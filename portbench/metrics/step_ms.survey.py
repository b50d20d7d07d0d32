"""step_ms.survey: the benchmark's span around the traced fit_batch call
over its steps, in ms (the call's preparation included)."""


def read(rec):
    t = rec["traced"]
    if t is None:
        return None
    return 1e3 * t["seconds"] / rec["cell"]["steps"]
