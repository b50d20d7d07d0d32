"""step_ms.fit: the traced fit's burn and sampling phases (phase_seconds)
over its steps, in ms; checkpoint writes and rejuvenation included."""


def read(rec):
    t = rec["traced"]
    if t is None or "phase_seconds" not in t:
        return None
    ph = t["phase_seconds"]
    return 1e3 * (ph.get("burn", 0.0) + ph.get("sampling", 0.0)) / rec["cell"]["steps"]
