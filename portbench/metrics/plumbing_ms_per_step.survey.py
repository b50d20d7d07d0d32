"""plumbing_ms_per_step.survey: device ms a step in kernels not built from
the port's csrc/, over the traced fit_batch call."""
from portbench.harness import layers


def read(rec):
    t = rec["traced"]
    if t is None or t["trace"]["window"] is None:
        return None
    return layers.plumbing_ms(t["trace"], [t["trace"]["window"]], rec["cell"]["steps"])
