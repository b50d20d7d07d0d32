"""kernels_per_step.fit: device kernels a step, over the traced fit's burn
and sampling phases (a count from the device trace)."""
from portbench.harness import layers


def read(rec):
    t = rec["traced"]
    if t is None:
        return None
    windows = layers.step_windows(t["trace"])
    if not windows:
        return None
    return len(layers.kernels(t["trace"], windows)) / rec["cell"]["steps"]
