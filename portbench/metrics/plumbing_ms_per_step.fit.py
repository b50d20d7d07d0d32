"""plumbing_ms_per_step.fit: device ms a step in kernels not built from the
port's csrc/ (PyTorch's own: scalar preparation, prior, moves,
accumulation), over the traced fit's burn and sampling phases."""
from portbench.harness import layers


def read(rec):
    t = rec["traced"]
    if t is None:
        return None
    return layers.plumbing_ms(t["trace"], layers.step_windows(t["trace"]), rec["cell"]["steps"])
