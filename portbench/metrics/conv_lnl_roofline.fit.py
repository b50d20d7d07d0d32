"""conv_lnl_roofline.fit: conv_lnl's share of its roofline over the traced
fit's sampling phase, in %: the least time of its calls (two a step, half
the walkers each: bounds.conv_lnl_work at the image's sides) over the
device time of its kernels there.  NVIDIA H100 peaks (bounds.py)."""
from portbench import bounds
from portbench.harness import layers


def read(rec):
    t, c = rec["traced"], rec["cell"]
    if t is None:
        return None
    windows = layers.spans(t["trace"], "sampling")
    h, w = c["shape"]
    least = 2 * bounds.bound_ms(*bounds.conv_lnl_work(c["walkers"] // 2, h, w)) * 1e-3
    return layers.roofline_share(t["trace"], windows, "conv_lnl", least, c["iterations"], 2)
