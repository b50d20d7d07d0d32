"""conv_lnl_roofline.survey: conv_lnl's share of its roofline over the
traced fit_batch call, in %: two calls a step on every target's half
ensemble (targets x walkers / 2 walkers, each target's own planes:
bounds.conv_lnl_work) over the device time of its kernels; the start's
evaluation (the call's first) left out.  NVIDIA H100 peaks (bounds.py)."""
from portbench import bounds
from portbench.harness import layers


def read(rec):
    t, c = rec["traced"], rec["cell"]
    if t is None or t["trace"]["window"] is None:
        return None
    h, w = c["shape"]
    k = c["targets"]
    work = bounds.conv_lnl_work(k * c["walkers"] // 2, h, w, targets=k)
    least = 2 * bounds.bound_ms(*work) * 1e-3
    return layers.roofline_share(t["trace"], [t["trace"]["window"]], "conv_lnl", least,
                                 c["steps"], 2, skip_first=True)
