"""render_roofline.survey: the render kernel's share of its roofline over
the traced fit_batch call, in %: two calls a step on every target's half
ensemble (bounds.render_work) over the device time of its kernel; the
start's render (the call's first) left out.  NVIDIA H100 peaks
(bounds.py)."""
from portbench import bounds
from portbench.harness import layers


def read(rec):
    t, c = rec["traced"], rec["cell"]
    if t is None or t["trace"]["window"] is None:
        return None
    h, w = c["shape"]
    work = bounds.render_work(c["targets"] * c["walkers"] // 2, h, w, c["sersics"])
    least = 2 * bounds.bound_ms(*work) * 1e-3
    return layers.roofline_share(t["trace"], [t["trace"]["window"]], "render", least,
                                 c["steps"], 2, skip_first=True)
