"""render_roofline.fit: the render kernel's share of its roofline over the
traced fit's sampling phase, in %: three calls a retained step (the two
half-steps' proposals, half the walkers each, and the image
accumulation's render of all the walkers; bounds.render_work) over the
device time of its kernel there.  NVIDIA H100 peaks (bounds.py)."""
from portbench import bounds
from portbench.harness import layers


def read(rec):
    t, c = rec["traced"], rec["cell"]
    if t is None:
        return None
    windows = layers.spans(t["trace"], "sampling")
    h, w = c["shape"]
    n, s = c["walkers"], c["sersics"]
    per_step = (2 * bounds.bound_ms(*bounds.render_work(n // 2, h, w, s))
                + bounds.bound_ms(*bounds.render_work(n, h, w, s)))
    return layers.roofline_share(t["trace"], windows, "render", per_step * 1e-3,
                                 c["iterations"], 3)
