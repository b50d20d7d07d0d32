"""What the readers of the program's own spans share.

The port names its host work with ranges on the profiler's clock
(``psfmc_tpu_torch.profiling.span``, each a ``psfmc.*`` host event of the
traced unit: ``trace["host"]`` as the trace reader sorts them, or
``trace["spans"]`` for a range recorded as a user annotation): one
``psfmc.fit`` span a fit, one ``psfmc.fit_batch`` a batch call, and inside
them the driver's and the sampler's (``psfmc.steps``, ``psfmc.capture``,
``psfmc.readout``, ``psfmc.checkpoint``, ``psfmc.batch.steps``, ...).  A
program without them (an older one) gives every reader None.
"""
from __future__ import annotations

from . import layers

__all__ = ["program_spans", "seconds", "self_seconds"]


def program_spans(trace):
    """``[(name, start, end)]`` of the program's ``psfmc.*`` spans."""
    return [ev for ev in trace["spans"] + trace["host"] if ev[0].startswith("psfmc.")]


def _spans(rec, root):
    """The traced unit's program spans where the program opened ``root``;
    None otherwise."""
    t = rec["traced"]
    if t is None:
        return None
    found = program_spans(t["trace"])
    return found if any(n == root for n, _, _ in found) else None


def seconds(rec, root, *names):
    """Seconds of the spans ``names`` (each taken whole; none of them
    inside another) in the traced unit; None without a ``root`` span."""
    found = _spans(rec, root)
    if found is None:
        return None
    return 1e-9 * sum(e - s for n, s, e in found if n in names)


def self_seconds(rec, root, name, less):
    """Seconds of the spans ``name`` less the parts that spans ``less``
    inside them cover; None without a ``root`` span."""
    found = _spans(rec, root)
    if found is None:
        return None
    inner = [(s, e) for n, s, e in found if n == less]
    return sum((e - s) * 1e-9 - layers.union(inner, (s, e)) for n, s, e in found if n == name)
