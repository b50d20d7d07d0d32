"""Launch counts of the kernel wrappers that read launches executed.

Every wrapper keeps ``<wrapper>.launches`` (the likelihood kernels also
``<wrapper>.route_launches``, and conv_lnl and its backward
``<wrapper>.shape_launches`` by ``(route, image shape)``) and calls :func:`count`
right after its kernel launched.  Eagerly that adds one.  Inside :func:`tally` it adds
nothing and appends the launch to the tally instead: the sampler
captures its CUDA graphs inside one, so that a capture, which executes
nothing, counts nothing, and each replay adds the tally it kept
(:func:`add`).  A capture made outside a tally (by a caller's own
``torch.cuda.graph``) counts nothing either: its replays cannot be
seen here.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["count", "tally", "add"]

_tally = None


def count(fn, route=None, shape=None):
    """One launch of the wrapper ``fn`` (on ``route``, a likelihood
    kernel's, at the image ``shape`` where the wrapper counts by shape):
    counted now, appended to the open tally, or, under a capture without
    a tally, not counted."""
    if _tally is not None:
        _tally.append((fn, route, shape))
        return
    if torch.cuda.is_current_stream_capturing():
        return
    add([(fn, route, shape)])


@contextlib.contextmanager
def tally():
    """Collect the launches made inside (a list of ``(wrapper, route,
    shape)``) instead of counting them."""
    global _tally
    outer, _tally = _tally, []
    try:
        yield _tally
    finally:
        _tally = outer


def add(launches):
    """Count a tally's launches: what one replay of its graph executed."""
    for fn, route, shape in launches:
        fn.launches += 1
        if route is not None:
            fn.route_launches[route] += 1
        if shape is not None:
            key = (route, shape)
            fn.shape_launches[key] = fn.shape_launches.get(key, 0) + 1
