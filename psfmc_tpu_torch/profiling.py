"""Tracing and per-phase wall-clock instrumentation (port of ``profiling.py``).

Every fitting phase records its host-clock seconds (printed on the
driver's stdout by the primary process, and returned as the database's
``phase_seconds``), each ending in a device synchronize
(:class:`PhaseTimer`, :func:`device_sync`).  A ``torch.profiler`` trace of
the CPU and CUDA activities, in Chrome's trace format (Perfetto,
``chrome://tracing``), is written by :func:`trace` when ``PSFMC_TRACE_DIR``
is set; the fitting driver traces its burn-in and its retained sampling.

The JAX module's analytic FLOP model (``conv_rdft_flops``,
``conv_fft_flops``, ``lnpost_flop_model``, outside its ``__all__``) is
not carried: it describes the TPU's matmul formulation and peak; the
port's bounds are computed where they are measured (``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch

from .parallel.multihost import is_primary, process_index

__all__ = ["PhaseTimer", "trace", "device_sync"]


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def device_sync(x):
    """Wait for the device work behind ``x``: a tensor, a (nested) list,
    tuple or dict of them, or a ``torch.device``; the CUDA device it lies
    on is synchronized, nothing else is.  Returns ``x``."""
    device = x if isinstance(x, torch.device) else None
    if device is None:
        t = _first_tensor(x)
        device = None if t is None else t.device
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return x


class PhaseTimer:
    """Accumulates named phase durations (``phases``, or the dict given);
    the primary process prints one line a phase, ``[psfmc] <name>:
    <seconds>s``."""

    def __init__(self, verbose=True, phases=None):
        self.phases = OrderedDict() if phases is None else phases
        self.verbose = verbose

    @contextlib.contextmanager
    def phase(self, name, sync_result=None):
        """Time the block on the host clock; ``sync_result`` (anything
        :func:`device_sync` takes) is synchronized before the clock is
        read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                device_sync(sync_result)
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if self.verbose and is_primary():
                print(f"[psfmc] {name}: {dt:.2f}s")

    def summary(self):
        return dict(self.phases)


@contextlib.contextmanager
def trace(label="psfmc", trace_dir=None):
    """A ``torch.profiler`` trace of the block (CPU and, where present,
    CUDA activities) written as ``<dir>/<label>/rank<r>.pt.trace.json``
    when ``trace_dir`` or ``PSFMC_TRACE_DIR`` names a directory; nothing
    otherwise."""
    trace_dir = trace_dir or os.environ.get("PSFMC_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, label)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, f"rank{process_index()}.pt.trace.json"))
