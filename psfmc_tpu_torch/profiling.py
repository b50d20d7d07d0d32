"""Tracing and per-phase wall-clock instrumentation (port of ``profiling.py``).

Every fitting phase records its host-clock seconds (printed on the
driver's stdout by the primary process, and returned as the database's
``phase_seconds``), each ending in a device synchronize
(:class:`PhaseTimer`, :func:`device_sync`).  A ``torch.profiler`` trace of
the CPU and CUDA activities, in Chrome's trace format (Perfetto,
``chrome://tracing``), is written by :func:`trace` when ``PSFMC_TRACE_DIR``
is set: one a fit (``fit``), one a ``fit_batch`` call (``fit_batch``).

Inside them, :func:`span` names the host's work: a range on the profiler's
clock while a profiler records, nothing otherwise.  A fit's spans nest
under ``psfmc.fit`` (its phases, and below them ``psfmc.steps``,
``psfmc.capture``, ``psfmc.readout``, ``psfmc.checkpoint``, ...), a batch
call's under ``psfmc.fit_batch``; README's tracing paragraph lists them.

The JAX module's analytic FLOP model (``conv_rdft_flops``,
``conv_fft_flops``, ``lnpost_flop_model``, outside its ``__all__``) is
not carried: it describes the TPU's matmul formulation and peak; the
port's bounds are computed where they are measured (``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import OrderedDict

import torch
from torch._C._profiler import _RecordFunctionFast

from .parallel.multihost import is_primary, process_index

__all__ = ["PhaseTimer", "trace", "device_sync", "span", "traced"]

_recording = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context manager naming the block ``name`` in a profiler's trace,
    on its clock, its parent the span around it: while a profiler records,
    a function-scope range (a ``cpu_op`` event); otherwise a shared no-op,
    which costs a check of the profiler's state (under a microsecond)
    instead of a range's ~10 us.

    Not a ``record_function`` (a user annotation): the profiler copies a
    user annotation onto the device's timeline over the kernels launched
    inside it, and those copies read as device work to a reader that does
    not know the name.  The fitting phases stay user annotations."""
    return _RecordFunctionFast(name) if _recording() else _NO_SPAN


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
    otherwise, nor under a profiler already recording (which holds the
    block's spans)."""
    trace_dir = trace_dir or os.environ.get("PSFMC_TRACE_DIR")
    if not trace_dir or _recording():
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


def traced(label):
    """Decorator: each call is one :func:`trace` labelled ``label`` and one
    span ``psfmc.<label>``, the parent of every span the call opens."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with trace(label), span("psfmc." + label):
                return fn(*args, **kwargs)
        return call
    return wrap
