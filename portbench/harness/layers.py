"""What the per-layer readers share: the reduced trace and the kernel table.

A traced unit's record (:func:`.trace.reduce_events`) holds, on the
profiler's clock (ns), the unit's span, every host annotation (the
driver's phases ``init``, ``burn``, ``sampling``, ``images``; the
harness's ``portbench.unit``), the host operations, and every device
activity (kernels, copies, sets).  The kernel table names the kernels
built from the port's ``csrc/`` by the substrings of their names, as the
profiler reports them (demangled or not), and which function each serves.
"""
from __future__ import annotations

import sys

__all__ = ["CSRC_MARKS", "is_csrc", "spans", "step_windows", "in_span", "kernels", "union",
           "busy_s", "idle_share", "plumbing_ms", "function_kernels", "roofline_share"]

# a kernel whose name holds one of these was built from csrc/
CSRC_MARKS = ("conv_lnl_", "fused_lnl_", "sersic_render_kernel", "render_backward_kernel",
              "fftglobal", "dftconv", "lnl_kernel", "weights_kernel", "combine_kernel")

# each likelihood function's kernels: the one that starts a call (one a
# call on every route), and the others of a call
ENTRIES = {
    "conv_lnl": ("conv_lnl_fft_kernel", "conv_lnl_padded_kernel", "conv_lnl_cluster_kernel",
                 "peak_kernel"),
    "fused_lnl": ("fused_lnl_kernel", "fused_lnl_fft_kernel", "fused_lnl_padded_kernel",
                  "fused_lnl_cluster_kernel", "fused_lnl_global_render_kernel"),
    "render": ("sersic_render_kernel",),
}
# the global route's forward kernels (csrc/fft_global.cuh) serve conv_lnl
# or, after the fused kernel's render pass, fused_lnl
_GLOBAL_FORWARD = ("rows_forward_kernel", "columns_kernel", "readout_kernel", "reduce_kernel")


def is_csrc(name):
    return any(m in name for m in CSRC_MARKS)


def spans(trace, name):
    """``[(start, end)]`` of the host annotation ``name``."""
    return [(s, e) for n, s, e in trace["spans"] if n == name]


def step_windows(trace):
    """The spans of the driver's burn and sampling phases: its steps."""
    return spans(trace, "burn") + spans(trace, "sampling")


def in_span(events, window):
    """The device events that start inside ``window`` ``(start, end)``."""
    s, e = window
    return [ev for ev in events if s <= ev[1] <= e]


def kernels(trace, windows):
    """``[(name, start, end)]`` of the kernels starting in any of ``windows``."""
    ks = [ev for ev in trace["device"] if ev[3] == "kernel"]
    out = []
    for w in windows:
        out += in_span(ks, w)
    return out


def _global_member(name):
    return "fftglobal" in name and any(k in name for k in _GLOBAL_FORWARD)


def function_kernels(events, function):
    """``(calls, kernels)`` of ``function`` (``"conv_lnl"``, ``"fused_lnl"``
    or ``"render"``) among ``events`` ``[(name, start, end, ...)]``: the
    kernels that start a call, and every kernel of its calls.  The global
    route's shared kernels go to the function whose global entry is
    there; with both there, to neither (None)."""
    entries = ENTRIES[function]
    starts = [ev for ev in events if any(k in ev[0] for k in entries)
              and ("peak_kernel" not in ev[0] or "fftglobal" in ev[0])]
    if function == "render":
        return starts, starts
    own = "conv_lnl_" if function == "conv_lnl" else "fused_lnl_"
    members = [ev for ev in events if own in ev[0] and "backward" not in ev[0]]
    conv_global = any("fftglobal" in ev[0] and "peak_kernel" in ev[0] for ev in events)
    fused_global = any("fused_lnl_global_render_kernel" in ev[0] for ev in events)
    if conv_global and fused_global:
        return None
    if (function == "conv_lnl" and conv_global) or (function == "fused_lnl" and fused_global):
        members += [ev for ev in events if _global_member(ev[0]) or
                    (function == "conv_lnl" and "fftglobal" in ev[0] and "peak_kernel" in ev[0])]
    return starts, members


def union(intervals, window):
    """Seconds of ``window`` covered by the union of ``intervals``."""
    s0, e0 = window
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, s0), min(e, e0)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def busy_s(trace):
    """Seconds of the unit's span in which an activity (a kernel, a copy,
    a set) ran on the device."""
    return union([(s, e) for _, s, e, _ in trace["device"]], trace["window"])


def idle_share(rec):
    """The share of the traced unit's span in which nothing ran on the
    device, in %; None without a traced unit or device activity."""
    t = rec["traced"]
    if t is None or t["trace"]["window"] is None or not t["trace"]["device"]:
        return None
    w0, w1 = t["trace"]["window"]
    return 100.0 * (1.0 - busy_s(t["trace"]) / ((w1 - w0) * 1e-9))


def plumbing_ms(trace, windows, steps):
    """Device ms a step in kernels not built from the port's csrc/ over
    ``windows``, which hold ``steps`` steps; None without windows."""
    if not windows:
        return None
    ks = [k for k in kernels(trace, windows) if not is_csrc(k[0])]
    return 1e-6 * sum(e - s for _, s, e, _ in ks) / steps


def roofline_share(trace, windows, function, least_s, steps, per_step=1, skip_first=False):
    """A function's share of its roofline over ``windows``, in %: the
    least time of its calls over their measured device seconds.  The
    calls come ``per_step`` to a sampler step, and ``least_s`` is the
    yardstick's least time of one step's calls; a captured step's warm-up
    (the sampler runs each step variant once before capturing it) is a
    step like the others, so the window holds ``steps`` steps or a few
    more.  With ``skip_first``, the first call (an evaluation of a start,
    at another batch) is left out.  None where the calls do not come in
    whole steps, or are fewer than ``steps`` steps', or the kernels cannot
    be told apart."""
    events = kernels(trace, windows)
    found = function_kernels(events, function)
    if found is None:
        return None
    starts, members = found
    if skip_first and starts:
        first = min(s for _, s, *_ in starts)
        later = [ev for ev in starts if ev[1] > first]
        if not later:
            return None
        cut = min(s for _, s, *_ in later)
        starts = later
        members = [ev for ev in members if ev[1] >= cut]
    if len(starts) % per_step or len(starts) < steps * per_step or not members:
        print(f"roofline of {function}: {len(starts)} calls in the window, "
              f"{steps} steps of {per_step} expected; not read", file=sys.stderr)
        return None
    seconds = sum(e - s for _, s, e, *_ in members) * 1e-9
    return 100.0 * (len(starts) // per_step) * least_s / seconds
