"""The traced unit: ``torch.profiler`` over one whole unit, reduced to records.

Device activities (kernels, copies, sets) come from the profiler's CUDA
trace (CUPTI); host annotations and operations from its CPU trace, on
the same clock.  The reduction keeps, in ns: every host annotation
``(name, start, end)``, every host operation, and every device activity
``(name, start, end, kind)``; the rest of the profiler's data is dropped
before the readers run.
"""
from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["UNIT_SPAN", "ANNOTATIONS", "traced", "reduce_events", "breakdown"]

UNIT_SPAN = "portbench.unit"
# the host annotations the readers use: the harness's and the driver's phases
ANNOTATIONS = (UNIT_SPAN, "init", "burn", "sampling", "images", "map")
_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def traced(fn):
    """Run ``fn()`` under the profiler; returns ``(fn's result, trace)``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(UNIT_SPAN):
            out = fn()
    trace = reduce_events(prof.profiler.kineto_results.events())
    del prof
    return out, trace


def _short(name):
    """A kernel's name without ``void``, the anonymous namespace and its
    argument list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:160]


def _kind(ev):
    """The event's activity: from the profiler where it says, else from
    the device and the name (a device event named as an annotation is the
    annotation's device-side copy, and is dropped)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    if ev.device_type() != torch.autograd.DeviceType.CPU:
        if name in ANNOTATIONS:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    user = getattr(ev, "is_user_annotation", None)
    return "user_annotation" if name in ANNOTATIONS or (user and user()) else "cpu_op"


def _ns(ev):
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.start_ns() + ev.duration_ns()
    return ev.start_us() * 1000, (ev.start_us() + ev.duration_us()) * 1000


def reduce_events(events):
    spans, host, device = [], [], []
    for ev in events:
        kind = _kind(ev)
        start, end = _ns(ev)
        if kind == "user_annotation":
            spans.append((ev.name(), start, end))
        elif kind == "cpu_op":
            host.append((ev.name(), start, end))
        elif kind in _DEVICE_KINDS:
            device.append((_short(ev.name()), start, end, _DEVICE_KINDS[kind]))
    unit = [(s, e) for n, s, e in spans if n == UNIT_SPAN]
    return {"window": unit[0] if unit else None, "spans": spans, "host": host,
            "device": sorted(device, key=lambda d: d[1])}


def breakdown(trace, top=10):
    """The device operations that took most time, and the longest idle
    gaps of the unit's span by what the host was doing (the innermost
    host annotation or operation covering the gap's middle)."""
    totals = {}
    for name, s, e, _ in trace["device"]:
        totals[name] = totals.get(name, 0) + (e - s)
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = trace["window"]
    gaps, cursor = [], w0
    for _, s, e, _ in trace["device"]:
        if s > cursor:
            gaps.append((cursor, min(s, w1)))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    covers = [(n, s, e) for n, s, e in trace["spans"] if n != "portbench.unit"] + trace["host"]
    named = []
    for s, e in gaps:
        mid = (s + e) // 2
        inside = [(ee - ss, n) for n, ss, ee in covers if ss <= mid <= ee]
        phase = [(ee - ss, n) for n, ss, ee in trace["spans"]
                 if ss <= mid <= ee and n != UNIT_SPAN]
        what = min(inside)[1] if inside else "host"
        if phase and min(phase)[1] != what:
            what = f"{min(phase)[1]}: {what}"
        named.append([what, (e - s) * 1e-9])
    return {"device_ops": [[n, t * 1e-9] for n, t in ops], "idle_gaps": named}
