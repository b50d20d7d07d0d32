"""The port's ``profiling`` module against the JAX package's, on the CPU.

``PhaseTimer`` prints the JAX package's line for each phase and sums a
phase's repeats; ``trace`` writes a ``torch.profiler`` Chrome trace under
``PSFMC_TRACE_DIR/<label>`` (or the directory given) and nothing when no
directory is set; ``device_sync`` hands back what it is given; the
fitting driver writes one trace of each whole fit, ``fit_batch`` one of
each call, when ``PSFMC_TRACE_DIR`` is set.  ``span`` opens a profiler
range only while a profiler records; the driver's and ``fit_batch``'s
spans nest in their phases under one ``psfmc.fit`` (``psfmc.fit_batch``)
span, and the driver's ``phase_seconds`` keeps its keys.
"""
import json
import os
import re
import warnings

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from psfmc_tpu import profiling as jprof
from psfmc_tpu_torch import batchfit, model_galaxy_mcmc, profiling
from psfmc_tpu_torch.flagship import general_components
from psfmc_tpu_torch.models import MultiComponentModel
from test_torch_io import MODEL, _write_inputs

LINE = re.compile(r"^\[psfmc\] (\w+): (\d+\.\d\d)s$")


def test_phase_timer_lines_and_sums_match_jax(capsys):
    lines = {}
    for name, mod in (("torch", profiling), ("jax", jprof)):
        timer = mod.PhaseTimer()
        for phase in ("burn", "sampling", "burn"):
            with timer.phase(phase, sync_result=torch.zeros(1)):
                pass
        lines[name] = capsys.readouterr().out.splitlines()
        assert list(timer.summary()) == ["burn", "sampling"]
        assert all(v >= 0.0 for v in timer.summary().values())
    assert [LINE.match(x).group(1) for x in lines["torch"]] == \
        [LINE.match(x).group(1) for x in lines["jax"]] == ["burn", "sampling", "burn"]
    timings = {"init": 1.0}
    timer = profiling.PhaseTimer(verbose=False, phases=timings)
    with timer.phase("init"):
        pass
    assert timer.phases is timings and timings["init"] >= 1.0
    assert capsys.readouterr().out == ""


def test_trace_writes_a_chrome_trace_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv("PSFMC_TRACE_DIR", raising=False)
    with profiling.trace("quiet"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("PSFMC_TRACE_DIR", str(tmp_path / "env"))
    with profiling.trace("step"):
        torch.ones(4).sum()
    with profiling.trace("given", trace_dir=str(tmp_path / "arg")):
        torch.ones(4).sum()
    for path in (tmp_path / "env" / "step", tmp_path / "arg" / "given"):
        (trace,) = path.iterdir()
        assert trace.name == "rank0.pt.trace.json"
        assert "traceEvents" in json.loads(trace.read_text())


def test_device_sync_returns_its_argument():
    x = torch.ones(3)
    nested = {"a": [x, 1], "b": None}
    assert profiling.device_sync(x) is x
    assert profiling.device_sync(nested) is nested
    assert profiling.device_sync(torch.device("cpu")) == torch.device("cpu")
    assert profiling.device_sync(None) is None


# each span of a fit (checkpoint_interval=1, 2 + 2 steps) and its parent
FIT_PARENTS = {
    "psfmc.model": "psfmc.fit", "psfmc.prior_draws": "psfmc.fit", "init": "psfmc.fit",
    "burn": "psfmc.fit", "sampling": "psfmc.fit", "images": "psfmc.fit",
    "psfmc.steps": ("burn", "sampling"), "psfmc.readout": ("burn", "sampling"),
    "psfmc.rejuvenate": "burn",
    "psfmc.checkpoint": ("burn", "sampling", "psfmc.fit"),
    "psfmc.checkpoint.table": "psfmc.checkpoint",
    "psfmc.checkpoint.payload": "psfmc.checkpoint",
    "psfmc.checkpoint.write": "psfmc.checkpoint",
    "psfmc.checkpoint.reload": "psfmc.checkpoint",
    "psfmc.convergence": "psfmc.fit",
    "psfmc.images.filter": "images", "psfmc.images.stats": "images",
    "psfmc.images.write": "images",
}
PHASES = ("init", "burn", "sampling", "images")
BATCH_PARENTS = {name: "psfmc.fit_batch" for name in (
    "psfmc.model", "psfmc.batch.prepare", "psfmc.batch.program", "psfmc.batch.start",
    "psfmc.batch.steps", "psfmc.batch.readout", "psfmc.batch.merge")}


def _fit(directory):
    _write_inputs(str(directory))
    (directory / "model.py").write_text(MODEL)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return model_galaxy_mcmc(str(directory / "model.py"),
                                     output_name=str(directory / "o"), chains=24, burn=2,
                                     iterations=2, checkpoint_interval=1, device="cpu")
    finally:
        torch.set_num_threads(threads)


def _batch():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = MultiComponentModel(general_components(
            (32, 32), (16, 16), num_psfs=1, gradient=False, noise_scale=False),
            device="cpu", dtype=torch.float64)
        obs, ivm, _ = batchfit.simulate_stack(model, 3, seed=1)
        return batchfit.fit_batch(model, obs, ivm, nwalkers=8, burn=2, iterations=2, seed=3)
    finally:
        torch.set_num_threads(threads)


def _profiled(fn):
    """``fn()``'s result and its spans ``[(name, start_us, end_us)]``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("psfmc.") or e.name in PHASES]
    return out, spans


def _parents(spans):
    """Each span's innermost enclosing span (None for the outermost)."""
    out = []
    for span in spans:
        _, s, e = span
        around = [(ee - ss, n) for n, ss, ee in spans
                  if (n, ss, ee) != span and ss <= s and e <= ee]
        out.append((span[0], min(around)[1] if around else None))
    return out


def _names_in_chrome_trace(path):
    events = json.loads(path.read_text())["traceEvents"]
    return {ev["name"] for ev in events}


@pytest.fixture(scope="module")
def profiled_fit(tmp_path_factory):
    return _profiled(lambda: _fit(tmp_path_factory.mktemp("fit")))


def test_driver_spans_nest_in_their_phases_under_one_fit_span(profiled_fit):
    _, spans = profiled_fit
    parents = _parents(spans)
    assert [p for p in parents if p[1] is None] == [("psfmc.fit", None)]
    for name, parent in parents:
        if name == "psfmc.fit":
            continue
        assert name in FIT_PARENTS or name.startswith("psfmc.images."), name
        allowed = FIT_PARENTS.get(name, "images")
        assert parent in (allowed if isinstance(allowed, tuple) else (allowed,)), (name, parent)
    names = [n for n, _ in parents]
    assert set(FIT_PARENTS) <= set(names)
    # a segment a step: two steps and two readouts a phase; a checkpoint
    # after each segment but the last, and the round's
    assert names.count("psfmc.steps") == names.count("psfmc.readout") == 4
    assert names.count("psfmc.checkpoint") == names.count("psfmc.checkpoint.write") == 3


def test_phase_seconds_keeps_its_keys(profiled_fit):
    db, _ = profiled_fit
    assert tuple(db.phase_seconds) == PHASES
    assert all(v > 0.0 for v in db.phase_seconds.values())
    assert np.all(np.isfinite(db["lnprobability"]))


def test_fit_batch_spans_nest_under_one_call_span():
    res, spans = _profiled(_batch)
    parents = _parents(spans)
    assert [p for p in parents if p[1] is None] == [("psfmc.fit_batch", None)]
    assert {n for n, _ in parents} == set(BATCH_PARENTS) | {"psfmc.fit_batch"}
    assert all(parent == BATCH_PARENTS[name] for name, parent in parents if parent)
    assert np.isfinite(res.mean).all()


def test_span_records_nothing_without_a_profiler():
    def body():
        with profiling.span("psfmc.test") as entered:
            return entered, torch.ones(2).sum().item()

    assert body() == (None, 2.0)
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    assert [e.name for e in prof.events()].count("psfmc.test") == 1


def test_trace_under_a_running_profiler_writes_nothing(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.trace("inner", trace_dir=str(tmp_path)):
            with profiling.span("psfmc.inner"):
                torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
    assert "psfmc.inner" in [e.name for e in prof.events()]


def test_driver_traces_burn_and_sampling(tmp_path, monkeypatch):
    """One trace file of the whole fit, which holds every span of it."""
    monkeypatch.setenv("PSFMC_TRACE_DIR", str(tmp_path / "traces"))
    db = _fit(tmp_path)
    assert sorted(os.listdir(tmp_path / "traces")) == ["fit"]
    (path,) = (tmp_path / "traces" / "fit").iterdir()
    assert path.name == "rank0.pt.trace.json"
    assert set(FIT_PARENTS) | {"psfmc.fit"} <= _names_in_chrome_trace(path)
    assert tuple(db.phase_seconds) == PHASES
    assert np.all(np.isfinite(db["lnprobability"]))


def test_fit_batch_writes_one_trace_of_the_call(tmp_path, monkeypatch):
    monkeypatch.setenv("PSFMC_TRACE_DIR", str(tmp_path))
    _batch()
    (path,) = (tmp_path / "fit_batch").iterdir()
    assert path.name == "rank0.pt.trace.json"
    assert set(BATCH_PARENTS) | {"psfmc.fit_batch"} <= _names_in_chrome_trace(path)


@pytest.mark.parametrize("name", ["PhaseTimer", "trace", "device_sync"])
def test_public_names(name):
    assert name in profiling.__all__ and name in jprof.__all__
