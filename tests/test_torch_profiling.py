"""The port's ``profiling`` module against the JAX package's, on the CPU.

``PhaseTimer`` prints the JAX package's line for each phase and sums a
phase's repeats; ``trace`` writes a ``torch.profiler`` Chrome trace under
``PSFMC_TRACE_DIR/<label>`` (or the directory given) and nothing when no
directory is set; ``device_sync`` hands back what it is given; the
fitting driver traces its burn-in and its sampling when
``PSFMC_TRACE_DIR`` is set.
"""
import json
import os
import re
import warnings

import numpy as np
import pytest
import torch

from psfmc_tpu import profiling as jprof
from psfmc_tpu_torch import model_galaxy_mcmc, profiling
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


def test_driver_traces_burn_and_sampling(tmp_path, monkeypatch):
    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    monkeypatch.setenv("PSFMC_TRACE_DIR", str(tmp_path / "traces"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            db = model_galaxy_mcmc(str(tmp_path / "model.py"), output_name=str(tmp_path / "o"),
                                   chains=24, burn=2, iterations=2, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert sorted(os.listdir(tmp_path / "traces")) == ["burn", "sampling"]
    assert list(db.phase_seconds) == ["init", "burn", "sampling", "images"]
    assert np.all(np.isfinite(db["lnprobability"]))


@pytest.mark.parametrize("name", ["PhaseTimer", "trace", "device_sync"])
def test_public_names(name):
    assert name in profiling.__all__ and name in jprof.__all__
