"""The readers of the program's own spans: on a tiny traced CPU run of each
mix every one returns a number; on a trace without the program's spans
(an older program) every one returns None; nested spans count once."""
import pytest

from portbench.harness import common

from portbench_support import CHECK_LIMITS, TINY_SIZES

SPAN_METRICS = {"j0005.single": ["replay_ms_per_step.fit", "capture_s.fit", "readout_s.fit",
                                 "checkpoint_s.fit", "model_s.fit"],
                "j0005.survey": ["batch_step_ms.survey", "batch_prepare_s.survey"]}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_a_tiny_traced_run_reports_every_span_metric(tiny_cell, name):
    from portbench import run

    cell = tiny_cell(name)
    assert set(SPAN_METRICS[name]) <= {m["name"] for m in cell.per_layer}
    limits = {k: v for k, v in CHECK_LIMITS.items() if k in cell.limits}
    res = run.run_cell(cell, 2**31 + 7, 0.5, True, "cpu", sizes=TINY_SIZES.get(name),
                       limits=limits)
    assert res["correct"], res["checks"]
    for metric in SPAN_METRICS[name]:
        value = res["metrics"][metric]["value"]
        assert isinstance(value, float) and value >= 0.0, metric
    # no graphs on the CPU: nothing captured, the steps all there
    if name == "j0005.single":
        assert res["metrics"]["capture_s.fit"]["value"] == 0.0
        assert res["metrics"]["replay_ms_per_step.fit"]["value"] > 0.0


def _rec(spans, steps=4):
    trace = {"window": (0, 1000), "spans": spans, "host": [], "device": []}
    return {"traced": {"trace": trace}, "cell": {"steps": steps}}


def test_without_the_programs_spans_every_reader_reads_none():
    bench = common.load_benchmark()
    rec = _rec([("portbench.unit", 0, 1000), ("burn", 10, 400), ("sampling", 400, 900)])
    for names in SPAN_METRICS.values():
        for name in names:
            assert common.load_metric(common.BENCH_DIR, name).read(rec) is None, name
            assert any(m["name"] == name and m["source"] == "program_span"
                       for m in bench["per_layer"])
    assert common.load_metric(common.BENCH_DIR, "capture_s.fit").read(
        {"traced": None, "cell": {"steps": 4}}) is None


def test_the_steps_less_their_captures_and_the_sums():
    rec = _rec([("psfmc.fit", 0, 10**9), ("psfmc.model", 0, 10**8),
                ("psfmc.prior_draws", 10**8, 2 * 10**8),
                ("psfmc.steps", 3 * 10**8, 5 * 10**8), ("psfmc.capture", 3 * 10**8, 4 * 10**8),
                ("psfmc.steps", 6 * 10**8, 7 * 10**8), ("psfmc.readout", 7 * 10**8, 8 * 10**8),
                ("psfmc.checkpoint", 8 * 10**8, 9 * 10**8)])
    read = {name: common.load_metric(common.BENCH_DIR, name).read(rec)
            for name in SPAN_METRICS["j0005.single"]}
    assert read["replay_ms_per_step.fit"] == pytest.approx(1e3 * 0.2 / 4)
    assert read["capture_s.fit"] == pytest.approx(0.1)
    assert read["readout_s.fit"] == pytest.approx(0.1)
    assert read["checkpoint_s.fit"] == pytest.approx(0.1)
    assert read["model_s.fit"] == pytest.approx(0.2)
