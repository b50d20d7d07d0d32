"""The harness on the CPU: every piece found by its name, a new one picked
up from a new file, a tiny run of each traffic mix through the whole
run, and no device metric without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import common

from portbench_support import CHECK_LIMITS, ROOT, TINY_SIZES



def test_every_cell_config_traffic_and_metric_is_found_by_name():
    bench = common.load_benchmark()
    for entry in bench["workloads"]:
        cell = common.cell_for(entry["name"])
        assert cell.config["name"] == entry["config"]
        assert cell.traffic["kind"] in ("driver", "batch")
        assert "lnp_gap" in cell.limits
        assert {"unmoved_walkers", "unmoved_targets"} & set(cell.limits)
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        for name in names:
            assert callable(common.load_metric(cell.bench_dir, name).read)
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics", metric["name"] + ".py"))


def test_a_new_config_and_metric_are_picked_up_from_new_files(tmp_path):
    copy = tmp_path / "repo"
    os.makedirs(copy)
    shutil.copytree(common.BENCH_DIR, copy / "portbench")
    bench = common.load_benchmark()
    with open(copy / "portbench" / "configs" / "j0005_wide.json", "w") as fh:
        json.dump(dict(common.cell_for("j0005.single").config, name="j0005_wide"), fh)
    with open(copy / "portbench" / "metrics" / "fits_seen.py", "w") as fh:
        fh.write("def read(rec):\n    return rec['window']['fits']\n")
    with open(copy / "portbench" / "limits" / "j0005_wide.single.json", "w") as fh:
        json.dump({"lnp_gap": {"max": 1}}, fh)
    bench["configs"].append(dict(bench["configs"][0], name="j0005_wide",
                                 file="portbench/configs/j0005_wide.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="j0005_wide.single",
                                   config="j0005_wide"))
    bench["per_layer"].append({"name": "fits_seen", "unit": "fits", "better": "higher",
                               "source": "host_clock", "layer": "driver and host I/O",
                               "moves": "fit_s", "workloads": ["j0005_wide.single"]})
    with open(copy / "BENCHMARK.json", "w") as fh:
        json.dump(bench, fh)
    cell = common.cell_for("j0005_wide.single", root=str(copy))
    assert cell.config["name"] == "j0005_wide"
    assert cell.limits == {"lnp_gap": {"max": 1}}
    assert [m["name"] for m in cell.per_layer] == ["fits_seen"]
    reader = common.load_metric(cell.bench_dir, "fits_seen")
    assert reader.read({"window": {"fits": 7}}) == 7


@pytest.mark.parametrize("name", ["j0005.single", "j0005.survey"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_of_each_mix_on_the_cpu(tiny_cell, name, traced):
    from portbench import run

    cell = tiny_cell(name)
    limits = {k: v for k, v in CHECK_LIMITS.items() if k in cell.limits}
    res = run.run_cell(cell, 2**31 + 5, 0.5, traced, "cpu", sizes=TINY_SIZES.get(name),
                       limits=limits)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(limits)
    metrics = res["metrics"]
    if traced:
        # the profiler saw no device: no device metric is reported
        assert not any(k.startswith(("device_idle", "plumbing")) and metrics[k]["value"] > 0
                       for k in metrics)
        assert not any("roofline" in k or "kernels_per_step" in k and metrics[k]["value"]
                       for k in metrics)
        assert res["device"]["busy_s"] == 0.0
    else:
        assert set(metrics) == {m["name"] for m in cell.end_to_end}
    assert res["device"]["platform"] == "cpu"


def test_without_a_card_the_command_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "j0005.single",
                           "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(common.BENCH_DIR, tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "j0005.single",
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("seeds", [(2**31 + 3, 2**31 + 4), (7, 2**33 + 1)])
def test_every_run_of_the_single_mix_fits_one_pool_in_another_order(tiny_cell, tmp_path, seeds):
    from portbench.harness import generator

    cell = tiny_cell("j0005.single")
    runs = []
    for seed in seeds:
        os.makedirs(tmp_path / str(seed))
        runs.append(generator.make_traffic(cell, seed, str(tmp_path / str(seed)), "cpu"))
    a, b = runs
    assert a.pool_seed == b.pool_seed == cell.traffic["pool_seed"]
    assert (a.inputs.obs == b.inputs.obs).all()
    assert len(a.inputs.model_files) == cell.traffic["pool"]
    assert 0 <= a.first_slot < cell.traffic["pool"] and 0 <= b.first_slot < cell.traffic["pool"]


def test_seeds_past_32_bits_give_the_program_valid_seeds():
    from portbench.harness.generator import unit_seed

    seeds = [unit_seed(2**33 + 17, i) for i in range(5)]
    assert len(set(seeds)) == 5 and all(0 <= s < 2**31 for s in seeds)


def _fake_trace(names_per_step, steps, warmups=1):
    """A traced fit's trace: ``steps + warmups`` steps of the given kernels,
    each 1000 ns, inside a sampling span."""
    device, t = [], 1000
    for _ in range(steps + warmups):
        for name in names_per_step:
            device.append((name, t, t + 1000, "kernel"))
            t += 2000
    return {"window": (0, t + 10), "spans": [("sampling", 500, t + 5)], "host": [],
            "device": device}


@pytest.mark.parametrize("route", [["conv_lnl_fft_kernel<false, false>"],
                                   ["psfmc::fftglobal::peak_kernel",
                                    "psfmc::fftglobal::rows_forward_kernel<false>",
                                    "psfmc::fftglobal::columns_kernel<false>",
                                    "psfmc::fftglobal::readout_kernel<false>",
                                    "psfmc::fftglobal::reduce_kernel<false>"]])
def test_a_roofline_counts_whole_steps_and_every_kernel_of_a_call(route):
    from portbench.harness import layers

    step = ["at::native::reduce_kernel<128, 4>"] + route + ["sersic_render_kernel<2>"] + route
    trace = _fake_trace(step, steps=10)
    # 11 steps of 2 calls, each call len(route) kernels of 1 us
    got = layers.roofline_share(trace, [(500, 10**9)], "conv_lnl", 1e-6, 10, 2)
    assert got == pytest.approx(100.0 * 11 * 1e-6 / (11 * 2 * len(route) * 1e-6))
    assert layers.roofline_share(trace, [(500, 10**9)], "conv_lnl", 1e-6, 12, 2) is None
    assert layers.roofline_share(trace, [(500, 10**9)], "render", 1e-6, 10, 1) == pytest.approx(
        100.0 * 11 * 1e-6 / (11 * 1e-6))


def test_the_union_of_intervals_counts_overlaps_once():
    from portbench.harness import layers

    assert layers.union([(0, 10), (5, 20), (30, 40)], (0, 35)) == pytest.approx(25e-9)
