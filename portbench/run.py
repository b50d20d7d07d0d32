"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (imports, the CUDA context, the kernels' build or load, the
inputs made from the seed, one warm-up unit) is ``setup_s``; then whole
units of the cell's traffic (fits, or survey batches) run back to back
until ``--seconds`` have passed, the unit in flight finishing.  With
``--trace 1`` the window's first unit runs under ``torch.profiler`` and
the cell's per-layer metrics are read from it; otherwise its end-to-end
metrics are read from the window.  After the window the program's state
is freed and what the timed units produced is compared with the float64
reference (:mod:`portbench.harness.check`).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``), then
``checks``, each compared number beside its limit; the same numbers end
standard error.  Without a card, or with fewer than the cell asks for,
the run prints no result and exits with 2.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cache of the program's tool chain at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".portbench_cache", _sub))

import torch  # noqa: E402

from portbench.harness import check, common, generator, layers, trace  # noqa: E402


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def _counts():
    """The launch counters of the port's kernel wrappers."""
    from psfmc_tpu_torch.ops.kernels import conv_lnl, fused_lnl, sersic_render

    return {"conv_lnl": conv_lnl.batched_conv_lnl.launches,
            "fused_lnl": fused_lnl.fused_lnl.launches,
            "render": sersic_render.render_sersics.launches}


def _power_limit_w():
    """The card's power limit in W (the peaks of the roofline shares hold
    at 700 W), or None where ``nvidia-smi`` cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits",
                              "-i", str(torch.cuda.current_device())],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _read(metrics, bench_dir, records):
    out = {}
    for m in metrics:
        value = common.load_metric(bench_dir, m["name"]).read(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _log_trace(rec):
    """What the traced unit held: its spans, its kernels in each, and the
    launch counters' increase."""
    tr = rec["trace"]
    kinds = {}
    for name, s, e in tr["spans"]:
        ks = [k for k in tr["device"] if k[3] == "kernel" and s <= k[1] <= e]
        kinds.setdefault(name, []).append((round((e - s) * 1e-9, 4), len(ks)))
    _log(f"traced unit: spans {kinds}; launches {rec['counts']}")


def run_cell(cell, seed, seconds, traced, device, t0=None, sizes=None, limits=None):
    """One run of ``cell``; returns the result dict (without printing).
    ``sizes`` (tests) overrides the traffic's walkers and steps;
    ``limits`` the cell's limits."""
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from psfmc_tpu_torch.ops.kernels import _build

        _build.build_all()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        traffic = generator.make_traffic(cell, seed, workdir, device, sizes)
        first = traffic.unit(0)  # the warm-up: every shape the window uses
        shutil.rmtree(first.get("dir", os.path.join(workdir, "none")), ignore_errors=True)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        units, attempted, failed, traced_rec = [], 0, 0, None
        start = time.perf_counter()
        while time.perf_counter() - start < seconds or attempted == 0:
            attempted += 1
            try:
                if traced and traced_rec is None:
                    before = _counts()
                    rec, tr = trace.traced(lambda: traffic.unit(attempted))
                    after = _counts()
                    traced_rec = dict(rec, trace=tr,
                                      counts={k: after[k] - before[k] for k in after})
                else:
                    rec = traffic.unit(attempted)
                units.append(rec)
                _log(f"unit {attempted}: {rec['seconds']:.3f} s")
            except Exception:  # noqa: BLE001 - a failed unit is counted, the run goes on
                failed += 1
                _log(traceback.format_exc())
        window_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = common.forbidden_modules()
        if found:
            raise SystemExit(f"forbidden modules loaded: {found}")
        model = getattr(traffic, "model", None)
        traffic.model = None
        del model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        try:
            numbers, detail = check.check_units(traffic, units, seed)
            ok, rows = check.judge(numbers, cell.limits if limits is None else limits)
        except Exception:  # noqa: BLE001 - what cannot be compared is not correct
            _log(traceback.format_exc())
            ok, rows, detail = False, [("comparison", None, "raised", None)], {}
        records = {"cell": traffic.describe(), "setup_s": setup_s, "units": units,
                   "window": {"seconds": window_s, "units": len(units),
                              "fits": sum(u["fits"] for u in units)},
                   "traced": traced_rec}
        metrics = _read(cell.per_layer if traced else cell.end_to_end, cell.bench_dir, records)
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        if cuda:
            dev["power_limit_w"] = _power_limit_w()
        result = {"correct": bool(ok and failed == 0), "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": dev}
        if traced and traced_rec is not None:
            _log_trace(traced_rec)
            dev["busy_s"] = layers.busy_s(traced_rec["trace"])
            w0, w1 = traced_rec["trace"]["window"]
            dev["window_s"] = (w1 - w0) * 1e-9
            result["breakdown"] = trace.breakdown(traced_rec["trace"])
        result["checks"] = {name: {"value": value, "limit": lim, "relation": rel}
                            for name, value, rel, lim in rows}
        result["detail"] = detail
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = common.cell_for(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    checks = result.pop("checks")
    result.pop("detail")
    result["checks"] = checks  # the compared numbers come last
    for name, c in checks.items():
        _log(f"check {name} = {c['value']!r} ({c['relation']} {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
