"""What every run shares: ``BENCHMARK.json``, and finding each piece by its name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's ``file`` is ``configs/<name>.json``, the mix is
``traffic/<name>.json`` (data that :mod:`.generator` reads), each metric
is ``metrics/<name>.py`` with a ``read(records)`` function, and each
cell's limits of the comparison that decides ``correct`` are
``limits/<cell>.json``.  Nothing here lists a cell, a mix or a metric:
a new one is a new file and a new entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

__all__ = ["ROOT", "BENCH_DIR", "Cell", "load_benchmark", "cell_for", "load_metric",
           "FORBIDDEN", "forbidden_modules"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names no run may hold: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "psfmc_tpu", "psfMC")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``sys.modules``, compared whole
    (``psfmc_tpu_torch`` is not ``psfmc_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metrics resolved."""

    def __init__(self, bench, entry, root=ROOT):
        self.name = entry["name"]
        self.entry = entry
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[entry["config"]]
        self.config = _load_json(os.path.join(root, self.config_entry["file"]))
        bench_dir = os.path.join(root, os.path.dirname(self.config_entry["file"]), "..")
        self.bench_dir = os.path.normpath(bench_dir)
        self.traffic = _load_json(os.path.join(self.bench_dir, "traffic",
                                               entry["traffic"] + ".json"))
        limits = os.path.join(self.bench_dir, "limits", self.name + ".json")
        self.limits = _load_json(limits) if os.path.exists(limits) else {}
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m, bench)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m, bench)]

    def _reports(self, metric, bench):
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:  # a per-layer metric without a list: the cells
            moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
            return self._reports(moved, bench)
        return True


def cell_for(name, root=ROOT):
    bench = load_benchmark(root)
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return Cell(bench, entry, root)
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_metric(bench_dir, name):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
