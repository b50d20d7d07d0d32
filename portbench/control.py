"""Readings for the limits of ``correct``: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 101,102,... [--units 2]
                                 [--faults "half frozen,..."]

For each seed, in one process: the cell's inputs from the seed, one
warm-up unit, ``--units`` timed units at the cell's own size (fits, or
survey batches), then the numbers that decide ``correct`` twice: the
program's (what its units recorded and wrote, against the float64
reference) and the control's (the reference computed at TF32, put in the
program's place on the same rows); with ``--faults``, each named fault
of :mod:`portbench.faults` planted under a run of its own, its numbers
too.  One JSON line a seed.  The
benchmark's own runs never run this; its readings set the limits in
``limits/<cell>.json`` (the program's largest, the control's smallest).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import faults  # noqa: E402
from portbench.harness import check, common, generator  # noqa: E402


def _units(cell, seed, units, device, sizes, workdir):
    traffic = generator.make_traffic(cell, seed, workdir, device, sizes)
    traffic.unit(0)
    done = [traffic.unit(i) for i in range(1, units + 1)]
    traffic.model = None
    return traffic, done


def readings(cell, seed, units, device, sizes=None, planted=()):
    """``{"program": numbers, "control": numbers, <fault>: numbers, ...}``
    of one seed; a fault whose run or comparison raises reads its error."""
    out = {}
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        traffic, done = _units(cell, seed, units, device, sizes, workdir)
        out["program"] = check.check_units(traffic, done, seed)[0]
        out["control"] = check.check_units(traffic, done, seed, control=True)[0]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name in planted:
        workdir = tempfile.mkdtemp(prefix="portbench-fault-")
        try:
            with faults.planted(name):
                traffic, done = _units(cell, seed, units, device, sizes, workdir)
            out[name] = check.check_units(traffic, done, seed)[0]
        except Exception as exc:  # noqa: BLE001 - a fault that crashes has failed
            out[name] = {"raised": repr(exc)[:200]}
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--units", type=int, default=2)
    parser.add_argument("--faults", default="")
    args = parser.parse_args(argv)
    cell = common.cell_for(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from psfmc_tpu_torch.ops.kernels import _build

    _build.build_all()
    for seed in (int(s) for s in args.seeds.split(",")):
        planted = [f for f in args.faults.split(",") if f]
        out = readings(cell, seed, args.units, "cuda", planted=planted)
        print(json.dumps(dict(cell=cell.name, seed=seed, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
