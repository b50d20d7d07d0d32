"""The port's multi-process fits on the CPU: two gloo processes against one.

One module-scoped launch starts two workers (``tests/torch_multiprocess_
worker.py``), each on one torch thread, joined through a ``file://``
store with a 120 s collective timeout, while this process runs the same
calls without a mesh (:func:`torch_multiprocess_worker.run_all`).  Then:

* both processes hold the same chains, bit for bit, and so does the
  one-process run: the ensemble driver, its resumed call in a shared
  directory, parallel tempering, NUTS with 4 chains, ``fit_batch`` with 4
  targets and with 3 (padded to the mesh's 4; the one-process run fits
  the padded stack), ``fit_hierarchical`` with ``shard="chains"``;
  ``shard="targets"`` equals the one-process fit within 1e-10, and
  annealed importance sampling with 8 groups its lnZ within 1e-6;
* ``groups=7`` over 2 processes raises the JAX package's ``ValueError``;
* only the primary process writes files (the database, the image
  products, the catalog, the hierarchical trace), and the resumed call
  took the checkpoint path on both processes (its chain is the first
  call's, continued).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multiprocess_worker as W

WORLD = 2
TIMEOUT = 120
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two workers' results and output directories, and the
    one-process results."""
    root = tmp_path_factory.mktemp("torch_mp")
    datadir, shared = root / "data", root / "shared"
    for d in (datadir, shared):
        d.mkdir()
    W.write_data(str(datadir))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(HERE), env.get("PYTHONPATH")) if p)
    outdirs = [root / f"rank{r}" for r in range(WORLD)]
    procs = []
    for r, outdir in enumerate(outdirs):
        outdir.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_multiprocess_worker.py"), str(r),
             str(WORLD), str(root / "store"), str(datadir), str(outdir), str(shared)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True))
    cwd, threads = os.getcwd(), torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        single_shared = root / "single_shared"
        single_out = root / "single"
        for d in (single_shared, single_out):
            d.mkdir()
        single = W.run_all(str(datadir), str(single_out), str(single_shared), None)
        outputs = []
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out[-4000:]}"
    results = [dict(np.load(outdirs[r] / f"result_{r}.npz")) for r in range(WORLD)]
    return results, outdirs, single, outputs


def test_every_process_holds_the_same_chains(runs):
    results, _, _, _ = runs
    assert set(results[0]) == set(results[1])
    for key in results[0]:
        np.testing.assert_array_equal(results[0][key], results[1][key], err_msg=key)


@pytest.mark.parametrize("key", [
    "sky", "mag", "lnp", "accept", "res_sky", "res_lnp", "pt_chain", "pt_lnp",
    "nuts_chain", "nuts_lnp", "nuts_z", "batch4_mean", "batch4_std", "batch4_map_lnp",
    "batch4_acceptance", "batch3_mean", "batch3_std", "batch3_map_lnp",
    "batch3_acceptance", "hier_chains_chain", "hier_chains_lnp"])
def test_sharded_run_equals_the_one_process_run(runs, key):
    results, _, single, _ = runs
    np.testing.assert_array_equal(results[0][key], single[key])


def test_target_sharded_hierarchy_and_ais_match(runs):
    results, _, single, _ = runs
    for key in ("hier_targets_chain", "hier_targets_lnp"):
        np.testing.assert_allclose(results[0][key], single[key], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(results[0]["ais_groups"], single["ais_groups"], rtol=1e-6)
    assert abs(float(results[0]["ais_lnz"]) - float(single["ais_lnz"])) <= 1e-6 * max(
        1.0, abs(float(single["ais_lnz"])))
    assert "groups=7 must be a multiple of the mesh size (2)" in str(results[0]["ais_refusal"])


def test_only_the_primary_writes_and_both_resume(runs):
    results, outdirs, single, outputs = runs
    primary = sorted(f.name for f in outdirs[0].iterdir() if f.name != "result_0.npz")
    for name in ("out_mp_db.fits", "out_mp_residual.fits", "out_batch.fits",
                 "out_hier.fits"):
        assert name in primary
    assert [f.name for f in outdirs[1].iterdir()] == ["result_1.npz"]
    assert "Resuming from checkpoint" in outputs[0]  # printed by the primary alone
    assert "Resuming from checkpoint" not in outputs[1]
    for r in range(WORLD):  # the resumed call ran no burn-in on either process
        assert results[r]["res_lnp"].shape == (W.CHAINS * 2 * W.ITERS,)
        assert not results[r]["res_burned"]
    assert not single["res_burned"]
