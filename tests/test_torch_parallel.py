"""The port's walker mesh in one process, against the JAX package's, on the CPU.

* ``pad_walkers_to_mesh`` equals the JAX package's for mesh sizes 1, 2,
  4 and 8 and 1 to 40 walkers, and each rank's rows of an even split are
  the index ranges of the JAX ``shard_walkers``'s addressable shards on
  the 8-device virtual CPU mesh (``tests/conftest.py``); an uneven split
  covers every row once, its counts differing by at most one;
* a fit given a mesh of one process (``walker_mesh("cpu")``) equals the
  fit without a mesh bit for bit: the fitting driver at 24x24 with 32
  walkers, and the ensemble, tempered and NUTS samplers given its
  sharding;
* the posterior-mean images merged from two halves of a batch in rank
  order (the Chan formula) equal the whole batch's within 1e-12 in
  float64;
* ``fetch``, ``put_sharded``, ``put_replicated``, ``is_primary``,
  ``process_index``, ``process_count`` and ``barrier`` in one process, and
  the type checks of ``mesh=`` and ``sharding=``.

The two-process runs are ``tests/test_torch_multiprocess.py``.  Each test
runs torch on one thread.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
from psfmc_tpu import parallel as jpar
from psfmc_tpu_torch import model_galaxy_mcmc, parallel
from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.parallel import mesh as tmesh
from psfmc_tpu_torch.parallel.posterior import merge_rank_means, shard_posterior
from psfmc_tpu_torch.sampler import EnsembleSampler, NUTSSampler, PTEnsembleSampler
from test_torch_io import MODEL, _write_inputs


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ranks(size):
    """A mesh object of ``size`` ranks for each rank (the split's
    arithmetic only; no process group)."""
    out = []
    for r in range(size):
        m = tmesh.WalkerMesh("cpu")
        m.size, m.rank = size, r
        out.append(m)
    return out


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_padding_and_row_ranges_match_jax(size):
    jmesh = jpar.walker_mesh(jax.devices()[:size])
    meshes = _ranks(size)
    for n in range(1, 41):
        assert parallel.pad_walkers_to_mesh(n, meshes[0]) == jpar.pad_walkers_to_mesh(n, jmesh)
        spans = [m.rows(n) for m in meshes]
        assert spans == meshes[0].split(n)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        counts = [hi - lo for lo, hi in spans]
        assert max(counts) - min(counts) <= 1
        if n % size:
            continue
        arr = jpar.shard_walkers(np.arange(n * 3.0).reshape(n, 3), jmesh)
        order = list(jmesh.devices.flat)
        want = sorted((order.index(s.device), (s.index[0].start or 0,
                                              s.index[0].stop if s.index[0].stop is not None
                                              else n)) for s in arr.addressable_shards)
        assert [span for _, span in want] == spans


def test_block_splits_keep_whole_targets():
    meshes = _ranks(2)
    assert [m.rows(5 * 8, blocks=5) for m in meshes] == [(0, 16), (16, 40)]
    assert [m.rows(4 * 6, blocks=4) for m in meshes] == [(0, 12), (12, 24)]
    with pytest.raises(ValueError, match="do not split into 3 blocks"):
        meshes[0].rows(10, blocks=3)


def test_one_process_helpers():
    mesh = parallel.walker_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.graphed) == (1, 0, None, False)
    assert parallel.is_primary() and parallel.process_index() == 0
    assert parallel.process_count() == 1
    parallel.barrier("test")  # a no-op in one process
    arr = np.arange(12.0).reshape(6, 2)
    sharded = parallel.shard_walkers(arr, mesh)
    assert sharded.shape == (6, 2) and torch.equal(sharded.local, torch.as_tensor(arr))
    np.testing.assert_array_equal(parallel.fetch(sharded), arr)
    np.testing.assert_array_equal(parallel.fetch(parallel.put_replicated(arr, mesh)), arr)
    assert parallel.fetch(torch.arange(3), np.float64).dtype == np.float64
    np.testing.assert_array_equal(parallel.fetch([1, 2]), [1, 2])
    assert parallel.walker_sharding(mesh).mesh is mesh
    for bad in (object(), "cpu"):
        with pytest.raises(TypeError, match="WalkerMesh"):
            parallel.walker_sharding(bad)
        with pytest.raises(TypeError, match="WalkerSharding"):
            EnsembleSampler(4, 1, None, device="cpu", sharding=bad)
    with pytest.raises(ValueError, match="2 devices for 1 processes"):
        parallel.walker_mesh(["cpu", "cpu"])


def test_driver_on_a_one_process_mesh_is_the_unsharded_fit(tmp_path, capsys):
    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    mesh = parallel.walker_mesh(["cpu"])
    assert "walker mesh: 1 process(es), backend none, cpu: steps eager" in \
        capsys.readouterr().out
    dbs = []
    for name, kw in (("plain", {"device": "cpu"}), ("mesh", {"mesh": mesh})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            dbs.append(model_galaxy_mcmc(str(tmp_path / "model.py"),
                                         output_name=str(tmp_path / name), chains=32,
                                         burn=4, iterations=4, seed=3, **kw))
    assert dbs[0].colnames == dbs[1].colnames
    for col in dbs[0].colnames:
        np.testing.assert_array_equal(dbs[0][col], dbs[1][col], err_msg=col)


@pytest.mark.parametrize("kind", ["ensemble", "tempered", "nuts"])
def test_samplers_on_a_one_process_mesh_are_unsharded(kind):
    spec = build_model_spec(flagship_components((24, 24), (12, 12)))
    post = build_posterior(spec, device="cpu", lnpost="batched")
    p0 = prior_draws(spec, 32, seed=4)
    sharding = parallel.walker_sharding(parallel.walker_mesh("cpu"))
    cls, kw = {"ensemble": (EnsembleSampler, {}),
               "tempered": (PTEnsembleSampler, {"ntemps": 2}),
               "nuts": (NUTSSampler, {"max_depth": 2})}[kind]
    n = 8 if kind == "nuts" else 32
    runs = []
    for sh in (None, sharding):
        sm = cls(n, spec.num_params, post, seed=1, device="cpu", sharding=sh, **kw)
        sm.init_state(p0)
        sm.run_burn(2)
        sm.reset()
        sm.run_sampling(2)
        runs.append(sm)
    np.testing.assert_array_equal(runs[0].chain, runs[1].chain)
    np.testing.assert_array_equal(runs[0].lnprobability, runs[1].lnprobability)
    for k, v in (runs[0].accumulated_images or {}).items():
        np.testing.assert_array_equal(v, runs[1].accumulated_images[k])


def test_rank_means_merge_to_the_batch_means():
    spec = build_model_spec(flagship_components((24, 24), (12, 12)))
    post = build_posterior(spec, device="cpu", dtype=torch.float64, lnpost="batched")
    thetas = torch.as_tensor(prior_draws(spec, 13, seed=5), dtype=torch.float64)
    whole = post.ensemble_carry_means(thetas)
    for cut in (6, 1, 12):
        merged = merge_rank_means([post.ensemble_carry_means(thetas[:cut]),
                                   post.ensemble_carry_means(thetas[cut:])],
                                  [cut, 13 - cut])
        assert set(merged) == set(whole)
        for k, v in whole.items():
            np.testing.assert_allclose(merged[k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(v.abs().max()), err_msg=k)
    # without a process group the sharded posterior is the posterior's own calls
    sp = shard_posterior(post, parallel.walker_sharding(parallel.walker_mesh("cpu")))
    assert sp.log_posterior_batch == post.log_posterior_batch
    assert sp.ensemble_carry_means == post.ensemble_carry_means
    assert sp.device == post.device and shard_posterior(sp, None) is sp
