"""One rank of the port's two-process CPU run (``tests/test_torch_multiprocess.py``).

``python torch_multiprocess_worker.py <rank> <world> <store> <datadir> <outdir> <shared>``
joins a gloo group through the ``file://`` store, makes the walker mesh
on the CPU and runs every sharded entry point at a small size from its
own working directory ``outdir``: the fitting driver (ensemble), a
second driver pair in the ``shared`` directory (a fit, then a call that
asks for more samples and must resume from the checkpoint), parallel
tempering, NUTS, annealed importance sampling (8 groups, and 7, which
must raise), ``fit_batch`` with 4 targets and with 3 (padded to 4) and
``fit_hierarchical`` with ``shard="targets"`` and ``"chains"``.  Every
result goes to ``<outdir>/result_<rank>.npz``; the test holds the ranks
to each other and to the same calls in one process (:func:`run_all` with
``mesh=None``).  Imports no JAX.
"""
import datetime
import os
import sys
import warnings

import numpy as np
import torch

MODEL = """
from numpy import array
from psfMC.ModelComponents import Configuration, Sky, PointSource
from psfMC.distributions import Normal, Uniform

Configuration(obs_file='sci.fits', obsivm_file='ivm.fits',
              psf_files='psf.fits', psfivm_files='psf_ivm.fits',
              mag_zeropoint=25.0)
Sky(adu=Normal(loc=0.02, scale=0.01))
PointSource(xy=Uniform(loc=array((12., 12.)), scale=array((8., 8.))),
            mag=Uniform(loc=19.0, scale=1.5))
"""

CHAINS, BURN, ITERS = 16, 6, 6
AIS = dict(nwalkers=64, nsteps=6, sweeps=1, moves="mixed")
BATCH = dict(nwalkers=8, burn=3, iterations=4, seed=19)
HIER_K, HIER_HW = 4, 12


def write_data(d):
    """The 32x32 point-source observation, PSF and model file."""
    from psfmc_tpu_torch.io import fits

    rng = np.random.RandomState(1234)
    h = w = 32
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    psf = np.exp(-((xx - 16) ** 2 + (yy - 16) ** 2) / (2 * 1.5**2))
    psf /= psf.sum()
    truth = np.full((h, w), 0.02)
    truth[15, 17] += 10 ** (-0.4 * (19.8 - 25.0))
    conv = np.fft.irfft2(np.fft.rfft2(truth) * np.fft.rfft2(np.fft.ifftshift(psf)),
                         s=truth.shape)
    sig = 0.004
    obs = conv + rng.randn(h, w) * sig
    fits.writeto(os.path.join(d, "sci.fits"), obs.astype(np.float32))
    fits.writeto(os.path.join(d, "ivm.fits"), (np.ones_like(obs) / sig**2).astype(np.float32))
    fits.writeto(os.path.join(d, "psf.fits"), psf.astype(np.float32))
    fits.writeto(os.path.join(d, "psf_ivm.fits"), (np.ones_like(psf) * 1e8).astype(np.float32))
    with open(os.path.join(d, "model.py"), "w") as fh:
        fh.write(MODEL)


def _hier_inputs():
    """A sky-only template at 12x12 in float64, 4 targets, a normal
    population on the sky level."""
    from psfmc_tpu_torch import distributions as D
    from psfmc_tpu_torch.hierarchy import NormalPopulation
    from psfmc_tpu_torch.models import MultiComponentModel
    from psfmc_tpu_torch.models import components as C

    hw, noise = HIER_HW, 0.5
    psf = np.zeros((8, 8))
    psf[4, 4] = 1.0
    model = MultiComponentModel(
        [C.Configuration(obs_file=np.zeros((hw, hw)), obsivm_file=np.full((hw, hw), 4.0),
                         psf_files=psf, psfivm_files=np.full_like(psf, 1e12),
                         mag_zeropoint=25.0),
         C.Sky(adu=D.Uniform(loc=-2.0, scale=6.0))], device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(9)
    adus = 0.3 + 0.08 * rng.randn(HIER_K)
    obs = adus[:, None, None] + rng.randn(HIER_K, hw, hw) * noise
    pop = {"0_Sky_adu": NormalPopulation(mu=D.Uniform(loc=-1.0, scale=3.0),
                                         sigma=D.Uniform(loc=0.01, scale=0.6))}
    return model, obs, np.full((HIER_K, hw, hw), 1.0 / noise**2), pop


def run_all(datadir, outdir, shared, mesh):
    """Every sharded entry point (``mesh=None``: the one-process run);
    returns the results as a dict of arrays."""
    from psfmc_tpu_torch import model_galaxy_mcmc
    from psfmc_tpu_torch.batchfit import fit_batch, save_batch_results, simulate_stack
    from psfmc_tpu_torch.hierarchy import fit_hierarchical
    from psfmc_tpu_torch.models import MultiComponentModel
    from psfmc_tpu_torch.parallel import walker_sharding
    from psfmc_tpu_torch.sampler import NUTSSampler, PTEnsembleSampler, ais_evidence

    model_file = os.path.join(datadir, "model.py")
    out = {}
    os.chdir(outdir)
    common = dict(chains=CHAINS, seed=5, mesh=mesh, device="cpu", checkpoint_interval=3)
    db = model_galaxy_mcmc(model_file, output_name="out_mp", burn=BURN, iterations=ITERS,
                           **common)
    out.update(sky=db["0_Sky_adu"], mag=db["1_PointSource_mag"], lnp=db["lnprobability"],
               accept=np.float64(db.meta["MCACCEPT"]))
    # the shared directory: the second call must resume on every process
    res_kw = dict(common, output_name=os.path.join(shared, "out_res"), burn=BURN)
    model_galaxy_mcmc(model_file, iterations=ITERS, **res_kw)
    db2 = model_galaxy_mcmc(model_file, iterations=2 * ITERS, **res_kw)
    # a resumed call has no burn-in left to run
    out.update(res_sky=db2["0_Sky_adu"], res_lnp=db2["lnprobability"],
               res_burned=np.bool_("burn" in db2.phase_seconds))

    model = MultiComponentModel(model_file, device="cpu")
    sharding = None if mesh is None else walker_sharding(mesh)
    rng = np.random.RandomState(11)
    pt = PTEnsembleSampler(CHAINS, model.num_params, model.posterior_fns, ntemps=3, seed=7,
                           device="cpu", sharding=sharding)
    pt.init_state(model.init_params_from_priors(CHAINS, random_state=rng))
    pt.run_burn(3)
    pt.reset()
    pt.run_sampling(3)
    out.update(pt_chain=pt.chain, pt_lnp=pt.lnprobability)

    nuts = NUTSSampler(4, model.num_params, model.posterior_fns, seed=13, max_depth=3,
                       device="cpu", sharding=sharding)
    nuts.init_state(model.init_params_from_priors(32, random_state=rng))
    nuts.run_burn(3)
    nuts.reset()
    nuts.run_sampling(3)
    out.update(nuts_chain=nuts.chain, nuts_lnp=nuts.lnprobability,
               nuts_z=nuts.checkpoint_payload()["positions"])

    ais = ais_evidence(model.posterior_fns, groups=8, seed=3, mesh=mesh, **AIS)
    out.update(ais_lnz=np.float64(ais.lnz), ais_groups=ais.lnz_groups)
    if mesh is not None:
        try:
            ais_evidence(model.posterior_fns, groups=7, seed=3, mesh=mesh, **AIS)
        except ValueError as err:
            out["ais_refusal"] = np.array(str(err))

    obs, ivm, injected = simulate_stack(model, 4, seed=17)
    for k in (4, 3):
        # 3 targets over 2 processes are padded to 4 (the last one twice):
        # one process fits that padded stack, trimmed, for the comparison
        sl = slice(0, k) if mesh is not None or k == 4 else [0, 1, 2, 2]
        b = fit_batch(model, obs[sl], ivm[sl], mesh=mesh, device="cpu", **BATCH)
        out.update({f"batch{k}_{f}": getattr(b, f)[:k] for f in ("mean", "std", "map_lnp",
                                                                 "acceptance")})
    save_batch_results(b, "out_batch.fits")

    hmodel, hobs, hivm, pop = _hier_inputs()
    for shard in ("targets", "chains"):
        h = fit_hierarchical(hmodel, hobs, hivm, pop, chains=2, burn=3, iterations=3,
                             max_depth=3, init_pool=4, seed=2, mesh=mesh, shard=shard,
                             device="cpu")
        out.update({f"hier_{shard}_chain": h.flatchain, f"hier_{shard}_lnp": h.lnp})
    h.save("out_hier.fits")
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    rank, world, store, datadir, outdir, shared = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    warnings.simplefilter("ignore", UserWarning)  # "not yet converged", few walkers

    from psfmc_tpu_torch.parallel import (
        fetch,
        initialize,
        is_primary,
        process_count,
        shard_walkers,
        walker_mesh,
    )

    initialize("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
               timeout=datetime.timedelta(seconds=120))
    assert process_count() == world and is_primary() == (rank == 0)
    mesh = walker_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.backend, mesh.graphed) == (world, rank, "gloo", False)
    # each process holds its own rows; fetch gathers them all on every process
    arr = np.arange(13 * 3, dtype=np.float64).reshape(13, 3)
    sharded = shard_walkers(arr, mesh)
    lo, hi = mesh.rows(13)
    assert sharded.local.shape == (hi - lo, 3) and lo == rank * 13 // world
    np.testing.assert_array_equal(fetch(sharded), arr)
    result = run_all(datadir, outdir, shared, mesh)
    np.savez(os.path.join(outdir, f"result_{rank}.npz"), **result)
    print(f"worker {rank}: done", flush=True)


if __name__ == "__main__":
    main()
