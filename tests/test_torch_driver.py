"""The port's model-file driver and its database against the JAX package's, on the CPU.

A trace database written by either package is read by the other; the
posterior images replayed from a JAX-written database match the JAX
package's; a tiny ``model_galaxy_mcmc(device="cpu")`` run resumes from
its checkpoint exactly, and the resume guards refuse a checkpoint for
changed data, for another generator, and (a deliberate divergence from
the JAX driver) a complete database for changed data.
"""
import types
import warnings

import numpy as np
import pytest
import torch

from psfmc_tpu import database as jdb
from psfmc_tpu.analysis.images import save_posterior_images as jax_save_images
from psfmc_tpu.analysis.statistics import check_convergence_autocorr as jax_converged
from psfmc_tpu.model_parser import component_list_from_file as jparse
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch import model_galaxy_mcmc
from psfmc_tpu_torch.analysis.images import save_posterior_images
from psfmc_tpu_torch.analysis.statistics import check_convergence_autocorr
from psfmc_tpu_torch.io import fits as tfits
from psfmc_tpu_torch.models import as_model
from psfmc_tpu_torch.sampler import EnsembleSampler
from test_torch_io import MODEL, _write_inputs


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NAMES = ["0_Sky_adu", "1_PointSource_mag", "1_PointSource_xy"]
LENS = [1, 1, 2]
NW, NITER = 6, 5
IMAGES = ("raw_model", "convolved_model", "composite_ivm", "residual",
          "point_source_subtracted")


def _chain(seed=0):
    rng = np.random.RandomState(seed)
    chain = rng.randn(NW, NITER, 4)
    return chain, -1e3 + rng.randn(NW, NITER)


def _fake_sampler(chain, lnp, payload):
    return types.SimpleNamespace(
        chain=chain, lnprobability=lnp, nwalkers=chain.shape[0],
        state=object(), checkpoint_kind="ensemble",
        checkpoint_payload=lambda: dict(payload))


def _payload(chain, lnp, jax_style):
    nw, niter = lnp.shape
    pay = {"version": 2, "ntemps": 1, "positions": chain[:, -1],
           "log_prob": lnp[:, -1], "naccept": np.arange(nw), "nsteps": niter,
           "accum": {"raw": np.ones((3, 4)), "raw_m2": np.zeros((3, 4))},
           "accum_count": nw * niter}
    if jax_style:
        pay["key"] = np.array([0, 42], np.uint32)
    else:
        pay["rng_kind"] = "torch-cpu"
        pay["rng_state"] = torch.Generator().manual_seed(3).get_state().numpy()
    return pay


META = {"MCITER": NITER, "MCBURN": 7, "MCCHAINS": NW, "MCCONVRG": False,
        "MCACCEPT": 0.25, "MCDATSUM": 123456}


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_database_is_read_across_packages(tmp_path, writer):
    chain, lnp = _chain()
    model = types.SimpleNamespace(param_names=NAMES, param_lens=LENS)
    path = str(tmp_path / "db.fits")
    save = {"torch": tdb.save_database, "jax": jdb.save_database}[writer]
    save(_fake_sampler(chain, lnp, _payload(chain, lnp, writer == "jax")),
         model, path, meta_dict=dict(META))
    tables = {"torch": tdb.load_database(path), "jax": jdb.load_database(path)}
    for tbl in tables.values():
        assert tbl.colnames == NAMES + ["lnprobability", "walker", "sample"]
        assert len(tbl) == NW * NITER
        np.testing.assert_array_equal(tbl["1_PointSource_xy"],
                                      chain[..., 2:].reshape(-1, 2))
        np.testing.assert_array_equal(tbl["lnprobability"], lnp.reshape(-1))
        assert tbl["walker"].dtype == tbl["sample"].dtype == np.int64
        np.testing.assert_array_equal(tbl["sample"], np.tile(np.arange(NITER), NW))
        best = int(np.argmax(lnp.reshape(-1)))
        assert tbl.meta["MAPWLKR"] == best // NITER
        assert tbl.meta["MAPSAMP"] == best % NITER
        for key, val in META.items():
            assert tbl.meta[key] == val, key
    t, j = tables["torch"], tables["jax"]
    assert list(t.meta.items()) == list(j.meta.items())
    for name in t.colnames:
        assert t[name].dtype == j[name].dtype and t[name].shape == j[name].shape

    ckpt = tdb.load_checkpoint(path)
    np.testing.assert_array_equal(ckpt["positions"], chain[:, -1])
    assert ckpt["accum_count"] == NW * NITER and sorted(ckpt["accum"]) == ["raw", "raw_m2"]
    if writer == "jax":
        assert ckpt["rng_kind"] == "jax" and ckpt["rng_state"] is None
    else:
        assert ckpt["rng_kind"] == "torch-cpu"
        np.testing.assert_array_equal(ckpt["rng_state"],
                                      _payload(chain, lnp, False)["rng_state"])


@pytest.fixture
def model_dir(tmp_path):
    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    return tmp_path


def test_posterior_images_replayed_from_a_jax_database(model_dir):
    """save_posterior_images in replay mode on a database the JAX package
    wrote: the five images within 1e-4 of the JAX package's."""
    path = str(model_dir / "model.py")
    tmodel = as_model(path, device="cpu")
    jmodel = JaxModel(jparse(path))
    rng = np.random.RandomState(5)
    nw, niter = 8, 4
    chain = tmodel.init_params_from_priors(nw * niter, random_state=rng)
    chain = chain.reshape(nw, niter, -1)
    lnp = -1e3 + rng.randn(nw, niter)
    sampler = types.SimpleNamespace(chain=chain, lnprobability=lnp,
                                    nwalkers=nw, state=None)
    db_path = str(model_dir / "jax_db.fits")
    jdb.save_database(sampler, jmodel, db_path, meta_dict=dict(META))
    jax_save_images(jmodel, jdb.load_database(db_path),
                    output_name=str(model_dir / "jax_{}"), ppc_draws=40)
    save_posterior_images(tmodel, tdb.load_database(db_path),
                          output_name=str(model_dir / "torch_{}"), ppc_draws=40)
    for ftype in IMAGES:
        want = tfits.getdata(str(model_dir / f"jax_{ftype}.fits"))
        got = tfits.getdata(str(model_dir / f"torch_{ftype}.fits"))
        # float32 images on both sides: 1e-4 relative, of the peak
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=ftype)
    th = tfits.getheader(str(model_dir / "torch_residual.fits"))
    jh = tfits.getheader(str(model_dir / "jax_residual.fits"))
    for key in ("MCITER", "MCDATSUM", "0SKY_ADU", "1PS_XY", "PSFIMG", "OBJECT"):
        assert th[key] == jh[key], key
    assert th["MCCHI2NU"] == pytest.approx(jh["MCCHI2NU"], rel=1e-4)
    assert abs(th["MCPPCP"] - jh["MCPPCP"]) <= 2.0 / 42


def test_image_header_stats_do_not_hide_a_failing_render(model_dir):
    """A render that fails while the header stats are computed (a kernel
    launch, on the card) propagates; the JAX writer turns it into a
    warning and a missing MCCHI2NU / MCPPCP card."""
    tmodel = as_model(str(model_dir / "model.py"), device="cpu")
    chain = tmodel.init_params_from_priors(8, random_state=np.random.RandomState(2))
    sampler = types.SimpleNamespace(chain=chain.reshape(4, 2, -1), nwalkers=4,
                                    lnprobability=-1e3 + np.arange(8.0).reshape(4, 2),
                                    state=None)
    db_path = str(model_dir / "db.fits")
    tdb.save_database(sampler, tmodel, db_path, meta_dict=dict(META, MCCHAINS=4))

    def failing_render(thetas):
        raise RuntimeError("render launch failed")

    tmodel.render_images_batch = failing_render
    with pytest.raises(RuntimeError, match="render launch failed"):
        save_posterior_images(tmodel, tdb.load_database(db_path),
                              output_name=str(model_dir / "out_{}"), ppc_draws=4)


def test_accumulate_images_matches_jax(model_dir):
    """Running means over image dicts, composite_ivm averaged as a
    variance (reference models.py:74-97), as the JAX package does."""
    path = str(model_dir / "model.py")
    models = (as_model(path, device="cpu"), JaxModel(jparse(path)))
    rng = np.random.RandomState(8)
    batches = [[{t: rng.uniform(0.5, 2.0, (24, 24)) for t in IMAGES}
                for _ in range(n)] for n in (3, 2)]
    for model in models:
        model.reset_images()
        for batch in batches:
            model.accumulate_images(batch)
    assert models[0].accumulated_samples == models[1].accumulated_samples == 5
    for t in IMAGES:
        np.testing.assert_allclose(models[0].posterior_images[t],
                                   models[1].posterior_images[t], rtol=1e-14)


def _run(model_dir, **kw):
    args = dict(output_name=str(model_dir / "out"), chains=24, burn=8,
                iterations=6, seed=0, device="cpu", checkpoint_interval=3)
    args.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "not yet converged"
        return model_galaxy_mcmc(str(model_dir / "model.py"), **args)


def test_driver_runs_and_resumes_exactly(model_dir, capsys):
    db6 = _run(model_dir)
    assert len(db6) == 24 * 6 and db6.meta["MCITER"] == 6
    for ftype in IMAGES:
        img = tfits.getdata(str(model_dir / f"out_{ftype}.fits"))
        assert img.shape == (24, 24) and np.all(np.isfinite(img))
    assert tfits.getheader(str(model_dir / "out_raw_model.fits"))["PSFIMG"] == "psf.fits"
    # the JAX package reads the port's database
    assert jdb.load_database(str(model_dir / "out_db.fits")).colnames == db6.colnames

    db12 = _run(model_dir, iterations=12)
    assert "Resuming from checkpoint" in capsys.readouterr().out
    assert len(db12) == 24 * 12 and db12.meta["MCITER"] == 12
    fresh = _run(model_dir, iterations=12, output_name=str(model_dir / "fresh"))
    # the generator state, positions and accumulators were restored
    # exactly: the resumed chain is the uninterrupted one
    for name in db12.colnames:
        np.testing.assert_array_equal(db12[name], fresh[name], err_msg=name)
    for ftype in IMAGES:
        np.testing.assert_array_equal(
            tfits.getdata(str(model_dir / f"out_{ftype}.fits")),
            tfits.getdata(str(model_dir / f"fresh_{ftype}.fits")), err_msg=ftype)


def test_resume_guards(model_dir, capsys):
    _run(model_dir)
    sci = str(model_dir / "sci.fits")
    tfits.writeto(sci, tfits.getdata(sci) + 1e-3)  # the data changed
    with pytest.warns(UserWarning, match="MCDATSUM mismatch"):
        db = model_galaxy_mcmc(str(model_dir / "model.py"),
                               output_name=str(model_dir / "out"), chains=24,
                               burn=8, iterations=8, device="cpu")
    assert len(db) == 24 * 8  # re-run from scratch, not resumed

    # a complete database: skipped when it matches ...
    _run(model_dir, iterations=8)
    assert "already contains sampled chains" in capsys.readouterr().out
    # ... and re-sampled when the data changed since (the JAX driver
    # skips its guards here and would write images of the old chain)
    tfits.writeto(sci, tfits.getdata(sci) - 1e-3)
    with pytest.warns(UserWarning, match="MCDATSUM mismatch"):
        db = model_galaxy_mcmc(str(model_dir / "model.py"),
                               output_name=str(model_dir / "out"), chains=24,
                               burn=8, iterations=4, device="cpu")
    assert len(db) == 24 * 4
    assert "already contains" not in capsys.readouterr().out


def test_jax_checkpoint_generator_is_refused(model_dir):
    db = _run(model_dir)
    path = str(model_dir / "out_db.fits")
    mc = as_model(str(model_dir / "model.py"), device="cpu")
    chain = np.stack([np.concatenate([np.atleast_1d(v) for v in row])
                      for row in db[mc.param_names]]).reshape(24, 6, -1)
    lnp = np.asarray(db["lnprobability"]).reshape(24, 6)
    pay = _payload(chain, lnp, jax_style=True)
    pay["accum"] = None
    jdb.save_database(_fake_sampler(chain, lnp, pay), mc, path,
                      meta_dict={k: db.meta[k] for k in ("MCITER", "MCBURN",
                                                         "MCCHAINS", "MCDATSUM")})
    with pytest.warns(UserWarning, match="'jax' generator"):
        db = model_galaxy_mcmc(str(model_dir / "model.py"),
                               output_name=str(model_dir / "out"), chains=24,
                               burn=8, iterations=10, device="cpu")
    assert len(db) == 24 * 10


@pytest.mark.parametrize("kw", [
    dict(sampler="nuts", criticism=True, mesh=object()), dict(sampler="nuts", mesh=object()),
    dict(ntemps=3, criticism=True, mesh=object()), dict(criticism=True, mesh=object()),
    dict(mesh=object()),
])
def test_driver_raises_outside_the_slice(kw):
    """A mesh that is not a :class:`~psfmc_tpu_torch.parallel.WalkerMesh`
    is refused with every sampler, with or without criticism, before the
    model file is read (a mesh itself runs:
    tests/test_torch_parallel.py, tests/test_torch_multiprocess.py)."""
    with pytest.raises(TypeError, match="mesh must be a psfmc_tpu_torch.parallel.WalkerMesh"):
        model_galaxy_mcmc("no_such_model.py", device="cpu", **kw)


def test_driver_writes_a_de_database(model_dir):
    """``moves="de"`` runs through the driver and writes its database."""
    db = _run(model_dir, moves="de")
    assert len(db) == 24 * 6 and db.meta["MCITER"] == 6
    assert np.all(np.isfinite(db["lnprobability"]))
    assert 0.0 < db.meta["MCACCEPT"] < 1.0
    assert tdb.load_checkpoint(str(model_dir / "out_db.fits"))["rng_kind"] == "torch-cpu"


def test_joint_model_file_builds_as_jax(model_dir):
    """A model file with two ``Configuration`` components builds a joint
    model in both packages (the same layout, each band its own data), and
    the single-band class given it warns that it uses only the first."""
    from psfmc_tpu.models.joint import JointModel as JaxJoint
    from psfmc_tpu.models.multicomponent import as_model as jax_as_model
    from psfmc_tpu_torch.models import JointModel, MultiComponentModel

    text = MODEL + MODEL.split("\n", 3)[3].split("Sky(")[0]  # a 2nd Configuration
    path = str(model_dir / "joint.py")
    (model_dir / "joint.py").write_text(text)
    own, jm = as_model(path, device="cpu"), jax_as_model(path)
    assert isinstance(own, JointModel) and isinstance(jm, JaxJoint)
    assert own.param_names == list(jm.param_names)
    assert [b.shape for b in own.spec.band_specs] == [b.shape for b in jm.spec.band_specs]
    assert len(own.spec.band_specs) == 2 and own.spec.band_specs[1].comp_specs[0].kind \
        == "psfselector"
    with pytest.warns(UserWarning, match="only the first"):
        MultiComponentModel(path, device="cpu")


class _Gaussian2D:
    device = torch.device("cpu")
    dtype = torch.float64

    def log_posterior_batch(self, x):
        return -0.5 * (x * x).sum(dim=1)


def test_rejuvenate_stuck_moves_only_stragglers():
    s = EnsembleSampler(10, 2, _Gaussian2D(), seed=1, device="cpu")
    p0 = np.random.RandomState(2).randn(10, 2)
    p0[3] = [100.0, 100.0]  # lnp -1e4: far below the bulk
    s.init_state(p0)
    assert s.rejuvenate_stuck(random_state=0) == 1
    pos = s.state.positions.numpy()
    assert np.all(np.abs(pos[3]) < 10) and any(np.array_equal(pos[3], p) for p in p0)
    np.testing.assert_array_equal(np.delete(pos, 3, 0), np.delete(p0, 3, 0))
    p0[:5] = 100.0 + np.arange(5)[:, None]  # half the ensemble: refuse
    s.init_state(p0)
    assert s.rejuvenate_stuck(random_state=0) == 0


def test_checkpoint_payload_restores_the_stream():
    s = EnsembleSampler(8, 2, _Gaussian2D(), seed=4, device="cpu")
    s.init_state(np.random.RandomState(6).randn(8, 2))
    s.run_sampling(5)
    payload = s.checkpoint_payload()
    r = EnsembleSampler(8, 2, _Gaussian2D(), seed=99, device="cpu")
    r.restore_state(payload)
    np.testing.assert_array_equal(r.acceptance_fraction, s.acceptance_fraction)
    s.run_sampling(7, segment=3)
    r.run_sampling(7)
    np.testing.assert_array_equal(r.chain, s.chain[:, 5:])
    with pytest.raises(ValueError, match="cannot be restored"):
        r.restore_state(dict(payload, rng_kind="jax"))


def test_convergence_check_matches_jax():
    rng = np.random.RandomState(7)
    chain = np.cumsum(rng.randn(6, 400, 3), axis=1) * 0.05 + rng.randn(6, 400, 3)
    s = EnsembleSampler(6, 3, _Gaussian2D(), device="cpu")
    s._chain = chain
    fake = types.SimpleNamespace(chain=chain, get_autocorr_time=s.get_autocorr_time)
    from psfmc_tpu.sampler.autocorr import integrated_time

    np.testing.assert_array_equal(s.get_autocorr_time(c=1),
                                  integrated_time(chain.mean(axis=0), axis=0, c=1))
    for ratio in (2, 10, 50):
        assert check_convergence_autocorr(s, ratio) == jax_converged(fake, ratio)


@pytest.mark.parametrize("moves", ["stretch", "mixed"])
def test_posterior_moments_match_jax(moves):
    """The moment-parity criterion of ``tests/test_moment_parity.py``
    (means within 5 Monte Carlo standard errors at tau = 25, stds within
    35%), the port's fused-path sampler against the JAX package's
    ensemble sampler on that file's Sersic + Sky workload, float64, the
    same starting positions and moves; two independent chains of 32
    walkers x (120 burn + 360 retained) steps."""
    import jax.numpy as jnp

    import test_moment_parity as M
    from psfmc_tpu import distributions as JD
    from psfmc_tpu.models.components import Configuration, Sersic, Sky
    from psfmc_tpu.models.posterior import build_posterior as jax_posterior
    from psfmc_tpu.models.spec import build_model_spec as jax_spec
    from psfmc_tpu.sampler.ensemble import EnsembleSampler as JaxSampler
    from psfmc_tpu_torch.models import build_posterior, spec_from_numpy
    from test_torch_posterior import _numpy_fields

    h = w = M.H
    rng = np.random.RandomState(99)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    psf = np.exp(-((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / (2 * 1.2**2))
    psf /= psf.sum()
    t = M.TRUTH
    truth = t["adu"] + M._np_sersic(xx, yy, t["x"], t["y"], t["mag"], t["reff"],
                                    t["reff_b"], t["index"], t["angle"], M.ZP)
    obs = np.fft.irfft2(np.fft.rfft2(truth) * np.fft.rfft2(np.fft.ifftshift(psf)),
                        s=(h, w)) + rng.randn(h, w) * M.NOISE
    U = JD.Uniform
    spec = jax_spec([
        Configuration(obs_file=obs, obsivm_file=np.full((h, w), M.NOISE**-2),
                      psf_files=psf, psfivm_files=np.full_like(psf, 1e12),
                      mag_zeropoint=M.ZP),
        Sky(adu=U(loc=0.0, scale=0.2)),
        Sersic(xy=U(loc=np.array([8.0, 8.0]), scale=np.array([8.0, 8.0])),
               mag=U(loc=19.0, scale=2.0), reff=U(loc=1.0, scale=5.0),
               reff_b=U(loc=1.0, scale=5.0), index=U(loc=0.5, scale=3.5),
               angle=U(loc=0.0, scale=180.0), angle_degrees=True),
    ])
    base = np.array([t["adu"], t["angle"], t["index"], t["mag"], t["reff"],
                     t["reff_b"], t["x"], t["y"]])
    r = np.random.RandomState(5)
    p0 = base + r.randn(32, 8) * np.array([0.01, 5.0, 0.1, 0.05, 0.15, 0.15, 0.2, 0.2])
    p0[:, 4:6] = np.sort(p0[:, 4:6], axis=1)[:, ::-1]  # reff >= reff_b

    flats = []
    for sampler in (
        JaxSampler(32, 8, jax_posterior(spec, dtype=jnp.float64), seed=3,
                   moves=moves),
        EnsembleSampler(32, 8, build_posterior(
            spec_from_numpy(**_numpy_fields(spec)), device="cpu",
            dtype=torch.float64, lnpost="fused"), seed=3, device="cpu",
            moves=moves),
    ):
        sampler.init_state(p0)
        sampler.run_burn(120)
        sampler.reset()
        sampler.run_sampling(360)
        flats.append(sampler.flatchain)
    jax_flat, port_flat = flats
    se = jax_flat.std(axis=0) * np.sqrt(25.0 / len(jax_flat))
    assert np.all(np.abs(port_flat.mean(axis=0) - jax_flat.mean(axis=0)) < 5 * se + 1e-3)
    np.testing.assert_allclose(port_flat.std(axis=0), jax_flat.std(axis=0), rtol=0.35)
