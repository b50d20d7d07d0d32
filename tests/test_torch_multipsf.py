"""Several PSFs, padding and oversampling in the port against the JAX package, on the CPU.

``bin_psf``, the batched sub-pixel window (``ops/oversample.py``) and the
padded render grid against the JAX package's functions on the same
seeded numpy inputs; the image writer's ``PSFIMG`` (the MAP sample's PSF)
and its Poisson ``MCCHI2NU`` / ``MCPPCP`` against the JAX writer's on the
same trace database; and the model-file driver on a two-PSF model at
tiny depth, whose database the JAX package reads.

Tolerances: float64 1e-12 of the peak for the window arithmetic and the
render (different summation orders), exact for ``bin_psf`` and the
window origins; header stats as ``tests/test_torch_driver.py`` holds
them (MCCHI2NU rel 1e-4, MCPPCP within 2 / (n + 2)).
"""
import os
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import database as jdb
from psfmc_tpu.analysis.images import save_posterior_images as jax_save_images
from psfmc_tpu.io.preprocess import bin_psf as jax_bin_psf
from psfmc_tpu.model_parser import component_list_from_file as jparse
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu.ops import oversample as JO
from psfmc_tpu.ops.sersic import render_sersic as jax_render_sersic
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch import model_galaxy_mcmc
from psfmc_tpu_torch.analysis.images import save_posterior_images
from psfmc_tpu_torch.flagship import write_general_files
from psfmc_tpu_torch.io import fits as tfits
from psfmc_tpu_torch.io.preprocess import bin_psf
from psfmc_tpu_torch.models import as_model, build_posterior
from psfmc_tpu_torch.ops import oversample as TO
from psfmc_tpu_torch.ops.sersic import sersic_profile_core, sersic_scalar_params
from test_torch_general import jax_posterior, specs, thetas


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


IMAGES = ("raw_model", "convolved_model", "composite_ivm", "residual",
          "point_source_subtracted")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_bin_psf_matches_jax(n):
    rng = np.random.RandomState(n)
    psf, var = rng.uniform(size=(32, 24)), rng.uniform(size=(32, 24))
    for got, want in zip(bin_psf(psf, var, n), jax_bin_psf(psf, var, n)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="does not divide"):
        bin_psf(psf, var, 5)


def _sersic_args(rng, b):
    xy = np.stack([rng.uniform(-6, 40, b), rng.uniform(-6, 30, b)], axis=1)
    xy[0] = (np.nan, 3.0)  # a non-finite center still gives a valid window
    xy[1] = (0.5, 24.5)  # on the .5 points: half to even on both sides
    return (xy, rng.uniform(18, 22, b), rng.uniform(1.0, 6.0, b),
            rng.uniform(0.5, 1.0, b), rng.uniform(0.6, 4.0, b),
            rng.uniform(0, 180, b))


@pytest.mark.parametrize("window,oversample,pad", [(8, 4, 0), (10, 2, 3), (5, 3, 6)])
def test_oversample_window_matches_jax(window, oversample, pad):
    """Batched origin, delta and scatter against the JAX package's
    per-walker ``dynamic_slice`` form, with a Sersic profile."""
    rng = np.random.RandomState(window)
    b, render_shape, zp = 6, (30 + 2 * pad, 40 + 2 * pad), 25.0
    xy, mag, reff, ratio, index, angle = _sersic_args(rng, b)
    reff_b = reff * ratio
    raw = rng.uniform(size=(b,) + render_shape)
    t = [torch.as_tensor(a) for a in (xy, mag, reff, reff_b, index, angle)]
    scal = [s[:, None, None] for s in sersic_scalar_params(*t, zp, True, "exact")]

    def profile(correction):
        return lambda xg, yg: sersic_profile_core(xg - scal[0], yg - scal[1],
                                                  *scal[2:], correction=correction)

    origin = TO.window_origin(t[0], window, render_shape, pad)
    delta = TO.oversampled_window_delta(profile(True), profile(False), origin,
                                        window, oversample, pad, torch.float64)
    got = TO.apply_window_delta(torch.as_tensor(raw), delta, origin).numpy()
    for w in range(1, b):
        args = (jnp.asarray(xy[w]), mag[w], reff[w], reff_b[w], index[w], angle[w],
                zp, True)

        def jfn(correction, a=args):
            return lambda xg, yg: jax_render_sersic(xg, yg, *a, kappa_mode="exact",
                                                    correction=correction)

        jorigin = JO.window_origin(jnp.asarray(xy[w]), window, render_shape, pad)
        assert (origin[0][w].item(), origin[1][w].item()) == tuple(
            int(o) for o in jorigin)
        jdelta = JO.oversampled_window_delta(jfn(True), jfn(False), jorigin, window,
                                             oversample, pad, jnp.float64)
        np.testing.assert_allclose(delta[w].numpy(), np.asarray(jdelta), rtol=0,
                                   atol=1e-12 * np.abs(jdelta).max())
        want = np.asarray(JO.apply_window_delta(jnp.asarray(raw[w]), jdelta, jorigin))
        np.testing.assert_allclose(got[w], want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    oy, ox = origin
    assert 0 <= oy[0] <= render_shape[0] - window and 0 <= ox[0] <= render_shape[1] - window
    assert (ox[1].item(), oy[1].item()) == (max(0 + pad - window // 2, 0),
                                            min(24 + pad - window // 2,
                                                render_shape[0] - window))


@pytest.mark.parametrize("variant", ["conv-pad", "pad-and-oversample",
                                     "render-oversample"])
def test_raw_render_matches_jax(variant):
    """The raw model on the render grid: the render kernel's plain version
    with each Sersic's center shifted by ``+pad`` (the JAX grid is ``xg -
    pad``: the two differ by rounding only), then the windows."""
    jspec, carried, _ = specs(variant)
    th = thetas(carried)[[0, 4, 5, 8, 9]]
    jfns = jax_posterior(jspec, dtype=jnp.float64)
    post = build_posterior(carried, device="cpu", dtype=torch.float64)
    raw, ps = post.raw_and_ps(th)
    assert raw.shape[1:] == tuple(n + 2 * carried.conv_pad for n in carried.shape)
    jraw, jps = jax.vmap(jfns._raw_and_ps)(jnp.asarray(th))
    for got, want in ((raw, jraw), (ps, jps)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


POISSON_MODEL = """\
from numpy import array
from psfMC.ModelComponents import Configuration, PointSource, Sersic, Sky
from psfMC.distributions import Uniform, WeibullMinimum

Configuration(obs_file="sci.fits", obsivm_file="ivm.fits",
              psf_files=["psf0.fits", "psf1.fits"],
              psfivm_files=["psf0_ivm.fits", "psf1_ivm.fits"],
              mag_zeropoint=25.9463, likelihood="poisson", likelihood_gain=2.0)
Sky(adu=Uniform(loc=15.0, scale=10.0))
PointSource(xy=Uniform(loc=array((9.0, 9.0)), scale=array((6.0, 6.0))),
            mag=Uniform(loc=20.5, scale=1.7))
Sersic(xy=Uniform(loc=array((9.0, 9.0)), scale=array((6.0, 6.0))),
       mag=Uniform(loc=20.7, scale=6.8), reff=Uniform(loc=2.0, scale=6.0),
       reff_b=Uniform(loc=2.0, scale=6.0), index=WeibullMinimum(c=1.5, scale=4),
       angle=Uniform(loc=0, scale=180), angle_degrees=True)
"""


def _write_poisson_inputs(directory, shape=(24, 24), psf_shape=(12, 12)):
    rng = np.random.RandomState(6)
    yy, xx = np.mgrid[0:psf_shape[0], 0:psf_shape[1]].astype(float)
    tfits.writeto(os.path.join(directory, "sci.fits"),
                  rng.poisson(20.0, shape).astype(float))
    tfits.writeto(os.path.join(directory, "ivm.fits"), np.ones(shape))
    for i, sigma in enumerate((1.5, 2.0)):
        psf = np.exp(-((xx - 6) ** 2 + (yy - 6) ** 2) / (2 * sigma**2))
        tfits.writeto(os.path.join(directory, f"psf{i}.fits"), psf / psf.sum())
        tfits.writeto(os.path.join(directory, f"psf{i}_ivm.fits"),
                      np.full(psf_shape, 1e8))
    path = os.path.join(directory, "model.py")
    with open(path, "w") as fh:
        fh.write(POISSON_MODEL)
    return path


def test_image_writer_matches_jax_on_a_two_psf_poisson_model(tmp_path):
    """PSFIMG names the MAP row's PSF and MCCHI2NU is the reduced Poisson
    deviance, as the JAX writer gives them from the same database."""
    path = _write_poisson_inputs(str(tmp_path))
    tmodel = as_model(path, device="cpu")
    jmodel = JaxModel(jparse(path))
    assert tmodel.posterior_fns.lnpost == "general"
    assert tmodel.param_names == list(jmodel.param_names)
    rng = np.random.RandomState(3)
    nw, niter = 8, 4
    chain = tmodel.init_params_from_priors(nw * niter, random_state=rng)
    chain = chain.reshape(nw, niter, -1)
    lnp = -1e3 + rng.randn(nw, niter)
    idx = next(s.offset for s in tmodel.spec.slots if s.name == "PSF_Index")
    assert set(np.unique(chain[..., idx])) <= {0.0, 1.0}  # rounded draws
    best = np.unravel_index(np.argmax(lnp), lnp.shape)
    for want_psf in (0.0, 1.0):
        chain[best + (idx,)] = want_psf
        sampler = types.SimpleNamespace(chain=chain, lnprobability=lnp, nwalkers=nw,
                                        state=None)
        db_path = str(tmp_path / "db.fits")
        jdb.save_database(sampler, jmodel, db_path,
                          meta_dict={"MCITER": niter, "MCCHAINS": nw})
        jax_save_images(jmodel, jdb.load_database(db_path),
                        output_name=str(tmp_path / "jax_{}"), ppc_draws=40)
        save_posterior_images(tmodel, tdb.load_database(db_path),
                              output_name=str(tmp_path / "torch_{}"), ppc_draws=40)
        th = tfits.getheader(str(tmp_path / "torch_residual.fits"))
        jh = tfits.getheader(str(tmp_path / "jax_residual.fits"))
        assert th["PSFIMG"] == jh["PSFIMG"] == f"psf{int(want_psf)}.fits"
        comments = {c[0]: c[2] for c in th.cards()}
        assert "Poisson deviance" in comments["MCCHI2NU"]
        assert th["MCCHI2NU"] == pytest.approx(jh["MCCHI2NU"], rel=1e-4)
        assert abs(th["MCPPCP"] - jh["MCPPCP"]) <= 2.0 / 42
        for ftype in IMAGES:
            want = tfits.getdata(str(tmp_path / f"jax_{ftype}.fits"))
            got = tfits.getdata(str(tmp_path / f"torch_{ftype}.fits"))
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(), err_msg=ftype)


def test_driver_runs_a_two_psf_model_file(tmp_path):
    """The general flagship as files (two PSF stars, sky gradient,
    NoiseScale) through ``model_galaxy_mcmc`` at tiny depth: the PSF_Index
    column in the JAX package's layout, PSFIMG of the MAP sample's PSF,
    finite images."""
    path = write_general_files(str(tmp_path), (24, 24), (12, 12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "not yet converged"
        db = model_galaxy_mcmc(path, output_name=str(tmp_path / "out"), chains=40,
                               burn=6, iterations=4, seed=1, device="cpu",
                               checkpoint_interval=3)
    jdb_table = jdb.load_database(str(tmp_path / "out_db.fits"))
    assert list(jdb_table.colnames) == list(db.colnames)
    assert "PSF_Index" in db.colnames and db["PSF_Index"].dtype == np.float64
    np.testing.assert_array_equal(np.asarray(jdb_table["PSF_Index"]), db["PSF_Index"])
    assert {"0_Sky_dx", "0_Sky_dy", "4_NoiseScale_scale"} <= set(db.colnames)
    assert np.all(np.isfinite(db["lnprobability"]))
    best = int(np.argmax(db["lnprobability"]))
    want_psf = f"psf{int(np.rint(db['PSF_Index'][best]))}.fits"
    for ftype in IMAGES:
        img = tfits.getdata(str(tmp_path / f"out_{ftype}.fits"))
        assert img.shape == (24, 24) and np.all(np.isfinite(img))
        assert tfits.getheader(str(tmp_path / f"out_{ftype}.fits"))["PSFIMG"] == want_psf
