"""The port's MAP optimiser against the JAX package's, on the CPU.

On ``tests/test_optimize.py``'s 32x32 fixture (a Sersic + Sky rendered by
the JAX package at high S/N, the same observation handed to both
packages), in float64 with the same pool and seed: ``fit_map`` at 8
starts x 30 steps (every start's optimum and best lnpost within rtol
1e-6), ``scatter_around`` at 1e-10, ``laplace_covariance`` within rtol
1e-4 of JAX's ``jax.hessian`` result (the port differentiates its exact
gradient by central differences) and both of its warnings; the multi-PSF
argmax assignment of ``tests/test_multipsf.py``'s fixture; recovery of
the truth at the JAX tests' bars (``tests/test_optimize.py``,
``tests/test_joint.py``); ``model_galaxy_map``'s products and header
cards against JAX's; and ``model_galaxy_mcmc(init="map")`` end to end.
Each test runs torch on one thread (small tensors; the suite's workers
share the cores).
"""
import functools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu.optimize import fit_map as jax_fit_map
from psfmc_tpu.optimize import laplace_covariance as jax_laplace
from psfmc_tpu.optimize import scatter_around as jax_scatter
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch import optimize
from psfmc_tpu_torch.models import MultiComponentModel
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.optimize import fit_map, laplace_covariance, scatter_around

TRUE = dict(x=16.3, y=15.7, mag=20.0, reff=3.0, reff_b=2.2, index=1.5,
            angle=40.0, sky=0.05)
H = W = 32
NOISE = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _psf():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    psf = np.exp(-((xx - W / 2) ** 2 + (yy - H / 2) ** 2) / (2 * 1.2**2))
    return psf / psf.sum()


def _config(C, obs):
    psf = _psf()
    return C.Configuration(obs_file=obs, obsivm_file=np.full((H, W), 1.0 / NOISE**2),
                           psf_files=psf, psfivm_files=np.ones_like(psf) * 1e8,
                           mag_zeropoint=25.0)


@functools.lru_cache(maxsize=None)
def _observation(seed):
    """The JAX package renders the truth at high S/N (its own test's way)."""
    clean = JaxModel([_config(JC, np.zeros((H, W))), JC.Sky(adu=TRUE["sky"]),
                      JC.Sersic(xy=np.array([TRUE["x"], TRUE["y"]]), mag=TRUE["mag"],
                                reff=TRUE["reff"], reff_b=TRUE["reff_b"],
                                index=TRUE["index"], angle=TRUE["angle"],
                                angle_degrees=True)])
    fns = clean.posterior_fns
    img = np.asarray(jax.jit(fns._render_images)(jnp.zeros(clean.num_params,
                                                          fns.dtype))["convolved_model"])
    return img + np.random.RandomState(seed).randn(H, W) * NOISE


def _components(C, D, seed=42):
    return [
        _config(C, _observation(seed)),
        C.Sky(adu=D.Normal(loc=0.0, scale=0.2)),
        C.Sersic(xy=D.Uniform(loc=np.array([10.0, 10.0]), scale=np.array([12.0, 12.0])),
                 mag=D.Uniform(loc=18.0, scale=4.0), reff=D.Uniform(loc=0.5, scale=7.5),
                 reff_b=D.Uniform(loc=0.5, scale=7.5), index=D.Uniform(loc=0.6, scale=3.0),
                 angle=D.Uniform(loc=0.0, scale=180.0), angle_degrees=True),
    ]


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(_components(JC, JD), dtype=jnp.float64)
    tm = MultiComponentModel(_components(TC, TD), device="cpu", dtype=torch.float64)
    return jm, tm


def _truth(model):
    by_name = {"Sky_adu": [TRUE["sky"]], "Sersic_angle": [TRUE["angle"]],
               "Sersic_index": [TRUE["index"]], "Sersic_mag": [TRUE["mag"]],
               "Sersic_reff": [TRUE["reff"]], "Sersic_reff_b": [TRUE["reff_b"]],
               "Sersic_xy": [TRUE["x"], TRUE["y"]]}
    return np.concatenate([by_name[n.split("_", 1)[1]] for n in model.param_names])


def test_fit_map_matches_jax(models):
    jm, tm = models
    pool = tm.init_params_from_priors(128, random_state=np.random.RandomState(5))
    np.testing.assert_array_equal(
        pool, jm.init_params_from_priors(128, random_state=np.random.RandomState(5)))
    want = jax_fit_map(jm.posterior_fns, n_starts=8, steps=30, p0=pool, seed=1)
    got = fit_map(tm.posterior_fns, n_starts=8, steps=30, p0=pool, seed=1)
    np.testing.assert_allclose(got.all_theta, want.all_theta, rtol=1e-6)
    np.testing.assert_allclose(got.all_lnpost, want.all_lnpost, rtol=1e-6)
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-6)
    assert got.lnpost == pytest.approx(want.lnpost, rel=1e-6)
    assert got.psf_index == want.psf_index == 0 and got.steps == 30
    assert got.cov is None and got.theta_std is None


def test_scatter_around_matches_jax(models):
    jm, tm = models
    center = _truth(tm)
    want = jax_scatter(jm.posterior_fns, center, 32, seed=3)
    got = scatter_around(tm.posterior_fns, center, 32, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert np.all(np.isfinite(tm.posterior_fns.log_posterior_batch(got).numpy()))


def test_laplace_covariance_matches_jax(models):
    """At the truth (the high-S/N posterior's mode is within its errors
    of it): std and covariance within rtol 1e-4 of JAX's Hessian."""
    jm, tm = models
    theta = _truth(tm)
    jcov, jstd = jax_laplace(jm.posterior_fns, theta)
    cov, std = laplace_covariance(tm.posterior_fns, theta)
    assert np.all(np.isfinite(std))
    np.testing.assert_allclose(std, jstd, rtol=1e-4)
    scale = np.sqrt(np.outer(jstd, jstd))
    assert np.all(np.abs(cov - jcov) <= 1e-4 * scale)


def test_laplace_warnings_as_jax(models, monkeypatch):
    """A non-positive-definite curvature (a point far from the mode) and
    the Newton kappa give NaN with the JAX package's warnings."""
    jm, tm = models
    far = tm.init_params_from_priors(1, random_state=np.random.RandomState(11))[0]
    for fn, fns in ((jax_laplace, jm.posterior_fns), (laplace_covariance, tm.posterior_fns)):
        with pytest.warns(UserWarning, match="not positive definite"):
            cov, std = fn(fns, far)
        assert np.all(np.isnan(std)) and np.all(np.isnan(cov))
    monkeypatch.setenv("PSFMC_KAPPA", "newton")
    newton = MultiComponentModel(_components(TC, TD), device="cpu", dtype=torch.float64)
    with pytest.warns(UserWarning, match="not twice-differentiable"):
        cov, std = laplace_covariance(newton.posterior_fns, _truth(newton))
    assert np.all(np.isnan(std))


def _two_psf_components(C, D):
    """``tests/test_multipsf.py``'s fixture: a delta made with the narrow
    of two PSFs."""
    rng = np.random.RandomState(1234)
    yy, xx = np.mgrid[0:16, 0:16].astype(float)
    narrow = np.exp(-((xx - 8) ** 2 + (yy - 8) ** 2) / (2 * 1.0**2))
    wide = np.exp(-((xx - 8) ** 2 + (yy - 8) ** 2) / (2 * 3.0**2))
    narrow, wide = narrow / narrow.sum(), wide / wide.sum()
    truth = np.full((32, 32), 0.01)
    truth[15, 17] += 50.0
    pad = np.zeros((32, 32))
    pad[8:24, 8:24] = narrow
    obs = np.fft.ifftshift(np.fft.irfft2(np.fft.rfft2(truth) * np.fft.rfft2(pad),
                                         s=(32, 32))) + rng.randn(32, 32) * 0.02
    return [C.Configuration(obs_file=obs, obsivm_file=np.full((32, 32), 1 / 0.02**2),
                            psf_files=[narrow, wide],
                            psfivm_files=[np.ones_like(narrow) * 1e8] * 2,
                            mag_zeropoint=25.0),
            C.Sky(adu=D.Normal(loc=0.01, scale=0.05)),
            C.PointSource(xy=D.Uniform(loc=np.array([14.0, 12.0]),
                                       scale=np.array([6.0, 6.0])),
                          mag=D.Uniform(loc=20.0, scale=2.0))]


def test_multi_psf_assignment_matches_jax():
    """The ascent marginalizes the PSF index; every start's optimum gets
    its own argmax index, as in the JAX package, and the best start the
    narrow PSF the data were made with."""
    jm = JaxModel(_two_psf_components(JC, JD), dtype=jnp.float64)
    tm = MultiComponentModel(_two_psf_components(TC, TD), device="cpu",
                             dtype=torch.float64)
    rng = np.random.RandomState(2)
    pool = np.column_stack([rng.normal(0.01, 0.02, 64), rng.uniform(20.0, 22.0, 64),
                            rng.uniform(14.0, 20.0, 64), rng.uniform(12.0, 18.0, 64),
                            rng.randint(0, 2, 64).astype(float)])
    want = jax_fit_map(jm.posterior_fns, n_starts=8, steps=40, p0=pool, seed=2)
    got = fit_map(tm.posterior_fns, n_starts=8, steps=40, p0=pool, seed=2)
    np.testing.assert_array_equal(got.all_theta[:, -1], want.all_theta[:, -1])
    np.testing.assert_allclose(got.all_theta, want.all_theta, rtol=1e-6)
    assert got.psf_index == want.psf_index == 0
    assert got.theta[-1] == 0.0


def test_fit_map_recovers_truth():
    """``tests/test_optimize.py``'s bars (position 0.2 px, magnitude 0.1,
    index 0.4, sky 0.02) and the MAP beating every pool draw, through the
    port in float32 from the best 8 of 256 prior draws."""
    tm = MultiComponentModel(_components(TC, TD), device="cpu")
    pool = tm.init_params_from_priors(256, random_state=np.random.RandomState(42))
    res = fit_map(tm.posterior_fns, n_starts=8, steps=300, p0=pool, seed=1)
    vals = dict(zip([n.split("_", 1)[1] for n in tm.param_names],
                    np.split(res.theta, np.cumsum(tm.param_lens)[:-1])))
    assert np.isfinite(res.lnpost)
    assert abs(vals["Sersic_xy"][0] - TRUE["x"]) < 0.2
    assert abs(vals["Sersic_xy"][1] - TRUE["y"]) < 0.2
    assert abs(vals["Sersic_mag"][0] - TRUE["mag"]) < 0.1
    assert abs(vals["Sersic_index"][0] - TRUE["index"]) < 0.4
    assert abs(vals["Sky_adu"][0] - TRUE["sky"]) < 0.02
    lnp_pool = tm.posterior_fns.log_posterior_batch(pool).numpy()
    assert res.lnpost > np.nanmax(np.where(np.isfinite(lnp_pool), lnp_pool, -np.inf))


def test_joint_map_recovers_the_injected_source():
    """``tests/test_joint.py``'s joint MAP: a point source tied between a
    24x24 and a 16x16 band, its magnitudes within 0.1 and 0.15 and its
    position within 0.3 px of the injection."""
    from psfmc_tpu_torch.models import JointModel

    def config(rng, h=24, w=24, noise=0.05):
        yy, xx = np.mgrid[0:h, 0:w].astype(float)
        psf = np.exp(-((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / (2 * 1.3**2))
        return TC.Configuration(obs_file=0.05 + rng.randn(h, w) * noise,
                                obsivm_file=np.full((h, w), 1 / noise**2),
                                psf_files=psf / psf.sum(),
                                psfivm_files=np.full((h, w), 1e8), mag_zeropoint=25.0)

    rng = np.random.RandomState(25)
    ps_a = TC.PointSource(xy=TD.Uniform(loc=np.array([9.0, 9.0]), scale=np.array([6.0, 6.0])),
                          mag=TD.Uniform(loc=20.5, scale=1.5))
    ps_b = TC.PointSource(xy=TC.Tied(ps_a, "xy"), mag=TD.Uniform(loc=21.0, scale=1.5))
    bands = [[config(rng), TC.Sky(adu=TD.Normal(loc=0.05, scale=0.05)), ps_a],
             [config(rng, h=16, w=16, noise=0.08),
              TC.Sky(adu=TD.Normal(loc=0.05, scale=0.05)), ps_b]]
    truth_model = JointModel(bands, device="cpu", dtype=torch.float64)
    off = dict(zip(truth_model.param_names,
                   np.cumsum([0] + truth_model.param_lens)))
    truth = truth_model.init_params_from_priors(1, random_state=np.random.RandomState(26))[0]
    truth[off["1_PointSource_xy"]:off["1_PointSource_xy"] + 2] = [11.2, 9.7]
    truth[off["1_PointSource_mag"]] = 21.2
    truth[off["4_PointSource_mag"]] = 21.9
    mocks, _ = truth_model.simulate(theta=truth, random_state=27)
    for band, mock in zip(bands, mocks):
        band[0] = TC.Configuration(obs_file=mock, obsivm_file=1.0 / band[0].obs_var,
                                   psf_files=band[0].psf_selector.spatial_psfs[0],
                                   psfivm_files=np.full(mock.shape, 1e8),
                                   mag_zeropoint=25.0)
    joint = JointModel(bands, device="cpu")
    res = fit_map(joint.posterior_fns, n_starts=8, steps=300, seed=28)
    got = res.theta
    assert np.isfinite(res.lnpost)
    assert abs(got[off["1_PointSource_mag"]] - 21.2) < 0.1
    assert abs(got[off["4_PointSource_mag"]] - 21.9) < 0.15
    assert np.all(np.abs(got[off["1_PointSource_xy"]:off["1_PointSource_xy"] + 2]
                         - [11.2, 9.7]) < 0.3)


def test_model_galaxy_map_matches_jax(models, tmp_path):
    """The five products and the header cards (``MAPLNP``, each
    abbreviation's value +/- its Laplace error) of the port's
    ``model_galaxy_map`` against the JAX package's, both in float64 from
    the same prepared model's pool: MAPLNP at rtol 1e-6, the values and
    errors as the cards print them (4 significant digits), the images at
    rtol 1e-6."""
    from psfmc_tpu import model_galaxy_map as jax_map
    from psfmc_tpu.io import fits as jfits
    from psfmc_tpu_torch import model_galaxy_map
    from psfmc_tpu_torch.io import fits

    jm, tm = models
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_map(jm, output_name="jax", n_starts=4, steps=200, seed=0)
        got = model_galaxy_map(tm, output_name="port", n_starts=4, steps=200, seed=0)
        assert set(got.phase_seconds) == {"pool", "fit", "laplace", "images"}
        for ftype in ("raw_model", "convolved_model", "composite_ivm", "residual",
                      "point_source_subtracted"):
            assert os.path.exists(f"port_{ftype}.fits"), ftype
            np.testing.assert_allclose(fits.getdata(f"port_{ftype}.fits"),
                                       jfits.getdata(f"jax_{ftype}.fits"), rtol=1e-6,
                                       atol=1e-6)
        hdr, jhdr = fits.getheader("port_residual.fits"), jfits.getheader("jax_residual.fits")
        assert hdr["MAPLNP"] == pytest.approx(jhdr["MAPLNP"], rel=1e-6)
        assert hdr["MAPLNP"] == pytest.approx(got.lnpost, rel=1e-6)
        assert got.lnpost == pytest.approx(want.lnpost, rel=1e-6)
        for abbr in tm.param_fits_abbrs:
            assert "+/-" in str(hdr[abbr])
            assert str(hdr[abbr]) == str(jhdr[abbr]), abbr
    finally:
        os.chdir(cwd)


def test_model_galaxy_mcmc_init_map_runs(tmp_path, monkeypatch):
    """``init="map"``: a MAP fit of a pool of prior draws (cut here to 8
    starts x 20 steps), then a z-space cloud around it: every walker in
    support at the start and a finite chain."""
    from psfmc_tpu_torch import load_database, model_galaxy_mcmc

    monkeypatch.setattr(optimize, "fit_map",
                        functools.partial(optimize.fit_map, n_starts=8, steps=20))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        model_galaxy_mcmc(_components(TC, TD, seed=7), output_name="mapinit",
                          iterations=10, burn=10, chains=16, init="map",
                          convergence_check=lambda s, verbose=0: True, device="cpu")
        db = load_database("mapinit_db.fits")
        assert len(db) == 10 * 16
        assert np.all(np.isfinite(np.asarray(db["lnprobability"], np.float64)))
        with pytest.raises(ValueError):
            model_galaxy_mcmc(_components(TC, TD, seed=7), output_name="bad",
                              iterations=2, burn=2, chains=8, init="bogus",
                              device="cpu")
    finally:
        os.chdir(cwd)
