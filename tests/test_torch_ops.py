"""The port's scalar and image ops against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both
packages; every tolerance is stated where it is asserted.  float64
comparisons (``jax_enable_x64`` is on in this suite) check the algebra,
float32 ones the working precision.
"""
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as sps
import torch

import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.ops import coords as jcoords
from psfmc_tpu.ops import fourier as jfourier
from psfmc_tpu.ops import gammainc as jgammainc
from psfmc_tpu.ops import likelihood as jlike
from psfmc_tpu.ops import pointsource as jps
from psfmc_tpu.ops import sersic as jsersic
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.ops import coords as tcoords
from psfmc_tpu_torch.ops import fourier as tfourier
from psfmc_tpu_torch.ops import gammainc as tgammainc
from psfmc_tpu_torch.ops import likelihood as tlike
from psfmc_tpu_torch.ops import pointsource as tps
from psfmc_tpu_torch.ops import sersic as tsersic


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DTYPES = {"f64": (np.float64, torch.float64, jnp.float64),
          "f32": (np.float32, torch.float32, jnp.float32)}


def test_mag_to_flux():
    mags = np.linspace(15.0, 28.0, 41)
    want = np.asarray(jcoords.mag_to_flux(jnp.asarray(mags), 25.9463))
    # host path is numpy's power, exactly the JAX package's host path
    np.testing.assert_array_equal(tcoords.mag_to_flux(mags, 25.9463),
                                  jcoords.mag_to_flux(mags, 25.9463))
    # tensor path: exp(ln10 * arg) in float64, rtol 1e-13
    got = tcoords.mag_to_flux(torch.as_tensor(mags), 25.9463).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_coord_grids():
    xg, yg = tcoords.coord_grids((5, 7), torch.float64)
    jx, jy = jcoords.coord_grids((5, 7), jnp.float64)
    np.testing.assert_array_equal(xg.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(yg.numpy(), np.asarray(jy))


def test_gammaincinv_half_table_matches_jax_and_scipy():
    a = np.geomspace(0.02, 190.0, 301)
    got = tgammainc.gammaincinv_half_table(torch.as_tensor(a)).numpy()
    want = np.asarray(jgammainc.gammaincinv_half_table(jnp.asarray(a)))
    # same table, same spline, float64: rtol 1e-6 (observed ~1e-15)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # and the table itself is within its documented 1e-6 of scipy
    np.testing.assert_allclose(got, sp.gammaincinv(a, 0.5), rtol=1e-6)


def test_gammaincinv_half_newton_matches_jax_and_scipy():
    a = np.geomspace(0.2, 60.0, 97)
    got = tgammainc.gammaincinv_half(torch.as_tensor(a)).numpy()
    want = np.asarray(jgammainc.gammaincinv_half(jnp.asarray(a)))
    # float64, rtol 1e-6 against both the JAX Newton and scipy
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, sp.gammaincinv(a, 0.5), rtol=1e-6)
    assert np.isnan(tgammainc.gammaincinv_half(torch.tensor([-1.0])).item())


_NEWTON_ITERS_SCRIPT = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
from psfmc_tpu.ops import gammainc as jgammainc
from psfmc_tpu_torch.ops import gammainc as tgammainc
a = np.concatenate([[0.5], np.geomspace(0.2, 60.0, 31)])
got = tgammainc.gammaincinv_half(torch.as_tensor(a)).numpy()
want = np.asarray(jgammainc.gammaincinv_half(jnp.asarray(a)))
np.testing.assert_allclose(got, want, rtol=1e-6)
print("kappa", got[0], want[0])
"""


@pytest.mark.parametrize("iters", ["1", "2"])
def test_newton_iters_follow_the_environment(iters):
    """``PSFMC_NEWTON_ITERS`` sets the Newton iterations of both packages
    (each reads it at import, hence a fresh interpreter): with 1 or 2
    iterations the port's kappa is the JAX package's, rtol 1e-6 in
    float64."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PSFMC_NEWTON_ITERS=iters, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    done = subprocess.run([sys.executable, "-c", _NEWTON_ITERS_SCRIPT],
                          env=env, cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def _sersic_args(rng, n):
    return dict(
        xy=np.stack([20 + 20 * rng.rand(n), 20 + 20 * rng.rand(n)], axis=1),
        mag=20.0 + rng.rand(n),
        reff=3.0 + 3 * rng.rand(n),
        reff_b=2.0 + 1 * rng.rand(n),
        index=0.7 + 3 * rng.rand(n),
        angle=180.0 * rng.rand(n),
    )


@pytest.mark.parametrize("kappa_mode", ["table", "exact"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_render_sersic(dt, kappa_mode):
    np_dt, t_dt, j_dt = DTYPES[dt]
    rng = np.random.RandomState(7)
    shape = (64, 64)
    args = _sersic_args(rng, 3)
    got = tsersic.render_sersic(
        shape, *(torch.as_tensor(args[k].astype(np_dt)) for k in args),
        25.0, angle_degrees=True, kappa_mode=kappa_mode,
    ).numpy()
    xg, yg = jcoords.coord_grids(shape, j_dt)
    for i in range(3):
        want = np.asarray(jsersic.render_sersic(
            xg, yg, *(jnp.asarray(args[k][i].astype(np_dt)) for k in args),
            25.0, angle_degrees=True, kappa_mode=kappa_mode,
        ))
        # per-pixel relative error (floor 1e-30 where the profile
        # underflows): 1e-9 in f64; 5e-5 in f32, where exp(-kappa (p-1))
        # turns 1 ulp of its argument (up to ~60) into ~4e-6 relative
        rel = np.abs(got[i] - want) / np.maximum(np.abs(want), 1e-30)
        assert rel.max() < (1e-9 if dt == "f64" else 5e-5), rel.max()


@pytest.mark.parametrize("method", ["lanczos3", "bilinear"])
def test_render_pointsource_dense(method):
    rng = np.random.RandomState(3)
    xy = rng.uniform(2, 30, size=(4, 2))
    xy[0] = [10.0, 17.0]  # integer position: sinc(0) branch
    mag = rng.uniform(18, 22, size=4)
    got = tps.render_pointsource_dense(
        (32, 40), torch.as_tensor(xy), torch.as_tensor(mag), 25.0, method
    ).numpy()
    for i in range(4):
        want = np.asarray(jps.render_pointsource_dense(
            (32, 40), jnp.asarray(xy[i]), mag[i], 25.0, method, jnp.float64
        ))
        # float64, rtol 1e-12 with an absolute floor of 1e-12 x peak
        np.testing.assert_allclose(got[i], want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    with pytest.raises(ValueError):
        tps.render_pointsource_dense((4, 4), torch.zeros(2), torch.zeros(()),
                                     25.0, "cubic")


@pytest.mark.parametrize("shape,psf_shape", [((128, 128), (64, 64)),
                                             ((45, 37), (15, 11)),
                                             ((512, 512), (64, 64))])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_convolve_and_convolve_rdft(shape, psf_shape, dt, monkeypatch):
    np_dt, t_dt, j_dt = DTYPES[dt]
    monkeypatch.setenv("PSFMC_CONV_PRECISION", "highest")
    rng = np.random.RandomState(11)
    img = rng.rand(2, *shape)
    psf = rng.rand(*psf_shape)
    fk = tfourier.pad_and_rfft_image(psf, shape)
    np.testing.assert_array_equal(fk, jfourier.pad_and_rfft_image(psf, shape))
    mats_np = tfourier.rdft_matrices(shape, np_dt)
    for m, jm in zip(mats_np, jfourier.rdft_matrices(shape, np_dt)):
        np.testing.assert_array_equal(m, jm)

    want = np.asarray(jfourier.convolve(jnp.asarray(img), jnp.asarray(fk)))
    cdt = torch.complex128 if dt == "f64" else torch.complex64
    got_fft = tfourier.convolve(torch.as_tensor(img.astype(np_dt)),
                                torch.as_tensor(fk).to(cdt)).numpy()
    mats = tuple(torch.as_tensor(m) for m in mats_np)
    got_rdft = tfourier.convolve_rdft(
        torch.as_tensor(img.astype(np_dt)),
        torch.as_tensor(fk.real.astype(np_dt)),
        torch.as_tensor(fk.imag.astype(np_dt)), mats,
    ).numpy()
    want_rdft = np.asarray(jfourier.convolve_rdft(
        jnp.asarray(img.astype(np_dt)), jnp.asarray(fk.real.astype(np_dt)),
        jnp.asarray(fk.imag.astype(np_dt)),
        tuple(jnp.asarray(m) for m in mats_np),
    ))
    # rtol 1e-9 in f64, 1e-5 in f32, relative to the image's peak
    tol = 1e-9 if dt == "f64" else 1e-5
    peak = np.abs(want).max()
    for got in (got_fft, got_rdft):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * peak)
    np.testing.assert_allclose(got_rdft, want_rdft, rtol=tol, atol=tol * peak)


def test_convolve_odd_size_delta_round_trip():
    """A centered delta kernel returns the image at an odd size (the
    reference's broken case)."""
    shape = (33, 27)
    img = np.random.RandomState(0).rand(*shape)
    delta = np.zeros((9, 7))
    delta[4, 3] = 1.0
    fk = torch.as_tensor(tfourier.pad_and_rfft_image(delta, shape))
    out = tfourier.convolve(torch.as_tensor(img), fk).numpy()
    np.testing.assert_allclose(out, img, atol=1e-12)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_gaussian_lnlike(dt):
    np_dt, t_dt, j_dt = DTYPES[dt]
    rng = np.random.RandomState(5)
    resid = rng.randn(3, 16, 16).astype(np_dt)
    ivm = rng.uniform(10, 1e4, size=(3, 16, 16)).astype(np_dt)
    good = rng.rand(16, 16) > 0.2
    ivm[:, ~good] = 0.0  # bad pixels: infinite variance
    resid[0, ~good] = np.nan  # never leaks out of a bad pixel
    got = tlike.gaussian_lnlike(torch.as_tensor(resid), torch.as_tensor(ivm),
                                torch.as_tensor(good)).numpy()
    for i in range(3):
        want = float(jlike.gaussian_lnlike(jnp.asarray(resid[i]),
                                           jnp.asarray(ivm[i]),
                                           jnp.asarray(good)))
        # rtol 1e-12 in f64, 1e-6 in f32 (summation order differs)
        np.testing.assert_allclose(got[i], want,
                                   rtol=1e-12 if dt == "f64" else 1e-6)
    resid[1, good] = np.nan
    bad = tlike.gaussian_lnlike(torch.as_tensor(resid), torch.as_tensor(ivm),
                                torch.as_tensor(good)).numpy()
    assert bad[1] == -np.inf and np.isfinite(bad[0])


@pytest.mark.parametrize("family,kwargs,xs", [
    ("Normal", dict(loc=0.3, scale=0.01), np.linspace(0.2, 0.4, 21)),
    ("Uniform", dict(loc=2.0, scale=10.0), np.array([1.9, 2.0, 5.0, 12.0, 12.1])),
    ("WeibullMinimum", dict(c=1.5, scale=4), np.array([-1.0, 0.0, 0.1, 2.0, 9.0])),
    ("Uniform", dict(loc=np.array([56.5, 56.5]), scale=np.array([16.0, 16.0])),
     np.array([[60.0, 70.0], [56.0, 60.0], [72.5, 72.5]])),
])
def test_prior_log_densities(family, kwargs, xs):
    tdist = getattr(TD, family)(**kwargs)
    jdist = getattr(JD, family)(**kwargs)
    got = tdist.torch_logp(torch.as_tensor(xs)).numpy()
    want = np.asarray(jdist.jax_logp(jnp.asarray(xs)))
    # float64: same -inf pattern, finite values to rtol 1e-12, and
    # scipy's logpdf agrees
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
    np.testing.assert_allclose(got[fin], tdist.logp(xs)[fin], rtol=1e-12)
    assert tdist.median() == pytest.approx(jdist.median())


def test_unported_prior_family_raises():
    """Every family of the JAX package is ported now (the priors slice):
    the two this test once refused agree with JAX, and only a name outside
    the map raises."""
    for tdist, jdist in ((TD.Gamma(a=2.0), JD.Gamma(a=2.0)),
                         (TD.from_name("LogNormal", s=1.0), JD.LogNormal(s=1.0))):
        xs = np.array([-1.0, 0.0, 0.5, 2.0])
        got = tdist.torch_logp(torch.as_tensor(xs)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jdist.jax_logp(jnp.asarray(xs))))
    with pytest.raises(ValueError, match="unknown prior family"):
        TD.from_name("NoSuchFamily", s=1.0)
    assert sps.norm  # the scipy names stay the JAX package's
    assert TD.SCIPY_DIST_NAMES == JD.SCIPY_DIST_NAMES


def test_preprocess_matches_jax(tmp_path):
    from psfmc_tpu.io import preprocess as jpre
    from psfmc_tpu_torch.io import preprocess as tpre

    rng = np.random.RandomState(13)
    obs = rng.rand(16, 12)
    ivm = rng.uniform(1, 10, size=obs.shape)
    obs[2, 3] = np.nan
    ivm[5, 5] = 0.0
    mask = np.zeros(obs.shape, bool)
    mask[0, :4] = True
    _, j_data, j_var, j_bad = jpre.preprocess_obs(obs, ivm, mask)
    _, t_data, t_var, t_bad = tpre.preprocess_obs(obs, ivm, mask)
    np.testing.assert_array_equal(t_bad, j_bad)
    np.testing.assert_array_equal(t_var, j_var)  # inf at bad pixels
    np.testing.assert_array_equal(t_data[~t_bad], j_data[~j_bad])

    psfs = [rng.rand(6, 6) for _ in range(2)]
    ivms = [rng.uniform(1e3, 1e4, size=(6, 6)) for _ in range(2)]
    ivms[0][1, 1] = -1.0  # a bad PSF pixel is zeroed
    t_pairs = [tpre.preprocess_psf(p, i) for p, i in zip(psfs, ivms)]
    j_pairs = [jpre.preprocess_psf(p, i) for p, i in zip(psfs, ivms)]
    for (td, tv), (jd, jv) in zip(t_pairs, j_pairs):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tv, jv)
    t_d, t_v = tpre.calculate_psf_variability(*zip(*t_pairs))
    j_d, j_v = jpre.calculate_psf_variability(*zip(*j_pairs))
    for a, b in zip(t_v, j_v):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpre.pre_fft_psf(t_d[0], t_v[0], (16, 12)),
                    jpre.pre_fft_psf(j_d[0], j_v[0], (16, 12))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(OSError):  # a string is a FITS file name
        tpre.preprocess_obs(str(tmp_path / "missing.fits"), ivm)
    with pytest.raises(ValueError, match="mask array shape"):
        tpre.preprocess_obs(obs, ivm, mask[:4])
