"""The port's likelihood families and their pointwise and CDF twins against the JAX package's, on the CPU.

The same seeded numpy inputs (residuals, inverse variances, a mask
whose bad pixels hold NaN data and zero weight, model images with
non-positive pixels) go through ``psfmc_tpu.ops.likelihood`` and
``psfmc_tpu_torch.ops.likelihood``; then the posterior-level twins
(``pointwise_log_likelihood``, ``pointwise_predictive_cdf``,
``pointwise_lnl_and_cdf``) of the general path are held against the
JAX posterior's on the general flagship at 64x64.

Tolerances: float64 rtol 1e-12 for the log-densities and 1e-9 absolute
for the CDFs (against scipy, torch's ``gammaincc`` is 4e-10 off and the
JAX package's ``betainc`` 5e-10 off at these inputs; the port's
Student-t CDF is within 2e-15); float32 1e-5 of the map's largest
magnitude per pixel (a Poisson term cancels ``k ln mu`` against ``ln
Gamma(k + 1)``) and 1e-4 absolute for the CDFs; posterior maps 1e-10
(float64) and 1e-4 (float32) of their peak; the same non-finite entries
everywhere.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu.ops import likelihood as JL
from psfmc_tpu_torch.flagship import prior_draws
from psfmc_tpu_torch.models import build_posterior
from psfmc_tpu_torch.ops import likelihood as TL
from test_torch_general import jax_posterior, specs, thetas


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILIES = [("gaussian", {}), ("student", dict(df=3.0)), ("student", dict(df=30.0)),
            ("poisson", dict(gain=1.0)), ("poisson", dict(gain=2.5))]
IDS = ["gaussian", "student-3", "student-30", "poisson-1", "poisson-2.5"]


def _inputs(seed=0, shape=(3, 24, 20)):
    """resid, ivm, good, model: a few bad pixels (NaN residual, zero
    weight), model pixels at and below zero, counts near 0 and large."""
    rng = np.random.RandomState(seed)
    model = rng.uniform(0.05, 30.0, shape)
    model[0, 0, :4] = [0.0, -1.0, 1e-8, 200.0]
    counts = rng.poisson(np.maximum(model, 0.0)).astype(float)
    counts[0, 1, :3] = [0.0, 0.4, 2.7]  # fractional counts: the continuous extension
    resid = counts - model
    ivm = rng.uniform(0.5, 4.0, shape)
    good = rng.uniform(size=shape) > 0.1
    good[0, :2, :4] = True
    resid[~good] = np.nan
    ivm[~good] = 0.0
    return resid, ivm, good, model


def _both(fn_name, kind, kw, args, dtype):
    jfn = getattr(JL, fn_name)(kind, **kw)
    tfn = getattr(TL, fn_name)(kind, **kw)
    resid, ivm, good, model = args
    if fn_name == "make_lnlike":  # one image at a time in the JAX package
        want = np.stack([np.asarray(jfn(jnp.asarray(r, dtype), jnp.asarray(i, dtype),
                                        jnp.asarray(g), jnp.asarray(m, dtype)))
                         for r, i, g, m in zip(*args)])
    else:
        want = np.asarray(jfn(jnp.asarray(resid, dtype), jnp.asarray(ivm, dtype),
                              jnp.asarray(good), jnp.asarray(model, dtype)))
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    got = tfn(torch.as_tensor(resid, dtype=tdt), torch.as_tensor(ivm, dtype=tdt),
              torch.as_tensor(good), torch.as_tensor(model, dtype=tdt)).numpy()
    return got, want


def _assert_close(got, want, rtol=0.0, atol=0.0):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,kw", FAMILIES, ids=IDS)
def test_pointwise_and_total_match_jax(kind, kw, dtype):
    args = _inputs(1)
    jdt = getattr(jnp, dtype)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    pw, jpw = _both("make_lnlike_pointwise", kind, kw, args, jdt)
    _assert_close(pw, jpw, rtol=rtol,
                  atol=0.0 if dtype == "float64" else rtol * np.abs(jpw[np.isfinite(jpw)]).max())
    assert np.all(pw[~args[2]] == 0.0)  # bad pixels carry exactly 0
    tot, jtot = _both("make_lnlike", kind, kw, args, jdt)
    _assert_close(tot, jtot, rtol=rtol * 10)
    # the single-twin rule: each total is the sum of its map
    summed = torch.as_tensor(pw).sum(dim=(-2, -1)).numpy()
    fin = np.isfinite(tot)
    np.testing.assert_array_equal(tot[fin], summed[fin])


def test_nan_guards_are_the_jax_packages():
    """Gaussian and Student-t map any non-finite total to -inf; Poisson
    maps NaN to -inf and keeps a -inf from a non-positive expectation."""
    resid, ivm, good, model = _inputs(2)
    args = [torch.as_tensor(a) for a in (resid, ivm, good, model)]
    inf_ivm = args[1].clone()
    inf_ivm[0, 5, 5] = np.inf  # an infinite weight at a good pixel
    args[2][0, 5, 5] = True
    for kind, kw in FAMILIES[:2]:
        out = TL.make_lnlike(kind, **kw)(args[0], inf_ivm, args[2], args[3])
        assert out[0] == -np.inf
    pois = TL.make_lnlike("poisson")(*args)
    assert pois[0] == -np.inf  # model 0 and -1 at good pixels of image 0
    nan_model = args[3].clone()
    nan_model[1, 3, 3] = np.nan
    args[2][1, 3, 3] = True
    assert TL.make_lnlike("poisson")(args[0], args[1], args[2], nan_model)[1] == -np.inf
    jpois = np.asarray(JL.poisson_lnlike(jnp.asarray(resid[0]), jnp.asarray(ivm[0]),
                                         jnp.asarray(good[0]), jnp.asarray(model[0]),
                                         1.0))
    assert jpois == -np.inf


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,kw", FAMILIES, ids=IDS)
def test_cdf_twins_match_jax(kind, kw, dtype):
    args = _inputs(3)
    got, want = _both("make_cdf_pointwise", kind, kw, args, getattr(jnp, dtype))
    atol = 1e-9 if dtype == "float64" else 1e-4
    _assert_close(got, want, atol=atol)
    assert np.all(got[~args[2]] == 0.5)
    assert np.all((got >= 0.0) & (got <= 1.0))


def test_betainc_matches_scipy():
    from scipy.special import betainc as sp_betainc

    rng = np.random.RandomState(4)
    x = np.concatenate([rng.uniform(size=500), [0.0, 1.0, 1e-300, 1 - 1e-16]])
    for a, b in ((0.25, 0.5), (1.5, 0.5), (15.0, 0.5), (2.0, 3.0), (0.5, 40.0)):
        got = TL.betainc(a, b, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, sp_betainc(a, b, x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,kw", [("student", dict(df=0.0)),
                                     ("student", dict(df=np.inf)),
                                     ("poisson", dict(gain=0.0)),
                                     ("poisson", dict(gain=np.nan)),
                                     ("cauchy", {})])
def test_factories_refuse_what_jax_refuses(kind, kw):
    for maker in ("make_lnlike", "make_lnlike_pointwise", "make_cdf_pointwise"):
        with pytest.raises(ValueError) as jerr:
            getattr(JL, maker)(kind, **kw)
        with pytest.raises(ValueError) as terr:
            getattr(TL, maker)(kind, **kw)
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]


@pytest.mark.parametrize("variant", ["two-psfs", "student", "poisson"])
def test_posterior_pointwise_twins_match_jax(variant):
    """The general posterior's per-pixel maps against the JAX posterior's,
    per walker: 1e-10 (float64) and 1e-4 (float32) of the map's peak,
    1e-9 and 1e-4 absolute for the CDFs; each map sums to the lnL."""
    jspec, carried, _ = specs(variant)
    th = thetas(carried)[[0, 4, 8, 9]]
    for dtype, tdt, tol in ((jnp.float64, torch.float64, 1e-10),
                            (jnp.float32, torch.float32, 1e-4)):
        jfns = jax_posterior(jspec, dtype=dtype)
        post = build_posterior(carried, device="cpu", dtype=tdt)
        jth = jnp.asarray(th, dtype)
        want_pw, want_cdf = (np.asarray(a) for a in
                             jax.vmap(jfns.pointwise_lnl_and_cdf)(jth))
        pw, cdf = (t.numpy() for t in post.pointwise_lnl_and_cdf(th))
        np.testing.assert_array_equal(pw, post.pointwise_log_likelihood(th).numpy())
        np.testing.assert_array_equal(cdf, post.pointwise_predictive_cdf(th).numpy())
        _assert_close(pw, want_pw, atol=tol * np.abs(want_pw).max())
        _assert_close(cdf, want_cdf, atol=1e-9 if tdt == torch.float64 else 1e-4)
        lnl = post.log_likelihood_batch(th)
        torch.testing.assert_close(torch.as_tensor(pw).sum(dim=(-2, -1)), lnl,
                                   rtol=0, atol=0)


def test_pointwise_twins_run_on_every_path():
    """The kernel paths' image products feed the same twins (Gaussian)."""
    _, carried, _ = specs("flat-sky")
    th = prior_draws(carried, 3, seed=2)
    maps = [build_posterior(carried, device="cpu", dtype=torch.float64,
                            lnpost=mode).pointwise_log_likelihood(th)
            for mode in ("batched", "fused", "general")]
    for m in maps[1:]:
        torch.testing.assert_close(m, maps[0], rtol=1e-10, atol=1e-9)
