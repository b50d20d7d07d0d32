"""The port's general likelihood path against the JAX package's XLA path, on the CPU.

The general flagship (Sky with a ``dx``/``dy`` gradient + PointSource +
2 Sersic + NoiseScale, with 1-3 PSF stars and a sampled ``PSF_Index``)
is built by each package from the same seeded numpy arrays at 64x64
with 32x32 PSFs, in one variant per feature: ``conv_pad``,
``render_oversample``, ``psf_oversample``, Student-t and Poisson.
``spec_from_numpy`` carries the JAX ``ModelSpec``'s fields into the
port, so both posteriors compute from identical constants; the port's
own ``build_model_spec`` must give the same spec.

Tolerances: lnpost rtol 1e-4 in float32 (``tests/test_torch_posterior.py``'s
bar) and rtol 1e-10 in float64, each with an absolute floor of a tenth of
that times the batch's largest |lnpost| (here lnpost is a sum of
positive and negative pixel terms that can cancel to near 0 for one
walker: 177 beside 8567 in one batch); the same non-finite entries on
both sides; images and carry means 1e-10 of their peak in float64.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psfmc_tpu_torch
from psfmc_tpu import distributions as JD
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.ops.pallas.lnpost_batched import batched_lnl_supported as jax_gate
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.flagship import (
    flagship_components,
    general_components,
    prior_draws,
)
from psfmc_tpu_torch.models import build_model_spec, build_posterior, spec_from_numpy
from psfmc_tpu_torch.models.posterior import lnpost_mode
from psfmc_tpu_torch.ops.kernels import batched_lnl_supported


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE, PSF_SHAPE = (64, 64), (32, 32)

VARIANTS = {
    "one-psf": dict(num_psfs=1),
    "two-psfs": dict(),
    "three-psfs": dict(num_psfs=3),
    "flat-sky": dict(num_psfs=1, gradient=False, noise_scale=False),
    "conv-pad": dict(conv_pad=8),
    "render-oversample": dict(render_oversample=4, oversample_window=10),
    "psf-oversample": dict(psf_oversample=2),
    "pad-and-oversample": dict(conv_pad=4, render_oversample=2),
    "student": dict(likelihood="student", likelihood_df=3.0),
    "poisson": dict(likelihood="poisson", likelihood_gain=2.0, counts=True,
                    noise_scale=False),
}
# index values of the PSF_Index column: on the .5 points (half to even:
# 0.5 -> 0, 1.5 -> 2, 2.5 -> 2), just off them, and outside the range
PSF_INDICES = np.array([0.5, 1.5, 2.5, -0.4, 0.49, 1.51, 3.4, -0.6, 1.0, 0.0])


def numpy_fields(jspec):
    """The JAX ModelSpec as plain numpy arrays and tuples."""
    slots = [(s.name, s.offset, s.size, type(s.dist).__name__,
              dict(s.dist.rv_frozen.kwds), s.fitsname) for s in jspec.slots]
    comps = [(cs.kind, dict(cs.params), dict(cs.static)) for cs in jspec.comp_specs]
    return dict(
        obs_data=np.asarray(jspec.obs_data), obs_var=np.asarray(jspec.obs_var),
        bad_px=np.asarray(jspec.bad_px), f_psf_stack=jspec.f_psf_stack,
        f_var_stack=jspec.f_var_stack, mag_zeropoint=jspec.mag_zeropoint,
        slots=slots, comp_params=comps, likelihood=jspec.likelihood,
        likelihood_df=jspec.likelihood_df, likelihood_gain=jspec.likelihood_gain,
        conv_pad=jspec.conv_pad, render_oversample=jspec.render_oversample,
        oversample_window=jspec.oversample_window,
    )


@functools.lru_cache(maxsize=None)
def specs(variant):
    """(JAX spec, the port's spec carried from it, the port's own build)."""
    kw = VARIANTS[variant]
    jspec = jax_spec(general_components(SHAPE, PSF_SHAPE, components=JC,
                                        distributions=JD, **kw))
    own = build_model_spec(general_components(SHAPE, PSF_SHAPE, **kw))
    return jspec, spec_from_numpy(**numpy_fields(jspec)), own


def thetas(spec, n=10, seed=3):
    """Prior draws with a NaN walker, an out-of-prior walker, a
    non-positive noise scale and the PSF indices of :data:`PSF_INDICES`."""
    th = prior_draws(spec, n, seed=seed)
    off = {s.name: s.offset for s in spec.slots}
    th[1, 0] = np.nan
    th[2, off["3_Sersic_mag"]] = 40.0
    if "4_NoiseScale_scale" in off:
        th[3, off["4_NoiseScale_scale"]] = -0.1
    if "PSF_Index" in off:
        th[:, off["PSF_Index"]] = PSF_INDICES[:n]
    return th


def jax_lnpost(jspec, th, dtype):
    fns = jax_posterior(jspec, dtype=dtype)
    return np.asarray(jax.vmap(fns.log_posterior)(jnp.asarray(th, dtype))), fns


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_own_spec_equals_the_carried_one(variant):
    jspec, carried, own = specs(variant)
    assert own.num_params == carried.num_params == jspec.num_params

    def table(spec):
        return [(s.name, s.fitsname, s.offset, s.size, s.attr, s.comp_index,
                 type(s.dist).__name__, repr(s.dist)) for s in spec.slots]

    assert table(carried) == table(own)
    assert [(s.name, s.fitsname) for s in jspec.slots] == [
        (s.name, s.fitsname) for s in own.slots]
    assert [(c.kind, sorted(c.params)) for c in own.comp_specs] == [
        (c.kind, sorted(c.params)) for c in jspec.comp_specs]
    # the padded and binned spectra and the data are equal, not just close
    for f in ("obs_data", "obs_var", "bad_px", "f_psf_stack", "f_var_stack"):
        np.testing.assert_array_equal(getattr(own, f), getattr(jspec, f))
    for f in ("num_psfs", "likelihood", "likelihood_df", "likelihood_gain",
              "conv_pad", "render_oversample", "oversample_window"):
        assert getattr(own, f) == getattr(jspec, f), f


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_general_lnpost_matches_jax(variant, dtype):
    jspec, carried, _ = specs(variant)
    th = thetas(carried)
    want, _ = jax_lnpost(jspec, th, getattr(jnp, dtype))
    post = build_posterior(carried, device="cpu", dtype=getattr(torch, dtype),
                           lnpost="general")
    got = post.log_posterior_batch(th).numpy()
    assert got[1] == got[2] == -np.inf
    if "4_NoiseScale_scale" in carried.param_names:
        assert got[3] == -np.inf
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert fin.sum() >= 4
    rtol = 1e-4 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=0.1 * rtol * np.abs(want[fin]).max())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_general_images_and_carry_means_match_jax(variant):
    """Per-walker carry images and the walker-mean carry images (per-PSF
    groups, noise-scale weights, the mean sky plane) in float64."""
    jspec, carried, _ = specs(variant)
    th = thetas(carried)
    want, jfns = jax_lnpost(jspec, th, jnp.float64)
    good = th[np.isfinite(want)]
    post = build_posterior(carried, device="cpu", dtype=torch.float64,
                           lnpost="general")
    imgs = post.images_batch(good)
    jimgs = jax.vmap(jfns.carry_images)(jnp.asarray(good))
    means = post.ensemble_carry_means(good)
    jmeans = jfns.ensemble_carry_means(jnp.asarray(good))
    for got, ref in ((imgs, jimgs), (means, jmeans)):
        for k, v in ref.items():
            w = np.asarray(v)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-10 * np.abs(w).max(), err_msg=k)


def test_carry_means_are_the_walker_mean_of_the_images():
    _, carried, _ = specs("three-psfs")
    post = build_posterior(carried, device="cpu", dtype=torch.float64)
    th = prior_draws(carried, 9, seed=4)
    th[:, carried.param_names.index("PSF_Index")] = np.arange(9) % 3
    imgs = post.images_batch(th)
    means = post.ensemble_carry_means(th)
    for k in ("raw", "conv", "var", "ps_conv"):
        torch.testing.assert_close(means[k], imgs[k].mean(dim=0), rtol=1e-10,
                                   atol=1e-12)
    dev = imgs["raw"] - imgs["raw"].mean(dim=0)
    torch.testing.assert_close(means["raw_m2"], (dev * dev).sum(dim=0),
                               rtol=1e-10, atol=1e-12)


def test_psf_index_rounds_half_to_even_and_clips():
    jspec, carried, _ = specs("three-psfs")
    th = thetas(carried)
    post = build_posterior(carried, device="cpu", dtype=torch.float64)
    jfns = jax_posterior(jspec, dtype=jnp.float64)
    got = post._psf_index(post.as_thetas(th)).numpy()
    want = np.asarray(jax.vmap(jfns._psf_index)(jnp.asarray(th)))
    np.testing.assert_array_equal(got, want)
    assert list(got) == [0, 2, 2, 0, 0, 2, 2, 0, 1, 0]
    # the prior rounds the same way: 2.5 -> 2 is inside, 3.4 and -0.6 out
    lp = post.log_prior_batch(th).numpy()
    assert np.isfinite(lp[[0, 4, 5, 8, 9]]).all()
    assert lp[6] == lp[7] == -np.inf


def test_lnpost_mode_selects_the_path(monkeypatch):
    flag = build_model_spec(flagship_components(SHAPE, PSF_SHAPE))
    gen = specs("two-psfs")[1]
    for env in (None, "", "xla", "foo"):  # the JAX package's XLA path
        if env is None:
            monkeypatch.delenv("PSFMC_LNPOST", raising=False)
        else:
            monkeypatch.setenv("PSFMC_LNPOST", env)
        assert lnpost_mode(spec=flag) == "batched"
        assert lnpost_mode(spec=gen) == "general"
        assert build_posterior(gen, device="cpu").lnpost == "general"
    assert lnpost_mode("general", flag) == "general"
    for env, mode in (("pallas", "fused"), ("pallas_batched", "batched")):
        monkeypatch.setenv("PSFMC_LNPOST", env)
        assert lnpost_mode(spec=gen) == mode
        with pytest.raises(ValueError, match="does not cover"):
            build_posterior(gen, device="cpu")
    monkeypatch.delenv("PSFMC_LNPOST")
    for mode in ("fused", "batched"):
        with pytest.raises(ValueError, match="does not cover"):
            build_posterior(gen, device="cpu", lnpost=mode)


def test_unknown_psfmc_lnpost_builds_the_unset_posterior(monkeypatch):
    """``PSFMC_LNPOST=foo`` runs what an unset variable runs, as in the
    JAX package (whose XLA path any value but the kernel names takes)."""
    _, carried, _ = specs("two-psfs")
    flag = build_model_spec(flagship_components(SHAPE, PSF_SHAPE))
    th = thetas(carried)
    out = {}
    for env in (None, "foo"):
        if env is None:
            monkeypatch.delenv("PSFMC_LNPOST", raising=False)
        else:
            monkeypatch.setenv("PSFMC_LNPOST", env)
        posts = [build_posterior(s, device="cpu", dtype=torch.float64)
                 for s in (carried, flag)]
        out[env] = ([p.lnpost for p in posts],
                    posts[0].log_posterior_batch(th),
                    posts[1].log_posterior_batch(prior_draws(flag, 4, seed=1)))
    assert out[None][0] == out["foo"][0] == ["general", "batched"]
    for a, b in zip(out[None][1:], out["foo"][1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["flat-sky", "two-psfs"])
def test_kappa_newton_matches_jax(monkeypatch, variant):
    """``PSFMC_KAPPA=newton`` selects the Newton solver on both sides."""
    jspec, spec, _ = specs(variant)
    assert lnpost_mode(spec=spec) == ("batched" if variant == "flat-sky"
                                      else "general")
    th = prior_draws(spec, 6, seed=8)
    monkeypatch.setenv("PSFMC_KAPPA", "newton")
    want, _ = jax_lnpost(jspec, th, jnp.float64)
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    assert post.kappa_mode == "exact"
    got = post.log_posterior_batch(th).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    monkeypatch.setenv("PSFMC_KAPPA", "table")
    table = build_posterior(spec, device="cpu", dtype=torch.float64)
    assert table.kappa_mode == "table"
    assert not np.array_equal(table.log_posterior_batch(th).numpy(), got)


def test_public_api_has_the_reference_names():
    for name in ("model_galaxy_mcmc", "MultiComponentModel", "load_database"):
        assert hasattr(psfmc_tpu_torch, name), name
        assert name in psfmc_tpu_torch.__all__


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_batched_gate_matches_jax(variant):
    jspec, carried, _ = specs(variant)
    ok, why = batched_lnl_supported(carried)
    assert ok == jax_gate(jspec)
    assert ok == (variant == "flat-sky") and (ok or why)


@pytest.mark.parametrize("low,high", [(0, 2), (0, 3), (-1, 4)])
def test_discrete_uniform_matches_jax_logp(low, high):
    tdist, jdist = TD.DiscreteUniform(low=low, high=high), JD.DiscreteUniform(
        low=low, high=high)
    ks = np.arange(low - 2, high + 2, dtype=float)
    xs = np.concatenate([ks, ks + 0.5, ks - 0.5, ks + 0.49, ks + 0.51,
                         [np.nan, np.inf, -np.inf]])
    got = tdist.torch_logp(torch.as_tensor(xs)).numpy()
    want = np.asarray(jdist.jax_logp(jnp.asarray(xs)))
    np.testing.assert_array_equal(got, want)
    # inside the support, at its edges, at .5 (half to even) and outside
    assert got[ks.tolist().index(low)] == got[ks.tolist().index(high - 1)] == \
        pytest.approx(-math.log(high - low), rel=1e-15)
    assert got[ks.tolist().index(low - 1)] == got[ks.tolist().index(high)] == -np.inf
    half = ks + 0.5
    inside = (np.round(half) >= low) & (np.round(half) <= high - 1)
    np.testing.assert_array_equal(np.isfinite(got[len(ks):2 * len(ks)]), inside)
    np.testing.assert_array_equal(tdist.logp(xs[:len(ks)]), jdist.logp(xs[:len(ks)]))
    assert tdist.is_discrete and tdist.median() == jdist.median()


def test_noise_scale_and_poisson_refusals_match_jax():
    with pytest.raises(ValueError, match="NoiseScale cannot be combined"):
        build_model_spec(general_components(SHAPE, PSF_SHAPE, likelihood="poisson",
                                            counts=True))
    with pytest.raises(ValueError, match="non-negative data"):
        build_model_spec(general_components(SHAPE, PSF_SHAPE, likelihood="poisson",
                                            noise_scale=False))
    with pytest.raises(ValueError, match="non-negative data"):
        jax_spec(general_components(SHAPE, PSF_SHAPE, likelihood="poisson",
                                    noise_scale=False, components=JC,
                                    distributions=JD))
    for kw, match in ((dict(likelihood="cauchy"), "Unknown likelihood"),
                      (dict(likelihood="student", likelihood_df=0.0), "df"),
                      (dict(likelihood="poisson", likelihood_gain=-1.0), "gain"),
                      (dict(conv_pad=-1), "conv_pad"),
                      (dict(render_oversample=1.5), "render_oversample"),
                      (dict(psf_oversample=3), "does not divide")):
        with pytest.raises(ValueError, match=match):
            general_components(SHAPE, PSF_SHAPE, **kw)
