"""The port's flagship slice against the JAX package's posterior, on the CPU.

The flagship model (Sky + PointSource + 2 Sersic, 18 parameters) is
built once by each package from the same seeded arrays, at 64x64 with a
32x32 PSF.  ``spec_from_numpy`` carries the JAX ``ModelSpec``'s fields
into the port, so both posteriors compute from identical constants.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import (
    Configuration,
    Sersic,
    Sky,
    build_model_spec,
    build_posterior,
    spec_from_numpy,
)

SHAPE, PSF_SHAPE = (64, 64), (32, 32)


def _graft_entry():
    """The JAX package's flagship builder (``__graft_entry__.py``)."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry_torch_test",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_fields(jspec):
    """The JAX ModelSpec as plain numpy arrays and tuples."""
    slots = [
        (s.name, s.offset, s.size, type(s.dist).__name__,
         dict(s.dist.rv_frozen.kwds), s.fitsname)
        for s in jspec.slots
    ]
    comps = [(cs.kind, dict(cs.params), dict(cs.static))
             for cs in jspec.comp_specs]
    return dict(
        obs_data=np.asarray(jspec.obs_data), obs_var=np.asarray(jspec.obs_var),
        bad_px=np.asarray(jspec.bad_px), f_psf_stack=jspec.f_psf_stack,
        f_var_stack=jspec.f_var_stack, mag_zeropoint=jspec.mag_zeropoint,
        slots=slots, comp_params=comps, likelihood=jspec.likelihood,
        conv_pad=jspec.conv_pad, render_oversample=jspec.render_oversample,
    )


@pytest.fixture(scope="module")
def specs():
    jspec = jax_spec(_graft_entry()._flagship_components(SHAPE, PSF_SHAPE))
    tspec = build_model_spec(flagship_components(SHAPE, PSF_SHAPE))
    return jspec, spec_from_numpy(**_numpy_fields(jspec)), tspec


def test_spec_from_numpy_matches_own_build(specs):
    jspec, carried, own = specs
    assert own.num_params == carried.num_params == jspec.num_params == 18

    def table(spec):
        return [(s.name, s.fitsname, s.offset, s.size, s.attr, s.comp_index,
                 type(s.dist).__name__, repr(s.dist)) for s in spec.slots]

    assert table(carried) == table(own)
    assert [(s.name, s.fitsname) for s in jspec.slots] == [
        (s.name, s.fitsname) for s in own.slots]
    assert [(c.kind, c.params.keys(), c.static) for c in carried.comp_specs] == [
        (c.kind, c.params.keys(), c.static) for c in own.comp_specs]
    for a, b in zip(carried.comp_specs, own.comp_specs):
        for k in a.params:
            assert a.params[k][0] == b.params[k][0]
            np.testing.assert_array_equal(a.params[k][1], b.params[k][1])
    # the constants are equal, not just close: same preprocessing
    for f in ("obs_data", "obs_var", "bad_px", "f_psf_stack", "f_var_stack"):
        np.testing.assert_array_equal(getattr(carried, f), getattr(own, f))
    assert carried.mag_zeropoint == own.mag_zeropoint


JAX_PATHS = {
    # the JAX package's kernel path: Pallas render + walker-batched
    # Pallas conv+likelihood (interpret mode here), true-f32 dots
    "pallas": {"PSFMC_CONV": "dft", "PSFMC_CONV_PRECISION": "highest",
               "PSFMC_RENDER": "pallas", "PSFMC_LNPOST": "pallas_batched",
               "PSFMC_LNPOST_DOT": "highest"},
    # its default XLA path (FFT convolution on the CPU backend)
    "xla": {"PSFMC_CONV": "", "PSFMC_RENDER": "xla", "PSFMC_LNPOST": "xla"},
}


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
def test_lnpost_and_carry_means_match_jax(specs, monkeypatch, path):
    jspec, carried, _ = specs
    for k, v in JAX_PATHS[path].items():
        monkeypatch.setenv(k, v)
    jfns = jax_posterior(jspec)
    th = prior_draws(carried, 8, seed=3)
    th[1, 0] = np.nan  # NaN theta
    off = {s.name: s.offset for s in carried.slots}
    th[2, off["2_Sersic_reff_b"]] = th[2, off["2_Sersic_reff"]] + 1.0  # reff_b > reff
    th[3, off["3_Sersic_mag"]] = 40.0  # outside its uniform prior

    th32 = jnp.asarray(th, jnp.float32)
    if path == "pallas":
        want = np.asarray(jfns.log_posterior_batch(th32))
    else:
        want = np.asarray(jax.vmap(jfns.log_posterior)(th32))
    tfns = build_posterior(carried, device="cpu", dtype=torch.float32)
    got = tfns.log_posterior_batch(th).numpy()

    # exact -inf for the NaN, constraint-violating and out-of-support
    # thetas, finite elsewhere
    assert got[1] == got[2] == got[3] == -np.inf
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() == len(th) - 3
    # float32 on both sides: rtol 1e-4 (tests/test_pallas.py's bar)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)

    good = th[fin]
    means = tfns.ensemble_carry_means(good)
    jmeans = jfns.ensemble_carry_means(jnp.asarray(good, jnp.float32))
    for k in ("raw", "conv", "var", "ps_conv", "raw_m2"):
        w = np.asarray(jmeans[k])
        # float32 images: 1e-4 of the image's peak (sums over walkers
        # and different convolution algorithms on the two sides)
        np.testing.assert_allclose(means[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_plain_paths_agree_in_float64(specs):
    """log_posterior_batch (kernel-wrapper path) equals the images +
    gaussian_lnlike path, and the carry means equal the walker mean of
    the per-walker images."""
    _, carried, _ = specs
    tfns = build_posterior(carried, device="cpu", dtype=torch.float64)
    th = prior_draws(carried, 6, seed=9)
    a = tfns.log_posterior_batch(th)
    b, imgs = tfns.lnpost_images_batch(th)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=0.0)
    means = tfns.ensemble_carry_means(th)
    for k in ("raw", "conv", "var", "ps_conv"):
        torch.testing.assert_close(means[k], imgs[k].mean(dim=0),
                                   rtol=1e-10, atol=1e-12)
    dev = imgs["raw"] - imgs["raw"].mean(dim=0)
    torch.testing.assert_close(means["raw_m2"], (dev * dev).sum(dim=0),
                               rtol=1e-10, atol=1e-12)


def test_build_posterior_requires_cuda_or_explicit_cpu(specs):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_posterior(specs[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_posterior(specs[1], device="cuda")


def _small_config(**kw):
    psf = np.ones((4, 4))
    args = dict(obs_file=np.ones((8, 8)), obsivm_file=np.ones((8, 8)),
                psf_files=psf, psfivm_files=psf, mag_zeropoint=25.0)
    args.update(kw)
    return Configuration(**args)


def _sersic(**kw):
    return Sersic(xy=TD.Uniform(loc=np.array([2.0, 2.0]), scale=np.array([4.0, 4.0])),
                  mag=TD.Uniform(loc=20, scale=2), reff=2.0, reff_b=1.0,
                  index=TD.Uniform(loc=1, scale=2), angle=0.0, **kw)


@pytest.mark.parametrize("comps", [
    lambda: [_small_config(), Sky(adu=TD.Normal(loc=0, scale=1),
                                  dx=TD.Normal(loc=0, scale=1))],
    lambda: [_small_config(), _sersic(c0=TD.Uniform(loc=-0.5, scale=1.0))],
    lambda: [_small_config(), _sersic(rtrunc=5.0, rsoft=1.0)],
    lambda: [_small_config(conv_pad=2), _sersic()],
    lambda: [_small_config(render_oversample=4), _sersic()],
    lambda: [_small_config(likelihood="student"), _sersic()],
    lambda: [_small_config(psf_files=[np.ones((4, 4)), np.eye(4) + 1],
                           psfivm_files=[np.ones((4, 4))] * 2), _sersic()],
    lambda: [_small_config(psf_oversample=2), _sersic()],
], ids=["sky-gradient", "boxy-c0", "truncation", "conv-pad", "oversample",
        "student", "two-psfs", "psf-oversample"])
def test_spec_outside_the_slice_raises(comps):
    with pytest.raises(NotImplementedError, match="not in this slice"):
        build_model_spec(comps())


def test_unported_prior_in_a_carried_spec_raises(specs):
    fields = _numpy_fields(specs[0])
    name, off, size, _, _, fits = fields["slots"][0]
    fields["slots"][0] = (name, off, size, "Gamma", {"a": 2.0}, fits)
    with pytest.raises(NotImplementedError, match="not ported"):
        spec_from_numpy(**fields)
    assert math.isfinite(JD.Gamma(a=2.0).median())
