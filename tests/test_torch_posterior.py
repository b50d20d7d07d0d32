"""The port's flagship slice against the JAX package's posterior, on the CPU.

The flagship model (Sky + PointSource + 2 Sersic, 18 parameters) is
built once by each package from the same seeded arrays, at 64x64 with a
32x32 PSF.  ``spec_from_numpy`` carries the JAX ``ModelSpec``'s fields
into the port, so both posteriors compute from identical constants.
"""
import functools
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.ops.kernels import batched_lnl_supported
from psfmc_tpu_torch.models import (
    Configuration,
    PointSource,
    Sersic,
    Sky,
    Tied,
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


def _small_config(C=None, **kw):
    psf = np.ones((4, 4))
    args = dict(obs_file=np.ones((8, 8)), obsivm_file=np.ones((8, 8)),
                psf_files=psf, psfivm_files=psf, mag_zeropoint=25.0)
    args.update(kw)
    return (C.Configuration if C is not None else Configuration)(**args)


def _sersic(C=None, D=TD, **kw):
    return (C.Sersic if C is not None else Sersic)(
        xy=D.Uniform(loc=np.array([2.0, 2.0]), scale=np.array([4.0, 4.0])),
        mag=D.Uniform(loc=20, scale=2), reff=2.0, reff_b=1.0,
        index=D.Uniform(loc=1, scale=2), angle=0.0, **kw)


_SHAPES = [dict(c0=TD.Uniform(loc=-0.5, scale=1.0)), dict(rtrunc=5.0, rsoft=1.0),
           dict(f1=0.1, f1_phi=0.3), dict(b1=0.1), dict(rot_ang=1.0, rot_out=3.0),
           dict(rtrunc_in=1.0, rsoft_in=0.5)]
_SHAPE_IDS = ["boxy-c0", "truncation", "fourier", "bending", "rotation",
              "inner-truncation"]
# a TAN WCS of the 8x8 observation: 0.05"/px, north up
_WCS = {"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRPIX1": 4.5, "CRPIX2": 4.5,
        "CRVAL1": 150.0, "CRVAL2": 2.0, "CD1_1": -0.05 / 3600, "CD1_2": 0.0,
        "CD2_1": 0.0, "CD2_2": 0.05 / 3600}


def _sky_tied(C, D, wcs, **kw):
    """A shaped Sersic whose point source is tied to it in sky frame, in
    one band with or without a WCS."""
    shape = {k: (D.Uniform(loc=-0.5, scale=1.0) if k == "c0" else v)
             for k, v in kw.items()}
    host = _sersic(C, D, **shape)
    obs = (_WCS, np.ones((8, 8))) if wcs else np.ones((8, 8))
    return [_small_config(C, obs_file=obs), host,
            C.PointSource(xy=C.Tied(host, "xy", frame="sky"),
                          mag=D.Uniform(loc=20, scale=2))]


@pytest.mark.parametrize("comps", [functools.partial(_sky_tied, **kw)
                                   for kw in _SHAPES], ids=_SHAPE_IDS)
def test_sky_tie_on_a_shaped_component_matches_jax(comps):
    """A single-band ``frame="sky"`` tie, whatever the shape of the
    component it names, is held to the JAX package: without a WCS on the
    observation it raises the JAX package's ``ValueError``; with one it
    builds the JAX package's spec (the tie a ``theta_affine`` through the
    band's own WCS, A and b within 1e-12 of the JAX package's; the map is
    the identity up to the finite differences' round-off, 1e-8)."""
    errors = []
    for C, D, build in ((JC, JD, jax_spec), (TC, TD, build_model_spec)):
        with pytest.raises(ValueError, match="requires WCS headers") as err:
            build(comps(C, D, wcs=False))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    jspec, own = jax_spec(comps(JC, JD, wcs=True)), build_model_spec(comps(TC, TD, wcs=True))
    assert own.param_names == list(jspec.param_names)
    for a, b in zip(own.comp_specs, jspec.comp_specs):
        assert a.kind == b.kind and sorted(a.params) == sorted(b.params)
        for k, (rule, payload) in a.params.items():
            assert rule == b.params[k][0]
            if rule == "theta_affine":
                assert payload[:2] == tuple(b.params[k][1][:2])
                for x, y in zip(payload[2:], b.params[k][1][2:]):
                    np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
                np.testing.assert_allclose(payload[2], np.eye(2), atol=1e-8)
                np.testing.assert_allclose(payload[3], np.zeros(2), atol=1e-8)


@pytest.mark.parametrize("kw", _SHAPES, ids=_SHAPE_IDS)
def test_spec_with_an_isophote_shape_builds(kw, monkeypatch):
    """The shapes the render-family slice brought in build, take the
    batched path and give a finite lnpost."""
    monkeypatch.delenv("PSFMC_LNPOST", raising=False)
    spec = build_model_spec([_small_config(), _sersic(**kw)])
    post = build_posterior(spec, device="cpu")
    assert post.lnpost == "batched"
    th = post.as_thetas(prior_draws(spec, 3, seed=1))
    assert torch.isfinite(post.log_posterior_batch(th)).all()


@pytest.mark.parametrize("comps", [
    lambda: [_small_config(), Sky(adu=TD.Normal(loc=0, scale=1),
                                  dx=TD.Normal(loc=0, scale=1))],
    lambda: [_small_config(conv_pad=2), _sersic()],
    lambda: [_small_config(render_oversample=4), _sersic()],
    lambda: [_small_config(likelihood="student"), _sersic()],
    lambda: [_small_config(psf_files=[np.ones((4, 4)), np.eye(4) + 1],
                           psfivm_files=[np.ones((4, 4))] * 2), _sersic()],
    lambda: [_small_config(psf_oversample=2), _sersic()],
], ids=["sky-gradient", "conv-pad", "oversample", "student", "two-psfs",
        "psf-oversample"])
def test_spec_of_the_general_slice_builds(comps, monkeypatch):
    """What the slice of the general path brought in builds, and an unset
    ``PSFMC_LNPOST`` picks the path that covers it."""
    monkeypatch.delenv("PSFMC_LNPOST", raising=False)
    spec = build_model_spec(comps())
    post = build_posterior(spec, device="cpu")
    covered = batched_lnl_supported(spec)[0]
    assert post.lnpost == ("batched" if covered else "general")
    th = post.as_thetas(prior_draws(spec, 3, seed=1))
    assert torch.isfinite(post.log_posterior_batch(th)).all()


def test_unported_prior_in_a_carried_spec_raises(specs):
    """A carried slot of any family of the JAX package builds (Gamma was
    refused before the priors slice) and its prior is JAX's; a family name
    outside the map raises."""
    fields = _numpy_fields(specs[0])
    name, off, size, _, _, fits = fields["slots"][0]
    fields["slots"][0] = (name, off, size, "Gamma", {"a": 2.0}, fits)
    spec = spec_from_numpy(**fields)
    assert type(spec.slots[0].dist).__name__ == "Gamma"
    xs = np.array([-0.5, 0.5, 3.0])
    got = spec.slots[0].dist.torch_logp(torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(got, np.asarray(JD.Gamma(a=2.0).jax_logp(jnp.asarray(xs))),
                               rtol=1e-12)
    fields["slots"][0] = (name, off, size, "NoSuchFamily", {"a": 2.0}, fits)
    with pytest.raises(ValueError, match="unknown prior family"):
        spec_from_numpy(**fields)
    assert math.isfinite(JD.Gamma(a=2.0).median())
