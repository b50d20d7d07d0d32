"""The port's fused likelihood (kernel #3) against the JAX package's, on the CPU.

The JAX package's fused Pallas kernel (``make_fused_lnl_batch``) runs in
interpret mode with true-f32 products (``PSFMC_LNPOST_DOT=highest``: its
bf16x3 default differs from fp32 by ~3e-5 relative); the port's wrapper
runs its plain PyTorch version, as it does for every CPU tensor.  Both
compute from the same ``ModelSpec`` (carried with ``spec_from_numpy``)
and the same numpy thetas, at 24x24 with a 12x12 PSF and 6 walkers.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.ops.pallas.lnpost_pallas import make_fused_lnl_batch
from psfmc_tpu_torch.flagship import prior_draws
from psfmc_tpu_torch.models import build_posterior, spec_from_numpy
from psfmc_tpu_torch.models.posterior import lnpost_mode
from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
from test_torch_posterior import _graft_entry, _numpy_fields

SHAPE, PSF_SHAPE = (24, 24), (12, 12)
FUSED_ENV = {"PSFMC_CONV": "dft", "PSFMC_CONV_PRECISION": "highest",
             "PSFMC_LNPOST": "pallas", "PSFMC_LNPOST_DOT": "highest"}


@pytest.fixture(scope="module")
def specs():
    jspec = jax_spec(_graft_entry()._flagship_components(SHAPE, PSF_SHAPE))
    return jspec, spec_from_numpy(**_numpy_fields(jspec))


@pytest.fixture
def fused_env(monkeypatch):
    for k, v in FUSED_ENV.items():
        monkeypatch.setenv(k, v)


def _thetas(spec, n=6):
    th = prior_draws(spec, n, seed=11)
    th[1, 0] = np.nan  # a NaN theta: lnl and lnpost exactly -inf
    return th


def test_fused_lnl_plain_matches_pallas_fused(specs, fused_env):
    jspec, carried = specs
    constants = jax_posterior(jspec).constants
    lnl_jax = make_fused_lnl_batch(constants, jspec, jspec.comp_specs,
                                   float(jspec.mag_zeropoint), jnp.float32,
                                   interpret=True)
    th = _thetas(carried)
    want = np.asarray(lnl_jax(jnp.asarray(th, jnp.float32)))

    post = build_posterior(carried, device="cpu", dtype=torch.float32,
                           lnpost="fused")
    thetas = post.as_thetas(th)
    params, sky = post.render_inputs(thetas)
    fky, kx = post.pointsource_inputs(thetas)
    assert tuple(fky.shape) == (6, 1, SHAPE[0]) and tuple(kx.shape) == (6, 1, SHAPE[1])
    before = FL.fused_lnl.launches
    got = FL.fused_lnl(params, sky, fky, kx, post.consts).numpy()
    assert FL.fused_lnl.launches == before  # the CPU runs the plain version
    np.testing.assert_array_equal(
        got, FL.fused_lnl_plain(params, sky, fky, kx, post.consts).numpy())

    assert got[1] == want[1] == -np.inf
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and fin.sum() == 5
    # float32, true-fp32 products on both sides: rtol 1e-5
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_fused_posterior_matches_jax_pallas_mode(specs, fused_env):
    jspec, carried = specs
    jfns = jax_posterior(jspec)
    th = _thetas(carried)
    off = {s.name: s.offset for s in carried.slots}
    th[2, off["2_Sersic_reff_b"]] = th[2, off["2_Sersic_reff"]] + 1.0  # reff_b > reff
    want = np.asarray(jfns.log_posterior_batch(jnp.asarray(th, jnp.float32)))
    post = build_posterior(carried, device="cpu", dtype=torch.float32)
    assert post.lnpost == "fused"  # PSFMC_LNPOST=pallas
    got = post.log_posterior_batch(th).numpy()
    assert got[1] == got[2] == -np.inf
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and fin.sum() == 4
    # float32 on both sides: rtol 1e-5
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_fused_and_batched_agree_in_float64(specs):
    _, carried = specs
    th = prior_draws(carried, 8, seed=12)
    out = {mode: build_posterior(carried, device="cpu", dtype=torch.float64,
                                 lnpost=mode).log_posterior_batch(th)
           for mode in ("fused", "batched")}
    torch.testing.assert_close(out["fused"], out["batched"], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("env,mode", [
    (None, "batched"), ("", "batched"), ("xla", "batched"),
    ("pallas_batched", "batched"), ("pallas", "fused"),
])
def test_lnpost_mode_reads_psfmc_lnpost(monkeypatch, env, mode):
    if env is None:
        monkeypatch.delenv("PSFMC_LNPOST", raising=False)
    else:
        monkeypatch.setenv("PSFMC_LNPOST", env)
    assert lnpost_mode() == mode
    # an explicit choice wins over the variable
    assert lnpost_mode("batched") == "batched" and lnpost_mode("fused") == "fused"


def test_lnpost_mode_rejects_unknown_values(monkeypatch):
    """An unknown ``lnpost`` argument raises; an unknown ``PSFMC_LNPOST``
    value runs what an unset variable runs (the JAX package's XLA path)."""
    monkeypatch.setenv("PSFMC_LNPOST", "mosaic")
    assert lnpost_mode() == "batched"
    with pytest.raises(ValueError, match="lnpost"):
        lnpost_mode("pallas")


@pytest.mark.parametrize("change,match", [
    (dict(likelihood="student"), "non-Gaussian"),
    (dict(conv_pad=4), "conv_pad"),
    (dict(num_psfs=2), "several PSFs"),
    (dict(shape=(1, 20000)), "shared memory"),
])
def test_fused_mode_raises_for_a_rejected_spec(specs, change, match):
    """The JAX package warns and falls back; the port raises ValueError
    (at 1x20000, a side of 1, which only the matmul-DFT route takes, for
    its three buffers in shared memory; 512x512 took that route, and this
    case, until the global route took it)."""
    spec = replace(specs[1], **change)
    with pytest.raises(ValueError, match=match):
        build_posterior(spec, device="cpu", lnpost="fused")
    if "shape" not in change:  # the conv+likelihood kernel refuses it too
        with pytest.raises(ValueError, match=f"'batched'.*does not cover.*{match}"):
            build_posterior(spec, device="cpu", lnpost="batched")


def test_fused_gate_covers_the_flagship_at_128(specs):
    assert FL.fused_lnl_supported(replace(specs[1], shape=(128, 128)))[0]
    assert FL.fused_lnl_smem_bytes((128, 128), 2, 1) == 200776


def test_fused_wrapper_checks_shapes(specs):
    post = build_posterior(specs[1], device="cpu", lnpost="fused")
    th = post.as_thetas(prior_draws(specs[1], 3, seed=13))
    params, sky = post.render_inputs(th)
    fky, kx = post.pointsource_inputs(th)
    with pytest.raises(ValueError, match="sky must be"):
        FL.fused_lnl(params, sky[:2], fky, kx, post.consts)
    with pytest.raises(ValueError, match="kx must be"):
        FL.fused_lnl(params, sky, fky, kx[:, :, :-1], post.consts)
    # no point sources is a valid (B, 0, H) input
    got = FL.fused_lnl(params, sky, fky[:, :0], kx[:, :0], post.consts)
    assert got.shape == (3,)
