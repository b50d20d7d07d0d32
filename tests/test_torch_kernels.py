"""The kernel modules' plain versions against the JAX package's Pallas kernels.

On the CPU the port's kernel wrappers return their plain PyTorch
versions; the JAX package's Pallas kernels run in interpret mode, as in
``tests/test_pallas.py``.  Both get the same numpy inputs.  The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.models.components import Configuration, PointSource, Sersic, Sky
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.ops.pallas import (
    pack_sersic_params,
    render_sersics_pallas,
)
from psfmc_tpu.ops.pallas.lnpost_batched import make_batched_conv_lnl
from psfmc_tpu.ops.pallas.sersic_pallas import render_sersics_pallas_tiled
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import sersic_render as SR
from psfmc_tpu_torch.ops.sersic import sersic_scalar_params


def _packed_rows(rng, b, s):
    """(B, S, 9) rows packed by the JAX package, float32."""
    rows = []
    for _ in range(b):
        per = []
        for _ in range(s):
            per.append(pack_sersic_params(
                jnp.asarray([10 + 12 * rng.rand(), 10 + 12 * rng.rand()],
                            jnp.float32),
                20.0 + rng.rand(), 3.0 + 3 * rng.rand(), 2.0 + 1 * rng.rand(),
                0.7 + 3 * rng.rand(), 180.0 * rng.rand(), 25.0, True,
                kappa_mode="table",
            ))
        rows.append(jnp.stack(per))
    return np.asarray(jnp.stack(rows), np.float32)


def _rel(got, want):
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12))


def test_render_plain_matches_pallas():
    rng = np.random.RandomState(21)
    shape = (32, 32)
    params = _packed_rows(rng, 4, 2)
    sky = (0.1 * rng.rand(4)).astype(np.float32)
    want = np.asarray(render_sersics_pallas(jnp.asarray(params),
                                            jnp.asarray(sky), shape))
    before = SR.render_sersics.launches
    got = SR.render_sersics(torch.as_tensor(params), torch.as_tensor(sky),
                            shape).numpy()
    # float32, per-pixel relative error < 5e-6 (the Pallas test's bar)
    assert _rel(got, want) < 5e-6
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert SR.render_sersics.launches == before


@pytest.mark.parametrize("tile", [None, 2])
def test_render_tiled_plain_matches_pallas_tiled(tile):
    rng = np.random.RandomState(22)
    shape = (24, 32)  # non-square: x runs along the columns
    params = _packed_rows(rng, 4, 2)
    sky = (0.1 * rng.rand(4)).astype(np.float32)
    want = np.asarray(render_sersics_pallas_tiled(
        jnp.asarray(params), jnp.asarray(sky), shape, tile=tile))
    got = SR.render_sersics_tiled(torch.as_tensor(params),
                                  torch.as_tensor(sky), shape,
                                  tile=tile).numpy()
    assert _rel(got, want) < 5e-6  # float32, as above


def test_render_tiled_rejects_tile_not_dividing_batch():
    params = torch.zeros((6, 1, 9))
    sky = torch.zeros(6)
    with pytest.raises(ValueError, match="does not divide"):
        SR.render_sersics_tiled(params, sky, (8, 8), tile=4)
    with pytest.raises(ValueError, match="does not divide"):
        render_sersics_pallas_tiled(jnp.zeros((6, 1, 9)), jnp.zeros(6),
                                    (8, 8), tile=4)
    assert SR.pick_tile(125) == 25 and SR.pick_tile(7) == 1


def test_render_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        SR.render_sersics(torch.zeros((2, 1, 8)), torch.zeros(2), (4, 4))
    with pytest.raises(ValueError):
        SR.render_sersics(torch.zeros((2, 1, 9)), torch.zeros(3), (4, 4))


def test_packed_scalars_match_jax():
    rng = np.random.RandomState(23)
    n = 6
    xy = rng.uniform(5, 25, size=(n, 2))
    mag, reff = 20 + rng.rand(n), 2 + 4 * rng.rand(n)
    reff_b, index, angle = 1 + rng.rand(n), 0.5 + 4 * rng.rand(n), 180 * rng.rand(n)
    got = SR.pack_sersic_params(sersic_scalar_params(
        *(torch.as_tensor(v) for v in (xy, mag, reff, reff_b, index, angle)),
        25.9463, True, "table")).numpy()
    want = np.stack([np.asarray(pack_sersic_params(
        jnp.asarray(xy[i]), mag[i], reff[i], reff_b[i], index[i], angle[i],
        25.9463, True, kappa_mode="table")) for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-12)  # float64


def _jax_flagship_spec(rng, shape=(32, 32), psf_side=16):
    h, w = shape
    psf = np.exp(-((np.mgrid[0:psf_side, 0:psf_side] - psf_side / 2) ** 2).sum(0)
                 / (2 * 1.5**2))
    obs = 0.1 + rng.randn(h, w) * 0.01
    ivm = np.full(shape, 1e4)
    ivm[3, 5] = 0.0  # one bad pixel
    mask = np.zeros(shape, bool)
    mask[:2, -3:] = True
    comps = [
        Configuration(obs_file=obs, obsivm_file=ivm, psf_files=psf,
                      psfivm_files=np.full_like(psf, 1e6), mask_file=mask,
                      mag_zeropoint=25.0),
        Sky(adu=JD.Normal(loc=0.1, scale=0.05)),
        PointSource(xy=JD.Uniform(loc=np.array([10.0, 10.0]),
                                  scale=np.array([12.0, 12.0])),
                    mag=JD.Uniform(loc=19.0, scale=3.0)),
        Sersic(xy=JD.Uniform(loc=np.array([10.0, 10.0]),
                             scale=np.array([12.0, 12.0])),
               mag=JD.Uniform(loc=20.0, scale=3.0),
               reff=JD.Uniform(loc=1.0, scale=6.0),
               reff_b=JD.Uniform(loc=1.0, scale=6.0),
               index=JD.WeibullMinimum(c=1.5, scale=4),
               angle=JD.Uniform(loc=0.0, scale=180.0), angle_degrees=True),
    ]
    return jax_spec(comps)


def test_conv_lnl_plain_matches_pallas_batched(monkeypatch):
    monkeypatch.setenv("PSFMC_LNPOST_DOT", "highest")
    rng = np.random.RandomState(24)
    spec = _jax_flagship_spec(rng)
    constants = jax_posterior(spec).constants
    raws = (0.1 + np.abs(rng.randn(6, *spec.shape)) * 0.5).astype(np.float32)
    # tile 4 on a batch of 6: the Pallas kernel's pad-to-whole-tiles path
    lnl_jax = make_batched_conv_lnl(constants, spec, jnp.float32, tile=4)
    want = np.asarray(lnl_jax(jnp.asarray(raws)))

    consts = CL.make_conv_lnl_consts(
        spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
        spec.obs_var, ~spec.bad_px, "cpu", torch.float32,
    )
    before = CL.batched_conv_lnl.launches
    got = CL.batched_conv_lnl(torch.as_tensor(raws), consts).numpy()
    # float32 with true-fp32 products on both sides: rtol 2e-6
    np.testing.assert_allclose(got, want, rtol=2e-6)
    assert CL.batched_conv_lnl.launches == before

    # non-finite input -> exactly -inf, like the Pallas wrapper
    raws[2, 4, 4] = np.nan
    got = CL.batched_conv_lnl(torch.as_tensor(raws), consts).numpy()
    assert got[2] == -np.inf and np.all(np.isfinite(np.delete(got, 2)))


def test_conv_lnl_block_operators_are_the_rdft_stages():
    """The kernel's (2H, 2H) h-stage operators equal the four real
    products of ``convolve_rdft`` they replace."""
    rng = np.random.RandomState(25)
    h, w = 6, 10
    consts = CL.make_conv_lnl_consts(
        np.fft.rfft2(rng.rand(h, w)), np.fft.rfft2(rng.rand(h, w)),
        rng.rand(h, w), np.full((h, w), 0.1), np.ones((h, w), bool),
        "cpu", torch.float64,
    )
    c = consts
    s1r, s1i = torch.as_tensor(rng.rand(h, 6)), torch.as_tensor(rng.rand(h, 6))
    out = c.lf @ torch.cat([s1r, s1i])
    torch.testing.assert_close(out[:h], c.ch @ s1r + c.sh @ s1i)
    torch.testing.assert_close(out[h:], c.ch @ s1i - c.sh @ s1r)
    out = c.li @ torch.cat([s1r, s1i])
    torch.testing.assert_close(out[:h], c.ich @ s1r - c.ish @ s1i)
    torch.testing.assert_close(out[h:], c.ich @ s1i + c.ish @ s1r)


def test_conv_lnl_wrapper_checks_shape():
    consts = CL.make_conv_lnl_consts(
        np.ones((4, 3), complex), np.ones((4, 3), complex), np.zeros((4, 4)),
        np.ones((4, 4)), np.ones((4, 4), bool), "cpu",
    )
    with pytest.raises(ValueError, match="raws must be"):
        CL.batched_conv_lnl(torch.zeros((2, 4, 5)), consts)
