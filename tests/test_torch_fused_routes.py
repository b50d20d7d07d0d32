"""The fused kernel on conv_lnl's routes, on the CPU.

The fused kernel (``csrc/fused_lnl.cu``) runs on every route conv_lnl
has: the FFT route's radix-2 and mixed-radix geometries, the padded route
and the cluster route, with the matmul-DFT route left for what no other
route holds.  What runs here: its gate against the JAX package's at the
flagship's shapes, the cluster route's split of the rows over the ranks,
and its lnL (the wrapper's plain version on CPU tensors, and the route's
own FFT scheme in plain PyTorch) against the JAX package's fused Pallas
kernel in interpret mode with true-f32 products, one small shape per new
route, from the same ``ModelSpec`` and seeded numpy thetas.  Every
tolerance is stated where it is asserted.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.ops.pallas.lnpost_pallas import fused_lnl_supported as jax_fused_gate
from psfmc_tpu.ops.pallas.lnpost_pallas import make_fused_lnl_batch
from psfmc_tpu_torch.flagship import prior_draws
from psfmc_tpu_torch.models import build_posterior, spec_from_numpy
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
from psfmc_tpu_torch.ops.likelihood import gaussian_lnlike
from psfmc_tpu_torch.ops.pointsource import pointsource_image
from psfmc_tpu_torch.ops.kernels.sersic_render import render_sersics_plain
from test_torch_fused import FUSED_ENV
from test_torch_posterior import _graft_entry, _numpy_fields


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)


def _specs(shape, psf_shape):
    jspec = jax_spec(_graft_entry()._flagship_components(shape, psf_shape))
    return jspec, spec_from_numpy(**_numpy_fields(jspec))


@pytest.fixture
def fused_env(monkeypatch):
    for k, v in FUSED_ENV.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("shape,psf_shape,route", [
    ((96, 96), (48, 48), "fft"), ((98, 98), (48, 48), "fft"),
    ((74, 74), (36, 36), "padded"), ((94, 94), (48, 48), "cluster"),
    ((144, 144), (72, 72), "fft"), ((256, 256), (64, 64), "cluster"),
], ids=_ids)
def test_fused_gate_agrees_with_jax_at_the_flagship(shape, psf_shape, route):
    """The flagship at each shape passes both gates; the port's on
    conv_lnl's route (no size limit of its own there, as the JAX gate has
    none)."""
    jspec, carried = _specs(shape, psf_shape)
    assert FL.fused_route(shape) == CL.conv_route(shape) == route
    assert jax_fused_gate(jspec, "dft")
    assert FL.fused_lnl_supported(carried) == (True, "")


def test_fused_gate_refuses_512_naming_shared_memory():
    """512x512 took no route but the matmul-DFT one, whose three buffers no
    block holds, and the port refused it; it now takes the global route
    and both gates take it, as the fused posterior does.  What the port
    still refuses, naming shared memory, is a side of 1 whose three
    buffers no block holds (1x20000), the one shape left on the matmul-DFT
    route."""
    jspec, carried = _specs((512, 512), (32, 32))
    assert jax_fused_gate(jspec, "dft")
    assert FL.fused_route((512, 512)) == "global"
    assert FL.fused_lnl_supported(carried) == (True, "")
    assert build_posterior(carried, device="cpu", lnpost="fused").lnpost == "fused"
    thin = types.SimpleNamespace(shape=(1, 20000), comp_specs=carried.comp_specs)
    assert FL.fused_route(thin.shape) == "dft"
    ok, why = FL.fused_lnl_supported(thin)
    assert not ok and "shared memory" in why and "dft route" in why


# the cluster route's shapes (tests/test_torch_cluster.py's) and their sizes
CLUSTER_SHAPES = [((88, 88), 2), ((94, 94), 2), ((101, 101), 2), ((160, 180), 2),
                  ((196, 196), 2), ((200, 200), 2), ((128, 256), 2), ((256, 256), 4),
                  ((450, 450), 8)]


@pytest.mark.parametrize("shape,ranks", CLUSTER_SHAPES, ids=_ids)
def test_cluster_ranks_tile_the_rows(shape, ranks):
    """The ranks' transform rows tile ``[0, M_h)`` and their rendered image
    rows tile ``[0, H)``, each without overlap, every rank holding rows
    and rendering at most ``ceil(H / C)`` of them: no rank renders the
    whole image."""
    split = FL.cluster_rank_rows(shape)
    mh = CL.padded_shape(shape)[0]
    h = shape[0]
    assert len(split) == ranks == CL.cluster_size(shape)
    held = [r for (lo, hi), _ in split for r in range(lo, hi)]
    drawn = [r for _, (lo, hi) in split for r in range(lo, hi)]
    assert held == list(range(mh)) and drawn == list(range(h))
    assert all(hi > lo for (lo, hi), _ in split)
    assert max(hi - lo for _, (lo, hi) in split) == -(-h // ranks) < h
    assert FL.cluster_rank_rows((96, 96)) == FL.cluster_rank_rows((512, 512)) == []


def _route_scheme_lnl(params, sky, fky, kx, consts, route):
    """The lnL by the route's own FFT scheme in plain PyTorch: the render,
    then the packed pair at the image's sides (FFT route) or at the padded
    transform, folded back (padded and cluster routes)."""
    raw = render_sersics_plain(params, sky, consts.shape) + pointsource_image(fky, kx)
    scheme = CL.packed_fft_conv_plain if route == "fft" else CL.padded_fft_conv_plain
    conv, mvar = scheme(raw, consts)
    return gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var), consts.good)


@pytest.mark.parametrize("shape,psf_shape,route,walkers", [
    ((24, 20), (12, 10), "fft", 6),       # mixed radix: 24 = 3 x 2^3, 20 = 5 x 2^2
    ((26, 26), (12, 12), "padded", 6),    # a factor of 13: padded to 54x54
    ((88, 88), (24, 24), "cluster", 3),   # 180x180 over a cluster of 2
], ids=_ids)
def test_fused_lnl_matches_pallas_fused_on_each_route(fused_env, shape, psf_shape, route,
                                                     walkers):
    jspec, carried = _specs(shape, psf_shape)
    assert FL.fused_route(shape) == route
    constants = jax_posterior(jspec).constants
    lnl_jax = make_fused_lnl_batch(constants, jspec, jspec.comp_specs,
                                   float(jspec.mag_zeropoint), jnp.float32,
                                   interpret=True)
    th = prior_draws(carried, walkers, seed=21)
    th[1, 0] = np.nan  # a NaN theta: lnl exactly -inf
    want = np.asarray(lnl_jax(jnp.asarray(th, jnp.float32)))

    post = build_posterior(carried, device="cpu", dtype=torch.float32, lnpost="fused")
    thetas = post.as_thetas(th)
    args = (*post.render_inputs(thetas), *post.pointsource_inputs(thetas))
    before = dict(FL.fused_lnl.route_launches)
    got = FL.fused_lnl(*args, post.consts).numpy()
    assert FL.fused_lnl.route_launches == before  # the CPU runs the plain version
    scheme = _route_scheme_lnl(*args, post.consts, route).numpy()
    assert got[1] == want[1] == scheme[1] == -np.inf
    fin = np.isfinite(want)
    assert fin.sum() == walkers - 1
    for lnl in (got, scheme):
        assert np.array_equal(fin, np.isfinite(lnl))
        # float32, true-fp32 products on both sides: rtol 1e-5
        np.testing.assert_allclose(lnl[fin], want[fin], rtol=1e-5)


def test_fused_and_batched_agree_in_float64_at_256():
    """The flagship at 256x256 (the cluster route on the card) builds on the
    fused path, whose lnpost matches the batched path's to 1e-12."""
    _, carried = _specs((256, 256), (64, 64))
    th = prior_draws(carried, 4, seed=22)
    out = {mode: build_posterior(carried, device="cpu", dtype=torch.float64,
                                 lnpost=mode).log_posterior_batch(th)
           for mode in ("fused", "batched")}
    assert torch.isfinite(out["fused"]).all()
    torch.testing.assert_close(out["fused"], out["batched"], rtol=1e-12, atol=0.0)
