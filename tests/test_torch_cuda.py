"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without CUDA they skip.
This file imports neither ``jax`` nor ``psfmc_tpu``, so it runs on a
machine that has only PyTorch, without the suite's ``conftest.py``::

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""
import numpy as np
import pytest
import torch

from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
from psfmc_tpu_torch.ops.kernels import sersic_render as SR
from psfmc_tpu_torch.ops.pointsource import pointsource_image

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def flagship(cuda):
    spec = build_model_spec(flagship_components((64, 64), (32, 32)))
    return spec, build_posterior(spec, device=cuda)


def _same_nonfinite(got, want):
    return torch.equal(torch.isfinite(got), torch.isfinite(want)) and \
        torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.parametrize("tiled", [False, True])
def test_render_kernel_matches_plain(flagship, tiled):
    spec, post = flagship
    th = torch.as_tensor(prior_draws(spec, 30, seed=4), dtype=torch.float32,
                         device=post.device)
    params, sky = post.render_inputs(th)
    params, sky = params.contiguous(), sky.contiguous()
    fn = SR.render_sersics_tiled if tiled else SR.render_sersics
    before = fn.launches
    got = fn(params, sky, spec.shape)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = SR.render_sersics_plain(params, sky, spec.shape)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    rel = (got[fin] - want[fin]).abs() / want[fin].abs().clamp(min=1e-12)
    assert rel.max().item() <= 5e-6  # float32, same rounded op sequence


# (shape, PSF shape, point sources, route): the FFT route where both sizes
# are powers of two, the matmul-DFT route elsewhere
LIKELIHOOD_CASES = [
    ((128, 128), (64, 64), True, "fft"),
    ((64, 64), (32, 32), True, "fft"),
    ((64, 64), (32, 32), False, "fft"),
    ((64, 128), (32, 32), True, "fft"),  # non-square: two line lengths
    ((45, 37), (16, 16), True, "dft"),  # odd sizes: W2 = 19, ragged warps
    ((96, 96), (48, 48), True, "dft"),
]
LIKELIHOOD_IDS = ["128", "64", "64-no-ps", "64x128", "45x37", "96"]


def _likelihood_inputs(cuda, shape, psf_shape, point_sources, lnpost, seed):
    spec = build_model_spec(flagship_components(shape, psf_shape))
    post = build_posterior(spec, device=cuda, lnpost=lnpost)
    th = torch.as_tensor(prior_draws(spec, 30, seed=seed), dtype=torch.float32,
                         device=post.device)
    params, sky = post.render_inputs(th)
    fky, kx = post.pointsource_inputs(th)
    if not point_sources:
        fky, kx = fky[:, :0].contiguous(), kx[:, :0].contiguous()
    return post, params, sky, fky, kx


def _assert_launched_on(fn, route, before, routes_before):
    assert fn.launches == before + 1
    routes_before[route] += 1
    assert fn.route_launches == routes_before


@pytest.mark.parametrize("shape,psf_shape,point_sources,route",
                         LIKELIHOOD_CASES, ids=LIKELIHOOD_IDS)
def test_conv_lnl_kernel_matches_plain(cuda, shape, psf_shape, point_sources,
                                       route):
    post, params, sky, fky, kx = _likelihood_inputs(
        cuda, shape, psf_shape, point_sources, "batched", 5)
    raws = SR.render_sersics(params.contiguous(), sky.contiguous(), shape) \
        + pointsource_image(fky, kx)
    assert CL.conv_route(shape) == route
    before = CL.batched_conv_lnl.launches
    routes_before = dict(CL.batched_conv_lnl.route_launches)
    got = CL.batched_conv_lnl(raws, post.consts)
    torch.cuda.synchronize()
    _assert_launched_on(CL.batched_conv_lnl, route, before, routes_before)
    want = CL.batched_conv_lnl_plain(raws, post.consts)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    assert fin.sum().item() >= 15
    # float32, an FFT or FMA GEMMs of the kernel's own vs cuBLAS fp32:
    # rtol 2e-5 per walker
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)
    # the same bits on every launch (no atomics)
    assert torch.equal(got, CL.batched_conv_lnl(raws, post.consts))


def test_conv_lnl_fft_route_keeps_the_non_finite_walkers(cuda):
    """A NaN pixel, an infinite pixel and a pixel whose square overflows
    float32 give -inf on exactly those walkers, as the plain version."""
    post, params, sky, fky, kx = _likelihood_inputs(
        cuda, (64, 64), (32, 32), True, "batched", 9)
    raws = SR.render_sersics(params.contiguous(), sky.contiguous(), (64, 64)) \
        + pointsource_image(fky, kx)
    raws = torch.nan_to_num(raws, nan=0.1, posinf=0.1, neginf=0.1)
    raws[2, 5, 7] = float("nan")
    raws[11, 40, 3] = float("inf")
    raws[17, 63, 63] = 1e30
    raws[23] = 0.0  # the scale falls back to 1
    got = CL.batched_conv_lnl(raws, post.consts)
    want = CL.batched_conv_lnl_plain(raws, post.consts)
    assert _same_nonfinite(got, want)
    assert {2, 11, 17} <= set(torch.isinf(got).nonzero().flatten().tolist())
    assert torch.isfinite(got[23])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)


@pytest.mark.parametrize("shape", [(2, 2), (4, 8), (8, 4), (16, 16), (32, 512),
                                   (512, 32), (256, 64), (64, 256)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_conv_lnl_fft_route_at_every_depth_of_pass(cuda, shape):
    """Line lengths from 2 to 512: one to three register passes of one to
    four stages each, and a twiddle table longer than the shorter line."""
    h, w = shape
    rng = np.random.RandomState(h * 1000 + w)
    ph, pw = max(h // 2, 1), max(w // 2, 1)
    yy, xx = np.mgrid[0:ph, 0:pw]
    psf = np.exp(-((yy - ph // 2) ** 2 + (xx - pw // 2) ** 2) / 4.5) + 1e-3
    psf /= psf.sum()

    def spectrum(img):  # centre-padded, as pad_and_rfft_image does
        pad = np.zeros(shape)
        oy, ox = h // 2 - ph // 2, w // 2 - pw // 2
        pad[oy:oy + ph, ox:ox + pw] = img
        return np.fft.rfft2(pad)

    good = rng.rand(h, w) > 0.05
    good[0, 0] = True
    consts = CL.make_conv_lnl_consts(
        spectrum(psf), spectrum(np.full_like(psf, 1e-8)),
        0.1 + 0.01 * rng.randn(h, w), np.full(shape, 2.5e-5), good, cuda)
    assert CL.conv_route(shape) == "fft"
    raws = torch.as_tensor((0.05 + np.abs(rng.randn(40, h, w)) * 0.1)
                           .astype(np.float32), device=cuda)
    raws[:, h // 2, w // 2] += 5.0  # a bright point source
    routes_before = dict(CL.batched_conv_lnl.route_launches)
    got = CL.batched_conv_lnl(raws, consts)
    torch.cuda.synchronize()
    routes_before["fft"] += 1
    assert CL.batched_conv_lnl.route_launches == routes_before
    want = CL.batched_conv_lnl_plain(raws, consts)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)


@pytest.mark.parametrize("shape,psf_shape,point_sources,route",
                         LIKELIHOOD_CASES, ids=LIKELIHOOD_IDS)
def test_fused_lnl_kernel_matches_plain(cuda, shape, psf_shape, point_sources,
                                        route):
    post, params, sky, fky, kx = _likelihood_inputs(
        cuda, shape, psf_shape, point_sources, "fused", 7)
    before = FL.fused_lnl.launches
    routes_before = dict(FL.fused_lnl.route_launches)
    got = FL.fused_lnl(params, sky, fky, kx, post.consts)
    torch.cuda.synchronize()
    _assert_launched_on(FL.fused_lnl, route, before, routes_before)
    want = FL.fused_lnl_plain(params, sky, fky, kx, post.consts)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    assert fin.sum().item() >= 15
    # float32, an FFT or FMA products in the kernel's order vs cuBLAS
    # fp32: rtol 2e-5 per walker, as for conv_lnl
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)
    assert torch.equal(got, FL.fused_lnl(params, sky, fky, kx, post.consts))


@pytest.mark.parametrize("kernel", ["conv_lnl", "fused_lnl"])
def test_tall_walker_takes_the_fft_route(cuda, kernel):
    """2048x8 fits a block only on the FFT route (155,648 B; the three
    buffers of the matmul-DFT route would need 245,760 B), and the fused
    kernel's gate measures the route the shape takes.  The kernel is held
    to the plain version in float64: over 2048-point lines the float32
    plain version's matrix products are themselves further than the
    tolerance from it."""
    shape = (2048, 8)
    post, params, sky, fky, kx = _likelihood_inputs(
        cuda, shape, (16, 4), True, "fused", 7)
    assert CL.conv_route(shape) == "fft"
    assert FL.fused_lnl_supported(post.spec)[0]
    assert FL.fused_lnl_smem_bytes(shape, 2, 1) > FL.FUSED_SMEM_LIMIT
    ref = build_posterior(post.spec, device="cpu", dtype=torch.float64,
                          lnpost="fused")
    if kernel == "conv_lnl":
        raws = SR.render_sersics(params.contiguous(), sky.contiguous(), shape) \
            + pointsource_image(fky, kx)
        fn, plain, args = CL.batched_conv_lnl, CL.batched_conv_lnl_plain, (raws,)
    else:
        fn, plain, args = FL.fused_lnl, FL.fused_lnl_plain, (params, sky, fky, kx)
    want = plain(*(t.double().cpu() for t in args), ref.consts)
    before = fn.launches
    routes_before = dict(fn.route_launches)
    got = fn(*args, post.consts)
    torch.cuda.synchronize()
    _assert_launched_on(fn, "fft", before, routes_before)
    # the non-finite walkers are float32's own: those of the plain version
    assert _same_nonfinite(got, plain(*args, post.consts))
    assert torch.equal(got, fn(*args, post.consts))
    got = got.double().cpu()
    fin = torch.isfinite(got) & torch.isfinite(want)
    assert fin.sum().item() >= 15
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)


def test_kernel_wrappers_do_not_fall_back(cuda):
    with pytest.raises(TypeError, match="float32"):
        SR.render_sersics(torch.zeros((2, 1, 9), dtype=torch.float64, device=cuda),
                          torch.zeros(2, dtype=torch.float64, device=cuda), (8, 8))


def test_fused_lnl_refuses_a_walker_beyond_shared_memory(cuda):
    """A 144x144 walker needs more shared memory than a block has: the
    launch is refused, and the wrapper raises instead of returning an
    unwritten output."""
    spec = build_model_spec(flagship_components((144, 144), (32, 32)))
    post = build_posterior(spec, device=cuda, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, 4, seed=8), dtype=torch.float32,
                         device=post.device)
    params, sky = post.render_inputs(th)
    fky, kx = post.pointsource_inputs(th)
    before = FL.fused_lnl.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        FL.fused_lnl(params, sky, fky, kx, post.consts)
    assert FL.fused_lnl.launches == before


def test_kernel_posterior_matches_cpu_float64(flagship):
    spec, post = flagship
    th = prior_draws(spec, 16, seed=6)
    got = post.log_posterior_batch(th).double().cpu().numpy()
    ref = build_posterior(spec, device="cpu", dtype=torch.float64)
    want = ref.log_posterior_batch(th).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and fin.sum() >= 8
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
