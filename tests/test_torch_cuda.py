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


def _synthetic_rows(seed, batch, count, shape, device):
    """(B, S, 9) packed rows, (B,) sky: indices 0.5-8, radii 0.5-60 px,
    walker 1 NaN, walker 2 centred on a pixel (both clamps)."""
    rng = np.random.RandomState(seed)
    h, w = shape
    index = rng.uniform(0.5, 8.0, (batch, count))
    reff = rng.uniform(0.5, 60.0, (batch, count))
    reff_b = reff * rng.uniform(0.2, 1.0, (batch, count))
    angle = rng.uniform(0.0, np.pi, (batch, count))
    p = np.zeros((batch, count, 9))
    p[..., 0] = rng.uniform(0, w, (batch, count))
    p[..., 1] = rng.uniform(0, h, (batch, count))
    p[..., 2], p[..., 3] = np.cos(angle) / reff, np.sin(angle) / reff
    p[..., 4], p[..., 5] = -np.sin(angle) / reff_b, np.cos(angle) / reff_b
    p[..., 6] = 2.0 * index - 1.0 / 3.0
    p[..., 7] = 0.5 / index
    p[..., 8] = rng.uniform(0.01, 2.0, (batch, count))
    if count:
        p[1] = np.nan
        p[2, 0, :2] = (3.0, 2.0)
    sky = rng.uniform(0.0, 0.1, batch)
    return (torch.as_tensor(p, dtype=torch.float32, device=device),
            torch.as_tensor(sky, dtype=torch.float32, device=device))


def _assert_render_matches_plain(got, params, sky, shape):
    want = SR.render_sersics_plain(params, sky, shape)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    rel = (got[fin] - want[fin]).abs() / want[fin].abs().clamp(min=1e-12)
    assert rel.max().item() <= 5e-6  # the gate of chip_smoke.py
    assert torch.equal(got[fin], want[fin])  # the same rounded operations
    # no further from the float64 render than the float32 plain version
    truth = SR.render_sersics_plain(params.double(), sky.double(), shape)
    fin &= torch.isfinite(truth)

    def err(img):
        return ((img.double() - truth)[fin].abs()
                / truth[fin].abs().clamp(min=1e-300)).max().item()

    assert err(got) <= err(want)


def test_profile_log_and_division_are_the_library_functions(cuda, tmp_path):
    """``csrc/sersic_profile.cuh`` writes out logf and the division for the
    operands its clamps leave; they must give the library's bits: the
    logarithm for every float from 1e-30 up, +inf and every NaN, the
    quotient of every ``n >= 2**-100`` (below that its remainder is
    subnormal), and ``1 + n / d`` wherever the quotient is finite (an
    overflowed one stays non-finite)."""
    import ctypes
    import os
    import subprocess

    from psfmc_tpu_torch.ops.kernels import _build

    lib = str(tmp_path / "sersic_profile_check.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sersic_profile_check.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC,
                    "-o", lib, src], check=True, capture_output=True)
    check = ctypes.CDLL(lib).sersic_profile_check
    check.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_ulonglong,
                      ctypes.c_void_p]
    check.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * 4)()
    lo = int(np.float32(1e-30).view(np.uint32))
    assert check(lo, 0x7FFFFFFF, 1 << 32, ctypes.addressof(counts)) == 0
    assert list(counts) == [0, 0, 0, 0]


# 128-bit stores (width a multiple of four), the scalar tail (45x37), a
# thread walking many runs of a row (8x2048), rows shorter than a warp
@pytest.mark.parametrize("shape", [(128, 128), (64, 128), (45, 37), (8, 2048),
                                   (2048, 8)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("count", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("tile", [1, 5])
def test_render_kernel_shapes_and_counts(cuda, shape, count, tile):
    """1 to 3 Sersics are unrolled in the kernel, any other count loops."""
    params, sky = _synthetic_rows(41 + count, 10, count, shape, cuda)
    fn = SR.render_sersics if tile == 1 else SR.render_sersics_tiled
    kwargs = {} if tile == 1 else {"tile": tile}
    before = fn.launches
    got = fn(params, sky, shape, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert count == 0 or torch.isnan(got[1]).all()
    _assert_render_matches_plain(got, params, sky, shape)


@pytest.mark.parametrize("geometry", [(32, 4, 1, 1), (32, 8, 1, 3), (8, 4, 8, 2),
                                      (1, 1, 1, 1), (5, 3, 2, 7)])
def test_render_kernel_any_geometry_gives_the_same_image(cuda, geometry):
    """Blocks that walk several strips, walkers several at a time, and
    shapes of block that are no power of two: the same bits."""
    shape = (45, 37)
    params, sky = _synthetic_rows(47, 7, 2, shape, cuda)
    want = SR.render_sersics(params, sky, shape)
    got = SR._launch(params, sky, shape, 3, geometry)
    torch.cuda.synchronize()
    assert torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0))


def test_render_kernel_refuses_a_block_beyond_its_limit(cuda):
    params, sky = _synthetic_rows(48, 4, 2, (16, 16), cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        SR._launch(params, sky, (16, 16), 1, (32, 16, 1, 1))  # 512 threads


def test_render_tiled_raises_on_the_card_too(cuda):
    params, sky = _synthetic_rows(49, 6, 1, (8, 8), cuda)
    before = SR.render_sersics_tiled.launches
    with pytest.raises(ValueError, match="does not divide"):
        SR.render_sersics_tiled(params, sky, (8, 8), tile=4)
    assert SR.render_sersics_tiled.launches == before


# shape, PSF, point sources, conv_lnl's route, the fused kernel's route
# (the same rule)
LIKELIHOOD_CASES = [
    ((128, 128), (64, 64), True, "fft", "fft"),
    ((64, 64), (32, 32), True, "fft", "fft"),
    ((64, 64), (32, 32), False, "fft", "fft"),
    ((64, 128), (32, 32), True, "fft", "fft"),  # non-square: two line lengths
    # odd sizes (W2 = 19, ragged warps): the padded route (90x80)
    ((45, 37), (16, 16), True, "padded", "padded"),
    # 3 x 2^5: the FFT route's mixed-radix geometry
    ((96, 96), (48, 48), True, "fft", "fft"),
    ((100, 100), (50, 50), True, "fft", "fft"),  # 5^2 x 2^2
    ((98, 98), (48, 48), True, "fft", "fft"),  # 7^2 x 2: radix-7 stages
    ((74, 74), (36, 36), True, "padded", "padded"),  # 2 x 37: padded to 150x150
    # 2 x 47: 192x192 fits no block but a cluster of 2 blocks
    ((94, 94), (48, 48), True, "cluster", "cluster"),
]
LIKELIHOOD_IDS = ["128", "64", "64-no-ps", "64x128", "45x37", "96", "100", "98",
                  "74", "94"]
# the fused kernel also on the cluster route's other sizes: 160x180 (2
# blocks, no padded side) and 256x256 (4 blocks)
FUSED_CASES = LIKELIHOOD_CASES + [
    ((160, 180), (64, 64), True, "cluster", "cluster"),
    ((256, 256), (64, 64), True, "cluster", "cluster"),
]
FUSED_IDS = LIKELIHOOD_IDS + ["160x180", "256"]


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


@pytest.mark.parametrize("shape,psf_shape,point_sources,route,fused_route",
                         LIKELIHOOD_CASES, ids=LIKELIHOOD_IDS)
def test_conv_lnl_kernel_matches_plain(cuda, shape, psf_shape, point_sources,
                                       route, fused_route):
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


MIXED_CASES = [((96, 96), (48, 48)), ((100, 100), (50, 50)),
               ((96, 128), (48, 64)), ((144, 144), (72, 72)),
               ((98, 98), (48, 48)), ((112, 140), (56, 64))]
MIXED_IDS = ["96", "100", "96x128", "144", "98", "112x140"]


@pytest.mark.parametrize("shape,psf_shape", MIXED_CASES, ids=MIXED_IDS)
def test_conv_lnl_mixed_radix_matches_float64(cuda, shape, psf_shape):
    """conv_lnl on the mixed-radix geometry of the FFT route at 125
    walkers: one launch on the ``"fft"`` route per call (counted at its
    shape), per walker within 2e-5 of the float64 plain version, a NaN
    and an infinite walker -inf as in the float32 plain version, and the
    same bits on every launch."""
    spec = build_model_spec(flagship_components(shape, psf_shape))
    post = build_posterior(spec, device=cuda, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, 125, seed=8), dtype=torch.float32,
                         device=cuda)
    raws = post.raw_and_ps(th)[0].contiguous()
    raws[3, 5, 7] = float("nan")
    raws[40, 20, 3] = float("inf")
    assert CL.conv_route(shape) == "fft" and post.consts.fft_layout.numel() > 0
    before = CL.batched_conv_lnl.launches
    routes = dict(CL.batched_conv_lnl.route_launches)
    at_shape = CL.batched_conv_lnl.shape_launches.get(("fft", tuple(shape)), 0)
    got = CL.batched_conv_lnl(raws, post.consts)
    torch.cuda.synchronize()
    _assert_launched_on(CL.batched_conv_lnl, "fft", before, routes)
    assert CL.batched_conv_lnl.shape_launches[("fft", tuple(shape))] == at_shape + 1
    assert _same_nonfinite(got, CL.batched_conv_lnl_plain(raws, post.consts))
    assert torch.isinf(got[3]) and torch.isinf(got[40])
    c64 = build_posterior(spec, device="cpu", dtype=torch.float64,
                          lnpost="batched").consts
    want = CL.batched_conv_lnl_plain(raws.double().cpu(), c64).to(cuda)
    fin = torch.isfinite(want)
    assert fin.sum().item() >= 120
    torch.testing.assert_close(got[fin].double(), want[fin], rtol=2e-5, atol=0.0)
    assert torch.equal(got, CL.batched_conv_lnl(raws, post.consts))


def _synthetic_consts(shape, device, seed):
    """conv_lnl's constants of a Gaussian PSF half the image's size
    (centre-padded, as ``pad_and_rfft_image`` does), a 5% mask and a flat
    observation, with 40 walkers of noise plus a bright point source."""
    h, w = shape
    rng = np.random.RandomState(seed)
    ph, pw = max(h // 2, 1), max(w // 2, 1)
    yy, xx = np.mgrid[0:ph, 0:pw]
    psf = np.exp(-((yy - ph // 2) ** 2 + (xx - pw // 2) ** 2) / 4.5) + 1e-3
    psf /= psf.sum()

    def spectrum(img):
        pad = np.zeros(shape)
        oy, ox = h // 2 - ph // 2, w // 2 - pw // 2
        pad[oy:oy + ph, ox:ox + pw] = img
        return np.fft.rfft2(pad)

    good = rng.rand(h, w) > 0.05
    good[0, 0] = True
    args = (spectrum(psf), spectrum(np.full_like(psf, 1e-8)),
            0.1 + 0.01 * rng.randn(h, w), np.full(shape, 2.5e-5), good)
    raws = (0.05 + np.abs(rng.randn(40, h, w)) * 0.1).astype(np.float32)
    raws[:, h // 2, w // 2] += 5.0
    return (CL.make_conv_lnl_consts(*args, device),
            CL.make_conv_lnl_consts(*args, "cpu", torch.float64),
            torch.as_tensor(raws, device=device))


@pytest.mark.parametrize("shape", [(2, 2), (4, 8), (8, 4), (16, 16), (32, 512),
                                   (512, 32), (256, 64), (64, 256),
                                   (6, 10), (12, 48), (54, 50), (486, 2),
                                   (24, 20), (250, 30), (96, 128),
                                   (14, 98), (42, 56), (490, 14)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_conv_lnl_fft_route_at_every_depth_of_pass(cuda, shape):
    """Line lengths from 2 to 512: one to three register passes of one to
    four stages each, and a twiddle table longer than the shorter line;
    then the mixed-radix geometry: every pass the plan makes (a radix-3,
    -5 or -7 stage alone or with one or two radix-2 stages, one to four
    radix-2 stages), up to five passes a line (486 = 2 x 3^5); the radix-7
    passes alone (0x70: 98, 42, 490) and with a radix-2 stage (0x71: 14,
    98, 56)."""
    consts, _, raws = _synthetic_consts(shape, cuda, shape[0] * 1000 + shape[1])
    assert CL.conv_route(shape) == "fft"
    routes_before = dict(CL.batched_conv_lnl.route_launches)
    got = CL.batched_conv_lnl(raws, consts)
    torch.cuda.synchronize()
    routes_before["fft"] += 1
    assert CL.batched_conv_lnl.route_launches == routes_before
    want = CL.batched_conv_lnl_plain(raws, consts)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)


@pytest.mark.parametrize("shape,psf_shape,point_sources,conv_route,route",
                         FUSED_CASES, ids=FUSED_IDS)
def test_fused_lnl_kernel_matches_plain(cuda, shape, psf_shape, point_sources,
                                        conv_route, route):
    post, params, sky, fky, kx = _likelihood_inputs(
        cuda, shape, psf_shape, point_sources, "fused", 7)
    assert FL.fused_route(shape) == route
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
    """A 1x20000 walker takes the matmul-DFT route (a side of 1: the one
    shape left there since 512x512 took the global route), whose three
    buffers need more shared memory than a block has: the launch is
    refused, and the wrapper raises instead of returning an unwritten
    output."""
    assert FL.fused_route((1, 20000)) == "dft"
    assert FL.fused_lnl_smem_bytes((1, 20000), 2, 1) > FL.FUSED_SMEM_LIMIT
    spec = build_model_spec(flagship_components((1, 20000), (1, 32)))
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


# -- the sampler's phase as CUDA graph replays -------------------------------

COUNTED = (SR.render_sersics, CL.batched_conv_lnl, FL.fused_lnl)


def _same_bits(x, y):
    x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
    torch.testing.assert_close(x, y, rtol=0.0, atol=0.0, equal_nan=True)


def _assert_same_state(a, b, chain_from=0):
    """Positions, lnprob, accept counts, accumulators and their count,
    moments, the generator's state and the chain: bit for bit."""
    sa, sb = a.state, b.state
    for x, y in ((sa.positions, sb.positions), (sa.log_prob, sb.log_prob),
                 (sa.naccept, sb.naccept), (sa.accum_count, sb.accum_count),
                 (a.generator.get_state(), b.generator.get_state()),
                 (a.chain[:, chain_from:], b.chain),
                 (a.lnprobability[:, chain_from:], b.lnprobability)):
        _same_bits(x, y)
    assert sorted(sa.accum) == sorted(sb.accum) and sa.accum
    for k in sa.accum:
        _same_bits(sa.accum[k], sb.accum[k])
    for k in sa.moments or {}:
        _same_bits(sa.moments[k], sb.moments[k])


def _phase(post, spec, moves, eager, walkers=40):
    """4 burn + 6 retained steps, thin 2, moments; the launches made."""
    import contextlib

    from psfmc_tpu_torch.sampler import EnsembleSampler
    from psfmc_tpu_torch.sampler.ensemble import _eager

    s = EnsembleSampler(walkers, spec.num_params, post, seed=3, moves=moves,
                        thin=2, track_moments=True)
    before = [f.launches for f in COUNTED]
    with _eager(s) if eager else contextlib.nullcontext():
        s.init_state(prior_draws(spec, walkers, seed=3))
        s.run_burn(4)
        s.reset()
        s.run_sampling(6)
    torch.cuda.synchronize()
    return s, [f.launches - n for f, n in zip(COUNTED, before)]


@pytest.mark.parametrize("lnpost", ["batched", "fused"])
@pytest.mark.parametrize("moves", ["stretch", "de", "mixed"])
def test_graphed_phase_is_bit_identical_to_eager(cuda, lnpost, moves):
    """Ten steps from one state as graph replays and through the private
    eager loop; the counters read launches executed: the same for both,
    and exactly one per kernel launch of the ten steps."""
    spec = build_model_spec(flagship_components((64, 64), (32, 32)))
    post = build_posterior(spec, device=cuda, lnpost=lnpost)
    graphed, g_launches = _phase(post, spec, moves, eager=False)
    eager, e_launches = _phase(post, spec, moves, eager=True)
    assert graphed.graph_replays == 10 and eager.graph_replays == 0
    _assert_same_state(graphed, eager)
    assert graphed.chain.shape == (40, 3, spec.num_params)
    assert int(graphed.state.moments["n"]) == 6 * 40
    # init: one launch; a step: one per half; a retained step: one render
    # for the image means
    want = ([1 + 20 + 6, 1 + 20, 0] if lnpost == "batched" else [6, 0, 1 + 20])
    assert g_launches == e_launches == want


def test_graphed_resume_is_bit_identical(flagship):
    """A checkpoint taken mid-run, restored into a new sampler and into the
    sampler whose graphs are already captured, replays bit-identically."""
    from psfmc_tpu_torch.sampler import EnsembleSampler

    spec, post = flagship
    s = EnsembleSampler(40, spec.num_params, post, seed=4, moves="mixed")
    s.init_state(prior_draws(spec, 40, seed=4))
    s.run_burn(3)
    s.reset()
    s.run_sampling(4)
    payload = s.checkpoint_payload()
    s.run_sampling(4)
    fresh = EnsembleSampler(40, spec.num_params, post, seed=99, moves="mixed")
    fresh.restore_state(payload)
    fresh.run_sampling(4)
    assert fresh.graph_replays == 4
    _assert_same_state(s, fresh, chain_from=4)
    replays = s.graph_replays
    s.restore_state(payload)  # in place, under the captured graphs
    s._chain, s._lnprob = s.chain[:, :4], s.lnprobability[:, :4]
    s.run_sampling(4)
    assert s.graph_replays == replays + 4
    _assert_same_state(s, fresh, chain_from=4)


def test_a_capture_counts_nothing_and_moves_nothing(flagship):
    from psfmc_tpu_torch.sampler import EnsembleSampler

    spec, post = flagship
    s = EnsembleSampler(40, spec.num_params, post, seed=5, moves="de")
    s.init_state(prior_draws(spec, 40, seed=5))
    torch.cuda.synchronize()
    before = [f.launches for f in COUNTED]
    pos, rng = s.state.positions.clone(), s.generator.get_state()
    graph = s._capture("burn")
    torch.cuda.synchronize()
    assert [f.launches for f in COUNTED] == before
    assert torch.equal(s.state.positions, pos)
    assert torch.equal(s.generator.get_state(), rng)
    assert [f for f, *_ in graph.launches] == [SR.render_sersics, CL.batched_conv_lnl] * 2
    graph.replay()
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(COUNTED, before)] == [2, 2, 0]
    assert not torch.equal(s.generator.get_state(), rng)


def test_a_failing_capture_raises_and_nothing_falls_back(flagship):
    """A step that copies from the host cannot be captured: the phase
    raises, and neither the state nor the counts moved."""
    from psfmc_tpu_torch.sampler import EnsembleSampler

    spec, post = flagship

    class HostCopy:
        device, dtype = post.device, post.dtype

        def log_posterior_batch(self, thetas):
            host = torch.as_tensor(np.zeros(1, np.float32), device=self.device)
            return post.log_posterior_batch(thetas) + host

    s = EnsembleSampler(40, spec.num_params, HostCopy(), seed=6)
    s.init_state(prior_draws(spec, 40, seed=6))
    torch.cuda.synchronize()
    pos = s.state.positions.clone()
    before = [f.launches for f in COUNTED]
    with pytest.raises(RuntimeError):
        s.run_burn(2)
    torch.cuda.synchronize()
    assert s.graph_replays == 0 and not s._graphs
    assert torch.equal(s.state.positions, pos)
    assert [f.launches for f in COUNTED] == before


# -- the general likelihood path ----------------------------------------------

GENERAL = {
    "two-psfs": dict(),
    "conv-pad": dict(conv_pad=8),
    "oversample": dict(render_oversample=4, psf_oversample=2),
    "student": dict(likelihood="student"),
    "poisson": dict(likelihood="poisson", counts=True, noise_scale=False),
}


def _general(device, variant, shape=(64, 64), psf_shape=(32, 32), **kw):
    from psfmc_tpu_torch.flagship import general_components

    spec = build_model_spec(general_components(shape, psf_shape,
                                               **dict(GENERAL[variant], **kw)))
    return spec, build_posterior(spec, device=device, lnpost="general")


def _general_thetas(spec, n, seed):
    """Prior draws; the PSF index on and beside its .5 points."""
    th = prior_draws(spec, n, seed=seed)
    if "PSF_Index" in spec.param_names:
        off = next(s.offset for s in spec.slots if s.name == "PSF_Index")
        th[:, off] = np.resize([0.5, 1.5, 0.49, 1.0, 0.0, -0.4], n)
    return th


@pytest.mark.parametrize("variant", sorted(GENERAL))
def test_general_posterior_matches_cpu_float64(cuda, variant):
    """lnpost (rtol 1e-4, with a floor of 1e-5 of the batch's largest
    |lnpost|), per-walker images and ensemble means (1e-4 of their
    peak) on the card against the CPU's float64 general path; one render
    launch per evaluation."""
    spec, post = _general(cuda, variant)
    th = _general_thetas(spec, 16, seed=6)
    before = SR.render_sersics.launches
    got = post.log_posterior_batch(th).double().cpu().numpy()
    torch.cuda.synchronize()
    assert SR.render_sersics.launches == before + 1
    ref = build_posterior(spec, device="cpu", dtype=torch.float64, lnpost="general")
    want = ref.log_posterior_batch(th).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and fin.sum() >= 8
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                               atol=1e-5 * np.abs(want[fin]).max())
    good = th[fin]
    for fn in ("images_batch", "ensemble_carry_means"):
        imgs, refs = getattr(post, fn)(good), getattr(ref, fn)(good)
        for k, v in refs.items():
            np.testing.assert_allclose(imgs[k].double().cpu().numpy(), v.numpy(),
                                       rtol=0, atol=1e-4 * v.abs().max().item(),
                                       err_msg=f"{fn}.{k}")


@pytest.mark.parametrize("pad", [4, 8])
def test_padded_grid_render_matches_plain(cuda, pad):
    """The render kernel on the padded grid, each Sersic's center shifted
    by +pad: the plain version's bits; and the JAX package's formulation
    (the grid minus pad, the center as it is) on the same float32
    scalars within 1e-5 at 99.9% of the pixels where both are finite (the
    shifted center rounds in float32: a pixel beside a steep center may
    differ by up to about 3e-3)."""
    from psfmc_tpu_torch.ops.sersic import sersic_profile_core

    spec, post = _general(cuda, "conv-pad", (128, 128), (64, 64), conv_pad=pad)
    th = post.as_thetas(_general_thetas(spec, 30, seed=8))
    params, sky, sersics = post._render_parts(th)
    got = SR.render_sersics(params.contiguous(), sky.contiguous(), post.render_shape)
    _assert_render_matches_plain(got, params, sky, post.render_shape)
    hr, wr = post.render_shape
    xg = torch.arange(wr, dtype=torch.float32, device=cuda) - pad
    yg = (torch.arange(hr, dtype=torch.float32, device=cuda) - pad)[:, None]
    want = sky[:, None, None].expand(-1, hr, wr)
    for _xy, scalars in sersics:
        q = [t[:, None, None] for t in scalars]
        want = want + sersic_profile_core(xg - q[0], yg - q[1], *q[2:])
    fin = torch.isfinite(want) & torch.isfinite(got)
    assert fin.double().mean().item() >= 0.95
    rel = ((got[fin] - want[fin]).abs() / want[fin].abs()).double().cpu()
    assert torch.quantile(rel[:2**24], 0.999).item() <= 1e-5


@pytest.mark.parametrize("variant", ["two-psfs", "oversample"])
@pytest.mark.parametrize("moves", ["stretch", "mixed"])
def test_general_graphed_phase_is_bit_identical_to_eager(cuda, variant, moves):
    """The general path's ten steps as graph replays and eagerly: the same
    state bit for bit; the render kernel's launches exact (init, one per
    half-step, one per retained step for the image means)."""
    spec, post = _general(cuda, variant)
    graphed, g_launches = _phase(post, spec, moves, eager=False)
    eager, e_launches = _phase(post, spec, moves, eager=True)
    assert graphed.graph_replays == 10 and eager.graph_replays == 0
    _assert_same_state(graphed, eager)
    assert g_launches == e_launches == [1 + 20 + 6, 0, 0]


def test_rejuvenation_between_graphed_segments_is_bit_identical(cuda):
    """A walker stranded between two burn segments is moved by
    ``rejuvenate_stuck``, whose writes land in the buffers the captured
    graphs read: the graphed phase stays bit-identical to the eager one."""
    import contextlib

    from psfmc_tpu_torch.sampler import EnsembleSampler
    from psfmc_tpu_torch.sampler.ensemble import _eager

    spec, post = _general(cuda, "two-psfs")
    mag = next(s.offset for s in spec.slots if s.name == "3_Sersic_mag")
    runs = []
    for eager in (False, True):
        s = EnsembleSampler(40, spec.num_params, post, seed=7)
        with _eager(s) if eager else contextlib.nullcontext():
            s.init_state(prior_draws(spec, 40, seed=7))
            s.run_burn(3)
            pos = s.state.positions.cpu().numpy()
            pos[5, mag] = 40.0  # outside its prior: lnp -inf
            s._reseat(pos)
            assert s.rejuvenate_stuck(random_state=0) == 1
            assert torch.isfinite(s.state.log_prob).all()
            s.run_burn(3)
            s.reset()
            s.run_sampling(4)
        torch.cuda.synchronize()
        runs.append(s)
    assert runs[0].graph_replays == 10 and runs[1].graph_replays == 0
    _assert_same_state(*runs)


# -- the render family ---------------------------------------------------------

FAMILY_SHAPED = ("flagship", "moffat", "king", "ferrer", "nuker", "edgedisk",
                 "sersic-modes", "offset-tie", "oversample")


def _family(device, variant, dtype=torch.float32):
    from psfmc_tpu_torch.flagship import family_components, family_lnpost

    spec = build_model_spec(family_components((64, 64), (32, 32), variant))
    return spec, build_posterior(spec, device=device, dtype=dtype,
                                 lnpost=family_lnpost(variant))


@pytest.mark.parametrize("variant", ["flagship", "oversample", "offset-tie", "king"])
def test_family_graphed_phase_is_bit_identical_to_eager(cuda, variant):
    """The family flagship's ten steps (and three variants') as graph
    replays and eagerly: the same state bit for bit, and the render and
    conv_lnl kernels' launches exact; the shaped profiles run inside the
    captured graph as plain PyTorch."""
    spec, post = _family(cuda, variant)
    assert post.lnpost == "batched"
    graphed, g_launches = _phase(post, spec, "stretch", eager=False)
    eager, e_launches = _phase(post, spec, "stretch", eager=True)
    assert graphed.graph_replays == 10 and eager.graph_replays == 0
    _assert_same_state(graphed, eager)
    assert g_launches == e_launches == [1 + 20 + 6, 1 + 20, 0]


@pytest.mark.parametrize("variant", FAMILY_SHAPED)
def test_shaped_render_on_the_card_matches_the_cpu(cuda, variant):
    """Each profile the render kernel does not draw, as the posterior
    renders it on the full grid: float32 on the card against float32 and
    float64 on the CPU, on the same walkers; the same non-finite pixels,
    and the card no further from float64 than 1e-4 relative (with a floor
    of 1e-6 of the image's peak)."""
    _, post = _family(cuda, variant)
    spec, ref32 = _family("cpu", variant)
    _, ref64 = _family("cpu", variant, torch.float64)
    th = prior_draws(spec, 24, seed=9)
    outs = []
    for p in (post, ref32, ref64):
        t = p.as_thetas(th)
        outs.append([coarse(p.xg_r, p.yg_r).double().cpu()
                     for _xy, coarse, _fine in p._profiles(t)])
    assert outs[0]
    for card, cpu32, cpu64 in zip(*outs):
        assert torch.equal(torch.isfinite(card), torch.isfinite(cpu64))
        assert torch.equal(torch.isfinite(cpu32), torch.isfinite(cpu64))
        fin = torch.isfinite(cpu64)
        peak = cpu64[fin].abs().max().item()
        torch.testing.assert_close(card[fin], cpu64[fin], rtol=1e-4, atol=1e-6 * peak)


def test_every_prior_family_on_the_card_and_in_one_graph(cuda):
    """Every case of ``chip_smoke.PRIOR_CASES`` (all 105 aliases) and the
    vector cases in float64 and float32 on the card against the CPU, then
    one captured graph of them all, replayed bit for bit against the eager
    call; a host-callback prior is refused at ``build_posterior``."""
    import chip_smoke

    chip_smoke.prior_family_phase(device=cuda)


def test_host_callback_prior_is_refused_on_the_card(cuda):
    from psfmc_tpu_torch import distributions as D
    from psfmc_tpu_torch.flagship import priors_components

    comps = priors_components((32, 32), (16, 16))
    comps[2].xy = D.Skellam(mu1=np.array([16.0, 16.0]), mu2=np.array([1.0, 2.0]))
    spec = build_model_spec(comps)
    with pytest.raises(NotImplementedError, match="Skellam"):
        build_posterior(spec, device=cuda)
    assert build_posterior(spec, device="cpu").lnpost == "batched"


@pytest.mark.parametrize("variant", ["flagship", "stress"])
def test_priors_graphed_phase_is_bit_identical_to_eager(cuda, variant):
    """The priors flagship and its stress set (Tukey-lambda bisection,
    noncentral t quadrature, noncentral chi-square mixture, tables,
    per-element tables, a discrete family) inside the captured step: ten
    steps as graph replays and eagerly, the same state bit for bit."""
    from psfmc_tpu_torch.flagship import priors_components

    spec = build_model_spec(priors_components((64, 64), (32, 32), variant))
    post = build_posterior(spec, device=cuda)
    assert post.lnpost == "batched"
    graphed, g_launches = _phase(post, spec, "stretch", eager=False)
    eager, e_launches = _phase(post, spec, "stretch", eager=True)
    assert graphed.graph_replays == 10 and eager.graph_replays == 0
    _assert_same_state(graphed, eager)
    assert g_launches == e_launches == [1 + 20 + 6, 1 + 20, 0]


def _joint(device, variant="flagship", band1=(94, 94)):
    """The joint flagship at 64x64 and ``band1``: by default 94x94, a
    factor of 47 whose padded transform (192x192) fits no block, on
    conv_lnl's cluster route (2 blocks)."""
    from psfmc_tpu_torch.flagship import joint_components
    from psfmc_tpu_torch.models import JointModel

    model = JointModel(joint_components(((64, 64), band1), (32, 32), variant),
                       device=device)
    return model.spec, model.posterior_fns


@pytest.mark.parametrize("variant", ["flagship", "general", "offset"])
def test_joint_graphed_phase_is_bit_identical_to_eager(cuda, variant):
    """The joint flagship's ten steps (band 0 at 64x64 on conv_lnl's FFT
    route, band 1 at 94x94 on its cluster route, both in one captured
    step) as graph replays and eagerly: the same state bit for bit, and
    each kernel's launches exact, per band and route."""
    spec, post = _joint(cuda, variant)
    paths = {"flagship": ("batched", "batched"), "offset": ("batched", "batched"),
             "general": ("general", "general")}[variant]
    assert post.lnpost == paths
    routes = dict(CL.batched_conv_lnl.route_launches)
    graphed, g_launches = _phase(post, spec, "stretch", eager=False, walkers=56)
    eager, e_launches = _phase(post, spec, "stretch", eager=True, walkers=56)
    assert graphed.graph_replays == 10 and eager.graph_replays == 0
    _assert_same_state(graphed, eager)
    assert sorted(graphed.state.accum) == sorted(post.carry_image_shapes())
    assert graphed.state.accum["b1_raw"].shape == (94, 94)
    batched = paths[0] == "batched"
    assert g_launches == e_launches == [2 * (1 + 20 + 6), 2 * (1 + 20) * batched, 0]
    if batched:  # each band's conv_lnl on its route, in both runs
        assert CL.batched_conv_lnl.route_launches == dict(
            routes, fft=routes["fft"] + 2 * 21, cluster=routes["cluster"] + 2 * 21)


def test_dft_route_conv_lnl_inside_a_captured_graph(cuda):
    """Band 1's conv_lnl at 94x94, formerly on the matmul-DFT route, now on
    the cluster route (one cluster of 2 blocks a walker), captured in a
    CUDA graph: the replay equals the eager launch bit for bit and the
    plain version within 2e-5."""
    spec, post = _joint(cuda)
    band = post.band_fns[1]
    assert CL.conv_route(band.shape) == "cluster"
    th = torch.as_tensor(prior_draws(spec, 30, seed=5), dtype=torch.float32,
                         device=cuda)
    raws = band.raw_and_ps(th)[0].contiguous()
    eager = CL.batched_conv_lnl(raws, band.consts)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        CL.batched_conv_lnl(raws, band.consts)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = CL.batched_conv_lnl(raws, band.consts)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    want = CL.batched_conv_lnl_plain(raws, band.consts)
    assert _same_nonfinite(out, want)
    fin = torch.isfinite(want)
    assert fin.sum() >= 15
    rel = (out[fin] - want[fin]).abs() / want[fin].abs()
    assert rel.max().item() <= 2e-5


# -- the gradient path: backward kernels, the Adam step as a graph -----------

def _normalized_err(got, want, dims):
    """max |got - want| over ``dims`` divided by max |want| there."""
    num = (got.double() - want).abs().amax(dim=dims)
    return (num / want.abs().amax(dim=dims).clamp(min=1e-300)).max().item()


@pytest.mark.parametrize("shape", [(128, 128), (45, 37)], ids=["128", "45x37"])
@pytest.mark.parametrize("count", [0, 1, 2, 3, 4, 5, 6])
def test_render_backward_matches_plain(cuda, shape, count):
    """The render's backward kernel at 125 walkers against the float64
    plain backward: per walker and packed scalar, the largest error over
    the Sersics within the larger of 1e-4 of the largest gradient there
    and 4x the float32 plain version's error (float32 per pixel, float64
    sums; a lone Sersic's scalar can cancel to a small sum); the same
    non-finite entries as the float32 plain version (walker 1 is NaN); the
    same bits on every launch.  The counts cover each instantiation of
    the kernel: none (the sky's sum alone), one to four, and 5 and 6 (the
    one-Sersic instantiation in passes)."""
    params, sky = _synthetic_rows(31, 125, count, shape, cuda)
    grad = torch.as_tensor(np.random.RandomState(3).randn(125, *shape),
                           dtype=torch.float32, device=cuda)
    before = SR.render_sersics_backward.launches
    g_params, g_sky = SR.render_sersics_backward(params, sky, shape, grad)
    torch.cuda.synchronize()
    assert SR.render_sersics_backward.launches == before + 1
    p32, s32 = SR.render_sersics_backward_plain(params, sky, shape, grad)
    assert _same_nonfinite(g_params, p32) and _same_nonfinite(g_sky, s32)
    p64, s64 = SR.render_sersics_backward_plain(params.double(), sky.double(),
                                                shape, grad.double())
    assert g_params.shape == params.shape
    keep = torch.isfinite(p64).all(dim=(1, 2)) & torch.isfinite(g_params).all(dim=(1, 2))
    assert keep.sum().item() >= 120
    if count:
        scale = p64[keep].abs().amax(dim=1).clamp(min=1e-300)
        err = (g_params[keep].double() - p64[keep]).abs().amax(dim=1) / scale
        plain_err = (p32[keep].double() - p64[keep]).abs().amax(dim=1) / scale
        assert torch.all(err <= (4 * plain_err).clamp(min=1e-4))
    torch.testing.assert_close(g_sky.double(), s64, rtol=1e-6, atol=0.0)
    again = SR.render_sersics_backward(params, sky, shape, grad)
    _same_bits(again[0], g_params)
    _same_bits(again[1], g_sky)


@pytest.mark.parametrize("shape,psf_shape,route",
                         [((128, 128), (64, 64), "fft"), ((96, 96), (48, 48), "fft"),
                          ((45, 37), (16, 16), "padded"), ((100, 100), (50, 50), "fft"),
                          ((96, 128), (48, 64), "fft"), ((144, 144), (72, 72), "fft"),
                          ((98, 98), (48, 48), "fft"), ((74, 74), (36, 36), "padded"),
                          ((45, 75), (24, 36), "padded"), ((64, 74), (32, 36), "padded"),
                          ((94, 94), (48, 48), "cluster"), ((101, 101), (48, 48), "cluster"),
                          ((160, 180), (64, 64), "cluster"),
                          ((256, 256), (64, 64), "cluster")],
                         ids=["128", "96", "45x37", "100", "96x128", "144", "98", "74",
                              "45x75", "64x74", "94", "101", "160x180", "256"])
def test_conv_lnl_backward_matches_plain(cuda, shape, psf_shape, route):
    """conv_lnl's backward kernel on its routes (the FFT route's
    radix-2 and mixed-radix geometries, radix-7 stages at 98x98; the padded
    route at odd sides and at a factor of 37, 45x37, 74x74, 45x75 and 64x74,
    one side padded; the cluster route at 94x94 and 101x101, padded to
    192x192 and 210x210 over 2 blocks, 160x180 over 2 and 256x256 over 4)
    at 125 walkers against
    the float64 plain backward: per walker within 1e-3 of its largest
    pixel gradient (float32 residuals of a 0.005-noise image carry about
    2e-5 of themselves; the FFT's and GEMMs' rounding come on top); the
    same non-finite entries as the float32 plain version (NaN and
    infinite pixels give a zero gradient); the same bits on every launch.
    On the FFT route the backward reads the residuals that the forward's
    residual instantiation wrote (on the padded route too)."""
    spec = build_model_spec(flagship_components(shape, psf_shape))
    post = build_posterior(spec, device=cuda, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, 125, seed=7), dtype=torch.float32,
                         device=cuda)
    raws = post.raw_and_ps(th)[0].contiguous()
    raws[2, 5, 7] = float("nan")
    raws[11, 20, 3] = float("inf")
    lnl, residuals = CL.batched_conv_lnl(raws, post.consts), None
    if route != "dft":
        lnl_res, *residuals = CL.batched_conv_lnl_residuals(raws, post.consts)
        _same_bits(lnl_res, lnl)
    grad = torch.as_tensor(np.random.RandomState(4).uniform(0.5, 2.0, 125),
                           dtype=torch.float32, device=cuda)
    assert CL.conv_route(shape) == route
    before = CL.batched_conv_lnl_backward.launches
    routes = dict(CL.batched_conv_lnl_backward.route_launches)
    got = CL.batched_conv_lnl_backward(raws, post.consts, lnl, grad, residuals)
    torch.cuda.synchronize()
    _assert_launched_on(CL.batched_conv_lnl_backward, route, before, routes)
    want32 = CL.batched_conv_lnl_backward_plain(raws, post.consts, lnl, grad)
    assert _same_nonfinite(got, want32)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    c64 = build_posterior(spec, device="cpu", dtype=torch.float64,
                          lnpost="batched").consts
    want = CL.batched_conv_lnl_backward_plain(
        raws.double().cpu(), c64, lnl.double().cpu(), grad.double().cpu()).to(cuda)
    keep = torch.isfinite(lnl)
    assert keep.sum().item() >= 120
    assert _normalized_err(got[keep], want[keep], dims=(1, 2)) <= 1e-3
    assert torch.equal(got, CL.batched_conv_lnl_backward(raws, post.consts, lnl, grad,
                                                         residuals))


@pytest.mark.parametrize("shape,psf_shape",
                         [((128, 128), (64, 64)), ((96, 96), (48, 48)),
                          ((100, 100), (50, 50)), ((96, 128), (48, 64)),
                          ((98, 98), (48, 48)), ((74, 74), (36, 36)),
                          ((45, 75), (24, 36)), ((64, 74), (32, 36)),
                          ((94, 94), (48, 48)), ((101, 101), (48, 48)),
                          ((160, 180), (64, 64)), ((256, 256), (64, 64))],
                         ids=["128", "96", "100", "96x128", "98", "74", "45x75", "64x74",
                              "94", "101", "160x180", "256"])
def test_conv_lnl_residuals_match_plain(cuda, shape, psf_shape):
    """The FFT, the padded and the cluster route's residual instantiation
    of the forward at 125 walkers: the same lnL bits as the forward
    kernel's launch on the same inputs, counted on the route ``"fft_res"``,
    ``"padded_res"`` or ``"cluster_res"``; its weights ``(a, c)``
    against the float64 plain scheme within the larger of 1e-6 of each
    walker's largest weight and 4x the float32 plain scheme's own error
    there (float32 FFT rounding of ``conv`` moves the residual ``r = obs
    - conv`` by a few 1e-6 of its peak; the plain scheme in float32 shows
    2e-6 to 4e-6 at 96-128); each walker's scale exponent within one of
    the float64 scheme's; the same bits on every launch."""
    spec = build_model_spec(flagship_components(shape, psf_shape))
    post = build_posterior(spec, device=cuda, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, 125, seed=9), dtype=torch.float32,
                         device=cuda)
    raws = post.raw_and_ps(th)[0].contiguous()
    raws[2, 5, 7] = float("nan")
    lnl = CL.batched_conv_lnl(raws, post.consts)
    route = CL.conv_route(shape)
    plain = (CL.packed_fft_conv_residuals_plain if route == "fft"
             else CL.padded_fft_conv_residuals_plain)
    before = CL.batched_conv_lnl.launches
    routes = dict(CL.batched_conv_lnl.route_launches)
    got, weights, scale_exp = CL.batched_conv_lnl_residuals(raws, post.consts)
    torch.cuda.synchronize()
    _assert_launched_on(CL.batched_conv_lnl, route + "_res", before, routes)
    _same_bits(got, lnl)
    assert weights.shape == (125, *shape, 2) and scale_exp.dtype == torch.int32
    c64 = build_posterior(spec, device="cpu", dtype=torch.float64,
                          lnpost="batched").consts
    _, w64, e64 = plain(raws.double().cpu(), c64)
    _, w32, _ = plain(raws, post.consts)
    keep = torch.isfinite(lnl)
    assert keep.sum().item() >= 120
    want = w64.to(cuda)[keep]
    scale = want.abs().amax(dim=(1, 2))  # (walkers, 2): a and c apart
    err = (weights[keep].double() - want).abs().amax(dim=(1, 2)) / scale
    plain_err = (w32[keep].double() - want).abs().amax(dim=(1, 2)) / scale
    assert torch.all(err <= (4 * plain_err).clamp(min=1e-6))
    assert (scale_exp[keep].cpu() - e64[keep.cpu()]).abs().max().item() <= 1
    again = CL.batched_conv_lnl_residuals(raws, post.consts)
    for x, y in zip(again, (got, weights, scale_exp)):
        _same_bits(x, y)


GRAD_COUNTED = (SR.render_sersics, SR.render_sersics_backward,
                CL.batched_conv_lnl, CL.batched_conv_lnl_backward)


@pytest.mark.parametrize("variant", ["batched", "general"])
def test_log_posterior_and_grad_matches_cpu_float64(cuda, variant):
    """The card's gradient (the kernels' backward kernels on the batched
    path; the render kernel's backward and plain PyTorch on the general
    path) against the CPU's float64 autograd: per point
    ``||g - g_cpu|| / ||g_cpu|| <= 1e-3``, and lnpost within 1e-4."""
    if variant == "batched":
        spec = build_model_spec(flagship_components((64, 64), (32, 32)))
        th = prior_draws(spec, 64, seed=12)
    else:
        spec, _ = _general(cuda, "two-psfs")
        th = _general_thetas(spec, 64, seed=12)
    post = build_posterior(spec, device=cuda)
    assert post.grad_mode == variant
    before = [fn.launches for fn in GRAD_COUNTED]
    lnp, g = post.log_posterior_and_grad(th)
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(GRAD_COUNTED, before)]
    assert launched == ([1, 1, 1, 1] if variant == "batched" else [1, 1, 0, 0])
    ref = build_posterior(spec, device="cpu", dtype=torch.float64)
    lnp64, g64 = ref.log_posterior_and_grad(th)
    fin = torch.isfinite(lnp64)
    assert fin.sum().item() >= 32
    assert torch.equal(fin, torch.isfinite(lnp.cpu()))
    torch.testing.assert_close(lnp.cpu().double()[fin], lnp64[fin], rtol=1e-4, atol=0.0)
    rel = (g.cpu().double() - g64).norm(dim=1) / g64.norm(dim=1)
    assert rel[fin].max().item() <= 1e-3


# a single fit's conv_lnl and backward launch nothing on the stacked routes,
# and (at these shapes) nothing on the global route
NO_TARGETS = {"fft_targets": 0, "padded_targets": 0, "dft_targets": 0,
              "fft_res_targets": 0, "padded_res_targets": 0, "cluster_targets": 0,
              "cluster_res_targets": 0, "global": 0, "global_res": 0,
              "global_targets": 0, "global_res_targets": 0}
NO_BACKWARD_TARGETS = {"fft_targets": 0, "padded_targets": 0, "dft_targets": 0,
                       "cluster_targets": 0, "global": 0, "global_targets": 0}


def _map_counts():
    return [fn.launches for fn in GRAD_COUNTED] + [
        dict(CL.batched_conv_lnl.route_launches),
        dict(CL.batched_conv_lnl_backward.route_launches)]


def test_map_adam_steps_graphed_are_bit_identical_to_eager(flagship):
    """Five Adam steps of fit_map at 8 starts as replays of the captured
    step and eagerly: the same optima bit for bit and the same launches,
    one of each kernel and backward kernel per step, plus the pool's and
    the final iterate's evaluations."""
    from psfmc_tpu_torch import optimize

    spec, post = flagship
    pool = prior_draws(spec, 32, seed=13)
    runs = []
    for eager in (False, True):
        before = _map_counts()
        import contextlib

        with optimize._eager(post) if eager else contextlib.nullcontext():
            res = optimize.fit_map(post, n_starts=8, steps=5, p0=pool, seed=2)
        torch.cuda.synchronize()
        after = _map_counts()
        runs.append((res, [a - b for a, b in zip(after[:4], before[:4])]))
    (g, g_n), (e, e_n) = runs
    _same_bits(g.all_theta, e.all_theta)
    _same_bits(g.all_lnpost, e.all_lnpost)
    assert g_n == e_n == [7, 6, 7, 6]
    program = next(iter(post.__dict__["_map_programs"].values()))
    assert program.replays == 5


def test_joint_map_runs_the_dft_backward_inside_the_graph(cuda):
    """fit_map on the joint flagship (band 0 at 64x64: FFT route; band 1
    at 94x94, formerly the matmul-DFT route: the cluster route): each
    captured Adam step launches each band's conv_lnl and its backward once
    on its route, band 1's forward under autograd writing its residuals;
    nothing on the matmul-DFT route."""
    from psfmc_tpu_torch.optimize import fit_map

    spec, post = _joint(cuda)
    before = _map_counts()
    res = fit_map(post, n_starts=4, steps=3, seed=3)
    torch.cuda.synchronize()
    after = _map_counts()
    assert np.isfinite(res.lnpost)
    # the pool's evaluation, three replays and the final iterate's, per band
    assert [a - b for a, b in zip(after[:4], before[:4])] == [10, 8, 10, 8]
    # by route: each band's forward under autograd writes its residuals
    assert {r: after[4][r] - before[4][r] for r in after[4]} == \
        {"fft": 1, "fft_res": 4, "dft": 0, "padded": 0, "padded_res": 0, "cluster": 1,
         "cluster_res": 4, **NO_TARGETS}
    assert {r: after[5][r] - before[5][r] for r in after[5]} == \
        {"fft": 4, "dft": 0, "padded": 0, "cluster": 4, **NO_BACKWARD_TARGETS}


def test_joint_map_runs_the_mixed_radix_band_inside_the_graph(cuda):
    """fit_map on the joint flagship with band 1 at 48x48 (3 x 2^4: the
    FFT route's mixed-radix geometry): each captured Adam step launches
    both bands' conv_lnl and backward on the FFT route, band 1's counted
    at its shape; replayed and eager Adam steps agree bit for bit."""
    _joint_map_on_the_fft_route(cuda, (48, 48))


@pytest.mark.parametrize("band1", [(56, 56), (98, 98)], ids=["56", "98"])
def test_joint_map_runs_the_radix7_band_inside_the_graph(cuda, band1):
    """The same with band 1 at 56x56 (7 x 2^3: passes 0x71, 0x12) and at
    98x98 (7^2 x 2: passes 0x70, 0x71), the mixed-radix geometry's
    radix-7 stages inside the captured Adam step."""
    assert CL.fft_plan(band1[0])[0][0] == 7
    _joint_map_on_the_fft_route(cuda, band1)


def _joint_map_on_the_fft_route(cuda, band1):
    import contextlib

    from psfmc_tpu_torch import optimize

    spec, post = _joint(cuda, band1=band1)
    assert CL.conv_route(post.band_fns[1].shape) == "fft"
    runs = []
    for eager in (False, True):
        before = _map_counts()
        keys = [(CL.batched_conv_lnl, "fft"), (CL.batched_conv_lnl, "fft_res"),
                (CL.batched_conv_lnl_backward, "fft")]
        at_band1 = [fn.shape_launches.get((r, band1), 0) for fn, r in keys]
        with optimize._eager(post) if eager else contextlib.nullcontext():
            res = optimize.fit_map(post, n_starts=4, steps=3, seed=3)
        torch.cuda.synchronize()
        after = _map_counts()
        assert np.isfinite(res.lnpost)
        assert [a - b for a, b in zip(after[:4], before[:4])] == [10, 8, 10, 8]
        # every launch on the FFT route, the forward under autograd writing
        # its residuals
        assert {r: after[4][r] - before[4][r] for r in after[4]} == \
            {"fft": 2, "fft_res": 8, "dft": 0, "padded": 0, "padded_res": 0, "cluster": 0,
             "cluster_res": 0, **NO_TARGETS}
        assert {r: after[5][r] - before[5][r] for r in after[5]} == \
            {"fft": 8, "dft": 0, "padded": 0, "cluster": 0, **NO_BACKWARD_TARGETS}
        assert [fn.shape_launches.get((r, band1), 0) - b
                for (fn, r), b in zip(keys, at_band1)] == [1, 4, 4]
        runs.append(res)
    _same_bits(runs[0].all_theta, runs[1].all_theta)
    _same_bits(runs[0].all_lnpost, runs[1].all_lnpost)


def test_joint_map_runs_the_padded_band_inside_the_graph(cuda):
    """fit_map on the joint flagship with band 1 at 74x74 (2 x 37: the
    padded route, a 150x150 transform): each captured Adam step launches
    band 1's residual forward and backward on the padded route, counted at
    its shape, band 0's on the FFT route; replayed and eager Adam steps
    agree bit for bit."""
    import contextlib

    from psfmc_tpu_torch import optimize

    band1 = (74, 74)
    spec, post = _joint(cuda, band1=band1)
    assert CL.conv_route(post.band_fns[1].shape) == "padded"
    runs = []
    for eager in (False, True):
        before = _map_counts()
        keys = [(CL.batched_conv_lnl, "padded"), (CL.batched_conv_lnl, "padded_res"),
                (CL.batched_conv_lnl_backward, "padded")]
        at_band1 = [fn.shape_launches.get((r, band1), 0) for fn, r in keys]
        with optimize._eager(post) if eager else contextlib.nullcontext():
            res = optimize.fit_map(post, n_starts=4, steps=3, seed=3)
        torch.cuda.synchronize()
        after = _map_counts()
        assert np.isfinite(res.lnpost)
        assert [a - b for a, b in zip(after[:4], before[:4])] == [10, 8, 10, 8]
        assert {r: after[4][r] - before[4][r] for r in after[4]} == \
            {"fft": 1, "fft_res": 4, "dft": 0, "padded": 1, "padded_res": 4, "cluster": 0,
             "cluster_res": 0, **NO_TARGETS}
        assert {r: after[5][r] - before[5][r] for r in after[5]} == \
            {"fft": 4, "dft": 0, "padded": 4, "cluster": 0, **NO_BACKWARD_TARGETS}
        assert [fn.shape_launches.get((r, band1), 0) - b
                for (fn, r), b in zip(keys, at_band1)] == [1, 4, 4]
        runs.append(res)
    _same_bits(runs[0].all_theta, runs[1].all_theta)
    _same_bits(runs[0].all_lnpost, runs[1].all_lnpost)


@pytest.mark.parametrize("shape", [(74, 74), (45, 75), (64, 74), (81, 81), (31, 31),
                                   (3, 5), (2, 37), (37, 2), (13, 128), (15, 21)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_conv_lnl_padded_route_at_every_transform(cuda, shape):
    """The padded route's forward, residual forward and backward at odd
    sides, prime sides, one side padded and the other not, the largest
    side (81 -> 162), a transform of powers of two (31 -> 64) and sides
    of 2 and 3: one launch each on the routes ``"padded"`` and
    ``"padded_res"``; the lnL within 2e-5 of the float64 plain version per
    walker, the residual instantiation's lnL bits the forward's, the
    backward within 1e-3 of each walker's largest gradient of the float64
    plain backward, and the same bits on a second launch."""
    consts, c64, raws = _synthetic_consts(shape, cuda, shape[0] * 1000 + shape[1])
    assert CL.conv_route(shape) == "padded"
    routes = dict(CL.batched_conv_lnl.route_launches)
    got = CL.batched_conv_lnl(raws, consts)
    lnl, *residuals = CL.batched_conv_lnl_residuals(raws, consts)
    torch.cuda.synchronize()
    routes["padded"] += 1
    routes["padded_res"] += 1
    assert CL.batched_conv_lnl.route_launches == routes
    _same_bits(lnl, got)
    want = CL.batched_conv_lnl_plain(raws.double().cpu(), c64).to(cuda)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=0.0)
    assert torch.equal(got, CL.batched_conv_lnl(raws, consts))
    grad = torch.as_tensor(np.random.RandomState(4).uniform(0.5, 2.0, len(raws)),
                           dtype=torch.float32, device=cuda)
    back = CL.batched_conv_lnl_backward(raws, consts, got, grad, residuals)
    want_back = CL.batched_conv_lnl_backward_plain(
        raws.double().cpu(), c64, want.cpu(), grad.double().cpu()).to(cuda)
    assert _normalized_err(back, want_back, dims=(1, 2)) <= 1e-3
    assert torch.equal(back, CL.batched_conv_lnl_backward(raws, consts, got, grad,
                                                          residuals))


@pytest.mark.parametrize("shape", [(88, 88), (94, 94), (101, 101), (160, 180), (196, 196),
                                   (200, 200), (128, 256), (256, 256), (450, 450)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_conv_lnl_cluster_route_at_every_cluster_size(cuda, shape):
    """The cluster route's forward, residual forward and backward on
    clusters of 2 blocks (the padded 180x180, 192x192 and 210x210, and
    160x180, 196x196, 200x200, 128x256), 4 (256x256) and 8 (450x450), at
    8 walkers: one launch each on the routes ``"cluster"`` and
    ``"cluster_res"`` and the backward's ``"cluster"``; the lnL within 2e-5
    of the float64 plain version per walker, the residual instantiation's
    lnL bits the forward's, the backward within 1e-3 of each walker's
    largest gradient of the float64 plain backward, and the same bits on a
    second launch of each."""
    consts, c64, raws = _synthetic_consts(shape, cuda, shape[0] * 1000 + shape[1])
    raws = raws[:8].contiguous()
    assert CL.conv_route(shape) == "cluster"
    assert CL.cluster_size(shape) == {(256, 256): 4, (450, 450): 8}.get(shape, 2)
    routes = dict(CL.batched_conv_lnl.route_launches)
    back_routes = dict(CL.batched_conv_lnl_backward.route_launches)
    got = CL.batched_conv_lnl(raws, consts)
    lnl, *residuals = CL.batched_conv_lnl_residuals(raws, consts)
    grad = torch.as_tensor(np.random.RandomState(4).uniform(0.5, 2.0, len(raws)),
                           dtype=torch.float32, device=cuda)
    back = CL.batched_conv_lnl_backward(raws, consts, got, grad, residuals)
    torch.cuda.synchronize()
    routes["cluster"] += 1
    routes["cluster_res"] += 1
    back_routes["cluster"] += 1
    assert CL.batched_conv_lnl.route_launches == routes
    assert CL.batched_conv_lnl_backward.route_launches == back_routes
    _same_bits(lnl, got)
    want = CL.batched_conv_lnl_plain(raws.double().cpu(), c64).to(cuda)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=0.0)
    want_back = CL.batched_conv_lnl_backward_plain(
        raws.double().cpu(), c64, want.cpu(), grad.double().cpu()).to(cuda)
    assert _normalized_err(back, want_back, dims=(1, 2)) <= 1e-3
    assert torch.equal(got, CL.batched_conv_lnl(raws, consts))
    for x, y in zip(CL.batched_conv_lnl_residuals(raws, consts), [lnl] + residuals):
        _same_bits(x, y)
    assert torch.equal(back, CL.batched_conv_lnl_backward(raws, consts, got, grad,
                                                          residuals))


def test_cluster_route_keeps_the_non_finite_walkers_inside_a_graph(cuda):
    """At 94x94 (192x192 over 2 blocks): a NaN pixel, an infinite pixel
    and a pixel whose square overflows float32 give -inf on exactly those
    walkers in the forward and the residual forward, as the plain version,
    and a zero gradient; the three launches captured in one CUDA graph
    replay the eager launches bit for bit."""
    consts, _, raws = _synthetic_consts((94, 94), cuda, 94)
    raws[2, 5, 7] = float("nan")
    raws[11, 40, 3] = float("inf")
    raws[17, 93, 93] = 1e30
    raws[23] = 0.0  # the scale falls back to 1
    grad = torch.ones(len(raws), dtype=torch.float32, device=cuda)

    def launches():
        lnl = CL.batched_conv_lnl(raws, consts)
        res = CL.batched_conv_lnl_residuals(raws, consts)
        return [lnl, *res, CL.batched_conv_lnl_backward(raws, consts, lnl, grad, res[1:])]

    eager = launches()
    want = CL.batched_conv_lnl_plain(raws, consts)
    for got in eager[:2]:
        assert _same_nonfinite(got, want)
        assert {2, 11, 17} <= set(torch.isinf(got).nonzero().flatten().tolist())
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)
    assert torch.isfinite(eager[0][23])
    for w in (2, 11, 17):
        assert torch.equal(eager[4][w], torch.zeros_like(eager[4][w]))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launches()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launches()
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(out, eager):
        _same_bits(x, y)


GLOBAL_SHAPES = [(235, 235), (251, 251), (512, 512), (640, 640), (235, 512), (1023, 1023)]


@pytest.mark.parametrize("shape", GLOBAL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_conv_lnl_global_route_matches_float64(cuda, shape):
    """The global route's forward, residual forward and backward (the
    padded 480x480, 504x504, 480x512 and 2048x2048 transforms, and 512x512
    and 640x640 unpadded) at 8 walkers: one launch each on the routes
    ``"global"`` and ``"global_res"`` and the backward's ``"global"``; the
    lnL within 2e-5 of the float64 plain version per walker, the residual
    instantiation's lnL bits the forward's, the backward within 1e-3 of
    each walker's largest gradient of the float64 plain backward, the same
    bits on a second launch of each, and each walker's bits independent of
    the batch it is launched in."""
    consts, c64, raws = _synthetic_consts(shape, cuda, shape[0] * 1000 + shape[1])
    raws = raws[:8].contiguous()
    assert CL.conv_route(shape) == "global" and CL.global_tiles(shape)
    routes = dict(CL.batched_conv_lnl.route_launches)
    back_routes = dict(CL.batched_conv_lnl_backward.route_launches)
    got = CL.batched_conv_lnl(raws, consts)
    lnl, *residuals = CL.batched_conv_lnl_residuals(raws, consts)
    grad = torch.as_tensor(np.random.RandomState(4).uniform(0.5, 2.0, len(raws)),
                           dtype=torch.float32, device=cuda)
    back = CL.batched_conv_lnl_backward(raws, consts, got, grad, residuals)
    torch.cuda.synchronize()
    routes["global"] += 1
    routes["global_res"] += 1
    back_routes["global"] += 1
    assert CL.batched_conv_lnl.route_launches == routes
    assert CL.batched_conv_lnl_backward.route_launches == back_routes
    _same_bits(lnl, got)
    want = CL.batched_conv_lnl_plain(raws.double().cpu(), c64).to(cuda)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=0.0)
    want_back = CL.batched_conv_lnl_backward_plain(
        raws.double().cpu(), c64, want.cpu(), grad.double().cpu()).to(cuda)
    assert _normalized_err(back, want_back, dims=(1, 2)) <= 1e-3
    assert torch.equal(got, CL.batched_conv_lnl(raws, consts))
    for x, y in zip(CL.batched_conv_lnl_residuals(raws, consts), [lnl] + residuals):
        _same_bits(x, y)
    assert torch.equal(back, CL.batched_conv_lnl_backward(raws, consts, got, grad,
                                                          residuals))
    _same_bits(CL.batched_conv_lnl(raws[3:6].contiguous(), consts), got[3:6])


@pytest.mark.parametrize("shape", [(251, 251), (512, 512)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_lnl_global_route_matches_float64(cuda, shape):
    """The fused kernel on the global route (its render pass, then
    conv_lnl's passes) at 30 walkers of the flagship: one launch on the
    route ``"global"``, the non-finite walkers of the float32 plain
    version, within 2e-5 of the float64 plain version per walker (at these
    widths the float32 plain version's matrix products are themselves
    further than that from it), the same bits on a second launch."""
    post, params, sky, fky, kx = _likelihood_inputs(cuda, shape, (64, 64), True, "fused", 7)
    assert FL.fused_route(shape) == "global" and FL.fused_lnl_supported(post.spec)[0]
    ref = build_posterior(post.spec, device="cpu", dtype=torch.float64, lnpost="fused")
    c64 = CL.ConvLnlConsts(**{f: getattr(ref.consts, f).to(cuda)
                              for f in CL.ConvLnlConsts.__dataclass_fields__})
    args = (params.contiguous(), sky.contiguous(), fky.contiguous(), kx.contiguous())
    before = FL.fused_lnl.launches
    routes_before = dict(FL.fused_lnl.route_launches)
    got = FL.fused_lnl(*args, post.consts)
    torch.cuda.synchronize()
    _assert_launched_on(FL.fused_lnl, "global", before, routes_before)
    assert _same_nonfinite(got, FL.fused_lnl_plain(*args, post.consts))
    want = FL.fused_lnl_plain(*(t.double() for t in args), c64)
    fin = torch.isfinite(want) & torch.isfinite(got)
    assert fin.sum().item() >= 15
    torch.testing.assert_close(got[fin].double(), want[fin], rtol=2e-5, atol=0.0)
    assert torch.equal(got, FL.fused_lnl(*args, post.consts))


def test_global_route_keeps_the_non_finite_walkers_inside_a_graph(cuda):
    """At 251x251 (a 504x504 transform in global memory): a NaN pixel, an
    infinite pixel and a pixel whose square overflows float32 give -inf on
    exactly those walkers in the forward and the residual forward, as the
    plain version, and a zero gradient; the three calls (eleven launches
    and their scratch from the graph's pool) captured in one CUDA graph
    replay the eager launches bit for bit."""
    consts, _, raws = _synthetic_consts((251, 251), cuda, 251)
    raws = raws[:24].contiguous()
    raws[2, 5, 7] = float("nan")
    raws[11, 40, 3] = float("inf")
    raws[17, 250, 250] = 1e30
    raws[23] = 0.0  # the scale falls back to 1
    grad = torch.ones(len(raws), dtype=torch.float32, device=cuda)

    def launches():
        lnl = CL.batched_conv_lnl(raws, consts)
        res = CL.batched_conv_lnl_residuals(raws, consts)
        return [lnl, *res, CL.batched_conv_lnl_backward(raws, consts, lnl, grad, res[1:])]

    eager = launches()
    want = CL.batched_conv_lnl_plain(raws, consts)
    for got in eager[:2]:
        assert _same_nonfinite(got, want)
        assert {2, 11, 17} <= set(torch.isinf(got).nonzero().flatten().tolist())
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)
    assert torch.isfinite(eager[0][23])
    for w in (2, 11, 17):
        assert torch.equal(eager[4][w], torch.zeros_like(eager[4][w]))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launches()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launches()
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(out, eager):
        _same_bits(x, y)


def test_global_launch_refuses_a_plan_the_host_did_not_make(cuda):
    """The global launch checks the transform's sides and the tiles
    against the plan: a transform or a tile the host would not make is
    refused (nothing launched) and the right plan launches."""
    consts, _, raws = _synthetic_consts((251, 251), cuda, 5)
    raws = raws[:4].contiguous()
    fn = CL._block_kernel("global", False)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [getattr(consts, n).data_ptr() for n in CL.PADDED_CONST_ARGS]
    scratch = [t.data_ptr() for t in CL._global_scratch(4, (251, 251), cuda)]
    out = torch.empty(4, device=cuda)
    one = (1, 0, 0)
    for plan in ((251, 251, 502, 504, 16, 8), (251, 251, 504, 504, 17, 8),
                 (251, 251, 504, 504, 16, 0)):
        assert fn(raws.data_ptr(), 4, *plan, *one, *ptrs, *scratch, out.data_ptr(),
                  stream) != 0
    assert fn(raws.data_ptr(), 4, 251, 251, 504, 504, 16, 8, *one, *ptrs, *scratch,
              out.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, CL.batched_conv_lnl_plain(raws, consts), rtol=2e-5,
                               atol=0.0)


def test_padded_launch_refuses_a_shape_the_host_did_not_plan(cuda):
    """The padded launch checks the transform's sides against the plan:
    a transform the host would not make is refused and the wrapper
    raises, with nothing counted."""
    consts, _, raws = _synthetic_consts((74, 74), cuda, 5)
    fn = CL._block_kernel("padded", False)
    out = torch.empty(len(raws), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [getattr(consts, n).data_ptr() for n in CL.PADDED_CONST_ARGS]
    one = (1, 0, 0)  # one target: a walker a target, strides 0
    for mh, mw in ((148, 150), (150, 152), (74, 74)):
        assert fn(raws.data_ptr(), len(raws), 74, 74, mh, mw, *one, *ptrs,
                  out.data_ptr(), stream) != 0
    assert fn(raws.data_ptr(), len(raws), 74, 74, 150, 150, *one, *ptrs,
              out.data_ptr(), stream) == 0
    # a target layout the kernel cannot read is refused too
    for bad in ((0, 0, 0), (1, -1, 0), (1, 0, -1)):
        assert fn(raws.data_ptr(), len(raws), 74, 74, 150, 150, *bad, *ptrs,
                  out.data_ptr(), stream) != 0


def test_a_failed_backward_build_raises(flagship, monkeypatch):
    """A backward kernel that cannot be built raises through the gradient:
    nothing falls back to the plain backward or to autograd."""
    spec, post = flagship

    def broken():
        raise RuntimeError("nvcc failed for csrc/sersic_render_backward.cu")

    monkeypatch.setattr(SR, "_backward_kernel", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        post.log_posterior_and_grad(prior_draws(spec, 4, seed=1))


# -- parallel tempering and annealed importance sampling -------------------------

PT_STATE = ("positions", "log_like", "log_prior", "betas", "naccept", "nswap",
            "accum_count", "lnl_sum", "lnl_sum_c", "lnl_sq_sum", "lnl_sq_sum_c",
            "evid_steps", "ss_max", "ss_sum")


def _tempered(post, spec, moves, eager, ntemps=4, walkers=40, betas=None):
    """10 burn steps (two adaptation windows of 5) + 6 retained steps of a
    tempered sampler; the launches made and the graphs after each window."""
    import contextlib

    from psfmc_tpu_torch.sampler import PTEnsembleSampler
    from psfmc_tpu_torch.sampler.ensemble import _eager

    s = PTEnsembleSampler(walkers, spec.num_params, post, ntemps=ntemps, seed=5,
                          moves=moves, betas=betas, track_moments=True)
    before = [f.launches for f in COUNTED]
    graphs = []
    with _eager(s) if eager else contextlib.nullcontext():
        s.init_state(prior_draws(spec, walkers, seed=5))
        s.run_burn(10, callback=lambda done, total: graphs.append(len(s._graphs)))
        s.reset()
        s.run_sampling(6)
    torch.cuda.synchronize()
    return s, [f.launches - n for f, n in zip(COUNTED, before)], graphs


@pytest.mark.parametrize("lnpost", ["batched", "fused"])
@pytest.mark.parametrize("moves", ["stretch", "mixed"])
def test_tempered_phase_graphed_is_bit_identical_to_eager(cuda, lnpost, moves):
    """Sixteen tempered steps (4 rungs, an adaptation of the ladder between
    two burn windows) as graph replays and eagerly: every buffer, the
    chain and the generator bit for bit, equal launches, two a step, each
    carrying every rung; the adaptation captures nothing new."""
    spec = build_model_spec(flagship_components((64, 64), (32, 32)))
    post = build_posterior(spec, device=cuda, lnpost=lnpost)
    graphed, g_launches, graphs = _tempered(post, spec, moves, eager=False)
    eager, e_launches, _ = _tempered(post, spec, moves, eager=True)
    assert graphed.graph_replays == 16 and eager.graph_replays == 0
    assert graphs == [1, 1] and len(graphed._graphs) == 2
    assert not np.array_equal(graphed.betas, [1.0, 0.25, 0.0625, 0.015625])
    for name in PT_STATE:
        _same_bits(getattr(graphed.state, name), getattr(eager.state, name))
    for k in graphed.state.accum:
        _same_bits(graphed.state.accum[k], eager.state.accum[k])
    for k in graphed.state.moments:
        _same_bits(graphed.state.moments[k], eager.state.moments[k])
    _same_bits(graphed.generator.get_state(), eager.generator.get_state())
    _same_bits(graphed.chain, eager.chain)
    _same_bits(graphed.lnprobability, eager.lnprobability)
    want = ([1 + 32 + 6, 1 + 32, 0] if lnpost == "batched" else [6, 0, 1 + 32])
    assert g_launches == e_launches == want


def test_tempered_ladder_written_in_place_needs_no_capture(flagship):
    """Setting ``betas`` writes the device buffer the captured step reads:
    the next replays use the new ladder without a new graph."""
    from psfmc_tpu_torch.sampler import PTEnsembleSampler, evidence_beta_ladder

    spec, post = flagship
    s = PTEnsembleSampler(40, spec.num_params, post, ntemps=4, seed=6)
    s.init_state(prior_draws(spec, 40, seed=6))
    s.run_burn(3)
    graph = s._graphs["burn"]
    buf = s.state.betas
    s.betas = evidence_beta_ladder(4)
    s.run_burn(3)
    assert s._graphs["burn"] is graph and s.state.betas is buf
    np.testing.assert_array_equal(buf.cpu().numpy(), evidence_beta_ladder(4))
    assert s.graph_replays == 6


def test_ais_graphed_is_bit_identical_to_eager(flagship):
    """Twelve anneal steps (2 sweeps of mixed moves, 4 groups of 16) as
    graph replays and eagerly: the same state bit for bit, and the
    render and conv_lnl launches exact (4 a step at 32 walkers each)."""
    from psfmc_tpu_torch.sampler.ais import ais_beta_schedule, run_ais
    from psfmc_tpu_torch.sampler.tempered import batched_like_prior

    spec, post = flagship
    p0 = torch.as_tensor(prior_draws(spec, 64, seed=7).reshape(4, 16, -1),
                         dtype=torch.float32, device=post.device)
    out = []
    for graphed in (True, False):
        gen = torch.Generator(device=post.device)
        gen.manual_seed(8)
        before = [f.launches for f in COUNTED]
        state, replays = run_ais(batched_like_prior(post), p0, ais_beta_schedule(12),
                                 gen, sweeps=2, moves="mixed", graphed=graphed)
        torch.cuda.synchronize()
        out.append((state, replays, gen.get_state(),
                    [f.launches - n for f, n in zip(COUNTED, before)]))
    (g, g_rep, g_gen, g_launch), (e, e_rep, e_gen, e_launch) = out
    assert (g_rep, e_rep) == (12, 0)
    for name in vars(g):
        _same_bits(getattr(g, name), getattr(e, name))
    _same_bits(g_gen, e_gen)
    assert g_launch == e_launch == [1 + 4 * 12, 1 + 4 * 12, 0]
    assert int(g.t) == 12 and torch.isfinite(g.lnz).all()


@pytest.mark.parametrize("batch", [500, 1000])
def test_kernels_at_tempered_batches_match_plain(cuda, batch):
    """The render and conv_lnl kernels at a tempered half-step's batch (4
    and 8 rungs of 250 walkers) at 128x128, against their plain versions."""
    spec = build_model_spec(flagship_components((128, 128), (64, 64)))
    post = build_posterior(spec, device=cuda, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, batch, seed=9), dtype=torch.float32,
                         device=cuda)
    params, sky = post.render_inputs(th)
    params, sky = params.contiguous(), sky.contiguous()
    got = SR.render_sersics(params, sky, spec.shape)
    want = SR.render_sersics_plain(params, sky, spec.shape)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    assert ((got[fin] - want[fin]).abs() / want[fin].abs().clamp(min=1e-12)).max() <= 5e-6
    raws = post.raw_and_ps(th)[0].contiguous()
    lnl = CL.batched_conv_lnl(raws, post.consts)
    ref = CL.batched_conv_lnl_plain(raws, post.consts)
    assert _same_nonfinite(lnl, ref)
    fin = torch.isfinite(ref)
    assert fin.float().mean() > 0.5
    assert ((lnl[fin] - ref[fin]).abs() / ref[fin].abs()).max() <= 2e-5


# -- NUTS ------------------------------------------------------------------------
class _NutsIdentity:
    """The identity transform of a toy target."""

    def __init__(self, m):
        self.num_unconstrained = m
        self.discrete_offsets = np.zeros(0, np.int64)

    def to_constrained(self, z):
        return z, torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)

    def to_unconstrained(self, theta):
        return np.asarray(theta, np.float64)


class _NutsGauss:
    """A correlated 3-D Gaussian with a carry image (theta_0 everywhere):
    the target of the JAX package's NUTS moments test."""

    mean = np.array([1.0, -2.0, 0.5])
    cov = np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]])

    def __init__(self, device):
        self.device, self.dtype = torch.device(device), torch.float64
        self.spec = type("Spec", (), {"num_psfs": 1})()
        self._mean = torch.as_tensor(self.mean, device=self.device)
        self._prec = torch.as_tensor(np.linalg.inv(self.cov), device=self.device)

    def log_posterior_batch(self, theta):
        d = theta - self._mean
        return -0.5 * ((d @ self._prec) * d).sum(-1)

    differentiable_log_posterior = log_posterior_batch

    def carry_image_shapes(self):
        return {"img": (2, 2)}

    def ensemble_carry_means(self, theta):
        return {"img": theta[:, 0].mean().expand(2, 2).to(torch.float32)}


def test_nuts_steps_graphed_are_bit_identical_to_eager(flagship):
    """Three warmup steps (the window switch after the third) and one
    retained step of NUTS at 8 chains, as replays of the captured pieces
    and eagerly: every buffer, the chain and the generator bit for bit,
    equal launches; the leaf's graph launches the render, conv_lnl's
    residual forward and both backward kernels once each."""
    import contextlib
    from dataclasses import fields

    from psfmc_tpu_torch.sampler.nuts import (
        SAMPLE_PIECES,
        WARMUP_PIECES,
        NUTSSampler,
        _eager,
    )

    spec, post = flagship
    pool = prior_draws(spec, 64, seed=21)
    runs = []
    for eager in (False, True):
        s = NUTSSampler(8, spec.num_params, post, seed=3, max_depth=5)
        s.init_state(pool)
        s.state.eps.fill_(2e-4)  # trees of several leaves from the prior's best
        before = _map_counts()
        with _eager(s) if eager else contextlib.nullcontext():
            s.run_burn(3)
            s.reset()
            s.run_sampling(1)
        torch.cuda.synchronize()
        after = _map_counts()
        runs.append((s, [a - b for a, b in zip(after[:4], before[:4])]))
    (g, g_n), (e, e_n) = runs
    for f in fields(g.state):
        x, y = getattr(g.state, f.name), getattr(e.state, f.name)
        for u, v in ([(x[k], y[k]) for k in x] if f.name == "accum" else [(x, y)]):
            _same_bits(u, v)
    _same_bits(g.generator.get_state(), e.generator.get_state())
    _same_bits(g.chain, e.chain)
    _same_bits(g.lnprobability, e.lnprobability)
    assert g.piece_counts == e.piece_counts and g.piece_counts["switch"] == 1
    assert g.graph_replays == sum(g.piece_counts.values()) and e.graph_replays == 0
    assert g.captures == len(set(WARMUP_PIECES) | set(SAMPLE_PIECES))
    tally = sorted((fn.__name__, route or "") for fn, route, _ in g._graphs["leaf"].launches)
    assert tally == [("batched_conv_lnl", "fft_res"), ("batched_conv_lnl_backward", "fft"),
                     ("render_sersics", ""), ("render_sersics_backward", "")]
    leaves = g.leaves_run
    assert leaves > g.steps_run  # trees of more than one leaf
    assert g_n == e_n == [leaves + 2, leaves, leaves + 1, leaves]


def test_nuts_gaussian_moments_on_the_card(cuda):
    """The JAX package's NUTS moments test on the card: 8 chains, 300
    warmup + 700 retained steps, the same bars."""
    from psfmc_tpu_torch.sampler.nuts import NUTSSampler

    post = _NutsGauss(cuda)
    s = NUTSSampler(8, 3, post, seed=1, transform=_NutsIdentity(3), device=cuda)
    s.init_state(np.random.RandomState(0).randn(8, 3) * 0.1 + post.mean)
    s.run_burn(300)
    s.reset()
    s.run_sampling(700)
    flat = np.asarray(s.flatchain, np.float64)
    assert np.allclose(flat.mean(0), post.mean, atol=0.08)
    assert np.allclose(np.cov(flat.T), post.cov, atol=0.2)
    inv_mass = s.state.inv_mass.cpu().numpy()
    assert np.all(inv_mass > 0.1) and np.all(inv_mass < 5.0)
    assert 0.5 < s.acceptance_fraction.mean() <= 1.0
    assert abs(float(s.accumulated_images["img"].mean()) - 1.0) < 0.15
    assert s.accumulated_samples == 8 * 700
    assert s.n_leapfrog_total > 0
    assert s.graph_replays == sum(s.piece_counts.values())


# -- conv_lnl with a target axis (the batch fit) ---------------------------------
def _target_stack(shape, device, nt, spectra, seed=3):
    """A stacked consts of ``nt`` targets around :func:`_synthetic_consts`'s
    observation (each its own noise, variance scale and mask; with
    ``spectra`` each its own PSF width), the float64 CPU twin, and
    ``nt x 6`` walkers of raws (the same 6 for every target)."""
    h, w = shape
    rng = np.random.RandomState(seed)
    base, _, raws = _synthetic_consts(shape, device, seed)
    obs = base.obs.cpu().double().numpy()[None] + 0.001 * rng.randn(nt, h, w)
    var = np.full((nt, h, w), 2.5e-5) * rng.uniform(0.8, 1.25, (nt, 1, 1))
    good = rng.rand(nt, h, w) > 0.05
    ph, pw = max(h // 2, 1), max(w // 2, 1)
    yy, xx = np.mgrid[0:ph, 0:pw]
    f_psf, f_var = [], []
    for s in rng.uniform(1.2, 2.0, nt):
        psf = np.exp(-((yy - ph // 2) ** 2 + (xx - pw // 2) ** 2) / (2 * s * s)) + 1e-3
        psf /= psf.sum()
        for out, img in ((f_psf, psf), (f_var, np.full_like(psf, 1e-8) * s)):
            pad = np.zeros(shape)
            oy, ox = h // 2 - ph // 2, w // 2 - pw // 2
            pad[oy:oy + ph, ox:ox + pw] = img
            out.append(np.fft.rfft2(pad))
    shared = (base.psf_r.cpu().double().numpy() + 1j * base.psf_i.cpu().double().numpy(),
              base.var_r.cpu().double().numpy() + 1j * base.var_i.cpu().double().numpy())
    fp, fv = (np.stack(f_psf), np.stack(f_var)) if spectra else shared
    args = (fp, fv, obs, var, good)
    raws = torch.cat([raws[:6]] * nt)
    return (CL.make_conv_lnl_consts_stack(*args, device),
            CL.make_conv_lnl_consts_stack(*args, "cpu", torch.float64), raws)


@pytest.mark.parametrize("shape", [(128, 128), (96, 96), (98, 98), (74, 74), (45, 75),
                                   (94, 94), (256, 256), (251, 251)])
@pytest.mark.parametrize("spectra", [False, True], ids=["planes", "spectra"])
def test_conv_lnl_with_targets_matches_plain(cuda, shape, spectra):
    """Per-target planes on every route (and per-target spectra off the
    matmul-DFT route: 94x94 and 256x256 on the cluster route, 251x251 on the
    global route) against the plain version: within 2e-5 of the
    float32 plain version per walker, as close to the float64 one as four
    times the float32 plain version, the same non-finite entries, counted
    on the route's ``_targets`` key; per-target spectra on the matmul-DFT
    route raise before any launch."""
    nt = 4
    consts, c64, raws = _target_stack(shape, cuda, nt, spectra)
    route = CL.conv_route(shape)
    before = dict(CL.batched_conv_lnl.route_launches)
    if spectra and route == "dft":
        with pytest.raises(ValueError, match="general path"):
            CL.batched_conv_lnl(raws, consts)
        assert CL.batched_conv_lnl.route_launches == before
        return
    got = CL.batched_conv_lnl(raws, consts)
    torch.cuda.synchronize()
    before[route + "_targets"] += 1
    assert CL.batched_conv_lnl.route_launches == before
    want = CL.batched_conv_lnl_plain(raws, consts)
    truth = CL.batched_conv_lnl_plain(raws.double().cpu(), c64)
    assert _same_nonfinite(got, want) and torch.isfinite(got).all()
    rel = ((got - want).abs() / want.abs()).max().item()
    err = ((got.double().cpu() - truth).abs() / truth.abs()).max().item()
    plain = ((want.double().cpu() - truth).abs() / truth.abs()).max().item()
    assert rel <= 2e-5 and err <= max(4 * plain, 1e-6)
    # each target against a launch of its own constants
    for t in range(nt):
        rows = slice(t * 6, (t + 1) * 6)
        one = CL.make_conv_lnl_consts(
            *(np.asarray(x) for x in (
                (c64.psf_r[t] + 1j * c64.psf_i[t]).numpy() if spectra
                else (c64.psf_r + 1j * c64.psf_i).numpy(),
                (c64.var_r[t] + 1j * c64.var_i[t]).numpy() if spectra
                else (c64.var_r + 1j * c64.var_i).numpy(),
                c64.obs[t].numpy(), c64.obs_var[t].numpy(), c64.good[t].numpy())), cuda)
        assert torch.equal(got[rows], CL.batched_conv_lnl(raws[rows], one))


@pytest.mark.parametrize("shape", [(128, 128), (96, 96), (74, 74), (94, 94)])
def test_conv_lnl_stacked_copies_equal_the_shared_launch(cuda, shape):
    """A stack of K copies of one observation gives the shared-constants
    launch's lnL bit for bit: the target stride only moves the pointers."""
    consts, _, raws = _synthetic_consts(shape, cuda, 5)
    # both from the same float64 inputs (the padded route's spectra are
    # transformed from them on the host)
    args = [(consts.psf_r + 1j * consts.psf_i).cpu().to(torch.complex128).numpy(),
            (consts.var_r + 1j * consts.var_i).cpu().to(torch.complex128).numpy()] + [
        t.cpu().numpy() for t in (consts.obs.double(), consts.obs_var.double(), consts.good)]
    shared = CL.make_conv_lnl_consts(*args, cuda)
    stack = CL.make_conv_lnl_consts_stack(
        *args[:2], *(np.repeat(a[None], 4, 0) for a in args[2:]), cuda)
    assert torch.equal(CL.batched_conv_lnl(raws, stack), CL.batched_conv_lnl(raws, shared))


TARGET_GRAD_CASES = [((128, 128), False), ((128, 128), True), ((96, 96), False),
                     ((74, 74), False), ((74, 74), True), ((94, 94), False),
                     ((94, 94), True), ((160, 180), False), ((251, 251), False),
                     ((251, 251), True)]


@pytest.mark.parametrize("shape,spectra", TARGET_GRAD_CASES,
                         ids=["128", "128-spectra", "96", "74", "74-spectra", "94",
                              "94-spectra", "160x180", "251", "251-spectra"])
def test_conv_lnl_residuals_and_backward_with_targets_match_plain(cuda, shape, spectra):
    """The residual forward and the backward with the target axis (the
    hierarchical fit's gradient): per-target planes on the radix-2,
    mixed-radix, padded and cluster routes, per-target spectra on the
    FFT, padded and cluster routes.  The residual instantiation's lnL bits are the
    forward's, counted on ``"<route>_res_targets"``, its weights within
    1e-6 of each walker's largest weight (or 4x the float32 plain
    scheme's error) of the float64 plain scheme; the backward, counted on
    ``batched_conv_lnl_backward``'s ``"<route>_targets"``, within 1e-3 of
    each walker's largest pixel gradient of the float64 plain backward;
    each target's rows the bits of a launch with that target's own
    constants; autograd through ``batched_conv_lnl`` the same bits as the
    explicit calls."""
    nt = 4
    consts, c64, raws = _target_stack(shape, cuda, nt, spectra, seed=11)
    route = CL.conv_route(shape)
    lnl, residuals = CL.batched_conv_lnl(raws, consts), None
    if route != "dft":
        routes = dict(CL.batched_conv_lnl.route_launches)
        got, weights, scale_exp = CL.batched_conv_lnl_residuals(raws, consts)
        torch.cuda.synchronize()
        routes[route + "_res_targets"] += 1
        assert CL.batched_conv_lnl.route_launches == routes
        _same_bits(got, lnl)
        plain = (CL.packed_fft_conv_residuals_plain if route == "fft"
                 else CL.padded_fft_conv_residuals_plain)
        _, w64, e64 = plain(raws.double().cpu(), c64)
        _, w32, _ = plain(raws, consts)
        want = w64.to(cuda)
        scale = want.abs().amax(dim=(1, 2))
        err = (weights.double() - want).abs().amax(dim=(1, 2)) / scale
        plain_err = (w32.double() - want).abs().amax(dim=(1, 2)) / scale
        assert torch.all(err <= (4 * plain_err).clamp(min=1e-6))
        assert (scale_exp.cpu() - e64).abs().max().item() <= 1
        residuals = (weights, scale_exp)
    grad = torch.as_tensor(np.random.RandomState(4).uniform(0.5, 2.0, len(raws)),
                           dtype=torch.float32, device=cuda)
    routes = dict(CL.batched_conv_lnl_backward.route_launches)
    back = CL.batched_conv_lnl_backward(raws, consts, lnl, grad, residuals)
    torch.cuda.synchronize()
    routes[route + "_targets"] += 1
    assert CL.batched_conv_lnl_backward.route_launches == routes
    want_back = CL.batched_conv_lnl_backward_plain(
        raws.double().cpu(), c64, lnl.double().cpu(), grad.double().cpu()).to(cuda)
    assert torch.isfinite(lnl).all()
    assert _normalized_err(back, want_back, dims=(1, 2)) <= 1e-3
    for t in range(nt):
        rows = slice(t * 6, (t + 1) * 6)
        one = CL.make_conv_lnl_consts(
            (c64.psf_r[t] + 1j * c64.psf_i[t]).numpy() if spectra
            else (c64.psf_r + 1j * c64.psf_i).numpy(),
            (c64.var_r[t] + 1j * c64.var_i[t]).numpy() if spectra
            else (c64.var_r + 1j * c64.var_i).numpy(),
            c64.obs[t].numpy(), c64.obs_var[t].numpy(), c64.good[t].numpy(), cuda)
        res_t = None
        if residuals is not None:
            _, *res_t = CL.batched_conv_lnl_residuals(raws[rows], one)
            for x, y in zip(res_t, (r[rows] for r in residuals)):
                _same_bits(x, y)
        _same_bits(back[rows], CL.batched_conv_lnl_backward(raws[rows], one, lnl[rows],
                                                            grad[rows], res_t))
    leaf = raws.clone().requires_grad_(True)
    (CL.batched_conv_lnl(leaf, consts) * grad).sum().backward()
    _same_bits(leaf.grad, back)


def _batch_counts():
    return (SR.render_sersics.launches, CL.batched_conv_lnl.launches,
            CL.batched_conv_lnl.route_launches["fft_targets"])


@pytest.mark.parametrize("moves", ["stretch", "mixed"])
def test_fit_batch_graphed_is_bit_identical_to_eager(cuda, moves):
    """A chunked batch fit (5 targets in chunks of 2, the last padded):
    three captures reused by every chunk, one replay a step, the render and
    conv_lnl once a half-step and at each chunk's start; the eager fit
    equal bit for bit; swapping two targets of different chunks changes
    exactly their rows."""
    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch.models import MultiComponentModel

    model = MultiComponentModel(flagship_components((64, 64), (32, 32)), device=cuda)
    obs, ivm, _ = BF.simulate_stack(model, 5, seed=1)
    kw = dict(nwalkers=40, burn=3, iterations=4, record_every=2, chunk=2, moves=moves,
              seed=7)
    fns = model.posterior_fns
    before = _batch_counts()
    res = BF.fit_batch(model, obs, ivm, **kw)
    torch.cuda.synchronize()
    _, program = fns.__dict__["_batch_program"]
    assert program.captures == 3 and program.replays == 3 * 7
    evals = 3 * (1 + 2 * 7)
    assert _batch_counts() == (before[0] + evals, before[1] + evals, before[2] + evals)
    swapped = obs.copy()
    swapped[[0, 4]] = swapped[[4, 0]]
    other = BF.fit_batch(model, swapped, ivm, **kw)
    assert fns.__dict__["_batch_program"][1] is program and program.captures == 3
    assert [not np.array_equal(other.mean[i], res.mean[i]) for i in range(5)] == [
        True, False, False, False, True]
    with BF._eager():
        eager = BF.fit_batch(model, obs, ivm, **kw)
    for name in ("mean", "std", "map_theta", "map_lnp", "acceptance", "chains", "lnprob"):
        assert np.array_equal(getattr(res, name), getattr(eager, name), equal_nan=True), name


def test_fit_batch_keeps_one_program_on_the_card(cuda):
    """Two chunk shapes in turn leave one program cached: the first one,
    its graphs and buffers, is freed when the second replaces it, with no
    collection."""
    import weakref

    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch.models import MultiComponentModel

    model = MultiComponentModel(flagship_components((64, 64), (32, 32)), device=cuda)
    obs, ivm, _ = BF.simulate_stack(model, 6, seed=1)
    fns = model.posterior_fns
    kw = dict(nwalkers=40, burn=2, iterations=2, record_every=2, seed=7)
    BF.fit_batch(model, obs, ivm, chunk=3, **kw)
    torch.cuda.synchronize()
    first_key, first = fns.__dict__["_batch_program"]
    assert first.captures == 3
    gone = weakref.ref(first)
    del first
    BF.fit_batch(model, obs, ivm, chunk=2, **kw)
    torch.cuda.synchronize()
    key, program = fns.__dict__["_batch_program"]
    assert gone() is None
    assert key != first_key and program.captures == 3
    assert program.state.positions.shape[0] == 2


def test_batch_posterior_on_the_card_matches_the_cpu(cuda):
    """log_posterior_obs on the card (float32; the kernel path, at 94x94
    on the cluster route with per-target spectra too) against the CPU's
    float64."""
    from psfmc_tpu_torch import batchfit as BF
    from psfmc_tpu_torch.models import MultiComponentModel

    for shape, psf_shape in (((64, 64), (32, 32)), ((94, 94), (48, 48))):
        comps = flagship_components(shape, psf_shape)
        card = MultiComponentModel(comps, device=cuda)
        cpu = MultiComponentModel(flagship_components(shape, psf_shape), device="cpu",
                                  dtype=torch.float64)
        obs, ivm, _ = BF.simulate_stack(cpu, 3, seed=2)
        yy, xx = np.mgrid[0:psf_shape[0], 0:psf_shape[1]].astype(float)
        stars = [np.exp(-((xx - psf_shape[1] / 2) ** 2 + (yy - psf_shape[0] / 2) ** 2)
                        / (2 * s * s)) for s in (1.6, 2.0, 2.4)]
        ivms = [np.full(psf_shape, 1e8)] * 3
        th = prior_draws(card.spec, 12, seed=3)
        for survey in (False, True):
            stacks = []
            for m, dt in ((card, np.float32), (cpu, np.float64)):
                d = BF.prepare_obs_stack(m.spec, obs, ivm, dt)
                if survey:
                    d.update(BF.prepare_psf_stack(m.spec, stars, ivms, dtype=dt))
                stacks.append(m.posterior_fns.prepare_obs(d))
            want_mode = "general" if survey and CL.conv_route(shape) == "dft" else "batched"
            assert stacks[0].mode == stacks[1].mode == want_mode
            got = card.posterior_fns.log_posterior_obs(th, stacks[0]).double().cpu()
            want = cpu.posterior_fns.log_posterior_obs(th, stacks[1])
            assert _same_nonfinite(got, want)
            fin = torch.isfinite(want)
            assert ((got[fin] - want[fin]).abs() / want[fin].abs()).max().item() <= 1e-4
