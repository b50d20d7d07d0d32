"""The schemes of the two backward kernels, in plain PyTorch on the CPU.

``csrc/sersic_render_backward.cu`` sums each thread's pixels in float32
over chunks of at most 32 and widens to float64 above that;
``render_sersics_backward_order_plain`` is that order of summation over
the kernel's own pixel assignment, held here against the float64 version
of record.  ``csrc/conv_lnl_backward.cu`` reads the weights and scale
exponents that the forward's residual instantiation wrote;
``packed_fft_conv_residuals_plain`` and
``packed_fft_conv_backward_from_residuals_plain`` are that scheme, held
against ``batched_conv_lnl_backward_plain`` (``padded_fft_conv_*`` on the
padded route: the same pair at the zero-padded transform, the fold's
adjoint and the crop).  The kernels themselves run
only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import sersic_render as SR

RENDER_BWD_TOL = 1e-4  # chip_smoke.py's bar: of each walker's largest gradient


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(seed, batch, count, shape):
    """(B, S, 9) float32 packed rows and (B,) sky: indices 0.5-8, radii
    0.5-60 px, walker 1 NaN, walker 2's first Sersic on a pixel centre
    (both clamps)."""
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
    p[1] = np.nan
    p[2, 0, :2] = (3.0, 2.0)
    return (torch.as_tensor(p, dtype=torch.float32),
            torch.as_tensor(rng.uniform(0.0, 0.1, batch), dtype=torch.float32))


@pytest.mark.parametrize("batch,shape", [(125, (128, 128)), (6, (16, 16)), (6, (20, 17))],
                         ids=["125x128", "16", "20x17"])
def test_render_backward_order_matches_float64(batch, shape):
    """The kernel's order of summation (float32 per thread over at most 32
    of its pixels, then float64) with its formulas (two reciprocals) on
    float32 rows, 2 Sersics: within 1e-4 of each walker's largest
    gradient of the float64 version of record, the sky within 1e-6; the
    same non-finite entries as the float32 version of record.  At the
    small shapes also chip_smoke.py's per-scalar bar: per walker and
    packed scalar within the larger of 1e-4 of its largest gradient and
    4x the float32 version of record's own error."""
    params, sky = _rows(31, batch, 2, shape)
    grad = torch.as_tensor(np.random.RandomState(3).randn(batch, *shape),
                           dtype=torch.float32)
    g_params, g_sky = SR.render_sersics_backward_order_plain(params, sky, shape, grad)
    assert g_params.dtype == torch.float32 and g_params.shape == params.shape
    p64, s64 = SR.render_sersics_backward_plain(params.double(), sky.double(), shape,
                                                grad.double())
    assert torch.equal(torch.isnan(g_params), torch.isnan(p64))
    keep = torch.isfinite(p64).all(dim=(1, 2))
    assert keep.sum().item() == batch - 1  # walker 1 is NaN
    err = (g_params[keep].double() - p64[keep]).abs().amax(dim=(1, 2))
    assert torch.all(err <= RENDER_BWD_TOL * p64[keep].abs().amax(dim=(1, 2)))
    assert torch.all((g_sky.double() - s64).abs() <= 1e-6 * s64.abs())
    if batch > 6:
        return
    p32, _ = SR.render_sersics_backward_plain(params, sky, shape, grad)
    assert torch.equal(torch.isfinite(g_params), torch.isfinite(p32))
    scale = p64[keep].abs().amax(dim=1)
    err_k = (g_params[keep].double() - p64[keep]).abs().amax(dim=1) / scale
    plain_k = (p32[keep].double() - p64[keep]).abs().amax(dim=1) / scale
    assert torch.all(err_k <= (4 * plain_k).clamp(min=RENDER_BWD_TOL))


@pytest.mark.parametrize("batch,shape", [(125, (128, 128)), (64, (128, 128)),
                                         (1, (128, 128)), (125, (45, 37)),
                                         (6, (20, 17)), (6, (16, 16)), (250, (512, 512))])
def test_backward_strips(batch, shape):
    """The render backward's launch geometry: what the C launch accepts
    (1 to 8 strips of a multiple of 256 pixels, which cover the image and
    each hold a pixel); at the MAP path's shapes (64 and 125 walkers,
    128x128) one wave of the H100 at two blocks per SM, filled to 0.9 or
    more, and at most 32 pixels a thread (one float32 chunk)."""
    strips, per_strip = SR.backward_strips(batch, shape)
    hw = shape[0] * shape[1]
    assert 1 <= strips <= SR.BACKWARD_MAX_STRIPS and per_strip % SR.BACKWARD_THREADS == 0
    assert (strips - 1) * per_strip < hw <= strips * per_strip
    if shape == (128, 128) and batch in (64, 125):
        wave = 2 * SR.SM_COUNT
        assert 0.9 * wave <= batch * strips <= wave
        assert per_strip // SR.BACKWARD_THREADS <= SR.BACKWARD_CHUNK


@pytest.fixture(scope="module")
def fft_posts():
    out = {}
    for shape in ((16, 16), (24, 20), (28, 42)):
        spec = build_model_spec(flagship_components(shape, (8, 8)))
        out[shape] = build_posterior(spec, device="cpu", dtype=torch.float64,
                                     lnpost="batched")
    return out


@pytest.mark.parametrize("shape", [(16, 16), (24, 20), (28, 42)],
                         ids=["radix2", "mixed", "radix7"])
def test_residual_scheme_matches_the_backward_of_record(fft_posts, shape):
    """The FFT route's residual forward and its backward from the
    residuals, in float64: the lnL within 1e-10 of the version of record,
    the backward within rtol 1e-10 of ``batched_conv_lnl_backward_plain``
    (normalized by the batch's largest gradient), a NaN walker's lnL
    ``-inf`` and its gradient zero, int32 scale exponents within +-96;
    the composed ``packed_fft_conv_backward_plain`` is the same."""
    post = fft_posts[shape]
    assert CL.conv_route(shape) == "fft"
    th = prior_draws(post.spec, 6, seed=9)
    raws = post.raw_and_ps(th)[0].detach()
    raws[1, 3, 4] = float("nan")
    grad = torch.as_tensor(np.random.RandomState(3).uniform(0.5, 2.0, 6))
    want_lnl = CL.batched_conv_lnl_plain(raws, post.consts)
    lnl, weights, scale_exp = CL.packed_fft_conv_residuals_plain(raws, post.consts)
    assert weights.shape == (6, *shape, 2) and scale_exp.dtype == torch.int32
    assert torch.isneginf(lnl[1]) and torch.isneginf(want_lnl[1])
    assert scale_exp.abs().max().item() <= 96 and scale_exp[1].item() == 0
    keep = [0, 2, 3, 4, 5]
    torch.testing.assert_close(lnl[keep], want_lnl[keep], rtol=1e-10, atol=0.0)
    got = CL.packed_fft_conv_backward_from_residuals_plain(
        raws, post.consts, lnl, grad, weights, scale_exp)
    want = CL.batched_conv_lnl_backward_plain(raws, post.consts, want_lnl, grad)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10 * want.abs().max().item())
    composed = CL.packed_fft_conv_backward_plain(raws, post.consts, lnl, grad)
    assert torch.equal(composed, got)


def test_residual_weights_and_exponent(fft_posts):
    """The weights are the likelihood's derivatives: ``a = dlnL/dconv``
    and ``c = dlnL/dmvar`` (against autograd through the Gaussian lnL of
    the same ``conv`` and ``mvar``); the exponent is ``e_a - e_c`` of the
    two parts' peaks, which gives ``a`` and ``2^e c`` peaks in the same
    binade."""
    post = fft_posts[(16, 16)]
    th = prior_draws(post.spec, 4, seed=2)
    raws = post.raw_and_ps(th)[0].detach()
    c = post.consts
    conv, mvar = CL.packed_fft_conv_plain(raws, c)
    conv, mvar = conv.requires_grad_(True), mvar.requires_grad_(True)
    lnl = -0.5 * torch.where(c.good, (c.obs - conv) ** 2 / (mvar + c.obs_var)
                             + torch.log(2 * np.pi * (mvar + c.obs_var)),
                             torch.zeros_like(conv)).sum(dim=(-2, -1))
    da, dc = torch.autograd.grad(lnl.sum(), (conv, mvar))
    _, weights, scale_exp = CL.packed_fft_conv_residuals_plain(raws, c)
    torch.testing.assert_close(weights[..., 0], da, rtol=1e-10,
                               atol=1e-12 * da.abs().max().item())
    torch.testing.assert_close(weights[..., 1], dc, rtol=1e-10,
                               atol=1e-12 * dc.abs().max().item())
    peak_a = weights[..., 0].abs().amax(dim=(-2, -1))
    peak_c = torch.ldexp(weights[..., 1].abs().amax(dim=(-2, -1)), scale_exp)
    assert torch.equal(torch.frexp(peak_a)[1], torch.frexp(peak_c)[1])


@pytest.fixture(scope="module")
def padded_posts():
    out = {}
    for shape in ((15, 21), (13, 37), (24, 37), (15, 13)):
        spec = build_model_spec(flagship_components(shape, (8, 8)))
        out[shape] = build_posterior(spec, device="cpu", dtype=torch.float64,
                                     lnpost="batched")
    return out


@pytest.mark.parametrize("shape", [(15, 21), (13, 37), (24, 37)],
                         ids=["odd", "prime", "one-side"])
def test_padded_residual_scheme_matches_the_backward_of_record(padded_posts, shape):
    """The padded route's residual forward and its backward from the
    residuals, in float64: the lnL within 1e-10 of the version of record,
    the backward within rtol 1e-10 of ``batched_conv_lnl_backward_plain``
    (normalized by the batch's largest gradient), a NaN walker's lnL
    ``-inf`` and its gradient zero, int32 scale exponents within +-96:
    odd sides (15x21 -> 30x42), a prime side (13x37 -> 28x80) and one side
    padded (24x37 -> 24x80)."""
    post = padded_posts[shape]
    assert CL.conv_route(shape) == "padded"
    th = prior_draws(post.spec, 6, seed=9)
    raws = post.raw_and_ps(th)[0].detach()
    raws[1, 3, 4] = float("nan")
    grad = torch.as_tensor(np.random.RandomState(3).uniform(0.5, 2.0, 6))
    want_lnl = CL.batched_conv_lnl_plain(raws, post.consts)
    lnl, weights, scale_exp = CL.padded_fft_conv_residuals_plain(raws, post.consts)
    assert weights.shape == (6, *shape, 2) and scale_exp.dtype == torch.int32
    assert torch.isneginf(lnl[1]) and torch.isneginf(want_lnl[1])
    assert scale_exp.abs().max().item() <= 96 and scale_exp[1].item() == 0
    keep = [0, 2, 3, 4, 5]
    torch.testing.assert_close(lnl[keep], want_lnl[keep], rtol=1e-10, atol=0.0)
    got = CL.padded_fft_conv_backward_from_residuals_plain(
        raws, post.consts, lnl, grad, weights, scale_exp)
    want = CL.batched_conv_lnl_backward_plain(raws, post.consts, want_lnl, grad)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10 * want.abs().max().item())


def test_residual_wrapper_on_the_cpu(fft_posts, padded_posts):
    """On the CPU ``batched_conv_lnl_residuals`` is the plain scheme of
    the route (the FFT route's at 24x20, the padded route's at 15x13) and
    ``batched_conv_lnl_backward`` the version of record whatever residuals
    it is given; a shape on the matmul-DFT route (1x64: a side of 1, which
    no other route takes) raises."""
    post = fft_posts[(24, 20)]
    raws = post.raw_and_ps(prior_draws(post.spec, 3, seed=4))[0].detach()
    out = CL.batched_conv_lnl_residuals(raws, post.consts)
    for x, y in zip(out, CL.packed_fft_conv_residuals_plain(raws, post.consts)):
        assert torch.equal(x, y)
    grad = torch.ones(3, dtype=torch.float64)
    lnl = out[0]
    assert torch.equal(
        CL.batched_conv_lnl_backward(raws, post.consts, lnl, grad, out[1:]),
        CL.batched_conv_lnl_backward_plain(raws, post.consts, lnl, grad))
    padded = padded_posts[(15, 13)]
    raws = padded.raw_and_ps(prior_draws(padded.spec, 3, seed=4))[0].detach()
    assert CL.conv_route((15, 13)) == "padded"
    for x, y in zip(CL.batched_conv_lnl_residuals(raws, padded.consts),
                    CL.padded_fft_conv_residuals_plain(raws, padded.consts)):
        assert torch.equal(x, y)
    rng = np.random.RandomState(5)
    shape = (1, 64)
    spectrum = np.fft.rfft2(rng.rand(*shape))
    dft = CL.make_conv_lnl_consts(spectrum, spectrum * 1e-3, rng.randn(*shape),
                                  rng.rand(*shape) + 1.0, np.ones(shape, bool), "cpu",
                                  torch.float64)
    assert CL.conv_route(shape) == "dft"
    with pytest.raises(ValueError, match="is on the matmul-DFT route"):
        CL.batched_conv_lnl_residuals(torch.as_tensor(rng.rand(2, *shape)), dft)
