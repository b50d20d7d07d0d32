"""The FFT route of the port's likelihood kernels, in its plain versions.

The CUDA kernels of ``csrc/fft_conv.cuh`` run only on the card; what runs
here is their scheme written once more in plain PyTorch
(``packed_fft_conv_plain``) and their butterfly schedule
(``fft_stages_plain``), held against ``torch.fft``, against the JAX
package's convolutions and against its batched conv+lnL Pallas kernel in
interpret mode.  Inputs come from numpy seeds; every tolerance is stated
where it is asserted (``jax_enable_x64`` is on in this suite).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.ops import fourier as jfourier
from psfmc_tpu.ops.pallas.lnpost_batched import make_batched_conv_lnl
from psfmc_tpu_torch.ops import fourier as tfourier
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.likelihood import gaussian_lnlike

from test_torch_kernels import _jax_flagship_spec

SHAPES = [(16, 16), (32, 32), (16, 64), (64, 8)]
DTYPES = {"f64": (np.float64, torch.float64, torch.complex128),
          "f32": (np.float32, torch.float32, torch.complex64)}


def _complex_images(seed, shape, cdt):
    rng = np.random.RandomState(seed)
    z = rng.randn(3, *shape) + 1j * rng.randn(3, *shape)
    return torch.as_tensor(z).to(cdt)


def _twiddles(shape, np_dt):
    return torch.as_tensor(CL.fft_twiddles(max(shape), np_dt))


@pytest.mark.parametrize("n", [2, 8, 128, 512])
def test_twiddle_table_is_float64_cos_sin(n):
    k = np.arange(n // 2)
    want = np.stack([np.cos(2 * np.pi * k / n), -np.sin(2 * np.pi * k / n)], 1)
    np.testing.assert_array_equal(CL.fft_twiddles(n, np.float64), want)
    # the float32 table is the float64 one, rounded once
    np.testing.assert_array_equal(CL.fft_twiddles(n), want.astype(np.float32))
    assert CL.fft_twiddles(n).shape == (n // 2, 2)


def test_twiddle_table_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        CL.fft_twiddles(96)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_fft_stages_forward_matches_fft2(shape, dt):
    np_dt, _, cdt = DTYPES[dt]
    z = _complex_images(31, shape, cdt)
    got = CL.fft_stages_plain(z, _twiddles(shape, np_dt))
    # bin (ky, kx) sits at the bit-reversed row and column
    rows, cols = CL.bit_reversed(shape[0]), CL.bit_reversed(shape[1])
    got = got[..., rows, :][..., cols]
    want = torch.fft.fft2(z)
    # float64: rtol 1e-12 of the spectrum's peak; float32: 2e-6 (log2 N
    # stages of float32 rounding)
    tol = 1e-12 if dt == "f64" else 2e-6
    peak = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * peak)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_fft_stages_inverse_undoes_forward(shape, dt):
    np_dt, _, cdt = DTYPES[dt]
    z = _complex_images(32, shape, cdt)
    tw = _twiddles(shape, np_dt)
    spectrum = CL.fft_stages_plain(z, tw)
    back = CL.fft_stages_plain(spectrum, tw, inverse=True) / (shape[0] * shape[1])
    tol = 1e-12 if dt == "f64" else 4e-6
    torch.testing.assert_close(back, z, rtol=tol, atol=tol * z.abs().max().item())
    # and on its own: the inverse of a bit-reversed fft2 is H W ifft2
    rows, cols = CL.bit_reversed(shape[0]), CL.bit_reversed(shape[1])
    permuted = torch.fft.fft2(z)[..., rows, :][..., cols]
    back = CL.fft_stages_plain(permuted, tw, inverse=True) / (shape[0] * shape[1])
    torch.testing.assert_close(back, z, rtol=tol, atol=tol * z.abs().max().item())


def test_fft_stages_serve_a_line_shorter_than_the_table():
    """One table of max(H, W) serves both axes: a line of length N reads
    every (M/N)-th entry."""
    z = _complex_images(33, (8, 64), torch.complex128)
    small = CL.fft_stages_plain(z, torch.as_tensor(CL.fft_twiddles(64, np.float64)))
    large = CL.fft_stages_plain(z, torch.as_tensor(CL.fft_twiddles(256, np.float64)))
    torch.testing.assert_close(small, large, rtol=1e-14, atol=1e-13)


def test_bit_reversed_is_an_involution():
    for n in (2, 16, 128):
        idx = CL.bit_reversed(n)
        assert sorted(idx) == list(range(n))
        np.testing.assert_array_equal(idx[idx], np.arange(n))
    np.testing.assert_array_equal(CL.bit_reversed(8), [0, 4, 2, 6, 1, 5, 3, 7])


def _consts(rng, shape, t_dt, psf_var_level=1e-8):
    h, w = shape
    psf = np.exp(-((np.mgrid[0:8, 0:8] - 4.0) ** 2).sum(0) / (2 * 1.5**2))
    psf /= psf.sum()
    f_psf = tfourier.pad_and_rfft_image(psf, shape)
    f_var = tfourier.pad_and_rfft_image(np.full_like(psf, psf_var_level), shape)
    good = np.ones(shape, bool)
    good[1, 2] = False
    consts = CL.make_conv_lnl_consts(
        f_psf, f_var, 0.1 + 0.01 * rng.randn(h, w), np.full(shape, 1e-4), good,
        "cpu", t_dt)
    return consts, f_psf, f_var


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_packed_fft_conv_matches_jax_convolutions(shape, dt):
    np_dt, t_dt, _ = DTYPES[dt]
    rng = np.random.RandomState(34)
    consts, f_psf, f_var = _consts(rng, shape, t_dt)
    raws = (0.05 + np.abs(rng.randn(3, *shape))).astype(np_dt)
    conv, mvar = CL.packed_fft_conv_plain(torch.as_tensor(raws), consts)
    # rtol 1e-9 in f64, 1e-5 in f32, relative to each image's peak
    tol = 1e-9 if dt == "f64" else 1e-5
    mats = tuple(jnp.asarray(m) for m in tfourier.rdft_matrices(shape, np_dt))
    for got, img, fk in ((conv, raws, f_psf), (mvar, raws * raws, f_var)):
        want = np.asarray(jfourier.convolve(jnp.asarray(img), jnp.asarray(fk)))
        want_rdft = np.asarray(jfourier.convolve_rdft(
            jnp.asarray(img), jnp.asarray(fk.real.astype(np_dt)),
            jnp.asarray(fk.imag.astype(np_dt)), mats))
        peak = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * peak)
        np.testing.assert_allclose(got.numpy(), want_rdft, rtol=tol,
                                   atol=tol * peak)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_packed_fft_conv_keeps_the_small_part_exact(dt):
    """An image whose square is 1e6 times its peak, a PSF variance map
    1e-8 of the PSF: both parts of the one complex image keep their own
    relative accuracy (the power-of-two scales ``s`` and ``g``)."""
    np_dt, t_dt, _ = DTYPES[dt]
    shape = (32, 32)
    rng = np.random.RandomState(35)
    consts, f_psf, f_var = _consts(rng, shape, t_dt)
    raws = (1.0 + np.abs(rng.randn(2, *shape))).astype(np_dt)
    raws[:, 16, 16] = 1e6  # a bright point source: raw^2 peaks at 1e12
    conv, mvar = CL.packed_fft_conv_plain(torch.as_tensor(raws), consts)
    tol = 1e-9 if dt == "f64" else 1e-5
    for got, img, fk in ((conv, raws, f_psf), (mvar, raws * raws, f_var)):
        want = np.asarray(jfourier.convolve(jnp.asarray(img.astype(np.float64)),
                                            jnp.asarray(fk)))
        np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    assert consts.var_gain.item() == 2.0 ** 21  # 1 / (64 x 1e-8) = 1.56e6


def test_var_spectrum_gain_is_a_power_of_two():
    one = np.ones((4, 3), complex)
    assert CL.var_spectrum_gain(one, one * 4e-5) == 2.0 ** 15
    assert CL.var_spectrum_gain(one, one * 3.0) == 0.25
    assert CL.var_spectrum_gain(one, one * 0.0) == 2.0 ** 96  # clamped
    assert CL.var_spectrum_gain(one * 0.0, one) == 1.0
    assert CL.var_spectrum_gain(one * np.nan, one) == 1.0


def test_packed_fft_conv_non_finite_walkers():
    """A NaN walker and a walker whose square overflows float32 come out
    non-finite, the others untouched, and the lnL is -inf on exactly the
    walkers where the plain version's is."""
    shape = (16, 16)
    rng = np.random.RandomState(36)
    consts, _, _ = _consts(rng, shape, torch.float32)
    raws = (0.1 + np.abs(rng.randn(5, *shape))).astype(np.float32)
    raws[1, 3, 4] = np.nan
    raws[3, 5, 6] = 1e30  # finite, its square is not
    raws_t = torch.as_tensor(raws)
    conv, mvar = CL.packed_fft_conv_plain(raws_t, consts)
    bad = ~(torch.isfinite(conv) & torch.isfinite(mvar)).all(dim=(-2, -1))
    assert bad.tolist() == [False, True, False, True, False]
    lnl = gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                          consts.good)
    want = CL.batched_conv_lnl_plain(raws_t, consts)
    assert torch.equal(torch.isfinite(lnl), torch.isfinite(want))
    assert lnl[1] == -np.inf and lnl[3] == -np.inf
    fin = torch.isfinite(want)
    torch.testing.assert_close(lnl[fin], want[fin], rtol=1e-5, atol=0.0)
    # an all-zero walker takes the scale 1 and convolves to zero
    conv, mvar = CL.packed_fft_conv_plain(torch.zeros((1, *shape)), consts)
    assert not conv.any() and not mvar.any()


def test_packed_fft_lnl_matches_pallas_batched(monkeypatch):
    """The lnL through the FFT scheme against the JAX package's batched
    conv+lnL Pallas kernel (interpret mode, true-fp32 products)."""
    monkeypatch.setenv("PSFMC_LNPOST_DOT", "highest")
    rng = np.random.RandomState(37)
    spec = _jax_flagship_spec(rng)  # 32x32: the FFT route's shape class
    constants = jax_posterior(spec).constants
    raws = (0.1 + np.abs(rng.randn(6, *spec.shape)) * 0.5).astype(np.float32)
    lnl_jax = make_batched_conv_lnl(constants, spec, jnp.float32, tile=4)
    want = np.asarray(lnl_jax(jnp.asarray(raws)))

    consts = CL.make_conv_lnl_consts(
        spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
        spec.obs_var, ~spec.bad_px, "cpu", torch.float32,
    )
    assert CL.conv_route(consts.shape) == "fft"
    conv, mvar = CL.packed_fft_conv_plain(torch.as_tensor(raws), consts)
    got = gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                          consts.good).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)  # float32 both sides

    # the butterfly schedule in place of torch.fft: the same lnL
    tw = consts.twiddle
    h, w = consts.shape
    z = torch.complex(torch.as_tensor(raws), torch.zeros_like(torch.as_tensor(raws)))
    staged = CL.fft_stages_plain(CL.fft_stages_plain(z, tw), tw, inverse=True)
    np.testing.assert_allclose(staged.real.numpy() / (h * w), raws, rtol=1e-5,
                               atol=1e-5 * raws.max())


@pytest.mark.parametrize("shape,route", [
    ((128, 128), "fft"), ((64, 64), "fft"), ((64, 128), "fft"),
    ((64, 256), "fft"), ((256, 64), "fft"), ((16, 16), "fft"),
    ((32, 512), "fft"), ((2, 2), "fft"),
    ((45, 37), "dft"), ((96, 96), "dft"), ((100, 100), "dft"),
    ((144, 144), "dft"), ((128, 96), "dft"), ((1, 64), "dft"),
    # powers of two, but one walker does not fit in a block
    ((128, 256), "dft"), ((256, 256), "dft"), ((512, 512), "dft"),
], ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_conv_route_is_a_function_of_the_shape(shape, route):
    assert CL.conv_route(shape) == route
    if route == "fft":
        assert CL.fft_smem_bytes(shape) <= CL.BLOCK_SMEM_LIMIT


def test_fft_route_needs_less_shared_memory_than_the_three_buffers():
    """At the square and moderately oblong shapes the fused kernel's FFT
    route needs less than the matmul-DFT route's three buffers would, so
    ``fused_lnl_supported`` keeps the answers it gave before the FFT
    route."""
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    assert CL.fft_smem_bytes((128, 128)) == 8 * (128 * 129 + 64)
    for shape in [(128, 128), (64, 64), (64, 256), (256, 64), (16, 16)]:
        assert CL.conv_route(shape) == "fft"
        assert (FL.fused_lnl_fft_smem_bytes(shape, 2, 1)
                < FL.fused_lnl_smem_bytes(shape, 2, 1))


@pytest.mark.parametrize("shape,route,ok", [
    ((128, 128), "fft", True), ((64, 256), "fft", True),
    # tall and narrow: the padded half spectra of the three buffers would
    # not fit (245,760 B), the one complex image does (155,648 B)
    ((2048, 8), "fft", True),
    ((96, 96), "dft", True), ((136, 136), "dft", True),
    ((144, 144), "dft", False), ((256, 256), "dft", False),
], ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_fused_gate_measures_the_route_the_shape_takes(shape, route, ok):
    from types import SimpleNamespace

    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    kinds = ("sky", "sersic", "sersic", "pointsource")
    spec = SimpleNamespace(
        shape=shape,
        comp_specs=[SimpleNamespace(kind=k, params=()) for k in kinds])
    assert CL.conv_route(shape) == route
    got, why = FL.fused_lnl_supported(spec)
    assert got == ok
    if not ok:
        assert "shared memory" in why and f"the {route} route" in why
    measure = (FL.fused_lnl_fft_smem_bytes if route == "fft"
               else FL.fused_lnl_smem_bytes)
    limit = (FL.FUSED_FFT_SMEM_LIMIT if route == "fft"
             else FL.FUSED_SMEM_LIMIT)
    assert (measure(shape, 2, 1) <= limit) == ok


def test_consts_carry_the_twiddles_only_for_powers_of_two():
    rng = np.random.RandomState(38)
    consts, _, _ = _consts(rng, (16, 64), torch.float32)
    assert tuple(consts.twiddle.shape) == (32, 2)
    assert consts.twiddle.dtype == torch.float32
    consts, _, _ = _consts(rng, (24, 20), torch.float32)
    assert tuple(consts.twiddle.shape) == (0, 2)
    assert CL.conv_route(consts.shape) == "dft"
    # a CPU tensor takes the plain version on either route, uncounted
    before = dict(CL.batched_conv_lnl.route_launches)
    CL.batched_conv_lnl(torch.ones((2, 24, 20)), consts)
    assert CL.batched_conv_lnl.route_launches == before
