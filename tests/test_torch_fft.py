"""The FFT route of the port's likelihood kernels, in its plain versions.

The CUDA kernels of ``csrc/fft_conv.cuh`` run only on the card; what runs
here is their scheme written once more in plain PyTorch
(``packed_fft_conv_plain``; ``padded_fft_conv_plain`` on the padded
route, the same pair on the zero-padded image with the fold at the
readout) and their butterfly schedule
(``fft_stages_plain``: radix-2 stages for powers of two, radix-2, -3, -5
and -7 stages in ``fft_plan``'s order otherwise), held against ``torch.fft``,
against the JAX package's convolutions and against its batched conv+lnL
Pallas kernel in interpret mode.  Inputs come from numpy seeds; every tolerance is stated
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
# even sides with factors 3, 5 and 7: the mixed-radix geometry of the route
MIXED_SHAPES = [(96, 96), (100, 100), (96, 128), (144, 144), (24, 20),
                (14, 28), (98, 98)]
DTYPES = {"f64": (np.float64, torch.float64, torch.complex128),
          "f32": (np.float32, torch.float32, torch.complex64)}


def _complex_images(seed, shape, cdt):
    rng = np.random.RandomState(seed)
    z = rng.randn(3, *shape) + 1j * rng.randn(3, *shape)
    return torch.as_tensor(z).to(cdt)


def _twiddles(shape, np_dt):
    """The twiddle array the kernel reads at ``shape``."""
    return torch.as_tensor(CL.fft_tables(shape, np_dt)[0])


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("n", [2, 8, 128, 512, 6, 20, 24, 96, 100, 144, 14, 98])
def test_twiddle_table_is_float64_cos_sin(n):
    """Half the circle for a power of two; off powers of two all ``n``
    roots (a radix-3, -5 or -7 stage's output ``p`` reads entry ``p j``)."""
    entries = n // 2 if n & (n - 1) == 0 else n
    k = np.arange(entries)
    want = np.stack([np.cos(2 * np.pi * k / n), -np.sin(2 * np.pi * k / n)], 1)
    np.testing.assert_array_equal(CL.fft_twiddles(n, np.float64), want)
    # the float32 table is the float64 one, rounded once
    np.testing.assert_array_equal(CL.fft_twiddles(n), want.astype(np.float32))
    assert CL.fft_twiddles(n).shape == (entries, 2)


def test_twiddle_table_needs_a_power_of_two():
    """The table needs an even size with no prime factor above 7 (a
    power of two, or 96, 100, 98, ...); 88, 45 and 74 have none (the
    padded route builds the table of the side it pads them to)."""
    for n in (88, 45, 74, 7):
        with pytest.raises(ValueError, match="7-smooth"):
            CL.fft_twiddles(n)
    assert CL.fft_twiddles(96).shape == (96, 2)
    assert CL.fft_twiddles(98).shape == (98, 2)


@pytest.mark.parametrize("shape", SHAPES + MIXED_SHAPES, ids=_ids)
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_fft_stages_forward_matches_fft2(shape, dt):
    np_dt, _, cdt = DTYPES[dt]
    z = _complex_images(31, shape, cdt)
    got = CL.fft_stages_plain(z, _twiddles(shape, np_dt))
    # bin (ky, kx) sits at the digit-reversed row and column (for powers
    # of two the bit reversal)
    rows, cols = CL.digit_reversed(shape[0]), CL.digit_reversed(shape[1])
    got = got[..., rows, :][..., cols]
    want = torch.fft.fft2(z)
    # float64: rtol 1e-12 of the spectrum's peak; float32: 2e-6 (a stage
    # of float32 rounding per radix, log2 N stages at most)
    tol = 1e-12 if dt == "f64" else 2e-6
    peak = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * peak)


@pytest.mark.parametrize("shape", SHAPES + MIXED_SHAPES, ids=_ids)
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_fft_stages_inverse_undoes_forward(shape, dt):
    np_dt, _, cdt = DTYPES[dt]
    z = _complex_images(32, shape, cdt)
    tw = _twiddles(shape, np_dt)
    spectrum = CL.fft_stages_plain(z, tw)
    back = CL.fft_stages_plain(spectrum, tw, inverse=True) / (shape[0] * shape[1])
    tol = 1e-12 if dt == "f64" else 4e-6
    torch.testing.assert_close(back, z, rtol=tol, atol=tol * z.abs().max().item())
    # and on its own: the inverse of a digit-reversed fft2 is H W ifft2
    rows, cols = CL.digit_reversed(shape[0]), CL.digit_reversed(shape[1])
    layout = torch.fft.fft2(z)
    permuted = torch.empty_like(layout)
    permuted[..., rows[:, None], cols[None, :]] = layout
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


@pytest.mark.parametrize("n,plan", [
    (96, ((3, 2, 2), (2, 2, 2))), (100, ((5, 2), (5, 2))),
    (144, ((3, 2, 2), (3, 2, 2))), (120, ((5, 2), (3, 2, 2))),
    (24, ((3, 2, 2), (2,))), (20, ((5, 2), (2,))), (6, ((3, 2),)),
    (128, ((2, 2, 2, 2), (2, 2, 2))), (2, ((2,),)),
    (250, ((5,), (5,), (5, 2))),
    (98, ((7,), (7, 2))), (112, ((7, 2), (2, 2, 2))), (42, ((7,), (3, 2))),
    (14, ((7, 2),)), (140, ((7, 2), (5, 2))),
])
def test_fft_plan_passes_end_in_radix_two(n, plan):
    """Each radix-3, -5 or -7 stage opens a register pass of at most 16
    elements (radix 7 first); the last stage is radix 2 (so that bins kx <
    W/2 are the even column positions); a power of two keeps the radix-2
    route's passes."""
    assert CL.fft_plan(n) == plan
    assert plan[-1][-1] == 2
    assert all(int(np.prod(p)) <= 16 for p in plan)
    assert int(np.prod([r for p in plan for r in p])) == n


def test_digit_reversed_is_the_layout():
    """Bin k = p0 + r0 p1 + r0 r1 p2 + ... sits at p0 N/r0 + p1 N/(r0 r1)
    + ...: at 12 (stages 3, 2, 2) bin 1 is at 4 and bin 3 at 2; a
    permutation that is the bit reversal for powers of two, whose even
    positions hold exactly the bins below N/2."""
    np.testing.assert_array_equal(CL.digit_reversed(12),
                                  [0, 4, 8, 2, 6, 10, 1, 5, 9, 3, 7, 11])
    # 14 (stages 7, 2): bin p0 + 7 p1 at 2 p0 + p1
    np.testing.assert_array_equal(CL.digit_reversed(14),
                                  [0, 2, 4, 6, 8, 10, 12, 1, 3, 5, 7, 9, 11, 13])
    # 98 (stages 7, 7, 2): bin p0 + 7 p1 + 49 p2 at 14 p0 + 2 p1 + p2
    k = np.arange(98)
    np.testing.assert_array_equal(CL.digit_reversed(98),
                                  14 * (k % 7) + 2 * (k // 7 % 7) + k // 49)
    for n in (2, 6, 20, 24, 96, 100, 144, 128, 14, 42, 98, 112):
        pos = CL.digit_reversed(n)
        assert sorted(pos) == list(range(n))
        assert set(np.arange(n)[pos % 2 == 0]) == set(range(n // 2))
        assert pos[n // 2] == 1
    for n in (2, 16, 128):
        np.testing.assert_array_equal(CL.digit_reversed(n), CL.bit_reversed(n))


@pytest.mark.parametrize("shape", MIXED_SHAPES, ids=_ids)
def test_fft_layout_tables(shape):
    """The kernel's int tables: the first entry of W's twiddles, each
    axis's pass codes, and per axis bin -> position and its inverse."""
    h, w = shape
    lay = CL.fft_layout(shape)
    assert lay.dtype == np.int32 and lay.shape == (20 + 2 * (h + w),)
    assert lay[0] == CL.fft_twiddles(h).shape[0]
    for at, n in ((1, h), (10, w)):
        plan = CL.fft_plan(n)
        codes = [16 * (p[0] if p[0] != 2 else 1) + p.count(2) for p in plan]
        assert lay[at] == len(plan)
        np.testing.assert_array_equal(lay[at + 1:at + 1 + len(plan)], codes)
    tables = np.split(lay[20:], np.cumsum([h, h, w]))
    for pos, bins, n in ((tables[0], tables[1], h), (tables[2], tables[3], w)):
        np.testing.assert_array_equal(pos, CL.digit_reversed(n))
        np.testing.assert_array_equal(bins[pos], np.arange(n))
    twiddle, layout = CL.fft_tables(shape)
    np.testing.assert_array_equal(layout, lay)
    assert twiddle.shape == (lay[0] + CL.fft_twiddles(w).shape[0], 2)
    assert CL.fft_smem_bytes(shape) == (8 * (h * (w + 1) + twiddle.shape[0])
                                        + 4 * lay.size)


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


@pytest.mark.parametrize("shape", SHAPES + MIXED_SHAPES[:3], ids=_ids)
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


def _warp_ways(slots):
    """Shared-memory wavefronts of one warp's float2 accesses at these
    float2 slots (32 banks of 4 bytes; the most distinct words any bank
    is asked for), over the 2 that 32 8-byte accesses need at least."""
    words = np.concatenate([2 * slots, 2 * slots + 1])
    return max(len(set(words[words % 32 == b])) for b in range(32)) / 2


def _pair_step_ways(shape):
    """(mean, worst) ways of each warp's bin read and partner read in
    ``csrc/fft_conv.cuh``'s mixed_pair_step: lanes on consecutive even
    column positions of the digit-reversed layout, row pitch W + 1."""
    h, w = shape
    lay = CL.fft_layout(shape).astype(np.int64)
    pos_h, bin_h, pos_w, bin_w = np.split(lay[20:], np.cumsum([h, h, w]))
    wh = w // 2
    ways = []
    for t0 in range(0, h * wh, 32):
        t = np.arange(t0, min(t0 + 32, h * wh))
        r, c = t // wh, 2 * (t % wh)
        ky, kx = bin_h[r], bin_w[c]
        own = ~((kx == 0) & (ky > h // 2))
        mine = r * (w + 1) + c
        partner = pos_h[(-ky) % h] * (w + 1) + pos_w[(-kx) % w]
        ways.append((_warp_ways(mine[own]), _warp_ways(partner[own])))
    ways = np.array(ways)
    return ways.mean(0), ways.max(0)


@pytest.mark.parametrize("shape,worst_partner", [
    ((96, 96), 2.0), ((100, 100), 3.0), ((144, 144), 2.5), ((96, 128), 2.0),
    ((98, 98), 2.5), ((112, 112), 2.0), ((150, 150), 2.5)],
    ids=lambda v: _ids(v) if isinstance(v, tuple) else str(v))
def test_mixed_pair_step_keeps_the_two_way_bound(shape, worst_partner):
    """The pointwise step on the digit-reversed layout reads each warp's
    own bins at most 2-way (the power-of-two step's swizzle bound; 1.67
    on average at 96x96, 1.79 at 100x100 and at 98x98, where W/2 = 49 is
    odd) and their partners at most ``worst_partner``-way (1.67, 2.09
    and 1.81 on average).  150x150 is the padded route's transform of
    74x74 (1.87 and 1.93 on average)."""
    mean, worst = _pair_step_ways(shape)
    assert worst[0] <= 2.0 and mean[0] <= 2.0
    assert worst[1] == worst_partner
    if shape == (96, 96):
        np.testing.assert_allclose(mean, [1.6667, 1.6701], atol=1e-4)
    if shape == (100, 100):
        np.testing.assert_allclose(mean, [1.7930, 2.0924], atol=1e-4)
    if shape == (98, 98):
        np.testing.assert_allclose(mean, [1.7881, 1.8113], atol=1e-4)
    if shape == (150, 150):
        np.testing.assert_allclose(mean, [1.8665, 1.9332], atol=1e-4)


def _staged_conv(raws, consts):
    """``(conv, mvar)`` by the kernel's own steps on the mixed-radix
    geometry, in plain PyTorch: the pack, ``fft_stages_plain`` (the
    digit-reversed layout), the pointwise step addressed through the
    layout's tables (the bin at each position, its partner's position),
    the inverse stages on that layout and the shifted readout."""
    h, w = consts.shape
    lay = consts.fft_layout.numpy().astype(np.int64)
    pos_h, bin_h, pos_w, bin_w = np.split(lay[20:], np.cumsum([h, h, w]))
    exponent, _ = CL._peak_exponent(raws)
    s = torch.ldexp(torch.ones_like(raws[:, 0, 0]), -exponent)[:, None, None]
    z = CL.fft_stages_plain(torch.complex(raws, (raws * raws) * s), consts.twiddle)
    partner = z[..., pos_h[(-bin_h) % h], :][..., pos_w[(-bin_w) % w]].conj()
    a = 0.5 * (z + partner)
    b = -0.5j * (z - partner)
    kpsf = CL._full_spectrum(consts.psf_r, consts.psf_i, w)[bin_h][:, bin_w]
    kvar = CL._full_spectrum(consts.var_r, consts.var_i, w)[bin_h][:, bin_w]
    y = CL.fft_stages_plain(a * kpsf + 1j * b * (kvar * consts.var_gain),
                            consts.twiddle, inverse=True) / (h * w)
    y = torch.roll(y, shifts=(-(h // 2), -(w // 2)), dims=(-2, -1))
    return y.real, y.imag / (s * consts.var_gain)


@pytest.mark.parametrize("shape", [(24, 20), (30, 36), (28, 42), (14, 28)],
                         ids=_ids)
def test_mixed_radix_lnl_matches_pallas_batched(monkeypatch, shape):
    """The lnL through the mixed-radix schedule and layout (and through
    the packed scheme) against the JAX package's batched conv+lnL Pallas
    kernel (interpret mode, true-fp32 products), rtol 1e-5, float32 on
    both sides."""
    monkeypatch.setenv("PSFMC_LNPOST_DOT", "highest")
    rng = np.random.RandomState(39)
    spec = _jax_flagship_spec(rng, shape, psf_side=min(16, *shape))
    constants = jax_posterior(spec).constants
    raws = (0.1 + np.abs(rng.randn(6, *spec.shape)) * 0.5).astype(np.float32)
    lnl_jax = make_batched_conv_lnl(constants, spec, jnp.float32, tile=2)
    want = np.asarray(lnl_jax(jnp.asarray(raws)))

    consts = CL.make_conv_lnl_consts(
        spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
        spec.obs_var, ~spec.bad_px, "cpu", torch.float32,
    )
    assert CL.conv_route(consts.shape) == "fft"
    assert consts.fft_layout.numel() > 0
    for conv, mvar in (_staged_conv(torch.as_tensor(raws), consts),
                       CL.packed_fft_conv_plain(torch.as_tensor(raws), consts)):
        got = gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                              consts.good).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


# even sides with factors 3, 5 and 7 that fit a block: the FFT route on the
# mixed-radix geometry
MIXED_FFT = {(96, 96), (100, 100), (144, 144), (128, 96), (98, 98), (56, 56),
             (98, 128)}
# an odd side or a prime factor above 7, padded to a transform that fits a
# block: the padded route
PADDED = {(45, 37), (74, 74), (45, 75), (49, 98), (64, 74)}
# a transform (the padded one, or the FFT route's own sides) too large for a
# block that fits a cluster of blocks: the cluster route
CLUSTER = {(128, 256), (256, 256), (88, 88), (160, 180), (196, 196), (94, 94),
           (101, 101)}


@pytest.mark.parametrize("shape,route", [
    ((128, 128), "fft"), ((64, 64), "fft"), ((64, 128), "fft"),
    ((64, 256), "fft"), ((256, 64), "fft"), ((16, 16), "fft"),
    ((32, 512), "fft"), ((2, 2), "fft"),
    ((45, 37), "padded"), ((96, 96), "fft"), ((100, 100), "fft"),
    ((144, 144), "fft"), ((128, 96), "fft"), ((1, 64), "dft"),
    # powers of two, but one walker does not fit in a block
    ((128, 256), "cluster"), ((256, 256), "cluster"), ((512, 512), "global"),
    # factors of 7: the mixed-radix geometry's radix-7 stages
    ((98, 98), "fft"), ((56, 56), "fft"), ((98, 128), "fft"),
    # a factor of 37 or 11, odd sides with factors 3, 5 and 7, too large
    ((74, 74), "padded"), ((88, 88), "cluster"), ((45, 75), "padded"),
    ((49, 98), "padded"), ((160, 180), "cluster"), ((196, 196), "cluster"),
    # factors of 47 and 101: padded to 192 and 210, no block holds them
    ((94, 94), "cluster"), ((101, 101), "cluster"), ((64, 74), "padded"),
    # on the global route: a transform that no cluster of 8 blocks holds
    ((512, 512), "global"),
], ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_conv_route_is_a_function_of_the_shape(shape, route):
    """conv_lnl's rule, which is also the fused kernel's
    (:func:`fused_route`), answers ``"fft"`` for the shapes of
    :data:`MIXED_FFT` and the powers of two that fit a block,
    ``"padded"`` for those of :data:`PADDED` (74x74 -> 150x150, 45x75 ->
    90x150, 49x98 -> 98x98, 45x37 -> 90x80, 64x74 -> 64x150: one side
    padded), ``"cluster"`` for those of :data:`CLUSTER`: 88x88 (180x180),
    94x94 (192x192) and 101x101 (210x210) need more shared memory than a
    block has, and so do 160x180, 196x196, 128x256 and 256x256 on the FFT
    route's sides, but a cluster of 2 (256x256: 4) blocks holds each;
    512x512 (no cluster of 8 holds it) takes the global route, and a side
    of 1 (1x64) stays on the matmul-DFT route."""
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    assert CL.conv_route(shape) == route
    assert FL.fused_route(shape) == route
    assert (route == "padded") == (shape in PADDED)
    assert (route == "cluster") == (shape in CLUSTER)
    if shape in MIXED_FFT:
        assert route == "fft"
    if route == "fft":
        assert CL.fft_smem_bytes(shape) <= CL.BLOCK_SMEM_LIMIT
    if route == "padded":
        padded = CL.padded_shape(shape)
        assert padded != shape and all(m >= 2 * n - 1 or m == n
                                       for n, m in zip(shape, padded))
        assert CL.fft_smem_bytes(padded) <= CL.BLOCK_SMEM_LIMIT
    if route == "cluster":
        assert CL.cluster_size(shape) in CL.CLUSTER_SIZES
        assert CL.fft_smem_bytes(CL.padded_shape(shape)) > CL.BLOCK_SMEM_LIMIT


def test_fft_route_needs_less_shared_memory_than_the_three_buffers():
    """At the square and moderately oblong shapes the FFT route (conv_lnl's
    and the fused kernel's, which reads the walker's scalars through the
    read-only cache) needs less than the matmul-DFT route's three buffers
    would."""
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    assert CL.fft_smem_bytes((128, 128)) == 8 * (128 * 129 + 64)
    for shape in [(128, 128), (64, 64), (64, 256), (256, 64), (16, 16)]:
        assert CL.conv_route(shape) == "fft"
        assert (CL.fft_smem_bytes(shape) + CL._FFT_STATIC_SMEM
                < FL.fused_lnl_smem_bytes(shape, 2, 1))


@pytest.mark.parametrize("shape,route,ok", [
    ((128, 128), "fft", True), ((64, 256), "fft", True),
    # tall and narrow: the padded half spectra of the three buffers would
    # not fit (245,760 B), the one complex image does (155,648 B)
    ((2048, 8), "fft", True),
    # off the radix-2 geometry: the mixed-radix one; 136 = 8 x 17 and
    # 256x256 beyond a block: a cluster
    ((96, 96), "fft", True), ((136, 136), "cluster", True),
    ((144, 144), "fft", True), ((256, 256), "cluster", True),
], ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_fused_gate_measures_the_route_the_shape_takes(shape, route, ok):
    """The fused kernel takes conv_lnl's route, and its gate passes every
    shape a route other than the matmul-DFT one holds; the three buffers
    of that route would not hold 2048x8, 144x144 or 256x256."""
    from types import SimpleNamespace

    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    kinds = ("sky", "sersic", "sersic", "pointsource")
    spec = SimpleNamespace(
        shape=shape,
        comp_specs=[SimpleNamespace(kind=k, params=()) for k in kinds])
    assert FL.fused_route(shape) == CL.conv_route(shape) == route
    got, why = FL.fused_lnl_supported(spec)
    assert (got, why) == (ok, "")
    three_buffers = FL.fused_lnl_smem_bytes(shape, 2, 1) <= FL.FUSED_SMEM_LIMIT
    assert three_buffers == (shape in [(128, 128), (64, 256), (96, 96), (136, 136)])
    if route == "fft":
        assert CL.fft_smem_bytes(shape) + CL._FFT_STATIC_SMEM <= CL.BLOCK_SMEM_LIMIT
    else:
        assert CL.cluster_size(shape) in CL.CLUSTER_SIZES


def test_consts_carry_the_twiddles_only_for_powers_of_two():
    """The FFT route's tables ride on the constants where the shape takes
    it: one table of max(H, W) and no layout for powers of two, both axes'
    tables and the int32 layout for the mixed-radix geometry (24x20, and
    98x20: a factor of 7), none at 74x20 (a factor of 37), which takes the
    padded route and carries the tables and the padded kernels' spectra
    of its 150x20 transform instead."""
    rng = np.random.RandomState(38)
    consts, _, _ = _consts(rng, (16, 64), torch.float32)
    assert tuple(consts.twiddle.shape) == (32, 2)
    assert consts.twiddle.dtype == torch.float32
    assert tuple(consts.fft_layout.shape) == (0,)
    consts, _, _ = _consts(rng, (24, 20), torch.float32)
    assert tuple(consts.twiddle.shape) == (24 + 20, 2)
    assert consts.fft_layout.dtype == torch.int32
    np.testing.assert_array_equal(consts.fft_layout.numpy(),
                                  CL.fft_layout((24, 20)))
    assert CL.conv_route(consts.shape) == "fft"
    consts98, _, _ = _consts(rng, (98, 20), torch.float32)
    assert tuple(consts98.twiddle.shape) == (98 + 20, 2)
    np.testing.assert_array_equal(consts98.fft_layout.numpy(),
                                  CL.fft_layout((98, 20)))
    assert CL.conv_route(consts98.shape) == "fft"
    consts74, _, _ = _consts(rng, (74, 20), torch.float32)
    assert tuple(consts74.twiddle.shape) == (0, 2)
    assert tuple(consts74.fft_layout.shape) == (0,)
    assert CL.conv_route(consts74.shape) == "padded"
    assert consts74.padded_shape == (150, 20)
    assert tuple(consts74.pad_twiddle.shape) == (150 + 20, 2)
    np.testing.assert_array_equal(consts74.pad_layout.numpy(),
                                  CL.fft_layout((150, 20)))
    for name in ("pad_psf_r", "pad_psf_i", "pad_var_r", "pad_var_i", "pad_psf_ic",
                 "pad_var_ic"):
        assert tuple(getattr(consts74, name).shape) == (150, 11)
    assert tuple(consts.pad_psf_r.shape) == (0, 0)  # 24x20: the FFT route
    # a CPU tensor takes the plain version on either route, uncounted
    before = dict(CL.batched_conv_lnl.route_launches)
    CL.batched_conv_lnl(torch.ones((2, 24, 20)), consts)
    CL.batched_conv_lnl(torch.ones((2, 98, 20)), consts98)
    CL.batched_conv_lnl(torch.ones((2, 74, 20)), consts74)
    assert CL.batched_conv_lnl.route_launches == before


@pytest.mark.parametrize("n", [2, 3, 5, 7, 11, 13, 17, 31, 37, 41, 45, 47, 49, 74,
                               75, 81, 82, 94, 101])
def test_padded_size_is_the_smallest_even_seven_smooth_side(n):
    """``padded_size(n)`` is at least ``2n - 1``, even, has no prime factor
    above 7, and no smaller side has all three (74 -> 150, 31 -> 64)."""
    m = CL.padded_size(n)
    assert m >= 2 * n - 1 and m % 2 == 0 and CL._smooth_even(m)
    assert not any(CL._smooth_even(k) for k in range(2 * n - 1, m))
    assert CL.padded_size(74) == 150 and CL.padded_size(31) == 64
    with pytest.raises(ValueError, match="at least 2"):
        CL.padded_size(1)


@pytest.mark.parametrize("shape", [(15, 21), (13, 37), (24, 37), (7, 2)], ids=_ids)
def test_pad_fold_and_crop_are_adjoints(shape):
    """The padded route's readout (the fold and the shift) and the
    backward's placement of the weights (:func:`_unfold`) are adjoints,
    and so are the zero pad and the crop: ``<fold y, x> = <y, unfold x>``
    and ``<pad x, y> = <x, crop y>`` in float64, to 1e-12 of the terms'
    size."""
    rng = np.random.RandomState(41)
    padded = CL.padded_shape(shape)
    x = torch.as_tensor(rng.randn(2, *shape))
    y = torch.as_tensor(rng.randn(2, *padded))
    for a, b in (((CL._fold(y, shape) * x).sum(), (y * CL._unfold(x, shape, padded)).sum()),
                 ((CL._pad(x, padded) * y).sum(), (x * CL._crop(y, shape)).sum())):
        assert abs(a.item() - b.item()) <= 1e-12 * (x.abs().sum() * y.abs().sum()).item()
    # the fold is the N-point circular convolution: a linear one of length
    # 2N - 1, folded, equals the circular one
    h, w = shape
    k = torch.as_tensor(rng.randn(h, w))
    lin = torch.fft.irfft2(torch.fft.rfft2(CL._pad(x, padded))
                           * torch.fft.rfft2(CL._pad(k, padded)), s=padded)
    circ = torch.fft.irfft2(torch.fft.rfft2(x) * torch.fft.rfft2(k), s=shape)
    want = torch.roll(circ, shifts=(-(h // 2), -(w // 2)), dims=(-2, -1))
    torch.testing.assert_close(CL._fold(lin, shape), want, rtol=1e-12, atol=1e-12)


def _staged_padded_conv(raws, consts):
    """``(conv, mvar)`` by the padded route's own steps in plain PyTorch:
    the zero pad to the transform's sides, the pack, ``fft_stages_plain``
    at those sides (the digit-reversed layout of ``consts.pad_layout``),
    the pointwise step addressed through the layout's tables with the
    padded kernels' spectra, the inverse stages, ``1 / (M_h M_w)``, the
    fold and the shifted readout."""
    h, w = consts.shape
    mh, mw = consts.padded_shape
    lay = consts.pad_layout.numpy().astype(np.int64)
    pos_h, bin_h, pos_w, bin_w = np.split(lay[20:], np.cumsum([mh, mh, mw]))
    exponent, _ = CL._peak_exponent(raws)
    s = torch.ldexp(torch.ones_like(raws[:, 0, 0]), -exponent)[:, None, None]
    x = CL._pad(raws, (mh, mw))
    z = CL.fft_stages_plain(torch.complex(x, (x * x) * s), consts.pad_twiddle)
    partner = z[..., pos_h[(-bin_h) % mh], :][..., pos_w[(-bin_w) % mw]].conj()
    a = 0.5 * (z + partner)
    b = -0.5j * (z - partner)
    kpsf = CL._full_spectrum(consts.pad_psf_r, consts.pad_psf_i, mw)[bin_h][:, bin_w]
    kvar = CL._full_spectrum(consts.pad_var_r, consts.pad_var_i, mw)[bin_h][:, bin_w]
    y = CL.fft_stages_plain(a * kpsf + 1j * b * (kvar * consts.var_gain),
                            consts.pad_twiddle, inverse=True) / (mh * mw)
    y = CL._fold(y, (h, w))
    return y.real, y.imag / (s * consts.var_gain)


@pytest.mark.parametrize("shape", [(22, 26), (15, 21), (13, 37), (24, 37)], ids=_ids)
def test_padded_lnl_matches_pallas_batched(monkeypatch, shape):
    """The lnL through the padded scheme (``padded_fft_conv_plain``) and
    through the kernel's own steps at the transform's sides against the
    JAX package's batched conv+lnL Pallas kernel (interpret mode,
    true-fp32 products), rtol 1e-5, float32 on both sides: even sides
    with a prime factor above 7 (22x26 -> 48x54), odd sides (15x21 ->
    30x42), a prime side (13x37 -> 28x80) and one side padded while the
    other is not (24x37 -> 24x80)."""
    monkeypatch.setenv("PSFMC_LNPOST_DOT", "highest")
    rng = np.random.RandomState(43)
    spec = _jax_flagship_spec(rng, shape, psf_side=min(16, *shape))
    constants = jax_posterior(spec).constants
    raws = (0.1 + np.abs(rng.randn(6, *spec.shape)) * 0.5).astype(np.float32)
    lnl_jax = make_batched_conv_lnl(constants, spec, jnp.float32, tile=2)
    want = np.asarray(lnl_jax(jnp.asarray(raws)))

    consts = CL.make_conv_lnl_consts(
        spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
        spec.obs_var, ~spec.bad_px, "cpu", torch.float32,
    )
    assert CL.conv_route(consts.shape) == "padded"
    assert consts.pad_layout.numel() > 0
    for conv, mvar in (CL.padded_fft_conv_plain(torch.as_tensor(raws), consts),
                       _staged_padded_conv(torch.as_tensor(raws), consts)):
        got = gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                              consts.good).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
