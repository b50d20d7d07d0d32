"""conv_lnl's global route, in its plain versions.

The global route (``csrc/fft_global.cuh``) runs the padded route's scheme
with the walker's transform in a global-memory scratch, split over blocks
by tiles of rows and by groups of columns, for the transforms no block and
no cluster of 8 holds; it runs only on the card.  What runs here: the route
rule as a function of the shape over every side from 1 to 1024; the
schedule emulated in plain PyTorch tile by tile and group by group (the row
passes' natural-order stores, the column groups with their Hermitian
partners, the pair step's ownership, the fold of the rows in the column
pass, the readout's tiles and their partial sums, the backward's
placement of the weights), held against the padded route's plain schemes
with the route forced at small shapes; and the plain versions at 251x251
(a 504x504 transform) and 512x512 against the JAX package's batched
conv+lnL Pallas kernel in interpret mode and against ``jax.grad`` of the
JAX package's own plain reference (``convolve_rdft`` and
``gaussian_lnlike``).  Inputs come from numpy seeds; every tolerance is
stated where it is asserted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.ops.fourier import convolve_rdft as jax_convolve_rdft
from psfmc_tpu.ops.fourier import rdft_matrices as jax_rdft_matrices
from psfmc_tpu.ops.likelihood import gaussian_lnlike as jax_gaussian_lnlike
from psfmc_tpu.ops.pallas.lnpost_batched import make_batched_conv_lnl
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
from psfmc_tpu_torch.ops.likelihood import gaussian_lnlike

from test_torch_cluster import _close, _ids, _inputs, _tables
from test_torch_kernels import _jax_flagship_spec


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the route rule ---------------------------------------------------------

def test_global_route_takes_every_square_side_the_clusters_do_not():
    """Over square sides 1-1024 the matmul-DFT route is left only for a side
    of 1; the FFT, padded and cluster routes keep the 41, 54 and 151 sides
    they took before the global route (whose 777 sides were all on the
    matmul-DFT route); the fused kernel takes the same route, and per-target
    spectra are read wherever the route is not the matmul-DFT one."""
    routes = {}
    for n in range(1, 1025):
        route = CL.conv_route((n, n))
        routes.setdefault(route, []).append(n)
        assert FL.fused_route((n, n)) == route
        assert CL.target_spectra_supported((n, n)) == (route != "dft")
        if route == "global":
            assert CL.cluster_size((n, n)) == 0 and CL.global_tiles((n, n))
    assert routes["dft"] == [1]
    assert {k: len(v) for k, v in routes.items()} == {
        "dft": 1, "fft": 41, "padded": 54, "cluster": 151, "global": 777}
    assert min(routes["global"]) == 226 and 512 in routes["global"]
    assert 640 in routes["global"] and 1024 in routes["global"]


@pytest.mark.parametrize("shape,route", [
    ((235, 512), "global"), ((512, 235), "global"), ((226, 226), "global"),
    ((251, 251), "global"), ((1023, 1023), "global"), ((240, 240), "cluster"),
    ((100, 1000), "cluster"), ((3, 4000), "cluster"), ((1, 64), "dft"), ((64, 1), "dft"),
    ((1, 1), "dft"), ((128, 128), "fft"), ((74, 74), "padded"),
], ids=_ids)
def test_route_of_non_square_shapes(shape, route):
    assert CL.conv_route(shape) == FL.fused_route(shape) == route
    assert (CL.global_tiles(shape) is None) == (min(shape) < 2)


@pytest.mark.parametrize("shape,tiles", [
    ((512, 512), (16, 8)), ((640, 640), (16, 8)), ((251, 251), (16, 8)),
    ((235, 512), (16, 8)), ((1023, 1023), (8, 4)), ((1024, 1024), (16, 8)),
], ids=_ids)
def test_global_tiles_are_the_largest_that_fit_a_block(shape, tiles):
    """A row tile of ``rows`` rows and a column group of ``2 cols`` columns
    (the bins and their partners) fit a block's shared memory with the
    static reductions; the next larger tile does not, or breaks the 2^16
    bound of a block's loop indices."""
    assert CL.global_tiles(shape) == tiles
    rows, cols = tiles
    transform = CL.padded_shape(shape)
    limit = CL.BLOCK_SMEM_LIMIT - CL._GLOBAL_STATIC_SMEM
    assert CL.global_row_smem(transform, rows) <= limit
    assert CL.global_column_smem(transform, cols) <= limit
    if rows < CL.GLOBAL_ROWS[0]:
        assert (CL.global_row_smem(transform, 2 * rows) > limit
                or 2 * rows * transform[1] >= 65536)
    if cols < CL.GLOBAL_COLS[0]:
        assert (CL.global_column_smem(transform, 2 * cols) > limit
                or 4 * cols * transform[0] >= 65536)


def test_global_launch_errors_name_the_shape_and_the_tiles():
    """A refused global launch raises with the image, the transform and both
    tiles' shared memory; nothing falls back to another route."""
    msg = CL._launch_error("conv_lnl", "global", (251, 251), 1)
    assert "global route" in msg and "cudaError 1" in msg and "251x251 walker" in msg
    assert "504x504 transform" in msg and "tiles of 16 rows" in msg
    assert f"{CL.global_row_smem((504, 504), 16)} bytes" in msg
    assert f"({CL.global_column_smem((504, 504), 8)} bytes)" in msg


def test_fused_render_tiles_cover_the_image_rows():
    """The fused kernel's render pass on the global route renders the row
    tiles of the row passes: they tile ``[0, H)`` without overlap, the
    last one ragged (251 = 15 x 16 + 11); off the global route there are
    none."""
    for shape in ((251, 251), (512, 512), (1023, 1023), (235, 512)):
        tiles = FL.global_render_rows(shape)
        rows = CL.global_tiles(shape)[0]
        drawn = [y for lo, hi in tiles for y in range(lo, hi)]
        assert drawn == list(range(shape[0]))
        assert all(0 < hi - lo <= rows for lo, hi in tiles)
    assert FL.global_render_rows((251, 251))[-1] == (240, 251)
    assert FL.global_render_rows((256, 256)) == FL.global_render_rows((1, 64)) == []


# -- the schedule, emulated -------------------------------------------------

def _force_global(monkeypatch, shape):
    """Send ``shape`` to the global route (no block, no cluster holds it)."""
    monkeypatch.setattr(CL, "_fits_a_block", lambda transform: False)
    monkeypatch.setattr(CL, "cluster_size", lambda s: 0)
    assert CL.conv_route(shape) == "global"


def _row_passes(tiles_of_rows, h, mw, rows, layout, tw_w):
    """Launch 2: each tile of rows through the forward row passes, stored in
    natural order (bin ``kx`` of the W axis read at its position
    ``pos_w[kx]``)."""
    pos_w = layout[2]
    out = []
    for t in range(-(-h // rows)):
        z = CL._stages_1d(tiles_of_rows(t * rows, min(h, t * rows + rows)), tw_w, False)
        out.append(z[..., pos_w])
    return torch.cat(out, dim=1)


def _column_groups(s, consts, cols, layout, tw_h, spectra, backward):
    """Launch 3 on ``s`` ``(B, H, M_w)``: each group of ``cols`` bins ``kx <=
    M_w / 2`` with its partners ``M_w - kx`` (tile columns ``[cols, 2 cols)``),
    the transform's rows from ``H`` up zeros (forward) or repeating rows ``0
    .. H - 2`` (backward, along a padded axis); the column passes, the pair
    step (the bin with ``ky <= M_h / 2`` owns an edge column's pairs), the
    inverse passes, rows ``[0, H)`` written back (the forward folds row ``s +
    H`` onto ``s``).  Returns the new ``s``; every bin of every row is
    written exactly once."""
    pos_h, bin_h = layout[0], layout[1]
    h, (mh, mw) = s.shape[1], consts.padded_shape
    wh = mw // 2
    fold_h = mh != h
    psf = torch.complex(spectra[0], spectra[1]).reshape(-1)
    var = torch.complex(spectra[2], spectra[3]).reshape(-1) * consts.var_gain
    out = torch.zeros_like(s)
    written = np.zeros(mw, np.int64)
    for c0 in range(0, wh + 1, cols):
        own = min(cols, wh + 1 - c0)
        bins = [c0 + i for i in range(own)] + [
            mw - (c0 + i) if 0 < c0 + i < wh else -1 for i in range(own)]
        place = list(range(own)) + [cols + i for i in range(own)]
        tile = s.new_zeros((s.shape[0], mh, 2 * cols))
        for kx, tc in zip(bins, place):
            if kx >= 0:
                tile[:, :h, tc] = s[:, :, kx]
                if backward and fold_h:
                    tile[:, h:2 * h - 1, tc] = s[:, :h - 1, kx]
        tile = CL._stages_1d(tile.transpose(-1, -2), tw_h, False).transpose(-1, -2)
        for i in range(own):
            kx = c0 + i
            edge = kx in (0, wh)
            r = np.arange(mh)
            ky = bin_h[r]
            keep = ~(edge & (ky > mh // 2))
            r, ky = r[keep], ky[keep]
            nky = (-ky) % mh
            r2, c2 = pos_h[nky], (i if edge else cols + i)
            z1, z2 = tile[:, r, i], tile[:, r2, c2]
            a = 0.5 * (z1 + z2.conj())
            b = -0.5j * (z1 - z2.conj())
            e = torch.as_tensor(ky * (wh + 1) + kx)
            p, q = a * psf[e], b * var[e]
            other = ~(edge & (nky == ky))
            tile[:, r, i] = p + 1j * q
            tile[:, r2[other], c2] = (p.conj() + 1j * q.conj())[:, other]
        tile = CL._stages_1d(tile.transpose(-1, -2), tw_h, True).transpose(-1, -2)
        for kx, tc in zip(bins, place):
            if kx < 0:
                continue
            col = tile[:, :h, tc].clone()
            if not backward and fold_h:
                col[:, :h - 1] += tile[:, h:2 * h - 1, tc]
            out[:, :, kx] = col
            written[kx] += 1
    assert (written == 1).all()
    return out


def _inverse_rows(s, ys, rows_of, layout, tw_w):
    """The inverse row passes of the rows ``rows_of(ys)`` of ``s``, loaded at
    the layout's positions."""
    z = torch.zeros_like(s[:, :len(ys)])
    z[..., layout[2]] = s[:, rows_of(ys)]
    return CL._stages_1d(z, tw_w, True)


def _global_forward(raws, consts, rows, cols):
    """``(lnl, conv, mvar)`` by the global route's five launches: the tiles'
    peaks (NaNs dropped), the row passes of the packed tiles, the column
    groups, the readout of each tile of image rows (shift, fold along W,
    lnL partial sums) and the partial sums added in tile order."""
    b, h, w = raws.shape
    mh, mw = consts.padded_shape
    layout, tw_h, tw_w = _tables(consts)
    tiles = -(-h // rows)
    peaks = torch.stack([torch.nan_to_num(raws[:, t * rows:t * rows + rows].abs(), nan=0.0)
                         .amax(dim=(-2, -1)) for t in range(tiles)], -1)
    exponent, _ = CL._peak_exponent(peaks[..., None])
    exponent = exponent.clamp(-CL._MAX_SCALE_EXP, CL._MAX_SCALE_EXP)
    s = torch.ldexp(torch.ones(b, dtype=raws.dtype), -exponent)[:, None, None]

    def packed(y0, y1):
        x = raws.new_zeros((b, y1 - y0, mw))
        x[..., :w] = raws[:, y0:y1]
        return torch.complex(x, (x * x) * s)

    spectrum = _row_passes(packed, h, mw, rows, layout, tw_w)
    spectra = (consts.pad_psf_r, consts.pad_psf_i, consts.pad_var_r, consts.pad_var_i)
    spectrum = _column_groups(spectrum, consts, cols, layout, tw_h, spectra, False)
    inv = 1.0 / (mh * mw)
    mvar_scale = torch.ldexp(torch.full((b,), inv, dtype=raws.dtype), exponent)
    conv, mvar = raws.new_zeros(raws.shape), raws.new_zeros(raws.shape)
    parts = []
    x = np.arange(w)
    sx = (x + w // 2) % w
    fx = torch.as_tensor((mw != w) & (sx < w - 1))
    for t in range(tiles):
        ys = np.arange(t * rows, min(h, t * rows + rows))
        z = _inverse_rows(spectrum, ys, lambda y: (y + h // 2) % h, layout, tw_w)
        v = z[..., sx] + torch.where(fx, z[..., np.minimum(sx + w, mw - 1)], 0)
        c = v.real * inv
        m = v.imag * (mvar_scale[:, None, None] / consts.var_gain)
        conv[:, ys], mvar[:, ys] = c, m
        parts.append(gaussian_lnlike(consts.obs[ys] - c, 1.0 / (m + consts.obs_var[ys]),
                                     consts.good[ys]))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    lnl = torch.where(torch.isfinite(total), total, torch.full_like(total, -np.inf))
    return lnl, conv, mvar


def _global_backward(raws, consts, lnl, grad, weights, scale_exp, rows, cols):
    """The global route's backward: the row passes of the weights at the
    slots the readout read them from (row ``y`` of ``[0, H)`` from pixel row
    ``(y - H/2) mod H``, column ``tx <= 2W - 2`` from ``(tx or tx - W) - W/2
    mod W``, zeros above; the imaginary parts times ``2^scale_exp``), the
    column groups with the conjugate spectra (rows ``H .. 2H - 2`` repeating
    ``0 .. H - 2``, the crop), the inverse row passes and the combine; 0 for
    a walker whose lnL is not finite."""
    b, h, w = raws.shape
    mw = consts.padded_shape[1]
    layout, tw_h, tw_w = _tables(consts)
    ys = torch.ldexp(torch.ones_like(lnl), scale_exp.to(torch.int64))[:, None, None]
    packed = torch.complex(weights[..., 0], weights[..., 1] * ys)
    tx = np.arange(mw)
    inside = tx <= 2 * w - 2
    x = (np.where(tx < w, tx, tx - w) - w // 2) % w

    def slots(y0, y1):
        z = packed.new_zeros((b, y1 - y0, mw))
        z[..., inside] = packed[:, (np.arange(y0, y1) - h // 2) % h][..., x[inside]]
        return z

    spectrum = _row_passes(slots, h, mw, rows, layout, tw_w)
    spectra = (consts.pad_psf_r, consts.pad_psf_ic, consts.pad_var_r, consts.pad_var_ic)
    spectrum = _column_groups(spectrum, consts, cols, layout, tw_h, spectra, True)
    inv = 1.0 / (consts.padded_shape[0] * mw)
    out = raws.new_zeros(raws.shape)
    for t in range(-(-h // rows)):
        y = np.arange(t * rows, min(h, t * rows + rows))
        v = _inverse_rows(spectrum, y, lambda r: r, layout, tw_w)[..., :w]
        gc = v.imag * (inv / ys / consts.var_gain)
        out[:, y] = grad[:, None, None] * (v.real * inv + 2.0 * raws[:, y] * gc)
    return torch.where(torch.isfinite(lnl)[:, None, None], out, torch.zeros_like(out))


# (image shape, rows, cols): the FFT route's own sides (24x20, mixed radix;
# 16x32, powers of two as radix-2 passes of the mixed geometry), odd sides
# (15x21 -> 30x42), a padded H only (13x40 -> 26x40) and a padded
# transform with a factor of 13 (22x26 -> 48x54); ragged tiles and groups,
# a group of one bin (the edge column alone) and every bin in one group
SCHEDULES = [((24, 20), 5, 3), ((16, 32), 4, 1), ((15, 21), 4, 4), ((13, 40), 16, 8),
             ((22, 26), 3, 5), ((22, 26), 16, 28)]


@pytest.mark.parametrize("shape,rows,cols", SCHEDULES, ids=_ids)
def test_global_schedule_matches_the_plain_schemes(monkeypatch, shape, rows, cols):
    """The forward's five launches, tile by tile and group by group, with the
    route forced at a small shape: ``(conv, mvar)`` against
    :func:`padded_fft_conv_plain` (the route's plain scheme), the lnL of the
    tiles' partial sums against the version of record
    (:func:`batched_conv_lnl_plain`), float64 to 1e-10 of the largest entry;
    the NaN walker's lnL is ``-inf`` on both.  The consts carry the padded
    spectra and the transform's mixed-radix tables."""
    _force_global(monkeypatch, shape)
    raws, consts, _, _ = _inputs(shape, sum(shape) + rows + cols)
    twiddle, layout = CL.cluster_tables(consts.padded_shape, np.float64)
    np.testing.assert_array_equal(consts.pad_twiddle.numpy(), twiddle)
    np.testing.assert_array_equal(consts.pad_layout.numpy(), layout)
    lnl, conv, mvar = _global_forward(raws, consts, rows, cols)
    want_conv, want_mvar = CL.padded_fft_conv_plain(raws, consts)
    keep = torch.isfinite(raws).all(dim=2).all(dim=1)
    _close(conv[keep], want_conv[keep], 1e-10)
    _close(mvar[keep], want_mvar[keep], 1e-10)
    want = CL.batched_conv_lnl_plain(raws, consts)
    assert lnl[1] == -np.inf and want[1] == -np.inf
    _close(lnl, want, 1e-10)


@pytest.mark.parametrize("shape,rows,cols", SCHEDULES, ids=_ids)
def test_global_backward_schedule_matches_the_plain_schemes(monkeypatch, shape, rows, cols):
    """The backward's three launches from the residuals of
    :func:`padded_fft_conv_residuals_plain`: against the route's plain
    scheme (:func:`padded_fft_conv_backward_from_residuals_plain`) to 1e-10
    and against the version of record
    (:func:`batched_conv_lnl_backward_plain`) to 1e-8 of the largest
    gradient, float64; the NaN walker's gradient is zero."""
    _force_global(monkeypatch, shape)
    raws, consts, _, _ = _inputs(shape, 3 * sum(shape) + rows)
    lnl, weights, scale_exp = CL.padded_fft_conv_residuals_plain(raws, consts)
    grad = torch.as_tensor(np.random.RandomState(7).uniform(0.5, 2.0, raws.shape[0]))
    got = _global_backward(raws, consts, lnl, grad, weights, scale_exp, rows, cols)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    _close(got, CL.padded_fft_conv_backward_from_residuals_plain(
        raws, consts, lnl, grad, weights, scale_exp), 1e-10)
    _close(got, CL.batched_conv_lnl_backward_plain(raws, consts, lnl, grad), 1e-8)


# -- the plain versions against the JAX package ------------------------------

def _spec(shape, seed):
    """The JAX package's flagship spec at ``shape`` with a 64x64 PSF."""
    return _jax_flagship_spec(np.random.RandomState(seed), shape, psf_side=64)


def _consts(spec, dtype):
    return CL.make_conv_lnl_consts(spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
                                   spec.obs_var, ~spec.bad_px, "cpu", dtype)


def _jax_lnl(spec, f_psf=None):
    """The JAX package's plain reference in float64: ``convolve_rdft`` twice
    and ``gaussian_lnlike``, a walker at a time (with the PSF spectrum
    ``f_psf`` in place of the spec's where given)."""
    mats = tuple(jnp.asarray(m) for m in jax_rdft_matrices(spec.shape, np.float64))
    f_psf = spec.f_psf_stack[0] if f_psf is None else f_psf
    f_var = spec.f_var_stack[0]
    obs, var, good = (jnp.asarray(a) for a in (spec.obs_data, spec.obs_var, ~spec.bad_px))

    def one(raw):
        conv = jax_convolve_rdft(raw, f_psf.real, f_psf.imag, mats)
        mvar = jax_convolve_rdft(raw * raw, f_var.real, f_var.imag, mats)
        return jax_gaussian_lnlike(obs - conv, 1.0 / (mvar + var), good)

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("shape", [(251, 251), (512, 512)], ids=_ids)
def test_global_plain_lnl_matches_pallas_batched(monkeypatch, shape):
    """Two walkers at 251x251 (a 504x504 transform) and 512x512: the lnL by
    the route's plain scheme (:func:`padded_fft_conv_plain`, at 512x512 the
    unpadded transform) and by the wrapper's CPU version of record against
    the JAX package's batched conv+lnL Pallas kernel (interpret mode,
    true-fp32 products), rtol 1e-5, float32 on both sides (the cluster
    route's tolerance at 94x94)."""
    monkeypatch.setenv("PSFMC_LNPOST_DOT", "highest")
    spec = _spec(shape, sum(shape))
    constants = jax_posterior(spec).constants
    raws = (0.1 + np.abs(np.random.RandomState(3).randn(2, *shape)) * 0.5).astype(np.float32)
    want = np.asarray(make_batched_conv_lnl(constants, spec, jnp.float32, tile=2)(
        jnp.asarray(raws)))
    consts = _consts(spec, torch.float32)
    assert CL.conv_route(shape) == "global"
    conv, mvar = CL.padded_fft_conv_plain(torch.as_tensor(raws), consts)
    got = gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var), consts.good)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(CL.batched_conv_lnl(torch.as_tensor(raws), consts).numpy(),
                               want, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_251():
    """The 251x251 spec, three walkers' raw images (float64) and the JAX
    package's lnL and ``jax.grad`` of ``sum(grad_b lnl_b)`` there."""
    spec = _spec((251, 251), 7)
    rng = np.random.RandomState(11)
    raws = 0.1 + np.abs(rng.randn(3, 251, 251)) * 0.5
    grad = rng.uniform(0.5, 2.0, 3)
    fn = _jax_lnl(spec)
    lnl = np.asarray(fn(jnp.asarray(raws)))
    dlnl = np.asarray(jax.grad(lambda r: jnp.sum(fn(r) * grad))(jnp.asarray(raws)))
    return spec, raws, grad, lnl, dlnl


def test_global_residual_and_backward_plains_match_jax_grad(jax_251):
    """At 251x251, float64: the residual plain's lnL
    (:func:`padded_fft_conv_residuals_plain`) within 1e-10 of the JAX
    reference's; the backward from its residuals
    (:func:`padded_fft_conv_backward_from_residuals_plain`, the route's
    scheme) and the backward of record
    (:func:`batched_conv_lnl_backward_plain`) within 1e-8 of the largest
    entry of ``jax.grad``; the residual wrapper and the backward wrapper on
    CPU tensors take those plain versions, uncounted."""
    spec, raws, grad, want_lnl, want = jax_251
    consts = _consts(spec, torch.float64)
    r, g = torch.as_tensor(raws), torch.as_tensor(grad)
    before = (dict(CL.batched_conv_lnl.route_launches),
              dict(CL.batched_conv_lnl_backward.route_launches))
    lnl, weights, scale_exp = CL.batched_conv_lnl_residuals(r, consts)
    np.testing.assert_allclose(lnl.numpy(), want_lnl, rtol=1e-10)
    for got in (CL.padded_fft_conv_backward_from_residuals_plain(r, consts, lnl, g, weights,
                                                                 scale_exp),
                CL.batched_conv_lnl_backward(r, consts, lnl, g, (weights, scale_exp))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max())
    assert (dict(CL.batched_conv_lnl.route_launches),
            dict(CL.batched_conv_lnl_backward.route_launches)) == before


def test_global_per_target_spectra_plain_matches_jax():
    """Per-target PSF spectra at 251x251 (K = 2 targets, each with its own
    observation and PSF): the stacked consts carry each target's padded
    spectra, and the route's plain scheme and the version of record give
    each walker its own target's lnL, against the JAX reference in float64
    to 1e-10."""
    specs = [_spec((251, 251), 20 + k) for k in range(2)]
    f_psf = np.stack([s.f_psf_stack[0] for s in specs])
    f_psf[1] *= 0.9  # the second target's PSF differs in more than its noise
    f_var = np.stack([s.f_var_stack[0] for s in specs])
    stack = CL.make_conv_lnl_consts_stack(
        f_psf, f_var, np.stack([s.obs_data for s in specs]),
        np.stack([s.obs_var for s in specs]), np.stack([~s.bad_px for s in specs]),
        "cpu", torch.float64)
    assert CL.conv_route(stack.shape) == "global" and stack.target_spectra
    assert tuple(stack.pad_psf_r.shape) == (2, 504, 253)
    raws = 0.1 + np.abs(np.random.RandomState(4).randn(4, 251, 251)) * 0.5
    want = []
    for k, spec in enumerate(specs):
        want.append(np.asarray(_jax_lnl(spec, f_psf[k])(jnp.asarray(raws[2 * k:2 * k + 2]))))
    r = torch.as_tensor(raws)
    conv, mvar = CL.padded_fft_conv_plain(r, stack)
    x, c = CL._split_targets(r, stack)
    got = gaussian_lnlike(c.obs - conv.reshape(x.shape),
                          1.0 / (mvar.reshape(x.shape) + c.obs_var), c.good)
    np.testing.assert_allclose(got.reshape(-1).numpy(), np.concatenate(want), rtol=1e-10)
    np.testing.assert_allclose(CL.batched_conv_lnl(r, stack).numpy(), np.concatenate(want),
                               rtol=1e-10)


def test_global_consts_carry_the_padded_spectra_and_cluster_tables():
    """At 235x512 (a 480x512 transform) the consts hold the padded kernels'
    half spectra and the mixed-radix tables of the transform, powers of two
    included (``cluster_tables``)."""
    shape = (235, 512)
    _, consts, f_psf, _ = _inputs(shape, 9, b=2)
    assert consts.padded_shape == (480, 512)
    assert tuple(consts.pad_psf_r.shape) == (480, 257)
    twiddle, layout = CL.cluster_tables((480, 512), np.float64)
    np.testing.assert_array_equal(consts.pad_twiddle.numpy(), twiddle)
    np.testing.assert_array_equal(consts.pad_layout.numpy(), layout)
    want = CL._padded_spectrum(f_psf, shape, (480, 512))
    np.testing.assert_allclose(consts.pad_psf_r.numpy(), want.real, atol=1e-12)


@pytest.mark.parametrize("shape", [(512, 512), (640, 640)], ids=_ids)
def test_fused_gate_takes_the_flagship_on_the_global_route(shape):
    """The flagship at 512x512 and 640x640 passes the JAX gate and the
    port's, now on the global route (512x512 was the one shape family the
    port refused)."""
    from test_torch_fused_routes import _specs, jax_fused_gate

    jspec, carried = _specs(shape, (64, 64))
    assert FL.fused_route(shape) == "global"
    assert jax_fused_gate(jspec, "dft")
    assert FL.fused_lnl_supported(carried) == (True, "")


@pytest.mark.parametrize("shape", [(251, 251), (512, 512)], ids=_ids)
def test_survey_mode_stays_on_the_kernel_path_at_a_global_shape(shape):
    """A batch fit with a PSF per target at a shape of the global route
    takes the kernel path (before the global route: the general path, the
    matmul-DFT route's spectra being shared GEMM operands)."""
    from psfmc_tpu_torch.flagship import flagship_components
    from psfmc_tpu_torch.models import build_model_spec, build_posterior

    fns = build_posterior(build_model_spec(flagship_components(shape, (16, 16))),
                          device="cpu")
    assert CL.conv_route(shape) == "global"
    assert fns.obs_mode() == fns.obs_mode(True) == "batched"
