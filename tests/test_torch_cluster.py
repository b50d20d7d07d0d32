"""conv_lnl's cluster route, in its plain versions.

The cluster route (``csrc/fft_cluster.cuh``) holds one walker's transform
across the shared memory of a thread-block cluster of C blocks, and runs
only on the card.  What runs here: the route rule as a function of the
shape; the cluster's schedule emulated in plain PyTorch rank by rank (the
row split, the column ownership, the pair step's partners across ranks,
the readout and lnL reduced over ranks, the backward's placement of the
weights), held against ``torch.fft`` and the padded route's plain schemes,
with the block limit shrunk so that small shapes need clusters of 2 and 4
blocks; and the route's plain path at 94x94 against the JAX package's
batched conv+lnL Pallas kernel in interpret mode.  Inputs come from numpy
seeds; every tolerance is stated where it is asserted.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.ops.pallas.lnpost_batched import make_batched_conv_lnl
from psfmc_tpu_torch.ops import convolve
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.likelihood import gaussian_lnlike

from test_torch_kernels import _jax_flagship_spec


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)


@pytest.mark.parametrize("shape,ranks", [
    ((88, 88), 2), ((94, 94), 2), ((101, 101), 2), ((160, 180), 2), ((196, 196), 2),
    ((200, 200), 2), ((128, 256), 2), ((256, 256), 4), ((450, 450), 8),
    # a side of 1, and transforms that fit no cluster of 8: 512x512, and
    # 235x235 and 470x470 padded to 480x480 and 960x960
    ((1, 64), 0), ((512, 512), 0), ((235, 235), 0), ((470, 470), 0),
], ids=_ids)
def test_cluster_route_is_a_function_of_the_shape(shape, ranks):
    """The cluster route takes the shapes whose transform
    (:func:`padded_shape`: 88x88 -> 180x180, 94x94 -> 192x192, 101x101 ->
    210x210, the FFT route's own sides otherwise) fits no block, on the
    smallest cluster whose blocks each hold their rows; the transforms no
    cluster holds take the global route, a side of 1 the matmul-DFT route.
    The fused kernel takes the same route; per-target spectra are read
    off the matmul-DFT route."""
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL

    assert CL.cluster_size(shape) == ranks
    rest = "global" if min(shape) > 1 else "dft"
    assert CL.conv_route(shape) == ("cluster" if ranks else rest)
    assert FL.fused_route(shape) == CL.conv_route(shape)
    assert CL.target_spectra_supported(shape) == (min(shape) > 1)
    if not ranks:
        return
    limit = CL.BLOCK_SMEM_LIMIT
    transform = CL.padded_shape(shape)
    assert CL.fft_smem_bytes(transform) + CL._FFT_STATIC_SMEM > limit
    for c in CL.CLUSTER_SIZES:
        fits = CL.cluster_smem_bytes(transform, c) + CL._CLUSTER_STATIC_SMEM <= limit
        assert fits == (c >= ranks)
    # every block holds rows; the tables are the mixed-radix form
    assert (ranks - 1) * -(-transform[0] // ranks) < transform[0]


# (image shape, cluster size), the block limit shrunk to what that many
# blocks need: a padded transform (22x26 -> 48x54), the FFT route's own
# sides (24x20, mixed radix; 16x32, powers of two), odd sides (15x21 ->
# 30x42: rows 8, 8, 8, 6) and 101x101 -> 210x210 over 4 ranks (53, 53, 53,
# 51 rows)
SHRUNK = [((22, 26), 2), ((22, 26), 4), ((24, 20), 2), ((16, 32), 4), ((15, 21), 4),
          ((101, 101), 4)]


def _shrink(monkeypatch, shape, ranks):
    limit = CL.cluster_smem_bytes(CL.padded_shape(shape), ranks) + CL._CLUSTER_STATIC_SMEM
    monkeypatch.setattr(CL, "BLOCK_SMEM_LIMIT", limit)
    assert CL.conv_route(shape) == "cluster" and CL.cluster_size(shape) == ranks


def _spectra(shape, rng):
    h, w = shape
    k = np.zeros(shape)
    k[h // 2 - 2:h // 2 + 3, w // 2 - 2:w // 2 + 3] = rng.rand(5, 5)
    k /= k.sum()
    shifted = np.fft.ifftshift(k)
    return np.fft.rfft2(shifted), np.fft.rfft2(shifted * shifted * 1e-4)


def _inputs(shape, seed, b=4):
    """``(raws, consts, f_psf, f_var)`` in float64: a walker with a NaN
    pixel (lnL -inf) among them, some bad pixels."""
    rng = np.random.RandomState(seed)
    f_psf, f_var = _spectra(shape, rng)
    obs = 0.5 + rng.randn(*shape) * 0.1
    good = rng.rand(*shape) > 0.1
    consts = CL.make_conv_lnl_consts(f_psf, f_var, obs, rng.rand(*shape) * 0.01 + 0.01,
                                     good, "cpu", torch.float64)
    raws = torch.as_tensor(0.1 + np.abs(rng.randn(b, *shape)) * 0.5)
    raws[1, 2, 3] = float("nan")
    return raws, consts, f_psf, f_var


class _Ranks:
    """A transform's split over the ranks of a cluster, as
    ``csrc/fft_cluster.cuh``'s ``ClusterGeom`` makes it: rank ``r`` holds
    rows ``[r R, r R + R)`` (``R = ceil(M_h / C)``), owns the columns
    ``[r Wc, r Wc + Wc)`` in the column passes and reads out the image rows
    ``[r Hc, r Hc + Hc)``.  Each rank's rows are a tensor of its own; an
    element is reached through :meth:`where`, the (rank, local row) of a
    row."""

    def __init__(self, image, transform, ranks):
        (self.h, self.w), (self.mh, self.mw), self.ranks = image, transform, ranks
        self.rows = -(-self.mh // ranks)
        cols, hc = -(-self.mw // ranks), -(-self.h // ranks)
        self.row0 = [r * self.rows for r in range(ranks)]
        self.nrows = [min(self.rows, self.mh - r0) for r0 in self.row0]
        self.col0 = [r * cols for r in range(ranks)]
        self.ncols = [min(cols, self.mw - c0) for c0 in self.col0]
        self.img0 = [r * hc for r in range(ranks)]
        self.nimg = [max(0, min(hc, self.h - i0)) for i0 in self.img0]

    def where(self, y):
        return y // self.rows, y % self.rows

    def gather(self, blocks, ys, xs):
        """``(B, *ys.shape)``: the elements at rows ``ys`` and columns ``xs``."""
        rank, local = self.where(ys)
        out = blocks[0].new_zeros((blocks[0].shape[0],) + ys.shape)
        for q, blk in enumerate(blocks):
            m = rank == q
            out[:, m] = blk[:, local[m], xs[m]]
        return out

    def scatter(self, blocks, ys, xs, values):
        rank, local = self.where(ys)
        for q, blk in enumerate(blocks):
            m = rank == q
            blk[:, local[m], xs[m]] = values[:, m]


def _tables(consts):
    mh, mw = consts.padded_shape
    lay = consts.pad_layout.numpy().astype(np.int64)
    pos_h, bin_h, pos_w, bin_w = np.split(lay[20:], np.cumsum([mh, mh, mw]))
    tw = torch.complex(consts.pad_twiddle[:, 0], consts.pad_twiddle[:, 1])
    nh = CL._twiddle_entries(mh)
    return (pos_h, bin_h, pos_w, bin_w), tw[:nh], tw[nh:]


def _columns(g, blocks, tw_h, inverse):
    """The column passes: each rank transforms the columns it owns, every
    element read and written in the rank that holds its row; each column
    has exactly one owner."""
    owners = np.zeros(g.mw, np.int64)
    for r in range(g.ranks):
        xs = np.arange(g.col0[r], g.col0[r] + g.ncols[r])
        owners[xs] += 1
        ys, xs = np.meshgrid(np.arange(g.mh), xs, indexing="ij")
        col = g.gather(blocks, ys, xs).transpose(-1, -2)
        g.scatter(blocks, ys, xs, CL._stages_1d(col, tw_h, inverse).transpose(-1, -2))
    assert (owners == 1).all()


def _pair_step(g, blocks, layout, spectra, gain):
    """Each rank walks its own row positions (the even column positions,
    and the column ``kx = W/2`` where it holds the row) and writes the pair
    ``(k, -k)``, the partner in whichever rank holds it; returns how often
    each slot was written (each exactly once)."""
    pos_h, bin_h, pos_w, bin_w = layout
    mh, mw = g.mh, g.mw
    wh = mw // 2
    psf = torch.complex(spectra[0], spectra[1]).reshape(-1)
    var = torch.complex(spectra[2], spectra[3]).reshape(-1) * gain
    written = np.zeros((mh, mw), np.int64)
    for r in range(g.ranks):
        lr, c = np.meshgrid(np.arange(g.nrows[r]), np.arange(0, mw, 2), indexing="ij")
        y1, x1 = (g.row0[r] + lr).ravel(), c.ravel()
        ky, kx = bin_h[y1], bin_w[x1]
        keep = ~((kx == 0) & (ky > mh // 2))
        y1, x1, ky, kx = y1[keep], x1[keep], ky[keep], kx[keep]
        half = np.arange(mh // 2 + 1)
        mine = (pos_h[half] >= g.row0[r]) & (pos_h[half] < g.row0[r] + g.nrows[r])
        y1 = np.concatenate([y1, pos_h[half[mine]]])
        x1 = np.concatenate([x1, np.full(mine.sum(), pos_w[wh])])
        ky = np.concatenate([ky, half[mine]])
        kx = np.concatenate([kx, np.full(mine.sum(), wh)])
        nky, nkx = (-ky) % mh, (-kx) % mw
        y2, x2 = pos_h[nky], pos_w[nkx]
        other = ~((nky == ky) & (nkx == kx))
        z1, z2 = g.gather(blocks, y1, x1), g.gather(blocks, y2, x2)
        e = torch.as_tensor(ky * (wh + 1) + kx)
        a = 0.5 * (z1 + z2.conj())
        b = -0.5j * (z1 - z2.conj())
        p, q = a * psf[e], b * var[e]
        g.scatter(blocks, y1, x1, p + 1j * q)
        g.scatter(blocks, y2[other], x2[other], (p.conj() + 1j * q.conj())[:, other])
        np.add.at(written, (y1, x1), 1)
        np.add.at(written, (y2[other], x2[other]), 1)
    return written


def _transform(g, blocks, consts, spectra, layout, tw_h, tw_w, ys=None):
    """Steps 2-4 of the schedule: the row passes on each rank's rows (the
    first multiplying the imaginary parts by ``ys``), the column passes,
    the pair step, the inverse column and row passes."""
    if ys is not None:
        blocks = [torch.complex(b.real, b.imag * ys[:, None, None]) for b in blocks]
    blocks = [CL._stages_1d(b, tw_w, False) for b in blocks]
    _columns(g, blocks, tw_h, False)
    written = _pair_step(g, blocks, layout, spectra, consts.var_gain)
    assert (written == 1).all()
    _columns(g, blocks, tw_h, True)
    return [CL._stages_1d(b, tw_w, True) for b in blocks]


def _read(g, blocks, y, x):
    """What output pixels ``(y, x)`` read: the shifted slot and, along a
    padded axis where it is ``s <= N - 2``, also ``s + N``."""
    y, x = (y + g.h // 2) % g.h, (x + g.w // 2) % g.w
    fx = torch.as_tensor((g.mw != g.w) & (x < g.w - 1))
    fy = torch.as_tensor((g.mh != g.h) & (y < g.h - 1))
    xx, yy = np.where(fx, x + g.w, x), np.where(fy, y + g.h, y)

    def line(rows):  # slot s of the row, plus s + N along a padded axis
        v = g.gather(blocks, rows, x)
        return v + torch.where(fx, g.gather(blocks, rows, xx), 0)

    return line(y) + torch.where(fy, line(yy), 0)


def _cluster_forward(raws, consts, ranks):
    """``(lnl, conv, mvar)`` by the cluster route's forward, rank by rank:
    each rank loads and pads its rows, the scale from the peak over the
    ranks (NaNs dropped), the pack, the transform, the readout of its image
    rows and its lnL; the ranks' lnLs summed in rank order."""
    g = _Ranks(consts.shape, consts.padded_shape, ranks)
    layout, tw_h, tw_w = _tables(consts)
    b = raws.shape[0]
    blocks, peaks = [], []
    for r in range(ranks):
        ys = np.arange(g.row0[r], g.row0[r] + g.nrows[r])
        blk = raws.new_zeros((b, g.nrows[r], g.mw))
        inside = ys < g.h
        blk[:, np.flatnonzero(inside), :g.w] = raws[:, ys[inside]]
        blocks.append(blk)
        peaks.append(torch.nan_to_num(blk.abs(), nan=0.0).amax(dim=(-2, -1)))
    exponent, _ = CL._peak_exponent(torch.stack(peaks, -1)[..., None])
    exponent = exponent.clamp(-CL._MAX_SCALE_EXP, CL._MAX_SCALE_EXP)
    s = torch.ldexp(torch.ones(b, dtype=raws.dtype), -exponent)[:, None, None]
    blocks = [torch.complex(x, (x * x) * s) for x in blocks]
    spectra = (consts.pad_psf_r, consts.pad_psf_i, consts.pad_var_r, consts.pad_var_i)
    blocks = _transform(g, blocks, consts, spectra, layout, tw_h, tw_w)
    inv = 1.0 / (g.mh * g.mw)
    conv = raws.new_zeros(raws.shape)
    mvar = raws.new_zeros(raws.shape)
    total = torch.zeros(b, dtype=torch.float64)
    for r in range(ranks):
        rows = np.arange(g.img0[r], g.img0[r] + g.nimg[r])
        y, x = np.meshgrid(rows, np.arange(g.w), indexing="ij")
        v = _read(g, blocks, y, x)
        c = v.real * inv
        m = v.imag * (torch.ldexp(torch.full((b,), inv, dtype=raws.dtype), exponent)
                      [:, None, None] / consts.var_gain)
        conv[:, rows], mvar[:, rows] = c, m
        ivm = 1.0 / (m + consts.obs_var[rows])
        total += gaussian_lnlike(consts.obs[rows] - c, ivm, consts.good[rows])
    lnl = torch.where(torch.isfinite(total), total, torch.full_like(total, -np.inf))
    return lnl, conv, mvar


def _cluster_backward(raws, consts, lnl, grad, weights, scale_exp, ranks):
    """The cluster route's backward, rank by rank: each rank copies the
    weights into the slots of its own rows that the forward's readout read
    (the shift undone; along a padded axis slot ``t`` in ``[N, 2N - 2]``
    takes slot ``t - N``'s), zeros elsewhere; the transform with the
    conjugate spectra, the imaginary parts scaled by ``2^scale_exp``; the
    combine of its image rows; 0 for a walker whose lnL is not finite."""
    g = _Ranks(consts.shape, consts.padded_shape, ranks)
    layout, tw_h, tw_w = _tables(consts)
    h, w = g.h, g.w
    packed = torch.complex(weights[..., 0], weights[..., 1])
    blocks = []
    for r in range(ranks):
        ty, tx = np.meshgrid(np.arange(g.row0[r], g.row0[r] + g.nrows[r]),
                             np.arange(g.mw), indexing="ij")
        inside = (ty <= 2 * h - 2) & (tx <= 2 * w - 2)
        y = (np.where(ty < h, ty, ty - h) - h // 2) % h
        x = (np.where(tx < w, tx, tx - w) - w // 2) % w
        blk = packed.new_zeros((raws.shape[0],) + ty.shape)
        blk[:, inside] = packed[:, y[inside], x[inside]]
        blocks.append(blk)
    s = torch.ldexp(torch.ones_like(lnl), scale_exp.to(torch.int64))
    spectra = (consts.pad_psf_r, consts.pad_psf_ic, consts.pad_var_r, consts.pad_var_ic)
    blocks = _transform(g, blocks, consts, spectra, layout, tw_h, tw_w, ys=s)
    inv = 1.0 / (g.mh * g.mw)
    out = raws.new_zeros(raws.shape)
    for r in range(ranks):
        rows = np.arange(g.img0[r], g.img0[r] + g.nimg[r])
        y, x = np.meshgrid(rows, np.arange(w), indexing="ij")
        v = g.gather(blocks, y, x)
        gc = v.imag * (inv / s / consts.var_gain)[:, None, None]
        out[:, rows] = grad[:, None, None] * (v.real * inv + 2.0 * raws[:, rows] * gc)
    return torch.where(torch.isfinite(lnl)[:, None, None], out, torch.zeros_like(out))


def _close(got, want, rtol):
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    scale = want[fin].abs().max().item()
    torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("shape,ranks", SHRUNK, ids=_ids)
def test_cluster_schedule_matches_the_plain_schemes(monkeypatch, shape, ranks):
    """The forward's schedule, rank by rank, with the block limit shrunk
    to what ``ranks`` blocks need: ``(conv, mvar)`` against
    :func:`padded_fft_conv_plain` (the route's plain scheme) and against
    ``torch.fft``'s convolutions, the lnL reduced over the ranks against
    the version of record (:func:`batched_conv_lnl_plain`), all in float64
    to 1e-10 of the largest entry; the NaN walker's lnL is ``-inf`` on
    both.  The consts carry the mixed-radix tables of the transform."""
    _shrink(monkeypatch, shape, ranks)
    raws, consts, f_psf, f_var = _inputs(shape, sum(shape) + ranks)
    transform = consts.padded_shape
    twiddle, layout = CL.cluster_tables(transform, np.float64)
    np.testing.assert_array_equal(consts.pad_twiddle.numpy(), twiddle)
    np.testing.assert_array_equal(consts.pad_layout.numpy(), layout)
    lnl, conv, mvar = _cluster_forward(raws, consts, ranks)
    want_conv, want_mvar = CL.padded_fft_conv_plain(raws, consts)
    keep = torch.isfinite(raws).all(dim=2).all(dim=1)
    for got, want in ((conv, want_conv), (mvar, want_mvar),
                      (conv, convolve(raws, torch.as_tensor(f_psf))),
                      (mvar, convolve(raws * raws, torch.as_tensor(f_var)))):
        _close(got[keep], want[keep], 1e-10)
    want_lnl = CL.batched_conv_lnl_plain(raws, consts)
    assert lnl[1] == -np.inf and want_lnl[1] == -np.inf
    _close(lnl, want_lnl, 1e-10)


@pytest.mark.parametrize("shape,ranks", SHRUNK, ids=_ids)
def test_cluster_backward_schedule_matches_the_plain_schemes(monkeypatch, shape, ranks):
    """The backward's schedule, rank by rank, from the residuals of
    :func:`padded_fft_conv_residuals_plain`: against the route's plain
    scheme (:func:`padded_fft_conv_backward_from_residuals_plain`) to
    1e-10 and against the version of record
    (:func:`batched_conv_lnl_backward_plain`) to 1e-8 of the largest
    gradient, float64; the NaN walker's gradient is zero."""
    _shrink(monkeypatch, shape, ranks)
    raws, consts, _, _ = _inputs(shape, 3 * sum(shape) + ranks)
    lnl, weights, scale_exp = CL.padded_fft_conv_residuals_plain(raws, consts)
    grad = torch.as_tensor(np.random.RandomState(5).uniform(0.5, 2.0, raws.shape[0]))
    got = _cluster_backward(raws, consts, lnl, grad, weights, scale_exp, ranks)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    _close(got, CL.padded_fft_conv_backward_from_residuals_plain(
        raws, consts, lnl, grad, weights, scale_exp), 1e-10)
    _close(got, CL.batched_conv_lnl_backward_plain(raws, consts, lnl, grad), 1e-8)


def test_cluster_route_on_the_cpu_takes_the_plain_versions():
    """At 94x94 (a 192x192 transform on 2 blocks) the wrappers on CPU
    tensors take the plain versions, uncounted: the forward the version of
    record, the residual forward the padded scheme (the same lnL to 1e-10),
    the backward the version of record; the consts carry the padded
    kernels' spectra and the transform's mixed-radix tables."""
    shape = (94, 94)
    raws, consts, _, _ = _inputs(shape, 94, b=3)
    assert CL.conv_route(shape) == "cluster" and consts.padded_shape == (192, 192)
    assert tuple(consts.pad_psf_r.shape) == (192, 97)
    before = (dict(CL.batched_conv_lnl.route_launches),
              dict(CL.batched_conv_lnl_backward.route_launches))
    lnl = CL.batched_conv_lnl(raws, consts)
    res = CL.batched_conv_lnl_residuals(raws, consts)
    for got, want in zip(res, CL.padded_fft_conv_residuals_plain(raws, consts)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    _close(res[0], lnl, 1e-10)
    grad = torch.ones(3, dtype=torch.float64)
    torch.testing.assert_close(
        CL.batched_conv_lnl_backward(raws, consts, lnl, grad, res[1:]),
        CL.batched_conv_lnl_backward_plain(raws, consts, lnl, grad), rtol=0, atol=0)
    assert (dict(CL.batched_conv_lnl.route_launches),
            dict(CL.batched_conv_lnl_backward.route_launches)) == before


def test_cluster_launch_errors_name_the_shape_and_the_cluster():
    """A cluster route launch that the card refuses raises with the image,
    the transform, the cluster's size and each block's shared memory; -1
    (no such cluster fits the card) says that it cannot be scheduled.
    Nothing falls back to another route."""
    unschedulable = CL._launch_error("conv_lnl", "cluster", (256, 256), -1)
    assert "can be scheduled on this card" in unschedulable
    assert "256x256 walker" in unschedulable and "cluster of 4 blocks" in unschedulable
    assert f"{CL.cluster_smem_bytes((256, 256), 4)} bytes" in unschedulable
    refused = CL._launch_error("conv_lnl backward", "cluster", (94, 94), 1)
    assert "cudaError 1" in refused and "192x192 transform" in refused


def test_cluster_plain_lnl_matches_pallas_batched(monkeypatch):
    """The lnL at 94x94 through the cluster route's plain scheme
    (``padded_fft_conv_plain`` at the 192x192 transform) and through the
    version of record against the JAX package's batched conv+lnL Pallas
    kernel (interpret mode, true-fp32 products), rtol 1e-5, float32 on
    both sides."""
    monkeypatch.setenv("PSFMC_LNPOST_DOT", "highest")
    rng = np.random.RandomState(47)
    spec = _jax_flagship_spec(rng, (94, 94), psf_side=16)
    constants = jax_posterior(spec).constants
    raws = (0.1 + np.abs(rng.randn(4, *spec.shape)) * 0.5).astype(np.float32)
    lnl_jax = make_batched_conv_lnl(constants, spec, jnp.float32, tile=2)
    want = np.asarray(lnl_jax(jnp.asarray(raws)))
    consts = CL.make_conv_lnl_consts(
        spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
        spec.obs_var, ~spec.bad_px, "cpu", torch.float32,
    )
    assert CL.conv_route(consts.shape) == "cluster"
    conv, mvar = CL.padded_fft_conv_plain(torch.as_tensor(raws), consts)
    got = gaussian_lnlike(consts.obs - conv, 1.0 / (mvar + consts.obs_var),
                          consts.good).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(CL.batched_conv_lnl(torch.as_tensor(raws), consts).numpy(),
                               want, rtol=1e-5)
