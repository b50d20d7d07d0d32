"""Batched convolution + Gaussian likelihood: CUDA kernel wrapper and plain version.

Counterpart of ``psfmc_tpu/ops/pallas/lnpost_batched.py``
(``make_batched_conv_lnl``): given rendered raw model images ``(B, H,
W)``, convolve each with the PSF and its square with the PSF variance
map, then reduce the masked Gaussian lnL per walker:

    lnl_b = -1/2 sum_good [(obs - conv_b)^2 ivm_b - log(ivm_b / 2 pi)],
    ivm_b = 1 / (mvar_b + obs_var)

with non-finite results mapped to ``-inf``.  The CUDA source
(``csrc/conv_lnl.cu``) has five routes, and the shape alone picks one
before the launch (:func:`conv_route`):

* ``"fft"``, when ``H`` and ``W`` are even with no prime factor above
  7 and one walker fits in a block's shared memory (64x64, 128x128,
  64x256, 96x96, 100x100, 98x98, 96x128, 144x144, ...): one launch, one
  block per walker, both convolutions as one complex 2-D FFT pair that
  never leaves shared memory (``csrc/fft_conv.cuh``; radix-2 stages when
  both sides are powers of two, radix-2, -3, -5 and -7 stages otherwise,
  planned by :func:`fft_plan`).  :func:`packed_fft_conv_plain` is that scheme in
  plain PyTorch and :func:`fft_stages_plain` its butterfly schedule, for
  the tests;
* ``"padded"``, when a side is odd or has a prime factor above 7 and
  each such side ``N`` pads to ``M = padded_size(N)`` (the smallest even
  7-smooth side of at least ``2N - 1``) with the ``M_h x M_w`` transform
  in a block (74x74 -> 150x150, 45x75 -> 90x150, 64x74 -> 64x150; every
  side up to 81): the same launch on the FFT route's geometry at ``M``.
  The image and the kernel (the ``N``-periodic PSF, placed at ``[0, N)``)
  are zero-padded, so the ``M``-point circular convolution is the linear
  one, and the readout folds it back, ``y[s] = z[s] + z[s + N]``: exactly
  the ``N``-point circular convolution.  :func:`padded_fft_conv_plain` is
  that scheme in plain PyTorch;
* ``"cluster"``, when the FFT route's or the padded route's transform
  (:func:`padded_shape`) fits no block but fits a thread-block cluster of
  ``C = 2, 4`` or ``8`` blocks (:func:`cluster_size`: 88x88 -> 180x180,
  94x94 -> 192x192, 101x101 -> 210x210, 160x180, 196x196 and 200x200 on
  2 blocks, 256x256 on 4): the padded route's scheme at that transform,
  its rows split over the blocks' shared memory and the column passes,
  the pair step and the readout reaching the other blocks' rows through
  Hopper's distributed shared memory (``csrc/fft_cluster.cuh``), one
  cluster a walker.  Its plain scheme is :func:`padded_fft_conv_plain`'s
  (at a transform that pads no side, the FFT route's);
* ``"global"``, when the transform fits no cluster of 8 (from about 470
  a side, so 512x512, 640x640 and every image side from about 226 up that
  is off the FFT route's sides: 235x235 -> 480x480, 251x251 -> 504x504):
  the padded route's scheme at that transform with the cluster route's
  tables, the transform's rows in a global-memory scratch ``(B, H, M_w)``
  complex64 (``csrc/fft_global.cuh``: a peak pass, the row passes by
  tiles of rows, the column passes and the pair step by groups of bins
  with their Hermitian partners, the inverse row passes with the readout
  by tiles, each walker's partial sums reduced in tile order; five
  launches, :func:`global_tiles` sizing the tiles);
* ``"dft"``, a side of 1: each convolution as the twelve real
  half-spectrum products of
  :func:`psfmc_tpu_torch.ops.fourier.convolve_rdft`, run as fp32 FMA
  GEMMs of the kernel's own through global scratch (15 launches).

No route is a fallback for another: a launch that fails raises (on the
cluster route also where the card cannot schedule the cluster).

Targets (the batch fit, :mod:`psfmc_tpu_torch.batchfit`): one launch may
carry the walkers of ``K`` independent fits.  A stacked
:class:`ConvLnlConsts` (:func:`make_conv_lnl_consts_stack`) holds each
target's observation, variance and mask planes ``(K, H, W)`` and, in
survey mode, its own PSF's spectra ``(K, ...)`` and variance gain
``(K,)``; walker ``b`` of a batch of ``B`` reads target ``b // (B / K)``.
The planes run on every route, per-target spectra on every route but the
matmul-DFT one: there the spectra are GEMM operands, and the wrapper
refuses them (:func:`target_spectra_supported`; the posterior sends such a
batch to its general path).  The plain versions take the same target
axis, and so do the residual instantiation and the backward kernels (the
hierarchical fit, :mod:`psfmc_tpu_torch.hierarchy`, differentiates a
stack): off the matmul-DFT route the backward reads only each target's
spectra and variance gain (its planes are inside the forward's weights),
on it the weights kernel reads each target's planes.
The Pallas kernel's emulated-precision dot modes (bf16x3) existed only
because Mosaic lacks an fp32-accurate product; they are not ported:
true fp32 is the contract.

On CPU tensors :func:`batched_conv_lnl` returns the plain version
(:func:`batched_conv_lnl_plain`, the version of record that every route
is held to); on CUDA tensors it launches the kernel or raises.

The gradient: when the raw images require it, :func:`batched_conv_lnl`
goes through a ``torch.autograd.Function`` whose backward maps ``dlnL
(B,)`` to ``dlnL/draw (B, H, W)`` (:func:`batched_conv_lnl_backward`).
With ``r = obs - conv`` and ``ivm = 1 / (mvar + obs_var)``::

    a = good r ivm,   c = good (r^2 ivm^2 - ivm) / 2,
    dlnL/draw = dlnL_b [a (x) psf + 2 raw (c (x) var)]

where ``(x)`` is the adjoint of the forward convolution (a correlation:
the conjugate spectrum, the shift undone); a walker whose lnL is not
finite gets a zero gradient.  On CUDA the hand-written kernels of
``csrc/conv_lnl_backward.cu`` on the route the shape takes, on the CPU
:func:`batched_conv_lnl_backward_plain`.  Off the matmul-DFT route the
forward under autograd is a second instantiation of the forward kernel
(:func:`batched_conv_lnl_residuals`, counted on the route ``"fft_res"``,
``"padded_res"`` on the padded route, ``"cluster_res"`` on the cluster
route, ``"global_res"`` on the global route):
the same lnL bits, and it also writes ``(a, c)`` per pixel (8 bytes a
pixel, kept for the backward: 16.4 MB at 125 walkers x 128x128) and
each walker's scale exponent; the backward loads them and runs one
packed pair ``a + i s c`` through the in-shared-memory FFT with the
conjugate spectra.  The matmul-DFT route's backward recomputes the
forward through the transposed GEMMs.  :func:`packed_fft_conv_residuals_plain`
and :func:`packed_fft_conv_backward_from_residuals_plain` are the FFT
route's scheme in plain PyTorch (:func:`packed_fft_conv_backward_plain`
the two in turn); on the padded route the backward writes each weight
to the slots its pixel was folded from (the adjoint of the fold), runs
the same pair at ``M`` and crops ``[0, N)`` (the adjoint of the zero
pad): :func:`padded_fft_conv_residuals_plain` and
:func:`padded_fft_conv_backward_from_residuals_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..fourier import convolve_rdft, rdft_matrices
from ..likelihood import gaussian_lnlike
from . import _build, counts

__all__ = [
    "batched_lnl_supported",
    "target_spectra_supported",
    "ConvLnlConsts",
    "make_conv_lnl_consts",
    "make_conv_lnl_consts_stack",
    "copy_target_consts_",
    "batched_conv_lnl",
    "batched_conv_lnl_plain",
    "conv_route",
    "cluster_size",
    "cluster_smem_bytes",
    "cluster_tables",
    "global_column_smem",
    "global_row_smem",
    "global_tiles",
    "padded_size",
    "padded_shape",
    "fft_smem_bytes",
    "fft_twiddles",
    "fft_plan",
    "fft_layout",
    "fft_tables",
    "var_spectrum_gain",
    "fft_stages_plain",
    "bit_reversed",
    "digit_reversed",
    "packed_fft_conv_plain",
    "padded_fft_conv_plain",
    "padded_fft_conv_residuals_plain",
    "padded_fft_conv_backward_from_residuals_plain",
    "batched_conv_lnl_residuals",
    "batched_conv_lnl_backward",
    "batched_conv_lnl_backward_plain",
    "packed_fft_conv_residuals_plain",
    "packed_fft_conv_backward_from_residuals_plain",
    "packed_fft_conv_backward_plain",
    "convolve_rdft_adjoint",
]

# Shared memory a block may use on Hopper.
BLOCK_SMEM_LIMIT = 232448
# Static shared memory of the FFT route (csrc/fft_conv.cuh): 16 doubles of
# the lnL reduction and 16 floats of the max reduction.
_FFT_STATIC_SMEM = 16 * 8 + 16 * 4
# |log2| of the squared image's scale is clamped to this (kMaxScaleExp).
_MAX_SCALE_EXP = 96
# The cluster route's sizes (csrc/fft_cluster.cuh: at most kMaxCluster, the
# portable cluster size) and its static shared memory as ptxas lays it out
# for the residual instantiation, the larger: the FFT route's reductions
# with the residual peaks (16 x 3 floats, 16 doubles), the rank's peak, and
# rank 0's 8 sums and 16 peaks, 456 bytes, and 8 of alignment.
CLUSTER_SIZES = (2, 4, 8)
_CLUSTER_STATIC_SMEM = 464
# The global route's tiles (csrc/fft_global.cuh: at most kMaxTile): the
# rows of a row tile and the bins of a column group, the largest that fit a
# block, and its static shared memory (the readout's 16 doubles and 32
# floats, block_max's 17 floats), with room to spare.
GLOBAL_ROWS = (16, 8, 4, 2, 1)
GLOBAL_COLS = (8, 4, 2, 1)
_GLOBAL_STATIC_SMEM = 512

# the routes that run the padded route's scheme at padded_shape with the
# consts' pad_* fields (the cluster and the global route at a transform that
# pads no side too)
_PADDED_SCHEME = ("padded", "cluster", "global")


# The FFT route's radices (conv_lnl's and the fused kernel's).
FFT_RADICES = (2, 3, 5, 7)
# The mixed-radix layout's int tables (csrc/fft_conv.cuh: kMaxPasses,
# kLayoutHeader): passes per axis, and the header before the index tables.
_MAX_PASSES = 8
_LAYOUT_HEADER = 20
# Radix-2 stages a radix-3, -5 or -7 stage takes into its register pass
# (at most 16 elements a thread).
_TWOS_AFTER = {3: 2, 5: 1, 7: 1}


def _power_of_two(n):
    return n >= 2 and n & (n - 1) == 0


def _smooth_even(n):
    """``n`` even, with no prime factor above 7."""
    if n < 2 or n % 2:
        return False
    for r in FFT_RADICES:
        while n % r == 0:
            n //= r
    return n == 1


def _twiddle_entries(n):
    return n // 2 if _power_of_two(n) else n


def fft_plan(n):
    """The register passes of an ``n``-point line on the FFT route, each a
    tuple of stage radices in the order the forward runs them; ``n`` even
    with no prime factor above 7.

    Every radix-3, -5 or -7 stage opens a pass (radix 7 first, then 5,
    then 3) and takes up to two (radix 3) or one (radix 5 and 7) of the
    radix-2 stages after it, filled from the last pass back, so that the
    last stage is radix 2; the radix-2 stages left over make the last
    passes, up to four each and of nearly equal depth (for a power of
    two: the radix-2 route's passes).  96 -> ((3, 2, 2), (2, 2, 2)), 100
    -> ((5, 2), (5, 2)), 98 -> ((7,), (7, 2)), 128 -> ((2, 2, 2, 2), (2,
    2, 2)).
    """
    n = int(n)
    if not _smooth_even(n):
        raise ValueError(f"the FFT route needs an even size with no prime "
                         f"factor above 7 (7-smooth), got {n}")
    twos = 0
    while n % 2 == 0:
        n //= 2
        twos += 1
    odds = []
    for r in (7, 5, 3):
        while n % r == 0:
            n //= r
            odds.append(r)
    passes = [[r] for r in odds]
    for p in reversed(passes):
        take = min(_TWOS_AFTER[p[0]], twos)
        p += [2] * take
        twos -= take
    if twos:
        npass = -(-twos // 4)
        depth, extra = divmod(twos, npass)
        passes += [[2] * (depth + (i < extra)) for i in range(npass)]
    return tuple(tuple(p) for p in passes)


def _stage_radices(n):
    return [r for p in fft_plan(n) for r in p]


def digit_reversed(n):
    """Where the forward leaves bin ``k`` of an ``n``-point line: the
    digits of ``k`` over the stage radices (:func:`fft_plan`, the first
    stage's digit lowest) reversed, ``p_0 n / r_0 + p_1 n / (r_0 r_1) +
    ...``; for a power of two, :func:`bit_reversed`."""
    k = np.arange(n)
    pos = np.zeros(n, np.int64)
    rem, stride = k.copy(), n
    for r in _stage_radices(n):
        stride //= r
        pos += (rem % r) * stride
        rem //= r
    return pos


def fft_layout(shape):
    """The FFT route's int32 layout tables of a shape that is not all
    powers of two (``csrc/fft_conv.cuh``): the header (the first entry of
    ``W``'s twiddle table; per axis the pass count and each pass's code,
    16 x its radix-3, -5 or -7 stage (1 if none) + its radix-2 stages), then
    per axis, ``H`` first, bin -> position (:func:`digit_reversed`) and
    position -> bin."""
    h, w = (int(n) for n in shape)
    header = np.zeros(_LAYOUT_HEADER, np.int64)
    header[0] = _twiddle_entries(h)
    tables = []
    for at, n in ((1, h), (2 + _MAX_PASSES, w)):
        plan = fft_plan(n)
        if len(plan) > _MAX_PASSES:
            raise ValueError(f"a {n}-point line needs {len(plan)} passes, "
                             f"the kernel holds {_MAX_PASSES}")
        header[at] = len(plan)
        for i, p in enumerate(plan):
            odd = p[0] if p[0] != 2 else 1
            header[at + 1 + i] = 16 * odd + p.count(2)
        pos = digit_reversed(n)
        tables += [pos, np.argsort(pos)]
    return np.concatenate([header] + tables).astype(np.int32)


def fft_smem_bytes(shape):
    """Dynamic shared memory of the FFT route's image: ``H`` rows of
    ``W + 1`` ``float2`` (the odd pitch keeps the row passes free of
    bank conflicts) plus the twiddles (``max(H, W) / 2`` when both sides
    are powers of two, else both axes' tables, :func:`fft_tables`) and
    the mixed-radix layout's ints."""
    h, w = (int(n) for n in shape)
    if _power_of_two(h) and _power_of_two(w):
        return 8 * (h * (w + 1) + max(h, w) // 2)
    return (8 * (h * (w + 1) + _twiddle_entries(h) + _twiddle_entries(w))
            + 4 * (_LAYOUT_HEADER + 2 * (h + w)))


def padded_size(n):
    """The padded route's transform side for an image side ``n >= 2``:
    the smallest even integer of at least ``2n - 1`` with no prime factor
    above 7 (74 -> 150, 45 -> 90, 37 -> 80, 31 -> 64).  At that side the
    circular convolution of the zero-padded image and kernel (each held
    on ``[0, n)``) wraps nothing around: it is the linear one."""
    n = int(n)
    if n < 2:
        raise ValueError(f"the padded route needs a side of at least 2, got {n}")
    m = 2 * n
    while not _smooth_even(m):
        m += 2
    return m


def padded_shape(shape):
    """The transform's ``(M_h, M_w)`` on the padded route: a side the FFT
    route takes keeps its size, any other pads to :func:`padded_size`."""
    return tuple(n if _smooth_even(n) else padded_size(n)
                 for n in (int(n) for n in shape))


def _fits_a_block(shape):
    """The FFT route's transform at ``shape`` fits one block's shared
    memory and its passes fit the layout."""
    h, w = shape
    fits = fft_smem_bytes((h, w)) + _FFT_STATIC_SMEM <= BLOCK_SMEM_LIMIT
    return fits and max(len(fft_plan(h)), len(fft_plan(w))) <= _MAX_PASSES


def cluster_smem_bytes(transform, ranks):
    """Dynamic shared memory of one block of the cluster route
    (``csrc/fft_cluster.cuh``'s ``cluster_image_bytes``): its
    ``ceil(M_h / C)`` rows of the ``M_h x M_w`` transform at the pitch
    ``M_w + 1``, both axes' twiddle tables and the mixed-radix layout
    (:func:`cluster_tables`)."""
    h, w = (int(n) for n in transform)
    rows = -(-h // int(ranks))
    return (8 * (rows * (w + 1) + _twiddle_entries(h) + _twiddle_entries(w))
            + 4 * (_LAYOUT_HEADER + 2 * (h + w)))


def cluster_size(shape):
    """The cluster route's number of blocks ``C`` for an ``(H, W)`` image:
    the smallest of :data:`CLUSTER_SIZES` whose blocks each hold their
    share of the transform :func:`padded_shape` (:func:`cluster_smem_bytes`
    plus the static shared memory within ``BLOCK_SMEM_LIMIT``) while every
    block holds at least one row and one column; 0 where none does, the
    passes exceed the layout, or a side is 1."""
    h, w = (int(n) for n in shape)
    if min(h, w) < 2:
        return 0
    mh, mw = padded_shape((h, w))
    if max(len(fft_plan(mh)), len(fft_plan(mw))) > _MAX_PASSES:
        return 0
    for ranks in CLUSTER_SIZES:
        rows, cols = -(-mh // ranks), -(-mw // ranks)
        if (ranks - 1) * rows >= mh or (ranks - 1) * cols >= mw:
            continue
        if cluster_smem_bytes((mh, mw), ranks) + _CLUSTER_STATIC_SMEM <= BLOCK_SMEM_LIMIT:
            return ranks
    return 0


def _global_tables_bytes(transform):
    h, w = transform
    return 8 * (_twiddle_entries(h) + _twiddle_entries(w)) + 4 * (_LAYOUT_HEADER + 2 * (h + w))


def global_row_smem(transform, rows):
    """Dynamic shared memory of one block of the global route's row passes
    (``csrc/fft_global.cuh``'s ``row_smem``): ``rows`` rows of the ``M_h x
    M_w`` transform at the pitch ``M_w + 1``, both axes' twiddle tables and
    the mixed-radix layout."""
    return 8 * rows * (int(transform[1]) + 1) + _global_tables_bytes(transform)


def global_column_smem(transform, cols):
    """Dynamic shared memory of one block of the global route's column
    passes (``column_smem``): every row of ``2 cols`` columns (a group of
    bins and their Hermitian partners) at the pitch ``2 cols + 1``, and the
    tables."""
    return 8 * int(transform[0]) * (2 * cols + 1) + _global_tables_bytes(transform)


def global_tiles(shape):
    """``(rows, cols)`` of the global route for an ``(H, W)`` image: the
    largest of :data:`GLOBAL_ROWS` rows of the transform :func:`padded_shape`
    and of :data:`GLOBAL_COLS` column bins (with their partners) whose block
    fits ``BLOCK_SMEM_LIMIT`` and whose loops stay below 2^16 items
    (``csrc/fft_global.cuh``'s ``plan_ok``); None where none does, the
    passes exceed the layout, or a side is 1."""
    h, w = (int(n) for n in shape)
    if min(h, w) < 2:
        return None
    mh, mw = padded_shape((h, w))
    if max(len(fft_plan(mh)), len(fft_plan(mw))) > _MAX_PASSES:
        return None
    limit = BLOCK_SMEM_LIMIT - _GLOBAL_STATIC_SMEM
    rows = next((r for r in GLOBAL_ROWS if r * mw < 65536
                 and global_row_smem((mh, mw), r) <= limit), None)
    cols = next((c for c in GLOBAL_COLS if 2 * c * mh < 65536
                 and global_column_smem((mh, mw), c) <= limit), None)
    return (rows, cols) if rows and cols else None


def conv_route(shape):
    """``"fft"``, ``"padded"``, ``"cluster"``, ``"global"`` or ``"dft"``:
    the route of ``csrc/conv_lnl.cu`` (and of its backward, and of the
    fused kernel ``csrc/fused_lnl.cu``) for an ``(H, W)`` image, a pure
    function of the shape.  ``"fft"`` needs both sides to be even with no
    prime factor above 7 and the walker's image to fit in one block's
    shared memory; ``"padded"`` takes the other shapes whose
    :func:`padded_shape` fits a block (every side from 2 to 81);
    ``"cluster"`` the shapes whose transform (the FFT route's or the padded
    one) fits no block but fits a cluster (:func:`cluster_size`);
    ``"global"`` the rest whose transform the global route's tiles take
    (:func:`global_tiles`: every shape with both sides from 2 to 1024);
    ``"dft"`` what is left, a side of 1."""
    h, w = (int(n) for n in shape)
    if _smooth_even(h) and _smooth_even(w):
        if _fits_a_block((h, w)):
            return "fft"
    elif min(h, w) < 2:
        return "dft"
    elif _fits_a_block(padded_shape((h, w))):
        return "padded"
    if cluster_size((h, w)):
        return "cluster"
    if global_tiles((h, w)):
        return "global"
    return "dft"


def fft_twiddles(n, dtype=np.float32):
    """The table of ``exp(-2 pi i k / n)`` as ``(cos, -sin)`` rows, built
    in float64 and cast: ``k < n / 2`` for a power of two (radix-2
    stages read no more; a line of length ``n / 2^j`` reads every
    ``2^j``-th entry), ``k < n`` for any other even ``n`` with no prime
    factor above 7 (a radix-3, -5 or -7 stage's output ``p`` reads entry
    ``p j``)."""
    if not _smooth_even(n):
        raise ValueError(f"the twiddle table needs an even size with no prime "
                         f"factor above 7 (7-smooth), got {n}")
    ang = 2.0 * np.pi * np.arange(_twiddle_entries(n)) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)


def cluster_tables(transform, dtype=np.float32):
    """``(twiddle, layout)`` of the cluster route at its ``transform``:
    :func:`fft_tables`' mixed-radix form for every side, powers of two
    included (each axis's table, ``H``'s first, and :func:`fft_layout`)."""
    h, w = (int(n) for n in transform)
    return (np.concatenate([fft_twiddles(h, dtype), fft_twiddles(w, dtype)]),
            fft_layout((h, w)))


def fft_tables(shape, dtype=np.float32):
    """``(twiddle, layout)`` of the FFT route at ``shape``: both sides
    powers of two, one table of ``max(H, W)`` serving both axes and no
    layout; otherwise ``H``'s table then ``W``'s and :func:`fft_layout`."""
    h, w = (int(n) for n in shape)
    if _power_of_two(h) and _power_of_two(w):
        return fft_twiddles(max(h, w), dtype), np.zeros(0, np.int32)
    return (np.concatenate([fft_twiddles(h, dtype), fft_twiddles(w, dtype)]),
            fft_layout((h, w)))


def batched_lnl_supported(spec):
    """``(ok, reason)``: whether the conv+likelihood kernel computes
    ``spec``'s likelihood (the JAX package's ``batched_lnl_supported``).

    The kernel holds one PSF's spectra, reduces the Gaussian lnL of the
    unscaled variance, and has no place for a background added after the
    convolution or for a padded grid: several PSFs, another likelihood
    family, a tilted-plane sky, a ``NoiseScale`` and ``conv_pad`` take
    the general path instead.
    """
    specs = getattr(spec, "comp_specs", ())
    checks = (
        (getattr(spec, "num_psfs", 1) == 1, "several PSFs"),
        (getattr(spec, "likelihood", "gaussian") == "gaussian",
         "a non-Gaussian likelihood"),
        (all(not ({"dx", "dy"} & set(cs.params))
             for cs in specs if cs.kind == "sky"), "a sky gradient"),
        (all(cs.kind != "noisescale" for cs in specs), "a NoiseScale"),
        (getattr(spec, "conv_pad", 0) == 0, "conv_pad > 0"),
    )
    for ok, what in checks:
        if not ok:
            return False, what
    return True, ""


def target_spectra_supported(shape):
    """Whether conv_lnl takes per-target PSF spectra at ``shape``: on every
    route but the matmul-DFT one (each target's spectra are planes the
    blocks read; on the matmul-DFT route they are GEMM operands)."""
    return conv_route(shape) != "dft"


@dataclass(frozen=True)
class ConvLnlConsts:
    """Device constants of the conv+likelihood stage.

    The eight :func:`rdft_matrices` operators, the PSF and PSF-variance
    half spectra as real/imaginary planes ``(H, W2)``, the observation,
    its variance and the good-pixel mask ``(H, W)``, plus the two
    ``(2H, 2H)`` block operators the matmul-DFT route uses for the
    h-direction stages: ``lf = [[ch, sh], [-sh, ch]]`` and ``li = [[ich,
    -ish], [ish, ich]]``; and the FFT route's twiddle table
    and its int32 layout (:func:`fft_tables`: empty unless the shape is
    on the FFT route, or both sizes are powers of two; the layout empty
    then) and its gain on the variance spectrum
    (:func:`var_spectrum_gain`).  The backward kernels also read the
    conjugate spectra's imaginary planes (``psf_ic = -psf_i``, ``var_ic =
    -var_i``) and the transposed operators (``*_t``).

    A stacked consts (:func:`make_conv_lnl_consts_stack`) holds ``K``
    targets: ``obs``, ``obs_var``, ``good`` and ``good_f`` are ``(K, H,
    W)`` and, with per-target spectra, the spectrum planes (``psf_*``,
    ``var_*``, ``pad_*``) ``(K, ...)`` and ``var_gain`` ``(K,)``.

    The padded, the cluster and the global route's (``pad_*``, empty
    unless :func:`conv_route` answers ``"padded"``, ``"cluster"`` or
    ``"global"``): the PSF and
    PSF-variance kernels' half spectra at the transform's
    :func:`padded_shape` ``(M_h, M_w/2+1)`` (real, imaginary and the
    backward's conjugate imaginary planes; ``_padded_spectrum``; on the
    cluster route at a transform that pads no side, the kernels' own
    spectra), and the twiddle table and layout at ``(M_h, M_w)``: the FFT
    route's (:func:`fft_tables`) on the padded route, the mixed-radix form
    (:func:`cluster_tables`) on the cluster and the global route.  The variance gain is
    the ``N``-point spectra's: the zero-frequency bin is the kernel's sum
    at either size.
    """

    cw: torch.Tensor
    sw: torch.Tensor
    ch: torch.Tensor
    sh: torch.Tensor
    ich: torch.Tensor
    ish: torch.Tensor
    ica: torch.Tensor
    isa: torch.Tensor
    psf_r: torch.Tensor
    psf_i: torch.Tensor
    var_r: torch.Tensor
    var_i: torch.Tensor
    obs: torch.Tensor
    obs_var: torch.Tensor
    good: torch.Tensor  # bool
    lf: torch.Tensor
    li: torch.Tensor
    good_f: torch.Tensor  # good as {0, 1} in the working dtype
    twiddle: torch.Tensor  # (max(H, W) / 2, 2), (H + W, 2) or less, or (0, 2)
    fft_layout: torch.Tensor  # int32: fft_layout(shape), or (0,)
    var_gain: torch.Tensor  # (1,): a power of two, see var_spectrum_gain
    # the backward's: the conjugate spectra's imaginary planes and the
    # transposed operators, each contiguous
    psf_ic: torch.Tensor
    var_ic: torch.Tensor
    ica_t: torch.Tensor
    isa_t: torch.Tensor
    li_t: torch.Tensor
    lf_t: torch.Tensor
    cw_t: torch.Tensor
    sw_t: torch.Tensor
    # the padded route's, (M_h, M_w/2+1) each, or (0, 0)
    pad_psf_r: torch.Tensor
    pad_psf_i: torch.Tensor
    pad_var_r: torch.Tensor
    pad_var_i: torch.Tensor
    pad_psf_ic: torch.Tensor
    pad_var_ic: torch.Tensor
    pad_twiddle: torch.Tensor  # fft_tables(padded_shape)[0], or (0, 2)
    pad_layout: torch.Tensor  # int32: fft_tables(padded_shape)[1], or (0,)

    @property
    def mats(self):
        return (self.cw, self.sw, self.ch, self.sh, self.ich, self.ish,
                self.ica, self.isa)

    @property
    def shape(self):
        return tuple(self.obs.shape[-2:])

    @property
    def targets(self):
        """``K`` for a stacked consts, 0 for one observation."""
        return self.obs.shape[0] if self.obs.dim() == 3 else 0

    @property
    def target_spectra(self):
        """Whether each target has its own PSF spectra."""
        return self.psf_r.dim() == 3

    @property
    def padded_shape(self):
        """The padded route's transform sides (:func:`padded_shape`)."""
        return padded_shape(self.shape)


def _padded_spectrum(f_half, shape, padded):
    """The half spectrum ``(M_h, M_w//2+1)`` of the kernel whose
    ``N``-point half spectrum is ``f_half``, placed at ``[0, N)`` of a
    zero ``(M_h, M_w)`` image (host numpy, float64): ``irfft2`` at
    ``shape``, the pad, ``rfft2``; ``f_half`` itself where nothing is
    padded."""
    if tuple(shape) == tuple(padded):
        return np.asarray(f_half)
    kernel = np.fft.irfft2(np.asarray(f_half, np.complex128), s=tuple(shape))
    out = np.zeros(tuple(padded))
    out[:shape[0], :shape[1]] = kernel
    return np.fft.rfft2(out)


def make_conv_lnl_consts(f_psf, f_var, obs, obs_var, good, device,
                         dtype=torch.float32):
    """Build :class:`ConvLnlConsts` from host numpy arrays.

    ``f_psf``/``f_var`` are complex half spectra ``(H, W//2+1)`` (one
    PSF); ``obs``/``obs_var`` real ``(H, W)``; ``good`` boolean.
    """
    obs = np.asarray(obs)
    shape = obs.shape
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    mats = rdft_matrices(shape, np_dtype)
    cw, sw, ch, sh, ich, ish, ica, isa = mats
    lf = np.block([[ch, sh], [-sh, ch]])
    li = np.block([[ich, -ish], [ish, ich]])
    f_psf = np.asarray(f_psf)
    f_var = np.asarray(f_var)
    good = np.asarray(good, bool)
    route = conv_route(shape)
    empty = np.zeros((0, 2), np_dtype), np.zeros(0, np.int32)
    if all(_power_of_two(n) for n in shape) or route == "fft":
        twiddle, layout = fft_tables(shape, np_dtype)
    else:
        twiddle, layout = empty
    pad = dict.fromkeys(("pad_psf_r", "pad_psf_i", "pad_var_r", "pad_var_i",
                         "pad_psf_ic", "pad_var_ic"), np.zeros((0, 0)))
    pad_twiddle, pad_layout = empty
    if route in _PADDED_SCHEME:
        padded = padded_shape(shape)
        p_psf = _padded_spectrum(f_psf, shape, padded)
        p_var = _padded_spectrum(f_var, shape, padded)
        pad = dict(pad_psf_r=p_psf.real, pad_psf_i=p_psf.imag, pad_var_r=p_var.real,
                   pad_var_i=p_var.imag, pad_psf_ic=-p_psf.imag, pad_var_ic=-p_var.imag)
        tables = fft_tables if route == "padded" else cluster_tables
        pad_twiddle, pad_layout = tables(padded, np_dtype)
    arrays = dict(
        cw=cw, sw=sw, ch=ch, sh=sh, ich=ich, ish=ish, ica=ica, isa=isa,
        psf_r=f_psf.real, psf_i=f_psf.imag,
        var_r=f_var.real, var_i=f_var.imag,
        obs=obs, obs_var=np.asarray(obs_var), lf=lf, li=li,
        good_f=good.astype(np_dtype), twiddle=twiddle,
        var_gain=np.array([var_spectrum_gain(f_psf, f_var)]),
        psf_ic=-f_psf.imag, var_ic=-f_var.imag, ica_t=ica.T, isa_t=isa.T,
        li_t=li.T, lf_t=lf.T, cw_t=cw.T, sw_t=sw.T, pad_twiddle=pad_twiddle, **pad,
    )
    tensors = {
        k: torch.as_tensor(np.ascontiguousarray(v, np_dtype), device=device)
        for k, v in arrays.items()
    }
    tensors["good"] = torch.as_tensor(good, device=device)
    tensors["fft_layout"] = torch.as_tensor(layout, device=device)
    tensors["pad_layout"] = torch.as_tensor(pad_layout, device=device)
    return ConvLnlConsts(**tensors)


# the fields of a stacked consts that are each target's own: the planes,
# and with per-target spectra the spectra and gains
TARGET_FIELDS = ("obs", "obs_var", "good", "good_f")
TARGET_SPECTRA_FIELDS = ("psf_r", "psf_i", "var_r", "var_i", "var_gain", "psf_ic",
                         "var_ic", "pad_psf_r", "pad_psf_i", "pad_var_r", "pad_var_i",
                         "pad_psf_ic", "pad_var_ic")


def make_conv_lnl_consts_stack(f_psf, f_var, obs, obs_var, good, device,
                               dtype=torch.float32):
    """:class:`ConvLnlConsts` of ``K`` targets, from host numpy arrays.

    ``obs``/``obs_var``/``good`` are ``(K, H, W)``; ``f_psf``/``f_var``
    one PSF's half spectra ``(H, W//2+1)``, shared by every target, or
    ``(K, H, W//2+1)``, one per target (survey mode: each target's own
    spectra, padded spectra (:func:`_padded_spectrum`) and variance gain
    (:func:`var_spectrum_gain`)).  The operators and tables are the
    single observation's."""
    obs = np.asarray(obs)
    good = np.asarray(good, bool)
    f_psf, f_var = np.asarray(f_psf), np.asarray(f_var)
    if obs.ndim != 3 or obs.shape != np.shape(obs_var) or obs.shape != good.shape:
        raise ValueError("obs, obs_var and good must be (K, H, W) each")
    per = f_psf.ndim == 3
    if per and (f_psf.shape[0] != obs.shape[0] or f_var.shape != f_psf.shape):
        raise ValueError(f"per-target spectra {f_psf.shape} / {f_var.shape} "
                         f"for {obs.shape[0]} targets")
    base = make_conv_lnl_consts(f_psf[0] if per else f_psf, f_var[0] if per else f_var,
                                obs[0], np.asarray(obs_var)[0], good[0], device, dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a, np_dtype), device=device)

    over = dict(obs=tensor(obs), obs_var=tensor(obs_var),
                good=torch.as_tensor(good, device=device),
                good_f=tensor(good.astype(np_dtype)))
    if per:
        over.update(psf_r=tensor(f_psf.real), psf_i=tensor(f_psf.imag),
                    var_r=tensor(f_var.real), var_i=tensor(f_var.imag),
                    psf_ic=tensor(-f_psf.imag), var_ic=tensor(-f_var.imag),
                    var_gain=tensor([var_spectrum_gain(p, v)
                                     for p, v in zip(f_psf, f_var)]))
        shape = obs.shape[1:]
        if conv_route(shape) in _PADDED_SCHEME:
            padded = padded_shape(shape)
            p_psf = np.stack([_padded_spectrum(p, shape, padded) for p in f_psf])
            p_var = np.stack([_padded_spectrum(v, shape, padded) for v in f_var])
            over.update(pad_psf_r=tensor(p_psf.real), pad_psf_i=tensor(p_psf.imag),
                        pad_var_r=tensor(p_var.real), pad_var_i=tensor(p_var.imag),
                        pad_psf_ic=tensor(-p_psf.imag), pad_var_ic=tensor(-p_var.imag))
    return replace(base, **over)


def copy_target_consts_(dst: ConvLnlConsts, src: ConvLnlConsts):
    """Write ``src``'s per-target fields into ``dst``'s tensors in place
    (a captured graph reads ``dst`` by address); both stacked alike."""
    if (dst.targets, dst.target_spectra, dst.shape) != (src.targets, src.target_spectra,
                                                        src.shape):
        raise ValueError("the two stacked consts differ in targets, spectra or shape")
    names = TARGET_FIELDS + (TARGET_SPECTRA_FIELDS if dst.target_spectra else ())
    for name in names:
        getattr(dst, name).copy_(getattr(src, name))


def _split_targets(raws, c: ConvLnlConsts):
    """``(x, c)``: for a stacked consts, ``raws`` ``(B, H, W)`` as ``(K, B/K,
    H, W)`` and every per-target field with an axis of 1 after the target
    axis (``var_gain`` ``(K, 1, 1, 1)``), so that they broadcast; else
    unchanged."""
    k = c.targets
    if not k:
        return raws, c
    x = raws.reshape(k, raws.shape[0] // k, *raws.shape[1:])
    names = TARGET_FIELDS + (TARGET_SPECTRA_FIELDS if c.target_spectra else ())
    over = {n: getattr(c, n)[:, None] for n in names if getattr(c, n).numel()}
    if c.target_spectra:  # a scalar a target, against (K, B/K, H, W)
        over["var_gain"] = c.var_gain[:, None, None, None]
    return x, replace(c, **over)


def batched_conv_lnl_plain(raws, consts: ConvLnlConsts):
    """Plain PyTorch version: ``convolve_rdft`` twice + ``gaussian_lnlike``
    (a stacked consts: each walker against its target's constants)."""
    x, c = _split_targets(raws, consts)
    conv = convolve_rdft(x, c.psf_r, c.psf_i, c.mats)
    mvar = convolve_rdft(x * x, c.var_r, c.var_i, c.mats)
    ivm = 1.0 / (mvar + c.obs_var)
    return gaussian_lnlike(c.obs - conv, ivm, c.good).reshape(raws.shape[0])


def var_spectrum_gain(f_psf, f_var):
    """The power of two nearest ``|Kpsf(0)| / |Kvar(0)|`` (within
    ``2^±96``; 1 where the ratio is 0 or not finite).

    The FFT route carries both convolutions in one complex image, ``conv
    + i s g mvar``.  A PSF variance map is many orders of magnitude below
    the PSF (sums of 4e-5 and 1 on the flagship), and in float32 the
    smaller part of a complex product or transform is only as exact as
    the larger part's rounding: the variance spectrum is multiplied by
    ``g`` (exact) so that both parts have the same scale, and ``mvar`` is
    divided by it at the readout."""
    ratio = abs(complex(np.asarray(f_psf)[0, 0])) / max(
        abs(complex(np.asarray(f_var)[0, 0])), 1e-300)
    if not np.isfinite(ratio) or ratio <= 0.0:
        return 1.0
    exponent = int(np.clip(np.rint(np.log2(ratio)), -_MAX_SCALE_EXP,
                           _MAX_SCALE_EXP))
    return float(2.0 ** exponent)


def bit_reversed(n):
    """Indices ``0 .. n-1`` with their ``log2 n`` bits reversed."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


_COS = {r: tuple(math.cos(2 * math.pi * k / r) for k in range(1, r // 2 + 1))
        for r in (3, 5, 7)}
_SIN = {r: tuple(math.sin(2 * math.pi * k / r) for k in range(1, r // 2 + 1))
        for r in (3, 5, 7)}


def _rotate_pair(a, b, inverse):
    """``(a - i b, a + i b)``, the inverse's ``(a + i b, a - i b)``."""
    ib = 1j * b
    return (a + ib, a - ib) if inverse else (a - ib, a + ib)


def _small_dft(x, inverse):
    """The ``r``-point DFT of the list ``x`` (``r`` = 2, 3, 5 or 7),
    unnormalised, in ``csrc/fft_conv.cuh``'s (``small_dft``) order of
    operations."""
    r = len(x)
    if r == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if r == 3:
        t = x[1] + x[2]
        m = x[0] - 0.5 * t
        y1, y2 = _rotate_pair(m, _SIN[3][0] * (x[1] - x[2]), inverse)
        return [x[0] + t, y1, y2]
    if r == 5:
        (c1, c2), (s1, s2) = _COS[5], _SIN[5]
        a1, b1 = x[1] + x[4], x[1] - x[4]
        a2, b2 = x[2] + x[3], x[2] - x[3]
        y1, y4 = _rotate_pair(x[0] + (c1 * a1 + c2 * a2), s1 * b1 + s2 * b2, inverse)
        y2, y3 = _rotate_pair(x[0] + (c2 * a1 + c1 * a2), s2 * b1 - s1 * b2, inverse)
        return [x[0] + (a1 + a2), y1, y2, y3, y4]
    # radix 7: the pairs k, 7 - k; output p reads cos and sin of 2 pi p k / 7
    (c1, c2, c3), (s1, s2, s3) = _COS[7], _SIN[7]
    a1, b1 = x[1] + x[6], x[1] - x[6]
    a2, b2 = x[2] + x[5], x[2] - x[5]
    a3, b3 = x[3] + x[4], x[3] - x[4]
    y1, y6 = _rotate_pair(x[0] + (c1 * a1 + c2 * a2 + c3 * a3),
                          s1 * b1 + s2 * b2 + s3 * b3, inverse)
    y2, y5 = _rotate_pair(x[0] + (c2 * a1 + c3 * a2 + c1 * a3),
                          s2 * b1 - s3 * b2 - s1 * b3, inverse)
    y3, y4 = _rotate_pair(x[0] + (c3 * a1 + c1 * a2 + c2 * a3),
                          s3 * b1 - s1 * b2 + s2 * b3, inverse)
    return [x[0] + (a1 + a2 + a3), y1, y2, y3, y4, y5, y6]


def _stages_1d(z, tw, inverse):
    """The stages of the last axis (length ``n``, :func:`fft_plan`'s
    radices), from the table ``tw`` (period ``2 len(tw)`` when ``n`` is
    a power of two, else ``len(tw)``).  Forward: decimation in frequency,
    natural order in, digit-reversed out; a stage of radix ``r`` on
    sub-blocks of length ``L`` takes the elements ``L / r`` apart, their
    DFT, then output ``p`` times ``exp(-2 pi i p j / L)`` (``j`` the
    offset within ``L / r``); for radix 2, ``(a + b, (a - b) w)``.
    Inverse: the stages undone in reverse order, input ``p`` times the
    conjugate twiddle then the inverse DFT (``(a + b conj w, a - b conj
    w)``), digit-reversed in, natural out, unnormalised."""
    n = z.shape[-1]
    period = 2 * tw.shape[0] if _power_of_two(n) else tw.shape[0]
    lead = z.shape[:-1]
    stages, length = [], n
    for r in _stage_radices(n):
        stages.append((r, length))
        length //= r
    for r, length in (reversed(stages) if inverse else stages):
        m = length // r
        x = z.reshape(*lead, n // length, r, m)
        x = [x[..., q, :] for q in range(r)]
        j = torch.arange(m, device=z.device)
        w = [tw[(p * j) * (period // length)] for p in range(r)]
        if inverse:
            x = _small_dft([x[0]] + [x[p] * w[p].conj() for p in range(1, r)],
                           True)
        else:
            x = _small_dft(x, False)
            x = [x[0]] + [x[p] * w[p] for p in range(1, r)]
        z = torch.stack(x, dim=-2).reshape(*lead, n)
    return z


def _axis_tables(tw, h, w):
    """The rows' and the columns' tables in a route's twiddle array."""
    if _power_of_two(h) and _power_of_two(w):
        return tw, tw
    nh = _twiddle_entries(h)
    return tw[:nh], tw[nh:nh + _twiddle_entries(w)]


def fft_stages_plain(z, twiddles, inverse=False):
    """The FFT route's butterfly schedule on a complex ``(..., H, W)``
    tensor, stage by stage, from the twiddles the kernel reads
    (:func:`fft_tables` of the shape: one table of ``max(H, W)`` when
    both sides are powers of two, else ``H``'s then ``W``'s).

    Forward: rows then columns, decimation in frequency; the result holds
    bin ``(ky, kx)`` at ``(digit_reversed(H)[ky], digit_reversed(W)[kx])``
    (for powers of two, the bit reversal).  ``inverse=True`` takes that
    layout back: columns then rows, decimation in time, unnormalised
    (``H W`` times ``ifft2``).  The kernel runs the stages of one
    :func:`fft_plan` pass per trip through shared memory on values held
    in registers; the arithmetic is the same.
    """
    tw = torch.complex(twiddles[:, 0], twiddles[:, 1])
    tw_h, tw_w = _axis_tables(tw, *z.shape[-2:])
    if inverse:
        z = _stages_1d(z.transpose(-1, -2), tw_h, True).transpose(-1, -2)
        return _stages_1d(z, tw_w, True)
    z = _stages_1d(z, tw_w, False)
    return _stages_1d(z.transpose(-1, -2), tw_h, False).transpose(-1, -2)


def _mirrored(z):
    """``z[(-ky) mod H, (-kx) mod W]`` over the trailing axes."""
    return torch.roll(torch.flip(z, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))


def _full_spectrum(k_r, k_i, w):
    """The ``(H, W)`` spectrum of a real kernel from its half spectrum
    ``(H, W//2+1)``: ``K(-k) = conj K(k)`` fills the columns above
    ``W/2``."""
    half = torch.complex(k_r, k_i)
    rows_mirrored = torch.roll(torch.flip(half, dims=(-2,)), 1, dims=-2)
    rest = rows_mirrored.conj()[..., 1:w - w // 2].flip(-1)
    return torch.cat([half, rest], dim=-1)


def _fold(y, shape):
    """The padded route's readout of a ``(..., M_h, M_w)`` linear
    convolution: along each padded axis of image side ``N``, slot ``s``
    sums ``z[s] + z[s + N]`` for ``s <= N - 2`` and keeps ``z[N - 1]``
    (the ``N``-point circular convolution), ``W`` first and then ``H``,
    so that four terms sum as ``(z00 + z01) + (z10 + z11)``, the kernel's
    order; then the ifftshift as a shifted readout (output pixel ``n``
    reads slot ``(n + N//2) mod N``).  An axis that is not padded is only
    shifted."""
    h, w = shape
    for axis, n in ((-1, w), (-2, h)):
        if y.shape[axis] != n:
            head = y.narrow(axis, 0, n)
            tail = torch.cat([y.narrow(axis, n, n - 1),
                              torch.zeros_like(head.narrow(axis, 0, 1))], dim=axis)
            y = head + tail
    return torch.roll(y, shifts=(-(h // 2), -(w // 2)), dims=(-2, -1))


def _unfold(x, shape, padded):
    """The adjoint of :func:`_fold`: the shift undone, then along each
    padded axis each slot ``s`` also at ``s + N`` where ``s <= N - 2``, and
    zeros up to ``M``."""
    h, w = shape
    z = torch.roll(x, shifts=(h // 2, w // 2), dims=(-2, -1))
    for axis, n, m in ((-2, h, padded[0]), (-1, w, padded[1])):
        if m != n:
            zeros = list(z.shape)
            zeros[axis] = m - (2 * n - 1)
            z = torch.cat([z, z.narrow(axis, 0, n - 1), z.new_zeros(zeros)], dim=axis)
    return z


def _pad(x, padded):
    """``(..., N_h, N_w)`` into the corner of zeros ``(..., M_h, M_w)``."""
    h, w = x.shape[-2:]
    return torch.nn.functional.pad(x, (0, padded[1] - w, 0, padded[0] - h))


def _crop(y, shape):
    """The adjoint of :func:`_pad`: ``[0, N_h) x [0, N_w)``."""
    return y[..., :shape[0], :shape[1]]


def _square_scale(images):
    """``(s, 1 / s)`` per image: the power of two ``2^-e`` of the squared
    image's scale, ``e = floor(log2 max|image|)`` within ``+-96`` (0 where
    the max is 0 or not finite), shaped to broadcast over ``(H, W)``."""
    exponent, _ = _peak_exponent(images)
    exponent = exponent.clamp(-_MAX_SCALE_EXP, _MAX_SCALE_EXP)
    one = torch.ones_like(images[..., 0, 0])
    return (torch.ldexp(one, -exponent)[..., None, None],
            torch.ldexp(one, exponent)[..., None, None])


def _packed_pair(raws, c, spectra, padded):
    """``(conv, mvar)`` by the packed pair at the transform's ``padded``
    sides (the image's own on the FFT route) with the half spectra
    ``spectra = (psf_r, psf_i, var_r, var_i)`` at those sides."""
    psf_r, psf_i, var_r, var_i = spectra
    s, inv_s = _square_scale(raws)
    x = _pad(raws, padded)
    z = torch.fft.fft2(torch.complex(x, (x * x) * s))
    zm = _mirrored(z).conj()
    a = 0.5 * (z + zm)
    b = -0.5j * (z - zm)
    y = a * _full_spectrum(psf_r, psf_i, padded[1]) \
        + 1j * b * (_full_spectrum(var_r, var_i, padded[1]) * c.var_gain)
    y = _fold(torch.fft.ifft2(y), c.shape)
    return y.real, y.imag * (inv_s / c.var_gain)


def packed_fft_conv_plain(raws, consts: ConvLnlConsts):
    """``(conv, mvar)`` of ``(B, H, W)`` raw images by the FFT route's
    scheme, in plain PyTorch.

    Pack ``z = raw + i s raw^2`` with the per-walker power-of-two scale
    ``s = 2^-floor(log2 max|raw|)`` (``1`` where the max is 0 or not
    finite; NaNs do not count towards the max); one complex ``fft2``;
    the Hermitian split with the mirrored index, ``A = (Z + conj Z~) /
    2`` and ``B = (Z - conj Z~) / 2i``; ``Y = A Kpsf + i B (g Kvar)``
    with the kernels' spectra completed from their half spectra and the
    gain ``g`` of :func:`var_spectrum_gain`; one ``ifft2``; the ifftshift
    as a shifted readout; ``mvar`` unscaled by ``1 / (s g)``.
    ``raw * raw`` is formed before the scale is applied.  A stacked
    consts takes each walker's target's constants.
    """
    x, c = _split_targets(raws, consts)
    conv, mvar = _packed_pair(x, c, (c.psf_r, c.psf_i, c.var_r, c.var_i), c.shape)
    return conv.reshape(raws.shape), mvar.reshape(raws.shape)


def padded_fft_conv_plain(raws, consts: ConvLnlConsts):
    """``(conv, mvar)`` of ``(B, H, W)`` raw images by the padded route's
    scheme, in plain PyTorch: :func:`packed_fft_conv_plain`'s pack and
    pair on the image zero-padded to :func:`padded_shape` ``(M_h, M_w)``
    with the padded kernels' spectra (``consts.pad_*``), which gives the
    linear convolution; the readout folds it back to the ``N``-point
    circular one (``y[s] = z[s] + z[s + N]`` along each padded axis) and
    shifts.  The inverse's normalisation is ``1 / (M_h M_w)``.  A stacked
    consts takes each walker's target's constants."""
    x, c = _split_targets(raws, consts)
    conv, mvar = _packed_pair(x, c, (c.pad_psf_r, c.pad_psf_i, c.pad_var_r,
                                     c.pad_var_i), c.padded_shape)
    return conv.reshape(raws.shape), mvar.reshape(raws.shape)


# conv_lnl_launch(raws, batch, h, w, per_target, data_stride, <these
# constants>, t1, t2, conv, mvar, out, stream)
_DFT_CONST_ARGS = ("cw", "sw", "lf", "li", "ica", "isa", "psf_r", "psf_i",
                   "var_r", "var_i", "obs", "obs_var", "good_f")
# conv_lnl_fft_launch(raws, batch, h, w, per_target, data_stride,
# spectra_stride, <these constants>, out, stream); fused_lnl_fft_launch
# takes them too
CONV_FFT_CONST_ARGS = ("twiddle", "fft_layout", "var_gain", "psf_r", "psf_i", "var_r",
                       "var_i", "obs", "obs_var", "good_f")
# conv_lnl_padded_launch(raws, batch, h, w, mh, mw, per_target, data_stride,
# spectra_stride, <these constants>, out, stream): the FFT route's
# constants at the transform's sides
PADDED_CONST_ARGS = ("pad_twiddle", "pad_layout", "var_gain", "pad_psf_r",
                     "pad_psf_i", "pad_var_r", "pad_var_i", "obs", "obs_var",
                     "good_f")
# the routes of the packed FFT pair, a walker's transform in one block's or
# one cluster's shared memory or in the global route's scratch: the C
# symbols of the forward and of its residual instantiation, and the
# constants they take (the residual instantiation's outputs are out,
# weights, scale_exp); conv_lnl_cluster_launch(raws, batch, h, w, mh, mw,
# ranks, per_target, data_stride, spectra_stride, <the padded route's
# constants>, out, stream); conv_lnl_global_launch(raws, batch, h, w, mh, mw,
# rows, cols, per_target, data_stride, spectra_stride, <the padded route's
# constants>, <its scratch, _global_scratch>, out, stream)
_FFT_ROUTES = {
    "fft": (("conv_lnl_fft_launch", "conv_lnl_fft_residuals_launch"),
            CONV_FFT_CONST_ARGS),
    "padded": (("conv_lnl_padded_launch", "conv_lnl_padded_residuals_launch"),
               PADDED_CONST_ARGS),
    "cluster": (("conv_lnl_cluster_launch", "conv_lnl_cluster_residuals_launch"),
                PADDED_CONST_ARGS),
    "global": (("conv_lnl_global_launch", "conv_lnl_global_residuals_launch"),
               PADDED_CONST_ARGS),
}


def _sides(route, shape):
    """The int arguments after the batch: ``h, w``; on the padded route
    the transform's ``mh, mw`` too, on the cluster route also its size, on
    the global route its tiles (:func:`global_tiles`)."""
    if route == "padded":
        return tuple(shape) + padded_shape(shape)
    if route == "cluster":
        return tuple(shape) + padded_shape(shape) + (cluster_size(shape),)
    if route == "global":
        return tuple(shape) + padded_shape(shape) + global_tiles(shape)
    return tuple(shape)


def _transform_rows(b, shape, device):
    """The global route's scratch S: the transform's rows in natural order,
    ``(B, H, M_w, 2)`` float32, from PyTorch's allocator (a captured step
    draws on its graph's pool)."""
    return torch.empty((b, int(shape[0]), padded_shape(shape)[1], 2), dtype=torch.float32,
                       device=device)


def _global_scratch(b, shape, device, residuals=False):
    """The global route's forward scratch for ``b`` walkers at the image
    ``shape``: S (:func:`_transform_rows`), the row tiles' peaks ``(B, T)``
    float32 and lnL partial sums ``(B, T)`` float64, and with
    ``residuals`` the tiles' weight peaks ``(B, T, 2)`` float32 (``T =
    ceil(H / rows)``)."""
    tiles = -(-int(shape[0]) // global_tiles(shape)[0])
    out = [_transform_rows(b, shape, device),
           torch.empty((b, tiles), dtype=torch.float32, device=device),
           torch.empty((b, tiles), dtype=torch.float64, device=device)]
    if residuals:
        out.append(torch.empty((b, tiles, 2), dtype=torch.float32, device=device))
    return out


def _launch_error(what, route, shape, err):
    """The message of a failed launch on ``route`` at the image ``shape``:
    the cudaError (-1 on the cluster route: the card cannot schedule the
    cluster) and the shared memory a block asked for."""
    if route in ("fft", "padded"):
        transform = shape if route == "fft" else padded_shape(shape)
        return (f"{what} ({route} route) launch failed: cudaError {err} ({shape[0]}x"
                f"{shape[1]} walker, {fft_smem_bytes(transform)} bytes of shared memory)")
    if route == "cluster":
        ranks, transform = cluster_size(shape), padded_shape(shape)
        why = ("no cluster of that size can be scheduled on this card" if err == -1
               else f"cudaError {err}")
        return (f"{what} (cluster route) launch failed: {why} ({shape[0]}x{shape[1]} "
                f"walker, a {transform[0]}x{transform[1]} transform over a cluster of "
                f"{ranks} blocks of {cluster_smem_bytes(transform, ranks)} bytes of "
                "shared memory each)")
    if route == "global":
        (rows, cols), transform = global_tiles(shape), padded_shape(shape)
        return (f"{what} (global route) launch failed: cudaError {err} ({shape[0]}x"
                f"{shape[1]} walker, a {transform[0]}x{transform[1]} transform in tiles "
                f"of {rows} rows ({global_row_smem(transform, rows)} bytes of shared "
                f"memory) and groups of {cols} columns "
                f"({global_column_smem(transform, cols)} bytes))")
    return f"{what} ({route} route) launch failed: cudaError {err}"


def _target_ints(batch, consts: ConvLnlConsts, route):
    """The forward's ints after the sides: walkers per target and the
    floats between two targets' planes, then (FFT and padded routes) their
    spectra's; ``(1, 0, 0)`` for one observation and PSF."""
    k = consts.targets
    per, data, spectra = (batch // k, consts.obs[0].numel(), 0) if k else (1, 0, 0)
    if k and consts.target_spectra:
        spectra = (consts.pad_psf_r if route in _PADDED_SCHEME
                   else consts.psf_r)[0].numel()
    return (per, data) if route == "dft" else (per, data, spectra)


@functools.lru_cache(maxsize=1)
def _dft_kernel():
    return _build.function(
        "conv_lnl", "conv_lnl_launch",
        [ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * (len(_DFT_CONST_ARGS) + 6),
    )


# the int arguments after the batch: the sides (and the cluster's size, or
# the global route's tiles)
_SIDE_INTS = {"fft": 2, "padded": 4, "cluster": 5, "global": 6}


@functools.lru_cache(maxsize=None)
def _block_kernel(route, residuals):
    (symbols, names) = _FFT_ROUTES[route]
    ints = 1 + _SIDE_INTS[route] + 3
    scratch = (4 if residuals else 3) if route == "global" else 0
    return _build.function(
        "conv_lnl", symbols[residuals],
        [ctypes.c_void_p] + [ctypes.c_int] * ints
        + [ctypes.c_void_p] * (len(names) + scratch + (4 if residuals else 2)),
    )


def check_launch_consts(consts: ConvLnlConsts, device):
    """Raise unless every constant is a contiguous float32 tensor on
    ``device`` (the mask ``good`` only needs the device, the layouts are
    contiguous int32), as the CUDA kernels take them."""
    for f in fields(consts):
        t = getattr(consts, f.name)
        if t.device != device:
            raise ValueError(f"consts.{f.name} is on {t.device}, inputs on {device}")
        want = torch.int32 if f.name in ("fft_layout", "pad_layout") else torch.float32
        if f.name != "good" and (t.dtype != want or not t.is_contiguous()):
            raise ValueError(f"consts.{f.name} must be contiguous {want}")


def _launch_dft(raws, consts: ConvLnlConsts):
    """The matmul-DFT route: 15 launches through global scratch."""
    b, h, w = raws.shape
    w2 = w // 2 + 1
    dev = raws.device
    t1 = torch.empty((b, 2, h, w2), dtype=torch.float32, device=dev)
    t2 = torch.empty_like(t1)
    conv = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    mvar = torch.empty_like(conv)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    tensors = [getattr(consts, n) for n in _DFT_CONST_ARGS] + [t1, t2, conv, mvar, out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _dft_kernel()(raws.data_ptr(), b, h, w, *_target_ints(b, consts, "dft"),
                            *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(f"conv_lnl launch failed: cudaError {err}")
    return out


def _launch_block(raws, consts: ConvLnlConsts, route, residuals=False):
    """The FFT, the padded, the cluster or the global route: one call, no
    allocation but the outputs and, on the global route, its scratch (on
    the FFT and padded routes radix-2 stages for powers of two, mixed radix
    otherwise: the launch picks).  With ``residuals`` the residual
    instantiation, which also returns the weights and the scale
    exponents."""
    b, h, w = raws.shape
    dev = raws.device
    outs = [torch.empty((b,), dtype=torch.float32, device=dev)]
    if residuals:
        outs += [torch.empty((b, h, w, 2), dtype=torch.float32, device=dev),
                 torch.empty((b,), dtype=torch.int32, device=dev)]
    scratch = _global_scratch(b, (h, w), dev, residuals) if route == "global" else []
    tensors = [getattr(consts, n) for n in _FFT_ROUTES[route][1]] + scratch + outs
    sides = _sides(route, (h, w))
    ints = sides + _target_ints(b, consts, route)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _block_kernel(route, residuals)(raws.data_ptr(), b, *ints,
                                              *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(_launch_error(
            "conv_lnl" + (" with residuals" if residuals else ""), route, (h, w), err))
    return tuple(outs) if residuals else outs[0]


def _launch(raws, consts: ConvLnlConsts, route):
    if raws.dtype != torch.float32:
        raise TypeError(f"the CUDA conv_lnl takes float32, got {raws.dtype}")
    check_launch_consts(consts, raws.device)
    raws = raws.contiguous()
    if route in _FFT_ROUTES:
        return _launch_block(raws, consts, route)
    return _launch_dft(raws, consts)


def batched_conv_lnl(raws, consts: ConvLnlConsts):
    """``(B, H, W)`` raw images -> ``(B,)`` Gaussian lnL (see module doc).

    With a stacked consts of ``K`` targets, ``B`` is a multiple of ``K``
    and walker ``b`` fits target ``b // (B / K)``; launches count on the
    route's ``"<route>_targets"`` key (``"fft_targets"``,
    ``"padded_targets"``, ``"cluster_targets"``, ``"global_targets"``,
    ``"dft_targets"``; under autograd off the matmul-DFT route
    ``"fft_res_targets"``, ``"padded_res_targets"``,
    ``"cluster_res_targets"``, ``"global_res_targets"``, and its backward
    on ``batched_conv_lnl_backward``'s ``"<route>_targets"``).
    Per-target spectra on the matmul-DFT route
    (:func:`target_spectra_supported`) raise ``ValueError``."""
    _check_inputs(raws, consts)
    if torch.is_grad_enabled() and raws.requires_grad:
        return _ConvLnl.apply(raws, consts)
    return _forward(raws, consts)


def _check_inputs(raws, consts: ConvLnlConsts):
    """Raise ``ValueError`` unless ``raws`` is ``(B, H, W)`` at the consts'
    shape and, for a stacked consts, ``B`` splits evenly over its targets
    and per-target spectra are on a route that reads them."""
    if raws.ndim != 3 or tuple(raws.shape[1:]) != consts.shape:
        raise ValueError(
            f"raws must be (B, {consts.shape[0]}, {consts.shape[1]}), "
            f"got {tuple(raws.shape)}"
        )
    if consts.targets:
        if raws.shape[0] % consts.targets:
            raise ValueError(f"{raws.shape[0]} walkers do not split evenly over "
                             f"{consts.targets} targets")
        if consts.target_spectra and not target_spectra_supported(consts.shape):
            raise ValueError(
                f"per-target PSF spectra at {consts.shape} take the matmul-DFT "
                "route, whose spectra are shared GEMM operands: such a batch "
                "takes the posterior's general path")


def _counted(route, consts: ConvLnlConsts):
    """The route key a launch counts on: ``route``, with ``"_targets"`` for
    a stacked consts."""
    return route + "_targets" if consts.targets else route


def _forward(raws, consts):
    if raws.device.type == "cpu":
        return batched_conv_lnl_plain(raws, consts)
    if raws.device.type != "cuda":
        raise ValueError(f"unsupported device {raws.device}")
    route = conv_route(consts.shape)
    out = _launch(raws, consts, route)
    counts.count(batched_conv_lnl, _counted(route, consts), consts.shape)
    return out


batched_conv_lnl.launches = 0
batched_conv_lnl.route_launches = {"fft": 0, "dft": 0, "fft_res": 0, "padded": 0,
                                   "padded_res": 0, "cluster": 0, "cluster_res": 0,
                                   "global": 0, "global_res": 0,
                                   "fft_targets": 0, "padded_targets": 0,
                                   "cluster_targets": 0, "global_targets": 0,
                                   "dft_targets": 0, "fft_res_targets": 0,
                                   "padded_res_targets": 0, "cluster_res_targets": 0,
                                   "global_res_targets": 0}
batched_conv_lnl.shape_launches = {}


def batched_conv_lnl_residuals(raws, consts: ConvLnlConsts):
    """``(lnl (B,), weights (B, H, W, 2), scale_exp (B,) int32)``: the lnL
    of :func:`batched_conv_lnl` with what its backward reads on the FFT,
    the padded, the cluster and the global route, the weights ``(a, c)`` of
    every pixel (``a = good r ivm``, ``c = good ((r ivm)^2 - ivm) / 2``) and
    each walker's scale exponent (:func:`packed_fft_conv_residuals_plain`).
    On CUDA the route's residual instantiation of the forward kernel (the
    same lnL bits as :func:`batched_conv_lnl`'s launch; counted in
    ``batched_conv_lnl.launches`` on the route ``"fft_res"``,
    ``"padded_res"``, ``"cluster_res"`` or ``"global_res"``, with
    ``"_targets"`` for a stacked consts, and by shape), on the CPU
    :func:`packed_fft_conv_residuals_plain` or (the padded, the cluster and
    the global route) :func:`padded_fft_conv_residuals_plain`.  A shape on
    the matmul-DFT route raises ``ValueError``."""
    _check_inputs(raws, consts)
    route = conv_route(consts.shape)
    if route not in _FFT_ROUTES:
        raise ValueError(f"{consts.shape} is on the matmul-DFT route: its backward "
                         "recomputes the forward and reads no residuals")
    if raws.device.type == "cpu":
        plain = (packed_fft_conv_residuals_plain if route == "fft"
                 else padded_fft_conv_residuals_plain)
        return plain(raws, consts)
    if raws.device.type != "cuda":
        raise ValueError(f"unsupported device {raws.device}")
    if raws.dtype != torch.float32:
        raise TypeError(f"the CUDA conv_lnl takes float32, got {raws.dtype}")
    check_launch_consts(consts, raws.device)
    out = _launch_block(raws.contiguous(), consts, route, residuals=True)
    counts.count(batched_conv_lnl, _counted(route + "_res", consts), consts.shape)
    return out


class _ConvLnl(torch.autograd.Function):
    """conv_lnl with its vector-Jacobian product: the forward is the
    wrapper's own launch (on CUDA off the matmul-DFT route, the residual
    instantiation, whose weights and scale exponents it keeps for the
    backward), the backward :func:`batched_conv_lnl_backward`."""

    @staticmethod
    def forward(ctx, raws, consts):
        ctx.consts = consts
        if raws.device.type == "cuda" and conv_route(consts.shape) in _FFT_ROUTES:
            lnl, weights, scale_exp = batched_conv_lnl_residuals(raws, consts)
            ctx.save_for_backward(raws, lnl, weights, scale_exp)
        else:
            lnl = _forward(raws, consts)
            ctx.save_for_backward(raws, lnl)
        return lnl

    @staticmethod
    def backward(ctx, grad):
        raws, lnl, *residuals = ctx.saved_tensors
        return batched_conv_lnl_backward(raws, ctx.consts, lnl, grad,
                                         residuals or None), None


def convolve_rdft_adjoint(img, kernel_r, kernel_i, mats):
    """The adjoint of :func:`~psfmc_tpu_torch.ops.fourier.convolve_rdft`:
    its twelve products transposed and taken in reverse order, with the
    conjugate spectrum (a circular correlation whose shift undoes the
    forward's ifftshift)."""
    cw, sw, ch, sh, ich, ish, ica, isa = mats
    s4r = img @ ica.T
    s4i = -(img @ isa.T)
    s3r = ich.T @ s4r + ish.T @ s4i
    s3i = ich.T @ s4i - ish.T @ s4r
    s2r = s3r * kernel_r + s3i * kernel_i
    s2i = s3i * kernel_r - s3r * kernel_i
    s1r = ch.T @ s2r - sh.T @ s2i
    s1i = sh.T @ s2r + ch.T @ s2i
    return s1r @ cw.T - s1i @ sw.T


def _adjoint_weights(conv, mvar, consts: ConvLnlConsts):
    """``(a, c)``: dlnL/dconv and dlnL/dmvar per pixel, 0 at bad pixels."""
    c = consts
    ivm = 1.0 / (mvar + c.obs_var)
    resid = c.obs - conv
    zero = torch.zeros_like(resid)
    a = torch.where(c.good, resid * ivm, zero)
    cc = torch.where(c.good, 0.5 * (resid * resid * ivm * ivm - ivm), zero)
    return a, cc


def _combine(raws, ga, gc, lnl, grad):
    out = grad[..., None, None] * (ga + 2.0 * raws * gc)
    return torch.where(torch.isfinite(lnl)[..., None, None], out, torch.zeros_like(out))


def batched_conv_lnl_backward_plain(raws, consts: ConvLnlConsts, lnl, grad):
    """Plain PyTorch version of the backward (the version of record):
    ``grad_b [a (x) psf + 2 raw (c (x) var)]``, 0 for a walker whose
    ``lnl`` is not finite (see the module doc).  A stacked consts takes
    each walker's target's constants."""
    x, c = _split_targets(raws, consts)
    lnl, grad = lnl.reshape(x.shape[:-2]), grad.reshape(x.shape[:-2])
    conv = convolve_rdft(x, c.psf_r, c.psf_i, c.mats)
    mvar = convolve_rdft(x * x, c.var_r, c.var_i, c.mats)
    a, cc = _adjoint_weights(conv, mvar, c)
    ga = convolve_rdft_adjoint(a, c.psf_r, c.psf_i, c.mats)
    gc = convolve_rdft_adjoint(cc, c.var_r, c.var_i, c.mats)
    return _combine(x, ga, gc, lnl, grad).reshape(raws.shape)


def _peak_exponent(images):
    """``(floor(log2 max|image|), usable)`` per image of ``(..., H, W)``:
    NaNs do not count towards the max, and where the max is 0 or not
    finite the exponent is 0 and ``usable`` False."""
    peak = torch.nan_to_num(images.abs(), nan=0.0, posinf=float("inf"))
    peak = peak.amax(dim=(-2, -1))
    usable = torch.isfinite(peak) & (peak > 0)
    exponent = torch.frexp(torch.where(usable, peak, torch.ones_like(peak)))[1] - 1
    return exponent, usable


def _residuals(conv, mvar, c, b):
    """``(lnl, weights, scale_exp)`` of :func:`packed_fft_conv_residuals_plain`
    from ``(conv, mvar)`` (split by target as :func:`_split_targets` splits
    them for the ``c`` it returned), each with the walker axis ``b`` again."""
    ivm = 1.0 / (mvar + c.obs_var)
    lnl = gaussian_lnlike(c.obs - conv, ivm, c.good)
    ri = (c.obs - conv) * ivm
    zero = torch.zeros_like(ri)
    a = torch.where(c.good, ri, zero)
    cc = torch.where(c.good, 0.5 * (ri * ri - ivm), zero)
    ea, oka = _peak_exponent(a)
    ec, okc = _peak_exponent(cc)
    exponent = torch.where(oka & okc, ea - ec, torch.zeros_like(ea))
    exponent = exponent.clamp(-_MAX_SCALE_EXP, _MAX_SCALE_EXP).to(torch.int32)
    weights = torch.stack([a, cc], dim=-1)
    return (lnl.reshape(b), weights.reshape(b, *weights.shape[-3:]),
            exponent.reshape(b))


def packed_fft_conv_residuals_plain(raws, consts: ConvLnlConsts):
    """The FFT route's forward with residuals in plain PyTorch: ``(lnl,
    weights, scale_exp)`` of :func:`batched_conv_lnl_residuals`.

    ``(conv, mvar)`` by :func:`packed_fft_conv_plain`, the lnL of them,
    ``a = good r ivm`` and ``c = good ((r ivm)^2 - ivm) / 2`` per pixel (the
    kernel's order of operations) as ``weights[..., 0]`` and
    ``weights[..., 1]``, and the exponent ``e_a - e_c`` of the two parts' peaks (``e``
    the exponent of each part's peak; 0 where either peak is 0 or not
    finite; within ``+-96``): the power of two that gives the backward's
    packed image ``a + i 2^(e_a - e_c) c`` one scale.  A stacked consts
    takes each walker's target's constants.
    """
    x, c = _split_targets(raws, consts)
    conv, mvar = _packed_pair(x, c, (c.psf_r, c.psf_i, c.var_r, c.var_i), c.shape)
    return _residuals(conv, mvar, c, raws.shape[0])


def padded_fft_conv_residuals_plain(raws, consts: ConvLnlConsts):
    """The padded route's forward with residuals in plain PyTorch: as
    :func:`packed_fft_conv_residuals_plain`, from
    :func:`padded_fft_conv_plain`'s ``(conv, mvar)``."""
    x, c = _split_targets(raws, consts)
    conv, mvar = _packed_pair(x, c, (c.pad_psf_r, c.pad_psf_i, c.pad_var_r,
                                     c.pad_var_i), c.padded_shape)
    return _residuals(conv, mvar, c, raws.shape[0])


def _backward_pair(raws, consts, lnl, grad, weights, scale_exp, padded_route):
    """The backward from residuals (a stacked consts split by target) at
    the transform's sides, with the half spectra there (``consts.pad_*`` on
    the padded route): the weights packed, unfolded (:func:`_unfold`; on
    the FFT route only the shift undone), the pair with the conjugate
    spectra, the crop, the combine."""
    x, c = _split_targets(raws, consts)
    lead = x.shape[:-2]
    lnl, grad, scale_exp = (t.reshape(lead) for t in (lnl, grad, scale_exp))
    weights = weights.reshape(*lead, *weights.shape[-3:])
    if padded_route:
        padded = c.padded_shape
        psf_r, psf_i, var_r, var_i = c.pad_psf_r, c.pad_psf_i, c.pad_var_r, c.pad_var_i
    else:
        padded = c.shape
        psf_r, psf_i, var_r, var_i = c.psf_r, c.psf_i, c.var_r, c.var_i
    exponent = scale_exp.to(torch.int64)
    one = torch.ones_like(lnl)
    s = torch.ldexp(one, exponent)[..., None, None]
    inv_s = torch.ldexp(one, -exponent)[..., None, None]
    z = _unfold(torch.complex(weights[..., 0], weights[..., 1] * s), c.shape, padded)
    z = torch.fft.fft2(z)
    zm = _mirrored(z).conj()
    za = 0.5 * (z + zm)
    zb = -0.5j * (z - zm)
    y = za * _full_spectrum(psf_r, psf_i, padded[1]).conj() \
        + 1j * zb * (_full_spectrum(var_r, var_i, padded[1]).conj() * c.var_gain)
    y = _crop(torch.fft.ifft2(y), c.shape)
    out = _combine(x, y.real, y.imag * (inv_s / c.var_gain), lnl, grad)
    return out.reshape(raws.shape)


def packed_fft_conv_backward_from_residuals_plain(raws, consts: ConvLnlConsts,
                                                  lnl, grad, weights, scale_exp):
    """The FFT route's backward from the forward's residuals in plain
    PyTorch (``csrc/conv_lnl_backward.cu``'s scheme).

    Pack ``z = a + i s c`` with ``s = 2^scale_exp`` at the shifted
    positions (the forward's readout shift undone); one ``fft2``; the
    Hermitian split; ``Y = A conj Kpsf + i B (g conj Kvar)``; one
    ``ifft2``; ``a (x) psf`` is the real part and ``c (x) var`` the
    imaginary part over ``s g``; then ``grad_b [a (x) psf + 2 raw (c (x)
    var)]``, 0 for a walker whose ``lnl`` is not finite.  A stacked consts
    takes each walker's target's spectra and variance gain.
    """
    return _backward_pair(raws, consts, lnl, grad, weights, scale_exp, False)


def padded_fft_conv_backward_from_residuals_plain(raws, consts: ConvLnlConsts,
                                                  lnl, grad, weights, scale_exp):
    """The padded route's backward from the forward's residuals in plain
    PyTorch: as :func:`packed_fft_conv_backward_from_residuals_plain`,
    with each packed weight also at the slot ``s + N`` that the forward's
    fold read (the adjoint of the fold) and zeros up to ``M``, the pair at
    :func:`padded_shape` with the padded kernels' conjugate spectra, and
    the ``[0, N)`` crop (the adjoint of the zero pad)."""
    return _backward_pair(raws, consts, lnl, grad, weights, scale_exp, True)


def packed_fft_conv_backward_plain(raws, consts: ConvLnlConsts, lnl, grad):
    """The FFT route's forward with residuals and its backward in turn, in
    plain PyTorch: :func:`packed_fft_conv_residuals_plain`, then
    :func:`packed_fft_conv_backward_from_residuals_plain` (the forward's
    ``lnl`` is the caller's, as the backward kernel reads it)."""
    _, weights, scale_exp = packed_fft_conv_residuals_plain(raws, consts)
    return packed_fft_conv_backward_from_residuals_plain(raws, consts, lnl, grad,
                                                         weights, scale_exp)


@functools.lru_cache(maxsize=None)
def _block_backward_kernel(route):
    symbol = {"fft": "conv_lnl_fft_backward_launch",
              "padded": "conv_lnl_padded_backward_launch",
              "cluster": "conv_lnl_cluster_backward_launch",
              "global": "conv_lnl_global_backward_launch"}[route]
    ints = 1 + _SIDE_INTS[route] + 2
    return _build.function(
        "conv_lnl_backward", symbol,
        [ctypes.c_void_p] + [ctypes.c_int] * ints
        + [ctypes.c_void_p] * (len(FFT_BACKWARD_CONST_ARGS) + 6 + (route == "global")),
    )


@functools.lru_cache(maxsize=1)
def _dft_backward_kernel():
    return _build.function(
        "conv_lnl_backward", "conv_lnl_dft_backward_launch",
        [ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * (len(DFT_BACKWARD_CONST_ARGS) + 9),
    )


# conv_lnl_fft_backward_launch(raws, batch, h, w, per_target, spectra_stride,
# <these>, weights, scale_exp, lnl, grad, out, stream): the conjugate spectra
FFT_BACKWARD_CONST_ARGS = ("twiddle", "fft_layout", "var_gain", "psf_r",
                           "psf_ic", "var_r", "var_ic")
# conv_lnl_padded_backward_launch(raws, batch, h, w, mh, mw, per_target,
# spectra_stride, <these>, weights, scale_exp, lnl, grad, out, stream): the
# same at the transform's sides (conv_lnl_cluster_backward_launch's, with
# the cluster's size after mh, mw; conv_lnl_global_backward_launch's with the
# tiles there and its scratch S before out)
PADDED_BACKWARD_CONST_ARGS = ("pad_twiddle", "pad_layout", "var_gain", "pad_psf_r",
                              "pad_psf_ic", "pad_var_r", "pad_var_ic")
# conv_lnl_dft_backward_launch(raws, batch, h, w, per_target, data_stride,
# <these>, lnl, grad, t1,
# t2, conv, mvar, ga, gc, out, stream): the forward's operators, the
# adjoint's (the transposes, in the order the adjoint applies them)
DFT_BACKWARD_CONST_ARGS = ("cw", "sw", "lf", "li", "ica", "isa", "ica_t",
                           "isa_t", "li_t", "lf_t", "cw_t", "sw_t", "psf_r",
                           "psf_i", "var_r", "var_i", "psf_ic", "var_ic",
                           "obs", "obs_var", "good_f")


def _launch_backward(raws, consts: ConvLnlConsts, lnl, grad, route, residuals=None):
    """The backward kernel on ``route``: off the matmul-DFT route from the
    forward's ``residuals`` ``(weights, scale_exp)``, on it recomputing the
    forward (``chip_smoke.py`` also times that route on the other routes'
    inputs)."""
    if raws.dtype != torch.float32 or grad.dtype != torch.float32:
        raise TypeError("the CUDA conv_lnl backward takes float32")
    check_launch_consts(consts, raws.device)
    raws, lnl, grad = raws.contiguous(), lnl.contiguous(), grad.contiguous()
    b, h, w = raws.shape
    dev = raws.device
    out = torch.empty_like(raws)
    sides = (h, w)
    if route in _FFT_ROUTES:
        weights, scale_exp = residuals
        if weights.shape != (b, h, w, 2) or weights.dtype != torch.float32 \
                or scale_exp.shape != (b,) or scale_exp.dtype != torch.int32 \
                or weights.device != dev or scale_exp.device != dev:
            raise ValueError("residuals must be (B, H, W, 2) float32 weights and "
                             "(B,) int32 scale exponents on the raws' device")
        fn = _block_backward_kernel(route)
        names = FFT_BACKWARD_CONST_ARGS if route == "fft" else PADDED_BACKWARD_CONST_ARGS
        per, _, spectra = _target_ints(b, consts, route)
        sides = _sides(route, (h, w)) + (per, spectra)
        scratch = [weights.contiguous(), scale_exp.contiguous(), lnl, grad]
        if route == "global":  # the transform's rows, S
            scratch.append(_transform_rows(b, (h, w), dev))
        tensors = [getattr(consts, n) for n in names] + scratch + [out]
    else:
        t1 = torch.empty((b, 2, h, w // 2 + 1), dtype=torch.float32, device=dev)
        scratch = [t1, torch.empty_like(t1)] + [torch.empty_like(raws)
                                               for _ in range(4)]
        fn, names = _dft_backward_kernel(), DFT_BACKWARD_CONST_ARGS
        sides += _target_ints(b, consts, route)
        tensors = [getattr(consts, n) for n in names] + [lnl, grad] + scratch + [out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(raws.data_ptr(), b, *sides, *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(_launch_error("conv_lnl backward", route, (h, w), err))
    return out


def batched_conv_lnl_backward(raws, consts: ConvLnlConsts, lnl, grad, residuals=None):
    """``dlnL/draw (B, H, W)`` of :func:`batched_conv_lnl` at ``raws``
    (whose lnL was ``lnl``) for the output gradient ``grad (B,)``.  On
    CUDA the backward kernel of the route :func:`conv_route` picks
    (counted in ``batched_conv_lnl_backward.launches``,
    ``.route_launches`` and ``.shape_launches``); every route but the
    matmul-DFT one reads ``residuals``, the ``(weights, scale_exp)`` of
    :func:`batched_conv_lnl_residuals` at the same ``raws``, and raise
    ``ValueError`` without them.  A stacked consts counts on the route's
    ``"<route>_targets"`` key.  On the CPU
    :func:`batched_conv_lnl_backward_plain` (``residuals`` unused)."""
    _check_inputs(raws, consts)
    if raws.device.type == "cpu":
        return batched_conv_lnl_backward_plain(raws, consts, lnl, grad)
    if raws.device.type != "cuda":
        raise ValueError(f"unsupported device {raws.device}")
    route = conv_route(consts.shape)
    if route in _FFT_ROUTES and residuals is None:
        raise ValueError(f"the {route} route's backward reads the forward's "
                         "residuals (batched_conv_lnl_residuals)")
    out = _launch_backward(raws, consts, lnl, grad, route, residuals)
    counts.count(batched_conv_lnl_backward, _counted(route, consts), consts.shape)
    return out


batched_conv_lnl_backward.launches = 0
batched_conv_lnl_backward.route_launches = {"fft": 0, "dft": 0, "padded": 0,
                                            "cluster": 0, "global": 0, "fft_targets": 0,
                                            "dft_targets": 0, "padded_targets": 0,
                                            "cluster_targets": 0, "global_targets": 0}
batched_conv_lnl_backward.shape_launches = {}
