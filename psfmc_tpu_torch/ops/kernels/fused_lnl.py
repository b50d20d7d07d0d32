"""Fused render + convolution + Gaussian likelihood: CUDA kernel wrapper and plain version.

Counterpart of ``psfmc_tpu/ops/pallas/lnpost_pallas.py``
(``make_fused_lnl_batch``, gate ``fused_lnl_supported``): per walker,
render ``raw = sky + sum of Sersics + sum of point sources``, convolve it
with the PSF and its square with the PSF variance map, and reduce the
masked Gaussian lnL, all in one kernel (``csrc/fused_lnl.cu``) that keeps
the walker's images in shared memory and writes one float per walker.
The source has the five routes of ``csrc/conv_lnl.cu``, and
:func:`fused_route` is :func:`~psfmc_tpu_torch.ops.kernels.conv_lnl.conv_route`:
``"fft"`` (one complex FFT pair in a block's shared memory on
``csrc/fft_conv.cuh``'s radix-2 or mixed-radix geometry), ``"padded"``
(its padded geometry), ``"cluster"`` (``csrc/fft_cluster.cuh``: the
transform across a cluster of 2, 4 or 8 blocks), ``"global"``
(``csrc/fft_global.cuh``: the transform in a global-memory scratch, a
render pass writing the walker's rows and their peaks before conv_lnl's
row, column and readout passes) and ``"dft"`` (the matmul-DFT products in
three shared-memory buffers, for what no other route holds: a side of 1).
On the first four the kernel reads the walker's scalars (Sersic rows,
``fky``, ``kx``) through the read-only cache instead of copying them into
shared memory, so that its shared memory is conv_lnl's and the two share
one route rule; the matmul-DFT route copies them beside its buffers.  The consts are conv_lnl's
(:func:`~psfmc_tpu_torch.ops.kernels.conv_lnl.make_conv_lnl_consts`).

The per-walker scalar preparation stays in torch, as in the JAX wrapper:
the packed Sersic rows (:func:`~psfmc_tpu_torch.ops.sersic.sersic_scalar_params`),
the sky sum and the point sources' 1-D kernels ``fky = flux * ky`` and
``kx`` (:func:`~psfmc_tpu_torch.ops.pointsource.pointsource_factors`).

* :func:`fused_lnl` — ``(B, S, 9)``, ``(B,)``, ``(B, P, H)``, ``(B, P,
  W)`` -> ``(B,)`` lnL; non-finite results are exactly ``-inf``;
* :func:`fused_lnl_plain` — the same function in plain PyTorch: the
  render, the dense point sources and :func:`batched_conv_lnl_plain`;
* :func:`fused_lnl_supported` — which specs the kernel covers.

On CPU tensors :func:`fused_lnl` returns the plain version; on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..pointsource import pointsource_image
from . import _build, counts
from .conv_lnl import (
    _DFT_CONST_ARGS,
    _FFT_ROUTES,
    _SIDE_INTS,
    BLOCK_SMEM_LIMIT,
    ConvLnlConsts,
    _global_scratch,
    _launch_error,
    _sides,
    batched_conv_lnl_plain,
    check_launch_consts,
    cluster_size,
    conv_route,
    global_tiles,
    padded_shape,
)
from .sersic_render import PARAMS_PER_SERSIC, render_sersics_plain

__all__ = [
    "FUSED_SMEM_LIMIT",
    "cluster_rank_rows",
    "fused_lnl",
    "fused_lnl_plain",
    "fused_lnl_smem_bytes",
    "fused_lnl_supported",
    "fused_route",
    "global_render_rows",
]

# Shared memory a block may use on Hopper, less the matmul-DFT route's
# static reduction buffer (16 doubles).
FUSED_SMEM_LIMIT = BLOCK_SMEM_LIMIT - 16 * 8

_SHAPE_ATTRS = {"c0", "f1", "f2", "f3", "f4", "b1", "b2", "b3",
                "rtrunc", "rtrunc_in", "rot_ang"}


def fused_route(shape):
    """``"fft"``, ``"padded"``, ``"cluster"``, ``"global"`` or ``"dft"``: the fused
    kernel's route for an ``(H, W)`` image, conv_lnl's
    (:func:`~psfmc_tpu_torch.ops.kernels.conv_lnl.conv_route`)."""
    return conv_route(shape)


def cluster_rank_rows(shape):
    """The cluster route's split of one walker over the ``C =
    cluster_size(shape)`` ranks of its cluster (``csrc/fft_cluster.cuh``'s
    ``ClusterGeom``): for rank ``r``, ``((row0, row1), (img0, img1))``,
    the rows ``[row0, row1)`` of the transform :func:`padded_shape` it
    holds (``R = ceil(M_h / C)`` each; it zeroes their slots outside the
    image) and the image rows ``[img0, img1)`` it renders (``ceil(H / C)``
    each, its readout's rows) into whichever rank holds them; ``[]`` off
    the cluster route."""
    if conv_route(shape) != "cluster":
        return []
    ranks = cluster_size(shape)
    h, mh = int(shape[0]), padded_shape(shape)[0]
    rows, hc = -(-mh // ranks), -(-h // ranks)
    return [((r * rows, min(r * rows + rows, mh)), (min(r * hc, h), min(r * hc + hc, h)))
            for r in range(ranks)]


def global_render_rows(shape):
    """The global route's render pass (``csrc/fused_lnl.cu``'s
    ``fused_lnl_global_render_kernel``): the image rows ``[y0, y1)`` that
    each block renders, the row tiles of conv_lnl's row passes
    (:func:`~psfmc_tpu_torch.ops.kernels.conv_lnl.global_tiles`), so that
    each tile's peak is ready for the pack; the pad's zeros are the row
    passes' (columns ``W .. M_w``) and the column passes' (rows ``H ..
    M_h``); ``[]`` off the global route."""
    if conv_route(shape) != "global":
        return []
    h, rows = int(shape[0]), global_tiles(shape)[0]
    return [(y0, min(y0 + rows, h)) for y0 in range(0, h, rows)]


def fused_lnl_smem_bytes(shape, num_sersic, num_ps):
    """Dynamic shared memory of one block on the matmul-DFT route: three
    ``(2, H, W//2+1)`` float buffers plus the walker's scalars
    (``csrc/fused_lnl.cu``); a block has :data:`FUSED_SMEM_LIMIT` for
    them."""
    h, w = shape
    return 4 * (6 * h * (w // 2 + 1) + PARAMS_PER_SERSIC * num_sersic
                + num_ps * (h + w))


def fused_lnl_supported(spec):
    """``(ok, reason)``: whether the fused kernel computes ``spec``'s
    likelihood exactly.

    The JAX package's gate (component kinds whitelisted, flat sky,
    elliptical Sersics, one PSF, Gaussian likelihood, no padding, no
    oversampling), plus the port's own limit: the route the shape takes
    (:func:`fused_route`) must hold one walker.  The FFT, padded, cluster
    and global routes hold every shape conv_lnl's rule sends them (every
    shape with both sides from 2 to 1024); the matmul-DFT route, left for
    a side of 1, needs its three buffers in a block's shared memory.
    """
    specs = getattr(spec, "comp_specs", ())
    known = {"sky", "pointsource", "sersic", "psfselector"}
    checks = (
        (all(cs.kind in known for cs in specs),
         "a component kind other than sky, pointsource, sersic"),
        (all(not ({"dx", "dy"} & set(cs.params))
             for cs in specs if cs.kind == "sky"), "a sky gradient"),
        (all(not (_SHAPE_ATTRS & set(cs.params))
             for cs in specs if cs.kind == "sersic"),
         "a non-elliptical Sersic shape"),
        (getattr(spec, "num_psfs", 1) == 1, "several PSFs"),
        (getattr(spec, "likelihood", "gaussian") == "gaussian",
         "a non-Gaussian likelihood"),
        (getattr(spec, "conv_pad", 0) == 0, "conv_pad > 0"),
        (getattr(spec, "render_oversample", 1) == 1, "render_oversample > 1"),
    )
    for ok, what in checks:
        if not ok:
            return False, what
    nser = sum(cs.kind == "sersic" for cs in specs)
    nps = sum(cs.kind == "pointsource" for cs in specs)
    route = fused_route(spec.shape)
    need = fused_lnl_smem_bytes(tuple(spec.shape), nser, nps)
    if route == "dft" and need > FUSED_SMEM_LIMIT:
        return False, (f"a {spec.shape[0]}x{spec.shape[1]} image: one walker "
                       f"needs {need} bytes of shared memory on the dft "
                       f"route, a block has {FUSED_SMEM_LIMIT}")
    return True, ""


def fused_lnl_plain(packed, sky, fky, kx, consts: ConvLnlConsts):
    """Plain PyTorch version: render, point sources, convolutions, lnL."""
    raw = render_sersics_plain(packed, sky, consts.shape)
    return batched_conv_lnl_plain(raw + pointsource_image(fky, kx), consts)


# fused_lnl_<route>_launch(packed, sky, fky, kx, batch, num_sersic, num_ps,
# <the sides: conv_lnl's _sides>, <conv_lnl's constants of the route, one
# observation and one PSF>, <on the global route: the raw images' scratch
# and conv_lnl's global scratch>, out, stream); the matmul-DFT route's
# symbol is fused_lnl_launch
_ROUTES = {"dft": ("fused_lnl_launch", _DFT_CONST_ARGS)}
_ROUTES.update({route: (f"fused_lnl_{route}_launch", names)
                for route, (_, names) in _FFT_ROUTES.items()})


def _scratch(route, b, shape, device):
    """The global route's scratch (the raw images ``(B, H, W)`` float32,
    then conv_lnl's: ``_global_scratch``); none on the other routes."""
    if route != "global":
        return []
    return [torch.empty((b, *shape), dtype=torch.float32, device=device)] + \
        _global_scratch(b, shape, device)


@functools.lru_cache(maxsize=None)
def _kernel(route):
    symbol, const_args = _ROUTES[route]
    return _build.function(
        "fused_lnl", symbol,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * (3 + _SIDE_INTS.get(route, 2))
        + [ctypes.c_void_p] * (len(const_args) + 4 * (route == "global") + 2),
    )


def _check(packed, sky, fky, kx, consts):
    shape = consts.shape
    if packed.ndim != 3 or packed.shape[2] != PARAMS_PER_SERSIC:
        raise ValueError(f"packed must be (B, S, 9), got {tuple(packed.shape)}")
    b = packed.shape[0]
    if tuple(sky.shape) != (b,):
        raise ValueError(f"sky must be ({b},), got {tuple(sky.shape)}")
    if fky.ndim != 3 or fky.shape[0] != b or fky.shape[2] != shape[0]:
        raise ValueError(f"fky must be ({b}, P, {shape[0]}), got {tuple(fky.shape)}")
    if tuple(kx.shape) != (b, fky.shape[1], shape[1]):
        raise ValueError(
            f"kx must be ({b}, {fky.shape[1]}, {shape[1]}), got {tuple(kx.shape)}")
    for t in (sky, fky, kx):
        if t.device != packed.device or t.dtype != packed.dtype:
            raise ValueError("packed, sky, fky and kx must share device and dtype")


def _launch(packed, sky, fky, kx, consts: ConvLnlConsts, route):
    if packed.dtype != torch.float32:
        raise TypeError(f"the CUDA fused_lnl takes float32, got {packed.dtype}")
    if consts.targets:
        raise ValueError("the fused kernel takes one observation, not a stacked consts")
    check_launch_consts(consts, packed.device)
    b, s, _ = packed.shape
    p = fky.shape[1]
    h, w = consts.shape
    packed, sky, fky, kx = (t.contiguous() for t in (packed, sky, fky, kx))
    out = torch.empty((b,), dtype=torch.float32, device=packed.device)
    tensors = [getattr(consts, n) for n in _ROUTES[route][1]] \
        + _scratch(route, b, (h, w), packed.device) + [out]
    sides = _sides(route, (h, w))
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(route)(
            packed.data_ptr(), sky.data_ptr(), fky.data_ptr(), kx.data_ptr(),
            b, s, p, *sides, *(t.data_ptr() for t in tensors), stream)
    if err != 0:  # e.g. a walker too large for a block's shared memory
        if route != "dft":
            raise RuntimeError(_launch_error("fused_lnl", route, (h, w), err))
        raise RuntimeError(
            f"fused_lnl launch failed: cudaError {err} ({h}x{w} walker on the "
            f"dft route, {fused_lnl_smem_bytes((h, w), s, p)} bytes of shared memory)")
    return out


def fused_lnl(packed, sky, fky, kx, consts: ConvLnlConsts):
    """Per-walker Gaussian lnL of the rendered, convolved model (see
    module doc); ``(B,)``."""
    _check(packed, sky, fky, kx, consts)
    if packed.device.type == "cpu":
        return fused_lnl_plain(packed, sky, fky, kx, consts)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    route = fused_route(consts.shape)
    out = _launch(packed, sky, fky, kx, consts, route)
    counts.count(fused_lnl, route)
    return out


fused_lnl.launches = 0
fused_lnl.route_launches = {"fft": 0, "padded": 0, "cluster": 0, "global": 0, "dft": 0}
