"""Sky + Sersic raw-model render: CUDA kernel wrapper and plain version.

Counterpart of ``psfmc_tpu/ops/pallas/sersic_pallas.py``: both of its
Pallas kernels (``render_sersics_pallas_one``, one walker per program,
and ``render_sersics_pallas_tiled``, T walkers per program) map to the
one CUDA kernel in ``csrc/sersic_render.cu``, with the walkers per block
as a launch parameter.

* :func:`render_sersics` — ``(B, S, 9)`` packed rows + ``(B,)`` sky ->
  ``(B, H, W)``, one walker per block;
* :func:`render_sersics_tiled` — the same with ``tile`` walkers per
  block; a tile that does not divide ``B`` raises ``ValueError`` (the
  Pallas kernel's contract);
* :func:`render_sersics_plain` — the same function in plain PyTorch.

On CPU tensors the wrappers return the plain version; on CUDA tensors
they launch the kernel or raise.  Point sources are not rendered here:
they are rank-1 outer products added in torch, as in the JAX path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..sersic import sersic_profile_core
from ..coords import coord_grids
from . import _build

__all__ = [
    "PARAMS_PER_SERSIC",
    "pack_sersic_params",
    "render_sersics",
    "render_sersics_tiled",
    "render_sersics_plain",
    "pick_tile",
]

PARAMS_PER_SERSIC = 9


def pack_sersic_params(scalars):
    """Stack the nine ``sersic_scalar_params`` outputs into ``(..., 9)``."""
    return torch.stack(scalars, dim=-1)


def render_sersics_plain(params, sky, shape):
    """Plain PyTorch render: ``sky + sum_s sersic_profile_core``."""
    xg, yg = coord_grids(shape, params.dtype, params.device)
    acc = sky[:, None, None].expand(params.shape[0], *shape)
    for s in range(params.shape[1]):
        q = params[:, s, :, None, None]
        acc = acc + sersic_profile_core(
            xg - q[:, 0], yg - q[:, 1], q[:, 2], q[:, 3], q[:, 4], q[:, 5],
            q[:, 6], q[:, 7], q[:, 8],
        )
    return acc.contiguous()


def pick_tile(batch):
    """Largest divisor of ``batch`` that is <= 25 (the Pallas tile rule)."""
    for t in (25, 16, 10, 8, 5, 4, 2):
        if batch % t == 0:
            return t
    return 1


def _check(params, sky, shape):
    if params.ndim != 3 or params.shape[2] != PARAMS_PER_SERSIC:
        raise ValueError(f"params must be (B, S, 9), got {tuple(params.shape)}")
    if sky.shape != (params.shape[0],):
        raise ValueError(
            f"sky must be ({params.shape[0]},), got {tuple(sky.shape)}"
        )
    if sky.device != params.device or sky.dtype != params.dtype:
        raise ValueError("params and sky must share device and dtype")
    if len(shape) != 2 or min(shape) <= 0:
        raise ValueError(f"bad image shape {shape}")


@functools.lru_cache(maxsize=1)
def _kernel():
    # (params, sky, out, batch, num_sersic, h, w, walkers_per_block, stream)
    return _build.function(
        "sersic_render", "sersic_render_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )


def _launch(params, sky, shape, walkers_per_block):
    if params.dtype != torch.float32:
        raise TypeError(f"the CUDA render takes float32, got {params.dtype}")
    params = params.contiguous()
    sky = sky.contiguous()
    b, s, _ = params.shape
    h, w = shape
    out = torch.empty((b, h, w), dtype=torch.float32, device=params.device)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(params.data_ptr(), sky.data_ptr(), out.data_ptr(),
                        b, s, h, w, walkers_per_block, stream)
    if err != 0:
        raise RuntimeError(f"sersic_render launch failed: cudaError {err}")
    return out


def _dispatch(params, sky, shape, walkers_per_block, counter_owner):
    if params.device.type == "cpu":
        return render_sersics_plain(params, sky, shape)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    out = _launch(params, sky, shape, walkers_per_block)
    counter_owner.launches += 1
    return out


def render_sersics(params, sky, shape):
    """Batched render ``(B, S, 9), (B,) -> (B, H, W)``, one walker per block."""
    _check(params, sky, tuple(shape))
    return _dispatch(params, sky, tuple(shape), 1, render_sersics)


def render_sersics_tiled(params, sky, shape, tile=None):
    """Walker-tiled render: ``tile`` walkers per block (default
    :func:`pick_tile`).  Raises ``ValueError`` if ``tile`` does not
    divide the batch."""
    _check(params, sky, tuple(shape))
    b = params.shape[0]
    if tile is None:
        tile = pick_tile(b)
    elif tile < 1 or b % tile:
        raise ValueError(f"tile={tile} does not divide the batch {b}")
    return _dispatch(params, sky, tuple(shape), int(tile), render_sersics_tiled)


render_sersics.launches = 0
render_sersics_tiled.launches = 0
