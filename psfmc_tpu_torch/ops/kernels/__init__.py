"""Hand-written CUDA kernels of the port (counterpart of ``ops/pallas/``).

Each module holds a wrapper that launches its kernel on CUDA tensors and
counts the launches executed (``<wrapper>.launches``, through
:mod:`.counts`, which also counts the replays of a captured CUDA graph),
and a plain PyTorch version of the same function that it uses for CPU
tensors.  The two
likelihood kernels have an FFT, a padded, a cluster, a global and a
matmul-DFT route, picked from the image's shape alone by one rule (:func:`conv_route`;
the fused kernel's ``fused_lnl.fused_route`` is the same).  Sources are
in ``psfmc_tpu_torch/csrc/`` and are built with ``nvcc`` on first use
(:mod:`._build`).  The fused kernel's wrapper is reached through its
module, ``psfmc_tpu_torch.ops.kernels.fused_lnl``, whose name it shares.
"""
from . import fused_lnl
from .conv_lnl import (
    ConvLnlConsts,
    batched_conv_lnl,
    batched_lnl_supported,
    batched_conv_lnl_plain,
    conv_route,
    make_conv_lnl_consts,
)
from .sersic_render import (
    pack_sersic_params,
    render_sersics,
    render_sersics_plain,
    render_sersics_tiled,
)

__all__ = [
    "ConvLnlConsts",
    "batched_conv_lnl",
    "batched_lnl_supported",
    "batched_conv_lnl_plain",
    "conv_route",
    "make_conv_lnl_consts",
    "pack_sersic_params",
    "render_sersics",
    "render_sersics_plain",
    "render_sersics_tiled",
]
