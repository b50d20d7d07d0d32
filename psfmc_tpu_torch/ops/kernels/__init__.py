"""Hand-written CUDA kernels of the port (counterpart of ``ops/pallas/``).

Each module holds a wrapper that launches its kernel on CUDA tensors,
counts its launches (``<wrapper>.launches``), and a plain PyTorch
version of the same function that it uses for CPU tensors.  Sources are
in ``psfmc_tpu_torch/csrc/`` and are built with ``nvcc`` on first use
(:mod:`._build`).
"""
from .conv_lnl import (
    ConvLnlConsts,
    batched_conv_lnl,
    batched_conv_lnl_plain,
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
    "batched_conv_lnl_plain",
    "make_conv_lnl_consts",
    "pack_sersic_params",
    "render_sersics",
    "render_sersics_plain",
    "render_sersics_tiled",
]
