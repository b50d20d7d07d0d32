"""Device policy shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "pin_fp32_matmul"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: on a host without CUDA this raises instead of
    quietly running on the CPU.  The CPU is used only when the caller
    asks for it (``device="cpu"``), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "psfmc_tpu_torch runs on CUDA by default and this host has "
                "no CUDA device; pass device='cpu' to run the plain "
                "PyTorch path explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    if device.index is None:  # "cuda" and "cuda:0" name one device
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def pin_fp32_matmul():
    """Full-fp32 matrix products (no TF32).

    TF32 keeps a 10-bit mantissa, the same danger class as the single-
    pass bf16 that collapsed the flagship's acceptance from 0.28 to 0.08
    on the JAX side: the inverse-variance likelihood amplifies the
    convolution error.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
