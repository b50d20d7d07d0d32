"""Device policy shared by every entry point of the port."""
from __future__ import annotations

import contextlib
import gc
import os

import torch

__all__ = ["resolve_device", "pin_fp32_matmul", "gc_paused"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: on a host without CUDA this raises instead of
    quietly running on the CPU.  The CPU is used only when the caller
    asks for it (``device="cpu"``), as the tests do.  In a process of an
    initialised ``torch.distributed`` group (one process a device, as
    ``torchrun`` starts them) ``None`` is ``cuda:LOCAL_RANK``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "psfmc_tpu_torch runs on CUDA by default and this host has "
                "no CUDA device; pass device='cpu' to run the plain "
                "PyTorch path explicitly"
            )
        if "LOCAL_RANK" in os.environ and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
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


@contextlib.contextmanager
def gc_paused():
    """Collect Python's garbage, then pause the collector until the block
    ends: a CUDA graph capture runs inside.  A dead reference cycle can
    hold a captured graph (a posterior and the programs it caches); its
    destruction inside another capture frees memory, which invalidates
    that capture, and the collector may run at any allocation."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
