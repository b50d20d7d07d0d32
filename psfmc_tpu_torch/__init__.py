"""psfmc_tpu_torch — the PyTorch + CUDA port of ``psfmc_tpu``.

The port mirrors the JAX package's module names (``ops``, ``models``,
``sampler``, ``io``, ``distributions``) so each function has an obvious
counterpart, but it imports nothing from ``psfmc_tpu`` and never imports
``jax``: host-side helpers it needs are carried as its own copies.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
host without CUDA they raise instead of falling back.  On the CPU every
kernel wrapper uses its plain PyTorch version; on CUDA only the
hand-written kernels in ``csrc/`` run (built with ``nvcc`` at first use).
"""
from . import distributions, io, models, ops, sampler
from ._device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "distributions",
    "io",
    "models",
    "ops",
    "sampler",
    "resolve_device",
    "__version__",
]
