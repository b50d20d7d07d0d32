"""psfmc_tpu_torch — the PyTorch + CUDA port of ``psfmc_tpu``.

The port mirrors the JAX package's module names (``ops``, ``models``,
``sampler``, ``io``, ``distributions``, ``database``, ``analysis``,
``model_parser``, ``fitting``) so each function has an obvious
counterpart, but it imports nothing from ``psfmc_tpu`` and never imports
``jax``: host-side helpers it needs are carried as its own copies.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
host without CUDA they raise instead of falling back.  On the CPU every
kernel wrapper uses its plain PyTorch version; on CUDA only the
hand-written kernels in ``csrc/`` run (built with ``nvcc`` at first use).
"""
from . import (analysis, batchfit, database, distributions, hierarchy, io, model_parser,
               models, ops, optimize, sampler)
from ._device import resolve_device
from .batchfit import fit_batch, simulate_stack
from .hierarchy import fit_hierarchical
from .database import get_sampler_state, load_database
from .fitting import model_galaxy_evidence, model_galaxy_map, model_galaxy_mcmc
from .models import MultiComponentModel, UnconstrainingTransform, build_transform
from .optimize import MAPResult, fit_map, laplace_covariance, scatter_around

__version__ = "0.1.0"

__all__ = [
    "MultiComponentModel",
    "load_database",
    "get_sampler_state",
    "analysis",
    "batchfit",
    "database",
    "fit_batch",
    "fit_hierarchical",
    "hierarchy",
    "simulate_stack",
    "model_parser",
    "model_galaxy_mcmc",
    "model_galaxy_map",
    "model_galaxy_evidence",
    "fit_map",
    "scatter_around",
    "laplace_covariance",
    "MAPResult",
    "build_transform",
    "UnconstrainingTransform",
    "optimize",
    "distributions",
    "io",
    "models",
    "ops",
    "sampler",
    "resolve_device",
    "__version__",
]
