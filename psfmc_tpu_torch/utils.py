"""Utility re-exports + progress printing (the reference's ``utils`` surface).

The numeric functions live in :mod:`psfmc_tpu_torch.ops` and the input
preprocessing in :mod:`psfmc_tpu_torch.io.preprocess`; this module
re-exports them under the reference's flat ``utils`` namespace, as the
JAX package's ``utils`` does.  That module's ``apply_platform_env``
selects a JAX platform and has no counterpart here: the port's command
line reads ``PSFMC_PLATFORM`` itself (:mod:`psfmc_tpu_torch.cli`).
"""
from __future__ import annotations

from .io.preprocess import (  # noqa: F401
    calculate_psf_variability,
    mask_from_file,
    norm_psf,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)
from .ops.coords import array_coords, mag_to_flux  # noqa: F401
from .ops.fourier import convolve, pad_and_rfft_image  # noqa: F401

__all__ = [
    "calculate_psf_variability",
    "mask_from_file",
    "norm_psf",
    "pre_fft_psf",
    "preprocess_obs",
    "preprocess_psf",
    "array_coords",
    "mag_to_flux",
    "convolve",
    "pad_and_rfft_image",
    "print_progress",
]


def print_progress(sample, max_samples, stage="Burning"):
    """Percent progress printer (reference utils.py:167-171)."""
    next_pct = 100 * (sample + 1) // max_samples
    curr_pct = 100 * sample // max_samples
    if next_pct - curr_pct > 0:
        print(f"{stage}: {next_pct:d}%")
