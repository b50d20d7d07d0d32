"""Host-side input preprocessing (arrays only in this slice)."""
from .preprocess import (
    calculate_psf_variability,
    norm_psf,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)

__all__ = [
    "calculate_psf_variability",
    "norm_psf",
    "pre_fft_psf",
    "preprocess_obs",
    "preprocess_psf",
]
