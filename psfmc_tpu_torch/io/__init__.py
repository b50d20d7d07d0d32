"""Host-side input: FITS codec, ds9 regions, trace table, preprocessing."""
from . import fits, region, table, wcs
from .preprocess import (
    calculate_psf_variability,
    mask_from_file,
    norm_psf,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)

__all__ = [
    "fits",
    "region",
    "table",
    "wcs",
    "calculate_psf_variability",
    "mask_from_file",
    "norm_psf",
    "pre_fft_psf",
    "preprocess_obs",
    "preprocess_psf",
]
