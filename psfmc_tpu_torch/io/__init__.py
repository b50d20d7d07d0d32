"""Host-side input: FITS codec, ds9 regions, trace table, preprocessing,
survey cutouts and per-target PSFs."""
from . import fits, region, table, wcs
from .cutout import CutoutStack, cutout_stack
from .preprocess import (
    calculate_psf_variability,
    make_source_mask,
    mask_from_file,
    norm_psf,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)
from .psfgrid import interpolate_psfs

__all__ = [
    "fits",
    "region",
    "table",
    "wcs",
    "CutoutStack",
    "calculate_psf_variability",
    "cutout_stack",
    "interpolate_psfs",
    "make_source_mask",
    "mask_from_file",
    "norm_psf",
    "pre_fft_psf",
    "preprocess_obs",
    "preprocess_psf",
]
