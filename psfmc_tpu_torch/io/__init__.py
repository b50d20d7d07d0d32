"""Host-side input: FITS codec, ds9 regions, trace table, WCS,
preprocessing, survey cutouts, per-target PSFs and the GALFIT importer."""
from . import fits, region, table, wcs
from .cutout import CutoutStack, cutout_stack
from .galfit import (
    components_from_feedme,
    feedme_to_model_source,
    parse_feedme,
    results_to_feedme,
)
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
from .region import parse_region_file, region_mask
from .table import Table
from .wcs import MiniWCS, proj_plane_pixel_area

__all__ = [
    "fits",
    "region",
    "table",
    "wcs",
    "Table",
    "CutoutStack",
    "MiniWCS",
    "proj_plane_pixel_area",
    "parse_region_file",
    "region_mask",
    "calculate_psf_variability",
    "cutout_stack",
    "interpolate_psfs",
    "make_source_mask",
    "mask_from_file",
    "norm_psf",
    "pre_fft_psf",
    "preprocess_obs",
    "preprocess_psf",
    "components_from_feedme",
    "feedme_to_model_source",
    "parse_feedme",
    "results_to_feedme",
]
