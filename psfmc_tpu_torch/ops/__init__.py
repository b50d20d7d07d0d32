"""Numeric operations of the port (counterpart of ``psfmc_tpu.ops``)."""
from . import kernels
from .coords import coord_grids, mag_to_flux
from .fourier import convolve, convolve_rdft, pad_and_rfft_image, rdft_matrices
from .gammainc import gammaincinv_half, gammaincinv_half_table
from .likelihood import gaussian_lnlike
from .pointsource import render_pointsource_dense
from .sersic import render_sersic, sersic_profile_core, sersic_scalar_params

__all__ = [
    "kernels",
    "coord_grids",
    "mag_to_flux",
    "convolve",
    "convolve_rdft",
    "pad_and_rfft_image",
    "rdft_matrices",
    "gammaincinv_half",
    "gammaincinv_half_table",
    "gaussian_lnlike",
    "render_pointsource_dense",
    "render_sersic",
    "sersic_profile_core",
    "sersic_scalar_params",
]
