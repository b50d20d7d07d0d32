"""Numeric operations of the port (counterpart of ``psfmc_tpu.ops``)."""
from . import kernels
from .coords import array_coords, coord_grids, mag_to_flux
from .fourier import convolve, convolve_rdft, pad_and_rfft_image, rdft_matrices
from .gammainc import gammaincinv_half, gammaincinv_half_table
from .likelihood import gaussian_lnlike, make_lnlike
from .pointsource import (
    add_pointsource,
    lanczos,
    render_pointsource,
    render_pointsource_dense,
    sinc,
)
from .sersic import (
    render_sersic,
    sersic_kappa,
    sersic_profile_core,
    sersic_sb_eff,
    sersic_scalar_params,
    sersic_sq_radii,
)

__all__ = [
    "kernels",
    "array_coords",
    "coord_grids",
    "mag_to_flux",
    "convolve",
    "convolve_rdft",
    "pad_and_rfft_image",
    "rdft_matrices",
    "gammaincinv_half",
    "gammaincinv_half_table",
    "gaussian_lnlike",
    "make_lnlike",
    "add_pointsource",
    "lanczos",
    "render_pointsource",
    "render_pointsource_dense",
    "sinc",
    "render_sersic",
    "sersic_kappa",
    "sersic_profile_core",
    "sersic_sb_eff",
    "sersic_scalar_params",
    "sersic_sq_radii",
]
