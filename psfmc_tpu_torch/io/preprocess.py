"""Observation / PSF preprocessing (port of ``io/preprocess.py``, arrays only).

Host numpy, once per model build, with the reference's semantics:

* :func:`preprocess_obs` — bad pixels are non-finite data or weight, or
  weight <= 0; they get infinite variance.  An optional boolean mask
  array (True = exclude) extends the bad-pixel map and leaves the
  variance untouched.
* :func:`preprocess_psf` — bad PSF pixels are zeroed in data and weight,
  then the PSF is normalized to unit sum (``math.fsum``).
* :func:`calculate_psf_variability` — inter-PSF mismatch variance.
* :func:`pre_fft_psf` — center-padded ``rfft2`` of PSF and variance.

FITS files and ds9 regions are read by the host-layer slice; here a
string input raises ``NotImplementedError``.
"""
from __future__ import annotations

from math import fsum

import numpy as np

from ..ops.fourier import pad_and_rfft_image

__all__ = [
    "norm_psf",
    "preprocess_obs",
    "preprocess_psf",
    "pre_fft_psf",
    "calculate_psf_variability",
]


def _as_array(data, what):
    if isinstance(data, str):
        raise NotImplementedError(
            f"{what}: FITS input ({data!r}) comes with the host-layer "
            "slice; pass a numpy array"
        )
    return np.asarray(data, dtype=np.float64)


def norm_psf(psf_data, psf_ivm):
    """Normalize PSF to unit sum; scale IVM to match."""
    psf_sum = fsum(np.asarray(psf_data, dtype=np.float64).flat)
    return psf_data / psf_sum, psf_ivm * psf_sum**2


def preprocess_obs(obs_data, obs_ivm, mask=None):
    """(data, variance, bad_px) from observation + weight arrays.

    ``mask`` is an optional boolean array of the data's shape, True
    where a pixel is excluded.
    """
    obs_data = _as_array(obs_data, "observation")
    obs_ivm = _as_array(obs_ivm, "observation weight")
    badpx = ~np.isfinite(obs_data) | ~np.isfinite(obs_ivm) | (obs_ivm <= 0)
    with np.errstate(divide="ignore"):
        obs_var = np.where(badpx, np.inf, 1.0 / np.where(badpx, 1.0, obs_ivm))
    if mask is not None:
        if isinstance(mask, str):
            raise NotImplementedError(
                "mask files (FITS, ds9 regions) come with the host-layer "
                "slice; pass a boolean array"
            )
        mask = np.asarray(mask)
        if mask.shape != obs_data.shape:
            raise ValueError(
                f"mask array shape {mask.shape} != data shape {obs_data.shape}"
            )
        badpx = badpx | mask.astype(bool)
    return obs_data, obs_var, badpx


def preprocess_psf(psf_data, psf_ivm):
    """Zero bad PSF pixels, normalize; returns (psf, variance)."""
    psf_data = _as_array(psf_data, "PSF")
    psf_ivm = _as_array(psf_ivm, "PSF weight")
    badpx = ~np.isfinite(psf_data) | ~np.isfinite(psf_ivm) | (psf_ivm <= 0)
    psf_data = np.where(badpx, 0.0, psf_data)
    psf_ivm = np.where(badpx, 0.0, psf_ivm)
    psf_data, psf_ivm = norm_psf(psf_data, psf_ivm)
    with np.errstate(divide="ignore"):
        psf_var = np.where(
            psf_ivm <= 0, 0.0, 1.0 / np.where(psf_ivm <= 0, 1.0, psf_ivm)
        )
    return psf_data, psf_var


def pre_fft_psf(psf_data, psf_var, pad_to_shape):
    """One-time rfft2 of the padded PSF and its variance map."""
    return (
        pad_and_rfft_image(psf_data, pad_to_shape),
        pad_and_rfft_image(psf_var, pad_to_shape),
    )


def calculate_psf_variability(psf_data, psf_vars):
    """Add the inter-PSF mismatch variance to each PSF's variance map."""
    psf_data = list(psf_data)
    psf_vars = list(psf_vars)
    if len(psf_data) == 1:
        return psf_data, psf_vars
    mismatch_var = np.var(np.stack(psf_data), axis=0)
    return psf_data, [var + mismatch_var for var in psf_vars]
