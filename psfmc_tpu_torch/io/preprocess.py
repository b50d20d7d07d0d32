"""Observation / PSF preprocessing (port of ``io/preprocess.py``).

Host numpy, once per model build, with the reference's semantics:

* :func:`preprocess_obs` — read observation + weight (FITS file names,
  ``(header, array)`` pairs or arrays); bad pixels are non-finite data or
  weight, or weight <= 0; they get infinite variance.  An optional mask
  (FITS file, nonzero = exclude; ds9 region file, outside = exclude; or a
  boolean array, True = exclude) extends the bad-pixel map and leaves the
  variance untouched.
* :func:`preprocess_psf` — bad PSF pixels are zeroed in data and weight,
  then the PSF is normalized to unit sum (``math.fsum``).
* :func:`calculate_psf_variability` — inter-PSF mismatch variance.
* :func:`bin_psf` — flux-preserving block binning of an oversampled PSF.
* :func:`pre_fft_psf` — center-padded ``rfft2`` of PSF and variance.
* :func:`make_source_mask` — detect-and-mask of neighbours around a
  target (``scipy.ndimage``), for survey cutouts.

FITS files are read with the port's own codec (:mod:`.fits`) and ds9
regions with its own parser (:mod:`.region`), copies of the JAX
package's numpy modules.
"""
from __future__ import annotations

from math import fsum

import numpy as np

from ..ops.fourier import pad_and_rfft_image
from . import fits
from .region import region_mask

__all__ = [
    "norm_psf",
    "preprocess_obs",
    "preprocess_psf",
    "pre_fft_psf",
    "calculate_psf_variability",
    "mask_from_file",
    "bin_psf",
    "make_source_mask",
]


def _get_image(file_or_array):
    """(header, float64 data) from a filename, (header, data) pair or array."""
    if isinstance(file_or_array, str):
        return fits.getheader(file_or_array), np.asarray(
            fits.getdata(file_or_array), dtype=np.float64
        )
    if isinstance(file_or_array, tuple):
        header, data = file_or_array
        return header, np.asarray(data, dtype=np.float64)
    return fits.Header(), np.asarray(file_or_array, dtype=np.float64)


def norm_psf(psf_data, psf_ivm):
    """Normalize PSF to unit sum; scale IVM to match."""
    psf_sum = fsum(np.asarray(psf_data, dtype=np.float64).flat)
    return psf_data / psf_sum, psf_ivm * psf_sum**2


def preprocess_obs(obs_data, obs_ivm, mask_file=None):
    """(header, data, variance, bad_px) from observation + weight.

    Bad pixels get infinite variance; the mask extends ``bad_px`` but
    leaves the variance untouched (:func:`mask_from_file`).
    """
    obs_hdr, obs_data = _get_image(obs_data)
    _, obs_ivm = _get_image(obs_ivm)
    badpx = ~np.isfinite(obs_data) | ~np.isfinite(obs_ivm) | (obs_ivm <= 0)
    with np.errstate(divide="ignore"):
        obs_var = np.where(badpx, np.inf, 1.0 / np.where(badpx, 1.0, obs_ivm))
    if mask_file is not None:
        badpx = badpx | mask_from_file(mask_file, obs_hdr, obs_data.shape)
    return obs_hdr, obs_data, obs_var, badpx


def mask_from_file(mask_file, obs_hdr, shape):
    """Exclusion mask (True = exclude) from a boolean array, a FITS file
    (nonzero = exclude) or a ds9 region file (pixels outside the regions
    are excluded).  A file that is neither FITS nor a usable region file
    raises ``ValueError``: a degraded mask would silently change which
    pixels constrain the fit."""
    if not isinstance(mask_file, str):
        mask = np.asarray(mask_file)
        if mask.shape != tuple(shape):
            raise ValueError(
                f"mask array shape {mask.shape} != data shape {tuple(shape)}"
            )
        return mask.astype(bool)
    try:
        return np.asarray(fits.getdata(mask_file)).astype(bool)
    except Exception:  # noqa: BLE001 - not FITS: try it as a ds9 region
        pass
    try:
        inside = region_mask(mask_file, shape, header=obs_hdr)
    except (ValueError, UnicodeDecodeError) as err:
        raise ValueError(
            f"mask file {mask_file!r} is neither FITS nor a usable ds9 "
            f"region file: {err}"
        ) from err
    return ~inside


def preprocess_psf(psf_data, psf_ivm):
    """Zero bad PSF pixels, normalize; returns (psf, variance)."""
    _, psf_data = _get_image(psf_data)
    _, psf_ivm = _get_image(psf_ivm)
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


def bin_psf(psf_data, psf_var, oversample):
    """Flux-preserving block binning of a PSF sampled ``oversample`` times
    finer than the data: each native pixel is the sum of its ``n x n``
    block, and its variance the sum of the block's variances.  The blocks
    start at sub-pixel (0, 0)."""
    n = int(oversample)
    h, w = psf_data.shape
    if h % n or w % n:
        raise ValueError(
            f"psf_oversample={n} does not divide the PSF shape ({h}, {w})")
    binned = psf_data.reshape(h // n, n, w // n, n).sum(axis=(1, 3))
    var = psf_var.reshape(h // n, n, w // n, n).sum(axis=(1, 3))
    return binned, var


def make_source_mask(image, ivm=None, target_xy=None, nsigma=3.0,
                     npixels=5, grow=2, keep_radius=3.0):
    """Exclusion mask for contaminating neighbors (True = exclude).

    Beyond the reference (whose users draw ds9 circles by hand): the
    standard detect-and-mask step survey pipelines need before feeding
    cutouts to :func:`psfmc_tpu_torch.batchfit.fit_batch` —

    1. sigma-clipped background statistics (5 iterations at 3 sigma),
    2. threshold detection at ``median + nsigma * std``,
    3. 8-connected components, dropping those smaller than ``npixels``
       (single hot pixels belong to the IVM, not the mask),
    4. the component containing — or any component within
       ``keep_radius`` pixels of — ``target_xy`` (default: the image
       center) is the source being fit and stays UNmasked,
    5. everything else is grown by ``grow`` dilations (detection
       thresholds miss faint wings).

    Non-finite pixels and ``ivm <= 0`` pixels are ignored throughout
    (they are already bad pixels).  Host numpy; returns a bool (H, W)
    array that feeds ``Configuration(mask_file=mask)`` directly.
    """
    from scipy import ndimage

    image = np.asarray(image, np.float64)
    good = np.isfinite(image)
    if ivm is not None:
        _, ivm_img = _get_image(ivm)
        good &= np.isfinite(ivm_img) & (np.asarray(ivm_img) > 0)
    if not good.any():
        raise ValueError("make_source_mask: no finite pixels")

    vals = image[good]
    med = np.median(vals)
    std = vals.std()
    for _ in range(5):  # sigma-clipped background stats
        clip = np.abs(vals - med) < 3.0 * std
        if clip.all() or not clip.any():
            break
        vals = vals[clip]
        med = np.median(vals)
        std = vals.std()
    if std == 0.0:
        return np.zeros(image.shape, bool)

    detect = good & (image > med + float(nsigma) * std)
    labels, nlab = ndimage.label(detect, structure=np.ones((3, 3), int))
    if nlab == 0:
        return np.zeros(image.shape, bool)
    counts = np.bincount(labels.ravel(), minlength=nlab + 1)

    h, w = image.shape
    if target_xy is None:
        target_xy = ((w - 1) / 2.0, (h - 1) / 2.0)
    yy, xx = np.mgrid[0:h, 0:w]
    near = np.hypot(
        xx - float(target_xy[0]), yy - float(target_xy[1])
    ) <= float(keep_radius)
    keep = set(np.unique(labels[near & detect]).tolist())
    keep.discard(0)

    mask = np.zeros(image.shape, bool)
    for lab in range(1, nlab + 1):
        if lab in keep or counts[lab] < int(npixels):
            continue
        mask |= labels == lab
    if mask.any() and grow:
        mask = ndimage.binary_dilation(mask, iterations=int(grow))
    return mask
