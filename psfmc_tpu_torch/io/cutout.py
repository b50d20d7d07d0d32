"""Mosaic -> cutout-stack extraction for survey-mode fitting (port of ``io/cutout.py``).

The reference fits one hand-made cutout at a time; its users carve
targets out of big drizzled mosaics with external tooling before psfMC
ever runs.  Here the carving is part of the framework because the
batched fitter wants a very specific product: K cutouts of ONE static
shape (:func:`psfmc_tpu_torch.batchfit.fit_batch` runs the whole
catalog as one ensemble, each step one captured CUDA graph), their IVM planes cut the same way, and a per-cutout FITS
header whose WCS still points at the sky (``CRPIX`` shifted by the
cutout origin) so sky-frame ties, ds9-region masks and the
``sbeff``-style derived traces keep working on the cutout exactly as
they would on the mosaic.

Conventions (matching the rest of the package):

* positions are 0-based ``(x, y)`` pixel coordinates — the component
  ``xy`` convention (reference parity: xy = FITS position - 1) — or
  ``(ra, dec)`` degrees with ``world=True`` (mapped through the
  native TAN :class:`~psfmc_tpu_torch.io.wcs.MiniWCS`).
* windows are clamped fully inside the mosaic (shifted, never
  shrunk — shapes stay static; the same clamp semantics as the
  reference's PointSource ``minimal_slice``).  The returned
  ``positions`` are re-expressed in each cutout's own frame, so they
  can seed ``xy`` priors directly even for clamped edge targets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["CutoutStack", "cutout_stack"]


@dataclass
class CutoutStack:
    """K same-shape cutouts from one mosaic.

    ``obs``/``ivm`` feed :func:`psfmc_tpu_torch.batchfit.fit_batch`
    directly; a
    ``(headers[k], obs[k])`` pair feeds a per-target
    :class:`~psfmc_tpu_torch.models.components.Configuration` (the header
    carries the shifted WCS).
    """

    obs: np.ndarray  # (K, h, w) float64
    ivm: np.ndarray  # (K, h, w) float64
    origins: np.ndarray  # (K, 2) int — 0-based (x0, y0) into the mosaic
    positions: np.ndarray  # (K, 2) float — requested targets, CUTOUT frame
    headers: List[object]  # per-cutout Header (CRPIX shifted)

    @property
    def num_targets(self) -> int:
        return self.obs.shape[0]

    def mosaic_xy(self, k, xy):
        """Map a cutout-frame (x, y) back to mosaic pixels."""
        return np.asarray(xy, np.float64) + self.origins[k]


def cutout_stack(image, ivm, positions, size, world=False):
    """Extract K aligned square cutouts + IVM planes from a mosaic.

    :param image: the mosaic — FITS filename, ``(header, array)``
        pair, or bare array (bare arrays get an empty header; don't
        use ``world=True`` with one).
    :param ivm: the mosaic's inverse-variance map, same forms.  Bad
        mosaic pixels should already carry ``ivm <= 0`` — they flow
        into each cutout and the fitters mask them per target.
    :param positions: (K, 2) target positions — 0-based ``(x, y)``
        pixels, or ``(ra, dec)`` degrees with ``world=True``.
    :param size: cutout side length in pixels, or ``(height, width)``.
        One static shape for all targets — the whole point: the
        batched fitter captures ONE step graph over the stack.
    :param world: interpret ``positions`` as (ra, dec) degrees and map
        them through the mosaic header's TAN WCS.
    :returns: :class:`CutoutStack`.
    """
    from .fits import Header
    from .preprocess import _get_image
    from .wcs import MiniWCS

    hdr, img = _get_image(image)
    _, ivm_img = _get_image(ivm)
    if img.shape != ivm_img.shape:
        raise ValueError(
            f"image and ivm shapes disagree: {img.shape} vs "
            f"{ivm_img.shape}"
        )
    if np.ndim(img) != 2:
        raise ValueError(f"mosaic must be 2-D, got shape {img.shape}")
    ny, nx = img.shape

    if np.isscalar(size):
        size = (int(size), int(size))
    h, w = int(size[0]), int(size[1])
    if h < 1 or w < 1:
        raise ValueError(f"cutout size must be positive, got {(h, w)}")
    if h > ny or w > nx:
        raise ValueError(
            f"cutout size {(h, w)} exceeds the mosaic {img.shape}"
        )

    positions = np.atleast_2d(np.asarray(positions, np.float64))
    if positions.ndim != 2 or positions.shape[1] != 2:
        raise ValueError(
            f"positions must be (K, 2), got {positions.shape}"
        )
    if world:
        wcs = MiniWCS(hdr)
        fx, fy = wcs.sky_to_pixel(positions[:, 0], positions[:, 1])
        # MiniWCS speaks 1-based FITS pixels; the package xy
        # convention is 0-based
        positions = np.column_stack([fx - 1.0, fy - 1.0])
    if not np.all(np.isfinite(positions)):
        raise ValueError("positions contain non-finite values")

    k = positions.shape[0]
    obs = np.empty((k, h, w), np.float64)
    ivm_out = np.empty((k, h, w), np.float64)
    origins = np.empty((k, 2), np.int64)
    local = np.empty((k, 2), np.float64)
    headers = []
    for t in range(k):
        x, y = positions[t]
        # window centered on the target's pixel, clamped inside the
        # mosaic (shift, never shrink — static shapes)
        x0 = int(np.clip(int(np.round(x)) - w // 2, 0, nx - w))
        y0 = int(np.clip(int(np.round(y)) - h // 2, 0, ny - h))
        if not (-0.5 <= x < nx - 0.5 and -0.5 <= y < ny - 0.5):
            raise ValueError(
                f"target {t} at pixel ({x:.1f}, {y:.1f}) lies outside "
                f"the {img.shape} mosaic"
            )
        obs[t] = img[y0 : y0 + h, x0 : x0 + w]
        ivm_out[t] = ivm_img[y0 : y0 + h, x0 : x0 + w]
        origins[t] = (x0, y0)
        local[t] = (x - x0, y - y0)
        ch = hdr.copy() if hasattr(hdr, "copy") else Header()
        # cutout pixel X' = mosaic X - x0 (both 1-based), so the
        # reference pixel moves by exactly the origin
        if "CRPIX1" in ch or "CRVAL1" in ch:
            ch.set("CRPIX1", float(ch.get("CRPIX1", 1.0)) - x0)
            ch.set("CRPIX2", float(ch.get("CRPIX2", 1.0)) - y0)
        ch.set("NAXIS1", w)
        ch.set("NAXIS2", h)
        ch.set("CUTORIGX", x0, "cutout x origin in mosaic (0-based)")
        ch.set("CUTORIGY", y0, "cutout y origin in mosaic (0-based)")
        headers.append(ch)
    return CutoutStack(
        obs=obs, ivm=ivm_out, origins=origins, positions=local,
        headers=headers,
    )
