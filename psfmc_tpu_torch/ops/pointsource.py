"""Point-source renderer (port of ``ops/pointsource.py``, dense form).

The shift kernels are separable, so a point source is the rank-1 image
``flux * ky(j - y) ⊗ kx(i - x)`` with the 1-D kernels evaluated over the
whole axis (zero outside their support).  This is the form the JAX
package's sampling path uses (``render_pointsource_dense``); it places
the same values as the windowed scatter on every in-bounds pixel.
"""
from __future__ import annotations

import math

import torch

from .coords import mag_to_flux

__all__ = ["sinc", "lanczos", "render_pointsource_dense", "SHIFT_METHODS"]

SHIFT_METHODS = ("bilinear", "lanczos3")


def sinc(x):
    """sin(pi x)/(pi x) with value 1 at 0."""
    px = math.pi * x
    safe = torch.where(px != 0, px, torch.ones_like(px))
    return torch.where(x != 0, torch.sin(px) / safe, torch.ones_like(x))


def lanczos(x, a):
    """1-D Lanczos kernel of half-width ``a``."""
    return torch.where(
        torch.abs(x) < a, sinc(x) * sinc(x / a), torch.zeros_like(x)
    )


def _kernel_1d(win_coords, center, method):
    d = win_coords - center
    if method == "bilinear":
        return torch.clamp(1.0 - torch.abs(d), min=0.0)
    if method == "lanczos3":
        return lanczos(d, 3.0)
    raise ValueError(f"Unknown shift method: {method}")


def render_pointsource_dense(shape, xy, mag, mag_zp, method="lanczos3"):
    """Point sources as rank-1 outer products.

    ``xy`` is ``(..., 2)`` in 0-based pixel coordinates, ``mag`` has the
    batch shape ``(...)``; the result is ``(..., H, W)``.
    """
    if method not in SHIFT_METHODS:
        raise ValueError(f"Unknown shift method: {method}")
    h, w = shape
    rows = torch.arange(h, dtype=mag.dtype, device=mag.device)
    cols = torch.arange(w, dtype=mag.dtype, device=mag.device)
    ky = _kernel_1d(rows, xy[..., 1:2], method)  # (..., H)
    kx = _kernel_1d(cols, xy[..., 0:1], method)  # (..., W)
    flux = mag_to_flux(mag, mag_zp)
    return (flux[..., None] * ky)[..., :, None] * kx[..., None, :]
