"""Point-source renderer (port of ``ops/pointsource.py``).

The shift kernels are separable, so a point source is the rank-1 image
``flux * ky(j - y) ⊗ kx(i - x)`` with the 1-D kernels evaluated over the
whole axis (zero outside their support).  This is the form the JAX
package's sampling path uses (``render_pointsource_dense``); it places
the same values as the windowed scatter on every in-bounds pixel.

:func:`add_pointsource` / :func:`render_pointsource` keep the windowed
scatter of the reference (a ``window_size(method)`` square placed from
the clipped position, weights from the true one), for API parity.
"""
from __future__ import annotations

import math

import torch

from .coords import mag_to_flux

__all__ = ["sinc", "lanczos", "pointsource_factors", "pointsource_image",
           "render_pointsource", "add_pointsource", "window_size",
           "render_pointsource_dense", "SHIFT_METHODS"]

SHIFT_METHODS = ("bilinear", "lanczos3")
_RADII = {"bilinear": 0.5, "lanczos3": 3.0}
_WINDOW = {"bilinear": 2, "lanczos3": 7}


def window_size(method):
    """Side of the square window a point source is scattered into."""
    return _WINDOW[method]


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


def add_pointsource(img, xy, mag, mag_zp, method="lanczos3"):
    """A copy of the ``(H, W)`` image ``img`` with one point source added.

    ``xy`` is (x, y) in 0-based pixel coordinates.  The window is placed
    from the position clipped so the kernel fits (the reference's
    ``minimal_slice``) and its start clamped into the image; the weights
    are evaluated at the true position.  Runs on ``img``'s device in its
    dtype.
    """
    if method not in _RADII:
        raise ValueError(f"Unknown shift method: {method}")
    r = _RADII[method]
    w = _WINDOW[method]
    h, ww = img.shape
    dtype, device = img.dtype, img.device
    xy = torch.as_tensor(xy, dtype=dtype, device=device)
    x, y = xy[0], xy[1]
    cy = torch.clamp(y, r - 0.5, h - (r + 0.5))
    cx = torch.clamp(x, r - 0.5, ww - (r + 0.5))
    y0 = int(torch.clamp(torch.round(cy - r).to(torch.int64), 0, h - w))
    x0 = int(torch.clamp(torch.round(cx - r).to(torch.int64), 0, ww - w))
    offs = torch.arange(w, dtype=dtype, device=device)
    ky = _kernel_1d(y0 + offs, y, method)
    kx = _kernel_1d(x0 + offs, x, method)
    mag = torch.as_tensor(mag, dtype=dtype, device=device)
    flux = mag_to_flux(mag, torch.as_tensor(mag_zp, dtype=dtype, device=device))
    out = img.clone()
    out[y0:y0 + w, x0:x0 + w] += flux * ky[:, None] * kx[None, :]
    return out


def render_pointsource(shape, xy, mag, mag_zp, method="lanczos3",
                       dtype=torch.float32, device=None):
    """One point source on a zero background (:func:`add_pointsource`), on
    ``device`` (``xy``'s when it is a tensor, else the CPU)."""
    if device is None:
        device = xy.device if isinstance(xy, torch.Tensor) else "cpu"
    return add_pointsource(torch.zeros(shape, dtype=dtype, device=device), xy,
                           mag, mag_zp, method)


def pointsource_factors(shape, xy, mag, mag_zp, method="lanczos3"):
    """The rank-1 factors ``(fky, kx)`` of point sources: ``fky = flux *
    ky(j - y)`` ``(..., H)`` and ``kx(i - x)`` ``(..., W)``.  The fused
    likelihood kernel takes them as they are; :func:`render_pointsource_dense`
    forms their outer product."""
    if method not in SHIFT_METHODS:
        raise ValueError(f"Unknown shift method: {method}")
    h, w = shape
    rows = torch.arange(h, dtype=mag.dtype, device=mag.device)
    cols = torch.arange(w, dtype=mag.dtype, device=mag.device)
    ky = _kernel_1d(rows, xy[..., 1:2], method)  # (..., H)
    kx = _kernel_1d(cols, xy[..., 0:1], method)  # (..., W)
    flux = mag_to_flux(mag, mag_zp)
    return flux[..., None] * ky, kx


def pointsource_image(fky, kx):
    """The sum over point sources of ``fky_p ⊗ kx_p``: ``(..., P, H)``,
    ``(..., P, W)`` -> ``(..., H, W)`` (zeros for ``P = 0``)."""
    return (fky[..., :, :, None] * kx[..., :, None, :]).sum(dim=-3)


def render_pointsource_dense(shape, xy, mag, mag_zp, method="lanczos3"):
    """Point sources as rank-1 outer products.

    ``xy`` is ``(..., 2)`` in 0-based pixel coordinates, ``mag`` has the
    batch shape ``(...)``; the result is ``(..., H, W)``.
    """
    fky, kx = pointsource_factors(shape, xy, mag, mag_zp, method)
    return fky[..., :, None] * kx[..., None, :]
