"""Coordinate grids and photometric conversions (port of ``ops/coords.py``).

Images are ``(H, W)`` with ``x`` along the columns: ``xg[j, i] == i`` and
``yg[j, i] == j``, the same pixel-center convention as the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["array_coords", "coord_grids", "mag_to_flux"]

_LN10 = math.log(10.0)


def array_coords(shape):
    """(H*W, 2) array of (x, y) pixel-center coordinates, row-major.

    The reference's flat coordinate list (index ``i`` maps to ``(i % W,
    i // W)``), kept for API compatibility; host float64 numpy, as in the
    JAX package.
    """
    h, w = shape
    idx = np.arange(h * w)
    return np.stack([idx % w, idx // w], axis=1).astype(np.float64)


def coord_grids(shape, dtype=torch.float32, device="cpu"):
    """(xg, yg) pixel-center coordinate grids of ``shape``."""
    h, w = shape
    yg = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xg = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return xg, yg


def mag_to_flux(mag, mag_zp):
    """Total flux ``10 ** (-0.4 * (mag - mag_zp))``.

    Host numbers and numpy arrays take numpy's power; tensors take
    ``exp(ln10 * arg)`` in their own dtype and device.
    """
    arg = -0.4 * (mag - mag_zp)
    if isinstance(arg, torch.Tensor):
        return torch.exp(_LN10 * arg)
    return 10.0**arg
