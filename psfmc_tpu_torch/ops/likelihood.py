"""Masked Gaussian log-likelihood (port of ``ops/likelihood.py``).

Over good pixels only: ``lnL = -1/2 sum(resid^2 ivm - log(ivm / 2 pi))``.
Bad pixels carry ``ivm == 0``; they are excluded by a ``where`` and the
``log`` is fed 1 there, so nothing non-finite leaks out of them.  A
non-finite total maps to ``-inf``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["gaussian_lnlike", "gaussian_lnlike_pointwise"]

_INV_2PI = 0.5 / math.pi


def gaussian_lnlike_pointwise(resid, ivm, good_px):
    """Per-pixel log-density map; bad pixels carry exactly 0."""
    safe_ivm = torch.where(good_px, ivm, torch.ones_like(ivm))
    term = resid * resid * ivm - torch.log(_INV_2PI * safe_ivm)
    return torch.where(good_px, -0.5 * term, torch.zeros_like(term))


def gaussian_lnlike(resid, ivm, good_px):
    """Masked Gaussian lnL over the trailing (H, W) axes; NaN -> -inf."""
    lnl = gaussian_lnlike_pointwise(resid, ivm, good_px).sum(dim=(-2, -1))
    return torch.where(
        torch.isfinite(lnl), lnl, torch.full_like(lnl, -math.inf)
    )
