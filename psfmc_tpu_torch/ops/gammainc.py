"""Inverse regularized incomplete gamma at p = 1/2 (port of ``ops/gammainc.py``).

The Sersic constant ``kappa = gammaincinv(2n, 1/2)`` (Ciotti & Bertin
1999).  Two solvers, as in the JAX package:

* :func:`gammaincinv_half_table` — the default on the sampling path: an
  exact 4096-knot scipy table of ``log kappa`` over ``log a`` in
  [log 0.01, log 200], Catmull-Rom interpolated in torch;
* :func:`gammaincinv_half` — log-space Newton on ``P(a, e^t) = 1/2``
  from the Wilson-Hilferty / small-``a`` initializers.

The table differentiates as it is.  The Newton solve goes through
``torch.special.gammainc``, which has no derivative in its first
argument, so its gradient is the implicit one at the converged root,
``dx/da = -(dP/da) / (dP/dx)``, with ``dP/dx = x^(a-1) e^-x / Gamma(a)``
and ``dP/da`` in float64 from the series ``P = sum_k t_k``, ``t_k =
x^(a+k) e^-x / Gamma(a+k+1)``: ``dP/da = sum_k t_k (log x - psi(a+k+1))``
(a fixed number of terms, so it runs inside a captured graph).  The JAX
package differentiates its unrolled Newton iterations, which converge to
the same derivative.
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

__all__ = ["gammaincinv_half", "gammaincinv_half_table", "kappa_table"]

# Newton iterations, as the JAX package reads them (default 6: ~1e-12 in
# float64); read once, at import.
_NEWTON_ITERS = int(os.environ.get("PSFMC_NEWTON_ITERS", "6"))
_TABLE_SIZE = 4096
_TABLE_RANGE = (0.01, 200.0)


def gammaincinv_half(a, iters=_NEWTON_ITERS):
    """Solve ``gammainc(a, x) == 0.5`` for ``x`` (elementwise, any device);
    differentiable in ``a`` by the implicit derivative (see module doc)."""
    a = torch.as_tensor(a)
    if not a.is_floating_point():
        a = a.to(torch.get_default_dtype())
    if torch.is_grad_enabled() and a.requires_grad:
        return _NewtonKappa.apply(a, iters)
    return _newton(a, iters)


# terms of the dP/da series: enough for a up to 400 (index 200)
_SERIES_TERMS = 400


class _NewtonKappa(torch.autograd.Function):
    """The Newton root with its implicit derivative in ``a``."""

    @staticmethod
    def forward(ctx, a, iters):
        x = _newton(a, iters)
        ctx.save_for_backward(a, x)
        return x

    @staticmethod
    def backward(ctx, grad):
        a, x = ctx.saved_tensors
        a64, x64 = a.double(), x.double()
        dp_dx = torch.exp((a64 - 1.0) * torch.log(x64) - x64 - torch.lgamma(a64))
        ak = a64[..., None] + torch.arange(_SERIES_TERMS, dtype=torch.float64,
                                           device=a.device)
        log_x = torch.log(x64)[..., None]
        log_t = ak * log_x - x64[..., None] - torch.lgamma(ak + 1.0)
        dp_da = (torch.exp(log_t) * (log_x - torch.digamma(ak + 1.0))).sum(-1)
        return grad * (-dp_da / dp_dx).to(grad.dtype), None


def _newton(a, iters):
    a_safe = torch.clamp(a, min=1e-6)
    # Wilson-Hilferty median approximation (good for a >~ 0.6)
    wh = a_safe * (1.0 - 1.0 / (9.0 * a_safe)) ** 3
    # small-a series: P(a, x) ~ x^a / Gamma(a+1) => x0 = (Gamma(a+1)/2)^(1/a)
    small = torch.exp((torch.lgamma(a_safe + 1.0) + math.log(0.5)) / a_safe)
    x0 = torch.where(a_safe > 0.6, torch.clamp(wh, min=1e-30), small)
    lgam = torch.lgamma(a_safe)
    t = torch.log(x0)
    for _ in range(iters):
        x = torch.exp(t)
        f = torch.special.gammainc(a_safe, x) - 0.5
        # d/dt P(a, e^t) = exp(a t - e^t - lnGamma(a))
        log_fp = a_safe * t - x - lgam
        step = torch.clamp(f * torch.exp(-log_fp), -1.5, 1.5)
        t = t - step
    return torch.where(a > 0, torch.exp(t), torch.full_like(t, math.nan))


@functools.lru_cache(maxsize=1)
def kappa_table():
    """(log_a grid, log kappa grid) as float64 numpy, built once by scipy."""
    import scipy.special as sp

    log_a = np.linspace(
        np.log(_TABLE_RANGE[0]), np.log(_TABLE_RANGE[1]), _TABLE_SIZE
    )
    return log_a, np.log(sp.gammaincinv(np.exp(log_a), 0.5))


@functools.lru_cache(maxsize=8)
def _table_tensor(device, dtype):
    return torch.as_tensor(kappa_table()[1], dtype=dtype, device=device)


def gammaincinv_half_table(a):
    """``gammaincinv(a, 1/2)`` by log-log Catmull-Rom interpolation.

    Relative error < 1e-7 over the table interior (a in [0.02, 190]),
    ~1e-6 in the edge cells; out-of-range ``a`` clamps to the table
    edge.  The result keeps ``a``'s dtype and device.
    """
    log_a, _ = kappa_table()
    lo64, hi64 = float(log_a[0]), float(log_a[-1])
    g = _table_tensor(a.device, a.dtype)
    la = torch.clamp(torch.log(torch.clamp(a, min=1e-30)), lo64, hi64)
    step = (hi64 - lo64) / (_TABLE_SIZE - 1)
    pos = (la - lo64) / step
    i1 = torch.clamp(pos.to(torch.int64), 1, _TABLE_SIZE - 3)
    t = pos - i1.to(pos.dtype)
    p0, p1, p2, p3 = g[i1 - 1], g[i1], g[i1 + 1], g[i1 + 2]
    log_k = 0.5 * (
        (2.0 * p1)
        + (-p0 + p2) * t
        + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t * t
        + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t * t * t
    )
    return torch.exp(log_k)
