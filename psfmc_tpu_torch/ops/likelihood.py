"""Per-pixel log-likelihoods and predictive CDFs (port of ``ops/likelihood.py``).

Three families, each with one signature ``(resid, ivm, good_px,
model=None)`` over the trailing ``(H, W)`` axes:

* ``gaussian``: ``-1/2 sum(resid^2 ivm - log(ivm / 2 pi))`` over good
  pixels (the reference's likelihood);
* ``student``: Student-t with static ``df`` and scale ``1/sqrt(ivm)``;
* ``poisson``: ``k ln mu - mu - ln Gamma(k + 1)`` with ``mu = gain *
  model`` and ``k = gain * (model + resid)``; ``ivm`` only defines the
  mask upstream.

Bad pixels are excluded by a ``where``, and whatever a log reads there
is replaced by 1 first, so nothing non-finite leaks out of them.  Each
lnL is the sum of its pointwise map (the single-twin rule of the JAX
package), and the NaN guards are the JAX package's: the Gaussian and
Student-t totals map every non-finite value to ``-inf``, the Poisson
total only NaN (a good pixel whose expected counts are not positive is
``-inf`` already).

The predictive CDF twins ``P(y_rep <= y_obs)`` (0.5 at bad pixels) are
the per-draw ingredient of LOO-PIT; the Student-t one needs the
regularized incomplete beta, which torch lacks: :func:`betainc` is its
continued fraction with a fixed number of terms (no data-dependent
loop, so it runs inside a captured graph too).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import betaln, gammaln

__all__ = [
    "gaussian_lnlike",
    "student_t_lnlike",
    "poisson_lnlike",
    "make_lnlike",
    "gaussian_lnlike_pointwise",
    "student_t_lnlike_pointwise",
    "poisson_lnlike_pointwise",
    "make_lnlike_pointwise",
    "gaussian_cdf_pointwise",
    "student_t_cdf_pointwise",
    "poisson_cdf_pointwise",
    "make_cdf_pointwise",
    "betainc",
]

_INV_2PI = 0.5 / math.pi


def _ones_where_bad(x, good_px):
    return torch.where(good_px, x, torch.ones_like(x))


def _total(pointwise, guard):
    lnl = pointwise.sum(dim=(-2, -1))
    return torch.where(guard(lnl), torch.full_like(lnl, -math.inf), lnl)


def _not_finite(x):
    return ~torch.isfinite(x)


def gaussian_lnlike_pointwise(resid, ivm, good_px, model=None):
    """Per-pixel Gaussian log-density map; bad pixels carry exactly 0."""
    term = resid * resid * ivm - torch.log(_INV_2PI * _ones_where_bad(ivm, good_px))
    return torch.where(good_px, -0.5 * term, torch.zeros_like(term))


def gaussian_lnlike(resid, ivm, good_px, model=None):
    """Masked Gaussian lnL; non-finite -> ``-inf``."""
    return _total(gaussian_lnlike_pointwise(resid, ivm, good_px), _not_finite)


def _student_norm(df):
    return float(gammaln(0.5 * (df + 1.0)) - gammaln(0.5 * df)
                 - 0.5 * np.log(df * np.pi))


def student_t_lnlike_pointwise(resid, ivm, good_px, df, model=None):
    """Per-pixel Student-t log-density map (static ``df``)."""
    df = float(df)
    term = (_student_norm(df)
            + 0.5 * torch.log(_ones_where_bad(ivm, good_px))
            - (0.5 * (df + 1.0)) * torch.log(1.0 + resid * resid * ivm / df))
    return torch.where(good_px, term, torch.zeros_like(term))


def student_t_lnlike(resid, ivm, good_px, df, model=None):
    """Masked Student-t lnL; non-finite -> ``-inf``."""
    return _total(student_t_lnlike_pointwise(resid, ivm, good_px, df), _not_finite)


def poisson_lnlike_pointwise(resid, ivm, good_px, model, gain):
    """Per-pixel Poisson log-density map: ``-inf`` at a good pixel whose
    expected counts are not positive, 0 at bad pixels.  ``k`` is the
    continuous extension: ``ln Gamma(k + 1)`` of the scaled counts."""
    gain = float(gain)
    mu = gain * model
    k = gain * (model + resid)
    ok = mu > 0
    safe_mu = _ones_where_bad(mu, ok)
    safe_k = torch.where(good_px, k, torch.zeros_like(k))  # bad px may hold NaN
    term = safe_k * torch.log(safe_mu) - safe_mu - torch.lgamma(safe_k + 1.0)
    term = torch.where(ok, term, torch.full_like(term, -math.inf))
    return torch.where(good_px, term, torch.zeros_like(term))


def poisson_lnlike(resid, ivm, good_px, model, gain):
    """Masked Poisson lnL (Cash); NaN -> ``-inf``."""
    return _total(poisson_lnlike_pointwise(resid, ivm, good_px, model, gain),
                  torch.isnan)


def _check_df(df):
    if not np.isfinite(df) or df <= 0:
        raise ValueError(
            f"likelihood_df must be a positive finite number, got {df}")


def _check_gain(gain):
    if not np.isfinite(gain) or gain <= 0:
        raise ValueError(
            "likelihood_gain must be a positive finite number "
            f"(counts per observation unit), got {gain}")


def _family(kind, df, gain, gaussian, student, poisson):
    """The ``(resid, ivm, good_px, model=None)`` function of ``kind``."""
    if kind == "gaussian":
        return gaussian
    if kind == "student":
        _check_df(df)
        return lambda resid, ivm, good_px, model=None: student(
            resid, ivm, good_px, df)
    if kind == "poisson":
        _check_gain(gain)
        return lambda resid, ivm, good_px, model=None: poisson(
            resid, ivm, good_px, model, gain)
    raise ValueError(
        f"Unknown likelihood {kind!r}: expected 'gaussian', 'student' or "
        "'poisson'")


def make_lnlike(kind="gaussian", df=4.0, gain=1.0):
    """Likelihood factory: ``(resid, ivm, good_px, model=None) -> (...)``
    lnL over the trailing image axes."""
    return _family(kind, df, gain, gaussian_lnlike, student_t_lnlike,
                   poisson_lnlike)


def make_lnlike_pointwise(kind="gaussian", df=4.0, gain=1.0):
    """Pointwise twin of :func:`make_lnlike`: the ``(..., H, W)`` map."""
    return _family(kind, df, gain, gaussian_lnlike_pointwise,
                   student_t_lnlike_pointwise, poisson_lnlike_pointwise)


def gaussian_cdf_pointwise(resid, ivm, good_px, model=None):
    """``Phi(resid sqrt(ivm))`` per pixel; 0.5 at bad pixels."""
    z = resid * torch.sqrt(_ones_where_bad(ivm, good_px))
    return torch.where(good_px, torch.special.ndtr(z), torch.full_like(z, 0.5))


def betainc(a, b, x, y=None, terms=200):
    """Regularized incomplete beta ``I_x(a, b)`` for float ``a, b > 0``
    and a tensor ``x`` in [0, 1] (``y = 1 - x``, given where it is known
    more accurately than ``1 - x``).

    Lentz's continued fraction on whichever of ``I_x(a, b)`` and ``1 -
    I_y(b, a)`` converges faster, with ``terms`` terms for every element
    (200 reach the double-precision limit for ``max(a, b)`` up to about
    1e4)."""
    if y is None:
        y = 1.0 - x
    flip = x > (a + 1.0) / (a + b + 2.0)
    xs = torch.where(flip, y, x)
    ys = torch.where(flip, x, y)
    tiny = torch.finfo(x.dtype).tiny * 1e3

    def cf(p, q, u):
        def guard(d):
            return torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)

        c = torch.ones_like(u)
        d = 1.0 / guard(1.0 - (p + q) * u / (p + 1.0))
        h = d
        for m in range(1, terms + 1):
            m2 = 2 * m
            for aa in (m * (q - m) * u / ((p - 1.0 + m2) * (p + m2)),
                       -(p + m) * (p + q + m) * u / ((p + m2) * (p + 1.0 + m2))):
                d = 1.0 / guard(1.0 + aa * d)
                c = guard(1.0 + aa / c)
                h = h * d * c
        return h

    def front(p, q, u, v):
        return torch.exp(p * torch.log(u) + q * torch.log(v)
                         - float(betaln(p, q))) / p

    direct = front(a, b, xs, ys) * cf(a, b, xs)
    mirrored = 1.0 - front(b, a, xs, ys) * cf(b, a, xs)
    out = torch.where(flip, mirrored, direct)
    out = torch.where(x <= 0, torch.zeros_like(out), out)
    return torch.where(x >= 1, torch.ones_like(out), out)


def student_t_cdf_pointwise(resid, ivm, good_px, df, model=None):
    """Student-t twin of :func:`gaussian_cdf_pointwise`: ``F(t) = 1 -
    I_{df/(df+t^2)}(df/2, 1/2) / 2`` for ``t >= 0``, ``F(-t) = 1 -
    F(t)``."""
    df = float(df)
    t = resid * torch.sqrt(_ones_where_bad(ivm, good_px))
    t2 = t * t
    upper = 0.5 * betainc(0.5 * df, 0.5, df / (df + t2), t2 / (df + t2))
    cdf = torch.where(t >= 0, 1.0 - upper, upper)
    return torch.where(good_px, cdf, torch.full_like(cdf, 0.5))


def poisson_cdf_pointwise(resid, ivm, good_px, model, gain):
    """Poisson twin: ``P(Y <= k) = Q(floor(k) + 1, mu)``; 0.5 at bad
    pixels and where ``mu`` is not positive."""
    gain = float(gain)
    mu = gain * model
    k = gain * (model + resid)
    ok = good_px & (mu > 0)
    n = torch.floor(torch.clamp(torch.where(good_px, k, torch.zeros_like(k)),
                                min=0.0))
    cdf = torch.special.gammaincc(n + 1.0, _ones_where_bad(mu, ok))
    return torch.where(ok, cdf, torch.full_like(cdf, 0.5))


def make_cdf_pointwise(kind="gaussian", df=4.0, gain=1.0):
    """Predictive-CDF factory matching :func:`make_lnlike`."""
    return _family(kind, df, gain, gaussian_cdf_pointwise,
                   student_t_cdf_pointwise, poisson_cdf_pointwise)
