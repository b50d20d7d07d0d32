"""Radial truncation envelopes (port of ``ops/truncation.py``).

GALFIT-style truncation of the Sersic and Moffat families, as in the
JAX package:

* **outer** ``(rtrunc, rsoft)``: the profile times ``sigmoid((rtrunc -
  r) / rsoft)``, ``r`` the generalized isophote radius in pixels along
  the semi-major axis (50% at ``rtrunc``);
* **inner** ``(rtrunc_in, rsoft_in)``: times ``sigmoid((r - rtrunc_in) /
  rsoft_in)`` (rings).

``mag`` stays the exact total magnitude: the truncated radial flux
integral is computed on the device by fixed-node tanh-sinh quadrature
(the nodes of :mod:`.profiles`, mapped linearly onto ``[0, xmax]`` with
a traced ``xmax``), and the central surface brightness is rescaled by
``R_closed / R_truncated``.  For an inner-only truncation the quadrature
computes the compactly supported deficit ``f (1 - T_in)`` instead.

Parameters share a batch shape ``(...)``; the quadrature runs on a
trailing node axis.
"""
from __future__ import annotations

import torch

from .profiles import tanh_sinh_tables

__all__ = [
    "truncation_envelope",
    "sersic_trunc_ratio",
    "moffat_trunc_ratio",
    "TRUNC_TAIL",
]

# envelope reach beyond the break radius: sigmoid(-12) ~ 6e-6
TRUNC_TAIL = 12.0


def truncation_envelope(r_px, outer, inner):
    """Multiplicative envelope over radius in pixels; ``outer``/``inner``
    are ``(break_px, soft_px)`` pairs or None (static structure)."""
    env = None
    if outer is not None:
        ro, so = outer
        env = torch.sigmoid((ro - r_px) / so)
    if inner is not None:
        ri, si = inner
        t = torch.sigmoid((r_px - ri) / si)
        env = t if env is None else env * t
    return env


def _nodes(pair):
    """A ``(break, soft)`` pair of ``(...)`` tensors on the node axis."""
    return None if pair is None else tuple(t[..., None] for t in pair)


def _quad_0_to(xmax, integrand):
    """Tanh-sinh integral of ``integrand`` over ``(0, xmax)``, ``xmax``
    of shape ``(...)``; ``integrand`` sees ``(..., N)`` abscissae."""
    s, _, w = tanh_sinh_tables(xmax.device, xmax.dtype)
    return xmax * torch.sum(w * integrand(xmax[..., None] * s), dim=-1)


def _trunc_xupper(outer, inner):
    """Upper integration limit in pixels: where the integrand dies (the
    outer envelope's tail, or the inner deficit's)."""
    if outer is not None:
        ro, so = outer
        return ro + TRUNC_TAIL * so
    ri, si = inner
    return ri + TRUNC_TAIL * si


def _ratio(r_closed, f_times, outer, inner):
    outer_n, inner_n = _nodes(outer), _nodes(inner)
    if outer is not None:
        # one quadrature covers both (T_in is smooth inside the support)
        r_trunc = f_times(lambda r: truncation_envelope(r, outer_n, inner_n),
                          _trunc_xupper(outer, inner))
    else:
        deficit = f_times(lambda r: 1.0 - truncation_envelope(r, None, inner_n),
                          _trunc_xupper(None, inner))
        r_trunc = r_closed - deficit
    return r_closed / torch.clamp(r_trunc, min=1e-30)


def sersic_trunc_ratio(kappa, index, reff, outer, inner):
    """``R_closed / R_truncated`` of the Sersic radial flux integral, in
    the substitution ``x = t^(1/n)``: ``R_closed = 2n e^kappa
    kappa^(-2n) Gamma(2n)``."""
    n = index
    two_n = 2.0 * n
    r_closed = torch.exp(torch.log(two_n) + kappa - two_n * torch.log(kappa)
                         + torch.lgamma(two_n))
    kappa_n, n_n, two_n_n, reff_n = (t[..., None] for t in (kappa, n, two_n, reff))

    def f_times(env_fn, r_upper_px):
        xmax = torch.exp(torch.log(r_upper_px / reff) / n)

        def integrand(x):
            xs = torch.clamp(x, min=1e-30)
            log_fx = (-kappa_n * (xs - 1.0) + (two_n_n - 1.0) * torch.log(xs)
                      + torch.log(two_n_n))
            r_px = torch.exp(n_n * torch.log(xs)) * reff_n
            return torch.exp(log_fx) * env_fn(r_px)

        return _quad_0_to(xmax, integrand)

    return _ratio(r_closed, f_times, outer, inner)


def moffat_trunc_ratio(beta, alpha_a, outer, inner):
    """``R_closed / R_truncated`` of the Moffat radial flux integral, in
    ``u = t^2``: ``R_closed = 1 / (beta - 1)``."""
    r_closed = 1.0 / (beta - 1.0)
    beta_n, alpha_n = beta[..., None], alpha_a[..., None]

    def f_times(env_fn, r_upper_px):
        umax = r_upper_px / alpha_a
        umax = umax * umax

        def integrand(u):
            return torch.exp(-beta_n * torch.log1p(u)) * env_fn(
                torch.sqrt(torch.clamp(u, min=0.0)) * alpha_n)

        return _quad_0_to(umax, integrand)

    return _ratio(r_closed, f_times, outer, inner)

