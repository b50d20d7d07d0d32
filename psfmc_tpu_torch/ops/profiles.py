"""King, Ferrer, Nuker and edge-on disk profiles (port of ``ops/profiles.py``).

Radial laws of the JAX package, with ``t`` the generalized radius in
scale-radius units:

* generalized King: ``g(t) = [(1+t^2)^(-1/alpha) - (1+x^2)^(-1/alpha)]^alpha``
  for ``t <= x = rt/rc``, else 0;
* modified Ferrer: ``g(t) = (1 - t^(2-beta))^alpha`` for ``t < 1``;
* Nuker: ``g(t) = 2^((beta-gamma)/alpha) t^(-gamma) [1 + t^alpha]^((gamma-beta)/alpha)``;
* edge-on disk: ``I(R, z) = I0 (|R|/rs) K1(|R|/rs) sech^2(z/hs)``, with
  ``x K1(x)`` from the JAX package's own rational approximations
  (:func:`xk1`, Abramowitz & Stegun 9.8.7/9.8.8), so both packages
  compute the same function.

Flux normalization, exactly ``mag`` for every shape: ``I0 = F / (a b A
R)`` with ``A`` the isophote area factor (:mod:`.isophote`) and ``R =
Int g(t) 2t dt``: a Beta function for Ferrer, and device tanh-sinh
quadrature for King and Nuker, whose fixed nodes and weights are made
once per (device, dtype) (:func:`tanh_sinh_tables`).  The Nuker integral
is split at the break and each piece substituted onto ``(0, 1)`` with
its endpoint power removed.

Parameters share a batch shape ``(...)`` that broadcasts against the
pixel grids; the quadratures run on a trailing node axis.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .coords import mag_to_flux
from .isophote import generalized_log_sq_radius, isophote_area_factor

__all__ = [
    "king_radial_factor",
    "king_radial_factor_alpha2",
    "ferrer_radial_factor",
    "nuker_radial_factor",
    "render_king",
    "render_king_gen",
    "render_ferrer",
    "render_ferrer_gen",
    "render_nuker",
    "render_nuker_gen",
    "render_edgedisk",
    "tanh_sinh_tables",
    "xk1",
]

_TINY = 1e-30
_LN2 = math.log(2.0)


def _tanh_sinh_01(n=60, h=0.05):
    """Tanh-sinh nodes, their logs and weights on (0, 1), host float64;
    ``j h`` capped at 3 keeps ``log(s)`` above about -32."""
    j = np.arange(-n, n + 1) * h
    u = 0.5 * np.pi * np.sinh(j)
    x = np.tanh(u)
    w = h * 0.5 * np.pi * np.cosh(j) / np.cosh(u) ** 2
    s = 0.5 * (x + 1.0)
    return s, np.log(s), 0.5 * w


_TS_S, _TS_LOG_S, _TS_W = _tanh_sinh_01()


@functools.lru_cache(maxsize=8)
def tanh_sinh_tables(device, dtype):
    """``(s, log s, w)`` of :func:`_tanh_sinh_01` on ``(device, dtype)``,
    made once."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (_TS_S, _TS_LOG_S, _TS_W))


def king_radial_factor(sq_xt, alpha):
    """``R = Int_0^x [(1+t^2)^(-1/a) - q]^a 2t dt`` (``t`` in ``rc`` units,
    ``sq_xt = (rt/rc)^2``, ``q`` the truncation pedestal), by tanh-sinh
    over ``t = x s``."""
    s, _, w = tanh_sinh_tables(sq_xt.device, sq_xt.dtype)
    inv_a = 1.0 / alpha
    q = torch.exp(-inv_a * torch.log1p(sq_xt))
    sq_t = sq_xt[..., None] * s * s
    outer = torch.exp(-inv_a[..., None] * torch.log1p(sq_t))
    bracket = torch.clamp(outer - q[..., None], min=_TINY)
    g = torch.exp(alpha[..., None] * torch.log(bracket))
    return sq_xt * torch.sum(w * g * 2.0 * s, dim=-1)


def king_radial_factor_alpha2(sq_xt):
    """Closed form at ``alpha = 2`` (King 1962): ``ln(1+x^2) - 4 (1 - q) +
    x^2/(1+x^2)``, ``q = (1+x^2)^(-1/2)``."""
    opx = 1.0 + sq_xt
    q = 1.0 / torch.sqrt(opx)
    return torch.log(opx) - 4.0 * (1.0 - q) + sq_xt / opx


def ferrer_radial_factor(alpha, beta):
    """``R = Int_0^1 (1 - t^(2-beta))^alpha 2t dt = (2/p) B(2/p, alpha+1)``,
    ``p = 2 - beta``."""
    p = 2.0 - beta
    a = 2.0 / p
    b = alpha + 1.0
    return a * torch.exp(torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))


def _nuker_piece(c, d):
    """``Int_0^1 (1 + s^c)^d ds`` by tanh-sinh (``c > 0``, ``d < 0``)."""
    _, log_s, w = tanh_sinh_tables(c.device, c.dtype)
    z = c[..., None] * log_s
    log1p_sc = torch.log1p(torch.exp(z))
    return torch.sum(w * torch.exp(d[..., None] * log1p_sc), dim=-1)


def nuker_radial_factor(alpha, beta, gamma):
    """``R = Int_0^inf g(t) 2t dt`` of the Nuker law (``gamma < 2 < beta``)."""
    d = (gamma - beta) / alpha
    pref = torch.exp((beta - gamma) / alpha * _LN2)
    inner = (2.0 / (2.0 - gamma)) * _nuker_piece(alpha / (2.0 - gamma), d)
    outer = (2.0 / (beta - 2.0)) * _nuker_piece(alpha / (beta - 2.0), d)
    return pref * (inner + outer)


def _scale_matrix(xy, a, b, angle, angle_degrees):
    """(x, y, m00, m01, m10, m11): the inverse scale+rotation folded into
    four scalars (the Sersic convention, +90 degree position angle)."""
    ang = torch.deg2rad(angle) if angle_degrees else angle
    ang = ang + 0.5 * math.pi
    sin_a, cos_a = torch.sin(ang), torch.cos(ang)
    return (xy[..., 0], xy[..., 1], cos_a / a, sin_a / a, -sin_a / b, cos_a / b)


def _log_sq_radius(xg, yg, x, y, m00, m01, m10, m11):
    dx = xg - x
    dy = yg - y
    u = m00 * dx + m01 * dy
    v = m10 * dx + m11 * dy
    return torch.log(torch.clamp(u * u + v * v, min=_TINY))


def _gen_log_sq_radius(xg, yg, x, y, m00, m01, m10, m11, c, fourier,
                       angle_degrees, bending, rotation, rot_axes):
    dx = xg - x
    dy = yg - y
    u = m00 * dx + m01 * dy
    v = m10 * dx + m11 * dy
    if rotation is not None:
        # radii in pixels: the swirl acts in the unscaled frame
        rot_ang, rot_out, rot_in, rot_pow = rotation
        rot_ang = torch.deg2rad(rot_ang) if angle_degrees else rot_ang
        rotation = (rot_ang, rot_out, rot_in, rot_pow) + tuple(rot_axes)
    return generalized_log_sq_radius(u, v, c, fourier, angle_degrees, bending,
                                     rotation)


def _area_factor(c0, fourier, angle_degrees):
    return isophote_area_factor(c0 + 2.0, fourier, angle_degrees)


# ---------------------------------------------------------------- King

def _king_sb(log_sq_t, i0, alpha, q, sq_xt):
    sq_t = torch.exp(log_sq_t)
    outer = torch.exp(-(1.0 / alpha) * torch.log(1.0 + sq_t))
    bracket = torch.clamp(outer - q, min=_TINY)
    val = i0 * torch.exp(alpha * torch.log(bracket))
    return torch.where(sq_t <= sq_xt, val, torch.zeros_like(val))


def _king_params(xy, mag, rc, rc_b, rt, alpha, angle, mag_zp, angle_degrees,
                 area):
    x, y, m00, m01, m10, m11 = _scale_matrix(xy, rc, rc_b, angle, angle_degrees)
    sq_xt = rt / rc
    sq_xt = sq_xt * sq_xt
    q = torch.exp(-(1.0 / alpha) * torch.log1p(sq_xt))
    flux = mag_to_flux(mag, mag_zp)
    i0 = flux / (rc * rc_b * area * king_radial_factor(sq_xt, alpha))
    return x, y, m00, m01, m10, m11, i0, q, sq_xt


def render_king(xg, yg, xy, mag, rc, rc_b, rt, alpha, angle, mag_zp,
                angle_degrees=False):
    """One generalized-King profile over the grid."""
    x, y, m00, m01, m10, m11, i0, q, sq_xt = _king_params(
        xy, mag, rc, rc_b, rt, alpha, angle, mag_zp, angle_degrees, math.pi)
    lsr = _log_sq_radius(xg, yg, x, y, m00, m01, m10, m11)
    return _king_sb(lsr, i0, alpha, q, sq_xt)


def render_king_gen(xg, yg, xy, mag, rc, rc_b, rt, alpha, angle, c0, mag_zp,
                    angle_degrees=False, fourier=(), bending=(), rotation=None):
    """King over generalized isophotes (:mod:`.isophote`)."""
    area = _area_factor(c0, fourier, angle_degrees)
    x, y, m00, m01, m10, m11, i0, q, sq_xt = _king_params(
        xy, mag, rc, rc_b, rt, alpha, angle, mag_zp, angle_degrees, area)
    lsr = _gen_log_sq_radius(xg, yg, x, y, m00, m01, m10, m11, c0 + 2.0,
                             fourier, angle_degrees, bending, rotation, (rc, rc_b))
    return _king_sb(lsr, i0, alpha, q, sq_xt)


# -------------------------------------------------------------- Ferrer

def _ferrer_sb(log_sq_t, i0, alpha, p):
    tp = torch.exp(0.5 * p * log_sq_t)
    base = torch.clamp(1.0 - tp, min=_TINY)
    val = i0 * torch.exp(alpha * torch.log(base))
    return torch.where(tp < 1.0, val, torch.zeros_like(val))


def _ferrer_params(xy, mag, rout, rout_b, alpha, beta, angle, mag_zp,
                   angle_degrees, area):
    x, y, m00, m01, m10, m11 = _scale_matrix(xy, rout, rout_b, angle,
                                             angle_degrees)
    flux = mag_to_flux(mag, mag_zp)
    i0 = flux / (rout * rout_b * area * ferrer_radial_factor(alpha, beta))
    return x, y, m00, m01, m10, m11, i0, 2.0 - beta


def render_ferrer(xg, yg, xy, mag, rout, rout_b, alpha, beta, angle, mag_zp,
                  angle_degrees=False):
    """One modified-Ferrer profile over the grid."""
    x, y, m00, m01, m10, m11, i0, p = _ferrer_params(
        xy, mag, rout, rout_b, alpha, beta, angle, mag_zp, angle_degrees,
        math.pi)
    lsr = _log_sq_radius(xg, yg, x, y, m00, m01, m10, m11)
    return _ferrer_sb(lsr, i0, alpha, p)


def render_ferrer_gen(xg, yg, xy, mag, rout, rout_b, alpha, beta, angle, c0,
                      mag_zp, angle_degrees=False, fourier=(), bending=(),
                      rotation=None):
    """Ferrer over generalized isophotes."""
    area = _area_factor(c0, fourier, angle_degrees)
    x, y, m00, m01, m10, m11, i0, p = _ferrer_params(
        xy, mag, rout, rout_b, alpha, beta, angle, mag_zp, angle_degrees, area)
    lsr = _gen_log_sq_radius(xg, yg, x, y, m00, m01, m10, m11, c0 + 2.0,
                             fourier, angle_degrees, bending, rotation,
                             (rout, rout_b))
    return _ferrer_sb(lsr, i0, alpha, p)


# --------------------------------------------------------------- Nuker

def _nuker_sb(log_sq_t, i0, alpha, beta, gamma):
    lt = 0.5 * log_sq_t
    z = alpha * lt
    # softplus form of log(1 + t^alpha): exact in both tails
    log1p_ta = torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))
    lg = (((beta - gamma) / alpha) * _LN2 - gamma * lt
          + ((gamma - beta) / alpha) * log1p_ta)
    return i0 * torch.exp(lg)


def _nuker_params(xy, mag, rb, rb_b, alpha, beta, gamma, angle, mag_zp,
                  angle_degrees, area):
    x, y, m00, m01, m10, m11 = _scale_matrix(xy, rb, rb_b, angle, angle_degrees)
    flux = mag_to_flux(mag, mag_zp)
    i0 = flux / (rb * rb_b * area * nuker_radial_factor(alpha, beta, gamma))
    return x, y, m00, m01, m10, m11, i0


def _nuker_log_floor(m00, m10, min_px_sq):
    """Cusp floor: the sampled square radius saturates at ``min_px_sq``
    pixels squared along the semi-major axis (``m00^2 + m10^2 =
    1/rb^2``); 0.125 is the half-pixel corner distance, and the
    oversampler passes ``0.125 / S^2`` for its closer midpoints."""
    return torch.log(min_px_sq * (m00 * m00 + m10 * m10))


def render_nuker(xg, yg, xy, mag, rb, rb_b, alpha, beta, gamma, angle, mag_zp,
                 angle_degrees=False, min_px_sq=0.125):
    """One Nuker profile over the grid, its cusp floored
    (:func:`_nuker_log_floor`)."""
    x, y, m00, m01, m10, m11, i0 = _nuker_params(
        xy, mag, rb, rb_b, alpha, beta, gamma, angle, mag_zp, angle_degrees,
        math.pi)
    lsr = _log_sq_radius(xg, yg, x, y, m00, m01, m10, m11)
    lsr = torch.maximum(lsr, _nuker_log_floor(m00, m10, min_px_sq))
    return _nuker_sb(lsr, i0, alpha, beta, gamma)


def render_nuker_gen(xg, yg, xy, mag, rb, rb_b, alpha, beta, gamma, angle, c0,
                     mag_zp, angle_degrees=False, fourier=(), bending=(),
                     rotation=None, min_px_sq=0.125):
    """Nuker over generalized isophotes."""
    area = _area_factor(c0, fourier, angle_degrees)
    x, y, m00, m01, m10, m11, i0 = _nuker_params(
        xy, mag, rb, rb_b, alpha, beta, gamma, angle, mag_zp, angle_degrees,
        area)
    lsr = _gen_log_sq_radius(xg, yg, x, y, m00, m01, m10, m11, c0 + 2.0,
                             fourier, angle_degrees, bending, rotation, (rb, rb_b))
    lsr = torch.maximum(lsr, _nuker_log_floor(m00, m10, min_px_sq))
    return _nuker_sb(lsr, i0, alpha, beta, gamma)


# ----------------------------------------------------------- EdgeDisk

def xk1(x):
    """``x K1(x)``, the JAX package's branchless pair of rational
    approximations (Abramowitz & Stegun 9.8.7 for ``x <= 2``, 9.8.8
    above), each on a clamped argument so both are finite; 1 at ``x ->
    0``."""
    xs = torch.clamp(x, 1e-15, 2.0)
    t = xs / 3.75
    t = t * t
    i1_over_x = (
        0.5
        + t * (0.87890594
               + t * (0.51498869
                      + t * (0.15084934
                             + t * (0.02658733
                                    + t * (0.00301532
                                           + t * 0.00032411)))))
    )
    u = 0.25 * xs * xs
    poly = (
        1.0
        + u * (0.15443144
               + u * (-0.67278579
                      + u * (-0.18156897
                             + u * (-0.01919402
                                    + u * (-0.00110404
                                           + u * -0.00004686)))))
    )
    small = xs * xs * (torch.log(xs) - _LN2) * i1_over_x + poly
    xl = torch.clamp(x, min=2.0)
    y = 2.0 / xl
    q = (
        1.25331414
        + y * (0.23498619
               + y * (-0.03655620
                      + y * (0.01504268
                             + y * (-0.00780353
                                    + y * (0.00325614
                                           + y * -0.00068245)))))
    )
    large = torch.sqrt(xl) * torch.exp(-xl) * q
    return torch.where(x <= 2.0, small, large)


def render_edgedisk(xg, yg, xy, mag, rs, hs, angle, mag_zp, angle_degrees=False):
    """One edge-on disk over the grid: ``R`` along the ``angle`` major
    axis in ``rs`` units, ``z`` across it in ``hs`` units, ``I0 = F / (2
    pi rs hs)`` exactly."""
    x, y, m00, m01, m10, m11 = _scale_matrix(xy, rs, hs, angle, angle_degrees)
    dx = xg - x
    dy = yg - y
    r = torch.abs(m00 * dx + m01 * dy)
    z = torch.abs(m10 * dx + m11 * dy)
    flux = mag_to_flux(mag, mag_zp)
    i0 = flux / (2.0 * math.pi * rs * hs)
    s = torch.exp(-2.0 * z)
    sech2 = 4.0 * s / ((1.0 + s) * (1.0 + s))
    return i0 * xk1(r) * sech2
