"""Generalized isophotes shared by the radial profiles (port of ``ops/isophote.py``).

GALFIT-style shape freedom beyond the reference's ellipses, as in the
JAX package:

* **boxiness** ``c0``: the isophote radius is ``r^c = |u|^c + |v|^c``,
  ``c = c0 + 2``, in the scaled and rotated frame (``c0 > 0`` boxy,
  ``c0 < 0`` disky, ``c0 = 0`` the ellipse);
* **azimuthal Fourier modes**: the isophote at generalized radius ``t``
  bends to ``t (1 + sum_m a_m cos(m theta - phi_m))``, ``theta`` the
  azimuth in the scaled frame from the major axis;
* **bending modes** ``b1..b3``: the scaled minor-axis coordinate is
  sheared, ``v -> v + sum_m b_m u^m`` (unit Jacobian: flux unchanged);
* **spiral rotation**: the unscaled component frame is swirled by
  ``rot_ang * clip((r - rot_in) / (rot_out - rot_in), 0)^rot_pow``
  (unit polar Jacobian: flux unchanged).

The profiles need the per-pixel ``log(r^2)`` field and the isophote
**area factor** that replaces ``pi`` in their closed-form flux
normalizations, so ``mag`` stays the exact total magnitude for any shape.
Powers are max-factored in log space (no overflow for any physical
``c``); the perturbation factor is floored at :data:`FOURIER_FLOOR`.

Every function is batched by broadcasting: shape parameters of shape
``(...)`` against pixel offsets that broadcast with them.  The
quadrature's host-made nodes live on the device once per (device,
dtype) (:func:`quadrature_tables`); the posterior makes them when it is
built, so no step of a captured CUDA graph copies from the host.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "superellipse_area_factor",
    "superellipse_area_factor_host",
    "isophote_area_factor",
    "generalized_log_sq_radius",
    "quadrature_tables",
    "FOURIER_FLOOR",
]

_TINY = 1e-30
_LOG_TINY = math.log(_TINY)
_QUAD_NODES = 512
FOURIER_FLOOR = 0.05


def superellipse_area_factor_host(c):
    """Host (numpy/scipy) twin of :func:`superellipse_area_factor`, for
    consumers that mirror the renderer's flux normalization off the
    device."""
    from scipy.special import gammaln

    c = np.asarray(c, float)
    return np.exp(np.log(4.0) + 2.0 * gammaln(1 + 1 / c) - gammaln(1 + 2 / c))


def superellipse_area_factor(c):
    """Area of the unit superellipse ``|u|^c + |v|^c <= 1``:
    ``4 Gamma(1 + 1/c)^2 / Gamma(1 + 2/c)``, pi at ``c = 2``."""
    return torch.exp(math.log(4.0) + 2.0 * torch.lgamma(1.0 + 1.0 / c)
                     - torch.lgamma(1.0 + 2.0 / c))


@functools.lru_cache(maxsize=8)
def quadrature_tables(device, dtype):
    """The area factor's midpoint nodes on ``(device, dtype)``: ``theta``,
    ``log cos^2``, ``log sin^2``, their signs and ``log|sin cos|``, each
    ``(N,)``; made once from float64 host values."""
    n = _QUAD_NODES
    th = (np.arange(n) + 0.5) * (2.0 * np.pi / n)
    lsc = np.log(np.cos(th) ** 2)
    lss = np.log(np.sin(th) ** 2)
    host = (th, lsc, lss, np.sign(np.cos(th)), np.sign(np.sin(th)),
            0.5 * (lsc + lss))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in host)


def _radians(phi, angle_degrees):
    return torch.deg2rad(phi) if angle_degrees else phi


def isophote_area_factor(c, fourier=(), angle_degrees=False):
    """Isophote area factor: closed form, or azimuthal quadrature.

    The area inside ``r_gen = t (1 + f(theta))`` is ``t^2 a b A`` with
    ``A = 1/2 Int rho(theta)^2 (1 + f(theta))^2 dtheta``, ``rho = (|cos|^c
    + |sin|^c)^(-1/c)``.  Without Fourier modes it is the closed
    :func:`superellipse_area_factor`.  With them, midpoint quadrature in
    two parametrizations picked per ``c``: theta-space (cusp-free for
    ``c >= 1``) and the superellipse parameter ``psi`` (``u =
    sgn|cos psi|^(2/c)``, cusp-free for ``c < 1``).  ``fourier`` is a
    sequence of ``(m, amplitude, phase)``; ``c`` and the modes share a
    batch shape ``(...)``.
    """
    if not fourier:
        return superellipse_area_factor(c)
    th, lsc, lss, sgn_c, sgn_s, lsin_cos = quadrature_tables(c.device, c.dtype)
    n = th.shape[0]
    c = c[..., None]

    def perturb(theta_vals):
        f = torch.zeros_like(theta_vals)
        for m, amp, phi in fourier:
            f = f + amp[..., None] * torch.cos(
                m * theta_vals - _radians(phi, angle_degrees)[..., None])
        g = torch.clamp(1.0 + f, min=FOURIER_FLOOR)
        return g * g

    # theta-space branch
    half_c = 0.5 * c
    lm = torch.maximum(lsc * half_c, lss * half_c)
    t = torch.exp(lsc * half_c - lm) + torch.exp(lss * half_c - lm)
    log_rho2 = -(lm + torch.log(t)) * (2.0 / c)
    a_theta = torch.sum(torch.exp(log_rho2) * perturb(th), dim=-1)

    # psi-space branch: the point rides the unit superellipse exactly
    inv_c = 1.0 / c
    u = sgn_c * torch.exp(lsc * inv_c)
    v = sgn_s * torch.exp(lss * inv_c)
    w = (2.0 * inv_c) * torch.exp(lsin_cos * (2.0 * inv_c - 1.0))
    a_psi = torch.sum(w * perturb(torch.atan2(v, u)), dim=-1)

    return (math.pi / n) * torch.where(c[..., 0] < 1.0, a_psi, a_theta)


def generalized_log_sq_radius(u, v, c, fourier, angle_degrees, bending=(),
                              rotation=None):
    """``log(r_gen^2)`` over the grid: swirl, bending, boxiness, Fourier.

    ``u``/``v`` are the scaled and rotated offsets; ``c`` and the mode
    parameters broadcast against them.  ``rotation`` is ``(rot_ang_rad,
    rot_out_px, rot_in_px, rot_pow, a, b)`` with ``a``/``b`` the
    semi-axes folded into ``u``/``v``: the swirl acts in the unscaled
    frame, first.  ``bending`` is a sequence of ``(m, amplitude)``
    applied before the radius and the Fourier azimuth.  The azimuth of
    the Fourier factor comes from Chebyshev recurrences on ``(u, v) /
    |(u, v)|``.
    """
    if rotation is not None:
        rot_ang, rot_out, rot_in, rot_pow, ax_a, ax_b = rotation
        x = u * ax_a
        y = v * ax_b
        r = torch.sqrt(torch.clamp(x * x + y * y, min=_TINY))
        ramp = (r - rot_in) / (rot_out - rot_in)
        ramp_p = torch.where(
            ramp > 0.0,
            torch.exp(rot_pow * torch.log(torch.clamp(ramp, min=_TINY))),
            torch.zeros_like(ramp),
        )
        phi = rot_ang * ramp_p
        cph = torch.cos(phi)
        sph = torch.sin(phi)
        u = (cph * x + sph * y) / ax_a
        v = (cph * y - sph * x) / ax_b
    if bending:
        amp_of = dict(bending)
        g = None
        up = None
        for m in range(1, max(amp_of) + 1):
            up = u if up is None else up * u
            if m in amp_of:
                term = amp_of[m] * up
                g = term if g is None else g + term
        v = v + g
    su = torch.clamp(u * u, min=_TINY)
    sv = torch.clamp(v * v, min=_TINY)
    lsu = torch.log(su)
    lsv = torch.log(sv)
    lm = torch.maximum(lsu, lsv)
    half_c = 0.5 * c
    t = torch.exp((lsu - lm) * half_c) + torch.exp((lsv - lm) * half_c)
    log_sq_r = torch.clamp(lm + torch.log(t) * (2.0 / c), min=_LOG_TINY)
    if fourier:
        rinv = torch.rsqrt(su + sv)
        cos1 = u * rinv
        sin1 = v * rinv
        f = torch.zeros_like(log_sq_r)
        cos_m, sin_m = cos1, sin1
        mode = {m: (amp, phi) for m, amp, phi in fourier}
        for m in range(1, max(mode) + 1):
            if m in mode:
                amp, phi = mode[m]
                phi_r = _radians(phi, angle_degrees)
                f = f + amp * (torch.cos(phi_r) * cos_m + torch.sin(phi_r) * sin_m)
            cos_m, sin_m = (cos_m * cos1 - sin_m * sin1,
                            sin_m * cos1 + cos_m * sin1)
        g = torch.clamp(1.0 + f, min=FOURIER_FLOOR)
        log_sq_r = log_sq_r - 2.0 * torch.log(g)
    return log_sq_r
