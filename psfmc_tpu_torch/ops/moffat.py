"""Moffat profile (port of ``ops/moffat.py``).

``I(r) = I0 (1 + (r / alpha)^2)^(-beta)``, parameterized as in the JAX
package: total ``mag``, semi-major/semi-minor FWHMs (``fwhm = 2 alpha
sqrt(2^(1/beta) - 1)``), position ``angle`` with the +90 degree
convention and ``index`` = beta.  The flux normalization is closed:
``I0 = F (beta - 1) / (A alpha_a alpha_b)``, ``A`` pi for the ellipse or
the isophote area factor of a shaped profile (:mod:`.isophote`).  No
sub-pixel correction: the Moffat core is flat.

Parameters share a batch shape ``(...)`` that broadcasts against the
pixel grids.
"""
from __future__ import annotations

import math

import torch

from .coords import mag_to_flux
from .isophote import generalized_log_sq_radius, isophote_area_factor
from .truncation import moffat_trunc_ratio, truncation_envelope

__all__ = [
    "moffat_scalar_params",
    "moffat_profile_core",
    "render_moffat",
    "render_moffat_gen",
]


def _alpha_scale(beta):
    """``sqrt(2^(1/beta) - 1)``: FWHM / (2 alpha)."""
    return torch.sqrt(torch.exp2(1.0 / beta) - 1.0)


def moffat_scalar_params(xy, mag, fwhm, fwhm_b, index, angle, mag_zp,
                         angle_degrees=False):
    """``(x, y, m00, m01, m10, m11, i0, beta)``: the inverse scale+rotation
    in alpha units and the flux-normalized central surface brightness."""
    s = _alpha_scale(index)
    alpha_a = 0.5 * fwhm / s
    alpha_b = 0.5 * fwhm_b / s
    flux = mag_to_flux(mag, mag_zp)
    i0 = flux * (index - 1.0) / (math.pi * alpha_a * alpha_b)
    ang = torch.deg2rad(angle) if angle_degrees else angle
    ang = ang + 0.5 * math.pi
    sin_a, cos_a = torch.sin(ang), torch.cos(ang)
    return (xy[..., 0], xy[..., 1], cos_a / alpha_a, sin_a / alpha_a,
            -sin_a / alpha_b, cos_a / alpha_b, i0, index)


def moffat_profile_core(dx, dy, m00, m01, m10, m11, i0, beta):
    """Per-pixel Moffat: ``i0 exp(-beta log(1 + sq_r))``."""
    u = m00 * dx + m01 * dy
    v = m10 * dx + m11 * dy
    sq_r = u * u + v * v
    return i0 * torch.exp(-beta * torch.log(1.0 + sq_r))


def render_moffat(xg, yg, xy, mag, fwhm, fwhm_b, index, angle, mag_zp,
                  angle_degrees=False):
    """One elliptical Moffat over the grid."""
    x, y, m00, m01, m10, m11, i0, beta = moffat_scalar_params(
        xy, mag, fwhm, fwhm_b, index, angle, mag_zp, angle_degrees)
    return moffat_profile_core(xg - x, yg - y, m00, m01, m10, m11, i0, beta)


def render_moffat_gen(xg, yg, xy, mag, fwhm, fwhm_b, index, angle, c0, mag_zp,
                      angle_degrees=False, fourier=(), bending=(), rotation=None,
                      trunc=None):
    """Moffat over generalized isophotes: boxiness ``c0``, Fourier modes,
    bending modes, spiral ``rotation`` and radial truncation ``trunc``
    (radii in semi-major alpha pixels), each flux-exact as in
    :func:`~psfmc_tpu_torch.ops.sersic.render_sersic_gen`; equal to
    :func:`render_moffat` at ``c0 = 0`` with no modes."""
    x, y, m00, m01, m10, m11, i0, beta = moffat_scalar_params(
        xy, mag, fwhm, fwhm_b, index, angle, mag_zp, angle_degrees)
    c = c0 + 2.0
    i0 = i0 * (math.pi / isophote_area_factor(c, fourier, angle_degrees))
    dx = xg - x
    dy = yg - y
    u = m00 * dx + m01 * dy
    v = m10 * dx + m11 * dy
    if rotation is not None:
        s_r = _alpha_scale(beta)
        rot_ang, rot_out, rot_in, rot_pow = rotation
        rot_ang = torch.deg2rad(rot_ang) if angle_degrees else rot_ang
        rotation = (rot_ang, rot_out, rot_in, rot_pow, 0.5 * fwhm / s_r,
                    0.5 * fwhm_b / s_r)
    log_sq_r = generalized_log_sq_radius(u, v, c, fourier, angle_degrees,
                                         bending, rotation)
    sq_r = torch.exp(log_sq_r)
    sb = i0 * torch.exp(-beta * torch.log(1.0 + sq_r))
    if trunc is not None:
        outer, inner = trunc
        alpha_a = 0.5 * fwhm / _alpha_scale(beta)
        sb = sb * (moffat_trunc_ratio(beta, alpha_a, outer, inner)
                   * truncation_envelope(torch.exp(0.5 * log_sq_r) * alpha_a,
                                         outer, inner))
    return sb
