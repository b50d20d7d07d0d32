"""Sersic profile (port of ``ops/sersic.py``).

Same algebra as the JAX package: kappa from the p=1/2 inverse
incomplete gamma, surface brightness at ``r_e`` from the total flux, the
inverse scale+rotation matrix folded into four scalars with the
reference's +90 degree position-angle convention, and the first-order
sub-pixel centroid correction.

Documented divergences from the reference, kept as in the JAX package:
the square radius is clamped at ``1e-30`` (an exact pixel-center hit
renders finite instead of ``log(0)``) and the square offset of the
correction at ``0.125`` (the half-pixel corner distance, so the
correction saturates at its largest valid value instead of diverging).

Every function here is batched over leading dimensions: scalars of
shape ``(B,)`` render ``(B, H, W)`` images.  The profile arithmetic of
:func:`sersic_profile_core` is written as a sequence of single, rounded
operations in a fixed order; the CUDA render kernel
(``csrc/sersic_render.cu``) evaluates the same sequence.

:func:`render_sersic_gen` renders the generalized isophotes (boxiness,
Fourier and bending modes, spiral rotation, radial truncation) in plain
PyTorch, as the JAX package renders them in XLA beside its kernel.
"""
from __future__ import annotations

import math

import torch

from .coords import coord_grids, mag_to_flux
from .gammainc import gammaincinv_half, gammaincinv_half_table
from .isophote import (
    generalized_log_sq_radius,
    isophote_area_factor,
    superellipse_area_factor,
)
from .truncation import sersic_trunc_ratio, truncation_envelope

__all__ = [
    "sersic_kappa",
    "sersic_sb_eff",
    "sersic_scalar_params",
    "sersic_profile_core",
    "render_sersic",
    "sersic_gen_area_factor",
    "render_sersic_gen",
]

_TINY = 1e-30


def sersic_kappa(index, mode="table"):
    """Sersic b_n: ``gammaincinv(2n, 1/2)`` by table or Newton."""
    a = 2.0 * index
    if mode == "table":
        return gammaincinv_half_table(a)
    if mode == "exact":
        return gammaincinv_half(a)
    raise ValueError(f"unknown kappa mode {mode!r}: expected 'table' or 'exact'")


def sersic_sb_eff(flux_tot, index, reff, reff_b, kappa):
    """Surface brightness (flux/pixel) at the effective radius."""
    two_n = 2.0 * index
    gamma_2n = torch.exp(torch.lgamma(two_n))
    return flux_tot / (
        math.pi
        * reff
        * reff_b
        * two_n
        * torch.exp(kappa - torch.log(kappa) * two_n)
        * gamma_2n
    )


def sersic_scalar_params(xy, mag, reff, reff_b, index, angle, mag_zp,
                         angle_degrees=False, kappa_mode="table"):
    """The nine per-component scalars the per-pixel profile consumes.

    ``xy`` is ``(..., 2)``; every other tensor argument has the batch
    shape ``(...)``.  Returns a tuple ``(x, y, m00, m01, m10, m11, kappa,
    radius_pow, sbeff)`` of batch-shaped tensors.
    """
    kappa = sersic_kappa(index, mode=kappa_mode)
    flux_tot = mag_to_flux(mag, mag_zp)
    sbeff = sersic_sb_eff(flux_tot, index, reff, reff_b, kappa)
    ang = torch.deg2rad(angle) if angle_degrees else angle
    ang = ang + 0.5 * math.pi
    sin_a, cos_a = torch.sin(ang), torch.cos(ang)
    return (
        xy[..., 0],
        xy[..., 1],
        cos_a / reff,
        sin_a / reff,
        -sin_a / reff_b,
        cos_a / reff_b,
        kappa,
        0.5 / index,
        sbeff,
    )


def sersic_profile_core(dx, dy, m00, m01, m10, m11, kappa, rp, sbeff,
                        correction=True):
    """Per-pixel Sersic surface brightness from pixel offsets + scalars.

    With ``p = (r^2)^(1/2n)``: ``sb = exp(-kappa (p - 1))`` and
    ``corr = 1 + (kappa rp p)^2 / (3 off^2)``.  Scalars broadcast
    against the offsets.
    """
    u = m00 * dx + m01 * dy
    v = m10 * dx + m11 * dy
    sq_r = torch.clamp(u * u + v * v, min=_TINY)
    p = torch.exp(torch.log(sq_r) * rp)
    sb = torch.exp(-kappa * (p - 1.0))
    if not correction:
        return sbeff * sb
    sq_off = torch.clamp(dx * dx + dy * dy, min=0.125)
    krp_p = kappa * rp * p
    corr = 1.0 + (krp_p * krp_p) / (3.0 * sq_off)
    return sbeff * sb * corr


def render_sersic(shape, xy, mag, reff, reff_b, index, angle, mag_zp,
                  angle_degrees=False, kappa_mode="table", correction=True):
    """Render Sersic profiles over the (H, W) grid.

    Tensor arguments share a batch shape ``(...)`` (``xy`` has a
    trailing 2); the result is ``(..., H, W)`` on their device.
    """
    x, y, m00, m01, m10, m11, kappa, rp, sbeff = sersic_scalar_params(
        xy, mag, reff, reff_b, index, angle, mag_zp, angle_degrees,
        kappa_mode,
    )
    xg, yg = coord_grids(shape, mag.dtype, mag.device)

    def b(s):  # batch scalar -> broadcast over the pixel grid
        return s[..., None, None]

    return sersic_profile_core(
        xg - b(x), yg - b(y), b(m00), b(m01), b(m10), b(m11), b(kappa),
        b(rp), b(sbeff), correction=correction,
    )


def sersic_gen_area_factor(c):
    """Superellipse area factor (:mod:`.isophote`); pi at ``c = 2``."""
    return superellipse_area_factor(c)


def render_sersic_gen(xg, yg, xy, mag, reff, reff_b, index, angle, c0, mag_zp,
                      angle_degrees=False, kappa_mode="table", fourier=(),
                      bending=(), rotation=None, trunc=None, correction=True):
    """Sersic profile over generalized isophotes.

    ``c0`` boxiness (``c = c0 + 2``), ``fourier`` ``((m, amplitude,
    phase), ...)``, ``bending`` ``((m, amplitude), ...)``, ``rotation``
    ``(rot_ang, rot_out, rot_in, rot_pow)`` (``rot_ang`` in ``angle``
    units, radii in pixels) and ``trunc`` ``(outer, inner)``, each a
    ``(break_px, soft_px)`` pair or None (:mod:`.truncation`).  Which
    options exist is static structure; their values are tensors.  The
    flux normalization uses the isophote area factor and, under
    truncation, the device quadrature's flux ratio, so ``mag`` stays the
    exact total flux.  The sub-pixel correction keeps the elliptical
    closed form.

    ``xg``/``yg`` broadcast against the parameters, whose batch shape
    ``(...)`` must broadcast against the pixel grid (e.g. ``(B, 1, 1)``
    with ``xy`` ``(B, 1, 1, 2)``).
    """
    x, y, m00, m01, m10, m11, kappa, rp, sbeff = sersic_scalar_params(
        xy, mag, reff, reff_b, index, angle, mag_zp, angle_degrees, kappa_mode)
    c = c0 + 2.0
    sbeff = sbeff * (math.pi / isophote_area_factor(c, fourier, angle_degrees))
    dx = xg - x
    dy = yg - y
    u = m00 * dx + m01 * dy
    v = m10 * dx + m11 * dy
    if rotation is not None:
        rot_ang, rot_out, rot_in, rot_pow = rotation
        rot_ang = torch.deg2rad(rot_ang) if angle_degrees else rot_ang
        rotation = (rot_ang, rot_out, rot_in, rot_pow, reff, reff_b)
    log_sq_r = generalized_log_sq_radius(u, v, c, fourier, angle_degrees,
                                         bending, rotation)
    p = torch.exp(log_sq_r * rp)
    sb = torch.exp(-kappa * (p - 1.0))
    if trunc is not None:
        outer, inner = trunc
        sbeff = sbeff * sersic_trunc_ratio(kappa, index, reff, outer, inner)
        r_px = torch.exp(0.5 * log_sq_r) * reff
        sb = sb * truncation_envelope(r_px, outer, inner)
    if not correction:
        return sbeff * sb
    sq_off = torch.clamp(dx * dx + dy * dy, min=0.125)
    krp_p = kappa * rp * p
    corr = 1.0 + (krp_p * krp_p) / (3.0 * sq_off)
    return sbeff * sb * corr
