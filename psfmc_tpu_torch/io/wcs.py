"""Minimal FITS WCS: zenithal projections + SIP distortion + pixel scale.

The reference uses ``astropy.wcs`` only to compute the projected pixel
area for surface-brightness plots (reference analysis/plotting.py:93-97)
and ``pyregion`` uses it to map sky-coordinate ds9 regions onto the image.
This stand-in reads the standard CD-matrix / CDELT+CROTA2 keywords,
supports the TAN/SIN/ARC projections (TAN covers HST-style imaging),
and applies SIP distortion polynomials (Shupe et al. 2005: ``A_p_q`` /
``B_p_q`` forward coefficients, with the fitted ``AP_p_q`` / ``BP_p_q``
inverses used as the starting guess for an exact fixed-point inversion)
— the one WCS case flt-frame HST imaging actually hits; drizzled
products carry no SIP.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "MiniWCS",
    "proj_plane_pixel_area",
    "galactic_to_equatorial",
    "equatorial_to_galactic",
    "ecliptic_to_equatorial",
    "equatorial_to_ecliptic",
]

_D2R = np.pi / 180.0


def _read_sip_poly(header, prefix):
    """Read a SIP polynomial (``{prefix}_ORDER`` + ``{prefix}_p_q``
    cards) into a dense (order+1, order+1) coefficient matrix, or None
    when absent.  Missing individual cards are zero (the convention —
    headers only write non-zero terms)."""
    order = header.get(f"{prefix}_ORDER")
    if order is None:
        return None
    order = int(order)
    coeffs = np.zeros((order + 1, order + 1))
    found = False
    for p in range(order + 1):
        for q in range(order + 1 - p):
            val = header.get(f"{prefix}_{p}_{q}")
            if val is not None:
                coeffs[p, q] = float(val)
                found = True
    return coeffs if found else None


def _sip_eval(coeffs, u, v):
    """Evaluate sum_pq c[p,q] u^p v^q (Horner in u, rows Horner in v)."""
    u = np.asarray(u, dtype=float)
    v = np.asarray(v, dtype=float)
    out = np.zeros(np.broadcast(u, v).shape)
    for p in range(coeffs.shape[0] - 1, -1, -1):
        row = np.zeros_like(out)
        for q in range(coeffs.shape[1] - 1, -1, -1):
            row = row * v + coeffs[p, q]
        out = out * u + row
    return out


class MiniWCS:
    def __init__(self, header):
        # Scope guard: only the gnomonic projection is implemented.
        # A non-TAN CTYPE (SIN/ARC/AIT/...) or SIP distortion suffix
        # would silently be treated as TAN — warn so sbeff pixel areas
        # and sky-region mapping are not quietly wrong (the reference
        # delegates to astropy.wcs, which handles any projection).
        import warnings

        self.proj = "TAN"
        self._sip_suffix = False
        for key in ("CTYPE1", "CTYPE2"):
            ctype = str(header.get(key, "") or "")
            code = ctype[5:8] if len(ctype) >= 8 else ""
            if ctype and code and code in ("SIN", "ARC"):
                self.proj = code
            elif ctype and code and code != "TAN":
                warnings.warn(
                    f"MiniWCS supports the TAN/SIN/ARC projections; "
                    f"header {key}={ctype!r} is treated AS TAN — pixel "
                    "areas and sky->pixel mappings may be wrong away "
                    "from the reference point"
                )
                break
            if ctype.endswith("-SIP"):
                self._sip_suffix = True
        self.crpix = np.array(
            [float(header.get("CRPIX1", 1.0)), float(header.get("CRPIX2", 1.0))]
        )
        self.crval = np.array(
            [float(header.get("CRVAL1", 0.0)), float(header.get("CRVAL2", 0.0))]
        )
        if "CD1_1" in header:
            self.cd = np.array(
                [
                    [float(header.get("CD1_1", 0.0)), float(header.get("CD1_2", 0.0))],
                    [float(header.get("CD2_1", 0.0)), float(header.get("CD2_2", 0.0))],
                ]
            )
        elif "PC1_1" in header:
            pc = np.array(
                [
                    [float(header.get("PC1_1", 1.0)), float(header.get("PC1_2", 0.0))],
                    [float(header.get("PC2_1", 0.0)), float(header.get("PC2_2", 1.0))],
                ]
            )
            cdelt = np.diag(
                [float(header.get("CDELT1", 1.0)), float(header.get("CDELT2", 1.0))]
            )
            self.cd = cdelt @ pc
        else:
            cdelt1 = float(header.get("CDELT1", 1.0))
            cdelt2 = float(header.get("CDELT2", 1.0))
            crota = float(header.get("CROTA2", 0.0)) * _D2R
            self.cd = np.array(
                [
                    [cdelt1 * np.cos(crota), -cdelt2 * np.sin(crota)],
                    [cdelt1 * np.sin(crota), cdelt2 * np.cos(crota)],
                ]
            )
        self.cd_inv = np.linalg.inv(self.cd)

        # SIP distortion polynomials (Shupe et al. 2005).  The forward
        # A/B polynomials correct pixel offsets (u, v) from CRPIX before
        # the CD matrix: (U, V) = (u + A(u, v), v + B(u, v)).  AP/BP are
        # fitted (approximate) inverses; sky_to_pixel uses them only as
        # the starting guess of an exact fixed-point inversion of the
        # forward model, so round trips close to machine precision.
        self.sip_a = _read_sip_poly(header, "A")
        self.sip_b = _read_sip_poly(header, "B")
        self.sip_ap = _read_sip_poly(header, "AP")
        self.sip_bp = _read_sip_poly(header, "BP")
        if self._sip_suffix and self.sip_a is None and self.sip_b is None:
            warnings.warn(
                "CTYPE carries the -SIP suffix but no A_p_q/B_p_q "
                "coefficient cards were found: treating the WCS as "
                "linear (no distortion applied)"
            )

    @property
    def has_sip(self):
        return self.sip_a is not None or self.sip_b is not None

    def _sip_forward(self, u, v):
        """(u, v) pixel offsets -> distorted (U, V) offsets."""
        du = _sip_eval(self.sip_a, u, v) if self.sip_a is not None else 0.0
        dv = _sip_eval(self.sip_b, u, v) if self.sip_b is not None else 0.0
        return u + du, v + dv

    def _sip_inverse(self, U, V):
        """Distorted (U, V) offsets -> undistorted (u, v), exactly.

        Fixed-point iteration of the forward model: u <- U - A(u, v).
        SIP corrections are small (a few px over thousands, with
        |dA/du| ~ 1e-3) so convergence is fast; the AP/BP inverse
        polynomials, when present, provide the starting guess.  Warns
        whenever the iteration fails to close below 1e-6 px — with or
        without AP/BP cards (a diverged fixed point hands garbage/NaN
        centers to the region rasterizer, which must never happen
        silently).
        """
        if self.sip_ap is not None or self.sip_bp is not None:
            u = U + (_sip_eval(self.sip_ap, U, V)
                     if self.sip_ap is not None else 0.0)
            v = V + (_sip_eval(self.sip_bp, U, V)
                     if self.sip_bp is not None else 0.0)
            had_inverse = True
        else:
            u, v = U, V
            had_inverse = False
        tol = 1e-6
        for _ in range(20):
            fu, fv = self._sip_forward(u, v)
            ru, rv = fu - U, fv - V
            resid = float(np.max(np.hypot(ru, rv)))
            if not np.isfinite(resid):
                break  # diverged — iterating further only makes NaNs
            if resid < tol:
                break
            u = u - ru
            v = v - rv
        else:
            # exhausted: the measured residual predates the final
            # update — re-measure at the returned (u, v) so the
            # warning (and its magnitude) are truthful
            fu, fv = self._sip_forward(u, v)
            resid = float(np.max(np.hypot(fu - U, fv - V)))
        if not (np.isfinite(resid) and resid < tol):
            import warnings

            hint = (
                "the AP/BP inverse-coefficient guess did not help"
                if had_inverse
                else "the header carries no AP/BP inverse coefficients"
            )
            warnings.warn(
                "SIP inversion did not converge below 1e-6 px "
                f"({hint}); sky->pixel positions may be off by up to "
                f"{resid:.2g} px"
            )
        return u, v

    def pixel_area_deg2(self):
        """Projected pixel area in square degrees (|det CD|)."""
        return abs(np.linalg.det(self.cd))

    def sky_to_pixel(self, ra, dec):
        """Zenithal world->pixel; returns 1-based FITS (x, y) pixels.

        TAN (gnomonic, the HST default), SIN (orthographic — radio
        interferometry) and ARC (zenithal equidistant) share the
        native-pole geometry and differ only in the radial scaling
        ``R(c)``: tan(c), sin(c), c.
        """
        ra = np.asarray(ra, dtype=float) * _D2R
        dec = np.asarray(dec, dtype=float) * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R

        cos_c = np.sin(dec0) * np.sin(dec) + np.cos(dec0) * np.cos(dec) * np.cos(
            ra - ra0
        )
        # direction components (= sin(c) * unit direction in the
        # tangent plane); projection scales them by R(c)/sin(c)
        sx = np.cos(dec) * np.sin(ra - ra0)
        sy = (
            np.cos(dec0) * np.sin(dec)
            - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)
        )
        if self.proj == "SIN":
            k = 1.0
        elif self.proj == "ARC":
            c = np.arccos(np.clip(cos_c, -1.0, 1.0))
            sin_c = np.sin(c)
            k = np.where(sin_c == 0.0, 1.0, c / np.where(sin_c == 0.0, 1.0, sin_c))
        else:  # TAN
            k = 1.0 / cos_c
        # Standard (intermediate) coordinates in degrees
        xi = k * sx / _D2R
        eta = k * sy / _D2R
        dxy = self.cd_inv @ np.stack([xi, eta])
        U, V = dxy[0], dxy[1]
        if self.has_sip:
            U, V = self._sip_inverse(U, V)
        return U + self.crpix[0], V + self.crpix[1]

    def pixel_to_sky(self, x, y):
        """Zenithal pixel->world; accepts 1-based FITS (x, y), deg out.

        Exact inverse of :meth:`sky_to_pixel` for the active projection
        (round-trip asserted in tests).
        """
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        u = x - self.crpix[0]
        v = y - self.crpix[1]
        if self.has_sip:
            u, v = self._sip_forward(u, v)
        xi, eta = self.cd @ np.stack([u, v])
        xi = xi * _D2R
        eta = eta * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R

        rho = np.hypot(xi, eta)
        if self.proj == "SIN":
            c = np.arcsin(np.clip(rho, -1.0, 1.0))
        elif self.proj == "ARC":
            c = rho
        else:  # TAN
            c = np.arctan(rho)
        cos_c, sin_c = np.cos(c), np.sin(c)
        # guard rho=0 (the reference point itself)
        safe_rho = np.where(rho == 0.0, 1.0, rho)
        dec = np.arcsin(
            cos_c * np.sin(dec0) + eta * sin_c * np.cos(dec0) / safe_rho
        )
        ra = ra0 + np.arctan2(
            xi * sin_c,
            safe_rho * np.cos(dec0) * cos_c - eta * np.sin(dec0) * sin_c,
        )
        dec = np.where(rho == 0.0, dec0, dec)
        ra = np.where(rho == 0.0, ra0, ra)
        return ra / _D2R, dec / _D2R


def proj_plane_pixel_area(wcs):
    """Pixel area in deg^2 (mirrors astropy.wcs.utils helper of same name)."""
    return wcs.pixel_area_deg2()


# -- sky-frame rotations (galactic / ecliptic <-> equatorial J2000) ------
# Equatorial(J2000) -> galactic rotation matrix (IAU 1958 pole at
# J2000: ra 192.85948, dec 27.12825, theta 122.93192 — the standard
# matrix astropy/SLALIB use to ~1e-7).
_EQ_TO_GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [+0.4941094279, -0.4448296300, +0.7469822445],
    [-0.8676661490, -0.1980763734, +0.4559837762],
])
_OBLIQUITY_J2000 = 23.4392911 * _D2R  # IAU 1976/2000 mean obliquity


def _sph_to_vec(lon_deg, lat_deg):
    lon = np.asarray(lon_deg, float) * _D2R
    lat = np.asarray(lat_deg, float) * _D2R
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)])


def _vec_to_sph(v):
    lon = np.arctan2(v[1], v[0]) / _D2R % 360.0
    lat = np.arcsin(np.clip(v[2], -1.0, 1.0)) / _D2R
    return lon, lat


def galactic_to_equatorial(l_deg, b_deg):
    """Galactic (l, b) -> equatorial J2000 (ra, dec), degrees.

    Exact spherical rotation (the frame conversion pyregion delegates
    to astropy; reference utils.py:82-103 accepts galactic-frame ds9
    regions through it).  FK5(J2000)-vs-ICRS differences are ~25 mas —
    irrelevant at mask-pixel scale.
    """
    return _vec_to_sph(_EQ_TO_GAL.T @ _sph_to_vec(l_deg, b_deg))


def equatorial_to_galactic(ra_deg, dec_deg):
    """Inverse of :func:`galactic_to_equatorial` (round-trip tested)."""
    return _vec_to_sph(_EQ_TO_GAL @ _sph_to_vec(ra_deg, dec_deg))


def ecliptic_to_equatorial(lon_deg, lat_deg):
    """Ecliptic J2000 (lon, lat) -> equatorial J2000 (ra, dec), deg."""
    v = _sph_to_vec(lon_deg, lat_deg)
    ce, se = np.cos(_OBLIQUITY_J2000), np.sin(_OBLIQUITY_J2000)
    return _vec_to_sph(np.stack([
        v[0], v[1] * ce - v[2] * se, v[1] * se + v[2] * ce
    ]))


def equatorial_to_ecliptic(ra_deg, dec_deg):
    """Inverse of :func:`ecliptic_to_equatorial` (round-trip tested)."""
    v = _sph_to_vec(ra_deg, dec_deg)
    ce, se = np.cos(_OBLIQUITY_J2000), np.sin(_OBLIQUITY_J2000)
    return _vec_to_sph(np.stack([
        v[0], v[1] * ce + v[2] * se, -v[1] * se + v[2] * ce
    ]))
