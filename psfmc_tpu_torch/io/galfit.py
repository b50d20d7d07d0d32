"""GALFIT ``.feedme`` importer — migrate GALFIT setups into psfMC models
(port of ``io/galfit.py``).

Host-side and numpy only (scipy inside the functions), as in the JAX
package: the parse, the conversions and the model-file text are the same
operations on the same numbers, and the components are the port's
(:mod:`psfmc_tpu_torch.models.components`, :mod:`psfmc_tpu_torch.
distributions`).  The generated texts name this package in their
generator comment lines; every other line is the JAX package's.

Beyond the reference (which only documents the angle/position
conversion in a test comment, reference tests/sim.feedme:1): parse a
GALFIT input file and build the equivalent component list, so an
existing GALFIT workflow moves to Bayesian fitting without hand
transcription.  Two layers:

* :func:`parse_feedme` — faithful structural parse (header entries +
  per-object parameter/toggle table, including GALFIT's "hidden"
  shape parameters ``C0``/``Fn``/``Bn``/``Rn``);
* :func:`components_from_feedme` — live :class:`ComponentBase`
  instances with every convention conversion applied (below);
* :func:`feedme_to_model_source` — an editable psfMC model-file text
  (the recommended entry point: imported priors are starting guesses,
  users should review the generated widths).

Convention conversions (reference tests/sim.feedme:1 and
tests/test_components.py:71-74):

* positions: GALFIT is 1-based -> subtract 1;
* position angle: psfMC angle = GALFIT angle + 90 (components are
  built with ``angle_degrees=True``);
* ``expdisk`` scale length -> ``reff = kappa(1) * rs`` (ExpDisk is
  half-light parameterized);
* ``gaussian`` FWHM -> ``reff = fwhm / 2`` (see
  :class:`~psfmc_tpu_torch.models.components.Gaussian`);
* axis ratio ``q`` -> semi-minor size ``= q * semi-major``;
* GALFIT's surface-brightness-parameterized families (``king`` mu(0),
  ``nuker`` mu(Rb), ``ferrer`` mu(0), ``edgedisk`` mu(0), all
  mag/arcsec^2) are
  converted EXACTLY to this package's total-magnitude convention via
  the same radial flux integrals the renderers use (host scipy
  quadrature twins — no device math at import time), using the
  feedme's zeropoint ``J)`` and plate scale ``K)``.

Free parameters (fit toggle 1) become ``Uniform`` priors centered on
the GALFIT value with documented margins (see
:func:`components_from_feedme`); toggle 0 becomes a constant.  GALFIT
is a maximum-likelihood fitter, so its file carries no prior widths —
the generated ones are sensible defaults, not gospel.

Parameter-constraint files (the ``G)`` input) are applied where an
exact equivalent exists: single-component ranges tighten the free
parameter's prior bounds; zero-offset / unit-ratio couples become
:class:`~psfmc_tpu_torch.models.components.Tied` links (same slot, exact by
construction).  Nonzero offsets, non-unit ratios and pair ranges have
no exact analogue and warn.

Not imported (warned about when present): GALFIT ``log`` spiral ramps
(only the ``power`` ramp family exists here), spiral inclination
projection ``R9``/``R10``, and the ``isophote``/``powsersic`` object
types.
"""
from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "parse_feedme",
    "components_from_feedme",
    "feedme_to_model_source",
    "results_to_feedme",
    "parse_constraints",
    "GalfitConstraint",
    "GalfitObject",
    "GalfitModel",
]

# kappa(n=1) = gammaincinv(2, 0.5): half-light radius of an
# exponential disk in scale lengths (Ciotti & Bertin 1999)
_KAPPA_N1 = 1.6783469900166605


@dataclass
class GalfitObject:
    """One parsed GALFIT object block."""

    kind: str
    # param key ('1', '3', ..., 'C0', 'F1', 'R0') -> (values, toggles);
    # values are floats except R0's ramp-function name (str)
    params: Dict[str, Tuple[list, list]] = field(default_factory=dict)


@dataclass
class GalfitModel:
    """Parsed feedme: control header entries + object list."""

    header: Dict[str, str] = field(default_factory=dict)
    objects: List[GalfitObject] = field(default_factory=list)

    @property
    def mag_zeropoint(self) -> Optional[float]:
        j = self.header.get("J")
        return float(j.split()[0]) if j else None

    @property
    def plate_scale(self) -> Optional[Tuple[float, float]]:
        k = self.header.get("K")
        if not k:
            return None
        parts = k.split()
        return float(parts[0]), float(parts[1 if len(parts) > 1 else 0])


_LINE_RE = re.compile(r"^\s*#?\s*([A-Z]?\d{0,2}|[A-Z])\)\s*(.*)$")


def _tokenize(body: str):
    """Values + toggles from a parameter line body (comment stripped)."""
    body = body.split("#", 1)[0].strip()
    return body.split()


def parse_feedme(source: str) -> GalfitModel:
    """Parse GALFIT feedme text or a path to one.

    Commented-out entries (``#D) psf.fits``) are skipped.  Object
    blocks start at ``0) <type>`` and collect every ``N)``/hidden-key
    line until the next ``0)``.  Values and fit toggles are split by
    count: a line ``1) 64.5 64.5 1 1`` is two values + two toggles;
    ``3) 21.72 1`` is one value + one toggle (GALFIT's fixed format).
    """
    if "\n" not in source and "\0" not in source:
        try:
            with open(source) as fh:
                source = fh.read()
        except OSError as err:
            raise ValueError(
                f"not feedme text and not a readable path: {err}"
            ) from None

    model = GalfitModel()
    current: Optional[GalfitObject] = None
    for raw in source.splitlines():
        stripped = raw.strip()
        if not stripped or stripped.startswith(("=", "-")):
            continue
        commented = stripped.startswith("#")
        m = _LINE_RE.match(raw)
        if not m or not m.group(1):
            continue
        key, body = m.group(1), m.group(2)
        if commented:
            continue
        if key == "0":
            kind_toks = _tokenize(body)
            if not kind_toks:
                raise ValueError(
                    "GALFIT feedme: '0)' component line carries no "
                    "component type"
                )
            kind = kind_toks[0].lower()
            current = GalfitObject(kind=kind)
            model.objects.append(current)
            continue
        if current is None:
            # control header entry (A..P): keep the raw body text
            if key.isalpha() and len(key) == 1:
                model.header[key] = body.split("#", 1)[0].strip()
            continue
        if key == "Z":  # output option: not a model parameter
            continue
        toks = _tokenize(body)
        if not toks:
            continue
        if key == "R0":  # rotation function name, no toggle
            current.params[key] = ([toks[0].lower()], [])
            continue
        try:
            vals = [float(t) for t in toks]
        except ValueError:
            warnings.warn(
                f"GALFIT object {current.kind}: unparseable line "
                f"{key}) {body!r} — skipped"
            )
            continue
        n = len(vals) // 2 if len(vals) > 1 else 1
        current.params[key] = (vals[:n], [int(t) for t in vals[n:]])
    return model


def _sb_factor_king(rc, rc_b, rt, alpha):
    """flux / (central-SB counts/px) for the King profile.

    ``SB(t)/SB(0) = (((1+t^2)^(-1/a) - q) / (1 - q))^a`` with
    ``q = (1+(rt/rc)^2)^(-1/a)``; integrating over the elliptical
    area element ``pi rc rc_b d(t^2)`` (same convention as
    ``ops.profiles._king_params``).
    """
    from scipy.integrate import quad

    sq_xt = (rt / rc) ** 2
    q = (1.0 + sq_xt) ** (-1.0 / alpha)

    def integrand(s):
        return max((1.0 + s) ** (-1.0 / alpha) - q, 0.0) ** alpha

    val, _ = quad(integrand, 0.0, sq_xt, limit=200)
    return np.pi * rc * rc_b * val / (1.0 - q) ** alpha


def _sb_factor_ferrer(rout, rout_b, alpha, beta):
    """flux / (central-SB counts/px) for the modified Ferrer profile.

    ``SB(t)/SB(0) = (1 - t^(2-beta))^alpha`` over the elliptical area
    element ``pi rout rout_b d(t^2)`` — the closed form is
    ``(2/p) B(2/p, alpha+1)`` with ``p = 2 - beta``
    (``ops.profiles.ferrer_radial_factor``; SB(0) = i0 exactly).
    """
    from scipy.special import beta as beta_fn

    p = 2.0 - beta
    return np.pi * rout * rout_b * (2.0 / p) * beta_fn(
        2.0 / p, alpha + 1.0
    )


def _sb_factor_nuker(rb, rb_b, alpha, beta, gamma):
    """flux / (SB(Rb) counts/px) for the Nuker profile.

    ``SB(t)/SB(rb) = 2^((b-g)/a) t^-g (1+t^a)^((g-b)/a)`` over the
    area element ``pi rb rb_b d(t^2) = 2 pi rb rb_b t dt``
    (``ops.profiles._nuker_params`` convention: i0 = SB at the break).
    """
    from scipy.integrate import quad

    pref = 2.0 ** ((beta - gamma) / alpha)

    def integrand(t):
        return (
            pref * t ** (1.0 - gamma)
            * (1.0 + t**alpha) ** ((gamma - beta) / alpha)
        )

    a, _ = quad(integrand, 0.0, 1.0, limit=200)
    b, _ = quad(integrand, 1.0, np.inf, limit=200)
    return 2.0 * np.pi * rb * rb_b * (a + b)


def _mu_to_mag(mu, factor, zp, plate_scale):
    """GALFIT surface brightness (mag/arcsec^2 at the family's anchor
    radius) -> total magnitude, given flux = factor * (counts/px at
    the anchor)."""
    if not np.isfinite(factor) or factor <= 0:
        raise ValueError(
            "GALFIT surface-brightness -> total-magnitude conversion "
            "failed: the profile's flux integral is divergent or "
            "invalid for these parameters (e.g. nuker gamma >= 2) — "
            "they lie outside both GALFIT's sane range and this "
            "renderer's support"
        )
    px_area = plate_scale[0] * plate_scale[1]
    counts_px = 10.0 ** (-0.4 * (mu - zp)) * px_area
    return zp - 2.5 * np.log10(counts_px * factor)


_REQUIRED = object()  # sentinel: no default -> missing key is an error


def _val(obj, key, default=_REQUIRED):
    v = obj.params.get(key)
    if v:
        return v[0][0]
    if default is _REQUIRED:
        # a truncated/corrupted feedme must fail attributably, not
        # with a NoneType TypeError from the middle of a conversion
        raise ValueError(
            f"GALFIT {obj.kind} component is missing its required "
            f"{key}) parameter line"
        )
    return default


def _free(obj, key, idx=0):
    v = obj.params.get(key)
    if not v or idx >= len(v[1]):
        return False
    t = v[1][idx]
    if t not in (0, 1):
        warnings.warn(
            f"GALFIT object {obj.kind}: fit toggle {t} on {key}) is "
            "not 0/1 — treated as fixed"
        )
        return False
    return t == 1


class _P:
    """One importable parameter: value + free flag + prior bounds."""

    def __init__(self, value, free, lo, hi):
        self.value = value
        self.free = bool(free)
        self.lo, self.hi = float(lo), float(hi)


def _size(v, free, factor):
    return _P(v, free, v / factor, v * factor)


def _obj_params(obj, zp, plate_scale, margins):
    """kind-specific GALFIT->psfMC parameter table for one object.

    Returns (component class name, {attr: _P | value}) or None for
    unsupported kinds.  Scalar attrs only — ``xy`` is assembled by
    the caller (vector prior).
    """
    pm = margins["position"]
    mm = margins["mag"]
    sf = margins["size_factor"]
    am = margins["angle"]

    x = _val(obj, "1", 1.0) - 1.0
    y = (
        (obj.params["1"][0][1] - 1.0)
        if "1" in obj.params and len(obj.params["1"][0]) > 1
        else x
    )
    xy_free = _free(obj, "1", 0) or _free(obj, "1", 1)
    out = {
        "xy": (
            np.array([x, y]),
            xy_free,
            np.array([x - pm, y - pm]),
            np.array([x + pm, y + pm]),
        )
    }

    def mag_p(key="3"):
        v = _val(obj, key)
        return _P(v, _free(obj, key), v - mm, v + mm)

    def angle_p():
        v = _val(obj, "10", 0.0) + 90.0
        return _P(v, _free(obj, "10"), v - am, v + am)

    def q_times(major_attr, key="9"):
        q = _val(obj, key, 1.0)
        major = out[major_attr]
        v = q * major.value
        return _P(
            v,
            _free(obj, key) or major.free,
            min(major.lo * q, v / sf),
            v * sf,
        )

    kind = obj.kind
    if kind == "sky":
        # param 1 is the sky VALUE here, not a position (no -1 shift)
        v = _val(obj, "1", 0.0)
        w = max(1.0, abs(v))
        res = {"adu": _P(v, _free(obj, "1"), v - w, v + w)}
        for attr, key in (("dx", "2"), ("dy", "3")):
            # gradient lines are optional in real feedmes
            g = _val(obj, key, None)
            if g is not None and (g != 0.0 or _free(obj, key)):
                gw = max(0.01, 10.0 * abs(g))
                res[attr] = _P(g, _free(obj, key), g - gw, g + gw)
        return "Sky", res
    if kind == "psf":
        out["mag"] = mag_p()
        return "PointSource", out

    if kind in ("sersic", "devauc", "expdisk", "gaussian"):
        out["mag"] = mag_p()
        r = _val(obj, "4")
        rf = _free(obj, "4")
        if kind == "expdisk":
            r = _KAPPA_N1 * r  # scale length -> half-light radius
        elif kind == "gaussian":
            r = 0.5 * r  # FWHM -> reff (kappa = ln 2 exactly)
        out["reff"] = _size(r, rf, sf)
        out["reff_b"] = q_times("reff")
        if kind == "sersic":
            n = _val(obj, "5")
            out["index"] = _P(
                n, _free(obj, "5"),
                max(0.36, n / 2.0), min(10.0, 2.0 * n),
            )
        out["angle"] = angle_p()
        cls = {
            "sersic": "Sersic",
            "devauc": "DeVaucouleurs",
            "expdisk": "ExpDisk",
            "gaussian": "Gaussian",
        }[kind]
        return cls, out
    if kind == "moffat":
        out["mag"] = mag_p()
        out["fwhm"] = _size(_val(obj, "4"), _free(obj, "4"), sf)
        out["fwhm_b"] = q_times("fwhm")
        b = _val(obj, "5")
        out["index"] = _P(
            b, _free(obj, "5"), max(1.05, b / 2.0), 2.0 * b
        )
        out["angle"] = angle_p()
        return "Moffat", out
    if kind == "king":
        rc, rt = _val(obj, "4"), _val(obj, "5")
        alpha = _val(obj, "6", 2.0)
        q = _val(obj, "9", 1.0)
        mu0 = _val(obj, "3")
        mag = _mu_to_mag(
            mu0, _sb_factor_king(rc, q * rc, rt, alpha), zp, plate_scale
        )
        out["mag"] = _P(mag, _free(obj, "3"), mag - mm, mag + mm)
        out["rc"] = _size(rc, _free(obj, "4"), sf)
        out["rc_b"] = q_times("rc")
        out["rt"] = _size(rt, _free(obj, "5"), sf)
        out["alpha"] = _P(
            alpha, _free(obj, "6"), max(0.1, alpha / 2.0), 2.0 * alpha
        )
        out["angle"] = angle_p()
        return "King", out
    if kind == "nuker":
        rb = _val(obj, "4")
        alpha = _val(obj, "5")
        beta = _val(obj, "6")
        gamma = _val(obj, "7")
        q = _val(obj, "9", 1.0)
        mub = _val(obj, "3")
        mag = _mu_to_mag(
            mub, _sb_factor_nuker(rb, q * rb, alpha, beta, gamma),
            zp, plate_scale,
        )
        out["mag"] = _P(mag, _free(obj, "3"), mag - mm, mag + mm)
        out["rb"] = _size(rb, _free(obj, "4"), sf)
        out["rb_b"] = q_times("rb")
        out["alpha"] = _P(
            alpha, _free(obj, "5"), max(0.1, alpha / 2.0), 2.0 * alpha
        )
        out["beta"] = _P(
            beta, _free(obj, "6"), max(2.05, beta / 1.5), 1.5 * beta
        )
        out["gamma"] = _P(
            gamma, _free(obj, "7"),
            min(0.0, gamma), min(1.95, max(gamma * 1.5, gamma + 0.5)),
        )
        out["angle"] = angle_p()
        return "Nuker", out
    if kind == "ferrer":
        r_out = _val(obj, "4")
        a0 = _val(obj, "5", 2.0)
        b0 = _val(obj, "6", 0.0)
        q = _val(obj, "9", 1.0)
        mu0 = _val(obj, "3")
        mag = _mu_to_mag(
            mu0, _sb_factor_ferrer(r_out, q * r_out, a0, b0),
            zp, plate_scale,
        )
        out["mag"] = _P(mag, _free(obj, "3"), mag - mm, mag + mm)
        out["rout"] = _size(r_out, _free(obj, "4"), sf)
        out["rout_b"] = q_times("rout")
        a = a0
        b = b0
        out["alpha"] = _P(a, _free(obj, "5"), max(0.1, a / 2.0), 2.0 * a)
        out["beta"] = _P(
            b, _free(obj, "6"), 0.0, min(1.95, max(2.0 * b, b + 0.5))
        )
        out["angle"] = angle_p()
        return "Ferrer", out
    if kind == "edgedisk":
        mu0 = _val(obj, "3")
        hs = _val(obj, "4")  # GALFIT: 4) scale height, 5) scale length
        rs = _val(obj, "5")
        mag = _mu_to_mag(
            mu0, 2.0 * np.pi * rs * hs, zp, plate_scale
        )
        out["mag"] = _P(mag, _free(obj, "3"), mag - mm, mag + mm)
        out["hs"] = _size(hs, _free(obj, "4"), sf)
        out["rs"] = _size(rs, _free(obj, "5"), sf)
        out["angle"] = angle_p()
        return "EdgeDisk", out
    warnings.warn(
        f"GALFIT object type {obj.kind!r} is not importable — skipped"
    )
    return None


def _shape_params(obj, margins):
    """Hidden-parameter table (C0, Fourier, bending, rotation)."""
    out = {}
    am = margins["angle"]
    if "C0" in obj.params:
        v = _val(obj, "C0")
        # Margin floor: for GALFIT values in the reliable regime
        # (v >= -1.2) keep the generated prior above -1.45 so the
        # extreme-disky build warning (flux normalization errors grow
        # to ~4x by c0=-1.8, see components._register_shape_attrs)
        # only fires when the GALFIT fit itself sits in that regime.
        lo_floor = -1.9 if v < -1.2 else -1.45
        out["c0"] = _P(
            v, _free(obj, "C0"), max(lo_floor, v - 1.0), v + 1.0
        )
    for m in (1, 2, 3, 4):
        key = f"F{m}"
        if key not in obj.params:
            continue
        vals, _togs = obj.params[key]
        amp = vals[0]
        phi = vals[1] if len(vals) > 1 else 0.0
        out[f"f{m}"] = _P(
            amp, _free(obj, key, 0),
            max(-0.9, amp - 0.3), min(0.9, amp + 0.3),
        )
        out[f"f{m}_phi"] = _P(
            phi, _free(obj, key, 1), phi - am, phi + am
        )
    for m in (1, 2, 3):
        key = f"B{m}"
        if key in obj.params:
            v = _val(obj, key)
            w = max(0.1, 2.0 * abs(v))
            out[f"b{m}"] = _P(v, _free(obj, key), v - w, v + w)
    if "R0" in obj.params:
        ramp = obj.params["R0"][0][0]
        if ramp != "power":
            warnings.warn(
                f"GALFIT {ramp!r} spiral ramp is not supported (only "
                "'power') — rotation parameters skipped"
            )
        else:
            sf = margins["size_factor"]
            rot_ang = _val(obj, "R3", 0.0)
            rot_out = _val(obj, "R2", 1.0)
            out["rot_ang"] = _P(
                rot_ang, _free(obj, "R3"), rot_ang - 180.0,
                rot_ang + 180.0,
            )
            out["rot_out"] = _size(rot_out, _free(obj, "R2"), sf)
            r_in = _val(obj, "R1", None)
            if r_in is not None and r_in > 0:
                out["rot_in"] = _size(r_in, _free(obj, "R1"), sf)
            p = _val(obj, "R4", None)
            if p is not None:
                out["rot_pow"] = _P(
                    p, _free(obj, "R4"), max(0.05, p / 2.0),
                    max(0.2, 2.0 * p),
                )
            for k in ("R9", "R10"):
                if k in obj.params and _val(obj, k, 0.0) != 0.0:
                    warnings.warn(
                        f"GALFIT spiral projection {k}) is not "
                        "supported — imported spiral is in-plane"
                    )
    return out


_DEFAULT_MARGINS = {
    # half-width of the Uniform prior around the GALFIT value
    "position": 5.0,  # px, each coordinate
    "mag": 3.0,  # mag
    "size_factor": 3.0,  # sizes span [v/f, v*f]
    "angle": 45.0,  # deg (also Fourier/spiral phases)
}


def _build_tables(source, margins=None):
    model = parse_feedme(source)
    mg = dict(_DEFAULT_MARGINS)
    if margins:
        unknown = set(margins) - set(mg)
        if unknown:
            raise ValueError(f"unknown margin keys: {sorted(unknown)}")
        mg.update(margins)
    zp = model.mag_zeropoint
    ps = model.plate_scale
    needs_sb = any(
        o.kind in ("king", "nuker", "edgedisk", "ferrer")
        for o in model.objects
    )
    if needs_sb and (zp is None or ps is None):
        raise ValueError(
            "king/nuker/edgedisk/ferrer are surface-brightness "
            "parameterized in GALFIT: the feedme must carry J) "
            "zeropoint and K) plate scale for the exact mu -> "
            "total-mag conversion"
        )
    tables = []
    for gf_num, obj in enumerate(model.objects, start=1):
        res = _obj_params(obj, zp, ps, mg)
        if res is None:
            continue
        cls, params = res
        if cls not in ("Sky", "PointSource", "EdgeDisk"):
            params.update(_shape_params(obj, mg))
        elif any(
            k in obj.params
            for k in ("C0", "F1", "F2", "F3", "F4", "B1", "B2", "B3")
        ):
            warnings.warn(
                f"GALFIT {obj.kind}: hidden shape parameters are not "
                "applicable to this component type — skipped"
            )
        # Renderer-support clamping (nuker gamma <= 1.95, beta >= 2.05,
        # c0 >= -1.9, ...) can produce bounds that EXCLUDE the GALFIT
        # value itself — the generated Uniform then silently cannot
        # reach GALFIT's solution.  The value is unsupported by the
        # renderer anyway: clamp it into the support and say so.
        for attr, p in params.items():
            if (
                isinstance(p, _P)
                and np.all(np.isfinite([p.value, p.lo, p.hi]))
                and not (p.lo <= p.value <= p.hi)
            ):
                clamped = min(max(p.value, p.lo), p.hi)
                warnings.warn(
                    f"GALFIT {obj.kind} {attr}: value {p.value:g} lies "
                    "outside this renderer's supported range — prior "
                    f"bounds [{p.lo:g}, {p.hi:g}], value clamped to "
                    f"{clamped:g}"
                )
                p.value = clamped
        # gf_num = the object's 1-based position in the feedme — the
        # numbering GALFIT constraint files use
        tables.append((gf_num, cls, params))
    return model, tables


@dataclass
class GalfitConstraint:
    """One parsed GALFIT constraint-file line."""

    comps: List[int]
    par: str
    kind: str  # 'offset' | 'ratio' | 'abs_range' | 'rel_range'
    lo: float = 0.0
    hi: float = 0.0


def parse_constraints(source) -> List[GalfitConstraint]:
    """Parse a GALFIT parameter-constraint file (the ``G)`` input).

    Grammar (GALFIT EXAMPLE.CONSTRAINTS): each line is a component
    spec, a parameter name, then either ``offset`` / ``ratio``
    (couple components at their initial offset/ratio), ``lo to hi``
    (absolute range) or ``lo hi`` (range relative to the input
    value).  Component specs: ``2`` one component, ``2_1`` a coupled
    pair, ``2/1`` a ratio pair.
    """
    if "\n" not in source and "\0" not in source:
        try:
            with open(source) as fh:
                source = fh.read()
        except OSError as err:
            raise ValueError(
                f"not constraint text and not a readable path: {err}"
            ) from None
    out = []
    for raw in source.splitlines():
        body = raw.split("#", 1)[0].strip()
        if not body:
            continue
        toks = body.split()
        if len(toks) < 3:
            warnings.warn(f"constraint line {raw!r}: too few fields")
            continue
        cspec, par = toks[0], toks[1].lower()
        comps = [int(c) for c in re.split(r"[_/]", cspec)]
        rest = [t.lower() for t in toks[2:]]
        if rest[0] in ("offset", "ratio"):
            out.append(GalfitConstraint(comps, par, rest[0]))
        elif "to" in rest:
            i = rest.index("to")
            out.append(GalfitConstraint(
                comps, par, "abs_range",
                float(rest[i - 1]), float(rest[i + 1]),
            ))
        else:
            out.append(GalfitConstraint(
                comps, par, "rel_range", float(rest[0]), float(rest[1])
            ))
    return out


_SIZE_ATTR = {
    "Sersic": "reff", "ExpDisk": "reff", "DeVaucouleurs": "reff",
    "Gaussian": "reff", "Moffat": "fwhm", "King": "rc",
    "Ferrer": "rout", "Nuker": "rb", "EdgeDisk": "rs",
}
# GALFIT constraint sizes are in the feedme's own parameterization:
# expdisk ranges are on the scale length, gaussian on the FWHM
_SIZE_CONV = {"ExpDisk": _KAPPA_N1, "Gaussian": 0.5}


def _constraint_attr(cls, par):
    """(attr, value-conversion fn) for a constraint par name, or
    (None, reason) when inexpressible."""
    if par in ("x", "y"):
        return "xy", None
    if par == "mag":
        return "mag", None
    if par in ("re", "rs", "rc", "rb", "rout", "fwhm", "4"):
        conv = _SIZE_CONV.get(cls, 1.0)
        return _SIZE_ATTR.get(cls), (lambda v: v * conv)
    if par in ("n", "index"):
        return "index", None
    if par == "pa":
        return "angle", (lambda v: v + 90.0)
    if par == "q":
        return None, (
            "axis-ratio constraints do not map onto the semi-minor-"
            "size parameterization"
        )
    return par, None  # alpha/beta/gamma/rt/c0/f1/... pass through


def _apply_constraints(tables, cons):
    """Fold constraint-file lines into the parameter tables.

    Single-component ranges tighten the free parameter's prior bounds
    (absolute ranges replace them; relative ranges are value+lo..hi).
    Zero-offset / unit-ratio couples become exact ties
    (:class:`~psfmc_tpu_torch.models.components.Tied` — same slot, no extra
    parameter).  Everything else GALFIT's grammar allows (nonzero
    offsets, non-unit ratios, pair ranges) has no exact equivalent
    here and warns.
    """
    by_num = {num: (cls, params) for num, cls, params in tables}
    # collect x/y pair-offsets: tying xy ties BOTH coordinates
    xy_pairs = {}
    for c in cons:
        if len(c.comps) == 2 and c.par in ("x", "y") and c.kind in (
            "offset", "ratio"
        ):
            xy_pairs.setdefault(tuple(sorted(c.comps)), set()).add(c.par)

    def warn(c, why):
        warnings.warn(
            f"constraint {'_'.join(map(str, c.comps))} {c.par} "
            f"{c.kind}: {why}"
        )

    seen_pairs = set()
    for c in cons:
        missing = [n for n in c.comps if n not in by_num]
        if missing:
            warn(c, f"unknown/unimported component {missing}")
            continue
        if len(c.comps) == 1:
            cls, params = by_num[c.comps[0]]
            if c.kind in ("offset", "ratio"):
                warn(c, "needs two components")
                continue
            attr, conv = _constraint_attr(cls, c.par)
            if attr is None:
                warn(c, conv)
                continue
            if attr not in params:
                warn(c, f"{cls} has no such parameter")
                continue
            p = params[attr]
            if isinstance(p, tuple) and p and isinstance(p[0], str):
                warn(c, "parameter is already tied — range ignored "
                        "(bound the tie's target instead)")
                continue
            if attr == "xy":
                value, is_free, lo, hi = p
                if not is_free:
                    warn(c, "parameter is fixed in the feedme")
                    continue
                i = 0 if c.par == "x" else 1
                if c.kind == "abs_range":
                    lo[i], hi[i] = c.lo - 1.0, c.hi - 1.0  # 1-based
                else:
                    lo[i] = value[i] + c.lo
                    hi[i] = value[i] + c.hi
                params[attr] = (value, is_free, lo, hi)
                continue
            if not p.free:
                warn(c, "parameter is fixed in the feedme")
                continue
            if c.kind == "abs_range":
                lo, hi = c.lo, c.hi
                if conv is not None:
                    lo, hi = conv(lo), conv(hi)
                if cls in ("King", "Ferrer", "Nuker", "EdgeDisk") and (
                    c.par == "mag"
                ):
                    warn(c, "absolute mu ranges are not converted — "
                            "use a relative range")
                    continue
            else:  # relative to the (converted) input value
                scale = conv(1.0) - conv(0.0) if conv is not None else 1.0
                lo = p.value + c.lo * scale
                hi = p.value + c.hi * scale
            if lo >= hi:
                warn(c, f"empty range [{lo}, {hi}]")
                continue
            params[attr] = _P(
                min(max(p.value, lo), hi), True, lo, hi
            )
            continue

        # pair/group constraint: expressible exactly only as an
        # equality tie — and only the offset/ratio couple forms ARE
        # equality couples; a pair RANGE (difference/ratio within
        # bounds) has no exact analogue even when the values coincide.
        # GALFIT's grammar allows couples of ANY length ('3_2_1 mag
        # offset'): every later component ties to the first.
        if c.kind not in ("offset", "ratio"):
            warn(c, "pair ranges (difference/ratio bounds) have no "
                    "exact equivalent here")
            continue
        a, *rest = sorted(c.comps)
        if c.par in ("x", "y"):
            key = tuple(sorted(c.comps))
            if key in seen_pairs:
                continue
            seen_pairs.add(key)
            if xy_pairs.get(key) == {"x"} or xy_pairs.get(
                key
            ) == {"y"}:
                warn(c, "only one coordinate coupled — tying BOTH "
                        "(xy shares one slot pair here)")
            if "xy" not in by_num[a][1]:
                warn(c, f"component {a} has no position (sky?) — "
                        "cannot couple x/y")
                continue
            va = by_num[a][1]["xy"][0]
            if isinstance(va, str):  # already a tie from another line
                warn(c, f"component {a} position is already tied — "
                        "chain the couple to the tie's target instead")
                continue
            for b in rest:
                if "xy" not in by_num[b][1]:
                    warn(c, f"component {b} has no position (sky?) — "
                            "skipped in the couple")
                    continue
                vb = by_num[b][1]["xy"][0]
                if isinstance(vb, str):
                    warn(c, f"component {b} position is already tied")
                    continue
                if not np.allclose(va, vb, atol=1e-6):
                    warn(c, f"initial positions differ ({va} vs {vb}):"
                            " only zero-offset couples are exact ties")
                    continue
                by_num[b][1]["xy"] = ("tie", a, "xy")
            continue
        cls_a, params_a = by_num[a]
        attr_a, _ = _constraint_attr(cls_a, c.par)
        if attr_a is None:
            warn(c, "unsupported parameter for coupling")
            continue
        if attr_a not in params_a or not isinstance(
            params_a[attr_a], _P
        ):
            warn(c, f"component {a} lacks the parameter (or it is "
                    "already tied)")
            continue
        va = params_a[attr_a].value
        for b in rest:
            cls_b, params_b = by_num[b]
            attr_b, _ = _constraint_attr(cls_b, c.par)
            if attr_b is None:
                warn(c, "unsupported parameter for coupling")
                continue
            if attr_b not in params_b or not isinstance(
                params_b[attr_b], _P
            ):
                warn(c, f"component {b} lacks the parameter (or it "
                        "is already tied)")
                continue
            vb = params_b[attr_b].value
            if not np.isclose(va, vb, atol=1e-6):
                warn(c, f"initial values differ ({va:.4g} vs {vb:.4g})"
                        ": only zero-offset/unit-ratio couples are "
                        "exact ties")
                continue
            params_b[attr_b] = ("tie", a, attr_a)
    return tables


def _load_feedme_constraints(source, model, constraints):
    """Resolve the ``constraints=`` argument (or the feedme's ``G)``
    entry when the feedme was given as a path)."""
    if constraints is None:
        g = model.header.get("G", "")
        if g and g.lower() not in ("none", ""):
            import os

            base = (
                os.path.dirname(os.path.abspath(source))
                if "\n" not in source else "."
            )
            path = g if os.path.isabs(g) else os.path.join(base, g)
            if os.path.exists(path):
                return parse_constraints(path)
            warnings.warn(
                f"feedme names constraint file G) {g!r} but it was "
                "not found — pass constraints= explicitly"
            )
        return []
    if isinstance(constraints, (list, tuple)):
        return list(constraints)
    return parse_constraints(constraints)


def components_from_feedme(source, margins=None, priors="uniform",
                           constraints=None):
    """Build live psfMC components from a GALFIT feedme.

    :param source: feedme text or a path to the file.
    :param margins: optional overrides of the free-parameter prior
        half-widths — keys ``position`` (px), ``mag`` (mag),
        ``size_factor`` (sizes span ``[v/f, v*f]``), ``angle`` (deg).
    :param priors: ``'uniform'`` (default) gives every free parameter
        (fit toggle 1) a Uniform prior with those margins;
        ``'fixed'`` imports everything as constants (render-parity
        checks, or a MAP starting point).
    :param constraints: GALFIT parameter-constraint file (path, text,
        or a pre-parsed list): single-component ranges tighten the
        prior bounds, zero-offset/unit-ratio couples become exact
        :class:`~psfmc_tpu_torch.models.components.Tied` links.  When
        omitted and the feedme's ``G)`` entry names a findable file,
        it is loaded automatically.
    :returns: component list ready for
        ``MultiComponentModel([Configuration(...), *components])`` —
        the data inputs stay yours to declare (GALFIT has no PSF
        uncertainty input, so its feedme cannot populate
        ``psfivm_files``).
    """
    from .. import distributions as D
    from ..models import components as C
    from ..models.components import Tied

    if priors not in ("uniform", "fixed"):
        raise ValueError(f"priors must be 'uniform'|'fixed': {priors!r}")
    model, tables = _build_tables(source, margins)
    cons = _load_feedme_constraints(source, model, constraints)
    if cons:
        tables = _apply_constraints(tables, cons)
    out = []
    by_num = {}
    for gf_num, cls_name, params in tables:
        kwargs = {}
        for attr, p in params.items():
            if isinstance(p, tuple) and isinstance(p[0], str):
                kwargs[attr] = Tied(by_num[p[1]], p[2])
            elif attr == "xy":
                value, is_free, lo, hi = p
                if is_free and priors == "uniform":
                    kwargs["xy"] = D.Uniform(loc=lo, scale=hi - lo)
                else:
                    kwargs["xy"] = value
            elif p.free and priors == "uniform":
                kwargs[attr] = D.Uniform(loc=p.lo, scale=p.hi - p.lo)
            else:
                kwargs[attr] = p.value
        if cls_name not in ("Sky", "PointSource"):
            kwargs["angle_degrees"] = True
        comp = getattr(C, cls_name)(**kwargs)
        by_num[gf_num] = comp
        out.append(comp)
    return out


def _fmt(v):
    if isinstance(v, np.ndarray):
        return "[" + ", ".join(f"{float(x):g}" for x in v) + "]"
    return f"{float(v):g}"


def feedme_to_model_source(source, margins=None, constraints=None):
    """GALFIT feedme -> psfMC model-file text (the DSL the parser runs).

    The recommended import path: review the generated priors, add the
    ``Configuration`` block (obs/ivm/psf/psfivm files), then fit with
    ``model_galaxy_mcmc``.  Free GALFIT parameters appear as
    ``Uniform`` priors; fixed ones as plain constants; constraint-file
    equality couples (see :func:`parse_constraints`) appear as
    ``Tied(...)`` references — components are emitted as named
    assignments (``c1 = Sersic(...)``), which the model-file DSL
    collects, so ties can name their target.
    """
    model, tables = _build_tables(source, margins)
    cons = _load_feedme_constraints(source, model, constraints)
    if cons:
        tables = _apply_constraints(tables, cons)
    extras = ""
    notes = []
    try:
        e = int(float((model.header.get("E") or "1").split()[0]))
    except ValueError:
        e = 1
    if e > 1:
        # GALFIT's E) PSF fine-sampling factor maps 1:1 onto
        # Configuration(psf_oversample=...)
        extras += f", psf_oversample={e}"
    # I) convolution box: GALFIT convolves each component over an
    # I)-sized box, so model flux from up to half the box beyond the
    # fit region scatters in.  Configuration(conv_pad=P) reproduces
    # that headroom exactly — render + convolve on an obs+2P grid,
    # crop back — so the conversion is P = ceil(max(box)/2).  (This
    # errs generous: GALFIT's box is per-component and also a speed
    # knob; shrink conv_pad if your sources sit well inside the frame.)
    i_body = model.header.get("I")
    if i_body:
        try:
            dims = [float(t) for t in i_body.split()[:2]]
            pad = int(np.ceil(max(dims) / 2.0))
        except (ValueError, IndexError):
            pad = 0
        if pad > 0:
            extras += f", conv_pad={pad}"
            notes.append(
                f"# GALFIT I) convolution box {i_body.split('#')[0].strip()}"
                f" -> conv_pad={pad} (= ceil(box/2): flux from that far"
            )
            notes.append(
                "#   beyond the frame is convolved instead of wrapping;"
                " reduce it to trade edge fidelity for speed)"
            )
    # H) fit region: GALFIT fits only this sub-window — there is no
    # in-framework crop knob (the obs/ivm arrays you pass ARE the fit
    # region), so carry the intent as an explicit cutout note.
    h_body = model.header.get("H")
    if h_body:
        try:
            xmin, xmax, ymin, ymax = [
                int(float(t)) for t in h_body.split()[:4]
            ]
            notes.append(
                f"# GALFIT H) fit region x:{xmin}-{xmax} y:{ymin}-"
                f"{ymax} (1-based, inclusive): crop the inputs to it"
            )
            notes.append(
                f"#   first, e.g. obs = full_obs[{ymin - 1}:{ymax}, "
                f"{xmin - 1}:{xmax}] (same for the IVM and mask)"
            )
        except (ValueError, IndexError):
            pass
    lines = [
        "# Generated from a GALFIT feedme by psfmc_tpu_torch.io.galfit",
        "# Review the prior widths: GALFIT files carry starting",
        "# values, not prior ranges.",
        "",
        "# Configuration(obs_file=..., obsivm_file=..., psf_files=...,",
        f"#     psfivm_files=..., mag_zeropoint={model.mag_zeropoint},",
        f"#     mask_file=...{extras})",
        *notes,
        "",
    ]
    for gf_num, cls_name, params in tables:
        args = []
        for attr, p in params.items():
            if isinstance(p, tuple) and isinstance(p[0], str):
                args.append(f"{attr}=Tied(c{p[1]}, '{p[2]}')")
            elif attr == "xy":
                value, is_free, lo, hi = p
                if is_free:
                    args.append(
                        f"xy=Uniform(loc={_fmt(lo)}, "
                        f"scale={_fmt(hi - lo)})"
                    )
                else:
                    args.append(f"xy={_fmt(value)}")
            elif p.free:
                args.append(
                    f"{attr}=Uniform(loc={_fmt(p.lo)}, "
                    f"scale={_fmt(p.hi - p.lo)})"
                )
            else:
                args.append(f"{attr}={_fmt(p.value)}")
        if cls_name not in ("Sky", "PointSource"):
            args.append("angle_degrees=True")
        # assignment + bare mention: the DSL collects only bare
        # expressions (assignment alone would NOT add the component),
        # and the name lets Tied(...) reference it
        lines.append(f"c{gf_num} = {cls_name}({', '.join(args)})")
        lines.append(f"c{gf_num}")
    return "\n".join(lines) + "\n"


def _mag_to_mu(mag, factor, zp, plate_scale):
    """Inverse of :func:`_mu_to_mag`: total magnitude -> GALFIT anchor
    surface brightness (mag/arcsec^2)."""
    px_area = plate_scale[0] * plate_scale[1]
    counts_px = 10.0 ** (-0.4 * (mag - zp)) / factor
    return zp - 2.5 * np.log10(counts_px / px_area)


_EXPORT_SHAPE = (
    ("c0", "C0"), ("b1", "B1"), ("b2", "B2"), ("b3", "B3"),
)


def results_to_feedme(model, database=None, plate_scale=None,
                      mag_zeropoint=None):
    """Export a fitted (or built) model back to GALFIT feedme text.

    The reverse of :func:`components_from_feedme`, closing the
    round trip with GALFIT-based pipelines: positions go back to
    1-based, angles to GALFIT PA (psfMC angle - 90), ``ExpDisk``
    half-light radius back to a scale length, ``Gaussian`` ``reff``
    back to FWHM, semi-minor sizes back to axis ratios ``q``, and the
    SB-parameterized families back to their anchor surface
    brightnesses (exact inverse of the import conversion).

    :param model: a ``MultiComponentModel`` (``Configuration`` and
        ``PSFSelector`` are skipped — GALFIT's control header is left
        as comments for you to fill in), or a bare component list
        (then ``mag_zeropoint`` is required when SB families are
        present).
    :param database: optional trace database — stochastic parameters
        export their posterior MEAN (a plain mean: multimodal or
        circular-phase posteriors deserve a look at the corner plot
        first, not a feedme).  Without it, priors export their current
        ``.value`` — which right after model construction is the
        prior's median in this package (the JAX package draws one): pass
        a database, or set parameter values first, to export a fit.
    :param plate_scale: (dx, dy) arcsec/px for the ``K)`` entry and
        the SB conversions; defaults to the observation WCS pixel
        scale when the model carries one.
    :returns: feedme text (write it wherever GALFIT expects it).
    """
    comps = getattr(model, "components", model)
    zp = mag_zeropoint
    if zp is None:
        spec = getattr(model, "spec", None)
        zp = float(spec.mag_zeropoint) if spec is not None else None
    if plate_scale is None:
        hdr = getattr(model, "obs_header", None)
        if hdr is not None:
            try:
                from .wcs import MiniWCS, proj_plane_pixel_area

                area = proj_plane_pixel_area(MiniWCS(hdr)) * 3600.0**2
                plate_scale = (np.sqrt(area), np.sqrt(area))
            except (KeyError, ValueError):
                plate_scale = None

    means = None
    if database is not None:
        from ..analysis.statistics import summary

        if isinstance(database, str):
            from ..database import load_database

            database = load_database(database)
        means = {k: v["mean"] for k, v in summary(database).items()}
        # prior .name is only assigned at spec build — a freshly
        # parsed component list has empty names, which would silently
        # fall back to construction-time .value instead of the
        # posterior mean.  Assign the canonical layout names (file
        # order minus Configuration, alphabetical within component —
        # the same convention spec.py uses) when they are missing.
        named = [
            c for c in comps
            if type(c).__name__ not in ("Configuration", "PSFSelector")
        ]
        if any(
            not getattr(p, "name", "")
            for c in named for p in c._priors.values()
        ):
            for count, c in enumerate(named):
                c.update_stochastic_names(count=count)

    def prior_value(comp, attr):
        prior = comp._priors[attr]
        if means is not None:
            name = getattr(prior, "name", None)
            if np.asarray(prior.value).size == 2:
                k0, k1 = f"{name}_0", f"{name}_1"
                if k0 in means:
                    return np.array([means[k0], means[k1]]), 1
            elif name in means:
                return means[name], 1
        return np.asarray(prior.value, np.float64), 1

    def value(comp, attr):
        # Tied attributes live in _constants: resolve to the tie
        # OWNER's slot so a database export writes the owner's
        # posterior mean and free-toggle — dereferencing the Tied via
        # getattr would read the owner prior's construction-time
        # .value, silently breaking the exactly-coupled geometry in
        # the exported feedme.
        from ..models.components import Tied

        tie = comp.__dict__.get("_tied_offsets", {}).get(attr)
        if tie is not None:
            # offset-tie: this attr's prior IS the registration
            # offset — the absolute exported value is owner + offset
            base, _t = value(tie.component, tie.attr)
            off, _t2 = prior_value(comp, attr)
            return (
                np.asarray(base, np.float64)
                + np.asarray(off, np.float64),
                1,
            )
        const = comp.__dict__.get("_constants", {}).get(attr)
        if isinstance(const, Tied):
            return value(const.component, const.attr)
        if attr in comp._priors:
            return prior_value(comp, attr)
        return np.asarray(getattr(comp, attr), np.float64), 0

    def angle_gf(comp):
        v, t = value(comp, "angle")
        if not getattr(comp, "angle_degrees", False):
            v = np.rad2deg(v)
        return float(v) - 90.0, t

    def need_scale():
        if zp is None or plate_scale is None:
            raise ValueError(
                "exporting king/nuker/ferrer/edgedisk needs the "
                "zeropoint and plate scale (GALFIT parameterizes them "
                "by surface brightness): pass mag_zeropoint= / "
                "plate_scale= or use a model with a WCS header"
            )

    lines = [
        "# Generated by psfmc_tpu_torch.io.galfit.results_to_feedme",
        "# A) ... input image    B) ... output    D) ... psf",
        f"J) {zp if zp is not None else 26.0:.4f}",
    ]
    if plate_scale is not None:
        lines.append(f"K) {plate_scale[0]:.4f} {plate_scale[1]:.4f}")
    lines.append("")

    def pline(key, vals, togs, comment=""):
        vs = " ".join(f"{float(v):.4f}" for v in np.atleast_1d(vals))
        ts = " ".join(str(int(t)) for t in np.atleast_1d(togs))
        pad = "" if not comment else f"    # {comment}"
        lines.append(f"{key:>3}) {vs} {ts}{pad}")

    def shape_lines(comp):
        for attr, key in _EXPORT_SHAPE:
            if comp._has(attr):
                v, t = value(comp, attr)
                pline(key, v, t)
        for m in (1, 2, 3, 4):
            if comp._has(f"f{m}"):
                a, ta = value(comp, f"f{m}")
                p, tp = (
                    value(comp, f"f{m}_phi")
                    if comp._has(f"f{m}_phi") else (0.0, 0)
                )
                pv = float(p)
                if not getattr(comp, "angle_degrees", False):
                    pv = float(np.rad2deg(pv))
                pline(f"F{m}", [float(a), pv], [ta, tp],
                      "azimuthal fourier mode")
        if comp._has("rot_ang"):
            lines.append(" R0) power")
            for attr, key in (
                ("rot_in", "R1"), ("rot_out", "R2"),
                ("rot_ang", "R3"), ("rot_pow", "R4"),
            ):
                if comp._has(attr):
                    v, t = value(comp, attr)
                    # R3 is an angle: GALFIT fields are degrees, so a
                    # radians-mode component converts like angle/phases
                    if attr == "rot_ang" and not getattr(
                        comp, "angle_degrees", False
                    ):
                        v = np.rad2deg(v)
                    pline(key, v, t)

    n_exported = 0
    for comp in comps:
        kind = type(comp).__name__
        if kind in ("Configuration", "PSFSelector"):
            continue
        if kind not in (
            "Sky", "PointSource", "Sersic", "ExpDisk", "DeVaucouleurs",
            "Gaussian", "Moffat", "King", "Ferrer", "Nuker", "EdgeDisk",
        ):
            warnings.warn(
                f"{kind} has no GALFIT equivalent — skipped in the "
                "feedme export"
            )
            continue
        n_exported += 1
        if kind == "Sky":
            lines.append(" 0) sky")
            v, t = value(comp, "adu")
            pline("1", v, t, "sky background")
            for attr, key in (("dx", "2"), ("dy", "3")):
                if comp._has(attr):
                    v, t = value(comp, attr)
                    pline(key, v, t)
            lines.append("")
            continue

        xy, t_xy = value(comp, "xy")
        gf_kind = {
            "PointSource": "psf", "Sersic": "sersic",
            "ExpDisk": "expdisk", "DeVaucouleurs": "devauc",
            "Gaussian": "gaussian", "Moffat": "moffat", "King": "king",
            "Ferrer": "ferrer", "Nuker": "nuker", "EdgeDisk": "edgedisk",
        }[kind]
        lines.append(f" 0) {gf_kind}")
        pline("1", np.asarray(xy) + 1.0, [t_xy, t_xy], "position x, y")
        mag, t_mag = value(comp, "mag")

        if kind == "PointSource":
            pline("3", mag, t_mag, "total magnitude")
        elif kind in ("Sersic", "ExpDisk", "DeVaucouleurs", "Gaussian"):
            pline("3", mag, t_mag, "total magnitude")
            reff, t_r = value(comp, "reff")
            reff_b, t_rb = value(comp, "reff_b")
            if kind == "ExpDisk":
                pline("4", reff / _KAPPA_N1, t_r, "scale length Rs")
            elif kind == "Gaussian":
                pline("4", 2.0 * reff, t_r, "FWHM")
            else:
                pline("4", reff, t_r, "R_e")
            if kind == "Sersic":
                n, t_n = value(comp, "index")
                pline("5", n, t_n, "sersic index")
            pline("9", reff_b / reff, max(t_rb, t_r), "axis ratio q")
            a, t_a = angle_gf(comp)
            pline("10", a, t_a, "position angle")
            shape_lines(comp)
        elif kind == "Moffat":
            pline("3", mag, t_mag, "total magnitude")
            fw, t_f = value(comp, "fwhm")
            fw_b, t_fb = value(comp, "fwhm_b")
            n, t_n = value(comp, "index")
            pline("4", fw, t_f, "FWHM")
            pline("5", n, t_n, "powerlaw beta")
            pline("9", fw_b / fw, max(t_fb, t_f), "axis ratio q")
            a, t_a = angle_gf(comp)
            pline("10", a, t_a, "position angle")
            shape_lines(comp)
        elif kind == "King":
            need_scale()
            rc, t_rc = value(comp, "rc")
            rc_b, t_rcb = value(comp, "rc_b")
            rt, t_rt = value(comp, "rt")
            al, t_al = value(comp, "alpha")
            mu = _mag_to_mu(
                mag, _sb_factor_king(rc, rc_b, rt, al), zp, plate_scale
            )
            pline("3", mu, t_mag, "mu(0) mag/arcsec^2")
            pline("4", rc, t_rc, "Rc")
            pline("5", rt, t_rt, "Rt")
            pline("6", al, t_al, "alpha")
            pline("9", rc_b / rc, max(t_rcb, t_rc), "axis ratio q")
            a, t_a = angle_gf(comp)
            pline("10", a, t_a, "position angle")
            shape_lines(comp)
        elif kind == "Ferrer":
            need_scale()
            ro, t_ro = value(comp, "rout")
            ro_b, t_rob = value(comp, "rout_b")
            al, t_al = value(comp, "alpha")
            be, t_be = value(comp, "beta")
            mu = _mag_to_mu(
                mag, _sb_factor_ferrer(ro, ro_b, al, be), zp, plate_scale
            )
            pline("3", mu, t_mag, "mu(0) mag/arcsec^2")
            pline("4", ro, t_ro, "R_out")
            pline("5", al, t_al, "alpha")
            pline("6", be, t_be, "beta")
            pline("9", ro_b / ro, max(t_rob, t_ro), "axis ratio q")
            a, t_a = angle_gf(comp)
            pline("10", a, t_a, "position angle")
            shape_lines(comp)
        elif kind == "Nuker":
            need_scale()
            rb, t_rb = value(comp, "rb")
            rb_b, t_rbb = value(comp, "rb_b")
            al, t_al = value(comp, "alpha")
            be, t_be = value(comp, "beta")
            ga, t_ga = value(comp, "gamma")
            mu = _mag_to_mu(
                mag, _sb_factor_nuker(rb, rb_b, al, be, ga),
                zp, plate_scale,
            )
            pline("3", mu, t_mag, "mu(Rb) mag/arcsec^2")
            pline("4", rb, t_rb, "Rb")
            pline("5", al, t_al, "alpha")
            pline("6", be, t_be, "beta")
            pline("7", ga, t_ga, "gamma")
            pline("9", rb_b / rb, max(t_rbb, t_rb), "axis ratio q")
            a, t_a = angle_gf(comp)
            pline("10", a, t_a, "position angle")
            shape_lines(comp)
        elif kind == "EdgeDisk":
            need_scale()
            rs, t_rs = value(comp, "rs")
            hs, t_hs = value(comp, "hs")
            mu = _mag_to_mu(
                mag, 2.0 * np.pi * rs * hs, zp, plate_scale
            )
            pline("3", mu, t_mag, "mu(0) mag/arcsec^2")
            pline("4", hs, t_hs, "scale height")
            pline("5", rs, t_rs, "scale length")
            a, t_a = angle_gf(comp)
            pline("10", a, t_a, "position angle")
        lines.append("")
    if n_exported == 0:
        warnings.warn("results_to_feedme: no exportable components")
    return "\n".join(lines) + "\n"
