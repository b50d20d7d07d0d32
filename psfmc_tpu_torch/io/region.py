"""ds9 region file parser + rasterizer (pyregion stand-in).

The reference relies on the optional ``pyregion`` package to turn ds9
region files into fitting masks (reference utils.py:82-103); this module
implements the subset needed natively:

* coordinate systems: ``image``/``physical`` (1-based FITS pixels),
  ``fk5``/``fk4``/``icrs``/``j2000``/``b1950`` (degrees, mapped through
  :class:`MiniWCS`), and ``galactic``/``ecliptic`` (degree longitudes,
  rotated exactly into fk5 first — see :mod:`.wcs`),
* shapes: ``circle``, ``ellipse``, ``box``, ``annulus``, ``point``,
  ``polygon`` (even-odd crossing test over pixel centers), and the
  wedge family ``pie``/``panda``/``epanda``/``bpanda`` (the
  ``nangle``/``nradius`` display-subdivision counts do not change the
  covered area).  Region angles are degrees CCW from the +x pixel
  axis in pixel frames; in sky frames they follow the WCS north
  rotation (the pyregion mapping — identical on north-up images,
  chirality flips ignored like pyregion),
* ds9 ``;`` statement separators (``fk5; circle(...)``) are accepted;
  comments (to end-of-line, property text in ``{}`` guarded) are
  stripped before statement splitting,
* zero-area annotation shapes (``vector``/``text``/``segment``/
  ``compass``/``ruler``/``projection``/``line``) warn and are skipped —
  pyregion's mask filter ignores them too; unsupported AREA shapes and
  frames remain hard errors,
* include/exclude semantics: a leading ``-`` excludes; the inside-mask is
  ``(union of includes) & ~(union of excludes)`` — matching pyregion's
  filter combination, so ``~mask`` is the excluded-pixel map like the
  reference's ``~regfilt.mask(shape)``.

Sizes in sky systems may use ``"`` (arcsec), ``'`` (arcmin) or ``d``/deg
suffixes and are converted to pixels with the WCS pixel scale.
"""
from __future__ import annotations

import re
import warnings

import numpy as np

from .wcs import MiniWCS

__all__ = ["parse_region_file", "region_mask", "RegionShape"]

_SKY_SYSTEMS = {"fk5", "fk4", "icrs", "j2000", "b1950"}
# sky frames whose longitudes are plain degrees (no h:m:s sexagesimal
# hour convention) and need a rotation into fk5 before the WCS
_DEG_SKY_SYSTEMS = {"galactic", "ecliptic"}
_ALL_SKY_SYSTEMS = _SKY_SYSTEMS | _DEG_SKY_SYSTEMS
_PIX_SYSTEMS = {"image", "physical"}
# frames pyregion/astropy convert but this parser does not — a hard
# error, never a silently mis-framed mask
_UNSUPPORTED_SYSTEMS = {
    "linear", "amplifier", "detector", "wcs",
    "wcsa", "wcsb", "wcsc",
}
_SUPPORTED_SHAPES = {
    "circle", "ellipse", "box", "annulus", "point", "polygon",
    "panda", "epanda", "bpanda", "pie",
}
# zero-area display annotations: pyregion's mask filter simply ignores
# these (reference utils.py:93-96), so a mixed annotation+mask file must
# still rasterize — warn-and-skip, never a hard error.  Area shapes
# outside _SUPPORTED_SHAPES stay hard errors (a dropped area shape
# silently changes which pixels constrain the fit; a dropped arrow
# does not).
_ANNOTATION_SHAPES = {
    "vector", "text", "segment", "compass", "ruler", "projection", "line",
}


def _strip_comment(line):
    """Truncate a ds9 line at the first '#'.

    ds9 property comments ('circle(...) # color=red text={a; fig (2)}')
    run to end-of-line; their text may contain ';' and '(' which must
    never reach the statement splitter (a commented-out shape after ';'
    once silently joined the fitting mask — round-4 advisor finding).
    In well-formed ds9 braces only ever appear INSIDE the property
    comment (after its opening '#'), so truncating at the first '#'
    unconditionally is correct — ``text={see #2}`` is already past the
    cut.  Tracking brace depth before the '#' (a previous iteration of
    this function) was wrong: an unclosed '{' ahead of a comment
    suppressed stripping and resurrected commented-out shapes.
    """
    i = line.find("#")
    return line if i < 0 else line[:i]

_SHAPE_RE = re.compile(
    r"^\s*(?P<exclude>-?)\s*(?P<shape>[a-zA-Z]+)\s*\(\s*(?P<args>[^)]*)\)"
)


class RegionShape:
    def __init__(self, shape, params, exclude, system):
        self.shape = shape
        self.params = params  # list of (value, unit) tuples
        self.exclude = exclude
        self.system = system

    def __repr__(self):
        sign = "-" if self.exclude else ""
        return f"{sign}{self.shape}({self.params}) [{self.system}]"


def _parse_size(token):
    token = token.strip()
    m = re.match(r'^([+-]?[\d.eE+-]+)\s*(["\'dr]?|deg)?$', token)
    if not m:
        raise ValueError(f"Cannot parse region token: {token!r}")
    return float(m.group(1)), (m.group(2) or "")


def _parse_coord(token, is_ra=False):
    """Parse a coordinate: plain number or sexagesimal h:m:s / d:m:s."""
    token = token.strip()
    if ":" in token:
        parts = [float(p) for p in token.split(":")]
        sign = -1.0 if token.strip().startswith("-") else 1.0
        mag = abs(parts[0]) + parts[1] / 60.0 + (parts[2] if len(parts) > 2 else 0.0) / 3600.0
        val = sign * mag
        if is_ra:
            val *= 15.0  # hours -> degrees
        return val, "deg"
    return _parse_size(token)


def parse_region_file(path_or_text):
    """Parse a ds9 region file -> list of RegionShape."""
    if "\n" in str(path_or_text) or "(" in str(path_or_text):
        text = str(path_or_text)
    else:
        with open(path_or_text) as f:
            text = f.read()

    system = "image"
    shapes = []
    # ds9 accepts ';' as a statement separator ('fk5; circle(...)' and
    # multiple shapes per line).  Comments run to end-of-line and may
    # themselves contain ';' or '(' — strip them BEFORE splitting so a
    # commented-out shape can never contribute statements.
    lines = [
        seg.strip()
        for raw in text.splitlines()
        for seg in _strip_comment(raw).split(";")
    ]
    for line in lines:
        if not line:
            continue
        if line.startswith("global"):
            continue
        lower = line.lower()
        if lower in _ALL_SKY_SYSTEMS | _PIX_SYSTEMS:
            system = lower
            continue
        if lower in _UNSUPPORTED_SYSTEMS:
            # the reference (via pyregion+astropy) converts these
            # frames; silently reading their coordinates as fk5 or
            # pixels would produce a wrong mask — fail loudly instead
            raise ValueError(
                f"ds9 coordinate system {lower!r} is not supported "
                f"(supported: "
                f"{sorted(_PIX_SYSTEMS | _ALL_SKY_SYSTEMS)}); "
                "convert the region file to fk5/icrs or image "
                "coordinates"
            )
        m = _SHAPE_RE.match(line)
        if not m:
            if "(" in line:
                # a shape-looking line that did not parse must not
                # silently drop out of the mask
                raise ValueError(
                    f"unparseable ds9 region line: {line!r}"
                )
            continue
        shape = m.group("shape").lower()
        if shape in _ANNOTATION_SHAPES:
            warnings.warn(
                f"ds9 annotation shape {shape!r} covers no area and is "
                "ignored for masking (pyregion parity)",
                UserWarning,
                stacklevel=2,
            )
            continue
        if shape not in _SUPPORTED_SHAPES:
            raise ValueError(
                f"ds9 region shape {shape!r} is not supported "
                f"(supported: {sorted(_SUPPORTED_SHAPES)})"
            )
        tokens = [t for t in m.group("args").split(",") if t.strip()]
        params = []
        for i, tok in enumerate(tokens):
            # polygon args are all coordinate pairs (x1,y1,x2,y2,...);
            # other shapes have one leading coordinate pair
            is_coord = i % 2 == 0 if shape == "polygon" else i == 0
            # galactic/ecliptic longitudes are degrees, not hours
            is_ra = is_coord and system in _SKY_SYSTEMS
            params.append(_parse_coord(tok, is_ra=is_ra))
        shapes.append(
            RegionShape(shape, params, exclude=m.group("exclude") == "-", system=system)
        )
    return shapes


def _size_to_pixels(value, unit, wcs):
    if unit == "":
        return value  # already pixels (or degrees treated as px w/o wcs)
    if wcs is None:
        raise ValueError("Region uses sky units but no WCS header available")
    scale_deg = np.sqrt(wcs.pixel_area_deg2())  # deg per pixel (isotropic)
    if unit == '"':
        return value / 3600.0 / scale_deg
    if unit == "'":
        return value / 60.0 / scale_deg
    if unit in ("d", "deg", "r"):
        return value / scale_deg
    raise ValueError(f"Unknown region size unit: {unit!r}")


def _polygon_inside(vertices, xg, yg):
    """Even-odd (crossing-number) point-in-polygon test over a grid.

    ``vertices`` is an (n, 2) array of polygon x,y vertices in pixel
    coordinates.  A pixel center is inside when a ray cast in +x
    crosses an odd number of edges — the same fill rule ds9/pyregion
    use for polygon regions (reference utils.py:82-103 accepts any
    pyregion shape; polygon is the common one for irregular HST masks).
    Vectorized over the whole grid: one boolean xor-accumulate per edge.
    """
    vertices = np.asarray(vertices, dtype=float)
    if vertices.shape[0] < 3:
        raise ValueError("polygon region needs at least 3 vertices")
    inside = np.zeros(xg.shape, dtype=bool)
    x1, y1 = vertices[:, 0], vertices[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    for ax, ay, bx, by in zip(x1, y1, x2, y2):
        # canonical endpoint order: the intersection formula is not
        # FP-symmetric under (a, b) swap, so without this a pixel
        # center within 1 ulp of an edge could flip when the vertex
        # list is traversed in the opposite direction (hypothesis
        # found such a triangle) — the mask must not depend on winding
        if (ay, ax) > (by, bx):
            ax, ay, bx, by = bx, by, ax, ay
        # does the horizontal ray at yg cross this edge?
        crosses = (ay > yg) != (by > yg)
        if not crosses.any():
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = ax + (yg - ay) * (bx - ax) / (by - ay)
        inside ^= crosses & (xg < x_int)
    return inside


def _to_fk5(lon, lat, system):
    """Map a degree pair from the region's sky frame into fk5."""
    if system == "galactic":
        from .wcs import galactic_to_equatorial

        return galactic_to_equatorial(lon, lat)
    if system == "ecliptic":
        from .wcs import ecliptic_to_equatorial

        return ecliptic_to_equatorial(lon, lat)
    return lon, lat


def _angle_in_wedge(theta, a1, a2):
    """CCW wedge containment with wrap: a1 -> a2 counterclockwise.

    a1 == a2 (mod 360) means the full circle, matching ds9's default
    ``panda 0 360``.
    """
    span = (a2 - a1) % 360.0
    if span == 0.0:
        return np.ones_like(theta, dtype=bool)
    return (theta - a1) % 360.0 <= span


# minimum argument counts (ds9 grammar): coordinates + required sizes.
# polygon is validated separately (even count >= 6).
_MIN_SHAPE_ARGS = {
    "circle": 3, "ellipse": 4, "box": 4, "annulus": 4, "point": 2,
    "pie": 4, "panda": 8, "epanda": 10, "bpanda": 10,
}


def _shape_inside(shape, xg, yg, wcs):
    """Boolean inside-map for one shape. xg/yg are 1-based pixel centers."""
    p = shape.params
    need = _MIN_SHAPE_ARGS.get(shape.shape)
    if need is not None and len(p) < need:
        raise ValueError(
            f"{shape.shape} region needs at least {need} arguments, "
            f"got {len(p)}"
        )
    sky = shape.system in _ALL_SKY_SYSTEMS
    if shape.shape == "polygon":
        if len(p) < 6 or len(p) % 2:
            raise ValueError(
                f"polygon region needs an even number of >= 6 coordinates, "
                f"got {len(p)}"
            )
        pairs = [(p[i], p[i + 1]) for i in range(0, len(p), 2)]
        if sky:
            if wcs is None:
                raise ValueError("Sky-coordinate region requires a WCS header")
            verts = [
                wcs.sky_to_pixel(
                    *_to_fk5(px[0], py[0], shape.system)
                )
                for px, py in pairs
            ]
        else:
            verts = [(px[0], py[0]) for px, py in pairs]
        return _polygon_inside(np.asarray(verts), xg, yg)
    ang_off = 0.0
    if sky:
        if wcs is None:
            raise ValueError("Sky-coordinate region requires a WCS header")
        ra, dec = _to_fk5(p[0][0], p[1][0], shape.system)
        cx, cy = wcs.sky_to_pixel(ra, dec)
        sizes = [_size_to_pixels(v, u, wcs) for v, u in p[2:]]
        # plain numbers among the trailing args (angles, counts) must
        # NOT be scaled: keep the raw values alongside
        raw = [v for v, _u in p[2:]]
        # Sky-frame region angles rotate WITH THE SKY: pyregion maps
        # them into the image by the local north rotation (north-up
        # image -> offset 0; it ignores chirality flips, and so do we
        # — reference-path parity).  Measured at the region center.
        pnx, pny = wcs.sky_to_pixel(ra, dec + 1.0 / 3600.0)
        ang_off = (
            np.degrees(np.arctan2(
                float(pny) - float(cy), float(pnx) - float(cx)
            ))
            - 90.0
        )
    else:
        cx, cy = p[0][0], p[1][0]
        sizes = [v for v, _u in p[2:]]
        raw = sizes

    dx = xg - cx
    dy = yg - cy

    # -- composite wedge shapes (ds9 "pie and annulus" family) ----------
    # Angles are degrees CCW from the +x pixel axis in image frames and
    # from the north-rotated reference in sky frames (ang_off above);
    # the n_ang/n_rad division counts only affect ds9's
    # display subdivisions, not the covered area, so the mask is the
    # union: wedge AND (outer region minus inner region).
    if shape.shape == "pie":
        a1, a2 = raw[0] + ang_off, raw[1] + ang_off
        theta = np.degrees(np.arctan2(dy, dx)) % 360.0
        return _angle_in_wedge(theta, a1, a2)
    if shape.shape == "panda":
        a1, a2 = raw[0] + ang_off, raw[1] + ang_off
        r1, r2 = sizes[3], sizes[4]
        if not r2 > 0:
            raise ValueError(
                f"panda region outer radius must be positive, got {r2}"
            )
        if r1 < 0:
            raise ValueError(
                f"panda region inner radius is negative: {r1}"
            )
        if r1 > r2:
            raise ValueError(
                f"panda region inner radius exceeds outer ({r1} > {r2})"
            )
        theta = np.degrees(np.arctan2(dy, dx)) % 360.0
        sq = dx * dx + dy * dy
        return (
            _angle_in_wedge(theta, a1, a2)
            & (sq >= r1 * r1)
            & (sq <= r2 * r2)
        )
    if shape.shape == "epanda":
        # x y a1 a2 nang a_in b_in a_out b_out nrad [rot]
        a1, a2 = raw[0], raw[1]
        ai, bi, ao, bo = sizes[3], sizes[4], sizes[5], sizes[6]
        if not (ao > 0 and bo > 0):
            raise ValueError(
                "epanda region outer semi-axes must be positive, got "
                f"({ao}, {bo})"
            )
        if ai < 0 or bi < 0:
            raise ValueError(
                f"epanda region inner semi-axes are negative: ({ai}, {bi})"
            )
        if ai > ao or bi > bo:
            raise ValueError(
                "epanda region inner semi-axes exceed outer "
                f"(({ai}, {bi}) > ({ao}, {bo}))"
            )
        rot = (raw[8] if len(raw) > 8 else 0.0) + ang_off
        ang = np.deg2rad(rot)
        u = np.cos(ang) * dx + np.sin(ang) * dy
        v = -np.sin(ang) * dx + np.cos(ang) * dy
        # wedge angles rotate with the region (ds9 draws the angular
        # divisions in the rotated frame)
        theta = np.degrees(np.arctan2(v, u)) % 360.0
        with np.errstate(divide="ignore", invalid="ignore"):
            inner = (
                (u / ai) ** 2 + (v / bi) ** 2 <= 1.0
                if ai > 0 and bi > 0
                else np.zeros_like(u, dtype=bool)
            )
        outer = (u / ao) ** 2 + (v / bo) ** 2 <= 1.0
        return _angle_in_wedge(theta, a1, a2) & outer & ~inner
    if shape.shape == "bpanda":
        # x y a1 a2 nang w_in h_in w_out h_out nrad [rot]
        a1, a2 = raw[0], raw[1]
        wi, hi, wo, ho = sizes[3], sizes[4], sizes[5], sizes[6]
        if not (wo > 0 and ho > 0):
            raise ValueError(
                "bpanda region outer width/height must be positive, "
                f"got ({wo}, {ho})"
            )
        if wi < 0 or hi < 0:
            raise ValueError(
                f"bpanda region inner width/height are negative: "
                f"({wi}, {hi})"
            )
        if wi > wo or hi > ho:
            raise ValueError(
                "bpanda region inner width/height exceed outer "
                f"(({wi}, {hi}) > ({wo}, {ho}))"
            )
        rot = (raw[8] if len(raw) > 8 else 0.0) + ang_off
        ang = np.deg2rad(rot)
        u = np.cos(ang) * dx + np.sin(ang) * dy
        v = -np.sin(ang) * dx + np.cos(ang) * dy
        theta = np.degrees(np.arctan2(v, u)) % 360.0
        if wi == 0 or hi == 0:  # zero-area inner box covers nothing
            inner = np.zeros_like(u, dtype=bool)
        else:
            inner = (np.abs(u) <= wi / 2) & (np.abs(v) <= hi / 2)
        outer = (np.abs(u) <= wo / 2) & (np.abs(v) <= ho / 2)
        return _angle_in_wedge(theta, a1, a2) & outer & ~inner
    if shape.shape == "circle":
        if len(sizes) != 1:
            raise ValueError(
                f"circle region takes exactly one radius, got {sizes}"
            )
        r = sizes[0]
        if not r > 0:
            raise ValueError(
                f"circle region radius must be positive, got {r}"
            )
        return dx * dx + dy * dy <= r * r
    if shape.shape == "annulus":
        # ds9 multi-annulus: annulus(x, y, r1, r2, ..., rn) draws
        # contiguous rings; the covered area is r1 <= r <= rn
        radii = sizes  # >= 2 entries by the _MIN_SHAPE_ARGS gate
        if radii[0] < 0:
            raise ValueError(
                f"annulus region inner radius is negative: {radii[0]}"
            )
        if not radii[-1] > 0:
            raise ValueError(
                "annulus region outer radius must be positive, got "
                f"{radii[-1]}"
            )
        if any(a > b for a, b in zip(radii, radii[1:])):
            raise ValueError(
                f"annulus region radii must be non-decreasing, got {radii}"
            )
        r1, r2 = radii[0], radii[-1]
        sq = dx * dx + dy * dy
        return (sq >= r1 * r1) & (sq <= r2 * r2)
    if shape.shape in ("ellipse", "box"):
        # Plain form: (x, y, s1, s2 [, angle]).  ds9 ellipse-annulus /
        # box-annulus: (x, y, s1, s2, s3, s4, ..., [angle]) — pairs of
        # sizes drawing nested outlines; the covered area is between
        # the innermost and outermost.  Trailing arg count odd => last
        # is the rotation angle (raw value, never unit-scaled).
        n = len(sizes)  # >= 2 by the _MIN_SHAPE_ARGS gate
        if n % 2:
            ang_raw, dims = raw[n - 1], sizes[: n - 1]
        else:
            ang_raw, dims = 0.0, sizes
        pairs = [(dims[i], dims[i + 1]) for i in range(0, len(dims), 2)]
        kind = "semi-axes" if shape.shape == "ellipse" else "width/height"
        if pairs[0][0] < 0 or pairs[0][1] < 0:
            raise ValueError(
                f"{shape.shape} region inner {kind} are negative: "
                f"{pairs[0]}"
            )
        if not (pairs[-1][0] > 0 and pairs[-1][1] > 0):
            raise ValueError(
                f"{shape.shape} region outer {kind} must be positive, "
                f"got {pairs[-1]}"
            )
        if any(p[0] > q[0] or p[1] > q[1]
               for p, q in zip(pairs, pairs[1:])):
            raise ValueError(
                f"{shape.shape} region size pairs must be "
                f"non-decreasing, got {pairs}"
            )
        ang = np.deg2rad(ang_raw + ang_off)
        u = np.cos(ang) * dx + np.sin(ang) * dy
        v = -np.sin(ang) * dx + np.cos(ang) * dy

        def _inside(p):
            s1, s2 = p
            if s1 == 0 or s2 == 0:
                # zero-area inner outline covers nothing — without this
                # a zero-width box would still "cover" the line of
                # pixel centers sitting exactly on the region axis
                return np.zeros_like(u, dtype=bool)
            if shape.shape == "ellipse":
                return (u / s1) ** 2 + (v / s2) ** 2 <= 1.0
            return (np.abs(u) <= s1 / 2) & (np.abs(v) <= s2 / 2)

        outer = _inside(pairs[-1])
        if len(pairs) == 1:
            return outer
        return outer & ~_inside(pairs[0])
    if shape.shape == "point":
        return (np.round(xg) == np.round(cx)) & (np.round(yg) == np.round(cy))
    raise ValueError(f"Unsupported region shape: {shape.shape}")


def region_mask(path_or_text, shape, header=None):
    """Rasterize a ds9 region file to an inside-mask of the given shape.

    Returns a boolean array where True = pixel is inside the (combined)
    region — same convention as ``pyregion...get_filter().mask(shape)``.
    """
    shapes = parse_region_file(path_or_text)
    ny, nx = shape
    # 1-based FITS pixel-center coordinates, like pyregion's mask()
    yg, xg = np.mgrid[1 : ny + 1, 1 : nx + 1].astype(float)
    wcs = MiniWCS(header) if header is not None else None

    includes = [s for s in shapes if not s.exclude]
    excludes = [s for s in shapes if s.exclude]

    if includes:
        inside = np.zeros(shape, dtype=bool)
        for s in includes:
            inside |= _shape_inside(s, xg, yg, wcs)
    else:
        inside = np.ones(shape, dtype=bool)
    for s in excludes:
        inside &= ~_shape_inside(s, xg, yg, wcs)
    return inside
