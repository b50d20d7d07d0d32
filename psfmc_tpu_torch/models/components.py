"""Model components (port of ``models/components.py``, single band).

Declaration-time objects with the JAX package's conventions: an
attribute is a prior :class:`~psfmc_tpu_torch.distributions.Distribution`,
a constant or a :class:`Tied` reference to another component's
attribute; a component's parameters are ordered alphabetically by
attribute; trace names are ``{count}_{CompType}_{attr}`` with the FITS
abbreviations; ``xy`` spans two slots.  They are compiled into a static
:class:`~psfmc_tpu_torch.models.spec.ModelSpec` by
:func:`~psfmc_tpu_torch.models.spec.build_model_spec`.

This slice has ``Configuration`` (FITS file names, ``(header, array)``
pairs or arrays, an optional FITS, ds9-region or boolean-array mask,
and the JAX package's likelihood, padding and oversampling options),
``PSFSelector`` (one PSF, or several with a sampled ``DiscreteUniform``
index), ``Sky`` (``adu`` and the tilted-plane ``dx``/``dy``),
``NoiseScale``, ``PointSource``, the render family (``Sersic`` with its
isophote shapes and truncation; ``ExpDisk``, ``DeVaucouleurs`` and
``Gaussian``; ``Moffat``; ``King``, ``Ferrer`` and ``Nuker``;
``EdgeDisk``) and pixel-frame ``Tied`` parameters, offset ties
included.  A ``frame="sky"`` tie belongs to joint multi-band models and
:func:`~psfmc_tpu_torch.models.spec.build_model_spec` raises
``NotImplementedError`` for it.

Each component has the reference's host API: ``get_distribution``,
``num_stochastics``, ``stochastic_names``, ``set_stochastic_values``
(a vector, ``"random"`` or ``"median"``) and ``log_priors`` (scipy at the
current values, with the component's cross-attribute constraints, e.g.
Sersic ``reff >= reff_b``).
"""
from __future__ import annotations

import warnings

import numpy as np

from ..distributions import DiscreteUniform, Distribution
from ..ops.coords import array_coords
from ..io.preprocess import (
    bin_psf,
    calculate_psf_variability,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)

__all__ = [
    "ComponentBase",
    "Sky",
    "NoiseScale",
    "PointSource",
    "Sersic",
    "ExpDisk",
    "DeVaucouleurs",
    "Gaussian",
    "Moffat",
    "EdgeDisk",
    "King",
    "Ferrer",
    "Nuker",
    "Configuration",
    "PSFSelector",
    "Tied",
]


class Tied:
    """Share another component's stochastic attribute.

    ``PointSource(xy=Tied(host, "xy"), ...)`` renders the point source
    from the SAME slot of the parameter vector as its host: the tie is
    exact, costs no parameter and adds no trace column.  A tie to a
    constant resolves to that constant; chains resolve transitively and
    cycles are rejected at spec build.  With ``offset=`` (a prior, ``xy``
    only) the component renders at the tied position plus a free offset
    that takes this attribute's slots and trace column.  ``frame="sky"``
    (the same sky position in another band's pixel frame) is accepted
    here and refused by ``build_model_spec``: it belongs to joint models.
    """

    def __init__(self, component, attr, frame="pixel", offset=None):
        if not isinstance(component, ComponentBase):
            raise TypeError(
                "Tied(component, attr): component must be a model "
                f"component, got {type(component).__name__}"
            )
        if not isinstance(attr, str):
            raise TypeError("Tied(component, attr): attr must be a string")
        if frame not in ("pixel", "sky"):
            raise ValueError(f"Tied frame {frame!r}: expected 'pixel' or 'sky'")
        if frame == "sky" and attr != "xy":
            raise ValueError("frame='sky' ties apply only to 'xy'")
        if offset is not None and not isinstance(offset, Distribution):
            raise TypeError(
                "Tied offset= must be a prior distribution (e.g. "
                "Normal(loc=[0, 0], scale=0.1) for a sub-pixel "
                "registration uncertainty)"
            )
        if offset is not None and attr != "xy":
            raise ValueError("Tied offset= applies only to 'xy'")
        self.component = component
        self.attr = attr
        self.frame = frame
        self.offset = offset


class ComponentBase:
    """Tracks priors vs constants per stochastic attribute."""

    _fits_abbrs = ()
    _stochastic_attrs = ()

    def __init__(self):
        object.__setattr__(self, "_priors", {})
        object.__setattr__(self, "_constants", {})
        object.__setattr__(self, "_tied_offsets", {})

    def __setattr__(self, name, value):
        if name in type(self)._stochastic_attrs:
            self._tied_offsets.pop(name, None)
            if isinstance(value, Tied) and value.offset is not None:
                # the offset prior owns this attribute's slots and column;
                # the tie is composed at spec build
                self._priors[name] = value.offset
                self._constants.pop(name, None)
                self._tied_offsets[name] = value
            elif isinstance(value, Distribution):
                self._priors[name] = value
                self._constants.pop(name, None)
            else:
                self._constants[name] = value
                self._priors.pop(name, None)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        """A stochastic attribute's current value; a (pixel-frame) tie
        reads the component it names, through chains, and a cycle
        raises ``ValueError``."""
        if name.startswith("_"):
            raise AttributeError(name)
        priors = self.__dict__.get("_priors", {})
        constants = self.__dict__.get("_constants", {})
        if name in priors:
            return priors[name].value
        if name not in constants:
            raise AttributeError(name)
        val = constants[name]
        seen = {(id(self), name)}
        while isinstance(val, Tied):
            comp, attr = val.component, val.attr
            if (id(comp), attr) in seen:
                raise ValueError(f"Tied cycle through {type(comp).__name__}.{attr}")
            seen.add((id(comp), attr))
            if attr in comp._priors:
                return comp._priors[attr].value
            val = comp._constants.get(attr)
        return val

    def _has(self, attr):
        return attr in self._priors or attr in self._constants

    def sorted_prior_items(self):
        return sorted(self._priors.items())

    def get_distribution(self, stoch_name):
        """The prior whose trace name is ``stoch_name`` (``KeyError`` unless
        exactly one matches)."""
        matching = [d for d in self._priors.values() if d.name == stoch_name]
        if len(matching) != 1:
            raise KeyError(f"Could not find unique prior with name: {stoch_name}")
        return matching[0]

    def stochastic_lens(self):
        return [np.asarray(p.value).size for _k, p in self.sorted_prior_items()]

    def num_stochastics(self):
        return int(np.sum(self.stochastic_lens(), dtype=int)) if self._priors else 0

    def stochastic_names(self, name_attr="name"):
        return [getattr(p, name_attr) for _k, p in self.sorted_prior_items()]

    def set_stochastic_values(self, param_values="random", random_state=None):
        """Set the priors' current values from a vector (alphabetical
        order, ``xy`` two wide), or draw them: ``"random"`` or
        ``"median"``.  Returns the vector set."""
        items = self.sorted_prior_items()
        if isinstance(param_values, str):
            if param_values not in ("random", "median"):
                raise ValueError(f"Unknown draw mode: {param_values}")
            vals = [np.ravel(p.random(random_state=random_state)
                             if param_values == "random" else p.median())
                    for _name, p in items]
            param_values = np.concatenate(vals) if vals else np.array([], float)
        start = 0
        for (_name, prior), size in zip(items, self.stochastic_lens()):
            prior.value = np.array(param_values[start:start + size])
            start += size
        return param_values

    def log_priors(self):
        """Joint host-side log-prior (scipy) at the current values:
        ``-inf`` where the component's joint constraints
        (:meth:`_batch_constraints`, the ones the draws enforce) fail."""
        lp = float(sum(np.sum(p.logp(p.value)) for p in self._priors.values()))
        current = {a: np.ravel(np.asarray(getattr(self, a), float))[None]
                   for a in type(self)._stochastic_attrs
                   if self._has(a) and getattr(self, a) is not None}
        return lp if not current or self._batch_constraints(current).all() else -np.inf

    def _batch_constraints(self, vals):
        """``(m,)`` validity of candidate draws ``{attr: (m, size)}``
        under the component's joint constraints (none by default)."""
        return np.ones(len(next(iter(vals.values()))), dtype=bool)

    def draw_batch(self, n, random_state=None, max_tries=1000):
        """``(n, num_stochastics)`` prior draws with the joint constraint
        enforced: every still-invalid row is redrawn together (the JAX
        package's vectorised rejection)."""
        items = self.sorted_prior_items()
        if not items:
            return np.zeros((n, 0))
        sizes = self.stochastic_lens()
        out = np.empty((n, int(np.sum(sizes))))
        need = np.arange(n)
        for _try in range(max_tries):
            m = len(need)
            vals, cols = {}, []
            valid = np.ones(m, dtype=bool)
            for (name, prior), size in zip(items, sizes):
                ev = np.shape(np.asarray(prior.value))
                d = np.asarray(prior.random(random_state=random_state,
                                            size=(m,) + ev),
                               dtype=float).reshape(m, size)
                if prior.is_discrete:
                    d = np.rint(d)
                vals[name] = d
                cols.append(d)
                with np.errstate(all="ignore"):
                    lp = np.asarray(prior.logp(d.reshape((m,) + ev)))
                valid &= np.isfinite(lp.reshape(m, -1)).all(axis=1)
            valid &= self._batch_constraints(vals)
            out[need] = np.concatenate(cols, axis=1)
            need = need[~valid]
            if need.size == 0:
                return out
        raise RuntimeError(
            f"Could not draw valid prior sample for {type(self).__name__} "
            f"after {max_tries} tries"
        )

    def update_stochastic_names(self, count=None):
        comptype = type(self).__name__
        for attr, prior in self._priors.items():
            newname = f"{comptype}_{attr}"
            fitsname = newname
            for longname, abbr in type(self)._fits_abbrs:
                fitsname = fitsname.replace(longname, abbr)
            if count is not None:
                newname = f"{count:d}_{newname}"
                fitsname = f"{count:d}{fitsname}"
            prior.name = newname
            prior.fitsname = fitsname


class Sky(ComponentBase):
    """Sky background: ``adu + dx (x - (W-1)/2) + dy (y - (H-1)/2)``.

    The flat ``adu`` is rendered into the raw model (a constant is
    convolution-invariant); the optional gradient plane is a background
    added after the PSF convolution, with no model variance.  Without
    ``dx``/``dy`` the parameter layout is the flat sky's.
    """

    _stochastic_attrs = ("adu", "dx", "dy")

    def __init__(self, adu=None, dx=None, dy=None):
        super().__init__()
        self.adu = adu
        if dx is not None:
            self.dx = dx
        if dy is not None:
            self.dy = dy


class NoiseScale(ComponentBase):
    """Sampled factor ``scale`` on the whole per-pixel variance budget
    (observation + PSF-mismatch model variance) inside the likelihood;
    ``scale <= 0`` has prior density 0."""

    _fits_abbrs = (("NoiseScale", "NSC"), ("scale", "SCL"))
    _stochastic_attrs = ("scale",)

    def __init__(self, scale=None):
        super().__init__()
        self.scale = scale

    def _batch_constraints(self, vals):
        return _positive(self, vals, super()._batch_constraints(vals), "scale")


class PointSource(ComponentBase):
    """Point source with a sub-pixel shift kernel (``lanczos3`` or
    ``bilinear``); ``xy`` is the 0-based pixel position."""

    _fits_abbrs = (("PointSource", "PS"),)
    _stochastic_attrs = ("xy", "mag")

    def __init__(self, xy=None, mag=None, shift_method="lanczos3"):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.shift_method = shift_method


_FOURIER_MODES = (1, 2, 3, 4)
_BENDING_MODES = (1, 2, 3)
_ROT_ATTRS = ("rot_ang", "rot_in", "rot_out", "rot_pow")
_SHAPE_ATTRS = ("c0",) + tuple(
    n for m in _FOURIER_MODES for n in (f"f{m}", f"f{m}_phi")
) + tuple(f"b{m}" for m in _BENDING_MODES) + _ROT_ATTRS
_TRUNC_ATTRS = ("rsoft", "rsoft_in", "rtrunc", "rtrunc_in")


def _c0_low(c0):
    """The low end of a ``c0``: a constant, or its prior's 99.8% interval
    (a mass-based bound: a Normal prior reaches -inf but rarely below
    -1.5)."""
    if isinstance(c0, Distribution):
        return float(np.ravel(np.asarray(c0.interval(0.998)))[0])
    if isinstance(c0, (int, float, np.floating)):
        return float(c0)
    return None


def _register_shape_attrs(comp, c0, shape_kw, allow_trunc=False):
    """Register the isophote-shape attributes given (``c0``, ``f1..f4`` and
    their phases, ``b1..b3``, the rotation, and for the families that
    support it the truncation): absent ones add no slot.  A phase without
    its amplitude, a truncation radius without its softening length (or
    the reverse) and a partial rotation are rejected, and a ``c0`` that
    reaches below -1.5 warns, as in the JAX package."""
    if c0 is not None:
        comp.c0 = c0
        low = _c0_low(c0)
        if low is not None and low < -1.5:
            warnings.warn(
                f"c0 support reaches {low:.3g} < -1.5: extreme-disky "
                "isophotes concentrate flux into axis ridges that "
                "point sampling cannot integrate; total-flux "
                "normalization errors grow to ~4x by c0=-1.8. Bound "
                "the c0 prior at >= -1.2 for quantitative photometry."
            )
    names = {n for m in _FOURIER_MODES for n in (f"f{m}", f"f{m}_phi")}
    names |= {f"b{m}" for m in _BENDING_MODES} | set(_ROT_ATTRS)
    if allow_trunc:
        names |= set(_TRUNC_ATTRS)
    for name, val in shape_kw.items():
        if name not in names:
            raise TypeError(f"{type(comp).__name__}() got an unexpected keyword "
                            f"argument {name!r}")
        if val is not None:
            setattr(comp, name, val)
    for m in _FOURIER_MODES:
        if comp._has(f"f{m}_phi") and not comp._has(f"f{m}"):
            raise ValueError(f"f{m}_phi given without its amplitude f{m}")
    for r, s in (("rtrunc", "rsoft"), ("rtrunc_in", "rsoft_in")):
        if comp._has(r) != comp._has(s):
            raise ValueError(f"truncation needs BOTH {r} (break radius, px) and "
                             f"{s} (softening length, px)")
    if comp._has("rot_ang") != comp._has("rot_out"):
        raise ValueError("spiral rotation needs BOTH rot_ang (winding angle) and "
                         "rot_out (radius where it is reached, px)")
    for opt in ("rot_in", "rot_pow"):
        if comp._has(opt) and not comp._has("rot_ang"):
            raise ValueError(f"{opt} given without rot_ang/rot_out")


def _value(comp, vals, name):
    """A draw batch's values of ``name``, or the constant; None where the
    attribute is absent or tied (another component draws it, and the
    log-prior enforces the constraint while sampling)."""
    v = vals.get(name, comp._constants.get(name))
    return None if isinstance(v, Tied) else v


def _positive(comp, vals, ok, *names):
    for name in names:
        v = _value(comp, vals, name)
        if v is not None:
            ok = ok & np.ravel(np.asarray(v, float) > 0.0)
    return ok


def _ordered(comp, vals, ok, a_name, b_name):
    """``a >= b`` (semi-major at least semi-minor) for every draw."""
    a, b = _value(comp, vals, a_name), _value(comp, vals, b_name)
    if a is None or b is None:
        return ok
    return ok & np.ravel(np.asarray(b) <= np.asarray(a))


def _shape_batch_ok(comp, vals, ok):
    """The isophote-shape support for a draw batch: ``c0 > -1.95``, ``sum
    |f_m| <= 0.9``, positive truncation radii, ``rot_out > rot_in >= 0``
    and ``rot_pow > 0``."""
    c0 = _value(comp, vals, "c0")
    if c0 is not None:
        ok = ok & np.ravel(np.asarray(c0) > -1.95)
    amp_sum = None
    for m in _FOURIER_MODES:
        a = _value(comp, vals, f"f{m}")
        if a is not None:
            a = np.abs(np.ravel(np.asarray(a, float)))
            amp_sum = a if amp_sum is None else amp_sum + a
    if amp_sum is not None:
        ok = ok & (amp_sum <= 0.9)
    ok = _positive(comp, vals, ok, *_TRUNC_ATTRS)
    rot_out = _value(comp, vals, "rot_out")
    if rot_out is not None:
        rot_out = np.ravel(np.asarray(rot_out, float))
        rot_in = vals.get("rot_in", comp._constants.get("rot_in", 0.0))
        if not isinstance(rot_in, Tied):
            rot_in = np.ravel(np.asarray(rot_in, float))
            ok = ok & (rot_out > rot_in) & (rot_in >= 0.0)
        ok = _positive(comp, vals, ok, "rot_pow")
    return ok


class Sersic(ComponentBase):
    """Sersic profile, with the JAX package's optional GALFIT-style shapes
    (each adds no slot when omitted):

    * ``c0`` boxiness (``r^c = |u|^c + |v|^c``, ``c = c0 + 2``; support
      ``c0 > -1.95``);
    * ``f1..f4`` (+ ``f1_phi..f4_phi``, in ``angle`` units, default 0)
      azimuthal Fourier modes (support ``sum |f_m| <= 0.9``);
    * ``b1..b3`` bending modes (flux exact for any amplitudes);
    * ``rot_ang``/``rot_out`` (+ ``rot_in`` default 0, ``rot_pow``
      default 1) spiral rotation (support ``rot_out > rot_in >= 0``,
      ``rot_pow > 0``);
    * ``rtrunc``/``rsoft`` and ``rtrunc_in``/``rsoft_in`` radial
      truncation, in semi-major pixels (support: all positive).

    ``mag`` stays the exact total flux for any shape
    (:func:`psfmc_tpu_torch.ops.sersic.render_sersic_gen`).
    """

    _fits_abbrs = (
        ("Sersic", "SER"),
        ("reff_b", "REB"),
        ("reff", "RE"),
        ("index", "N"),
        ("angle", "ANG"),
    )
    _fourier_modes = _FOURIER_MODES
    _stochastic_attrs = ("xy", "mag", "reff", "reff_b", "index", "angle") \
        + _SHAPE_ATTRS + _TRUNC_ATTRS

    def __init__(self, xy=None, mag=None, reff=None, reff_b=None,
                 index=None, angle=None, angle_degrees=False, c0=None,
                 **shape_kw):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.reff = reff
        self.reff_b = reff_b
        self.index = index
        self.angle = angle
        self.angle_degrees = angle_degrees
        _register_shape_attrs(self, c0, shape_kw, allow_trunc=True)

    def _batch_constraints(self, vals):
        """``reff >= reff_b`` and the shape support for every draw."""
        ok = super()._batch_constraints(vals)
        return _shape_batch_ok(self, vals, _ordered(self, vals, ok, "reff", "reff_b"))


def _fixed_index(cls, value, kw):
    if "index" in kw:
        raise TypeError(f"{cls} fixes index={value:g}; use Sersic for a free index")
    return dict(kw, index=value)


class ExpDisk(Sersic):
    """Exponential disk: a Sersic with ``index`` fixed at 1 (GALFIT's
    ``expdisk``); shapes and truncation as :class:`Sersic`."""

    _fits_abbrs = (("ExpDisk", "EXP"), ("reff_b", "REB"), ("reff", "RE"),
                   ("angle", "ANG"))

    def __init__(self, **kw):
        super().__init__(**_fixed_index("ExpDisk", 1.0, kw))


class DeVaucouleurs(Sersic):
    """de Vaucouleurs spheroid: a Sersic with ``index`` fixed at 4
    (GALFIT's ``devauc``)."""

    _fits_abbrs = (("DeVaucouleurs", "DEV"), ("reff_b", "REB"), ("reff", "RE"),
                   ("angle", "ANG"))

    def __init__(self, **kw):
        super().__init__(**_fixed_index("DeVaucouleurs", 4.0, kw))


class Gaussian(Sersic):
    """Elliptical Gaussian: a Sersic with ``index`` fixed at 0.5, whose
    half maximum falls at ``reff`` (``FWHM = 2 reff``)."""

    _fits_abbrs = (("Gaussian", "GAU"), ("reff_b", "REB"), ("reff", "RE"),
                   ("angle", "ANG"))

    def __init__(self, **kw):
        super().__init__(**_fixed_index("Gaussian", 0.5, kw))


class King(ComponentBase):
    """Generalized King profile (GALFIT's ``king``; King 1962 at ``alpha =
    2``): ``I0 [(1+t^2)^(-1/alpha) - (1+(rt/rc)^2)^(-1/alpha)]^alpha`` inside
    the tidal radius ``rt``, in total ``mag``; core radii ``rc >= rc_b``;
    optional isophote shapes.  Support: ``rt > 0``, ``alpha > 0``."""

    _fits_abbrs = (("King", "KNG"), ("rc_b", "RCB"), ("rc", "RC"), ("rt", "RT"),
                   ("alpha", "AL"), ("angle", "ANG"))
    _fourier_modes = _FOURIER_MODES
    _stochastic_attrs = ("xy", "mag", "rc", "rc_b", "rt", "alpha", "angle") \
        + _SHAPE_ATTRS

    def __init__(self, xy=None, mag=None, rc=None, rc_b=None, rt=None,
                 alpha=2.0, angle=None, angle_degrees=False, c0=None,
                 **shape_kw):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.rc = rc
        self.rc_b = rc_b
        self.rt = rt
        self.alpha = alpha
        self.angle = angle
        self.angle_degrees = angle_degrees
        _register_shape_attrs(self, c0, shape_kw)

    def _batch_constraints(self, vals):
        ok = _ordered(self, vals, super()._batch_constraints(vals), "rc", "rc_b")
        return _shape_batch_ok(self, vals, _positive(self, vals, ok, "rt", "alpha"))


class Ferrer(ComponentBase):
    """Modified Ferrer profile (GALFIT's ``ferrer``; bars and lenses):
    ``I0 (1 - t^(2-beta))^alpha`` inside ``t < 1`` (``t`` in ``rout``
    units), in total ``mag``; ``rout >= rout_b``; optional isophote
    shapes.  Support: ``alpha > 0``, ``0 <= beta < 2``."""

    _fits_abbrs = (("Ferrer", "FER"), ("rout_b", "ROB"), ("rout", "RO"),
                   ("alpha", "AL"), ("beta", "BE"), ("angle", "ANG"))
    _fourier_modes = _FOURIER_MODES
    _stochastic_attrs = ("xy", "mag", "rout", "rout_b", "alpha", "beta",
                         "angle") + _SHAPE_ATTRS

    def __init__(self, xy=None, mag=None, rout=None, rout_b=None, alpha=None,
                 beta=None, angle=None, angle_degrees=False, c0=None,
                 **shape_kw):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.rout = rout
        self.rout_b = rout_b
        self.alpha = alpha
        self.beta = beta
        self.angle = angle
        self.angle_degrees = angle_degrees
        _register_shape_attrs(self, c0, shape_kw)

    def _batch_constraints(self, vals):
        ok = _ordered(self, vals, super()._batch_constraints(vals), "rout", "rout_b")
        ok = _positive(self, vals, ok, "alpha")
        beta = _value(self, vals, "beta")
        if beta is not None:
            b = np.ravel(np.asarray(beta))
            ok = ok & (b >= 0.0) & (b < 2.0)
        return _shape_batch_ok(self, vals, ok)


class Nuker(ComponentBase):
    """Nuker law (GALFIT's ``nuker``; Lauer et al. 1995): ``I_b
    2^((beta-gamma)/alpha) t^(-gamma) [1 + t^alpha]^((gamma-beta)/alpha)``
    (``t`` in break-radius units), in total ``mag``; ``rb >= rb_b``;
    optional isophote shapes.  Support: ``alpha > 0``, ``beta > 2``,
    ``gamma < 2``, ``gamma < beta``.  The cusp is point-sampled with a
    half-pixel floor; ``Configuration(render_oversample=...)`` integrates
    it."""

    _fits_abbrs = (("Nuker", "NUK"), ("rb_b", "RBB"), ("rb", "RB"),
                   ("alpha", "AL"), ("beta", "BE"), ("gamma", "GA"),
                   ("angle", "ANG"))
    _fourier_modes = _FOURIER_MODES
    _stochastic_attrs = ("xy", "mag", "rb", "rb_b", "alpha", "beta", "gamma",
                         "angle") + _SHAPE_ATTRS

    def __init__(self, xy=None, mag=None, rb=None, rb_b=None, alpha=None,
                 beta=None, gamma=None, angle=None, angle_degrees=False,
                 c0=None, **shape_kw):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.rb = rb
        self.rb_b = rb_b
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.angle = angle
        self.angle_degrees = angle_degrees
        _register_shape_attrs(self, c0, shape_kw)

    def _batch_constraints(self, vals):
        ok = _ordered(self, vals, super()._batch_constraints(vals), "rb", "rb_b")
        ok = _positive(self, vals, ok, "alpha")
        beta, gamma = _value(self, vals, "beta"), _value(self, vals, "gamma")
        if beta is not None:
            ok = ok & np.ravel(np.asarray(beta) > 2.0)
        if gamma is not None:
            ok = ok & np.ravel(np.asarray(gamma) < 2.0)
        if beta is not None and gamma is not None:
            ok = ok & np.ravel(np.asarray(gamma) < np.asarray(beta))
        return _shape_batch_ok(self, vals, ok)


class EdgeDisk(ComponentBase):
    """Edge-on disk (GALFIT's ``edgedisk``; van der Kruit & Searle 1981):
    ``I0 (|R|/rs) K1(|R|/rs) sech^2(z/hs)``, ``R`` along the ``angle``
    major axis, in total ``mag``.  Support: ``rs > 0``, ``hs > 0`` (no
    ordering).  No isophote shapes: the law is separable in (R, z)."""

    _fits_abbrs = (("EdgeDisk", "EDG"), ("rs", "RS"), ("hs", "HS"),
                   ("angle", "ANG"))
    _stochastic_attrs = ("xy", "mag", "rs", "hs", "angle")

    def __init__(self, xy=None, mag=None, rs=None, hs=None, angle=None,
                 angle_degrees=False):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.rs = rs
        self.hs = hs
        self.angle = angle
        self.angle_degrees = angle_degrees

    def _batch_constraints(self, vals):
        return _positive(self, vals, super()._batch_constraints(vals), "rs", "hs")


class Moffat(ComponentBase):
    """Moffat profile: total ``mag``, FWHMs ``fwhm >= fwhm_b``, position
    ``angle`` and ``index`` = beta (> 1 for a finite flux); the isophote
    shapes and truncation of :class:`Sersic`."""

    _fits_abbrs = (("Moffat", "MOF"), ("fwhm_b", "FWB"), ("fwhm", "FW"),
                   ("index", "B"), ("angle", "ANG"))
    _fourier_modes = _FOURIER_MODES
    _stochastic_attrs = ("xy", "mag", "fwhm", "fwhm_b", "index", "angle") \
        + _SHAPE_ATTRS + _TRUNC_ATTRS

    def __init__(self, xy=None, mag=None, fwhm=None, fwhm_b=None, index=None,
                 angle=None, angle_degrees=False, c0=None, **shape_kw):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.fwhm = fwhm
        self.fwhm_b = fwhm_b
        self.index = index
        self.angle = angle
        self.angle_degrees = angle_degrees
        _register_shape_attrs(self, c0, shape_kw, allow_trunc=True)

    def _batch_constraints(self, vals):
        ok = _ordered(self, vals, super()._batch_constraints(vals), "fwhm", "fwhm_b")
        index = _value(self, vals, "index")
        if index is not None:
            ok = ok & np.ravel(np.asarray(index) > 1.0)
        return _shape_batch_ok(self, vals, ok)


class PSFSelector(ComponentBase):
    """Preprocessed PSF(s): with several, the index is a free
    ``DiscreteUniform(0, n)`` parameter (``PSF_Index``).

    Each PSF is normalised, then binned when ``oversample > 1``
    (:func:`~psfmc_tpu_torch.io.preprocess.bin_psf`), and the inter-PSF
    mismatch variance is added to every variance map.  The spatial
    kernels are kept (``spatial_psfs``, ``spatial_vars``): a ``conv_pad``
    model transforms them at the padded size; the observation-size half
    spectra ``psf_list``/``var_list`` are made on first use.
    """

    _stochastic_attrs = ("psf_index",)

    def __init__(self, psf_list, ivm_list, data_shape, oversample=1):
        super().__init__()
        if isinstance(psf_list, (str, np.ndarray)):
            psf_list = [psf_list]
        if isinstance(ivm_list, (str, np.ndarray)):
            ivm_list = [ivm_list]
        if len(psf_list) != len(ivm_list):
            raise ValueError("PSF and IVM lists must be the same length")
        if len(psf_list) > 1:
            self.psf_index = DiscreteUniform(low=0, high=len(psf_list))
        else:
            self.psf_index = 0
        if oversample != int(oversample) or int(oversample) < 1:
            raise ValueError(
                f"psf_oversample must be a positive integer, got {oversample!r}")
        pairs = [preprocess_psf(p, i) for p, i in zip(psf_list, ivm_list)]
        if int(oversample) != 1:
            pairs = [bin_psf(d, v, oversample) for d, v in pairs]
        self.spatial_psfs, self.spatial_vars = calculate_psf_variability(
            [d for d, _ in pairs], [v for _, v in pairs])
        self.filenames = [p if isinstance(p, str) else f"<array {i}>"
                          for i, p in enumerate(psf_list)]
        self._data_shape = tuple(data_shape)
        self._ffts = None

    def _spectra(self):
        if self._ffts is None:
            self._ffts = [pre_fft_psf(p, v, self._data_shape)
                          for p, v in zip(self.spatial_psfs, self.spatial_vars)]
        return self._ffts

    @property
    def psf_list(self):
        return [f for f, _ in self._spectra()]

    @property
    def var_list(self):
        return [v for _, v in self._spectra()]

    def update_stochastic_names(self, count=None):
        # one selector per model: no count prefix
        if "psf_index" in self._priors:
            self._priors["psf_index"].name = "PSF_Index"
            self._priors["psf_index"].fitsname = "PSF_IDX"

    def set_index(self, value):
        """Set the index's current value (the image writer sets the MAP
        sample's)."""
        if "psf_index" in self._priors:
            self._priors["psf_index"].value = value
        else:
            self.psf_index = value

    def current_index(self):
        prior = self._priors.get("psf_index")
        value = prior.value if prior is not None else self._constants["psf_index"]
        return int(np.rint(np.asarray(value)))

    @property
    def filename(self):
        """The current PSF's file name, as the ``PSFIMG`` card reports it."""
        return self.filenames[self.current_index()]


class Configuration(ComponentBase):
    """Input arrays and control parameters.

    :param obs_file: observed image: FITS file name, ``(header, array)``
        pair or array.
    :param obsivm_file: its inverse-variance map.
    :param psf_files: one PSF image or several (their index is then a
        free parameter).
    :param psfivm_files: the matching PSF inverse-variance maps.
    :param mask_file: optional FITS mask (nonzero = exclude), ds9 region
        file (the fit region) or boolean array (True = exclude).
    :param mag_zeropoint: magnitude of 1 count/second.
    :param likelihood: ``'gaussian'`` (the reference's), ``'student'``
        (Student-t with ``likelihood_df`` degrees of freedom) or
        ``'poisson'`` (counts ``likelihood_gain * image``; the data must
        be non-negative and the IVM only defines the mask).
    :param likelihood_df: Student-t degrees of freedom.
    :param likelihood_gain: Poisson counts per observation unit.
    :param psf_oversample: the PSFs are sampled this many times finer
        than the data and are block-binned to it.
    :param conv_pad: render and convolve on a grid this many pixels
        larger on every side, then crop.
    :param render_oversample: sub-pixel factor of the window around each
        Sersic's center (:mod:`psfmc_tpu_torch.ops.oversample`).
    :param oversample_window: that window's side in pixels.

    The observation's FITS header is kept as ``obs_header``: the image
    products start from it.
    """

    def __init__(self, obs_file, obsivm_file, psf_files, psfivm_files,
                 mask_file=None, mag_zeropoint=0, likelihood="gaussian",
                 likelihood_df=4.0, likelihood_gain=1.0, psf_oversample=1,
                 conv_pad=0, render_oversample=1, oversample_window=16):
        super().__init__()
        from ..ops.likelihood import make_lnlike

        self.mag_zeropoint = mag_zeropoint
        make_lnlike(likelihood, likelihood_df, likelihood_gain)  # validates
        self.likelihood = likelihood
        self.likelihood_df = float(likelihood_df)
        self.likelihood_gain = float(likelihood_gain)
        self.conv_pad = int(conv_pad)
        if self.conv_pad < 0:
            raise ValueError(f"conv_pad must be >= 0, got {conv_pad}")
        for name, v in (("render_oversample", render_oversample),
                        ("oversample_window", oversample_window)):
            if v != int(v) or int(v) < 1:
                raise ValueError(f"{name} must be a positive integer, got {v!r}")
        self.render_oversample = int(render_oversample)
        self.oversample_window = int(oversample_window)
        obs_hdr, obs_data, obs_var, bad_px = preprocess_obs(
            obs_file, obsivm_file, mask_file
        )
        self.obs_header = obs_hdr
        self.obs_data = obs_data
        self.obs_var = obs_var
        self.bad_px = bad_px
        self.psf_selector = PSFSelector(
            psf_files, psfivm_files, obs_data.shape, oversample=psf_oversample
        )
        self.coords = array_coords(obs_data.shape)
