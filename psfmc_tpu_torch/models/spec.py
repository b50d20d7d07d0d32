"""Static model specification (port of ``models/spec.py``).

A :class:`ModelSpec` fixes, once per model build, the flat parameter
vector's layout — components in file order with the PSF selector last,
attributes alphabetical within a component, ``xy`` spanning two slots —
and the host constants: observation, variance, bad-pixel map and the
PSF / PSF-variance half spectra.  Everything downstream is a function of
``(theta, ModelSpec)``.

Two ways to get one:

* :func:`build_model_spec` from this package's components;
* :func:`spec_from_numpy` from plain numpy arrays and tuples — the
  hand-over of state from another implementation (the tests feed it the
  fields of the JAX package's ``ModelSpec``, so both packages compute
  from identical constants).

A parameter rule is ``('theta', (offset, size))``, ``('const',
value)``, or one of the JAX package's two tie kinds:
``('theta_affine', (offset, size, A, b))`` renders ``A @ theta[offset]
+ b`` and ``('theta_affine_offset', (offset, size, A, b, own))`` renders
``A @ theta[offset] + b + theta[own]``.  Pixel-frame ties resolve to a
shared ``theta`` slot or a constant; an offset tie adds the component's
own offset slots.  A ``frame="sky"`` tie maps the owner's pixel position
through the owner band's WCS onto the user band's pixel grid
(:func:`config_wcs_frame`, :func:`_pixel_affine`: a float64 affine on
the host, linearised at the source band's image center), in one band
as in a joint multi-band model (:mod:`.joint`).

Both end in :func:`check_in_slice`, which raises
``NotImplementedError`` for a component kind, attribute or rule kind the
port does not run.  Every prior family and every component of the JAX
package is in: Sky (with its tilted plane), PointSource, the render
family (shaped and truncated Sersics and their fixed-index subclasses,
Moffat, King, Ferrer, Nuker, EdgeDisk), NoiseScale and several PSFs
with a sampled index, with ``conv_pad``, ``render_oversample``,
``psf_oversample``, the Student-t and Poisson likelihoods, and ties in
pixel and sky frame.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

from .. import distributions as D
from ..ops.fourier import pad_and_rfft_image
from ..ops.pointsource import SHIFT_METHODS
from .components import (
    ComponentBase,
    Configuration,
    EdgeDisk,
    Ferrer,
    King,
    Moffat,
    NoiseScale,
    Nuker,
    PointSource,
    PSFSelector,
    Sersic,
    Sky,
    Tied,
)

__all__ = [
    "ParamSlot",
    "CompSpec",
    "ModelSpec",
    "build_param_slots",
    "build_model_spec",
    "spec_from_numpy",
    "check_in_slice",
    "psf_spectra_for",
    "psf_spectra_for_selector",
    "config_wcs_frame",
]

# the isophote-shape, truncation and rotation rules of the radial
# profiles, in the JAX package's order
SHAPE_PARAMS = ("c0", "f1", "f1_phi", "f2", "f2_phi", "f3", "f3_phi", "f4",
                "f4_phi", "b1", "b2", "b3")
TRUNC_PARAMS = ("rtrunc", "rsoft", "rtrunc_in", "rsoft_in")
ROT_PARAMS = ("rot_ang", "rot_out", "rot_in", "rot_pow")
# each component kind's own attributes, in render order
BASE_PARAMS = {
    "sky": ("adu", "dx", "dy"),
    "pointsource": ("xy", "mag"),
    "sersic": ("xy", "mag", "reff", "reff_b", "index", "angle"),
    "moffat": ("xy", "mag", "fwhm", "fwhm_b", "index", "angle"),
    "king": ("xy", "mag", "rc", "rc_b", "rt", "alpha", "angle"),
    "ferrer": ("xy", "mag", "rout", "rout_b", "alpha", "beta", "angle"),
    "nuker": ("xy", "mag", "rb", "rb_b", "alpha", "beta", "gamma", "angle"),
    "edgedisk": ("xy", "mag", "rs", "hs", "angle"),
    "noisescale": ("scale",),
    "psfselector": ("psf_index",),
}
# the attributes a rule may name, per kind
SLICE_PARAMS = dict(BASE_PARAMS)
for _kind in ("sersic", "moffat"):
    SLICE_PARAMS[_kind] += SHAPE_PARAMS + TRUNC_PARAMS + ROT_PARAMS
for _kind in ("king", "ferrer", "nuker"):
    SLICE_PARAMS[_kind] += SHAPE_PARAMS + ROT_PARAMS
RULE_KINDS = ("theta", "const", "theta_affine", "theta_affine_offset")


@dataclass(frozen=True)
class ParamSlot:
    """One stochastic attribute's slice of the flat parameter vector."""

    comp_index: int
    attr: str
    offset: int
    size: int
    name: str
    fitsname: str
    dist: Any  # psfmc_tpu_torch.distributions.Distribution


@dataclass(frozen=True)
class CompSpec:
    """Render rule of one component.

    ``params`` maps attribute -> ``('const', value)`` or
    ``('theta', (offset, size))``.
    """

    kind: str  # a key of BASE_PARAMS
    params: Dict[str, Tuple[str, Any]]
    static: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelSpec:
    comp_specs: List[CompSpec]
    slots: List[ParamSlot]
    num_params: int
    shape: Tuple[int, int]
    mag_zeropoint: float
    obs_data: np.ndarray
    obs_var: np.ndarray
    bad_px: np.ndarray
    f_psf_stack: np.ndarray  # (npsf, H + 2 pad, (W + 2 pad)//2+1) complex
    f_var_stack: np.ndarray
    num_psfs: int
    likelihood: str = "gaussian"  # 'gaussian' | 'student' | 'poisson'
    likelihood_df: float = 4.0  # Student-t degrees of freedom
    likelihood_gain: float = 1.0  # Poisson counts per observation unit
    conv_pad: int = 0  # the spectra are sized to the padded grid
    render_oversample: int = 1
    oversample_window: int = 16

    @property
    def param_names(self) -> List[str]:
        return [s.name for s in self.slots]

    @property
    def param_fits_abbrs(self) -> List[str]:
        return [s.fitsname for s in self.slots]

    @property
    def param_lens(self) -> List[int]:
        return [s.size for s in self.slots]


def _not_in_slice(what):
    raise NotImplementedError(
        f"{what} is not in psfmc_tpu_torch (every component, tie and prior "
        "of the JAX package's models is); see ROADMAP Queue 1"
    )


def check_in_slice(spec: ModelSpec):
    """Raise ``NotImplementedError`` for anything this slice cannot run."""
    for cs in spec.comp_specs:
        allowed = SLICE_PARAMS.get(cs.kind)
        if allowed is None:
            _not_in_slice(f"component kind {cs.kind!r}")
        extra = sorted(set(cs.params) - set(allowed))
        if extra:
            _not_in_slice(f"{cs.kind} attribute(s) {extra}")
        for attr, (kind, _payload) in cs.params.items():
            if kind not in RULE_KINDS:
                _not_in_slice(f"a {kind!r} parameter rule ({cs.kind}.{attr})")
        if cs.kind == "pointsource":
            method = cs.static.get("shift_method", "lanczos3")
            if method not in SHIFT_METHODS:
                raise ValueError(f"Unknown shift method: {method}")
    for slot in spec.slots:
        if not isinstance(slot.dist, D.Distribution):
            _not_in_slice(f"prior {slot.dist!r} of {slot.name}")
    return spec


def build_param_slots(components) -> tuple:
    """Flat layout over a component list -> (slots, slot_map, dim).

    File order, alphabetical within a component; a component that
    appears more than once (shared between the bands of a joint model)
    contributes its slots once.
    """
    slots: List[ParamSlot] = []
    slot_map = {}
    offset = 0
    seen = set()
    for ci, comp in enumerate(components):
        if id(comp) in seen:
            continue
        seen.add(id(comp))
        for attr, prior in comp.sorted_prior_items():
            size = int(np.asarray(prior.value).size)
            slot = ParamSlot(
                comp_index=ci, attr=attr, offset=offset, size=size,
                name=prior.name, fitsname=prior.fitsname, dist=prior,
            )
            slots.append(slot)
            slot_map[(id(comp), attr)] = slot
            offset += size
    return slots, slot_map, offset


def _pixel_affine(frame_from, frame_to):
    """``(A, b)`` mapping 0-based pixels of one band's frame to another's
    through the sky (pixel -> world -> pixel), linearised by finite
    differences at the source band's image center, in float64 on the
    host.  ``frame_*`` are ``(MiniWCS, ref_xy)`` pairs."""
    wcs_from, ref = frame_from
    wcs_to, _ = frame_to

    def fwd(p):
        ra, dec = wcs_from.pixel_to_sky(p[0] + 1.0, p[1] + 1.0)
        x, y = wcs_to.sky_to_pixel(ra, dec)
        return np.array([float(x) - 1.0, float(y) - 1.0])

    p0 = np.asarray(ref, float)
    f0 = fwd(p0)
    a = np.stack([fwd(p0 + np.array([1.0, 0.0])) - f0,
                  fwd(p0 + np.array([0.0, 1.0])) - f0], axis=1)
    return a, f0 - a @ p0


def config_wcs_frame(config):
    """``(MiniWCS, ref_xy)`` of a Configuration whose observation header
    has a usable WCS (``CRVAL1`` and a CD, CDELT or PC scale), else None;
    ``ref_xy`` is the image center, where :func:`_pixel_affine`
    linearises."""
    hdr = getattr(config, "obs_header", None)
    if hdr is None:
        return None
    try:
        keys = set(hdr.keys())
    except Exception:
        return None
    if "CRVAL1" not in keys or not ({"CD1_1", "CDELT1", "PC1_1"} & keys):
        return None
    from ..io.wcs import MiniWCS

    h, w = config.obs_data.shape
    return (MiniWCS(hdr), (w / 2.0, h / 2.0))


def _resolve(comp, attr, slot_map, wcs_map=None):
    """The rule of ``comp.attr``: its slot, its constant, or a tie
    resolved through its chain (the JAX package's ``_resolve``).  An
    offset tie composes the tie's base with this component's own offset
    slots: ``theta_affine_offset`` on a slot (the base's sky map, or the
    identity), ``theta_affine`` (identity map of the own slots plus the
    constant) on a constant.  ``wcs_map`` maps ``id(component)`` to its
    band's :func:`config_wcs_frame` (or ``"ambiguous"``)."""
    tie = comp._tied_offsets.get(attr)
    if tie is None:
        return _resolve_tie(comp, attr, None, slot_map, wcs_map)
    own = slot_map[(id(comp), attr)]
    kind, payload = _resolve_tie(comp, attr, tie, slot_map, wcs_map)
    eye, zero = np.eye(own.size), np.zeros(own.size)
    if kind == "theta":
        return ("theta_affine_offset", (payload[0], payload[1], eye, zero,
                                        own.offset))
    if kind == "theta_affine":
        return ("theta_affine_offset", payload + (own.offset,))
    return ("theta_affine", (own.offset, own.size, eye,
                             np.asarray(payload, float).reshape(own.size)))


def _sky_affine(user, frame_comp, slot, wcs_map):
    """The ``theta_affine`` rule of a sky tie that ends on ``slot``: the
    slot holds pixels of ``frame_comp``'s band, rendered in ``user``'s."""
    if slot.size != 2:
        raise ValueError("frame='sky' ties need a 2-vector xy")
    if wcs_map is None:
        raise ValueError("frame='sky' tie in a context without WCS frames")
    f_owner = wcs_map.get(id(frame_comp))
    f_user = wcs_map.get(id(user))
    if f_owner is None or f_user is None:
        raise ValueError(
            "frame='sky' tie requires WCS headers (CRVAL + CD/CDELT/PC) on "
            "every involved band's observation")
    if isinstance(f_owner, str) or isinstance(f_user, str):
        raise ValueError(
            "frame='sky' tie involves a component shared between bands with "
            "different WCS — its frame is ambiguous; give each band its own "
            "component")
    a, b = _pixel_affine(f_owner, f_user)
    return ("theta_affine", (slot.offset, slot.size, a, b))


def _resolve_tie(user, user_attr, first_tie, slot_map, wcs_map=None):
    """Follow a tie chain to a slot or a constant.

    ``first_tie`` is an offset tie's first hop (it lives in
    ``_tied_offsets``, not in ``_constants``).  Each sky hop moves the
    frame to its target (a sky hop means "shares the target's sky
    position", which the target's band's WCS gives); pixel hops only
    change which slot the value comes from.  Raises ``ValueError`` as
    the JAX package does: a cycle, a tie onto an offset-tied attribute,
    a target with no value, and for a sky tie a slot that is not a
    2-vector, no WCS context, missing WCS headers, an ambiguous shared
    component or a chain that ends on a constant.
    """
    component, attr = user, user_attr
    sky = False
    frame_comp = user
    seen = set()
    if first_tie is not None:
        seen.add((id(component), attr))
        if first_tie.frame == "sky":
            sky, frame_comp = True, first_tie.component
        component, attr = first_tie.component, first_tie.attr
    while True:
        key = (id(component), attr)
        if key in slot_map:
            if component is user and first_tie is not None:
                # an offset-tie chain back to its own offset slot
                raise ValueError(
                    f"Tied cycle through {type(component).__name__}.{attr}")
            if component is not user and attr in component._tied_offsets:
                raise ValueError(
                    "tying onto an offset-tied attribute is not supported "
                    "(chain the tie to its base instead)")
            slot = slot_map[key]
            if sky:
                return _sky_affine(user, frame_comp, slot, wcs_map)
            return ("theta", (slot.offset, slot.size))
        if key in seen:
            raise ValueError(f"Tied cycle through {type(component).__name__}.{attr}")
        seen.add(key)
        try:
            val = component._constants[attr]
        except KeyError:
            raise ValueError(
                f"Tied target {type(component).__name__}.{attr} has no "
                "value — is the referenced component part of the model?"
            ) from None
        if not isinstance(val, Tied):
            if sky:
                raise ValueError(
                    "frame='sky' tie resolves to a constant — give the owner "
                    "component a stochastic xy or tie in pixel frame")
            return ("const", val)
        if val.frame == "sky":
            sky, frame_comp = True, val.component
        component, attr = val.component, val.attr


# component class -> kind, most derived first (the Sersic subclasses are
# Sersics)
_KINDS = ((Sky, "sky"), (PointSource, "pointsource"), (Sersic, "sersic"),
          (Moffat, "moffat"), (King, "king"), (Ferrer, "ferrer"),
          (Nuker, "nuker"), (EdgeDisk, "edgedisk"), (NoiseScale, "noisescale"),
          (PSFSelector, "psfselector"))


def comp_spec_for(comp, slot_map, wcs_map=None) -> CompSpec:
    """The render rule of one component: its kind's attributes, then (the
    JAX package's ``_add_shape_rules``) the shape attributes it has, an
    amplitude without a phase taking a constant-zero phase."""
    kind = next((k for cls, k in _KINDS if isinstance(comp, cls)), None)
    if kind is None:
        raise TypeError(f"Unknown component type: {type(comp).__name__}")
    params = {a: _resolve(comp, a, slot_map, wcs_map) for a in BASE_PARAMS[kind]
              if comp._has(a)}
    for attr in SLICE_PARAMS[kind][len(BASE_PARAMS[kind]):]:
        if comp._has(attr):
            params[attr] = _resolve(comp, attr, slot_map, wcs_map)
        elif attr.endswith("_phi") and comp._has(attr[:-4]):
            params[attr] = ("const", 0.0)
    static = {}
    if kind == "pointsource":
        static["shift_method"] = comp.shift_method
    elif kind not in ("sky", "noisescale", "psfselector"):
        static["angle_degrees"] = comp.angle_degrees
    return CompSpec(kind, params, static=static)


def psf_spectra_for_selector(sel, obs_shape, conv_pad=0):
    """``(f_psf_stack, f_var_stack)`` of a PSFSelector: the observation-size
    half spectra, or with ``conv_pad`` the spatial kernels re-padded and
    transformed at the padded size ``obs + 2 pad``."""
    conv_pad = int(conv_pad)
    if conv_pad > 0:
        padded = tuple(int(n) + 2 * conv_pad for n in obs_shape)
        return (np.stack([pad_and_rfft_image(p, padded) for p in sel.spatial_psfs]),
                np.stack([pad_and_rfft_image(v, padded) for v in sel.spatial_vars]))
    return np.stack(sel.psf_list), np.stack(sel.var_list)


def psf_spectra_for(config):
    """``(f_psf_stack, f_var_stack)`` of a Configuration, honouring its
    ``conv_pad``."""
    return psf_spectra_for_selector(config.psf_selector, config.obs_data.shape,
                                    config.conv_pad)


def _check_poisson_inputs(config, comp_specs):
    """A Poisson model needs non-negative data at every good pixel, and
    refuses a NoiseScale (it has no variance plane to scale)."""
    good = ~np.asarray(config.bad_px, bool)
    obs = np.asarray(config.obs_data, np.float64)
    if np.any(obs[good] < 0):
        raise ValueError(
            "likelihood='poisson' needs non-negative data at every good "
            f"pixel (found min {obs[good].min():.4g}): Poisson counts cannot "
            "be background-subtracted below zero — mask the offending pixels "
            "or use the gaussian/student likelihood")
    if any(cs.kind == "noisescale" for cs in comp_specs):
        raise ValueError(
            "NoiseScale cannot be combined with likelihood='poisson': the "
            "Poisson likelihood has no variance plane to scale (the "
            "parameter would be sampled but inert)")


def build_model_spec(components: List[ComponentBase], config=None) -> ModelSpec:
    """Compile a component list (+ Configuration) into a :class:`ModelSpec`.

    ``components`` may include the Configuration, or it is passed
    separately.  Raises ``NotImplementedError`` for anything outside
    this slice.
    """
    components = list(components)
    if config is None:
        configs = [c for c in components if isinstance(c, Configuration)]
        if not configs:
            raise ValueError(
                "Unable to find the Configuration component, required "
                "for setting up input images."
            )
        config = configs[0]
    components = [c for c in components if not isinstance(c, Configuration)]
    sel = config.psf_selector
    components.append(sel)
    for count, component in enumerate(components):
        component.update_stochastic_names(count=count)
    slots, slot_map, num_params = build_param_slots(components)
    frame = config_wcs_frame(config)
    wcs_map = {id(c): frame for c in components} if frame else {}
    comp_specs = [comp_spec_for(c, slot_map, wcs_map) for c in components]
    if config.likelihood == "poisson":
        _check_poisson_inputs(config, comp_specs)
    f_psf_stack, f_var_stack = psf_spectra_for(config)
    spec = ModelSpec(
        comp_specs=comp_specs,
        slots=slots,
        num_params=num_params,
        shape=tuple(config.obs_data.shape),
        mag_zeropoint=float(config.mag_zeropoint),
        obs_data=np.asarray(config.obs_data, dtype=np.float64),
        obs_var=np.asarray(config.obs_var, dtype=np.float64),
        bad_px=np.asarray(config.bad_px, dtype=bool),
        f_psf_stack=f_psf_stack,
        f_var_stack=f_var_stack,
        num_psfs=len(sel.spatial_psfs),
        likelihood=config.likelihood,
        likelihood_df=config.likelihood_df,
        likelihood_gain=config.likelihood_gain,
        conv_pad=config.conv_pad,
        render_oversample=config.render_oversample,
        oversample_window=config.oversample_window,
    )
    return check_in_slice(spec)


def spec_from_numpy(obs_data, obs_var, bad_px, f_psf_stack, f_var_stack,
                    mag_zeropoint, slots, comp_params, likelihood="gaussian",
                    likelihood_df=4.0, likelihood_gain=1.0, conv_pad=0,
                    render_oversample=1, oversample_window=16) -> ModelSpec:
    """Build a :class:`ModelSpec` from plain numpy arrays and tuples.

    :param obs_data, obs_var, bad_px: ``(H, W)`` observation, variance
        (inf at bad pixels) and bad-pixel map.
    :param f_psf_stack, f_var_stack: ``(npsf, Hr, Wr//2+1)`` complex half
        spectra of the center-padded PSF(s) and PSF variance map(s), at
        the render grid's size ``(Hr, Wr) = (H + 2 pad, W + 2 pad)``.
    :param mag_zeropoint: magnitude of 1 count/second.
    :param slots: the slot table, one ``(name, offset, size, family,
        kwargs)`` or ``(name, offset, size, family, kwargs, fitsname)``
        tuple per slot in vector order; ``family`` is a prior alias
        (``'Uniform'``) and ``kwargs`` its scipy keyword arguments.
    :param comp_params: the per-component parameter map, one ``(kind,
        params, static)`` tuple per component in file order (PSF
        selector last); ``params`` maps attribute ->
        ``('theta', (offset, size))`` or ``('const', value)``.
    """
    comp_specs = [
        CompSpec(str(kind), {a: (str(k), p) for a, (k, p) in params.items()},
                 dict(static))
        for kind, params, static in comp_params
    ]
    # the components whose rules read each slot: a tied slot is read by
    # several, and its owner is the one whose count prefixes its name
    readers = {}
    for ci, cs in enumerate(comp_specs):
        for attr, (kind, payload) in cs.params.items():
            if kind == "theta_affine_offset":
                readers.setdefault(int(payload[4]), []).append((ci, attr))
            elif kind in ("theta", "theta_affine"):
                readers.setdefault(int(payload[0]), []).append((ci, attr))
    table = []
    num_params = 0
    for entry in slots:
        name, offset, size, family, kwargs = entry[:5]
        fitsname = entry[5] if len(entry) > 5 else ""
        cands = readers.get(int(offset), [(-1, "")])
        ci, attr = next((c for c in cands if str(name).startswith(f"{c[0]}_")),
                        cands[0])
        table.append(ParamSlot(
            comp_index=ci, attr=attr, offset=int(offset), size=int(size),
            name=str(name), fitsname=str(fitsname),
            dist=D.from_name(family, **dict(kwargs)),
        ))
        num_params = max(num_params, int(offset) + int(size))
    obs_data = np.asarray(obs_data, dtype=np.float64)
    f_psf_stack = np.asarray(f_psf_stack)
    spec = ModelSpec(
        comp_specs=comp_specs,
        slots=table,
        num_params=num_params,
        shape=tuple(obs_data.shape),
        mag_zeropoint=float(mag_zeropoint),
        obs_data=obs_data,
        obs_var=np.asarray(obs_var, dtype=np.float64),
        bad_px=np.asarray(bad_px, dtype=bool),
        f_psf_stack=f_psf_stack,
        f_var_stack=np.asarray(f_var_stack),
        num_psfs=int(f_psf_stack.shape[0]),
        likelihood=str(likelihood),
        likelihood_df=float(likelihood_df),
        likelihood_gain=float(likelihood_gain),
        conv_pad=int(conv_pad),
        render_oversample=int(render_oversample),
        oversample_window=int(oversample_window),
    )
    return check_in_slice(spec)
