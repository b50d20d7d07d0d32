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

Both end in :func:`check_in_slice`, which raises
``NotImplementedError`` for what this slice of the port does not run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import numpy as np

from .. import distributions as D
from ..ops.pointsource import SHIFT_METHODS
from .components import (
    ComponentBase,
    Configuration,
    PointSource,
    PSFSelector,
    Sersic,
    Sky,
)

__all__ = [
    "ParamSlot",
    "CompSpec",
    "ModelSpec",
    "build_param_slots",
    "build_model_spec",
    "spec_from_numpy",
    "check_in_slice",
]

# attributes each component kind renders in this slice
SLICE_PARAMS = {
    "sky": ("adu",),
    "pointsource": ("xy", "mag"),
    "sersic": ("xy", "mag", "reff", "reff_b", "index", "angle"),
    "psfselector": ("psf_index",),
}


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

    kind: str  # 'sky' | 'pointsource' | 'sersic' | 'psfselector'
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
    f_psf_stack: np.ndarray  # (npsf, H, W//2+1) complex
    f_var_stack: np.ndarray
    num_psfs: int
    likelihood: str = "gaussian"
    conv_pad: int = 0
    render_oversample: int = 1


def _not_in_slice(what):
    raise NotImplementedError(
        f"{what} is not in this slice of psfmc_tpu_torch (the flagship "
        "Sky + PointSource + elliptical Sersic model, one PSF, Gaussian "
        "likelihood); see ROADMAP Queue 1 for the slice that brings it"
    )


def check_in_slice(spec: ModelSpec):
    """Raise ``NotImplementedError`` for anything this slice cannot run."""
    if spec.num_psfs != 1:
        _not_in_slice(f"a model with {spec.num_psfs} PSFs")
    if spec.likelihood != "gaussian":
        _not_in_slice(f"likelihood={spec.likelihood!r}")
    if spec.conv_pad:
        _not_in_slice(f"conv_pad={spec.conv_pad}")
    if spec.render_oversample != 1:
        _not_in_slice(f"render_oversample={spec.render_oversample}")
    for cs in spec.comp_specs:
        allowed = SLICE_PARAMS.get(cs.kind)
        if allowed is None:
            _not_in_slice(f"component kind {cs.kind!r}")
        extra = sorted(set(cs.params) - set(allowed))
        if extra:
            _not_in_slice(f"{cs.kind} attribute(s) {extra}")
        for attr, (kind, _payload) in cs.params.items():
            if kind not in ("theta", "const"):
                _not_in_slice(f"a {kind!r} parameter rule ({cs.kind}.{attr})")
        if cs.kind == "pointsource":
            method = cs.static.get("shift_method", "lanczos3")
            if method not in SHIFT_METHODS:
                raise ValueError(f"Unknown shift method: {method}")
        if cs.kind == "psfselector" and cs.params["psf_index"][0] != "const":
            _not_in_slice("a sampled PSF index")
    for slot in spec.slots:
        if not isinstance(slot.dist, D.Distribution):
            _not_in_slice(f"prior {slot.dist!r} of {slot.name}")
    return spec


def build_param_slots(components) -> tuple:
    """Flat layout over a component list -> (slots, slot_map, dim).

    File order, alphabetical within a component.
    """
    slots: List[ParamSlot] = []
    slot_map = {}
    offset = 0
    for ci, comp in enumerate(components):
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


def _resolve(comp, attr, slot_map):
    slot = slot_map.get((id(comp), attr))
    if slot is not None:
        return ("theta", (slot.offset, slot.size))
    return ("const", comp._constants[attr])


def _comp_spec(comp, slot_map) -> CompSpec:
    def rules(attrs):
        return {a: _resolve(comp, a, slot_map) for a in attrs
                if a in comp._priors or a in comp._constants}

    if isinstance(comp, Sky):
        return CompSpec("sky", rules(("adu", "dx", "dy")))
    if isinstance(comp, PointSource):
        return CompSpec("pointsource", rules(("xy", "mag")),
                        static={"shift_method": comp.shift_method})
    if isinstance(comp, Sersic):
        if comp.shape_options:
            _not_in_slice(f"Sersic shape option(s) {sorted(comp.shape_options)}")
        return CompSpec("sersic", rules(SLICE_PARAMS["sersic"]),
                        static={"angle_degrees": comp.angle_degrees})
    if isinstance(comp, PSFSelector):
        return CompSpec("psfselector", rules(("psf_index",)))
    _not_in_slice(f"component {type(comp).__name__}")


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
    if sel.oversample != 1:
        _not_in_slice(f"psf_oversample={sel.oversample}")
    components.append(sel)
    for count, component in enumerate(components):
        component.update_stochastic_names(count=count)
    slots, slot_map, num_params = build_param_slots(components)
    comp_specs = [_comp_spec(c, slot_map) for c in components]
    spec = ModelSpec(
        comp_specs=comp_specs,
        slots=slots,
        num_params=num_params,
        shape=tuple(config.obs_data.shape),
        mag_zeropoint=float(config.mag_zeropoint),
        obs_data=np.asarray(config.obs_data, dtype=np.float64),
        obs_var=np.asarray(config.obs_var, dtype=np.float64),
        bad_px=np.asarray(config.bad_px, dtype=bool),
        f_psf_stack=np.stack(sel.psf_list),
        f_var_stack=np.stack(sel.var_list),
        num_psfs=len(sel.psf_list),
        likelihood=config.likelihood,
        conv_pad=config.conv_pad,
        render_oversample=config.render_oversample,
    )
    return check_in_slice(spec)


def spec_from_numpy(obs_data, obs_var, bad_px, f_psf_stack, f_var_stack,
                    mag_zeropoint, slots, comp_params, likelihood="gaussian",
                    conv_pad=0, render_oversample=1) -> ModelSpec:
    """Build a :class:`ModelSpec` from plain numpy arrays and tuples.

    :param obs_data, obs_var, bad_px: ``(H, W)`` observation, variance
        (inf at bad pixels) and bad-pixel map.
    :param f_psf_stack, f_var_stack: ``(npsf, H, W//2+1)`` complex half
        spectra of the center-padded PSF(s) and PSF variance map(s).
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
    owner = {}
    for ci, cs in enumerate(comp_specs):
        for attr, (kind, payload) in cs.params.items():
            if kind == "theta":
                owner[int(payload[0])] = (ci, attr)
    table = []
    num_params = 0
    for entry in slots:
        name, offset, size, family, kwargs = entry[:5]
        fitsname = entry[5] if len(entry) > 5 else ""
        ci, attr = owner.get(int(offset), (-1, ""))
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
        conv_pad=int(conv_pad),
        render_oversample=int(render_oversample),
    )
    return check_in_slice(spec)
