"""Batched log-posterior over a :class:`ModelSpec` (port of ``models/posterior.py``).

The JAX package traces one walker's ``lnpost(theta)`` and lets ``vmap``
add the walker axis; here every function takes a ``(B, num_params)``
batch of thetas and works on the batch directly.  Three likelihood
paths (``lnpost``), each the counterpart of one of the JAX package's:

* ``"batched"`` (``PSFMC_LNPOST=pallas_batched``): the per-walker
  scalars in torch (prior, sky, the nine packed scalars of each
  elliptical Sersic), the **render kernel** (``raw = sky + sum of
  elliptical Sersics``), every other profile (shaped or truncated
  Sersics, Moffat, King, Ferrer, Nuker, EdgeDisk) added in plain
  PyTorch on the device as the JAX package adds them in XLA, the point
  sources as rank-1 outer products, then the **conv+likelihood kernel**
  (Gaussian lnL per walker);
* ``"fused"`` (``PSFMC_LNPOST=pallas``): the same scalars, then the
  **fused kernel** renders, convolves and reduces each walker in one
  launch;
* ``"general"`` (the JAX package's default XLA path, which runs every
  spec): the render kernel and the other profiles on the render grid
  (padded by ``conv_pad``), the sub-pixel windows of
  ``render_oversample``, then in plain PyTorch
  on the device: each walker's PSF gathered by its rounded and clipped
  index, the convolutions by ``torch.fft``, the crop, the tilted-plane
  sky added after the convolution, the ``NoiseScale`` factor on the
  variance, and the likelihood family of the spec (Gaussian, Student-t
  or Poisson).  ``PSFMC_RENDER=pallas_tiled`` renders with the walker-
  tiled kernel.

With ``lnpost=None`` the path comes from ``PSFMC_LNPOST`` as in the JAX
package: ``pallas`` selects ``fused``, ``pallas_batched`` selects
``batched``, and an unset variable, ``xla`` or any other value select
``batched`` where the conv+likelihood kernel covers the spec
(:func:`~psfmc_tpu_torch.ops.kernels.conv_lnl.batched_lnl_supported`)
and ``general`` elsewhere.  Where the JAX package warns and falls back
for a spec its kernel rejects, ``batched`` and ``fused`` raise
``ValueError``: no path hides a kernel.  ``PSFMC_KAPPA``: ``table`` (the
default) interpolates the Sersic ``b_n``, any other value solves it by
Newton (``"exact"``), on every path.

On CUDA the render and likelihood kernels are the hand-written kernels
of :mod:`psfmc_tpu_torch.ops.kernels`; on the CPU their plain versions.

The prior is its own module, :class:`LogPrior` (the slots' densities
and the components' constraints, the JAX package's ``make_log_prior``):
a posterior holds one over its spec, a joint multi-band model
(:mod:`.joint`) one over the union of its bands, whose band posteriors
have no slots and read the global parameter vector.

Against a stack of observations (the batch fit,
:mod:`psfmc_tpu_torch.batchfit`): :meth:`PosteriorFns.prepare_obs` puts
``K`` observations (and, in survey mode, each target's own PSF spectra)
on the device as an :class:`ObsStack`, and
:meth:`~PosteriorFns.log_posterior_obs` /
:meth:`~PosteriorFns.log_likelihood_obs` evaluate a batch whose walker
``b`` fits target ``b // (B / K)``: the render kernel and conv_lnl with
per-target planes where the kernels cover the spec (:meth:`PosteriorFns.obs_mode`),
else the general path with each walker's PSF gathered from its target's
spectra and its target's variance.

The image products (:meth:`images_batch`, :meth:`ensemble_carry_means`)
use the same render; the kernel paths convolve with the plain
``convolve_rdft``, the general path with ``torch.fft``.  The ensemble
means exploit linearity: the walker mean of ``conv(raw_w)`` is
``conv(mean raw)`` per PSF group, so a step costs three convolutions per
PSF, not three per walker.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, fields
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .._device import pin_fp32_matmul, resolve_device
from ..ops.fourier import convolve, convolve_rdft
from ..ops.kernels.conv_lnl import (
    ConvLnlConsts,
    batched_conv_lnl,
    batched_lnl_supported,
    copy_target_consts_,
    make_conv_lnl_consts,
    make_conv_lnl_consts_stack,
    target_spectra_supported,
)
from ..ops.kernels.fused_lnl import fused_lnl, fused_lnl_supported
from ..ops.kernels.sersic_render import (
    PARAMS_PER_SERSIC,
    pack_sersic_params,
    render_sersics,
    render_sersics_tiled,
)
from ..ops.isophote import quadrature_tables
from ..ops.likelihood import make_cdf_pointwise, make_lnlike, make_lnlike_pointwise
from ..ops.moffat import render_moffat, render_moffat_gen
from ..ops.oversample import (
    apply_window_delta,
    oversampled_window_delta,
    window_origin,
)
from ..ops import profiles as P
from ..ops.pointsource import pointsource_factors, pointsource_image
from ..ops.sersic import render_sersic_gen, sersic_profile_core, sersic_scalar_params
from .spec import BASE_PARAMS, ROT_PARAMS, SHAPE_PARAMS, TRUNC_PARAMS, ModelSpec, check_in_slice

__all__ = ["LogPrior", "ObsStack", "PosteriorFns", "build_posterior", "lnpost_mode",
           "LNPOST_MODES", "value_and_grad"]

LNPOST_MODES = ("batched", "fused", "general")
# PSFMC_LNPOST values of the JAX package that name a kernel path; every
# other value (unset, xla, unknown) runs its XLA path, which runs any spec
_ENV_MODES = {"pallas_batched": "batched", "pallas": "fused"}
# each radial family's semi-major and semi-minor attributes
_AXES = {"sersic": ("reff", "reff_b"), "moffat": ("fwhm", "fwhm_b"),
         "king": ("rc", "rc_b"), "ferrer": ("rout", "rout_b"), "nuker": ("rb", "rb_b")}
# the point-sampled and shaped renders of the King, Ferrer and Nuker laws
_RADIAL = {"king": (P.render_king, P.render_king_gen),
           "ferrer": (P.render_ferrer, P.render_ferrer_gen),
           "nuker": (P.render_nuker, P.render_nuker_gen)}
_SHAPED = frozenset(SHAPE_PARAMS + TRUNC_PARAMS + ROT_PARAMS)
# the kinds a profile render draws (the sky, point sources, the noise
# scale and the PSF selector are not profiles)
_PROFILE_KINDS = frozenset(_AXES) | {"edgedisk"}


def packs_into_the_kernel(cs):
    """Whether component ``cs`` is a row of the render kernel: an
    elliptical Sersic (its fixed-index subclasses included).  Every other
    profile is rendered beside the kernel, as in the JAX package."""
    return cs.kind == "sersic" and not (_SHAPED & set(cs.params))


def lnpost_mode(lnpost=None, spec=None):
    """The likelihood path: ``lnpost`` if given, else from
    ``PSFMC_LNPOST``: ``pallas`` -> ``fused``, ``pallas_batched`` ->
    ``batched``; unset, ``xla`` or another value -> ``batched`` where
    :func:`batched_lnl_supported` holds for ``spec`` (or no spec is
    given), else ``general``."""
    if lnpost is None:
        mode = _ENV_MODES.get(os.environ.get("PSFMC_LNPOST", ""))
        if mode is not None:
            return mode
        if spec is None or batched_lnl_supported(spec)[0]:
            return "batched"
        return "general"
    if lnpost not in LNPOST_MODES:
        raise ValueError(f"lnpost={lnpost!r}: expected one of {LNPOST_MODES}")
    return lnpost


class LogPrior(nn.Module):
    """The joint log-prior over parameter slots, with the component
    constraints of the JAX package's ``make_log_prior``, and the
    components' parameter rules (:meth:`param`).

    Each prior's device constants (loc, scale, vector hyperparameters,
    tables, quadrature rules, mixture terms) and the components' constant
    values and tie maps are buffers, made once, so a captured step copies
    nothing from the host.  A single-band posterior holds one over its
    spec's slots and components and reads its parameters through it; a
    joint model holds one over the union of the bands' slots and every
    band's components, so the prior is counted once, and each band
    posterior holds one over no slots for its own components' rules.
    ``forward(thetas)`` takes a ``(B, num_params)`` batch in the working
    dtype on the module's device.
    """

    def __init__(self, slots, comp_specs, device, dtype=torch.float32):
        super().__init__()
        device = torch.device(device)
        self.slots = list(slots)
        self._rule_specs = list(comp_specs)
        for ci, cs in enumerate(self._rule_specs):
            for attr, (kind, payload) in cs.params.items():
                if kind == "const" and cs.kind != "psfselector":
                    self._rule_buffer(f"const{ci}_{attr}", payload, device, dtype)
                elif kind in ("theta_affine", "theta_affine_offset"):
                    self._rule_buffer(f"aff{ci}_{attr}_a", payload[2], device, dtype)
                    self._rule_buffer(f"aff{ci}_{attr}_b", payload[3], device, dtype)
        self._prior_keys = []
        for i, slot in enumerate(self.slots):
            if device.type == "cuda" and slot.dist.needs_host(slot.size):
                raise NotImplementedError(
                    f"prior {type(slot.dist).__name__} of {slot.name} evaluates "
                    "scipy on the host (a discrete family with vector "
                    "hyperparameters): a CUDA graph cannot call the host; use "
                    "device='cpu' or scalar hyperparameters")
            params = slot.dist.torch_params(dtype, device, slot.size)
            for key, tensor in params.items():
                self.register_buffer(f"prior{i}_{key}", tensor, persistent=False)
            self._prior_keys.append(tuple(params))

    def forward(self, thetas):
        """Log-prior per walker; outside a constraint ``-inf``, NaN ->
        ``-inf``."""
        lp = thetas.new_zeros(thetas.shape[0])
        for i, slot in enumerate(self.slots):
            x = thetas[:, slot.offset:slot.offset + slot.size]
            params = {k: getattr(self, f"prior{i}_{k}") for k in self._prior_keys[i]}
            lp = lp + slot.dist.torch_logp(x, params).sum(dim=-1)
        neg_inf = torch.full_like(lp, -math.inf)
        for ci, cs in enumerate(self._rule_specs):
            bad = self._outside_support(ci, cs, thetas)
            if bad is not None:
                lp = torch.where(bad, neg_inf, lp)
        return torch.where(torch.isnan(lp), neg_inf, lp)

    def _rule_buffer(self, name, value, device, dtype):
        self.register_buffer(name, torch.as_tensor(
            np.asarray(value, np.float64), dtype=dtype, device=device),
            persistent=False)

    def param(self, ci, name, thetas):
        """Parameter ``name`` of component ``ci`` for every walker:
        ``(B,)`` for a scalar, ``(B, size)`` for a vector."""
        kind, payload = self._rule_specs[ci].params[name]
        if kind == "const":
            t = getattr(self, f"const{ci}_{name}")
            return t.expand(thetas.shape[0], *t.shape)
        offset, size = payload[:2]
        if kind in ("theta_affine", "theta_affine_offset"):
            # a tie: A @ theta[offset] + b (+ the own offset slots), as an
            # fp32 product on the card (TF32 is off)
            x = thetas[:, offset:offset + size]
            out = (x @ getattr(self, f"aff{ci}_{name}_a").T
                   + getattr(self, f"aff{ci}_{name}_b"))
            if kind == "theta_affine_offset":
                out = out + thetas[:, payload[4]:payload[4] + size]
            return out[:, 0] if size == 1 else out
        if size == 1:
            return thetas[:, offset]
        return thetas[:, offset:offset + size]

    def _outside_support(self, ci, cs, thetas):
        """``(B,)`` where component ``ci``'s joint prior is 0, or None: the
        axis order of every radial family (semi-major >= semi-minor), the
        families' supports (Moffat beta > 1; King rt, alpha > 0; Ferrer
        alpha > 0, 0 <= beta < 2; Nuker alpha > 0, beta > 2, gamma < 2,
        gamma < beta; EdgeDisk rs, hs > 0; NoiseScale scale > 0) and the
        isophote shapes' (c0 > -1.95, sum |f_m| <= 0.9, positive
        truncation radii, rot_out > rot_in >= 0, rot_pow > 0)."""
        def get(attr):
            return self.param(ci, attr, thetas)

        if cs.kind == "noisescale":
            return get("scale") <= 0.0
        if cs.kind == "edgedisk":
            return (get("rs") <= 0.0) | (get("hs") <= 0.0)
        if cs.kind not in _AXES:
            return None
        a_name, b_name = _AXES[cs.kind]
        bad = get(b_name) > get(a_name)
        if cs.kind == "moffat":
            bad = bad | (get("index") <= 1.0)
        elif cs.kind == "king":
            bad = bad | (get("rt") <= 0.0) | (get("alpha") <= 0.0)
        elif cs.kind == "ferrer":
            beta = get("beta")
            bad = bad | (get("alpha") <= 0.0) | (beta < 0.0) | (beta >= 2.0)
        elif cs.kind == "nuker":
            beta, gamma = get("beta"), get("gamma")
            bad = (bad | (get("alpha") <= 0.0) | (beta <= 2.0) | (gamma >= 2.0)
                   | (gamma >= beta))
        if "c0" in cs.params:
            bad = bad | (get("c0") <= -1.95)
        amps = [get(f"f{m}").abs() for m in (1, 2, 3, 4) if f"f{m}" in cs.params]
        if amps:
            bad = bad | (sum(amps[1:], amps[0]) > 0.9)
        for attr in TRUNC_PARAMS:
            if attr in cs.params:
                bad = bad | (get(attr) <= 0.0)
        if "rot_ang" in cs.params:
            rot_in = get("rot_in") if "rot_in" in cs.params else 0.0
            bad = bad | (get("rot_out") <= rot_in)
            if "rot_in" in cs.params:
                bad = bad | (rot_in < 0.0)
            if "rot_pow" in cs.params:
                bad = bad | (get("rot_pow") <= 0.0)
        return bad


@dataclass
class ObsStack:
    """``K`` observations of one spec on the posterior's device (the JAX
    package's traced obs dict, stacked): ``obs``, ``obs_var`` (inf at bad
    pixels) and ``good`` ``(K, H, W)``; ``f_stack`` each target's PSF
    spectra ``(K, num_psfs, 3, Hr, Wr//2+1)`` complex (the PSF, its
    variance, the PSF) in survey mode, else None; ``consts`` the stacked
    conv_lnl constants on the kernel path, else None.  ``mode`` is the
    path, ``"batched"`` or ``"general"``."""

    obs: torch.Tensor
    obs_var: torch.Tensor
    good: torch.Tensor
    f_stack: Optional[torch.Tensor]
    consts: Optional[ConvLnlConsts]
    mode: str

    @property
    def targets(self) -> int:
        return self.obs.shape[0]

    def split(self, x):
        """``(B, ...)`` walker-major -> ``(K, B/K, ...)``: each target's
        walkers (contiguous)."""
        return x.reshape(self.targets, x.shape[0] // self.targets, *x.shape[1:])

    def copy_(self, other: "ObsStack"):
        """Write ``other``'s observations into this stack's tensors in place
        (a captured graph reads them by address)."""
        if (self.mode, self.obs.shape, self.f_stack is None) != (
                other.mode, other.obs.shape, other.f_stack is None):
            raise ValueError("the two stacks differ in path, shape or PSF mode")
        for name in ("obs", "obs_var", "good") + (() if self.f_stack is None
                                                   else ("f_stack",)):
            getattr(self, name).copy_(getattr(other, name))
        if self.consts is not None:
            copy_target_consts_(self.consts, other.consts)
        return self


def _obs_spectra(obs):
    """``(psf_f, var_f)`` complex host arrays from an obs dict (``psf_f`` /
    ``var_f``, or the ``*_re`` / ``*_im`` planes), or ``(None, None)``."""
    out = []
    for key in ("psf_f", "var_f"):
        if key in obs:
            out.append(np.asarray(obs[key]))
        elif f"{key}_re" in obs:
            out.append(np.asarray(obs[f"{key}_re"], np.float64)
                       + 1j * np.asarray(obs[f"{key}_im"], np.float64))
        else:
            out.append(None)
    return tuple(out)


class PosteriorFns(nn.Module):
    """The posterior of a spec on one device.

    Every constant (observation, variance, mask, PSF spectra, DFT
    operators, prior hyperparameters, constant parameter values) is a
    buffer on the module's device.  ``forward`` is
    :meth:`log_posterior_batch`; ``lnpost`` picks its likelihood path
    (see :func:`lnpost_mode`).
    """

    def __init__(self, spec: ModelSpec, device=None, dtype=torch.float32,
                 lnpost=None):
        super().__init__()
        self.lnpost = lnpost_mode(lnpost, spec)
        # whether the JAX package runs this path as a Pallas kernel, whose
        # own lnL its tempered samplers take (fused: PSFMC_LNPOST=pallas;
        # batched when PSFMC_LNPOST=pallas_batched picked it)
        self.kernel_lnl = self.lnpost == "fused" or (
            lnpost is None and self.lnpost == "batched"
            and os.environ.get("PSFMC_LNPOST") == "pallas_batched")
        gates = {"fused": (fused_lnl_supported, "PSFMC_LNPOST=pallas"),
                 "batched": (batched_lnl_supported, "PSFMC_LNPOST=pallas_batched")}
        if self.lnpost in gates:
            gate, env = gates[self.lnpost]
            ok, why = gate(spec)
            if not ok:
                raise ValueError(
                    f"lnpost={self.lnpost!r} ({env}) does not cover {why}; "
                    "use lnpost='general'")
        device = resolve_device(device)
        check_in_slice(spec)
        if device.type == "cuda":
            if dtype != torch.float32:
                raise TypeError("the CUDA path works in float32")
            pin_fp32_matmul()
        self.spec = spec
        self.dtype = dtype
        self.mag_zp = float(spec.mag_zeropoint)
        self.shape = tuple(spec.shape)
        # PSFMC_KAPPA: ``table`` (the default), any other value Newton
        self.kappa_mode = ("table" if os.environ.get("PSFMC_KAPPA", "table")
                           == "table" else "exact")
        self.pad = int(spec.conv_pad)
        self.render_shape = tuple(n + 2 * self.pad for n in self.shape)
        self.oversample = int(spec.render_oversample)
        self.os_window = min(int(spec.oversample_window), min(self.render_shape))
        tiled = (self.lnpost == "general"
                 and os.environ.get("PSFMC_RENDER", "") == "pallas_tiled")
        self._render = render_sersics_tiled if tiled else render_sersics
        family = (spec.likelihood, spec.likelihood_df, spec.likelihood_gain)
        self._lnlike = make_lnlike(*family)
        self._lnlike_pointwise = make_lnlike_pointwise(*family)
        self._cdf_pointwise = make_cdf_pointwise(*family)
        kinds = [cs.kind for cs in spec.comp_specs]
        self._noise_ci = kinds.index("noisescale") if "noisescale" in kinds else None
        self._grad_skies = [ci for ci, cs in enumerate(spec.comp_specs)
                            if cs.kind == "sky" and {"dx", "dy"} & set(cs.params)]
        self._selector = spec.comp_specs[kinds.index("psfselector")]

        np_dtype = np.float32 if dtype == torch.float32 else np.float64

        def buffer(name, array, dt=dtype):
            self.register_buffer(name, torch.as_tensor(array, dtype=dt, device=device),
                                 persistent=False)

        buffer("obs", np.ascontiguousarray(spec.obs_data, np_dtype))
        buffer("obs_var", np.ascontiguousarray(spec.obs_var, np_dtype))
        buffer("good", ~np.asarray(spec.bad_px, bool), torch.bool)
        h, w = self.shape
        # the tilted plane's coordinates, zero at the image center
        buffer("x_centered", np.arange(w, dtype=np_dtype) - np_dtype((w - 1) / 2.0))
        buffer("y_centered", (np.arange(h, dtype=np_dtype)
                              - np_dtype((h - 1) / 2.0))[:, None])
        # the gradient's path: the kernels' where they cover the spec,
        # whatever ``lnpost`` says (the JAX gradient runs its XLA path)
        self.grad_mode = "batched" if batched_lnl_supported(spec)[0] else "general"
        if self.lnpost == "general":
            # (num_psfs, 3, Hr, Wr//2+1): the PSF, its variance and the PSF
            # again (the point sources' convolution), stacked for one FFT
            cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
            f_psf, f_var = np.asarray(spec.f_psf_stack), np.asarray(spec.f_var_stack)
            buffer("f_stack", np.stack([f_psf, f_var, f_psf], axis=1), cdtype)
        if self.lnpost != "general" or self.grad_mode == "batched":
            consts = make_conv_lnl_consts(
                spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
                spec.obs_var, ~np.asarray(spec.bad_px, bool), device, dtype,
            )
            for f in fields(ConvLnlConsts):
                self.register_buffer("c_" + f.name, getattr(consts, f.name),
                                     persistent=False)
        self.prior = LogPrior(spec.slots, spec.comp_specs, device, dtype)
        # the render grid's pixel coordinates in observation pixels (``-pad``
        # at the first column), as a row and a column that broadcast
        hr, wr = self.render_shape
        buffer("xg_r", (np.arange(wr, dtype=np_dtype) - self.pad)[None, :])
        buffer("yg_r", (np.arange(hr, dtype=np_dtype) - self.pad)[:, None])
        # the quadrature nodes of the shaped profiles, made on the device
        # now rather than inside a captured step
        quadrature_tables(device, dtype)
        P.tanh_sinh_tables(device, dtype)

    # -- constants -------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.obs.device

    @property
    def consts(self) -> ConvLnlConsts:
        """The conv+likelihood constants of the kernel paths."""
        return ConvLnlConsts(
            **{f.name: getattr(self, "c_" + f.name) for f in fields(ConvLnlConsts)}
        )

    def as_thetas(self, thetas):
        thetas = torch.as_tensor(thetas, dtype=self.dtype, device=self.device)
        if thetas.ndim != 2 or thetas.shape[1] != self.spec.num_params:
            raise ValueError(
                f"thetas must be (B, {self.spec.num_params}), "
                f"got {tuple(thetas.shape)}"
            )
        return thetas

    def _get(self, ci, name, thetas):
        """Parameter ``name`` of component ``ci`` for every walker."""
        return self.prior.param(ci, name, thetas)

    # -- prior -----------------------------------------------------------
    def log_prior_batch(self, thetas):
        """Joint log-prior per walker with the JAX package's component
        constraints (:class:`LogPrior`); NaN -> ``-inf``."""
        return self.prior(self.as_thetas(thetas))

    # -- renders ---------------------------------------------------------
    def _psf_index(self, thetas):
        """Each walker's PSF: its index rounded half to even (as the
        ``DiscreteUniform`` prior rounds it), then clipped to the stack."""
        kind, payload = self._selector.params["psf_index"]
        if kind == "const":
            idx = torch.full((thetas.shape[0],), int(payload), dtype=torch.int64,
                             device=self.device)
        else:
            idx = torch.round(thetas[:, payload[0]]).to(torch.int64)
        return torch.clamp(idx, 0, self.spec.num_psfs - 1)

    def _render_parts(self, thetas):
        """(packed rows ``(B, S, 9)`` of the elliptical Sersics on the
        render grid, sky ``(B,)``, and each packed Sersic's ``(xy,
        scalars)`` in observation pixels)."""
        b = thetas.shape[0]
        sky = torch.zeros(b, dtype=self.dtype, device=self.device)
        sersics, rows = [], []
        for ci, cs in enumerate(self.spec.comp_specs):
            if cs.kind == "sky":
                sky = sky + self._get(ci, "adu", thetas)
            elif packs_into_the_kernel(cs):
                g = [self._get(ci, n, thetas) for n in BASE_PARAMS["sersic"]]
                scalars = sersic_scalar_params(
                    *g, self.mag_zp, cs.static["angle_degrees"], self.kappa_mode)
                sersics.append((g[0], scalars))
                if self.pad:  # the render grid's pixel 0 is -pad
                    scalars = (scalars[0] + self.pad, scalars[1] + self.pad,
                               *scalars[2:])
                rows.append(pack_sersic_params(scalars))
        if rows:
            params = torch.stack(rows, dim=1)
        else:
            params = torch.zeros((b, 0, PARAMS_PER_SERSIC), dtype=self.dtype,
                                 device=self.device)
        return params, sky, sersics

    def _profiles(self, thetas):
        """``(xy, coarse, fine)`` of every profile the render kernel does
        not draw (the JAX package's per-family branches of
        ``_raw_and_ps``): ``coarse(xg, yg)`` renders it as the full frame
        does and ``fine`` as the sub-pixel window integrates it.  Every
        parameter is ``(B, 1, 1)`` (``xy`` ``(B, 1, 1, 2)``) against grids
        that broadcast with it."""
        out = []
        for ci, cs in enumerate(self.spec.comp_specs):
            if cs.kind not in _PROFILE_KINDS or packs_into_the_kernel(cs):
                continue

            def get(attr, _ci=ci):
                t = self._get(_ci, attr, thetas)
                return t[:, None, None]

            xy = self._get(ci, "xy", thetas)
            args = (xy[:, None, None, :],) + tuple(
                get(a) for a in BASE_PARAMS[cs.kind][1:])
            tail = (self.mag_zp, cs.static["angle_degrees"])
            if cs.kind == "edgedisk":
                # finite center (x K1 -> 1): point sampling is the fine form
                coarse = self._closure(P.render_edgedisk, args, tail, {})
                out.append((xy, coarse, coarse))
                continue
            shaped = bool(set(SHAPE_PARAMS + ROT_PARAMS) & set(cs.params))
            trunc = self._trunc_args(cs, get)
            kw = {}
            if shaped or trunc is not None:
                c0 = get("c0") if "c0" in cs.params else torch.zeros_like(args[1])
                args = args + (c0,)
                kw = self._shape_args(cs, get)
                if trunc is not None:
                    kw["trunc"] = trunc
            if cs.kind == "sersic":
                kw["kappa_mode"] = self.kappa_mode
                coarse = self._closure(render_sersic_gen, args, tail, kw)
                fine = self._closure(render_sersic_gen, args, tail,
                                     dict(kw, correction=False))
            elif cs.kind == "moffat":
                fn = render_moffat_gen if kw else render_moffat
                coarse = fine = self._closure(fn, args, tail, kw)
            else:
                # no trapezoid term: the point sample is the fine form, but
                # the Nuker cusp floor relaxes by 1/S^2 for the closer
                # midpoints
                fn = _RADIAL[cs.kind][1 if shaped else 0]
                coarse = fine = self._closure(fn, args, tail, kw)
                if cs.kind == "nuker":
                    fine = self._closure(fn, args, tail, dict(
                        kw, min_px_sq=0.125 / self.oversample**2))
            out.append((xy, coarse, fine))
        return out

    @staticmethod
    def _closure(fn, args, tail, kw):
        return lambda xg, yg: fn(xg, yg, *args, *tail, **kw)

    @staticmethod
    def _shape_args(cs, get):
        """The keyword arguments of a shaped render: ``fourier`` ``((m,
        amplitude, phase), ...)``, ``bending`` ``((m, amplitude), ...)``
        and ``rotation`` ``(rot_ang, rot_out, rot_in, rot_pow)`` (defaults
        0 and 1), each present as the spec has it."""
        kw = {"fourier": tuple((m, get(f"f{m}"), get(f"f{m}_phi"))
                               for m in (1, 2, 3, 4) if f"f{m}" in cs.params),
              "bending": tuple((m, get(f"b{m}")) for m in (1, 2, 3)
                               if f"b{m}" in cs.params)}
        if "rot_ang" in cs.params:
            kw["rotation"] = (
                get("rot_ang"), get("rot_out"),
                get("rot_in") if "rot_in" in cs.params else 0.0,
                get("rot_pow") if "rot_pow" in cs.params else 1.0)
        return kw

    @staticmethod
    def _trunc_args(cs, get):
        """``(outer, inner)`` truncation pairs (each ``(break, soft)`` or
        None), or None without truncation."""
        outer = ((get("rtrunc"), get("rsoft")) if "rtrunc" in cs.params else None)
        inner = ((get("rtrunc_in"), get("rsoft_in")) if "rtrunc_in" in cs.params
                 else None)
        return None if outer is None and inner is None else (outer, inner)

    def render_inputs(self, thetas):
        """(packed Sersic rows ``(B, S, 9)``, sky ``(B,)``) for the render
        kernel, on the render grid."""
        params, sky, _ = self._render_parts(self.as_thetas(thetas))
        return params, sky

    def pointsource_inputs(self, thetas):
        """Point-source factors ``fky`` ``(B, P, Hr)`` and ``kx`` ``(B, P,
        Wr)`` on the render grid (``P`` may be 0)."""
        thetas = self.as_thetas(thetas)
        fkys, kxs = [], []
        for ci, cs in enumerate(self.spec.comp_specs):
            if cs.kind == "pointsource":
                xy = self._get(ci, "xy", thetas)
                fky, kx = pointsource_factors(
                    self.render_shape, xy + self.pad if self.pad else xy,
                    self._get(ci, "mag", thetas), self.mag_zp,
                    cs.static.get("shift_method", "lanczos3"),
                )
                fkys.append(fky)
                kxs.append(kx)
        b = thetas.shape[0]
        h, w = self.render_shape
        if not fkys:
            kw = dict(dtype=self.dtype, device=self.device)
            return torch.zeros((b, 0, h), **kw), torch.zeros((b, 0, w), **kw)
        return torch.stack(fkys, dim=1), torch.stack(kxs, dim=1)

    def _apply_oversample(self, raw, xy, coarse, fine):
        """One profile's sub-pixel window: ``fine`` integrated on the
        midpoint grid minus ``coarse`` point-sampled, added into the
        render.  For a packed Sersic ``coarse`` is the plain profile, which
        differs from what the kernel added by at most its 5e-6 relative per
        pixel."""
        origin = window_origin(xy, self.os_window, self.render_shape, self.pad)
        delta = oversampled_window_delta(coarse, fine, origin, self.os_window,
                                         self.oversample, self.pad, self.dtype)
        return apply_window_delta(raw, delta, origin)

    def raw_and_ps(self, thetas):
        """Raw composite model ``(B, Hr, Wr)`` on the render grid and its
        point-source part: the render kernel's sky and elliptical Sersics,
        plus every other profile, plus the point sources."""
        thetas = self.as_thetas(thetas)
        params, sky, sersics = self._render_parts(thetas)
        raw = self._render(params.contiguous(), sky.contiguous(), self.render_shape)
        profiles = self._profiles(thetas)
        for _xy, coarse, _fine in profiles:
            raw = raw + coarse(self.xg_r, self.yg_r)
        if self.oversample > 1:
            for xy, scalars in sersics:
                x, y, *rest = (t[:, None, None] for t in scalars)

                def profile(correction, x=x, y=y, rest=rest):
                    return lambda xg, yg: sersic_profile_core(
                        xg - x, yg - y, *rest, correction=correction)

                raw = self._apply_oversample(raw, xy, profile(True), profile(False))
            for xy, coarse, fine in profiles:
                raw = self._apply_oversample(raw, xy, coarse, fine)
        ps = pointsource_image(*self.pointsource_inputs(thetas))
        return raw + ps, ps

    def _crop(self, img):
        """Crop render-grid images back to the observation frame."""
        p = self.pad
        return img[..., p:img.shape[-2] - p, p:img.shape[-1] - p] if p else img

    def _sky_plane(self, thetas):
        """``(B, H, W)`` tilted-plane background, added after the
        convolution: a background never rode the PSF, and the circular
        convolution would wrap a ramp at the frame's edges."""
        plane = torch.zeros((thetas.shape[0],) + self.shape, dtype=self.dtype,
                            device=self.device)
        for ci in self._grad_skies:
            params = self.spec.comp_specs[ci].params
            if "dx" in params:
                plane = plane + self._get(ci, "dx", thetas)[:, None, None] * self.x_centered
            if "dy" in params:
                plane = plane + self._get(ci, "dy", thetas)[:, None, None] * self.y_centered
        return plane

    def _noise_scale(self, thetas):
        return self._get(self._noise_ci, "scale", thetas)

    # -- posterior -------------------------------------------------------
    def log_likelihood_batch(self, thetas):
        """lnL per walker on this posterior's path: the render and
        conv+lnL kernels (``batched``), the fused kernel, or the general
        path's images and likelihood family."""
        return self._log_likelihood(self.as_thetas(thetas), self.lnpost)

    # -- against a stack of observations ------------------------------------
    def obs_mode(self, target_psf=False):
        """The path :meth:`log_posterior_obs` takes, with or without a PSF
        per target: ``"batched"`` (the render and conv_lnl kernels) where
        :func:`batched_lnl_supported` holds and, with a PSF per target,
        :func:`target_spectra_supported` at this shape, else ``"general"``."""
        ok = batched_lnl_supported(self.spec)[0] and (
            not target_psf or target_spectra_supported(self.shape))
        return "batched" if ok else "general"

    def prepare_obs(self, obs) -> ObsStack:
        """An :class:`ObsStack` on this posterior's device from the JAX
        package's obs dict, stacked: ``obs_data``, ``obs_var`` and
        ``good_px`` ``(K, H, W)`` and optionally each target's PSF spectra
        (``psf_f`` / ``var_f`` complex ``(K, num_psfs, Hr, Wr//2+1)``, or
        their ``*_re`` / ``*_im`` planes;
        :func:`~psfmc_tpu_torch.batchfit.prepare_psf_stack`)."""
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        data = np.asarray(obs["obs_data"], np.float64)
        var = np.asarray(obs["obs_var"], np.float64)
        good = np.asarray(obs["good_px"], bool)
        if data.ndim != 3 or data.shape[1:] != self.shape or var.shape != data.shape \
                or good.shape != data.shape:
            raise ValueError(f"obs_data, obs_var and good_px must be (K, {self.shape[0]}, "
                             f"{self.shape[1]}), got {data.shape}, {var.shape}, {good.shape}")
        f_psf, f_var = _obs_spectra(obs)
        if f_psf is not None and f_psf.shape[:2] != (data.shape[0], self.spec.num_psfs):
            raise ValueError(f"per-target spectra {f_psf.shape} for {data.shape[0]} "
                             f"targets of {self.spec.num_psfs} PSF(s)")
        mode = self.obs_mode(f_psf is not None)
        dev = self.device

        def tensor(a, dt=self.dtype):
            return torch.as_tensor(np.ascontiguousarray(a, np_dtype), dtype=dt, device=dev)

        f_stack = consts = None
        if mode == "batched":
            consts = make_conv_lnl_consts_stack(
                self.spec.f_psf_stack[0] if f_psf is None else f_psf[:, 0],
                self.spec.f_var_stack[0] if f_var is None else f_var[:, 0],
                data, var, good, dev, self.dtype)
        elif f_psf is not None:
            cdtype = torch.complex64 if self.dtype == torch.float32 else torch.complex128
            f_stack = torch.as_tensor(np.stack([f_psf, f_var, f_psf], axis=2),
                                      dtype=cdtype, device=dev)
        elif not hasattr(self, "f_stack"):
            raise ValueError(f"lnpost={self.lnpost!r} holds no PSF spectra for the "
                             "general path: pass each target's PSF")
        return ObsStack(tensor(data), tensor(var),
                        torch.as_tensor(good, device=dev), f_stack, consts, mode)

    def _as_obs(self, obs):
        return obs if isinstance(obs, ObsStack) else self.prepare_obs(obs)

    def _obs_likelihood(self, thetas, obs: ObsStack):
        if thetas.shape[0] % obs.targets:
            raise ValueError(f"{thetas.shape[0]} walkers do not split evenly over "
                             f"{obs.targets} targets")
        if obs.mode == "batched":
            raw, _ = self.raw_and_ps(thetas)
            return batched_conv_lnl(raw, obs.consts)
        imgs = self._images(thetas, with_ps=False, obs=obs)
        conv = obs.split(imgs["conv"])
        lnl = self._lnlike(obs.obs[:, None] - conv, 1.0 / obs.split(imgs["var"]),
                           obs.good[:, None], conv)
        return lnl.reshape(thetas.shape[0])

    def log_likelihood_obs(self, thetas, obs):
        """lnL per walker against a stack of observations (an
        :class:`ObsStack` or the dict :meth:`prepare_obs` takes): walker
        ``b`` of ``B`` fits target ``b // (B / K)``.  Differentiable in
        ``thetas`` (the hierarchical fit's gradient) on the stack's path,
        which follows ``grad_mode``'s rule (:meth:`obs_mode`): the render
        and conv_lnl with per-target planes and spectra through their
        backward kernels where they cover the spec, else the general path
        with autograd through ``torch.fft`` (each target's spectra too)."""
        return self._obs_likelihood(self.as_thetas(thetas), self._as_obs(obs))

    def log_posterior_obs(self, thetas, obs):
        """lnpost per walker against a stack of observations: the prior,
        then :meth:`log_likelihood_obs` (``-inf`` outside the prior)."""
        thetas = self.as_thetas(thetas)
        lp = self.prior(thetas)
        lnl = self._obs_likelihood(thetas, self._as_obs(obs))
        return torch.where(torch.isfinite(lp), lnl + lp, torch.full_like(lp, -math.inf))

    def _log_likelihood(self, thetas, mode):
        if mode == "fused":
            params, sky = self.render_inputs(thetas)
            fky, kx = self.pointsource_inputs(thetas)
            return fused_lnl(params, sky, fky, kx, self.consts)
        if mode == "batched":
            raw, _ = self.raw_and_ps(thetas)
            return batched_conv_lnl(raw, self.consts)
        imgs = self._images(thetas, with_ps=False)
        return self._lnlike(self.obs - imgs["conv"], 1.0 / imgs["var"], self.good,
                            imgs["conv"])

    def log_posterior_batch(self, thetas):
        """lnpost per walker: prior, then :meth:`log_likelihood_batch`."""
        return self._log_posterior(self.as_thetas(thetas), self.lnpost)

    def log_likelihood_prior_batch(self, thetas):
        """``(lnL, lnprior)`` per walker, the split the tempered samplers
        temper, with one evaluation of each: the likelihood kernel's own
        lnL where the JAX package's path is a Pallas kernel
        (``kernel_lnl``), else, as its XLA path recovers it, ``lnpost -
        lnprior`` where the prior is finite and ``-inf`` elsewhere."""
        thetas = self.as_thetas(thetas)
        lp = self.prior(thetas)
        lnl = self._log_likelihood(thetas, self.lnpost)
        if self.kernel_lnl:
            return lnl, lp
        inf = torch.full_like(lp, -math.inf)
        post = torch.where(torch.isfinite(lp), lnl + lp, inf)
        return torch.where(torch.isfinite(lp), post - lp, inf), lp

    forward = log_posterior_batch

    def differentiable_log_posterior(self, thetas):
        """lnpost per walker on the gradient's path (``grad_mode``: the
        render and conv+lnL kernels where they cover the spec, else the
        general path, whatever ``lnpost`` is), differentiable in
        ``thetas`` through the kernels' backward kernels."""
        return self._log_posterior(thetas, self.grad_mode)

    def _log_posterior(self, thetas, mode):
        lp = self.prior(thetas)
        lnl = self._log_likelihood(thetas, mode)
        return torch.where(torch.isfinite(lp), lnl + lp, torch.full_like(lp, -math.inf))

    def log_posterior_and_grad(self, thetas):
        """``(lnpost (B,), dlnpost/dtheta (B, num_params))`` per walker:
        the batched counterpart of the JAX package's
        ``jax.vmap(jax.value_and_grad(fns.log_posterior))``."""
        return value_and_grad(self.differentiable_log_posterior,
                              self.as_thetas(thetas))

    def _convolve3(self, raw, sq, ps):
        c = self.consts
        out = convolve_rdft(
            torch.stack([raw, sq, ps], dim=-3),
            torch.stack([c.psf_r, c.var_r, c.psf_r]),
            torch.stack([c.psf_i, c.var_i, c.psf_i]),
            c.mats,
        )
        return out[..., 0, :, :], out[..., 1, :, :], out[..., 2, :, :]

    def _images(self, thetas, with_ps=True, obs: Optional[ObsStack] = None):
        """The carry images per walker (``ps_conv`` only ``with_ps``):
        render, convolutions (each walker with its PSF on the general
        path), crop, ``NoiseScale`` on the variance, then the sky plane.
        Against a stack ``obs`` (its general path): each walker's PSF from
        its target's spectra in survey mode, and its target's variance."""
        raw, ps = self.raw_and_ps(thetas)
        if self.lnpost == "general" or obs is not None:
            chans = (raw, raw * raw, ps) if with_ps else (raw, raw * raw)
            idx = self._psf_index(thetas)
            if obs is not None and obs.f_stack is not None:
                b = thetas.shape[0]
                target = torch.arange(b, device=self.device) // (b // obs.targets)
                kern = obs.f_stack[target, idx, :len(chans)]
            else:
                kern = self.f_stack[:, :len(chans)].index_select(0, idx)
            out = self._crop(convolve(torch.stack(chans, dim=1), kern))
            conv, model_var = out[:, 0], out[:, 1]
            ps_conv = out[:, 2] if with_ps else None
        else:
            conv, model_var, ps_conv = self._convolve3(raw, raw * raw, ps)
        raw = self._crop(raw)
        if obs is None:
            var = model_var + self.obs_var
        else:
            var = (obs.split(model_var) + obs.obs_var[:, None]).reshape(model_var.shape)
        if self._noise_ci is not None:
            var = var * self._noise_scale(thetas)[:, None, None]
        if self._grad_skies:
            plane = self._sky_plane(thetas)
            raw = raw + plane
            conv = conv + plane
        return {"raw": raw, "conv": conv, "var": var, "ps_conv": ps_conv}

    def images_batch(self, thetas) -> Dict[str, torch.Tensor]:
        """The four carry images per walker: raw, conv, var (model +
        observation variance, times the noise scale) and the convolved
        point sources."""
        return self._images(self.as_thetas(thetas))

    def lnpost_images_batch(self, thetas):
        """(lnpost, images) through :meth:`images_batch` and the plain
        likelihood of the spec's family — the same function as
        :meth:`log_posterior_batch` without the likelihood kernels."""
        thetas = self.as_thetas(thetas)
        lp = self.log_prior_batch(thetas)
        imgs = self.images_batch(thetas)
        lnl = self._lnlike(self.obs - imgs["conv"], 1.0 / imgs["var"], self.good,
                           imgs["conv"])
        lnpost = torch.where(
            torch.isfinite(lp), lnl + lp, torch.full_like(lp, -math.inf)
        )
        return lnpost, imgs

    def _pointwise(self, thetas, fns):
        imgs = self._images(self.as_thetas(thetas), with_ps=False)
        resid = self.obs - imgs["conv"]
        ivm = 1.0 / imgs["var"]
        return tuple(fn(resid, ivm, self.good, imgs["conv"]) for fn in fns)

    def pointwise_log_likelihood(self, thetas):
        """Per-pixel log-density maps ``(B, H, W)``, 0 at masked pixels;
        each sums to the walker's lnL."""
        return self._pointwise(thetas, (self._lnlike_pointwise,))[0]

    def pointwise_predictive_cdf(self, thetas):
        """Per-pixel ``P(y_rep <= y_obs | theta)`` maps ``(B, H, W)``, 0.5
        at masked pixels (LOO-PIT's per-draw ingredient)."""
        return self._pointwise(thetas, (self._cdf_pointwise,))[0]

    def pointwise_lnl_and_cdf(self, thetas):
        """(log-density maps, predictive-CDF maps) from one render."""
        return self._pointwise(thetas, (self._lnlike_pointwise, self._cdf_pointwise))

    def carry_image_shapes(self) -> Dict[str, tuple]:
        """Keys and shapes of :meth:`ensemble_carry_means`, without
        computing it (the sampler allocates its accumulators from them,
        as the JAX package does from a shape-only trace)."""
        return {k: self.shape for k in ("raw", "conv", "var", "ps_conv", "raw_m2")}

    def _convolve_groups(self, raw, sq, ps):
        """(conv, model var, ps conv) of per-PSF-group images ``(K, Hr,
        Wr)``, each group with its own PSF, cropped and summed over the
        groups."""
        if self.lnpost != "general":
            return self._convolve3(raw[0], sq[0], ps[0])
        out = self._crop(convolve(torch.stack([raw, sq, ps], dim=1), self.f_stack))
        out = out.sum(dim=0)
        return out[0], out[1], out[2]

    def ensemble_carry_means(self, thetas) -> Dict[str, torch.Tensor]:
        """Walker-mean carry images, three convolutions per PSF group.

        Convolution is linear, so the mean of ``conv(raw_w)``,
        ``conv(raw_w^2)`` and ``conv(ps_w)`` over the walkers that use
        one PSF is the convolution of their mean; the groups are summed
        with a one-hot product in full fp32.  ``NoiseScale`` is a
        per-walker weight on ``raw_w^2``, and the observation variance
        takes the walkers' mean scale.  ``raw_m2`` is the sum of squared
        deviations of the raw images about this batch's mean (deviation
        form: float32 never sees an O(mean^2) cancellation).
        """
        thetas = self.as_thetas(thetas)
        raws, pss = self.raw_and_ps(thetas)
        inv_n = 1.0 / raws.shape[0]
        sq = raws * raws
        mean_s = 1.0
        if self._noise_ci is not None:
            s = self._noise_scale(thetas)
            mean_s = s.mean()
            sq = sq * s[:, None, None]
        if self.spec.num_psfs == 1:
            groups = [t.sum(dim=0)[None] * inv_n for t in (raws, sq, pss)]
        else:
            psfs = torch.arange(self.spec.num_psfs, device=self.device)
            onehot = (self._psf_index(thetas)[:, None] == psfs).to(self.dtype)
            groups = [torch.einsum("wk,whx->khx", onehot, t) * inv_n
                      for t in (raws, sq, pss)]
        conv, model_var, ps_conv = self._convolve_groups(*groups)
        mean_raw = self._crop(groups[0].sum(dim=0))
        raws = self._crop(raws)
        if self._grad_skies:
            planes = self._sky_plane(thetas)
            mean_plane = planes.sum(dim=0) * inv_n
            mean_raw = mean_raw + mean_plane
            conv = conv + mean_plane
            raws = raws + planes
        return {
            "raw": mean_raw,
            "conv": conv,
            "var": model_var + mean_s * self.obs_var,
            "ps_conv": ps_conv,
            "raw_m2": ((raws - mean_raw) ** 2).sum(dim=0),
        }


def value_and_grad(fn, thetas):
    """``(fn(thetas), d sum(fn(thetas)) / d thetas)`` for a batched
    ``fn`` whose walkers do not interact: each row of the gradient is
    that walker's own."""
    thetas = thetas.detach().requires_grad_(True)
    with torch.enable_grad():
        value = fn(thetas)
        (grad,) = torch.autograd.grad(value.sum(), thetas)
    return value.detach(), grad


def build_posterior(spec: ModelSpec, device=None, dtype=torch.float32,
                    lnpost=None) -> PosteriorFns:
    """The posterior of ``spec`` on ``device`` (CUDA unless ``"cpu"`` is
    asked for; raises ``RuntimeError`` when CUDA is absent and no device
    is given), on the ``lnpost`` likelihood path (:func:`lnpost_mode`)."""
    return PosteriorFns(spec, device=device, dtype=dtype, lnpost=lnpost)
