"""Batched log-posterior over a :class:`ModelSpec` (port of ``models/posterior.py``).

The JAX package traces one walker's ``lnpost(theta)`` and lets ``vmap``
add the walker axis; here every function takes a ``(B, num_params)``
batch of thetas and works on the batch directly.  The sampling path,
:meth:`PosteriorFns.log_posterior_batch`, has the shape of the JAX
package's ``PSFMC_LNPOST=pallas_batched`` path:

1. per-walker scalar prep in torch: the prior, the sky and the nine
   packed scalars of each Sersic (:func:`sersic_scalar_params`);
2. the **render kernel**: ``raw = sky + sum of Sersics``, ``(B, H, W)``;
3. ``raw += sum of point sources``, rank-1 ``fky ⊗ kx`` outer products;
4. the **conv+likelihood kernel**: the Gaussian lnL per walker;
5. ``lnpost = lnl + prior`` where the prior is finite, else ``-inf``.

On CUDA, steps 2 and 4 are the hand-written kernels of
:mod:`psfmc_tpu_torch.ops.kernels`; on the CPU their plain versions.

The image products (:meth:`images_batch`, :meth:`ensemble_carry_means`)
use the same render and the plain ``convolve_rdft`` products; the
ensemble means exploit linearity: the walker mean of ``conv(raw_w)`` is
``conv(mean raw)``, so a step costs three convolutions, not three per
walker.
"""
from __future__ import annotations

import math
from dataclasses import fields
from typing import Dict

import numpy as np
import torch
from torch import nn

from .._device import pin_fp32_matmul, resolve_device
from ..ops.fourier import convolve_rdft
from ..ops.kernels.conv_lnl import (
    ConvLnlConsts,
    batched_conv_lnl,
    make_conv_lnl_consts,
)
from ..ops.kernels.sersic_render import (
    PARAMS_PER_SERSIC,
    pack_sersic_params,
    render_sersics,
)
from ..ops.likelihood import gaussian_lnlike
from ..ops.pointsource import render_pointsource_dense
from ..ops.sersic import sersic_scalar_params
from .spec import ModelSpec, check_in_slice

__all__ = ["PosteriorFns", "build_posterior"]


class PosteriorFns(nn.Module):
    """The flagship posterior on one device.

    Every constant (observation, variance, mask, PSF spectra, DFT
    operators, prior hyperparameters, constant parameter values) is a
    buffer on the module's device.  ``forward`` is
    :meth:`log_posterior_batch`.
    """

    def __init__(self, spec: ModelSpec, device=None, dtype=torch.float32):
        super().__init__()
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

        consts = make_conv_lnl_consts(
            spec.f_psf_stack[0], spec.f_var_stack[0], spec.obs_data,
            spec.obs_var, ~np.asarray(spec.bad_px, bool), device, dtype,
        )
        for f in fields(ConvLnlConsts):
            self.register_buffer("c_" + f.name, getattr(consts, f.name),
                                 persistent=False)
        for i, slot in enumerate(spec.slots):
            loc, scale = slot.dist.torch_params(dtype, device)
            self.register_buffer(f"prior{i}_loc", loc, persistent=False)
            self.register_buffer(f"prior{i}_scale", scale, persistent=False)
        # constant parameter values become buffers once, here
        for ci, cs in enumerate(spec.comp_specs):
            for attr, (kind, payload) in cs.params.items():
                if kind == "const" and cs.kind != "psfselector":
                    self.register_buffer(
                        f"const{ci}_{attr}",
                        torch.as_tensor(np.asarray(payload, np.float64),
                                        dtype=dtype, device=device),
                        persistent=False,
                    )

    # -- constants -------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.c_obs.device

    @property
    def consts(self) -> ConvLnlConsts:
        return ConvLnlConsts(
            **{f.name: getattr(self, "c_" + f.name) for f in fields(ConvLnlConsts)}
        )

    def _get(self, ci, name, thetas):
        """Parameter ``name`` of component ``ci`` for every walker:
        ``(B,)`` for a scalar, ``(B, size)`` for a vector."""
        kind, payload = self.spec.comp_specs[ci].params[name]
        if kind == "const":
            t = getattr(self, f"const{ci}_{name}")
            return t.expand(thetas.shape[0], *t.shape)
        offset, size = payload
        if size == 1:
            return thetas[:, offset]
        return thetas[:, offset:offset + size]

    def as_thetas(self, thetas):
        thetas = torch.as_tensor(thetas, dtype=self.dtype, device=self.device)
        if thetas.ndim != 2 or thetas.shape[1] != self.spec.num_params:
            raise ValueError(
                f"thetas must be (B, {self.spec.num_params}), "
                f"got {tuple(thetas.shape)}"
            )
        return thetas

    # -- prior -----------------------------------------------------------
    def log_prior_batch(self, thetas):
        """Joint log-prior per walker, with the Sersic ``reff >= reff_b``
        constraint; NaN -> ``-inf``."""
        thetas = self.as_thetas(thetas)
        lp = torch.zeros(thetas.shape[0], dtype=self.dtype, device=self.device)
        for i, slot in enumerate(self.spec.slots):
            x = thetas[:, slot.offset:slot.offset + slot.size]
            params = (getattr(self, f"prior{i}_loc"),
                      getattr(self, f"prior{i}_scale"))
            lp = lp + slot.dist.torch_logp(x, params).sum(dim=-1)
        neg_inf = torch.full_like(lp, -math.inf)
        for ci, cs in enumerate(self.spec.comp_specs):
            if cs.kind == "sersic":
                a = self._get(ci, "reff", thetas)
                b = self._get(ci, "reff_b", thetas)
                lp = torch.where(b > a, neg_inf, lp)
        return torch.where(torch.isnan(lp), neg_inf, lp)

    # -- renders ---------------------------------------------------------
    def render_inputs(self, thetas):
        """(packed Sersic rows ``(B, S, 9)``, sky ``(B,)``) for the render."""
        thetas = self.as_thetas(thetas)
        b = thetas.shape[0]
        sky = torch.zeros(b, dtype=self.dtype, device=self.device)
        rows = []
        for ci, cs in enumerate(self.spec.comp_specs):
            if cs.kind == "sky":
                sky = sky + self._get(ci, "adu", thetas)
            elif cs.kind == "sersic":
                g = [self._get(ci, n, thetas)
                     for n in ("xy", "mag", "reff", "reff_b", "index", "angle")]
                rows.append(pack_sersic_params(sersic_scalar_params(
                    *g, self.mag_zp, cs.static["angle_degrees"], "table",
                )))
        if rows:
            params = torch.stack(rows, dim=1)
        else:
            params = torch.zeros((b, 0, PARAMS_PER_SERSIC), dtype=self.dtype,
                                 device=self.device)
        return params, sky

    def raw_and_ps(self, thetas):
        """Raw composite model ``(B, H, W)`` and its point-source part."""
        thetas = self.as_thetas(thetas)
        params, sky = self.render_inputs(thetas)
        raw = render_sersics(params.contiguous(), sky.contiguous(), self.shape)
        ps = torch.zeros_like(raw)
        for ci, cs in enumerate(self.spec.comp_specs):
            if cs.kind == "pointsource":
                ps = ps + render_pointsource_dense(
                    self.shape, self._get(ci, "xy", thetas),
                    self._get(ci, "mag", thetas), self.mag_zp,
                    cs.static.get("shift_method", "lanczos3"),
                )
        return raw + ps, ps

    # -- posterior -------------------------------------------------------
    def log_posterior_batch(self, thetas):
        """lnpost per walker through the render and conv+lnL kernels."""
        thetas = self.as_thetas(thetas)
        lp = self.log_prior_batch(thetas)
        raw, _ = self.raw_and_ps(thetas)
        lnl = batched_conv_lnl(raw, self.consts)
        return torch.where(
            torch.isfinite(lp), lnl + lp, torch.full_like(lp, -math.inf)
        )

    forward = log_posterior_batch

    def _convolve3(self, raw, sq, ps):
        c = self.consts
        out = convolve_rdft(
            torch.stack([raw, sq, ps], dim=-3),
            torch.stack([c.psf_r, c.var_r, c.psf_r]),
            torch.stack([c.psf_i, c.var_i, c.psf_i]),
            c.mats,
        )
        return out[..., 0, :, :], out[..., 1, :, :], out[..., 2, :, :]

    def images_batch(self, thetas) -> Dict[str, torch.Tensor]:
        """The four carry images per walker: raw, conv, var (model +
        observation variance) and the convolved point sources."""
        raw, ps = self.raw_and_ps(thetas)
        conv, model_var, ps_conv = self._convolve3(raw, raw * raw, ps)
        return {"raw": raw, "conv": conv, "var": model_var + self.c_obs_var,
                "ps_conv": ps_conv}

    def lnpost_images_batch(self, thetas):
        """(lnpost, images) through :meth:`images_batch` and the plain
        ``gaussian_lnlike`` — the same function as
        :meth:`log_posterior_batch` without the conv+lnL kernel."""
        thetas = self.as_thetas(thetas)
        lp = self.log_prior_batch(thetas)
        imgs = self.images_batch(thetas)
        lnl = gaussian_lnlike(self.c_obs - imgs["conv"], 1.0 / imgs["var"],
                              self.c_good)
        lnpost = torch.where(
            torch.isfinite(lp), lnl + lp, torch.full_like(lp, -math.inf)
        )
        return lnpost, imgs

    def ensemble_carry_means(self, thetas) -> Dict[str, torch.Tensor]:
        """Walker-mean carry images, three convolutions per call.

        Convolution is linear, so the mean of ``conv(raw_w)``,
        ``conv(raw_w^2)`` and ``conv(ps_w)`` over walkers is the
        convolution of the walker means.  ``raw_m2`` is the sum of
        squared deviations of the raw images about this batch's mean
        (deviation form: float32 never sees an O(mean^2) cancellation).
        """
        raws, pss = self.raw_and_ps(thetas)
        inv_n = 1.0 / raws.shape[0]
        mean_raw = raws.sum(dim=0) * inv_n
        mean_sq = (raws * raws).sum(dim=0) * inv_n
        mean_ps = pss.sum(dim=0) * inv_n
        conv, var, ps_conv = self._convolve3(mean_raw, mean_sq, mean_ps)
        return {
            "raw": mean_raw,
            "conv": conv,
            "var": var + self.c_obs_var,
            "ps_conv": ps_conv,
            "raw_m2": ((raws - mean_raw) ** 2).sum(dim=0),
        }


def build_posterior(spec: ModelSpec, device=None,
                    dtype=torch.float32) -> PosteriorFns:
    """The posterior of ``spec`` on ``device`` (CUDA unless ``"cpu"`` is
    asked for; raises ``RuntimeError`` when CUDA is absent and no device
    is given)."""
    return PosteriorFns(spec, device=device, dtype=dtype)
