"""Joint multi-band fits: one posterior over several observations (port of ``models/joint.py``).

Each band has its own observation, PSF stack, likelihood options and
components (typically its own magnitudes and sky); structural
parameters are shared between bands with
:class:`~psfmc_tpu_torch.models.components.Tied`, in pixel frame or,
through each band's WCS, in sky frame.  One global parameter vector
carries every band:

    lnpost(theta) = log_prior(theta) + sum_b lnL_b(theta),

the prior evaluated once over the union slot layout (a tie contributes
no slot, so nothing counts twice) and each band's likelihood on its own
path, as the JAX package sums each band's ``log_likelihood``:

* ``"batched"`` where the conv+likelihood kernel covers the band
  (:func:`~psfmc_tpu_torch.ops.kernels.conv_lnl.batched_lnl_supported`):
  the render kernel and the conv_lnl kernel with the band's own
  constants, on the FFT route for a cutout whose sides are even with no
  prime factor above 7, on the padded route for the other cutouts whose
  transform fits a block (every side up to 81) and on the matmul-DFT
  route for any other;
* ``"general"`` elsewhere (several PSFs, a NoiseScale, a sky gradient,
  ``conv_pad``, another likelihood family): the render kernel and plain
  PyTorch.

``PSFMC_LNPOST`` does not change that choice (the JAX joint posterior
never runs the fused kernel), and an explicit ``lnpost`` raises.  On CUDA
the whole joint step, every band included, is one captured CUDA graph of
the sampler.

Usage::

    host_r = Sersic(xy=Uniform(...), mag=Uniform(...), reff=..., ...)
    host_g = Sersic(xy=Tied(host_r, "xy", frame="sky"),
                    reff=Tied(host_r, "reff"), ..., mag=Uniform(...))
    model = JointModel([[config_r, Sky(...), host_r],
                        [config_g, Sky(...), host_g]])
    sampler = EnsembleSampler(nw, model.num_params, model.posterior_fns)

or a model file with several ``Configuration`` components through
:func:`~psfmc_tpu_torch.models.multicomponent.as_model` and the fitting
driver.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..ops.kernels.conv_lnl import batched_lnl_supported
from .components import ComponentBase, Configuration
from .multicomponent import (
    _random_state,
    carry_to_reference_images,
    replicate_noise,
    trace_param_matrix,
)
from .posterior import LogPrior, PosteriorFns, value_and_grad
from .spec import (
    ModelSpec,
    _check_poisson_inputs,
    build_param_slots,
    comp_spec_for,
    config_wcs_frame,
    psf_spectra_for,
)

__all__ = ["JointModel", "JointPosteriorFns", "JointSpec", "build_joint_specs"]


def build_joint_specs(bands):
    """Compile per-band component lists into band specs and the layout.

    :param bands: a list of component lists, each with its own
        :class:`Configuration`; a component may tie to another band's.
    :returns: ``(band_specs, slots, num_params, all_comp_specs,
        unique_components)``: the band specs carry global offsets in
        their rules and no slots (a band contributes its likelihood only;
        the prior is evaluated once over ``slots``).
    """
    band_lists, configs = [], []
    all_components: List[ComponentBase] = []
    for comps in bands:
        comps = list(comps)
        cfgs = [c for c in comps if isinstance(c, Configuration)]
        if not cfgs:
            raise ValueError("every band needs its own Configuration component")
        config = cfgs[0]
        comps = [c for c in comps if not isinstance(c, Configuration)]
        comps.append(config.psf_selector)
        configs.append(config)
        band_lists.append(comps)
        all_components.extend(comps)

    # canonical global names: band order, file order within a band
    for count, comp in enumerate(all_components):
        comp.update_stochastic_names(count=count)
    # with more than one band sampling its PSF index the single-band name
    # 'PSF_Index' would name several trace columns: one per band instead
    stoch_selectors = [(bi, comps[-1]) for bi, comps in enumerate(band_lists)
                       if "psf_index" in comps[-1]._priors]
    if len(stoch_selectors) > 1:
        for bi, sel in stoch_selectors:
            prior = sel._priors["psf_index"]
            prior.name = f"B{bi}_PSF_Index"
            prior.fitsname = f"B{bi}PSFIX"

    slots, slot_map, num_params = build_param_slots(all_components)
    names = [s.name for s in slots]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate parameter names in the joint layout: {dupes}")

    # each component maps to its band's WCS frame; a component shared by
    # bands of different frames is "ambiguous", and a sky tie through it
    # raises
    wcs_map = {}
    for comps, config in zip(band_lists, configs):
        frame = config_wcs_frame(config)
        if frame is None:
            continue
        for c in comps:
            prev = wcs_map.get(id(c))
            wcs_map[id(c)] = ("ambiguous" if prev is not None and prev is not frame
                              else frame)

    band_specs, all_comp_specs = [], []
    for comps, config in zip(band_lists, configs):
        comp_specs = [comp_spec_for(c, slot_map, wcs_map) for c in comps]
        all_comp_specs.extend(comp_specs)
        if config.likelihood == "poisson":
            _check_poisson_inputs(config, comp_specs)
        f_psf_stack, f_var_stack = psf_spectra_for(config)
        band_specs.append(ModelSpec(
            comp_specs=comp_specs,
            slots=[],  # the prior and its constraints live in the joint prior
            num_params=num_params,
            shape=tuple(config.obs_data.shape),
            mag_zeropoint=float(config.mag_zeropoint),
            obs_data=np.asarray(config.obs_data, np.float64),
            obs_var=np.asarray(config.obs_var, np.float64),
            bad_px=np.asarray(config.bad_px, bool),
            f_psf_stack=f_psf_stack,
            f_var_stack=f_var_stack,
            num_psfs=len(config.psf_selector.spatial_psfs),
            likelihood=config.likelihood,
            likelihood_df=config.likelihood_df,
            likelihood_gain=config.likelihood_gain,
            conv_pad=config.conv_pad,
            render_oversample=config.render_oversample,
            oversample_window=config.oversample_window,
        ))
    # unique components in global order: the list the slots came from, so
    # the prior draws' columns line up with them
    unique, seen = [], set()
    for comp in all_components:
        if id(comp) not in seen:
            seen.add(id(comp))
            unique.append(comp)
    return band_specs, slots, num_params, all_comp_specs, unique


class JointSpec:
    """The global layout and the band specs."""

    def __init__(self, band_specs, slots, num_params, comp_specs):
        self.band_specs = band_specs
        self.slots = slots
        self.num_params = num_params
        self.comp_specs = comp_specs  # every band's, in band order

    @property
    def param_names(self):
        return [s.name for s in self.slots]

    @property
    def param_fits_abbrs(self):
        return [s.fitsname for s in self.slots]

    @property
    def param_lens(self):
        return [s.size for s in self.slots]


def _band_lnpost(band_spec):
    """The path a band takes by default: ``"batched"`` where the
    conv+likelihood kernel covers it, else ``"general"``."""
    return "batched" if batched_lnl_supported(band_spec)[0] else "general"


class JointPosteriorFns(nn.Module):
    """The joint posterior on one device: the joint prior
    (:class:`~psfmc_tpu_torch.models.posterior.LogPrior` over the union
    slots and every band's components) plus one
    :class:`~psfmc_tpu_torch.models.posterior.PosteriorFns` per band,
    each with its own constants and path (``band_fns[i].lnpost``).

    The surface the sampler and the driver read: ``device``, ``dtype``,
    :meth:`log_posterior_batch` (``forward``), :meth:`log_prior_batch`,
    :meth:`images_batch` and :meth:`lnpost_images_batch`,
    :meth:`carry_image_shapes` and :meth:`ensemble_carry_means` (keys
    ``b{i}_<carry>``), and :meth:`render_images`.
    """

    def __init__(self, jspec: JointSpec, device=None, dtype=torch.float32,
                 lnpost=None):
        super().__init__()
        if lnpost is not None:
            raise ValueError(
                f"lnpost={lnpost!r} does not apply to a joint model: each band "
                "takes 'batched' where the conv+likelihood kernel covers it, "
                "else 'general' (the joint posterior never runs the fused "
                "kernel)")
        device = resolve_device(device)
        self.spec = jspec
        self.dtype = dtype
        self.band_fns = nn.ModuleList(
            PosteriorFns(bs, device=device, dtype=dtype, lnpost=_band_lnpost(bs))
            for bs in jspec.band_specs)
        self.prior = LogPrior(jspec.slots, jspec.comp_specs, device, dtype)

    @property
    def device(self) -> torch.device:
        return self.band_fns[0].device

    @property
    def lnpost(self):
        """Each band's likelihood path."""
        return tuple(f.lnpost for f in self.band_fns)

    def as_thetas(self, thetas):
        return self.band_fns[0].as_thetas(thetas)

    def log_prior_batch(self, thetas):
        """The joint log-prior per walker; NaN -> ``-inf``."""
        return self.prior(self.as_thetas(thetas))

    def log_likelihood_batch(self, thetas):
        """The sum of the bands' lnL per walker, each on its own path."""
        thetas = self.as_thetas(thetas)
        lnl = thetas.new_zeros(thetas.shape[0])
        for f in self.band_fns:
            lnl = lnl + f.log_likelihood_batch(thetas)
        return lnl

    @staticmethod
    def _joint(lp, lnl):
        out = torch.where(torch.isfinite(lp), lp + lnl, torch.full_like(lp, -math.inf))
        return torch.where(torch.isnan(out), torch.full_like(out, -math.inf), out)

    def log_posterior_batch(self, thetas):
        """lnpost per walker: the joint prior plus every band's lnL,
        ``-inf`` outside the prior and for NaN."""
        thetas = self.as_thetas(thetas)
        return self._joint(self.log_prior_batch(thetas),
                           self.log_likelihood_batch(thetas))

    def log_likelihood_prior_batch(self, thetas):
        """``(lnL, lnprior)`` per walker for the tempered samplers, as the
        JAX package splits its joint posterior: ``lnpost - lnprior`` where
        the prior is finite, ``-inf`` elsewhere."""
        thetas = self.as_thetas(thetas)
        lp = self.log_prior_batch(thetas)
        post = self._joint(lp, self.log_likelihood_batch(thetas))
        return torch.where(torch.isfinite(lp), post - lp,
                           torch.full_like(lp, -math.inf)), lp

    forward = log_posterior_batch

    def differentiable_log_posterior(self, thetas):
        """lnpost per walker with every band on its gradient's path (its
        own: the batched kernels where they cover the band, else the
        general path), differentiable in ``thetas``."""
        lnl = thetas.new_zeros(thetas.shape[0])
        for f in self.band_fns:
            lnl = lnl + f._log_likelihood(thetas, f.grad_mode)
        return self._joint(self.prior(thetas), lnl)

    def log_posterior_and_grad(self, thetas):
        """``(lnpost (B,), dlnpost/dtheta (B, num_params))`` per walker."""
        return value_and_grad(self.differentiable_log_posterior,
                              self.as_thetas(thetas))

    def images_batch(self, thetas):
        """Every band's four carry images per walker, ``b{i}_<carry>``."""
        thetas = self.as_thetas(thetas)
        return {f"b{i}_{k}": v for i, f in enumerate(self.band_fns)
                for k, v in f.images_batch(thetas).items()}

    def lnpost_images_batch(self, thetas):
        """(lnpost, images) through :meth:`images_batch` and each band's
        plain likelihood, without the likelihood kernels."""
        thetas = self.as_thetas(thetas)
        lnl = thetas.new_zeros(thetas.shape[0])
        out = {}
        for i, f in enumerate(self.band_fns):
            imgs = f.images_batch(thetas)
            lnl = lnl + f._lnlike(f.obs - imgs["conv"], 1.0 / imgs["var"], f.good,
                                  imgs["conv"])
            out.update({f"b{i}_{k}": v for k, v in imgs.items()})
        return self._joint(self.log_prior_batch(thetas), lnl), out

    def carry_image_shapes(self):
        return {f"b{i}_{k}": s for i, f in enumerate(self.band_fns)
                for k, s in f.carry_image_shapes().items()}

    def ensemble_carry_means(self, thetas):
        """Every band's walker-mean carry images (three convolutions per
        PSF group and band), ``b{i}_<carry>``."""
        thetas = self.as_thetas(thetas)
        return {f"b{i}_{k}": v for i, f in enumerate(self.band_fns)
                for k, v in f.ensemble_carry_means(thetas).items()}

    def render_images(self, thetas):
        """The five reference image types of every band per walker,
        ``b{i}_<type>``, as ``(B, H_i, W_i)`` tensors."""
        thetas = self.as_thetas(thetas)
        out = {}
        for i, f in enumerate(self.band_fns):
            imgs = carry_to_reference_images(f.images_batch(thetas), f.obs)
            out.update({f"b{i}_{k}": v for k, v in imgs.items()})
        return out


class JointModel:
    """Host facade over a joint multi-band model: the
    ``MultiComponentModel`` surface that the sampler, the trace database
    and the driver read.

    :param bands: a list of component lists, each with its own
        Configuration.
    :param device: the posterior's device (CUDA unless ``"cpu"``).
    :param dtype: its working dtype (float32 on CUDA).
    :param lnpost: None: each band takes its own path; any other value
        raises ``ValueError``.
    """

    def __init__(self, bands, device=None, dtype=torch.float32, lnpost=None):
        band_specs, slots, num_params, all_cs, components = build_joint_specs(bands)
        self.spec = JointSpec(band_specs, slots, num_params, all_cs)
        self.posterior_fns = JointPosteriorFns(self.spec, device=device,
                                               dtype=dtype, lnpost=lnpost)
        self._components = components
        self.accumulated_samples = 0

    @property
    def num_params(self):
        return self.spec.num_params

    @property
    def param_names(self):
        return self.spec.param_names

    @property
    def param_fits_abbrs(self):
        return self.spec.param_fits_abbrs

    @property
    def param_lens(self):
        return self.spec.param_lens

    def set_accumulated_from_sampler(self, sampler):
        """Driver hook: the image writer reads the sampler's per-band
        accumulators itself, so only the count is kept."""
        self.accumulated_samples = sampler.accumulated_samples

    def thetas_from_database(self, database, rows=None):
        """``(N, num_params)`` parameter matrix of a trace database (the
        global slot layout)."""
        thetas = trace_param_matrix(database, self.param_names)
        return thetas if rows is None else thetas[rows]

    def init_params_from_priors(self, nwalkers, random_state=None, max_tries=1000):
        """``(nwalkers, num_params)`` prior draws over the global layout
        (each component's constraints by vectorised rejection)."""
        if random_state is None:
            random_state = np.random.RandomState()
        cols = [c.draw_batch(nwalkers, random_state=random_state,
                             max_tries=max_tries) for c in self._components]
        if not cols:
            return np.zeros((nwalkers, 0))
        return np.concatenate(cols, axis=1)

    def simulate(self, theta=None, random_state=None, add_noise=True):
        """A mock observation per band at one parameter vector: the
        band's convolved model plus its noise (:func:`replicate_noise` at
        the observation's sigma, 0 at bad pixels).  Returns ``(mocks,
        theta)``: a list of ``(H_b, W_b)`` float64 images and the vector."""
        rng = _random_state(random_state)
        if theta is None:
            theta = self.init_params_from_priors(1, random_state=rng)[0]
        theta = np.asarray(theta, np.float64)
        mocks = []
        for bs, f in zip(self.spec.band_specs, self.posterior_fns.band_fns):
            conv = f.images_batch(theta[None])["conv"][0].to("cpu", torch.float64).numpy()
            if add_noise:
                var = np.asarray(bs.obs_var, np.float64)
                sigma = np.where(np.isfinite(var), np.sqrt(var), 0.0)
                conv = replicate_noise(rng, conv, bs, sigma)
            mocks.append(conv)
        return mocks, theta

    def save_posterior_images(self, sampler, output_name, database=None,
                              filetypes=None, criticism_draws=0):
        """Write each band's five posterior-mean image products as
        ``<output_name>_b{i}_<type>.fits``, with the ``MCBAND`` and
        ``MCACCUM`` cards and, given the trace ``database``, each
        parameter's posterior mean and standard deviation under its FITS
        abbreviation.

        ``sampler`` is anything with ``accumulated_images`` and
        ``accumulated_samples`` (a sampler, or the accumulators of a
        checkpoint).  The means cover every walker's retained states (the
        single-band writer's stuck-walker filter is single-band only).
        ``criticism_draws`` other than 0, given the ``database``, adds the
        criticism block (:func:`~psfmc_tpu_torch.analysis.
        model_comparison.criticism_header_stats`), computed once over
        every band's pixels, to every band's headers; a trace with too few
        usable draws for it warns and leaves the block out.
        """
        from ..analysis.images import default_filetypes, write_image_products
        from ..analysis.model_comparison import criticism_cards_or_warn
        from ..database import annotate_metadata
        from ..io import fits

        accum = sampler.accumulated_images
        n = sampler.accumulated_samples
        if accum is None or n == 0:
            raise ValueError("sampler has no accumulated images: run retained "
                             "sampling first")
        filetypes = default_filetypes if filetypes is None else filetypes
        criticism = {}
        if criticism_draws and database is not None:
            criticism = criticism_cards_or_warn(self, database, criticism_draws)
        for i, bs in enumerate(self.spec.band_specs):
            carries = {k: np.asarray(accum[f"b{i}_{k}"], np.float64)
                       for k in ("raw", "conv", "var", "ps_conv")}
            images = carry_to_reference_images(carries, np.asarray(bs.obs_data))
            header = fits.Header()
            header.set("MCBAND", i, "joint-fit band index")
            header.set("MCACCUM", int(n), "posterior samples averaged")
            if database is not None:
                stats = {}
                for name, abbr in zip(self.param_names, self.param_fits_abbrs):
                    col = np.asarray(database[name], np.float64)
                    m, sd = np.mean(col, axis=0), np.std(col, axis=0)
                    if np.ndim(m) == 0:
                        stats[abbr] = f"{m:0.4g} +/- {sd:0.4g}"
                    else:
                        stats[abbr] = ("(" + ",".join(f"{v:0.4g}" for v in m)
                                       + ") +/- ("
                                       + ",".join(f"{v:0.4g}" for v in sd) + ")")
                for key, value in annotate_metadata(stats).items():
                    header.set(key, value[0], value[1])
            for key, (value, comment) in criticism.items():
                header.set(key, value, comment)
            write_image_products(f"{output_name}_b{i}", images, header, filetypes)
