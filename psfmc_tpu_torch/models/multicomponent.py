"""MultiComponentModel: the model the fitting driver fits (port of ``models/multicomponent.py``, single band).

A thin host facade over a :class:`~.spec.ModelSpec` and its
:class:`~.posterior.PosteriorFns`, with the reference's model API:
construction from a component list or a model file, parameter names and
lengths, the current parameter vector (``param_values``, which sets each
component's prior values), ``get_distribution``, the host's scipy
``log_priors``, ``log_posterior(theta)`` and the five image methods at
the current vector, prior draws for the walkers' start, ``simulate``,
the five reference image types of a batch of parameter vectors, the
posterior-mean images (adopted from the sampler's accumulators or
replayed from a chain), posterior-predictive mocks and the
posterior-predictive p-value of the ``MCPPCP`` header card.

A component list or model file with several ``Configuration``
components is a joint multi-band model: :func:`as_model` splits it at
each ``Configuration`` into bands and builds a
:class:`~psfmc_tpu_torch.models.joint.JointModel`.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

from .components import ComponentBase, Configuration
from .posterior import IMAGE_TYPES, build_posterior
from .spec import build_model_spec

__all__ = ["MultiComponentModel", "as_model", "replicate_noise",
           "poisson_deviance", "trace_param_matrix", "slot_param_names",
           "IMAGE_TYPES"]


def replicate_noise(rng, conv, spec, sigma):
    """Replicated data under ``spec.likelihood``, the JAX package's one
    rule: Gaussian or Student-t (static df) noise at ``sigma`` around
    ``conv``, or Poisson counts at ``gain * conv`` (clipped at 0) scaled
    back to observation units (``sigma`` unused)."""
    if spec.likelihood == "poisson":
        g = float(spec.likelihood_gain)
        return rng.poisson(np.maximum(conv, 0.0) * g) / g
    if spec.likelihood == "student":
        noise = rng.standard_t(float(spec.likelihood_df), size=conv.shape)
    else:
        noise = rng.randn(*conv.shape)
    return conv + noise * sigma


def poisson_deviance(counts, mu, good):
    """``2 sum_good (mu - k + k ln(k / mu))`` over the trailing image axes,
    at good pixels with ``mu > 0`` (the ``k = 0`` term is ``2 mu``)."""
    ok = good & (mu > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(counts > 0,
                     counts * np.log(np.where(counts > 0, counts, 1.0)
                                     / np.where(mu > 0, mu, 1.0)), 0.0)
    return 2.0 * np.sum(np.where(ok, mu - counts + r, 0.0), axis=(-2, -1))


def trace_param_matrix(database, param_names):
    """``(N, num_params)`` parameter matrix of a trace database: its columns
    in slot order (``xy`` two wide)."""
    return np.concatenate(
        [np.asarray(database[name], np.float64).reshape(len(database), -1)
         for name in param_names], axis=1)


def slot_param_names(param_names, param_lens):
    """One display name per slot: ``xy`` -> ``xy_x`` / ``xy_y``, a wider
    vector ``name_0``, ``name_1``, ...  (the per-slot results tables, such
    as the sensitivity indices, use it)."""
    lens = param_lens or [1] * len(param_names)
    out = []
    for name, ln in zip(param_names, lens):
        if ln == 1:
            out.append(name)
        elif ln == 2:
            out.extend([f"{name}_x", f"{name}_y"])
        else:
            out.extend(f"{name}_{j}" for j in range(ln))
    return out


def _random_state(random_state):
    return (random_state if isinstance(random_state, np.random.RandomState)
            else np.random.RandomState(random_state))


def carry_to_reference_images(imgs: Dict[str, np.ndarray], obs_data):
    """The carry basis (raw, conv, var, ps_conv) -> the five image types."""
    return {
        "raw_model": imgs["raw"],
        "convolved_model": imgs["conv"],
        "residual": obs_data - imgs["conv"],
        "composite_ivm": 1.0 / imgs["var"],
        "point_source_subtracted": obs_data - imgs["ps_conv"],
    }


def _components_from_file(path):
    from ..model_parser import component_list_from_file

    try:
        return component_list_from_file(path)
    except IOError as err:
        raise IOError(f"Unable to open model file {path}. Does it exist?") from err


def as_model(model, device=None, lnpost=None, dtype=torch.float32):
    """A model from a model file name, a component list or a prepared
    model (anything with ``posterior_fns`` and ``init_params_from_priors``
    passes through unchanged), on ``device`` in ``dtype``.

    A file or list with several ``Configuration`` components builds a
    :class:`~psfmc_tpu_torch.models.joint.JointModel`: each
    ``Configuration`` starts a band, and the components after it belong
    to that band.  The one dispatch rule of the driver.
    """
    if hasattr(model, "posterior_fns") and hasattr(model, "init_params_from_priors"):
        return model
    if isinstance(model, str):
        components = _components_from_file(model)
    else:
        components = list(model)
    if sum(isinstance(c, Configuration) for c in components) <= 1:
        return MultiComponentModel(components, device=device, dtype=dtype,
                                   lnpost=lnpost)
    from .joint import JointModel

    if not isinstance(components[0], Configuration):
        raise ValueError(
            "a multi-band model must start with its first band's "
            "Configuration (components before the first Configuration "
            "have no band to belong to)")
    bands = []
    for comp in components:
        if isinstance(comp, Configuration):
            bands.append([comp])
        else:
            bands[-1].append(comp)
    return JointModel(bands, device=device, dtype=dtype, lnpost=lnpost)


class MultiComponentModel:
    """Composite 2-D surface-brightness model over a component list.

    :param components: component list (with one ``Configuration``), or
        the file name of a model-definition file.
    :param device: the posterior's device (CUDA unless ``"cpu"``).
    :param dtype: its working dtype (float32 on CUDA).
    :param lnpost: its likelihood path (``"batched"``, ``"fused"``,
        ``"general"`` or None for ``PSFMC_LNPOST`` and the spec).
    """

    def __init__(self, components, device=None, dtype=torch.float32,
                 lnpost=None):
        if isinstance(components, str):
            components = _components_from_file(components)
        configs = [c for c in components if isinstance(c, Configuration)]
        if not configs:
            raise ValueError(
                "Unable to find the Configuration component, required for "
                "setting up input images."
            )
        if len(configs) > 1:
            warnings.warn(
                f"{len(configs)} Configuration components given to the "
                "single-observation MultiComponentModel — only the first is "
                "used.  For a joint multi-band fit pass the components "
                "through as_model()/model_galaxy_mcmc (each Configuration "
                "starts a band) or build a JointModel.")
        self.config = configs[0]
        self.spec = build_model_spec(list(components), config=self.config)
        self.posterior_fns = build_posterior(self.spec, device=device,
                                             dtype=dtype, lnpost=lnpost)
        comp_order: List[ComponentBase] = [
            c for c in components if not isinstance(c, Configuration)
        ]
        comp_order.append(self.config.psf_selector)
        self.components = comp_order
        self.obs_header = self.config.obs_header
        self._param_vector = np.zeros(self.num_params)
        self.posterior_images: Dict[str, np.ndarray] = {}
        self.accumulated_samples = 0
        self.reset_images()

    # -- parameter layout ---------------------------------------------------
    @property
    def num_params(self) -> int:
        return self.spec.num_params

    @property
    def param_names(self) -> List[str]:
        return self.spec.param_names

    @property
    def param_fits_abbrs(self) -> List[str]:
        return self.spec.param_fits_abbrs

    @property
    def param_lens(self) -> List[int]:
        return self.spec.param_lens

    @property
    def param_values(self):
        """The current parameter vector, split by parameter name."""
        split = np.split(self._param_vector, np.cumsum(self.param_lens)[:-1])
        return dict(zip(self.param_names, split))

    @param_values.setter
    def param_values(self, value_vector):
        value_vector = np.asarray(value_vector, dtype=np.float64).ravel()
        if value_vector.size != self.num_params:
            raise ValueError(
                f"Expected {self.num_params} parameters, got {value_vector.size}")
        self._param_vector = value_vector
        start = 0
        for comp in self.components:
            n = comp.num_stochastics()
            comp.set_stochastic_values(value_vector[start:start + n])
            start += n

    def get_distribution(self, param_name):
        """The prior of trace name ``param_name``, or None."""
        for comp in self.components:
            try:
                return comp.get_distribution(param_name)
            except KeyError:
                pass
        return None

    # -- priors and posterior ---------------------------------------------
    def log_priors(self) -> float:
        """Joint log-prior (host scipy) at the current parameter values."""
        return float(np.sum([comp.log_priors() for comp in self.components]))

    def log_posterior(self, param_values, **kwargs):
        """``(lnp, images)`` at one parameter vector, through the
        posterior's :meth:`~.posterior.PosteriorFns.lnpost_images_batch`
        (the reference's signature: a ``model=`` keyword is accepted and
        ignored); the vector becomes the current one."""
        kwargs.pop("model", None)
        theta = np.asarray(param_values, dtype=np.float64)
        lnp, imgs = self.posterior_fns.lnpost_images_batch(theta[None])
        self.param_values = theta
        host = {k: v[0].to("cpu", torch.float64).numpy() for k, v in imgs.items()}
        return float(lnp[0]), carry_to_reference_images(
            host, np.asarray(self.spec.obs_data))

    def init_params_from_priors(self, nwalkers, random_state=None,
                                max_tries=1000):
        """``(nwalkers, num_params)`` starting positions drawn from the
        priors, each component's joint constraint enforced by vectorised
        rejection (the JAX package's draws for the same RandomState)."""
        if random_state is None:
            random_state = np.random.RandomState()
        cols = [c.draw_batch(nwalkers, random_state=random_state,
                             max_tries=max_tries) for c in self.components]
        return np.concatenate(cols, axis=1)

    # -- images ---------------------------------------------------------------
    def render_images_batch(self, thetas):
        """``(n, num_params)`` -> the five image types, ``(n, H, W)`` float64
        numpy each."""
        imgs = self.posterior_fns.images_batch(thetas)
        host = {k: v.to("cpu", torch.float64).numpy() for k, v in imgs.items()}
        return carry_to_reference_images(host, np.asarray(self.spec.obs_data))

    # -- images at the current parameter vector -------------------------
    def _current_images(self):
        return {k: v[0] for k, v in
                self.render_images_batch(self._param_vector[None]).items()}

    def raw_model_std(self):
        """Per-pixel posterior standard deviation of the raw model (after
        sampling or a replay), else None."""
        return self.posterior_images.get("raw_model_std")

    def raw_model(self):
        """Raw model image (before the PSF convolution)."""
        return self._current_images()["raw_model"]

    def convolved_model(self, raw_px=None):
        """PSF-convolved model image."""
        return self._current_images()["convolved_model"]

    def composite_ivm(self, raw_px=None):
        """Composite inverse-variance map (observation + model variance)."""
        return self._current_images()["composite_ivm"]

    def residual(self, convolved_px=None, raw_px=None):
        """Observation minus the convolved model."""
        return self._current_images()["residual"]

    def point_source_subtracted(self):
        """Observation minus the convolved point sources only."""
        return self._current_images()["point_source_subtracted"]

    def simulate(self, theta=None, random_state=None, add_noise=True):
        """A mock observation: the convolved model at ``theta`` (drawn from
        the priors when None) plus the observation's noise
        (:func:`replicate_noise` at the observation's sigma, 0 at bad
        pixels).  Returns ``(mock (H, W), theta)``."""
        rng = _random_state(random_state)
        if theta is None:
            theta = self.init_params_from_priors(1, random_state=rng)[0]
        theta = np.asarray(theta, np.float64)
        mock = np.asarray(self.render_images_batch(theta[None])["convolved_model"][0],
                          np.float64)
        if add_noise:
            sigma = np.sqrt(np.asarray(self.spec.obs_var, np.float64))
            sigma = np.where(np.isfinite(sigma), sigma, 0.0)
            mock = replicate_noise(rng, mock, self.spec, sigma)
        return mock, theta

    def thetas_from_database(self, database, rows=None):
        """``(N, num_params)`` parameter matrix from a trace database."""
        thetas = trace_param_matrix(database, self.param_names)
        return thetas if rows is None else thetas[rows]

    def _replicate(self, database, n, rng):
        """Posterior draws, their images and replicated datasets (stuck
        walkers dropped first, as the image writer does)."""
        from ..database import filter_lowp_walkers

        kept = filter_lowp_walkers(database, percentile=10)
        if len(kept) == 0:
            raise ValueError(
                "no trace rows left after the stuck-walker filter (every "
                "retained row at or below the 10th lnprobability percentile)")
        all_th = self.thetas_from_database(kept)
        thetas = all_th[rng.randint(0, len(all_th), size=n)]
        imgs = self.render_images_batch(thetas)
        conv = imgs["convolved_model"]
        ivm = imgs["composite_ivm"]
        sigma = np.sqrt(np.where(ivm > 0, 1.0 / np.where(ivm > 0, ivm, 1.0), 0.0))
        return thetas, conv, ivm, replicate_noise(rng, conv, self.spec, sigma)

    def posterior_predictive(self, database, n=100, random_state=None):
        """``(mocks (n, H, W), thetas (n, num_params))``: replicated data at
        ``n`` posterior draws, from each draw's own noise budget."""
        thetas, _conv, _ivm, y_rep = self._replicate(
            database, n, _random_state(random_state))
        return y_rep, thetas

    def posterior_predictive_pvalue(self, database, n=200, random_state=None):
        """Posterior-predictive p-value of the deviance statistic, ``(1 +
        #{T_rep >= T_obs}) / (n + 2)``; ~0.5 is healthy, near 0 a misfit.
        ``T = sum_good (y - conv)^2 ivm``, or under the Poisson likelihood
        the Poisson deviance of the counts."""
        _thetas, conv, ivm, y_rep = self._replicate(
            database, n, _random_state(random_state))
        good = (~np.asarray(self.spec.bad_px))[None]
        obs = np.asarray(self.spec.obs_data, np.float64)[None]
        if self.spec.likelihood == "poisson":
            g = float(self.spec.likelihood_gain)
            mu = np.maximum(conv, 0.0) * g
            t_obs = poisson_deviance(np.maximum(obs, 0.0) * g, mu, good)
            t_rep = poisson_deviance(np.maximum(y_rep, 0.0) * g, mu, good)
        else:
            t_obs = np.sum(np.where(good, (obs - conv) ** 2 * ivm, 0.0), axis=(1, 2))
            t_rep = np.sum(np.where(good, (y_rep - conv) ** 2 * ivm, 0.0), axis=(1, 2))
        return float((1 + np.sum(t_rep >= t_obs)) / (n + 2))

    # -- posterior-mean images --------------------------------------------------
    def reset_images(self):
        shape = self.spec.shape
        self.accumulated_samples = 0
        self.posterior_images = {t: np.ones(shape, dtype=np.float64)
                                 for t in IMAGE_TYPES}

    def accumulate_images(self, sample_images):
        """Running per-pixel means over a list of image dicts;
        ``composite_ivm`` is averaged as a variance (reference
        models.py:74-97)."""
        post = self.posterior_images
        post["composite_ivm"] = 1.0 / post["composite_ivm"]
        for img_dict in sample_images:
            self.accumulated_samples += 1
            n = self.accumulated_samples
            for img_type, img in img_dict.items():
                img = np.asarray(img, dtype=np.float64)
                if img_type == "composite_ivm":
                    img = 1.0 / img
                post[img_type] = post[img_type] * (n - 1) / n + img / n
        post["composite_ivm"] = 1.0 / post["composite_ivm"]

    def replay_posterior_means(self, thetas, chunk=2048):
        """Posterior-mean images of ``thetas`` ``(N, num_params)``, each
        chunk reduced to its carry means on the device
        (``ensemble_carry_means``) and merged on the host in float64 (a
        Chan merge for ``raw_m2``)."""
        fns = self.posterior_fns
        thetas = np.asarray(thetas, np.float64)
        sums, total = None, 0
        m2_run, mean_run = None, None
        for start in range(0, len(thetas), chunk):
            part = thetas[start:start + chunk]
            m = {k: v.to("cpu", torch.float64).numpy()
                 for k, v in fns.ensemble_carry_means(part).items()}
            w = len(part)
            m2_part = m.pop("raw_m2")
            if m2_run is None:
                m2_run, mean_run = m2_part, m["raw"]
            else:
                delta = m["raw"] - mean_run
                m2_run = m2_run + m2_part + delta * delta * (total * w / (total + w))
                mean_run = mean_run + delta * (w / (total + w))
            part_sums = {k: v * w for k, v in m.items()}
            sums = part_sums if sums is None else {k: sums[k] + part_sums[k]
                                                   for k in sums}
            total += w
        carry = {k: v / total for k, v in sums.items()}
        carry["raw_m2"] = m2_run
        self.posterior_images = carry_to_reference_images(
            carry, np.asarray(self.spec.obs_data))
        self._add_raw_std(carry, total)
        self.accumulated_samples = total
        return self.posterior_images

    def set_accumulated_from_sampler(self, sampler):
        """Adopt the sampler's running means (IVM averaged as variance)."""
        accum = sampler.accumulated_images
        if accum is None or sampler.accumulated_samples == 0:
            return
        carry = {k: np.asarray(v, np.float64) for k, v in accum.items()}
        self.posterior_images = carry_to_reference_images(
            carry, np.asarray(self.spec.obs_data))
        self._add_raw_std(carry, sampler.accumulated_samples)
        self.accumulated_samples = sampler.accumulated_samples

    def _add_raw_std(self, carry, count):
        """``raw_model_std = sqrt(raw_m2 / n)``, the per-pixel posterior
        standard deviation of the raw model, when it is available."""
        m2 = carry.get("raw_m2")
        if m2 is None or count < 2:
            return
        m2 = np.asarray(m2, np.float64)
        if np.all(np.isfinite(m2)):
            self.posterior_images["raw_model_std"] = np.sqrt(
                np.maximum(m2 / count, 0.0))
