"""Hierarchical (population-level) inference over a target catalog (port of ``hierarchy.py``).

The reference fits targets one at a time and histograms the point
estimates, which ignores the per-target uncertainties and cannot shrink
poorly constrained targets toward the population.  Here the whole
catalog is ONE posterior:

    ln P(theta_1..theta_K, phi | data)
        = sum_k ln L_k(theta_k)                  (one batched likelihood)
        + sum_k ln pi_base(theta_k)              (non-governed priors)
        + sum_k sum_j ln p_pop(theta_k[j] | phi) (population densities)
        + ln p(phi)                              (hyper priors)

sampled with NUTS over the ``K*d + h`` dimensional space (the ensemble
sampler is available for small K).  The samplers batch chains: a batch of
``C`` rows ``(C, K*d + h)`` is reordered target-major to ``(K*C, d)``
(row ``b`` fits target ``b // C``, the rule of
:class:`~psfmc_tpu_torch.models.posterior.ObsStack`) and each band's
:meth:`~psfmc_tpu_torch.models.posterior.PosteriorFns.log_likelihood_obs`
evaluates every target's likelihood in one call: on the card the render
kernel and conv_lnl with per-target planes (and, in survey mode,
per-target spectra), forward and backward, where the kernels cover the
spec, else the general path with autograd through ``torch.fft``.  On
CUDA every NUTS piece and every ensemble step is a graph replay.

Usage::

    from psfmc_tpu_torch.hierarchy import NormalPopulation, fit_hierarchical

    pop = {"1_Sersic_index": NormalPopulation(
        mu=Uniform(loc=0.5, scale=5.0),
        sigma=Uniform(loc=0.05, scale=3.0))}
    res = fit_hierarchical(model, obs_stack, ivm_stack, population=pop,
                           chains=4, burn=500, iterations=500)
    print(res.summary())     # hyper posterior + shrunken targets

Semantics, as in the JAX package:

* A governed parameter KEEPS its original prior's support as a hard
  truncation (the population density applies inside it): the NUTS
  bound-transforms stay exact and renderer domains are protected.
* ``parametrization='noncentered'`` samples the standardized residual
  ``eta_k`` instead of ``theta_k`` (``theta_k = reconstruct(eta_k,
  phi)``): no small-sigma funnel; the template support becomes a hard
  wall in a moving location, and the value fed to the renderer is
  clamped into it.  Results are reported in the constrained theta space.
* multiple PSFs: the discrete PSF index is marginalized per target and
  band (a logsumexp over the PSF stack); the reported chain's index
  columns are Gibbs-sampled back per retained draw.
* multi-band: a :class:`~psfmc_tpu_torch.models.JointModel` template takes
  one obs/ivm stack per band.
* survey mode: ``psf_stack=`` gives every target its own PSF star(s)
  (:func:`psfmc_tpu_torch.batchfit.prepare_psf_stack`).
* scalar governed slots only.
* ``mesh=`` (:func:`~psfmc_tpu_torch.parallel.walker_mesh`) with
  ``shard='chains'`` splits the samplers' chain (walker) axis over one
  process a device; with ``shard='targets'`` every process evaluates its
  own targets' likelihood rows against a stack of its own targets'
  observations, and every chain's per-target lnL and gradient rows are
  gathered and summed in target order (the port's form of the JAX
  package's scalar psum).  The state is held by every process
  (:mod:`psfmc_tpu_torch.parallel.mesh`).  Without a mesh ``shard`` has
  no effect, as in the JAX package.

Populations evaluate their density on tensors (``torch_logp(x, phi)``,
the JAX package's ``jax_logp``): ``x`` is ``(..., K)`` and ``phi`` the
hyperparameters, each indexable ``phi[j]`` broadcasting against ``x`` (a
tuple of ``(C, 1)`` columns in the posterior); the result sums over the
last axis.  ``reconstruct``, ``eta_logp`` and ``eta_random`` are the JAX
package's.
"""
from __future__ import annotations

import inspect
import math
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .models.posterior import value_and_grad
from .optimize import psf_fan_out
from .parallel.mesh import check_mesh, shard_rows, walker_sharding
from .parallel.multihost import barrier, is_primary

__all__ = [
    "NormalPopulation",
    "LogNormalPopulation",
    "StudentTPopulation",
    "RegressionPopulation",
    "HierarchicalResult",
    "fit_hierarchical",
    "load_hierarchical_result",
    "target_loglike",
    "loo_targets",
]

_LOG_2PI = float(np.log(2.0 * np.pi))


def _where_ok(ok, lp):
    """``lp`` where ``ok`` (reshaped to ``lp``'s shape), else ``-inf``."""
    return torch.where(ok.reshape(lp.shape), lp, torch.full_like(lp, -math.inf))


def _safe(sigma):
    return torch.where(sigma > 0, sigma, torch.ones_like(sigma))


class _LocScalePopulation:
    """Shared plumbing for two-hyperparameter (mu, sigma) populations.

    Subclasses define the centered density :meth:`torch_logp` and the
    non-centered form: :meth:`reconstruct` (theta from the standardized
    residual eta) + :meth:`eta_logp` / :meth:`eta_random` (the
    phi-independent residual density / sampler).
    """

    hyper_names = ("mu", "sigma")
    #: index into hyper_dists of the scale hyperparameter — its prior
    #: must have nonnegative support under the non-centered form (a
    #: negative sigma would make reconstruct() two-to-one).
    scale_hyper_index = 1

    def __init__(self, mu, sigma):
        for name, d in (("mu", mu), ("sigma", sigma)):
            if not hasattr(d, "torch_logp"):
                raise TypeError(
                    f"{type(self).__name__} {name}= must be a prior "
                    f"distribution, got {type(d).__name__}"
                )
        self.mu = mu
        self.sigma = sigma

    @property
    def hyper_dists(self):
        return (self.mu, self.sigma)


class NormalPopulation(_LocScalePopulation):
    """Gaussian population: governed values ~ N(mu, sigma) (truncated
    to the governed parameter's original prior support).

    ``mu`` and ``sigma`` are prior :class:`~psfmc_tpu_torch.distributions.
    Distribution` objects over the two hyperparameters; ``sigma``'s
    prior should have positive support (a guard rejects sigma <= 0
    regardless).
    """

    def torch_logp(self, x, phi):
        """Population log-density of governed values ``x`` ``(..., K)``
        given ``phi = (mu, sigma)``, summed over the last axis.  -inf when
        sigma <= 0."""
        mu, sigma = phi[0], phi[1]
        safe = _safe(sigma)
        lp = torch.sum(-0.5 * ((x - mu) / safe) ** 2 - torch.log(safe) - 0.5 * _LOG_2PI,
                       dim=-1)
        return _where_ok(sigma > 0, lp)

    # -- non-centered form: theta = mu + sigma * eta, eta ~ N(0, 1) --
    def reconstruct(self, eta, phi):
        return phi[0] + phi[1] * eta

    def eta_logp(self, eta):
        return torch.sum(-0.5 * eta**2 - 0.5 * _LOG_2PI, dim=-1)

    def eta_random(self, random_state, size):
        return random_state.standard_normal(size)


class LogNormalPopulation(_LocScalePopulation):
    """Log-normal population: ln(theta) ~ N(mu, sigma), theta > 0.

    The natural choice for positive, multiplicatively-scattered
    parameters (effective radii, fluxes).  Values <= 0 get density -inf.
    """

    def torch_logp(self, x, phi):
        mu, sigma = phi[0], phi[1]
        safe = _safe(sigma)
        xs = torch.where(x > 0, x, torch.ones_like(x))
        lx = torch.log(xs)
        lp = torch.sum(-0.5 * ((lx - mu) / safe) ** 2 - torch.log(safe) - lx
                       - 0.5 * _LOG_2PI, dim=-1)
        ok = (x > 0).all(dim=-1) & (sigma > 0).reshape(lp.shape)
        return _where_ok(ok, lp)

    # -- non-centered form: theta = exp(mu + sigma * eta) --
    def reconstruct(self, eta, phi, xp=torch):
        # xp=np gives predict_population a pure-host path (float64); the
        # posterior uses the torch default — one implementation
        return xp.exp(phi[0] + phi[1] * eta)

    def eta_logp(self, eta):
        return torch.sum(-0.5 * eta**2 - 0.5 * _LOG_2PI, dim=-1)

    def eta_random(self, random_state, size):
        return random_state.standard_normal(size)


class StudentTPopulation(_LocScalePopulation):
    """Student-t population: (theta - mu)/sigma ~ t(df), df static.

    Robust to outlier targets: a few misclassified or badly-fit objects
    drag a Gaussian population's (mu, sigma) while the t population
    downweights them.
    """

    def __init__(self, mu, sigma, df=4.0):
        super().__init__(mu, sigma)
        df = float(df)
        if not df > 0:
            raise ValueError(f"df must be positive, got {df}")
        self.df = df
        from scipy.special import gammaln

        # host-folded normalization (df is static)
        self._lognorm = float(
            gammaln((df + 1.0) / 2.0) - gammaln(df / 2.0) - 0.5 * np.log(df * np.pi)
        )

    def torch_logp(self, x, phi):
        mu, sigma = phi[0], phi[1]
        safe = _safe(sigma)
        t = (x - mu) / safe
        lp = torch.sum(self._lognorm - 0.5 * (self.df + 1.0) * torch.log1p(t * t / self.df)
                       - torch.log(safe), dim=-1)
        return _where_ok(sigma > 0, lp)

    # -- non-centered form: theta = mu + sigma * eta, eta ~ t(df) --
    def reconstruct(self, eta, phi):
        return phi[0] + phi[1] * eta

    def eta_logp(self, eta):
        return torch.sum(self._lognorm
                         - 0.5 * (self.df + 1.0) * torch.log1p(eta * eta / self.df), dim=-1)

    def eta_random(self, random_state, size):
        return random_state.standard_t(self.df, size)


class RegressionPopulation:
    """Scaling-relation population: y ~ N(alpha + beta*(x - x0), sigma).

    The hierarchical regression of one per-target parameter on another
    (size-luminosity relations, fundamental-plane style fits) through the
    full pixel likelihood: ``fit_hierarchical(model, obs, ivm,
    population={'1_Sersic_reff': RegressionPopulation(
    covariate='1_Sersic_mag', alpha=..., beta=..., sigma=..., x0=20.5)})``
    infers (alpha, beta, sigma) jointly with every target's parameters, so
    measurement error in both axes is handled exactly.

    ``covariate`` names another per-target SCALAR slot: its own template
    prior stays in force.  The covariate may itself be governed by another
    population — list it EARLIER in the ``population`` dict.  ``x0`` is a
    fixed pivot.  ``alpha``/``beta``/``sigma`` are prior distributions over
    the hyperparameters; sigma's prior needs positive support.

    Non-centered form: y = alpha + beta*(x - x0) + sigma*eta with
    eta ~ N(0,1).
    """

    hyper_names = ("alpha", "beta", "sigma")
    scale_hyper_index = 2

    def __init__(self, covariate, alpha, beta, sigma, x0=0.0):
        if not isinstance(covariate, str):
            raise TypeError(
                "covariate must name a per-target parameter slot, "
                f"got {type(covariate).__name__}"
            )
        for name, dd in (("alpha", alpha), ("beta", beta), ("sigma", sigma)):
            if not hasattr(dd, "torch_logp"):
                raise TypeError(
                    f"RegressionPopulation {name}= must be a prior "
                    f"distribution, got {type(dd).__name__}"
                )
        self.covariate = covariate
        self.alpha = alpha
        self.beta = beta
        self.sigma = sigma
        self.x0 = float(x0)

    @property
    def hyper_dists(self):
        return (self.alpha, self.beta, self.sigma)

    def torch_logp(self, y, phi, x):
        """Conditional log-density of y ``(..., K)`` given phi = (alpha,
        beta, sigma) and covariate values x ``(..., K)``.  -inf when
        sigma <= 0."""
        alpha, beta, sigma = phi[0], phi[1], phi[2]
        safe = _safe(sigma)
        r = (y - alpha - beta * (x - self.x0)) / safe
        lp = torch.sum(-0.5 * r * r - torch.log(safe) - 0.5 * _LOG_2PI, dim=-1)
        return _where_ok(sigma > 0, lp)

    # -- non-centered form ------------------------------------------------
    def reconstruct(self, eta, phi, x, xp=torch):
        return phi[0] + phi[1] * (x - self.x0) + phi[2] * eta

    def eta_logp(self, eta):
        return torch.sum(-0.5 * eta**2 - 0.5 * _LOG_2PI, dim=-1)

    def eta_random(self, random_state, size):
        return random_state.standard_normal(size)


# -- population persistence -------------------------------------------------
# predict_population after load_hierarchical_result needs the family's
# STATIC structure (class + covariate/x0/df), not its hyper priors (the
# hyper posterior rides hyper_chain).  Loaded families carry placeholder
# hyper priors and are flagged — fit_hierarchical refuses them.
_POP_FAMILIES = {}


def _register_population(cls):
    _POP_FAMILIES[cls.__name__] = cls
    return cls


for _cls in (NormalPopulation, LogNormalPopulation, StudentTPopulation,
             RegressionPopulation):
    _register_population(_cls)


def _pop_static_spec(pop):
    """(family_name, {static kwargs}) for a population family, or
    (None, reason) when the family is custom/unregistered."""
    name = type(pop).__name__
    if name not in _POP_FAMILIES:
        return None, (
            f"{name} is not a built-in population family — its spec "
            "is not persisted; pass populations= after loading"
        )
    extra = {}
    if isinstance(pop, StudentTPopulation):
        extra["df"] = float(pop.df)
    if isinstance(pop, RegressionPopulation):
        extra["covariate"] = str(pop.covariate)
        extra["x0"] = float(pop.x0)
    return name, extra


def _pop_from_spec(name, extra):
    """Predict-only family instance from a persisted spec."""
    from . import distributions as D

    cls = _POP_FAMILIES[name]
    # placeholder hyper priors: predict_population never evaluates them
    # (draws come from hyper_chain rows); sigma's placeholder has positive
    # support to satisfy constructor conventions
    loc = D.Normal(loc=0.0, scale=1.0)
    scale = D.Uniform(loc=0.0, scale=1.0)
    if cls is RegressionPopulation:
        pop = cls(
            covariate=extra["covariate"],
            alpha=loc, beta=D.Normal(loc=0.0, scale=1.0), sigma=scale,
            x0=float(extra.get("x0", 0.0)),
        )
    elif cls is StudentTPopulation:
        pop = cls(mu=loc, sigma=scale, df=float(extra.get("df", 4.0)))
    else:
        pop = cls(mu=loc, sigma=scale)
    pop._hyper_priors_placeholder = True
    return pop


def _has_xp(pop):
    """Whether ``pop.reconstruct`` takes ``xp=`` (signature inspection, not
    ``try/except TypeError``: a real TypeError inside a custom family's
    reconstruct must surface)."""
    try:
        params = inspect.signature(pop.reconstruct).parameters
    except (TypeError, ValueError):  # builtins/C callables
        return False
    return "xp" in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                                 for p in params.values())


def _host_reconstruct(pop, eta, phi, x=None):
    """``pop.reconstruct`` on host numpy, float64 (``xp=np`` where the
    family takes it)."""
    args = (eta, phi) if x is None else (eta, phi, x)
    v = pop.reconstruct(*args, xp=np) if _has_xp(pop) else pop.reconstruct(*args)
    return np.array(v, np.float64)


@dataclass
class HierarchicalResult:
    """Posterior of a hierarchical catalog fit.

    ``target_mean``/``target_std`` are per-target marginal moments of
    the SHRUNKEN posteriors; ``hyper_chain`` is the flattened hyper
    posterior sample.
    """

    param_names: List[str]  # per-target slot names (d entries)
    hyper_names: List[str]  # e.g. '1_Sersic_index:mu'
    num_targets: int
    target_mean: np.ndarray  # (K, d)
    target_std: np.ndarray  # (K, d)
    hyper_chain: np.ndarray  # (S, h)
    governed: List[str] = field(default_factory=list)
    diagnostics: Dict[str, float] = field(default_factory=dict)
    flatchain: Optional[np.ndarray] = None  # (S, K*d + h)
    #: (S,) retained-draw log-posterior — lets target_loglike drop
    #: burn-in leakage rows (robust lnp floor) before the PSIS replay
    lnp: Optional[np.ndarray] = None
    #: population family objects keyed by governed name (attached by
    #: fit_hierarchical; built-in families persist their STATIC spec
    #: through save()/load_hierarchical_result — loaded instances are
    #: predict-only, with placeholder hyper priors)
    populations: Optional[Dict[str, object]] = None
    #: (lo, hi) template-prior truncation per governed name (attached
    #: by fit_hierarchical; persisted through save()/load)
    governed_bounds: Optional[Dict[str, tuple]] = None

    @property
    def hyper_mean(self) -> np.ndarray:
        return self.hyper_chain.mean(axis=0)

    @property
    def hyper_std(self) -> np.ndarray:
        return self.hyper_chain.std(axis=0)

    def summary(self) -> str:
        lines = [
            f"hierarchical fit: {self.num_targets} targets, "
            f"population on {self.governed}"
        ]
        m, s = self.hyper_mean, self.hyper_std
        for i, name in enumerate(self.hyper_names):
            lines.append(f"  {name:<28s} {m[i]:10.4g} +/- {s[i]:.4g}")
        for k, v in self.diagnostics.items():
            lines.append(f"  {k}: {v:.4g}")
        return "\n".join(lines)

    def predict_population(self, n=4000, seed=0, populations=None,
                           bounds=None, max_tries=1000,
                           covariates=None):
        """Posterior-predictive draws of a NEW target's governed values.

        For each draw, a hyper-posterior row ``phi_s`` is picked (with
        replacement) and ``theta_new ~ p(theta | phi_s)`` is drawn from
        the population family, rejection-truncated to the governed
        template prior's support exactly like the fit's density.  This is
        the inferred POPULATION distribution with hyperparameter
        uncertainty folded in, wider than plugging in ``hyper_mean``.

        ``populations``/``bounds`` (dicts keyed by governed name)
        default to the objects :func:`fit_hierarchical` attached; after
        :func:`load_hierarchical_result` the built-in families' static
        specs are back.  Returns ``{governed_name: (n,) draws}``.

        A :class:`RegressionPopulation` is a CONDITIONAL density —
        pass ``covariates={governed_name: x}`` (scalar, or (n,) array)
        naming where on the relation to predict.
        """
        pops = populations if populations is not None else self.populations
        if pops is None:
            raise ValueError(
                "no population families on this result (loaded from "
                "disk?) — pass populations={name: family} matching the "
                "fit's population= argument"
            )
        if bounds is None:
            bounds = self.governed_bounds or {}
        rng = np.random.RandomState(seed)
        s_total = self.hyper_chain.shape[0]
        hyper_index = {nm: j for j, nm in enumerate(self.hyper_names)}
        out = {}
        for name in self.governed:
            pop = pops.get(name)
            if pop is None:
                raise ValueError(f"populations is missing {name!r}")
            if not (hasattr(pop, "reconstruct")
                    and hasattr(pop, "eta_random")):
                raise TypeError(
                    f"{type(pop).__name__} defines no sampler "
                    "(reconstruct/eta_random) — cannot draw "
                    "predictive values"
                )
            cols = [hyper_index[f"{name}:{h}"] for h in pop.hyper_names]
            rows = rng.randint(0, s_total, size=n)
            phi = tuple(
                np.asarray(self.hyper_chain[rows, c], np.float64)
                for c in cols
            )
            lo, hi = bounds.get(name, (-np.inf, np.inf))
            xv = None
            if getattr(pop, "covariate", None) is not None:
                if covariates is None or name not in covariates:
                    raise ValueError(
                        f"{type(pop).__name__} on {name!r} is a "
                        "conditional density — pass covariates="
                        f"{{{name!r}: x}} (the {pop.covariate!r} "
                        "value(s) to predict at)"
                    )
                xv = np.broadcast_to(
                    np.asarray(covariates[name], np.float64), (n,)
                )

            def _draw(m, phi_m, x_m):
                return _host_reconstruct(pop, pop.eta_random(rng, m), phi_m, x_m)

            x = _draw(n, phi, xv)
            bad = ~((x > lo) & (x < hi) & np.isfinite(x))
            tries = 0
            while bad.any():
                tries += 1
                if tries > max_tries:
                    raise RuntimeError(
                        f"predict_population: {int(bad.sum())}/{n} "
                        f"draws of {name!r} still outside "
                        f"({lo}, {hi}) after {max_tries} rejection "
                        "rounds — the population mass barely "
                        "overlaps the template support"
                    )
                x[bad] = _draw(
                    int(bad.sum()),
                    tuple(p[bad] for p in phi),
                    None if xv is None else xv[bad],
                )
                bad = ~((x > lo) & (x < hi) & np.isfinite(x))
            out[name] = x
        return out

    def save(self, db_name, meta=None):
        """Write the hierarchical trace as a FITS database.

        One TRACE bintable (the regular trace database's extension name):
        per-target columns ``T{t}_<slot>`` in layout order, then the hyper
        columns under their ``<param>:<hyper>`` names.  Governed names ride
        one ``GOVERN{i}`` card each.  The JAX package reads the file, and
        this package reads the JAX package's.  In a multi-process run the
        primary process writes it, and every process waits for it.
        """
        from .database import annotate_metadata
        from .io.table import Table

        if self.flatchain is None:
            raise ValueError(
                "no flatchain on this result — nothing to save"
            )
        k, d = self.num_targets, len(self.param_names)
        cols = OrderedDict()
        for t in range(k):
            for j, nm in enumerate(self.param_names):
                cols[f"T{t}_{nm}"] = self.flatchain[:, t * d + j]
        for j, nm in enumerate(self.hyper_names):
            cols[nm] = self.flatchain[:, k * d + j]
        if self.lnp is not None:
            # same column name as the regular trace database; load
            # special-cases it so it never reads as a hyper column
            cols["lnprobability"] = np.asarray(self.lnp, np.float64)
        m = OrderedDict(meta or {})
        m["MCHIER"] = (1, "hierarchical population fit")
        m["NTARGETS"] = (k, "targets in the joint posterior")
        for i, g in enumerate(self.governed):
            m[f"GOVERN{i}"] = (g, "population-governed parameter")
            pop = (self.populations or {}).get(g)
            if pop is not None:
                fam, extra = _pop_static_spec(pop)
                if fam is None:
                    warnings.warn(extra)
                else:
                    m[f"POPFAM{i}"] = (fam, "population family")
                    if "df" in extra:
                        m[f"POPDF{i}"] = (extra["df"], "population df")
                    if "covariate" in extra:
                        m[f"POPCOV{i}"] = (
                            extra["covariate"], "regression covariate"
                        )
                    if "x0" in extra:
                        m[f"POPX0{i}"] = (extra["x0"], "regression pivot")
            lo, hi = (self.governed_bounds or {}).get(
                g, (-np.inf, np.inf)
            )
            # non-finite bounds are simply absent (FITS float cards)
            if np.isfinite(lo):
                m[f"GBLO{i}"] = (float(lo), "governed support lo")
            if np.isfinite(hi):
                m[f"GBHI{i}"] = (float(hi), "governed support hi")
        if "divergences" in self.diagnostics:
            m["MCNDIV"] = (
                float(self.diagnostics["divergences"]),
                "divergent NUTS trajectories",
            )
        if "mean_accept" in self.diagnostics:
            m["MCACCEPT"] = (
                float(self.diagnostics["mean_accept"]),
                "mean acceptance",
            )
        tbl = Table(cols, meta=annotate_metadata(m))
        if is_primary():
            tbl.write(db_name, format="fits", extname="TRACE")
        barrier("save_hierarchical")  # the file exists before any process returns
        return tbl


def load_hierarchical_result(db_name):
    """Rebuild a :class:`HierarchicalResult` from ``save()`` output (this
    package's or the JAX package's)."""
    import re

    from .io.table import Table

    tbl = Table.read(db_name, extname="TRACE")
    meta = tbl.meta
    if not meta.get("MCHIER"):
        raise ValueError(
            f"{db_name!r} is not a hierarchical trace database"
        )
    k = int(meta["NTARGETS"])
    governed = []
    for i in range(len(meta)):
        key = f"GOVERN{i}"
        if key not in meta:
            break
        governed.append(meta[key])
    names, hyper_names = [], []
    per_cols, hyper_cols = [], []
    pat = re.compile(r"^T(\d+)_(.+)$")
    for cname in tbl.colnames:
        mm = pat.match(cname)
        if mm:
            if int(mm.group(1)) == 0:
                names.append(mm.group(2))
            per_cols.append(cname)
        elif cname != "lnprobability":
            hyper_names.append(cname)
            hyper_cols.append(cname)
    d = len(names)
    n = len(tbl[per_cols[0]])
    flat = np.empty((n, k * d + len(hyper_cols)), np.float64)
    for t in range(k):
        for j, nm in enumerate(names):
            flat[:, t * d + j] = np.asarray(tbl[f"T{t}_{nm}"])
    for j, cname in enumerate(hyper_cols):
        flat[:, k * d + j] = np.asarray(tbl[cname])
    per = flat[:, : k * d].reshape(n, k, d)
    diags = {}
    if "MCNDIV" in meta:
        diags["divergences"] = float(meta["MCNDIV"])
    if "MCACCEPT" in meta:
        diags["mean_accept"] = float(meta["MCACCEPT"])
    lnp = None
    if "lnprobability" in tbl.colnames:
        lnp = np.asarray(tbl["lnprobability"], np.float64)
    pops, bounds = {}, {}
    for i, g in enumerate(governed):
        fam = meta.get(f"POPFAM{i}")
        if fam:
            extra = {}
            if f"POPDF{i}" in meta:
                extra["df"] = float(meta[f"POPDF{i}"])
            if f"POPCOV{i}" in meta:
                extra["covariate"] = str(meta[f"POPCOV{i}"])
            if f"POPX0{i}" in meta:
                extra["x0"] = float(meta[f"POPX0{i}"])
            pops[g] = _pop_from_spec(fam, extra)
        lo = float(meta.get(f"GBLO{i}", -np.inf))
        hi = float(meta.get(f"GBHI{i}", np.inf))
        bounds[g] = (lo, hi)
    return HierarchicalResult(
        param_names=names,
        hyper_names=hyper_names,
        num_targets=k,
        target_mean=per.mean(axis=0),
        target_std=per.std(axis=0),
        hyper_chain=flat[:, k * d:],
        governed=governed,
        diagnostics=diags,
        flatchain=flat,
        lnp=lnp,
        populations=pops or None,
        governed_bounds=bounds or None,
    )


def _as_model(model, device=None):
    from .models.multicomponent import as_model

    return as_model(model, device=None if device is None else resolve_device(device))


def _target_major(per, dtype, device):
    """``(n, K, d)`` host draws -> ``(K*n, d)`` rows, target-major (row
    ``b`` belongs to target ``b // n``), on ``device``."""
    n, k, d = per.shape
    rows = np.ascontiguousarray(np.swapaxes(per, 0, 1).reshape(k * n, d))
    return torch.as_tensor(rows, dtype=dtype, device=device)


def target_loglike(model, obs_stack, ivm_stack, result,
                   max_samples=1000, chunk=256, seed=0,
                   psf_stack=None, psfivm_stack=None, psf_oversample=1,
                   device=None):
    """(S, K) per-target log-likelihood replay at the retained draws.

    The data term of target k at each retained draw's theta_k — bands
    summed, discrete PSF indices marginalized INCLUDING the uniform
    1/num_psfs mixture weight (so rows are proper per-target
    log-densities).  The pointwise unit here is a TARGET, not a pixel —
    feed the matrix to :func:`psfmc_tpu_torch.analysis.psis_loo` /
    ``waic(loglike=..., unit='targets')`` via :func:`loo_targets`.

    Rows below the robust lnp floor (burn-in leakage; see
    :func:`psfmc_tpu_torch.analysis.model_comparison.robust_lnp_keep`)
    are dropped first when the result carries ``lnp``.  The replay runs
    ``chunk`` draws (``chunk * K`` rows) a call on the posterior's device.
    """
    from .analysis.model_comparison import robust_lnp_keep

    model = _as_model(model, device)
    fns = model.posterior_fns
    spec = model.spec
    d = spec.num_params
    bands, k = _build_bands(
        fns, spec, obs_stack, ivm_stack,
        psf_stack=psf_stack, psfivm_stack=psfivm_stack,
        psf_oversample=psf_oversample,
    )
    if isinstance(result, HierarchicalResult):
        flat = result.flatchain
        if flat is None:
            raise ValueError(
                "result has no flatchain — nothing to replay"
            )
        if result.lnp is not None and len(result.lnp) == len(flat):
            keep = robust_lnp_keep(result.lnp)
            if not keep.all():
                flat = flat[keep]
    else:
        flat = np.asarray(result, np.float64)
        if flat.ndim != 2:
            raise ValueError(
                "result must be a HierarchicalResult or an "
                "(S, K*d [+ h]) draw matrix"
            )
    if flat.shape[1] < k * d:
        raise ValueError(
            f"flatchain has {flat.shape[1]} columns — expected at "
            f"least K*d = {k * d} for {k} targets x {d} params"
        )
    per = np.asarray(flat[:, : k * d], np.float64).reshape(-1, k, d)
    n = per.shape[0]
    if n > max_samples:
        rows = np.random.RandomState(seed).choice(
            n, max_samples, replace=False
        )
        per = per[np.sort(rows)]
        n = per.shape[0]

    lnl_one = _make_lnl_one(bands)
    out = np.zeros((n, k), np.float64)
    with torch.no_grad():
        for lo in range(0, n, chunk):
            block = per[lo: lo + chunk]
            m = block.shape[0]
            lnl = lnl_one(_target_major(block, fns.dtype, fns.device)).reshape(k, m)
            out[lo: lo + m] = lnl.T.to("cpu", torch.float64).numpy()
    # proper mixture density: fold the uniform index weights the
    # posterior convention leaves to base_prior
    out += sum(
        -np.log(b["psf"][1]) for b in bands if b["psf"] is not None
    )
    return out


def loo_targets(model, obs_stack, ivm_stack, result, **kw):
    """Leave-one-TARGET-out PSIS-LOO of a hierarchical fit.

    Grouped cross-validation for comparing POPULATION models (e.g.
    :class:`NormalPopulation` vs :class:`StudentTPopulation` on the same
    catalog): the importance ratio for dropping target k is 1/p(y_k |
    theta_k) (Vehtari's leave-one-group-out construction).  Compare two
    fits with :func:`psfmc_tpu_torch.analysis.model_comparison.compare`.

    Targets whose own data dominate their posterior (the no-pooling
    regime) get heavy-tailed weights, and the per-target Pareto ``k``
    flags them; every non-governed per-target parameter is data-dominated
    by construction, so such flags are common.  The paired comparison of
    two population families is much more stable than absolute elpd
    values.  Keywords are :func:`target_loglike`'s.
    """
    from .analysis.model_comparison import psis_loo

    ll = target_loglike(model, obs_stack, ivm_stack, result, **kw)
    res = psis_loo(
        loglike=ll,
        unit="targets",
        advice=(
            "those targets are in the no-pooling regime (their own "
            "data dominate their posterior, so dropping them shifts "
            "theta_k too far for importance sampling) — their grouped "
            "LOO terms, and any elpd comparison leaning on them, are "
            "not trustworthy"
        ),
    )
    res.kind = "loo-target"
    return res


class _HierarchicalFns:
    """The posterior bundle the samplers consume, batched over chains.

    :meth:`log_posterior_batch` and :meth:`differentiable_log_posterior`
    take ``(C, K*d + h)`` rows and return the joint catalog lnpost ``(C,)``
    (the same function: the bands' likelihoods differentiate through the
    kernels' backward kernels where they cover the spec, through autograd
    elsewhere).  No image accumulation (``ensemble_carry_means`` is None:
    the per-target posterior-mean images of a catalog fit are a replay
    product, not a streaming one).
    """

    ensemble_carry_means = None

    def __init__(self, bands, d, k, governed_cols, bounds,
                 populations, hyper_offsets, hyper_prior, base_prior,
                 noncentered=False, cov_cols=None, target_mesh=None, local_bands=None):
        if cov_cols is None:
            cov_cols = [None] * len(populations)
        self._bands = bands  # [{"fns", "obs": ObsStack, "psf": (col, npsf) | None}]
        self.dtype = bands[0]["fns"].dtype
        self.device = bands[0]["fns"].device
        h = int(sum(len(p.hyper_dists) for p in populations))
        self.k, self.d, self.h = int(k), int(d), h
        self.spec = SimpleNamespace(num_params=self.k * self.d + h, num_psfs=1)
        self._governed = list(zip(governed_cols, bounds, populations, hyper_offsets,
                                  cov_cols))
        self._hyper_prior = hyper_prior
        self._base_prior = base_prior
        self.noncentered = bool(noncentered)
        # shard='targets': the mesh the likelihood gathers over (the samplers
        # graph their steps where its steps are graphed)
        self.mesh = target_mesh
        self._lnl_one = (_make_lnl_one(bands) if target_mesh is None else
                         _target_sharded(_make_lnl_one(local_bands), target_mesh, self.k))
        # discrete PSF-index columns being marginalized (reporting Gibbs
        # pass + init pinning read this)
        self.psf_margs = [b["psf"] for b in bands if b["psf"]]

    def _population(self, big):
        """``(lp, thetas, phi)`` of ``(C, K*d + h)`` rows: the population
        terms with the truncation guards ``(C,)``, the per-target thetas
        ``(C, K, d)`` the likelihood reads (reconstructed and clamped under
        the non-centered form) and the hyperparameters ``(C, h)``."""
        k, d = self.k, self.d
        c = big.shape[0]
        sampled = big[:, : k * d].reshape(c, k, d)
        phi = big[:, k * d:]
        neg_inf = big.new_full((c,), -math.inf)

        thetas = sampled
        lp = big.new_zeros(c)
        for col, (a, b), pop, off, xcol in self._governed:
            nh = len(pop.hyper_dists)
            phi_p = tuple(phi[:, off + j: off + j + 1] for j in range(nh))
            # regression covariate: read from THETAS, not sampled — a
            # governed covariate processed earlier (dict order is
            # validated) has already been reconstructed/clamped there
            xtra = () if xcol is None else (thetas[:, :, xcol],)
            if self.noncentered:
                # the sampled value is the standardized residual eta; its
                # density is phi-independent and theta is reconstructed
                eta = sampled[:, :, col]
                x = pop.reconstruct(eta, phi_p, *xtra).to(self.dtype)
                lp = lp + pop.eta_logp(eta)
            else:
                x = sampled[:, :, col]
                lp = lp + pop.torch_logp(x, phi_p, *xtra)
            # truncation to the original prior support (the centered NUTS
            # transform already enforces it; this guards the ensemble path
            # and the non-centered moving wall)
            if np.isfinite(a):
                lp = torch.where((x < a).any(dim=-1), neg_inf, lp)
            if np.isfinite(b):
                lp = torch.where((x > b).any(dim=-1), neg_inf, lp)
            if self.noncentered:
                # clamp the value fed to the renderer into the template
                # support: the guard above voids the density outside, and an
                # unclamped excursion would render NaN whose gradient the
                # render's backward passes on
                if np.isfinite(a):
                    x = torch.clamp_min(x, float(a))
                if np.isfinite(b):
                    x = torch.clamp_max(x, float(b))
                thetas = torch.cat([thetas[:, :, :col], x[:, :, None],
                                    thetas[:, :, col + 1:]], dim=2)
        return lp, thetas, phi

    def likelihood_rows(self, big):
        """The target-major ``(K*C, d)`` rows the bands' likelihoods take for
        ``(C, K*d + h)`` rows (row ``b`` fits target ``b // C``)."""
        big = torch.as_tensor(big, dtype=self.dtype, device=self.device)
        thetas = self._population(big)[1]
        return thetas.transpose(0, 1).reshape(-1, self.d)

    def log_posterior_batch(self, big):
        """Joint lnpost of ``(C, K*d + h)`` rows; NaN -> ``-inf``."""
        big = torch.as_tensor(big, dtype=self.dtype, device=self.device)
        k, c = self.k, big.shape[0]
        lp, thetas, phi = self._population(big)
        rows = thetas.transpose(0, 1).reshape(k * c, self.d)  # target-major
        lnl = self._lnl_one(rows).reshape(k, c).sum(dim=0)
        lp = lp + self._base_prior(rows).reshape(k, c).sum(dim=0)
        lp = lp + self._hyper_prior(phi)
        neg_inf = torch.full_like(lp, -math.inf)
        out = torch.where(torch.isfinite(lp), lnl + lp, neg_inf)
        return torch.where(torch.isnan(out), neg_inf, out)

    differentiable_log_posterior = log_posterior_batch

    def gibbs_psf_indices(self, per, seed, chunk=256):
        """Per-draw, per-target PSF indices for the reported chain.

        Sampling marginalizes the discrete indices out of the posterior
        (the index columns ride inert at 0); reporting Gibbs-samples them
        back per retained draw from the exact conditional p(j | theta_k,
        y_k) ∝ exp(lnl_kj), a Gumbel-max draw from
        ``np.random.RandomState(seed)`` in the JAX package's order (band,
        chunk of draws, then ``(draw, target, index)``).

        :param per: (n, k, d) constrained per-target thetas.
        :returns: dict ``{theta_column: (n, k) float indices}``.
        """
        rng = np.random.RandomState(seed)
        n, k = per.shape[:2]
        result = {}
        for band in self._bands:
            if band["psf"] is None:
                continue
            col, npsf = band["psf"]
            f, obs = band["fns"], band["obs"]
            out = np.zeros((n, k), np.float64)
            for lo in range(0, n, chunk):
                block = per[lo: lo + chunk]
                m = block.shape[0]
                rows = psf_fan_out(_target_major(block, self.dtype, self.device), col, npsf)
                with torch.no_grad():
                    lnls = f.log_likelihood_obs(rows, obs)
                lnls = lnls.reshape(k, m, npsf).transpose(0, 1).to("cpu", torch.float64)
                g = rng.gumbel(size=lnls.shape)
                out[lo: lo + m] = np.argmax(lnls.numpy() + g, axis=-1)
            result[col] = out
        return result


class _GatheredRows(torch.autograd.Function):
    """``value`` as a function of ``rows`` whose per-row gradient is
    ``grad`` (each row's value depends on that row alone)."""

    @staticmethod
    def forward(ctx, rows, value, grad):
        ctx.save_for_backward(grad)
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None] * grad, None, None


def _target_sharded(lnl_local, mesh, k):
    """The per-target data term over ``mesh`` (``shard='targets'``): this
    process's targets' rows of a target-major batch evaluated by
    ``lnl_local`` (its own targets' stacks), every row's value (and,
    where the rows carry a gradient, every row's gradient) gathered in
    target order."""
    sharding = walker_sharding(mesh)
    lnl = shard_rows(lnl_local, sharding, blocks=k)
    lnl_and_grad = shard_rows(lambda r: value_and_grad(lnl_local, r), sharding, blocks=k)

    def lnl_one(rows):
        if not (rows.requires_grad and torch.is_grad_enabled()):
            return lnl(rows)
        return _GatheredRows.apply(rows, *lnl_and_grad(rows.detach()))

    return lnl_one


def _make_lnl_one(bands):
    """The per-target data term of a target-major batch of rows ``(K*n,
    d)`` (row ``b`` against target ``b // n``): the sum of the band
    likelihoods, each band's PSF index marginalized per target and band by
    a fan-out over the PSFs and a logsumexp (the port's NUTS marginal).
    The uniform 1/num_psfs mixture weight is NOT added here: the base
    prior evaluates the DiscreteUniform density at the inert index column
    (placeholder 0), contributing exactly -ln(num_psfs)."""
    def lnl_one(rows):
        tot = rows.new_zeros(rows.shape[0])
        for band in bands:
            f, obs = band["fns"], band["obs"]
            if band["psf"] is None:
                tot = tot + f.log_likelihood_obs(rows, obs)
                continue
            col, npsf = band["psf"]
            lps = f.log_likelihood_obs(psf_fan_out(rows, col, npsf), obs)
            tot = tot + torch.logsumexp(lps.reshape(rows.shape[0], npsf), dim=1)
        return tot

    return lnl_one


def _build_bands(fns, spec, obs_stack, ivm_stack, psf_stack=None,
                 psfivm_stack=None, psf_oversample=1):
    """Band descriptors (each band's posterior, its observations as an
    :class:`~psfmc_tpu_torch.models.posterior.ObsStack` on its device, its
    PSF marginalization) and K.

    Single-band models take plain (K, H, W) stacks; joint models take a
    LIST of one stack per band.  ``psf_stack``/``psfivm_stack`` add
    survey-mode per-target PSFs (:func:`psfmc_tpu_torch.batchfit.
    prepare_psf_stack`; for a joint model a list with one entry per band,
    ``None`` keeping that band's template PSF).  Shared by
    :func:`fit_hierarchical` and the :func:`target_loglike` replay.
    """
    from .batchfit import prepare_obs_stack, prepare_psf_stack

    if (psf_stack is None) != (psfivm_stack is None):
        raise ValueError(
            "psf_stack and psfivm_stack must be given together"
        )
    np_dtype = np.float32 if fns.dtype == torch.float32 else np.float64
    band_specs = getattr(spec, "band_specs", None)
    if band_specs is None:
        band_specs = [spec]
        band_fns_list = [fns]
        obs_stacks, ivm_stacks = [obs_stack], [ivm_stack]
        psf_stacks = [psf_stack]
        psfivm_stacks = [psfivm_stack]
    else:
        band_fns_list = list(fns.band_fns)
        if len(obs_stack) != len(band_specs) or len(ivm_stack) != len(
            band_specs
        ):
            raise ValueError(
                f"joint fit_hierarchical needs one obs/ivm stack per "
                f"band ({len(band_specs)}), got {len(obs_stack)}/"
                f"{len(ivm_stack)}"
            )
        if psf_stack is not None and (
            len(psf_stack) != len(band_specs)
            or len(psfivm_stack) != len(band_specs)
        ):
            raise ValueError(
                f"joint psf_stack needs one entry per band "
                f"({len(band_specs)}; None keeps that band's template "
                f"PSF), got {len(psf_stack)}/{len(psfivm_stack)}"
            )
        obs_stacks, ivm_stacks = list(obs_stack), list(ivm_stack)
        psf_stacks = (
            list(psf_stack) if psf_stack is not None
            else [None] * len(band_specs)
        )
        psfivm_stacks = (
            list(psfivm_stack) if psfivm_stack is not None
            else [None] * len(band_specs)
        )
    bands = []
    k = None
    for bs, bf, ob_s, iv_s, ps_s, pi_s in zip(
        band_specs, band_fns_list, obs_stacks, ivm_stacks,
        psf_stacks, psfivm_stacks,
    ):
        ob = prepare_obs_stack(bs, ob_s, iv_s, np_dtype)
        k_b = ob["obs_data"].shape[0]
        if k is None:
            k = k_b
        elif k_b != k:
            raise ValueError(
                f"bands disagree on target count: {k_b} vs {k}"
            )
        if ps_s is not None:
            if pi_s is None:
                raise ValueError(
                    "a band's psf_stack entry needs a matching "
                    "psfivm_stack entry"
                )
            psf = prepare_psf_stack(bs, ps_s, pi_s, psf_oversample, np_dtype)
            if psf["psf_f_re"].shape[0] != k_b:
                raise ValueError(
                    f"psf_stack target count {psf['psf_f_re'].shape[0]} "
                    f"!= obs target count {k_b}"
                )
            ob.update(psf)
        bands.append({"fns": bf, "obs": bf.prepare_obs(ob), "psf": _psf_marg_for(bs)})
    return bands, k


def _psf_marg_for(band_spec):
    """(theta_column, num_psfs) when the band's PSF index is sampled,
    else None (single PSF, or index held constant)."""
    npsf = int(getattr(band_spec, "num_psfs", 1))
    if npsf == 1:
        return None
    cs = next(
        (c for c in band_spec.comp_specs if c.kind == "psfselector"),
        None,
    )
    if cs is None:
        return None
    kind, payload = cs.params["psf_index"]
    if kind != "theta":
        return None
    return (int(payload[0]), npsf)


def _hyper_slots(names, dists):
    """ParamSlot list for the hyper block (transform and prior building)."""
    from .models.spec import ParamSlot

    slots = []
    for off, (name, dist) in enumerate(zip(names, dists)):
        slots.append(
            ParamSlot(
                comp_index=-1,
                attr=name,
                offset=off,
                size=1,
                name=name,
                fitsname=name[:8],
                dist=dist,
            )
        )
    return slots


class _HierTransform:
    """K copies of the per-target bijection + the hyper bijection.

    z layout mirrors theta: ``[K x base_z, hyper_z]``; :meth:`to_constrained`
    takes ``(C, m)`` rows (or one ``(m,)`` row).
    """

    def __init__(self, base, hyper, k, d):
        self.base = base
        self.hyper = hyper
        self.k = int(k)
        self.d = int(d)
        self.num_unconstrained = (
            self.k * base.num_unconstrained + hyper.num_unconstrained
        )
        self.discrete_offsets = np.asarray([], np.int32)

    def cache_token(self):
        return ("hier", self.k, self.base.cache_token(),
                self.hyper.cache_token())

    def to_constrained(self, z):
        squeeze = z.ndim == 1
        z = torch.atleast_2d(z)
        c = z.shape[0]
        bz = self.base.num_unconstrained
        zt = z[:, : self.k * bz].reshape(c * self.k, bz)
        th, ld = self.base.to_constrained(zt)
        ph, ldh = self.hyper.to_constrained(z[:, self.k * bz:])
        theta = torch.cat([th.reshape(c, self.k * self.d), ph], dim=1)
        logdet = ld.reshape(c, self.k).sum(dim=1) + ldh
        return (theta[0], logdet[0]) if squeeze else (theta, logdet)

    def to_unconstrained(self, theta):
        theta = np.asarray(theta, np.float64)
        squeeze = theta.ndim == 1
        theta = np.atleast_2d(theta)
        n = theta.shape[0]
        per = theta[:, : self.k * self.d].reshape(n * self.k, self.d)
        zt = self.base.to_unconstrained(per).reshape(n, -1)
        zh = self.hyper.to_unconstrained(theta[:, self.k * self.d:])
        z = np.concatenate([zt, np.atleast_2d(zh)], axis=1)
        return z[0] if squeeze else z


class _UnboundedStandin:
    """Stand-in dist whose support is all of R — makes the
    UnconstrainingTransform treat a governed slot as identity (the
    non-centered residual eta is unbounded)."""

    is_discrete = False

    class _RV:
        @staticmethod
        def support():
            return (-np.inf, np.inf)

    rv_frozen = _RV()


def _noncentered_transform(fns, spec, governed_cols):
    """Per-target bijection with governed slots identity-mapped.

    Built from a slot copy whose governed dists report unbounded support.
    Axis-pair members (reff/reff_b etc.) cannot be governed non-centered:
    their dependent-bound bijection would read the RAW residual as the
    bound value.
    """
    from .models.transforms import UnconstrainingTransform

    gov = set(int(c) for c in governed_cols)
    slots = [
        replace(s, dist=_UnboundedStandin()) if int(s.offset) in gov else s
        for s in spec.slots
    ]
    mod = SimpleNamespace(
        slots=slots,
        comp_specs=spec.comp_specs,
        num_params=spec.num_params,
    )
    tr = UnconstrainingTransform(mod, dtype=fns.dtype)
    for zb, za, _kb in tr.reffb_pairs:
        if int(tr.offsets[zb]) in gov or int(tr.offsets[za]) in gov:
            raise ValueError(
                "parametrization='noncentered' cannot govern an "
                "axis-pair parameter (reff/reff_b, fwhm/fwhm_b, "
                "...): the dependent minor-axis bound needs the "
                "constrained value — use parametrization="
                "'centered'"
            )
    return tr


@dataclass
class _Setup:
    """A validated hierarchical fit before sampling: the model, its
    bands, the posterior bundle and what the start and the transform need."""

    model: object
    hier: _HierarchicalFns
    k: int
    d: int
    governed_cols: list
    bounds: list
    populations: list
    hyper_offsets: list
    cov_cols: list
    hyper_names: list
    hyper_dists: list
    noncentered: bool

    def draw(self, n, rng):
        """``(n, K*d + h)`` start rows: per-target prior draws (the PSF
        index columns pinned at 0, eta draws in the governed columns under
        the non-centered form) + hyper prior draws, from ``rng`` in the
        JAX package's order."""
        k, d = self.k, self.d
        per = self.model.init_params_from_priors(
            n * k, random_state=rng
        ).reshape(n, k, d)
        for col, _npsf in self.hier.psf_margs:
            # the index is marginalized: pin its columns at 0 so the
            # inert coordinates stay valid under base_prior
            per[:, :, col] = 0.0
        if self.noncentered:
            for col, pop in zip(self.governed_cols, self.populations):
                per[:, :, col] = pop.eta_random(rng, (n, k))
        hyp = np.column_stack(
            [
                np.ravel(hd.random(random_state=rng, size=n))
                for hd in self.hyper_dists
            ]
        )
        return np.concatenate([per.reshape(n, k * d), hyp], axis=1)

    def transform(self):
        """NUTS's :class:`_HierTransform`: the per-target bijection (the
        governed slots identity-mapped under the non-centered form) and
        the hyper bijection."""
        from .models.transforms import UnconstrainingTransform, build_transform

        fns, spec = self.model.posterior_fns, self.model.spec
        hyper_spec = SimpleNamespace(
            slots=_hyper_slots(self.hyper_names, self.hyper_dists),
            comp_specs=[],
            num_params=len(self.hyper_dists),
        )
        base_tr = (
            _noncentered_transform(fns, spec, self.governed_cols)
            if self.noncentered
            else build_transform(spec, dtype=fns.dtype)
        )
        return _HierTransform(
            base_tr, UnconstrainingTransform(hyper_spec, dtype=fns.dtype), self.k, self.d)


def _setup(model, obs_stack, ivm_stack, population, mesh=None, shard="chains",
           parametrization="centered", psf_stack=None, psfivm_stack=None,
           psf_oversample=1, device=None):
    """:func:`fit_hierarchical`'s validation and posterior bundle, before
    any sampling (the JAX package's checks, in its order, with its
    exception types and messages)."""
    from .models.posterior import LogPrior

    model = _as_model(model, device)
    fns = model.posterior_fns
    spec = model.spec
    d = spec.num_params
    bands, k = _build_bands(
        fns, spec, obs_stack, ivm_stack,
        psf_stack=psf_stack, psfivm_stack=psfivm_stack,
        psf_oversample=psf_oversample,
    )

    if not population:
        raise ValueError("population must name at least one parameter")
    if parametrization not in ("centered", "noncentered"):
        raise ValueError(
            f"unknown parametrization {parametrization!r}: expected "
            "'centered' or 'noncentered'"
        )
    noncentered = parametrization == "noncentered"
    slot_by_name = {s.name: s for s in spec.slots}
    governed_cols, bounds, populations, cov_cols = [], [], [], []
    hyper_names, hyper_dists, hyper_offsets = [], [], []
    for name, pop in population.items():
        if getattr(pop, "_hyper_priors_placeholder", False):
            raise ValueError(
                f"population on {name!r}: this family was loaded from "
                "a saved result — its hyper priors are placeholders "
                "(predict-only).  Construct a fresh family with real "
                "hyper priors to fit."
            )
        slot = slot_by_name.get(name)
        if slot is None:
            raise ValueError(
                f"unknown parameter {name!r}: expected one of "
                f"{sorted(slot_by_name)}"
            )
        if slot.size != 1:
            raise ValueError(
                f"population on {name!r}: vector slots (xy) are not "
                "supported — govern scalar parameters"
            )
        if slot.dist.is_discrete:
            raise ValueError(
                f"population on {name!r}: the discrete PSF index is "
                "marginalized, not governed"
            )
        governed_cols.append(int(slot.offset))
        a, b = slot.dist.rv_frozen.support()
        bounds.append((float(a), float(b)))
        populations.append(pop)
        xname = getattr(pop, "covariate", None)
        if xname is None:
            cov_cols.append(None)
        else:
            xslot = slot_by_name.get(xname)
            if xslot is None:
                raise ValueError(
                    f"population on {name!r}: unknown covariate "
                    f"{xname!r} — expected one of {sorted(slot_by_name)}"
                )
            if xslot.size != 1 or xslot.dist.is_discrete:
                raise ValueError(
                    f"population on {name!r}: covariate {xname!r} must "
                    "be a continuous scalar slot"
                )
            if xname == name:
                raise ValueError(
                    f"population on {name!r}: a parameter cannot be "
                    "its own covariate"
                )
            keys = list(population)
            if xname in population and (
                keys.index(xname) >= keys.index(name)
            ):
                raise ValueError(
                    f"population on {name!r}: its covariate {xname!r} "
                    "is governed too — list the covariate's population "
                    "FIRST (its constrained value feeds the regression "
                    "density)"
                )
            cov_cols.append(int(xslot.offset))
        hyper_offsets.append(len(hyper_dists))
        for hname, hdist in zip(pop.hyper_names, pop.hyper_dists):
            hyper_names.append(f"{name}:{hname}")
            hyper_dists.append(hdist)
        if noncentered:
            if not hasattr(pop, "reconstruct"):
                raise ValueError(
                    f"{type(pop).__name__} defines no non-centered "
                    "form (reconstruct/eta_logp) — use "
                    "parametrization='centered'"
                )
            si = getattr(pop, "scale_hyper_index", None)
            if si is not None:
                lo_s = float(
                    pop.hyper_dists[si].rv_frozen.support()[0]
                )
                if lo_s < 0:
                    raise ValueError(
                        f"population on {name!r}: the scale "
                        "hyperparameter's prior must have nonnegative "
                        "support under parametrization='noncentered' "
                        "(a negative sigma makes theta = "
                        "reconstruct(eta, phi) two-to-one)"
                    )

    dev, dtype = fns.device, fns.dtype
    base_prior = LogPrior(
        [s for s in spec.slots if int(s.offset) not in governed_cols],
        spec.comp_specs, dev, dtype,
    )
    if shard not in ("chains", "targets"):
        raise ValueError(
            f"unknown shard {shard!r}: expected 'chains' or 'targets'"
        )
    target_mesh = local_bands = None
    if mesh is not None and shard == "targets":
        if k < mesh.size:
            raise ValueError(f"shard='targets' needs at least one target a process: "
                             f"{k} targets over {mesh.size}")
        target_mesh = mesh
        lo, hi = mesh.rows(k)
        joint = hasattr(spec, "band_specs")

        def mine(stack):
            if stack is None:
                return None
            if joint:
                return [None if b is None else list(b)[lo:hi] for b in stack]
            return list(stack)[lo:hi]

        local_bands, _ = _build_bands(
            fns, spec, mine(obs_stack), mine(ivm_stack), psf_stack=mine(psf_stack),
            psfivm_stack=mine(psfivm_stack), psf_oversample=psf_oversample)
    hyper_prior = LogPrior(_hyper_slots(hyper_names, hyper_dists), [],
                           dev, dtype)
    hier = _HierarchicalFns(
        bands, d, k, governed_cols, bounds, populations,
        hyper_offsets, hyper_prior, base_prior,
        noncentered=noncentered, cov_cols=cov_cols,
        target_mesh=target_mesh, local_bands=local_bands,
    )
    return _Setup(model, hier, k, d, governed_cols, bounds, populations, hyper_offsets,
                  cov_cols, hyper_names, hyper_dists, noncentered)


def fit_hierarchical(
    model,
    obs_stack,
    ivm_stack,
    population,
    sampler="nuts",
    chains=4,
    nwalkers=None,
    burn=500,
    iterations=500,
    seed=0,
    max_depth=8,
    init_pool=16,
    mesh=None,
    shard="chains",
    parametrization="centered",
    psf_stack=None,
    psfivm_stack=None,
    psf_oversample=1,
    device=None,
):
    """Joint hierarchical fit of K stacked observations.

    :param model: template model (instance / component list / model
        file, single-band or :class:`psfmc_tpu_torch.models.JointModel`;
        a list or path builds on ``device``: CUDA unless ``"cpu"``) — its
        Configuration(s) supply PSF/mask/zeropoint/geometry; per-target
        priors come from its component priors.  Multi-PSF templates
        marginalize the discrete index per target.
    :param obs_stack / ivm_stack: (K, H, W) stacks — or, for a joint
        model, a LIST of one (K, H_b, W_b) stack per band.
    :param population: dict mapping a SCALAR parameter trace name
        (e.g. ``'1_Sersic_index'``) to a population object
        (:class:`NormalPopulation`); that parameter's per-target prior
        density is replaced by the population density (truncated to the
        original support) and the population's hyperparameters are
        sampled.
    :param sampler: ``'nuts'`` (default: the joint space is ``K*d + h``
        dimensional) or ``'ensemble'`` (small K only; walkers default to
        ``2*(K*d+h) + 2``).
    :param chains: NUTS chains (one batch).
    :param init_pool: NUTS starts from the best ``chains`` of ``chains *
        init_pool`` prior draws.
    :param mesh: optional :func:`~psfmc_tpu_torch.parallel.walker_mesh`;
        ``shard`` says which axis it splits (the fit runs on the mesh's
        device unless ``device`` is given).
    :param shard: ``'chains'`` (default) splits the NUTS chain / ensemble
        walker axis over the mesh; ``'targets'`` splits the K targets of
        the likelihood instead (every chain on every process, each process
        rendering its own targets).  Without a mesh both are the
        one-device fit.
    :param parametrization: ``'centered'`` (default) or
        ``'noncentered'`` (standardized residuals sampled).  Results are
        reported in constrained theta space either way.
    :param psf_stack / psfivm_stack: optional survey-mode per-target
        PSFs (as :func:`psfmc_tpu_torch.batchfit.fit_batch` takes them).
        Pass the SAME stacks to :func:`target_loglike`/:func:`loo_targets`
        when replaying.
    :param psf_oversample: per-target PSF oversampling factor.
    :returns: :class:`HierarchicalResult`.
    """
    from .models.multicomponent import slot_param_names

    if check_mesh(mesh) is not None and device is None:
        device = mesh.device
    setup = _setup(model, obs_stack, ivm_stack, population, mesh=mesh, shard=shard,
                   parametrization=parametrization, psf_stack=psf_stack,
                   psfivm_stack=psfivm_stack, psf_oversample=psf_oversample,
                   device=device)
    hier, k, d = setup.hier, setup.k, setup.d
    spec = setup.model.spec
    dim = hier.spec.num_params
    # initial positions: per-target prior draws + hyper prior draws
    rng = np.random.RandomState(seed)
    sharding = (walker_sharding(mesh) if mesh is not None and shard == "chains"
                else None)
    if sampler == "nuts":
        from .sampler.nuts import NUTSSampler

        smp = NUTSSampler(
            int(chains), dim, hier, seed=seed, max_depth=max_depth,
            transform=setup.transform(), device=hier.device, sharding=sharding,
        )
        smp.init_state(setup.draw(int(chains) * int(init_pool), rng))
        smp.run_burn(int(burn))
        smp.reset()
        smp.run_sampling(int(iterations))
        diags = {
            "divergences": float(smp.n_divergent),
            "mean_accept": float(smp.acceptance_fraction.mean()),
        }
    elif sampler == "ensemble":
        from .sampler.ensemble import EnsembleSampler

        nw = nwalkers or 2 * dim + 2
        if nw % 2:
            nw += 1
        smp = EnsembleSampler(nw, dim, hier, seed=seed, device=hier.device,
                              sharding=sharding)
        smp.init_state(setup.draw(nw, rng))
        smp.run_burn(int(burn))
        smp.reset()
        smp.run_sampling(int(iterations))
        diags = {
            "mean_accept": float(smp.acceptance_fraction.mean()),
        }
    else:
        raise ValueError(
            f"unknown sampler {sampler!r}: expected 'nuts' or 'ensemble'"
        )

    # a copy: the reconstruction and the Gibbs pass below write into it,
    # and the sampler's chain stays the sampled one
    flat = np.array(smp.flatchain, np.float64)
    # flatchain is chain.reshape(-1, dim) — lnprobability (nchains, S)
    # flattens in the same row order
    lnp_flat = np.asarray(smp.lnprobability, np.float64).reshape(-1)
    per = flat[:, : k * d].reshape(len(flat), k, d)
    if setup.noncentered:
        # report constrained thetas: reconstruct governed columns from the
        # sampled residuals + that sample's own hyperparameters.  Dict
        # order means a governed regression covariate is already
        # constrained in `per` when its dependent reads it.
        for col, pop, off, xcol in zip(setup.governed_cols, setup.populations,
                                       setup.hyper_offsets, setup.cov_cols):
            nh = len(pop.hyper_dists)
            phi_chain = tuple(flat[:, k * d + off + j][:, None] for j in range(nh))
            per[:, :, col] = _host_reconstruct(
                pop, per[:, :, col], phi_chain,
                None if xcol is None else per[:, :, xcol])
        flat = np.concatenate(
            [per.reshape(len(flat), k * d), flat[:, k * d:]], axis=1
        )
    if hier.psf_margs:
        # Gibbs-sample the marginalized indices back per retained draw
        # (exact conditionals) so the reported chain carries them like
        # the regular trace database's PSF_Index column(s)
        for col, idx in hier.gibbs_psf_indices(per, seed=seed + 1).items():
            per[:, :, col] = idx
        flat = np.concatenate(
            [per.reshape(len(flat), k * d), flat[:, k * d:]], axis=1
        )
    return HierarchicalResult(
        param_names=slot_param_names(
            list(spec.param_names), list(spec.param_lens)
        ),
        hyper_names=setup.hyper_names,
        num_targets=k,
        target_mean=per.mean(axis=0),
        target_std=per.std(axis=0),
        hyper_chain=flat[:, k * d:],
        governed=list(population.keys()),
        diagnostics=diags,
        flatchain=flat,
        lnp=lnp_flat,
        populations=dict(population),
        governed_bounds={
            nm: setup.bounds[i] for i, nm in enumerate(population.keys())
        },
    )

