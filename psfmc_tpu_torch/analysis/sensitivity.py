"""Power-scaling prior/likelihood sensitivity diagnostics (port of
``analysis/sensitivity.py``).

Kallioinen, Paananen, Bürkner & Vehtari 2023 (arXiv:2107.14054): raise
the prior (or the likelihood) to a power ``alpha`` near 1, estimate the
perturbed posterior by Pareto-smoothed importance reweighting of the
existing chain (no refits), and measure how far each parameter's
marginal moves.  A large prior sensitivity with a large likelihood
sensitivity is a prior-data conflict; a large prior sensitivity alone,
a prior that dominates the data.

Each draw's ``ln pi(theta)`` and ``ln L(theta)`` are replayed on the
posterior's device in chunks (:meth:`~psfmc_tpu_torch.models.posterior.
PosteriorFns.log_prior_batch` and ``log_likelihood_batch``: the kernels
of the posterior's likelihood path; a joint model sums its bands'); the
order statistics and the distances are the JAX package's host numpy in
float64.

Distance: the cumulative Jensen-Shannon divergence between the base and
the reweighted weighted ECDFs (Nguyen & Vreeken 2015), scaled by
``1/|log2 alpha|``.  Indices at or above ``threshold`` (0.05) are
flagged.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from .model_comparison import TooFewDrawsError, _psis_smooth

__all__ = [
    "SensitivityResult",
    "power_scale_sensitivity",
    "power_scale_from_logs",
    "cjs_distance",
]

REPLAY_CHUNK = 1024  # draws per device replay of lnprior and lnL


# ---------------------------------------------------------------------------
# cumulative Jensen-Shannon distance
# ---------------------------------------------------------------------------

def cjs_distance(x, weights):
    """Normalized cumulative Jensen-Shannon distance.

    Between the empirical distribution of ``x`` (uniform weights) and
    the same sample reweighted by ``weights`` — the ECDF-based
    divergence of Nguyen & Vreeken 2015 used by the power-scaling
    paper.  0 for identical weightings; grows toward ~1 as the
    reweighted distribution separates from the base.
    """
    x = np.asarray(x, np.float64)
    w = np.asarray(weights, np.float64)
    w = w / np.sum(w)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    bins = np.diff(xs)
    if not np.any(bins > 0):
        return 0.0
    n = x.size
    cdf_p = np.arange(1.0, n + 1.0) / n
    cdf_q = np.cumsum(w[order])
    p = cdf_p[:-1]
    q = np.clip(cdf_q[:-1], 0.0, 1.0)
    mid = 0.5 * (p + q)
    with np.errstate(divide="ignore", invalid="ignore"):
        term_pq = np.where(p > 0, p * np.log2(p / np.where(mid > 0, mid, 1.0)), 0.0)
        term_qp = np.where(q > 0, q * np.log2(q / np.where(mid > 0, mid, 1.0)), 0.0)
    inv_2ln2 = 0.5 / np.log(2.0)
    cjs_pq = np.sum(bins * term_pq) + inv_2ln2 * np.sum(bins * (q - p))
    cjs_qp = np.sum(bins * term_qp) + inv_2ln2 * np.sum(bins * (p - q))
    bound = np.sum(bins * mid)
    if bound <= 0:
        return 0.0
    return float(np.sqrt(max(cjs_pq + cjs_qp, 0.0) / bound))


# ---------------------------------------------------------------------------
# result container
# ---------------------------------------------------------------------------

@dataclass
class SensitivityResult:
    """Per-parameter power-scaling sensitivity indices."""

    param_names: List[str]
    prior: np.ndarray  # (dim,)
    likelihood: np.ndarray  # (dim,)
    threshold: float = 0.05
    pareto_k: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def diagnosis(self, name_or_idx) -> str:
        i = (
            self.param_names.index(name_or_idx)
            if isinstance(name_or_idx, str)
            else int(name_or_idx)
        )
        pr = self.prior[i] >= self.threshold
        lk = self.likelihood[i] >= self.threshold
        if pr and lk:
            return "prior-data conflict"
        if pr:
            return "strong prior / weak likelihood"
        if lk:
            return "likelihood-dominated (prior uninformative)"
        return "robust"

    def flagged(self) -> List[str]:
        """Parameters whose diagnosis needs attention (conflict or a
        dominating prior)."""
        return [
            n
            for i, n in enumerate(self.param_names)
            if self.prior[i] >= self.threshold
        ]

    def summary(self) -> str:
        lines = [
            "power-scaling sensitivity "
            f"(threshold {self.threshold:g}):",
            f"  {'parameter':<24s} {'prior':>8s} {'lik':>8s}  diagnosis",
        ]
        for i, n in enumerate(self.param_names):
            diag = self.diagnosis(i)
            mark = "  <--" if diag.startswith(("prior", "strong")) else ""
            lines.append(
                f"  {n:<24s} {self.prior[i]:8.4f} "
                f"{self.likelihood[i]:8.4f}  {diag}{mark}"
            )
        lines.extend(f"  WARNING: {w}" for w in self.notes)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the diagnostic
# ---------------------------------------------------------------------------

def _replay_scalar(fn, thetas, chunk):
    """A batched per-draw scalar over the chain, ``chunk`` draws a call,
    as float64 on the host."""
    out = []
    for lo in range(0, len(thetas), chunk):
        with torch.no_grad():
            out.append(fn(thetas[lo : lo + chunk]).to("cpu", torch.float64).numpy())
    return np.concatenate(out)


def power_scale_sensitivity(
    model,
    database=None,
    thetas=None,
    alpha=1.01,
    threshold=0.05,
    max_samples=4000,
    chunk=REPLAY_CHUNK,
    device=None,
):
    """Power-scaling sensitivity of every parameter (no refits).

    ``model`` is anything ``as_model`` accepts (a model file is built on
    ``device``); draws come from ``thetas`` or evenly thinned ``database``
    rows.  ``alpha`` is the upper power (the lower is ``1/alpha``); the
    index is the mean CJS distance over the two directions scaled by
    ``1/|log2 alpha|``.  Fewer than 100 finite draws raise
    :class:`~psfmc_tpu_torch.analysis.model_comparison.TooFewDrawsError`
    (a ``ValueError``).
    """
    from ..models.multicomponent import as_model, slot_param_names
    from .model_comparison import _resolve_thetas

    model = as_model(model, device=device)
    thetas = _resolve_thetas(model, database, thetas, max_samples)
    fns = model.posterior_fns
    lnprior = _replay_scalar(fns.log_prior_batch, thetas, chunk)
    # a joint posterior's log_likelihood_batch is the sum of its bands'
    lnlik = _replay_scalar(fns.log_likelihood_batch, thetas, chunk)

    finite = np.isfinite(lnprior) & np.isfinite(lnlik)
    if not np.all(finite):
        thetas, lnprior, lnlik = (
            thetas[finite], lnprior[finite], lnlik[finite]
        )
    if len(thetas) < 100:
        raise TooFewDrawsError(
            "power_scale_sensitivity needs >=100 finite posterior draws"
        )
    return power_scale_from_logs(
        thetas,
        lnprior,
        lnlik,
        param_names=slot_param_names(model.param_names, model.param_lens),
        alpha=alpha,
        threshold=threshold,
    )


def power_scale_from_logs(
    thetas,
    lnprior,
    lnlik,
    param_names=None,
    alpha=1.01,
    threshold=0.05,
):
    """Sensitivity indices from precomputed per-draw log terms.

    The model-free core of :func:`power_scale_sensitivity` — exactly
    the estimator of Kallioinen et al. 2023: PSIS-reweight the chain
    by ``(alpha - 1) * ln pi`` (or ``ln L``) in both power directions,
    measure the CJS distance each marginal moved, scale by
    ``1/|log2 alpha|``.
    """
    thetas = np.asarray(thetas, np.float64)
    dim = thetas.shape[1]
    if param_names is None:
        param_names = [f"p{i}" for i in range(dim)]
    res = SensitivityResult(
        param_names=list(param_names),
        prior=np.zeros(dim),
        likelihood=np.zeros(dim),
        threshold=threshold,
    )
    scale = 1.0 / abs(np.log2(alpha))
    for comp, g in (
        ("prior", np.asarray(lnprior, np.float64)),
        ("likelihood", np.asarray(lnlik, np.float64)),
    ):
        dists = np.zeros(dim)
        for a in (alpha, 1.0 / alpha):
            lr = (a - 1.0) * g
            lw, ks = _psis_smooth(lr[None, :])
            k = float(ks[0])
            res.pareto_k[f"{comp}@{a:.4g}"] = k
            if k > 0.7:
                res.notes.append(
                    f"{comp} power-scaling weights at alpha={a:.4g} "
                    f"have Pareto k={k:.2f} > 0.7 — shrink alpha or "
                    "run a longer chain"
                )
                warnings.warn(res.notes[-1])
            w = np.exp(lw[0] - np.max(lw[0]))
            for p in range(dim):
                dists[p] += cjs_distance(thetas[:, p], w)
        # mean over the two directions, scaled to a per-log2-alpha rate
        comp_idx = dists / 2.0 * scale
        if comp == "prior":
            res.prior = comp_idx
        else:
            res.likelihood = comp_idx
    return res
