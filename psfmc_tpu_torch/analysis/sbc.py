"""Simulation-based calibration (SBC) of the full fitting pipeline (port of ``analysis/sbc.py``).

Talts et al. 2018 (arXiv:1804.06788): draw parameters from the prior,
simulate data from them, fit the simulated data, and record the RANK of
each injected value within the posterior samples.  If the
prior/simulator/sampler stack is self-consistent, every rank is
uniformly distributed — ANY systematic deviation (overconfident or
biased posteriors, a renderer/noise-model mismatch, a broken sampler)
shows up as non-uniform ranks.  This is the end-to-end validation the
reference leaves to eyeballing completeness pulls; here it is one call
on top of the batched multi-target machinery
(:mod:`psfmc_tpu_torch.batchfit` — K simulate+fit cycles run as one
ensemble on the card, each step one CUDA graph replay).

Usage::

    from psfmc_tpu_torch.analysis.sbc import run_sbc
    res = run_sbc(model, n_sims=128, burn=400, iterations=400,
                  record_every=20)
    print(res.summary())       # per-parameter uniformity p-values
    assert res.calibrated()    # False => investigate

Statistical details:

* Ranks use a THINNED chain (``record_every``): SBC's uniformity
  theorem assumes (approximately) independent posterior draws —
  autocorrelated draws inflate the apparent rank concentration.  Set
  ``record_every`` to a few autocorrelation times.
* Uniformity is tested per parameter with a chi-square over ``bins``
  equal-width rank bins (the Talts et al. recommendation); the
  joint ``calibrated()`` verdict Bonferroni-corrects across
  parameters.
* Ties (rank exactly on a sample) are randomized — with continuous
  likelihoods they occur with probability ~0 but a deterministic
  tie-break would bias discrete-valued parameters (e.g. a PSF index).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["SBCResult", "run_sbc", "sbc_ranks_from_chains"]


@dataclass
class SBCResult:
    """Rank statistics from one SBC run.

    ``ranks[k, p]`` is the number of retained posterior samples below
    the injected value, in ``{0, ..., n_posterior}`` — uniform when
    the pipeline is calibrated.
    """

    param_names: List[str]
    ranks: np.ndarray  # (K, dim) integer ranks
    n_posterior: int  # samples per fit (rank support is 0..n_posterior)
    injected: np.ndarray  # (K, dim) the prior draws that were fit
    bins: int = 20

    @property
    def n_sims(self) -> int:
        return self.ranks.shape[0]

    def uniformity_pvalues(self) -> np.ndarray:
        """Per-parameter chi-square p-value of rank uniformity.

        Ranks live on the DISCRETE support {0, ..., n_posterior}, so
        each bin's expected count is proportional to how many integers
        it contains — equal-width real bins with a flat k/b expectation
        are wrong whenever b does not divide n_posterior + 1 (worst
        case, bins containing no representable rank guarantee a false
        MISCALIBRATED).  Bins with zero support are dropped from the
        statistic (df = populated bins - 1).
        """
        from scipy.stats import chi2

        k, dim = self.ranks.shape
        support = self.n_posterior + 1
        b = min(self.bins, max(2, k // 5), support)  # >=5 exp. per bin
        edges = np.linspace(0.0, float(support), b + 1)
        # integers per bin, with np.histogram's own binning semantics
        n_int, _ = np.histogram(np.arange(support), bins=edges)
        expected = k * n_int / float(support)
        keep = n_int > 0
        out = np.empty(dim)
        for p in range(dim):
            counts, _ = np.histogram(self.ranks[:, p], bins=edges)
            stat = float(np.sum(
                (counts[keep] - expected[keep]) ** 2 / expected[keep]
            ))
            out[p] = chi2.sf(stat, df=int(np.sum(keep)) - 1)
        return out

    def calibrated(self, alpha=0.01) -> bool:
        """True when no parameter rejects uniformity at the
        Bonferroni-corrected level ``alpha``."""
        p = self.uniformity_pvalues()
        return bool(np.all(p > alpha / max(len(p), 1)))

    def summary(self) -> str:
        p = self.uniformity_pvalues()
        lines = [
            f"SBC: {self.n_sims} simulations, "
            f"{self.n_posterior} posterior samples each"
        ]
        thr = 0.01 / max(len(p), 1)
        for name, pv in zip(self.param_names, p):
            flag = "  <-- NOT UNIFORM" if pv <= thr else ""
            lines.append(f"  {name:<24s} p={pv:.4f}{flag}")
        lines.append(
            "calibrated" if self.calibrated() else "MISCALIBRATED"
        )
        return "\n".join(lines)


def sbc_ranks_from_chains(chains, injected, rng=None):
    """Ranks of ``injected[k, p]`` within ``chains[k, ..., p]``.

    ``chains`` is ``(K, nrec, nwalkers, dim)`` (the
    :class:`~psfmc_tpu_torch.batchfit.BatchFitResult` recording layout) or
    any ``(K, ..., dim)``; ties are broken uniformly at random.
    """
    rng = rng or np.random.RandomState(0)
    chains = np.asarray(chains, np.float64)
    k, dim = chains.shape[0], chains.shape[-1]
    flat = chains.reshape(k, -1, dim)
    injected = np.asarray(injected, np.float64)
    below = np.sum(flat < injected[:, None, :], axis=1)
    equal = np.sum(flat == injected[:, None, :], axis=1)
    # randomized tie-break: uniform over the tied block
    jitter = (rng.random_sample(below.shape) * (equal + 1)).astype(int)
    return below + np.minimum(jitter, equal)


def run_sbc(
    model,
    n_sims=64,
    nwalkers=None,
    burn=400,
    iterations=400,
    record_every=20,
    seed=0,
    mesh=None,
    chunk=None,
    moves="stretch",
    bins=20,
    device=None,
):
    """End-to-end SBC: prior draws -> mocks -> batched fits -> ranks.

    One :func:`~psfmc_tpu_torch.batchfit.fit_batch` call does all
    ``n_sims`` fits as one ensemble on the card; only the thinned chains
    (needed for the rank statistics) come back to the host.  ``mesh=``
    splits the fits over its processes, as :func:`~psfmc_tpu_torch.
    batchfit.fit_batch` does; a model file or component list builds on
    ``device`` (CUDA unless ``"cpu"``; the mesh's device when a mesh is
    given).

    :param record_every: thinning interval of the retained chain used
        for ranks — set to a few autocorrelation times of the target
        posterior or the uniformity test reads overconfident.
    """
    if record_every <= 0:
        raise ValueError("run_sbc needs record_every > 0 (ranks are "
                         "computed from the thinned retained chain)")
    from ..batchfit import _as_model, fit_batch, simulate_stack
    from .._device import resolve_device
    from ..parallel.mesh import check_mesh

    if check_mesh(mesh) is not None and device is None:
        device = mesh.device
    model = _as_model(model, device=None if device is None else resolve_device(device))
    obs, ivm, injected = simulate_stack(model, n_sims, seed=seed)
    res = fit_batch(
        model,
        obs,
        ivm,
        nwalkers=nwalkers,
        burn=burn,
        iterations=iterations,
        seed=seed + 1,
        moves=moves,
        record_every=record_every,
        mesh=mesh,
        chunk=chunk,
    )
    ranks = sbc_ranks_from_chains(
        res.chains, injected, rng=np.random.RandomState(seed + 2)
    )
    n_post = int(np.prod(res.chains.shape[1:-1]))
    # expand names to one per SLOT (xy holds two: _x, _y) so the
    # per-parameter p-value table lines up with the rank columns
    from ..models.multicomponent import slot_param_names

    return SBCResult(
        param_names=slot_param_names(res.param_names, res.param_lens),
        ranks=ranks,
        n_posterior=n_post,
        injected=np.asarray(injected, np.float64),
        bins=bins,
    )
