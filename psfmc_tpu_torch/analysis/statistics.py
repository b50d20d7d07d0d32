"""Convergence statistics (port of ``analysis/statistics.py``).

Host numpy in float64, a copy of the JAX package's module (the port
imports nothing of it): the classic Gelman-Rubin PSRF and effective
samples (BDA §11.6), the fitting driver's default
:func:`check_convergence_autocorr` (converged when the chain is at least
``min_chain_to_tau_ratio`` times longer than the integrated
autocorrelation time of every parameter, the dirty c=1 window, like the
reference), the modern multi-chain diagnostics of Vehtari et al. 2021
(:func:`rhat_rank`, :func:`ess_bulk`, :func:`ess_tail`: the judges of
NUTS's independent chains), and the trace database's
:func:`convergence_summary`, :func:`summary` and
:func:`to_inference_dict`.
"""
from __future__ import annotations

from warnings import warn

import numpy as np

from ..sampler.autocorr import AutocorrError

__all__ = [
    "potential_scale_reduction",
    "num_effective_samples",
    "check_convergence_autocorr",
    "check_convergence_psrf",
    "summary",
    "rhat_rank",
    "ess_bulk",
    "ess_tail",
    "convergence_summary",
    "to_inference_dict",
]


# The classic Gelman-Rubin quantities below are the standard textbook
# formulas (Gelman et al., BDA 2nd ed. §11.6, eqns 11.2-11.4; Brooks &
# Gelman 1998 eq. 1.1) — W is the mean within-chain variance, B/n the
# variance of the chain means, var-hat their (n-1)/n : 1/n blend.  Any
# implementation converges on the same expressions; this one computes
# them vectorized over an (nsamples, nchains) f64 matrix.


def _gelman_w_b(traces):
    """(W, B/n, n, m) for a list of 1-D chains, promoted to float64.

    Promotion matters: summing tens of thousands of float32 samples
    sequentially accumulates rounding drift of order 1e-3 on O(10)
    values — enough to visibly corrupt means and (through the two-pass
    variance) inflate stds.
    """
    x = np.column_stack(traces).astype(np.float64)
    n, m = x.shape
    w = float(np.mean(np.var(x, axis=0, ddof=1)))
    b_over_n = float(np.var(np.mean(x, axis=0), ddof=1))
    return w, b_over_n, n, m


def potential_scale_reduction(traces):
    """Gelman-Rubin R-hat over a list of 1-D chains (BDA §11.6)."""
    w, b_over_n, n, m = _gelman_w_b(traces)
    if w == 0:
        return 1.0
    var_hat = (n - 1) / n * w + b_over_n  # marginal posterior variance
    # sqrt of the (m+1)/m-corrected variance ratio, minus the
    # (n-1)/(m n) sampling-variability term (Brooks & Gelman eq. 1.1)
    return np.sqrt((m + 1) / m * var_hat / w - (n - 1) / (m * n))


def num_effective_samples(traces):
    """Effective sample count n*m*var-hat/B (BDA eqn 11.4), capped at
    n*m so autocorrelated sampling is never reported as better than
    independent (B underestimates or vanishes for short/agreeing
    chains)."""
    w, b_over_n, n, m = _gelman_w_b(traces)
    var_hat = (n - 1) / n * w + b_over_n
    b = n * b_over_n
    if b == 0 or var_hat > b:
        return n * m
    return n * m * var_hat / b


def check_convergence_autocorr(sampler, min_chain_to_tau_ratio=10, verbose=0):
    """True when chain length > ratio x integrated autocorrelation time.

    ``sampler`` is an EnsembleSampler (or anything exposing
    ``get_autocorr_time(c=1)`` and ``chain`` of shape
    (nwalkers, nsteps, dim)).
    """
    try:
        acorr = sampler.get_autocorr_time(c=1)
    except AutocorrError:
        warn(
            "Unable to estimate the autocorrelation time; assuming chain "
            "is not converged"
        )
        return False
    if verbose > 0:
        print(f"Autocorrelation times: {acorr}")
    nsamples = sampler.chain.shape[1]
    return bool(np.all(nsamples > min_chain_to_tau_ratio * np.asarray(acorr)))


def check_convergence_psrf(chains, psrf_tol=0.05, verbose=0):
    """Gelman-Rubin convergence over a (nwalkers, nsteps, dim) chain array.

    Converged when |R-hat - 1| < tol for every parameter.  (The
    reference's PSRF check targeted its legacy pymc interface; this is
    the working ensemble-chain equivalent.)
    """
    chains = np.asarray(chains)
    if chains.shape[0] < 2:
        return True
    converged = True
    for p in range(chains.shape[2]):
        traces = [chains[w, :, p] for w in range(chains.shape[0])]
        psrf = potential_scale_reduction(traces)
        if verbose > 0:
            print(f"param {p}: PSRF = {psrf}")
        converged &= abs(psrf - 1.0) < psrf_tol
    return bool(converged)


# ---------------------------------------------------------------------------
# Modern diagnostics (Vehtari, Gelman, Simpson, Carpenter & Burkner 2021):
# rank-normalized split-R-hat and bulk/tail effective sample sizes.
# Beyond the reference (whose statistics stop at classic Gelman-Rubin):
# rank normalization makes R-hat robust to heavy tails, and the folded
# variant catches chains that agree in location but not in scale —
# exactly the failure mode of an ensemble with a subset of walkers
# stuck in a narrow mode.
# ---------------------------------------------------------------------------


def _split_chains(chains):
    """(m, n) -> (2m, n//2): first/second halves as separate chains."""
    chains = np.asarray(chains, np.float64)
    n = chains.shape[1] // 2
    return np.concatenate([chains[:, :n], chains[:, n : 2 * n]], axis=0)


def _rank_normalize(chains):
    """Pooled fractional ranks -> normal scores (Vehtari eqn 14)."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    flat = chains.reshape(-1)
    r = rankdata(flat, method="average")
    z = ndtri((r - 0.375) / (flat.size + 0.25))
    return z.reshape(chains.shape)


def _classic_split_rhat(chains):
    """Classic R-hat over already-split (m, n) chains."""
    m, n = chains.shape
    if n < 2 or m < 2:
        return np.nan
    chain_means = chains.mean(axis=1)
    b = n * np.var(chain_means, ddof=1)
    w = np.mean(np.var(chains, axis=1, ddof=1))
    if w == 0:
        # a zero-variance (frozen) parameter is UNDIAGNOSABLE, not
        # healthy — the stretch move freezes all-equal coordinates
        # (project notes), and reporting 1.0 here would be the
        # diagnostic's worst false negative.  NaN propagates to the
        # CLI flag.
        return np.nan
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def rhat_rank(chains):
    """Rank-normalized split-R-hat: max of the bulk and tail variants.

    ``chains`` is (nchains, nsteps); bulk = R-hat of the
    rank-normalized split chains, tail = the same on the folded draws
    ``|x - median|`` (catches scale disagreement).  < 1.01 is the
    recommended threshold (Vehtari et al. 2021).
    """
    split = _split_chains(chains)
    bulk = _classic_split_rhat(_rank_normalize(split))
    folded = np.abs(split - np.median(split))
    tail = _classic_split_rhat(_rank_normalize(folded))
    return float(np.nanmax([bulk, tail]))


def _geyer_tau(chains):
    """Integrated autocorrelation time by Geyer's initial monotone
    positive sequence over combined chains (Vehtari eqns 10-13)."""
    chains = np.asarray(chains, np.float64)
    m, n = chains.shape
    if n < 4:
        return 1.0
    means = chains.mean(axis=1, keepdims=True)
    x = chains - means
    # per-chain autocovariance via FFT
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
    s2 = np.var(chains, axis=1, ddof=1)
    w = s2.mean()
    b_over_n = np.var(chains.mean(axis=1), ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b_over_n
    if var_plus == 0:
        # frozen chains: undiagnosable (see _classic_split_rhat)
        return np.nan
    rho = 1.0 - (w - acov.mean(axis=0)) / var_plus  # rho[0] == 1
    # Geyer: sum consecutive-lag pairs while positive, enforce the
    # pairs monotone non-increasing; tau = -1 + 2 * sum(pairs)
    # (the -1 removes rho[0]'s double count)
    prev_pair = np.inf
    pairs = []
    for t in range(0, n - 1, 2):
        p = rho[t] + rho[t + 1]
        if p <= 0:
            break
        p = min(p, prev_pair)
        prev_pair = p
        pairs.append(p)
    tau = -1.0 + 2.0 * float(np.sum(pairs))
    return max(tau, 1.0)


def ess_bulk(chains):
    """Bulk effective sample size on rank-normalized split chains."""
    split = _rank_normalize(_split_chains(chains))
    m, n = split.shape
    return float(m * n / _geyer_tau(split))


def ess_tail(chains, quantiles=(0.05, 0.95)):
    """Tail effective sample size: min ESS of the extreme-quantile
    indicator functions (how well the tails are resolved)."""
    chains = np.asarray(chains, np.float64)
    out = np.inf
    for q in quantiles:
        thr = np.quantile(chains, q)
        ind = _split_chains((chains <= thr).astype(np.float64))
        m, n = ind.shape
        out = min(out, m * n / _geyer_tau(ind))
    return float(out)


def _walker_grid(database):
    """(row order, nwalkers, nsamples) for chain reconstruction.

    Walker IDs may be NON-contiguous (``filter_lowp_walkers`` drops
    whole walkers but keeps their original IDs) — map to dense indices
    instead of assuming max+1 chains.
    """
    walker = np.asarray(database["walker"], int)
    sample = np.asarray(database["sample"], int)
    uniq_w = np.unique(walker)
    nw = len(uniq_w)
    ns = len(walker) // nw
    if nw * ns != len(walker):
        raise ValueError(
            "database rows do not form a complete walker x sample "
            f"grid ({len(walker)} rows, {nw} walkers)"
        )
    dense_w = np.searchsorted(uniq_w, walker)
    return np.lexsort((sample, dense_w)), nw, ns


def to_inference_dict(database):
    """ArviZ-ready dict of (chain, draw[, k]) arrays from a trace DB.

    Interop with the wider Bayesian-workflow ecosystem:
    ``arviz.from_dict(**to_inference_dict(db))`` builds an
    ``InferenceData`` (arviz is NOT a dependency of this package — the
    returned value is plain numpy).  ``posterior`` holds one entry per
    trace column (vector stochastics like ``xy`` keep a trailing
    length-2 axis); ``sample_stats`` carries the log-posterior as
    ``lp`` (the arviz-conventional name).  The ensemble-walker caveat
    of :func:`convergence_summary` applies to any cross-chain
    diagnostic run downstream.
    """
    order, nw, ns = _walker_grid(database)
    posterior = {}
    for name in database.colnames:
        if name in {"walker", "sample", "lnprobability"}:
            continue
        col = np.asarray(database[name], np.float64)
        shaped = col[order].reshape((nw, ns) + col.shape[1:])
        posterior[name] = shaped
    lp = np.asarray(database["lnprobability"], np.float64)
    return {
        "posterior": posterior,
        "sample_stats": {"lp": lp[order].reshape(nw, ns)},
    }


def convergence_summary(database):
    """Per-parameter modern diagnostics from a trace database.

    Reconstructs per-walker chains from the ``walker``/``sample``
    columns and returns an OrderedDict mapping each scalar trace name
    to ``{'rhat': rank-normalized split-R-hat, 'ess_bulk': ...,
    'ess_tail': ...}``.  Thresholds: rhat < 1.01 and ess > 400 are the
    published recommendations.

    Caveat (shared with every emcee-style workflow): ensemble walkers
    interact through the stretch move, so they are not fully
    independent chains — R-hat over walkers can read slightly
    optimistic.  The split in split-R-hat (first vs second half of
    each walker) still catches non-stationarity, and the ESS numbers
    remain meaningful.
    """
    from collections import OrderedDict

    order, nw, ns = _walker_grid(database)
    out = OrderedDict()
    skip = {"walker", "sample"}
    for name in database.colnames:
        if name in skip:
            continue
        col = np.asarray(database[name], dtype=np.float64)
        cols = (
            [(name, col)]
            if col.ndim == 1
            else [(f"{name}_{i}", col[:, i]) for i in range(col.shape[1])]
        )
        for cname, values in cols:
            chains = values[order].reshape(nw, ns)
            out[cname] = {
                "rhat": rhat_rank(chains),
                "ess_bulk": ess_bulk(chains),
                "ess_tail": ess_tail(chains),
            }
    return out


def summary(database, percentiles=(16.0, 50.0, 84.0)):
    """Posterior summary table: one row per scalar trace column.

    Returns an OrderedDict mapping trace name (vector stochastics like
    ``xy`` expand to ``name_0``/``name_1``) to a dict with ``mean``,
    ``std`` and one ``p{q:g}`` entry per requested percentile —
    everything promoted to f64 before reduction (the f32 summation
    drift documented in the project notes corrupts means of long
    chains).  A quick programmatic companion to the FITS header stats.
    """
    from collections import OrderedDict

    out = OrderedDict()
    skip = {"walker", "sample"}
    for name in database.colnames:
        if name in skip:
            continue
        col = np.asarray(database[name], dtype=np.float64)
        cols = (
            [(name, col)]
            if col.ndim == 1
            else [(f"{name}_{i}", col[:, i]) for i in range(col.shape[1])]
        )
        for cname, values in cols:
            stats = {
                "mean": float(np.mean(values)),
                "std": float(np.std(values)),
            }
            qs = np.percentile(values, percentiles)
            for q, v in zip(percentiles, qs):
                stats[f"p{q:g}"] = float(v)
            out[cname] = stats
    return out
