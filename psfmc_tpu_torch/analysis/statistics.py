"""Convergence check of the fitting driver (port of ``analysis/statistics.py``, one function).

:func:`check_convergence_autocorr` is the fitting driver's default: converged
when the chain is at least ``min_chain_to_tau_ratio`` times longer than
the integrated autocorrelation time of every parameter (the dirty c=1
window, like the reference).
"""
from __future__ import annotations

from warnings import warn

import numpy as np

from ..sampler.autocorr import AutocorrError

__all__ = ["check_convergence_autocorr"]


def check_convergence_autocorr(sampler, min_chain_to_tau_ratio=10, verbose=0):
    """True when chain length > ratio x integrated autocorrelation time.

    ``sampler`` exposes ``get_autocorr_time(c=1)`` and ``chain`` of shape
    ``(nwalkers, nsteps, dim)``.
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
