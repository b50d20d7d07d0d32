"""Autocorrelation analysis (emcee 2.x-equivalent algorithms).

The reference consumes emcee 2.2.1's ``autocorr`` module for both its
convergence check (``sampler.get_autocorr_time(c=1)``, reference
analysis/statistics.py:134-155) and its autocorrelation plots
(reference analysis/plotting.py:240-304).  This module reimplements the
same estimators natively:

* ``function`` — FFT-based normalized autocorrelation function,
* ``integrated_time`` — Sokal iterative-window estimate of the
  integrated autocorrelation time (window accepted once
  ``M > c * tau``); raises :class:`AutocorrError` when the chain is too
  short to estimate reliably, which callers treat as "not converged".
"""
from __future__ import annotations

import numpy as np

__all__ = ["AutocorrError", "function", "integrated_time"]


class AutocorrError(Exception):
    """The chain is too short to estimate an autocorrelation time."""

    def __init__(self, tau, *args):
        self.tau = tau
        super().__init__(*args)


def function(x, axis=0):
    """Normalized autocorrelation function along ``axis`` (FFT-based)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = x.shape[axis]
    f = np.fft.fft(x - np.mean(x, axis=axis, keepdims=True), n=2 * n, axis=axis)
    acf = np.fft.ifft(f * np.conjugate(f), axis=axis).real
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, n)
    acf = acf[tuple(sl)]
    sl[axis] = slice(0, 1)
    norm = acf[tuple(sl)]
    return acf / norm


def integrated_time(x, axis=0, low=10, high=None, step=1, c=10):
    """Integrated autocorrelation time with Sokal's iterative window.

    Walks window sizes ``M`` from ``low`` to ``high`` and accepts the
    first that satisfies ``M > c * max(tau)``; raises AutocorrError if
    no window converges (chain too short relative to tau).
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    f = function(x, axis=axis)
    n = x.shape[axis]
    if high is None:
        high = int(n / (2 * c)) if c > 0 else n
    high = max(high, low + 1)

    tau = None
    for m in range(low, high, step):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(1, m)
        tau = 1.0 + 2.0 * np.sum(f[tuple(sl)], axis=axis)
        # Near-white or slightly anticorrelated chains can estimate
        # tau <= 1; clamp rather than reject (matching emcee's window
        # criterion M > c * tau alone) so well-mixed chains are not
        # declared unconverged forever.  Deliberate divergence from
        # emcee 2.2.1 — documented in README "Differences from the
        # reference".
        tau = np.maximum(tau, 1.0)
        tau_max = float(np.max(tau))
        if m > c * tau_max:
            return tau
        if c * tau_max >= m and m + step >= high:
            break
    raise AutocorrError(
        tau,
        "The chain is too short to reliably estimate the autocorrelation "
        "time; run more iterations.",
    )
