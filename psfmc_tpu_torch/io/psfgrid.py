"""Spatially-varying PSFs: per-target PSF construction from field stars (port of ``io/psfgrid.py``).

The reference takes the PSF star(s) as a given input (utils.py:106-123
``preprocess_psf``; PSFSelector.py:16-43) — its users pick a star near
each target by hand before psfMC runs.  In survey mode the framework
fits hundreds of targets from one mosaic in a single batched ensemble
(:func:`psfmc_tpu_torch.io.cutout.cutout_stack` ->
:func:`psfmc_tpu_torch.batchfit.fit_batch`), so "pick the star by
hand" does not scale.  This module automates the standard survey
practice: given PSF stars scattered across the field, build each
target's local PSF.

Two methods, matching the two ways the framework can consume a PSF:

``method='idw'``
    One interpolated PSF per target: an inverse-distance-weighted
    (Shepard) per-pixel mean of the normalized star stamps, with
    bad-pixel-aware per-pixel weight renormalization and exact
    first-order IVM propagation.  Feeds ``psf_stack=`` with a single
    PSF per target.

``method='nearest'``
    The ``k`` nearest stars per target, untouched: feeds the
    framework's stochastic PSF-index machinery (the discrete index is
    marginalized per target), which turns PSF mismatch into an honest
    posterior width instead of a point estimate.  Requires the model
    template to declare ``k`` PSFs (``num_psfs == k``).

Positions are 0-based ``(x, y)`` mosaic pixels — the same convention
as :func:`~psfmc_tpu_torch.io.cutout.cutout_stack` (use its ``world=`` path
to map sky coordinates first).  Star stamps must share one shape; they
are run through the package's standard PSF preprocessing
(:func:`~psfmc_tpu_torch.io.preprocess.preprocess_psf`: bad pixels zeroed,
unit-sum normalization, IVM propagated through the rescale) before any
interpolation, so interpolation weights act on comparable unit-flux
stamps.
"""
from __future__ import annotations

import numpy as np

__all__ = ["interpolate_psfs"]


def _safe_ivm(var, good=None):
    """``1/var`` where ``var > 0`` (and ``good``), else 0.

    The bad-pixel IVM convention shared by every branch of
    :func:`interpolate_psfs` — keep the inversion rule in ONE place.
    """
    ok = (var > 0) if good is None else good & (var > 0)
    with np.errstate(divide="ignore"):
        return np.where(ok, 1.0 / np.where(ok, var, 1.0), 0.0)


def _load_stars(star_psfs, star_ivms):
    """Run every star through the standard PSF preprocessing."""
    from .preprocess import _get_image, preprocess_psf

    if len(star_psfs) != len(star_ivms):
        raise ValueError(
            f"star_psfs and star_ivms disagree on star count: "
            f"{len(star_psfs)} vs {len(star_ivms)}"
        )
    if len(star_psfs) == 0:
        raise ValueError("need at least one PSF star")
    psfs, variances, goods = [], [], []
    shape = None
    for p, i in zip(star_psfs, star_ivms):
        _, p_raw = _get_image(p)
        _, i_raw = _get_image(i)
        if p_raw.shape != i_raw.shape:
            raise ValueError(
                f"PSF and IVM shapes disagree: {p_raw.shape} vs "
                f"{i_raw.shape}"
            )
        if shape is None:
            shape = p_raw.shape
        elif p_raw.shape != shape:
            raise ValueError(
                f"all PSF stars must share one shape; got {shape} and "
                f"{p_raw.shape}"
            )
        good = np.isfinite(p_raw) & np.isfinite(i_raw) & (i_raw > 0)
        psf, var = preprocess_psf(p_raw, i_raw)
        psfs.append(np.asarray(psf, np.float64))
        variances.append(np.asarray(var, np.float64))
        goods.append(good)
    return (
        np.stack(psfs),  # (S, h, w) unit-sum, bad px zeroed
        np.stack(variances),  # (S, h, w) 0 at bad px
        np.stack(goods),  # (S, h, w) bool
    )


def interpolate_psfs(
    star_psfs,
    star_ivms,
    star_positions,
    target_positions,
    method="idw",
    k=None,
    power=2.0,
):
    """Build one local PSF (or a nearest-star stack) per target.

    :param star_psfs: length-S sequence of PSF star stamps — ``(h, w)``
        arrays or FITS filenames — or an ``(S, h, w)`` array.  All
        stamps must share one shape and be centered the same way (the
        package never recentroids PSF inputs; reference parity).
    :param star_ivms: the stars' inverse-variance maps, same forms.
    :param star_positions: ``(S, 2)`` 0-based mosaic ``(x, y)`` pixels.
    :param target_positions: ``(K, 2)`` target positions, same frame
        (e.g. the positions handed to
        :func:`~psfmc_tpu_torch.io.cutout.cutout_stack`).
    :param method: ``'idw'`` — Shepard-interpolated single PSF per
        target (from the ``k`` nearest stars if ``k`` is given, else
        all stars); ``'nearest'`` — the ``k`` nearest stars per target,
        unmixed, for stochastic-index marginalization (``k`` defaults
        to 1).
    :param power: IDW exponent p in ``w = 1/d^p`` (ignored for
        ``'nearest'``).
    :returns: ``(psf_stack, psfivm_stack)`` ready for the batched
        fitters' ``psf_stack=``/``psfivm_stack=``: ``(K, h, w)`` arrays
        for ``'idw'`` and ``'nearest'`` with k=1, per-target lists of
        ``k`` stamps (nearest first) otherwise.

    IDW semantics, per pixel: ``psf = sum_j w_j p_j / sum_j w_j`` over
    the stars whose pixel is GOOD (weights renormalize around each
    star's bad pixels independently — a hole in one star is filled by
    the others instead of biasing the sum low), with ``w_j = d_j^-p``
    and an exact-hit rule (a target within 1e-6 px of a star gets that
    star verbatim).  Variance propagates to first order as
    ``var = sum_j w_j^2 var_j / (sum_j w_j)^2``; pixels bad in EVERY
    contributing star return psf 0 / ivm 0 (= bad, the package PSF
    convention).  The interpolated stamp is a convex per-pixel mix of
    unit-sum stamps, so it is unit-sum up to bad-pixel holes; the
    fitters re-run standard preprocessing on every ``psf_stack`` entry
    anyway.
    """
    if hasattr(star_psfs, "ndim") and getattr(star_psfs, "ndim", 0) == 3:
        star_psfs = list(star_psfs)
    if hasattr(star_ivms, "ndim") and getattr(star_ivms, "ndim", 0) == 3:
        star_ivms = list(star_ivms)
    psfs, variances, goods = _load_stars(star_psfs, star_ivms)
    s = psfs.shape[0]

    star_positions = np.atleast_2d(np.asarray(star_positions, np.float64))
    target_positions = np.atleast_2d(
        np.asarray(target_positions, np.float64)
    )
    if star_positions.shape != (s, 2):
        raise ValueError(
            f"star_positions must be ({s}, 2) to match {s} stars; got "
            f"{star_positions.shape}"
        )
    if target_positions.ndim != 2 or target_positions.shape[1] != 2:
        raise ValueError(
            f"target_positions must be (K, 2), got "
            f"{target_positions.shape}"
        )
    if not (
        np.all(np.isfinite(star_positions))
        and np.all(np.isfinite(target_positions))
    ):
        raise ValueError("positions contain non-finite values")

    if method not in ("idw", "nearest"):
        raise ValueError(f"method must be 'idw' or 'nearest', got {method!r}")
    if k is None:
        k = 1 if method == "nearest" else s
    k = int(k)
    if not 1 <= k <= s:
        raise ValueError(f"k={k} must be in [1, {s}] (S={s} stars)")

    # (K, S) distances target -> star
    dist = np.sqrt(
        ((target_positions[:, None, :] - star_positions[None, :, :]) ** 2)
        .sum(-1)
    )
    # k nearest per target, nearest first (stable for ties)
    order = np.argsort(dist, axis=1, kind="stable")[:, :k]

    if method == "nearest":
        ivms = _safe_ivm(variances)
        if k == 1:
            sel = order[:, 0]
            return psfs[sel].copy(), ivms[sel].copy()
        psf_stack = [[psfs[j] for j in row] for row in order]
        ivm_stack = [[ivms[j] for j in row] for row in order]
        return psf_stack, ivm_stack

    n_targets = target_positions.shape[0]
    h, w = psfs.shape[1:]
    out_psf = np.empty((n_targets, h, w), np.float64)
    out_ivm = np.empty((n_targets, h, w), np.float64)
    for t in range(n_targets):
        sel = order[t]
        d = dist[t, sel]
        if d[0] < 1e-6:  # exact hit: that star verbatim
            j = sel[0]
            out_psf[t] = psfs[j]
            out_ivm[t] = _safe_ivm(variances[j])
            continue
        w_j = d ** -float(power)  # (k,)
        # per-pixel: only stars whose pixel is good contribute
        g = goods[sel]  # (k, h, w)
        wpx = w_j[:, None, None] * g  # (k, h, w)
        wsum = wpx.sum(0)  # (h, w)
        any_good = wsum > 0
        denom = np.where(any_good, wsum, 1.0)
        out_psf[t] = np.where(
            any_good, (wpx * psfs[sel]).sum(0) / denom, 0.0
        )
        var = (wpx**2 * variances[sel]).sum(0) / denom**2
        out_ivm[t] = _safe_ivm(var, good=any_good)
    return out_psf, out_ivm
