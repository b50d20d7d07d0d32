"""Trace, histogram, autocorrelation, corner, criticism and radial-profile
plots (port of ``analysis/plotting.py``).

Axis-label templating, the four derived traces (``magdiff``,
``centerdist``, ``axisratio``, ``sbeff`` in mag/arcsec^2 through the WCS
pixel area), per-walker trace plots, prior overlays on histograms,
autocorrelation plots with effective sample counts, corner plots
(:mod:`psfmc_tpu_torch.analysis.corner`), the one-page model-criticism
sheet and the radial surface-brightness profile.

matplotlib is imported inside each plot (Agg-safe) and is not a
dependency of the rest of the port.  A plot that needs the model (a
prior overlay, the criticism replay, the posterior-mean profile) builds
a model file on ``device`` (CUDA unless ``"cpu"``).
"""
from __future__ import annotations

import os
from warnings import warn

import numpy as np

from ..database import filter_lowp_walkers, load_database
from ..io.wcs import MiniWCS, proj_plane_pixel_area
from ..ops.coords import mag_to_flux
from ..sampler import autocorr as _autocorr
from .corner import corner as _corner

__all__ = [
    "plot_trace",
    "plot_hist",
    "plot_autocorr",
    "plot_profile",
    "radial_profile",
    "corner_plot",
    "plot_criticism",
]

_LABELS = {
    "lnprobability": "Model posterior log-probability",
    "x": "{} x (pix)",
    "y": "{} y (pix)",
    "xy": "{} x,y (pix)",
    "adu": "{} (adu)",
    "mag": "{} mag",
    "index": "{} index $n$",
    "reff": "{} $R_e a$ (pix)",
    "reff_b": "{} $R_e b$ (pix)",
    "angle": "{} PA (deg)",
    "PSF_Index": "PSF index",
    "axisratio": "{} axis ratio $b/a$",
    "sbeff": "{} $\\mu_e$ (mag arcsec$^2$)",
    "magdiff": "$m_{{{}}} - m_{{{}}}$",
    "centerdist": "{} vs. {} position difference (pixels)",
}


def _axis_label(trace_name):
    """Human-readable axis label for a trace name."""
    if trace_name in _LABELS:
        return _LABELS[trace_name]
    if "_" in trace_name:
        comps = []
        rest = trace_name
        while rest not in _LABELS and rest != "":
            parts = rest.split("_", 2)
            if len(parts) < 3:
                break
            index, comp, rest = parts
            comps.append(f"({index}) {comp}")
        return _LABELS.get(rest, rest).format(*comps)
    return trace_name


def _sersic_sb_eff_host(flux, index, reff, reff_b):
    """Host-side surface brightness at r_e (for the sbeff derived trace)."""
    import scipy.special as sp

    kappa = sp.gammaincinv(2 * index, 0.5)
    return flux / (
        np.pi
        * reff
        * reff_b
        * 2
        * index
        * np.exp(kappa + np.log(kappa) * -2 * index)
        * sp.gamma(2 * index)
    )


def _get_trace(trace_name, db, model=None):
    """Trace array (N, D) for a column or derived quantity.

    Derived names (reference plotting.py:60-109):
    ``<c1>_<c2>_magdiff``, ``<c1>_<c2>_centerdist``,
    ``<n>_Sersic_axisratio``, ``<n>_Sersic_sbeff``.

    Like the reference, derived traces read only DB columns, so they
    see stochastic parameters (constants are not trace columns).  The
    ``sbeff`` boxiness correction therefore applies when ``c0`` was
    fit; Fourier-mode area corrections are not applied (their phases
    may be non-stochastic and invisible here — for shaped fits quote
    surface brightness from the posterior images instead).
    """
    name_comps = trace_name.split("_")
    try:
        if "magdiff" in name_comps:
            key1 = "_".join(name_comps[0:2] + ["mag"])
            key2 = "_".join(name_comps[2:4] + ["mag"])
            trace = np.asarray(db[key1]) - np.asarray(db[key2])
        elif "centerdist" in name_comps:
            key1 = "_".join(name_comps[0:2] + ["xy"])
            key2 = "_".join(name_comps[2:4] + ["xy"])
            cdiff = np.asarray(db[key1]) - np.asarray(db[key2])
            trace = np.sqrt(np.sum(cdiff**2, axis=1))
        elif "axisratio" in name_comps:
            prefix = "_".join(name_comps[0:2] + [""])
            # each profile family stores its own (major, minor) pair:
            # Sersic reff, Moffat fwhm, King rc, Ferrer rout, Nuker rb
            minor, major = ("reff_b", "reff")
            for cand in ("fwhm", "rc", "rout", "rb"):
                if prefix + "reff" not in db.colnames and (
                    prefix + cand in db.colnames
                ):
                    minor, major = (cand + "_b", cand)
                    break
            else:
                if prefix + "reff" not in db.colnames and (
                    prefix + "rs" in db.colnames
                ):
                    # EdgeDisk: apparent flattening hs/rs (no _b pair)
                    minor, major = ("hs", "rs")
            trace = np.asarray(db[prefix + minor]) / np.asarray(
                db[prefix + major]
            )
        elif "sbeff" in name_comps:
            prefix = "_".join(name_comps[0:2] + [""])
            flux = mag_to_flux(np.asarray(db[prefix + "mag"]), 0)
            trace = _sersic_sb_eff_host(
                flux,
                np.asarray(db[prefix + "index"]),
                np.asarray(db[prefix + "reff"]),
                np.asarray(db[prefix + "reff_b"]),
            )
            if prefix + "c0" in db.colnames:
                # boxy/disky fits renormalize flux by the superellipse
                # area — mirror the renderer through the shared helper
                # so mu_e stays the true surface brightness at r_e
                from ..ops.isophote import superellipse_area_factor_host

                c = np.asarray(db[prefix + "c0"]) + 2.0
                trace = trace * (
                    np.pi / superellipse_area_factor_host(c)
                )
            if model is not None and model.obs_header is not None:
                wcs = MiniWCS(model.obs_header)
                px_area = proj_plane_pixel_area(wcs) * 3600**2
                trace = trace / px_area
            trace = -2.5 * np.log10(trace)
        else:
            trace = np.asarray(db[trace_name])
    except KeyError as err:
        raise KeyError(
            f"Unable to find trace {trace_name}. Available traces are "
            f"{db.colnames} or magdiff, centerdist, axisratio, sbeff"
        ) from err

    trace = np.asarray(trace, dtype=np.float64)
    if trace.ndim == 1:
        trace = trace[:, None]
    return trace


def _load_db_and_model(db_file, model_file, device=None):
    """(display name, db Table, model or None) from filenames; a model file
    is built on ``device``."""
    disp_name, _ext = os.path.splitext(os.path.basename(db_file))
    db = load_database(db_file)
    model = None
    if model_file is not None:
        from ..models.multicomponent import MultiComponentModel

        if isinstance(model_file, MultiComponentModel):
            return disp_name, db, model_file
        try:
            model = MultiComponentModel(model_file, device=device)
        except Exception as exc:  # fuzzy-matched file may not be a model
            # plot_chain guesses the model file by filename similarity
            # (reference scripts/plot_chain:72-78); the nearest .py can
            # be an unrelated script — degrade to no prior overlay
            # instead of crashing the plotting tool.
            print(
                f"Unable to load model file {model_file} ({exc}). "
                "Priors will not be plotted."
            )
            model = None
    return disp_name, db, model


def plot_trace(trace_name, db, model=None, save=False, device=None):
    """Per-walker value-vs-sample trace plot with marginal histogram."""
    import matplotlib.pyplot as pp
    from matplotlib.ticker import MaxNLocator
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    disp_name, db, model = _load_db_and_model(db, model, device)

    fig = pp.figure()
    ax_trace = pp.subplot(111)
    divider = make_axes_locatable(ax_trace)
    ax_hist = divider.append_axes("right", size=1.2, pad=0.1, sharey=ax_trace)
    ax_hist.get_xaxis().set_major_locator(MaxNLocator(nbins=3, integer=True))
    pp.setp(ax_hist.get_yticklabels(), visible=False)
    ax_hist.get_xaxis().tick_top()

    best_row = int(np.argmax(db["lnprobability"]))
    trace = _get_trace(trace_name, db, model=model)
    walkers = np.asarray(db["walker"])
    n_walkers = int(walkers.max()) + 1
    n_samples = trace.shape[0] // n_walkers

    for col in range(trace.shape[1]):
        for walker in range(n_walkers):
            walker_trace = trace[:, col][walkers == walker]
            ax_trace.plot(
                np.arange(len(walker_trace)),
                walker_trace,
                color="black",
                alpha=0.3,
                lw=0.5,
            )
        ax_hist.hist(
            trace[:, col], bins=20, histtype="step", orientation="horizontal"
        )
        ax_hist.axhline(trace[best_row, col], color="Orange", lw=2)

    ax_trace.set_xlabel("Sample")
    ax_trace.set_ylabel(_axis_label(trace_name))
    fig.suptitle(disp_name)
    _show_or_save(fig, save, f"{disp_name}_{trace_name}_trace.pdf")
    return n_samples


def plot_hist(trace_name, db, model=None, save=False, device=None):
    """Histogram of a traced quantity, with optional prior overlay."""
    import matplotlib.pyplot as pp
    from matplotlib.transforms import blended_transform_factory

    disp_name, db, model = _load_db_and_model(db, model, device)

    fig = pp.figure()
    ax = fig.add_subplot(111)

    trace = _get_trace(trace_name, db, model=model)
    best_row = int(np.argmax(db["lnprobability"]))
    for col in range(trace.shape[1]):
        ax.hist(trace[:, col], bins=20, histtype="step", lw=2)
        ax.axvline(trace[best_row, col], lw=2, ls="dashed")

    fig.suptitle(disp_name)
    ax.set_xlabel(_axis_label(trace_name))
    ax.set_ylabel("Number of Samples")

    prior = model.get_distribution(trace_name) if model is not None else None
    if prior is not None:
        min_xs, max_xs = prior.interval(0.99)
        min_xs = np.atleast_1d(min_xs).astype(float)
        max_xs = np.atleast_1d(max_xs).astype(float)
        span = max_xs - min_xs
        min_xs = min_xs - 0.01 * span
        max_xs = max_xs + 0.01 * span
        prior_x = np.column_stack(
            [
                np.linspace(lo, hi, 100)
                for lo, hi in zip(min_xs, max_xs)
            ]
        )
        prior_xform = blended_transform_factory(ax.transData, ax.transAxes)
        ax.plot(
            prior_x,
            np.exp(prior.logp(prior_x)),
            lw=1,
            color="black",
            zorder=-1,
            transform=prior_xform,
        )

    _show_or_save(fig, save, f"{disp_name}_{trace_name}_hist.pdf")


def plot_autocorr(trace_name, db, save=False):
    """Autocorrelation vs lag, per walker + walker average, with n_eff."""
    import matplotlib.pyplot as pp

    disp_name, db, _model = _load_db_and_model(db, None)

    trace = _get_trace(trace_name, db)
    walkers = np.asarray(db["walker"])
    n_walkers = int(walkers.max()) + 1
    n_samples = trace.shape[0] // n_walkers

    for col in range(trace.shape[1]):
        fig = pp.figure()
        ax = fig.add_subplot(111)

        trace_walkers = trace[:, col].reshape((n_walkers, n_samples)).T
        lags = np.arange(n_samples)
        acorr_all = _autocorr.function(trace_walkers, axis=0)
        trace_avg = np.mean(trace_walkers, axis=1)
        acorr_avg = _autocorr.function(trace_avg)
        try:
            tau = float(np.max(_autocorr.integrated_time(trace_avg, c=1)))
            eff_samples = n_samples / tau
            neff_label = f"$n_{{eff}}$ = {eff_samples:0.1f}"
        except _autocorr.AutocorrError:
            neff_label = "$n_{eff}$ unavailable"

        maxlag = int(np.argmin(acorr_avg > 0)) or n_samples

        for walk in range(n_walkers):
            ax.plot(
                lags,
                acorr_all[:, walk],
                ls="solid",
                lw=1,
                color="black",
                alpha=0.3,
                drawstyle="steps-mid",
            )
        ax.plot(lags, acorr_avg, ls="solid", lw=2, drawstyle="steps-mid")

        trace_label = trace_name
        if "xy" in trace_label:
            trace_label = trace_label.replace("xy", "xy"[col])
        fig.suptitle(" ".join([disp_name, _axis_label(trace_label)]))
        ax.set_xlim(0, maxlag * 1.01)
        ax.axhline(0.0, color="black")
        ax.set_xlabel("Lag Length (Samples)")
        ax.set_ylabel("Autocorrelation (Normalized)")
        # white text stroke so the annotation stays readable over data
        # (the reference defines this effect but never wires it —
        # plotting.py:39 `_text_stroke`, unused; applied here as
        # intended)
        from matplotlib import patheffects

        ax.text(
            0.95,
            0.95,
            neff_label,
            va="top",
            ha="right",
            transform=ax.transAxes,
            path_effects=[
                patheffects.withStroke(linewidth=3, foreground="w")
            ],
        )
        _show_or_save(fig, save, f"{disp_name}_{trace_name}_acorr.pdf")


def corner_plot(
    database,
    disp_parameters=None,
    save=False,
    skip_zero_variance=True,
    filter_walkers=10,
    **kwargs,
):
    """Corner plot of sampled parameters (reference plotting.py:307-380)."""
    import matplotlib.pyplot as pp

    disp_name, db, _model = _load_db_and_model(database, None)
    if filter_walkers is not None:
        db = filter_lowp_walkers(db, filter_walkers)

    available = db.colnames
    if disp_parameters is None:
        display_cols = [
            c for c in available if c not in ("lnprobability", "walker",
                                              "sample")
        ]
    else:
        missing = set(disp_parameters) - set(available)
        if missing:
            raise ValueError(f"Unable to find trace(s) named: {missing}")
        display_cols = list(disp_parameters)

    traces = [_get_trace(name, db) for name in display_cols]
    flat = np.column_stack(traces)

    labels = list(display_cols)
    xy_inds = [i for i, lab in enumerate(labels) if "xy" in lab]
    for ind in reversed(xy_inds):
        label = labels[ind]
        labels[ind] = label.replace("xy", "y")
        labels.insert(ind, label.replace("xy", "x"))
    labels = [_axis_label(lab) for lab in labels]

    if skip_zero_variance:
        col_vars = np.var(flat, axis=0)
        keep = np.where(col_vars != 0)[0]
        removed = [labels[i] for i in range(flat.shape[1]) if i not in keep]
        flat = flat[:, keep]
        labels = [labels[i] for i in keep]
        if removed:
            warn(
                "The following traces had zero variance and will not be "
                f"displayed: {removed}"
            )

    fig = _corner(
        flat,
        labels=labels,
        max_n_ticks=3,
        range=[0.99] * len(labels),
        label_kwargs={"fontsize": "small"},
        **kwargs,
    )
    _show_or_save(fig, save, f"{disp_name}_corner.pdf")


def plot_criticism(database, model, save=False, draws=500, device=None):
    """One-page model-criticism sheet (beyond the reference).

    Top panel: LOO-PIT histogram over all unmasked pixels with the
    binomial uniform band — bathtub shape = overconfident noise model,
    dome = overdispersed, slope = bias.  Per band below: the Pareto-k
    map (pixels whose LOO term is unreliable — unmasked artifacts show
    up here) and the LOO z-score map ``Phi^-1(PIT)`` (a residual map
    calibrated against the model's own leave-one-out predictive, so
    structure in it is genuine misfit, not noise).
    """
    import matplotlib.pyplot as pp
    from scipy.stats import norm as _norm

    from ..models.multicomponent import as_model
    from .model_comparison import (
        REPLAY_CHUNK,
        _band_slices,
        _pointwise_matrix_pair,
        _resolve_thetas,
        loo_pit,
        psis_loo,
    )

    # NB not _load_db_and_model: that helper builds a single-band
    # MultiComponentModel from a guessed filename; criticism needs the
    # general dispatch (prepared models, joint multi-band files)
    if isinstance(database, str):
        disp_name = os.path.splitext(os.path.basename(database))[0]
        db = load_database(database)
    else:
        disp_name = "model"
        db = database
    model = as_model(model, device=device)
    thetas = _resolve_thetas(model, db, None, draws)
    ll, cdfm = _pointwise_matrix_pair(model, thetas, REPLAY_CHUNK)
    loo = psis_loo(loglike=ll)
    pit = loo_pit(loglike=ll, cdf=cdfm)

    bands = _band_slices(model)
    nbands = len(bands)
    fig, axes = pp.subplots(
        1 + nbands, 2, figsize=(9, 3.2 * (1 + nbands))
    )
    axes = np.atleast_2d(axes)

    # PIT histogram + uniform band
    ax = axes[0, 0]
    nbins = 25
    n = pit.pit.size
    counts, edges, _ = ax.hist(
        pit.pit, bins=nbins, range=(0, 1), color="C0", alpha=0.8
    )
    exp = n / nbins
    band = 2.0 * np.sqrt(exp * (1 - 1 / nbins))  # ~95% binomial band
    ax.axhspan(exp - band, exp + band, color="gray", alpha=0.3)
    ax.axhline(exp, color="k", lw=1)
    ax.set_xlabel("LOO-PIT")
    ax.set_title(
        f"KS p = {pit.ks_pvalue:.3g} "
        f"({'calibrated' if pit.calibrated() else 'MISCALIBRATED'})"
    )
    # Pareto-k rank plot (all pixels)
    ax = axes[0, 1]
    finite_k = loo.pareto_k[np.isfinite(loo.pareto_k)]
    ax.plot(np.sort(finite_k), ".", ms=2)
    ax.axhline(0.7, color="r", lw=1, ls="--")
    ax.set_xlabel("pixel (sorted)")
    ax.set_ylabel("Pareto k")
    nbad = int(np.sum(loo.pareto_k > 0.7))
    ax.set_title(f"{nbad} pixels k > 0.7; p_eff = {loo.p_eff:.1f}")

    # per-band maps: k and LOO z-score, reconstructed onto the grid
    z_flat = _norm.ppf(np.clip(pit.pit, 1e-9, 1 - 1e-9))
    for b, (good, part) in enumerate(bands):
        for col, (vals, label, kw) in enumerate(
            (
                (loo.pareto_k[part], "Pareto k",
                 dict(vmin=0, vmax=1, cmap="magma")),
                (z_flat[part], "LOO z-score",
                 dict(vmin=-4, vmax=4, cmap="RdBu_r")),
            )
        ):
            img = np.full(good.shape, np.nan)
            img[good] = vals
            ax = axes[1 + b, col]
            im = ax.imshow(img, origin="lower", **kw)
            fig.colorbar(im, ax=ax, shrink=0.8)
            ax.set_title(
                label if nbands == 1 else f"band {b}: {label}"
            )
    fig.suptitle(disp_name)
    fig.tight_layout()
    _show_or_save(fig, save, f"{disp_name}_criticism.pdf")
    return loo, pit


def radial_profile(image, center, variance=None, good=None, bin_px=1.0,
                   rmax=None, axis_ratio=1.0, angle=0.0):
    """Azimuthally averaged radial profile in whole-pixel annuli.

    Host f64 numpy (analysis layer).  ``center`` is 0-based ``(x, y)``;
    annuli are ``[i*bin_px, (i+1)*bin_px)`` out to ``rmax`` (default:
    the largest circular radius fully inside the frame).  Bad pixels
    (``good=False``) are excluded from both the mean and the error.
    ``axis_ratio < 1`` with ``angle`` (radians, the component ``angle``
    convention — the renderer's +90° PA rotation is applied here too)
    switches to ELLIPTICAL annuli: the radius is the semi-major axis of
    the aligned ellipse through each pixel, GALFIT-ellipse style.

    :returns: ``(r_mid, mean, err, npix)`` — annulus mid-radii, the
        area-weighted mean per annulus (NaN where empty), the standard
        error of that mean from the per-pixel ``variance`` map
        (``sqrt(sum var) / N``; NaN when no variance given), and the
        contributing pixel count.
    """
    image = np.asarray(image, np.float64)
    h, w = image.shape
    cx, cy = float(center[0]), float(center[1])
    yy, xx = np.mgrid[0:h, 0:w]
    ang = float(angle) + 0.5 * np.pi  # renderer parity (ops/sersic.py)
    ca, sa = np.cos(ang), np.sin(ang)
    dx, dy = xx - cx, yy - cy
    u = ca * dx + sa * dy
    v = -sa * dx + ca * dy
    r = np.hypot(u, v / float(axis_ratio))
    if good is None:
        good = np.ones(image.shape, bool)
    if rmax is None:
        rmax = max(min(cx, cy, (w - 1) - cx, (h - 1) - cy), bin_px)
    nb = max(int(np.floor(float(rmax) / float(bin_px))), 1)
    edges = np.arange(nb + 1, dtype=np.float64) * float(bin_px)
    idx = np.digitize(r.ravel(), edges) - 1
    ok = np.asarray(good).ravel() & (idx >= 0) & (idx < nb)
    sel = idx[ok]
    cnt = np.bincount(sel, minlength=nb).astype(np.float64)
    mean = np.bincount(sel, weights=image.ravel()[ok], minlength=nb)
    mean = np.where(cnt > 0, mean / np.maximum(cnt, 1.0), np.nan)
    if variance is not None:
        v = np.asarray(variance, np.float64).ravel()[ok]
        err = np.sqrt(
            np.bincount(sel, weights=v, minlength=nb)
        ) / np.maximum(cnt, 1.0)
        err = np.where(cnt > 0, err, np.nan)
    else:
        err = np.full(nb, np.nan)
    r_mid = 0.5 * (edges[:-1] + edges[1:])
    return r_mid, mean, err, cnt.astype(np.int64)


def _component_angle_degrees(model, component):
    """True when the named component's ``angle`` attribute is in
    degrees (its static ``angle_degrees`` flag); False when unknown.

    Trace prefixes number non-Configuration components in model-file
    order, which is exactly ``spec.comp_specs`` order.
    """
    if model is None:
        return False
    try:
        idx = int(component.split("_", 1)[0])
        cs = model.spec.comp_specs[idx]
    except (ValueError, IndexError, AttributeError):
        return False
    return bool(getattr(cs, "static", None) or {}) and bool(
        cs.static.get("angle_degrees", False)
    )


def plot_profile(db, model=None, save=False, component=None, bin_px=1.0,
                 rmax=None, axis_ratio=None, angle=None, device=None):
    """Radial surface-brightness profile: data vs posterior-mean model.

    The classic 1-D sanity check of 2-D decomposition work (the
    reference has no analogue): azimuthal annulus averages of the
    observation (points with noise error bars), the posterior-mean
    convolved model (line) and — when the model has a point source —
    the point-source-subtracted data, over a residual significance
    panel ``(data - model) / noise`` per annulus.  PSF mismatch, sky
    errors and Sersic-index tension that hide in a 2-D residual image
    show up here at a glance.

    Radii are measured from ``component``'s posterior-mean center
    (a trace prefix like ``'1_Sersic'``); default is the brightest
    pixel of the posterior-mean convolved model.  When the named
    component has fitted ``reff``/``reff_b``/``angle`` columns, the
    annuli default to ELLIPSES matching its posterior-mean shape
    (GALFIT-ellipse semantics: the radius axis is the isophote
    semi-major axis); override with ``axis_ratio=``/``angle=`` (angle
    in the component's own units) or force circles with
    ``axis_ratio=1``.  In mag/arcsec^2 when the observation header
    carries a celestial WCS (surface brightness via the pixel area and
    the Configuration zeropoint), linear image units otherwise.

    Needs the model (to replay posterior-mean images): pass
    ``model=`` or keep the model file next to the DB so the fuzzy
    CLI match finds it.
    """
    import matplotlib.pyplot as pp

    disp_name, db, model = _load_db_and_model(db, model, device)
    if model is None:
        raise ValueError(
            "plot_profile needs the model (for the posterior-mean "
            "image replay): pass model= or keep the model file next "
            "to the database"
        )
    # posterior_images may be pre-filled with ONES by reset_images —
    # only trust it when samples were actually accumulated
    imgs = getattr(model, "posterior_images", None)
    if not imgs or getattr(model, "accumulated_samples", 0) == 0:
        thetas = model.thetas_from_database(
            filter_lowp_walkers(db, percentile=10)
        )
        imgs = model.replay_posterior_means(thetas)
    obs = np.asarray(model.spec.obs_data, np.float64)
    good = ~np.asarray(model.spec.bad_px, bool)
    conv = np.asarray(imgs["convolved_model"], np.float64)
    ivm = np.asarray(imgs["composite_ivm"], np.float64)
    var = np.where(good & (ivm > 0), 1.0 / np.where(ivm > 0, ivm, 1.0),
                   np.inf)
    good = good & np.isfinite(var)

    if component is not None:
        col = f"{component}_xy"
        if col in db.colnames:
            center = np.asarray(db[col], np.float64).mean(axis=0)
        else:
            raise KeyError(
                f"no trace column {col!r} (constant centers are not in "
                f"the DB); available: {db.colnames}"
            )
        # elliptical annuli matching the component's posterior-mean
        # shape, when it has one (stochastic columns only — constants
        # are not in the DB, same limit as the derived traces)
        if axis_ratio is None and (
            f"{component}_reff" in db.colnames
            and f"{component}_reff_b" in db.colnames
        ):
            axis_ratio = float(
                np.mean(np.asarray(db[f"{component}_reff_b"], np.float64))
                / np.mean(np.asarray(db[f"{component}_reff"], np.float64))
            )
        if angle is None and f"{component}_angle" in db.colnames:
            angle = float(
                np.mean(np.asarray(db[f"{component}_angle"], np.float64))
            )
            if _component_angle_degrees(model, component):
                angle = np.deg2rad(angle)
    else:
        iy, ix = np.unravel_index(
            np.argmax(np.where(good, conv, -np.inf)), conv.shape
        )
        center = np.array([ix, iy], np.float64)

    prof_kw = dict(
        good=good, bin_px=bin_px, rmax=rmax,
        axis_ratio=1.0 if axis_ratio is None else float(axis_ratio),
        angle=0.0 if angle is None else float(angle),
    )
    r, d_mean, d_err, _ = radial_profile(
        obs, center, variance=var, **prof_kw
    )
    _, m_mean, _, _ = radial_profile(conv, center, **prof_kw)
    ps_mean = None
    if "point_source_subtracted" in imgs and not np.allclose(
        np.asarray(imgs["point_source_subtracted"]), obs
    ):
        _, ps_mean, _, _ = radial_profile(
            np.asarray(imgs["point_source_subtracted"], np.float64),
            center, **prof_kw,
        )

    # mag/arcsec^2 when the header has a celestial WCS; linear otherwise
    zp = float(model.spec.mag_zeropoint)
    px_area = None
    if model.obs_header is not None:
        try:
            wcs = MiniWCS(model.obs_header)
            px_area = proj_plane_pixel_area(wcs) * 3600.0**2
        except (KeyError, ValueError):
            px_area = None

    def to_mu(f):
        with np.errstate(divide="ignore", invalid="ignore"):
            return zp - 2.5 * np.log10(np.where(f > 0, f, np.nan)
                                       / px_area)

    fig, (ax, axr) = pp.subplots(
        2, 1, sharex=True, figsize=(6.4, 6.4),
        gridspec_kw={"height_ratios": [3, 1], "hspace": 0.05},
    )
    if px_area is not None:
        ax.errorbar(r, to_mu(d_mean),
                    yerr=2.5 / np.log(10) * d_err / np.abs(d_mean),
                    fmt="o", ms=3, color="k", label="data")
        ax.plot(r, to_mu(m_mean), color="C3", lw=2, label="model")
        if ps_mean is not None:
            ax.plot(r, to_mu(ps_mean), "s", ms=3, color="C0", mfc="none",
                    label="data - point source")
        ax.invert_yaxis()
        ax.set_ylabel(r"$\mu$ (mag arcsec$^{-2}$)")
    else:
        ax.errorbar(r, d_mean, yerr=d_err, fmt="o", ms=3, color="k",
                    label="data")
        ax.plot(r, m_mean, color="C3", lw=2, label="model")
        if ps_mean is not None:
            ax.plot(r, ps_mean, "s", ms=3, color="C0", mfc="none",
                    label="data - point source")
        ax.set_yscale("symlog", linthresh=max(np.nanmin(d_err), 1e-12))
        ax.set_ylabel("surface brightness (image units)")
    ax.legend(frameon=False)
    fig.suptitle(disp_name)

    with np.errstate(invalid="ignore"):
        axr.axhline(0.0, color="0.6", lw=1)
        axr.plot(r, (d_mean - m_mean) / d_err, "o", ms=3, color="k")
    axr.set_ylabel(r"resid ($\sigma$)")
    axr.set_xlabel(f"radius from ({center[0]:.1f}, {center[1]:.1f}) (pix)")

    _show_or_save(fig, save, f"{disp_name}_profile.pdf")
    return r, d_mean, m_mean, d_err


def _show_or_save(fig, save, filename):
    import matplotlib.pyplot as pp

    if save:
        fig.savefig(filename)
    else:  # pragma: no cover - interactive
        pp.show()
    pp.close(fig)
