"""Posterior model image writer (port of ``analysis/images.py``).

Writes the five image types as FITS files, in two modes:

* ``weighted`` (default): the per-pixel posterior mean over the retained
  samples.  Running means the model adopted from the sampler are reused
  when they cover the (stuck-walker-filtered) database; otherwise every
  row is replayed through ``ensemble_carry_means`` in chunks;
* ``maximum`` / ``MAP``: the single highest-probability sample.

Headers carry the observation's header, the sampler metadata, each
parameter's posterior mean +/- std under its FITS abbreviation, the
reduced chi-squared of the MAP model (``MCCHI2NU``; the reduced Poisson
deviance under the Poisson likelihood), the posterior-predictive
p-value (``MCPPCP``), the file name of the MAP sample's PSF
(``PSFIMG``, from its ``PSF_Index`` when the model has several) and,
given ``criticism_draws``, the criticism block (``MCLOOELP``,
``MCLOOSE``, ``MCLOOPEF``, ``MCLOOKBD``, ``MCPITKS``, ``MCPITP``,
``MCPSFLAG``; :func:`~psfmc_tpu_torch.analysis.model_comparison.
criticism_header_stats`).

Unlike the JAX writer, no exception is swallowed: a failing render (a
kernel launch) must not pass as a missing header card.  The data
conditions under which the JAX writer ends up without a card are tested
for explicitly, each with a warning: no sampled rows (no ``MCCHI2NU``,
no ``MCPPCP``), a trace that the posterior-predictive check's
stuck-walker filter leaves empty (no ``MCPPCP``), and a trace with too
few usable draws for the criticism replay (no criticism block).
"""
from __future__ import annotations

from collections import OrderedDict
from warnings import warn

import numpy as np

from ..database import annotate_metadata, filter_lowp_walkers, row_to_param_vector
from ..io import fits
from ..models.multicomponent import IMAGE_TYPES, poisson_deviance
from ..parallel.multihost import barrier, is_primary
from ..profiling import span

__all__ = ["save_posterior_images", "write_image_products", "default_filetypes"]

default_filetypes = (
    "raw_model",
    "convolved_model",
    "composite_ivm",
    "residual",
    "point_source_subtracted",
)

_KNOWN_TYPES = set(IMAGE_TYPES) | {"raw_model_std"}
_REPLAY_CHUNK = 2048  # rows per on-device batched mean


def save_posterior_images(model, database, output_name="out_{}",
                          mode="weighted", filetypes=default_filetypes,
                          bad_px_value=0, walker_min_percentile=10,
                          ppc_draws=100, criticism_draws=0):
    """Write posterior model images as FITS files.

    :param model: the :class:`~psfmc_tpu_torch.models.multicomponent.
        MultiComponentModel` that was fitted.
    :param database: trace table (from ``save_database``/``load_database``).
    :param output_name: base output name; '{}' is replaced per filetype.
    :param mode: 'weighted' (posterior mean) or 'maximum'/'MAP'.
    :param bad_px_value: replacement value for non-finite pixels.
    :param walker_min_percentile: stuck-walker filter threshold.
    :param ppc_draws: posterior draws for the MCPPCP card; 0 disables it.
    :param criticism_draws: posterior draws replayed for the criticism
        block (PSIS-LOO, LOO-PIT, prior power-scaling); 0 disables it.

    Spans: ``psfmc.images.filter``, ``.stats`` (the MAP render and the
    predictive check's draws), ``.criticism``, ``.replay`` (the chain
    replayed where the filter dropped walkers) and ``.write``.
    """
    header = model.obs_header.copy() if model.obs_header else fits.Header()
    if "{}" not in output_name:
        output_name += "_{}"
    with span("psfmc.images.filter"):
        database = filter_lowp_walkers(database, percentile=walker_min_percentile)
    with span("psfmc.images.stats"):
        _add_stats_to_header(header, model, database, ppc_draws=ppc_draws)
    if criticism_draws:
        from .model_comparison import criticism_cards_or_warn

        with span("psfmc.images.criticism"):
            for key, (value, comment) in criticism_cards_or_warn(
                    model, database, criticism_draws).items():
                header.set(key, value, comment)

    if is_primary():
        print("Saving posterior models")
    unknown = set(filetypes) - _KNOWN_TYPES
    if unknown:
        warn(f"Unknown filetypes requested: {unknown} Output images will "
             "not be generated for these types.")
        filetypes = [f for f in filetypes if f not in unknown]

    stochastic_cols = list(model.param_names)
    output_data = {}
    if mode in ("maximum", "MAP"):
        best = int(np.argmax(database["lnprobability"]))
        theta = row_to_param_vector(database[stochastic_cols][best])
        imgs = model.render_images_batch(theta[None, :])
        for ftype in filetypes:
            if ftype not in imgs:
                warn(f"{ftype} is not defined in MAP mode; skipping")
                continue
            output_data[ftype] = imgs[ftype][0]
    elif mode == "weighted":
        if len(database) != model.accumulated_samples:
            with span("psfmc.images.replay"):
                thetas = np.stack([row_to_param_vector(r)
                                   for r in database[stochastic_cols]])
                model.reset_images()
                model.replay_posterior_means(thetas, chunk=_REPLAY_CHUNK)
        for ftype in filetypes:
            if ftype not in model.posterior_images:
                warn(f"{ftype} was not accumulated for this run; skipping")
                continue
            output_data[ftype] = model.posterior_images[ftype]
    else:
        warn(f"Unknown posterior output mode ({mode}). Posterior model "
             "images will not be saved.")
        return
    with span("psfmc.images.write"):
        write_image_products(output_name, output_data, header, filetypes,
                             bad_px_value)


def write_image_products(output_name, images, header,
                         filetypes=default_filetypes, bad_px_value=0):
    """Write a dict of (H, W) images as the standard FITS products:
    non-finite pixels replaced, float32, an OBJECT card per type.  In a
    multi-process run the primary process writes them, and every process
    waits for it."""
    if not is_primary():
        barrier("write_image_products")
        return
    if "{}" not in output_name:
        output_name += "_{}"
    known = [f for f in filetypes if f in images]
    unknown = set(filetypes) - set(known)
    if unknown:
        warn(f"Unknown filetypes requested: {unknown} Output images will "
             "not be generated for these types.")
    for ftype in known:
        data = np.array(images[ftype], dtype=np.float64)
        data[~np.isfinite(data)] = bad_px_value
        header.set("OBJECT", ftype)
        fits.writeto(output_name.format(ftype) + ".fits",
                     data.astype(np.float32), header=header, overwrite=True)
    barrier("write_image_products")


def _add_stats_to_header(header, model, database, ppc_draws=100):
    """Sampler metadata + per-parameter posterior stats into the header."""
    header.extend(_fits_section_header("psfMC MCMC SAMPLER PARAMETERS"))
    for key, value in annotate_metadata(database.meta).items():
        header.set(key, value[0], value[1])

    header.extend(_fits_section_header("psfMC POSTERIOR MODEL INFORMATION"))
    model_stats = OrderedDict()
    for col_name, fits_abbr in zip(model.param_names, model.param_fits_abbrs):
        col = np.asarray(database[col_name], dtype=np.float64)
        mean_post = np.mean(col, axis=0)
        std_post = np.std(col, axis=0)
        if np.ndim(mean_post) == 0:
            val = f"{mean_post:0.4g} +/- {std_post:0.4g}"
        else:
            strmean = ",".join(f"{dim:0.4g}" for dim in mean_post)
            strstd = ",".join(f"{dim:0.4g}" for dim in std_post)
            val = f"({strmean}) +/- ({strstd})"
        model_stats[fits_abbr] = val

    # The two model stats need sampled rows (no exception is swallowed:
    # see the module's docstring)
    if len(database) == 0 or "lnprobability" not in database.colnames:
        warn("no sampled rows with lnprobability: MCCHI2NU and MCPPCP not computed")
    else:
        # goodness of fit of the MAP sample over good pixels
        best = int(np.argmax(np.asarray(database["lnprobability"])))
        theta_map = row_to_param_vector(database[list(model.param_names)][best])
        imgs = model.render_images_batch(theta_map[None, :])
        good = np.asarray(~model.spec.bad_px)
        dof = max(int(good.sum()) - model.num_params, 1)
        if model.spec.likelihood == "poisson":
            # the IVM is only a mask under this likelihood: a chi^2
            # against it would mean nothing
            g = float(model.spec.likelihood_gain)
            mu = np.maximum(imgs["convolved_model"][0], 0.0) * g
            obs = np.asarray(model.spec.obs_data, np.float64) * g
            dev = float(poisson_deviance(obs, mu, good))
            model_stats["MCCHI2NU"] = (round(dev / dof, 4),
                                       "reduced Poisson deviance of the MAP model")
        else:
            resid = imgs["residual"][0]
            ivm = imgs["composite_ivm"][0]
            chi2 = float(np.sum((resid * resid * ivm)[good]))
            model_stats["MCCHI2NU"] = (round(chi2 / dof, 4),
                                       "reduced chi-squared of the MAP model")
        if ppc_draws and len(filter_lowp_walkers(database, percentile=10)) == 0:
            # every row at one lnprobability (stuck chains): the check's
            # own stuck-walker filter leaves nothing to draw from
            warn("no trace rows left after the posterior-predictive check's "
                 "stuck-walker filter: MCPPCP not computed")
        elif ppc_draws:
            p = model.posterior_predictive_pvalue(database, n=ppc_draws,
                                                  random_state=0)
            model_stats["MCPPCP"] = (round(p, 4),
                                     "posterior-predictive p-value (deviance)")

    # the PSF of the maximum-posterior sample
    selector = model.config.psf_selector
    if len(selector.spatial_psfs) > 1 and "PSF_Index" in database.colnames \
            and len(database) > 0:
        best = int(np.argmax(np.asarray(database["lnprobability"])))
        selector.set_index(database["PSF_Index"][best])
    model_stats["PSFIMG"] = selector.filename
    for key, value in annotate_metadata(model_stats).items():
        header.set(key, value[0], value[1])


def _fits_section_header(section_name):
    """Drizzle-style blank/comment/blank section separator cards."""
    return [("", "", ""), ("", "/ " + section_name, ""), ("", "", "")]
