"""Top-level MCMC fitting driver (port of ``fitting.py::model_galaxy_mcmc``).

The JAX package's fitting driver on the port: a model file (or component list,
or prepared model) -> walkers drawn from the priors -> burn-in with
stuck-walker rejuvenation -> retained sampling with the convergence
retry loop -> the FITS trace database with its resume checkpoint after
every segment -> the five posterior image products.  An existing
database resumes from its checkpoint, or is skipped when it already
holds the requested iterations.

Deliberate divergences from the JAX driver:

* the resume guards (walker count, data fingerprint ``MCDATSUM``, model
  parameters) also run when the database already holds enough
  iterations: a database sampled against other data or another model is
  re-sampled instead of being turned into images of the current model
  (the JAX driver skips them there);
* a checkpoint whose generator the port cannot restore (one written by
  the JAX package, or by the port on another device type) warns and
  re-runs from scratch, like the other guards;
* the driver runs on CUDA unless ``device="cpu"`` is given.

This slice runs ``sampler="ensemble"`` with any ``ntemps`` (parallel
tempering above 1, :class:`~psfmc_tpu_torch.sampler.tempered.
PTEnsembleSampler`, whose evidence goes into the ``MCLNZ`` / ``MCLNZERR``
cards from 3 rungs up) and any ``moves`` (``"stretch"``, ``"de"`` or
``"mixed"``), and ``sampler="nuts"`` (:class:`~psfmc_tpu_torch.sampler.
nuts.NUTSSampler`, ``max_depth`` its tree depth; ``ntemps`` and ``moves``
warn and are ignored; 8 chains by default, from the best of a pool of
``max(32 * chains, 256)`` starts), ``init="prior"`` or ``init="map"`` (a
gradient MAP fit of a pool of prior draws, then a z-space cloud around
it), ``criticism`` (the criticism block of every image product's header
from 500 replayed draws: PSIS-LOO, LOO-PIT and prior power-scaling) and
``mesh`` (:func:`~psfmc_tpu_torch.parallel.walker_mesh`: every sampler's
posterior evaluations split over one process a device, the state held by
every process, files and console lines from the primary process alone;
:mod:`psfmc_tpu_torch.parallel.mesh`).  On CUDA
every sampler step (for NUTS every piece of a step) and every Adam step
is a replay of a captured CUDA graph (:class:`~psfmc_tpu_torch.sampler.
ensemble.EnsembleSampler`, :func:`~psfmc_tpu_torch.optimize.fit_map`).

:func:`model_galaxy_map` is the quick-look MAP fit: the five image
products of the mode, with each parameter's value (and Laplace standard
error) in the headers.  :func:`model_galaxy_evidence` is the marginal
likelihood of a model file by annealed importance sampling
(:func:`~psfmc_tpu_torch.sampler.ais.ais_evidence`), for Bayes factors
between two model files of the same data.
"""
from __future__ import annotations

import contextlib
import os
import zlib
from collections import OrderedDict
from types import SimpleNamespace
from warnings import warn

import numpy as np
import torch

from .analysis.images import default_filetypes, save_posterior_images
from .analysis.statistics import check_convergence_autocorr
from .database import (
    load_checkpoint,
    load_database,
    row_to_param_vector,
    save_database,
)
from .models.multicomponent import as_model
from .parallel.mesh import check_mesh, walker_sharding
from .parallel.multihost import is_primary
from .profiling import PhaseTimer, span, traced
from .sampler.ensemble import EnsembleSampler
from .sampler.nuts import NUTSSampler
from .sampler.tempered import PTEnsembleSampler
from .utils import print_progress

__all__ = ["model_galaxy_mcmc", "model_galaxy_map", "model_galaxy_evidence"]

CRITICISM_DRAWS = 500  # draws the criticism block replays (criticism=True)


def _print(*args, **kwargs):
    """Console output from the primary process only (multi-process runs)."""
    if is_primary():
        print(*args, **kwargs)


@contextlib.contextmanager
def _phase(name, device, timings):
    """Time a phase on the host clock into ``timings[name]``
    (:class:`~psfmc_tpu_torch.profiling.PhaseTimer`), ending in a device
    synchronize, under a ``torch.profiler`` range of that name."""
    with PhaseTimer(phases=timings).phase(name, sync_result=device), \
            torch.profiler.record_function(name):
        yield


def _data_fingerprint(mc_model):
    """crc32 over the observation data + variance of every band:
    identifies the data a trace database was sampled against."""
    spec = mc_model.spec
    h = 0
    for s in getattr(spec, "band_specs", None) or [spec]:
        for arr in (s.obs_data, s.obs_var):
            h = zlib.crc32(np.ascontiguousarray(arr).tobytes(), h)
    return int(h)


def _resume_refusal(database, ckpt, sampler, mc_model, restoring):
    """Why the existing database cannot stand for this run, or None.

    The walker-count, data and model guards always apply; the
    checkpoint, sampler-family and generator guards only when the
    sampler is to be restored from the checkpoint (``restoring``).
    """
    db_chains = int(database.meta.get("MCCHAINS", sampler.nwalkers))
    datsum = database.meta.get("MCDATSUM")
    if restoring and ckpt is None:
        return "Existing database has no checkpoint"
    if db_chains != sampler.nwalkers:
        return (f"Existing database was sampled with {db_chains} walkers but "
                f"chains={sampler.nwalkers} was requested")
    if datsum is not None and int(datsum) != _data_fingerprint(mc_model):
        return ("Existing database was sampled against different observation "
                "data (MCDATSUM mismatch — obs/ivm files changed?)")
    n_match = sum(n in database.colnames for n in mc_model.param_names)
    ckpt_dim = (None if ckpt is None
                else int(np.asarray(ckpt["positions"]).shape[-1]))
    if n_match != len(mc_model.param_names) or (
            ckpt_dim is not None and ckpt_dim != mc_model.num_params):
        return (f"Existing database was written for another model "
                f"({n_match}/{len(mc_model.param_names)} trace columns match, "
                f"checkpoint dimension {ckpt_dim}, model dimension "
                f"{mc_model.num_params}) — the model changed")
    if not restoring:
        return None
    if ckpt["sampler_kind"] != sampler.checkpoint_kind:
        return (f"Existing checkpoint was written by the "
                f"{ckpt['sampler_kind']!r} sampler but "
                f"sampler={sampler.checkpoint_kind!r} was requested")
    if ckpt["rng_kind"] != sampler.rng_kind:
        return (f"Existing checkpoint holds a {ckpt['rng_kind']!r} generator "
                f"state, which a {sampler.rng_kind!r} sampler cannot restore")
    return None


@traced("fit")
def model_galaxy_mcmc(
    model_file,
    output_name=None,
    write_fits=default_filetypes,
    iterations=0,
    burn=0,
    chains=None,
    max_iterations=1,
    convergence_check=check_convergence_autocorr,
    seed=0,
    mesh=None,
    ntemps=1,
    betas=None,
    checkpoint_interval=None,
    sampler="ensemble",
    init="prior",
    moves="stretch",
    max_depth=8,
    criticism=False,
    rejuvenate=True,
    device=None,
):
    """Model the surface brightness of a galaxy or galaxies with
    multi-component MCMC parameter estimation.

    :param model_file: model definition file name, component list or
        prepared :class:`~psfmc_tpu_torch.models.multicomponent.
        MultiComponentModel` or :class:`~psfmc_tpu_torch.models.joint.
        JointModel`; a file or list with several ``Configuration``
        components is a joint multi-band model (one band per
        ``Configuration``), whose products are written per band as
        ``<output>_b{i}_<type>.fits``.
    :param output_name: base name of the output files (default
        ``out_<model file name>``).
    :param write_fits: image types to write.
    :param iterations: retained samples per round.
    :param burn: discarded burn-in samples.
    :param chains: walkers (default ``2 * num_params + 2``; rounded up to
        an even count), or NUTS's independent chains (default 8; any
        count).
    :param max_iterations: sampling rounds before convergence is enforced.
    :param convergence_check: function of the sampler returning bool.
    :param seed: seed of the walkers' prior draws and the sampler.
    :param checkpoint_interval: steps between progress lines and
        checkpoints (default: about a tenth of a phase longer than 50
        steps, at least 25; 0 disables segmenting).
    :param ntemps: parallel-tempering rungs (1: the plain ensemble
        sampler); from 3 rungs the database carries the evidence
        (``MCLNZ``, ``MCLNZERR``).
    :param betas: the tempering ladder (pins it; by default it is sized
        during burn-in and frozen for the retained phase).
    :param moves: proposal family of the ensemble sampler:
        ``"stretch"``, ``"de"`` (differential evolution) or ``"mixed"``.
    :param sampler: ``"ensemble"`` or ``"nuts"`` (the No-U-Turn sampler
        over the posterior's gradient; ``max_depth`` caps its tree at
        ``2^max_depth - 1`` leapfrogs a step; its burn-in is the warmup).
    :param criticism: replay 500 thinned draws of the final chain for
        the criticism block of every image product's header (PSIS-LOO
        elpd / SE / p_eff and its Pareto-k census, the LOO-PIT KS test,
        the count of prior power-scaling flags: the ``MCLOO*`` /
        ``MCPIT*`` / ``MCPSFLAG`` cards), for every sampler; a joint
        model's block covers every band's pixels.
    :param rejuvenate: move stranded walkers onto healthy ones between
        burn segments.
    :param mesh: optional :func:`~psfmc_tpu_torch.parallel.walker_mesh`:
        each posterior evaluation's walkers (NUTS's chains) are split over
        its processes, the sampler state held by every process; the
        database, checkpoints, images and console lines come from the
        primary process, with a barrier after each write.  ``chains`` is
        kept as given (a half-ensemble of 125 splits 62 + 63 over 2).
    :param device: the posterior's device, CUDA unless ``"cpu"`` (the
        mesh's device by default when a mesh is given).
    :returns: the trace table as ``load_database`` reads it; its
        ``phase_seconds`` attribute holds the host-clock seconds of each
        phase of this call (init, burn, sampling, images), each ending
        in a device synchronize.

    With ``PSFMC_TRACE_DIR`` set, the call writes one ``torch.profiler``
    trace of the whole fit, ``<dir>/fit/rank<r>.pt.trace.json``
    (:func:`~psfmc_tpu_torch.profiling.trace`), its spans under
    ``psfmc.fit``.
    The likelihood
    path follows ``PSFMC_LNPOST`` and the model (``pallas`` runs the
    fused kernel; unset, a model the conv+likelihood kernel covers runs
    it and any other the general path; each band of a joint model takes
    the batched or the general path by the same rule, whatever
    ``PSFMC_LNPOST`` says), or the ``lnpost`` of a prepared model.
    """
    if init not in ("prior", "map"):
        raise ValueError(f"Unknown init {init!r}: expected 'prior' or 'map'")
    if moves not in ("stretch", "de", "mixed"):
        raise ValueError(
            f"Unknown moves {moves!r}: expected 'stretch', 'de' or 'mixed'")
    if sampler not in ("ensemble", "nuts"):
        raise ValueError(
            f"Unknown sampler {sampler!r}: expected 'ensemble' or 'nuts'")
    sharding = None if check_mesh(mesh) is None else walker_sharding(mesh)
    if mesh is not None and device is None:
        device = mesh.device

    if output_name is None:
        name = model_file if isinstance(model_file, str) else "model"
        output_name = "out_" + os.path.basename(name).replace(".py", "")
    output_name += "_{}"
    timings = OrderedDict()
    criticism_draws = CRITICISM_DRAWS if criticism else 0

    with span("psfmc.model"):
        mc_model = as_model(model_file, device=device)
        fns = mc_model.posterior_fns
        nuts = sampler == "nuts"
        if chains is None:
            # NUTS's chains are independent: a handful suffices
            chains = 8 if nuts else 2 * mc_model.num_params + 2
        if not nuts and chains % 2:
            chains += 1  # half-ensemble moves need an even walker count
        if nuts:
            if ntemps > 1:
                warn("ntemps is ignored with sampler='nuts'")
            if moves != "stretch":
                warn("moves= is ignored with sampler='nuts'")
            ens = NUTSSampler(chains, mc_model.num_params, fns, seed=seed,
                              max_depth=max_depth, device=fns.device, sharding=sharding)
        elif ntemps > 1:
            ens = PTEnsembleSampler(chains, mc_model.num_params, fns, ntemps=ntemps,
                                    betas=betas, seed=seed, device=fns.device,
                                    moves=moves, sharding=sharding)
        else:
            ens = EnsembleSampler(chains, mc_model.num_params, fns, seed=seed,
                                  device=fns.device, moves=moves, sharding=sharding)
    db_name = output_name.format("db") + ".fits"
    common = dict(max_iterations=max_iterations,
                  convergence_check=convergence_check, db_name=db_name,
                  checkpoint_interval=checkpoint_interval,
                  rejuvenate=rejuvenate, seed=seed, timings=timings)

    database = None
    if os.path.exists(db_name):
        with span("psfmc.resume"):
            database = load_database(db_name)
            existing_iter = int(database.meta.get("MCITER", 0))
            ckpt = load_checkpoint(db_name)
            skip = existing_iter >= iterations and iterations > 0
            refusal = _resume_refusal(database, ckpt, ens, mc_model,
                                      restoring=not skip)
        if refusal is not None:
            warn(f"{refusal}; re-running sampling from scratch")
            database = None
        elif skip:
            _print("Database already contains sampled chains, skipping sampling")
        else:
            burn_total = max(burn, int(database.meta.get("MCBURN", 0)))
            burn_done = int(database.meta.get("MCBURNDN", burn_total))
            _print(f"Resuming from checkpoint: {burn_done}/{burn_total} "
                   f"burn-in + {existing_iter} retained iterations done")
            database = _run_sampling(
                ens, mc_model, None, burn=max(0, burn_total - burn_done),
                iterations=iterations - existing_iter, burn_total=burn_total,
                burn_done=burn_done, resume_payload=ckpt,
                prior_db=database if existing_iter > 0 else None, **common)

    if database is None:
        rng = np.random.RandomState(seed)
        # NUTS's chains start from the best of a larger pool
        # (NUTSSampler.init_state); the ensemble takes one row per walker
        n_init = max(32 * chains, 256) if nuts else chains
        if init == "map":
            from .optimize import fit_map, scatter_around

            with _phase("map", fns.device, timings):
                with span("psfmc.prior_draws"):
                    pool = mc_model.init_params_from_priors(max(n_init, 256),
                                                            random_state=rng)
                map_res = fit_map(fns, p0=pool, seed=seed)
                _print(f"MAP fit: lnpost = {map_res.lnpost:.2f}")
                p0 = scatter_around(fns, map_res.theta, n_init, seed=seed)
        else:
            with span("psfmc.prior_draws"):
                p0 = mc_model.init_params_from_priors(n_init, random_state=rng)
        database = _run_sampling(ens, mc_model, p0, burn=burn,
                                 iterations=iterations, burn_total=burn,
                                 **common)

    with _phase("images", fns.device, timings):
        if hasattr(mc_model.spec, "band_specs"):
            _save_joint_images(mc_model, ens, db_name, database,
                               output_name[:-len("_{}")], write_fits,
                               criticism_draws)
        else:
            save_posterior_images(mc_model, database, output_name=output_name,
                                  filetypes=write_fits,
                                  criticism_draws=criticism_draws)
    database.phase_seconds = timings
    return database


def model_galaxy_map(model_file, output_name=None, write_fits=default_filetypes,
                     n_starts=64, steps=500, seed=0, laplace=True, device=None):
    """Quick-look gradient MAP fit: best-fit model images in seconds.

    A multi-start Adam ascent of the log-posterior
    (:func:`~psfmc_tpu_torch.optimize.fit_map`, from the best of
    ``max(4 n_starts, 128)`` prior draws) followed by the five FITS image
    products of a full MCMC run, rendered at the mode, with ``MAPLNP``
    and each parameter's value (``+/-`` its Laplace standard error when
    ``laplace``) under its FITS abbreviation in the headers.  No trace
    database is written.

    :param device: the posterior's device, CUDA unless ``"cpu"``.
    :returns: the :class:`~psfmc_tpu_torch.optimize.MAPResult`; its
        ``phase_seconds`` attribute holds the host-clock seconds of each
        phase (pool, fit, laplace, images), each ending in a device
        synchronize.
    """
    from .analysis.images import _fits_section_header, write_image_products
    from .database import annotate_metadata
    from .io import fits
    from .optimize import fit_map, laplace_covariance

    if output_name is None:
        name = model_file if isinstance(model_file, str) else "model"
        output_name = "out_" + os.path.basename(name).replace(".py", "")
    if "{}" not in output_name:
        output_name += "_{}"

    mc_model = as_model(model_file, device=device)
    fns = mc_model.posterior_fns
    if hasattr(fns, "band_fns"):
        raise NotImplementedError(
            "model_galaxy_map's quick-look image products are single-band; "
            "for joint models run psfmc_tpu_torch.fit_map on "
            "model.posterior_fns directly and render per band with "
            "posterior_fns.render_images")
    timings = OrderedDict()
    with _phase("pool", fns.device, timings):
        rng = np.random.RandomState(seed)
        pool = mc_model.init_params_from_priors(max(4 * n_starts, 128),
                                                random_state=rng)
    with _phase("fit", fns.device, timings):
        res = fit_map(fns, n_starts=n_starts, steps=steps, seed=seed, p0=pool)
    if laplace:
        with _phase("laplace", fns.device, timings):
            res.cov, res.theta_std = laplace_covariance(fns, res.theta)
    _print(f"MAP fit: lnpost = {res.lnpost:.2f}")

    with _phase("images", fns.device, timings):
        header = (mc_model.obs_header.copy() if mc_model.obs_header
                  else fits.Header())
        header.extend(_fits_section_header("psfMC MAP FIT PARAMETERS"))
        stats = OrderedDict()
        stats["MAPLNP"] = float(res.lnpost)
        pos = 0
        for ln, abbr in zip(mc_model.param_lens, mc_model.param_fits_abbrs):
            val = res.theta[pos:pos + ln]
            std = (res.theta_std[pos:pos + ln] if res.theta_std is not None
                   else np.full(ln, np.nan))
            if ln == 1:
                text = f"{val[0]:0.4g}"
                if np.isfinite(std[0]):
                    text += f" +/- {std[0]:0.4g}"
            else:
                text = "(" + ",".join(f"{v:0.4g}" for v in val) + ")"
                if np.all(np.isfinite(std)):
                    text += " +/- (" + ",".join(f"{v:0.4g}" for v in std) + ")"
            stats[abbr] = text
            pos += ln
        for key, value in annotate_metadata(stats).items():
            header.set(key, value[0], value[1])
        imgs = mc_model.render_images_batch(res.theta[None, :])
        _print("Saving MAP models")
        write_image_products(output_name, {k: v[0] for k, v in imgs.items()},
                             header, write_fits)
    res.phase_seconds = timings
    return res


def model_galaxy_evidence(model_file, nwalkers=512, nsteps=3000, groups=4,
                          sweeps=2, seed=0, mesh=None, moves="mixed", device=None,
                          **ais_kwargs):
    """Marginal likelihood of a model file (Bayesian model comparison).

    Builds the model and runs the SMC/AIS evidence estimator
    (:func:`~psfmc_tpu_torch.sampler.ais.ais_evidence`) from
    ``nwalkers`` draws of its priors.  Two model files of the same data
    compare by their log Bayes factor::

        r1 = model_galaxy_evidence('model_ps_only.py')
        r2 = model_galaxy_evidence('model_ps_host.py')
        ln_bayes = r2.lnz - r1.lnz   # > 0 favors the host model

    :param model_file: model definition file name, component list or
        prepared model (as for :func:`model_galaxy_mcmc`).
    :param nwalkers: total walkers; walkers per group (``nwalkers //
        groups``) must be enough to find the posterior's modes from prior
        draws: keep 64 or more for imaging models.
    :param nsteps: annealing steps (many more than std(lnL), about
        ``sqrt(n_good_pixels / 2)``).
    :param mesh: optional :func:`~psfmc_tpu_torch.parallel.walker_mesh`;
        the group axis is split over it (``groups`` a multiple of its
        size).
    :param device: the posterior's device, CUDA unless ``"cpu"`` (the
        mesh's device by default when a mesh is given).
    :returns: :class:`~psfmc_tpu_torch.sampler.ais.AISResult`.
    """
    from .sampler.ais import ais_evidence

    if check_mesh(mesh) is not None and device is None:
        device = mesh.device
    mc_model = as_model(model_file, device=device)
    rng = np.random.RandomState(seed)
    p0 = mc_model.init_params_from_priors(nwalkers, random_state=rng)
    return ais_evidence(mc_model.posterior_fns, nwalkers=nwalkers, nsteps=nsteps,
                        groups=groups, sweeps=sweeps, seed=seed, p0=p0,
                        moves=moves, mesh=mesh, **ais_kwargs)


def _save_joint_images(mc_model, sampler, db_name, database, output_name,
                       filetypes, criticism_draws=0):
    """A joint model's products, one set of the five image types per band,
    from the sampler's per-band accumulators; when sampling was skipped
    (the database was complete), from the checkpoint's accumulators."""
    accum_src = sampler
    if sampler.accumulated_samples == 0:
        ckpt = load_checkpoint(db_name)
        if ckpt is not None and ckpt.get("accum") and int(ckpt["accum_count"]) > 0:
            accum_src = SimpleNamespace(accumulated_images=ckpt["accum"],
                                        accumulated_samples=int(ckpt["accum_count"]))
    if accum_src.accumulated_samples > 0:
        mc_model.save_posterior_images(accum_src, output_name, database=database,
                                       filetypes=filetypes,
                                       criticism_draws=criticism_draws)
    else:
        warn("no accumulated images available for the joint model (no "
             "retained sampling ran and the checkpoint has no accumulators); "
             "skipping image products")


def _auto_segment(nsteps, checkpoint_interval):
    """Segment length of a phase (None = one segment): about a tenth of
    a phase longer than 50 steps, at least 25 steps."""
    if checkpoint_interval is not None:
        return None if checkpoint_interval <= 0 else int(checkpoint_interval)
    if nsteps <= 50:
        return None
    return max(25, min(2500, nsteps // 10))


def _run_sampling(sampler, mc_model, initial_positions, burn, iterations,
                  max_iterations, convergence_check, db_name, burn_total,
                  burn_done=0, resume_payload=None, prior_db=None,
                  checkpoint_interval=None, rejuvenate=True, seed=0,
                  timings=None):
    """Burn + retained sampling with convergence retries; saves the
    database (with its checkpoint) after every segment and round."""
    device = sampler.device
    timings = OrderedDict() if timings is None else timings
    with _phase("init", device, timings):
        if resume_payload is not None:
            sampler.restore_state(resume_payload)
        else:
            sampler.init_state(initial_positions)

    def checkpoint_meta(converged=False):
        niter = 0 if sampler.chain is None else sampler.chain.shape[1]
        burn_dn = (min(burn_done + sampler._nsteps_total, burn_total)
                   if niter == 0 else burn_total)
        meta = OrderedDict([
            ("MCITER", niter),
            ("MCBURN", burn_total),
            ("MCBURNDN", burn_dn),
            ("MCCHAINS", sampler.nwalkers),
            ("MCCONVRG", bool(converged)),
            ("MCACCEPT", float(sampler.acceptance_fraction.mean())),
            ("MCDATSUM", _data_fingerprint(mc_model)),
        ])
        if niter > 0 and getattr(sampler, "ntemps", 1) >= 3:
            # a tempered run's marginal-likelihood estimate
            try:
                lnz, dlnz = sampler.log_evidence()
            except (RuntimeError, ValueError):
                pass
            else:
                meta["MCLNZ"] = float(lnz)
                meta["MCLNZERR"] = float(dlnz)
        return meta

    def checkpoint(converged=False):
        with span("psfmc.checkpoint"):
            return save_database(sampler, mc_model, db_name,
                                 meta_dict=checkpoint_meta(converged))

    if burn > 0:
        _print(f"Burning: {burn} iterations x {sampler.nwalkers} walkers")
        rejuv_rng = np.random.RandomState(np.uint32(seed) ^ 0x5EED)

        def burn_cb(done, total):
            if rejuvenate and done < total and hasattr(sampler, "rejuvenate_stuck"):
                # NUTS's chains are independent and never teleported
                with span("psfmc.rejuvenate"):
                    n_fix = sampler.rejuvenate_stuck(random_state=rejuv_rng)
                if n_fix:
                    _print(f"  rejuvenated {n_fix} stuck walkers")
            print_progress(burn_done + done - 1, burn_total, "Burning")
            if done < total:  # the final state is saved by save_round
                checkpoint()

        with _phase("burn", device, timings):
            sampler.run_burn(burn, segment=_auto_segment(burn, checkpoint_interval),
                             callback=burn_cb)

    if resume_payload is None or burn > 0 or prior_db is None:
        # a fresh retained phase; a mid-sampling resume keeps the restored
        # accumulators and counts streaming
        sampler.reset()

    if prior_db is not None:
        # the saved database holds the whole concatenated run
        cols = prior_db[list(mc_model.param_names)]
        flat = np.stack([row_to_param_vector(r) for r in cols])
        niter = len(prior_db) // sampler.nwalkers
        sampler._chain = flat.reshape(sampler.nwalkers, niter, mc_model.num_params)
        sampler._lnprob = np.asarray(prior_db["lnprobability"],
                                     np.float64).reshape(sampler.nwalkers, niter)
        sampler._nsteps_total = niter

    def sample_cb(done, total):
        print_progress(done - 1, total, "Sampling")
        if done < total:
            checkpoint()

    database = None
    for sampling_iter in range(max_iterations):
        _print(f"Sampling: {iterations} iterations x {sampler.nwalkers} walkers")
        with _phase("sampling", device, timings):
            sampler.run_sampling(
                iterations, segment=_auto_segment(iterations, checkpoint_interval),
                callback=sample_cb)
        with span("psfmc.convergence"):
            converged = bool(convergence_check(sampler))
            mc_model.set_accumulated_from_sampler(sampler)
        database = checkpoint(converged)
        if converged:
            break
        warn(f"Not yet converged after {(sampling_iter + 1) * iterations:d} "
             "iterations:")
        with span("psfmc.convergence"):
            convergence_check(sampler, verbose=1)
    return database
