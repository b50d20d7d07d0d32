"""Command-line drivers of the port: plot_chain, corner_plot, quick_fit,
summary and import_galfit (counterpart of ``psfmc_tpu.cli``).

The same five commands with the same arguments, usage texts (naming this
package) and exit codes.  ``python -m psfmc_tpu_torch.cli <command>
[arguments]`` runs one (:func:`main`); the console scripts
``psfmc-torch-plot-chain``, ``psfmc-torch-corner-plot``,
``psfmc-torch-quick-fit``, ``psfmc-torch-summary`` and
``psfmc-torch-import-galfit`` run them one by one.

Device: where the JAX commands call ``apply_platform_env`` (a JAX
platform from ``PSFMC_PLATFORM``), these read the same variable:
``cpu`` runs the command on the CPU, unset or ``cuda`` on the card, and
any other value raises a ``ValueError`` naming it.  A command that does
work without CUDA and without ``PSFMC_PLATFORM=cpu`` raises, as
:func:`~psfmc_tpu_torch._device.resolve_device` does.  ``import_galfit``
is host work and reads no device.  matplotlib is imported by the plot
commands only.
"""
from __future__ import annotations

import glob
import os
import sys
from ast import literal_eval
from difflib import SequenceMatcher

from ._device import resolve_device

__all__ = ["plot_chain_main", "corner_plot_main", "quick_fit_main",
           "summary_main", "import_galfit_main", "main", "COMMANDS"]

PLATFORM_ENV = "PSFMC_PLATFORM"


def _platform():
    """``"cpu"`` or None (the card) from ``PSFMC_PLATFORM``; a
    ``ValueError`` for any other value."""
    plat = os.environ.get(PLATFORM_ENV, "")
    if plat in ("", "cuda"):
        return None
    if plat == "cpu":
        return "cpu"
    raise ValueError(f"{PLATFORM_ENV}={plat!r}: expected 'cpu' or 'cuda' "
                     "(or unset, the card)")


PLOT_CHAIN_DOC = """
Generate diagnostic plots from psfmc_tpu_torch trace databases. Requires (at
least) the name of a traced variable from the model to plot.

Modes:
  hist (default) - histograms of all chains in the database; if a model
      file with a similar name sits next to the database, priors are
      overplotted.
  trace - value vs. sample index plots (assess burn-in length).
  autocorr - autocorrelation vs. lag plots with effective-sample counts.
  profile - radial surface-brightness profile: data vs posterior-mean
      model with a residual-significance panel.  Takes an OPTIONAL
      component prefix ('1_Sersic') to center on instead of a trace
      name; bare database filenames center on the model peak.
  save - write pdf files instead of opening windows.

Derived trace names (components given as <index>_<type>):
  <comp1>_<comp2>_magdiff     magnitude difference of two components
  <comp1>_<comp2>_centerdist  Euclidean distance (pixels) between centers
  <n>_Sersic_axisratio        semi-minor/semi-major axis ratio
  <n>_Sersic_sbeff            surface brightness at reff (mag/arcsec^2)

Examples:
  plot_chain 1_PointSource_mag mydb.fits
  plot_chain 1_PointSource_2_Sersic_magdiff trace *db.fits
  plot_chain 2_Sersic_index autocorr save
"""

CORNER_PLOT_DOC = """
Generate a corner plot showing covariances in the posterior distribution
of a psfmc_tpu_torch model. A comma-separated list of trace names selects the
displayed parameters. The argument "save" writes pdfs instead of opening
windows. All other arguments are trace database filenames.

Examples:
  corner_plot 1_PS_mag,2_Sersic_mag,2_Sersic_reff database.fits
  corner_plot save *.fits
"""


def plot_chain_main(argv=None):
    platform = _platform()
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        print(PLOT_CHAIN_DOC)
        return 0

    args = argv[1:]
    mode = "hist"
    for check_mode in ("hist", "chain", "trace", "autocorr", "profile"):
        if check_mode in args:
            args.remove(check_mode)
            mode = check_mode
    save = "save" in args
    if save:
        args.remove("save")
        import matplotlib

        matplotlib.use("Agg")

    if mode == "profile" and args and args[0].endswith(".fits"):
        # profile takes an OPTIONAL component prefix ('1_Sersic'), not
        # a trace name — bare db filenames mean "center on the peak"
        trace_name = None
        db_names = args
    else:
        trace_name = args[0]
        db_names = args[1:] or glob.glob("*db.fits")

    device = resolve_device(platform)
    from .analysis.plotting import plot_autocorr, plot_hist, plot_profile, plot_trace

    for db_name in db_names:
        # fuzzy-match the most similarly named model .py next to the db
        db_dir = os.path.dirname(db_name)
        py_files = sorted(
            glob.glob(os.path.join(db_dir, "*.py")),
            key=lambda x: SequenceMatcher(a=db_name, b=x).ratio(),
        )
        model_name = py_files[-1] if py_files else None

        if mode == "hist":
            if model_name is not None:
                print(
                    f"Found matching model file {model_name} for database "
                    f"{db_name}"
                )
            plot_hist(trace_name, db_name, model=model_name, save=save,
                      device=device)
        elif mode in ("chain", "trace"):
            plot_trace(trace_name, db_name, model=model_name, save=save,
                       device=device)
        elif mode == "autocorr":
            plot_autocorr(trace_name, db_name, save=save)
        elif mode == "profile":
            plot_profile(db_name, model=model_name, save=save,
                         component=trace_name, device=device)
    return 0


QUICK_FIT_DOC = """
Quick-look gradient MAP fit of a model file (no MCMC): writes the five
best-fit image products with parameter values +/- Laplace standard
errors in the headers, in seconds.  For full posteriors, use
model_galaxy_mcmc (optionally with init='map' to reuse this fit).

Usage: quick_fit <model.py> [output_name] [key=value ...]

Optional key=value settings: n_starts (64), steps (500), seed (0),
laplace (1).

Examples:
  quick_fit model_J0005.py
  quick_fit model_J0005.py quick_J0005 n_starts=128 steps=800
"""


def quick_fit_main(argv=None):
    platform = _platform()
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        print(QUICK_FIT_DOC)
        return 0

    args = argv[1:]
    kwargs = {}
    for kv in [a for a in list(args) if "=" in a]:
        args.remove(kv)
        key, _, value = kv.partition("=")
        if key not in ("n_starts", "steps", "seed", "laplace"):
            print(f"Unknown setting {key!r}\n{QUICK_FIT_DOC}")
            return 2
        try:
            kwargs[key] = (
                int(value) if key != "laplace" else bool(int(value))
            )
        except ValueError:
            print(f"Setting {key!r} needs an integer, got {value!r}")
            return 2

    if not args:
        print(f"No model file given\n{QUICK_FIT_DOC}")
        return 2
    model_file = args[0]
    output_name = args[1] if len(args) > 1 else None

    device = resolve_device(platform)
    from .fitting import model_galaxy_map

    res = model_galaxy_map(model_file, output_name=output_name, device=device,
                           **kwargs)
    print(f"lnpost = {res.lnpost:.3f}  (psf_index = {res.psf_index})")
    return 0


def corner_plot_main(argv=None):
    platform = _platform()
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        print(CORNER_PLOT_DOC)
        return 0

    args = argv[1:]
    save = "save" in args
    if save:
        args.remove("save")
        import matplotlib

        matplotlib.use("Agg")

    resolve_device(platform)  # raises without CUDA unless PSFMC_PLATFORM=cpu
    from .analysis.plotting import corner_plot

    disp_params = None
    for cl_arg in [a for a in list(args) if "," in a]:
        args.remove(cl_arg)
        wrapped = "[" + cl_arg + "]"
        try:
            parsed = literal_eval(wrapped)
        except (SyntaxError, ValueError):
            quoted = (
                wrapped.replace(",", "','")
                .replace("[", "['")
                .replace("]", "']")
            )
            parsed = [p for p in literal_eval(quoted) if p != ""]
        disp_params = list(parsed)

    for db_name in args:
        corner_plot(db_name, disp_parameters=disp_params, save=save)
    return 0


SUMMARY_DOC = """\
Usage: psfmc-torch-summary [--criticism MODEL_FILE] <db.fits> [db2.fits ...]

Print a posterior summary table per trace database: mean, std,
16/50/84 percentiles, plus modern convergence diagnostics
(rank-normalized split-R-hat and bulk/tail effective sample sizes,
Vehtari et al. 2021; healthy: R-hat < 1.01, ESS > 400).

With --criticism MODEL_FILE, also replay the chain through the model
for predictive model criticism: PSIS-LOO (elpd, p_eff, per-pixel
Pareto-k census), LOO-PIT calibration (KS uniformity of the
leave-one-out predictive CDFs) and power-scaling prior/likelihood
sensitivity (prior-data conflict / dominating-prior flags).  Exit
status 1 when anything is flagged or the criticism could not be
computed.
"""


def summary_main(argv=None):
    platform = _platform()
    argv = list(sys.argv if argv is None else argv)
    model_path = None
    if "--criticism" in argv:
        i = argv.index("--criticism")
        if i + 1 >= len(argv):
            print(SUMMARY_DOC)
            return 2
        model_path = argv[i + 1]
        del argv[i : i + 2]
    if len(argv) < 2:
        print(SUMMARY_DOC)
        return 2

    import warnings

    import numpy as np

    from .analysis import convergence_summary, summary
    from .database import load_database

    device = resolve_device(platform)
    model = None
    if model_path is not None:
        from .models.multicomponent import as_model

        model = as_model(model_path, device=device)

    status = 0
    for db_name in argv[1:]:
        db = load_database(db_name)
        stats = summary(db)
        try:
            diag = convergence_summary(db)
        except Exception as err:  # noqa: BLE001 - diag must not kill IO
            print(f"(convergence diagnostics unavailable: {err})")
            diag = {}
        print(f"\n# {db_name}")
        hdr = (f"{'parameter':<24s} {'mean':>12s} {'std':>11s} "
               f"{'p16':>12s} {'p50':>12s} {'p84':>12s} "
               f"{'rhat':>7s} {'essB':>7s} {'essT':>7s}")
        print(hdr)
        print("-" * len(hdr))
        for name, s in stats.items():
            d = diag.get(name, {})
            rhat = d.get("rhat")
            eb = d.get("ess_bulk")
            et = d.get("ess_tail")
            flag = ""
            if rhat is not None:
                # NaN (frozen/undiagnosable parameter) must FLAG, not
                # pass — NaN > 1.01 is False, so use negated healthy
                # conditions
                healthy = (
                    np.isfinite(rhat)
                    and rhat <= 1.01
                    and np.isfinite(eb)
                    and np.isfinite(et)
                    and min(eb, et) >= 400
                )
                if not healthy:
                    flag = "  <-- check"
                    status = max(status, 1)
            print(
                f"{name:<24s} {s['mean']:>12.5g} {s['std']:>11.4g} "
                f"{s['p16']:>12.5g} {s['p50']:>12.5g} {s['p84']:>12.5g} "
                + (f"{rhat:>7.3f} {eb:>7.0f} {et:>7.0f}" if rhat is not None
                   else f"{'-':>7s} {'-':>7s} {'-':>7s}")
                + flag
            )
        if model is not None:
            from .analysis import (
                loo_pit,
                pointwise_loglike,
                power_scale_sensitivity,
                psis_loo,
            )

            try:
                with warnings.catch_warnings():
                    # summaries already carry the notes; don't double-print
                    warnings.simplefilter("ignore")
                    ll = pointwise_loglike(model, db)
                    loo = psis_loo(loglike=ll)
                    pit = loo_pit(model, db, loglike=ll)
                    sens = power_scale_sensitivity(model, db)
                print()
                print(loo.summary())
                print(pit.summary())
                print(sens.summary())
                if (loo.notes or not pit.calibrated() or sens.flagged()
                        or sens.notes):
                    status = max(status, 1)
            except Exception as err:  # noqa: BLE001 - must not kill IO
                # an uncomputable criticism is a failure to verify,
                # not a pass — surface it in the exit status
                print(f"(model criticism unavailable: {err})")
                status = max(status, 1)
    return status


IMPORT_GALFIT_DOC = """
Convert a GALFIT .feedme input file into a psfMC model file.

Usage: psfmc-torch-import-galfit galfit.feedme [out_model.py]

Writes the generated model source to out_model.py (stdout if omitted).
Free GALFIT parameters (fit toggle 1) become Uniform priors centered
on the value; fixed ones become constants.  Review the priors and add
the Configuration(...) block before fitting — GALFIT has no PSF
uncertainty input, so the data declaration stays yours.
All conventions (position -1, angle +90, expdisk scale length,
GALFIT's surface-brightness-parameterized king/nuker/edgedisk) are
converted exactly; see psfmc_tpu_torch.io.galfit.
"""


def import_galfit_main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2 or argv[1] in ("-h", "--help"):
        print(IMPORT_GALFIT_DOC)
        return 2
    # host parsing + scipy quadrature: no device
    from .io.galfit import feedme_to_model_source

    src = feedme_to_model_source(argv[1])
    if len(argv) > 2:
        with open(argv[2], "w") as fh:
            fh.write(src)
        print(f"wrote {argv[2]}")
    else:
        sys.stdout.write(src)
    return 0


COMMANDS = {
    "plot_chain": plot_chain_main,
    "quick_fit": quick_fit_main,
    "corner_plot": corner_plot_main,
    "summary": summary_main,
    "import_galfit": import_galfit_main,
}

MAIN_DOC = """\
Usage: python -m psfmc_tpu_torch.cli <command> [arguments]

Commands: plot_chain, quick_fit, corner_plot, summary, import_galfit.
Each prints its own usage when given no arguments.  PSFMC_PLATFORM=cpu
runs a command on the CPU; unset (or cuda), it runs on the card.
"""


def main(argv=None):
    """``python -m psfmc_tpu_torch.cli <command> [arguments]``: run one
    command with ``argv[0]`` its name.  No command prints the usage (exit
    status 2; 0 for ``-h`` / ``--help``), an unknown one too."""
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2 or argv[1] in ("-h", "--help"):
        print(MAIN_DOC)
        return 0 if len(argv) >= 2 else 2
    command = COMMANDS.get(argv[1])
    if command is None:
        print(f"Unknown command {argv[1]!r}\n{MAIN_DOC}")
        return 2
    return command(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
