"""The comparison that decides ``correct``: what the timed path produced
against the float64 reference.

Numbers compared (each against its limit in ``limits/<cell>.json``):

* ``lnp_gap``: the widest gap between the lnpost the program recorded
  and the reference's at the same parameters, as a share of the larger
  of the reference's |lnpost| and the likelihood's normalisation
  (``sum_good log(ivm / 2 pi) / 2`` of the observation): float32
  arithmetic errs in proportion to the terms it sums.  Driver
  fits: a sample of each fit's retained trace rows drawn from the seed,
  with the fit's best row; survey batches: every target's best (MAP)
  row.  The rows are read back from the trace database with the
  benchmark's own FITS reader.
* ``image_gap``: the widest gap of the five posterior-mean image
  products written by a fit drawn from the seed, against the reference's
  means over the same trace rows (after the same stuck-walker filter),
  as a share of the product's scale (the raw model's peak; the
  convolved model's peak for the convolved model, the residual and the
  point-source-subtracted image; the composite IVM's peak).  Driver
  fits only.
* ``unmoved_walkers``: the largest share, over the fits, of the walkers
  that never moved in the retained steps: a sampler that stops moving
  (all of its walkers, or half of them) leaves every row consistent
  with the others, and only this reads it.  Driver fits.
* ``unmoved_targets``: the largest share, over the batches, of the
  targets whose acceptance fraction (as ``fit_batch`` reports it) is 0:
  targets never stepped, which the MAP rows alone would not show.
  Survey batches.
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..reference.posterior import param_names
from .fitsio import read_image, read_table

__all__ = ["check_units", "judge", "IMAGE_TYPES", "DRIVER_ROWS", "IMAGE_FITS"]

IMAGE_TYPES = ("raw_model", "convolved_model", "residual", "composite_ivm",
               "point_source_subtracted")
_SCALE_OF = {"raw_model": "raw_model", "convolved_model": "convolved_model",
             "residual": "convolved_model", "point_source_subtracted": "convolved_model",
             "composite_ivm": "composite_ivm"}
DRIVER_ROWS = 64  # trace rows of each fit compared, besides its best row
IMAGE_FITS = 1  # fits whose image products are compared


def _gap(got, want, norm):
    """Widest ``|got - want| / max(|want|, norm)``; equal infinities agree."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same_inf = (got == want) & ~np.isfinite(want)
    gap = np.abs(got - want) / np.maximum(np.abs(want), norm)
    gap[same_inf] = 0.0
    gap[np.isnan(gap)] = math.inf
    return float(gap.max()) if gap.size else 0.0


def _named(cols, names, rows):
    return {n: cols[n][rows] for n, _ in names}


def _unmoved_walkers(cols, names, walkers):
    """Share of the walkers that never moved in the retained steps."""
    x = np.concatenate([np.reshape(cols[n], (len(cols[n]), -1)) for n, _ in names], axis=1)
    order = np.lexsort((cols["sample"], cols["walker"]))
    x = x[order].reshape(walkers, -1, x.shape[1])
    moved = np.any(x[:, 1:] != x[:, :-1], axis=(1, 2))
    return float(1.0 - moved.mean())


def _image_gap(ref, cols, names, fitdir, control=None):
    """Widest gap of the fit's five image products (or, given the
    ``control``, of its images of the same rows), with the program's
    stuck-walker filter applied to its own trace first."""
    lnp = cols["lnprobability"]
    pct = np.percentile(lnp, 10)
    keep = np.isin(cols["walker"], np.unique(cols["walker"][lnp > pct]))
    if not keep.any():
        return math.inf, {}
    want = ref.mean_images(_named(cols, names, keep))
    made = None if control is None else control.mean_images(_named(cols, names, keep))
    gaps = {}
    for kind in IMAGE_TYPES:
        got = (read_image(os.path.join(fitdir, f"out_{kind}.fits")) if made is None
               else np.where(np.isfinite(made[kind]), made[kind], 0.0))
        w = np.where(np.isfinite(want[kind]), want[kind], 0.0)
        scale = np.abs(want[_SCALE_OF[kind]][np.isfinite(want[_SCALE_OF[kind]])]).max()
        gaps[kind] = float(np.abs(got - w).max() / scale)
    return max(gaps.values()), gaps


def check_driver(traffic, units, seed, control=False):
    cfg, inputs = traffic.cfg, traffic.inputs
    names = param_names(cfg["components"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    image_units = set(rng.choice(len(units), min(IMAGE_FITS, len(units)), replace=False))
    refs = {}
    lnp_gap, unmoved, image_gap, detail = 0.0, 0.0, 0.0, {}
    for j, u in enumerate(units):
        cols, _ = read_table(os.path.join(u["dir"], "out_db.fits"), "TRACE")
        n = len(cols["lnprobability"])
        rows = np.unique(np.append(rng.choice(n, min(DRIVER_ROWS, n), replace=False),
                                   np.argmax(cols["lnprobability"])))
        if u["target"] not in refs:
            refs[u["target"]] = (inputs.reference([u["target"]]),
                                 inputs.reference([u["target"]], "tf32") if control else None)
        ref, ctrl = refs[u["target"]]
        named = _named(cols, names, rows)
        want = ref.log_posterior(named)
        got = cols["lnprobability"][rows] if ctrl is None else ctrl.log_posterior(named)
        lnp_gap = max(lnp_gap, _gap(got, want, ref.normalization()[0]))
        unmoved = max(unmoved, _unmoved_walkers(cols, names, traffic.walkers))
        if j in image_units:
            gap, detail = _image_gap(ref, cols, names, u["dir"], ctrl)
            image_gap = max(image_gap, gap)
    return {"lnp_gap": lnp_gap, "image_gap": image_gap, "unmoved_walkers": unmoved}, detail


def check_batch(traffic, units, seed, control=False):
    ref = traffic.inputs.reference(None)
    ctrl = traffic.inputs.reference(None, "tf32") if control else None
    lnp_gap, unmoved = 0.0, 0.0
    for u in units:
        named, pos = {}, 0
        for name, ln in zip(u["param_names"], u["param_lens"]):
            col = u["map_theta"][:, pos:pos + ln]
            named[name] = col[:, 0] if ln == 1 else col
            pos += ln
        target = np.asarray(u["targets"])
        want = ref.log_posterior(named, target=target)
        got = u["map_lnp"] if ctrl is None else ctrl.log_posterior(named, target=target)
        lnp_gap = max(lnp_gap, _gap(got, want, ref.normalization()[target]))
        unmoved = max(unmoved, float(np.mean(u["acceptance"] == 0)))
    return {"lnp_gap": lnp_gap, "unmoved_targets": unmoved}, {}


def check_units(traffic, units, seed, control=False):
    """The compared numbers of ``units`` (and a detail dict); with
    ``control``, the control's (the reference at TF32, in the program's
    place, on the program's rows)."""
    if traffic.mix["kind"] == "batch":
        return check_batch(traffic, units, seed, control)
    return check_driver(traffic, units, seed, control)


def judge(numbers, limits):
    """``(correct, [(name, value, relation, limit)])``: each number
    against its limit (``max``: at most; ``min``: at least); a number
    without a limit fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        lim = limits.get(name)
        if lim is None:
            rows.append((name, value, "no limit", None))
            ok = False
        elif "max" in lim:
            rows.append((name, value, "<=", lim["max"]))
            ok &= bool(value <= lim["max"])
        else:
            rows.append((name, value, ">=", lim["min"]))
            ok &= bool(value >= lim["min"])
    return ok, rows
