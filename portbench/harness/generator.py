"""The one traffic generator: a mix's data file says what arrives.

A mix (``traffic/<name>.json``) is data:

* ``"kind": "driver"``: whole fits through ``model_galaxy_mcmc`` on a model
  file, one after another.  A pool of ``pool`` fits, each an observation
  of the field and the program's seed, is drawn at set-up from
  ``pool_seed``; the fits take the pool in turn from a slot drawn from
  the run's seed, so that every run does the same work in another order
  (which fits replay their chain for the images depends on the fit);
  ``env`` is the environment a user sets (``PSFMC_LNPOST``; every other
  ``PSFMC_`` variable is cleared); the walkers and steps are the
  configuration's ``fit`` unless the mix gives its own.
  Each fit writes its trace database and its five image products to a
  directory of its own under the run's ``TMPDIR``.
* ``"kind": "batch"``: survey batches through ``fit_batch``: ``targets``
  observations a call (``pool`` stacks made at set-up, taken in turn),
  ``walkers`` (``null``: the default ``2 dim + 2``), ``burn`` and
  ``iterations``; one model object serves every call, as a survey
  pipeline keeps it.

Each unit of work (a fit, a batch) is whole: :meth:`unit` returns when
it is done, its outputs on disk or in the returned record.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

from .inputs import make_inputs

__all__ = ["make_traffic", "unit_seed"]


def unit_seed(seed, i):
    """The program's seed of unit ``i`` of a run seeded ``seed`` (< 2**31)."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1)[0] >> 1)


class _Traffic:
    def __init__(self, cell, seed, workdir, device):
        self.cell, self.seed, self.workdir, self.device = cell, seed, workdir, device
        self.mix = cell.traffic
        self.cfg = cell.config
        # the program's switches are the mix's alone
        for key in [k for k in os.environ if k.startswith("PSFMC_")]:
            del os.environ[key]
        os.environ.update(self.mix.get("env", {}))

    def describe(self):
        """The shapes and counts the per-layer readers need."""
        h, w = self.cfg["shape"]
        kinds = [c["type"] for c in self.cfg["components"]]
        return {"name": self.cell.name, "shape": [h, w], "walkers": self.walkers,
                "targets": self.targets, "burn": self.burn, "iterations": self.iterations,
                "steps": self.burn + self.iterations, "sersics": kinds.count("Sersic"),
                "points": kinds.count("PointSource")}


class DriverTraffic(_Traffic):
    """Whole fits through the model-file driver, back to back."""

    def __init__(self, cell, seed, workdir, device, sizes=None):
        super().__init__(cell, seed, workdir, device)
        fit = dict(self.cfg["fit"], **self.mix.get("fit", {}), **(sizes or {}))
        self.walkers, self.burn, self.iterations = fit["chains"], fit["burn"], fit["iterations"]
        self.targets = 1
        indir = os.path.join(workdir, "inputs")
        os.makedirs(indir)
        pool = int(self.mix.get("pool", 1))
        self.pool_seed = int(self.mix["pool_seed"])
        self.first_slot = int(np.random.default_rng([int(seed), 11]).integers(pool))
        self.inputs = make_inputs(self.cfg, self.pool_seed, pool, indir, device)

    def unit(self, i):
        from psfmc_tpu_torch.fitting import model_galaxy_mcmc

        k = (self.first_slot + i) % len(self.inputs.model_files)
        fitdir = os.path.join(self.workdir, f"fit{i}")
        os.makedirs(fitdir)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            db = model_galaxy_mcmc(self.inputs.model_files[k],
                                   output_name=os.path.join(fitdir, "out"),
                                   burn=self.burn, iterations=self.iterations,
                                   chains=self.walkers, seed=unit_seed(self.pool_seed, k),
                                   device=self.device)
        return {"i": i, "target": k, "dir": fitdir, "seconds": time.perf_counter() - t0,
                "fits": 1, "phase_seconds": dict(db.phase_seconds)}


class BatchTraffic(_Traffic):
    """Survey batches through ``fit_batch``, back to back."""

    def __init__(self, cell, seed, workdir, device, sizes=None):
        super().__init__(cell, seed, workdir, device)
        mix = dict(self.mix, **(sizes or {}))
        self.targets, self.burn, self.iterations = mix["targets"], mix["burn"], mix["iterations"]
        indir = os.path.join(workdir, "inputs")
        os.makedirs(indir)
        pool = int(mix.get("pool", 1))
        self.inputs = make_inputs(self.cfg, seed, pool * self.targets, indir, device)
        dim = sum(int(np.size(p["loc"])) for c in self.cfg["components"]
                  for p in c["params"].values())
        self.walkers = mix.get("walkers") or 2 * dim + 2
        self.pool = pool
        self.model = None

    def unit(self, i):
        from psfmc_tpu_torch.batchfit import fit_batch
        from psfmc_tpu_torch.models import MultiComponentModel

        if self.model is None:  # the field's template: its PSF, mask and geometry
            self.model = MultiComponentModel(self.inputs.model_files[0], device=self.device)
        k = i % self.pool
        rows = slice(k * self.targets, (k + 1) * self.targets)
        obs = self.inputs.obs[rows]
        ivm = np.broadcast_to(self.inputs.ivm, obs.shape)
        t0 = time.perf_counter()
        res = fit_batch(self.model, obs, ivm, nwalkers=self.walkers, burn=self.burn,
                        iterations=self.iterations, seed=unit_seed(self.seed, i),
                        device=self.device)
        return {"i": i, "targets": list(range(rows.start, rows.stop)),
                "seconds": time.perf_counter() - t0, "fits": self.targets,
                "param_names": list(res.param_names), "param_lens": list(res.param_lens),
                "map_theta": np.asarray(res.map_theta, np.float64),
                "map_lnp": np.asarray(res.map_lnp, np.float64),
                "acceptance": np.asarray(res.acceptance, np.float64)}


_KINDS = {"driver": DriverTraffic, "batch": BatchTraffic}


def make_traffic(cell, seed, workdir, device, sizes=None):
    return _KINDS[cell.traffic["kind"]](cell, seed, workdir, device, sizes)
