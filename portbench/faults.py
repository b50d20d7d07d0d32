"""Faults planted under the timed path, each of which ``correct`` has to read.

    with faults.planted("half frozen"):
        ...  # every fit or batch run here has the fault

* ``frozen step``: a sampler step that returns its state unchanged;
* ``half the batch``: half of the batch left out, the mean taken over
  the rest (the driver's image means; the survey's evaluations);
* ``half frozen``: half of the batch never stepped (the driver's first
  half of each half-ensemble of walkers; the survey's first half of its
  targets), the rest stepped as before;
* ``answer altered``: an answer altered where it is produced: the
  driver's first walker's lnpost; the survey's first target's.

The cells run on one chip, so no exchange between chips can be left out.
The tests plant each on the CPU at the tiny size; ``control.py --faults``
reads each at a cell's own size on the card.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

__all__ = ["FAULTS", "planted"]


def _frozen():
    from psfmc_tpu_torch import batchfit
    from psfmc_tpu_torch.sampler import ensemble

    return [(ensemble.EnsembleSampler, "_step", lambda self, variant: None),
            (batchfit._BatchProgram, "_step", lambda self, variant: None)]


def _half_batch():
    from psfmc_tpu_torch.models.posterior import PosteriorFns

    means = PosteriorFns.ensemble_carry_means
    lnpost_obs = PosteriorFns.log_posterior_obs

    def half_means(self, thetas):
        return means(self, self.as_thetas(thetas)[: max(1, len(thetas) // 2)])

    def half_lnpost(self, thetas, obs):
        lnp = lnpost_obs(self, thetas, obs)
        half = lnp[: len(lnp) // 2]
        fin = half[torch.isfinite(half)]
        rest = torch.full_like(lnp[len(half):], fin.mean() if len(fin) else 0.0)
        return torch.cat([half, rest])

    return [(PosteriorFns, "ensemble_carry_means", half_means),
            (PosteriorFns, "log_posterior_obs", half_lnpost)]


def _first_half_kept(active_pos, active_lnp, pos, lnp, acc):
    """The update with the first half along the leading axis (walkers, or
    targets) kept where it was, and counted as not accepted."""
    n = acc.shape[0]
    keep = (torch.arange(n, device=acc.device) < n // 2).reshape((n,) + (1,) * (acc.dim() - 1))
    return (torch.where(keep[..., None], active_pos, pos), torch.where(keep, active_lnp, lnp),
            torch.where(keep, torch.zeros_like(acc), acc))


def _half_frozen():
    from psfmc_tpu_torch import batchfit
    from psfmc_tpu_torch.sampler import ensemble

    metropolis, batch_update = ensemble._metropolis, batchfit.batch_update

    def walkers(active_pos, active_lnp, *args):
        return _first_half_kept(active_pos, active_lnp,
                                *metropolis(active_pos, active_lnp, *args))

    def targets(active_pos, active_lnp, *args, **kwargs):
        return _first_half_kept(active_pos, active_lnp,
                                *batch_update(active_pos, active_lnp, *args, **kwargs))

    return [(ensemble, "_metropolis", walkers), (batchfit, "batch_update", targets)]


def _bump(lnp, n):  # the first n lnposts moved by 0.1% and 50 nats
    extra = torch.zeros_like(lnp)
    extra[:n] = 1e-3 * lnp[:n].abs() + 50.0
    return lnp + extra


def _altered():
    from psfmc_tpu_torch import batchfit
    from psfmc_tpu_torch.models.posterior import PosteriorFns

    lnpost, batch_update = PosteriorFns.log_posterior_batch, batchfit.batch_update

    def first_target(active_pos, active_lnp, comp_pos, lnpost_batch, *args, **kwargs):
        k = active_pos.shape[1]  # the first target's walkers lead the batch
        return batch_update(active_pos, active_lnp, comp_pos,
                            lambda thetas: _bump(lnpost_batch(thetas), k), *args, **kwargs)

    return [(PosteriorFns, "log_posterior_batch", lambda self, thetas: _bump(lnpost(self, thetas), 1)),
            (batchfit, "batch_update", first_target)]


FAULTS = {"frozen step": _frozen, "half the batch": _half_batch, "half frozen": _half_frozen,
          "answer altered": _altered}


@contextlib.contextmanager
def planted(name):
    """The fault ``name`` planted while the block runs."""
    with contextlib.ExitStack() as stack:
        for owner, attr, value in FAULTS[name]():
            stack.enter_context(mock.patch.object(owner, attr, value))
        yield
