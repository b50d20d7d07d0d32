"""Affine-invariant ensemble sampler (port of ``sampler/ensemble.py``, stretch moves).

emcee 2.x stretch-move semantics, as in the JAX package: ``a = 2`` by
default, red/black half-ensemble updates (the second half moves against
the already-updated first half), ``z = ((a-1) u + 1)^2 / a`` and the
acceptance ratio ``(dim-1) ln z + lnp(Y) - lnp(X)``.  Each half-step
evaluates the whole half-ensemble in one batched posterior call.

Differences of form from the JAX package:

* a Python loop over steps replaces ``lax.scan`` (the state stays on
  the device; nothing synchronizes per step);
* every random draw takes an explicit ``torch.Generator`` on the
  sampler's device, and :func:`stretch_update` takes the draws as
  arguments so a test can inject them;
* the chain is fetched to the host once per phase, and the posterior
  moments are merged there in float64: float32 chain sums drift by
  ~1e-3 over ~1e5 samples.

Posterior-image running means accumulate on the device (float32) after
every retained step, from the posterior's ``ensemble_carry_means``
(three convolutions per step) when it has one.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "EnsembleState",
    "EnsembleSampler",
    "welford_batch_update",
    "merge_image_accumulators",
    "stretch_update",
    "make_step_fn",
]


@dataclass
class EnsembleState:
    positions: torch.Tensor  # (nwalkers, dim)
    log_prob: torch.Tensor  # (nwalkers,)
    accum: Dict[str, torch.Tensor]  # running-mean images; empty until merged
    accum_count: int
    naccept: torch.Tensor  # (nwalkers,) accepted moves per walker


def welford_batch_update(moments, batch):
    """Merge a ``(nbatch, dim)`` batch into Welford running moments.

    Chan et al. parallel merge: the batch's own mean and M2 first, then
    the merge into ``moments = {"mean", "m2", "n"}``.  Works in the
    batch's dtype; the sampler calls it with float64 host tensors.
    """
    nb = batch.shape[0]
    bmean = batch.mean(dim=0)
    bm2 = ((batch - bmean) ** 2).sum(dim=0)
    n = int(moments["n"])
    n_new = n + nb
    delta = bmean - moments["mean"]
    mean = moments["mean"] + delta * (nb / n_new)
    m2 = moments["m2"] + bm2 + delta * delta * (n * nb / n_new)
    return {"mean": mean, "m2": m2, "n": n_new}


def merge_image_accumulators(accum, count, means, nbatch):
    """Merge one batch of ensemble image statistics into the running means.

    Mean keys take the incremental-mean update; ``raw_m2`` (sum of
    squared deviations) the Chan parallel merge against the OLD mean.
    Returns ``(new_accum, new_count)``.
    """
    count_new = count + nbatch
    out = {}
    for k, v in accum.items():
        if k.endswith("raw_m2"):
            continue
        out[k] = v + nbatch * (means[k].to(v.dtype) - v) / count_new
    for k, v in accum.items():
        if not k.endswith("raw_m2"):
            continue
        base = k[: -len("_m2")]
        delta = means[base].to(v.dtype) - accum[base]
        ratio = count * nbatch / count_new
        out[k] = v + means[k].to(v.dtype) + delta * delta * ratio
    return out, count_new


def stretch_update(active_pos, active_lnp, comp_pos, lnpost_batch, a, dim,
                   u, partner, u_accept):
    """One half-ensemble stretch move with its random draws given.

    ``u`` and ``u_accept`` are uniforms on [0, 1), ``partner`` indices
    into ``comp_pos``, one each per active walker.  Returns ``(new_pos,
    new_lnp, accepted)``.
    """
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    c = comp_pos[partner]
    proposal = c + z[:, None] * (active_pos - c)
    log_extra = (dim - 1.0) * torch.log(z)
    prop_lnp = lnpost_batch(proposal)
    log_ratio = log_extra + prop_lnp - active_lnp
    accept = torch.log(u_accept) < log_ratio
    new_pos = torch.where(accept[:, None], proposal, active_pos)
    new_lnp = torch.where(accept, prop_lnp, active_lnp)
    return new_pos, new_lnp, accept.to(torch.int64)


def _stretch_half(generator, active_pos, active_lnp, comp_pos, lnpost_batch,
                  a, dim):
    """Draw the stretch move's randoms from ``generator`` and apply it."""
    k = active_pos.shape[0]
    kw = dict(generator=generator, device=active_pos.device)
    u = torch.rand(k, dtype=active_pos.dtype, **kw)
    partner = torch.randint(0, comp_pos.shape[0], (k,), **kw)
    u_accept = torch.rand(k, dtype=active_pos.dtype, **kw)
    return stretch_update(active_pos, active_lnp, comp_pos, lnpost_batch, a,
                          dim, u, partner, u_accept)


def make_step_fn(lnpost_batch, nwalkers, dim, generator, a=2.0,
                 accumulate=False, ensemble_means_fn=None):
    """One ensemble iteration: two half-ensemble updates, then (when
    ``accumulate``) the image accumulation over the current walkers."""
    half = nwalkers // 2

    def step(state: EnsembleState) -> EnsembleState:
        pos, lnp = state.positions, state.log_prob
        p0, l0, acc0 = _stretch_half(
            generator, pos[:half], lnp[:half], pos[half:], lnpost_batch, a, dim
        )
        p1, l1, acc1 = _stretch_half(
            generator, pos[half:], lnp[half:], p0, lnpost_batch, a, dim
        )
        new_pos = torch.cat([p0, p1], dim=0)
        accum, count = state.accum, state.accum_count
        if accumulate and ensemble_means_fn is not None:
            means = ensemble_means_fn(new_pos)
            if not accum:  # keys and shapes come from the first batch
                accum = {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in means.items()}
            accum, count = merge_image_accumulators(accum, count, means,
                                                    nwalkers)
        return EnsembleState(
            positions=new_pos,
            log_prob=torch.cat([l0, l1], dim=0),
            accum=accum,
            accum_count=count,
            naccept=state.naccept + torch.cat([acc0, acc1]),
        )

    return step


class EnsembleSampler:
    """emcee-2.x-style sampler: ``init_state``, ``run_burn``, ``reset``,
    ``run_sampling`` and the ``chain`` / ``lnprobability`` /
    ``acceptance_fraction`` / ``accumulated_images`` accessors.

    ``posterior_fns`` needs ``log_posterior_batch(thetas)``, ``device``
    and ``dtype``; with an ``ensemble_carry_means(thetas)`` the sampler
    also accumulates posterior-mean images during retained sampling.
    """

    def __init__(self, nwalkers: int, dim: int, posterior_fns, a: float = 2.0,
                 seed: int = 0, device=None):
        if nwalkers % 2 != 0:
            raise ValueError("nwalkers must be even for half-ensemble moves")
        if nwalkers < 2 * dim + 2:
            warnings.warn(
                f"nwalkers={nwalkers} is fewer than the recommended "
                f"2*dim+2={2 * dim + 2}"
            )
        self.device = resolve_device(device)
        if torch.device(posterior_fns.device) != self.device:
            raise ValueError(
                f"posterior is on {posterior_fns.device}, sampler on "
                f"{self.device}"
            )
        self.nwalkers = nwalkers
        self.dim = dim
        self.a = float(a)
        self.fns = posterior_fns
        self.dtype = posterior_fns.dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._means_fn = getattr(posterior_fns, "ensemble_carry_means", None)
        self.state: Optional[EnsembleState] = None
        self._chain = None  # numpy (nwalkers, nsteps, dim), emcee layout
        self._lnprob = None  # numpy (nwalkers, nsteps)
        self._naccept = np.zeros(nwalkers, dtype=np.int64)
        self._nsteps_total = 0
        self._moments = self._fresh_moments()

    # -- state -----------------------------------------------------------
    def _fresh_moments(self):
        z = torch.zeros(self.dim, dtype=torch.float64)
        return {"mean": z, "m2": z.clone(), "n": 0}

    def init_state(self, p0):
        """Set the walkers to ``p0`` ``(nwalkers, dim)`` and evaluate them."""
        p0 = torch.as_tensor(p0, dtype=self.dtype, device=self.device)
        if p0.shape != (self.nwalkers, self.dim):
            raise ValueError(
                f"p0 must be ({self.nwalkers}, {self.dim}), got {tuple(p0.shape)}"
            )
        self.state = EnsembleState(
            positions=p0,
            log_prob=self.fns.log_posterior_batch(p0),
            accum={},
            accum_count=0,
            naccept=torch.zeros(self.nwalkers, dtype=torch.int64,
                                device=self.device),
        )
        return self.state

    def reset(self):
        """Clear the chain, acceptance counts, image accumulators and
        moments; keep the walker positions (emcee's ``reset()``)."""
        self._chain = None
        self._lnprob = None
        self._naccept = np.zeros(self.nwalkers, dtype=np.int64)
        self._nsteps_total = 0
        self._moments = self._fresh_moments()
        if self.state is not None:
            self.state = replace(
                self.state,
                accum={},
                accum_count=0,
                naccept=torch.zeros_like(self.state.naccept),
            )

    # -- phases ----------------------------------------------------------
    def _step_fn(self, accumulate):
        return make_step_fn(
            self.fns.log_posterior_batch, self.nwalkers, self.dim,
            self.generator, a=self.a, accumulate=accumulate,
            ensemble_means_fn=self._means_fn,
        )

    def _run(self, nsteps, accumulate, record):
        if self.state is None:
            raise RuntimeError("call init_state(p0) first")
        step = self._step_fn(accumulate)
        start_accept = self.state.naccept.clone()
        positions, lnprobs = [], []
        for _ in range(int(nsteps)):
            self.state = step(self.state)
            if record:
                positions.append(self.state.positions)
                lnprobs.append(self.state.log_prob)
        self._naccept += (self.state.naccept - start_accept).cpu().numpy()
        self._nsteps_total += int(nsteps)
        if not record or not positions:
            return
        # one device -> host transfer per phase; emcee layout
        chain = torch.stack(positions, dim=1).to("cpu", torch.float64)
        lnprob = torch.stack(lnprobs, dim=1).to("cpu", torch.float64)
        for s in range(chain.shape[1]):
            self._moments = welford_batch_update(self._moments, chain[:, s])
        chain, lnprob = chain.numpy(), lnprob.numpy()
        if self._chain is None:
            self._chain, self._lnprob = chain, lnprob
        else:
            self._chain = np.concatenate([self._chain, chain], axis=1)
            self._lnprob = np.concatenate([self._lnprob, lnprob], axis=1)

    def run_burn(self, nsteps: int):
        """Burn-in: no chain recording, no image accumulation."""
        self._run(nsteps, accumulate=False, record=False)
        return self

    def run_sampling(self, nsteps: int):
        """Retained sampling: records the chain and accumulates images."""
        self._run(nsteps, accumulate=True, record=True)
        return self

    # -- emcee-compatible accessors ----------------------------------------
    @property
    def chain(self):
        """``(nwalkers, nsteps, dim)`` float64 numpy, or None."""
        return self._chain

    @property
    def lnprobability(self):
        """``(nwalkers, nsteps)`` float64 numpy, or None."""
        return self._lnprob

    @property
    def flatchain(self):
        c = self._chain
        return c.reshape(-1, self.dim) if c is not None else None

    @property
    def acceptance_fraction(self):
        return self._naccept / max(self._nsteps_total, 1)

    @property
    def accumulated_images(self):
        """Running-mean carry images (plus ``raw_m2``) as numpy; None
        before any retained step."""
        if self.state is None or not self.state.accum:
            return None
        return {k: v.cpu().numpy() for k, v in self.state.accum.items()}

    @property
    def accumulated_samples(self):
        return 0 if self.state is None else int(self.state.accum_count)

    @property
    def posterior_moments(self):
        """(mean, std) per parameter over every retained step since the
        last reset, merged in float64 on the host; None before any."""
        if self._moments["n"] == 0:
            return None
        n = self._moments["n"]
        var = self._moments["m2"] / max(n - 1, 1)
        return self._moments["mean"].numpy(), np.sqrt(var.numpy())
