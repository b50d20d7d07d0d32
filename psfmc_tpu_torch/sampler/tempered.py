"""Parallel-tempered ensemble sampler (port of ``sampler/tempered.py``).

Replica exchange over ``ntemps`` rungs at inverse temperatures ``1 =
beta_0 > beta_1 > ... >= 0``, each rung an affine-invariant ensemble
sampling ``prior * likelihood^beta``, with the standard replica-swap
Metropolis rule between adjacent rungs after every step.  Hot rungs roam
between the modes of a multimodal quasar/host posterior (flux swaps
between the point source and the Sersic, position swaps between
components) and feed the cold rung, whose chain alone is recorded.

As in the JAX package, tempering acts on the likelihood only
(``lnprior + beta * lnL``); a posterior without a prior decomposition is
tempered as ``beta * lnpost``.  The rung axis is one more batch axis:
every half-step evaluates ``ntemps * nwalkers / 2`` walkers in one
batched likelihood call, so on the card one launch of the render and
conv+likelihood kernels (or of the fused kernel) carries every rung.

The state lives in persistent buffers (:class:`PTState`) written in
place, and on CUDA every step of ``run_burn`` / ``run_sampling`` is a
replay of one captured graph per variant, through the ensemble sampler's
``_step`` / ``_capture``.  The ladder ``betas`` is one of those buffers:
burn-in adaptation writes it with ``copy_`` between windows, the
counterpart of the JAX package passing ``betas`` as a runtime argument
of its compiled phase, so adaptation never captures a new graph.

The retained phase feeds the evidence accumulators: Kahan-compensated
sums of each rung's per-step mean lnL and lnL^2 (thermodynamic
integration) and a streaming logsumexp of ``dbeta * lnL`` at the hotter
rung of each adjacent pair (stepping-stone), read by
:meth:`PTEnsembleSampler.log_evidence`.  They are float64 on every
device (a deliberate divergence: the JAX package sums in the dtype of
the computed lnL, float32 on the chip).

Differences of form from the JAX package are the ensemble sampler's
(see :mod:`.ensemble`): a ``torch.Generator`` in place of the PRNG key,
the draws of :func:`pt_update` and :func:`swap_move` taken as arguments.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .ensemble import (
    EnsembleSampler,
    _de_proposal,
    _host,
    _stretch_proposal,
    fresh_image_accumulators,
    merge_image_accumulators,
    restore_image_accumulators,
    welford_batch_update,
)

__all__ = [
    "default_beta_ladder",
    "evidence_beta_ladder",
    "ladder_from_sigma",
    "batched_like_prior",
    "GeneratorDraws",
    "PTState",
    "pt_update",
    "swap_move",
    "make_pt_step_fn",
    "PTEnsembleSampler",
]


def default_beta_ladder(ntemps: int, tmax: float = 64.0):
    """Geometric inverse-temperature ladder 1 ... 1/tmax (float64).

    With ``betas=None`` the sampler re-sizes this ladder during burn-in
    from the measured per-rung std(lnL) (:func:`ladder_from_sigma`): a
    high-S/N imaging likelihood needs rungs far closer than 1/64 spacing
    to swap at all.
    """
    if ntemps == 1:
        return np.ones(1)
    return np.exp(np.linspace(0.0, -np.log(tmax), ntemps))


def evidence_beta_ladder(ntemps: int, bmin: float = 1e-3):
    """Beta ladder for evidence estimation: geometric rungs from 1 down to
    ``bmin`` and an explicit ``beta = 0`` rung that samples the prior."""
    if ntemps < 3:
        raise ValueError("evidence ladder needs >= 3 rungs (1 ... bmin, 0)")
    geo = np.exp(np.linspace(0.0, np.log(bmin), ntemps - 1))
    return np.concatenate([geo, [0.0]])


def ladder_from_sigma(sigmas, betas_old, ntemps: int, delta: float = 1.0):
    """A beta ladder sized from per-rung std(lnL) measurements.

    Integrates down from beta = 1 with spacing ``delta / sigma(beta)``,
    ``sigma(beta)`` interpolated as ``u(beta) / beta`` with ``u = sigma *
    beta`` (about constant for Gaussian-like posteriors), each spacing
    clamped to the geometric default ladder's rung and kept strictly
    decreasing.  ``delta = sqrt(-ln(target))`` targets a swap acceptance
    of about ``target``.
    """
    betas_old = np.asarray(betas_old, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    u = sigmas * betas_old
    geo = default_beta_ladder(ntemps)
    out = [1.0]
    for k in range(ntemps - 1):
        b = out[-1]
        u_b = float(np.interp(b, betas_old[::-1], u[::-1]))
        sig = max(u_b, 1e-3 * b) / b
        nb = b - delta / sig
        nb = max(nb, geo[k + 1])
        nb = min(nb, b * (1.0 - 1e-4))
        out.append(nb)
    return np.asarray(out, np.float64)


def batched_like_prior(fns):
    """``like_prior(thetas) -> (lnL, lnprior)`` per walker of a flat
    ``(n, dim)`` batch: the split the tempered samplers temper.

    A posterior's own ``log_likelihood_prior_batch`` where it has one
    (:class:`~psfmc_tpu_torch.models.posterior.PosteriorFns` and the joint
    posterior: the JAX package's split on the same path); else, with a
    ``log_prior_batch``, ``lnpost - lnprior`` where the prior is finite and
    ``-inf`` elsewhere; else ``(lnpost, 0)`` (tempering then acts on the
    whole posterior).
    """
    split = getattr(fns, "log_likelihood_prior_batch", None)
    if split is not None:
        return split
    prior = getattr(fns, "log_prior_batch", None)
    if prior is None:
        def like_prior(thetas):
            post = fns.log_posterior_batch(thetas)
            return post, torch.zeros_like(post)

        return like_prior

    def like_prior(thetas):
        lp = prior(thetas)
        post = fns.log_posterior_batch(thetas)
        return torch.where(torch.isfinite(lp), post - lp,
                           torch.full_like(lp, -math.inf)), lp

    return like_prior


class GeneratorDraws:
    """The random draws of a step, each from one ``torch.Generator``."""

    def __init__(self, generator, device):
        self.generator = generator
        self.device = device

    def uniform(self, shape, dtype):
        return torch.rand(shape, dtype=dtype, generator=self.generator,
                          device=self.device)

    def randint(self, high, shape):
        return torch.randint(0, high, shape, generator=self.generator,
                             device=self.device)

    def normal(self, shape, dtype):
        return torch.randn(shape, dtype=dtype, generator=self.generator,
                           device=self.device)


def _kahan_add(s, c, v):
    """Compensated add: ``(s', c')`` with ``s' - c'`` the exact sum."""
    y = v - c
    t = s + y
    return t, (t - s) - y


def _temper(b, lnl):
    """``b * lnl``, at ``b = 0`` exactly 0 for a finite ``lnl`` and
    ``-inf`` otherwise (never the NaN of ``0 * -inf``)."""
    return torch.where(
        b > 0, b * lnl,
        torch.where(torch.isfinite(lnl), torch.zeros_like(lnl),
                    torch.full_like(lnl, -math.inf)))


def pt_update(active_pos, active_lnl, active_lnp, comp_pos, like_prior_batch,
              betas, a, dim, partner, u_accept, u=None, shift=None,
              u_jump=None, normal=None, use_de=None, gamma0=None):
    """One tempered half-ensemble update of every rung, its draws given.

    ``active_pos`` is ``(ntemps, k, dim)`` with its untempered lnL and
    log-prior ``(ntemps, k)``, ``comp_pos`` ``(ntemps, m, dim)``, ``betas``
    ``(ntemps,)``; each draw is ``(ntemps, k)``.  The move is the stretch
    move when only ``u`` is given, differential evolution when ``shift``,
    ``u_jump`` and ``normal`` are given without ``u`` (``gamma0`` its
    scale), and with all of them the one ``use_de`` (a boolean tensor)
    picks, both proposals formed from the same ``partner``.  Every
    proposal is evaluated in one ``like_prior_batch`` call of ``ntemps *
    k`` walkers and accepted on ``lnprior + beta * lnL``.  Returns
    ``(new_pos, new_lnl, new_lnp, accepted)``.
    """
    if shift is None:
        proposal, log_extra = _stretch_proposal(active_pos, comp_pos, a, dim,
                                                u, partner)
    else:
        proposal, log_extra = _de_proposal(active_pos, comp_pos, gamma0,
                                           partner, shift, u_jump, normal)
        if u is not None:
            st_prop, st_extra = _stretch_proposal(active_pos, comp_pos, a, dim,
                                                  u, partner)
            proposal = torch.where(use_de, proposal, st_prop)
            log_extra = torch.where(use_de, log_extra, st_extra)
    ntemps, k = active_pos.shape[:2]
    prop_lnl, prop_lnp = like_prior_batch(proposal.reshape(ntemps * k, -1))
    prop_lnl = prop_lnl.reshape(ntemps, k)
    prop_lnp = prop_lnp.reshape(ntemps, k)
    b = betas.to(prop_lnl.dtype)[:, None]
    log_ratio = (log_extra + (prop_lnp + _temper(b, prop_lnl))
                 - (active_lnp + _temper(b, active_lnl)))
    accept = torch.log(u_accept) < log_ratio
    return (torch.where(accept[..., None], proposal, active_pos),
            torch.where(accept, prop_lnl, active_lnl),
            torch.where(accept, prop_lnp, active_lnp),
            accept.to(torch.int64))


def swap_move(betas, pos, lnl, lnp, uniforms):
    """Replica exchange between adjacent rungs, one sweep.

    From the hottest pair ``(ntemps-2, ntemps-1)`` down to the coldest,
    each walker index swaps its two rungs' states independently when
    ``log(u) < (beta_i - beta_{i+1}) (lnL_{i+1} - lnL_i)``;
    ``uniforms[t]`` ``(nwalkers,)`` decides the ``t``-th pair swept.
    Returns ``(pos, lnl, lnp, swaps)``, ``swaps`` ``(ntemps-1,)`` the
    accepted swaps per pair.
    """
    ntemps = pos.shape[0]
    pos, lnl, lnp = (list(x.unbind(0)) for x in (pos, lnl, lnp))
    b = betas.to(lnl[0].dtype)
    swaps = [None] * (ntemps - 1)
    for t in range(ntemps - 1):
        i = ntemps - 2 - t
        log_ratio = (b[i] - b[i + 1]) * (lnl[i + 1] - lnl[i])
        do = torch.log(uniforms[t]) < log_ratio
        pos[i], pos[i + 1] = (torch.where(do[:, None], pos[i + 1], pos[i]),
                              torch.where(do[:, None], pos[i], pos[i + 1]))
        lnl[i], lnl[i + 1] = (torch.where(do, lnl[i + 1], lnl[i]),
                              torch.where(do, lnl[i], lnl[i + 1]))
        lnp[i], lnp[i + 1] = (torch.where(do, lnp[i + 1], lnp[i]),
                              torch.where(do, lnp[i], lnp[i + 1]))
        swaps[i] = do.sum()
    if ntemps > 1:
        swaps = torch.stack(swaps)
    else:
        swaps = torch.zeros(0, dtype=torch.int64, device=lnl[0].device)
    return torch.stack(pos), torch.stack(lnl), torch.stack(lnp), swaps


@dataclass
class PTState:
    """The tempered sampler's persistent buffers, updated in place."""

    positions: torch.Tensor  # (ntemps, nwalkers, dim)
    log_like: torch.Tensor  # (ntemps, nwalkers) untempered lnL
    log_prior: torch.Tensor  # (ntemps, nwalkers)
    betas: torch.Tensor  # (ntemps,) float64: the ladder in force
    accum: Dict[str, torch.Tensor]  # cold-rung running-mean images
    accum_count: torch.Tensor  # () int64
    naccept: torch.Tensor  # (ntemps, nwalkers) int64
    nswap: torch.Tensor  # (ntemps - 1,) int64 accepted swaps per pair
    # evidence accumulators, float64, retained phase only: Kahan sums
    # (s, c) of each rung's per-step mean lnL and lnL^2 (the exact sum is
    # s - c), the steps summed, and the streaming logsumexp (max, sum) of
    # dbeta * lnL at the hotter rung of each pair
    lnl_sum: torch.Tensor
    lnl_sum_c: torch.Tensor
    lnl_sq_sum: torch.Tensor
    lnl_sq_sum_c: torch.Tensor
    evid_steps: torch.Tensor  # () int64
    ss_max: torch.Tensor
    ss_sum: torch.Tensor
    moments: Optional[Dict[str, torch.Tensor]] = None  # cold rung, float64

    def clone(self):
        def copy(d):
            return None if d is None else {k: v.clone() for k, v in d.items()}

        return PTState(**{k: (copy(v) if isinstance(v, dict) or v is None
                              else v.clone())
                          for k, v in vars(self).items()})


def make_pt_step_fn(like_prior_batch, nwalkers, dim, draws, a=2.0,
                    accumulate=False, ensemble_means_fn=None, moves="stretch",
                    de_gamma0=None):
    """One tempered iteration, in place: ``step(state, record=None)``.

    Two half-ensemble updates of every rung (:func:`pt_update`), then the
    swap sweep (:func:`swap_move`).  With ``accumulate`` (the retained
    phase) the evidence accumulators take the step, and the cold rung
    alone feeds the image accumulators and the Welford moments where
    ``state`` holds buffers for them; ``record`` (as in
    :func:`~.ensemble.make_step_fn`) takes the cold rung's positions and
    lnprob.  The draws come from ``draws`` (:class:`GeneratorDraws`) in
    this order: with mixed moves one uniform ``()`` that picks the move of
    the step; per half-step, each ``(ntemps, k)``, stretch ``u``,
    ``partner``, ``u_accept``, DE ``partner``, ``shift``, ``u_jump``,
    ``normal``, ``u_accept``, mixed ``u`` and then DE's; then one uniform
    ``(nwalkers,)`` per rung pair, hottest pair first.
    """
    half = nwalkers // 2
    gamma0 = 2.38 / math.sqrt(2.0 * dim) if de_gamma0 is None else float(de_gamma0)

    def half_step(betas, use_de, pos, lnl, lnp, comp):
        shape, m, dt = pos.shape[:2], comp.shape[1], pos.dtype
        d = {}
        if moves != "de":
            d["u"] = draws.uniform(shape, dt)
        d["partner"] = draws.randint(m, shape)
        if moves != "stretch":
            d["shift"] = draws.randint(m - 1, shape)
            d["u_jump"] = draws.uniform(shape, dt)
            d["normal"] = draws.normal(shape, dt)
        d["u_accept"] = draws.uniform(shape, dt)
        return pt_update(pos, lnl, lnp, comp, like_prior_batch, betas, a, dim,
                         use_de=use_de, gamma0=gamma0, **d)

    def step(state: PTState, record=None):
        pos, lnl, lnp = state.positions, state.log_like, state.log_prior
        use_de = None
        if moves == "mixed":  # both halves of a step take the same move
            use_de = draws.uniform((), pos.dtype) < 0.5
        p0, l0, q0, acc0 = half_step(state.betas, use_de, pos[:, :half],
                                     lnl[:, :half], lnp[:, :half], pos[:, half:])
        p1, l1, q1, acc1 = half_step(state.betas, use_de, pos[:, half:],
                                     lnl[:, half:], lnp[:, half:], p0)
        state.naccept.add_(torch.cat([acc0, acc1], dim=1))
        uniforms = [draws.uniform((nwalkers,), lnl.dtype)
                    for _ in range(pos.shape[0] - 1)]
        new_pos, new_lnl, new_lnp, swaps = swap_move(
            state.betas, torch.cat([p0, p1], dim=1), torch.cat([l0, l1], dim=1),
            torch.cat([q0, q1], dim=1), uniforms)
        state.nswap.add_(swaps)
        if accumulate:
            _accumulate_evidence(state, new_lnl)
            if state.accum:
                accum, count = merge_image_accumulators(
                    state.accum, state.accum_count, ensemble_means_fn(new_pos[0]),
                    nwalkers)
                for k, v in accum.items():
                    state.accum[k].copy_(v)
                state.accum_count.copy_(count)
            if state.moments is not None:
                moments = welford_batch_update(state.moments,
                                               new_pos[0].to(torch.float64))
                for k, v in moments.items():
                    state.moments[k].copy_(v)
        pos.copy_(new_pos)
        lnl.copy_(new_lnl)
        lnp.copy_(new_lnp)
        if record is not None:
            chain_pos, chain_lnp, slot = record
            chain_pos.index_copy_(0, slot, new_pos[0][None])
            chain_lnp.index_copy_(0, slot, (new_lnp[0] + new_lnl[0])[None])
            slot.add_(1)

    return step


def _finite_std(lnl):
    """Each row's std over its finite entries (0 with fewer than two)."""
    out = np.zeros(lnl.shape[0])
    for t, row in enumerate(lnl):
        row = row[np.isfinite(row)]
        if row.size > 1:
            out[t] = np.std(row)
    return out


def _accumulate_evidence(state, lnl):
    """One retained step into the evidence accumulators, in float64."""
    lnl = lnl.to(torch.float64)
    state.evid_steps.add_(1)
    for (s, c), v in (((state.lnl_sum, state.lnl_sum_c), lnl.mean(dim=1)),
                      ((state.lnl_sq_sum, state.lnl_sq_sum_c),
                       (lnl * lnl).mean(dim=1))):
        t, c_new = _kahan_add(s, c, v)
        s.copy_(t)
        c.copy_(c_new)
    dbeta = state.betas[:-1] - state.betas[1:]
    v = dbeta[:, None] * lnl[1:]  # at the hotter rung of each pair
    new_max = torch.maximum(state.ss_max, v.amax(dim=1))
    # an empty accumulator (max -inf) contributes 0, not exp(nan)
    scale = torch.where(torch.isfinite(state.ss_max),
                        torch.exp(state.ss_max - new_max),
                        torch.zeros_like(new_max))
    state.ss_sum.copy_(state.ss_sum * scale
                       + torch.exp(v - new_max[:, None]).sum(dim=1))
    state.ss_max.copy_(new_max)


class PTEnsembleSampler(EnsembleSampler):
    """Tempered counterpart of :class:`~.ensemble.EnsembleSampler`.

    ``ntemps`` rungs of ``nwalkers`` walkers; the recorded ``chain`` /
    ``lnprobability``, the image accumulators and the moments are the
    cold (beta = 1) rung's.  ``betas=None`` sizes the ladder during burn-in
    (every adaptation window, from the measured per-rung std(lnL), with
    ``delta = sqrt(-ln(target_swap_accept))``) and freezes it for the
    retained phase; explicit ``betas`` (or ``adapt_ladder=False``) pin it.
    Diagnostics: :attr:`swap_acceptance_fraction` per rung pair,
    :attr:`tempered_acceptance_fraction` per rung, and the evidence
    (:meth:`log_evidence`).  ``a``, ``seed``, ``device``,
    ``track_moments``, ``moves`` and ``sharding`` as the ensemble
    sampler's: under a mesh every rung's walkers, flattened rung-major
    into one batch, are split over the ranks and the ladder is held by
    every rank.
    """

    # stretch-family state: interchangeable with plain ensemble checkpoints
    checkpoint_kind = "ensemble"

    def __init__(self, nwalkers: int, dim: int, posterior_fns, ntemps: int = 4,
                 betas=None, a: float = 2.0, seed: int = 0, device=None,
                 track_moments: bool = False, adapt_ladder=None,
                 target_swap_accept: float = 0.3, moves: str = "stretch",
                 sharding=None):
        self.ntemps = int(ntemps)
        self.adapt_ladder = ((betas is None) if adapt_ladder is None
                             else bool(adapt_ladder))
        self.target_swap_accept = float(target_swap_accept)
        betas = np.asarray(default_beta_ladder(self.ntemps) if betas is None
                           else betas, np.float64)
        if betas.shape != (self.ntemps,):
            raise ValueError(f"betas has {betas.size} rungs, ntemps={self.ntemps}")
        if betas[0] != 1.0:
            raise ValueError("betas[0] must be 1.0 (the cold chain)")
        self._betas = betas
        self._adapt_t = 0  # adaptation windows completed
        self._u_ema = None  # EMA of sigma(lnL) * beta per rung
        super().__init__(nwalkers, dim, posterior_fns, a=a, seed=seed,
                         device=device, track_moments=track_moments, moves=moves,
                         sharding=sharding)
        self._like_prior = batched_like_prior(self.fns)
        self._draws = GeneratorDraws(self.generator, self.device)

    @property
    def betas(self):
        """The ladder in force (float64 numpy); setting it writes the
        device buffer in place, so no step graph is captured anew."""
        return self._betas

    @betas.setter
    def betas(self, value):
        self._betas = np.asarray(value, np.float64)
        if self.state is not None:
            self.state.betas.copy_(torch.as_tensor(self._betas))

    # -- state -----------------------------------------------------------
    def _rungs(self, p):
        """``(ntemps, nwalkers, dim)`` walkers from ``p``, that shape or
        one ``(nwalkers, dim)`` ensemble given to every rung."""
        p = torch.as_tensor(p, dtype=self.dtype, device=self.device)
        if p.ndim == 2:
            p = self._walkers(p).expand(self.ntemps, -1, -1)
        shape = (self.ntemps, self.nwalkers, self.dim)
        if tuple(p.shape) != shape:
            raise ValueError(f"p0 must be {shape} or {shape[1:]}, got "
                             f"{tuple(p.shape)}")
        return p

    def _evaluate(self, p):
        lnl, lnp = self._like_prior(p.reshape(self.ntemps * self.nwalkers, self.dim))
        return lnl.reshape(self.ntemps, self.nwalkers), lnp.reshape(
            self.ntemps, self.nwalkers)

    def init_state(self, p0):
        """Set every rung to ``p0`` (``(nwalkers, dim)``, broadcast to every
        rung, or ``(ntemps, nwalkers, dim)``), evaluate it in one batched
        call, and zero the counts and accumulators; the first call
        allocates the buffers, later calls write into them."""
        p0 = self._rungs(p0)
        lnl, lnp = self._evaluate(p0)
        if self.state is not None:
            s = self.state
            s.positions.copy_(p0)
            s.log_like.copy_(lnl)
            s.log_prior.copy_(lnp)
            s.betas.copy_(torch.as_tensor(self._betas))
            self._zero_counters()
            return self.state
        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        nt, npair = self.ntemps, self.ntemps - 1
        moments = None
        if self.track_moments:
            moments = {"mean": torch.zeros(self.dim, **f64),
                       "m2": torch.zeros(self.dim, **f64),
                       "n": torch.zeros((), **i64)}
        self.state = PTState(
            positions=p0.clone(), log_like=lnl.clone(), log_prior=lnp.clone(),
            betas=torch.tensor(self._betas, **f64),
            accum=fresh_image_accumulators(self.fns, dev),
            accum_count=torch.zeros((), **i64),
            naccept=torch.zeros((nt, self.nwalkers), **i64),
            nswap=torch.zeros(npair, **i64),
            lnl_sum=torch.zeros(nt, **f64), lnl_sum_c=torch.zeros(nt, **f64),
            lnl_sq_sum=torch.zeros(nt, **f64), lnl_sq_sum_c=torch.zeros(nt, **f64),
            evid_steps=torch.zeros((), **i64),
            ss_max=torch.full((npair,), -math.inf, **f64),
            ss_sum=torch.zeros(npair, **f64), moments=moments)
        return self.state

    def _zero_counters(self):
        super()._zero_counters()
        s = self.state
        for v in (s.nswap, s.lnl_sum, s.lnl_sum_c, s.lnl_sq_sum, s.lnl_sq_sum_c,
                  s.evid_steps, s.ss_sum):
            v.zero_()
        s.ss_max.fill_(-math.inf)

    def _reseat(self, p):
        p = self._rungs(p)
        lnl, lnp = self._evaluate(p)
        self.state.positions.copy_(p)
        self.state.log_like.copy_(lnl)
        self.state.log_prior.copy_(lnp)

    def rejuvenate_stuck(self, random_state=None, floor_sigmas=20.0,
                         min_drop=50.0):
        """Per-rung burn-phase walker rescue (see
        :meth:`EnsembleSampler.rejuvenate_stuck`): each rung's floor is
        taken on its own tempered posterior ``beta * lnL + lnprior`` and
        its stranded walkers take the positions of healthy walkers of the
        same rung; every rung is then re-evaluated in one batched call.

        :returns: the number of walkers moved, over all rungs.
        """
        rng = (random_state if isinstance(random_state, np.random.RandomState)
               else np.random.RandomState(random_state))
        lnl = _host(self.state.log_like)
        lpr = _host(self.state.log_prior)
        lnp = self._betas[:, None] * lnl + lpr
        pos = _host(self.state.positions)
        total = 0
        for t in range(self.ntemps):
            row = lnp[t]
            finite = np.isfinite(row)
            if not finite.any():
                continue
            med = np.median(row[finite])
            mad = np.median(np.abs(row[finite] - med))
            floor = med - max(float(min_drop), float(floor_sigmas) * 1.4826 * mad)
            stuck = ~finite | (row < floor)
            n_stuck = int(stuck.sum())
            if n_stuck == 0 or n_stuck >= self.nwalkers // 2:
                continue
            donors = rng.choice(np.flatnonzero(~stuck), size=n_stuck)
            pos[t, stuck] = pos[t, donors]
            total += n_stuck
        if total:
            self._reseat(pos)
        return total

    def _cold_naccept(self):
        return self.state.naccept[0]

    def _step_fn(self, accumulate):
        fn = self._steps.get(accumulate)
        if fn is None:
            fn = self._steps[accumulate] = make_pt_step_fn(
                self._like_prior, self.nwalkers, self.dim, self._draws,
                a=self.a, accumulate=accumulate, ensemble_means_fn=self._means_fn,
                moves=self.moves, de_gamma0=self.de_gamma0)
        return fn

    # -- phases ----------------------------------------------------------
    def run_burn(self, nsteps: int, segment=None, callback=None):
        """Burn-in, with ladder adaptation when enabled.

        In windows of ``max(5, min(nsteps // 12, 250))`` steps (``nsteps //
        2`` below 60 steps); after each window but the last the ladder is
        re-sized from a geometric EMA of the measured ``sigma(lnL) *
        beta`` per rung, and ``callback(done, nsteps)`` runs after every
        window (``segment`` is then not used).  Without adaptation (or
        below 10 steps) this is the ensemble sampler's burn-in.

        Each rung's ``sigma(lnL)`` is taken over its walkers of finite lnL
        (a deliberate divergence: the JAX package's ``np.std`` over every
        walker makes the ladder NaN, for good, as soon as one walker's lnL
        is ``-inf``, e.g. a Sersic whose profile overflows).
        """
        if not (self.adapt_ladder and self.ntemps > 1) or nsteps < 10:
            return super().run_burn(nsteps, segment=segment, callback=callback)
        window = max(5, min(nsteps // 12 if nsteps >= 60 else nsteps // 2, 250))
        delta = float(np.sqrt(-np.log(self.target_swap_accept)))
        done = 0
        while done < nsteps:
            n = min(window, nsteps - done)
            super().run_burn(n)
            done += n
            if done < nsteps:
                sig = _finite_std(_host(self.state.log_like))
                u = np.maximum(sig, 1e-6) * self._betas
                if self._u_ema is None:
                    self._u_ema = u
                else:
                    self._u_ema = np.exp(0.4 * np.log(self._u_ema)
                                         + 0.6 * np.log(u))
                self.betas = ladder_from_sigma(self._u_ema / self._betas,
                                               self._betas, self.ntemps,
                                               delta=delta)
                self._adapt_t += 1
            if callback is not None:
                callback(done, nsteps)
        return self

    # -- checkpoint / resume -----------------------------------------------
    def checkpoint_payload(self):
        """Full resume state of every rung (checkpoint v2): positions,
        accept and swap counts, the ladder, the generator's state, the
        cold rung's image accumulators, and the evidence accumulators
        with each Kahan sum stored exact (``s - c``)."""
        s = self.state
        return {
            "version": 2,
            "ntemps": self.ntemps,
            "positions": _host(s.positions),
            "log_prob": _host(s.log_prior)[0] + _host(s.log_like)[0],
            "naccept": _host(s.naccept, torch.int64),
            "nsteps": int(self._nsteps_total),
            "nswap": _host(s.nswap, torch.int64),
            "betas": self._betas.copy(),
            "rng_kind": self.rng_kind,
            "rng_state": self.generator.get_state().numpy().copy(),
            "accum": {k: _host(v, v.dtype) for k, v in s.accum.items()},
            "accum_count": int(s.accum_count),
            "lnl_sum": _host(s.lnl_sum) - _host(s.lnl_sum_c),
            "lnl_sq_sum": _host(s.lnl_sq_sum) - _host(s.lnl_sq_sum_c),
            "evid_steps": int(s.evid_steps),
            "ss_max": _host(s.ss_max),
            "ss_sum": _host(s.ss_sum),
        }

    def restore_state(self, payload):
        """Rebuild the state from a checkpoint payload, in the buffers.

        A payload with this ``ntemps`` restores every rung, the ladder in
        force when it was written (a restored ladder is not adapted
        again), the swap counts and the evidence accumulators; a plain
        sampler's payload, or a tempered one with another ``ntemps``
        (which warns), gives its cold positions to every rung.  Raises
        ``ValueError`` for a checkpoint whose generator is not this
        sampler's kind.
        """
        self._check_rng_kind(payload)
        positions = np.asarray(payload["positions"], np.float64)
        full = positions.ndim == 3 and int(payload.get("ntemps", 1)) == self.ntemps
        if not full and positions.ndim == 3:
            warnings.warn(
                f"checkpoint has {payload.get('ntemps')} tempering rungs "
                f"but ntemps={self.ntemps} was requested; hot rungs "
                "restart from the cold-rung positions")
            positions = positions[0]
        betas = payload.get("betas")
        if full and betas is not None and np.shape(betas) == (self.ntemps,):
            self._betas = np.asarray(betas, np.float64)
            self._adapt_t = max(self._adapt_t, 1)
        self.init_state(positions)
        self.generator.set_state(torch.as_tensor(
            np.asarray(payload["rng_state"], np.uint8)))
        restore_image_accumulators(self.state.accum, self.state.accum_count, payload)
        s = self.state
        naccept = np.asarray(payload.get("naccept", 0), np.int64)
        if naccept.shape == (self.ntemps, self.nwalkers):
            s.naccept.copy_(torch.as_tensor(naccept))
        nswap = payload.get("nswap")
        if full and nswap is not None and np.shape(nswap) == (self.ntemps - 1,):
            s.nswap.copy_(torch.as_tensor(np.asarray(nswap, np.int64)))
        if full and payload.get("lnl_sum") is not None and np.shape(
                payload["lnl_sum"]) == (self.ntemps,):
            for name in ("lnl_sum", "lnl_sq_sum", "ss_max", "ss_sum"):
                getattr(s, name).copy_(torch.as_tensor(
                    np.asarray(payload[name], np.float64)))
            s.evid_steps.fill_(int(payload.get("evid_steps", 0)))
        if naccept.ndim == 2:
            naccept = naccept[0]
        if naccept.shape == (self.nwalkers,):
            self._naccept = naccept.copy()
            self._nsteps_total = int(payload.get("nsteps", 0))
        return self.state

    # -- diagnostics -------------------------------------------------------
    @property
    def tempered_acceptance_fraction(self):
        """``(ntemps, nwalkers)`` move acceptance per rung."""
        return _host(self.state.naccept) / max(self._nsteps_total, 1)

    @property
    def swap_acceptance_fraction(self):
        """``(ntemps - 1,)`` replica-swap acceptance per adjacent pair."""
        return _host(self.state.nswap) / (max(self._nsteps_total, 1) * self.nwalkers)

    def _evid_means(self):
        s = self.state
        t = max(int(s.evid_steps), 1)
        return ((_host(s.lnl_sum) - _host(s.lnl_sum_c)) / t,
                (_host(s.lnl_sq_sum) - _host(s.lnl_sq_sum_c)) / t)

    @property
    def rung_log_like_mean(self):
        """``(ntemps,)`` mean untempered lnL per rung, retained phase."""
        return self._evid_means()[0]

    @property
    def rung_log_like_std(self):
        """``(ntemps,)`` std of the untempered lnL per rung, retained phase."""
        m, sq = self._evid_means()
        return np.sqrt(np.maximum(sq - m * m, 0.0))

    def log_evidence(self, method: str = "auto"):
        """Marginal likelihood ``(lnZ, dlnZ)`` from the retained phase.

        ``'stepping-stone'`` (``'ss'``; Xie et al. 2011): lnZ = sum_k ln
        E_{beta_{k+1}}[L^(beta_k - beta_{k+1})], from the streaming
        logsumexps; needs a ladder reaching beta = 0
        (:func:`evidence_beta_ladder`).  ``'ti'``: thermodynamic
        integration, the trapezoid of the per-rung mean lnL over beta,
        with a rectangle for ``[0, beta_min]`` when the ladder stops
        short (whose whole size is counted as error).  ``'auto'``:
        stepping-stone when the ladder reaches 0, else TI.  The error is
        ``|SS - TI|`` for stepping-stone, the half-ladder quadrature
        difference for TI.  Warns when a pair's ``|dbeta| * std(lnL)``
        exceeds 4 (an under-resolved ladder).
        """
        if self.ntemps < 3:
            raise ValueError("evidence estimation needs ntemps >= 3")
        nsteps = int(self.state.evid_steps)
        if nsteps == 0:
            raise RuntimeError(
                "no retained samples accumulated; run_sampling() first "
                "(burn-in does not feed the evidence accumulators)")
        betas = self._betas
        mean_lnl = self.rung_log_like_mean
        reaches_prior = betas[-1] == 0.0
        trapezoid = getattr(np, "trapezoid", None) or np.trapz

        def _ti(bs, ms):
            lnz = -float(trapezoid(ms, bs))  # betas descend
            if bs[-1] > 0:
                lnz += float(bs[-1] * ms[-1])
            return lnz

        idx = list(range(0, len(betas), 2))
        if idx[-1] != len(betas) - 1:
            idx.append(len(betas) - 1)
        lnz_ti = _ti(betas, mean_lnl)
        err_ti = abs(lnz_ti - _ti(betas[idx], mean_lnl[idx]))
        if betas[-1] > 0:
            err_ti += abs(float(betas[-1] * mean_lnl[-1]))

        sig = self.rung_log_like_std
        pair_width = np.abs(np.diff(betas)) * np.maximum(sig[:-1], sig[1:])
        if np.max(pair_width) > 4.0:
            warnings.warn(
                "evidence ladder under-resolved: max |dbeta|*std(lnL) = "
                f"{np.max(pair_width):.1f} (want O(1)); increase ntemps "
                f"to ~{int(np.ceil(np.sum(pair_width))) + 2} rungs "
                "(rungs are a batch axis — cost is ~linear)")

        if method == "auto":
            method = "stepping-stone" if reaches_prior else "ti"
        if method in ("stepping-stone", "ss"):
            if not reaches_prior:
                raise ValueError(
                    "stepping-stone needs a ladder reaching beta=0; use "
                    "betas=evidence_beta_ladder(ntemps) (or method='ti')")
            n = nsteps * self.nwalkers
            ln_r = _host(self.state.ss_max) + np.log(_host(self.state.ss_sum)) - np.log(n)
            lnz = float(np.sum(ln_r))
            return lnz, abs(lnz - lnz_ti)
        if method == "ti":
            return lnz_ti, err_ti
        raise ValueError(f"unknown evidence method {method!r}")
