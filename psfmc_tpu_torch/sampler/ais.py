"""Annealed importance sampling (AIS) evidence (port of ``sampler/ais.py``).

The tempered estimators need a ladder resolved to ``|dbeta| * std(lnL) =
O(1)`` per pair, hundreds of rungs for a 128x128 imaging likelihood; AIS
(Neal 2001) anneals beta over time instead: a batch of walkers starts at
exact prior draws (beta = 0) and follows a fine schedule to the posterior
(beta = 1), folding the weight increment ``dbeta_t * lnL(x_t)`` into a
running evidence.  As in the JAX package it is a full SMC sampler (Del
Moral, Doucet & Jasra 2006): a group whose weight ESS falls below
``resample_threshold * m`` is resampled systematically (one stratified
uniform per group; Douc et al. 2005).  Walkers are split into
independent groups, the rung axis of :func:`~.tempered.pt_update` taking
the part of the group axis; the group-to-group scatter is the error bar.

Under a mesh (``mesh=``) the group axis is split over the processes, the
state held by every one (:mod:`psfmc_tpu_torch.parallel.mesh`).

On CUDA each anneal step is one replay of a captured graph: the schedule
is a device tensor indexed by a device step counter the graph advances,
the resampling is a ``torch.where`` on the groups' ``need`` mask, and
nothing is fetched until the anneal ends.  The weights, the running
evidence and the ESS are float64 on every device (the JAX package keeps
them in the posterior's dtype).

Per step the draws are taken from the generator in this order: one
uniform ``(groups, 1)`` for the resampling (made every step, as the JAX
package makes its key), then per sweep the draws of
:func:`~.tempered.make_pt_step_fn`'s two half-steps (with mixed moves
the move's uniform first).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional
from warnings import warn

import numpy as np
import torch

from ..parallel.mesh import check_mesh, walker_sharding
from ..parallel.posterior import shard_posterior
from .ensemble import MOVES, _host, capture_step
from .tempered import GeneratorDraws, batched_like_prior, pt_update

__all__ = ["AISResult", "ais_evidence", "ais_beta_schedule", "AISState",
           "make_ais_step_fn", "run_ais"]


def ais_beta_schedule(nsteps: int, power: float = 4.0):
    """``(nsteps + 1,)`` annealing schedule 0 -> 1, ``beta_t = (t/T)^power``."""
    t = np.arange(nsteps + 1, dtype=np.float64) / nsteps
    return t**power


@dataclass
class AISResult:
    """Outcome of :func:`ais_evidence`."""

    lnz: float  # log evidence (mean of the per-group log-estimates)
    err: float  # group-to-group standard error of lnz
    lnz_groups: np.ndarray  # (groups,) per-group estimates
    # worst pre-resample weight ESS over the anneal, summed over groups
    ess: float
    nwalkers: int
    nsteps: int
    accept_fraction: float  # mean move acceptance over the anneal
    nresample: int = 0  # resampling events summed over groups
    graph_replays: int = 0  # anneal steps run as replays of a captured graph


@dataclass
class AISState:
    """The anneal's persistent buffers, updated in place."""

    positions: torch.Tensor  # (groups, m, dim)
    log_like: torch.Tensor  # (groups, m)
    log_prior: torch.Tensor  # (groups, m)
    lnw: torch.Tensor  # (groups, m) float64 normalized log-weights
    lnz: torch.Tensor  # (groups,) float64
    ess_min: torch.Tensor  # (groups,) float64 worst pre-resample ESS
    naccept: torch.Tensor  # () int64
    nresample: torch.Tensor  # () int64
    schedule: torch.Tensor  # (T + 1,) float64
    t: torch.Tensor  # (1,) int64: steps taken

    def clone(self):
        return AISState(**{k: v.clone() for k, v in vars(self).items()})


def make_ais_step_fn(like_prior_batch, draws, a=2.0, sweeps=1,
                     resample_threshold=0.5, moves="stretch"):
    """One anneal step, in place: ``step(state)``.

    From ``beta_t`` to ``beta_{t+1}`` of ``state.schedule`` (``t`` the
    state's counter): (1) fold ``dbeta * lnL`` into each group's evidence
    through its normalized weights, (2) resample a group systematically
    where its pre-resample ESS is below ``resample_threshold * m``, (3)
    move every walker by ``sweeps`` tempered sweeps at the new beta
    (:func:`~.tempered.pt_update`, groups on the rung axis).
    """
    def step(state: AISState):
        pos, lnl, lnp = state.positions, state.log_like, state.log_prior
        groups, m, dim = pos.shape
        half = m // 2
        gamma0 = 2.38 / math.sqrt(2.0 * dim)
        pair = state.schedule.index_select(0, torch.cat([state.t, state.t + 1]))
        u = (pair[1] - pair[0]) * lnl.to(torch.float64)
        s = torch.logsumexp(state.lnw + u, dim=1)
        lnz = state.lnz + s
        lnw = state.lnw + u - s[:, None]

        ess = torch.exp(-torch.logsumexp(2.0 * lnw, dim=1))
        state.ess_min.copy_(torch.minimum(state.ess_min, ess))
        need = ess < resample_threshold * m
        cdf = torch.cumsum(torch.exp(lnw), dim=1)
        cdf = cdf / cdf[:, -1:]
        u0 = draws.uniform((groups, 1), torch.float64)
        pts = (u0 + torch.arange(m, dtype=torch.float64, device=pos.device)[None, :]) / m
        idx = torch.clamp(torch.searchsorted(cdf, pts, right=True), max=m - 1)
        pos = torch.where(need[:, None, None],
                          torch.take_along_dim(pos, idx[:, :, None], dim=1), pos)
        lnl = torch.where(need[:, None], torch.take_along_dim(lnl, idx, dim=1), lnl)
        lnp = torch.where(need[:, None], torch.take_along_dim(lnp, idx, dim=1), lnp)
        lnw = torch.where(need[:, None], torch.full_like(lnw, -math.log(m)), lnw)
        state.nresample.add_(need.sum())

        bvec = pair[1].expand(groups)
        dt = pos.dtype
        for _ in range(sweeps):
            use_de = None
            if moves == "mixed":
                use_de = draws.uniform((), dt) < 0.5
            halves = []
            for active, comp in ((slice(0, half), slice(half, m)),
                                 (slice(half, m), None)):
                comp_pos = pos[:, comp] if comp is not None else halves[0][0]
                shape = (groups, half)
                d = {}
                if moves != "de":
                    d["u"] = draws.uniform(shape, dt)
                d["partner"] = draws.randint(comp_pos.shape[1], shape)
                if moves != "stretch":
                    d["shift"] = draws.randint(comp_pos.shape[1] - 1, shape)
                    d["u_jump"] = draws.uniform(shape, dt)
                    d["normal"] = draws.normal(shape, dt)
                d["u_accept"] = draws.uniform(shape, dt)
                halves.append(pt_update(pos[:, active], lnl[:, active],
                                        lnp[:, active], comp_pos, like_prior_batch,
                                        bvec, a, dim, use_de=use_de,
                                        gamma0=gamma0, **d))
            (q0, l0, r0, acc0), (q1, l1, r1, acc1) = halves
            pos = torch.cat([q0, q1], dim=1)
            lnl = torch.cat([l0, l1], dim=1)
            lnp = torch.cat([r0, r1], dim=1)
            state.naccept.add_(acc0.sum() + acc1.sum())
        state.positions.copy_(pos)
        state.log_like.copy_(lnl)
        state.log_prior.copy_(lnp)
        state.lnw.copy_(lnw)
        state.lnz.copy_(lnz)
        state.t.add_(1)

    return step


def run_ais(like_prior_batch, p0, schedule, generator, a=2.0, sweeps=1,
            resample_threshold=0.5, moves="stretch", graphed=None):
    """The anneal over ``schedule`` (``(T + 1,)`` ascending 0 -> 1) from
    ``p0`` ``(groups, m, dim)``, exact prior draws, on ``p0``'s device.

    On CUDA (unless ``graphed=False``) every step is a replay of one
    captured graph; elsewhere the step function runs eagerly on the same
    buffers.  Returns the final :class:`AISState` and the number of
    steps run as graph replays.
    """
    groups, m, dim = p0.shape
    dev = p0.device
    f64 = dict(dtype=torch.float64, device=dev)
    lnl, lnp = like_prior_batch(p0.reshape(groups * m, dim))
    state = AISState(
        positions=p0.clone(), log_like=lnl.reshape(groups, m),
        log_prior=lnp.reshape(groups, m),
        lnw=torch.full((groups, m), -math.log(m), **f64),
        lnz=torch.zeros(groups, **f64),
        ess_min=torch.full((groups,), float(m), **f64),
        naccept=torch.zeros((), dtype=torch.int64, device=dev),
        nresample=torch.zeros((), dtype=torch.int64, device=dev),
        schedule=torch.as_tensor(np.asarray(schedule, np.float64), **f64),
        t=torch.zeros(1, dtype=torch.int64, device=dev))
    step = make_ais_step_fn(like_prior_batch, GeneratorDraws(generator, dev), a=a,
                            sweeps=sweeps, resample_threshold=resample_threshold,
                            moves=moves)
    nsteps = state.schedule.shape[0] - 1
    if graphed is None:
        graphed = dev.type == "cuda"
    if not graphed:
        for _ in range(nsteps):
            step(state)
        return state, 0
    stream = torch.cuda.Stream(dev)
    graph = capture_step(step, (state,), (state.clone(),), generator, stream,
                         torch.cuda.graph_pool_handle())
    for _ in range(nsteps):
        graph.replay()
    return state, nsteps


def ais_evidence(posterior_fns, nwalkers: int = 256, nsteps: int = 2000,
                 groups: int = 4, sweeps: int = 1, power: float = 4.0,
                 schedule=None, seed: int = 0, p0: Optional[np.ndarray] = None,
                 a: float = 2.0, resample_threshold: float = 0.5,
                 moves: str = "mixed", mesh=None):
    """Marginal likelihood by annealed importance sampling (SMC).

    :param posterior_fns: a posterior with a ``log_prior_batch``
        decomposition (AIS anchors at the normalized prior), on its
        device; the anneal runs there.
    :param nwalkers: total walkers, split into ``groups`` independent
        groups of ``nwalkers // groups`` (rounded down to even, at least
        4).  Imaging posteriors need 64 or more a group: fewer leave whole
        groups stranded in the no-source mode, which the group spread
        flags (a warning above 3 lnZ units).
    :param nsteps: annealing steps (many more than std(lnL)).
    :param schedule: explicit ``(T + 1,)`` ascending beta array from 0 to
        1; overrides ``power`` (``beta_t = (t/T)^power``).
    :param p0: ``(nwalkers, dim)`` exact prior draws; ``None`` draws them
        from the priors, rejection-sampling the joint constraints.  Rows
        outside the prior's support raise.
    :param moves: ``"mixed"`` (the default: stretch and differential
        evolution), ``"stretch"`` or ``"de"``.
    :param mesh: optional :func:`~psfmc_tpu_torch.parallel.walker_mesh`:
        the GROUP axis is split over it (each rank evaluates its
        ``groups / size`` groups' walkers; the state is held by every
        rank); ``groups`` must be a multiple of its size.  The anneal runs
        on the mesh's device, graphed where the mesh's steps are.
    :returns: :class:`AISResult`; warns when the groups disagree or the
        weights degenerate (acceptance below 5% or a group's ESS below 5%
        of its walkers), as the JAX package does.
    """
    fns = posterior_fns
    check_mesh(mesh)
    if getattr(fns, "log_prior_batch", None) is None:
        raise ValueError(
            "ais_evidence needs a posterior with a log_prior "
            "decomposition (AIS anchors at the normalized prior)")
    if groups < 2:
        raise ValueError(
            "need groups >= 2: the error bar is the group-to-group "
            "scatter (a single group has no dispersion estimate)")
    m = nwalkers // groups
    m -= m % 2
    if m < 4:
        raise ValueError(
            f"nwalkers={nwalkers} over groups={groups} leaves {m} "
            "walkers/group; need >= 4 (and even) for stretch moves")
    nwalkers = m * groups
    if schedule is None:
        schedule = ais_beta_schedule(nsteps, power=power)
    schedule = np.asarray(schedule, np.float64)
    if schedule[0] != 0.0 or schedule[-1] != 1.0 or np.any(np.diff(schedule) < 0):
        raise ValueError("schedule must ascend from 0 to 1")
    nsteps = len(schedule) - 1
    if moves not in MOVES:
        raise ValueError(f"unknown moves {moves!r}: expected 'stretch', 'de' or 'mixed'")

    def prior(p):
        return _host(fns.log_prior_batch(torch.as_tensor(p, dtype=fns.dtype,
                                                         device=fns.device)))

    if p0 is None:
        from ..optimize import _prior_pool

        rng = np.random.RandomState(seed)
        p0 = _prior_pool(fns.spec, nwalkers, rng)
        lp = prior(p0)
        tries = 0
        while not np.all(np.isfinite(lp)) and tries < 100:
            bad = ~np.isfinite(lp)
            p0[bad] = _prior_pool(fns.spec, int(bad.sum()), rng)
            lp = prior(p0)
            tries += 1
        if not np.all(np.isfinite(lp)):
            raise RuntimeError(
                "could not draw in-support prior samples after 100 "
                "rejection rounds; check the joint prior constraints")
    else:
        p0 = np.asarray(p0, np.float64)
        n_bad = int(np.sum(~np.isfinite(prior(p0))))
        if n_bad:
            raise ValueError(
                f"{n_bad}/{len(p0)} rows of p0 are outside the prior "
                "support; AIS anchors at the normalized prior, so p0 "
                "must be an exact constrained-prior draw (pass p0=None "
                "to let ais_evidence rejection-sample one)")
    p0 = np.asarray(p0, np.float64)[:nwalkers].reshape(groups, m, -1)

    graphed = None
    if mesh is not None:
        if groups % mesh.size != 0:
            raise ValueError(
                f"groups={groups} must be a multiple of the mesh size "
                f"({mesh.size}) to shard the group axis")
        if torch.device(fns.device) != mesh.device:
            raise ValueError(f"posterior is on {fns.device}, the mesh on {mesh.device}")
        # every half-step's batch is group-major: a split of its rows into
        # whole groups is a split of the group axis
        fns = shard_posterior(fns, walker_sharding(mesh))
        graphed = mesh.graphed
    generator = torch.Generator(device=fns.device)
    generator.manual_seed(int(seed))
    state, replays = run_ais(batched_like_prior(fns),
                             torch.as_tensor(p0, dtype=fns.dtype, device=fns.device),
                             schedule, generator, a=a, sweeps=sweeps,
                             resample_threshold=resample_threshold, moves=moves,
                             graphed=graphed)
    lnz_g = _host(state.lnz)
    ess_min = _host(state.ess_min)
    nacc = int(state.naccept)
    nres = int(state.nresample)

    lnz = float(np.mean(lnz_g))
    err = float(np.std(lnz_g, ddof=1) / np.sqrt(groups))
    ess = float(np.sum(ess_min))
    accept = float(nacc) / (nsteps * sweeps * nwalkers)

    group_spread = float(np.std(lnz_g, ddof=1))
    if group_spread > 3.0:
        warn(
            f"AIS group estimates disagree by {group_spread:.1f} lnZ "
            f"units (want O(1)): groups are likely stranded in "
            f"different posterior modes.  Increase walkers per group "
            f"(currently {m}; imaging posteriors need >= 64) or "
            "sweeps=; do NOT trust the averaged lnz.")
    min_group_ess = float(np.min(ess_min))
    if accept < 0.05 or min_group_ess < 0.05 * m:
        warn(
            "AIS transitions are under-mixing (acceptance "
            f"{accept:.1%}, worst pre-resample group ESS "
            f"{min_group_ess:.1f}/{m}): importance weights are "
            "degenerate and lnz is likely biased LOW with an "
            "overconfident error bar.  Increase nsteps, use "
            "moves='mixed', or verify across seeds.")
    return AISResult(lnz=lnz, err=err, lnz_groups=lnz_g, ess=ess,
                     nwalkers=nwalkers, nsteps=nsteps, accept_fraction=accept,
                     nresample=nres, graph_replays=replays)
