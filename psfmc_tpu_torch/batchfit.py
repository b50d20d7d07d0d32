"""Batched multi-target fitting: K independent fits as one graphed ensemble (port of ``batchfit.py``).

Completeness and injection studies fit the *same model* to many mock or
survey observations.  The reference runs those fits one process each;
the JAX package ``vmap`` s one fit's whole burn + retained scan over the
stacked targets.  Here the K fits are one ensemble of ``K x nwalkers``
walkers on the card:

* positions are ``(K, nwalkers, dim)``; each half-ensemble moves against
  its own target's complementary half (:func:`batch_update`, the
  target-batched ``_stretch_half``), so one half-step is one posterior
  call of ``K x nwalkers / 2`` walkers;
* the posterior is :meth:`~psfmc_tpu_torch.models.posterior.PosteriorFns.
  log_posterior_obs` against an :class:`~psfmc_tpu_torch.models.
  posterior.ObsStack`: the render kernel and conv_lnl with per-target
  planes (and, in survey mode, per-target PSF spectra) where the kernels
  cover the spec, else the general path;
* Welford moments, the MAP and the accept counts stay per target on the
  device, and ``record_every`` keeps ``(K, nrec, nwalkers, dim)`` chains
  there, fetched once per chunk;
* on CUDA every step is one replay of a captured CUDA graph, one graph per
  step variant (burn, retained, retained and recorded) per chunk shape,
  cached on the posterior and reused by every chunk and every call with
  the same shape (one program a posterior: another shape replaces it); each
  chunk's observations, spectra and start are copied into the captured
  buffers in place (a graph reads fixed addresses).

Differences from the JAX package, deliberate:

* the draws come from a ``torch.Generator`` seeded per chunk from
  ``(seed, start)``; the same seed does not give the JAX package's draws
  (its ``fold_in`` keys have no torch counterpart).  :func:`batch_update`
  takes its draws as arguments, so the tests feed it the JAX package's;
* the Welford moments accumulate in float64 on the device, as the port's
  single-fit sampler's do (the JAX package accumulates in the fit's
  dtype, float32 on the accelerator).

``mesh=`` (:func:`~psfmc_tpu_torch.parallel.walker_mesh`) splits the
target axis over one process a device: each chunk's target count is
padded to a multiple of the mesh's size (the last target repeated, the
results trimmed), every process holds the whole ensemble's state, and
each evaluates its own targets' walkers against a stack of its own
targets' observations (conv_lnl sees only those planes and spectra);
one all-gather a half-step gives every process every target's lnpost
(:mod:`psfmc_tpu_torch.parallel.mesh`).  The catalog is written by the
primary process.

Typical completeness loop::

    model = MultiComponentModel('model_field.py')
    obs, ivm, injected = simulate_stack(model, n_mocks=64, seed=1)
    res = fit_batch(model, obs, ivm, burn=300, iterations=300)
    pulls = res.pulls(injected)        # (K, dim) recovery z-scores
"""
from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .parallel.mesh import check_mesh, shard_rows, steps_graphed, walker_sharding
from .parallel.multihost import barrier, is_primary
from .profiling import span, traced
from .sampler.ensemble import (
    MOVES,
    _de_proposal,
    _stretch_proposal,
    capture_step,
    welford_batch_update,
)
from .sampler.tempered import GeneratorDraws

__all__ = [
    "BatchFitResult",
    "BatchState",
    "batch_update",
    "make_batch_step_fn",
    "prepare_obs_stack",
    "prepare_psf_stack",
    "prepare_obs_for",
    "fit_batch",
    "completeness_fraction",
    "save_batch_results",
    "load_batch_results",
    "simulate_stack",
]


@dataclass
class BatchFitResult:
    """Per-target posterior summaries from :func:`fit_batch`.

    All arrays are host numpy with leading axis K (targets).
    """

    param_names: List[str]
    mean: np.ndarray  # (K, dim) posterior means (all retained steps)
    std: np.ndarray  # (K, dim) posterior stds
    map_theta: np.ndarray  # (K, dim) best retained sample per target
    map_lnp: np.ndarray  # (K,) its log-posterior
    acceptance: np.ndarray  # (K,) mean acceptance fraction (retained)
    param_lens: Optional[List[int]] = None  # slots per name (xy=2)
    chains: Optional[np.ndarray] = None  # (K, nrec, nwalkers, dim)
    lnprob: Optional[np.ndarray] = None  # (K, nrec, nwalkers)

    @property
    def num_targets(self) -> int:
        return self.mean.shape[0]

    def pulls(self, injected) -> np.ndarray:
        """(recovered mean - injected) / posterior std, per target/param.

        The completeness-simulation bottom line: well-calibrated
        recoveries have pulls ~ N(0, 1) per parameter.
        """
        injected = np.asarray(injected, np.float64)
        if injected.shape != self.mean.shape:
            raise ValueError(
                f"injected shape {injected.shape} != {self.mean.shape}"
            )
        return (self.mean - injected) / np.maximum(self.std, 1e-300)

    def psrf(self) -> np.ndarray:
        """Gelman-Rubin R-hat per target/param from the recorded chains.

        Each walker is one chain (the standard ensemble-sampler R-hat
        convention).  Requires ``record_every`` to have been set;
        values near 1 indicate converged retained sampling.
        """
        if self.chains is None:
            raise ValueError(
                "psrf() needs recorded chains: call fit_batch with "
                "record_every > 0"
            )
        from .analysis.statistics import potential_scale_reduction

        k, _nrec, nwalkers, dim = self.chains.shape
        out = np.empty((k, dim))
        for t in range(k):
            for p in range(dim):
                out[t, p] = potential_scale_reduction(
                    [self.chains[t, :, w, p] for w in range(nwalkers)]
                )
        return out


def _as_model(model, device=None):
    from .models.multicomponent import as_model

    return as_model(model, device=device)


# -- the observations --------------------------------------------------------
def prepare_obs_stack(spec, obs_stack, ivm_stack, dtype=np.float32):
    """Stacked observations -> the obs dict :func:`fit_batch` consumes.

    Per-target bad pixels (non-finite data/ivm, ivm <= 0 — reference
    utils.py:54-79 semantics) are unioned with the template spec's
    static bad-pixel mask (which carries any region-file exclusions),
    so mocks of the same field inherit its masking.
    """
    obs_stack = np.asarray(obs_stack, np.float64)
    ivm_stack = np.asarray(ivm_stack, np.float64)
    if obs_stack.ndim != 3 or obs_stack.shape != ivm_stack.shape:
        raise ValueError(
            "obs_stack and ivm_stack must both be (K, H, W); got "
            f"{obs_stack.shape} and {ivm_stack.shape}"
        )
    if obs_stack.shape[1:] != tuple(spec.shape):
        raise ValueError(
            f"target shape {obs_stack.shape[1:]} != model shape "
            f"{tuple(spec.shape)}"
        )
    bad = (
        ~np.isfinite(obs_stack)
        | ~np.isfinite(ivm_stack)
        | (ivm_stack <= 0)
        | np.asarray(spec.bad_px)[None]
    )
    if getattr(spec, "likelihood", "gaussian") == "poisson":
        # the check build_model_spec runs for the baked observation:
        # negative good-pixel counts have no Poisson density
        neg = (~bad) & (obs_stack < 0)
        if neg.any():
            k_bad = int(np.flatnonzero(neg.any(axis=(1, 2)))[0])
            raise ValueError(
                "likelihood='poisson' needs non-negative data at every "
                f"good pixel, but target {k_bad} has min "
                f"{obs_stack[k_bad][neg[k_bad]].min():.4g} — mask the "
                "offending pixels (ivm 0) or use gaussian/student"
            )
    with np.errstate(divide="ignore"):
        var = np.where(bad, np.inf, 1.0 / np.where(bad, 1.0, ivm_stack))
    return {
        "obs_data": np.where(bad, 0.0, obs_stack).astype(dtype),
        "obs_var": var.astype(dtype),
        "good_px": ~bad,
    }


def prepare_psf_stack(spec, psf_stack, psfivm_stack, oversample=1,
                      dtype=np.float32):
    """Per-target PSF stacks -> obs-dict spectra entries (survey mode).

    Every target brings its own PSF star while the model structure stays
    shared, so the whole batch runs as one ensemble.  Each target's PSFs
    go through exactly the preprocessing the template PSF does
    (normalization, IVM->variance propagation, inter-PSF mismatch
    variance, oversample binning, conv_pad-aware FFT) by building a
    throwaway :class:`~psfmc_tpu_torch.models.components.PSFSelector`
    per target and transforming it with
    :func:`psfmc_tpu_torch.models.spec.psf_spectra_for_selector`.

    :param spec: the template ModelSpec (band spec for joint models).
    :param psf_stack: length-K sequence; each entry one PSF (``(h, w)``
        array or FITS filename) or a LIST of ``spec.num_psfs`` PSFs
        when the template samples a stochastic PSF index.  A ``(K, h,
        w)`` array works too.
    :param psfivm_stack: inverse-variance maps, same structure.
    :param oversample: PSF oversampling factor (block-binned down,
        flux-preserving — Configuration ``psf_oversample`` semantics).
    :returns: ``{"psf_f_re"/"psf_f_im": (K, num_psfs, Hf, Wf) float,
        "var_f_re"/"var_f_im": ...}`` ready to merge into the fit's obs
        dict (real and imaginary planes, as the JAX package ships them).
    """
    from .models.components import PSFSelector
    from .models.spec import psf_spectra_for_selector

    cdtype = (
        np.complex64 if np.dtype(dtype) == np.float32 else np.complex128
    )
    npsf = int(getattr(spec, "num_psfs", 1))
    if len(psf_stack) != len(psfivm_stack):
        raise ValueError(
            f"psf_stack and psfivm_stack disagree on target count: "
            f"{len(psf_stack)} vs {len(psfivm_stack)}"
        )
    conv_pad = int(getattr(spec, "conv_pad", 0))
    fs, vs = [], []
    for p, i in zip(psf_stack, psfivm_stack):
        if not isinstance(p, (list, tuple)):
            p, i = [p], [i]
        if len(p) != npsf:
            raise ValueError(
                f"each target needs {npsf} PSF(s) to match the "
                f"template's stochastic index; got {len(p)}"
            )
        sel = PSFSelector(list(p), list(i), spec.shape,
                          oversample=oversample)
        f, v = psf_spectra_for_selector(sel, spec.shape, conv_pad)
        fs.append(f)
        vs.append(v)
    f_all = np.asarray(np.stack(fs), cdtype)
    v_all = np.asarray(np.stack(vs), cdtype)
    rdtype = np.dtype(dtype)
    return {
        "psf_f_re": np.ascontiguousarray(f_all.real, rdtype),
        "psf_f_im": np.ascontiguousarray(f_all.imag, rdtype),
        "var_f_re": np.ascontiguousarray(v_all.real, rdtype),
        "var_f_im": np.ascontiguousarray(v_all.imag, rdtype),
    }


_OBS_KEYS = ("obs_data", "obs_var", "good_px")
_PSF_KEYS = ("psf_f", "var_f", "psf_f_re", "psf_f_im", "var_f_re", "var_f_im")


def prepare_obs_for(fns, obs):
    """The obs dict of a single-band or joint posterior -> one
    :class:`~psfmc_tpu_torch.models.posterior.ObsStack` per band on its
    device.  A joint posterior's dict is flat, with ``b{i}_``-prefixed
    keys, one set per band (its optional per-target spectra included)."""
    band_fns = getattr(fns, "band_fns", None)
    if band_fns is None:
        return [fns.prepare_obs(obs)]
    return [f.prepare_obs({key: obs[f"b{i}_{key}"] for key in _OBS_KEYS + _PSF_KEYS
                           if f"b{i}_{key}" in obs})
            for i, f in enumerate(band_fns)]


def _lnpost_obs_for(fns):
    """``(thetas (B, dim), stacks) -> lnpost (B,)``, single-band or joint.

    A joint posterior (``band_fns``): the global slot prior once, then
    each band's ``log_posterior_obs`` against its stack (its components'
    constraints and its likelihood), ``-inf`` outside the slot prior and
    for NaN: the JAX package's decomposition.  The slot prior's constants
    are made here, once, before any capture."""
    band_fns = getattr(fns, "band_fns", None)
    if band_fns is None:
        return lambda thetas, stacks: fns.log_posterior_obs(thetas, stacks[0])

    from .models.posterior import LogPrior

    slot_prior = LogPrior(fns.spec.slots, [], fns.device, fns.dtype)

    def lnpost(thetas, stacks):
        lp = slot_prior(thetas)
        tot = lp
        for f, stack in zip(band_fns, stacks):
            tot = tot + f.log_posterior_obs(thetas, stack)
        neg_inf = torch.full_like(lp, -math.inf)
        out = torch.where(torch.isfinite(lp), tot, neg_inf)
        return torch.where(torch.isnan(out), neg_inf, out)

    return lnpost


_EAGER = False  # set by _eager(): new programs run their steps without graphs


@contextlib.contextmanager
def _eager():
    """Fit with programs whose steps run eagerly on CUDA, as on the CPU:
    the yardstick the card holds the graphed fit against (an eager
    program has its own key, so it replaces a graphed one in the cache).
    No public switch selects it."""
    global _EAGER
    outer, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = outer


# -- the target-batched ensemble step ------------------------------------------
def batch_update(active_pos, active_lnp, comp_pos, lnpost_batch, a, dim,
                 partner, u_accept, u=None, shift=None, u_jump=None,
                 normal=None, use_de=None, gamma0=None):
    """One half-ensemble update of every target, its draws given.

    ``active_pos`` is ``(K, k, dim)`` with its lnpost ``(K, k)``,
    ``comp_pos`` ``(K, m, dim)``, each draw ``(K, k)``: every proposal
    takes its partners inside its own target (``partner`` in ``[0, m)``,
    DE's second partner ``(partner + 1 + shift) mod m``).  The move is the
    stretch move when only ``u`` is given, differential evolution when
    ``shift``, ``u_jump`` and ``normal`` are given without ``u``
    (``gamma0`` its scale), and with all of them the move each target's
    ``use_de`` (a ``(K,)`` boolean tensor) picks, both proposals formed
    from the same ``partner``.  ``lnpost_batch`` evaluates the ``K k``
    proposals in one call, target-major.  Returns ``(new_pos, new_lnp,
    accepted (K, k) int64)``.
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
            proposal = torch.where(use_de[:, None, None], proposal, st_prop)
            log_extra = torch.where(use_de[:, None], log_extra, st_extra)
    k_targets, k = active_pos.shape[:2]
    prop_lnp = lnpost_batch(proposal.reshape(k_targets * k, -1)).reshape(k_targets, k)
    accept = torch.log(u_accept) < log_extra + prop_lnp - active_lnp
    return (torch.where(accept[..., None], proposal, active_pos),
            torch.where(accept, prop_lnp, active_lnp),
            accept.to(torch.int64))


@dataclass
class BatchState:
    """The batch fit's persistent buffers, updated in place: positions
    ``(K, nwalkers, dim)`` and their lnpost ``(K, nwalkers)``, accept
    counts ``(K,)`` int64, float64 Welford moments ``{"mean", "m2": (K,
    dim), "n": ()}`` of the retained steps, and each target's best lnpost
    ``(K,)`` and its position ``(K, dim)``."""

    positions: torch.Tensor
    log_prob: torch.Tensor
    naccept: torch.Tensor
    moments: Dict[str, torch.Tensor]
    best_lnp: torch.Tensor
    best_theta: torch.Tensor

    def clone(self):
        return BatchState(self.positions.clone(), self.log_prob.clone(),
                          self.naccept.clone(),
                          {k: v.clone() for k, v in self.moments.items()},
                          self.best_lnp.clone(), self.best_theta.clone())


def make_batch_step_fn(lnpost_batch, nwalkers, dim, draws, a=2.0,
                       moves="stretch", de_gamma0=None, track=False):
    """One step of every target's ensemble, in place: ``step(state,
    record=None)``.

    Two half-ensemble updates (:func:`batch_update`), the second against
    the updated first half, then, when ``track``, the per-target Welford
    moments (float64) and MAP of the step's positions; ``record``, a
    ``(positions (cap, K, nwalkers, dim), lnprob (cap, K, nwalkers),
    slot (1,) int64)`` triple, takes them at row ``slot``, which then
    advances.  The draws come from ``draws`` (``uniform(shape, dtype)``,
    ``randint(high, shape)``, ``normal(shape, dtype)``) in this order:
    for ``"mixed"`` one uniform per target (below 0.5: DE this step,
    both halves); then per half-step stretch ``u``, ``partner``, DE's
    ``shift``, ``u_jump`` and ``normal``, and ``u_accept``, each ``(K,
    k)``, the moves' own only.
    """
    if moves not in MOVES:
        raise ValueError(f"unknown moves {moves!r}: expected 'stretch', 'de' "
                         "or 'mixed'")
    half = nwalkers // 2
    gamma0 = 2.38 / math.sqrt(2.0 * dim) if de_gamma0 is None else float(de_gamma0)

    def half_step(use_de, active_pos, active_lnp, comp_pos):
        shape = tuple(active_pos.shape[:2])
        m = comp_pos.shape[1]
        dt = active_pos.dtype
        d = {}
        if moves != "de":
            d["u"] = draws.uniform(shape, dt)
        d["partner"] = draws.randint(m, shape)
        if moves != "stretch":
            d.update(shift=draws.randint(m - 1, shape), u_jump=draws.uniform(shape, dt),
                     normal=draws.normal(shape, dt), use_de=use_de, gamma0=gamma0)
        d["u_accept"] = draws.uniform(shape, dt)
        return batch_update(active_pos, active_lnp, comp_pos, lnpost_batch, a, dim, **d)

    def step(state: BatchState, record=None):
        pos, lnp = state.positions, state.log_prob
        use_de = None
        if moves == "mixed":
            use_de = draws.uniform((pos.shape[0],), pos.dtype) < 0.5
        p0, l0, acc0 = half_step(use_de, pos[:, :half], lnp[:, :half], pos[:, half:])
        p1, l1, acc1 = half_step(use_de, pos[:, half:], lnp[:, half:], p0)
        new_pos = torch.cat([p0, p1], dim=1)
        new_lnp = torch.cat([l0, l1], dim=1)
        state.naccept.add_(acc0.sum(dim=1) + acc1.sum(dim=1))
        if track:
            moments = welford_batch_update(state.moments, new_pos.to(torch.float64),
                                           axis=1)
            for k, v in moments.items():
                state.moments[k].copy_(v)
            best = new_lnp.argmax(dim=1, keepdim=True)
            cand = new_lnp.gather(1, best)[:, 0]
            better = cand > state.best_lnp
            theta = new_pos.gather(1, best[..., None].expand(-1, 1, dim))[:, 0]
            state.best_lnp.copy_(torch.where(better, cand, state.best_lnp))
            state.best_theta.copy_(torch.where(better[:, None], theta, state.best_theta))
        pos.copy_(new_pos)
        lnp.copy_(new_lnp)
        if record is not None:
            chain_pos, chain_lnp, slot = record
            chain_pos.index_copy_(0, slot, new_pos[None])
            chain_lnp.index_copy_(0, slot, new_lnp[None])
            slot.add_(1)

    return step


class _BatchProgram:
    """One chunk shape's fit: the state and chain buffers, the live
    observation stacks, the generator and, on CUDA, one captured graph per
    step variant (``burn``, ``retain``, ``record``), reused by every
    chunk: :meth:`run` copies a chunk's stacks and start into the
    captured buffers in place.  Under a ``sharding`` the stacks hold this
    process's targets of the chunk (:meth:`~psfmc_tpu_torch.parallel.
    WalkerMesh.rows` of ``targets``) and each evaluation gathers every
    target's lnpost."""

    def __init__(self, fns, stacks, targets, nwalkers, dim, a, moves, de_gamma0,
                 nrec, draws=None, sharding=None):
        self.device = torch.device(fns.device)
        self.dtype = fns.dtype
        self.dim = dim
        self.lnpost = _lnpost_obs_for(fns)
        self.stacks = stacks  # the live stacks: the graphs read them
        kw = dict(dtype=self.dtype, device=self.device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.state = BatchState(
            positions=torch.zeros((targets, nwalkers, dim), **kw),
            log_prob=torch.zeros((targets, nwalkers), **kw),
            naccept=torch.zeros(targets, dtype=torch.int64, device=self.device),
            moments={"mean": torch.zeros((targets, dim), **f64),
                     "m2": torch.zeros((targets, dim), **f64),
                     "n": torch.zeros((), dtype=torch.int64, device=self.device)},
            best_lnp=torch.zeros(targets, **kw), best_theta=torch.zeros((targets, dim), **kw))
        self.record = None
        if nrec:
            self.record = (torch.zeros((nrec, targets, nwalkers, dim), **kw),
                           torch.zeros((nrec, targets, nwalkers), **kw),
                           torch.zeros(1, dtype=torch.int64, device=self.device))
        self.generator = torch.Generator(device=self.device)
        if draws is None:  # the tests hand in the JAX package's draws
            draws = GeneratorDraws(self.generator, self.device)

        lnpost = self.lnpost

        def local(thetas):  # no reference to self: a dropped program is freed at once
            return lnpost(thetas, stacks)

        self.batch = batch = shard_rows(local, sharding, blocks=targets)
        self.steps = {variant: make_batch_step_fn(
            batch, nwalkers, dim, draws, a=a, moves=moves, de_gamma0=de_gamma0,
            track=variant != "burn") for variant in ("burn", "retain", "record")}
        self._graphed = not _EAGER and steps_graphed(self.device, sharding)
        self.graphs = {}
        self.captures = 0  # graphs captured
        self.replays = 0  # steps run as a replay
        self._stream = self._pool = None

    def _step(self, variant):
        record = self.record if variant == "record" else None
        if not self._graphed:
            self.steps[variant](self.state, record)
            return
        graph = self.graphs.get(variant)
        if graph is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            scratch = None if record is None else tuple(t.clone() for t in record)
            graph = self.graphs[variant] = capture_step(
                self.steps[variant], (self.state, record), (self.state.clone(), scratch),
                self.generator, self._stream, self._pool)
            self.captures += 1
        graph.replay()
        self.replays += 1

    def run(self, p0, stacks, seed, burn, iterations, record_every):
        """One chunk: its stacks and start into the buffers, the generator
        seeded, the start evaluated, ``burn`` steps, the accept counts
        zeroed, ``iterations`` retained steps (every ``record_every``-th
        recorded); returns the chunk's results as host numpy.  Spans:
        ``psfmc.batch.start`` (the copies in, the start's evaluation),
        ``psfmc.batch.steps`` (ending in the read of the moments' count,
        which waits for the steps), ``psfmc.batch.readout``."""
        s = self.state
        with span("psfmc.batch.start"):
            for live, new in zip(self.stacks, stacks):
                if live is not new:
                    live.copy_(new)
            s.positions.copy_(torch.as_tensor(p0, dtype=self.dtype))
            k, w, dim = s.positions.shape
            s.log_prob.copy_(self.batch(s.positions.reshape(k * w, dim)).reshape(k, w))
            s.naccept.zero_()
            for v in s.moments.values():
                v.zero_()
            s.best_lnp.fill_(-math.inf)
            s.best_theta.zero_()
            self.generator.manual_seed(int(seed))
        with span("psfmc.batch.steps"):
            for _ in range(int(burn)):
                self._step("burn")
            # the retained phase's acceptance covers retained steps only
            s.naccept.zero_()
            if self.record is not None:
                self.record[2].zero_()
            for i in range(int(iterations)):
                rec = record_every and (i + 1) % record_every == 0
                self._step("record" if rec else "retain")
            n = max(int(s.moments["n"]), 1)

        def host(t):
            return t.to("cpu", torch.float64, copy=True).numpy()

        with span("psfmc.batch.readout"):
            out = {"mean": host(s.moments["mean"]),
                   "std": np.sqrt(host(s.moments["m2"]) / max(n - 1, 1)),
                   "map_theta": host(s.best_theta), "map_lnp": host(s.best_lnp),
                   "naccept": host(s.naccept)}
            if record_every:
                nrec = int(iterations) // record_every
                out["chain"] = np.ascontiguousarray(host(self.record[0][:nrec]).swapaxes(0, 1))
                out["lnprob"] = np.ascontiguousarray(host(self.record[1][:nrec]).swapaxes(0, 1))
        return out


def _chunk_seed(seed, start):
    """The generator's seed for the chunk whose first target is
    ``start``: a 64-bit word of numpy's ``SeedSequence([seed, start])``."""
    return int(np.random.SeedSequence([int(seed), int(start)]).generate_state(
        1, np.uint64)[0])


def _stack_inputs(spec, obs_stack, ivm_stack, psf_stack, psfivm_stack, psf_oversample,
                  np_dtype):
    """:func:`fit_batch`'s stacks as one dict of ``(K, ...)`` arrays (a
    joint model's keys prefixed ``b{i}_``), and K."""
    band_specs = getattr(spec, "band_specs", None)
    if band_specs is None:
        obs = prepare_obs_stack(spec, obs_stack, ivm_stack, np_dtype)
        k_real = obs["obs_data"].shape[0]
        if psf_stack is not None:
            psf = prepare_psf_stack(spec, psf_stack, psfivm_stack, psf_oversample,
                                    np_dtype)
            if psf["psf_f_re"].shape[0] != k_real:
                raise ValueError(
                    f"psf_stack target count {psf['psf_f_re'].shape[0]} "
                    f"!= obs target count {k_real}"
                )
            obs.update(psf)
    else:
        # joint model: one (K, H_b, W_b) stack per band, flattened into
        # b{i}_-prefixed keys so the chunk plumbing is the single band's
        if len(obs_stack) != len(band_specs) or len(ivm_stack) != len(band_specs):
            raise ValueError(
                f"joint fit_batch needs one obs/ivm stack per band "
                f"({len(band_specs)}), got {len(obs_stack)}/{len(ivm_stack)}"
            )
        if psf_stack is not None and len(psf_stack) != len(band_specs):
            raise ValueError(
                f"joint fit_batch needs one psf_stack per band "
                f"({len(band_specs)}; None keeps that band's template "
                f"PSF), got {len(psf_stack)}"
            )
        obs = {}
        k_real = None
        for i, (bs, ob, iv) in enumerate(zip(band_specs, obs_stack, ivm_stack)):
            d = prepare_obs_stack(bs, ob, iv, np_dtype)
            if psf_stack is not None and psf_stack[i] is not None:
                if psfivm_stack[i] is None:
                    raise ValueError(
                        f"band {i}: psf_stack entry needs a matching "
                        "psfivm_stack entry"
                    )
                p = prepare_psf_stack(bs, psf_stack[i], psfivm_stack[i],
                                      psf_oversample, np_dtype)
                if p["psf_f_re"].shape[0] != d["obs_data"].shape[0]:
                    raise ValueError(
                        f"band {i}: psf_stack target count "
                        f"{p['psf_f_re'].shape[0]} != obs target count "
                        f"{d['obs_data'].shape[0]}"
                    )
                d.update(p)
            k = d["obs_data"].shape[0]
            if k_real is None:
                k_real = k
            elif k != k_real:
                raise ValueError(f"bands disagree on target count: {k_real} vs {k}")
            for key, v in d.items():
                obs[f"b{i}_{key}"] = v
    return obs, k_real


@traced("fit_batch")
def fit_batch(
    model,
    obs_stack,
    ivm_stack,
    nwalkers=None,
    burn=500,
    iterations=500,
    seed=0,
    a=2.0,
    moves="stretch",
    de_gamma0=None,
    record_every=0,
    mesh=None,
    chunk=None,
    psf_stack=None,
    psfivm_stack=None,
    psf_oversample=1,
    device=None,
):
    """Fit the model independently to K stacked observations at once.

    :param model: a MultiComponentModel, a component list, a
        model-file path, or a :class:`psfmc_tpu_torch.models.JointModel`
        (a list or path builds on ``device``: CUDA unless ``"cpu"``).
        The model's Configuration(s) supply the PSF, mask, zeropoint
        and image geometry shared by every target; their own
        observations are only templates.
    :param obs_stack: (K, H, W) observed images — or, for a joint
        model, a LIST of one (K, H_b, W_b) stack per band
        (``simulate_stack`` returns the right structure either way).
    :param ivm_stack: inverse-variance maps, same structure as
        ``obs_stack`` (reference obsivm_file semantics).
    :param nwalkers: walkers per target (default ``2*dim + 2``, the
        reference default).
    :param burn / iterations: steps per phase, every target alike.
    :param moves: ``'stretch'`` | ``'de'`` | ``'mixed'`` — same proposal
        families as :class:`~psfmc_tpu_torch.sampler.EnsembleSampler`;
        ``'mixed'`` picks the move per target and step.
    :param record_every: if > 0, also return chains thinned by this
        factor (must divide ``iterations``); default records nothing
        and ships only O(dim) summaries per target.
    :param mesh: optional :func:`~psfmc_tpu_torch.parallel.walker_mesh`:
        the target axis is split over its processes (K padded to a mesh
        multiple a chunk, results trimmed; see the module doc); the fit
        runs on the mesh's device unless ``device`` is given.
    :param chunk: targets per ensemble.  Every chunk reuses one captured
        graph per step variant and device memory stays bounded; the last
        chunk is padded by repeating its last target and trimmed.
        Default: all K in one chunk.
    :param psf_stack: optional per-target PSFs (survey mode):
        length-K sequence of ``(h, w)`` arrays/filenames (or per-target
        LISTS of ``num_psfs`` PSFs under a stochastic index), or a
        per-band LIST of such for joint models (a ``None`` entry keeps
        that band's template PSF).  See :func:`prepare_psf_stack`.
    :param psfivm_stack: PSF inverse-variance maps, same structure;
        required with ``psf_stack``.
    :param psf_oversample: per-target PSF oversampling factor.
    :returns: :class:`BatchFitResult`.

    With ``PSFMC_TRACE_DIR`` set, the call writes one ``torch.profiler``
    trace, ``<dir>/fit_batch/rank<r>.pt.trace.json``
    (:func:`~psfmc_tpu_torch.profiling.trace`), its spans under
    ``psfmc.fit_batch``.
    """
    if check_mesh(mesh) is not None and device is None:
        device = mesh.device
    with span("psfmc.model"):
        model = _as_model(model, device=None if device is None else resolve_device(device))
    fns = model.posterior_fns
    spec = model.spec
    dim = spec.num_params
    if nwalkers is None:
        nwalkers = 2 * dim + 2  # reference default; always even
    if nwalkers % 2:
        raise ValueError("nwalkers must be even for half-ensemble moves")
    if moves not in MOVES:
        raise ValueError(
            f"unknown moves {moves!r}: expected 'stretch', 'de' or 'mixed'"
        )
    record_every = int(record_every)
    if record_every and iterations % record_every:
        raise ValueError(
            f"iterations={iterations} not divisible by "
            f"record_every={record_every}"
        )
    if (psf_stack is None) != (psfivm_stack is None):
        raise ValueError(
            "psf_stack and psfivm_stack must be given together"
        )
    np_dtype = np.float32 if fns.dtype == torch.float32 else np.float64
    with span("psfmc.batch.prepare"):
        obs, k_real = _stack_inputs(spec, obs_stack, ivm_stack, psf_stack, psfivm_stack,
                                    psf_oversample, np_dtype)

    # every chunk's target count a mesh multiple: each process takes whole fits
    quantum = 1 if mesh is None else mesh.size
    per_chunk = k_real if chunk is None else max(1, min(int(chunk), k_real))
    per_chunk = max(quantum, -(-per_chunk // quantum) * quantum)
    sharding = None if mesh is None else walker_sharding(mesh)
    lo_t, hi_t = (0, per_chunk) if mesh is None else mesh.rows(per_chunk)
    nrec = int(iterations) // record_every if record_every else 0
    rng = np.random.RandomState(seed)
    outs = []
    for start in range(0, k_real, per_chunk):
        with span("psfmc.batch.prepare"):
            sl = slice(start, min(start + per_chunk, k_real))
            chunk_obs = {key: v[sl] for key, v in obs.items()}
            pad = per_chunk - (sl.stop - sl.start)
            if pad:
                chunk_obs = {key: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                             for key, v in chunk_obs.items()}
            p0 = model.init_params_from_priors(
                per_chunk * nwalkers, random_state=rng
            ).reshape(per_chunk, nwalkers, dim)
            stacks = prepare_obs_for(fns, {key: v[lo_t:hi_t] for key, v in chunk_obs.items()})
        key = ("batchfit", _EAGER, per_chunk, nwalkers, dim, float(a), moves, de_gamma0,
               nrec, None if mesh is None else (id(mesh), mesh.size, mesh.rank),
               tuple((s.mode, s.f_stack is not None,
                      s.consts is not None and s.consts.target_spectra) for s in stacks))
        cached = fns.__dict__.get("_batch_program")
        if cached is None or cached[0] != key:
            # one program a posterior: another chunk shape frees the last
            # one's buffers and graphs before the new one is made
            with span("psfmc.batch.program"):
                fns.__dict__.pop("_batch_program", None)
                cached = fns.__dict__["_batch_program"] = (key, _BatchProgram(
                    fns, stacks, per_chunk, nwalkers, dim, a, moves, de_gamma0, nrec,
                    sharding=sharding))
        program = cached[1]
        out = program.run(p0, stacks, _chunk_seed(seed, start), burn, iterations,
                          record_every)
        outs.append({k: v[: per_chunk - pad] for k, v in out.items()})

    with span("psfmc.batch.merge"):
        merged = {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
        res = BatchFitResult(
            param_names=list(spec.param_names),
            mean=merged["mean"],
            std=merged["std"],
            map_theta=merged["map_theta"],
            map_lnp=merged["map_lnp"],
            acceptance=merged["naccept"] / float(int(iterations) * nwalkers),
            param_lens=list(spec.param_lens),
        )
        if record_every:
            res.chains = merged["chain"]
            res.lnprob = merged["lnprob"]
    return res


def completeness_fraction(
    res: BatchFitResult,
    injected,
    param,
    bins=8,
    recovered=None,
):
    """Recovered fraction binned by an injected parameter value.

    The completeness-curve bottom line of an injection study: what
    fraction of sources injected at a given magnitude (or size, ...)
    does the fit recover?

    :param param: parameter name (e.g. ``'1_PointSource_mag'``) whose
        INJECTED value defines the binning axis; must be a scalar slot.
    :param bins: bin count, or an explicit bin-edge array.
    :param recovered: predicate ``(res, injected) -> (K,) bool``.
        The default calls a target recovered when the named parameter's
        posterior pull is within 3 and its std is smaller than the
        prior draw spread (i.e. the data, not the prior, constrained
        it).  Real studies should pass their own detection criterion —
        this default is a sensible starting point, not a standard.
    :returns: ``(bin_centers, fraction, counts)`` — fraction is NaN for
        empty bins.
    """
    injected = np.asarray(injected, np.float64)
    lens = res.param_lens or [1] * len(res.param_names)
    offs = np.concatenate([[0], np.cumsum(lens)])
    try:
        i = res.param_names.index(param)
    except ValueError:
        raise ValueError(
            f"unknown parameter {param!r}: expected one of "
            f"{res.param_names}"
        ) from None
    if lens[i] != 1:
        raise ValueError(f"{param!r} is a vector slot; bin on a scalar")
    col = offs[i]
    x = injected[:, col]

    if recovered is None:
        pull = (res.mean[:, col] - x) / np.maximum(res.std[:, col], 1e-300)
        spread = np.std(x) if len(x) > 1 else np.inf
        ok = (np.abs(pull) < 3.0) & (res.std[:, col] < max(spread, 1e-12))
    else:
        ok = np.asarray(recovered(res, injected), bool)

    edges = (
        np.histogram_bin_edges(x, bins=bins)
        if np.isscalar(bins)
        else np.asarray(bins, np.float64)
    )
    idx = np.clip(np.digitize(x, edges) - 1, 0, len(edges) - 2)
    counts_ = np.bincount(idx, minlength=len(edges) - 1)
    hits = np.bincount(idx, weights=ok.astype(float), minlength=len(edges) - 1)
    with np.errstate(invalid="ignore"):
        frac = np.where(counts_ > 0, hits / np.maximum(counts_, 1), np.nan)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, frac, counts_


def save_batch_results(res: BatchFitResult, path, injected=None):
    """Write a batch-fit catalog as a FITS binary table (extension
    ``BATCHFIT``).

    One row per target; per parameter-slot columns ``<name>_mean``,
    ``<name>_std``, ``<name>_map`` (vector slots like ``xy`` stay
    2-wide columns), plus ``lnp_map`` and ``acceptance``.  With
    ``injected`` given, ``<name>_true`` and ``<name>_pull`` columns
    record the completeness-simulation truth and recovery z-scores.
    Header cards ``NTARGETS`` and ``MCINJECT``.  In a multi-process run
    the primary process writes the file, and every process waits for it.
    """
    from .io.table import Table

    cols = OrderedDict()
    lens = res.param_lens
    if lens is None:
        # only safe when every slot is scalar: an all-ones default would
        # shift every column after a 2-wide xy slot
        if len(res.param_names) != res.mean.shape[1]:
            raise ValueError(
                "BatchFitResult.param_lens is required when parameter "
                "slots are not all scalar (found "
                f"{len(res.param_names)} names for {res.mean.shape[1]} "
                "slots)"
            )
        lens = [1] * len(res.param_names)
    pulls = res.pulls(injected) if injected is not None else None
    off = 0
    for name, size in zip(res.param_names, lens):
        sl = slice(off, off + size)

        def col(arr):
            block = np.asarray(arr[:, sl], np.float64)
            return block[:, 0] if size == 1 else block

        cols[f"{name}_mean"] = col(res.mean)
        cols[f"{name}_std"] = col(res.std)
        cols[f"{name}_map"] = col(res.map_theta)
        if injected is not None:
            cols[f"{name}_true"] = col(np.asarray(injected, np.float64))
            cols[f"{name}_pull"] = col(pulls)
        off += size
    cols["lnp_map"] = np.asarray(res.map_lnp, np.float64)
    cols["acceptance"] = np.asarray(res.acceptance, np.float64)
    meta = OrderedDict([
        ("NTARGETS", (res.num_targets, "batch-fit targets")),
        ("MCINJECT", (injected is not None, "injected truth recorded")),
    ])
    if is_primary():
        Table(cols, meta=meta).write(path, extname="BATCHFIT")
    barrier("save_batch_results")  # the file exists before any process returns


def load_batch_results(path):
    """Read a :func:`save_batch_results` catalog back as a Table."""
    from .io.table import Table

    return Table.read(path, extname="BATCHFIT")


def simulate_stack(model, n_mocks, seed=0, thetas=None, add_noise=True,
                   device=None):
    """K mock observations through the port's own renderer.

    Batched ``MultiComponentModel.simulate``: mock = PSF-convolved model
    (:meth:`~psfmc_tpu_torch.models.MultiComponentModel.
    render_images_batch`; each band's ``images_batch`` for a joint
    model) + noise at the observation's variance map
    (:func:`~psfmc_tpu_torch.models.multicomponent.replicate_noise`).
    The returned ivm stack is the template observation's ivm (mocks
    inherit the field's noise model and bad pixels).  The parameters and
    the noise come from ``np.random.RandomState(seed)``, as in the JAX
    package.

    :returns: ``(obs_stack (K,H,W) f64, ivm_stack (K,H,W) f64,
        thetas (K, dim) f64)`` (for a joint model the first two are
        lists, one stack per band).
    """
    from .models.multicomponent import replicate_noise

    model = _as_model(model, device=None if device is None else resolve_device(device))
    spec = model.spec
    rng = np.random.RandomState(seed)
    if thetas is None:
        thetas = model.init_params_from_priors(n_mocks, random_state=rng)
    thetas = np.asarray(thetas, np.float64)
    if thetas.shape != (n_mocks, spec.num_params):
        raise ValueError(
            f"thetas shape {thetas.shape} != ({n_mocks}, {spec.num_params})"
        )

    def mock_band(conv, var, spec_b):
        obs = np.asarray(conv, np.float64)
        if add_noise:
            sigma = np.where(np.isfinite(var), np.sqrt(var), 0.0)
            obs = replicate_noise(rng, obs, spec_b, sigma[None])
        with np.errstate(divide="ignore"):
            ivm = np.where(np.isfinite(var) & (var > 0), 1.0 / var, 0.0)
        return obs, np.broadcast_to(ivm, obs.shape).copy()

    band_specs = getattr(spec, "band_specs", None)
    if band_specs is not None:
        # joint model: one mock stack per band at the same thetas
        obs_list, ivm_list = [], []
        for bs, f in zip(band_specs, model.posterior_fns.band_fns):
            conv = f.images_batch(thetas)["conv"].to("cpu", torch.float64).numpy()
            ob, iv = mock_band(conv, np.asarray(bs.obs_var, np.float64), bs)
            obs_list.append(ob)
            ivm_list.append(iv)
        return obs_list, ivm_list, thetas

    conv = model.render_images_batch(thetas)["convolved_model"]
    obs, ivm = mock_band(conv, np.asarray(spec.obs_var, np.float64), spec)
    return obs, ivm, thetas
