"""Affine-invariant ensemble sampler (port of ``sampler/ensemble.py``).

emcee 2.x semantics, as in the JAX package: red/black half-ensemble
updates (the second half moves against the already-updated first half),
each half evaluated in one batched posterior call.  Three move families
(``moves=``):

* ``"stretch"``: ``z = ((a-1) u + 1)^2 / a`` with ``a = 2`` by default
  and the acceptance ratio ``(dim-1) ln z + lnp(Y) - lnp(X)``;
* ``"de"``: differential evolution (ter Braak 2006, emcee 3's DEMove),
  ``Y = X + gamma (C_r1 - C_r2)`` with two distinct complementary
  walkers, ``gamma = gamma0 = 2.38 / sqrt(2 dim)`` (90%) or 1 (10%),
  times a ``1 + 1e-5 N(0, 1)`` jitter; plain Metropolis acceptance;
* ``"mixed"``: one Bernoulli(1/2) draw per step, on the device, picks
  the move both halves take; both proposals are formed and one is
  selected with ``torch.where``, so the step has no host branch and the
  choice costs no posterior evaluation.

The state lives in persistent buffers (:class:`EnsembleState`): every
step and every method writes into them in place.  That is what lets a
CUDA graph capture a step: on CUDA, ``run_burn``, ``run_sampling`` and
:meth:`EnsembleSampler.sample` replay one captured graph per step, the
port's counterpart of the JAX package's jitted ``lax.scan`` over a
phase.  There is one graph per step variant (burn; retained; retained
and recorded, which writes the step's positions and lnprob into the
chain buffer at the row a device counter gives), captured the first time
the sampler needs it after a warm-up on scratch copies of the buffers,
cached per sampler in one memory pool, and replayed once per step from
the host loop.  A capture or replay that fails raises; nothing falls
back to the eager loop.  On the CPU the same step function runs eagerly
on the same buffers.

Retained steps accumulate the posterior-mean images on the device
(float32), from the posterior's ``ensemble_carry_means`` into
accumulators allocated before the phase from its
``carry_image_shapes()``; ``thin`` records every thin-th retained step
into the chain buffer, and ``track_moments`` keeps Welford moments of
every retained step on the device, in float64 (float32 sums drift by
about 1e-3 over 1e5 samples).

Differences of form from the JAX package:

* a host loop of graph replays replaces ``lax.scan``; the chain buffer
  is fetched to the host once per segment;
* every random draw takes the sampler's ``torch.Generator`` (registered
  with each graph), and :func:`stretch_update`, :func:`de_update` and
  :func:`mixed_update` take the draws as arguments so a test can inject
  them;
* where the JAX checkpoint holds a PRNG key, the port's holds the state
  of its generator (``rng_state``) and the generator's kind
  (``rng_kind``: ``torch-cuda`` or ``torch-cpu``); a checkpoint with
  another kind cannot be restored into this sampler, and the third
  element :meth:`~EnsembleSampler.sample` yields is the generator's
  state where the JAX package yields its key.

Under a walker mesh (``sharding=``, :mod:`psfmc_tpu_torch.parallel.mesh`)
every process holds the whole state and draws the same proposals; each
half-step's posterior call evaluates the process's rows and gathers the
rest (the JAX package's walker sharding, its partner gather made
unnecessary by the replicated state).

For the fitting driver, as in the JAX package: ``run_burn`` and
``run_sampling`` take ``segment=``/``callback=`` (progress and mid-phase
checkpoints), :meth:`EnsembleSampler.rejuvenate_stuck` repairs stranded
walkers between burn segments, and :meth:`~EnsembleSampler.
checkpoint_payload` / :meth:`~EnsembleSampler.restore_state` carry the
full resume state.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .._device import gc_paused, resolve_device
from ..ops.kernels import counts
from ..parallel.mesh import check_sharding, steps_graphed
from ..parallel.posterior import shard_posterior
from ..profiling import span
from .autocorr import integrated_time

__all__ = [
    "MOVES",
    "EnsembleState",
    "EnsembleSampler",
    "welford_batch_update",
    "merge_image_accumulators",
    "fresh_image_accumulators",
    "restore_image_accumulators",
    "stretch_update",
    "de_update",
    "mixed_update",
    "make_step_fn",
    "run_stretch_move",
    "capture_step",
]

MOVES = ("stretch", "de", "mixed")


@dataclass
class EnsembleState:
    """The sampler's persistent buffers, updated in place."""

    positions: torch.Tensor  # (nwalkers, dim)
    log_prob: torch.Tensor  # (nwalkers,)
    accum: Dict[str, torch.Tensor]  # running-mean images (empty: none)
    accum_count: torch.Tensor  # () int64: accumulated samples
    naccept: torch.Tensor  # (nwalkers,) int64 accepted moves per walker
    # Welford moments {"mean", "m2": (dim,) float64, "n": () int64} over
    # every retained step, or None (track_moments off)
    moments: Optional[Dict[str, torch.Tensor]] = None

    def clone(self):
        def copy(d):
            return None if d is None else {k: v.clone() for k, v in d.items()}

        return EnsembleState(self.positions.clone(), self.log_prob.clone(),
                             copy(self.accum), self.accum_count.clone(),
                             self.naccept.clone(), copy(self.moments))


def welford_batch_update(moments, batch, axis=0):
    """Merge a ``(nbatch, dim)`` batch into Welford running moments.

    Chan et al. parallel merge, as the JAX package writes it: the batch's
    own mean and M2 first, then the merge into ``moments = {"mean",
    "m2", "n"}`` with ``n`` an integer tensor.  Works in the batch's
    dtype; the sampler calls it in float64.  ``axis`` is the batch's
    sample axis (the batch fit's ``(K, nwalkers, dim)`` merges over axis
    1, one set of moments per target).
    """
    nb = batch.shape[axis]
    bmean = batch.mean(dim=axis)
    bm2 = ((batch - bmean.unsqueeze(axis)) ** 2).sum(dim=axis)
    n = moments["n"]
    n_new = n + nb
    delta = bmean - moments["mean"]
    ratio = (n.to(batch.dtype) * nb) / n_new.to(batch.dtype)
    mean = moments["mean"] + delta * (nb / n_new.to(batch.dtype))
    m2 = moments["m2"] + bm2 + delta * delta * ratio
    return {"mean": mean, "m2": m2, "n": n_new}


def merge_image_accumulators(accum, count, means, nbatch):
    """Merge one batch of ensemble image statistics into the running means.

    ``count`` is an integer tensor.  Mean keys take the incremental-mean
    update; ``raw_m2`` (sum of squared deviations) the Chan parallel
    merge against the OLD mean.  Returns ``(new_accum, new_count)``.
    """
    count_new = count + nbatch
    out = {}
    for k, v in accum.items():
        if k.endswith("raw_m2"):
            continue
        out[k] = v + nbatch * (means[k].to(v.dtype) - v) / count_new.to(v.dtype)
    for k, v in accum.items():
        if not k.endswith("raw_m2"):
            continue
        base = k[: -len("_m2")]
        delta = means[base].to(v.dtype) - accum[base]
        ratio = (count.to(v.dtype) * nbatch) / count_new.to(v.dtype)
        out[k] = v + means[k].to(v.dtype) + delta * delta * ratio
    return out, count_new


def fresh_image_accumulators(posterior_fns, device):
    """Zero float32 accumulators keyed and shaped by the posterior's
    ``carry_image_shapes()`` (the counterpart of the JAX package's
    shape-only trace); empty for a posterior without carry images."""
    if getattr(posterior_fns, "ensemble_carry_means", None) is None:
        return {}
    return {k: torch.zeros(s, dtype=torch.float32, device=device)
            for k, s in posterior_fns.carry_image_shapes().items()}


def restore_image_accumulators(bufs, count_buf, payload):
    """Write a checkpoint payload's image accumulators and their count
    into the buffers ``bufs`` and ``count_buf``; nothing when the payload
    has none or holds another image basis.  A payload without ``raw_m2``
    fills it with NaN (the std product then reports unavailable)."""
    accum = payload.get("accum")
    count = int(payload.get("accum_count", 0))
    if not accum or count <= 0 or not bufs:
        return
    if any(k not in accum and k != "raw_m2" for k in bufs):
        return  # another image basis
    for k, buf in bufs.items():
        if k in accum:
            buf.copy_(torch.as_tensor(np.asarray(accum[k]), dtype=buf.dtype))
        else:
            buf.fill_(math.nan)
    count_buf.fill_(count)


def _metropolis(active_pos, active_lnp, proposal, log_extra, lnpost_batch,
                u_accept):
    prop_lnp = lnpost_batch(proposal)
    log_ratio = log_extra + prop_lnp - active_lnp
    accept = torch.log(u_accept) < log_ratio
    new_pos = torch.where(accept[..., None], proposal, active_pos)
    new_lnp = torch.where(accept, prop_lnp, active_lnp)
    return new_pos, new_lnp, accept.to(torch.int64)


def _take(comp_pos, partner):
    """``comp_pos[partner]`` along the walker axis, with or without a
    leading rung axis (``(m, dim)`` and ``(k,)``, or ``(T, m, dim)`` and
    ``(T, k)``)."""
    return torch.take_along_dim(comp_pos, partner[..., None], dim=-2)


def _stretch_proposal(active_pos, comp_pos, a, dim, u, partner):
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    c = _take(comp_pos, partner)
    return c + z[..., None] * (active_pos - c), (dim - 1.0) * torch.log(z)


def _de_proposal(active_pos, comp_pos, gamma0, partner, shift, u_jump, normal):
    partner2 = torch.remainder(partner + 1 + shift, comp_pos.shape[-2])
    gamma = torch.where(u_jump < 0.1, torch.ones_like(u_jump),
                        torch.full_like(u_jump, gamma0))
    gamma = gamma * (1.0 + 1e-5 * normal)
    diff = _take(comp_pos, partner) - _take(comp_pos, partner2)
    return active_pos + gamma[..., None] * diff, torch.zeros_like(u_jump)


def stretch_update(active_pos, active_lnp, comp_pos, lnpost_batch, a, dim,
                   u, partner, u_accept):
    """One half-ensemble stretch move with its random draws given.

    ``u`` and ``u_accept`` are uniforms on [0, 1), ``partner`` indices
    into ``comp_pos``, one each per active walker.  Returns ``(new_pos,
    new_lnp, accepted)``.
    """
    proposal, log_extra = _stretch_proposal(active_pos, comp_pos, a, dim, u,
                                            partner)
    return _metropolis(active_pos, active_lnp, proposal, log_extra,
                       lnpost_batch, u_accept)


def de_update(active_pos, active_lnp, comp_pos, lnpost_batch, gamma0,
              partner, shift, u_jump, normal, u_accept):
    """One half-ensemble differential-evolution move with its draws given.

    Per active walker: ``partner`` in ``[0, m)`` and ``shift`` in ``[0,
    m-1)`` pick the two distinct complementary walkers ``partner`` and
    ``(partner + 1 + shift) mod m``; ``u_jump`` (uniform) below 0.1 takes
    ``gamma = 1`` instead of ``gamma0``; ``normal`` (standard normal)
    makes the jitter ``1 + 1e-5 normal``; ``u_accept`` (uniform) decides
    the plain Metropolis acceptance.  Returns ``(new_pos, new_lnp,
    accepted)``.
    """
    proposal, log_extra = _de_proposal(active_pos, comp_pos, gamma0, partner,
                                       shift, u_jump, normal)
    return _metropolis(active_pos, active_lnp, proposal, log_extra,
                       lnpost_batch, u_accept)


def mixed_update(active_pos, active_lnp, comp_pos, lnpost_batch, a, dim,
                 gamma0, use_de, u, partner, shift, u_jump, normal, u_accept):
    """The move ``use_de`` (a boolean tensor) picks, with every draw of
    both given: both proposals are formed from the same ``partner`` and
    one is selected with ``torch.where``; one posterior evaluation."""
    st_prop, st_extra = _stretch_proposal(active_pos, comp_pos, a, dim, u,
                                          partner)
    de_prop, de_extra = _de_proposal(active_pos, comp_pos, gamma0, partner,
                                     shift, u_jump, normal)
    proposal = torch.where(use_de, de_prop, st_prop)
    log_extra = torch.where(use_de, de_extra, st_extra)
    return _metropolis(active_pos, active_lnp, proposal, log_extra,
                       lnpost_batch, u_accept)


def make_step_fn(lnpost_batch, nwalkers, dim, generator, a=2.0,
                 accumulate=False, ensemble_means_fn=None, moves="stretch",
                 de_gamma0=None):
    """One ensemble iteration, in place: ``step(state, record=None)``.

    Two half-ensemble updates, then (when ``accumulate``) the image
    accumulation over the current walkers and the Welford moments, each
    where ``state`` holds buffers for them.  ``record``, a ``(positions
    (cap, nwalkers, dim), log_prob (cap, nwalkers), slot (1,) int64)``
    triple of buffers, takes the step's positions and lnprob at row
    ``slot``, which then advances.  Per half-step the draws are taken
    from ``generator`` in this order: stretch ``u``, ``partner``,
    ``u_accept``; DE ``partner``, ``shift``, ``u_jump``, ``normal``,
    ``u_accept``; mixed ``u`` and then DE's, after one uniform per step
    that picks the move.
    """
    if moves not in MOVES:
        raise ValueError(f"unknown moves {moves!r}: expected 'stretch', 'de' "
                         "or 'mixed'")
    half = nwalkers // 2
    gamma0 = 2.38 / math.sqrt(2.0 * dim) if de_gamma0 is None else float(de_gamma0)

    def half_step(use_de, active_pos, active_lnp, comp_pos):
        k, m = active_pos.shape[0], comp_pos.shape[0]
        dt = active_pos.dtype
        kw = dict(generator=generator, device=active_pos.device)
        if moves != "de":
            u = torch.rand(k, dtype=dt, **kw)
        partner = torch.randint(0, m, (k,), **kw)
        if moves == "stretch":
            u_accept = torch.rand(k, dtype=dt, **kw)
            return stretch_update(active_pos, active_lnp, comp_pos,
                                  lnpost_batch, a, dim, u, partner, u_accept)
        shift = torch.randint(0, m - 1, (k,), **kw)
        u_jump = torch.rand(k, dtype=dt, **kw)
        normal = torch.randn(k, dtype=dt, **kw)
        u_accept = torch.rand(k, dtype=dt, **kw)
        if moves == "de":
            return de_update(active_pos, active_lnp, comp_pos, lnpost_batch,
                             gamma0, partner, shift, u_jump, normal, u_accept)
        return mixed_update(active_pos, active_lnp, comp_pos, lnpost_batch, a,
                            dim, gamma0, use_de, u, partner, shift, u_jump,
                            normal, u_accept)

    def step(state: EnsembleState, record=None):
        pos, lnp = state.positions, state.log_prob
        use_de = None
        if moves == "mixed":  # both halves of a step take the same move
            use_de = torch.rand((), generator=generator, device=pos.device) < 0.5
        p0, l0, acc0 = half_step(use_de, pos[:half], lnp[:half], pos[half:])
        p1, l1, acc1 = half_step(use_de, pos[half:], lnp[half:], p0)
        new_pos = torch.cat([p0, p1], dim=0)
        new_lnp = torch.cat([l0, l1], dim=0)
        if accumulate and state.accum:
            accum, count = merge_image_accumulators(
                state.accum, state.accum_count, ensemble_means_fn(new_pos),
                nwalkers)
            for k, v in accum.items():
                state.accum[k].copy_(v)
            state.accum_count.copy_(count)
        if accumulate and state.moments is not None:
            moments = welford_batch_update(state.moments,
                                           new_pos.to(torch.float64))
            for k, v in moments.items():
                state.moments[k].copy_(v)
        state.naccept.add_(torch.cat([acc0, acc1]))
        pos.copy_(new_pos)
        lnp.copy_(new_lnp)
        if record is not None:
            chain_pos, chain_lnp, slot = record
            chain_pos.index_copy_(0, slot, new_pos[None])
            chain_lnp.index_copy_(0, slot, new_lnp[None])
            slot.add_(1)

    return step


def _vmapped_image_means(images_fn, positions):
    """Mean carry images over the walkers from the per-walker
    ``images_fn``, with ``raw_m2`` (the batch's sum of squared deviations)
    beside each raw image, as the JAX package's ``ensemble_image_means``
    forms them for a posterior without ``ensemble_carry_means``."""
    imgs = [images_fn(p) for p in positions]
    stacked = {k: torch.stack([i[k] for i in imgs]) for k in imgs[0]}
    out = {k: v.mean(dim=0) for k, v in stacked.items()}
    for k, v in stacked.items():
        if k == "raw" or k.endswith("_raw"):
            out[k + "_m2"] = ((v - out[k][None]) ** 2).sum(dim=0)
    return out


def run_stretch_move(lnpost_batch, images_fn, state, nsteps, a=2.0,
                     accumulate=False, record=True, unroll=1,
                     ensemble_means_fn=None, thin=1, moves="stretch",
                     de_gamma0=None, *, generator):
    """``nsteps`` ensemble iterations of :func:`make_step_fn`, eagerly.

    The JAX package's ``run_stretch_move`` with its arguments and returns:
    ``(final_state, chain, lnprob)``, the chain ``(nsteps // thin,
    nwalkers, dim)`` and lnprob ``(nsteps // thin, nwalkers)``, both None
    when ``record=False``; ``thin > 1`` records every thin-th state (a
    ``ValueError`` when it does not divide ``nsteps``) while the image
    accumulation still sees every step.  Every draw comes from
    ``generator`` (a ``torch.Generator`` on the state's device), in
    :func:`make_step_fn`'s order.  ``state`` is left as it was: the steps
    run on a copy, which is returned.  ``unroll`` (a ``lax.scan``
    setting) has no effect here.  ``images_fn(theta) -> {name: image}``
    serves the accumulation when ``ensemble_means_fn`` is not given.
    """
    if record and thin > 1 and nsteps % thin:
        raise ValueError(f"nsteps={nsteps} not divisible by thin={thin}")
    nwalkers, dim = state.positions.shape
    means_fn = ensemble_means_fn
    if accumulate and means_fn is None and images_fn is not None:
        def means_fn(positions):
            return _vmapped_image_means(images_fn, positions)
    step = make_step_fn(lnpost_batch, nwalkers, dim, generator, a=a,
                        accumulate=accumulate, ensemble_means_fn=means_fn,
                        moves=moves, de_gamma0=de_gamma0)
    final = state.clone()
    if not record:
        for _ in range(nsteps):
            step(final)
        return final, None, None
    pos = final.positions
    chain = torch.empty((nsteps // thin, nwalkers, dim), dtype=pos.dtype,
                        device=pos.device)
    lnprob = torch.empty((nsteps // thin, nwalkers), dtype=final.log_prob.dtype,
                         device=pos.device)
    rec = (chain, lnprob, torch.zeros(1, dtype=torch.int64, device=pos.device))
    for i in range(nsteps):
        step(final, rec if (i + 1) % thin == 0 else None)
    return final, chain, lnprob


def _host(t, dtype=torch.float64):
    """A numpy copy of ``t`` (never a view of a buffer that steps write)."""
    return t.to("cpu", dtype, copy=True).numpy()


class _StepGraph:
    """A captured step and the kernel launches one replay executes."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches

    def replay(self):
        self.graph.replay()
        counts.add(self.launches)


def capture_step(step, live, scratch, generator, stream, pool):
    """Capture ``step(*live)`` into a CUDA graph on ``stream`` in ``pool``.

    The warm-up that capture needs (the kernels' builds, cuBLAS's handle
    and workspace, the lazily copied constants) runs ``step(*scratch)``,
    on scratch copies of the buffers, with its launches left uncounted
    and ``generator``'s state restored after it: the buffers, the
    generator and the counts move only by replays.  Python's collector is
    paused over the capture (:func:`~psfmc_tpu_torch._device.gc_paused`).
    Both run under one ``psfmc.capture`` span.
    """
    with span("psfmc.capture"):
        current = torch.cuda.current_stream(stream.device)
        rng_state = generator.get_state()
        stream.wait_stream(current)
        with torch.cuda.stream(stream), counts.tally():
            step(*scratch)
        current.wait_stream(stream)
        generator.set_state(rng_state)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with counts.tally() as launches, gc_paused():
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                step(*live)
    return _StepGraph(graph, launches)


@contextlib.contextmanager
def _eager(sampler):
    """Run ``sampler``'s steps eagerly on CUDA, as on the CPU: the
    yardstick the card tests and ``chip_smoke.py`` hold the graphed
    phase against.  No public switch selects it."""
    graphed, sampler._graphed = sampler._graphed, False
    try:
        yield sampler
    finally:
        sampler._graphed = graphed


class EnsembleSampler:
    """emcee-2.x-style sampler: ``init_state``, ``run_burn``, ``reset``,
    ``run_sampling``, ``sample`` and the ``chain`` / ``lnprobability`` /
    ``acceptance_fraction`` / ``accumulated_images`` /
    ``posterior_moments`` accessors.

    ``posterior_fns`` needs ``log_posterior_batch(thetas)``, ``device``
    and ``dtype``; with ``ensemble_carry_means(thetas)`` and
    ``carry_image_shapes()`` the sampler also accumulates posterior-mean
    images during retained sampling.

    ``moves``: ``"stretch"`` (emcee 2.x), ``"de"`` or ``"mixed"`` (see
    the module doc); ``de_gamma0`` overrides DE's ``2.38 / sqrt(2
    dim)``.  ``thin`` records every thin-th retained step (image
    accumulation and acceptance still cover every step);
    ``track_moments`` keeps float64 Welford moments of every retained
    step on the device (:attr:`posterior_moments`).

    ``sharding`` (:func:`~psfmc_tpu_torch.parallel.walker_sharding`)
    splits every posterior evaluation's walkers over a mesh, the state
    replicated on every rank (:mod:`psfmc_tpu_torch.parallel.mesh`); the
    device defaults to the mesh's, and steps are graphed where the mesh's
    are (:attr:`~psfmc_tpu_torch.parallel.WalkerMesh.graphed`).
    """

    checkpoint_kind = "ensemble"

    def __init__(self, nwalkers: int, dim: int, posterior_fns, a: float = 2.0,
                 seed: int = 0, device=None, thin: int = 1,
                 track_moments: bool = False, moves: str = "stretch",
                 de_gamma0: Optional[float] = None, sharding=None):
        if nwalkers % 2 != 0:
            raise ValueError("nwalkers must be even for half-ensemble moves")
        if moves not in MOVES:
            raise ValueError(f"unknown moves {moves!r}: expected 'stretch', "
                             "'de' or 'mixed'")
        if thin < 1:
            raise ValueError("thin must be >= 1")
        if nwalkers < 2 * dim + 2:
            warnings.warn(
                f"nwalkers={nwalkers} is fewer than the recommended "
                f"2*dim+2={2 * dim + 2}"
            )
        check_sharding(sharding)
        if device is None and sharding is not None:
            device = sharding.mesh.device
        self.device = resolve_device(device)
        if torch.device(posterior_fns.device) != self.device:
            raise ValueError(
                f"posterior is on {posterior_fns.device}, sampler on "
                f"{self.device}"
            )
        self.sharding = sharding
        posterior_fns = shard_posterior(posterior_fns, sharding)
        self.nwalkers = nwalkers
        self.dim = dim
        self.a = float(a)
        self.moves = moves
        self.de_gamma0 = None if de_gamma0 is None else float(de_gamma0)
        self.thin = int(thin)
        self.track_moments = bool(track_moments)
        self.fns = posterior_fns
        self.dtype = posterior_fns.dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._means_fn = getattr(posterior_fns, "ensemble_carry_means", None)
        self.state: Optional[EnsembleState] = None
        self._record = None  # chain buffers of make_step_fn's ``record``
        self._steps = {}  # accumulate -> step function
        self._graphs = {}  # variant -> _StepGraph
        self._pool = None
        self._stream = None
        self._graphed = steps_graphed(self.device, sharding, posterior_fns)
        self.graph_replays = 0  # steps run as a replay of a captured graph
        self.graph_captures = 0  # graphs captured
        self._chain = None  # numpy (nwalkers, nsteps, dim), emcee layout
        self._lnprob = None  # numpy (nwalkers, nsteps)
        self._naccept = np.zeros(nwalkers, dtype=np.int64)
        self._nsteps_total = 0

    # -- state -----------------------------------------------------------
    def _walkers(self, p):
        p = torch.as_tensor(p, dtype=self.dtype, device=self.device)
        if p.shape != (self.nwalkers, self.dim):
            raise ValueError(
                f"p0 must be ({self.nwalkers}, {self.dim}), got {tuple(p.shape)}"
            )
        return p

    def init_state(self, p0):
        """Set the walkers to ``p0`` ``(nwalkers, dim)``, evaluate them,
        and zero the accept counts, image accumulators and moments.  The
        first call allocates the sampler's buffers; later calls write
        into them."""
        p0 = self._walkers(p0)
        lnp = self.fns.log_posterior_batch(p0)
        if self.state is None:
            z = dict(dtype=torch.int64, device=self.device)
            moments = None
            if self.track_moments:
                f64 = dict(dtype=torch.float64, device=self.device)
                moments = {"mean": torch.zeros(self.dim, **f64),
                           "m2": torch.zeros(self.dim, **f64),
                           "n": torch.zeros((), **z)}
            self.state = EnsembleState(
                positions=p0.clone(), log_prob=lnp.clone(),
                accum=fresh_image_accumulators(self.fns, self.device),
                accum_count=torch.zeros((), **z),
                naccept=torch.zeros(self.nwalkers, **z), moments=moments)
        else:
            self.state.positions.copy_(p0)
            self.state.log_prob.copy_(lnp)
            self._zero_counters()
        return self.state

    def _zero_counters(self):
        s = self.state
        s.naccept.zero_()
        s.accum_count.zero_()
        for v in s.accum.values():
            v.zero_()
        for v in (s.moments or {}).values():
            v.zero_()

    def _reseat(self, p):
        """New walker positions, evaluated; the rest of the state stays."""
        p = self._walkers(p)
        lnp = self.fns.log_posterior_batch(p)
        self.state.positions.copy_(p)
        self.state.log_prob.copy_(lnp)

    @property
    def rng_kind(self):
        """Kind of generator whose state a checkpoint carries."""
        return f"torch-{self.device.type}"

    def rejuvenate_stuck(self, random_state=None, floor_sigmas=20.0,
                         min_drop=50.0):
        """Burn-phase rescue: copy stranded walkers onto healthy ones.

        A walker whose lnp is not finite or lies below ``median -
        max(min_drop, floor_sigmas * 1.4826 * MAD)`` takes the position
        of a randomly chosen healthy walker (``random_state``, a numpy
        RandomState or seed); the ensemble's lnp is then re-evaluated in
        one batched call.  Refuses (returns 0) when half the ensemble or
        more is below the floor.  Call between burn segments only.

        :returns: the number of walkers moved.
        """
        rng = (random_state if isinstance(random_state, np.random.RandomState)
               else np.random.RandomState(random_state))
        lnp = _host(self.state.log_prob)
        finite = np.isfinite(lnp)
        if not finite.any():
            return 0
        med = np.median(lnp[finite])
        mad = np.median(np.abs(lnp[finite] - med))
        floor = med - max(float(min_drop), float(floor_sigmas) * 1.4826 * mad)
        stuck = ~finite | (lnp < floor)
        n_stuck = int(stuck.sum())
        if n_stuck == 0 or n_stuck >= self.nwalkers // 2:
            return 0
        donors = rng.choice(np.flatnonzero(~stuck), size=n_stuck)
        pos = _host(self.state.positions)
        pos[stuck] = pos[donors]
        self._reseat(pos)
        return n_stuck

    def reset(self):
        """Clear the chain, acceptance counts, image accumulators and
        moments; keep the walker positions (emcee's ``reset()``)."""
        self._chain = None
        self._lnprob = None
        self._naccept = np.zeros(self.nwalkers, dtype=np.int64)
        self._nsteps_total = 0
        if self.state is not None:
            self._zero_counters()

    # -- steps -----------------------------------------------------------
    def _step_fn(self, accumulate):
        fn = self._steps.get(accumulate)
        if fn is None:
            fn = self._steps[accumulate] = make_step_fn(
                self.fns.log_posterior_batch, self.nwalkers, self.dim,
                self.generator, a=self.a, accumulate=accumulate,
                ensemble_means_fn=self._means_fn, moves=self.moves,
                de_gamma0=self.de_gamma0)
        return fn

    def _step(self, variant):
        """One step of ``variant`` (``"burn"``, ``"retain"``, ``"record"``):
        a replay of its graph on CUDA, the step function elsewhere."""
        record = self._record if variant == "record" else None
        if not self._graphed:
            self._step_fn(variant != "burn")(self.state, record)
            return
        graph = self._graphs.get(variant)
        if graph is None:
            graph = self._graphs[variant] = self._capture(variant)
            self.graph_captures += 1
        graph.replay()
        self.graph_replays += 1

    def _capture(self, variant):
        """Capture one step of ``variant`` into a CUDA graph
        (:func:`capture_step`, warmed up on scratch copies of the
        buffers): the chain, the generator and the counts move only by
        replays."""
        step = self._step_fn(variant != "burn")
        record = self._record if variant == "record" else None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        scratch_record = None if record is None else tuple(t.clone() for t in record)
        return capture_step(step, (self.state, record),
                            (self.state.clone(), scratch_record),
                            self.generator, self._stream, self._pool)

    def _use_record(self, nrec):
        """Chain buffers of at least ``nrec`` rows, the slot at row 0; a
        larger buffer drops the graph that wrote the old one."""
        if self._record is None or self._record[0].shape[0] < nrec:
            kw = dict(dtype=self.dtype, device=self.device)
            self._record = (
                torch.empty((nrec, self.nwalkers, self.dim), **kw),
                torch.empty((nrec, self.nwalkers), **kw),
                torch.zeros(1, dtype=torch.int64, device=self.device))
            self._graphs.pop("record", None)
        self._record[2].zero_()

    def _cold_naccept(self):
        """Accept counts of the walkers the chain records."""
        return self.state.naccept

    # -- phases ----------------------------------------------------------
    @staticmethod
    def _segments(nsteps: int, segment):
        """Split ``nsteps`` into segment lengths (``None``: one segment)."""
        if segment is None or segment >= nsteps:
            return [nsteps]
        segment = max(1, int(segment))
        out = [segment] * (nsteps // segment)
        if nsteps % segment:
            out.append(nsteps % segment)
        return out

    def _advance_segment(self, n: int, storechain: bool = True,
                         burn: bool = False):
        """``n`` steps and all the bookkeeping, for ``run_burn``,
        ``run_sampling`` and ``sample()`` alike.  Returns the segment's
        recorded (chain, lnprob) in emcee layout, ``(None, None)`` for a
        burn segment.

        The steps run under a ``psfmc.steps`` span that ends in the accept
        counts' copy to the host, which waits for them; the bookkeeping
        and the chain's copy to the host under ``psfmc.readout``."""
        if self.state is None:
            raise RuntimeError("call init_state(p0) first")
        thin = 1 if burn else self.thin
        nrec = 0 if burn else n // thin
        with span("psfmc.steps"):
            if nrec:
                self._use_record(nrec)
            start_accept = self._cold_naccept().clone()
            for i in range(int(n)):
                if burn:
                    self._step("burn")
                else:
                    self._step("record" if (i + 1) % thin == 0 else "retain")
            accepted = (self._cold_naccept() - start_accept).cpu()
        with span("psfmc.readout"):
            self._naccept += accepted.numpy()
            self._nsteps_total += int(n)
            if not nrec:
                return None, None
            # one device -> host transfer per segment; emcee layout
            chain, lnprob = (np.ascontiguousarray(_host(t[:nrec]).swapaxes(0, 1))
                             for t in self._record[:2])
            if storechain:
                if self._chain is None:
                    self._chain, self._lnprob = chain, lnprob
                else:
                    self._chain = np.concatenate([self._chain, chain], axis=1)
                    self._lnprob = np.concatenate([self._lnprob, lnprob], axis=1)
        return chain, lnprob

    def run_burn(self, nsteps: int, segment=None, callback=None):
        """Burn-in: no chain recording, no image accumulation.

        ``segment`` splits the phase so that ``callback(done, total)``
        can report progress and write checkpoints between segments.
        """
        done = 0
        for n in self._segments(int(nsteps), segment):
            self._advance_segment(n, burn=True)
            done += n
            if callback is not None:
                callback(done, nsteps)
        return self

    def run_sampling(self, nsteps: int, segment=None, callback=None):
        """Retained sampling: records every thin-th step and accumulates
        images and moments over every step (``segment``/``callback`` as
        for :meth:`run_burn`; segments round to thinning boundaries)."""
        if nsteps % self.thin:
            raise ValueError(f"nsteps={nsteps} not divisible by thin={self.thin}")
        if segment is not None and self.thin > 1:
            segment = max(self.thin, (segment // self.thin) * self.thin)
        done = 0
        for n in self._segments(int(nsteps), segment):
            self._advance_segment(n)
            done += n
            if callback is not None:
                callback(done, nsteps)
        return self

    def sample(self, p0=None, lnprob0=None, rstate0=None, iterations=1,
               thin=1, storechain=True, segment=None, **kwargs):
        """emcee-2.x-style step generator: yields ``(pos, lnprob, rstate)``.

        One tuple per iteration, replayed from the chain each segment of
        ``segment`` steps (default: the whole call) records.  A new
        ``p0`` re-seats the walkers and keeps the image accumulators
        running; ``storechain=False`` discards the recorded chain.
        ``rstate`` is the generator's state after the segment (the JAX
        package yields its PRNG key there); ``lnprob0`` and ``rstate0``
        are accepted and ignored, and there is no fourth "blobs" element.
        """
        unknown = set(kwargs) - {"blobs0", "mh_proposal"}
        if unknown:
            raise TypeError(
                f"sample() got unexpected keyword arguments {sorted(unknown)}")
        if kwargs.get("mh_proposal") is not None:
            raise ValueError("mh_proposal is not supported (stretch/DE moves only)")
        if thin != 1 or self.thin != 1:
            raise ValueError(
                "sample() yields every step: thin must be 1 (use "
                "run_sampling(thin=...) for on-device thinning)")
        if self.state is None:
            if p0 is None:
                raise ValueError("no current sampler state: pass p0")
            self.init_state(p0)
        elif p0 is not None:
            self._reseat(p0)
        it = int(iterations)
        if it <= 0:
            return
        for n in self._segments(it, segment):
            chain, lnprob = self._advance_segment(n, storechain=storechain)
            rstate = self.generator.get_state()
            for s in range(n):
                yield chain[:, s, :], lnprob[:, s], rstate

    def clear_blobs(self):
        """No-op parity shim: per-step model images never reach the host
        (they accumulate on the device, ``accumulated_images``)."""

    # -- checkpoint / resume -----------------------------------------------
    def checkpoint_payload(self):
        """Full resume state as a dict of host arrays (checkpoint v2,
        with the generator's state in place of a JAX PRNG key)."""
        s = self.state
        return {
            "version": 2,
            "ntemps": 1,
            "positions": _host(s.positions),
            "log_prob": _host(s.log_prob),
            "naccept": _host(s.naccept, torch.int64),
            "nsteps": int(self._nsteps_total),
            "rng_kind": self.rng_kind,
            "rng_state": self.generator.get_state().numpy().copy(),
            "accum": {k: _host(v, v.dtype) for k, v in s.accum.items()},
            "accum_count": int(s.accum_count),
        }

    def restore_state(self, payload):
        """Rebuild the state from a :meth:`checkpoint_payload` dict, in
        the sampler's buffers.

        Log-probabilities are recomputed (one batched evaluation);
        positions, accumulators, accept counts and the generator state
        are restored exactly; a tempered checkpoint gives its cold rung.
        Raises ``ValueError`` for a checkpoint whose generator is not
        this sampler's kind.
        """
        self._check_rng_kind(payload)
        positions = np.asarray(payload["positions"], np.float64)
        if positions.ndim == 3:  # a tempered checkpoint: its cold rung
            positions = positions[0]
        self.init_state(positions)
        self.generator.set_state(torch.as_tensor(
            np.asarray(payload["rng_state"], np.uint8)))
        restore_image_accumulators(self.state.accum, self.state.accum_count, payload)
        naccept = np.asarray(payload.get("naccept", 0), np.int64)
        if naccept.ndim == 2:
            naccept = naccept[0]
        if naccept.shape == (self.nwalkers,):
            self.state.naccept.copy_(torch.as_tensor(naccept))
            self._naccept = naccept.copy()
            self._nsteps_total = int(payload.get("nsteps", 0))
        return self.state

    def _check_rng_kind(self, payload):
        kind = payload.get("rng_kind")
        if kind != self.rng_kind:
            raise ValueError(
                f"checkpoint generator {kind!r} cannot be restored into a "
                f"{self.rng_kind!r} sampler"
            )

    # -- emcee-compatible accessors ----------------------------------------
    @property
    def chain(self):
        """``(nwalkers, nrecorded, dim)`` float64 numpy, or None."""
        return self._chain

    @property
    def lnprobability(self):
        """``(nwalkers, nrecorded)`` float64 numpy, or None."""
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
        for a posterior without carry images."""
        if self.state is None or not self.state.accum:
            return None
        return {k: _host(v, v.dtype) for k, v in self.state.accum.items()}

    @property
    def accumulated_samples(self):
        return 0 if self.state is None else int(self.state.accum_count)

    def get_autocorr_time(self, c=1):
        """Integrated autocorrelation time of the walker-averaged chain
        (emcee 2.x); raises :class:`~.autocorr.AutocorrError` when the
        chain is too short."""
        if self._chain is None:
            raise ValueError("No chain recorded yet")
        return integrated_time(np.mean(self._chain, axis=0), axis=0, c=c)

    @property
    def posterior_moments(self):
        """(mean, std) per parameter from the on-device float64 Welford
        moments over every retained step since the last reset (including
        the steps ``thin`` dropped from the chain); None unless
        ``track_moments``."""
        if self.state is None or self.state.moments is None:
            return None
        m = self.state.moments
        n = max(int(m["n"]), 1)
        mean = _host(m["mean"])
        var = _host(m["m2"]) / max(n - 1, 1)
        return mean, np.sqrt(var)
