"""No-U-Turn Sampler over the posterior's gradient (port of ``sampler/nuts.py``).

Hamiltonian Monte Carlo with multinomial NUTS (Hoffman & Gelman 2014;
iterative tree building with a checkpoint stack as in Phan et al. 2019,
memory O(max_depth)), as in the JAX package:

* sampling runs in the unconstrained space of :class:`~psfmc_tpu_torch.
  models.transforms.UnconstrainingTransform`; the potential is ``U(z) =
  -(lnpost(theta(z)) + log|J|)`` with the discrete PSF index
  marginalized by a logsumexp over the PSFs, and its gradient comes from
  the posterior's gradient path (``differentiable_log_posterior``: the
  render and conv_lnl kernels with their backward kernels on the card);
* each retained draw Gibbs-samples the PSF index from the posterior's own
  likelihood path (``log_posterior_batch``);
* the warmup is Stan's: dual-averaging step size (target accept 0.8), 15%
  step-size-only, doubling windows of a pooled-Welford diagonal metric to
  90% (each window end sets the metric and restarts dual averaging), the
  rest step-size-only;
* the chains are the batch axis: every leapfrog evaluates every chain in
  one batched gradient call.

The JAX package nests two data-dependent ``lax.while_loop`` under
``vmap``.  Here every chain carries its own tree, its own ``active``,
``turning`` and ``diverging`` flags, and all chains advance leaf by leaf
in lockstep: a chain that stopped holds its carry, as ``vmap`` of
``lax.while_loop`` does, and the leaf counter is the same for every
active chain within a doubling.  A transition is a host loop over five
pieces (:func:`begin_step`, :func:`begin_doubling`, :func:`leaf`,
:func:`end_doubling`, and an end-of-step piece: dual averaging and
Welford in the warmup, the record and the image accumulation in the
retained phase), with one more piece for the warmup's window switch; the
host reads one device flag ("any chain still active") after each leaf
and after each doubling, so a step runs at most ``2^max_depth - 1``
leaves, the work of the JAX package's vmapped loop.  The window bounds
are known on the host, which replays the switch after the steps that end
a window.

The state lives in persistent buffers (:class:`NUTSState`) written in
place.  On CUDA every piece is a replay of a captured CUDA graph
(:func:`~.ensemble.capture_step`, one graph per piece, all captured
before the first step of a phase); nothing inside a piece copies to the
host or synchronizes.  ``_eager(sampler)`` (the ensemble sampler's
private context) runs the same pieces eagerly: the yardstick.

Every random draw is an argument (:class:`NUTSDraws`): the momentum
normal ``(B, m)``; per doubling a direction uniform (right where below
1/2) and a switch uniform; per leaf a take uniform; per retained step a
Gumbel sample ``(B, num_psfs)`` for the PSF index.  A test can hand in
the JAX package's draws.  Differences of form from the JAX package are
the ensemble sampler's: a ``torch.Generator`` in place of the PRNG key,
its state in the checkpoint (``rng_kind``, ``rng_state``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from ..models.posterior import value_and_grad
from ..models.transforms import build_transform
from ..optimize import _lnpost_batch, marginal_lnpost_theta, psf_fan_out
from .autocorr import integrated_time
from .ensemble import _eager  # noqa: F401  (the eager yardstick, see the module doc)
from .ensemble import (
    EnsembleSampler,
    _host,
    capture_step,
    fresh_image_accumulators,
    merge_image_accumulators,
    restore_image_accumulators,
    welford_batch_update,
)

__all__ = [
    "NUTSDraws",
    "NUTSState",
    "NUTSSampler",
    "nuts_kernel",
    "begin_step",
    "begin_doubling",
    "leaf",
    "end_doubling",
    "run_transition",
    "warmup_windows",
]

_MAX_DELTA = 1000.0  # divergence threshold on the Hamiltonian error
# dual averaging (Hoffman & Gelman 2014, sec 3.2)
_DA_GAMMA, _DA_T0, _DA_KAPPA, _DA_TARGET = 0.05, 10.0, 0.75, 0.8

# the pieces of a warmup step and of a retained step
WARMUP_PIECES = ("begin_step", "begin_doubling", "leaf", "end_doubling", "warm_end",
                 "warm_end_window", "switch")
SAMPLE_PIECES = ("begin_step", "begin_doubling", "leaf", "end_doubling", "sample_end")


class NUTSDraws:
    """The random draws of NUTS, each from one ``torch.Generator``."""

    def __init__(self, generator, device):
        self.generator = generator
        self.device = device

    def _uniform(self, shape, dtype):
        return torch.rand(shape, dtype=dtype, generator=self.generator,
                          device=self.device)

    def momentum(self, shape, dtype):
        return torch.randn(shape, dtype=dtype, generator=self.generator,
                           device=self.device)

    direction = take = switch = _uniform

    def gumbel(self, shape, dtype):
        u = torch.clamp_min(self._uniform(shape, dtype), torch.finfo(dtype).tiny)
        return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Hamiltonian pieces, batched over chains: (B, m) tensors
# ---------------------------------------------------------------------------


def _kinetic(r, inv_mass):
    return 0.5 * (r * r * inv_mass).sum(-1)


def _leapfrog(u_vg, eps, inv_mass, z, r, grad):
    """One leapfrog step of each chain (``eps`` ``(B, 1)``); U = -lnpost_u."""
    r = r - 0.5 * eps * grad
    z = z + eps * r * inv_mass
    u, grad = u_vg(z)
    r = r - 0.5 * eps * grad
    return z, r, grad, u


def _is_turning(r_left, r_right, r_sum, inv_mass):
    """Generalized U-turn criterion over the last axis."""
    v_left = r_left * inv_mass
    v_right = r_right * inv_mass
    return ((v_left * r_sum).sum(-1) <= 0) | ((v_right * r_sum).sum(-1) <= 0)


def _popcount(n, bits):
    c = torch.zeros_like(n)
    for b in range(bits):
        c = c + ((n >> b) & 1)
    return c


def _trailing_ones(n, bits):
    t = torch.zeros_like(n)
    done = torch.zeros_like(n, dtype=torch.bool)
    for b in range(bits):
        bit = ((n >> b) & 1) == 1
        t = t + (bit & ~done).to(n.dtype)
        done = done | ~bit
    return t


def _put(dst, new, mask):
    """``dst = where(mask, new, dst)`` in place, ``mask`` over the chains."""
    dst.copy_(torch.where(mask.view(-1, *([1] * (dst.dim() - 1))), new, dst))


# ---------------------------------------------------------------------------
# The state and the pieces of a transition
# ---------------------------------------------------------------------------
#
# A doubling simulates 2^depth new leaves.  NUTS rejects the doubling if
# any dyadic subtree of the new half makes a U-turn.  The subtree [l, i]
# of size 2^j completes at leaf i with (i+1) % 2^j == 0; its left endpoint
# l = i+1-2^j is an even leaf.  Each even leaf's state goes to the
# checkpoint stack at position popcount(leaf), so leaf i (odd) finds the
# left endpoints of its popcount(i)-trailing_ones(i) .. popcount(i)-1
# subtrees there.


@dataclass
class NUTSState:
    """The sampler's persistent buffers, updated in place: the chains'
    state, the tree of the current transition (``sub_*`` the subtree of
    the current doubling, ``*_ck`` its checkpoint stack), dual averaging,
    the pooled Welford moments, the phase's totals and the image
    accumulators."""

    z: torch.Tensor  # (B, m) position in unconstrained space
    u: torch.Tensor  # (B,) potential
    grad: torch.Tensor  # (B, m) dU/dz
    eps: torch.Tensor  # () step size
    inv_mass: torch.Tensor  # (m,) diagonal inverse metric
    # the tree: left and right ends, proposal, weight, momentum sum
    h0: torch.Tensor
    zl: torch.Tensor
    rl: torch.Tensor
    gl: torch.Tensor
    zr: torch.Tensor
    rr: torch.Tensor
    gr: torch.Tensor
    zp: torch.Tensor
    up: torch.Tensor
    gp: torch.Tensor
    logw: torch.Tensor
    r_sum: torch.Tensor
    depth: torch.Tensor  # (B,) int64
    turning: torch.Tensor  # (B,) bool
    diverging: torch.Tensor
    active: torch.Tensor  # (B,) bool: the chain's tree still grows
    sum_ap: torch.Tensor  # (B,) accept-probability sum
    n_ap: torch.Tensor  # (B,) int64
    n_leapfrog: torch.Tensor  # (B,) int64
    # the doubling
    go_right: torch.Tensor  # (B,) bool
    eps_d: torch.Tensor  # (B,) signed step
    # the subtree: the current leaf and the subtree's own sums
    leaf: torch.Tensor  # (B,) int64
    sub_z: torch.Tensor
    sub_r: torch.Tensor
    sub_g: torch.Tensor
    sub_r_sum: torch.Tensor
    sub_logw: torch.Tensor
    sub_zp: torch.Tensor
    sub_up: torch.Tensor
    sub_gp: torch.Tensor
    sub_turning: torch.Tensor
    sub_diverging: torch.Tensor
    sub_sum_ap: torch.Tensor
    sub_n_ap: torch.Tensor
    sub_active: torch.Tensor  # (B,) bool: the chain runs the next leaf
    z_ck: torch.Tensor  # (B, max_depth + 1, m)
    r_ck: torch.Tensor
    rs_ck: torch.Tensor
    flag: torch.Tensor  # () bool: any chain active (what the host reads)
    # dual averaging
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    da_t: torch.Tensor
    # pooled Welford moments of the mass window
    wf_n: torch.Tensor  # () int64
    wf_mean: torch.Tensor  # (m,)
    wf_m2: torch.Tensor
    # the phase's totals
    tot_accept: torch.Tensor  # () float64: per-step mean accept statistic
    tot_leapfrog: torch.Tensor  # () int64
    tot_divergent: torch.Tensor  # () int64
    accum: Dict[str, torch.Tensor]  # running-mean images (empty: none)
    accum_count: torch.Tensor  # () int64

    # the fields by shape and dtype; every other one is (B, m) in the float
    # dtype (``flag`` () bool, ``tot_accept`` () float64)
    _SCALARS = ("eps", "log_eps", "log_eps_bar", "h_bar", "mu", "da_t")
    _METRIC = ("inv_mass", "wf_mean", "wf_m2")
    _ROWS = ("u", "h0", "up", "logw", "sum_ap", "eps_d", "sub_logw", "sub_up",
             "sub_sum_ap")
    _COUNTS = ("depth", "n_ap", "n_leapfrog", "leaf", "sub_n_ap")
    _FLAGS = ("turning", "diverging", "active", "go_right", "sub_turning",
              "sub_diverging", "sub_active")
    _STACK = ("z_ck", "r_ck", "rs_ck")
    _TOTALS = ("wf_n", "tot_leapfrog", "tot_divergent", "accum_count")

    @classmethod
    def allocate(cls, nchains, zdim, max_depth, dtype, device, accum=None):
        """Zeroed buffers (the metric at the identity) for ``nchains``
        chains of ``zdim`` unconstrained coordinates."""
        b, m = nchains, zdim
        f = dict(dtype=dtype, device=device)
        shapes = {}
        shapes.update(dict.fromkeys(cls._SCALARS, ((), f)))
        shapes.update(dict.fromkeys(cls._METRIC, ((m,), f)))
        shapes.update(dict.fromkeys(cls._ROWS, ((b,), f)))
        shapes.update(dict.fromkeys(cls._COUNTS, ((b,), dict(dtype=torch.int64,
                                                              device=device))))
        shapes.update(dict.fromkeys(cls._FLAGS, ((b,), dict(dtype=torch.bool,
                                                             device=device))))
        shapes.update(dict.fromkeys(cls._STACK, ((b, max_depth + 1, m), f)))
        shapes.update(dict.fromkeys(cls._TOTALS, ((), dict(dtype=torch.int64,
                                                            device=device))))
        shapes["flag"] = ((), dict(dtype=torch.bool, device=device))
        shapes["tot_accept"] = ((), dict(dtype=torch.float64, device=device))
        kw = {}
        for fld in fields(cls):
            if fld.name != "accum":
                shape, where = shapes.get(fld.name, ((b, m), f))
                kw[fld.name] = torch.zeros(shape, **where)
        kw["inv_mass"].fill_(1.0)
        return cls(accum=accum or {}, **kw)

    def clone(self):
        return NUTSState(**{f.name: ({k: v.clone() for k, v in getattr(self, f.name).items()}
                                     if f.name == "accum" else getattr(self, f.name).clone())
                            for f in fields(self)})


def begin_step(s, draws, max_depth):
    """The momentum, the initial energy ``h0`` and the one-leaf tree."""
    r0 = draws.momentum(s.z.shape, s.z.dtype) / torch.sqrt(s.inv_mass)
    s.h0.copy_(s.u + _kinetic(r0, s.inv_mass))
    for t in (s.zl, s.zr, s.zp):
        t.copy_(s.z)
    for t in (s.rl, s.rr, s.r_sum):
        t.copy_(r0)
    for t in (s.gl, s.gr, s.gp):
        t.copy_(s.grad)
    s.up.copy_(s.u)
    for t in (s.logw, s.sum_ap, s.n_ap, s.n_leapfrog, s.depth, s.turning, s.diverging):
        t.zero_()
    s.active.fill_(max_depth > 0)
    s.flag.fill_(max_depth > 0)


def begin_doubling(s, draws):
    """The direction of the doubling, its start point and signed step,
    and an empty subtree; the active chains run its first leaf."""
    go_right = draws.direction(s.u.shape, s.z.dtype) < 0.5
    s.go_right.copy_(go_right)
    right = go_right[:, None]
    s.sub_z.copy_(torch.where(right, s.zr, s.zl))
    s.sub_r.copy_(torch.where(right, s.rr, s.rl))
    s.sub_g.copy_(torch.where(right, s.gr, s.gl))
    s.eps_d.copy_(torch.where(go_right, s.eps, -s.eps))
    s.sub_zp.copy_(s.sub_z)
    s.sub_gp.copy_(s.sub_g)
    s.sub_logw.fill_(-math.inf)
    for t in (s.sub_up, s.sub_r_sum, s.leaf, s.sub_turning, s.sub_diverging, s.sub_sum_ap,
              s.sub_n_ap, s.z_ck, s.r_ck, s.rs_ck):
        t.zero_()
    s.sub_active.copy_(s.active)


def leaf(s, u_vg, draws):
    """One leaf of every chain still running its subtree: a leapfrog with
    its gradient, progressive multinomial sampling within the subtree, the
    checkpoint store (even leaves) and the U-turn checks of every dyadic
    subtree ending here (odd leaves), all masked per chain."""
    act = s.sub_active
    bits = s.z_ck.shape[1]
    u_take = draws.take(act.shape, s.z.dtype)
    z, r, g, u = _leapfrog(u_vg, s.eps_d[:, None], s.inv_mass, s.sub_z, s.sub_r, s.sub_g)
    dh = u + _kinetic(r, s.inv_mass) - s.h0
    ok = dh <= _MAX_DELTA  # NaN compares False: a divergence
    logw_leaf = torch.where(ok, -dh, torch.full_like(dh, -math.inf))
    logw_new = torch.logaddexp(s.sub_logw, logw_leaf)
    p_take = torch.exp(logw_leaf - torch.where(torch.isfinite(logw_new), logw_new,
                                               torch.zeros_like(logw_new)))
    take = (u_take < p_take) & ok
    zp = torch.where(take[:, None], z, s.sub_zp)
    up = torch.where(take, u, s.sub_up)
    gp = torch.where(take[:, None], g, s.sub_gp)
    sum_ap = s.sub_sum_ap + torch.where(ok, torch.clamp_max(torch.exp(-dh), 1.0),
                                        torch.zeros_like(dh))

    n = s.leaf
    slots = torch.arange(bits, device=n.device)
    pc = _popcount(n, bits)
    store = (((n % 2) == 0)[:, None] & (slots == pc[:, None]))[..., None]
    z_ck = torch.where(store, z[:, None], s.z_ck)
    r_ck = torch.where(store, r[:, None], s.r_ck)
    rs_ck = torch.where(store, s.sub_r_sum[:, None], s.rs_ck)
    r_sum = s.sub_r_sum + r
    idx_max = pc - 1
    idx_min = idx_max - _trailing_ones(n, bits) + 1
    check = (((n % 2) == 1)[:, None] & (idx_min[:, None] <= slots)
             & (slots <= idx_max[:, None]))
    turn = _is_turning(r_ck, r[:, None], r_sum[:, None] - rs_ck, s.inv_mass)
    turning = (check & turn).any(dim=1)

    for dst, new in ((s.sub_z, z), (s.sub_r, r), (s.sub_g, g), (s.sub_r_sum, r_sum),
                     (s.sub_logw, logw_new), (s.sub_zp, zp), (s.sub_up, up),
                     (s.sub_gp, gp), (s.sub_turning, turning), (s.sub_diverging, ~ok),
                     (s.sub_sum_ap, sum_ap), (s.sub_n_ap, s.sub_n_ap + 1),
                     (s.z_ck, z_ck), (s.r_ck, r_ck), (s.rs_ck, rs_ck), (s.leaf, n + 1)):
        _put(dst, new, act)
    s.sub_active.copy_(act & (s.leaf < (torch.ones_like(s.depth) << s.depth))
                       & ~s.sub_turning & ~s.sub_diverging)
    s.flag.copy_(s.sub_active.any())


def end_doubling(s, draws, max_depth):
    """Merge the subtree into the tree (biased progressive sampling of the
    proposal, the moved end, the full tree's U-turn) for the chains that
    ran this doubling; the others hold."""
    act = s.active
    u_switch = draws.switch(act.shape, s.z.dtype)
    ok = ~s.sub_turning & ~s.sub_diverging
    p_switch = torch.clamp_max(torch.exp(s.sub_logw - s.logw), 1.0)
    switch = ok & (u_switch < p_switch)
    sw = switch[:, None]
    zp = torch.where(sw, s.sub_zp, s.zp)
    up = torch.where(switch, s.sub_up, s.up)
    gp = torch.where(sw, s.sub_gp, s.gp)
    logw = torch.where(ok, torch.logaddexp(s.logw, s.sub_logw), s.logw)
    right = (ok & s.go_right)[:, None]
    left = (ok & ~s.go_right)[:, None]
    zr = torch.where(right, s.sub_z, s.zr)
    rr = torch.where(right, s.sub_r, s.rr)
    gr = torch.where(right, s.sub_g, s.gr)
    zl = torch.where(left, s.sub_z, s.zl)
    rl = torch.where(left, s.sub_r, s.rl)
    gl = torch.where(left, s.sub_g, s.gl)
    r_sum = torch.where(ok[:, None], s.r_sum + s.sub_r_sum, s.r_sum)
    turning = s.sub_turning | (ok & _is_turning(rl, rr, r_sum, s.inv_mass))
    for dst, new in ((s.zp, zp), (s.up, up), (s.gp, gp), (s.logw, logw), (s.zr, zr),
                     (s.rr, rr), (s.gr, gr), (s.zl, zl), (s.rl, rl), (s.gl, gl),
                     (s.r_sum, r_sum), (s.turning, turning), (s.diverging, s.sub_diverging),
                     (s.depth, s.depth + 1), (s.sum_ap, s.sum_ap + s.sub_sum_ap),
                     (s.n_ap, s.n_ap + s.sub_n_ap),
                     (s.n_leapfrog, s.n_leapfrog + s.leaf)):
        _put(dst, new, act)
    s.active.copy_(act & (s.depth < max_depth) & ~s.turning & ~s.diverging)
    s.flag.copy_(s.active.any())


def accept_statistic(s):
    """(B,) mean accept probability of each chain's transition."""
    return s.sum_ap / torch.clamp_min(s.n_ap, 1).to(s.sum_ap.dtype)


def _finish(s):
    """The transition's proposal becomes the chains' state."""
    s.z.copy_(s.zp)
    s.u.copy_(s.up)
    s.grad.copy_(s.gp)


def run_transition(run, flag, max_depth):
    """One NUTS transition as the host loop of its pieces: ``run(name)``
    executes one, ``flag()`` reads "any chain still active" (not read
    where the loop ends anyway)."""
    run("begin_step")
    for d in range(max_depth):
        run("begin_doubling")
        n = 1 << d
        for i in range(n):
            run("leaf")
            if i + 1 < n and not flag():
                break
        run("end_doubling")
        if d + 1 < max_depth and not flag():
            break


def nuts_kernel(u_vg, max_depth: int = 8):
    """The NUTS transition ``step(generator, z, u, grad, eps, inv_mass) ->
    (z', u', grad', stats)`` (the JAX package's ``nuts_kernel``), eagerly
    through this module's pieces.

    ``u_vg(z) -> (U, dU/dz)`` is the potential (-lnpost in the
    unconstrained space).  ``z`` is one chain ``(m,)``, with ``u_vg``
    taking ``(m,)``, or a batch of chains ``(B, m)``, with ``u_vg`` taking
    ``(B, m)``: every chain runs its own tree in one call.  ``generator``
    is a ``torch.Generator`` (draws as :class:`NUTSDraws` takes them) or a
    draws object with :class:`NUTSDraws`' methods.  ``stats``: the mean
    accept probability, leapfrog count, tree depth reached and divergence
    flag, per chain.
    """
    def step(generator, z, u, grad, eps, inv_mass):
        single = z.dim() == 1
        vg = u_vg
        if single:
            z, grad = z[None], grad[None]

            def vg(zb):
                val, g = u_vg(zb[0])
                return torch.as_tensor(val).reshape(1), g[None]

        dev, dt = z.device, z.dtype
        draws = (NUTSDraws(generator, dev) if isinstance(generator, torch.Generator)
                 else generator)
        s = NUTSState.allocate(z.shape[0], z.shape[1], max_depth, dt, dev)
        for dst, src in ((s.z, z), (s.u, u), (s.grad, grad), (s.eps, eps),
                         (s.inv_mass, inv_mass)):
            dst.copy_(torch.as_tensor(src, dtype=dt, device=dev).reshape(dst.shape))
        pieces = {"begin_step": lambda: begin_step(s, draws, max_depth),
                  "begin_doubling": lambda: begin_doubling(s, draws),
                  "leaf": lambda: leaf(s, vg, draws),
                  "end_doubling": lambda: end_doubling(s, draws, max_depth)}
        run_transition(lambda name: pieces[name](), lambda: bool(s.flag), max_depth)
        stats = {"accept_prob": accept_statistic(s), "n_leapfrog": s.n_leapfrog,
                 "depth": s.depth, "diverging": s.diverging}
        _finish(s)
        if single:
            stats = {k: v[0] for k, v in stats.items()}
            return s.z[0], s.u[0], s.grad[0], stats
        return s.z, s.u, s.grad, stats

    return step


def warmup_windows(nsteps):
    """``(m_start, m_end, bounds)`` of a warmup of ``nsteps``: Welford
    runs over steps ``[m_start, m_end)`` and the metric switches after
    each step in ``bounds`` (the JAX package's schedule)."""
    m_start = max(1, int(0.15 * nsteps))
    m_end = max(m_start + 1, int(0.9 * nsteps))
    bounds = []
    t0, w = m_start, max(10, (m_end - m_start) // 12)
    while t0 + w < m_end:
        if t0 + 3 * w >= m_end:
            w = m_end - t0  # absorb the remainder into the last
        bounds.append(min(t0 + w, m_end))
        t0 += w
        w *= 2
    if not bounds or bounds[-1] != m_end:
        bounds.append(m_end)
    return m_start, m_end, bounds


def _da_init(s, eps0):
    log_eps = torch.log(eps0)
    s.log_eps.copy_(log_eps)
    s.log_eps_bar.copy_(log_eps)
    s.h_bar.zero_()
    s.mu.copy_(torch.log(10.0 * eps0))
    s.da_t.zero_()


def _da_update(s, alpha):
    t = s.da_t + 1.0
    eta = 1.0 / (t + _DA_T0)
    h_bar = (1.0 - eta) * s.h_bar + eta * (_DA_TARGET - alpha)
    log_eps = s.mu - torch.sqrt(t) / _DA_GAMMA * h_bar
    w = t ** (-_DA_KAPPA)
    s.log_eps_bar.copy_(w * log_eps + (1.0 - w) * s.log_eps_bar)
    s.log_eps.copy_(log_eps)
    s.h_bar.copy_(h_bar)
    s.da_t.copy_(t)


class NUTSSampler:
    """NUTS over the model posterior, with the surface the fitting driver
    uses: ``init_state`` / ``run_burn`` (the warmup) / ``reset`` /
    ``run_sampling`` / ``chain`` / ``lnprobability`` /
    ``acceptance_fraction`` / ``get_autocorr_time`` / ``checkpoint_payload``
    / ``restore_state`` and the posterior-image accumulators.

    ``nwalkers`` is the number of independent chains.  ``posterior_fns``
    needs ``differentiable_log_posterior``, ``log_posterior_batch``,
    ``spec``, ``device`` and ``dtype``; with ``ensemble_carry_means`` and
    ``carry_image_shapes`` the retained phase accumulates the
    posterior-mean images.  ``transform`` defaults to the spec's
    :func:`~psfmc_tpu_torch.models.transforms.build_transform`.

    Counters: ``piece_counts`` (the pieces run, by name), of them
    ``graph_replays`` as replays of a captured graph, ``captures`` (graphs
    captured), ``leaves_run`` (leaf pieces: the batch's leapfrogs) and
    ``steps_run`` (transitions).
    """

    checkpoint_kind = "nuts"

    def __init__(self, nwalkers: int, dim: int, posterior_fns, seed: int = 0,
                 max_depth: int = 8, transform=None, device=None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.device = resolve_device(device if device is not None
                                     else posterior_fns.device)
        if resolve_device(posterior_fns.device) != self.device:
            raise ValueError(f"posterior is on {posterior_fns.device}, sampler on "
                             f"{self.device}")
        self.nwalkers = int(nwalkers)
        self.dim = int(dim)
        self.fns = posterior_fns
        self.dtype = posterior_fns.dtype
        self.max_depth = int(max_depth)
        self.transform = transform or build_transform(posterior_fns.spec,
                                                      dtype=posterior_fns.dtype)
        self.zdim = self.transform.num_unconstrained
        self.num_psfs = getattr(posterior_fns.spec, "num_psfs", 1)
        offsets = self.transform.discrete_offsets
        self._offset = int(offsets[0]) if len(offsets) else None
        self._marginal = marginal_lnpost_theta(posterior_fns, self.transform)
        self._means_fn = getattr(posterior_fns, "ensemble_carry_means", None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.draws = NUTSDraws(self.generator, self.device)
        self.state = None
        self._record = None  # (theta (cap, B, dim), lnprob (cap, B), slot (1,))
        self._graphs = {}
        self._pool = None
        self._stream = None
        self._graphed = self.device.type == "cuda"
        self._flag_host = self._flag_event = None
        self.piece_counts = {}
        self.graph_replays = 0
        self.captures = 0
        self._chain = None  # numpy (nchains, nsteps, dim) constrained, emcee layout
        self._lnprob = None
        self._nsteps_total = 0
        self._sum_accept = 0.0
        self._n_leapfrog_total = 0
        self._n_divergent = 0

    # -- target ----------------------------------------------------------
    def _potential(self, z):
        theta, ld = self.transform.to_constrained(z)
        return -(self._marginal(theta) + ld)

    def _u_vg(self, z):
        """``(U (B,), dU/dz (B, m))``: the potential and its gradient."""
        return value_and_grad(self._potential, z)

    # -- state -----------------------------------------------------------
    def init_state(self, p0):
        """p0: ``(n, dim)`` constrained positions, ``n >= nwalkers``.

        With more rows than chains, the chains start from the highest-
        posterior rows (the posterior's own ``log_posterior_batch``, a
        non-finite value ranked as ``-inf``): far from the sources the
        likelihood gradient vanishes, and a chain started at a random
        prior draw may never feel the data.  The step size starts at
        ``0.1 / zdim^0.25``, the metric at the identity.
        """
        p0 = np.asarray(p0, np.float64)
        if p0.ndim != 2 or p0.shape[1] != self.dim or p0.shape[0] < self.nwalkers:
            raise ValueError(f"p0 must be (n >= {self.nwalkers}, {self.dim}), got "
                             f"{p0.shape}")
        if p0.shape[0] > self.nwalkers:
            lnp = _lnpost_batch(self.fns, p0)
            lnp = np.where(np.isfinite(lnp), lnp, -np.inf)
            p0 = p0[np.argsort(lnp)[::-1][: self.nwalkers]]
        z0 = torch.as_tensor(self.transform.to_unconstrained(p0), dtype=self.dtype,
                             device=self.device)
        u0, g0 = self._u_vg(z0)
        if self.state is None:
            self.state = NUTSState.allocate(
                self.nwalkers, self.zdim, self.max_depth, self.dtype, self.device,
                fresh_image_accumulators(self.fns, self.device))
        s = self.state
        s.z.copy_(z0)
        s.u.copy_(u0)
        s.grad.copy_(g0)
        s.eps.fill_(0.1 / max(self.zdim, 1) ** 0.25)
        s.inv_mass.fill_(1.0)
        self._zero_accum()
        return s

    def _zero_accum(self):
        self.state.accum_count.zero_()
        for v in self.state.accum.values():
            v.zero_()

    def reset(self):
        """Clear the chain, the accept statistic, the leapfrog and
        divergence counts and the image accumulators; keep the chains'
        positions, step size and metric."""
        self._chain = None
        self._lnprob = None
        self._nsteps_total = 0
        self._sum_accept = 0.0
        self._n_leapfrog_total = 0
        self._n_divergent = 0
        if self.state is not None:
            self._zero_accum()

    @property
    def rng_kind(self):
        """Kind of generator whose state a checkpoint carries."""
        return f"torch-{self.device.type}"

    # -- pieces ----------------------------------------------------------
    def _piece(self, name):
        """The piece ``name`` as a function of ``(state, record)``."""
        draws, depth = self.draws, self.max_depth
        return {
            "begin_step": lambda s, rec: begin_step(s, draws, depth),
            "begin_doubling": lambda s, rec: begin_doubling(s, draws),
            "leaf": lambda s, rec: leaf(s, self._u_vg, draws),
            "end_doubling": lambda s, rec: end_doubling(s, draws, depth),
            "warm_end": lambda s, rec: self._warm_end(s, window=False),
            "warm_end_window": lambda s, rec: self._warm_end(s, window=True),
            "switch": lambda s, rec: self._switch(s),
            "sample_end": self._sample_end,
        }[name]

    def _warm_end(self, s, window):
        """The end of a warmup step: the dual-averaging update and the
        next step size, then the pooled Welford merge of the chains'
        positions.  As in the JAX package, whose windowing selects the
        merged count but keeps the merged mean and M2 on every step, the
        mean and M2 take every step and the count only the steps inside
        the window (``window``)."""
        alpha = accept_statistic(s).mean()
        _finish(s)
        _da_update(s, alpha)
        s.eps.copy_(torch.exp(s.log_eps))
        wf = welford_batch_update({"mean": s.wf_mean, "m2": s.wf_m2, "n": s.wf_n}, s.z)
        s.wf_mean.copy_(wf["mean"])
        s.wf_m2.copy_(wf["m2"])
        if window:
            s.wf_n.copy_(wf["n"])
        s.tot_leapfrog.add_(s.n_leapfrog.sum())
        s.tot_divergent.add_(s.diverging.sum())

    def _switch(self, s):
        """The end of a mass window: the regularized metric, dual
        averaging restarted at its averaged step size, a fresh Welford."""
        nf = torch.clamp_min(s.wf_n, 2).to(s.wf_m2.dtype)
        var = s.wf_m2 / (nf - 1.0)
        var = (nf / (nf + 5.0)) * var + 1e-3 * (5.0 / (nf + 5.0))
        s.inv_mass.copy_(torch.clamp_min(var, 1e-10))
        _da_init(s, torch.exp(s.log_eps_bar))
        s.eps.copy_(torch.exp(s.log_eps))
        for t in (s.wf_n, s.wf_mean, s.wf_m2):
            t.zero_()

    def _sample_end(self, s, record):
        """The end of a retained step: the constrained theta with the PSF
        index Gibbs-sampled from the posterior's own path, its lnpost, the
        image accumulation and the record at the slot."""
        alpha = accept_statistic(s).mean()
        _finish(s)
        theta, _ = self.transform.to_constrained(s.z)
        if self._offset is None:
            lnp = self.fns.log_posterior_batch(theta)
        else:
            b, k = theta.shape[0], self.num_psfs
            lps = self.fns.log_posterior_batch(
                psf_fan_out(theta, self._offset, k)).reshape(b, k)
            pick = torch.argmax(lps + self.draws.gumbel((b, k), lps.dtype), dim=1)
            lnp = lps.gather(1, pick[:, None])[:, 0]
            theta = torch.cat([theta[:, :self._offset], pick[:, None].to(theta.dtype),
                               theta[:, self._offset + 1:]], dim=1)
        if s.accum:
            accum, count = merge_image_accumulators(s.accum, s.accum_count,
                                                    self._means_fn(theta), self.nwalkers)
            for key, v in accum.items():
                s.accum[key].copy_(v)
            s.accum_count.copy_(count)
        chain_theta, chain_lnp, slot = record
        chain_theta.index_copy_(0, slot, theta[None])
        chain_lnp.index_copy_(0, slot, lnp[None])
        slot.add_(1)
        s.tot_accept.add_(alpha.to(torch.float64))
        s.tot_leapfrog.add_(s.n_leapfrog.sum())
        s.tot_divergent.add_(s.diverging.sum())

    def _run(self, name):
        """Run one piece: a replay of its graph on CUDA, the piece itself
        elsewhere (and under ``_eager``)."""
        self.piece_counts[name] = self.piece_counts.get(name, 0) + 1
        if not self._graphed:
            with torch.no_grad():
                self._piece(name)(self.state, self._record)
            return
        self._graphs[name].replay()
        self.graph_replays += 1

    def _prepare(self, names):
        """Capture every piece of a phase that has no graph yet (CUDA)."""
        if self.state is None:
            raise RuntimeError("call init_state(p0) first")
        if not self._graphed:
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        for name in names:
            if name in self._graphs:
                continue
            record = self._record if name == "sample_end" else None
            scratch = None if record is None else tuple(t.clone() for t in record)
            with torch.no_grad():
                self._graphs[name] = capture_step(
                    self._piece(name), (self.state, record), (self.state.clone(), scratch),
                    self.generator, self._stream, self._pool)
            self.captures += 1

    def _flag(self):
        """Whether any chain is still active: one device flag, read through
        pinned memory on CUDA."""
        if self.device.type != "cuda":
            return bool(self.state.flag)
        if self._flag_host is None:
            self._flag_host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self._flag_event = torch.cuda.Event()
        self._flag_host.copy_(self.state.flag, non_blocking=True)
        self._flag_event.record()
        self._flag_event.synchronize()
        return bool(self._flag_host)

    def _transition(self):
        run_transition(self._run, self._flag, self.max_depth)

    @property
    def leaves_run(self):
        return self.piece_counts.get("leaf", 0)

    @property
    def steps_run(self):
        return self.piece_counts.get("begin_step", 0)

    def _totals(self):
        """Read and clear the phase's device totals: (accept sum,
        leapfrogs, divergences)."""
        s = self.state
        out = (float(s.tot_accept), int(s.tot_leapfrog), int(s.tot_divergent))
        for t in (s.tot_accept, s.tot_leapfrog, s.tot_divergent):
            t.zero_()
        return out

    # -- warmup ("burn") --------------------------------------------------
    def run_burn(self, nsteps: int, segment=None, callback=None):
        """Warmup: step-size and metric adaptation over ``nsteps`` steps
        (discarded, like burn-in), from the identity metric.

        ``segment`` is accepted for the fitting driver's sake, but the windows are
        laid out over the whole warmup: ``callback(nsteps, nsteps)`` runs
        once at its end, so no mid-warmup checkpoint is written (a killed
        run pays the warmup again), as in the JAX package.
        """
        if nsteps <= 0:
            return self
        self._prepare(WARMUP_PIECES)
        m_start, m_end, bounds = warmup_windows(int(nsteps))
        s = self.state
        with torch.no_grad():
            _da_init(s, s.eps.clone())
            s.eps.copy_(torch.exp(s.log_eps))
            s.inv_mass.fill_(1.0)
            for t in (s.wf_n, s.wf_mean, s.wf_m2):
                t.zero_()
            self._totals()
        for t in range(int(nsteps)):
            self._transition()
            self._run("warm_end_window" if m_start <= t < m_end else "warm_end")
            if t in bounds:
                self._run("switch")
        with torch.no_grad():
            s.eps.copy_(torch.exp(s.log_eps_bar))
        _, n_lf, n_div = self._totals()
        self._n_leapfrog_total += n_lf
        self._n_divergent += n_div
        if callback is not None:
            callback(nsteps, nsteps)
        return self

    # -- retained sampling -------------------------------------------------
    def _use_record(self, nrec):
        """Chain buffers of at least ``nrec`` rows; a larger buffer drops
        the graph that wrote the old one."""
        if self._record is None or self._record[0].shape[0] < nrec:
            kw = dict(dtype=self.dtype, device=self.device)
            self._record = (torch.empty((nrec, self.nwalkers, self.dim), **kw),
                            torch.empty((nrec, self.nwalkers), **kw),
                            torch.zeros(1, dtype=torch.int64, device=self.device))
            self._graphs.pop("sample_end", None)

    def _sample_segment(self, n):
        self._record[2].zero_()
        self._totals()
        for _ in range(n):
            self._transition()
            self._run("sample_end")
        chain, lnprob = (np.ascontiguousarray(_host(t[:n]).swapaxes(0, 1))
                         for t in self._record[:2])
        if self._chain is None:
            self._chain, self._lnprob = chain, lnprob
        else:
            self._chain = np.concatenate([self._chain, chain], axis=1)
            self._lnprob = np.concatenate([self._lnprob, lnprob], axis=1)
        accept, n_lf, n_div = self._totals()
        self._nsteps_total += n
        self._sum_accept += accept
        self._n_leapfrog_total += n_lf
        self._n_divergent += n_div

    def run_sampling(self, nsteps: int, segment=None, callback=None):
        """Retained sampling in segments of ``segment`` steps (default: one),
        ``callback(done, nsteps)`` after each (mid-phase checkpoints); the
        chain is fetched to the host once per segment."""
        if nsteps <= 0:
            return self
        segs = EnsembleSampler._segments(int(nsteps), segment)
        if self.state is None:
            raise RuntimeError("call init_state(p0) first")
        self._use_record(max(segs))
        self._prepare(SAMPLE_PIECES)
        done = 0
        for n in segs:
            self._sample_segment(n)
            done += n
            if callback is not None:
                callback(done, nsteps)
        return self

    # -- emcee-compatible surface ------------------------------------------
    @property
    def chain(self):
        """``(nchains, nrecorded, dim)`` float64 numpy, or None."""
        return self._chain

    @property
    def lnprobability(self):
        return self._lnprob

    @property
    def flatchain(self):
        c = self._chain
        return c.reshape(-1, self.dim) if c is not None else None

    @property
    def acceptance_fraction(self):
        """The mean NUTS accept statistic, broadcast per chain (HMC's
        acceptance is a step-size diagnostic, not a move count)."""
        return np.full(self.nwalkers, self._sum_accept / max(self._nsteps_total, 1))

    @property
    def accumulated_images(self):
        if self.state is None or not self.state.accum:
            return None
        return {k: _host(v, v.dtype) for k, v in self.state.accum.items()}

    @property
    def accumulated_samples(self):
        return 0 if self.state is None else int(self.state.accum_count)

    @property
    def n_leapfrog_total(self):
        """Posterior-gradient evaluations per chain, summed over chains
        (the HMC cost metric)."""
        return self._n_leapfrog_total

    @property
    def n_divergent(self):
        return self._n_divergent

    def get_autocorr_time(self, c=1):
        if self._chain is None:
            raise ValueError("No chain recorded yet")
        return integrated_time(np.mean(self._chain, axis=0), axis=0, c=c)

    # -- checkpoint ----------------------------------------------------------
    def checkpoint_payload(self):
        """Full resume state as host arrays: the JAX package's NUTS payload
        with the generator's state in place of its key."""
        s = self.state
        with torch.no_grad():
            theta, _ = self.transform.to_constrained(s.z.to("cpu", torch.float64))
        return {
            "version": 2,
            "ntemps": 1,
            "positions": theta.numpy().copy(),
            "log_prob": -_host(s.u),
            "naccept": np.zeros(self.nwalkers, np.int64),
            "nsteps": int(self._nsteps_total),
            "rng_kind": self.rng_kind,
            "rng_state": self.generator.get_state().numpy().copy(),
            "accum": {k: _host(v, v.dtype) for k, v in s.accum.items()},
            "accum_count": int(s.accum_count),
            "nuts_eps": float(s.eps),
            "nuts_inv_mass": _host(s.inv_mass),
            "sum_accept": float(self._sum_accept),
        }

    def restore_state(self, payload):
        """Rebuild the state from a :meth:`checkpoint_payload` dict: the
        positions (re-evaluated), step size, metric, image accumulators,
        step count, accept numerator and the generator's state.  Raises
        ``ValueError`` for a checkpoint whose generator is not this
        sampler's kind."""
        kind = payload.get("rng_kind")
        if kind != self.rng_kind:
            raise ValueError(f"checkpoint generator {kind!r} cannot be restored into a "
                             f"{self.rng_kind!r} sampler")
        positions = np.asarray(payload["positions"], np.float64)
        if positions.ndim == 3:
            positions = positions[0]
        self.init_state(positions)
        self.generator.set_state(torch.as_tensor(np.asarray(payload["rng_state"],
                                                            np.uint8)))
        s = self.state
        if payload.get("nuts_eps"):
            s.eps.fill_(float(payload["nuts_eps"]))
        im = payload.get("nuts_inv_mass")
        if im is not None and np.shape(im) == (self.zdim,):
            s.inv_mass.copy_(torch.as_tensor(np.asarray(im, np.float64), dtype=self.dtype))
        restore_image_accumulators(s.accum, s.accum_count, payload)
        self._nsteps_total = int(payload.get("nsteps", 0))
        # the acceptance numerator pairs with nsteps: left at zero it would
        # bias MCACCEPT toward zero after every resume
        self._sum_accept = float(payload.get("sum_accept", 0.0))
        return s


