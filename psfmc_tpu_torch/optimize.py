"""Gradient MAP optimization (port of ``optimize.py``).

A multi-start Adam ascent of the log-posterior in the unconstrained
reparameterization (:mod:`.models.transforms`) finds the posterior mode
in a few hundred steps: the JAX package's GALFIT-replacement mode and the
warm start of ``model_galaxy_mcmc(..., init="map")``.

The gradient is the posterior's own (``differentiable_log_posterior``:
the render and conv_lnl kernels with their hand-written backward kernels
where they cover the spec, else the general path).  The starts are a
batch axis; the discrete PSF index is marginalized during the ascent (a
logsumexp over the PSFs, batched as ``starts x psfs``) and assigned by a
per-start argmax at the end.  Adam is optax's ``adam(learning_rate)``
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction) written out as
tensor arithmetic.

On CUDA each Adam step is one replay of a captured CUDA graph (forward,
``torch.autograd.grad`` through the backward kernels, the update and the
running best), the counterpart of the JAX package's single ``lax.scan``
program; the loop of replays never synchronizes with the host.  The graph
is cached on the posterior per ``(n_starts, steps, learning rate,
transform token)``, as the JAX package caches its program.

:func:`laplace_covariance` differs from the JAX package on purpose: the
kernels have first derivatives only, so the Hessian is the Jacobian of
the exact gradient by central differences (two batched gradient calls,
symmetrized), not ``jax.hessian`` (README, deliberate differences).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional
from warnings import warn

import numpy as np
import torch

from ._device import gc_paused
from .models.posterior import value_and_grad
from .models.transforms import build_transform, transform_token
from .ops.kernels import counts

__all__ = ["MAPResult", "fit_map", "laplace_covariance", "scatter_around"]

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
# the central differences' step per coordinate, as a fraction of the
# coordinate's posterior standard deviation from a pilot pass (float32:
# the gradient's rounding grows as the step shrinks; float64: the
# truncation error, about step^2 / 6 of the curvature's change, is what
# remains); the pilot's step is this fraction of max(|x|, 1)
LAPLACE_STEP = {torch.float32: 0.3, torch.float64: 1e-3}
LAPLACE_PILOT_STEP = 1e-3

@dataclass
class MAPResult:
    """Outcome of :func:`fit_map`."""

    theta: np.ndarray  # (dim,) best parameter vector (constrained space)
    lnpost: float  # log-posterior at theta (discrete index substituted)
    psf_index: int  # argmax discrete PSF assignment (0 if none)
    all_theta: np.ndarray  # (n_starts, dim) per-start optima
    all_lnpost: np.ndarray  # (n_starts,) per-start best objective
    steps: int
    # Laplace approximation at the mode (fit_map(..., laplace=True)):
    # covariance / std over the CONTINUOUS slots, NaN rows at discrete
    # offsets.  None unless requested.
    cov: "np.ndarray | None" = None  # (dim, dim)
    theta_std: "np.ndarray | None" = None  # (dim,)


@contextlib.contextmanager
def _eager(posterior_fns):
    """Run ``posterior_fns``'s Adam steps eagerly on CUDA, as on the CPU:
    the yardstick the card tests and ``chip_smoke.py`` hold the graphed
    steps against.  No public switch selects it."""
    fns = posterior_fns.__dict__
    eager, fns["_map_eager"] = fns.get("_map_eager", False), True
    try:
        yield
    finally:
        fns["_map_eager"] = eager


def _cache(fns):
    """The posterior's cache of captured Adam programs."""
    cache = fns.__dict__.get("_map_programs")
    if cache is None:
        cache = fns.__dict__["_map_programs"] = {}
    return cache


def psf_fan_out(theta, offset, num_psfs):
    """``(B * num_psfs, dim)``: each row of ``theta`` once per PSF index,
    the index written at ``offset`` (row ``b * num_psfs + k`` takes PSF
    ``k``)."""
    b = theta.shape[0]
    rep = theta.repeat_interleave(num_psfs, dim=0)
    index = torch.arange(num_psfs, dtype=theta.dtype, device=theta.device).repeat(b)
    return torch.cat([rep[:, :offset], index[:, None], rep[:, offset + 1:]], dim=1)


def marginal_lnpost_theta(fns, transform):
    """``theta (B, dim) -> lnpost (B,)`` on the gradient's path
    (``differentiable_log_posterior``), the discrete PSF index
    marginalized by a logsumexp over the PSFs."""
    offsets = transform.discrete_offsets
    num_psfs = getattr(fns.spec, "num_psfs", 1)
    if len(offsets) == 0:
        return fns.differentiable_log_posterior
    off = int(offsets[0])

    def lnpost(theta):
        lps = fns.differentiable_log_posterior(psf_fan_out(theta, off, num_psfs))
        return torch.logsumexp(lps.reshape(theta.shape[0], num_psfs), dim=1)

    return lnpost


def _marginal_lnpost_fn(fns, transform):
    """``z (B, m) -> lnpost(theta(z)) (B,)``, the discrete PSF index
    marginalized by a logsumexp over the PSFs; the MAP objective.

    No transform Jacobian: the mode users want is the argmax of the
    constrained posterior density."""
    marginal = marginal_lnpost_theta(fns, transform)

    def lnpost(z):
        theta, _ = transform.to_constrained(z)
        return marginal(theta)

    return lnpost


def _prior_pool(spec, n, rng):
    """(n, dim) prior draws, column-assembled from the slot layout."""
    cols = []
    for slot in spec.slots:
        draws = np.stack([np.ravel(np.asarray(slot.dist.random(random_state=rng)))
                          for _ in range(n)])
        cols.append(draws.reshape(n, slot.size))
    return np.concatenate(cols, axis=1)


def _lnpost_batch(fns, thetas):
    """The posterior's own batched lnpost (its likelihood path), float64."""
    with torch.no_grad():
        out = fns.log_posterior_batch(torch.as_tensor(thetas, dtype=fns.dtype,
                                                      device=fns.device))
    return out.to("cpu", torch.float64).numpy()


class _AdamProgram:
    """The Adam ascent of one ``(posterior, n_starts, learning rate,
    transform)``: persistent state buffers and, on CUDA, one captured
    step that :meth:`run` replays."""

    def __init__(self, fns, transform, n_starts, learning_rate):
        self.fns = fns
        self.lr = float(learning_rate)
        objective = _marginal_lnpost_fn(fns, transform)
        self.neg_objective = lambda z: -objective(z)
        m = transform.num_unconstrained
        kw = dict(dtype=fns.dtype, device=fns.device)
        self.z = torch.zeros((n_starts, m), **kw)
        self.mu = torch.zeros_like(self.z)
        self.nu = torch.zeros_like(self.z)
        self.count = torch.zeros((), **kw)
        self.best_z = torch.zeros_like(self.z)
        self.best_val = torch.zeros((n_starts,), **kw)
        self.graph = None
        self.launches = None  # the kernel launches one replay executes
        self.replays = 0

    def step(self):
        """One Adam step in place: the objective at the current z, the
        running best, then optax's update with non-finite gradient entries
        zeroed (a start in a -inf pocket stops moving)."""
        val, grad = value_and_grad(self.neg_objective, self.z)
        better = val < self.best_val
        self.best_val.copy_(torch.where(better, val, self.best_val))
        self.best_z.copy_(torch.where(better[:, None], self.z, self.best_z))
        grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
        self.mu.copy_((1 - ADAM_B1) * grad + ADAM_B1 * self.mu)
        self.nu.copy_((1 - ADAM_B2) * (grad * grad) + ADAM_B2 * self.nu)
        self.count.add_(1.0)
        mu_hat = self.mu / (1 - torch.pow(ADAM_B1, self.count))
        nu_hat = self.nu / (1 - torch.pow(ADAM_B2, self.count))
        update = mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS)
        self.z.copy_(self.z + (-self.lr) * update)

    def reset(self, z0):
        self.z.copy_(z0)
        self.best_z.copy_(z0)
        self.mu.zero_()
        self.nu.zero_()
        self.count.zero_()
        self.best_val.fill_(math.inf)

    def _capture(self):
        """Capture one step.  The warm-up that capture needs (the kernels'
        builds, cuBLAS's workspace, lazily made constants) runs one step
        on a side stream with its launches uncounted; the state is
        restored after it.  Python's collector is paused over the capture
        (:func:`~psfmc_tpu_torch._device.gc_paused`)."""
        saved = [t.clone() for t in self._state()]
        side = torch.cuda.Stream(self.fns.device)
        side.wait_stream(torch.cuda.current_stream(self.fns.device))
        with torch.cuda.stream(side), counts.tally():
            self.step()
        torch.cuda.current_stream(self.fns.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with counts.tally() as launches, gc_paused():
            with torch.cuda.graph(graph, stream=side):
                self.step()
        for t, s in zip(self._state(), saved):
            t.copy_(s)
        self.graph, self.launches = graph, launches

    def _state(self):
        return (self.z, self.mu, self.nu, self.count, self.best_z, self.best_val)

    def run(self, z0, steps):
        """``steps`` Adam steps from ``z0``, then the final iterate against
        the running best: ``(best_z, best objective)`` (the objective is
        -lnpost)."""
        self.reset(z0)
        graphed = (self.fns.device.type == "cuda"
                   and not self.fns.__dict__.get("_map_eager", False))
        if graphed and self.graph is None and steps > 0:
            self._capture()
        for _ in range(steps):
            if graphed:
                self.graph.replay()
                counts.add(self.launches)
                self.replays += 1
            else:
                self.step()
        val, _ = value_and_grad(self.neg_objective, self.z)
        better = val < self.best_val
        best_val = torch.where(better, val, self.best_val)
        best_z = torch.where(better[:, None], self.z, self.best_z)
        return best_z, best_val


def fit_map(
    posterior_fns,
    n_starts: int = 64,
    steps: int = 500,
    learning_rate: float = 0.05,
    seed: int = 0,
    p0: Optional[np.ndarray] = None,
    transform=None,
    laplace: bool = False,
):
    """Multi-start Adam MAP fit of the model posterior.

    :param posterior_fns: a ``PosteriorFns`` or ``JointPosteriorFns``.
    :param n_starts: independent starts (a batch axis).
    :param steps: Adam steps (on CUDA, replays of one captured step).
    :param p0: optional ``(m, dim)`` start pool in constrained space;
        more rows than ``n_starts`` keeps the highest-posterior ones
        (through the posterior's own ``log_posterior_batch``).  ``None``
        draws ``max(4 n_starts, 128)`` from the priors.
    :param laplace: also compute :func:`laplace_covariance` at the mode.
    :returns: :class:`MAPResult`.
    """
    fns = posterior_fns
    spec = fns.spec
    transform = transform or build_transform(spec, dtype=fns.dtype)
    rng = np.random.RandomState(seed)
    if p0 is None:
        p0 = _prior_pool(spec, max(4 * n_starts, 128), rng)
    p0 = np.asarray(p0, np.float64)
    if p0.shape[0] > n_starts:
        # best-of-pool: gradients vanish far from the sources
        lnp = _lnpost_batch(fns, p0)
        lnp = np.where(np.isfinite(lnp), lnp, -np.inf)
        p0 = p0[np.argsort(lnp)[::-1][:n_starts]]
    elif p0.shape[0] < n_starts:
        n_starts = p0.shape[0]
    z0 = torch.as_tensor(transform.to_unconstrained(p0), dtype=fns.dtype,
                         device=fns.device)

    key = ("map_fit", n_starts, steps, float(learning_rate),
           transform_token(transform))
    cache = _cache(fns)
    program = cache.get(key)
    if program is None:
        program = cache[key] = _AdamProgram(fns, transform, n_starts, learning_rate)
    best_z, best_val = program.run(z0, steps)
    with torch.no_grad():
        all_theta_t, _ = transform.to_constrained(best_z)
    all_theta = all_theta_t.to("cpu", torch.float64).numpy().copy()
    best_lnp = -best_val.to("cpu", torch.float64).numpy()

    i_best = int(np.nanargmax(np.where(np.isfinite(best_lnp), best_lnp, -np.inf)))
    theta = all_theta[i_best].copy()
    psf_index = 0
    offsets = transform.discrete_offsets
    if len(offsets) > 0:
        # per-start argmax assignment over the (starts, psfs) grid
        num_psfs = getattr(spec, "num_psfs", 1)
        off = int(offsets[0])
        cand = np.repeat(all_theta, num_psfs, axis=0)
        cand[:, off] = np.tile(np.arange(num_psfs), len(all_theta))
        lps = _lnpost_batch(fns, cand).reshape(len(all_theta), num_psfs)
        per_start = np.argmax(lps, axis=1)
        all_theta[:, off] = per_start
        psf_index = int(per_start[i_best])
        theta[off] = psf_index
        lnp_at_mode = float(lps[i_best, psf_index])
    else:
        lnp_at_mode = float(best_lnp[i_best])

    cov = std = None
    if laplace:
        cov, std = laplace_covariance(fns, theta, transform=transform)
    return MAPResult(theta=theta, lnpost=lnp_at_mode, psf_index=psf_index,
                     all_theta=all_theta, all_lnpost=best_lnp, steps=steps,
                     cov=cov, theta_std=std)


def _newton_kappa(fns):
    """Whether a Sersic's kappa is the Newton solve (``PSFMC_KAPPA`` not
    ``table``) somewhere in the posterior."""
    for f in getattr(fns, "band_fns", None) or [fns]:
        if f.kappa_mode == "exact" and any(cs.kind == "sersic"
                                           for cs in f.spec.comp_specs):
            return True
    return False


def _continuous_grad(fns, theta_map, offsets, x):
    """dlnpost/dx ``(n, m)`` at ``n`` points ``x (n, m)`` of the
    continuous slots, the rest of theta at ``theta_map``."""
    thetas = np.repeat(theta_map[None], len(x), axis=0)
    thetas[:, offsets] = x
    _, g = fns.log_posterior_and_grad(thetas)
    return g.to("cpu", torch.float64).numpy()[:, offsets]


def _central_jacobian(fns, theta_map, offsets, x0, h):
    """The Jacobian of the gradient by central differences with step
    ``h`` per coordinate: ``2 m`` points in one batched gradient call."""
    m = len(x0)
    pts = np.repeat(x0[None], 2 * m, axis=0)
    pts[np.arange(m), np.arange(m)] += h
    pts[m + np.arange(m), np.arange(m)] -= h
    g = _continuous_grad(fns, theta_map, offsets, pts)
    return ((g[:m] - g[m:]) / (2.0 * h)[:, None]).T


def laplace_covariance(posterior_fns, theta_map, transform=None):
    """(cov, std): Laplace approximation at an interior posterior mode.

    The curvature is taken in CONSTRAINED theta over the continuous
    slots (``cov = inv(-H)``), with ``H`` the Jacobian of the exact
    gradient by central differences: a pilot pass with the step
    ``LAPLACE_PILOT_STEP * max(|x|, 1)`` estimates each coordinate's
    standard deviation ``sigma`` from its diagonal, and the Hessian is
    taken again with the step ``LAPLACE_STEP[dtype] * sigma``, then
    symmetrized.  Host linear algebra in float64.  Discrete slots get NaN
    rows and columns.  A non-positive-definite ``-H`` (a boundary mode or
    a saddle) returns NaN with a warning; so does the Newton kappa
    (``PSFMC_KAPPA`` not ``table``), as in the JAX package, whose Hessian
    does not exist there.
    """
    fns = posterior_fns
    transform = transform or build_transform(fns.spec, dtype=fns.dtype)
    offsets = np.asarray(transform.offsets, np.int64)
    dim = fns.spec.num_params
    theta_map = np.asarray(theta_map, np.float64)
    cov = np.full((dim, dim), np.nan)
    std = np.full(dim, np.nan)
    if _newton_kappa(fns):
        warn("posterior is not twice-differentiable under the current "
             "PSFMC_KAPPA setting; Laplace covariance is NaN (use the "
             "default table-based kappa)")
        return cov, std
    x0 = theta_map[offsets]
    h0 = LAPLACE_PILOT_STEP * np.maximum(np.abs(x0), 1.0)
    diag = np.diag(_central_jacobian(fns, theta_map, offsets, x0, h0))
    usable = np.isfinite(diag) & (diag < 0)
    sigma = np.where(usable, 1.0 / np.sqrt(np.where(usable, -diag, 1.0)),
                     h0 / LAPLACE_PILOT_STEP)
    h = LAPLACE_STEP.get(fns.dtype, LAPLACE_STEP[torch.float32]) * sigma
    H = _central_jacobian(fns, theta_map, offsets, x0, h)
    H = 0.5 * (H + H.T)
    try:
        from scipy.linalg import cho_factor, cho_solve

        cov_c = cho_solve(cho_factor(-H, lower=True), np.eye(len(H)))
    except (np.linalg.LinAlgError, ValueError):
        warn("Laplace curvature is not positive definite at the MAP "
             "(boundary mode or saddle); covariance is NaN")
        return cov, std
    cov[np.ix_(offsets, offsets)] = cov_c
    std[offsets] = np.sqrt(np.diag(cov_c))
    return cov, std


def scatter_around(posterior_fns, theta_center, n, scale=0.25, seed=0,
                   transform=None):
    """(n, dim) walker cloud around a point, jittered in z-space.

    Every walker is inside the prior support (and the axis order) by
    construction.  Discrete slots are re-drawn from their priors: an
    all-equal coordinate would never move under affine-invariant moves.
    """
    fns = posterior_fns
    transform = transform or build_transform(fns.spec, dtype=fns.dtype)
    rng = np.random.RandomState(seed)
    z_c = transform.to_unconstrained(np.asarray(theta_center, np.float64))
    z = z_c[None, :] + scale * rng.randn(n, z_c.size)
    with torch.no_grad():
        thetas, _ = transform.to_constrained(
            torch.as_tensor(z, dtype=fns.dtype, device=fns.device))
    thetas = thetas.to("cpu", torch.float64).numpy().copy()
    discrete = set(int(o) for o in transform.discrete_offsets)
    for slot in fns.spec.slots:
        if not slot.dist.is_discrete or slot.offset not in discrete:
            continue
        draws = np.stack([np.ravel(np.asarray(slot.dist.random(random_state=rng)))
                          for _ in range(n)]).reshape(n, slot.size)
        thetas[:, slot.offset:slot.offset + slot.size] = draws
    return thetas
