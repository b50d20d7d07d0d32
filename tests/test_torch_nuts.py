"""The port's NUTS against the JAX package's, on the CPU.

The draws of a transition are made with ``jax.random`` on the key tree
``sampler/nuts.py`` splits (the momentum key, per doubling ``key, k_dir,
k_sub, k_switch``, per leaf ``k_sub, k_take``; per warmup step ``key,
k_step`` and one key per chain) and handed to the port through a
scripted draws object, so both packages take the same operations on the
same numbers, in float64: the Hamiltonian pieces at 1e-12; one
transition on an analytic Gaussian and on a correlated non-Gaussian
potential at depths 1-5 with the leapfrog count, depth and divergence
flag exact and z, u, the gradient and the accept statistic at 1e-12 (the
statistic differs from JAX's in the last place); warmups of 20 and 150
steps across their window switches at 1e-10; one transition of the
flagship (24x24, a 12x12 PSF) at 1e-9; the potential with the PSF index
marginalized over two PSFs, with the transform's Jacobian, and the
Gibbs-sampled index on JAX's categorical draws; the best-of-pool start.
Then the fitting driver with ``sampler="nuts"`` (its database, the NUTS
checkpoint cards read by both packages, a resume) and its repairs, every
function of ``analysis/statistics.py`` against the JAX one, and a CPU
rehearsal of ``chip_smoke.py``'s NUTS phase.  Each test runs torch on
one thread.
"""
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import database as jdb
from psfmc_tpu.analysis import statistics as jstat
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.sampler import nuts as jn
from psfmc_tpu import distributions as JD
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch import fitting, model_galaxy_mcmc
from psfmc_tpu_torch.analysis import statistics as tstat
from psfmc_tpu_torch.flagship import flagship_components, general_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.sampler import nuts as tn
from test_torch_grad import _graft_entry
from test_torch_io import MODEL, _write_inputs

F64 = jnp.float64
COV = np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]])
PREC = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0, 0.5])
SHAPE, PSF_SHAPE = (24, 24), (12, 12)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the potentials ------------------------------------------------------------
def _jax_gauss(z):
    d = z - jnp.asarray(MEAN)
    return 0.5 * d @ jnp.asarray(PREC) @ d


def _torch_gauss(z):
    d = z - torch.as_tensor(MEAN)
    return 0.5 * ((d @ torch.as_tensor(PREC)) * d).sum(-1)


def _jax_banana(z):
    """A correlated, non-Gaussian potential (a twisted, coupled well)."""
    b = z[1] - 0.5 * z[0] ** 2
    return (0.5 * z[0] ** 2 / 2.0 + 0.5 * b ** 2 / 0.5 + 0.3 * z[0] * z[2]
            + 0.5 * z[2] ** 2 + 0.1 * z[2] ** 4)


def _torch_banana(z):
    b = z[:, 1] - 0.5 * z[:, 0] ** 2
    return (0.5 * z[:, 0] ** 2 / 2.0 + 0.5 * b ** 2 / 0.5 + 0.3 * z[:, 0] * z[:, 2]
            + 0.5 * z[:, 2] ** 2 + 0.1 * z[:, 2] ** 4)


POTENTIALS = {"gauss": (_jax_gauss, _torch_gauss), "banana": (_jax_banana, _torch_banana)}


def _torch_vg(u):
    def vg(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            val = u(z)
            (g,) = torch.autograd.grad(val.sum(), z)
        return val.detach(), g

    return vg


# -- JAX's draws, handed to the port -------------------------------------------
def _chain_draws(key, m, depth, dt=F64):
    """One chain's transition draws from its key, on ``nuts_kernel``'s key
    tree, for a full tree of ``depth`` doublings (a transition that stops
    early uses a prefix): the momentum normal, each doubling's direction
    and switch uniform, each leaf's take uniform (leaf i of doubling d at
    ``2^d - 1 + i``)."""
    key, k_mom = jax.random.split(key)
    normal = jax.random.normal(k_mom, (m,), dt)
    dirs, switches, takes = [], [], []
    for d in range(depth):
        key, k_dir, k_sub, k_switch = jax.random.split(key, 4)
        dirs.append(jax.random.bernoulli(k_dir))
        switches.append(jax.random.uniform(k_switch, (), dt))
        for _ in range(2 ** d):
            k_sub, k_take = jax.random.split(k_sub)
            takes.append(jax.random.uniform(k_take, (), dt))
        key = k_sub
    return normal, jnp.stack(dirs), jnp.stack(switches), jnp.stack(takes)


_DRAWS = {}


def transition_draws(keys, m, depth):
    """``_chain_draws`` of every chain (one key each), as numpy."""
    fn = _DRAWS.get((m, depth))
    if fn is None:
        fn = _DRAWS[(m, depth)] = jax.jit(jax.vmap(lambda k: _chain_draws(k, m, depth)))
    return tuple(np.array(x) for x in fn(keys))


class ScriptedDraws:
    """Stands in for :class:`~psfmc_tpu_torch.sampler.nuts.NUTSDraws`: the
    draws of one transition per :meth:`momentum` call (``steps``, a list
    of ``transition_draws``), each doubling's and leaf's by its index, and
    one Gumbel sample per step (``gumbels``)."""

    def __init__(self, steps, gumbels=None):
        self.steps, self.gumbels = list(steps), list(gumbels or [])
        self.step = -1

    def momentum(self, shape, dtype):
        self.step += 1
        self.d = -1
        normal = self.steps[self.step][0]
        assert normal.shape == tuple(shape)
        return torch.as_tensor(normal, dtype=dtype)

    def direction(self, shape, dtype):
        self.d += 1
        self.leaf = 0
        right = self.steps[self.step][1][:, self.d]
        return torch.as_tensor(np.where(right, 0.25, 0.75), dtype=dtype)

    def take(self, shape, dtype):
        u = self.steps[self.step][3][:, (1 << self.d) - 1 + self.leaf]
        self.leaf += 1
        return torch.as_tensor(u, dtype=dtype)

    def switch(self, shape, dtype):
        return torch.as_tensor(self.steps[self.step][2][:, self.d], dtype=dtype)

    def gumbel(self, shape, dtype):
        g = self.gumbels[self.step]
        assert g.shape == tuple(shape)
        return torch.as_tensor(g, dtype=dtype)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# -- the Hamiltonian pieces ------------------------------------------------------
@pytest.mark.parametrize("bits", [1, 3, 5, 9])
def test_popcount_and_trailing_ones_match_jax(bits):
    n = np.arange(0, 2 ** bits + 3, dtype=np.int64)
    want_pc = np.array([int(jn._popcount(jnp.int32(v), bits)) for v in n])
    want_to = np.array([int(jn._trailing_ones(jnp.int32(v), bits)) for v in n])
    np.testing.assert_array_equal(tn._popcount(torch.as_tensor(n), bits).numpy(), want_pc)
    np.testing.assert_array_equal(tn._trailing_ones(torch.as_tensor(n), bits).numpy(),
                                  want_to)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hamiltonian_pieces_match_jax(seed):
    rng = np.random.RandomState(seed)
    b, m = 5, 4
    r, rl, rs, z, g = (rng.randn(b, m) for _ in range(5))
    inv_mass = rng.uniform(0.2, 2.0, m)
    eps = rng.uniform(-0.3, 0.3, b)
    ke = jax.vmap(jn._kinetic, in_axes=(0, None))(r, inv_mass)
    _close(tn._kinetic(torch.as_tensor(r), torch.as_tensor(inv_mass)), ke, 1e-12)
    turn = jax.vmap(jn._is_turning, in_axes=(0, 0, 0, None))(rl, r, rs, inv_mass)
    np.testing.assert_array_equal(
        tn._is_turning(*(torch.as_tensor(x) for x in (rl, r, rs, inv_mass))).numpy(),
        np.asarray(turn))
    jvg = jax.value_and_grad(_jax_banana)
    want = jax.vmap(lambda e, zz, rr, gg: jn._leapfrog(jvg, e, jnp.asarray(inv_mass), zz,
                                                       rr, gg))(eps, z, r, g)
    got = tn._leapfrog(_torch_vg(_torch_banana), torch.as_tensor(eps)[:, None],
                       torch.as_tensor(inv_mass), *(torch.as_tensor(x) for x in (z, r, g)))
    for gv, wv in zip(got, want):
        _close(gv, wv, 1e-12)


# -- one transition ----------------------------------------------------------------
def nuts_step(u_vg, z, u, grad, eps, inv_mass, draws, max_depth=8):
    """One transition of every chain through the port's pieces, eagerly:
    the batched counterpart of the JAX package's ``nuts_kernel(u_vg,
    max_depth)`` step.  Returns ``(z', u', grad', stats)``, ``stats`` with
    ``accept_prob``, ``n_leapfrog``, ``depth`` and ``diverging`` per
    chain."""
    s = tn.NUTSState.allocate(z.shape[0], z.shape[1], max_depth, z.dtype, z.device)
    for dst, src in ((s.z, z), (s.u, u), (s.grad, grad), (s.eps, eps),
                     (s.inv_mass, inv_mass)):
        dst.copy_(torch.as_tensor(src, dtype=z.dtype))
    pieces = {"begin_step": lambda: tn.begin_step(s, draws, max_depth),
              "begin_doubling": lambda: tn.begin_doubling(s, draws),
              "leaf": lambda: tn.leaf(s, u_vg, draws),
              "end_doubling": lambda: tn.end_doubling(s, draws, max_depth)}
    tn.run_transition(lambda name: pieces[name](), lambda: bool(s.flag), max_depth)
    stats = {"accept_prob": tn.accept_statistic(s), "n_leapfrog": s.n_leapfrog.clone(),
             "depth": s.depth.clone(), "diverging": s.diverging.clone()}
    tn._finish(s)
    return s.z, s.u, s.grad, stats


def _transition_pair(jax_u, torch_vg, z0, eps, inv_mass, depth, seed=3, jax_vg=None,
                     batched_vg=None):
    """One JAX ``nuts_kernel`` transition of every chain and the port's on
    the same draws (``batched_vg``: a compiled ``vmap`` of ``jax_vg`` for
    the start, which an eager ``vmap`` of a posterior takes seconds to
    run)."""
    b, m = z0.shape
    jvg = jax_vg or jax.value_and_grad(jax_u)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    u0, g0 = (batched_vg or jax.vmap(jvg))(jnp.asarray(z0))
    step = jax.jit(jax.vmap(jn.nuts_kernel(jvg, max_depth=depth),
                            in_axes=(0, 0, 0, 0, None, None)))
    want = step(keys, jnp.asarray(z0), u0, g0, eps, jnp.asarray(inv_mass))
    draws = ScriptedDraws([transition_draws(keys, m, depth)])
    got = nuts_step(torch_vg, torch.as_tensor(z0), torch.as_tensor(np.array(u0)),
                    torch.as_tensor(np.array(g0)), eps, torch.as_tensor(inv_mass),
                    draws, max_depth=depth)
    return got, want


def _assert_transition(got, want, tol):
    """The tree's decisions exact; the accept statistic, a float of the
    potential's values, and z, u, grad at ``tol`` (the two packages' exp
    and sums round differently in the last place: ROADMAP Queue 3)."""
    (z, u, g, stats), (jz, ju, jg, jstats) = got, want
    for k in ("n_leapfrog", "depth", "diverging"):
        np.testing.assert_array_equal(stats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
    _close(stats["accept_prob"], jstats["accept_prob"], tol)
    _close(z, jz, tol)
    _close(u, ju, tol)
    _close(g, jg, tol)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("potential", sorted(POTENTIALS))
def test_transition_matches_jax(potential, depth):
    jax_u, torch_u = POTENTIALS[potential]
    rng = np.random.RandomState(depth)
    z0 = rng.randn(6, 3) + MEAN * (potential == "gauss")
    got, want = _transition_pair(jax_u, _torch_vg(torch_u), z0, 0.3,
                                 np.array([1.0, 0.7, 1.3]), depth, seed=depth)
    _assert_transition(got, want, 1e-12)
    assert int(got[3]["depth"].max()) <= depth


def test_divergent_start_stops_at_the_first_leaf():
    z0 = np.random.RandomState(0).randn(4, 3)
    got, want = _transition_pair(_jax_banana, _torch_vg(_torch_banana), z0, 50.0,
                                 np.ones(3), 5)
    _assert_transition(got, want, 1e-12)
    stats = got[3]
    assert stats["diverging"].all() and (stats["n_leapfrog"] == 1).all()
    assert (stats["depth"] == 1).all()
    np.testing.assert_array_equal(got[0].numpy(), z0)  # the start is kept


# -- the warmup ------------------------------------------------------------------
class _Identity:
    """Identity transform of a toy target (both packages' surface)."""

    def __init__(self, m, lib):
        self.num_unconstrained = m
        self.discrete_offsets = np.zeros(0, np.int64)
        self.lib = lib

    def to_constrained(self, z):
        if self.lib == "jax":
            return z, jnp.zeros((), z.dtype)
        return z, torch.zeros(z.shape[:-1], dtype=z.dtype)

    def to_unconstrained(self, theta):
        return np.asarray(theta, np.float64)


class _JaxGauss:
    dtype = F64
    spec = types.SimpleNamespace(num_psfs=1)

    def log_posterior(self, theta):
        return -_jax_gauss(theta)


class TorchGauss:
    """A posterior stand-in for the port's sampler: the 3-D Gaussian, with
    a carry image (theta_0 everywhere)."""

    def __init__(self, device="cpu", dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.spec = types.SimpleNamespace(num_psfs=1)
        self.mean = torch.as_tensor(MEAN, dtype=dtype, device=self.device)
        self.prec = torch.as_tensor(PREC, dtype=dtype, device=self.device)

    def log_posterior_batch(self, theta):
        d = theta - self.mean
        return -0.5 * ((d @ self.prec) * d).sum(-1)

    differentiable_log_posterior = log_posterior_batch

    def carry_image_shapes(self):
        return {"img": (2, 2)}

    def ensemble_carry_means(self, theta):
        return {"img": theta[:, 0].mean().expand(2, 2).to(torch.float32)}


def warmup_draws(key, nchains, m, depth, nsteps):
    """Every warmup step's transition draws, on the warmup program's key
    tree (``key, k_step``, then one key per chain)."""
    out = []
    for _ in range(nsteps):
        key, k_step = jax.random.split(key)
        out.append(transition_draws(jax.random.split(k_step, nchains), m, depth))
    return out


@pytest.mark.parametrize("nsteps,windows", [(20, (3, 18, [18])),
                                             (150, (22, 135, [32, 52, 135]))])
def test_warmup_matches_jax(nsteps, windows):
    """A warmup of 20 steps (Welford over steps 3..17, the switch after step
    18) and one of 150 (windows of 10, 20 and 83 steps): the step size, the
    metric and the positions at 1e-10."""
    nchains, m, depth = 4, 3, 5
    assert tn.warmup_windows(nsteps) == windows
    z0 = np.random.RandomState(1).randn(nchains, m) * 0.3 + MEAN
    js = jn.NUTSSampler(nchains, m, _JaxGauss(), max_depth=depth,
                        transform=_Identity(m, "jax"))
    key = jax.random.PRNGKey(7)
    u0, g0 = jax.vmap(js._u_vg)(jnp.asarray(z0))
    eps0 = 0.1 / m ** 0.25
    jz, _, _, _, jeps, jim, outs = js._warmup_program(nsteps)(
        jnp.asarray(z0), u0, g0, key, np.float64(eps0))

    ts = tn.NUTSSampler(nchains, m, TorchGauss(), max_depth=depth,
                        transform=_Identity(m, "torch"), device="cpu")
    ts.init_state(z0)
    ts.draws = ScriptedDraws(warmup_draws(key, nchains, m, depth, nsteps))
    ts.run_burn(nsteps)
    _close(ts.state.eps, jeps, 1e-10)
    _close(ts.state.inv_mass, jim, 1e-10)
    _close(ts.state.z, jz, 1e-10)
    assert not np.allclose(np.asarray(jim), 1.0)  # the switch set the metric
    assert ts.piece_counts["switch"] == len(windows[2])
    assert ts.n_leapfrog_total == int(np.sum(outs[1]))
    assert ts.n_divergent == int(np.sum(outs[2]))


# -- the flagship ----------------------------------------------------------------
def _pair(jspec, spec):
    """Both packages' posteriors of one spec in float64, the JAX sampler's
    potential compiled over a batch (``vg``) and its ``log_posterior``."""
    jfns = jax_posterior(jspec, dtype=F64)
    js = jn.NUTSSampler(1, spec.num_params, jfns)
    return types.SimpleNamespace(
        jfns=jfns, js=js, vg=jax.jit(jax.vmap(js._u_vg)),
        lnpost=jax.jit(jfns.log_posterior), spec=spec,
        post=build_posterior(spec, device="cpu", dtype=torch.float64))


@pytest.fixture(scope="module")
def flagship():
    return _pair(jax_spec(_graft_entry()._flagship_components(SHAPE, PSF_SHAPE)),
                 build_model_spec(flagship_components(SHAPE, PSF_SHAPE)))


def test_flagship_transition_matches_jax(flagship):
    """One transition (max_depth 3) of the flagship's potential, the JAX
    side on ``NUTSSampler._u_vg``, the port's through the gradient path."""
    f = flagship
    ts = tn.NUTSSampler(3, f.spec.num_params, f.post, device="cpu")
    z0 = ts.transform.to_unconstrained(prior_draws(f.spec, 3, seed=5))
    u, g = ts._u_vg(torch.as_tensor(z0))
    ju, jg = f.vg(jnp.asarray(z0))
    _close(u, ju, 1e-9)
    _close(g, jg, 1e-9)
    got, want = _transition_pair(None, ts._u_vg, z0, 2e-3, np.ones(ts.zdim), 3,
                                 jax_vg=f.js._u_vg, batched_vg=f.vg)
    _assert_transition(got, want, 1e-9)


def test_best_of_pool_start_matches_jax(flagship):
    """More rows than chains: the chains start from the highest-lnpost
    rows, non-finite ranked last, as the JAX sampler picks them
    (``NUTSSampler.init_state``'s ranking, replayed on JAX's batched
    lnpost), with JAX's potential there and its first step size."""
    from psfmc_tpu.optimize import _cached_batched_lnpost

    f = flagship
    pool = prior_draws(f.spec, 24, seed=6)
    pool[5, -1] = np.nan  # a non-finite row: ranked as -inf
    lnp = np.asarray(_cached_batched_lnpost(f.jfns)(jnp.asarray(pool)))
    lnp = np.where(np.isfinite(lnp), lnp, -np.inf)
    best = pool[np.argsort(lnp)[::-1][:5]]
    ts = tn.NUTSSampler(5, f.spec.num_params, f.post, device="cpu")
    ts.init_state(pool)
    z = f.js.transform.to_unconstrained(best)
    _close(ts.state.z, z, 1e-12)
    _close(ts.state.u, f.vg(jnp.asarray(z))[0], 1e-9)
    assert float(ts.state.eps) == 0.1 / ts.zdim ** 0.25
    np.testing.assert_array_equal(ts.state.inv_mass.numpy(), np.ones(ts.zdim))


# -- the marginalized potential and the Gibbs index -------------------------------
@pytest.fixture(scope="module")
def two_psfs():
    return _pair(jax_spec(general_components(SHAPE, PSF_SHAPE, components=JC,
                                             distributions=JD)),
                 build_model_spec(general_components(SHAPE, PSF_SHAPE)))


def test_marginalized_potential_matches_jax(two_psfs):
    """U(z) = -(logsumexp_k lnpost(theta(z), k) + log|J|) and its
    gradient, against ``NUTSSampler._u_vg`` at 1e-9; the Jacobian is in
    it (the MAP objective, which leaves it out, differs by log|J|)."""
    f = two_psfs
    post = f.post
    ts = tn.NUTSSampler(4, f.spec.num_params, post, device="cpu")
    assert ts.zdim == f.spec.num_params - 1 and ts.num_psfs == 2
    z = ts.transform.to_unconstrained(prior_draws(f.spec, 4, seed=4))
    u, g = ts._u_vg(torch.as_tensor(z))
    ju, jg = f.vg(jnp.asarray(z))
    _close(u, ju, 1e-9)
    _close(g, jg, 1e-9)
    from psfmc_tpu_torch.optimize import _marginal_lnpost_fn

    with torch.no_grad():
        objective = _marginal_lnpost_fn(post, ts.transform)(torch.as_tensor(z))
        _, ld = ts.transform.to_constrained(torch.as_tensor(z))
    _close(-u, objective + ld, 1e-12)
    assert torch.all(ld.abs() > 1e-3)


def test_gibbs_index_matches_jax(two_psfs):
    """The retained record: theta with the PSF index Gibbs-sampled from the
    posterior's own path and its lnpost, on JAX's categorical draws."""
    f = two_psfs
    js, nchains = f.js, 6
    ts = tn.NUTSSampler(nchains, f.spec.num_params, f.post, device="cpu")
    z = ts.transform.to_unconstrained(prior_draws(f.spec, nchains, seed=8))
    ts.init_state(ts.transform.to_constrained(torch.as_tensor(z))[0].numpy())
    off = int(ts.transform.discrete_offsets[0])
    # JAX's record: lps over the PSFs and jax.random.categorical on each
    # chain's key
    lps = np.stack([[float(f.lnpost(js._theta_at_index(
        js.transform.to_constrained(jnp.asarray(zz))[0], k))) for k in range(2)] for zz in z])
    gkeys = jax.random.split(jax.random.PRNGKey(11), nchains)
    want_k = [int(jax.random.categorical(key, row)) for key, row in zip(gkeys, lps)]
    want_lnp = lps[np.arange(nchains), want_k]
    gumbels = np.stack([np.array(jax.random.gumbel(k, (2,), F64)) for k in gkeys])
    # a second record whose Gumbel noise favours PSF 1 on every other
    # chain by more than the lnpost gap: the index JAX's rule argmax(lps +
    # g) takes
    shifted = gumbels.copy()
    shifted[::2, 1] += np.abs(lps[::2, 0] - lps[::2, 1]) + 1.0
    ts.draws = ScriptedDraws([None, None], [gumbels, shifted])
    ts._use_record(2)
    ts._record[2].zero_()
    ts.state.zp.copy_(ts.state.z)  # a transition that kept its start
    ts.state.up.copy_(ts.state.u)
    ts.state.gp.copy_(ts.state.grad)
    for step in range(2):
        ts.draws.step = step
        with torch.no_grad():
            ts._sample_end(ts.state, ts._record)
    np.testing.assert_array_equal(ts._record[0][0, :, off].numpy(), want_k)
    _close(ts._record[1][0], want_lnp, 1e-9)
    want_shifted = np.argmax(lps + shifted, axis=1)
    assert set(want_shifted) == {0, 1}  # both PSFs drawn
    np.testing.assert_array_equal(ts._record[0][1, :, off].numpy(), want_shifted)
    _close(ts._record[1][1], lps[np.arange(nchains), want_shifted], 1e-9)
    # the rest of theta is the chain's constrained position
    np.testing.assert_array_equal(np.delete(ts._record[0][1].numpy(), off, axis=1),
                                  np.delete(ts._record[0][0].numpy(), off, axis=1))


# -- the checkpoint, both ways ---------------------------------------------------------
def test_jax_nuts_checkpoint_reads_in_the_port(tmp_path):
    """A NUTS checkpoint the JAX package writes: the port reads its
    adaptation (step size, metric, accept numerator) and its kind."""
    rng = np.random.RandomState(0)
    chain, lnp = rng.randn(4, 3, 5), rng.randn(4, 3)
    payload = {"version": 2, "ntemps": 1, "positions": chain[:, -1], "log_prob": lnp[:, -1],
               "naccept": np.zeros(4, np.int64), "nsteps": 3,
               "key": np.array([0, 5], np.uint32), "accum": {}, "accum_count": 0,
               "nuts_eps": 0.0123, "nuts_inv_mass": np.array([0.5, 1.5, 2.5]),
               "sum_accept": 2.25, "sampler_kind": "nuts"}
    sampler = types.SimpleNamespace(chain=chain, lnprobability=lnp, nwalkers=4, state=object(),
                                    checkpoint_kind="nuts",
                                    checkpoint_payload=lambda: dict(payload))
    model = types.SimpleNamespace(param_names=["a", "b"], param_lens=[2, 3])
    path = str(tmp_path / "db.fits")
    jdb.save_database(sampler, model, path, meta_dict={"MCITER": 3})
    ck = tdb.load_checkpoint(path)
    assert ck["sampler_kind"] == "nuts" and ck["rng_kind"] == "jax"
    assert ck["nuts_eps"] == 0.0123 and ck["sum_accept"] == 2.25
    np.testing.assert_array_equal(ck["nuts_inv_mass"], [0.5, 1.5, 2.5])


# -- the fitting driver ----------------------------------------------------------------------
@pytest.fixture
def model_dir(tmp_path):
    _write_inputs(str(tmp_path), shape=(16, 16), psf_shape=(8, 8))
    (tmp_path / "model.py").write_text(MODEL)
    return tmp_path


def _run(model_dir, **kw):
    args = dict(output_name=str(model_dir / "out"), chains=4, burn=12, iterations=6,
                seed=0, device="cpu", checkpoint_interval=3, sampler="nuts",
                max_depth=3)
    args.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "not yet converged"
        return model_galaxy_mcmc(str(model_dir / "model.py"), **args)


def test_driver_nuts_writes_its_database_and_cards(model_dir):
    db = _run(model_dir)
    mc = fitting.as_model(str(model_dir / "model.py"), device="cpu")
    assert db.colnames == list(mc.param_names) + ["lnprobability", "walker", "sample"]
    assert len(db) == 4 * 6 and db.meta["MCITER"] == 6 and db.meta["MCCHAINS"] == 4
    assert np.all(np.isfinite(db["lnprobability"]))
    # a 12-step warmup may end with every retained transition diverging
    # (the schedule restarts dual averaging at its switch two steps before
    # the end): the statistic is a mean of probabilities, 0 included
    assert 0.0 <= db.meta["MCACCEPT"] <= 1.0
    path = str(model_dir / "out_db.fits")
    from psfmc_tpu_torch.io.table import Table

    cards = Table.read(path, format="fits", extname="CHECKPOINT").meta
    assert cards["CKPTSMPL"] == "nuts" and cards["CKPTEPS"] > 0
    assert cards["CKPTACCS"] == pytest.approx(db.meta["MCACCEPT"] * 6, rel=1e-6)
    for ck in (tdb.load_checkpoint(path), jdb.load_checkpoint(path)):
        assert ck["sampler_kind"] == "nuts" and ck["nuts_eps"] == cards["CKPTEPS"]
        assert ck["nuts_inv_mass"].shape == (mc.num_params,)  # no discrete slot
        assert np.all(ck["nuts_inv_mass"] > 0) and ck["accum_count"] == 4 * 6
        assert ck["positions"].shape == (4, mc.num_params)
    for ftype in ("raw_model", "convolved_model", "composite_ivm", "residual",
                  "point_source_subtracted"):
        from psfmc_tpu_torch.io import fits

        img = fits.getdata(str(model_dir / f"out_{ftype}.fits"))
        assert img.shape == (16, 16) and np.all(np.isfinite(img))


def test_driver_nuts_resumes(model_dir, capsys):
    db6 = _run(model_dir)
    ck6 = tdb.load_checkpoint(str(model_dir / "out_db.fits"))
    db9 = _run(model_dir, iterations=9)
    assert "Resuming from checkpoint: 12/12 burn-in + 6 retained" in capsys.readouterr().out
    assert len(db9) == 4 * 9 and db9.meta["MCITER"] == 9
    for name in db6.colnames:  # the first six samples stay
        np.testing.assert_array_equal(np.asarray(db9[name]).reshape(4, 9, -1)[:, :6],
                                      np.asarray(db6[name]).reshape(4, 6, -1),
                                      err_msg=name)
    ck9 = tdb.load_checkpoint(str(model_dir / "out_db.fits"))
    assert ck9["nuts_eps"] == ck6["nuts_eps"]  # no warmup ran again
    np.testing.assert_array_equal(ck9["nuts_inv_mass"], ck6["nuts_inv_mass"])
    assert ck9["accum_count"] == 4 * 9 and ck9["nsteps"] == 9


def test_driver_refuses_the_other_samplers_checkpoint(model_dir):
    _run(model_dir, sampler="ensemble", chains=24, burn=4)
    with pytest.warns(UserWarning, match="'ensemble' sampler but sampler='nuts'"):
        db = model_galaxy_mcmc(str(model_dir / "model.py"), output_name=str(model_dir / "out"),
                               chains=24, burn=2, iterations=8, device="cpu",
                               sampler="nuts", max_depth=2)
    assert len(db) == 24 * 8
    with pytest.warns(UserWarning, match="'nuts' sampler but sampler='ensemble'"):
        db = model_galaxy_mcmc(str(model_dir / "model.py"), output_name=str(model_dir / "out"),
                               chains=24, burn=2, iterations=10, device="cpu")
    assert len(db) == 24 * 10


def test_driver_refuses_an_unknown_sampler():
    with pytest.raises(ValueError, match="Unknown sampler 'hmc'"):
        model_galaxy_mcmc("no_such_model.py", device="cpu", sampler="hmc")


# -- the fitting driver's repairs -------------------------------------------------------------
def test_driver_nuts_keeps_an_odd_chain_count(model_dir):
    db = _run(model_dir, chains=3, iterations=2, checkpoint_interval=0)
    assert db.meta["MCCHAINS"] == 3 and len(db) == 3 * 2


def test_driver_nuts_ignores_ntemps_and_moves_with_a_warning(model_dir):
    built = []
    init = fitting.NUTSSampler.__init__

    def kept(self, *a, **k):
        init(self, *a, **k)
        built.append(self)

    fitting.NUTSSampler.__init__ = kept
    try:
        with pytest.warns(UserWarning) as rec:
            model_galaxy_mcmc(str(model_dir / "model.py"), output_name=str(model_dir / "o"),
                              chains=4, burn=12, iterations=6, device="cpu", sampler="nuts",
                              ntemps=3, moves="de", max_depth=2)
    finally:
        fitting.NUTSSampler.__init__ = init
    messages = [str(w.message) for w in rec]
    assert "ntemps is ignored with sampler='nuts'" in messages
    assert "moves= is ignored with sampler='nuts'" in messages
    assert len(built) == 1 and built[0].max_depth == 2


def test_burn_callback_skips_rejuvenation_without_the_method(model_dir):
    """A sampler without ``rejuvenate_stuck`` (NUTS) is never teleported,
    also when its burn-in reports a segment before the end."""
    mc = fitting.as_model(str(model_dir / "model.py"), device="cpu")
    sampler = tn.NUTSSampler(2, mc.num_params, mc.posterior_fns, device="cpu", max_depth=2)
    assert not hasattr(sampler, "rejuvenate_stuck")
    run_burn = sampler.run_burn

    def two_segments(nsteps, segment=None, callback=None):
        run_burn(nsteps)
        callback(1, nsteps)  # a mid-phase report
        callback(nsteps, nsteps)
        return sampler

    sampler.run_burn = two_segments
    p0 = mc.init_params_from_priors(64, random_state=np.random.RandomState(0))
    db = fitting._run_sampling(sampler, mc, p0, burn=2, iterations=2, max_iterations=1,
                               convergence_check=lambda s, verbose=0: True,
                               db_name=str(model_dir / "r_db.fits"), burn_total=2)
    assert len(db) == 2 * 2


# -- analysis/statistics.py ---------------------------------------------------------
def _chains(seed, shape=(6, 200)):
    """Autocorrelated chains with a chain offset and a heavy tail."""
    rng = np.random.RandomState(seed)
    x = np.zeros(shape)
    for t in range(1, shape[1]):
        x[:, t] = 0.7 * x[:, t - 1] + rng.standard_t(4, shape[0])
    return x + 0.3 * np.arange(shape[0])[:, None] * (seed % 2)


def _database(seed):
    rng = np.random.RandomState(seed)
    nw, ns = 5, 40
    walker = np.repeat(np.arange(nw) * 2, ns)  # non-contiguous walker ids
    sample = np.tile(np.arange(ns), nw)
    perm = rng.permutation(nw * ns)
    return {"a": rng.randn(nw * ns)[perm], "xy": rng.randn(nw * ns, 2)[perm],
            "lnprobability": rng.randn(nw * ns)[perm], "walker": walker[perm],
            "sample": sample[perm]}


class _Table(dict):
    @property
    def colnames(self):
        return list(self)


STAT_CASES = {
    "potential_scale_reduction": lambda m, c: m.potential_scale_reduction(list(c)),
    "num_effective_samples": lambda m, c: m.num_effective_samples(list(c)),
    "check_convergence_psrf": lambda m, c: m.check_convergence_psrf(
        np.stack([c, c[::-1]], axis=2), psrf_tol=0.1),
    "rhat_rank": lambda m, c: m.rhat_rank(c),
    "ess_bulk": lambda m, c: m.ess_bulk(c),
    "ess_tail": lambda m, c: m.ess_tail(c),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(STAT_CASES))
def test_chain_statistics_match_jax(name, seed):
    c = _chains(seed)
    got, want = STAT_CASES[name](tstat, c), STAT_CASES[name](jstat, c)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("name", ["convergence_summary", "summary", "to_inference_dict"])
def test_database_statistics_match_jax(name):
    db = _Table(_database(3))
    got, want = getattr(tstat, name)(db), getattr(jstat, name)(db)

    def flat(d):
        if isinstance(d, dict):
            return {k: flat(v) for k, v in d.items()}
        return np.asarray(d, np.float64)

    got, want = flat(got), flat(want)
    assert list(got) == list(want)

    def same(g, w):
        if isinstance(g, dict):
            assert list(g) == list(w)
            for k in g:
                same(g[k], w[k])
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12)

    same(got, want)


@pytest.mark.parametrize("ratio", [2, 10, 50])
def test_check_convergence_autocorr_on_a_nuts_sampler_matches_jax(ratio):
    s = tn.NUTSSampler(4, 3, TorchGauss(), seed=2, max_depth=4,
                       transform=_Identity(3, "torch"), device="cpu")
    s.init_state(np.random.RandomState(0).randn(4, 3) + MEAN)
    s.run_burn(10)
    s.reset()
    s.run_sampling(50)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a short chain's estimate
        assert (tstat.check_convergence_autocorr(s, min_chain_to_tau_ratio=ratio)
                == jstat.check_convergence_autocorr(s, min_chain_to_tau_ratio=ratio))


def test_chip_smoke_nuts_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.nuts_phase`` (the fitting driver's NUTS fit and its resumed
    call, graphed against eager, the general flagship's marginalized run)
    at 32x32 and a shallow depth on the CPU, where the wrappers run their
    plain versions: each wrapper is counted as the card counts its kernel
    (conv_lnl's forward under autograd on the route ``fft_res``), so the
    phase's exact launch checks hold here."""
    import functools

    import chip_smoke as cs
    import psfmc_tpu_torch.models.posterior as P
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    def counting(mod, name, route=None):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            wrapped.launches += 1
            if route is not None:
                key = route(*a)
                wrapped.route_launches[key[0]] += 1
                wrapped.shape_launches[key] = wrapped.shape_launches.get(key, 0) + 1
            return orig(*a, **k)

        wrapped.launches = 0
        if route is not None:
            wrapped.route_launches = dict.fromkeys(orig.route_launches, 0)
            wrapped.shape_launches = {}
        monkeypatch.setattr(mod, name, wrapped)
        if hasattr(P, name):
            monkeypatch.setattr(P, name, wrapped)

    def forward_route(raws, consts):
        route = CL.conv_route(consts.shape)
        if torch.is_grad_enabled() and raws.requires_grad and route in ("fft", "padded"):
            route += "_res"
        return route, consts.shape

    counting(SR, "render_sersics")
    counting(SR, "render_sersics_backward")
    counting(CL, "batched_conv_lnl", forward_route)
    counting(CL, "batched_conv_lnl_backward",
             lambda raws, consts, *a: (CL.conv_route(consts.shape), consts.shape))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name, value in (("NUTS_BURN", 12), ("NUTS_SAMPLE", 4), ("NUTS_CHECKPOINT", 2),
                        ("NUTS_RESUMED", 6), ("NUTS_DEPTH", 4), ("NUTS_MARGINAL", (3, 2, 2))):
        monkeypatch.setattr(cs, name, value)
    out = cs.nuts_phase(shape=(32, 32), psf_shape=(16, 16), device="cpu")
    fit = out["nuts_fit"]
    assert fit["batched_conv_lnl:fft_res"] == fit["batched_conv_lnl_backward:fft"] > 16
    assert out["nuts_marginal"]["batched_conv_lnl"] == 0
    assert out["nuts_leaves_per_step"] >= 1.0
