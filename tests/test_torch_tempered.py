"""The port's parallel-tempered sampler against the JAX package's, on the CPU.

The draws of a tempered step are made with ``jax.random`` from the JAX
package's own key splits (``make_pt_step_fn``: ``key, key0, key1, key_s,
key_m``; each half-step's six-way split as ``_pt_stretch_half`` makes
it; one key per rung pair of the swap sweep) and handed to the port in
its own order of draws (:class:`ScriptedDraws`), so that both packages
take the same operations on the same numbers, in float64: 1e-12.  The
real posterior (the flagship at 32x32) is held at 1e-9, the analytic
evidence at the JAX tests' own bars, and the tempered checkpoint across
the two packages' readers.
"""
import math
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import database as jdb
from psfmc_tpu.sampler import tempered as jt
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch import model_galaxy_mcmc
from psfmc_tpu_torch.sampler import EnsembleSampler
from psfmc_tpu_torch.sampler import tempered as tt
from test_torch_driver import MODEL, _write_inputs

T, K, DIM = 3, 12, 3  # rungs, walkers per half, dimensions
BETAS = np.array([1.0, 0.4, 0.0])
F64 = jnp.float64


# -- a small target with a support and a -inf likelihood region ------------
def _jax_like(x):
    lnl = -0.5 * jnp.sum((x - 0.3) ** 2 / 0.5, axis=-1)
    return jnp.where(x[..., 0] > 2.5, -jnp.inf, lnl)


def _jax_prior(x):
    inside = jnp.all(jnp.abs(x) <= 3.0, axis=-1)
    return jnp.where(inside, -3.0 * jnp.log(6.0), -jnp.inf)


def _torch_like_prior(x):
    lnl = -0.5 * (((x - 0.3) ** 2) / 0.5).sum(dim=-1)
    lnl = torch.where(x[..., 0] > 2.5, torch.full_like(lnl, -math.inf), lnl)
    inside = (x.abs() <= 3.0).all(dim=-1)
    lp = torch.where(inside, torch.full_like(lnl, -3.0 * math.log(6.0)),
                     torch.full_like(lnl, -math.inf))
    return lnl, lp


def _rungs(seed, nwalkers):
    """Positions (T, nwalkers, DIM), some outside the prior and some in
    the -inf likelihood region, with their lnL and log-prior."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3.4, 3.4, (T, nwalkers, DIM))
    return pos, np.array(_jax_like(pos)), np.array(_jax_prior(pos))


class ScriptedDraws:
    """Stands in for :class:`~psfmc_tpu_torch.sampler.tempered.
    GeneratorDraws`: hands out given arrays in order, checking each
    request's kind and shape."""

    def __init__(self, items):
        self.items = list(items)

    def _pop(self, kind, shape):
        got_kind, arr = self.items.pop(0)
        assert got_kind == kind and tuple(np.shape(arr)) == tuple(shape), (
            got_kind, kind, np.shape(arr), shape)
        return torch.as_tensor(np.array(arr))

    def uniform(self, shape, dtype):
        return self._pop("uniform", shape).to(dtype)

    def randint(self, high, shape):
        return self._pop("randint", shape).to(torch.int64)

    def normal(self, shape, dtype):
        return self._pop("normal", shape).to(dtype)


def half_draws(key, shape, m, moves):
    """One JAX half-step's draws from ``key`` (``_pt_stretch_half``'s
    split), in the port's order for ``moves``."""
    key_z, key_r, key_u, key_r2, key_g, key_j = jax.random.split(key, 6)
    out = []
    if moves != "de":
        out.append(("uniform", jax.random.uniform(key_z, shape, F64)))
    out.append(("randint", jax.random.randint(key_r, shape, 0, m)))
    if moves != "stretch":
        out += [("randint", jax.random.randint(key_r2, shape, 0, m - 1)),
                ("uniform", jax.random.uniform(key_g, shape, F64)),
                ("normal", jax.random.normal(key_j, shape, F64))]
    out.append(("uniform", jax.random.uniform(key_u, shape, F64)))
    return out


def step_draws(key, ntemps, nwalkers, moves):
    """One JAX tempered step's draws from the state's ``key``, in the port's
    order, and the key of the next step."""
    key, key0, key1, key_s, key_m = jax.random.split(key, 5)
    half = nwalkers // 2
    out = []
    if moves == "mixed":
        use_de = bool(jax.random.bernoulli(key_m))
        out.append(("uniform", np.array(0.25 if use_de else 0.75)))
    out += half_draws(key0, (ntemps, half), nwalkers - half, moves)
    out += half_draws(key1, (ntemps, nwalkers - half), half, moves)
    for k in jax.random.split(key_s, ntemps - 1):
        out.append(("uniform", jax.random.uniform(k, (nwalkers,), F64)))
    return out, key


def _assert_close(got, want, rtol=1e-12):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=rtol)


# -- the ladders -------------------------------------------------------------
@pytest.mark.parametrize("ntemps", [1, 2, 4, 7, 12])
@pytest.mark.parametrize("tmax", [8.0, 64.0, 1e4])
def test_default_ladder_equals_jax(ntemps, tmax):
    got, want = tt.default_beta_ladder(ntemps, tmax), jt.default_beta_ladder(ntemps, tmax)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ntemps", [3, 5, 10])
@pytest.mark.parametrize("bmin", [1e-4, 1e-3, 0.1])
def test_evidence_ladder_equals_jax(ntemps, bmin):
    np.testing.assert_array_equal(tt.evidence_beta_ladder(ntemps, bmin),
                                  jt.evidence_beta_ladder(ntemps, bmin))
    with pytest.raises(ValueError, match=">= 3 rungs"):
        tt.evidence_beta_ladder(2)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("delta", [0.5, 1.0, 1.5])
def test_ladder_from_sigma_equals_jax(seed, delta):
    rng = np.random.RandomState(seed)
    ntemps = 3 + seed
    betas = jt.default_beta_ladder(ntemps)
    sigmas = rng.uniform(0.1, 200.0, ntemps) * np.array([1.0] + [0.5] * (ntemps - 1))
    np.testing.assert_array_equal(tt.ladder_from_sigma(sigmas, betas, ntemps, delta),
                                  jt.ladder_from_sigma(sigmas, betas, ntemps, delta))


# -- the helpers -------------------------------------------------------------
def test_temper_and_kahan_match_jax():
    lnl = np.array([-3.0, -np.inf, np.nan, 2.0, -np.inf])
    b = np.array([0.0, 0.0, 0.0, 0.5, 0.5])
    got = tt._temper(torch.as_tensor(b), torch.as_tensor(lnl)).numpy()
    want = np.asarray(jt._temper(jnp.asarray(b), jnp.asarray(lnl)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[1] == got[2] == -np.inf  # never NaN at beta 0
    s, c, v = (np.random.RandomState(0).randn(5) * 10 ** e for e in (8, -9, 0))
    for g, w in zip(tt._kahan_add(*map(torch.as_tensor, (s, c, v))),
                    jt._kahan_add(*map(jnp.asarray, (s, c, v)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the tempered half-step and the swap sweep ----------------------------------
@pytest.mark.parametrize("moves,use_de", [("stretch", None), ("de", True),
                                          ("mixed", False), ("mixed", True)])
def test_pt_update_matches_jax(moves, use_de):
    pos, lnl, lnp = _rungs(50, 2 * K)
    assert np.isinf(lnp).any() and np.isinf(lnl).any()
    key = jax.random.PRNGKey(51)
    active = tuple(jnp.asarray(x[:, :K]) for x in (pos, lnl, lnp))
    jax_use_de = None if use_de is None else jnp.asarray(use_de)
    want = jt._pt_stretch_half(key, jnp.asarray(BETAS), active,
                               jnp.asarray(pos[:, K:]), _jax_like, _jax_prior,
                               2.0, DIM, use_de=jax_use_de)
    names = ({"stretch": ["u", "partner", "u_accept"],
              "de": ["partner", "shift", "u_jump", "normal", "u_accept"],
              "mixed": ["u", "partner", "shift", "u_jump", "normal", "u_accept"]})
    d = dict(zip(names[moves], (torch.as_tensor(np.array(a))
                                for _, a in half_draws(key, (T, K), K, moves))))
    got = tt.pt_update(*(torch.as_tensor(x[:, :K]) for x in (pos, lnl, lnp)),
                       torch.as_tensor(pos[:, K:]), _torch_like_prior,
                       torch.as_tensor(BETAS), 2.0, DIM,
                       use_de=None if use_de is None else torch.tensor(use_de),
                       gamma0=2.38 / math.sqrt(2.0 * DIM), **d)
    _assert_close(got, want)
    acc = got[3].numpy()
    assert 0 < acc.sum() < T * K and acc[2].sum() > 0  # the beta = 0 rung moves
    assert np.isfinite(got[1].numpy()[acc == 1]).all()


def test_swap_move_matches_jax():
    pos, lnl, lnp = _rungs(52, 2 * K)
    lnl[1, :3] = -np.inf
    key = jax.random.PRNGKey(53)
    nswap0 = np.array([4, 7], np.int32)
    want = jt._swap_move(key, jnp.asarray(BETAS), *map(jnp.asarray, (pos, lnl, lnp)),
                         jnp.asarray(nswap0))
    uniforms = [torch.as_tensor(np.array(jax.random.uniform(k, (2 * K,), F64)))
                for k in jax.random.split(key, T - 1)]
    *got, swaps = tt.swap_move(torch.as_tensor(BETAS),
                               *map(torch.as_tensor, (pos, lnl, lnp)), uniforms)
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(swaps.numpy() + nswap0, np.asarray(want[3]))
    assert 0 < swaps.sum() < (T - 1) * 2 * K


# -- the step function ---------------------------------------------------------
def _jax_state(pos, lnl, lnp, key, nwalkers):
    z = np.zeros(T)
    return jt.PTState(
        positions=jnp.asarray(pos), log_like=jnp.asarray(lnl), log_prior=jnp.asarray(lnp),
        accum=None, accum_count=jnp.asarray(0, jnp.int32),
        naccept=jnp.zeros((T, nwalkers), jnp.int32),
        nswap=jnp.zeros(T - 1, jnp.int32), key=key,
        lnl_sum=jnp.asarray(z), lnl_sum_c=jnp.asarray(z), lnl_sq_sum=jnp.asarray(z),
        lnl_sq_sum_c=jnp.asarray(z), evid_steps=jnp.asarray(0, jnp.int32),
        ss_max=jnp.full(T - 1, -jnp.inf, F64), ss_sum=jnp.zeros(T - 1, F64))


def _torch_state(pos, lnl, lnp, betas, nwalkers):
    i64, f64 = torch.int64, torch.float64
    return tt.PTState(
        positions=torch.as_tensor(pos).clone(), log_like=torch.as_tensor(lnl).clone(),
        log_prior=torch.as_tensor(lnp).clone(), betas=torch.as_tensor(betas, dtype=f64),
        accum={}, accum_count=torch.zeros((), dtype=i64),
        naccept=torch.zeros((T, nwalkers), dtype=i64),
        nswap=torch.zeros(T - 1, dtype=i64),
        lnl_sum=torch.zeros(T, dtype=f64), lnl_sum_c=torch.zeros(T, dtype=f64),
        lnl_sq_sum=torch.zeros(T, dtype=f64), lnl_sq_sum_c=torch.zeros(T, dtype=f64),
        evid_steps=torch.zeros((), dtype=i64),
        ss_max=torch.full((T - 1,), -math.inf, dtype=f64),
        ss_sum=torch.zeros(T - 1, dtype=f64))


def run_both(like_b, prior_b, like_prior, pos, lnl, lnp, betas, key, nsteps,
             moves, rtol=1e-12):
    """``nsteps`` retained steps of both step functions from one state, on
    the same draws; asserts every buffer, the records and the evidence
    accumulators agree.  Returns the port's state."""
    nwalkers = pos.shape[1]
    jstep = jax.jit(jt.make_pt_step_fn(like_b, prior_b, None, jnp.asarray(betas),
                                       nwalkers, pos.shape[2], record=True,
                                       moves=moves))
    jstate = _jax_state(pos, lnl, lnp, key, nwalkers)
    state = _torch_state(pos, lnl, lnp, betas, nwalkers)
    chain = torch.zeros((nsteps, nwalkers, pos.shape[2]), dtype=torch.float64)
    lnprob = torch.zeros((nsteps, nwalkers), dtype=torch.float64)
    slot = torch.zeros(1, dtype=torch.int64)
    draws = ScriptedDraws([])
    step = tt.make_pt_step_fn(like_prior, nwalkers, pos.shape[2], draws,
                              accumulate=True, moves=moves)
    outs = []
    for _ in range(nsteps):
        items, _ = step_draws(jstate.key, T, nwalkers, moves)
        draws.items = items
        jstate, out = jstep(jstate, None)
        outs.append(out)
        step(state, (chain, lnprob, slot))
        assert not draws.items
    _assert_close([state.positions, state.log_like, state.log_prior],
                  [jstate.positions, jstate.log_like, jstate.log_prior], rtol)
    np.testing.assert_array_equal(state.naccept.numpy(), np.asarray(jstate.naccept))
    np.testing.assert_array_equal(state.nswap.numpy(), np.asarray(jstate.nswap))
    assert int(state.evid_steps) == int(jstate.evid_steps) == nsteps
    _assert_close([state.lnl_sum - state.lnl_sum_c,
                   state.lnl_sq_sum - state.lnl_sq_sum_c, state.ss_max, state.ss_sum],
                  [jstate.lnl_sum - jstate.lnl_sum_c,
                   jstate.lnl_sq_sum - jstate.lnl_sq_sum_c, jstate.ss_max,
                   jstate.ss_sum], rtol)
    _assert_close([chain, lnprob], [np.stack([o[0] for o in outs]),
                                    np.stack([o[1] for o in outs])], rtol)
    return state


@pytest.mark.parametrize("moves", ["stretch", "de", "mixed"])
def test_five_steps_match_jax(moves):
    pos, lnl, lnp = _rungs(54, 2 * K)
    state = run_both(jax.vmap(_jax_like), jax.vmap(_jax_prior), _torch_like_prior,
                     pos, lnl, lnp, BETAS, jax.random.PRNGKey(55), 5, moves)
    assert int(state.nswap.sum()) > 0 and np.isfinite(state.ss_sum.numpy()).all()


# -- log_evidence ----------------------------------------------------------------
def _evidence_pair(betas, nsteps, seed, nwalkers=16):
    """A JAX and a port sampler object holding the same accumulators."""
    rng = np.random.RandomState(seed)
    nt = len(betas)
    mean = -10.0 / np.maximum(betas, 0.05)
    lnl_sum, lnl_c = mean * nsteps, rng.randn(nt) * 1e-9
    sq_sum, sq_c = (mean**2 + rng.uniform(20.0, 60.0, nt)) * nsteps, rng.randn(nt) * 1e-9
    ss_max, ss_sum = rng.uniform(-3, 0, nt - 1), rng.uniform(1, 50, nt - 1)
    jax_state = types.SimpleNamespace(
        evid_steps=np.int32(nsteps), lnl_sum=lnl_sum, lnl_sum_c=lnl_c,
        lnl_sq_sum=sq_sum, lnl_sq_sum_c=sq_c, ss_max=ss_max, ss_sum=ss_sum)
    j = object.__new__(jt.PTEnsembleSampler)
    j.ntemps, j.nwalkers, j.betas, j.state = nt, nwalkers, np.asarray(betas), jax_state
    t = object.__new__(tt.PTEnsembleSampler)
    t.ntemps, t.nwalkers, t._betas = nt, nwalkers, np.asarray(betas, np.float64)
    t.state = types.SimpleNamespace(**{k: torch.as_tensor(np.asarray(v))
                                       for k, v in vars(jax_state).items()})
    return j, t


@pytest.mark.parametrize("method", ["auto", "stepping-stone", "ss", "ti"])
@pytest.mark.parametrize("ladder", ["evidence", "mixing"])
def test_log_evidence_matches_jax(method, ladder):
    betas = (jt.evidence_beta_ladder(6) if ladder == "evidence"
             else jt.default_beta_ladder(6, 8.0))
    j, t = _evidence_pair(betas, 37, seed=len(method))
    if ladder == "mixing" and method in ("stepping-stone", "ss"):
        for obj in (j, t):
            with pytest.raises(ValueError, match="reaching beta=0"), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                obj.log_evidence(method)
        return
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jt.PTEnsembleSampler.log_evidence(j, method)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t.log_evidence(method)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(t.rung_log_like_std,
                               jt.PTEnsembleSampler.rung_log_like_std.fget(j), rtol=1e-12)
    # the same warnings (the port's text says "batch axis" where the JAX
    # package's says "vmapped batch axis")
    assert ([str(w.message).split(" (rungs")[0] for w in tw]
            == [str(w.message).split(" (rungs")[0] for w in jw])
    assert any("under-resolved" in str(w.message) for w in tw) == (ladder == "evidence")


def test_log_evidence_raises_as_jax():
    j, t = _evidence_pair(tt.evidence_beta_ladder(4), 0, seed=1)
    for obj in (j, t):
        with pytest.raises(RuntimeError, match="no retained samples"):
            type(obj).log_evidence(obj)
    j, t = _evidence_pair(tt.evidence_beta_ladder(4), 5, seed=1)
    for obj in (j, t):
        with pytest.raises(ValueError, match="unknown evidence method 'xx'"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            type(obj).log_evidence(obj, "xx")
    j, t = _evidence_pair(np.array([1.0, 0.0]), 5, seed=1)
    for obj in (j, t):
        with pytest.raises(ValueError, match="ntemps >= 3"):
            type(obj).log_evidence(obj)


# -- the real posterior -----------------------------------------------------------
SHAPE, PSF_SHAPE = (32, 32), (16, 16)


@pytest.fixture(scope="module")
def flagship():
    from test_torch_posterior import _graft_entry, _numpy_fields
    from psfmc_tpu.models.spec import build_model_spec as jax_spec
    from psfmc_tpu_torch.models import spec_from_numpy

    jspec = jax_spec(_graft_entry()._flagship_components(SHAPE, PSF_SHAPE))
    return jspec, spec_from_numpy(**_numpy_fields(jspec))


JAX_XLA = {"PSFMC_CONV": "", "PSFMC_RENDER": "xla", "PSFMC_LNPOST": "xla"}


def test_flagship_tempered_steps_match_jax(flagship, monkeypatch):
    """The port's plain path against the JAX package's default path: the
    lnL/prior split on prior draws and three tempered steps on JAX's
    draws, positions and lnL at 1e-9."""
    from psfmc_tpu.models.posterior import build_posterior as jax_posterior
    from psfmc_tpu_torch.flagship import prior_draws
    from psfmc_tpu_torch.models import build_posterior

    for k, v in JAX_XLA.items():
        monkeypatch.setenv(k, v)
    jspec, spec = flagship
    jfns = jax_posterior(jspec, dtype=F64)
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    assert post.lnpost == "batched" and not post.kernel_lnl
    like_b, prior_b = jt.batched_like_prior(jfns)
    nwalkers = 8
    p = prior_draws(spec, T * nwalkers, seed=21)
    mag = next(s.offset for s in spec.slots if s.name == "3_Sersic_mag")
    p[3, mag] = 40.0  # outside its uniform prior: lnL -inf on both sides
    lnl, lnp = (np.asarray(f(jnp.asarray(p))) for f in (like_b, prior_b))
    got = post.log_likelihood_prior_batch(torch.as_tensor(p))
    assert lnl[3] == -np.inf and got[0][3] == -np.inf
    _assert_close(got, (lnl, lnp), rtol=1e-10)
    shape = (T, nwalkers, spec.num_params)
    betas = np.array([1.0, 0.3, 0.05])
    run_both(like_b, prior_b, post.log_likelihood_prior_batch, p.reshape(shape),
             lnl.reshape(shape[:2]), lnp.reshape(shape[:2]), betas,
             jax.random.PRNGKey(22), 3, "stretch", rtol=1e-9)


# -- the sampler -----------------------------------------------------------------
class Box:
    """Uniform([-5, 5]^2) prior x N(0, I_2) likelihood (the JAX tests'
    ``BoxGaussianPosterior``): lnZ = -2 ln 10 to 1e-6."""

    dtype = torch.float64
    device = torch.device("cpu")
    a = 5.0

    def log_prior_batch(self, th):
        th = torch.as_tensor(th, dtype=self.dtype)
        inside = (th.abs() <= self.a).all(dim=1)
        return torch.where(inside, torch.full_like(th[:, 0], -2.0 * math.log(2 * self.a)),
                           torch.full_like(th[:, 0], -math.inf))

    def log_posterior_batch(self, th):
        th = torch.as_tensor(th, dtype=self.dtype)
        return self.log_prior_batch(th) - 0.5 * (th * th).sum(dim=1) - math.log(2 * math.pi)


TRUTH = -2.0 * np.log(10.0)


def _box_pt(nwalkers=64, ntemps=10, burn=300, steps=1200, seed=3, **kw):
    torch.set_num_threads(1)
    pt = tt.PTEnsembleSampler(nwalkers, 2, Box(), ntemps=ntemps,
                              betas=tt.evidence_beta_ladder(ntemps), seed=seed,
                              device="cpu", **kw)
    pt.init_state(np.random.RandomState(0).uniform(-5, 5, (nwalkers, 2)))
    pt.run_burn(burn)
    pt.reset()
    pt.run_sampling(steps)
    return pt


def test_pt_recovers_the_analytic_evidence():
    """``tests/test_evidence.py::test_evidence_recovers_analytic_lnz``'s bars."""
    pt = _box_pt()
    lnz_ss, err_ss = pt.log_evidence("stepping-stone")
    lnz_ti, err_ti = pt.log_evidence("ti")
    assert abs(lnz_ss - TRUTH) < 0.15, (lnz_ss, TRUTH)
    assert abs(lnz_ti - TRUTH) < 0.6, (lnz_ti, TRUTH)
    assert pt.log_evidence() == (lnz_ss, err_ss)
    assert err_ss < 1.0 and err_ti < 1.5
    m = pt.rung_log_like_mean
    assert m[0] > m[-1]
    assert abs(m[0] - (-np.log(2 * np.pi) - 1.0)) < 0.1
    assert np.all(pt.rung_log_like_std >= 0)
    assert pt.chain.shape == (64, 1200, 2)
    assert np.all((pt.swap_acceptance_fraction > 0) & (pt.swap_acceptance_fraction <= 1))
    assert pt.tempered_acceptance_fraction.shape == (10, 64)


class Gauss(Box):
    """A 40-dimensional standard normal likelihood in a wide box: std(lnL)
    about sqrt(20) at beta = 1, enough for the ladder to be re-sized."""

    a = 50.0


def test_ladder_adaptation_writes_the_beta_buffer_in_place():
    """Burn-in adaptation resizes the ladder every window (the JAX
    package's rule) and writes it into the same device buffer; the
    callback runs once per window; explicit betas stay pinned."""
    torch.set_num_threads(1)
    with pytest.warns(UserWarning, match="fewer than the recommended"):
        pt = tt.PTEnsembleSampler(16, 40, Gauss(), ntemps=4, seed=1, device="cpu")
    assert pt.adapt_ladder
    pt.init_state(np.random.RandomState(2).randn(16, 40))
    buf = pt.state.betas
    windows = []
    pt.run_burn(60, segment=7, callback=lambda done, total: windows.append(done))
    assert windows == list(range(5, 61, 5)) and pt._adapt_t == 11
    assert pt.state.betas is buf
    np.testing.assert_array_equal(buf.numpy(), pt.betas)
    assert not np.array_equal(pt.betas, tt.default_beta_ladder(4))
    assert pt.betas[0] == 1.0 and np.all(np.diff(pt.betas) < 0)
    pinned = tt.PTEnsembleSampler(16, 2, Box(), ntemps=3, betas=[1.0, 0.5, 0.1],
                                  device="cpu")
    pinned.init_state(np.zeros((3, 16, 2)) + 0.1 * np.random.RandomState(3).randn(3, 16, 2))
    pinned.run_burn(20)
    np.testing.assert_array_equal(pinned.betas, [1.0, 0.5, 0.1])
    with pytest.raises(ValueError, match="betas\\[0\\] must be 1.0"):
        tt.PTEnsembleSampler(16, 2, Box(), ntemps=2, betas=[0.9, 0.5], device="cpu")
    with pytest.raises(ValueError, match="rungs"):
        tt.PTEnsembleSampler(16, 2, Box(), ntemps=3, betas=[1.0, 0.5], device="cpu")


def test_rejuvenate_stuck_works_per_rung():
    torch.set_num_threads(1)
    pt = tt.PTEnsembleSampler(16, 2, Box(), ntemps=3, betas=[1.0, 0.5, 0.0],
                              seed=4, device="cpu")
    pos = np.random.RandomState(5).uniform(-1, 1, (3, 16, 2))
    pos[0, 3] = [7.0, 0.0]  # outside the prior: stranded on the cold rung
    pos[2, 5] = [0.0, 9.0]  # and on the prior rung
    pt.init_state(pos)
    assert pt.rejuvenate_stuck(random_state=0) == 2
    assert torch.isfinite(pt.state.log_prior).all()
    after = pt.state.positions.numpy()
    np.testing.assert_array_equal(after[1], pos[1])
    assert any(np.array_equal(after[0, 3], pos[0, j]) for j in range(16) if j != 3)


# -- checkpoints ----------------------------------------------------------------
NAMES, LENS = ["x"], [2]
MODEL2 = types.SimpleNamespace(param_names=NAMES, param_lens=LENS)


def _sampled(ntemps=4, seed=6):
    torch.set_num_threads(1)
    pt = tt.PTEnsembleSampler(16, 2, Box(), ntemps=ntemps,
                              betas=tt.evidence_beta_ladder(ntemps), seed=seed,
                              device="cpu")
    pt.init_state(np.random.RandomState(seed).uniform(-2, 2, (16, 2)))
    pt.run_burn(10)
    pt.reset()
    pt.run_sampling(12)
    return pt


def test_port_checkpoint_reads_in_jax(tmp_path):
    pt = _sampled()
    path = str(tmp_path / "db.fits")
    tdb.save_database(pt, MODEL2, path, meta_dict={"MCITER": 12})
    pay = pt.checkpoint_payload()
    for load in (jdb.load_checkpoint, tdb.load_checkpoint):
        ck = load(path)
        assert ck["ntemps"] == 4 and ck["version"] == 2
        np.testing.assert_array_equal(ck["positions"], pay["positions"])
        np.testing.assert_array_equal(ck["naccept"], pay["naccept"])
        np.testing.assert_array_equal(ck["log_prob"], pay["log_prob"])
        for name in ("betas", "nswap", "lnl_sum", "lnl_sq_sum", "ss_max", "ss_sum"):
            np.testing.assert_array_equal(ck[name], pay[name], err_msg=name)
        assert ck["evid_steps"] == 12 and ck["nsteps"] == 12
    assert tdb.load_checkpoint(path)["rng_kind"] == "torch-cpu"


def test_jax_checkpoint_reads_in_the_port(tmp_path):
    rng = np.random.RandomState(7)
    pay = {"version": 2, "ntemps": 3, "positions": rng.randn(3, 6, 2),
           "log_prob": rng.randn(6), "naccept": rng.randint(0, 9, (3, 6)),
           "nsteps": 9, "key": np.array([0, 42], np.uint32),
           "nswap": np.array([5, 2]), "betas": np.array([1.0, 0.1, 0.0]),
           "accum": None, "accum_count": 0, "lnl_sum": rng.randn(3),
           "lnl_sq_sum": rng.rand(3), "evid_steps": 9, "ss_max": rng.randn(2),
           "ss_sum": rng.rand(2)}
    sampler = types.SimpleNamespace(chain=None, lnprobability=None, nwalkers=6,
                                    state=object(), checkpoint_kind="ensemble",
                                    checkpoint_payload=lambda: dict(pay))
    path = str(tmp_path / "db.fits")
    jdb.save_database(sampler, MODEL2, path, meta_dict={"MCITER": 0})
    want, got = jdb.load_checkpoint(path), tdb.load_checkpoint(path)
    assert got["rng_kind"] == "jax" and got["ntemps"] == want["ntemps"] == 3
    for name in ("positions", "naccept", "log_prob", "betas", "nswap", "lnl_sum",
                 "lnl_sq_sum", "ss_max", "ss_sum", "evid_steps"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(got[name], pay[name], err_msg=name)
    pt = tt.PTEnsembleSampler(6, 2, Box(), ntemps=3, device="cpu")
    with pytest.raises(ValueError, match="'jax' cannot be restored"):
        pt.restore_state(got)


def test_full_restore_continues_bit_for_bit(tmp_path):
    """A tempered run checkpointed mid-sampling and restored into a fresh
    sampler continues exactly as the original: every rung, the ladder, the
    swap counts, the generator and the evidence accumulators."""
    pt = _sampled(ntemps=4)
    path = str(tmp_path / "db.fits")
    tdb.save_database(pt, MODEL2, path, meta_dict={"MCITER": 12})
    fresh = tt.PTEnsembleSampler(16, 2, Box(), ntemps=4, seed=99, device="cpu")
    fresh.restore_state(tdb.load_checkpoint(path))
    np.testing.assert_array_equal(fresh.betas, pt.betas)
    assert fresh._adapt_t == 1  # a restored ladder is not adapted again
    lnz = pt.log_evidence()
    np.testing.assert_allclose(fresh.log_evidence(), lnz, rtol=1e-12)
    for a, b in ((pt, fresh),):
        a.run_sampling(5)
        b.run_sampling(5)
    for name in ("positions", "log_like", "log_prior", "naccept", "nswap", "ss_max",
                 "ss_sum", "evid_steps"):
        assert torch.equal(getattr(pt.state, name), getattr(fresh.state, name)), name
    np.testing.assert_allclose(fresh.log_evidence(), pt.log_evidence(), rtol=1e-12)
    np.testing.assert_array_equal(fresh.swap_acceptance_fraction,
                                  pt.swap_acceptance_fraction)


def test_ntemps_mismatch_warns_and_takes_the_cold_rung():
    pay = _sampled(ntemps=3).checkpoint_payload()
    pt = tt.PTEnsembleSampler(16, 2, Box(), ntemps=4, device="cpu")
    with pytest.warns(UserWarning, match="3 tempering rungs but ntemps=4"):
        pt.restore_state(pay)
    pos = pt.state.positions.numpy()
    for t in range(4):
        np.testing.assert_array_equal(pos[t], pay["positions"][0])
    assert int(pt.state.nswap.sum()) == 0 and int(pt.state.evid_steps) == 0
    np.testing.assert_array_equal(pt.betas, tt.default_beta_ladder(4))


def test_plain_sampler_restores_the_cold_rung():
    pay = _sampled(ntemps=3).checkpoint_payload()
    plain = EnsembleSampler(16, 2, Box(), device="cpu")
    plain.restore_state(pay)
    np.testing.assert_array_equal(plain.state.positions.numpy(), pay["positions"][0])
    np.testing.assert_array_equal(plain.state.naccept.numpy(), pay["naccept"][0])
    np.testing.assert_allclose(plain.state.log_prob.numpy(), pay["log_prob"], rtol=1e-12)
    assert plain._nsteps_total == pay["nsteps"]


# -- the driver -------------------------------------------------------------------
def test_driver_writes_the_evidence_cards(tmp_path):
    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    torch.set_num_threads(1)
    args = dict(output_name=str(tmp_path / "out"), chains=24, burn=10,
                iterations=6, seed=0, device="cpu", checkpoint_interval=3,
                ntemps=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        db = model_galaxy_mcmc(str(tmp_path / "model.py"), **args)
    assert len(db) == 24 * 6 and db.meta["MCITER"] == 6
    assert np.isfinite(db.meta["MCLNZ"]) and db.meta["MCLNZERR"] >= 0
    ck = tdb.load_checkpoint(str(tmp_path / "out_db.fits"))
    assert ck["ntemps"] == 3 and ck["positions"].shape[:2] == (3, 24)
    assert ck["evid_steps"] == 6 and ck["betas"].shape == (3,)
    # a second call with more iterations resumes every rung, and its
    # evidence accumulators continue
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        db2 = model_galaxy_mcmc(str(tmp_path / "model.py"), **dict(args, iterations=9))
    assert len(db2) == 24 * 9 and np.isfinite(db2.meta["MCLNZ"])
    ck2 = tdb.load_checkpoint(str(tmp_path / "out_db.fits"))
    assert ck2["evid_steps"] == 9
    np.testing.assert_array_equal(ck2["betas"], ck["betas"])
    for name in db.colnames:
        np.testing.assert_array_equal(
            np.asarray(db2[name]).reshape(24, 9, -1)[:, :6],
            np.asarray(db[name]).reshape(24, 6, -1), err_msg=name)


def test_driver_nuts_still_raises_naming_item_19(tmp_path):
    """Item 19 brought NUTS: ``sampler="nuts"`` with ``ntemps`` now warns
    that the rungs are ignored and runs NUTS (its checkpoint's kind); a
    mesh that is not a ``WalkerMesh`` raises a ``TypeError`` naming the
    type it takes."""
    _write_inputs(str(tmp_path), shape=(16, 16), psf_shape=(8, 8))
    (tmp_path / "model.py").write_text(MODEL)
    with pytest.warns(UserWarning, match="ntemps is ignored with sampler='nuts'"):
        db = model_galaxy_mcmc(str(tmp_path / "model.py"), output_name=str(tmp_path / "out"),
                               chains=4, burn=12, iterations=6, device="cpu",
                               sampler="nuts", ntemps=4, max_depth=2)
    assert len(db) == 4 * 6
    assert tdb.load_checkpoint(str(tmp_path / "out_db.fits"))["sampler_kind"] == "nuts"
    with pytest.raises(TypeError, match="mesh must be a psfmc_tpu_torch.parallel.WalkerMesh"):
        model_galaxy_mcmc("no_such_model.py", device="cpu", sampler="nuts", ntemps=4,
                          mesh=object())


def test_adaptation_measures_finite_walkers_only():
    """A walker whose lnL is -inf (a profile that overflows) leaves the
    adapted ladder finite: each rung's std(lnL) is taken over its finite
    walkers (the JAX package's np.std over all of them turns it NaN)."""
    class Overflow(Gauss):
        def log_posterior_batch(self, th):
            out = super().log_posterior_batch(th)
            th = torch.as_tensor(th, dtype=self.dtype)
            return torch.where(th[:, 0] > 4.0, torch.full_like(out, -math.inf), out)

    torch.set_num_threads(1)
    with pytest.warns(UserWarning, match="fewer than the recommended"):
        # a = 1.0001: stretches of at most 1e-4, so the walker stays put
        pt = tt.PTEnsembleSampler(16, 40, Overflow(), ntemps=4, seed=1,
                                  device="cpu", a=1.0001)
    p0 = np.random.RandomState(2).randn(16, 40)
    p0[3, 0] = 4.5  # in the prior, lnL -inf on every rung
    pt.init_state(p0)
    pt.run_burn(10)
    assert not np.isfinite(pt.state.log_like.numpy()).all()
    assert np.isfinite(pt.betas).all() and np.all(np.diff(pt.betas) < 0)
    np.testing.assert_array_equal(tt._finite_std(np.array([[1.0, 3.0, -np.inf], [2.0, np.nan, -np.inf]])),
                                  [1.0, 0.0])


def test_gc_is_paused_over_a_capture():
    """Every capture runs with Python's collector paused, after a
    collection: a dead cycle holding an earlier graph is destroyed before
    the capture, never inside it (which invalidates the capture)."""
    import gc
    import weakref

    from psfmc_tpu_torch._device import gc_paused

    class Holder:
        pass

    cycle = Holder()
    cycle.self = cycle
    alive = weakref.ref(cycle)
    del cycle
    assert gc.isenabled()
    with gc_paused():
        assert alive() is None and not gc.isenabled()
    assert gc.isenabled()


def test_joint_model_tempers_through_the_same_code():
    """A joint multi-band posterior's split is the JAX package's rule,
    ``lnpost - lnprior`` where the prior is finite and -inf elsewhere
    (``tests/test_torch_joint.py`` holds its lnpost and prior to the JAX
    package's), and a tempered sampler runs on it (the joint flagship at
    24x24 and 18x18)."""
    from test_torch_joint import _flagship, _thetas

    torch.set_num_threads(1)
    fns = _flagship("torch").posterior_fns
    th = torch.as_tensor(_thetas(_flagship("torch"), n=12, seed=23))
    lnl, lp = fns.log_likelihood_prior_batch(th)
    post, prior = fns.log_posterior_batch(th), fns.log_prior_batch(th)
    want = torch.where(torch.isfinite(prior), post - prior,
                       torch.full_like(prior, -math.inf))
    assert torch.equal(lp, prior) and torch.isinf(lnl).any()
    torch.testing.assert_close(lnl, want, rtol=0.0, atol=0.0)
    pt = tt.PTEnsembleSampler(12, th.shape[1], fns, ntemps=3,
                              betas=[1.0, 0.3, 0.0], seed=3, device="cpu")
    pt.init_state(th)
    pt.run_burn(2)
    pt.reset()
    pt.run_sampling(2)
    assert pt.chain.shape == (12, 2, th.shape[1]) and int(pt.state.evid_steps) == 2
