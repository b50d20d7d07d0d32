"""The port's annealed importance sampling (SMC evidence) against the JAX
package's, on the CPU.

Three anneal steps, one of them resampling some groups and not others,
on the JAX package's draws (``run_ais``'s key splits, handed to the port
in its own order of draws) agree at 1e-12 in float64; the analytic
evidence of the Box-Gaussian target is recovered at the JAX test's bars;
the argument checks and the two failure-mode warnings are the JAX
package's; ``model_galaxy_evidence`` runs a model file.
"""
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu.sampler import ais as jais
from psfmc_tpu_torch import model_galaxy_evidence
from psfmc_tpu_torch.sampler import ais as tais
from test_torch_driver import MODEL, _write_inputs
from test_torch_tempered import (
    TRUTH,
    Box,
    ScriptedDraws,
    _assert_close,
    half_draws,
)

F64 = jnp.float64
GROUPS, M, DIM = 3, 8, 2


def _jax_like(x):
    return -0.5 * jnp.sum((x - 0.5) ** 2 / 0.2, axis=-1)


def _jax_prior(x):
    inside = jnp.all(jnp.abs(x) <= 3.0, axis=-1)
    return jnp.where(inside, -2.0 * jnp.log(6.0), -jnp.inf)


def _torch_like_prior(x):
    lnl = -0.5 * (((x - 0.5) ** 2) / 0.2).sum(dim=-1)
    inside = (x.abs() <= 3.0).all(dim=-1)
    lp = torch.where(inside, torch.full_like(lnl, -2.0 * math.log(6.0)),
                     torch.full_like(lnl, -math.inf))
    return lnl, lp


def _ais_draws(key, nsteps, sweeps, moves):
    """``run_ais``'s draws over ``nsteps`` steps, in the port's order."""
    out = []
    for _ in range(nsteps):
        key, kr = jax.random.split(key)
        out.append(("uniform", jax.random.uniform(kr, (GROUPS, 1), F64)))
        for _ in range(sweeps):
            key, k0, k1, km = jax.random.split(key, 4)
            if moves == "mixed":
                use_de = bool(jax.random.bernoulli(km))
                out.append(("uniform", np.array(0.25 if use_de else 0.75)))
            out += half_draws(k0, (GROUPS, M // 2), M // 2, moves)
            out += half_draws(k1, (GROUPS, M // 2), M // 2, moves)
    return out


@pytest.mark.parametrize("moves,sweeps", [("stretch", 1), ("mixed", 2), ("de", 1)])
def test_three_ais_steps_match_jax(moves, sweeps):
    p0 = np.random.RandomState(60).uniform(-3, 3, (GROUPS, M, DIM))
    schedule = np.array([0.0, 0.05, 0.4, 1.0])
    key = jax.random.PRNGKey(61)
    want = jais.run_ais(jax.vmap(_jax_like), jax.vmap(_jax_prior), jnp.asarray(p0), key,
                        jnp.asarray(schedule), sweeps=sweeps, resample_threshold=0.8,
                        moves=moves)
    draws = ScriptedDraws(_ais_draws(key, 3, sweeps, moves))
    step = tais.make_ais_step_fn(_torch_like_prior, draws, sweeps=sweeps,
                                 resample_threshold=0.8, moves=moves)
    state, replays = tais.run_ais(_torch_like_prior, torch.as_tensor(p0), schedule,
                                  torch.Generator(), sweeps=sweeps,
                                  resample_threshold=0.8, moves=moves)
    assert replays == 0  # the CPU runs the step function eagerly
    # the same anneal again, step by step, on JAX's draws
    lnl, lnp = _torch_like_prior(torch.as_tensor(p0).reshape(-1, DIM))
    state = tais.AISState(
        positions=torch.as_tensor(p0).clone(), log_like=lnl.reshape(GROUPS, M),
        log_prior=lnp.reshape(GROUPS, M),
        lnw=torch.full((GROUPS, M), -math.log(M), dtype=torch.float64),
        lnz=torch.zeros(GROUPS, dtype=torch.float64),
        ess_min=torch.full((GROUPS,), float(M), dtype=torch.float64),
        naccept=torch.zeros((), dtype=torch.int64),
        nresample=torch.zeros((), dtype=torch.int64),
        schedule=torch.as_tensor(schedule), t=torch.zeros(1, dtype=torch.int64))
    for _ in range(3):
        step(state)
    assert not draws.items
    pos, lnl_w, lnz, lnw, nacc, nres, ess_min = want
    _assert_close([state.positions, state.log_like, state.lnz, state.lnw, state.ess_min],
                  [pos, lnl_w, lnz, lnw, ess_min])
    assert int(state.naccept) == int(nacc) and int(state.nresample) == int(nres)
    assert 0 < int(nres) < 3 * GROUPS  # a resampling event, and a step without
    assert int(state.t) == 3


def test_ais_recovers_the_analytic_evidence():
    """``tests/test_evidence.py::test_ais_recovers_analytic_lnz``'s bars."""
    torch.set_num_threads(1)
    post = Box()
    p0 = np.random.RandomState(11).uniform(-post.a, post.a, (128, 2))
    res = tais.ais_evidence(post, nwalkers=128, nsteps=600, groups=8, seed=5, p0=p0)
    assert abs(res.lnz - TRUTH) < 0.1, (res.lnz, TRUTH)
    assert abs(res.lnz - TRUTH) < 3.5 * max(res.err, 0.02)
    assert res.ess > 0.2 * res.nwalkers
    assert 0.1 < res.accept_fraction < 0.9
    assert res.lnz_groups.shape == (8,) and res.nsteps == 600 and res.nwalkers == 128

    s = tais.ais_beta_schedule(100)
    np.testing.assert_array_equal(s, jais.ais_beta_schedule(100))
    np.testing.assert_array_equal(tais.ais_beta_schedule(37, 2.5),
                                  jais.ais_beta_schedule(37, 2.5))
    with pytest.raises(ValueError, match="ascend from 0 to 1"):
        tais.ais_evidence(post, nwalkers=128, p0=p0, schedule=np.linspace(0.1, 1, 50))
    with pytest.raises(ValueError, match="walkers/group"):
        tais.ais_evidence(post, nwalkers=8, groups=8, p0=p0)


def test_ais_argument_checks_are_jax_s():
    post = Box()
    p0 = np.random.RandomState(12).uniform(-5, 5, (32, 2))
    with pytest.raises(ValueError, match="groups >= 2"):
        tais.ais_evidence(post, nwalkers=32, groups=1, p0=p0)
    bad = p0.copy()
    bad[3] = 9.0
    with pytest.raises(ValueError, match="1/32 rows of p0 are outside the prior"):
        tais.ais_evidence(post, nwalkers=32, groups=4, p0=bad)
    with pytest.raises(ValueError, match="unknown moves 'walk'"):
        tais.ais_evidence(post, nwalkers=32, groups=4, p0=p0, moves="walk")
    no_prior = type("NoPrior", (), {"dtype": torch.float64,
                                    "device": torch.device("cpu"),
                                    "log_posterior_batch": Box.log_posterior_batch})()
    with pytest.raises(ValueError, match="log_prior decomposition"):
        tais.ais_evidence(no_prior, nwalkers=32, p0=p0)
    # odd walkers per group round down to even, as in the JAX package
    res = tais.ais_evidence(post, nwalkers=30, groups=4, nsteps=5, p0=p0[:30],
                            moves="stretch")
    assert res.nwalkers == 24


class Narrow(Box):
    """A likelihood far narrower than the prior: a handful of steps cannot
    anneal it, so the weights collapse and the groups disagree."""

    def log_posterior_batch(self, th):
        th = torch.as_tensor(th, dtype=self.dtype)
        return self.log_prior_batch(th) - 0.5 * (th * th).sum(dim=1) / 1e-4


def test_ais_failure_warnings_are_jax_s():
    post = Narrow()
    p0 = np.random.RandomState(13).uniform(-5, 5, (128, 2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tais.ais_evidence(post, nwalkers=128, groups=4, nsteps=4, p0=p0,
                                moves="stretch")
    text = [str(w.message) for w in caught]
    assert any(t.startswith("AIS group estimates disagree by") for t in text), text
    assert any(t.startswith("AIS transitions are under-mixing") for t in text), text
    assert np.std(res.lnz_groups, ddof=1) > 3.0


def test_model_galaxy_evidence_runs_a_model_file(tmp_path):
    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = model_galaxy_evidence(str(tmp_path / "model.py"), nwalkers=32,
                                    nsteps=12, groups=2, sweeps=1, device="cpu")
    assert np.isfinite(res.lnz) and np.isfinite(res.err)
    assert res.nwalkers == 32 and res.nsteps == 12 and res.lnz_groups.shape == (2,)
    with pytest.raises(TypeError, match="mesh must be a psfmc_tpu_torch.parallel.WalkerMesh"):
        model_galaxy_evidence(str(tmp_path / "model.py"), mesh=object(), device="cpu")


def test_ais_draws_its_own_prior_sample(tmp_path):
    """``p0=None``: draws from the priors with the joint constraints
    rejection-sampled, on the model's own posterior."""
    from psfmc_tpu_torch.models import as_model

    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    fns = as_model(str(tmp_path / "model.py"), device="cpu").posterior_fns
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = tais.ais_evidence(fns, nwalkers=16, nsteps=6, groups=2, seed=3)
    assert np.isfinite(res.lnz_groups).all() and 0 <= res.accept_fraction <= 1
