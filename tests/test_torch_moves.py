"""The port's DE and mixed moves, thinning, on-device moments and
``sample()``, on the CPU, against the JAX package's ensemble sampler.

The draws of a half-step are made with ``jax.random`` from one key and
its six-way split, exactly as ``psfmc_tpu.sampler.ensemble._stretch_half``
makes them, and handed to the port's move; both packages evaluate the
same Gaussian log-density, in float64.
"""
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu.sampler import ensemble as jens
from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.sampler import EnsembleSampler
from psfmc_tpu_torch.sampler import ensemble as tens
from test_torch_sampler import _Gaussian2D

K = M = 12
DIM = 3


def _jax_lnpost(x):
    return jnp.where(x[:, 0] > 2.0, -jnp.inf, -0.5 * jnp.sum(x * x, axis=1))


def _torch_lnpost(x):
    out = -0.5 * (x * x).sum(dim=1)
    return torch.where(x[:, 0] > 2.0, torch.full_like(out, -math.inf), out)


def _walkers(seed):
    rng = np.random.RandomState(seed)
    active, comp = rng.randn(K, DIM), rng.randn(M, DIM)
    return active, np.asarray(_jax_lnpost(jnp.asarray(active))), comp


def _draws(key):
    """The JAX half-step's draws from ``key``, as numpy (its split order)."""
    key_z, key_r, key_u, key_r2, key_g, key_j = jax.random.split(key, 6)
    f64 = jnp.float64
    return {
        "u": jax.random.uniform(key_z, (K,), f64),
        "partner": jax.random.randint(key_r, (K,), 0, M),
        "shift": jax.random.randint(key_r2, (K,), 0, M - 1),
        "u_jump": jax.random.uniform(key_g, (K,), f64),
        "normal": jax.random.normal(key_j, (K,), f64),
        "u_accept": jax.random.uniform(key_u, (K,), f64),
    }


def _t(draws):
    return {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}


def _assert_same(got, want):
    # float64, the same operations in the same order: 1e-12
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("gamma0", [None, 0.4])
def test_de_update_matches_jax(gamma0):
    active, lnp, comp = _walkers(40)
    key = jax.random.PRNGKey(41)
    want = jens._stretch_half(key, jnp.asarray(active), jnp.asarray(lnp),
                              jnp.asarray(comp), _jax_lnpost, 2.0, DIM,
                              use_de=jnp.asarray(True), gamma0=gamma0)
    d = _t(_draws(key))
    g0 = 2.38 / math.sqrt(2.0 * DIM) if gamma0 is None else gamma0
    got = tens.de_update(torch.as_tensor(active), torch.as_tensor(lnp),
                         torch.as_tensor(comp), _torch_lnpost, g0, d["partner"],
                         d["shift"], d["u_jump"], d["normal"], d["u_accept"])
    _assert_same(got, want)
    assert 0 < int(got[2].sum()) < K
    # the two partners are distinct complementary walkers
    partner2 = (d["partner"] + 1 + d["shift"]) % M
    assert torch.all(partner2 != d["partner"])


@pytest.mark.parametrize("use_de", [False, True])
def test_mixed_update_matches_jax(use_de):
    """The mixed step with the move choice given; its stretch branch is
    the stretch move itself, bit for bit."""
    active, lnp, comp = _walkers(42)
    key = jax.random.PRNGKey(43)
    want = jens._stretch_half(key, jnp.asarray(active), jnp.asarray(lnp),
                              jnp.asarray(comp), _jax_lnpost, 2.0, DIM,
                              use_de=jnp.asarray(use_de))
    d = _t(_draws(key))
    args = (torch.as_tensor(active), torch.as_tensor(lnp), torch.as_tensor(comp),
            _torch_lnpost)
    got = tens.mixed_update(*args, 2.0, DIM, 2.38 / math.sqrt(2.0 * DIM),
                            torch.tensor(use_de), d["u"], d["partner"],
                            d["shift"], d["u_jump"], d["normal"], d["u_accept"])
    _assert_same(got, want)
    if not use_de:
        stretch = tens.stretch_update(*args, 2.0, DIM, d["u"], d["partner"],
                                      d["u_accept"])
        for g, s in zip(got, stretch):
            assert torch.equal(g, s)


@pytest.mark.parametrize("moves", ["de", "mixed"])
def test_de_and_mixed_recover_a_correlated_gaussian(moves):
    target = _Gaussian2D()
    rng = np.random.RandomState(44)
    s = EnsembleSampler(32, 2, target, seed=6, device="cpu", moves=moves,
                        track_moments=True)
    s.init_state(rng.randn(32, 2) * 0.1)
    s.run_burn(300)
    s.reset()
    s.run_sampling(1500)
    flat = s.flatchain
    assert s.chain.shape == (32, 1500, 2)
    # the tolerances of test_sampler_recovers_a_correlated_gaussian
    np.testing.assert_allclose(flat.mean(axis=0), target.mean, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), target.cov, atol=0.15)
    assert 0.2 < s.acceptance_fraction.mean() < 0.9
    mean, std = s.posterior_moments
    np.testing.assert_allclose(mean, flat.mean(axis=0), rtol=1e-10)
    np.testing.assert_allclose(std, flat.std(axis=0, ddof=1), rtol=1e-10)


def test_moves_and_thin_are_checked_as_in_jax():
    target = _Gaussian2D()
    with pytest.raises(ValueError, match="unknown moves 'walk'"):
        EnsembleSampler(8, 2, target, device="cpu", moves="walk")
    with pytest.raises(ValueError, match="thin must be >= 1"):
        EnsembleSampler(8, 2, target, device="cpu", thin=0)
    s = EnsembleSampler(8, 2, target, device="cpu", thin=3)
    s.init_state(np.random.RandomState(45).randn(8, 2))
    with pytest.raises(ValueError, match="not divisible by thin=3"):
        s.run_sampling(10)
    assert s.posterior_moments is None  # track_moments off, as in JAX


@pytest.mark.parametrize("moves", ["stretch", "mixed"])
def test_thin_records_every_kth_step_and_moments_cover_all(moves):
    """``thin=3`` gives exactly every third step of an unthinned run from
    the same seed; segments round to thinning boundaries; the on-device
    moments are the Welford moments of the unthinned chain."""
    target = _Gaussian2D()
    p0 = np.random.RandomState(46).randn(10, 2)
    runs = {}
    for thin in (1, 3):
        s = EnsembleSampler(10, 2, target, seed=7, device="cpu", thin=thin,
                            moves=moves, track_moments=True)
        s.init_state(p0)
        s.run_burn(5)
        s.reset()
        done = []
        s.run_sampling(12, segment=5, callback=lambda d, t: done.append(d))
        runs[thin] = (s, done)
    full, thinned = runs[1][0], runs[3][0]
    assert runs[3][1] == [3, 6, 9, 12] and runs[1][1] == [5, 10, 12]
    assert thinned.chain.shape == (10, 4, 2)
    np.testing.assert_array_equal(thinned.chain, full.chain[:, 2::3])
    np.testing.assert_array_equal(thinned.lnprobability, full.lnprobability[:, 2::3])
    np.testing.assert_array_equal(thinned.acceptance_fraction,
                                  full.acceptance_fraction)
    j_m = {"mean": jnp.zeros(2), "m2": jnp.zeros(2), "n": jnp.int32(0)}
    for step in range(12):
        j_m = jens.welford_batch_update(j_m, jnp.asarray(full.chain[:, step]))
    want_std = np.sqrt(np.asarray(j_m["m2"]) / (int(j_m["n"]) - 1))
    for s in (full, thinned):
        mean, std = s.posterior_moments
        assert int(s.state.moments["n"]) == 120
        np.testing.assert_allclose(mean, np.asarray(j_m["mean"]), rtol=1e-12)
        np.testing.assert_allclose(std, want_std, rtol=1e-12)
    thinned.reset()
    assert int(thinned.state.moments["n"]) == 0
    assert np.all(thinned.posterior_moments[1] == 0)


def test_sample_yields_the_chain_of_run_sampling():
    target = _Gaussian2D()
    p0 = np.random.RandomState(47).randn(8, 2)
    s = EnsembleSampler(8, 2, target, seed=8, device="cpu", moves="mixed")
    ref = EnsembleSampler(8, 2, target, seed=8, device="cpu", moves="mixed")
    ref.init_state(p0)
    ref.run_sampling(7)
    got = list(s.sample(p0, iterations=7, segment=3))
    assert len(got) == 7
    for i, (pos, lnp, rstate) in enumerate(got):
        np.testing.assert_array_equal(pos, ref.chain[:, i])
        np.testing.assert_array_equal(lnp, ref.lnprobability[:, i])
    # the generator's state where the JAX package yields its key
    assert torch.equal(got[-1][2], s.generator.get_state())
    np.testing.assert_array_equal(s.chain, ref.chain)
    np.testing.assert_array_equal(s.acceptance_fraction, ref.acceptance_fraction)
    s.clear_blobs()
    # storechain=False runs the steps and keeps no chain
    assert len(list(s.sample(iterations=2, storechain=False))) == 2
    assert s.chain.shape == (8, 7, 2)


def test_sample_reseats_walkers_and_keeps_the_accumulators():
    spec = build_model_spec(flagship_components((16, 16), (8, 8)))
    fns = build_posterior(spec, device="cpu", dtype=torch.float32)
    nw = 40
    s = EnsembleSampler(nw, spec.num_params, fns, seed=1, device="cpu")
    for _ in s.sample(prior_draws(spec, nw, seed=1), iterations=2):
        pass
    assert s.accumulated_samples == 2 * nw
    p1 = prior_draws(spec, nw, seed=2)
    assert list(s.sample(p1, iterations=0)) == []
    np.testing.assert_array_equal(s.state.positions.numpy(), p1.astype(np.float32))
    np.testing.assert_array_equal(s.state.log_prob.numpy(),
                                  fns.log_posterior_batch(p1).numpy())
    for _ in s.sample(iterations=3, storechain=False):
        pass
    assert s.accumulated_samples == 5 * nw and s.chain.shape[1] == 2


def _jax_sampler(thin=1):
    fns = types.SimpleNamespace(
        log_posterior_batch=lambda x: -0.5 * jnp.sum(x * x, axis=1),
        carry_images=lambda theta: {}, dtype=jnp.float64)
    return jens.EnsembleSampler(8, 2, fns, seed=0, thin=thin)


@pytest.mark.parametrize("case", [
    dict(kw=dict(bogus=1)), dict(kw=dict(mh_proposal=object())),
    dict(kw=dict(thin=2)), dict(kw={}, thin=2), dict(kw={}, p0=False),
], ids=["unknown-keyword", "mh_proposal", "thin-argument", "sampler-thin", "no-p0"])
def test_sample_raises_the_errors_of_jax(case):
    p0 = np.random.RandomState(48).randn(8, 2)
    thin = case.get("thin", 1)
    args = {} if case.get("p0") is False else {"p0": p0}
    errors = []
    for sampler in (_jax_sampler(thin),
                    EnsembleSampler(8, 2, _Gaussian2D(), device="cpu", thin=thin)):
        with pytest.raises((TypeError, ValueError)) as err:
            next(sampler.sample(iterations=2, **args, **case["kw"]))
        errors.append((err.type, str(err.value)))
    assert errors[0] == errors[1]


def test_accumulated_images_match_jax_merge():
    """The device ``accum_count`` and the in-place merge give the running
    means the JAX package's ``merge_image_accumulators`` gives over the
    same per-step ensemble means (float32, 1e-5 of the image's peak)."""
    spec = build_model_spec(flagship_components((32, 32), (16, 16)))
    fns = build_posterior(spec, device="cpu", dtype=torch.float32)
    nw = 40
    s = EnsembleSampler(nw, spec.num_params, fns, seed=3, device="cpu")
    s.init_state(prior_draws(spec, nw, seed=3))
    s.run_sampling(3)
    assert int(s.state.accum_count) == s.accumulated_samples == 3 * nw
    j_acc = {k: jnp.zeros(v, jnp.float32) for k, v in fns.carry_image_shapes().items()}
    j_n = jnp.int32(0)
    for step in range(3):
        means = fns.ensemble_carry_means(torch.as_tensor(s.chain[:, step]))
        j_acc, j_n = jens.merge_image_accumulators(
            j_acc, j_n, {k: jnp.asarray(v.numpy()) for k, v in means.items()}, nw)
    got = s.accumulated_images
    assert sorted(got) == sorted(j_acc) and int(j_n) == 3 * nw
    for k, v in j_acc.items():
        want = np.asarray(v)
        np.testing.assert_allclose(got[k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
