"""The port's stretch-move ensemble sampler, on the CPU.

The random draws of a half-step are injected so the move can be held
against a numpy transcription of the JAX package's ``_stretch_half``;
the statistics helpers are held against the JAX package's own.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu.sampler import ensemble as jens
from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.sampler import ensemble as tens
from psfmc_tpu_torch.sampler import EnsembleSampler


def _numpy_stretch(active_pos, active_lnp, comp_pos, lnpost, a, dim, u,
                   partner, u_accept):
    """psfmc_tpu/sampler/ensemble.py:127-159 (stretch branch) in numpy."""
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    c = comp_pos[partner]
    proposal = c + z[:, None] * (active_pos - c)
    log_extra = (dim - 1.0) * np.log(z)
    prop_lnp = lnpost(proposal)
    log_ratio = log_extra + prop_lnp - active_lnp
    accept = np.log(u_accept) < log_ratio
    new_pos = np.where(accept[:, None], proposal, active_pos)
    new_lnp = np.where(accept, prop_lnp, active_lnp)
    return new_pos, new_lnp, accept.astype(np.int64)


def test_stretch_update_with_injected_draws():
    rng = np.random.RandomState(31)
    k, m, dim = 12, 12, 3
    active, comp = rng.randn(k, dim), rng.randn(m, dim)

    def lnpost_np(x):
        out = -0.5 * np.sum(x * x, axis=1)
        out[0] = -np.inf  # a rejected proposal stays rejected
        return out

    active_lnp = lnpost_np(active)
    active_lnp[0] = 0.0
    u, u_acc = rng.rand(k), rng.rand(k)
    partner = rng.randint(0, m, k)
    want = _numpy_stretch(active, active_lnp, comp, lnpost_np, 2.0, dim, u,
                          partner, u_acc)
    got = tens.stretch_update(
        torch.as_tensor(active), torch.as_tensor(active_lnp),
        torch.as_tensor(comp), lambda x: torch.as_tensor(lnpost_np(x.numpy())),
        2.0, dim, torch.as_tensor(u), torch.as_tensor(partner),
        torch.as_tensor(u_acc),
    )
    # float64, same operations in the same order: rtol 1e-14
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14)
    assert 0 < got[2].sum() < k and got[2][0] == 0


def test_welford_batch_update_matches_jax():
    rng = np.random.RandomState(32)
    dim = 5
    # the port keeps n on the device, as the JAX package does
    t_m = {"mean": torch.zeros(dim, dtype=torch.float64),
           "m2": torch.zeros(dim, dtype=torch.float64),
           "n": torch.zeros((), dtype=torch.int64)}
    j_m = {"mean": jnp.zeros(dim), "m2": jnp.zeros(dim), "n": jnp.int32(0)}
    batches = [rng.randn(8, dim) * 3 + 10 for _ in range(4)]
    for b in batches:
        t_m = tens.welford_batch_update(t_m, torch.as_tensor(b))
        j_m = jens.welford_batch_update(j_m, jnp.asarray(b))
    # float64: rtol 1e-12; and both equal the direct two-pass moments
    np.testing.assert_allclose(t_m["mean"].numpy(), np.asarray(j_m["mean"]),
                               rtol=1e-12)
    np.testing.assert_allclose(t_m["m2"].numpy(), np.asarray(j_m["m2"]),
                               rtol=1e-12)
    allb = np.concatenate(batches)
    np.testing.assert_allclose(t_m["m2"].numpy() / (int(t_m["n"]) - 1),
                               allb.var(axis=0, ddof=1), rtol=1e-12)
    assert int(t_m["n"]) == int(j_m["n"]) == 32


def test_merge_image_accumulators_matches_jax():
    rng = np.random.RandomState(33)
    keys = ("raw", "conv", "var", "ps_conv")
    t_acc = {k: torch.zeros((4, 5), dtype=torch.float64) for k in keys}
    t_acc["raw_m2"] = torch.zeros((4, 5), dtype=torch.float64)
    j_acc = {k: jnp.zeros((4, 5)) for k in t_acc}
    t_n, j_n = torch.zeros((), dtype=torch.int64), jnp.int32(0)  # on the device
    for _ in range(3):
        means = {k: rng.rand(4, 5) for k in t_acc}
        t_acc, t_n = tens.merge_image_accumulators(
            t_acc, t_n, {k: torch.as_tensor(v) for k, v in means.items()}, 6)
        j_acc, j_n = jens.merge_image_accumulators(
            j_acc, j_n, {k: jnp.asarray(v) for k, v in means.items()}, 6)
    for k in t_acc:
        # float64: rtol 1e-12
        np.testing.assert_allclose(t_acc[k].numpy(), np.asarray(j_acc[k]),
                                   rtol=1e-12, err_msg=k)
    assert int(t_n) == int(j_n) == 18


class _Gaussian2D:
    """A correlated 2-D Gaussian target with the posterior interface."""

    device = torch.device("cpu")
    dtype = torch.float64
    mean = np.array([1.0, -2.0])
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])

    def __init__(self):
        self._prec = torch.as_tensor(np.linalg.inv(self.cov))
        self._mu = torch.as_tensor(self.mean)

    def log_posterior_batch(self, x):
        d = x - self._mu
        return -0.5 * torch.einsum("bi,ij,bj->b", d, self._prec, d)


def test_sampler_recovers_a_correlated_gaussian():
    target = _Gaussian2D()
    rng = np.random.RandomState(34)
    s = EnsembleSampler(32, 2, target, seed=5, device="cpu", track_moments=True)
    s.init_state(rng.randn(32, 2) * 0.1)
    s.run_burn(300)
    s.reset()
    s.run_sampling(1500)
    flat = s.flatchain
    assert s.chain.shape == (32, 1500, 2)
    assert s.lnprobability.shape == (32, 1500)
    # 48k correlated draws (autocorrelation ~tens of steps): the mean
    # within 0.1 and each covariance entry within 0.15 of the truth
    np.testing.assert_allclose(flat.mean(axis=0), target.mean, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), target.cov, atol=0.15)
    acc = s.acceptance_fraction
    assert acc.shape == (32,) and 0.3 < acc.mean() < 0.9
    # float64 device moments over every retained step = the chain's
    mean, std = s.posterior_moments
    np.testing.assert_allclose(mean, flat.mean(axis=0), rtol=1e-10)
    np.testing.assert_allclose(std, flat.std(axis=0, ddof=1), rtol=1e-10)
    assert s.accumulated_images is None  # the target renders no images


def test_sampler_same_seed_same_chain():
    target = _Gaussian2D()
    p0 = np.random.RandomState(35).randn(8, 2)
    chains = []
    for _ in range(2):
        s = EnsembleSampler(8, 2, target, seed=11, device="cpu")
        s.init_state(p0)
        s.run_sampling(20)
        chains.append(s.chain)
    np.testing.assert_array_equal(chains[0], chains[1])


def test_flagship_sampler_accumulates_images():
    spec = build_model_spec(flagship_components((32, 32), (16, 16)))
    fns = build_posterior(spec, device="cpu", dtype=torch.float32)
    nw = 40
    s = EnsembleSampler(nw, spec.num_params, fns, seed=0, device="cpu")
    s.init_state(prior_draws(spec, nw, seed=0))
    s.run_burn(5)
    s.reset()
    assert s.accumulated_samples == 0
    s.run_sampling(4)
    assert s.chain.shape == (nw, 4, spec.num_params)
    assert np.all(np.isfinite(s.lnprobability))
    imgs = s.accumulated_images
    assert sorted(imgs) == ["conv", "ps_conv", "raw", "raw_m2", "var"]
    assert s.accumulated_samples == 4 * nw
    # the last retained step's ensemble, merged after three earlier
    # ones: the running mean equals the mean of the four per-step means
    assert all(np.all(np.isfinite(v)) for v in imgs.values())
    final = fns.ensemble_carry_means(torch.as_tensor(s.chain[:, -1]))
    assert imgs["raw"].shape == tuple(final["raw"].shape) == (32, 32)
    step_means = [fns.ensemble_carry_means(torch.as_tensor(s.chain[:, i]))
                  for i in range(4)]
    for k in ("raw", "conv", "var", "ps_conv"):
        want = np.mean([m[k].numpy() for m in step_means], axis=0)
        # float32 running mean of 4 batches: 1e-5 of the image's peak
        np.testing.assert_allclose(imgs[k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    assert math.isfinite(float(s.acceptance_fraction.mean()))


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    spec = build_model_spec(flagship_components((16, 16), (8, 8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_posterior(spec)
    fns = build_posterior(spec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        EnsembleSampler(40, spec.num_params, fns)


def test_sampler_rejects_odd_walkers_and_device_mismatch():
    target = _Gaussian2D()
    with pytest.raises(ValueError, match="even"):
        EnsembleSampler(7, 2, target, device="cpu")
    with pytest.raises(ValueError, match="p0 must be"):
        EnsembleSampler(8, 2, target, device="cpu").init_state(np.zeros((6, 2)))
