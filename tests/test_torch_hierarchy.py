"""The port's hierarchical fit against the JAX package's, on the CPU.

Both packages build the same templates from the same numpy arrays, in
float64: the sky-only model at 12x12 (``_hierarchy_helpers``), a point
source with two PSFs (the general path), a point source with a PSF star
per target (survey mode, conv_lnl with per-target spectra), a sky with a
tilt governed by a regression on its level (the general path), and the
two-band joint sky model.  The JAX package's own posterior bundle,
transform and start pool are taken from its ``fit_hierarchical`` (its
sampler class replaced by one that keeps them and stops), and each case
is held to it:

* every population's density, ``reconstruct`` and ``eta_logp``: 1e-12;
* the joint lnpost of ``(C, K*d + h)`` rows, centered and non-centered:
  1e-10; its gradient in z through ``_HierTransform``: 1e-8;
* NUTS transitions on the hierarchical potential on JAX's own draws
  (``test_torch_nuts._transition_pair``): 1e-10;
* the start rows and the best-of-pool start, the Gibbs-sampled PSF
  indices, ``target_loglike`` (1e-10), ``loo_targets``' ELPD (1e-8),
  ``predict_population`` (equal), a result saved by either package and
  read by the other;
* every refusal of the JAX package's validation tests, same type and
  message;
* a port ``fit_hierarchical`` whose NUTS and ensemble fits agree within
  ``test_hierarchy.py::test_ensemble_and_nuts_agree``'s bar, and short
  fits in every mode (multi-PSF, joint, survey, regression; both
  samplers, both parametrizations);
* ``chip_smoke.py``'s hierarchy phase, rehearsed at 32x32.

Each test runs torch on one thread.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu import hierarchy as JH
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.joint import JointModel as JaxJoint
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch import hierarchy as TH
from psfmc_tpu_torch.models import JointModel, MultiComponentModel
from psfmc_tpu_torch.models import components as TC
from test_torch_nuts import _assert_transition, _torch_vg, _transition_pair

PACKAGES = {"torch": (TC, TD, TH), "jax": (JC, JD, JH)}
RTOL = 1e-10
GRAD_RTOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the templates, built alike in both packages ------------------------------
def _config(C, hw, noise, psfs):
    many = isinstance(psfs, list)
    return C.Configuration(
        obs_file=np.zeros((hw, hw)),
        obsivm_file=np.full((hw, hw), 1.0 / noise**2),
        psf_files=psfs,
        psfivm_files=[np.full_like(p, 1e12) for p in psfs] if many
        else np.full_like(psfs, 1e12),
        mag_zeropoint=25.0,
    )


def _delta():
    p = np.zeros((8, 8))
    p[4, 4] = 1.0
    return p


def _gauss(hw, sigma):
    yy, xx = np.mgrid[:hw, :hw] - (hw - 1) / 2.0
    p = np.exp(-(xx**2 + yy**2) / (2 * sigma**2))
    return p / p.sum()


def _model(package, comps):
    if package == "torch":
        return MultiComponentModel(comps, device="cpu", dtype=torch.float64)
    return JaxModel(comps, dtype=jnp.float64)


def sky_model(package, hw=12, noise=0.5, tilt=False):
    C, D, _ = PACKAGES[package]
    kw = dict(dx=D.Uniform(loc=-1.0, scale=2.0)) if tilt else {}
    return _model(package, [_config(C, hw, noise, _delta()),
                            C.Sky(adu=D.Uniform(loc=-2.0, scale=6.0), **kw)])


def ps_model(package, hw=16, noise=0.05, sigmas=(1.5,)):
    """A point source (and a sky with two PSFs, as test_hierarchy's)."""
    C, D, _ = PACKAGES[package]
    psfs = [_gauss(hw, s) for s in sigmas]
    comps = [_config(C, hw, noise, psfs if len(psfs) > 1 else psfs[0])]
    if len(psfs) > 1:
        comps.append(C.Sky(adu=D.Normal(loc=0.0, scale=0.05)))
    comps.append(C.PointSource(xy=D.Uniform(loc=(6.0, 6.0), scale=(4.0, 4.0)),
                               mag=D.Uniform(loc=19.5, scale=2.5)))
    return _model(package, comps)


def joint_model(package, hw_a=12, hw_b=8, noise=0.4, npsf_b=1):
    C, D, _ = PACKAGES[package]
    psfs_b = [_delta()]
    if npsf_b > 1:
        blur = np.zeros((8, 8))
        blur[3:6, 3:6] = 1 / 9.0
        psfs_b.append(blur)
    bands = [[_config(C, hw_a, noise, _delta()), C.Sky(adu=D.Uniform(loc=-2.0, scale=6.0))],
             [_config(C, hw_b, noise, psfs_b if npsf_b > 1 else psfs_b[0]),
              C.Sky(adu=D.Uniform(loc=-2.0, scale=6.0))]]
    if package == "torch":
        return JointModel(bands, device="cpu", dtype=torch.float64)
    return JaxJoint(bands, dtype=jnp.float64)


def normal_pop(package, lo=-1.0, width=3.0, slo=0.01, swidth=0.6):
    _, D, H = PACKAGES[package]
    return H.NormalPopulation(mu=D.Uniform(loc=lo, scale=width),
                              sigma=D.Uniform(loc=slo, scale=swidth))


def regression_pop(package):
    _, D, H = PACKAGES[package]
    return H.RegressionPopulation(covariate="0_Sky_adu",
                                  alpha=D.Uniform(loc=-0.5, scale=1.0),
                                  beta=D.Uniform(loc=-1.0, scale=2.0),
                                  sigma=D.Uniform(loc=0.001, scale=0.3), x0=0.5)


def psf_stars(k, hw=16, seed=3):
    rng = np.random.RandomState(seed)
    stars = [_gauss(hw, s) for s in rng.uniform(1.3, 2.2, k)]
    return stars, [np.full((hw, hw), 1e12)] * k


def _sky_data(k, hw, noise, seed, tilt=False):
    rng = np.random.RandomState(seed)
    adus = 0.3 + 0.08 * rng.randn(k)
    obs = adus[:, None, None] + rng.randn(k, hw, hw) * noise
    if tilt:
        xg = np.arange(hw) - (hw - 1) / 2.0
        obs = obs + (0.02 + 0.05 * (adus - 0.5))[:, None, None] * xg
    return obs, np.full((k, hw, hw), 1.0 / noise**2)


def _ps_data(k, hw, noise, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:hw, :hw] - (hw - 1) / 2.0
    obs = 10.0 ** (-0.4 * (20.5 - 25.0)) * np.exp(-(xx**2 + yy**2) / 4.5)[None] / 14.1
    obs = obs + rng.randn(k, hw, hw) * noise
    return obs, np.full((k, hw, hw), 1.0 / noise**2)


# each case: (template builder, population builder on its name, data, fit keywords)
CASES = {
    "sky": (sky_model, {"0_Sky_adu": normal_pop}, lambda: _sky_data(3, 12, 0.5, 1), {}),
    "regression": (lambda p: sky_model(p, tilt=True),
                   {"0_Sky_adu": normal_pop, "0_Sky_dx": regression_pop},
                   lambda: _sky_data(3, 12, 0.5, 2, tilt=True), {}),
    "multipsf": (lambda p: ps_model(p, sigmas=(1.5, 1.8)),
                 {"1_PointSource_mag": lambda p: normal_pop(p, 19.5, 2.5, 0.02, 1.5)},
                 lambda: _ps_data(3, 16, 0.05, 3), {}),
    "survey": (ps_model, {"0_PointSource_mag": lambda p: normal_pop(p, 19.5, 2.5, 0.02, 1.5)},
               lambda: _ps_data(3, 16, 0.05, 4), "survey"),
    "joint": (lambda p: joint_model(p, npsf_b=2), {"0_Sky_adu": normal_pop},
              lambda: tuple([a, b] for a, b in zip(_sky_data(3, 12, 0.4, 5),
                                                   _sky_data(3, 8, 0.4, 6))), {}),
}


class _Captured(Exception):
    pass


def jax_setup(monkeypatch, case, parametrization="centered", seed=0, chains=2,
              init_pool=4):
    """The JAX package's own posterior bundle, transform and start pool
    from its ``fit_hierarchical``: its NUTS sampler replaced by one that
    keeps them and stops."""
    import psfmc_tpu.sampler.nuts as jnuts

    build, pops, data, kw = CASES[case]
    obs, ivm = data()
    kw = dict(psf_stack=psf_stars(3)[0], psfivm_stack=psf_stars(3)[1]) if kw else {}
    kept = {}

    class Keep:
        def __init__(self, nchains, dim, hier, seed=0, max_depth=8, transform=None,
                     sharding=None):
            kept.update(hier=hier, transform=transform, dim=dim)

        def init_state(self, p0):
            kept["pool"] = np.asarray(p0)
            raise _Captured

    monkeypatch.setattr(jnuts, "NUTSSampler", Keep)
    model = build("jax")
    with pytest.raises(_Captured):
        JH.fit_hierarchical(model, obs, ivm, {n: f("jax") for n, f in pops.items()},
                            chains=chains, init_pool=init_pool, seed=seed,
                            parametrization=parametrization, **kw)
    kept.update(model=model, obs=obs, ivm=ivm, kw=kw)
    return kept


def torch_setup(case, parametrization="centered"):
    build, pops, data, kw = CASES[case]
    obs, ivm = data()
    kw = dict(psf_stack=psf_stars(3)[0], psfivm_stack=psf_stars(3)[1]) if kw else {}
    model = build("torch")
    setup = TH._setup(model, obs, ivm, {n: f("torch") for n, f in pops.items()},
                      parametrization=parametrization, **kw)
    return setup, obs, ivm, kw


def _jax_lnpost(hier):
    return jax.jit(jax.vmap(hier.log_posterior))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=0)


# -- the populations ---------------------------------------------------------------
FAMILIES = ("normal", "lognormal", "student", "regression")


def _family(package, name):
    _, D, H = PACKAGES[package]
    u = D.Uniform(loc=0.0, scale=1.0)
    if name == "normal":
        return H.NormalPopulation(mu=u, sigma=u)
    if name == "lognormal":
        return H.LogNormalPopulation(mu=u, sigma=u)
    if name == "student":
        return H.StudentTPopulation(mu=u, sigma=u, df=3.5)
    return H.RegressionPopulation(covariate="c", alpha=u, beta=u, sigma=u, x0=0.7)


@pytest.mark.parametrize("name", FAMILIES)
def test_population_densities_match_jax(name):
    """``torch_logp`` (the JAX package's ``jax_logp``), ``reconstruct`` and
    ``eta_logp`` on the same values: 1e-12, -inf alike (sigma <= 0, and a
    non-positive value under the log-normal)."""
    rng = np.random.RandomState(FAMILIES.index(name))
    tp, jp = _family("torch", name), _family("jax", name)
    x = rng.uniform(0.1, 3.0, 6)
    cov = rng.randn(6)
    extra = (cov,) if name == "regression" else ()
    nh = len(tp.hyper_names)
    for phi in (rng.uniform(0.2, 1.5, nh), np.r_[rng.uniform(0.2, 1.5, nh - 1), -0.3],
                rng.uniform(0.2, 1.5, nh)):
        for xs in (x, np.r_[x[:-1], -x[-1]]):
            got = tp.torch_logp(torch.as_tensor(xs), torch.as_tensor(phi),
                                *map(torch.as_tensor, extra))
            want = jp.jax_logp(jnp.asarray(xs), jnp.asarray(phi), *map(jnp.asarray, extra))
            _close(got.numpy()[None], np.asarray(want)[None], 1e-12)
        # batched as the posterior calls it: phi as (C, 1) columns, x (C, K)
        cols = tuple(torch.as_tensor(np.full((2, 1), v)) for v in phi)
        got = tp.torch_logp(torch.as_tensor(np.stack([x, x])), cols,
                            *(torch.as_tensor(np.stack([cov, cov])) for _ in extra))
        _close(got.numpy(), np.full(2, float(jp.jax_logp(jnp.asarray(x), jnp.asarray(phi),
                                                         *map(jnp.asarray, extra)))), 1e-12)
        eta = rng.randn(6)
        np.testing.assert_allclose(
            tp.reconstruct(torch.as_tensor(eta), torch.as_tensor(phi),
                           *map(torch.as_tensor, extra)).numpy(),
            np.asarray(jp.reconstruct(jnp.asarray(eta), jnp.asarray(phi),
                                      *map(jnp.asarray, extra))), rtol=1e-12)
        np.testing.assert_allclose(float(tp.eta_logp(torch.as_tensor(eta))),
                                   float(jp.eta_logp(jnp.asarray(eta))), rtol=1e-12)
    a, b = (np.random.RandomState(5) for _ in range(2))
    np.testing.assert_array_equal(tp.eta_random(a, (3, 4)), jp.eta_random(b, (3, 4)))


# -- the joint posterior, its start and its gradient ---------------------------------
LNPOST_CASES = [("sky", "centered"), ("sky", "noncentered"), ("regression", "centered"),
                ("regression", "noncentered"), ("multipsf", "centered"),
                ("survey", "centered"), ("joint", "centered"), ("joint", "noncentered")]


@pytest.mark.parametrize("case,parametrization", LNPOST_CASES)
def test_joint_lnpost_and_gradient_match_jax(monkeypatch, case, parametrization):
    """The start pool (the same rows from the same RandomState), the joint
    lnpost of its ``(C, K*d + h)`` rows and of rows moved off them (1e-10,
    -inf alike), and the potential's gradient in z through the transforms
    (1e-8) against the JAX package's."""
    jx = jax_setup(monkeypatch, case, parametrization)
    setup, *_ = torch_setup(case, parametrization)
    pool = setup.draw(8, np.random.RandomState(0))
    np.testing.assert_array_equal(pool, jx["pool"])
    rng = np.random.RandomState(7)
    rows = np.concatenate([pool, pool + 0.02 * rng.randn(*pool.shape)])
    for col, _ in setup.hier.psf_margs:  # the inert index columns stay at 0
        rows[:, [t * setup.d + col for t in range(setup.k)]] = 0.0
    got = setup.hier.log_posterior_batch(torch.as_tensor(rows)).numpy()
    want = np.asarray(_jax_lnpost(jx["hier"])(jnp.asarray(rows)))
    _close(got, want, RTOL)
    assert np.isfinite(want).sum() >= 4

    # the potential and its gradient in z
    ttr, jtr = setup.transform(), jx["transform"]
    assert ttr.num_unconstrained == jtr.num_unconstrained
    finite = rows[np.isfinite(want)][:6]
    z = ttr.to_unconstrained(finite)
    np.testing.assert_allclose(z, jtr.to_unconstrained(finite), rtol=1e-12, atol=1e-12)

    def jax_u(zz):
        th, ld = jtr.to_constrained(zz)
        return -(jx["hier"].log_posterior(th) + ld)

    ju, jg = jax.jit(jax.vmap(jax.value_and_grad(jax_u)))(jnp.asarray(z))

    def torch_u(zz):
        th, ld = ttr.to_constrained(zz)
        return -(setup.hier.differentiable_log_posterior(th) + ld)

    tu, tg = _torch_vg(torch_u)(torch.as_tensor(z))
    _close(tu.numpy(), np.asarray(ju), RTOL)
    tg, jg = tg.numpy(), np.asarray(jg)
    err = np.linalg.norm(tg - jg, axis=1) / np.linalg.norm(jg, axis=1)
    assert err.max() <= GRAD_RTOL, err


@pytest.mark.parametrize("case,parametrization,depth", [("sky", "centered", 3),
                                                         ("sky", "noncentered", 3),
                                                         ("survey", "centered", 2)])
def test_nuts_transition_matches_jax(monkeypatch, case, parametrization, depth):
    """One NUTS transition of every chain on the hierarchical potential, the
    JAX package's ``nuts_kernel`` and the port's pieces on the same draws:
    the tree's decisions exact, z, u, the gradient and the accept statistic
    to 1e-10."""
    jx = jax_setup(monkeypatch, case, parametrization)
    setup, *_ = torch_setup(case, parametrization)
    ttr, jtr = setup.transform(), jx["transform"]
    z0 = ttr.to_unconstrained(jx["pool"][:4])

    def jax_u(zz):
        th, ld = jtr.to_constrained(zz)
        return -(jx["hier"].log_posterior(th) + ld)

    def torch_u(zz):
        th, ld = ttr.to_constrained(zz)
        return -(setup.hier.differentiable_log_posterior(th) + ld)

    jvg = jax.value_and_grad(jax_u)
    got, want = _transition_pair(jax_u, _torch_vg(torch_u), z0, 0.05,
                                 np.ones(z0.shape[1]), depth, seed=depth, jax_vg=jvg,
                                 batched_vg=jax.jit(jax.vmap(jvg)))
    _assert_transition(got, want, 1e-10)


def test_best_of_pool_start_matches_jax(monkeypatch):
    """The NUTS start: the best ``chains`` rows of the pool by lnpost, in
    z, as the JAX package ranks them."""
    from psfmc_tpu_torch.sampler.nuts import NUTSSampler

    jx = jax_setup(monkeypatch, "sky", chains=3, init_pool=5)
    setup, *_ = torch_setup("sky")
    pool = setup.draw(15, np.random.RandomState(0))
    np.testing.assert_array_equal(pool, jx["pool"])
    lnp = np.asarray(_jax_lnpost(jx["hier"])(jnp.asarray(pool)))
    best = pool[np.argsort(np.where(np.isfinite(lnp), lnp, -np.inf))[::-1][:3]]
    sm = NUTSSampler(3, setup.hier.spec.num_params, setup.hier, transform=setup.transform(),
                     device="cpu")
    sm.init_state(pool)
    np.testing.assert_allclose(sm.state.z.numpy(), jx["transform"].to_unconstrained(best),
                               rtol=1e-12, atol=1e-12)


def test_gibbs_indices_match_jax(monkeypatch):
    """The reported chain's PSF indices: the same Gumbel-max draws from the
    same RandomState on the same per-target lnLs."""
    jx = jax_setup(monkeypatch, "multipsf")
    setup, *_ = torch_setup("multipsf")
    per = jx["pool"][:, : setup.k * setup.d].reshape(-1, setup.k, setup.d)
    per = np.concatenate([per, per + 0.01])
    got = setup.hier.gibbs_psf_indices(per, seed=3, chunk=5)
    want = jx["hier"].gibbs_psf_indices(per, seed=3, chunk=5)
    assert got.keys() == want.keys()
    for col in got:
        np.testing.assert_array_equal(got[col], want[col])
        assert set(np.unique(got[col])) <= {0.0, 1.0}


# -- the replay, LOO and the population predictive ----------------------------------
@pytest.mark.parametrize("case", ["sky", "multipsf", "survey", "joint"])
def test_target_loglike_and_loo_match_jax(monkeypatch, case):
    """``target_loglike`` of the same draws (1e-10; the mixture weight of a
    sampled PSF index included) and ``loo_targets``' ELPD (1e-8)."""
    jx = jax_setup(monkeypatch, case)
    setup, obs, ivm, kw = torch_setup(case)
    rng = np.random.RandomState(11)
    pool = jx["pool"]
    draws = np.concatenate([pool + 0.01 * rng.randn(*pool.shape) for _ in range(3)])
    draws = np.repeat(draws, 2, axis=0)
    got = TH.target_loglike(setup.model, obs, ivm, draws, chunk=7, **kw)
    want = JH.target_loglike(jx["model"], jx["obs"], jx["ivm"], draws, chunk=7, **jx["kw"])
    assert got.shape == (len(draws), setup.k)
    _close(got, want, RTOL)
    tl = TH.loo_targets(setup.model, obs, ivm, draws, **kw)
    jl = JH.loo_targets(jx["model"], jx["obs"], jx["ivm"], draws, **jx["kw"])
    assert tl.kind == jl.kind == "loo-target" and tl.n_points == setup.k
    np.testing.assert_allclose(tl.elpd, jl.elpd, rtol=1e-8)
    np.testing.assert_allclose(tl.elpd_i, jl.elpd_i, rtol=1e-8)


def _results(flat, lnp=None, k=2, pops=None, bounds=None):
    """The same HierarchicalResult in both packages."""
    out = {}
    for package in ("torch", "jax"):
        _, D, H = PACKAGES[package]
        populations = None if pops is None else {n: f(package) for n, f in pops.items()}
        out[package] = H.HierarchicalResult(
            param_names=["0_Sky_adu", "0_Sky_dx"],
            hyper_names=["0_Sky_adu:mu", "0_Sky_adu:sigma", "0_Sky_dx:alpha",
                         "0_Sky_dx:beta", "0_Sky_dx:sigma"],
            num_targets=k,
            target_mean=flat[:, : k * 2].reshape(-1, k, 2).mean(0),
            target_std=flat[:, : k * 2].reshape(-1, k, 2).std(0),
            hyper_chain=flat[:, k * 2:], governed=["0_Sky_adu", "0_Sky_dx"],
            diagnostics={"divergences": 2.0, "mean_accept": 0.75},
            flatchain=flat, lnp=lnp, populations=populations, governed_bounds=bounds)
    return out


def _student(package):
    _, D, H = PACKAGES[package]
    return H.StudentTPopulation(mu=D.Normal(loc=0.0, scale=1.0),
                                sigma=D.Uniform(loc=0.0, scale=1.0), df=7.5)


POPS = {"0_Sky_adu": _student, "0_Sky_dx": regression_pop}


def test_predict_population_matches_jax():
    """The predictive draws of both packages from the same hyper chain and
    seed, with a truncation and a covariate, are equal; the log-normal's
    too."""
    rng = np.random.RandomState(0)
    flat = np.c_[rng.randn(64, 4), 0.3 + 0.1 * rng.randn(64), 0.2 + 0.05 * rng.rand(64),
                 0.1 * rng.randn(64), 0.5 + 0.1 * rng.randn(64), 0.1 + 0.05 * rng.rand(64)]
    res = _results(flat, pops=POPS, bounds={"0_Sky_adu": (0.1, 4.0),
                                            "0_Sky_dx": (-np.inf, np.inf)})
    got = res["torch"].predict_population(n=300, seed=5, covariates={"0_Sky_dx": 0.4})
    want = res["jax"].predict_population(n=300, seed=5, covariates={"0_Sky_dx": 0.4})
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    for package in res:
        _, D, H = PACKAGES[package]
        res[package].populations["0_Sky_adu"] = H.LogNormalPopulation(
            mu=D.Uniform(loc=0, scale=1), sigma=D.Uniform(loc=0, scale=1))
    got = res["torch"].predict_population(n=100, seed=2, covariates={"0_Sky_dx": 0.1})
    want = res["jax"].predict_population(n=100, seed=2, covariates={"0_Sky_dx": 0.1})
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-14)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_save_load_round_trip_across_packages(tmp_path, writer):
    """A result one package saves, the other loads: the flat chain, lnp,
    governed names, cards, populations' static specs and bounds, and the
    loaded result predicts as the written one."""
    rng = np.random.RandomState(1)
    flat = np.c_[rng.randn(32, 4), 0.3 + 0.1 * rng.randn(32), 0.2 + 0.05 * rng.rand(32),
                 0.1 * rng.randn(32), 0.5 + 0.1 * rng.randn(32), 0.1 + 0.05 * rng.rand(32)]
    res = _results(flat, lnp=-rng.rand(32), pops=POPS,
                   bounds={"0_Sky_adu": (-2.0, 4.0), "0_Sky_dx": (-np.inf, np.inf)})
    reader = "jax" if writer == "torch" else "torch"
    path = str(tmp_path / "hier.fits")
    res[writer].save(path)
    back = PACKAGES[reader][2].load_hierarchical_result(path)
    mine = PACKAGES[writer][2].load_hierarchical_result(path)
    for loaded in (back, mine):
        np.testing.assert_array_equal(loaded.flatchain, flat)
        np.testing.assert_array_equal(loaded.lnp, res[writer].lnp)
        assert loaded.governed == ["0_Sky_adu", "0_Sky_dx"]
        assert loaded.param_names == res[writer].param_names
        assert loaded.hyper_names == res[writer].hyper_names
        assert loaded.diagnostics == {"divergences": 2.0, "mean_accept": 0.75}
        assert loaded.governed_bounds == {"0_Sky_adu": (-2.0, 4.0),
                                          "0_Sky_dx": (-np.inf, np.inf)}
        st, rg = loaded.populations["0_Sky_adu"], loaded.populations["0_Sky_dx"]
        assert (type(st).__name__, st.df) == ("StudentTPopulation", 7.5)
        assert (type(rg).__name__, rg.covariate, rg.x0) == ("RegressionPopulation",
                                                             "0_Sky_adu", 0.5)
    a = back.predict_population(n=50, seed=4, covariates={"0_Sky_dx": 0.2})
    b = mine.predict_population(n=50, seed=4, covariates={"0_Sky_dx": 0.2})
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])


# -- the validation surface ----------------------------------------------------------
def _same_refusal(call):
    """``call(package)`` raises the same type and message in both packages."""
    errors = {}
    for package in ("torch", "jax"):
        with pytest.raises(Exception) as info:
            call(package)
        errors[package] = (type(info.value).__name__, str(info.value))
    assert errors["torch"] == errors["jax"], errors


def _fit(package, model, obs, ivm, population, **kw):
    kw.setdefault("sampler", "ensemble")
    kw.setdefault("burn", 2)
    kw.setdefault("iterations", 2)
    if package == "torch":
        kw["device"] = "cpu"
    return PACKAGES[package][2].fit_hierarchical(model, obs, ivm, population, **kw)


def _sersic_model(package):
    C, D, _ = PACKAGES[package]
    return _model(package, [
        _config(C, 16, 0.05, _gauss(16, 1.5)),
        C.Sersic(xy=D.Uniform(loc=(6.0, 6.0), scale=(4.0, 4.0)),
                 mag=D.Uniform(loc=19.0, scale=3.0), reff=D.Uniform(loc=1.0, scale=6.0),
                 reff_b=D.Uniform(loc=0.5, scale=6.0), index=D.Uniform(loc=0.5, scale=5.0),
                 angle=D.Uniform(loc=0.0, scale=180.0))])


def _centered_only(package):
    """A family with a centered density and no non-centered form (the
    same class name in both packages)."""
    _, D, _ = PACKAGES[package]
    dists = (D.Uniform(loc=0.0, scale=1.0), D.Uniform(loc=0.01, scale=0.5))
    logp = "torch_logp" if package == "torch" else "jax_logp"
    return type("_CenteredOnly", (), {"hyper_names": ("mu", "sigma"), "hyper_dists": dists,
                                      logp: lambda self, x, phi: None})()


REFUSALS = {
    # test_validation_errors
    "unknown parameter": lambda p, m, o, i: _fit(p, m, o, i, {"nope": normal_pop(p)}),
    "no population": lambda p, m, o, i: _fit(p, m, o, i, {}),
    "not a prior": lambda p, m, o, i: PACKAGES[p][2].NormalPopulation(
        mu=1.0, sigma=normal_pop(p).sigma),
    "vector slot": lambda p, m, o, i: _fit(p, ps_model(p), np.zeros((3, 16, 16)),
                                           np.full((3, 16, 16), 400.0),
                                           {"0_PointSource_xy": normal_pop(p)}),
    # test_noncentered_validation
    "parametrization": lambda p, m, o, i: _fit(p, m, o, i, {"0_Sky_adu": normal_pop(p)},
                                               parametrization="typo"),
    "negative scale": lambda p, m, o, i: _fit(
        p, m, o, i, {"0_Sky_adu": normal_pop(p, 0.0, 1.0, -0.2, 0.7)},
        parametrization="noncentered"),
    "no non-centered form": lambda p, m, o, i: _fit(
        p, m, o, i, {"0_Sky_adu": _centered_only(p)},
        parametrization="noncentered"),
    "axis pair": lambda p, m, o, i: _fit(
        p, _sersic_model(p), np.zeros((3, 16, 16)), np.full((3, 16, 16), 400.0),
        {"0_Sersic_reff": normal_pop(p, 1.0, 5.0, 0.01, 1.0)},
        sampler="nuts", parametrization="noncentered"),
    # the samplers and shards
    "unknown sampler": lambda p, m, o, i: _fit(p, m, o, i, {"0_Sky_adu": normal_pop(p)},
                                               sampler="hmc"),
    "unknown shard": lambda p, m, o, i: _fit(p, m, o, i, {"0_Sky_adu": normal_pop(p)},
                                             shard="pixels"),
    # test_per_target_psf_validation
    "psf stacks together": lambda p, m, o, i: _fit(
        p, ps_model(p, 12, 0.5, (1.4,)), o, np.full((3, 12, 12), 4.0),
        {"0_PointSource_mag": normal_pop(p, 19.5, 2.5, 0.02, 1.5)},
        psf_stack=[_gauss(12, 1.4)] * 3),
    "psf target count": lambda p, m, o, i: _fit(
        p, ps_model(p, 12, 0.5, (1.4,)), o, np.full((3, 12, 12), 4.0),
        {"0_PointSource_mag": normal_pop(p, 19.5, 2.5, 0.02, 1.5)},
        psf_stack=[_gauss(12, 1.4)] * 2, psfivm_stack=[np.full((12, 12), 1e12)] * 2),
    # test_regression_validation
    "unknown covariate": lambda p, m, o, i: _fit(
        p, sky_model(p, tilt=True), o, i,
        {"0_Sky_dx": _regression(p, "0_Sky_nope")}),
    "own covariate": lambda p, m, o, i: _fit(
        p, sky_model(p, tilt=True), o, i, {"0_Sky_dx": _regression(p, "0_Sky_dx")}),
    "covariate first": lambda p, m, o, i: _fit(
        p, sky_model(p, tilt=True), o, i,
        {"0_Sky_dx": _regression(p, "0_Sky_adu"),
         "0_Sky_adu": normal_pop(p, -1.0, 3.0, 0.01, 2.0)}),
    "covariate name": lambda p, m, o, i: _regression(p, 3),
    "regression prior": lambda p, m, o, i: PACKAGES[p][2].RegressionPopulation(
        covariate="0_Sky_adu", alpha=1.0, beta=PACKAGES[p][1].Uniform(loc=0, scale=1),
        sigma=PACKAGES[p][1].Uniform(loc=0, scale=1)),
}


def _regression(package, covariate):
    _, D, H = PACKAGES[package]
    return H.RegressionPopulation(covariate=covariate, alpha=D.Uniform(loc=-0.5, scale=1.0),
                                  beta=D.Uniform(loc=-1.0, scale=2.0),
                                  sigma=D.Uniform(loc=0.001, scale=0.3))


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_validation_matches_jax(name):
    """Each refusal of ``test_hierarchy.py``'s validation tests (and the
    sampler and shard names), the same exception type and message."""
    obs, ivm = _sky_data(3, 12, 0.5, 9)
    _same_refusal(lambda p: REFUSALS[name](p, sky_model(p), obs, ivm))


def test_placeholder_families_and_the_mesh_are_refused():
    """A family loaded from a saved result is predict-only (the JAX
    package's message); a ``mesh=`` that is not a ``WalkerMesh`` raises a
    ``TypeError`` naming the type it takes; ``shard='targets'`` without a
    mesh runs the fit ``'chains'`` runs, as in the JAX package."""
    obs, ivm = _sky_data(3, 12, 0.5, 9)
    loaded = {"0_Sky_adu": TH._pop_from_spec("NormalPopulation", {})}
    jloaded = {"0_Sky_adu": JH._pop_from_spec("NormalPopulation", {})}
    _same_refusal(lambda p: _fit(p, sky_model(p), obs, ivm,
                                 loaded if p == "torch" else jloaded))
    with pytest.raises(TypeError, match="mesh must be a psfmc_tpu_torch.parallel.WalkerMesh"):
        _fit("torch", sky_model("torch"), obs, ivm, {"0_Sky_adu": normal_pop("torch")},
             mesh=object())
    fits = [_fit("torch", sky_model("torch"), obs, ivm, {"0_Sky_adu": normal_pop("torch")},
                 shard=shard) for shard in ("targets", "chains")]
    np.testing.assert_array_equal(fits[0].flatchain, fits[1].flatchain)
    np.testing.assert_array_equal(fits[0].lnp, fits[1].lnp)
    with pytest.raises(ValueError, match="one obs/ivm stack per"):
        _fit("torch", joint_model("torch"), [obs], [ivm], {"0_Sky_adu": normal_pop("torch")})


# -- a fit ---------------------------------------------------------------------------
def test_nuts_and_ensemble_fits_agree():
    """The port's NUTS and ensemble fits of 4 sky targets agree on the
    population mean within ``test_ensemble_and_nuts_agree``'s 0.08; the
    result's shapes and summary."""
    k, hw, noise = 4, 12, 0.5
    rng = np.random.RandomState(0)
    adus = 0.3 + 0.08 * rng.randn(k)
    obs = adus[:, None, None] + rng.randn(k, hw, hw) * noise
    ivm = np.full((k, hw, hw), 1.0 / noise**2)
    model = sky_model("torch")
    pop = {"0_Sky_adu": normal_pop("torch", -1.0, 3.0, 0.01, 0.6)}
    r_nuts = TH.fit_hierarchical(model, obs, ivm, pop, sampler="nuts", chains=4, burn=40,
                                 iterations=40, max_depth=5, seed=4, device="cpu")
    r_ens = TH.fit_hierarchical(model, obs, ivm, pop, sampler="ensemble", burn=300,
                                iterations=300, seed=5, device="cpu")
    assert abs(r_nuts.hyper_chain[:, 0].mean() - r_ens.hyper_chain[:, 0].mean()) < 0.08
    assert "0_Sky_adu:mu" in r_nuts.summary()
    assert r_nuts.target_mean.shape == (k, 1)
    assert r_ens.flatchain.shape[1] == k * 1 + 2
    assert r_nuts.lnp.shape == (4 * 40,) and np.isfinite(r_nuts.lnp).all()
    assert set(r_nuts.diagnostics) == {"divergences", "mean_accept"}


@pytest.mark.parametrize("case,sampler,parametrization", [
    ("multipsf", "ensemble", "centered"), ("joint", "nuts", "noncentered"),
    ("survey", "nuts", "centered"), ("regression", "ensemble", "noncentered")])
def test_fit_runs_every_mode(case, sampler, parametrization):
    """A short port fit in each mode: the multi-PSF and joint (two PSFs in
    band 1) templates report Gibbs-sampled integer index columns, the
    non-centred fits constrained values inside the template support, and
    every result is finite with the JAX package's layout."""
    build, pops, data, kw = CASES[case]
    obs, ivm = data()
    kw = dict(psf_stack=psf_stars(3)[0], psfivm_stack=psf_stars(3)[1]) if kw else {}
    model = build("torch")
    res = TH.fit_hierarchical(model, obs, ivm, {n: f("torch") for n, f in pops.items()},
                              sampler=sampler, chains=2, init_pool=2, max_depth=3, burn=6,
                              iterations=4, seed=2, parametrization=parametrization,
                              device="cpu", **kw)
    k, d = 3, model.num_params
    assert res.flatchain.shape[1] == k * d + len(res.hyper_names)
    assert np.all(np.isfinite(res.flatchain)) and np.all(np.isfinite(res.lnp))
    for col in (i for i, n in enumerate(res.param_names) if "PSF_Index" in n):
        assert set(np.unique(res.flatchain[:, [t * d + col for t in range(k)]])) <= {0.0, 1.0}
    for name, (lo, hi) in res.governed_bounds.items():
        col = res.param_names.index(name)
        vals = res.flatchain[:, [t * d + col for t in range(k)]]
        assert np.all((vals >= lo) & (vals <= hi)), name


# -- the card's smoke phase, rehearsed ------------------------------------------------
def test_chip_smoke_hierarchy_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.hierarchy_phase`` at 32x32 with 4 targets, 2 chains and
    a few shallow steps on the CPU, where the wrappers run their plain
    versions: each wrapper counted as the card counts its kernel (conv_lnl
    on its ``_res_targets`` / ``_targets`` keys), so the phase's exact
    launch checks, its float64 comparisons and its rows hold here."""
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

    def targets(consts):
        return "_targets" if consts.targets else ""

    def forward_route(raws, consts):
        route = CL.conv_route(consts.shape)
        if torch.is_grad_enabled() and raws.requires_grad and route != "dft":
            route += "_res"
        return route + targets(consts), consts.shape

    counting(SR, "render_sersics")
    counting(SR, "render_sersics_backward")
    counting(CL, "batched_conv_lnl", forward_route)
    counting(CL, "batched_conv_lnl_backward", lambda raws, consts, *a: (
        CL.conv_route(consts.shape) + targets(consts), consts.shape))
    # a forced route (the matmul-DFT route timed beside the cluster route) has
    # no CPU mode
    monkeypatch.setattr(CL, "_launch_backward", lambda r, c, l, g, route, residuals=None:
                        CL.batched_conv_lnl_backward_plain(r, c, l, g))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn, *a, **k: (fn(), 1.0)[1])
    for name, value in (("HIER_TARGETS", 4), ("HIER_POOL", 2), ("HIER_DEPTH", 3),
                        ("HIER_BURN", 3), ("HIER_SAMPLE", 3), ("HIER_SURVEY_TARGETS", 2),
                        ("HIER_SURVEY_STEPS", 2), ("HIER_SURVEY_DEPTH", 2),
                        ("HIER_JOINT_TARGETS", 2), ("HIER_JOINT_STEPS", 2),
                        ("HIER_JOINT_DEPTH", 2), ("HIER_ENSEMBLE_TARGETS", 2),
                        ("HIER_ENSEMBLE_STEPS", 2), ("HIER_CPU_ROWS", 2),
                        ("HIER_ROW_WALKERS", 16), ("HIER_CHAINS", 2),
                        ("FLAGSHIP_SHAPE", (32, 32)), ("MIXED_SHAPE", (24, 24)),
                        ("MIXED_PSF_SHAPE", (12, 12)), ("PADDED_SHAPE", (20, 19)),
                        ("PADDED_PSF_SHAPE", (8, 8)),
                        ("HIER_JOINT_BAND1", ((24, 24), (20, 19), (94, 94)))):
        monkeypatch.setattr(cs, name, value)
    out = cs.hierarchy_phase(shape=(32, 32), psf_shape=(16, 16), device="cpu")
    names = [r["name"] for r in out["rows"]]
    assert names == ["conv_lnl_res_targets", "conv_lnl_backward_targets",
                     "conv_lnl_res_targets_spectra", "conv_lnl_backward_targets_spectra",
                     "conv_lnl_res_targets_mixed", "conv_lnl_backward_targets_mixed",
                     "conv_lnl_res_targets_padded", "conv_lnl_backward_targets_padded",
                     "conv_lnl_res_targets_cluster", "conv_lnl_backward_targets_cluster"]
    assert all(r["launches"] > 0 for r in out["rows"])
    launches = {r["name"]: r["launches"] for r in out["rows"]}
    assert launches["conv_lnl_res_targets"] == launches["conv_lnl_backward_targets"]
    fit = out["out"]["centered"]
    assert fit["res_equals_backward"] == {"fft_targets:32x32": fit["leaves"] + 1}
    assert out["render_launches"]["render_sersics_backward"] > 0
