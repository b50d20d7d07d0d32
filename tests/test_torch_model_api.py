"""The port's model API against the JAX package's, on the CPU.

The priors flagship (``psfmc_tpu_torch.flagship.write_priors_files`` at
32x32 with a 16x16 PSF) is one model file that each package's
``MultiComponentModel`` reads; both are held to each other at the same
thetas in float64: ``param_values``, ``get_distribution``, the host's
``log_priors`` per component and in all, ``log_posterior`` (rtol 1e-6)
and its five images, the image methods, ``simulate`` with a fixed
``RandomState``, ``thetas_from_database`` and ``get_sampler_state`` on a
database written by each package, and the flagship's batched
``log_prior_batch`` against JAX's vmapped ``log_prior`` (with the stress
and general variants of its priors).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import database as jdb
from psfmc_tpu import distributions as JD
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch.flagship import (
    PRIORS_VARIANTS,
    prior_draws,
    priors_components,
    write_priors_files,
)
from psfmc_tpu_torch.models import MultiComponentModel, build_model_spec, build_posterior


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE, PSF_SHAPE = (32, 32), (16, 16)
IMAGES = ("raw_model", "convolved_model", "composite_ivm", "residual",
          "point_source_subtracted")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(port model, JAX model, model file) on one priors-flagship file, both
    in float64."""
    directory = tmp_path_factory.mktemp("priors")
    path = write_priors_files(str(directory), SHAPE, PSF_SHAPE)
    tmodel = MultiComponentModel(path, device="cpu", dtype=torch.float64)
    jmodel = JaxModel(path, dtype=jnp.float64)
    return tmodel, jmodel, path


def _thetas(tmodel, n=4, seed=3):
    return tmodel.init_params_from_priors(n, random_state=np.random.RandomState(seed))


def test_model_file_layout_matches_jax(models):
    tmodel, jmodel, _ = models
    assert tmodel.param_names == jmodel.param_names
    assert tmodel.param_lens == jmodel.param_lens == [1, 1, 2, 1, 1, 1, 1, 1, 2,
                                                     1, 1, 1, 1, 1, 2]
    assert tmodel.param_fits_abbrs == jmodel.param_fits_abbrs
    j_draws = jmodel.init_params_from_priors(4, random_state=np.random.RandomState(3))
    np.testing.assert_array_equal(_thetas(tmodel), j_draws)


def test_param_values_and_get_distribution(models):
    tmodel, jmodel, _ = models
    theta = _thetas(tmodel)[0]
    tmodel.param_values = theta
    jmodel.param_values = theta
    tv, jv = tmodel.param_values, jmodel.param_values
    assert list(tv) == list(jv)
    for name in tv:
        np.testing.assert_array_equal(tv[name], jv[name])
        td, jd = tmodel.get_distribution(name), jmodel.get_distribution(name)
        assert type(td).__name__ == type(jd).__name__ and td.name == jd.name == name
        np.testing.assert_array_equal(np.ravel(td.value), np.ravel(jd.value))
    assert tmodel.get_distribution("no_such_param") is None
    for tc, jc in zip(tmodel.components, jmodel.components):
        assert tc.num_stochastics() == jc.num_stochastics()
        assert tc.stochastic_names() == jc.stochastic_names()
    with pytest.raises(ValueError, match="Expected 18 parameters"):
        tmodel.param_values = theta[:-1]


def test_set_stochastic_values_draws(models):
    """``"median"`` and ``"random"`` set a component's values as JAX's do."""
    tmodel, jmodel, _ = models
    tc, jc = tmodel.components[2], jmodel.components[2]  # a Sersic
    np.testing.assert_array_equal(tc.set_stochastic_values("median"),
                                  jc.set_stochastic_values("median"))
    np.testing.assert_array_equal(
        tc.set_stochastic_values("random", random_state=np.random.RandomState(5)),
        jc.set_stochastic_values("random", random_state=np.random.RandomState(5)))
    with pytest.raises(ValueError, match="Unknown draw mode"):
        tc.set_stochastic_values("mode")


@pytest.mark.parametrize("row", range(4))
def test_log_priors_match_jax(models, row):
    """Per-component and model ``log_priors`` (host scipy, with each
    component's constraints), on prior draws and, for row 3, a draw whose
    Sersic breaks ``reff >= reff_b`` (-inf in both)."""
    tmodel, jmodel, _ = models
    theta = _thetas(tmodel)[row]
    if row == 3:
        names = tmodel.param_names
        off = np.cumsum([0] + tmodel.param_lens)
        theta[off[names.index("2_Sersic_reff_b")]] = theta[off[names.index("2_Sersic_reff")]] + 1
    tmodel.param_values = theta
    jmodel.param_values = theta
    for tc, jc in zip(tmodel.components, jmodel.components):
        assert tc.log_priors() == pytest.approx(jc.log_priors(), rel=1e-12, abs=0)
    want = jmodel.log_priors()
    assert tmodel.log_priors() == pytest.approx(want, rel=1e-12, abs=0)
    assert np.isneginf(want) == (row == 3)
    batch = tmodel.posterior_fns.log_prior_batch(theta[None]).item()
    assert batch == pytest.approx(want, rel=1e-10, abs=0)


@pytest.mark.parametrize("row", range(2))
def test_log_posterior_and_images_match_jax(models, row):
    tmodel, jmodel, _ = models
    theta = _thetas(tmodel)[row]
    lnp, imgs = tmodel.log_posterior(theta, model=None)
    jlnp, jimgs = jmodel.log_posterior(theta)
    assert lnp == pytest.approx(jlnp, rel=1e-6)
    np.testing.assert_array_equal(tmodel._param_vector, theta)
    for name in IMAGES:
        scale = np.abs(jimgs[name]).max()
        np.testing.assert_allclose(imgs[name], jimgs[name], rtol=1e-6,
                                   atol=1e-9 * scale, err_msg=name)
        # the image methods read the current vector: log_posterior's
        np.testing.assert_array_equal(getattr(tmodel, name)(), imgs[name])
    assert tmodel.raw_model_std() is None


def test_simulate_matches_jax(models):
    """The same RandomState gives the same mock (the prior draw and the
    noise) in both packages."""
    tmodel, jmodel, _ = models
    mock, theta = tmodel.simulate(random_state=np.random.RandomState(11))
    jmock, jtheta = jmodel.simulate(random_state=np.random.RandomState(11))
    np.testing.assert_array_equal(theta, jtheta)
    np.testing.assert_allclose(mock, jmock, rtol=1e-6, atol=1e-9)
    clean, _ = tmodel.simulate(theta, add_noise=False)
    jclean, _ = jmodel.simulate(theta, add_noise=False)
    np.testing.assert_allclose(clean, jclean, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_database_api_across_packages(models, tmp_path, writer):
    """``thetas_from_database`` and ``get_sampler_state`` of a database
    written by either package, against the JAX package's on the same
    file and the chain's last step."""
    tmodel, jmodel, _ = models
    nw, niter = 5, 3
    chain = _thetas(tmodel, nw * niter, seed=9).reshape(nw, niter, -1)
    lnp = -1e3 + np.random.RandomState(2).randn(nw, niter)
    sampler = types.SimpleNamespace(chain=chain, lnprobability=lnp, nwalkers=nw,
                                    state=None)
    path = str(tmp_path / "db.fits")
    save, model = {"torch": (tdb.save_database, tmodel),
                   "jax": (jdb.save_database, jmodel)}[writer]
    save(sampler, model, path)
    ttable, jtable = tdb.load_database(path), jdb.load_database(path)
    thetas = tmodel.thetas_from_database(ttable)
    np.testing.assert_array_equal(thetas, jmodel.thetas_from_database(jtable))
    np.testing.assert_array_equal(thetas, chain.reshape(nw * niter, -1))
    np.testing.assert_array_equal(tmodel.thetas_from_database(ttable, rows=[2, 0]),
                                  thetas[[2, 0]])
    pos, lnprob = tdb.get_sampler_state(ttable)
    jpos, jlnprob = jdb.get_sampler_state(jtable)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(lnprob, jlnprob)
    np.testing.assert_array_equal(pos, chain[:, -1])
    np.testing.assert_array_equal(lnprob, lnp[:, -1])
    mocks, draws = tmodel.posterior_predictive(ttable, n=3, random_state=4)
    assert mocks.shape == (3,) + SHAPE and draws.shape == (3, tmodel.num_params)
    assert np.all(np.isfinite(mocks))


@pytest.mark.parametrize("variant", PRIORS_VARIANTS)
def test_priors_flagship_log_prior_batch_matches_jax(variant):
    """The batched log-prior of each priors variant (vector ``loc``
    truncated Normals, Reciprocal, Gamma, ...; the stress set's bisection,
    quadrature, mixture, tables and discrete family) against JAX's
    vmapped ``log_prior`` in float64, NaN and out-of-support rows
    included."""
    spec = build_model_spec(priors_components(SHAPE, PSF_SHAPE, variant))
    jspec = jax_spec(priors_components(SHAPE, PSF_SHAPE, variant,
                                       components=JC, distributions=JD))
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    jpost = jax_posterior(jspec, dtype=jnp.float64)
    th = prior_draws(spec, 12, seed=1)
    th[3, 0] = np.nan
    th[4, 4] = 1e3
    th[5, 2] = -50.0
    got = post.log_prior_batch(th).numpy()
    want = np.asarray(jax.vmap(jpost.log_prior)(jnp.asarray(th)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() >= 8
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10)


def test_chip_smoke_priors_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.priors_phase`` (the priors fit by ``model_galaxy_mcmc``, the
    API phase, graphed against eager, the steady steps and the three
    variants) at 32x32 with 40 walkers on the CPU, where the kernel
    wrappers run their plain versions: each wrapper is counted as the card
    counts its kernel, so the phase's exact launch checks hold here."""
    import functools

    import chip_smoke as cs
    import psfmc_tpu_torch.models as M
    import psfmc_tpu_torch.models.posterior as P
    import psfmc_tpu_torch.sampler as S
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    def counting(mod, name):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            wrapped.launches += 1
            if hasattr(wrapped, "route_launches"):  # consts is the last argument
                shape = a[-1].shape
                route = FL.fused_route if name == "fused_lnl" else CL.conv_route
                wrapped.route_launches[route(shape)] += 1
                if name == "batched_conv_lnl":
                    key = (route(shape), shape)
                    wrapped.shape_launches[key] = wrapped.shape_launches.get(
                        key, 0) + 1
            return orig(*a, **k)

        wrapped.launches = 0
        if name in ("batched_conv_lnl", "fused_lnl"):
            wrapped.route_launches = {"fft": 0, "dft": 0}
        if name == "batched_conv_lnl":
            wrapped.shape_launches = {}
        monkeypatch.setattr(mod, name, wrapped)
        monkeypatch.setattr(P, name, wrapped)

    for mod, name in ((CL, "batched_conv_lnl"), (FL, "fused_lnl"),
                      (SR, "render_sersics"), (SR, "render_sersics_tiled")):
        counting(mod, name)
    build = M.build_posterior
    monkeypatch.setattr(M, "build_posterior", lambda spec, device=None, **k: build(
        spec, device=device or "cpu", **k))
    monkeypatch.setattr(S, "EnsembleSampler",
                        functools.partial(S.EnsembleSampler, device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn, **k: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "NWALKERS", 40)
    sampling, api, variants, priors, stress = cs.priors_phase(
        shape=SHAPE, psf_shape=PSF_SHAPE, device="cpu")
    assert sampling["render_sersics"] == 1 + 2 * 40 + 20
    assert sampling["batched_conv_lnl:fft"] == 1 + 2 * 40
    assert api["render_sersics"] > 0 and variants["fused_lnl"] == 9
    assert priors.fns.lnpost == stress.fns.lnpost == "batched"
