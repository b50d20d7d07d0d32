"""Model criticism in the port against the JAX package's, on the CPU.

The same seeded inputs go through both packages in float64: a 32x32
observation (sky + point source + one Sersic, one masked pixel, a 12x12
PSF) simulated from a known truth, 300 draws scattered around it, and a
trace database of them; a two-band joint model (a 24x24 second band
whose point source is tied to the first's) likewise.  Held to the JAX
package:

* the PSIS core (``_psis_smooth``, ``_gpd_fit``, ``_gpd_quantile``,
  ``_logsumexp``) and ``cjs_distance`` on seeded matrices: identical to
  1e-12;
* the pointwise replay (the log-density matrix and the (loglike, cdf)
  pair): within 1e-10 of the largest |entry|; each draw's row sums to
  its ``log_likelihood_batch`` within 1e-10 (relative);
* WAIC, PSIS-LOO, LOO-PIT and ``compare``: ELPD, SE and p_eff within
  rtol 1e-10, the per-pixel Pareto k within 1e-8, PIT within 1e-10, the
  KS statistic and p-value within rtol 1e-8;
* power-scaling sensitivity: indices within 1e-8, the flagged set equal;
* the criticism block before rounding (the seven values within rtol
  1e-8, integer cards equal) and the cards of both image writers (floats
  within one unit of their rounding, integers equal), single-band and
  joint;
* the driver's ``criticism=True`` (ensemble: its cards against the JAX
  package's criticism of the port's own database; ``ntemps > 1`` and
  ``sampler="nuts"``: the seven cards in every product);
* the data conditions without cards: a degenerate trace (no ``MCPPCP``;
  failed in the port before its repair), too few draws (no criticism
  block), while any other error propagates.
"""
import os
import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu import database as jdb
from psfmc_tpu import distributions as JD
from psfmc_tpu.analysis import model_comparison as jmc
from psfmc_tpu.analysis import sensitivity as jsens
from psfmc_tpu.analysis.images import save_posterior_images as jax_save_images
from psfmc_tpu.model_parser import component_list_from_file as jparse
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.joint import JointModel as JaxJoint
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu.models.multicomponent import slot_param_names as jax_slot_names
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch import model_galaxy_mcmc
from psfmc_tpu_torch.analysis import model_comparison as tmc
from psfmc_tpu_torch.analysis import sensitivity as tsens
from psfmc_tpu_torch.analysis.images import save_posterior_images
from psfmc_tpu_torch.io import fits as tfits
from psfmc_tpu_torch.models import JointModel, MultiComponentModel, as_model
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.models.multicomponent import slot_param_names
from test_torch_io import MODEL, _write_inputs

PACKAGES = {"torch": (TC, TD), "jax": (JC, JD)}
SHAPE, SHAPE1, PSF_SHAPE = (32, 32), (24, 24), (12, 12)
NOISE = 0.05
NDRAWS = 300
CARDS = ("MCLOOELP", "MCLOOSE", "MCLOOPEF", "MCLOOKBD", "MCPITKS", "MCPITP", "MCPSFLAG")
INT_CARDS = ("MCLOOKBD", "MCPSFLAG")
DECIMALS = {"MCLOOELP": 2, "MCLOOSE": 2, "MCLOOPEF": 2, "MCPITKS": 4, "MCPITP": 4}
IMAGES = ("raw_model", "convolved_model", "composite_ivm", "residual",
          "point_source_subtracted")
# the truth: sky, the point source's mag and xy, the Sersic's angle, index,
# mag, reff, reff_b and xy (the slot order); the draws' scatter around it
TRUTH = np.array([0.05, 20.8, 16.0, 15.5, 60.0, 1.5, 20.5, 3.0, 2.2, 15.5, 16.5])
SCATTER = np.array([5e-4, 0.02, 0.02, 0.02, 2.0, 0.05, 0.02, 0.05, 0.05, 0.05, 0.05])


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _psf():
    yy, xx = np.mgrid[0:PSF_SHAPE[0], 0:PSF_SHAPE[1]].astype(float)
    psf = np.exp(-((xx - 6) ** 2 + (yy - 6) ** 2) / (2 * 1.5 ** 2))
    return psf / psf.sum()


def _config(C, obs):
    return C.Configuration(obs_file=obs, obsivm_file=np.full(obs.shape, NOISE ** -2),
                           psf_files=_psf(), psfivm_files=np.full(PSF_SHAPE, 1e10),
                           mag_zeropoint=25.0)


def _sources(C, D):
    ps = C.PointSource(xy=D.Uniform(loc=np.array((12.0, 12.0)), scale=np.array((8.0, 8.0))),
                       mag=D.Normal(loc=20.5, scale=1.0))
    host = C.Sersic(xy=D.Uniform(loc=np.array((12.0, 12.0)), scale=np.array((8.0, 8.0))),
                    mag=D.Uniform(loc=19.0, scale=4.0), reff=D.Uniform(loc=1.5, scale=4.0),
                    reff_b=D.Uniform(loc=1.5, scale=4.0), index=D.Uniform(loc=0.8, scale=3.0),
                    angle=D.Uniform(loc=0, scale=180), angle_degrees=True)
    return ps, host


def _single(package, obs):
    C, D = PACKAGES[package]
    comps = [_config(C, obs), C.Sky(adu=D.Normal(loc=0.05, scale=0.1)), *_sources(C, D)]
    if package == "torch":
        return MultiComponentModel(comps, device="cpu", dtype=torch.float64)
    return JaxModel(comps, dtype=jnp.float64)


def _joint(package, obs0, obs1):
    """Band 0 the single-band model; band 1 a sky and a point source tied
    to band 0's position, with its own magnitude."""
    C, D = PACKAGES[package]
    ps, host = _sources(C, D)
    ps1 = C.PointSource(xy=C.Tied(ps, "xy"), mag=D.Normal(loc=21.0, scale=1.0))
    bands = [[_config(C, obs0), C.Sky(adu=D.Normal(loc=0.05, scale=0.1)), ps, host],
             [_config(C, obs1), C.Sky(adu=D.Normal(loc=0.02, scale=0.1)), ps1]]
    if package == "torch":
        return JointModel(bands, device="cpu", dtype=torch.float64)
    return JaxJoint(bands, dtype=jnp.float64)


def _write_db(model, thetas, path, nwalkers=10):
    """A trace database of ``thetas`` (walker-major) with their float64
    lnpost."""
    lnp = model.posterior_fns.log_posterior_batch(thetas).numpy()
    sampler = types.SimpleNamespace(chain=thetas.reshape(nwalkers, -1, thetas.shape[1]),
                                    lnprobability=lnp.reshape(nwalkers, -1),
                                    nwalkers=nwalkers, state=None)
    tdb.save_database(sampler, model, path, meta_dict={"MCITER": len(thetas) // nwalkers})
    return tdb.load_database(path), jdb.load_database(path)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Both packages' single-band and joint models on the same simulated
    data, the draws, and a trace database of each."""
    tmp = tmp_path_factory.mktemp("criticism")
    rng = np.random.RandomState(0)
    obs, _ = _single("torch", np.zeros(SHAPE)).simulate(theta=TRUTH, random_state=1)
    obs[3, 4] = np.nan  # one masked pixel
    thetas = TRUTH + rng.randn(NDRAWS, TRUTH.size) * SCATTER
    out = {"tmp": tmp, "thetas": thetas, "torch": _single("torch", obs),
           "jax": _single("jax", obs)}
    out["tdb"], out["jdb"] = _write_db(out["torch"], thetas, str(tmp / "db.fits"))
    # the joint model: band 1's sky and magnitude appended to the layout
    gen = _joint("torch", np.zeros(SHAPE), np.zeros(SHAPE1))
    names = gen.param_names
    jtruth = np.zeros(gen.num_params)
    jscatter = np.zeros(gen.num_params)
    single_names = out["torch"].param_names
    off = dict(zip(single_names, np.cumsum([0] + out["torch"].param_lens)))
    joff = dict(zip(names, np.cumsum([0] + gen.param_lens)))
    for name, ln in zip(single_names, out["torch"].param_lens):
        jtruth[joff[name]:joff[name] + ln] = TRUTH[off[name]:off[name] + ln]
        jscatter[joff[name]:joff[name] + ln] = SCATTER[off[name]:off[name] + ln]
    extra = [n for n in names if n not in single_names]
    assert len(extra) == 2  # band 1's sky and point-source magnitude
    for name, value, sd in zip(sorted(extra), (0.02, 21.3), (5e-4, 0.03)):
        jtruth[joff[name]], jscatter[joff[name]] = value, sd
    mocks, _ = gen.simulate(theta=jtruth, random_state=2)
    out["jt"] = _joint("torch", obs, mocks[1])
    out["jj"] = _joint("jax", obs, mocks[1])
    out["jthetas"] = jtruth + rng.randn(NDRAWS, jtruth.size) * jscatter
    out["jtdb"], out["jjdb"] = _write_db(out["jt"], out["jthetas"], str(tmp / "jdb.fits"))
    return out


# -- the PSIS core and the CJS distance ----------------------------------------
def _heavy_matrix(seed, p=40, s=400):
    """Seeded log-ratio rows: light tails, heavy tails, a constant row, a
    single dominating draw."""
    rng = np.random.RandomState(seed)
    lr = rng.randn(p, s)
    lr[5:15] *= 6.0
    lr[15:20] = rng.standard_cauchy((5, s))
    lr[20] = 1.5
    lr[21, 7] = 1e3
    return lr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psis_core_matches_jax(seed):
    """``_psis_smooth`` (log-weights and k), ``_gpd_fit``, ``_gpd_quantile``
    and ``_logsumexp``: the same bits as the JAX package's to 1e-12."""
    lr = _heavy_matrix(seed)
    lw_t, k_t = tmc._psis_smooth(lr.copy())
    lw_j, k_j = jmc._psis_smooth(lr.copy())
    np.testing.assert_allclose(lw_t, lw_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(k_t, k_j, rtol=1e-12, atol=1e-12)
    assert np.isinf(k_t[20]) and k_t[20] < 0  # nothing to smooth
    exceed = np.sort(np.abs(np.random.RandomState(seed).standard_cauchy((8, 60))), axis=1)
    for a, b in zip(tmc._gpd_fit(exceed), jmc._gpd_fit(exceed)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    k, sigma = jmc._gpd_fit(exceed)
    q = np.linspace(0.05, 0.95, 7)[None, :]
    np.testing.assert_allclose(tmc._gpd_quantile(q, k, sigma),
                               jmc._gpd_quantile(q, k, sigma), rtol=1e-12)
    np.testing.assert_allclose(tmc._logsumexp(lr, axis=1), jmc._logsumexp(lr, axis=1),
                               rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_cjs_distance_matches_jax(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(500)
    for w in (np.ones(500), np.exp(0.3 * x), np.exp(-2.0 * x ** 2), rng.gamma(0.5, size=500)):
        assert tsens.cjs_distance(x, w) == pytest.approx(jsens.cjs_distance(x, w),
                                                         rel=1e-12, abs=1e-12)
    assert tsens.cjs_distance(np.ones(20), rng.rand(20)) == 0.0  # no spread


def test_slot_param_names_matches_jax():
    names, lens = ["a", "b_xy", "c"], [1, 2, 3]
    assert slot_param_names(names, lens) == jax_slot_names(names, lens)
    assert slot_param_names(names, None) == jax_slot_names(names, None)


# -- the pointwise replay --------------------------------------------------------
def _rel_max(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_pointwise_replay_matches_jax(case):
    """The log-density matrix and the (loglike, cdf) pair from the same
    thetas, in chunks of 128 and the remainder: within 1e-10 of the
    largest entry of the JAX package's; each row sums to the draw's lnL."""
    tm, jm, th = case["torch"], case["jax"], case["thetas"]
    ll = tmc.pointwise_loglike(tm, thetas=th, chunk=128)
    assert ll.shape == (NDRAWS, SHAPE[0] * SHAPE[1] - 1) and ll.dtype == np.float64
    assert _rel_max(ll, jmc.pointwise_loglike(jm, thetas=th, chunk=128)) < 1e-10
    pair_t = tmc._pointwise_matrix_pair(tm, th, 128)
    pair_j = jmc._pointwise_matrix_pair(jm, th, 128)
    np.testing.assert_array_equal(pair_t[0], ll)  # one render for both maps
    for a, b in zip(pair_t, pair_j):
        assert _rel_max(a, b) < 1e-10
    assert np.all((pair_t[1] >= 0) & (pair_t[1] <= 1))
    lnl = tm.posterior_fns.log_likelihood_batch(th).numpy()
    np.testing.assert_allclose(ll.sum(axis=1), lnl, rtol=1e-10)


def test_joint_pointwise_replay_concatenates_bands(case):
    tm, jm, th = case["jt"], case["jj"], case["jthetas"]
    ll, cdf = tmc._pointwise_matrix_pair(tm, th, 256)
    assert ll.shape == (NDRAWS, SHAPE[0] * SHAPE[1] - 1 + SHAPE1[0] * SHAPE1[1])
    for a, b in zip((ll, cdf), jmc._pointwise_matrix_pair(jm, th, 256)):
        assert _rel_max(a, b) < 1e-10
    np.testing.assert_allclose(ll.sum(axis=1),
                               tm.posterior_fns.log_likelihood_batch(th).numpy(), rtol=1e-10)


def test_resolve_thetas_filters_as_jax(case):
    """The stuck-walker filter, the lnp floor and the even thinning pick
    the same rows; a walker stranded far below the rest is dropped."""
    th = case["thetas"].copy()
    path = str(case["tmp"] / "stuck.fits")
    th[:30, 0] = 0.35  # walker 0: a sky far off (lnp ~ -1e4 lower)
    tdb_, jdb_ = _write_db(case["torch"], th, path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tmc._resolve_thetas(case["torch"], tdb_, None, 200)
        want = jmc._resolve_thetas(case["jax"], jdb_, None, 200)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 200 and not np.any(got[:, 0] == 0.35)
    with pytest.warns(UserWarning, match="dropping"):
        np.testing.assert_array_equal(tmc.robust_lnp_keep([0.0] * 50 + [-1e6]),
                                      [True] * 50 + [False])


# -- the scores ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def matrices(case):
    th = case["thetas"]
    return (tmc._pointwise_matrix_pair(case["torch"], th, 256),
            jmc._pointwise_matrix_pair(case["jax"], th, 256))


def _same_elpd(a, b):
    assert a.kind == b.kind and a.n_samples == b.n_samples and a.unit == b.unit
    for f in ("elpd", "p_eff", "se"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-10), f
    np.testing.assert_allclose(a.elpd_i, b.elpd_i, rtol=1e-10, atol=1e-10)
    assert len(a.notes) == len(b.notes)


def test_waic_and_psis_loo_match_jax(matrices):
    (llt, _), (llj, _) = matrices
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wt, wj = tmc.waic(loglike=llt), jmc.waic(loglike=llj)
        lt, lj = tmc.psis_loo(loglike=llt, point_chunk=500), jmc.psis_loo(loglike=llj,
                                                                          point_chunk=500)
    _same_elpd(wt, wj)
    _same_elpd(lt, lj)
    assert wt.pareto_k is None
    np.testing.assert_allclose(lt.pareto_k, lj.pareto_k, rtol=0, atol=1e-8)
    assert np.sum(lt.pareto_k > 0.7) == np.sum(lj.pareto_k > 0.7)
    assert lt.summary().splitlines()[0] == lj.summary().splitlines()[0]
    assert wt.ic == pytest.approx(-2 * wt.elpd)


def test_loo_pit_and_compare_match_jax(case, matrices):
    (llt, cdft), (llj, cdfj) = matrices
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pt, pj = tmc.loo_pit(loglike=llt, cdf=cdft), jmc.loo_pit(loglike=llj, cdf=cdfj)
        # the replay from the database, as the driver's block does
        pd = tmc.loo_pit(case["torch"], case["tdb"], max_samples=200)
        pdj = jmc.loo_pit(case["jax"], case["jdb"], max_samples=200)
        # two "fits" of the same pixels: the first and the last 150 draws
        l1, l2 = tmc.psis_loo(loglike=llt[:150]), tmc.psis_loo(loglike=llt[150:])
        j1, j2 = jmc.psis_loo(loglike=llj[:150]), jmc.psis_loo(loglike=llj[150:])
    for a, b in ((pt, pj), (pd, pdj)):
        np.testing.assert_allclose(a.pit, b.pit, rtol=0, atol=1e-10)
        np.testing.assert_allclose(a.pareto_k, b.pareto_k, rtol=0, atol=1e-8)
        assert a.ks_stat == pytest.approx(b.ks_stat, rel=1e-8)
        assert a.ks_pvalue == pytest.approx(b.ks_pvalue, rel=1e-8)
        assert a.calibrated() == b.calibrated()
    delta_t, delta_j = tmc.compare(l1, l2), jmc.compare(j1, j2)
    np.testing.assert_allclose(delta_t, delta_j, rtol=1e-8)
    assert delta_t[1] > 0
    with pytest.raises(ValueError, match="same data"):
        tmc.compare(l1, tmc.psis_loo(loglike=llt[:, :10]))
    with pytest.raises(ValueError, match="units"):
        tmc.compare(l1, tmc.ELPDResult("loo", 0.0, 0.0, 0.0, 1, l1.elpd_i, unit="targets"))


# -- sensitivity ---------------------------------------------------------------------
def test_power_scale_sensitivity_matches_jax(case):
    """The indices of every slot within 1e-8 and the flagged set; then a
    conflicting prior (a Normal on the sky 20 sigma away from the data's
    value), flagged in both packages."""
    th = case["thetas"]
    st = tsens.power_scale_sensitivity(case["torch"], thetas=th)
    sj = jsens.power_scale_sensitivity(case["jax"], thetas=th)
    assert st.param_names == sj.param_names
    assert st.param_names[2:4] == ["1_PointSource_xy_x", "1_PointSource_xy_y"]
    np.testing.assert_allclose(st.prior, sj.prior, rtol=0, atol=1e-8)
    np.testing.assert_allclose(st.likelihood, sj.likelihood, rtol=0, atol=1e-8)
    assert st.flagged() == sj.flagged()
    assert st.pareto_k.keys() == sj.pareto_k.keys()
    for key in st.pareto_k:
        assert st.pareto_k[key] == pytest.approx(sj.pareto_k[key], abs=1e-8)
    # a prior-data conflict on the sky: its lnprior term tilts the draws
    lnprior = -0.5 * ((th[:, 0] - 0.04) / 5e-4) ** 2
    lnlik = case["torch"].posterior_fns.log_likelihood_batch(th).numpy()
    ct = tsens.power_scale_from_logs(th, lnprior, lnlik, st.param_names)
    cj = jsens.power_scale_from_logs(th, lnprior, lnlik, sj.param_names)
    np.testing.assert_allclose(ct.prior, cj.prior, rtol=0, atol=1e-8)
    assert ct.flagged() == cj.flagged() and "0_Sky_adu" in ct.flagged()
    assert ct.diagnosis(0) == cj.diagnosis(0)
    assert ct.summary() == cj.summary()


def test_joint_sensitivity_sums_the_bands(case):
    th = case["jthetas"]
    st = tsens.power_scale_sensitivity(case["jt"], thetas=th)
    sj = jsens.power_scale_sensitivity(case["jj"], thetas=th)
    assert st.param_names == sj.param_names
    np.testing.assert_allclose(st.prior, sj.prior, rtol=0, atol=1e-8)
    np.testing.assert_allclose(st.likelihood, sj.likelihood, rtol=0, atol=1e-8)
    assert st.flagged() == sj.flagged()


def test_too_few_draws_raise_a_value_error(case):
    """Below 100 finite draws both packages raise a ``ValueError``; the
    port's is :class:`TooFewDrawsError`, the one error its writers turn
    into a warning."""
    th = case["thetas"][:120].copy()
    th[:30, 1] = np.nan  # 90 finite draws
    with pytest.raises(tmc.TooFewDrawsError, match=">=100 finite"):
        tsens.power_scale_sensitivity(case["torch"], thetas=th)
    with pytest.raises(ValueError, match=">=100 finite"):
        jsens.power_scale_sensitivity(case["jax"], thetas=th)
    assert issubclass(tmc.TooFewDrawsError, ValueError)


# -- the header block ---------------------------------------------------------------
def _jax_values(model, db, draws):
    """The JAX package's criticism block before rounding."""
    thetas = jmc._resolve_thetas(model, db, None, draws)
    ll, cdf = jmc._pointwise_matrix_pair(model, thetas, 256)
    return (jmc.psis_loo(loglike=ll), jmc.loo_pit(loglike=ll, cdf=cdf),
            jsens.power_scale_sensitivity(model, thetas=thetas))


def _floats(loo, pit, sens):
    return {"MCLOOELP": loo.elpd, "MCLOOSE": loo.se, "MCLOOPEF": loo.p_eff,
            "MCLOOKBD": int(np.sum(loo.pareto_k > 0.7)), "MCPITKS": pit.ks_stat,
            "MCPITP": pit.ks_pvalue, "MCPSFLAG": len(sens.flagged())}


@pytest.mark.parametrize("kind", ["single", "joint"])
def test_criticism_values_match_jax(case, kind):
    """The seven values before rounding within rtol 1e-8 (the integer
    cards equal), from a trace database with 200 draws; the port's cards
    are those values rounded as the JAX package rounds them."""
    tm, jm, tdb_, jdb_ = ((case["torch"], case["jax"], case["tdb"], case["jdb"])
                          if kind == "single" else
                          (case["jt"], case["jj"], case["jtdb"], case["jjdb"]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _floats(*tmc.criticism_values(tm, tdb_, draws=200))
        want = _floats(*_jax_values(jm, jdb_, 200))
        cards = tmc.criticism_header_stats(tm, tdb_, draws=200)
    assert list(cards) == list(CARDS)
    for key in CARDS:
        if key in INT_CARDS:
            assert got[key] == want[key], key
            assert cards[key][0] == got[key]
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-8), key
            assert cards[key][0] == round(got[key], DECIMALS[key])


def _assert_cards_match(th, jh):
    """The criticism cards of two headers: integers equal, floats within
    one unit of their rounding, the comments equal."""
    for key in CARDS:
        assert key in th and key in jh, key
        if key in INT_CARDS:
            assert th[key] == jh[key], key
        else:
            assert abs(th[key] - jh[key]) <= 10.0 ** -DECIMALS[key] + 1e-12, key
    comments = [{k: c for k, _, c in h.cards() if k in CARDS} for h in (th, jh)]
    assert comments[0] == comments[1]


def test_single_band_writer_cards_match_jax(case):
    tmp = case["tmp"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_save_images(case["jax"], case["jdb"], output_name=str(tmp / "jw_{}"),
                        ppc_draws=0, criticism_draws=200)
        save_posterior_images(case["torch"], case["tdb"], output_name=str(tmp / "tw_{}"),
                              ppc_draws=0, criticism_draws=200)
    for ftype in IMAGES:
        _assert_cards_match(tfits.getheader(str(tmp / f"tw_{ftype}.fits")),
                            tfits.getheader(str(tmp / f"jw_{ftype}.fits")))


def test_joint_writer_cards_match_jax(case):
    """One block over both bands' pixels, in every band's products."""
    tmp, tm, th = case["tmp"], case["jt"], case["jthetas"]
    accum = {k: v.numpy() for k, v in tm.posterior_fns.ensemble_carry_means(th).items()}
    src = types.SimpleNamespace(accumulated_images=accum, accumulated_samples=len(th))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        case["jj"].save_posterior_images(src, str(tmp / "jj"), database=case["jjdb"],
                                         criticism_draws=200)
        tm.save_posterior_images(src, str(tmp / "jt"), database=case["jtdb"],
                                 criticism_draws=200)
    for band in (0, 1):
        for ftype in IMAGES:
            _assert_cards_match(tfits.getheader(str(tmp / f"jt_b{band}_{ftype}.fits")),
                                tfits.getheader(str(tmp / f"jj_b{band}_{ftype}.fits")))
    hdr = tfits.getheader(str(tmp / "jt_b1_residual.fits"))
    assert hdr["MCBAND"] == 1 and hdr["MCACCUM"] == len(th)


# -- the data conditions without cards ---------------------------------------------
def _degenerate_db(model, path):
    """Two stuck chains of two samples each: the writer's filter keeps the
    better chain, whose rows sit at one lnprobability."""
    th = np.tile(TRUTH, (4, 1))
    th[2:, 0] += 1e-3
    sampler = types.SimpleNamespace(chain=th.reshape(2, 2, -1), nwalkers=2, state=None,
                                    lnprobability=np.array([[-5.0, -5.0], [-3.0, -3.0]]))
    tdb.save_database(sampler, model, path, meta_dict={"MCITER": 2})
    return tdb.load_database(path), jdb.load_database(path)


def test_degenerate_trace_writes_the_products_without_mcppcp(case):
    """Both packages write every product for a trace whose rows, after the
    stuck-walker filter, sit at one lnprobability, with a warning and no
    ``MCPPCP`` (before the repair the port raised from the replay's
    reshape); the criticism block is left out too."""
    tmp = case["tmp"]
    tdb_, jdb_ = _degenerate_db(case["torch"], str(tmp / "degenerate.fits"))
    with pytest.warns(UserWarning, match="MCPPCP not computed"):
        save_posterior_images(case["torch"], tdb_, output_name=str(tmp / "tdeg_{}"),
                              ppc_draws=20, criticism_draws=200)
    with pytest.warns(UserWarning, match="posterior-predictive p-value"):
        jax_save_images(case["jax"], jdb_, output_name=str(tmp / "jdeg_{}"),
                        ppc_draws=20, criticism_draws=200)
    for prefix in ("tdeg", "jdeg"):
        for ftype in IMAGES:
            hdr = tfits.getheader(str(tmp / f"{prefix}_{ftype}.fits"))
            assert "MCCHI2NU" in hdr and "MCPPCP" not in hdr, (prefix, ftype)
            assert not any(key in hdr for key in CARDS)
    with pytest.raises(ValueError, match="stuck-walker filter"):
        case["torch"].posterior_predictive_pvalue(tdb_[np.arange(2, 4)], n=4)


def test_short_trace_leaves_out_the_block_with_a_warning(case):
    """Fewer than 100 draws: no criticism card in either package, the
    products written, the port warning that names the reason."""
    tmp = case["tmp"]
    tdb_, jdb_ = _write_db(case["torch"], case["thetas"][:60],
                           str(tmp / "short.fits"), nwalkers=6)
    with pytest.warns(UserWarning, match="could not compute criticism.*>=100"):
        save_posterior_images(case["torch"], tdb_, output_name=str(tmp / "tshort_{}"),
                              ppc_draws=0, criticism_draws=500)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_save_images(case["jax"], jdb_, output_name=str(tmp / "jshort_{}"),
                        ppc_draws=0, criticism_draws=500)
    for prefix in ("tshort", "jshort"):
        hdr = tfits.getheader(str(tmp / f"{prefix}_residual.fits"))
        assert "MCCHI2NU" in hdr and not any(key in hdr for key in CARDS), prefix


def test_a_failing_replay_propagates(case, monkeypatch):
    """A replay that fails (a kernel launch, on the card) is not a missing
    card: it propagates out of the writer."""
    def failing(thetas):
        raise RuntimeError("replay launch failed")

    model = _single("torch", np.asarray(case["torch"].spec.obs_data))
    monkeypatch.setattr(model.posterior_fns, "pointwise_lnl_and_cdf", failing)
    with pytest.raises(RuntimeError, match="replay launch failed"):
        save_posterior_images(model, case["tdb"], output_name=str(case["tmp"] / "fail_{}"),
                              ppc_draws=0, criticism_draws=200)


# -- the driver ------------------------------------------------------------------------
@pytest.fixture
def model_dir(tmp_path):
    _write_inputs(str(tmp_path))
    (tmp_path / "model.py").write_text(MODEL)
    return tmp_path


def _fit(model_dir, model=None, **kw):
    args = dict(output_name=str(model_dir / "out"), chains=24, burn=10, iterations=10,
                seed=0, device="cpu", criticism=True)
    args.update(kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "not yet converged"
        return model_galaxy_mcmc(model or str(model_dir / "model.py"), **args)


def _products_have_the_cards(base):
    headers = [tfits.getheader(f"{base}_{ftype}.fits") for ftype in IMAGES]
    for hdr in headers:
        assert all(key in hdr for key in CARDS), [k for k in CARDS if k not in hdr]
    return headers[0]


def test_driver_criticism_matches_jax(model_dir):
    """``model_galaxy_mcmc(criticism=True)`` on the model file's float64
    model: the seven cards in every product, equal (within one unit of
    rounding) to the JAX package's criticism of the port's own database
    at the driver's 500 draws."""
    path = str(model_dir / "model.py")
    _fit(model_dir, MultiComponentModel(path, device="cpu", dtype=torch.float64), burn=30)
    hdr = _products_have_the_cards(str(model_dir / "out"))
    # the writer's stuck-walker filter, then the block's own
    db = jdb.filter_lowp_walkers(jdb.load_database(str(model_dir / "out_db.fits")), 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _floats(*_jax_values(JaxModel(jparse(path), dtype=jnp.float64), db, 500))
    for key in CARDS:
        if key in INT_CARDS:
            assert hdr[key] == want[key], key
        else:
            assert abs(hdr[key] - round(want[key], DECIMALS[key])) \
                <= 10.0 ** -DECIMALS[key] + 1e-12, key


@pytest.mark.parametrize("kw", [dict(ntemps=3, chains=24),
                                dict(sampler="nuts", chains=8, burn=12, iterations=20,
                                     max_depth=2)])
def test_driver_criticism_other_samplers(model_dir, kw):
    """Tempered and NUTS fits write the seven cards into every product."""
    db = _fit(model_dir, **kw)
    assert len(db) >= 100
    hdr = _products_have_the_cards(str(model_dir / "out"))
    assert hdr["MCLOOKBD"] >= 0 and 0.0 <= hdr["MCPITP"] <= 1.0


def test_joint_driver_criticism(model_dir):
    """A two-``Configuration`` model file: one block over both bands."""
    text = MODEL + MODEL.split("\n", 3)[3].split("Sky(")[0]
    (model_dir / "joint.py").write_text(text)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        model_galaxy_mcmc(str(model_dir / "joint.py"), output_name=str(model_dir / "jo"),
                          chains=24, burn=6, iterations=6, seed=0, device="cpu",
                          criticism=True)
    h0 = _products_have_the_cards(str(model_dir / "jo_b0"))
    h1 = _products_have_the_cards(str(model_dir / "jo_b1"))
    assert all(h0[key] == h1[key] for key in CARDS)
    assert isinstance(as_model(str(model_dir / "joint.py"), device="cpu"), JointModel)


# -- chip_smoke.py's criticism phase, rehearsed ----------------------------------
def test_chip_smoke_criticism_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.criticism_phase`` (the fused flagship fit and a joint fit
    with ``criticism=True``, the cards and the matrices against the CPU's
    float64, the block's exact launches, the kernel checks at its batches)
    at 32x32 (the joint's band 1 at 24x24, the mixed-radix geometry) on the
    CPU, where each wrapper runs its plain version and is counted as the
    card counts its kernel."""
    import functools

    import chip_smoke as cs
    import psfmc_tpu_torch.models.posterior as P
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    def counting(mod, name, route=None):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            wrapped.launches += 1
            if route is not None:
                key = route(a[-1].shape), a[-1].shape  # the constants come last
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

    counting(SR, "render_sersics")
    counting(CL, "batched_conv_lnl", CL.conv_route)
    counting(FL, "fused_lnl", FL.fused_route)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn, **k: (fn(), 0.123)[1])
    for name, value in (("NWALKERS", 40), ("BURN", 10), ("SAMPLE", 20), ("CHECKPOINT", 10),
                        ("CRIT_JOINT_BURN", 6), ("CRIT_JOINT_SAMPLE", 10)):
        monkeypatch.setattr(cs, name, value)
    out = cs.criticism_phase(shape=(32, 32), psf_shape=(16, 16),
                             joint_shapes=((32, 32), (24, 24)), device="cpu")
    single, joint = out["single"], out["joint"]
    assert single["launches"] == {"render_sersics": 2, "fused_lnl": 1,
                                  "batched_conv_lnl": 0, "render_sersics_tiled": 0}
    assert joint["launches"]["render_sersics"] == 2 * (2 + 1)
    # 800 rows thinned to the driver's 500; the joint's 400 less the filters'
    assert single["draws"] == 500 and 100 <= joint["draws"] <= 400
    for res in (single, joint):
        assert res["ll_err_share_of_tol"] <= 1.0 and res["cdf_err_share_of_tol"] <= 1.0
        assert set(res["cards"]) == set(cs.CRIT_CARDS)
    assert [c["batch"] for c in single["kernel_checks"]] == [256, 244, 500]
    assert [c["kernel"] for c in joint["kernel_checks"]] == ["render"] * 2 + [
        "render+conv_lnl"] + ["render"] * 2 + ["render+conv_lnl"]
