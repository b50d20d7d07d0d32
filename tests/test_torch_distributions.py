"""The port's prior densities against the JAX package's, on the CPU.

Every case of ``tests/test_distributions.py`` (and the aliases it lacks,
``chip_smoke.PRIOR_CASES``: the same list, which the card evaluates too)
goes through ``jax_logp`` and the port's ``torch_logp`` at its grid, the
support's edges and points just and well outside them: float64 to rtol
1e-8 / atol 1e-8 with the same infinite entries, and float32 against
JAX's float32 (``jax.enable_x64(False)``) to 1e-5 of ``max(1, |lp|)``
with the same infinite entries.  Then the table families' host builds,
vector hyperparameters (per-element tables on the columns of a batch),
the host-callback last resort, gradients, discrete rounding, ``median``
and ``interval``.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from psfmc_tpu import distributions as JD
from psfmc_tpu_torch import distributions as TD
from test_distributions import CASES

F32_TOL = 1e-5  # float32: |port - JAX| / max(1, |JAX|)
TABLE_ALIASES = ("BetaPrime", "KSOneSided", "KSTwoSided", "LevyStable")
_IDS = [f"{i}-{alias}" for i, (alias, _kw, _grid) in enumerate(chip_smoke.PRIOR_CASES)]


@pytest.fixture(scope="module")
def priors():
    """One (JAX, port) pair per case, built once; the table families'
    tables are built here, in the fixture's setup (LevyStable's take over
    ten seconds of host time in each package)."""
    cache = {}

    def get(i):
        if i not in cache:
            alias, kw, _grid = chip_smoke.PRIOR_CASES[i]
            cache[i] = (getattr(JD, alias)(**kw), TD.from_name(alias, **kw))
        return cache[i]

    for i, (alias, _kw, _grid) in enumerate(chip_smoke.PRIOR_CASES):
        if alias in TABLE_ALIASES:
            jd, td = get(i)
            jd.jax_logp(jnp.asarray([0.3]))
            td._plan(1)
    return get


def _assert_same(got, want, rtol, atol, what):
    inf = np.isinf(want) | np.isinf(got)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=rtol, atol=atol, err_msg=what)


def test_prior_cases_are_the_jax_test_cases():
    """``chip_smoke.PRIOR_CASES`` starts with the JAX test's cases, in its
    order, and adds the aliases they lack: every alias is evaluated."""
    ours = chip_smoke.PRIOR_CASES
    for (make, xs), (alias, kw, grid) in zip(CASES, ours):
        jd = make()
        assert (type(jd).__name__, jd.rv_frozen.kwds) == (alias, kw)
        np.testing.assert_array_equal(chip_smoke.prior_grid(grid), xs)
    assert {alias for alias, _kw, _grid in ours} == set(JD.SCIPY_DIST_NAMES)


@pytest.mark.parametrize("i", range(len(chip_smoke.PRIOR_CASES)), ids=_IDS)
def test_torch_logp_matches_jax(priors, i):
    jd, td = priors(i)
    x = chip_smoke.prior_points(td, chip_smoke.PRIOR_CASES[i][2])
    want = np.asarray(jd.jax_logp(jnp.asarray(x, jnp.float64)))
    got = td.torch_logp(torch.as_tensor(x, dtype=torch.float64)).numpy()
    assert got.dtype == np.float64
    _assert_same(got, want, 1e-8, 1e-8, _IDS[i])


@pytest.mark.parametrize("i", range(len(chip_smoke.PRIOR_CASES)), ids=_IDS)
def test_torch_logp_float32_matches_jax_float32(priors, i):
    """Where float32 loses digits (Tukey-lambda's upper bisection bound
    rounds to 1, the noncentral families' sums, ...) it loses them in both
    packages the same way."""
    jd, td = priors(i)
    x = chip_smoke.prior_grid(chip_smoke.PRIOR_CASES[i][2]).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jd.jax_logp(jnp.asarray(x, jnp.float32)))
    got = td.torch_logp(torch.as_tensor(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    inf = np.isinf(want) | np.isinf(got)
    np.testing.assert_array_equal(got[inf], want[inf])
    err = np.abs(got[~inf] - want[~inf]) / np.maximum(1.0, np.abs(want[~inf]))
    assert err.max(initial=0.0) <= F32_TOL, _IDS[i]


@pytest.mark.parametrize("alias", TABLE_ALIASES)
def test_table_is_the_jax_table(priors, alias):
    """The four families with no closed form: the port's host build gives
    the JAX package's grid, values and slopes bit for bit, and the tails
    extrapolate (or mask) as JAX's do."""
    i = next(k for k, case in enumerate(chip_smoke.PRIOR_CASES) if case[0] == alias)
    jd, td = priors(i)
    x = np.asarray([0.3])
    jd.jax_logp(jnp.asarray(x))
    jtab = jd._logpdf_table
    (ttab,) = td._plan(1).tables
    for attr in ("med", "s", "t0", "dt", "n", "lo", "hi"):
        assert getattr(ttab, attr) == float(getattr(jtab, attr)), attr
    np.testing.assert_array_equal(ttab.v, jtab.v)
    np.testing.assert_array_equal(ttab.slope, jtab.slope)
    a, b = td.rv_frozen.support()
    far = [b + 0.1 if np.isfinite(b) else 5 * td.rv_frozen.isf(1e-12),
           a - 0.1 if np.isfinite(a) else 5 * td.rv_frozen.ppf(1e-12), np.nan]
    want = np.asarray(jd.jax_logp(jnp.asarray(far, jnp.float64)))
    got = td.torch_logp(torch.as_tensor(far, dtype=torch.float64)).numpy()
    _assert_same(got, want, 1e-8, 1e-8, alias)
    assert td._plan(1).kind == "tables" and not td.needs_host()


@pytest.mark.parametrize("alias,kw,rows", chip_smoke.PRIOR_VECTOR_CASES,
                         ids=[c[0] for c in chip_smoke.PRIOR_VECTOR_CASES])
def test_vector_hyperparameters_match_jax(alias, kw, rows):
    """The JAX density is vmapped per walker (``x`` is ``(size,)``); the
    port's takes the batch ``(B, size)`` and applies per-element tables to
    its columns.  No host callback: no warning."""
    jd, td = getattr(JD, alias)(**kw), TD.from_name(alias, **kw)
    rows = np.asarray(rows)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = np.stack([np.asarray(jd.jax_logp(jnp.asarray(r, jnp.float64)))
                         for r in rows])
        got = td.torch_logp(torch.as_tensor(rows, dtype=torch.float64)).numpy()
    assert got.shape == rows.shape
    _assert_same(got, want, 1e-8, 1e-8, alias)
    kind = "closed" if alias == "TruncatedNormal" else "tables"
    assert td._plan(rows.shape[1]).kind == kind and not td.needs_host()


def test_discrete_vector_hyperparameters_use_the_host_on_the_cpu():
    """The last resort, scipy on the host, warns as the JAX package's
    callback does and agrees with it; the posterior refuses it on CUDA
    (``tests/test_torch_cuda.py``)."""
    kw = dict(mu1=np.array([2.0, 3.0]), mu2=np.array([1.0, 1.0]))
    jd, td = JD.Skellam(**kw), TD.Skellam(**kw)
    rows = np.array([[1.0, 2.0], [-2.0, 0.4], [0.6, 7.0]])
    with pytest.warns(UserWarning, match="host callback"):
        want = np.stack([np.asarray(jd.jax_logp(jnp.asarray(r, jnp.float64)))
                         for r in rows])
    with pytest.warns(UserWarning, match="host callback"):
        got = td.torch_logp(torch.as_tensor(rows, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert td.needs_host() and not TD.Skellam(mu1=2.0, mu2=1.0).needs_host()


@pytest.mark.parametrize("make,points", [
    (lambda D: D.TukeyLambda(lam=0.5), (0.3, -1.2, 1.7)),
    (lambda D: D.TukeyLambda(lam=0.0), (0.3, -2.5)),
    (lambda D: D.TukeyLambda(lam=-0.5), (0.3, 4.0)),
    (lambda D: D.NonCentralT(df=4.0, nc=1.5), (0.7, -2.0, 6.0)),
    (lambda D: D.KSTwoSided(), (0.7, 1.3, 2.9)),
], ids=["tukeylambda-0.5", "tukeylambda-0", "tukeylambda--0.5", "nct", "kstwobign"])
def test_gradient_matches_jax(make, points):
    """``torch.autograd.grad`` against ``jax.grad`` in float64: the
    Tukey-lambda implicit gradient (the bisection's own derivative is 0),
    the quadrature and the table's Hermite interpolant."""
    jd, td = make(JD), make(TD)
    for p in points:
        want = float(jax.grad(lambda v: jd.jax_logp(v))(jnp.asarray(p, jnp.float64)))
        x = torch.tensor(p, dtype=torch.float64, requires_grad=True)
        (got,) = torch.autograd.grad(td.torch_logp(x), x)
        assert got.item() == pytest.approx(want, rel=1e-8, abs=1e-12), p


_CONTINUOUS = [i for i, (alias, _kw, _grid) in enumerate(chip_smoke.PRIOR_CASES)
               if not TD.from_name(alias, **_kw).is_discrete]


@pytest.fixture()
def one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("i", _CONTINUOUS, ids=[_IDS[i] for i in _CONTINUOUS])
def test_torch_logp_gradient_matches_jax(priors, i, one_thread):
    """Every continuous family's ``torch_logp`` gradient (the MAP fit's
    prior term) against ``jax.grad`` of ``jax_logp`` in float64.  At the
    case's grid points strictly inside the support, within 1e-8 of the
    largest (Laplace's location, a kink where the two frameworks take
    different subgradients, is left out).  At every point, the support's
    edges and points outside included, the port's gradient is finite
    wherever JAX's is (outside the support the port's safe ``where``s give
    0 where JAX's give NaN; at an edge the two may take different sides)."""
    jd, td = priors(i)
    alias, kw, grid = chip_smoke.PRIOR_CASES[i]
    lo, hi = (float(v) for v in td.rv_frozen.support())

    def grads(x):
        want = np.asarray(jax.grad(lambda v: jnp.sum(jd.jax_logp(v)))(
            jnp.asarray(x, jnp.float64)))
        xt = torch.as_tensor(x, dtype=torch.float64).requires_grad_(True)
        out = td.torch_logp(xt).sum()
        got = (torch.autograd.grad(out, xt)[0].numpy() if out.requires_grad
               else np.zeros_like(x))  # a constant density (Uniform)
        return got, want

    x = chip_smoke.prior_points(td, grid)
    inside = (x > lo) & (x < hi) & (np.arange(len(x)) < len(chip_smoke.prior_grid(grid)))
    if alias == "Laplace":
        inside &= x != kw.get("loc", 0.0)
    got, want = grads(x)
    assert np.all(np.isfinite(got[np.isfinite(want)])), _IDS[i]
    got, want = got[inside], want[inside]
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got)), _IDS[i]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * max(np.abs(want).max(), 1e-300),
                               err_msg=_IDS[i])


def test_tukeylambda_matches_jax_over_its_interval():
    """The JAX test's grid (the 1 - 2e-6 interval, 41 points) and the
    bounded support's edge, for each of its lambdas."""
    for lam in (0.5, -0.5, 0.14, 0.0, -2.0):
        jd, td = JD.TukeyLambda(lam=lam), TD.TukeyLambda(lam=lam)
        lo, hi = td.interval(1 - 2e-6)
        x = np.append(np.linspace(lo, hi, 41), [1.0 / lam + 0.1] if lam > 0 else [])
        want = np.asarray(jd.jax_logp(jnp.asarray(x, jnp.float64)))
        got = td.torch_logp(torch.as_tensor(x, dtype=torch.float64)).numpy()
        _assert_same(got, want, 1e-8, 1e-8, f"lam={lam}")


def test_registry_covers_reference_table():
    """All 105 aliases, each the JAX class's scipy family, in ``__all__``;
    none raises, and a model file's namespace gets them all."""
    assert TD.SCIPY_DIST_NAMES == JD.SCIPY_DIST_NAMES
    assert len(TD.SCIPY_DIST_NAMES) == 105
    for alias, name in JD.SCIPY_DIST_NAMES.items():
        cls = getattr(TD, alias)
        assert issubclass(cls, TD.Distribution) and cls.scipy_name == name
        assert alias in TD.__all__
        assert getattr(JD, alias).scipy_name == name
    with pytest.raises(ValueError, match="unknown prior family"):
        TD.from_name("NoSuchFamily")


@pytest.mark.parametrize("value", [1.6, 2.5, 0.5, 1.5, -0.4, np.array([0.5, 1.5, 2.7])])
def test_discrete_value_rounding(value):
    """A discrete prior's value rounds half to even to an int, as in the
    JAX package (1.6 -> 2, 2.5 -> 2)."""
    jd, td = JD.DiscreteUniform(low=0, high=3), TD.DiscreteUniform(low=0, high=3)
    jd.value = value
    td.value = value
    assert type(td.value) is type(jd.value)
    np.testing.assert_array_equal(td.value, jd.value)
    c = TD.Normal(loc=0.0, scale=1.0)
    c.value = value
    np.testing.assert_array_equal(c.value, value)  # a continuous one keeps it


@pytest.mark.parametrize("alias,kw", [
    ("Normal", dict(loc=5.0, scale=2.0)), ("TruncatedNormal", dict(a=-1, b=2)),
    ("Reciprocal", dict(a=2.0, b=12.0)), ("Poisson", dict(mu=3.0)),
    ("KSTwoSided", dict()), ("Uniform", dict(loc=np.array([1.0, 2.0]), scale=3.0)),
])
def test_median_and_interval(alias, kw):
    jd, td = getattr(JD, alias)(**kw), TD.from_name(alias, **kw)
    np.testing.assert_array_equal(td.median(), jd.median())
    np.testing.assert_array_equal(td.interval(0.95), jd.interval(0.95))
    # the port's start value is the median (the JAX package draws one)
    np.testing.assert_array_equal(td.value, td.median())
