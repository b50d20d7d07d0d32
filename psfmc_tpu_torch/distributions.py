"""Prior distributions (port of ``psfmc_tpu/distributions.py``).

The declaration API is the JAX package's: every ``scipy.stats`` family
of its name map (:data:`SCIPY_DIST_NAMES`, 105 aliases) is a class of
the same name; a prior wraps a frozen scipy distribution and carries
``name``, ``fitsname``, ``value`` (a discrete family's rounds half to
even to an ``int``), ``median()``, ``interval()``, ``random(...)`` and
``logp`` (scipy, host).  The sampling path evaluates
:meth:`Distribution.torch_logp`, a PyTorch log-density with the frozen
hyperparameters baked in, in the dtype and on the device of its input.

The densities are the JAX package's, one for one:

* 101 closed forms (``_TORCH_STD_LOGP``) of the standardized variable;
  constants that need scipy's special functions are computed once per
  prior on the host in float64 from the frozen hyperparameters; the
  noncentral chi-square and F families are Poisson-mixture logsumexps,
  the noncentral t a Gauss-Legendre quadrature, Skellam a host-sized
  Bessel series, and Tukey-lambda inverts its quantile function by 70
  bisection steps (a Python loop: a captured graph does not branch on
  data) with an implicit gradient (:class:`_TukeyInvert`);
* the four families with no closed form (``betaprime``, ``ksone``,
  ``kstwobign``, ``levy_stable``) evaluate a table of the host's scipy
  log-density (:class:`_LogpdfTable`): a gather and a cubic Hermite
  interpolation, with linear extrapolation in asinh coordinates and the
  support's mask;
* vector hyperparameters broadcast through the closed forms that take
  them; a closed form that bakes scalar host constants rejects them (a
  ``TypeError``, as in the JAX package) and the family falls through to
  one table per element, applied to column ``j`` of a ``(B, size)``
  batch;
* the last resort, a discrete family with vector hyperparameters (or a
  table that cannot be built), evaluates scipy on the host with the JAX
  package's warning.  That works on the CPU only: a host callback cannot
  run inside a CUDA graph, and the posterior refuses such a prior on
  CUDA when it is built (:meth:`Distribution.needs_host`).

Every array a density needs (hyperparameter vectors, tables and their
slopes, quadrature nodes and weights, mixture terms) is in the dict of
:meth:`Distribution.torch_params`, made once per prior; the posterior
registers them as buffers, so nothing in a density copies from the host.

A discrete family's density is that of ``round(x)`` (half to even, as
``torch.round`` and ``jnp.round`` both round): the ensemble moves treat
the parameter as continuous, and the posterior rounds the PSF index the
same way, so a walker's density and its PSF always agree.

A new prior's ``value`` starts at the family's median, where the JAX
package draws a random one: the value only sizes the parameter slot, and
the median needs no random state.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import scipy.special as _sspecial
import scipy.stats as sps
import torch

# Friendly alias -> scipy.stats name: the JAX package's map (the
# reference's table).
SCIPY_DIST_NAMES = {
    "Alpha": "alpha", "Anglit": "anglit", "Arcsine": "arcsine",
    "Beta": "beta", "BetaPrime": "betaprime", "Bradford": "bradford",
    "Burr3": "burr", "Burr12": "burr12", "Cauchy": "cauchy", "Chi": "chi",
    "ChiSquared": "chi2", "Cosine": "cosine", "DoubleGamma": "dgamma",
    "DoubleWeibull": "dweibull", "Erlang": "erlang",
    "Exponential": "expon", "ExponentialNormal": "exponnorm",
    "ExponentialWeibull": "exponweib", "ExponentialPower": "exponpow",
    "F": "f", "FatigueLife": "fatiguelife", "Fisk": "fisk",
    "FoldedCauchy": "foldcauchy", "FoldedNormal": "foldnorm",
    "GeneralLogistic": "genlogistic", "GeneralNormal": "gennorm",
    "GeneralPareto": "genpareto", "GeneralExponential": "genexpon",
    "GeneralExtreme": "genextreme", "GaussHypergeometric": "gausshyper",
    "Gamma": "gamma", "GeneralGamma": "gengamma",
    "GeneralHalfLogistic": "genhalflogistic", "Gilbrat": "gibrat",
    "Gompertz": "gompertz", "GumbelRight": "gumbel_r",
    "GumbelLeft": "gumbel_l", "HalfCauchy": "halfcauchy",
    "HalfLogistic": "halflogistic", "HalfNormal": "halfnorm",
    "HalfGeneralNormal": "halfgennorm", "HyperbolicSecant": "hypsecant",
    "InverseGamma": "invgamma", "InverseGaussian": "invgauss",
    "InverseWeibull": "invweibull", "JohnsonSB": "johnsonsb",
    "JohnsonSU": "johnsonsu", "Kappa4": "kappa4", "Kappa3": "kappa3",
    "KSOneSided": "ksone", "KSTwoSided": "kstwobign", "Laplace": "laplace",
    "Levy": "levy", "LevyLeft": "levy_l", "LevyStable": "levy_stable",
    "Logistic": "logistic", "LogGamma": "loggamma",
    "LogLaplace": "loglaplace", "LogNormal": "lognorm", "Lomax": "lomax",
    "Maxwell": "maxwell", "Mielke": "mielke", "Nakagami": "nakagami",
    "NonCentralChiSquared": "ncx2", "NonCentralF": "ncf",
    "NonCentralT": "nct", "Normal": "norm", "Pareto": "pareto",
    "PearsonType3": "pearson3", "PowerLaw": "powerlaw",
    "PowerLogNormal": "powerlognorm", "PowerNormal": "powernorm",
    "RDistributed": "rdist", "Reciprocal": "loguniform",
    "Rayleigh": "rayleigh", "Rice": "rice",
    "ReciprocalInverseGaussian": "recipinvgauss",
    "Semicircular": "semicircular", "SkewNormal": "skewnorm", "T": "t",
    "Trapezoidal": "trapezoid", "Triangular": "triang",
    "TruncatedExponential": "truncexpon", "TruncatedNormal": "truncnorm",
    "TukeyLambda": "tukeylambda", "Uniform": "uniform",
    "VonMises": "vonmises", "VonMisesLine": "vonmises_line", "Wald": "wald",
    "WeibullMinimum": "weibull_min", "WeibullMaximum": "weibull_max",
    "WrappedCauchy": "wrapcauchy",
    # discrete
    "Bernoulli": "bernoulli", "Binomial": "binom", "Boltzmann": "boltzmann",
    "DiscreteLaplace": "dlaplace", "Geometric": "geom",
    "Hypergeometric": "hypergeom", "LogSeries": "logser",
    "NegativeBinomial": "nbinom", "Planck": "planck", "Poisson": "poisson",
    "DiscreteUniform": "randint", "Skellam": "skellam", "Zipf": "zipf",
}

_LOG_2PI = math.log(2.0 * math.pi)
_TINY = 1e-300  # the JAX package's floor; 0 in float32 there and here
_INF = math.inf


# ---------------------------------------------------------------------------
# Helpers.  A hyperparameter is a Python float (a scalar, baked in) or a
# tensor (a vector, on the device); the dual functions compute a float's
# on the host in float64 and a tensor's on its device.
# ---------------------------------------------------------------------------

def _dual(host, device):
    def op(*args):
        if any(isinstance(a, torch.Tensor) for a in args):
            return device(*args)
        with np.errstate(all="ignore"):
            return float(host(*args))
    return op


_log = _dual(np.log, torch.log)
_log1p = _dual(np.log1p, torch.log1p)
_expm1 = _dual(np.expm1, torch.expm1)
_abs = _dual(np.abs, torch.abs)
_gammaln = _dual(_sspecial.gammaln, torch.special.gammaln)
_ndtr = _dual(_sspecial.ndtr, torch.special.ndtr)
_i0e = _dual(_sspecial.i0e, torch.special.i0e)


def _betaln(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return _gammaln(a) + _gammaln(b) - _gammaln(a + b)
    return float(_sspecial.betaln(a, b))


def _f(c):
    """``float(c)`` of a hyperparameter; a vector raises ``TypeError``, the
    JAX package's signal to fall through to per-element tables."""
    if isinstance(c, torch.Tensor):
        raise TypeError("a vector hyperparameter has no float()")
    return float(c)


def _maxc(c, v):
    return torch.clamp(c, min=v) if isinstance(c, torch.Tensor) else max(c, v)


def _full(v, like):
    return v if isinstance(v, torch.Tensor) else torch.full_like(like, v)


def _mask(cond, lp, like):
    """``lp`` where ``cond`` holds, else ``-inf``."""
    return torch.where(cond, _full(lp, like), -_INF)


def _lo(z):
    return torch.clamp(z, min=_TINY)


def _softplus(x):  # logaddexp(0, x)
    return torch.logaddexp(torch.zeros_like(x), x)


def _logphi(z):
    return -0.5 * z * z - 0.5 * _LOG_2PI


# ---------------------------------------------------------------------------
# Standardized log-densities: fn(z, *shapes) of z = (x - loc) / scale
# (continuous; the caller subtracts log(scale)) or z = k - loc (discrete).
# ---------------------------------------------------------------------------

def _lp_uniform(z):
    return _mask((z >= 0) & (z <= 1), 0.0, z)


def _lp_norm(z):
    return -0.5 * z * z - 0.5 * _LOG_2PI


def _lp_weibull_min(z, c):
    zc = _lo(z)
    return _mask(z > 0, _log(c) + (c - 1.0) * torch.log(zc) - zc**c, z)


def _lp_weibull_max(z, c):
    return _lp_weibull_min(-z, c)


def _lp_expon(z):
    return _mask(z >= 0, -z, z)


def _lp_gamma(z, a):
    zc = _lo(z)
    return _mask(z > 0, (a - 1.0) * torch.log(zc) - zc - _gammaln(a), z)


def _lp_beta(z, a, b):
    zc = torch.clamp(z, _TINY, 1 - 1e-16)
    lp = (a - 1.0) * torch.log(zc) + (b - 1.0) * torch.log1p(-zc) - _betaln(a, b)
    return _mask((z > 0) & (z < 1), lp, z)


def _lp_lognorm(z, s):
    lz = torch.log(_lo(z))
    lp = -(lz**2) / (2 * s * s) - lz - _log(s) - 0.5 * _LOG_2PI
    return _mask(z > 0, lp, z)


def _lp_laplace(z):
    return -torch.abs(z) - math.log(2.0)


def _lp_cauchy(z):
    return -math.log(math.pi) - torch.log1p(z * z)


def _lp_halfnorm(z):
    return _mask(z >= 0, 0.5 * math.log(2 / math.pi) - 0.5 * z * z, z)


def _lp_halfcauchy(z):
    return _mask(z >= 0, math.log(2 / math.pi) - torch.log1p(z * z), z)


def _lp_t(z, df):
    return (_gammaln((df + 1) / 2) - _gammaln(df / 2) - 0.5 * _log(df * math.pi)
            - (df + 1) / 2 * torch.log1p(z * z / df))


def _lp_chi2(z, df):
    zc = _lo(z)
    lp = ((df / 2 - 1) * torch.log(zc) - zc / 2 - (df / 2) * math.log(2.0)
          - _gammaln(df / 2))
    return _mask(z > 0, lp, z)


def _lp_invgamma(z, a):
    zc = _lo(z)
    return _mask(z > 0, -(a + 1) * torch.log(zc) - 1.0 / zc - _gammaln(a), z)


def _lp_rayleigh(z):
    return _mask(z >= 0, torch.log(_lo(z)) - z * z / 2, z)


def _lp_pareto(z, b):
    zc = torch.clamp(z, min=1.0)
    return _mask(z >= 1, _log(b) - (b + 1) * torch.log(zc), z)


def _lp_powerlaw(z, a):
    zc = torch.clamp(z, _TINY, 1.0)
    return _mask((z >= 0) & (z <= 1), _log(a) + (a - 1) * torch.log(zc), z)


def _lp_logistic(z):
    return -z - 2 * _softplus(-z)


def _lp_gumbel_r(z):
    return -z - torch.exp(-z)


def _lp_gumbel_l(z):
    return z - torch.exp(z)


def _lp_truncnorm(z, a, b):
    lognorm_const = _log(_ndtr(b) - _ndtr(a))
    lp = -0.5 * z * z - 0.5 * _LOG_2PI - lognorm_const
    return _mask((z >= a) & (z <= b), lp, z)


def _lp_truncexpon(z, b):
    return _mask((z >= 0) & (z <= b), -z - _log(-_expm1(-b)), z)


def _lp_vonmises(z, kappa):
    log_i0 = _log(_i0e(kappa)) + kappa
    return kappa * torch.cos(z) - _LOG_2PI - log_i0


def _lp_arcsine(z):
    zc = torch.clamp(z, _TINY, 1 - 1e-16)
    lp = -math.log(math.pi) - 0.5 * torch.log(zc * (1 - zc))
    return _mask((z > 0) & (z < 1), lp, z)


def _lp_triang(z, c):
    up = math.log(2.0) + torch.log(_lo(z)) - _log(_maxc(c, _TINY))
    down = (math.log(2.0) + torch.log(torch.clamp(1 - z, min=_TINY))
            - _log(_maxc(1 - c, _TINY)))
    lp = torch.where(z < c, up, down)
    return _mask((z >= 0) & (z <= 1), lp, z)


def _lp_loguniform(z, a, b):
    lp = -torch.log(_lo(z)) - _log(_log(b) - _log(a))
    return _mask((z >= a) & (z <= b), lp, z)


def _lp_maxwell(z):
    lp = math.log(math.sqrt(2 / math.pi)) + 2 * torch.log(_lo(z)) - z * z / 2
    return _mask(z >= 0, lp, z)


def _lp_wald(z):
    zc = _lo(z)
    lp = -0.5 * torch.log(2 * math.pi * zc**3) - (zc - 1) ** 2 / (2 * zc)
    return _mask(z > 0, lp, z)


def _lp_alpha(z, a):
    zc = _lo(z)
    lp = (-2.0 * torch.log(zc) - 0.5 * (a - 1.0 / zc) ** 2 - 0.5 * _LOG_2PI
          - np.log(float(_sspecial.ndtr(_f(a)))))
    return _mask(z > 0, lp, z)


def _lp_anglit(z):
    lp = torch.log(torch.clamp(torch.cos(2 * z), min=_TINY))
    return _mask(torch.abs(z) <= math.pi / 4, lp, z)


def _lp_bradford(z, c):
    lp = _log(c) - torch.log1p(c * z) - np.log(np.log1p(_f(c)))
    return _mask((z >= 0) & (z <= 1), lp, z)


def _lp_burr(z, c, d):
    lz = torch.log(_lo(z))
    lp = _log(c * d) - (c + 1.0) * lz - (d + 1.0) * torch.log1p(torch.exp(-c * lz))
    return _mask(z > 0, lp, z)


def _lp_burr12(z, c, d):
    lz = torch.log(_lo(z))
    lp = _log(c * d) + (c - 1.0) * lz - (d + 1.0) * _softplus(c * lz)
    return _mask(z > 0, lp, z)


def _lp_chi(z, df):
    lp = ((df - 1.0) * torch.log(_lo(z)) - z * z / 2
          - (df / 2 - 1.0) * math.log(2.0) - _gammaln(df / 2))
    return _mask(z > 0, lp, z)


def _lp_cosine(z):
    lp = torch.log(torch.clamp(1.0 + torch.cos(z), min=_TINY)) - _LOG_2PI
    return _mask(torch.abs(z) <= math.pi, lp, z)


def _lp_dgamma(z, a):
    az = torch.clamp(torch.abs(z), min=_TINY)
    lp = math.log(0.5) + (a - 1.0) * torch.log(az) - az - _gammaln(a)
    if _f(a) != 1.0:  # density 0 (a > 1) or divergent (a < 1) at z = 0
        lp = torch.where(z == 0, -_INF if _f(a) > 1.0 else _INF, lp)
    return lp


def _lp_dweibull(z, c):
    az = torch.clamp(torch.abs(z), min=_TINY)
    lp = _log(0.5 * c) + (c - 1.0) * torch.log(az) - az**c
    if _f(c) != 1.0:
        lp = torch.where(z == 0, -_INF if _f(c) > 1.0 else _INF, lp)
    return lp


def _lp_exponnorm(z, K):
    return (-_log(2.0 * K) + 1.0 / (2.0 * K * K) - z / K + math.log(2.0)
            + torch.special.log_ndtr(z - 1.0 / K))


def _lp_exponweib(z, a, c):
    lz = torch.log(_lo(z))
    zpc = torch.exp(c * lz)
    lp = (_log(a * c)
          + (a - 1.0) * torch.log(torch.clamp(-torch.expm1(-zpc), min=_TINY))
          - zpc + (c - 1.0) * lz)
    return _mask(z > 0, lp, z)


def _lp_exponpow(z, b):
    zc = _lo(z)
    zpb = zc**b
    lp = _log(b) + (b - 1.0) * torch.log(zc) + 1.0 + zpb - torch.exp(zpb)
    return _mask(z >= 0, lp, z)


def _lp_f(z, dfn, dfd):
    zc = _lo(z)
    lp = ((dfn / 2) * (_log(dfn) - _log(dfd)) + (dfn / 2 - 1.0) * torch.log(zc)
          - ((dfn + dfd) / 2) * torch.log1p(dfn * zc / dfd)
          - _betaln(dfn / 2, dfd / 2))
    return _mask(z > 0, lp, z)


def _lp_fatiguelife(z, c):
    zc = _lo(z)
    lp = (torch.log(zc + 1.0) - _log(2.0 * c) - 0.5 * _LOG_2PI - 1.5 * torch.log(zc)
          - (zc - 1.0) ** 2 / (2.0 * zc * c * c))
    return _mask(z > 0, lp, z)


def _lp_fisk(z, c):
    lz = torch.log(_lo(z))
    return _mask(z > 0, _log(c) + (c - 1.0) * lz - 2.0 * _softplus(c * lz), z)


def _lp_foldcauchy(z, c):
    lp = -math.log(math.pi) + torch.log(1.0 / (1.0 + (z - c) ** 2)
                                        + 1.0 / (1.0 + (z + c) ** 2))
    return _mask(z >= 0, lp, z)


def _lp_foldnorm(z, c):
    return _mask(z >= 0, torch.logaddexp(_logphi(z - c), _logphi(z + c)), z)


def _lp_genlogistic(z, c):
    return _log(c) - z - (c + 1.0) * _softplus(-z)


def _lp_gennorm(z, b):
    az = torch.clamp(torch.abs(z), min=_TINY)
    return _log(b / 2) - _gammaln(1.0 / b) - az**b


def _lp_halfgennorm(z, b):
    return _mask(z > 0, _log(b) - _gammaln(1.0 / b) - _lo(z) ** b, z)


def _lp_genpareto(z, c):
    c = _f(c)
    if abs(c) < 1e-12:
        return _lp_expon(z)
    # the JAX package's floor -1 + 1e-300 is -1.0 in floating point
    lp = -(1.0 + 1.0 / c) * torch.log1p(torch.clamp(c * z, min=-1.0 + 1e-300))
    inside = (z >= 0) if c > 0 else ((z >= 0) & (z <= -1.0 / c))
    return _mask(inside, lp, z)


def _lp_genextreme(z, c):
    c = _f(c)
    if abs(c) < 1e-12:
        return _lp_gumbel_r(z)
    # support 1 - c z > 0; log1p keeps the relative precision of c z that
    # the 1/c factor would amplify; the double where keeps the
    # out-of-support branch finite
    inside = 1.0 - c * z > 0
    logt = torch.where(inside, torch.log1p(torch.where(inside, -c * z, 0.0)),
                       math.log(1e-300))
    lp = -torch.exp(logt / c) + (1.0 / c - 1.0) * logt
    return _mask(inside, lp, z)


def _lp_genexpon(z, a, b, c):
    zc = torch.clamp(z, min=0.0)
    om = -torch.expm1(-c * zc)
    lp = torch.log(a + b * om) - a * zc - b * zc + b / c * om
    return _mask(z >= 0, lp, z)


def _lp_gengamma(z, a, c):
    lz = torch.log(_lo(z))
    lp = _log(_abs(c)) + (c * a - 1.0) * lz - torch.exp(c * lz) - _gammaln(a)
    return _mask(z > 0, lp, z)


def _lp_genhalflogistic(z, c):
    # log1p and the log(1e-300) floor at the closed edge z = 1/c, as in
    # the JAX package
    pos = 1.0 - c * z > 0
    logt = torch.where(pos, torch.log1p(torch.where(pos, -c * z, 0.0)),
                       math.log(1e-300))
    u = torch.exp(logt / c)
    lp = math.log(2.0) + (1.0 / c - 1.0) * logt - 2.0 * torch.log1p(u)
    return _mask((z >= 0) & (z <= 1.0 / c), lp, z)


def _lp_gibrat(z):
    return _lp_lognorm(z, 1.0)


def _lp_gompertz(z, c):
    return _mask(z >= 0, _log(c) + z - c * torch.expm1(z), z)


def _lp_halflogistic(z):
    return _mask(z >= 0, math.log(2.0) - z - 2.0 * _softplus(-z), z)


def _lp_hypsecant(z):
    return -math.log(math.pi) - (torch.logaddexp(z, -z) - math.log(2.0))


def _lp_invgauss(z, mu):
    zc = _lo(z)
    lp = -0.5 * _LOG_2PI - 1.5 * torch.log(zc) - (zc - mu) ** 2 / (2.0 * mu * mu * zc)
    return _mask(z > 0, lp, z)


def _lp_invweibull(z, c):
    lz = torch.log(_lo(z))
    return _mask(z > 0, _log(c) - (c + 1.0) * lz - torch.exp(-c * lz), z)


def _lp_johnsonsb(z, a, b):
    zc = torch.clamp(z, _TINY, 1 - 1e-16)
    u = a + b * (torch.log(zc) - torch.log1p(-zc))
    lp = _log(b) - torch.log(zc) - torch.log1p(-zc) + _logphi(u)
    return _mask((z > 0) & (z < 1), lp, z)


def _lp_johnsonsu(z, a, b):
    u = a + b * torch.asinh(z)
    return _log(b) - 0.5 * torch.log(z * z + 1.0) + _logphi(u)


def _lp_kappa3(z, a):
    lp = _log(a) - (a + 1.0) / a * torch.log(a + _lo(z) ** a)
    return _mask(z > 0, lp, z)


def _lp_levy(z):
    zc = _lo(z)
    return _mask(z > 0, -0.5 * _LOG_2PI - 1.5 * torch.log(zc) - 0.5 / zc, z)


def _lp_levy_l(z):
    return _lp_levy(-z)


def _lp_loggamma(z, c):
    return c * z - torch.exp(z) - _gammaln(c)


def _lp_loglaplace(z, c):
    lz = torch.log(_lo(z))
    lp = _log(c / 2) + torch.where(z < 1.0, (c - 1.0) * lz, -(c + 1.0) * lz)
    return _mask(z > 0, lp, z)


def _lp_lomax(z, c):
    return _mask(z >= 0, _log(c) - (c + 1.0) * torch.log1p(torch.clamp(z, min=0.0)), z)


def _lp_mielke(z, k, s):
    lz = torch.log(_lo(z))
    lp = _log(k) + (k - 1.0) * lz - (1.0 + k / s) * _softplus(s * lz)
    return _mask(z > 0, lp, z)


def _lp_nakagami(z, nu):
    lp = (math.log(2.0) + nu * _log(nu) - _gammaln(nu)
          + (2.0 * nu - 1.0) * torch.log(_lo(z)) - nu * z * z)
    return _mask(z > 0, lp, z)


def _lp_pearson3(z, skew):
    skew = _f(skew)
    if abs(skew) < 1e-8:
        return _lp_norm(z)
    alpha = 4.0 / (skew * skew)
    b = 2.0 / skew  # signed rate; a negative skew mirrors
    u = b * (z + alpha / b)
    uc = _lo(u)
    lp = math.log(abs(b)) + (alpha - 1.0) * torch.log(uc) - uc - _gammaln(alpha)
    return _mask(u > 0, lp, z)


def _lp_powerlognorm(z, c, s):
    zc = _lo(z)
    u = torch.log(zc) / s
    lp = (_log(c) - torch.log(zc) - _log(s) + _logphi(u)
          + (c - 1.0) * torch.special.log_ndtr(-u))
    return _mask(z > 0, lp, z)


def _lp_powernorm(z, c):
    return _log(c) + _logphi(z) + (c - 1.0) * torch.special.log_ndtr(-z)


def _lp_rdist(z, c):
    t = torch.clamp(1.0 - z * z, min=_TINY)
    lp = (c / 2 - 1.0) * torch.log(t) - _betaln(0.5, c / 2)
    return _mask(torch.abs(z) < 1, lp, z)


def _lp_recipinvgauss(z, mu):
    zc = _lo(z)
    lp = (-0.5 * _LOG_2PI - 0.5 * torch.log(zc)
          - (1.0 - mu * zc) ** 2 / (2.0 * mu * mu * zc))
    return _mask(z > 0, lp, z)


def _lp_rice(z, b):
    zc = _lo(z)
    x = zc * b  # log I0(x) = log(i0e(x)) + x
    lp = torch.log(zc) - (z * z + b * b) / 2 + torch.log(torch.special.i0e(x)) + x
    return _mask(z >= 0, lp, z)


def _lp_semicircular(z):
    t = torch.clamp(1.0 - z * z, min=_TINY)
    return _mask(torch.abs(z) <= 1, math.log(2.0 / math.pi) + 0.5 * torch.log(t), z)


def _lp_skewnorm(z, a):
    return math.log(2.0) + _logphi(z) + torch.special.log_ndtr(a * z)


def _lp_trapezoid(z, c, d):
    c, d = _f(c), _f(d)
    lu = math.log(2.0 / (d - c + 1.0))  # the flat top
    rising = lu + torch.log(_lo(z)) - math.log(max(c, _TINY))
    falling = lu + torch.log(torch.clamp(1.0 - z, min=_TINY)) - math.log(max(1.0 - d, _TINY))
    lp = torch.where(z < c, rising, torch.where(z <= d, lu, falling))
    return _mask((z >= 0) & (z <= 1), lp, z)


def _poisson_terms(lam):
    """The Poisson weights' k range (mass 1 - ~1e-18) and log weights."""
    k_lo = int(max(0, np.floor(lam - 14 * np.sqrt(lam + 1) - 30)))
    k_hi = int(np.ceil(lam + 14 * np.sqrt(lam + 1) + 30))
    k = np.arange(k_lo, k_hi + 1, dtype=np.float64)
    return k, -lam + k * np.log(lam) - _sspecial.gammaln(k + 1)


def _arr_ncx2(df, nc):
    lam = _f(nc) / 2.0
    if lam < 1e-12:
        return {}
    k, logw = _poisson_terms(lam)
    dfk = _f(df) + 2 * k
    return {"const": logw - (dfk / 2) * np.log(2.0) - _sspecial.gammaln(dfk / 2),
            "slope": dfk / 2 - 1.0}


def _lp_ncx2(z, df, nc, arr):
    # Poisson mixture: ncx2(df, nc) = sum_k Pois(k; nc/2) chi2(df + 2k),
    # the per-k constants host arrays, one logsumexp on the device
    if not arr:
        return _lp_chi2(z, df)
    zc = _lo(z)
    lz = torch.log(zc)
    lp = torch.logsumexp(arr["const"] + arr["slope"] * lz[..., None], dim=-1)
    return _mask(z > 0, lp - zc / 2, z)


def _arr_ncf(dfn, dfd, nc):
    dfn, dfd = _f(dfn), _f(dfd)
    lam = _f(nc) / 2.0
    if lam < 1e-12:
        return {}
    k, logw = _poisson_terms(lam)
    d1k = dfn + 2 * k
    const = (logw + (d1k / 2) * np.log(dfn / d1k)
             + (d1k / 2) * (np.log(d1k) - np.log(dfd))
             - _sspecial.betaln(d1k / 2, dfd / 2))
    return {"const": const, "a": dfn / 2 + k - 1.0, "b": (d1k + dfd) / 2}


def _lp_ncf(z, dfn, dfd, nc, arr):
    # the same mixture through the F ratio: one logsumexp over k
    dfn, dfd = _f(dfn), _f(dfd)
    if not arr:
        return _lp_f(z, dfn, dfd)
    zc = _lo(z)
    A = torch.log(zc)
    B = torch.log1p(dfn * zc / dfd)
    lp = torch.logsumexp(arr["const"] + arr["a"] * A[..., None]
                         - arr["b"] * B[..., None], dim=-1)
    return _mask(z > 0, lp, z)


def _nct_rule(nu, mu):
    y_hi = abs(mu) + 3.0 * np.sqrt(nu) + 14.0
    n_nodes = max(192, int(np.ceil(10 * y_hi)))
    yq, wq = np.polynomial.legendre.leggauss(n_nodes)
    yq = 0.5 * y_hi * (yq + 1.0)
    return yq, nu * np.log(np.maximum(yq, 1e-300)) + np.log(0.5 * y_hi * wq)


def _arr_nct(df, nc):
    nu, mu = _f(df), _f(nc)
    if abs(mu) < 1e-14:
        return {}
    yq, lwq = _nct_rule(nu, mu)
    return {"yq": yq, "lwq": lwq}


def _lp_nct(z, df, nc, arr):
    # all-positive Gauss-Legendre quadrature of the integral form (the
    # JAX package's derivation): b = mu t / sqrt(nu + t^2), A(b) =
    # int_0^inf y^nu exp(-(y - b)^2 / 2) dy on host-fixed nodes
    nu, mu = _f(df), _f(nc)
    if not arr:
        return _lp_t(z, nu)
    logK = (np.log(2.0) + (nu / 2) * np.log(nu / 2) - _sspecial.gammaln(nu / 2)
            - 0.5 * np.log(2 * np.pi))
    fac = nu + z * z
    b = mu * z / torch.sqrt(fac)
    logA = torch.logsumexp(arr["lwq"] - 0.5 * (arr["yq"] - b[..., None]) ** 2, dim=-1)
    return float(logK) - (nu + 1) / 2 * torch.log(fac) - 0.5 * (mu * mu - b * b) + logA


def _lp_kappa4(z, h, k):
    h, k = _f(h), _f(k)
    if abs(k) > 1e-12:
        t = 1.0 - k * z
        logu = torch.log(torch.clamp(t, min=_TINY)) / k
        in_k = t > 0
    else:
        logu = -z
        in_k = torch.ones_like(z, dtype=torch.bool)
    u = torch.exp(logu)
    if abs(h) > 1e-12:
        w = 1.0 - h * u
        tail = (1.0 / h - 1.0) * torch.log(torch.clamp(w, min=_TINY))
        in_h = (w > 0) if h > 0 else torch.ones_like(z, dtype=torch.bool)
    else:
        tail = -u
        in_h = torch.ones_like(z, dtype=torch.bool)
    return _mask(in_k & in_h, (1.0 - k) * logu + tail, z)


def _tukey_Q(p, lam):
    if abs(lam) < 1e-12:
        return torch.log(p) - torch.log1p(-p)
    return (p**lam - (1.0 - p) ** lam) / lam


def _tukey_Qp(p, lam):
    if abs(lam) < 1e-12:
        return 1.0 / (p * (1.0 - p))
    return p ** (lam - 1.0) + (1.0 - p) ** (lam - 1.0)


TUKEY_STEPS = 70  # bisection steps: p to float64 precision


class _TukeyInvert(torch.autograd.Function):
    """``p`` with ``Q(p) = x`` for the Tukey-lambda quantile function ``Q``.

    :data:`TUKEY_STEPS` bisection steps of a strictly increasing ``Q``,
    unrolled (no data-dependent branch: the step's CUDA graph records
    them).  The gradient is the implicit function theorem's ``dp/dx =
    1/Q'(p)``: differentiating the loop itself would give zero.
    """

    @staticmethod
    def forward(ctx, x, lam):
        with torch.no_grad():
            lo = torch.full_like(x, 1e-15)
            hi = torch.full_like(x, 1.0 - 1e-15)  # 1.0 in float32, as in JAX
            for _ in range(TUKEY_STEPS):
                mid = 0.5 * (lo + hi)
                below = _tukey_Q(mid, lam) < x
                lo = torch.where(below, mid, lo)
                hi = torch.where(below, hi, mid)
            p = 0.5 * (lo + hi)
        ctx.save_for_backward(p)
        ctx.lam = lam
        return p

    @staticmethod
    def backward(ctx, grad):
        (p,) = ctx.saved_tensors
        return grad / _tukey_Qp(p, ctx.lam), None


def _lp_tukeylambda(z, lam):
    # pdf(x) = 1 / Q'(F(x)), F by bisection
    lam = _f(lam)
    lp = -torch.log(_tukey_Qp(_TukeyInvert.apply(z, lam), lam))
    if lam > 0:  # bounded support |x| <= 1/lam
        lp = _mask(torch.abs(z) <= 1.0 / lam, lp, z)
    return lp


def _arr_skellam(mu1, mu2):
    x = 2.0 * np.sqrt(_f(mu1) * _f(mu2))
    m = np.arange(int(np.ceil(x + 12 * np.sqrt(x + 1) + 25)), dtype=np.float64)
    return {"m": m, "lgm": _sspecial.gammaln(m + 1)}


def _lp_skellam(z, mu1, mu2, arr):
    # pmf(k) = e^-(mu1+mu2) (mu1/mu2)^(k/2) I_k(2 sqrt(mu1 mu2)), I_|k| an
    # all-positive logsumexp over the host-truncated series
    mu1, mu2 = _f(mu1), _f(mu2)
    k = torch.round(z)
    lhalf = np.log(max(2.0 * np.sqrt(mu1 * mu2), 1e-300) / 2.0)
    ak = torch.abs(k)[..., None]
    a = ((2 * arr["m"] + ak) * float(lhalf) - arr["lgm"]
         - torch.special.gammaln(arr["m"] + ak + 1))
    return -(mu1 + mu2) + (k / 2.0) * math.log(mu1 / mu2) + torch.logsumexp(a, dim=-1)


def _lp_wrapcauchy(z, c):
    lp = (_log1p(-c * c) - _LOG_2PI
          - torch.log(1.0 + c * c - 2.0 * c * torch.cos(z)))
    return _mask((z >= 0) & (z <= 2 * math.pi), lp, z)


def _lp_gausshyper(z, a, b, c, zshape):
    # B(a, b) 2F1(c, a; a + b; -z), on the host
    lognorm = float(_sspecial.betaln(_f(a), _f(b))
                    + np.log(_sspecial.hyp2f1(_f(c), _f(a), _f(a) + _f(b), -_f(zshape))))
    zc = torch.clamp(z, _TINY, 1 - 1e-16)
    lp = ((a - 1.0) * torch.log(zc) + (b - 1.0) * torch.log1p(-zc)
          - c * torch.log1p(zshape * zc) - lognorm)
    return _mask((z > 0) & (z < 1), lp, z)


# discrete (z = k - loc)
def _lp_boltzmann(z, lam, N):
    k = torch.round(z)
    lam, N = _f(lam), _f(N)
    lp = np.log(-np.expm1(-lam)) - np.log(-np.expm1(-lam * N)) - lam * k
    return _mask((k >= 0) & (k <= N - 1), lp, z)


def _lp_dlaplace(z, a):
    return float(np.log(np.tanh(_f(a) / 2.0))) - a * torch.abs(torch.round(z))


def _lchoose(top, bot):
    return _gammaln(top + 1.0) - _gammaln(bot + 1.0) - _gammaln(top - bot + 1.0)


def _lp_hypergeom(z, M, n, N):
    k = torch.round(z)
    M, n, N = _f(M), _f(n), _f(N)
    lo, hi = max(0.0, N - (M - n)), min(n, N)
    kc = torch.clamp(k, lo, hi)
    lp = _lchoose(n, kc) + _lchoose(M - n, N - kc) - _lchoose(M, N)
    return _mask((k >= lo) & (k <= hi), lp, z)


def _lp_logser(z, p):
    k = torch.round(z)
    p = _f(p)
    kc = torch.clamp(k, min=1.0)
    lp = kc * math.log(p) - torch.log(kc) - float(np.log(-np.log1p(-p)))
    return _mask(k >= 1, lp, z)


def _lp_planck(z, lam):
    k = torch.round(z)
    lam = _f(lam)
    return _mask(k >= 0, float(np.log(-np.expm1(-lam))) - lam * k, z)


def _lp_zipf(z, a):
    k = torch.round(z)
    a = _f(a)
    kc = torch.clamp(k, min=1.0)
    return _mask(k >= 1, -a * torch.log(kc) - math.log(_sspecial.zeta(a, 1.0)), z)


def _lp_randint(z, low, high):
    k = torch.round(z)
    return _mask((k >= low) & (k <= high - 1), -_log(high - low), z)


def _lp_poisson(z, mu):
    k = torch.round(z)
    return _mask(k >= 0, k * _log(mu) - mu - torch.special.gammaln(k + 1), z)


def _lp_bernoulli(z, p):
    k = torch.round(z)
    lp = torch.where(k == 1, _full(_log(p), z), _full(_log1p(-p), z))
    return _mask((k == 0) | (k == 1), lp, z)


def _lp_binom(z, n, p):
    k = torch.round(z)
    lp = (_gammaln(n + 1) - torch.special.gammaln(k + 1)
          - torch.special.gammaln(n - k + 1) + k * _log(p) + (n - k) * _log1p(-p))
    return _mask((k >= 0) & (k <= n), lp, z)


def _lp_geom(z, p):
    k = torch.round(z)
    return _mask(k >= 1, (k - 1) * _log1p(-p) + _log(p), z)


def _lp_nbinom(z, n, p):
    k = torch.round(z)
    lp = (torch.special.gammaln(k + n) - torch.special.gammaln(k + 1) - _gammaln(n)
          + n * _log(p) + k * _log1p(-p))
    return _mask(k >= 0, lp, z)


_TORCH_STD_LOGP = {
    "uniform": _lp_uniform, "norm": _lp_norm, "weibull_min": _lp_weibull_min,
    "weibull_max": _lp_weibull_max, "expon": _lp_expon, "gamma": _lp_gamma,
    "erlang": _lp_gamma, "beta": _lp_beta, "lognorm": _lp_lognorm,
    "laplace": _lp_laplace, "cauchy": _lp_cauchy, "halfnorm": _lp_halfnorm,
    "halfcauchy": _lp_halfcauchy, "t": _lp_t, "chi2": _lp_chi2,
    "invgamma": _lp_invgamma, "rayleigh": _lp_rayleigh, "pareto": _lp_pareto,
    "powerlaw": _lp_powerlaw, "logistic": _lp_logistic, "gumbel_r": _lp_gumbel_r,
    "gumbel_l": _lp_gumbel_l, "truncnorm": _lp_truncnorm,
    "truncexpon": _lp_truncexpon, "vonmises": _lp_vonmises,
    "vonmises_line": _lp_vonmises, "arcsine": _lp_arcsine, "triang": _lp_triang,
    "loguniform": _lp_loguniform, "maxwell": _lp_maxwell, "wald": _lp_wald,
    "randint": _lp_randint, "poisson": _lp_poisson, "bernoulli": _lp_bernoulli,
    "binom": _lp_binom, "geom": _lp_geom, "nbinom": _lp_nbinom,
    "alpha": _lp_alpha, "anglit": _lp_anglit, "bradford": _lp_bradford,
    "burr": _lp_burr, "burr12": _lp_burr12, "chi": _lp_chi, "cosine": _lp_cosine,
    "dgamma": _lp_dgamma, "dweibull": _lp_dweibull, "exponnorm": _lp_exponnorm,
    "exponweib": _lp_exponweib, "exponpow": _lp_exponpow, "f": _lp_f,
    "fatiguelife": _lp_fatiguelife, "fisk": _lp_fisk,
    "foldcauchy": _lp_foldcauchy, "foldnorm": _lp_foldnorm,
    "genlogistic": _lp_genlogistic, "gennorm": _lp_gennorm,
    "halfgennorm": _lp_halfgennorm, "genpareto": _lp_genpareto,
    "genextreme": _lp_genextreme, "genexpon": _lp_genexpon,
    "gengamma": _lp_gengamma, "genhalflogistic": _lp_genhalflogistic,
    "gibrat": _lp_gibrat, "gompertz": _lp_gompertz,
    "halflogistic": _lp_halflogistic, "hypsecant": _lp_hypsecant,
    "invgauss": _lp_invgauss, "invweibull": _lp_invweibull,
    "johnsonsb": _lp_johnsonsb, "johnsonsu": _lp_johnsonsu, "kappa3": _lp_kappa3,
    "levy": _lp_levy, "levy_l": _lp_levy_l, "loggamma": _lp_loggamma,
    "loglaplace": _lp_loglaplace, "lomax": _lp_lomax, "mielke": _lp_mielke,
    "nakagami": _lp_nakagami, "pearson3": _lp_pearson3,
    "powerlognorm": _lp_powerlognorm, "powernorm": _lp_powernorm,
    "rdist": _lp_rdist, "recipinvgauss": _lp_recipinvgauss, "rice": _lp_rice,
    "semicircular": _lp_semicircular, "skewnorm": _lp_skewnorm,
    "trapezoid": _lp_trapezoid, "wrapcauchy": _lp_wrapcauchy,
    "gausshyper": _lp_gausshyper,
    "ncx2": _lp_ncx2, "ncf": _lp_ncf, "nct": _lp_nct, "kappa4": _lp_kappa4,
    "tukeylambda": _lp_tukeylambda, "skellam": _lp_skellam,
    "boltzmann": _lp_boltzmann, "dlaplace": _lp_dlaplace,
    "hypergeom": _lp_hypergeom, "logser": _lp_logser, "planck": _lp_planck,
    "zipf": _lp_zipf,
}
# the closed forms whose host arrays (mixture terms, quadrature rule,
# series) ride in torch_params; their fn takes them as a last argument
_HOST_ARRAYS = {"ncx2": _arr_ncx2, "ncf": _arr_ncf, "nct": _arr_nct,
                "skellam": _arr_skellam}


class _LogpdfTable:
    """Tabulated log-density of a frozen rv with no closed form.

    The JAX package's host build, step for step: ``n`` points uniform in
    ``t = asinh((x - median) / s)`` (``s = IQR / 1.349``) over the
    ``[eps, 1 - eps]`` quantile range, each edge pushed out by bisection
    probes until the log-density nears the float64 floor, and the
    Catmull-Rom slopes of the host's scipy log-density.  The device side
    (:meth:`__call__`) is a gather plus a cubic Hermite interpolation,
    linear extrapolation in ``t`` outside the grid (a power law in
    ``|x|``) and ``-inf`` outside the support.
    """

    def __init__(self, rv_frozen, n=4096, eps=1e-12):
        med = float(rv_frozen.median())
        iqr = float(rv_frozen.ppf(0.75) - rv_frozen.ppf(0.25))
        self.s = max(iqr / 1.349, 1e-12)
        self.med = med
        xlo = float(rv_frozen.ppf(eps))
        xhi = float(rv_frozen.isf(eps))
        if not (np.isfinite(xlo) and np.isfinite(xhi) and xhi > xlo):
            raise ValueError("quantile range is not finite")
        t0 = np.arcsinh((xlo - med) / self.s)
        t1 = np.arcsinh((xhi - med) / self.s)
        a, b = rv_frozen.support()

        def _probe(t):
            x = med + self.s * np.sinh(t)
            with np.errstate(all="ignore"):
                v = float(rv_frozen.logpdf(x))
            return np.isfinite(v) and v > -700.0

        def _extend(t_edge, sign_hi):
            target = 3.0 * t_edge
            bound = b if sign_hi else a
            if np.isfinite(bound):
                t_bound = np.arcsinh((float(bound) - med) / self.s)
                target = min(target, t_bound) if sign_hi else max(target, t_bound)
            if _probe(target):
                return target
            good, bad = t_edge, target
            for _ in range(20):
                mid = 0.5 * (good + bad)
                if _probe(mid):
                    good = mid
                else:
                    bad = mid
            return good

        t0, t1 = _extend(t0, False), _extend(t1, True)
        x = med + self.s * np.sinh(np.linspace(t0, t1, n))
        with np.errstate(all="ignore"):
            v = np.asarray(rv_frozen.logpdf(x), dtype=np.float64)
        v[~np.isfinite(v)] = -745.0
        v = np.clip(v, -745.0, None)
        slope = np.empty_like(v)
        slope[1:-1] = (v[2:] - v[:-2]) / 2
        slope[0] = v[1] - v[0]
        slope[-1] = v[-1] - v[-2]
        self.t0, self.dt, self.n = float(t0), float((t1 - t0) / (n - 1)), n
        self.v, self.slope = v, slope
        # the true support: extrapolation must not leak outside it
        self.lo = float(a) if np.isfinite(a) else -np.inf
        self.hi = float(b) if np.isfinite(b) else np.inf

    def __call__(self, x, v, mm):
        """The log-density of ``x`` from the device copies ``v`` and ``mm``
        of :attr:`v` and :attr:`slope`."""
        t = torch.asinh((x - self.med) / self.s)
        u = (t - self.t0) / self.dt
        # a NaN x takes row 0 (and ends -inf below): no index leaves the table
        i = torch.clamp(torch.nan_to_num(torch.floor(u), nan=0.0), 0,
                        self.n - 2).to(torch.int64)
        w = u - i
        v0, v1, m0, m1 = v[i], v[i + 1], mm[i], mm[i + 1]
        w2, w3 = w * w, w * w * w
        val = ((2 * w3 - 3 * w2 + 1) * v0 + (w3 - 2 * w2 + w) * m0
               + (-2 * w3 + 3 * w2) * v1 + (w3 - w2) * m1)
        lo_val = v[0] + u * mm[0]
        hi_val = v[self.n - 1] + (u - (self.n - 1)) * mm[self.n - 1]
        val = torch.where(u < 0, lo_val, torch.where(u > self.n - 1, hi_val, val))
        return torch.where((x >= self.lo) & (x <= self.hi), val, -_INF)


class _Plan:
    """How a prior's density evaluates: ``kind`` is ``"closed"`` (``fn``
    with ``shapes``, each a float or the key of a vector in the params,
    and the host ``arrays``), ``"tables"`` (one table for the whole
    variable, or one per element of a ``(B, size)`` batch) or ``"host"``
    (scipy on the host: the CPU only)."""

    def __init__(self, kind, fn=None, shapes=(), arrays=None, tables=()):
        self.kind, self.fn, self.shapes = kind, fn, shapes
        self.arrays = arrays or {}
        self.tables = tables


class Distribution:
    """Prior wrapping a frozen scipy rv, with a PyTorch log-density.

    Subclasses, one per alias of :data:`SCIPY_DIST_NAMES`, are made by
    :func:`_make_dist_class`.
    """

    scipy_name: str = ""

    def __init__(self, *args, **kwargs):
        self.rv_class = getattr(sps, type(self).scipy_name)
        self.rv_frozen = self.rv_class(*args, **kwargs)
        self.is_discrete = isinstance(self.rv_frozen.dist, sps.rv_discrete)
        if not self.is_discrete and not isinstance(self.rv_frozen.dist,
                                                   sps.rv_continuous):
            raise TypeError(
                "Only rv_continuous and rv_discrete distributions are supported")
        parsed = self.rv_frozen.dist._parse_args(
            *self.rv_frozen.args, **self.rv_frozen.kwds)
        if self.is_discrete:
            shapes, loc, scale = parsed[0], parsed[1], 1.0
        else:
            shapes, loc, scale = parsed
        self._shapes = tuple(np.asarray(s, dtype=np.float64) for s in shapes)
        self._loc = np.asarray(loc, dtype=np.float64)
        self._scale = np.asarray(scale, dtype=np.float64)
        self.name = ""
        self.fitsname = ""
        self._plans = {}
        # the value sizes the parameter slot; the median is a deterministic
        # member of the support (no global RNG draw)
        self._value = self.median()

    # -- host side ---------------------------------------------------------
    def random(self, random_state=None, size=None):
        return self.rv_frozen.rvs(size=size, random_state=random_state)

    def median(self):
        return self.rv_frozen.median()

    def interval(self, confidence):
        """The central interval holding ``confidence`` of the mass."""
        return self.rv_frozen.interval(confidence)

    def logp(self, x):
        """Host-side scipy log-density (a discrete family's of ``rint(x)``)."""
        if self.is_discrete:
            return self.rv_frozen.logpmf(np.rint(np.asarray(x)))
        return self.rv_frozen.logpdf(x)

    # -- sampling path -------------------------------------------------------
    def _slot_size(self):
        return int(np.size(self._value))

    def _plan(self, size=None):
        """The evaluation plan for a variable of ``size`` elements (by
        default the value's), made once on the host (the JAX package's
        order of fall-through)."""
        size = self._slot_size() if size is None else size
        plan = self._plans.get(size)
        if plan is None:
            plan = self._plans[size] = self._make_plan(size)
        return plan

    def _make_plan(self, size):
        name = type(self).scipy_name
        fn = _TORCH_STD_LOGP.get(name)
        if fn is not None:
            # a scalar hyperparameter is a float, a vector an array
            host = [s.item() if s.size == 1 else s for s in self._shapes]
            vector = [isinstance(h, np.ndarray) for h in host]
            try:
                arrays = _HOST_ARRAYS[name](*host) if name in _HOST_ARRAYS else None
                if any(vector):
                    # a closed form that bakes scalar host constants raises
                    # TypeError for a vector, as under the JAX trace
                    args = [torch.as_tensor(h) if v else h for h, v in zip(host, vector)]
                    if arrays is not None:
                        args.append({k: torch.as_tensor(a) for k, a in arrays.items()})
                    fn(torch.zeros((1, size), dtype=torch.float64), *args)
                shapes = tuple(f"shape{j}" if v else h
                               for j, (h, v) in enumerate(zip(host, vector)))
                return _Plan("closed", fn, shapes, arrays)
            except TypeError:
                pass
        params = (*self._shapes, self._loc, self._scale)
        if not self.is_discrete and all(np.ndim(p) == 0 for p in params):
            try:
                return _Plan("tables", tables=(_LogpdfTable(self.rv_frozen),))
            except Exception:  # a non-finite quantile range, ...
                pass
        elif not self.is_discrete and all(np.ndim(p) <= 1 for p in params):
            try:
                *shapes_b, loc_b, scale_b = (
                    np.broadcast_to(np.asarray(p, np.float64), (size,)) for p in params)
                return _Plan("tables", tables=tuple(
                    _LogpdfTable(self.rv_class(*(s[j] for s in shapes_b),
                                               loc=loc_b[j], scale=scale_b[j]))
                    for j in range(size)))
            except Exception:  # a non-finite quantile range, a bad broadcast
                pass
        return _Plan("host")

    def needs_host(self, size=None):
        """Whether the density evaluates scipy on the host (a discrete
        family with vector hyperparameters, or a table that could not be
        built): such a prior runs on the CPU only."""
        return self._plan(size).kind == "host"

    def torch_params(self, dtype, device, size=None):
        """Every device constant of :meth:`torch_logp` for a variable of
        ``size`` elements (by default the value's): ``loc``, ``scale``, the
        vector hyperparameters, the host arrays of a closed form and the
        tables with their slopes, as a dict of tensors."""
        plan = self._plan(size)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)

        out = {"loc": t(self._loc), "scale": t(self._scale)}
        if plan.kind == "closed":
            for s, host in zip(plan.shapes, self._shapes):
                if isinstance(s, str):
                    out[s] = t(host)
            for key, arr in plan.arrays.items():
                out["arr_" + key] = t(arr)
        elif plan.kind == "tables":
            out["tab_v"] = t(np.stack([tab.v for tab in plan.tables]))
            out["tab_slope"] = t(np.stack([tab.slope for tab in plan.tables]))
        return out

    def torch_logp(self, x, params=None):
        """Log-density of ``x`` (``(..., size)`` for a vector prior, any
        shape for a scalar one), in ``x``'s dtype and on its device.
        ``params`` is the dict of :meth:`torch_params` (the posterior's
        buffers); without it the constants are made here."""
        plan = self._plan()
        if params is None:
            params = self.torch_params(x.dtype, x.device)
        if plan.kind == "host":
            return self._host_logp(x)
        if plan.kind == "tables":
            v, mm = params["tab_v"], params["tab_slope"]
            if len(plan.tables) == 1:
                return plan.tables[0](x, v[0], mm[0])
            return torch.stack([tab(x[..., j], v[j], mm[j])
                                for j, tab in enumerate(plan.tables)], dim=-1)
        shapes = [params[s] if isinstance(s, str) else s for s in plan.shapes]
        if type(self).scipy_name in _HOST_ARRAYS:
            shapes.append({k: params["arr_" + k] for k in plan.arrays})
        loc, scale = params["loc"], params["scale"]
        if self.is_discrete:
            return plan.fn(x - loc, *shapes)
        return plan.fn((x - loc) / scale, *shapes) - torch.log(scale)

    def _host_logp(self, x):
        """The last resort: scipy on the host, the CPU only."""
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"{type(self).__name__} with vector hyperparameters has no "
                "device-side log-density: its prior evaluates scipy on the host, "
                "which a CUDA graph cannot call (run it with device='cpu')")
        warnings.warn(
            f"{type(self).__name__} has no device-side log-density; its prior "
            "evaluates through a host callback into scipy, which runs on the "
            "CPU only (a CUDA graph cannot call the host).  Prefer a family "
            "with a device-side density.")
        host = np.asarray(self.logp(x.detach().numpy()), dtype=np.float64)
        return torch.as_tensor(host, dtype=x.dtype)

    # -- mutable current value (reference semantics) ---------------------
    def get_value(self):
        return self._value

    def set_value(self, val):
        if self.is_discrete:
            val = np.rint(val).astype(int)
        arr = np.asarray(val)
        self._value = arr.item() if arr.size == 1 else arr

    value = property(fget=get_value, fset=set_value)

    def __repr__(self):
        return (f"{type(self).__name__}(args={self.rv_frozen.args}, "
                f"kwds={self.rv_frozen.kwds})")


def _make_dist_class(alias, scipy_name):
    if not hasattr(sps, scipy_name):
        return None
    return type(alias, (Distribution,), {
        "scipy_name": scipy_name,
        "__doc__": f"{alias} prior (scipy.stats.{scipy_name}).",
    })


_CLASSES = {}
for _alias, _scipy_name in SCIPY_DIST_NAMES.items():
    _cls = _make_dist_class(_alias, _scipy_name)
    if _cls is not None:
        _CLASSES[_alias] = globals()[_alias] = _cls

__all__ = ["Distribution", "SCIPY_DIST_NAMES", "from_name", *_CLASSES]


def from_name(family, *args, **kwargs):
    """A prior by alias (``"Uniform"``) and its scipy arguments."""
    cls = _CLASSES.get(family)
    if cls is None:
        raise ValueError(f"unknown prior family {family!r}: one of "
                         f"{sorted(_CLASSES)}")
    return cls(*args, **kwargs)
