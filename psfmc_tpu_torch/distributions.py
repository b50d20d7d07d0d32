"""Prior distributions (port of ``psfmc_tpu/distributions.py``, flagship subset).

The declaration API is the JAX package's: a prior wraps a frozen
``scipy.stats`` distribution under its descriptive alias and carries
``name``, ``fitsname``, ``value``, ``median()``, ``random(...)`` and
``logp`` (scipy, host).  The sampling path evaluates
:meth:`Distribution.torch_logp`, a PyTorch log-density with the frozen
hyperparameters baked in.

This slice ports the three families of the flagship model: ``Normal``,
``Uniform`` and ``WeibullMinimum``.  Every other alias of the JAX
package's name map raises ``NotImplementedError`` when it is looked up;
its density comes with the later slice of the remaining priors.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.stats as sps
import torch

__all__ = ["Distribution", "Normal", "Uniform", "WeibullMinimum",
           "SCIPY_DIST_NAMES"]

# Friendly alias -> scipy.stats name: the JAX package's map, so a model
# that names a family gets a clear "not yet ported" instead of an
# AttributeError.
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


# Standardized log-densities: fn(z, *shapes) of z = (x - loc) / scale;
# the caller subtracts log(scale).
def _lp_uniform(z):
    inside = (z >= 0) & (z <= 1)
    return torch.where(inside, torch.zeros_like(z), torch.full_like(z, -math.inf))


def _lp_norm(z):
    return -0.5 * z * z - 0.5 * _LOG_2PI


def _lp_weibull_min(z, c):
    zc = torch.clamp(z, min=1e-300 if z.dtype == torch.float64 else 1e-38)
    lp = math.log(c) + (c - 1.0) * torch.log(zc) - zc**c
    return torch.where(z > 0, lp, torch.full_like(z, -math.inf))


_TORCH_STD_LOGP = {
    "norm": _lp_norm,
    "uniform": _lp_uniform,
    "weibull_min": _lp_weibull_min,
}


class Distribution:
    """Prior wrapping a frozen scipy rv, with a PyTorch log-density."""

    scipy_name: str = ""

    def __init__(self, *args, **kwargs):
        self.rv_class = getattr(sps, type(self).scipy_name)
        self.rv_frozen = self.rv_class(*args, **kwargs)
        self.is_discrete = False
        shapes, loc, scale = self.rv_frozen.dist._parse_args(
            *self.rv_frozen.args, **self.rv_frozen.kwds
        )
        self._shapes = tuple(float(s) for s in shapes)
        self._loc = np.asarray(loc, dtype=np.float64)
        self._scale = np.asarray(scale, dtype=np.float64)
        self.name = ""
        self.fitsname = ""
        # the current value sizes the parameter slot; the median is a
        # deterministic member of the support (no global RNG draw)
        self._value = self.median()

    # -- host side ---------------------------------------------------------
    def random(self, random_state=None, size=None):
        return self.rv_frozen.rvs(size=size, random_state=random_state)

    def median(self):
        return self.rv_frozen.median()

    def logp(self, x):
        """Host-side scipy log-density."""
        return self.rv_frozen.logpdf(x)

    # -- sampling path -------------------------------------------------------
    def torch_params(self, dtype, device):
        """(loc, scale) as tensors, for :meth:`torch_logp` on a hot path."""
        return (
            torch.as_tensor(self._loc, dtype=dtype, device=device),
            torch.as_tensor(self._scale, dtype=dtype, device=device),
        )

    def torch_logp(self, x, params=None):
        """Log-density of ``x`` (any shape broadcasting with the
        hyperparameters), in ``x``'s dtype and device.  ``params`` is a
        cached :meth:`torch_params` pair (saves two host->device copies
        per call)."""
        fn = _TORCH_STD_LOGP[type(self).scipy_name]
        if params is None:
            params = self.torch_params(x.dtype, x.device)
        loc, scale = params
        z = (x - loc) / scale
        return fn(z, *self._shapes) - torch.log(scale)

    def get_value(self):
        return self._value

    def set_value(self, val):
        arr = np.asarray(val)
        self._value = arr.item() if arr.size == 1 else arr

    value = property(fget=get_value, fset=set_value)

    def __repr__(self):
        return (
            f"{type(self).__name__}(args={self.rv_frozen.args}, "
            f"kwds={self.rv_frozen.kwds})"
        )


class Normal(Distribution):
    """Normal prior (scipy.stats.norm)."""

    scipy_name = "norm"


class Uniform(Distribution):
    """Uniform prior (scipy.stats.uniform) on [loc, loc + scale]."""

    scipy_name = "uniform"


class WeibullMinimum(Distribution):
    """Weibull-minimum prior (scipy.stats.weibull_min)."""

    scipy_name = "weibull_min"


_PORTED = {"Normal": Normal, "Uniform": Uniform, "WeibullMinimum": WeibullMinimum}


def from_name(family, *args, **kwargs):
    """A prior by alias (``"Uniform"``) and its scipy arguments."""
    cls = _PORTED.get(family)
    if cls is None:
        __getattr__(family)  # raises with the reason
    return cls(*args, **kwargs)


def __getattr__(name):
    if name in SCIPY_DIST_NAMES:
        raise NotImplementedError(
            f"prior family {name!r} is not ported yet: this slice has "
            "Normal, Uniform and WeibullMinimum; the other densities come "
            "with the remaining-priors slice (ROADMAP Queue 1)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
