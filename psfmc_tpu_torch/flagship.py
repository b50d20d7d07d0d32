"""The flagship quasar/host workload, built with the port's components.

Sky + PointSource + 2 Sersic (18 free parameters) on a synthetic
observation of the flagship's shape: seed 0, a Gaussian PSF of sigma 2
px, noise sigma 0.005 around a 0.01 background, magnitude zeropoint
25.9463 and the flagship's priors (the synthetic branch of the JAX
package's ``__graft_entry__._flagship_components``).  The default size
is the flagship's 128x128 observation and 64x64 PSF; tests shrink it.
"""
from __future__ import annotations

import numpy as np

from . import distributions as D
from .models.components import Configuration, PointSource, Sersic, Sky

__all__ = ["flagship_components", "enforce_axis_order", "prior_draws"]


def flagship_components(shape=(128, 128), psf_shape=(64, 64), seed=0):
    """[Configuration, Sky, PointSource, Sersic, Sersic] of the flagship."""
    rng = np.random.RandomState(seed)
    h, w = shape
    ph, pw = psf_shape
    pyy, pxx = np.mgrid[0:ph, 0:pw].astype(float)
    psf = np.exp(-((pxx - pw / 2) ** 2 + (pyy - ph / 2) ** 2) / (2 * 2.0**2))
    psf /= psf.sum()
    psf_ivm = np.ones_like(psf) * 1e8
    obs = 0.01 + rng.randn(h, w) * 0.005
    ivm = np.ones_like(obs) / 0.005**2
    mag_zp = 25.9463

    total_mag = 20.66
    center = np.array((w / 2 + 0.5, h / 2 + 0.5))
    max_shift = np.array((8, 8))
    blob_center = np.array((0.36 * w, 0.67 * h))
    config = Configuration(
        obs_file=obs,
        obsivm_file=ivm,
        psf_files=psf,
        psfivm_files=psf_ivm,
        mag_zeropoint=mag_zp,
    )
    return [
        config,
        Sky(adu=D.Normal(loc=0, scale=0.01)),
        PointSource(
            xy=D.Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=D.Uniform(loc=total_mag - 0.2, scale=0.2 + 1.5),
        ),
        Sersic(
            xy=D.Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=D.Uniform(loc=total_mag, scale=27.5 - total_mag),
            reff=D.Uniform(loc=2.0, scale=10.0),
            reff_b=D.Uniform(loc=2.0, scale=10.0),
            index=D.WeibullMinimum(c=1.5, scale=4),
            angle=D.Uniform(loc=0, scale=180),
            angle_degrees=True,
        ),
        Sersic(
            xy=D.Uniform(loc=blob_center - 5, scale=10),
            mag=D.Uniform(loc=23.5, scale=2.0),
            reff=D.Uniform(loc=2.0, scale=6.0),
            reff_b=D.Uniform(loc=2.0, scale=6.0),
            index=D.WeibullMinimum(c=1.5, scale=4),
            angle=D.Uniform(loc=0, scale=180),
            angle_degrees=True,
        ),
    ]


def enforce_axis_order(p0, spec):
    """Swap reff/reff_b draws so every Sersic has reff >= reff_b."""
    by_name = {s.name: s for s in spec.slots}
    for name, slot in by_name.items():
        b = by_name.get(name + "_b") if name.endswith("_reff") else None
        if b is None:
            continue
        a_val = p0[:, slot.offset].copy()
        b_val = p0[:, b.offset].copy()
        p0[:, slot.offset] = np.maximum(a_val, b_val)
        p0[:, b.offset] = np.minimum(a_val, b_val)
    return p0


def prior_draws(spec, nwalkers, seed=0):
    """``(nwalkers, num_params)`` float64 draws from the priors, with the
    Sersic axis order enforced."""
    rng = np.random.RandomState(seed)
    cols = [
        np.asarray(s.dist.random(random_state=rng, size=(nwalkers,)
                                 + np.shape(s.dist.value)), float
                   ).reshape(nwalkers, s.size)
        for s in spec.slots
    ]
    return enforce_axis_order(np.concatenate(cols, axis=1), spec)
