"""The flagship quasar/host workload, built with the port's components.

Sky + PointSource + 2 Sersic (18 free parameters) on a synthetic
observation of the flagship's shape: seed 0, a Gaussian PSF of sigma 2
px, noise sigma 0.005 around a 0.01 background, magnitude zeropoint
25.9463 and the flagship's priors (the synthetic branch of the JAX
package's ``__graft_entry__._flagship_components``).  The default size
is the flagship's 128x128 observation and 64x64 PSF; tests shrink it.
:func:`write_flagship_files` writes the same inputs as FITS files, a
ds9 mask and a model file, for the model-file driver.
"""
from __future__ import annotations

import os

import numpy as np

from . import distributions as D
from .models.components import Configuration, PointSource, Sersic, Sky

__all__ = ["flagship_arrays", "flagship_components", "write_flagship_files",
           "enforce_axis_order", "prior_draws"]

MAG_ZP = 25.9463
TOTAL_MAG = 20.66


def flagship_arrays(shape=(128, 128), psf_shape=(64, 64), seed=0):
    """The flagship's observation, IVM, PSF and PSF-IVM arrays."""
    rng = np.random.RandomState(seed)
    h, w = shape
    ph, pw = psf_shape
    pyy, pxx = np.mgrid[0:ph, 0:pw].astype(float)
    psf = np.exp(-((pxx - pw / 2) ** 2 + (pyy - ph / 2) ** 2) / (2 * 2.0**2))
    psf /= psf.sum()
    obs = 0.01 + rng.randn(h, w) * 0.005
    return {"obs": obs, "ivm": np.ones_like(obs) / 0.005**2, "psf": psf,
            "psf_ivm": np.ones_like(psf) * 1e8}


def _prior_args(shape):
    """The flagship's prior centers and widths for a ``shape`` image."""
    h, w = shape
    return {"center": np.array((w / 2 + 0.5, h / 2 + 0.5)),
            "max_shift": np.array((8, 8)),
            "blob_center": np.array((0.36 * w, 0.67 * h))}


def flagship_components(shape=(128, 128), psf_shape=(64, 64), seed=0):
    """[Configuration, Sky, PointSource, Sersic, Sersic] of the flagship."""
    arrays = flagship_arrays(shape, psf_shape, seed)
    a = _prior_args(shape)
    center, max_shift, blob_center = a["center"], a["max_shift"], a["blob_center"]
    config = Configuration(
        obs_file=arrays["obs"],
        obsivm_file=arrays["ivm"],
        psf_files=arrays["psf"],
        psfivm_files=arrays["psf_ivm"],
        mag_zeropoint=MAG_ZP,
    )
    return [
        config,
        Sky(adu=D.Normal(loc=0, scale=0.01)),
        PointSource(
            xy=D.Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=D.Uniform(loc=TOTAL_MAG - 0.2, scale=0.2 + 1.5),
        ),
        Sersic(
            xy=D.Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=D.Uniform(loc=TOTAL_MAG, scale=27.5 - TOTAL_MAG),
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


_MODEL_FILE = """\
# The flagship quasar + host model: Sky + PointSource + 2 Sersic.
from numpy import array

from psfMC.ModelComponents import Configuration, PointSource, Sersic, Sky
from psfMC.distributions import Normal, Uniform, WeibullMinimum

center = array({center})
max_shift = array({max_shift})
blob_center = array({blob_center})

Configuration(obs_file="sci.fits", obsivm_file="ivm.fits",
              psf_files="psf.fits", psfivm_files="psf_ivm.fits",
              mask_file="mask.reg", mag_zeropoint={mag_zp!r})
Sky(adu=Normal(loc=0, scale=0.01))
PointSource(xy=Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=Uniform(loc={total_mag!r} - 0.2, scale=0.2 + 1.5))
Sersic(xy=Uniform(loc=center - max_shift, scale=2 * max_shift),
       mag=Uniform(loc={total_mag!r}, scale=27.5 - {total_mag!r}),
       reff=Uniform(loc=2.0, scale=10.0), reff_b=Uniform(loc=2.0, scale=10.0),
       index=WeibullMinimum(c=1.5, scale=4), angle=Uniform(loc=0, scale=180),
       angle_degrees=True)
Sersic(xy=Uniform(loc=blob_center - 5, scale=10),
       mag=Uniform(loc=23.5, scale=2.0),
       reff=Uniform(loc=2.0, scale=6.0), reff_b=Uniform(loc=2.0, scale=6.0),
       index=WeibullMinimum(c=1.5, scale=4), angle=Uniform(loc=0, scale=180),
       angle_degrees=True)
"""


def write_flagship_files(directory, shape=(128, 128), psf_shape=(64, 64),
                         seed=0):
    """Write the flagship's inputs to ``directory`` as a user would hold
    them: ``sci.fits``, ``ivm.fits``, ``psf.fits``, ``psf_ivm.fits``
    (the port's FITS codec), a ds9 mask ``mask.reg`` with one ``circle``
    (the fit region) and one ``-circle`` (an excluded neighbour), and the
    model file ``model.py`` (18 free parameters).  Returns the model
    file's path."""
    from .io import fits

    arrays = flagship_arrays(shape, psf_shape, seed)
    for name, key in (("sci", "obs"), ("ivm", "ivm"), ("psf", "psf"),
                      ("psf_ivm", "psf_ivm")):
        fits.writeto(os.path.join(directory, name + ".fits"), arrays[key])
    h, w = shape
    with open(os.path.join(directory, "mask.reg"), "w") as fh:
        fh.write("# Region file format: DS9\nimage\n"
                 f"circle({w / 2 + 0.5:g},{h / 2 + 0.5:g},{0.45 * min(h, w):g})\n"
                 f"-circle({0.2 * w:g},{0.85 * h:g},{0.05 * min(h, w):g})\n")
    a = _prior_args(shape)
    text = _MODEL_FILE.format(
        center=tuple(a["center"].tolist()),
        max_shift=tuple(a["max_shift"].tolist()),
        blob_center=tuple(a["blob_center"].tolist()),
        mag_zp=MAG_ZP, total_mag=TOTAL_MAG)
    path = os.path.join(directory, "model.py")
    with open(path, "w") as fh:
        fh.write(text)
    return path


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
