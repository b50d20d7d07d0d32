"""The flagship quasar/host workload, built with the port's components.

Sky + PointSource + 2 Sersic (18 free parameters) on a synthetic
observation of the flagship's shape: seed 0, a Gaussian PSF of sigma 2
px, noise sigma 0.005 around a 0.01 background, magnitude zeropoint
25.9463 and the flagship's priors (the synthetic branch of the JAX
package's ``__graft_entry__._flagship_components``).  The default size
is the flagship's 128x128 observation and 64x64 PSF; tests shrink it.
:func:`write_flagship_files` writes the same inputs as FITS files, a
ds9 mask and a model file, for the model-file driver.

The general flagship (:func:`general_components`,
:func:`write_general_files`) is the same model on the features that only
the general likelihood path runs: several PSF stars with a sampled
``PSF_Index``, a sky with a ``dx``/``dy`` gradient and a ``NoiseScale``,
and, by keyword, the Configuration's likelihood, padding and
oversampling options (with ``counts=True``, a Poisson observation of
non-negative counts).

The family flagship (:func:`family_components`,
:func:`write_family_files`) is a GALFIT-style bulge + disk + AGN
decomposition on the render family: Sky + PointSource + a de
Vaucouleurs bulge and an exponential disk both centred on the point
source (``Tied(ps, "xy")``), the disk boxy (a ``c0`` prior) and
truncated (``rtrunc``/``rsoft``); its variants (:data:`FAMILY_VARIANTS`)
swap the disk for each other profile family or shape.

The priors flagship (:func:`priors_components`, :func:`write_priors_files`)
is the flagship's sources with priors as a user writes them:
``TruncatedNormal`` positions with a vector ``loc``, ``Reciprocal``
sizes, a ``Gamma`` and a ``TruncatedNormal`` index, ``Triangular`` and
``SkewNormal`` magnitudes.  Its variants (:data:`PRIORS_VARIANTS`) are a
stress set that reaches each mechanism of the prior densities (the
Tukey-lambda bisection, the noncentral t's quadrature, the noncentral
chi-square's Poisson mixture, a table, per-element tables of a vector
hyperparameter, a discrete family) and a general-path model with two
PSF stars and a ``LogNormal`` ``NoiseScale``.

The MAP flagship (:func:`map_truth`, :func:`write_map_files`,
:func:`joint_map_components`) is the flagship (and the joint flagship)
with an observation simulated from a truth inside the priors
(``simulate`` on the CPU in float64, seed 0, the flagship's noise of
0.005 around a 0.01 sky): the flagship's own observation is pure noise,
on which a MAP fit has nothing to find.

The GALFIT flagship (:func:`galfit_feedme`, :func:`write_galfit_files`)
is the MAP flagship as a GALFIT user hands it over: a ``.feedme`` with a
sky (its gradients fixed at 0), a ``psf`` and two ``sersic`` objects at
the MAP truth in GALFIT's conventions (1-based positions, position angle
= angle - 90, axis ratio ``q``), the host started on the point source,
the zeropoint ``J)`` and a plate scale ``K)``, and a ``G)`` constraint
file coupling the host's position to the point source's at zero offset
(the importer's ``Tied``), beside the MAP flagship's FITS files.

The joint flagship (:func:`joint_components`, :func:`write_joint_files`)
is a two-band quasar/host decomposition: band 0 is the flagship with a
TAN WCS at 0.03"/px; band 1 a 96x96 observation with its own PSF star,
the same pixel scale, its WCS rotated by 20 degrees about a shifted
reference pixel, its own Sky, and the flagship's three sources seen
again: each position tied to band 0's in sky frame, the Sersics' sizes
and index tied to band 0's in pixel frame, the magnitudes and the
Sersics' angles free (24 free parameters).  Its variants
(:data:`JOINT_VARIANTS`) put both bands on the general path (two PSF
stars each with a sampled index, a ``NoiseScale`` in band 1), add a
registration offset to a sky tie, or run the general bands under the
tiled render.
"""
from __future__ import annotations

import os

import numpy as np

from . import distributions as D
from .models.components import Configuration, PointSource, Sersic, Sky

__all__ = ["flagship_arrays", "flagship_components", "write_flagship_files",
           "general_arrays", "general_components", "write_general_files",
           "FAMILY_VARIANTS", "family_lnpost", "family_components",
           "write_family_files", "PRIORS_VARIANTS", "priors_components",
           "write_priors_files", "JOINT_VARIANTS", "joint_headers",
           "joint_components", "write_joint_files", "enforce_axis_order",
           "prior_draws", "map_truth", "write_map_files", "joint_map_components",
           "GALFIT_PLATE_SCALE", "galfit_feedme", "write_galfit_files"]

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


def _sources(shape, C, Dist):
    """The flagship's PointSource and two Sersics, built from the classes
    of the modules ``C`` (components) and ``Dist`` (distributions)."""
    a = _prior_args(shape)
    center, max_shift, blob_center = a["center"], a["max_shift"], a["blob_center"]
    return [
        C.PointSource(
            xy=Dist.Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=Dist.Uniform(loc=TOTAL_MAG - 0.2, scale=0.2 + 1.5),
        ),
        C.Sersic(
            xy=Dist.Uniform(loc=center - max_shift, scale=2 * max_shift),
            mag=Dist.Uniform(loc=TOTAL_MAG, scale=27.5 - TOTAL_MAG),
            reff=Dist.Uniform(loc=2.0, scale=10.0),
            reff_b=Dist.Uniform(loc=2.0, scale=10.0),
            index=Dist.WeibullMinimum(c=1.5, scale=4),
            angle=Dist.Uniform(loc=0, scale=180),
            angle_degrees=True,
        ),
        C.Sersic(
            xy=Dist.Uniform(loc=blob_center - 5, scale=10),
            mag=Dist.Uniform(loc=23.5, scale=2.0),
            reff=Dist.Uniform(loc=2.0, scale=6.0),
            reff_b=Dist.Uniform(loc=2.0, scale=6.0),
            index=Dist.WeibullMinimum(c=1.5, scale=4),
            angle=Dist.Uniform(loc=0, scale=180),
            angle_degrees=True,
        ),
    ]


def flagship_components(shape=(128, 128), psf_shape=(64, 64), seed=0):
    """[Configuration, Sky, PointSource, Sersic, Sersic] of the flagship."""
    from .models import components

    arrays = flagship_arrays(shape, psf_shape, seed)
    config = Configuration(
        obs_file=arrays["obs"],
        obsivm_file=arrays["ivm"],
        psf_files=arrays["psf"],
        psfivm_files=arrays["psf_ivm"],
        mag_zeropoint=MAG_ZP,
    )
    return [config, Sky(adu=D.Normal(loc=0, scale=0.01))] + _sources(
        shape, components, D)


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


PSF_SIGMAS = (2.0, 2.4, 1.7)  # the general flagship's PSF stars, in px
COUNTS_SKY = 20.0  # counts per pixel of the Poisson observation


def general_arrays(shape=(128, 128), psf_shape=(64, 64), num_psfs=2, seed=0,
                   counts=False):
    """The general flagship's observation, IVM, PSFs and PSF IVMs: the
    flagship's arrays with ``num_psfs`` Gaussian PSF stars of the widths
    :data:`PSF_SIGMAS`; with ``counts``, Poisson counts around
    :data:`COUNTS_SKY` per pixel."""
    arrays = flagship_arrays(shape, psf_shape, seed)
    ph, pw = psf_shape
    pyy, pxx = np.mgrid[0:ph, 0:pw].astype(float)
    psfs = []
    for sigma in PSF_SIGMAS[:num_psfs]:
        psf = np.exp(-((pxx - pw / 2) ** 2 + (pyy - ph / 2) ** 2) / (2 * sigma**2))
        psfs.append(psf / psf.sum())
    if counts:
        arrays["obs"] = np.random.RandomState(seed + 1).poisson(
            COUNTS_SKY, size=shape).astype(float)
    arrays["psfs"] = psfs
    arrays["psf_ivms"] = [arrays["psf_ivm"]] * num_psfs
    return arrays


def general_components(shape=(128, 128), psf_shape=(64, 64), num_psfs=2,
                       seed=0, gradient=True, noise_scale=True, counts=False,
                       components=None, distributions=None, **config):
    """[Configuration, Sky, PointSource, Sersic, Sersic, NoiseScale] of the
    general flagship; ``config`` goes to the Configuration (``likelihood``,
    ``conv_pad``, ...).  ``components`` and ``distributions`` are the
    modules whose classes build it (by default the port's: every class
    used here has the same name and arguments in the JAX package)."""
    if components is None:
        from .models import components
    if distributions is None:
        from . import distributions
    C, Dist = components, distributions
    arrays = general_arrays(shape, psf_shape, num_psfs, seed, counts)
    sky = (Dist.Uniform(loc=COUNTS_SKY - 5.0, scale=10.0) if counts
           else Dist.Normal(loc=0, scale=0.01))
    slope = {}
    if gradient:
        slope = dict(dx=Dist.Normal(loc=0, scale=1e-4),
                     dy=Dist.Normal(loc=0, scale=1e-4))
    comps = [
        C.Configuration(obs_file=arrays["obs"], obsivm_file=arrays["ivm"],
                        psf_files=arrays["psfs"], psfivm_files=arrays["psf_ivms"],
                        mag_zeropoint=MAG_ZP, **config),
        C.Sky(adu=sky, **slope),
    ] + _sources(shape, C, Dist)
    if noise_scale:
        comps.append(C.NoiseScale(scale=Dist.Uniform(loc=0.5, scale=1.0)))
    return comps


_GENERAL_MODEL_FILE = _MODEL_FILE.replace(
    "Configuration(obs_file=\"sci.fits\", obsivm_file=\"ivm.fits\",\n"
    "              psf_files=\"psf.fits\", psfivm_files=\"psf_ivm.fits\",",
    "Configuration(obs_file=\"sci.fits\", obsivm_file=\"ivm.fits\",\n"
    "              psf_files={psf_files}, psfivm_files={psf_ivm_files},",
).replace(
    "from psfMC.ModelComponents import Configuration, PointSource, Sersic, Sky",
    "from psfMC.ModelComponents import (Configuration, NoiseScale, PointSource,\n"
    "                                   Sersic, Sky)",
).replace(
    "Sky(adu=Normal(loc=0, scale=0.01))",
    "Sky(adu=Normal(loc=0, scale=0.01), dx=Normal(loc=0, scale=1e-4),\n"
    "    dy=Normal(loc=0, scale=1e-4))",
).replace(
    "# The flagship quasar + host model: Sky + PointSource + 2 Sersic.",
    "# The general flagship: two PSF stars, a sky gradient and a NoiseScale.",
) + "NoiseScale(scale=Uniform(loc=0.5, scale=1.0))\n"


def write_general_files(directory, shape=(128, 128), psf_shape=(64, 64),
                        num_psfs=2, seed=0):
    """Write the general flagship's inputs to ``directory``: the
    flagship's files with the PSF stars ``psf0.fits``, ``psf1.fits``, ...
    (and their IVMs) in place of ``psf.fits``, and a model file whose
    Configuration lists them, whose Sky has a ``dx``/``dy`` gradient and
    which ends in a ``NoiseScale``.  Returns the model file's path."""
    from .io import fits

    write_flagship_files(directory, shape, psf_shape, seed)
    for name in ("psf.fits", "psf_ivm.fits"):
        os.remove(os.path.join(directory, name))
    arrays = general_arrays(shape, psf_shape, num_psfs, seed)
    names = [f"psf{i}.fits" for i in range(num_psfs)]
    ivm_names = [f"psf{i}_ivm.fits" for i in range(num_psfs)]
    for i in range(num_psfs):
        fits.writeto(os.path.join(directory, names[i]), arrays["psfs"][i])
        fits.writeto(os.path.join(directory, ivm_names[i]), arrays["psf_ivms"][i])
    a = _prior_args(shape)
    text = _GENERAL_MODEL_FILE.format(
        center=tuple(a["center"].tolist()),
        max_shift=tuple(a["max_shift"].tolist()),
        blob_center=tuple(a["blob_center"].tolist()),
        mag_zp=MAG_ZP, total_mag=TOTAL_MAG, psf_files=names,
        psf_ivm_files=ivm_names)
    path = os.path.join(directory, "model.py")
    with open(path, "w") as fh:
        fh.write(text)
    return path

# the family flagship's variants: each keeps Sky + PointSource + the tied
# bulge and swaps the disk for what its name says
FAMILY_VARIANTS = ("flagship", "moffat", "king", "ferrer", "nuker", "edgedisk",
                   "sersic-modes", "gaussian", "offset-tie", "oversample",
                   "fused", "general")


def family_lnpost(variant):
    """The likelihood path a variant is fitted on: ``"fused"`` (under
    ``PSFMC_LNPOST=pallas``) for the elliptical bulge + disk, ``"general"``
    for the two-PSF variant, else ``"batched"`` (the default path)."""
    return {"fused": "fused", "general": "general"}.get(variant, "batched")


def _family_sources(shape, variant, C, Dist):
    """The PointSource, the bulge tied to it and the variant's disk."""
    a = _prior_args(shape)
    center, max_shift, blob = a["center"], a["max_shift"], a["blob_center"]
    ps = C.PointSource(
        xy=Dist.Uniform(loc=center - max_shift, scale=2 * max_shift),
        mag=Dist.Uniform(loc=TOTAL_MAG - 0.2, scale=0.2 + 1.5))
    U = Dist.Uniform

    # each component gets priors of its own: a prior names one trace column
    def ang():
        return dict(angle=U(loc=0, scale=180), angle_degrees=True)

    def disk_axes():
        return dict(mag=U(loc=21.0, scale=3.0), reff=U(loc=3.0, scale=9.0),
                    reff_b=U(loc=2.0, scale=6.0), **ang())

    def trunc():
        return dict(rtrunc=U(loc=15.0, scale=15.0), rsoft=U(loc=1.0, scale=2.0))

    def boxy():
        return dict(c0=U(loc=0.0, scale=0.5))

    def off_center():
        return dict(xy=U(loc=blob - 5, scale=10), mag=U(loc=22.0, scale=3.0), **ang())

    def moffat():
        return C.Moffat(fwhm=U(loc=3.0, scale=5.0), fwhm_b=U(loc=2.0, scale=4.0),
                        index=U(loc=1.5, scale=2.5), c0=U(loc=-0.3, scale=0.8),
                        **trunc(), **off_center())

    def nuker():
        return C.Nuker(rb=U(loc=2.0, scale=4.0), rb_b=U(loc=1.5, scale=3.0),
                       alpha=U(loc=1.0, scale=2.0), beta=U(loc=2.5, scale=2.0),
                       gamma=U(loc=0.1, scale=0.8), c0=U(loc=-0.2, scale=0.5),
                       **off_center())

    bulge = C.DeVaucouleurs(xy=C.Tied(ps, "xy"), mag=U(loc=TOTAL_MAG, scale=2.5),
                            reff=U(loc=1.0, scale=4.0), reff_b=U(loc=1.0, scale=4.0),
                            **ang())
    if variant in ("flagship", "offset-tie"):
        xy = C.Tied(ps, "xy")
        if variant == "offset-tie":
            xy = C.Tied(ps, "xy", offset=Dist.Normal(loc=[0.0, 0.0], scale=0.5))
        disk = [C.ExpDisk(xy=xy, **disk_axes(), **boxy(), **trunc())]
    elif variant in ("fused", "general"):
        # elliptical on the fused kernel; boxy beside two PSFs
        disk = [C.ExpDisk(xy=C.Tied(ps, "xy"), **disk_axes(),
                          **(boxy() if variant == "general" else {}))]
    elif variant == "gaussian":
        disk = [C.Gaussian(xy=C.Tied(ps, "xy"), **disk_axes())]
    elif variant == "sersic-modes":
        disk = [C.Sersic(
            xy=C.Tied(ps, "xy"), index=U(loc=0.7, scale=1.5), **disk_axes(),
            f1=U(loc=-0.2, scale=0.4), f1_phi=U(loc=0, scale=180),
            f3=U(loc=-0.2, scale=0.4), f3_phi=U(loc=0, scale=120),
            b2=U(loc=-0.1, scale=0.2), rot_ang=U(loc=30, scale=90),
            rot_out=U(loc=6.0, scale=6.0), rot_in=1.0,
            rot_pow=U(loc=0.5, scale=1.0))]
    elif variant == "moffat":
        disk = [moffat()]
    elif variant == "king":
        disk = [C.King(rc=U(loc=2.0, scale=3.0),
                       rc_b=U(loc=1.5, scale=2.5),
                       rt=U(loc=12.0, scale=10.0),
                       alpha=U(loc=1.5, scale=1.0),
                       c0=U(loc=-0.3, scale=0.6), **off_center())]
    elif variant == "ferrer":
        disk = [C.Ferrer(rout=U(loc=6.0, scale=6.0),
                         rout_b=U(loc=3.0, scale=4.0),
                         alpha=U(loc=1.0, scale=2.0),
                         beta=U(loc=0.0, scale=1.5),
                         f2=U(loc=-0.1, scale=0.2), **off_center())]
    elif variant == "nuker":
        disk = [nuker()]
    elif variant == "edgedisk":
        disk = [C.EdgeDisk(xy=C.Tied(ps, "xy"), mag=U(loc=21.0, scale=3.0),
                           rs=U(loc=3.0, scale=6.0),
                           hs=U(loc=0.5, scale=2.0), **ang())]
    elif variant == "oversample":
        disk = [nuker(), moffat()]
    else:
        raise ValueError(f"unknown family variant {variant!r}; one of "
                         f"{FAMILY_VARIANTS}")
    return [ps, bulge] + disk


def family_components(shape=(128, 128), psf_shape=(64, 64), variant="flagship",
                      seed=0, components=None, distributions=None, **config):
    """[Configuration, Sky, PointSource, DeVaucouleurs, <disk>...] of the
    family flagship or one of its :data:`FAMILY_VARIANTS`; ``config`` goes
    to the Configuration.  The ``oversample`` variant renders with
    ``render_oversample=4`` and the ``general`` one sees two PSF stars.
    ``components`` and ``distributions`` are the modules whose classes
    build it (by default the port's; the JAX package's have the same
    names and arguments)."""
    if components is None:
        from .models import components
    if distributions is None:
        from . import distributions
    C, Dist = components, distributions
    num_psfs = 2 if variant == "general" else 1
    arrays = general_arrays(shape, psf_shape, num_psfs, seed)
    if variant == "oversample":
        config = dict(dict(render_oversample=4), **config)
    return [
        C.Configuration(obs_file=arrays["obs"], obsivm_file=arrays["ivm"],
                        psf_files=arrays["psfs"], psfivm_files=arrays["psf_ivms"],
                        mag_zeropoint=MAG_ZP, **config),
        C.Sky(adu=Dist.Normal(loc=0, scale=0.01)),
    ] + _family_sources(shape, variant, C, Dist)


_FAMILY_MODEL_FILE = """\
# The family flagship: a bulge + disk + AGN decomposition.  The bulge and
# the disk are centred on the point source; the disk is boxy and truncated.
from numpy import array

from psfMC.ModelComponents import (Configuration, DeVaucouleurs, ExpDisk,
                                   PointSource, Sky, Tied)
from psfMC.distributions import Normal, Uniform

center = array({center})
max_shift = array({max_shift})

Configuration(obs_file="sci.fits", obsivm_file="ivm.fits",
              psf_files="psf.fits", psfivm_files="psf_ivm.fits",
              mask_file="mask.reg", mag_zeropoint={mag_zp!r})
Sky(adu=Normal(loc=0, scale=0.01))
agn = PointSource(xy=Uniform(loc=center - max_shift, scale=2 * max_shift),
                  mag=Uniform(loc={total_mag!r} - 0.2, scale=0.2 + 1.5))
agn
DeVaucouleurs(xy=Tied(agn, "xy"), mag=Uniform(loc={total_mag!r}, scale=2.5),
              reff=Uniform(loc=1.0, scale=4.0), reff_b=Uniform(loc=1.0, scale=4.0),
              angle=Uniform(loc=0, scale=180), angle_degrees=True)
ExpDisk(xy=Tied(agn, "xy"), mag=Uniform(loc=21.0, scale=3.0),
        reff=Uniform(loc=3.0, scale=9.0), reff_b=Uniform(loc=2.0, scale=6.0),
        angle=Uniform(loc=0, scale=180), angle_degrees=True,
        c0=Uniform(loc=0.0, scale=0.5),
        rtrunc=Uniform(loc=15.0, scale=15.0), rsoft=Uniform(loc=1.0, scale=2.0))
"""


def write_family_files(directory, shape=(128, 128), psf_shape=(64, 64), seed=0):
    """Write the family flagship's inputs to ``directory``: the flagship's
    FITS files and ds9 mask (:func:`write_flagship_files`) and a model
    file ``model.py`` that imports ``ExpDisk``, ``DeVaucouleurs`` and
    ``Tied`` from ``psfMC.ModelComponents`` and declares the components of
    ``family_components(shape, psf_shape)``, with the mask.  Returns its
    path."""
    path = write_flagship_files(directory, shape, psf_shape, seed)
    a = _prior_args(shape)
    with open(path, "w") as fh:
        fh.write(_FAMILY_MODEL_FILE.format(
            center=tuple(a["center"].tolist()),
            max_shift=tuple(a["max_shift"].tolist()),
            mag_zp=MAG_ZP, total_mag=TOTAL_MAG))
    return path


PRIORS_VARIANTS = ("flagship", "stress", "general")


def _priors_sources(shape, variant, C, Dist):
    """The flagship's PointSource and two Sersics with the priors of a
    :data:`PRIORS_VARIANTS` entry."""
    a = _prior_args(shape)
    center, max_shift, blob = a["center"], a["max_shift"], a["blob_center"]
    U = Dist.Uniform

    def tn_xy(loc, half):  # a truncated Normal of sigma half/2 within +-half
        return Dist.TruncatedNormal(a=-2.0, b=2.0, loc=loc, scale=half / 2.0)

    def angle():
        return dict(angle=U(loc=0, scale=180), angle_degrees=True)

    if variant == "stress":
        return [
            C.PointSource(xy=U(loc=center - max_shift, scale=2 * max_shift),
                          mag=Dist.NonCentralT(df=5.0, nc=0.5, loc=TOTAL_MAG,
                                               scale=0.3)),
            C.Sersic(xy=U(loc=center - max_shift, scale=2 * max_shift),
                     mag=U(loc=TOTAL_MAG, scale=27.5 - TOTAL_MAG),
                     reff=Dist.NonCentralChiSquared(df=4.0, nc=2.0, loc=2.0,
                                                    scale=1.0),
                     reff_b=U(loc=2.0, scale=10.0),
                     index=Dist.KSTwoSided(loc=0.5, scale=2.0), **angle()),
            C.Sersic(xy=Dist.KSOneSided(n=np.array([20, 30]), loc=blob - 3.0,
                                        scale=25.0),
                     mag=U(loc=23.5, scale=2.0), reff=U(loc=2.0, scale=6.0),
                     reff_b=U(loc=2.0, scale=6.0),
                     index=Dist.Binomial(n=6, p=0.4, loc=1), **angle()),
        ]
    return [
        C.PointSource(xy=tn_xy(center, max_shift),
                      mag=Dist.Triangular(c=0.3, loc=TOTAL_MAG - 0.2, scale=1.7)),
        C.Sersic(xy=tn_xy(center, max_shift),
                 mag=Dist.SkewNormal(a=3.0, loc=TOTAL_MAG + 0.3, scale=1.5),
                 reff=Dist.Reciprocal(a=2.0, b=12.0),
                 reff_b=Dist.Reciprocal(a=2.0, b=12.0),
                 index=Dist.Gamma(a=4.0, scale=0.75), **angle()),
        C.Sersic(xy=tn_xy(blob, np.array((5.0, 5.0))),
                 mag=Dist.Triangular(c=0.5, loc=23.5, scale=2.0),
                 reff=Dist.Reciprocal(a=2.0, b=8.0),
                 reff_b=Dist.Reciprocal(a=2.0, b=8.0),
                 index=Dist.TruncatedNormal(a=-2.0, b=2.0, loc=2.5, scale=1.0),
                 **angle()),
    ]


def priors_components(shape=(128, 128), psf_shape=(64, 64), variant="flagship",
                      seed=0, components=None, distributions=None, **config):
    """[Configuration, Sky, PointSource, Sersic, Sersic(, NoiseScale)] of the
    priors flagship or one of its :data:`PRIORS_VARIANTS`: ``stress`` puts
    a Tukey-lambda prior on the sky, ``general`` sees two PSF stars (a
    sampled ``PSF_Index``) and adds a ``LogNormal`` ``NoiseScale``.
    ``config`` goes to the Configuration; ``components`` and
    ``distributions`` are the modules whose classes build it (by default
    the port's; the JAX package's have the same names and arguments)."""
    if components is None:
        from .models import components
    if distributions is None:
        from . import distributions
    C, Dist = components, distributions
    if variant not in PRIORS_VARIANTS:
        raise ValueError(f"unknown priors variant {variant!r}; one of "
                         f"{PRIORS_VARIANTS}")
    arrays = general_arrays(shape, psf_shape, 2 if variant == "general" else 1, seed)
    sky = (Dist.TukeyLambda(lam=0.14, loc=0.0, scale=0.01) if variant == "stress"
           else Dist.Normal(loc=0, scale=0.01))
    comps = [
        C.Configuration(obs_file=arrays["obs"], obsivm_file=arrays["ivm"],
                        psf_files=arrays["psfs"], psfivm_files=arrays["psf_ivms"],
                        mag_zeropoint=MAG_ZP, **config),
        C.Sky(adu=sky),
    ] + _priors_sources(shape, variant, C, Dist)
    if variant == "general":
        comps.append(C.NoiseScale(scale=Dist.LogNormal(s=0.3)))
    return comps


_PRIORS_MODEL_FILE = """\
# The priors flagship: the quasar + host model with the priors a user
# writes: truncated-Normal positions, log-uniform sizes, a Gamma and a
# truncated-Normal Sersic index, skewed magnitudes.
from numpy import array

from psfMC.ModelComponents import Configuration, PointSource, Sersic, Sky
from psfMC.distributions import (Gamma, Normal, Reciprocal, SkewNormal,
                                 Triangular, TruncatedNormal, Uniform)

center = array({center})
max_shift = array({max_shift})
blob_center = array({blob_center})

Configuration(obs_file="sci.fits", obsivm_file="ivm.fits",
              psf_files="psf.fits", psfivm_files="psf_ivm.fits",
              mask_file="mask.reg", mag_zeropoint={mag_zp!r})
Sky(adu=Normal(loc=0, scale=0.01))
PointSource(xy=TruncatedNormal(a=-2.0, b=2.0, loc=center, scale=max_shift / 2.0),
            mag=Triangular(c=0.3, loc={total_mag!r} - 0.2, scale=1.7))
Sersic(xy=TruncatedNormal(a=-2.0, b=2.0, loc=center, scale=max_shift / 2.0),
       mag=SkewNormal(a=3.0, loc={total_mag!r} + 0.3, scale=1.5),
       reff=Reciprocal(a=2.0, b=12.0), reff_b=Reciprocal(a=2.0, b=12.0),
       index=Gamma(a=4.0, scale=0.75), angle=Uniform(loc=0, scale=180),
       angle_degrees=True)
Sersic(xy=TruncatedNormal(a=-2.0, b=2.0, loc=blob_center, scale=2.5),
       mag=Triangular(c=0.5, loc=23.5, scale=2.0),
       reff=Reciprocal(a=2.0, b=8.0), reff_b=Reciprocal(a=2.0, b=8.0),
       index=TruncatedNormal(a=-2.0, b=2.0, loc=2.5, scale=1.0),
       angle=Uniform(loc=0, scale=180), angle_degrees=True)
"""


def write_priors_files(directory, shape=(128, 128), psf_shape=(64, 64), seed=0):
    """Write the priors flagship's inputs to ``directory``: the flagship's
    FITS files and ds9 mask (:func:`write_flagship_files`) and a model file
    ``model.py`` that declares ``priors_components(shape, psf_shape)``'s
    sources with the priors imported from ``psfMC.distributions``, with the
    mask.  Returns its path."""
    path = write_flagship_files(directory, shape, psf_shape, seed)
    a = _prior_args(shape)
    with open(path, "w") as fh:
        fh.write(_PRIORS_MODEL_FILE.format(
            center=tuple(a["center"].tolist()),
            max_shift=tuple(a["max_shift"].tolist()),
            blob_center=tuple(a["blob_center"].tolist()),
            mag_zp=MAG_ZP, total_mag=TOTAL_MAG))
    return path


JOINT_VARIANTS = ("flagship", "general", "offset", "tiled")
JOINT_SHAPES = ((128, 128), (96, 96))  # the two bands' observations
PIXEL_SCALE = 0.03 / 3600.0  # degrees per pixel, both bands
JOINT_CRVAL = (150.1163, 2.2058)
JOINT_ROTATION = 20.0  # band 1's WCS against band 0's, in degrees
JOINT_CRPIX_SHIFT = (3.0, -2.0)  # band 1's reference pixel off its center
JOINT_PSF_SIGMAS = ((2.0, 2.4), (2.4, 2.9))  # each band's PSF stars, px


def joint_headers(shapes=JOINT_SHAPES):
    """The two bands' WCS cards (dicts of TAN cards): band 0 north up at
    :data:`PIXEL_SCALE` with its reference pixel at the image center;
    band 1 rotated by :data:`JOINT_ROTATION` about a reference pixel
    :data:`JOINT_CRPIX_SHIFT` off its center, at the same sky position."""
    out = []
    for band, (h, w) in enumerate(shapes):
        rot = np.deg2rad(JOINT_ROTATION * band)
        dx, dy = JOINT_CRPIX_SHIFT if band else (0.0, 0.0)
        c, s_ = np.cos(rot) * PIXEL_SCALE, np.sin(rot) * PIXEL_SCALE
        out.append({"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN",
                    "CRPIX1": w / 2 + 0.5 + dx, "CRPIX2": h / 2 + 0.5 + dy,
                    "CRVAL1": JOINT_CRVAL[0], "CRVAL2": JOINT_CRVAL[1],
                    "CD1_1": -c, "CD1_2": s_, "CD2_1": s_, "CD2_2": c})
    return out


def _joint_arrays(shapes, psf_shape, num_psfs, seed):
    """Each band's observation, IVM, PSF stars and PSF IVMs: the flagship's
    noise model, band ``b`` from seed ``seed + b``, with the PSF widths of
    :data:`JOINT_PSF_SIGMAS`."""
    ph, pw = psf_shape
    pyy, pxx = np.mgrid[0:ph, 0:pw].astype(float)
    bands = []
    for band, shape in enumerate(shapes):
        arrays = flagship_arrays(shape, psf_shape, seed + band)
        psfs = []
        for sigma in JOINT_PSF_SIGMAS[band][:num_psfs]:
            psf = np.exp(-((pxx - pw / 2) ** 2 + (pyy - ph / 2) ** 2) / (2 * sigma**2))
            psfs.append(psf / psf.sum())
        arrays["psfs"] = psfs
        arrays["psf_ivms"] = [arrays["psf_ivm"]] * num_psfs
        bands.append(arrays)
    return bands


def _joint_band1(sources, variant, C, Dist):
    """Band 1's sources: the flagship's seen again through the sky."""
    ps0, host0, blob0 = sources
    U = Dist.Uniform
    offset = ({"offset": Dist.Normal(loc=np.array([0.0, 0.0]), scale=0.3)}
              if variant == "offset" else {})
    out = [C.PointSource(xy=C.Tied(ps0, "xy", frame="sky", **offset),
                         mag=U(loc=TOTAL_MAG - 0.2, scale=0.2 + 1.5))]
    for s0, mag in ((host0, U(loc=TOTAL_MAG, scale=27.5 - TOTAL_MAG)),
                    (blob0, U(loc=23.5, scale=2.0))):
        out.append(C.Sersic(
            xy=C.Tied(s0, "xy", frame="sky"), mag=mag,
            reff=C.Tied(s0, "reff"), reff_b=C.Tied(s0, "reff_b"),
            index=C.Tied(s0, "index"), angle=U(loc=0, scale=180),
            angle_degrees=True))
    return out


def joint_components(shapes=JOINT_SHAPES, psf_shape=(64, 64), variant="flagship",
                     seed=0, components=None, distributions=None):
    """``[band 0 components, band 1 components]`` of the joint flagship or
    one of its :data:`JOINT_VARIANTS` (``general`` and ``tiled`` give each
    band two PSF stars, whose index is then sampled, and band 1 a
    ``NoiseScale``; ``offset`` adds a registration offset to band 1's
    point-source tie).  ``components`` and ``distributions`` are the
    modules whose classes build it (by default the port's; the JAX
    package's have the same names and arguments)."""
    if components is None:
        from .models import components
    if distributions is None:
        from . import distributions
    C, Dist = components, distributions
    if variant not in JOINT_VARIANTS:
        raise ValueError(f"unknown joint variant {variant!r}; one of {JOINT_VARIANTS}")
    general = variant in ("general", "tiled")
    arrays = _joint_arrays(shapes, psf_shape, 2 if general else 1, seed)
    configs = [C.Configuration(obs_file=(hdr, a["obs"]), obsivm_file=a["ivm"],
                               psf_files=a["psfs"], psfivm_files=a["psf_ivms"],
                               mag_zeropoint=MAG_ZP)
               for hdr, a in zip(joint_headers(shapes), arrays)]
    sources = _sources(shapes[0], C, Dist)
    band0 = [configs[0], C.Sky(adu=Dist.Normal(loc=0, scale=0.01))] + sources
    band1 = [configs[1], C.Sky(adu=Dist.Normal(loc=0, scale=0.01))] + _joint_band1(
        sources, variant, C, Dist)
    if general:
        band1.append(C.NoiseScale(scale=Dist.Uniform(loc=0.5, scale=1.0)))
    return [band0, band1]


_JOINT_MODEL_FILE = """\
# The joint flagship: the quasar + host model in two bands.  Band 1 sees
# band 0's sources through its own WCS (frame="sky" ties), shares the
# Sersics' sizes and index, and has magnitudes, angles and a sky of its own.
from numpy import array

from psfMC.ModelComponents import Configuration, PointSource, Sersic, Sky, Tied
from psfMC.distributions import Normal, Uniform, WeibullMinimum

center = array({center})
max_shift = array({max_shift})
blob_center = array({blob_center})

Configuration(obs_file="sci0.fits", obsivm_file="ivm0.fits",
              psf_files="psf0.fits", psfivm_files="psf_ivm0.fits",
              mag_zeropoint={mag_zp!r})
Sky(adu=Normal(loc=0, scale=0.01))
agn = PointSource(xy=Uniform(loc=center - max_shift, scale=2 * max_shift),
                  mag=Uniform(loc={total_mag!r} - 0.2, scale=0.2 + 1.5))
agn
host = Sersic(xy=Uniform(loc=center - max_shift, scale=2 * max_shift),
              mag=Uniform(loc={total_mag!r}, scale=27.5 - {total_mag!r}),
              reff=Uniform(loc=2.0, scale=10.0), reff_b=Uniform(loc=2.0, scale=10.0),
              index=WeibullMinimum(c=1.5, scale=4), angle=Uniform(loc=0, scale=180),
              angle_degrees=True)
host
blob = Sersic(xy=Uniform(loc=blob_center - 5, scale=10),
              mag=Uniform(loc=23.5, scale=2.0),
              reff=Uniform(loc=2.0, scale=6.0), reff_b=Uniform(loc=2.0, scale=6.0),
              index=WeibullMinimum(c=1.5, scale=4), angle=Uniform(loc=0, scale=180),
              angle_degrees=True)
blob

Configuration(obs_file="sci1.fits", obsivm_file="ivm1.fits",
              psf_files="psf1.fits", psfivm_files="psf_ivm1.fits",
              mag_zeropoint={mag_zp!r})
Sky(adu=Normal(loc=0, scale=0.01))
PointSource(xy=Tied(agn, "xy", frame="sky"),
            mag=Uniform(loc={total_mag!r} - 0.2, scale=0.2 + 1.5))
Sersic(xy=Tied(host, "xy", frame="sky"),
       mag=Uniform(loc={total_mag!r}, scale=27.5 - {total_mag!r}),
       reff=Tied(host, "reff"), reff_b=Tied(host, "reff_b"),
       index=Tied(host, "index"), angle=Uniform(loc=0, scale=180),
       angle_degrees=True)
Sersic(xy=Tied(blob, "xy", frame="sky"), mag=Uniform(loc=23.5, scale=2.0),
       reff=Tied(blob, "reff"), reff_b=Tied(blob, "reff_b"),
       index=Tied(blob, "index"), angle=Uniform(loc=0, scale=180),
       angle_degrees=True)
"""


def write_joint_files(directory, shapes=JOINT_SHAPES, psf_shape=(64, 64), seed=0):
    """Write the joint flagship's inputs to ``directory``: per band ``b``
    ``sci{b}.fits`` (with its WCS cards), ``ivm{b}.fits``, ``psf{b}.fits``
    and ``psf_ivm{b}.fits`` (the port's FITS codec), and the model file
    ``model.py`` with two ``Configuration`` components and the
    ``frame="sky"`` ties of :func:`joint_components`.  Returns its path."""
    from .io import fits

    for band, (hdr, a) in enumerate(zip(joint_headers(shapes),
                                        _joint_arrays(shapes, psf_shape, 1, seed))):
        header = fits.Header()
        for key, value in hdr.items():
            header.set(key, value)
        fits.writeto(os.path.join(directory, f"sci{band}.fits"), a["obs"],
                     header=header)
        for name, arr in (("ivm", a["ivm"]), ("psf", a["psfs"][0]),
                          ("psf_ivm", a["psf_ivms"][0])):
            fits.writeto(os.path.join(directory, f"{name}{band}.fits"), arr)
    p = _prior_args(shapes[0])
    path = os.path.join(directory, "model.py")
    with open(path, "w") as fh:
        fh.write(_JOINT_MODEL_FILE.format(
            center=tuple(p["center"].tolist()),
            max_shift=tuple(p["max_shift"].tolist()),
            blob_center=tuple(p["blob_center"].tolist()),
            mag_zp=MAG_ZP, total_mag=TOTAL_MAG))
    return path


def enforce_axis_order(p0, spec):
    """Swap the draws of each semi-major/semi-minor pair (``reff`` and
    ``reff_b``, ``fwhm`` and ``fwhm_b``, ...) so that every profile has
    its semi-major axis the longer."""
    by_name = {s.name: s for s in spec.slots}
    for name, slot in by_name.items():
        b = by_name.get(name + "_b")
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


def _map_values(shape):
    """The MAP flagship's truth by parameter name (the flagship's and the
    joint flagship's component numbering), inside every prior: the point
    source and the host a little off the centre, the blob off its prior's
    centre, each Sersic elongated."""
    a = _prior_args(shape)
    c, blob = a["center"], a["blob_center"]
    return {
        "0_Sky_adu": [0.01],
        "1_PointSource_mag": [TOTAL_MAG + 0.4], "1_PointSource_xy": c + (0.3, -0.2),
        "2_Sersic_angle": [60.0], "2_Sersic_index": [2.5], "2_Sersic_mag": [21.6],
        "2_Sersic_reff": [5.0], "2_Sersic_reff_b": [3.2], "2_Sersic_xy": c + (-0.4, 0.5),
        "3_Sersic_angle": [130.0], "3_Sersic_index": [1.2], "3_Sersic_mag": [24.3],
        "3_Sersic_reff": [3.5], "3_Sersic_reff_b": [2.4], "3_Sersic_xy": blob + (1.0, -1.5),
        # band 1 of the joint flagship: its sky, magnitudes and angles
        "5_Sky_adu": [0.012], "6_PointSource_mag": [TOTAL_MAG + 0.6],
        "7_Sersic_angle": [80.0], "7_Sersic_mag": [21.9],
        "8_Sersic_angle": [110.0], "8_Sersic_mag": [24.6],
    }


def map_truth(param_names, shape):
    """The MAP flagship's truth as a vector in the layout of
    ``param_names`` (a single-band or a joint flagship's); ``shape`` is
    band 0's."""
    values = _map_values(shape)
    return np.concatenate([np.asarray(values[n], np.float64) for n in param_names])


def write_map_files(directory, shape=(128, 128), psf_shape=(64, 64), seed=0):
    """Write the MAP flagship's inputs to ``directory``: the flagship's
    files (:func:`write_flagship_files`) with ``sci.fits`` replaced by the
    model's simulation at :func:`map_truth` (the convolved model plus the
    observation's noise, seed ``seed``, through the model file itself, so
    that its mask is the fit's).  Returns ``(model file path, truth)``."""
    import torch

    from .io import fits
    from .models import MultiComponentModel

    path = write_flagship_files(directory, shape, psf_shape, seed)
    model = MultiComponentModel(path, device="cpu", dtype=torch.float64)
    truth = map_truth(model.param_names, shape)
    mock, _ = model.simulate(theta=truth, random_state=seed)
    fits.writeto(os.path.join(directory, "sci.fits"), mock, overwrite=True)
    return path, truth


def joint_map_components(shapes=JOINT_SHAPES, psf_shape=(64, 64), seed=0):
    """The joint flagship's bands with each observation simulated at
    :func:`map_truth` (``JointModel.simulate`` on the CPU in float64, seed
    ``seed``), each band keeping its WCS.  Returns ``(bands, truth)``."""
    import torch

    from .models import JointModel

    model = JointModel(joint_components(shapes, psf_shape, seed=seed), device="cpu",
                       dtype=torch.float64)
    truth = map_truth(model.param_names, shapes[0])
    mocks, _ = model.simulate(theta=truth, random_state=seed)
    bands = joint_components(shapes, psf_shape, seed=seed)
    arrays = _joint_arrays(shapes, psf_shape, 1, seed)
    for band, mock, hdr, a in zip(bands, mocks, joint_headers(shapes), arrays):
        band[0] = Configuration(obs_file=(hdr, mock), obsivm_file=a["ivm"],
                                psf_files=a["psfs"], psfivm_files=a["psf_ivms"],
                                mag_zeropoint=MAG_ZP)
    return bands, truth


GALFIT_PLATE_SCALE = 0.03  # arcsec per pixel, the feedme's K)


def galfit_feedme(shape=(128, 128), constraints="constraints.txt"):
    """The GALFIT flagship's feedme text (see the module doc): every value
    free but the sky's gradients, ``G)`` naming ``constraints``."""
    v = _map_values(shape)

    def num(x):
        return repr(float(x))

    def xy(name):  # GALFIT's positions are 1-based
        return " ".join(num(c + 1.0) for c in v[name])

    def sersic(n, position):
        reff, reff_b = v[f"{n}_Sersic_reff"][0], v[f"{n}_Sersic_reff_b"][0]
        return (f" 0) sersic\n 1) {position} 1 1\n 3) {num(v[f'{n}_Sersic_mag'][0])} 1\n"
                f" 4) {num(reff)} 1\n 5) {num(v[f'{n}_Sersic_index'][0])} 1\n"
                f" 9) {num(reff_b / reff)} 1\n10) {num(v[f'{n}_Sersic_angle'][0] - 90.0)} 1\n")

    ps = xy("1_PointSource_xy")
    return (f"A) sci.fits\nB) out.fits\nD) psf.fits\nG) {constraints}\n"
            f"J) {MAG_ZP!r}\nK) {GALFIT_PLATE_SCALE!r} {GALFIT_PLATE_SCALE!r}\n"
            f"P) 0\n\n 0) sky\n 1) {num(v['0_Sky_adu'][0])} 1\n 2) 0.0 0\n 3) 0.0 0\n\n"
            f" 0) psf\n 1) {ps} 1 1\n 3) {num(v['1_PointSource_mag'][0])} 1\n\n"
            + sersic(2, ps) + "\n" + sersic(3, xy("3_Sersic_xy")))


def write_galfit_files(directory, shape=(128, 128), psf_shape=(64, 64), seed=0):
    """Write the GALFIT flagship to ``directory``: the MAP flagship's FITS
    files and ds9 mask (:func:`write_map_files`, without its model file),
    ``galfit.feedme`` and its constraint file ``constraints.txt`` (the
    point source, object 2, and the host, object 3, coupled in x and y at
    zero offset).  Returns the feedme's path."""
    write_map_files(directory, shape, psf_shape, seed)
    os.remove(os.path.join(directory, "model.py"))
    with open(os.path.join(directory, "constraints.txt"), "w") as fh:
        fh.write("# comp  par  constraint\n 3_2  x  offset\n 3_2  y  offset\n")
    path = os.path.join(directory, "galfit.feedme")
    with open(path, "w") as fh:
        fh.write(galfit_feedme(shape))
    return path
