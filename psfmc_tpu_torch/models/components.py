"""Model components (port of ``models/components.py``, flagship subset).

Declaration-time objects with the JAX package's conventions: an
attribute is a prior :class:`~psfmc_tpu_torch.distributions.Distribution`
or a constant; a component's parameters are ordered alphabetically by
attribute; trace names are ``{count}_{CompType}_{attr}`` with the FITS
abbreviations; ``xy`` spans two slots.  They are compiled into a static
:class:`~psfmc_tpu_torch.models.spec.ModelSpec` by
:func:`~psfmc_tpu_torch.models.spec.build_model_spec`.

This slice has ``Configuration`` (arrays and an optional boolean mask
array), ``PSFSelector`` (one PSF), ``Sky`` (``adu``), ``PointSource``
and the elliptical ``Sersic``.  The constructors accept the JAX
package's other options so a model states them in the same words; the
spec builder raises ``NotImplementedError`` for every one of them
(gradient sky, isophote shapes and truncation, several PSFs, padding,
oversampling, non-Gaussian likelihoods).
"""
from __future__ import annotations

import numpy as np

from ..distributions import Distribution
from ..io.preprocess import (
    calculate_psf_variability,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)

__all__ = [
    "ComponentBase",
    "Sky",
    "PointSource",
    "Sersic",
    "Configuration",
    "PSFSelector",
]


class ComponentBase:
    """Tracks priors vs constants per stochastic attribute."""

    _fits_abbrs = ()
    _stochastic_attrs = ()

    def __init__(self):
        object.__setattr__(self, "_priors", {})
        object.__setattr__(self, "_constants", {})

    def __setattr__(self, name, value):
        if name in type(self)._stochastic_attrs:
            if isinstance(value, Distribution):
                self._priors[name] = value
                self._constants.pop(name, None)
            else:
                self._constants[name] = value
                self._priors.pop(name, None)
        else:
            object.__setattr__(self, name, value)

    def sorted_prior_items(self):
        return sorted(self._priors.items())

    def update_stochastic_names(self, count=None):
        comptype = type(self).__name__
        for attr, prior in self._priors.items():
            newname = f"{comptype}_{attr}"
            fitsname = newname
            for longname, abbr in type(self)._fits_abbrs:
                fitsname = fitsname.replace(longname, abbr)
            if count is not None:
                newname = f"{count:d}_{newname}"
                fitsname = f"{count:d}{fitsname}"
            prior.name = newname
            prior.fitsname = fitsname


class Sky(ComponentBase):
    """Flat sky background ``adu``.

    ``dx``/``dy`` (the JAX package's tilted-plane gradient) are accepted
    and rejected by the spec builder: they wait for a later slice.
    """

    _stochastic_attrs = ("adu", "dx", "dy")

    def __init__(self, adu=None, dx=None, dy=None):
        super().__init__()
        self.adu = adu
        if dx is not None:
            self.dx = dx
        if dy is not None:
            self.dy = dy


class PointSource(ComponentBase):
    """Point source with a sub-pixel shift kernel (``lanczos3`` or
    ``bilinear``); ``xy`` is the 0-based pixel position."""

    _fits_abbrs = (("PointSource", "PS"),)
    _stochastic_attrs = ("xy", "mag")

    def __init__(self, xy=None, mag=None, shift_method="lanczos3"):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.shift_method = shift_method


class Sersic(ComponentBase):
    """Elliptical Sersic profile.

    ``c0`` and the other shape keywords of the JAX package (Fourier and
    bending modes, rotation, truncation) are recorded and rejected by
    the spec builder: they wait for the full render-family slice.
    """

    _fits_abbrs = (
        ("Sersic", "SER"),
        ("reff_b", "REB"),
        ("reff", "RE"),
        ("index", "N"),
        ("angle", "ANG"),
    )
    _stochastic_attrs = ("xy", "mag", "reff", "reff_b", "index", "angle")

    def __init__(self, xy=None, mag=None, reff=None, reff_b=None,
                 index=None, angle=None, angle_degrees=False, c0=None,
                 **shape_kw):
        super().__init__()
        self.xy = xy
        self.mag = mag
        self.reff = reff
        self.reff_b = reff_b
        self.index = index
        self.angle = angle
        self.angle_degrees = angle_degrees
        self.shape_options = {
            k: v for k, v in dict(c0=c0, **shape_kw).items() if v is not None
        }


class PSFSelector(ComponentBase):
    """Preprocessed PSF(s) and their center-padded half spectra.

    Several PSFs (a free PSF index in the JAX package) are recorded and
    rejected by the spec builder; ``oversample`` other than 1 too.
    """

    _stochastic_attrs = ("psf_index",)

    def __init__(self, psf_list, ivm_list, data_shape, oversample=1):
        super().__init__()
        if isinstance(psf_list, (str, np.ndarray)):
            psf_list = [psf_list]
        if isinstance(ivm_list, (str, np.ndarray)):
            ivm_list = [ivm_list]
        if len(psf_list) != len(ivm_list):
            raise ValueError("PSF and IVM lists must be the same length")
        self.psf_index = 0
        self.oversample = oversample
        pairs = [preprocess_psf(p, i) for p, i in zip(psf_list, ivm_list)]
        data_list, var_list = calculate_psf_variability(
            [d for d, _ in pairs], [v for _, v in pairs]
        )
        ffts = [pre_fft_psf(p, v, tuple(data_shape))
                for p, v in zip(data_list, var_list)]
        self.psf_list = [f for f, _ in ffts]
        self.var_list = [v for _, v in ffts]


class Configuration(ComponentBase):
    """Input arrays and control parameters.

    :param obs_file: observed image (numpy array).
    :param obsivm_file: its inverse-variance map.
    :param psf_files: the PSF image (one in this slice).
    :param psfivm_files: the PSF's inverse-variance map.
    :param mask_file: optional boolean array, True = exclude.
    :param mag_zeropoint: magnitude of 1 count/second.

    ``likelihood``, ``psf_oversample``, ``conv_pad`` and
    ``render_oversample`` keep the JAX package's names; only their
    reference values (``'gaussian'``, 1, 0, 1) are in this slice, and the
    spec builder rejects the others.
    """

    def __init__(self, obs_file, obsivm_file, psf_files, psfivm_files,
                 mask_file=None, mag_zeropoint=0, likelihood="gaussian",
                 psf_oversample=1, conv_pad=0, render_oversample=1):
        super().__init__()
        self.mag_zeropoint = mag_zeropoint
        self.likelihood = likelihood
        self.conv_pad = int(conv_pad)
        self.render_oversample = int(render_oversample)
        obs_data, obs_var, bad_px = preprocess_obs(
            obs_file, obsivm_file, mask_file
        )
        self.obs_data = obs_data
        self.obs_var = obs_var
        self.bad_px = bad_px
        self.psf_selector = PSFSelector(
            psf_files, psfivm_files, obs_data.shape, oversample=psf_oversample
        )
