"""Model components (port of ``models/components.py``, flagship subset).

Declaration-time objects with the JAX package's conventions: an
attribute is a prior :class:`~psfmc_tpu_torch.distributions.Distribution`
or a constant; a component's parameters are ordered alphabetically by
attribute; trace names are ``{count}_{CompType}_{attr}`` with the FITS
abbreviations; ``xy`` spans two slots.  They are compiled into a static
:class:`~psfmc_tpu_torch.models.spec.ModelSpec` by
:func:`~psfmc_tpu_torch.models.spec.build_model_spec`.

This slice has ``Configuration`` (FITS file names, ``(header, array)``
pairs or arrays, an optional FITS, ds9-region or boolean-array mask,
and the JAX package's likelihood, padding and oversampling options),
``PSFSelector`` (one PSF, or several with a sampled ``DiscreteUniform``
index), ``Sky`` (``adu`` and the tilted-plane ``dx``/``dy``),
``NoiseScale``, ``PointSource`` and the elliptical ``Sersic``.  The
Sersic constructor accepts the JAX package's isophote-shape and
truncation keywords so a model states them in the same words; the spec
builder raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import numpy as np

from ..distributions import DiscreteUniform, Distribution
from ..io.preprocess import (
    bin_psf,
    calculate_psf_variability,
    pre_fft_psf,
    preprocess_obs,
    preprocess_psf,
)

__all__ = [
    "ComponentBase",
    "Sky",
    "NoiseScale",
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

    def stochastic_lens(self):
        return [np.asarray(p.value).size for _k, p in self.sorted_prior_items()]

    def _batch_constraints(self, vals):
        """``(m,)`` validity of candidate draws ``{attr: (m, size)}``
        under the component's joint constraints (none by default)."""
        return np.ones(len(next(iter(vals.values()))), dtype=bool)

    def draw_batch(self, n, random_state=None, max_tries=1000):
        """``(n, num_stochastics)`` prior draws with the joint constraint
        enforced: every still-invalid row is redrawn together (the JAX
        package's vectorised rejection)."""
        items = self.sorted_prior_items()
        if not items:
            return np.zeros((n, 0))
        sizes = self.stochastic_lens()
        out = np.empty((n, int(np.sum(sizes))))
        need = np.arange(n)
        for _try in range(max_tries):
            m = len(need)
            vals, cols = {}, []
            valid = np.ones(m, dtype=bool)
            for (name, prior), size in zip(items, sizes):
                ev = np.shape(np.asarray(prior.value))
                d = np.asarray(prior.random(random_state=random_state,
                                            size=(m,) + ev),
                               dtype=float).reshape(m, size)
                if prior.is_discrete:
                    d = np.rint(d)
                vals[name] = d
                cols.append(d)
                with np.errstate(all="ignore"):
                    lp = np.asarray(prior.logp(d.reshape((m,) + ev)))
                valid &= np.isfinite(lp.reshape(m, -1)).all(axis=1)
            valid &= self._batch_constraints(vals)
            out[need] = np.concatenate(cols, axis=1)
            need = need[~valid]
            if need.size == 0:
                return out
        raise RuntimeError(
            f"Could not draw valid prior sample for {type(self).__name__} "
            f"after {max_tries} tries"
        )

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
    """Sky background: ``adu + dx (x - (W-1)/2) + dy (y - (H-1)/2)``.

    The flat ``adu`` is rendered into the raw model (a constant is
    convolution-invariant); the optional gradient plane is a background
    added after the PSF convolution, with no model variance.  Without
    ``dx``/``dy`` the parameter layout is the flat sky's.
    """

    _stochastic_attrs = ("adu", "dx", "dy")

    def __init__(self, adu=None, dx=None, dy=None):
        super().__init__()
        self.adu = adu
        if dx is not None:
            self.dx = dx
        if dy is not None:
            self.dy = dy


class NoiseScale(ComponentBase):
    """Sampled factor ``scale`` on the whole per-pixel variance budget
    (observation + PSF-mismatch model variance) inside the likelihood;
    ``scale <= 0`` has prior density 0."""

    _fits_abbrs = (("NoiseScale", "NSC"), ("scale", "SCL"))
    _stochastic_attrs = ("scale",)

    def __init__(self, scale=None):
        super().__init__()
        self.scale = scale

    def _batch_constraints(self, vals):
        m = len(next(iter(vals.values())))
        scale = vals.get("scale", self._constants.get("scale"))
        return np.ravel(np.asarray(scale) > 0) & np.ones(m, bool)


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

    def _batch_constraints(self, vals):
        """``reff >= reff_b`` for every draw (constants count too)."""
        m = len(next(iter(vals.values())))
        reff = vals.get("reff", self._constants.get("reff"))
        reff_b = vals.get("reff_b", self._constants.get("reff_b"))
        if reff is None or reff_b is None:
            return np.ones(m, dtype=bool)
        return np.ravel(np.asarray(reff_b) <= np.asarray(reff)) & np.ones(m, bool)


class PSFSelector(ComponentBase):
    """Preprocessed PSF(s): with several, the index is a free
    ``DiscreteUniform(0, n)`` parameter (``PSF_Index``).

    Each PSF is normalised, then binned when ``oversample > 1``
    (:func:`~psfmc_tpu_torch.io.preprocess.bin_psf`), and the inter-PSF
    mismatch variance is added to every variance map.  The spatial
    kernels are kept (``spatial_psfs``, ``spatial_vars``): a ``conv_pad``
    model transforms them at the padded size; the observation-size half
    spectra ``psf_list``/``var_list`` are made on first use.
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
        if len(psf_list) > 1:
            self.psf_index = DiscreteUniform(low=0, high=len(psf_list))
        else:
            self.psf_index = 0
        if oversample != int(oversample) or int(oversample) < 1:
            raise ValueError(
                f"psf_oversample must be a positive integer, got {oversample!r}")
        pairs = [preprocess_psf(p, i) for p, i in zip(psf_list, ivm_list)]
        if int(oversample) != 1:
            pairs = [bin_psf(d, v, oversample) for d, v in pairs]
        self.spatial_psfs, self.spatial_vars = calculate_psf_variability(
            [d for d, _ in pairs], [v for _, v in pairs])
        self.filenames = [p if isinstance(p, str) else f"<array {i}>"
                          for i, p in enumerate(psf_list)]
        self._data_shape = tuple(data_shape)
        self._ffts = None

    def _spectra(self):
        if self._ffts is None:
            self._ffts = [pre_fft_psf(p, v, self._data_shape)
                          for p, v in zip(self.spatial_psfs, self.spatial_vars)]
        return self._ffts

    @property
    def psf_list(self):
        return [f for f, _ in self._spectra()]

    @property
    def var_list(self):
        return [v for _, v in self._spectra()]

    def update_stochastic_names(self, count=None):
        # one selector per model: no count prefix
        if "psf_index" in self._priors:
            self._priors["psf_index"].name = "PSF_Index"
            self._priors["psf_index"].fitsname = "PSF_IDX"

    def set_index(self, value):
        """Set the index's current value (the image writer sets the MAP
        sample's)."""
        if "psf_index" in self._priors:
            self._priors["psf_index"].value = value
        else:
            self.psf_index = value

    def current_index(self):
        prior = self._priors.get("psf_index")
        value = prior.value if prior is not None else self._constants["psf_index"]
        return int(np.rint(np.asarray(value)))

    @property
    def filename(self):
        """The current PSF's file name, as the ``PSFIMG`` card reports it."""
        return self.filenames[self.current_index()]


class Configuration(ComponentBase):
    """Input arrays and control parameters.

    :param obs_file: observed image: FITS file name, ``(header, array)``
        pair or array.
    :param obsivm_file: its inverse-variance map.
    :param psf_files: one PSF image or several (their index is then a
        free parameter).
    :param psfivm_files: the matching PSF inverse-variance maps.
    :param mask_file: optional FITS mask (nonzero = exclude), ds9 region
        file (the fit region) or boolean array (True = exclude).
    :param mag_zeropoint: magnitude of 1 count/second.
    :param likelihood: ``'gaussian'`` (the reference's), ``'student'``
        (Student-t with ``likelihood_df`` degrees of freedom) or
        ``'poisson'`` (counts ``likelihood_gain * image``; the data must
        be non-negative and the IVM only defines the mask).
    :param likelihood_df: Student-t degrees of freedom.
    :param likelihood_gain: Poisson counts per observation unit.
    :param psf_oversample: the PSFs are sampled this many times finer
        than the data and are block-binned to it.
    :param conv_pad: render and convolve on a grid this many pixels
        larger on every side, then crop.
    :param render_oversample: sub-pixel factor of the window around each
        Sersic's center (:mod:`psfmc_tpu_torch.ops.oversample`).
    :param oversample_window: that window's side in pixels.

    The observation's FITS header is kept as ``obs_header``: the image
    products start from it.
    """

    def __init__(self, obs_file, obsivm_file, psf_files, psfivm_files,
                 mask_file=None, mag_zeropoint=0, likelihood="gaussian",
                 likelihood_df=4.0, likelihood_gain=1.0, psf_oversample=1,
                 conv_pad=0, render_oversample=1, oversample_window=16):
        super().__init__()
        from ..ops.likelihood import make_lnlike

        self.mag_zeropoint = mag_zeropoint
        make_lnlike(likelihood, likelihood_df, likelihood_gain)  # validates
        self.likelihood = likelihood
        self.likelihood_df = float(likelihood_df)
        self.likelihood_gain = float(likelihood_gain)
        self.conv_pad = int(conv_pad)
        if self.conv_pad < 0:
            raise ValueError(f"conv_pad must be >= 0, got {conv_pad}")
        for name, v in (("render_oversample", render_oversample),
                        ("oversample_window", oversample_window)):
            if v != int(v) or int(v) < 1:
                raise ValueError(f"{name} must be a positive integer, got {v!r}")
        self.render_oversample = int(render_oversample)
        self.oversample_window = int(oversample_window)
        obs_hdr, obs_data, obs_var, bad_px = preprocess_obs(
            obs_file, obsivm_file, mask_file
        )
        self.obs_header = obs_hdr
        self.obs_data = obs_data
        self.obs_var = obs_var
        self.bad_px = bad_px
        self.psf_selector = PSFSelector(
            psf_files, psfivm_files, obs_data.shape, oversample=psf_oversample
        )
