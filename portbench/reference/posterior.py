"""The plain reference: the posterior of a quasar + host model in float64.

Written from the model's published description (psfMC's components,
priors and Gaussian likelihood) in plain PyTorch, independent of the
program under test: it imports nothing of the port, takes the inputs the
benchmark made (observation, weight, PSF star and its weight, mask) and
works out everything the port's set-up derives from them again (the
normalised PSF and its variance map, the centre-padded PSF spectra, the
bad-pixel map).

Conventions (0-based pixel centres, ``x`` along the columns):

* ``Sky(adu)``: a constant added to the raw model;
* ``PointSource(xy, mag)``: ``flux * ky(j - y) kx(i - x)`` with the 1-D
  Lanczos-3 kernel, ``flux = 10 ** (-0.4 (mag - zp))``;
* ``Sersic(xy, mag, reff, reff_b, index, angle)`` (angle in degrees,
  +90 degree convention): ``sbeff exp(-kappa (p - 1)) (1 + (kappa p /
  2n)^2 / (3 max(dx^2 + dy^2, 1/8)))`` with ``p = max(r^2, 1e-30)^(1/2n)``,
  ``kappa = gammaincinv(2n, 1/2)`` and ``sbeff`` from the total flux;
* the model is convolved circularly with the PSF centre-padded to the
  image (``m // 2`` on ``N // 2``), its square with the PSF's variance map;
* ``lnL = -1/2 sum_good [(obs - conv)^2 ivm - log(ivm / 2 pi)]``, ``ivm =
  1 / (mvar + obs_var)``, not finite -> ``-inf``;
* the priors (Normal, Uniform, WeibullMinimum) and each Sersic's axis
  order ``reff >= reff_b``.

``precision="tf32"`` is the control of the comparison that decides
``correct``: the same arithmetic in float32, with each convolution's
discrete Fourier transforms as matrix products whose operands are rounded
to TF32 (10 bits of mantissa), the step below the configuration's
float32-with-TF32-off.  The rounding is done here, explicitly, so the
control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy import special

__all__ = ["ReferenceModel", "param_names", "tf32_round", "render_truth"]

_TINY = 1e-30
_LN10 = math.log(10.0)

# the parameters of each component type, in the model file's order
_PARAMS = {
    "Sky": ("adu",),
    "PointSource": ("xy", "mag"),
    "Sersic": ("xy", "mag", "reff", "reff_b", "index", "angle"),
}


def param_names(components):
    """``[(name, size)]`` of a model's free parameters: ``<i>_<Type>_<attr>``
    with ``i`` the component's position in the model file (the
    Configuration left out), as psfMC's trace database names them."""
    out = []
    for i, comp in enumerate(components):
        for attr in _PARAMS[comp["type"]]:
            if attr in comp["params"]:
                size = np.size(comp["params"][attr]["loc"])
                out.append((f"{i}_{comp['type']}_{attr}", int(size)))
    return out


def tf32_round(x):
    """``x`` (float32) rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _prior_logp(prior, x):
    """Log-density of one prior at ``x`` (``(B,)`` or ``(B, size)``)."""
    kind = prior["prior"]
    loc = torch.as_tensor(prior.get("loc", 0.0), dtype=x.dtype, device=x.device)
    scale = torch.as_tensor(prior.get("scale", 1.0), dtype=x.dtype, device=x.device)
    z = (x - loc) / scale
    if kind == "Normal":
        lp = -0.5 * z * z - 0.5 * math.log(2 * math.pi)
    elif kind == "Uniform":
        lp = torch.where((z >= 0) & (z <= 1), torch.zeros_like(z),
                         torch.full_like(z, -math.inf))
    elif kind == "WeibullMinimum":
        c = float(prior["c"])
        zc = torch.clamp(z, min=_TINY)
        lp = torch.where(z > 0, math.log(c) + (c - 1.0) * torch.log(zc) - zc ** c,
                         torch.full_like(z, -math.inf))
    else:
        raise ValueError(f"prior {kind!r} has no reference density")
    lp = lp - torch.log(scale)
    return lp.reshape(x.shape[0], -1).sum(dim=1)


def _center_pad(img, shape):
    out = torch.zeros(shape, dtype=img.dtype, device=img.device)
    oy, ox = shape[0] // 2 - img.shape[0] // 2, shape[1] // 2 - img.shape[1] // 2
    out[oy:oy + img.shape[0], ox:ox + img.shape[1]] = img
    return out


def _dft_mats(n, dtype, device):
    k = torch.arange(n, dtype=torch.float64, device=device)
    ang = 2 * math.pi * torch.outer(k, k) / n
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


class ReferenceModel:
    """The posterior of ``components`` (the configuration's model, as data)
    against one observation or a stack of them.

    :param obs, ivm: ``(H, W)`` or ``(K, H, W)`` arrays as the benchmark
        wrote them; bad pixels are non-finite data or weight, or weight
        <= 0, and those of ``bad_mask``.
    :param psf, psf_ivm: the PSF star and its weight ``(h, w)``.
    :param bad_mask: ``(H, W)`` bool, True = excluded (the mask file).
    :param precision: ``"float64"`` (the reference) or ``"tf32"`` (the
        control).
    """

    def __init__(self, components, zeropoint, obs, ivm, psf, psf_ivm, bad_mask,
                 device="cpu", precision="float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.components = components
        self.zp = float(zeropoint)
        f64 = dict(dtype=torch.float64, device=self.device)
        obs = torch.as_tensor(np.asarray(obs, np.float64), **f64)
        ivm = torch.as_tensor(np.asarray(ivm, np.float64), **f64)
        if obs.ndim == 2:
            obs, ivm = obs[None], ivm[None]
        self.shape = tuple(obs.shape[1:])
        bad = (~torch.isfinite(obs)) | (~torch.isfinite(ivm)) | (ivm <= 0)
        self.obs_var = torch.where(bad, torch.full_like(ivm, math.inf),
                                   1.0 / torch.where(bad, torch.ones_like(ivm), ivm))
        bad = bad | torch.as_tensor(np.asarray(bad_mask, bool), device=self.device)[None]
        self.good = ~bad
        self.obs = obs
        # the PSF: bad pixels zeroed, normalised to unit sum, weight scaled
        psf = torch.as_tensor(np.asarray(psf, np.float64), **f64)
        pivm = torch.as_tensor(np.asarray(psf_ivm, np.float64), **f64)
        pbad = (~torch.isfinite(psf)) | (~torch.isfinite(pivm)) | (pivm <= 0)
        psf = torch.where(pbad, torch.zeros_like(psf), psf)
        pivm = torch.where(pbad, torch.zeros_like(pivm), pivm)
        total = float(math.fsum(psf.flatten().tolist()))
        psf, pivm = psf / total, pivm * total * total
        pvar = torch.where(pivm <= 0, torch.zeros_like(pivm),
                           1.0 / torch.where(pivm <= 0, torch.ones_like(pivm), pivm))
        self.k_psf = torch.fft.fft2(_center_pad(psf, self.shape))
        self.k_var = torch.fft.fft2(_center_pad(pvar, self.shape))
        if precision == "tf32":
            self._mats = {n: _dft_mats(n, torch.float32, self.device)
                          for n in set(self.shape)}
        h, w = self.shape
        self.yg = torch.arange(h, **f64)[:, None]
        self.xg = torch.arange(w, **f64)[None, :]

    def normalization(self):
        """Each observation's ``|sum_good log(ivm / 2 pi)| / 2`` (host numpy)."""
        ivm = 1.0 / self.obs_var
        term = torch.log(torch.where(self.good, ivm, torch.ones_like(ivm)) / (2 * math.pi))
        return (0.5 * torch.where(self.good, term, torch.zeros_like(term)).sum(dim=(1, 2))
                ).abs().cpu().numpy()

    # -- parameters --------------------------------------------------------
    def split(self, named):
        """``{name: (B,) or (B, size) float64 tensor}`` from a dict of arrays."""
        return {k: torch.as_tensor(np.asarray(v, np.float64), dtype=torch.float64,
                                   device=self.device) for k, v in named.items()}

    def log_prior(self, p):
        """The priors and the Sersics' axis order; NaN -> ``-inf``."""
        b = next(iter(p.values())).shape[0]
        lp = torch.zeros(b, dtype=torch.float64, device=self.device)
        for i, comp in enumerate(self.components):
            for attr, prior in comp["params"].items():
                lp = lp + _prior_logp(prior, p[f"{i}_{comp['type']}_{attr}"])
            if comp["type"] == "Sersic":
                pre = f"{i}_Sersic_"
                lp = torch.where(p[pre + "reff_b"] > p[pre + "reff"],
                                 torch.full_like(lp, -math.inf), lp)
        return torch.where(torch.isnan(lp), torch.full_like(lp, -math.inf), lp)

    # -- render ------------------------------------------------------------
    def _flux(self, mag):
        return torch.exp(_LN10 * (-0.4 * (mag - self.zp)))

    def raw_and_ps(self, p):
        """Raw model ``(B, H, W)`` and its point-source part, in float64."""
        b = next(iter(p.values())).shape[0]
        h, w = self.shape
        raw = torch.zeros((b, h, w), dtype=torch.float64, device=self.device)
        ps = torch.zeros_like(raw)
        for i, comp in enumerate(self.components):
            pre = f"{i}_{comp['type']}_"
            if comp["type"] == "Sky":
                raw = raw + p[pre + "adu"][:, None, None]
            elif comp["type"] == "PointSource":
                xy = p[pre + "xy"]
                ky = _lanczos3(self.yg[None, :, 0] - xy[:, 1:2])  # (B, H)
                kx = _lanczos3(self.xg[None, 0, :] - xy[:, 0:1])  # (B, W)
                ps = ps + self._flux(p[pre + "mag"])[:, None, None] * ky[:, :, None] * kx[:, None, :]
            elif comp["type"] == "Sersic":
                raw = raw + self._sersic(p, pre, comp.get("angle_degrees", False))
        return raw + ps, ps

    def _sersic(self, p, pre, degrees):
        xy, mag = p[pre + "xy"], p[pre + "mag"]
        reff, reff_b, n, angle = (p[pre + k] for k in ("reff", "reff_b", "index", "angle"))
        two_n = 2.0 * n
        kappa = torch.as_tensor(special.gammaincinv(two_n.cpu().numpy(), 0.5),
                                dtype=torch.float64, device=self.device)
        sbeff = self._flux(mag) / (math.pi * reff * reff_b * two_n
                                   * torch.exp(kappa - torch.log(kappa) * two_n)
                                   * torch.exp(torch.lgamma(two_n)))
        ang = (torch.deg2rad(angle) if degrees else angle) + 0.5 * math.pi
        c, s = torch.cos(ang), torch.sin(ang)

        def bc(t):
            return t[:, None, None]

        dx = self.xg[None] - bc(xy[:, 0])
        dy = self.yg[None] - bc(xy[:, 1])
        u = (bc(c) * dx + bc(s) * dy) / bc(reff)
        v = (-bc(s) * dx + bc(c) * dy) / bc(reff_b)
        pw = torch.exp(torch.log(torch.clamp(u * u + v * v, min=_TINY)) / bc(two_n))
        sb = torch.exp(-bc(kappa) * (pw - 1.0))
        corr = 1.0 + (bc(kappa) * pw / bc(two_n)) ** 2 / (
            3.0 * torch.clamp(dx * dx + dy * dy, min=0.125))
        return bc(sbeff) * sb * corr

    # -- convolution and likelihood ---------------------------------------
    def convolve(self, img, kernel):
        """Circular convolution of ``(B, H, W)`` float64 images with a
        centre-padded kernel's spectrum (``"psf"`` or ``"var"``)."""
        k = self.k_psf if kernel == "psf" else self.k_var
        if self.precision == "float64":
            out = torch.fft.ifft2(torch.fft.fft2(img) * k).real
        else:
            out = self._convolve_tf32(img, k)
        return torch.fft.ifftshift(out, dim=(-2, -1))

    def _convolve_tf32(self, img, k):
        """The control's convolution: DFT matrix products on TF32 operands,
        float32 sums, the spectrum product in float32."""
        h, w = self.shape
        ch, sh = self._mats[h]
        cw, sw = self._mats[w]

        def mm(a, b):
            return tf32_round(a) @ tf32_round(b)

        x = img.to(torch.float32)
        # forward along W then H: X = F_H x F_W, F = cos - i sin
        ar, ai = mm(x, cw), -mm(x, sw)
        br = mm(ch, ar) + mm(sh, ai)
        bi = mm(ch, ai) - mm(sh, ar)
        kr, ki = k.real.to(torch.float32), k.imag.to(torch.float32)
        pr, pi = br * kr - bi * ki, br * ki + bi * kr
        # inverse: x = conj(F_H) P conj(F_W) / (H W), real part
        cr = mm(ch, pr) - mm(sh, pi)
        ci = mm(ch, pi) + mm(sh, pr)
        out = (mm(cr, cw) - mm(ci, sw)) / (h * w)
        return out.to(torch.float64)

    def log_likelihood(self, raw, target=None):
        """Masked Gaussian lnL per walker; ``target`` ``(B,)`` picks each
        walker's observation in a stack (default: the first)."""
        if target is None:
            target = torch.zeros(raw.shape[0], dtype=torch.int64, device=self.device)
        conv = self.convolve(raw, "psf")
        mvar = self.convolve(raw * raw, "var")
        obs, good = self.obs[target], self.good[target]
        ivm = 1.0 / (mvar + self.obs_var[target])
        term = (obs - conv) ** 2 * ivm - torch.log(
            torch.where(good, ivm, torch.ones_like(ivm)) / (2 * math.pi))
        if self.precision == "tf32":
            term = term.to(torch.float32)
        lnl = torch.where(good, -0.5 * term, torch.zeros_like(term)).sum(dim=(1, 2))
        lnl = lnl.to(torch.float64)
        return torch.where(torch.isfinite(lnl), lnl, torch.full_like(lnl, -math.inf))

    def log_posterior(self, named, target=None, block=256):
        """lnpost of named parameter rows (``{name: (N,) / (N, size)}``),
        in blocks of ``block`` rows; ``(N,)`` float64 on the host."""
        p = self.split(named)
        n = next(iter(p.values())).shape[0]
        out = []
        for lo in range(0, n, block):
            part = {k: v[lo:lo + block] for k, v in p.items()}
            lp = self.log_prior(part)
            raw, _ = self.raw_and_ps(part)
            if self.precision == "tf32":
                raw = raw.to(torch.float32).to(torch.float64)
            t = None if target is None else torch.as_tensor(
                np.asarray(target[lo:lo + block]), dtype=torch.int64, device=self.device)
            lnl = self.log_likelihood(raw, t)
            out.append(torch.where(torch.isfinite(lp), lnl + lp,
                                   torch.full_like(lp, -math.inf)).cpu())
        return torch.cat(out).numpy()

    def mean_images(self, named, block=256):
        """The five posterior-mean image products of the rows ``named``:
        the means of the raw model, its square and the point sources
        over the rows, then convolved (the mean of a convolution is the
        convolution of the mean).  Float64 numpy ``(H, W)`` each."""
        p = self.split(named)
        n = next(iter(p.values())).shape[0]
        sums = None
        for lo in range(0, n, block):
            part = {k: v[lo:lo + block] for k, v in p.items()}
            raw, ps = self.raw_and_ps(part)
            if self.precision == "tf32":
                raw, ps = (t.to(torch.float32).to(torch.float64) for t in (raw, ps))
            s = (raw.sum(0), (raw * raw).sum(0), ps.sum(0))
            sums = s if sums is None else tuple(a + b for a, b in zip(sums, s))
        mean_raw, mean_sq, mean_ps = (t[None] / n for t in sums)
        conv = self.convolve(mean_raw, "psf")[0]
        mvar = self.convolve(mean_sq, "var")[0]
        ps_conv = self.convolve(mean_ps, "psf")[0]
        obs = self.obs[0]
        ivm = 1.0 / (mvar + self.obs_var[0])
        imgs = {"raw_model": mean_raw[0], "convolved_model": conv,
                "residual": obs - conv, "composite_ivm": ivm,
                "point_source_subtracted": obs - ps_conv}
        return {k: v.cpu().numpy() for k, v in imgs.items()}


def _lanczos3(d):
    """The 1-D Lanczos kernel of half-width 3, 0 outside it."""
    pd = math.pi * d
    safe = torch.where(d != 0, pd, torch.ones_like(pd))
    sinc = torch.where(d != 0, torch.sin(safe) / safe, torch.ones_like(d))
    pd3 = pd / 3.0
    safe3 = torch.where(d != 0, pd3, torch.ones_like(pd3))
    sinc3 = torch.where(d != 0, torch.sin(safe3) / safe3, torch.ones_like(d))
    return torch.where(d.abs() < 3.0, sinc * sinc3, torch.zeros_like(d))


def render_truth(model, named):
    """The convolved model of parameter rows: ``(N, H, W)`` float64 (the
    noiseless observations the benchmark simulates)."""
    p = model.split(named)
    raw, _ = model.raw_and_ps(p)
    return model.convolve(raw, "psf")
