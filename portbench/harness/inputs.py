"""The cell's inputs, made from ``--seed``: observations, PSF star, mask, model file.

Everything is drawn from one ``torch.Generator`` on the run's device,
seeded from the seed, in a few large calls: each target's truth (the
configuration's ``truth`` values, each moved uniformly within its
half-width, all inside the priors), the PSF star's width and
ellipticity, and the noise.  The float64 reference renders and convolves
the truths; the observations are that plus the noise, rounded to float32
as a camera's FITS files hold them.  The files (observation, weight, PSF
star, its weight, a ds9 mask and the psfMC model file) go to a directory
under the run's ``TMPDIR``; the same arrays go to the reference.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..reference.posterior import ReferenceModel, param_names, render_truth
from .fitsio import write_image

__all__ = ["Inputs", "make_inputs", "model_file_text", "mask_region_text", "region_bad"]


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, shape, device):
    return torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def _psf_star(cfg, g, device):
    """A 64x64 elliptical Gaussian whose width and ellipticity come from
    the seed; its centre on pixel ``m // 2``, where the centre-padding puts
    the transform's origin."""
    ph, pw = cfg["psf_shape"]
    (s0, ds), (e0, de) = cfg["psf"]["sigma"], cfg["psf"]["ellipticity"]
    u = _uniform(g, (3,), device).cpu().numpy()
    sigma = s0 + ds * (2 * u[0] - 1)
    ell = e0 + de * (2 * u[1] - 1)
    theta = math.pi * u[2]
    yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float64)
    dx, dy = xx - pw // 2, yy - ph // 2
    c, s = math.cos(theta), math.sin(theta)
    a, b = sigma * (1 + ell), sigma / (1 + ell)
    u_, v_ = (c * dx + s * dy) / a, (-s * dx + c * dy) / b
    psf = np.exp(-0.5 * (u_ * u_ + v_ * v_))
    return (psf / psf.sum()).astype(np.float32)


def mask_region_text(cfg):
    """The ds9 region file of the configuration's mask (image frame,
    1-based): the include circles, then the excluded ones."""
    lines = ["# Region file format: DS9", "image"]
    lines += [f"circle({x:g},{y:g},{r:g})" for x, y, r in cfg["mask"]["include"]]
    lines += [f"-circle({x:g},{y:g},{r:g})" for x, y, r in cfg["mask"]["exclude"]]
    return "\n".join(lines) + "\n"


def region_bad(cfg):
    """The mask as a bad-pixel map (True = excluded): a pixel is kept when
    its centre (1-based) lies in an include circle and in no exclude one."""
    h, w = cfg["shape"]
    yy, xx = np.mgrid[1:h + 1, 1:w + 1].astype(np.float64)

    def inside(circles):
        hit = np.zeros((h, w), bool)
        for x, y, r in circles:
            hit |= (xx - x) ** 2 + (yy - y) ** 2 <= r * r
        return hit

    return ~(inside(cfg["mask"]["include"]) & ~inside(cfg["mask"]["exclude"]))


def _prior_text(prior):
    args = {k: v for k, v in prior.items() if k != "prior"}
    text = ", ".join(f"{k}={'array(' + repr(v) + ')' if isinstance(v, list) else repr(v)}"
                     for k, v in args.items())
    return f"{prior['prior']}({text})"


def model_file_text(cfg, names):
    """A psfMC model file of the configuration: its Configuration names
    the files in ``names`` (obs, ivm, psf, psf_ivm, mask)."""
    comps = cfg["components"]
    kinds = sorted({c["type"] for c in comps} | {"Configuration"})
    priors = sorted({p["prior"] for c in comps for p in c["params"].values()})
    lines = ["from numpy import array", "",
             f"from psfMC.ModelComponents import {', '.join(kinds)}",
             f"from psfMC.distributions import {', '.join(priors)}", "",
             f"Configuration(obs_file={names['obs']!r}, obsivm_file={names['ivm']!r},",
             f"              psf_files={names['psf']!r}, psfivm_files={names['psf_ivm']!r},",
             f"              mask_file={names['mask']!r}, mag_zeropoint={cfg['mag_zeropoint']!r})"]
    for comp in comps:
        args = [f"{k}={_prior_text(p)}" for k, p in comp["params"].items()]
        if comp.get("angle_degrees"):
            args.append("angle_degrees=True")
        lines.append(f"{comp['type']}({', '.join(args)})")
    return "\n".join(lines) + "\n"


class Inputs:
    """One cell's inputs: ``targets`` observations of one field (the same
    PSF star, weight and mask), their truths, the files and the
    reference that judges the fits of them."""

    def __init__(self, cfg, obs, ivm, psf, psf_ivm, truths, directory, device):
        self.cfg = cfg
        self.obs, self.ivm, self.psf, self.psf_ivm = obs, ivm, psf, psf_ivm
        self.truths = truths
        self.directory = directory
        self.bad_mask = region_bad(cfg)
        self.device = device
        self.model_files = []
        names = dict(ivm="ivm.fits", psf="psf.fits", psf_ivm="psf_ivm.fits",
                     mask="mask.reg")
        write_image(os.path.join(directory, "ivm.fits"), ivm)
        write_image(os.path.join(directory, "psf.fits"), psf)
        write_image(os.path.join(directory, "psf_ivm.fits"), psf_ivm)
        with open(os.path.join(directory, "mask.reg"), "w") as fh:
            fh.write(mask_region_text(cfg))
        for k in range(obs.shape[0]):
            sci = f"sci{k}.fits"
            write_image(os.path.join(directory, sci), obs[k])
            path = os.path.join(directory, f"model{k}.py")
            with open(path, "w") as fh:
                fh.write(model_file_text(cfg, dict(names, obs=sci)))
            self.model_files.append(path)

    def reference(self, targets=None, precision="float64"):
        """The reference posterior of the observations ``targets`` (all by
        default), on the run's device."""
        obs = self.obs if targets is None else self.obs[targets]
        return ReferenceModel(self.cfg["components"], self.cfg["mag_zeropoint"], obs,
                              np.broadcast_to(self.ivm, obs.shape), self.psf,
                              self.psf_ivm, self.bad_mask, device=self.device,
                              precision=precision)


def make_inputs(cfg, seed, targets, directory, device):
    """Draw ``targets`` observations of the configuration from ``seed``
    and write their files to ``directory``."""
    g = _generator(seed, device)
    h, w = cfg["shape"]
    psf = _psf_star(cfg, g, device)
    psf_ivm = np.full(psf.shape, cfg["psf"]["ivm"], np.float32)
    sigma = float(cfg["noise_sigma"])
    ivm = np.full((h, w), 1.0 / sigma ** 2, np.float32)
    truths = {}
    for name, size in param_names(cfg["components"]):
        center, half = cfg["truth"][name]
        center = np.broadcast_to(np.asarray(center, np.float64), (size,))
        half = np.broadcast_to(np.asarray(half, np.float64), (size,))
        u = _uniform(g, (targets, size), device).cpu().numpy()
        value = center + half * (2 * u - 1)
        truths[name] = value[:, 0] if size == 1 else value
    blank = np.zeros((1, h, w), np.float32)
    ref = ReferenceModel(cfg["components"], cfg["mag_zeropoint"], blank,
                         ivm[None], psf, psf_ivm, np.zeros((h, w), bool), device=device)
    clean = render_truth(ref, truths)
    noise = torch.randn((targets, h, w), generator=g, device=device, dtype=torch.float64)
    obs = (clean + sigma * noise).to(torch.float32).cpu().numpy()
    return Inputs(cfg, obs, ivm, psf, psf_ivm, truths, directory, device)
