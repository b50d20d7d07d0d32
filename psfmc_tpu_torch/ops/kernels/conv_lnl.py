"""Batched convolution + Gaussian likelihood: CUDA kernel wrapper and plain version.

Counterpart of ``psfmc_tpu/ops/pallas/lnpost_batched.py``
(``make_batched_conv_lnl``): given rendered raw model images ``(B, H,
W)``, convolve each with the PSF and its square with the PSF variance
map, then reduce the masked Gaussian lnL per walker:

    lnl_b = -1/2 sum_good [(obs - conv_b)^2 ivm_b - log(ivm_b / 2 pi)],
    ivm_b = 1 / (mvar_b + obs_var)

with non-finite results mapped to ``-inf``.  The convolutions are the
twelve real half-spectrum products of
:func:`psfmc_tpu_torch.ops.fourier.convolve_rdft`; the CUDA kernel
(``csrc/conv_lnl.cu``) runs them as fp32 FMA GEMMs of its own.  The
Pallas kernel's emulated-precision dot modes (bf16x3) existed only
because Mosaic lacks an fp32-accurate product; they are not ported:
true fp32 is the contract.

On CPU tensors :func:`batched_conv_lnl` returns the plain version; on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..fourier import convolve_rdft, rdft_matrices
from ..likelihood import gaussian_lnlike
from . import _build

__all__ = [
    "ConvLnlConsts",
    "make_conv_lnl_consts",
    "batched_conv_lnl",
    "batched_conv_lnl_plain",
]


@dataclass(frozen=True)
class ConvLnlConsts:
    """Device constants of the conv+likelihood stage.

    The eight :func:`rdft_matrices` operators, the PSF and PSF-variance
    half spectra as real/imaginary planes ``(H, W2)``, the observation,
    its variance and the good-pixel mask ``(H, W)``, plus the two
    ``(2H, 2H)`` block operators the kernel uses for the h-direction
    stages: ``lf = [[ch, sh], [-sh, ch]]`` and ``li = [[ich, -ish],
    [ish, ich]]``.
    """

    cw: torch.Tensor
    sw: torch.Tensor
    ch: torch.Tensor
    sh: torch.Tensor
    ich: torch.Tensor
    ish: torch.Tensor
    ica: torch.Tensor
    isa: torch.Tensor
    psf_r: torch.Tensor
    psf_i: torch.Tensor
    var_r: torch.Tensor
    var_i: torch.Tensor
    obs: torch.Tensor
    obs_var: torch.Tensor
    good: torch.Tensor  # bool
    lf: torch.Tensor
    li: torch.Tensor
    good_f: torch.Tensor  # good as {0, 1} in the working dtype

    @property
    def mats(self):
        return (self.cw, self.sw, self.ch, self.sh, self.ich, self.ish,
                self.ica, self.isa)

    @property
    def shape(self):
        return tuple(self.obs.shape)


def make_conv_lnl_consts(f_psf, f_var, obs, obs_var, good, device,
                         dtype=torch.float32):
    """Build :class:`ConvLnlConsts` from host numpy arrays.

    ``f_psf``/``f_var`` are complex half spectra ``(H, W//2+1)`` (one
    PSF); ``obs``/``obs_var`` real ``(H, W)``; ``good`` boolean.
    """
    obs = np.asarray(obs)
    shape = obs.shape
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    mats = rdft_matrices(shape, np_dtype)
    cw, sw, ch, sh, ich, ish, ica, isa = mats
    lf = np.block([[ch, sh], [-sh, ch]])
    li = np.block([[ich, -ish], [ish, ich]])
    f_psf = np.asarray(f_psf)
    f_var = np.asarray(f_var)
    good = np.asarray(good, bool)
    arrays = dict(
        cw=cw, sw=sw, ch=ch, sh=sh, ich=ich, ish=ish, ica=ica, isa=isa,
        psf_r=f_psf.real, psf_i=f_psf.imag,
        var_r=f_var.real, var_i=f_var.imag,
        obs=obs, obs_var=np.asarray(obs_var), lf=lf, li=li,
        good_f=good.astype(np_dtype),
    )
    tensors = {
        k: torch.as_tensor(np.ascontiguousarray(v, np_dtype), device=device)
        for k, v in arrays.items()
    }
    tensors["good"] = torch.as_tensor(good, device=device)
    return ConvLnlConsts(**tensors)


def batched_conv_lnl_plain(raws, consts: ConvLnlConsts):
    """Plain PyTorch version: ``convolve_rdft`` twice + ``gaussian_lnlike``."""
    c = consts
    conv = convolve_rdft(raws, c.psf_r, c.psf_i, c.mats)
    mvar = convolve_rdft(raws * raws, c.var_r, c.var_i, c.mats)
    ivm = 1.0 / (mvar + c.obs_var)
    return gaussian_lnlike(c.obs - conv, ivm, c.good)


# conv_lnl_launch(raws, batch, h, w, <these constants>, t1, t2, conv,
# mvar, out, stream)
_CONST_ARGS = ("cw", "sw", "lf", "li", "ica", "isa", "psf_r", "psf_i",
               "var_r", "var_i", "obs", "obs_var", "good_f")


@functools.lru_cache(maxsize=1)
def _kernel():
    return _build.function(
        "conv_lnl", "conv_lnl_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * (len(_CONST_ARGS) + 6),
    )


def _launch(raws, consts: ConvLnlConsts):
    if raws.dtype != torch.float32:
        raise TypeError(f"the CUDA conv_lnl takes float32, got {raws.dtype}")
    for f in fields(consts):
        t = getattr(consts, f.name)
        if t.device != raws.device:
            raise ValueError(f"consts.{f.name} is on {t.device}, raws on {raws.device}")
        if f.name != "good" and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"consts.{f.name} must be contiguous float32")
    raws = raws.contiguous()
    b, h, w = raws.shape
    w2 = w // 2 + 1
    dev = raws.device
    t1 = torch.empty((b, 2, h, w2), dtype=torch.float32, device=dev)
    t2 = torch.empty_like(t1)
    conv = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    mvar = torch.empty_like(conv)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    tensors = [getattr(consts, n) for n in _CONST_ARGS] + [t1, t2, conv, mvar, out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(raws.data_ptr(), b, h, w,
                        *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(f"conv_lnl launch failed: cudaError {err}")
    return out


def batched_conv_lnl(raws, consts: ConvLnlConsts):
    """``(B, H, W)`` raw images -> ``(B,)`` Gaussian lnL (see module doc)."""
    if raws.ndim != 3 or tuple(raws.shape[1:]) != consts.shape:
        raise ValueError(
            f"raws must be (B, {consts.shape[0]}, {consts.shape[1]}), "
            f"got {tuple(raws.shape)}"
        )
    if raws.device.type == "cpu":
        return batched_conv_lnl_plain(raws, consts)
    if raws.device.type != "cuda":
        raise ValueError(f"unsupported device {raws.device}")
    out = _launch(raws, consts)
    batched_conv_lnl.launches += 1
    return out


batched_conv_lnl.launches = 0
