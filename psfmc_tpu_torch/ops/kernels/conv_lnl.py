"""Batched convolution + Gaussian likelihood: CUDA kernel wrapper and plain version.

Counterpart of ``psfmc_tpu/ops/pallas/lnpost_batched.py``
(``make_batched_conv_lnl``): given rendered raw model images ``(B, H,
W)``, convolve each with the PSF and its square with the PSF variance
map, then reduce the masked Gaussian lnL per walker:

    lnl_b = -1/2 sum_good [(obs - conv_b)^2 ivm_b - log(ivm_b / 2 pi)],
    ivm_b = 1 / (mvar_b + obs_var)

with non-finite results mapped to ``-inf``.  The CUDA source
(``csrc/conv_lnl.cu``) has two routes, and the shape alone picks one
before the launch (:func:`conv_route`):

* ``"fft"``, when ``H`` and ``W`` are powers of two and one walker fits
  in a block's shared memory (64x64, 128x128, 64x256, ...): one launch,
  one block per walker, both convolutions as one complex 2-D FFT pair
  that never leaves shared memory (``csrc/fft_conv.cuh``).
  :func:`packed_fft_conv_plain` is that scheme in plain PyTorch and
  :func:`fft_stages_plain` its butterfly schedule, for the tests;
* ``"dft"``, every other shape: each convolution as the twelve real
  half-spectrum products of
  :func:`psfmc_tpu_torch.ops.fourier.convolve_rdft`, run as fp32 FMA
  GEMMs of the kernel's own through global scratch (15 launches).

Neither route is a fallback for the other: a launch that fails raises.
The Pallas kernel's emulated-precision dot modes (bf16x3) existed only
because Mosaic lacks an fp32-accurate product; they are not ported:
true fp32 is the contract.

On CPU tensors :func:`batched_conv_lnl` returns the plain version
(:func:`batched_conv_lnl_plain`, the version of record that both routes
are held to); on CUDA tensors it launches the kernel or raises.

The gradient: when the raw images require it, :func:`batched_conv_lnl`
goes through a ``torch.autograd.Function`` whose backward maps ``dlnL
(B,)`` to ``dlnL/draw (B, H, W)`` (:func:`batched_conv_lnl_backward`).
With ``r = obs - conv`` and ``ivm = 1 / (mvar + obs_var)``::

    a = good r ivm,   c = good (r^2 ivm^2 - ivm) / 2,
    dlnL/draw = dlnL_b [a (x) psf + 2 raw (c (x) var)]

where ``(x)`` is the adjoint of the forward convolution (a correlation:
the conjugate spectrum, the shift undone); a walker whose lnL is not
finite gets a zero gradient.  On CUDA the hand-written kernels of
``csrc/conv_lnl_backward.cu`` on the route the shape takes (the FFT
route: one launch that recomputes the pair and runs the packed pair ``a
+ i s c`` through the same in-shared-memory FFT with the conjugate
spectra; the matmul-DFT route: the transposed GEMMs), on the CPU
:func:`batched_conv_lnl_backward_plain`.  :func:`packed_fft_conv_backward_plain`
is the FFT route's scheme in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..fourier import convolve_rdft, rdft_matrices
from ..likelihood import gaussian_lnlike
from . import _build, counts

__all__ = [
    "batched_lnl_supported",
    "ConvLnlConsts",
    "make_conv_lnl_consts",
    "batched_conv_lnl",
    "batched_conv_lnl_plain",
    "conv_route",
    "fft_smem_bytes",
    "fft_twiddles",
    "var_spectrum_gain",
    "fft_stages_plain",
    "bit_reversed",
    "packed_fft_conv_plain",
    "batched_conv_lnl_backward",
    "batched_conv_lnl_backward_plain",
    "packed_fft_conv_backward_plain",
    "convolve_rdft_adjoint",
]

# Shared memory a block may use on Hopper.
BLOCK_SMEM_LIMIT = 232448
# Static shared memory of the FFT route (csrc/fft_conv.cuh): 16 doubles of
# the lnL reduction and 16 floats of the max reduction.
_FFT_STATIC_SMEM = 16 * 8 + 16 * 4
# |log2| of the squared image's scale is clamped to this (kMaxScaleExp).
_MAX_SCALE_EXP = 96


def _power_of_two(n):
    return n >= 2 and n & (n - 1) == 0


def fft_smem_bytes(shape):
    """Dynamic shared memory of the FFT route's image: ``H`` rows of
    ``W + 1`` ``float2`` (the odd pitch keeps the row passes free of
    bank conflicts) plus the ``max(H, W) / 2`` twiddles."""
    h, w = shape
    return 8 * (h * (w + 1) + max(h, w) // 2)


def conv_route(shape):
    """``"fft"`` or ``"dft"``: the route of ``csrc/conv_lnl.cu`` and
    ``csrc/fused_lnl.cu`` for an ``(H, W)`` image, a pure function of the
    shape.  ``"fft"`` needs both sizes to be powers of two (>= 2) and the
    walker's image to fit in one block's shared memory."""
    h, w = (int(n) for n in shape)
    fits = fft_smem_bytes((h, w)) + _FFT_STATIC_SMEM <= BLOCK_SMEM_LIMIT
    return "fft" if _power_of_two(h) and _power_of_two(w) and fits else "dft"


def fft_twiddles(n, dtype=np.float32):
    """``(n / 2, 2)`` table of ``exp(-2 pi i k / n)`` as ``(cos, -sin)``,
    built in float64 and cast; ``n`` a power of two.  A line of length
    ``n / 2^j`` reads every ``2^j``-th entry."""
    if not _power_of_two(n):
        raise ValueError(f"the twiddle table needs a power of two, got {n}")
    ang = 2.0 * np.pi * np.arange(n // 2) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)


def batched_lnl_supported(spec):
    """``(ok, reason)``: whether the conv+likelihood kernel computes
    ``spec``'s likelihood (the JAX package's ``batched_lnl_supported``).

    The kernel holds one PSF's spectra, reduces the Gaussian lnL of the
    unscaled variance, and has no place for a background added after the
    convolution or for a padded grid: several PSFs, another likelihood
    family, a tilted-plane sky, a ``NoiseScale`` and ``conv_pad`` take
    the general path instead.
    """
    specs = getattr(spec, "comp_specs", ())
    checks = (
        (getattr(spec, "num_psfs", 1) == 1, "several PSFs"),
        (getattr(spec, "likelihood", "gaussian") == "gaussian",
         "a non-Gaussian likelihood"),
        (all(not ({"dx", "dy"} & set(cs.params))
             for cs in specs if cs.kind == "sky"), "a sky gradient"),
        (all(cs.kind != "noisescale" for cs in specs), "a NoiseScale"),
        (getattr(spec, "conv_pad", 0) == 0, "conv_pad > 0"),
    )
    for ok, what in checks:
        if not ok:
            return False, what
    return True, ""


@dataclass(frozen=True)
class ConvLnlConsts:
    """Device constants of the conv+likelihood stage.

    The eight :func:`rdft_matrices` operators, the PSF and PSF-variance
    half spectra as real/imaginary planes ``(H, W2)``, the observation,
    its variance and the good-pixel mask ``(H, W)``, plus the two
    ``(2H, 2H)`` block operators the matmul-DFT route uses for the
    h-direction stages: ``lf = [[ch, sh], [-sh, ch]]`` and ``li = [[ich,
    -ish], [ish, ich]]``; and the FFT route's twiddle table
    (:func:`fft_twiddles` of ``max(H, W)``; empty unless both sizes are
    powers of two) and its gain on the variance spectrum
    (:func:`var_spectrum_gain`).  The backward kernels also read the
    conjugate spectra's imaginary planes (``psf_ic = -psf_i``, ``var_ic =
    -var_i``) and the transposed operators (``*_t``).
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
    twiddle: torch.Tensor  # (max(H, W) / 2, 2), or (0, 2)
    var_gain: torch.Tensor  # (1,): a power of two, see var_spectrum_gain
    # the backward's: the conjugate spectra's imaginary planes and the
    # transposed operators, each contiguous
    psf_ic: torch.Tensor
    var_ic: torch.Tensor
    ica_t: torch.Tensor
    isa_t: torch.Tensor
    li_t: torch.Tensor
    lf_t: torch.Tensor
    cw_t: torch.Tensor
    sw_t: torch.Tensor

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
    if all(_power_of_two(n) for n in shape):
        twiddle = fft_twiddles(max(shape), np_dtype)
    else:
        twiddle = np.zeros((0, 2), np_dtype)
    arrays = dict(
        cw=cw, sw=sw, ch=ch, sh=sh, ich=ich, ish=ish, ica=ica, isa=isa,
        psf_r=f_psf.real, psf_i=f_psf.imag,
        var_r=f_var.real, var_i=f_var.imag,
        obs=obs, obs_var=np.asarray(obs_var), lf=lf, li=li,
        good_f=good.astype(np_dtype), twiddle=twiddle,
        var_gain=np.array([var_spectrum_gain(f_psf, f_var)]),
        psf_ic=-f_psf.imag, var_ic=-f_var.imag, ica_t=ica.T, isa_t=isa.T,
        li_t=li.T, lf_t=lf.T, cw_t=cw.T, sw_t=sw.T,
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


def var_spectrum_gain(f_psf, f_var):
    """The power of two nearest ``|Kpsf(0)| / |Kvar(0)|`` (within
    ``2^±96``; 1 where the ratio is 0 or not finite).

    The FFT route carries both convolutions in one complex image, ``conv
    + i s g mvar``.  A PSF variance map is many orders of magnitude below
    the PSF (sums of 4e-5 and 1 on the flagship), and in float32 the
    smaller part of a complex product or transform is only as exact as
    the larger part's rounding: the variance spectrum is multiplied by
    ``g`` (exact) so that both parts have the same scale, and ``mvar`` is
    divided by it at the readout."""
    ratio = abs(complex(np.asarray(f_psf)[0, 0])) / max(
        abs(complex(np.asarray(f_var)[0, 0])), 1e-300)
    if not np.isfinite(ratio) or ratio <= 0.0:
        return 1.0
    exponent = int(np.clip(np.rint(np.log2(ratio)), -_MAX_SCALE_EXP,
                           _MAX_SCALE_EXP))
    return float(2.0 ** exponent)


def bit_reversed(n):
    """Indices ``0 .. n-1`` with their ``log2 n`` bits reversed."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _stages_1d(z, tw, inverse):
    """The radix-2 stages of the last axis (length ``n``, a power of
    two).  Forward: decimation in frequency, natural order in,
    bit-reversed out; stage ``s`` pairs elements ``n >> (s + 1)`` apart as
    ``(a + b, (a - b) w)``.  Inverse: the stages undone in reverse order,
    ``(a + b conj w, a - b conj w)``, bit-reversed in, natural out,
    unnormalised."""
    n = z.shape[-1]
    m = n.bit_length() - 1
    scale = 2 * tw.shape[0] // n  # the table serves max(H, W)
    lead = z.shape[:-1]
    for s in (range(m - 1, -1, -1) if inverse else range(m)):
        half = n >> (s + 1)
        w = tw[(torch.arange(half, device=z.device) << s) * scale]
        z = z.reshape(*lead, n // (2 * half), 2, half)
        a, b = z[..., 0, :], z[..., 1, :]
        if inverse:
            b = b * w.conj()
            z = torch.stack([a + b, a - b], dim=-2)
        else:
            z = torch.stack([a + b, (a - b) * w], dim=-2)
        z = z.reshape(*lead, n)
    return z


def fft_stages_plain(z, twiddles, inverse=False):
    """The FFT route's butterfly schedule on a complex ``(..., H, W)``
    tensor, stage by stage, from the same twiddle table.

    Forward: rows then columns, decimation in frequency; the result holds
    bin ``(ky, kx)`` at ``(bit_reversed(H)[ky], bit_reversed(W)[kx])``.
    ``inverse=True`` takes that layout back: columns then rows,
    decimation in time, unnormalised (``H W`` times ``ifft2``).  The
    kernel runs up to four of these stages per trip through shared
    memory on values held in registers; the arithmetic is the same.
    """
    tw = torch.complex(twiddles[:, 0], twiddles[:, 1])
    if inverse:
        z = _stages_1d(z.transpose(-1, -2), tw, True).transpose(-1, -2)
        return _stages_1d(z, tw, True)
    z = _stages_1d(z, tw, False)
    return _stages_1d(z.transpose(-1, -2), tw, False).transpose(-1, -2)


def _mirrored(z):
    """``z[(-ky) mod H, (-kx) mod W]`` over the trailing axes."""
    return torch.roll(torch.flip(z, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))


def _full_spectrum(k_r, k_i, w):
    """The ``(H, W)`` spectrum of a real kernel from its half spectrum
    ``(H, W//2+1)``: ``K(-k) = conj K(k)`` fills the columns above
    ``W/2``."""
    half = torch.complex(k_r, k_i)
    rows_mirrored = torch.roll(torch.flip(half, dims=(-2,)), 1, dims=-2)
    rest = rows_mirrored.conj()[..., 1:w - w // 2].flip(-1)
    return torch.cat([half, rest], dim=-1)


def packed_fft_conv_plain(raws, consts: ConvLnlConsts):
    """``(conv, mvar)`` of ``(B, H, W)`` raw images by the FFT route's
    scheme, in plain PyTorch.

    Pack ``z = raw + i s raw^2`` with the per-walker power-of-two scale
    ``s = 2^-floor(log2 max|raw|)`` (``1`` where the max is 0 or not
    finite; NaNs do not count towards the max); one complex ``fft2``;
    the Hermitian split with the mirrored index, ``A = (Z + conj Z~) /
    2`` and ``B = (Z - conj Z~) / 2i``; ``Y = A Kpsf + i B (g Kvar)``
    with the kernels' spectra completed from their half spectra and the
    gain ``g`` of :func:`var_spectrum_gain`; one ``ifft2``; the ifftshift
    as a shifted readout; ``mvar`` unscaled by ``1 / (s g)``.
    ``raw * raw`` is formed before the scale is applied.
    """
    c = consts
    h, w = c.shape
    exponent, _ = _peak_exponent(raws)
    exponent = exponent.clamp(-_MAX_SCALE_EXP, _MAX_SCALE_EXP)
    one = torch.ones_like(raws[..., 0, 0])
    s = torch.ldexp(one, -exponent)[..., None, None]
    inv_s = torch.ldexp(one, exponent)[..., None, None]
    z = torch.fft.fft2(torch.complex(raws, (raws * raws) * s))
    zm = _mirrored(z).conj()
    a = 0.5 * (z + zm)
    b = -0.5j * (z - zm)
    y = a * _full_spectrum(c.psf_r, c.psf_i, w) \
        + 1j * b * (_full_spectrum(c.var_r, c.var_i, w) * c.var_gain)
    y = torch.roll(torch.fft.ifft2(y), shifts=(-(h // 2), -(w // 2)),
                   dims=(-2, -1))
    return y.real, y.imag * (inv_s / c.var_gain)


# conv_lnl_launch(raws, batch, h, w, <these constants>, t1, t2, conv,
# mvar, out, stream)
_DFT_CONST_ARGS = ("cw", "sw", "lf", "li", "ica", "isa", "psf_r", "psf_i",
                   "var_r", "var_i", "obs", "obs_var", "good_f")
# conv_lnl_fft_launch(raws, batch, h, w, <these constants>, out, stream)
FFT_CONST_ARGS = ("twiddle", "var_gain", "psf_r", "psf_i", "var_r", "var_i",
                  "obs", "obs_var", "good_f")


@functools.lru_cache(maxsize=1)
def _dft_kernel():
    return _build.function(
        "conv_lnl", "conv_lnl_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * (len(_DFT_CONST_ARGS) + 6),
    )


@functools.lru_cache(maxsize=1)
def _fft_kernel():
    return _build.function(
        "conv_lnl", "conv_lnl_fft_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * (len(FFT_CONST_ARGS) + 2),
    )


def check_launch_consts(consts: ConvLnlConsts, device):
    """Raise unless every constant is a contiguous float32 tensor on
    ``device`` (the mask ``good`` only needs the device), as the CUDA
    kernels take them."""
    for f in fields(consts):
        t = getattr(consts, f.name)
        if t.device != device:
            raise ValueError(f"consts.{f.name} is on {t.device}, inputs on {device}")
        if f.name != "good" and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"consts.{f.name} must be contiguous float32")


def _launch_dft(raws, consts: ConvLnlConsts):
    """The matmul-DFT route: 15 launches through global scratch."""
    b, h, w = raws.shape
    w2 = w // 2 + 1
    dev = raws.device
    t1 = torch.empty((b, 2, h, w2), dtype=torch.float32, device=dev)
    t2 = torch.empty_like(t1)
    conv = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    mvar = torch.empty_like(conv)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    tensors = [getattr(consts, n) for n in _DFT_CONST_ARGS] + [t1, t2, conv, mvar, out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _dft_kernel()(raws.data_ptr(), b, h, w,
                            *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(f"conv_lnl launch failed: cudaError {err}")
    return out


def _launch_fft(raws, consts: ConvLnlConsts):
    """The FFT route: one launch, no allocation but the output."""
    b, h, w = raws.shape
    out = torch.empty((b,), dtype=torch.float32, device=raws.device)
    tensors = [getattr(consts, n) for n in FFT_CONST_ARGS] + [out]
    with torch.cuda.device(raws.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fft_kernel()(raws.data_ptr(), b, h, w,
                            *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(
            f"conv_lnl (FFT route) launch failed: cudaError {err} ({h}x{w} "
            f"walker, {fft_smem_bytes((h, w))} bytes of shared memory)")
    return out


def _launch(raws, consts: ConvLnlConsts, route):
    if raws.dtype != torch.float32:
        raise TypeError(f"the CUDA conv_lnl takes float32, got {raws.dtype}")
    check_launch_consts(consts, raws.device)
    raws = raws.contiguous()
    if route == "fft":
        return _launch_fft(raws, consts)
    return _launch_dft(raws, consts)


def batched_conv_lnl(raws, consts: ConvLnlConsts):
    """``(B, H, W)`` raw images -> ``(B,)`` Gaussian lnL (see module doc)."""
    if raws.ndim != 3 or tuple(raws.shape[1:]) != consts.shape:
        raise ValueError(
            f"raws must be (B, {consts.shape[0]}, {consts.shape[1]}), "
            f"got {tuple(raws.shape)}"
        )
    if torch.is_grad_enabled() and raws.requires_grad:
        return _ConvLnl.apply(raws, consts)
    return _forward(raws, consts)


def _forward(raws, consts):
    if raws.device.type == "cpu":
        return batched_conv_lnl_plain(raws, consts)
    if raws.device.type != "cuda":
        raise ValueError(f"unsupported device {raws.device}")
    route = conv_route(consts.shape)
    out = _launch(raws, consts, route)
    counts.count(batched_conv_lnl, route)
    return out


batched_conv_lnl.launches = 0
batched_conv_lnl.route_launches = {"fft": 0, "dft": 0}


class _ConvLnl(torch.autograd.Function):
    """conv_lnl with its vector-Jacobian product: the forward is the
    wrapper's own launch, the backward :func:`batched_conv_lnl_backward`."""

    @staticmethod
    def forward(ctx, raws, consts):
        lnl = _forward(raws, consts)
        ctx.consts = consts
        ctx.save_for_backward(raws, lnl)
        return lnl

    @staticmethod
    def backward(ctx, grad):
        raws, lnl = ctx.saved_tensors
        return batched_conv_lnl_backward(raws, ctx.consts, lnl, grad), None


def convolve_rdft_adjoint(img, kernel_r, kernel_i, mats):
    """The adjoint of :func:`~psfmc_tpu_torch.ops.fourier.convolve_rdft`:
    its twelve products transposed and taken in reverse order, with the
    conjugate spectrum (a circular correlation whose shift undoes the
    forward's ifftshift)."""
    cw, sw, ch, sh, ich, ish, ica, isa = mats
    s4r = img @ ica.T
    s4i = -(img @ isa.T)
    s3r = ich.T @ s4r + ish.T @ s4i
    s3i = ich.T @ s4i - ish.T @ s4r
    s2r = s3r * kernel_r + s3i * kernel_i
    s2i = s3i * kernel_r - s3r * kernel_i
    s1r = ch.T @ s2r - sh.T @ s2i
    s1i = sh.T @ s2r + ch.T @ s2i
    return s1r @ cw.T - s1i @ sw.T


def _adjoint_weights(conv, mvar, consts: ConvLnlConsts):
    """``(a, c)``: dlnL/dconv and dlnL/dmvar per pixel, 0 at bad pixels."""
    c = consts
    ivm = 1.0 / (mvar + c.obs_var)
    resid = c.obs - conv
    zero = torch.zeros_like(resid)
    a = torch.where(c.good, resid * ivm, zero)
    cc = torch.where(c.good, 0.5 * (resid * resid * ivm * ivm - ivm), zero)
    return a, cc


def _combine(raws, ga, gc, lnl, grad):
    out = grad[:, None, None] * (ga + 2.0 * raws * gc)
    return torch.where(torch.isfinite(lnl)[:, None, None], out, torch.zeros_like(out))


def batched_conv_lnl_backward_plain(raws, consts: ConvLnlConsts, lnl, grad):
    """Plain PyTorch version of the backward (the version of record):
    ``grad_b [a (x) psf + 2 raw (c (x) var)]``, 0 for a walker whose
    ``lnl`` is not finite (see the module doc)."""
    c = consts
    conv = convolve_rdft(raws, c.psf_r, c.psf_i, c.mats)
    mvar = convolve_rdft(raws * raws, c.var_r, c.var_i, c.mats)
    a, cc = _adjoint_weights(conv, mvar, c)
    ga = convolve_rdft_adjoint(a, c.psf_r, c.psf_i, c.mats)
    gc = convolve_rdft_adjoint(cc, c.var_r, c.var_i, c.mats)
    return _combine(raws, ga, gc, lnl, grad)


def _peak_exponent(images):
    """``(floor(log2 max|image|), usable)`` per image of ``(..., H, W)``:
    NaNs do not count towards the max, and where the max is 0 or not
    finite the exponent is 0 and ``usable`` False."""
    peak = torch.nan_to_num(images.abs(), nan=0.0, posinf=float("inf"))
    peak = peak.amax(dim=(-2, -1))
    usable = torch.isfinite(peak) & (peak > 0)
    exponent = torch.frexp(torch.where(usable, peak, torch.ones_like(peak)))[1] - 1
    return exponent, usable


def packed_fft_conv_backward_plain(raws, consts: ConvLnlConsts, lnl, grad):
    """The FFT route's backward scheme in plain PyTorch.

    Recompute ``(conv, mvar)`` by :func:`packed_fft_conv_plain`; form
    ``a`` and ``c``; pack ``z = a + i s c`` at the shifted positions (the
    forward's readout shift undone), with the power of two ``s =
    2^(e_a - e_c)`` (``e`` the exponents of each part's peak, 1 where
    either peak is 0 or not finite, within ``2^±96``) that gives both
    parts one scale; one ``fft2``; the Hermitian split; ``Y = A conj
    Kpsf + i B (g conj Kvar)``; one ``ifft2``; ``a (x) psf`` is the real
    part and ``c (x) var`` the imaginary part over ``s g``.
    """
    c = consts
    h, w = c.shape
    conv, mvar = packed_fft_conv_plain(raws, c)
    a, cc = _adjoint_weights(conv, mvar, c)
    ea, oka = _peak_exponent(a)
    ec, okc = _peak_exponent(cc)
    exponent = torch.where(oka & okc, ea - ec, torch.zeros_like(ea))
    exponent = exponent.clamp(-_MAX_SCALE_EXP, _MAX_SCALE_EXP)
    one = torch.ones_like(lnl)
    s = torch.ldexp(one, exponent)[:, None, None]
    inv_s = torch.ldexp(one, -exponent)[:, None, None]
    z = torch.roll(torch.complex(a, cc * s), shifts=(h // 2, w // 2), dims=(-2, -1))
    z = torch.fft.fft2(z)
    zm = _mirrored(z).conj()
    za = 0.5 * (z + zm)
    zb = -0.5j * (z - zm)
    y = za * _full_spectrum(c.psf_r, c.psf_i, w).conj() \
        + 1j * zb * (_full_spectrum(c.var_r, c.var_i, w).conj() * c.var_gain)
    y = torch.fft.ifft2(y)
    return _combine(raws, y.real, y.imag * (inv_s / c.var_gain), lnl, grad)


@functools.lru_cache(maxsize=1)
def _fft_backward_kernel():
    return _build.function(
        "conv_lnl_backward", "conv_lnl_fft_backward_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * (len(FFT_BACKWARD_CONST_ARGS) + 4),
    )


@functools.lru_cache(maxsize=1)
def _dft_backward_kernel():
    return _build.function(
        "conv_lnl_backward", "conv_lnl_dft_backward_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * (len(DFT_BACKWARD_CONST_ARGS) + 9),
    )


# conv_lnl_fft_backward_launch(raws, batch, h, w, <these>, lnl, grad, out,
# stream): the forward pair's spectra, then the conjugates'
FFT_BACKWARD_CONST_ARGS = ("twiddle", "var_gain", "psf_r", "psf_i", "var_r",
                           "var_i", "psf_ic", "var_ic", "obs", "obs_var",
                           "good_f")
# conv_lnl_dft_backward_launch(raws, batch, h, w, <these>, lnl, grad, t1,
# t2, conv, mvar, ga, gc, out, stream): the forward's operators, the
# adjoint's (the transposes, in the order the adjoint applies them)
DFT_BACKWARD_CONST_ARGS = ("cw", "sw", "lf", "li", "ica", "isa", "ica_t",
                           "isa_t", "li_t", "lf_t", "cw_t", "sw_t", "psf_r",
                           "psf_i", "var_r", "var_i", "psf_ic", "var_ic",
                           "obs", "obs_var", "good_f")


def _launch_backward(raws, consts: ConvLnlConsts, lnl, grad, route):
    if raws.dtype != torch.float32 or grad.dtype != torch.float32:
        raise TypeError("the CUDA conv_lnl backward takes float32")
    check_launch_consts(consts, raws.device)
    raws, lnl, grad = raws.contiguous(), lnl.contiguous(), grad.contiguous()
    b, h, w = raws.shape
    dev = raws.device
    out = torch.empty_like(raws)
    if route == "fft":
        fn, names, scratch = _fft_backward_kernel(), FFT_BACKWARD_CONST_ARGS, []
    else:
        t1 = torch.empty((b, 2, h, w // 2 + 1), dtype=torch.float32, device=dev)
        scratch = [t1, torch.empty_like(t1)] + [torch.empty_like(raws)
                                               for _ in range(4)]
        fn, names = _dft_backward_kernel(), DFT_BACKWARD_CONST_ARGS
    tensors = [getattr(consts, n) for n in names] + [lnl, grad] + scratch + [out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(raws.data_ptr(), b, h, w, *(t.data_ptr() for t in tensors), stream)
    if err != 0:
        raise RuntimeError(
            f"conv_lnl backward ({route} route) launch failed: cudaError {err}")
    return out


def batched_conv_lnl_backward(raws, consts: ConvLnlConsts, lnl, grad):
    """``dlnL/draw (B, H, W)`` of :func:`batched_conv_lnl` at ``raws``
    (whose lnL was ``lnl``) for the output gradient ``grad (B,)``.  On
    CUDA the backward kernel of the route :func:`conv_route` picks
    (counted in ``batched_conv_lnl_backward.launches`` and
    ``.route_launches``), on the CPU
    :func:`batched_conv_lnl_backward_plain`."""
    if raws.device.type == "cpu":
        return batched_conv_lnl_backward_plain(raws, consts, lnl, grad)
    if raws.device.type != "cuda":
        raise ValueError(f"unsupported device {raws.device}")
    route = conv_route(consts.shape)
    out = _launch_backward(raws, consts, lnl, grad, route)
    counts.count(batched_conv_lnl_backward, route)
    return out


batched_conv_lnl_backward.launches = 0
batched_conv_lnl_backward.route_launches = {"fft": 0, "dft": 0}
