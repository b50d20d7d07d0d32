"""PSF convolution (port of ``ops/fourier.py``).

* :func:`pad_and_rfft_image` — host numpy, once per model build: the
  kernel is center-padded so its center ``m//2`` lands on the
  ifftshift origin ``N//2``, then ``rfft2``.
* :func:`convolve` — ``ifftshift(irfft2(rfft2(img) * K, s=img.shape))``:
  circular boundary, and ``s=`` keeps odd sizes round-tripping (the
  reference omits it and corrupts odd-sized images).
* :func:`rdft_matrices` + :func:`convolve_rdft` — the same convolution as
  twelve real half-spectrum matrix products, with the trailing
  ifftshift folded into the inverse operators' indexing.  The
  conv+likelihood kernel (``csrc/conv_lnl.cu``) runs these products;
  in torch they are plain fp32 ``matmul`` s (TF32 off, see
  :func:`psfmc_tpu_torch._device.pin_fp32_matmul`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pad_and_rfft_image",
    "convolve",
    "fft_convolve_direct",
    "rdft_matrices",
    "convolve_rdft",
]


def pad_and_rfft_image(img, newshape):
    """Center-pad ``img`` to ``newshape`` then rfft2 (host numpy)."""
    img = np.asarray(img)
    pad = np.asarray(newshape) - np.asarray(img.shape)
    if np.any(pad < 0):
        raise NotImplementedError(
            "PSF images larger than observation images are not supported"
        )
    off = [n // 2 - m // 2 for n, m in zip(newshape, img.shape)]
    img_pad = np.zeros(tuple(newshape), dtype=img.dtype)
    img_pad[
        off[0] : off[0] + img.shape[0],
        off[1] : off[1] + img.shape[1],
    ] = img
    return np.fft.rfft2(img_pad)


def convolve(img, fourier_kernel):
    """Circular FFT convolution of ``(..., H, W)`` with a half spectrum."""
    h, w = img.shape[-2], img.shape[-1]
    spec = torch.fft.rfft2(img) * fourier_kernel
    out = torch.fft.irfft2(spec, s=(h, w))
    return torch.fft.ifftshift(out, dim=(-2, -1))


def fft_convolve_direct(img, kernel_padded):
    """Convolve with a spatial kernel already padded to the image's shape
    (its spectrum taken here; for tests)."""
    return convolve(img, torch.fft.rfft2(kernel_padded))


def rdft_matrices(shape, dtype=np.float32):
    """Real matmul-DFT operators ``(cw, sw, ch, sh, ich, ish, ica, isa)``.

    * ``cw/sw``  (W, W2): forward cos/sin along the last axis,
    * ``ch/sh``  (H, H):  forward cos/sin along the first axis,
    * ``ich/ish`` (H, H): inverse along h, rows pre-ifftshifted, 1/H folded,
    * ``ica/isa`` (W2, W): inverse along w, hermitian weights and 1/W
      folded, columns pre-ifftshifted.

    Host numpy, built in float64 and cast to ``dtype``.
    """
    h, w = shape
    w2 = w // 2 + 1
    jw = np.arange(w)[:, None] * np.arange(w2)[None, :]
    ang_w = 2.0 * np.pi * jw / w
    cw = np.cos(ang_w)
    sw = np.sin(ang_w)

    kh = np.arange(h)[:, None] * np.arange(h)[None, :]
    ang_h = 2.0 * np.pi * kh / h
    ch = np.cos(ang_h)
    sh = np.sin(ang_h)

    # inverse along h with the ifftshift folded in: output row p reads
    # unshifted row (p + H//2)
    rows = (np.arange(h)[:, None] + h // 2) * np.arange(h)[None, :]
    ang_ih = 2.0 * np.pi * rows / h
    ich = np.cos(ang_ih) / h
    ish = np.sin(ang_ih) / h

    # inverse along w: hermitian completion weights, 1/W, shift fold
    c = np.full(w2, 2.0)
    c[0] = 1.0
    if w % 2 == 0:
        c[-1] = 1.0
    cols = np.arange(w2)[:, None] * (np.arange(w)[None, :] + w // 2)
    ang_iw = 2.0 * np.pi * cols / w
    ica = (c[:, None] / w) * np.cos(ang_iw)
    isa = (c[:, None] / w) * np.sin(ang_iw)

    return tuple(m.astype(dtype) for m in (cw, sw, ch, sh, ich, ish, ica, isa))


def convolve_rdft(img, kernel_r, kernel_i, mats):
    """Half-spectrum matmul convolution of ``(..., H, W)`` real images.

    ``kernel_r/kernel_i`` are the real/imaginary planes ``(H, W2)`` of the
    kernel's rfft2; ``mats`` are :func:`rdft_matrices` as tensors on the
    images' device.  Equals :func:`convolve` (circular boundary and the
    trailing ifftshift).
    """
    cw, sw, ch, sh, ich, ish, ica, isa = mats
    # forward along w (real input): S1 = x @ (cw - i sw)
    s1r = img @ cw
    s1i = -(img @ sw)
    # forward along h: S2 = (ch - i sh) @ S1
    s2r = ch @ s1r + sh @ s1i
    s2i = ch @ s1i - sh @ s1r
    # kernel multiply
    s3r = s2r * kernel_r - s2i * kernel_i
    s3i = s2r * kernel_i + s2i * kernel_r
    # inverse along h (shift folded): S4 = (ich + i ish) @ S3
    s4r = ich @ s3r - ish @ s3i
    s4i = ich @ s3i + ish @ s3r
    # inverse along w, real part only
    return s4r @ ica - s4i @ isa
