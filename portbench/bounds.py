"""The least time an NVIDIA H100 could take for the likelihood functions.

A frozen copy of the bound arithmetic the port's smoke script used when
each kernel was brought up, cut to what the function itself needs at
the cell's shapes: each input byte read once, each output byte written
once, the function's own operation count (the FFT count of its two
circular convolutions at the image's sides, whatever transform size or
route a kernel picks).  A route's own scratch traffic is not counted, so
a later change of route cannot change the yardstick.

Peaks (NVIDIA's data sheet, H100 SXM, at its 700 W limit): 3.35 TB/s of
HBM, 67 TFLOP/s of fp32 outside the tensor cores, and 16 special-function
results a clock on each of the 132 SMs at the 1.98 GHz boost clock.
"""
from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "SFU_RESULTS_PER_S", "bound_ms",
           "fft_conv_ops", "conv_lnl_work", "render_work", "fused_lnl_work"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_RESULTS_PER_S = 16 * 132 * 1.98e9

# one Sersic at one pixel: 31 fp32 operations (each expf, logf and
# division counted once) and 3 special-function results (the ex2 of
# each expf, the reciprocal of the division)
RENDER_OPS_PER_PIXEL = 31
RENDER_SFU_PER_PIXEL = 3
PARAMS_PER_SERSIC = 9  # the packed scalars the render reads per Sersic
LNL_OPS_PER_PIXEL = 10  # the Gaussian lnL's operations per pixel


def bound_ms(nbytes, nops, nsfu=0):
    """The least time in ms: the largest of the bytes over the memory
    rate, the fp32 operations over the fp32 peak and the special-function
    results over their rate."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S,
                     nsfu / SFU_RESULTS_PER_S)


def fft_conv_ops(h, w):
    """One circular convolution by real FFTs: a real transform of N points
    ~2.5 N log2 N, one forward and one inverse, and the product with the
    half spectrum (6 operations a complex bin)."""
    n = h * w
    return 5 * n * math.log2(n) + 6 * h * (w // 2 + 1)


def _data_bytes(h, w, targets=1, target_spectra=False):
    """The constants conv_lnl reads: the PSF's and its variance map's half
    spectra (real and imaginary planes) and, per target, the observation,
    its variance and the good-pixel plane, in float32."""
    spectra = 4 * h * (w // 2 + 1) * (targets if target_spectra else 1)
    return 4 * (spectra + 3 * h * w * targets)


def conv_lnl_work(b, h, w, targets=1, target_spectra=False):
    """``(bytes, fp32 operations)`` of one conv_lnl call on ``b`` walkers
    of ``h x w`` images: the raw images in, the two convolutions, the
    square, the lnL, one float per walker out."""
    n = h * w
    ops = b * (2 * fft_conv_ops(h, w) + n + LNL_OPS_PER_PIXEL * n)
    nbytes = 4 * b * n + _data_bytes(h, w, targets, target_spectra) + 4 * b
    return nbytes, ops


def render_work(b, h, w, sersics):
    """``(bytes, fp32 operations, special-function results)`` of one render
    of ``b`` walkers: sky plus ``sersics`` Sersics at every pixel, the
    packed scalars in, the raw images out."""
    n = h * w
    nbytes = 4 * (b * (PARAMS_PER_SERSIC * sersics + 1) + b * n)
    return (nbytes, b * n * (sersics * RENDER_OPS_PER_PIXEL + 1),
            b * n * sersics * RENDER_SFU_PER_PIXEL)


def fused_lnl_work(b, h, w, sersics, points, targets=1):
    """``(bytes, fp32 operations, special-function results)`` of one
    evaluation of ``b`` walkers' likelihoods from their parameters, as the
    fused kernel computes it: the render (with ``points`` point sources as
    rank-1 outer products, 2 operations a pixel each), then conv_lnl's
    work; the raw images never leave the kernel."""
    n = h * w
    _, conv_ops = conv_lnl_work(b, h, w)
    in_bytes = 4 * b * (PARAMS_PER_SERSIC * sersics + 1 + points * (h + w))
    nbytes = in_bytes + _data_bytes(h, w, targets) + 4 * b
    ops = conv_ops + b * n * (sersics * RENDER_OPS_PER_PIXEL + 1 + 2 * points)
    return nbytes, ops, b * n * sersics * RENDER_SFU_PER_PIXEL
