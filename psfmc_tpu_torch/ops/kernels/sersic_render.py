"""Sky + Sersic raw-model render: CUDA kernel wrapper and plain version.

Counterpart of ``psfmc_tpu/ops/pallas/sersic_pallas.py``: both of its
Pallas kernels (``render_sersics_pallas_one``, one walker per program,
and ``render_sersics_pallas_tiled``, T walkers per program) map to the
one CUDA kernel in ``csrc/sersic_render.cu``, with the walkers per block
as a launch parameter.

* :func:`render_sersics` — ``(B, S, 9)`` packed rows + ``(B,)`` sky ->
  ``(B, H, W)``, one walker per block;
* :func:`render_sersics_tiled` — the same with ``tile`` walkers per
  block; a tile that does not divide ``B`` raises ``ValueError`` (the
  Pallas kernel's contract);
* :func:`render_sersics_plain` — the same function in plain PyTorch;
* :func:`render_sersics_runs_plain` — the same once more, in the order in
  which the kernel evaluates it (bit-identical; the tests hold that).

On CPU tensors the wrappers return the plain version; on CUDA tensors
they launch the kernel or raise.  Point sources are not rendered here:
they are rank-1 outer products added in torch, as in the JAX path.

The gradient: when the packed rows or the sky require it, both wrappers
go through a ``torch.autograd.Function`` whose backward maps the image
gradient ``G (B, H, W)`` to the rows' ``(B, S, 9)`` and the sky's
``(B,)`` (:func:`render_sersics_backward`): on CUDA the hand-written
kernel of ``csrc/sersic_render_backward.cu`` (one launch, a
thread-block cluster of strips per walker, :func:`backward_strips`), on
the CPU :func:`render_sersics_backward_plain`, the same function written
out as formulas; :func:`render_sersics_backward_order_plain` is the
kernel's formulas and order of summation, for the tests.  The forward
launch is the same either way.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..sersic import sersic_profile_core
from ..coords import coord_grids
from . import _build, counts

__all__ = [
    "PARAMS_PER_SERSIC",
    "pack_sersic_params",
    "render_sersics",
    "render_sersics_tiled",
    "render_sersics_plain",
    "render_sersics_runs_plain",
    "render_sersics_backward",
    "render_sersics_backward_plain",
    "render_sersics_backward_order_plain",
    "backward_strips",
    "launch_geometry",
    "pick_tile",
]

PARAMS_PER_SERSIC = 9


def pack_sersic_params(scalars):
    """Stack the nine ``sersic_scalar_params`` outputs into ``(..., 9)``."""
    return torch.stack(scalars, dim=-1)


def render_sersics_plain(params, sky, shape):
    """Plain PyTorch render: ``sky + sum_s sersic_profile_core``."""
    xg, yg = coord_grids(shape, params.dtype, params.device)
    acc = sky[:, None, None].expand(params.shape[0], *shape)
    for s in range(params.shape[1]):
        q = params[:, s, :, None, None]
        acc = acc + sersic_profile_core(
            xg - q[:, 0], yg - q[:, 1], q[:, 2], q[:, 3], q[:, 4], q[:, 5],
            q[:, 6], q[:, 7], q[:, 8],
        )
    return acc.contiguous()


def pick_tile(batch):
    """Largest divisor of ``batch`` that is <= 25 (the Pallas tile rule)."""
    for t in (25, 16, 10, 8, 5, 4, 2):
        if batch % t == 0:
            return t
    return 1


def _check(params, sky, shape):
    if params.ndim != 3 or params.shape[2] != PARAMS_PER_SERSIC:
        raise ValueError(f"params must be (B, S, 9), got {tuple(params.shape)}")
    if sky.shape != (params.shape[0],):
        raise ValueError(
            f"sky must be ({params.shape[0]},), got {tuple(sky.shape)}"
        )
    if sky.device != params.device or sky.dtype != params.dtype:
        raise ValueError("params and sky must share device and dtype")
    if len(shape) != 2 or min(shape) <= 0:
        raise ValueError(f"bad image shape {shape}")


def render_sersics_runs_plain(params, sky, shape, run=4):
    """The render in the CUDA kernel's order of evaluation, in plain PyTorch.

    ``csrc/sersic_profile.cuh`` computes what no pixel changes once per
    walker (``-kappa``, ``kappa * rp``), what no pixel of a row changes
    once per row (``m01 * dy``, ``m11 * dy``, ``dy * dy``), and then
    ``run`` pixels of a row at a time, the last run of a row cut short.
    These are the rounded operations of :func:`render_sersics_plain` on
    the same operands, so the two agree bit for bit; the tests hold that.
    """
    h, w = shape
    xg = torch.arange(w, dtype=params.dtype, device=params.device)
    yg = torch.arange(h, dtype=params.dtype, device=params.device)[:, None]
    out = torch.empty((params.shape[0], h, w), dtype=params.dtype,
                      device=params.device)
    per_sersic = []
    for s in range(params.shape[1]):
        x, y, m00, m01, m10, m11, kappa, rp, sbeff = (
            params[:, s, k, None, None] for k in range(PARAMS_PER_SERSIC))
        dy = yg - y  # (B, H, 1): the row's terms
        per_sersic.append((x, m00, m10, -kappa, rp, kappa * rp, sbeff,
                           m01 * dy, m11 * dy, dy * dy))
    for x0 in range(0, w, run):
        cols = xg[..., x0:x0 + run]
        acc = sky[:, None, None].expand(-1, h, cols.shape[-1])
        for x, m00, m10, neg_kappa, rp, krp, sbeff, m01dy, m11dy, dy2 in per_sersic:
            dx = cols - x
            u = m00 * dx + m01dy
            v = m10 * dx + m11dy
            sq_r = torch.clamp(u * u + v * v, min=1e-30)
            p = torch.exp(torch.log(sq_r) * rp)
            sb = torch.exp(neg_kappa * (p - 1.0))
            sq_off = torch.clamp(dx * dx + dy2, min=0.125)
            krp_p = krp * p
            corr = 1.0 + (krp_p * krp_p) / (3.0 * sq_off)
            acc = acc + sbeff * sb * corr
        out[..., x0:x0 + run] = acc
    return out


BLOCK_THREADS = 128  # csrc/sersic_render.cu takes up to 256
RUN = 4  # pixels of one 128-bit store, csrc/sersic_render.cu's kRun
MAX_STRIPS = 65535  # a grid's second dimension; a block walks the rest


def launch_geometry(shape, walkers_per_block):
    """``(block_x, block_y, block_z, strips)`` of a render launch.

    A block is ``block_x`` threads along a row (``RUN`` pixels each) by
    ``block_y`` rows by ``block_z`` of its walkers, powers of two and
    ``BLOCK_THREADS`` together where the image allows; the image's strips
    of ``block_y`` rows are dealt over ``strips`` blocks.  Measured at the
    flagship's shape (``chip_smoke.py --profile``): many short blocks
    (every strip its own block) beat fewer blocks that walk several
    strips, and 128 threads beat 256.
    """
    h, w = shape
    block_x = min(32, _pow2_ceil(-(-w // RUN)))
    lanes = max(BLOCK_THREADS // block_x, 1)  # rows x walkers
    block_z = min(lanes, _pow2_floor(walkers_per_block))
    block_y = min(lanes // block_z, _pow2_ceil(h))
    return block_x, block_y, block_z, min(-(-h // block_y), MAX_STRIPS)


def _pow2_floor(n):
    return 1 << (max(n, 1).bit_length() - 1)


def _pow2_ceil(n):
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=1)
def _kernel():
    # (params, sky, out, batch, num_sersic, h, w, walkers_per_block,
    #  block_x, block_y, block_z, strips, stream)
    return _build.function(
        "sersic_render", "sersic_render_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    )


def _launch(params, sky, shape, walkers_per_block, geometry=None):
    """Launch the kernel; ``geometry`` overrides :func:`launch_geometry`
    (``chip_smoke.py --profile`` times the alternatives with it)."""
    if params.dtype != torch.float32:
        raise TypeError(f"the CUDA render takes float32, got {params.dtype}")
    params = params.contiguous()
    sky = sky.contiguous()
    b, s, _ = params.shape
    h, w = shape
    if geometry is None:
        geometry = launch_geometry(shape, walkers_per_block)
    out = torch.empty((b, h, w), dtype=torch.float32, device=params.device)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(params.data_ptr(), sky.data_ptr(), out.data_ptr(),
                        b, s, h, w, walkers_per_block, *geometry, stream)
    if err != 0:
        raise RuntimeError(f"sersic_render launch failed: cudaError {err}")
    return out


def _forward(params, sky, shape, walkers_per_block, counter_owner):
    if params.device.type == "cpu":
        return render_sersics_plain(params, sky, shape)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    out = _launch(params, sky, shape, walkers_per_block)
    counts.count(counter_owner)
    return out


class _Render(torch.autograd.Function):
    """The render with its vector-Jacobian product: the forward is the
    wrapper's own launch, the backward :func:`render_sersics_backward`."""

    @staticmethod
    def forward(ctx, params, sky, shape, walkers_per_block, counter_owner):
        ctx.shape = shape
        ctx.save_for_backward(params, sky)
        return _forward(params, sky, shape, walkers_per_block, counter_owner)

    @staticmethod
    def backward(ctx, grad):
        params, sky = ctx.saved_tensors
        g_params, g_sky = render_sersics_backward(params, sky, ctx.shape, grad)
        return g_params, g_sky, None, None, None


def _dispatch(params, sky, shape, walkers_per_block, counter_owner):
    if torch.is_grad_enabled() and (params.requires_grad or sky.requires_grad):
        return _Render.apply(params, sky, shape, walkers_per_block, counter_owner)
    return _forward(params, sky, shape, walkers_per_block, counter_owner)


def render_sersics(params, sky, shape):
    """Batched render ``(B, S, 9), (B,) -> (B, H, W)``, one walker per block."""
    _check(params, sky, tuple(shape))
    return _dispatch(params, sky, tuple(shape), 1, render_sersics)


def render_sersics_tiled(params, sky, shape, tile=None):
    """Walker-tiled render: ``tile`` walkers per block (default
    :func:`pick_tile`).  Raises ``ValueError`` if ``tile`` does not
    divide the batch."""
    _check(params, sky, tuple(shape))
    b = params.shape[0]
    if tile is None:
        tile = pick_tile(b)
    elif tile < 1 or b % tile:
        raise ValueError(f"tile={tile} does not divide the batch {b}")
    return _dispatch(params, sky, tuple(shape), int(tile), render_sersics_tiled)


render_sersics.launches = 0
render_sersics_tiled.launches = 0


def render_sersics_backward_plain(params, sky, shape, grad):
    """The render's vector-Jacobian product in plain PyTorch: ``(g_params
    (B, S, 9), g_sky (B,))`` for the image gradient ``grad (B, H, W)``.

    ``g_sky[b] = sum_p G[b, p]`` and ``g_params[b, s, k] = sum_p G[b, p]
    dI_s(p)/dq_k`` through :func:`~psfmc_tpu_torch.ops.sersic.
    sersic_profile_core` as written, with ``p = (r^2)^rp``, ``sb =
    exp(-kappa (p - 1))`` and ``corr = 1 + (kappa rp p)^2 / (3 off^2)``.
    The two clamps (square radius at 1e-30, square offset at 0.125) have
    zero slope below their floors and at a NaN, as autograd gives them.
    """
    xg, yg = coord_grids(shape, params.dtype, params.device)
    g_sky = grad.sum(dim=(-2, -1))
    rows = []
    for s in range(params.shape[1]):
        x, y, m00, m01, m10, m11, kappa, rp, sbeff = (
            params[:, s, k, None, None] for k in range(PARAMS_PER_SERSIC))
        dx, dy = xg - x, yg - y
        u = m00 * dx + m01 * dy
        v = m10 * dx + m11 * dy
        sq = u * u + v * v
        sq_r = torch.clamp(sq, min=1e-30)
        log_sq = torch.log(sq_r)
        p = torch.exp(log_sq * rp)
        sb = torch.exp(-kappa * (p - 1.0))
        off = dx * dx + dy * dy
        three_off = 3.0 * torch.clamp(off, min=0.125)
        krp = kappa * rp
        krp_p = krp * p
        corr = 1.0 + krp_p * krp_p / three_off
        g_sb = grad * sbeff * corr  # d/d sb
        g_corr = grad * sbeff * sb
        g_krp_p = g_corr * 2.0 * krp_p / three_off
        g_off = torch.where(off >= 0.125,
                            -g_corr * krp_p * krp_p * 3.0 / (three_off * three_off),
                            torch.zeros_like(off))
        g_arg = g_sb * sb  # d/d[-kappa (p - 1)]
        g_p = g_krp_p * krp - g_arg * kappa
        g_lp = g_p * p  # d/d[log(sq) rp]
        g_sq = torch.where(sq >= 1e-30, g_lp * rp / sq_r, torch.zeros_like(sq))
        g_u, g_v = 2.0 * u * g_sq, 2.0 * v * g_sq
        g_dx = g_u * m00 + g_v * m10 + 2.0 * dx * g_off
        g_dy = g_u * m01 + g_v * m11 + 2.0 * dy * g_off
        g_krp = (g_krp_p * p).sum(dim=(-2, -1))

        def total(t):
            return t.sum(dim=(-2, -1))

        rows.append(torch.stack([
            -total(g_dx), -total(g_dy),
            total(g_u * dx), total(g_u * dy), total(g_v * dx), total(g_v * dy),
            g_krp * rp[:, 0, 0] - total(g_arg * (p - 1.0)),
            g_krp * kappa[:, 0, 0] + total(g_lp * log_sq),
            total(grad * sb * corr),
        ], dim=-1))
    if rows:
        g_params = torch.stack(rows, dim=1)
    else:
        g_params = torch.zeros_like(params)
    return g_params, g_sky


SM_COUNT = 132  # the H100 SXM's multiprocessors
BACKWARD_THREADS = 256  # csrc/sersic_render_backward.cu's kThreads
BACKWARD_CHUNK = 32  # pixels a thread sums in float32 (kChunk)
BACKWARD_MAX_STRIPS = 8  # the portable thread-block cluster size (kMaxStrips)
BACKWARD_BLOCKS_PER_SM = 2  # the blocks one wave places on an SM


def backward_strips(batch, shape):
    """``(strips, per_strip)`` of a backward launch: each walker's pixels
    in ``strips`` contiguous ranges of ``per_strip`` pixels (a multiple of
    the block's 256 threads), one block each, one thread-block cluster per
    walker.

    As many strips as fill one wave of the H100 at two blocks per SM
    (``264 // B``: 2 at 125 walkers, 4 at 64), at least as many as keep a
    thread's pixels within one float32 chunk of 32 (``H W / 8192``), at
    most 8 (the portable cluster size) and no more than leave every strip
    a pixel."""
    h, w = (int(n) for n in shape)
    hw = h * w
    wave = max(1, BACKWARD_BLOCKS_PER_SM * SM_COUNT // max(int(batch), 1))
    need = -(-hw // (BACKWARD_THREADS * BACKWARD_CHUNK))
    strips = min(BACKWARD_MAX_STRIPS, max(wave, need), -(-hw // BACKWARD_THREADS))
    per_strip = -(-hw // (strips * BACKWARD_THREADS)) * BACKWARD_THREADS
    return -(-hw // per_strip), per_strip


def _backward_terms(params, shape, grad):
    """Each pixel's products, ``(B, H W)`` one at a time: the nine packed
    scalars of every Sersic in turn, in the kernel's formulas (two
    reciprocals, then multiplies) and in ``params``' dtype."""
    xg, yg = coord_grids(shape, params.dtype, params.device)
    b = params.shape[0]

    def flat(t):
        return t.expand(b, *shape).reshape(b, -1)

    for s in range(params.shape[1]):
        x, y, m00, m01, m10, m11, kappa, rp, sbeff = (
            params[:, s, k, None, None] for k in range(PARAMS_PER_SERSIC))
        krp = kappa * rp
        dx, dy = xg - x, yg - y
        u = m00 * dx + m01 * dy
        v = m10 * dx + m11 * dy
        sq = u * u + v * v
        sq_r = torch.clamp(sq, min=1e-30)
        log_sq = torch.log(sq_r)
        pw = torch.exp(log_sq * rp)
        sb = torch.exp(-kappa * (pw - 1.0))
        off = dx * dx + dy * dy
        inv3 = 1.0 / (3.0 * torch.clamp(off, min=0.125))
        krp_p = krp * pw
        kpp2 = krp_p * krp_p
        corr = 1.0 + kpp2 * inv3
        gs = grad * sbeff
        t = gs * sb * inv3
        g_krp_p = 2.0 * krp_p * t
        g_off = torch.where(off >= 0.125, -3.0 * kpp2 * t * inv3, torch.zeros_like(off))
        g_arg = gs * corr * sb
        g_p = g_krp_p * krp - g_arg * kappa
        g_lp = g_p * pw
        g_sq = torch.where(sq >= 1e-30, g_lp * rp * (1.0 / sq_r), torch.zeros_like(sq))
        g_u, g_v = 2.0 * u * g_sq, 2.0 * v * g_sq
        g_krp = g_krp_p * pw
        yield flat(-(g_u * m00 + g_v * m10 + 2.0 * dx * g_off))
        yield flat(-(g_u * m01 + g_v * m11 + 2.0 * dy * g_off))
        yield flat(g_u * dx)
        yield flat(g_u * dy)
        yield flat(g_v * dx)
        yield flat(g_v * dy)
        yield flat(g_krp * rp - g_arg * (pw - 1.0))
        yield flat(g_krp * kappa + g_lp * log_sq)
        yield flat(grad * sb * corr)


def _thread_sums(term, strips, per_strip, kahan=False):
    """``(B,)`` float64: one term's sum in the kernel's order, each
    thread's pixels in ``term``'s dtype over chunks of at most 32 of its
    steps (with Kahan's compensation if ``kahan``), each chunk widened to
    float64."""
    b = term.shape[0]
    steps = per_strip // BACKWARD_THREADS
    term = torch.nn.functional.pad(term, (0, strips * per_strip - term.shape[-1]))
    term = term.reshape(b, strips, steps, BACKWARD_THREADS)
    total = torch.zeros(b, dtype=torch.float64, device=term.device)
    for c0 in range(0, steps, BACKWARD_CHUNK):
        acc = torch.zeros_like(term[:, :, 0])
        comp = torch.zeros_like(acc)
        for i in range(c0, min(steps, c0 + BACKWARD_CHUNK)):
            if kahan:
                y = term[:, :, i] - comp
                t = acc + y
                comp = (t - acc) - y
                acc = t
            else:
                acc = acc + term[:, :, i]
        total = total + (acc.double() - comp.double()).sum(dim=(-2, -1))
    return total


def render_sersics_backward_order_plain(params, sky, shape, grad):
    """The backward kernel's order of summation in plain PyTorch: the
    kernel's formulas (:func:`_backward_terms`) in ``params``' dtype, each
    thread's terms summed in that dtype over chunks of at most 32 of its
    pixels in the kernel's pixel order (:func:`backward_strips`: thread
    ``t`` of strip ``k`` adds pixel ``k per_strip + t + 256 i`` at step
    ``i``), ``G``'s own sum with Kahan's compensation, each chunk then
    widened to float64 and everything above it summed in float64; the
    result cast back.  The tests hold it (in float32, as the kernel runs)
    against :func:`render_sersics_backward_plain` in float64."""
    shape = tuple(int(n) for n in shape)
    b, s, _ = params.shape
    geometry = backward_strips(b, shape)
    sums = [_thread_sums(t, *geometry) for t in _backward_terms(params, shape, grad)]
    g_params = torch.stack(sums, dim=-1) if sums else params.new_zeros(
        (b, 0), dtype=torch.float64)
    g_sky = _thread_sums(grad.reshape(b, -1), *geometry, kahan=True)
    return (g_params.reshape(b, s, PARAMS_PER_SERSIC).to(params.dtype),
            g_sky.to(params.dtype))


@functools.lru_cache(maxsize=1)
def _backward_kernel():
    # (params, grad, g_params, g_sky, batch, num_sersic, h, w, strips,
    #  per_strip, stream)
    return _build.function(
        "sersic_render_backward", "sersic_render_backward_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )


def _launch_backward(params, grad, shape):
    if params.dtype != torch.float32 or grad.dtype != torch.float32:
        raise TypeError("the CUDA render backward takes float32")
    params = params.contiguous()
    grad = grad.contiguous()
    b, s, _ = params.shape
    h, w = shape
    strips, per_strip = backward_strips(b, shape)
    dev = params.device
    g_params = torch.empty_like(params)
    g_sky = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_kernel()(params.data_ptr(), grad.data_ptr(),
                                 g_params.data_ptr(), g_sky.data_ptr(), b, s, h, w,
                                 strips, per_strip, stream)
    if err != 0:
        raise RuntimeError(f"sersic_render backward launch failed: cudaError {err}")
    return g_params, g_sky


def render_sersics_backward(params, sky, shape, grad):
    """``(g_params (B, S, 9), g_sky (B,))`` of the render at ``(params,
    sky)`` for the image gradient ``grad (B, H, W)`` (the backward of
    both render wrappers).  On CUDA the backward kernel (counted in
    ``render_sersics_backward.launches``), on the CPU
    :func:`render_sersics_backward_plain`."""
    shape = tuple(shape)
    if tuple(grad.shape) != (params.shape[0],) + shape:
        raise ValueError(f"grad must be (B, H, W), got {tuple(grad.shape)}")
    if params.device.type == "cpu":
        return render_sersics_backward_plain(params, sky, shape, grad)
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    out = _launch_backward(params, grad, shape)
    counts.count(render_sersics_backward)
    return out


render_sersics_backward.launches = 0
