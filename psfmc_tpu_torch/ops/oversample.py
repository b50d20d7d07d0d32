"""Sub-pixel oversampled rendering of profile components (port of ``ops/oversample.py``).

``Configuration(render_oversample=S, oversample_window=W)``: a ``W x W``
pixel window around each profile component's center is re-rendered on
an ``S`` times finer midpoint grid, flux-averaged back to native pixels,
and the difference to the point-sampled values is added in place.  The
fine samples leave out the profile's sub-pixel correction term (the
average integrates the pixel itself).

Batched over walkers: every walker's window has its own origin, so the
window is placed by index arithmetic (a scatter-add of the ``(B, W, W)``
delta at per-walker flat indices), with no ``.item()``, ``nonzero`` or
per-walker loop: the step that runs it is captured in a CUDA graph.
"""
from __future__ import annotations

import torch

__all__ = ["window_origin", "oversampled_window_delta", "apply_window_delta"]


def window_origin(xy, window, render_shape, pad):
    """Clamped integer ``(row, col)`` origins ``(B,)`` of the windows on the
    render grid, from component centers ``xy`` ``(B, 2)`` in observation
    pixels (the padded grid spans ``[-pad, shape + pad)``).  A non-finite
    center still gives an in-range origin (its walker's prior is
    ``-inf``)."""
    h, w = render_shape
    win = int(window)
    half = win // 2
    cx = torch.round(xy[..., 0]).to(torch.int64) + (pad - half)
    cy = torch.round(xy[..., 1]).to(torch.int64) + (pad - half)
    return torch.clamp(cy, 0, h - win), torch.clamp(cx, 0, w - win)


def oversampled_window_delta(profile_coarse, profile_fine, origin, window,
                             oversample, pad, dtype):
    """``(B, W, W)`` correction: midpoint-integrated minus point-sampled.

    ``profile_coarse(xg, yg)`` evaluates the profile as the full-frame
    render does (correction included) and ``profile_fine`` without the
    correction; both broadcast over ``xg`` ``(B, 1, n)`` and ``yg`` ``(B,
    n, 1)`` in observation coordinates.
    """
    win = int(window)
    s = int(oversample)
    oy, ox = origin
    ar = torch.arange(win, dtype=dtype, device=oy.device)
    xs = (ox - pad)[:, None] + ar  # (B, W) observation coordinates
    ys = (oy - pad)[:, None] + ar
    coarse = profile_coarse(xs[:, None, :], ys[:, :, None])
    # the k-th of S sub-samples of pixel c sits at c + (k + 1/2)/S - 1/2
    sub = (torch.arange(s, dtype=dtype, device=oy.device) + 0.5) / s - 0.5
    xf = (xs[:, :, None] + sub).reshape(xs.shape[0], win * s)
    yf = (ys[:, :, None] + sub).reshape(ys.shape[0], win * s)
    fine = profile_fine(xf[:, None, :], yf[:, :, None])
    binned = fine.reshape(-1, win, s, win, s).mean(dim=(2, 4))
    return (binned - coarse).to(dtype)


def apply_window_delta(raw, delta, origin):
    """``raw`` ``(B, H, W)`` with each walker's window plus its delta
    (out of place): a scatter-add at the windows' flat pixel indices."""
    b, h, w = raw.shape
    oy, ox = origin
    ar = torch.arange(delta.shape[-1], device=oy.device)
    idx = (oy[:, None, None] + ar[:, None]) * w + (ox[:, None, None] + ar)
    return raw.reshape(b, h * w).scatter_add(
        1, idx.reshape(b, -1), delta.reshape(b, -1)).reshape(b, h, w)
