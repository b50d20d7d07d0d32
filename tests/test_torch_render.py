"""The render kernel's order of evaluation and launch geometry, on the CPU.

``csrc/sersic_profile.cuh`` hoists what a walker and a row keep constant
and evaluates runs of pixels of one row; ``render_sersics_runs_plain``
states that order in plain PyTorch, and must equal ``render_sersics_plain``
bit for bit (the kernel itself is held to the plain version on the card,
``tests/test_torch_cuda.py``).  ``launch_geometry`` is the Python half of
the kernel's launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psfmc_tpu.ops.pallas import render_sersics_pallas
from psfmc_tpu_torch.ops.kernels import sersic_render as SR


def _rows(seed, batch, count, shape):
    """(B, S, 9) packed rows and (B,) sky, float32: indices 0.5-8, radii
    0.5-60 px, one walker with NaN rows, one centred on a pixel."""
    rng = np.random.RandomState(seed)
    h, w = shape
    index = rng.uniform(0.5, 8.0, (batch, count))
    reff = rng.uniform(0.5, 60.0, (batch, count))
    reff_b = reff * rng.uniform(0.2, 1.0, (batch, count))
    angle = rng.uniform(0.0, np.pi, (batch, count))
    p = np.zeros((batch, count, 9))
    p[..., 0] = rng.uniform(0, w, (batch, count))
    p[..., 1] = rng.uniform(0, h, (batch, count))
    p[..., 2], p[..., 3] = np.cos(angle) / reff, np.sin(angle) / reff
    p[..., 4], p[..., 5] = -np.sin(angle) / reff_b, np.cos(angle) / reff_b
    p[..., 6] = 2.0 * index - 1.0 / 3.0
    p[..., 7] = 0.5 / index
    p[..., 8] = rng.uniform(0.01, 2.0, (batch, count))
    p[1] = np.nan  # the WeibullMinimum prior draws such walkers
    p[2, 0, :2] = (3.0, 2.0)  # an exact pixel-centre hit: both clamps
    sky = rng.uniform(0.0, 0.1, batch)
    return (torch.as_tensor(p, dtype=torch.float32),
            torch.as_tensor(sky, dtype=torch.float32))


@pytest.mark.parametrize("shape", [(16, 16), (45, 37), (8, 128)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("count", [1, 2, 3])
def test_kernel_order_equals_plain_bit_for_bit(count, shape):
    params, sky = _rows(31 + count, 5, count, shape)
    want = SR.render_sersics_plain(params, sky, shape)
    got = SR.render_sersics_runs_plain(params, sky, shape)
    nan = torch.isnan(want)
    assert nan[1].all() and not nan[0].any() and not nan[2:].any()
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])  # float32, the same bits
    assert torch.isfinite(want[2, 2, 3])  # log(0) clamped at the centre


@pytest.mark.parametrize("run", [1, 3, 8, 64])
def test_kernel_order_any_run_length(run):
    """The run length (and so the cut last run of a row) changes no bit."""
    params, sky = _rows(35, 4, 2, (9, 37))
    want = SR.render_sersics_plain(params, sky, (9, 37))
    got = SR.render_sersics_runs_plain(params, sky, (9, 37), run=run)
    assert torch.equal(got.nan_to_num(nan=-1.0), want.nan_to_num(nan=-1.0))


@pytest.mark.parametrize("count", [1, 3])
def test_kernel_order_matches_pallas(count):
    """1 and 3 Sersics against the Pallas kernel in interpret mode (two
    are ``tests/test_torch_kernels.py``'s)."""
    shape = (24, 40)
    params, sky = _rows(36 + count, 4, count, shape)
    params[1], sky[1] = params[0], sky[0]  # no NaN walker here
    want = np.asarray(render_sersics_pallas(jnp.asarray(params.numpy()),
                                            jnp.asarray(sky.numpy()), shape))
    got = SR.render_sersics_runs_plain(params, sky, shape).numpy()
    # float32, per-pixel relative error < 5e-6 (the Pallas test's bar)
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)) < 5e-6


GEOMETRY_CASES = [
    # shape, walkers a block, (block_x, block_y, block_z, strips)
    ((128, 128), 1, (32, 4, 1, 32)),   # the main path: 128 threads, a row a warp
    ((128, 128), 25, (32, 1, 4, 128)),  # a block's walkers four at a time
    ((128, 128), 2, (32, 2, 2, 64)),
    ((64, 128), 1, (32, 4, 1, 16)),
    ((45, 37), 5, (16, 2, 4, 23)),     # 10 runs of a row on 16 threads
    ((8, 2048), 1, (32, 4, 1, 2)),     # a thread walks 16 runs of its row
    ((2048, 8), 1, (2, 64, 1, 32)),
    ((1, 1), 1, (1, 1, 1, 1)),
    ((300000, 4), 1, (1, 128, 1, 2344)),
    ((300000, 4), 128, (1, 1, 128, 65535)),  # the grid's limit: strips are walked
]


@pytest.mark.parametrize("shape,walkers,want", GEOMETRY_CASES,
                         ids=[f"{s[0]}x{s[1]}-{t}" for s, t, _ in GEOMETRY_CASES])
def test_launch_geometry(shape, walkers, want):
    got = SR.launch_geometry(shape, walkers)
    assert got == want
    block_x, block_y, block_z, strips = got
    assert block_x * block_y * block_z <= 256  # csrc/sersic_render.cu's limit
    assert all(n & (n - 1) == 0 for n in (block_x, block_y, block_z))
    assert 1 <= strips <= 65535 and block_z <= max(walkers, 1)
    assert strips * block_y >= min(shape[0], 65535 * block_y)
