"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without CUDA they skip.
This file imports neither ``jax`` nor ``psfmc_tpu``, so it runs on a
machine that has only PyTorch, without the suite's ``conftest.py``::

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""
import numpy as np
import pytest
import torch

from psfmc_tpu_torch.flagship import flagship_components, prior_draws
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
from psfmc_tpu_torch.ops.kernels import sersic_render as SR

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def flagship(cuda):
    spec = build_model_spec(flagship_components((64, 64), (32, 32)))
    return spec, build_posterior(spec, device=cuda)


def _same_nonfinite(got, want):
    return torch.equal(torch.isfinite(got), torch.isfinite(want)) and \
        torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.parametrize("tiled", [False, True])
def test_render_kernel_matches_plain(flagship, tiled):
    spec, post = flagship
    th = torch.as_tensor(prior_draws(spec, 30, seed=4), dtype=torch.float32,
                         device=post.device)
    params, sky = post.render_inputs(th)
    params, sky = params.contiguous(), sky.contiguous()
    fn = SR.render_sersics_tiled if tiled else SR.render_sersics
    before = fn.launches
    got = fn(params, sky, spec.shape)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = SR.render_sersics_plain(params, sky, spec.shape)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    rel = (got[fin] - want[fin]).abs() / want[fin].abs().clamp(min=1e-12)
    assert rel.max().item() <= 5e-6  # float32, same rounded op sequence


def test_conv_lnl_kernel_matches_plain(flagship):
    spec, post = flagship
    th = torch.as_tensor(prior_draws(spec, 30, seed=5), dtype=torch.float32,
                         device=post.device)
    raws = post.raw_and_ps(th)[0]
    before = CL.batched_conv_lnl.launches
    got = CL.batched_conv_lnl(raws, post.consts)
    torch.cuda.synchronize()
    assert CL.batched_conv_lnl.launches == before + 1
    want = CL.batched_conv_lnl_plain(raws, post.consts)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    # float32 FMA GEMMs vs cuBLAS fp32: rtol 2e-5 per walker
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)


@pytest.mark.parametrize("shape,psf_shape,point_sources", [
    ((64, 64), (32, 32), True),
    ((64, 64), (32, 32), False),
    ((45, 37), (16, 16), True),  # odd sizes: W2 = 19, ragged warps
], ids=["64", "64-no-ps", "45x37"])
def test_fused_lnl_kernel_matches_plain(cuda, shape, psf_shape, point_sources):
    spec = build_model_spec(flagship_components(shape, psf_shape))
    post = build_posterior(spec, device=cuda, lnpost="fused")
    th = torch.as_tensor(prior_draws(spec, 30, seed=7), dtype=torch.float32,
                         device=post.device)
    params, sky = post.render_inputs(th)
    fky, kx = post.pointsource_inputs(th)
    if not point_sources:
        fky, kx = fky[:, :0].contiguous(), kx[:, :0].contiguous()
    before = FL.fused_lnl.launches
    got = FL.fused_lnl(params, sky, fky, kx, post.consts)
    torch.cuda.synchronize()
    assert FL.fused_lnl.launches == before + 1
    want = FL.fused_lnl_plain(params, sky, fky, kx, post.consts)
    assert _same_nonfinite(got, want)
    fin = torch.isfinite(want)
    assert fin.sum().item() >= 15
    # float32 FMA products in the kernel's order vs cuBLAS fp32: rtol 2e-5
    # per walker, as for conv_lnl
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=0.0)


def test_kernel_wrappers_do_not_fall_back(cuda):
    with pytest.raises(TypeError, match="float32"):
        SR.render_sersics(torch.zeros((2, 1, 9), dtype=torch.float64, device=cuda),
                          torch.zeros(2, dtype=torch.float64, device=cuda), (8, 8))


def test_fused_lnl_refuses_a_walker_beyond_shared_memory(cuda):
    """A 144x144 walker needs more shared memory than a block has: the
    launch is refused, and the wrapper raises instead of returning an
    unwritten output."""
    spec = build_model_spec(flagship_components((144, 144), (32, 32)))
    post = build_posterior(spec, device=cuda, lnpost="batched")
    th = torch.as_tensor(prior_draws(spec, 4, seed=8), dtype=torch.float32,
                         device=post.device)
    params, sky = post.render_inputs(th)
    fky, kx = post.pointsource_inputs(th)
    before = FL.fused_lnl.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        FL.fused_lnl(params, sky, fky, kx, post.consts)
    assert FL.fused_lnl.launches == before


def test_kernel_posterior_matches_cpu_float64(flagship):
    spec, post = flagship
    th = prior_draws(spec, 16, seed=6)
    got = post.log_posterior_batch(th).double().cpu().numpy()
    ref = build_posterior(spec, device="cpu", dtype=torch.float64)
    want = ref.log_posterior_batch(th).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and fin.sum() >= 8
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
