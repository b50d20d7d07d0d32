"""The port's gradient path against the JAX package's autodiff, on the CPU.

``PosteriorFns.log_posterior_and_grad`` (float64, through the render's
and conv_lnl's plain backward formulas and autograd everywhere else) is
held to ``jax.vmap(jax.value_and_grad(fns.log_posterior))`` in float64 on
the same spec and thetas: lnpost at rtol 1e-10 with the same non-finite
entries, and at every point of finite lnpost the gradient within 1e-8 of
the point's largest component, with the same non-finite entries.
Paths: the batched path (the flagship at 32x32), the general path (two
PSFs with the index marginalized as ``fit_map`` does, a sky gradient and
a ``NoiseScale``; Student-t; Poisson; ``conv_pad``; oversampling), every
family variant, a sky-frame tie, the joint flagship at small size, and
the Newton kappa (``PSFMC_KAPPA=newton``, its implicit derivative
against JAX's unrolled Newton iterations, within 1e-6).

The plain backwards are held to ``torch.autograd`` through the plain
forwards in float64 at 1e-10 (and the autograd Functions against a
central difference along one direction at 1e-6), and the FFT route's
backward scheme to the version of record.  Each test runs torch on one
thread: its tensors are small, and the suite's workers share the cores.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.joint import JointModel as JaxJointModel
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.flagship import (
    FAMILY_VARIANTS,
    family_components,
    flagship_components,
    general_components,
    joint_components,
    prior_draws,
)
from psfmc_tpu_torch.models import JointModel, build_model_spec, build_posterior
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from psfmc_tpu_torch.ops.kernels import sersic_render as SR
from psfmc_tpu_torch.ops.sersic import sersic_scalar_params

SHAPE, PSF_SHAPE = (24, 24), (12, 12)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graft_entry():
    """The module of the JAX package's flagship components (``__graft_entry__.py``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("_graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_grads_match(jfns, post, th, vtol=1e-10, gtol=1e-8, min_finite=4):
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jfns.log_posterior)))(jnp.asarray(th))
    jv, jg = np.asarray(jv), np.asarray(jg)
    v, g = post.log_posterior_and_grad(th)
    v, g = v.numpy(), g.numpy()
    assert np.array_equal(np.isfinite(v), np.isfinite(jv))
    fin = np.isfinite(jv)
    assert fin.sum() >= min_finite
    np.testing.assert_allclose(v[fin], jv[fin], rtol=vtol)
    # where lnpost is -inf the gradients part on purpose: the backward
    # kernels give a walker whose lnL is not finite a zero gradient, where
    # autodiff carries the NaN of a NaN theta back through the render
    assert np.array_equal(np.isfinite(g[fin]), np.isfinite(jg[fin]))
    scale = np.abs(jg[fin]).max(axis=1, keepdims=True)
    assert np.all(np.abs(g[fin] - jg[fin]) <= gtol * scale)


def test_batched_path_gradient_matches_jax():
    """The flagship (Sky + PointSource + 2 Sersic) at 32x32 on the batched
    path: the render's and conv_lnl's backward formulas."""
    jspec = jax_spec(_graft_entry()._flagship_components((32, 32), (16, 16)))
    spec = build_model_spec(flagship_components((32, 32), (16, 16)))
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    assert post.grad_mode == "batched"
    th = prior_draws(spec, 12, seed=3)
    th[1, 0] = np.nan
    _assert_grads_match(jax_posterior(jspec, dtype=jnp.float64), post, th)


@pytest.mark.parametrize("lnpost", ["fused", "general"])
def test_gradient_path_ignores_the_likelihood_path(lnpost):
    """Under ``lnpost="fused"`` (or a forced ``"general"``) on a spec the
    conv+likelihood kernel covers, the gradient still takes the render and
    conv_lnl (``grad_mode``), as the JAX gradient takes its XLA path
    whatever ``PSFMC_LNPOST`` says: the same values and gradients as the
    default posterior's, bit for bit."""
    spec = build_model_spec(flagship_components((32, 32), (16, 16)))
    th = prior_draws(spec, 6, seed=11)
    want = build_posterior(spec, device="cpu", dtype=torch.float64
                           ).log_posterior_and_grad(th)
    post = build_posterior(spec, device="cpu", dtype=torch.float64, lnpost=lnpost)
    assert post.lnpost == lnpost and post.grad_mode == "batched"
    got = post.log_posterior_and_grad(th)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


GENERAL = {
    "two-psfs": dict(),
    "student": dict(likelihood="student", likelihood_df=3.0, num_psfs=1),
    "poisson": dict(likelihood="poisson", likelihood_gain=2.0, counts=True,
                    noise_scale=False, num_psfs=1),
    "conv-pad": dict(conv_pad=4, num_psfs=1),
    "oversample": dict(render_oversample=2, oversample_window=4, num_psfs=1),
}


@pytest.mark.parametrize("variant", sorted(GENERAL))
def test_general_path_gradient_matches_jax(variant):
    """The general flagship (sky gradient, NoiseScale) on each feature of
    the general path; with two PSFs also the MAP objective, the index
    marginalized by a logsumexp over the PSFs, against JAX's."""
    kw = GENERAL[variant]
    jspec = jax_spec(general_components(SHAPE, PSF_SHAPE, components=JC,
                                        distributions=JD, **kw))
    spec = build_model_spec(general_components(SHAPE, PSF_SHAPE, **kw))
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    assert post.grad_mode == "general"
    th = prior_draws(spec, 8, seed=4)
    jfns = jax_posterior(jspec, dtype=jnp.float64)
    _assert_grads_match(jfns, post, th)
    if variant != "two-psfs":
        return
    from psfmc_tpu.models.transforms import build_transform as jax_transform
    from psfmc_tpu.optimize import _marginal_lnpost_fn as jax_objective
    from psfmc_tpu_torch.models.posterior import value_and_grad
    from psfmc_tpu_torch.models.transforms import build_transform
    from psfmc_tpu_torch.optimize import _marginal_lnpost_fn

    jt = jax_transform(jspec, dtype=jnp.float64)
    tt = build_transform(spec, dtype=torch.float64)
    z = tt.to_unconstrained(th)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jax_objective(jfns, jt))))(
        jnp.asarray(z))
    v, g = value_and_grad(_marginal_lnpost_fn(post, tt), torch.as_tensor(z))
    jv, jg = np.asarray(jv), np.asarray(jg)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-10)
    assert np.all(np.abs(g.numpy() - jg) <= 1e-8 * np.abs(jg).max(1, keepdims=True))


@pytest.mark.parametrize("variant", FAMILY_VARIANTS)
def test_family_gradient_matches_jax(variant):
    """Each family variant (shaped and truncated Sersics, Moffat, King,
    Ferrer, Nuker, EdgeDisk, Fourier and bending modes, offset ties,
    oversampling, two PSFs) on its gradient path."""
    # two sub-pixels in a 4-pixel window keep JAX's compile short
    kw = (dict(render_oversample=2, oversample_window=4) if variant == "oversample"
          else {})
    jspec = jax_spec(family_components(SHAPE, PSF_SHAPE, variant, components=JC,
                                       distributions=JD, **kw))
    spec = build_model_spec(family_components(SHAPE, PSF_SHAPE, variant, **kw))
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    th = prior_draws(spec, 6, seed=5)
    _assert_grads_match(jax_posterior(jspec, dtype=jnp.float64), post, th,
                        min_finite=3)


_C30, _S30 = np.cos(np.pi / 6) * 0.05 / 3600, np.sin(np.pi / 6) * 0.05 / 3600
_WCS = {"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRPIX1": 12.5, "CRPIX2": 12.5,
        "CRVAL1": 150.0, "CRVAL2": 2.0, "CD1_1": -_C30, "CD1_2": _S30,
        "CD2_1": _S30, "CD2_2": _C30}


def _sky_tied(C, D):
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:24, 0:24].astype(float)
    psf = np.exp(-((xx - 12) ** 2 + (yy - 12) ** 2) / (2 * 1.2**2))
    host = C.Sersic(xy=D.Uniform(loc=np.array([8.0, 8.0]), scale=np.array([8.0, 8.0])),
                    mag=D.Uniform(loc=20.0, scale=2.0), reff=D.Uniform(loc=1.0, scale=4.0),
                    reff_b=D.Uniform(loc=1.0, scale=4.0), index=1.0, angle=0.0)
    ps = C.PointSource(xy=C.Tied(host, "xy", frame="sky",
                                 offset=D.Normal(loc=np.zeros(2), scale=0.3)),
                       mag=D.Uniform(loc=21.0, scale=1.0))
    return [C.Configuration(obs_file=(_WCS, 0.05 + rng.randn(24, 24) * 0.05),
                            obsivm_file=np.full((24, 24), 400.0),
                            psf_files=psf / psf.sum(), psfivm_files=np.full((24, 24), 1e8),
                            mag_zeropoint=25.0),
            C.Sky(adu=D.Normal(loc=0.05, scale=0.02)), host, ps]


def test_sky_frame_tie_gradient_matches_jax():
    """A point source tied to a Sersic in sky frame with an offset: the
    gradient flows through the WCS map to the host's position."""
    jspec, spec = jax_spec(_sky_tied(JC, JD)), build_model_spec(_sky_tied(TC, TD))
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    _assert_grads_match(jax_posterior(jspec, dtype=jnp.float64), post,
                        prior_draws(spec, 8, seed=6))


def test_joint_gradient_matches_jax():
    """The joint flagship at 24x24 + 20x20 (band 1 on the matmul-DFT
    route's shapes): the prior once, each band's likelihood, sky and pixel
    ties between the bands."""
    shapes = ((24, 24), (20, 20))
    jm = JaxJointModel(joint_components(shapes, PSF_SHAPE, components=JC,
                                        distributions=JD), dtype=jnp.float64)
    tm = JointModel(joint_components(shapes, PSF_SHAPE), device="cpu",
                    dtype=torch.float64)
    th = tm.init_params_from_priors(8, random_state=np.random.RandomState(7))
    _assert_grads_match(jm.posterior_fns, tm.posterior_fns, th)


def test_newton_kappa_gradient_matches_jax(monkeypatch):
    """``PSFMC_KAPPA=newton``: the implicit derivative of the Newton root
    against JAX's derivative of its unrolled iterations, within 1e-6."""
    monkeypatch.setenv("PSFMC_KAPPA", "newton")
    jspec = jax_spec(_graft_entry()._flagship_components((32, 32), (16, 16)))
    spec = build_model_spec(flagship_components((32, 32), (16, 16)))
    post = build_posterior(spec, device="cpu", dtype=torch.float64)
    assert post.kappa_mode == "exact"
    _assert_grads_match(jax_posterior(jspec, dtype=jnp.float64), post,
                        prior_draws(spec, 8, seed=8), vtol=1e-10, gtol=1e-6)


# -- the plain backwards against autograd through the plain forwards ---------

def _rows(batch, shape, seed):
    rng = np.random.RandomState(seed)
    h, w = shape
    rows = []
    for _ in range(2):
        xy = torch.as_tensor(rng.uniform(2, min(h, w) - 2, (batch, 2)))
        reff = torch.as_tensor(rng.uniform(1.5, 6.0, batch))
        rows.append(SR.pack_sersic_params(sersic_scalar_params(
            xy, torch.as_tensor(rng.uniform(18, 22, batch)), reff,
            reff * torch.as_tensor(rng.uniform(0.3, 1.0, batch)),
            torch.as_tensor(rng.uniform(0.5, 4.0, batch)),
            torch.as_tensor(rng.uniform(0.0, 180.0, batch)), 25.0, True)))
    rows = torch.stack(rows, dim=1)
    rows[0, 0, :2] = torch.tensor([3.0, 2.0])  # a pixel centre: both clamps
    return rows, torch.as_tensor(rng.uniform(0.0, 0.1, batch))


@pytest.mark.parametrize("shape", [(20, 17), (16, 16)])
def test_render_backward_plain_matches_autograd(shape):
    params, sky = _rows(5, shape, 1)
    grad = torch.as_tensor(np.random.RandomState(2).randn(5, *shape))
    p, s = params.clone().requires_grad_(True), sky.clone().requires_grad_(True)
    want = torch.autograd.grad((SR.render_sersics_plain(p, s, shape) * grad).sum(), (p, s))
    got = SR.render_sersics_backward_plain(params, sky, shape, grad)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10 * w.abs().max().item())
    # the autograd Function of both wrappers against a central difference
    # along one direction (away from walker 0's pixel centre, where the
    # clamps have their kinks)
    p, s = params[1:3], sky[1:3]
    dirs = (torch.as_tensor(np.random.RandomState(3).randn(*p.shape)),
            torch.as_tensor(np.random.RandomState(4).randn(*s.shape)))
    weights = torch.as_tensor(np.random.RandomState(5).randn(2, *shape))
    for fn in (SR.render_sersics, SR.render_sersics_tiled):
        _assert_directional(lambda a, b: (fn(a, b, shape) * weights).sum(), (p, s), dirs)


def _assert_directional(f, args, dirs, h=1e-6, rtol=1e-6):
    """``f``'s autograd gradient along ``dirs`` against the central
    difference ``(f(x + h d) - f(x - h d)) / 2h`` (float64)."""
    xs = [a.clone().requires_grad_(True) for a in args]
    grads = torch.autograd.grad(f(*xs), xs)
    want = sum((g * d).sum() for g, d in zip(grads, dirs)).item()
    with torch.no_grad():
        plus = f(*(a + h * d for a, d in zip(args, dirs))).item()
        minus = f(*(a - h * d for a, d in zip(args, dirs))).item()
    assert (plus - minus) / (2 * h) == pytest.approx(want, rel=rtol)


@pytest.fixture(scope="module")
def conv_consts():
    out = {}
    for shape, psf in (((16, 16), (8, 8)), ((15, 13), (8, 8)), ((24, 20), (8, 8)),
                       ((28, 14), (8, 8))):
        spec = build_model_spec(flagship_components(shape, psf))
        post = build_posterior(spec, device="cpu", dtype=torch.float64, lnpost="batched")
        out[shape] = post
    return out


@pytest.mark.parametrize("shape", [(16, 16), (15, 13), (24, 20), (28, 14)],
                         ids=["fft", "dft", "mixed", "radix7"])
def test_conv_lnl_backward_plain_matches_autograd(conv_consts, shape):
    """The version of record against autograd through the plain forward
    at 1e-10 (a NaN walker gets a zero gradient, where the forward's -inf
    passes none); on a shape of the FFT route (powers of two, or the
    mixed-radix 24x20 and 28x14) or of the padded route (15x13, odd sides
    padded to 30x28), its scheme against the version of record;
    ``gradcheck`` through the autograd Function."""
    post = conv_consts[shape]
    th = prior_draws(post.spec, 6, seed=9)
    raws = post.raw_and_ps(th)[0].detach()
    raws[1, 3, 4] = float("nan")
    grad = torch.as_tensor(np.random.RandomState(3).uniform(0.5, 2.0, 6))
    r = raws.clone().requires_grad_(True)
    lnl = CL.batched_conv_lnl_plain(r, post.consts)
    (want,) = torch.autograd.grad((torch.where(torch.isfinite(lnl), lnl, 0.0) * grad).sum(), r)
    got = CL.batched_conv_lnl_backward_plain(raws, post.consts, lnl.detach(), grad)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    keep = [0, 2, 3, 4, 5]
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-10,
                               atol=1e-10 * want[keep].abs().max().item())
    if CL.conv_route(shape) == "fft":
        scheme = CL.packed_fft_conv_backward_plain(raws, post.consts, lnl.detach(), grad)
        torch.testing.assert_close(scheme, got, rtol=1e-10,
                                   atol=1e-10 * got.abs().max().item())
    if CL.conv_route(shape) == "padded":
        _, weights, scale_exp = CL.padded_fft_conv_residuals_plain(raws, post.consts)
        scheme = CL.padded_fft_conv_backward_from_residuals_plain(
            raws, post.consts, lnl.detach(), grad, weights, scale_exp)
        torch.testing.assert_close(scheme, got, rtol=1e-10,
                                   atol=1e-10 * got.abs().max().item())
    # through the autograd Function, against a central difference
    small = raws[[0, 2]]
    direction = torch.as_tensor(np.random.RandomState(6).randn(*small.shape))
    _assert_directional(lambda x: (CL.batched_conv_lnl(x, post.consts)
                                   * grad[[0, 2]]).sum(), (small,), (direction,))


def test_newton_kappa_implicit_derivative():
    """d gammaincinv(a, 1/2) / da of the Newton solve against the JAX
    package's derivative of its unrolled iterations, within 1e-8."""
    from psfmc_tpu.ops.gammainc import gammaincinv_half as jax_kappa
    from psfmc_tpu_torch.ops.gammainc import gammaincinv_half

    a = np.array([0.3, 1.0, 3.0, 8.0, 20.0, 60.0])
    want = np.asarray(jax.vmap(jax.grad(jax_kappa))(jnp.asarray(a)))
    x = torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)
    (got,) = torch.autograd.grad(gammaincinv_half(x).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)
