"""The port's public surface against the JAX package's, on the CPU.

Every name in the ``__all__`` of each JAX module that has a counterpart in
the port is present there, with one stated exception
(``utils.apply_platform_env``, which selects a JAX platform); the JAX
modules without a counterpart are each listed with the reason.  The
names this slice added are held to JAX: ``array_coords``,
``add_pointsource`` / ``render_pointsource`` (lanczos3 and bilinear,
inside the image and clipped at its edges), ``sersic_sq_radii``,
``fft_convolve_direct`` and ``Configuration.coords`` within 1e-12 in
float64 and 1e-6 relative in float32; ``nuts_kernel`` transitions (a
batch of chains and one chain) at 1e-12 on JAX's draws, as
``tests/test_torch_nuts.py`` holds its pieces; ``run_stretch_move`` bit
for bit the port's sampler on the same generator, its ``thin`` and
``record=False`` cases as JAX's, and its moments on a correlated
Gaussian within ``tests/test_moment_parity.py``'s criterion of the JAX
``run_stretch_move``.  A fresh interpreter that imports the command line
and the GALFIT module holds neither ``jax`` nor ``psfmc_tpu`` (nor
matplotlib).  Each test runs torch on one thread.
"""
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psfmc_tpu
from psfmc_tpu.models import components as JC
from psfmc_tpu.ops import coords as jcoords
from psfmc_tpu.ops import fourier as jfourier
from psfmc_tpu.ops import pointsource as jps
from psfmc_tpu.ops import sersic as jsersic
from psfmc_tpu.sampler import ensemble as jens
from psfmc_tpu.sampler import nuts as jn
from psfmc_tpu_torch import ops as tops
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.sampler import EnsembleSampler, EnsembleState, run_stretch_move
from psfmc_tpu_torch.sampler import nuts as tn
from test_torch_io import REPO
from test_torch_nuts import POTENTIALS, ScriptedDraws, _assert_transition, _torch_vg, \
    transition_draws

@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# JAX modules with no counterpart in the port, and why
NO_PORT = {
    "psfmc_tpu.cachelog": "the XLA compile cache's log: no XLA here (ROADMAP Queue 1)",
    "psfmc_tpu.compat": "JAX version shims (ROADMAP Queue 1)",
    "psfmc_tpu.ops.fastmath": "the TPU's software exp/log; torch's are accurate "
                              "(ROADMAP Queue 1)",
    "psfmc_tpu.ops.pallas": "the Pallas kernels: ported as CUDA in psfmc_tpu_torch/csrc",
    "psfmc_tpu.ops.pallas.lnpost_batched": "ported as csrc/conv_lnl.cu",
    "psfmc_tpu.ops.pallas.lnpost_pallas": "ported as csrc/fused_lnl.cu",
    "psfmc_tpu.ops.pallas.sersic_pallas": "ported as csrc/sersic_render.cu",
}
# names of a ported module's __all__ the port leaves out, and why
NOT_PORTED = {("psfmc_tpu.utils", "apply_platform_env"):
              "selects a JAX platform; the port's commands read PSFMC_PLATFORM themselves"}


def _jax_modules():
    yield "psfmc_tpu"
    for info in pkgutil.walk_packages(psfmc_tpu.__path__, "psfmc_tpu."):
        yield info.name


@pytest.mark.parametrize("name", sorted(_jax_modules()))
def test_every_public_name_has_its_counterpart(name):
    port_name = "psfmc_tpu_torch" + name[len("psfmc_tpu"):]
    try:
        found = importlib.util.find_spec(port_name) is not None
    except ModuleNotFoundError:  # its parent package is not ported either
        found = False
    if not found:
        assert name in NO_PORT, f"{name} has no counterpart {port_name}"
        return
    assert name not in NO_PORT, f"{name} is ported now: take it off NO_PORT"
    names = getattr(importlib.import_module(name), "__all__", [])
    port = importlib.import_module(port_name)
    missing = [n for n in names if not hasattr(port, n) and (name, n) not in NOT_PORTED]
    assert not missing, f"{port_name} lacks {missing}"
    for (mod, n), why in NOT_PORTED.items():
        if mod == name:
            assert n in names and not hasattr(port, n), why


def test_reexports_are_the_same_objects():
    from psfmc_tpu_torch import io, sampler, utils
    from psfmc_tpu_torch.models import multicomponent, posterior
    from psfmc_tpu_torch.ops import gammainc, sersic
    from psfmc_tpu_torch.sampler import autocorr

    assert gammainc.sersic_kappa is sersic.sersic_kappa is tops.sersic_kappa
    assert posterior.IMAGE_TYPES is multicomponent.IMAGE_TYPES
    assert posterior.IMAGE_TYPES == importlib.import_module(
        "psfmc_tpu.models.posterior").IMAGE_TYPES
    assert sampler.function is autocorr.function
    assert utils.array_coords is tops.array_coords and utils.convolve is tops.convolve
    assert io.MiniWCS is io.wcs.MiniWCS and io.region_mask is io.region.region_mask
    assert io.Table is io.table.Table


# -- the ops --------------------------------------------------------------------------
def _close(got, want, dtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-6 * scale


@pytest.mark.parametrize("shape", [(5, 7), (24, 24), (1, 3)])
def test_array_coords_matches_jax(shape):
    got = tops.array_coords(shape)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jcoords.array_coords(shape))


POINTS = [(11.3, 12.7), (0.2, 23.6), (-3.0, 5.5), (23.9, -1.2), (6.5, 6.5), (12.0, 12.0)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["lanczos3", "bilinear"])
@pytest.mark.parametrize("xy", POINTS)
def test_pointsources_match_jax(xy, method, dtype):
    shape, mag, zp = (24, 24), 20.3, 25.0
    rng = np.random.RandomState(int(10 * xy[0]) % 97)
    img = rng.rand(*shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tops.add_pointsource(torch.as_tensor(img, dtype=tdt),
                               torch.as_tensor(xy, dtype=tdt), mag, zp, method)
    want = jps.add_pointsource(jnp.asarray(img, jdt), jnp.asarray(xy, jdt), mag, zp, method)
    assert got.dtype == tdt
    _close(got, want, dtype)
    got = tops.render_pointsource(shape, torch.as_tensor(xy, dtype=tdt), mag, zp, method,
                                  dtype=tdt)
    want = jps.render_pointsource(shape, jnp.asarray(xy, jdt), mag, zp, method, dtype=jdt)
    _close(got, want, dtype)
    assert tops.pointsource.window_size(method) == jps.window_size(method)
    # inside the image the window holds what the dense form renders
    if 3.0 <= min(xy) and max(xy) <= 20.0 and method == "lanczos3":
        dense = tops.render_pointsource_dense(shape, torch.as_tensor(xy, dtype=tdt),
                                              torch.tensor(mag, dtype=tdt), zp, method)
        _close(got, dense, dtype)


def test_pointsource_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="Unknown shift method"):
        tops.render_pointsource((8, 8), (3.0, 3.0), 20.0, 25.0, "cubic")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("angle_degrees", [True, False])
def test_sersic_sq_radii_matches_jax(dtype, angle_degrees):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xg, yg = tops.coord_grids((20, 24), tdt)
    jxg, jyg = jcoords.coord_grids((20, 24), jdt)
    args = (10.0, 9.0, 4.0, 2.5, 37.0 if angle_degrees else 0.6)  # x on a pixel column
    got = tops.sersic_sq_radii(xg, yg, *(torch.tensor(a, dtype=tdt) for a in args),
                               angle_degrees=angle_degrees)
    want = jsersic.sersic_sq_radii(jxg, jyg, *(jnp.asarray(a, jdt) for a in args),
                                   angle_degrees=angle_degrees)
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(16, 16), (15, 21)])
def test_fft_convolve_direct_matches_jax(dtype, shape):
    rng = np.random.RandomState(3)
    img, kern = rng.rand(2, *shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tops.fourier.fft_convolve_direct(torch.as_tensor(img, dtype=tdt),
                                           torch.as_tensor(kern, dtype=tdt))
    want = jfourier.fft_convolve_direct(jnp.asarray(img, jdt), jnp.asarray(kern, jdt))
    _close(got, want, dtype)


def test_configuration_coords_match_jax():
    rng = np.random.RandomState(4)
    obs, psf = rng.rand(12, 17), rng.rand(6, 6)
    kw = dict(obs_file=obs, obsivm_file=np.ones_like(obs), psf_files=psf,
              psfivm_files=np.ones_like(psf), mag_zeropoint=25.0)
    got, want = TC.Configuration(**kw).coords, JC.Configuration(**kw).coords
    assert got.dtype == np.float64 and got.shape == (12 * 17, 2)
    np.testing.assert_array_equal(got, want)


# -- nuts_kernel -----------------------------------------------------------------------
@pytest.mark.parametrize("potential", sorted(POTENTIALS))
def test_nuts_kernel_matches_jax(potential, depth=4):
    """The batched step on JAX's draws (``ScriptedDraws``), and one chain's
    step (``z`` of shape ``(m,)``, a per-chain potential) on chain 0's
    draws, each against the JAX kernel at 1e-12."""
    jax_u, torch_u = POTENTIALS[potential]
    rng = np.random.RandomState(depth + 7)
    z0 = rng.randn(5, 3)
    eps, inv_mass = 0.3, np.array([1.0, 0.7, 1.3])
    jvg = jax.value_and_grad(jax_u)
    keys = jax.random.split(jax.random.PRNGKey(depth), 5)
    u0, g0 = jax.vmap(jvg)(jnp.asarray(z0))
    jstep = jn.nuts_kernel(jvg, max_depth=depth)
    want = jax.jit(jax.vmap(jstep, in_axes=(0, 0, 0, 0, None, None)))(
        keys, jnp.asarray(z0), u0, g0, eps, jnp.asarray(inv_mass))
    vg = _torch_vg(torch_u)
    step = tn.nuts_kernel(vg, max_depth=depth)
    got = step(ScriptedDraws([transition_draws(keys, 3, depth)]), torch.as_tensor(z0),
               torch.as_tensor(np.array(u0)), torch.as_tensor(np.array(g0)), eps,
               torch.as_tensor(inv_mass))
    _assert_transition(got, want, 1e-12)

    def one_chain_vg(z):
        u, g = vg(z[None])
        return u[0], g[0]

    want1 = jax.tree_util.tree_map(lambda x: x[0], want)  # chain 0 of the JAX batch
    draws = ScriptedDraws([tuple(x[:1] for x in transition_draws(keys, 3, depth))])
    got1 = tn.nuts_kernel(one_chain_vg, max_depth=depth)(
        draws, torch.as_tensor(z0[0]), float(u0[0]),
        torch.as_tensor(np.array(g0[0])), eps, torch.as_tensor(inv_mass))
    assert got1[0].shape == (3,) and got1[1].shape == () and got1[1].dtype == torch.float64
    _assert_transition(got1, want1, 1e-12)


def test_nuts_kernel_takes_a_generator():
    """A ``torch.Generator`` draws as :class:`NUTSDraws` does: two
    generators of one seed give the same transition."""
    vg = _torch_vg(POTENTIALS["banana"][1])
    z0 = torch.as_tensor(np.random.RandomState(1).randn(4, 3))
    u0, g0 = vg(z0)
    step = tn.nuts_kernel(vg, max_depth=5)
    outs = [step(torch.Generator().manual_seed(9), z0, u0, g0, 0.2, torch.ones(3)),
            step(tn.NUTSDraws(torch.Generator().manual_seed(9), "cpu"), z0, u0, g0, 0.2,
                 torch.ones(3))]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(a, b)
    assert all(torch.equal(outs[0][3][k], outs[1][3][k]) for k in outs[0][3])
    assert torch.all(torch.isfinite(outs[0][0])) and (outs[0][3]["n_leapfrog"] >= 1).all()


# -- run_stretch_move -----------------------------------------------------------------
MEAN = np.array([1.0, -2.0, 0.5])
COV = np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.5]])
PREC = np.linalg.inv(COV)


class _Gaussian:
    """A correlated 3-D Gaussian with the posterior interface."""

    device = torch.device("cpu")
    dtype = torch.float64

    def log_posterior_batch(self, x):
        d = x - torch.as_tensor(MEAN)
        return -0.5 * ((d @ torch.as_tensor(PREC)) * d).sum(-1)


def _state(post, p0):
    p0 = torch.as_tensor(p0)
    return EnsembleState(positions=p0.clone(), log_prob=post.log_posterior_batch(p0),
                         accum={}, accum_count=torch.zeros((), dtype=torch.int64),
                         naccept=torch.zeros(p0.shape[0], dtype=torch.int64))


@pytest.mark.parametrize("moves", ["stretch", "de", "mixed"])
def test_run_stretch_move_is_the_samplers_stepping(moves):
    post = _Gaussian()
    p0 = np.random.RandomState(2).randn(16, 3)
    s = EnsembleSampler(16, 3, post, seed=7, device="cpu", moves=moves)
    s.init_state(p0)
    s.run_sampling(30)
    state0 = _state(post, p0)
    final, chain, lnprob = run_stretch_move(post.log_posterior_batch, None, state0, 30,
                                            moves=moves,
                                            generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(chain.numpy().transpose(1, 0, 2), s.chain)
    np.testing.assert_array_equal(lnprob.numpy().T, s.lnprobability)
    assert torch.equal(final.positions, s.state.positions)
    assert torch.equal(final.naccept, s.state.naccept)
    assert torch.equal(state0.positions, torch.as_tensor(p0))  # the input is left as it was
    # thin: every thin-th state of the same steps; record=False: no chain
    _, thinned, thin_lnp = run_stretch_move(post.log_posterior_batch, None, state0, 30,
                                            moves=moves, thin=3,
                                            generator=torch.Generator().manual_seed(7))
    assert torch.equal(thinned, chain[2::3]) and torch.equal(thin_lnp, lnprob[2::3])
    last, c, lp = run_stretch_move(post.log_posterior_batch, None, state0, 30, moves=moves,
                                   record=False, generator=torch.Generator().manual_seed(7))
    assert c is None and lp is None and torch.equal(last.positions, final.positions)


def test_run_stretch_move_thin_and_record_cases_as_jax():
    post = _Gaussian()
    p0 = np.random.RandomState(3).randn(8, 3)
    jstate = jens.EnsembleState(
        positions=jnp.asarray(p0), log_prob=-0.5 * jnp.einsum("bi,ij,bj->b", p0 - MEAN,
                                                              PREC, p0 - MEAN),
        accum=None, accum_count=jnp.int32(0), naccept=jnp.zeros(8, jnp.int32),
        key=jax.random.PRNGKey(0))

    def jlnp(x):
        d = x - jnp.asarray(MEAN)
        return -0.5 * jnp.einsum("bi,ij,bj->b", d, jnp.asarray(PREC), d)

    with pytest.raises(ValueError) as want:
        jens.run_stretch_move(jlnp, None, jstate, 10, thin=3)
    with pytest.raises(ValueError) as got:
        run_stretch_move(post.log_posterior_batch, None, _state(post, p0), 10, thin=3,
                         generator=torch.Generator())
    assert str(got.value) == str(want.value)
    # thin without record is not checked for divisibility, in either
    jens.run_stretch_move(jlnp, None, jstate, 10, thin=3, record=False)
    final, chain, lnprob = run_stretch_move(post.log_posterior_batch, None,
                                            _state(post, p0), 10, thin=3, record=False,
                                            generator=torch.Generator())
    assert chain is None and lnprob is None and final.positions.shape == (8, 3)
    _, chain, lnprob = run_stretch_move(post.log_posterior_batch, None, _state(post, p0),
                                        12, thin=4, generator=torch.Generator())
    _, jchain, jlnprob = jens.run_stretch_move(jlnp, None, jstate, 12, thin=4)
    assert chain.shape == jchain.shape == (3, 8, 3) and lnprob.shape == jlnprob.shape


def test_run_stretch_move_accumulates_images_from_images_fn():
    """``images_fn`` per walker serves the accumulation as the JAX
    package's vmapped one: the running means and the raw image's M2."""
    post = _Gaussian()
    p0 = np.random.RandomState(4).randn(8, 3)
    state = _state(post, p0)
    state.accum = {k: torch.zeros((2, 2), dtype=torch.float64) for k in ("raw", "raw_m2")}

    def images_fn(theta):
        return {"raw": theta[0] * torch.ones((2, 2), dtype=theta.dtype)}

    final, chain, _ = run_stretch_move(post.log_posterior_batch, images_fn, state, 6,
                                       accumulate=True, generator=torch.Generator())
    first = chain[:, :, 0].numpy()
    np.testing.assert_allclose(final.accum["raw"].numpy(), first.mean() * np.ones((2, 2)),
                               rtol=1e-12)
    np.testing.assert_allclose(final.accum["raw_m2"].numpy(),
                               ((first - first.mean()) ** 2).sum() * np.ones((2, 2)),
                               rtol=1e-10)
    assert int(final.accum_count) == 6 * 8


def test_run_stretch_move_moments_match_jax():
    """32 walkers, 200 + 1000 steps on the correlated Gaussian in each
    package: the means within 5 Monte Carlo standard errors (tau 25) + 1e-3
    of JAX's and the standard deviations within 35%."""
    post = _Gaussian()
    nwalkers, burn, n = 32, 200, 1000
    p0 = np.random.RandomState(5).randn(nwalkers, 3) * 0.1

    def jlnp(x):
        d = x - jnp.asarray(MEAN)
        return -0.5 * jnp.einsum("bi,ij,bj->b", d, jnp.asarray(PREC), d)

    jstate = jens.EnsembleState(
        positions=jnp.asarray(p0), log_prob=jlnp(jnp.asarray(p0)), accum=None,
        accum_count=jnp.int32(0), naccept=jnp.zeros(nwalkers, jnp.int32),
        key=jax.random.PRNGKey(11))
    jstate, _, _ = jens.run_stretch_move(jlnp, None, jstate, burn, record=False)
    _, jchain, _ = jens.run_stretch_move(jlnp, None, jstate, n)
    gen = torch.Generator().manual_seed(11)
    state, _, _ = run_stretch_move(post.log_posterior_batch, None, _state(post, p0), burn,
                                   record=False, generator=gen)
    _, chain, _ = run_stretch_move(post.log_posterior_batch, None, state, n, generator=gen)
    flat_j = np.asarray(jchain).reshape(-1, 3)
    flat_t = chain.numpy().reshape(-1, 3)
    se = flat_j.std(axis=0) * np.sqrt(25.0 / flat_j.shape[0])
    assert np.all(np.abs(flat_t.mean(axis=0) - flat_j.mean(axis=0)) < 5 * se + 1e-3)
    np.testing.assert_allclose(flat_t.std(axis=0), flat_j.std(axis=0), rtol=0.35)
    np.testing.assert_allclose(flat_t.mean(axis=0), MEAN, atol=0.15)


# -- the import footprint ----------------------------------------------------------------
def test_cli_and_galfit_import_neither_jax_nor_psfmc_tpu():
    code = ("import sys, psfmc_tpu_torch.cli, psfmc_tpu_torch.io.galfit\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'psfmc_tpu', 'matplotlib')))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
