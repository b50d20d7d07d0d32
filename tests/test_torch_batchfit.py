"""The port's batch fit against the JAX package's, on the CPU.

Both packages build the same models from the same seeded numpy arrays at
a small size (a 32x32 observation and a 16x16 PSF; the joint flagship at
32x32 + 24x24), in float64, and each case is held to ``psfmc_tpu``:

* the stacked observation and PSF inputs (``prepare_obs_stack`` exactly,
  ``prepare_psf_stack``'s spectra to 1e-12);
* ``log_posterior_obs`` / ``log_likelihood_obs`` to 1e-9 with the same
  non-finite entries, on the kernel path (render + conv_lnl with
  per-target planes) and on the general path, with a shared PSF and
  with a PSF per target, single-band and joint;
* the stacked plain conv_lnl on every route against K calls of one
  target each (1e-12), and the rule that sends per-target spectra on the
  matmul-DFT route to the general path;
* the batched ensemble steps on the JAX package's own draws (each
  target's key split as ``batchfit.py`` splits it, handed to the port in
  its order by ``test_torch_tempered.ScriptedDraws``), for the stretch,
  DE and mixed moves: positions, lnp, moments, MAP and accept counts to
  1e-9;
* ``simulate_stack`` at the same seed (1e-9), the completeness and SBC
  statistics on the same arrays (1e-12), the catalog written by either
  package read by the other, and ``fit_batch``'s refusals.

The JAX programs of a module are compiled once (module fixtures).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import batchfit as jbf
from psfmc_tpu import distributions as JD
from psfmc_tpu.analysis import sbc as jsbc
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.joint import JointModel as JaxJoint
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch import batchfit as tbf
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.analysis import sbc as tsbc
from psfmc_tpu_torch.flagship import general_components, joint_components, prior_draws
from psfmc_tpu_torch.models import JointModel, MultiComponentModel
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.models.spec import build_model_spec
from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
from test_torch_tempered import ScriptedDraws, half_draws


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE, PSF_SHAPE = (32, 32), (16, 16)
JOINT_SHAPES = ((32, 32), (24, 24))
K, W = 3, 4  # targets and walkers a target of the lnpost parity cases
RTOL = 1e-9
PACKAGES = {"torch": (TC, TD), "jax": (JC, JD)}
FLAGSHIP = dict(num_psfs=1, gradient=False, noise_scale=False)


def _components(package, variant, shape=SHAPE, **config):
    C, D = PACKAGES[package]
    if variant.startswith("joint"):
        return joint_components(JOINT_SHAPES, PSF_SHAPE,
                                "general" if variant == "joint_general" else "flagship",
                                components=C, distributions=D)
    kw = FLAGSHIP if variant == "flagship" else {}
    return general_components(shape, PSF_SHAPE, components=C, distributions=D,
                              **kw, **config)


def _build(package, variant, shape=SHAPE):
    comps = _components(package, variant, shape)
    if variant.startswith("joint"):
        if package == "torch":
            return JointModel(comps, device="cpu", dtype=torch.float64)
        return JaxJoint(comps, dtype=jnp.float64)
    if package == "torch":
        return MultiComponentModel(comps, device="cpu", dtype=torch.float64)
    return JaxModel(comps, dtype=jnp.float64)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = (_build("torch", variant), _build("jax", variant))
        return cache[variant]

    return get


def psf_stars(n, shape=PSF_SHAPE, num_psfs=1, seed=3):
    """``n`` targets' Gaussian PSF stars (sigma 1.6-2.4 px) and IVMs: one
    array each, or a list of ``num_psfs``."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(float)
    psfs, ivms = [], []
    for _ in range(n):
        stars = []
        for _ in range(num_psfs):
            s = rng.uniform(1.6, 2.4)
            p = np.exp(-((xx - shape[1] / 2) ** 2 + (yy - shape[0] / 2) ** 2) / (2 * s * s))
            stars.append(p / p.sum())
        ivm = [np.full(shape, 1e8)] * num_psfs
        psfs.append(stars if num_psfs > 1 else stars[0])
        ivms.append(ivm if num_psfs > 1 else ivm[0])
    return psfs, ivms


def _obs_dicts(tm, jm, survey, seed=1):
    """The same obs dict for both packages (flat ``b{i}_`` keys for a joint
    model): mocks of the model, with per-target PSFs in ``survey`` mode
    (band 0 only for a joint model)."""
    obs, ivm, _ = tbf.simulate_stack(tm, K, seed=seed)
    specs = getattr(tm.spec, "band_specs", None)
    if specs is None:
        t = tbf.prepare_obs_stack(tm.spec, obs, ivm, np.float64)
        j = jbf.prepare_obs_stack(jm.spec, obs, ivm, np.float64)
        if survey:
            p, i = psf_stars(K, num_psfs=tm.spec.num_psfs)
            t.update(tbf.prepare_psf_stack(tm.spec, p, i, dtype=np.float64))
            j.update(jbf.prepare_psf_stack(jm.spec, p, i, dtype=np.float64))
        return t, j
    t, j = {}, {}
    for b, (ts, js) in enumerate(zip(specs, jm.spec.band_specs)):
        dt = tbf.prepare_obs_stack(ts, obs[b], ivm[b], np.float64)
        dj = jbf.prepare_obs_stack(js, obs[b], ivm[b], np.float64)
        if survey and b == 0:
            p, i = psf_stars(K, num_psfs=ts.num_psfs)
            dt.update(tbf.prepare_psf_stack(ts, p, i, dtype=np.float64))
            dj.update(jbf.prepare_psf_stack(js, p, i, dtype=np.float64))
        t.update({f"b{b}_{k}": v for k, v in dt.items()})
        j.update({f"b{b}_{k}": v for k, v in dj.items()})
    return t, j


def _assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol)


# -- the inputs ------------------------------------------------------------------
@pytest.mark.parametrize("variant,config", [("flagship", {}), ("general", {}),
                                            ("general", {"conv_pad": 3})])
def test_prepare_stacks_match_jax(variant, config):
    tspec = build_model_spec(_components("torch", variant, **config))
    jspec = jax_spec(_components("jax", variant, **config))
    rng = np.random.RandomState(11)
    obs = rng.randn(K, *SHAPE) * 0.01
    ivm = np.full((K, *SHAPE), 4e4)
    obs[0, 3, 4], ivm[1, 5, 6], ivm[2, 7, 8] = np.nan, 0.0, np.inf
    for dtype in (np.float32, np.float64):
        got = tbf.prepare_obs_stack(tspec, obs, ivm, dtype)
        want = jbf.prepare_obs_stack(jspec, obs, ivm, dtype)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert not got["good_px"][0, 3, 4] and not got["good_px"][1, 5, 6]
    psfs, ivms = psf_stars(K, num_psfs=tspec.num_psfs)
    got = tbf.prepare_psf_stack(tspec, psfs, ivms, dtype=np.float64)
    want = jbf.prepare_psf_stack(jspec, psfs, ivms, dtype=np.float64)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)
    expect = (K, tspec.num_psfs) + tuple(np.shape(tspec.f_psf_stack)[1:])
    assert got["psf_f_re"].shape == expect


def test_prepare_errors_match_jax():
    poisson = dict(likelihood="poisson", counts=True, gradient=False, noise_scale=False)
    tspec = build_model_spec(_components("torch", "general", **poisson))
    jspec = jax_spec(_components("jax", "general", **poisson))
    obs = np.full((2, *SHAPE), 3.0)
    obs[1, 2, 2] = -1.0
    cases = [(lambda m, s: m.prepare_obs_stack(s, obs, np.ones_like(obs))),
             (lambda m, s: m.prepare_obs_stack(s, obs[0], np.ones_like(obs[0]))),
             (lambda m, s: m.prepare_obs_stack(s, obs[:, :8], np.ones_like(obs[:, :8]))),
             (lambda m, s: m.prepare_psf_stack(s, [np.ones(PSF_SHAPE)], [])),
             (lambda m, s: m.prepare_psf_stack(s, [np.ones(PSF_SHAPE)],
                                               [np.ones(PSF_SHAPE)]))]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(jbf, jspec)
        with pytest.raises(ValueError) as got:
            case(tbf, tspec)
        assert str(got.value) == str(want.value)


# -- the posterior against a stack -----------------------------------------------
@pytest.fixture(scope="module")
def jax_obs_fns():
    """Jitted JAX lnpost / lnL of one target's walkers, per model."""
    cache = {}

    def get(jm):
        if id(jm) not in cache:
            fns = jm.posterior_fns
            if getattr(fns, "band_fns", None) is not None:
                cache[id(jm)] = (jax.jit(jax.vmap(jbf._lnpost_obs_for(fns),
                                                  in_axes=(0, None))), None)
            else:
                cache[id(jm)] = tuple(jax.jit(jax.vmap(f, in_axes=(0, None)))
                                      for f in (fns.log_posterior_obs,
                                                fns.log_likelihood_obs))
        return cache[id(jm)]

    return get


def _thetas(spec, n, seed=5):
    th = prior_draws(spec, n, seed=seed)
    th[1, 0] = np.nan  # -inf
    names = spec.param_names
    off = dict(zip(names, np.cumsum([0] + spec.param_lens)))
    th[2, off["2_Sersic_reff"]], th[2, off["2_Sersic_reff_b"]] = 2.5, 5.0  # -inf
    return th


@pytest.mark.parametrize("survey", [False, True])
@pytest.mark.parametrize("variant,mode", [("flagship", ("batched",)),
                                          ("general", ("general",)),
                                          ("joint", ("batched", "batched")),
                                          ("joint_general", ("general", "general"))])
def test_log_posterior_obs_matches_jax(models, jax_obs_fns, variant, mode, survey):
    tm, jm = models(variant)
    tobs, jobs = _obs_dicts(tm, jm, survey)
    th = _thetas(tm.spec, K * W)
    stacks = tbf.prepare_obs_for(tm.posterior_fns, tobs)
    assert tuple(s.mode for s in stacks) == mode
    assert (stacks[0].f_stack is not None or (stacks[0].consts is not None
                                               and stacks[0].consts.target_spectra)) == survey
    lnpost = tbf._lnpost_obs_for(tm.posterior_fns)(torch.as_tensor(th), stacks).numpy()
    jpost, jlike = jax_obs_fns(jm)
    per = [{k: v[t] for k, v in jobs.items()} for t in range(K)]
    want = np.concatenate([np.asarray(jpost(jnp.asarray(th[t * W:(t + 1) * W]), per[t]))
                           for t in range(K)])
    _assert_close(lnpost, want)
    assert np.isfinite(lnpost).sum() == K * W - 2
    if jlike is not None:
        got = tm.posterior_fns.log_likelihood_obs(torch.as_tensor(th), stacks[0]).numpy()
        want = np.concatenate([np.asarray(jlike(jnp.asarray(th[t * W:(t + 1) * W]),
                                                per[t])) for t in range(K)])
        _assert_close(got, want)
        # the dict goes through prepare_obs itself
        _assert_close(tm.posterior_fns.log_posterior_obs(torch.as_tensor(th), tobs).numpy(),
                      lnpost, rtol=0)


def test_log_posterior_obs_of_the_template_is_the_posterior(models):
    """Against a stack holding the model's own observation, the batch
    posterior is the model's posterior (each walker as its target)."""
    tm, _ = models("flagship")
    spec = tm.spec
    with np.errstate(divide="ignore"):
        ivm = np.where(np.isfinite(spec.obs_var), 1.0 / np.asarray(spec.obs_var), 0.0)
    obs = tbf.prepare_obs_stack(spec, np.repeat(np.asarray(spec.obs_data)[None], 2, 0),
                                np.repeat(ivm[None], 2, 0), np.float64)
    th = torch.as_tensor(_thetas(spec, 6))
    _assert_close(tm.posterior_fns.log_posterior_obs(th, obs).numpy(),
                  tm.posterior_fns.log_posterior_batch(th).numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="split evenly"):
        tm.posterior_fns.log_posterior_obs(th[:5], obs)


# -- conv_lnl with a target axis -------------------------------------------------
def _kernel_spectra(shape, rng):
    h, w = shape
    k = np.zeros(shape)
    k[h // 2 - 1:h // 2 + 2, w // 2 - 1:w // 2 + 2] = rng.rand(3, 3)
    k /= k.sum()
    shifted = np.fft.ifftshift(k)
    return np.fft.rfft2(shifted), np.fft.rfft2(shifted * shifted * 1e-3)


@pytest.mark.parametrize("shape", [(32, 32), (24, 20), (28, 28), (15, 13), (94, 94)])
@pytest.mark.parametrize("target_spectra", [False, True])
def test_stacked_plain_conv_lnl_matches_per_target_calls(shape, target_spectra):
    """The plain versions with a target axis (``batched_conv_lnl_plain``,
    ``packed_fft_conv_plain``, ``padded_fft_conv_plain``) against one call
    per target, on the radix-2, mixed-radix, radix-7, padded and cluster
    routes (94x94: a 192x192 transform over 2 blocks): 1e-12; and the gradient through the stacked consts against each
    target's single-observation gradient: 1e-10."""
    rng = np.random.RandomState(sum(shape))
    nt, wpt = 3, 4
    spectra = [_kernel_spectra(shape, rng) for _ in range(nt)]
    f_psf = np.stack([s[0] for s in spectra])
    f_var = np.stack([s[1] for s in spectra])
    obs = rng.randn(nt, *shape)
    var = rng.rand(nt, *shape) + 0.5
    good = rng.rand(nt, *shape) > 0.1
    raws = torch.as_tensor(rng.rand(nt * wpt, *shape))
    route = CL.conv_route(shape)
    stacked = CL.make_conv_lnl_consts_stack(
        f_psf if target_spectra else f_psf[0], f_var if target_spectra else f_var[0],
        obs, var, good, "cpu", torch.float64)
    assert stacked.targets == nt and stacked.target_spectra == target_spectra
    if target_spectra and route == "dft":
        assert not CL.target_spectra_supported(shape)
        with pytest.raises(ValueError, match="general path"):
            CL.batched_conv_lnl(raws, stacked)
        return
    got = CL.batched_conv_lnl(raws, stacked)
    scheme = {"fft": CL.packed_fft_conv_plain, "padded": CL.padded_fft_conv_plain,
              "cluster": CL.padded_fft_conv_plain}.get(route)
    for t in range(nt):
        one = CL.make_conv_lnl_consts(f_psf[t if target_spectra else 0],
                                      f_var[t if target_spectra else 0],
                                      obs[t], var[t], good[t], "cpu", torch.float64)
        rows = slice(t * wpt, (t + 1) * wpt)
        np.testing.assert_allclose(got[rows].numpy(),
                                   CL.batched_conv_lnl(raws[rows], one).numpy(),
                                   rtol=1e-12, atol=1e-12)
        if scheme is not None:
            for a, b in zip(scheme(raws, stacked), scheme(raws[rows], one)):
                np.testing.assert_allclose(a[rows].numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-12)
    with pytest.raises(ValueError, match="split evenly"):
        CL.batched_conv_lnl(raws[:-1], stacked)
    # the gradient through the stacked consts: each target's rows are the
    # gradient of that target's single-observation call
    weight = torch.arange(1.0, nt * wpt + 1.0, dtype=torch.float64)
    leaf = raws.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad((CL.batched_conv_lnl(leaf, stacked) * weight).sum(), leaf)
    for t in range(nt):
        one = CL.make_conv_lnl_consts(f_psf[t if target_spectra else 0],
                                      f_var[t if target_spectra else 0],
                                      obs[t], var[t], good[t], "cpu", torch.float64)
        rows = slice(t * wpt, (t + 1) * wpt)
        leaf_t = raws[rows].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(
            (CL.batched_conv_lnl(leaf_t, one) * weight[rows]).sum(), leaf_t)
        np.testing.assert_allclose(grad[rows].numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(want.abs().max()))


def test_copy_target_consts_writes_in_place():
    rng = np.random.RandomState(8)
    shape = (15, 13)  # the padded route: its spectra too
    spectra = [_kernel_spectra(shape, rng) for _ in range(2)]
    f_psf, f_var = (np.stack([s[i] for s in spectra]) for i in (0, 1))

    def stack(fp, fv):
        return CL.make_conv_lnl_consts_stack(fp, fv, rng.randn(2, *shape),
                                             rng.rand(2, *shape) + 1,
                                             rng.rand(2, *shape) > 0.2, "cpu", torch.float64)

    a, b = stack(f_psf, f_var), stack(f_psf[::-1] * 2.0, f_var[::-1])
    ptrs = [getattr(a, n).data_ptr() for n in ("obs", "pad_psf_r", "var_gain")]
    CL.copy_target_consts_(a, b)
    assert ptrs == [getattr(a, n).data_ptr() for n in ("obs", "pad_psf_r", "var_gain")]
    for n in CL.TARGET_FIELDS + CL.TARGET_SPECTRA_FIELDS:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


def test_survey_mode_on_the_dft_route_takes_the_general_path():
    """At 1x64 (a side of 1: the matmul-DFT route, the one shape family left
    there since the global route took 512x512) a stack with a PSF per
    target takes the general path, a stack with the shared PSF the kernel
    path, and both agree with the JAX package."""
    shape, psf_shape = (1, 64), (1, 16)

    def components(package):
        C, D = PACKAGES[package]
        return general_components(shape, psf_shape, components=C, distributions=D,
                                  **FLAGSHIP)

    tm = MultiComponentModel(components("torch"), device="cpu", dtype=torch.float64)
    jm = JaxModel(components("jax"), dtype=jnp.float64)
    assert CL.conv_route(shape) == "dft"
    assert CL.batched_lnl_supported(tm.spec) == (True, "")
    assert not CL.target_spectra_supported(shape)
    fns = tm.posterior_fns
    assert fns.obs_mode() == "batched" and fns.obs_mode(True) == "general"
    nt, wpt = 2, 2
    obs, ivm, _ = tbf.simulate_stack(tm, nt, seed=4)
    psfs, ivms = psf_stars(nt, psf_shape)
    th = prior_draws(tm.spec, nt * wpt, seed=6)
    jfun = jax.jit(jax.vmap(jm.posterior_fns.log_posterior_obs, in_axes=(0, None)))
    for survey in (False, True):
        tobs = tbf.prepare_obs_stack(tm.spec, obs, ivm, np.float64)
        jobs = jbf.prepare_obs_stack(jm.spec, obs, ivm, np.float64)
        if survey:
            tobs.update(tbf.prepare_psf_stack(tm.spec, psfs, ivms, dtype=np.float64))
            jobs.update(jbf.prepare_psf_stack(jm.spec, psfs, ivms, dtype=np.float64))
        stack = fns.prepare_obs(tobs)
        assert stack.mode == ("general" if survey else "batched")
        got = fns.log_posterior_obs(torch.as_tensor(th), stack).numpy()
        want = np.concatenate([
            np.asarray(jfun(jnp.asarray(th[t * wpt:(t + 1) * wpt]),
                            {k: v[t] for k, v in jobs.items()})) for t in range(nt)])
        _assert_close(got, want)


# -- the batched steps on the JAX package's draws ------------------------------------
def batch_step_draws(keys, nwalkers, moves):
    """One batched step's draws, in the port's order, from each target's
    key as ``psfmc_tpu/batchfit.py``'s step splits it (``key, k0, k1, km``;
    each half-step's six-way split in ``half_draws``), stacked over the
    targets; and the targets' next keys."""
    half = nwalkers // 2
    per_target, new_keys = [], []
    for key in keys:
        key, k0, k1, km = jax.random.split(key, 4)
        new_keys.append(key)
        items = []
        if moves == "mixed":
            items.append(("uniform", np.array(0.25 if bool(jax.random.bernoulli(km))
                                              else 0.75)))
        items += half_draws(k0, (half,), nwalkers - half, moves)
        items += half_draws(k1, (nwalkers - half,), half, moves)
        per_target.append(items)
    out = [(kind, np.stack([np.asarray(t[i][1]) for t in per_target]))
           for i, (kind, _) in enumerate(per_target[0])]
    return out, new_keys


def scripted(keys, nwalkers, moves, steps):
    items = []
    for _ in range(steps):
        step, keys = batch_step_draws(keys, nwalkers, moves)
        items += step
    return ScriptedDraws(items)


class _JaxToy:
    """A target with a support: each target's Gaussian around its ``mu``,
    ``-inf`` outside ``|theta| <= 3``."""

    dtype = jnp.float64

    @staticmethod
    def log_posterior_obs(theta, obs):
        lnl = -0.5 * jnp.sum((theta - obs["mu"]) ** 2 / 0.5)
        return jnp.where(jnp.all(jnp.abs(theta) <= 3.0), lnl, -jnp.inf)


class _TorchToy:
    device = torch.device("cpu")
    dtype = torch.float64

    @staticmethod
    def log_posterior_obs(thetas, mu):
        x = thetas.reshape(mu.shape[0], -1, thetas.shape[1])
        lnl = -0.5 * (((x - mu[:, None]) ** 2) / 0.5).sum(dim=-1)
        inside = (x.abs() <= 3.0).all(dim=-1)
        return torch.where(inside, lnl, torch.full_like(lnl, -math.inf)).reshape(-1)


def _compare_fit(out, want, nwalkers, iterations):
    for key in ("mean", "std", "map_theta", "map_lnp"):
        _assert_close(out[key], want[key])
    _assert_close(out["chain"], want["chain"])
    _assert_close(out["lnprob"], want["lnprob"])
    np.testing.assert_array_equal(
        out["naccept"], np.rint(np.asarray(want["acceptance"], np.float64)
                                * iterations * nwalkers))


@pytest.mark.parametrize("moves", ["stretch", "de", "mixed"])
def test_batch_steps_match_jax(moves):
    """3 burn + 3 retained steps of 3 targets x 12 walkers on a toy
    posterior with a support: the port's batched step (its program's
    ``run``) on the JAX package's draws against ``_make_single_fit`` under
    ``vmap``."""
    nt, nw, dim, burn, iters = 3, 12, 3, 3, 3
    rng = np.random.RandomState(21)
    mu = rng.uniform(-1, 1, (nt, dim))
    p0 = rng.uniform(-3.2, 3.2, (nt, nw, dim))  # some outside the support
    keys = list(jax.random.split(jax.random.PRNGKey(22), nt))
    run = jbf._make_single_fit(_JaxToy(), nw, dim, burn, iters, 2.0, moves, None, 1)
    want = jax.jit(jax.vmap(run, in_axes=(0, 0, 0)))(jnp.stack(keys), jnp.asarray(p0),
                                                     {"mu": jnp.asarray(mu)})
    draws = scripted(keys, nw, moves, burn + iters)
    prog = tbf._BatchProgram(_TorchToy(), [torch.as_tensor(mu)], nt, nw, dim, 2.0, moves,
                             None, iters, draws=draws)
    out = prog.run(p0, prog.stacks, 0, burn, iters, 1)
    assert not draws.items  # every draw taken, in order
    _compare_fit(out, want, nw, iters)
    assert 0 < out["naccept"].sum() < nt * nw * iters


@pytest.fixture(scope="module")
def flagship_fit(models):
    tm, jm = models("flagship")
    nt, nw, burn, iters = 2, 8, 2, 2
    obs, ivm, _ = tbf.simulate_stack(tm, nt, seed=12)
    tobs = tbf.prepare_obs_stack(tm.spec, obs, ivm, np.float64)
    jobs = jbf.prepare_obs_stack(jm.spec, obs, ivm, np.float64)
    p0 = tm.init_params_from_priors(nt * nw, random_state=np.random.RandomState(13)
                                    ).reshape(nt, nw, -1)
    keys = list(jax.random.split(jax.random.PRNGKey(14), nt))
    run = jbf._make_single_fit(jm.posterior_fns, nw, tm.num_params, burn, iters, 2.0,
                               "stretch", None, 1)
    want = jax.jit(jax.vmap(run))(jnp.stack(keys), jnp.asarray(p0),
                                  {k: jnp.asarray(v) for k, v in jobs.items()})
    return tm, tobs, p0, keys, want, (nt, nw, burn, iters)


def test_flagship_batch_steps_match_jax(flagship_fit):
    """The flagship (render + conv_lnl with per-target planes): 2 burn + 2
    retained stretch steps of 2 targets x 8 walkers on the JAX draws."""
    tm, tobs, p0, keys, want, (nt, nw, burn, iters) = flagship_fit
    fns = tm.posterior_fns
    stacks = tbf.prepare_obs_for(fns, tobs)
    assert stacks[0].mode == "batched"
    prog = tbf._BatchProgram(fns, stacks, nt, nw, tm.num_params, 2.0, "stretch", None,
                             iters, draws=scripted(keys, nw, "stretch", burn + iters))
    out = prog.run(p0, stacks, 0, burn, iters, 1)
    _compare_fit(out, want, nw, iters)


# -- simulate_stack ----------------------------------------------------------------
@pytest.mark.parametrize("variant", ["flagship", "general", "joint"])
@pytest.mark.parametrize("add_noise", [True, False])
def test_simulate_stack_matches_jax(models, variant, add_noise):
    tm, jm = models(variant)
    got = tbf.simulate_stack(tm, 4, seed=9, add_noise=add_noise)
    want = jbf.simulate_stack(jm, 4, seed=9, add_noise=add_noise)
    for g, w in zip(got, want):
        if isinstance(w, list):
            for gb, wb in zip(g, w):
                np.testing.assert_allclose(gb, wb, rtol=RTOL, atol=RTOL)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)
    thetas = prior_draws(tm.spec, 2, seed=1)
    np.testing.assert_allclose(tbf.simulate_stack(tm, 2, seed=3, thetas=thetas)[0][0],
                               jbf.simulate_stack(jm, 2, seed=3, thetas=thetas)[0][0],
                               rtol=RTOL, atol=RTOL)
    for pkg, model in ((tbf, tm), (jbf, jm)):
        with pytest.raises(ValueError, match="thetas shape"):
            pkg.simulate_stack(model, 3, thetas=thetas)


# -- the statistics ------------------------------------------------------------------
def _result(pkg, rng, k=60):
    names = ["0_Sky_adu", "1_PointSource_mag", "1_PointSource_xy"]
    injected = rng.randn(k, 4)
    injected[:, 1] = rng.uniform(20.0, 24.0, k)
    mean = injected + rng.randn(k, 4) * 0.1
    mean[:, 1] += np.where(injected[:, 1] > 22.5, 4.0, 0.0)
    std = np.abs(rng.randn(k, 4)) * 0.2 + 0.01
    return pkg.BatchFitResult(param_names=names, mean=mean, std=std,
                              map_theta=mean + 0.01, map_lnp=rng.randn(k),
                              acceptance=rng.uniform(0.1, 0.5, k), param_lens=[1, 1, 2]), \
        injected


@pytest.mark.parametrize("bins", [8, 3, np.array([20.0, 21.5, 23.0, 24.0])])
def test_completeness_fraction_matches_jax(bins):
    tres, injected = _result(tbf, np.random.RandomState(30))
    jres, _ = _result(jbf, np.random.RandomState(30))
    for recovered in (None, lambda r, inj: r.mean[:, 0] > inj[:, 0]):
        got = tbf.completeness_fraction(tres, injected, "1_PointSource_mag", bins=bins,
                                        recovered=recovered)
        want = jbf.completeness_fraction(jres, injected, "1_PointSource_mag", bins=bins,
                                         recovered=recovered)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tres.pulls(injected), jres.pulls(injected), rtol=1e-12)
    for param in ("1_PointSource_xy", "nope"):
        with pytest.raises(ValueError) as want_err:
            jbf.completeness_fraction(jres, injected, param)
        with pytest.raises(ValueError) as got_err:
            tbf.completeness_fraction(tres, injected, param)
        assert str(got_err.value) == str(want_err.value)


def test_sbc_statistics_match_jax():
    rng = np.random.RandomState(31)
    chains = np.round(rng.randn(40, 6, 8, 3), 1)  # ties at one decimal
    injected = np.round(rng.randn(40, 3), 1)
    for seed in range(3):
        np.testing.assert_array_equal(
            tsbc.sbc_ranks_from_chains(chains, injected, rng=np.random.RandomState(seed)),
            jsbc.sbc_ranks_from_chains(chains, injected, rng=np.random.RandomState(seed)))
    ranks = tsbc.sbc_ranks_from_chains(chains, injected)
    for bins in (20, 7, 100):
        got = tsbc.SBCResult(["a", "b", "c"], ranks, 48, injected, bins)
        want = jsbc.SBCResult(["a", "b", "c"], ranks, 48, injected, bins)
        np.testing.assert_allclose(got.uniformity_pvalues(), want.uniformity_pvalues(),
                                   rtol=1e-12, atol=1e-12)
        assert got.calibrated() == want.calibrated() and got.summary() == want.summary()
        assert got.n_sims == 40


# -- the catalog -----------------------------------------------------------------
@pytest.mark.parametrize("with_injected", [False, True])
def test_catalog_round_trips_between_packages(tmp_path, with_injected):
    tres, injected = _result(tbf, np.random.RandomState(32), k=5)
    jres, _ = _result(jbf, np.random.RandomState(32), k=5)
    inj = injected if with_injected else None
    tbf.save_batch_results(tres, str(tmp_path / "t.fits"), injected=inj)
    jbf.save_batch_results(jres, str(tmp_path / "j.fits"), injected=inj)
    for path in ("t.fits", "j.fits"):
        a = tbf.load_batch_results(str(tmp_path / path))
        b = jbf.load_batch_results(str(tmp_path / path))
        assert a.colnames == b.colnames and len(a) == 5
        for name in b.colnames:
            np.testing.assert_array_equal(np.asarray(a[name]), np.asarray(b[name]))
        assert a.meta["NTARGETS"] == 5 and bool(a.meta["MCINJECT"]) == with_injected
    a = tbf.load_batch_results(str(tmp_path / "t.fits"))
    np.testing.assert_array_equal(a["1_PointSource_xy_mean"], tres.mean[:, 2:4])
    if with_injected:
        np.testing.assert_allclose(a["0_Sky_adu_pull"], tres.pulls(injected)[:, 0])


# -- fit_batch -------------------------------------------------------------------------
def test_fit_batch_refusals_match_jax(models):
    tm, jm = models("flagship")
    obs, ivm, _ = tbf.simulate_stack(tm, 2, seed=1)
    with pytest.raises(TypeError, match="mesh must be a psfmc_tpu_torch.parallel.WalkerMesh"):
        tbf.fit_batch(tm, obs, ivm, mesh=object())
    with pytest.raises(TypeError, match="mesh must be a psfmc_tpu_torch.parallel.WalkerMesh"):
        tsbc.run_sbc(tm, n_sims=2, mesh=object())
    for kwargs in (dict(nwalkers=7), dict(moves="walk"), dict(iterations=10, record_every=3),
                   dict(psf_stack=[np.ones(PSF_SHAPE)] * 2),
                   dict(psf_stack=[np.ones(PSF_SHAPE)] * 3, psfivm_stack=[np.ones(PSF_SHAPE)] * 3)):
        with pytest.raises(ValueError) as want:
            jbf.fit_batch(jm, obs, ivm, burn=1, **kwargs)
        with pytest.raises(ValueError) as got:
            tbf.fit_batch(tm, obs, ivm, burn=1, **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="record_every > 0"):
        tsbc.run_sbc(tm, n_sims=2, record_every=0)


def test_fit_batch_chunks_fit_their_own_data(models):
    """K = 5 targets in chunks of 2 (the last padded): one program for the
    chunk shape, reused by every chunk and by a second call, which gives
    the same result; swapping two targets of different chunks changes
    exactly their rows."""
    tm, _ = models("flagship")
    obs, ivm, injected = tbf.simulate_stack(tm, 5, seed=1)
    kw = dict(nwalkers=12, burn=3, iterations=4, record_every=2, chunk=2, seed=3)
    fns = tm.posterior_fns
    fns.__dict__.pop("_batch_program", None)
    res = tbf.fit_batch(tm, obs, ivm, **kw)
    _, program = fns.__dict__["_batch_program"]
    assert res.mean.shape == res.std.shape == res.map_theta.shape == (5, tm.num_params)
    assert res.chains.shape == (5, 2, 12, tm.num_params) and res.lnprob.shape == (5, 2, 12)
    assert np.isfinite(res.mean).all() and np.isfinite(res.psrf()).all()
    assert np.all((res.acceptance >= 0) & (res.acceptance <= 1))
    assert np.all(res.lnprob.max(axis=(1, 2)) <= res.map_lnp)
    again = tbf.fit_batch(tm, obs, ivm, **kw)
    assert fns.__dict__["_batch_program"][1] is program
    for name in ("mean", "std", "map_lnp", "acceptance", "chains"):
        np.testing.assert_array_equal(getattr(again, name), getattr(res, name))
    swapped = obs.copy()
    swapped[[0, 4]] = swapped[[4, 0]]
    other = tbf.fit_batch(tm, swapped, ivm, **kw)
    changed = [not np.array_equal(other.mean[i], res.mean[i]) for i in range(5)]
    assert changed == [True, False, False, False, True]
    assert res.pulls(injected).shape == (5, tm.num_params)


def test_fit_batch_keeps_one_program_a_posterior(models):
    """A call with another chunk shape replaces the cached program, and the
    replaced one (its buffers and chains) is freed at once, with no
    collection; a third call with the first shape builds it anew."""
    import weakref

    tm, _ = models("flagship")
    obs, ivm, _ = tbf.simulate_stack(tm, 4, seed=1)
    fns = tm.posterior_fns
    kw = dict(nwalkers=8, burn=1, iterations=2, record_every=1, seed=3)
    tbf.fit_batch(tm, obs, ivm, chunk=2, **kw)
    first_key, first = fns.__dict__["_batch_program"]
    gone = weakref.ref(first)
    del first
    tbf.fit_batch(tm, obs, ivm, chunk=3, **kw)
    key, program = fns.__dict__["_batch_program"]
    assert gone() is None
    assert key != first_key and program.state.positions.shape[0] == 3
    tbf.fit_batch(tm, obs, ivm, chunk=2, **kw)
    assert fns.__dict__["_batch_program"][0] == first_key
    assert fns.__dict__["_batch_program"][1] is not program


@pytest.mark.parametrize("moves", ["de", "mixed"])
def test_fit_batch_survey_and_joint_run(models, moves):
    """Survey mode (a PSF per target) single-band and joint (band 0's PSF
    per target, band 1 the template's): finite per-target results."""
    tm, _ = models("flagship")
    obs, ivm, _ = tbf.simulate_stack(tm, 3, seed=2)
    psfs, ivms = psf_stars(3)
    res = tbf.fit_batch(tm, obs, ivm, nwalkers=10, burn=2, iterations=2, moves=moves,
                        psf_stack=psfs, psfivm_stack=ivms)
    assert np.isfinite(res.mean).all() and res.mean.shape == (3, tm.num_params)
    jt, _ = models("joint")
    obs, ivm, _ = tbf.simulate_stack(jt, 2, seed=2)
    res = tbf.fit_batch(jt, obs, ivm, nwalkers=10, burn=2, iterations=2, moves=moves,
                        psf_stack=[psfs[:2], None], psfivm_stack=[ivms[:2], None])
    assert np.isfinite(res.mean).all() and res.mean.shape == (2, jt.num_params)
    with pytest.raises(ValueError, match="one obs/ivm stack per band"):
        tbf.fit_batch(jt, obs[:1], ivm[:1])


def test_run_sbc_on_the_cpu(models):
    tm, _ = models("flagship")
    res = tsbc.run_sbc(tm, n_sims=5, nwalkers=10, burn=2, iterations=4, record_every=2,
                       chunk=3)
    assert res.ranks.shape == (5, tm.num_params) and res.n_posterior == 2 * 10
    assert np.all((res.ranks >= 0) & (res.ranks <= res.n_posterior))
    assert np.all((res.uniformity_pvalues() >= 0) & (res.uniformity_pvalues() <= 1))
    assert len(res.param_names) == tm.num_params


# -- chip_smoke's batch phase --------------------------------------------------------
def test_chip_smoke_batch_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.batch_phase`` at 32x32 (joint 32x32 + 24x24, band 1 on
    the padded route at 22x26 and on the cluster route at 94x94; survey
    mode also at 94x94, its per-target spectra on the cluster route) with 4
    targets on the CPU, where the kernel wrappers run their plain versions:
    the render and conv_lnl wrappers are counted as the card counts its
    kernels (conv_lnl on ``<route>_targets`` for a stacked consts, by route
    and shape), so the phase's exact launch checks, its chunking checks
    (the eager and the graphless fit alike here), the swap and its rows
    hold here; the times are stubbed."""
    import functools

    import chip_smoke as cs
    import psfmc_tpu_torch.models.posterior as P
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    def counting(mod, name):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            wrapped.launches += 1
            if name == "batched_conv_lnl":
                consts = a[-1]
                route = CL.conv_route(consts.shape)
                key = route + "_targets" if consts.targets else route
                wrapped.route_launches[key] += 1
                wrapped.shape_launches[(key, consts.shape)] = wrapped.shape_launches.get(
                    (key, consts.shape), 0) + 1
            return orig(*a, **k)

        wrapped.launches = 0
        if name == "batched_conv_lnl":
            wrapped.route_launches = dict.fromkeys(CL.batched_conv_lnl.route_launches, 0)
            wrapped.shape_launches = {}
        monkeypatch.setattr(mod, name, wrapped)
        monkeypatch.setattr(P, name, wrapped)

    for mod, name in ((CL, "batched_conv_lnl"), (SR, "render_sersics")):
        counting(mod, name)
    # a forced route (the matmul-DFT route timed beside the cluster route) has
    # no CPU mode
    monkeypatch.setattr(CL, "_launch", lambda raws, consts, route:
                        CL.batched_conv_lnl_plain(raws, consts))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn, **k: (fn(), 0.123)[1])
    monkeypatch.setattr(cs, "sfu_results_per_s", lambda: 4.0e12)
    for name, value in (("FLAGSHIP_SHAPE", (32, 32)), ("MIXED_SHAPE", (24, 24)),
                        ("MIXED_PSF_SHAPE", (12, 12)), ("PADDED_SHAPE", (22, 26)),
                        ("PADDED_PSF_SHAPE", (12, 12)), ("CLUSTER_PSF_SHAPE", (12, 12)),
                        ("BATCH_TARGETS", 4), ("BATCH_BURN", 3), ("BATCH_SAMPLE", 6),
                        ("BATCH_RECORD", 2),
                        ("BATCH_CHUNK_TARGETS", 5), ("BATCH_CHUNK", 2),
                        ("BATCH_CHUNK_STEPS", 2), ("BATCH_SURVEY_TARGETS", 3),
                        ("BATCH_SURVEY_STEPS", 2), ("BATCH_JOINT_TARGETS", 2),
                        ("BATCH_JOINT_STEPS", 2), ("BATCH_ROUTE_STEPS", 1),
                        ("SBC_SIMS", 4), ("SBC_BURN", 2), ("SBC_SAMPLE", 4),
                        ("SBC_RECORD", 2)):
        monkeypatch.setattr(cs, name, value)
    got = cs.batch_phase(psf_shape=(16, 16), joint_shapes=((32, 32), (24, 24)),
                         device="cpu")
    names = [r["name"] for r in got["rows"]]
    assert names == ["conv_lnl_targets", "conv_lnl_targets_spectra", "conv_lnl_targets_mixed",
                     "conv_lnl_targets_padded", "conv_lnl_targets_cluster",
                     "conv_lnl_targets_cluster_spectra"]
    launches = {r["name"]: r["launches"] for r in got["rows"]}
    # evaluations: the start, then two a step; the flagship batch, the three
    # joint batches' band 0 and the SBC; the survey fits (32x32, 94x94); each
    # band 1
    evals = {"batch": 2 * (1 + 2 * 9), "survey": 1 + 2 * 4, "joint": 1 + 2 * 4,
             "route": 1 + 2 * 2, "sbc": 1 + 2 * 6}  # the flagship batch runs twice
    assert launches == {
        "conv_lnl_targets": evals["batch"] + evals["joint"] + 2 * evals["route"] + evals["sbc"],
        "conv_lnl_targets_spectra": evals["survey"], "conv_lnl_targets_mixed": evals["joint"],
        "conv_lnl_targets_padded": evals["route"], "conv_lnl_targets_cluster": evals["route"],
        "conv_lnl_targets_cluster_spectra": evals["survey"]}
    # the render: once a band and evaluation, and the SBC's mocks once
    assert got["render_launches"] == (evals["batch"] + 2 * evals["survey"] + 2 * evals["joint"]
                                      + 2 * 2 * evals["route"] + 1 + evals["sbc"])
    for r in got["rows"]:
        assert r["max_rel_err"] <= cs.CONV_LNL_TOL and r["targets"] == 4
        assert r["walkers"] == 4 * 19 and math.isfinite(r["bound_ms"])
    assert got["out"]["fit"]["lnpost_rel_err"] <= cs.SLICE_RTOL
    assert got["out"]["chunked"]["chunks"] == 3
    # the render and conv_lnl against their plain versions at each fit's
    # half-step batch, each band of a joint fit on its own shape and stack
    checks = got["kernel_checks"]
    assert [(c["fit"], c["band"]) for c in checks] == [
        ("batch", 0), ("batch, chunked", 0), ("batch, survey", 0),
        ("batch, survey at 94x94", 0), ("batch, joint", 0),
        ("batch, joint", 1), ("batch, joint, padded band", 0),
        ("batch, joint, padded band", 1), ("batch, joint, cluster band", 0),
        ("batch, joint, cluster band", 1), ("batch, sbc", 0)]
    assert checks[0]["batch"] == 4 * 19 and checks[0]["targets"] == 4
    assert checks[3]["render_shape"] == [94, 94]
    assert [c["render_shape"] for c in checks[4:10:2]] == [[32, 32]] * 3
    assert [c["render_shape"] for c in checks[5:10:2]] == [[24, 24], [22, 26], [94, 94]]
    assert [c["target_spectra"] for c in checks] == [False, False, True, True] + [False] * 7
    for c in checks:
        assert c["render_max_rel_err"] <= cs.RENDER_TOL
        assert c["conv_lnl_max_rel_err"] <= cs.CONV_LNL_TOL
        assert c["conv_lnl_per_walker_rel_err"] <= cs.CONV_LNL_TOL
        assert c["conv_lnl_min_abs_lnl"] > 0
