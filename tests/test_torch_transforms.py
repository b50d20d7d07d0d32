"""The port's unconstraining transform against the JAX package's, on the CPU.

Each spec of ``tests/test_transforms.py`` (the Sersic + PointSource spec
with a Weibull index, the two-PSF spec with its discrete index, the
minor axis under a Weibull, a Normal and a constant major axis) and the
joint flagship's spec is built by each package from the same components;
both transforms run in float64.  Tolerance 1e-12 (relative, with an
absolute floor of 1e-12 of the largest magnitude) on ``to_constrained``'s
theta and log-Jacobian at seeded z, on ``to_unconstrained`` at those
thetas, and exact agreement on the layout (kinds, bounds, offsets, the
discrete offsets, the dependent pairs and the cache token).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.joint import JointModel as JaxJointModel
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.models.transforms import build_transform as jax_transform
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.flagship import joint_components
from psfmc_tpu_torch.models import JointModel, build_model_spec
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.models.transforms import build_transform, transform_token

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _psf():
    yy, xx = np.mgrid[0:32, 0:32].astype(float)
    psf = np.exp(-((xx - 16) ** 2 + (yy - 16) ** 2) / (2 * 1.5**2))
    return psf / psf.sum()


def _config(C, psfs=1):
    obs = 0.1 + np.random.RandomState(1234).randn(32, 32) * 0.01
    psf = _psf()
    files = psf if psfs == 1 else [psf, np.roll(psf, 1, axis=0)]
    ivms = np.ones_like(psf) * 1e6 if psfs == 1 else [np.ones_like(psf) * 1e6] * 2
    return C.Configuration(obs_file=obs, obsivm_file=np.full((32, 32), 1e4),
                           psf_files=files, psfivm_files=ivms, mag_zeropoint=25.0)


def _components(C, D, case):
    if case == "main":
        return [
            _config(C),
            C.Sky(adu=D.Normal(loc=0.1, scale=0.05)),
            C.PointSource(xy=D.Uniform(loc=np.array([8.0, 8.0]),
                                       scale=np.array([16.0, 16.0])),
                          mag=D.Uniform(loc=19.0, scale=3.0)),
            C.Sersic(xy=D.Uniform(loc=np.array([8.0, 8.0]),
                                  scale=np.array([16.0, 16.0])),
                     mag=D.Uniform(loc=20.0, scale=3.0),
                     reff=D.Uniform(loc=1.0, scale=7.0),
                     reff_b=D.Uniform(loc=1.0, scale=7.0),
                     index=D.WeibullMinimum(c=1.5, scale=4),
                     angle=D.Uniform(loc=0.0, scale=180.0), angle_degrees=True),
        ]
    if case == "discrete":
        return [_config(C, psfs=2), C.Sky(adu=D.Normal(loc=0.1, scale=0.05))]
    if case == "weibull":
        reff, reff_b = D.Uniform(loc=1.0, scale=7.0), D.WeibullMinimum(c=2.0, scale=3.0)
    elif case == "normal":
        reff, reff_b = D.Uniform(loc=1.0, scale=7.0), D.Normal(loc=3.0, scale=1.0)
    else:  # a constant major axis with a lower-bounded minor prior
        reff, reff_b = 5.0, D.WeibullMinimum(c=2.0, scale=3.0)
    return [
        _config(C),
        C.Sersic(xy=D.Uniform(loc=np.array([8.0, 8.0]), scale=np.array([16.0, 16.0])),
                 mag=D.Uniform(loc=20.0, scale=3.0), reff=reff, reff_b=reff_b,
                 index=1.5, angle=30.0, angle_degrees=True),
    ]


CASES = ["main", "discrete", "weibull", "normal", "const_major", "joint"]


def _specs(case):
    if case == "joint":
        shapes, psf = ((24, 24), (20, 20)), (12, 12)
        jm = JaxJointModel(joint_components(shapes, psf, components=JC,
                                            distributions=JD))
        tm = JointModel(joint_components(shapes, psf), device="cpu",
                        dtype=torch.float64)
        return jm.spec, tm.spec
    return (jax_spec(_components(JC, JD, case)),
            build_model_spec(_components(TC, TD, case)))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want[fin]).max()))


@pytest.mark.parametrize("case", CASES)
def test_transform_matches_jax(case):
    jspec, tspec = _specs(case)
    jt = jax_transform(jspec, dtype=jnp.float64)
    tt = build_transform(tspec, dtype=torch.float64)
    for attr in ("kinds", "lo", "hi", "offsets", "discrete_offsets"):
        np.testing.assert_array_equal(getattr(tt, attr), getattr(jt, attr), err_msg=attr)
    assert tt.reffb_pairs == jt.reffb_pairs
    assert tt.num_unconstrained == jt.num_unconstrained
    assert transform_token(tt) == jt.cache_token()
    if case == "discrete":
        assert len(tt.discrete_offsets) == 1
        assert tt.num_unconstrained == tspec.num_params - 1

    z = np.random.RandomState(7).randn(32, tt.num_unconstrained) * 2.0
    jtheta, jld = jax.vmap(jt.to_constrained)(jnp.asarray(z))
    ttheta, tld = tt.to_constrained(torch.as_tensor(z))
    _close(ttheta.numpy(), jtheta)
    _close(tld.numpy(), jld)
    assert np.all(np.isfinite(tld.numpy()))
    # one vector: (dim,) and a scalar log-Jacobian
    t1, l1 = tt.to_constrained(torch.as_tensor(z[0]))
    assert t1.shape == (tspec.num_params,) and l1.ndim == 0
    _close(t1.numpy(), jtheta[0])

    thetas = np.asarray(jtheta)
    _close(tt.to_unconstrained(thetas), jt.to_unconstrained(thetas))
    _close(tt.to_unconstrained(thetas[0]), jt.to_unconstrained(thetas[0]))


@pytest.mark.parametrize("case", ["main", "weibull", "normal", "const_major"])
def test_log_jacobian_is_the_jacobians_log_determinant(case):
    """The log-Jacobian of ``to_constrained`` is ``log|det dtheta/dz|``
    over the continuous slots (torch's autograd Jacobian, float64), and
    the minor axis never exceeds its major axis."""
    _, tspec = _specs(case)
    tt = build_transform(tspec, dtype=torch.float64)
    offsets = torch.as_tensor(tt.offsets, dtype=torch.int64)
    for z in np.random.RandomState(8).randn(4, tt.num_unconstrained) * 1.5:
        z = torch.as_tensor(z)
        jac = torch.autograd.functional.jacobian(
            lambda v: tt.to_constrained(v)[0][offsets], z)
        _, logdet = torch.linalg.slogdet(jac)
        assert logdet.item() == pytest.approx(tt.to_constrained(z)[1].item(),
                                              rel=1e-10, abs=1e-10)
    off = {s.name: s.offset for s in tspec.slots}
    names = [n for n in off if n.endswith("Sersic_reff_b")]
    thetas = tt.to_constrained(torch.as_tensor(
        np.random.RandomState(9).randn(64, tt.num_unconstrained) * 3.0))[0].numpy()
    for name in names:
        major = (thetas[:, off[name[:-2]]] if name[:-2] in off else 5.0)
        assert np.all(thetas[:, off[name]] <= major + 1e-12)


def test_gradient_through_the_transform_matches_jax():
    """lnpost(theta(z)) + log|J| and its gradient in z, through the port's
    posterior and through the JAX package's, at z of the JAX test's scales
    (0.1, 2, 6) in float64: the same non-finite values (a tiny index
    overflows the profile in both) and, where finite, values at rtol 1e-10
    and gradients within 1e-8 of each point's largest component."""
    from psfmc_tpu.models.posterior import build_posterior as jax_posterior
    from psfmc_tpu_torch.models import build_posterior
    from psfmc_tpu_torch.models.posterior import value_and_grad

    jspec, tspec = _specs("main")
    jt = jax_transform(jspec, dtype=jnp.float64)
    tt = build_transform(tspec, dtype=torch.float64)
    jfns = jax_posterior(jspec, dtype=jnp.float64)
    post = build_posterior(tspec, device="cpu", dtype=torch.float64)

    def jax_u(z):
        theta, ld = jt.to_constrained(z)
        return jfns.log_posterior(theta) + ld

    def port_u(z):
        theta, ld = tt.to_constrained(z)
        return post.differentiable_log_posterior(theta) + ld

    rng = np.random.RandomState(10)
    z = np.concatenate([rng.randn(8, tt.num_unconstrained) * scale
                        for scale in (0.1, 2.0, 6.0)])
    jval, jgrad = jax.jit(jax.vmap(jax.value_and_grad(jax_u)))(jnp.asarray(z))
    val, grad = value_and_grad(port_u, torch.as_tensor(z))
    jval, jgrad = np.asarray(jval), np.asarray(jgrad)
    assert np.array_equal(np.isfinite(val.numpy()), np.isfinite(jval))
    fin = np.isfinite(jval)
    assert fin.sum() >= 16
    np.testing.assert_allclose(val.numpy()[fin], jval[fin], rtol=1e-10)
    g, jg = grad.numpy()[fin], jgrad[fin]
    assert np.all(np.isfinite(g))
    assert np.all(np.abs(g - jg).max(1) <= 1e-8 * np.abs(jg).max(1))
