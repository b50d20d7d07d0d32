"""The render family and the family flagship against the JAX package, on the CPU.

Two halves:

* each ported render function (``render_sersic_gen``, ``render_moffat``
  and ``render_moffat_gen``, King, Ferrer and Nuker with their ``_gen``
  forms, ``render_edgedisk``) against its JAX twin on one 32x32 float64
  grid, with each isophote shape alone and combined and truncation
  inner, outer and both: atol 1e-10 of the image's peak;
* the family flagship (Sky + PointSource + a de Vaucouleurs bulge and a
  boxy, truncated exponential disk, both tied to the point source) and
  each of its variants (:data:`psfmc_tpu_torch.flagship.FAMILY_VARIANTS`),
  built by each package from the same seeded numpy arrays at 32x32 with
  a 16x16 PSF: the spec (layout, rules, constants, tie maps), the gates,
  lnpost on every path the gates admit (rtol 1e-10 in float64, 1e-4 in
  float32, each with an absolute floor of a tenth of that times the
  batch's largest |lnpost|; the same non-finite entries), the carry
  images and their walker means (1e-10 of their peak), the support of
  every family and shape held walker by walker against the JAX prior,
  and a model file that imports ``ExpDisk`` and ``Tied`` from
  ``psfMC.ModelComponents`` fitted by the port's driver.
"""
import contextlib
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.model_parser import component_list_from_file as jparse
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu.ops import moffat as JM
from psfmc_tpu.ops import profiles as JP
from psfmc_tpu.ops import sersic as JS
from psfmc_tpu.ops.pallas.lnpost_batched import batched_lnl_supported as jax_gate
from psfmc_tpu.ops.pallas.lnpost_pallas import fused_lnl_supported as jax_fused_gate
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch import model_galaxy_mcmc
from psfmc_tpu_torch.flagship import (
    FAMILY_VARIANTS,
    family_components,
    family_lnpost,
    prior_draws,
    write_family_files,
)
from psfmc_tpu_torch.models import build_model_spec, build_posterior, spec_from_numpy
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.models.posterior import lnpost_mode
from psfmc_tpu_torch.ops import moffat as TM
from psfmc_tpu_torch.ops import profiles as TP
from psfmc_tpu_torch.ops import sersic as TS
from psfmc_tpu_torch.ops.kernels import batched_lnl_supported
from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_lnl_supported
from test_torch_general import numpy_fields


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPE, PSF_SHAPE = (32, 32), (16, 16)
NWALKERS = 8

# -- the render functions ----------------------------------------------------

_YG, _XG = np.mgrid[0:SHAPE[0], 0:SHAPE[1]].astype(float)
XY = [15.3, 16.7]


def _shape_kw(opts, conv):
    """The isophote-shape keywords of ``opts`` as ``conv`` arrays."""
    kw = {}
    if "fourier" in opts:
        kw["fourier"] = tuple((m, conv(0.1 * m), conv(20.0 * m)) for m in (1, 3))
    if "bending" in opts:
        kw["bending"] = ((2, conv(0.05)), (3, conv(-0.02)))
    if "rotation" in opts:
        kw["rotation"] = (conv(60.0), conv(8.0), conv(1.0), conv(1.3))
    outer, inner = (conv(9.0), conv(1.5)), (conv(1.0), conv(0.5))
    if "outer" in opts or "inner" in opts:
        kw["trunc"] = (outer if "outer" in opts else None,
                       inner if "inner" in opts else None)
    return kw


_SHAPES = {"c0": (), "fourier": ("fourier",), "bending": ("bending",),
           "rotation": ("rotation",),
           "all": ("fourier", "bending", "rotation")}
_TRUNCS = {"outer": ("outer",), "inner": ("inner",), "both": ("outer", "inner"),
           "all+both": ("fourier", "bending", "rotation", "outer", "inner")}
# (JAX function, port function, scalar arguments before c0 / mag_zp)
_GEN = {
    "sersic_gen": (JS.render_sersic_gen, TS.render_sersic_gen,
                   [21.0, 6.0, 3.0, 2.3, 40.0]),
    "moffat_gen": (JM.render_moffat_gen, TM.render_moffat_gen,
                   [21.0, 5.0, 3.0, 2.5, 40.0]),
    "king_gen": (JP.render_king_gen, TP.render_king_gen,
                 [21.0, 3.0, 2.0, 12.0, 1.7, 40.0]),
    "ferrer_gen": (JP.render_ferrer_gen, TP.render_ferrer_gen,
                   [21.0, 9.0, 6.0, 2.0, 0.5, 40.0]),
    "nuker_gen": (JP.render_nuker_gen, TP.render_nuker_gen,
                  [21.0, 3.0, 2.0, 2.0, 3.0, 0.7, 40.0]),
}
_PLAIN = {
    "moffat": (JM.render_moffat, TM.render_moffat, XY, [21.0, 5.0, 3.0, 2.5, 40.0]),
    "king": (JP.render_king, TP.render_king, XY, [21.0, 3.0, 2.0, 12.0, 1.7, 40.0]),
    "king-alpha2": (JP.render_king, TP.render_king, XY,
                    [21.0, 3.0, 2.0, 12.0, 2.0, 40.0]),
    "ferrer": (JP.render_ferrer, TP.render_ferrer, XY, [21.0, 9.0, 6.0, 2.0, 0.5, 40.0]),
    "nuker": (JP.render_nuker, TP.render_nuker, XY,
              [21.0, 3.0, 2.0, 2.0, 3.0, 0.7, 40.0]),
    # the cusp on a pixel center: the half-pixel floor decides its value
    "nuker-on-a-pixel": (JP.render_nuker, TP.render_nuker, [15.0, 16.0],
                         [21.0, 3.0, 2.0, 2.0, 3.0, 0.7, 40.0]),
    "edgedisk": (JP.render_edgedisk, TP.render_edgedisk, XY, [21.0, 5.0, 1.0, 40.0]),
    # x K1(x) at x = 0 on a pixel center
    "edgedisk-on-a-pixel": (JP.render_edgedisk, TP.render_edgedisk, [15.0, 16.0],
                            [21.0, 5.0, 1.0, 40.0]),
}


def _t(v):
    return torch.as_tensor(np.asarray(v, float))


def _assert_images_match(want, got):
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def _gen_cases():
    for name in _GEN:
        opts = dict(_SHAPES)
        if name in ("sersic_gen", "moffat_gen"):
            opts.update(_TRUNCS)
        for key, o in opts.items():
            for c0 in (0.5, -0.7):
                yield pytest.param(name, o, c0, id=f"{name}-{key}-c0={c0}")


@pytest.mark.parametrize("name,opts,c0", list(_gen_cases()))
def test_shaped_render_matches_jax(name, opts, c0):
    jfn, tfn, scalars = _GEN[name]
    tail = scalars + [c0, 25.0]
    kw = {"kappa_mode": "table"} if name == "sersic_gen" else {}
    want = jfn(jnp.asarray(_XG), jnp.asarray(_YG), jnp.asarray(XY),
               *map(jnp.asarray, tail), True, **kw, **_shape_kw(opts, jnp.asarray))
    got = tfn(_t(_XG), _t(_YG), _t(XY), *map(_t, tail), True, **kw,
              **_shape_kw(opts, _t)).numpy()
    _assert_images_match(want, got)


@pytest.mark.parametrize("name", sorted(_PLAIN))
def test_plain_render_matches_jax(name):
    jfn, tfn, xy, scalars = _PLAIN[name]
    want = jfn(jnp.asarray(_XG), jnp.asarray(_YG), jnp.asarray(xy),
               *map(jnp.asarray, scalars), 25.0, True)
    got = tfn(_t(_XG), _t(_YG), _t(xy), *map(_t, scalars), 25.0, True).numpy()
    _assert_images_match(want, got)


def test_nuker_fine_floor_and_sersic_without_correction_match_jax():
    """The forms the sub-pixel window integrates: the Nuker with its floor
    relaxed by 1/S^2 and the shaped Sersic without its correction."""
    nuk = [21.0, 3.0, 2.0, 2.0, 3.0, 0.7, 40.0, 0.2, 25.0]
    want = JP.render_nuker_gen(jnp.asarray(_XG), jnp.asarray(_YG), jnp.asarray([15.0, 16.0]),
                               *map(jnp.asarray, nuk), True, min_px_sq=0.125 / 16)
    got = TP.render_nuker_gen(_t(_XG), _t(_YG), _t([15.0, 16.0]), *map(_t, nuk), True,
                              min_px_sq=0.125 / 16).numpy()
    _assert_images_match(want, got)
    ser = [21.0, 6.0, 3.0, 2.3, 40.0, 0.3, 25.0]
    want = JS.render_sersic_gen(jnp.asarray(_XG), jnp.asarray(_YG), jnp.asarray(XY),
                                *map(jnp.asarray, ser), True, kappa_mode="table",
                                correction=False, **_shape_kw(("fourier",), jnp.asarray))
    got = TS.render_sersic_gen(_t(_XG), _t(_YG), _t(XY), *map(_t, ser), True,
                               kappa_mode="table", correction=False,
                               **_shape_kw(("fourier",), _t)).numpy()
    _assert_images_match(want, got)


def test_area_factors_match_jax():
    """The isophote area factor: the superellipse's closed form on the
    device and on the host (pi at c = 2), and the azimuthal quadrature
    with Fourier modes, against the JAX package's."""
    from psfmc_tpu.ops import isophote as JI
    from psfmc_tpu_torch.ops import isophote as TI

    c = np.array([0.06, 0.3, 1.0, 1.7, 2.0, 2.5, 3.4])
    want = np.asarray(JI.superellipse_area_factor(jnp.asarray(c)))
    np.testing.assert_allclose(TI.superellipse_area_factor(_t(c)).numpy(), want,
                               rtol=1e-12)
    np.testing.assert_allclose(TI.superellipse_area_factor_host(c), want, rtol=1e-12)
    np.testing.assert_allclose(TS.sersic_gen_area_factor(_t(2.0)).item(), np.pi,
                               rtol=1e-14)
    for degrees in (False, True):
        phi = 30.0 if degrees else 0.5
        modes = ((1, 0.2, phi), (4, -0.1, phi))
        # the JAX function takes one c at a time; the port's a batch
        want = [float(JI.isophote_area_factor(
            jnp.asarray(ci), tuple((m, jnp.asarray(a), jnp.asarray(p)) for m, a, p in modes),
            degrees)) for ci in c]
        got = TI.isophote_area_factor(
            _t(c), tuple((m, _t(np.full_like(c, a)), _t(np.full_like(c, p)))
                         for m, a, p in modes), degrees)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def _jax_each(fn, *arrays):
    """The JAX function (which takes scalars) element by element."""
    return np.array([float(fn(*map(jnp.asarray, vals))) for vals in zip(*arrays)])


def test_radial_factors_match_jax():
    """The flux integrals: King by quadrature and its closed form at alpha
    = 2, Ferrer's Beta function, Nuker's split quadrature; and x K1(x)
    from 0 across the branch point at 2."""
    sq_xt = np.array([4.0, 16.0, 100.0])
    for alpha in (0.7, 2.0, 3.1):
        a = np.full_like(sq_xt, alpha)
        np.testing.assert_allclose(TP.king_radial_factor(_t(sq_xt), _t(a)).numpy(),
                                   _jax_each(JP.king_radial_factor, sq_xt, a), rtol=1e-12)
    closed = TP.king_radial_factor_alpha2(_t(sq_xt)).numpy()
    np.testing.assert_allclose(closed, _jax_each(JP.king_radial_factor_alpha2, sq_xt),
                               rtol=1e-13)
    np.testing.assert_allclose(
        closed, TP.king_radial_factor(_t(sq_xt), _t(np.full(3, 2.0))).numpy(), rtol=1e-8)
    al, be, ga = np.array([0.5, 2.0, 4.0]), np.array([2.2, 3.0, 6.0]), np.array([-0.5, 0.7, 1.9])
    fb = np.array([0.0, 0.8, 1.9])
    got = TP.ferrer_radial_factor(_t(al), _t(fb)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_each(JP.ferrer_radial_factor, al, fb), rtol=1e-13)
    np.testing.assert_allclose(TP.nuker_radial_factor(_t(al), _t(be), _t(ga)).numpy(),
                               _jax_each(JP.nuker_radial_factor, al, be, ga), rtol=1e-12)
    x = np.array([0.0, 1e-12, 1e-3, 0.5, 1.999, 2.0, 2.001, 7.0, 40.0])
    got = TP.xk1(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.xk1(jnp.asarray(x))), rtol=1e-13)
    assert got[0] == pytest.approx(1.0, abs=1e-12) and np.isfinite(got).all()


# -- the family flagship and its variants ------------------------------------


@functools.lru_cache(maxsize=None)
def specs(variant):
    """(JAX spec, the port's spec carried from it, the port's own build)."""
    with _quiet():
        jspec = jax_spec(family_components(SHAPE, PSF_SHAPE, variant, components=JC,
                                           distributions=JD))
        own = build_model_spec(family_components(SHAPE, PSF_SHAPE, variant))
    return jspec, spec_from_numpy(**numpy_fields(jspec)), own


@contextlib.contextmanager
def _quiet():
    """Without the packages' build-time warnings (the family priors are
    not the point here)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def thetas(spec, n=NWALKERS, seed=3):
    """Prior draws with a NaN walker, an out-of-prior walker and a walker
    whose first semi-major/semi-minor pair is swapped the wrong way."""
    th = prior_draws(spec, n, seed=seed)
    off = {s.name: s.offset for s in spec.slots}
    th[1, 0] = np.nan
    th[2, off["1_PointSource_mag"]] = 40.0
    pair = next(n for n in off if n + "_b" in off)
    th[3, off[pair + "_b"]] = th[3, off[pair]] + 0.5
    return th


def _rule_table(spec):
    """Every component's rules with their payloads as plain lists."""
    def plain(payload):
        if isinstance(payload, tuple):
            return tuple(plain(p) for p in payload)
        return np.asarray(payload, float).tolist()

    return [(cs.kind, {a: (k, plain(p)) for a, (k, p) in sorted(cs.params.items())},
             dict(cs.static)) for cs in spec.comp_specs]


@pytest.mark.parametrize("variant", FAMILY_VARIANTS)
def test_family_spec_equals_jax(variant):
    jspec, carried, own = specs(variant)
    assert own.param_names == carried.param_names == list(jspec.param_names)
    assert own.num_params == jspec.num_params

    def table(spec):
        return [(s.name, s.fitsname, s.offset, s.size, s.attr, s.comp_index,
                 type(s.dist).__name__, repr(s.dist)) for s in spec.slots]

    assert table(own) == table(carried)
    assert [(s.name, s.fitsname) for s in jspec.slots] == [
        (s.name, s.fitsname) for s in own.slots]
    assert _rule_table(own) == _rule_table(jspec) == _rule_table(carried)
    for f in ("obs_data", "obs_var", "bad_px", "f_psf_stack", "f_var_stack"):
        np.testing.assert_array_equal(getattr(own, f), getattr(jspec, f))
    for f in ("num_psfs", "render_oversample", "oversample_window", "conv_pad"):
        assert getattr(own, f) == getattr(jspec, f), f
    # the tied attributes take no slot and no trace column
    assert not any(n.endswith(("DeVaucouleurs_xy",)) for n in own.param_names)
    kinds = {cs.params.get("xy", ("", None))[0] for cs in own.comp_specs}
    assert ("theta_affine_offset" in kinds) == (variant == "offset-tie")


@pytest.mark.parametrize("variant", FAMILY_VARIANTS)
def test_family_gates_match_jax(variant):
    jspec, carried, own = specs(variant)
    for spec in (carried, own):
        assert batched_lnl_supported(spec)[0] == jax_gate(jspec)
        assert fused_lnl_supported(spec)[0] == jax_fused_gate(jspec, "dft")
    want = family_lnpost(variant)
    assert lnpost_mode(spec=own) == ("general" if want == "general" else "batched")
    assert fused_lnl_supported(own)[0] == (variant in ("fused", "gaussian"))


def _paths(variant):
    _, _, own = specs(variant)
    paths = ["general"]
    if batched_lnl_supported(own)[0]:
        paths.append("batched")
    if fused_lnl_supported(own)[0]:
        paths.append("fused")
    return paths


def _lnpost_cases():
    for variant in FAMILY_VARIANTS:
        for dtype in ("float32", "float64"):
            yield pytest.param(variant, dtype, id=f"{variant}-{dtype}")


@functools.lru_cache(maxsize=None)
def jax_lnpost(variant, dtype):
    jspec, carried, _ = specs(variant)
    fns = jax_posterior(jspec, dtype=getattr(jnp, dtype))
    th = thetas(carried)
    return np.asarray(jax.vmap(fns.log_posterior)(jnp.asarray(th, getattr(jnp, dtype)))), fns


@pytest.mark.parametrize("variant,dtype", list(_lnpost_cases()))
def test_family_lnpost_matches_jax_on_every_path(variant, dtype):
    _, carried, own = specs(variant)
    th = thetas(carried)
    want, _ = jax_lnpost(variant, dtype)
    rtol = 1e-4 if dtype == "float32" else 1e-10
    fin = np.isfinite(want)
    assert fin.sum() >= NWALKERS // 2
    assert not fin[[1, 2, 3]].any()
    for path in _paths(variant):
        for spec in (carried, own):
            post = build_posterior(spec, device="cpu", dtype=getattr(torch, dtype),
                                   lnpost=path)
            got = post.log_posterior_batch(th).numpy()
            assert np.array_equal(np.isfinite(got), fin), path
            assert np.array_equal(np.isnan(got), np.isnan(want)), path
            np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                                       atol=0.1 * rtol * np.abs(want[fin]).max(),
                                       err_msg=path)


@pytest.mark.parametrize("variant", FAMILY_VARIANTS)
def test_family_images_and_carry_means_match_jax(variant):
    _, carried, _ = specs(variant)
    th = thetas(carried)
    want, jfns = jax_lnpost(variant, "float64")
    good = th[np.isfinite(want)]
    post = build_posterior(carried, device="cpu", dtype=torch.float64,
                           lnpost=_paths(variant)[-1])
    imgs = post.images_batch(good)
    jimgs = jax.vmap(jfns.carry_images)(jnp.asarray(good))
    means = post.ensemble_carry_means(good)
    jmeans = jfns.ensemble_carry_means(jnp.asarray(good))
    for got, ref in ((imgs, jimgs), (means, jmeans)):
        for k, v in ref.items():
            w = np.asarray(v)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-10 * np.abs(w).max(), err_msg=k)


# -- the support of every family and shape -----------------------------------


def _support_components(C, Dist):
    """One component of each family with every shape option it takes, on
    wide Normal priors, so that only the joint constraints can make a
    walker's prior 0."""
    def n(loc, scale=0.1):
        return Dist.Normal(loc=loc, scale=scale)

    def shape():
        return dict(c0=n(0.2), f1=n(0.1), f1_phi=n(10.0), f3=n(0.1), f3_phi=n(5.0),
                    b2=n(0.02), rot_ang=n(40.0), rot_out=n(8.0), rot_in=n(1.0),
                    rot_pow=n(1.0), angle=n(30.0))

    def trunc():
        return dict(rtrunc=n(12.0), rsoft=n(1.5), rtrunc_in=n(1.0), rsoft_in=n(0.5))

    def xy():
        return dict(xy=n(np.array([16.0, 16.0]), 1.0), mag=n(22.0))

    return [
        C.Sersic(reff=n(6.0), reff_b=n(3.0), index=n(2.0), **xy(), **shape(), **trunc()),
        C.Moffat(fwhm=n(5.0), fwhm_b=n(3.0), index=n(2.5), **xy(), **shape(), **trunc()),
        C.King(rc=n(3.0), rc_b=n(2.0), rt=n(12.0), alpha=n(2.0), **xy(), **shape()),
        C.Ferrer(rout=n(9.0), rout_b=n(6.0), alpha=n(2.0), beta=n(0.5), **xy(), **shape()),
        C.Nuker(rb=n(3.0), rb_b=n(2.0), alpha=n(2.0), beta=n(3.0), gamma=n(0.7),
                **xy(), **shape()),
        C.EdgeDisk(rs=n(5.0), hs=n(1.0), angle=n(30.0), **xy()),
    ]


# (component's trace-name prefix, attribute, value) of one violation each
_VIOLATIONS = [
    ("0_Sersic", "reff_b", 7.0), ("0_Sersic", "c0", -1.96), ("0_Sersic", "f1", 0.85),
    ("0_Sersic", "rtrunc", -0.1), ("0_Sersic", "rsoft", 0.0), ("0_Sersic", "rsoft_in", -1.0),
    ("0_Sersic", "rtrunc_in", 0.0), ("0_Sersic", "rot_out", 0.9),
    ("0_Sersic", "rot_in", -0.1), ("0_Sersic", "rot_pow", 0.0),
    ("1_Moffat", "fwhm_b", 6.0), ("1_Moffat", "index", 1.0), ("1_Moffat", "f3", -0.85),
    ("1_Moffat", "c0", -2.5), ("1_Moffat", "rsoft", -0.5),
    ("2_King", "rc_b", 3.5), ("2_King", "rt", 0.0), ("2_King", "alpha", -0.1),
    ("2_King", "rot_out", 0.5),
    ("3_Ferrer", "rout_b", 9.5), ("3_Ferrer", "alpha", 0.0), ("3_Ferrer", "beta", 2.0),
    ("3_Ferrer", "beta", -0.01), ("3_Ferrer", "f1", 0.9),
    ("4_Nuker", "rb_b", 3.5), ("4_Nuker", "alpha", 0.0), ("4_Nuker", "beta", 2.0),
    ("4_Nuker", "gamma", 2.0), ("4_Nuker", "c0", -1.95),
    ("5_EdgeDisk", "rs", 0.0), ("5_EdgeDisk", "hs", -0.2),
]


def test_support_constraints_match_jax():
    """Each constraint of the JAX prior, walker by walker: a valid walker,
    then one walker per violation (and one on the Fourier sum's edge)."""
    def build(C, Dist, build_spec):
        h, w = SHAPE
        psf = np.zeros(PSF_SHAPE)
        psf[8, 8] = 1.0
        cfg = C.Configuration(obs_file=np.zeros(SHAPE), obsivm_file=np.ones(SHAPE),
                              psf_files=psf, psfivm_files=np.ones(PSF_SHAPE) * 1e8,
                              mag_zeropoint=25.0)
        with _quiet():
            return build_spec([cfg] + _support_components(C, Dist))

    jspec = build(JC, JD, jax_spec)
    own = build(TC, TD, build_model_spec)
    assert own.param_names == list(jspec.param_names)
    off = {s.name: s.offset for s in own.slots}
    base = np.concatenate([np.atleast_1d(np.asarray(s.dist.value, float))
                           for s in own.slots])
    rows = [base.copy()]
    for comp, attr, value in _VIOLATIONS:
        row = base.copy()
        row[off[f"{comp}_{attr}"]] = value
        rows.append(row)
    edge = base.copy()  # |f1| + |f3| = 0.9 exactly: inside
    edge[off["0_Sersic_f1"]], edge[off["0_Sersic_f3"]] = 0.5, -0.4
    rows.append(edge)
    th = np.stack(rows)
    jfns = jax_posterior(jspec, dtype=jnp.float64)
    want = np.asarray(jax.vmap(jfns.log_prior)(jnp.asarray(th)))
    got = build_posterior(own, device="cpu", dtype=torch.float64) \
        .log_prior_batch(th).numpy()
    assert np.isfinite(want[0]) and np.isfinite(want[-1])
    assert (want[1:-1] == -np.inf).all()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[[0, -1]], want[[0, -1]], rtol=1e-12)


def test_draw_batch_respects_every_family_constraint():
    """The walker initialisation's rejection keeps every draw inside the
    support the posterior enforces."""
    with _quiet():
        comps = _support_components(TC, TD)
        spec = build_model_spec([family_components(SHAPE, PSF_SHAPE)[0]] + comps)
    rng = np.random.RandomState(5)
    draws = np.concatenate([c.draw_batch(64, random_state=rng) for c in comps], axis=1)
    lp = build_posterior(spec, device="cpu", dtype=torch.float64).log_prior_batch(draws)
    assert torch.isfinite(lp).all()


def test_c0_below_the_quantitative_range_warns_as_jax():
    for C, Dist in ((TC, TD), (JC, JD)):
        with pytest.warns(UserWarning, match="c0 support reaches"):
            C.Sersic(c0=Dist.Uniform(loc=-1.8, scale=1.0))
    with pytest.raises(ValueError, match="BOTH rtrunc"):
        TC.Moffat(rtrunc=5.0)
    with pytest.raises(ValueError, match="without its amplitude"):
        TC.King(f2_phi=0.3)
    with pytest.raises(TypeError, match="unexpected keyword"):
        TC.King(rtrunc=5.0, rsoft=1.0)
    with pytest.raises(TypeError, match="fixes index"):
        TC.ExpDisk(index=2.0)


# -- the model file ------------------------------------------------------------


def test_family_model_file_runs_through_the_driver(tmp_path):
    """A model file that imports ``ExpDisk``, ``DeVaucouleurs`` and
    ``Tied`` from ``psfMC.ModelComponents`` builds the JAX package's
    layout and is fitted on the CPU: the database has the JAX spec's
    columns, the tied positions none."""
    path = write_family_files(str(tmp_path), SHAPE, PSF_SHAPE)
    jnames = list(jax_spec(jparse(path)).param_names)
    db = model_galaxy_mcmc(path, output_name=str(tmp_path / "out"), chains=32,
                           burn=4, iterations=4, device="cpu")
    assert db.colnames == jnames + ["lnprobability", "walker", "sample"]
    assert not any(n.endswith(("DeVaucouleurs_xy", "ExpDisk_xy")) for n in jnames)
    assert "3_ExpDisk_c0" in jnames and "3_ExpDisk_rtrunc" in jnames
    # the layout chip_smoke.py holds the card's database to
    import chip_smoke

    assert chip_smoke.FAMILY_COLUMNS == jnames
    assert np.isfinite(db["lnprobability"]).all()
