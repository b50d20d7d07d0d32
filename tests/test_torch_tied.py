"""Pixel-frame ``Tied`` parameters in the port against the JAX package, on the CPU.

A tie resolves at spec build to the slot of the attribute it names (no
slot, no trace column of its own), to a constant, or through a chain;
an offset tie (``Tied(..., offset=prior)``) adds the component's own
slots and renders ``A @ theta[base] + b + theta[own]``
(``theta_affine_offset``) or, on a constant base, ``theta_affine``.
Each case is built by both packages from the same seeded arrays at
24x24; the specs (names, rules, tie maps) must be equal and lnpost
must agree at rtol 1e-10 in float64.  The error cases raise the
exception types the JAX package raises; a ``frame="sky"`` tie maps
through the band's WCS where the observation has one and raises the
JAX package's ``ValueError`` where it has none.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import distributions as JD
from psfmc_tpu.model_parser import component_list_from_string as jparse_string
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.posterior import build_posterior as jax_posterior
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch.flagship import prior_draws
from psfmc_tpu_torch.model_parser import component_list_from_string
from psfmc_tpu_torch.models import build_model_spec, build_posterior
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.ops.kernels import batched_lnl_supported
from psfmc_tpu_torch.ops.kernels.fused_lnl import fused_lnl_supported

PACKAGES = {"torch": (TC, TD, build_model_spec), "jax": (JC, JD, jax_spec)}


def _config(C, h=24, w=24, noise=0.05):
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    psf = np.exp(-((xx - 12) ** 2 + (yy - 12) ** 2) / (2 * 1.2**2))
    return C.Configuration(obs_file=0.05 + rng.randn(h, w) * noise,
                           obsivm_file=np.full((h, w), 1.0 / noise**2),
                           psf_files=psf / psf.sum(),
                           psfivm_files=np.full((h, w), 1e8), mag_zeropoint=25.0)


def _host(C, D, xy=None):
    if xy is None:
        xy = D.Uniform(loc=np.array([8.0, 8.0]), scale=np.array([8.0, 8.0]))
    return C.Sersic(xy=xy, mag=D.Uniform(loc=20.0, scale=2.0),
                    reff=D.Uniform(loc=1.0, scale=4.0),
                    reff_b=D.Uniform(loc=1.0, scale=4.0), index=1.0, angle=0.0)


def _ps(C, D, xy):
    return C.PointSource(xy=xy, mag=D.Uniform(loc=21.0, scale=1.0))


# each case builds [components] from (components, distributions)
def _pure(C, D):
    host = _host(C, D)
    return [C.Sky(adu=0.05), host, _ps(C, D, C.Tied(host, "xy"))]


def _const(C, D):
    host = _host(C, D, np.array([11.0, 13.0]))
    return [host, _ps(C, D, C.Tied(host, "xy"))]


def _chain(C, D):
    host = _host(C, D)
    ps1 = _ps(C, D, C.Tied(host, "xy"))
    return [host, ps1, _ps(C, D, C.Tied(ps1, "xy"))]


def _offset(C, D):
    host = _host(C, D)
    off = D.Normal(loc=np.array([0.0, 0.0]), scale=0.3)
    return [C.Sky(adu=0.05), host, _ps(C, D, C.Tied(host, "xy", offset=off))]


def _offset_on_const(C, D):
    host = _host(C, D, np.array([11.0, 13.0]))
    off = D.Normal(loc=np.array([0.0, 0.0]), scale=0.3)
    return [host, _ps(C, D, C.Tied(host, "xy", offset=off))]


def _offset_through_chain(C, D):
    host = _host(C, D)
    mid = _ps(C, D, C.Tied(host, "xy"))
    off = D.Normal(loc=np.array([0.0, 0.0]), scale=0.3)
    return [host, mid, _ps(C, D, C.Tied(mid, "xy", offset=off))]


def _scalar_ties(C, D):
    """Ties of scalar attributes across families: a Moffat's angle and a
    King's magnitude on the Sersic's."""
    host = C.Sersic(xy=D.Uniform(loc=np.array([8.0, 8.0]), scale=np.array([8.0, 8.0])),
                    mag=D.Uniform(loc=20.0, scale=2.0), reff=D.Uniform(loc=2.0, scale=4.0),
                    reff_b=D.Uniform(loc=1.0, scale=1.0), index=1.0,
                    angle=D.Uniform(loc=0.0, scale=3.0))
    moffat = C.Moffat(xy=C.Tied(host, "xy"), mag=D.Uniform(loc=21.0, scale=1.0),
                      fwhm=3.0, fwhm_b=2.0, index=2.5, angle=C.Tied(host, "angle"))
    king = C.King(xy=C.Tied(host, "xy"), mag=C.Tied(host, "mag"), rc=2.0, rc_b=1.5,
                  rt=10.0, angle=C.Tied(moffat, "angle"))
    return [host, moffat, king]


CASES = {"pure": _pure, "const": _const, "chain": _chain, "offset": _offset,
         "offset-on-const": _offset_on_const, "offset-through-chain": _offset_through_chain,
         "scalar-ties": _scalar_ties}
# the rule each case gives the last component's tied attribute
RULE = {"pure": "theta", "const": "const", "chain": "theta",
        "offset": "theta_affine_offset", "offset-on-const": "theta_affine",
        "offset-through-chain": "theta_affine_offset", "scalar-ties": "theta"}


def _build(case, package):
    C, D, build = PACKAGES[package]
    return build([_config(C)] + CASES[case](C, D))


def _plain(payload):
    if isinstance(payload, tuple):
        return tuple(_plain(p) for p in payload)
    return np.asarray(payload, float).tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tie_spec_equals_jax(case):
    own, jspec = _build(case, "torch"), _build(case, "jax")
    assert own.param_names == list(jspec.param_names)
    assert [(s.offset, s.size, s.fitsname) for s in own.slots] == [
        (s.offset, s.size, s.fitsname) for s in jspec.slots]
    for a, b in zip(own.comp_specs, jspec.comp_specs):
        assert a.kind == b.kind
        assert {k: (r, _plain(p)) for k, (r, p) in a.params.items()} == {
            k: (r, _plain(p)) for k, (r, p) in b.params.items()}
    attr = "angle" if case == "scalar-ties" else "xy"
    last = [cs for cs in own.comp_specs if cs.kind != "psfselector"][-1]
    assert last.params[attr][0] == RULE[case]
    # a pure tie adds no column; an offset tie adds the offset's
    tied = [n for n in own.param_names if n.endswith("PointSource_xy")]
    assert len(tied) == (1 if RULE[case].startswith("theta_affine") else 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tie_lnpost_matches_jax(case):
    own, jspec = _build(case, "torch"), _build(case, "jax")
    th = prior_draws(own, 6, seed=2)
    want = np.asarray(jax.vmap(jax_posterior(jspec, dtype=jnp.float64).log_posterior)(
        jnp.asarray(th)))
    assert np.isfinite(want).sum() >= 3
    paths = ["general"] + [p for p, gate in (("batched", batched_lnl_supported),
                                             ("fused", fused_lnl_supported))
                           if gate(own)[0]]
    assert "batched" in paths
    for path in paths:
        got = build_posterior(own, device="cpu", dtype=torch.float64,
                              lnpost=path).log_posterior_batch(th).numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), path
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, err_msg=path)


def test_tied_model_equals_the_untied_model_at_the_shared_position():
    """The tie renders the point source from the host's slot: the
    likelihood of the tied model equals the untied model's with the
    position copied (the untied one's prior has the position's term)."""
    tied = _build("pure", "torch")
    host = _host(TC, TD)
    free = build_model_spec([_config(TC), TC.Sky(adu=0.05), host,
                             _ps(TC, TD, TD.Uniform(loc=np.array([8.0, 8.0]),
                                                    scale=np.array([8.0, 8.0])))])
    assert free.num_params == tied.num_params + 2
    th = prior_draws(tied, 5, seed=4)
    i_xy = tied.param_names.index("1_Sersic_xy")
    i_ps = next(s.offset for s in free.slots if s.name.endswith("PointSource_xy"))
    th_free = np.insert(th, i_ps, th[:, [tied.slots[i_xy].offset,
                                         tied.slots[i_xy].offset + 1]].T, axis=1)
    a = build_posterior(tied, device="cpu", dtype=torch.float64)
    b = build_posterior(free, device="cpu", dtype=torch.float64)
    torch.testing.assert_close(a.log_posterior_batch(th) - a.log_prior_batch(th),
                               b.log_posterior_batch(th_free) - b.log_prior_batch(th_free),
                               rtol=1e-12, atol=0)


def test_offset_tie_is_exact_in_float32():
    """The tie map ``A @ theta[base] + b + theta[own]`` of an identity map
    is the plain sum in float32 (no reduced-precision product)."""
    spec = _build("offset", "torch")
    post = build_posterior(spec, device="cpu", dtype=torch.float32)
    th = post.as_thetas(prior_draws(spec, 5, seed=1))
    ci = [cs.kind for cs in spec.comp_specs].index("pointsource")
    _, (base, size, _a, _b, own) = spec.comp_specs[ci].params["xy"]
    got = post._get(ci, "xy", th)
    assert torch.equal(got, th[:, base:base + size] + th[:, own:own + size])


def _cycle(C, D):
    a = C.PointSource(xy=None, mag=D.Uniform(loc=21.0, scale=1.0))
    b = C.PointSource(xy=C.Tied(a, "xy"), mag=D.Uniform(loc=21.0, scale=1.0))
    a.xy = C.Tied(b, "xy")
    return [a, b]


def _onto_offset_tied(C, D):
    host = _host(C, D)
    off = C.PointSource(xy=C.Tied(host, "xy", offset=D.Normal(loc=np.zeros(2), scale=0.3)),
                        mag=D.Uniform(loc=21.0, scale=1.0))
    return [host, off, _ps(C, D, C.Tied(off, "xy"))]


def _offset_cycle(C, D):
    """An offset tie whose chain comes back to its own (offset) slot."""
    a = C.PointSource(xy=None, mag=D.Uniform(loc=21.0, scale=1.0))
    b = _ps(C, D, C.Tied(a, "xy"))
    a.xy = C.Tied(b, "xy", offset=D.Normal(loc=np.zeros(2), scale=0.3))
    return [a, b]


def _missing_target(C, D):
    """A tie onto an attribute the target never set: a disk's ``c0`` onto
    an elliptical Sersic's."""
    host = _host(C, D)
    disk = C.ExpDisk(xy=C.Tied(host, "xy"), mag=D.Uniform(loc=21.0, scale=1.0),
                     reff=3.0, reff_b=2.0, angle=0.0, c0=C.Tied(host, "c0"))
    return [host, disk]


@pytest.mark.parametrize("case,err,match", [
    (_cycle, ValueError, "cycle"),
    (_onto_offset_tied, ValueError, "offset-tied"),
    (_offset_cycle, ValueError, "cycle"),
    (_missing_target, ValueError, "has no value"),
], ids=["cycle", "onto-offset-tied", "offset-cycle", "missing-target"])
def test_tie_errors_raise_as_jax(case, err, match):
    for package in ("jax", "torch"):
        C, D, build = PACKAGES[package]
        with pytest.raises(err, match=match):
            build([_config(C)] + case(C, D))


# a TAN WCS of the 24x24 observation: 0.05"/px, rotated by 30 degrees
_C30, _S30 = np.cos(np.pi / 6) * 0.05 / 3600, np.sin(np.pi / 6) * 0.05 / 3600
_WCS = {"CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRPIX1": 12.5, "CRPIX2": 12.5,
        "CRVAL1": 150.0, "CRVAL2": 2.0, "CD1_1": -_C30, "CD1_2": _S30,
        "CD2_1": _S30, "CD2_2": _C30}


def _sky_comps(C, D, where):
    host = _host(C, D)
    if where == "direct":
        return [host, _ps(C, D, C.Tied(host, "xy", frame="sky"))]
    if where == "end-of-chain":
        mid = _ps(C, D, C.Tied(host, "xy", frame="sky"))
        return [host, mid, _ps(C, D, C.Tied(mid, "xy"))]
    return [host, _ps(C, D, C.Tied(host, "xy", frame="sky",
                                   offset=D.Normal(loc=np.zeros(2), scale=0.3)))]


@pytest.mark.parametrize("where", ["direct", "end-of-chain", "offset"])
def test_sky_frame_tie_matches_jax(where):
    """A single-band ``frame="sky"`` tie is held to the JAX package: with
    no WCS on the observation both raise the JAX package's ``ValueError``;
    with a WCS both build the same spec (the tie maps through the band's
    own WCS: ``theta_affine``, or ``theta_affine_offset`` with an offset,
    A and b within 1e-12) and the same lnpost (rtol 1e-10)."""
    errors = []
    for package in ("jax", "torch"):
        C, D, build = PACKAGES[package]
        with pytest.raises(ValueError, match="requires WCS headers") as err:
            build([_config(C)] + _sky_comps(C, D, where))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    specs = {}
    for package in ("jax", "torch"):
        C, D, build = PACKAGES[package]
        cfg = _config(C)
        wcs_cfg = C.Configuration(obs_file=(_WCS, cfg.obs_data),
                                  obsivm_file=1.0 / cfg.obs_var,
                                  psf_files=cfg.psf_selector.spatial_psfs[0],
                                  psfivm_files=np.full((24, 24), 1e8),
                                  mag_zeropoint=25.0)
        specs[package] = build([wcs_cfg] + _sky_comps(C, D, where))
    own, jspec = specs["torch"], specs["jax"]
    assert own.param_names == list(jspec.param_names)
    for a, b in zip(own.comp_specs, jspec.comp_specs):
        assert a.kind == b.kind and sorted(a.params) == sorted(b.params)
        for k, (rule, payload) in a.params.items():
            jrule, jpayload = b.params[k]
            assert rule == jrule
            if rule.startswith("theta_affine"):
                assert payload[:2] == tuple(jpayload[:2]) and payload[4:] == tuple(jpayload[4:])
                for x, y in zip(payload[2:4], jpayload[2:4]):
                    np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
            else:
                assert _plain(payload) == _plain(jpayload)
    last = [cs for cs in own.comp_specs if cs.kind == "pointsource"][-1]
    assert last.params["xy"][0] == {"direct": "theta_affine",
                                    "end-of-chain": "theta_affine",
                                    "offset": "theta_affine_offset"}[where]
    th = prior_draws(own, 6, seed=2)
    want = np.asarray(jax.vmap(jax_posterior(jspec, dtype=jnp.float64).log_posterior)(
        jnp.asarray(th)))
    got = build_posterior(own, device="cpu", dtype=torch.float64).log_posterior_batch(th)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("args,err,match", [
    (lambda C, D, h: (h, "mag"), None, None),
    (lambda C, D, h: (h, "mag", "pixel", D.Normal(loc=0.0, scale=0.1)), ValueError,
     "only to 'xy'"),
    (lambda C, D, h: (h, "xy", "pixel", 0.5), TypeError, "prior distribution"),
    (lambda C, D, h: (h, "mag", "sky"), ValueError, "only to 'xy'"),
    (lambda C, D, h: (h, "xy", "world"), ValueError, "expected 'pixel' or 'sky'"),
    (lambda C, D, h: ("not a component", "xy"), TypeError, "model component"),
    (lambda C, D, h: (h, 3), TypeError, "must be a string"),
], ids=["ok", "offset-not-xy", "offset-not-a-prior", "sky-not-xy", "bad-frame",
        "not-a-component", "attr-not-a-string"])
def test_tied_constructor_checks_match_jax(args, err, match):
    for package in ("jax", "torch"):
        C, D, _ = PACKAGES[package]
        a = args(C, D, _host(C, D))
        if err is None:
            assert C.Tied(*a).attr == "mag"
        else:
            with pytest.raises(err, match=match):
                C.Tied(*a)


def test_host_side_reads_follow_the_tie():
    host = _host(TC, TD)
    ps = _ps(TC, TD, TC.Tied(host, "xy"))
    chained = _ps(TC, TD, TC.Tied(ps, "xy"))
    np.testing.assert_array_equal(chained.xy, host.xy)
    host.xy = np.array([3.0, 4.0])
    np.testing.assert_array_equal(ps.xy, [3.0, 4.0])
    a, b = _cycle(TC, TD)
    with pytest.raises(ValueError, match="cycle"):
        _ = a.xy


MODEL = """
from numpy import array
from psfMC.ModelComponents import ExpDisk, Tied
Configuration(obs_file=obs, obsivm_file=ivm, psf_files=psf, psfivm_files=pivm,
              mag_zeropoint=25.0)
Sky(adu=Normal(loc=0.05, scale=0.05))
host = Sersic(xy=Uniform(loc=array([8., 8.]), scale=array([8., 8.])),
              mag=Uniform(loc=20.7, scale=2.0), reff=Uniform(loc=1.0, scale=4.0),
              reff_b=Uniform(loc=1.0, scale=4.0), index=1.0, angle=0.0)
host
ExpDisk(xy=Tied(host, 'xy', offset=Normal(loc=array([0., 0.]), scale=0.2)),
        mag=Tied(host, 'mag'), reff=Uniform(loc=2.0, scale=4.0), reff_b=2.0, angle=0.0)
PointSource(xy=Tied(host, 'xy'), mag=Uniform(loc=20.2, scale=1.5))
"""


def test_model_file_with_ties_parses_to_the_jax_spec():
    """``Tied`` and ``ExpDisk`` come from ``psfMC.ModelComponents`` (and
    from the namespace a model file starts with) in both parsers."""
    cfg = _config(TC)
    prelude = {"obs": cfg.obs_data, "ivm": 1.0 / cfg.obs_var,
               "psf": _config(TC).psf_selector.spatial_psfs[0],
               "pivm": np.full((24, 24), 1e8)}
    src = "".join(f"{k} = array({np.asarray(v).tolist()!r})\n" for k, v in prelude.items())
    src = "from numpy import array\n" + src + MODEL
    own = build_model_spec(component_list_from_string(src))
    jspec = jax_spec(jparse_string(src))
    assert own.param_names == list(jspec.param_names)
    assert [type(c).__name__ for c in component_list_from_string(src)] == [
        "Configuration", "Sky", "Sersic", "ExpDisk", "PointSource"]
    sersic, disk = own.comp_specs[1:3]
    assert disk.params["xy"][0] == "theta_affine_offset"
    assert disk.params["mag"] == sersic.params["mag"]
