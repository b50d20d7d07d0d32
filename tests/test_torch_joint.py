"""Joint multi-band models and sky-frame ties in the port against the JAX package, on the CPU.

Each case is built by both packages' component classes from the same
seeded numpy arrays at small sizes (bands of 24x24 and 18x18, as in
``tests/test_joint.py``); the JAX side runs ``psfmc_tpu.models.joint``
on the CPU and the port ``device="cpu"``.  The specs (slots, names, tie
maps) must be equal, the sky affines within 1e-12, lnpost within rtol
1e-10 in float64 and 1e-4 in float32 with the same non-finite entries,
the carry images within 1e-10 and the mocks within 1e-6.  Every sky-tie
error raises the JAX package's ``ValueError`` with its message.  A
two-``Configuration`` model file runs through ``as_model`` and the
driver, and a mixed-shape checkpoint written by either package is read
by the other.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psfmc_tpu import database as jdb
from psfmc_tpu import distributions as JD
from psfmc_tpu.fitting import _data_fingerprint as jax_fingerprint
from psfmc_tpu.models import components as JC
from psfmc_tpu.models.joint import JointModel as JaxJoint
from psfmc_tpu.models.multicomponent import as_model as jax_as_model
from psfmc_tpu.models.spec import build_param_slots as jax_slots
from psfmc_tpu.models.spec import comp_spec_for as jax_comp_spec
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch import distributions as TD
from psfmc_tpu_torch import model_galaxy_mcmc
from psfmc_tpu_torch.flagship import JOINT_VARIANTS, joint_components, prior_draws
from psfmc_tpu_torch.flagship import write_joint_files
from psfmc_tpu_torch.io import fits as tfits
from psfmc_tpu_torch.models import JointModel, MultiComponentModel, as_model
from psfmc_tpu_torch.models import components as TC
from psfmc_tpu_torch.models.spec import build_param_slots, comp_spec_for


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread a test (the suite's workers share the host's cores;
    more threads a worker oversubscribe them), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES, PSF_SHAPE = ((24, 24), (18, 18)), (12, 12)
PACKAGES = {"torch": (TC, TD), "jax": (JC, JD)}


def _flagship(package, variant="flagship", dtype=None):
    C, D = PACKAGES[package]
    bands = joint_components(SHAPES, PSF_SHAPE, variant, components=C, distributions=D)
    if package == "torch":
        return JointModel(bands, device="cpu", dtype=dtype or torch.float64)
    return JaxJoint(bands, dtype=dtype or jnp.float64)


def _thetas(model, n=8, seed=2):
    """Prior draws with one walker outside the axis order (-inf) and one
    NaN (-inf)."""
    th = prior_draws(model.spec, n, seed=seed)
    names = model.param_names
    off = dict(zip(names, np.cumsum([0] + model.param_lens)))
    th[1, off["2_Sersic_reff"]], th[1, off["2_Sersic_reff_b"]] = 2.5, 5.0
    th[2, 0] = np.nan
    return th


def _jax_lnpost(jmodel, th):
    return np.asarray(jax.vmap(jmodel.posterior_fns.log_posterior)(
        jnp.asarray(th, jmodel.posterior_fns.dtype)), np.float64)


def _plain(payload):
    if isinstance(payload, tuple):
        return tuple(_plain(p) for p in payload)
    return np.asarray(payload, float).tolist()


def _assert_rules_equal(own, jax_specs, affine_tol=1e-12):
    """The same kinds and rules; the affine maps within ``affine_tol``."""
    for a, b in zip(own, jax_specs):
        assert a.kind == b.kind and sorted(a.params) == sorted(b.params)
        for k, (rule, payload) in a.params.items():
            jrule, jpayload = b.params[k]
            assert rule == jrule, (a.kind, k)
            if rule.startswith("theta_affine"):
                assert payload[:2] == tuple(jpayload[:2])
                assert payload[4:] == tuple(jpayload[4:])
                np.testing.assert_allclose(payload[2], jpayload[2], rtol=0,
                                           atol=affine_tol)
                np.testing.assert_allclose(payload[3], jpayload[3], rtol=0,
                                           atol=affine_tol)
            else:
                assert _plain(payload) == _plain(jpayload), (a.kind, k)


# -- one band ---------------------------------------------------------------
def _one_band(C, D):
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:24, 0:24].astype(float)
    psf = np.exp(-((xx - 12) ** 2 + (yy - 12) ** 2) / (2 * 1.2**2))
    config = C.Configuration(obs_file=0.05 + rng.randn(24, 24) * 0.05,
                             obsivm_file=np.full((24, 24), 400.0),
                             psf_files=psf / psf.sum(),
                             psfivm_files=np.full((24, 24), 1e8), mag_zeropoint=25.0)
    host = C.Sersic(xy=D.Uniform(loc=np.array([8.0, 8.0]), scale=np.array([8.0, 8.0])),
                    mag=D.Uniform(loc=19.5, scale=2.0), reff=D.Uniform(loc=1.0, scale=4.0),
                    reff_b=D.Uniform(loc=1.0, scale=4.0), index=1.0, angle=0.0)
    return [config, C.Sky(adu=D.Normal(loc=0.05, scale=0.05)), host]


def test_single_band_joint_matches_plain_posterior():
    """A one-band JointModel is the plain posterior, bit for bit, and the
    JAX package's joint posterior within 1e-10."""
    comps = _one_band(TC, TD)
    joint = JointModel([comps], device="cpu", dtype=torch.float64)
    plain = MultiComponentModel(comps, device="cpu", dtype=torch.float64)
    assert joint.param_names == plain.param_names
    assert joint.param_lens == plain.param_lens
    th = plain.init_params_from_priors(6, random_state=np.random.RandomState(1))
    got = joint.posterior_fns.log_posterior_batch(th)
    assert torch.equal(got, plain.posterior_fns.log_posterior_batch(th))
    want = _jax_lnpost(JaxJoint([_one_band(JC, JD)], dtype=jnp.float64), th)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


# -- the joint flagship -----------------------------------------------------
@pytest.mark.parametrize("variant", JOINT_VARIANTS)
def test_joint_spec_equals_jax(variant):
    own, jm = _flagship("torch", variant), _flagship("jax", variant)
    assert own.param_names == list(jm.param_names)
    assert own.param_fits_abbrs == list(jm.param_fits_abbrs)
    assert [(s.offset, s.size) for s in own.spec.slots] == [
        (s.offset, s.size) for s in jm.spec.slots]
    assert own.num_params == jm.num_params == (26 if variant == "offset" else
                                               24 + 3 * (variant in ("general", "tiled")))
    for bs, jbs in zip(own.spec.band_specs, jm.spec.band_specs):
        assert bs.slots == [] and bs.num_params == own.num_params
        assert bs.shape == jbs.shape and bs.num_psfs == jbs.num_psfs
        _assert_rules_equal(bs.comp_specs, jbs.comp_specs)
    _assert_rules_equal(own.spec.comp_specs, jm.spec.comp_specs)
    kinds = {cs.kind: cs.params["xy"][0] for cs in own.spec.band_specs[1].comp_specs
             if "xy" in cs.params}
    assert kinds["pointsource"] == ("theta_affine_offset" if variant == "offset"
                                    else "theta_affine")
    assert kinds["sersic"] == "theta_affine"


@pytest.mark.parametrize("variant", JOINT_VARIANTS)
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_joint_lnpost_matches_jax(variant, precision, monkeypatch):
    """lnpost = the joint prior + each band's lnL, against the JAX joint
    posterior: rtol 1e-10 in float64, 1e-4 in float32, the same
    non-finite entries."""
    if variant == "tiled":
        monkeypatch.setenv("PSFMC_RENDER", "pallas_tiled")
    tdt, jdt, rtol = {"f64": (torch.float64, jnp.float64, 1e-10),
                      "f32": (torch.float32, jnp.float32, 1e-4)}[precision]
    own, jm = _flagship("torch", variant, tdt), _flagship("jax", variant, jdt)
    th = _thetas(own)
    fns = own.posterior_fns
    got = fns.log_posterior_batch(th)
    parts = fns.log_prior_batch(th) + sum(f.log_likelihood_batch(th) for f in fns.band_fns)
    fin = torch.isfinite(got)
    assert torch.equal(got[fin], parts[fin])
    want = _jax_lnpost(jm, th)
    got = got.double().numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).sum() >= 4 and not np.isfinite(want[[1, 2]]).any()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol)
    np.testing.assert_allclose(fns.log_prior_batch(th).double().numpy()[ok],
                               np.asarray(jax.vmap(jm.posterior_fns.log_prior)(
                                   jnp.asarray(th, jdt)))[ok], rtol=rtol)


@pytest.mark.parametrize("variant", ["flagship", "general"])
def test_joint_carry_images_match_jax(variant):
    """Every band's carry images per walker and its walker-mean carry
    images (``b{i}_*``) within 1e-10 of the JAX package's."""
    own, jm = _flagship("torch", variant), _flagship("jax", variant)
    th = prior_draws(own.spec, 5, seed=4)
    fns = own.posterior_fns
    want = jax.vmap(jm.posterior_fns.carry_images)(jnp.asarray(th))
    got = fns.images_batch(th)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(want[k])).max(),
                                   err_msg=k)
    means = fns.ensemble_carry_means(th)
    want = jm.posterior_fns.ensemble_carry_means(jnp.asarray(th))
    assert sorted(means) == sorted(want) == sorted(fns.carry_image_shapes())
    for k, v in means.items():
        assert tuple(v.shape) == fns.carry_image_shapes()[k]
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(want[k])).max(),
                                   err_msg=k)
    lnp, imgs = fns.lnpost_images_batch(th)
    torch.testing.assert_close(lnp, fns.log_posterior_batch(th), rtol=1e-10, atol=0)
    assert sorted(imgs) == sorted(got)


def test_psf_index_names_per_band():
    """Two bands sampling their PSF index: ``B{i}_PSF_Index`` columns (and
    ``B{i}PSFIX`` abbreviations), as the JAX package names them."""
    own, jm = _flagship("torch", "general"), _flagship("jax", "general")
    assert "B0_PSF_Index" in own.param_names and "B1_PSF_Index" in own.param_names
    assert "PSF_Index" not in own.param_names
    assert own.param_names == list(jm.param_names)
    assert {"B0PSFIX", "B1PSFIX"} <= set(own.param_fits_abbrs)


def test_duplicate_names_raise_as_jax():
    def bands(C, D):  # one prior object in two bands' skies: one name twice
        b0, b1 = joint_components(SHAPES, PSF_SHAPE, components=C, distributions=D)
        b1[1] = C.Sky(adu=b0[1]._priors["adu"])
        return [b0, b1]

    with pytest.raises(ValueError, match="duplicate parameter names") as jerr:
        JaxJoint(bands(JC, JD))
    with pytest.raises(ValueError, match="duplicate parameter names") as terr:
        JointModel(bands(TC, TD), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("variant", ["flagship", "general"])
def test_each_band_takes_its_path(variant, monkeypatch):
    """A band the conv+likelihood kernel covers takes "batched", another
    "general", whatever PSFMC_LNPOST says; an explicit lnpost ("fused"
    included) raises."""
    want = {"flagship": ("batched", "batched"), "general": ("general", "general")}
    for env in ("", "pallas", "pallas_batched", "xla"):
        monkeypatch.setenv("PSFMC_LNPOST", env)
        assert _flagship("torch", variant, torch.float32).posterior_fns.lnpost == \
            want[variant]
    bands = joint_components(SHAPES, PSF_SHAPE, variant)
    for mode in ("fused", "batched", "general"):
        with pytest.raises(ValueError, match=f"lnpost='{mode}' does not apply to "
                                             "a joint model"):
            JointModel(bands, device="cpu", lnpost=mode)


def test_simulate_matches_jax():
    """One mock per band at one shared vector: the same draws and mocks
    (rtol 1e-6) as the JAX package's for one seed; noiseless, each band's
    convolved model."""
    own, jm = _flagship("torch"), _flagship("jax")
    mocks, theta = own.simulate(random_state=18)
    jmocks, jtheta = jm.simulate(random_state=18)
    np.testing.assert_array_equal(theta, jtheta)
    assert [m.shape for m in mocks] == list(SHAPES)
    for a, b in zip(mocks, jmocks):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    clean, _ = own.simulate(theta=theta, add_noise=False)
    conv = own.posterior_fns.images_batch(theta[None])
    for i, img in enumerate(clean):
        np.testing.assert_array_equal(img, conv[f"b{i}_conv"][0].numpy())


# -- sky-frame ties ---------------------------------------------------------
S = 0.05 / 3600.0
HEADERS = (  # (CRPIX, CRVAL, CD) of three bands: rotated, coarser, far away
    ((12.5, 12.5), (150.0, 2.0), [[-S, 0.0], [0.0, S]]),
    ((9.5, 9.5), (150.0 + 2e-4, 2.0 - 1e-4), [[0.0, -1.5 * S], [1.5 * S, 0.0]]),
    ((5.0, 5.0), (151.0, 2.5), [[-4 * S, 0.0], [0.0, 4 * S]]),
)


def _header(i):
    (c1, c2), (v1, v2), cd = HEADERS[i]
    return {"CRPIX1": c1, "CRPIX2": c2, "CRVAL1": v1, "CRVAL2": v2,
            "CD1_1": cd[0][0], "CD1_2": cd[0][1], "CD2_1": cd[1][0], "CD2_2": cd[1][1]}


def _band_config(C, i, hw, wcs=True):
    rng = np.random.RandomState(40 + i)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(float)
    psf = np.exp(-((xx - hw // 2) ** 2 + (yy - hw // 2) ** 2) / 2.0)
    obs = rng.randn(hw, hw) * 0.1
    return C.Configuration(obs_file=(_header(i), obs) if wcs else obs,
                           obsivm_file=np.full((hw, hw), 100.0),
                           psf_files=psf / psf.sum(),
                           psfivm_files=np.full((hw, hw), 1e8), mag_zeropoint=25.0)


def _ps(C, D, xy):
    return C.PointSource(xy=xy, mag=D.Uniform(loc=21.0, scale=1.0))


def _free_xy(D):
    return D.Uniform(loc=np.array([6.0, 6.0]), scale=np.array([4.0, 4.0]))


def _sky_case(C, D, where, wcs=True):
    """Bands of a sky tie: ``direct`` (band 1 -> band 0), ``end-of-chain``
    (band 1 --sky--> band 0 --pixel--> band 2's slot: band 0's WCS reads
    the slot) and ``offset`` (a sky tie with a registration offset)."""
    if where == "end-of-chain":
        ps_c = _ps(C, D, _free_xy(D))
        ps_a = _ps(C, D, C.Tied(ps_c, "xy"))
        ps_b = _ps(C, D, C.Tied(ps_a, "xy", frame="sky"))
        return [[_band_config(C, 0, 24, wcs), ps_a], [_band_config(C, 1, 20, wcs), ps_b],
                [_band_config(C, 2, 16, wcs), ps_c]]
    ps_a = _ps(C, D, _free_xy(D))
    off = ({"offset": D.Normal(loc=np.array([0.0, 0.0]), scale=0.2)}
           if where == "offset" else {})
    ps_b = _ps(C, D, C.Tied(ps_a, "xy", frame="sky", **off))
    return [[_band_config(C, 0, 24, wcs), C.Sky(adu=D.Normal(loc=0.0, scale=0.02)), ps_a],
            [_band_config(C, 1, 18, wcs), C.Sky(adu=D.Normal(loc=0.0, scale=0.02)), ps_b]]


@pytest.mark.parametrize("where", ["direct", "end-of-chain", "offset"])
def test_sky_tie_affine_equals_jax(where):
    """The sky tie's rule and its affine (A, b) within 1e-12 of the JAX
    package's, and A p + b the composed WCS mapping of band 0's pixel into
    band 1's (to TAN curvature, 1e-6 px); lnpost within rtol 1e-10."""
    from psfmc_tpu_torch.io.wcs import MiniWCS

    own = JointModel(_sky_case(TC, TD, where), device="cpu", dtype=torch.float64)
    jm = JaxJoint(_sky_case(JC, JD, where), dtype=jnp.float64)
    assert own.param_names == list(jm.param_names)
    for bs, jbs in zip(own.spec.band_specs, jm.spec.band_specs):
        _assert_rules_equal(bs.comp_specs, jbs.comp_specs)
    rule, payload = next(cs for cs in own.spec.band_specs[1].comp_specs
                         if cs.kind == "pointsource").params["xy"]
    assert rule == ("theta_affine_offset" if where == "offset" else "theta_affine")
    a, b = payload[2], payload[3]
    wa, wb = MiniWCS(_header(0)), MiniWCS(_header(1))
    for p in ([7.3, 8.1], [14.2, 11.7]):
        ra, dec = wa.pixel_to_sky(p[0] + 1, p[1] + 1)
        qx, qy = wb.sky_to_pixel(ra, dec)
        np.testing.assert_allclose(a @ np.asarray(p) + b, [qx - 1, qy - 1], atol=1e-6)
    th = own.init_params_from_priors(6, random_state=np.random.RandomState(5))
    np.testing.assert_allclose(own.posterior_fns.log_posterior_batch(th).numpy(),
                               _jax_lnpost(jm, th), rtol=1e-10)


def _scalar_xy(C, D):
    ps_a = C.PointSource(xy=D.Uniform(loc=5.0, scale=4.0), mag=D.Uniform(loc=21.0, scale=1.0))
    return [[_band_config(C, 0, 24), ps_a],
            [_band_config(C, 1, 18), _ps(C, D, C.Tied(ps_a, "xy", frame="sky"))]]


def _no_wcs(C, D):
    return _sky_case(C, D, "direct", wcs=False)


def _ambiguous(C, D):
    ps_a = _ps(C, D, _free_xy(D))
    return [[_band_config(C, 0, 24), ps_a],
            [_band_config(C, 1, 18), ps_a, _ps(C, D, C.Tied(ps_a, "xy", frame="sky"))]]


def _constant(C, D):
    ps_a = _ps(C, D, np.array([7.0, 8.0]))
    return [[_band_config(C, 0, 24), ps_a],
            [_band_config(C, 1, 18), _ps(C, D, C.Tied(ps_a, "xy", frame="sky"))]]


def _cycle(C, D):
    a = _ps(C, D, None)
    b = _ps(C, D, C.Tied(a, "xy"))
    a.xy = C.Tied(b, "xy", frame="sky")
    return [[_band_config(C, 0, 24), a], [_band_config(C, 1, 18), b]]


@pytest.mark.parametrize("case", [_scalar_xy, _no_wcs, _ambiguous, _constant, _cycle],
                         ids=["not-a-2-vector", "no-wcs-headers", "ambiguous",
                              "constant", "cycle"])
def test_sky_tie_errors_raise_as_jax(case):
    """Each sky-tie error of the JAX package, its type and its message."""
    with pytest.raises(ValueError) as jerr:
        JaxJoint(case(JC, JD))
    with pytest.raises(ValueError) as terr:
        JointModel(case(TC, TD), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_sky_tie_without_a_wcs_context_raises_as_jax():
    """A rule resolved with no WCS map at all (``comp_spec_for`` called
    alone) raises the JAX package's error."""
    errors = []
    for slots_fn, spec_fn, (C, D) in ((jax_slots, jax_comp_spec, PACKAGES["jax"]),
                                      (build_param_slots, comp_spec_for,
                                       PACKAGES["torch"])):
        ps_a = _ps(C, D, _free_xy(D))
        ps_b = _ps(C, D, C.Tied(ps_a, "xy", frame="sky"))
        _, slot_map, _ = slots_fn([ps_a, ps_b])
        with pytest.raises(ValueError, match="without WCS frames") as err:
            spec_fn(ps_b, slot_map)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# -- model files, the driver and the database ------------------------------
def test_multi_band_list_must_start_with_a_configuration():
    bands = joint_components(SHAPES, PSF_SHAPE)
    comps = [bands[0][1]] + bands[0][:1] + bands[0][2:] + bands[1]
    jcomps = joint_components(SHAPES, PSF_SHAPE, components=JC, distributions=JD)
    jcomps = [jcomps[0][1]] + jcomps[0][:1] + jcomps[0][2:] + jcomps[1]
    with pytest.raises(ValueError, match="must start with its first band") as jerr:
        jax_as_model(jcomps)
    with pytest.raises(ValueError, match="must start with its first band") as terr:
        as_model(comps, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_model_file_with_two_configurations_through_the_driver(tmp_path):
    """A model file with two Configurations and sky ties: ``as_model``
    builds a JointModel whose layout is the JAX package's; the driver
    writes a database the JAX package reads with the same columns, a data
    fingerprint of both bands, the per-band products and a mixed-shape
    checkpoint; a second call skips sampling and writes the products from
    the checkpoint's accumulators."""
    path = write_joint_files(str(tmp_path), SHAPES, PSF_SHAPE)
    own = as_model(path, device="cpu")
    jm = jax_as_model(path)
    assert isinstance(own, JointModel) and own.param_names == list(jm.param_names)
    assert [bs.shape for bs in own.spec.band_specs] == list(SHAPES)
    for bs, jbs in zip(own.spec.band_specs, jm.spec.band_specs):
        _assert_rules_equal(bs.comp_specs, jbs.comp_specs)
    with pytest.warns(UserWarning, match="only the first"):
        MultiComponentModel(path, device="cpu")

    out = str(tmp_path / "out")
    nw = 2 * own.num_params + 2
    kw = dict(output_name=out, chains=nw, burn=4, iterations=4, seed=3,
              checkpoint_interval=2, device="cpu")
    db = model_galaxy_mcmc(path, **kw)
    jtable = jdb.load_database(out + "_db.fits")
    assert jtable.colnames == list(jm.param_names) + ["lnprobability", "walker", "sample"]
    assert len(jtable) == nw * 4 and np.all(np.isfinite(db["lnprobability"]))
    assert int(jtable.meta["MCDATSUM"]) == jax_fingerprint(jm)
    products = {}
    for b, shape in enumerate(SHAPES):
        for ftype in ("raw_model", "convolved_model", "composite_ivm", "residual",
                      "point_source_subtracted"):
            name = f"{out}_b{b}_{ftype}.fits"
            products[name] = tfits.getdata(name)
            assert products[name].shape == shape and np.all(np.isfinite(products[name]))
        hdr = tfits.getheader(f"{out}_b{b}_raw_model.fits")
        assert hdr["MCBAND"] == b and hdr["MCACCUM"] == nw * 4
    ckpt = jdb.load_checkpoint(out + "_db.fits")
    own_ckpt = tdb.load_checkpoint(out + "_db.fits")
    assert sorted(ckpt["accum"]) == sorted(own.posterior_fns.carry_image_shapes())
    for k, v in ckpt["accum"].items():
        assert v.shape == own.posterior_fns.carry_image_shapes()[k]
        np.testing.assert_array_equal(v, own_ckpt["accum"][k])

    for name in products:
        os.remove(name)
    again = model_galaxy_mcmc(path, **kw)
    assert len(again) == nw * 4
    for name, data in products.items():
        np.testing.assert_array_equal(tfits.getdata(name), data)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_mixed_shape_checkpoint_is_read_across_packages(tmp_path, writer):
    """Accumulators of two shapes (a joint model's bands) ride the
    one-row layout with ``CKIMSH{i}`` cards; either package reads what
    the other wrote, shapes and values exact."""
    rng = np.random.RandomState(6)
    nw, niter = 6, 3
    chain, lnp = rng.randn(nw, niter, 4), -1e3 + rng.randn(nw, niter)
    accum = {"b0_raw": rng.randn(4, 5), "b0_raw_m2": rng.rand(4, 5),
             "b1_raw": rng.randn(3, 2), "b1_raw_m2": rng.rand(3, 2)}
    payload = {"version": 2, "ntemps": 1, "positions": chain[:, -1],
               "log_prob": lnp[:, -1], "naccept": np.arange(nw), "nsteps": niter,
               "accum": accum, "accum_count": nw * niter}
    if writer == "jax":
        payload["key"] = np.array([0, 42], np.uint32)
    else:
        payload["rng_kind"] = "torch-cpu"
        payload["rng_state"] = torch.Generator().manual_seed(3).get_state().numpy()
    sampler = type("S", (), dict(chain=chain, lnprobability=lnp, nwalkers=nw,
                                 state=object(), checkpoint_kind="ensemble",
                                 checkpoint_payload=lambda self: dict(payload)))()
    model = type("M", (), dict(param_names=["a", "b"], param_lens=[1, 3]))()
    path = str(tmp_path / "db.fits")
    {"torch": tdb.save_database, "jax": jdb.save_database}[writer](
        sampler, model, path, meta_dict={"MCITER": niter, "MCCHAINS": nw})
    for load in (tdb.load_checkpoint, jdb.load_checkpoint):
        ckpt = load(path)
        assert ckpt["accum_count"] == nw * niter and sorted(ckpt["accum"]) == sorted(accum)
        for k, v in accum.items():
            np.testing.assert_array_equal(ckpt["accum"][k], v)
        np.testing.assert_array_equal(ckpt["positions"], chain[:, -1])


def test_chip_smoke_joint_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.joint_phase`` (the joint fit by ``model_galaxy_mcmc``,
    the second call from the checkpoint, graphed against eager, the steady
    steps and the three variants, the offset variant's band 1 at 28x28 = 7
    x 2^2) at
    32x32 + 24x24 with 60 walkers on the CPU, where the kernel wrappers run
    their plain versions: each wrapper is counted as the card counts its
    kernel, by route and by shape, so the phase's exact launch checks hold
    here."""
    import functools

    import chip_smoke as cs
    import psfmc_tpu_torch.models as M
    import psfmc_tpu_torch.models.joint as J
    import psfmc_tpu_torch.models.posterior as P
    import psfmc_tpu_torch.sampler as S
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels import fused_lnl as FL
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    def counting(mod, name):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            wrapped.launches += 1
            if hasattr(wrapped, "route_launches"):  # consts is the last argument
                shape = a[-1].shape
                route = FL.fused_route if name == "fused_lnl" else CL.conv_route
                wrapped.route_launches[route(shape)] += 1
                if name == "batched_conv_lnl":
                    key = (route(shape), shape)
                    wrapped.shape_launches[key] = wrapped.shape_launches.get(
                        key, 0) + 1
            return orig(*a, **k)

        wrapped.launches = 0
        if name in ("batched_conv_lnl", "fused_lnl"):
            wrapped.route_launches = {"fft": 0, "dft": 0}
        if name == "batched_conv_lnl":
            wrapped.shape_launches = {}
        monkeypatch.setattr(mod, name, wrapped)
        monkeypatch.setattr(P, name, wrapped)

    for mod, name in ((CL, "batched_conv_lnl"), (FL, "fused_lnl"),
                      (SR, "render_sersics"), (SR, "render_sersics_tiled")):
        counting(mod, name)
    joint_init = J.JointModel.__init__
    monkeypatch.setattr(J.JointModel, "__init__", lambda self, bands, device=None, **k:
                        joint_init(self, bands, device=device or "cpu", **k))
    monkeypatch.setattr(S, "EnsembleSampler",
                        functools.partial(S.EnsembleSampler, device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "time_ms", lambda fn, **k: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "NWALKERS", 60)
    monkeypatch.setattr(cs, "B_HALF", 30)
    assert M.JointModel is J.JointModel
    sampling, variants, on_path, joint = cs.joint_phase(
        shapes=((32, 32), (24, 24)), psf_shape=(16, 16), device="cpu",
        radix7_band=(28, 28))
    assert sampling["render_sersics"] == 2 * (1 + 2 * 40 + 20)
    # both bands on the FFT route, band 1 (24 = 3 x 2^3) on its mixed-radix
    # geometry; the offset variant's band 1 (28 = 7 x 2^2) on the same
    # geometry's radix-7 stages
    assert sampling["batched_conv_lnl:fft"] == 2 * 81
    assert sampling["batched_conv_lnl:mixed"] == 81
    assert sampling["batched_conv_lnl:dft"] == 0
    assert variants["render_sersics_tiled"] == 22
    assert variants["batched_conv_lnl:fft:radix7"] == 9
    assert variants["batched_conv_lnl:fft"] == 18 and variants["batched_conv_lnl:dft"] == 0
    assert on_path["joint_ms"] == 1.0 and joint.fns.lnpost == ("batched", "batched")
