"""The port's GALFIT importer and exporter (``io/galfit.py``) against the
JAX package's, on the CPU.

Each case of ``tests/test_galfit_import.py`` that needs no reference data
runs here through both packages on the same feedme text: the parsed
tables equal; the parameter tables (values, free flags, prior bounds)
equal; the surface-brightness factors within rel 1e-12 of JAX's, and
the port's King, Ferrer and Nuker factors within rel 1e-8 of the port's
own renderer normalizations (``ops/profiles.py``); the component lists'
classes, constants, priors' parameters and ``Tied`` links equal; the
warnings equal; ``feedme_to_model_source`` equal but for the generator
line; ``results_to_feedme`` text equal but for the generator line, also
on a trace database the port wrote, read by each package; the fuzz
case's outcomes (components or ``ValueError`` text) equal.  The imported
King and edge-on disk render the feedme's central surface brightness on
the port's renderers, in float64.  Then a CPU rehearsal of
``chip_smoke.py``'s GALFIT phase at 32x32.  Each test runs torch on one
thread (the phase's subprocess too).
"""
import functools
import types
import warnings

import numpy as np
import pytest
import torch

from psfmc_tpu.io import galfit as jg
from psfmc_tpu.model_parser import component_list_from_string as jparse_string
from psfmc_tpu.models import components as JC
from psfmc_tpu_torch import database as tdb
from psfmc_tpu_torch.io import galfit as tg
from psfmc_tpu_torch.model_parser import component_list_from_string as tparse_string
from psfmc_tpu_torch.models import components as TC
from test_galfit_import import (
    CONSTRAINTS,
    FEEDME_CON,
    FEEDME_MULTI,
    FEEDME_SB,
    HEADER,
)

NUKER = HEADER + (
    " 0) nuker\n 1) 30.0 30.0 1 1\n 3) 18.0 1\n 4) 5.0 1\n"
    " 5) 1.5 1\n 6) 4.0 1\n 7) 0.5 1\n 9) 0.9 0\n10) 20.0 1\n"
)
HINTS = "J) 26.0\nK) 0.05 0.05\nE) 5\nI) 60 50\nH) 101 228 51 178\n 0) sky\n 1) 1.0 0\n"
FEEDMES = {"multi": FEEDME_MULTI, "sb": FEEDME_SB, "con": FEEDME_CON, "nuker": NUKER,
           "full": FEEDME_MULTI + FEEDME_SB.replace(HEADER, "") + NUKER.replace(HEADER, ""),
           "hints": HINTS}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PORT_LINE = {"# Generated from a GALFIT feedme by psfmc_tpu_torch.io.galfit":
             "# Generated from a GALFIT feedme by psfmc_tpu.io.galfit",
             "# Generated by psfmc_tpu_torch.io.galfit.results_to_feedme":
             "# Generated by psfmc_tpu.io.galfit.results_to_feedme"}


def _as_jax_text(text):
    """The port's generated text with its generator line named as the JAX
    package names it (the one line in which the two may differ)."""
    lines = text.split("\n")
    assert lines[0] in PORT_LINE, lines[0]
    return "\n".join([PORT_LINE[lines[0]]] + lines[1:])


def _both(fn_name, *args, **kwargs):
    """``fn_name`` of both modules on the same arguments: ``(port, jax)``,
    each ``(result or None, exception text or None, warning texts)``."""
    out = []
    for mod in (tg, jg):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                res, err = getattr(mod, fn_name)(*args, **kwargs), None
            except ValueError as e:
                res, err = None, str(e)
        out.append((res, err, [str(w.message) for w in caught]))
    return out


def _same_prior(tp, jp):
    assert type(tp).__name__ == type(jp).__name__
    for ta, ja in zip(tp.rv_frozen.args, jp.rv_frozen.args):
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))
    assert tp.rv_frozen.kwds.keys() == jp.rv_frozen.kwds.keys()
    for k in tp.rv_frozen.kwds:
        np.testing.assert_array_equal(np.asarray(tp.rv_frozen.kwds[k]),
                                      np.asarray(jp.rv_frozen.kwds[k]))


def _same_components(tcomps, jcomps):
    """Classes, constants, priors' parameters, ``Tied`` links (by owner
    position and attribute) and the angle convention equal."""
    assert [type(c).__name__ for c in tcomps] == [type(c).__name__ for c in jcomps]
    tpos = {id(c): i for i, c in enumerate(tcomps)}
    jpos = {id(c): i for i, c in enumerate(jcomps)}
    for tc, jc in zip(tcomps, jcomps):
        assert getattr(tc, "angle_degrees", None) == getattr(jc, "angle_degrees", None)
        assert tc._constants.keys() == jc._constants.keys()
        for attr, tv in tc._constants.items():
            jv = jc._constants[attr]
            if isinstance(tv, TC.Tied):
                assert isinstance(jv, JC.Tied)
                assert (tpos[id(tv.component)], tv.attr) == (jpos[id(jv.component)], jv.attr)
            else:
                np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
        assert tc._priors.keys() == jc._priors.keys()
        for attr in tc._priors:
            _same_prior(tc._priors[attr], jc._priors[attr])


def _same_tables(t, j):
    """``_build_tables`` / ``_apply_constraints`` outputs equal."""
    assert len(t) == len(j)
    for (tn, tcls, tp), (jn, jcls, jp) in zip(t, j):
        assert (tn, tcls) == (jn, jcls)
        assert tp.keys() == jp.keys()
        for attr in tp:
            a, b = tp[attr], jp[attr]
            if isinstance(a, tg._P):
                assert (a.value, a.free, a.lo, a.hi) == (b.value, b.free, b.lo, b.hi), attr
            elif isinstance(a[0], str):
                assert a == b
            else:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


# -- the parse and the tables ----------------------------------------------------
@pytest.mark.parametrize("name", sorted(FEEDMES))
def test_parse_and_tables_match_jax(name):
    text = FEEDMES[name]
    (tm, _, tw), (jm, _, jw) = _both("parse_feedme", text)
    assert tm.header == jm.header and tw == jw
    assert (tm.mag_zeropoint, tm.plate_scale) == (jm.mag_zeropoint, jm.plate_scale)
    assert [(o.kind, o.params) for o in tm.objects] == [(o.kind, o.params) for o in jm.objects]
    (t, _, tw), (j, _, jw) = _both("_build_tables", text)
    assert tw == jw
    _same_tables(t[1], j[1])


@pytest.mark.parametrize("name", ["multi", "sb", "con", "nuker", "full"])
@pytest.mark.parametrize("priors", ["uniform", "fixed"])
def test_components_match_jax(name, priors):
    (t, terr, tw), (j, jerr, jw) = _both("components_from_feedme", FEEDMES[name],
                                         priors=priors)
    assert terr is None and jerr is None and tw == jw
    _same_components(t, j)
    assert all(type(c).__module__ == "psfmc_tpu_torch.models.components" for c in t)


def test_import_all_types_as_jax_asserts():
    """The JAX test's own checks of the multi-type import, on the port."""
    sky, ps, disk, gauss, mof, dev, fer = tg.components_from_feedme(FEEDME_MULTI)
    assert isinstance(sky, TC.Sky) and sky.adu == 12.5 and not sky._has("dy")
    np.testing.assert_allclose(ps._priors["xy"].rv_frozen.mean(), [29.0, 39.0])
    assert isinstance(disk, TC.ExpDisk)
    assert disk.reff == pytest.approx(1.6783469900166605 * 4.0)
    assert disk.reff_b == pytest.approx(0.5 * disk.reff) and disk.angle == pytest.approx(100.0)
    assert isinstance(gauss, TC.Gaussian) and gauss.reff == pytest.approx(3.0)
    assert isinstance(mof._priors["fwhm_b"], type(mof._priors["fwhm"])) and mof.index == 2.5
    for attr in ("c0", "f1", "f1_phi", "b2", "rot_ang"):
        assert attr in dev._priors, attr
    assert (dev.rot_out, dev.rot_in, dev.rot_pow) == (12.0, 2.0, 0.5)
    assert isinstance(fer, TC.Ferrer) and fer.rout_b == pytest.approx(6.4)


# -- the surface-brightness factors ------------------------------------------------
KING = [(5.0, 4.0, 20.0, 2.0), (3.0, 3.0, 9.0, 2.0), (5.0, 5.0, 40.0, 1.2),
        (2.0, 2.0, 5.0, 3.5)]
NUKERS = [(3.0, 3.0, 1.5, 3.0, 0.5), (2.0, 2.0, 1.5, 3.0, 0.5), (2.0, 2.0, 0.8, 2.5, -0.3),
          (2.0, 2.0, 4.0, 5.0, 1.5)]
FERRERS = [(8.0, 6.4, 2.0, 1.0), (5.0, 5.0, 0.5, 0.0), (3.0, 2.0, 3.0, 1.5)]


@pytest.mark.parametrize("fn,args", [("_sb_factor_king", a) for a in KING]
                         + [("_sb_factor_nuker", a) for a in NUKERS]
                         + [("_sb_factor_ferrer", a) for a in FERRERS])
def test_sb_factors_match_jax(fn, args):
    got, want = getattr(tg, fn)(*args), getattr(jg, fn)(*args)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("fn,args", [("king", a) for a in KING] + [("nuker", a) for a in NUKERS]
                         + [("ferrer", a) for a in FERRERS])
def test_sb_factors_match_the_port_renderers(fn, args):
    """flux / (anchor counts a pixel) of the host quadrature twins equals the
    port's own renderer normalization (float64 torch), rel 1e-8."""
    from psfmc_tpu_torch.ops import profiles as P

    f64 = functools.partial(torch.tensor, dtype=torch.float64)
    if fn == "king":
        rc, rc_b, rt, alpha = args
        sq_xt = (rt / rc) ** 2
        qk = (1.0 + sq_xt) ** (-1.0 / alpha)
        dev = float(P.king_radial_factor(f64(sq_xt), f64(alpha)))
        want = np.pi * rc * rc_b * dev / (1.0 - qk) ** alpha
        got = tg._sb_factor_king(*args)
    elif fn == "nuker":
        rb, rb_b, a, b, g = args
        want = np.pi * rb * rb_b * float(P.nuker_radial_factor(f64(a), f64(b), f64(g)))
        got = tg._sb_factor_nuker(*args)
    else:
        ro, ro_b, a, b = args
        want = np.pi * ro * ro_b * float(P.ferrer_radial_factor(f64(a), f64(b)))
        got = tg._sb_factor_ferrer(*args)
    assert got == pytest.approx(want, rel=1e-8)


def test_sb_anchor_end_to_end_on_the_port_renderers():
    """Imported king / edgedisk render the feedme's central SB exactly
    (float64 torch renderers, the source on a pixel centre)."""
    from psfmc_tpu_torch.ops.coords import coord_grids
    from psfmc_tpu_torch.ops.profiles import render_edgedisk, render_king

    king, disk = tg.components_from_feedme(FEEDME_SB, priors="fixed")
    assert isinstance(king, TC.King) and isinstance(disk, TC.EdgeDisk)
    assert (disk.hs, disk.rs) == (2.0, 8.0)
    zp, px_area = 26.0, 0.05 * 0.05
    xg, yg = coord_grids((61, 61), torch.float64)
    t = functools.partial(torch.tensor, dtype=torch.float64)
    img = render_king(xg, yg, t([30.0, 30.0]), t(king.mag), t(king.rc), t(king.rc_b),
                      t(king.rt), t(king.alpha), t(king.angle), t(zp), angle_degrees=True)
    assert float(img[30, 30]) == pytest.approx(10.0 ** (-0.4 * (20.0 - zp)) * px_area,
                                               rel=1e-6)
    img = render_edgedisk(xg, yg, t([30.0, 30.0]), t(disk.mag), t(disk.rs), t(disk.hs),
                          t(disk.angle), t(zp), angle_degrees=True)
    assert float(img[30, 30]) == pytest.approx(10.0 ** (-0.4 * (21.0 - zp)) * px_area,
                                               rel=1e-5)


# -- errors and warnings ---------------------------------------------------------------
ERROR_CASES = {
    "sb_without_zeropoint": (FEEDME_SB.replace("J) 26.0               # zeropoint\n", ""), {}),
    "unknown_margin": (FEEDME_MULTI, {"margins": {"bogus": 1.0}}),
    "bad_priors": (FEEDME_MULTI, {"priors": "normal"}),
    "missing_mag": ("0) sersic\n 1) 10 10 1 1\n", {}),
    "divergent_nuker": (NUKER.replace("7) 0.5 1", "7) 2.5 1"), {}),
    "no_type": ("0)\n", {}),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_jax(case):
    text, kw = ERROR_CASES[case]
    (_, terr, tw), (_, jerr, jw) = _both("components_from_feedme", text, **kw)
    assert terr is not None and terr == jerr and tw == jw


WARN_CASES = {
    "unknown_type": (HEADER + " 0) powsersic\n 1) 30.0 30.0 0 0\n 3) 20.0 0\n\n"
                     " 0) sky\n 1) 3.0 0\n", None),
    "clamped_gamma": (NUKER.replace("7) 0.5 1", "7) 1.98 1"), None),
    "not_a_tie": (FEEDME_CON, " 2_1 mag offset\n"),
    "axis_ratio": (FEEDME_CON, " 1 q 0.5 to 1\n"),
    "fixed_pa": (FEEDME_CON, " 1 pa -10 10\n"),
    "pair_range": (FEEDME_CON.replace("3) 21.0 1", "3) 20.0 1"), " 2_1 mag -0.5 0.5\n"),
    "multi_couple": (FEEDME_CON.replace("3) 21.0 1", "3) 20.0 1")
                     + "\n 0) psf\n 1) 40.0 40.0 1 1\n 3) 20.0 1\n", " 3_2_1 mag offset\n"),
    "xy_to_sky": (HEADER + " 0) sky\n 1) 1.0 1\n\n 0) psf\n 1) 30.0 30.0 1 1\n 3) 21.0 1\n",
                  " 2_1 x offset\n 2_1 y offset\n"),
    "one_coordinate": (FEEDME_CON, " 2_1 x offset\n"),
    "ranges_and_ties": (FEEDME_CON, CONSTRAINTS),
    "log_ramp": (FEEDME_MULTI.replace("R0) power", "R0) log"), None),
    "bad_toggle": (FEEDME_MULTI.replace("3) 19.5 1", "3) 19.5 2"), None),
}


@pytest.mark.parametrize("case", sorted(WARN_CASES))
def test_constraints_and_warnings_match_jax(case):
    """Warnings equal, and the components (with their ``Tied`` links)."""
    text, cons = WARN_CASES[case]
    (t, terr, tw), (j, jerr, jw) = _both("components_from_feedme", text, constraints=cons)
    assert terr is None and jerr is None
    assert tw == jw
    _same_components(t, j)
    (ts, _, tw), (js, _, jw) = _both("feedme_to_model_source", text, constraints=cons)
    assert _as_jax_text(ts) == js and tw == jw


def test_constraint_ranges_and_ties_on_the_port():
    ser, ps = tg.components_from_feedme(FEEDME_CON, constraints=CONSTRAINTS)
    assert ser._priors["index"].rv_frozen.support() == pytest.approx((0.5, 6.0))
    assert ser._priors["mag"].rv_frozen.support() == pytest.approx((19.0, 21.0))
    assert ser._priors["reff"].rv_frozen.support() == pytest.approx((2.0, 9.0))
    assert isinstance(ps._constants["xy"], TC.Tied) and ps._constants["xy"].component is ser
    src = tg.feedme_to_model_source(FEEDME_CON, constraints=CONSTRAINTS)
    assert "Tied(c1, 'xy')" in src
    parsed = tparse_string(src)
    assert parsed[1]._constants["xy"].component is parsed[0]
    from psfmc_tpu_torch.models.spec import build_param_slots

    slots, _, _ = build_param_slots(parsed)
    assert not any("PointSource_xy" in s.name for s in slots)


def test_constraint_autoload_from_g_entry(tmp_path):
    (tmp_path / "cons.txt").write_text(" 1 n 1.0 to 4.0\n")
    (tmp_path / "gal.feedme").write_text(FEEDME_CON.replace("P) 0", "P) 0\nG) cons.txt"))
    (t, _, tw), (j, _, jw) = _both("components_from_feedme", str(tmp_path / "gal.feedme"))
    assert tw == jw
    _same_components(t, j)
    assert t[0]._priors["index"].rv_frozen.support() == pytest.approx((1.0, 4.0))
    (tmp_path / "gal2.feedme").write_text(FEEDME_CON.replace("P) 0", "P) 0\nG) nowhere.txt"))
    (t, _, tw), (j, _, jw) = _both("components_from_feedme", str(tmp_path / "gal2.feedme"))
    assert tw == jw and tw


# -- the model source --------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(FEEDMES))
def test_model_source_matches_jax_but_the_generator_line(name, tmp_path):
    src = tg.feedme_to_model_source(FEEDMES[name])
    want = jg.feedme_to_model_source(FEEDMES[name])
    assert _as_jax_text(src) == want
    assert src.split("\n", 1)[1] == want.split("\n", 1)[1]
    parsed = tparse_string(src, model_dir=str(tmp_path))
    _same_components(parsed, jparse_string(want, model_dir=str(tmp_path)))
    direct = tg.components_from_feedme(FEEDMES[name])
    assert [type(c).__name__ for c in parsed] == [type(c).__name__ for c in direct]


# -- the export ------------------------------------------------------------------------
def test_results_to_feedme_roundtrip_matches_jax():
    full = FEEDMES["full"]
    t = tg.components_from_feedme(full, priors="fixed")
    j = jg.components_from_feedme(full, priors="fixed")
    kw = dict(mag_zeropoint=26.0, plate_scale=(0.05, 0.05))
    out = tg.results_to_feedme(t, **kw)
    assert _as_jax_text(out) == jg.results_to_feedme(j, **kw)
    back = tg.components_from_feedme(out, priors="fixed")
    for c_d, c_b in zip(t, back):
        for attr in sorted(c_d._constants):
            np.testing.assert_allclose(np.asarray(getattr(c_b, attr), np.float64),
                                       np.asarray(getattr(c_d, attr), np.float64),
                                       rtol=2e-3, atol=5e-4)


def test_results_to_feedme_exports_degrees_for_radians_mode():
    kw = dict(xy=np.array([30.0, 30.0]), mag=20.0, reff=5.0, reff_b=4.0, index=2.0,
              angle=0.5, angle_degrees=False, rot_ang=1.0, rot_out=5.0)
    out = tg.results_to_feedme([TC.Sersic(**kw)])
    assert _as_jax_text(out) == jg.results_to_feedme([JC.Sersic(**kw)])
    (obj,) = tg.parse_feedme(out).objects
    assert obj.params["R3"][0][0] == pytest.approx(np.rad2deg(1.0))
    with pytest.raises(ValueError, match="zeropoint and plate scale"):
        tg.results_to_feedme(tg.components_from_feedme(FEEDME_SB, priors="fixed"))


def _port_database(comps, path, seed, nwalkers=8, niter=12):
    """Draws around each prior's centre written by the port's
    ``save_database`` under the canonical layout names."""
    for i, c in enumerate(comps):
        c.update_stochastic_names(count=i)
    priors = [p for c in comps for _a, p in c.sorted_prior_items()]
    names = [p.name for p in priors]
    lens = [int(np.size(p.rv_frozen.mean())) for p in priors]
    centre = np.concatenate([np.atleast_1d(p.rv_frozen.mean()) for p in priors])
    width = np.concatenate([np.atleast_1d(p.rv_frozen.std()) for p in priors])
    rng = np.random.RandomState(seed)
    chain = centre + 0.05 * width * rng.randn(nwalkers, niter, centre.size)
    sampler = types.SimpleNamespace(chain=chain, lnprobability=rng.randn(nwalkers, niter),
                                    nwalkers=nwalkers, state=None)
    model = types.SimpleNamespace(param_names=names, param_lens=lens)
    tdb.save_database(sampler, model, path, meta_dict={"MCITER": niter})
    return centre


@pytest.mark.parametrize("name,cons", [("full", None), ("con", CONSTRAINTS)])
def test_results_to_feedme_on_a_port_database_matches_jax(name, cons, tmp_path):
    """A trace database the port wrote, read by each package: the same
    feedme text (posterior means, toggles, the tie's owner's mean)."""
    path = str(tmp_path / "db.fits")
    _port_database(tg.components_from_feedme(FEEDMES[name], constraints=cons), path, seed=3)
    t = tg.components_from_feedme(FEEDMES[name], constraints=cons)
    j = jg.components_from_feedme(FEEDMES[name], constraints=cons)
    kw = dict(database=path, mag_zeropoint=26.0, plate_scale=(0.05, 0.05))
    (out, _, tw), (want, _, jw) = [(mod.results_to_feedme(c, **kw), None, None)
                                   for mod, c in ((tg, t), (jg, j))]
    assert _as_jax_text(out) == want
    if name == "con":  # the tied point source exports the Sersic's mean position
        ser_o, ps_o = tg.parse_feedme(out).objects
        assert ps_o.params["1"] == ser_o.params["1"]
        assert ps_o.params["1"][1] == [1, 1]


def test_fuzzed_feedmes_match_jax():
    """Structurally plausible garbage: both packages give the same
    components, or the same ``ValueError`` text."""
    from hypothesis import given, settings, strategies as st

    kinds = st.sampled_from(["sersic", "expdisk", "devauc", "psf", "sky", "gaussian",
                             "moffat", "king", "nuker", "ferrer", "edgedisk", "garbage"])
    num = st.floats(-100, 100, allow_nan=False).map(lambda v: f"{v:.4g}")
    pkey = st.sampled_from(["1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "C0", "F1",
                            "B2", "R1", "R2", "R3", "R4", "T0", "Z"])

    @settings(max_examples=80, deadline=None)
    @given(st.lists(st.tuples(kinds, st.lists(
        st.tuples(pkey, num, st.sampled_from(["0", "1"])), max_size=8)),
        min_size=1, max_size=3))
    def run(objs):
        lines = []
        for kind, params in objs:
            lines.append(f"0) {kind}")
            lines += [f" {k}) {v} {t}" for k, v, t in params]
        text = "\n".join(lines)
        (t, terr, tw), (j, jerr, jw) = _both("components_from_feedme", text)
        assert terr == jerr and tw == jw
        if terr is None:
            _same_components(t, j)

    run()


# -- the chip phase, rehearsed -------------------------------------------------------------
def test_chip_smoke_galfit_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.galfit_phase`` at 32x32 on the CPU, where each kernel
    wrapper runs its plain version and is counted as the card counts its
    kernel (conv_lnl's forward under autograd on the route ``fft_res``): the
    import, the MAP fit through ``quick_fit_main`` (16 starts x 30 steps)
    and its subprocess, a 40-walker MCMC fit of 4 + 4 steps, the summary
    with and without the criticism, the export and its round trip, the
    exact launch tallies and the kernel checks at the phase's batches."""
    import chip_smoke as cs
    import psfmc_tpu_torch.models.posterior as P
    from psfmc_tpu_torch.ops.kernels import conv_lnl as CL
    from psfmc_tpu_torch.ops.kernels import sersic_render as SR

    def counting(mod, name, route=None):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            wrapped.launches += 1
            if route is not None:
                key = route(*a)
                wrapped.route_launches[key[0]] += 1
                wrapped.shape_launches[key] = wrapped.shape_launches.get(key, 0) + 1
            return orig(*a, **k)

        wrapped.launches = 0
        if route is not None:
            wrapped.route_launches = dict.fromkeys(orig.route_launches, 0)
            wrapped.shape_launches = {}
        monkeypatch.setattr(mod, name, wrapped)
        if hasattr(P, name):
            monkeypatch.setattr(P, name, wrapped)

    def forward_route(raws, consts, *a):
        route = CL.conv_route(consts.shape)
        if torch.is_grad_enabled() and raws.requires_grad and route in ("fft", "padded"):
            route += "_res"
        return route, consts.shape

    counting(SR, "render_sersics")
    counting(SR, "render_sersics_backward")
    counting(CL, "batched_conv_lnl", forward_route)
    counting(CL, "batched_conv_lnl_backward",
             lambda raws, consts, *a: (CL.conv_route(consts.shape), consts.shape))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the phase's quick_fit subprocess
    for name, value in (("MAP_STARTS", 16), ("MAP_STEPS", 30), ("NWALKERS", 40),
                        ("B_HALF", 20), ("BURN", 4), ("SAMPLE", 4), ("CHECKPOINT", 2),
                        # a 32x32 flagship is crowded and a short fit's Laplace
                        # curvature need not be positive definite (its cards then
                        # carry no error): the full-width phase requires them
                        ("LAPLACE_MARK", "")):
        monkeypatch.setattr(cs, name, value)
    out = cs.galfit_phase(shape=(32, 32), psf_shape=(16, 16), device="cpu")
    assert out["import"] == {"lnpost": "batched", "grad_mode": "batched", "params": 16,
                             "tied": True}
    assert out["subprocess_rc"] == 0 and out["roundtrip_max_err"] <= 5e-5
    assert out["map"]["batched_conv_lnl:fft_res"] == 30 + 3
    assert [c["batch"] for c in out["kernel_checks"]["map"]] == [16]
    assert [c["batch"] for c in out["kernel_checks"]["mcmc"]] == [20]
    assert set(out["seconds"]) >= {"import", "quick_fit", "quick_fit_subprocess", "mcmc",
                                   "summary", "summary_criticism", "export"}
