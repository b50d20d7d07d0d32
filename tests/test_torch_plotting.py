"""The port's plots (``analysis/plotting.py``, ``analysis/corner.py``)
against the JAX package's, on the CPU under matplotlib's Agg backend.

The numbers behind the plots are held to the JAX package on the same
inputs: the axis labels equal, ``_get_trace``'s derived traces
(``magdiff``, ``centerdist``, ``axisratio``, ``sbeff`` with and without
the boxy ``c0`` and the WCS pixel area) and ``radial_profile`` (circular
and elliptical annuli, with a variance and a mask) within 1e-12, and
``plot_criticism``'s PIT histogram counts equal, its Pareto-k map within
1e-8 and its LOO z-score map within rtol 1e-6 (float64 replays of the
same trace).  Every
plot function runs with ``save=True`` and writes its file.  No module of
the port imports matplotlib at module level.
"""
import ast
import os
import types
import warnings

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from psfmc_tpu.analysis import plotting as jplot  # noqa: E402
from psfmc_tpu.database import save_database as jax_save_database  # noqa: E402
from psfmc_tpu.io import fits as jfits  # noqa: E402
from psfmc_tpu.model_parser import component_list_from_file as jparse  # noqa: E402
from psfmc_tpu.models.multicomponent import MultiComponentModel as JaxModel  # noqa: E402
from psfmc_tpu_torch import analysis  # noqa: E402
from psfmc_tpu_torch import model_galaxy_mcmc  # noqa: E402
from psfmc_tpu_torch.analysis import plotting as tplot  # noqa: E402
from psfmc_tpu_torch.database import load_database  # noqa: E402
from psfmc_tpu_torch.io import fits as tfits  # noqa: E402
from psfmc_tpu_torch.models import MultiComponentModel  # noqa: E402
from test_torch_io import MODEL, REPO, _write_inputs  # noqa: E402

NAMES = ["0_Sky_adu", "1_PointSource_mag", "1_PointSource_xy", "2_Sersic_c0",
         "2_Sersic_index", "2_Sersic_mag", "2_Sersic_reff", "2_Sersic_reff_b",
         "2_Sersic_xy"]
LENS = [1, 1, 2, 1, 1, 1, 1, 1, 2]
DERIVED = ["1_PointSource_2_Sersic_magdiff", "1_PointSource_2_Sersic_centerdist",
           "2_Sersic_axisratio", "2_Sersic_sbeff", "2_Sersic_mag", "1_PointSource_xy",
           "lnprobability"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace_db(path, with_c0, nwalkers=8, niter=40, seed=0):
    """A trace database of random draws around a quasar + host; written by
    the JAX package's writer, read by each package."""
    names = NAMES if with_c0 else [n for n in NAMES if n != "2_Sersic_c0"]
    lens = LENS if with_c0 else [ln for n, ln in zip(NAMES, LENS) if n != "2_Sersic_c0"]
    base = {"0_Sky_adu": [0.02], "1_PointSource_mag": [19.5],
            "1_PointSource_xy": [16.0, 15.0], "2_Sersic_c0": [0.3],
            "2_Sersic_index": [2.0], "2_Sersic_mag": [20.5], "2_Sersic_reff": [4.0],
            "2_Sersic_reff_b": [3.0], "2_Sersic_xy": [16.5, 15.2]}
    centre = np.concatenate([base[n] for n in names])
    rng = np.random.RandomState(seed)
    sampler = types.SimpleNamespace(
        chain=centre + rng.randn(nwalkers, niter, centre.size) * 0.1,
        lnprobability=rng.randn(nwalkers, niter), state=None)
    model = types.SimpleNamespace(param_names=names, param_lens=lens)
    jax_save_database(sampler, model, path, meta_dict={"MCITER": niter})
    return path


def _wcs_header(fits_module):
    hdr = fits_module.Header()
    for key, value in (("CTYPE1", "RA---TAN"), ("CTYPE2", "DEC--TAN"),
                       ("CRVAL1", 150.1), ("CRVAL2", 2.2), ("CRPIX1", 16.0),
                       ("CRPIX2", 16.0), ("CD1_1", -0.03 / 3600), ("CD1_2", 0.0),
                       ("CD2_1", 0.0), ("CD2_2", 0.03 / 3600)):
        hdr.set(key, value)
    return hdr


def test_axis_labels_match_jax():
    for name in ["lnprobability", "1_PointSource_xy", "2_Sersic_reff_b",
                 "1_PointSource_2_Sersic_magdiff", "2_Sersic_sbeff", "PSF_Index",
                 "3_Sersic_angle", "unknown", "a_b"]:
        assert tplot._axis_label(name) == jplot._axis_label(name), name


@pytest.mark.parametrize("with_c0", [False, True])
def test_derived_traces_match_jax(tmp_path, with_c0):
    """Each derived trace, without a model and with a WCS header (sbeff in
    mag/arcsec^2), within 1e-12 of the JAX package's; an unknown name
    raises the same ``KeyError``."""
    path = _trace_db(str(tmp_path / "db.fits"), with_c0)
    from psfmc_tpu.database import load_database as jax_load

    tdb, jdb = load_database(path), jax_load(path)
    t_model = types.SimpleNamespace(obs_header=_wcs_header(tfits))
    j_model = types.SimpleNamespace(obs_header=_wcs_header(jfits))
    for name in DERIVED:
        for tm, jm in ((None, None), (t_model, j_model)):
            got = tplot._get_trace(name, tdb, model=tm)
            want = jplot._get_trace(name, jdb, model=jm)
            assert got.shape == want.shape and got.dtype == np.float64, name
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=name)
    with pytest.raises(KeyError, match="Unable to find trace"):
        tplot._get_trace("9_Sersic_mag", tdb)


@pytest.mark.parametrize("axis_ratio, angle", [(1.0, 0.0), (0.6, 0.7)])
def test_radial_profile_matches_jax(axis_ratio, angle):
    rng = np.random.RandomState(3)
    image = rng.randn(40, 36) + 5.0
    var = rng.uniform(0.5, 2.0, image.shape)
    good = rng.rand(*image.shape) > 0.1
    for kw in (dict(), dict(variance=var, good=good, bin_px=1.5),
               dict(variance=var, rmax=12.0)):
        got = tplot.radial_profile(image, (17.3, 19.1), axis_ratio=axis_ratio,
                                   angle=angle, **kw)
        want = jplot.radial_profile(image, (17.3, 19.1), axis_ratio=axis_ratio,
                                    angle=angle, **kw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
            assert a.dtype == b.dtype


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    """A short fit of the 24x24 model file on the CPU: its directory, the
    database file, and float64 models of both packages."""
    tmp = tmp_path_factory.mktemp("plots")
    _write_inputs(str(tmp))
    (tmp / "model.py").write_text(MODEL)
    path = str(tmp / "model.py")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        model_galaxy_mcmc(path, output_name=str(tmp / "fit"), chains=24, burn=30,
                          iterations=10, seed=0, device="cpu", write_fits=())
    return {"dir": tmp, "model_file": path, "db": str(tmp / "fit_db.fits"),
            "torch": MultiComponentModel(path, device="cpu", dtype=torch.float64),
            "jax": JaxModel(jparse(path), dtype=jnp.float64)}


def test_every_plot_writes_its_file(fit, monkeypatch):
    monkeypatch.chdir(fit["dir"])
    db, model_file = fit["db"], fit["model_file"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        n = analysis.plot_trace("1_PointSource_mag", db, model_file, save=True,
                                device="cpu")
        analysis.plot_hist("2_Sersic_reff", db, model_file, save=True, device="cpu")
        analysis.plot_autocorr("1_PointSource_xy", db, save=True)
        analysis.corner_plot(db, save=True)
        analysis.corner_plot(db, disp_parameters=["1_PointSource_xy", "2_Sersic_mag"],
                             save=True)
        loo, pit = analysis.plot_criticism(db, fit["torch"], save=True, draws=200)
        r, d_mean, m_mean, d_err = analysis.plot_profile(
            db, model=model_file, save=True, component="2_Sersic", device="cpu")
    assert n == 10
    for suffix in ("1_PointSource_mag_trace", "2_Sersic_reff_hist",
                   "1_PointSource_xy_acorr", "corner", "criticism", "profile"):
        assert os.path.exists(f"fit_db_{suffix}.pdf"), suffix
    assert loo.elpd_i.size == pit.pit.size == 24 * 24 - int(
        np.asarray(fit["torch"].spec.bad_px).sum())
    assert np.all(np.isfinite(m_mean)) and r.size == d_mean.size == d_err.size
    with pytest.raises(ValueError, match="Unable to find trace"):
        analysis.corner_plot(db, disp_parameters=["no_such"], save=True)


def _captured(module, monkeypatch):
    """Keep the figure ``module``'s plots hand to ``_show_or_save``."""
    figs = []
    monkeypatch.setattr(module, "_show_or_save", lambda fig, save, name: figs.append(fig))
    return figs


def test_plot_criticism_panels_match_jax(fit, monkeypatch):
    """The same trace through both packages' ``plot_criticism`` (float64
    replays): the PIT histogram's counts equal, the Pareto-k map within
    1e-8 and the LOO z-score map within rtol 1e-6 (NaN at the same masked
    pixels)."""
    figs_t, figs_j = _captured(tplot, monkeypatch), _captured(jplot, monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tplot.plot_criticism(fit["db"], fit["torch"], draws=200)
        jplot.plot_criticism(fit["db"], fit["jax"], draws=200)
    (ft,), (fj,) = figs_t, figs_j
    at, aj = np.asarray(ft.axes), np.asarray(fj.axes)
    # the histogram's 25 bars, then the uniform band's span
    counts_t = [p.get_height() for p in at[0].patches[:25]]
    counts_j = [p.get_height() for p in aj[0].patches[:25]]
    assert len(at[0].patches) == len(aj[0].patches) == 26 and counts_t == counts_j
    assert sum(counts_t) == 24 * 24 - int(np.asarray(fit["torch"].spec.bad_px).sum())
    # the Pareto-k map, then the z-score map (the colorbars after them);
    # Phi^-1 magnifies a PIT near 0 or 1, so the z-scores are held relatively
    for k, tol in ((2, dict(rtol=0, atol=1e-8)), (3, dict(rtol=1e-6, atol=1e-8))):
        got = np.ma.filled(at[k].images[0].get_array(), np.nan)
        want = np.ma.filled(aj[k].images[0].get_array(), np.nan)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, equal_nan=True, **tol)
        assert at[k].get_title() == aj[k].get_title()
    assert at[0].get_title() == aj[0].get_title()
    assert at[1].get_title() == aj[1].get_title()
    for fig in (ft, fj):
        matplotlib.pyplot.close(fig)


def _module_level_imports(tree):
    """Imported module names in the statements run at import time: the
    module body, and the bodies of its top-level ``try`` / ``if`` blocks."""
    names, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        elif isinstance(node, (ast.Try, ast.If)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            todo += [s for h in getattr(node, "handlers", []) for s in h.body]
    return names


def test_port_imports_matplotlib_only_inside_functions():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "psfmc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for name in _module_level_imports(tree):
            assert name.split(".")[0] not in ("matplotlib", "mpl_toolkits"), (path, name)
    with open(os.path.join(REPO, "psfmc_tpu_torch", "analysis", "plotting.py")) as fh:
        assert "import matplotlib" in fh.read()  # inside the plots
