"""The port's command line (``cli.py``) against the JAX package's, on the
CPU with ``PSFMC_PLATFORM=cpu``.

Every command's usage text and error exit codes equal the JAX command's
(its package and console names read as the port's); ``quick_fit`` at
24x24 (8 starts x 150 steps, as ``tests/test_optimize.py`` runs the JAX
one) writes products bit for bit those of ``model_galaxy_map(...,
device="cpu")`` called directly; ``summary`` and ``summary --criticism``
print the JAX command's lines on the same database (one the port wrote),
every number equal to its printed precision, with the same exit status;
``plot_chain`` (hist, trace, autocorr, profile) and ``corner_plot`` with
``save`` write their files; ``import_galfit`` writes the JAX command's
model text but for the generator line, and the file parses; without CUDA
and without ``PSFMC_PLATFORM=cpu`` the commands raise, and an unknown
``PSFMC_PLATFORM`` raises a ``ValueError`` naming it; ``python -m
psfmc_tpu_torch.cli`` (run through ``runpy``) prints its usage without a
command, and the dispatcher runs each command.  Each test runs torch on one thread.
"""
import contextlib
import io
import os
import re
import sys
import types
import warnings

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from psfmc_tpu import cli as jcli  # noqa: E402
from psfmc_tpu_torch import cli as tcli  # noqa: E402
from psfmc_tpu_torch import database as tdb  # noqa: E402
from psfmc_tpu_torch.fitting import model_galaxy_map  # noqa: E402
from psfmc_tpu_torch.io import fits as tfits  # noqa: E402
from psfmc_tpu_torch.model_parser import component_list_from_file  # noqa: E402
from psfmc_tpu_torch.models import MultiComponentModel  # noqa: E402
from test_galfit_import import HEADER  # noqa: E402
from test_torch_io import MODEL, _write_inputs  # noqa: E402

COMMANDS = ("plot_chain", "quick_fit", "corner_plot", "summary", "import_galfit")
IMAGE_TYPES = ("raw_model", "convolved_model", "residual", "composite_ivm",
               "point_source_subtracted")
# MODEL's layout: sky, point source (mag, xy), Sersic (angle, index, mag,
# reff, reff_b, xy)
TRUTH = np.array([0.01, 21.0, 12.0, 12.0, 40.0, 2.0, 22.0, 4.0, 3.0, 12.3, 11.8])
SCATTER = np.array([1.5e-4, 0.006, 0.006, 0.006, 0.6, 0.015, 0.015, 0.03, 0.03, 0.006, 0.006])
QUICK_MODEL = (
    "import numpy as np\n"
    "Configuration(obs_file=np.load('obs.npy'),\n"
    "    obsivm_file=np.full((24,24), 1111.0),\n"
    "    psf_files=np.load('psf.npy'),\n"
    "    psfivm_files=np.full((24,24), 1e8), mag_zeropoint=25.0)\n"
    "Sky(adu=Normal(loc=0.05, scale=0.1))\n"
    "Sersic(xy=Uniform(loc=np.array([8.,8.]), scale=np.array([8.,8.])),\n"
    "    mag=Uniform(loc=19., scale=4.), reff=Uniform(loc=0.5, scale=4.5),\n"
    "    reff_b=Uniform(loc=0.5, scale=4.5), index=1.0, angle=0.0)\n"
)


@pytest.fixture(autouse=True)
def _cpu_one_thread(monkeypatch):
    """PSFMC_PLATFORM=cpu and one torch thread for the test."""
    monkeypatch.setenv("PSFMC_PLATFORM", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(fn, argv):
    """``fn(argv)``'s exit status and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = fn(list(argv))
    return rc, buf.getvalue()


def _as_port(text):
    """The JAX command's text with its package and console names read as
    the port's."""
    return (text.replace("psfmc-summary", "psfmc-torch-summary")
            .replace("psfmc-import-galfit", "psfmc-torch-import-galfit")
            .replace("psfmc_tpu", "psfmc_tpu_torch"))


_NUMBER = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _same_at_printed_precision(got, want):
    """The same lines, token by token; numbers equal to their printed
    precision (within one unit of the last digit the shorter prints)."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g_line, w_line in zip(got_lines, want_lines):
        g_tok, w_tok = g_line.replace(",", " ").split(), w_line.replace(",", " ").split()
        assert len(g_tok) == len(w_tok), (g_line, w_line)
        for g, w in zip(g_tok, w_tok):
            g, w = g.strip("()"), w.strip("()")
            if not (_NUMBER.match(g) and _NUMBER.match(w)):
                assert g == w, (g_line, w_line)
                continue
            mant = w.lower().split("e")[0]
            digits = len(mant.split(".")[1]) if "." in mant else 0
            exp = int(w.lower().split("e")[1]) if "e" in w.lower() else 0
            unit = 10.0 ** (exp - digits)
            assert abs(float(g) - float(w)) <= unit * (1 + 1e-9), (g_line, w_line)


# -- usage texts and error codes -------------------------------------------------
USAGE_CASES = [
    ("plot_chain", []), ("quick_fit", []), ("corner_plot", []), ("summary", []),
    ("summary", ["--criticism"]), ("import_galfit", []), ("import_galfit", ["-h"]),
    ("import_galfit", ["--help"]), ("quick_fit", ["m.py", "bogus=1"]),
    ("quick_fit", ["n_starts=8"]), ("quick_fit", ["m.py", "steps=abc"]),
    ("quick_fit", ["m.py", "laplace=yes"]),
]


@pytest.mark.parametrize("command,args", USAGE_CASES)
def test_usage_and_error_codes_match_jax(command, args):
    argv = [command] + args
    got = _run(getattr(tcli, f"{command}_main"), argv)
    want = _run(getattr(jcli, f"{command}_main"), argv)
    assert got[0] == want[0]
    assert got[1] == _as_port(want[1])
    assert got == _run(tcli.main, ["psfmc_tpu_torch.cli"] + argv)  # the dispatcher


def test_docs_match_jax():
    for name in ("PLOT_CHAIN_DOC", "CORNER_PLOT_DOC", "QUICK_FIT_DOC", "SUMMARY_DOC",
                 "IMPORT_GALFIT_DOC"):
        assert getattr(tcli, name) == _as_port(getattr(jcli, name)), name


# -- quick_fit --------------------------------------------------------------------
def test_quick_fit_products_are_model_galaxy_map_s(tmp_path, monkeypatch):
    """The command's five products bit for bit those of ``model_galaxy_map``
    called directly on the CPU with the same settings, and its printed
    line the fit's."""
    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:24, 0:24].astype(float)
    psf = np.exp(-((xx - 12) ** 2 + (yy - 12) ** 2) / (2 * 1.2**2))
    obs = 0.05 + np.exp(-((xx - 12.0) ** 2 + (yy - 12.0) ** 2) / (2 * 2.0**2)) \
        + rng.randn(24, 24) * 0.03
    monkeypatch.chdir(tmp_path)
    np.save("obs.npy", obs)
    np.save("psf.npy", psf / psf.sum())
    (tmp_path / "m.py").write_text(QUICK_MODEL)
    rc, printed = _run(tcli.quick_fit_main, ["quick_fit", "m.py", "n_starts=8", "steps=150"])
    assert rc == 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = model_galaxy_map("m.py", output_name="direct", n_starts=8, steps=150,
                               device="cpu")
    assert printed.splitlines()[-1] == f"lnpost = {res.lnpost:.3f}  (psf_index = {res.psf_index})"
    for ftype in IMAGE_TYPES:
        got, want = f"out_m_{ftype}.fits", f"direct_{ftype}.fits"
        np.testing.assert_array_equal(tfits.getdata(got), tfits.getdata(want))
        g_hdr, w_hdr = tfits.getheader(got), tfits.getheader(want)
        assert list(g_hdr.keys()) == list(w_hdr.keys())
        for key in w_hdr.keys():
            assert g_hdr[key] == w_hdr[key], key
    assert "+/-" in str(tfits.getheader("out_m_residual.fits")["1SER_MAG"])
    rc, printed = _run(tcli.quick_fit_main, ["quick_fit", "m.py", "quick", "n_starts=8",
                                             "steps=150", "seed=0", "laplace=0"])
    assert rc == 0 and os.path.exists("quick_residual.fits")
    assert "+/-" not in str(tfits.getheader("quick_residual.fits")["1SER_MAG"])


# -- summary ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    """The 24x24 model file on data simulated at TRUTH, and a database of
    draws around TRUTH with their float64 lnpost, written by the port."""
    tmp = tmp_path_factory.mktemp("cli")
    _write_inputs(str(tmp))
    (tmp / "model.py").write_text(MODEL)
    model = MultiComponentModel(str(tmp / "model.py"), device="cpu", dtype=torch.float64)
    mock, _ = model.simulate(theta=TRUTH, random_state=1)
    tfits.writeto(str(tmp / "sci.fits"), mock, overwrite=True)
    model = MultiComponentModel(str(tmp / "model.py"), device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(0)
    nwalkers, niter = 10, 40
    thetas = TRUTH + rng.randn(nwalkers * niter, TRUTH.size) * SCATTER
    lnp = model.posterior_fns.log_posterior_batch(thetas).numpy()
    sampler = types.SimpleNamespace(chain=thetas.reshape(nwalkers, niter, -1),
                                    lnprobability=lnp.reshape(nwalkers, niter),
                                    nwalkers=nwalkers, state=None)
    db = str(tmp / "fit_db.fits")
    tdb.save_database(sampler, model, db, meta_dict={"MCITER": niter})
    return {"dir": tmp, "model": str(tmp / "model.py"), "db": db}


@pytest.mark.parametrize("criticism", [False, True])
def test_summary_matches_jax(trace, criticism, monkeypatch):
    """With ``--criticism`` both commands build their model in float64 (the
    replays' float32 roundings differ between the packages in the fourth
    significant digit of the power-scaling indices)."""
    import jax.numpy as jnp

    import psfmc_tpu.models.multicomponent as jmc
    import psfmc_tpu_torch.models.multicomponent as tmc
    from psfmc_tpu.model_parser import component_list_from_file as jparse

    port_as_model = tmc.as_model
    monkeypatch.setattr(jmc, "as_model", lambda m: m if hasattr(m, "posterior_fns") else
                        jmc.MultiComponentModel(jparse(m), dtype=jnp.float64))
    monkeypatch.setattr(tmc, "as_model",
                        lambda m, **k: port_as_model(m, dtype=torch.float64, **k))
    monkeypatch.chdir(trace["dir"])
    argv = ["psfmc-summary"] + (["--criticism", "model.py"] if criticism else []) + [
        trace["db"], trace["db"]]
    got_rc, got = _run(tcli.summary_main, argv)
    want_rc, want = _run(jcli.summary_main, argv)
    assert got_rc == want_rc
    _same_at_printed_precision(got, want)
    assert "0_Sky_adu" in got and "rhat" in got
    if criticism:
        assert all(s in got for s in ("PSIS-LOO", "LOO-PIT", "power-scaling sensitivity"))
        assert "unavailable" not in got


def test_summary_criticism_failure_is_status_1(trace, monkeypatch):
    monkeypatch.chdir(trace["dir"])
    (trace["dir"] / "broken.py").write_text(MODEL.replace("mask.reg", "no_such.reg"))
    argv = ["psfmc-summary", "--criticism", "broken.py", trace["db"]]
    with pytest.raises(Exception):  # noqa: B017 - the model cannot build in either
        _run(jcli.summary_main, argv)
    with pytest.raises(Exception):  # noqa: B017
        _run(tcli.summary_main, argv)


# -- the plots ---------------------------------------------------------------------
def test_plot_commands_write_their_files(trace, monkeypatch):
    monkeypatch.chdir(trace["dir"])
    db = trace["db"]
    for mode, trace_name, suffix in (("hist", "2_Sersic_reff", "2_Sersic_reff_hist"),
                                     ("trace", "1_PointSource_mag", "1_PointSource_mag_trace"),
                                     ("autocorr", "1_PointSource_xy", "1_PointSource_xy_acorr")):
        rc, printed = _run(tcli.plot_chain_main, ["plot_chain", trace_name, mode, "save", db])
        assert rc == 0 and os.path.exists(f"fit_db_{suffix}.pdf"), mode
        if mode == "hist":
            assert printed == f"Found matching model file {trace['model']} for database {db}\n"
    rc, _ = _run(tcli.plot_chain_main, ["plot_chain", "2_Sersic", "profile", "save", db])
    assert rc == 0 and os.path.exists("fit_db_profile.pdf")
    assert _run(tcli.corner_plot_main, ["corner_plot", "save", db])[0] == 0
    assert os.path.exists("fit_db_corner.pdf")
    os.remove("fit_db_corner.pdf")
    assert _run(tcli.corner_plot_main,
                ["corner_plot", "1_PointSource_mag,2_Sersic_mag", "save", db])[0] == 0
    assert os.path.exists("fit_db_corner.pdf")


# -- import_galfit ---------------------------------------------------------------------
def test_import_galfit_matches_jax(tmp_path, monkeypatch):
    """tests/test_galfit_import.py's CLI case on the port, and the written
    model text the JAX command's but for the generator line."""
    fm = tmp_path / "gal.feedme"
    fm.write_text(HEADER + "\n 0) sky\n 1) 4.0 1\n")
    out, jout = tmp_path / "model.py", tmp_path / "jmodel.py"
    assert _run(tcli.import_galfit_main, ["x", str(fm), str(out)]) == (0, f"wrote {out}\n")
    assert _run(jcli.import_galfit_main, ["x", str(fm), str(jout)])[0] == 0
    text, want = out.read_text(), jout.read_text()
    assert "Sky(adu=Uniform" in text
    assert text.split("\n", 1)[1] == want.split("\n", 1)[1]
    assert text.split("\n", 1)[0] == "# Generated from a GALFIT feedme by psfmc_tpu_torch.io.galfit"
    assert len(component_list_from_file(str(out))) == 1
    assert _run(tcli.import_galfit_main, ["x", str(fm)]) == (0, text)  # to stdout
    assert _run(tcli.import_galfit_main, ["x"])[0] == 2  # usage
    monkeypatch.delenv("PSFMC_PLATFORM")  # host work: no device read
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _run(tcli.import_galfit_main, ["x", str(fm)])[0] == 0


# -- the device ----------------------------------------------------------------------------
def test_commands_raise_without_cuda_and_without_cpu(trace, monkeypatch):
    monkeypatch.chdir(trace["dir"])
    monkeypatch.delenv("PSFMC_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = trace["db"]
    for command, args in (("quick_fit", ["model.py"]), ("summary", [db]),
                          ("summary", ["--criticism", "model.py", db]),
                          ("plot_chain", ["0_Sky_adu", "save", db]),
                          ("corner_plot", ["save", db])):
        with pytest.raises(RuntimeError, match="runs on CUDA by default"):
            _run(getattr(tcli, f"{command}_main"), [command] + args)
    monkeypatch.setenv("PSFMC_PLATFORM", "cuda")
    with pytest.raises(RuntimeError, match="runs on CUDA by default"):
        _run(tcli.summary_main, ["summary", db])
    monkeypatch.setenv("PSFMC_PLATFORM", "tpu")
    for command in COMMANDS[:4]:
        with pytest.raises(ValueError, match="PSFMC_PLATFORM='tpu'"):
            _run(getattr(tcli, f"{command}_main"), [command, db])


# -- python -m psfmc_tpu_torch.cli ---------------------------------------------------------
def test_python_dash_m_dispatches(tmp_path, monkeypatch):
    """The module run as ``python -m`` runs it (``runpy``, as the
    interpreter does): usage and exit status 2 without a command; the
    dispatcher runs each command with ``argv[0]`` its name."""
    import runpy

    monkeypatch.setattr(sys, "argv", ["psfmc_tpu_torch.cli"])
    buf = io.StringIO()
    with pytest.raises(SystemExit) as done, contextlib.redirect_stdout(buf), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the module is imported already
        runpy.run_module("psfmc_tpu_torch.cli", run_name="__main__", alter_sys=True)
    assert done.value.code == 2
    assert buf.getvalue() == tcli.MAIN_DOC + "\n"
    assert buf.getvalue().startswith("Usage: python -m psfmc_tpu_torch.cli <command>")
    assert _run(tcli.main, ["cli", "bogus"])[0] == 2
    assert _run(tcli.main, ["cli", "--help"]) == (0, tcli.MAIN_DOC + "\n")
    fm = tmp_path / "gal.feedme"
    fm.write_text(HEADER + "\n 0) sky\n 1) 4.0 1\n")
    assert _run(tcli.main, ["cli", "import_galfit", str(fm)]) == _run(
        tcli.import_galfit_main, ["import_galfit", str(fm)])
    for command in COMMANDS:
        assert _run(tcli.main, ["cli", command]) == _run(getattr(tcli, f"{command}_main"),
                                                         [command])
