"""The port's host layer against the JAX package's, on the CPU.

FITS codec, ds9 regions, preprocessing from files, the model-file
parser (including ``examples/model_example.py`` itself), and the rule
that the port imports neither ``jax`` nor ``psfmc_tpu``.
"""
import ast
import os
import shutil
import sys

import numpy as np
import pytest

from psfmc_tpu.io import fits as jfits
from psfmc_tpu.io import preprocess as jpre
from psfmc_tpu.io.region import region_mask as jregion_mask
from psfmc_tpu.model_parser import component_list_from_file as jparse
from psfmc_tpu.models.spec import build_model_spec as jax_spec
from psfmc_tpu_torch.io import fits as tfits
from psfmc_tpu_torch.io import preprocess as tpre
from psfmc_tpu_torch.io.region import region_mask as tregion_mask
from psfmc_tpu_torch.model_parser import (
    component_list_from_file as tparse,
    component_list_from_string,
)
from psfmc_tpu_torch.models import build_model_spec, spec_from_numpy
from test_torch_posterior import _numpy_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# examples/make_example_data.py writes this mask for model_example.py
MASK_EXAMPLE = ("# Region file format: DS9 version 4.1\nimage\n"
                "circle(65,65,55)\n-circle(20,110,8)\n")


def _header(codec):
    hdr = codec.Header()
    hdr.set("TELESCOP", "HST", "the telescope")
    hdr.set("EXPTIME", 1234.5, "seconds")
    hdr.set("NCOMBINE", 4)
    hdr.set("FLAGGED", True)
    hdr.set("OBSERVER", "O'Hara", "a quote inside")
    return hdr


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_fits_round_trip_across_codecs(tmp_path, writer, reader):
    codecs = {"torch": tfits, "jax": jfits}
    w, r = codecs[writer], codecs[reader]
    rng = np.random.RandomState(1)
    img = rng.randn(7, 5)
    path = str(tmp_path / "img.fits")
    w.writeto(path, img, header=_header(w))
    np.testing.assert_array_equal(r.getdata(path), img)
    hdr = r.getheader(path)
    for key in ("TELESCOP", "EXPTIME", "NCOMBINE", "FLAGGED", "OBSERVER"):
        assert hdr[key] == _header(w)[key], key
    cols = {"a": rng.randn(4), "xy": rng.randn(4, 2),
            "n": np.arange(4, dtype=np.int64)}
    hdus = [(w.Header(), None),
            w.make_bintable_hdu(list(cols), cols, meta=[("MCITER", 4)],
                                extname="TRACE")]
    w.write_hdus(str(tmp_path / "tbl.fits"), hdus)
    (_, _), (thdr, raw) = r.read_hdus(str(tmp_path / "tbl.fits"))
    names, got = r.read_bintable(thdr, raw)
    assert names == list(cols) and thdr["MCITER"] == 4
    for k, v in cols.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype


@pytest.mark.parametrize("text,shape", [
    (MASK_EXAMPLE, (128, 128)),
    ("image\npolygon(3,4,20,6,25,22,12,28,4,18)\n-circle(12,14,3)\n", (32, 30)),
    ("image; box(10,12,8,5,30); ellipse(20,20,6,3,45)", (32, 32)),
])
def test_region_mask_matches_jax(text, shape):
    got = tregion_mask(text, shape)
    np.testing.assert_array_equal(got, jregion_mask(text, shape))
    assert 0 < got.sum() < got.size


def _write_inputs(directory, shape=(24, 24), psf_shape=(12, 12), seed=2):
    rng = np.random.RandomState(seed)
    h, w = shape
    yy, xx = np.mgrid[0:psf_shape[0], 0:psf_shape[1]].astype(float)
    psf = np.exp(-((xx - psf_shape[1] / 2) ** 2 + (yy - psf_shape[0] / 2) ** 2) / 4.5)
    obs = 0.01 + rng.randn(h, w) * 0.005
    ivm = np.full(shape, 1 / 0.005**2)
    ivm[3, 4] = 0.0
    names = {"sci.fits": obs, "ivm.fits": ivm, "psf.fits": psf / psf.sum(),
             "psf_ivm.fits": np.full(psf_shape, 1e8)}
    hdr = tfits.Header()
    hdr.set("OBJECT", "J0005-0006")
    for name, arr in names.items():
        tfits.writeto(os.path.join(directory, name), arr,
                      header=hdr if name == "sci.fits" else None)
    mask = np.zeros(shape, np.int16)
    mask[:2, :] = 1
    tfits.writeto(os.path.join(directory, "mask.fits"), mask)
    with open(os.path.join(directory, "mask.reg"), "w") as fh:
        fh.write("image\ncircle(12.5,12.5,10)\n-circle(5,19,2)\n")


@pytest.mark.parametrize("mask", [None, "mask.fits", "mask.reg"])
def test_preprocess_from_files_matches_jax(tmp_path, mask):
    _write_inputs(str(tmp_path))
    p = lambda n: str(tmp_path / n)  # noqa: E731
    mask_file = None if mask is None else p(mask)
    t_hdr, t_data, t_var, t_bad = tpre.preprocess_obs(p("sci.fits"), p("ivm.fits"), mask_file)
    j_hdr, j_data, j_var, j_bad = jpre.preprocess_obs(p("sci.fits"), p("ivm.fits"), mask_file)
    assert t_hdr["OBJECT"] == j_hdr["OBJECT"] == "J0005-0006"
    np.testing.assert_array_equal(t_data, j_data)
    np.testing.assert_array_equal(t_var, j_var)
    np.testing.assert_array_equal(t_bad, j_bad)
    assert t_bad.sum() == 1 if mask is None else t_bad.sum() > 40
    for a, b in zip(tpre.preprocess_psf(p("psf.fits"), p("psf_ivm.fits")),
                    jpre.preprocess_psf(p("psf.fits"), p("psf_ivm.fits"))):
        np.testing.assert_array_equal(a, b)


def test_mask_file_that_is_neither_fits_nor_region_raises(tmp_path):
    bad = tmp_path / "mask.txt"
    bad.write_text("image\nhexagon(1,2,3)\n")
    with pytest.raises(ValueError, match="neither FITS nor"):
        tpre.mask_from_file(str(bad), None, (8, 8))


MODEL = """\
from numpy import array
from psfMC.ModelComponents import Configuration, PointSource, Sersic, Sky
from psfMC.distributions import Normal, Uniform, WeibullMinimum
import psfMC.distributions as dist

Configuration(obs_file="sci.fits", obsivm_file="ivm.fits", psf_files="psf.fits",
              psfivm_files="psf_ivm.fits", mask_file="mask.reg",
              mag_zeropoint=25.9463)
Sky(adu=dist.Normal(loc=0, scale=0.01))
PointSource(xy=Uniform(loc=array((9.0, 9.0)), scale=array((6.0, 6.0))),
            mag=Uniform(loc=20.5, scale=1.7))
host = Sersic(xy=Uniform(loc=array((9.0, 9.0)), scale=array((6.0, 6.0))),
              mag=Uniform(loc=20.7, scale=6.8), reff=Uniform(loc=2.0, scale=6.0),
              reff_b=Uniform(loc=2.0, scale=6.0),
              index=WeibullMinimum(c=1.5, scale=4),
              angle=Uniform(loc=0, scale=180), angle_degrees=True)
host
"""


def test_both_parsers_give_equal_specs(tmp_path):
    _write_inputs(str(tmp_path))
    path = tmp_path / "model.py"
    path.write_text(MODEL)
    before = {k: v for k, v in sys.modules.items() if k.startswith("psfMC")}
    tspec = build_model_spec(tparse(str(path)))
    # the port's parser registers no import shims
    assert {k: v for k, v in sys.modules.items() if k.startswith("psfMC")} == before
    carried = spec_from_numpy(**_numpy_fields(jax_spec(jparse(str(path)))))
    assert tspec.num_params == carried.num_params == 11

    def table(spec):
        return [(s.name, s.fitsname, s.offset, s.size, s.attr, s.comp_index,
                 type(s.dist).__name__, repr(s.dist)) for s in spec.slots]

    assert table(tspec) == table(carried)
    assert [(c.kind, c.params.keys(), c.static) for c in tspec.comp_specs] == \
        [(c.kind, c.params.keys(), c.static) for c in carried.comp_specs]
    for f in ("obs_data", "obs_var", "bad_px", "f_psf_stack", "f_var_stack"):
        np.testing.assert_array_equal(getattr(tspec, f), getattr(carried, f))


def test_parser_runs_examples_model_example(tmp_path):
    """``examples/model_example.py`` imports ``psfmc_tpu.models.components``;
    the port resolves it to its own components, unmodified."""
    shutil.copy(os.path.join(REPO, "examples", "model_example.py"), tmp_path)
    rng = np.random.RandomState(3)
    obs = 0.002 + rng.randn(128, 128) * 0.004
    tfits.writeto(str(tmp_path / "sci_example.fits"), obs)
    tfits.writeto(str(tmp_path / "ivm_example.fits"), np.full(obs.shape, 1 / 0.004**2))
    yy, xx = np.mgrid[0:64, 0:64].astype(float)
    psf = (1 + ((xx - 32) ** 2 + (yy - 32) ** 2) / 4.0) ** -2.5
    tfits.writeto(str(tmp_path / "psf_example.fits"), psf / psf.sum())
    tfits.writeto(str(tmp_path / "ivm_psf_example.fits"), np.full(psf.shape, 1e9))
    (tmp_path / "mask_example.reg").write_text(MASK_EXAMPLE)
    comps = tparse(str(tmp_path / "model_example.py"))
    assert [type(c).__module__ for c in comps] == ["psfmc_tpu_torch.models.components"] * 4
    spec = build_model_spec(comps)
    assert spec.num_params == 11
    np.testing.assert_array_equal(spec.bad_px, ~jregion_mask(MASK_EXAMPLE, (128, 128)))


@pytest.mark.parametrize("source,err", [
    ("import psfmc_tpu.fitting\n", ImportError),
    ("from psfMC.distributions import NoSuchFamily\n", ImportError),
])
def test_parser_refuses_what_the_port_lacks(source, err):
    with pytest.raises(err):
        component_list_from_string(source)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") in (
                "__import__", "import_module"):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_neither_jax_nor_psfmc_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "psfmc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for name in _imports(tree):
            root = str(name).split(".")[0]
            assert root not in ("jax", "jaxlib", "psfmc_tpu", "psfMC"), (path, name)
