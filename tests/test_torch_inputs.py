"""The survey inputs of the batch fit in the port against the JAX package, on the CPU.

``make_source_mask``, ``cutout_stack`` and ``interpolate_psfs`` are host
numpy in both packages: each is called by both on the same seeded arrays
and must agree exactly (masks, cutouts, origins, headers) or within
1e-12 (the interpolated PSFs and their IVMs); every validation error is
the JAX package's, message included.
"""
import numpy as np
import pytest

from psfmc_tpu.io import cutout as jcut
from psfmc_tpu.io import fits as jfits
from psfmc_tpu.io import preprocess as jpre
from psfmc_tpu.io import psfgrid as jgrid
from psfmc_tpu_torch.io import cutout as tcut
from psfmc_tpu_torch.io import fits as tfits
from psfmc_tpu_torch.io import preprocess as tpre
from psfmc_tpu_torch.io import psfgrid as tgrid


def _field(seed=0, shape=(64, 80)):
    """A noisy field with a target at the center and three neighbours of
    different sizes, a NaN pixel and a patch of zero weight."""
    rng = np.random.RandomState(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    img = rng.randn(h, w) * 0.05
    for x, y, amp, s in ((w / 2, h / 2, 3.0, 2.0), (10, 12, 2.0, 1.5),
                         (60, 50, 1.0, 3.0), (45, 20, 0.4, 0.6)):
        img += amp * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * s * s))
    img[5, 70] = np.nan
    ivm = np.full(shape, 400.0)
    ivm[40:43, 5:9] = 0.0
    return img, ivm


@pytest.mark.parametrize("kwargs", [
    {},
    {"nsigma": 5.0, "grow": 0},
    {"target_xy": (10.0, 12.0), "keep_radius": 5.0, "npixels": 2},
    {"npixels": 40, "grow": 3},
])
@pytest.mark.parametrize("with_ivm", [False, True])
def test_make_source_mask_matches_jax(kwargs, with_ivm):
    img, ivm = _field()
    args = (img, ivm) if with_ivm else (img,)
    got = tpre.make_source_mask(*args, **kwargs)
    want = jpre.make_source_mask(*args, **kwargs)
    assert got.dtype == bool and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    if not kwargs:
        assert got.any() and not got[32, 40]  # neighbours masked, target kept


def test_make_source_mask_edge_cases_match_jax():
    flat = np.zeros((16, 16))
    np.testing.assert_array_equal(tpre.make_source_mask(flat), jpre.make_source_mask(flat))
    with pytest.raises(ValueError, match="no finite pixels"):
        tpre.make_source_mask(np.full((4, 4), np.nan))


def _wcs_header(lib, shape):
    hdr = lib.Header()
    h, w = shape
    for key, value in (("CTYPE1", "RA---TAN"), ("CTYPE2", "DEC--TAN"),
                       ("CRPIX1", w / 2 + 0.5), ("CRPIX2", h / 2 + 0.5),
                       ("CRVAL1", 150.1163), ("CRVAL2", 2.2058),
                       ("CD1_1", -8.3e-6), ("CD1_2", 1.0e-6),
                       ("CD2_1", 1.0e-6), ("CD2_2", 8.3e-6)):
        hdr.set(key, value)
    return hdr


def _same_cutouts(got, want):
    for name in ("obs", "ivm", "origins", "positions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.num_targets == want.num_targets
    for hg, hw in zip(got.headers, want.headers):
        assert list(hg.keys()) == list(hw.keys())
        for key in hw.keys():
            assert hg.get(key) == hw.get(key), key
    np.testing.assert_array_equal(got.mosaic_xy(1, (2.0, 3.0)),
                                  want.mosaic_xy(1, (2.0, 3.0)))


@pytest.mark.parametrize("size", [16, (12, 20)])
def test_cutout_stack_matches_jax(size):
    img, ivm = _field(1)
    # inside, on an edge (clamped) and in a corner
    positions = np.array([[40.0, 32.0], [1.2, 30.4], [78.6, 62.9], [20.5, 10.5]])
    got = tcut.cutout_stack((_wcs_header(tfits, img.shape), img), ivm, positions, size)
    want = jcut.cutout_stack((_wcs_header(jfits, img.shape), img), ivm, positions, size)
    _same_cutouts(got, want)


def test_cutout_stack_world_positions_match_jax():
    img, ivm = _field(2)
    radec = np.array([[150.1163, 2.2058], [150.1161, 2.2059]])
    got = tcut.cutout_stack((_wcs_header(tfits, img.shape), img), ivm, radec, 16, world=True)
    want = jcut.cutout_stack((_wcs_header(jfits, img.shape), img), ivm, radec, 16, world=True)
    _same_cutouts(got, want)


@pytest.mark.parametrize("bad", [
    dict(positions=[[500.0, 3.0]], size=8),
    dict(positions=[[3.0, 3.0]], size=(200, 8)),
    dict(positions=[[3.0, 3.0]], size=0),
    dict(positions=[[np.nan, 3.0]], size=8),
    dict(positions=[1.0, 2.0, 3.0], size=8),
])
def test_cutout_stack_errors_match_jax(bad):
    img, ivm = _field(3)
    with pytest.raises(ValueError) as want:
        jcut.cutout_stack(img, ivm, **bad)
    with pytest.raises(ValueError, match=None) as got:
        tcut.cutout_stack(img, ivm, **bad)
    assert str(got.value) == str(want.value)


def _stars(seed=4, n=5, shape=(15, 15)):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(float)
    psfs, ivms = [], []
    for _ in range(n):
        s = rng.uniform(1.2, 2.6)
        p = np.exp(-((xx - 7) ** 2 + (yy - 7) ** 2) / (2 * s * s)) * rng.uniform(0.5, 3.0)
        iv = np.full(shape, 1e6) * rng.uniform(0.5, 2.0)
        p[rng.randint(15), rng.randint(15)] = np.nan  # a bad pixel each
        psfs.append(p)
        ivms.append(iv)
    positions = rng.uniform(0, 500, (n, 2))
    return psfs, ivms, positions


@pytest.mark.parametrize("method,k,power", [("idw", None, 2.0), ("idw", 3, 1.0),
                                            ("nearest", None, 2.0), ("nearest", 3, 2.0)])
def test_interpolate_psfs_matches_jax(method, k, power):
    psfs, ivms, stars = _stars()
    targets = np.concatenate([np.random.RandomState(5).uniform(0, 500, (6, 2)),
                              stars[2:3]])  # the last an exact hit
    got = tgrid.interpolate_psfs(psfs, ivms, stars, targets, method=method, k=k,
                                 power=power)
    want = jgrid.interpolate_psfs(psfs, ivms, stars, targets, method=method, k=k,
                                  power=power)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-12, atol=1e-12)
    if method == "idw":
        assert got[0].shape == (7, 15, 15)
        np.testing.assert_allclose(got[0][-1], jpre.preprocess_psf(psfs[2], ivms[2])[0]
                                   * np.isfinite(psfs[2]), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("bad", [
    dict(method="cubic"), dict(k=9), dict(star_positions=np.zeros((2, 2))),
    dict(target_positions=np.array([[np.inf, 0.0]])),
])
def test_interpolate_psfs_errors_match_jax(bad):
    psfs, ivms, stars = _stars()
    args = dict(star_psfs=psfs, star_ivms=ivms, star_positions=stars,
                target_positions=np.zeros((2, 2)))
    args.update(bad)
    with pytest.raises(ValueError) as want:
        jgrid.interpolate_psfs(**args)
    with pytest.raises(ValueError) as got:
        tgrid.interpolate_psfs(**args)
    assert str(got.value) == str(want.value)
