"""The port's host-side light tables against the JAX package's: the
sky / sun helpers, the Hosek-Wilkie sky bake, the environment CDF builders
and the light hierarchy build.  All of it is numpy on both sides, so every
result must be EQUAL (tolerance 0)."""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from ignis_tpu.light import env_cdf as jcdf
from ignis_tpu.light import hierarchy as jh
from ignis_tpu.light import hosek as jhosek
from ignis_tpu.light import skysun as jsky
from ignis_tpu_torch.light import env_cdf as tcdf
from ignis_tpu_torch.light import hierarchy as th
from ignis_tpu_torch.light import hosek as thosek
from ignis_tpu_torch.light import skysun as tsky

TIMEPOINTS = [dict(year=y, month=m, day=d, hour=h, minute=mi, seconds=s)
              for y, m, d, h, mi, s in [
                  (2020, 5, 6, 12, 0, 0.0), (2021, 12, 21, 8, 30, 15.0),
                  (1999, 1, 1, 0, 0, 0.0), (2024, 2, 29, 17, 45, 59.5),
                  (2030, 7, 15, 6, 10, 0.0)]]
LOCATIONS = [dict(latitude=la, longitude=lo, timezone=tz)
             for la, lo, tz in [(49.235422, -6.9965744, -2.0),
                                (-33.9, -18.4, -2.0), (64.1, 21.9, 0.0),
                                (0.0, 0.0, 0.0), (35.7, -139.7, -9.0)]]
ELEVATIONS = np.linspace(-0.2, 1.55, 8)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def _sky_obj_cases():
    objs = [{}, {"elevation": 0.4}, {"azimuth": 2.0},
            {"elevation": 1.1, "azimuth": 5.5},
            {"direction": [0.3, 0.8, -0.4]},
            {"sun_direction": [-0.1, 0.2, 0.9]},
            {"year": 2022, "month": 9, "day": 23, "hour": 15,
             "latitude": 10.0, "longitude": 70.0, "timezone": 5.0}]
    return objs


# one case per public function of skysun, each on its grid of inputs
SKYSUN = {
    "illuminance_to_irradiance": lambda m: [
        m.illuminance_to_irradiance(a) for a in (0.0, 1.0, 12345.6, 1e5)],
    "day_of_the_year": lambda m: [
        m.day_of_the_year(t["year"], t["month"], t["day"])
        for t in TIMEPOINTS],
    "compute_sun_ea": lambda m: [
        m.compute_sun_ea(t, l) for t in TIMEPOINTS for l in LOCATIONS],
    "ea_to_dir": lambda m: [
        m.ea_to_dir(e, a) for e in ELEVATIONS for a in (0.0, 1.3, 4.0)],
    "dir_to_ea": lambda m: [
        m.dir_to_ea(d) for d in ([0, 1, 0], [0.3, 0.2, -0.9], [1, 0, 0],
                                 [-0.2, -0.5, 0.4], [0, 0, 0])],
    "get_timepoint": lambda m: [m.get_timepoint(o)
                                for o in _sky_obj_cases()],
    "get_location": lambda m: [m.get_location(o) for o in _sky_obj_cases()],
    "get_ea": lambda m: [m.get_ea(o) for o in _sky_obj_cases()],
    "get_sun_direction": lambda m: [m.get_sun_direction(o)
                                    for o in _sky_obj_cases()],
    "perez_eval": lambda m: [m.perez_eval(
        -1.0, -0.3, 8.0, -2.5, 0.4, np.linspace(-1, 1, 9),
        np.linspace(-0.2, 1, 9))],
    "perez_integrate": lambda m: [
        m.perez_integrate(-1.0, -0.3, c, -2.5, 0.4, z)
        for c in (2.0, 8.0) for z in (0.2, 0.9, 1.4)],
    "sky_brightness": lambda m: [
        m.sky_brightness(d, z, doy) for d in (50.0, 200.0)
        for z in (0.3, 1.2) for doy in (0, 180, 364)],
    "sky_clearness": lambda m: [
        m.sky_clearness(d, r, z) for d in (50.0, 200.0)
        for r in (0.0, 400.0, 800.0) for z in (0.3, 1.2)],
    "diffuse_irradiance": lambda m: [
        m.diffuse_irradiance(b, z, doy) for b in (0.05, 0.3)
        for z in (0.3, 1.2) for doy in (0, 200)],
    "perez_from_sky": lambda m: [
        m.perez_from_sky(b, c, z) for b in (0.005, 0.15, 0.3, 0.9)
        for c in (1.0, 1.1, 1.6, 3.0, 5.0, 7.0) for z in (0.2, 1.0)],
    "perez_model_from_obj": lambda m: [
        m.perez_model_from_obj(o, z, t) for o in (
            {}, {"clearness": 2.0, "brightness": 0.25},
            {"brightness": 0.1},
            {"direct_irradiance": 500.0, "diffuse_irradiance": 120.0},
            {"diffuse_illuminance": 20000.0, "direct_illuminance": 60000.0},
            {"a": -1.1, "b": -0.2, "c": 4.0, "d": -1.5, "e": 0.3})
        for z in (0.4, 1.1) for t in TIMEPOINTS[:2]],
    "cie_sunny_params": lambda m: [
        m.cie_sunny_params(c, not c, e, sy, tb) for c in (True, False)
        for e in ELEVATIONS for sy in (0.1, 0.5, 0.95)
        for tb in (2.45, 4.0)],
}


@pytest.mark.parametrize("name", sorted(SKYSUN))
def test_skysun_equal(name):
    _same(SKYSUN[name](tsky), SKYSUN[name](jsky))


def test_skysun_constants_equal():
    for k in ("SOLAR_CONSTANT_E", "SOLAR_CONSTANT_L", "WHITE_EFFICIENCY",
              "DEFAULT_TIMEPOINT", "DEFAULT_LOCATION", "_RANGES", "_SA",
              "_SB", "_SC", "_SD", "_SE", "_THETA_BASE", "_PHI_BASE"):
        _same(getattr(tsky, k), getattr(jsky, k))


def test_hosek_data_is_the_packages_own_copy():
    """The port reads the Hosek coefficients from its own package, and the
    two copies of the file are the same bytes."""
    import ignis_tpu_torch
    own = Path(ignis_tpu_torch.__file__).parent / "data" / "hosek_rgb.npz"
    import ignis_tpu
    ref = Path(ignis_tpu.__file__).parent / "data" / "hosek_rgb.npz"
    assert filecmp.cmp(own, ref, shallow=False)
    thosek._DATA = None
    d = thosek._data()
    assert Path(d.zip.filename).resolve() == own.resolve()
    for k in ("config", "radiance"):
        np.testing.assert_array_equal(d[k], jhosek._data()[k])


@pytest.mark.parametrize("turbidity", [1.7, 3.0, 9.4])
@pytest.mark.parametrize("albedo", [0.8, (0.1, 0.5, 0.9)])
def test_bake_sky_image_equal(turbidity, albedo):
    for el, az in ((0.6, 0.3), (1.2, 4.0)):
        got = thosek.bake_sky_image(np.asarray(albedo, np.float64), el, az,
                                    turbidity)
        ref = jhosek.bake_sky_image(np.asarray(albedo, np.float64), el, az,
                                    turbidity)
        assert got.dtype == np.float32 and got.shape == (256, 512, 3)
        np.testing.assert_array_equal(got, ref)


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 2, (h, w, 3)).astype(np.float32) ** 3
    img[rng.integers(0, h), rng.integers(0, w)] = 80.0
    img[h // 3, :] = 0.0
    return img


@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("shape", [(8, 16), (33, 70), (256, 512)])
def test_cdf_builders_equal(compensate, shape):
    img = _image(shape[0], *shape)
    _same(tcdf.build_cdf2d(img, compensate=compensate),
          jcdf.build_cdf2d(img, compensate=compensate))
    _same(tcdf.build_cdf2d(img, premultiply_sin=False,
                           compensate=compensate),
          jcdf.build_cdf2d(img, premultiply_sin=False,
                           compensate=compensate))
    sat = tcdf.build_sat2d(img, compensate=compensate)
    _same(sat, jcdf.build_sat2d(img, compensate=compensate))
    _same(tcdf.sat_to_cdf(sat), jcdf.sat_to_cdf(sat))
    # a black image takes the uniform fallbacks
    black = np.zeros(shape + (3,), np.float32)
    _same(tcdf.build_cdf2d(black, compensate=compensate),
          jcdf.build_cdf2d(black, compensate=compensate))
    _same(tcdf.build_sat2d(black, compensate=compensate),
          jcdf.build_sat2d(black, compensate=compensate))


@pytest.mark.parametrize("n", [2, 3, 16, 257, 1024])
@pytest.mark.parametrize("with_dirs", [False, True])
def test_build_light_hierarchy_equal(n, with_dirs):
    rng = np.random.default_rng(n)
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pos[n // 2] = pos[0]                       # coincident lights
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    has = rng.uniform(size=n) < 0.5 if with_dirs else np.zeros(n, bool)
    flux = rng.uniform(0.01, 10, n).astype(np.float32)
    got, gd = th.build_light_hierarchy(pos, dirs, has, flux)
    ref, rd = jh.build_light_hierarchy(pos, dirs, has, flux)
    assert gd == rd
    _same(got, ref)
    assert got["lh_codes"].dtype == np.uint32
