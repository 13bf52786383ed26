"""Host-side sky/sun math: solar position, Perez all-weather model and CIE
sunny-sky precomputations.

Mirrors the reference's skysun runtime helpers:
  - solar position: src/runtime/skysun/SunLocation.cpp (PSA algorithm,
    "Computing the Solar Vector", Blanco-Muriel et al. 2001)
  - Perez coefficients: src/runtime/skysun/PerezModel.cpp (Perez, Seals,
    Michalsky 1993 bins)
  - CIE clear/intermediate factors: src/runtime/light/CIELight.cpp:26-98
  - illuminance conversions: src/runtime/skysun/Illuminance.h

Everything here runs at scene-compile time on the host (numpy floats); the
resulting constants are baked into light_data rows / static sky dicts that the
radiance functions of light/union.py read.  A copy of ignis_tpu/light/skysun.py
(framework-neutral host code): both give the same bits.
"""

from __future__ import annotations

import math

import numpy as np

# solar constants (Illuminance.h:6-8)
SOLAR_CONSTANT_E = 1367.0    # W/m^2
SOLAR_CONSTANT_L = 127500.0  # Lux
WHITE_EFFICIENCY = 179.0     # lm/W

PI2 = math.pi / 2
DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi

# defaults (SunLocation.h:9-34)
DEFAULT_TIMEPOINT = dict(year=2020, month=5, day=6, hour=12, minute=0,
                         seconds=0.0)
DEFAULT_LOCATION = dict(latitude=49.235422, longitude=-6.9965744,
                        timezone=-2.0)


def illuminance_to_irradiance(a: float) -> float:
    return a * SOLAR_CONSTANT_E / SOLAR_CONSTANT_L


def day_of_the_year(year: int, month: int, day: int) -> int:
    """TimePoint::dayOfTheYear (SunLocation.cpp:7-15), 0-based."""
    import datetime
    return datetime.date(year, month, day).timetuple().tm_yday - 1


def compute_sun_ea(timepoint: dict, location: dict) -> tuple[float, float]:
    """computeSunEA (SunLocation.cpp:21-120) -> (elevation, azimuth) rad."""
    dec_hours = (timepoint["hour"] + location["timezone"]
                 + (timepoint["minute"] + timepoint["seconds"] / 60.0) / 60.0)
    li1 = (timepoint["month"] - 14) // 12
    li2 = ((1461 * (timepoint["year"] + 4800 + li1)) // 4
           + (367 * (timepoint["month"] - 2 - 12 * li1)) // 12
           - (3 * ((timepoint["year"] + 4900 + li1) // 100)) // 4
           + timepoint["day"] - 32075)
    julian = float(li2) - 0.5 + dec_hours / 24.0
    ejd = julian - 2451545.0

    omega = 2.1429 - 0.0010394594 * ejd
    mean_lon = 4.8950630 + 0.017202791698 * ejd
    anomaly = 6.2400600 + 0.0172019699 * ejd
    ecl_lon = (mean_lon + 0.03341607 * math.sin(anomaly)
               + 0.00034894 * math.sin(2 * anomaly) - 0.0001134
               - 0.0000203 * math.sin(omega))
    ecl_obl = 0.4090928 - 6.2140e-9 * ejd + 0.0000396 * math.cos(omega)

    sin_el = math.sin(ecl_lon)
    ra = math.atan2(math.cos(ecl_obl) * sin_el, math.cos(ecl_lon))
    if ra < 0:
        ra += 2 * math.pi
    decl = math.asin(math.sin(ecl_obl) * sin_el)

    gmst = 6.6974243242 + 0.0657098283 * ejd + dec_hours
    lmst = DEG2RAD * float(np.float32(gmst * 15 - location["longitude"]))
    lat = DEG2RAD * location["latitude"]
    hour_angle = lmst - ra
    zenith = math.acos(math.cos(lat) * math.cos(hour_angle) * math.cos(decl)
                       + math.sin(decl) * math.sin(lat))
    az = math.atan2(-math.sin(hour_angle),
                    math.tan(decl) * math.cos(lat)
                    - math.sin(lat) * math.cos(hour_angle))
    if az < 0:
        az += 2 * math.pi
    zenith += (6371.01 / 149597890.0) * math.sin(zenith)
    return PI2 - zenith, math.fmod(az + math.pi, 2 * math.pi)


def ea_to_dir(elevation: float, azimuth: float) -> np.ndarray:
    """ElevationAzimuth::toDirectionYUp (ElevationAzimuth.h:22-30)."""
    se, ce = math.sin(elevation), math.cos(elevation)
    sa, ca = math.sin(azimuth), math.cos(azimuth)
    return np.asarray([ce * sa, se, -ce * ca], np.float32)


def dir_to_ea(d) -> tuple[float, float]:
    """ElevationAzimuth::fromDirectionYUp (ElevationAzimuth.h:15-20)."""
    d = np.asarray(d, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    theta = math.acos(max(-1.0, min(1.0, float(d[1]))))
    phi = math.atan2(float(d[0]), -float(d[2]))
    return PI2 - theta, phi + 2 * math.pi if phi < 0 else phi


def get_timepoint(obj: dict) -> dict:
    tp = dict(DEFAULT_TIMEPOINT)
    for k in tp:
        if k in obj:
            tp[k] = obj[k]
    return tp


def get_location(obj: dict) -> dict:
    loc = dict(DEFAULT_LOCATION)
    for k in loc:
        if k in obj:
            loc[k] = obj[k]
    return loc


def get_ea(obj: dict) -> tuple[float, float]:
    """LoaderUtils::getEA (LoaderUtils.cpp:140-151)."""
    v = obj.get("direction", obj.get("sun_direction"))
    if v is not None:
        return dir_to_ea([float(x) for x in v])
    if "elevation" in obj or "azimuth" in obj:
        return float(obj.get("elevation", 0.0)), float(obj.get("azimuth", 0.0))
    return compute_sun_ea(get_timepoint(obj), get_location(obj))


def get_sun_direction(obj: dict) -> np.ndarray:
    """LoaderUtils::getDirection (LoaderUtils.cpp:153-156)."""
    el, az = get_ea(obj)
    return ea_to_dir(el, az)


# --------------------------------------------------------------------- Perez

# Perez/Seals/Michalsky (1993) bin tables (PerezModel.cpp:8-64)
_RANGES = np.asarray(
    [1.000, 1.065, 1.230, 1.500, 1.950, 2.800, 4.500, 6.200, np.inf])

_SA = np.asarray([
    [1.3525, -0.2576, -0.2690, -1.4366], [-1.2219, -0.7730, 1.4148, 1.1016],
    [-1.1000, -0.2515, 0.8952, 0.0156], [-0.5484, -0.6654, -0.2672, 0.7117],
    [-0.6000, -0.3566, -2.5000, 2.3250], [-1.0156, -0.3670, 1.0078, 1.4051],
    [-1.0000, 0.0211, 0.5025, -0.5119], [-1.0500, 0.0289, 0.4260, 0.3590]])
_SB = np.asarray([
    [-0.7670, 0.0007, 1.2734, -0.1233], [-0.2054, 0.0367, -3.9128, 0.9156],
    [0.2782, -0.1812, -4.5000, 1.1766], [0.7234, -0.6219, -5.6812, 2.6297],
    [0.2937, 0.0496, -5.6812, 1.8415], [0.2875, -0.5328, -3.8500, 3.3750],
    [-0.3000, 0.1922, 0.7023, -1.6317], [-0.3250, 0.1156, 0.7781, 0.0025]])
_SC = np.asarray([
    [2.8000, 0.6004, 1.2375, 1.0000], [6.9750, 0.1774, 6.4477, -0.1239],
    [24.7219, -13.0812, -37.7000, 34.8438],
    [33.3389, -18.3000, -62.2500, 52.0781],
    [21.0000, -4.7656, -21.5906, 7.2492], [14.0000, -0.9999, -7.1406, 7.5469],
    [19.0000, -5.0000, 1.2438, -1.9094],
    [31.0625, -14.5000, -46.1148, 55.3750]])
_SD = np.asarray([
    [1.8734, 0.6297, 0.9738, 0.2809], [-1.5798, -0.5081, -1.7812, 0.1080],
    [-5.0000, 1.5218, 3.9229, -2.6204], [-3.5000, 0.0016, 1.1477, 0.1062],
    [-3.5000, -0.1554, 1.4062, 0.3988], [-3.4000, -0.1078, -1.0750, 1.5702],
    [-4.0000, 0.0250, 0.3844, 0.2656], [-7.2312, 0.4050, 13.3500, 0.6234]])
_SE = np.asarray([
    [0.0356, -0.1246, -0.5718, 0.9938], [0.2624, 0.0672, -0.2190, -0.4285],
    [-0.0156, 0.1597, 0.4199, -0.5562], [0.4659, -0.3296, -0.0876, -0.0329],
    [0.0032, 0.0766, -0.0656, -0.1294], [-0.0672, 0.4016, 0.3017, -0.4844],
    [1.0468, -0.3788, -2.4517, 1.4656], [1.5000, -0.6426, 1.8564, 0.5636]])

# Radiance 145-patch integration base (PerezModel.cpp:87-110)
_THETA_BASE = np.concatenate([
    np.full(30, 84.0), np.full(30, 72.0), np.full(24, 60.0),
    np.full(24, 48.0), np.full(18, 36.0), np.full(12, 24.0),
    np.full(6, 12.0), [0.0]])
_PHI_BASE = np.concatenate([
    np.arange(30) * 12.0, np.arange(30) * 12.0, np.arange(24) * 15.0,
    np.arange(24) * 15.0, np.arange(18) * 20.0, np.arange(12) * 30.0,
    np.arange(6) * 60.0, [0.0]])


def perez_eval(a, b, c, d, e, cos_sun, cos_theta):
    """PerezModel::eval / calc_perez (cie.art:41-47), numpy-vectorized."""
    sun_a = np.arccos(np.clip(cos_sun, -1.0, 1.0))
    A = 1 + a * np.exp(b / np.maximum(0.01, cos_theta))
    B = 1 + c * np.exp(d * sun_a) + e * cos_sun * cos_sun
    return A * B


def perez_integrate(a, b, c, d, e, solar_zenith: float) -> float:
    """PerezModel::integrate, Radiance 145-base variant
    (PerezModel.cpp:75-120)."""
    cs, ss = math.cos(solar_zenith), math.sin(solar_zenith)
    th = _THETA_BASE * DEG2RAD
    ph = _PHI_BASE * DEG2RAD
    ct, st, cp = np.cos(th), np.sin(th), np.cos(ph)
    cos_sun = np.minimum(1.0, cs * ct + ss * st * cp)
    vals = perez_eval(a, b, c, d, e, cos_sun, ct) * ct
    return float(2 * math.pi * vals.sum() / len(vals))


def _air_mass(solar_zenith: float) -> float:
    sz_deg = min(RAD2DEG * solar_zenith, 90.0)
    return 1.0 / (math.cos(DEG2RAD * sz_deg)
                  + 0.15 * math.exp(math.log(93.885 - sz_deg) * -1.253))


def _eccentricity(day_of_year: int) -> float:
    da = 2 * math.pi * min(max(day_of_year / 365.0, 0.0), 1.0)
    return (1.00011 + 0.034221 * math.cos(da) + 0.00128 * math.sin(da)
            + 0.000719 * math.cos(2 * da) + 0.000077 * math.sin(2 * da))


def sky_brightness(diff_irrad, solar_zenith, doy) -> float:
    return diff_irrad * _air_mass(solar_zenith) / (
        SOLAR_CONSTANT_E * _eccentricity(doy))


def sky_clearness(diff_irrad, direct_irrad, solar_zenith) -> float:
    A = 1.041 * solar_zenith ** 3
    return ((diff_irrad + direct_irrad) / diff_irrad + A) / (1 + A)


def diffuse_irradiance(brightness, solar_zenith, doy) -> float:
    return brightness * SOLAR_CONSTANT_E * _eccentricity(doy) / _air_mass(
        solar_zenith)


def perez_from_sky(brightness: float, clearness: float,
                   solar_zenith: float) -> tuple:
    """PerezModel::fromSky (PerezModel.cpp:154-183)."""
    if 1.065 < clearness < 2.8 and brightness < 0.2:
        brightness = 0.2
    brightness = min(max(brightness, 0.01), 0.6)

    bin_ = 0
    for bin_ in range(8):
        if _RANGES[bin_] <= clearness < _RANGES[bin_ + 1]:
            break

    def comp(x):
        return x[0] + x[1] * solar_zenith + brightness * (
            x[2] + x[3] * solar_zenith)

    a = comp(_SA[bin_])
    b = comp(_SB[bin_])
    if bin_ > 0:
        c = comp(_SC[bin_])
        d = comp(_SD[bin_])
    else:
        c = math.exp((brightness * (_SC[0, 0] + _SC[0, 1] * solar_zenith))
                     ** _SC[0, 2]) - _SC[0, 3]
        d = -math.exp(brightness * (_SD[0, 0] + _SD[0, 1] * solar_zenith)) \
            + _SD[0, 2] + brightness * _SD[0, 3]
    e = comp(_SE[bin_])
    return float(a), float(b), float(c), float(d), float(e)


def perez_model_from_obj(lobj: dict, solar_zenith: float,
                         timepoint: dict) -> tuple:
    """getModel (PerezLight.cpp:25-58) -> ((a,b,c,d,e), diffuse_irradiance)."""
    doy = day_of_the_year(timepoint["year"], timepoint["month"],
                          timepoint["day"])

    def num(k, dflt):
        v = lobj.get(k, dflt)
        return float(v) if isinstance(v, (int, float)) else float(dflt)

    if "clearness" in lobj or "brightness" in lobj:
        br = num("brightness", 0.2)
        model = perez_from_sky(br, num("clearness", 1.0), solar_zenith)
        return model, diffuse_irradiance(br, solar_zenith, doy)
    if "direct_irradiance" in lobj or "diffuse_irradiance" in lobj:
        diff = num("diffuse_irradiance", 1.0)
        model = perez_from_sky(
            sky_brightness(diff, solar_zenith, doy),
            sky_clearness(diff, num("direct_irradiance", 1.0), solar_zenith),
            solar_zenith)
        return model, diff
    if "direct_illuminance" in lobj or "diffuse_illuminance" in lobj:
        diff = illuminance_to_irradiance(num("diffuse_illuminance", 1.0))
        model = perez_from_sky(
            sky_brightness(diff, solar_zenith, doy),
            sky_clearness(diff,
                          illuminance_to_irradiance(
                              num("direct_illuminance", 1.0)), solar_zenith),
            solar_zenith)
        return model, illuminance_to_irradiance(num("diffuse_illuminance",
                                                    1.0))
    model = (num("a", 1.0), num("b", 1.0), num("c", 1.0), num("d", 1.0),
             num("e", 1.0))
    return model, 1.0


# ---------------------------------------------------------------- CIE sunny

def _skylight_norm(altitude: float, clear: bool) -> float:
    """skylight_normalization_factor (CIELight.cpp:27-38)."""
    clear_a = [2.766521, 0.547665, -0.369832, 0.009237, 0.059229]
    interm_a = [3.5556, -2.7152, -1.3081, 1.0660, 0.60227]
    arr = clear_a if clear else interm_a
    x = (altitude - math.pi / 4) / (math.pi / 4)
    f = arr[4]
    for i in range(3, -1, -1):
        f = f * x + arr[i]
    return f


def cie_sunny_params(is_clear: bool, is_intermediate: bool, elevation: float,
                     sun_y: float, turbidity: float) -> tuple[float, float]:
    """CIELight::serialize clear/intermediate precompute
    (CIELight.cpp:66-98) -> (zenith_brightness/factor, c2)."""
    elevation = min(elevation, 87 * DEG2RAD)
    sky_illum = 203.0
    zb = (1.376 * turbidity - 1.81) * math.tan(elevation) + 0.38
    if is_intermediate:
        zb = (zb + 8.6 * sun_y + 0.123) / 2
    zb = max(0.0, zb * 1000 / sky_illum)

    if is_clear:
        factor = 0.274 * (0.91 + 10 * math.exp(-3 * (PI2 - elevation))
                          + 0.45 * sun_y * sun_y)
    else:
        factor = ((2.739 + 0.9891 * math.sin(0.3119 + 2.6 * elevation))
                  * math.exp(-(PI2 - elevation) * (0.4441 + 1.48 * elevation)))

    norm = _skylight_norm(elevation, is_clear) / math.pi / factor
    sun_illum = 208.0
    solar_b = 1.5e9 / sun_illum * (1.147 - 0.147 / max(sun_y, 0.16))
    additive = (6e-5 / math.pi * solar_b * sun_y
                * (1.0 if is_clear else 0.15))
    c2 = zb * norm + additive
    return zb / max(factor, 1e-20), c2
