"""CT / pseudo-CT Hounsfield-unit to acoustic-property mappings.

Re-implements the seven mapping methods of the reference
(`TranscranialModeling/BabelIntegrationBASE.py:210-644,1193-1239`):
``Webb-Marsac`` (default), ``Aubry``, ``Pichardo``, ``McDannold``,
``Marsac-Aubry``, ``Pichardo-Marsac``, ``McDannold-Marsac`` — each maps the
quantized unique-HU vector of a skull CT to per-HU density, longitudinal
speed of sound, and longitudinal attenuation.

All constants are published calibrations (citations inline). Pure NumPy.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

MAPPING_METHODS = (
    "Webb-Marsac",
    "Aubry",
    "Pichardo",
    "McDannold",
    "Marsac-Aubry",
    "Pichardo-Marsac",
    "McDannold-Marsac",
)

# Webb et al. IEEE TUFFC 65(7):1111 (2018) Tables I/II and IEEE TUFFC
# 68(5):1532 (2020) Table IV; default scanner combo GE / 120 kVp / BonePlus
# kernel / axial 0.5, slice 0.6 (the reference's default `CTMapCombo`,
# `BabelIntegrationBASE.py:1091`). The full 75-row scanner-parameter tables
# (every scanner/energy/kernel combination the reference supports) ship as
# package data extracted from the published calibration CSVs
# (`WebbHU_SoS.csv` / `WebbHU_Att.csv`, loaders `:494-589`).
WEBB_DEFAULT_COMBO = ("GE", "120", "B", "", "0.5, 0.6")


@functools.lru_cache(maxsize=1)
def _webb_tables():
    z = np.load(os.path.join(_DATA, "webb_tables.npz"))
    sos = {
        tuple(k.split("|")): (s, i)
        for k, s, i in zip(z["sos_keys"], z["sos_slope"], z["sos_intercept"])
    }
    att = {
        tuple(k.split("|")): (a, b, c)
        for k, a, b, c in zip(z["att_keys"], z["att_alpha0"], z["att_beta"], z["att_c"])
    }
    return sos, att


def webb_combos() -> list[tuple]:
    """All scanner/energy/kernel calibration combos with both SoS and
    attenuation rows (user-selectable like the reference's ``CTMapCombo``)."""
    sos, att = _webb_tables()
    return sorted(set(sos) & set(att))


def hu_to_long_sos_webb(hu, combo=WEBB_DEFAULT_COMBO):
    """HU -> longitudinal SoS (m/s); Webb 2018 calibration table
    (`BabelIntegrationBASE.py:555-589`): slope*HU + intercept_km/s*1000."""
    slope, intercept = _webb_tables()[0][tuple(combo)]
    return slope * np.asarray(hu, np.float64) + intercept * 1000.0


def hu_to_attenuation_webb(hu, frequency, combo=WEBB_DEFAULT_COMBO):
    """HU -> longitudinal attenuation (Np/m); Webb 2020 exponential model
    (`BabelIntegrationBASE.py:494-534`).

    alpha = alpha_0 * (f/MHz)^beta * exp(c*HU), alpha_0 in Np/cm -> x100 Np/m.
    """
    a0, beta, c = _webb_tables()[1][tuple(combo)]
    hu = np.asarray(hu, np.float64)
    return a0 * (frequency / 1e6) ** beta * np.exp(hu * c) * 100.0


def hu_to_density_marsac(hu):
    """HU -> density; Marsac 2017 linear normalization between water/air and
    max bone (`BabelIntegrationBASE.py:305-323`)."""
    hu = np.asarray(hu, np.float64)
    rho_min, rho_max = 1000.0, 2700.0
    return rho_min + (rho_max - rho_min) * hu / hu.max()


def hu_to_density_air_tissue(hu):
    """HU -> density via linear air(-1000 HU, 1.293)/tissue(27 HU, 1041) fit
    (`BabelIntegrationBASE.py:276-303`)."""
    return np.polyval(np.array([1.01237293, 1.01366593e3]), np.asarray(hu, np.float64))


def hu_to_density_kwave(hu):
    """HU -> density, k-Wave hounsfield2density piecewise-linear model
    (Schneider 1996 / Mast 2000; `BabelIntegrationBASE.py:237-274`)."""
    hu_shift = np.asarray(hu, np.float64) + 1000.0
    density = np.zeros_like(hu_shift)
    m = hu_shift < 930
    density[m] = np.polyval([1.025793065681423, -5.680404011488714], hu_shift[m])
    m = (hu_shift >= 930) & (hu_shift <= 1098)
    density[m] = np.polyval([0.9082709691264, 103.6151457847139], hu_shift[m])
    m = (hu_shift > 1098) & (hu_shift < 1260)
    density[m] = np.polyval([0.5108369316599, 539.9977189228704], hu_shift[m])
    m = hu_shift >= 1260
    density[m] = np.polyval([0.6625370912451, 348.8555178455294], hu_shift[m])
    return density


def hu_to_porosity(hu):
    """HU -> porosity, Aubry 2003 model (`BabelIntegrationBASE.py:422-437`)."""
    hu = np.asarray(hu, np.float64)
    return 1.0 - hu / hu.max()


def porosity_to_density(phi):
    """Porosity -> density (`BabelIntegrationBASE.py:439-454`)."""
    phi = np.asarray(phi, np.float64)
    return 1000.0 * phi + 2200.0 * (1.0 - phi)


def porosity_to_long_sos(phi):
    """Porosity -> longitudinal SoS (`BabelIntegrationBASE.py:456-471`)."""
    phi = np.asarray(phi, np.float64)
    return 1500.0 * phi + 3100.0 * (1.0 - phi)


def porosity_to_long_att(phi, frequency):
    """Porosity -> longitudinal attenuation Np/m
    (`BabelIntegrationBASE.py:473-492`)."""
    phi = np.asarray(phi, np.float64)
    amin = 2.302555836 * frequency / 1e6
    amax = 92.10223344 * frequency / 1e6
    return amin + (amax - amin) * np.sqrt(phi)


def density_to_long_sos_mcdannold(density):
    """Density -> longitudinal SoS, McDannold polynomial
    (`BabelIntegrationBASE.py:405-420`)."""
    poly = np.flip(np.array([1.24e-3, -7.63e-7, 1.69e-10, 5.31e-16, -2.79e-18]))
    return 1.0 / np.polyval(poly, np.asarray(density, np.float64))


def density_to_long_att_mcdannold(density, frequency):
    """Density -> longitudinal attenuation (Np/m), McDannold polynomial at
    660 kHz with linear frequency scaling (`BabelIntegrationBASE.py:383-403`)."""
    poly = np.flip(np.array([5.71e3, -9.02, 5.40e-3, -1.41e-6, 1.36e-10]))
    return np.polyval(poly, np.asarray(density, np.float64)) * frequency / 660e3


@functools.lru_cache(maxsize=1)
def _pichardo_map():
    z = np.load(os.path.join(_DATA, "pichardo_map.npz"))
    return z["rho"], z["freq_mhz"], z["sos"], z["att"]


def _bilinear_extrap(xg, yg, z, xq, yq):
    """Bilinear interpolation with linear extrapolation outside the grid —
    the semantics of ``RectBivariateSpline(kx=1, ky=1)`` the reference builds
    over the Pichardo map (`BabelIntegrationBASE.py:61-69`)."""
    xq = np.asarray(xq, np.float64)
    yq = np.asarray(yq, np.float64)
    ix = np.clip(np.searchsorted(xg, xq) - 1, 0, len(xg) - 2)
    iy = np.clip(np.searchsorted(yg, yq) - 1, 0, len(yg) - 2)
    tx = (xq - xg[ix]) / (xg[ix + 1] - xg[ix])  # unclipped -> extrapolates
    ty = (yq - yg[iy]) / (yg[iy + 1] - yg[iy])
    z00, z01 = z[ix, iy], z[ix, iy + 1]
    z10, z11 = z[ix + 1, iy], z[ix + 1, iy + 1]
    return (
        z00 * (1 - tx) * (1 - ty)
        + z10 * tx * (1 - ty)
        + z01 * (1 - tx) * ty
        + z11 * tx * ty
    )


def density_to_sos_pichardo(density, frequency):
    """Density -> long SoS, bilinear interp of the Pichardo density/frequency
    map (`BabelIntegrationBASE.py:590-606`). Uses the measured 500x500
    (density 1242-2900 kg/m3, frequency 0.1-1 MHz) calibration grid shipped
    as package data (extracted from the published `MapPichardo.h5`).

    The map arrays are stored as [frequency, density] — SoS rises strongly
    with density (1715 -> 3767 m/s) and weakly with frequency, and the
    reference's legacy ``interp2d(rho, freq, MapSoS)`` branch consumes
    exactly that layout (interp2d expects z as (len(y), len(x))). Its
    scipy>1.14 ``RectBivariateSpline(rho, freq, MapSoS)`` branch
    (`BabelIntegrationBASE.py:62-65`) transposes the axes, which makes SoS
    nearly density-independent — we implement the physically-correct
    (legacy/published) orientation."""
    rho, fmhz, sos, _ = _pichardo_map()
    return _bilinear_extrap(fmhz, rho, sos, float(frequency) / 1e6, density)


def density_to_att_pichardo(density, frequency):
    """Density -> long attenuation (Np/m); Pichardo calibration map
    (`BabelIntegrationBASE.py:608-624`), bilinear on the measured
    [frequency, density] grid (see density_to_sos_pichardo on layout)."""
    rho, fmhz, _, att = _pichardo_map()
    return _bilinear_extrap(fmhz, rho, att, float(frequency) / 1e6, density)


def hu_to_density_ucl_lowdose(hu):
    """HU -> density via the UCL low-dose PETRA-to-CT calibration table
    (`BabelIntegrationBASE.py:325-344`; github.com/ucl-bug/petra-to-ct)."""
    z = np.load(os.path.join(_DATA, "ucl_lowdose.npz"))
    return np.interp(np.asarray(hu, np.float64), z["hu"], z["density"])


def density_to_lsos_marsac(density):
    """Density -> long SoS, Marsac linear min-max map
    (`BabelIntegrationBASE.py:363-381`)."""
    density = np.asarray(density, np.float64)
    cmin, cmax = 1500.0, 3000.0
    return cmin + (cmax - cmin) * (density - density.min()) / (
        density.max() - density.min()
    )


def simnibs_petra_density(hu):
    """PETRA pseudo-CT HU -> density (SimNIBS cph2025 calibration line,
    `BabelIntegrationBASE.py:346-360`): piecewise-linear interpolation of the
    published calibration points extended by the (3150 HU, 3147.35 kg/m3)
    cap, floored at water density."""
    z = np.load(os.path.join(_DATA, "cph2025_line.npz"))
    hu_pts = np.append(z["hu"], 3150.0)
    rho_pts = np.append(z["density"], 3147.35469785)
    rho = np.interp(np.asarray(hu, np.float64), hu_pts, rho_pts)
    return np.maximum(rho, 1000.0)


def density_to_hu_bony(density):
    """Bone density (kg/m3) -> HU, piecewise-linear through the reference's
    8-point CT/density calibration (`BabelIntegrationBASE.py:210-234`, which
    fits a pwlf with breaks exactly at the data points), linearly
    extrapolated at both ends."""
    pts_hu = np.array([-947.030278, 52.0388482, 202.749650, 810.468261,
                       1003.99419, 1234.90136, 1419.01214, 1659.90448])
    pts_rho = np.array([1.225, 1060.0, 1160.0, 1530.0, 1660.0, 1820.0,
                        1990.0, 2150.0])
    rho = np.asarray(density, np.float64)
    i = np.clip(np.searchsorted(pts_rho, rho) - 1, 0, len(pts_rho) - 2)
    t = (rho - pts_rho[i]) / (pts_rho[i + 1] - pts_rho[i])
    return pts_hu[i] * (1 - t) + pts_hu[i + 1] * t


def map_hu_to_properties(
    unique_hu: np.ndarray,
    frequency: float,
    method: str = "Webb-Marsac",
    *,
    is_petra: bool = False,
    density_input: np.ndarray | None = None,
    webb_combo=WEBB_DEFAULT_COMBO,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map the quantized unique-HU vector to (density, long SoS, long att).

    Dispatch mirrors `BabelIntegrationBASE.py:1193-1239`. Shear is disabled in
    CT mode (as in the reference, `:1343-1344`). When ``density_input`` is
    given the CT volume already holds density (``bDensity`` path).
    """
    hu = np.asarray(unique_hu, np.float64)
    if density_input is not None:
        # ``bDensity`` path (`BabelIntegrationBASE.py:1184-1190`): the input
        # volume already holds density; recover HU for the HU-based models.
        density = np.asarray(density_input, np.float64)
        hu = density_to_hu_bony(density)
    phi = hu_to_porosity(hu)

    if density_input is not None:
        pass
    elif method == "Webb-Marsac" and is_petra:
        density = simnibs_petra_density(hu)
    elif method in ("Webb-Marsac", "Marsac-Aubry", "Pichardo-Marsac", "McDannold-Marsac"):
        density = hu_to_density_marsac(hu)
    elif method == "Aubry":
        density = porosity_to_density(phi)
    elif method in ("Pichardo", "McDannold"):
        density = hu_to_density_air_tissue(hu)
    else:
        raise ValueError(f"Unknown mapping method: {method}")

    if method == "Webb-Marsac":
        sos = hu_to_long_sos_webb(hu, webb_combo)
        att = hu_to_attenuation_webb(hu, frequency, webb_combo)
    elif method == "Aubry":
        sos = porosity_to_long_sos(phi)
        att = porosity_to_long_att(phi, frequency)
    elif method == "Pichardo" or method == "Pichardo-Marsac":
        sos = density_to_sos_pichardo(density, frequency)
        att = density_to_att_pichardo(density, frequency)
    elif method == "McDannold" or method == "McDannold-Marsac":
        sos = density_to_long_sos_mcdannold(density)
        att = density_to_long_att_mcdannold(density, frequency)
    elif method == "Marsac-Aubry":
        sos = density_to_lsos_marsac(density)
        att = porosity_to_long_att(hu, frequency)

    return density, sos, att


def quantize_hu(
    hu_volume: np.ndarray, bone_mask: np.ndarray, bits: int = 10
) -> tuple[np.ndarray, np.ndarray]:
    """Quantize bone HU values to 2**bits - 1 levels and return
    ``(unique_hu, index_volume)``.

    This is the data path that makes CT-mode FDTD tractable (one material per
    quantized HU; the reference uses the same 10-bit default,
    `BabelBrain/BabelDatasetPreps.py:1019-1045`). ``index_volume`` is 0 where
    ``bone_mask`` is False and the 0-based quantization index elsewhere.
    """
    levels = (1 << bits) - 1
    vals = hu_volume[bone_mask].astype(np.float64)
    if vals.size == 0:
        return np.zeros(0), np.zeros(hu_volume.shape, np.uint32)
    lo, hi = vals.min(), vals.max()
    edges = np.linspace(lo, hi, levels)
    idx = np.clip(np.searchsorted(edges, vals, side="left"), 0, levels - 1)
    unique_idx = np.unique(idx)
    remap = np.zeros(levels, np.uint32)
    remap[unique_idx] = np.arange(len(unique_idx), dtype=np.uint32)
    unique_hu = edges[unique_idx]
    out = np.zeros(hu_volume.shape, np.uint32)
    out[bone_mask] = remap[idx]
    return unique_hu, out
