"""Frequency-indexed acoustic tissue property database.

Re-implements the literature-fit material model of the reference
(`TranscranialModeling/BabelIntegrationBASE.py:71-167`): for each tissue a
5-vector ``[density (kg/m^3), long. SoS (m/s), shear SoS (m/s),
long. attenuation (Np/m), shear attenuation (Np/m)]`` valid for
100-1120 kHz.

Anchor data (all published literature values, cited per function):
  * Shear speeds in bone: Pichardo et al., Phys Med Biol 62(17):6938 (2017).
  * Longitudinal speeds in bone: Pichardo et al., Phys Med Biol 56(1):219 (2011).
  * Bone attenuation: Goss et al. JASA 64(2) (1978) + Webb et al.
    IEEE TUFFC 68(5):1532 (2020) multi-study fit.
  * Soft-tissue properties: IT'IS database + Labuda 2022.

All functions are pure NumPy (host-side, called once per simulation setup).
"""

from __future__ import annotations

import numpy as np

DB_TO_NEPER = 1.0 / (20.0 * np.log10(np.e))

FREQ_MIN = 100e3
FREQ_MAX = 1120e3
FREQ_STEP = 5e3

TISSUES = (
    "Water",
    "Cortical",
    "Trabecular",
    "Skin",
    "Brain",
    "WhiteMatter",
    "GrayMatter",
    "CSF",
)

# Column indices of the 5-vector
DENSITY, LONG_SOS, SHEAR_SOS, LONG_ATT, SHEAR_ATT = range(5)


def _linfit_eval(f_ref: np.ndarray, v_ref: np.ndarray, frequency) -> np.ndarray:
    p = np.polyfit(f_ref, v_ref, 1)
    return np.round(np.polyval(p, frequency))


def fit_speed_cortical_shear(frequency):
    """Shear SoS in cortical bone; Pichardo 2017 two-frequency anchors."""
    f_ref = np.array([270e3, 836e3])
    cs = np.array(
        [np.mean([1577.0, 1498.0, 1313.0]), np.mean([1758.0, 1674.0, 1545.0])]
    )
    return _linfit_eval(f_ref, cs, frequency)


def fit_speed_trabecular_shear(frequency):
    """Shear SoS in trabecular bone; Pichardo 2017 anchors."""
    f_ref = np.array([270e3, 836e3])
    cs = np.array(
        [np.mean([1227.0, 1365.0, 1200.0]), np.mean([1574.0, 1252.0, 1327.0])]
    )
    return _linfit_eval(f_ref, cs, frequency)


def fit_speed_cortical_long(frequency):
    """Longitudinal SoS in cortical bone; Pichardo 2011 anchors."""
    return _linfit_eval(np.array([270e3, 836e3]), np.array([2448.0, 2516.0]), frequency)


def fit_speed_trabecular_long(frequency):
    """Longitudinal SoS in trabecular bone; Pichardo 2011 anchors."""
    return _linfit_eval(np.array([270e3, 836e3]), np.array([2140.0, 2300.0]), frequency)


def fit_att_bone_shear(frequency, reduction_factor=1.0):
    """Shear attenuation in bone (Np/m); Pichardo 2017, linear in frequency."""
    pichardo = (57.0 / 0.27 + 373.0 / 0.836) / 2.0
    return np.round(pichardo * (np.asarray(frequency) / 1e6) * reduction_factor)


def fit_att_cortical_long(frequency, bcoeff=1.0, reduction_factor=0.8):
    """Longitudinal attenuation cortical bone (Np/m); Goss/Pichardo/Webb fit."""
    return np.round(203.25090263 * ((np.asarray(frequency) / 1e6) ** bcoeff) * reduction_factor)


def fit_att_trabecular_long(frequency, bcoeff=1.0, reduction_factor=0.8):
    """Longitudinal attenuation trabecular bone (Np/m); Goss/Pichardo/Webb fit."""
    return np.round(202.76362433 * ((np.asarray(frequency) / 1e6) ** bcoeff) * reduction_factor)


def tissue_properties(frequency: float) -> dict:
    """Return {tissue: 5-vector} at a given frequency in Hz.

    Mirrors the per-frequency table of the reference
    (`BabelIntegrationBASE.py:140-167`); valid for 100-1120 kHz.
    """
    f = float(frequency)
    if not (FREQ_MIN <= f <= FREQ_MAX):
        raise ValueError(
            f"frequency {f} outside supported range [{FREQ_MIN}, {FREQ_MAX}] Hz"
        )
    props = {
        "Water": np.array([1000.0, 1500.0, 0.0, 0.0, 0.0]),
        "Cortical": np.array(
            [
                1896.5,
                fit_speed_cortical_long(f),
                fit_speed_cortical_shear(f),
                fit_att_cortical_long(f),
                fit_att_bone_shear(f),
            ]
        ),
        "Trabecular": np.array(
            [
                1738.0,
                fit_speed_trabecular_long(f),
                fit_speed_trabecular_shear(f),
                fit_att_trabecular_long(f),
                fit_att_bone_shear(f),
            ]
        ),
        "Skin": np.array([1116.0, 1537.0, 0.0, 2.3 * f / 500e3, 0.0]),
        "Brain": np.array([1041.0, 1562.0, 0.0, 3.45 * f / 500e3, 0.0]),
        # Labuda 2022 for SoS/attenuation, IT'IS for density
        "WhiteMatter": np.array([1041.0, 1537.0, 0.0, 10.1772968 * f / 1000e3, 0.0]),
        "GrayMatter": np.array([1045.0, 1520.0, 0.0, 4.397881647 * f / 1000e3, 0.0]),
        "CSF": np.array([1007.0, 1507.0, 0.0, 0.0990 * f / 1000e3, 0.0]),
    }
    return props


def material_array(frequency: float, tissues=TISSUES) -> np.ndarray:
    """Stack tissue 5-vectors into an (N, 5) float array."""
    props = tissue_properties(frequency)
    return np.stack([props[t] for t in tissues]).astype(np.float64)


def density_to_ssos_pichardo(density):
    """Shear SoS from density; Pichardo 2017 average over reported freqs
    (`BabelIntegrationBASE.py:626-644`)."""
    return np.asarray(density) * 0.422 + 680.515


def smallest_sos(frequency: float, include_shear: bool = False) -> float:
    """Smallest nonzero sound speed across tissues at this frequency.

    Used to derive grid spacing dx = c_min / (f * PPW)
    (`BabelIntegrationBASE.py:170-182`). When ``include_shear``, also bounds
    by the Pichardo density->shear-SoS mapping at water density (CT mode can
    produce shear speeds below the tissue table).
    """
    props = tissue_properties(frequency)
    sos = min(
        min(v[LONG_SOS] for v in props.values() if v[LONG_SOS] > 0),
        min((v[SHEAR_SOS] for v in props.values() if v[SHEAR_SOS] > 0), default=np.inf),
    )
    if include_shear:
        sos = min(sos, float(density_to_ssos_pichardo(1000.0)))
    return float(sos)


def speed_of_sound_water(temperature_c: float = 20.0) -> float:
    """Speed of sound in pure water vs temperature (m/s).

    5th-order Marczak/UNESCO-style polynomial fit, 0-100 C — the same model
    BabelViscoFDTD's ``SpeedofSoundWater`` exposes (used to size transducer
    surface meshes, `BabelIntegrationSingle.py:243`).
    """
    t = float(temperature_c)
    # Marczak (1997) J. Acoust. Soc. Am. 102(5) polynomial
    coeffs = [
        1.402385e3,
        5.038813,
        -5.799136e-2,
        3.287156e-4,
        -1.398845e-6,
        2.787860e-9,
    ]
    return float(sum(c * t**i for i, c in enumerate(coeffs)))
