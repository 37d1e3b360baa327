"""Thermal tissue property tables for the Pennes bio-heat (BHTE) solver.

Values are IT'IS Foundation tissue-property database entries, matching the
reference's hard-coded tables (`ThermalModeling/CalculateTemperatureEffects.py:776-841`).

Two layouts exist, mirroring the reference:
  * label mode: materials = [Water, Skin, Cortical, Trabecular, Brain]
    (+ [WhiteMatter, GrayMatter, CSF] when brain is segmented);
  * CT mode: materials = [Water, Skin, Brain, (WM, GM, CSF,) hu_0..hu_N]
    where every quantized-HU skull material gets averaged cortical/trabecular
    thermal properties.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Per-tissue (SpecificHeat J/kg/C, Conductivity W/m/C, Perfusion mL/min/kg,
# Absorption fraction) — IT'IS database.
TISSUE_THERMAL = {
    "Water": (4178.0, 0.6, 0.0, 0.0),
    "Skin": (3391.0, 0.37, 106.0, 0.85),
    "Cortical": (1313.0, 0.32, 10.0, 0.16),
    "Trabecular": (2274.0, 0.31, 30.0, 0.15),
    "Brain": (3630.0, 0.51, 559.0, 0.85),
    "WhiteMatter": (3583.0, 0.48, 212.0, 0.85),
    "GrayMatter": (3696.0, 0.55, 764.0, 0.85),
    "CSF": (4096.0, 0.57, 0.0, 0.0),
}

_SKULL_AVG = {
    "SpecificHeat": (1313.0 + 2274.0) / 2,
    "Conductivity": (0.32 + 0.31) / 2,
    "Perfusion": (10.0 + 30.0) / 2,
    "Absorption": (0.16 + 0.15) / 2,
}


@dataclass
class ThermalMaterialList:
    """Columnar thermal+acoustic material properties used by the BHTE."""

    density: np.ndarray
    sos: np.ndarray
    attenuation: np.ndarray  # Np/m (longitudinal)
    specific_heat: np.ndarray
    conductivity: np.ndarray
    perfusion: np.ndarray  # mL/min/kg
    absorption: np.ndarray  # fraction of attenuation deposited as heat
    init_temperature: np.ndarray = field(default=None)

    def __post_init__(self):
        n = len(self.density)
        for name in (
            "sos",
            "attenuation",
            "specific_heat",
            "conductivity",
            "perfusion",
            "absorption",
        ):
            assert len(getattr(self, name)) == n, name
        if self.init_temperature is None:
            self.init_temperature = np.full(n, 37.0)


def _cols(names, baseline):
    sh, k, w, a = zip(*(TISSUE_THERMAL[t] for t in names))
    return (
        np.array(sh),
        np.array(k),
        np.array(w),
        np.array(a),
        np.full(len(names), baseline),
    )


def build_thermal_material_list(
    acoustic_materials: np.ndarray,
    *,
    ct_mode: bool,
    segmented_brain: bool,
    baseline_temperature: float = 37.0,
    no_skull_scalp_absorption: bool = False,
) -> ThermalMaterialList:
    """Build the BHTE material list matching an acoustic material array.

    ``acoustic_materials`` is the (N, 5) array stored in ``DataForSim.h5``
    (`Material` key): columns density, long SoS, shear SoS, long att, shear att.
    Mirrors `CalculateTemperatureEffects.py:749-841`.
    """
    n = acoustic_materials.shape[0]
    density = acoustic_materials[:, 0].astype(np.float64)
    sos = acoustic_materials[:, 1].astype(np.float64)
    attenuation = acoustic_materials[:, 3].astype(np.float64)

    if not ct_mode:
        names = ["Water", "Skin", "Cortical", "Trabecular", "Brain"]
        if segmented_brain:
            names += ["WhiteMatter", "GrayMatter", "CSF"]
        if n != len(names):
            raise ValueError(
                f"label-mode material count {n} != expected {len(names)}"
            )
        sh, k, w, a, t0 = _cols(names, baseline_temperature)
        if no_skull_scalp_absorption:
            a = a.copy()
            a[1:4] = 0.0
    else:
        # CT mode: [Water, Skin, Brain, (WM, GM, CSF,)] + N skull HU materials
        soft = ["Water", "Skin", "Brain"] + (
            ["WhiteMatter", "GrayMatter", "CSF"] if segmented_brain else []
        )
        n_soft = len(soft)
        sh = np.empty(n)
        k = np.empty(n)
        w = np.empty(n)
        a = np.empty(n)
        ssh, sk, sw, sa, _ = _cols(soft, baseline_temperature)
        sh[:n_soft], k[:n_soft], w[:n_soft], a[:n_soft] = ssh, sk, sw, sa
        sh[n_soft:] = _SKULL_AVG["SpecificHeat"]
        k[n_soft:] = _SKULL_AVG["Conductivity"]
        w[n_soft:] = _SKULL_AVG["Perfusion"]
        a[n_soft:] = 0.0 if no_skull_scalp_absorption else _SKULL_AVG["Absorption"]
        if no_skull_scalp_absorption:
            a[1] = 0.0
        t0 = np.full(n, baseline_temperature)

    return ThermalMaterialList(
        density=density,
        sos=sos,
        attenuation=attenuation,
        specific_heat=sh,
        conductivity=k,
        perfusion=w,
        absorption=a,
        init_temperature=t0,
    )
