"""YAML profile loaders (thermal profiles, transducer registry).

Honors the reference's profile contracts:
* thermal profiles (`Profiles/Thermal_Profile_*.yaml`): ``BaseIsppa`` + a
  list of ``AllDC_PRF_Duration`` entries {DC, PRF, Duration, DurationOff,
  Repetitions, NumberGroupedSonications, PauseBetweenGroupedSonications}.
* per-transducer geometry (`BabelBrain/Babel_<Tx>/default.yaml`): frequency
  lists, aperture/focal length, ring diameters, steering limits.

Numpy copy of ``babelbrain_tpu/pipeline/profiles.py``; ``yaml`` is imported
only where a YAML file is read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .thermal import SonicationParams


def load_thermal_profile(path: str) -> tuple[float, list[SonicationParams]]:
    """Parse a thermal profile YAML into (base_isppa, [SonicationParams])."""
    import yaml

    with open(path) as f:
        prof = yaml.safe_load(f)
    base_isppa = float(prof.get("BaseIsppa", 5.0))
    combos = []
    for entry in prof.get("AllDC_PRF_Duration", []):
        combos.append(
            SonicationParams(
                duration_on=float(entry["Duration"]),
                duration_off=float(entry.get("DurationOff", entry["Duration"])),
                duty_cycle=float(entry["DC"]),
                prf=float(entry["PRF"]),
                repetitions=int(entry.get("Repetitions", 1)),
                grouped_sonications=int(entry.get("NumberGroupedSonications", 1)),
                pause_between_groups=float(
                    entry.get("PauseBetweenGroupedSonications", 0.0)
                ),
                isppa=base_isppa,
            )
        )
    return base_isppa, combos


@dataclass
class TransducerSpec:
    """Registry entry describing a supported transducer system."""

    name: str
    kind: str  # 'single' | 'annular' | 'concave' | 'flat' | 'dome'
    diameter: float
    focal_length: float | None = None
    frequencies: tuple = ()
    in_diameters: tuple = ()
    out_diameters: tuple = ()
    n_elements: int | None = None
    elem_diameter: float | None = None
    pitch: float | None = None
    grid_dims: tuple = ()
    steering_range: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)


# Published device specs (mirrors the Babel_<Tx>/default.yaml files of the
# reference; SURVEY.md section 2.4). Element-coordinate tables for the
# concave arrays are manufacturer CSVs the user supplies at run time.
TRANSDUCER_REGISTRY = {
    "Single": TransducerSpec(
        "Single", "single", diameter=50e-3, focal_length=50e-3,
        frequencies=tuple(np.arange(200e3, 1000e3 + 1, 50e3)),
        meta={"user_adjustable": True},
    ),
    "CTX_500": TransducerSpec(
        "CTX_500", "annular", diameter=64e-3, focal_length=62.94e-3,
        frequencies=(500e3, 545e3),
        steering_range={"tpo_min": 33.6e-3, "tpo_max": 82.5e-3},
        meta={"natural_outplane": 52.38e-3},
        in_diameters=(0.0, 31.6988e-3, 44.2688e-3, 53.6688e-3),
        out_diameters=(31.14e-3, 43.71e-3, 53.11e-3, 60.83e-3),
    ),
    "CTX_250": TransducerSpec(
        "CTX_250", "annular", diameter=64e-3, focal_length=62.94e-3,
        frequencies=(250e3,),
        steering_range={"tpo_min": 25.0e-3, "tpo_max": 60.0e-3},
        meta={"natural_outplane": 52.38e-3},
        in_diameters=(0.0, 30.1788e-3, 42.1388e-3, 51.1088e-3),
        out_diameters=(29.62e-3, 41.58e-3, 50.55e-3, 57.94e-3),
    ),
    "CTX_250_2ch": TransducerSpec(
        "CTX_250_2ch", "annular", diameter=45.5e-3, focal_length=62.9e-3,
        frequencies=(250e3,),
        steering_range={"tpo_min": 20.0e-3, "tpo_max": 80.0e-3},
        meta={"natural_outplane": 56.9e-3},
        in_diameters=(0.0, 29.2588e-3),
        out_diameters=(28.7e-3, 40.2e-3),
    ),
    "DPX_500": TransducerSpec(
        # 4-ring long-focus annular (`Babel_DPX500/default.yaml`)
        "DPX_500", "annular", diameter=64e-3, focal_length=150.0e-3,
        frequencies=(500e3,),
        in_diameters=(0.0, 0.03243857, 0.04582899, 0.05597536),
        out_diameters=(0.0312153, 0.04464872, 0.05483928, 0.06328742),
        steering_range={"tpo_min": 50.0e-3, "tpo_max": 120.0e-3},
        meta={"natural_outplane": 144.9e-3},
    ),
    "DPXPC_300": TransducerSpec(
        # 4-ring long-focus annular (`Babel_DPXPC300/default.yaml`)
        "DPXPC_300", "annular", diameter=64e-3, focal_length=150.0e-3,
        frequencies=(300e3,),
        in_diameters=(7.7e-3, 30.8e-3, 43.5e-3, 53.2e-3),
        out_diameters=(30.8e-3, 43.5e-3, 53.2e-3, 61.3e-3),
        steering_range={"tpo_min": 50.0e-3, "tpo_max": 120.0e-3},
        meta={"natural_outplane": 144.9e-3},
    ),
    "R15287": TransducerSpec(
        # 10-ring annular, F=75 mm (`Babel_R15287/default.yaml`)
        "R15287", "annular", diameter=65e-3, focal_length=75.0e-3,
        frequencies=(300e3,),
        in_diameters=(10.0e-3, 22.3e-3, 30.0e-3, 36.3e-3, 41.7e-3,
                      46.5e-3, 51.0e-3, 55.1e-3, 58.9e-3, 62.5e-3),
        out_diameters=(21.3e-3, 29.1e-3, 35.3e-3, 40.7e-3, 45.6e-3,
                       50.0e-3, 54.1e-3, 58.0e-3, 61.6e-3, 65.0e-3),
        steering_range={"tpo_min": 8.0e-3, "tpo_max": 110.0e-3},
        meta={"natural_outplane": 65.3e-3},
    ),
    "R15473": TransducerSpec(
        # 10-ring annular, F=100 mm (`Babel_R15473/default.yaml`)
        "R15473", "annular", diameter=65e-3, focal_length=100.0e-3,
        frequencies=(300e3,),
        in_diameters=(10.0e-3, 22.1e-3, 29.8e-3, 36.0e-3, 41.4e-3,
                      46.3e-3, 50.7e-3, 54.9e-3, 58.7e-3, 62.4e-3),
        out_diameters=(21.1e-3, 28.8e-3, 35.0e-3, 40.4e-3, 45.3e-3,
                       49.7e-3, 53.9e-3, 57.8e-3, 61.5e-3, 65.0e-3),
        steering_range={"tpo_min": 15.0e-3, "tpo_max": 110.0e-3},
        meta={"natural_outplane": 92.7e-3},
    ),
    "H317": TransducerSpec(
        "H317", "concave", diameter=157e-3, focal_length=135e-3,
        frequencies=(250e3, 700e3, 825e3), n_elements=128,
        elem_diameter=9.5e-3,
        steering_range={"z": (-50e-3, 50e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (20.0e-3, 95.5e-3, 25.0e-3)},
    ),
    "H301": TransducerSpec(
        "H301", "concave", diameter=150e-3, focal_length=150e-3,
        frequencies=(1100e3,), n_elements=128, elem_diameter=10.15e-3,
        steering_range={"z": (-30e-3, 30e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (10.0e-3, 129.0e-3, 60.0e-3)},
    ),
    "ATAC": TransducerSpec(
        "ATAC", "concave", diameter=58e-3, focal_length=53.2e-3,
        frequencies=(1000e3,), n_elements=128, elem_diameter=3.5e-3,
        steering_range={"z": (-30e-3, 30e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (10.0e-3, 42.0e-3, 25.0e-3)},
    ),
    "I12378": TransducerSpec(
        "I12378", "concave", diameter=103e-3, focal_length=72e-3,
        frequencies=(650e3,), n_elements=128, elem_diameter=6.6e-3,
        steering_range={"z": (-30e-3, 30e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (10.0e-3, 48.0e-3, 25.0e-3)},
    ),
    "R15148": TransducerSpec(
        "R15148", "concave", diameter=103e-3, focal_length=80e-3,
        frequencies=(500e3,), n_elements=128, elem_diameter=6.6e-3,
        steering_range={"z": (-30e-3, 30e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (10.0e-3, 61.0e-3, 40.0e-3)},
    ),
    "R15646": TransducerSpec(
        "R15646", "concave", diameter=65.95e-3, focal_length=65e-3,
        frequencies=(650e3,), n_elements=64, elem_diameter=6e-3,
        steering_range={"z": (-30e-3, 30e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (10.0e-3, 55.5e-3, 52.0e-3)},
    ),
    "IGT64_500": TransducerSpec(
        "IGT64_500", "concave", diameter=65e-3, focal_length=75e-3,
        frequencies=(500e3,), n_elements=64, elem_diameter=6e-3,
        steering_range={"z": (-30e-3, 30e-3), "x": (-20e-3, 20e-3), "y": (-20e-3, 20e-3)},
        meta={"cone_to_focus": (10.0e-3, 65.0e-3, 65.0e-3)},
    ),
    "REMOPD": TransducerSpec(
        "REMOPD", "flat", diameter=58e-3, focal_length=0.0,
        frequencies=(300e3, 480e3, 490e3, 500e3), n_elements=256,
        pitch=3.08e-3, grid_dims=(16, 16), elem_diameter=2.58e-3,
        steering_range={"z": (20e-3, 100e-3), "x": (-35e-3, 35e-3),
                        "y": (-35e-3, 35e-3)},
        meta={"default_z_steering": 30e-3},
    ),
    "H246": TransducerSpec(
        "H246", "flat_rings", diameter=33.6e-3, focal_length=0.0,
        frequencies=(500e3,), n_elements=2,
        steering_range={"tpo_min": 25.0e-3, "tpo_max": 95.0e-3},
        in_diameters=(0.0, 24.0e-3), out_diameters=(23.3e-3, 33.6e-3),
    ),
    "DomeTx": TransducerSpec(
        "DomeTx", "dome", diameter=300e-3, focal_length=150e-3,
        frequencies=(220e3, 670e3), n_elements=1024, elem_diameter=9e-3,
        meta={"amplitude_1w": {"Rayleigh": 0.14475482330468514,
                               "Visco": {220000: {6: 74065.04, 7: 79050.414,
                                                  8: 84021.836, 9: 88933.47,
                                                  10: 94068.0, 11: 91529.37,
                                                  12: 97344.266},
                                         670000: {6: 166890.38}}}},
    ),
    "BSonix": TransducerSpec(
        "BSonix", "single", diameter=64e-3, focal_length=80e-3,
        frequencies=(650e3,),
    ),
}


def tpo_to_z_steering(spec: TransducerSpec, tpo_m: float) -> float:
    """TPO focal distance -> Z steering for annular/ring systems.

    The reference programs ring phases from a TPO distance against the
    natural out-plane distance: ``ZSteering = TPO - NaturalOutPlaneDistance``
    (`_Babel_RingTx/Babel_RingTx.py:97,226`), with the TPO spinbox clamped
    to the per-device ``Minimal/MaximalTPODistance``
    (`Babel_CTX500/default.yaml`). Raises on out-of-range TPO.
    """
    rng = spec.steering_range
    if "tpo_min" not in rng:
        raise ValueError(f"{spec.name}: no TPO range (not a ring system)")
    if not (rng["tpo_min"] <= tpo_m <= rng["tpo_max"]):
        raise ValueError(
            f"{spec.name}: TPO {tpo_m * 1e3:.1f} mm outside "
            f"[{rng['tpo_min'] * 1e3:.1f}, {rng['tpo_max'] * 1e3:.1f}] mm"
        )
    return tpo_m - spec.meta["natural_outplane"]


def z_steering_to_tpo(spec: TransducerSpec, z_steering: float) -> float:
    """Inverse of ``tpo_to_z_steering`` (the distance to program in the
    TPO device, `Babel_RingTx.py:129,214-226`)."""
    tpo = z_steering + spec.meta["natural_outplane"]
    rng = spec.steering_range
    if not (rng["tpo_min"] <= tpo <= rng["tpo_max"]):
        raise ValueError(
            f"{spec.name}: ZSteering {z_steering * 1e3:.1f} mm maps to TPO "
            f"{tpo * 1e3:.1f} mm outside the device range"
        )
    return tpo


def validate_steering(spec: TransducerSpec, steering) -> None:
    """Enforce the per-device steering limits (`Babel_<Tx>/default.yaml`
    Minimal/Maximal{X,Y,Z}Steering and TPO ranges). Raises ValueError."""
    sx, sy, sz = (float(v) for v in steering)
    rng = spec.steering_range
    if not rng:
        # no published range (custom/test devices, Single/BSonix/DomeTx):
        # the library permits phase steering; nothing to enforce
        return
    if "tpo_min" in rng:
        if sx or sy:
            raise ValueError(
                f"{spec.name}: annular arrays steer along z only"
            )
        if sz:
            z_steering_to_tpo(spec, sz)  # raises when out of TPO range
        return
    for axis, v in zip("xyz", (sx, sy, sz)):
        lo, hi = rng.get(axis, (0.0, 0.0))
        if not (lo <= v <= hi):
            raise ValueError(
                f"{spec.name}: {axis}-steering {v * 1e3:.1f} mm outside "
                f"[{lo * 1e3:.1f}, {hi * 1e3:.1f}] mm"
            )


def cone_to_focus_adjust(
    spec: TransducerSpec,
    skin_to_target_m: float,
    distance_cone_to_focus: float | None = None,
    z_steering: float = 0.0,
) -> tuple[float, float]:
    """Concave-array mechanical-Z auto-adjust from the device cone.

    The reference positions the Tx so the holder cone's focus distance
    matches the skin-to-target depth: ``TxMechanicalAdjustmentZ =
    DistanceConeToFocus - Distance``; positive Z steering adds extra cone
    depth (`BabelIntegrationCONCAVE_PHASEDARRAY.py:140-152`). The cone
    distance defaults to / is clamped against the per-device
    (min, max, default) triple (`Babel_H317/default.yaml`).

    Returns ``(tx_mechanical_adjustment_z, extra_depth_adjust)``.
    """
    lo, hi, default = spec.meta["cone_to_focus"]
    d = default if distance_cone_to_focus is None else distance_cone_to_focus
    if not (lo <= d <= hi):
        raise ValueError(
            f"{spec.name}: DistanceConeToFocus {d * 1e3:.1f} mm outside "
            f"[{lo * 1e3:.1f}, {hi * 1e3:.1f}] mm"
        )
    mech_z = d - skin_to_target_m
    extra_depth = z_steering if z_steering > 0 else 0.0
    return mech_z, extra_depth


def amplitude_for_1w(spec: TransducerSpec, frequency: float | None = None,
                     ppw: int | None = None, solver: str = "Visco") -> float:
    """Calibrated source amplitude for 1 W of acoustic power.

    DomeTx ships measured per-frequency/PPW calibration factors
    (`Babel_DomeTx/default.yaml` Amplitude1W); ``solver='Rayleigh'`` returns
    the Rayleigh particle-velocity factor, ``'Visco'`` the per-(frequency,
    PPW) FDTD pressure amplitude in Pa.
    """
    table = spec.meta.get("amplitude_1w")
    if table is None:
        raise ValueError(f"{spec.name}: no 1 W calibration table")
    if solver == "Rayleigh":
        return float(table["Rayleigh"])
    by_freq = table["Visco"]
    fkey = int(frequency)
    if fkey not in by_freq:
        raise ValueError(
            f"{spec.name}: no 1 W calibration at {frequency} Hz "
            f"(available: {sorted(by_freq)})"
        )
    by_ppw = by_freq[fkey]
    pkey = int(ppw)
    if pkey not in by_ppw:
        raise ValueError(
            f"{spec.name}: no 1 W calibration at PPW {ppw} "
            f"(available: {sorted(by_ppw)})"
        )
    return float(by_ppw[pkey])


def build_transducer(
    spec: TransducerSpec,
    frequency: float,
    sos_water: float = 1482.3,
    ppw_surface: float = 8.0,
    elem_centers=None,
    rotation_z: float = 0.0,
    sector: str = "Total",
    factor_enlarge: float = 1.0,
    diameter: float | None = None,
    focal_length: float | None = None,
):
    """Instantiate geometry for a registry entry (focus at origin).

    ``rotation_z`` (degrees) spins multi-element arrays about the beam axis,
    the reference's RotationZ parameter (`I12378.py:55-70` et al.).
    ``sector`` selects the REMOPD half-array configs ('Total' | 'Sector1' =
    elements 0-127 | 'Sector2' = 128-255, `BabelIntegrationREMOPD.py:100-118`).
    ``factor_enlarge`` scales a single-element bowl's aperture AND focal
    length together (same F-number) — the reference's FactorEnlarge trick
    that feeds the FDTD a more coherent incident field
    (`BabelIntegrationSingle.py:224-238`); the focus stays at the origin.
    ``diameter``/``focal_length`` override the registry values for the
    user-adjustable Single system (`Babel_SingleTx` Foc/Diam spinboxes).
    """
    from ..tx import (
        TABLE_DEVICES,
        element_table,
        make_annular_array,
        make_concave_array,
        make_flat_array_from_positions,
        make_flat_grid_array,
        make_flat_ring_array,
        make_focused_bowl,
        remopd_positions,
    )

    if spec.kind == "single":
        foc = focal_length if focal_length is not None else spec.focal_length
        diam = diameter if diameter is not None else spec.diameter
        return make_focused_bowl(
            frequency, foc * factor_enlarge, diam * factor_enlarge,
            sos_water, ppw_surface,
        )
    if spec.kind == "annular":
        if not spec.in_diameters:
            return make_focused_bowl(
                frequency, spec.focal_length, spec.diameter, sos_water, ppw_surface
            )
        return make_annular_array(
            frequency, spec.focal_length, spec.in_diameters, spec.out_diameters,
            sos_water, ppw_surface,
        )
    if spec.kind in ("concave", "dome"):
        if elem_centers is None:
            if spec.name in TABLE_DEVICES:
                elem_centers = element_table(spec.name)
            else:
                raise ValueError(
                    f"{spec.name}: element-center table required"
                )
        if rotation_z:
            a = np.deg2rad(rotation_z)
            rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                            [np.sin(a), np.cos(a), 0.0],
                            [0.0, 0.0, 1.0]])
            elem_centers = np.asarray(elem_centers) @ rot.T
        return make_concave_array(
            frequency, spec.focal_length, spec.elem_diameter or 9.5e-3,
            elem_centers, sos_water, ppw_surface,
        )
    if spec.kind == "flat":
        if spec.name == "REMOPD":
            # measured element positions; square elements of side
            # pitch - kerf at z = -1.2 mm (`BabelIntegrationREMOPD.py:28-39`)
            pos = remopd_positions()
            if sector == "Sector1":
                pos = pos[:128]
            elif sector == "Sector2":
                pos = pos[128:]
            elif sector != "Total":
                raise ValueError(f"unknown REMOPD sector {sector!r}")
            if rotation_z:
                a = np.deg2rad(rotation_z)
                rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                                [np.sin(a), np.cos(a), 0.0],
                                [0.0, 0.0, 1.0]])
                pos = pos @ rot.T
            return make_flat_array_from_positions(
                frequency, pos, 3.08e-3 - 0.5e-3,
                sos_water, ppw_surface, z_offset=-1.2e-3,
            )
        nx, ny = spec.grid_dims or (16, 16)
        return make_flat_grid_array(
            frequency, spec.pitch or 3.08e-3, nx, ny,
            spec.elem_diameter or 2.8e-3, sos_water, ppw_surface,
        )
    if spec.kind == "flat_rings":
        return make_flat_ring_array(
            frequency, spec.in_diameters, spec.out_diameters,
            sos_water, ppw_surface,
        )
    raise ValueError(f"unknown transducer kind {spec.kind}")
