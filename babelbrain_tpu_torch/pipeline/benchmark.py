"""Benchmark-file injection (ITRUSST-style cross-validation media).

Counterpart of ``babelbrain_tpu/pipeline/benchmark.py``: the reference's
``BenchmarkTestFile`` mechanism
(`TranscranialModeling/BabelIntegrationBASE.py:1253-1260,1313-1321,2210-2217`;
SURVEY.md section 4). An HDF5 file supplies ``Materials`` (list of dicts
with Density/LongSoS/ShearSoS/LongAtt/ShearAtt [+thermal props]), a
``MaterialMap`` volume, a ``TestType`` in {1,2,3}, and optionally
``QCorrArr`` and ``FixedAcousticPower``. The simulation then runs on exactly
that medium, making results directly comparable across solvers.

``run_benchmark_acoustic`` reads the file and hands the loaded medium to
``_run_loaded_benchmark`` (QCorr, grid, ``ops.fdtd.run_fdtd``), which takes
a medium held in memory as well (``_with_material_array`` of its dict).
``solid_layer_transmission`` is the exact plane-wave transmission through
an elastic layer, the analytic truth of the shear anchor: a numpy copy of
the JAX function.
"""

from __future__ import annotations

import numpy as np

from ..ops.fdtd import FDTDGrid, run_fdtd
from .domain import compute_time_stepping, sensor_window, simulation_steps
from .io import load_dict_h5


def load_benchmark_file(path: str) -> dict:
    return _with_material_array(load_dict_h5(path))


def _with_material_array(data: dict) -> dict:
    """``data`` (a benchmark file's contents) with "MaterialArray": the
    (M, 5) [rho, c_long, c_shear, att_long, att_shear] of its "Materials"."""
    mats = []
    for entry in data["Materials"]:
        mats.append(
            [
                float(entry["Density"]),
                float(entry["LongSoS"]),
                float(entry.get("ShearSoS", 0.0)),
                float(entry.get("LongAtt", 0.0)),
                float(entry.get("ShearAtt", 0.0)),
            ]
        )
    data["MaterialArray"] = np.asarray(mats)
    return data


def thermal_benchmark_regions(material_map, test_type: int):
    """Region masks per TestType (`CalculateTemperatureEffects.py:868-906`).

    Returns (skull_mask, brain_ids, id_region_benchmark)."""
    mm = np.asarray(material_map)
    if test_type == 1:
        return mm > 0, [int(mm.max())], [0]
    if test_type == 2:
        return mm == 1, [int(mm.max())], [0, 1]
    if test_type == 3:
        mx = int(mm.max())
        return (mm > 1) & (mm <= mx - 2), [mx], [mx - 2, mx - 3]
    raise ValueError(f"TestType must be 1..3, got {test_type}")


def run_benchmark_acoustic(
    path: str,
    frequency: float,
    ppw: float,
    source_amp: np.ndarray,
    source_phase: np.ndarray,
    *,
    npml: int = 12,
    alpha_cfl: float = 0.5,
    source_plane_z: int = 13,
    mesh=None,
    device="cuda",
):
    """Run the FDTD on a benchmark medium with a given CW source plane.

    An optional ``QCorrArr`` in the file scales each material's attenuation
    columns — the reference's per-material Q correction for benchmark media
    (`BabelIntegrationBASE.py:2210-2217`; our SLS is exact at the carrier so
    the array acts directly on the alpha columns). ``device``: where the
    FDTD runs (CUDA: the step kernels; CPU: their plain versions);
    ``mesh``: a device mesh the FDTD is decomposed over (``run_fdtd``). The
    JAX version's ``backend`` has no counterpart here.
    """
    return _run_loaded_benchmark(
        load_benchmark_file(path), frequency, ppw, source_amp, source_phase,
        npml=npml, alpha_cfl=alpha_cfl, source_plane_z=source_plane_z,
        mesh=mesh, device=device,
    )


def _run_loaded_benchmark(bench: dict, frequency, ppw, source_amp,
                          source_phase, *, npml=12, alpha_cfl=0.5,
                          source_plane_z=13, mesh=None, device="cuda"):
    """``run_benchmark_acoustic`` on a medium already loaded (the dict
    ``load_benchmark_file`` returns; its "MaterialArray" is replaced by the
    Q-corrected one)."""
    mats = bench["MaterialArray"]
    if "QCorrArr" in bench:
        q = np.asarray(bench["QCorrArr"], np.float64).reshape(-1)
        if len(q) != len(mats):
            raise ValueError(
                f"QCorrArr has {len(q)} entries for {len(mats)} materials"
            )
        mats = mats.copy()
        mats[:, 3] *= q
        mats[:, 4] *= q
        bench["MaterialArray"] = mats
    mat_map = np.asarray(bench["MaterialMap"]).astype(np.uint32)
    dx, dt, ppp, _ = compute_time_stepping(
        mats, frequency, ppw, alpha_cfl, bound_by_tissue_minimum=False
    )
    shape = mat_map.shape
    n_steps = simulation_steps(
        (np.array(shape) - 2 * npml) * dx, mats[0, 1], dt, ppp
    )
    grid = FDTDGrid(
        shape=shape,
        dx=dx,
        dt=dt,
        n_steps=n_steps,
        frequency=frequency,
        npml=npml,
        sensor_start=sensor_window(n_steps, ppp),
        source_plane_z=source_plane_z,
    )
    out = run_fdtd(
        mat_map, mats, grid, source_amp=source_amp, source_phase=source_phase,
        mesh=mesh, device=device,
    )
    out["grid"] = grid
    out["benchmark"] = bench
    return out


def solid_layer_transmission(theta, frequency, thickness, fluid, solid):
    """Exact plane-wave transmission through an elastic layer in a fluid.

    Analytic fluid–solid–fluid sandwich with P<->SV mode conversion
    (Brekhovskikh, *Waves in Layered Media*; the same physics the
    reference anchors through hydrophone/inter-comparison studies,
    the reference's `README.md:27`): an incident P wave at angle
    ``theta`` (rad, from the layer normal) excites up/down longitudinal
    AND shear partial waves in the layer; the six amplitudes follow from
    continuity of normal velocity and normal stress plus zero tangential
    stress at both interfaces. Solved as a direct 6x6 complex linear
    system with displacement potentials (time convention e^{-i w t}),
    so post-critical (evanescent) branches fall out automatically via
    the Im >= 0 square root.

    Parameters: ``fluid`` = (rho, c); ``solid`` = (rho, cL, cT); lossless.
    Returns complex (T, R): transmitted/reflected PRESSURE amplitude
    ratios referenced to the incident pressure at the entry interface
    (|R|^2 + |T|^2 = 1 for propagating waves in the same fluid on both
    sides — asserted by the unit tests).
    """
    rho1, c1 = fluid
    rho, cL, cT = solid
    w = 2.0 * np.pi * frequency
    k1 = w / c1
    kL = w / cL
    kT = w / cT
    kx = k1 * np.sin(theta)

    def kz(k):
        v = complex(k * k - kx * kx)
        r = np.sqrt(v)
        # decaying evanescent branch for e^{+i kz z} with Im(kz) >= 0
        if r.imag < 0:
            r = -r
        return r

    g1 = kz(k1)
    gL = kz(kL)
    gT = kz(kT)
    lam = rho * (cL * cL - 2.0 * cT * cT)
    mu = rho * cT * cT
    lam1 = rho1 * c1 * c1
    d = thickness

    def p_wave(amp_rho, lam_m, mu_m, kP, s, z):
        """(vz, szz, sxz) of a P partial wave phi = e^{i(kx x + s z)}."""
        ph = np.exp(1j * s * z)
        uz = 1j * s * ph
        vz = -1j * w * uz
        szz = -(lam_m * kP * kP + 2.0 * mu_m * s * s) * ph
        sxz = -2.0 * mu_m * kx * s * ph
        return vz, szz, sxz

    def sv_wave(mu_m, q, z):
        """(vz, szz, sxz) of an SV partial wave psi = e^{i(kx x + q z)}."""
        ph = np.exp(1j * q * z)
        uz = 1j * kx * ph
        vz = -1j * w * uz
        szz = -2.0 * mu_m * kx * q * ph
        sxz = mu_m * (q * q - kx * kx) * ph
        return vz, szz, sxz

    # unknown column: [R, A+, A-, B+, B-, T] (potentials); incident P has
    # potential amplitude 1 travelling +z in fluid 1
    M = np.zeros((6, 6), complex)
    rhs = np.zeros(6, complex)
    vzi, szzi, _ = p_wave(rho1, lam1, 0.0, k1, g1, 0.0)
    vzr, szzr, _ = p_wave(rho1, lam1, 0.0, k1, -g1, 0.0)
    rows = []
    for z in (0.0, d):
        ap = p_wave(rho, lam, mu, kL, gL, z)
        am = p_wave(rho, lam, mu, kL, -gL, z)
        bp = sv_wave(mu, gT, z)
        bm = sv_wave(mu, -gT, z)
        rows.append((ap, am, bp, bm))
    (ap0, am0, bp0, bm0), (apd, amd, bpd, bmd) = rows
    vzt, szzt, _ = p_wave(rho1, lam1, 0.0, k1, g1, 0.0)  # local z' = z - d

    # z = 0: vz and szz continuity, sxz = 0
    M[0] = [vzr, -ap0[0], -am0[0], -bp0[0], -bm0[0], 0.0]
    rhs[0] = -vzi
    M[1] = [szzr, -ap0[1], -am0[1], -bp0[1], -bm0[1], 0.0]
    rhs[1] = -szzi
    M[2] = [0.0, ap0[2], am0[2], bp0[2], bm0[2], 0.0]
    # z = d: vz and szz continuity, sxz = 0
    M[3] = [0.0, apd[0], amd[0], bpd[0], bmd[0], -vzt]
    M[4] = [0.0, apd[1], amd[1], bpd[1], bmd[1], -szzt]
    M[5] = [0.0, apd[2], amd[2], bpd[2], bmd[2], 0.0]
    sol = np.linalg.solve(M, rhs)
    # pressure ratios: p = -szz = lam1 k1^2 phi in the fluid, common factor
    return complex(sol[5]), complex(sol[0])
