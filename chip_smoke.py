#!/usr/bin/env python3
"""On-card drive of the PyTorch/CUDA port (``babelbrain_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check exits nonzero):

1. probe   — torch/CUDA versions, the card, its power limit, and whether
             ``h5py`` / ``yaml`` import;
2. build   — the CUDA kernels of ``babelbrain_tpu_torch/csrc`` with nvcc
             (one process per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card at
             main-path shapes, with times and bounds: the fluid FDTD pair
             at 192x192x240 with the 1026-material CT table and the
             viscoelastic pair at the same shape with the label-mode
             materials (each 200 steps across the DFT window start); the
             BHTE step, 500 steps;
4. slices  — the two main paths on a procedural digital head with the
             CTX_500 transducer at 500 kHz / 6 PPW, each with every kernel
             count set to 0 just before and read just after:
             CT mode (Step 1 -> Rayleigh + fluid FDTD -> BHTE, Pichardo HU
             law) and label mode (no CT: tissue-label materials,
             Rayleigh + viscoelastic FDTD -> BHTE). Each runs through
             ``run_case`` when h5py is installed, else through the stage
             functions ``run_case`` calls, in its order, writing no files.
             Every kernel's launch count must equal the step count the run
             implies, and no plain version may run.

The last lines are the kernel table (JSON), the card's name and power limit
(``nvidia-smi``), and ``{"ok": true, "device": {...}}``. The script never
falls back to the CPU: without a CUDA device it exits with an error.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

F0 = 500e3
PPW = 6.0
KERNEL_SHAPE = (192, 192, 240)
FLUID_STEPS, FLUID_SENSOR_START = 200, 150
VISCO_STEPS, VISCO_SENSOR_START = 200, 150
BHTE_STEPS, BHTE_HEAT_STEPS = 500, 300
# FDTD grid (216, 216, 224) after the transducer-cone fit: the order of the
# 192x192x240 benchmark grid
MASK_SHAPE = (160, 160, 200)
VOX = 2.0  # digital-head voxel size (mm)
# HU -> acoustic law of the slice. Under the default Webb-Marsac law this
# phantom's ~550 HU diploe maps to 438 Np/m at 500 kHz: the brain focus gets
# ~18 kPa through the vertex, the Isppa normalisation scales the field 31x
# and the skin passes 2000 C, so CEM43 overflows float32 (the JAX package's
# numerics do the same). Pichardo maps the diploe to 108 Np/m.
MAPPING = "Pichardo"
N_HEAD = 96
# published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 1: probe
# ---------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def probe() -> dict:
    props = torch.cuda.get_device_properties(0)
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[probe] device {props.name} sms {props.multi_processor_count} "
          f"memory {props.total_memory / 2**30:.1f} GiB "
          f"count {torch.cuda.device_count()}")
    print(f"[probe] nvidia-smi: {nvidia_smi_line()}")
    have = {m: importlib.util.find_spec(m) is not None for m in ("h5py", "yaml")}
    print(f"[probe] h5py {'yes' if have['h5py'] else 'MISSING'} "
          f"yaml {'yes' if have['yaml'] else 'MISSING'}")
    return have


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build():
    from babelbrain_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    print(f"[build] kernels ready in {time.time() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def ct_table():
    """CT-mode material table: water + skin + brain + 1023 quantized-HU bone
    (the benchmark's configuration)."""
    from babelbrain_tpu_torch.materials import map_hu_to_properties

    hu = np.linspace(300.0, 2100.0, 1023)
    rho, sos, att = map_hu_to_properties(hu, F0, "Webb-Marsac")
    mats = np.zeros((1026, 5))
    mats[0] = [1000.0, 1500.0, 0, 0, 0]
    mats[1] = [1116.0, 1537.0, 0, 2.99, 0]
    mats[2] = [1041.0, 1562.0, 0, 4.49, 0]
    mats[3:, 0] = rho
    mats[3:, 1] = sos
    mats[3:, 3] = att
    return mats


def ct_index_volume(shape, seed=0):
    """Skin slab, random quantized-HU bone slab, brain (seeded)."""
    n1, n2, n3 = shape
    z0 = n3 // 4
    idx = np.zeros(shape, np.uint16)
    rng = np.random.default_rng(seed)
    idx[:, :, z0:z0 + 10] = 1
    idx[:, :, z0 + 10:z0 + 28] = rng.integers(3, 1026, (n1, n2, 18))
    idx[:, :, z0 + 28:] = 2
    return idx


def _timed(fn, n, warm=2):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _copy_state(st):
    """A copy of a fluid or visco state (every tensor and psi slab cloned)."""
    return type(st)(
        **{k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
           for k, v in vars(st).items()}
    )


# Work of one launch, counted from the kernel code: float-sized volumes read
# plus written per cell (the int32 material index counts as one), CPML'd
# derivatives per axis (each reads and writes a lo and a hi psi slab of ns
# planes), (N1, N2) source planes read, and float operations per cell. The
# CPML profiles and the material table (a few hundred bytes) are left out.
KERNEL_WORK = {
    "fluid_velocity": dict(volumes=8, derivs_per_axis=1, planes=3, flops=24),
    "fluid_pressure": dict(volumes=10, derivs_per_axis=1, planes=0, flops=27),
    "fluid_pressure_dft": dict(volumes=16, derivs_per_axis=1, planes=0,
                               flops=33),
    "bhte_step": dict(volumes=15, derivs_per_axis=0, planes=0, flops=30),
    "visco_velocity": dict(volumes=13, derivs_per_axis=3, planes=3, flops=60),
    "visco_stress": dict(volumes=28, derivs_per_axis=3, planes=0, flops=134),
    "visco_stress_dft": dict(volumes=34, derivs_per_axis=3, planes=0,
                             flops=143),
}


def bound(name, shape, ns=14):
    """(least ms, "bytes" or "operations") of one launch of ``name`` at
    ``shape`` on an H100 at its published peaks: each input read once and
    each output written once over the HBM rate, against the float32
    operations over the float32 peak."""
    w = KERNEL_WORK[name]
    n1, n2, n3 = shape
    cells = n1 * n2 * n3
    slab_cells = ns * (n2 * n3 + n1 * n3 + n1 * n2)  # one slab per axis
    floats = (w["volumes"] * cells + w["derivs_per_axis"] * 2 * 2 * slab_cells
              + w["planes"] * n1 * n2)
    t_bytes = 4.0 * floats / HBM_BYTES_PER_S * 1e3
    t_ops = float(w["flops"]) * cells / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_fluid(shape=KERNEL_SHAPE, n_steps=FLUID_STEPS,
                sensor_start=FLUID_SENSOR_START, device="cuda"):
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    mats = ct_table()
    cmax = mats[:, 1].max()
    dx = 1482.3 / F0 / PPW
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, cfl=0.5)))
    dt = 1 / F0 / ppp
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=n_steps,
                      frequency=F0, sensor_start=sensor_start,
                      source_plane_z=13)
    coefs = F.sls_coefficients(mats, F0, dt)
    props = F._material_fields(ct_index_volume(shape), coefs, has_shear=False)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, cmax, 1e-5)
    amp = np.zeros(shape[:2])
    m = max(2, shape[0] // 12)  # 16 cells at the benchmark shape
    amp[m:-m, m:-m] = 60e3
    ph = np.random.default_rng(1).uniform(-1.0, 1.0, shape[:2])
    co = F.make_fluid_coeffs(props, prof, amp, ph, grid, coefs["viscous"],
                             device)
    oz = 1.0 / (1000.0 * 1500.0)
    st_k = K.FluidState.zeros(shape, 14, device)
    st_p = K.FluidState.zeros(shape, 14, device)
    for n in range(n_steps):
        F.fluid_step(st_k, co, grid, n, oz)
        s_sin, s_cos, cosw, sinw = F.step_scalars(grid, n, oz)
        K.fluid_velocity_ref(st_p, co, s_sin, s_cos)
        if n >= sensor_start:
            K.fluid_pressure_ref(st_p, co, cosw, sinw)
        else:
            K.fluid_pressure_ref(st_p, co)
    if device == "cuda":
        torch.cuda.synchronize()
    pmax = float(st_p.p.abs().max())
    if not np.isfinite(pmax) or pmax <= 0:
        fail(f"fluid plain run has max|p| = {pmax}")
    tol = 1e-4 * pmax
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    errs = {
        "fluid_velocity": max(err(st_k.vx, st_p.vx), err(st_k.vy, st_p.vy),
                              err(st_k.vz, st_p.vz)),
        "fluid_pressure": max(err(st_k.p, st_p.p), err(st_k.r, st_p.r)),
        "fluid_pressure_dft": max(err(st_k.acc_cos, st_p.acc_cos),
                                  err(st_k.acc_sin, st_p.acc_sin),
                                  err(st_k.peak, st_p.peak)),
    }
    print(f"[kernels] fluid {shape} {n_steps} steps (window from "
          f"{sensor_start}): max|p| {pmax:.6g} Pa, tolerance {tol:.6g} "
          f"(1e-4 max|p|)")
    for name, e in errs.items():
        print(f"[kernels]   {name}: max abs diff vs plain {e:.6g}")
    velocity_err = errs["fluid_velocity"]
    if max(errs["fluid_pressure"], errs["fluid_pressure_dft"]) > tol:
        fail(f"fluid kernels disagree with the plain version: {errs}")
    # velocities are compared at the same relative band (|v| ~ |p| oz)
    vmax = float(max(st_p.vx.abs().max(), st_p.vy.abs().max(),
                     st_p.vz.abs().max()))
    if velocity_err > 1e-4 * vmax:
        fail(f"fluid velocity kernel disagrees: {velocity_err} > 1e-4 * {vmax}")

    times = {}
    if device == "cuda":
        s = F.step_scalars(grid, 10, oz)
        work = _copy_state(st_k)
        times["fluid_velocity"] = (
            _timed(lambda: K.fluid_velocity(work, co, s[0], s[1]), 20),
            _timed(lambda: K.fluid_velocity_ref(work, co, s[0], s[1]), 5),
        )
        times["fluid_pressure"] = (
            _timed(lambda: K.fluid_pressure(work, co), 20),
            _timed(lambda: K.fluid_pressure_ref(work, co), 5),
        )
        times["fluid_pressure_dft"] = (
            _timed(lambda: K.fluid_pressure(work, co, s[2], s[3]), 20),
            _timed(lambda: K.fluid_pressure_ref(work, co, s[2], s[3]), 5),
        )
        cells = float(np.prod(shape))
        step_k = times["fluid_velocity"][0] + times["fluid_pressure"][0]
        step_p = times["fluid_velocity"][1] + times["fluid_pressure"][1]
        for name, (tk, tp) in times.items():
            print(f"[kernels]   {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms")
        print(f"[kernels] fluid quiet step: kernel {step_k:.4f} ms/step "
              f"({cells / step_k / 1e3:.1f} Mcell-updates/s), plain "
              f"{step_p:.4f} ms/step ({cells / step_p / 1e3:.1f} "
              f"Mcell-updates/s)")
    return errs, times


def label_index_volume(shape):
    """Label-mode material layers along z: water, skin, then a skull of
    cortical / trabecular / cortical bone, then brain (the layering of the
    skull_slab_visco regression configuration, at this grid's scale)."""
    z0 = shape[2] // 4
    idx = np.zeros(shape, np.uint8)
    for label, width in ((1, 8), (2, 6), (3, 10), (2, 6)):
        idx[:, :, z0:z0 + width] = label
        z0 += width
    idx[:, :, z0:] = 4
    return idx


def check_visco(shape=KERNEL_SHAPE, n_steps=VISCO_STEPS,
                sensor_start=VISCO_SENSOR_START, device="cuda"):
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
    from babelbrain_tpu_torch.pipeline.domain import (
        build_label_materials,
        compute_time_stepping,
    )

    mats = build_label_materials(F0, False)
    dx, dt, _, _ = compute_time_stepping(mats, F0, PPW)
    cmax = max(mats[:, 1].max(), mats[:, 2].max())
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=n_steps,
                      frequency=F0, sensor_start=sensor_start,
                      source_plane_z=13)
    coefs = F.sls_coefficients(mats, F0, dt)
    idx, table = F._build_indexed_materials(coefs, label_index_volume(shape),
                                            None)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, cmax, 1e-5)
    amp = np.zeros(shape[:2])
    m = max(2, shape[0] // 12)
    amp[m:-m, m:-m] = 60e3
    ph = np.random.default_rng(1).uniform(-1.0, 1.0, shape[:2])
    co = F.make_visco_coeffs(idx, table, prof, amp, ph, grid,
                             coefs["viscous"], device)
    oz = 1.0 / (mats[0, 0] * mats[0, 1])
    st_k = V.ViscoState.zeros(shape, 14, device)
    st_p = V.ViscoState.zeros(shape, 14, device)
    for n in range(n_steps):
        F.visco_step(st_k, co, grid, n, oz)
        s_sin, s_cos, cosw, sinw = F.step_scalars(grid, n, oz)
        V.visco_velocity_ref(st_p, co, s_sin, s_cos)
        if n >= sensor_start:
            V.visco_stress_ref(st_p, co, cosw, sinw)
        else:
            V.visco_stress_ref(st_p, co)
    if device == "cuda":
        torch.cuda.synchronize()
    # every field against the plain state, at 1e-4 of the field's own
    # maximum (the kernels are expected to be bit-equal: --fmad=false and
    # the plain versions' operation order)
    groups = {
        "visco_velocity": ("vx", "vy", "vz", "psi_s"),
        "visco_stress": V.STRESSES + V.MEMORIES + ("psi_v",),
        "visco_stress_dft": ("acc_cos", "acc_sin", "peak"),
    }
    errs, bad = {}, []
    for kname, fields in groups.items():
        errs[kname] = 0.0
        for f in fields:
            a, b = getattr(st_k, f), getattr(st_p, f)
            pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
            for x, y in pairs:
                e = float((x - y).abs().max())
                scale = float(y.abs().max())
                if not np.isfinite(scale) or e > 1e-4 * scale:
                    bad.append((f, e, scale))
                errs[kname] = max(errs[kname], e)
    pmax = float(st_p.peak.max())
    print(f"[kernels] visco {shape} {n_steps} steps (window from "
          f"{sensor_start}), {table.shape[1]} label materials: peak |p| "
          f"{pmax:.6g} Pa, max|sxx| {float(st_p.sxx.abs().max()):.6g} Pa, "
          f"max|vz| {float(st_p.vz.abs().max()):.6g} m/s")
    for name, e in errs.items():
        print(f"[kernels]   {name}: max abs diff vs plain {e:.6g}")
    if not np.isfinite(pmax) or pmax <= 0:
        fail(f"visco plain run has peak |p| = {pmax}")
    if bad:
        fail(f"visco kernels disagree with the plain version (field, max "
             f"abs diff, max |plain|): {bad}")

    times = {}
    if device == "cuda":
        s = F.step_scalars(grid, 10, oz)
        work = _copy_state(st_k)
        times["visco_velocity"] = (
            _timed(lambda: V.visco_velocity(work, co, s[0], s[1]), 20),
            _timed(lambda: V.visco_velocity_ref(work, co, s[0], s[1]), 5),
        )
        times["visco_stress"] = (
            _timed(lambda: V.visco_stress(work, co), 20),
            _timed(lambda: V.visco_stress_ref(work, co), 5),
        )
        times["visco_stress_dft"] = (
            _timed(lambda: V.visco_stress(work, co, s[2], s[3]), 20),
            _timed(lambda: V.visco_stress_ref(work, co, s[2], s[3]), 5),
        )
        cells = float(np.prod(shape))
        step_k = times["visco_velocity"][0] + times["visco_stress"][0]
        step_p = times["visco_velocity"][1] + times["visco_stress"][1]
        for name, (tk, tp) in times.items():
            print(f"[kernels]   {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms")
        print(f"[kernels] visco quiet step: kernel {step_k:.4f} ms/step "
              f"({cells / step_k / 1e3:.1f} Mcell-updates/s), plain "
              f"{step_p:.4f} ms/step ({cells / step_p / 1e3:.1f} "
              f"Mcell-updates/s)")
    return errs, times


def check_bhte(shape=KERNEL_SHAPE, n_steps=BHTE_STEPS,
               heat_steps=BHTE_HEAT_STEPS, device="cuda"):
    from babelbrain_tpu_torch.materials import build_thermal_material_list
    from babelbrain_tpu_torch.ops import bhte as B
    from babelbrain_tpu_torch.ops import bhte_kernels as K

    mats = build_thermal_material_list(ct_table(), ct_mode=True,
                                       segmented_brain=False)
    idx = ct_index_volume(shape)
    dx = 1482.3 / F0 / PPW
    dt = 0.01
    # focused heating blob in the brain layer, hot enough to cross 43 C
    n1, n2, n3 = shape
    ii, jj, kk = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    r2 = ((ii - n1 / 2) ** 2 + (jj - n2 / 2) ** 2
          + ((kk - 0.7 * n3) / 3.0) ** 2) / 8.0**2
    p = (3e6 * np.exp(-r2)).astype(np.float32)
    Q = torch.as_tensor(B.absorption_heating(p, idx, mats, 0.3), device=device)
    co = B.make_bhte_coeffs(B._build_coeff_maps(idx, mats, dx, dt), device)
    t_art = 37.0
    T0 = torch.as_tensor(
        np.asarray(mats.init_temperature, np.float32)[idx], device=device
    )

    def run(step):
        T, out = T0.clone(), torch.empty_like(T0)
        dose = torch.zeros_like(T0)
        peak = torch.full_like(T0, -1e9)
        for n in range(n_steps):
            q = Q if n < heat_steps else None
            T_new = step(T, dose, peak, co, q, t_art, out)
            T, out = T_new, T
        return T, dose, peak

    Tk, dk, pk = run(lambda T, d, pe, c, q, ta, o:
                     K.bhte_step(T, d, pe, c, q, ta, T_out=o))
    Tp, dp, pp = run(K.bhte_step_ref)
    dT = float((Tk - Tp).abs().max())
    dpeak = float((pk - pp).abs().max())
    ddose = float(((dk - dp).abs() / dp.abs().clamp_min(1e-30)).max())
    tmax = float(pp.max())
    print(f"[kernels] bhte {shape} {n_steps} steps ({heat_steps} heating): "
          f"peak T {tmax:.4f} C, max|dT| {dT:.3g} C, max|dpeak| {dpeak:.3g} C, "
          f"dose max rel diff {ddose:.3g}")
    if not (dT <= 1e-5 and dpeak <= 1e-5 and ddose <= 1e-5):
        fail("bhte kernel disagrees with the plain version "
             "(|dT| <= 1e-5 C and dose rtol <= 1e-5 required)")
    times = {}
    if device == "cuda":
        T, out = Tk.clone(), torch.empty_like(Tk)
        tk = _timed(lambda: K.bhte_step(T, dk, pk, co, Q, t_art, T_out=out), 50)
        tp = _timed(lambda: K.bhte_step_ref(T, dk, pk, co, Q, t_art, out), 10)
        cells = float(np.prod(shape))
        print(f"[kernels]   bhte_step: kernel {tk:.4f} ms/step "
              f"({cells / tk / 1e3:.1f} Mcell-updates/s), plain {tp:.4f} "
              f"ms/step ({cells / tp / 1e3:.1f} Mcell-updates/s)")
        times["bhte_step"] = (tk, tp)
    return {"bhte_step": max(dT, dpeak)}, times


# ---------------------------------------------------------------------------
# phase 4: the CT-mode slice
# ---------------------------------------------------------------------------


def build_head():
    """(labels, ct_hu, affine) of the procedural digital head at 2 mm
    isotropic: skull sandwich with published adult thickness statistics,
    per-compartment HU values and one intracranial air sinus."""
    N = N_HEAD
    rng = np.random.default_rng(11)
    aff = np.diag([VOX, VOX, VOX, 1.0])
    aff[:3, 3] = -N
    ii, jj, kk = np.mgrid[0:N, 0:N, 0:N]
    ras = np.stack([ii, jj, kk], -1) * VOX - N
    x, y, z = ras[..., 0], ras[..., 1], ras[..., 2]
    r = np.sqrt((x / 0.97) ** 2 + (y / 0.92) ** 2 + z ** 2) + 1e-9
    ux, uy, uz = x / r, y / r, z / r
    r_skull_out = 60.0 * (1.0 + 0.05 * ux - 0.03 * uy * uz)
    thick = np.clip(
        6.3 + 1.5 * (0.8 * uz - 0.5 * ux * uy + 0.4 * uy), 3.5, 9.5
    )
    table = np.clip(1.8 + 0.3 * uz, 1.2, 2.4)
    d_out = r - r_skull_out
    skin = (d_out > 0) & (d_out <= 5.0)
    outer_table = (d_out <= 0) & (d_out > -table)
    diploe = (d_out <= -table) & (d_out > -(thick - table))
    inner_table = (d_out <= -(thick - table)) & (d_out > -thick)
    brain = d_out <= -thick
    sinus = (
        np.sqrt(x ** 2 + (y + 40) ** 2 + (z - 25) ** 2) < 7
    ) & (brain | diploe | inner_table)

    labels = np.zeros((N, N, N), np.int32)
    labels[skin] = 5
    labels[outer_table | inner_table | diploe] = 7
    csf = brain & (d_out > -(thick + 3.0))
    labels[brain] = 2
    labels[csf] = 4
    labels[d_out <= -(thick + 18.0)] = 1
    labels[sinus] = 0  # air cavity

    ct = np.full((N, N, N), 20.0)
    ct[skin] = 45.0 + rng.normal(0, 8, skin.sum())
    ct[brain] = 35.0 + rng.normal(0, 6, brain.sum())
    ct[outer_table] = 1550.0 + rng.normal(0, 180, outer_table.sum())
    ct[inner_table] = 1450.0 + rng.normal(0, 180, inner_table.sum())
    ct[diploe] = 550.0 + rng.normal(0, 140, diploe.sum())
    ct[sinus] = -1000.0
    ct = np.clip(ct, -1000.0, 2100.0)
    return labels, ct, aff


def _counted_modules():
    """The kernel modules whose wrappers count launches and plain calls."""
    from babelbrain_tpu_torch.ops import (
        bhte_kernels,
        fdtd_kernels,
        fdtd_visco_kernels,
    )

    return fdtd_kernels, fdtd_visco_kernels, bhte_kernels


def reset_counts():
    for mod in _counted_modules():
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0


def read_counts():
    launches, plain = {}, {}
    for mod in _counted_modules():
        launches.update(mod.launches)
        plain.update(mod.plain_calls)
    return launches, plain


def run_stages(cfg, labels, aff, ct, target, direction, params, mask_shape):
    """The stage functions ``run_case`` calls, in its order (no files
    written): CT mode with a CT volume, label mode with ``ct=None``."""
    from babelbrain_tpu_torch.materials.ct_mapping import map_hu_to_properties
    from babelbrain_tpu_torch.pipeline.acoustic import (
        position_transducer,
        run_acoustic_sim,
    )
    from babelbrain_tpu_torch.pipeline.domain import (
        build_ct_materials,
        build_domain,
        build_label_materials,
        fit_domain_offsets,
    )
    from babelbrain_tpu_torch.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        build_transducer,
    )
    from babelbrain_tpu_torch.pipeline.step1 import generate_mask
    from babelbrain_tpu_torch.pipeline.thermal import run_sonication
    from babelbrain_tpu_torch.utils.timing import stage_timer

    spec = TRANSDUCER_REGISTRY[cfg.tx_system]
    ct_mode = ct is not None
    with stage_timer("Step1 domain generation", level=2, step=1):
        s1 = generate_mask(
            labels, aff, target, direction, cfg.frequency, cfg.ppw,
            shape=mask_shape, ct_data=ct, ct_affine=aff if ct_mode else None,
            hu_threshold=cfg.hu_threshold, device=cfg.device,
        )
    with stage_timer("Step2 acoustic simulation", level=2, step=2):
        if ct_mode:
            rho, sos, att = map_hu_to_properties(
                s1.unique_hu, cfg.frequency, cfg.mapping_method
            )
            materials = build_ct_materials(cfg.frequency, cfg.segment_brain,
                                           rho, sos, att)
        else:
            materials = build_label_materials(cfg.frequency,
                                              cfg.segment_brain)
        offsets, shrinks = fit_domain_offsets(
            np.flip(s1.mask, axis=2), s1.dx_mm * 1e-3, spec.diameter,
            spec.focal_length,
        )
        air = s1.air_mask if ct_mode and s1.air_mask.any() else None
        dom = build_domain(
            s1.mask, cfg.frequency, cfg.ppw, materials=materials,
            ct_index_map=s1.ct_index if ct_mode else None, air_mask=air,
            offsets=offsets, shrink_cells=shrinks,
        )
        tx = build_transducer(spec, cfg.frequency)
        tx = position_transducer(tx, dom, spec.focal_length)
        result = run_acoustic_sim(dom, tx, cfg.source_amp_pa,
                                  device=cfg.device)
    data = result.data_for_sim
    with stage_timer("Step3 thermal simulation", level=2, step=3):
        thermal = run_sonication(
            result.p_amp, np.asarray(data["p_amp_water"]),
            data["MaterialMap"], materials, dom.dx, data["TargetLocation"],
            params, ct_mode=ct_mode, segmented=cfg.segment_brain,
            frequency=cfg.frequency, device=cfg.device,
        )
    return {"step1": s1, "domain": dom, "acoustic": result,
            "thermal": thermal, "data_for_sim": data}


def run_slice(have_h5py: bool, mode="ct", mask_shape=MASK_SHAPE,
              device="cuda", tx_system="CTX_500", params=None):
    """One main path on the digital head: ``mode`` "ct" (CT volume given:
    fluid FDTD) or "label" (labels only: viscoelastic FDTD). Returns the
    launch counts of the run."""
    from babelbrain_tpu_torch.pipeline.runner import CaseConfig, run_case
    from babelbrain_tpu_torch.pipeline.thermal import SonicationParams
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    tag = f"[slice {mode}]"
    labels, ct, aff = build_head()
    ct = ct if mode == "ct" else None
    params = params or SonicationParams(
        duration_on=30.0, duration_off=30.0, duty_cycle=0.3, isppa=10.0
    )
    target, direction = [0.0, 0.0, 20.0], [0, 0, -1]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CaseConfig(tx_system=tx_system, frequency=F0, ppw=PPW,
                         mapping_method=MAPPING, output_dir=tmp,
                         prefix="chip_smoke", device=device)
        clear_spans()
        reset_counts()
        t0 = time.time()
        if have_h5py:
            print(f"{tag} driving run_case (h5py present)")
            res = run_case(cfg, labels, aff, target, direction, ct_data=ct,
                           ct_affine=aff if ct is not None else None,
                           thermal_params=params, mask_shape=mask_shape)
        else:
            print(f"{tag} h5py missing: driving the stage functions of "
                  "run_case in its order, writing no files")
            res = run_stages(cfg, labels, aff, ct, target, direction, params,
                             mask_shape)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches, plain = read_counts()
    spans = recorded_spans()
    dom = res["domain"]
    shear = int((np.asarray(dom.materials)[:, 2] > 0).sum())
    print(f"{tag} FDTD grid {dom.material_map.shape} n_steps {dom.n_steps} "
          f"sensor_start {dom.sensor_start} ppp {dom.ppp} "
          f"materials {len(dom.materials)} ({shear} with shear); "
          f"wall {wall:.2f} s")
    for label, dt in spans:
        print(f"{tag} span {label}: {dt:.3f} s")

    p_amp = np.asarray(res["data_for_sim"]["p_amp"])
    th = res["thermal"]
    if not np.isfinite(p_amp).all() or p_amp.max() <= 0:
        fail(f"{mode}: p_amp not finite or empty")
    for name in ("temperature_end", "temperature_peak", "dose"):
        if not np.isfinite(getattr(th, name)).all():
            fail(f"{mode}: thermal {name} not finite")
    s1 = res["step1"]
    mask, tgt, dx_mm = s1.mask, np.asarray(s1.target_idx), s1.dx_mm
    pk = np.unravel_index(np.argmax(p_amp), p_amp.shape)
    brain = np.isin(mask, (4, 5))
    fk = np.unravel_index(np.argmax(np.where(brain, p_amp, 0.0)), p_amp.shape)
    off_mm = (np.asarray(fk) - tgt) * dx_mm
    print(f"{tag} global max p_amp {p_amp.max():.6g} Pa at "
          f"{tuple(int(v) for v in pk)} label {int(mask[pk])}")
    print(f"{tag} focal peak in the brain {p_amp[fk]:.6g} Pa at "
          f"{tuple(int(v) for v in fk)} label {int(mask[fk])}, offset from "
          f"the target {tuple(round(float(v), 2) for v in off_mm)} mm; "
          f"pressure ratio {th.pressure_ratio:.4f}; max T "
          f"{th.temperature_peak.max():.4f} C; TI {th.metrics['TI']:.4f} "
          f"TIS {th.metrics['TIS']:.4f} TIC {th.metrics['TIC']:.4f} C")
    # the focal spot must form inside the brain on the beam axis: within
    # 2 mm of the target laterally and 15 mm along the beam (the focal shift
    # of the 64 mm CTX-500 bowl plus the skull's)
    if not brain[fk] or p_amp[fk] <= 0:
        fail(f"{mode}: no focal peak inside the brain")
    if np.hypot(off_mm[0], off_mm[1]) > 2.0 or abs(off_mm[2]) > 15.0:
        fail(f"{mode}: focal peak in the brain {off_mm} mm off the target")

    n_on = int(round(params.duration_on / 0.01))
    n_off = int(round(params.duration_off / 0.01))
    fdtd, stress = ("fluid", "pressure") if mode == "ct" else ("visco",
                                                               "stress")
    expect = dict({k: 0 for k in launches}, **{
        f"{fdtd}_velocity": dom.n_steps,
        f"{fdtd}_{stress}": dom.sensor_start,
        f"{fdtd}_{stress}_dft": dom.n_steps - dom.sensor_start,
        "bhte_step": n_on + n_on + n_off,  # locating run + schedule
    })
    print(f"{tag} launches {launches}; plain calls {plain}")
    if device == "cuda":
        if launches != expect:
            fail(f"{mode}: launch counts {launches} != expected {expect}")
        if any(plain.values()):
            fail(f"{mode}: plain versions ran on the main path: {plain}")
    return launches


# ---------------------------------------------------------------------------

FLUID_CU = "babelbrain_tpu_torch/csrc/fdtd_fluid.cu"
VISCO_CU = "babelbrain_tpu_torch/csrc/fdtd_visco.cu"
PALLAS = "babelbrain_tpu/ops/fdtd_pallas.py"
SOURCES = {
    "fluid_velocity": ("fluid_velocity_kernel", FLUID_CU, f"{PALLAS}:262"),
    "fluid_pressure": ("fluid_pressure_kernel", FLUID_CU, f"{PALLAS}:370"),
    "fluid_pressure_dft": ("fluid_pressure_kernel<WITH_DFT>", FLUID_CU,
                           f"{PALLAS}:370"),
    "bhte_step": ("bhte_step_kernel", "babelbrain_tpu_torch/csrc/bhte.cu",
                  "babelbrain_tpu/ops/bhte_pallas.py:109"),
    # B5 vel_kernel / stress_kernel; the same step as B6-B8
    "visco_velocity": ("visco_velocity_kernel", VISCO_CU, f"{PALLAS}:3025"),
    "visco_stress": ("visco_stress_kernel", VISCO_CU, f"{PALLAS}:3196"),
    "visco_stress_dft": ("visco_stress_kernel<WITH_DFT>", VISCO_CU,
                         f"{PALLAS}:3196"),
}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (this script drives the port on the GPU only)")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "babelbrain_tpu_torch")):
        fail(f"babelbrain_tpu_torch not found next to {__file__}")
    sys.path.insert(0, root)

    have = probe()
    build()
    errs, times = check_fluid()
    for check in (check_visco, check_bhte):
        e, t = check()
        errs.update(e)
        times.update(t)
    launches = {k: 0 for k in SOURCES}
    for mode in ("ct", "label"):
        for k, v in run_slice(have["h5py"], mode).items():
            launches[k] += v

    table = []
    for k, (name, source, replaces) in SOURCES.items():
        b_ms, b_by = bound(k, KERNEL_SHAPE)
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches[k]),
            "max_abs_err": errs[k], "ms": times[k][0],
            "plain_ms": times[k][1], "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes an FDTD or BHTE step
            "library_ms": None,
        })
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
