"""Staggered-grid FDTD for transcranial ultrasound: fluid and viscoelastic.

PyTorch counterpart of ``babelbrain_tpu/ops/fdtd.py``: CT mode (fluid,
shear-free media) and label mode (viscoelastic media with shear in the
skull), driven by a CW plane source, a stress point (refocusing) or a
volumetric velocity source (dome transducers). The host numerics (CPML
profiles, SLS coefficient tuning, the CFL bound, the indexed material
table and the reflector fold) are exact numpy copies. Both media gather
their properties per voxel from the indexed table; the JAX XLA path expands
them into volumes, with the same float32 values.
The time loop is a Python loop over ``ops.fdtd_kernels`` (fluid) or
``ops.fdtd_visco_kernels`` (viscoelastic): on a CUDA device each step is
two hand-written kernels (velocity, then pressure or stress; a volumetric source
adds ``ops.fdtd_sources`` between them); on the CPU the same step runs as
plain PyTorch.

Physics (see the JAX module for the derivations): 4th-order staggered
differences, CPML with slab-only psi memory, one SLS relaxation mechanism
per modulus tuned exactly at the carrier, a CW plane source with per-pixel
amplitude and phase, and the carrier DFT accumulated over the sensor window.

Diagnostics (``ops.fdtd_extras``): the 14 ``sel_maps`` RMS / peak maps (one
more kernel after the step), and the pressure series at ``monitor_ijk``
voxels every ``sensor_subsampling`` steps of the window and the raw
pressure capture of ``run_fdtd_capture``, both sampled by the step's own
pressure / stress kernel.

``run_fdtd_batch`` runs B plane-source cases on one card from one setup.
The port compiles no executable per grid, so it keeps no counterpart of the
JAX package's executable memo.

Not ported yet: multi-device meshes (``NotImplementedError`` naming ROADMAP
Queue A item 6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.timing import stage_timer
from .fdtd_kernels import (
    _C1,
    _C2,
    FluidCoeffs,
    FluidState,
    fluid_pressure,
    fluid_velocity,
)
from .fdtd_visco_kernels import (
    ViscoCoeffs,
    ViscoState,
    visco_stress,
    visco_velocity,
)
from .fdtd_extras import Diagnostics, Monitor, check_sel_maps, monitor_index
from .fdtd_sources import VolumeSource, velocity_volume_source

SOURCE_TYPES = ("velocity_plane", "stress_point", "velocity_volume")


# ---------------------------------------------------------------------------
# CPML
# ---------------------------------------------------------------------------


def cpml_profiles(n, npml, dx, dt, cmax, reflection_limit=1e-5, m=3.0):
    """1-D CPML (b, a) coefficient profiles for integer and half positions.

    sigma(d) = sigma_max * (d/L)^m with
    sigma_max = -(m+1) * cmax * ln(R) / (2 L)   [Roden & Gedney 2000]
    b = exp(-sigma dt), a = b - 1 (kappa=1, alpha=0).
    Returns dict with 'b_int', 'a_int', 'b_half', 'a_half' arrays of length n
    (nonzero only in the first/last npml cells).
    """
    L = npml * dx
    sigma_max = -(m + 1.0) * cmax * np.log(reflection_limit) / (2.0 * L)

    def sigma_at(pos):  # pos: distance from interior edge of PML, in cells
        d = np.clip(pos, 0.0, npml) / npml
        return sigma_max * d**m

    out = {}
    for name, off in (("int", 0.0), ("half", 0.5)):
        coord = np.arange(n) + off
        depth_lo = npml - coord  # >0 inside lo PML
        depth_hi = coord - (n - 1 - npml)
        sig = sigma_at(depth_lo) + sigma_at(depth_hi)
        b = np.exp(-sig * dt)
        a = b - 1.0
        a[sig == 0] = 0.0
        out[f"b_{name}"] = b.astype(np.float32)
        out[f"a_{name}"] = a.astype(np.float32)
    return out


def _build_cpml_profiles_np(shape, npml, dx, dt, cmax, reflection_limit):
    """Per-axis slab-trimmed (b, a) coefficient sets as numpy arrays."""
    out = []
    ns = npml + 2
    for axis, n in enumerate(shape):
        prof = cpml_profiles(n, npml, dx, dt, cmax, reflection_limit)
        entry = {}
        for stag in ("int", "half"):
            b = prof[f"b_{stag}"]
            a = prof[f"a_{stag}"]
            entry[stag] = {
                "b_lo": b[:ns], "a_lo": a[:ns], "b_hi": b[-ns:], "a_hi": a[-ns:],
            }
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# SLS (standard linear solid) coefficient tuning
# ---------------------------------------------------------------------------


def sls_coefficients(materials: np.ndarray, frequency: float, dt: float):
    """Per-material solver coefficients with exact carrier-frequency tuning.

    materials: (M, 5) [rho, c_long, c_shear, att_long (Np/m), att_shear].
    Returns dict of (M,) float64 arrays:
      pi_u, mu_u    unrelaxed moduli factors used in the stress update
      c_rp, c_rs    memory-variable feed coefficients (include dt folding)
      b_r           memory decay factor
      rho_inv
      viscous       True if any material has attenuation
    """
    m = np.asarray(materials, np.float64)
    rho, cl, cs, al, ash = m[:, 0], m[:, 1], m[:, 2], m[:, 3], m[:, 4]
    omega = 2 * np.pi * frequency

    def modulus(c, alpha):
        """Complex modulus with loss angle from (c, alpha) at omega."""
        q = alpha * c / omega
        s = (1.0 / np.where(c > 0, c, 1.0)) * (1.0 - 1j * q)  # complex slowness
        M = rho / s**2
        return np.where(c > 0, M, 0.0)

    Mp = modulus(cl, al)  # P modulus rho*cl^2 e^{i delta_p}
    Ms = modulus(cs, ash)

    # shared tau_sigma per material from the P loss angle
    delta_p = np.angle(Mp + (Mp == 0))
    x = np.tan(np.pi / 4 + delta_p / 2)  # omega*tau_eps_p
    tau_sig = 1.0 / (omega * x)
    tau_eps_p = x / omega

    # S relaxation time chosen to hit the S loss angle with shared tau_sigma
    delta_s = np.angle(Ms + (Ms == 0))
    tau_eps_s = np.tan(delta_s + np.arctan(omega * tau_sig)) / omega
    tau_eps_s = np.where(cs > 0, tau_eps_s, tau_sig)

    def relaxed(M_target, tau_eps):
        F = (1 + 1j * omega * tau_eps) / (1 + 1j * omega * tau_sig)
        MR = np.real(M_target / F)
        return MR

    Pi_R = relaxed(Mp, tau_eps_p)
    Mu_R = relaxed(Ms, tau_eps_s)

    tp = tau_eps_p / tau_sig
    ts = tau_eps_s / tau_sig
    pi_u = Pi_R * tp
    mu_u = Mu_R * ts

    # memory update: r^{n+1} = b_r r^n - a_r * phi,
    #   phi = c_rp * theta_dot - 2 c_rs * (theta_dot - d v_i/d x_i) etc.
    half = dt / (2.0 * tau_sig)
    b_r = (1.0 - half) / (1.0 + half)
    a_r = dt / (1.0 + half)
    c_rp = Pi_R * (tp - 1.0) / tau_sig * a_r / dt  # folded so phi*dt later
    c_rs = Mu_R * (ts - 1.0) / tau_sig * a_r / dt
    # snap lossless materials to exactly zero feed (kills fp noise from tan(pi/4))
    c_rp = np.where(al > 0, c_rp, 0.0)
    c_rs = np.where(ash > 0, c_rs, 0.0)

    return {
        "pi_u": pi_u,
        "mu_u": mu_u,
        "c_rp": c_rp * dt,
        "c_rs": c_rs * dt,
        "b_r": b_r,
        "rho_inv": 1.0 / rho,
        "viscous": bool(np.any(al > 0) or np.any(ash > 0)),
    }


# ---------------------------------------------------------------------------
# simulation setup & run
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FDTDGrid:
    shape: tuple  # (N1, N2, N3)
    dx: float
    dt: float
    n_steps: int
    frequency: float
    npml: int = 12
    reflection_limit: float = 1e-5
    sensor_start: int = 0  # first step of the DFT window
    source_plane_z: int = 13  # z-index of the CW source plane
    source_type: str = "velocity_plane"  # or "stress_point" / "velocity_volume"
    source_ijk: tuple = (0, 0, 0)  # for stress_point
    ramp_cycles: float = 4.0


def stable_dt(dx: float, cmax: float, cfl: float = 1.0) -> float:
    """4th-order staggered-grid 3-D stability bound."""
    return cfl * dx / (cmax * np.sqrt(3.0) * (abs(_C1) + abs(_C2)))


def _build_indexed_materials(coefs, mat_idx, reflector_mask):
    """Indexed materials of the FDTD kernels (fluid and viscoelastic).

    Returns ``(idx int32 (N1,N2,N3), table (6, M) f32)`` with table rows
    [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r]. Reflector (air-cavity) voxels get
    twin materials with zeroed moduli and feeds: the pressure-release fold
    of the JAX ``_fold_reflector`` (the reference passes air cavities as a
    ``ReflectorMask`` forced to zero stress every step,
    `BabelIntegrationBASE.py:2365`; with zero initial conditions that equals
    zeroing pi_u, mu_u, c_rp and c_rs there), kept per material so the table
    gather gives the folded volumes' values exactly. The JAX version's
    128-lane table cap and z window test are limits of the TPU's gather and
    do not apply here.
    """
    keys = ("rho_inv", "pi_u", "mu_u", "c_rp", "c_rs", "b_r")
    M = len(np.asarray(coefs["pi_u"]))
    idx = np.asarray(mat_idx).astype(np.int32)
    has_refl = reflector_mask is not None and np.asarray(reflector_mask).any()
    tab = np.zeros((6, 2 * M if has_refl else M), np.float32)
    for r, k in enumerate(keys):
        v = np.asarray(coefs[k], np.float32)
        tab[r, :M] = v
        if has_refl:
            tab[r, M:] = v if k in ("rho_inv", "b_r") else 0.0
    if has_refl:
        idx = np.where(np.asarray(reflector_mask, bool), idx + M, idx)
    return idx.astype(np.int32), tab


def _to_device(device):
    """numpy -> contiguous float32 tensor on ``device``."""
    dev = torch.device(device)
    return lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32), device=dev
    )


def _pack_profiles(profiles_np, stag, f32):
    """(3, 4, ns) [b_lo, a_lo, b_hi, a_hi] profiles per axis."""
    return f32(np.stack([
        np.stack([profiles_np[ax][stag][k]
                  for k in ("b_lo", "a_lo", "b_hi", "a_hi")])
        for ax in range(3)
    ]))


def _plane(src_amp, src_phase, f32) -> dict:
    """The plane-source fields of the coefficients: amplitude and cos/sin
    of the phase."""
    phase = f32(src_phase)
    return dict(src_amp=f32(src_amp), src_cph=torch.cos(phase),
                src_sph=torch.sin(phase))


def _step_constants(grid: FDTDGrid, viscous: bool) -> dict:
    return dict(dt_dx=grid.dt / grid.dx, inv_dx=1.0 / grid.dx,
                half_dt=grid.dt * 0.5, zsrc=int(grid.source_plane_z),
                viscous=bool(viscous))


def _make_coeffs(cls, mat_idx, table, profiles_np, src_amp, src_phase,
                 grid: FDTDGrid, viscous: bool, device):
    """``cls`` (FluidCoeffs or ViscoCoeffs) with the step-invariant inputs
    on ``device``; ``mat_idx``/``table`` as ``_build_indexed_materials``
    returns them."""
    f32 = _to_device(device)
    idx = np.ascontiguousarray(mat_idx, np.int32)
    if idx.min() < 0 or idx.max() >= table.shape[1]:
        raise ValueError(
            f"material index outside the table's {table.shape[1]} materials"
        )
    return cls(
        mat_idx=torch.as_tensor(idx, device=torch.device(device)),
        table=f32(table),
        cpml_half=_pack_profiles(profiles_np, "half", f32),
        cpml_int=_pack_profiles(profiles_np, "int", f32),
        **_plane(src_amp, src_phase, f32), **_step_constants(grid, viscous),
    )


def make_fluid_coeffs(mat_idx, table, profiles_np, src_amp, src_phase,
                      grid: FDTDGrid, viscous: bool, device) -> FluidCoeffs:
    """The step-invariant inputs of the fluid step on ``device``."""
    return _make_coeffs(FluidCoeffs, mat_idx, table, profiles_np, src_amp,
                        src_phase, grid, viscous, device)


def make_visco_coeffs(mat_idx, table, profiles_np, src_amp, src_phase,
                      grid: FDTDGrid, viscous: bool, device) -> ViscoCoeffs:
    """The step-invariant inputs of the viscoelastic step on ``device``."""
    return _make_coeffs(ViscoCoeffs, mat_idx, table, profiles_np, src_amp,
                        src_phase, grid, viscous, device)


def step_scalars(grid: FDTDGrid, n: int, oz_scale: float,
                 point_amp: float = 0.0):
    """Host scalars of step ``n``: (s_sin, s_cos, cosw, sinw, s_point).

    s_sin / s_cos are sin(wt) / cos(wt) times the half-cosine source ramp
    and the pressure->velocity scale; cosw / sinw are the carrier DFT
    weights; s_point = point_amp sin(wt) ramp is the stress-point value.
    Evaluated in float64 (the kernels take them as float32).
    """
    omega = 2.0 * np.pi * grid.frequency
    wt = omega * (n * grid.dt)
    ramp_steps = grid.ramp_cycles / grid.frequency / grid.dt
    ramp = 0.5 * (1.0 - np.cos(np.pi * n / ramp_steps)) if n < ramp_steps else 1.0
    scale = ramp * oz_scale
    return (float(np.sin(wt) * scale), float(np.cos(wt) * scale),
            float(np.cos(wt)), float(np.sin(wt)),
            float(point_amp * np.sin(wt) * ramp))


def point_index(grid: FDTDGrid) -> int | None:
    """C-order linear index of a ``stress_point`` source cell, else None."""
    if grid.source_type != "stress_point":
        return None
    return int(np.ravel_multi_index(tuple(int(v) for v in grid.source_ijk),
                                    grid.shape))


def _advance(velocity, stress, st, co, grid, n, oz_scale, point_amp, vsrc,
             monitor):
    """One leapfrog step: velocity kernel, volumetric source (if any), then
    the pressure / stress kernel with the point source (if any), inside the
    sensor window the DFT, and at a sample step the monitor sample."""
    s_sin, s_cos, cosw, sinw, s_pt = step_scalars(grid, n, oz_scale,
                                                  point_amp)
    velocity(st, co, s_sin, s_cos)
    if vsrc is not None:
        velocity_volume_source(st.vx, st.vy, st.vz, vsrc, s_sin, s_cos)
    pt = point_index(grid)
    point = None if pt is None else (pt, s_pt)
    if n >= grid.sensor_start:
        stress(st, co, cosw, sinw, point, monitor)
    else:
        # quiet phase: the DFT window is closed, accumulators untouched
        stress(st, co, point=point, monitor=monitor)


def fluid_step(st: FluidState, co: FluidCoeffs, grid: FDTDGrid, n: int,
               oz_scale: float, point_amp: float = 0.0,
               vsrc: VolumeSource | None = None,
               monitor: Monitor | None = None) -> None:
    """Advance the fluid state by step ``n`` (velocity, then pressure);
    ``monitor``: the sample this step takes (``Diagnostics.monitor``)."""
    _advance(fluid_velocity, fluid_pressure, st, co, grid, n, oz_scale,
             point_amp, vsrc, monitor)


def visco_step(st: ViscoState, co: ViscoCoeffs, grid: FDTDGrid, n: int,
               oz_scale: float, point_amp: float = 0.0,
               vsrc: VolumeSource | None = None,
               monitor: Monitor | None = None) -> None:
    """Advance the viscoelastic state by step ``n`` (velocity, then
    stress); ``monitor``: the sample this step takes."""
    _advance(visco_velocity, visco_stress, st, co, grid, n, oz_scale,
             point_amp, vsrc, monitor)


def run_fdtd(
    mat_idx: np.ndarray,
    materials: np.ndarray,
    grid: FDTDGrid,
    source_amp: np.ndarray | None = None,
    source_phase: np.ndarray | None = None,
    point_amp: float = 0.0,
    mesh=None,
    reflector_mask=None,
    volume_source: VolumeSource | dict | None = None,
    sel_maps: tuple = (),
    monitor_ijk: np.ndarray | None = None,
    sensor_subsampling: int = 1,
    *,
    device="cuda",
):
    """Run the CW simulation and return carrier amplitude/phase/peak maps.

    Parameters are those of the JAX ``run_fdtd`` in fluid or viscoelastic
    (shear) media, for each ``grid.source_type``: ``velocity_plane``
    (``source_amp``/``source_phase``), ``stress_point`` (``point_amp`` at
    ``grid.source_ijk``) and ``velocity_volume`` (``volume_source``: a
    ``VolumeSource`` on ``device``, or the JAX package's dense dict, turned
    into one here). ``device`` selects where the state lives
    (CUDA: the step kernels; CPU: their plain PyTorch versions). Both
    media use indexed materials (``_build_indexed_materials``).

    ``sel_maps``: extra maps named ``<Field>_rms`` / ``<Field>_peak``, Field
    in Pressure, Vx, Vy, Vz, Sigmaxx, Sigmayy, Sigmazz, accumulated over
    the sensor window. ``monitor_ijk``: (K, 3) voxels whose pressure is kept
    at steps ``sensor_start, sensor_start + sensor_subsampling, ...``. The
    JAX Pallas path samples at its fused depth instead; the values here are
    those of its XLA path.

    Returns dict with 'p_amp' (Pa), 'p_phase' (rad, FFT-bin convention of
    the reference), 'peak' (Pa), each (N1,N2,N3) float32 numpy arrays; plus
    one entry per ``sel_maps`` name, and 'sensor_series' (K, nT) float32 +
    'sensor_times' (nT,) float32 when ``monitor_ijk`` is given.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_fdtd(mesh=...): multi-GPU decomposition is ROADMAP Queue A "
            "item 6"
        )
    sel_maps = check_sel_maps(sel_maps)
    if int(sensor_subsampling) < 1:
        raise ValueError(f"sensor_subsampling={sensor_subsampling} < 1")
    with stage_timer("FDTD setup", level=3, step=2):
        step, st, co, oz_scale, vsrc = fdtd_setup(
            mat_idx, materials, grid, source_amp, source_phase,
            reflector_mask, volume_source, device=device,
        )
    sel = np.arange(grid.sensor_start, grid.n_steps, int(sensor_subsampling))
    diag = None
    if sel_maps or monitor_ijk is not None:
        with_series = monitor_ijk is not None
        diag = Diagnostics.create(
            st, grid.sensor_start, sel_maps,
            sample_steps=sel if with_series else (),
            index=(monitor_index(monitor_ijk, grid.shape, device)
                   if with_series else None),
        )
    _time_loop(step, st, co, grid, oz_scale, point_amp, vsrc, diag)

    result = _carrier(st, grid)
    if diag is not None and diag.extras is not None:
        result.update(diag.extras.read(grid.n_steps - grid.sensor_start))
    if monitor_ijk is not None:
        k = int(diag.index.shape[0])
        series = (diag.series.cpu().numpy() if diag.series is not None
                  else np.zeros((0, k), np.float32))
        result["sensor_series"] = series.T.astype(np.float32)
        result["sensor_times"] = (sel * grid.dt).astype(np.float32)
    return result


def _time_loop(step, st, co, grid, oz_scale, point_amp, vsrc, diag=None):
    """Steps 0..n_steps-1, each taking its monitor sample and followed by
    the maps' pass (with ``diag``)."""
    with stage_timer("FDTD time loop", level=3, step=2):
        for n in range(grid.n_steps):
            if diag is None:
                step(st, co, grid, n, oz_scale, point_amp, vsrc)
                continue
            step(st, co, grid, n, oz_scale, point_amp, vsrc, diag.monitor(n))
            diag.record(st, n)
        if st.peak.device.type == "cuda":
            torch.cuda.synchronize()  # the readback below waits anyway


def _carrier(st, grid: FDTDGrid) -> dict:
    """'p_amp', 'p_phase' and 'peak' from the DFT accumulators."""
    acc_c = st.acc_cos.cpu().numpy()
    acc_s = st.acc_sin.cpu().numpy()
    n_win = grid.n_steps - grid.sensor_start
    # FFT-bin convention: X = sum p e^{-i w t} = C - iS; amp=2|X|/N
    amp = 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2)
    phase = np.arctan2(-acc_s, acc_c)
    return {
        "p_amp": amp.astype(np.float32),
        "p_phase": phase.astype(np.float32),
        "peak": st.peak.cpu().numpy(),
    }


def run_fdtd_capture(
    mat_idx: np.ndarray,
    materials: np.ndarray,
    grid: FDTDGrid,
    source_amp: np.ndarray | None = None,
    source_phase: np.ndarray | None = None,
    point_amp: float = 0.0,
    *,
    t_start: int = 0,
    t_end: int | None = None,
    subsample: int = 1,
    sensor_mask: np.ndarray | None = None,
    reflector_mask=None,
    device="cuda",
):
    """Raw pressure time-series capture (transient / non-CW analysis).

    The run of ``run_fdtd`` (plane or stress-point source, fluid or shear
    media) that also keeps the pressure after steps
    ``t_start + (m+1)*subsample - 1`` of [t_start, t_end), at the voxels of
    ``sensor_mask`` (bool volume) or, with None, at every voxel. The samples
    go into one device buffer of ``n_samples * n_sensors * 4`` bytes, read
    back once at the end.

    Returns dict with 'series' (n_samples, n_sensors) float32 in
    ``np.argwhere`` order (or (n_samples,) + grid.shape without a mask),
    'times' (s), 'sensor_ijk' (n_sensors, 3) with a mask, and the
    'p_amp'/'p_phase'/'peak' carrier outputs of the same run.
    """
    t_end = int(t_end if t_end is not None else grid.n_steps)
    t_start = int(t_start)
    sub = int(subsample)
    if not (0 <= t_start < t_end <= grid.n_steps) or sub < 1:
        raise ValueError("capture window must satisfy "
                         "0 <= t_start < t_end <= n_steps, subsample >= 1")
    if grid.source_type not in ("velocity_plane", "stress_point"):
        raise ValueError(
            f"run_fdtd_capture drives plane and point sources, not "
            f"{grid.source_type!r}"
        )
    with stage_timer("FDTD setup", level=3, step=2):
        step, st, co, oz_scale, vsrc = fdtd_setup(
            mat_idx, materials, grid, source_amp, source_phase,
            reflector_mask, device=device,
        )
    ijk = None
    if sensor_mask is not None:
        ijk = np.argwhere(np.asarray(sensor_mask, bool))
    n_groups = (t_end - t_start) // sub
    steps = t_start + (np.arange(n_groups) + 1) * sub - 1
    diag = Diagnostics.create(
        st, grid.sensor_start, sample_steps=steps,
        index=None if ijk is None else monitor_index(ijk, grid.shape, device),
    )
    _time_loop(step, st, co, grid, oz_scale, point_amp, vsrc, diag)

    out = _carrier(st, grid)
    k = int(np.prod(grid.shape)) if ijk is None else len(ijk)
    series = (diag.series.cpu().numpy() if diag.series is not None
              else np.zeros((0, k), np.float32))
    out["series"] = (series if ijk is not None
                     else series.reshape((n_groups,) + tuple(grid.shape)))
    out["times"] = (steps * grid.dt).astype(np.float32)
    if ijk is not None:
        out["sensor_ijk"] = ijk
    return out


def fdtd_setup(mat_idx, materials, grid: FDTDGrid, source_amp=None,
               source_phase=None, reflector_mask=None,
               volume_source: VolumeSource | dict | None = None, *,
               device="cuda"):
    """What ``run_fdtd`` steps with, for the same arguments: (step function,
    zero state, step-invariant inputs, pressure->velocity scale, sparse
    volume source or None)."""
    if grid.source_type not in SOURCE_TYPES:
        raise ValueError(f"unknown source_type {grid.source_type!r}")
    vsrc = None
    if grid.source_type == "velocity_volume":
        if volume_source is None:
            raise ValueError("velocity_volume sources need volume_source")
        vsrc = (volume_source if isinstance(volume_source, VolumeSource)
                else VolumeSource.from_dense(volume_source, grid.shape,
                                             device))
    mats = np.asarray(materials, np.float64)
    coefs = sls_coefficients(mats, grid.frequency, grid.dt)
    has_shear = bool(np.any(mats[:, 2] > 0))

    rho0, c0 = mats[0, 0], mats[0, 1]
    oz_scale = 1.0 / (rho0 * c0)  # pressure -> particle velocity (plane wave)
    cmax = max(mats[:, 1].max(), mats[:, 2].max())
    profiles = _build_cpml_profiles_np(
        grid.shape, grid.npml, grid.dx, grid.dt, cmax, grid.reflection_limit
    )
    zeros2 = np.zeros(grid.shape[:2])
    plane = grid.source_type == "velocity_plane"  # the only plane drive
    src = (source_amp if plane and source_amp is not None else zeros2,
           source_phase if plane and source_phase is not None else zeros2)
    ns = grid.npml + 2
    idx, table = _build_indexed_materials(coefs, mat_idx, reflector_mask)
    make, state, step = ((make_visco_coeffs, ViscoState, visco_step)
                         if has_shear else
                         (make_fluid_coeffs, FluidState, fluid_step))
    co = make(idx, table, profiles, *src, grid, coefs["viscous"], device)
    return step, state.zeros(grid.shape, ns, device), co, oz_scale, vsrc


def run_fdtd_batch(
    mat_idx: np.ndarray,
    materials: np.ndarray,
    grid: FDTDGrid,
    source_amps: np.ndarray,
    source_phases: np.ndarray,
    mesh=None,
    reflector_mask=None,
    *,
    device="cuda",
):
    """Run B independent plane-source simulations on one card.

    Multipoint steering runs one case per steering point (the reference
    loops them, `CalculateFieldProcess.py:78-111`); the cases share the
    material map and grid and differ only in their CW source plane. One
    ``fdtd_setup`` serves them all: the cases run in turn with the same
    kernels, the state zeroed and the source plane swapped between them,
    so case b equals ``run_fdtd`` with plane b bit for bit.

    ``source_amps``, ``source_phases``: (B, N1, N2) per-case planes.
    ``mesh`` (the JAX package's case-axis device fan-out) is ROADMAP Queue A
    item 6. Returns the stacked (B, N1, N2, N3) 'p_amp', 'p_phase' and
    'peak' of ``run_fdtd``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_fdtd_batch(mesh=...): fanning cases out over several GPUs "
            "is ROADMAP Queue A item 6"
        )
    if grid.source_type != "velocity_plane":
        raise ValueError("run_fdtd_batch drives plane sources, not "
                         f"{grid.source_type!r}")
    amps = np.asarray(source_amps, np.float32)
    phases = np.asarray(source_phases, np.float32)
    if amps.ndim != 3 or amps.shape != phases.shape:
        raise ValueError("source_amps/source_phases must be (B, N1, N2)")
    with stage_timer("FDTD setup", level=3, step=2):
        step, st, co, oz_scale, _ = fdtd_setup(
            mat_idx, materials, grid, amps[0], phases[0], reflector_mask,
            device=device,
        )
    f32 = _to_device(device)
    outs = []
    for b in range(amps.shape[0]):
        if b:
            for v in vars(st).values():
                for t in (v if isinstance(v, list) else [v]):
                    t.zero_()
            for k, v in _plane(amps[b], phases[b], f32).items():
                setattr(co, k, v)
        _time_loop(step, st, co, grid, oz_scale, 0.0, None)
        # stacked now: on the CPU 'peak' is a view of the state, zeroed next
        outs.append(_carrier(st, grid))
        outs[-1]["peak"] = outs[-1]["peak"].copy()
    return {k: np.stack([o[k] for o in outs])
            for k in ("p_amp", "p_phase", "peak")}
