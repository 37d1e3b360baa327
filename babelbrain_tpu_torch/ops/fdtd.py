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
plain PyTorch. A run with a plane or point source and no diagnostics runs
fused sweeps instead, K steps a launch (``fuse_steps``): fluid media
``ops.fdtd_fused_kernels`` in the schedule of the JAX package's
``simulate_fluid_pallas``, shear media ``ops.fdtd_visco_fused_kernels`` in
that of ``simulate_visco_pallas``; a volumetric drive the halo sweeps
``ops.fdtd_halo_kernels`` (fluid) and ``ops.fdtd_visco_halo_kernels``
(shear). A fluid run whose diagnostics are only the Pressure_rms /
Pressure_peak maps and monitors can take its window in the fluid sweep's
extras instantiations (``extras_plan``, B4's ``with_p2`` and monitor
capture). Each equals the step-by-step run bit for bit.

Physics (see the JAX module for the derivations): 4th-order staggered
differences, CPML with slab-only psi memory, one SLS relaxation mechanism
per modulus tuned exactly at the carrier, a CW plane source with per-pixel
amplitude and phase, and the carrier DFT accumulated over the sensor window.

Diagnostics (``ops.fdtd_extras``): the 14 ``sel_maps`` RMS / peak maps (one
more kernel after the step), and the pressure series at ``monitor_ijk``
voxels every ``sensor_subsampling`` steps of the window and the raw
pressure capture of ``run_fdtd_capture``, both sampled by the step's own
pressure / stress kernel.

``run_fdtd_batch`` runs B plane-source cases from one setup per device.
The port compiles no executable per grid, so it keeps no counterpart of the
JAX package's executable memo.

Domain decomposition (``run_fdtd(mesh=)``, ``parallel.halo``): the grid is
cut into equal blocks of columns over the devices of a ``DeviceMesh`` on
axis "x", axis "y" or both (``make_mesh_2d``: ``Blocks``, shard s =
sx * ny + sy); each shard holds its own copy of the setup, its block and
ghost planes on each side that has a neighbour along each axis, and its
launches apply the x and y CPMLs only where it holds a global edge. An
x-mesh plane-source run without diagnostics goes
overlap-and-discard (``sharded_plan``, the JAX package's
``_simulate_fluid_pallas_sharded_fused`` and
``_simulate_visco_pallas_sharded_fused``): H = 3K (fluid) or JAX's 4K
(visco) ghost planes a side, one bundled refresh of each group of the state's
ghost planes (``Blocks.refresh_group``) and one fused K-step launch per
shard a sweep; what the array's edge contaminates stays inside the ghost
planes. Every other run, and every run on a mesh cut along y (the JAX
package's Pallas drivers decompose x only, so its 2-D runs go through its
XLA step), keeps 2 ghost planes and, after each half-step, copies those of
the fields the next half-step reads across x and across y from the
neighbours (``Blocks.refresh``, ``HALO_FIELDS``). Either way a sharded run
equals the unsharded one bit for bit. A mesh with other axes than x and y
runs replicated over them, as the JAX package does, except that only the
shards at index 0 of those axes compute (``parallel.halo.
decomposition_mesh``). A mesh over several processes (``make_mesh(...,
group=)``, ``parallel.distributed``) runs in each of them: every process
sets up the whole grid, steps its own shards, exchanges the ghost planes
that cross processes and returns the whole result (``own_planes``: the
owned blocks all-gathered). ``run_fdtd_batch(mesh=)`` spreads its cases
over a mesh's devices (``make_case_mesh``, or any mesh of one process).
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import distributed
from ..parallel.halo import (
    Blocks,
    XSlabs,
    check_mesh,
    decomposition_mesh,
    mesh_axis_sizes,
    mesh_devices,
)
from ..parallel.halo import make_mesh as _make_mesh
from ..utils.timing import stage_timer
from . import fdtd_kernels, fdtd_visco_kernels
from .fdtd_kernels import (
    _C1,
    _C2,
    FluidCoeffs,
    FluidState,
    fluid_pressure,
    fluid_pressure_ref,
    fluid_velocity,
    fluid_velocity_ref,
)
from .fdtd_visco_kernels import (
    ViscoCoeffs,
    ViscoState,
    visco_stress,
    visco_stress_ref,
    visco_velocity,
    visco_velocity_ref,
)
from .fdtd_extras import (
    SWEEP_MAPS,
    Diagnostics,
    Monitor,
    check_sel_maps,
    monitor_index,
)
from . import fdtd_fused_kernels, fdtd_visco_fused_kernels
from .fdtd_fused_kernels import FUSE_BEST, fluid_fused, fluid_fused_ref
from . import fdtd_halo_kernels
from .fdtd_halo_kernels import (
    HALO_K_CAP,
    VOLUME_FUSE_BEST,
    fluid_halo,
    fluid_halo_ref,
)
from .fdtd_visco_fused_kernels import (
    VISCO_FUSE_BEST,
    visco_fused,
    visco_fused_ref,
)
from . import fdtd_visco_halo_kernels
from .fdtd_visco_halo_kernels import (
    VISCO_HALO_K_CAP,
    VISCO_VOLUME_FUSE_BEST,
    visco_halo,
)
from .fdtd_sources import (
    VolumeSource,
    velocity_volume_source,
    velocity_volume_source_ref,
)

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
    weights, all evaluated in float64 (the kernels take them as float32);
    s_point = point_amp sin(wt) ramp is the stress-point value, float32 as
    the JAX package's step computes it (``point_value``).
    """
    omega = 2.0 * np.pi * grid.frequency
    wt = omega * (n * grid.dt)
    ramp_steps = grid.ramp_cycles / grid.frequency / grid.dt
    ramp = 0.5 * (1.0 - np.cos(np.pi * n / ramp_steps)) if n < ramp_steps else 1.0
    scale = ramp * oz_scale
    return (float(np.sin(wt) * scale), float(np.cos(wt) * scale),
            float(np.cos(wt)), float(np.sin(wt)),
            point_value(grid, n, point_amp))


@functools.cache
def _libm():
    """The C library's float32 ``sinf`` / ``cosf`` (ctypes)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


def point_value(grid: FDTDGrid, n: int, point_amp: float) -> float:
    """The stress-point drive of step ``n`` in float32, operation by
    operation as the JAX package's XLA step computes ``sval``
    (`babelbrain_tpu/ops/fdtd.py:521, :557-562, :855`) on the CPU: XLA
    folds the constants of ``omega * (n * dt)`` into ``n * (dt * omega)``
    and of ``pi * n / ramp_steps`` into ``n * (pi / ramp_steps)``, each
    constant product rounded to float32, and takes sin and cos from the C
    library's ``sinf`` / ``cosf``; the products run left to right. A float64
    drive cast to float32 misses it by an ulp of omega t (3.8e-6 rad at 40
    rad) on a fraction of the steps."""
    if not point_amp:
        return 0.0
    f = np.float32
    m = _libm()
    nf = f(n)
    s = f(m.sinf(nf * (f(grid.dt) * f(2.0 * np.pi * grid.frequency))))
    ramp_steps = f(grid.ramp_cycles / grid.frequency / grid.dt)
    ramp = f(1.0)
    if nf < ramp_steps:
        ramp = f(0.5) * (f(1.0) - f(m.cosf(nf * (f(np.pi) / ramp_steps))))
    return float(f(point_amp) * s * ramp)


def point_index(grid: FDTDGrid) -> int | None:
    """C-order linear index of a ``stress_point`` source cell, else None."""
    if grid.source_type != "stress_point":
        return None
    return int(np.ravel_multi_index(tuple(int(v) for v in grid.source_ijk),
                                    grid.shape))


def _velocity_half(velocity, st, co, scalars, vsrc,
                   scatter=velocity_volume_source, **kw):
    """The velocity kernel, then the volumetric source (if any); ``kw``
    goes to the kernel's wrapper."""
    s_sin, s_cos = scalars[:2]
    velocity(st, co, s_sin, s_cos, **kw)
    if vsrc is not None:
        scatter(st.vx, st.vy, st.vz, vsrc, s_sin, s_cos)


def _stress_half(stress, st, co, grid, n, scalars, pt, monitor, **kw):
    """The pressure / stress kernel of step ``n`` with the point source at
    linear cell ``pt`` (if not None), inside the sensor window the DFT, and
    at a sample step the monitor sample; ``kw`` goes to the wrapper."""
    cosw, sinw, s_pt = scalars[2:]
    point = None if pt is None else (pt, s_pt)
    if n >= grid.sensor_start:
        stress(st, co, cosw, sinw, point, monitor, **kw)
    else:
        # quiet phase: the DFT window is closed, accumulators untouched
        stress(st, co, point=point, monitor=monitor, **kw)


def _advance(velocity, stress, st, co, grid, n, oz_scale, point_amp, vsrc,
             monitor):
    """One leapfrog step: velocity kernel, volumetric source (if any), then
    the pressure / stress kernel with the point source (if any), inside the
    sensor window the DFT, and at a sample step the monitor sample."""
    scalars = step_scalars(grid, n, oz_scale, point_amp)
    _velocity_half(velocity, st, co, scalars, vsrc)
    _stress_half(stress, st, co, grid, n, scalars, point_index(grid),
                 monitor)


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


# ---------------------------------------------------------------------------
# fused sweeps (fluid)
# ---------------------------------------------------------------------------


def phase_schedule(n0: int, n1: int, k: int, fused2: bool = True,
                   k_min: int = 3):
    """Steps [n0, n1) split as the JAX package's ``run_phase``
    (`babelbrain_tpu/ops/fdtd_pallas.py:2874`, fluid; `:6443`, visco):
    (sweeps, tail), the sweeps a list of (first step, K): K-step sweeps
    while K >= ``k_min`` (3 fluid, 2 visco) fits, then 2-step sweeps (with
    ``fused2``), then the tail, the steps left to the pair."""
    sweeps, rem = [], n0
    if k >= k_min and (n1 - n0) // k > 0:
        m = (n1 - n0) // k
        sweeps += [(n0 + k * j, k) for j in range(m)]
        rem = n0 + k * m
    pairs = (n1 - rem) // 2 if fused2 else 0
    sweeps += [(rem + 2 * j, 2) for j in range(pairs)]
    return sweeps, list(range(rem + 2 * pairs, n1))


@dataclass(frozen=True)
class FusedPlan:
    """The depths of a fused run: K in the quiet phase and in the sensor
    window (``k``, ``k_dft``), whether 2-step sweeps run (``fused2``), and
    the least K of a K-step sweep (``k_min``: 3 fluid, 2 visco)."""

    k: int
    k_dft: int
    fused2: bool
    k_min: int = 3


def _pinned(fuse_steps, quiet: int, window: int, k_cap: int, k_min: int,
            shape, device) -> int:
    """A pinned ``fuse_steps``, refused outside 0..``k_cap`` and where the
    card cannot hold a K-step sweep of that depth."""
    k = int(fuse_steps)
    if not 0 <= k <= k_cap:
        raise ValueError(f"fuse_steps={k} outside 0..{k_cap}")
    if k >= k_min and k > min(quiet, window):
        raise ValueError(
            f"fuse_steps={k}: {device} holds {min(quiet, window)} stages of "
            f"the fused kernel at once on {tuple(shape)}")
    return k


def fused_plan(shape, device, viscous: bool, point: bool,
               fuse_steps: int | None = None) -> FusedPlan:
    """The depth rule of ``simulate_fluid_pallas``: ``None`` takes in each
    phase the deepest K the kernel admits on ``shape`` (``admitted_depth``,
    at most ``FUSE_BEST``); an int pins K in both and is refused when the
    card cannot hold K >= 3 steps a launch. 2-step sweeps run where both
    phases admit them, and with ``None`` only while ``FUSE_BEST`` >= 2
    (0: the pair for every step, the card's measurement)."""
    fk = fdtd_fused_kernels
    quiet = fk.admitted_depth(shape, device, viscous, False, point)
    window = fk.admitted_depth(shape, device, viscous, True, point)
    if fuse_steps is None:
        return FusedPlan(min(quiet, FUSE_BEST), min(window, FUSE_BEST),
                         FUSE_BEST >= 2 and min(quiet, window) >= 2)
    k = _pinned(fuse_steps, quiet, window, fk.K_CAP, 3, shape, device)
    return FusedPlan(k, k, min(quiet, window) >= 2)


def visco_plan(shape, device, viscous: bool, point: bool,
               fuse_steps: int | None = None) -> FusedPlan:
    """The depth rule of ``simulate_visco_pallas`` (unsharded,
    `babelbrain_tpu/ops/fdtd_pallas.py:6393-6441`): ``None`` takes in each
    phase the deepest K ``visco_fused`` admits on ``shape`` (at most
    ``VISCO_FUSE_BEST``); an int pins K in both and is refused when the
    card cannot hold K >= 2 steps a launch (JAX refuses an x-extent too
    short for its VMEM blocks, which has no counterpart here). K-step
    sweeps run from K = 2, 2-step sweeps after them only for a plane
    source, and with ``None`` only while ``VISCO_FUSE_BEST`` >= 2 (0: the
    pair for every step, the card's measurement)."""
    vk = fdtd_visco_fused_kernels
    quiet = vk.admitted_depth(shape, device, viscous, False, point)
    window = vk.admitted_depth(shape, device, viscous, True, point)
    fused2 = not point and min(quiet, window) >= 2
    if fuse_steps is None:
        return FusedPlan(min(quiet, VISCO_FUSE_BEST),
                         min(window, VISCO_FUSE_BEST),
                         fused2 and VISCO_FUSE_BEST >= 2, 2)
    k = _pinned(fuse_steps, quiet, window, vk.K_CAP, 2, shape, device)
    return FusedPlan(k, k, fused2, 2)


def volume_plan(fuse_steps: int | None = None) -> FusedPlan:
    """The depth rule of a fluid run with a volumetric drive (the halo
    sweep, ``fluid_halo``): K-step sweeps, then a one-step tail on pair +
    scatter, as JAX's volumetric ``run_phase``
    (`babelbrain_tpu/ops/fdtd_pallas.py:2877-2931`: no 2-step sweeps).
    JAX sweeps from K = 3; here from K = 2 (ROADMAP Queue C, "Fused
    schedule"). ``None`` takes ``VOLUME_FUSE_BEST``, the depth the card
    measured fastest at the dome's shape (0: pair + scatter for every
    step); an int pins K (0 and 1: the pair), refused beyond
    ``HALO_K_CAP``. No co-residency bounds the halo sweep's depth."""
    k = VOLUME_FUSE_BEST if fuse_steps is None else int(fuse_steps)
    if not 0 <= k <= HALO_K_CAP:
        raise ValueError(f"fuse_steps={k} outside 0..{HALO_K_CAP} for a "
                         "volumetric source")
    return FusedPlan(k, k, False, 2)


def visco_volume_plan(grid: FDTDGrid,
                      fuse_steps: int | None = None) -> FusedPlan:
    """The depth rule of a shear-media run with a volumetric drive (the
    halo sweep, ``visco_halo``): K-step sweeps from K = 2, no 2-step sweeps,
    then a one-step tail on pair + scatter, exactly JAX's visco
    ``run_phase`` with a volumetric source
    (`babelbrain_tpu/ops/fdtd_pallas.py:6441-6479`). ``None`` takes
    ``VISCO_VOLUME_FUSE_BEST``, the depth the card measured fastest at the
    dome's shape (0: pair + scatter for every step); an int pins K (0 and
    1: the pair, as JAX), refused beyond ``VISCO_HALO_K_CAP`` and, for
    K >= 2, where JAX refuses it: an x-extent with N1 / 2 < ceil(ns / 2) +
    2K - 1 (`:6432-6438`, its VMEM blocks of nb = 2 planes)."""
    k = VISCO_VOLUME_FUSE_BEST if fuse_steps is None else int(fuse_steps)
    if not 0 <= k <= VISCO_HALO_K_CAP:
        raise ValueError(f"fuse_steps={k} outside 0..{VISCO_HALO_K_CAP} for "
                         "a volumetric source in shear media")
    kx = -(-(grid.npml + 2) // 2)
    if k >= 2 and grid.shape[0] // 2 < kx + 2 * k - 1:
        raise ValueError(f"fuse_steps={k} needs an unsharded x-extent with "
                         f"N1/nb >= {kx + 2 * k - 1}")
    return FusedPlan(k, k, False, 2)


def extras_eligible(st, grid: FDTDGrid, sel_maps, monitor_ijk,
                    vsrc) -> bool:
    """Whether an unsharded run's diagnostics can ride on the fluid sweep,
    JAX's rule for B4's ``with_p2`` path: a fluid medium, a plane or point
    source, maps only among ``SWEEP_MAPS``, and maps or monitors asked."""
    return (isinstance(st, FluidState) and vsrc is None
            and grid.source_type in ("velocity_plane", "stress_point")
            and set(sel_maps) <= SWEEP_MAPS
            and (bool(sel_maps) or monitor_ijk is not None))


def extras_plan(shape, device, viscous: bool, point: bool,
                fuse_steps: int | None = None) -> FusedPlan | None:
    """The depth rule of an ``extras_eligible`` run: the quiet phase as
    ``fused_plan`` gives it without diagnostics; the window in extras sweeps
    of ``k_dft`` steps (then 2-step extras sweeps, then a tail on the pair
    with the maps' pass and its MONITOR sample). ``None`` takes the deepest
    K the extras instantiation admits, capped at ``EXTRAS_FUSE_BEST``; an
    int pins K in both phases, refused as ``fused_plan`` refuses it and
    where the card cannot hold the extras sweep. Returns None where the
    window depth is below 2: the run keeps the pair for every step. Unlike
    JAX (`babelbrain_tpu/ops/fdtd_pallas.py:2857-2875`), K need not divide
    the window: each sweep samples every selected step (ROADMAP Queue C,
    "Fused schedule")."""
    fk = fdtd_fused_kernels
    if fuse_steps is None and fk.EXTRAS_FUSE_BEST < 2:
        return None
    base = fused_plan(shape, device, viscous, point, fuse_steps)
    window = fk.admitted_depth(shape, device, viscous, True, point,
                               extras=True)
    if fuse_steps is None:
        k = min(window, fk.EXTRAS_FUSE_BEST)
    else:
        k = base.k_dft
        if k >= 2 and k > window:
            raise ValueError(
                f"fuse_steps={k}: {device} holds {window} stages of the "
                f"fused kernel's extras sweep at once on {tuple(shape)}")
    if k < 2:
        return None
    return FusedPlan(base.k, k, base.fused2)


def fused_schedule(grid: FDTDGrid, plan: FusedPlan):
    """[(first step, K, with_dft)] of a fused run: the quiet phase
    [0, sensor_start), then the window, each split by ``phase_schedule``
    (K = 1: a step of the pair); K-step sweeps only where the phase's K
    reaches ``plan.k_min``, as JAX's ``use_fusedK`` (whose two phases share
    one K; an extras run's window may sweep after a quiet phase on the
    pair)."""
    n_quiet = max(0, min(grid.sensor_start, grid.n_steps))
    out = []
    for n0, n1, dft in ((0, n_quiet, False), (n_quiet, grid.n_steps, True)):
        k = plan.k_dft if dft else plan.k
        k = k if k >= plan.k_min else 0
        sweeps, tail = phase_schedule(n0, n1, k, plan.fused2, plan.k_min)
        out += [(n, m, dft) for n, m in sweeps] + [(n, 1, dft) for n in tail]
    return out


# each family's fused sweep: (the wrapper, its plain version, the step of
# the pair its tails run, the depth rule, the halo sweep of a volumetric
# drive)
FUSED = {
    FluidState: (fluid_fused, fluid_fused_ref, fluid_step, fused_plan,
                 fluid_halo),
    ViscoState: (visco_fused, visco_fused_ref, visco_step, visco_plan,
                 visco_halo),
}


def plan_run(st, shape, device, viscous: bool, point: bool,
             fuse_steps: int | None = None) -> FusedPlan:
    """The depth rule of ``st``'s family (``fused_plan``, ``visco_plan``)."""
    return FUSED[type(st)][3](shape, device, viscous, point, fuse_steps)


def _fused_loop(runs, grid: FDTDGrid, oz_scale, point_amp, plan: FusedPlan,
                vsrc: VolumeSource | None = None,
                diag: Diagnostics | None = None):
    """The runs ``runs`` ((state, coefficients) pairs of one family) in
    lockstep through ``fused_schedule``: each sweep one fused launch a run
    (``fluid_fused`` or ``visco_fused``; with a volumetric drive ``vsrc``
    the family's halo sweep, ``fluid_halo`` or ``visco_halo``), each tail
    step the pair (and the scatter). ``diag`` (one fluid run,
    ``extras_plan``): the window's sweeps feed its maps and samples (the
    extras sweep), its tail steps take their MONITOR sample and the maps'
    pass."""
    pt = point_index(grid)
    fused, _, step, _, halo = FUSED[type(runs[0][0])]
    if vsrc is not None:
        def fused(st, co, rows, _pt, with_dft):
            halo(st, co, rows, vsrc, with_dft=with_dft)
    if diag is not None and (len(runs) != 1 or vsrc is not None):
        raise ValueError("diagnostics ride on one fluid run's sweeps")
    with stage_timer("FDTD time loop", level=3, step=2):
        for n, k, dft in fused_schedule(grid, plan):
            if k == 1:
                for st, co in runs:
                    if diag is None:
                        step(st, co, grid, n, oz_scale, point_amp, vsrc)
                        continue
                    step(st, co, grid, n, oz_scale, point_amp, vsrc,
                         diag.monitor(n))
                    diag.record(st, n)
                continue
            rows = [step_scalars(grid, m, oz_scale, point_amp)
                    for m in range(n, n + k)]
            for st, co in runs:
                if diag is not None and dft:
                    fused(st, co, rows, pt, with_dft=True,
                          extras=diag.extras,
                          monitor=diag.sweep_monitor(n, k))
                else:
                    fused(st, co, rows, pt, with_dft=dft)
        _synchronize([st.peak for st, _ in runs])
    fdtd_halo_kernels.release()
    fdtd_visco_halo_kernels.release()


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
    fuse_steps: int | None = None,
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

    ``fuse_steps``: the JAX argument. A run with a plane or point source
    and no ``sel_maps`` or ``monitor_ijk`` runs fused sweeps, K steps a
    launch, in the schedule of the JAX driver of its medium, in the quiet
    phase and in the window: fluid media ``fluid_fused`` as
    ``simulate_fluid_pallas`` (K-step sweeps while K >= 3, then 2-step
    sweeps), shear media ``visco_fused`` as ``simulate_visco_pallas``
    (K-step sweeps while K >= 2, then, for a plane source, 2-step sweeps);
    then a one-step tail on the pair. ``None`` takes the deepest K the
    kernel admits on this grid and device (``fused_plan``, ``visco_plan``);
    an int pins K (refused when the card cannot hold it). A run with a
    volumetric source and no diagnostics runs the halo sweep of its medium
    in independent halo-recomputing blocks (K-step sweeps from K = 2, then
    pair + scatter): fluid media ``fluid_halo`` in ``volume_plan``'s
    schedule (``None``: ``VOLUME_FUSE_BEST``), shear media ``visco_halo``
    in ``visco_volume_plan``'s, JAX's visco ``run_phase`` (``None``:
    ``VISCO_VOLUME_FUSE_BEST``; an int is refused where JAX refuses it).
    A fluid run with a plane or point source whose ``sel_maps`` are among
    ``Pressure_rms`` / ``Pressure_peak`` and / or with ``monitor_ijk``
    (JAX's rule for B4's ``with_p2`` path, ``extras_eligible``) runs its
    quiet phase as without diagnostics and its window in the fused sweep's
    extras instantiations, p^2 and the samples taken inside the sweep
    (``extras_plan``: ``None`` caps the window's K at ``EXTRAS_FUSE_BEST``,
    whose 0 keeps the pair for every step; an int pins K). Every other run
    with ``sel_maps`` or ``monitor_ijk`` keeps the pair for every step, with
    its per-step monitor samples. Fused or not, the result is the
    step-by-step run's bit for bit.

    ``mesh``: a ``DeviceMesh`` on axis "x" (``parallel.halo.make_mesh``),
    on axis "y" (``make_mesh(n, "y")``) or on both (``make_mesh_2d(nx,
    ny)``) decomposes the grid along those axes over its devices
    (``device`` is then not used): N1 and N2 must divide by the mesh's
    shard counts into shards of at least npml + 2 planes, as in the JAX
    package. On an x mesh a plane-source run without diagnostics, and a
    fluid run with a volumetric source, run overlap-and-discard fused
    sweeps where ``sharded_plan`` finds a K >= 2 (``fuse_steps`` as above;
    the volumetric ones through ``fluid_halo``, by default only where
    ``VOLUME_FUSE_BEST`` >= 2); every other run (a volumetric source in
    shear media too: JAX sends it to XLA; and every run on a mesh cut along
    y, whatever ``fuse_steps`` says, as JAX keeps its XLA step) the pair
    with 2 ghost planes. A mesh with other axes too is cut along its x and
    y axes at index 0 of the others. A mesh over several processes runs
    in each of them, each stepping its own shards and returning the whole
    result. The result equals the unsharded run's bit for bit.

    ``sel_maps``: extra maps named ``<Field>_rms`` / ``<Field>_peak``, Field
    in Pressure, Vx, Vy, Vz, Sigmaxx, Sigmayy, Sigmazz, accumulated over
    the sensor window; in fluid media ``Pressure_peak`` (and the Sigma
    peaks) is the carrier 'peak' itself, as on JAX's B4 path.
    ``monitor_ijk``: (n, 3) voxels whose pressure is kept
    at steps ``sensor_start, sensor_start + sensor_subsampling, ...``, on
    the pair or inside the extras sweeps alike. The JAX Pallas path samples
    once a sweep instead; the values here are those of its XLA path.

    Returns dict with 'p_amp' (Pa), 'p_phase' (rad, FFT-bin convention of
    the reference), 'peak' (Pa), each (N1,N2,N3) float32 numpy arrays; plus
    one entry per ``sel_maps`` name, and 'sensor_series' (K, nT) float32 +
    'sensor_times' (nT,) float32 when ``monitor_ijk`` is given.
    """
    sel_maps = check_sel_maps(sel_maps)
    if int(sensor_subsampling) < 1:
        raise ValueError(f"sensor_subsampling={sensor_subsampling} < 1")
    if mesh is not None:
        return _run_fdtd_sharded(
            mesh, mat_idx, materials, grid, source_amp, source_phase,
            point_amp, reflector_mask, volume_source, sel_maps, monitor_ijk,
            int(sensor_subsampling), fuse_steps,
        )
    with stage_timer("FDTD setup", level=3, step=2):
        step, st, co, oz_scale, vsrc = fdtd_setup(
            mat_idx, materials, grid, source_amp, source_phase,
            reflector_mask, volume_source, device=device,
        )
    sel = np.arange(grid.sensor_start, grid.n_steps, int(sensor_subsampling))
    diag = plan = None
    if sel_maps or monitor_ijk is not None:
        if extras_eligible(st, grid, sel_maps, monitor_ijk, vsrc):
            plan = extras_plan(grid.shape, device, co.viscous,
                               point_index(grid) is not None, fuse_steps)
        with_series = monitor_ijk is not None
        diag = Diagnostics.create(
            st, grid.sensor_start, sel_maps,
            sample_steps=sel if with_series else (),
            index=(monitor_index(monitor_ijk, grid.shape, device)
                   if with_series else None),
            sweep=plan is not None,
        )
    if vsrc is None and diag is None:
        plan = plan_run(st, grid.shape, device, co.viscous,
                        point_index(grid) is not None, fuse_steps)
        _fused_loop([(st, co)], grid, oz_scale, point_amp, plan)
    elif diag is None:
        plan = (volume_plan(fuse_steps) if isinstance(st, FluidState)
                else visco_volume_plan(grid, fuse_steps))
        _fused_loop([(st, co)], grid, oz_scale, point_amp, plan, vsrc)
    elif plan is not None:
        _fused_loop([(st, co)], grid, oz_scale, point_amp, plan, diag=diag)
    else:
        _time_loop([(step, st, co, vsrc, diag)], grid, oz_scale, point_amp)

    result = _carrier(st, grid)
    if diag is not None and diag.extras is not None:
        result.update(diag.extras.read(grid.n_steps - grid.sensor_start))
    if monitor_ijk is not None:
        k = int(diag.index.shape[0])
        series = (diag.series.cpu().numpy() if diag.series is not None
                  else np.zeros((0, k), np.float32))
        result.update(_series(series, sel, grid))
    return result


def _series(series, sel, grid: FDTDGrid) -> dict:
    """'sensor_series' (K, nT) and 'sensor_times' (nT,) of a monitor run
    from its (nT, K) samples at steps ``sel``."""
    return {"sensor_series": series.T.astype(np.float32),
            "sensor_times": (sel * grid.dt).astype(np.float32)}


def _synchronize(tensors) -> None:
    """Wait for the CUDA devices of ``tensors`` (the readback would wait
    anyway: this keeps the loop's span honest)."""
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _time_loop(runs, grid, oz_scale, point_amp=0.0):
    """Steps 0..n_steps-1 of each run of ``runs`` (step function, state,
    coefficients, volume source or None, ``Diagnostics`` or None), in
    lockstep: each step takes its monitor sample and is followed by the
    maps' pass (with a ``Diagnostics``)."""
    with stage_timer("FDTD time loop", level=3, step=2):
        for n in range(grid.n_steps):
            for step, st, co, vsrc, diag in runs:
                if diag is None:
                    step(st, co, grid, n, oz_scale, point_amp, vsrc)
                    continue
                step(st, co, grid, n, oz_scale, point_amp, vsrc,
                     diag.monitor(n))
                diag.record(st, n)
        _synchronize([run[1].peak for run in runs])


def _carrier(st, grid: FDTDGrid) -> dict:
    """'p_amp', 'p_phase' and 'peak' from the DFT accumulators."""
    return _carrier_of(st.acc_cos.cpu().numpy(), st.acc_sin.cpu().numpy(),
                       st.peak.cpu().numpy(), grid)


def _carrier_of(acc_c, acc_s, peak, grid: FDTDGrid) -> dict:
    """'p_amp', 'p_phase' and 'peak' from the DFT sums (numpy)."""
    n_win = grid.n_steps - grid.sensor_start
    # FFT-bin convention: X = sum p e^{-i w t} = C - iS; amp=2|X|/N
    amp = 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2)
    phase = np.arctan2(-acc_s, acc_c)
    return {
        "p_amp": amp.astype(np.float32),
        "p_phase": phase.astype(np.float32),
        "peak": peak,
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
    _time_loop([(step, st, co, vsrc, diag)], grid, oz_scale, point_amp)

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


@dataclass
class _HostSetup:
    """What ``fdtd_setup`` computes on the host: the indexed materials, the
    CPML profiles, the source plane (amplitude, phase), the medium's flags
    and the pressure->velocity scale."""

    idx: np.ndarray
    table: np.ndarray
    profiles: list
    src: tuple
    viscous: bool
    has_shear: bool
    oz_scale: float

    def family(self):
        """(coefficients factory, state class, step function)."""
        return ((make_visco_coeffs, ViscoState, visco_step) if self.has_shear
                else (make_fluid_coeffs, FluidState, fluid_step))


def _host_setup(mat_idx, materials, grid: FDTDGrid, source_amp=None,
                source_phase=None, reflector_mask=None) -> _HostSetup:
    if grid.source_type not in SOURCE_TYPES:
        raise ValueError(f"unknown source_type {grid.source_type!r}")
    mats = np.asarray(materials, np.float64)
    coefs = sls_coefficients(mats, grid.frequency, grid.dt)
    rho0, c0 = mats[0, 0], mats[0, 1]
    cmax = max(mats[:, 1].max(), mats[:, 2].max())
    profiles = _build_cpml_profiles_np(
        grid.shape, grid.npml, grid.dx, grid.dt, cmax, grid.reflection_limit
    )
    zeros2 = np.zeros(grid.shape[:2])
    plane = grid.source_type == "velocity_plane"  # the only plane drive
    src = (source_amp if plane and source_amp is not None else zeros2,
           source_phase if plane and source_phase is not None else zeros2)
    idx, table = _build_indexed_materials(coefs, mat_idx, reflector_mask)
    return _HostSetup(idx=idx, table=table, profiles=profiles, src=src,
                      viscous=coefs["viscous"],
                      has_shear=bool(np.any(mats[:, 2] > 0)),
                      # pressure -> particle velocity (plane wave)
                      oz_scale=1.0 / (rho0 * c0))


def _volume_source(grid: FDTDGrid, volume_source, device):
    """The ``VolumeSource`` of a ``velocity_volume`` run on ``device`` (a
    given one as it is, JAX's dense dict turned into one), else None."""
    if grid.source_type != "velocity_volume":
        return None
    if volume_source is None:
        raise ValueError("velocity_volume sources need volume_source")
    return (volume_source if isinstance(volume_source, VolumeSource)
            else VolumeSource.from_dense(volume_source, grid.shape, device))


def fdtd_setup(mat_idx, materials, grid: FDTDGrid, source_amp=None,
               source_phase=None, reflector_mask=None,
               volume_source: VolumeSource | dict | None = None, *,
               device="cuda"):
    """What ``run_fdtd`` steps with, for the same arguments: (step function,
    zero state, step-invariant inputs, pressure->velocity scale, sparse
    volume source or None)."""
    h = _host_setup(mat_idx, materials, grid, source_amp, source_phase,
                    reflector_mask)
    vsrc = _volume_source(grid, volume_source, device)
    make, state, step = h.family()
    co = make(h.idx, h.table, h.profiles, *h.src, grid, h.viscous, device)
    return (step, state.zeros(grid.shape, grid.npml + 2, device), co,
            h.oz_scale, vsrc)


# ---------------------------------------------------------------------------
# (x, y) decomposition over a device mesh
# ---------------------------------------------------------------------------

# the fields each half-step's successor differences across x and across y:
# their ghost planes along that axis are refreshed after (velocity half,
# pressure / stress half). Fluid: vx = D+x p, vy = D+y p, vz = D+z p, then
# theta = D-x vx + D-y vy + D-z vz. Visco (ops.fdtd_visco_kernels
# VELOCITY_DERIVS, STRESS_DERIVS): the velocities read sxx, sxy, sxz along
# x and sxy, syy, syz along y; the stresses read vx, vy, vz along both.
HALO_FIELDS = {
    FluidState: {0: (("vx",), ("p",)), 1: (("vy",), ("p",))},
    ViscoState: {0: (("vx", "vy", "vz"), ("sxx", "sxy", "sxz")),
                 1: (("vx", "vy", "vz"), ("sxy", "syy", "syz"))},
}
# (velocity, pressure / stress) of each family: the kernels' wrappers and
# their plain versions; the wrappers' one-time check
_STEPS = {
    FluidState: ((fluid_velocity, fluid_pressure),
                 (fluid_velocity_ref, fluid_pressure_ref)),
    ViscoState: ((visco_velocity, visco_stress),
                 (visco_velocity_ref, visco_stress_ref)),
}
_CHECK = {FluidState: fdtd_kernels.check_step,
          ViscoState: fdtd_visco_kernels.check_step}


@dataclass
class Shard:
    """One shard of a decomposed run: its device, state, coefficients,
    volume source, point-source cell (local linear index) and
    ``Diagnostics``, and the global slots of its monitor voxels."""

    device: torch.device
    st: object
    co: object
    vsrc: VolumeSource | None = None
    point: int | None = None
    diag: Diagnostics | None = None
    slots: np.ndarray | None = None


def _decomposition(mesh, grid: FDTDGrid, halo: int = 2):
    """(``Blocks``, the device of each shard) of ``grid`` over ``mesh``
    with ``halo`` ghost planes: cut along the mesh's "x" and "y" axes (the
    shards in (x, y) C order), replicated over any other axis, of which
    index 0 computes (``parallel.halo.decomposition_mesh``); across
    processes the shards' processes. The JAX package's refusals
    (`babelbrain_tpu/ops/fdtd.py:1477-1485`)."""
    check_mesh(mesh, "run_fdtd")
    nx, ny = mesh_axis_sizes(mesh)
    if grid.shape[0] % nx or grid.shape[1] % ny:
        raise ValueError(
            f"grid {grid.shape[:2]} not divisible by mesh ({nx}, {ny})"
        )
    if grid.shape[0] // nx < grid.npml + 2 or grid.shape[1] // ny < grid.npml + 2:
        raise ValueError("shard too thin for the PML slab; reduce mesh size")
    sub = decomposition_mesh(mesh)
    across = ((sub.ranks, mesh.group, mesh.rank) if mesh.spans_processes
              else ())
    return (Blocks(XSlabs(grid.shape[0], nx, halo),
                   XSlabs(grid.shape[1], ny, halo, axis=1), *across),
            sub.devices)


def _blocks(mesh, grid: FDTDGrid, halo: int = 2) -> Blocks:
    """The ``Blocks`` of ``_decomposition``."""
    return _decomposition(mesh, grid, halo)[0]


def _split_source(vs: VolumeSource, dd: Blocks, s: int, n2: int, n3: int,
                  device):
    """The source voxels of shard s's block, its ghost planes included,
    re-indexed to its local cells, on ``device`` (the values copied, not
    recomputed). The overlap-and-discard sweeps drive the ghost planes as
    their owner drives them, zero beyond the global edges (JAX extends its
    sharded drive so, `babelbrain_tpu/ops/fdtd_pallas.py:2677-2690`); in
    the pair's steps a driven ghost plane is refreshed from its owner or
    never read."""
    (a, b), (m1, m2) = dd.start(s), dd.planes(s)
    v = vs.index.long()
    i, j, z = v // (n2 * n3), v // n3 % n2, v % n3
    sel = torch.nonzero((i >= a) & (i < a + m1) & (j >= b)
                        & (j < b + m2)).reshape(-1)
    index = (((i - a) * m2 + (j - b)) * n3 + z).index_select(0, sel)
    return VolumeSource(index=index.to(torch.int32).to(device), **{
        k: getattr(vs, k).index_select(0, sel).to(device)
        for k in ("amp", "cph", "sph", "ox", "oy", "oz")})


def shard_setup(mesh, mat_idx, materials, grid: FDTDGrid, source_amp=None,
                source_phase=None, reflector_mask=None, volume_source=None,
                sel_maps=(), monitor_ijk=None, sample_steps=(), halo=2):
    """What ``run_fdtd(mesh=)`` steps with: (``Blocks``, the ``Shard`` of
    each shard, None for one of another process, the pressure->velocity
    scale). Every process runs the host setup on the full arrays (as each
    JAX process supplies them) and builds its own shards only. Each shard
    holds its copy of the setup, a zero state of its block and ``halo``
    ghost planes a side along each cut axis, its part of the sources (the
    point source only on its owner) and, with ``sel_maps`` or
    ``monitor_ijk``, its ``Diagnostics`` (monitor samples at
    ``sample_steps``) over the voxels it owns."""
    dd, devices = _decomposition(mesh, grid, halo)
    h = _host_setup(mat_idx, materials, grid, source_amp, source_phase,
                    reflector_mask)
    local = [s for s in range(dd.n_shards) if dd.is_local(s)]
    vsrc = _volume_source(grid, volume_source,
                          devices[local[0]] if local else "cpu")
    make, state, _ = h.family()
    n2, n3 = grid.shape[1:]
    mon = (None if monitor_ijk is None
           else np.asarray(monitor_ijk, np.int64).reshape(-1, 3))
    if mon is not None:
        monitor_index(mon, grid.shape, "cpu")  # refuses voxels off the grid
    shards = [None] * dd.n_shards
    for s in local:
        dev = devices[s]
        (a, b), (m1, m2) = dd.start(s), dd.planes(s)
        box = (slice(a, a + m1), slice(b, b + m2))
        shape = (m1, m2, n3)
        co = make(h.idx[box], h.table, h.profiles,
                  *(np.asarray(v)[box] for v in h.src), grid, h.viscous, dev)
        co.x_lo, co.x_hi, co.y_lo, co.y_hi = dd.edges(s)
        sh = Shard(dev, state.zeros(shape, grid.npml + 2, dev), co)
        _CHECK[state](sh.st, sh.co)  # once: the loop passes checked=True
        if vsrc is not None:
            sh.vsrc = _split_source(vsrc, dd, s, n2, n3, dev)
        if (grid.source_type == "stress_point"
                and dd.owner(*(int(v) for v in grid.source_ijk[:2])) == s):
            i, j, k = (int(v) for v in grid.source_ijk)
            sh.point = ((i - a) * m2 + j - b) * n3 + k
        if sel_maps or mon is not None:
            index = None
            if mon is not None:
                sh.slots = np.flatnonzero(
                    [dd.owner(i, j) == s for i, j in mon[:, :2]])
                local = mon[sh.slots] - np.array([a, b, 0])
                index = monitor_index(local, shape, dev)
            sh.diag = Diagnostics.create(
                sh.st, grid.sensor_start, sel_maps,
                sample_steps=sample_steps if mon is not None else (),
                index=index)
        shards[s] = sh
    return dd, shards, h.oz_scale


def _shard_range(sh: Shard, s: int):
    """An NVTX range naming shard s around its launches (CUDA only)."""
    if sh.device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.nvtx.range(f"shard {s}")


def _local(shards) -> list:
    """(s, shard) of the shards of this process (``shard_setup`` puts None
    for another process's)."""
    return [(s, sh) for s, sh in enumerate(shards) if sh is not None]


def _refresh(shards, dd: Blocks, half: int) -> None:
    """The ghost planes of half-step ``half``'s fields (``HALO_FIELDS`` of
    the state) along each cut axis; each field's place in that list tags
    its messages across processes."""
    state = type(_local(shards)[0][1].st)
    for axis, names in HALO_FIELDS[state].items():
        for j, k in enumerate(names[half]):
            dd.refresh([None if sh is None else getattr(sh.st, k)
                        for sh in shards], axis, tag=4 * half + j)


def step_shards(shards, dd: Blocks, grid: FDTDGrid, n: int, oz_scale: float,
                point_amp: float = 0.0, plain: bool = False) -> None:
    """Step ``n`` of ``_advance`` over the shards: every shard's velocity
    half-step and volumetric scatter, the velocity ghost planes, every
    shard's pressure / stress half-step (its point source and monitor
    sample, then its maps), the pressure / stress ghost planes; each
    refresh along x, then along y. ``plain`` runs the plain versions (to
    check the kernels against). The shards' states and coefficients were
    validated by ``shard_setup``: the wrappers skip their per-call
    checks. Across processes each steps its own shards (none: nothing to
    do, no slab of it crosses)."""
    mine = _local(shards)
    if not mine:
        return
    velocity, stress = _STEPS[type(mine[0][1].st)][plain]
    scatter = velocity_volume_source_ref if plain else velocity_volume_source
    kw = {} if plain else {"checked": True}
    scalars = step_scalars(grid, n, oz_scale, point_amp)
    for s, sh in mine:
        with _shard_range(sh, s):
            _velocity_half(velocity, sh.st, sh.co, scalars, sh.vsrc, scatter,
                           **kw)
    _refresh(shards, dd, 0)
    for s, sh in mine:
        with _shard_range(sh, s):
            mon = sh.diag.monitor(n) if sh.diag is not None else None
            _stress_half(stress, sh.st, sh.co, grid, n, scalars, sh.point,
                         mon, **kw)
            if sh.diag is not None:
                sh.diag.record(sh.st, n, plain=plain)
    _refresh(shards, dd, 1)


def sharded_plan(width: int, grid: FDTDGrid, device, viscous: bool,
                 fuse_steps: int | None = None, visco: bool = False,
                 volume: bool = False):
    """(K, H) of the overlap-and-discard sweeps on shards of ``width`` own
    planes, the counterpart of the JAX package's ``_sharded_fusedK_plan``
    (`babelbrain_tpu/ops/fdtd_pallas.py:2544`; ``visco``: with ``K_cap=4``,
    as ``simulate_visco_pallas`` calls it), or None when no K >= 2 fits.
    H = ``CONTAMINATION`` x K ghost planes a side: each step widens what
    the array's edge contaminates by 3 planes, in either medium (JAX counts
    4); the fluid takes 3K, the visco JAX's 4K.
    H must also satisfy H <= width - (npml + 2), JAX's guard: ghost planes
    that reached into an edge neighbour's x-PML slab would evolve without
    the CPML there. ``fuse_steps`` pins K (None or 0: the deepest K from
    the family's cap (``K_CAP`` and ``FUSE_BEST`` / ``VISCO_FUSE_BEST``)
    down that the card holds on the extended slab). ``volume``: the halo
    sweep of a volumetric drive (``fluid_halo``, JAX's sharded volume
    branch), which no co-residency bounds: None or 0 takes
    ``VOLUME_FUSE_BEST`` (at most ``HALO_K_CAP``) down, none while it is
    below 2 (the pair, as unsharded)."""
    fk = fdtd_visco_fused_kernels if visco else fdtd_fused_kernels
    best = VISCO_FUSE_BEST if visco else FUSE_BEST
    cap = fk.K_CAP
    if volume:
        fk, best, cap = fdtd_halo_kernels, VOLUME_FUSE_BEST, HALO_K_CAP
    ns = grid.npml + 2
    auto = not fuse_steps
    for k in ([int(fuse_steps)] if not auto
              else range(min(cap, best), 1, -1)):
        if k < 2:
            return None
        if volume and k > cap:
            raise ValueError(f"fuse_steps={k} outside 0..{cap}")
        h = fk.CONTAMINATION * k
        if h > width - ns:
            continue
        ext = (width + 2 * h,) + tuple(grid.shape[1:])
        if auto and not volume and min(
                fk.admitted_depth(ext, device, viscous, dft)
                for dft in (False, True)) < k:
            continue
        return k, h
    return None


def overlap_schedule(grid: FDTDGrid, k: int):
    """[(first step, K, with_dft)] of an overlap-and-discard run: in the
    quiet phase and in the window, K-step sweeps, then one-step sweeps (the
    JAX sharded drivers' ``run_phase``)."""
    n_quiet = max(0, min(grid.sensor_start, grid.n_steps))
    out = []
    for n0, n1, dft in ((0, n_quiet, False), (n_quiet, grid.n_steps, True)):
        m = max(0, n1 - n0) // k
        out += [(n0 + k * j, k, dft) for j in range(m)]
        out += [(n, 1, dft) for n in range(n0 + k * m, n1)]
    return out


def state_groups(st) -> tuple:
    """The per-cell fields of a state that an overlap sweep refreshes in
    the ghost planes, in groups of one shape (the x psi slabs sit at the
    global edges, which have no ghost planes; the DFT sums of ghost planes
    are discarded). Fluid: the volumes p, vx, vy, vz, r; the four y psi
    slabs; the four z psi slabs. Visco (JAX's
    ``_simulate_visco_pallas_sharded_fused``): the 15 fields; the 12 y psi
    slabs; the 12 z psi slabs."""
    if isinstance(st, FluidState):
        return ([st.p, st.vx, st.vy, st.vz, st.r],
                st.psi_p[2:4] + st.psi_v[2:4], st.psi_p[4:6] + st.psi_v[4:6])
    fields = st.fields(("vx", "vy", "vz") + fdtd_visco_kernels.STRESSES
                       + fdtd_visco_kernels.MEMORIES)
    slabs = {1: [], 2: []}
    for psi, derivs in ((st.psi_s, fdtd_visco_kernels.VELOCITY_DERIVS),
                        (st.psi_v, fdtd_visco_kernels.STRESS_DERIVS)):
        for q, (_, axis, _) in enumerate(derivs):
            if axis:
                slabs[axis] += psi[2 * q:2 * q + 2]
    return fields, slabs[1], slabs[2]


def sweep_shards(shards, dd: Blocks, grid: FDTDGrid, n: int, k: int,
                 with_dft: bool, oz_scale: float, plain: bool = False) -> None:
    """Steps n..n+k-1 over the shards of an x mesh, overlap and discard:
    one bundled refresh of each group of ``state_groups``, then one fused
    launch (``fluid_fused`` or ``visco_fused``; with a volumetric drive
    ``fluid_halo``) per shard over its planes and ghost planes (``plain``:
    the plain version). Across processes each sweeps its own shards, the
    ghost planes that cross exchanged (a group's place in
    ``state_groups`` tags its messages)."""
    mine = _local(shards)
    if not mine:
        return
    groups = [None if sh is None else state_groups(sh.st) for sh in shards]
    for g in range(len(state_groups(mine[0][1].st))):
        dd.refresh_group([None if gr is None else gr[g] for gr in groups],
                         tag=g)
    rows = [step_scalars(grid, m, oz_scale) for m in range(n, n + k)]
    fused, ref, *_ = FUSED[type(mine[0][1].st)]
    for s, sh in mine:
        with _shard_range(sh, s):
            if sh.vsrc is not None:  # a volumetric drive: the halo sweep
                if plain:
                    fluid_halo_ref(sh.st, sh.co, rows, sh.vsrc,
                                   with_dft=with_dft)
                else:
                    fluid_halo(sh.st, sh.co, rows, sh.vsrc,
                               with_dft=with_dft, checked=True)
            elif plain:
                ref(sh.st, sh.co, rows, with_dft=with_dft)
            else:
                fused(sh.st, sh.co, rows, with_dft=with_dft, checked=True)


def own_planes(dd: Blocks, parts, n3: int | None = None) -> np.ndarray:
    """The global volume from each shard's (planes, rows, N3) part (numpy
    arrays or tensors): the block each shard owns, in place. Across
    processes (None for another process's part; ``n3`` = N3) every process
    gets the whole volume, the owned float32 blocks all-gathered (the JAX
    package's ``process_allgather(tiled=True)``)."""
    own = [None if p is None else
           (p.cpu().numpy() if torch.is_tensor(p) else p)[dd.own(s)]
           for s, p in enumerate(parts)]
    if dd.ranks is not None:
        own = _gather_owned(dd, own, (dd.x.width, dd.y.width, n3))
    ny = dd.y.n_shards
    return np.concatenate([np.concatenate(own[sx * ny:(sx + 1) * ny], axis=1)
                           for sx in range(dd.x.n_shards)])


def _gather_owned(dd: Blocks, own, shape) -> list:
    """Every shard's owned block (``own``: this process's, None for the
    others) on every process: one all-gather of each process's blocks in
    ascending shard order."""
    counts = [dd.ranks.count(r)
              for r in range(distributed.process_count(dd.group))]
    got = distributed.all_gather_blocks(
        [torch.from_numpy(np.ascontiguousarray(b, np.float32))
         for b in own if b is not None], shape, counts, dd.group)
    order = sorted(range(dd.n_shards), key=lambda s: (dd.ranks[s], s))
    out = [None] * dd.n_shards
    for s, b in zip(order, got):
        out[s] = b.numpy()
    return out


def overlap_plan(mesh, materials, grid: FDTDGrid, sel_maps=(),
                 monitor_ijk=None, fuse_steps=None):
    """``sharded_plan`` of a ``run_fdtd(mesh=)`` call (fluid or shear
    media), or None where that run keeps the pair: anything but a plane
    source or a fluid run's volumetric drive without diagnostics, a mesh
    cut along y (the sweeps decompose x only, as the JAX package's Pallas
    drivers: `babelbrain_tpu/ops/fdtd.py:1161`), or no K >= 2 that fits."""
    mats = np.asarray(materials, np.float64)
    visco = bool(np.any(mats[:, 2] > 0))
    volume = grid.source_type == "velocity_volume" and not visco
    if ((grid.source_type != "velocity_plane" and not volume) or sel_maps
            or monitor_ijk is not None):
        return None
    dd, devices = _decomposition(mesh, grid)
    if dd.y.n_shards > 1:
        return None
    viscous = sls_coefficients(mats, grid.frequency, grid.dt)["viscous"]
    mine = [devices[s] for s in range(dd.n_shards) if dd.is_local(s)]
    plan = (sharded_plan(dd.x.width, grid, mine[0], viscous, fuse_steps,
                         visco=visco, volume=volume) if mine else None)
    if dd.ranks is None:
        return plan
    # every process must take the same plan (ghost depth, refresh calls):
    # those with shards each propose theirs from their first device
    plans = {tuple(p) if p else None for has, p in
             distributed.all_gather_object((bool(mine), plan), dd.group)
             if has}
    if len(plans) > 1:
        raise ValueError(
            f"run_fdtd: the processes of the mesh reach different sweep "
            f"plans {sorted(plans, key=str)} on their devices; give every "
            f"process devices of one kind")
    return plans.pop()


def _run_fdtd_sharded(mesh, mat_idx, materials, grid: FDTDGrid, source_amp,
                      source_phase, point_amp, reflector_mask, volume_source,
                      sel_maps, monitor_ijk, sub: int,
                      fuse_steps=None) -> dict:
    """``run_fdtd`` decomposed along x and / or y over ``mesh``:
    overlap-and-discard fused sweeps where ``overlap_plan`` finds one, else
    the pair step by step; the maps and the monitor series assembled from
    what each shard owns."""
    sel = np.arange(grid.sensor_start, grid.n_steps, sub)
    plan = overlap_plan(mesh, materials, grid, sel_maps, monitor_ijk,
                        fuse_steps)
    with stage_timer("FDTD setup", level=3, step=2):
        dd, shards, oz_scale = shard_setup(
            mesh, mat_idx, materials, grid, source_amp, source_phase,
            reflector_mask, volume_source, sel_maps, monitor_ijk, sel,
            halo=2 if plan is None else plan[1])
    with stage_timer("FDTD time loop", level=3, step=2):
        if plan is None:
            for n in range(grid.n_steps):
                step_shards(shards, dd, grid, n, oz_scale, point_amp)
        else:
            for n, k, dft in overlap_schedule(grid, plan[0]):
                sweep_shards(shards, dd, grid, n, k, dft, oz_scale)
        _synchronize([sh.st.peak for _, sh in _local(shards)])
    fdtd_halo_kernels.release()

    n3 = grid.shape[2]
    result = _carrier_of(*(own_planes(dd, [None if sh is None else
                                           getattr(sh.st, k) for sh in shards],
                                      n3)
                           for k in ("acc_cos", "acc_sin", "peak")), grid)
    n_win = grid.n_steps - grid.sensor_start
    if sel_maps:
        maps = [None if sh is None else sh.diag.extras.read(n_win)
                for sh in shards]
        result.update({k: own_planes(dd, [None if m is None else m[k]
                                          for m in maps], n3)
                       for k in sel_maps})
    if monitor_ijk is not None:
        mon = np.asarray(monitor_ijk).reshape(-1, 3)
        series = np.zeros((len(sel), len(mon)), np.float32)
        for _, sh in _local(shards):
            if sh.diag.series is not None:  # the monitor's psum, by owner
                series[:, sh.slots] = sh.diag.series.cpu().numpy()
        if dd.ranks is not None:  # each voxel's column from its owner
            world = distributed.process_count(dd.group)
            got = [g.numpy() for g in distributed.all_gather_blocks(
                [torch.from_numpy(series)], series.shape, [1] * world,
                dd.group)]
            for j, (i, jj, _) in enumerate(mon):
                series[:, j] = got[dd.ranks[dd.owner(int(i), int(jj))]][:, j]
        result.update(_series(series, sel, grid))
    return result


# ---------------------------------------------------------------------------
# independent cases
# ---------------------------------------------------------------------------


def make_case_mesh(n_devices: int | None = None, devices=None):
    """1-D mesh on axis "case" for ``run_fdtd_batch``: ``devices`` (repeats
    allowed), or CUDA devices 0..n_devices-1 (all when None)."""
    return _make_mesh(n_devices, "case", devices)


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
    """Run B independent plane-source simulations.

    Multipoint steering runs one case per steering point (the reference
    loops them, `CalculateFieldProcess.py:78-111`); the cases share the
    material map and grid and differ only in their CW source plane. Each
    device runs its cases in turn from one ``fdtd_setup``, the state zeroed
    and the source plane swapped between them (in the fused sweeps of
    ``run_fdtd``'s schedule, either medium), so case b equals ``run_fdtd``
    with plane b bit for bit.

    ``source_amps``, ``source_phases``: (B, N1, N2) per-case planes.
    ``mesh``: a ``DeviceMesh`` (``make_case_mesh``, or a mesh of any axes:
    ``make_mesh_2d`` too, as the JAX package takes one) whose devices, in C
    order, take contiguous blocks of the cases (the JAX package's case-axis
    fan-out, without its padding), stepped in lockstep so that several
    cards work at once; without it every case runs on ``device``. A mesh
    over several processes raises ``NotImplementedError`` (ROADMAP Queue A
    item 6c: the JAX package runs only ``run_fdtd`` across processes).
    Returns the stacked (B, N1, N2, N3) 'p_amp', 'p_phase' and 'peak' of
    ``run_fdtd``.
    """
    devices = ((torch.device(device),) if mesh is None
               else mesh_devices(mesh, "run_fdtd_batch"))
    if grid.source_type != "velocity_plane":
        raise ValueError("run_fdtd_batch drives plane sources, not "
                         f"{grid.source_type!r}")
    amps = np.asarray(source_amps, np.float32)
    phases = np.asarray(source_phases, np.float32)
    if amps.ndim != 3 or amps.shape != phases.shape:
        raise ValueError("source_amps/source_phases must be (B, N1, N2)")
    cases = [list(c) for c in np.array_split(np.arange(amps.shape[0]),
                                             len(devices))]
    with stage_timer("FDTD setup", level=3, step=2):
        h = _host_setup(mat_idx, materials, grid, amps[0], phases[0],
                        reflector_mask)
        make, state, _ = h.family()
        runs = [(make(h.idx, h.table, h.profiles, *h.src, grid, h.viscous,
                      dev), state.zeros(grid.shape, grid.npml + 2, dev), c)
                for dev, c in zip(devices, cases) if c]
        plan = plan_run(runs[0][1], grid.shape, devices[0], h.viscous,
                        False)
    outs = {}
    for j in range(len(runs[0][2])):  # the first device has the most cases
        active = [(co, st, c[j]) for co, st, c in runs if j < len(c)]
        for co, st, b in active:
            if j:
                for v in vars(st).values():
                    for t in (v if isinstance(v, list) else [v]):
                        t.zero_()
            f32 = _to_device(st.peak.device)
            for k, v in _plane(amps[b], phases[b], f32).items():
                setattr(co, k, v)
        _fused_loop([(st, co) for co, st, _ in active], grid, h.oz_scale,
                    0.0, plan)
        for _, st, b in active:
            # copied now: on the CPU 'peak' is a view of the state, zeroed
            # by the next case
            outs[b] = _carrier(st, grid)
            outs[b]["peak"] = outs[b]["peak"].copy()
    return {k: np.stack([outs[b][k] for b in range(amps.shape[0])])
            for k in ("p_amp", "p_phase", "peak")}
