"""Pennes bio-heat (BHTE) solver with CEM43 dose.

PyTorch counterpart of ``babelbrain_tpu/ops/bhte.py``:

    rho C dT/dt = div(k grad T) + w_b rho_b C_b (T_a - T) + Q
    Q = absorption_fraction * attenuation * p^2 / (rho c) * duty_cycle

with FTCS time stepping (dt = 10 ms default), a 7-point Laplacian with
harmonic-mean interface conductivities and edge-replicated (adiabatic)
boundaries, perfusion converted from mL/min/kg, and the CEM43 thermal dose
``dose += dt * R^(43 - T)`` with R = 0.5 above 43 C and 0.25 below.

The schedule runs in JAX's segment order (``babelbrain_tpu/ops/
bhte_pallas.py:bhte_segment_pallas``): each (field, on) segment of n steps
is n // K sweeps of ``ops.bhte_kernels.bhte_fused`` (K steps a launch of
one CUDA kernel on a GPU), then n % K steps of ``bhte_step`` (one launch
each); a sweep never crosses a segment. K is ``bhte_run``'s ``fuse_steps``:
by default ``BHTE_FUSE_BEST`` on a card and 1 (every step through
``bhte_step``, as JAX's XLA path on its CPU) elsewhere. Monitor-point
temperatures are sampled after each sweep and after each one-step launch
(``monitor_steps``) into a preallocated device tensor, with no host sync
inside the loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.timing import stage_timer
from .bhte_kernels import (
    BHTE_FUSE_BEST,
    BHTE_K_CAP,
    BHTECoeffs,
    bhte_fused,
    bhte_step,
    edge_shift,
)

# IT'IS blood properties for the perfusion term
BLOOD_DENSITY = 1050.0  # kg/m^3
BLOOD_SPECIFIC_HEAT = 3617.0  # J/kg/C


def _harmonic_mean(a, b):
    return 2.0 * a * b / (a + b + 1e-30)


@dataclass
class BHTEResult:
    temperature: np.ndarray  # T at end of schedule
    peak_temperature: np.ndarray  # max T over schedule
    dose: np.ndarray  # CEM43 in seconds
    monitor: np.ndarray  # (n_points, n_samples) temperatures
    # global step index of each monitor sample (``monitor_steps``)
    monitor_steps: np.ndarray | None = None


def _build_coeff_maps(mat_idx, mats, dx, dt):
    """Host-side per-voxel coefficient maps from the thermal material list."""
    idx = np.asarray(mat_idx)
    rho = np.asarray(mats.density, np.float64)[idx]
    cp = np.asarray(mats.specific_heat, np.float64)[idx]
    kth = np.asarray(mats.conductivity, np.float64)[idx]
    w = np.asarray(mats.perfusion, np.float64)[idx]  # mL/min/kg

    inv_rho_cp = 1.0 / (rho * cp)
    # perfusion rate (1/s): mL/min/kg * rho[kg/m3] -> mL/min/m3 -> m3/s/m3
    omega = w * rho / (60.0 * 1e6)
    perf = omega * BLOOD_DENSITY * BLOOD_SPECIFIC_HEAT * inv_rho_cp * dt

    diff = kth  # conductivity map; interface averaging at run time
    return {
        "inv_rho_cp_dt": (inv_rho_cp * dt).astype(np.float32),
        "k": diff.astype(np.float32),
        "perf_dt": perf.astype(np.float32),
        "inv_dx2": np.float32(1.0 / dx**2),
    }


def absorption_heating(pressure, mat_idx, mats, duty_cycle=1.0):
    """Volumetric heat source Q (W/m^3) from a pressure amplitude map."""
    idx = np.asarray(mat_idx)
    rho = np.asarray(mats.density, np.float64)[idx]
    sos = np.asarray(mats.sos, np.float64)[idx]
    att = np.asarray(mats.attenuation, np.float64)[idx]
    absf = np.asarray(mats.absorption, np.float64)[idx]
    p = np.asarray(pressure, np.float64)
    return (absf * att * p**2 / (rho * sos) * duty_cycle).astype(np.float32)


def make_bhte_coeffs(coeff_np: dict, device) -> BHTECoeffs:
    """Device coefficients: interface conductivities (harmonic means with
    the edge-replicated neighbour) pre-scaled by 1/dx^2."""
    dev = torch.device(device)
    km = torch.as_tensor(coeff_np["k"], device=dev)
    inv_dx2 = float(coeff_np["inv_dx2"])
    k6 = [
        (_harmonic_mean(km, edge_shift(km, off, axis)) * inv_dx2).contiguous()
        for axis in range(3)
        for off in (1, -1)
    ]
    return BHTECoeffs(
        k6=k6,
        irc=torch.as_tensor(coeff_np["inv_rho_cp_dt"], device=dev),
        perf=torch.as_tensor(coeff_np["perf_dt"], device=dev),
    )


def bhte_run(
    pressure_fields,
    mat_idx,
    mats,
    dx: float,
    schedule,
    *,
    dt: float = 0.01,
    duty_cycle: float = 1.0,
    monitor_points=None,
    initial_temperature=None,
    initial_dose=None,
    arterial_temperature: float | None = None,
    dose_dt_scale: float = 1.0,
    device="cuda",
    fuse_steps: int | None = None,
) -> BHTEResult:
    """Run a BHTE schedule.

    Parameters
    ----------
    pressure_fields : (F, N1, N2, N3) or (N1, N2, N3) pressure amplitude maps
        (Pa). Multiple fields model time-multiplexed multipoint steering.
    schedule : sequence of (field_index, n_steps, on) tuples executed in
        order; ``field_index < 0`` or ``on=False`` means no heating.
    duty_cycle : scales Q during 'on' phases.
    monitor_points : (P, 3) integer voxel indices to record, after each
        sweep and each one-step launch (``monitor_steps``).
    device : where the volumes live (CUDA: the BHTE kernels; CPU: their
        plain PyTorch versions).
    fuse_steps : K, the steps a sweep advances (JAX's
        ``bhte_segment_pallas(fuse_steps=)``): None takes ``BHTE_FUSE_BEST``
        on a card and 1 elsewhere; 1 runs one step a launch; 2..8 pin K.
        Results do not depend on it (bit for bit); the monitor cadence does.

    Returns BHTEResult; dose is CEM43 in seconds.
    """
    dev = torch.device(device)
    k = fuse_depth(fuse_steps, dev)
    with stage_timer("BHTE setup", level=3, step=3):
        state = _bhte_setup(pressure_fields, mat_idx, mats, dx, dt,
                            duty_cycle, monitor_points, initial_temperature,
                            initial_dose, arterial_temperature,
                            dose_dt_scale, dev)
    with stage_timer("BHTE time loop", level=3, step=3):
        return _bhte_loop(*state, schedule, dt, dose_dt_scale, dev, k)


def fuse_depth(fuse_steps, device) -> int:
    """The K ``bhte_run(fuse_steps=)`` runs on ``device``: JAX's
    ``backend="auto"`` rule, the K-step sweep on the accelerator and one
    step at a time elsewhere, unless pinned."""
    if fuse_steps is None:
        return BHTE_FUSE_BEST if torch.device(device).type == "cuda" else 1
    k = int(fuse_steps)
    if k != fuse_steps or not 1 <= k <= BHTE_K_CAP:
        raise ValueError(f"fuse_steps={fuse_steps!r}: 1..{BHTE_K_CAP} or None")
    return k


def segment_plan(schedule, k: int):
    """Per schedule segment (field, on, sweeps of K steps, one-step tail
    launches): JAX's split, ``n // K`` sweeps then ``n % K`` single steps
    (K = 1: every step a single one)."""
    plan = []
    for f_idx, n_steps, on in schedule:
        n = max(int(n_steps), 0)
        sweeps = n // k if k >= 2 else 0
        plan.append((f_idx, on, sweeps, n - k * sweeps))
    return plan


def monitor_steps(schedule, k: int) -> np.ndarray:
    """The global step index of each monitor sample of a run with K-step
    sweeps: the last step of each sweep, then each tail step, segment by
    segment (JAX's ``bhte_segment_pallas`` offset as in its ``bhte_run``)."""
    steps, step0 = [], 0
    for _, _, sweeps, tail in segment_plan(schedule, k):
        done = step0 + k * sweeps
        steps += [*range(step0 + k - 1, done, k), *range(done, done + tail)]
        step0 = done + tail
    return np.asarray(steps, np.int64)


def schedule_launches(schedule, k: int) -> dict:
    """Kernel launches of a run: ``bhte_fused`` sweeps and ``bhte_step``
    one-step launches."""
    plan = segment_plan(schedule, k)
    return {"bhte_fused": sum(p[2] for p in plan),
            "bhte_step": sum(p[3] for p in plan)}


def _bhte_setup(pressure_fields, mat_idx, mats, dx, dt, duty_cycle,
                monitor_points, initial_temperature, initial_dose,
                arterial_temperature, dose_dt_scale, dev):
    """The device inputs of ``bhte_run``: (heat maps, coefficients, T,
    dose, peak, monitor indices, arterial temperature)."""
    p = np.asarray(pressure_fields, np.float32)
    if p.ndim == 3:
        p = p[None]
    F = p.shape[0]
    shape = p.shape[1:]
    Q = [
        torch.as_tensor(absorption_heating(p[f], mat_idx, mats, duty_cycle),
                        device=dev)
        for f in range(F)
    ]
    co = make_bhte_coeffs(_build_coeff_maps(mat_idx, mats, dx, dt), dev)

    t_init = np.asarray(mats.init_temperature, np.float64)[np.asarray(mat_idx)]
    # a copy: the loop writes T in place, and on the CPU ``torch.as_tensor``
    # would share the caller's array (a chained run's previous result)
    T = torch.tensor(
        np.asarray(initial_temperature if initial_temperature is not None
                   else t_init, np.float32),
        device=dev,
    ).contiguous()
    dose = torch.as_tensor(
        np.asarray((np.asarray(initial_dose) / (dt * dose_dt_scale))
                   if initial_dose is not None else np.zeros(shape),
                   np.float32),
        device=dev,
    ).contiguous()
    peak = torch.full_like(T, -1e9)
    if monitor_points is None:
        monitor_points = np.zeros((1, 3), np.int64)
    mp = np.asarray(monitor_points)
    flat_idx = torch.as_tensor(
        np.ravel_multi_index((mp[:, 0], mp[:, 1], mp[:, 2]), shape), device=dev
    )
    t_art = float(
        arterial_temperature
        if arterial_temperature is not None
        else np.asarray(mats.init_temperature).max()
    )
    return Q, co, T, dose, peak, flat_idx, t_art


def _bhte_loop(Q, co, T, dose, peak, flat_idx, t_art, schedule, dt,
               dose_dt_scale, dev, k) -> BHTEResult:
    """The schedule from the setup's state at depth ``k``; results read back
    to the host (the readback waits for the device)."""
    steps = monitor_steps(schedule, k)
    mons = torch.empty((len(steps), len(flat_idx)), dtype=torch.float32,
                       device=dev)
    spare = torch.empty_like(T)
    s = 0
    for f_idx, on, sweeps, tail in segment_plan(schedule, k):
        q = Q[int(f_idx)] if (on and f_idx >= 0) else None
        for n in range(sweeps + tail):
            if n < sweeps:
                T_new = bhte_fused(T, dose, peak, co, q, t_art, k, T_out=spare)
            else:
                T_new = bhte_step(T, dose, peak, co, q, t_art, T_out=spare)
            T, spare = T_new, T
            torch.index_select(T.view(-1), 0, flat_idx, out=mons[s])
            s += 1
    return BHTEResult(
        temperature=T.cpu().numpy(),
        peak_temperature=peak.cpu().numpy(),
        dose=dose.cpu().numpy() * dt * dose_dt_scale,
        monitor=mons.cpu().numpy().T,
        monitor_steps=steps,
    )


def cem43(T_history_dt, temperatures):
    """Reference CEM43 for a temperature time series (seconds)."""
    T = np.asarray(temperatures, np.float64)
    R = np.where(T >= 43.0, 0.5, 0.25)
    return float(np.sum(T_history_dt * R ** (43.0 - T)))
