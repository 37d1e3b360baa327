"""Viscoelastic FDTD step: CUDA kernels, their wrappers and plain versions.

One viscoelastic leapfrog step (label mode: shear in the skull) is two
kernels (``csrc/fdtd_visco.cu``):

* ``visco_velocity`` — v_i += dt/dx rho_inv sum_j D sigma_ij with nine
  CPML'd stress derivatives, then the CW plane source SET into vz at
  ``zsrc`` where the source amplitude is positive;
* ``visco_stress`` — six stresses and six SLS memory variables from nine
  CPML'd velocity derivatives; with ``point`` the stress-point source
  (refocusing) added to sxx, syy and szz at one cell; with the carrier DFT
  and |p| peak of p = -(sxx+syy+szz)/3 inside the sensor window
  (``cosw``/``sinw`` given); with ``monitor`` (``ops.fdtd_extras.Monitor``)
  that pressure sampled at the monitor voxels, or at every voxel, into a
  row of the series (the kernel's MONITOR instantiations).

Materials are indexed: an int32 index volume and a (6, M) float32 table with
rows [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r] (``ops.fdtd
._build_indexed_materials``), gathered per voxel.

They replace the JAX package's Pallas kernel B5 and the one-step point
injection of B6-B8 (``babelbrain_tpu/ops/fdtd_pallas.py``); the K-step
sweeps of B6-B8 are ``ops.fdtd_visco_fused_kernels`` (plane and point
sources) and ``ops.fdtd_visco_halo_kernels`` (a volumetric source), whose
runs end in one-step tails of this pair. The math is the XLA step of
``babelbrain_tpu/ops/fdtd.py:_make_step_fn``; a volumetric (dome) source is
``ops.fdtd_sources``, launched between the two.

x decomposition: as the fluid step, ``x_lo`` / ``x_hi`` of the
coefficients say which x-CPML slabs a shard's launches apply (the port of
the ``edge_offset`` of B6/B8).

The wrappers dispatch on the device of the state: a CPU state runs the plain
version (``visco_velocity_ref`` / ``visco_stress_ref``), a CUDA state
launches the kernel on that device and its current stream (or raises); a
tensor on another device is refused. All state is updated in place. ``launches`` counts kernel launches, ``plain_calls`` calls of the
plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build
from .fdtd_kernels import (
    LaunchGeometry,
    _check_size,
    _cpml,
    _gather,
    _ptr,
    _edges,
    _ptrs,
    check_point,
    d_minus,
    d_plus,
    launch_geometry,
    monitor_args,
    pressure_key,
)

_KEYS = ("visco_velocity", "visco_stress", "visco_stress_dft",
         "visco_stress_point", "visco_stress_point_dft")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)

# the stress kernel keeps five table rows in (static-size) shared memory
MAX_MATERIALS = 48 * 1024 // (5 * 4)

# x-planes a block of the visco kernels marches at most (the launch geometry
# of ops.fdtd_kernels.launch_geometry), chosen on an H100 (PERF.md)
SEGMENT_PLANES = 8


def visco_launch_geometry(shape) -> LaunchGeometry:
    """The launch geometry of both kernels on an (N1, N2, N3) grid."""
    return launch_geometry(shape, SEGMENT_PLANES)


# CPML'd derivatives of each kernel, as (field, axis, forward?): a forward
# difference (d_plus) takes the "half" profiles, a backward one the "int"
VELOCITY_DERIVS = (
    ("sxx", 0, True), ("sxy", 1, False), ("sxz", 2, False),
    ("sxy", 0, False), ("syy", 1, True), ("syz", 2, False),
    ("sxz", 0, False), ("syz", 1, False), ("szz", 2, True),
)
STRESS_DERIVS = (
    ("vx", 0, False), ("vy", 1, False), ("vz", 2, False),
    ("vx", 1, True), ("vy", 0, True), ("vx", 2, True),
    ("vz", 0, True), ("vy", 2, True), ("vz", 1, True),
)
STRESSES = ("sxx", "syy", "szz", "sxy", "sxz", "syz")
MEMORIES = ("rxx", "ryy", "rzz", "rxy", "rxz", "ryz")


@dataclass
class ViscoCoeffs:
    """Step-invariant inputs of the viscoelastic step (one device).

    ``mat_idx``: int32 (N1, N2, N3) material index; ``table``: float32
    (6, M) rows [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r]. ``cpml_half`` /
    ``cpml_int``: (3, 4, ns) profiles, per axis the rows [b_lo, a_lo, b_hi,
    a_hi] of the ns-plane slabs. ``src_*``: (N1, N2) source amplitude and
    cos/sin of its phase. ``x_lo`` / ``x_hi``: which x-CPML slabs the step
    applies (``ops.fdtd_kernels.FluidCoeffs``).
    """

    mat_idx: torch.Tensor
    table: torch.Tensor
    cpml_half: torch.Tensor
    cpml_int: torch.Tensor
    src_amp: torch.Tensor
    src_cph: torch.Tensor
    src_sph: torch.Tensor
    dt_dx: float
    inv_dx: float
    half_dt: float
    zsrc: int
    viscous: bool
    x_lo: bool = True
    x_hi: bool = True


@dataclass
class ViscoState:
    """The 15 fields, the CPML psi slabs and the DFT accumulators.

    ``psi_s`` / ``psi_v``: the [lo, hi] slabs of each derivative of
    ``VELOCITY_DERIVS`` / ``STRESS_DERIVS`` in turn (18 tensors each), with
    shapes (ns, N2, N3), (N1, ns, N3) or (N1, N2, ns) for the x, y, z axis.
    """

    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    sxx: torch.Tensor
    syy: torch.Tensor
    szz: torch.Tensor
    sxy: torch.Tensor
    sxz: torch.Tensor
    syz: torch.Tensor
    rxx: torch.Tensor
    ryy: torch.Tensor
    rzz: torch.Tensor
    rxy: torch.Tensor
    rxz: torch.Tensor
    ryz: torch.Tensor
    acc_cos: torch.Tensor
    acc_sin: torch.Tensor
    peak: torch.Tensor
    psi_s: list
    psi_v: list

    @classmethod
    def zeros(cls, shape, ns, device) -> "ViscoState":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731

        def slab(axis):
            s = list(shape)
            s[axis] = ns
            return z(*s)

        def psi(derivs):
            return [slab(axis) for _, axis, _ in derivs for _ in range(2)]

        vols = ("vx", "vy", "vz") + STRESSES + MEMORIES + (
            "acc_cos", "acc_sin", "peak")
        return cls(**{k: z(*shape) for k in vols},
                   psi_s=psi(VELOCITY_DERIVS), psi_v=psi(STRESS_DERIVS))

    def fields(self, names):
        return [getattr(self, k) for k in names]


def _check(st: ViscoState, co: ViscoCoeffs) -> tuple:
    """Validate device, dtype, shape and contiguity; return (shape, ns)."""
    shape = tuple(st.vx.shape)
    if len(shape) != 3:
        raise ValueError(f"visco state must be 3-D, got {shape}")
    n1, n2, n3 = shape
    ns = co.cpml_half.shape[-1]
    if min(shape) < ns:
        raise ValueError(f"grid {shape} thinner than the CPML slab ({ns})")
    dev = st.vx.device
    n_mat = co.table.shape[-1]
    vols = st.fields(("vx", "vy", "vz") + STRESSES + MEMORIES
                     + ("acc_cos", "acc_sin", "peak"))
    slab = {0: (ns, n2, n3), 1: (n1, ns, n3), 2: (n1, n2, ns)}
    expect = (
        [(t, shape, torch.float32) for t in vols]
        + [(co.mat_idx, shape, torch.int32), (co.table, (6, n_mat), torch.float32)]
        + [(t, slab[axis], torch.float32)
           for psi, derivs in ((st.psi_s, VELOCITY_DERIVS), (st.psi_v, STRESS_DERIVS))
           for t, axis in zip(psi, [a for _, a, _ in derivs for _ in range(2)])]
        + [(t, (3, 4, ns), torch.float32) for t in (co.cpml_half, co.cpml_int)]
        + [(t, (n1, n2), torch.float32)
           for t in (co.src_amp, co.src_cph, co.src_sph)]
    )
    if len(st.psi_s) != 18 or len(st.psi_v) != 18:
        raise ValueError("visco step: 18 psi slabs per kernel expected")
    for t, s, dtype in expect:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(
                f"visco step: expected {dtype} on {dev}, got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != s or not t.is_contiguous():
            raise ValueError(
                f"visco step: expected a contiguous {s} tensor, got "
                f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
            )
    if not 1 <= n_mat <= MAX_MATERIALS:
        raise ValueError(f"visco step: {n_mat} materials (1..{MAX_MATERIALS})")
    if not 0 <= co.zsrc < n3:
        raise ValueError(f"source plane z={co.zsrc} outside the grid")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"visco step: unsupported device {dev}")
    return shape, ns


def check_step(st: ViscoState, co: ViscoCoeffs) -> None:
    """Validate a state and its coefficients once, for the calls that then
    pass ``checked=True`` (``ops.fdtd_kernels.check_step``)."""
    _shape(st, co, False)


def _shape(st, co, checked: bool) -> tuple:
    """(shape, ns) of a step, validated unless ``checked``; the kernels'
    size limit on the CUDA route."""
    if checked:
        return tuple(st.vx.shape), co.cpml_half.shape[-1]
    shape, ns = _check(st, co)
    if st.vx.device.type == "cuda":
        _check_size(shape, "visco step")
    return shape, ns


def visco_velocity(st: ViscoState, co: ViscoCoeffs, s_sin: float,
                   s_cos: float, *, checked: bool = False) -> None:
    """Velocity half-step in place; ``s_sin``/``s_cos`` are sin(wt) and
    cos(wt) times the source ramp and the pressure->velocity scale;
    ``checked``: ``check_step`` validated (st, co) already."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    if st.vx.device.type == "cpu":
        visco_velocity_ref(st, co, s_sin, s_cos)
        return
    geo = visco_launch_geometry((n1, n2, n3))
    _build.launch(
        "bb_visco_velocity", "visco_velocity_kernel", st.vx.device,
        _ptrs(st.fields(STRESSES)), _ptrs(st.fields(("vx", "vy", "vz"))),
        _ptr(co.mat_idx), _ptr(co.table), _ptrs(st.psi_s),
        _ptr(co.cpml_half), _ptr(co.cpml_int), _ptr(co.src_amp),
        _ptr(co.src_cph), _ptr(co.src_sph), s_sin, s_cos, co.dt_dx,
        co.table.shape[1], n1, n2, n3, ns, int(co.x_lo), int(co.x_hi),
        co.zsrc, geo.tile_y, geo.segment, *geo.grid,
    )
    launches["visco_velocity"] += 1


def visco_stress(st: ViscoState, co: ViscoCoeffs, cosw: float | None = None,
                 sinw: float | None = None, point=None,
                 monitor=None, *, checked: bool = False) -> None:
    """Stress half-step in place; with ``point`` = (linear cell index,
    value) the point source is added to that cell's normal stresses; with
    ``cosw``/``sinw`` (the carrier cos/sin at this step) it also accumulates
    the DFT and the |p| peak; with ``monitor`` (an
    ``ops.fdtd_extras.Monitor``) it samples the new pressure; ``checked``
    as ``visco_velocity``."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    check_point(point, (n1, n2, n3))
    with_dft = cosw is not None
    if st.vx.device.type == "cpu":
        visco_stress_ref(st, co, cosw, sinw, point, monitor)
        return
    pt, sval = point if point is not None else (0, 0.0)
    geo = visco_launch_geometry((n1, n2, n3))
    mon = monitor_args(monitor, st.sxx, geo)
    _build.launch(
        "bb_visco_stress", "visco_stress_kernel", st.vx.device,
        _ptrs(st.fields(("vx", "vy", "vz"))), _ptrs(st.fields(STRESSES)),
        _ptrs(st.fields(MEMORIES)), _ptr(co.mat_idx), _ptr(co.table),
        _ptr(st.acc_cos), _ptr(st.acc_sin), _ptr(st.peak), _ptrs(st.psi_v),
        _ptr(co.cpml_half), _ptr(co.cpml_int), co.dt_dx, co.inv_dx,
        co.half_dt, cosw if with_dft else 0.0, sinw if with_dft else 0.0,
        co.table.shape[1], n1, n2, n3, ns, int(co.x_lo), int(co.x_hi),
        int(co.viscous), int(with_dft), int(point is not None), pt, sval,
        *mon, geo.tile_y, geo.segment, *geo.grid,
    )
    launches[pressure_key("visco_stress", with_dft, point)] += 1
    if monitor is not None:
        monitor.launched()


# ---------------------------------------------------------------------------
# plain PyTorch versions (same operation order as the kernels)
# ---------------------------------------------------------------------------


def _derivs(st: ViscoState, co: ViscoCoeffs, derivs, psi) -> list:
    """The CPML'd derivatives of ``derivs``, updating their psi slabs."""
    out = []
    for q, (name, axis, forward) in enumerate(derivs):
        f = getattr(st, name)
        d = d_plus(f, axis) if forward else d_minus(f, axis)
        prof = (co.cpml_half if forward else co.cpml_int)[axis]
        out.append(_cpml(d, axis, prof, psi[2 * q], psi[2 * q + 1],
                         **_edges(co, axis)))
    return out


def visco_velocity_ref(st: ViscoState, co: ViscoCoeffs, s_sin: float,
                       s_cos: float) -> None:
    """Plain version of ``visco_velocity_kernel`` (in place)."""
    plain_calls["visco_velocity"] += 1
    rho_inv = _gather(co, 0)
    d = _derivs(st, co, VELOCITY_DERIVS, st.psi_s)
    for a, v in enumerate((st.vx, st.vy, st.vz)):
        v.copy_(v + co.dt_dx * rho_inv * (d[3 * a] + d[3 * a + 1] + d[3 * a + 2]))
    plane = st.vz[:, :, co.zsrc]
    sval = co.src_amp * (s_sin * co.src_cph + s_cos * co.src_sph)
    plane.copy_(torch.where(co.src_amp > 0, sval, plane))


def visco_stress_ref(st: ViscoState, co: ViscoCoeffs,
                     cosw: float | None = None,
                     sinw: float | None = None, point=None,
                     monitor=None) -> None:
    """Plain version of ``visco_stress_kernel`` (in place); the monitor
    sample is ``ops.fdtd_extras.monitor_gather_ref`` after the step."""
    with_dft = cosw is not None
    plain_calls[pressure_key("visco_stress", with_dft, point)] += 1
    pi_u, mu_u, c_rp, c_rs, b_r = (_gather(co, r) for r in range(1, 6))
    d = _derivs(st, co, STRESS_DERIVS, st.psi_v)
    theta = d[0] + d[1] + d[2]
    strains = [d[3] + d[4], d[5] + d[6], d[7] + d[8]]  # exy, exz, eyz
    for a, (s, r) in enumerate(zip(st.fields(STRESSES), st.fields(MEMORIES))):
        if a < 3:
            el = pi_u * theta - 2 * mu_u * (theta - d[a])
            new_s = s + co.dt_dx * el
            if co.viscous:
                phi = c_rp * theta - 2.0 * c_rs * (theta - d[a])
                new_r = b_r * r - phi * co.inv_dx
        else:
            e = strains[a - 3]
            new_s = s + co.dt_dx * mu_u * e
            if co.viscous:
                new_r = b_r * r - c_rs * e * co.inv_dx
        if co.viscous:
            new_s = new_s + co.half_dt * (new_r + r)
            r.copy_(new_r)
        s.copy_(new_s)
    if point is not None:
        index, sval = point
        for s in (st.sxx, st.syy, st.szz):
            cell = s.view(-1)[index]
            cell.copy_(cell + sval)
    if with_dft:
        p = -(st.sxx + st.syy + st.szz) * (1.0 / 3.0)
        st.acc_cos.copy_(st.acc_cos + p * cosw)
        st.acc_sin.copy_(st.acc_sin + p * sinw)
        st.peak.copy_(torch.maximum(st.peak, p.abs()))
    if monitor is not None:
        monitor.gather_ref(st)
