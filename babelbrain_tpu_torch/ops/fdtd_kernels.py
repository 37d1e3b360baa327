"""Fluid FDTD step: CUDA kernels, their wrappers and plain PyTorch versions.

One fluid leapfrog step is two kernels (``csrc/fdtd_fluid.cu``):

* ``fluid_velocity`` — v_i -= dt/dx rho_inv (D+_i p + psi), CPML on all
  three axes ("half" profiles), then the CW plane source SET into vz at
  ``zsrc`` where the source amplitude is positive;
* ``fluid_pressure`` — theta = sum of the CPML'd D-_i v_i ("int" profiles),
  the SLS memory r, p -= dt/dx pi_u theta + dt (r' + r)/2; with ``point``
  the stress-point source (refocusing) subtracted from p at one cell; with
  the carrier DFT and |p| peak inside the sensor window (``cosw``/``sinw``
  given); with ``monitor`` (``ops.fdtd_extras.Monitor``) the new pressure
  sampled at the monitor voxels, or at every voxel, into a row of the
  series (the kernel's MONITOR instantiations).

Materials are indexed: an int32 index volume and the (6, M) float32 table
of ``ops.fdtd._build_indexed_materials`` (rows [rho_inv, pi_u, mu_u, c_rp,
c_rs, b_r], reflector twins included); the fluid step reads rows 0, 1, 3
and 5, the kernels through the read-only data path (any table size).

They replace the JAX package's Pallas kernel B1
(``babelbrain_tpu/ops/fdtd_pallas.py``); B2-B4, K steps a launch, are
``ops.fdtd_fused_kernels``, whose plain version is K steps of this pair.
The math is the XLA step of ``babelbrain_tpu/ops/fdtd.py
:_make_fluid_step_fn``; a volumetric (dome) source is ``ops.fdtd_sources``,
launched between the two.

Launch geometry (both FDTD families, ``launch_geometry``): blocks of
``TILE_Z`` x ``TILE_Y`` threads own (y, z) tiles of columns and march along
x over segments of planes; the wrappers pass the grid to the C entry
points, which refuse one that does not cover the volume once.

x decomposition (``ops.fdtd.run_fdtd(mesh=)``): the coefficients of one
shard say whether its launches apply the x CPML's lo and hi slabs
(``x_lo`` / ``x_hi``: where the shard holds that global edge), the port of
the ``edge_offset`` of B2/B4.

The wrappers dispatch on the device of the state: a CPU state runs the plain
version (``fluid_velocity_ref`` / ``fluid_pressure_ref``), a CUDA state
launches the kernel on that device and its current stream (or raises); a
tensor on another device is refused. All state is updated in place. ``launches`` counts kernel launches, ``plain_calls`` calls of the
plain versions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

# 4th-order staggered-grid coefficients
_C1 = 9.0 / 8.0
_C2 = -1.0 / 24.0

_KEYS = ("fluid_velocity", "fluid_pressure", "fluid_pressure_dft",
         "fluid_pressure_point", "fluid_pressure_point_dft")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)


# Launch geometry of the FDTD kernels (csrc/fdtd_stencil.cuh): a block of
# TILE_Z x TILE_Y threads owns a (y, z) tile of columns and marches along x
# over a segment of at most a family's segment length in planes. TILE_Z is
# one warp along z (128 contiguous bytes); TILE_Y is compiled into the
# kernels; the segment lengths were chosen on an H100 (PERF.md): short
# segments give the grid many waves of blocks. SEGMENT_PLANES is the fluid
# family's (ops.fdtd_visco_kernels has its own).
TILE_Z = 32
TILE_Y = 8
SEGMENT_PLANES = 2


@dataclass(frozen=True)
class LaunchGeometry:
    """``tile_y`` threads along y (and ``TILE_Z`` along z) a block;
    ``segment`` x-planes a block marches; ``grid`` the blocks along
    (z, y, x), as the wrappers launch it."""

    tile_y: int
    segment: int
    grid: tuple

    def planes(self, s: int, n1: int) -> range:
        """The x-planes segment ``s`` updates."""
        return range(s * self.segment, min((s + 1) * self.segment, n1))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_geometry(shape, segment_planes: int) -> LaunchGeometry:
    """The launch geometry on an (N1, N2, N3) grid with segments of at most
    ``segment_planes`` planes (the shortest segments for that many)."""
    n1, n2, n3 = shape
    seg = _cdiv(n1, _cdiv(n1, segment_planes))
    return LaunchGeometry(TILE_Y, seg,
                          (_cdiv(n3, TILE_Z), _cdiv(n2, TILE_Y), _cdiv(n1, seg)))


def fluid_launch_geometry(shape) -> LaunchGeometry:
    """The launch geometry of both fluid kernels on an (N1, N2, N3) grid."""
    return launch_geometry(shape, SEGMENT_PLANES)


@dataclass
class FluidCoeffs:
    """Step-invariant inputs of the fluid step (one device).

    ``mat_idx``: int32 (N1, N2, N3) material index; ``table``: float32
    (6, M) rows [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r]. ``cpml_half`` /
    ``cpml_int``: (3, 4, ns) profiles, per axis the rows [b_lo, a_lo, b_hi,
    a_hi] of the ns-plane slabs. ``src_*``: (N1, N2) source amplitude and
    cos/sin of its phase. ``x_lo`` / ``x_hi``: whether the step applies the
    x CPML's lo slab (first ns planes) / hi slab (last ns planes); both for
    a whole grid, on a shard of an x decomposition only at a global edge.
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
class FluidState:
    """Fields of the fluid system, the CPML psi slabs and the accumulators.

    ``psi_p`` / ``psi_v``: [x_lo, x_hi, y_lo, y_hi, z_lo, z_hi] with shapes
    (ns, N2, N3), (N1, ns, N3), (N1, N2, ns) for the x, y, z slabs.
    """

    p: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    r: torch.Tensor
    acc_cos: torch.Tensor
    acc_sin: torch.Tensor
    peak: torch.Tensor
    psi_p: list
    psi_v: list

    @classmethod
    def zeros(cls, shape, ns, device) -> "FluidState":
        n1, n2, n3 = shape
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)

        def psi():
            return [z(ns, n2, n3), z(ns, n2, n3), z(n1, ns, n3), z(n1, ns, n3),
                    z(n1, n2, ns), z(n1, n2, ns)]

        return cls(p=z(n1, n2, n3), vx=z(n1, n2, n3), vy=z(n1, n2, n3),
                   vz=z(n1, n2, n3), r=z(n1, n2, n3), acc_cos=z(n1, n2, n3),
                   acc_sin=z(n1, n2, n3), peak=z(n1, n2, n3),
                   psi_p=psi(), psi_v=psi())


def _check(st: FluidState, co: FluidCoeffs) -> tuple:
    """Validate device, dtype, shape and contiguity, the material index
    against the table and, on the CUDA route, the grid against the kernels'
    32-bit offsets; return (shape, ns)."""
    shape = tuple(st.p.shape)
    if len(shape) != 3:
        raise ValueError(f"fluid state must be 3-D, got {shape}")
    n1, n2, n3 = shape
    ns = co.cpml_half.shape[-1]
    if min(shape) < ns:
        raise ValueError(f"grid {shape} thinner than the CPML slab ({ns})")
    dev = st.p.device
    n_mat = co.table.shape[-1]
    vols = [st.p, st.vx, st.vy, st.vz, st.r, st.acc_cos, st.acc_sin, st.peak]
    psi_shapes = [(ns, n2, n3)] * 2 + [(n1, ns, n3)] * 2 + [(n1, n2, ns)] * 2
    f32 = torch.float32
    expect = ([(t, shape, f32) for t in vols]
              + [(t, s, f32) for t, s in zip(st.psi_p, psi_shapes)]
              + [(t, s, f32) for t, s in zip(st.psi_v, psi_shapes)]
              + [(co.cpml_half, (3, 4, ns), f32), (co.cpml_int, (3, 4, ns), f32)]
              + [(t, (n1, n2), f32)
                 for t in (co.src_amp, co.src_cph, co.src_sph)]
              + [(co.table, (6, n_mat), f32), (co.mat_idx, shape, torch.int32)])
    for t, s, dtype in expect:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(
                f"fluid step: expected {dtype} on {dev}, got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != s or not t.is_contiguous():
            raise ValueError(
                f"fluid step: expected a contiguous {s} tensor, got "
                f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
            )
    if n_mat < 1:
        raise ValueError("fluid step: the material table is empty")
    if not 0 <= co.zsrc < n3:
        raise ValueError(f"source plane z={co.zsrc} outside the grid")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fluid step: unsupported device {dev}")
    if dev.type == "cuda":
        _check_size(shape, "fluid step")
    _check_index(co)
    return shape, ns


def check_step(st: FluidState, co: FluidCoeffs) -> None:
    """Validate a state and its coefficients once, for the calls that then
    pass ``checked=True`` (a decomposed run's loop, whose shards keep their
    tensors: the wrappers' per-call checks cost more host time than a
    shard's launch takes on the card)."""
    _check(st, co)


def _check_size(shape, what: str = "FDTD step") -> None:
    """The kernels index cells with 32-bit offsets (the plain versions have
    no such limit)."""
    n1, n2, n3 = shape
    if n1 * n2 * n3 >= 2**31:
        raise ValueError(f"{what}: grid {tuple(shape)} too large for the "
                         "kernels' 32-bit cell offsets")


def _check_index(co) -> None:
    """Every material index lies in the table. Checked once per version of
    the index tensor (on the card the check waits for the device)."""
    key = (co.mat_idx.data_ptr(), co.mat_idx._version, co.table.shape[-1])
    if getattr(co, "_index_checked", None) == key:
        return
    lo, hi = (int(v) for v in torch.aminmax(co.mat_idx))
    if lo < 0 or hi >= co.table.shape[-1]:
        raise ValueError(
            f"material index {lo}..{hi} outside the table's "
            f"{co.table.shape[-1]} materials"
        )
    co._index_checked = key


def pressure_key(stem: str, with_dft: bool, point) -> str:
    """Count key of a pressure / stress launch: ``stem`` + "_point" with a
    point source + "_dft" inside the sensor window."""
    return stem + ("_point" if point is not None else "") + (
        "_dft" if with_dft else "")


def check_point(point, shape) -> None:
    """Validate a ``(linear index, value)`` point source against ``shape``."""
    if point is not None:
        index, _ = point
        if not 0 <= index < shape[0] * shape[1] * shape[2]:
            raise ValueError(f"point source index {index} outside {shape}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _ptrs(tensors) -> ctypes.Array:
    """Host array of device pointers (the kernels' pointer-list arguments)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _shape(st, co, checked: bool) -> tuple:
    """(shape, ns) of a step; validated unless ``checked`` (the caller ran
    ``check_step`` on this pair)."""
    if checked:
        return tuple(st.p.shape), co.cpml_half.shape[-1]
    return _check(st, co)


def fluid_velocity(st: FluidState, co: FluidCoeffs, s_sin: float,
                   s_cos: float, *, checked: bool = False) -> None:
    """Velocity half-step in place; ``s_sin``/``s_cos`` are sin(wt) and
    cos(wt) times the source ramp and the pressure->velocity scale;
    ``checked``: ``check_step`` validated (st, co) already."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    if st.p.device.type == "cpu":
        fluid_velocity_ref(st, co, s_sin, s_cos)
        return
    geo = fluid_launch_geometry((n1, n2, n3))
    _build.launch(
        "bb_fluid_velocity", "fluid_velocity_kernel", st.p.device,
        _ptr(st.p), _ptrs([st.vx, st.vy, st.vz]), _ptr(co.mat_idx),
        _ptr(co.table), _ptrs(st.psi_p), _ptr(co.cpml_half),
        _ptr(co.src_amp), _ptr(co.src_cph), _ptr(co.src_sph), s_sin, s_cos,
        co.dt_dx, co.table.shape[1], n1, n2, n3, ns, int(co.x_lo),
        int(co.x_hi), co.zsrc, geo.tile_y, geo.segment, *geo.grid,
    )
    launches["fluid_velocity"] += 1


# the kernels' monitor modes (csrc/fdtd_stencil.cuh kNoMonitor,
# kMonitorListed, kMonitorEvery)
MONITOR_NONE, MONITOR_LISTED, MONITOR_EVERY = 0, 1, 2


def monitor_args(monitor, st_field: torch.Tensor, geo: LaunchGeometry):
    """The C entry points' monitor arguments (start, cell, slot, out row,
    mode) of a ``Monitor`` or None, checked against the state and the
    launch geometry."""
    if monitor is None:
        return None, None, None, None, MONITOR_NONE
    monitor.check(st_field, geo)
    out = ctypes.c_void_p(monitor.out_ptr())
    if monitor.index is None:
        return None, None, None, out, MONITOR_EVERY
    return (_ptr(monitor.start), _ptr(monitor.entries[0]),
            _ptr(monitor.entries[1]), out, MONITOR_LISTED)


def fluid_pressure(st: FluidState, co: FluidCoeffs, cosw: float | None = None,
                   sinw: float | None = None, point=None,
                   monitor=None, *, checked: bool = False) -> None:
    """Pressure half-step in place; with ``point`` = (linear cell index,
    value) the point source is subtracted from that cell's new pressure;
    with ``cosw``/``sinw`` (the carrier cos/sin at this step) it also
    accumulates the DFT and the |p| peak; with ``monitor`` (an
    ``ops.fdtd_extras.Monitor``) it samples the new pressure; ``checked``
    as ``fluid_velocity``."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    check_point(point, (n1, n2, n3))
    with_dft = cosw is not None
    if st.p.device.type == "cpu":
        fluid_pressure_ref(st, co, cosw, sinw, point, monitor)
        return
    pt, sval = point if point is not None else (0, 0.0)
    geo = fluid_launch_geometry((n1, n2, n3))
    mon = monitor_args(monitor, st.p, geo)
    _build.launch(
        "bb_fluid_pressure", "fluid_pressure_kernel", st.p.device,
        _ptrs([st.vx, st.vy, st.vz]), _ptr(st.p), _ptr(st.r),
        _ptr(co.mat_idx), _ptr(co.table), _ptr(st.acc_cos), _ptr(st.acc_sin),
        _ptr(st.peak), _ptrs(st.psi_v), _ptr(co.cpml_int), co.dt_dx,
        co.inv_dx, co.half_dt, cosw if with_dft else 0.0,
        sinw if with_dft else 0.0, co.table.shape[1], n1, n2, n3, ns,
        int(co.x_lo), int(co.x_hi), int(co.viscous), int(with_dft),
        int(point is not None), pt, sval, *mon, geo.tile_y, geo.segment,
        *geo.grid,
    )
    launches[pressure_key("fluid_pressure", with_dft, point)] += 1
    if monitor is not None:
        monitor.launched()


# ---------------------------------------------------------------------------
# plain PyTorch versions (same operation order as the kernels)
# ---------------------------------------------------------------------------


def _padded(f, axis, lo, hi):
    """f zero-padded by ``lo`` cells before and ``hi`` cells after along
    ``axis`` (one copy; its shifted windows are views)."""
    pad = [0] * (2 * f.dim())
    pad[2 * (f.dim() - 1 - axis)] = lo
    pad[2 * (f.dim() - 1 - axis) + 1] = hi
    return torch.nn.functional.pad(f, pad)


def d_plus(f, axis):
    """Derivative at half point i+1/2 from integer-point samples (x 1/dx)."""
    n = f.shape[axis]
    g = _padded(f, axis, 1, 2)  # g[i + 1] = f[i]
    return _C1 * (g.narrow(axis, 2, n) - f) + _C2 * (
        g.narrow(axis, 3, n) - g.narrow(axis, 0, n)
    )


def d_minus(f, axis):
    """Derivative at integer point i from half-point samples (x 1/dx)."""
    n = f.shape[axis]
    g = _padded(f, axis, 2, 1)  # g[i + 2] = f[i]
    return _C1 * (f - g.narrow(axis, 1, n)) + _C2 * (
        g.narrow(axis, 3, n) - g.narrow(axis, 0, n)
    )


def _cpml(D, axis, prof, psi_lo, psi_hi, lo=True, hi=True):
    """Update the psi slabs in place and correct D in place (lo, then hi);
    ``lo`` / ``hi`` False leave that slab (and its psi) alone: the x slabs
    of a shard that holds no such global edge (the kernels' Geo xlo, xhi)."""
    ns = prof.shape[-1]
    shape = [1, 1, 1]
    shape[axis] = ns
    b_lo, a_lo, b_hi, a_hi = (prof[q].reshape(shape) for q in range(4))
    if lo:
        d_lo = D.narrow(axis, 0, ns)
        new_lo = b_lo * psi_lo + a_lo * d_lo
        psi_lo.copy_(new_lo)
        d_lo.copy_(d_lo + new_lo)
    if hi:
        d_hi = D.narrow(axis, D.shape[axis] - ns, ns)
        new_hi = b_hi * psi_hi + a_hi * d_hi
        psi_hi.copy_(new_hi)
        d_hi.copy_(d_hi + new_hi)
    return D


def _edges(co, axis) -> dict:
    """The slabs ``_cpml`` applies along ``axis``: x as the coefficients
    say, y and z both."""
    return dict(lo=co.x_lo, hi=co.x_hi) if axis == 0 else {}


def _gather(co, row: int) -> torch.Tensor:
    """Table row ``row`` at every voxel (the kernels' table gather)."""
    idx = co.mat_idx
    return co.table[row].index_select(0, idx.reshape(-1)).reshape(idx.shape)


def fluid_velocity_ref(st: FluidState, co: FluidCoeffs, s_sin: float,
                       s_cos: float) -> None:
    """Plain version of ``fluid_velocity_kernel`` (in place)."""
    plain_calls["fluid_velocity"] += 1
    rho_inv = _gather(co, 0)
    for axis, v in enumerate((st.vx, st.vy, st.vz)):
        d = _cpml(d_plus(st.p, axis), axis, co.cpml_half[axis],
                  st.psi_p[2 * axis], st.psi_p[2 * axis + 1],
                  **_edges(co, axis))
        v.copy_(v - co.dt_dx * rho_inv * d)
    plane = st.vz[:, :, co.zsrc]
    sval = co.src_amp * (s_sin * co.src_cph + s_cos * co.src_sph)
    plane.copy_(torch.where(co.src_amp > 0, sval, plane))


def fluid_pressure_ref(st: FluidState, co: FluidCoeffs,
                       cosw: float | None = None,
                       sinw: float | None = None, point=None,
                       monitor=None) -> None:
    """Plain version of ``fluid_pressure_kernel`` (in place); the monitor
    sample is ``ops.fdtd_extras.monitor_gather_ref`` after the step."""
    with_dft = cosw is not None
    plain_calls[pressure_key("fluid_pressure", with_dft, point)] += 1
    dv = [
        _cpml(d_minus(v, axis), axis, co.cpml_int[axis],
              st.psi_v[2 * axis], st.psi_v[2 * axis + 1], **_edges(co, axis))
        for axis, v in enumerate((st.vx, st.vy, st.vz))
    ]
    theta = dv[0] + dv[1] + dv[2]
    pi_u = _gather(co, 1)
    if co.viscous:
        c_rp, b_r = _gather(co, 3), _gather(co, 5)
        new_r = b_r * st.r - c_rp * theta * co.inv_dx
        p_new = (st.p - co.dt_dx * pi_u * theta
                 - co.half_dt * (new_r + st.r))
        st.r.copy_(new_r)
    else:
        p_new = st.p - co.dt_dx * pi_u * theta
    if point is not None:
        index, sval = point
        cell = p_new.view(-1)[index]
        cell.copy_(cell - sval)
    st.p.copy_(p_new)
    if with_dft:
        st.acc_cos.copy_(st.acc_cos + p_new * cosw)
        st.acc_sin.copy_(st.acc_sin + p_new * sinw)
        st.peak.copy_(torch.maximum(st.peak, p_new.abs()))
    if monitor is not None:
        monitor.gather_ref(st)
