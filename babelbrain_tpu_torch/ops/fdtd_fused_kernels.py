"""Fluid FDTD fused sweep: K leapfrog steps in one launch, its wrapper and
plain version.

``fluid_fused`` runs K steps of the fluid pair (``ops.fdtd_kernels``:
velocity, then pressure) in one launch of ``csrc/fdtd_fluid_fused.cu``, with
the CPML, the SLS memory, the plane or point source, and, inside the sensor
window, the carrier DFT and |p| peak of every step. It replaces the JAX
package's Pallas kernels B2 (``build_fluid_fused_step``, K = 1), B3
(``build_fluid_fused2_step``, K = 2) and B4 (``build_fluid_fusedK_step``,
K >= 3) of ``babelbrain_tpu/ops/fdtd_pallas.py``, without their volumetric
drive (the halo sweep, ``ops.fdtd_halo_kernels``). With ``extras`` /
``monitor`` (the EXTRAS instantiations: inside the window, whole grids)
each step also adds p^2 to the ``Pressure_rms`` accumulator of an
``ops.fdtd_extras.Extras`` (B4's ``with_p2``) and writes the new pressure
at the listed voxels into its row of the series (the monitor capture of
B4's driver, at every sampled step: ``ops.fdtd_extras.SweepMonitor``).

Launch (``csrc/fdtd_fluid_fused.cu``): a cooperative grid of blocks
(z-tile, y-tile, stage) of 32x8 threads, each thread ``CELLS`` cells
``TILE_Y`` rows apart (a tile of ``TILE_Z`` x ``ROWS`` columns), every block
resident at once; stage s marches ``LAG`` planes behind stage s - 1, its
pressure ``PLAG`` planes behind its velocity, with a grid-wide barrier after
each march step; each step's loads are issued a step ahead (``PREFETCH``)
into a shared-memory double buffer (``march`` mirrors the schedule, the
staged loads included; ``SMEM_BYTES`` a block). So K is bounded by how many
blocks the card holds at once: ``admitted_depth`` is the deepest K that
fits, and ``ops.fdtd.fused_plan`` caps it at ``FUSE_BEST``, the depth the
card measured fastest.

The wrapper dispatches on the device of the state as the pair's do: a CPU
state runs the plain version (``fluid_fused_ref``: K steps of the pair's
plain versions, with the maps' pass and the monitor gather after each step
of an extras sweep, which is what the kernel must equal bit for bit), a CUDA
state launches the kernel on that device and its current stream (or
raises); a tensor on another device is refused. ``launches`` counts kernel
launches, ``plain_calls`` calls of the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fdtd_extras import extras_accumulate_ref, monitor_gather_ref
from .fdtd_kernels import (
    TILE_Y,
    TILE_Z,
    FluidCoeffs,
    FluidState,
    LaunchGeometry,
    _cdiv,
    _ptr,
    _ptrs,
    _shape,
    fluid_pressure_ref,
    fluid_velocity_ref,
    pressure_key,
    whole_y,
)

# steps a launch takes at most (csrc/fdtd_fluid_fused.cu kMaxSteps)
K_CAP = 8
# planes between stage s's and stage s + 1's velocity planes (kLag), the
# planes a stage's pressure runs behind its velocity (kPLag), the march
# steps a stage loads its x-window before its first plane (kLead) and how
# many march steps ahead a load is issued (the double buffer's depth)
LAG = 6
PLAG = 2
LEAD = 2
PREFETCH = 1
# a thread's cells (kCells), TILE_Y rows apart: a block's tile is TILE_Z x
# ROWS columns
CELLS = 2
ROWS = TILE_Y * CELLS
# the kernel's dynamic shared memory a block (kSmem): two mbarriers, two
# ring buffers of whole 16-byte chunks along z (p: ROWS + 3 rows x TILE_Z + 8
# columns, vy: ROWS + 3 x TILE_Z, vz: ROWS x TILE_Z + 8) and one set of 17
# staged values a cell
SLOTS = 17
RING = ((ROWS + 3) * (TILE_Z + 8) + (ROWS + 3) * TILE_Z
        + ROWS * (TILE_Z + 8))
SMEM_BYTES = 16 + 4 * (2 * RING + SLOTS * CELLS * TILE_Y * TILE_Z)
# the depth fuse_steps=None takes at most: the fastest K >= 2 a step
# measured on an H100 against the pair, quiet and window, at 192x192x240 and
# at the CT slice's 216x216x224 (K = 1..4, the depths the card holds there);
# 0: no K was faster, so such runs keep the pair for every step (PERF.md)
FUSE_BEST = 0
# the window depth an unsharded run with Pressure_rms / Pressure_peak maps
# and / or monitors takes with fuse_steps=None (ops.fdtd.extras_plan): the
# fastest K a step of the extras sweep measured on an H100 at the CT slice's
# 216x216x224 against pair + extras + MONITOR; 0: no K was faster, so such
# runs keep the pair for every step (PERF.md)
EXTRAS_FUSE_BEST = 0
# planes a step of the stencil widens what the array's edge contaminates:
# d_plus reads -1..+2, d_minus -2..+1 (the overlap-and-discard halo, per step)
CONTAMINATION = 3

_KEYS = ("fluid_fused", "fluid_fused_dft", "fluid_fused_point",
         "fluid_fused_point_dft", "fluid_fused_extras_dft",
         "fluid_fused_point_extras_dft")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)


def fused_launch_geometry(shape, k: int, rows: int = ROWS) -> LaunchGeometry:
    """The launch of K steps on an (N1, N2, N3) grid: blocks of TILE_Z x
    ``rows`` columns (the fluid sweep's ROWS; the visco sweep's TILE_Y)
    over (z-tiles, y-tiles, K stages), each marching all N1 planes."""
    n1, n2, n3 = shape
    return LaunchGeometry(rows, n1, (_cdiv(n3, TILE_Z), _cdiv(n2, rows),
                                     int(k)))


def march_steps(n1: int, k: int) -> int:
    """March steps of a launch of K steps over N1 planes."""
    return n1 + LEAD + PLAG + LAG * (k - 1)


def march(n1: int, k: int):
    """The kernel's march: for each march step t (from -``PREFETCH``: the
    loads issued before the first step), the (stage, velocity plane,
    pressure plane, loads) of each stage, the planes None where it updates
    none, ``loads`` the (field, plane, role) it issues at step t for step
    t + ``PREFETCH``, as ``fluid_fused_kernel`` computes them: "p" is p's
    family (p, r, the DFT sums, the p^2 sum, the pressure's psi), "v" the
    velocities' (vx, vy, vz, the velocity's psi); role "ring" is the (y,
    z) ring around the block's tile, "own" a cell's own values, "window"
    the newest p of its x-window (plane i + 2)."""
    n_march = march_steps(n1, k)
    out = []
    for t in range(-PREFETCH, n_march):
        row = []
        for s in range(k):
            i = t - LEAD - LAG * s
            ip = i - PLAG
            loads = []
            t1 = t + PREFETCH
            if 0 <= t1 < n_march:
                i1 = t1 - LEAD - LAG * s
                ip1 = i1 - PLAG
                if 0 <= i1 < n1:
                    loads += [("p", i1, "ring"), ("v", i1, "own")]
                if -LEAD <= i1 < n1 + PLAG and 0 <= i1 + 2 < n1:
                    loads.append(("p", i1 + 2, "window"))
                if 0 <= ip1 < n1:
                    loads += [("v", ip1, "ring"), ("p", ip1, "own")]
            live = t >= 0
            row.append((s, i if live and 0 <= i < n1 else None,
                        ip if live and 0 <= ip < n1 else None, tuple(loads)))
        out.append((t, row))
    return out


def check_tile(device) -> None:
    """Raise unless the kernel was compiled with this module's tile (TILE_Z,
    TILE_Y, ROWS, SMEM_BYTES), before a device's first launch."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index in _TILE_CHECKED:
        return
    out = [ctypes.c_int(0) for _ in range(4)]
    _build.check(_build.library().bb_fluid_fused_tile(
        *(ctypes.byref(o) for o in out)), "fluid_fused_kernel tile")
    got = tuple(o.value for o in out)
    if got != (TILE_Z, TILE_Y, ROWS, SMEM_BYTES):
        raise RuntimeError(
            f"fluid_fused_kernel: compiled tile (z, y, rows, smem) {got}, "
            f"ops/fdtd_fused_kernels.py expects "
            f"{(TILE_Z, TILE_Y, ROWS, SMEM_BYTES)}")
    _TILE_CHECKED.add(index)


# the devices whose build check_tile has checked
_TILE_CHECKED: set = set()
# co-resident blocks of a cooperative kernel's instantiation on a device
# (the kernel's occupancy does not change while the process runs)
_CAPACITY: dict = {}


def resident(entry: str, kernel: str, device, viscous: bool, with_dft: bool,
             point: bool, *flags: int, xalls=(1, 0)) -> int:
    """How many blocks of the (viscous, with_dft, point, xall, ``flags``)
    instantiations of a fused sweep's kernel (its capacity query ``entry``)
    the CUDA ``device`` holds at once (a cooperative launch may not exceed
    it): the fewest over ``xalls``, its whole-grid and its shards' twin."""
    dev = torch.device(device)
    key = (entry, dev.index if dev.index is not None
           else torch.cuda.current_device(), bool(viscous), bool(with_dft),
           bool(point), flags, tuple(xalls))
    if key not in _CAPACITY:
        blocks = []
        for xall in xalls:
            out = ctypes.c_int(0)
            with torch.cuda.device(key[1]):
                rc = getattr(_build.library(), entry)(
                    int(viscous), int(with_dft), int(point), xall, *flags,
                    ctypes.byref(out))
            _build.check(rc, f"{kernel} occupancy")
            blocks.append(out.value)
        _CAPACITY[key] = min(blocks)
    return _CAPACITY[key]


def capacity(device, viscous: bool, with_dft: bool, point: bool,
             extras: bool = False) -> int:
    """How many blocks of the fused kernel's instantiation the CUDA
    ``device`` holds at once (``resident``; the EXTRAS ones exist with the
    DFT on whole grids only)."""
    return resident("bb_fluid_fused_capacity", "fluid_fused_kernel", device,
                    viscous, with_dft, point, int(extras),
                    xalls=(1,) if extras else (1, 0))


def admitted_depth(shape, device, viscous: bool, with_dft: bool,
                   point: bool = False, extras: bool = False) -> int:
    """The deepest K (at most ``K_CAP``) a launch on ``shape`` may take on
    ``device``: on a CUDA device the K whose K x tiles blocks the card holds
    at once (0 when not even one stage fits); on the CPU ``K_CAP``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return K_CAP
    check_tile(dev)
    gz, gy, _ = fused_launch_geometry(shape, 1).grid
    return min(K_CAP, capacity(dev, viscous, with_dft, point, extras)
               // (gz * gy))


def check_rows(rows, k_cap: int = K_CAP, name: str = "fluid_fused") -> int:
    """K of a launch's per-step rows: 1..``k_cap`` rows of five scalars."""
    k = len(rows)
    if not 1 <= k <= k_cap:
        raise ValueError(f"{name}: {k} steps a launch, 1..{k_cap} taken")
    if any(len(r) != 5 for r in rows):
        raise ValueError(f"{name}: rows are (s_sin, s_cos, cosw, sinw, "
                         "s_point) of ops.fdtd.step_scalars")
    return k


def fused_key(with_dft: bool, point, extras: bool = False) -> str:
    """Count key of a ``fluid_fused`` launch: fluid_fused[_point][_dft], or
    fluid_fused[_point]_extras_dft for an extras sweep."""
    if extras:
        return "fluid_fused" + ("_point" if point is not None else "") + (
            "_extras_dft")
    return pressure_key("fluid_fused", with_dft, point)


def _check_extras(st: FluidState, extras, monitor, with_dft: bool,
                  co: FluidCoeffs, k: int):
    """The p^2 accumulator of ``extras`` (None without one), after checking
    that an extras sweep fits this launch: inside the window, on a whole
    grid, only a Pressure_rms accumulator held, the monitor's rows one a
    step and its tensors on the state's device."""
    if not with_dft or not (co.x_lo and co.x_hi):
        raise ValueError("fluid_fused: maps and monitors are taken inside "
                         "the sensor window (with_dft) of a whole grid")
    acc = None
    if extras is not None:
        if set(extras.acc) - {"Pressure_rms"}:
            raise ValueError(f"fluid_fused: the sweep sums p^2 only, not "
                             f"{sorted(set(extras.acc) - {'Pressure_rms'})}")
        acc = extras.acc.get("Pressure_rms")
        if acc is not None and (acc.shape != st.p.shape
                                or acc.device != st.p.device
                                or acc.dtype != torch.float32
                                or not acc.is_contiguous()):
            raise ValueError("fluid_fused: the Pressure_rms accumulator must "
                             "be a contiguous float32 tensor like p")
    if monitor is not None:
        monitor.check(st.p, k)
    return acc


def fluid_fused(st: FluidState, co: FluidCoeffs, rows, point=None, *,
                with_dft: bool = False, checked: bool = False, extras=None,
                monitor=None) -> None:
    """K = len(rows) fluid steps in place: each row (s_sin, s_cos, cosw,
    sinw, s_point) of ``ops.fdtd.step_scalars`` is one step; with ``point``
    (a linear cell index) the point source s_point is subtracted from that
    cell's new pressure; with ``with_dft`` each step accumulates the DFT at
    its cosw, sinw and the |p| peak. ``extras`` (an ``ops.fdtd_extras
    .Extras`` holding at most the Pressure_rms accumulator) and ``monitor``
    (an ``ops.fdtd_extras.SweepMonitor`` with this launch's K series rows)
    make it an extras sweep: each step adds p^2 to the accumulator and
    samples the new pressure at the listed voxels into its row (with
    ``with_dft``, on a whole grid). ``checked``: ``check_step`` validated
    (st, co) already."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    k = check_rows(rows)
    whole_y(co, "fluid_fused")
    if point is not None and not 0 <= int(point) < n1 * n2 * n3:
        raise ValueError(f"point source index {point} outside {(n1, n2, n3)}")
    with_extras = extras is not None or monitor is not None
    acc = (_check_extras(st, extras, monitor, with_dft, co, k)
           if with_extras else None)
    if st.p.device.type == "cpu":
        fluid_fused_ref(st, co, rows, point, with_dft=with_dft, extras=extras,
                        monitor=monitor)
        return
    check_tile(st.p.device)
    geo = fused_launch_geometry((n1, n2, n3), k)
    flat = (ctypes.c_float * (5 * k))(*(float(v) for r in rows for v in r))
    mon = monitor
    mon_rows = (ctypes.c_int * k)(*(mon.rows if mon is not None
                                    else [-1] * k))
    _build.launch(
        "bb_fluid_fused", "fluid_fused_kernel", st.p.device,
        _ptr(st.p), _ptrs([st.vx, st.vy, st.vz]), _ptr(st.r),
        _ptr(co.mat_idx), _ptr(co.table), _ptr(st.acc_cos), _ptr(st.acc_sin),
        _ptr(st.peak), _ptrs(st.psi_p), _ptrs(st.psi_v), _ptr(co.cpml_half),
        _ptr(co.cpml_int), _ptr(co.src_amp), _ptr(co.src_cph),
        _ptr(co.src_sph), flat, k, co.dt_dx, co.inv_dx, co.half_dt,
        co.table.shape[1], n1, n2, n3, ns, int(co.x_lo), int(co.x_hi),
        co.zsrc, int(co.viscous), int(with_dft), int(point is not None),
        int(point or 0), *geo.grid[:2], int(with_extras),
        None if acc is None else _ptr(acc),
        *((_ptr(mon.start), _ptr(mon.entries[0]), _ptr(mon.entries[1]),
           _ptr(mon.series), int(mon.series.shape[1])) if mon is not None
          else (None, None, None, None, 0)),
        mon_rows,
    )
    launches[fused_key(with_dft, point, with_extras)] += 1


def fluid_fused_ref(st: FluidState, co: FluidCoeffs, rows, point=None, *,
                    with_dft: bool = False, extras=None,
                    monitor=None) -> None:
    """Plain version of ``fluid_fused_kernel``: the K steps through the
    pair's plain versions, in place; an extras sweep feeds ``extras``'s
    accumulator (``extras_accumulate_ref``) and takes each sampled step's
    monitor sample (``monitor_gather_ref``) after each step."""
    check_rows(rows)
    with_extras = extras is not None or monitor is not None
    plain_calls[fused_key(with_dft, point, with_extras)] += 1
    for s, (s_sin, s_cos, cosw, sinw, s_pt) in enumerate(rows):
        fluid_velocity_ref(st, co, s_sin, s_cos)
        pnt = None if point is None else (int(point), s_pt)
        if with_dft:
            fluid_pressure_ref(st, co, cosw, sinw, pnt)
        else:
            fluid_pressure_ref(st, co, point=pnt)
        if extras is not None and extras.acc:
            extras_accumulate_ref(st, extras)
        if monitor is not None and monitor.rows[s] >= 0:
            monitor_gather_ref(st, monitor.index, monitor.series,
                               monitor.rows[s])
