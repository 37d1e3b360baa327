"""Viscoelastic FDTD fused sweep: K leapfrog steps in one launch, its wrapper
and plain version.

``visco_fused`` runs K steps of the visco pair (``ops.fdtd_visco_kernels``:
velocity, then stress) in one launch of ``csrc/fdtd_visco_fused.cu``, with
the CPML, the SLS memories, the plane or point source, and, inside the
sensor window, the carrier DFT and |p| peak of every step. It replaces the
JAX package's Pallas kernels B6 (``build_visco_fused_step``, K = 1), B7
(``build_visco_fused2_step``, K = 2) and B8 (``build_visco_fusedK_step``)
of ``babelbrain_tpu/ops/fdtd_pallas.py``, without their volumetric drive
(``ops.fdtd_visco_halo_kernels``: the dome's planes hold more blocks than
this kernel's cooperative launch may).

Launch (``csrc/fdtd_visco_fused.cu``): a cooperative grid of blocks
(z-tile, y-tile, stage) of ``TILE_Z`` x ``THREADS_Y`` threads, each thread
``CELLS`` cells ``THREADS_Y`` rows apart (a tile of ``TILE_Z`` x ``ROWS``
columns), every block resident at once; within a stage the stress trails
the velocity by ``STRESS_LAG`` planes, and stage s marches ``LAG`` planes
behind stage s - 1, with a grid-wide barrier after each march step. The
stress's y/z
differences read a shared ring of the velocities its block has just
computed (``VELOCITY_RING`` planes); every other load of a march step is
issued a step ahead (``PREFETCH``) into shared memory (``march`` mirrors
the schedule, the staged loads included; ``SMEM_BYTES`` a block). So K is
bounded by how many blocks the card holds at once: ``admitted_depth`` is
the deepest K that fits, and ``ops.fdtd.visco_plan`` caps it at
``VISCO_FUSE_BEST``.

The wrapper dispatches on the device of the state as the pair's do: a CPU
state runs the plain version (``visco_fused_ref``: K steps of the pair's
plain versions, which is what the kernel must equal bit for bit), a CUDA
state launches the kernel on that device and its current stream (or
raises); a tensor on another device is refused. ``launches`` counts kernel
launches, ``plain_calls`` calls of the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import fdtd_fused_kernels as FK
from .fdtd_fused_kernels import check_rows, resident
from .fdtd_kernels import (
    TILE_Z,
    LaunchGeometry,
    _ptr,
    _ptrs,
    pressure_key,
    whole_y,
)
from .fdtd_visco_kernels import (
    MEMORIES,
    STRESSES,
    ViscoCoeffs,
    ViscoState,
    _shape,
    visco_stress_ref,
    visco_velocity_ref,
)

# steps a launch takes at most (csrc/fdtd_visco_fused.cu kMaxSteps; the
# JAX package's visco K_cap)
K_CAP = 4
# planes between stage s's and stage s + 1's velocity planes (kLag), planes
# a stage's stress trails its velocity (kStressLag), the march steps a stage
# loads its x-windows before its first plane (kLead) and how many march
# steps ahead a load is issued (the double buffer's depth)
LAG = 6
STRESS_LAG = 2
LEAD = 2
PREFETCH = 1
# a block's threads along y (kTY) and a thread's cells (kCells), THREADS_Y
# rows apart: a block's tile is TILE_Z x ROWS columns. 12 rows: 128 tiles
# on a 192x240 plane put K = 2's 256 blocks two on nearly every SM of an
# H100 (264 slots), where 16 rows (96 tiles) put two on 60 SMs and one on
# the rest, and the barrier waits for the SMs holding twice the cells
THREADS_Y = 6
CELLS = 2
ROWS = THREADS_Y * CELLS
# planes of the block's own velocity ring (kVDepth): the stress of plane
# i - STRESS_LAG reads one while the velocity writes plane i
VELOCITY_RING = STRESS_LAG + 1
# the kernel's dynamic shared memory a block (kSmem): two mbarriers; two
# buffers of the five stress rings in whole 16-byte chunks along z (sxy,
# syy: ROWS + 3 rows x TILE_Z; syz: ROWS + 3 x TILE_Z + 8; sxz, szz: ROWS x
# TILE_Z + 8); the velocity ring (vx, vy, vz x VELOCITY_RING planes of
# ROWS + 4 rows x TILE_Z + 8); one set of SLOTS staged values a cell (23
# fields and planes, the 18 derivatives' psi values)
SLOTS = 41
STRESS_RING = (2 * (ROWS + 3) * TILE_Z + (ROWS + 3) * (TILE_Z + 8)
               + 2 * ROWS * (TILE_Z + 8))
V_RING = 3 * VELOCITY_RING * (ROWS + 4) * (TILE_Z + 8)
SMEM_BYTES = 16 + 4 * (2 * STRESS_RING + V_RING
                       + SLOTS * CELLS * THREADS_Y * TILE_Z)
# the depth fuse_steps=None takes at most: the fastest K >= 2 a step
# measured on an H100 against the visco pair, quiet and window, at
# 192x192x240 and at the label slices' 216x216x224 (K = 1, 2: the depths
# the card holds there); 0: no K was faster at both (K = 2 1.55-1.74x the
# pair), so such runs keep the pair for every step (PERF.md)
VISCO_FUSE_BEST = 0
# ghost planes a step of the overlap-and-discard halo: JAX's visco plan
# (H >= 4K, "2 per half-step"). What the array's edge contaminates reaches
# 3 planes a step, as in the fluid (the chains of fields alternate forward
# and backward differences; tests/test_torch_visco_fused.py), so 4K keeps
# one plane a step to spare
CONTAMINATION = 4

_KEYS = ("visco_fused", "visco_fused_dft", "visco_fused_point",
         "visco_fused_point_dft")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)


def fused_launch_geometry(shape, k: int) -> LaunchGeometry:
    """The launch of K steps on an (N1, N2, N3) grid: the fluid sweep's
    tiling, TILE_Z x ROWS columns a block."""
    return FK.fused_launch_geometry(shape, k, rows=ROWS)


def march_steps(n1: int, k: int) -> int:
    """March steps of a launch of K steps over N1 planes."""
    return n1 + LEAD + STRESS_LAG + LAG * (k - 1)


def march(n1: int, k: int):
    """The kernel's march: for each march step t (from -``PREFETCH``: the
    loads issued before the first step), the (stage, velocity plane, stress
    plane, loads) of each stage, the planes None where it updates none,
    ``loads`` the (field, plane, role) it issues at step t for step
    t + ``PREFETCH``, as ``visco_fused_kernel`` computes them: "s" is the
    stresses' family (sigma, r, the DFT sums, the stress's psi), "v" the
    velocities' (v, the velocity's psi); role "ring" is the (y, z) rings of
    the five stresses the velocity differentiates, around the block's tile;
    "halo" the rows and columns around the tile of the velocity ring (the
    block writes the tile's cells itself); "own" a cell's own values;
    "window" the newest planes of its x-windows (sxx of plane i + 2, sxy
    and sxz of plane i + 1)."""
    n_march = march_steps(n1, k)
    out = []
    for t in range(-PREFETCH, n_march):
        row = []
        for s in range(k):
            i = t - LEAD - LAG * s
            js = i - STRESS_LAG
            loads = []
            t1 = t + PREFETCH
            if 0 <= t1 < n_march:
                i1 = t1 - LEAD - LAG * s
                js1 = i1 - STRESS_LAG
                if 0 <= i1 < n1:
                    loads += [("s", i1, "ring"), ("v", i1, "own")]
                if -LEAD <= i1 < n1 + STRESS_LAG:
                    loads += [("s", x, "window") for x in (i1 + 2, i1 + 1)
                              if 0 <= x < n1]
                if 0 <= js1 < n1:
                    loads += [("v", js1, "halo"), ("s", js1, "own")]
            live = t >= 0
            row.append((s, i if live and 0 <= i < n1 else None,
                        js if live and 0 <= js < n1 else None, tuple(loads)))
        out.append((t, row))
    return out


def check_tile(device) -> None:
    """Raise unless the kernel was compiled with this module's tile (TILE_Z,
    THREADS_Y, ROWS, SMEM_BYTES), before a device's first launch."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index in _TILE_CHECKED:
        return
    out = [ctypes.c_int(0) for _ in range(4)]
    _build.check(_build.library().bb_visco_fused_tile(
        *(ctypes.byref(o) for o in out)), "visco_fused_kernel tile")
    got = tuple(o.value for o in out)
    if got != (TILE_Z, THREADS_Y, ROWS, SMEM_BYTES):
        raise RuntimeError(
            f"visco_fused_kernel: compiled tile (z, y, rows, smem) {got}, "
            f"ops/fdtd_visco_fused_kernels.py expects "
            f"{(TILE_Z, THREADS_Y, ROWS, SMEM_BYTES)}")
    _TILE_CHECKED.add(index)


# the devices whose build check_tile has checked
_TILE_CHECKED: set = set()


def capacity(device, viscous: bool, with_dft: bool, point: bool) -> int:
    """How many blocks of the fused kernel's instantiation the CUDA
    ``device`` holds at once: the fewer of its whole-grid and its shards'
    twin (each the fewer of its two copy widths)."""
    return resident("bb_visco_fused_capacity", "visco_fused_kernel", device,
                    viscous, with_dft, point)


def admitted_depth(shape, device, viscous: bool, with_dft: bool,
                   point: bool = False) -> int:
    """The deepest K (at most ``K_CAP``) a launch on ``shape`` may take on
    ``device``: on a CUDA device the K whose K x tiles blocks the card holds
    at once (0 when not even one stage fits); on the CPU ``K_CAP``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return K_CAP
    check_tile(dev)
    gz, gy, _ = fused_launch_geometry(shape, 1).grid
    return min(K_CAP, capacity(dev, viscous, with_dft, point) // (gz * gy))


def visco_fused(st: ViscoState, co: ViscoCoeffs, rows, point=None, *,
                with_dft: bool = False, checked: bool = False) -> None:
    """K = len(rows) visco steps in place: each row (s_sin, s_cos, cosw,
    sinw, s_point) of ``ops.fdtd.step_scalars`` is one step; with ``point``
    (a linear cell index) the point source s_point is added to that cell's
    normal stresses; with ``with_dft`` each step accumulates the DFT at its
    cosw, sinw and the |p| peak. ``checked``: ``check_step`` validated
    (st, co) already."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    k = check_rows(rows, K_CAP, "visco_fused")
    whole_y(co, "visco_fused")
    if point is not None and not 0 <= int(point) < n1 * n2 * n3:
        raise ValueError(f"point source index {point} outside {(n1, n2, n3)}")
    if st.vx.device.type == "cpu":
        visco_fused_ref(st, co, rows, point, with_dft=with_dft)
        return
    check_tile(st.vx.device)
    geo = fused_launch_geometry((n1, n2, n3), k)
    flat = (ctypes.c_float * (5 * k))(*(float(v) for r in rows for v in r))
    _build.launch(
        "bb_visco_fused", "visco_fused_kernel", st.vx.device,
        _ptrs(st.fields(("vx", "vy", "vz"))), _ptrs(st.fields(STRESSES)),
        _ptrs(st.fields(MEMORIES)), _ptr(co.mat_idx), _ptr(co.table),
        _ptr(st.acc_cos), _ptr(st.acc_sin), _ptr(st.peak), _ptrs(st.psi_s),
        _ptrs(st.psi_v), _ptr(co.cpml_half), _ptr(co.cpml_int),
        _ptr(co.src_amp), _ptr(co.src_cph), _ptr(co.src_sph), flat, k,
        co.dt_dx, co.inv_dx, co.half_dt, co.table.shape[1], n1, n2, n3, ns,
        int(co.x_lo), int(co.x_hi), co.zsrc, int(co.viscous), int(with_dft),
        int(point is not None), int(point or 0), *geo.grid[:2],
    )
    launches[pressure_key("visco_fused", with_dft, point)] += 1


def visco_fused_ref(st: ViscoState, co: ViscoCoeffs, rows, point=None, *,
                    with_dft: bool = False) -> None:
    """Plain version of ``visco_fused_kernel``: the K steps through the
    pair's plain versions, in place."""
    check_rows(rows, K_CAP, "visco_fused")
    plain_calls[pressure_key("visco_fused", with_dft, point)] += 1
    for s_sin, s_cos, cosw, sinw, s_pt in rows:
        visco_velocity_ref(st, co, s_sin, s_cos)
        pnt = None if point is None else (int(point), s_pt)
        if with_dft:
            visco_stress_ref(st, co, cosw, sinw, pnt)
        else:
            visco_stress_ref(st, co, point=pnt)
