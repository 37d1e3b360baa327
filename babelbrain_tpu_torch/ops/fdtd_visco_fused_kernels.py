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
(z-tile, y-tile, stage), 32x8 columns a block as the pair's, every block
resident at once; within a stage the stress trails the velocity by
``STRESS_LAG`` planes, and stage s marches ``LAG`` planes behind stage
s - 1, with a grid-wide barrier after each march step (``march`` mirrors
the schedule). So K is bounded by how many blocks the card holds at once:
``admitted_depth`` is the deepest K that fits, and ``ops.fdtd.visco_plan``
caps it at ``VISCO_FUSE_BEST``.

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
from .fdtd_kernels import TILE_Y, LaunchGeometry, _ptr, _ptrs, pressure_key
from .fdtd_visco_kernels import (
    MEMORIES,
    STRESSES,
    ViscoCoeffs,
    ViscoState,
    _shape,
    visco_stress_ref,
    visco_velocity_ref,
)

def fused_launch_geometry(shape, k: int) -> LaunchGeometry:
    """The launch of K steps on an (N1, N2, N3) grid: the fluid sweep's
    tiling with TILE_Y rows a block (one cell a thread)."""
    return FK.fused_launch_geometry(shape, k, rows=TILE_Y)


# steps a launch takes at most (csrc/fdtd_visco_fused.cu kMaxSteps; the
# JAX package's visco K_cap)
K_CAP = 4
# planes between stage s's and stage s + 1's velocity planes (kLag), and
# planes a stage's stress trails its velocity (kStressLag)
LAG = 5
STRESS_LAG = 2
# the depth fuse_steps=None takes at most: the fastest K >= 2 a step
# measured on an H100 at 192x192x240 of the depths the card holds there
# (K = 2, the only one; PERF.md)
VISCO_FUSE_BEST = 2
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


def march(n1: int, k: int):
    """The kernel's march: per march step t, the (stage, velocity plane,
    stress plane) each stage updates (None where it updates none), as
    ``visco_fused_kernel`` computes them."""
    out = []
    for t in range(n1 + STRESS_LAG + LAG * (k - 1)):
        row = []
        for s in range(k):
            i = t - LAG * s
            row.append((s, i if 0 <= i < n1 else None,
                        i - STRESS_LAG if 0 <= i - STRESS_LAG < n1 else None))
        out.append(row)
    return out


def capacity(device, viscous: bool, with_dft: bool, point: bool) -> int:
    """How many blocks of the fused kernel's instantiation the CUDA
    ``device`` holds at once: the fewer of its whole-grid and its shards'
    twin."""
    return resident("bb_visco_fused_capacity", "visco_fused_kernel", device,
                    viscous, with_dft, point)


def admitted_depth(shape, device, viscous: bool, with_dft: bool,
                   point: bool = False) -> int:
    """The deepest K (at most ``K_CAP``) a launch on ``shape`` may take on
    ``device``: on a CUDA device the K whose K x tiles blocks the card holds
    at once (0 when not even one stage fits); on the CPU ``K_CAP``."""
    if torch.device(device).type != "cuda":
        return K_CAP
    gz, gy, _ = fused_launch_geometry(shape, 1).grid
    return min(K_CAP, capacity(device, viscous, with_dft, point) // (gz * gy))


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
    if point is not None and not 0 <= int(point) < n1 * n2 * n3:
        raise ValueError(f"point source index {point} outside {(n1, n2, n3)}")
    if st.vx.device.type == "cpu":
        visco_fused_ref(st, co, rows, point, with_dft=with_dft)
        return
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
