"""Viscoelastic FDTD halo sweep with a volumetric (dome) drive: K leapfrog
steps a launch in independent blocks that recompute a halo, its wrapper and
plain version.

``visco_halo`` runs K steps of the visco pair (``ops.fdtd_visco_kernels``:
velocity, the volumetric scatter of ``ops.fdtd_sources``, stress) in one
launch of ``csrc/fdtd_visco_halo.cu``, with the CPML, the SLS memories, the
volumetric drive and, inside the sensor window, the carrier DFT and |p|
peak of every step. It replaces the volumetric drive of the JAX package's
Pallas kernel B8 (``build_visco_fusedK_step``,
``babelbrain_tpu/ops/fdtd_pallas.py:4905``) and B6's K = 1 form of it
(``:3666-3675``).

Launch (``csrc/fdtd_visco_halo.cu``): blocks of (z-tile, y-tile,
x-segment), each computing its tile and segment extended by ``3K`` cells
(``CONTAMINATION`` a step) on every side, one thread a column, and writing
only the cells it owns; no grid barrier, so no bound on K or on the plane
size from what the card holds at once (``visco_halo_launch_geometry``;
``march`` models a block's schedule for the CPU tests). Within a block
step s's velocity runs ``LAG`` planes behind step s - 1's, its stress
``STRESS_LAG`` planes behind its velocity. The kernel reads the state and
writes a second copy of it; the steps in between go through scratch copies
of the state. The wrapper keeps the twin and the scratch in a pool per
shape and device, swaps the twin's tensors into the caller's
``ViscoState`` after each launch, and ``release`` frees the pool at the end
of a run. The DFT sums and the peak are updated in place. Whole grids only
(``co.x_lo`` and ``co.x_hi``): sharded shear runs with a volumetric drive
keep pair + scatter (``ops.fdtd``).

The wrapper dispatches on the device of the state as the pair's do: a CPU
state runs the plain version (``visco_halo_ref``: K steps of the pair's
plain versions and the scatter's, in place, which is what the kernel must
equal bit for bit), a CUDA state launches the kernel on that device and
its current stream (or raises); a tensor on another device is refused.
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
version, keyed ``visco_halo_volume[_dft]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fdtd_fused_kernels import check_rows
from .fdtd_halo_kernels import HaloGeometry, check_tile, halo_launch_geometry
from .fdtd_kernels import _ptr, _ptrs
from .fdtd_sources import VolumeSource, velocity_volume_source_ref
from .fdtd_sources import _check as _check_source
from .fdtd_visco_kernels import (
    MEMORIES,
    STRESSES,
    ViscoCoeffs,
    ViscoState,
    _shape,
    visco_stress_ref,
    visco_velocity_ref,
)

# steps a launch takes at most (csrc/fdtd_visco_halo.cu kMaxSteps; one
# translation unit a depth, ops/_build.py VISCO_HALO_DEPTHS)
VISCO_HALO_K_CAP = 2
# cells a step widens what a block's cut edge contaminates (the halo is 3K
# a side); planes between step s's and s + 1's velocity planes (kLag); and
# planes a step's stress trails its velocity (kStressLag)
CONTAMINATION = 3
LAG = 4
STRESS_LAG = 2
# planes a shared-memory ring holds (csrc kRing)
RING = 4
# (TZ, TY) owned by a block at each depth (csrc ViscoHaloTile<K>)
VISCO_HALO_TILES = {1: (32, 8), 2: (16, 8)}
# the depth run_fdtd(fuse_steps=None) takes for a volumetric drive in shear
# media (ops/fdtd.py visco_volume_plan): the K whose sweeps measured
# fastest on an H100 at the dome's 392x392x337 grid, 0 where none beat
# pair + scatter. None does: K = 1 10.1173, K = 2 20.9857 ms a step against
# 4.6797 (PERF.md), so the default keeps pair + scatter.
VISCO_VOLUME_FUSE_BEST = 0
# the fields of a stage's state, in the kernel's order (then psi_s, psi_v)
FIELDS = ("vx", "vy", "vz") + STRESSES + MEMORIES

_KEYS = ("visco_halo_volume", "visco_halo_volume_dft")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)


def halo_key(with_dft: bool) -> str:
    """Count key of a launch: ``visco_halo_volume`` + "_dft"."""
    return "visco_halo_volume" + ("_dft" if with_dft else "")


def visco_halo_launch_geometry(shape, k: int) -> HaloGeometry:
    """The launch of K steps on an (N1, N2, N3) grid: ``VISCO_HALO_TILES[K]``
    tiles over (z, y), a halo of 3K, and x-segments as the fluid halo
    sweep's (``ops.fdtd_halo_kernels.halo_launch_geometry``). Refuses K
    outside 1..``VISCO_HALO_K_CAP`` and grids of 2^31 cells or more."""
    return halo_launch_geometry(shape, k, VISCO_HALO_TILES, "visco_halo")


def march(n_planes: int, k: int):
    """A block's march over planes [0, n_planes) (its marched planes, from
    the bottom of the grid), as ``visco_halo_kernel`` runs it: per march
    step f, its events in program order: ("w", ring, step, plane) a store
    into step ``step``'s shared-memory ring (its velocity's input "sxy",
    "sxz", "syy", "syz", "szz", its velocities "vx", "vy", "vz") at slot
    plane % ``RING``; ("r", ring, step, plane) a load of the neighbours'
    values there; ("push", window, step, plane) a plane entering one of the
    step's x-windows (registers: "sxx", "sxy", "sxz" for its velocity, "vx",
    "vy", "vz" for its stress); ("xwin", window, step, planes) the planes
    read from a window; ("own", step, plane, "v" | "s") the cell's own old
    velocities or stresses and memories, from the step's input state in
    device memory (the input, or the scratch the step before wrote); ("V",
    step, plane) / ("S", step, plane) a step's velocity or stress of a
    plane."""
    stress_rings = ("sxy", "sxz", "syy", "syz", "szz")
    velocity_rings = ("vx", "vy", "vz")

    def take_stress(s, pl):
        return ([("push", w, s, pl) for w in ("sxx", "sxy", "sxz")]
                + [("w", r, s, pl) for r in stress_rings])

    out = []
    for f in range(n_planes + LAG * k):
        ev = take_stress(0, f)
        for s in range(k):
            a = f - 2 - LAG * s
            b = a - STRESS_LAG
            if 0 <= a < n_planes:
                ev += [("xwin", "sxx", s, (a - 1, a, a + 1, a + 2)),
                       ("xwin", "sxy", s, (a - 2, a - 1, a, a + 1)),
                       ("xwin", "sxz", s, (a - 2, a - 1, a, a + 1))]
                ev += [("r", r, s, a) for r in stress_rings]
                ev += [("own", s, a, "v"), ("V", s, a)]
            ev += [("w", r, s, a) for r in velocity_rings]
            ev += [("push", w, s, a) for w in velocity_rings]
            if 0 <= b < n_planes:
                ev += [("xwin", "vx", s, (b - 2, b - 1, b, b + 1)),
                       ("xwin", "vy", s, (b - 1, b, b + 1, b + 2)),
                       ("xwin", "vz", s, (b - 1, b, b + 1, b + 2))]
                ev += [("r", r, s, b) for r in velocity_rings]
                ev += [("own", s, b, "s"), ("S", s, b)]
            if s + 1 < k:
                ev += take_stress(s + 1, b)
        out.append(ev)
    return out


# the twin state and the scratch states of the runs in flight, by (shape,
# ns, device): freed by release()
_POOL: dict = {}


def _blank(st: ViscoState) -> ViscoState:
    """A state shaped as ``st`` with the fields and psi slabs the kernel
    writes (no DFT sums or peak), uninitialised."""
    return ViscoState(**{n: torch.empty_like(getattr(st, n)) for n in FIELDS},
                      acc_cos=None, acc_sin=None, peak=None,
                      psi_s=[torch.empty_like(t) for t in st.psi_s],
                      psi_v=[torch.empty_like(t) for t in st.psi_v])


def _twin(st: ViscoState, k: int):
    """(twin, scratch): a second state for the launch's output and K - 1
    scratch states for the steps in between, from the pool."""
    key = (tuple(st.vx.shape), st.psi_s[2].shape[1], str(st.vx.device))
    twin, scratch = _POOL.get(key, (None, []))
    if twin is None:
        twin = _blank(st)
    while len(scratch) < k - 1:
        scratch.append(_blank(st))
    _POOL[key] = (twin, scratch)
    return twin, scratch


def release() -> None:
    """Free the twins and scratch states of the pool (the end of a run)."""
    _POOL.clear()


def _swap(st: ViscoState, twin: ViscoState, co: ViscoCoeffs) -> None:
    """Move the launch's output (the twin's tensors) into ``st`` and the
    input into the twin: the fields the kernel wrote (the memories only
    when viscous) and every psi slab (a whole grid applies them all)."""
    for n in FIELDS if co.viscous else FIELDS[:9]:
        a = getattr(st, n)
        setattr(st, n, getattr(twin, n))
        setattr(twin, n, a)
    st.psi_s, twin.psi_s = twin.psi_s, st.psi_s
    st.psi_v, twin.psi_v = twin.psi_v, st.psi_v


def _check_state(st: ViscoState, co: ViscoCoeffs) -> None:
    """The kernel reads one copy of the state and writes another of a whole
    grid: refuse a state whose fields share storage, and a shard's
    coefficients."""
    vols = st.fields(FIELDS + ("acc_cos", "acc_sin", "peak")) + st.psi_s \
        + st.psi_v
    ptrs = [t.data_ptr() for t in vols]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("visco_halo: fields of the state alias each other")
    if not (co.x_lo and co.x_hi):
        raise ValueError("visco_halo: whole grids only (a shard's x-CPML "
                         "flags given)")


def visco_halo(st: ViscoState, co: ViscoCoeffs, rows, vsrc: VolumeSource,
               *, with_dft: bool = False, checked: bool = False) -> None:
    """K = len(rows) visco steps: each row (s_sin, s_cos, cosw, sinw, ...)
    of ``ops.fdtd.step_scalars`` is one step (velocity, the volumetric
    drive ``vsrc``, stress); with ``with_dft`` each step accumulates the
    DFT at its cosw, sinw and the |p| peak. The result is in ``st`` (on a
    card its field tensors are swapped with the wrapper's twin).
    ``checked``: ``check_step`` validated (st, co) already."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    k = check_rows(rows, VISCO_HALO_K_CAP, "visco_halo")
    _check_state(st, co)
    _check_source(st.vx, st.vy, st.vz, vsrc)
    if st.vx.device.type == "cpu":
        visco_halo_ref(st, co, rows, vsrc, with_dft=with_dft)
        return
    geo = visco_halo_launch_geometry((n1, n2, n3), k)
    check_tile(k, VISCO_HALO_TILES, "visco_halo")
    twin, scratch = _twin(st, k)
    stages = [st] + scratch[:k - 1] + [twin]
    flat = (ctypes.c_float * (4 * k))(*(float(v) for r in rows
                                        for v in r[:4]))
    _build.launch(
        f"bb_visco_halo_k{k}", "visco_halo_kernel", st.vx.device,
        _ptrs([t for s in stages
               for t in s.fields(FIELDS) + s.psi_s + s.psi_v]),
        _ptr(co.mat_idx), _ptr(co.table), _ptr(st.acc_cos), _ptr(st.acc_sin),
        _ptr(st.peak), _ptr(co.cpml_half), _ptr(co.cpml_int),
        _ptr(co.src_amp), _ptr(co.src_cph), _ptr(co.src_sph),
        _ptr(vsrc.slot_volume((n1, n2, n3))),
        _ptrs([vsrc.amp, vsrc.cph, vsrc.sph, vsrc.ox, vsrc.oy, vsrc.oz]),
        flat, k, co.dt_dx, co.inv_dx, co.half_dt, co.table.shape[1], n1, n2,
        n3, ns, co.zsrc, int(co.viscous), int(with_dft), geo.segment,
        *geo.grid,
    )
    _swap(st, twin, co)
    launches[halo_key(with_dft)] += 1


def visco_halo_ref(st: ViscoState, co: ViscoCoeffs, rows,
                   vsrc: VolumeSource, *, with_dft: bool = False) -> None:
    """Plain version of ``visco_halo_kernel``: the K steps through the
    pair's and the scatter's plain versions, in place."""
    check_rows(rows, VISCO_HALO_K_CAP, "visco_halo")
    plain_calls[halo_key(with_dft)] += 1
    for s_sin, s_cos, cosw, sinw, *_ in rows:
        visco_velocity_ref(st, co, s_sin, s_cos)
        velocity_volume_source_ref(st.vx, st.vy, st.vz, vsrc, s_sin, s_cos)
        if with_dft:
            visco_stress_ref(st, co, cosw, sinw)
        else:
            visco_stress_ref(st, co)
