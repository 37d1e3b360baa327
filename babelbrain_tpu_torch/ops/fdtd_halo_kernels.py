"""Fluid FDTD halo sweep: K leapfrog steps a launch in independent blocks
that recompute a halo, its wrapper and plain version.

``fluid_halo`` runs K steps of the fluid pair (``ops.fdtd_kernels``:
velocity, the volumetric scatter of ``ops.fdtd_sources``, pressure) in one
launch of ``csrc/fdtd_fluid_halo.cu``, with the CPML, the SLS memory, a
plane or a volumetric (dome) drive and, inside the sensor window, the
carrier DFT and |p| peak of every step. It replaces the volumetric drive of
the JAX package's Pallas kernel B4 (``build_fluid_fusedK_step``,
``babelbrain_tpu/ops/fdtd_pallas.py:1815``) and the volume branch of its
sharded driver (``:2677-2690``).

Launch (``csrc/fdtd_fluid_halo.cu``): blocks of (z-tile, y-tile,
x-segment), each computing its tile and segment extended by ``3K`` cells
(``CONTAMINATION`` a step) on every side, one thread a column, and writing
only the cells it owns; no grid barrier, so no bound on K or on the plane
size from what the card holds at once (``halo_launch_geometry``; ``march``
models a block's schedule for the CPU tests). The kernel reads the state
and writes a second copy of it: the wrapper keeps that twin (and the
scratch copies of the CPML slabs the steps in between write) in a pool per
shape and device, swaps the twin's tensors into the caller's
``FluidState`` after each launch, and ``release`` frees the pool at the
end of a run. The DFT sums and the peak are updated in place.

The wrapper dispatches on the device of the state as the pair's do: a CPU
state runs the plain version (``fluid_halo_ref``: K steps of the pair's
plain versions and the scatter's, in place, which is what the kernel must
equal bit for bit), a CUDA state launches the kernel on that device and
its current stream (or raises); a tensor on another device is refused.
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
version, keyed ``fluid_halo[_volume][_dft]``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .fdtd_fused_kernels import check_rows
from .fdtd_kernels import (
    FluidCoeffs,
    FluidState,
    _cdiv,
    _check_size,
    _ptr,
    _ptrs,
    _shape,
    fluid_pressure_ref,
    fluid_velocity_ref,
)
from .fdtd_sources import VolumeSource, velocity_volume_source_ref
from .fdtd_sources import _check as _check_source

# steps a launch takes at most (csrc/fdtd_fluid_halo.cu kMaxSteps; one
# translation unit a depth, ops/_build.py HALO_DEPTHS)
HALO_K_CAP = 3
# cells a step widens what a block's cut edge contaminates: d_plus reads
# -1..+2, d_minus -2..+1 (the halo is 3K a side)
CONTAMINATION = 3
# planes a shared-memory ring holds (csrc kRing)
RING = 4
# (TZ, TY) owned by a block at each depth (csrc HaloTile<K>): one thread a
# column of the tile extended by 3K a side, at most 1024 threads
HALO_TILES = {1: (32, 16), 2: (32, 8), 3: (16, 8)}
# the depth run_fdtd(fuse_steps=None) takes for a volumetric drive
# (ops/fdtd.py volume_plan): the K whose sweeps measured fastest on an H100
# at the dome's 392x392x337 grid, 0 where none beat pair + scatter. None
# does: K = 1 2.5252, K = 2 3.2928, K = 3 7.2230 ms a step against 1.5079
# (PERF.md), so the default keeps pair + scatter.
VOLUME_FUSE_BEST = 0
# blocks a launch aims at (one resident on each of an H100's 132 SMs,
# several waves): halo_launch_geometry cuts x into segments until the grid
# has about as many
HALO_BLOCKS = 1024

_KEYS = ("fluid_halo", "fluid_halo_dft", "fluid_halo_volume",
         "fluid_halo_volume_dft")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)


def halo_key(volume: bool, with_dft: bool) -> str:
    """Count key of a launch: ``fluid_halo`` + "_volume" + "_dft"."""
    return "fluid_halo" + ("_volume" if volume else "") + (
        "_dft" if with_dft else "")


@dataclass(frozen=True)
class HaloGeometry:
    """A K-step launch: ``tile`` = (TZ, TY) owned columns a block,
    ``halo`` = 3K cells a side, ``segment`` owned x-planes a block, ``grid``
    the blocks along (z, y, x)."""

    tile: tuple
    halo: int
    segment: int
    grid: tuple

    @property
    def threads(self) -> int:
        """Threads a block: one per column of the extended tile."""
        tz, ty = self.tile
        return (tz + 2 * self.halo) * (ty + 2 * self.halo)

    def computed(self, shape) -> float:
        """Cell-updates a launch computes per cell it owns, a step (its
        extended tiles and segments, clipped to the grid, over the grid)."""
        n1, n2, n3 = shape
        tz, ty = self.tile
        h, seg = self.halo, self.segment
        gz, gy, gx = self.grid

        def span(n, tile, blocks):
            return sum(min(n, (b + 1) * tile + h) - max(0, b * tile - h)
                       for b in range(blocks))

        return (span(n1, seg, gx) * span(n2, ty, gy) * span(n3, tz, gz)
                / float(n1 * n2 * n3))


def halo_launch_geometry(shape, k: int, tiles=None,
                         name: str = "fluid_halo") -> HaloGeometry:
    """The launch of K steps on an (N1, N2, N3) grid: ``tiles[K]`` (by
    default ``HALO_TILES``) over (z, y) and the x-segment length that gives
    about ``HALO_BLOCKS`` blocks. Refuses K outside the depths ``tiles``
    has (1..``HALO_K_CAP``) and grids of 2^31 cells or more (the kernels'
    32-bit offsets)."""
    tiles = HALO_TILES if tiles is None else tiles
    if isinstance(k, bool) or int(k) != k or int(k) not in tiles:
        raise ValueError(f"{name}: {k} steps a launch, 1..{max(tiles)} "
                         "taken")
    _check_size(shape, name)
    n1, n2, n3 = (int(n) for n in shape)
    tz, ty = tiles[int(k)]
    gz, gy = _cdiv(n3, tz), _cdiv(n2, ty)
    seg = max(1, min(n1, _cdiv(n1 * gz * gy, HALO_BLOCKS)))
    seg = _cdiv(n1, _cdiv(n1, seg))  # the shortest for that many segments
    return HaloGeometry((tz, ty), CONTAMINATION * int(k), seg,
                        (gz, gy, _cdiv(n1, seg)))


def march(n_planes: int, k: int):
    """A block's march over planes [0, n_planes) (its marched planes, from
    the bottom of the grid), as ``fluid_halo_kernel`` runs it: per march
    step f, its events in program order: ("w", ring, step, plane) a store
    into step ``step``'s shared-memory ring ("p": its input pressure, "vy",
    "vz": its velocities) at slot plane % ``RING``; ("r", ring, step,
    plane, "lateral" | "own") a load of a neighbour's or the own column's
    value there; ("V", step, plane) / ("P", step, plane) a step's velocity
    or pressure of a plane, with ("xwin", "p" | "vx", step, planes) the
    x-window (registers) it reads and ("r_in", step, plane) the SLS memory
    of the previous step it takes from the register ring."""
    out = []
    for f in range(n_planes + CONTAMINATION * k):
        ev = [("w", "p", 0, f)]
        for s in range(k):
            a = f - 2 - CONTAMINATION * s
            b = a - 1
            if 0 <= a < n_planes:
                ev.append(("xwin", "p", s, (a - 1, a, a + 1, a + 2)))
                ev.append(("r", "p", s, a, "lateral"))
                if s:
                    ev.append(("xwin", "vx", s - 1, (a,)))
                    ev += [("r", r, s - 1, a, "own") for r in ("vy", "vz")]
                ev.append(("V", s, a))
            ev += [("w", r, s, a) for r in ("vy", "vz")]
            if 0 <= b < n_planes:
                ev.append(("xwin", "vx", s, (b - 2, b - 1, b, b + 1)))
                ev += [("r", r, s, b, "lateral") for r in ("vy", "vz")]
                ev.append(("r_in", s, b))
                ev.append(("P", s, b))
            if s + 1 < k:
                ev.append(("w", "p", s + 1, b))
        out.append(ev)
    return out


# the twin states and psi scratch of the runs in flight, by (shape, ns,
# device): freed by release()
_POOL: dict = {}


def _twin(st: FluidState, k: int):
    """(twin, scratch): a second set of the fields the kernel writes (p,
    vx, vy, vz, r and the 12 psi slabs) and K - 1 sets of psi slabs for the
    steps in between, shaped as ``st``'s, from the pool."""
    key = (tuple(st.p.shape), st.psi_p[2].shape[1], str(st.p.device))
    twin, scratch = _POOL.get(key, (None, []))
    if twin is None:
        twin = FluidState(
            **{n: torch.empty_like(getattr(st, n))
               for n in ("p", "vx", "vy", "vz", "r")},
            acc_cos=None, acc_sin=None, peak=None,
            psi_p=[torch.empty_like(t) for t in st.psi_p],
            psi_v=[torch.empty_like(t) for t in st.psi_v])
    while len(scratch) < k - 1:
        scratch.append([torch.empty_like(t) for t in st.psi_p + st.psi_v])
    _POOL[key] = (twin, scratch)
    return twin, scratch


def release() -> None:
    """Free the twins and scratch slabs of the pool (the end of a run)."""
    _POOL.clear()


def _swap(st: FluidState, twin: FluidState, co: FluidCoeffs) -> None:
    """Move the launch's output (the twin's tensors) into ``st`` and the
    input into the twin: the fields the kernel wrote (r only when viscous;
    the x psi slabs only where the launch applies them)."""
    names = ("p", "vx", "vy", "vz") + (("r",) if co.viscous else ())
    for n in names:
        a = getattr(st, n)
        setattr(st, n, getattr(twin, n))
        setattr(twin, n, a)
    keep = (co.x_lo, co.x_hi, True, True, True, True)
    for lst, tw in ((st.psi_p, twin.psi_p), (st.psi_v, twin.psi_v)):
        for q in range(6):
            if keep[q]:
                lst[q], tw[q] = tw[q], lst[q]


def _check_state(st: FluidState) -> None:
    """The kernel reads one copy of the state and writes another: refuse a
    state whose fields share storage."""
    vols = [st.p, st.vx, st.vy, st.vz, st.r, st.acc_cos, st.acc_sin,
            st.peak] + st.psi_p + st.psi_v
    ptrs = [t.data_ptr() for t in vols]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("fluid_halo: fields of the state alias each other")


def fluid_halo(st: FluidState, co: FluidCoeffs, rows,
               vsrc: VolumeSource | None = None, *, with_dft: bool = False,
               checked: bool = False) -> None:
    """K = len(rows) fluid steps: each row (s_sin, s_cos, cosw, sinw, ...)
    of ``ops.fdtd.step_scalars`` is one step (velocity, the volumetric
    drive ``vsrc`` if given, pressure); with ``with_dft`` each step
    accumulates the DFT at its cosw, sinw and the |p| peak. The result is
    in ``st`` (on a card its field tensors are swapped with the wrapper's
    twin). ``checked``: ``check_step`` validated (st, co) already."""
    (n1, n2, n3), ns = _shape(st, co, checked)
    k = check_rows(rows, HALO_K_CAP, "fluid_halo")
    _check_state(st)
    if vsrc is not None:
        _check_source(st.vx, st.vy, st.vz, vsrc)
    if st.p.device.type == "cpu":
        fluid_halo_ref(st, co, rows, vsrc, with_dft=with_dft)
        return
    geo = halo_launch_geometry((n1, n2, n3), k)
    check_tile(k)
    twin, scratch = _twin(st, k)
    stages = ([st.psi_p + st.psi_v] + scratch[:k - 1]
              + [twin.psi_p + twin.psi_v])
    flat = (ctypes.c_float * (4 * k))(*(float(v) for r in rows
                                        for v in r[:4]))
    if vsrc is not None:
        slot = _ptr(vsrc.slot_volume((n1, n2, n3)))
        src6 = _ptrs([vsrc.amp, vsrc.cph, vsrc.sph, vsrc.ox, vsrc.oy,
                      vsrc.oz])
    else:
        slot, src6 = None, None
    _build.launch(
        f"bb_fluid_halo_k{k}", "fluid_halo_kernel", st.p.device,
        *(_ptr(getattr(st, n)) for n in ("p", "vx", "vy", "vz", "r")),
        *(_ptr(getattr(twin, n)) for n in ("p", "vx", "vy", "vz", "r")),
        _ptr(co.mat_idx), _ptr(co.table), _ptr(st.acc_cos),
        _ptr(st.acc_sin), _ptr(st.peak), _ptrs([t for s in stages for t in s]),
        _ptr(co.cpml_half), _ptr(co.cpml_int), _ptr(co.src_amp),
        _ptr(co.src_cph), _ptr(co.src_sph), slot, src6, flat, k, co.dt_dx,
        co.inv_dx, co.half_dt, co.table.shape[1], n1, n2, n3, ns,
        int(co.x_lo), int(co.x_hi), co.zsrc, int(co.viscous), int(with_dft),
        geo.segment, *geo.grid,
    )
    _swap(st, twin, co)
    launches[halo_key(vsrc is not None, with_dft)] += 1


# (TZ, TY) of each halo sweep's tile at each depth as the built library
# reports it, by (entry point stem, K)
_KERNEL_TILES: dict = {}


def check_tile(k: int, tiles=None, stem: str = "fluid_halo") -> None:
    """Refuse a K-step launch whose geometry's tile (``tiles[K]``, by
    default ``HALO_TILES``) is not the built kernel's, which the library
    reports through ``bb_<stem>_tile_k<K>``."""
    tiles = HALO_TILES if tiles is None else tiles
    if (stem, k) not in _KERNEL_TILES:
        tz, ty = ctypes.c_int(0), ctypes.c_int(0)
        rc = getattr(_build.library(), f"bb_{stem}_tile_k{k}")(
            ctypes.byref(tz), ctypes.byref(ty))
        _build.check(rc, f"{stem}_kernel tile")
        _KERNEL_TILES[(stem, k)] = (tz.value, ty.value)
    if _KERNEL_TILES[(stem, k)] != tiles[k]:
        raise RuntimeError(
            f"{stem}: the kernel's (TZ, TY) at K = {k} is "
            f"{_KERNEL_TILES[(stem, k)]}, its launch geometry's {tiles[k]}")


def fluid_halo_ref(st: FluidState, co: FluidCoeffs, rows,
                   vsrc: VolumeSource | None = None, *,
                   with_dft: bool = False) -> None:
    """Plain version of ``fluid_halo_kernel``: the K steps through the
    pair's and the scatter's plain versions, in place."""
    check_rows(rows, HALO_K_CAP, "fluid_halo")
    plain_calls[halo_key(vsrc is not None, with_dft)] += 1
    for s_sin, s_cos, cosw, sinw, *_ in rows:
        fluid_velocity_ref(st, co, s_sin, s_cos)
        if vsrc is not None:
            velocity_volume_source_ref(st.vx, st.vy, st.vz, vsrc, s_sin,
                                       s_cos)
        if with_dft:
            fluid_pressure_ref(st, co, cosw, sinw)
        else:
            fluid_pressure_ref(st, co)
