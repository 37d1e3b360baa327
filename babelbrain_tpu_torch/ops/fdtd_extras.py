"""FDTD diagnostics: RMS / peak maps and pressure series, as CUDA kernels,
their wrappers and plain PyTorch versions.

The reference's ``SelMapsRMSPeakList`` / ``SelRMSorPeak`` maps and its
``SensorOutput`` / ``SensorSubSampling`` series
(``babelbrain_tpu/ops/fdtd.py`` ``_update_extras``, ``_monitor_gather`` and
the capture segment of ``_simulate_local``):

* ``extras_accumulate`` — after the pressure / stress kernel of every step
  of the sensor window, ``<Field>_rms`` adds v*v and ``<Field>_peak`` keeps
  max(acc, |v|) for each requested map (``Extras``); Field is Pressure, Vx,
  Vy, Vz, Sigmaxx, Sigmayy or Sigmazz, taken after this step's injections;
* the pressure at K voxels (or at every voxel) written into row m of a
  preallocated (n_samples, K) device buffer at each sample step: a
  ``Monitor`` handed to the step's pressure / stress wrapper, whose kernel
  takes the sample itself (its MONITOR instantiation, ``csrc/fdtd_fluid.cu``
  / ``csrc/fdtd_visco.cu``; the voxels sorted by the warp that writes them,
  ``monitor_csr``). Its plain version is ``monitor_gather_ref``.

The extras kernel lives in ``csrc/fdtd_extras.cu``: the XLA path's 14 maps
(``_update_extras``), after each step a run takes on the pair. The MONITOR
instantiations take the XLA path's samples on the pair. B4's own
``with_p2`` accumulator and the monitor capture of its driver
(``babelbrain_tpu/ops/fdtd_pallas.py``) live in the fluid sweep's EXTRAS
instantiations (``ops.fdtd_fused_kernels.fluid_fused`` with ``extras`` and a
``SweepMonitor``, whose voxel list is ``sweep_csr``); the sweep serves the
maps of ``SWEEP_MAPS``. Every fluid run, on either route, reads
``Pressure_peak`` (and the Sigma peaks that alias it) from the carrier peak
(``Extras.zeros(peak=)``), as JAX's B4 path does: the pair's pressure kernel
and the sweep keep fmaxf(peak, |p|) over the same window steps.
``Diagnostics`` holds the state of one run: ``monitor(n)`` is the sample of
step n on the pair, ``sweep_monitor(n, k)`` that of a sweep of K steps from
n, ``record`` feeds the maps after a step on the pair.

The wrappers dispatch on the device of the state: a CPU state runs the plain
version, a CUDA state launches the kernel on its device and that device's
current stream (or raises); a tensor on another device is refused.
``launches`` counts kernel launches (``monitor_<family>``: launches of a
MONITOR instantiation), ``plain_calls`` calls of the plain versions, keyed
by kernel and family.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _build
from .fdtd_kernels import (
    TILE_Z,
    FluidState,
    LaunchGeometry,
    fluid_launch_geometry,
)
from .fdtd_visco_kernels import ViscoState, visco_launch_geometry

MAP_FIELDS = ("Pressure", "Vx", "Vy", "Vz", "Sigmaxx", "Sigmayy", "Sigmazz")
# accumulator i of the kernel's bitmask is SEL_MAPS[i]
SEL_MAPS = tuple(f"{f}_{k}" for f in MAP_FIELDS for k in ("rms", "peak"))
# the maps the fluid sweep's extras instantiations serve (B4's with_p2 and
# its carrier peak, `babelbrain_tpu/ops/fdtd.py:1089-1103`): Pressure_rms
# summed in the sweep, Pressure_peak carried by the run's peak
SWEEP_MAPS = frozenset({"Pressure_rms", "Pressure_peak"})

_KEYS = ("extras_fluid", "extras_visco", "monitor_fluid", "monitor_visco")
launches = dict.fromkeys(_KEYS, 0)
plain_calls = dict.fromkeys(_KEYS, 0)


def check_sel_maps(sel_maps) -> tuple:
    """The requested map names, in order and without repeats; raises on a
    name outside the 14 of ``SEL_MAPS`` (the JAX ``run_fdtd`` message)."""
    names = tuple(dict.fromkeys(sel_maps))
    bad = set(names) - set(SEL_MAPS)
    if bad:
        raise ValueError(f"unknown sel_maps entries: {sorted(bad)}")
    return names


def _family(st) -> tuple[bool, tuple]:
    """(viscoelastic?, the fields the kernels read): fluid p, vx, vy, vz;
    visco sxx, syy, szz, vx, vy, vz."""
    if isinstance(st, ViscoState):
        return True, (st.sxx, st.syy, st.szz, st.vx, st.vy, st.vz)
    if isinstance(st, FluidState):
        return False, (st.p, st.vx, st.vy, st.vz)
    raise TypeError(f"not an FDTD state: {type(st).__name__}")


@dataclass
class Extras:
    """Accumulators of the requested maps on one device.

    ``names``: the requested maps; ``source[name]``: the accumulator that
    holds it; ``acc``: accumulator name -> (N1, N2, N3) float32 tensor, fed
    by the maps' pass or the extras sweep; ``carried``: accumulator name ->
    a tensor of the run's state that already holds it (read, never fed). In
    a fluid medium sigma_ii = -p, so (-p)^2 and |-p| equal p^2 and |p| bit
    for bit: the Sigma maps are held by the Pressure accumulators.
    """

    names: tuple
    source: dict
    acc: dict
    carried: dict = field(default_factory=dict)

    @classmethod
    def zeros(cls, sel_maps, shape, device, visco: bool,
              peak: torch.Tensor | None = None) -> "Extras":
        """Zero accumulators of ``sel_maps``; ``peak``: the carrier |p|
        peak of a fluid run (the pair's DFT or the sweep's, fmaxf(peak, |p|)
        from 0 over the window steps, as the maps' pass), which then holds
        Pressure_peak, as JAX's B4 path reads it."""
        names = check_sel_maps(sel_maps)
        source = {}
        for name in names:
            fld, kind = name.rsplit("_", 1)
            source[name] = (f"Pressure_{kind}"
                            if not visco and fld.startswith("Sigma") else name)
        held = dict.fromkeys(source.values())
        carried = ({"Pressure_peak": peak}
                   if peak is not None and "Pressure_peak" in held else {})
        acc = {k: torch.zeros(tuple(shape), dtype=torch.float32, device=device)
               for k in held if k not in carried}
        return cls(names=names, source=source, acc=acc, carried=carried)

    @property
    def mask(self) -> int:
        """Bit i set: the accumulator of ``SEL_MAPS[i]`` is held."""
        return sum(1 << SEL_MAPS.index(k) for k in self.acc)

    def read(self, n_win: int) -> dict:
        """The maps as float32 numpy arrays: sqrt(sum / n_win) for ``_rms``,
        the running maximum for ``_peak`` (the JAX readout)."""
        host = {k: v.cpu().numpy()
                for k, v in {**self.acc, **self.carried}.items()}
        out = {}
        for name in self.names:
            v = host[self.source[name]]
            out[name] = (np.sqrt(v / n_win).astype(np.float32)
                         if name.endswith("_rms") else v.copy())
        return out


def _check(st, tensors, what) -> None:
    visco, fields = _family(st)
    dev, shape = fields[0].device, tuple(fields[0].shape)
    for t in fields + tuple(tensors):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(
                f"{what}: every tensor must be float32 on {dev}, got "
                f"{t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    for t in fields:
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: field shapes differ")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _pointer_array(tensors, n) -> ctypes.Array:
    """Host array of ``n`` device pointers (null after ``tensors``)."""
    ptrs = [t.data_ptr() for t in tensors] + [None] * (n - len(tensors))
    return (ctypes.c_void_p * n)(*ptrs)


def extras_accumulate(st, ex: Extras) -> None:
    """Add this step's fields to the held accumulators, in place."""
    _check(st, ex.acc.values(), "extras")
    visco, fields = _family(st)
    for t in ex.acc.values():
        if tuple(t.shape) != tuple(fields[0].shape):
            raise ValueError("extras: accumulator shape differs from the grid")
    if fields[0].device.type == "cpu":
        extras_accumulate_ref(st, ex)
        return
    accs = [ex.acc.get(k) for k in SEL_MAPS]
    acc_ptrs = (ctypes.c_void_p * len(SEL_MAPS))(
        *(None if t is None else t.data_ptr() for t in accs))
    _build.launch(
        "bb_extras_accumulate", "extras_accumulate_kernel", fields[0].device,
        _pointer_array(fields, 6), acc_ptrs, ex.mask, int(visco),
        fields[0].numel(),
    )
    launches["extras_visco" if visco else "extras_fluid"] += 1


def _field_values(visco, fields):
    """Field -> its (N1, N2, N3) values, as the kernel forms them."""
    if visco:
        sxx, syy, szz, vx, vy, vz = fields
        p = -(sxx + syy + szz) * (1.0 / 3.0)
        return dict(Pressure=p, Vx=vx, Vy=vy, Vz=vz, Sigmaxx=sxx,
                    Sigmayy=syy, Sigmazz=szz)
    p, vx, vy, vz = fields
    return dict(Pressure=p, Vx=vx, Vy=vy, Vz=vz, Sigmaxx=-p, Sigmayy=-p,
                Sigmazz=-p)


def extras_accumulate_ref(st, ex: Extras) -> None:
    """Plain version of ``extras_accumulate_kernel`` (in place)."""
    visco, fields = _family(st)
    plain_calls["extras_visco" if visco else "extras_fluid"] += 1
    values = _field_values(visco, fields)
    for name, acc in ex.acc.items():
        fld, kind = name.rsplit("_", 1)
        v = values[fld]
        if kind == "rms":
            acc.copy_(acc + v * v)
        else:
            acc.copy_(torch.maximum(acc, v.abs()))


def monitor_index(monitor_ijk, shape, device) -> torch.Tensor:
    """int32 (K,) C-order linear indices of (K, 3) voxel indices; raises on
    a voxel outside ``shape``."""
    shape = tuple(int(n) for n in shape)
    if int(np.prod(shape)) >= 2**31:
        raise ValueError(f"grid {shape} too large for int32 voxel indices")
    mi = np.asarray(monitor_ijk, np.int64).reshape(-1, 3)
    if (mi < 0).any() or (mi >= np.array(shape)).any():
        raise ValueError(f"monitor voxels outside the grid {shape}")
    lin = np.ravel_multi_index(tuple(mi.T), shape)
    return torch.as_tensor(lin.astype(np.int32), device=torch.device(device))


def monitor_gather_ref(st, index: torch.Tensor | None, out: torch.Tensor,
                       row: int) -> None:
    """Plain version of the MONITOR instantiations' sample (in place): the
    pressure at ``index`` (None: every voxel) into ``out[row]``."""
    visco, fields = _family(st)
    plain_calls["monitor_visco" if visco else "monitor_fluid"] += 1

    def at(t):
        flat = t.view(-1)
        return flat if index is None else flat.index_select(0, index)

    if visco:
        p = -(at(fields[0]) + at(fields[1]) + at(fields[2])) * (1.0 / 3.0)
    else:
        p = at(fields[0])
    out[row].copy_(p)


def monitor_csr(lin, shape, geo: LaunchGeometry):
    """The monitor voxels ``lin`` (C-order linear indices, any order,
    repeats allowed) sorted by the warp of ``geo`` that writes them, as the
    listed MONITOR kernels read them: (``start`` int32 (n_warps + 1,),
    ``entries`` int32 (2, K) of [voxel, slot]), warp w's entries being
    ``entries[:, start[w]:start[w + 1]]``. A warp is one y-row of a block's
    tile and is numbered as the kernels number it: block * tile_y + the
    row, the block being z-tile + gz * (y-tile + gy * x-segment)."""
    n1, n2, n3 = (int(n) for n in shape)
    lin = np.asarray(lin, np.int64).reshape(-1)
    gz, gy, gx = geo.grid
    i, rest = np.divmod(lin, n2 * n3)
    j, k = np.divmod(rest, n3)
    ty, row = np.divmod(j, geo.tile_y)
    block = k // TILE_Z + gz * (ty + gy * (i // geo.segment))
    warp = block * geo.tile_y + row
    n_warps = gz * gy * gx * geo.tile_y
    order = np.argsort(warp, kind="stable")
    start = np.zeros(n_warps + 1, np.int64)
    np.cumsum(np.bincount(warp, minlength=n_warps), out=start[1:])
    entries = np.stack([lin[order], order]).astype(np.int32)
    return start.astype(np.int32), entries


@dataclass
class Monitor:
    """One pressure sample, taken by the pressure / stress kernel of a step:
    the pressure at ``index`` (int32 linear voxels; None: every voxel) into
    row ``row`` of ``series`` (n_samples, K). ``start`` / ``entries``
    are ``monitor_csr`` of the index for the kernel's launch geometry
    (``geometry``), on the series' device; ``visco``: the family, for the
    launch counts."""

    index: torch.Tensor | None
    series: torch.Tensor
    row: int
    geometry: LaunchGeometry | None = None
    start: torch.Tensor | None = None
    entries: torch.Tensor | None = None
    visco: bool = False

    def out_ptr(self) -> int:
        """Device address of the series row."""
        s = self.series
        return s.data_ptr() + self.row * s.shape[1] * s.element_size()

    def check(self, field: torch.Tensor, geo: LaunchGeometry) -> None:
        """Raise unless this sample fits a kernel launch of ``geo`` on a
        state whose fields are like ``field``."""
        k = field.numel() if self.index is None else int(self.index.shape[0])
        s = self.series
        if (s.device != field.device or s.dtype != torch.float32
                or not s.is_contiguous() or s.dim() != 2 or s.shape[1] != k
                or not 0 <= self.row < s.shape[0]):
            raise ValueError(
                f"monitor: row {self.row} of a {s.dtype} {tuple(s.shape)} "
                f"buffer on {s.device} for {k} points on {field.device}"
            )
        if self.index is not None and (self.geometry != geo
                                       or self.start.device
                                       != field.device):
            raise ValueError("monitor: its voxel list was sorted for another "
                             "launch geometry or device")

    def launched(self) -> None:
        """Count a launch of a MONITOR instantiation."""
        launches["monitor_visco" if self.visco else "monitor_fluid"] += 1

    def gather_ref(self, st) -> None:
        """The sample from the state after the step (the plain version)."""
        monitor_gather_ref(st, self.index, self.series, self.row)


def sweep_geometry(shape) -> LaunchGeometry:
    """The (z-tile, y-tile) columns of the fluid sweep's launch
    (``ops.fdtd_fused_kernels.fused_launch_geometry``) as one x-segment of
    all N1 planes: its tile rows (a thread's cells are ``CELLS`` rows of it
    apart), keyed as the EXTRAS instantiations key them whatever the
    stage."""
    from .fdtd_fused_kernels import fused_launch_geometry

    return fused_launch_geometry(tuple(int(n) for n in shape), 1)


def sweep_csr(lin, shape):
    """``monitor_csr`` of the voxels ``lin`` for the fluid sweep
    (``sweep_geometry``: a list a tile row), each row's entries sorted by
    voxel (a repeated voxel's slots in their order): each stage of an
    extras sweep walks its rows' entries plane by plane as it writes
    them."""
    start, (cell, slot) = monitor_csr(lin, shape, sweep_geometry(shape))
    warp = np.repeat(np.arange(len(start) - 1), np.diff(start))
    order = np.lexsort((slot, cell, warp))
    return start, np.stack([cell[order], slot[order]])


@dataclass
class SweepMonitor:
    """The pressure samples of one extras sweep of K steps
    (``ops.fdtd_fused_kernels.fluid_fused``): step s of the sweep writes the
    pressure at ``index`` into row ``rows[s]`` of ``series`` (n_samples, K
    voxels; -1: step s takes no sample). ``start`` / ``entries`` are
    ``sweep_csr`` of the index, on the series' device."""

    index: torch.Tensor
    series: torch.Tensor
    start: torch.Tensor
    entries: torch.Tensor
    rows: tuple

    def check(self, field: torch.Tensor, k: int) -> None:
        """Raise unless this sample fits a sweep of ``k`` steps on a state
        whose fields are like ``field``."""
        s = self.series
        n = int(self.index.shape[0])
        geo = sweep_geometry(field.shape)
        gz, gy, _ = geo.grid
        if (s.device != field.device or s.dtype != torch.float32
                or not s.is_contiguous() or s.dim() != 2 or s.shape[1] != n
                or self.start.device != field.device
                or self.start.shape[0] != gz * gy * geo.tile_y + 1
                or len(self.rows) != k
                or not all(-1 <= r < s.shape[0] for r in self.rows)):
            raise ValueError(
                f"sweep monitor: rows {self.rows} of a {s.dtype} "
                f"{tuple(s.shape)} buffer on {s.device} for {n} voxels and "
                f"{k} steps on {field.device}")


@dataclass
class Diagnostics:
    """What one FDTD run records besides the carrier DFT.

    ``extras``: the map accumulators, fed at every step n >= ``window_start``
    (None: no maps). ``rows``: sample step -> row of ``series``, the
    (n_samples, K) float32 buffer the pressure at ``index`` (int32 linear
    voxel indices; None: every voxel) is written to (empty: no series);
    ``sample``: the ``Monitor`` of row 0 (None without a series or with
    no voxel).
    """

    window_start: int
    extras: Extras | None = None
    rows: dict = field(default_factory=dict)
    index: torch.Tensor | None = None
    series: torch.Tensor | None = None
    sample: Monitor | None = None
    swept: SweepMonitor | None = None

    @classmethod
    def create(cls, st, window_start, sel_maps=(), sample_steps=(),
               index=None, sweep: bool = False) -> "Diagnostics":
        """Zero accumulators and an empty series buffer on the state's
        device, Pressure_peak read from a fluid state's carrier peak;
        ``sample_steps``: the steps whose pressure is kept; ``sweep``: the
        fluid run's window goes through extras sweeps (the listed voxels
        also sorted for the sweep, ``sweep_monitor``)."""
        visco, fields = _family(st)
        f0 = fields[0]
        extras = (Extras.zeros(sel_maps, f0.shape, f0.device, visco,
                               peak=None if visco else st.peak)
                  if tuple(sel_maps) else None)
        steps = [int(n) for n in sample_steps]
        if index is not None and (index.device != f0.device
                                  or index.dtype != torch.int32
                                  or index.dim() != 1
                                  or not index.is_contiguous()):
            raise ValueError(
                f"monitor: expected a contiguous int32 index on {f0.device}, "
                f"got {index.dtype} {tuple(index.shape)} on {index.device}"
            )
        k = f0.numel() if index is None else int(index.shape[0])
        series = (torch.zeros((len(steps), k), dtype=torch.float32,
                              device=f0.device) if steps else None)
        sample = None
        if steps and k:
            geo = (visco_launch_geometry if visco
                   else fluid_launch_geometry)(tuple(f0.shape))
            sample = Monitor(index, series, 0, geo, visco=visco)
            if index is not None:
                sample.start, sample.entries = (
                    torch.as_tensor(a, device=f0.device)
                    for a in monitor_csr(index.cpu().numpy(), f0.shape, geo))
        swept = None
        if sweep and sample is not None:
            if visco or index is None:
                raise ValueError("extras sweeps sample listed voxels of a "
                                 "fluid run")
            start, entries = sweep_csr(index.cpu().numpy(), f0.shape)
            swept = SweepMonitor(index, series,
                                 torch.as_tensor(start, device=f0.device),
                                 torch.as_tensor(entries, device=f0.device),
                                 ())
        return cls(window_start=int(window_start), extras=extras,
                   rows={n: m for m, n in enumerate(steps)}, index=index,
                   series=series, sample=sample, swept=swept)

    def sweep_monitor(self, n: int, k: int) -> SweepMonitor | None:
        """The samples of the extras sweep of steps n .. n + k - 1 (None:
        no listed voxels)."""
        if self.swept is None:
            return None
        return dataclasses.replace(
            self.swept, rows=tuple(self.rows.get(m, -1)
                                   for m in range(n, n + k)))

    def monitor(self, n: int) -> Monitor | None:
        """The sample step ``n`` takes (None: not a sample step), for the
        step's pressure / stress wrapper."""
        row = self.rows.get(n)
        if row is None or self.sample is None:
            return None
        return dataclasses.replace(self.sample, row=row)

    def record(self, st, n: int, plain: bool = False) -> None:
        """After step ``n``: feed the maps inside the window; ``plain`` runs
        the plain version."""
        if (self.extras is not None and self.extras.acc
                and n >= self.window_start):
            (extras_accumulate_ref if plain else extras_accumulate)(
                st, self.extras)
