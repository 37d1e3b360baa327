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
* ``monitor_gather`` — the pressure at K voxels (or at every voxel) written
  into row m of a preallocated (n_samples, K) device buffer.

Both kernels live in ``csrc/fdtd_extras.cu`` and replace the JAX package's
B4 ``with_p2`` accumulator and its driver's monitor capture
(``babelbrain_tpu/ops/fdtd_pallas.py``), generalised to the 14 maps and the
sample steps of the XLA path. ``Diagnostics`` holds the state of one run and
``record`` applies both after a step.

The wrappers dispatch on the device of the state: a CPU state runs the plain
version, a CUDA state launches the kernel on the current stream (or raises).
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
versions, keyed by kernel and family.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _build
from .fdtd_kernels import FluidState, _ptr, _stream
from .fdtd_visco_kernels import ViscoState

MAP_FIELDS = ("Pressure", "Vx", "Vy", "Vz", "Sigmaxx", "Sigmayy", "Sigmazz")
# accumulator i of the kernel's bitmask is SEL_MAPS[i]
SEL_MAPS = tuple(f"{f}_{k}" for f in MAP_FIELDS for k in ("rms", "peak"))

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
    holds it; ``acc``: accumulator name -> (N1, N2, N3) float32 tensor. In a
    fluid medium sigma_ii = -p, so (-p)^2 and |-p| equal p^2 and |p| bit for
    bit: the Sigma maps are held by the Pressure accumulators.
    """

    names: tuple
    source: dict
    acc: dict

    @classmethod
    def zeros(cls, sel_maps, shape, device, visco: bool) -> "Extras":
        names = check_sel_maps(sel_maps)
        source = {}
        for name in names:
            fld, kind = name.rsplit("_", 1)
            source[name] = (f"Pressure_{kind}"
                            if not visco and fld.startswith("Sigma") else name)
        acc = {k: torch.zeros(tuple(shape), dtype=torch.float32, device=device)
               for k in dict.fromkeys(source.values())}
        return cls(names=names, source=source, acc=acc)

    @property
    def mask(self) -> int:
        """Bit i set: the accumulator of ``SEL_MAPS[i]`` is held."""
        return sum(1 << SEL_MAPS.index(k) for k in self.acc)

    def read(self, n_win: int) -> dict:
        """The maps as float32 numpy arrays: sqrt(sum / n_win) for ``_rms``,
        the running maximum for ``_peak`` (the JAX readout)."""
        host = {k: v.cpu().numpy() for k, v in self.acc.items()}
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
    lib = _build.library()
    rc = lib.bb_extras_accumulate(
        _pointer_array(fields, 6), acc_ptrs, ex.mask, int(visco),
        fields[0].numel(), _stream(),
    )
    _build.check(rc, "extras_accumulate_kernel")
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


def monitor_gather(st, index: torch.Tensor | None, out: torch.Tensor,
                   row: int) -> None:
    """Write the pressure at the voxels ``index`` (int32 linear; None: every
    voxel in C order) into ``out[row]`` of the (n_samples, K) buffer."""
    _check(st, (out,), "monitor")
    visco, fields = _family(st)
    k = fields[0].numel() if index is None else int(index.shape[0])
    if k >= 2**31:
        raise ValueError(f"monitor: {k} points exceed the kernel's int32 count")
    if out.dim() != 2 or out.shape[1] != k or not 0 <= row < out.shape[0]:
        raise ValueError(
            f"monitor: row {row} of a {tuple(out.shape)} buffer for {k} points"
        )
    if index is not None and (index.device != out.device
                              or index.dtype != torch.int32 or index.dim() != 1
                              or not index.is_contiguous()):
        raise ValueError(
            f"monitor: expected a contiguous int32 index on {out.device}, got "
            f"{index.dtype} on {index.device}"
        )
    if out.device.type == "cpu":
        monitor_gather_ref(st, index, out, row)
        return
    if k == 0:
        return
    lib = _build.library()
    rc = lib.bb_monitor_gather(
        _pointer_array(fields, 6), None if index is None else _ptr(index),
        ctypes.c_void_p(out.data_ptr() + row * k * out.element_size()), k,
        int(visco), _stream(),
    )
    _build.check(rc, "monitor_gather_kernel")
    launches["monitor_visco" if visco else "monitor_fluid"] += 1


def monitor_gather_ref(st, index: torch.Tensor | None, out: torch.Tensor,
                       row: int) -> None:
    """Plain version of ``monitor_gather_kernel`` (in place)."""
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


@dataclass
class Diagnostics:
    """What one FDTD run records besides the carrier DFT.

    ``extras``: the map accumulators, fed at every step n >= ``window_start``
    (None: no maps). ``rows``: sample step -> row of ``series``, the
    (n_samples, K) float32 buffer the pressure at ``index`` (int32 linear
    voxel indices; None: every voxel) is written to (empty: no series).
    """

    window_start: int
    extras: Extras | None = None
    rows: dict = field(default_factory=dict)
    index: torch.Tensor | None = None
    series: torch.Tensor | None = None

    @classmethod
    def create(cls, st, window_start, sel_maps=(), sample_steps=(),
               index=None) -> "Diagnostics":
        """Zero accumulators and an empty series buffer on the state's
        device; ``sample_steps``: the steps whose pressure is kept."""
        visco, fields = _family(st)
        f0 = fields[0]
        extras = (Extras.zeros(sel_maps, f0.shape, f0.device, visco)
                  if tuple(sel_maps) else None)
        steps = [int(n) for n in sample_steps]
        k = f0.numel() if index is None else int(index.shape[0])
        series = (torch.zeros((len(steps), k), dtype=torch.float32,
                              device=f0.device) if steps else None)
        return cls(window_start=int(window_start), extras=extras,
                   rows={n: m for m, n in enumerate(steps)}, index=index,
                   series=series)

    def record(self, st, n: int, plain: bool = False) -> None:
        """After step ``n``: feed the maps inside the window and keep the
        pressure at a sample step; ``plain`` runs the plain versions."""
        if self.extras is not None and n >= self.window_start:
            (extras_accumulate_ref if plain else extras_accumulate)(
                st, self.extras)
        row = self.rows.get(n)
        if row is not None:
            (monitor_gather_ref if plain else monitor_gather)(
                st, self.index, self.series, row)
