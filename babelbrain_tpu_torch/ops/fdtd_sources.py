"""Volumetric velocity source (dome transducers): CUDA kernel, wrapper and
plain PyTorch version.

A dome array sits inside the simulation domain and drives particle velocity
along per-voxel normals. After each velocity update, at every voxel where
the drive amplitude is positive, the three velocities are SET to

    v_i = amp sin(wt + phase) ramp oz o_i
        = amp (s_sin cos(phase) + s_cos sin(phase)) o_i

(``babelbrain_tpu/ops/fdtd.py``, ``velocity_volume`` branch of both step
functions). The JAX package's TPU kernels B2/B4/B6/B8 stream the drive as
six dense (N1, N2, N3) volumes; here it is a sparse list of the source
voxels (``VolumeSource``), and ``velocity_volume_source`` scatters it with
one CUDA thread per voxel (``csrc/fdtd_sources.cu``), between the velocity
kernel and the pressure/stress kernel of either FDTD family.

The wrapper dispatches on the device of the velocities: CPU tensors run the
plain version (``velocity_volume_source_ref``, an ``index_put_`` of the
three velocities), CUDA tensors launch the kernel on their device and its
current stream (or raise); a source on another device is refused. ``launches`` counts kernel launches, ``plain_calls`` calls of the
plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import _build
from .fdtd_kernels import _ptr

launches = {"volume_source": 0}
plain_calls = {"volume_source": 0}

_FIELDS = ("amp", "cph", "sph", "ox", "oy", "oz")


@dataclass
class VolumeSource:
    """The source voxels of a volumetric drive, on one device.

    ``index``: int32 (S,) C-order linear voxel index; ``amp``, ``cph``,
    ``sph`` (amplitude and cos/sin of the phase), ``ox``, ``oy``, ``oz``
    (unit drive direction): float32 (S,).
    """

    index: torch.Tensor
    amp: torch.Tensor
    cph: torch.Tensor
    sph: torch.Tensor
    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    # (shape, the dense slot volume) once ``slot_volume`` built it
    _slots: tuple | None = field(default=None, repr=False, compare=False)

    @classmethod
    def from_sparse(cls, sparse: dict, shape, device) -> "VolumeSource":
        """The source on ``device`` from its host form (``index``: C-order
        linear voxel indices; ``amp``, ``phase``, ``ox``, ``oy``, ``oz``:
        float32 per voxel), as ``pipeline.acoustic.make_volume_source``
        returns it."""
        shape = tuple(int(n) for n in shape)
        if int(np.prod(shape)) >= 2**31:
            raise ValueError(f"grid {shape} too large for int32 voxel indices")
        index = np.asarray(sparse["index"])
        if index.ndim != 1 or (index.size and not (
                0 <= index.min() and index.max() < np.prod(shape))):
            raise ValueError(f"volume source indices outside the grid {shape}")
        dev = torch.device(device)

        def col(k):
            v = np.asarray(sparse[k], np.float32)
            if v.shape != index.shape:
                raise ValueError(f"volume source {k!r} has shape {v.shape}, "
                                 f"the index {index.shape}")
            return torch.as_tensor(v, device=dev)

        phase = col("phase")
        return cls(index=torch.as_tensor(index.astype(np.int32), device=dev),
                   amp=col("amp"), cph=torch.cos(phase), sph=torch.sin(phase),
                   ox=col("ox"), oy=col("oy"), oz=col("oz"))

    @classmethod
    def from_dense(cls, volume_source: dict, shape, device) -> "VolumeSource":
        """Sparse form of the dense dict of the JAX package's
        ``make_volume_source`` (``amp``, ``phase``, ``ox``, ``oy``, ``oz``,
        each (N1, N2, N3)): the voxels where the float32 amplitude is > 0,
        the JAX ``on`` mask."""
        shape = tuple(int(n) for n in shape)
        dense = {k: np.asarray(volume_source[k], np.float32)
                 for k in ("amp", "phase", "ox", "oy", "oz")}
        for k, v in dense.items():
            if v.shape != shape:
                raise ValueError(
                    f"volume_source[{k!r}] has shape {v.shape}, grid {shape}"
                )
        on = np.flatnonzero(dense["amp"] > 0)
        sparse = {k: v.reshape(-1)[on] for k, v in dense.items()}
        return cls.from_sparse(dict(sparse, index=on), shape, device)

    @property
    def n_src(self) -> int:
        return int(self.index.shape[0])

    def slot_volume(self, shape) -> torch.Tensor:
        """The drive as a dense int32 (N1, N2, N3) volume on the source's
        device: -1 where no voxel drives, else the voxel's index in the
        sparse list (the halo sweeps, ``ops.fdtd_halo_kernels`` and
        ``ops.fdtd_visco_halo_kernels``, read a cell's slot once a
        launch). Built once for a shape; a voxel listed
        twice is refused."""
        shape = tuple(int(n) for n in shape)
        if self._slots is None or self._slots[0] != shape:
            n = int(np.prod(shape))
            lin = self.index.long()
            if self.n_src and (int(lin.min()) < 0 or int(lin.max()) >= n):
                raise ValueError(
                    f"volume source indices outside the grid {shape}")
            if self.n_src and torch.unique(lin).numel() != self.n_src:
                raise ValueError("volume source: a voxel is listed twice")
            slots = torch.full((n,), -1, dtype=torch.int32,
                               device=self.index.device)
            slots[lin] = torch.arange(self.n_src, dtype=torch.int32,
                                      device=self.index.device)
            self._slots = (shape, slots.view(shape))
        return self._slots[1]


def _check(vx, vy, vz, vs: VolumeSource) -> None:
    dev = vx.device
    for v in (vx, vy, vz):
        if v.device != dev or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(
                "volume source: velocities must be contiguous float32 on one "
                f"device, got {v.dtype} on {v.device}"
            )
        if v.shape != vx.shape:
            raise ValueError("volume source: velocity shapes differ")
    if vs.index.device != dev or vs.index.dtype != torch.int32:
        raise ValueError(
            f"volume source: expected an int32 index on {dev}, got "
            f"{vs.index.dtype} on {vs.index.device}"
        )
    for k in _FIELDS:
        t = getattr(vs, k)
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (vs.n_src,) or not t.is_contiguous()):
            raise ValueError(
                f"volume source: {k} must be a contiguous float32 ({vs.n_src},)"
                f" tensor on {dev}"
            )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"volume source: unsupported device {dev}")


def velocity_volume_source(vx, vy, vz, vs: VolumeSource, s_sin: float,
                           s_cos: float) -> None:
    """Set the velocities at the source voxels in place; ``s_sin``/``s_cos``
    are sin(wt) and cos(wt) times the source ramp and the pressure->velocity
    scale."""
    _check(vx, vy, vz, vs)
    if vx.device.type == "cpu":
        velocity_volume_source_ref(vx, vy, vz, vs, s_sin, s_cos)
        return
    if vs.n_src == 0:
        return
    _build.launch(
        "bb_velocity_volume_source", "velocity_volume_source_kernel",
        vx.device, _ptr(vs.index), *(_ptr(getattr(vs, k)) for k in _FIELDS),
        _ptr(vx), _ptr(vy), _ptr(vz), s_sin, s_cos, vs.n_src,
    )
    launches["volume_source"] += 1


def velocity_volume_source_ref(vx, vy, vz, vs: VolumeSource, s_sin: float,
                               s_cos: float) -> None:
    """Plain version of ``velocity_volume_source_kernel`` (in place)."""
    plain_calls["volume_source"] += 1
    sv = vs.amp * (s_sin * vs.cph + s_cos * vs.sph)
    index = (vs.index.long(),)
    for v, o in ((vx, vs.ox), (vy, vs.oy), (vz, vs.oz)):
        v.view(-1).index_put_(index, sv * o)
