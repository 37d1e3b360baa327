"""Domain decomposition along x for the FDTD, on explicit torch devices.

Counterpart of ``babelbrain_tpu/parallel/halo.py``. The JAX package runs
one program over a device ``Mesh`` with ``shard_map``; each shard carries
2-plane halos (the 4th-order stencil's reach) on both sides, refreshed with
``lax.ppermute``, and its kernels shift and mask the x CPML by the shard's
place (``edge_offset``). Here one process drives a tuple of
``torch.device`` (``DeviceMesh``), each shard's state lives on its device,
and ``XSlabs.refresh`` copies the ghost planes between neighbours after
each half-step that writes them; the overlap-and-discard fused sweeps
(``ops.fdtd.sweep_shards``) carry H ghost planes a side and refresh a group
of fields with one transfer per boundary and direction
(``XSlabs.refresh_group``, the JAX driver's ``refresh_group``). The first
shard has no ghost planes below
it and the last none above (``XSlabs``): a global edge is the end of its
shard's array, so the kernels' zero boundary there is the whole grid's,
and the x-CPML slab sits where the whole grid has it (the kernels are told
only whether a shard applies it: ``FluidCoeffs.x_lo`` / ``x_hi``).

A mesh may name one device several times (``make_mesh(4, devices=
["cuda:0"] * 4)``, or ``["cpu"] * 4`` on the CPU): the shards then share it
and run in turn, which checks the decomposition bit for bit on one card.
Without ``devices`` a mesh takes CUDA devices 0..n-1 and refuses more than
exist. Copies between two devices go through ``Tensor.copy_`` with
``non_blocking=True``: PyTorch orders a copy between devices on both
devices' current streams with CUDA events (a barrier on the destination's
stream before the copy, one on the source's after it), so neither side
waits for the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# the ROADMAP item that holds what the decomposition does not do yet
ROADMAP_ITEM = "ROADMAP Queue A item 6"


@dataclass(frozen=True)
class DeviceMesh:
    """Devices laid out on named axes: ``devices`` in C order over
    ``shape``, one entry of ``axis_names`` per axis."""

    devices: tuple
    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(n_devices, devices) -> tuple:
    """The mesh's devices: ``devices`` as given (repeats allowed; "cuda"
    is the current card), else CUDA devices 0..n_devices-1 (all present
    when None). Refuses a CUDA device that does not exist; never falls back
    to the CPU."""
    count = torch.cuda.device_count()
    if devices is None:
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(
                f"make_mesh: {n} CUDA devices asked for, {count} present; "
                "name devices= to place several shards on one device"
            )
        return tuple(torch.device("cuda", i) for i in range(n))
    devs = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d.index is None and count:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.type == "cuda" and not (d.index is not None
                                     and 0 <= d.index < count):
            raise ValueError(f"make_mesh: {d} is not a CUDA device of this "
                             f"machine ({count} present)")
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"make_mesh: unsupported device {d}")
        devs.append(d)
    if not devs or (n_devices is not None and int(n_devices) != len(devs)):
        raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                         f"{len(devs)} named")
    return tuple(devs)


def make_mesh(n_devices: int | None = None, axis: str = "x",
              devices=None) -> DeviceMesh:
    """1-D mesh on axis ``axis``: ``devices`` (a list of devices, repeats
    allowed), or CUDA devices 0..n_devices-1 (all of them when None)."""
    devs = _devices(n_devices, devices)
    return DeviceMesh(devs, (axis,), (len(devs),))


def make_mesh_2d(nx: int, ny: int, devices=None) -> DeviceMesh:
    """2-D (x, y) mesh of nx * ny devices (``devices`` in C order)."""
    devs = _devices(int(nx) * int(ny), devices)
    return DeviceMesh(devs, ("x", "y"), (int(nx), int(ny)))


def mesh_axis_sizes(mesh: DeviceMesh) -> tuple:
    """(n_x, n_y) shard counts of a 1-D or 2-D FDTD mesh."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return sizes.get("x", 1), sizes.get("y", 1)


def mesh_devices(mesh, what: str) -> tuple:
    """The devices of a 1-D ``DeviceMesh``, for ``what``; raises TypeError
    for anything else and NotImplementedError for a mesh of more axes."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a DeviceMesh (parallel.halo."
                        f"make_mesh), got {type(mesh).__name__}")
    if len([n for n in mesh.shape if n > 1]) > 1:
        raise NotImplementedError(
            f"{what}: meshes of more than one axis ({mesh.axis_names} "
            f"{mesh.shape}) are {ROADMAP_ITEM}"
        )
    return mesh.devices


@dataclass(frozen=True)
class XSlabs:
    """N1 planes in ``n_shards`` equal shards along x, each extended by
    ``halo`` ghost planes on the sides that have a neighbour.

    Shard s holds global planes [start(s), start(s) + planes(s)) and owns
    the ``width`` planes ``own(s)`` of them (local indices); the first
    shard has no ghost planes below, the last none above.
    """

    n1: int
    n_shards: int
    halo: int = 2

    @property
    def width(self) -> int:
        return self.n1 // self.n_shards

    def lo_ghosts(self, s: int) -> int:
        return self.halo if s > 0 else 0

    def hi_ghosts(self, s: int) -> int:
        return self.halo if s < self.n_shards - 1 else 0

    def start(self, s: int) -> int:
        """Global index of shard s's local plane 0."""
        return s * self.width - self.lo_ghosts(s)

    def planes(self, s: int) -> int:
        return self.width + self.lo_ghosts(s) + self.hi_ghosts(s)

    def own(self, s: int) -> slice:
        """Shard s's own planes, as a slice of its local planes."""
        lo = self.lo_ghosts(s)
        return slice(lo, lo + self.width)

    def refresh_group(self, groups) -> None:
        """Ghost planes of a group of same-shaped fields (``groups[s]``:
        shard s's tensors, as ``refresh`` takes one): at each boundary and
        in each direction the group's ``halo`` own planes are stacked into
        one buffer, moved to the neighbour's device in one transfer and
        copied into its ghost planes with one multi-tensor copy."""
        h = self.halo
        for s in range(self.n_shards - 1):
            a, b = groups[s], groups[s + 1]
            end = a[0].shape[0] - h  # a's own planes end here
            for src, src_sl, dst, dst_sl in ((b, slice(h, 2 * h), a,
                                              slice(end, None)),
                                             (a, slice(end - h, end), b,
                                              slice(0, h))):
                buf = torch.stack([t[src_sl] for t in src])
                buf = buf.to(dst[0].device, non_blocking=True)
                torch._foreach_copy_([t[dst_sl] for t in dst],
                                     list(buf.unbind(0)))

    def refresh(self, tensors) -> None:
        """Ghost planes of ``tensors`` (shard s's (planes(s), ...) tensor at
        index s) from their neighbours' own planes: at each boundary the
        last ``halo`` own planes below it and the first above it."""
        h = self.halo
        for s in range(self.n_shards - 1):
            a, b = tensors[s], tensors[s + 1]
            end = a.shape[0] - h  # a's own planes end here
            a[end:].copy_(b[h:2 * h], non_blocking=True)
            b[:h].copy_(a[end - h:end], non_blocking=True)
