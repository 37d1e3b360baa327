"""Domain decomposition along x and y for the FDTD, on explicit torch devices.

Counterpart of ``babelbrain_tpu/parallel/halo.py``. The JAX package runs
one program over a device ``Mesh`` with ``shard_map``; each shard carries
2-plane halos (the 4th-order stencil's reach) on both sides of each
sharded axis (``DomainComm.pad_x`` / ``pad_y``), refreshed with
``lax.ppermute``, and its kernels shift and mask the x CPML by the shard's
place (``edge_offset``; ``edge_masks_y`` along y). Here one process drives
a tuple of ``torch.device`` (``DeviceMesh``), each shard's state lives on
its device, and ``Blocks.refresh`` copies the ghost planes between
neighbours along one axis after each half-step that writes them; the
overlap-and-discard fused sweeps (``ops.fdtd.sweep_shards``, x meshes
only) carry H ghost planes a side and refresh a group of fields with one
transfer per boundary and direction (``XSlabs.refresh_group``, the JAX
driver's ``refresh_group``). Along each axis (``XSlabs``, one per axis in
``Blocks``) the first shard has no ghost planes below it and the last
none above: a global edge is the end of its shard's array, so the
kernels' zero boundary there is the whole grid's, and the CPML slab sits
where the whole grid has it (the kernels are told only whether a shard
applies it: ``FluidCoeffs.x_lo`` / ``x_hi`` / ``y_lo`` / ``y_hi``).

A mesh may name one device several times (``make_mesh(4, devices=
["cuda:0"] * 4)``, ``make_mesh_2d(2, 4, devices=["cuda:0"] * 8)``, or
``["cpu"] * n`` on the CPU): the shards then share it and run in turn,
which checks the decomposition bit for bit on one card. Without
``devices`` a mesh takes CUDA devices 0..n-1 and refuses more than exist.
Copies between two devices go through ``Tensor.copy_`` with
``non_blocking=True``: PyTorch orders a copy between devices on both
devices' current streams with CUDA events (a barrier on the destination's
stream before the copy, one on the source's after it), so neither side
waits for the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# the ROADMAP items that hold what the decomposition does not do yet
ROADMAP_ITEM = "ROADMAP Queue A item 6b / 6c"


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
    """The devices of a ``DeviceMesh`` of any axes (C order), for
    ``what``; raises TypeError for anything else."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a DeviceMesh (parallel.halo."
                        f"make_mesh), got {type(mesh).__name__}")
    return mesh.devices


@dataclass(frozen=True)
class XSlabs:
    """N1 planes in ``n_shards`` equal shards along array axis ``axis`` (0:
    x; 1: y, the y slabs of ``Blocks``), each extended by ``halo`` ghost
    planes on the sides that have a neighbour.

    Shard s holds global planes [start(s), start(s) + planes(s)) and owns
    the ``width`` planes ``own(s)`` of them (local indices); the first
    shard has no ghost planes below, the last none above.
    """

    n1: int
    n_shards: int
    halo: int = 2
    axis: int = 0

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
        h, ax = self.halo, self.axis
        for s in range(self.n_shards - 1):
            a, b = groups[s], groups[s + 1]
            end = a[0].shape[ax] - h  # a's own planes end here
            for src, src_at, dst, dst_at in ((b, h, a, end),
                                             (a, end - h, b, 0)):
                buf = torch.stack([t.narrow(ax, src_at, h) for t in src])
                buf = buf.to(dst[0].device, non_blocking=True)
                torch._foreach_copy_([t.narrow(ax, dst_at, h) for t in dst],
                                     list(buf.unbind(0)))

    def refresh(self, tensors) -> None:
        """Ghost planes of ``tensors`` (shard s's tensor, planes(s) long
        along ``axis``, at index s) from their neighbours' own planes: at
        each boundary the last ``halo`` own planes below it and the first
        above it. Along y a ghost slab is a strided (N1, halo, N3) block:
        one strided copy a boundary and direction."""
        h, ax = self.halo, self.axis
        for s in range(self.n_shards - 1):
            a, b = tensors[s], tensors[s + 1]
            end = a.shape[ax] - h  # a's own planes end here
            a.narrow(ax, end, h).copy_(b.narrow(ax, h, h), non_blocking=True)
            b.narrow(ax, 0, h).copy_(a.narrow(ax, end - h, h),
                                     non_blocking=True)


@dataclass(frozen=True)
class Blocks:
    """The (x, y) decomposition of an FDTD grid: ``x`` slabs of N1 and
    ``y`` slabs of N2 (``XSlabs`` on axes 0 and 1). Shard s of the mesh
    (C order, as ``make_mesh_2d`` lays out its devices) holds x slab
    s // ny and y slab s % ny, its ghost planes included; a 1-D x mesh has
    one y slab and no y ghost planes, a 1-D y mesh one x slab.

    An owned cell's axis-aligned stencil reads ghost cells along x or
    along y, never a corner cell that is a ghost along both: corners are
    not refreshed, and hold whatever the shard computed there."""

    x: XSlabs
    y: XSlabs

    @property
    def n_shards(self) -> int:
        return self.x.n_shards * self.y.n_shards

    def coords(self, s: int) -> tuple:
        """(x slab, y slab) of shard s."""
        return divmod(s, self.y.n_shards)

    def start(self, s: int) -> tuple:
        """Global (i, j) of shard s's local cell (0, 0)."""
        sx, sy = self.coords(s)
        return self.x.start(sx), self.y.start(sy)

    def planes(self, s: int) -> tuple:
        """Shard s's local (N1, N2), ghost planes included."""
        sx, sy = self.coords(s)
        return self.x.planes(sx), self.y.planes(sy)

    def own(self, s: int) -> tuple:
        """Shard s's own (x, y) cells, as slices of its local ones."""
        sx, sy = self.coords(s)
        return self.x.own(sx), self.y.own(sy)

    def owner(self, i: int, j: int) -> int:
        """The shard that owns global column (i, j)."""
        return (i // self.x.width) * self.y.n_shards + j // self.y.width

    def edges(self, s: int) -> tuple:
        """(x_lo, x_hi, y_lo, y_hi): which global edges shard s holds."""
        sx, sy = self.coords(s)
        return (sx == 0, sx == self.x.n_shards - 1, sy == 0,
                sy == self.y.n_shards - 1)

    def _lines(self, axis: int):
        """The shards along ``axis`` in each line of the mesh, in order."""
        nx, ny = self.x.n_shards, self.y.n_shards
        if axis == 0:
            return [[sx * ny + sy for sx in range(nx)] for sy in range(ny)]
        return [[sx * ny + sy for sy in range(ny)] for sx in range(nx)]

    def refresh_group(self, groups) -> None:
        """``XSlabs.refresh_group`` along x (the overlap-and-discard
        sweeps), on a mesh not cut along y."""
        if self.y.n_shards > 1:
            raise ValueError("refresh_group: the overlap-and-discard sweeps "
                             "run on x meshes only")
        self.x.refresh_group(groups)

    def refresh(self, tensors, axis: int) -> None:
        """Ghost planes along ``axis`` (0: x, 1: y) of ``tensors`` (shard
        s's at index s), line by line of the mesh (``XSlabs.refresh``)."""
        slabs = self.x if axis == 0 else self.y
        if slabs.n_shards > 1:
            for line in self._lines(axis):
                slabs.refresh([tensors[s] for s in line])
