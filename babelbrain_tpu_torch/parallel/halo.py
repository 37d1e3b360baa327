"""Domain decomposition along x and y for the FDTD, on explicit torch devices.

Counterpart of ``babelbrain_tpu/parallel/halo.py``. The JAX package runs
one program over a device ``Mesh`` with ``shard_map``; each shard carries
2-plane halos (the 4th-order stencil's reach) on both sides of each
sharded axis (``DomainComm.pad_x`` / ``pad_y``), refreshed with
``lax.ppermute``, and its kernels shift and mask the x CPML by the shard's
place (``edge_offset``; ``edge_masks_y`` along y). Here each process
drives the shards of a ``DeviceMesh`` that lie on its devices, each
shard's state on its device, and ``Blocks.refresh`` copies the ghost planes
between neighbours along one axis after each half-step that writes them;
the overlap-and-discard fused sweeps (``ops.fdtd.sweep_shards``, x meshes
only) carry H ghost planes a side and refresh a group of fields with one
transfer per boundary and direction (``Blocks.refresh_group``, the JAX
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

A mesh made with ``group=`` (a gloo process group,
``parallel.distributed``) spans processes: each process names its own
devices, laid out in rank order as JAX's global ``jax.devices()``, and
``DeviceMesh.ranks`` records the process of each shard. A ghost slab
between two shards of one process is a device copy as above; one that
crosses processes is staged to the host and sent, all of one refresh in one
``batch_isend_irecv`` (``parallel.distributed.exchange``), each message
tagged by field, axis, boundary and direction. Corners are not refreshed
(``Blocks``), across processes as within one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import distributed

# the ROADMAP item that holds what the decomposition does not do yet
ROADMAP_ITEM = "ROADMAP Queue A item 6c"


@dataclass(frozen=True)
class DeviceMesh:
    """Devices laid out on named axes: ``devices`` in C order over
    ``shape``, one entry of ``axis_names`` per axis. Across processes
    (``group``): ``ranks`` the process of each device, ``rank`` this
    one's; a device of another process is only its name here."""

    devices: tuple
    axis_names: tuple
    shape: tuple
    ranks: tuple | None = None
    group: object = field(default=None, compare=False, repr=False)
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(set(self.ranks)) > 1


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


def _mesh(n_total, devices, group, axis_names, shape) -> DeviceMesh:
    """A mesh of ``devices`` (this process's, see ``_devices``); with a
    ``group`` those of every process of it in rank order, gathered once."""
    if group is None:
        devs = _devices(n_total, devices)
        return DeviceMesh(devs, axis_names, shape or (len(devs),))
    distributed.check_group(group)
    mine = _devices(None, devices)
    names = distributed.all_gather_object([str(d) for d in mine], group)
    rank = distributed.process_index(group)
    devs = tuple(mine[j] if r == rank else torch.device(n)
                 for r, ns in enumerate(names) for j, n in enumerate(ns))
    if n_total is not None and int(n_total) != len(devs):
        raise ValueError(f"make_mesh: {n_total} devices asked for, "
                         f"{len(devs)} named by the {len(names)} processes")
    ranks = tuple(r for r, ns in enumerate(names) for _ in ns)
    return DeviceMesh(devs, axis_names, shape or (len(devs),), ranks, group,
                      rank)


def make_mesh(n_devices: int | None = None, axis: str = "x",
              devices=None, group=None) -> DeviceMesh:
    """1-D mesh on axis ``axis``: ``devices`` (a list of devices, repeats
    allowed), or CUDA devices 0..n_devices-1 (all of them when None). With
    a process ``group`` each process names its own ``devices`` (without
    them its CUDA devices) and ``n_devices`` counts those of all."""
    return _mesh(n_devices, devices, group, (axis,), None)


def make_mesh_2d(nx: int, ny: int, devices=None, group=None) -> DeviceMesh:
    """2-D (x, y) mesh of nx * ny devices (``devices`` in C order; with a
    process ``group``, each process's own, in rank order)."""
    n = int(nx) * int(ny)
    return _mesh(n, devices, group, ("x", "y"), (int(nx), int(ny)))


def mesh_axis_sizes(mesh: DeviceMesh) -> tuple:
    """(n_x, n_y) shard counts of a mesh (1 for an axis it does not
    have)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return sizes.get("x", 1), sizes.get("y", 1)


def check_mesh(mesh, what: str) -> None:
    """Raise TypeError unless ``mesh`` is a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a DeviceMesh (parallel.halo."
                        f"make_mesh), got {type(mesh).__name__}")


def mesh_devices(mesh, what: str) -> tuple:
    """The devices of a ``DeviceMesh`` of any axes (C order), for
    ``what``; raises TypeError for anything else, and NotImplementedError
    for a mesh over several processes (only ``run_fdtd`` runs across
    processes, as in the JAX package)."""
    check_mesh(mesh, what)
    if mesh.spans_processes:
        raise NotImplementedError(
            f"{what}: a mesh over {len(set(mesh.ranks))} processes; only "
            f"run_fdtd runs across processes, the rest is {ROADMAP_ITEM}")
    return mesh.devices


def decomposition_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The shards that compute an FDTD run on ``mesh``: its "x" and "y"
    axes (either may be missing) at index 0 of every other axis, in (x, y)
    C order. The JAX package runs the same program on every index of
    those other axes; their results would be identical, so here one index
    computes and the rest of the mesh stays idle."""
    order = np.arange(mesh.size).reshape(mesh.shape)
    keep = [a for a in mesh.axis_names if a in ("x", "y")]
    order = order[tuple(slice(None) if a in ("x", "y") else 0
                        for a in mesh.axis_names)]
    if keep == ["y", "x"]:
        order = order.T
    flat = [int(i) for i in order.reshape(-1)]
    nx, ny = mesh_axis_sizes(mesh)
    return DeviceMesh(
        tuple(mesh.devices[i] for i in flat), ("x", "y"), (nx, ny),
        None if mesh.ranks is None else tuple(mesh.ranks[i] for i in flat),
        mesh.group, mesh.rank)


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

    def ghost_moves(self):
        """(source shard, its first plane sent, destination shard, its
        first ghost plane, boundary, direction) of each ghost slab: at
        boundary s the first ``halo`` own planes of shard s + 1 land above
        shard s's (direction 0) and the last of shard s below shard s + 1's
        (direction 1)."""
        h = self.halo
        for s in range(self.n_shards - 1):
            end = self.planes(s) - h  # s's own planes end here
            yield s + 1, h, s, end, s, 0
            yield s, end - h, s + 1, 0, s, 1


def _copy(src, dst) -> None:
    """Slabs ``src`` into ``dst`` (lists of views, one per field of a
    group): one field with one copy; a group stacked into one buffer,
    moved to the destination's device in one transfer and copied with one
    multi-tensor copy."""
    if len(src) == 1:
        dst[0].copy_(src[0], non_blocking=True)
        return
    buf = torch.stack(src).to(dst[0].device, non_blocking=True)
    torch._foreach_copy_(dst, list(buf.unbind(0)))


@dataclass(frozen=True)
class Blocks:
    """The (x, y) decomposition of an FDTD grid: ``x`` slabs of N1 and
    ``y`` slabs of N2 (``XSlabs`` on axes 0 and 1). Shard s of the mesh
    (C order, as ``make_mesh_2d`` lays out its devices) holds x slab
    s // ny and y slab s % ny, its ghost planes included; a 1-D x mesh has
    one y slab and no y ghost planes, a 1-D y mesh one x slab.

    Across processes ``ranks`` holds the process of each shard (None: all
    this process's), ``group`` their process group and ``rank`` this
    process's; a refresh then takes None for each shard of another process
    and exchanges the slabs that cross (``parallel.distributed``).

    An owned cell's axis-aligned stencil reads ghost cells along x or
    along y, never a corner cell that is a ghost along both: corners are
    not refreshed, and hold whatever the shard computed there."""

    x: XSlabs
    y: XSlabs
    ranks: tuple | None = None
    group: object = field(default=None, compare=False, repr=False)
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return self.x.n_shards * self.y.n_shards

    def is_local(self, s: int) -> bool:
        """Whether shard s is this process's."""
        return self.ranks is None or self.ranks[s] == self.rank

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

    def refresh_group(self, groups, tag: int = 0) -> None:
        """Ghost planes along x of a group of same-shaped fields (the
        overlap-and-discard sweeps, on a mesh not cut along y;
        ``groups[s]``: shard s's tensors): at each boundary and in each
        direction the group's slabs move as one buffer (``_copy``, or one
        message across processes); ``tag`` names the group among those a
        sweep refreshes."""
        if self.y.n_shards > 1:
            raise ValueError("refresh_group: the overlap-and-discard sweeps "
                             "run on x meshes only")
        self._refresh(groups, self.x, tag)

    def refresh(self, tensors, axis: int, tag: int = 0) -> None:
        """Ghost planes along ``axis`` (0: x, 1: y) of ``tensors`` (shard
        s's at index s, None for a shard of another process) from their
        neighbours' own planes: at each boundary of each line of the mesh
        the last ``halo`` own planes below it and the first above it. Along
        y a ghost slab is a strided (N1, halo, N3) block: one strided copy
        a boundary and direction. ``tag`` names the field."""
        self._refresh([None if t is None else [t] for t in tensors],
                      self.x if axis == 0 else self.y, tag)

    def _refresh(self, groups, slabs: XSlabs, tag: int) -> None:
        """The ghost slabs along ``slabs``' axis (``groups[s]``: shard s's
        fields, None for another process's): a slab between two shards of
        this process copied on the devices (``_copy``), those that cross
        processes exchanged in one batch, each message tagged by ``tag``,
        the axis, the boundary (line, place) and the direction."""
        h, ax = slabs.halo, slabs.axis
        sends, recvs = [], []
        for li, line in enumerate(self._lines(ax)):
            for src, src_at, dst, dst_at, b, d in slabs.ghost_moves():
                a, c = groups[line[src]], groups[line[dst]]
                if a is not None and c is not None:
                    _copy([t.narrow(ax, src_at, h) for t in a],
                          [t.narrow(ax, dst_at, h) for t in c])
                    continue
                if a is None and c is None:
                    continue
                key = (((tag * 2 + ax) * self.n_shards + li * slabs.n_shards
                        + b) * 2 + d)
                if a is not None:
                    sends.append(([t.narrow(ax, src_at, h) for t in a],
                                  self.ranks[line[dst]], key))
                else:
                    recvs.append(([t.narrow(ax, dst_at, h) for t in c],
                                  self.ranks[line[src]], key))
        if sends or recvs:
            _exchange(sends, recvs, self.group)


def _exchange(sends, recvs, group) -> None:
    """Slabs to and from other processes (``sends`` / ``recvs``: [(views
    of a group's fields, peer rank, tag)]): each group's views staged
    into one contiguous host buffer, the device work that wrote them
    waited for, one ``batch_isend_irecv``, and each received buffer copied
    into its ghost views."""
    t0 = time.perf_counter()
    out = [(distributed.stage(v[0] if len(v) == 1 else torch.stack(v)), r,
            tag) for v, r, tag in sends]
    distributed.synchronize([v[0].device for v, _, _ in sends])
    into = [(distributed.buffer_for(
        (len(v),) * (len(v) > 1) + tuple(v[0].shape), v[0]), r, tag)
        for v, r, tag in recvs]
    t1 = time.perf_counter()
    distributed.exchange(out, into, group)
    t2 = time.perf_counter()
    for (views, _, _), (buf, _, _) in zip(recvs, into):
        if len(views) == 1:
            views[0].copy_(buf, non_blocking=True)
        else:
            torch._foreach_copy_(views, list(
                buf.to(views[0].device, non_blocking=True).unbind(0)))
    stats = distributed.stats
    stats["exchanges"] += 1
    stats["bytes"] += sum(t.numel() * t.element_size() for t, _, _ in out)
    stats["staging"] += t1 - t0
    stats["wire"] += t2 - t1
    stats["seconds"] += time.perf_counter() - t0
