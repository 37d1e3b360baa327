"""Several processes in one run: the counterpart of ``jax.distributed``.

The JAX package runs ``run_fdtd(mesh=)`` across processes by giving every
process the full arrays (``jax.device_put`` with a ``NamedSharding``, each
process keeping its addressable shards) and gathering the results with
``multihost_utils.process_allgather(tiled=True)``
(`babelbrain_tpu/ops/fdtd.py:1518-1546`). Here the processes meet in a
``torch.distributed`` process group (``initialize``, or ``torchrun``'s
``env://`` followed by ``initialize("env://", ...)``); a mesh made with
``group=`` (``parallel.halo.make_mesh``) records the process of each
shard, and the ghost planes that cross a process boundary travel through
``exchange`` while those between two shards of one process stay device
copies.

Transport: gloo, which is handed CPU tensors only. A CUDA slab is copied
to pinned host memory after the device work that wrote it, sent, and the
received slab copied back to the device. NCCL is refused
(``NotImplementedError`` naming ROADMAP Queue A item 6c): two ranks cannot
share one card under NCCL, and the peer path across cards is that item's.
It is never replaced by gloo behind the caller's back.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# the ROADMAP item that holds NCCL and the peer path across cards
NCCL_ITEM = "ROADMAP Queue A item 6c"
# what the cross-process exchanges of this process cost: the batches
# posted, the bytes sent, and host seconds: in all (from staging the first
# send to queueing the last received slab's copy), staging the sends (their
# copies queued and the device work that writes them waited for), and on
# the wire (posting the batch to its last message received, the peer's
# lateness included)
stats = {"exchanges": 0, "bytes": 0, "seconds": 0.0, "staging": 0.0,
         "wire": 0.0}


def reset_stats() -> None:
    stats.update(exchanges=0, bytes=0, seconds=0.0, staging=0.0, wire=0.0)


def check_backend(backend) -> None:
    """Refuse a backend other than gloo (NCCL: ``NotImplementedError``)."""
    name = str(backend).lower()
    if name == "nccl":
        raise NotImplementedError(
            "a process group on NCCL: two ranks cannot share one card under "
            f"NCCL, and the peer path across cards is {NCCL_ITEM}; use gloo")
    if name != "gloo":
        raise ValueError(f"unsupported process-group backend {backend!r} "
                         "(gloo only)")


def initialize(init_method: str, world_size: int, rank: int,
               backend: str = "gloo", timeout: float = 300.0):
    """Join the process group of a multi-process run (the counterpart of
    ``jax.distributed.initialize``): ``init_method`` a ``file://`` path
    (tests: a file under a temporary directory), ``tcp://host:port`` or
    ``env://`` (``torchrun``). Returns the group (``dist.group.WORLD``).
    ``timeout`` (seconds) bounds every collective and exchange, so a dead
    peer fails the survivors instead of hanging them."""
    check_backend(backend)
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def check_group(group) -> None:
    """Refuse a process group that is not gloo."""
    check_backend(dist.get_backend(group))


def process_count(group=None) -> int:
    """Processes in ``group`` (the default group), 1 when none is set up."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def process_index(group=None) -> int:
    """This process's rank in ``group``, 0 when none is set up."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def all_gather_object(obj, group) -> list:
    """``obj`` of every process of ``group``, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather_blocks(blocks, shape, counts, group) -> list:
    """The blocks of every process, in rank order: ``blocks`` this
    process's (CPU float32 tensors of ``shape``, maybe none), ``counts``
    how many each process holds. One all-gather of each process's blocks
    stacked and padded to the largest count."""
    like = torch.zeros((max(counts),) + tuple(shape), dtype=torch.float32)
    mine = like.clone()
    for j, b in enumerate(blocks):
        mine[j] = b
    out = [like.clone() for _ in counts]
    dist.all_gather(out, mine, group=group)
    return [b for r, n in enumerate(counts) for b in out[r][:n]]


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group`` (P2POp takes global
    ranks)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def exchange(sends, recvs, group) -> None:
    """One ``batch_isend_irecv`` of contiguous CPU buffers, then a wait for
    all of it: ``sends`` [(tensor, peer rank, tag)], ``recvs`` [(buffer,
    peer rank, tag)], ranks of ``group``. Tags tell apart the messages
    between one pair of processes."""
    ops = [dist.P2POp(dist.isend, t, _peer(group, r), group, tag)
           for t, r, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, _peer(group, r), group, tag)
            for t, r, tag in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def stage(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``tensor`` to send (pinned host memory for
    a CUDA tensor, queued on its device's current stream: the caller
    synchronizes that stream before sending)."""
    if tensor.device.type == "cuda":
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        return host
    return tensor.clone(memory_format=torch.contiguous_format)


def buffer_for(shape, like: torch.Tensor) -> torch.Tensor:
    """An empty CPU buffer of ``shape`` to receive what lands in ``like``'s
    dtype and device (pinned for a CUDA tensor)."""
    return torch.empty(tuple(shape), dtype=like.dtype,
                       pin_memory=like.device.type == "cuda")


def synchronize(devices) -> None:
    """Wait for the current streams of the CUDA ``devices``."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
