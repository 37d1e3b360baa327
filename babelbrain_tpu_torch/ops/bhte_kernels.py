"""Pennes BHTE steps: CUDA kernels, their wrappers and plain PyTorch versions.

One FTCS step with CEM43 dose and running peak (``csrc/bhte.cu``):

    T' = T + sum_dir k_dir (T_nb - T) irc + perf (T_art - T) [+ Q irc]
    dose += 2^(log2(R) (43 - T')),  R = 0.5 at or above 43 C, 0.25 below
    peak = max(peak, T')

with edge-replicated (adiabatic) neighbours and the six interface
conductivities already scaled by 1/dx^2. ``bhte_fused`` advances K such
steps in one launch of ``bhte_fused_kernel`` (K = 1..``BHTE_K_CAP``),
``bhte_step`` one step in one launch of ``bhte_step_kernel``. Together they
replace the JAX package's Pallas kernel B9 (``babelbrain_tpu/ops/
bhte_pallas.py: build_bhte_fusedK_step``, K steps a streaming sweep); the
update is ``ops/bhte.py:_bhte_scan``'s.

The K-step launch: blocks of ``FUSED_TILE_Z`` x ``fused_tile_y(K)`` owned
(z, y) columns over a segment of x-planes (``fused_launch_geometry``), each
recomputing a K-cell halo of its neighbours (overlap and discard); every
K <= ``BHTE_K_CAP`` fits a block, so no depth is refused for its size.
``BHTE_FUSE_BEST`` is the depth ``ops.bhte.bhte_run`` takes on a card.

The wrappers dispatch on the device of ``T``: CPU tensors run the plain
versions (``bhte_step_ref``; ``bhte_fused_ref``, K calls of it), CUDA
tensors launch the kernel on their device and its current stream (or
raise); a tensor on another device is refused. ``launches`` counts kernel
launches, ``plain_calls`` calls of the plain versions (``bhte_fused_ref``
counts its K ``bhte_step_ref`` calls under ``bhte_step`` too).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .fdtd_kernels import _cdiv

LOG2R_HI = -1.0  # log2(0.5)
LOG2R_LO = -2.0  # log2(0.25)

# steps a launch of bhte_fused_kernel takes at most (the instantiations of
# csrc/bhte.cu bb_bhte_fused; JAX's K_cap, babelbrain_tpu/ops/
# bhte_pallas.py:204)
BHTE_K_CAP = 8
# the depth ops.bhte.bhte_run takes on a card: the fastest K a step of at
# least 2 measured on an H100 at 192x192x240 (PERF.md)
BHTE_FUSE_BEST = 3
# owned cells a block of bhte_fused_kernel<K> along z and y (FusedTile<K>
# in csrc/bhte.cu, checked against it before a depth's first launch):
# extended by K a side, one thread per column, at most 1024 threads
FUSED_TILE_Z = 32


def fused_tile_y(k: int) -> int:
    return 16 if k <= 3 else 8 if k <= 7 else 4


# blocks a K-step launch aims at (one or two resident on each of an H100's
# 132 SMs, several waves): fused_launch_geometry cuts x into segments until
# the grid has as many
FUSED_BLOCKS = 512

launches = {"bhte_step": 0, "bhte_fused": 0}
plain_calls = {"bhte_step": 0, "bhte_fused": 0}


@dataclass
class BHTECoeffs:
    """Step-invariant BHTE inputs: ``k6`` = [kxp, kxm, kyp, kym, kzp, kzm]
    interface conductivities times 1/dx^2, ``irc`` = dt/(rho c), ``perf`` =
    perfusion rate times dt (all float32 volumes on one device)."""

    k6: list
    irc: torch.Tensor
    perf: torch.Tensor


def fused_launch_geometry(shape, k: int):
    """((z-tiles, y-tiles, x-segments), planes a segment) of a K-step
    launch on an (N1, N2, N3) grid: the segment length is the longest that
    gives ``FUSED_BLOCKS`` blocks (each marches its segment plus K planes a
    side), at least 1 plane."""
    n1, n2, n3 = shape
    gz, gy = _cdiv(n3, FUSED_TILE_Z), _cdiv(n2, fused_tile_y(k))
    seg = max(1, min(n1, _cdiv(n1 * gz * gy, FUSED_BLOCKS)))
    return (gz, gy, _cdiv(n1, seg)), seg


# (TZ, TY) of each depth's FusedTile<K> as the built library reports it
_KERNEL_TILES: dict = {}


def _check_tile(k: int) -> None:
    """Refuse a K-step launch whose geometry's tile (``FUSED_TILE_Z`` x
    ``fused_tile_y(K)``) is not the built kernel's ``FusedTile<K>``."""
    if k not in _KERNEL_TILES:
        tz, ty = ctypes.c_int(0), ctypes.c_int(0)
        rc = _build.library().bb_bhte_fused_tile(k, ctypes.byref(tz),
                                                 ctypes.byref(ty))
        _build.check(rc, "bhte_fused_kernel tile")
        _KERNEL_TILES[k] = (tz.value, ty.value)
    own = (FUSED_TILE_Z, fused_tile_y(k))
    if _KERNEL_TILES[k] != own:
        raise RuntimeError(
            f"bhte_fused: csrc/bhte.cu FusedTile<{k}> (TZ, TY) is "
            f"{_KERNEL_TILES[k]}, ops/bhte_kernels.py FUSED_TILE_Z / "
            f"fused_tile_y({k}) give {own}")


def _check_depth(k) -> int:
    if isinstance(k, bool) or int(k) != k or not 1 <= int(k) <= BHTE_K_CAP:
        raise ValueError(f"bhte_fused: {k} steps a launch, 1..{BHTE_K_CAP} "
                         "taken")
    return int(k)


def _check(T, T_out, dose, peak, co: BHTECoeffs, q, name="bhte_step"):
    shape = tuple(T.shape)
    if len(shape) != 3:
        raise ValueError(f"{name}: T must be 3-D, got {shape}")
    vols = [T, T_out, dose, peak, *co.k6, co.irc, co.perf]
    if q is not None:
        vols.append(q)
    if len(co.k6) != 6:
        raise ValueError(f"{name}: k6 must hold six conductivity volumes")
    for t in vols:
        if t.device != T.device or t.dtype != torch.float32:
            raise ValueError(
                f"{name}: every tensor must be float32 on {T.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous {shape} tensor, got "
                f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
            )
    if T_out.data_ptr() == T.data_ptr():
        raise ValueError(f"{name}: T_out must not alias T")
    if T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {T.device}")
    return shape


def bhte_step(T, dose, peak, co: BHTECoeffs, q, t_art: float, T_out=None):
    """One BHTE step. Returns the new temperature (``T_out`` if given, else
    a fresh ``torch.empty`` volume); ``dose`` and ``peak`` update in place.
    ``q`` is the heat map of a heating segment or None while cooling."""
    if T_out is None:
        T_out = torch.empty_like(T)
    n1, n2, n3 = _check(T, T_out, dose, peak, co, q)
    if T.device.type == "cpu":
        return bhte_step_ref(T, dose, peak, co, q, t_art, T_out)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    _build.launch(
        "bb_bhte_step", "bhte_step_kernel", T.device, ptr(T), ptr(T_out),
        ptr(dose), ptr(peak), *(ptr(k) for k in co.k6), ptr(co.irc),
        ptr(co.perf), ptr(q), t_art, n1, n2, n3,
    )
    launches["bhte_step"] += 1
    return T_out


def bhte_fused(T, dose, peak, co: BHTECoeffs, q, t_art: float, K: int,
               T_out=None):
    """K BHTE steps in one launch. Returns the temperature after them
    (``T_out`` if given, else a fresh ``torch.empty`` volume; it must not
    alias ``T``, which stays as it was); ``dose`` and ``peak`` update in
    place, each cell's K increments summed in step order. ``q`` is the heat
    map of a heating segment or None while cooling."""
    k = _check_depth(K)
    if T_out is None:
        T_out = torch.empty_like(T)
    n1, n2, n3 = _check(T, T_out, dose, peak, co, q, name="bhte_fused")
    if T.device.type == "cpu":
        return bhte_fused_ref(T, dose, peak, co, q, t_art, k, T_out)
    if n1 * n2 * n3 >= 2**31:
        raise ValueError(f"bhte_fused: {(n1, n2, n3)} has 2^31 cells or more "
                         "(the kernel computes 32-bit offsets)")
    _check_tile(k)
    grid, seg = fused_launch_geometry((n1, n2, n3), k)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    _build.launch(
        "bb_bhte_fused", "bhte_fused_kernel", T.device, ptr(T), ptr(T_out),
        ptr(dose), ptr(peak), *(ptr(c) for c in co.k6), ptr(co.irc),
        ptr(co.perf), ptr(q), t_art, k, n1, n2, n3, seg, *grid,
    )
    launches["bhte_fused"] += 1
    return T_out


def bhte_fused_ref(T, dose, peak, co: BHTECoeffs, q, t_art: float, K: int,
                   T_out):
    """Plain version of ``bhte_fused_kernel``: K calls of ``bhte_step_ref``
    (what the kernel must equal bit for bit), the last into ``T_out``."""
    k = _check_depth(K)
    plain_calls["bhte_fused"] += 1
    cur = T
    for n in range(k):
        nxt = T_out if n == k - 1 else torch.empty_like(T)
        cur = bhte_step_ref(cur, dose, peak, co, q, t_art, nxt)
    return T_out


def edge_shift(f, offset, axis):
    """f shifted so out[i] = f[clamp(i+offset)] (edge replication)."""
    n = f.shape[axis]
    idx = torch.clamp(torch.arange(n, device=f.device) + offset, 0, n - 1)
    return f.index_select(axis, idx)


def bhte_step_ref(T, dose, peak, co: BHTECoeffs, q, t_art: float, T_out):
    """Plain version of ``bhte_step_kernel`` (same operation order)."""
    plain_calls["bhte_step"] += 1
    kxp, kxm, kyp, kym, kzp, kzm = co.k6
    lap = (
        kxp * (edge_shift(T, 1, 0) - T)
        + kxm * (edge_shift(T, -1, 0) - T)
        + kyp * (edge_shift(T, 1, 1) - T)
        + kym * (edge_shift(T, -1, 1) - T)
        + kzp * (edge_shift(T, 1, 2) - T)
        + kzm * (edge_shift(T, -1, 2) - T)
    )
    T_new = T + lap * co.irc + co.perf * (t_art - T)
    if q is not None:
        T_new = T_new + q * co.irc
    log2r = torch.where(T_new >= 43.0, LOG2R_HI, LOG2R_LO)
    dose.copy_(dose + torch.exp2(log2r * (43.0 - T_new)))
    peak.copy_(torch.maximum(peak, T_new))
    T_out.copy_(T_new)
    return T_out
