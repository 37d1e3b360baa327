"""Pennes BHTE step: CUDA kernel, its wrapper and plain PyTorch version.

One FTCS step with CEM43 dose and running peak (``csrc/bhte.cu``):

    T' = T + sum_dir k_dir (T_nb - T) irc + perf (T_art - T) [+ Q irc]
    dose += 2^(log2(R) (43 - T')),  R = 0.5 at or above 43 C, 0.25 below
    peak = max(peak, T')

with edge-replicated (adiabatic) neighbours and the six interface
conductivities already scaled by 1/dx^2. It replaces the JAX package's
Pallas kernel B9 (``babelbrain_tpu/ops/bhte_pallas.py:
build_bhte_fusedK_step``); the update is ``ops/bhte.py:_bhte_scan``'s.

The wrapper dispatches on the device of ``T``: CPU tensors run the plain
version ``bhte_step_ref``, CUDA tensors launch the kernel on their device
and its current stream (or raise); a tensor on another device is refused. ``launches`` counts kernel launches, ``plain_calls``
calls of the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

LOG2R_HI = -1.0  # log2(0.5)
LOG2R_LO = -2.0  # log2(0.25)

launches = {"bhte_step": 0}
plain_calls = {"bhte_step": 0}


@dataclass
class BHTECoeffs:
    """Step-invariant BHTE inputs: ``k6`` = [kxp, kxm, kyp, kym, kzp, kzm]
    interface conductivities times 1/dx^2, ``irc`` = dt/(rho c), ``perf`` =
    perfusion rate times dt (all float32 volumes on one device)."""

    k6: list
    irc: torch.Tensor
    perf: torch.Tensor


def _check(T, T_out, dose, peak, co: BHTECoeffs, q):
    shape = tuple(T.shape)
    if len(shape) != 3:
        raise ValueError(f"bhte_step: T must be 3-D, got {shape}")
    vols = [T, T_out, dose, peak, *co.k6, co.irc, co.perf]
    if q is not None:
        vols.append(q)
    if len(co.k6) != 6:
        raise ValueError("bhte_step: k6 must hold six conductivity volumes")
    for t in vols:
        if t.device != T.device or t.dtype != torch.float32:
            raise ValueError(
                f"bhte_step: every tensor must be float32 on {T.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"bhte_step: expected a contiguous {shape} tensor, got "
                f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
            )
    if T_out.data_ptr() == T.data_ptr():
        raise ValueError("bhte_step: T_out must not alias T")
    if T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bhte_step: unsupported device {T.device}")
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
