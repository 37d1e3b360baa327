"""Rayleigh-Sommerfeld integral propagator: CUDA kernel, wrapper and plain
PyTorch version.

Computes the monochromatic field radiated by M source patches at P field
points:

    p(x_p) = (i k / 2 pi) * sum_m  u0_m * ds_m * exp(-i k r_pm) / r_pm

with complex wavenumber ``k = 2 pi f / c + i alpha`` (imaginary part =
attenuation in Np/m). With ``u0`` in pressure units (rho c v), this
normalization reproduces the exact on-axis piston solution
``p(z) = u0 (e^{-ikz} - e^{-ikR})``.

Counterpart of ``babelbrain_tpu/ops/rayleigh.py``, which has no TPU kernel
(XLA matmuls). Differences from the JAX version: pair distances are direct
coordinate differences (the JAX package expands ``|p|^2 - 2 p.c + |c|^2``
for the TPU's matrix unit, which cancels in float32), and the sum over
sources is taken at full float32 precision (TF32 is switched off for every
call: the phases reach k r ~ 1e3 rad).

``rayleigh_sum`` dispatches on the device of the points: CPU tensors run
the plain version (``rayleigh_sum_ref``: field points in blocks, so memory
stays at O(point_block * elem_block), each block a complex64
matrix-vector product), CUDA tensors launch ``csrc/rayleigh.cu``
``rayleigh_kernel`` (one thread a point, the sources staged through shared
memory; ``point_block`` and ``elem_block`` do not apply) or raise.
``launches`` counts kernel launches, ``plain_calls`` calls of the plain
version. With ``mesh`` the points are split in contiguous runs of whole
blocks over the mesh's devices, each integrating every source over its run
(JAX's point sharding, `babelbrain_tpu/ops/rayleigh.py:148-175`); a point's
value does not depend on the other points of its call, so the field is the
unsharded one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.halo import mesh_devices
from . import _build
from .fdtd_kernels import _ptr

launches = {"rayleigh": 0}
plain_calls = {"rayleigh": 0}


def rayleigh_sum(kr, ki, centers, w, points, point_block=4096,
                 elem_block=8192):
    """sum_m w_m exp(-ki r_pm) exp(-i kr r_pm) / r_pm at each point, on the
    device of the tensors (``centers`` (M, 3) and ``points`` (P, 3)
    contiguous float32, ``w`` (M,) complex64); returns (P,) complex64."""
    dev = points.device
    for name, t, dtype in (("centers", centers, torch.float32),
                           ("w", w, torch.complex64),
                           ("points", points, torch.float32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"rayleigh: {name} must be contiguous {dtype} on {dev}, got "
                f"{t.dtype} on {t.device}")
    if (centers.ndim != 2 or centers.shape[1] != 3 or points.ndim != 2
            or points.shape[1] != 3 or tuple(w.shape) != (centers.shape[0],)):
        raise ValueError(
            f"rayleigh: centers {tuple(centers.shape)}, w {tuple(w.shape)}, "
            f"points {tuple(points.shape)}: expected (M, 3), (M,), (P, 3)")
    if dev.type == "cpu":
        return rayleigh_sum_ref(kr, ki, centers, w, points, point_block,
                                elem_block)
    if dev.type != "cuda":
        raise ValueError(f"rayleigh: unsupported device {dev}")
    if centers.shape[0] >= 2**31:
        raise ValueError(f"rayleigh: {centers.shape[0]} sources exceed int32")
    out = torch.zeros(points.shape[0], dtype=torch.complex64, device=dev)
    if points.shape[0] == 0:
        return out
    _build.launch("bb_rayleigh", "rayleigh_kernel", dev, _ptr(points),
                  _ptr(centers), _ptr(w), _ptr(out), kr, ki,
                  points.shape[0], centers.shape[0])
    launches["rayleigh"] += 1
    return out


def rayleigh_sum_ref(kr, ki, centers, w, points, point_block=4096,
                     elem_block=8192):
    """Plain version of ``rayleigh_kernel``: blocked evaluation on the
    tensors' device; returns (P,) complex64."""
    plain_calls["rayleigh"] += 1
    P = points.shape[0]
    M = centers.shape[0]
    out = torch.empty(P, dtype=torch.complex64, device=points.device)
    for p0 in range(0, P, point_block):
        pts = points[p0 : p0 + point_block]
        acc = torch.zeros(pts.shape[0], dtype=torch.complex64,
                          device=points.device)
        for e0 in range(0, M, elem_block):
            c = centers[e0 : e0 + elem_block]
            r2 = torch.square(pts[:, 0:1] - c[:, 0])
            r2 += torch.square(pts[:, 1:2] - c[:, 1])
            r2 += torch.square(pts[:, 2:3] - c[:, 2])
            r = torch.sqrt(r2.clamp_min_(1e-12))
            decay = torch.reciprocal(r)
            if ki != 0.0:
                decay *= torch.exp(-ki * r)
            a = torch.polar(decay, r.mul_(-kr))
            acc += a @ w[e0 : e0 + elem_block]
        out[p0 : p0 + point_block] = acc
    return out


def sum_inputs(wavenumber, centers, areas, u0, points):
    """The arguments ``rayleigh_field`` hands ``rayleigh_sum``: (kr, ki,
    centers, w, points), the coordinates float32 numpy shifted to the
    midpoint of sources and points (for float32 conditioning), w complex64
    with the (i k / 2 pi) prefactor and the areas folded into u0. The host
    work is float64."""
    kr = float(np.real(wavenumber))
    ki = float(np.imag(wavenumber))
    centers = np.asarray(centers, np.float64)
    points = np.asarray(points, np.float64)
    u0 = np.asarray(u0, np.complex128).reshape(-1)
    areas = np.asarray(areas, np.float64).reshape(-1)
    allpts = np.concatenate([centers, points])
    mid = (allpts.min(0) + allpts.max(0)) * 0.5
    pref = 1j * (kr + 1j * ki) / (2.0 * np.pi)
    w = (u0 * areas * pref).astype(np.complex64)
    return (kr, ki, (centers - mid).astype(np.float32), w,
            (points - mid).astype(np.float32))


def rayleigh_field(
    wavenumber: complex,
    centers,
    areas,
    u0,
    points,
    *,
    point_block: int = 4096,
    elem_block: int = 8192,
    mesh=None,
    device="cuda",
):
    """Evaluate the Rayleigh integral at ``points``.

    Parameters
    ----------
    wavenumber : complex
        k = 2 pi f / c + i alpha (alpha in Np/m).
    centers : (M, 3) source patch centers (m).
    areas : (M,) patch areas (m^2).
    u0 : (M,) complex surface pressure amplitudes (Pa).
    points : (P, 3) field points (m).
    mesh : optional 1-D ``DeviceMesh`` (``parallel.halo.make_mesh``): the
        points are split over its devices in contiguous runs of whole
        ``point_block`` blocks (``device`` is then not used).
    device : where the evaluation runs.

    Returns
    -------
    (P,) complex64 numpy pressure field.
    """
    devices = ((torch.device(device),) if mesh is None
               else mesh_devices(mesh, "rayleigh_field"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kr, ki, centers, w, points = sum_inputs(wavenumber, centers, areas, u0,
                                            points)
    # each device's run of points: whole blocks, the last one ragged
    n_blocks = -(-len(points) // point_block)
    run = -(-n_blocks // len(devices)) * point_block
    parts = [
        rayleigh_sum(
            kr, ki, torch.as_tensor(centers, device=dev),
            torch.as_tensor(w, device=dev),
            torch.as_tensor(points[d * run:(d + 1) * run], device=dev),
            point_block, elem_block,
        )
        for d, dev in enumerate(devices) if d * run < len(points)
    ]  # every device's work is queued before the first readback
    if not parts:
        return np.zeros(0, np.complex64)
    return np.concatenate([p.cpu().numpy() for p in parts])


def rayleigh_field_volume(wavenumber, tx, u0, x, y, z, **kw):
    """Evaluate on a full (len(x), len(y), len(z)) grid; returns complex64 volume.

    Grid layout matches the reference's meshgrid ordering
    (`BabelIntegrationSingle.py:290-297`).
    """
    xp, yp, zp = np.meshgrid(
        np.asarray(x), np.asarray(y), np.asarray(z), indexing="ij"
    )
    pts = np.stack([xp.ravel(), yp.ravel(), zp.ravel()], axis=1).astype(np.float32)
    field = rayleigh_field(wavenumber, tx.centers, tx.areas, u0, pts, **kw)
    return np.asarray(field).reshape(len(x), len(y), len(z))


def steering_phases(
    wavenumber: complex,
    elem_centers,
    target,
    spatial_step: float = 1e-3,
    device="cuda",
):
    """Conjugate-phase element programming toward ``target``.

    Backward-propagates a virtual point source at the steered target to the
    element centers and conjugates (`BabelIntegrationCONCAVE_PHASEDARRAY.py:292-314`).
    Returns complex per-element weights (unit-amplitude phases).
    """
    target = np.asarray(target, np.float32).reshape(1, 3)
    u_back = rayleigh_field(
        wavenumber,
        target,
        np.array([spatial_step**2], np.float32),
        np.array([1.0 + 0j], np.complex64),
        np.asarray(elem_centers, np.float32),
        device=device,
    )
    conj = np.conjugate(np.asarray(u_back))
    return np.exp(1j * np.angle(conj)).astype(np.complex64)


def expand_element_weights(tx, elem_weights):
    """Broadcast per-element complex weights to per-sub-element u0."""
    ew = np.asarray(elem_weights, np.complex64)
    return ew[np.asarray(tx.elem_ids)]
