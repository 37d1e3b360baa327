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
``rayleigh_kernel`` (several points a thread, the sources staged through
shared memory; ``point_block`` and ``elem_block`` do not apply) or raise.
``rayleigh_sum_grid`` is its grid form: the points of a regular grid given
by its three axes, which the kernel expands on the card (the plain version
builds the points and evaluates them as ``rayleigh_sum_ref`` does); a point
gives the same value in either form, bit for bit. ``launches`` counts kernel
launches (``rayleigh``, ``rayleigh_grid``), ``plain_calls`` calls of the
plain version. With ``mesh`` the points are split over the mesh's devices, in
contiguous runs of whole blocks (``rayleigh_field``) or of whole x planes
(``rayleigh_field_grid``), each integrating every source over its run
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

launches = {"rayleigh": 0, "rayleigh_grid": 0}
plain_calls = {"rayleigh": 0, "rayleigh_grid": 0}


def _check(dev, *named):
    """Raise unless every (name, tensor, dtype) is contiguous on ``dev``."""
    for name, t, dtype in named:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"rayleigh: {name} must be contiguous {dtype} on {dev}, got "
                f"{t.dtype} on {t.device}")


def _sources(dev, centers, w):
    """Check the sources and return the device's type ("cpu" or "cuda")."""
    _check(dev, ("centers", centers, torch.float32),
           ("w", w, torch.complex64))
    if (centers.ndim != 2 or centers.shape[1] != 3
            or tuple(w.shape) != (centers.shape[0],)):
        raise ValueError(
            f"rayleigh: centers {tuple(centers.shape)}, w {tuple(w.shape)}: "
            "expected (M, 3), (M,)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rayleigh: unsupported device {dev}")
    if centers.shape[0] >= 2**31:
        raise ValueError(f"rayleigh: {centers.shape[0]} sources exceed int32")
    return dev.type


def rayleigh_sum(kr, ki, centers, w, points, point_block=4096,
                 elem_block=8192):
    """sum_m w_m exp(-ki r_pm) exp(-i kr r_pm) / r_pm at each point, on the
    device of the tensors (``centers`` (M, 3) and ``points`` (P, 3)
    contiguous float32, ``w`` (M,) complex64); returns (P,) complex64."""
    dev = points.device
    _check(dev, ("points", points, torch.float32))
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"rayleigh: points {tuple(points.shape)}: expected "
                         "(P, 3)")
    if _sources(dev, centers, w) == "cpu":
        return rayleigh_sum_ref(kr, ki, centers, w, points, point_block,
                                elem_block)
    out = torch.zeros(points.shape[0], dtype=torch.complex64, device=dev)
    if points.shape[0] == 0:
        return out
    _build.launch("bb_rayleigh", "rayleigh_kernel", dev, _ptr(points),
                  _ptr(centers), _ptr(w), _ptr(out), -kr, ki,
                  points.shape[0], centers.shape[0])
    launches["rayleigh"] += 1
    return out


def grid_points(x, y, z):
    """The (N1 N2 N3, 3) points of the grid of axes ``x``, ``y``, ``z`` in
    C order, on their device (the points ``rayleigh_sum_grid`` sums at)."""
    xp, yp, zp = torch.meshgrid(x, y, z, indexing="ij")
    return torch.stack([xp.reshape(-1), yp.reshape(-1), zp.reshape(-1)], 1)


def rayleigh_sum_grid(kr, ki, centers, w, x, y, z, point_block=4096,
                      elem_block=8192):
    """``rayleigh_sum`` at the points of the (N1, N2, N3) grid of the axes
    ``x``, ``y``, ``z`` (1-D contiguous float32 on the sources' device), in
    C order: returns (N1 N2 N3,) complex64, bit for bit what
    ``rayleigh_sum`` gives at ``grid_points(x, y, z)``."""
    dev = x.device
    for name, a in (("x", x), ("y", y), ("z", z)):
        _check(dev, (name, a, torch.float32))
        if a.ndim != 1:
            raise ValueError(f"rayleigh: axis {name} {tuple(a.shape)}: "
                             "expected 1-D")
    n1, n2, n3 = len(x), len(y), len(z)
    if n1 * n2 * n3 >= 2**62 or n2 * n3 >= 2**31:
        raise ValueError(f"rayleigh: grid {(n1, n2, n3)} too large")
    if _sources(dev, centers, w) == "cpu":
        plain_calls["rayleigh_grid"] += 1
        return _sum_ref(kr, ki, centers, w, grid_points(x, y, z),
                        point_block, elem_block)
    out = torch.zeros(n1 * n2 * n3, dtype=torch.complex64, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("bb_rayleigh_grid", "rayleigh_kernel<GRID>", dev, _ptr(x),
                  _ptr(y), _ptr(z), n1, n2, n3, _ptr(centers), _ptr(w),
                  _ptr(out), -kr, ki, centers.shape[0])
    launches["rayleigh_grid"] += 1
    return out


def rayleigh_sum_ref(kr, ki, centers, w, points, point_block=4096,
                     elem_block=8192):
    """Plain version of ``rayleigh_kernel``: blocked evaluation on the
    tensors' device, the complex products at full float32 precision (TF32
    off for the call, restored after it); returns (P,) complex64."""
    plain_calls["rayleigh"] += 1
    return _sum_ref(kr, ki, centers, w, points, point_block, elem_block)


def _sum_ref(kr, ki, centers, w, points, point_block, elem_block):
    """``rayleigh_sum_ref``'s evaluation, not counted."""
    P = points.shape[0]
    M = centers.shape[0]
    out = torch.empty(P, dtype=points.dtype.to_complex(),
                      device=points.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for p0 in range(0, P, point_block):
            pts = points[p0 : p0 + point_block]
            acc = torch.zeros(pts.shape[0], dtype=out.dtype,
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
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _prep(wavenumber, centers, areas, u0, lo, hi):
    """(kr, ki, centers shifted float32, w, mid): the midpoint of the
    sources and of the points' extrema ``lo`` / ``hi`` (float32
    conditioning) and w complex64 with the (i k / 2 pi) prefactor and the
    areas folded into u0; the host work is float64."""
    kr = float(np.real(wavenumber))
    ki = float(np.imag(wavenumber))
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    u0 = np.asarray(u0, np.complex128).reshape(-1)
    areas = np.asarray(areas, np.float64).reshape(-1)
    lo = np.minimum(centers.min(0), lo) if len(centers) else lo
    hi = np.maximum(centers.max(0), hi) if len(centers) else hi
    mid = (lo + hi) * 0.5
    pref = 1j * (kr + 1j * ki) / (2.0 * np.pi)
    w = (u0 * areas * pref).astype(np.complex64)
    return kr, ki, (centers - mid).astype(np.float32), w, mid


def sum_inputs(wavenumber, centers, areas, u0, points):
    """The arguments ``rayleigh_field`` hands ``rayleigh_sum``: (kr, ki,
    centers, w, points), the coordinates float32 numpy shifted to the
    midpoint of sources and points (for float32 conditioning), w complex64
    with the (i k / 2 pi) prefactor and the areas folded into u0. The host
    work is float64."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if len(points):
        lo, hi = points.min(0), points.max(0)
    else:
        lo = hi = np.asarray(centers, np.float64).reshape(-1, 3).min(0)
    kr, ki, centers, w, mid = _prep(wavenumber, centers, areas, u0, lo, hi)
    return kr, ki, centers, w, (points - mid).astype(np.float32)


def grid_inputs(wavenumber, centers, areas, u0, x, y, z):
    """The arguments ``rayleigh_field_grid`` hands ``rayleigh_sum_grid``:
    (kr, ki, centers, w, (x, y, z)), each axis taken as float32 (as a
    float32 meshgrid of it would hold it), shifted in float64 by the
    midpoint ``sum_inputs`` takes for the grid's points and cast to
    float32, so every point's coordinates are those ``sum_inputs`` gives
    it."""
    axes = [np.asarray(a).reshape(-1).astype(np.float32).astype(np.float64)
            for a in (x, y, z)]
    if all(len(a) for a in axes):
        lo = np.array([a.min() for a in axes])
        hi = np.array([a.max() for a in axes])
    else:
        lo = hi = np.asarray(centers, np.float64).reshape(-1, 3).min(0)
    kr, ki, centers, w, mid = _prep(wavenumber, centers, areas, u0, lo, hi)
    return kr, ki, centers, w, tuple((a - m).astype(np.float32)
                                     for a, m in zip(axes, mid))


def _devices(mesh, device, who):
    return ((torch.device(device),) if mesh is None
            else mesh_devices(mesh, who))


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
    devices = _devices(mesh, device, "rayleigh_field")
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


def rayleigh_field_grid(wavenumber, centers, areas, u0, x, y, z, *,
                        point_block: int = 4096, elem_block: int = 8192,
                        mesh=None, device="cuda"):
    """Evaluate the Rayleigh integral on the full (len(x), len(y), len(z))
    grid of the axes (m), the reference's meshgrid order
    (`BabelIntegrationSingle.py:290-297`); returns the complex64 numpy
    volume, bit for bit ``rayleigh_field`` at the grid's float32 points.
    The points are built on the device from the axes (``grid_inputs``,
    ``rayleigh_sum_grid``). ``mesh``: the x planes are split over its
    devices in contiguous runs of whole planes."""
    devices = _devices(mesh, device, "rayleigh_field_grid")
    kr, ki, centers, w, (xs, ys, zs) = grid_inputs(wavenumber, centers,
                                                   areas, u0, x, y, z)
    n1, n2, n3 = len(xs), len(ys), len(zs)
    run = max(1, -(-n1 // len(devices)))
    parts = [
        rayleigh_sum_grid(
            kr, ki, torch.as_tensor(centers, device=dev),
            torch.as_tensor(w, device=dev),
            torch.as_tensor(xs[d * run:(d + 1) * run], device=dev),
            torch.as_tensor(ys, device=dev), torch.as_tensor(zs, device=dev),
            point_block, elem_block,
        )
        for d, dev in enumerate(devices) if d * run < n1
    ]  # every device's work is queued before the first readback
    if not parts:
        return np.zeros((n1, n2, n3), np.complex64)
    return np.concatenate([p.cpu().numpy() for p in parts]).reshape(
        n1, n2, n3)


def rayleigh_field_volume(wavenumber, tx, u0, x, y, z, **kw):
    """Evaluate on a full (len(x), len(y), len(z)) grid; returns complex64 volume.

    Grid layout matches the reference's meshgrid ordering
    (`BabelIntegrationSingle.py:290-297`).
    """
    return rayleigh_field_grid(wavenumber, tx.centers, tx.areas, u0, x, y, z,
                               **kw)


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
