"""Rigid MRI/CT <-> T1 coregistration (the elastix-subprocess replacement).

Counterpart of ``babelbrain_tpu/pipeline/coreg.py`` in PyTorch. The
reference shells out to the external elastix binary with a rigid parameter
file (`BabelBrain/CTZTEProcessing.py:111`, `ExternalBin/elastix/rigid.txt`);
here it is an optimization over 6 rigid parameters with a differentiable
trilinear resampler. ``torch.autograd`` gives exact gradients of the
similarity metric (the parameters are the only leaf that requires one), and
a multi-resolution Adam loop (optax.adam's arithmetic), a derivative-free
coordinate descent and a terminal normalized-gradient-fields polish
converge on the device.

Metrics: normalized cross-correlation on gradient-magnitude images (edge
alignment, insensitive to the CT<->MR intensity relationship) or
Parzen-window mutual information (``metric='mi'``), the multi-modal metric
class of the reference's elastix config (Mattes MI).

Everything runs in float32 on ``device``, in the JAX function's arithmetic
order; its fixed-grid coordinates are built once per pyramid level, and
only the interior that the metrics read (``_interior``) is resampled. Each
host read of a loss value (``float``) waits for the device: the descent
takes an improvement at once, so its candidates run one by one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.imaging import interpolate

# Failure-detection thresholds on register_rigid(return_quality=True)'s
# final-level similarity, calibrated by the JAX package's convergence-radius
# harness (tests/test_registration_robustness.py): on CT<->T1-like phantom
# pairs every converged registration scored well above, and every
# diverged / wrong-anatomy registration well below, these values.
QUALITY_THRESHOLD = {"ncc": 0.55, "mi": 0.25}


def registration_ok(quality: float, metric: str = "ncc") -> bool:
    """True when a registration's quality score clears the calibrated
    failure-detection threshold (the reference has no equivalent: elastix
    failures are silently consumed)."""
    return float(quality) >= QUALITY_THRESHOLD[metric]


def _full_fp32():
    """Matrix products at full float32 (no TF32), as the JAX package
    computes them on the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mat3(rows):
    return torch.stack([torch.stack(r) for r in rows])


def euler_matrix(rx, ry, rz):
    """Rz @ Ry @ Rx of three angles (radians): numbers or 0-d float32
    tensors, whose autograd graph the matrix keeps."""
    rx, ry, rz = (torch.as_tensor(a, dtype=torch.float32) for a in (rx, ry, rz))
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    Rx = _mat3([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = _mat3([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = _mat3([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return Rz @ Ry @ Rx


def _base_grid(shape, center, interior=False):
    """(3, P) float32 voxel coordinates of a fixed grid relative to
    ``center``: every voxel, or with ``interior`` the ``_interior`` block
    in its C order."""
    axes = [torch.arange(n, dtype=torch.float32, device=center.device)
            for n in shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))
    if interior:
        grid = grid[(slice(None),) + _interior_slices(shape)]
    return grid.reshape(3, -1) - center[:, None]


def _warp(moving, params, pts, center):
    """``moving`` sampled at the rigid transform of the grid points ``pts``
    (relative to ``center``): flat (P,)."""
    R = euler_matrix(params[0], params[1], params[2])
    src = R @ pts + center[:, None] + params[3:6, None]
    return interpolate(moving, src, order=1)


def _resample_rigid(moving, params, shape, center):
    """Sample ``moving`` at rigid-transformed coordinates of the fixed grid."""
    return _warp(moving, params, _base_grid(shape, center), center).reshape(
        tuple(shape))


def _ncc(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return torch.sum(a * b) / torch.sqrt(
        torch.sum(a * a) * torch.sum(b * b) + 1e-12)


def _mutual_information(a, b, bins: int = 32):
    """Differentiable Parzen-window (soft-binned) mutual information.

    Inputs are min-max normalized into [0, 1]; a Gaussian window one bin
    wide keeps the joint histogram smooth so gradients exist. The joint
    histogram is a matrix product at full float32.
    """
    _full_fp32()
    av = a.reshape(-1)
    bv = b.reshape(-1)
    av = (av - av.min()) / (av.max() - av.min() + 1e-9)
    bv = (bv - bv.min()) / (bv.max() - bv.min() + 1e-9)
    centers = torch.linspace(0.0, 1.0, bins, device=av.device)
    sig = 1.0 / bins
    wa = torch.exp(-0.5 * ((av[:, None] - centers[None, :]) / sig) ** 2)
    wb = torch.exp(-0.5 * ((bv[:, None] - centers[None, :]) / sig) ** 2)
    wa = wa / (wa.sum(dim=1, keepdim=True) + 1e-12)
    wb = wb / (wb.sum(dim=1, keepdim=True) + 1e-12)
    pab = (wa.T @ wb) / av.shape[0]
    pa = pab.sum(dim=1)
    pb = pab.sum(dim=0)
    return torch.sum(
        pab * (torch.log(pab + 1e-12)
               - torch.log(pa[:, None] * pb[None, :] + 1e-12))
    )


def _gradients(v):
    """``jnp.gradient`` along each axis: central differences, one-sided at
    the edges (edge order 1)."""
    return torch.gradient(v, dim=(0, 1, 2))


def _grad_mag(v):
    gx, gy, gz = _gradients(v)
    return torch.sqrt(gx * gx + gy * gy + gz * gz)


def _ngf(a, b, eps):
    """Normalized-gradient-fields similarity (Haber & Modersitzki): the
    mean squared cosine between the two images' gradient directions.
    Orientation alignment only, insensitive to the bias-field modulation of
    gradient magnitudes that biases gradient-NCC by ~2 deg on the
    robustness phantom (the terminal polish runs on it for that reason)."""
    ga = torch.stack(_gradients(a))
    gb = torch.stack(_gradients(b))
    na = torch.sqrt((ga * ga).sum(0) + eps * eps)
    nb = torch.sqrt((gb * gb).sum(0) + eps * eps)
    d = (ga * gb).sum(0) / (na * nb)
    return (d * d).mean()


def _interior_slices(shape, frac: float = 0.14):
    return tuple(slice(int(frac * n), n - int(frac * n)) for n in shape)


def _interior(v, frac: float = 0.14):
    """Crop a border fraction before computing the similarity.

    Rotated/translated warps pull zero padding in from the array corners;
    including those regions in the metric penalizes every non-identity
    transform and biases the optimum toward zero.
    """
    return v[_interior_slices(v.shape, frac)]


def _downsample(v, f):
    if f == 1:
        return v
    n = [(s // f) * f for s in v.shape]
    v = v[: n[0], : n[1], : n[2]]
    return v.reshape(n[0] // f, f, n[1] // f, f, n[2] // f, f).mean(
        dim=(1, 3, 5))


def _standardize(v):
    return (v - v.mean()) / (v.std(correction=0) + 1e-6)


class _Level:
    """One pyramid level's objective: ``-similarity(warp(moving), fixed)``
    over the fixed image's interior, with that interior's grid built once.
    Counts loss evaluations and host reads in ``counts``."""

    def __init__(self, fixed, moving, factor, similarity, counts):
        self.moving = moving
        self.factor = factor
        self.similarity = similarity
        self.counts = counts
        self.center = torch.as_tensor(
            np.array(fixed.shape, np.float32) / 2.0, device=fixed.device)
        self.fixed_in = _interior(fixed)
        self.pts = _base_grid(fixed.shape, self.center, interior=True)

    def loss(self, p):
        # rotations are scale-free; translations are kept in full-res
        # voxels and divided by the pyramid factor at this level
        self.counts["evals"] += 1
        p_level = torch.cat([p[:3], p[3:] / self.factor])
        warped = _warp(self.moving, p_level, self.pts, self.center)
        return -self.similarity(warped.reshape(self.fixed_in.shape),
                                self.fixed_in)

    def value(self, p_np):
        """The loss at float64 host parameters (rounded to float32), read
        back to the host."""
        p = torch.as_tensor(np.asarray(p_np, np.float32),
                            device=self.moving.device)
        with torch.no_grad():
            v = self.loss(p)
        self.counts["syncs"] += 1
        return float(v)


def _adam(loss, p, lr, steps, b1=0.9, b2=0.999, eps=1e-8):
    """``steps`` Adam steps on the leaf ``p`` in place, in optax.adam's
    arithmetic (bias-corrected moments, eps outside the square root). The
    device holds the moments and reads nothing back. Written out because
    constructing ``torch.optim.Adam`` imports ``torch._dynamo``, which made
    the first registration of a process 10.3 s against 3.8 s on an H100
    host (``chip_smoke.py`` slice coreg-zte), for six parameters."""
    mu = torch.zeros_like(p)
    nu = torch.zeros_like(p)
    for t in range(1, steps + 1):
        (g,) = torch.autograd.grad(loss(p), p)
        with torch.no_grad():
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            p -= lr * ((mu / (1 - b1 ** t))
                       / (torch.sqrt(nu / (1 - b2 ** t)) + eps))


def _descend(level, p_np, best_val, steps, margin):
    """Derivative-free coordinate descent: per step size, up to 4 sweeps of
    +-step on each parameter, taking any improvement beyond ``margin`` at
    once. Returns (params, loss)."""
    for step_deg, step_vox in steps:
        improved = True
        sweeps = 0
        while improved and sweeps < 4:
            improved = False
            sweeps += 1
            for ax in range(6):
                d = np.deg2rad(step_deg) if ax < 3 else step_vox
                for sgn in (+1.0, -1.0):
                    cand = p_np.copy()
                    cand[ax] += sgn * d
                    v = level.value(cand)
                    if v < best_val - margin:
                        best_val = v
                        p_np = cand
                        improved = True
    return p_np, best_val


def _parabolic_polish(level, p_np, best_val):
    """Per-parameter parabolic line fits at 0.25 and 0.1 deg (twice the
    step in voxels), falling back to the better neighbour where the loss is
    not locally convex."""
    for step_deg in (0.25, 0.1):
        for _ in range(2):
            for ax in range(6):
                d = np.deg2rad(step_deg) if ax < 3 else step_deg * 2
                cm = p_np.copy()
                cm[ax] -= d
                cp = p_np.copy()
                cp[ax] += d
                vm = level.value(cm)
                vp = level.value(cp)
                denom = vm - 2.0 * best_val + vp
                if denom <= 1e-12:
                    if min(vm, vp) < best_val - 1e-9:
                        p_np = cm if vm < vp else cp
                        best_val = min(vm, vp)
                    continue
                delta = float(np.clip(0.5 * (vm - vp) / denom * d, -d, d))
                cand = p_np.copy()
                cand[ax] += delta
                v = level.value(cand)
                if v < best_val - 1e-9:
                    best_val = v
                    p_np = cand
    return p_np, best_val


def _pre_search_candidates():
    """Identity, then +-5..20 deg about each axis and +-4/8 voxels along
    each: 37 candidates."""
    cands = [np.zeros(6)]
    for ax in range(3):
        for deg in (-20, -15, -10, -5, 5, 10, 15, 20):
            c = np.zeros(6)
            c[ax] = np.deg2rad(deg)
            cands.append(c)
    for ax in range(3):
        for vx in (-8, -4, 4, 8):
            c = np.zeros(6)
            c[3 + ax] = vx
            cands.append(c)
    return cands


def register_rigid(
    fixed: np.ndarray,
    moving: np.ndarray,
    *,
    levels=(4, 2, 1),
    iters_per_level=100,
    lr=0.5,
    use_gradient_images=True,
    init_params=None,
    metric: str = "ncc",
    return_quality: bool = False,
    pre_search: bool = True,
    device="cuda",
    stats: list | None = None,
):
    """Estimate the rigid transform aligning ``moving`` to ``fixed``.

    Both volumes must share a voxel grid/spacing (resample first with
    ``imaging.resample_from_to`` if needed). Returns (params[6] float32,
    matrix4x4) where the matrix maps fixed-voxel -> moving-voxel homogeneous
    coordinates (its [:3, :3] and [:3, 3] are the ``matrix`` and ``offset``
    of ``imaging.resample_affine``).

    ``metric``: 'ncc' (on gradient-magnitude images by default) or 'mi'
    (Parzen mutual information). ``return_quality`` additionally returns
    the final similarity at the finest level (NCC in [-1, 1] or MI in
    nats) so callers can detect a failed registration. ``device``: where
    the volumes and every evaluation live. ``stats``: a list that receives
    one dict per stage (the pre-search, then each level): its loss
    evaluations, host reads and wall seconds.
    """
    _full_fp32()
    dev = torch.device(device)
    fixed = torch.tensor(np.asarray(fixed, np.float32), device=dev)
    moving = torch.tensor(np.asarray(moving, np.float32), device=dev)
    params = np.asarray(
        init_params if init_params is not None else np.zeros(6), np.float32)
    if metric not in ("ncc", "mi"):
        raise ValueError("metric must be 'ncc' or 'mi'")
    similarity = _mutual_information if metric == "mi" else _ncc
    gradient_images = use_gradient_images and metric == "ncc"
    quality = None

    def record(stage, counts, t0):
        if stats is not None:
            stats.append(dict(stage=stage, seconds=time.time() - t0, **counts))

    if pre_search and init_params is None:
        # coarse exhaustive initialization at the coarsest level: shell-
        # dominated head images have a flat similarity landscape around
        # identity, so gradient ascent alone stalls; seeding from the best
        # single-axis candidate restores the full capture range
        t0 = time.time()
        counts = {"evals": 0, "syncs": 0}
        f0 = levels[0]
        fx0 = _downsample(fixed, f0)
        mv0 = _downsample(moving, f0)
        if gradient_images:
            fx0 = _grad_mag(fx0)
            mv0 = _grad_mag(mv0)
        level = _Level(fx0, mv0, f0, similarity, counts)
        params = np.asarray(
            max(_pre_search_candidates(), key=lambda c: -level.value(c)),
            np.float32)
        record("pre-search", counts, t0)

    for f in levels:
        t0 = time.time()
        counts = {"evals": 0, "syncs": 0}
        fx = _downsample(fixed, f)
        mv = _downsample(moving, f)
        if gradient_images:
            fx = _grad_mag(fx)
            mv = _grad_mag(mv)
        level = _Level(_standardize(fx), _standardize(mv), f, similarity,
                       counts)

        p = torch.tensor(params, device=dev, requires_grad=True)
        _adam(level.loss, p, lr * (0.02 if f == 1 else 0.05),
              iters_per_level)

        # derivative-free coordinate refinement: shell-dominated head
        # images have a shallow, noisy similarity landscape in rotation,
        # where gradient steps stall or drift
        p_np = p.detach().cpu().numpy().astype(np.float64)
        counts["syncs"] += 1
        p_np, best_val = _descend(
            level, p_np, level.value(p_np),
            ((4.0, 4.0), (2.0, 2.0), (1.0, 1.0), (0.5, 0.5), (0.25, 0.25)),
            1e-7)
        if f == levels[-1]:
            # terminal sub-step polish at the finest resolution on the NGF
            # metric: gradient-NCC's optimum is biased ~2 deg from truth on
            # bias-field-shaded multi-modal pairs, NGF sits within ~0.5 deg
            fxi = _standardize(_downsample(fixed, f))
            mvi = _standardize(_downsample(moving, f))
            eps_ngf = 0.5 * float(torch.abs(_grad_mag(fxi)).mean())
            counts["syncs"] += 1
            polish = _Level(fxi, mvi, f,
                            lambda w, x: _ngf(w, x, eps_ngf), counts)
            # the opening 2-deg step must clear the primary metric's
            # measured ~2-deg bias basin before the fine sweeps converge
            p_np, best_val = _descend(
                polish, p_np, polish.value(p_np),
                ((2.0, 2.0), (1.0, 1.0), (0.5, 0.5), (0.25, 0.25)), 1e-8)
            p_np, best_val = _parabolic_polish(polish, p_np, best_val)
        params = p_np.astype(np.float32)
        # quality stays on the PRIMARY metric (the failure-detection
        # thresholds are calibrated on NCC/MI, not on the polish NGF)
        quality = -level.value(p_np)
        record(f"level {f}", counts, t0)

    p = params
    R = euler_matrix(p[0], p[1], p[2]).numpy()
    c = np.array(fixed.shape, np.float64) / 2.0
    m = np.eye(4)
    m[:3, :3] = R
    m[:3, 3] = c - R @ c + p[3:6]
    if return_quality:
        return p, m, quality
    return p, m
