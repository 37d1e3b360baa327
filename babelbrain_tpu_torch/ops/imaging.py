"""Volume image-processing ops of Step 1 (plain PyTorch).

Counterpart of ``babelbrain_tpu/ops/imaging.py`` for the ops Step 1 uses
(CT and label mode). The JAX versions are XLA (no TPU kernels), so these stay plain
PyTorch on the given device:

  * median_filter3d     <- GPUMedianFilter (3-D median, reflect boundary)
  * binary_close / binary_open / binary_dilate / binary_erode <-
    GPUBinaryClosing (cubic structure, outside-of-volume = background)
  * label_components / largest_component <- GPULabel (6-connectivity)
  * map_to_unique       <- GPUMapping (value -> index in quantized table)
  * resample_affine / resample_from_to <- GPUResample (orders 0/1/3; order 3
    = cubic B-spline with host-side prefilter)

Each function takes numpy input and returns numpy output; ``device`` picks
where the work runs. ``interpolate`` (the order-0/1 sampling under
``resample_affine``, also the rigid registration's resampler) works on
tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# median filter
# ---------------------------------------------------------------------------


def median_filter3d(volume, size: int = 7, z_chunk: int = 8, *, device="cuda"):
    """3-D median filter with reflect boundary (odd ``size`` <= 7).

    Matches `GPUFunctions/GPUMedianFilter/median_filter.cpp` behavior: the
    median of the size^3 window with scipy 'reflect' (numpy 'symmetric')
    padding, as float32. ``z_chunk`` output planes are processed at a time
    to bound the window-stack temporaries.
    """
    if size % 2 != 1:
        raise ValueError("size must be odd")
    arr = np.asarray(volume)
    r = size // 2
    padded = np.pad(arr.astype(np.float32), [(r, r)] * 3, mode="symmetric")
    pv = torch.as_tensor(padded, device=torch.device(device))
    n1, n2, n3 = arr.shape
    out = torch.empty((n1, n2, n3), dtype=torch.float32, device=pv.device)
    for z0 in range(0, n3, z_chunk):
        z1 = min(z0 + z_chunk, n3)
        stack = torch.stack(
            [
                pv[i : i + n1, j : j + n2, z0 + k : z1 + k]
                for i in range(size)
                for j in range(size)
                for k in range(size)
            ],
            dim=-1,
        )
        # odd window count: the lower median is the median
        out[:, :, z0:z1] = stack.median(dim=-1).values
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# binary morphology
# ---------------------------------------------------------------------------


def _dilate(x, size):
    # outside-of-volume treated as background (zero padding)
    r = size // 2
    xp = F.pad(x[None, None], (r, r, r, r, r, r))
    return F.max_pool3d(xp, size, stride=1)[0, 0]


def _erode(x, size):
    r = size // 2
    xp = F.pad(x[None, None], (r, r, r, r, r, r))  # zeros: border = background
    return -F.max_pool3d(-xp, size, stride=1)[0, 0]


def _as_float(volume, device):
    return torch.as_tensor(
        np.asarray(volume).astype(np.float32), device=torch.device(device)
    )


def binary_close(volume, size: int = 5, *, device="cuda"):
    """Morphological closing with a cubic structuring element
    (`GPUBinaryClosing/binary_closing.cpp` equivalent). Boundary treated as
    background for the erosion (same as zero-padded closing)."""
    x = _as_float(volume, device)
    return (_erode(_dilate(x, size), size) > 0.5).cpu().numpy()


def binary_open(volume, size: int = 5, *, device="cuda"):
    x = _as_float(volume, device)
    return (_dilate(_erode(x, size), size) > 0.5).cpu().numpy()


def binary_dilate(volume, size: int = 3, *, device="cuda"):
    x = _as_float(volume, device)
    return (_dilate(x, size) > 0.5).cpu().numpy()


def binary_erode(volume, size: int = 3, *, device="cuda"):
    x = _as_float(volume, device)
    return (_erode(x, size) > 0.5).cpu().numpy()


# ---------------------------------------------------------------------------
# connected components (6-connectivity)
# ---------------------------------------------------------------------------


def _label_components(mask):
    """Min-flat-id label per component (INF = n outside the mask)."""
    shape = mask.shape
    n = mask.numel()
    INF = n
    flat_ids = torch.arange(n, dtype=torch.int64, device=mask.device).reshape(shape)
    labels = torch.where(mask, flat_ids, INF)

    def neighbor_min(lab):
        m = lab
        for axis in range(3):
            for shift in (-1, 1):
                nb = torch.full_like(lab, INF)
                k = lab.shape[axis] - 1
                if shift == 1:  # nb[i] = lab[i-1]
                    nb.narrow(axis, 1, k).copy_(lab.narrow(axis, 0, k))
                else:  # nb[i] = lab[i+1]
                    nb.narrow(axis, 0, k).copy_(lab.narrow(axis, 1, k))
                m = torch.minimum(m, nb)
        return torch.where(mask, m, INF)

    def compress(lab):
        # pointer jumping: label <- label[label]
        flat = lab.reshape(-1)
        safe = flat.clamp(0, n - 1)
        jumped = torch.where(flat < n, flat[safe], INF)
        return jumped.reshape(shape)

    while True:
        new = compress(compress(neighbor_min(labels)))
        if torch.equal(new, labels):
            return labels
        labels = new


def label_components(mask, *, device="cuda"):
    """6-connected component labeling.

    Returns (labels int32 with 0 = background and 1..K compact component ids,
    K), ids ordered by each component's smallest flat voxel index.
    Algorithm: iterative min-neighbor propagation with pointer-jumping
    compression — the replacement for the reference's `GPULabel/label.cpp`
    iterative kernels.
    """
    m = np.asarray(mask).astype(bool)
    raw = _label_components(torch.as_tensor(m, device=torch.device(device)))
    raw = raw.cpu().numpy()
    out = np.zeros(m.shape, np.int32)
    vals = raw[m]
    uniq, inv = np.unique(vals, return_inverse=True)
    out[m] = inv + 1
    return out, len(uniq)


def largest_component(mask, *, device="cuda"):
    """Keep only the largest 6-connected component (common Step-1 cleanup,
    `BabelDatasetPreps.py:887-894`)."""
    labels, k = label_components(mask, device=device)
    if k == 0:
        return np.zeros_like(np.asarray(mask), bool)
    counts = np.bincount(labels.ravel())[1:]
    return labels == (int(np.argmax(counts)) + 1)


# ---------------------------------------------------------------------------
# value -> quantized-table index
# ---------------------------------------------------------------------------


def map_to_unique(volume, unique_values, mask=None, *, device="cuda"):
    """Index of each voxel's value in the sorted ``unique_values`` table
    (`GPUMapping/map_filter.cpp` equivalent; nearest match)."""
    dev = torch.device(device)
    uv = torch.as_tensor(np.asarray(unique_values), device=dev)
    v = torch.as_tensor(np.asarray(volume), device=dev)
    n = len(np.asarray(unique_values))
    idx = torch.searchsorted(uv, v).clamp(0, n - 1)
    # snap to nearest of idx / idx-1
    lo = (idx - 1).clamp_min(0)
    pick_lo = (v - uv[lo]).abs() <= (uv[idx] - v).abs()
    out = torch.where(pick_lo, lo, idx)
    if mask is not None:
        out = torch.where(torch.as_tensor(np.asarray(mask), device=dev), out, 0)
    return out.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# affine resampling
# ---------------------------------------------------------------------------


def _source_coords(matrix, offset, out_shape, device):
    """(3, P) float32 source voxel coordinates of every output voxel."""
    m = torch.as_tensor(np.asarray(matrix, np.float32), device=device)
    off = torch.as_tensor(np.asarray(offset, np.float32), device=device)
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in out_shape]
    ii, jj, kk = torch.meshgrid(*axes, indexing="ij")
    coords = torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)])
    return m @ coords + off[:, None]


def _round_half_away(x):
    t = torch.trunc(x)
    return t + torch.sign(x) * ((x - t).abs() >= 0.5)


def _resample(vol, matrix, offset, out_shape, order):
    """Orders 0/1 with zero outside the volume (JAX map_coordinates
    'constant' mode, which is scipy's 'grid-constant')."""
    src = _source_coords(matrix, offset, out_shape, vol.device)
    return interpolate(vol, src, order).reshape(out_shape)


def interpolate(vol, src, order: int = 1):
    """``vol`` sampled at the (3, P) voxel coordinates ``src``, order 0 or 1,
    zero outside: JAX ``map_coordinates(mode="constant")`` in its own
    arithmetic order (per corner the weight product times the masked
    value, corners summed x-major). Differentiable in ``src`` for order 1;
    flat (P,) result."""
    dims = vol.shape
    flat = vol.reshape(-1)
    if order == 0:
        nodes = [[(_round_half_away(src[d]).to(torch.int64), None)]
                 for d in range(3)]
    elif order == 1:
        nodes = []
        for d in range(3):
            lower = torch.floor(src[d])
            upper_w = src[d] - lower
            idx = lower.to(torch.int64)
            nodes.append([(idx, 1 - upper_w), (idx + 1, upper_w)])
    else:
        raise ValueError(f"order must be 0, 1 or 3, got {order}")
    out = None
    for ix, wx in nodes[0]:
        for iy, wy in nodes[1]:
            for iz, wz in nodes[2]:
                ok = ((ix >= 0) & (ix < dims[0]) & (iy >= 0) & (iy < dims[1])
                      & (iz >= 0) & (iz < dims[2]))
                lin = (ix.clamp(0, dims[0] - 1) * dims[1]
                       + iy.clamp(0, dims[1] - 1)) * dims[2] + iz.clamp(0, dims[2] - 1)
                val = torch.where(ok, flat[lin], 0.0)
                if wx is not None:
                    val = wx * wy * wz * val
                out = val if out is None else out + val
    return out


def _bspline3_weights(t):
    """Cubic B-spline basis weights for fractional offset t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return (w0, w1, w2, w3)


def _resample_cubic(coeff, matrix, offset, out_shape):
    """Cubic B-spline interpolation of prefiltered coefficients (zero
    outside, like scipy 'grid-constant')."""
    n1, n2, n3 = coeff.shape
    src = _source_coords(matrix, offset, out_shape, coeff.device)
    base = torch.floor(src).to(torch.int64)  # (3, P)
    frac = src - base
    wx = _bspline3_weights(frac[0])
    wy = _bspline3_weights(frac[1])
    wz = _bspline3_weights(frac[2])
    flat = coeff.reshape(-1)
    out = torch.zeros(src.shape[1], dtype=torch.float32, device=coeff.device)
    for a in range(4):
        ix = base[0] + (a - 1)
        okx = (ix >= 0) & (ix < n1)
        cx = ix.clamp(0, n1 - 1)
        for b in range(4):
            iy = base[1] + (b - 1)
            oky = (iy >= 0) & (iy < n2)
            cy = iy.clamp(0, n2 - 1)
            for c in range(4):
                iz = base[2] + (c - 1)
                okz = (iz >= 0) & (iz < n3)
                cz = iz.clamp(0, n3 - 1)
                w = wx[a] * wy[b] * wz[c] * (okx & oky & okz)
                out = out + w * flat[(cx * n2 + cy) * n3 + cz]
    return out.reshape(out_shape)


def resample_affine(volume, matrix, offset, out_shape, order: int = 1, *,
                    device="cuda"):
    """Resample with out_voxel -> in_voxel affine (scipy.ndimage convention).

    Orders 0 (nearest), 1 (linear), and 3 (cubic B-spline with prefilter) —
    the same set the reference's GPUResample exposes
    (`GPUResample/affine_transform.cpp` + `spline_filter.cpp`). Order 3
    prefilters host-side and interpolates on the device.
    """
    dev = torch.device(device)
    out_shape = tuple(int(s) for s in out_shape)
    if order == 3:
        import scipy.ndimage as _ndi

        # zero-pad before prefiltering so boundary coefficients blend with
        # the outside value, matching scipy's 'grid-constant' handling
        PAD = 8
        padded = np.pad(np.asarray(volume, np.float32), PAD)
        coeff = _ndi.spline_filter(padded, order=3, output=np.float32)
        off = np.asarray(offset, np.float64) + PAD
        out = _resample_cubic(
            torch.as_tensor(coeff, device=dev), matrix, off, out_shape
        )
    else:
        vol = torch.as_tensor(np.asarray(volume, np.float32), device=dev)
        out = _resample(vol, matrix, offset, out_shape, order)
    return out.cpu().numpy()


def resample_from_to(volume, from_affine, to_affine, to_shape, order: int = 1,
                     *, device="cuda"):
    """nibabel ``resample_from_to`` equivalent (`Resample.py` contract):
    resample ``volume`` (voxel->world ``from_affine``) onto the grid defined
    by (``to_shape``, ``to_affine``)."""
    M = np.linalg.inv(from_affine) @ to_affine
    return resample_affine(volume, M[:3, :3], M[:3, 3], to_shape, order,
                           device=device)
