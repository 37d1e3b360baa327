"""Solid voxelization of watertight triangle meshes + STL I/O.

Replaces the reference's GPU scatter-XOR voxelizer
(`GPUFunctions/GPUVoxelize/voxelize.cpp`, SURVEY.md section 2.3): instead of
per-triangle atomic XOR bit tables, a fully vectorized parity ray-cast —
candidate (triangle, ray) pairs from yz-bounding boxes, Möller-Trumbore
intersection for all pairs at once, crossing-parity prefix (cumsum mod 2)
along x. Runs host-side (NumPy): voxelization is a once-per-case setup step
and is irregular, which SURVEY.md flags as the one op that does not map
cleanly onto a dense device kernel.

STL reading supports binary and ASCII; writing is binary.

Numpy copy of ``babelbrain_tpu/ops/voxelize.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import struct

import numpy as np


def read_stl(path: str) -> np.ndarray:
    """Read an STL file; returns (T, 3, 3) float64 triangle vertices."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head[:5].lower() == b"solid":
            # could still be binary with a 'solid' header; sniff size
            data = f.read()
            try:
                return _parse_ascii_stl(data.decode("ascii", errors="strict"))
            except (UnicodeDecodeError, ValueError):
                pass
        f.seek(80)
        (n_tri,) = struct.unpack("<I", f.read(4))
        raw = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
        rec = raw.reshape(n_tri, 50)
        floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 4, 3)
        return floats[:, 1:, :].astype(np.float64)


def _parse_ascii_stl(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            verts.append([float(p) for p in parts[1:4]])
    v = np.asarray(verts)
    if len(v) == 0 or len(v) % 3:
        raise ValueError("not a valid ascii STL")
    return v.reshape(-1, 3, 3)


def write_stl(path: str, triangles: np.ndarray):
    """Write (T, 3, 3) triangles as binary STL."""
    tri = np.asarray(triangles, np.float32)
    n = tri.shape[0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    nrm = np.cross(e1, e2)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-30), 0.0).astype(np.float32)
    rec = np.zeros((n, 50), np.uint8)
    packed = np.concatenate([nrm[:, None, :], tri], axis=1).astype("<f4")
    rec[:, :48] = packed.reshape(n, 48 * 1).view(np.uint8) if False else np.frombuffer(
        packed.tobytes(), np.uint8
    ).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n))
        f.write(rec.tobytes())


def voxelize_solid(
    triangles: np.ndarray,
    origin,
    dx: float,
    shape,
    batch: int = 200_000,
    backend: str = "auto",
) -> np.ndarray:
    """Solid-voxelize a watertight mesh.

    A voxel (i,j,k) with center ``origin + dx*(i,j,k)`` is inside if an
    x-directed ray through its center crosses the surface an odd number of
    times before reaching it.

    Parameters
    ----------
    triangles : (T, 3, 3) vertices in world units.
    origin : world position of voxel (0,0,0) center.
    dx : isotropic voxel size.
    shape : (N1, N2, N3) output grid.
    backend : 'auto' | 'native' | 'numpy'. 'native' is the OpenMP C++
        XOR-bit-table kernel (``native/voxelize.cpp``, the
        counterpart of the reference's GPU voxelizer
        `GPUFunctions/GPUVoxelize/voxelize.cpp`); bit-identical to the
        NumPy path. 'auto' uses it when the toolchain is available.

    Returns boolean (N1, N2, N3).
    """
    tri = (np.asarray(triangles, np.float64) - np.asarray(origin)) / dx
    if backend in ("auto", "native"):
        try:
            from ..native import voxelize_solid_native

            return voxelize_solid_native(tri, shape)
        except Exception:
            if backend == "native":
                raise
    N1, N2, N3 = shape
    # tiny sample-point shift avoids rays hitting edges/vertices exactly
    EPS_J, EPS_K = 2.4375e-4, 7.8125e-5

    # candidate (triangle, ray) pairs from yz bounding boxes
    ymin = tri[:, :, 1].min(1)
    ymax = tri[:, :, 1].max(1)
    zmin = tri[:, :, 2].min(1)
    zmax = tri[:, :, 2].max(1)
    j0 = np.clip(np.ceil(ymin - EPS_J), 0, N2 - 1).astype(np.int64)
    j1 = np.clip(np.floor(ymax - EPS_J), -1, N2 - 1).astype(np.int64)
    k0 = np.clip(np.ceil(zmin - EPS_K), 0, N3 - 1).astype(np.int64)
    k1 = np.clip(np.floor(zmax - EPS_K), -1, N3 - 1).astype(np.int64)
    nj = np.maximum(j1 - j0 + 1, 0)
    nk = np.maximum(k1 - k0 + 1, 0)
    counts = nj * nk
    keep = counts > 0
    tri_ids = np.repeat(np.nonzero(keep)[0], counts[keep])
    # per-pair local cell index -> (j, k)
    local = np.concatenate([np.arange(c) for c in counts[keep]]) if keep.any() else np.zeros(0, np.int64)
    nk_r = nk[tri_ids]
    jj = j0[tri_ids] + local // nk_r
    kk = k0[tri_ids] + local % nk_r

    flips = np.zeros((N2 * N3, N1 + 1), np.uint32)
    for s in range(0, len(tri_ids), batch):
        t_id = tri_ids[s : s + batch]
        j = jj[s : s + batch]
        kq = kk[s : s + batch]
        a = tri[t_id, 0]
        b = tri[t_id, 1]
        c = tri[t_id, 2]
        # ray: origin (x=-inf, y=j+EPS, z=k+EPS), direction +x.
        # Solve for intersection in the yz system.
        py = j + EPS_J
        pz = kq + EPS_K
        d = np.stack([b[:, 1] - a[:, 1], b[:, 2] - a[:, 2]], 1)
        e = np.stack([c[:, 1] - a[:, 1], c[:, 2] - a[:, 2]], 1)
        rhs = np.stack([py - a[:, 1], pz - a[:, 2]], 1)
        det = d[:, 0] * e[:, 1] - d[:, 1] * e[:, 0]
        ok = np.abs(det) > 1e-14
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        u = (rhs[:, 0] * e[:, 1] - rhs[:, 1] * e[:, 0]) * inv
        v = (d[:, 0] * rhs[:, 1] - d[:, 1] * rhs[:, 0]) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1)
        x_hit = a[:, 0] + u * (b[:, 0] - a[:, 0]) + v * (c[:, 0] - a[:, 0])
        i_cross = np.floor(x_hit).astype(np.int64) + 1
        valid = hit & (i_cross <= N1)
        i_cross = np.clip(i_cross, 0, N1)
        lin = (j * N3 + kq)[valid]
        np.add.at(flips, (lin, i_cross[valid]), 1)

    parity = np.cumsum(flips[:, :N1], axis=1) & 1
    return parity.astype(bool).reshape(N2, N3, N1).transpose(2, 0, 1)


def sphere_mesh(center, radius, n_sub: int = 3) -> np.ndarray:
    """Icosphere triangle mesh (testing / synthetic phantoms)."""
    t = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    tris = verts[faces]
    for _ in range(n_sub):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    tris /= np.linalg.norm(tris, axis=2, keepdims=True)
    return tris * radius + np.asarray(center)
