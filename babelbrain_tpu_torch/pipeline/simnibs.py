"""SimNIBS / gmsh mesh ingestion: `.msh` parsing + tetrahedron rasterization.

Counterpart of the reference's brain-tissue upscale path
(`BabelBrain/BabelDatasetPreps.py:307` ``RunMeshConv`` +
`ExternalBin/SimbNIBSMesh/MeshConv.py`), which shells out to an external
SimNIBS python environment to turn the charm `.msh` head model into voxel
WM/GM/CSF labels. Here the gmsh v2 file (ASCII and binary, the format
SimNIBS writes) is parsed directly and its tetrahedra are rasterized onto
any target grid — no SimNIBS install required.

SimNIBS volume region tags: 1 WM, 2 GM, 3 CSF, 4 bone, 5 scalp/skin,
6 eyes, 7 compact bone, 8 spongy bone, 9 blood, 10 muscle (charm models
use 1-10; headreco 1-8).

Numpy copy of ``babelbrain_tpu/pipeline/simnibs.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_msh", "rasterize_tetrahedra", "msh_to_labels",
           "SIMNIBS_TO_CHARM"]

# SimNIBS volume tag -> the charm-label vocabulary used by
# `pipeline.step1.CHARM_TO_TISSUE` (WM=1, GM=2, CSF=3, bone=7/4 via
# compact/spongy, skin=5)
SIMNIBS_TO_CHARM = {1: 1, 2: 2, 3: 3, 4: 7, 5: 5, 6: 0, 7: 7, 8: 4, 9: 3,
                    10: 5}


def read_msh(path: str):
    """Parse a gmsh v2.2 `.msh` file (ASCII or binary).

    Returns (nodes (N,3) float64, elements dict {gmsh_type: (conn, tags)})
    where ``conn`` is (M, n_nodes) 0-based int32 and ``tags`` is (M,) int32
    (the first element tag — the physical/region id SimNIBS uses).
    Types of interest: 2 = triangle, 4 = tetrahedron.
    """
    with open(path, "rb") as f:
        data = f.read()

    def find_section(name):
        s = data.find(b"$" + name)
        if s < 0:
            raise ValueError(f"missing ${name.decode()} section")
        s = data.index(b"\n", s) + 1
        e = data.find(b"$End" + name)
        return s, e

    s, e = find_section(b"MeshFormat")
    header = data[s:e].split()
    version, is_binary = header[0], int(header[1])
    if not version.startswith(b"2"):
        raise ValueError(f"unsupported msh version {version.decode()}")

    s, e = find_section(b"Nodes")
    if is_binary:
        nl = data.index(b"\n", s)
        n_nodes = int(data[s:nl])
        off = nl + 1
        rec = np.frombuffer(
            data, dtype=np.dtype([("id", "<i4"), ("xyz", "<f8", 3)]),
            count=n_nodes, offset=off,
        )
        ids = rec["id"]
        nodes = rec["xyz"].astype(np.float64)
    else:
        rows = np.array(data[s:e].split(), dtype=np.float64)
        n_nodes = int(rows[0])
        rows = rows[1 : 1 + 4 * n_nodes].reshape(n_nodes, 4)
        ids = rows[:, 0].astype(np.int64)
        nodes = rows[:, 1:4]
    # gmsh node ids may be non-contiguous; build an id -> row lookup
    id2row = np.full(ids.max() + 1, -1, np.int64)
    id2row[ids] = np.arange(n_nodes)

    NODES_PER = {1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 15: 1}
    elements: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    s, e = find_section(b"Elements")
    if is_binary:
        nl = data.index(b"\n", s)
        n_elem = int(data[s:nl])
        off = nl + 1
        read = 0
        while read < n_elem:
            etype, count, ntags = struct.unpack_from("<3i", data, off)
            off += 12
            npn = NODES_PER[etype]
            rec = np.frombuffer(
                data,
                dtype=np.dtype(
                    [("id", "<i4"), ("tags", "<i4", ntags),
                     ("conn", "<i4", npn)]
                ),
                count=count,
                offset=off,
            )
            off += rec.itemsize * count
            conn = id2row[rec["conn"].reshape(count, npn)]
            tags = (rec["tags"].reshape(count, ntags)[:, 0]
                    if ntags else np.zeros(count, np.int32))
            prev = elements.get(etype)
            if prev is not None:
                conn = np.concatenate([prev[0], conn])
                tags = np.concatenate([prev[1], tags])
            elements[etype] = (conn.astype(np.int32), tags.astype(np.int32))
            read += count
    else:
        lines = data[s:e].split(b"\n")
        n_elem = int(lines[0])
        by_type: dict[int, list] = {}
        for ln in lines[1 : 1 + n_elem]:
            parts = ln.split()
            etype = int(parts[1])
            ntags = int(parts[2])
            tag = int(parts[3]) if ntags else 0
            conn = [int(v) for v in parts[3 + ntags :]]
            by_type.setdefault(etype, []).append((tag, conn))
        for etype, rows in by_type.items():
            tags = np.array([r[0] for r in rows], np.int32)
            conn = id2row[np.array([r[1] for r in rows], np.int64)]
            elements[etype] = (conn.astype(np.int32), tags)
    return nodes, elements


def rasterize_tetrahedra(
    nodes: np.ndarray,
    tets: np.ndarray,
    tags: np.ndarray,
    affine: np.ndarray,
    shape,
    chunk: int = 50_000,
) -> np.ndarray:
    """Rasterize tagged tetrahedra into an int32 label volume.

    A voxel gets the tag of the tetrahedron containing its center (SimNIBS
    meshes are conforming, so tets do not overlap). Vectorized over
    bounding-box candidate voxels per chunk of tetrahedra.
    """
    shape = tuple(int(v) for v in shape)
    inv = np.linalg.inv(np.asarray(affine, np.float64))
    vox = nodes @ inv[:3, :3].T + inv[:3, 3]  # nodes in voxel coords
    out = np.zeros(shape, np.int32)
    tets = np.asarray(tets, np.int64)
    tags = np.asarray(tags, np.int32)

    for s in range(0, len(tets), chunk):
        t = tets[s : s + chunk]
        tg = tags[s : s + chunk]
        v = vox[t]  # (C, 4, 3)
        lo = np.maximum(np.ceil(v.min(1) - 1e-9), 0).astype(np.int64)
        hi = np.minimum(np.floor(v.max(1) + 1e-9), np.array(shape) - 1).astype(
            np.int64
        )
        n = np.maximum(hi - lo + 1, 0)
        counts = n.prod(1)
        keep = counts > 0
        if not keep.any():
            continue
        tet_ids = np.repeat(np.nonzero(keep)[0], counts[keep])
        local = (
            np.arange(counts[keep].sum())
            - np.repeat(np.cumsum(counts[keep]) - counts[keep], counts[keep])
        )
        nk = n[tet_ids]
        i = lo[tet_ids, 0] + local // (nk[:, 1] * nk[:, 2])
        rem = local % (nk[:, 1] * nk[:, 2])
        j = lo[tet_ids, 1] + rem // nk[:, 2]
        k = lo[tet_ids, 2] + rem % nk[:, 2]
        p = np.stack([i, j, k], 1).astype(np.float64)

        # barycentric inside test: solve M lam = p - v0
        v0 = v[tet_ids, 0]
        M = np.stack(
            [v[tet_ids, 1] - v0, v[tet_ids, 2] - v0, v[tet_ids, 3] - v0], -1
        )  # (P, 3, 3)
        det = np.linalg.det(M)
        ok = np.abs(det) > 1e-12
        lam = np.zeros((len(p), 3))
        if ok.any():
            lam[ok] = np.linalg.solve(M[ok], (p - v0)[ok][..., None])[..., 0]
        eps = 1e-9
        inside = ok & (lam >= -eps).all(1) & (lam.sum(1) <= 1 + eps)
        if inside.any():
            out[i[inside], j[inside], k[inside]] = tg[tet_ids[inside]]
    return out


def msh_to_labels(
    path: str,
    affine: np.ndarray,
    shape,
    tag_map: dict | None = None,
) -> np.ndarray:
    """SimNIBS `.msh` head model -> charm-vocabulary label volume.

    Drop-in producer for `pipeline.step1.generate_mask`'s ``labels_data``
    (the reference obtains the same volume through the SimNIBS
    `MeshConv.py` subprocess). ``affine`` maps voxel indices of the target
    grid to the mesh's world (RAS mm) space.
    """
    nodes, elements = read_msh(path)
    if 4 not in elements:
        raise ValueError("mesh has no tetrahedra")
    conn, tags = elements[4]
    tag_map = SIMNIBS_TO_CHARM if tag_map is None else tag_map
    lut = np.zeros(max(tags.max(), max(tag_map)) + 1, np.int32)
    for k, vv in tag_map.items():
        lut[k] = vv
    raw = rasterize_tetrahedra(nodes, conn, tags, affine, shape)
    return lut[raw]
