"""Pure-python GIfTI (.gii) surface/metric interchange.

The reference exchanges ``*.surf.gii`` scalp meshes and ``*.func.gii``
per-vertex metric maps with PlanTUS and neuronavigation workflows
(`BabelBrain/PlanTUSViewer/RunPlanTUS.py:338,492,541-545`,
via nibabel). nibabel is not available in this environment, so the subset
those workflows need is implemented directly on the GIfTI XML format
(base64/gzip-encoded DataArrays): POINTSET + TRIANGLE surface files and
scalar metric files, read and write, with the optional
CoordinateSystemTransformMatrix preserved.

Numpy copy of ``babelbrain_tpu/pipeline/gifti.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import base64
import gzip
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

_NIFTI_DTYPES = {
    "NIFTI_TYPE_UINT8": np.uint8,
    "NIFTI_TYPE_INT32": np.int32,
    "NIFTI_TYPE_FLOAT32": np.float32,
    "NIFTI_TYPE_FLOAT64": np.float64,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


@dataclass
class GiftiArray:
    intent: str
    data: np.ndarray
    meta: dict = field(default_factory=dict)
    transform: np.ndarray | None = None  # 4x4, POINTSET only


def _decode_data(elem, dtype, shape, order):
    enc = elem.get("Encoding", "GZipBase64Binary")
    data_el = elem.find("Data")
    txt = (data_el.text or "") if data_el is not None else ""
    if enc == "ASCII":
        arr = np.fromstring(txt, dtype=dtype, sep=" ")  # noqa: NPY201
    else:
        raw = base64.b64decode(txt)
        if enc == "GZipBase64Binary":
            raw = gzip.decompress(raw)
        arr = np.frombuffer(raw, dtype=dtype).copy()
    if elem.get("Endian", "LittleEndian") == "BigEndian":
        arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
    if shape:
        arr = arr.reshape(shape, order="F" if order.startswith("Column") else "C")
    return arr


def read_gifti(path: str) -> list[GiftiArray]:
    """All DataArrays of a .gii file as (intent, ndarray) records."""
    root = ET.parse(path).getroot()
    out = []
    for da in root.iter("DataArray"):
        intent = da.get("Intent", "NIFTI_INTENT_NONE")
        dtype = _NIFTI_DTYPES[da.get("DataType", "NIFTI_TYPE_FLOAT32")]
        ndim = int(da.get("Dimensionality", "1"))
        shape = tuple(int(da.get(f"Dim{i}", "1")) for i in range(ndim))
        order = da.get("ArrayIndexingOrder", "RowMajorOrder")
        arr = _decode_data(da, dtype, shape, order)
        meta = {}
        md = da.find("MetaData")
        if md is not None:
            for m in md.iter("MD"):
                name = m.findtext("Name")
                if name is not None:
                    meta[name] = m.findtext("Value") or ""
        xf = None
        cst = da.find("CoordinateSystemTransformMatrix")
        if cst is not None:
            vals = np.fromstring(  # noqa: NPY201
                cst.findtext("MatrixData") or "", sep=" "
            )
            if vals.size == 16:
                xf = vals.reshape(4, 4)
        out.append(GiftiArray(intent=intent, data=arr, meta=meta, transform=xf))
    return out


def _data_array_xml(arr: GiftiArray) -> ET.Element:
    a = np.ascontiguousarray(arr.data)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if a.dtype not in _DTYPE_NAMES:
        a = a.astype(np.int32 if np.issubdtype(a.dtype, np.integer)
                     else np.float32)
    attrs = {
        "Intent": arr.intent,
        "DataType": _DTYPE_NAMES[a.dtype],
        "ArrayIndexingOrder": "RowMajorOrder",
        "Dimensionality": str(a.ndim),
        "Encoding": "GZipBase64Binary",
        "Endian": "LittleEndian",
        "ExternalFileName": "",
        "ExternalFileOffset": "",
    }
    for i, d in enumerate(a.shape):
        attrs[f"Dim{i}"] = str(d)
    el = ET.Element("DataArray", attrs)
    if arr.meta:
        md = ET.SubElement(el, "MetaData")
        for k, v in arr.meta.items():
            m = ET.SubElement(md, "MD")
            ET.SubElement(m, "Name").text = str(k)
            ET.SubElement(m, "Value").text = str(v)
    if arr.transform is not None:
        cst = ET.SubElement(el, "CoordinateSystemTransformMatrix")
        ET.SubElement(cst, "DataSpace").text = "NIFTI_XFORM_SCANNER_ANAT"
        ET.SubElement(cst, "TransformedSpace").text = "NIFTI_XFORM_SCANNER_ANAT"
        ET.SubElement(cst, "MatrixData").text = " ".join(
            f"{v:.8g}" for v in np.asarray(arr.transform, float).ravel()
        )
    data = ET.SubElement(el, "Data")
    data.text = base64.b64encode(
        gzip.compress(a.astype(a.dtype.newbyteorder("<")).tobytes())
    ).decode("ascii")
    return el


def write_gifti(path: str, arrays: list[GiftiArray]):
    root = ET.Element(
        "GIFTI",
        {"Version": "1.0", "NumberOfDataArrays": str(len(arrays))},
    )
    for arr in arrays:
        root.append(_data_array_xml(arr))
    tree = ET.ElementTree(root)
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0" encoding="UTF-8"?>\n')
        f.write(
            b'<!DOCTYPE GIFTI SYSTEM "http://www.nitrc.org/frs/'
            b'download.php/115/gifti.dtd">\n'
        )
        tree.write(f, xml_declaration=False)


def write_surf_gii(path: str, vertices: np.ndarray, faces: np.ndarray,
                   transform: np.ndarray | None = None):
    """Surface mesh: (n,3) f32 POINTSET + (m,3) i32 TRIANGLE."""
    write_gifti(path, [
        GiftiArray(
            "NIFTI_INTENT_POINTSET",
            np.asarray(vertices, np.float32),
            meta={"AnatomicalStructurePrimary": "Head",
                  "GeometricType": "Anatomical"},
            transform=(np.eye(4) if transform is None else transform),
        ),
        GiftiArray("NIFTI_INTENT_TRIANGLE", np.asarray(faces, np.int32)),
    ])


def read_surf_gii(path: str):
    """-> (vertices (n,3) f32 in the file's coordinate frame, faces i32).

    A POINTSET CoordinateSystemTransformMatrix, when present and
    non-identity, is applied (the convention the reference's PlanTUS
    meshes use for scanner-anatomical coordinates)."""
    verts = faces = None
    for arr in read_gifti(path):
        if arr.intent == "NIFTI_INTENT_POINTSET":
            verts = np.asarray(arr.data, np.float64)
            if arr.transform is not None and not np.allclose(
                arr.transform, np.eye(4)
            ):
                verts = (arr.transform[:3, :3] @ verts.T
                         + arr.transform[:3, 3:4]).T
            verts = verts.astype(np.float32)
        elif arr.intent == "NIFTI_INTENT_TRIANGLE":
            faces = np.asarray(arr.data, np.int32)
    if verts is None or faces is None:
        raise ValueError(f"{path}: not a surface gifti (need POINTSET "
                         "and TRIANGLE arrays)")
    return verts, faces


def write_func_gii(path: str, values: np.ndarray, name: str = "metric"):
    """Per-vertex scalar map(s): (n,) or (n,k) float."""
    v = np.asarray(values, np.float32)
    cols = v[:, None] if v.ndim == 1 else v
    write_gifti(path, [
        GiftiArray("NIFTI_INTENT_NONE", np.ascontiguousarray(col),
                   meta={"Name": f"{name}{i if cols.shape[1] > 1 else ''}"})
        for i, col in enumerate(cols.T)
    ])


def read_func_gii(path: str) -> np.ndarray:
    """-> (n,) for one map or (n,k) for several."""
    cols = [np.asarray(a.data, np.float32).ravel()
            for a in read_gifti(path)
            if a.intent not in ("NIFTI_INTENT_POINTSET",
                                "NIFTI_INTENT_TRIANGLE")]
    if not cols:
        raise ValueError(f"{path}: no scalar data arrays")
    return cols[0] if len(cols) == 1 else np.stack(cols, axis=1)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Outward per-vertex normals (area-weighted face-normal average,
    orientation fixed outward against the mesh centroid)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for c in range(3):
        np.add.at(n, f[:, c], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    outward = np.sum(n * (v - v.mean(axis=0)), axis=1)
    n[outward < 0] *= -1.0
    return n.astype(np.float32)
