"""Coordinate transforms: Brainsight / 3DSlicer trajectory interchange.

Re-implements `BabelBrain/ConvMatTransform.py` (SURVEY.md section 2.2):
Brainsight exported-trajectory text files, ITK ``.tfm`` affine transforms,
and the RAS<->LPS handling between them. The sonication direction is the
-z column of the trajectory matrix (Brainsight convention).

Numpy copy of ``babelbrain_tpu/pipeline/transforms.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

import re

import numpy as np

LPS_TO_RAS = np.diag([-1.0, -1.0, 1.0, 1.0])


def read_trajectory_brainsight(path: str):
    """Parse a Brainsight trajectory export.

    Returns (name, matrix4x4) where the matrix columns are the trajectory
    frame in RAS and the translation is the target position
    (`ConvMatTransform.py:121` equivalent). Expects the standard export with
    '# Target name' header and a data line holding name + 12 or 16 floats.
    """
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    data = None
    name = "Target"
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        parts = ln.split("\t")
        floats = []
        for p in parts[1:]:
            try:
                floats.append(float(p))
            except ValueError:
                pass
        if len(floats) >= 12:
            name = parts[0]
            data = floats
            break
    if data is None:
        raise ValueError(f"{path}: no trajectory data line found")
    m = np.eye(4)
    # Brainsight: target x,y,z then 3x3 orientation (m0..m8) column-major
    tgt = np.array(data[0:3])
    rot = np.array(data[3:12]).reshape(3, 3).T
    m[:3, :3] = rot
    m[:3, 3] = tgt
    return name, m


def write_trajectory_brainsight(path: str, name: str, matrix: np.ndarray):
    m = np.asarray(matrix)
    vals = list(m[:3, 3]) + list(m[:3, :3].T.ravel())
    with open(path, "w") as f:
        f.write("# Version: 7\n# Coordinate system: NIfTI:Aligned\n")
        f.write(
            "# Target name\tLoc. X\tLoc. Y\tLoc. Z\tm0\tm1\tm2\tm3\tm4\tm5\tm6\tm7\tm8\n"
        )
        f.write(name + "\t" + "\t".join(f"{v:.4f}" for v in vals) + "\n")


def read_itk_tfm(path: str) -> np.ndarray:
    """Read an ITK .tfm affine (LPS); returns a 4x4 RAS matrix
    (`ConvMatTransform.py:29-99` equivalent)."""
    params = None
    fixed = np.zeros(3)
    with open(path) as f:
        for ln in f:
            if ln.startswith("Parameters:"):
                params = np.array([float(v) for v in ln.split(":")[1].split()])
            elif ln.startswith("FixedParameters:"):
                fixed = np.array([float(v) for v in ln.split(":")[1].split()])
    if params is None or len(params) != 12:
        raise ValueError(f"{path}: not a 12-parameter affine tfm")
    m = np.eye(4)
    m[:3, :3] = params[:9].reshape(3, 3)
    m[:3, 3] = params[9:12] + fixed - m[:3, :3] @ fixed
    return LPS_TO_RAS @ m @ LPS_TO_RAS


def write_itk_tfm(path: str, matrix_ras: np.ndarray):
    m = LPS_TO_RAS @ np.asarray(matrix_ras) @ LPS_TO_RAS
    with open(path, "w") as f:
        f.write("#Insight Transform File V1.0\n#Transform 0\n")
        f.write("Transform: AffineTransform_double_3_3\n")
        vals = list(m[:3, :3].ravel()) + list(m[:3, 3])
        f.write("Parameters: " + " ".join(f"{v:.9f}" for v in vals) + "\n")
        f.write("FixedParameters: 0 0 0\n")


def trajectory_target_direction(matrix: np.ndarray):
    """(target_ras, direction_ras) from a trajectory matrix; the sonication
    direction points INTO the head along -z of the trajectory frame."""
    m = np.asarray(matrix)
    return m[:3, 3].copy(), -m[:3, 2].copy()
