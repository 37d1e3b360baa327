"""Step 1 — domain generation: segmentation + trajectory -> material mask.

TPU-first redesign of `BabelBrain/BabelDatasetPreps.py:GetSkullMaskFromSimbNIBSSTL`
(SURVEY.md sections 2.2/3.1). The reference goes labels -> marching-cubes
STL meshes -> GPU voxelization back to a grid; since meshing exists there
mainly for smoothing/FOV-cone intersection, this implementation works
directly on label volumes with the image ops (median smoothing, closing,
connected components) and resamples straight into the trajectory-aligned
simulation grid. STL inputs are still supported through ops.voxelize for
mesh-based workflows.

Counterpart of ``babelbrain_tpu/pipeline/step1.py``: mask generation and
its CT branch, whose image ops run in PyTorch on ``device``, and the host
helpers ``export_surface_meshes`` (``ops.mesh``) and ``create_target_mask``.

Outputs honor the Step-1 contract: a ``...BabelViscoInput.nii.gz``-style
label volume {0 water, 1 skin, 2 cortical, 3 trabecular, 4 brain, 5 target,
6 WM, 7 GM, 8 CSF} on an isotropic grid whose +z axis points along the
sonication trajectory, plus CT companions (quantized HU index volume +
UniqueHU vector) when CT/pseudo-CT data is given.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..materials.ct_mapping import quantize_hu
from ..ops import imaging as im

# SimNIBS charm final_tissues labels -> our categories
# (charm: 1 WM, 2 GM, 3 CSF, 4 spongy/cancellous bone, 5 scalp/skin,
#  6 eyes, 7 compact bone, 8 ... depends on version; headreco differs)
CHARM_TO_TISSUE = {
    1: "wm",
    2: "gm",
    3: "csf",
    4: "bone",
    5: "skin",
    6: "skin",
    7: "bone",
    8: "bone",
    9: "skin",
    10: "skin",
}

LABELS = dict(
    water=0, skin=1, cortical=2, trabecular=3, brain=4, target=5,
    wm=6, gm=7, csf=8,
)


def trajectory_frame(target_ras, direction_ras):
    """Orthonormal frame with +z along the (unit) trajectory direction.

    Equivalent to the reference's trajectory-aligned grid construction
    (`BabelDatasetPreps.py:594-728`); Brainsight/Slicer trajectory parsing
    lives in pipeline.transforms.
    """
    z = np.asarray(direction_ras, np.float64)
    z = z / np.linalg.norm(z)
    ref = np.array([1.0, 0.0, 0.0]) if abs(z[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(ref, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)  # columns = axes in RAS
    return R


def aligned_grid_affine(target_ras, direction_ras, dx_mm, shape, focus_frac=0.7):
    """Voxel->RAS affine of the trajectory-aligned isotropic grid.

    ``direction_ras`` points from the transducer INTO the head (the
    sonication direction). The grid's +z points back OUT toward the
    transducer, matching the Step-1 output contract (skin at high z; the
    acoustic stage z-flips into sim orientation). The target lands at
    ``focus_frac`` of the z extent at the x/y center.
    """
    R = trajectory_frame(target_ras, -np.asarray(direction_ras, np.float64))
    A = np.eye(4)
    A[:3, :3] = R * dx_mm
    center_vox = np.array(
        [shape[0] / 2.0, shape[1] / 2.0, shape[2] * focus_frac]
    )
    A[:3, 3] = np.asarray(target_ras) - A[:3, :3] @ center_vox
    return A


def _skin_depth_along_ray(labels, affine, target_ras, direction_ras,
                          max_mm=160.0, step_mm=0.5):
    """Distance (mm) from the target to the outermost labeled voxel along
    the outward trajectory (used to size the grid so skin/skull fit)."""
    lab = np.asarray(labels)
    inv = np.linalg.inv(affine)
    d = np.asarray(direction_ras, np.float64)
    d = d / np.linalg.norm(d)
    t = np.asarray(target_ras, np.float64)
    ts = np.arange(0.0, max_mm, step_mm)
    pts = t[None, :] - d[None, :] * ts[:, None]  # outward = -direction
    vox = (inv[:3, :3] @ pts.T + inv[:3, 3:4]).T
    ijk = np.round(vox).astype(int)
    ok = np.all((ijk >= 0) & (ijk < np.array(lab.shape)), axis=1)
    vals = np.zeros(len(ts))
    vals[ok] = lab[ijk[ok, 0], ijk[ok, 1], ijk[ok, 2]]
    nz = np.nonzero(vals > 0)[0]
    return float(ts[nz.max()]) if len(nz) else 60.0


@dataclass
class Step1Result:
    mask: np.ndarray  # label volume {0..8}
    affine: np.ndarray  # voxel->RAS of the aligned grid
    dx_mm: float
    target_idx: np.ndarray
    ct_index: np.ndarray | None = None  # quantized HU index per voxel
    unique_hu: np.ndarray | None = None
    air_mask: np.ndarray | None = None
    meta: dict = field(default_factory=dict)


def generate_mask(
    labels_data: np.ndarray,
    labels_affine: np.ndarray,
    target_ras,
    direction_ras,
    frequency: float,
    ppw: float,
    *,
    c_min: float = 1102.5,
    shape=None,
    segment_brain_tissue: bool = False,
    trabecular_proportion: float = 0.8,
    label_map: dict = None,
    smooth_median: int = 3,
    ct_data: np.ndarray | None = None,
    ct_affine: np.ndarray | None = None,
    hu_threshold: float = 300.0,
    hu_cap: float = 2100.0,
    ct_quantification_bits: int = 10,
    bone_rim_correction: bool = False,
    focus_frac: float | None = None,
    device="cuda",
) -> Step1Result:
    """Build the simulation-label volume on the trajectory-aligned grid.

    Pipeline (mirrors `BabelDatasetPreps.py:353-1180` behaviorally):
      1. dx = c_min/(f*PPW); build an aligned grid around the target.
      2. Resample the charm/headreco label volume into it (nearest).
      3. Derive skin/bone/brain masks; median-smooth; binary-close the bone;
         keep the largest bone island; fill the skull interior as brain.
      4. Split bone into cortical shell + trabecular core by erosion with
         ``trabecular_proportion`` (`:1101-1116`).
      5. Clear everything proximal of the first skin voxel along z
         (prefocal water region) and mark the target voxel (5).
      6. CT path: resample (pseudo-)CT onto the grid, cap HU, 3-D median,
         closing, largest component, quantize to 2^bits - 1 levels
         (`CTZTEProcessing` + `:1019-1064`).

    ``device`` is where the image ops run.
    """
    label_map = label_map or CHARM_TO_TISSUE
    dx_mm = c_min / frequency / ppw * 1000.0

    # depth of the outermost tissue along the trajectory (for z sizing)
    depth_mm = _skin_depth_along_ray(
        labels_data, labels_affine, target_ras, direction_ras
    )

    if shape is None:
        n_xy = int(np.ceil(120.0 / dx_mm))
        above = depth_mm + 18.0
        below = 40.0
        n_z = int(np.ceil((above + below) / dx_mm))
        shape = (n_xy, n_xy, n_z)
        focus_frac = below / (above + below)
    elif focus_frac is None:
        above = min(depth_mm + 15.0, shape[2] * dx_mm * 0.85)
        focus_frac = 1.0 - above / (shape[2] * dx_mm)
    A = aligned_grid_affine(target_ras, direction_ras, dx_mm, shape, focus_frac)

    lab = im.resample_from_to(
        labels_data.astype(np.float32), labels_affine, A, shape, order=0,
        device=device,
    ).astype(np.int32)

    cat = np.zeros(shape, np.uint8)  # 0 none,1 skin,2 bone,3 brainish,4 wm,5 gm,6 csf
    for lbl, name in label_map.items():
        sel = lab == lbl
        if name == "skin":
            cat[sel] = 1
        elif name == "bone":
            cat[sel] = 2
        elif name == "wm":
            cat[sel] = 4
        elif name == "gm":
            cat[sel] = 5
        elif name == "csf":
            cat[sel] = 6

    if smooth_median and smooth_median > 1:
        cat = im.median_filter3d(
            cat, smooth_median, device=device
        ).astype(np.uint8)

    bone = im.binary_close(cat == 2, 3, device=device)
    if bone.any():
        bone = im.largest_component(bone, device=device)
    skin = (cat == 1) | bone  # skin envelope includes bone for hole-filling
    skin = im.binary_close(skin, 3, device=device)
    brainish = (cat >= 3) & ~bone

    # split bone into cortical shell and trabecular core
    trabecular = np.zeros_like(bone)
    if bone.any() and trabecular_proportion > 0:
        n_er = max(1, int(round(2 * trabecular_proportion)))
        core = bone
        for _ in range(n_er):
            core = im.binary_erode(core, 3, device=device)
        trabecular = core

    mask = np.zeros(shape, np.uint8)
    mask[skin] = LABELS["skin"]
    mask[brainish] = LABELS["brain"]
    if segment_brain_tissue:
        mask[(cat == 4) & ~bone] = LABELS["wm"]
        mask[(cat == 5) & ~bone] = LABELS["gm"]
        mask[(cat == 6) & ~bone] = LABELS["csf"]
    mask[bone] = LABELS["cortical"]
    mask[trabecular] = LABELS["trabecular"]

    # prefocal cleanup: water above the skin entry (`:1120-1133`). In this
    # grid the transducer is at high z; clear tissue beyond the outermost
    # skin surface per column.
    any_tissue = mask > 0
    rev = any_tissue[:, :, ::-1]
    first = np.argmax(rev, axis=2)  # from the top
    has = rev.any(axis=2)
    nz = mask.shape[2]
    top_idx = np.where(has, nz - 1 - first, -1)
    zz = np.arange(nz)[None, None, :]
    beyond = zz > top_idx[:, :, None]
    mask[beyond] = 0

    # target voxel
    tgt = np.round(np.linalg.inv(A) @ np.append(np.asarray(target_ras), 1.0))[:3]
    tgt = tgt.astype(int)
    ti = tuple(np.clip(tgt, 0, np.array(shape) - 1))
    mask[ti] = LABELS["target"]

    result = Step1Result(
        mask=mask,
        affine=A,
        dx_mm=dx_mm,
        target_idx=np.array(ti),
        meta={"shape": shape, "frequency": frequency, "ppw": ppw},
    )

    if ct_data is not None:
        ct = im.resample_from_to(
            np.asarray(ct_data, np.float32),
            ct_affine if ct_affine is not None else labels_affine,
            A,
            shape,
            order=3,  # cubic, as the reference's CT resample
            device=device,
        )
        ct = np.minimum(ct, hu_cap)
        ct = im.median_filter3d(ct, 3, device=device)
        bone_region = (mask == LABELS["cortical"]) | (mask == LABELS["trabecular"])
        # floor bone HU at the threshold before the rim fix / quantization,
        # as the reference does (`BabelDatasetPreps.py:933`): partial-volume
        # rim voxels otherwise stretch the quantization range downward
        ct = np.where(bone_region, np.maximum(ct, hu_threshold), ct)
        if bone_rim_correction:
            # partial-volume rim fix before quantization (`:935-1017`)
            ct = maximize_bone_rim(ct, bone_region, voxels_per_mm=1.0 / dx_mm)
        uhu, ct_idx = quantize_hu(ct, bone_region, bits=ct_quantification_bits)
        # air regions in [-1200, -400] HU (`BabelDatasetPreps.py:1047-1064`),
        # restricted to INSIDE the head: the exterior of a head CT (and the
        # -1000 background a pseudo-CT assigns outside the head mask,
        # `CTZTEProcessing.py:619-621`) is air too, but the simulation's
        # background/coupling medium is water — only intracranial cavities
        # (sinuses, mastoid) become pressure-release reflectors
        air = (ct > -1200) & (ct < -400) & (mask > 0)
        result.ct_index = ct_idx
        result.unique_hu = uhu
        result.air_mask = air
    return result


def maximize_bone_rim(
    ct: np.ndarray,
    bone_mask: np.ndarray,
    voxels_per_mm: float,
    interior_threshold: float = 800.0,
    max_boost: float = 1000.0,
) -> np.ndarray:
    """Partial-volume edge correction: boost rim HU toward interior bone.

    Capability of the reference's ``bMaximizeBoneRim`` option
    (`BabelBrain/BabelDatasetPreps.py:935-1017`): CT voxels at the bone
    boundary read artificially low because of partial-volume averaging with
    soft tissue, which under-estimates skull attenuation/SoS. The fix blends
    each edge voxel (bone mask minus its erosion by a ~1 mm structure)
    toward a locally Gaussian-averaged interior-bone mean, weighted by
    exp(-d/scale) where d is the Euclidean distance to the eroded interior;
    the boost is clamped to ``max_boost`` HU and never lowers a value more
    than the blend itself. Returns a corrected copy of ``ct``.

    Host-side (scipy) like the rest of Step-1 preprocessing; runs once per
    case on a ~10^7-voxel grid.
    """
    from scipy import ndimage

    r = int(round(voxels_per_mm))
    if r % 2 == 0:
        r += 1
    r = max(r, 3)
    bone_mask = bone_mask.astype(bool)
    interior = ndimage.binary_erosion(bone_mask, structure=np.ones((r, r, r)))
    interior_val = bone_mask & (ct >= interior_threshold)
    if not interior_val.any():
        return ct
    global_mean = float(ct[interior_val].mean())
    dist = ndimage.distance_transform_edt(~interior)
    edge = bone_mask & ~interior
    if not edge.any():
        return ct
    weights = np.exp(-dist[edge] / (r / 2.0))
    blur_i = ndimage.gaussian_filter(ct * interior_val, sigma=r)
    blur_m = ndimage.gaussian_filter(interior_val.astype(np.float32), sigma=r)
    local_mean = np.where(blur_m > 1e-6, blur_i / np.maximum(blur_m, 1e-6),
                          global_mean)
    orig = ct[edge]
    delta = np.clip(weights * (local_mean[edge] - orig), None, max_boost)
    out = ct.copy()
    out[edge] = orig + delta
    return out


def export_surface_meshes(
    result: Step1Result,
    out_prefix: str,
    smooth_iterations: int = 10,
) -> dict:
    """Write skin / skull / brain-or-CSF surface STLs from a Step-1 result.

    Capability of the reference's `MaskToStl` stage
    (`BabelBrain/BabelDatasetPreps.py:87,476-494` — charm labels to
    skin.stl / bone.stl / csf.stl via vtk marching cubes + smoothing), here
    extracted from the aligned simulation labels with `ops.mesh`
    (marching tetrahedra + Taubin smoothing). Returns {name: path}.
    """
    from ..ops.mesh import mask_to_mesh
    from ..ops.voxelize import write_stl

    lab = result.mask
    surfaces = {
        "skin": lab >= 1,
        "bone": (lab == 2) | (lab == 3),
        "csf": np.isin(lab, (4, 5, 6, 7, 8)),
    }
    out = {}
    for name, m in surfaces.items():
        if not m.any():
            continue
        tris = mask_to_mesh(m, result.affine, smooth_iterations)
        path = f"{out_prefix}_{name}.stl"
        write_stl(path, tris)
        out[name] = path
    return out


def create_target_mask(in_path, ras_xyz, out_path=None, radii_vox=(1.0, 1.0, 1.0)):
    """Write a small ellipsoidal target-mask NIfTI at an RAS coordinate.

    Capability of the reference's PlanTUS helper
    (`BabelBrain/CreateVoxelMask.py:62-120` ``create_target_mask``): the RAS
    point (mm) is mapped through the inverse affine of ``in_path`` to a voxel
    index and an ellipsoid of ``radii_vox`` voxels is rasterized there. Used
    to hand a target seed to PlanTUS-style planning tools.

    Returns (mask ndarray, output path).
    """
    from .io import load_nifti, save_nifti

    img = load_nifti(in_path)
    affine = img.affine
    shape3 = img.data.shape[:3]
    vox = np.linalg.inv(affine) @ np.append(np.asarray(ras_xyz, float), 1.0)
    idx = np.rint(vox[:3]).astype(int)
    if np.any(idx < 0) or np.any(idx >= np.array(shape3)):
        raise ValueError(
            f"target voxel {tuple(idx)} out of bounds for shape {shape3}"
        )
    ri, rj, rk = radii_vox
    ii, jj, kk = np.ogrid[: shape3[0], : shape3[1], : shape3[2]]
    dist = (
        ((ii - idx[0]) / ri) ** 2
        + ((jj - idx[1]) / rj) ** 2
        + ((kk - idx[2]) / rk) ** 2
    )
    mask = (dist <= 1.0).astype(np.float32)
    if out_path is None:
        stem = in_path
        for suf in (".nii.gz", ".nii"):
            if stem.endswith(suf):
                stem = stem[: -len(suf)]
                break
        out_path = stem + "_mask.nii.gz"
    save_nifti(out_path, mask, affine)
    return mask, out_path
