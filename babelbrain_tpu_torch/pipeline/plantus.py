"""Transducer-placement planning (PlanTUS-equivalent capability).

The reference integrates the external PlanTUS toolbox through platform shell
scripts and a Qt viewer (`BabelBrain/PlanTUSViewer/RunPlanTUS.py:613-679`,
`PlanTUSViewer.py`), passing it a transducer-config YAML
(`RunPlanTUS.py:107-184`) and reading back per-vertex scalp metric maps.
Here the capability is implemented natively: candidate scalp positions are
scored with the same five weighted metrics PlanTUS exposes
(`RunPlanTUS.py:116-120` — skin-target distance, skin-target angle,
skin-target intersections, skin-skull incidence angle, skull thickness) on a
Step-1-style label volume, and the top candidates are returned as
Brainsight-compatible trajectories.

Also includes the O'Neil spherical-shell analytic axis used by the reference
to convert a requested focal depth into a TPO-equivalent setting + FLHM
(`RunPlanTUS.py:53-105`).

Numpy copy of ``babelbrain_tpu/pipeline/plantus.py`` (host code; the port
imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .step1 import LABELS, trajectory_frame


@dataclass
class PlanTUSConfig:
    """Transducer envelope + metric weights (`RunPlanTUS.py:107-159`)."""

    max_distance: float  # maximum focal depth (mm)
    min_distance: float  # minimum focal depth (mm)
    optimal_distance: float  # preferred skin-target distance (mm)
    transducer_diameter: float  # aperture (mm)
    max_angle: float  # maximum tilt from the scalp normal (deg)
    plane_offset: float = 0.0  # radiating surface to exit plane (mm)
    additional_offset: float = 0.0  # gel/silicone pad (mm)
    focal_distance_list: list = field(default_factory=list)  # calibration (mm)
    flhm_list: list = field(default_factory=list)  # FLHM at those depths (mm)
    weight_skin_target_distances: float = 0.2
    weight_skin_target_angles: float = 0.2
    weight_skin_target_intersections: float = 0.2
    weight_skin_skull_angles: float = 0.2
    weight_skull_thickness: float = 0.2

    def export_yaml(self, fname: str):
        """Write the reference's PlanTUS config-YAML contract
        (`RunPlanTUS.py:161-184` key set)."""
        import yaml

        txconfig = {
            "max_distance": self.max_distance,
            "min_distance": self.min_distance,
            "optimal_distance": self.optimal_distance,
            "transducer_diameter": self.transducer_diameter,
            "max_angle": self.max_angle,
            "plane_offset": self.plane_offset,
            "additional_offset": self.additional_offset,
            "focal_distance_list": list(self.focal_distance_list),
            "flhm_list": list(self.flhm_list),
            "weight_skin_target_distances": self.weight_skin_target_distances,
            "weight_skin_target_angles": self.weight_skin_target_angles,
            "weight_skin_target_intersections":
                self.weight_skin_target_intersections,
            "weight_skin_skull_angles": self.weight_skin_skull_angles,
            "weight_skull_thickness": self.weight_skull_thickness,
        }
        with open(fname, "w") as f:
            yaml.safe_dump(txconfig, f)


def acoustic_axis_oneil(frequency, aperture, focal_length, c=1500.0, step=0.05):
    """O'Neil on-axis pressure magnitude of a spherical-shell transducer.

    Returns (h, z, |P|) with h the shell depth and z from the apex plane
    (`RunPlanTUS.py:53-66` formula; also an analytic anchor for the Rayleigh
    propagator tests).
    """
    k = 2 * np.pi * frequency / c
    lam = c / frequency
    a = aperture / 2.0
    A = focal_length
    h = A - np.sqrt(A**2 - a**2)
    z = np.arange(0.0, 2 * focal_length, lam * step)
    B = np.sqrt((z - h) ** 2 + a**2)
    delta = B - z
    with np.errstate(divide="ignore", invalid="ignore"):
        E = 2.0 / (1.0 - z / A)
    P = E * np.sin(k * delta / 2.0)
    P[~np.isfinite(P)] = 0.0
    return h, z, np.abs(P)


def find_tpo_equivalent(frequency, aperture, focal_length):
    """(h, TPO-equivalent depth, FLHM) from the analytic axis.

    TPO = axial peak nearest the geometric focus, relative to the exit
    plane; FLHM = full length at half-maximum pressure around that peak
    (`RunPlanTUS.py:68-105`).
    """
    h, z, p = acoustic_axis_oneil(frequency, aperture, focal_length)
    # local maxima (simple neighbor test, no plateau handling needed for |P|)
    interior = (p[1:-1] > p[:-2]) & (p[1:-1] >= p[2:])
    peaks = np.nonzero(interior)[0] + 1
    if len(peaks) == 0:
        peaks = np.array([int(np.argmax(p))])
    pk = peaks[np.argmin(np.abs(z[peaks] - focal_length))]
    half = 0.5 * p[pk]
    above = p >= half
    # walk out from the peak to the half-maximum crossings
    lo = pk
    while lo > 0 and above[lo - 1]:
        lo -= 1
    hi = pk
    while hi < len(p) - 1 and above[hi + 1]:
        hi += 1
    flhm = z[hi] - z[lo]
    return h, z[pk] - h, flhm


def recommended_focal_setting(
    config: PlanTUSConfig, skin_target_distance_mm: float
) -> dict:
    """Focal setting + expected FLHM for a given skin-target distance.

    Uses the device calibration lists the reference feeds PlanTUS
    (`RunPlanTUS.py:155-159` focal_distance_list/flhm_list): the focal
    depth to program is the skin-target distance plus the exit-plane
    offsets, clamped to the device envelope; the expected FLHM is
    interpolated from the calibration table. Falls back to the O'Neil
    analytic FLHM for a generic spherical shell when no calibration is
    given (the reference's bUseGenericTransducerModel branch).
    """
    depth = (
        skin_target_distance_mm + config.plane_offset + config.additional_offset
    )
    clamped = float(np.clip(depth, config.min_distance, config.max_distance))
    if config.focal_distance_list and config.flhm_list:
        flhm = float(
            np.interp(clamped, config.focal_distance_list, config.flhm_list)
        )
    else:
        # generic model: spherical shell of the config aperture focused at
        # the requested depth (mm -> m at 500 kHz reference frequency)
        _, _, flhm_m = find_tpo_equivalent(
            500e3, config.transducer_diameter * 1e-3, clamped * 1e-3
        )
        flhm = float(flhm_m * 1e3)
    return {
        "focal_depth_mm": clamped,
        "in_envelope": bool(
            config.min_distance <= depth <= config.max_distance
        ),
        "expected_flhm_mm": flhm,
    }


def _box_smooth(vol: np.ndarray, r: int = 2) -> np.ndarray:
    """Separable uniform filter (radius r) via cumulative sums."""
    out = np.asarray(vol, np.float32)
    for ax in range(3):
        pad = [(0, 0)] * 3
        pad[ax] = (r + 1, r)
        c = np.cumsum(np.pad(out, pad), axis=ax)
        sl_hi = [slice(None)] * 3
        sl_hi[ax] = slice(2 * r + 1, None)
        sl_lo = [slice(None)] * 3
        sl_lo[ax] = slice(None, -(2 * r + 1))
        out = (c[tuple(sl_hi)] - c[tuple(sl_lo)]) / (2 * r + 1)
    return out


def _surface_normals(mask: np.ndarray) -> np.ndarray:
    """Outward unit normals of a binary mask from its smoothed gradient."""
    sm = _box_smooth(mask.astype(np.float32))
    g = np.stack(np.gradient(sm), axis=-1)
    n = -g  # gradient points inward (mask increases into the object)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    ln[ln == 0] = 1.0
    return n / ln


@dataclass
class PlacementResult:
    positions_ras: np.ndarray  # (K, 3) scalp entry points
    directions_ras: np.ndarray  # (K, 3) unit vectors entry -> target
    scores: np.ndarray  # (K,) weighted score, lower is better
    metrics: dict  # per-candidate raw metric arrays (all candidates)
    candidates_ras: np.ndarray  # (N, 3) every feasible scalp candidate
    order: np.ndarray  # (N,) candidate ranking (indices into candidates)
    # mesh-candidate mode only: vertex index of each feasible candidate
    # in the scalp mesh (for per-vertex .func.gii metric maps)
    candidate_vertices: np.ndarray | None = None

    def trajectory(self, rank: int = 0) -> np.ndarray:
        """Brainsight-style 4x4 for the rank-th placement: target in the
        translation column, -z column = sonication direction (the convention
        of `pipeline.transforms.trajectory_target_direction`)."""
        d = self.directions_ras[rank]
        R = trajectory_frame(self.positions_ras[rank], -d)
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = self.target_ras
        return M

    target_ras: np.ndarray = None


def suggest_placements(
    labels: np.ndarray,
    affine: np.ndarray,
    target_ras,
    config: PlanTUSConfig,
    *,
    skin_label: int = LABELS["skin"],
    skull_labels=(LABELS["cortical"], LABELS["trabecular"]),
    step_mm: float = 0.5,
    top_k: int = 10,
    max_candidates: int = 20000,
    scalp_mesh=None,
) -> PlacementResult:
    """Rank scalp entry points for sonicating ``target_ras``.

    Metrics per candidate (PlanTUS's five, `RunPlanTUS.py:116-120`):
      skin-target distance (deviation from ``optimal_distance`` when set,
      else raw), skin-target angle (tilt from the scalp normal), number of
      skin intersections along the beam path (ears/nose-grazing paths),
      skull incidence angle at bone entry, and skull thickness along the
      path. Each is min-max normalized over the feasible candidates and
      combined with the config weights (lower = better).

    ``scalp_mesh`` = (vertices_ras (n,3), faces (m,3)): candidates are
    the mesh vertices (with outward per-vertex normals) instead of scalp
    voxels — the interchange contract PlanTUS/neuronavigation workflows
    use (``*.surf.gii`` scalp meshes, `RunPlanTUS.py:338,492`; load with
    ``gifti.read_surf_gii``). Per-vertex metric maps for the mesh come
    from ``export_metric_func_gii``.
    """
    lab = np.asarray(labels)
    target = np.asarray(target_ras, np.float64)
    inv = np.linalg.inv(affine)

    head = lab > 0
    skin = lab == skin_label
    skull = np.isin(lab, skull_labels)

    if scalp_mesh is not None:
        from .gifti import vertex_normals

        verts, faces = scalp_mesh
        verts = np.asarray(verts, np.float64)
        cand_vertex = np.arange(len(verts))
        if len(verts) > max_candidates:
            cand_vertex = np.linspace(
                0, len(verts) - 1, max_candidates
            ).astype(int)
        pos = verts[cand_vertex]
        normals = np.asarray(
            vertex_normals(verts, faces), np.float64
        )[cand_vertex]
    else:
        # scalp voxels: skin with at least one 6-neighbor outside the head
        outside = ~head
        nb = np.zeros_like(skin)
        for ax in range(3):
            for sh in (1, -1):
                nb |= np.roll(outside, sh, axis=ax)
        scalp = skin & nb
        idx = np.argwhere(scalp)
        if len(idx) == 0:
            raise ValueError("no scalp (skin) surface voxels found in labels")
        if len(idx) > max_candidates:
            sel = np.linspace(0, len(idx) - 1, max_candidates).astype(int)
            idx = idx[sel]
        cand_vertex = None
        pos = (affine[:3, :3] @ idx.T + affine[:3, 3:4]).T  # (N,3) RAS
        normals = _surface_normals(head)[idx[:, 0], idx[:, 1], idx[:, 2]]

    dvec = target[None, :] - pos
    dist = np.linalg.norm(dvec, axis=1)
    dirs = dvec / dist[:, None]

    # feasibility: focal-depth envelope + tilt limit
    eff = dist + config.plane_offset + config.additional_offset
    cos_tilt = np.clip(np.sum(-normals * dirs, axis=1), -1.0, 1.0)
    tilt = np.degrees(np.arccos(cos_tilt))
    feasible = (
        (eff >= config.min_distance)
        & (eff <= config.max_distance)
        & (tilt <= config.max_angle)
    )
    if not feasible.any():
        raise ValueError(
            "no feasible scalp candidates (focal-depth envelope "
            f"[{config.min_distance}, {config.max_distance}] mm, "
            f"max tilt {config.max_angle} deg)"
        )
    if cand_vertex is not None:
        cand_vertex = cand_vertex[feasible]
    pos, dirs, dist, eff, tilt = (
        a[feasible] for a in (pos, dirs, dist, eff, tilt)
    )

    # march every ray at step_mm resolution (vectorized N x T lookups)
    n_t = int(np.ceil(dist.max() / step_mm))
    ts = (np.arange(n_t) + 0.5) * step_mm
    pts = pos[:, None, :] + dirs[:, None, :] * ts[None, :, None]
    vox = np.einsum("ij,ntj->nti", inv[:3, :3], pts) + inv[:3, 3]
    ijk = np.round(vox).astype(int)
    inside = np.all(
        (ijk >= 0) & (ijk < np.array(lab.shape)), axis=-1
    ) & (ts[None, :] < dist[:, None])
    ijk_c = np.clip(ijk, 0, np.array(lab.shape) - 1)
    lab_ray = np.where(
        inside, lab[ijk_c[..., 0], ijk_c[..., 1], ijk_c[..., 2]], 0
    )

    skull_thick = step_mm * np.isin(lab_ray, skull_labels).sum(axis=1)
    is_skin_ray = lab_ray == skin_label
    entries = (
        is_skin_ray[:, 1:] & ~is_skin_ray[:, :-1]
    ).sum(axis=1) + is_skin_ray[:, 0].astype(int)
    intersections = np.maximum(entries - 1, 0)  # first skin entry is free

    # skull incidence angle at first bone voxel along the ray
    is_skull_ray = np.isin(lab_ray, skull_labels)
    has_skull = is_skull_ray.any(axis=1)
    first = np.where(has_skull, is_skull_ray.argmax(axis=1), 0)
    skull_n = _surface_normals(skull)
    e_ijk = ijk_c[np.arange(len(pos)), first]
    n_sk = skull_n[e_ijk[:, 0], e_ijk[:, 1], e_ijk[:, 2]]
    cos_inc = np.clip(np.sum(-n_sk * dirs, axis=1), -1.0, 1.0)
    incidence = np.where(
        has_skull, np.degrees(np.arccos(cos_inc)), 0.0
    )

    if config.optimal_distance is not None and config.optimal_distance > 0:
        dist_metric = np.abs(eff - config.optimal_distance)
    else:
        dist_metric = eff

    def norm01(v):
        v = np.asarray(v, np.float64)
        lo, hi = v.min(), v.max()
        return np.zeros_like(v) if hi == lo else (v - lo) / (hi - lo)

    score = (
        config.weight_skin_target_distances * norm01(dist_metric)
        + config.weight_skin_target_angles * norm01(tilt)
        + config.weight_skin_target_intersections * norm01(intersections)
        + config.weight_skin_skull_angles * norm01(incidence)
        + config.weight_skull_thickness * norm01(skull_thick)
    )
    order = np.argsort(score, kind="stable")
    k = min(top_k, len(order))
    sel = order[:k]
    return PlacementResult(
        positions_ras=pos[sel],
        directions_ras=dirs[sel],
        scores=score[sel],
        metrics={
            "skin_target_distance": eff,
            "skin_target_angle": tilt,
            "skin_intersections": intersections,
            "skull_incidence_angle": incidence,
            "skull_thickness": skull_thick,
            "score": score,
        },
        candidates_ras=pos,
        order=order,
        candidate_vertices=cand_vertex,
        target_ras=target,
    )


def export_scalp_surf_gii(
    path: str, labels: np.ndarray, affine: np.ndarray,
    smooth_iters: int = 10,
):
    """Extract the scalp surface from a label volume and write it as a
    ``*.surf.gii`` mesh in RAS (the scalp-surface interchange PlanTUS
    workflows expect, `RunPlanTUS.py:338`). Returns (vertices, faces)."""
    from ..ops.mesh import mask_to_mesh, weld_vertices

    lab = np.asarray(labels)
    tris = mask_to_mesh(lab >= 1, smooth_iterations=smooth_iters)
    verts, faces = weld_vertices(tris)
    ras = (affine[:3, :3] @ verts.T + affine[:3, 3:4]).T
    from .gifti import write_surf_gii

    write_surf_gii(path, ras, faces)
    return ras.astype(np.float32), faces


def export_metric_func_gii(
    path: str, result: PlacementResult, n_vertices: int,
    metric: str = "score",
):
    """Per-vertex ``*.func.gii`` metric map for a mesh-candidate planner
    run (the reference's flattened scalp metric maps,
    `RunPlanTUS.py:541-545`): feasible candidate vertices carry the
    metric, everything else NaN."""
    if result.candidate_vertices is None:
        raise ValueError(
            "planner was not run with scalp_mesh=...; per-vertex maps "
            "need mesh candidates"
        )
    from .gifti import write_func_gii

    vals = np.full(int(n_vertices), np.nan, np.float32)
    vals[result.candidate_vertices] = np.asarray(
        result.metrics[metric], np.float32
    )
    write_func_gii(path, vals, name=metric)
    return vals


def metric_volume(
    labels: np.ndarray, affine: np.ndarray, result: PlacementResult,
    metric: str = "score",
) -> np.ndarray:
    """Paint a candidate metric onto the scalp voxels (NaN elsewhere) — the
    library-level stand-in for PlanTUS's flattened scalp metric maps."""
    vol = np.full(np.asarray(labels).shape, np.nan, np.float32)
    inv = np.linalg.inv(affine)
    ijk = np.round(
        (inv[:3, :3] @ result.candidates_ras.T + inv[:3, 3:4]).T
    ).astype(int)
    vol[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = result.metrics[metric]
    return vol


def export_placements_csv(path: str, result: PlacementResult):
    """Ranked candidate table (position, direction, score)."""
    with open(path, "w") as f:
        f.write(
            "rank,x,y,z,dx,dy,dz,score,skin_target_distance,"
            "skin_target_angle,skull_incidence_angle,skull_thickness\n"
        )
        m = result.metrics
        for r in range(len(result.positions_ras)):
            i = result.order[r]
            p = result.positions_ras[r]
            d = result.directions_ras[r]
            f.write(
                f"{r},{p[0]:.3f},{p[1]:.3f},{p[2]:.3f},"
                f"{d[0]:.5f},{d[1]:.5f},{d[2]:.5f},"
                f"{result.scores[r]:.5f},"
                f"{m['skin_target_distance'][i]:.3f},"
                f"{m['skin_target_angle'][i]:.2f},"
                f"{m['skull_incidence_angle'][i]:.2f},"
                f"{m['skull_thickness'][i]:.3f}\n"
            )
