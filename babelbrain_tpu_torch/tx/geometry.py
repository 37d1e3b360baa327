"""Transducer surface discretization.

Generates quadrature meshes (sub-element centers, areas, normals) for the
transducer families the reference supports
(`TranscranialModeling/BabelIntegrationSingle.py:26-137`,
`BabelIntegrationANNULAR_ARRAY.py:139-161`, CONCAVE/REMOPD/DOME modules):

  * focused bowls (single-element, spherical cap),
  * annular ring arrays (concentric spherical-cap rings),
  * concave multi-element phased arrays (circular elements on a spherical
    shell, element centers from device tables),
  * flat 2-D grids of square elements.

Everything is vectorized NumPy executed once at setup; the output feeds the
Rayleigh propagator. Geometry convention matches the reference: the bowl
sits at negative z with its geometric focus at the origin; callers shift by
+focal_length to place the focus.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Transducer:
    """Discretized radiating surface.

    ``centers``/``areas``/``normals`` describe quadrature sub-elements;
    ``elem_ids`` maps each sub-element to its physical (drivable) element and
    ``elem_centers`` gives one representative center per physical element
    (used to compute steering phases).
    """

    centers: np.ndarray  # (M, 3) float32
    areas: np.ndarray  # (M,) float32
    normals: np.ndarray  # (M, 3) float32
    elem_ids: np.ndarray  # (M,) int32
    elem_centers: np.ndarray  # (E, 3) float32
    meta: dict = field(default_factory=dict)

    @property
    def num_subelements(self) -> int:
        return self.centers.shape[0]

    @property
    def num_elements(self) -> int:
        return self.elem_centers.shape[0]

    def translated(self, offset) -> "Transducer":
        off = np.asarray(offset, np.float64)
        return Transducer(
            centers=(self.centers + off).astype(np.float32),
            areas=self.areas,
            normals=self.normals,
            elem_ids=self.elem_ids,
            elem_centers=(self.elem_centers + off).astype(np.float32),
            meta=dict(self.meta),
        )

    def total_area(self) -> float:
        return float(self.areas.sum())

    @staticmethod
    def concatenate(parts: list["Transducer"]) -> "Transducer":
        elem_offset = 0
        ids = []
        ecenters = []
        for p in parts:
            ids.append(p.elem_ids + elem_offset)
            ecenters.append(p.elem_centers)
            elem_offset += p.num_elements
        return Transducer(
            centers=np.concatenate([p.centers for p in parts]).astype(np.float32),
            areas=np.concatenate([p.areas for p in parts]).astype(np.float32),
            normals=np.concatenate([p.normals for p in parts]).astype(np.float32),
            elem_ids=np.concatenate(ids).astype(np.int32),
            elem_centers=np.concatenate(ecenters).astype(np.float32),
            meta={},
        )


def make_spherical_cap(
    focal_length: float,
    out_diameter: float,
    step: float,
    in_diameter: float = 0.0,
    elem_id: int = 0,
) -> Transducer:
    """Discretize a spherical-cap annulus into quadrature patches.

    Rings of constant polar angle beta in [beta1, beta2] (beta =
    arcsin(r / focal_length)), each ring split into ceil(perimeter/step)
    azimuthal patches. Patch areas are the exact sphere-patch areas
    F^2 (cos b1 - cos b2) dalpha, so the sum telescopes to the analytic cap
    area. This is the same quadrature the reference builds
    (`BabelIntegrationSingle.py:26-130`) with a vectorized construction.
    """
    F = float(focal_length)
    b1 = np.arcsin(0.5 * in_diameter / F)
    b2 = np.arcsin(0.5 * out_diameter / F)
    n_rings = max(int(np.ceil((b2 - b1) * F / step)), 1)
    dbeta = (b2 - b1) / n_rings
    beta_lo = b1 + dbeta * np.arange(n_rings)
    beta_c = beta_lo + 0.5 * dbeta

    # azimuthal counts per ring
    perim = 2.0 * np.pi * F * np.sin(beta_c)
    n_alpha = np.maximum(np.ceil(perim / step).astype(int), 1)

    ring_idx = np.repeat(np.arange(n_rings), n_alpha)
    # patch index within its ring
    starts = np.concatenate([[0], np.cumsum(n_alpha)[:-1]])
    j = np.arange(n_alpha.sum()) - starts[ring_idx]
    dalpha = 2.0 * np.pi / n_alpha[ring_idx]
    alpha = (j + 0.5) * dalpha

    bc = beta_c[ring_idx]
    sin_b, cos_b = np.sin(bc), np.cos(bc)
    centers = np.stack(
        [F * sin_b * np.cos(alpha), F * sin_b * np.sin(alpha), -F * cos_b], axis=1
    )
    blo = beta_lo[ring_idx]
    areas = F * F * (np.cos(blo) - np.cos(blo + dbeta)) * dalpha
    normals = -centers / F  # toward the geometric focus at the origin

    center_beta = 0.5 * (b1 + b2)
    elem_center = np.array(
        [[F * np.sin(center_beta), 0.0, -F * np.cos(center_beta)]]
    )
    return Transducer(
        centers=centers.astype(np.float32),
        areas=areas.astype(np.float32),
        normals=normals.astype(np.float32),
        elem_ids=np.full(centers.shape[0], elem_id, np.int32),
        elem_centers=elem_center.astype(np.float32),
        meta={
            "focal_length": F,
            "out_diameter": out_diameter,
            "in_diameter": in_diameter,
            "beta1": float(b1),
            "beta2": float(b2),
        },
    )


def make_focused_bowl(
    frequency: float,
    focal_length: float,
    diameter: float,
    sos: float,
    ppw_surface: float = 8.0,
) -> Transducer:
    """Single-element focused bowl (the reference's ``GenerateFocusTx``)."""
    step = sos / frequency / ppw_surface
    tx = make_spherical_cap(focal_length, diameter, step)
    tx.meta["frequency"] = frequency
    return tx


def make_annular_array(
    frequency: float,
    focal_length: float,
    in_diameters,
    out_diameters,
    sos: float,
    ppw_surface: float = 8.0,
) -> Transducer:
    """Concentric-ring array (CTX-500/250, DPX, R15287-style).

    One physical element per ring (`BabelIntegrationANNULAR_ARRAY.py:139-161`).
    """
    step = sos / frequency / ppw_surface
    rings = [
        make_spherical_cap(focal_length, od, step, in_diameter=idm)
        for idm, od in zip(in_diameters, out_diameters)
    ]
    tx = Transducer.concatenate(rings)
    tx.meta = {
        "frequency": frequency,
        "focal_length": focal_length,
        "in_diameters": list(in_diameters),
        "out_diameters": list(out_diameters),
    }
    return tx


def _orthonormal_frame(n):
    """Tangent basis (t1, t2) for unit vector(s) n, shape (...,3)."""
    n = np.asarray(n, np.float64)
    ref = np.where(
        np.abs(n[..., 2:3]) < 0.9,
        np.broadcast_to([0.0, 0.0, 1.0], n.shape),
        np.broadcast_to([1.0, 0.0, 0.0], n.shape),
    )
    t1 = np.cross(ref, n)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    return t1, t2


def make_concave_array(
    frequency: float,
    focal_length: float,
    elem_diameter: float,
    elem_centers: np.ndarray,
    sos: float,
    ppw_surface: float = 8.0,
) -> Transducer:
    """Multi-element concave phased array (H-317/I12378/ATAC/R15148 style).

    ``elem_centers`` (E,3) are element centers on (or near) the spherical
    shell of radius ``focal_length`` centered at the origin-focus. Each
    circular element is tessellated with a polar sub-grid in its tangent
    plane, then projected back onto the sphere so sub-element phases are
    exact (`BabelIntegrationCONCAVE_PHASEDARRAY.py` keeps per-element meshes
    the same way via repeated cap generation + rotation).
    """
    F = float(focal_length)
    step = sos / frequency / ppw_surface
    ec = np.asarray(elem_centers, np.float64)
    r_elem = elem_diameter / 2.0

    # polar sub-grid template in local tangent coordinates
    n_r = max(int(np.ceil(r_elem / step)), 1)
    dr = r_elem / n_r
    rows = []
    for i in range(n_r):
        rc = (i + 0.5) * dr
        n_a = max(int(np.ceil(2 * np.pi * rc / step)), 1)
        da = 2 * np.pi / n_a
        ang = (np.arange(n_a) + 0.5) * da
        area = 0.5 * ((rc + dr / 2) ** 2 - (rc - dr / 2) ** 2) * da
        rows.append(
            np.stack(
                [rc * np.cos(ang), rc * np.sin(ang), np.full(n_a, area)], axis=1
            )
        )
    template = np.concatenate(rows)  # (S, 3): u, v, area

    nrm = -ec / np.linalg.norm(ec, axis=1, keepdims=True)  # toward focus
    t1, t2 = _orthonormal_frame(nrm)

    # place template on each element tangent plane and project onto sphere
    uv = template[:, :2]
    pts = (
        ec[:, None, :]
        + uv[None, :, 0:1] * t1[:, None, :]
        + uv[None, :, 1:2] * t2[:, None, :]
    )  # (E, S, 3)
    # radial projection onto the shell |x| = F (keeps curvature-correct phase)
    norms = np.linalg.norm(pts, axis=2, keepdims=True)
    pts = pts * (F / norms)
    areas = np.broadcast_to(template[None, :, 2], pts.shape[:2])
    normals = -pts / F

    E, S = pts.shape[:2]
    return Transducer(
        centers=pts.reshape(E * S, 3).astype(np.float32),
        areas=np.ascontiguousarray(areas.reshape(E * S)).astype(np.float32),
        normals=normals.reshape(E * S, 3).astype(np.float32),
        elem_ids=np.repeat(np.arange(E, dtype=np.int32), S),
        elem_centers=ec.astype(np.float32),
        meta={
            "frequency": frequency,
            "focal_length": F,
            "elem_diameter": elem_diameter,
            "subelems_per_elem": S,
        },
    )


def make_flat_grid_array(
    frequency: float,
    pitch: float,
    n_x: int,
    n_y: int,
    elem_width: float,
    sos: float,
    ppw_surface: float = 8.0,
) -> Transducer:
    """Flat 2-D array of square elements at z=0 (REMOPD/H246-style,
    `BabelIntegrationREMOPD.py:28-70`)."""
    step = sos / frequency / ppw_surface
    n_sub = max(int(np.ceil(elem_width / step)), 1)
    sub = (np.arange(n_sub) + 0.5) / n_sub * elem_width - elem_width / 2
    su, sv = np.meshgrid(sub, sub, indexing="ij")
    sub_area = (elem_width / n_sub) ** 2

    ex = (np.arange(n_x) - (n_x - 1) / 2) * pitch
    ey = (np.arange(n_y) - (n_y - 1) / 2) * pitch
    gx, gy = np.meshgrid(ex, ey, indexing="ij")
    ecenters = np.stack([gx.ravel(), gy.ravel(), np.zeros(n_x * n_y)], axis=1)

    E = n_x * n_y
    S = n_sub * n_sub
    centers = np.zeros((E, S, 3))
    centers[:, :, 0] = ecenters[:, None, 0] + su.ravel()[None, :]
    centers[:, :, 1] = ecenters[:, None, 1] + sv.ravel()[None, :]
    return Transducer(
        centers=centers.reshape(E * S, 3).astype(np.float32),
        areas=np.full(E * S, sub_area, np.float32),
        normals=np.tile(np.array([0.0, 0.0, 1.0], np.float32), (E * S, 1)),
        elem_ids=np.repeat(np.arange(E, dtype=np.int32), S),
        elem_centers=ecenters.astype(np.float32),
        meta={"frequency": frequency, "pitch": pitch, "n_x": n_x, "n_y": n_y},
    )


def make_flat_array_from_positions(
    frequency: float,
    positions: np.ndarray,
    elem_width: float,
    sos: float,
    ppw_surface: float = 8.0,
    z_offset: float = 0.0,
) -> Transducer:
    """Flat array of square elements at measured (x, y) positions
    (REMOPD: `BabelIntegrationREMOPD.py:36-85`, elements of side
    pitch-kerf = 2.58 mm at z = -1.2 mm from the outplane)."""
    pos = np.asarray(positions, np.float64)
    step = sos / frequency / ppw_surface
    n_sub = max(int(np.round(elem_width / step)), 1)
    sub = (np.arange(n_sub) + 0.5) / n_sub * elem_width - elem_width / 2
    su, sv = np.meshgrid(sub, sub, indexing="ij")
    sub_area = (elem_width / n_sub) ** 2

    E = pos.shape[0]
    S = n_sub * n_sub
    centers = np.zeros((E, S, 3))
    centers[:, :, 0] = pos[:, None, 0] + su.ravel()[None, :]
    centers[:, :, 1] = pos[:, None, 1] + sv.ravel()[None, :]
    centers[:, :, 2] = pos[:, None, 2] + z_offset
    ecenters = pos.copy()
    ecenters[:, 2] += z_offset
    return Transducer(
        centers=centers.reshape(E * S, 3).astype(np.float32),
        areas=np.full(E * S, sub_area, np.float32),
        normals=np.tile(np.array([0.0, 0.0, 1.0], np.float32), (E * S, 1)),
        elem_ids=np.repeat(np.arange(E, dtype=np.int32), S),
        elem_centers=ecenters.astype(np.float32),
        meta={"frequency": frequency, "elem_width": elem_width},
    )


def make_flat_ring_array(
    frequency: float,
    in_diameters,
    out_diameters,
    sos: float,
    ppw_surface: float = 8.0,
) -> Transducer:
    """Flat concentric-annulus array at z=0 (H246: the reference generates a
    quasi-flat bowl at F=1000 m and zeroes z, `BabelIntegrationH246.py:271-288`).
    One physical element per annulus; patch areas are exact annulus sectors."""
    step = sos / frequency / ppw_surface
    parts = []
    for e, (din, dout) in enumerate(zip(in_diameters, out_diameters)):
        r1, r2 = din / 2.0, dout / 2.0
        n_r = max(int(np.ceil((r2 - r1) / step)), 1)
        dr = (r2 - r1) / n_r
        rows = []
        for i in range(n_r):
            rc = r1 + (i + 0.5) * dr
            n_a = max(int(np.ceil(2 * np.pi * rc / step)), 1)
            da = 2 * np.pi / n_a
            ang = (np.arange(n_a) + 0.5) * da
            area = 0.5 * ((rc + dr / 2) ** 2 - (rc - dr / 2) ** 2) * da
            rows.append(np.stack(
                [rc * np.cos(ang), rc * np.sin(ang),
                 np.zeros(n_a), np.full(n_a, area)], axis=1))
        patches = np.concatenate(rows)
        parts.append(Transducer(
            centers=patches[:, :3].astype(np.float32),
            areas=patches[:, 3].astype(np.float32),
            normals=np.tile(np.array([0.0, 0.0, 1.0], np.float32),
                            (patches.shape[0], 1)),
            elem_ids=np.zeros(patches.shape[0], np.int32),
            elem_centers=np.array([[0.5 * (r1 + r2), 0.0, 0.0]], np.float32),
            meta={},
        ))
    tx = Transducer.concatenate(parts)
    tx.meta = {
        "frequency": frequency,
        "in_diameters": list(in_diameters),
        "out_diameters": list(out_diameters),
    }
    return tx


def cap_area(focal_length: float, out_diameter: float, in_diameter: float = 0.0):
    """Analytic spherical-cap annulus area (validation helper)."""
    F = focal_length
    b1 = np.arcsin(0.5 * in_diameter / F)
    b2 = np.arcsin(0.5 * out_diameter / F)
    return 2 * np.pi * F * F * (np.cos(b1) - np.cos(b2))
