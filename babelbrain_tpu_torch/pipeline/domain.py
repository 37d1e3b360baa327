"""Simulation-domain arithmetic: grid spacing, time stepping, material maps.

Re-implements the numerics of the reference's ``UpdateConditions``
(`TranscranialModeling/BabelIntegrationBASE.py:1753-2221`):

* dx = c_min / (f * PPW), with c_min over the material table (long+shear)
  bounded by the global tissue minimum.
* "ideal" dt from the CFL bound, then snapped so the period is an integer
  number of steps (PPP), with the same awkward-prime fixups and
  round-up-to-multiple-of-5 rule (`:1808-1827`) so sensor windows divide
  evenly.
* domain = input mask + PML offsets (+ cone-fitting growth); z-flip of the
  input mask (the reference simulates with z reversed, `:1844`).
* material-ID remapping for label mode and CT mode, including the
  tissue-layer removal below the source plane (`:2160-2201`).

Numpy copy of ``babelbrain_tpu/pipeline/domain.py`` using the port's
``ops.fdtd.stable_dt``.

Mask label convention (Step 1 contract, `BabelDatasetPreps.py:771-772`):
0 water, 1 skin, 2 cortical, 3 trabecular, 4 brain, 5 target (brain voxel),
6 white matter, 7 gray matter, 8 CSF.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..materials import material_array, smallest_sos
from ..ops.fdtd import stable_dt


def snap_ppp(ppp: float) -> int:
    """Round points-per-period up, avoiding awkward prime factors
    (`BabelIntegrationBASE.py:1809-1827`)."""
    ppp = int(np.ceil(ppp))
    fixups = {31: 32, 34: 35, 23: 24, 71: 72, 74: 75, 79: 80, 47: 48}
    if ppp in fixups:
        return fixups[ppp]
    if ppp % 5 != 0:
        ppp = (ppp // 5 + 1) * 5
    return ppp


def compute_time_stepping(
    materials: np.ndarray,
    frequency: float,
    ppw: float,
    alpha_cfl: float = 0.5,
    bound_by_tissue_minimum: bool = True,
):
    """Return (dx, dt, ppp, adjusted_cfl).

    dx from the smallest propagating speed; dt from the 4th-order CFL bound
    at the largest speed, snapped to an integer divisor of the period.
    """
    mats = np.asarray(materials, np.float64)
    speeds = mats[:, 1:3].ravel()
    # speeds below 500 m/s belong to sub-resolution reflector materials
    # (air cavities); they set an impedance contrast, not a resolved
    # wavelength, so they must not shrink the grid
    resolved = speeds[speeds >= 500.0]
    cmin = resolved.min()
    if bound_by_tissue_minimum:
        cmin = min(cmin, smallest_sos(frequency, include_shear=True))
    cmax = speeds.max()
    dx = cmin / frequency / ppw
    dt_ideal = stable_dt(dx, cmax, cfl=alpha_cfl)
    ppp = snap_ppp(1.0 / frequency / dt_ideal)
    dt = 1.0 / frequency / ppp
    return dx, dt, ppp, dt / dt_ideal * alpha_cfl


def sensor_window(
    n_steps: int, ppp: int, cycles_to_track: int = 2
) -> int:
    """First step of the carrier-DFT window (last N cycles)."""
    return max(0, n_steps - cycles_to_track * ppp)


def simulation_steps(domain_extent_m, water_sos: float, dt: float, ppp: int) -> int:
    """Total steps = time for a wavefront to cross the domain diagonal
    (excluding PML), rounded up to whole periods (`:2082-2089`)."""
    t_cross = float(np.linalg.norm(domain_extent_m)) / water_sos
    n = int(np.floor(t_cross / dt))
    return (n // ppp + 1) * ppp


@dataclass
class Domain:
    """Assembled simulation domain (all arrays in sim orientation: z flipped
    vs the input NIfTI, increasing z = away from transducer)."""

    material_map: np.ndarray  # (N1,N2,N3) uint32 material indices
    materials: np.ndarray  # (M,5)
    dx: float
    dt: float
    ppp: int
    n_steps: int
    sensor_start: int
    source_z: int
    npml: int
    offsets: tuple  # (xl, xr, yl, yr, zl, zr)
    focal_idx: np.ndarray  # (3,) voxel index of the target in sim grid
    x_vec: np.ndarray
    y_vec: np.ndarray
    z_vec: np.ndarray
    frequency: float
    mask_shape: tuple = ()
    meta: dict = field(default_factory=dict)

    def crop(self, volume):
        """Remove PML/padding -> input-mask-shaped volume (sim orientation)."""
        xl, xr, yl, yr, zl, zr = self.offsets
        return volume[xl:-xr, yl:-yr, zl:-zr]

    def crop_and_unflip(self, volume):
        """Back to the input NIfTI orientation (`ReturnResults` contract)."""
        return np.flip(self.crop(volume), axis=2)


LABEL_WATER, LABEL_SKIN, LABEL_CORTICAL, LABEL_TRABECULAR = 0, 1, 2, 3
LABEL_BRAIN, LABEL_TARGET, LABEL_WM, LABEL_GM, LABEL_CSF = 4, 5, 6, 7, 8


def _q_correction(mats: np.ndarray) -> np.ndarray:
    """Env hook ``BBT_QCORRECTION=<float>``: scale the attenuation columns.

    Counterpart of the reference's ``BABEL_PYTEST_QFACTOR`` override
    (`BabelIntegrationBASE.py:1109-1111`), which rescales the Q-factor
    correction applied to its relaxation model. Our SLS is tuned exactly at
    the carrier so the correction is identically 1 by design; the hook lets
    attenuation-sensitivity tests scale it without editing material tables.
    """
    import os

    q = os.environ.get("BBT_QCORRECTION")
    if q:
        mats = mats.copy()
        mats[:, 3] *= float(q)
        mats[:, 4] *= float(q)
    return mats


def build_label_materials(frequency: float, segmented: bool, no_shear=False):
    """Label-mode material table: water, skin, cortical, trabecular, brain
    (+WM, GM, CSF) — `BabelIntegrationBASE.py:1357-1377`.

    Env hook: ``BBT_PAPER_CONDITIONS=1`` models all soft tissues as water
    (the reference's ``BABEL_PYTEST_PAPER`` hook,
    `BabelIntegrationBASE.py:1323-1335`), reproducing its paper conditions.
    """
    import os

    paper = os.environ.get("BBT_PAPER_CONDITIONS") == "1"
    tissues = ["Water", "Skin", "Cortical", "Trabecular", "Brain"]
    if segmented:
        tissues += ["WhiteMatter", "GrayMatter", "CSF"]
    if paper:
        tissues = [
            "Water" if t not in ("Cortical", "Trabecular") else t
            for t in tissues
        ]
    mats = material_array(frequency, tissues)
    if no_shear:
        mats[:, 2] = 0.0
        mats[:, 4] = 0.0
    return _q_correction(mats)


AIR_MATERIAL = np.array([1.2, 343.0, 0.0, 30.0, 0.0])


def build_ct_materials(
    frequency: float, segmented: bool, hu_density, hu_sos, hu_att,
    with_air: bool = False,
):
    """CT-mode material table: water + soft tissues + one material per
    quantized HU (`BabelIntegrationBASE.py:1322-1354`); shear disabled.

    ``with_air`` appends a low-impedance air material as the LAST index;
    intracranial air cavities mapped to it reflect nearly all energy — the
    physically-grounded equivalent of the reference's ``ReflectorMask``
    (`BabelIntegrationBASE.py:2365` ReflectorMask argument).
    """
    tissues = ["Water", "Skin", "Brain"]
    if segmented:
        tissues += ["WhiteMatter", "GrayMatter", "CSF"]
    soft = material_array(frequency, tissues)
    soft[:, 2] = 0.0
    soft[:, 4] = 0.0
    n_hu = len(hu_density)
    skull = np.zeros((n_hu, 5))
    skull[:, 0] = hu_density
    skull[:, 1] = hu_sos
    skull[:, 3] = hu_att
    if with_air:
        raise NotImplementedError(
            "air is handled as a pressure-release reflector mask, not a "
            "material (extreme impedance contrast is unstable on the grid); "
            "pass reflector_mask to run_fdtd / air_mask to build_domain"
        )
    return _q_correction(np.concatenate([soft, skull]))


def remap_labels(
    mask_ids: np.ndarray,
    ct_index_map: np.ndarray | None = None,
    segmented: bool | None = None,
) -> np.ndarray:
    """Map Step-1 label IDs to material-table indices.

    Label mode (`:2194-2198`): target(5) -> brain index; with segmentation the
    IDs 6..8 shift down by 1 (indices 5..7).
    CT mode (`:2163-2192`): bone labels (2,3) take their CT material index
    (already offset by the soft-tissue count); other tissues map onto
    [water, skin, brain, (WM, GM, CSF)].
    """
    ids = np.asarray(mask_ids).astype(np.int64)
    if segmented is None:
        segmented = bool((ids > 5).any())
    out = ids.copy()
    if ct_index_map is None:
        if segmented:
            out[ids == 5] = 4
            out[ids >= 6] -= 1
        else:
            out[ids == 5] = 4
        return out.astype(np.uint32)

    ct = np.asarray(ct_index_map).astype(np.int64)
    n_soft = 6 if segmented else 3
    bone = (ids == LABEL_CORTICAL) | (ids == LABEL_TRABECULAR)
    if segmented:
        # water0, skin1, brain2, WM3, GM4, CSF5
        remap = {0: 0, 1: 1, 4: 2, 5: 2, 6: 3, 7: 4, 8: 5}
    else:
        remap = {0: 0, 1: 1, 4: 2, 5: 2}
    for src, dst in remap.items():
        out[ids == src] = dst
    out[bone] = ct[bone] + n_soft
    return out.astype(np.uint32)


def build_domain(
    mask_nifti_data: np.ndarray,
    frequency: float,
    ppw: float,
    *,
    materials: np.ndarray | None = None,
    ct_index_map: np.ndarray | None = None,
    air_mask: np.ndarray | None = None,
    npml: int = 12,
    alpha_cfl: float = 0.5,
    cycles_to_track: int = 2,
    z_into_skin_m: float = 0.0,
    pad_cone_cells: tuple = (0, 0),
    water_only: bool = False,
    extra_steps_cycles: float = 0.0,
    offsets: tuple | None = None,
    shrink_cells: tuple | None = None,
    shape_bucket: int = 0,
) -> Domain:
    """Assemble the simulation domain from a Step-1 mask volume.

    ``mask_nifti_data`` is in NIfTI orientation (z increasing toward the
    transducer as produced by Step 1); it is z-flipped into sim orientation
    here, exactly as the reference does (`:1844`).

    ``pad_cone_cells`` = extra (x,y) halo so a wide Rayleigh incident cone
    fits inside the non-PML region. ``offsets``/``shrink_cells`` (each
    per-side 6-tuples, sim orientation) override it with the output of
    ``fit_domain_offsets`` — the reference's grow/tight-beam-shrink loop
    (`BabelIntegrationBASE.py:1874-2068`): the mask is cropped by the
    shrinks before padding, so narrow beams get matching (smaller) grids.

    ``shape_bucket`` > 0 rounds every grid dimension UP to a multiple of
    the bucket (extra water padding on the hi side, stripped again by
    ``Domain.crop``) and the step count up to a whole multiple of 4
    cycles, so near-equal cases of a targets x frequencies x PPW matrix
    share one canonical grid signature (one compiled executable in the
    JAX package; ``run_cases`` counts the distinct signatures of a
    sweep). The extra cells are water behind the PML-side padding: fields
    there are physically inert, and the extra settle cycles only deepen
    steady state.
    """
    mask = np.flip(np.asarray(mask_nifti_data), axis=2).astype(np.uint32)
    shrinks = tuple(int(v) for v in (shrink_cells or (0,) * 6))

    def _crop_shrink(vol):
        xs_l, xs_r, ys_l, ys_r, zs_l, zs_r = shrinks
        sl = tuple(
            slice(lo, vol.shape[d] - hi if hi else None)
            for d, (lo, hi) in enumerate(
                ((xs_l, xs_r), (ys_l, ys_r), (zs_l, zs_r))
            )
        )
        return vol[sl]

    if any(shrinks):
        mask = _crop_shrink(mask)
    segmented = bool((mask > 5).any())
    if materials is None:
        materials = build_label_materials(frequency, segmented)
    dx, dt, ppp, adj_cfl = compute_time_stepping(
        materials, frequency, ppw, alpha_cfl
    )

    if offsets is not None:
        xl, xr, yl, yr, zl, zr = (int(v) for v in offsets)
    else:
        px, py = pad_cone_cells
        xl = xr = npml + int(px)
        yl = yr = npml + int(py)
        zl = npml
        zr = npml
    z_into_pix = int(np.round(z_into_skin_m / dx))
    src_z = npml + z_into_pix + 1

    if shape_bucket:
        b = int(shape_bucket)
        dims = (
            mask.shape[0] + xl + xr,
            mask.shape[1] + yl + yr,
            mask.shape[2] + zl + zr,
        )
        pads = [(-d) % b for d in dims]
        xr += pads[0]
        yr += pads[1]
        zr += pads[2]

    shape = (
        mask.shape[0] + xl + xr,
        mask.shape[1] + yl + yr,
        mask.shape[2] + zl + zr,
    )
    mat_map = np.zeros(shape, np.uint32)
    if not water_only:
        ids = mask
        ct = None
        if ct_index_map is not None:
            ct = np.flip(np.asarray(ct_index_map), axis=2).astype(np.uint32)
            if any(shrinks):
                ct = _crop_shrink(ct)
        remapped = remap_labels(ids, ct, segmented)
        mat_map[xl:-xr, yl:-yr, zl:-zr] = remapped
        # remove tissue layers at/below the source plane (water instead)
        mat_map[:, :, : src_z + 1] = 0

    reflector = None
    if air_mask is not None:
        am = np.flip(np.asarray(air_mask).astype(bool), axis=2)
        if any(shrinks):
            am = _crop_shrink(am)
        reflector = np.zeros(shape, bool)
        reflector[xl:-xr, yl:-yr, zl:-zr] = am
        reflector[:, :, : src_z + 1] = False

    focal = np.argwhere(mask == LABEL_TARGET)
    if len(focal) == 0:
        focal_idx = np.array(shape) // 2
    else:
        focal_idx = focal[0] + np.array([xl, yl, zl])

    x_vec = (np.arange(shape[0]) - focal_idx[0]) * dx
    y_vec = (np.arange(shape[1]) - focal_idx[1]) * dx
    z_vec = (np.arange(shape[2]) - focal_idx[2]) * dx

    extent = (np.array(shape) - 2 * npml) * dx
    n_steps = simulation_steps(extent, materials[0, 1], dt, ppp)
    n_steps += int(np.round(extra_steps_cycles * ppp))
    if shape_bucket:
        # canonical step count: round up to whole 4-cycle multiples so
        # bucketed cases share the scan length too (extra settle cycles
        # only deepen steady state before the 2-cycle sensor window)
        q = 4 * ppp
        n_steps = int(-(-n_steps // q) * q)

    # env hook ``BBT_SEL_MASK=<path>``: dump the assembled simulation-region
    # debug volume (the reference's ``BABELBRAIN_SEL_MASK``,
    # `BabelIntegrationBASE.py:2127-2151`)
    import os

    sel_path = os.environ.get("BBT_SEL_MASK")
    if sel_path:
        np.savez_compressed(
            sel_path if sel_path.endswith(".npz") else sel_path + ".npz",
            material_map=mat_map,
            focal_idx=np.asarray(focal_idx),
            offsets=np.array((xl, xr, yl, yr, zl, zr)),
            source_z=src_z,
            dx=dx,
        )
    return Domain(
        material_map=mat_map,
        materials=np.asarray(materials, np.float64),
        dx=dx,
        dt=dt,
        ppp=ppp,
        n_steps=n_steps,
        sensor_start=sensor_window(n_steps, ppp, cycles_to_track),
        source_z=src_z,
        npml=npml,
        offsets=(xl, xr, yl, yr, zl, zr),
        focal_idx=np.asarray(focal_idx),
        x_vec=x_vec,
        y_vec=y_vec,
        z_vec=z_vec,
        frequency=frequency,
        mask_shape=tuple(mask.shape),
        meta={
            "adjusted_cfl": adj_cfl,
            "segmented": segmented,
            "reflector_mask": reflector,
            "shrinks": shrinks,
        },
    )


def fit_domain_offsets(
    mask: np.ndarray,
    dx: float,
    aperture: float,
    focal_length: float,
    *,
    npml: int = 12,
    tx_mech_adjust: tuple = (0.0, 0.0, 0.0),
    extra_depth: float = 0.0,
    extra_adjust_xy: tuple = (),
    tight_narrow_beam: bool = False,
    z_beyond_focal_m: float = 0.0225,
    dome: bool = False,
):
    """Reference grow/tight-beam-shrink domain fit
    (`BabelIntegrationBASE.py:1874-2068`).

    Grows the per-side offsets until the incident-beam cylinder (radius
    ``RadiusFace`` around the steered/mechanical axis) clears the PML, and —
    with ``tight_narrow_beam`` — shrinks x/y to the beam's support and
    truncates z to ``z_beyond_focal_m`` past the focus (the reference's
    ``zLengthBeyonFocalPointWhenNarrow``). The update arithmetic mirrors the
    reference's integer cell math so grid dimensions are comparable.

    ``dome`` selects the reference's ``DomeType=True`` region: the whole
    transducer sits inside the domain, so the fit region is the hemisphere
    of radius ``aperture/2 * 1.02`` below the target plane instead of the
    incident cone, and the z axis is not shifted by the focal length
    (`BabelIntegrationBASE.py:1929-1932,1953-1954,1999-2016`); in tight
    mode the dome's z shrink ACCUMULATES (`:2060-2062`).

    ``mask`` is the Step-1 volume in SIM orientation (z already flipped).
    Returns ``(offsets, shrinks)`` with offsets = (xl, xr, yl, yr, zl, zr)
    and shrinks = (xs_l, xs_r, ys_l, ys_r, zs_l, zs_r).
    """
    mask = np.asarray(mask)
    mech_x, mech_y, mech_z = tx_mech_adjust
    XL = XR = YL = YR = ZL = ZR = npml
    XsL = XsR = YsL = YsR = ZsL = ZsR = 0
    focal = np.argwhere(mask == LABEL_TARGET)
    focal0 = (focal[0] if len(focal) else np.array(mask.shape) // 2)
    tissue_z = np.nonzero(mask.any(axis=(0, 1)))[0]
    first_tissue_mask_z = int(tissue_z.min()) if len(tissue_z) else 0

    done_for_shrinking = False
    for _ in range(8):  # the reference converges in one grow pass + recompute
        N1 = mask.shape[0] + XL + XR - XsL - XsR
        N2 = mask.shape[1] + YL + YR - YsL - YsR
        N3 = mask.shape[2] + ZL + ZR - ZsL - ZsR
        fx = focal0[0] + XL - XsL
        fy = focal0[1] + YL - YsL
        fz = focal0[2] + ZL - ZsL
        xfield = (np.arange(N1) - fx) * dx
        yfield = (np.arange(N2) - fy) * dx
        zfield = (np.arange(N3) - fz) * dx + (0.0 if dome else focal_length)
        top_z = zfield[npml]
        first_tz = max(first_tissue_mask_z - ZsL, 0) + ZL

        if dome:
            # hemisphere of the dome aperture below the target plane
            # (`BabelIntegrationBASE.py:1953-1954,2001-2016`)
            radius = aperture / 2 * 1.02
            z_rezero = 0.0
            z_cone_limit = 1.0  # unused on the dome branch
        elif focal_length != 0:
            alpha = np.arcsin(
                min(aperture / 2 / (focal_length + extra_depth), 1.0)
            )
            dist_to_focus = focal_length - top_z + mech_z + extra_depth
            radius = dist_to_focus * np.tan(alpha)
            radius = min(radius, aperture / 2) * 1.1
            z_rezero = -focal_length - mech_z - extra_depth
            z_cone_limit = -dist_to_focus
        else:
            radius = aperture / 2 * 1.1
            z_rezero = 0.0
            z_cone_limit = top_z - mech_z

        xf2 = (xfield - mech_x) / radius
        yf2 = (yfield - mech_y) / radius
        if dome:
            zf2 = (zfield - mech_z) / radius
        else:
            zf2 = (zfield + z_rezero) / z_cone_limit
        offs = [(0.0, 0.0)] + [tuple(e) for e in extra_adjust_xy]
        x_abs = np.min(
            [np.abs(xf2 - ex / radius) for ex, _ in offs], axis=0
        )
        y_abs = np.min(
            [np.abs(yf2 - ey / radius) for _, ey in offs], axis=0
        )
        if dome:
            # axis projections of the solid hemisphere x^2+y^2+z^2 <= 1,
            # z <= 0 are exactly |x| <= 1, |y| <= 1, -1 <= z <= 0
            x_in = x_abs <= 1.0
            y_in = y_abs <= 1.0
            z_in = (zf2 >= -1.0) & (zf2 <= 0.0)
        else:
            # the incident region is a product set: |x|,|y| within the face
            # radius, z between the transducer plane and the first tissue
            # plane
            x_in = x_abs <= 1.0
            y_in = y_abs <= 1.0
            z_in = (zf2 >= 0.0) & (zf2 <= 1.0) & (zf2 <= zf2[first_tz])
        if done_for_shrinking:
            break
        changed = False
        ind_x = np.nonzero(x_in)[0]
        ind_y = np.nonzero(y_in)[0]
        ind_z = np.nonzero(z_in)[0]
        if not (len(ind_x) and len(ind_y) and len(ind_z)):
            break
        step_x = abs(float(np.mean(np.diff(xf2))))
        step_y = abs(float(np.mean(np.diff(yf2))))
        step_z = abs(float(np.mean(np.diff(zf2))))

        def fit_axis(ind, edge, lo, hi, s_lo, s_hi, step, n, grow_hi=True):
            nonlocal changed
            if ind.min() < npml:
                lo += int(np.ceil((1.0 - edge[npml]) / step))
                changed = True
            elif tight_narrow_beam and lo == npml:
                d = ind.min() - lo
                if d > 0:
                    s_lo += d
                    changed = True
            if np.any(ind >= n - npml) and grow_hi:
                hi += int(np.ceil((1.0 - edge[-npml]) / step))
                changed = True
            elif tight_narrow_beam and grow_hi and hi == npml:
                d = n - hi - ind.max() - 1
                if d > 0:
                    s_hi += d
                    changed = True
            return lo, hi, s_lo, s_hi

        XL, XR, XsL, XsR = fit_axis(ind_x, x_abs, XL, XR, XsL, XsR,
                                    step_x, N1)
        YL, YR, YsL, YsR = fit_axis(ind_y, y_abs, YL, YR, YsL, YsR,
                                    step_y, N2)
        # z: the high side grows only when not in tight mode
        # (`fgen` condition: "Z" skips the upper grow when tight)
        ZL, ZR, ZsL, _ = fit_axis(
            ind_z, np.abs(zf2), ZL, ZR, ZsL, 0, step_z, N3,
            grow_hi=not tight_narrow_beam,
        )
        if tight_narrow_beam:
            n_beyond = int(z_beyond_focal_m / dx)
            red = N3 - (fz + n_beyond) - ZR
            # dome z-shrink accumulates; cone mode overwrites (`:2060-2062`)
            new_zsr = max(0, ZsR + red) if dome else max(0, red)
            if new_zsr != ZsR:
                ZsR = new_zsr
                changed = True
        done_for_shrinking = True
        if not changed:
            break
    return (XL, XR, YL, YR, ZL, ZR), (XsL, XsR, YsL, YsR, ZsL, ZsR)


def cone_padding_cells(
    aperture: float,
    focal_length: float,
    dx: float,
    mask_shape_xy: tuple,
    npml: int = 12,
    margin: float = 1.1,
) -> tuple:
    """Extra (x, y) cells so the transducer cone cross-section fits inside
    the non-PML region (simplified form of the grow loop `:2029-2055`)."""
    radius_cells = margin * (aperture / 2.0) / dx
    need = []
    for n in mask_shape_xy:
        half = n / 2.0
        need.append(int(max(0, np.ceil(radius_cells - half))))
    return tuple(need)
