"""Step-2 acoustic simulation pipeline (headless).

Orchestrates the reference's 10-step sequence
(`TranscranialModeling/BabelIntegrationBASE.py:994-1033`, SURVEY.md
section 3.2) TPU-natively:

  S1  domain + materials           (pipeline.domain)
  S2  forward Rayleigh to the source plane          (ops.rayleigh)
  S3  CW source construction (amplitude/phase plane)
  S4  FDTD through skull           (ops.fdtd; carrier DFT in-kernel, which
      merges the reference's S5 phase-extraction FFT pass)
  S6  backward Rayleigh from the sensor plane -> conjugate element phases
  S7/8 refocused FDTD + extraction
  S10 result assembly with the reference's crops/flips and DataForSim keys

The water-only pass defaults to reusing the Rayleigh solution
(``use_rayleigh_for_water=True``) exactly like the reference's default
(`BabelBrain/BabelBrain.py:441`, justified by its 308-case study).

Counterpart of ``babelbrain_tpu/pipeline/acoustic.py``: the plane-source
path with optional refocusing (S4b-S8), multipoint steering
(``run_multipoint``) and dome transducers driven volumetrically
(``run_dome_sim``); Rayleigh and FDTD run in PyTorch on ``device``, the
FDTD decomposed over a ``mesh`` (``parallel.halo.make_mesh``) where one is
given.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.fdtd import FDTDGrid, make_case_mesh, run_fdtd, run_fdtd_batch
from ..ops.fdtd_sources import VolumeSource
from ..ops.rayleigh import (
    expand_element_weights,
    rayleigh_field,
    steering_phases,
)
from ..parallel.halo import mesh_devices
from ..utils.timing import stage_timer
from .domain import Domain


@dataclass
class AcousticResult:
    """Simulation outputs in the input-mask frame (reference orientation)."""

    p_amp: np.ndarray  # carrier amplitude, full mask grid (flipped back)
    p_phase: np.ndarray
    p_amp_refocus: np.ndarray | None
    rayleigh_field: np.ndarray  # complex, mask grid
    data_for_sim: dict  # DataForSim.h5 contract keys
    phased_array_programming: np.ndarray | None = None
    phased_array_refocus: np.ndarray | None = None
    meta: dict = field(default_factory=dict)
    extra_maps: dict = field(default_factory=dict)  # sel_maps / sensor series


def _volume_points(dom: Domain):
    xp, yp, zp = np.meshgrid(dom.x_vec, dom.y_vec, dom.z_vec, indexing="ij")
    return np.stack([xp.ravel(), yp.ravel(), zp.ravel()], 1).astype(np.float32)


def forward_rayleigh(dom: Domain, tx, u0, attenuated_water=0.0, *,
                     device="cuda"):
    """Rayleigh field over the whole domain grid (S2)."""
    k = (
        2 * np.pi * dom.frequency / dom.materials[0, 1]
        + 1j * attenuated_water
    )
    pts = _volume_points(dom)
    field_flat = rayleigh_field(k, tx.centers, tx.areas, u0, pts,
                                device=device)
    return np.asarray(field_flat).reshape(dom.material_map.shape)


def source_plane_from_field(dom: Domain, u2: np.ndarray):
    """Extract the CW source plane at z = source_z, zeroing the PML skirt
    (`BabelIntegrationSingle.py:300-304`)."""
    plane = u2[:, :, dom.source_z].copy()
    n = dom.npml
    plane[:n, :] = 0
    plane[-n:, :] = 0
    plane[:, :n] = 0
    plane[:, -n:] = 0
    return plane


def _make_grid(dom: Domain, source_type="velocity_plane", source_ijk=(0, 0, 0)):
    return FDTDGrid(
        shape=dom.material_map.shape,
        dx=dom.dx,
        dt=dom.dt,
        n_steps=dom.n_steps,
        frequency=dom.frequency,
        npml=dom.npml,
        sensor_start=dom.sensor_start,
        source_plane_z=dom.source_z,
        source_type=source_type,
        source_ijk=tuple(int(v) for v in source_ijk),
    )


def _source_for_steering(
    dom: Domain,
    tx,
    source_amp_pa: float,
    steering_target=None,
    element_weights=None,
    *,
    device="cuda",
):
    """Element programming + forward Rayleigh + source plane (S2/S3).

    Env hook ``BBT_AVOID_PHASE_PROGRAMMING=1`` disables element phase
    programming (all elements driven in phase) — the reference's
    ``BABEL_AVOID_PHASE_PROGRAMING`` test hook
    (`BabelIntegrationANNULAR_ARRAY.py:389`).
    """
    import os

    k_water = 2 * np.pi * dom.frequency / dom.materials[0, 1]
    programming = None
    if os.environ.get("BBT_AVOID_PHASE_PROGRAMMING") == "1":
        steering_target = None
    if steering_target is not None:
        programming = steering_phases(
            k_water, tx.elem_centers, steering_target, device=device
        )
        drive = programming
        if element_weights is not None:
            # calibrated weights apply ON TOP of the steering phases (the
            # reference multiplies the steered drive by the optimized
            # weights, `BabelIntegrationBASE.py:2224-2234,2302`)
            drive = programming * np.asarray(element_weights, np.complex64)
        u0 = expand_element_weights(tx, drive) * source_amp_pa
    elif element_weights is not None:
        u0 = expand_element_weights(tx, element_weights) * source_amp_pa
    else:
        u0 = np.full(tx.num_subelements, source_amp_pa, np.complex64)
    u2 = forward_rayleigh(dom, tx, u0, device=device)
    src = source_plane_from_field(dom, u2)
    return programming, u2, src


def run_acoustic_sim(
    dom: Domain,
    tx,
    source_amp_pa: float = 60e3,
    *,
    element_weights: np.ndarray | None = None,
    steering_target=None,
    do_refocus: bool = False,
    use_rayleigh_for_water: bool = True,
    mesh=None,
    input_source_plane: np.ndarray | None = None,
    sel_maps: tuple = (),
    monitor_ijk: np.ndarray | None = None,
    device="cuda",
) -> AcousticResult:
    """Full Step-2 run for one transducer position/steering.

    ``tx`` must already be positioned in domain coordinates (focus-centered
    axes, transducer below the source plane; see ``position_transducer``).

    ``input_source_plane``: externally supplied complex source plane
    (N1,N2) replacing the Rayleigh-derived one — the reference's
    ``InputFocusStart`` hook (`BabelIntegrationSingle.py:306-311`), used to
    drive the FDTD from a measured/precomputed focal plane. The Rayleigh
    field is still computed for the water-path shortcut and display.

    ``sel_maps``/``monitor_ijk`` pass through to ``run_fdtd`` (RMS/peak map
    selection and the pressure series at monitor voxels, sampled every
    step of the sensor window); the extra maps land in
    ``AcousticResult.extra_maps`` cropped to the mask frame.

    ``do_refocus``: backpropagate from a stress point at the target (S4b),
    conjugate the sensor-plane field at the elements through a backward
    Rayleigh (S6) and rerun the forward Rayleigh and the FDTD with those
    phases (S7/8); the result carries ``p_amp_refocus`` and
    ``phased_array_refocus``.
    """
    k_water = 2 * np.pi * dom.frequency / dom.materials[0, 1]

    # --- S2/S3: element programming + forward Rayleigh + source plane ---
    with stage_timer("Step2 forward Rayleigh", level=3, step=2):
        programming, u2, src = _source_for_steering(
            dom, tx, source_amp_pa, steering_target, element_weights,
            device=device,
        )
    if input_source_plane is not None:
        src = np.asarray(input_source_plane, np.complex64)
        if src.shape != dom.material_map.shape[:2]:
            raise ValueError(
                f"input_source_plane shape {src.shape} != domain plane "
                f"{dom.material_map.shape[:2]}"
            )

    # --- S4: FDTD through skull ---
    grid = _make_grid(dom)
    reflector = dom.meta.get("reflector_mask")
    with stage_timer("Step2 FDTD", level=3, step=2):
        out = run_fdtd(
            dom.material_map,
            dom.materials,
            grid,
            source_amp=np.abs(src),
            source_phase=np.angle(src),
            mesh=mesh,
            reflector_mask=reflector,
            sel_maps=sel_maps,
            monitor_ijk=monitor_ijk,
            device=device,
        )

    refocus_out = None
    refocus_programming = None
    if do_refocus:
        # --- S4b: backpropagate from a stress point at the target ---
        grid_b = _make_grid(dom, "stress_point", dom.focal_idx)
        with stage_timer("Step2 refocus backward FDTD", level=3, step=2):
            back = run_fdtd(
                dom.material_map,
                dom.materials,
                grid_b,
                point_amp=source_amp_pa,
                mesh=mesh,
                reflector_mask=reflector,
                device=device,
            )
        # --- S6: sensor-plane field -> element conjugate phases ---
        plane_amp = back["p_amp"][:, :, dom.npml]
        plane_ph = back["p_phase"][:, :, dom.npml]
        sel = np.abs(src) > 0
        xp, yp = np.meshgrid(dom.x_vec, dom.y_vec, indexing="ij")
        centers = np.stack(
            [xp[sel], yp[sel], np.full(sel.sum(), dom.z_vec[dom.npml])], 1
        ).astype(np.float32)
        u_plane = plane_amp[sel] * np.exp(1j * plane_ph[sel])
        with stage_timer("Step2 refocus Rayleigh", level=3, step=2):
            u_back = rayleigh_field(
                k_water,
                centers,
                np.full(sel.sum(), dom.dx**2, np.float32),
                u_plane.astype(np.complex64),
                tx.elem_centers,
                device=device,
            )
            refocus_programming = np.exp(
                1j * np.angle(np.conjugate(np.asarray(u_back)))
            ).astype(np.complex64)
            u0r = expand_element_weights(tx, refocus_programming) * source_amp_pa
            u2r = forward_rayleigh(dom, tx, u0r, device=device)
            srcr = source_plane_from_field(dom, u2r)
        with stage_timer("Step2 refocus FDTD", level=3, step=2):
            refocus_out = run_fdtd(
                dom.material_map,
                dom.materials,
                grid,
                source_amp=np.abs(srcr),
                source_phase=np.angle(srcr),
                mesh=mesh,
                reflector_mask=reflector,
                device=device,
            )

    # --- S10: assemble results in input orientation ---
    water_p_amp = None
    if not use_rayleigh_for_water:
        # full water-only FDTD pass (the reference's bUseRayleighForWater=False
        # branch, `CalculateFieldProcess.py:55-77`)
        water_out = run_fdtd(
            np.zeros_like(dom.material_map),
            dom.materials[:1],
            grid,
            source_amp=np.abs(src),
            source_phase=np.angle(src),
            mesh=mesh,
            device=device,
        )
        water_p_amp = water_out["p_amp"]
    return _assemble_result(
        dom, u2, src, out,
        refocus_out=refocus_out,
        programming=programming,
        refocus_programming=refocus_programming,
        water_p_amp=water_p_amp,
    )


def _assemble_result(
    dom: Domain,
    u2,
    src,
    out,
    *,
    refocus_out=None,
    programming=None,
    refocus_programming=None,
    water_p_amp=None,
    dome=False,
) -> AcousticResult:
    """S10: crop/unflip into the input-mask frame and build DataForSim keys.

    ``water_p_amp=None`` selects the Rayleigh-for-water shortcut (the
    reference default, `BabelBrain/BabelBrain.py:441`).

    ``dome``: the transducer occupies the domain volume, so there is no
    source plane to blank below (`BabelIntegrationDOME_PHASEDARRAY.py`
    keeps the full field).
    """

    def mask_frame(vol):
        return dom.crop_and_unflip(vol)

    zsrc_blank = 0 if dome else dom.source_z + 1
    u2_masked = u2.copy()
    u2_masked[:, :, :zsrc_blank] = 0
    p_amp_full = out["p_amp"].copy()
    p_amp_full[:, :, :zsrc_blank] = 0
    p_phase_full = out["p_phase"].copy()
    p_phase_full[:, :, :zsrc_blank] = 0

    data = {
        "p_amp": mask_frame(p_amp_full),
        "p_complex_re": mask_frame(p_amp_full * np.cos(p_phase_full)),
        "p_complex_im": mask_frame(p_amp_full * np.sin(p_phase_full)),
        "MaterialMap": mask_frame(dom.material_map).astype(np.uint32),
        "Material": dom.materials,
        "x_vec": dom.x_vec[dom.offsets[0] : -dom.offsets[1]],
        "y_vec": dom.y_vec[dom.offsets[2] : -dom.offsets[3]],
        "z_vec": dom.z_vec[dom.offsets[4] : -dom.offsets[5]],
        "SpatialStep": dom.dx,
        # cropped MASK-frame index (z un-flipped to match the exported
        # arrays, like the reference's FocalSpotLocationOrig in DataForSim)
        "TargetLocation": np.array([
            dom.focal_idx[0] - dom.offsets[0],
            dom.focal_idx[1] - dom.offsets[2],
            dom.mask_shape[2] - 1 - (dom.focal_idx[2] - dom.offsets[4]),
        ]),
        "SourcePlane_re": np.real(
            src[dom.npml : -dom.npml, dom.npml : -dom.npml]
        ),
        "SourcePlane_im": np.imag(
            src[dom.npml : -dom.npml, dom.npml : -dom.npml]
        ),
    }
    if water_p_amp is None:
        data["p_amp_water"] = np.abs(mask_frame(u2_masked))
    else:
        pw = water_p_amp.copy()
        pw[:, :, :zsrc_blank] = 0
        data["p_amp_water"] = mask_frame(pw)
    if refocus_out is not None:
        pr = refocus_out["p_amp"].copy()
        pr[:, :, :zsrc_blank] = 0
        data["p_amp_refocus"] = mask_frame(pr)

    extra = {}
    for k, v in out.items():
        if k in ("p_amp", "p_phase", "peak"):
            continue
        extra[k] = mask_frame(v) if np.ndim(v) == 3 else v

    return AcousticResult(
        p_amp=data["p_amp"],
        p_phase=mask_frame(p_phase_full),
        p_amp_refocus=data.get("p_amp_refocus"),
        rayleigh_field=mask_frame(np.abs(u2_masked))
        * np.exp(1j * mask_frame(np.angle(u2_masked))),
        data_for_sim=data,
        phased_array_programming=programming,
        phased_array_refocus=refocus_programming,
        meta={"peak": float(out["peak"].max())},
        extra_maps=extra,
    )


def position_transducer(tx, dom: Domain, focal_length: float, extra_z: float = 0.0,
                        return_adjustment: bool = False):
    """Place a transducer built with its focus at the origin so the bowl sits
    fully below the source plane, mirroring the reference's repositioning
    loop (`BabelIntegrationSingle.py:256-278`).

    The domain's z axis is zero at the focal spot; the source plane is at
    z_vec[source_z]. The transducer's natural position puts its focus at
    z=0 via a +focal_length shift from the apex frame; it is then pushed
    down until max(center_z) <= source-plane z.

    With ``return_adjustment`` the mechanical z correction applied beyond
    ``extra_z`` is also returned (meters, negative = pushed away from the
    head) — the reference reports this back to the user as
    ``AdjustmentInRAS`` (`_BabelBaseTx.py:407`, DataForSim key §3.2/S10)
    so the physical positioning can be corrected.
    """
    z_plane = dom.z_vec[dom.source_z]
    shifted = tx.translated([0.0, 0.0, extra_z])
    over = shifted.centers[:, 2].max() - z_plane
    adjustment = 0.0
    if over > 0:
        adjustment = -(over + 1e-6)
        shifted = shifted.translated([0.0, 0.0, adjustment])
    if return_adjustment:
        return shifted, adjustment
    return shifted


def fanout_mesh(fanout, mesh, do_refocus: bool, n_targets: int, device):
    """(fan out?, case mesh or None) of ``run_multipoint``: the JAX rule
    (`babelbrain_tpu/pipeline/acoustic.py:400-416`) over the CUDA cards;
    the case mesh spans ``min(n_targets, cards)`` of them when that is more
    than one."""
    cards = (torch.cuda.device_count()
             if torch.device(device).type == "cuda" else 0)
    use = fanout is True or (fanout == "auto" and mesh is None
                             and not do_refocus and n_targets > 1
                             and cards > 1)
    n = min(n_targets, cards)
    return use, (make_case_mesh(n) if use and n > 1 else None)


def run_multipoint(
    dom: Domain,
    tx,
    steering_targets,
    source_amp_pa: float = 60e3,
    *,
    mesh=None,
    do_refocus: bool = False,
    fanout: bool | str = "auto",
    device="cuda",
) -> tuple[list[AcousticResult], dict]:
    """Multipoint steering (`CalculateFieldProcess.py:78-111`).

    Runs one full acoustic case per steering target and combines the
    per-point fields by voxelwise maximum for display; per-point fields are
    kept for the time-multiplexed BHTE (`BHTEMultiplePressureFields`).

    With fan-out the per-point FDTDs run as one ``run_fdtd_batch`` (no
    refocusing, as in the JAX package) over a case mesh of
    ``min(len(targets), torch.cuda.device_count())`` cards (on ``device``
    alone when that is one), and each point's result is assembled;
    ``fanout='auto'`` fans out when several cards are available, no spatial
    ``mesh`` was given and no refocusing is asked for (``fanout_mesh``,
    JAX's rule); ``True`` / ``False`` force it. Without fan-out each point
    runs ``run_acoustic_sim``, its FDTD decomposed over ``mesh`` if given.
    """
    if mesh is not None:
        mesh_devices(mesh, "run_multipoint")  # refused before any Rayleigh
    targets = [np.asarray(t) for t in steering_targets]
    use_fanout, case_mesh = fanout_mesh(fanout, mesh, do_refocus,
                                        len(targets), device)
    if use_fanout:
        with stage_timer("Step2 forward Rayleigh", level=3, step=2):
            per_point = [
                _source_for_steering(dom, tx, source_amp_pa,
                                     steering_target=t, device=device)
                for t in targets
            ]
        srcs = np.stack([src for _, _, src in per_point])
        with stage_timer("Step2 FDTD", level=3, step=2):
            outs = run_fdtd_batch(
                dom.material_map,
                dom.materials,
                _make_grid(dom),
                source_amps=np.abs(srcs),
                source_phases=np.angle(srcs),
                mesh=case_mesh,
                reflector_mask=dom.meta.get("reflector_mask"),
                device=device,
            )
        results = [
            _assemble_result(
                dom,
                per_point[i][1],
                per_point[i][2],
                {k: outs[k][i] for k in outs},
                programming=per_point[i][0],
            )
            for i in range(len(targets))
        ]
    else:
        results = [
            run_acoustic_sim(dom, tx, source_amp_pa, steering_target=t,
                             do_refocus=do_refocus, mesh=mesh, device=device)
            for t in targets
        ]
    combined = {
        "p_amp_max": np.max([r.p_amp for r in results], axis=0),
        "p_amp_all": np.stack([r.p_amp for r in results]),
        "steering_targets": np.asarray(targets),
    }
    return results, combined


def make_volume_source(dom: Domain, tx, u0) -> dict:
    """Splat transducer sub-elements into a volumetric vector source.

    For dome transducers the whole array sits inside the simulation domain
    (`BabelIntegrationDOME_PHASEDARRAY.py` capability): each sub-element is
    deposited on its nearest voxel with its complex drive and unit normal;
    voxels receiving several sub-elements sum complex amplitudes and average
    normals.

    Returns the sparse form (``ops.fdtd_sources.VolumeSource.from_sparse``
    takes it): ``index``, the C-order linear indices of the voxels whose
    float32 amplitude is > 0, and per voxel the float32 ``amp``, ``phase``,
    ``ox``, ``oy``, ``oz``. These are the nonzero voxels of the JAX
    package's dense dict and its values there, bit for bit: the sums run
    over the deposited sub-elements in the same order and precision
    (complex128 / float64), without a grid-sized accumulator.
    """
    shape = dom.material_map.shape
    centers = np.asarray(tx.centers, np.float64)
    ijk = np.stack(
        [
            np.round((centers[:, 0] - dom.x_vec[0]) / dom.dx),
            np.round((centers[:, 1] - dom.y_vec[0]) / dom.dx),
            np.round((centers[:, 2] - dom.z_vec[0]) / dom.dx),
        ],
        axis=1,
    ).astype(int)
    ok = np.all((ijk >= 0) & (ijk < np.array(shape)), axis=1)
    ijk = ijk[ok]
    u = np.asarray(u0, np.complex128).ravel()[ok]
    nrm = np.asarray(tx.normals, np.float64)[ok]

    ds = np.asarray(tx.areas, np.float64)[ok]
    lin = np.ravel_multi_index((ijk[:, 0], ijk[:, 1], ijk[:, 2]), shape)
    # conserve volume-velocity: deposit u*ds and renormalize by the voxel
    # face area, so a sparse voxel shell radiates like the continuous surface
    vox, slot = np.unique(lin, return_inverse=True)
    acc = np.zeros(len(vox), np.complex128)
    np.add.at(acc, slot, u * ds)
    nacc = np.zeros((len(vox), 3))
    np.add.at(nacc, slot, nrm * ds[:, None])
    acc /= dom.dx**2
    ln = np.linalg.norm(nacc, axis=1)
    nacc[ln > 0] /= ln[ln > 0, None]
    amp = np.abs(acc).astype(np.float32)
    on = amp > 0
    return {
        "index": vox[on],
        "amp": amp[on],
        "phase": np.angle(acc[on]).astype(np.float32),
        "ox": nacc[on, 0].astype(np.float32),
        "oy": nacc[on, 1].astype(np.float32),
        "oz": nacc[on, 2].astype(np.float32),
    }


def run_dome_sim(
    dom: Domain,
    tx,
    source_amp_pa: float = 60e3,
    *,
    steering_target=None,
    element_weights: np.ndarray | None = None,
    mesh=None,
    use_rayleigh_for_water: bool = False,
    assemble: bool = True,
    device="cuda",
):
    """Acoustic run for a dome transducer fully inside the domain.

    The dome is the reference's ``RUN_SIM`` subclass with overridden
    sensor/phase/run steps (`BabelIntegrationDOME_PHASEDARRAY.py:344-407`):
    the whole 1024-element array drives particle velocity volumetrically
    instead of through a source plane. With ``assemble`` (the runner path)
    the outputs are packed into a full ``AcousticResult`` with the
    DataForSim contract keys; ``assemble=False`` returns the raw field dict.

    The water reference field defaults to a second volumetric FDTD pass on
    a water-only medium: the dome thermal losses are a PEAK ratio at the
    target (`CalculateTemperatureEffects.py:199-201`), so the water field
    must share the volumetric-source amplitude convention — the
    Rayleigh-for-water shortcut (``use_rayleigh_for_water=True``) uses the
    surface-integral drive instead and systematically overestimates the
    losses ratio for dome sources.
    """
    k_water = 2 * np.pi * dom.frequency / dom.materials[0, 1]
    programming = None
    if steering_target is not None:
        programming = steering_phases(k_water, tx.elem_centers,
                                      steering_target, device=device)
        u0 = expand_element_weights(tx, programming) * source_amp_pa
    elif element_weights is not None:
        u0 = expand_element_weights(tx, element_weights) * source_amp_pa
    else:
        u0 = np.full(tx.num_subelements, source_amp_pa, np.complex64)
    grid = _make_grid(dom, "velocity_volume")
    with stage_timer("Step2 volume source", level=3, step=2):
        # one device copy of the source voxels for both FDTD passes
        vsrc = VolumeSource.from_sparse(make_volume_source(dom, tx, u0),
                                        grid.shape, device)
    with stage_timer("Step2 FDTD", level=3, step=2):
        out = run_fdtd(
            dom.material_map, dom.materials, grid, volume_source=vsrc,
            mesh=mesh, reflector_mask=dom.meta.get("reflector_mask"),
            device=device,
        )
    out["programming"] = programming
    if not assemble:
        return out

    with stage_timer("Step2 forward Rayleigh", level=3, step=2):
        u2 = forward_rayleigh(dom, tx, u0, device=device)
    water_p_amp = None
    if not use_rayleigh_for_water:
        with stage_timer("Step2 water FDTD", level=3, step=2):
            water_out = run_fdtd(
                np.zeros_like(dom.material_map), dom.materials[:1], grid,
                volume_source=vsrc, mesh=mesh, device=device,
            )
        water_p_amp = water_out["p_amp"]
    src = np.zeros(dom.material_map.shape[:2], np.complex64)
    res = _assemble_result(
        dom, u2, src, out,
        programming=programming,
        water_p_amp=water_p_amp,
        dome=True,
    )
    res.meta["tx_is_dome"] = True
    return res
