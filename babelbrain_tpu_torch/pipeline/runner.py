"""Headless end-to-end runner (the RunCases-equivalent primary API).

The reference drives everything from three worker functions + file contracts
(SURVEY.md section 3.5 marks the batch path as the primary API). This module
is the library-first equivalent: one call runs Step 1 -> Step 2 -> Step 3 on
a case, with skip-if-output-exists caching like the reference
(`BabelIntegrationBASE.py:962-966`) and ``CTS:``-style stage timing.

Counterpart of ``babelbrain_tpu/pipeline/runner.py``: ``run_case`` in CT
mode (``ct_data`` given: fluid FDTD; a CT, a ZTE or PETRA MRI turned into a
pseudo-CT, or a density map, ``CaseConfig.ct_type``) and label mode (no CT:
tissue-label materials, viscoelastic FDTD with shear in the skull), with
plane-source transducers (optionally refocused, ``CaseConfig.do_refocus``)
or dome transducers driven volumetrically, and one thermal profile entry or
a list of them; ``run_cases`` sweeps targets x frequencies x PPW. A ZTE or
PETRA MRI with a T1 and ``CaseConfig.coregister`` is first rigidly
registered to the T1 (``coregister_to_t1``), and ``CaseConfig.export_meshes``
writes Step 1's surface STLs. Every device stage runs on
``CaseConfig.device``; ``run_case(mesh=)`` decomposes the FDTD over a
``parallel.halo`` device mesh.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

from ..materials.ct_mapping import map_hu_to_properties
from ..materials import pseudo_ct
from ..materials.pseudo_ct import compute_sdr
from ..ops import imaging as im
from ..utils.timing import stage_timer
from . import io as pio
from .acoustic import (
    _make_grid,
    position_transducer,
    run_acoustic_sim,
    run_dome_sim,
)
from .domain import (
    build_ct_materials,
    build_domain,
    build_label_materials,
    fit_domain_offsets,
)
from .profiles import (
    TRANSDUCER_REGISTRY,
    build_transducer,
    cone_to_focus_adjust,
    tpo_to_z_steering,
    validate_steering,
)
from .step1 import Step1Result, generate_mask
from .thermal import SonicationParams, run_all_combinations, run_sonication


def case_hash(**kwargs) -> str:
    """blake2s content hash for cache keys (the FileManager idea,
    `BabelBrain/FileManager.py:163-293`)."""
    h = hashlib.blake2s(digest_size=8)
    for k in sorted(kwargs):
        v = kwargs[k]
        h.update(str(k).encode())
        if isinstance(v, np.ndarray):
            h.update(v.tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def verify_precursor(nifti_path: str, expected_hash: str) -> bool:
    """Check a written NIfTI's embedded precursor hash.

    The reference chains blake2s precursor hashes through the NIfTI
    ``descrip`` header and skips recomputation only when the stored chain
    matches (`FileManager.py:163-293`); a user-replaced or corrupted
    intermediate file therefore invalidates everything downstream.
    """
    if not os.path.isfile(nifti_path):
        return False
    try:
        descrip = pio.load_nifti(nifti_path).descrip
    except Exception:
        return False
    return descrip == f"hash:{expected_hash}".encode()


def _advanced_params_snapshot(cfg: "CaseConfig") -> dict:
    """Physics-relevant advanced parameters, the reference's per-dataset
    ``-AdvancedParams.yaml`` contract (`BabelBrain.py:1547-1583`): a diff
    against the stored file forces full recalculation."""
    return {
        "MappingMethod": cfg.mapping_method,
        "CTType": cfg.ct_type,
        "ZTERange": list(cfg.zte_range),
        "HUThreshold": float(cfg.hu_threshold),
        "DensityThreshold": float(cfg.density_threshold),
        "TightNarrowBeamDomain": bool(cfg.tight_narrow_beam),
        "zLengthBeyonFocalPointWhenNarrow": float(cfg.z_beyond_focal_m),
        "SegmentBrain": bool(cfg.segment_brain),
        "BoneRimCorrection": bool(cfg.bone_rim_correction),
        "DistanceConeToFocus": cfg.distance_cone_to_focus,
        "TPODistance": cfg.tpo_distance,
    }


def check_advanced_params(out_base: str, cfg: "CaseConfig") -> bool:
    """True when the stored AdvancedParams file differs from the current
    config (-> force full recalculation, `BabelBrain.py:1547-1583`);
    writes/refreshes the file either way."""
    import yaml

    path = out_base + "-AdvancedParams.yaml"
    cur = _advanced_params_snapshot(cfg)
    force = False
    if os.path.isfile(path):
        try:
            with open(path) as f:
                force = yaml.safe_load(f) != cur
        except Exception:
            force = True
    with open(path, "w") as f:
        yaml.safe_dump(cur, f)
    return force


def load_optimized_weights(
    weights_file: str,
    spec,
    *,
    search_dir: str = ".",
    z_steering: float = 0.0,
    n_elements: int | None = None,
) -> np.ndarray:
    """Load per-element calibrated complex weights for a case.

    Mirrors the reference's ``OptimizedWeightsFile`` selection + validation
    (`BabelIntegrationBASE.py:2224-2234`): the h5 carries Amplitudes/Phases
    per physical element; the element count must match the transducer.
    ``weights_file='auto'`` picks the ``RingAmplPhase_<loc>.h5`` in
    ``search_dir`` whose calibration location is nearest to the programmed
    TPO distance (``z_steering`` + the device's natural out-plane) — the
    per-TPO-location files are what ``pipeline.calibration.run_calibration``
    writes.
    """
    import glob

    from . import io as pio

    if weights_file == "auto":
        cands = sorted(glob.glob(os.path.join(search_dir, "RingAmplPhase_*.h5")))
        if not cands:
            raise FileNotFoundError(
                f"optimized_weights_file='auto': no RingAmplPhase_*.h5 in "
                f"{search_dir!r}"
            )
        outplane = spec.meta.get("natural_outplane", 0.0)
        tpo_mm = (z_steering + outplane) * 1e3
        best, best_d = None, np.inf
        for c in cands:
            try:
                loc = float(np.asarray(pio.load_dict_h5(c)["LocationMM"]))
            except (OSError, KeyError, ValueError):
                continue
            if abs(loc - tpo_mm) < best_d:
                best, best_d = c, abs(loc - tpo_mm)
        if best is None:
            raise FileNotFoundError(
                f"optimized_weights_file='auto': no readable calibration in "
                f"{search_dir!r}"
            )
        weights_file = best
    blob = pio.load_dict_h5(weights_file)
    tx_sys = blob.get("TxSystem")
    if tx_sys is not None:
        name = tx_sys if isinstance(tx_sys, str) else str(
            np.asarray(tx_sys).item()
        )
        name = name.strip("b'\"")
        if name != spec.name:
            raise ValueError(
                f"{weights_file}: calibrated for {name}, case uses {spec.name}"
            )
    w = np.asarray(blob["Amplitudes"], np.float64) * np.exp(
        1j * np.asarray(blob["Phases"], np.float64)
    )
    w = w.ravel().astype(np.complex64)
    if n_elements is not None and w.size != n_elements:
        raise ValueError(
            f"{weights_file} has {w.size} elements, but the Tx has "
            f"{n_elements} (reference contract "
            f"`BabelIntegrationBASE.py:2230-2232`)"
        )
    return w


def make_pseudo_ct(ct_type: str, image, image_affine, labels_data,
                   labels_affine, zte_range=(0.1, 0.6), *, device="cuda"):
    """ZTE / PETRA MRI -> pseudo-CT HU in the image's grid (``run_case``'s
    conversion, without its file cache): the head mask is the labels
    resampled (nearest) onto that grid, then
    ``materials.pseudo_ct.mri_to_pseudo_ct`` (span ``<ct_type> to
    pseudo-CT``)."""
    image = np.asarray(image)
    head = im.resample_from_to(
        (np.asarray(labels_data) > 0).astype(np.float32),
        labels_affine,
        image_affine if image_affine is not None else labels_affine,
        image.shape,
        order=0,
        device=device,
    ) > 0.5
    with stage_timer(f"{ct_type} to pseudo-CT", level=1, step=1):
        return pseudo_ct.mri_to_pseudo_ct(
            np.asarray(image, np.float64), head, ct_type,
            norm_range=tuple(zte_range),
        )


def coregister_to_t1(image, image_affine, t1_data, t1_affine, *,
                     device="cuda", stats=None):
    """Rigid MRI -> T1 registration, the elastix-equivalent step of
    ``run_case`` before the pseudo-CT (`CTZTEProcessing.py:111,289`): the
    image resampled (linear) onto the T1 grid, ``coreg.register_rigid`` on
    ``device`` (span ``MRI to T1 coregistration``), the quality gate, then
    the registered image on the T1 grid. A registration whose quality is
    below ``coreg.QUALITY_THRESHOLD`` raises unless the environment sets
    ``BBT_IGNORE_COREG_QUALITY``. Returns (image on the T1 grid, rigid
    parameters, quality); the image's affine is ``t1_affine``. ``stats``
    goes to ``register_rigid``."""
    from .coreg import register_rigid, registration_ok

    t1 = np.asarray(t1_data, np.float32)
    mv = im.resample_from_to(np.asarray(image, np.float32), image_affine,
                             t1_affine, t1.shape, order=1, device=device)
    with stage_timer("MRI to T1 coregistration", level=1, step=1):
        params, mat, quality = register_rigid(t1, mv, return_quality=True,
                                              device=device, stats=stats)
    if not registration_ok(quality) and not os.environ.get(
        "BBT_IGNORE_COREG_QUALITY"
    ):
        # a silently-bad registration corrupts every later step; the
        # harness-calibrated threshold catches diverged / wrong-anatomy fits
        raise RuntimeError(
            f"CT/MR coregistration quality {quality:.3f} below the "
            f"calibrated failure threshold; inspect the inputs or set "
            f"BBT_IGNORE_COREG_QUALITY=1 to proceed anyway"
        )
    # the matrix maps T1 voxels to the resampled image's voxels
    return im.resample_affine(mv, mat[:3, :3], mat[:3, 3], t1.shape, order=1,
                              device=device), params, quality


@dataclass
class CaseConfig:
    """One sonication case (target x transducer x frequency x PPW)."""

    tx_system: str = "CTX_500"
    frequency: float = 500e3
    ppw: float = 6.0
    source_amp_pa: float = 60e3
    steering: tuple = (0.0, 0.0, 0.0)
    mapping_method: str = "Webb-Marsac"
    # imaging input type, like the reference's start-dialog CTType combo
    # (`SelFiles/ui_form.py:227-231`): 'CT' | 'ZTE' | 'PETRA' | 'Density'
    ct_type: str = "CT"
    zte_range: tuple = (0.1, 0.6)
    hu_threshold: float = 300.0
    density_threshold: float = 1200.0  # `BabelDatasetPreps.py:391,410-413`
    coregister: bool = False  # rigid-register CT/ZTE/PETRA to T1 first
    rotation_z: float = 0.0  # array rotation about the beam axis (degrees)
    do_refocus: bool = False
    # the reference's TightNarrowBeamDomain advanced option: shrink x/y to
    # the incident-beam support and truncate z past the focus
    # (`BabelIntegrationBASE.py:2024-2068`)
    tight_narrow_beam: bool = False
    z_beyond_focal_m: float = 0.0225
    # ring systems: program Z steering from a TPO focal distance against the
    # device's natural out-plane (`_Babel_RingTx/Babel_RingTx.py:97,226`)
    tpo_distance: float | None = None
    # concave arrays: holder-cone distance for the mechanical-Z auto-adjust
    # (`BabelIntegrationCONCAVE_PHASEDARRAY.py:140-152`); None = device default
    distance_cone_to_focus: float | None = None
    # single-element bowls: same-F-number virtual enlargement for a more
    # coherent FDTD input field (`BabelIntegrationSingle.py:224-238`), and
    # the user-adjustable Foc/Diam overrides of the Single system
    factor_enlarge: float = 1.0
    tx_diameter: float | None = None
    tx_focal_length: float | None = None
    segment_brain: bool = False
    bone_rim_correction: bool = False
    # drive at the device's calibrated 1 W amplitude instead of
    # ``source_amp_pa`` (DomeTx ships Amplitude1W tables,
    # `Babel_DomeTx/default.yaml`; `profiles.amplitude_for_1w`)
    drive_1w: bool = False
    # per-element calibrated complex weights: path to a RingAmplPhase h5
    # produced by `pipeline.calibration` (the reference's
    # ``OptimizedWeightsFile``, `BabelIntegrationBASE.py:2224-2234`), or
    # 'auto' to pick the nearest calibration location to the programmed TPO
    optimized_weights_file: str | None = None
    # round grid dims up to this multiple (+ steps to whole 4-cycle
    # multiples) so near-equal matrix cells share one compiled FDTD
    # executable (`build_domain(shape_bucket=...)`; the reference's case
    # loop is compile-free, `BabelIntegrationBASE.py:884-1037`). 0 = off.
    shape_bucket: int = 0
    elem_centers: np.ndarray | None = None
    output_dir: str = "."
    prefix: str = "case"
    export_meshes: bool = False
    meta: dict = field(default_factory=dict)
    # torch device of every device stage (Step-1 image ops, Rayleigh, FDTD,
    # BHTE)
    device: str = "cuda"


class CaseResults(dict):
    """Per-cell results of a ``run_cases`` sweep, plus a ``.summary``
    attribute (cases run, distinct FDTD grids vs cells that repeat one).
    The summary belongs
    to the instance (the JAX package's is a class-level dict shared by every
    instance; its ``run_cases`` assigns one per instance all the same)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.summary = {}


def run_cases(
    cfg: CaseConfig,
    labels_data,
    labels_affine,
    targets,
    direction_ras,
    *,
    frequencies=None,
    ppws=None,
    stop_on_error: bool = False,
    **case_kwargs,
):
    """Case-matrix sweep: targets x frequencies x PPW.

    The reference's ``RUN_SIM_BASE.RunCases`` loops the full matrix with
    per-case output naming and skip-if-output-exists caching
    (`BabelIntegrationBASE.py:884-1037`); this is the library equivalent —
    one call instead of shell loops, with each cell running ``run_case``
    (so the per-case hash caches and Step-1/pseudo-CT reuse apply across
    the matrix automatically).

    Parameters
    ----------
    targets : list of RAS points, or dict name -> RAS point. Names become
        the per-case prefix suffix (``<prefix>_<target>``); unnamed targets
        get ``T0``, ``T1``, ...
    frequencies, ppws : lists; default to the single values in ``cfg``.
    stop_on_error : raise on the first failing cell instead of recording
        the exception and continuing (the reference aborts the whole
        batch; continuing is friendlier for long sweeps).

    Returns dict ``(target_name, frequency, ppw) -> run_case result`` (or
    the exception instance for failed cells when ``stop_on_error`` is
    False). The returned mapping additionally carries a ``.summary``
    attribute under the JAX package's keys: ``cases``, and over the cells
    that ran their FDTD here (not failed, not served from the output
    cache) ``fdtd_executable_builds``, the number of distinct grid
    signatures, and ``fdtd_executable_reuses``, the cells that repeat one.
    The port compiles nothing per grid (there is no executable cache);
    the counts say how far ``cfg.shape_bucket`` collapsed the matrix, where
    the JAX package compiles once per signature.
    """
    if isinstance(targets, dict):
        named = list(targets.items())
    else:
        named = [(f"T{i}", t) for i, t in enumerate(targets)]
    freqs = list(frequencies) if frequencies is not None else [cfg.frequency]
    ppw_list = list(ppws) if ppws is not None else [cfg.ppw]

    results = CaseResults()
    n_cells = 0
    for tname, target in named:
        for f in freqs:
            for ppw in ppw_list:
                c = dataclasses.replace(
                    cfg, frequency=float(f), ppw=float(ppw),
                    prefix=f"{cfg.prefix}_{tname}",
                )
                key = (tname, float(f), float(ppw))
                n_cells += 1
                try:
                    results[key] = run_case(
                        c, labels_data, labels_affine, target,
                        direction_ras, **case_kwargs,
                    )
                except Exception as e:  # noqa: BLE001 - recorded per cell
                    if stop_on_error:
                        raise
                    results[key] = e
    grids = [_make_grid(r["domain"]) for r in results.values()
             if isinstance(r, dict) and r.get("domain") is not None]
    results.summary = {
        "cases": n_cells,
        "fdtd_executable_builds": len(set(grids)),
        "fdtd_executable_reuses": len(grids) - len(set(grids)),
    }
    return results


def run_case(
    cfg: CaseConfig,
    labels_data,
    labels_affine,
    target_ras,
    direction_ras,
    *,
    ct_data=None,
    ct_affine=None,
    t1_data=None,
    t1_affine=None,
    thermal_params: SonicationParams | None = None,
    mask_shape=None,
    mesh=None,
    force_recalc=False,
):
    """Run the full pipeline for one case; returns a results dict and writes
    the reference's output files (BabelViscoInput.nii.gz, DataForSim.h5,
    ThermalField h5).

    Caching: a blake2s hash over the inputs + config is stored next to the
    outputs; when it matches and ``force_recalc`` is False, Steps 1+2 are
    reloaded from disk instead of recomputed (the reference's
    skip-if-output-exists + FileManager hash-chain behavior,
    `BabelIntegrationBASE.py:962-966`, `FileManager.py:223`).
    """
    spec = TRANSDUCER_REGISTRY[cfg.tx_system]
    dev = cfg.device
    out_base = os.path.join(
        cfg.output_dir,
        f"{cfg.prefix}_{cfg.tx_system}_{int(cfg.frequency/1e3)}kHz_{int(cfg.ppw)}PPW",
    )
    os.makedirs(cfg.output_dir, exist_ok=True)
    # per-dataset AdvancedParams diff forces full recalculation
    # (`BabelBrain.py:1547-1583`)
    force_recalc = force_recalc or check_advanced_params(out_base, cfg)

    ct_type = cfg.ct_type.upper().replace("REAL ", "")
    if ct_data is not None and ct_type in ("ZTE", "PETRA"):
        # MRI -> pseudo-CT conversion in the imaging grid, mirroring Step 1's
        # CTZTEProcessing branch (`BabelDatasetPreps.py:843-851`,
        # `CTZTEProcessing.py:501-628`). The product is target-independent,
        # so it is cached by CONTENT hash in the output dir and reused
        # across targets/prefixes — the reference's cross-target reuse via
        # filename substitution (`FileManager.py:270-283`).
        pct_hash = case_hash(
            ct=np.asarray(ct_data),
            t1=np.asarray(t1_data) if t1_data is not None else "none",
            labels=np.asarray(labels_data),
            ct_type=ct_type,
            zte_range=tuple(cfg.zte_range),
            coreg=cfg.coregister,
        )
        pct_cache = os.path.join(cfg.output_dir, f"pseudoCT_{pct_hash}.h5")
        pct = None
        if not force_recalc and os.path.isfile(pct_cache):
            try:
                pct = pio.load_dict_h5(pct_cache)
            except OSError:
                pct = None
        if pct is not None:
            ct_data = np.asarray(pct["pct"])
            ct_affine = np.asarray(pct["affine"])
        else:
            if cfg.coregister and t1_data is not None:
                ct_data, _, _ = coregister_to_t1(ct_data, ct_affine, t1_data,
                                                 t1_affine, device=dev)
                ct_affine = t1_affine
            ct_data = make_pseudo_ct(ct_type, ct_data, ct_affine, labels_data,
                                     labels_affine, cfg.zte_range, device=dev)
            pio.save_dict_h5(
                {
                    "pct": np.asarray(ct_data),
                    "affine": np.asarray(
                        ct_affine if ct_affine is not None else np.eye(4)
                    ),
                },
                pct_cache,
            )
    bone_threshold = (
        cfg.density_threshold if ct_type == "DENSITY" else cfg.hu_threshold
    )

    chash = case_hash(
        labels=np.asarray(labels_data),
        target=np.asarray(target_ras, float),
        direction=np.asarray(direction_ras, float),
        ct=np.asarray(ct_data) if ct_data is not None else "none",
        tx=cfg.tx_system,
        freq=cfg.frequency,
        ppw=cfg.ppw,
        steering=tuple(cfg.steering),
        refocus=cfg.do_refocus,
        rotz=cfg.rotation_z,
        mapping=cfg.mapping_method,
        ct_type=cfg.ct_type,
        zte_range=tuple(cfg.zte_range),
        thr=(cfg.hu_threshold, cfg.density_threshold),
        segment=cfg.segment_brain,
        rim=cfg.bone_rim_correction,
        amp=cfg.source_amp_pa,
        mask_shape=tuple(mask_shape) if mask_shape else "auto",
        # physics-changing env hooks must invalidate the cache too, else a
        # re-run with a hook toggled would silently return stale results
        env_hooks=(
            os.environ.get("BBT_QCORRECTION", ""),
            os.environ.get("BBT_PAPER_CONDITIONS", ""),
            os.environ.get("BBT_AVOID_PHASE_PROGRAMMING", ""),
        ),
        tight=(cfg.tight_narrow_beam, cfg.z_beyond_focal_m),
        tpo=cfg.tpo_distance,
        cone=cfg.distance_cone_to_focus,
        enlarge=(cfg.factor_enlarge, cfg.tx_diameter, cfg.tx_focal_length),
        drive_1w=cfg.drive_1w,
        weights=cfg.optimized_weights_file,
    )
    hash_file = out_base + ".hash"
    h5_path_probe = out_base + "_DataForSim.h5"
    if (
        not force_recalc
        and os.path.isfile(hash_file)
        and os.path.isfile(h5_path_probe)
        and open(hash_file).read().strip() == chash
    ):
        cached = pio.load_dict_h5(h5_path_probe)
        return {
            "step1": None,
            "domain": None,
            "acoustic": None,
            "thermal": None,
            "cached": True,
            "data_for_sim": cached,
            "files": {
                "mask": out_base + "_BabelViscoInput.nii.gz",
                "acoustic": h5_path_probe,
                "thermal": None,
            },
        }

    # ---------------- Step 1 ----------------
    # Per-step cache (the FileManager hash-chain idea, `FileManager.py:163-293`):
    # Step 1 only depends on the trajectory + imaging inputs, so steering /
    # refocus / power / thermal changes reuse the domain files.
    s1_hash = case_hash(
        labels=np.asarray(labels_data),
        target=np.asarray(target_ras, float),
        direction=np.asarray(direction_ras, float),
        ct=np.asarray(ct_data) if ct_data is not None else "none",
        freq=cfg.frequency,
        ppw=cfg.ppw,
        ct_type=cfg.ct_type,
        zte_range=tuple(cfg.zte_range),
        thr=(cfg.hu_threshold, cfg.density_threshold),
        segment=cfg.segment_brain,
        rim=cfg.bone_rim_correction,
        mask_shape=tuple(mask_shape) if mask_shape else "auto",
    )
    s1_cache = out_base + "_Step1.h5"
    s1 = None
    # precursor chain check: the written NIfTI must carry the matching hash
    # in its descrip header (`FileManager.py:163-293`); a replaced or
    # corrupted intermediate invalidates the Step-1 reuse
    if (
        not force_recalc
        and os.path.isfile(s1_cache)
        and verify_precursor(out_base + "_BabelViscoInput.nii.gz", s1_hash)
    ):
        try:
            blob = pio.load_dict_h5(s1_cache)
            if str(np.asarray(blob["hash"]).item()) in (s1_hash, repr(s1_hash)):
                s1 = Step1Result(
                    mask=np.asarray(blob["mask"]),
                    affine=np.asarray(blob["affine"]),
                    dx_mm=float(np.asarray(blob["dx_mm"])),
                    target_idx=np.asarray(blob["target_idx"]),
                    ct_index=np.asarray(blob["ct_index"])
                    if "ct_index" in blob else None,
                    unique_hu=np.asarray(blob["unique_hu"])
                    if "unique_hu" in blob else None,
                    air_mask=np.asarray(blob["air_mask"]).astype(bool)
                    if "air_mask" in blob else None,
                )
        except (OSError, KeyError, ValueError):
            s1 = None
    if s1 is None:
        with stage_timer("Step1 domain generation", level=2, step=1):
            s1 = generate_mask(
                labels_data,
                labels_affine,
                target_ras,
                direction_ras,
                cfg.frequency,
                cfg.ppw,
                shape=mask_shape,
                segment_brain_tissue=cfg.segment_brain,
                ct_data=ct_data,
                ct_affine=ct_affine,
                hu_threshold=bone_threshold,
                bone_rim_correction=cfg.bone_rim_correction,
                device=dev,
            )
            descrip = f"hash:{s1_hash}".encode()
            pio.save_nifti(
                out_base + "_BabelViscoInput.nii.gz", s1.mask, s1.affine,
                descrip,
            )
            if s1.ct_index is not None:
                pio.save_nifti(
                    out_base + "_CT.nii.gz", s1.ct_index, s1.affine, descrip
                )
                np.savez(out_base + "_CT-cal.npz", UniqueHU=s1.unique_hu)
            blob = {
                "hash": s1_hash,
                "mask": s1.mask,
                "affine": s1.affine,
                "dx_mm": s1.dx_mm,
                "target_idx": s1.target_idx,
            }
            if s1.ct_index is not None:
                blob["ct_index"] = s1.ct_index
                blob["unique_hu"] = s1.unique_hu
            if s1.air_mask is not None:
                blob["air_mask"] = s1.air_mask.astype(np.uint8)
            pio.save_dict_h5(blob, s1_cache)
    if cfg.export_meshes:
        from .step1 import export_surface_meshes

        with stage_timer("Step1 surface meshes", level=2, step=1):
            export_surface_meshes(s1, out_base)

    # ---------------- Step 2 ----------------
    h5_path = out_base + "_DataForSim.h5"
    ct_mode = s1.ct_index is not None
    with stage_timer("Step2 acoustic simulation", level=2, step=2):
        if ct_mode:
            rho, sos, att = map_hu_to_properties(
                s1.unique_hu,
                cfg.frequency,
                cfg.mapping_method,
                is_petra=(ct_type == "PETRA"),
                density_input=s1.unique_hu if ct_type == "DENSITY" else None,
            )
            materials = build_ct_materials(
                cfg.frequency, cfg.segment_brain, rho, sos, att
            )
        else:
            materials = build_label_materials(cfg.frequency, cfg.segment_brain)
        # registry steering semantics: TPO -> ZSteering for ring systems,
        # per-device range enforcement, concave holder-cone mechanical-Z
        steering = np.asarray(cfg.steering, float)
        if cfg.tpo_distance is not None:
            steering = steering.copy()
            steering[2] = tpo_to_z_steering(spec, cfg.tpo_distance)
        validate_steering(spec, steering)
        is_dome = spec.kind == "dome"
        # drive amplitude: the calibrated 1 W level when requested
        # (`Babel_DomeTx/default.yaml` Amplitude1W, `amplitude_for_1w`)
        source_amp = cfg.source_amp_pa
        if cfg.drive_1w:
            from .profiles import amplitude_for_1w

            source_amp = amplitude_for_1w(spec, cfg.frequency, cfg.ppw)
        # per-element calibrated weights (the reference's
        # OptimizedWeightsFile, `BabelIntegrationBASE.py:2224-2234`)
        elem_weights = None
        if cfg.optimized_weights_file is not None:
            elem_weights = load_optimized_weights(
                cfg.optimized_weights_file, spec,
                search_dir=cfg.output_dir,
                z_steering=float(steering[2]),
                n_elements=spec.n_elements or len(spec.in_diameters) or None,
            )
        mech_z = 0.0
        extra_depth = 0.0
        if spec.kind == "concave" and "cone_to_focus" in spec.meta:
            sim_mask = np.flip(s1.mask, axis=2)
            ti, tj, tk = (int(v) for v in np.argwhere(sim_mask == 5)[0])
            line = np.nonzero(sim_mask[ti, tj, :])[0]
            skin_to_target = (tk - int(line[0])) * s1.dx_mm * 1e-3
            mech_z, extra_depth = cone_to_focus_adjust(
                spec, skin_to_target, cfg.distance_cone_to_focus,
                z_steering=float(steering[2]),
            )
        # reference grow/tight-beam-shrink fit (`BabelIntegrationBASE.py:
        # 1874-2068`): offsets grown so the incident cone clears the PML,
        # x/y shrunk to the beam support in tight mode
        eff_diam = (cfg.tx_diameter or spec.diameter) * cfg.factor_enlarge
        eff_focal = (
            cfg.tx_focal_length
            if cfg.tx_focal_length is not None
            else (spec.focal_length or 0.0)
        ) * cfg.factor_enlarge
        offsets, shrinks = fit_domain_offsets(
            np.flip(s1.mask, axis=2),
            s1.dx_mm * 1e-3,
            eff_diam,
            eff_focal,
            tx_mech_adjust=(0.0, 0.0, mech_z),
            extra_depth=extra_depth,
            tight_narrow_beam=cfg.tight_narrow_beam,
            z_beyond_focal_m=cfg.z_beyond_focal_m,
            dome=is_dome,
        )
        dom = build_domain(
            s1.mask,
            cfg.frequency,
            cfg.ppw,
            materials=materials,
            ct_index_map=s1.ct_index if ct_mode else None,
            air_mask=s1.air_mask
            if (ct_mode and s1.air_mask is not None and s1.air_mask.any())
            else None,
            offsets=offsets,
            shrink_cells=shrinks,
            shape_bucket=cfg.shape_bucket,
        )
        tx = build_transducer(
            spec, cfg.frequency, elem_centers=cfg.elem_centers,
            rotation_z=cfg.rotation_z, factor_enlarge=cfg.factor_enlarge,
            diameter=cfg.tx_diameter, focal_length=cfg.tx_focal_length,
        )
        if is_dome:
            # dome dispatch: whole array inside the domain, volumetric
            # drive, no source-plane repositioning
            # (`BabelIntegrationDOME_PHASEDARRAY.py:344-407`)
            mech_adjust = 0.0
            result = run_dome_sim(
                dom,
                tx,
                source_amp,
                steering_target=steering if np.any(steering != 0) else None,
                element_weights=elem_weights,
                mesh=mesh,
                device=dev,
            )
        else:
            tx, mech_adjust = position_transducer(
                tx, dom, eff_focal, extra_z=mech_z,
                return_adjustment=True,
            )
            result = run_acoustic_sim(
                dom,
                tx,
                source_amp,
                element_weights=elem_weights,
                steering_target=steering if np.any(steering != 0) else None,
                do_refocus=cfg.do_refocus,
                mesh=mesh,
                device=dev,
            )
        data = dict(result.data_for_sim)
        data["TxSystem"] = cfg.tx_system
        data["Frequency"] = cfg.frequency
        for k, v in zip(("XSteering", "YSteering", "ZSteering"), steering):
            data[k] = v
        # mechanical z correction applied to fit the bowl below the source
        # plane, reported along the trajectory direction in RAS (the
        # reference's AdjustmentInRAS, `_BabelBaseTx.py:407` + §3.2/S10)
        data["AdjustmentInRAS"] = mech_adjust * 1e3 * np.asarray(direction_ras)
        if ct_mode:
            # skull-density ratio of the quantized-HU volume within the
            # skull labels (`BabelIntegrationBASE.py:816,1392`); restrict to
            # bone-range HU so partial-volume edge voxels don't skew the ray
            # minima (the reference rays only traverse thresholded bone)
            hu_vol = s1.unique_hu[s1.ct_index]
            skull = np.isin(s1.mask, (2, 3)) & (hu_vol > 300.0)
            data["SDR"] = compute_sdr(hu_vol, skull, spacing_mm=s1.dx_mm)
        if ct_mode and s1.air_mask is not None and s1.air_mask.any():
            # optional AirMask key the reference's thermal step consumes
            # (`CalculateTemperatureEffects.py:692-694`)
            data["AirMask"] = s1.air_mask.astype(np.uint8)
        # BLOSC per the driving-system interop contract
        # (`InformationForDrivingSystems.md:12-16`); saved on the
        # background pool so Step 3 overlaps the serialization (the
        # reference's FileManager thread-pool saves,
        # `BabelBrain/FileManager.py:127-152`)
        saver = pio.AsyncSaver()
        saver.save_dict_h5(data, h5_path, compression="blosc")
        # companion water file: the reference's thermal step resolves
        # `..._Water_DataForSim.h5` next to the skull file and reads its
        # `p_amp` (`CalculateTemperatureEffects.py:683-690`), so writing it
        # makes these outputs drop-in inputs for the reference's Step 3
        saver.save_dict_h5(
            {
                "p_amp": np.asarray(data["p_amp_water"]),
                "SpatialStep": dom.dx,
            },
            out_base + "_Water_DataForSim.h5",
            compression="blosc",
        )
        # display NIfTIs for Brainsight/Slicer overlays, the reference's
        # OutputFileNames contract (`BabelIntegrationBASE.py:1039-1067`);
        # the mask grid is already isotropic so a plain save satisfies the
        # enforced-ISO rule (`:737`)
        saver.save_nifti(
            out_base + "_FullElasticSolution.nii.gz",
            np.asarray(result.p_amp, np.float32), s1.affine,
        )
        saver.save_nifti(
            out_base + "_RayleighFreeWater.nii.gz",
            np.abs(result.rayleigh_field).astype(np.float32), s1.affine,
        )
        if result.p_amp_refocus is not None:
            saver.save_nifti(
                out_base + "_FullElasticSolutionRefocus.nii.gz",
                np.asarray(result.p_amp_refocus, np.float32), s1.affine,
            )

    if os.environ.get("BBT_FORCE_ERROR_STEP2") == "1":
        # error-path test hook (the reference's TEST_FORCE_ERROR_BABEL_STEP2,
        # `BabelIntegrationBASE.py:1034-1036`)
        raise RuntimeError("forced Step-2 error (BBT_FORCE_ERROR_STEP2)")

    # ---------------- Step 3 ----------------
    thermal = None
    if isinstance(thermal_params, (list, tuple)):
        # full thermal profile: one BHTE run per combination + consolidation
        # (`CalculateThermalProcess.py:54-123`)
        with stage_timer("Step3 thermal simulation", level=2, step=3):
            p_water = data.get("p_amp_water", result.p_amp)
            t_all, _ = run_all_combinations(
                result.p_amp,
                np.asarray(p_water),
                data["MaterialMap"],
                materials,
                dom.dx,
                data["TargetLocation"],
                list(thermal_params),
                out_base=out_base,
                ct_mode=ct_mode,
                segmented=cfg.segment_brain,
                frequency=cfg.frequency,
                tx_is_dome=is_dome,
                device=dev,
            )
            thermal = t_all[-1]
    elif thermal_params is not None:
        with stage_timer("Step3 thermal simulation", level=2, step=3):
            p_water = data.get("p_amp_water", result.p_amp)
            thermal = run_sonication(
                result.p_amp,
                np.asarray(p_water),
                data["MaterialMap"],
                materials,
                dom.dx,
                data["TargetLocation"],
                thermal_params,
                ct_mode=ct_mode,
                segmented=cfg.segment_brain,
                frequency=cfg.frequency,
                tx_is_dome=is_dome,
                device=dev,
            )
            tdict = {
                "MaterialList": {
                    "Density": materials[:, 0],
                    "SoS": materials[:, 1],
                    "Attenuation": materials[:, 3],
                },
                "p_map": result.p_amp * thermal.pressure_ratio,
                "MaterialMap": data["MaterialMap"],
                "TempEndFUS": thermal.temperature_end,
                "FinalTemp": thermal.temperature_end,
                "FinalDose": thermal.dose,
                "DoseEndFUS": thermal.dose,
                "TemperaturePoints": thermal.monitor,
                # the step of each sample: one a launch, so every step on
                # the CPU and every K-step sweep's last on a card
                "TemperaturePointsSteps": thermal.monitor_steps,
                "TargetLocation": data["TargetLocation"],
                "RatioLosses": thermal.ratio_losses,
                "PressureRatio": thermal.pressure_ratio,
                "dt": 0.01,
            }
            tdict.update(thermal.metrics)
            saver.save_dict_h5(tdict, out_base + "_ThermalField.h5",
                               compression="blosc")

    # all background saves must land (and any writer error surface) before
    # the hash marks the case complete
    saver.wait()
    with open(hash_file, "w") as f:
        f.write(chash)
    # session-level telemetry event (the reference posts per-run CTS events
    # with Tx/frequency metadata, `Telemetry/Telemetry.py:10-109`)
    try:
        from ..utils.telemetry import get_telemetry

        tel = get_telemetry()
        tel.event(
            "CTS:L0: case complete",
            tx=cfg.tx_system, frequency=cfg.frequency, ppw=cfg.ppw,
            ct_type=cfg.ct_type if ct_data is not None else "none",
            refocus=cfg.do_refocus,
        )
        tel.flush()
    except Exception:
        pass
    return {
        "step1": s1,
        "domain": dom,
        "acoustic": result,
        "thermal": thermal,
        "cached": False,
        "data_for_sim": data,
        "files": {
            "mask": out_base + "_BabelViscoInput.nii.gz",
            "acoustic": h5_path,
            "thermal": out_base + "_ThermalField.h5" if thermal else None,
        },
    }
