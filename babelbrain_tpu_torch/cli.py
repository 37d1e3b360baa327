"""Command-line interface (the headless replacement for the reference GUI).

    python -m babelbrain_tpu_torch run --labels charm.nii.gz --trajectory t.txt \
        --tx CTX_500 --frequency 500e3 --ppw 6 --out outdir [--ct ct.nii.gz]
        [--thermal-profile profile.yaml] [--device cpu]
    python -m babelbrain_tpu_torch plan --labels charm.nii.gz --target 12,-8,55 \
        --max-distance 80 --min-distance 30 --out placements.csv
    python -m babelbrain_tpu_torch list-tx

Counterpart of ``babelbrain_tpu/cli.py`` with its arguments and JSON output;
``run`` adds ``--device`` (default ``cuda``), where every device stage runs.
``bench`` is not ported yet (ROADMAP Queue A item 1).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _cmd_run(args):
    from .pipeline.io import load_nifti
    from .pipeline.runner import CaseConfig, run_case
    from .pipeline.thermal import SonicationParams
    from .pipeline.transforms import (
        read_trajectory_brainsight,
        trajectory_target_direction,
    )

    if args.labels.endswith(".msh"):
        # SimNIBS head model: rasterize tetrahedra to 1 mm charm labels
        # (the reference's MeshConv subprocess, `BabelDatasetPreps.py:307`)
        from .pipeline.simnibs import msh_to_labels, read_msh

        nodes, _ = read_msh(args.labels)
        lo = np.floor(nodes.min(0)) - 1
        shape = tuple((np.ceil(nodes.max(0)) - lo + 2).astype(int))
        aff = np.eye(4)
        aff[:3, 3] = lo

        class _Img:
            affine = aff

            @staticmethod
            def get_fdata():
                return msh_to_labels(args.labels, aff, shape)

        labels = _Img()
    else:
        labels = load_nifti(args.labels)
    targets = None
    if args.trajectory:
        _, m = read_trajectory_brainsight(args.trajectory)
        target, direction = trajectory_target_direction(m)
    else:
        targets = [
            np.array([float(v) for v in t.split(",")])
            for t in args.target.split(";")
        ]
        target = targets[0]
        direction = np.array([float(v) for v in args.direction.split(",")])
    freqs = [float(v) for v in str(args.frequency).split(",")]
    ppws = [float(v) for v in str(args.ppw).split(",")]

    ct = ct_aff = None
    if args.ct:
        ct_nii = load_nifti(args.ct)
        ct, ct_aff = ct_nii.get_fdata(), ct_nii.affine
    t1 = t1_aff = None
    if args.t1:
        t1_nii = load_nifti(args.t1)
        t1, t1_aff = t1_nii.get_fdata(), t1_nii.affine

    thermal = None
    if args.thermal_profile:
        from .pipeline.profiles import load_thermal_profile

        _, combos = load_thermal_profile(args.thermal_profile)
        thermal = combos or None
    elif args.thermal:
        dc, prf, dur, off = (float(v) for v in args.thermal.split(","))
        thermal = SonicationParams(
            duration_on=dur, duration_off=off, duty_cycle=dc, prf=prf,
            isppa=args.isppa,
        )

    elem_centers = None
    if args.elements_csv:
        elem_centers = np.loadtxt(args.elements_csv, delimiter=",") * (
            1e-3 if args.elements_unit == "mm" else 1.0
        )

    cfg = CaseConfig(
        tx_system=args.tx,
        frequency=freqs[0],
        ppw=ppws[0],
        steering=tuple(float(v) for v in args.steering.split(",")),
        do_refocus=args.refocus,
        ct_type=args.ct_type,
        zte_range=tuple(float(v) for v in args.zte_range.split(",")),
        hu_threshold=args.hu_threshold,
        density_threshold=args.density_threshold,
        coregister=args.coregister,
        rotation_z=args.rotation_z,
        mapping_method=args.mapping,
        segment_brain=args.segment_brain,
        bone_rim_correction=args.bone_rim_correction,
        elem_centers=elem_centers,
        tight_narrow_beam=args.tight_narrow_beam,
        tpo_distance=args.tpo_distance * 1e-3 if args.tpo_distance else None,
        distance_cone_to_focus=(
            args.cone_to_focus * 1e-3 if args.cone_to_focus else None
        ),
        factor_enlarge=args.factor_enlarge,
        tx_diameter=args.tx_diameter * 1e-3 if args.tx_diameter else None,
        tx_focal_length=(
            args.tx_focal_length * 1e-3 if args.tx_focal_length else None
        ),
        drive_1w=args.drive_1w,
        optimized_weights_file=args.optimized_weights or None,
        output_dir=args.out,
        prefix=args.prefix,
        export_meshes=args.export_meshes,
        device=args.device,
    )
    mask_shape = None
    if args.mask_shape:
        mask_shape = tuple(int(v) for v in args.mask_shape.split(","))
    common = dict(
        ct_data=ct,
        ct_affine=ct_aff,
        t1_data=t1,
        t1_affine=t1_aff,
        thermal_params=thermal,
        mask_shape=mask_shape,
    )
    labels_np = labels.get_fdata().astype(np.int32)
    matrix = (
        (targets is not None and len(targets) > 1)
        or len(freqs) > 1 or len(ppws) > 1
    )
    if matrix:
        # case-matrix sweep (the reference's RunCases loop over
        # targets x frequencies x PPW, `BabelIntegrationBASE.py:884-1037`)
        from .pipeline.runner import run_cases

        res_map = run_cases(
            cfg, labels_np, labels.affine,
            targets if targets is not None else [target],
            direction, frequencies=freqs, ppws=ppws, **common,
        )
        summary = {}
        for (tname, f, p), res in res_map.items():
            key = f"{tname}_{int(f/1e3)}kHz_{int(p)}PPW"
            if isinstance(res, Exception):
                summary[key] = {"error": str(res)}
            else:
                summary[key] = {"files": res["files"],
                                "cached": res["cached"]}
        summary["_sweep"] = res_map.summary
        print(json.dumps(summary, indent=2, default=str))
        return
    res = run_case(
        cfg,
        labels_np,
        labels.affine,
        target,
        direction,
        **common,
    )
    summary = {"files": res["files"]}
    if res["thermal"] is not None:
        summary["metrics"] = {
            k: float(v)
            for k, v in res["thermal"].metrics.items()
            if np.isscalar(v) or isinstance(v, (int, float))
        }
    print(json.dumps(summary, indent=2, default=str))


def _cmd_plan(args):
    """Placement planning (the PlanTUS-integration capability, headless)."""
    from .pipeline.io import load_nifti
    from .pipeline.plantus import (
        PlanTUSConfig,
        export_placements_csv,
        suggest_placements,
    )
    from .pipeline.transforms import write_trajectory_brainsight

    nii = load_nifti(args.labels)
    cfg = PlanTUSConfig(
        max_distance=args.max_distance,
        min_distance=args.min_distance,
        optimal_distance=args.optimal_distance,
        transducer_diameter=args.diameter,
        max_angle=args.max_angle,
        plane_offset=args.plane_offset,
        additional_offset=args.additional_offset,
    )
    target = np.array([float(v) for v in args.target.split(",")])
    res = suggest_placements(
        nii.get_fdata().astype(np.int32), nii.affine, target, cfg,
        top_k=args.top_k,
    )
    export_placements_csv(args.out, res)
    if args.trajectory_out:
        write_trajectory_brainsight(
            args.trajectory_out, "PlannedTarget", res.trajectory(0)
        )
    best = res.positions_ras[0]
    print(
        json.dumps(
            {
                "candidates": int(len(res.candidates_ras)),
                "best_entry_ras": [round(float(v), 2) for v in best],
                "best_score": round(float(res.scores[0]), 4),
                "csv": args.out,
            }
        )
    )


def _cmd_list_tx(args):
    from .pipeline.profiles import TRANSDUCER_REGISTRY

    for name, spec in sorted(TRANSDUCER_REGISTRY.items()):
        freqs = "/".join(f"{f/1e3:.0f}k" for f in spec.frequencies)
        print(
            f"{name:14s} {spec.kind:8s} D={spec.diameter*1e3:.1f}mm "
            f"F={0 if not spec.focal_length else spec.focal_length*1e3:.1f}mm "
            f"[{freqs}]"
        )


def _cmd_bench(args):
    raise NotImplementedError(
        "the port has no benchmark yet (ROADMAP Queue A item 1); "
        "chip_smoke.py drives it on the card"
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="babelbrain_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a full planning case")
    r.add_argument("--labels", required=True, help="segmentation labels NIfTI")
    r.add_argument("--trajectory", help="Brainsight trajectory export")
    r.add_argument("--target", default="0,0,0",
                   help="target RAS mm (x,y,z); multiple targets separated "
                        "by ';' run as a case matrix")
    r.add_argument("--direction", default="0,0,-1", help="sonication direction")
    r.add_argument("--tx", default="CTX_500")
    r.add_argument("--frequency", default="500e3",
                   help="Hz; comma-separated list runs a case matrix")
    r.add_argument("--ppw", default="6",
                   help="points per wavelength; comma list runs a matrix")
    r.add_argument("--ct", help="CT / ZTE / PETRA / density NIfTI (enables CT mode)")
    r.add_argument(
        "--ct-type", default="CT", choices=["CT", "ZTE", "PETRA", "Density"],
        help="imaging type of --ct (the reference's CTType selector)",
    )
    r.add_argument("--t1", help="T1w NIfTI (for --coregister)")
    r.add_argument(
        "--coregister", action="store_true",
        help="rigid-register --ct to --t1 first (elastix-equivalent)",
    )
    r.add_argument("--zte-range", default="0.1,0.6",
                   help="normalized ZTE/PETRA bone range")
    r.add_argument("--hu-threshold", type=float, default=300.0)
    r.add_argument("--density-threshold", type=float, default=1200.0)
    r.add_argument("--rotation-z", type=float, default=0.0,
                   help="array rotation about the beam axis (deg)")
    r.add_argument("--mapping", default="Webb-Marsac",
                   help="CT mapping method (7 supported)")
    r.add_argument("--steering", default="0,0,0", help="steering offsets (m)")
    r.add_argument("--tpo-distance", type=float, default=0.0,
                   help="ring systems: TPO focal distance (mm); converted to "
                        "Z steering against the device's natural out-plane")
    r.add_argument("--cone-to-focus", type=float, default=0.0,
                   help="concave arrays: holder-cone distance (mm) for the "
                        "mechanical-Z auto-adjust (0 = device default)")
    r.add_argument("--tight-narrow-beam", action="store_true",
                   help="shrink the domain to the incident-beam support "
                        "(the reference's TightNarrowBeamDomain option)")
    r.add_argument("--factor-enlarge", type=float, default=1.0,
                   help="single bowls: same-F-number virtual enlargement")
    r.add_argument("--tx-diameter", type=float, default=0.0,
                   help="single bowls: override aperture (mm)")
    r.add_argument("--tx-focal-length", type=float, default=0.0,
                   help="single bowls: override focal length (mm)")
    r.add_argument("--refocus", action="store_true")
    r.add_argument("--drive-1w", action="store_true",
                   help="drive at the device's calibrated 1 W amplitude "
                        "(DomeTx Amplitude1W tables)")
    r.add_argument("--optimized-weights", default="",
                   help="RingAmplPhase h5 with calibrated per-element "
                        "weights, or 'auto' to pick the nearest calibration "
                        "location in the output dir")
    r.add_argument(
        "--export-meshes",
        action="store_true",
        help="write skin/bone/csf surface STLs from the Step-1 labels",
    )
    r.add_argument("--segment-brain", action="store_true")
    r.add_argument(
        "--bone-rim-correction",
        action="store_true",
        help="boost partial-volume-depressed CT rim voxels (CT mode)",
    )
    r.add_argument("--thermal", help="DC,PRF,DurOn,DurOff")
    r.add_argument("--thermal-profile", help="Thermal_Profile yaml")
    r.add_argument("--isppa", type=float, default=5.0)
    r.add_argument("--elements-csv", help="element centers for phased arrays")
    r.add_argument("--elements-unit", default="mm", choices=["mm", "m"])
    r.add_argument("--out", default=".")
    r.add_argument("--prefix", default="case")
    r.add_argument(
        "--mask-shape",
        help="override Step-1 grid shape as N1,N2,N3 (default sized for a "
        "full head at the chosen PPW)",
    )
    r.add_argument("--device", default="cuda",
                   help="torch device of the device stages (cuda or cpu)")
    r.set_defaults(fn=_cmd_run)

    pl = sub.add_parser("plan", help="rank transducer placements for a target")
    pl.add_argument("--labels", required=True, help="Step-1 label NIfTI")
    pl.add_argument("--target", required=True, help="target RAS mm (x,y,z)")
    pl.add_argument("--max-distance", type=float, default=80.0)
    pl.add_argument("--min-distance", type=float, default=10.0)
    pl.add_argument("--optimal-distance", type=float, default=0.0)
    pl.add_argument("--diameter", type=float, default=64.0)
    pl.add_argument("--max-angle", type=float, default=15.0)
    pl.add_argument("--plane-offset", type=float, default=0.0)
    pl.add_argument("--additional-offset", type=float, default=0.0)
    pl.add_argument("--top-k", type=int, default=10)
    pl.add_argument("--out", default="placements.csv")
    pl.add_argument("--trajectory-out", help="write best entry as Brainsight txt")
    pl.set_defaults(fn=_cmd_plan)

    lt = sub.add_parser("list-tx", help="list supported transducers")
    lt.set_defaults(fn=_cmd_list_tx)

    b = sub.add_parser("bench", help="the single-chip FDTD benchmark (not "
                       "ported yet)")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
