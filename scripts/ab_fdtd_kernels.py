#!/usr/bin/env python3
"""A/B of the FDTD kernels of two trees of the port, on one CUDA GPU.

    python3 scripts/ab_fdtd_kernels.py --other DIR [--out FILE]

``DIR`` holds another tree of the repository (for example a commit
unpacked with ``git archive <commit> | tar -x -C DIR``). Both trees'
kernel libraries are built from their own ``csrc/``; the script prints
each FDTD kernel's registers, spills and stack in both builds (from
``nvcc -Xptxas -v``) and, after the timings, fails if a kernel both builds
hold differs. It times every velocity and pressure / stress instantiation
the main path launches without a monitor sample (fluid viscous and
inviscid, visco; plain, +DFT, point, point+DFT) at
``chip_smoke.KERNEL_SHAPE``, each from a CUDA graph of 20 calls as
``chip_smoke._timed_graph`` times it, in the order other, this, this,
other, on one state after 200 steps of this tree's kernels. The last line
is a JSON object of the times (ms) and their ratios (this / other); with
``--out`` it is also written to FILE.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def load_other(root: str):
    """The other tree's ``babelbrain_tpu_torch`` under the name
    ``bbt_other`` (its relative imports resolve inside that tree)."""
    pkg = os.path.join(root, "babelbrain_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "bbt_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bbt_other"] = mod
    spec.loader.exec_module(mod)
    return mod


def resources(build):
    """Kernel -> its ptxas resources. A pressure / stress instantiation
    with a fourth template argument (MONITOR) is named by its first three
    when that argument is 0 (no monitor), so that it meets its twin of a
    tree without the argument, and gets the monitor mode appended else.
    The last argument of a tree whose kernels take the x-slab flag XALL is
    dropped where it is 1 (a whole grid, the twin of a tree without it);
    the shards' instantiations (0) are named "... shards"."""
    out = {}
    for name, res in C.fdtd_resources(build.build_log):
        suffix = ""
        if name.count(",") == 4 or (name.startswith(
                ("fluid_velocity_kernel<", "visco_velocity_kernel<"))):
            head, flag = name[:-1].rsplit(", " if "," in name else "<", 1)
            name = head + (">" if "," in head else "")
            suffix = "" if flag == "1" else " shards"
        if name.count(",") == 3:
            head, mode = name[:-1].rsplit(", ", 1)
            name = head + ">" + {"0": "", "1": " MONITOR listed",
                                 "2": " MONITOR every voxel"}[mode]
        out[name + suffix] = res
    return out


def cases(device):
    """(family, label, state, coefficients, step scalars, point) of each
    timed configuration, its state after 200 steps."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    out = []
    for family, viscous in (("fluid", True), ("fluid", False),
                            ("visco", True)):
        if family == "fluid":
            grid, co, _, _, oz = C.fluid_case(
                C.KERNEL_SHAPE, 200, 150, "point", device, viscous=viscous)
            st, step = K.FluidState.zeros(C.KERNEL_SHAPE, 14, device), \
                F.fluid_step
        else:
            grid, co, _, _, oz, _ = C.visco_case(C.KERNEL_SHAPE, 200, 150,
                                                 "point", device)
            st, step = V.ViscoState.zeros(C.KERNEL_SHAPE, 14, device), \
                F.visco_step
        for n in range(grid.n_steps):
            step(st, co, grid, n, oz, C.POINT_AMP)
        s = F.step_scalars(grid, 10, oz, C.POINT_AMP)
        label = family + ("" if viscous else " inviscid")
        out.append((family, label, st, co, s, (F.point_index(grid), s[4])))
    torch.cuda.synchronize()
    return out


def launchers(pkg, family, st, co, s, point, viscous):
    """name -> a call of ``pkg``'s wrapper for each instantiation."""
    if family == "fluid":
        mod = importlib.import_module(pkg + ".ops.fdtd_kernels")
        vel, stress = mod.fluid_velocity, mod.fluid_pressure
    else:
        mod = importlib.import_module(pkg + ".ops.fdtd_visco_kernels")
        vel, stress = mod.visco_velocity, mod.visco_stress
    calls = {
        "pressure": lambda: stress(st, co),
        "pressure+DFT": lambda: stress(st, co, s[2], s[3]),
    }
    if viscous:
        calls.update({
            "velocity": lambda: vel(st, co, s[0], s[1]),
            "point": lambda: stress(st, co, point=point),
            "point+DFT": lambda: stress(st, co, s[2], s[3], point),
        })
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (holds babelbrain_tpu_torch)")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_fdtd_kernels: no CUDA device")
    print(f"[ab] {C.nvidia_smi_line()}")

    from babelbrain_tpu_torch.ops import _build as this_build

    other = load_other(os.path.abspath(args.other))
    other_build = importlib.import_module("bbt_other.ops._build")
    this_build.library()
    other_build.library()
    ours, theirs = resources(this_build), resources(other_build)
    changed = []
    for name in sorted(set(ours) | set(theirs)):
        a, b = theirs.get(name), ours.get(name)
        print(f"[ab] {name}: other {a}; this {b}")
        if a is not None and b is not None and a != b:
            changed.append(name)

    result = {}
    for family, label, st, co, s, point in cases("cuda"):
        viscous = "inviscid" not in label
        calls = {pkg: launchers(pkg, family, st, co, s, point, viscous)
                 for pkg in ("bbt_other", "babelbrain_tpu_torch")}
        for name in calls["bbt_other"]:
            a = calls["bbt_other"][name]
            b = calls["babelbrain_tpu_torch"][name]
            t = [C._timed_graph(f, 20) for f in (a, b, b, a)]
            other_ms, this_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            key = f"{label} {name}"
            result[key] = dict(other_ms=other_ms, this_ms=this_ms,
                               ratio=this_ms / other_ms,
                               runs=[round(v, 6) for v in t])
            print(f"[ab] {key}: other {t[0]:.4f} / {t[3]:.4f} ms, this "
                  f"{t[1]:.4f} / {t[2]:.4f} ms, this / other "
                  f"{this_ms / other_ms:.4f}")
    worst = max(abs(np.log(r["ratio"])) for r in result.values())
    print(f"[ab] largest change {np.expm1(worst):.2%}")
    line = json.dumps({"device": torch.cuda.get_device_name(0),
                       "times": result})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if changed:
        raise SystemExit(f"ab_fdtd_kernels: resources differ: {changed}")


if __name__ == "__main__":
    main()
