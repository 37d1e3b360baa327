#!/usr/bin/env python3
"""Where a march step of the visco lockstep sweep goes, on one CUDA GPU.

    python3 scripts/visco_sweep_probe.py [--shape N1 N2 N3] [--k K ...]

Builds ``scripts/visco_sweep_probe.cu`` (the skeleton of the visco sweep's
first design: its cooperative launch of 32x8 blocks, one cell a thread, K
stages 5 planes apart, every load through L2) with ``nvcc`` into
``babelbrain_tpu_torch/_build/`` and times, quiet and in the window
(viscous, 5 label materials, a plane source, the state
``chip_smoke.FUSED_PRE_STEPS`` pair steps leave), for each K:

* the launch with only its grid barriers (mode 0),
* the barriers and every load a cell-stage of that sweep issues, through
  L2 (mode 1),
* the port's own ``visco_fused`` (the whole step, whatever design the
  tree's ``csrc/fdtd_visco_fused.cu`` has),

each from a CUDA graph of 5 calls as ``chip_smoke._timed_graph`` times it,
a launch and a march step (the skeleton's march has N1 + 2 + 5 (K - 1)
steps).

    python3 scripts/visco_sweep_probe.py --variants [--k K ...]

times instead the tree's own sweep (``csrc/fdtd_visco_fused.cu``) against
variants of it built from copies of its source with one part taken out, so
that each difference is that part's share of a march step (their results
are wrong; only the times are read): "base" (the source as it is),
"nopsi" (no psi value copied), "noown" (no other own value copied, the
material index read as 0), "norings" (no ring copied), "nowork" (neither
half-step computed: the copies and the barriers), "cells1" (one cell a
thread: 32x12 threads on the same tile, 24 warps an SM) and
"cells1_nowork". Each at 192x192x240 (16-byte
copies) and 192x192x241 (4-byte copies, the same tiles); plane, viscous,
quiet. Each variant's SASS is summarised (instructions, local-memory
loads and stores) by ``cuobjdump``.

The card's name and power limit are printed first; the last line is a JSON
object of the times (ms).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from babelbrain_tpu_torch.ops import _build  # noqa: E402
from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK  # noqa: E402
from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF  # noqa
from babelbrain_tpu_torch.ops.fdtd_kernels import _ptr, _ptrs  # noqa: E402
from babelbrain_tpu_torch.ops.fdtd_visco_kernels import (  # noqa: E402
    MEMORIES,
    STRESSES,
)

SRC = os.path.join(ROOT, "scripts", "visco_sweep_probe.cu")


def build() -> ctypes.CDLL:
    """The probe's library, built with the port's nvcc flags."""
    out = os.path.join(_build.BUILD_DIR, "libbb_visco_probe.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", _build.CSRC, "-o", out, SRC], check=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bb_visco_probe.argtypes = ([I] + [P] * 5 + [I] + [P] * 5 + [I] * 7
                                   + [P, P])
    return lib


def probe(lib, mode, st, co, dft, k, sink):
    """One launch of the skeleton in ``mode`` on the state ``st``."""
    n1, n2, n3 = st.vx.shape
    rc = lib.bb_visco_probe(
        mode, _ptrs(st.fields(("vx", "vy", "vz"))),
        _ptrs(st.fields(STRESSES)), _ptrs(st.fields(MEMORIES)),
        _ptr(co.mat_idx), _ptr(co.table), co.table.shape[1],
        _ptr(st.acc_cos), _ptr(st.acc_sin), _ptr(st.peak), _ptrs(st.psi_s),
        _ptrs(st.psi_v), n1, n2, n3, st.psi_s[0].shape[0], int(co.viscous),
        int(dft), k, _ptr(sink), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bb_visco_probe mode {mode}: CUDA error {rc}")


KERNEL = os.path.join(_build.CSRC, "fdtd_visco_fused.cu")
# variant -> [(text of the source, its replacement)]
VARIANTS = {
    "base": [],
    "nopsi": [("    if (b[a].pos >= b[a].lo_end && b[a].pos < b[a].hi_start) "
               "continue;", "    continue;")],
    "noown": [("    if (VEC) {\n      constexpr int kChunks",
               "    if (false) {\n      constexpr int kChunks"),
              ("      if (!VEC) {\n        const auto cp",
               "      if (false) {\n        const auto cp"),
              ("reinterpret_cast<const int*>(S)[kIdxV * kBlockCells]", "0"),
              ("reinterpret_cast<const int*>(S)[kIdxS * kBlockCells]", "0")],
    "norings": [("if (more) issue_rings(t + 1);", "")],
    "nowork": [("if (i >= -kLead && i < g.n1 + kStressLag) {",
                "if (false) {")],
}
# one cell a thread: the same 32 x 12 tile and shared memory, 32x12 threads
# (24 warps an SM at two blocks, 80 registers a thread)
ONE_CELL = [("constexpr int kTY = 6;", "constexpr int kTY = 12;"),
            ("constexpr int kCells = 2;", "constexpr int kCells = 1;")]
VARIANTS["cells1"] = ONE_CELL
VARIANTS["cells1_nowork"] = ONE_CELL + VARIANTS["nowork"]


def build_variant(name: str) -> subprocess.Popen:
    """Start the build of a copy of the sweep's source with ``name``'s
    replacements (each must match once): its two copy widths' units in
    parallel, then the link."""
    with open(KERNEL) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} matches "
                               f"{src.count(old)} times")
        src = src.replace(old, new)
    d = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"visco_fused_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    nvcc = " ".join([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                     _build.CSRC])
    obj = [f"{path[:-3]}_{vec}.o" for vec in (0, 1)]
    script = (f"{nvcc} -DBB_VFUSED_VEC=0 -c -o {obj[0]} {path} & a=$!; "
              f"{nvcc} -DBB_VFUSED_VEC=1 -c -o {obj[1]} {path} & b=$!; "
              f"wait $a && wait $b && {_build.find_nvcc()} "
              f"{' '.join(_build.ARCH)} -shared -o {path[:-3]}.so "
              f"{obj[0]} {obj[1]}")
    return subprocess.Popen(["bash", "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


class _Routed:
    """The port's kernel library with the visco sweep's entry points taken
    from a variant's."""

    def __init__(self, main, variant):
        self.main, self.variant = main, variant

    def __getattr__(self, name):
        return getattr(self.variant if name.startswith("bb_visco_fused")
                       else self.main, name)


def sass_summary(so: str) -> dict:
    """{instantiation: (instructions, local loads, local stores)} of the
    sweep's kernels in a built library, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if "visco_fused_kernel" in name else None
            if name:
                res[name] = [0, 0, 0]
        elif name and line.strip().startswith("/*") and "*/" in line:
            text = line.split("*/", 1)[1]
            if not text.strip() or text.strip().startswith("/*"):
                continue
            res[name][0] += 1
            res[name][1] += " LDL" in text
            res[name][2] += " STL" in text
    return res


def variants(ks):
    """Time the tree's sweep and its variants (the module docstring)."""
    import ctypes as ct

    main_lib = _build.library()
    names = list(VARIANTS)
    procs = {n: build_variant(n) for n in names}
    libs = {}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n} failed:\n{log}")
        so = os.path.join(_build.BUILD_DIR, "variants", f"visco_fused_{n}.so")
        lib = ct.CDLL(so)
        for entry in ("bb_visco_fused", "bb_visco_fused_capacity",
                      "bb_visco_fused_tile"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ct.c_int
        libs[n] = lib
        summary = {k.split("visco_fused_kernel")[1][:40]: v
                   for k, v in sass_summary(so).items()
                   if "ILb1ELb0ELb0ELb1E" in k}
        print(f"[variant] {n}: SASS (instructions, LDL, STL) of the viscous "
              f"quiet plane whole-grid instantiations: {summary}")
    out = {}
    n1, n2, n3 = C.KERNEL_SHAPE
    for shape in ((n1, n2, n3), (n1, n2, n3 + 1)):
        st, co, rows, pt, _ = C._visco_fused_case(shape, max(ks), "plane",
                                                  False, "cuda")
        for n in names:
            _build._LIB = _Routed(main_lib, libs[n])
            FK._CAPACITY.clear()  # the variant's own occupancy
            VF._TILE_CHECKED.clear()
            VF.THREADS_Y, VF.CELLS = ((12, 1) if n.startswith("cells1")
                                      else (6, 2))
            for k in ks:
                ms = C._timed_graph(lambda: VF.visco_fused(
                    st, co, rows[:k], pt, checked=True), 5)
                march = VF.march_steps(shape[0], k)
                print(f"[variant] {n} {shape} K={k}: {ms:.4f} ms a launch, "
                      f"{ms / k:.4f} a step, {ms / march * 1e3:.3f} us a "
                      f"march step ({march})")
                out[f"{n} {shape} K{k}"] = ms
        _build._LIB = main_lib
        del st
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=C.KERNEL_SHAPE)
    ap.add_argument("--k", type=int, nargs="+", default=[2])
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("visco_sweep_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.variants:
        variants(args.k)
        return
    shape = tuple(args.shape)
    lib = build()
    out = {"shape": shape, "device": torch.cuda.get_device_name(0)}
    for dft in (False, True):
        st, co, rows, pt, _ = C._visco_fused_case(shape, max(args.k), "plane",
                                                  dft, "cuda")
        for k in args.k:
            sink = torch.zeros((k,) + shape[1:], device="cuda")
            march = shape[0] + 2 + 5 * (k - 1)
            t = {
                "barrier": C._timed_graph(
                    lambda: probe(lib, 0, st, co, dft, k, sink), 5),
                "barrier+loads": C._timed_graph(
                    lambda: probe(lib, 1, st, co, dft, k, sink), 5),
                "whole": C._timed_graph(lambda: VF.visco_fused(
                    st, co, rows[:k], pt, with_dft=dft, checked=True), 5),
            }
            phase = "window" if dft else "quiet"
            for name, ms in t.items():
                print(f"[probe] K={k} {phase} {name}: {ms:.4f} ms a launch, "
                      f"{ms / k:.4f} a step, {ms / march * 1e3:.3f} us a "
                      f"skeleton march step ({march})")
            out[f"K{k}_{phase}"] = t
    print(json.dumps(out))


if __name__ == "__main__":
    main()
