"""Build the CUDA kernels of ``babelbrain_tpu_torch/csrc`` and load them.

The sources are compiled on first use with ``nvcc``, one process per source,
all started together, and linked into one shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers are compiled,
so a build takes seconds). The library lands in ``babelbrain_tpu_torch/
_build/``, named by a hash of the sources, headers and flags, so an edited
source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: only a call that needs a kernel on a CUDA
tensor builds or loads the library. ``launch`` calls an entry point on the
device of the call's tensors, on that device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fdtd_fluid.cu", "fdtd_fluid_fused.cu", "fdtd_fluid_halo.cu",
           "fdtd_visco.cu", "fdtd_visco_fused.cu", "fdtd_visco_halo.cu",
           "fdtd_sources.cu", "bhte.cu", "fdtd_extras.cu", "probes.cu",
           "rayleigh.cu")
# the halo sweeps are compiled once per depth (-DBB_HALO_K=K,
# -DBB_VHALO_K=K) and the visco lockstep sweep once per copy width
# (-DBB_VFUSED_VEC=0, 1), each a translation unit of its own, so that they
# compile in parallel
HALO_DEPTHS = (1, 2, 3)
VISCO_HALO_DEPTHS = (1, 2)
DEPTH_UNITS = {"fdtd_fluid_halo.cu": ("BB_HALO_K", HALO_DEPTHS),
               "fdtd_visco_halo.cu": ("BB_VHALO_K", VISCO_HALO_DEPTHS),
               "fdtd_visco_fused.cu": ("BB_VFUSED_VEC", (0, 1))}
HEADERS = ("fdtd_stencil.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# --fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like the sequence of PyTorch elementwise ops in its plain version (the
# kernels are bound by device-memory traffic, not arithmetic)
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB = None
# nvcc's output of the build of the loaded library (ptxas -v), kept beside
# it, so a library an earlier process built reports it too
build_log = ""
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "bb_fluid_velocity": [_P] * 9 + [_F] * 3 + [_I] * 13 + [_P],
    "bb_fluid_pressure": [_P] * 10 + [_F] * 5 + [_I] * 10 + [_L, _F]
    + [_P] * 4 + [_I] * 6 + [_P],
    "bb_fluid_fused": [_P] * 16 + [_I] + [_F] * 3 + [_I] * 11 + [_L]
    + [_I] * 2 + [_P],
    "bb_fluid_fused_capacity": [_I] * 4 + [_P],
    "bb_fluid_fused_tile": [_P] * 4,
    "bb_visco_fused": [_P] * 16 + [_I] + [_F] * 3 + [_I] * 11 + [_L]
    + [_I] * 2 + [_P],
    "bb_visco_fused_capacity": [_I] * 4 + [_P],
    "bb_visco_fused_tile": [_P] * 4,
    "bb_bhte_step": [_P] * 13 + [_F] + [_I] * 3 + [_P],
    "bb_bhte_fused": [_P] * 13 + [_F] + [_I] * 8 + [_P],
    "bb_bhte_fused_tile": [_I, _P, _P],
    "bb_visco_velocity": [_P] * 10 + [_F] * 3 + [_I] * 13 + [_P],
    "bb_visco_stress": [_P] * 11 + [_F] * 5 + [_I] * 10 + [_L, _F]
    + [_P] * 4 + [_I] * 6 + [_P],
    "bb_velocity_volume_source": [_P] * 10 + [_F, _F, _I, _P],
    "bb_extras_accumulate": [_P, _P, _I, _I, _L, _P],
    **{f"bb_fluid_halo_k{k}": [_P] * 24 + [_I] + [_F] * 3 + [_I] * 14 + [_P]
       for k in HALO_DEPTHS},
    **{f"bb_fluid_halo_tile_k{k}": [_P] * 3 for k in HALO_DEPTHS},
    **{f"bb_fluid_halo_clusters_k{k}": [_P] for k in HALO_DEPTHS},
    **{f"bb_visco_halo_k{k}": [_P] * 14 + [_I] + [_F] * 3 + [_I] * 12 + [_P]
       for k in VISCO_HALO_DEPTHS},
    **{f"bb_visco_halo_tile_k{k}": [_P] * 3 for k in VISCO_HALO_DEPTHS},
    **{f"bb_visco_halo_clusters_k{k}": [_P] for k in VISCO_HALO_DEPTHS},
    "bb_stream": [_P, _P, _L, _P],
    "bb_fma_chain": [_P, _P, _P, _I, _I, _P],
    "bb_table_gather": [_P, _P, _P, _I, _I, _L, _I, _P],
    "bb_rayleigh": [_P] * 4 + [_F, _F, _L, _I, _P],
    "bb_rayleigh_grid": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_F, _F, _I, _P],
}


def find_nvcc() -> str | None:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    return path


def _units():
    """(source, extra nvcc flags, object name) of each translation unit."""
    for src in SOURCES:
        stem = os.path.splitext(src)[0]
        if src in DEPTH_UNITS:
            macro, depths = DEPTH_UNITS[src]
            for k in depths:
                yield src, (f"-D{macro}={k}",), f"{stem}_k{k}"
        else:
            yield src, (), stem


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(
        NVCC_FLAGS + tuple(f for _, flags, _ in _units() for f in flags)
    ).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use.

    Raises ``RuntimeError`` when ``nvcc`` is missing or the build fails.
    """
    global _LIB, build_log, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = os.path.join(BUILD_DIR, f"libbb_kernels_{_source_hash()}.so")
        if not os.path.isfile(path):
            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found: the CUDA kernels of babelbrain_tpu_torch "
                    "are built from csrc/ with the CUDA toolkit on first use"
                )
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.time()
            units = list(_units())
            objs = [f"{tmp}.{stem}.o" for _, _, stem in units]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj,
                     os.path.join(CSRC, src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for (src, flags, _), obj in zip(units, objs)
            ]
            logs = [proc.communicate()[0] for proc in procs]
            build_log = "".join(logs)
            failed = [(stem, proc.returncode)
                      for (_, _, stem), proc in zip(units, procs)
                      if proc.returncode != 0]
            if not failed:
                link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
                build_log += link.stdout + link.stderr
                if link.returncode != 0:
                    failed = [("link", link.returncode)]
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            build_seconds = time.time() - t0
            if failed:
                raise RuntimeError(f"nvcc failed {failed}:\n{build_log}")
            with open(f"{path}.log", "w") as f:
                f.write(build_log)
            os.replace(tmp, path)
        elif os.path.isfile(f"{path}.log"):
            with open(f"{path}.log") as f:
                build_log = f.read()
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA launch error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def launch(entry: str, kernel: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``device`` as its last argument, with ``device`` the current device
    (so the kernel launches there, on the device of its tensors); raise if
    the launch of ``kernel`` failed."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    check(rc, kernel)
