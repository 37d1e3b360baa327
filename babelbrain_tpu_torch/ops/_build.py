"""Build the CUDA kernels of ``babelbrain_tpu_torch/csrc`` and load them.

The sources are compiled on first use with ``nvcc`` into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch headers
are compiled, so a build takes seconds). The library lands in
``babelbrain_tpu_torch/_build/``, named by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: only a call that needs a kernel on a CUDA
tensor builds or loads the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("fdtd_fluid.cu", "bhte.cu")
# --fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like the sequence of PyTorch elementwise ops in its plain version (the
# kernels are bound by device-memory traffic, not arithmetic)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build in this process (ptxas -v)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "bb_fluid_velocity": [_P] * 15 + [_F, _F, _F] + [_I] * 5 + [_P],
    "bb_fluid_pressure": [_P] * 18 + [_F] * 5 + [_I] * 6 + [_P],
    "bb_bhte_step": [_P] * 13 + [_F] + [_I] * 3 + [_P],
}


def find_nvcc() -> str | None:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
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
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(CSRC, s) for s in SOURCES)]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.time() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, path)
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
