"""Host-side native code (C++), loaded via ctypes: the BLOSC1/LZ4 codec and
the solid voxelizer.

The reference writes its HDF5 payloads BLOSC-compressed through
``H5pySimple`` (`InformationForDrivingSystems.md:12-16`); this codec lets the
port read files the reference produced and write files its driving systems
read, without a blosc plugin. ``voxelize.cpp`` is the OpenMP solid
voxelizer of ``ops.voxelize`` (a copy of the JAX package's), which keeps a
NumPy path beside it.

Each ``<name>.cpp`` is compiled with g++ on first use into the package's
``_build/`` directory (ignored by git) and cached there; an edited source is
rebuilt. Without g++ the first call raises, as the build cannot run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIBS: dict = {}


def _build_and_load(name: str):
    """Compile <name>.cpp -> _build/lib<name>.so (cached) and dlopen it."""
    src = os.path.join(_DIR, f"{name}.cpp")
    lib = os.path.join(_BUILD_DIR, f"lib{name}.so")
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        if (not os.path.exists(lib)) or os.path.getmtime(lib) < os.path.getmtime(src):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [
                "g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                "-std=c++17", src, "-o", tmp,
            ]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, lib)
        _LIBS[name] = ctypes.CDLL(lib)
        return _LIBS[name]


def native_available(name: str = "voxelize") -> bool:
    try:
        _build_and_load(name)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block (native)."""
    lib = _build_and_load("blosc")
    fn = lib.lz4_decompress_block
    fn.restype = ctypes.c_int64
    dst = ctypes.create_string_buffer(dst_size)
    n = fn(src, ctypes.c_int64(len(src)), dst, ctypes.c_int64(dst_size))
    if n != dst_size:
        raise ValueError(f"lz4 block decode failed ({n} != {dst_size})")
    return dst.raw


def _unshuffle(buf: bytes, typesize: int) -> bytes:
    lib = _build_and_load("blosc")
    fn = lib.blosc_unshuffle
    n = len(buf)
    dst = ctypes.create_string_buffer(n)
    fn(buf, dst, ctypes.c_int64(n), ctypes.c_int64(typesize))
    return dst.raw


def blosc_decompress(chunk: bytes) -> bytes:
    """Decompress a BLOSC1 chunk (HDF5 filter 32001, LZ4 codec).

    Handles the memcpy, shuffle, and split-stream block layouts of the
    BLOSC1 format.
    """
    if len(chunk) < 16:
        raise ValueError("short blosc chunk")
    flags, typesize = chunk[2], chunk[3]
    nbytes, blocksize, cbytes = np.frombuffer(chunk[4:16], "<u4")
    nbytes, blocksize = int(nbytes), int(blocksize)
    if len(chunk) < cbytes:
        raise ValueError("truncated blosc chunk")
    if flags & 0x2:  # memcpyed
        return chunk[16 : 16 + nbytes]
    codec = flags >> 5
    if codec != 1:  # 1 = LZ4/LZ4HC in the BLOSC1 flags byte
        raise ValueError(f"unsupported blosc codec {codec} (only LZ4)")
    shuffled = bool(flags & 0x1)
    if flags & 0x4:
        raise ValueError("bit-shuffle not supported")

    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = np.frombuffer(chunk[16 : 16 + 4 * nblocks], "<u4")
    out = bytearray(nbytes)

    def _read_streams(pos: int, nstreams: int, neblock: int) -> bytes | None:
        per = neblock // nstreams
        if per * nstreams != neblock:
            return None
        parts = []
        for _ in range(nstreams):
            if pos + 4 > len(chunk):
                return None
            (cb,) = np.frombuffer(chunk[pos : pos + 4], "<i4")
            pos += 4
            cb = int(cb)
            if cb < 0 or pos + abs(cb) > len(chunk):
                return None
            if cb == per:  # stored raw
                parts.append(chunk[pos : pos + per])
            else:
                try:
                    parts.append(lz4_decompress(chunk[pos : pos + cb], per))
                except ValueError:
                    return None
            pos += cb
        return b"".join(parts)

    for j in range(nblocks):
        neblock = min(blocksize, nbytes - j * blocksize)
        pos = int(bstarts[j])
        blk = None
        # BLOSC splits each block into `typesize` byte-plane streams for
        # small typesizes; the decision isn't in the header, so try the
        # split layout first and fall back to a single stream.
        if shuffled and typesize > 1:
            blk = _read_streams(pos, typesize, neblock)
        if blk is None:
            blk = _read_streams(pos, 1, neblock)
        if blk is None:
            raise ValueError(f"blosc block {j} decode failed")
        if shuffled and typesize > 1 and neblock % typesize == 0:
            blk = _unshuffle(blk, typesize)
        out[j * blocksize : j * blocksize + neblock] = blk
    return bytes(out)


def lz4_compress(src: bytes) -> bytes | None:
    """Compress one raw LZ4 block (native); None when incompressible."""
    lib = _build_and_load("blosc")
    fn = lib.lz4_compress_block
    fn.restype = ctypes.c_int64
    cap = len(src) - 1 if len(src) > 1 else 1
    dst = ctypes.create_string_buffer(max(cap, 1))
    n = fn(src, ctypes.c_int64(len(src)), dst, ctypes.c_int64(cap))
    if n < 0:
        return None
    return dst.raw[:n]


def _shuffle(buf: bytes, typesize: int) -> bytes:
    lib = _build_and_load("blosc")
    fn = lib.blosc_shuffle
    n = len(buf)
    dst = ctypes.create_string_buffer(n)
    fn(buf, dst, ctypes.c_int64(n), ctypes.c_int64(typesize))
    return dst.raw


def blosc_compress(data: bytes, typesize: int = 1,
                   blocksize: int = 1 << 17) -> bytes:
    """Build a BLOSC1 chunk (HDF5 filter 32001, LZ4 codec, byte shuffle).

    Counterpart of ``blosc_decompress``. Follows c-blosc 1.x layout rules:
    shuffle per block when divisible by the typesize, and split each
    shuffled block into ``typesize`` byte-plane streams when ``typesize <=
    16`` and the per-stream extent is >= 128 bytes (the decompressor infers
    the same split from the header, so the rule must match).
    """
    n = len(data)
    if typesize < 1 or typesize > 255:
        typesize = 1
    blocksize = max(typesize, (blocksize // typesize) * typesize)
    shuffle = typesize > 1
    flags = (1 << 5) | (0x1 if shuffle else 0)  # codec LZ4 + byte shuffle
    if n == 0:
        header = bytes([2, 1, flags, typesize]) + np.array(
            [0, blocksize, 16], "<u4"
        ).tobytes()
        return header
    nblocks = (n + blocksize - 1) // blocksize
    body = bytearray()
    bstarts = np.zeros(nblocks, "<u4")
    base = 16 + 4 * nblocks
    for j in range(nblocks):
        raw = data[j * blocksize : j * blocksize + blocksize]
        neblock = len(raw)
        do_shuffle = shuffle and neblock % typesize == 0
        if do_shuffle:
            raw = _shuffle(raw, typesize)
        split = (
            do_shuffle and typesize <= 16 and neblock // typesize >= 128
        )
        nstreams = typesize if split else 1
        per = neblock // nstreams
        bstarts[j] = base + len(body)
        for s in range(nstreams):
            part = raw[s * per : (s + 1) * per]
            comp = lz4_compress(part)
            if comp is None or len(comp) >= len(part):
                body += np.array([len(part)], "<i4").tobytes() + part
            else:
                body += np.array([len(comp)], "<i4").tobytes() + comp
    cbytes = base + len(body)
    header = bytes([2, 1, flags, typesize]) + np.array(
        [n, blocksize, cbytes], "<u4"
    ).tobytes()
    return header + bstarts.tobytes() + bytes(body)


def voxelize_solid_native(triangles_vox: np.ndarray, shape) -> np.ndarray:
    """Solid voxelization in voxel coordinates (see ops.voxelize for the
    public API). Raises if the native library cannot be built/loaded."""
    lib = _build_and_load("voxelize")
    fn = lib.voxelize_solid_native
    fn.restype = ctypes.c_int
    tri = np.ascontiguousarray(triangles_vox, np.float64)
    N1, N2, N3 = (int(s) for s in shape)
    out = np.zeros((N1, N2, N3), np.uint8)
    rc = fn(
        tri.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(tri.shape[0]),
        ctypes.c_int64(N1), ctypes.c_int64(N2), ctypes.c_int64(N3),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise MemoryError("native voxelizer allocation failed")
    return out.astype(bool)
