#!/usr/bin/env python3
"""On-card drive of the PyTorch/CUDA port (``babelbrain_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check exits nonzero):

1. probe   — torch/CUDA versions, the card, its power limit, and whether
             ``h5py`` / ``yaml`` import;
2. build   — the CUDA kernels of ``babelbrain_tpu_torch/csrc`` with nvcc
             (one process per source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card at
             main-path shapes, with times and bounds: the fluid FDTD
             kernels at 192x192x240 with the 1026-material CT table and the
             viscoelastic ones at the same shape with the label-mode
             materials, each 200 steps across the DFT window start, with a
             plane source, a stress point at the centre (the point
             variants) and a hemispherical shell of source voxels (the
             volumetric scatter, timed from a CUDA graph of its launches:
             it runs for a few microseconds, less than a call costs the
             host); the BHTE step, 500 steps; the diagnostics (all 14
             RMS / peak maps, and the pressure / stress kernels' MONITOR
             instantiations sampling 4096 seeded voxels every window step
             and every voxel for one step more, each timed against its
             plain twin with 201 and 4096 voxels and every voxel) on the
             fluid and visco plane-source states, and the MONITOR
             instantiations of both families at 27x45x47 with a plane, a
             point and a shell source; the probe kernels (stream over
             128 MB, the FMA chain,
             the CT table's gather over every voxel), and the
             viscoelastic pair again, bit for bit in every field, for 40
             steps on a ragged 27x45x47 grid (see ``RAGGED_SHAPE``), and
             the fluid pair there too (a plane with an air pocket, whose
             reflector twins double the table; without attenuation; a
             point), then at 192x192x240 with a 65539-material table (a
             16-bit HU quantisation, beyond what shared memory holds).
             Then the fused phase: ``fluid_fused`` (K steps a launch)
             against its plain version and against K launches of the
             pair, max abs difference 0 in every field, at 192x192x240
             and at 27x45x47, K = 1, 2, 3 and the deepest K the card
             holds there, plane and point, viscous and inviscid, quiet and
             window, and on a 50-plane shard with each x_lo / x_hi
             combination; each K timed per step against its bound and the
             pair. Before it the extras sweep (``check_fused_extras``):
             ``fluid_fused`` with B4's ``with_p2`` accumulator and the
             monitor capture (its EXTRAS instantiations) against its plain
             version and K steps of pair + extras + MONITOR, bit for bit in
             every field, both Pressure maps and the series, for every K
             the card admits at 192x192x240 (plane and point, viscous with
             4096 seeded voxels and inviscid with 201 on a line, some
             listed twice; maps only, the peak only, monitors only) and
             K = 1..4 at 27x45x47 with voxels on tile corners and the
             stages' hand-over planes; each K timed a launch and a step at
             192x192x240 and 216x216x224 against its bound and pair +
             extras + MONITOR (the figures behind ``EXTRAS_FUSE_BEST``).
             Then the visco fused phase: ``visco_fused`` against its
             plain version and K launches of the visco pair, bit for bit,
             at 192x192x240 with the 5 label materials for every K the card
             admits (plane and point, quiet and window), on the 50-plane
             shard with each x_lo / x_hi combination, and at 27x45x47 for
             K = 1..4 (a plane on a z-tile edge, a point on a tile corner,
             and inviscid: the 4-byte copies); each admitted K timed a
             step, quiet and window, at 192x192x240 and 216x216x224
             against the pair timed there (the figures behind
             ``VISCO_FUSE_BEST``), the kernel's registers, spills and
             shared memory printed. Then the halo sweep
             (``check_fused_volume``): ``fluid_halo`` (K steps a launch in
             thread-block clusters that recompute a 3K halo at their
             outer edge and share their inner edges through distributed
             shared memory, with the volumetric drive) against its plain
             version and K steps of pair + scatter, bit for bit, K = 1..3
             at 192x192x240 and at the dome's 392x392x337, viscous and
             inviscid, quiet and window, with a shell of source voxels; at
             27x45x47 with voxels on the clusters' corners, their inner
             edges and the halos' edges; on the 50-plane shard with each
             x_lo / x_hi pair; each K timed a launch and a step against
             its bound and pair + scatter (timed
             in the same run), with its cluster shape, the clusters active
             at once and its cells computed per cell owned. Then the visco
             halo sweep
             (``check_visco_volume``): ``visco_halo`` (the same design for
             the 15 visco fields) against its plain version and K steps
             of the visco pair + scatter, bit for bit, K = 1, 2 at
             192x192x240 and 392x392x337 with the 5 label materials and
             the shell, viscous and inviscid, quiet and window, and at
             27x45x47 with voxels on the clusters' corners, inner edges
             and halo edges; each K timed as the fluid one's at both
             shapes. Then the BHTE sweep:
             ``bhte_fused`` (K steps a launch) against its plain version
             and against K launches of
             ``bhte_step`` (and those against the plain version), max abs
             difference 0 in T, dose and peak, at 192x192x240 (heating,
             then cooling, across 43 C) for K = 1, 2, 3, 4, 8 and
             ``BHTE_FUSE_BEST``, at the slices' Step 3 frame 160x160x200
             for ``BHTE_FUSE_BEST``, at 27x45x47 for K = 1..8, with N1
             below K and with N2 and N3 below one tile; each K timed a
             launch and a step at 192x192x240 and 160x160x200 against its
             bound and ``bhte_step``.
             Every kernel is timed from a CUDA graph of captured calls:
             the card's own time, without the host's work per call. The
             plain versions of the FDTD, BHTE and stream rows, which run
             far longer than that work, are timed from back-to-back
             calls. Where one PyTorch call computes the same function it
             is timed beside them;
4. slices  — the main paths on a procedural digital head, each with every
             kernel count set to 0 just before and read just after: with
             the CTX_500 transducer at 500 kHz / 6 PPW, CT mode (Step 1 ->
             Rayleigh + fluid FDTD -> BHTE, Pichardo HU law) and label mode
             (no CT: tissue-label materials, Rayleigh + viscoelastic FDTD
             -> BHTE), each once plain and once refocused (backward FDTD
             from a stress point at the target, backward Rayleigh,
             refocused forward run); and the 1024-element DomeTx at
             220 kHz / 6 PPW at its 1 W drive, in CT mode (dome-ct:
             volumetric fluid FDTD over a 392x392x337 grid at 2250 of its
             6750 steps, forward Rayleigh, water pass, BHTE) and in label
             mode (dome-label: the same grid, the volumetric visco FDTD,
             at 2250 of its 4125 steps);
             and diag-ct / diag-label, the CT and label slices asking
             ``run_acoustic_sim`` for all 14 ``sel_maps`` and the pressure
             series along the beam axis through the target, after which
             diag-ct runs ``run_fdtd_capture`` on its inputs at a 5x5x5
             mask and over the full volume; and sensors-ct, the CT slice
             asking for the reference's own Step 2 selection (the
             Pressure RMS / peak maps and the beam-axis series), its
             window through the extras sweeps (pinned at the deepest K
             the card admits while ``EXTRAS_FUSE_BEST`` keeps such runs on
             the pair). Each runs through ``run_case``
             when h5py is installed (the diag and sensors slices always
             through the stage functions: ``run_case`` takes no
             ``sel_maps``), else
             through the stage functions ``run_case`` calls, in its order,
             writing no files. Every kernel's launch count must equal the
             step count the run implies, and no plain version may run.
             The diag slices' maps and series are held to the steady-state
             anchors and to each other, the capture to the series, bit for
             bit. The CT, label, sensors-ct, refocus-ct, refocus-label,
             zte-ct and coreg-zte slices' FDTD runs go through the fused
             sweeps
             (``run_fdtd``'s default: ``fluid_fused`` in CT mode,
             ``visco_fused`` in label mode; refocus-ct pinned at
             ``fused_depth``, refocus-label at ``visco_depth``, while a
             default keeps its family on the pair), the dome slices' volumetric
             passes through the halo sweeps (``fuse_steps`` pinned at
             ``DOME_PIN_K`` while the default keeps pair + scatter:
             ``fluid_halo`` in fluid media, dome-label's tissue pass in
             shear media through ``visco_halo``): each run is repeated
             through the pair (and the scatter; sensors-ct's with the
             maps' pass and the MONITOR samples) step by step and must
             equal it bit for bit, maps and series included. Every
             slice's Step 3 runs the BHTE
             sweeps (``bhte_run``'s default K on a card): each of its two
             ``bhte_run`` loops is run again from its start one step a
             launch (``fuse_steps=1``) and must equal it bit for bit in T,
             dose and peak, its monitors at the sampled steps; the
             launch counts are the sweeps and one-step tails of the
             sonication's schedules. After a refocus, dome or diag slice,
             the kernels and their plain versions run 40 steps across the
             window start on
             that slice's own domain and its stress point, volumetric or
             plane source (the diag slices with every map and monitor), and
             every field must agree bit for bit. After the CT and dome-ct
             slices the Rayleigh kernel (``rayleigh_kernel``: each slice's
             forward Rayleigh a launch of its grid form, every
             ``rayleigh_field`` call one of its point-list form) runs again
             with all the sources of that forward Rayleigh: the point-list
             form at 2^18 of its points, the grid form on a slab of whole
             x planes of about as many, both equal to the slice's values
             bit for bit and to each other, within 2e-5 of the peak of the
             plain version, held to float64 at 256 points and timed.
             zte-ct is the CT slice
             from a synthetic ZTE MRI of the head (the pseudo-CT stage,
             then Step 1's CT branch; its bone HU must lie in 300..2100).
             coreg-zte moves that MRI 6 deg and (4, -3, 2) mm off the head
             and registers it on the card to a 192^3 T1 at 1 mm
             (``coregister_to_t1``, NCC, levels 4, 2, 1) before the
             pseudo-CT: the transform must come within 1 deg and 1 voxel
             of the truth and pass the quality gate, the registration on
             the card and on the CPU must agree on the pair averaged to
             64^3, and Step 1's surface meshes are exported and counted
             (the CPU registration and the export in spawned processes
             beside the anchors and sweep-ct, joined before the mesh
             phase).
             After the slices, the golden phase (``run_golden``): the
             reference's digital head (``build_head`` of
             `tests/test_torch_digital_head.py`, loaded by path) in CT
             mode at the configuration of `tests/golden/digital_head_ct.npz`
             (HeadTest bowl, 500 kHz, 6 PPW, mask 84x84x192, no Step 3),
             through ``run_case`` (its HDF5 writes kept in memory where
             h5py is missing); peak within 1% and 1e-4, crop L2 below
             0.05 and 1e-3, focus within one grid step of the golden's,
             launch counts as a slice's.
             Last, sweep-ct (``run_sweep``, after the anchors below): two
             shape-bucketed targets 5 mm
             apart (one grid signature), each with a 3-entry thermal
             profile (the last entry's 30.01 s pause ends in a one-step
             tail; its Step 3 checked as the slices'), then multipoint steering of the first cell at +-5 mm
             through ``run_fdtd_batch``; its cases 0 and 1 must each equal
             ``run_fdtd`` of their plane bit for bit; the anchors: the
             shear anchor of `tests/test_shear_anchor.py` (normal and 25
             deg incidence through elastic slabs against the analytic
             layer transmission, 5%), the O'Neil water anchor of
             `tests/test_benchmark_anchor.py` (the inter-comparison's
             bowl driven through the port's Rayleigh, 5%), its
             benchmark-file skull slab through ``run_benchmark_acoustic``'s
             helper, the water and slab runs again on the
             inter-comparison's whole 70 x 70 x 120 mm domain (the water
             focus against O'Neil's), the CTX-500 calibration recovering
             known ring weights, and the CT slice's Step 1 in a spawned
             worker equal to the in-process one;
5. mesh    — the x decomposition on one card: ``make_mesh(4, devices=
             ["cuda:0"] * 4)`` named explicitly (``make_mesh(4)`` must
             refuse with fewer cards). The four FDTD kernels with their
             x-CPML edge ownership on 4 shards of 192x192x240 against
             their plain versions (plane, and a point on an inner shard;
             40 steps, bit for bit) and each shard's launch timed against
             the whole one; the overlap-and-discard fused sweeps against
             their plain versions and the unsharded run (fluid and
             visco); then the ``run_fdtd`` calls the CT and label (overlap
             and discard), diag-ct (14 maps, 201 monitors) and dome-ct
             slices made and the refocus slices' backward point runs
             (recorded as they ran) again on the 4-shard mesh, each equal
             to its slice's result bit for bit (dome-ct's at 450 of its
             2250 steps, against an unsharded run at that depth: its
             tissue pass as it ran, by overlap and discard through the
             halo sweep, its water pass with ``fuse_steps=1``, through
             pair + scatter with 2 ghost planes),
             with the loops' idle share
             under ``torch.profiler`` (CT, label); the CT slice's forward
             Rayleigh over 4 devices (within 2e-5 of its peak, the
             difference printed); sweep-ct's ``run_fdtd_batch`` on a
             2-device case mesh, bit-equal. Then its 2-D part (the
             (x, y) decomposition, ``make_mesh_2d(nx, ny, devices=
             ["cuda:0"] * (nx * ny))``): the four pair kernels' shards'
             instantiations on 192x192x240 cut (2, 4) and (1, 2), plane and
             a point on a y-interior shard, 40 steps against their plain
             versions bit for bit, each shard's launch timed; the label
             slice's run_fdtd on (4, 2), diag-ct's on (2, 2), refocus-ct's
             backward point run on (2, 4) and dome-ct's pair + scatter
             pass on (2, 2), each bit-equal to its slice's; the CT slice's
             ``run_acoustic_sim`` on (2, 4) at its own steps, its
             DataForSim maps bit-equal to the slice's; the CT loop's idle
             share. Counts are set to 0 before the replays: the FDTD rows
             must count the shards' launches. With more than one card,
             the CT run across cards and the peer-copy rate;
6. multiprocess — the CT slice's ``run_fdtd`` again in two worker
             processes of this script (``--mp-worker``), each holding two
             shards of cuda:0 of a 4-way x mesh laid out over a gloo
             process group, the ghost planes that cross the processes
             staged through pinned host memory; each worker's whole result
             must equal the slice's bit for bit, and rank 0 prints its loop
             and its host time a step in the cross-process exchange;
7. probes  — ``babelbrain_tpu_torch.probes.run_probes``: the card's stream
             rate, FP32 FMA rate and table-gather cost (P1, P2).

The last lines are the kernel table (JSON), the card's name and power limit
(``nvidia-smi``), and ``{"ok": true, "device": {...}}``. The script never
falls back to the CPU: without a CUDA device it exits with an error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import inspect
import json
import os
import pickle
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

F0 = 500e3
PPW = 6.0
KERNEL_SHAPE = (192, 192, 240)
FLUID_STEPS, FLUID_SENSOR_START = 200, 150
VISCO_STEPS, VISCO_SENSOR_START = 200, 150
BHTE_STEPS, BHTE_HEAT_STEPS = 500, 300
# the K-step BHTE check: steps a case at KERNEL_SHAPE (half heating, then
# cooling across 43 C; 8 K at the small grids), and the grids beside
# KERNEL_SHAPE and RAGGED_SHAPE: N1 below K, and N2 and N3 below one tile
BHTE_FUSED_STEPS = 24
BHTE_THIN, BHTE_NARROW = (5, 45, 47), (12, 5, 20)
# FDTD grid (216, 216, 224) after the transducer-cone fit: the order of the
# 192x192x240 benchmark grid
MASK_SHAPE = (160, 160, 200)
VOX = 2.0  # digital-head voxel size (mm)
# HU -> acoustic law of the slice. Under the default Webb-Marsac law this
# phantom's ~550 HU diploe maps to 438 Np/m at 500 kHz: the brain focus gets
# ~18 kPa through the vertex, the Isppa normalisation scales the field 31x
# and the skin passes 2000 C, so CEM43 overflows float32 (the JAX package's
# numerics do the same). Pichardo maps the diploe to 108 Np/m.
MAPPING = "Pichardo"
N_HEAD = 96
# published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 1: probe
# ---------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def probe() -> dict:
    props = torch.cuda.get_device_properties(0)
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[probe] device {props.name} sms {props.multi_processor_count} "
          f"memory {props.total_memory / 2**30:.1f} GiB "
          f"count {torch.cuda.device_count()}")
    print(f"[probe] nvidia-smi: {nvidia_smi_line()}")
    have = {m: importlib.util.find_spec(m) is not None for m in ("h5py", "yaml")}
    print(f"[probe] h5py {'yes' if have['h5py'] else 'MISSING'} "
          f"yaml {'yes' if have['yaml'] else 'MISSING'}")
    return have


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build():
    from babelbrain_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    print(f"[build] kernels ready in {time.time() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")
    lib = _build.library()
    gone = not hasattr(lib, "bb_monitor_gather") and (
        "monitor_gather_kernel" not in _build.build_log)
    print("[build] monitor_gather_kernel: "
          f"{'not in the build' if gone else 'BUILT'} (0 launches: the "
          "MONITOR instantiations of the pressure / stress kernels take the "
          "samples)")
    if not gone:
        fail("monitor_gather_kernel is still built")
    for name, res in fdtd_resources(_build.build_log):
        print(f"[build] {name}: {res['registers']} registers, "
              f"{res['spill']} bytes spilled (stores + loads), "
              f"{res['stack']} bytes stack, {res['smem']} bytes static shared "
              f"memory (+ the material table, dynamic)")


def fdtd_resources(log):
    """[(kernel<template arguments>, {registers, spill, stack, smem})] of
    the fluid, visco and Rayleigh kernels, from nvcc's ``-Xptxas -v``
    log."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(
                r"((?:visco|fluid)_[a-z_]+_kernel|rayleigh_kernel)"
                r"(I(?:L[ib]\d+E)+E)?",
                m.group(1))
            name = k and k.group(1) + (
                "<" + ", ".join(re.findall(r"L[ib](\d+)E", k.group(2))) + ">"
                if k.group(2) else "")
            if name:
                out.append((name, dict(registers=None, spill=0, stack=0,
                                       smem=0)))
            continue
        if name is None:
            continue
        res = out[-1][1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            res["stack"] = int(m.group(1))
            res["spill"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            res["smem"] = int(sm.group(1)) if sm else 0
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def ct_table(n_bone=1023):
    """CT-mode material table: water + skin + brain + ``n_bone``
    quantized-HU bone (1023: the benchmark's configuration)."""
    from babelbrain_tpu_torch.materials import map_hu_to_properties

    hu = np.linspace(300.0, 2100.0, n_bone)
    rho, sos, att = map_hu_to_properties(hu, F0, "Webb-Marsac")
    mats = np.zeros((n_bone + 3, 5))
    mats[0] = [1000.0, 1500.0, 0, 0, 0]
    mats[1] = [1116.0, 1537.0, 0, 2.99, 0]
    mats[2] = [1041.0, 1562.0, 0, 4.49, 0]
    mats[3:, 0] = rho
    mats[3:, 1] = sos
    mats[3:, 3] = att
    return mats


def ct_index_volume(shape, seed=0, n_mat=1026):
    """Skin slab, random quantized-HU bone slab, brain (seeded)."""
    n1, n2, n3 = shape
    z0 = n3 // 4
    idx = np.zeros(shape, np.int32)
    rng = np.random.default_rng(seed)
    idx[:, :, z0:z0 + 10] = 1
    idx[:, :, z0 + 10:z0 + 28] = rng.integers(3, n_mat, (n1, n2, 18))
    idx[:, :, z0 + 28:] = 2
    return idx


def _timed(fn, n, warm=2):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _timed_graph(fn, n):
    """ms of one ``fn()`` on the card alone: ``n`` calls captured in one CUDA
    graph and replayed, so the host's per-call work (argument checks, the
    ctypes call) is not in the time. Ten replays warm the card up first:
    after the plain versions' stretch of small launches two were too few
    (one 0.216 ms kernel read 0.255 ms)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _timed(graph.replay, 5, warm=10) / n


def _copy_state(st):
    """A copy of a fluid or visco state (every tensor and psi slab cloned)."""
    return type(st)(
        **{k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
           for k, v in vars(st).items()}
    )


def plain_step(st, co, grid, n, oz, pamp=0.0, vsrc=None, monitor=None):
    """Step ``n`` of ``ops.fdtd.fluid_step`` / ``visco_step`` (by the type of
    ``st``) through the plain versions, on whatever device ``st`` lies; with
    ``monitor`` (``ops.fdtd_extras.Monitor``) the sample after it."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_sources as S
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    velocity, stress = ((K.fluid_velocity_ref, K.fluid_pressure_ref)
                        if isinstance(st, K.FluidState)
                        else (V.visco_velocity_ref, V.visco_stress_ref))
    s_sin, s_cos, cosw, sinw, s_pt = F.step_scalars(grid, n, oz, pamp)
    velocity(st, co, s_sin, s_cos)
    if vsrc is not None:
        S.velocity_volume_source_ref(st.vx, st.vy, st.vz, vsrc, s_sin, s_cos)
    pt = F.point_index(grid)
    point = None if pt is None else (pt, s_pt)
    if n >= grid.sensor_start:
        stress(st, co, cosw, sinw, point, monitor)
    else:
        stress(st, co, point=point, monitor=monitor)


# Work of one launch, counted from the kernel code: float-sized volumes read
# plus written per cell (the int32 material index counts as one), CPML'd
# derivatives per axis (each reads and writes a lo and a hi psi slab of ns
# planes), (N1, N2) source planes read, and float operations per cell. The
# CPML profiles and the material table (a few hundred bytes to a few tens
# of KB) are left out. A point-source variant does the work of its
# plane-source twin (one cell more is a sub-byte change). The fluid rows
# are the viscous CT case: velocity p, index, 3 velocities read and
# written; pressure 3 velocities, index, p and r read, p and r written
# (+ 3 accumulators read and written in the window).
KERNEL_WORK = {
    "fluid_velocity": dict(volumes=8, derivs_per_axis=1, planes=3, flops=24),
    "fluid_pressure": dict(volumes=8, derivs_per_axis=1, planes=0, flops=27),
    "fluid_pressure_dft": dict(volumes=14, derivs_per_axis=1, planes=0,
                               flops=33),
    "bhte_step": dict(volumes=15, derivs_per_axis=0, planes=0, flops=30),
    "visco_velocity": dict(volumes=13, derivs_per_axis=3, planes=3, flops=60),
    "visco_stress": dict(volumes=28, derivs_per_axis=3, planes=0, flops=134),
    "visco_stress_dft": dict(volumes=34, derivs_per_axis=3, planes=0,
                             flops=143),
}
KERNEL_WORK.update({
    "fluid_pressure_point": KERNEL_WORK["fluid_pressure"],
    "fluid_pressure_point_dft": KERNEL_WORK["fluid_pressure_dft"],
    "visco_stress_point": KERNEL_WORK["visco_stress"],
    "visco_stress_point_dft": KERNEL_WORK["visco_stress_dft"],
})
# The volumetric source scatter, per source voxel: the int32 index and six
# floats read, three floats written (the voxels of a shell lie in runs along
# z, so neighbouring writes share sectors); 6 float operations.
SCATTER_BYTES_PER_SOURCE = 4 + 6 * 4 + 3 * 4
SCATTER_FLOPS_PER_SOURCE = 6
# seeded voxels the kernel phase samples with the MONITOR instantiations
MONITOR_POINTS = 4096


def roofline(nbytes, flops):
    """(least ms, "bytes" or "operations") of work that moves ``nbytes``
    and does ``flops`` float32 operations, on an H100 at its published
    peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The fused sweep of K steps (csrc/fdtd_fluid_fused.cu), per launch: p, vx,
# vy, vz, r and the index read once and p, vx, vy, vz, r written once (11
# volumes; + the DFT sums and the peak read and written in the window, 17);
# the psi slabs of both half-steps' derivatives read and written once; the
# three source planes read once; each step's float operations (the pair's).
# Nothing is recomputed (no halo): the K stages share one copy of the state.
FUSED_WORK = {
    "fluid_fused": dict(volumes=11, derivs_per_axis=2, planes=3,
                        flops_per_step=51),
    "fluid_fused_dft": dict(volumes=17, derivs_per_axis=2, planes=3,
                            flops_per_step=57),
}
FUSED_WORK.update({"fluid_fused_point": FUSED_WORK["fluid_fused"],
                   "fluid_fused_point_dft": FUSED_WORK["fluid_fused_dft"]})
# The extras sweep (the EXTRAS instantiations, always in the window): the
# window sweep's 17 volumes and the p^2 accumulator read and written once
# (19), and each step's operations plus p * p and its add (the monitor
# list and samples, a few KB, are added by check_fused_extras)
FUSED_WORK["fluid_fused_extras_dft"] = dict(volumes=19, derivs_per_axis=2,
                                            planes=3, flops_per_step=59)
FUSED_WORK["fluid_fused_point_extras_dft"] = FUSED_WORK[
    "fluid_fused_extras_dft"]
# The visco sweep of K steps (csrc/fdtd_visco_fused.cu), per launch: the 15
# fields (v, sigma, r) and the index read once and the 15 fields written
# once (31 volumes; + the DFT sums and the peak read and written in the
# window, 37); the psi slabs of both half-steps' 18 derivatives (6 an axis)
# read and written once; the three source planes read once; each step's
# float operations (the pair's: 60 + 134, 60 + 143 with the DFT).
FUSED_WORK.update({
    "visco_fused": dict(volumes=31, derivs_per_axis=6, planes=3,
                        flops_per_step=194),
    "visco_fused_dft": dict(volumes=37, derivs_per_axis=6, planes=3,
                            flops_per_step=203),
})
FUSED_WORK.update({"visco_fused_point": FUSED_WORK["visco_fused"],
                   "visco_fused_point_dft": FUSED_WORK["visco_fused_dft"]})
# The halo sweep of K steps (csrc/fdtd_fluid_halo.cu), per launch: p, vx,
# vy, vz, r and the index read once and p, vx, vy, vz, r written once (11
# volumes; + the DFT sums and the peak read and written in the window, 17);
# the psi slabs of both half-steps read and written once (the scratch slabs
# of the steps in between are written and read again, from L2 mostly, not
# counted); the three source planes read once; each step's float
# operations (the pair's). With a volumetric drive (``work``'s
# "fluid_halo_volume" rows) also the int32 slot volume (12 volumes, 18)
# and each source voxel's six floats read once, and the scatter's 6
# operations a voxel a step. The halo a cluster recomputes is read again
# from L2, not counted.
FUSED_WORK.update({"fluid_halo": FUSED_WORK["fluid_fused"],
                   "fluid_halo_dft": FUSED_WORK["fluid_fused_dft"]})
# The visco halo sweep of K steps (csrc/fdtd_visco_halo.cu), per launch: as
# the visco sweep (the 15 fields and the index read once, the 15 fields
# written once: 31 volumes, 37 in the window; the psi slabs; the source
# planes; the pair's operations a step), and with its volumetric drive
# (``work``'s "visco_halo_volume" rows) the slot volume (32 volumes, 38)
# and each source voxel's six floats read once, and the scatter's 6
# operations a voxel a step. The scratch psi slabs of the steps in between
# are written and read again (L2 mostly), and the halo a cluster recomputes
# read again: neither is counted.
FUSED_WORK.update({"visco_halo": FUSED_WORK["visco_fused"],
                   "visco_halo_dft": FUSED_WORK["visco_fused_dft"]})
# The BHTE sweep of K steps (csrc/bhte.cu bhte_fused_kernel), per launch:
# T read and written, dose and peak read and written, the six
# conductivities, irc, perf and Q read once (15 volumes, whatever K; the
# halo a block recomputes is read again from L2, not counted); each step's
# float operations (the one-step kernel's).
FUSED_WORK["bhte_fused"] = dict(volumes=15, derivs_per_axis=0, planes=0,
                                flops_per_step=30)


def work(name, shape, ns=14, n_src=0, k=1):
    """(bytes, float32 operations) of one launch of ``name`` at ``shape``
    (with ``n_src`` source voxels for the volumetric scatter, ``k`` steps a
    launch for the fused sweep): each input read once and each output
    written once."""
    if name.startswith(("fluid_halo_volume", "visco_halo_volume")):
        b, f = work(name.replace("_volume", ""), shape, ns, k=k)
        return (b + 4.0 * float(np.prod(shape)) + n_src * 6 * 4,
                f + k * n_src * SCATTER_FLOPS_PER_SOURCE)
    if name in FUSED_WORK:
        w = FUSED_WORK[name]
        w = dict(w, flops=w["flops_per_step"] * k)
    elif name == "volume_source":
        return (n_src * SCATTER_BYTES_PER_SOURCE,
                n_src * SCATTER_FLOPS_PER_SOURCE)
    else:
        w = KERNEL_WORK[name]
    n1, n2, n3 = shape
    cells = n1 * n2 * n3
    slab_cells = ns * (n2 * n3 + n1 * n3 + n1 * n2)  # one slab per axis
    floats = (w["volumes"] * cells + w["derivs_per_axis"] * 2 * 2 * slab_cells
              + w["planes"] * n1 * n2)
    return 4.0 * floats, float(w["flops"]) * cells


def bound(name, shape, ns=14, n_src=0, k=1):
    """(least ms, "bytes" or "operations") of one launch of ``name`` at
    ``shape`` on an H100 at its published peaks: its ``work`` over the HBM
    rate, against its float32 operations over the float32 peak."""
    return roofline(*work(name, shape, ns, n_src, k))


def shell_source(shape):
    """The hemispherical dome shell of `tests/test_fused_kernel.py:311-323`
    (radii 14-16 of a 48-cell grid, below the centre, random phases from
    seed 4, inward normals) scaled to ``shape``: the dense dict
    ``run_fdtd(volume_source=...)`` takes."""
    c = [n / 2.0 for n in shape]
    k = min(shape) / 48.0
    ii, jj, kk = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in shape),
                             indexing="ij")
    r = np.sqrt((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2)
    shell = (r > 14 * k) & (r < 16 * k) & (kk < c[2])
    rr = np.maximum(r, 1e-6)
    rng = np.random.default_rng(4)
    return dict(amp=np.where(shell, 60e3, 0.0).astype(np.float32),
                phase=(rng.uniform(-2, 2, shape) * shell).astype(np.float32),
                ox=(c[0] - ii) / rr, oy=(c[1] - jj) / rr, oz=(c[2] - kk) / rr)


# the kernel-phase sources: ("plane" | "point" | "volume") -> source type;
# the point sits at the grid centre with this amplitude (Pa)
SOURCE_TYPES = {"plane": "velocity_plane", "point": "stress_point",
                "volume": "velocity_volume"}
POINT_AMP = 60e3


def _sources(shape, source, device):
    """(point amplitude, VolumeSource or None) of a kernel-phase run."""
    vsrc = shell_vsrc(shape, device) if source == "volume" else None
    return (POINT_AMP if source == "point" else 0.0), vsrc


def fluid_case(shape, n_steps, sensor_start, source, device, zsrc=13,
               source_ijk=None, n_bone=1023, reflector=False, viscous=True):
    """(grid, coefficients, point amplitude, volume source, oz) of the
    kernel phase's fluid runs: the CT table (water, skin, brain and
    ``n_bone`` quantized-HU bones; inviscid unless ``viscous``), with an
    air pocket in the bone (reflector twins) if ``reflector``, and a
    ``source`` drive (the plane at ``zsrc``, the point at ``source_ijk``,
    by default the centre)."""
    from babelbrain_tpu_torch.ops import fdtd as F

    mats = ct_table(n_bone)
    if not viscous:
        mats[:, 3:] = 0.0
    cmax = mats[:, 1].max()
    dx = 1482.3 / F0 / PPW
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, cfl=0.5)))
    dt = 1 / F0 / ppp
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=n_steps,
                      frequency=F0, sensor_start=sensor_start,
                      source_plane_z=zsrc, source_type=SOURCE_TYPES[source],
                      source_ijk=source_ijk or tuple(n // 2 for n in shape))
    coefs = F.sls_coefficients(mats, F0, dt)
    idx = ct_index_volume(shape, n_mat=len(mats))
    refl = None
    if reflector:  # a cube of air in the middle of the bone slab
        refl = np.zeros(shape, bool)
        z = shape[2] // 4 + 19
        c = [n // 2 for n in shape[:2]]
        refl[c[0] - 4:c[0] + 4, c[1] - 4:c[1] + 4, z - 3:z + 3] = True
    mi, table = F._build_indexed_materials(coefs, idx, refl)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, cmax, 1e-5)
    amp = np.zeros(shape[:2])
    m = max(2, shape[0] // 12)  # 16 cells at the benchmark shape
    if source == "plane":
        amp[m:-m, m:-m] = 60e3
    ph = np.random.default_rng(1).uniform(-1.0, 1.0, shape[:2])
    co = F.make_fluid_coeffs(mi, table, prof, amp, ph, grid, coefs["viscous"],
                             device)
    pamp, vsrc = _sources(shape, source, device)
    return grid, co, pamp, vsrc, 1.0 / (1000.0 * 1500.0)


def check_fluid(shape=KERNEL_SHAPE, n_steps=FLUID_STEPS,
                sensor_start=FLUID_SENSOR_START, device="cuda",
                source="plane"):
    """The fluid kernels against their plain versions over ``n_steps``
    steps with a ``source`` ("plane", "point" or "volume") drive; returns
    (errors, times) keyed by kernel row."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_sources as S

    grid, co, pamp, vsrc, oz = fluid_case(shape, n_steps, sensor_start,
                                          source, device)
    pt = F.point_index(grid)
    st_k = K.FluidState.zeros(shape, 14, device)
    st_p = K.FluidState.zeros(shape, 14, device)
    for n in range(n_steps):
        F.fluid_step(st_k, co, grid, n, oz, pamp, vsrc)
        plain_step(st_p, co, grid, n, oz, pamp, vsrc)
    if device == "cuda":
        torch.cuda.synchronize()
    pmax = float(st_p.p.abs().max())
    if not np.isfinite(pmax) or pmax <= 0:
        fail(f"fluid plain run ({source} source) has max|p| = {pmax}")
    # every field and psi slab against the plain state, bit for bit (the
    # kernels are built with --fmad=false in the plain versions' operation
    # order); the rows this source exercises: (velocity, pressure,
    # pressure + DFT) and the fields each writes
    diff = {}
    for name, e in state_diff(st_k, st_p):
        diff[name] = max(diff.get(name, 0.0), e)
    groups = (("vx", "vy", "vz", "psi_p"), ("p", "r", "psi_v"),
              ("acc_cos", "acc_sin", "peak"))
    errs_of = [max([diff.get(f, 0.0) for f in fields]) for fields in groups]
    velocity_err, pressure_err, dft_err = errs_of
    rows = {
        "plane": ("fluid_velocity", "fluid_pressure", "fluid_pressure_dft"),
        "point": (None, "fluid_pressure_point", "fluid_pressure_point_dft"),
        "volume": ("volume_source", None, None),
    }[source]
    errs = {k: e for k, e in zip(rows, errs_of) if k is not None}
    extra = f", {vsrc.n_src} source voxels" if vsrc is not None else ""
    print(f"[kernels] fluid {shape} {n_steps} steps (window from "
          f"{sensor_start}), {source} source{extra}: max|p| {pmax:.6g} Pa, "
          f"tolerance 0 (bit for bit, every field and psi slab)")
    print(f"[kernels]   velocity / pressure / DFT fields: max abs diff vs "
          f"plain {velocity_err:.6g} / {pressure_err:.6g} / {dft_err:.6g}")
    if diff:
        fail(f"fluid kernels ({source} source) differ from the plain "
             f"version (field, max abs diff): {sorted(diff.items())}")
    times = {}
    if device == "cuda":
        s = F.step_scalars(grid, 10, oz, pamp)
        point = None if pt is None else (pt, s[4])
        work = _copy_state(st_k)
        if source == "plane":
            times["fluid_velocity"] = (
                _timed_graph(lambda: K.fluid_velocity(work, co, s[0], s[1]),
                             20),
                _timed(lambda: K.fluid_velocity_ref(work, co, s[0], s[1]), 5),
            )
        if source in ("plane", "point"):
            q, d = rows[1:]
            times[q] = (
                _timed_graph(lambda: K.fluid_pressure(work, co, point=point),
                             20),
                _timed(lambda: K.fluid_pressure_ref(work, co, point=point), 5),
            )
            times[d] = (
                _timed_graph(lambda: K.fluid_pressure(work, co, s[2], s[3],
                                                      point), 20),
                _timed(lambda: K.fluid_pressure_ref(work, co, s[2], s[3],
                                                    point), 5),
            )
        else:
            # a launch of a few microseconds: the time of back-to-back
            # calls is the host's, so the card's own time comes from a graph
            v = (work.vx, work.vy, work.vz)

            def kern():
                S.velocity_volume_source(*v, vsrc, s[0], s[1])

            def ref():
                S.velocity_volume_source_ref(*v, vsrc, s[0], s[1])

            times["volume_source"] = (_timed_graph(kern, 50),
                                      _timed_graph(ref, 50))
            print(f"[kernels]   volume_source, back-to-back calls timed on "
                  f"the host's launches: kernel {_timed(kern, 50):.4f} ms, "
                  f"plain {_timed(ref, 10):.4f} ms")
        for name, (tk, tp) in times.items():
            print(f"[kernels]   {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms")
        if source == "plane":
            cells = float(np.prod(shape))
            step_k = times["fluid_velocity"][0] + times["fluid_pressure"][0]
            step_p = times["fluid_velocity"][1] + times["fluid_pressure"][1]
            print(f"[kernels] fluid quiet step: kernel {step_k:.4f} ms/step "
                  f"({cells / step_k / 1e3:.1f} Mcell-updates/s), plain "
                  f"{step_p:.4f} ms/step ({cells / step_p / 1e3:.1f} "
                  f"Mcell-updates/s)")
    return errs, times


def label_index_volume(shape):
    """Label-mode material layers along z: water, skin, then a skull of
    cortical / trabecular / cortical bone, then brain (the layering of the
    skull_slab_visco regression configuration, at this grid's scale)."""
    z0 = shape[2] // 4
    idx = np.zeros(shape, np.uint8)
    for label, width in ((1, 8), (2, 6), (3, 10), (2, 6)):
        idx[:, :, z0:z0 + width] = label
        z0 += width
    idx[:, :, z0:] = 4
    return idx


def visco_case(shape, n_steps, sensor_start, source, device, zsrc=13,
               source_ijk=None):
    """(grid, coefficients, point amplitude, volume source, oz, number of
    materials) of the kernel phase's viscoelastic runs: the label-mode
    materials in layers and a ``source`` drive (the plane at ``zsrc``, the
    point at ``source_ijk``, by default the centre)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.pipeline.domain import (
        build_label_materials,
        compute_time_stepping,
    )

    mats = build_label_materials(F0, False)
    dx, dt, _, _ = compute_time_stepping(mats, F0, PPW)
    cmax = max(mats[:, 1].max(), mats[:, 2].max())
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=n_steps,
                      frequency=F0, sensor_start=sensor_start,
                      source_plane_z=zsrc, source_type=SOURCE_TYPES[source],
                      source_ijk=source_ijk or tuple(n // 2 for n in shape))
    coefs = F.sls_coefficients(mats, F0, dt)
    idx, table = F._build_indexed_materials(coefs, label_index_volume(shape),
                                            None)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, cmax, 1e-5)
    amp = np.zeros(shape[:2])
    m = max(2, shape[0] // 12)
    if source == "plane":
        amp[m:-m, m:-m] = 60e3
    ph = np.random.default_rng(1).uniform(-1.0, 1.0, shape[:2])
    co = F.make_visco_coeffs(idx, table, prof, amp, ph, grid,
                             coefs["viscous"], device)
    pamp, vsrc = _sources(shape, source, device)
    return (grid, co, pamp, vsrc, 1.0 / (mats[0, 0] * mats[0, 1]),
            table.shape[1])


def check_visco(shape=KERNEL_SHAPE, n_steps=VISCO_STEPS,
                sensor_start=VISCO_SENSOR_START, device="cuda",
                source="plane"):
    """The viscoelastic kernels against their plain versions over
    ``n_steps`` steps with a ``source`` ("plane", "point" or "volume")
    drive; returns (errors, times) keyed by kernel row."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    grid, co, pamp, vsrc, oz, n_mats = visco_case(shape, n_steps,
                                                  sensor_start, source, device)
    pt = F.point_index(grid)
    st_k = V.ViscoState.zeros(shape, 14, device)
    st_p = V.ViscoState.zeros(shape, 14, device)
    for n in range(n_steps):
        F.visco_step(st_k, co, grid, n, oz, pamp, vsrc)
        plain_step(st_p, co, grid, n, oz, pamp, vsrc)
    if device == "cuda":
        torch.cuda.synchronize()
    # every field against the plain state, at 1e-4 of the field's own
    # maximum (the kernels are expected to be bit-equal: --fmad=false and
    # the plain versions' operation order); the rows this source exercises
    velocity = ("vx", "vy", "vz", "psi_s")
    stress = V.STRESSES + V.MEMORIES + ("psi_v",)
    dft = ("acc_cos", "acc_sin", "peak")
    groups = {
        "plane": {"visco_velocity": velocity, "visco_stress": stress,
                  "visco_stress_dft": dft},
        "point": {"visco_stress_point": stress,
                  "visco_stress_point_dft": dft},
        "volume": {"volume_source": velocity},
    }[source]
    errs, bad = {}, []
    for kname, fields in groups.items():
        errs[kname] = 0.0
        for f in fields:
            a, b = getattr(st_k, f), getattr(st_p, f)
            pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
            for x, y in pairs:
                e = float((x - y).abs().max())
                scale = float(y.abs().max())
                if not np.isfinite(scale) or e > 1e-4 * scale:
                    bad.append((f, e, scale))
                errs[kname] = max(errs[kname], e)
    pmax = float(st_p.peak.max())
    extra = f", {vsrc.n_src} source voxels" if vsrc is not None else ""
    print(f"[kernels] visco {shape} {n_steps} steps (window from "
          f"{sensor_start}), {n_mats} label materials, {source} "
          f"source{extra}: peak |p| {pmax:.6g} Pa, max|sxx| "
          f"{float(st_p.sxx.abs().max()):.6g} Pa, max|vz| "
          f"{float(st_p.vz.abs().max()):.6g} m/s")
    for name, e in errs.items():
        print(f"[kernels]   {name}: max abs diff vs plain {e:.6g}")
    if not np.isfinite(pmax) or pmax <= 0:
        fail(f"visco plain run ({source} source) has peak |p| = {pmax}")
    if bad:
        fail(f"visco kernels ({source} source) disagree with the plain "
             f"version (field, max abs diff, max |plain|): {bad}")

    times = {}
    if device == "cuda" and source != "volume":
        s = F.step_scalars(grid, 10, oz, pamp)
        point = None if pt is None else (pt, s[4])
        work = _copy_state(st_k)
        if source == "plane":
            times["visco_velocity"] = (
                _timed_graph(lambda: V.visco_velocity(work, co, s[0], s[1]),
                             20),
                _timed(lambda: V.visco_velocity_ref(work, co, s[0], s[1]), 5),
            )
        q, d = list(groups)[-2:]
        times[q] = (
            _timed_graph(lambda: V.visco_stress(work, co, point=point), 20),
            _timed(lambda: V.visco_stress_ref(work, co, point=point), 5),
        )
        times[d] = (
            _timed_graph(lambda: V.visco_stress(work, co, s[2], s[3], point),
                         20),
            _timed(lambda: V.visco_stress_ref(work, co, s[2], s[3], point), 5),
        )
        for name, (tk, tp) in times.items():
            print(f"[kernels]   {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms")
        if source == "plane":
            cells = float(np.prod(shape))
            step_k = times["visco_velocity"][0] + times["visco_stress"][0]
            step_p = times["visco_velocity"][1] + times["visco_stress"][1]
            print(f"[kernels] visco quiet step: kernel {step_k:.4f} ms/step "
                  f"({cells / step_k / 1e3:.1f} Mcell-updates/s), plain "
                  f"{step_p:.4f} ms/step ({cells / step_p / 1e3:.1f} "
                  f"Mcell-updates/s)")
    return errs, times


# A ragged grid for the visco kernels' tiling: N3 not a multiple of the
# 32-wide z-tile, N2 not one of the y-tile, N1 < 2 ns (the lo and hi x-CPML
# slabs overlap inside a segment); RAGGED_STEPS steps across the window start
RAGGED_SHAPE = (27, 45, 47)
RAGGED_STEPS, RAGGED_SENSOR_START = 40, 20


def state_diff(st_k, st_p):
    """(field, max abs diff) of every tensor and psi slab of two fluid or
    visco states that differ bit for bit."""
    bad = []
    for name, a in vars(st_k).items():
        b = getattr(st_p, name)
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            e = _equal(x, y)
            if e:
                bad.append((name, e))
    return bad


def check_visco_ragged(device="cuda"):
    """The visco kernels against their plain versions at ``RAGGED_SHAPE``,
    bit for bit in every field: a plane source at z = 32 (a z-tile edge),
    then a stress point on a (y, z) tile corner at the first plane of the
    second x-segment. Returns the difference (0) keyed by kernel row."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    geo = V.visco_launch_geometry(RAGGED_SHAPE)
    corner = (geo.segment, geo.tile_y, K.TILE_Z)
    rows = {"plane": ("visco_velocity", "visco_stress", "visco_stress_dft"),
            "point": ("visco_stress_point", "visco_stress_point_dft")}
    errs = {}
    for source, names in rows.items():
        grid, co, pamp, _, oz, _ = visco_case(
            RAGGED_SHAPE, RAGGED_STEPS, RAGGED_SENSOR_START, source, device,
            zsrc=K.TILE_Z, source_ijk=corner)
        st_k = V.ViscoState.zeros(RAGGED_SHAPE, 14, device)
        st_p = V.ViscoState.zeros(RAGGED_SHAPE, 14, device)
        for n in range(RAGGED_STEPS):
            F.visco_step(st_k, co, grid, n, oz, pamp)
            plain_step(st_p, co, grid, n, oz, pamp)
        if device == "cuda":
            torch.cuda.synchronize()
        bad = state_diff(st_k, st_p)
        peak = float(st_p.peak.max())
        what = (f"stress point at {corner}" if source == "point"
                else f"plane source at z = {K.TILE_Z}")
        print(f"[kernels] visco {RAGGED_SHAPE} (launch {geo}), {what}, "
              f"{RAGGED_STEPS} steps (window from {RAGGED_SENSOR_START}): "
              f"peak |p| {peak:.6g} Pa; fields differing from plain {bad}")
        if bad or not np.isfinite(peak) or peak <= 0:
            fail(f"visco kernels at {RAGGED_SHAPE} ({source} source) differ "
                 f"from their plain versions: {bad}; peak {peak}")
        errs.update(dict.fromkeys(names, 0.0))
    return errs, {}


def _fluid_bit_for_bit(tag, grid, co, pamp, oz, device):
    """``grid.n_steps`` steps of the fluid kernels and of their plain
    versions from zero fields; fails unless every field and psi slab is
    equal bit for bit. Returns (the plain run's peak |p|, the kernels'
    state)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    st_k = K.FluidState.zeros(grid.shape, 14, device)
    st_p = K.FluidState.zeros(grid.shape, 14, device)
    for n in range(grid.n_steps):
        F.fluid_step(st_k, co, grid, n, oz, pamp)
        plain_step(st_p, co, grid, n, oz, pamp)
    if device == "cuda":
        torch.cuda.synchronize()
    bad = state_diff(st_k, st_p)
    peak = float(st_p.peak.max())
    if bad or not np.isfinite(peak) or peak <= 0:
        fail(f"fluid kernels, {tag}: fields differ from their plain "
             f"versions: {bad}; peak {peak}")
    return peak, st_k


def check_fluid_ragged(device="cuda"):
    """The fluid kernels against their plain versions at ``RAGGED_SHAPE``,
    bit for bit in every field: the CT table with an air pocket (reflector
    twins) and a plane source at z = 32 (a z-tile edge); the same without
    attenuation (the inviscid pressure kernel); a stress point on a (y, z)
    tile corner at the first plane of the second x-segment. Returns the
    difference (0) keyed by kernel row."""
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    geo = K.fluid_launch_geometry(RAGGED_SHAPE)
    corner = (geo.segment, geo.tile_y, K.TILE_Z)
    runs = {
        "plane, reflector twins": (
            "plane", dict(reflector=True),
            ("fluid_velocity", "fluid_pressure", "fluid_pressure_dft")),
        "plane, inviscid": ("plane", dict(viscous=False), ()),
        "point": ("point", {}, ("fluid_pressure_point",
                                "fluid_pressure_point_dft")),
    }
    errs = {}
    for what, (source, kw, names) in runs.items():
        grid, co, pamp, _, oz = fluid_case(
            RAGGED_SHAPE, RAGGED_STEPS, RAGGED_SENSOR_START, source, device,
            zsrc=K.TILE_Z, source_ijk=corner, **kw)
        peak, st = _fluid_bit_for_bit(f"{RAGGED_SHAPE} {what}", grid, co,
                                      pamp, oz, device)
        n_mat = co.table.shape[1]
        where = (f"stress point at {corner}" if source == "point"
                 else f"plane source at z = {K.TILE_Z}")
        air = ""
        if kw.get("reflector"):
            twins = co.mat_idx >= n_mat // 2
            air = (f", {int(twins.sum())} air voxels (max|p| there "
                   f"{float(st.p[twins].abs().max()):.6g})")
            if not twins.any() or float(st.p[twins].abs().max()) != 0.0:
                fail(f"fluid {RAGGED_SHAPE}: the air pocket is empty or "
                     "carries pressure")
        print(f"[kernels] fluid {RAGGED_SHAPE} (launch {geo}), {what}, "
              f"{where}, {n_mat} materials{air}, viscous {co.viscous}, "
              f"{RAGGED_STEPS} steps (window from {RAGGED_SENSOR_START}): "
              f"peak |p| {peak:.6g} Pa; every field bit-equal to plain")
        errs.update(dict.fromkeys(names, 0.0))
    return errs, {}


# the material count of a 16-bit HU quantisation (65536 bone levels + water,
# skin and brain): a 1.5 MB table, whose rows exceed the 227 KB of shared
# memory a block may hold on an H100 (the fluid kernels gather every table
# through __ldg)
LARGE_BONES = 65536
LARGE_STEPS, LARGE_SENSOR_START = 40, 20


def check_fluid_large_table(device="cuda"):
    """The fluid kernels at ``KERNEL_SHAPE`` with the 16-bit table (indices
    above 65535), bit for bit against the plain versions over 40 steps
    across the window start; their times with it (beside those of
    ``check_fluid`` with the 1026-material table)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    grid, co, pamp, _, oz = fluid_case(KERNEL_SHAPE, LARGE_STEPS,
                                       LARGE_SENSOR_START, "plane", device,
                                       n_bone=LARGE_BONES)
    n_mat = co.table.shape[1]
    top = int(co.mat_idx.max())
    if top <= 65535:
        fail(f"the {n_mat}-material run gathers no index above 65535")
    peak, st = _fluid_bit_for_bit(f"{n_mat}-material table", grid, co, pamp,
                                  oz, device)
    print(f"[kernels] fluid {KERNEL_SHAPE}, {n_mat}-material table "
          f"({4 * 6 * n_mat} bytes, indices up to {top}), {LARGE_STEPS} "
          f"steps (window from {LARGE_SENSOR_START}): peak |p| {peak:.6g} "
          "Pa; every field bit-equal to plain")
    if device == "cuda":
        s = F.step_scalars(grid, 10, oz)
        t = (_timed_graph(lambda: K.fluid_velocity(st, co, s[0], s[1]), 20),
             _timed_graph(lambda: K.fluid_pressure(st, co), 20),
             _timed_graph(lambda: K.fluid_pressure(st, co, s[2], s[3]), 20))
        print(f"[kernels]   with this table: velocity {t[0]:.4f} ms, "
              f"pressure {t[1]:.4f} ms, +DFT {t[2]:.4f} ms")
    return {"fluid_velocity": 0.0, "fluid_pressure": 0.0,
            "fluid_pressure_dft": 0.0}, {}


# the fused phase: steps before a fused launch (from zero fields, with the
# pair), and the 50-plane grid its shard checks run on (the planes of a
# shard of 192 planes over 4 devices with its ghost planes)
FUSED_PRE_STEPS = 30
FUSED_SHARD = (50, 192, 240)


def _fused_case(shape, k, source, viscous, dft, device, x_lo=True,
                x_hi=True):
    """One fused launch of ``k`` steps against its plain version
    (``fluid_fused_ref``, on the card) and against ``k`` steps of the pair,
    from the state ``FUSED_PRE_STEPS`` pair steps leave (the kernel phase's
    CT case, ``source`` drive): (the fused state, coefficients, rows,
    point, [(field, max abs diff)] of both comparisons)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    n0 = FUSED_PRE_STEPS
    grid, co, pamp, _, oz = fluid_case(shape, n0 + k, n0 // 2, source, device,
                                       viscous=viscous)
    co.x_lo, co.x_hi = x_lo, x_hi
    st = K.FluidState.zeros(shape, 14, device)
    for n in range(n0):
        F.fluid_step(st, co, grid, n, oz, pamp)
    fused, plain, pair = (_copy_state(st) for _ in range(3))
    pt = F.point_index(grid)
    rows = [F.step_scalars(grid, n, oz, pamp) for n in range(n0, n0 + k)]
    FK.fluid_fused(fused, co, rows, pt, with_dft=dft)
    FK.fluid_fused_ref(plain, co, rows, pt, with_dft=dft)
    for s_sin, s_cos, cosw, sinw, s_pt in rows:
        K.fluid_velocity(pair, co, s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        if dft:
            K.fluid_pressure(pair, co, cosw, sinw, point)
        else:
            K.fluid_pressure(pair, co, point=point)
    if device == "cuda":
        torch.cuda.synchronize()
    bad = ([("plain", *b) for b in state_diff(fused, plain)]
           + [("pair", *b) for b in state_diff(fused, pair)])
    return fused, co, rows, pt, bad


def check_fused(times, device="cuda"):
    """The fused phase: ``fluid_fused`` against its plain version and
    against K launches of the pair, max abs difference 0 in every field, at
    192x192x240 (the 1026-material CT table) and at the ragged 27x45x47,
    for K = 1, 2, 3 and the deepest K each grid admits, plane and point,
    viscous and inviscid, quiet and window; on a 50-plane shard with each
    x_lo / x_hi combination; then each K's time at 192x192x240 from a CUDA
    graph of captured launches, per step, against its bound and the pair's
    ``times``, and at 192x192x240 and 216x216x224 against the pair timed
    there (``time_fused_steps``: the figures behind ``FUSE_BEST``). Returns
    (errors, times, bounds) keyed by kernel row, the rows at the depth the
    main path takes there (``fused_depth``)."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK
    from babelbrain_tpu_torch.ops.fdtd_kernels import pressure_key

    t_phase = time.time()
    cases = []
    for shape in (KERNEL_SHAPE, RAGGED_SHAPE):
        kmax = min(FK.admitted_depth(shape, device, v, d, p)
                   for v in (True, False) for d in (False, True)
                   for p in (False, True))
        for k in sorted({1, 2, 3, kmax}):
            for viscous in ((True, False) if k in (3, kmax) else (True,)):
                for source in ("plane", "point"):
                    for dft in (False, True):
                        cases.append((shape, k, source, viscous, dft, True,
                                      True))
    for x_lo, x_hi in ((True, True), (True, False), (False, True),
                       (False, False)):
        for dft in (False, True):
            cases.append((FUSED_SHARD, 3, "plane", True, dft, x_lo, x_hi))
    errs = {}
    for shape, k, source, viscous, dft, x_lo, x_hi in cases:
        st, _, _, _, bad = _fused_case(shape, k, source, viscous, dft, device,
                                       x_lo, x_hi)
        pmax = float(st.p.abs().max())
        print(f"[fused] {shape} K={k} {source} "
              f"{'viscous' if viscous else 'inviscid'} "
              f"{'window' if dft else 'quiet'} x_lo={x_lo} x_hi={x_hi}: "
              f"max|p| {pmax:.6g} Pa; fields differing from the plain "
              f"version / the pair {bad}")
        if bad or not np.isfinite(pmax) or pmax <= 0:
            fail(f"fused kernel differs ({shape}, K={k}, {source}, "
                 f"viscous={viscous}, dft={dft}, x_lo={x_lo}, x_hi={x_hi}): "
                 f"{bad}; max|p| {pmax}")
        errs[pressure_key("fluid_fused", dft,
                          0 if source == "point" else None)] = 0.0
    out_t, out_b = {}, {}
    if device == "cuda":
        shape = KERNEL_SHAPE
        cells = float(np.prod(shape))
        pair = {False: times["fluid_velocity"][0] + times["fluid_pressure"][0],
                True: times["fluid_velocity"][0]
                + times["fluid_pressure_dft"][0]}
        fused_step_ms = {}
        for source in ("plane", "point"):
            point = source == "point"
            for dft in (False, True):
                key = pressure_key("fluid_fused", dft, 0 if point else None)
                k_main = fused_depth(shape, device)
                kmax = FK.admitted_depth(shape, device, True, dft, point)
                st, co, rows_max, pt, _ = _fused_case(shape, kmax, source,
                                                      True, dft, device)
                for k in range(1, kmax + 1):
                    if point and k != k_main:
                        continue
                    rows = rows_max[:k]
                    ms = _timed_graph(lambda: FK.fluid_fused(
                        st, co, rows, pt, with_dft=dft), 5)
                    if not point:
                        fused_step_ms[(k, dft)] = ms / k
                    b_ms, b_by = bound(key, shape, k=k)
                    print(f"[fused] {key} K={k} at {shape}: {ms:.4f} ms a "
                          f"launch, {ms / k:.4f} ms a step "
                          f"({cells * k / ms / 1e3:.1f} Mcell-updates/s); "
                          f"bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.4f} a "
                          f"step ({b_ms / ms:.0%}); the pair "
                          f"{pair[dft]:.4f} ms a step "
                          f"({ms / k / pair[dft]:.3f}x)")
                    if k == k_main:
                        plain = _timed(lambda: FK.fluid_fused_ref(
                            st, co, rows, pt, with_dft=dft), 2, warm=1)
                        out_t[key] = (ms, plain)
                        out_b[key] = (b_ms, b_by)
                        print(f"[fused]   {key}: the main path's K={k} at "
                              f"{shape} (fused_depth); plain version "
                              f"{plain:.4f} ms a launch")
        per_step = {KERNEL_SHAPE: {}, SLICE_SHAPE: {}}
        for dft in (False, True):
            per_step[KERNEL_SHAPE][("pair", dft)] = pair[dft]
            for k in range(1, FK.admitted_depth(KERNEL_SHAPE, device, True,
                                                dft) + 1):
                per_step[KERNEL_SHAPE][(k, dft)] = fused_step_ms[(k, dft)]
        per_step[SLICE_SHAPE] = time_fused_steps(SLICE_SHAPE, device)
        best = lockstep_fuse_best(per_step)
        for shape, t in per_step.items():
            print(f"[fused] a step at {shape}, quiet / window: " + "; ".join(
                f"K={k} {t[(k, False)]:.4f} / {t[(k, True)]:.4f} ms "
                f"({t[(k, False)] / t[('pair', False)]:.3f}x / "
                f"{t[(k, True)] / t[('pair', True)]:.3f}x the pair)"
                for k in sorted({k for k, _ in t if k != "pair"}))
                + f"; the pair {t[('pair', False)]:.4f} / "
                f"{t[('pair', True)]:.4f} ms")
        print(f"[fused] the depth measured fastest against the pair at both "
              f"shapes, quiet and window: {best} (FUSE_BEST = "
              f"{FK.FUSE_BEST})")
        if best != FK.FUSE_BEST:
            print("[fused] WARNING: FUSE_BEST does not follow this run's "
                  "measurement")
    print(f"[fused] phase {time.time() - t_phase:.2f} s")
    return errs, out_t, out_b


def time_fused_steps(shape, device="cuda"):
    """{(K, dft): ms a step} of the viscous plane sweep at every K the card
    admits on ``shape``, and {("pair", dft): ms} of one step of the pair
    (velocity + pressure), timed in the same way (CUDA graphs) on the same
    state."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    out = {}
    for dft in (False, True):
        kmax = FK.admitted_depth(shape, device, True, dft)
        st, co, rows_max, pt, _ = _fused_case(shape, kmax, "plane", True, dft,
                                              device)
        s_sin, s_cos, cosw, sinw, _ = rows_max[0]

        def pair_step():
            K.fluid_velocity(st, co, s_sin, s_cos)
            if dft:
                K.fluid_pressure(st, co, cosw, sinw)
            else:
                K.fluid_pressure(st, co)

        out[("pair", dft)] = _timed_graph(pair_step, 10)
        for k in range(1, kmax + 1):
            rows = rows_max[:k]
            out[(k, dft)] = _timed_graph(lambda: FK.fluid_fused(
                st, co, rows, pt, with_dft=dft), 5) / k
        del st
    return out


def lockstep_fuse_best(per_step):
    """The depth ``fuse_steps=None`` should take in a lockstep sweep (the
    fluid's, and the visco one's, ``check_visco_fused``): of K >= 2,
    the one whose worst ratio to the pair over the shapes of ``per_step``,
    quiet and window, is the least, if that ratio is below 1; else 0."""
    ratios = {}
    for t in per_step.values():
        for (k, dft), ms in t.items():
            if k != "pair" and k >= 2:
                ratios[k] = max(ratios.get(k, 0.0), ms / t[("pair", dft)])
    shared = [k for k in ratios
              if all((k, d) in t for t in per_step.values()
                     for d in (False, True))]
    k = min(shared, key=lambda k: ratios[k], default=0)
    return k if k and ratios[k] < 1.0 else 0


# the CT slices' FDTD grid (216x216x224), where the extras sweep's depth is
# chosen against pair + extras + MONITOR (EXTRAS_FUSE_BEST)
SLICE_SHAPE = (216, 216, 224)
# the maps of the reference's Step 2 selection (SelMapsRMSPeakList)
SENSOR_MAPS = ("Pressure_rms", "Pressure_peak")


def extras_voxels(shape, n, seed=6):
    """(K, 3) monitor voxels for the extras sweep's checks: n = 201, a line
    along z through the centre (the diag slices' beam axis), its middle
    voxel first; else ``n`` seeded voxels; the last 8 repeat the first 8."""
    if n == 201:
        c1, c2 = shape[0] // 2, shape[1] // 2
        ks = np.linspace(0, shape[2] - 1, n - 1).astype(int)
        ijk = np.array([[c1, c2, shape[2] // 2]] + [[c1, c2, k] for k in ks])
    else:
        rng = np.random.default_rng(seed)
        ijk = np.stack([rng.integers(0, m, n) for m in shape], 1)
    ijk[-8:] = ijk[:8]
    return ijk


def edge_voxels(shape):
    """Voxels where the extras sweep's warps and stages meet: the planes
    where one stage hands over to the next (0, 1, LAG - 1, LAG, LAG + 1 and
    the last two) on the (y, z) tiles' corners (a thread's two rows and
    the block's) and at the centre, each once, and 6 of them again."""
    from babelbrain_tpu_torch.ops.fdtd_fused_kernels import LAG, ROWS
    from babelbrain_tpu_torch.ops.fdtd_kernels import TILE_Y, TILE_Z

    n1, n2, n3 = shape
    planes = sorted({0, 1, LAG - 1, LAG, LAG + 1, n1 - 2, n1 - 1})
    ys = sorted({0, TILE_Y - 1, TILE_Y, ROWS - 1, ROWS, n2 - 1})
    zs = sorted({0, TILE_Z - 1, TILE_Z, n3 - 1})
    ijk = np.array([[i, j, k] for i in planes for j in ys for k in zs]
                   + [[i, n2 // 2, n3 // 2] for i in planes])
    return np.concatenate([ijk, ijk[[0, 7, 7, 20, 41, -1]]])


def _extras_case(shape, k, source, viscous, device, ijk, maps=SENSOR_MAPS):
    """One extras sweep of ``k`` window steps (``fluid_fused`` with the
    Pressure_rms accumulator of ``maps`` and the samples at ``ijk``, every
    step but the second sampled) from the state ``FUSED_PRE_STEPS`` quiet
    pair steps leave, against its plain version and against ``k`` steps of
    pair + extras + MONITOR (``fluid_step`` with the sample, the maps'
    pass). Returns (the swept state, its Diagnostics, coefficients, grid,
    oz, point amplitude, [(what, max abs diff)])."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_extras as E
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    n0 = FUSED_PRE_STEPS
    grid, co, pamp, _, oz = fluid_case(shape, n0 + k, n0, source, device,
                                       viscous=viscous)
    st = K.FluidState.zeros(shape, 14, device)
    for n in range(n0):
        F.fluid_step(st, co, grid, n, oz, pamp)
    fused, plain, pair = (_copy_state(st) for _ in range(3))
    index = (None if ijk is None else E.monitor_index(ijk, shape, device))
    steps = [n for n in range(n0, n0 + k) if n != n0 + 1]
    diags = [E.Diagnostics.create(
        x, grid.sensor_start, maps, sample_steps=steps if ijk is not None
        else (), index=index, sweep=sweep)
        for x, sweep in ((fused, True), (plain, True), (pair, False))]
    pt = F.point_index(grid)
    rows = [F.step_scalars(grid, n, oz, pamp) for n in range(n0, n0 + k)]
    for fn, x, d in ((FK.fluid_fused, fused, diags[0]),
                     (FK.fluid_fused_ref, plain, diags[1])):
        fn(x, co, rows, pt, with_dft=True, extras=d.extras,
           monitor=d.sweep_monitor(n0, k))
    for n in range(n0, n0 + k):
        F.fluid_step(pair, co, grid, n, oz, pamp, None, diags[2].monitor(n))
        diags[2].record(pair, n)
    if device == "cuda":
        torch.cuda.synchronize()
    bad = ([("plain", *b) for b in state_diff(fused, plain)]
           + [("pair", *b) for b in state_diff(fused, pair)])
    ex = [d.extras.read(k) if d.extras is not None else {} for d in diags]
    for name in ex[0]:
        for other, o in (("plain", ex[1]), ("pair", ex[2])):
            if (e := _equal(torch.as_tensor(ex[0][name]),
                            torch.as_tensor(o[name]))):
                bad.append((f"{other} {name}", e))
    if ijk is not None:
        for other, d in (("plain", diags[1]), ("pair", diags[2])):
            if (e := _equal(diags[0].series, d.series)):
                bad.append((f"{other} series", e))
    return fused, diags[0], co, grid, oz, pamp, bad


def check_fused_extras(device="cuda"):
    """The extras sweep (``fluid_fused`` with B4's ``with_p2`` accumulator
    and the monitor capture; csrc/fdtd_fluid_fused.cu EXTRAS) against its
    plain version and against K steps of pair + extras + MONITOR, max abs
    difference 0 in every field, the Pressure_rms / Pressure_peak maps and
    the series: at 192x192x240 for K = 1 .. the deepest the card admits,
    plane and point, viscous (4096 seeded voxels, 8 twice) and inviscid
    (201 on a line), the Pressure_peak map read from the carrier peak;
    there also maps only, Pressure_peak only and monitors only; at 27x45x47
    for K = 1..4 with voxels on tile corners and the stages' hand-over
    planes. Then each K's time a launch and a step at 192x192x240 and at
    the CT slices' 216x216x224 against its bound and pair + extras +
    MONITOR a step (201 voxels, every step sampled). Returns (errors,
    times, bounds) keyed by kernel row (the plane-source row at the depth
    the sensors-ct slice takes) and {K: ms a step at 216x216x224, "pair":
    ms} for ``EXTRAS_FUSE_BEST``."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    t_phase = time.time()
    cases = []
    kmax = min(FK.admitted_depth(KERNEL_SHAPE, device, v, True, p, True)
               for v in (True, False) for p in (False, True))
    for k in range(1, kmax + 1):
        for viscous, n_mon in ((True, MONITOR_POINTS), (False, 201)):
            for source in ("plane", "point"):
                cases.append((KERNEL_SHAPE, k, source, viscous,
                              extras_voxels(KERNEL_SHAPE, n_mon), SENSOR_MAPS))
    for maps, n_mon in ((SENSOR_MAPS, None), (("Pressure_peak",), 201),
                        ((), 201)):
        cases.append((KERNEL_SHAPE, kmax, "plane", True, None if n_mon is None
                      else extras_voxels(KERNEL_SHAPE, n_mon), maps))
    for k in range(1, 5):
        for source in ("plane", "point"):
            cases.append((RAGGED_SHAPE, k, source, k % 2 == 1,
                          edge_voxels(RAGGED_SHAPE), SENSOR_MAPS))
    errs = {}
    for shape, k, source, viscous, ijk, maps in cases:
        st, diag, *_, bad = _extras_case(shape, k, source, viscous, device,
                                         ijk, maps)
        pmax = float(st.p.abs().max())
        smax = (float(diag.series.abs().max()) if diag.series is not None
                else None)
        print(f"[fused extras] {shape} K={k} {source} "
              f"{'viscous' if viscous else 'inviscid'} maps {maps} "
              f"{0 if ijk is None else len(ijk)} voxels: max|p| {pmax:.6g} "
              f"Pa, max|series| {smax}; differing from the plain version / "
              f"pair + extras + MONITOR {bad}")
        if bad or not np.isfinite(pmax) or pmax <= 0 or (
                smax is not None and not smax > 0):
            fail(f"extras sweep differs ({shape}, K={k}, {source}, "
                 f"viscous={viscous}, maps={maps}): {bad}; max|p| {pmax}")
        errs[FK.fused_key(True, 0 if source == "point" else None,
                          True)] = 0.0
    out_t, out_b, per_step = {}, {}, {}
    if device == "cuda":
        for shape in (KERNEL_SHAPE, SLICE_SHAPE):
            per_step.update(_time_extras(shape, device, out_t, out_b))
    print(f"[fused extras] phase {time.time() - t_phase:.2f} s")
    return errs, out_t, out_b, per_step


def _time_extras(shape, device, out_t, out_b):
    """The deepest K of the extras sweep the card admits at ``shape``
    (plane, viscous, the Pressure maps, 201 voxels) held to its plain
    version and to K steps of pair + extras + MONITOR, max abs difference
    0 (fails otherwise); then each K a launch and a step (every step
    sampled) against its bound and pair + extras + MONITOR a step (the
    pair route's work for the Pressure maps and the voxels: one CUDA graph
    of the three launches, timed before and after the sweeps); at
    ``KERNEL_SHAPE`` the plane-source row's times and bound at the
    sensors-ct slice's depth go into ``out_t`` / ``out_b``. Returns {K: ms
    a step, "pair": ms a step} at ``SLICE_SHAPE``, else {}."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_extras as E
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    kmax = FK.admitted_depth(shape, device, True, True, False, True)
    ijk = extras_voxels(shape, 201)
    st, diag, co, grid, oz, pamp, bad = _extras_case(shape, kmax, "plane",
                                                     True, device, ijk)
    pmax = float(st.p.abs().max())
    smax = float(diag.series.abs().max())
    print(f"[fused extras] {shape} K={kmax} plane viscous maps {SENSOR_MAPS} "
          f"{len(ijk)} voxels: max|p| {pmax:.6g} Pa, max|series| {smax:.6g}; "
          f"differing from the plain version / pair + extras + MONITOR {bad}")
    if bad or not np.isfinite(pmax) or pmax <= 0 or not smax > 0:
        fail(f"extras sweep differs ({shape}, K={kmax}, plane, viscous): "
             f"{bad}; max|p| {pmax}")
    n0 = FUSED_PRE_STEPS
    rows_max = [F.step_scalars(grid, n, oz, pamp) for n in range(n0, n0 + kmax)]
    sampled = E.Diagnostics.create(st, n0, SENSOR_MAPS,
                                   sample_steps=range(n0, n0 + kmax),
                                   index=diag.index, sweep=True)
    pair_diag = E.Diagnostics.create(st, n0, SENSOR_MAPS,
                                     sample_steps=[n0], index=diag.index)

    def pair_step():
        F.fluid_step(st, co, grid, n0, oz, pamp, None, pair_diag.monitor(n0))
        pair_diag.record(st, n0)

    pair = [_timed_graph(pair_step, 10)]
    cells = float(np.prod(shape))
    n_warps = float(np.prod(E.sweep_geometry(shape).grid)) * 8
    ms = {}
    for k in range(1, kmax + 1):
        rows = rows_max[:k]
        mon = sampled.sweep_monitor(n0, k)
        ms[k] = _timed_graph(lambda: FK.fluid_fused(
            st, co, rows, None, with_dft=True, extras=sampled.extras,
            monitor=mon), 5)
    pair.append(_timed_graph(pair_step, 10))
    t_pair = sum(pair) / 2
    k_main = sensors_depth(shape, device)
    key = FK.fused_key(True, None, True)
    for k, t in ms.items():
        b_bytes, b_ops = work(key, shape, k=k)
        # the list's offsets and entries read, the samples written
        b_ms, b_by = roofline(b_bytes + 4.0 * (n_warps + 1 + 2 * 201 + k * 201),
                              b_ops)
        print(f"[fused extras] {key} K={k} at {shape}: {t:.4f} ms a launch, "
              f"{t / k:.4f} ms a step ({cells * k / t / 1e3:.1f} "
              f"Mcell-updates/s); bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / k:.4f} a step ({b_ms / t:.0%}); pair + extras + "
              f"MONITOR {pair[0]:.4f} / {pair[1]:.4f} ms a step "
              f"({t / k / t_pair:.3f}x)")
        if shape == KERNEL_SHAPE and k == k_main:
            plain = _timed(lambda: FK.fluid_fused_ref(
                st, co, rows_max[:k], None, with_dft=True,
                extras=sampled.extras, monitor=sampled.sweep_monitor(n0, k)),
                2, warm=1)
            out_t[key] = (t, plain)
            out_b[key] = (b_ms, b_by)
            print(f"[fused extras]   {key}: the sensors-ct slice's K={k}; "
                  f"plain version {plain:.4f} ms a launch")
    if shape != SLICE_SHAPE:
        return {}
    return {**{k: t / k for k, t in ms.items()}, "pair": t_pair}


# the depth of the fluid sweep the main path takes where the defaults keep
# the pair (FUSE_BEST, EXTRAS_FUSE_BEST = 0): its fastest K against the pair
# on the card (check_fused, check_fused_extras, PERF.md), at which
# pinned_fuse_steps pins the refocus-ct slice (plane and point, quiet and
# window) and the sensors-ct slice (the extras sweeps)
FUSED_PIN_K = 4


def fused_depth(shape, device="cuda", extras=False):
    """The depth of the fluid sweep (its EXTRAS instantiations with
    ``extras``) the main path takes on ``shape``: the default's where it
    sweeps, else ``FUSED_PIN_K``, at most what the card admits there."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    best = FK.EXTRAS_FUSE_BEST if extras else FK.FUSE_BEST
    admitted = FK.admitted_depth(shape, device, True, True, False, extras)
    return min(best if best >= 2 else FUSED_PIN_K, admitted)


def sensors_depth(shape, device="cuda"):
    """The window depth the sensors-ct slice's run_fdtd on ``shape`` is
    pinned at (``pinned_fuse_steps``): the extras sweep's ``fused_depth``."""
    return fused_depth(shape, device, extras=True)


def _visco_fused_case(shape, k, source, dft, device, x_lo=True, x_hi=True,
                      viscous=True, zsrc=13, source_ijk=None):
    """One ``visco_fused`` launch of ``k`` steps against its plain version
    (``visco_fused_ref``, on the card) and against ``k`` steps of the visco
    pair, from the state ``FUSED_PRE_STEPS`` pair steps leave (the kernel
    phase's label case, ``source`` drive; the SLS memories off unless
    ``viscous``): (the fused state, coefficients, rows, point, [(field, max
    abs diff)] of both comparisons)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    n0 = FUSED_PRE_STEPS
    grid, co, pamp, _, oz, _ = visco_case(shape, n0 + k, n0 // 2, source,
                                          device, zsrc=zsrc,
                                          source_ijk=source_ijk)
    co.x_lo, co.x_hi = x_lo, x_hi
    co.viscous = co.viscous and viscous
    st = V.ViscoState.zeros(shape, 14, device)
    for n in range(n0):
        F.visco_step(st, co, grid, n, oz, pamp)
    fused, plain, pair = (_copy_state(st) for _ in range(3))
    pt = F.point_index(grid)
    rows = [F.step_scalars(grid, n, oz, pamp) for n in range(n0, n0 + k)]
    VF.visco_fused(fused, co, rows, pt, with_dft=dft)
    VF.visco_fused_ref(plain, co, rows, pt, with_dft=dft)
    for s_sin, s_cos, cosw, sinw, s_pt in rows:
        V.visco_velocity(pair, co, s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        if dft:
            V.visco_stress(pair, co, cosw, sinw, point)
        else:
            V.visco_stress(pair, co, point=point)
    if device == "cuda":
        torch.cuda.synchronize()
    bad = ([("plain", *b) for b in state_diff(fused, plain)]
           + [("pair", *b) for b in state_diff(fused, pair)])
    return fused, co, rows, pt, bad


def check_visco_fused(device="cuda"):
    """The visco fused phase: ``visco_fused`` against its plain version and
    against K launches of the visco pair, max abs difference 0 in every
    field: at 192x192x240 (5 label materials) for every K the card admits
    there, plane and point, quiet and window; on a 50-plane shard with each
    x_lo / x_hi combination (the shards' instantiation beside the XALL
    twin); at the ragged 27x45x47 for K = 1..4, plane (on a z-tile edge)
    and point (on a tile corner), and inviscid (N3 % 4 != 0: the 4-byte
    copies; the other grids take the 16-byte ones). Then each admitted K's
    time a step, quiet and window, at 192x192x240 and at the label slices'
    216x216x224 against the visco pair timed there (``time_visco_steps``,
    the figures behind ``VISCO_FUSE_BEST``), and the point rows at the
    depth the main path takes, each against its bound; the kernel's
    registers, spills and shared memory a block are printed. Returns
    (errors, times, bounds) keyed by kernel row, the rows at the depth the
    main path takes (``visco_depth``)."""
    from babelbrain_tpu_torch.ops import _build
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF
    from babelbrain_tpu_torch.ops.fdtd_kernels import pressure_key

    t_phase = time.time()
    kmax = min(VF.admitted_depth(KERNEL_SHAPE, device, True, d, p)
               for d in (False, True) for p in (False, True))
    kshard = min(2, VF.admitted_depth(FUSED_SHARD, device, True, True))
    print(f"[visco-fused] admitted depth at {KERNEL_SHAPE}: K = {kmax}; at "
          f"{SLICE_SHAPE}: "
          f"{VF.admitted_depth(SLICE_SHAPE, device, True, True)}; at "
          f"{FUSED_SHARD}: "
          f"{VF.admitted_depth(FUSED_SHARD, device, True, True)}; at "
          f"{RAGGED_SHAPE}: "
          f"{VF.admitted_depth(RAGGED_SHAPE, device, True, True)}"
          + (f"; capacity {VF.capacity(device, True, True, False)} blocks, "
             f"{VF.SMEM_BYTES} bytes of shared memory a block"
             if device == "cuda" else ""))
    if device == "cuda":
        for name, res in fdtd_resources(_build.build_log):
            if name.startswith("visco_fused_kernel"):
                print(f"[visco-fused] {name}: {res}")
    if kmax < 1:
        fail(f"visco_fused: not one stage fits at {KERNEL_SHAPE}")
    corner = (RAGGED_SHAPE[0] // 2, VF.ROWS, K.TILE_Z)
    cases = []  # (shape, k, source, dft, x_lo, x_hi, viscous)
    for k in range(1, kmax + 1):
        for source in ("plane", "point"):
            for dft in (False, True):
                cases.append((KERNEL_SHAPE, k, source, dft, True, True, True))
    for x_lo, x_hi in ((True, True), (True, False), (False, True),
                       (False, False)):
        for dft in (False, True):
            cases.append((FUSED_SHARD, kshard, "plane", dft, x_lo, x_hi,
                          True))
    for k in range(1, VF.K_CAP + 1):
        for source in ("plane", "point"):
            for dft in (False, True):
                cases.append((RAGGED_SHAPE, k, source, dft, True, True,
                              True))
    for k in (2, VF.K_CAP):
        cases.append((RAGGED_SHAPE, k, "plane", True, True, True, False))
    errs = {}
    for shape, k, source, dft, x_lo, x_hi, viscous in cases:
        ragged = shape == RAGGED_SHAPE
        st, _, _, _, bad = _visco_fused_case(
            shape, k, source, dft, device, x_lo, x_hi, viscous,
            zsrc=K.TILE_Z if ragged else 13,
            source_ijk=corner if ragged else None)
        smax = float(st.sxx.abs().max())
        print(f"[visco-fused] {shape} K={k} {source} "
              f"{'viscous' if viscous else 'inviscid'} "
              f"{'window' if dft else 'quiet'} x_lo={x_lo} x_hi={x_hi}: "
              f"max|sxx| {smax:.6g} Pa; fields differing from the plain "
              f"version / the pair {bad}")
        if bad or not np.isfinite(smax) or smax <= 0:
            fail(f"visco fused kernel differs ({shape}, K={k}, {source}, "
                 f"dft={dft}, x_lo={x_lo}, x_hi={x_hi}, viscous={viscous}): "
                 f"{bad}; max|sxx| {smax}")
        errs[pressure_key("visco_fused", dft,
                          0 if source == "point" else None)] = 0.0
    out_t, out_b = {}, {}
    if device == "cuda":
        per_step = {shape: time_visco_steps(shape, device)
                    for shape in (KERNEL_SHAPE, SLICE_SHAPE)}
        best = lockstep_fuse_best(per_step)
        for shape, t in per_step.items():
            for (k, dft), ms in sorted(t.items(), key=str):
                if k == "pair":
                    continue
                key = pressure_key("visco_fused", dft, None)
                b_ms, b_by = bound(key, shape, k=k)
                print(f"[visco-fused] {key} K={k} at {shape}: {ms * k:.4f} "
                      f"ms a launch, {ms:.4f} ms a step "
                      f"({float(np.prod(shape)) / ms / 1e3:.1f} "
                      f"Mcell-updates/s); bound {b_ms:.4f} ms ({b_by}), "
                      f"{b_ms / k:.4f} a step ({b_ms / (ms * k):.0%}); the "
                      f"pair {t[('pair', dft)]:.4f} ms a step "
                      f"({ms / t[('pair', dft)]:.3f}x)")
            print(f"[visco-fused] a step at {shape}, quiet / window: "
                  + "; ".join(
                      f"K={k} {t[(k, False)]:.4f} / {t[(k, True)]:.4f} ms "
                      f"({t[(k, False)] / t[('pair', False)]:.3f}x / "
                      f"{t[(k, True)] / t[('pair', True)]:.3f}x the pair)"
                      for k in sorted({k for k, _ in t if k != "pair"}))
                  + f"; the pair {t[('pair', False)]:.4f} / "
                  f"{t[('pair', True)]:.4f} ms")
        print(f"[visco-fused] the depth measured fastest against the pair at "
              f"both shapes, quiet and window: {best} (VISCO_FUSE_BEST = "
              f"{VF.VISCO_FUSE_BEST})")
        if best != VF.VISCO_FUSE_BEST:
            print("[visco-fused] WARNING: VISCO_FUSE_BEST does not follow "
                  "this run's measurement")
        shape = KERNEL_SHAPE
        k_main = visco_depth(shape, device)
        for source in ("plane", "point"):
            point = source == "point"
            for dft in (False, True):
                key = pressure_key("visco_fused", dft, 0 if point else None)
                st, co, rows, pt, _ = _visco_fused_case(shape, k_main, source,
                                                        dft, device)
                ms = _timed_graph(lambda: VF.visco_fused(
                    st, co, rows, pt, with_dft=dft, checked=True), 5)
                plain = _timed(lambda: VF.visco_fused_ref(
                    st, co, rows, pt, with_dft=dft), 2, warm=1)
                out_t[key] = (ms, plain)
                out_b[key] = bound(key, shape, k=k_main)
                print(f"[visco-fused]   {key}: the main path's K={k_main} at "
                      f"{shape} (visco_depth): {ms:.4f} ms a launch, bound "
                      f"{out_b[key][0]:.4f} ms ({out_b[key][0] / ms:.0%}); "
                      f"plain version {plain:.4f} ms a launch")
                del st
    print(f"[visco-fused] phase {time.time() - t_phase:.2f} s")
    return errs, out_t, out_b


def time_visco_steps(shape, device="cuda"):
    """{(K, dft): ms a step} of the viscous plane sweep at every K the card
    admits on ``shape``, and {("pair", dft): ms} of one step of the visco
    pair (velocity + stress), timed in the same way (CUDA graphs) on the
    same state, before and after the sweeps (their mean). The state is
    ``_visco_fused_case``'s at the deepest K, which holds that launch to
    its plain version and to the pair bit for bit first."""
    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    out = {}
    for dft in (False, True):
        kmax = VF.admitted_depth(shape, device, True, dft)
        st, co, rows_max, pt, bad = _visco_fused_case(shape, kmax, "plane",
                                                      dft, device)
        if bad:
            fail(f"visco fused kernel differs ({shape}, K={kmax}, plane, "
                 f"dft={dft}): {bad}")
        s_sin, s_cos, cosw, sinw, _ = rows_max[0]

        def pair_step():
            V.visco_velocity(st, co, s_sin, s_cos)
            if dft:
                V.visco_stress(st, co, cosw, sinw)
            else:
                V.visco_stress(st, co)

        pair = [_timed_graph(pair_step, 10)]
        for k in range(1, kmax + 1):
            rows = rows_max[:k]
            out[(k, dft)] = _timed_graph(lambda: VF.visco_fused(
                st, co, rows, pt, with_dft=dft, checked=True), 5) / k
        pair.append(_timed_graph(pair_step, 10))
        out[("pair", dft)] = sum(pair) / 2
        print(f"[visco-fused] the pair at {shape} "
              f"{'window' if dft else 'quiet'}: {pair[0]:.4f} / "
              f"{pair[1]:.4f} ms a step (before / after the sweeps)")
        del st
    return out


# the depth of the visco sweep chip_smoke pins the refocus-label slice's
# run_fdtd calls at (pinned_fuse_steps) while VISCO_FUSE_BEST = 0 keeps
# label-mode runs on the pair, so that the sweep stays on a path and
# check_fused_runs holds it to the pair: its fastest K against the pair on
# the card (check_visco_fused, PERF.md)
VISCO_PIN_K = 2


def visco_depth(shape, device="cuda"):
    """The depth of the visco sweep the main path takes on ``shape``: the
    default's where it sweeps, else ``VISCO_PIN_K``, at most what the card
    admits there."""
    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF

    best = VF.VISCO_FUSE_BEST
    admitted = min(VF.admitted_depth(shape, device, True, d, p)
                   for d in (False, True) for p in (False, True))
    return min(best if best >= 2 else VISCO_PIN_K, admitted)


# the dome slices' FDTD grid (DomeTx at 220 kHz, 6 PPW), for the halo
# sweeps' checks
DOME_SHAPE = (392, 392, 337)
# the depth chip_smoke pins for every run_fdtd call of the dome slices (both
# volumetric passes, in fluid or shear media) while run_fdtd(fuse_steps=None)
# keeps pair + scatter there (ops.fdtd_halo_kernels.VOLUME_FUSE_BEST and
# ops.fdtd_visco_halo_kernels.VISCO_VOLUME_FUSE_BEST are 0): the halo
# sweeps' fastest K of those the volumetric schedules sweep (K >= 2) at
# DOME_SHAPE in both families (PERF.md)
DOME_PIN_K = 2
_SHELLS: dict = {}


@contextlib.contextmanager
def pinned_fuse_steps(mode: str):
    """While a dome slice runs, each of its ``run_fdtd`` calls
    (``pipeline.acoustic``'s name) takes ``fuse_steps=DOME_PIN_K``; while
    sensors-ct runs, ``sensors_depth`` of its grid (the extras sweeps'
    depth: pinned while ``EXTRAS_FUSE_BEST`` keeps such runs on the pair);
    while refocus-ct runs, ``fused_depth`` (its plane and point runs: pinned
    while ``FUSE_BEST`` keeps such runs on the pair); while refocus-label
    runs, ``visco_depth`` (likewise, while ``VISCO_FUSE_BEST`` keeps
    label-mode runs on the pair; the default's own depth otherwise, which
    pinning does not change); nothing changes for another slice."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.pipeline import acoustic as A

    saved = A.run_fdtd

    def call(*args, **kwargs):
        if mode.startswith("dome"):
            kwargs.setdefault("fuse_steps", DOME_PIN_K)
        elif mode == "refocus-label":
            grid, = _bound(F.run_fdtd, args, kwargs, "grid")
            kwargs.setdefault("fuse_steps", visco_depth(
                grid.shape, kwargs.get("device", "cuda")))
        else:
            grid, = _bound(F.run_fdtd, args, kwargs, "grid")
            kwargs.setdefault("fuse_steps", fused_depth(
                grid.shape, kwargs.get("device", "cuda"),
                extras=mode.startswith("sensors")))
        return saved(*args, **kwargs)

    if mode.startswith(("dome", "sensors", "refocus")):
        A.run_fdtd = call
    try:
        yield
    finally:
        A.run_fdtd = saved


def shell_vsrc(shape, device):
    """``shell_source(shape)`` as a ``VolumeSource`` on ``device`` (built
    once a shape: at DOME_SHAPE the dense dict takes seconds)."""
    from babelbrain_tpu_torch.ops.fdtd_sources import VolumeSource

    key = (tuple(shape), str(device))
    if key not in _SHELLS:
        _SHELLS[key] = VolumeSource.from_dense(shell_source(shape), shape,
                                               device)
    return _SHELLS[key]


def corner_vsrc(shape, k, device, geometry=None):
    """Source voxels where a halo sweep's clusters and blocks meet: on the
    corners of the depth-``k`` clusters' owned tiles of ``geometry`` (the
    fluid halo sweep's ``halo_launch_geometry`` by default), on the inner
    edges between a cluster's blocks (the last row of one block's slab and
    the first of the next, read across through distributed shared memory)
    and on the outer edge of the clusters' halos (3K cells beyond a tile),
    in every x-segment's first and last plane and in between (seeded
    amplitudes, phases and directions)."""
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK
    from babelbrain_tpu_torch.ops.fdtd_sources import VolumeSource

    geo = (geometry or HK.halo_launch_geometry)(shape, k)
    tz, ty = geo.tile
    h = geo.halo
    ys, zs = set(), set()
    for j in range(0, shape[1] + ty, ty):
        ys |= {j, j - 1, j + h, j - h - 1}
        ys |= {j - h + r * geo.rows + d for r in range(1, geo.cluster)
               for d in (-1, 0)}
    for z in range(0, shape[2] + tz, tz):
        zs |= {z, z - 1, z + h, z - h - 1}
    xs = {0, geo.segment - 1, geo.segment, shape[0] // 2, shape[0] - 1}
    cells = [(i, j, z) for i in sorted(xs) for j in sorted(ys)
             for z in sorted(zs) if 0 <= i < shape[0] and 0 <= j < shape[1]
             and 0 <= z < shape[2]]
    idx = np.ravel_multi_index(np.array(cells).T, shape)
    rng = np.random.default_rng(9)
    n = len(idx)
    return VolumeSource.from_sparse(dict(
        index=idx, amp=rng.uniform(3e4, 6e4, n), phase=rng.uniform(-2, 2, n),
        ox=rng.uniform(-1, 1, n), oy=rng.uniform(-1, 1, n),
        oz=rng.uniform(-1, 1, n)), shape, device)


# the halo sweeps' time a step over pair + scatter's at DOME_SHAPE in the
# quiet phase, by (family, K), of the independent-block design the
# clusters replaced (PERF.md, rows B4v / B8v), printed beside this run's
OLD_HALO_RATIOS = {("fluid", 1): 1.675, ("fluid", 2): 2.184,
                   ("fluid", 3): 4.790, ("visco", 1): 2.162,
                   ("visco", 2): 4.484}


def time_halo(tag, family, run, k, shape, step, key, n_src, geo, clusters,
              beats):
    """Time one halo sweep launch ``run()`` of ``k`` steps from a CUDA graph
    and print it against its bound, pair + scatter's ``step`` ms timed in
    the same call, the old design's ratio, its cluster and its cells
    computed per cell owned; record in ``beats`` whether the sweep beats
    pair + scatter a step. Returns the ms."""
    ms = _timed_graph(run, 5)
    b_ms, b_by = bound(key, shape, n_src=n_src, k=k)
    cells = float(np.prod(shape))
    old = OLD_HALO_RATIOS.get((family, k)) if shape == DOME_SHAPE else None
    print(f"[{tag}] {key} K={k} at {shape}: {ms:.4f} ms a launch, "
          f"{ms / k:.4f} ms a step ({cells * k / ms / 1e3:.1f} "
          f"Mcell-updates/s); bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.4f} a "
          f"step ({b_ms / ms:.0%}); pair + scatter {step:.4f} ms a step: "
          f"{ms / k / step:.3f}x"
          + (f" (the independent-block design's {old:.3f}x quiet)" if old
             else "")
          + f"; clusters of (1, "
          f"{geo.cluster}, 1) blocks of {geo.threads} threads ({geo.rows} "
          f"rows), owning {geo.tile[0]}x{geo.tile[1]}, {clusters} active "
          f"at once; grid {geo.grid}, segment {geo.segment}, "
          f"{geo.computed(shape):.3f} cells computed per cell owned a step")
    beats.setdefault((shape, k), []).append(ms / k < step)
    return ms


def fuse_best(beats, ks):
    """The depth the default should take by the rule: the K whose sweep beat
    pair + scatter at DOME_SHAPE in both the quiet phase and the window
    (the fewest launches a step of those: the deepest), else 0."""
    won = [k for k in ks if beats.get((DOME_SHAPE, k)) == [True, True]]
    return max(won) if won else 0


def _halo_start(shape, viscous, device, vsrc):
    """(grid, coefficients, oz, the state FUSED_PRE_STEPS steps of pair
    (and scatter) leave) of the kernel phase's CT case with the volumetric
    drive ``vsrc``."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K

    n0 = FUSED_PRE_STEPS
    grid, co, _, _, oz = fluid_case(shape, n0 + 8, n0 // 2, "volume",
                                    device, viscous=viscous)
    st = K.FluidState.zeros(shape, 14, device)
    for n in range(n0):
        F.fluid_step(st, co, grid, n, oz, 0.0, vsrc)
    return grid, co, oz, st


def _halo_case(grid, co, oz, st0, k, dft, vsrc):
    """One ``fluid_halo`` launch of ``k`` steps from ``st0`` against its
    plain version (on the card) and ``k`` steps of pair + scatter: (the
    halo state, [(field, max abs diff)])."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_sources as S

    n0 = FUSED_PRE_STEPS
    halo, plain, pair = (_copy_state(st0) for _ in range(3))
    rows = [F.step_scalars(grid, n, oz) for n in range(n0, n0 + k)]
    HK.fluid_halo(halo, co, rows, vsrc, with_dft=dft)
    HK.fluid_halo_ref(plain, co, rows, vsrc, with_dft=dft)
    for s_sin, s_cos, cosw, sinw, _ in rows:
        K.fluid_velocity(pair, co, s_sin, s_cos)
        if vsrc is not None:
            S.velocity_volume_source(pair.vx, pair.vy, pair.vz, vsrc, s_sin,
                                     s_cos)
        if dft:
            K.fluid_pressure(pair, co, cosw, sinw)
        else:
            K.fluid_pressure(pair, co)
    if pair.p.device.type == "cuda":
        torch.cuda.synchronize()
    bad = ([("plain", *b) for b in state_diff(halo, plain)]
           + [("pair", *b) for b in state_diff(halo, pair)])
    return halo, bad


def check_fused_volume(times, device="cuda"):
    """The halo sweep (``fluid_halo``, csrc/fdtd_fluid_halo.cu) against its
    plain version and against K steps of pair + scatter, max abs difference
    0 in every field: every K it takes (1..HALO_K_CAP) at 192x192x240 and
    at the dome's 392x392x337 (which the lockstep sweep holds only at
    K = 1), quiet and window, viscous and inviscid, with ``shell_source``;
    at 27x45x47 with source voxels on the clusters' corners, inner edges
    and halo edges; on the 50-plane shard with each x_lo / x_hi pair. Then
    each K timed a launch and a step at both shapes (CUDA graphs of
    captured launches, ``time_halo``), against
    its bound and pair + scatter, with its cluster and its cells computed
    per cell owned; the depth the rule gives ``VOLUME_FUSE_BEST``
    (``fuse_best``) printed. Returns (errors, times, bounds) keyed by kernel row, the rows at
    the dome's shape and the depth its slice runs."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_sources as S

    t_phase = time.time()
    ks = range(1, HK.HALO_K_CAP + 1)
    errs = {}

    def report(tag, bad, st):
        pmax = float(st.p.abs().max())
        print(f"[fused-volume] {tag}: max|p| {pmax:.6g} Pa; fields differing "
              f"from the plain version / pair + scatter {bad}")
        if bad or not np.isfinite(pmax) or pmax <= 0:
            fail(f"fluid_halo differs ({tag}): {bad}; max|p| {pmax}")

    starts = {}
    for shape in (KERNEL_SHAPE, DOME_SHAPE):
        vsrc = shell_vsrc(shape, device)
        for viscous in (True, False):
            start = _halo_start(shape, viscous, device, vsrc)
            if viscous:
                starts[shape] = start
            for k in ks:
                for dft in (False, True):
                    st, bad = _halo_case(*start, k, dft, vsrc)
                    report(f"{shape} K={k} {vsrc.n_src} shell voxels "
                           f"{'viscous' if viscous else 'inviscid'} "
                           f"{'window' if dft else 'quiet'}", bad, st)
                    errs[HK.halo_key(True, dft)] = 0.0
                    del st
            del start
    for k in ks:
        vsrc = corner_vsrc(RAGGED_SHAPE, k, device)
        start = _halo_start(RAGGED_SHAPE, True, device, vsrc)
        for dft in (False, True):
            st, bad = _halo_case(*start, k, dft, vsrc)
            report(f"{RAGGED_SHAPE} K={k} {vsrc.n_src} voxels on cluster "
                   f"corners, inner edges and halo edges "
                   f"{'window' if dft else 'quiet'}", bad, st)
    vsrc = shell_vsrc(FUSED_SHARD, device)
    grid, co, oz, st0 = _halo_start(FUSED_SHARD, True, device, vsrc)
    for x_lo, x_hi in ((True, True), (True, False), (False, True),
                       (False, False)):
        co.x_lo, co.x_hi = x_lo, x_hi
        for dft in (False, True):
            st, bad = _halo_case(grid, co, oz, st0, DOME_PIN_K, dft, vsrc)
            report(f"{FUSED_SHARD} K={DOME_PIN_K} x_lo={x_lo} x_hi={x_hi} "
                   f"{'window' if dft else 'quiet'}", bad, st)
    del st0
    HK.release()
    print(f"[fused-volume] checks {time.time() - t_phase:.2f} s")

    out_t, out_b = {}, {}
    if device != "cuda":
        return errs, out_t, out_b
    k_main = DOME_PIN_K
    beats = {}
    for shape in (KERNEL_SHAPE, DOME_SHAPE):
        grid, co, oz, st = starts.pop(shape)
        vsrc = shell_vsrc(shape, device)
        cells = float(np.prod(shape))
        s = F.step_scalars(grid, FUSED_PRE_STEPS, oz)
        velocity = _timed_graph(lambda: K.fluid_velocity(st, co, s[0], s[1]),
                                10)
        scatter = _timed_graph(lambda: S.velocity_volume_source(
            st.vx, st.vy, st.vz, vsrc, s[0], s[1]), 10)
        pair = {False: _timed_graph(lambda: K.fluid_pressure(st, co), 10),
                True: _timed_graph(lambda: K.fluid_pressure(st, co, s[2],
                                                            s[3]), 10)}
        for dft in (False, True):
            step = velocity + scatter + pair[dft]
            print(f"[fused-volume] pair + scatter at {shape}, "
                  f"{'window' if dft else 'quiet'}: velocity {velocity:.4f} + "
                  f"scatter {scatter:.4f} + pressure {pair[dft]:.4f} = "
                  f"{step:.4f} ms a step ({cells / step / 1e3:.1f} "
                  f"Mcell-updates/s)")
            key = HK.halo_key(True, dft)
            for k in ks:
                rows = [F.step_scalars(grid, FUSED_PRE_STEPS + m, oz)
                        for m in range(k)]
                geo = HK.halo_launch_geometry(shape, k)
                ms = time_halo(
                    "fused-volume", "fluid", lambda: HK.fluid_halo(
                        st, co, rows, vsrc, with_dft=dft, checked=True),
                    k, shape, step, key, vsrc.n_src, geo,
                    HK.active_clusters(k), beats)
                if shape == DOME_SHAPE and k == k_main:
                    b_ms, b_by = bound(key, shape, n_src=vsrc.n_src, k=k)
                    plain = _timed(lambda: HK.fluid_halo_ref(
                        st, co, rows, vsrc, with_dft=dft), 1, warm=1)
                    out_t[key] = (ms, plain)
                    out_b[key] = (b_ms, b_by)
                    print(f"[fused-volume]   {key}: the dome slices' K={k} at "
                          f"{shape}; plain version {plain:.4f} ms a launch")
        del st
        HK.release()
    best = fuse_best(beats, ks)
    print(f"[fused-volume] the rule's default at {DOME_SHAPE}: K = {best} "
          f"(VOLUME_FUSE_BEST = {HK.VOLUME_FUSE_BEST})")
    if best != HK.VOLUME_FUSE_BEST:
        print("[fused-volume] WARNING: VOLUME_FUSE_BEST does not follow "
              "this run's measurement")
    print(f"[fused-volume] phase {time.time() - t_phase:.2f} s")
    return errs, out_t, out_b


def _visco_halo_start(shape, viscous, device, vsrc):
    """(grid, coefficients, oz, the state FUSED_PRE_STEPS steps of the visco
    pair + scatter leave) of the kernel phase's label-mode case (the 5
    label materials in layers) with the volumetric drive ``vsrc``."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    n0 = FUSED_PRE_STEPS
    grid, co, _, _, oz, _ = visco_case(shape, n0 + 8, n0 // 2, "volume",
                                       device)
    co.viscous = co.viscous and viscous
    st = V.ViscoState.zeros(shape, 14, device)
    for n in range(n0):
        F.visco_step(st, co, grid, n, oz, 0.0, vsrc)
    return grid, co, oz, st


def _visco_halo_case(grid, co, oz, st0, k, dft, vsrc):
    """One ``visco_halo`` launch of ``k`` steps from ``st0`` against its
    plain version (on the card) and ``k`` steps of the visco pair +
    scatter: (the halo state, [(field, max abs diff)])."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_sources as S
    from babelbrain_tpu_torch.ops import fdtd_visco_halo_kernels as VH
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    n0 = FUSED_PRE_STEPS
    halo, plain, pair = (_copy_state(st0) for _ in range(3))
    rows = [F.step_scalars(grid, n, oz) for n in range(n0, n0 + k)]
    VH.visco_halo(halo, co, rows, vsrc, with_dft=dft)
    VH.visco_halo_ref(plain, co, rows, vsrc, with_dft=dft)
    for s_sin, s_cos, cosw, sinw, _ in rows:
        V.visco_velocity(pair, co, s_sin, s_cos)
        S.velocity_volume_source(pair.vx, pair.vy, pair.vz, vsrc, s_sin,
                                 s_cos)
        if dft:
            V.visco_stress(pair, co, cosw, sinw)
        else:
            V.visco_stress(pair, co)
    if pair.vx.device.type == "cuda":
        torch.cuda.synchronize()
    bad = ([("plain", *b) for b in state_diff(halo, plain)]
           + [("pair", *b) for b in state_diff(halo, pair)])
    return halo, bad


def check_visco_volume(times, device="cuda"):
    """The visco halo sweep (``visco_halo``, csrc/fdtd_visco_halo.cu)
    against its plain version and against K steps of the visco pair +
    scatter, max abs difference 0 in all 15 fields, the psi slabs, the DFT
    sums and the peak: every K it takes (1..VISCO_HALO_K_CAP) at
    192x192x240 and at the dome's 392x392x337 (where the lockstep visco
    sweep holds not even K = 1), with the 5 label materials and
    ``shell_source``, quiet and window, viscous and inviscid; at 27x45x47
    with source voxels on the clusters' corners, inner edges and halo
    edges. Then each K timed as ``check_fused_volume`` times the fluid
    one's, and the depth the rule gives ``VISCO_VOLUME_FUSE_BEST``
    printed. Returns (errors, times, bounds) keyed by
    kernel row, the rows at the dome's shape and the depth its label slice
    runs."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK
    from babelbrain_tpu_torch.ops import fdtd_sources as S
    from babelbrain_tpu_torch.ops import fdtd_visco_halo_kernels as VH
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    t_phase = time.time()
    ks = range(1, VH.VISCO_HALO_K_CAP + 1)
    errs = {}

    def report(tag, bad, st):
        smax = float(st.sxx.abs().max())
        print(f"[visco-volume] {tag}: max|sxx| {smax:.6g} Pa; fields "
              f"differing from the plain version / pair + scatter {bad}")
        if bad or not np.isfinite(smax) or smax <= 0:
            fail(f"visco_halo differs ({tag}): {bad}; max|sxx| {smax}")

    starts = {}
    for shape in (KERNEL_SHAPE, DOME_SHAPE):
        vsrc = shell_vsrc(shape, device)
        for viscous in (True, False):
            start = _visco_halo_start(shape, viscous, device, vsrc)
            if viscous:
                starts[shape] = start
            for k in ks:
                for dft in (False, True):
                    st, bad = _visco_halo_case(*start, k, dft, vsrc)
                    report(f"{shape} K={k} {vsrc.n_src} shell voxels "
                           f"{'viscous' if viscous else 'inviscid'} "
                           f"{'window' if dft else 'quiet'}", bad, st)
                    errs[VH.halo_key(dft)] = 0.0
                    del st
            del start
    for k in ks:
        vsrc = corner_vsrc(RAGGED_SHAPE, k, device,
                           VH.visco_halo_launch_geometry)
        start = _visco_halo_start(RAGGED_SHAPE, True, device, vsrc)
        for dft in (False, True):
            st, bad = _visco_halo_case(*start, k, dft, vsrc)
            report(f"{RAGGED_SHAPE} K={k} {vsrc.n_src} voxels on cluster "
                   f"corners, inner edges and halo edges "
                   f"{'window' if dft else 'quiet'}", bad, st)
    VH.release()
    print(f"[visco-volume] checks {time.time() - t_phase:.2f} s")

    out_t, out_b = {}, {}
    if device != "cuda":
        return errs, out_t, out_b
    k_main = DOME_PIN_K
    beats = {}
    for shape in (KERNEL_SHAPE, DOME_SHAPE):
        grid, co, oz, st = starts.pop(shape)
        vsrc = shell_vsrc(shape, device)
        cells = float(np.prod(shape))
        s = F.step_scalars(grid, FUSED_PRE_STEPS, oz)
        velocity = _timed_graph(lambda: V.visco_velocity(st, co, s[0], s[1]),
                                10)
        scatter = _timed_graph(lambda: S.velocity_volume_source(
            st.vx, st.vy, st.vz, vsrc, s[0], s[1]), 10)
        stress = {False: _timed_graph(lambda: V.visco_stress(st, co), 10),
                  True: _timed_graph(lambda: V.visco_stress(st, co, s[2],
                                                            s[3]), 10)}
        for dft in (False, True):
            step = velocity + scatter + stress[dft]
            p_ms, _ = roofline(
                work("visco_velocity", shape)[0]
                + work("volume_source", shape, n_src=vsrc.n_src)[0]
                + work("visco_stress_dft" if dft else "visco_stress",
                       shape)[0], 0.0)
            print(f"[visco-volume] pair + scatter at {shape}, "
                  f"{'window' if dft else 'quiet'}: velocity {velocity:.4f} "
                  f"+ scatter {scatter:.4f} + stress {stress[dft]:.4f} = "
                  f"{step:.4f} ms a step ({cells / step / 1e3:.1f} "
                  f"Mcell-updates/s; its bytes' bound {p_ms:.4f} ms)")
            key = VH.halo_key(dft)
            for k in ks:
                rows = [F.step_scalars(grid, FUSED_PRE_STEPS + m, oz)
                        for m in range(k)]
                geo = VH.visco_halo_launch_geometry(shape, k)
                ms = time_halo(
                    "visco-volume", "visco", lambda: VH.visco_halo(
                        st, co, rows, vsrc, with_dft=dft, checked=True),
                    k, shape, step, key, vsrc.n_src, geo,
                    HK.active_clusters(k, "visco_halo"), beats)
                if shape == DOME_SHAPE and k == k_main:
                    b_ms, b_by = bound(key, shape, n_src=vsrc.n_src, k=k)
                    plain = _timed(lambda: VH.visco_halo_ref(
                        st, co, rows, vsrc, with_dft=dft), 1, warm=1)
                    out_t[key] = (ms, plain)
                    out_b[key] = (b_ms, b_by)
                    print(f"[visco-volume]   {key}: dome-label's K={k} at "
                          f"{shape}; plain version {plain:.4f} ms a launch")
        del st
        VH.release()
    best = fuse_best(beats, ks)
    print(f"[visco-volume] the rule's default at {DOME_SHAPE}: K = {best} "
          f"(VISCO_VOLUME_FUSE_BEST = {VH.VISCO_VOLUME_FUSE_BEST})")
    if best != VH.VISCO_VOLUME_FUSE_BEST:
        print("[visco-volume] WARNING: VISCO_VOLUME_FUSE_BEST does not follow "
              "this run's measurement")
    print(f"[visco-volume] phase {time.time() - t_phase:.2f} s")
    return errs, out_t, out_b


def check_monitor_ragged(device="cuda"):
    """The MONITOR instantiations of both families at ``RAGGED_SHAPE``
    (blocks with threads off the volume, which must still meet the block
    barrier) with a plane, a point on a tile corner and a shell source:
    ``MONITOR_POINTS`` // 16 seeded voxels (unsorted, five twice, the tile
    corner) sampled at every step from 5 before the window, against the
    plain step and ``monitor_gather_ref``, bit for bit in the series and
    every field; then one more step sampling every voxel. Returns the
    difference (0) keyed by kernel row."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_extras as E
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    rng = np.random.default_rng(9)
    for family in ("fluid", "visco"):
        geometry, state, step, case = (
            (V.visco_launch_geometry, V.ViscoState, F.visco_step, visco_case)
            if family == "visco" else
            (K.fluid_launch_geometry, K.FluidState, F.fluid_step, fluid_case))
        geo = geometry(RAGGED_SHAPE)
        corner = (geo.segment, geo.tile_y, K.TILE_Z)
        ijk = np.stack([rng.integers(0, n, MONITOR_POINTS // 16)
                        for n in RAGGED_SHAPE], 1)
        ijk = np.concatenate([ijk, ijk[[1, 9, 9, 30, 200]], [corner]])
        for source in ("plane", "point", "volume"):
            grid, co, pamp, vsrc, oz, *_ = case(
                RAGGED_SHAPE, RAGGED_STEPS, RAGGED_SENSOR_START, source,
                device, zsrc=K.TILE_Z, source_ijk=corner)
            st_k, st_p = (state.zeros(RAGGED_SHAPE, 14, device)
                          for _ in range(2))
            index = E.monitor_index(ijk, RAGGED_SHAPE, device)
            steps = range(RAGGED_SENSOR_START - 5, RAGGED_STEPS)
            diags = [E.Diagnostics.create(st, grid.sensor_start,
                                          sample_steps=steps, index=index)
                     for st in (st_k, st_p)]
            for n in range(RAGGED_STEPS):
                step(st_k, co, grid, n, oz, pamp, vsrc, diags[0].monitor(n))
                plain_step(st_p, co, grid, n, oz, pamp, vsrc,
                           diags[1].monitor(n))
            if device == "cuda":
                torch.cuda.synchronize()
            bad = state_diff(st_k, st_p)
            if (e := _equal(diags[0].series, diags[1].series)):
                bad.append(("series", e))
            smax = float(diags[1].series.abs().max())
            tag = f"[kernels] {family} MONITOR {RAGGED_SHAPE}, {source} source"
            print(f"{tag}: {len(ijk)} voxels x {len(steps)} samples (steps "
                  f"{steps.start}-{steps.stop - 1}, window from "
                  f"{RAGGED_SENSOR_START}), max|p| {smax:.6g} Pa; differing "
                  f"from plain {bad}")
            if bad or not np.isfinite(smax) or smax <= 0:
                fail(f"{tag}: differs from its plain version: {bad}; max "
                     f"{smax}")
            full_capture_step(tag, step, st_k, st_p, co, grid, RAGGED_STEPS,
                              oz, pamp, vsrc)
    return {"monitor_fluid": 0.0, "monitor_visco": 0.0}, {}


def bhte_case(shape, device, amp=3e6, hot=0.0):
    """(heat map Q, coefficients, T0) of the BHTE kernel checks on the CT
    table's thermal materials (``ct_index_volume``; seeded indices on grids
    too thin for its layers): a focused heating blob of ``amp`` Pa in the
    brain layer (30% duty), T0 the materials' start plus ``hot`` C at the
    blob's centre."""
    from babelbrain_tpu_torch.materials import build_thermal_material_list
    from babelbrain_tpu_torch.ops import bhte as B

    mats = build_thermal_material_list(ct_table(), ct_mode=True,
                                       segmented_brain=False)
    idx = (ct_index_volume(shape) if shape[2] >= 48 else
           np.random.default_rng(3).integers(0, len(ct_table()), shape))
    dx = 1482.3 / F0 / PPW
    n1, n2, n3 = shape
    ii, jj, kk = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    r2 = ((ii - n1 / 2) ** 2 + (jj - n2 / 2) ** 2
          + ((kk - 0.7 * n3) / 3.0) ** 2) / 8.0**2
    p = (amp * np.exp(-r2)).astype(np.float32)
    Q = torch.as_tensor(B.absorption_heating(p, idx, mats, 0.3), device=device)
    co = B.make_bhte_coeffs(B._build_coeff_maps(idx, mats, dx, 0.01), device)
    T0 = np.asarray(mats.init_temperature, np.float32)[idx]
    T0 = T0 + (hot * np.exp(-r2 / 4)).astype(np.float32)
    return Q, co, torch.as_tensor(T0, device=device)


def check_bhte(shape=KERNEL_SHAPE, n_steps=BHTE_STEPS,
               heat_steps=BHTE_HEAT_STEPS, device="cuda"):
    from babelbrain_tpu_torch.ops import bhte_kernels as K

    # a focused heating blob in the brain layer
    Q, co, T0 = bhte_case(shape, device)
    t_art = 37.0

    def run(step):
        T, out = T0.clone(), torch.empty_like(T0)
        dose = torch.zeros_like(T0)
        peak = torch.full_like(T0, -1e9)
        for n in range(n_steps):
            q = Q if n < heat_steps else None
            T_new = step(T, dose, peak, co, q, t_art, out)
            T, out = T_new, T
        return T, dose, peak

    Tk, dk, pk = run(lambda T, d, pe, c, q, ta, o:
                     K.bhte_step(T, d, pe, c, q, ta, T_out=o))
    Tp, dp, pp = run(K.bhte_step_ref)
    dT = float((Tk - Tp).abs().max())
    dpeak = float((pk - pp).abs().max())
    ddose = float(((dk - dp).abs() / dp.abs().clamp_min(1e-30)).max())
    tmax = float(pp.max())
    print(f"[kernels] bhte {shape} {n_steps} steps ({heat_steps} heating): "
          f"peak T {tmax:.4f} C, max|dT| {dT:.3g} C, max|dpeak| {dpeak:.3g} C, "
          f"dose max rel diff {ddose:.3g}")
    if not (dT <= 1e-5 and dpeak <= 1e-5 and ddose <= 1e-5):
        fail("bhte kernel disagrees with the plain version "
             "(|dT| <= 1e-5 C and dose rtol <= 1e-5 required)")
    times = {}
    if device == "cuda":
        T, out = Tk.clone(), torch.empty_like(Tk)
        tk = _timed_graph(
            lambda: K.bhte_step(T, dk, pk, co, Q, t_art, T_out=out), 50)
        tp = _timed(lambda: K.bhte_step_ref(T, dk, pk, co, Q, t_art, out), 10)
        cells = float(np.prod(shape))
        print(f"[kernels]   bhte_step: kernel {tk:.4f} ms/step "
              f"({cells / tk / 1e3:.1f} Mcell-updates/s), plain {tp:.4f} "
              f"ms/step ({cells / tp / 1e3:.1f} Mcell-updates/s)")
        times["bhte_step"] = (tk, tp)
    return {"bhte_step": max(dT, dpeak)}, times


def check_bhte_fused(times, device="cuda"):
    """``bhte_fused`` (K steps a launch) against its plain version and
    against K launches of ``bhte_step``, and those launches against the
    plain version too, max abs difference 0 in T, dose and peak: at
    192x192x240 for K = 1, 2, 3, 4, 8 and ``BHTE_FUSE_BEST`` and at the
    slices' Step 3 frame ``MASK_SHAPE`` for ``BHTE_FUSE_BEST`` (the main
    path's depth and grid; ``BHTE_FUSED_STEPS`` steps, half heating, then
    cooling, from a start whose blob straddles 43 C), at the ragged 27x45x47
    for K = 1..8, with N1 below K and with N2 and N3 below one tile (8 K
    steps each); then each K's time at both grids from a CUDA graph of
    captured launches, a launch and a step, against its bound and the
    one-step kernel's (``times`` at 192x192x240). Returns (errors, times,
    bounds) of the ``bhte_fused`` row, timed at the main path's K at
    192x192x240."""
    from babelbrain_tpu_torch.ops import bhte_kernels as K

    t_phase = time.time()
    best = K.BHTE_FUSE_BEST
    t_art = 37.0
    depths = sorted({1, 2, 3, 4, 8, best})
    cases = ((KERNEL_SHAPE, depths), (MASK_SHAPE, (best,)),
             (RAGGED_SHAPE, range(1, K.BHTE_K_CAP + 1)), (BHTE_THIN, (6, 8)),
             (BHTE_NARROW, (1, 3, 8)))
    for shape, ks in cases:
        Q, co, T0 = bhte_case(shape, device, amp=6e6, hot=7.0)
        for k in ks:
            n = (BHTE_FUSED_STEPS // k if shape in (KERNEL_SHAPE, MASK_SHAPE)
                 else 8) * k
            heat = n // 2 // k * k

            def run(how):
                T, out = T0.clone(), torch.empty_like(T0)
                dose, peak = torch.zeros_like(T0), torch.full_like(T0, -1e9)
                for s in range(0, n, k):
                    q = Q if s < heat else None
                    if how == "steps":
                        for _ in range(k):
                            T_new = K.bhte_step(T, dose, peak, co, q, t_art,
                                                T_out=out)
                            T, out = T_new, T
                        continue
                    fn = K.bhte_fused if how == "kernel" else K.bhte_fused_ref
                    T_new = fn(T, dose, peak, co, q, t_art, k, out)
                    T, out = T_new, T
                return T, dose, peak

            got, plain, steps = run("kernel"), run("plain"), run("steps")
            if device == "cuda":
                torch.cuda.synchronize()
            names = ("T", "dose", "peak")
            bad = [(f"{nm} {what}", _equal(a, b))
                   for what, x, y in (("fused vs plain", got, plain),
                                      ("fused vs steps", got, steps),
                                      ("steps vs plain", steps, plain))
                   for nm, a, b in zip(names, x, y) if not torch.equal(a, b)]
            # both dose branches: cells start below 43 C and peak above it
            tmin, pmax = float(T0.min()), float(got[2].max())
            print(f"[bhte-fused] {shape} K={k} {n} steps ({heat} heating): "
                  f"T from {tmin:.3f} C, peak {pmax:.3f} C; differing among "
                  f"bhte_fused, the plain version and K launches of "
                  f"bhte_step {bad}")
            if bad or not tmin < 43.0 < pmax:
                fail(f"bhte_fused differs ({shape}, K={k}): {bad}; T from "
                     f"{tmin} C, peak {pmax} C (both dose branches required)")
    out_t, out_b = {}, {}
    if device == "cuda":
        for shape in (KERNEL_SHAPE, MASK_SHAPE):
            cells = float(np.prod(shape))
            Q, co, T0 = bhte_case(shape, device, amp=6e6, hot=7.0)
            T, out = T0.clone(), torch.empty_like(T0)
            dose, peak = torch.zeros_like(T0), torch.full_like(T0, -1e9)
            one = (times["bhte_step"][0] if shape == KERNEL_SHAPE else
                   _timed_graph(lambda: K.bhte_step(T, dose, peak, co, Q,
                                                    t_art, T_out=out), 24))
            print(f"[bhte-fused] bhte_step at {shape}: {one:.4f} ms a step")
            for k in depths:
                ms = _timed_graph(lambda: K.bhte_fused(
                    T, dose, peak, co, Q, t_art, k, T_out=out), 24 // k)
                cool = _timed_graph(lambda: K.bhte_fused(
                    T, dose, peak, co, None, t_art, k, T_out=out), 24 // k)
                b_ms, b_by = bound("bhte_fused", shape, k=k)
                print(f"[bhte-fused] K={k} at {shape}: {ms:.4f} ms a launch, "
                      f"{ms / k:.4f} ms a step ({cells * k / ms / 1e3:.1f} "
                      f"Mcell-updates/s; cooling {cool / k:.4f}); bound "
                      f"{b_ms:.4f} ms ({b_by}), {b_ms / k:.4f} a step "
                      f"({b_ms / ms:.0%}); bhte_step {one:.4f} ms a step "
                      f"({ms / k / one:.3f}x)")
                if k == best and shape == KERNEL_SHAPE:
                    plain = _timed(lambda: K.bhte_fused_ref(
                        T, dose, peak, co, Q, t_art, k, out), 2, warm=1)
                    out_t["bhte_fused"] = (ms, plain)
                    out_b["bhte_fused"] = (b_ms, b_by)
                    print(f"[bhte-fused]   the main path's K={k} "
                          f"(BHTE_FUSE_BEST); plain version {plain:.4f} ms a "
                          "launch")
    print(f"[bhte-fused] phase {time.time() - t_phase:.2f} s")
    return {"bhte_fused": 0.0}, out_t, out_b


def _equal(a, b) -> float:
    """0.0 when ``a`` and ``b`` are equal bit for bit (NaNs included), else
    their largest absolute difference (inf when NaNs differ)."""
    if torch.equal(a, b):
        return 0.0
    d = float((a - b).abs().max())
    return d if d > 0 else float("inf")


def full_capture_step(tag, step, st_k, st_p, co, grid, n, oz, pamp=0.0,
                      vsrc=None):
    """Step ``n`` once more on copies of a kernel state and of its plain
    twin (equal so far), each sampling every voxel: the full-capture
    MONITOR instantiation against the plain step and ``monitor_gather_ref``.
    Fails unless the samples and every field agree bit for bit."""
    from babelbrain_tpu_torch.ops import fdtd_extras as E

    a, b = _copy_state(st_k), _copy_state(st_p)
    diag_k, diag_p = (E.Diagnostics.create(st, grid.sensor_start,
                                           sample_steps=[n]) for st in (a, b))
    step(a, co, grid, n, oz, pamp, vsrc, diag_k.monitor(n))
    plain_step(b, co, grid, n, oz, pamp, vsrc, diag_p.monitor(n))
    if a.vx.device.type == "cuda":
        torch.cuda.synchronize()
    bad = state_diff(a, b)
    if (e := _equal(diag_k.series, diag_p.series)):
        bad.append(("full capture", e))
    smax = float(diag_p.series.abs().max())
    print(f"{tag} full capture at step {n} ({diag_p.series.shape[1]} voxels, "
          f"max|p| {smax:.6g} Pa): fields and samples differing from plain "
          f"{bad}")
    if bad or not np.isfinite(smax) or smax <= 0:
        fail(f"{tag}: the full-capture MONITOR kernel differs from its plain "
             f"version: {bad}; max {smax}")


# monitor counts the MONITOR instantiations are timed with at
# KERNEL_SHAPE: the diag slices' beam axis, the kernel phase's seeded voxels
# and every voxel (None)
MONITOR_TIMED = (201, MONITOR_POINTS, None)


def monitor_bound(stem, with_dft, k, geo):
    """(least ms, "bytes" or "operations") of a MONITOR launch of the
    pressure / stress kernel ``stem`` at ``KERNEL_SHAPE``: its plain twin's
    work plus, for ``k`` listed voxels, the warps' offsets, the (voxel,
    slot) entries and the samples ((n_warps + 1 + 2k) ints, k floats); for
    every voxel (k None) one float a cell."""
    nbytes, flops = work(stem + ("_dft" if with_dft else ""), KERNEL_SHAPE)
    n_warps = np.prod(geo.grid) * geo.tile_y
    extra = (4.0 * np.prod(KERNEL_SHAPE) if k is None
             else 4.0 * (n_warps + 1 + 3 * k))
    return roofline(nbytes + float(extra), flops)


def time_monitor(family, st, co, s, index):
    """The MONITOR instantiations of the family's pressure / stress kernel
    against their plain twins on state ``st`` at ``KERNEL_SHAPE``, each
    from a CUDA graph: without and with the DFT, twin, then each of
    ``MONITOR_TIMED`` (seeded voxels from ``index``), then the twin again.
    Returns {(with_dft, k): ms} with k "twin" for the plain twin (the mean
    of its two times)."""
    from babelbrain_tpu_torch.ops import fdtd_extras as E
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    kernel = V.visco_stress if family == "visco" else K.fluid_pressure
    mons = {}
    for k in MONITOR_TIMED:
        diag = E.Diagnostics.create(st, 0, sample_steps=[0],
                                    index=None if k is None else index[:k])
        mons[k] = diag.monitor(0)
    out = {}
    for with_dft in (False, True):
        dft = (s[2], s[3]) if with_dft else (None, None)
        twin = [_timed_graph(lambda: kernel(st, co, *dft), 20)]
        for k, mon in mons.items():
            out[with_dft, k] = _timed_graph(
                lambda: kernel(st, co, *dft, None, mon), 20)
        twin.append(_timed_graph(lambda: kernel(st, co, *dft), 20))
        tw = out[with_dft, "twin"] = sum(twin) / 2
        print(f"[kernels]   {family} MONITOR, {'with' if with_dft else 'no'} "
              f"DFT: plain twin {twin[0]:.4f} / {twin[1]:.4f} ms; "
              + "; ".join(
                  f"{'every voxel' if k is None else f'{k} voxels'} "
                  f"{out[with_dft, k]:.4f} ms ({out[with_dft, k] - tw:+.4f})"
                  for k in mons))
    return out


def check_diagnostics(family, shape=KERNEL_SHAPE, device="cuda"):
    """The diagnostics kernels against their plain versions on the states of
    a plane-source run (fluid: CT table; visco: label materials): the
    extras pass with all 14 maps at every window step (both fed the same
    state after every step), and the MONITOR instantiation of the pressure /
    stress kernel at ``MONITOR_POINTS`` seeded voxels (unsorted, some
    twice) at every window step against ``monitor_gather_ref`` after the
    step, then over every voxel for one more step (``full_capture_step``).
    Returns (errors, times, bounds) keyed by kernel row; a time is (kernel
    ms, plain ms, library ms or None)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_extras as E
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

    visco = family == "visco"
    if visco:
        grid, co, _, _, oz, _ = visco_case(shape, VISCO_STEPS,
                                           VISCO_SENSOR_START, "plane", device)
        st, step = V.ViscoState.zeros(shape, 14, device), F.visco_step
        stem, geo = "visco_stress", V.visco_launch_geometry(shape)
    else:
        grid, co, _, _, oz = fluid_case(shape, FLUID_STEPS,
                                        FLUID_SENSOR_START, "plane", device)
        st, step = K.FluidState.zeros(shape, 14, device), F.fluid_step
        stem, geo = "fluid_pressure", K.fluid_launch_geometry(shape)
    rng = np.random.default_rng(5)
    ijk = np.stack([rng.integers(0, n, MONITOR_POINTS) for n in shape], 1)
    ijk[-8:] = ijk[:8]  # repeats
    index = E.monitor_index(ijk, shape, device)
    window = range(grid.sensor_start, grid.n_steps)
    diag_k, diag_p = (E.Diagnostics.create(st, grid.sensor_start, E.SEL_MAPS,
                                           sample_steps=window, index=index)
                      for _ in range(2))
    # fluid: Pressure_peak is read from the carrier peak; the kernel also
    # feeds an accumulator of its own, which must equal that peak
    own = (None if visco else
           E.Extras.zeros(("Pressure_peak",), shape, device, False))
    for n in range(grid.n_steps):
        step(st, co, grid, n, oz, monitor=diag_k.monitor(n))
        diag_k.record(st, n)
        diag_p.record(st, n, plain=True)
        if own is not None and n >= grid.sensor_start:
            E.extras_accumulate(st, own)
        if n in diag_p.rows:
            diag_p.monitor(n).gather_ref(st)
    if device == "cuda":
        torch.cuda.synchronize()
    acc_err = {k: _equal(a, diag_p.extras.acc[k])
               for k, a in diag_k.extras.acc.items()}
    if own is not None:
        acc_err["Pressure_peak (the carrier peak)"] = _equal(
            own.acc["Pressure_peak"], st.peak)
    series_err = _equal(diag_k.series, diag_p.series)
    amax = {k: float(a.abs().max()) for k, a in diag_p.extras.acc.items()}
    smax = float(diag_p.series.abs().max())
    ex, mon = f"extras_{family}", f"monitor_{family}"
    print(f"[kernels] {family} diagnostics {shape}, {len(window)} window "
          f"steps of a plane-source run: {len(amax)} accumulators for the 14 "
          f"maps (max {min(amax.values()):.6g} .. {max(amax.values()):.6g}), "
          f"{MONITOR_POINTS} monitor voxels, 8 of them twice, sampled by the "
          f"{stem} kernel (max|p| {smax:.6g} Pa)")
    print(f"[kernels]   {ex}: max abs diff vs plain {max(acc_err.values())}; "
          f"{mon} (the MONITOR instantiation vs monitor_gather_ref): "
          f"{series_err}")
    if any(acc_err.values()) or series_err:
        fail(f"{family} diagnostics kernels disagree with their plain "
             f"versions: {acc_err}, series {series_err}")
    if not all(np.isfinite(v) and v > 0 for v in amax.values()) or smax <= 0:
        fail(f"{family} diagnostics: an accumulator or the series is empty "
             f"or not finite: {amax}, {smax}")
    full_capture_step(f"[kernels]   {family} {shape}", step, st, st, co,
                      grid, grid.n_steps, oz)

    cells = float(np.prod(shape))
    # extras: every field read once, every held accumulator read and
    # written; 4 operations a map pair (v*v, +, |v|, max) for each distinct
    # field (fluid: p, vx, vy, vz; visco: seven), and the visco pressure's 4
    # (two adds, a negation, a multiply). Monitor row: the pressure / stress
    # kernel with the DFT sampling the diag slices' 201 voxels
    n_read, n_fields = (6, 7) if visco else (4, 4)
    bounds = {
        ex: roofline(cells * (4 * n_read + 8 * len(diag_k.extras.acc)),
                     cells * (4 * n_fields + (4 if visco else 0))),
        mon: monitor_bound(stem, True, MONITOR_TIMED[0], geo),
    }
    errs = {ex: max(acc_err.values()), mon: series_err}
    if device != "cuda":
        return errs, {}, bounds
    acc = diag_k.extras
    t_ex = (_timed_graph(lambda: E.extras_accumulate(st, acc), 20),
            _timed(lambda: E.extras_accumulate_ref(st, acc), 5),
            # no single PyTorch call adds v*v into one map and keeps max|v|
            # in another, over seven fields
            None)
    s = F.step_scalars(grid, grid.n_steps - 1, oz)
    t_fold = time_monitor(family, st, co, s, index)
    for (with_dft, k), t in t_fold.items():
        if k == "twin":
            continue
        b_ms, _ = monitor_bound(stem, with_dft, k, geo)
        print(f"[kernels]   {family} MONITOR {'+DFT ' if with_dft else ''}"
              f"{'every voxel' if k is None else f'{k} voxels'}: {t:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_ms / t:.0%}); extra over the twin "
              f"{t - t_fold[with_dft, 'twin']:.4f} ms")
    # plain: the plain step's pressure / stress half and the plain gather
    ref = V.visco_stress_ref if visco else K.fluid_pressure_ref
    m201 = E.Diagnostics.create(st, 0, sample_steps=[0],
                                index=index[:MONITOR_TIMED[0]]).monitor(0)
    t_mon = (t_fold[True, MONITOR_TIMED[0]],
             _timed(lambda: ref(st, co, s[2], s[3], None, m201), 5),
             # no single PyTorch call steps the pressure and gathers it
             None)
    for name, (tk, tp, tl) in ((ex, t_ex), (mon, t_mon)):
        print(f"[kernels]   {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms"
              + ("" if tl is None else f", library {tl:.4f} ms"))
    return errs, {ex: t_ex, mon: t_mon}, bounds


def check_probe_kernels(device="cuda"):
    """The probe kernels against their plain versions, bit for bit: stream
    over ``probes.STREAM_BYTES``, the FMA chain on the P1 block at the
    smaller repetition count, the table gather of the CT table's four
    coefficients over every voxel of the kernel shape. Returns (errors,
    times, bounds) as ``check_diagnostics``."""
    from babelbrain_tpu_torch import probes as P

    gen = torch.Generator(device=device).manual_seed(6)
    n = P.STREAM_BYTES // 4
    x = torch.rand(n, generator=gen, device=device)
    y_k, y_p = torch.empty_like(x), torch.empty_like(x)
    P.stream(x, y_k)
    P.stream_ref(x, y_p)

    rep = P.FMA_REPS[0]
    rng = np.random.default_rng(0)
    xf = torch.as_tensor(rng.uniform(1, 2, P.FMA_BLOCK).astype(np.float32),
                         device=device)
    scale = torch.as_tensor(P.FMA_SCALE, device=device)
    f_k, f_p = torch.empty_like(xf), torch.empty_like(xf)
    P.fma_chain(xf, scale, f_k, rep)
    P.fma_chain_ref(xf, scale, f_p, rep)

    n_coef, m = 4, 1026
    idx, tab = P.gather_inputs(KERNEL_SHAPE, m, n_coef, seed=7, device=device)
    g_k = torch.empty((n_coef,) + KERNEL_SHAPE, device=device)
    g_p = torch.empty_like(g_k)
    P.table_gather(idx, tab, g_k)
    P.table_gather_ref(idx, tab, g_p)
    if device == "cuda":
        torch.cuda.synchronize()
    errs = {"stream": _equal(y_k, y_p), "fma_chain": _equal(f_k, f_p),
            "table_gather": _equal(g_k, g_p)}
    print(f"[kernels] probes: stream {n} floats, fma_chain {P.FMA_BLOCK} x "
          f"{P.FMA_CHAINS} chains x {rep} steps, table_gather ({n_coef}, "
          f"{m}) table over {KERNEL_SHAPE}: max abs diff vs plain {errs}")
    if any(errs.values()):
        fail(f"probe kernels disagree with their plain versions: {errs}")

    cells = idx.numel()
    fma_ops = xf.numel() * (P.FMA_CHAINS * (1 + 2 * rep) + P.FMA_CHAINS - 1)
    bounds = {
        "stream": roofline(8 * n, n),
        "fma_chain": roofline(8 * xf.numel() + 4 * P.FMA_CHAINS, fma_ops),
        "table_gather": roofline(4 * cells * (1 + n_coef) + 4 * n_coef * m,
                                 0),
    }
    if device != "cuda":
        return errs, {}, bounds
    take_idx = (idx.long().unsqueeze(0)
                + m * torch.arange(n_coef, device=device).view(-1, 1, 1, 1))
    times = {
        "stream": (_timed_graph(lambda: P.stream(x, y_k), 20),
                   _timed(lambda: P.stream_ref(x, y_p), 5),
                   _timed_graph(lambda: torch.add(x, 1.0, out=y_p), 20)),
        "fma_chain": (_timed_graph(lambda: P.fma_chain(xf, scale, f_k, rep),
                                   20),
                      _timed_graph(lambda: P.fma_chain_ref(xf, scale, f_p,
                                                           rep), 1),
                      # no PyTorch call runs a chain of dependent FMAs
                      None),
        "table_gather": (
            _timed_graph(lambda: P.table_gather(idx, tab, g_k), 20),
            _timed_graph(lambda: P.table_gather_ref(idx, tab, g_p), 20),
            _timed(lambda: torch.take(tab, take_idx), 20)),
    }
    for name, (tk, tp, tl) in times.items():
        print(f"[kernels]   {name}: kernel {tk:.4f} ms, plain {tp:.4f} ms"
              + ("" if tl is None else f", library {tl:.4f} ms"))
    return errs, times, bounds


# ---------------------------------------------------------------------------
# phase 4: the CT-mode slice
# ---------------------------------------------------------------------------


def head_regions(x, y, z):
    """The procedural head's compartments at RAS points (mm): skin, the
    outer and inner tables and the diploe, brain (with its CSF rim and deep
    core) and one intracranial air sinus."""
    r = np.sqrt((x / 0.97) ** 2 + (y / 0.92) ** 2 + z ** 2) + 1e-9
    ux, uy, uz = x / r, y / r, z / r
    r_skull_out = 60.0 * (1.0 + 0.05 * ux - 0.03 * uy * uz)
    thick = np.clip(
        6.3 + 1.5 * (0.8 * uz - 0.5 * ux * uy + 0.4 * uy), 3.5, 9.5
    )
    table = np.clip(1.8 + 0.3 * uz, 1.2, 2.4)
    d_out = r - r_skull_out
    skin = (d_out > 0) & (d_out <= 5.0)
    outer_table = (d_out <= 0) & (d_out > -table)
    diploe = (d_out <= -table) & (d_out > -(thick - table))
    inner_table = (d_out <= -(thick - table)) & (d_out > -thick)
    brain = d_out <= -thick
    sinus = (
        np.sqrt(x ** 2 + (y + 40) ** 2 + (z - 25) ** 2) < 7
    ) & (brain | diploe | inner_table)
    return dict(skin=skin, outer_table=outer_table, diploe=diploe,
                inner_table=inner_table, brain=brain, sinus=sinus,
                csf=brain & (d_out > -(thick + 3.0)),
                deep=d_out <= -(thick + 18.0), r=r)


def build_head():
    """(labels, ct_hu, affine) of the procedural digital head at 2 mm
    isotropic: skull sandwich with published adult thickness statistics,
    per-compartment HU values and one intracranial air sinus."""
    N = N_HEAD
    rng = np.random.default_rng(11)
    aff = np.diag([VOX, VOX, VOX, 1.0])
    aff[:3, 3] = -N
    ii, jj, kk = np.mgrid[0:N, 0:N, 0:N]
    ras = np.stack([ii, jj, kk], -1) * VOX - N
    g = head_regions(ras[..., 0], ras[..., 1], ras[..., 2])
    skin, outer_table, diploe = g["skin"], g["outer_table"], g["diploe"]
    inner_table, brain, sinus = g["inner_table"], g["brain"], g["sinus"]

    labels = np.zeros((N, N, N), np.int32)
    labels[skin] = 5
    labels[outer_table | inner_table | diploe] = 7
    labels[brain] = 2
    labels[g["csf"]] = 4
    labels[g["deep"]] = 1
    labels[sinus] = 0  # air cavity

    ct = np.full((N, N, N), 20.0)
    ct[skin] = 45.0 + rng.normal(0, 8, skin.sum())
    ct[brain] = 35.0 + rng.normal(0, 6, brain.sum())
    ct[outer_table] = 1550.0 + rng.normal(0, 180, outer_table.sum())
    ct[inner_table] = 1450.0 + rng.normal(0, 180, inner_table.sum())
    ct[diploe] = 550.0 + rng.normal(0, 140, diploe.sum())
    ct[sinus] = -1000.0
    ct = np.clip(ct, -1000.0, 2100.0)
    return labels, ct, aff


def zte_volume(labels):
    """A synthetic ZTE MRI of the head, made as `tests/test_runner.py:
    303-308` makes one: bright soft tissue, dark skull, dark background,
    seeded noise."""
    rng = np.random.default_rng(0)
    zte = np.full(labels.shape, 30.0)
    zte[labels > 0] = 1000.0
    zte[labels == 7] = 350.0  # the head's skull
    return zte + rng.normal(0, 5, labels.shape)


# the T1 of slice coreg-zte: 1 mm voxels over the digital head's field
# (192^3); the ZTE MRI sits on the head's 2 mm grid, moved off it by
# ZTE_MOVE (degrees about an axis, a shift in mm)
T1_VOX = 1.0
ZTE_MOVE = (6.0, 2, (4.0, -3.0, 2.0))


def t1_volume(labels):
    """(T1, affine) of the digital head on a ``T1_VOX`` grid over the same
    field as ``build_head``'s. The labels are this T1's segmentation (as a
    SimNIBS segmentation would be), so its tissues are theirs, each head
    voxel a block of T1 voxels: dark skull and air, graded soft tissue,
    seeded noise and a multiplicative coil shading, made as
    `tests/test_registration_robustness.py` makes ``_head_pair``."""
    f = int(round(VOX / T1_VOX))
    lab = labels.repeat(f, 0).repeat(f, 1).repeat(f, 2)
    n = lab.shape[0]
    aff = np.diag([T1_VOX, T1_VOX, T1_VOX, 1.0])
    aff[:3, 3] = -N_HEAD - VOX / 2 + T1_VOX / 2  # the same outer boundary
    ax = (np.arange(n, dtype=np.float32) * T1_VOX + np.float32(aff[0, 3]))
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = head_regions(x, y, z)["r"]
    t1 = np.zeros((n, n, n), np.float32)
    t1[lab == 5] = 620.0  # skin
    t1[lab == 7] = 120.0  # skull
    t1[lab == 4] = 300.0  # CSF
    brain = lab == 2
    t1[brain] = 700.0 + 2.0 * (60.0 - r[brain])
    t1[lab == 1] = 850.0
    extent = N_HEAD * VOX
    bias = np.exp(0.5 * x / extent + 0.35 * y / extent - 0.3 * z / extent
                  + 0.4 * x * y / extent ** 2)
    rng = np.random.default_rng(12)
    t1 = t1 * bias + rng.normal(0, 25.0, t1.shape).astype(np.float32)
    return t1.astype(np.float32), aff


def moved(volume, move=ZTE_MOVE):
    """``volume`` (on the head's grid) moved by a rigid transform about the
    grid's centre: out(o) = volume(R (o - c) + c + t), linear (the
    robustness harness's ``_apply_rigid``); ``move`` is (degrees, axis,
    shift in mm)."""
    from scipy import ndimage

    from babelbrain_tpu_torch.pipeline.coreg import euler_matrix

    deg, axis, shift_mm = move
    angles = [0.0, 0.0, 0.0]
    angles[axis] = np.deg2rad(deg)
    R = euler_matrix(*angles).numpy().astype(np.float64)
    c = np.array(volume.shape) / 2.0
    offset = c - R @ c + np.asarray(shift_mm) / VOX
    return ndimage.affine_transform(volume, R, offset=offset, order=1)


def expected_registration(head_aff, t1_shape, t1_aff, move=ZTE_MOVE):
    """The rigid parameters (radians, T1 voxels) that realign ``moved``'s
    image on the T1 grid: the inverse rotation, and the inverse shift plus
    the term that the two grids' rotation centres give."""
    from babelbrain_tpu_torch.pipeline.coreg import euler_matrix

    deg, axis, shift_mm = move
    angles = [0.0, 0.0, 0.0]
    angles[axis] = np.deg2rad(deg)
    R = euler_matrix(*angles).numpy().astype(np.float64)
    # the world points about which ``moved`` and ``register_rigid`` rotate
    c_t1 = t1_aff[:3, :3] @ (np.array(t1_shape) / 2.0) + t1_aff[:3, 3]
    c_head = head_aff[:3, :3] @ np.full(3, N_HEAD / 2.0) + head_aff[:3, 3]
    d = c_t1 - c_head
    t_mm = (R.T - np.eye(3)) @ d - R.T @ np.asarray(shift_mm)
    return np.concatenate([-np.asarray(angles), t_mm / T1_VOX])


def _counted_modules():
    """The kernel modules whose wrappers count launches and plain calls."""
    from babelbrain_tpu_torch import probes
    from babelbrain_tpu_torch.ops import (
        bhte_kernels,
        fdtd_extras,
        fdtd_fused_kernels,
        fdtd_halo_kernels,
        fdtd_kernels,
        fdtd_sources,
        fdtd_visco_fused_kernels,
        fdtd_visco_halo_kernels,
        fdtd_visco_kernels,
        rayleigh,
    )

    return (fdtd_kernels, fdtd_fused_kernels, fdtd_halo_kernels,
            fdtd_visco_kernels, fdtd_visco_fused_kernels,
            fdtd_visco_halo_kernels, fdtd_sources, bhte_kernels, fdtd_extras,
            rayleigh, probes)


def reset_counts():
    for mod in _counted_modules():
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0


def restore_counts(launches, plain):
    """Set every count back to what ``read_counts`` returned."""
    for mod in _counted_modules():
        for d, values in ((mod.launches, launches), (mod.plain_calls, plain)):
            for k in d:
                d[k] = values[k]


def read_counts():
    launches, plain = {}, {}
    for mod in _counted_modules():
        launches.update(mod.launches)
        plain.update(mod.plain_calls)
    return launches, plain


@contextlib.contextmanager
def counting_rayleigh():
    """Count the calls of ``rayleigh_field`` (the acoustic pipeline's and
    those of ``steering_phases``) and of ``rayleigh_field_grid`` (the
    forward Rayleigh over a grid) while the block runs: a call on one
    device launches the Rayleigh kernel's point-list or grid form once, so a
    slice's ``rayleigh`` and ``rayleigh_grid`` launches must equal these
    counts. Yields a two-element list (point list, grid)."""
    from babelbrain_tpu_torch.ops import rayleigh as R
    from babelbrain_tpu_torch.pipeline import acoustic as A

    calls = [0, 0]
    names = ("rayleigh_field", "rayleigh_field_grid")
    saved = {(m, n): getattr(m, n) for m in (R, A) for n in names}

    def counted(fn, slot):
        def call(*args, **kwargs):
            calls[slot] += 1
            return fn(*args, **kwargs)
        return call

    for (m, n), fn in saved.items():
        setattr(m, n, counted(fn, names.index(n)))
    try:
        yield calls
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


# steps of the slice-input check: half before the DFT window's start, half
# inside it, from zero fields at the full source amplitude
SLICE_CHECK_STEPS = 40


def slice_source(cfg, dom):
    """(grid, point amplitude, ``VolumeSource`` or None) of the FDTD pass
    of a slice that injects in-kernel: the refocusing's backward run from a
    stress point at the target (``run_acoustic_sim``), or the dome's
    volumetric tissue pass (``run_dome_sim``), rebuilt from the slice's own
    domain and configuration as those functions build it."""
    from babelbrain_tpu_torch.ops.fdtd_sources import VolumeSource
    from babelbrain_tpu_torch.pipeline.acoustic import (
        _make_grid,
        make_volume_source,
    )
    from babelbrain_tpu_torch.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        amplitude_for_1w,
        build_transducer,
    )

    spec = TRANSDUCER_REGISTRY[cfg.tx_system]
    if spec.kind != "dome":
        return (_make_grid(dom, "stress_point", dom.focal_idx),
                cfg.source_amp_pa, None)
    amp = (amplitude_for_1w(spec, cfg.frequency, cfg.ppw) if cfg.drive_1w
           else cfg.source_amp_pa)
    tx = build_transducer(spec, cfg.frequency)
    u0 = np.full(tx.num_subelements, amp, np.complex64)
    grid = _make_grid(dom, "velocity_volume")
    return (grid, 0.0, VolumeSource.from_sparse(
        make_volume_source(dom, tx, u0), grid.shape, cfg.device))


def check_slice_inputs(tag, dom, grid, point_amp=0.0, volume_source=None,
                       source_plane=None, monitor_ijk=None, device="cuda"):
    """The kernels against their plain versions on the card, on the inputs a
    slice's FDTD pass gave them: its domain, materials and grid, with its
    stress point, its volumetric source or its complex ``source_plane``;
    with ``monitor_ijk`` also the diagnostics (all 14 maps and the series
    at those voxels, every window step, sampled by the MONITOR kernels),
    and one step more sampling every voxel (``full_capture_step``). Both
    run ``SLICE_CHECK_STEPS`` steps across the window's start; every field
    (velocities, pressure or stresses, memories, psi slabs, accumulators,
    peak, maps, series) must be equal bit for bit. Returns the difference
    (0) keyed by the kernel rows that ran."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_extras as E

    plane = (None, None) if source_plane is None else (np.abs(source_plane),
                                                        np.angle(source_plane))
    step, st_k, co, oz, vsrc = F.fdtd_setup(
        dom.material_map, dom.materials, grid, *plane,
        reflector_mask=dom.meta.get("reflector_mask"),
        volume_source=volume_source, device=device,
    )
    st_p = _copy_state(st_k)
    n0 = max(0, grid.sensor_start - SLICE_CHECK_STEPS // 2)
    diags = ()
    if monitor_ijk is not None:
        index = E.monitor_index(monitor_ijk, grid.shape, device)
        steps = range(grid.sensor_start, n0 + SLICE_CHECK_STEPS)
        diags = [E.Diagnostics.create(st, grid.sensor_start, E.SEL_MAPS,
                                      sample_steps=steps, index=index)
                 for st in (st_k, st_p)]
    reset_counts()
    for n in range(n0, n0 + SLICE_CHECK_STEPS):
        mon = [d.monitor(n) for d in diags] or [None, None]
        step(st_k, co, grid, n, oz, point_amp, vsrc, mon[0])
        plain_step(st_p, co, grid, n, oz, point_amp, vsrc, mon[1])
        if diags:
            diags[0].record(st_k, n)
            diags[1].record(st_p, n, plain=True)
    if diags:
        full_capture_step(tag, step, st_k, st_p, co, grid,
                          n0 + SLICE_CHECK_STEPS, oz, point_amp, vsrc)
    if device == "cuda":
        torch.cuda.synchronize()
    launches, _ = read_counts()
    bad = state_diff(st_k, st_p)
    if diags:
        pairs = [(k, a, diags[1].extras.acc[k])
                 for k, a in diags[0].extras.acc.items()]
        pairs.append(("sensor_series", diags[0].series, diags[1].series))
        bad += [(name, e) for name, a, b in pairs if (e := _equal(a, b))]
    peak = float(st_p.peak.max())
    what = (f"{vsrc.n_src} source voxels" if vsrc is not None
            else f"stress point at {grid.source_ijk}" if point_amp
            else "plane source")
    if diags:
        what += (f", 14 maps and {len(monitor_ijk)} monitors over steps "
                 f"{grid.sensor_start}-{n0 + SLICE_CHECK_STEPS - 1}")
    ran = sorted(k for k, v in launches.items() if v)
    print(f"{tag} kernels vs plain on this slice's inputs: grid {grid.shape},"
          f" {what}, steps {n0}-{n0 + SLICE_CHECK_STEPS - 1} (window from "
          f"{grid.sensor_start}): peak |p| {peak:.6g} Pa; fields differing "
          f"{bad}; kernels {ran}")
    if bad or not np.isfinite(peak) or peak <= 0:
        fail(f"{tag}: the kernels disagree with their plain versions on the "
             f"slice's inputs (field, max abs diff): {bad}; peak {peak}")
    return {k: 0.0 for k in ran}


def beam_axis_monitors(dom):
    """(K, 3) FDTD-grid voxels: the target, then the beam axis through it
    (along z) over the mask frame's z range."""
    fi, fj, fk = (int(v) for v in dom.focal_idx)
    zl, zr = dom.offsets[4:]
    ks = np.arange(zl, dom.material_map.shape[2] - zr)
    return np.array([[fi, fj, fk]] + [[fi, fj, k] for k in ks])


def to_mask_frame(dom, ijk):
    """(K, 3) FDTD-grid voxels -> their indices in the mask frame of the
    exported arrays (``crop_and_unflip``, as ``TargetLocation``)."""
    ijk = np.asarray(ijk)
    xl, _, yl, _, zl, _ = dom.offsets
    return np.stack([ijk[:, 0] - xl, ijk[:, 1] - yl,
                     dom.mask_shape[2] - 1 - (ijk[:, 2] - zl)], 1)


def run_stages(cfg, labels, aff, ct, target, direction, params, mask_shape,
               diagnostics=(), t1=None, n_steps=None):
    """The stage functions ``run_case`` calls, in its order (no files
    written): CT mode with a CT volume (a ZTE or PETRA MRI first turned
    into a pseudo-CT, by ``cfg.ct_type``; with ``cfg.coregister`` and
    ``t1`` = (T1, its affine) first registered to the T1 on the card, the
    registration's wall time, statistics and peak device memory under the
    result's ``"coreg"``), label mode with ``ct=None``; a
    dome transducer runs ``run_dome_sim``, any other ``run_acoustic_sim``
    with ``cfg.do_refocus`` and, with ``diagnostics`` (``sel_maps`` names:
    all 14, or the reference's Step 2 selection ``SENSOR_MAPS``), those
    maps and the pressure series at ``beam_axis_monitors``. Step 3 runs
    ``run_sonication`` on one ``params`` entry, or ``run_all_combinations``
    (chained, no files) on a list of them. ``n_steps`` cuts the domain's
    FDTD steps (its DFT window kept whole)."""
    from babelbrain_tpu_torch.materials.ct_mapping import map_hu_to_properties
    from babelbrain_tpu_torch.pipeline.acoustic import (
        position_transducer,
        run_acoustic_sim,
        run_dome_sim,
    )
    from babelbrain_tpu_torch.pipeline.domain import (
        build_ct_materials,
        build_domain,
        build_label_materials,
        fit_domain_offsets,
    )
    from babelbrain_tpu_torch.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        amplitude_for_1w,
        build_transducer,
    )
    from babelbrain_tpu_torch.pipeline.runner import (
        coregister_to_t1,
        make_pseudo_ct,
    )
    from babelbrain_tpu_torch.pipeline.step1 import generate_mask
    from babelbrain_tpu_torch.pipeline.thermal import (
        run_all_combinations,
        run_sonication,
    )
    from babelbrain_tpu_torch.utils.timing import stage_timer

    spec = TRANSDUCER_REGISTRY[cfg.tx_system]
    ct_mode = ct is not None
    is_dome = spec.kind == "dome"
    ct_type = cfg.ct_type.upper()
    ct_aff, coreg = aff, None
    if ct_mode and ct_type in ("ZTE", "PETRA"):
        if cfg.coregister and t1 is not None:
            cuda = cfg.device == "cuda"
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            coreg = {"stats": []}
            t0 = time.time()
            ct, coreg["params"], coreg["quality"] = coregister_to_t1(
                ct, aff, *t1, device=cfg.device, stats=coreg["stats"])
            coreg["seconds"] = time.time() - t0
            coreg["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                                   else None)
            ct_aff = t1[1]
        ct = make_pseudo_ct(ct_type, ct, ct_aff, labels, aff, cfg.zte_range,
                            device=cfg.device)
    with stage_timer("Step1 domain generation", level=2, step=1):
        s1 = generate_mask(
            labels, aff, target, direction, cfg.frequency, cfg.ppw,
            shape=mask_shape, ct_data=ct,
            ct_affine=ct_aff if ct_mode else None,
            hu_threshold=(cfg.density_threshold if ct_type == "DENSITY"
                          else cfg.hu_threshold), device=cfg.device,
        )
    with stage_timer("Step2 acoustic simulation", level=2, step=2):
        if ct_mode:
            rho, sos, att = map_hu_to_properties(
                s1.unique_hu, cfg.frequency, cfg.mapping_method,
                is_petra=ct_type == "PETRA",
                density_input=s1.unique_hu if ct_type == "DENSITY" else None,
            )
            materials = build_ct_materials(cfg.frequency, cfg.segment_brain,
                                           rho, sos, att)
        else:
            materials = build_label_materials(cfg.frequency,
                                              cfg.segment_brain)
        source_amp = cfg.source_amp_pa
        if cfg.drive_1w:
            source_amp = amplitude_for_1w(spec, cfg.frequency, cfg.ppw)
        offsets, shrinks = fit_domain_offsets(
            np.flip(s1.mask, axis=2), s1.dx_mm * 1e-3, spec.diameter,
            spec.focal_length, dome=is_dome,
        )
        air = s1.air_mask if ct_mode and s1.air_mask.any() else None
        dom = build_domain(
            s1.mask, cfg.frequency, cfg.ppw, materials=materials,
            ct_index_map=s1.ct_index if ct_mode else None, air_mask=air,
            offsets=offsets, shrink_cells=shrinks,
            shape_bucket=cfg.shape_bucket,
        )
        if n_steps:
            dom = dataclasses.replace(dom, n_steps=n_steps,
                                      sensor_start=n_steps - (
                                          dom.n_steps - dom.sensor_start))
        tx = build_transducer(spec, cfg.frequency)
        monitors = beam_axis_monitors(dom) if diagnostics else None
        if is_dome:
            result = run_dome_sim(dom, tx, source_amp, device=cfg.device)
        else:
            tx = position_transducer(tx, dom, spec.focal_length)
            diag = (dict(sel_maps=tuple(diagnostics), monitor_ijk=monitors)
                    if diagnostics else {})
            result = run_acoustic_sim(dom, tx, source_amp,
                                      do_refocus=cfg.do_refocus,
                                      device=cfg.device, **diag)
    data = result.data_for_sim
    with stage_timer("Step3 thermal simulation", level=2, step=3):
        args = (result.p_amp, np.asarray(data["p_amp_water"]),
                data["MaterialMap"], materials, dom.dx, data["TargetLocation"])
        kw = dict(ct_mode=ct_mode, segmented=cfg.segment_brain,
                  frequency=cfg.frequency, tx_is_dome=is_dome,
                  device=cfg.device)
        if isinstance(params, list):
            profile, _ = run_all_combinations(*args, params, out_base=None,
                                              concatenate=True, **kw)
            thermal = profile[-1]
        else:
            thermal = run_sonication(*args, params, **kw)
    return {"step1": s1, "domain": dom, "acoustic": result,
            "thermal": thermal, "data_for_sim": data, "monitor_ijk": monitors,
            "tx": tx, "coreg": coreg}


# the FDTD steps the dome slices run: their domains' own (DomeTx at 220
# kHz, 6 PPW: 6750 in CT mode, 4125 in label mode)
DOME_CT_STEPS = 6750
DOME_STEPS = {"dome-ct": DOME_CT_STEPS, "dome-label": 4125}
# the slices of phase 4: (CT volume given?, transducer, frequency,
# refocusing?, 1 W calibrated drive?); a "diag" slice asks for every
# diagnostic (the 14 maps and the beam-axis series)
SLICES = {
    "ct": (True, "CTX_500", F0, False, False),
    "label": (False, "CTX_500", F0, False, False),
    "diag-ct": (True, "CTX_500", F0, False, False),
    "diag-label": (False, "CTX_500", F0, False, False),
    # the CT slice asking for the reference's own Step 2 selection: the
    # Pressure RMS / peak maps and the beam-axis pressure sensors, its
    # window through the fluid sweep's extras instantiations
    "sensors-ct": (True, "CTX_500", F0, False, False),
    "refocus-ct": (True, "CTX_500", F0, True, False),
    "refocus-label": (False, "CTX_500", F0, True, False),
    # the DomeTx's other published frequency: at 670 kHz the dome-fitted
    # domain would hold ~30x the cells
    "dome-ct": (True, "DomeTx", 220e3, False, True),
    # dome-ct's case in label mode: its tissue pass in shear media
    "dome-label": (False, "DomeTx", 220e3, False, True),
    # the CT slice from a synthetic ZTE MRI of the head (pseudo-CT first)
    "zte-ct": (True, "CTX_500", F0, False, False),
    # zte-ct with the MRI moved off the head and registered to its T1 first
    "coreg-zte": (True, "CTX_500", F0, False, False),
}


def run_slice(have_h5py: bool, mode="ct", mask_shape=MASK_SHAPE,
              device="cuda", params=None):
    """One main path on the digital head (``SLICES[mode]``): CT mode (CT
    volume given: fluid FDTD) or label mode (labels only: viscoelastic
    FDTD), with refocusing, with the DomeTx driven volumetrically, with
    every diagnostic (and, in CT mode, the raw capture after it), or with
    the reference's Step 2 selection (sensors-ct). Returns the launch
    counts of the run."""
    from babelbrain_tpu_torch.ops.fdtd_extras import SEL_MAPS
    from babelbrain_tpu_torch.pipeline.acoustic import _make_grid
    from babelbrain_tpu_torch.pipeline.runner import CaseConfig, run_case
    from babelbrain_tpu_torch.pipeline.thermal import SonicationParams
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    with_ct, tx_system, freq, refocus, drive_1w = SLICES[mode]
    dome = mode.startswith("dome")
    diag = mode.startswith("diag")
    sensors = mode.startswith("sensors")
    coreg = mode == "coreg-zte"
    zte = mode.startswith("zte") or coreg
    tag = f"[slice {mode}]"
    labels, ct, aff = build_head()
    ct = ct if with_ct else None
    t1 = None
    if zte:
        ct = zte_volume(labels)
    if coreg:
        t0 = time.time()
        ct = moved(ct)
        t1 = t1_volume(labels)
        print(f"{tag} T1 {t1[0].shape} at {T1_VOX} mm and the ZTE MRI moved "
              f"by {ZTE_MOVE[0]} deg about axis {ZTE_MOVE[1]} and "
              f"{ZTE_MOVE[2]} mm, made in {time.time() - t0:.2f} s")
    params = params or SonicationParams(
        duration_on=30.0, duration_off=30.0, duty_cycle=0.3, isppa=10.0
    )
    target, direction = [0.0, 0.0, 20.0], [0, 0, -1]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CaseConfig(tx_system=tx_system, frequency=freq, ppw=PPW,
                         mapping_method=MAPPING, do_refocus=refocus,
                         drive_1w=drive_1w, ct_type="ZTE" if zte else "CT",
                         coregister=coreg, output_dir=tmp,
                         prefix="chip_smoke", device=device)
        clear_spans()
        reset_counts()
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.time()
        with recording_bhte() as bhte_loops, counting_rayleigh() as n_ray:
            if have_h5py and not (diag or sensors or zte
                                  or mode in DOME_STEPS):
                print(f"{tag} driving run_case (h5py present)")
                res = run_case(cfg, labels, aff, target, direction, ct_data=ct,
                               ct_affine=aff if ct is not None else None,
                               thermal_params=params, mask_shape=mask_shape)
            else:
                print(f"{tag} driving the stage functions of run_case in its "
                      "order, writing no files ("
                      + ("run_case takes no sel_maps)" if diag or sensors
                         else "the pseudo-CT stage in the open)" if zte
                         else "h5py missing)"))
                res = run_stages(cfg, labels, aff, ct, target, direction,
                                 params, mask_shape,
                                 diagnostics=(SEL_MAPS if diag else
                                              SENSOR_MAPS if sensors else ()),
                                 t1=t1, n_steps=DOME_STEPS.get(mode))
            if device == "cuda":
                torch.cuda.synchronize()
        wall = time.time() - t0
        launches, plain = read_counts()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    spans = recorded_spans()
    dom = res["domain"]
    shear = int((np.asarray(dom.materials)[:, 2] > 0).sum())
    print(f"{tag} {tx_system} {freq / 1e3:g} kHz: FDTD grid "
          f"{dom.material_map.shape} ({int(np.prod(dom.material_map.shape))} "
          f"cells) n_steps {dom.n_steps} sensor_start {dom.sensor_start} ppp "
          f"{dom.ppp} materials {len(dom.materials)} ({shear} with shear); "
          f"wall {wall:.2f} s")
    for label, dt in spans:
        print(f"{tag} span {label}: {dt:.3f} s")
    setup = [round(dt, 3) for label, dt in spans
             if label.endswith("FDTD setup")]
    print(f"{tag} fdtd_setup host time of each run_fdtd (s): {setup}")

    p_amp = np.asarray(res["data_for_sim"]["p_amp"])
    th = res["thermal"]
    if not np.isfinite(p_amp).all() or p_amp.max() <= 0:
        fail(f"{mode}: p_amp not finite or empty")
    for name in ("temperature_end", "temperature_peak", "dose"):
        if not np.isfinite(getattr(th, name)).all():
            fail(f"{mode}: thermal {name} not finite")
    s1 = res["step1"]
    mask, tgt, dx_mm = s1.mask, np.asarray(s1.target_idx), s1.dx_mm
    pk = np.unravel_index(np.argmax(p_amp), p_amp.shape)
    brain = np.isin(mask, (4, 5))
    fk = np.unravel_index(np.argmax(np.where(brain, p_amp, 0.0)), p_amp.shape)
    off_mm = (np.asarray(fk) - tgt) * dx_mm
    print(f"{tag} global max p_amp {p_amp.max():.6g} Pa at "
          f"{tuple(int(v) for v in pk)} label {int(mask[pk])}")
    print(f"{tag} focal peak in the brain {p_amp[fk]:.6g} Pa at "
          f"{tuple(int(v) for v in fk)} label {int(mask[fk])}, offset from "
          f"the target {tuple(round(float(v), 2) for v in off_mm)} mm; "
          f"pressure ratio {th.pressure_ratio:.4f}; ratio losses "
          f"{th.ratio_losses:.4f}; max T {th.temperature_peak.max():.4f} C; "
          f"TI {th.metrics['TI']:.4f} TIS {th.metrics['TIS']:.4f} TIC "
          f"{th.metrics['TIC']:.4f} C")
    if dome:
        # `tests/test_runner.py:481-501`: the target region is strongly
        # driven against the field's median, and the losses are the dome's
        # peak ratio
        t = np.asarray(res["data_for_sim"]["TargetLocation"])
        near = p_amp[tuple(slice(max(v - 2, 0), v + 3) for v in t)].max()
        med = float(np.median(p_amp[p_amp > 0]))
        print(f"{tag} target 5x5x5 max {near:.6g} Pa = "
              f"{near / med:.2f}x the median positive p_amp ({med:.6g} Pa)")
        if not near > 5 * med:
            fail(f"{mode}: target region {near} <= 5 x median {med}")
        if res["acoustic"].meta.get("tx_is_dome") is not True:
            fail(f"{mode}: tx_is_dome not set")
        if not (np.isfinite(th.ratio_losses) and 0 < th.ratio_losses <= 1.5):
            fail(f"{mode}: ratio_losses {th.ratio_losses} outside (0, 1.5]")
        # the sparse volume source keeps no grid-sized host arrays
        print(f"{tag} peak RSS of this process: {rss0 / 2**20:.3f} GiB "
              f"before the slice, {rss1 / 2**20:.3f} GiB after")
    else:
        # the focal spot must form inside the brain on the beam axis:
        # within 2 mm of the target laterally and 15 mm along the beam (the
        # focal shift of the 64 mm CTX-500 bowl plus the skull's)
        if not brain[fk] or p_amp[fk] <= 0:
            fail(f"{mode}: no focal peak inside the brain")
        if np.hypot(off_mm[0], off_mm[1]) > 2.0 or abs(off_mm[2]) > 15.0:
            fail(f"{mode}: focal peak in the brain {off_mm} mm off the "
                 "target")
    if zte:
        # `tests/test_runner.py:318-321`: the pseudo-CT's bone maps into the
        # skull's HU band
        hu = np.asarray(s1.unique_hu)
        print(f"{tag} pseudo-CT bone HU {hu.min():.2f}..{hu.max():.2f} in "
              f"{len(hu)} quantised levels; {len(dom.materials)} materials")
        if not (hu.min() >= 300.0 and hu.max() <= 2100.0):
            fail(f"{mode}: pseudo-CT HU band {hu.min()}..{hu.max()} outside "
                 "300..2100")
    if coreg:
        check_coregistration(tag, res, ct, aff, t1, device)
    if refocus:
        pr = res["data_for_sim"].get("p_amp_refocus")
        if pr is None or not np.isfinite(pr).all() or pr.max() <= 0:
            fail(f"{mode}: p_amp_refocus missing, not finite or empty")
        pr = np.asarray(pr)
        fr = np.unravel_index(np.argmax(np.where(brain, pr, 0.0)), pr.shape)
        print(f"{tag} refocused: max p_amp_refocus {pr.max():.6g} Pa; at "
              f"the brain focus {pr[fk]:.6g} Pa, gain {pr[fk] / p_amp[fk]:.4f}"
              f" over the first pass; refocused brain peak {pr[fr]:.6g} Pa "
              f"at {tuple(int(v) for v in fr)}, offset from the target "
              f"{tuple(round(float(v), 2) for v in (fr - tgt) * dx_mm)} mm")

    n, s = dom.n_steps, dom.sensor_start
    fdtd, stress = ("fluid", "pressure") if with_ct else ("visco", "stress")
    runs = 2 if (refocus or dome) else 1  # plane / volumetric FDTD passes
    expect = {k: 0 for k in launches}
    # a launch a call, all on one card
    expect["rayleigh"], expect["rayleigh_grid"] = n_ray
    expect_bhte(expect, [params], device)  # the locating run + schedule
    if dome:  # the tissue and the water pass, both volumetric
        for mats in (dom.materials, dom.materials[:1]):
            expect_fused_run(expect, _make_grid(dom, "velocity_volume"),
                             mats, device=device, fuse_steps=DOME_PIN_K)
    elif sensors:  # the window through the extras sweeps, pinned
        grid = _make_grid(dom)
        expect_fused_run(expect, grid, dom.materials, device=device,
                         fuse_steps=sensors_depth(grid.shape, device),
                         sel_maps=SENSOR_MAPS, monitors=True)
    elif not diag:
        # plane and point runs: the fused sweeps by default (refocus-ct's
        # pinned at fused_depth, refocus-label's at visco_depth,
        # pinned_fuse_steps)
        pin = {"refocus-ct": fused_depth,
               "refocus-label": visco_depth}.get(mode)
        pin = pin and pin(dom.material_map.shape, device)
        expect_fused_run(expect, _make_grid(dom), dom.materials, n=runs,
                         device=device, fuse_steps=pin)
        if refocus:  # the backward run from a stress point at the target
            expect_fused_run(expect, _make_grid(dom, "stress_point",
                                                dom.focal_idx), dom.materials,
                             device=device, fuse_steps=pin)
    else:
        expect.update({f"{fdtd}_velocity": (runs + refocus) * n,
                       f"{fdtd}_{stress}": runs * s,
                       f"{fdtd}_{stress}_dft": runs * (n - s)})
        if refocus:  # the backward run from a stress point at the target
            expect[f"{fdtd}_{stress}_point"] = s
            expect[f"{fdtd}_{stress}_point_dft"] = n - s
    if diag:  # every window step: the maps, and the series (subsampling 1)
        expect[f"extras_{fdtd}"] = n - s
        expect[f"monitor_{fdtd}"] = len(range(s, n, 1))
    print(f"{tag} launches {launches}; plain calls {plain}")
    errs = {}
    if device == "cuda":
        if launches != expect:
            fail(f"{mode}: launch counts {launches} != expected {expect}")
        if any(plain.values()):
            fail(f"{mode}: plain versions ran on the main path: {plain}")
    check_bhte_runs(tag, bhte_loops, sonication_schedules(params), device)
    if refocus or dome:
        errs = check_slice_inputs(tag, dom, *slice_source(cfg, dom),
                                  device=device)
    if sensors:
        check_diagnostic_outputs(tag, res, brain, fk, fluid=True,
                                 names=SENSOR_MAPS)
    if diag:
        check_diagnostic_outputs(tag, res, brain, fk, fluid=with_ct)
        src = source_plane_of(res["data_for_sim"], dom)
        if with_ct:
            counts = check_capture(tag, res, src, device=device)
            launches = {k: v + counts[k] for k, v in launches.items()}
        errs = check_slice_inputs(tag, dom, _make_grid(dom),
                                  source_plane=src,
                                  monitor_ijk=res["monitor_ijk"],
                                  device=device)
    return launches, errs


# the card-vs-CPU registration check of slice coreg-zte: its T1 and its
# resampled ZTE MRI block-averaged by this factor (192^3 -> 64^3)
COREG_CHECK_FACTOR = 3


def _block_mean(v, f):
    n = [(s // f) * f for s in v.shape]
    v = v[: n[0], : n[1], : n[2]]
    return v.reshape(n[0] // f, f, n[1] // f, f, n[2] // f, f).mean(
        axis=(1, 3, 5))


def export_meshes(step1, prefix):
    """``export_surface_meshes`` of a Step-1 result: triangles per
    surface."""
    from babelbrain_tpu_torch.ops.voxelize import read_stl
    from babelbrain_tpu_torch.pipeline.step1 import export_surface_meshes

    files = export_surface_meshes(step1, prefix)
    return {k: len(read_stl(v)) for k, v in files.items()}


# host work that runs beside the later phases, and the checks of its
# results: [(future, check)], joined (and emptied) by ``finish_background``
# before the mesh phase, so that its loop times, idle shares and the probes
# share neither the host nor the card with it
BACKGROUND: list = []


def _host_call(fn, *args, **kw):
    """(``fn(*args, **kw)``, its seconds on the host clock)."""
    t0 = time.time()
    out = fn(*args, **kw)
    return out, time.time() - t0


def in_background(fn, *args, check, process=True, **kw):
    """Run ``fn(*args, **kw)`` beside the later phases: in a spawned process
    with two torch threads (host work that would hold this interpreter or
    the host's cores), or in a thread (``process=False``: a call that waits
    on a process of its own). ``check(result, seconds)`` runs in
    ``finish_background``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    pool = (ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=torch.set_num_threads, initargs=(2,))
        if process else ThreadPoolExecutor(1))
    job = pool.submit(_host_call, fn, *args, **kw)

    def collect():
        try:
            result, seconds = job.result()
        finally:
            pool.shutdown()
        check(result, seconds)

    BACKGROUND.append((job, collect))


def background_note(phase):
    """Print how many jobs of ``BACKGROUND`` are still running as ``phase``
    starts: its times are taken beside them."""
    n = sum(not job.done() for job, _ in BACKGROUND)
    print(f"[background] {n} of {len(BACKGROUND)} job(s) running as {phase} "
          "starts")


def finish_background():
    """Wait for every job of ``BACKGROUND`` and run its checks; prints the
    wait."""
    t0, n = time.time(), len(BACKGROUND)
    while BACKGROUND:
        BACKGROUND.pop(0)[1]()
    print(f"[background] joined {n} job(s) in {time.time() - t0:.2f} s")


def check_coregistration(tag, res, zte, aff, t1, device="cuda"):
    """Slice coreg-zte's registration: the recovered transform within 1 deg
    and 1 T1 voxel of the truth (``expected_registration``; the largest
    error over the axes, as the robustness harness's ``_recovered_error``
    takes it) and the quality gate, with its statistics per level. Then
    ``register_rigid`` on the card and on this machine's CPU on the pair
    block-averaged to 64^3, which must agree within the port's JAX parity
    band (0.25 deg, 0.25 voxel, quality 1e-3); the CPU run, and
    ``export_surface_meshes`` of the slice's Step-1 result, in processes of
    their own beside the anchors and sweep-ct (``in_background``)."""
    tmp = tempfile.TemporaryDirectory()
    shape = res["step1"].mask.shape

    def meshes_made(tris, seconds):
        tmp.cleanup()
        print(f"{tag} export_surface_meshes of the Step-1 mask {shape} (in "
              f"the background): triangles {tris} in {seconds:.2f} s")
        if sorted(tris) != ["bone", "csf", "skin"] or min(tris.values()) <= 0:
            fail(f"coreg-zte: surface meshes {tris}")

    in_background(export_meshes, res["step1"],
                  os.path.join(tmp.name, "chip_smoke"), check=meshes_made)
    check_registration(tag, res, zte, aff, t1, device)


def check_registration(tag, res, zte, aff, t1, device):
    """The registration checks of ``check_coregistration``."""
    from babelbrain_tpu_torch.ops import imaging as im
    from babelbrain_tpu_torch.pipeline.coreg import (
        register_rigid,
        registration_ok,
    )

    c = res["coreg"]
    t1v, t1_aff = t1
    want = expected_registration(aff, t1v.shape, t1_aff)
    p = np.asarray(c["params"], np.float64)
    rot_err = float(np.rad2deg(np.abs(p[:3] - want[:3])).max())
    tr_err = float(np.abs(p[3:] - want[3:]).max())
    print(f"{tag} registration {c['seconds']:.3f} s on {device}: params "
          f"{np.round(p, 5).tolist()} (rad, T1 voxels), truth "
          f"{np.round(want, 5).tolist()}; error {rot_err:.4f} deg, "
          f"{tr_err:.4f} voxels; quality {c['quality']:.5f}")
    for st in c["stats"]:
        print(f"{tag} registration {st['stage']}: {st['evals']} loss "
              f"evaluations, {st['syncs']} host syncs, {st['seconds']:.3f} s "
              f"({1e3 * st['seconds'] / max(st['evals'], 1):.3f} ms per "
              f"evaluation)")
    if c["peak_bytes"] is not None:
        print(f"{tag} registration peak device memory "
              f"{c['peak_bytes'] / 2**30:.3f} GiB")
    if rot_err > 1.0 or tr_err > 1.0:
        fail(f"coreg-zte: recovered transform {rot_err} deg / {tr_err} voxels "
             "off the truth (limit 1, 1)")
    if not registration_ok(c["quality"]):
        fail(f"coreg-zte: registration quality {c['quality']} below the gate")

    mv = im.resample_from_to(zte, aff, t1_aff, t1v.shape, order=1,
                             device=device)
    fx = _block_mean(t1v, COREG_CHECK_FACTOR)
    mvs = _block_mean(mv, COREG_CHECK_FACTOR)
    t0 = time.time()
    pd, _, qd = register_rigid(fx, mvs, return_quality=True, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"{tag} register_rigid at {fx.shape} on {device}: "
          f"{time.time() - t0:.3f} s, params "
          f"{np.round(pd.astype(np.float64), 6).tolist()}, quality {qd:.6f}")

    def compare(cpu, seconds):
        pc, _, qc = cpu
        print(f"{tag} register_rigid at {fx.shape} on cpu (in the "
              f"background, two threads): {seconds:.3f} s, params "
              f"{np.round(pc.astype(np.float64), 6).tolist()}, quality "
              f"{qc:.6f}")
        drot = float(np.rad2deg(np.abs(pd[:3] - pc[:3])).max())
        dtr = float(np.abs(pd[3:] - pc[3:]).max())
        print(f"{tag} {device} vs cpu at {fx.shape}: {drot:.5f} deg, "
              f"{dtr:.5f} voxels, quality {abs(qd - qc):.2e}")
        if drot >= 0.25 or dtr >= 0.25 or abs(qd - qc) >= 1e-3:
            fail(f"coreg-zte: {device} and cpu registrations differ by "
                 f"{drot} deg, {dtr} voxels, quality {abs(qd - qc)}")

    in_background(register_rigid, fx, mvs, return_quality=True, device="cpu",
                  check=compare)


# the golden phase's own bands beside the reference's (tol_1 0.01, tol_5
# 0.05): peak relative error and crop L2, ~20x and ~12x above the port's
# readings on an H100 (4.3e-6 and 8.2e-5), so that a drift of orders of
# magnitude (a wrong material table, a lower-precision field) fails here
GOLDEN_BANDS = (1e-4, 1e-3)


def golden_test_module():
    """``tests/test_torch_digital_head.py`` loaded by path: the one copy of
    the reference's digital head, the golden's configuration and the golden
    figures (it imports nothing of JAX)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_digital_head.py")
    spec = importlib.util.spec_from_file_location("bb_digital_head_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_golden(device="cuda"):
    """The golden phase: the reference's digital head (96^3 at 2 mm, its
    ``build_head``) in CT mode at the golden's configuration (the HeadTest
    bowl, 500 kHz, 6 PPW, target (0, 0, 20) mm, mask 84x84x192, no Step 3)
    through ``run_case``, its HDF5 writes kept in memory where h5py is
    missing (``run_case_without`` of the test file), with the kernel counts
    set to 0 before and read after. The field must meet
    `tests/golden/digital_head_ct.npz` at the reference's bands (peak within
    1%, L2 of the central 32x32x48 crop below 0.05) and at ``GOLDEN_BANDS``,
    and its focus must lie within one grid step of the golden's. Returns the
    launch counts."""
    import pytest

    from babelbrain_tpu_torch.pipeline import io as pio
    from babelbrain_tpu_torch.pipeline.acoustic import _make_grid
    from babelbrain_tpu_torch.pipeline.profiles import TRANSDUCER_REGISTRY
    from babelbrain_tpu_torch.pipeline.runner import CaseConfig, run_case

    dh = golden_test_module()
    labels, ct, *_, aff = dh.build_head()
    TRANSDUCER_REGISTRY["HeadTest"] = dh.HEAD_TX
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp, \
                dh.run_case_without(mp) as (cap, made):
            print(f"[golden] driving run_case; replaced: {made or 'nothing'}")
            cfg = CaseConfig(tx_system="HeadTest", frequency=500e3, ppw=6.0,
                             ct_type="CT", output_dir=tmp, prefix="dh_ct",
                             device=device)
            reset_counts()
            t0 = time.time()
            with counting_rayleigh() as n_ray:
                res = run_case(cfg, labels, aff, dh.TARGET, dh.DIRECTION,
                               ct_data=ct, ct_affine=aff,
                               mask_shape=dh.MASK_SHAPE)
                if device == "cuda":
                    torch.cuda.synchronize()
            wall = time.time() - t0
            launches, plain = read_counts()
            path = res["files"]["acoustic"]
            data = (cap.files[path] if cap is not None
                    else pio.load_dict_h5(path))
    finally:
        TRANSDUCER_REGISTRY.pop("HeadTest", None)
    dom = res["domain"]
    pa, pos, peak, _ = dh.focal_metrics(data)
    f = dh.golden_figures(pa, pos, peak)
    dx = float(np.asarray(data["SpatialStep"]))
    print(f"[golden] FDTD grid {dom.material_map.shape} n_steps "
          f"{dom.n_steps}, {len(dom.materials)} materials; wall {wall:.2f} s")
    print(f"[golden] peak {peak:.6g} Pa, relative error "
          f"{f['peak_rel_err']:.6g} (tol_1: < 0.01); focus "
          f"{tuple(float(v) for v in pos)} m, {f['pos_err_m']:.6g} m from "
          f"the golden's (grid step {dx:.6g} m); crop L2 {f['crop_l2']:.6g} "
          "(tol_5: < 0.05)")
    peak_band, crop_band = GOLDEN_BANDS
    if not (f["peak_rel_err"] < min(0.01, peak_band)
            and f["crop_l2"] < min(0.05, crop_band)
            and f["pos_err_m"] <= dx * (1 + 1e-6)):
        fail(f"golden: the CT field misses tests/golden/digital_head_ct.npz "
             f"(peak < 0.01 and < {peak_band}, crop L2 < 0.05 and < "
             f"{crop_band}, focus within {dx} m): {f}")
    expect = dict.fromkeys(launches, 0)
    expect["rayleigh"], expect["rayleigh_grid"] = n_ray
    expect_fused_run(expect, _make_grid(dom), dom.materials, device=device)
    print(f"[golden] launches { {k: v for k, v in launches.items() if v} }")
    if device == "cuda":
        if launches != expect:
            fail(f"golden: launch counts {launches} != expected {expect}")
        if any(plain.values()):
            fail(f"golden: plain versions ran on the main path: {plain}")
    return launches


# slice sweep-ct: two targets 5 mm apart on the beam axis, shape-bucketed to
# one grid signature; a 3-entry thermal profile per cell (the slices'
# sonication at three duty cycles, chained); multipoint steering +-5 mm in z
SWEEP_TARGETS = {"A": [0.0, 0.0, 20.0], "B": [0.0, 0.0, 15.0]}
SWEEP_BUCKET = 32
SWEEP_DUTY = (0.1, 0.2, 0.3)
SWEEP_STEER = ([0.0, 0.0, -5e-3], [0.0, 0.0, 5e-3])


def sweep_profile():
    """The slices' sonication at ``SWEEP_DUTY``; the last entry's pause is
    30.01 s, 3001 steps: no whole number of BHTE sweeps of any K >= 2, so
    the one-step kernel runs the tail."""
    from babelbrain_tpu_torch.pipeline.thermal import SonicationParams

    return [SonicationParams(duration_on=30.0,
                             duration_off=30.01 if dc == SWEEP_DUTY[-1]
                             else 30.0, duty_cycle=dc, isppa=10.0)
            for dc in SWEEP_DUTY]


def run_sweep(have_h5py: bool, mask_shape=MASK_SHAPE, device="cuda"):
    """Slice sweep-ct, a planning session on the digital head: the CT slice's
    case at two targets (``run_cases`` with h5py, else the stage functions
    per cell), each with a 3-entry thermal profile through
    ``run_all_combinations``; the two cells must share one grid signature
    (``run_cases``' summary); then ``run_multipoint(fanout=True)`` on the
    first cell's domain (``run_fdtd_batch``, B=2). Every launch count must
    equal the steps implied and no plain version may run. After the counts:
    each case of the batch against ``run_fdtd`` of its source plane, bit for
    bit (case 1 is the one that runs on the zeroed state and the swapped
    plane). Returns the launch counts."""
    from babelbrain_tpu_torch.ops.fdtd import run_fdtd
    from babelbrain_tpu_torch.pipeline.acoustic import (
        _assemble_result,
        _make_grid,
        position_transducer,
        run_multipoint,
    )
    from babelbrain_tpu_torch.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        build_transducer,
    )
    from babelbrain_tpu_torch.pipeline.runner import CaseConfig, run_cases
    from babelbrain_tpu_torch.utils.timing import (
        clear_spans,
        recorded_spans,
        stage_timer,
    )

    tag = "[slice sweep-ct]"
    labels, ct, aff = build_head()
    profile = sweep_profile()
    direction = [0, 0, -1]
    spec = TRANSDUCER_REGISTRY["CTX_500"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CaseConfig(tx_system="CTX_500", frequency=F0, ppw=PPW,
                         mapping_method=MAPPING, shape_bucket=SWEEP_BUCKET,
                         output_dir=tmp, prefix="sweep", device=device)
        clear_spans()
        reset_counts()
        t0 = time.time()
        with counting_rayleigh() as n_ray:
            with recording_bhte() as bhte_loops:
                if have_h5py:
                    print(f"{tag} driving run_cases (h5py present)")
                    out = run_cases(cfg, labels, aff, SWEEP_TARGETS, direction,
                                    ct_data=ct, ct_affine=aff,
                                    thermal_params=profile,
                                    mask_shape=mask_shape, stop_on_error=True)
                    cells = {k: out[(k, cfg.frequency, cfg.ppw)]
                             for k in SWEEP_TARGETS}
                    summary = out.summary
                else:
                    print(f"{tag} driving the stage functions of run_case per "
                          "cell, writing no files (h5py missing)")
                    cells = {
                        k: run_stages(dataclasses.replace(cfg,
                                                          prefix=f"sweep_{k}"),
                                      labels, aff, ct, t, direction, profile,
                                      mask_shape)
                        for k, t in SWEEP_TARGETS.items()
                    }
                    # run_cases' count of the cells' distinct grid signatures
                    sigs = {_make_grid(c["domain"]) for c in cells.values()}
                    summary = {
                        "cases": len(cells),
                        "fdtd_executable_builds": len(sigs),
                        "fdtd_executable_reuses": len(cells) - len(sigs)}
            dom = cells["A"]["domain"]
            tx = position_transducer(build_transducer(spec, F0), dom,
                                     spec.focal_length)
            with stage_timer("Step2 multipoint", level=2, step=2):
                points, combined = run_multipoint(
                    dom, tx, SWEEP_STEER, cfg.source_amp_pa, fanout=True,
                    device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
        launches, plain = read_counts()
    for label, dt in recorded_spans():
        print(f"{tag} span {label}: {dt:.3f} s")
    print(f"{tag} wall {wall:.2f} s; sweep summary {summary}")
    if summary != {"cases": 2, "fdtd_executable_builds": 1,
                   "fdtd_executable_reuses": 1}:
        fail(f"sweep-ct: the cells did not share one grid signature: "
             f"{summary}")

    expect = {k: 0 for k in launches}
    # a launch a call, all on one card
    expect["rayleigh"], expect["rayleigh_grid"] = n_ray
    grids = [c["domain"] for c in cells.values()] + [dom, dom]
    for d in grids:  # the cells' runs and the batch's cases: fused sweeps
        expect_fused_run(expect, _make_grid(d), d.materials, device=device)
    for _ in cells:  # per entry: the locating run + schedule
        expect_bhte(expect, profile, device)
    for k, c in cells.items():
        d, pa = c["domain"], np.asarray(c["data_for_sim"]["p_amp"])
        th = c["thermal"]
        print(f"{tag} cell {k} target {SWEEP_TARGETS[k]}: grid "
              f"{d.material_map.shape} n_steps {d.n_steps} sensor_start "
              f"{d.sensor_start}; max p_amp {pa.max():.6g} Pa; last entry "
              f"(DC {profile[-1].duty_cycle}) max T "
              f"{th.temperature_peak.max():.4f} C, TI {th.metrics['TI']:.4f}")
        if not np.isfinite(pa).all() or pa.max() <= 0:
            fail(f"sweep-ct: cell {k} p_amp not finite or empty")
        for name in ("temperature_end", "temperature_peak", "dose"):
            if not np.isfinite(getattr(th, name)).all():
                fail(f"sweep-ct: cell {k} thermal {name} not finite")
    pall = combined["p_amp_all"]
    zk = [int(np.unravel_index(np.argmax(f), f.shape)[2]) for f in pall]
    print(f"{tag} multipoint {len(points)} points {SWEEP_STEER}: max p_amp "
          f"{[float(f.max()) for f in pall]} Pa, peaks at mask z {zk}")
    if (pall.shape[0] != 2 or not np.isfinite(pall).all()
            or not np.array_equal(combined["p_amp_max"], pall.max(axis=0))):
        fail("sweep-ct: multipoint fields missing, not finite or not "
             "combined by their maximum")
    print(f"{tag} launches {launches}; plain calls {plain}")
    if device == "cuda":
        if launches != expect:
            fail(f"sweep-ct: launch counts {launches} != expected {expect}")
        if any(plain.values()):
            fail(f"sweep-ct: plain versions ran on the main path: {plain}")
    check_bhte_runs(tag, bhte_loops, [s for _ in cells for p in profile
                                      for s in sonication_schedules(p)],
                    device)

    # each case of the batch against run_fdtd of the same source plane
    for b, point in enumerate(points):
        src = source_plane_of(point.data_for_sim, dom)
        single = run_fdtd(dom.material_map, dom.materials, _make_grid(dom),
                          source_amp=np.abs(src), source_phase=np.angle(src),
                          reflector_mask=dom.meta.get("reflector_mask"),
                          device=device)
        ref = _assemble_result(dom, np.zeros(dom.material_map.shape,
                                             np.complex64), src, single)
        bad = [k for k in ("p_amp", "p_phase")
               if not np.array_equal(getattr(ref, k), getattr(point, k))]
        print(f"{tag} run_fdtd_batch case {b} vs run_fdtd of its plane: "
              f"fields differing {bad}")
        if bad:
            fail(f"sweep-ct: batch case {b} differs from run_fdtd in {bad}")
    return launches


def source_plane_of(data, dom):
    """The complex source plane of a slice's FDTD pass, rebuilt from its
    DataForSim ``SourcePlane_re`` / ``_im`` (the plane inside the PML skirt,
    outside which ``source_plane_from_field`` zeroes it)."""
    n = dom.npml
    src = np.zeros(dom.material_map.shape[:2], np.complex64)
    src[n:-n, n:-n] = data["SourcePlane_re"] + 1j * data["SourcePlane_im"]
    return src


def check_diagnostic_outputs(tag, res, brain, fk, fluid, names=None):
    """What a diag slice's ``extra_maps`` must hold: the maps ``names`` (all
    14 by default) in the mask
    frame, finite and not empty; the sample times of every window step; at
    every monitor voxel the largest |p| of the series equal to the
    ``Pressure_peak`` map there, bit for bit; in a fluid, each Sigma map
    equal to the Pressure map of its kind, bit for bit; at the brain focus
    ``fk`` Pressure_rms / p_amp within 5% of 1/sqrt(2), and at the brain
    focus on the monitored beam axis max|series| within 3% of p_amp (the
    steady-state anchors of `tests/test_fdtd.py:395-428`)."""
    from babelbrain_tpu_torch.ops.fdtd_extras import SEL_MAPS

    names = SEL_MAPS if names is None else names
    dom, ex = res["domain"], res["acoustic"].extra_maps
    p_amp = np.asarray(res["data_for_sim"]["p_amp"])
    if set(ex) != set(names) | {"sensor_series", "sensor_times"}:
        fail(f"{tag}: extra_maps keys {sorted(ex)}")
    for name in names:
        v = ex[name]
        if (v.shape != p_amp.shape or v.dtype != np.float32
                or not np.isfinite(v).all() or not v.max() > 0):
            fail(f"{tag}: map {name} {v.shape} {v.dtype} max {v.max()}")
    n, s = dom.n_steps, dom.sensor_start
    series, times = ex["sensor_series"], ex["sensor_times"]
    mon = res["monitor_ijk"]
    if series.shape != (len(mon), n - s) or not np.isfinite(series).all():
        fail(f"{tag}: sensor_series {series.shape}, want ({len(mon)}, "
             f"{n - s}), finite")
    if not np.array_equal(times, (np.arange(s, n) * dom.dt).astype(np.float32)):
        fail(f"{tag}: sensor_times are not the window's steps")
    mf = to_mask_frame(dom, mon)
    peak_at = ex["Pressure_peak"][tuple(mf.T)]
    if not np.array_equal(np.abs(series).max(1), peak_at):
        fail(f"{tag}: max|series| differs from Pressure_peak at the monitors")
    if fluid and names == SEL_MAPS:
        for kind in ("rms", "peak"):
            for f in ("Sigmaxx", "Sigmayy", "Sigmazz"):
                if not np.array_equal(ex[f"{f}_{kind}"],
                                      ex[f"Pressure_{kind}"]):
                    fail(f"{tag}: {f}_{kind} != Pressure_{kind} in a fluid")
    rms_ratio = float(ex["Pressure_rms"][fk] / p_amp[fk])
    on_axis = brain[tuple(mf[1:].T)]  # the line (the target comes first)
    if not on_axis.any():
        fail(f"{tag}: no monitor of the beam axis lies in the brain")
    line = np.flatnonzero(on_axis) + 1
    a = line[np.argmax(p_amp[tuple(mf[line].T)])]
    amp_ratio = float(np.abs(series[a]).max() / p_amp[tuple(mf[a])])
    print(f"{tag} diagnostics: {len(names)} maps in the mask frame "
          f"{p_amp.shape}; "
          f"{len(mon)} monitors x {n - s} samples; Pressure_rms / p_amp at the "
          f"brain focus {rms_ratio:.5f} (1/sqrt 2 = {1 / np.sqrt(2):.5f}); "
          f"max|series| / p_amp at the beam axis's brain focus "
          f"{tuple(int(v) for v in mf[a])}: {amp_ratio:.5f}; max|series| == "
          f"Pressure_peak at every monitor"
          + ("; Sigma maps == Pressure maps" if fluid and names == SEL_MAPS
             else ""))
    if abs(rms_ratio * np.sqrt(2) - 1) > 0.05:
        fail(f"{tag}: Pressure_rms / p_amp {rms_ratio} not within 5% of "
             "1/sqrt(2)")
    if abs(amp_ratio - 1) > 0.03:
        fail(f"{tag}: max|series| / p_amp {amp_ratio} not within 3% of 1")


# samples of the full-volume capture, every CAPTURE_SUBSAMPLE-th step of the
# run's last CAPTURE_SAMPLES * CAPTURE_SUBSAMPLE
CAPTURE_SAMPLES, CAPTURE_SUBSAMPLE = 3, 10


def check_capture(tag, res, src, device="cuda"):
    """``run_fdtd_capture`` on a diag slice's FDTD inputs, twice: at a 5x5x5
    mask around the target over the sensor window, and over the full volume
    for ``CAPTURE_SAMPLES`` samples. Each launches what its steps imply; the
    samples equal the slice's monitor series at the same voxels and steps,
    its carrier outputs the slice's (p_amp and, in the mask frame, the peak
    equal to the Pressure and Sigma peak maps), bit for bit. Returns the
    launch counts of the two runs."""
    from babelbrain_tpu_torch.ops.fdtd import run_fdtd_capture
    from babelbrain_tpu_torch.pipeline.acoustic import _make_grid

    dom, ex = res["domain"], res["acoustic"].extra_maps
    grid = _make_grid(dom)
    n, s = grid.n_steps, grid.sensor_start
    kw = dict(source_amp=np.abs(src), source_phase=np.angle(src),
              reflector_mask=dom.meta.get("reflector_mask"), device=device)
    fi, fj, fk = (int(v) for v in dom.focal_idx)
    mask = np.zeros(grid.shape, bool)
    mask[fi - 2:fi + 3, fj - 2:fj + 3, fk - 2:fk + 3] = True
    t0 = time.time()
    reset_counts()
    cap = run_fdtd_capture(dom.material_map, dom.materials, grid,
                           t_start=s, sensor_mask=mask, **kw)
    t_vol = n - CAPTURE_SAMPLES * CAPTURE_SUBSAMPLE
    vol = run_fdtd_capture(dom.material_map, dom.materials, grid,
                           t_start=t_vol, subsample=CAPTURE_SUBSAMPLE, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = read_counts()
    # off the card (a rehearsal) the plain calls take the launches' place
    ran, other = (launches, plain) if device == "cuda" else (plain, launches)
    expect = dict({k: 0 for k in launches}, fluid_velocity=2 * n,
                  fluid_pressure=2 * s, fluid_pressure_dft=2 * (n - s),
                  monitor_fluid=(n - s) + CAPTURE_SAMPLES)
    print(f"{tag} capture: 5x5x5 mask x {n - s} samples and the full volume x "
          f"{CAPTURE_SAMPLES} samples (every {CAPTURE_SUBSAMPLE}th step from "
          f"{t_vol}) in {wall:.2f} s; launches {launches}")
    if ran != expect or any(other.values()):
        fail(f"{tag}: capture launches {launches} (plain {plain}), expected "
             f"{expect}")

    mon, series = res["monitor_ijk"], ex["sensor_series"]
    col = {tuple(v): c for c, v in enumerate(cap["sensor_ijk"])}
    in_mask = [(i, col[tuple(v)]) for i, v in enumerate(mon) if tuple(v) in col]
    rows = np.arange(CAPTURE_SAMPLES) * CAPTURE_SUBSAMPLE + (
        t_vol + CAPTURE_SUBSAMPLE - 1 - s)
    zsrc = dom.source_z + 1
    p_amp = cap["p_amp"].copy()
    p_amp[:, :, :zsrc] = 0
    bad = [what for what, ok in (
        ("mask times", np.array_equal(cap["times"], ex["sensor_times"])),
        ("mask series", len(in_mask) >= 5 and all(
            np.array_equal(cap["series"][:, c], series[i])
            for i, c in in_mask)),
        ("volume series", np.array_equal(
            vol["series"][(slice(None),) + tuple(mon.T)], series[:, rows].T)),
        ("p_amp", np.array_equal(dom.crop_and_unflip(p_amp),
                                 res["data_for_sim"]["p_amp"])),
        ("peak", np.array_equal(dom.crop_and_unflip(cap["peak"]),
                                ex["Pressure_peak"])),
        ("volume carrier", all(np.array_equal(vol[k], cap[k])
                               for k in ("p_amp", "p_phase", "peak"))),
    ) if not ok]
    print(f"{tag} capture vs the slice: {len(in_mask)} monitors in the mask "
          f"and {len(mon)} in the volume samples; differing {bad}")
    if bad:
        fail(f"{tag}: the capture differs from the slice's run: {bad}")
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the anchors slice
# ---------------------------------------------------------------------------

# the shear anchor of `tests/test_shear_anchor.py` (its own grid): water and
# a lossless elastic solid at 500 kHz, 9 cells a water wavelength
SHEAR_F0, SHEAR_C = 500e3, 1500.0
SHEAR_FLUID = (1000.0, SHEAR_C)
SHEAR_SOLID = (1896.5, 2494.0, 1400.0)
SHEAR_SHAPE = (32, 224, 144)
SHEAR_ALPHA_W = 10.0  # water loss of the oblique runs (Np/m)


def _shear_run(idx, mats, centre, width, ncyc, device):
    """p_amp of a plane source (a super-Gaussian strip along y about
    ``centre``) through ``idx`` / ``mats`` (`tests/test_shear_anchor.py`
    ``_run_normal`` / ``_run_tilted``)."""
    from babelbrain_tpu_torch.ops.fdtd import FDTDGrid, run_fdtd, stable_dt

    dx = SHEAR_C / SHEAR_F0 / 9
    ppp = int(np.ceil(1 / SHEAR_F0 / stable_dt(dx, SHEAR_SOLID[1], cfl=0.5)))
    ns = ncyc * ppp
    grid = FDTDGrid(shape=SHEAR_SHAPE, dx=dx, dt=1 / SHEAR_F0 / ppp,
                    n_steps=ns, frequency=SHEAR_F0, sensor_start=ns - 2 * ppp,
                    source_plane_z=13)
    jj = np.arange(SHEAR_SHAPE[1])
    amp = np.zeros(SHEAR_SHAPE[:2], np.float32)
    amp[:] = (60e3 * np.exp(-((jj - centre) / width) ** 8))[None, :]
    amp[:12] = 0
    amp[-12:] = 0
    return run_fdtd(idx, mats, grid, source_amp=amp,
                    source_phase=np.zeros(SHEAR_SHAPE[:2], np.float32),
                    device=device)["p_amp"]


def _tilted_slab(theta_deg, d_cells):
    """The slab of ``d_cells`` cells tilted by ``theta_deg`` about x."""
    th = np.deg2rad(theta_deg)
    idx = np.zeros(SHEAR_SHAPE, np.uint8)
    jj, kk = np.mgrid[0:SHEAR_SHAPE[1], 0:SHEAR_SHAPE[2]]
    s = -np.sin(th) * (jj - 112.0) + np.cos(th) * (kk - 62.0)
    idx[:, (s >= 0) & (s < d_cells)] = 1
    return idx


def anchor_shear(device="cuda"):
    """`tests/test_shear_anchor.py:130-185` on the port: normal incidence
    through 6- and 10-cell elastic slabs (the viscoelastic kernels) within
    5% of ``solid_layer_transmission``; 25 deg through a tilted slab within
    5% of the elastic analytic value, and a slab without shear within 20%
    of the no-shear value and below 0.75x the elastic one."""
    from babelbrain_tpu_torch.pipeline.benchmark import (
        solid_layer_transmission as layer,
    )

    dx = SHEAR_C / SHEAR_F0 / 9
    tag = "[slice anchors] shear"
    t0 = time.time()
    mats = np.array([[1000.0, SHEAR_C, 0.0, 0.0, 0.0],
                     [*SHEAR_SOLID, 0.0, 0.0]])
    pw = _shear_run(np.zeros(SHEAR_SHAPE, np.uint8), mats[:1], 60.0, 40.0,
                    16, device)
    bad = []
    for d in (6, 10):
        idx = np.zeros(SHEAR_SHAPE, np.uint8)
        idx[:, :, 50:50 + d] = 1
        ps = _shear_run(idx, mats, 60.0, 40.0, 16, device)
        t_sim = ps[16, :, 90].max() / pw[16, :, 90].max()
        t_an = abs(layer(0.0, SHEAR_F0, d * dx, SHEAR_FLUID, SHEAR_SOLID)[0])
        err = abs(t_sim - t_an) / t_an
        print(f"{tag} normal incidence, {d}-cell slab: |T| {t_sim:.5f} "
              f"against the analytic {t_an:.5f} ({err:+.2%}; band 5%)")
        if not err < 0.05:
            bad.append(f"normal {d}")
    th = np.deg2rad(25.0)
    mats_e = np.array([[1000.0, SHEAR_C, 0.0, SHEAR_ALPHA_W, 0.0],
                       [*SHEAR_SOLID, 0.0, 0.0]])
    mats_f = mats_e.copy()
    mats_f[1, 2] = 0.0
    pw = _shear_run(np.zeros(SHEAR_SHAPE, np.uint8), mats_e[:1], 112.0, 55.0,
                    30, device)
    corr = np.exp(-SHEAR_ALPHA_W * 6 * dx / np.cos(th))
    sel = (16, slice(30, -30), 112)
    t_el = _shear_run(_tilted_slab(25.0, 6), mats_e, 112.0, 55.0, 30,
                      device)[sel].max() / pw[sel].max() * corr
    t_ctl = _shear_run(_tilted_slab(25.0, 6), mats_f, 112.0, 55.0, 30,
                       device)[sel].max() / pw[sel].max() * corr
    t_an = abs(layer(th, SHEAR_F0, 6 * dx, SHEAR_FLUID, SHEAR_SOLID)[0])
    t_no = abs(layer(th, SHEAR_F0, 6 * dx, SHEAR_FLUID,
                     (SHEAR_SOLID[0], SHEAR_SOLID[1], 1e-6))[0])
    print(f"{tag} 25 deg, 6-cell tilted slab: elastic |T| {t_el:.5f} against "
          f"the analytic {t_an:.5f} ({(t_el - t_an) / t_an:+.2%}; band 5%); "
          f"without shear {t_ctl:.5f} against the no-shear {t_no:.5f} "
          f"({(t_ctl - t_no) / t_no:+.2%}; band 20%) and {t_ctl / t_an:.3f}x "
          f"the elastic value (below 0.75x); {time.time() - t0:.2f} s")
    if not abs(t_el - t_an) / t_an < 0.05:
        bad.append("oblique elastic")
    if not (abs(t_ctl - t_no) / t_no < 0.20 and t_ctl < 0.75 * t_an):
        bad.append("oblique control")
    if bad:
        fail(f"shear anchor outside its bands: {bad}")


# the O'Neil water anchor of `tests/test_benchmark_anchor.py`: the
# inter-comparison's bowl (64 mm aperture and radius of curvature) at
# 500 kHz, 60 kPa surface drive, 6 PPW, focus at the origin
ONEIL_C, ONEIL_RHO = 1500.0, 1000.0
ONEIL_ROC = ONEIL_APERTURE = 64e-3
ONEIL_P0 = 60e3
ONEIL_NPML = 12


def oneil_pressure(points, n_theta=4000, n_phi=720, device="cuda"):
    """|p| at field points by direct quadrature of the Rayleigh integral
    over the spherical cap (O'Neil 1949), focus at the origin: the truth
    of `tests/test_benchmark_anchor.py:44`, independent of the port's
    Rayleigh (float64 on ``device``)."""
    f64 = dict(dtype=torch.float64, device=device)
    k = 2 * np.pi * F0 / ONEIL_C
    tmax = np.arcsin(ONEIL_APERTURE / 2 / ONEIL_ROC)
    th = (torch.arange(n_theta, **f64) + 0.5) * (tmax / n_theta)
    ph = (torch.arange(n_phi, **f64) + 0.5) * (2 * np.pi / n_phi)
    st, ct = torch.sin(th), torch.cos(th)
    cap = torch.stack([torch.outer(ONEIL_ROC * st, torch.cos(ph)).ravel(),
                       torch.outer(ONEIL_ROC * st, torch.sin(ph)).ravel(),
                       (-ONEIL_ROC * ct).repeat_interleave(n_phi)], 1)
    ds = (ONEIL_ROC**2 * st * (tmax / n_theta) * (2 * np.pi / n_phi)
          ).repeat_interleave(n_phi)
    out = np.empty(len(points))
    for i, p in enumerate(np.asarray(points, np.float64)):
        r = torch.linalg.norm(cap - torch.as_tensor(p, **f64), dim=1)
        val = torch.sum(ds * torch.polar(1.0 / r, k * r))
        out[i] = abs(1j * k / (2 * np.pi) * ONEIL_P0 * complex(val))
    return out


def oneil_axis(z_vals, device="cuda"):
    """On-axis |p| (the exact 1-D quadrature of the same integral)."""
    f64 = dict(dtype=torch.float64, device=device)
    k = 2 * np.pi * F0 / ONEIL_C
    tmax = np.arcsin(ONEIL_APERTURE / 2 / ONEIL_ROC)
    n = 200_000
    th = (torch.arange(n, **f64) + 0.5) * (tmax / n)
    st, ct = torch.sin(th), torch.cos(th)
    out = np.empty(len(z_vals))
    for i, z in enumerate(np.asarray(z_vals, np.float64)):
        r = torch.sqrt((ONEIL_ROC * st) ** 2 + (z + ONEIL_ROC * ct) ** 2)
        val = complex(torch.sum(torch.polar(ONEIL_ROC**2 * st / r, k * r)))
        out[i] = abs(1j * k * ONEIL_P0 * val * (tmax / n))
    return out


def width_m6db(x, y):
    """-6 dB full width of profile y(x), linearly interpolated."""
    pk = int(np.argmax(y))
    half = y[pk] * 10 ** (-6 / 20)

    def cross(direction):
        i = pk
        while 0 < i < len(y) - 1 and y[i] > half:
            i += direction
        j = i - direction
        f = (y[j] - half) / (y[j] - y[i])
        return x[j] + f * (x[i] - x[j])

    return abs(cross(1) - cross(-1))


def bowl_source_plane(x_vec, z_src, device="cuda"):
    """The velocity plane that drives the FDTD with the bowl's field: the
    normal velocity (as rho c vz) on the plane z = ``z_src`` over
    ``x_vec`` x ``x_vec``, zero in the PML skirt. The pressure P comes
    from the port's ``rayleigh_field`` on the card; dP/dz from its values
    on four more planes (central differences at h = dx/4 and dx/2,
    Richardson-extrapolated), and vz = i dP/dz / (k rho c) with the sign
    that meets the plane-wave limit vz = p / (rho c) at the beam centre
    (`tests/test_benchmark_anchor.py:106`'s exact normal velocity, in the
    repository's phasor convention)."""
    from babelbrain_tpu_torch.ops.rayleigh import rayleigh_field
    from babelbrain_tpu_torch.tx import make_focused_bowl

    tx = make_focused_bowl(F0, ONEIL_ROC, ONEIL_APERTURE, ONEIL_C,
                           ppw_surface=6.0)
    u0 = np.full(tx.num_subelements, ONEIL_P0, np.complex64)
    k = 2 * np.pi * F0 / ONEIL_C
    h = (x_vec[1] - x_vec[0]) / 4
    xp, yp = np.meshgrid(x_vec, x_vec, indexing="ij")

    def field(z):
        pts = np.stack([xp.ravel(), yp.ravel(), np.full(xp.size, z)], 1)
        return rayleigh_field(k, tx.centers, tx.areas, u0, pts,
                              device=device).astype(np.complex128)

    p = field(z_src)
    f = {m: field(z_src + m * h) for m in (-2, -1, 1, 2)}
    d1 = (f[1] - f[-1]) / (2 * h)
    d2 = (f[2] - f[-2]) / (4 * h)
    dpdz = (4 * d1 - d2) / 3
    i_pk = int(np.argmax(np.abs(p)))
    cands = [sgn * 1j * dpdz / k for sgn in (1, -1)]
    vz = min(cands, key=lambda v: abs(v[i_pk] - p[i_pk]))
    plane = vz.reshape(xp.shape)
    n = ONEIL_NPML
    plane[:n] = plane[-n:] = 0
    plane[:, :n] = plane[:, -n:] = 0
    return plane, tx.num_subelements


def anchor_water(device="cuda"):
    """`tests/test_benchmark_anchor.py:190-233` on the port: the bowl's
    field in water through the fluid kernels, driven on a plane 24 mm
    before the focus, against O'Neil's: focal pressure, focal position
    (1.5 cells), -6 dB axial length and lateral width, each within 5%.
    Returns what the slab runs reuse."""
    from babelbrain_tpu_torch.ops.fdtd import FDTDGrid, run_fdtd, stable_dt

    tag = "[slice anchors] O'Neil water"
    t0 = time.time()
    dx = ONEIL_C / F0 / PPW
    n = ONEIL_NPML
    z_src = -24e-3
    n_lat = 88
    shape = (n_lat + 2 * n, n_lat + 2 * n,
             int(round((24e-3 + 16e-3) / dx)) + 2 * n + 2)
    zsrc = n + 1
    i0 = shape[0] // 2
    z_vec = (np.arange(shape[2]) - zsrc) * dx + z_src
    x_vec = (np.arange(shape[0]) - i0) * dx
    plane, n_sub = bowl_source_plane(x_vec, z_src, device)
    t_plane = time.time() - t0
    ppp = int(np.ceil(1 / F0 / stable_dt(dx, ONEIL_C, 0.5)))
    dt = 1 / F0 / ppp
    n_steps = (int(np.ceil(60e-3 / ONEIL_C / dt)) // ppp + 3) * ppp
    grid = FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=n_steps, frequency=F0,
                    npml=n, sensor_start=n_steps - 2 * ppp,
                    source_plane_z=zsrc)
    out = run_fdtd(np.zeros(shape, np.uint8),
                   np.array([[ONEIL_RHO, ONEIL_C, 0.0, 0.0, 0.0]]), grid,
                   source_amp=np.abs(plane), source_phase=np.angle(plane),
                   device=device)
    t_run = time.time() - t0 - t_plane
    axis = out["p_amp"][i0, i0, :]
    sel = slice(zsrc + 6, len(z_vec) - 14)
    zf = int(np.argmax(axis[sel])) + sel.start
    z_ref = np.linspace(-18e-3, 10e-3, 281)
    p_ref = oneil_axis(z_ref, device)
    l_fdtd = width_m6db(z_vec[sel], axis[sel])
    z_long = np.linspace(-18e-3, 12e-3, 601)
    l_ref = width_m6db(z_long, oneil_axis(z_long, device))
    lat = out["p_amp"][:, i0, zf]
    x_ref = np.linspace(-4e-3, 4e-3, 81)
    w_ref = width_m6db(x_ref, oneil_pressure(np.stack(
        [x_ref, np.zeros_like(x_ref), np.full_like(x_ref, z_vec[zf])], 1),
        device=device))
    w_fdtd = width_m6db(x_vec, lat)
    got = dict(focal_pressure=(axis[zf], p_ref.max()),
               axial_m6db=(l_fdtd, l_ref), lateral_m6db=(w_fdtd, w_ref))
    z_off = z_vec[zf] - z_ref[int(np.argmax(p_ref))]
    print(f"{tag}: grid {shape}, {n_steps} steps, source plane from the "
          f"Rayleigh of {n_sub} sub-elements ({t_plane:.2f} s), run_fdtd "
          f"{t_run:.2f} s; focus {z_vec[zf] * 1e3:.3f} mm ({z_off * 1e3:+.3f} "
          f"mm from O'Neil's, band {1.5 * dx * 1e3:.2f} mm); "
          + "; ".join(f"{k} {a:.6g} against {b:.6g} ({(a - b) / b:+.2%})"
                      for k, (a, b) in got.items())
          + f" (band 5%); {time.time() - t0:.2f} s with the quadratures")
    bad = [k for k, (a, b) in got.items() if not abs(a - b) / b < 0.05]
    if abs(z_off) >= 1.5 * dx:
        bad.append("focal position")
    if bad:
        fail(f"O'Neil water anchor outside its bands: {bad}")
    return dict(out=out, plane=plane, x_vec=x_vec, z_vec=z_vec, i0=i0,
                zsrc=zsrc, dx=dx, oneil_peak=p_ref.max(),
                oneil_z=z_ref[int(np.argmax(p_ref))], oneil_axial=l_ref)


# the slab of `tests/test_benchmark_anchor.py:236`: the inter-comparison's
# skull (2800 m/s, 1850 kg/m^3, lossless), 12 cells thick, 14 cells past
# the source plane (17 mm before the focus)
SLAB_C, SLAB_RHO = 2800.0, 1850.0
SLAB_CELLS, SLAB_AFTER_SOURCE = 12, 14
# the inter-comparison's whole domain (Aubry et al., JASA 2022): 70 x 70 x
# 120 mm (the bowl's apex to 56 mm past the focus), the PML outside it
FULL_DOMAIN_MM = (70.0, 70.0, 120.0)


def _slab_medium(shape, k0):
    """A benchmark medium (the dict ``load_benchmark_file`` returns): water
    with the slab at z-cells [k0, k0 + SLAB_CELLS), TestType 2."""
    from babelbrain_tpu_torch.pipeline.benchmark import _with_material_array

    mat_map = np.zeros(shape, np.uint32)
    mat_map[:, :, k0:k0 + SLAB_CELLS] = 1
    return _with_material_array({
        "Materials": [
            {"Density": ONEIL_RHO, "LongSoS": ONEIL_C, "ShearSoS": 0.0,
             "LongAtt": 0.0, "ShearAtt": 0.0},
            {"Density": SLAB_RHO, "LongSoS": SLAB_C, "ShearSoS": 0.0,
             "LongAtt": 0.0, "ShearAtt": 0.0},
        ],
        "MaterialMap": mat_map, "TestType": 2,
    })


def _focus_past(p_amp, i0, z_vec, start):
    """(peak p_amp on the axis from z-cell ``start`` to 14 cells before the
    end, its z)."""
    axis = p_amp[i0, i0, :]
    sel = slice(start, len(axis) - 14)
    k = int(np.argmax(axis[sel])) + sel.start
    return axis[k], z_vec[k]


def anchor_slab(water, device="cuda"):
    """`tests/test_benchmark_anchor.py:236` on the port, through
    ``run_benchmark_acoustic``'s loaded-medium helper: the water anchor's
    beam through the slab, its focal pressure against the water run's
    within 15% of the analytic slab transmission, its focus moved toward
    the bowl by 0.9-2x the paraxial ray shift. Returns (focal pressure,
    the cut-down run's grid)."""
    from babelbrain_tpu_torch.pipeline.benchmark import _run_loaded_benchmark

    tag = "[slice anchors] benchmark-file slab"
    t0 = time.time()
    zsrc, i0, plane = water["zsrc"], water["i0"], water["plane"]
    shape = water["out"]["p_amp"].shape
    k0 = zsrc + SLAB_AFTER_SOURCE
    out = _run_loaded_benchmark(_slab_medium(shape, k0), F0, PPW,
                                np.abs(plane), np.angle(plane),
                                source_plane_z=zsrc, device=device)
    dxb = out["grid"].dx
    z_src = water["z_vec"][zsrc]
    zb = (np.arange(shape[2]) - zsrc) * dxb + z_src
    p_w, zf_w = _focus_past(water["out"]["p_amp"], i0, water["z_vec"],
                            zsrc + 6)
    p_s, zf_s = _focus_past(out["p_amp"], i0, zb, k0 + 14)
    t_real = SLAB_CELLS * dxb
    z1, z2 = ONEIL_RHO * ONEIL_C, SLAB_RHO * SLAB_C
    k2 = 2 * np.pi * F0 / SLAB_C
    t_an = 1.0 / np.sqrt(np.cos(k2 * t_real) ** 2 + 0.25 * (
        z2 / z1 + z1 / z2) ** 2 * np.sin(k2 * t_real) ** 2)
    shift_ref = -t_real * (SLAB_C / ONEIL_C - 1.0)
    shift = zf_s - zf_w
    print(f"{tag}: grid {shape}, {out['grid'].n_steps} steps; focal "
          f"pressure {p_s:.6g} Pa, {p_s / p_w:.5f}x the water run's against "
          f"the analytic transmission {t_an:.5f} "
          f"({(p_s / p_w - t_an) / t_an:+.2%}; band 15%); focus moved "
          f"{shift * 1e3:+.3f} mm, {abs(shift / shift_ref):.3f}x the paraxial "
          f"{shift_ref * 1e3:+.3f} mm (band 0.9-2x, toward the bowl); "
          f"{time.time() - t0:.2f} s")
    if not (abs(p_s / p_w - t_an) / t_an < 0.15 and shift < 0
            and 0.9 * abs(shift_ref) <= abs(shift) <= 2.0 * abs(shift_ref)):
        fail("benchmark-file slab anchor outside its bands")
    return p_s, out["grid"]


def anchor_full_width(water, p_cut, device="cuda"):
    """The water and the slab anchor on the inter-comparison's whole domain
    (``FULL_DOMAIN_MM`` at 500 kHz and 6 PPW, the PML outside it): the
    bowl's field on a plane 1.4 mm past its rim, the slab at the same
    distance before the focus as in the cut-down run. The water focus must
    meet O'Neil's focal pressure and -6 dB axial and lateral sizes within
    5% (its position, after 54 mm of propagation at 6 PPW where the
    cut-down run has 24, is printed); the slab's focus must move toward
    the bowl, and its pressure is printed next to the cut-down run's (the
    slab's echo meets the hard source plane 37 mm upstream here, 7 mm in
    the cut-down run). Prints the grid, the steps, the ``run_fdtd`` spans
    and the fluid kernels' launches of each run."""
    from babelbrain_tpu_torch.pipeline.benchmark import _run_loaded_benchmark
    from babelbrain_tpu_torch.utils.timing import (
        clear_spans,
        recorded_spans,
    )

    tag = "[slice anchors] full width"
    t0 = time.time()
    dx = ONEIL_C / F0 / PPW
    n = ONEIL_NPML
    cells = [int(round(mm * 1e-3 / dx)) for mm in FULL_DOMAIN_MM]
    shape = tuple(c + 2 * n for c in cells)
    z_lo = -ONEIL_ROC - n * dx  # the grid's first plane: apex minus the PML
    z_rim = -np.sqrt(ONEIL_ROC**2 - (ONEIL_APERTURE / 2) ** 2)
    zsrc = int(np.ceil((z_rim + 1.4e-3 - z_lo) / dx))
    z_vec = np.arange(shape[2]) * dx + z_lo
    i0 = shape[0] // 2
    x_vec = (np.arange(shape[0]) - i0) * dx
    plane, _ = bowl_source_plane(x_vec, z_vec[zsrc], device)
    k0 = zsrc + int(round((-17e-3 - z_vec[zsrc]) / dx))
    print(f"{tag}: grid {shape} ({int(np.prod(shape))} cells, "
          f"{FULL_DOMAIN_MM} mm + PML), source plane at "
          f"{z_vec[zsrc] * 1e3:.2f} mm (z-cell {zsrc}), slab at z-cells "
          f"{k0}-{k0 + SLAB_CELLS - 1}")
    focus, p_amp = {}, {}
    for slab in (False, True):
        medium = _slab_medium(shape, k0)
        if not slab:
            medium["MaterialMap"][:] = 0
        before = read_counts()[0]
        clear_spans()
        out = _run_loaded_benchmark(medium, F0, PPW, np.abs(plane),
                                    np.angle(plane), source_plane_z=zsrc,
                                    device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        spans = {label.split(": ", 1)[-1]: dt
                 for label, dt in recorded_spans()}
        after = read_counts()[0]
        b1 = {k: after[k] - before[k] for k in
              ("fluid_velocity", "fluid_pressure", "fluid_pressure_dft",
               "fluid_fused", "fluid_fused_dft")}
        if not np.isfinite(out["p_amp"]).all():
            fail(f"full-width {'slab' if slab else 'water'} run not finite")
        p_amp[slab] = out["p_amp"]
        focus[slab] = _focus_past(out["p_amp"], i0, z_vec,
                                  k0 + 14 if slab else zsrc + 6)
        print(f"{tag} {'slab' if slab else 'water'}: {out['grid'].n_steps} "
              f"steps; spans " + ", ".join(f"{k} {v:.3f} s"
                                           for k, v in spans.items())
              + f"; launches {b1}; focal pressure {focus[slab][0]:.6g} Pa "
              f"at {focus[slab][1] * 1e3:.2f} mm")
    (p_w, z_w), (p_s, z_s) = focus[False], focus[True]
    axis = p_amp[False][i0, i0, :]
    sel = slice(zsrc + 6, len(z_vec) - 14)
    x_ref = np.linspace(-4e-3, 4e-3, 81)
    w_ref = width_m6db(x_ref, oneil_pressure(np.stack(
        [x_ref, np.zeros_like(x_ref), np.full_like(x_ref, z_w)], 1),
        device=device))
    kf = int(np.argmin(np.abs(z_vec - z_w)))
    got = dict(focal_pressure=(p_w, water["oneil_peak"]),
               axial_m6db=(width_m6db(z_vec[sel], axis[sel]),
                           water["oneil_axial"]),
               lateral_m6db=(width_m6db(x_vec, p_amp[False][:, i0, kf]),
                             w_ref))
    print(f"{tag}: water " + "; ".join(
        f"{k} {a:.6g} against O'Neil's {b:.6g} ({(a - b) / b:+.2%})"
        for k, (a, b) in got.items())
        + f" (band 5%); focus {(z_w - water['oneil_z']) * 1e3:+.3f} mm from "
        f"O'Neil's; slab focal pressure {p_s / p_w:.5f}x the water run's "
        f"({p_s / p_cut:.5f}x the cut-down slab run's {p_cut:.6g} Pa), "
        f"focus moved {(z_s - z_w) * 1e3:+.3f} mm; {time.time() - t0:.2f} s")
    bad = [k for k, (a, b) in got.items() if not abs(a - b) / b < 0.05]
    if bad or not z_s < z_w:
        fail(f"full-width anchor: water {bad} off O'Neil's, or the slab's "
             "focus not moved toward the bowl")


# the calibration anchor: the CTX-500's known ring weights
# (`tests/test_pipeline.py:708`), profiles along its axis at two locations
CALIB_W_TRUE = np.array([1.15, 0.85 * np.exp(0.25j), 1.05 * np.exp(-0.2j),
                         0.9], np.complex64)
CALIB_Z_MM = np.arange(35.0, 75.0, 1.0)
CALIB_LOCS = (45.0, 60.0)


def anchor_calibration(device="cuda"):
    """`tests/test_pipeline.py::TestCalibrationIngestion::
    test_calibration_recovers_ring_weights` on the card: the CTX-500 at its
    full sub-element count, amplitude and phase profiles synthesised with
    the port's Rayleigh from known ring weights on top of each location's
    steering, written as CSV, read back and fitted by
    ``calibrate_annular_from_profiles`` (``run_calibration`` writes HDF5);
    the weights within 5% in amplitude and 0.08 rad in phase, residual
    below 0.05."""
    from babelbrain_tpu_torch.ops.rayleigh import (
        rayleigh_field,
        steering_phases,
    )
    from babelbrain_tpu_torch.pipeline import calibration as Cal
    from babelbrain_tpu_torch.pipeline.profiles import (
        TRANSDUCER_REGISTRY,
        build_transducer,
    )

    tag = "[slice anchors] calibration"
    spec = TRANSDUCER_REGISTRY["CTX_500"]
    k = 2 * np.pi * F0 / 1500.0
    tx = build_transducer(spec, F0, sos_water=1500.0)
    outplane = spec.meta["natural_outplane"]
    t0 = time.time()
    amp, ph = [], []
    for loc in CALIB_LOCS:
        w_steer = steering_phases(k, Cal._ring_centers(tx),
                                  [0.0, 0.0, loc * 1e-3 - outplane],
                                  device=device)
        u0 = Cal._expand_ring_weights(tx, w_steer * CALIB_W_TRUE)
        pts = np.zeros((len(CALIB_Z_MM), 3), np.float32)
        pts[:, 2] = CALIB_Z_MM * 1e-3 - outplane
        f = rayleigh_field(k, tx.centers, tx.areas, u0, pts, device=device)
        amp.append(np.abs(f))
        ph.append(np.angle(f))
    t_synth = time.time() - t0
    with tempfile.TemporaryDirectory() as d:
        files = []
        for name, cols in (("amp", amp), ("phase", ph)):
            rows = [",".join(["0"] + [f"{v}" for v in CALIB_LOCS])]
            rows += [",".join([f"{z}"] + [f"{c[i]}" for c in cols])
                     for i, z in enumerate(CALIB_Z_MM)]
            files.append(os.path.join(d, f"{name}.csv"))
            with open(files[-1], "w") as fh:
                fh.write("\n".join(rows))
        z_mm, locs, vals = Cal.load_hydrophone_profiles(files[0])
        _, _, phases = Cal.load_hydrophone_profiles(files[1])
    t1 = time.time()
    fits = Cal.calibrate_annular_from_profiles(
        spec, F0, z_mm, locs, vals, phases, lam=1e-6, device=device)
    t_fit = time.time() - t1
    bad = []
    for loc, fit in fits.items():
        w = np.asarray(fit["weights"], np.complex128)
        w = w * np.exp(1j * (np.angle(CALIB_W_TRUE[0]) - np.angle(w[0])))
        amp_err = np.abs(np.abs(w) / np.abs(CALIB_W_TRUE) - 1).max()
        ph_err = np.abs(np.angle(w / CALIB_W_TRUE)).max()
        print(f"{tag} {loc:g} mm: ring weights (amplitude, phase) "
              + ", ".join(f"({abs(v):.4f}, {np.angle(v):+.4f})" for v in w)
              + " against "
              + ", ".join(f"({abs(v):.4f}, {np.angle(v):+.4f})"
                          for v in CALIB_W_TRUE)
              + f": amplitude {amp_err:.3%} (band 5%), phase {ph_err:.4f} rad "
              f"(band 0.08), residual {fit['residual']:.3e} (below 0.05)")
        if not (amp_err < 0.05 and ph_err < 0.08 and fit["residual"] < 0.05):
            bad.append(loc)
    print(f"{tag}: CTX-500, {tx.num_subelements} sub-elements in "
          f"{tx.num_elements} rings, {len(CALIB_Z_MM)} axial points x "
          f"{len(CALIB_LOCS)} locations; Rayleigh synthesis {t_synth:.3f} s, "
          f"the fit (its Rayleigh columns and the solve) {t_fit:.3f} s")
    if bad:
        fail(f"calibration did not recover the ring weights at {bad}")


def anchor_workers(device="cuda"):
    """The CT slice's ``generate_mask`` (``run_stages``' call: the digital
    head, CTX-500 at 500 kHz and 6 PPW, ``MASK_SHAPE``) on the card in this
    process and through ``workers.calculate_mask_process`` in a spawned
    child that opens its own CUDA context (waited on in a thread beside
    sweep-ct, ``in_background``): every array of the two results equal.
    Prints the child's wall time."""
    from babelbrain_tpu_torch.pipeline.step1 import generate_mask
    from babelbrain_tpu_torch.pipeline.workers import (
        ERROR_SENTINEL,
        calculate_mask_process,
    )

    tag = "[slice anchors] workers"
    labels, ct, aff = build_head()
    kw = dict(labels_data=labels, labels_affine=aff,
              target_ras=[0.0, 0.0, 20.0], direction_ras=[0, 0, -1],
              frequency=F0, ppw=PPW, shape=MASK_SHAPE, ct_data=ct,
              ct_affine=aff, hu_threshold=300.0, device=device)
    here = generate_mask(**kw)
    logs = []

    def compare(child, wall):
        names = ("mask", "affine", "target_idx", "ct_index", "unique_hu",
                 "air_mask")
        differ = [n for n in names
                  if not np.array_equal(getattr(child, n), getattr(here, n))]
        print(f"{tag}: generate_mask of the CT slice in a spawned child "
              f"({wall:.2f} s wall, beside sweep-ct; {len(logs)} log "
              f"lines) and in this process: mask {child.mask.shape}, "
              f"{len(child.unique_hu)} HU levels; arrays differing {differ}")
        if differ or any(ln.strip() == ERROR_SENTINEL for ln in logs):
            fail(f"the spawned Step 1 differs from the in-process one: "
                 f"{differ}")

    in_background(calculate_mask_process, on_log=logs.append, check=compare,
                  process=False, **kw)


def run_anchors(device="cuda"):
    """The anchors slice: the shear, O'Neil water, benchmark-file slab and
    full-width anchors through ``run_fdtd`` (and the benchmark helper) on
    the card, the CTX-500 calibration and a spawned Step 1, with the kernel
    counts set to 0 before and read after: both FDTD families must have
    launched on the route ``fuse_steps=None`` takes (each family's pair
    while its default depth, ``FUSE_BEST`` / ``VISCO_FUSE_BEST``, is 0, else
    its sweep) and no plain version run. Returns the launch counts."""
    from babelbrain_tpu_torch.ops.fdtd_fused_kernels import FUSE_BEST
    from babelbrain_tpu_torch.ops.fdtd_visco_fused_kernels import (
        VISCO_FUSE_BEST,
    )

    t0 = time.time()
    reset_counts()
    anchor_shear(device)
    water = anchor_water(device)
    p_cut, _ = anchor_slab(water, device)
    anchor_full_width(water, p_cut, device)
    anchor_calibration(device)
    anchor_workers(device)
    if device == "cuda":
        torch.cuda.synchronize()
    launches, plain = read_counts()
    print(f"[slice anchors] {time.time() - t0:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    need = (("visco_fused", "visco_fused_dft") if VISCO_FUSE_BEST >= 2
            else ("visco_velocity", "visco_stress", "visco_stress_dft")) + (
        ("fluid_fused", "fluid_fused_dft") if FUSE_BEST >= 2
        else ("fluid_velocity", "fluid_pressure", "fluid_pressure_dft"))
    if device == "cuda" and (any(plain.values())
                             or not all(launches[k] for k in need)):
        fail(f"anchors: launches {launches}, plain calls {plain}")
    return launches


# ---------------------------------------------------------------------------
# mesh: the x decomposition on one card
# ---------------------------------------------------------------------------

# shards of the mesh phase, all on one card (devices= named explicitly);
# the slices whose run_fdtd calls it replays on them
MESH_SHARDS = 4
MESH_SLICES = ("ct", "label", "diag-ct", "dome-ct", "refocus-ct",
               "refocus-label")
# of the refocus slices only their backward run (a stress point: sharded,
# it keeps the pair, step by step)
MESH_POINT_ONLY = ("refocus-ct", "refocus-label")
# the slices whose run_fdtd calls go through the fused sweeps by default:
# each call is run again through the pair, step by step, and must equal it
FUSED_SLICES = ("ct", "label", "sensors-ct", "refocus-ct", "refocus-label",
                "zte-ct", "coreg-zte", "dome-ct", "dome-label")
# the run_fdtd call (its place among dome-ct's calls) the mesh phase replays
# with fuse_steps=1, through pair + scatter with 2 ghost planes (the path of
# a volumetric run that keeps the pair), the slice's other calls as they
# were made: dome-ct's water pass
DOME_CT_PAIR_REPLAY = 1
# the steps the mesh phase replays dome-ct's calls at, against an unsharded
# run at that depth (the DFT window kept whole): all of DOME_CT_STEPS would
# not fit the time limit
DOME_CT_REPLAY_STEPS = 450
MESH_CHECK_STEPS = 40
# the mesh phase's 2-D part, every shard on one card: the (nx, ny) cuts the
# kernels are checked on (corner, x-edge and y-interior shards; shards that
# hold both x edges and one y edge), the recorded run_fdtd calls replayed on
# (nx, ny) meshes (of the refocus slice its backward point run, of dome-ct
# its pair + scatter pass), and the cut of the CT slice's run_acoustic_sim
MESH_2D_KERNELS = ((2, 4), (1, 2))
MESH_2D_REPLAYS = {"label": (4, 2), "diag-ct": (2, 2), "refocus-ct": (2, 4),
                   "dome-ct": (2, 2)}
MESH_2D_CT = (2, 4)
# mode -> [(function name, args, kwargs, result, loop seconds)] of the
# pipeline calls a slice made (``recording``)
RECORDED: dict = {}
RECORDED_FUNCTIONS = ("run_fdtd", "run_fdtd_batch", "rayleigh_field_grid",
                      "run_acoustic_sim")


@contextlib.contextmanager
def recording(mode):
    """While slice ``mode`` runs, keep the arguments and results of the
    calls the Step 2 pipeline makes (``pipeline.acoustic``'s names):
    every ``run_fdtd`` and ``run_fdtd_batch``, in the ``RAYLEIGH_SLICES``
    their first forward Rayleigh over the whole grid, for the Rayleigh
    kernel's check and the mesh phase to replay, and the CT slice's
    ``run_acoustic_sim`` (its result's DataForSim arrays)."""
    from babelbrain_tpu_torch.pipeline import acoustic as A
    from babelbrain_tpu_torch.utils.timing import recorded_spans

    calls = RECORDED.setdefault(mode, [])
    saved = {name: getattr(A, name) for name in RECORDED_FUNCTIONS}

    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "rayleigh_field_grid" and (
                    mode not in RAYLEIGH_SLICES
                    or any(c[0] == name for c in calls)):
                return out
            if name == "run_acoustic_sim" and mode != "ct":
                return out
            loop = next((dt for label, dt in reversed(recorded_spans())
                         if label.endswith("FDTD time loop")), None)
            res = out.data_for_sim if name == "run_acoustic_sim" else out
            kept = ({k: np.array(v) if isinstance(v, np.ndarray) else v
                     for k, v in res.items()} if isinstance(res, dict)
                    else np.array(res))
            calls.append((name, args, kwargs, kept, loop))
            return out
        return call

    for name, fn in saved.items():
        setattr(A, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(A, name, fn)


def expect_fused_run(expect, grid, materials, n=1, device="cuda",
                     fuse_steps=None, sel_maps=(), monitors=False):
    """Add the launches ``n`` calls of ``run_fdtd`` on ``grid`` make in
    ``materials`` (fluid, or shear media) with a plane, point or
    volumetric source and no diagnostics: the fused sweeps and the pair's
    tail steps of ``ops.fdtd.fused_schedule`` at the depths ``fused_plan``
    / ``visco_plan`` / ``volume_plan`` / ``visco_volume_plan`` take on the
    card (``fuse_steps`` as the calls passed it; a volumetric run's sweeps
    are ``fluid_halo``'s or ``visco_halo``'s, its tail steps scatter
    too). With ``sel_maps`` among Pressure_rms / Pressure_peak and / or
    ``monitors`` (every window step sampled) a fluid run in ``extras_plan``'s
    schedule: its window sweeps are the extras sweep's, its window's tail
    steps take the MONITOR sample and the maps' pass."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops.fdtd_fused_kernels import fused_key
    from babelbrain_tpu_torch.ops.fdtd_halo_kernels import halo_key
    from babelbrain_tpu_torch.ops.fdtd_kernels import pressure_key
    from babelbrain_tpu_torch.ops.fdtd_visco_halo_kernels import (
        halo_key as visco_halo_key,
    )

    mats = np.asarray(materials, np.float64)
    viscous = F.sls_coefficients(mats, grid.frequency, grid.dt)["viscous"]
    point = 0 if F.point_index(grid) is not None else None
    visco = bool(np.any(mats[:, 2] > 0))
    volume = grid.source_type == "velocity_volume"
    fam, stem = ("visco", "visco_stress") if visco else ("fluid",
                                                         "fluid_pressure")
    extras = bool(sel_maps) or monitors
    if volume:
        plan = (F.visco_volume_plan(grid, fuse_steps) if visco
                else F.volume_plan(fuse_steps))
    elif extras:
        plan = F.extras_plan(grid.shape, device, viscous, point is not None,
                             fuse_steps)
    else:
        plan = (F.visco_plan if visco else F.fused_plan)(
            grid.shape, device, viscous, point is not None, fuse_steps)
    for _, k, dft in F.fused_schedule(grid, plan):
        if k == 1:
            expect[f"{fam}_velocity"] += n
            expect[pressure_key(stem, dft, point)] += n
            expect["volume_source"] += n * volume
            if extras and dft:
                expect["extras_fluid"] += n * ("Pressure_rms" in sel_maps)
                expect["monitor_fluid"] += n * monitors
        elif extras and dft:
            expect[fused_key(True, point, True)] += n
        elif volume:
            expect[visco_halo_key(dft) if visco
                   else halo_key(True, dft)] += n
        else:
            expect[pressure_key(f"{fam}_fused", dft, point)] += n


def sonication_schedules(params):
    """The two ``bhte_run`` schedules ``pipeline.thermal.run_sonication``
    runs for a profile entry of one group and one repetition: the locating
    run (the on time) and the sonication (on, then off)."""
    if params.grouped_sonications != 1 or params.repetitions != 1:
        raise ValueError("one group of one repetition expected")
    n_on = int(round(params.duration_on / 0.01))
    n_off = int(round(params.duration_off / 0.01))
    return [[(0, n_on, True)],
            [(0, n_on, True)] + ([(0, n_off, False)] if n_off else [])]


def expect_bhte(expect, profile, device="cuda"):
    """Add the launches Step 3 makes for each entry of ``profile``: the
    sweeps and one-step tails of both its schedules (``ops.bhte
    .schedule_launches``) at the depth ``bhte_run`` takes on ``device``."""
    from babelbrain_tpu_torch.ops import bhte as B

    k = B.fuse_depth(None, device)
    for params in profile:
        for sched in sonication_schedules(params):
            for key, v in B.schedule_launches(sched, k).items():
                expect[key] += v


@contextlib.contextmanager
def recording_bhte():
    """While Step 3 runs, keep each ``bhte_run`` loop's inputs (the start
    T, dose and peak cloned before the loop updates them), its depth, its
    result and its seconds (host clock; the loop ends in a readback)."""
    from babelbrain_tpu_torch.ops import bhte as B

    loops, loop = [], B._bhte_loop

    def call(Q, co, T, dose, peak, *rest):
        start = (T.clone(), dose.clone(), peak.clone())
        t0 = time.time()
        res = loop(Q, co, T, dose, peak, *rest)
        loops.append((Q, co, start, rest, res, time.time() - t0))
        return res

    B._bhte_loop = call
    try:
        yield loops
    finally:
        B._bhte_loop = loop


def check_bhte_runs(tag, loops, schedules, device="cuda"):
    """Each ``bhte_run`` loop a slice made (``recording_bhte``), in the
    order ``schedules`` lists them, run again from its start one step a
    launch (``fuse_steps=1``: ``bhte_step`` only): temperature, peak and
    dose must be equal bit for bit, the monitors at the sampled steps
    (``ops.bhte.monitor_steps``) too. Prints both loops' seconds; the
    counts of these launches are set aside."""
    from babelbrain_tpu_torch.ops import bhte as B

    if [lp[3][2] for lp in loops] != schedules:
        fail(f"{tag}: Step 3 ran {[lp[3][2] for lp in loops]}, expected "
             f"{schedules}")
    saved = read_counts()
    for Q, co, (T, dose, peak), rest, res, secs in loops:
        *head, k = rest
        t0 = time.time()
        one = B._bhte_loop(Q, co, T, dose, peak, *head, 1)
        secs1 = time.time() - t0
        sched = head[2]
        bad = [n for n in ("temperature", "peak_temperature", "dose")
               if not np.array_equal(getattr(res, n), getattr(one, n))]
        if not np.array_equal(res.monitor_steps, B.monitor_steps(sched, k)):
            bad.append("monitor_steps")
        elif not np.array_equal(res.monitor,
                                one.monitor[:, res.monitor_steps]):
            bad.append("monitor")
        print(f"{tag} bhte_run {tuple(T.shape)} {sched}: K={k} "
              f"{B.schedule_launches(sched, k)} loop {secs:.3f} s, one step a "
              f"launch {secs1:.3f} s ({secs / secs1:.3f}x); max T "
              f"{float(res.peak_temperature.max()):.4f} C; differing {bad}")
        if bad:
            fail(f"{tag}: bhte_run with K={k} differs from fuse_steps=1 in "
                 f"{bad}")
    restore_counts(*saved)


# the slices whose first forward Rayleigh over the whole grid is recorded
# for the Rayleigh kernel's check (the CT slice's 10.5 M points and the
# CTX-500's sources; dome-ct's 51.8 M points and the DomeTx's sources), the
# points of it the check takes, evenly spread, its band against the plain
# version (of the peak |p| at those points) and the points it also holds
# to float64
RAYLEIGH_SLICES = ("ct", "dome-ct")
RAYLEIGH_CHECK_POINTS = 2**18
RAYLEIGH_BAND = 2e-5
RAYLEIGH_F64_POINTS = 256
# float32 operations of a point-source pair: r^2 (3 differences, 3 squares,
# 2 sums), the square root, the reciprocal, the phase's product, its cosine
# and sine, the 2 products of the amplitude and the complex multiply-add
# (8); 2 more (a product and exp) with an attenuation. Of them, the
# transcendental ones a pair (the reciprocal square root, the sine and the
# cosine; the exponential with an attenuation) also run on the SFU, 16 a
# clock an SM (H100: 132 SMs, the clock nvidia-smi reports as
# clocks.max.sm).
RAYLEIGH_OPS_PER_PAIR = 23
RAYLEIGH_SFU_PER_PAIR = 3
SFU_PER_SM_CLOCK = 16


def sfu_ops_per_s():
    """Transcendental operations a second the card's SFUs issue at most:
    16 a clock an SM x SMs x the card's maximum SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_SM_CLOCK * sms * mhz * 1e6, mhz, sms


def rayleigh_bound(n_points, n_src, attenuated, sfu_rate):
    """(least ms, "operations", float32 ms, SFU ms) of a Rayleigh sum:
    the larger of its float32 operations over 67 TFLOP/s and its
    transcendental ones over ``sfu_rate``; the bytes (20 a point and a
    source) are far below either."""
    pairs = n_points * n_src
    t_fp = pairs * (RAYLEIGH_OPS_PER_PAIR + 2 * attenuated) / FP32_FLOP_PER_S
    t_sfu = pairs * (RAYLEIGH_SFU_PER_PAIR + attenuated) / sfu_rate
    t_bytes = 20 * (n_points + n_src) / HBM_BYTES_PER_S
    assert t_bytes < max(t_fp, t_sfu)
    return max(t_fp, t_sfu) * 1e3, "operations", t_fp * 1e3, t_sfu * 1e3


def check_rayleigh_run(mode, device="cuda"):
    """The forward Rayleigh that slice ``mode`` ran over its whole grid
    (``recording``: ``rayleigh_field_grid``), with every source: the
    point-list form (``rayleigh_sum``) at ``RAYLEIGH_CHECK_POINTS`` of its
    points, evenly spread, and the grid form (``rayleigh_sum_grid``) on a
    slab of whole x planes in the middle of the grid of at least as many
    points, must give the slice's values there bit for bit, and the
    point-list form the grid form's on the slab; the plain version
    (``rayleigh_sum_ref``, on the same device and inputs) must agree with
    each form within ``RAYLEIGH_BAND`` of its own peak |p| on that form's
    points (the spread points, the slab). Each form and its plain version
    are held to a float64 evaluation at ``RAYLEIGH_F64_POINTS`` of those
    points and, on a card, timed. The counts of these launches are set
    aside. Returns ({key: max |kernel - plain|}, {key: (ms, plain ms, None)}
    or {}, {key: (bound ms, by)}) for the point-list ("rayleigh") and grid
    ("rayleigh_grid") forms."""
    from babelbrain_tpu_torch.ops import rayleigh as R

    saved = read_counts()
    _, args, kw, ref, _ = next(c for c in RECORDED[mode]
                               if c[0] == "rayleigh_field_grid")
    k, centers, areas, u0, x, y, z = _bound(
        R.rayleigh_field_grid, args, kw, "wavenumber", "centers", "areas",
        "u0", "x", "y", "z")
    kr, ki, c, w, (xs, ys, zs) = R.grid_inputs(k, centers, areas, u0, x, y,
                                               z)
    shape = (len(xs), len(ys), len(zs))
    n_all = int(np.prod(shape))
    ref = np.asarray(ref).reshape(-1)
    sel = np.unique(np.linspace(0, n_all - 1, RAYLEIGH_CHECK_POINTS)
                    .round().astype(np.int64))
    i, j, kk = np.unravel_index(sel, shape)
    pts = np.stack([xs[i], ys[j], zs[kk]], 1)
    dev = torch.device(device)
    c_t, w_t = torch.as_tensor(c, device=dev), torch.as_tensor(w, device=dev)
    p_t = torch.as_tensor(pts, device=dev)
    got = R.rayleigh_sum(kr, ki, c_t, w_t, p_t)
    plain = R.rayleigh_sum_ref(kr, ki, c_t, w_t, p_t)
    # the grid form on the middle x planes
    m = -(-RAYLEIGH_CHECK_POINTS // (shape[1] * shape[2]))
    a = max(0, (shape[0] - m) // 2)
    slab = [torch.as_tensor(v, device=dev) for v in (xs[a:a + m], ys, zs)]
    n_slab = len(slab[0]) * shape[1] * shape[2]
    got_grid = R.rayleigh_sum_grid(kr, ki, c_t, w_t, *slab)
    slab_pts = R.grid_points(*slab).contiguous()
    got_list = R.rayleigh_sum(kr, ki, c_t, w_t, slab_pts)
    forms = bool(torch.equal(got_grid, got_list))
    same = (np.array_equal(got.cpu().numpy(), ref[sel]) and np.array_equal(
        got_grid.cpu().numpy(),
        ref[a * shape[1] * shape[2]:a * shape[1] * shape[2] + n_slab]))
    plain_grid = R.rayleigh_sum_ref(kr, ki, c_t, w_t, slab_pts)

    def held(kernel, plain, points):
        """(max |kernel - plain|, peak |plain|, [kernel, plain] against
        float64 at about RAYLEIGH_F64_POINTS of the points, of the peak,
        those points' number)."""
        kernel, plain = kernel.cpu().numpy(), plain.cpu().numpy()
        err = float(np.abs(kernel - plain).max())
        scale = float(np.abs(plain).max())
        n = len(points)
        few = np.arange(0, n, max(1, n // RAYLEIGH_F64_POINTS))
        exact = R.rayleigh_sum_ref(
            kr, ki, c_t.double(), w_t.to(torch.complex128),
            points[torch.as_tensor(few, device=dev)].double()).cpu().numpy()
        return err, scale, [float(np.abs(v[few] - exact).max()) / scale
                            for v in (kernel, plain)], len(few)

    held_by = {"rayleigh": held(got, plain, p_t),
               "rayleigh_grid": held(got_grid, plain_grid, slab_pts)}
    timed = {}
    if dev.type == "cuda":
        plain_ms = _timed(lambda: R.rayleigh_sum_ref(kr, ki, c_t, w_t, p_t),
                          1, warm=0)
        timed["rayleigh"] = (
            _timed(lambda: R.rayleigh_sum(kr, ki, c_t, w_t, p_t), 3),
            plain_ms, None)
        timed["rayleigh_grid"] = (
            _timed(lambda: R.rayleigh_sum_grid(kr, ki, c_t, w_t, *slab), 3),
            _timed(lambda: R.rayleigh_sum_ref(kr, ki, c_t, w_t,
                                              R.grid_points(*slab)),
                   1, warm=0), None)
        rate, mhz, sms = sfu_ops_per_s()
    else:  # the rehearsal: an H100's 132 SMs at 1980 MHz
        rate, mhz, sms = SFU_PER_SM_CLOCK * 132 * 1980e6, 1980.0, 132
    restore_counts(*saved)
    bounds, parts = {}, {}
    for key, n in (("rayleigh", len(sel)), ("rayleigh_grid", n_slab)):
        b_ms, b_by, fp_ms, sfu_ms = rayleigh_bound(n, len(c), int(ki != 0),
                                                   rate)
        bounds[key] = (b_ms, b_by)
        parts[key] = (fp_ms, sfu_ms)
    print(f"[rayleigh] {mode} forward Rayleigh ({n_all} points {shape}, "
          f"{len(c)} sources): the point-list form at {len(sel)} of its "
          f"points and the grid form on x planes {a}..{a + m - 1} "
          f"({n_slab} points) equal the slice's values bit for bit: {same}; "
          f"the grid form equals the point list there: {forms}")
    for key, n in (("rayleigh", len(sel)), ("rayleigh_grid", n_slab)):
        err, scale, e64, n_f64 = held_by[key]
        b_ms = bounds[key][0]
        fp_ms, sfu_ms = parts[key]
        line = (f"[rayleigh]   {key}: max |kernel - plain| {err:.6g} Pa = "
                f"{err / scale:.3g} of the peak {scale:.6g} Pa (band "
                f"{RAYLEIGH_BAND:g}); against float64 at {n_f64} points "
                f"{e64[0]:.3g} (kernel) and {e64[1]:.3g} (plain) of the peak; "
                f"bound {b_ms:.3f} ms (float32 {fp_ms:.3f} ms at 67 TFLOP/s; "
                f"SFU {sfu_ms:.3f} ms at "
                f"{SFU_PER_SM_CLOCK} x {sms} SMs x {mhz:g} MHz)")
        if key in timed:
            ms, plain_ms = timed[key][:2]
            line += (f"; kernel {ms:.3f} ms ({n * len(c) / ms / 1e9:.4f} "
                     f"Tpairs/s, {b_ms / ms:.1%} of the bound), plain "
                     f"{plain_ms:.3f} ms ({plain_ms / ms:.1f}x)")
        print(line)
    if not (same and forms):
        fail(f"{mode}: the Rayleigh kernel's forms differ from each other or "
             "from the slice's forward Rayleigh")
    for key, (err, scale, _, _) in held_by.items():
        if not err <= RAYLEIGH_BAND * scale:
            fail(f"{mode}: Rayleigh kernel {key} off its plain version by "
                 f"{err} (peak {scale})")
    return {key: v[0] for key, v in held_by.items()}, timed, bounds


def check_fused_runs(mode, device="cuda"):
    """Each ``run_fdtd`` call slice ``mode`` made (``recording``), which
    went through the fused sweeps (a volumetric one through the halo
    sweep; one with the Pressure maps and monitors through the extras
    sweeps), again through the pair step by step (``fdtd_setup`` and the
    wrappers of ``ops.fdtd_kernels``, with the scatter of a volumetric
    drive, with a fresh ``Diagnostics`` taking the maps' pass and the
    MONITOR samples): the carrier maps, the extra maps and the series must
    be equal bit for bit. Prints both loops' times; the counts of these
    launches are set aside."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_extras as E
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    saved = read_counts()
    for name, args, kw, ref, loop in RECORDED.get(mode, ()):
        if name != "run_fdtd":
            continue
        kw = {k: v for k, v in kw.items() if k not in ("device", "mesh")}
        idx, mats, grid, amp, ph, pamp, refl, vs, maps, mon, sub = _bound(
            F.run_fdtd, args, kw, "mat_idx", "materials", "grid",
            "source_amp", "source_phase", "point_amp", "reflector_mask",
            "volume_source", "sel_maps", "monitor_ijk", "sensor_subsampling")
        clear_spans()
        step, st, co, oz, vsrc = F.fdtd_setup(idx, mats, grid, amp, ph, refl,
                                              vs, device=device)
        diag, sel = None, np.arange(grid.sensor_start, grid.n_steps, sub)
        if maps or mon is not None:
            diag = E.Diagnostics.create(
                st, grid.sensor_start, E.check_sel_maps(maps),
                sample_steps=sel if mon is not None else (),
                index=(None if mon is None
                       else E.monitor_index(mon, grid.shape, device)))
        F._time_loop([(step, st, co, vsrc, diag)], grid, oz, pamp)
        pair_loop = next(dt for label, dt in recorded_spans()
                         if label.endswith("FDTD time loop"))
        out = F._carrier(st, grid)
        if diag is not None and diag.extras is not None:
            out.update(diag.extras.read(grid.n_steps - grid.sensor_start))
        if mon is not None:
            out.update(F._series(diag.series.cpu().numpy(), sel, grid))
        bad = _maps_differ(ref, out)
        if set(ref) != set(out):
            bad.append(f"keys {sorted(ref)} != {sorted(out)}")
        print(f"[slice {mode}] run_fdtd {grid.shape} {grid.n_steps} steps "
              f"({grid.source_type}): fused loop {loop:.3f} s, the pair "
              f"step by step {pair_loop:.3f} s ({loop / pair_loop:.3f}x); "
              f"maps differing {bad}")
        if bad:
            fail(f"{mode}: run_fdtd through the fused sweeps differs from "
                 f"the pair in {bad}")
    restore_counts(*saved)


def mesh_case(family, source, shape=KERNEL_SHAPE):
    """(grid, materials, index, plane amplitude, phase) of the mesh phase's
    kernel checks: the kernel phase's CT table and slab (fluid) or label
    layers (visco), a plane or a point at the centre, 40 steps with the DFT
    window from step 20."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.pipeline.domain import (
        build_label_materials,
        compute_time_stepping,
    )

    if family == "fluid":
        mats = ct_table()
        idx = ct_index_volume(shape, n_mat=len(mats))
        dx = 1482.3 / F0 / PPW
        dt = 1 / F0 / int(np.ceil(1 / F0 / F.stable_dt(
            dx, mats[:, 1].max(), cfl=0.5)))
    else:
        mats = build_label_materials(F0, False)
        idx = label_index_volume(shape)
        dx, dt, _, _ = compute_time_stepping(mats, F0, PPW)
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=MESH_CHECK_STEPS,
                      frequency=F0, sensor_start=MESH_CHECK_STEPS // 2,
                      source_plane_z=13, source_type=SOURCE_TYPES[source],
                      source_ijk=tuple(n // 2 for n in shape))
    amp = np.zeros(shape[:2])
    m = max(2, shape[0] // 12)
    if source == "plane":
        amp[m:-m, m:-m] = 60e3
    ph = np.random.default_rng(1).uniform(-1.0, 1.0, shape[:2])
    return grid, mats, idx, amp, ph


def check_mesh_kernels(mesh, times, device="cuda"):
    """The four FDTD kernels with their CPML edge ownership on the shards
    of ``mesh`` (``MESH_SHARDS`` along x, or an (x, y) mesh) of the kernel
    phase's grid, against their plain versions: 40 steps of
    ``ops.fdtd.step_shards`` with a plane and with a point (on an inner
    shard), every field of every shard bit-equal; on an x mesh the
    overlap-and-discard sweeps of the plane (``check_mesh_overlap``); then
    each shard's launches timed from CUDA graphs, their sum against the
    unsharded launch (``times``) per cell. Returns the errors by row."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops import fdtd_kernels as K
    from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
    from babelbrain_tpu_torch.parallel.halo import mesh_axis_sizes

    errs = {}
    cut = mesh_axis_sizes(mesh)
    tag = "[mesh]" if cut[1] == 1 else "[mesh 2d]"
    for family in ("fluid", "visco"):
        stem = "fluid_pressure" if family == "fluid" else "visco_stress"
        vel, stress = ((K.fluid_velocity, K.fluid_pressure)
                       if family == "fluid"
                       else (V.visco_velocity, V.visco_stress))
        for source in ("plane", "point"):
            grid, mats, idx, amp, ph = mesh_case(family, source)
            pamp = POINT_AMP if source == "point" else 0.0
            runs = []
            for plain in (False, True):
                xs, shards, oz = F.shard_setup(mesh, idx, mats, grid, amp, ph)
                for n in range(grid.n_steps):
                    F.step_shards(shards, xs, grid, n, oz, pamp, plain=plain)
                runs.append(shards)
            if device == "cuda":
                torch.cuda.synchronize()
            bad = [(s, name, e) for s, (a, b) in enumerate(zip(*runs))
                   for name, e in state_diff(a.st, b.st)]
            pmax = max(float(sh.st.acc_cos.abs().max()) for sh in runs[1])
            inner = [(s, xs.coords(s)) for s, sh in enumerate(runs[0])
                     if sh.point is not None]
            print(f"{tag} {family} kernels on {mesh.size} shards {cut} of "
                  f"{grid.shape} ({[xs.planes(s) for s in range(xs.n_shards)]}"
                  f" (x, y) with ghosts; edges held (x_lo, x_hi, y_lo, y_hi) "
                  f"{[tuple(int(e) for e in xs.edges(s)) for s in range(xs.n_shards)]}"
                  f"), {source} source"
                  + (f" on shard (s, (sx, sy)) {inner}" if inner else "")
                  + f", {grid.n_steps} steps (window from "
                  f"{grid.sensor_start}) against the plain versions: max "
                  f"|DFT sum| {pmax:.6g}; fields differing {bad}")
            if bad or not np.isfinite(pmax) or pmax <= 0:
                fail(f"mesh: the {family} kernels on shards {cut} disagree "
                     f"with their plain versions ({source} source): {bad}")
            point = "_point" if source == "point" else ""
            keys = ((f"{family}_velocity",) if source == "plane" else ()) + (
                stem + point, stem + point + "_dft")
            for k in keys:
                errs[k] = 0.0
            if source == "plane" and cut[1] == 1:
                check_mesh_overlap(mesh, grid, mats, idx, amp, ph, device)
            if source != "plane" or device != "cuda":
                continue
            s = F.step_scalars(grid, 10, oz)
            calls = {
                f"{family}_velocity": lambda sh: vel(sh.st, sh.co, s[0], s[1]),
                stem: lambda sh: stress(sh.st, sh.co),
                f"{stem}_dft": lambda sh: stress(sh.st, sh.co, s[2], s[3]),
            }
            cells = [int(np.prod(xs.planes(i))) * grid.shape[2]
                     for i in range(xs.n_shards)]
            whole = float(np.prod(grid.shape))
            for k, fn in calls.items():
                per = [_timed_graph(lambda sh=sh: fn(sh), 20)
                       for sh in runs[0]]
                ratio = (sum(per) / sum(cells)) / (times[k][0] / whole)
                print(f"{tag}   {k}: shards {[round(t, 4) for t in per]} "
                      f"ms, sum {sum(per):.4f} ms over {sum(cells)} cells "
                      f"(+{sum(cells) / whole - 1:.2%} ghost planes); the "
                      f"unsharded launch {times[k][0]:.4f} ms; time per "
                      f"cell sharded / unsharded {ratio:.4f}")
    return errs


def check_mesh_overlap(mesh, grid, mats, idx, amp, ph, device="cuda"):
    """The overlap-and-discard sweeps (``ops.fdtd.sweep_shards``) of a
    plane-source case (fluid or shear media) on the mesh's shards against
    their plain versions, every field of every shard bit for bit, and the
    own planes' carrier against the unsharded run's; the fluid sweeps at
    ``FUSED_PIN_K`` while ``FUSE_BEST`` = 0 keeps such runs on the pair,
    the visco ones at ``VISCO_PIN_K`` while ``VISCO_FUSE_BEST`` = 0."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops.fdtd_fused_kernels import FUSE_BEST
    from babelbrain_tpu_torch.ops.fdtd_visco_fused_kernels import (
        VISCO_FUSE_BEST,
    )

    visco = bool(np.any(np.asarray(mats)[:, 2] > 0))
    best, pin = ((VISCO_FUSE_BEST, VISCO_PIN_K) if visco
                 else (FUSE_BEST, FUSED_PIN_K))
    plan = F.overlap_plan(mesh, mats, grid,
                          fuse_steps=None if best >= 2 else pin)
    if plan is None:
        fail(f"mesh: no overlap plan for {grid.shape} on {mesh.size} shards")
    runs = []
    for plain in (False, True):
        xs, shards, oz = F.shard_setup(mesh, idx, mats, grid, amp, ph,
                                       halo=plan[1])
        for n, k, dft in F.overlap_schedule(grid, plan[0]):
            F.sweep_shards(shards, xs, grid, n, k, dft, oz, plain=plain)
        runs.append(shards)
    if device == "cuda":
        torch.cuda.synchronize()
    bad = [(s, name, e) for s, (a, b) in enumerate(zip(*runs))
           for name, e in state_diff(a.st, b.st)]
    whole = F.run_fdtd(idx, mats, grid, amp, ph, device=device)
    mine = F._carrier_of(*(F.own_planes(xs, [getattr(sh.st, k)
                                             for sh in runs[0]])
                           for k in ("acc_cos", "acc_sin", "peak")), grid)
    differ = _maps_differ(whole, mine)
    family = "visco" if visco else "fluid"
    print(f"[mesh] {family} overlap and discard (K, H) = {plan} on "
          f"{mesh.size} shards of {grid.shape} "
          f"({[xs.planes(s) for s in range(xs.n_shards)]} planes with ghosts)"
          f", {grid.n_steps} steps (window from {grid.sensor_start}): "
          f"fields differing from the plain versions {bad}; maps differing "
          f"from the unsharded run {differ}")
    if bad or differ:
        fail(f"mesh: the overlap-and-discard sweeps differ: {bad} {differ}")


IDLE_STEPS = 300


def idle_share(args, kw, mesh=None):
    """(device-busy ms, wall ms, idle share) of ``IDLE_STEPS`` steps of a
    recorded ``run_fdtd`` call's loop (from its window's start, in its
    fused sweeps where it has them), on ``mesh`` or unsharded on the card,
    under ``torch.profiler``: the
    kernels' and copies' device time against the host clock from the first
    step to the synchronize after the last. (None, wall, None) when the
    profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from babelbrain_tpu_torch.ops import fdtd as F

    from babelbrain_tpu_torch.ops.fdtd import run_fdtd

    mat_idx, materials, grid, amp, phase, refl, vsrc = _bound(
        run_fdtd, args, kw, "mat_idx", "materials", "grid", "source_amp",
        "source_phase", "reflector_mask", "volume_source")
    # the loop as run_fdtd runs it: (first step, K, with_dft) units, each
    # a fused sweep (K > 1, or any K on the overlap path) or a step
    units = [(n, 1, n >= grid.sensor_start) for n in range(grid.n_steps)]
    if mesh is None:
        step, st, co, oz, vsrc = F.fdtd_setup(
            mat_idx, materials, grid, amp, phase, refl, vsrc, device="cuda")
        if vsrc is None:
            units = F.fused_schedule(grid, F.plan_run(
                st, grid.shape, "cuda", co.viscous, False))

        def run(n, k, dft):
            if k == 1:
                step(st, co, grid, n, oz, 0.0, vsrc)
            else:
                F.FUSED[type(st)][0](st, co, [F.step_scalars(grid, m, oz)
                                              for m in range(n, n + k)],
                                     with_dft=dft)
    else:
        plan = F.overlap_plan(mesh, materials, grid)
        xs, shards, oz = F.shard_setup(mesh, mat_idx, materials, grid, amp,
                                       phase, refl, vsrc,
                                       halo=2 if plan is None else plan[1])
        if plan is not None:
            units = F.overlap_schedule(grid, plan[0])

        def run(n, k, dft):
            if plan is None:
                F.step_shards(shards, xs, grid, n, oz)
            else:
                F.sweep_shards(shards, xs, grid, n, k, dft, oz)
    n0 = grid.sensor_start
    for u in units:  # warm
        if n0 - 20 <= u[0] < n0:
            run(*u)
    torch.cuda.synchronize()
    timed = [u for u in units if n0 <= u[0] < n0 + IDLE_STEPS]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for u in timed:
            run(*u)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    if busy <= 0:
        return None, wall, None
    return busy, wall, max(0.0, 1.0 - busy / wall)


def _bound(fn, args, kw, *names):
    """The arguments ``names`` of a recorded call ``fn(*args, **kw)``
    (defaults included)."""
    bound = inspect.signature(fn).bind(*args, **kw)
    bound.apply_defaults()
    return tuple(bound.arguments[n] for n in names)


def _maps_differ(ref: dict, out: dict) -> list:
    """The array entries of two ``run_fdtd``-style results that differ."""
    return [k for k, v in ref.items()
            if isinstance(v, np.ndarray) and not np.array_equal(v, out.get(k))]


def _expect_shard_launches(expect, grid, materials, n_shards, mesh=None,
                           kw=None):
    """Add the launches a run of ``grid`` on ``n_shards`` shards makes
    (plane or volumetric source): on ``mesh``, with the call's keywords
    ``kw``, the fused launches of the overlap-and-discard sweeps where
    ``ops.fdtd.overlap_plan`` finds one, else the velocity and pressure /
    stress launches of every step."""
    from babelbrain_tpu_torch.ops import fdtd as F

    kw = kw or {}
    plan = (None if mesh is None else F.overlap_plan(
        mesh, materials, grid, kw.get("sel_maps", ()), kw.get("monitor_ijk"),
        kw.get("fuse_steps")))
    fam, stem = (("visco", "visco_stress")
                 if np.any(np.asarray(materials)[:, 2] > 0)
                 else ("fluid", "fluid_pressure"))
    if plan is not None:
        sweep = ("fluid_halo_volume" if grid.source_type == "velocity_volume"
                 else f"{fam}_fused")
        for _, _, dft in F.overlap_schedule(grid, plan[0]):
            expect[f"{sweep}_dft" if dft else sweep] += n_shards
        return
    n, s = grid.n_steps, grid.sensor_start
    # a stress point: the shard that holds it launches the point variants
    point = int(grid.source_type == "stress_point")
    expect[f"{fam}_velocity"] += n_shards * n
    expect[stem] += (n_shards - point) * s
    expect[f"{stem}_dft"] += (n_shards - point) * (n - s)
    if point:
        expect[f"{stem}_point"] += s
        expect[f"{stem}_point_dft"] += n - s


def _shallow_replay(args, kw, n_steps, device="cuda"):
    """A recorded ``run_fdtd`` call cut to ``n_steps`` (its DFT window kept
    whole): (its args, its keywords, its grid, the unsharded run's result
    at that depth on ``device``, that run's loop seconds). The unsharded
    run takes the default depth; its launches are set aside."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    bound = inspect.signature(F.run_fdtd).bind(*args, **kw)
    grid = bound.arguments["grid"]
    grid = dataclasses.replace(grid, n_steps=n_steps, sensor_start=n_steps - (
        grid.n_steps - grid.sensor_start))
    bound.arguments["grid"] = grid
    args, kw = bound.args, bound.kwargs
    saved = read_counts()
    clear_spans()
    ref = F.run_fdtd(*args, device=device, **{
        k: v for k, v in kw.items() if k != "fuse_steps"})
    restore_counts(*saved)
    loop = next(dt for label, dt in recorded_spans()
                if label.endswith("FDTD time loop"))
    return args, kw, grid, ref, loop


def run_mesh(times, device="cuda"):
    """The mesh phase (one card): the kernels on shards
    (``check_mesh_kernels``), then the recorded ``run_fdtd`` calls of the
    CT, label, diag-ct and dome-ct slices and refocus-ct's point run again
    on a ``MESH_SHARDS``-shard mesh, each equal to its slice's unsharded
    result bit for bit (dome-ct's at ``DOME_CT_REPLAY_STEPS``, to an
    unsharded run at that depth); the CT
    slice's forward Rayleigh over a 4-device mesh; sweep-ct's
    ``run_fdtd_batch`` on a 2-device case mesh, equal to its unsharded
    batch. Counts are set to 0 before the replays and read after: every
    FDTD kernel's launches must be those of the shards, and no plain
    version may run. With more than one card, the CT run again across real
    cards and the peer-copy rate. Returns (errors, launches, the CT
    run's loop seconds on the shards)."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops.fdtd import make_case_mesh
    from babelbrain_tpu_torch.ops.fdtd import run_fdtd, run_fdtd_batch
    from babelbrain_tpu_torch.ops.rayleigh import rayleigh_field_grid
    from babelbrain_tpu_torch.parallel.halo import make_mesh
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    t_phase = time.time()
    cards = torch.cuda.device_count()
    one = "cuda:0" if device == "cuda" else device
    devices = [one] * MESH_SHARDS
    mesh = make_mesh(MESH_SHARDS, devices=devices)
    print(f"[mesh] make_mesh({MESH_SHARDS}, devices={devices}): every shard "
          f"on one card, named explicitly ({cards} card(s) present)")
    if cards < MESH_SHARDS:
        try:
            make_mesh(MESH_SHARDS)
        except ValueError as e:
            print(f"[mesh] make_mesh({MESH_SHARDS}) without devices= refuses: "
                  f"{e}")
        else:
            fail(f"mesh: make_mesh({MESH_SHARDS}) made a mesh on {cards} "
                 "card(s)")
    errs = check_mesh_kernels(mesh, times, device)
    t_2d = time.time()
    for cut in MESH_2D_KERNELS:
        errs.update(check_mesh_kernels(mesh_2d(cut, one), times, device))
    t_2d = time.time() - t_2d

    reset_counts()
    launches0, _ = read_counts()
    expect = dict.fromkeys(launches0, 0)
    replayed = {}  # (mode, call) -> what the 2-D part replays again
    for mode in MESH_SLICES:
        calls = [c for c in RECORDED.get(mode, ()) if c[0] == "run_fdtd"]
        for j, (name, args, kw, ref, loop) in enumerate(calls):
            kw = {k: v for k, v in kw.items() if k not in ("device", "mesh")}
            if mode == "dome-ct" and j == DOME_CT_PAIR_REPLAY:
                kw["fuse_steps"] = 1
            grid, mats = _bound(run_fdtd, args, kw, "grid", "materials")
            if (mode in MESH_POINT_ONLY
                    and grid.source_type != "stress_point"):
                continue
            if mode == "dome-ct":
                args, kw, grid, ref, loop = _shallow_replay(
                    args, kw, DOME_CT_REPLAY_STEPS, device)
            clear_spans()
            t0 = time.time()
            out = run_fdtd(*args, mesh=mesh, **kw)
            wall = time.time() - t0
            loop_mesh = next(dt for label, dt in recorded_spans()
                             if label.endswith("FDTD time loop"))
            replayed[mode, j] = (args, kw, grid, mats, ref, loop, loop_mesh)
            bad = _maps_differ(ref, out)
            extra = [k for k in ref if k not in ("p_amp", "p_phase", "peak")
                     and isinstance(ref[k], np.ndarray)]
            plan = F.overlap_plan(mesh, mats, grid, kw.get("sel_maps", ()),
                                  kw.get("monitor_ijk"), kw.get("fuse_steps"))
            halo = halo_bytes(grid, mats, MESH_SHARDS, plan)
            sweep = ("" if plan is None else
                     f" ({halo * plan[0] / 1e6:.3f} MB a sweep of overlap and "
                     f"discard, (K, H) = {plan})")
            print(f"[mesh] {mode} run_fdtd {grid.shape} {grid.n_steps} steps "
                  f"({grid.source_type}"
                  + (f", {len(extra)} maps and series" if extra else "")
                  + f") on {MESH_SHARDS} shards: wall {wall:.3f} s, loop "
                  f"{loop_mesh:.3f} s against the unsharded loop "
                  f"{loop:.3f} s ({loop_mesh / loop:.3f}x); halo "
                  f"{halo / 1e6:.3f} MB a step{sweep}; fields differing "
                  f"from the slice's result {bad}")
            if bad:
                fail(f"mesh: {mode} run_fdtd on {MESH_SHARDS} shards differs "
                     f"from the unsharded run in {bad}")
            _expect_shard_launches(expect, grid, mats, MESH_SHARDS, mesh, kw)
            if mode in ("ct", "label") and device == "cuda":
                # the idle share of the loop, sharded and not (the counts
                # are set aside: these launches are the measurement's)
                fields = 6 if np.any(np.asarray(mats)[:, 2] > 0) else 2
                saved = read_counts()
                whole = idle_share(args, kw)
                shard = idle_share(args, kw, mesh)
                restore_counts(*saved)
                copies = (f"overlap and discard (K, H) = {plan}: "
                          f"{2 * (MESH_SHARDS - 1) * 3} bundled ghost-plane "
                          f"transfers a sweep" if plan is not None else
                          f"{2 * (MESH_SHARDS - 1) * fields} ghost-plane "
                          "copies a step")
                print(f"[mesh] {mode} loop over {IDLE_STEPS} window steps "
                      f"under torch.profiler (device busy ms, wall ms, idle "
                      f"share): unsharded {whole}; {MESH_SHARDS} shards "
                      f"{shard}; {copies}")
            del out
    t_2d += run_mesh_2d(replayed, expect, one, device)
    # the CT slice's forward Rayleigh, its x planes over 4 devices
    for name, args, kw, ref, _ in RECORDED.get("ct", ()):
        if name != "rayleigh_field_grid":
            continue
        kw = {k: v for k, v in kw.items() if k != "device"}
        t0 = time.time()
        out = rayleigh_field_grid(*args, mesh=make_mesh(4, devices=devices),
                                  **kw)
        wall = time.time() - t0
        diff = float(np.abs(out - ref).max())
        scale = float(np.abs(ref).max())
        x, y, z, centers = _bound(rayleigh_field_grid, args, kw, "x", "y",
                                  "z", "centers")
        print(f"[mesh] ct forward Rayleigh ({len(x) * len(y) * len(z)} "
              f"points, {len(centers)} sources) on 4 devices: {wall:.3f} s; "
              f"max |difference| {diff:.6g} Pa = {diff / scale:.3g} of the "
              f"peak (bit-equal: {diff == 0.0})")
        if diff != 0.0:
            fail(f"mesh: sharded Rayleigh off by {diff} (peak {scale})")
    # sweep-ct's batch over a 2-device case mesh
    for name, args, kw, ref, _ in RECORDED.get("sweep-ct", ()):
        if name != "run_fdtd_batch":
            continue
        kw = {k: v for k, v in kw.items() if k not in ("device", "mesh")}
        grid, mats, amps = _bound(run_fdtd_batch, args, kw, "grid",
                                  "materials", "source_amps")
        t0 = time.time()
        out = run_fdtd_batch(*args, mesh=make_case_mesh(
            devices=[one] * 2), **kw)
        wall = time.time() - t0
        bad = _maps_differ(ref, out)
        print(f"[mesh] sweep-ct run_fdtd_batch ({len(amps)} cases) on a "
              f"2-device case mesh: {wall:.3f} s; fields differing from the "
              f"unsharded batch {bad}")
        if bad:
            fail(f"mesh: the case-mesh batch differs in {bad}")
        expect_fused_run(expect, grid, mats, n=len(amps), device=device)
    launches, plain = read_counts()
    print(f"[mesh] launches {launches}; plain calls {plain}")
    fdtd_rows = [k for k in expect if expect[k]]
    if device == "cuda" and (any(plain.values()) or any(launches[k] != expect[k]
                                   for k in fdtd_rows)
            or not all(launches[k] for k in ("volume_source", "extras_fluid",
                                             "monitor_fluid"))):
        fail(f"mesh: launches {launches} (expected {expect} for the "
             f"velocity and pressure / stress rows), plain calls {plain}")
    if cards > 1:
        check_mesh_cards(cards)
    print(f"[mesh] phase {time.time() - t_phase:.2f} s, its 2-D part "
          f"{t_2d:.2f} s of it")
    ct = replayed.get(("ct", 0))
    return errs, launches, None if ct is None else ct[-1]


def mesh_2d(cut, one):
    """An (nx, ny) mesh of every shard on device ``one``."""
    from babelbrain_tpu_torch.parallel.halo import make_mesh_2d

    return make_mesh_2d(*cut, devices=[one] * (cut[0] * cut[1]))


def run_mesh_2d(replayed, expect, one, device="cuda"):
    """The mesh phase's 2-D replays, every shard on device ``one``: the
    recorded ``run_fdtd`` calls of ``MESH_2D_REPLAYS`` (as the x part
    replayed them, ``replayed``) on their (nx, ny) meshes, each equal to
    its slice's result bit for bit, and the CT slice's ``run_acoustic_sim``
    on ``MESH_2D_CT``, its DataForSim maps equal to the slice's; each
    loop's seconds beside the x mesh's and the unsharded one's, and the CT
    loop's idle share. Adds the shards' launches to ``expect``. Returns its
    seconds."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.ops.fdtd import run_fdtd
    from babelbrain_tpu_torch.pipeline import acoustic as A
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    def loop_span():
        return next(dt for label, dt in recorded_spans()
                    if label.endswith("FDTD time loop"))

    t_part = time.time()
    for (mode, j), (args, kw, grid, mats, ref, loop, loop_x) in \
            replayed.items():
        cut = MESH_2D_REPLAYS.get(mode)
        if cut is None or (mode == "dome-ct" and j != DOME_CT_PAIR_REPLAY):
            continue
        mesh = mesh_2d(cut, one)
        clear_spans()
        t0 = time.time()
        out = run_fdtd(*args, mesh=mesh, **kw)
        wall = time.time() - t0
        loop_2d = loop_span()
        bad = _maps_differ(ref, out)
        extra = [k for k in ref if k not in ("p_amp", "p_phase", "peak")
                 and isinstance(ref[k], np.ndarray)]
        where = ""
        if grid.source_type == "stress_point":
            dd = F._blocks(mesh, grid)
            s = dd.owner(*(int(v) for v in grid.source_ijk[:2]))
            sx, sy = dd.coords(s)
            where = (f", the point {tuple(int(v) for v in grid.source_ijk)} "
                     f"on shard {s} (sx, sy) = ({sx}, {sy})"
                     + (", y-interior" if 0 < sy < cut[1] - 1 else ""))
        print(f"[mesh 2d] {mode} run_fdtd {grid.shape} {grid.n_steps} steps "
              f"({grid.source_type}"
              + (f", {len(extra)} maps and series" if extra else "")
              + f"{where}) on {cut} shards: wall {wall:.3f} s, loop "
              f"{loop_2d:.3f} s against {MESH_SHARDS} x shards' {loop_x:.3f} "
              f"s and the unsharded {loop:.3f} s; halo "
              f"{halo_bytes_2d(grid, mats, mesh) / 1e6:.3f} MB a step; "
              f"fields differing from the slice's result {bad}")
        if bad:
            fail(f"mesh 2d: {mode} run_fdtd on {cut} shards differs from the "
                 f"unsharded run in {bad}")
        _expect_shard_launches(expect, grid, mats, mesh.size, mesh, kw)
        del out
    calls = [c for c in RECORDED.get("ct", ()) if c[0] == "run_acoustic_sim"]
    if not calls or ("ct", 0) not in replayed:
        fail("mesh 2d: the CT slice's run_acoustic_sim and run_fdtd were "
             "not recorded")
    _, args, kw, ref, _ = calls[0]
    fargs, fkw, grid, mats, _, loop, loop_x = replayed["ct", 0]
    mesh = mesh_2d(MESH_2D_CT, one)
    clear_spans()
    t0 = time.time()
    res = A.run_acoustic_sim(*args, mesh=mesh, **kw)
    wall = time.time() - t0
    loop_2d = loop_span()
    bad = _maps_differ(ref, res.data_for_sim)
    print(f"[mesh 2d] ct run_acoustic_sim ({grid.shape}, {grid.n_steps} "
          f"steps) on {MESH_2D_CT} shards: wall {wall:.3f} s, FDTD loop "
          f"{loop_2d:.3f} s against {MESH_SHARDS} x shards' {loop_x:.3f} s "
          f"and the unsharded {loop:.3f} s; halo "
          f"{halo_bytes_2d(grid, mats, mesh) / 1e6:.3f} MB a step; "
          f"DataForSim arrays compared {len([k for k in ref if isinstance(ref[k], np.ndarray)])}, "
          f"differing from the slice's {bad}")
    if bad:
        fail(f"mesh 2d: the CT slice's run_acoustic_sim on {MESH_2D_CT} "
             f"shards differs in {bad}")
    _expect_shard_launches(expect, grid, mats, mesh.size, mesh, {})
    if device == "cuda":
        saved = read_counts()
        idle = idle_share(fargs, fkw, mesh)
        restore_counts(*saved)
        nx, ny = MESH_2D_CT
        fx, fy = (sum(len(h) for h in F.HALO_FIELDS[F.FluidState][axis])
                  for axis in (0, 1))
        copies = 2 * ((nx - 1) * ny * fx + nx * (ny - 1) * fy)
        print(f"[mesh 2d] ct loop over {IDLE_STEPS} window steps under "
              f"torch.profiler (device busy ms, wall ms, idle share) on "
              f"{MESH_2D_CT} shards: {idle}; {mesh.size * 2} launches and "
              f"{copies} ghost-slab copies a step")
    return time.time() - t_part


def halo_bytes_2d(grid, materials, mesh):
    """Bytes the ghost-plane refresh of one step copies on an (x, y)
    ``mesh``: along each cut axis, at each boundary of each line of the
    mesh, 2 planes each way of the fields ``ops.fdtd.HALO_FIELDS`` lists
    for that axis (a plane spans the shard's other axis, its ghosts
    included)."""
    from babelbrain_tpu_torch.ops import fdtd as F

    dd = F._blocks(mesh, grid)
    state = (F.ViscoState if np.any(np.asarray(materials)[:, 2] > 0)
             else F.FluidState)
    total = 0
    for axis, cut, other in ((0, dd.x, dd.y), (1, dd.y, dd.x)):
        n_fields = sum(len(h) for h in F.HALO_FIELDS[state][axis])
        planes = sum(other.planes(o) for o in range(other.n_shards))
        total += ((cut.n_shards - 1) * 2 * cut.halo * planes * grid.shape[2]
                  * 4 * n_fields)
    return total


def halo_bytes(grid, materials, n_shards, plan=None):
    """Bytes the ghost-plane refresh of one step copies on ``n_shards``
    shards: 2 planes each way at each boundary, for each field the next
    half-step reads across x (fluid vx, p; visco 3 velocities, 3 stresses);
    with an overlap ``plan`` (K, H), H planes each way of the state's
    groups once a sweep, over K (fluid p, vx, vy, vz, r and the four y and
    four z psi slabs; visco the 15 fields and the twelve y and twelve z psi
    slabs)."""
    n2, n3 = grid.shape[1:]
    visco = bool(np.any(np.asarray(materials)[:, 2] > 0))
    if plan is not None:
        k, h = plan
        ns = grid.npml + 2
        vols, slabs = (15, 12) if visco else (5, 4)
        cells = vols * n2 * n3 + slabs * (ns * n3 + n2 * ns)
        return (n_shards - 1) * 2 * h * cells * 4 / k
    fields = 6 if visco else 2
    plane = n2 * n3 * 4
    return (n_shards - 1) * 2 * 2 * plane * fields


def check_mesh_cards(cards):
    """With several cards: the CT slice's run_fdtd across real cards, equal
    to its unsharded result, and the peer-copy rate between cards 0 and 1."""
    from babelbrain_tpu_torch.ops.fdtd import run_fdtd
    from babelbrain_tpu_torch.parallel.halo import make_mesh

    name, args, kw, ref, loop = next(c for c in RECORDED["ct"]
                                     if c[0] == "run_fdtd")
    kw = {k: v for k, v in kw.items() if k not in ("device", "mesh")}
    (grid,) = _bound(run_fdtd, args, kw, "grid")
    n = max(d for d in range(1, min(cards, MESH_SHARDS) + 1)
            if grid.shape[0] % d == 0)
    t0 = time.time()
    out = run_fdtd(*args, mesh=make_mesh(n), **kw)
    bad = _maps_differ(ref, out)
    print(f"[mesh] ct run_fdtd across {n} cards: {time.time() - t0:.3f} s; "
          f"fields differing {bad}")
    if bad:
        fail(f"mesh: the run across cards differs in {bad}")
    a = torch.empty(64 * 2**20, device="cuda:0")
    b = torch.empty(64 * 2**20, device="cuda:1")
    ms = _timed(lambda: b.copy_(a, non_blocking=True), 10)
    print(f"[mesh] peer copy cuda:0 -> cuda:1: {a.numel() * 4 / ms / 1e6:.1f}"
          f" GB/s ({ms:.4f} ms for {a.numel() * 4 / 2**20:.0f} MiB)")


# ---------------------------------------------------------------------------
# the multi-process phase
# ---------------------------------------------------------------------------

# the CT slice's run_fdtd over MP_PROCS processes of MP_SHARDS shards each,
# every shard on one card: a 4-way x mesh whose middle boundary crosses the
# processes, its ghost planes host-staged through gloo
MP_PROCS = 2
MP_SHARDS = 2
MP_TIMEOUT = 300  # seconds for the workers, their start included


def run_multiprocess(mesh_loop=None, device="cuda"):
    """The CT slice's recorded ``run_fdtd`` call (``RECORDED["ct"]``) in
    ``MP_PROCS`` worker processes of this script (``--mp-worker``), each
    holding ``MP_SHARDS`` shards of one ``device`` in a mesh laid out over
    a gloo process group (``parallel.distributed``); each worker returns
    the whole result, which must equal the slice's unsharded result bit
    for bit. The library is built already (``build``), so the workers only
    load it. Rank 0 prints its loop and the host time a step spent in the
    cross-process exchange; ``mesh_loop`` is the loop of the same run on as
    many shards in one process (the mesh phase's). Returns the workers'
    summed launch counts, which must be those of the shards."""
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.parallel.halo import make_mesh

    t_phase = time.time()
    name, args, kw, ref, loop = next(c for c in RECORDED["ct"]
                                     if c[0] == "run_fdtd")
    kw = {k: v for k, v in kw.items() if k not in ("device", "mesh")}
    grid, mats = _bound(F.run_fdtd, args, kw, "grid", "materials")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "case.pkl"), "wb") as f:
            pickle.dump({"args": args, "kw": kw, "ref": ref}, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-worker",
             str(r), str(MP_PROCS), tmp, device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MP_PROCS)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, MP_TIMEOUT - (time.time() - t_phase)))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.communicate()
                fail(f"multiprocess: workers still running after "
                     f"{MP_TIMEOUT} s")
            outs.append(out)
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                if line.startswith("[multiprocess]"):
                    print(line)
            if p.returncode != 0:
                fail(f"multiprocess: worker {r} exited {p.returncode}:\n"
                     f"{out[-3000:]}")
        res = []
        for r in range(MP_PROCS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    for r in res:
        if r["differing"]:
            fail(f"multiprocess: rank {r['rank']}'s result differs from the "
                 f"unsharded run in {r['differing']}")
    n_shards = MP_PROCS * MP_SHARDS
    expect = dict.fromkeys(res[0]["launches"], 0)
    one = "cuda:0" if device == "cuda" else device
    _expect_shard_launches(expect, grid, mats, n_shards,
                           make_mesh(n_shards, devices=[one] * n_shards), kw)
    launches = {k: sum(r["launches"][k] for r in res) for k in expect}
    plain = {k: sum(r["plain"][k] for r in res) for k in expect}
    r0 = res[0]
    step = r0["exchange"]["seconds"] / grid.n_steps
    print(f"[multiprocess] ct run_fdtd {grid.shape} {grid.n_steps} steps on "
          f"{MP_PROCS} processes x {MP_SHARDS} shards of {one} (gloo, "
          f"host-staged): rank 0 loop {r0['loop']:.3f} s, wall "
          f"{r0['wall']:.3f} s; cross-process exchange {step * 1e3:.4f} ms "
          f"a step of host time (staging the sends and waiting for the "
          f"device {r0['exchange']['staging'] / grid.n_steps * 1e3:.4f} ms, "
          f"on the wire {r0['exchange']['wire'] / grid.n_steps * 1e3:.4f} "
          f"ms; {r0['exchange']['exchanges']} exchanges, "
          f"{r0['exchange']['bytes'] / grid.n_steps / 1e6:.4f} MB sent a "
          f"step); unsharded loop {loop:.3f} s"
          + ("" if mesh_loop is None else
             f", {n_shards} shards in one process {mesh_loop:.3f} s")
          + f"; both results bit-equal to the unsharded run; phase "
          f"{time.time() - t_phase:.2f} s")
    print(f"[multiprocess] launches "
          f"{ {k: v for k, v in launches.items() if v} }; plain calls "
          f"{ {k: v for k, v in plain.items() if v} }")
    if device == "cuda" and (any(plain.values()) or any(
            launches[k] != expect[k] for k in expect)):
        fail(f"multiprocess: launches {launches} (expected {expect}), plain "
             f"calls {plain}")
    return launches


def mp_worker(rank: int, world: int, tmp: str, device: str) -> None:
    """One process of ``run_multiprocess``: joins the gloo group on a
    ``file://`` store in ``tmp``, names ``MP_SHARDS`` shards of ``device``
    (cuda:0 on a card) and runs the case, its counts set to 0 just before;
    writes ``rank<r>.json`` (the fields that differ from the slice's
    result, loop, exchange figures, counts)."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from babelbrain_tpu_torch.ops import fdtd as F
    from babelbrain_tpu_torch.parallel import distributed as D
    from babelbrain_tpu_torch.parallel.halo import make_mesh
    from babelbrain_tpu_torch.utils.timing import clear_spans, recorded_spans

    if device == "cuda" and not torch.cuda.is_available():
        fail("multiprocess worker: no CUDA device")
    group = D.initialize(f"file://{os.path.join(tmp, 'store')}", world,
                         rank, timeout=MP_TIMEOUT)
    with open(os.path.join(tmp, "case.pkl"), "rb") as f:
        case = pickle.load(f)
    one = "cuda:0" if device == "cuda" else device
    mesh = make_mesh(world * MP_SHARDS, devices=[one] * MP_SHARDS,
                     group=group)
    reset_counts()
    D.reset_stats()
    clear_spans()
    t0 = time.time()
    out = F.run_fdtd(*case["args"], mesh=mesh, **case["kw"])
    wall = time.time() - t0
    loop = next(dt for label, dt in recorded_spans()
                if label.endswith("FDTD time loop"))
    launches, plain = read_counts()
    bad = _maps_differ(case["ref"], out) + sorted(
        set(case["ref"]) ^ set(out))
    if rank == 0:
        print(f"[multiprocess] rank 0: loop {loop:.3f} s, cross-process "
              f"exchange {D.stats['seconds']:.3f} s of host time "
              f"({D.stats['exchanges']} exchanges, {D.stats['bytes']} bytes "
              f"sent); fields differing {bad}", flush=True)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "wall": wall, "loop": loop,
                   "differing": bad, "exchange": dict(D.stats),
                   "launches": launches, "plain": plain}, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------

FLUID_CU = "babelbrain_tpu_torch/csrc/fdtd_fluid.cu"
FUSED_CU = "babelbrain_tpu_torch/csrc/fdtd_fluid_fused.cu"
HALO_CU = "babelbrain_tpu_torch/csrc/fdtd_fluid_halo.cu"
VISCO_HALO_CU = "babelbrain_tpu_torch/csrc/fdtd_visco_halo.cu"
VISCO_FUSED_CU = "babelbrain_tpu_torch/csrc/fdtd_visco_fused.cu"
VISCO_CU = "babelbrain_tpu_torch/csrc/fdtd_visco.cu"
SOURCES_CU = "babelbrain_tpu_torch/csrc/fdtd_sources.cu"
EXTRAS_CU = "babelbrain_tpu_torch/csrc/fdtd_extras.cu"
PROBES_CU = "babelbrain_tpu_torch/csrc/probes.cu"
PALLAS = "babelbrain_tpu/ops/fdtd_pallas.py"
XLA = "babelbrain_tpu/ops/fdtd.py"
SOURCES = {
    "fluid_velocity": ("fluid_velocity_kernel", FLUID_CU, f"{PALLAS}:262"),
    "fluid_pressure": ("fluid_pressure_kernel", FLUID_CU, f"{PALLAS}:370"),
    "fluid_pressure_dft": ("fluid_pressure_kernel<WITH_DFT>", FLUID_CU,
                           f"{PALLAS}:370"),
    # B9: its K-step sweep, and one step of it (the tails of a segment)
    "bhte_fused": ("bhte_fused_kernel", "babelbrain_tpu_torch/csrc/bhte.cu",
                   "babelbrain_tpu/ops/bhte_pallas.py:54"),
    "bhte_step": ("bhte_step_kernel", "babelbrain_tpu_torch/csrc/bhte.cu",
                  "babelbrain_tpu/ops/bhte_pallas.py:109"),
    # B5 vel_kernel / stress_kernel; the same step as B6-B8
    "visco_velocity": ("visco_velocity_kernel", VISCO_CU, f"{PALLAS}:3025"),
    "visco_stress": ("visco_stress_kernel", VISCO_CU, f"{PALLAS}:3196"),
    "visco_stress_dft": ("visco_stress_kernel<WITH_DFT>", VISCO_CU,
                         f"{PALLAS}:3196"),
    # B2 build_fluid_fused_step: its in-kernel point injection (the same
    # as B4's) and its volumetric drive (B4/B6/B8 alike)
    "fluid_pressure_point": ("fluid_pressure_kernel<POINT>", FLUID_CU,
                             f"{PALLAS}:774"),
    "fluid_pressure_point_dft": ("fluid_pressure_kernel<WITH_DFT, POINT>",
                                 FLUID_CU, f"{PALLAS}:774"),
    # B2 (K = 1), B3 (K = 2) and B4 (K >= 3): K steps in one sweep, plane
    # (B4 :1754) and point (B4's injection :1808); timed at the main path's K
    "fluid_fused": ("fluid_fused_kernel", FUSED_CU, f"{PALLAS}:1754"),
    "fluid_fused_dft": ("fluid_fused_kernel<WITH_DFT>", FUSED_CU,
                        f"{PALLAS}:1754"),
    "fluid_fused_point": ("fluid_fused_kernel<POINT>", FUSED_CU,
                          f"{PALLAS}:1808"),
    "fluid_fused_point_dft": ("fluid_fused_kernel<WITH_DFT, POINT>", FUSED_CU,
                              f"{PALLAS}:1808"),
    # B4's with_p2 accumulator (:1756, summed :2288) and its driver's
    # monitor capture (:2891) inside the K-step sweep: the extras sweep,
    # timed at the sensors-ct slice's K (its point twin, off the main path,
    # is checked by check_fused_extras and the cuda tests)
    "fluid_fused_extras_dft": ("fluid_fused_kernel<WITH_DFT, EXTRAS>",
                               FUSED_CU, f"{PALLAS}:1756"),
    # B6 (K = 1), B7 (K = 2) and B8 (K >= 2): K visco steps in one sweep,
    # plane (B8 :4843) and point (B8's injection :4900); timed at the main
    # path's K
    "visco_fused": ("visco_fused_kernel", VISCO_FUSED_CU, f"{PALLAS}:4843"),
    "visco_fused_dft": ("visco_fused_kernel<WITH_DFT>", VISCO_FUSED_CU,
                        f"{PALLAS}:4843"),
    "visco_fused_point": ("visco_fused_kernel<POINT>", VISCO_FUSED_CU,
                          f"{PALLAS}:4900"),
    "visco_fused_point_dft": ("visco_fused_kernel<WITH_DFT, POINT>",
                              VISCO_FUSED_CU, f"{PALLAS}:4900"),
    "volume_source": ("velocity_volume_source_kernel", SOURCES_CU,
                      f"{PALLAS}:706"),
    # no TPU kernel: the XLA Rayleigh integral (its matrix-unit form), its
    # point-list form (the steering, the refocus's backward Rayleigh, the
    # anchors); timed at 2^18 of dome-ct's points with its sources
    "rayleigh": ("rayleigh_kernel", "babelbrain_tpu_torch/csrc/rayleigh.cu",
                 "babelbrain_tpu/ops/rayleigh.py:98"),
    # its grid form (the points built on the card from the grid's axes):
    # the forward Rayleigh over each slice's grid, the XLA evaluation of
    # rayleigh_field_volume (:195); timed on a slab of dome-ct's grid
    "rayleigh_grid": ("rayleigh_kernel<GRID>",
                      "babelbrain_tpu_torch/csrc/rayleigh.cu",
                      "babelbrain_tpu/ops/rayleigh.py:195"),
    # B4's volumetric drive (:1815, injected at :2108) inside its K-step
    # sweep: the halo sweep, timed at the dome's grid and depth
    "fluid_halo_volume": ("fluid_halo_kernel<VOLUME>", HALO_CU,
                          f"{PALLAS}:1815"),
    "fluid_halo_volume_dft": ("fluid_halo_kernel<WITH_DFT, VOLUME>", HALO_CU,
                              f"{PALLAS}:1815"),
    # B8's volumetric drive (:4905, injected at :5293) inside its K-step
    # sweep (B6's K = 1 form :3666): the visco halo sweep, which always
    # drives the volume, timed at the dome's grid and dome-label's depth
    "visco_halo_volume": ("visco_halo_kernel", VISCO_HALO_CU,
                          f"{PALLAS}:4905"),
    "visco_halo_volume_dft": ("visco_halo_kernel<WITH_DFT>", VISCO_HALO_CU,
                              f"{PALLAS}:4905"),
    # B6 build_visco_fused_step's point injection (the same as B8's)
    "visco_stress_point": ("visco_stress_kernel<POINT>", VISCO_CU,
                           f"{PALLAS}:3780"),
    "visco_stress_point_dft": ("visco_stress_kernel<WITH_DFT, POINT>",
                               VISCO_CU, f"{PALLAS}:3780"),
    # no TPU kernel: the XLA path's 14 maps (_update_extras) in either
    # family, after each step a run takes on the pair
    "extras_fluid": ("extras_accumulate_kernel", EXTRAS_CU, f"{XLA}:729"),
    "extras_visco": ("extras_accumulate_kernel<VISCO>", EXTRAS_CU,
                     f"{XLA}:729"),
    # no TPU kernel: the XLA path's samples (_monitor_gather) on the pair,
    # folded into the pressure / stress kernel (timed with the DFT and 201
    # voxels)
    "monitor_fluid": ("fluid_pressure_kernel<WITH_DFT, kMonitorListed>",
                      FLUID_CU, f"{XLA}:706"),
    "monitor_visco": ("visco_stress_kernel<WITH_DFT, kMonitorListed>",
                      VISCO_CU, f"{XLA}:706"),
    # P1 (and P2's table gathers, tools/probe_gather.py:46)
    "stream": ("stream_kernel", PROBES_CU, "tools/probe_roofline.py:75"),
    "fma_chain": ("fma_chain_kernel", PROBES_CU, "tools/probe_roofline.py:90"),
    "table_gather": ("table_gather_kernel", PROBES_CU,
                     "tools/probe_roofline.py:213"),
}


def run_probes():
    """The probe phase: ``probes.run_probes`` on the card (P1's stream, FMA
    and table-gather probes, P2's gather cases and cost probe), each kernel
    exact; returns its launch counts."""
    from babelbrain_tpu_torch import probes as P

    reset_counts()
    t0 = time.time()
    res = P.run_probes(device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, _ = read_counts()
    counts = {k: launches[k] for k in P.launches}
    for r in res:
        print(f"[probes] {json.dumps(r)}")
    print(f"[probes] {wall:.2f} s; launches {counts}")
    bad = [r["probe"] for r in res
           if not r.get("exact", True) or r.get("wrong")]
    if bad:
        fail(f"probes not exact: {bad}")
    return counts


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (this script drives the port on the GPU only)")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "babelbrain_tpu_torch")):
        fail(f"babelbrain_tpu_torch not found next to {__file__}")
    sys.path.insert(0, root)

    t_start = time.time()
    have = probe()
    build()
    errs, times, bounds = {}, {}, {}
    for check, source in ((check_fluid, "plane"), (check_fluid, "point"),
                          (check_fluid, "volume"), (check_visco, "plane"),
                          (check_visco, "point"), (check_visco, "volume"),
                          (check_visco_ragged, None),
                          (check_fluid_ragged, None),
                          (check_fluid_large_table, None),
                          (check_monitor_ragged, None),
                          (check_bhte, None)):
        e, t = check() if source is None else check(source=source)
        for k, v in e.items():  # the scatter is checked in both families
            errs[k] = max(errs.get(k, 0.0), v)
        times.update(t)
    e, t, b, per_step = check_fused_extras()
    errs.update(e)
    times.update(t)
    bounds.update(b)
    from babelbrain_tpu_torch.ops.fdtd_fused_kernels import EXTRAS_FUSE_BEST
    print(f"[fused extras] at {SLICE_SHAPE} a step: "
          + ", ".join(f"K={k} {v:.4f} ms" for k, v in per_step.items()
                      if k != "pair")
          + f"; pair + extras + MONITOR {per_step['pair']:.4f} ms; "
          f"EXTRAS_FUSE_BEST = {EXTRAS_FUSE_BEST}")
    # the rule of lockstep_fuse_best: the fastest K >= 2 if it beats the pair
    best = min((k for k in per_step if k != "pair" and k >= 2),
               key=per_step.get, default=0)
    if best and per_step[best] >= per_step["pair"]:
        best = 0
    if best != EXTRAS_FUSE_BEST:
        print(f"[fused extras] WARNING: EXTRAS_FUSE_BEST does not follow "
              f"this run's measurement (K = {best})")
    for e, t, b in (check_fused(times), check_visco_fused(),
                    check_fused_volume(times), check_visco_volume(times),
                    check_bhte_fused(times),
                    check_diagnostics("fluid"),
                    check_diagnostics("visco"), check_probe_kernels()):
        errs.update(e)
        times.update(t)
        bounds.update(b)
    n_shell = int((shell_source(KERNEL_SHAPE)["amp"] > 0).sum())
    # every counted kernel (the halo sweep's plane-source instantiations
    # are checked by the cuda tests only, off the kernel table)
    launches = dict.fromkeys([*SOURCES, *read_counts()[0]], 0)
    for mode in SLICES:
        with (recording(mode) if mode in MESH_SLICES + FUSED_SLICES
              else contextlib.nullcontext()), pinned_fuse_steps(mode):
            counts, slice_errs = run_slice(have["h5py"], mode)
        if mode in FUSED_SLICES:
            check_fused_runs(mode)
            if mode not in MESH_SLICES:
                RECORDED.pop(mode, None)
        if mode in RAYLEIGH_SLICES:
            e, t, b = check_rayleigh_run(mode)
            times.update(t)
            bounds.update(b)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if mode != "ct":  # the mesh phase replays the CT slice's alone
                RECORDED[mode] = [c for c in RECORDED[mode]
                                  if c[0] != "rayleigh_field_grid"]
        for k, v in counts.items():
            launches[k] += v
        for k, v in slice_errs.items():
            errs[k] = max(errs[k], v)
    background_note("the golden phase")
    for k, v in run_golden().items():
        launches[k] += v
    background_note("the anchors")
    for k, v in run_anchors().items():
        launches[k] += v
    background_note("sweep-ct")
    with recording("sweep-ct"):
        for k, v in run_sweep(have["h5py"]).items():
            launches[k] += v
    finish_background()
    mesh_errs, counts, mesh_loop = run_mesh(times)
    for k, v in counts.items():
        launches[k] += v
    for k, v in run_multiprocess(mesh_loop).items():
        launches[k] += v
    RECORDED.clear()
    for k, v in mesh_errs.items():
        errs[k] = max(errs[k], v)
    for k, v in run_probes().items():
        launches[k] += v

    table = []
    for k, (name, source, replaces) in SOURCES.items():
        b_ms, b_by = bounds.get(k) or bound(k, KERNEL_SHAPE, n_src=n_shell)
        ms, plain_ms, *lib = times[k]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches[k]),
            "max_abs_err": errs[k], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            # the FDTD and BHTE rows: no single PyTorch call computes an
            # FDTD or BHTE step, or sets three scattered velocity volumes
            # from the dome drive; nor the Rayleigh sum from its points and
            # sources (a complex product needs the points x sources matrix
            # of phase factors, which is the kernel's work) (the other rows
            # give theirs or say why not)
            "library_ms": lib[0] if lib else None,
        })
        if launches[k] <= 0:
            fail(f"{name} was never launched on its path")
    print(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
    else:
        main()
