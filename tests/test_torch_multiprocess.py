"""Port parity: ``run_fdtd(mesh=)`` over shards held by several processes.

The twin of `tests/test_multihost.py` (2 processes of JAX CPU devices, one
mesh, bit for bit against one device) for ``babelbrain_tpu_torch``: this
file is also the worker. A module fixture starts it twice as
``python tests/test_torch_multiprocess.py <rank> 2 <store> <out dir>``; the
two processes meet in a gloo process group on a ``file://`` store
(``parallel.distributed.initialize``), each names two ``"cpu"`` devices
(``make_mesh(..., group=)``: a 4-shard mesh in rank order), runs every
case of ``CASES`` and writes its whole result to ``<case>.<rank>.npz``.
Each case must equal the port's unsharded run in this process bit for bit,
from both processes: JAX's multihost case on a 4-way x mesh, a (2, 2) mesh
whose x boundary crosses the processes, a (1, 4) mesh whose y boundary
does, shear media across y, a point source owned by rank 1, maps with
monitors on both processes, a volumetric source, and a pinned
overlap-and-discard run (the CPU runs the plain versions of the fused
sweeps). Every case but the last (JAX's Pallas sweeps run in one process
only) is also held to JAX's unsharded XLA run at its source's band: a
plane 1e-4 of the peak with rtol 1e-3, a point 1e-6, a volumetric source
1e-5. The workers also
record that ``rayleigh_field``, ``run_fdtd_batch`` and ``run_multipoint``
refuse the mesh. A second pair, whose rank 1 leaves after joining, shows
that the survivor fails instead of hanging.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.parallel import distributed as D
from babelbrain_tpu_torch.parallel import halo as H

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F0, C = 500e3, 1500.0
SHEAR = [[1000.0, C, 0, 0, 0], [1896.5, 2494.0, 1594.0, 106.0, 214.0]]
FLUID = [[1000.0, C, 0.0, 20.0, 0.0], [1896.0, 2494.0, 0.0, 150.0, 0.0]]
PLANE, POINT, VOLUME = 1e-4, 1e-6, 1e-5  # bands, of the JAX run's peak
WORKER_TIMEOUT = 240  # seconds for a pair of workers
MAPS = ("Pressure_rms", "Vx_peak", "Sigmayy_rms")
# on the x boundary of the processes (i = 15 | 16), on the y boundary
# inside each process (j = 15 | 16), inside each shard, one voxel twice
MONITORS = np.array([[15, 8, 16], [16, 8, 16], [8, 15, 18], [24, 16, 18],
                     [4, 4, 20], [28, 28, 12], [16, 8, 16]])


def _grid(shape, n_cycles, npml=4, **kw):
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / T.stable_dt(dx, 2494.0, cfl=0.9)))
    nsteps = ppp * n_cycles
    return dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=nsteps,
                frequency=F0, npml=npml, sensor_start=nsteps - 2 * ppp,
                source_plane_z=npml + 1, **kw)


def _plane(shape, seed, edge=4):
    rng = np.random.default_rng(seed)
    amp = np.zeros(shape[:2], np.float32)
    amp[edge:-edge, edge:-edge] = 60e3 * rng.uniform(
        0.5, 1, (shape[0] - 2 * edge, shape[1] - 2 * edge))
    ph = rng.uniform(-2, 2, shape[:2]).astype(np.float32)
    return dict(source_amp=amp, source_phase=ph)


def _shell(shape, centre, seed=7):
    """A phased dome shell (dense dict) across the four x shards."""
    ci, cj, ck = centre
    ii, jj, kk = np.mgrid[:shape[0], :shape[1], :shape[2]]
    r = np.sqrt((ii - ci) ** 2 + (jj - cj) ** 2 + (kk - ck) ** 2)
    shell = (r > 7) & (r < 9) & (kk < ck)
    rng = np.random.default_rng(seed)
    rr = np.maximum(r, 1e-6)
    return dict(amp=np.where(shell, 60e3, 0.0).astype(np.float32),
                phase=(rng.uniform(-2, 2, shape) * shell).astype(np.float32),
                ox=((ci - ii) / rr).astype(np.float32),
                oy=((cj - jj) / rr).astype(np.float32),
                oz=((ck - kk) / rr).astype(np.float32))


def _case(name):
    """(index, materials, grid keywords, run_fdtd keywords, mesh (nx, ny))
    of a case; every mesh has 4 shards, 2 a process."""
    if name == "multihost":  # `tests/test_multihost.py:31-52`
        shape = (96, 32, 56)
        g = _grid(shape, 4, npml=8)
        mats = np.array(SHEAR)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 28:34] = 1
        rng = np.random.default_rng(0)
        amp = np.zeros(shape[:2])
        amp[12:-12, 12:-12] = 60e3 * rng.uniform(0.5, 1, (72, 8))
        ph = rng.uniform(-3, 3, shape[:2])
        return idx, mats, g, dict(source_amp=amp, source_phase=ph), (4, 1)
    if name in ("x_cross", "y_cross", "shear_y"):
        shape = (32, 32, 32) if name == "x_cross" else (24, 48, 32)
        mats = np.array(SHEAR if name == "shear_y" else FLUID)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 18:22] = 1
        mesh = (2, 2) if name == "x_cross" else (1, 4)
        return idx, mats, _grid(shape, 3), _plane(shape, 1), mesh
    if name == "point":  # the source in shard 2, rank 1's first
        shape = (48, 24, 32)
        g = _grid(shape, 3, source_type="stress_point",
                  source_ijk=(30, 11, 16))
        return (np.zeros(shape, np.uint8), np.array(SHEAR[:1]), g,
                dict(point_amp=60e3), (4, 1))
    if name == "maps":
        shape = (32, 32, 32)
        return (np.zeros(shape, np.uint8), np.array(FLUID[:1]),
                _grid(shape, 3), dict(_plane(shape, 2), sel_maps=MAPS,
                                      monitor_ijk=MONITORS,
                                      sensor_subsampling=2), (2, 2))
    if name == "volume":
        shape = (48, 24, 32)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 20:24] = 1
        return (idx, np.array(FLUID), _grid(shape, 3,
                                            source_type="velocity_volume"),
                dict(volume_source=_shell(shape, (24.0, 12.0, 16.0))), (4, 1))
    if name == "overlap":  # (K, H) = (3, 9) on 16 planes a shard
        shape = (64, 24, 32)
        return (np.zeros(shape, np.uint8), np.array(FLUID[:1]),
                _grid(shape, 3), dict(_plane(shape, 3), fuse_steps=3), (4, 1))
    raise KeyError(name)


CASES = ("multihost", "x_cross", "y_cross", "shear_y", "point", "maps",
         "volume", "overlap")
# each case that JAX runs across processes (all but the overlap-and-discard
# sweeps), with its band and rtol against JAX's unsharded XLA run
JAX_BANDS = {"multihost": (PLANE, 1e-3), "x_cross": (PLANE, 1e-3),
             "y_cross": (PLANE, 1e-3), "shear_y": (PLANE, 1e-3),
             "point": (POINT, 0.0), "maps": (PLANE, 1e-3),
             "volume": (VOLUME, 0.0)}


def _mesh(cut, group):
    """A (nx, ny) mesh of 4 shards over the processes of ``group``, two
    "cpu" devices each."""
    if cut[1] == 1:
        return H.make_mesh(4, devices=["cpu"] * 2, group=group)
    return H.make_mesh_2d(*cut, devices=["cpu"] * 2, group=group)


def _refusals(mesh) -> dict:
    """The message of each caller that refuses a mesh over processes."""
    from babelbrain_tpu_torch.ops.rayleigh import rayleigh_field
    from babelbrain_tpu_torch.pipeline.acoustic import run_multipoint

    idx, mats, g, kw, _ = _case("x_cross")
    grid = T.FDTDGrid(**g)
    amps = np.stack([kw["source_amp"]] * 2)
    calls = {
        "rayleigh_field": lambda: rayleigh_field(
            2 * np.pi * F0 / C, np.zeros((2, 3)), np.ones(2), np.ones(2),
            np.ones((4, 3)), mesh=mesh),
        "run_fdtd_batch": lambda: T.run_fdtd_batch(
            idx, mats, grid, amps, amps * 0, mesh=mesh),
        "run_multipoint": lambda: run_multipoint(None, None, [], mesh=mesh),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def worker(rank: int, world: int, store: str, out: str, mode: str) -> None:
    torch.set_num_threads(1)
    group = D.initialize(f"file://{store}", world, rank, timeout=60)
    if mode == "leave":  # rank 1 makes the mesh, then leaves unannounced
        idx, mats, g, kw, cut = _case("x_cross")
        mesh = _mesh(cut, group)
        torch.distributed.barrier(group)
        if rank == 1:
            os._exit(3)
        T.run_fdtd(idx, mats, T.FDTDGrid(**g), mesh=mesh, **kw)
        return
    for name in CASES:
        idx, mats, g, kw, cut = _case(name)
        res = T.run_fdtd(idx, mats, T.FDTDGrid(**g), mesh=_mesh(cut, group),
                         **kw)
        np.savez(os.path.join(out, f"{name}.{rank}.npz"), **res)
    with open(os.path.join(out, f"refusals.{rank}.json"), "w") as f:
        json.dump(_refusals(_mesh((4, 1), group)), f)
    torch.distributed.destroy_process_group()


def _launch(tmp, mode="cases"):
    """Start the two workers; returns them."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    store = os.path.join(tmp, "store")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", store, tmp,
         mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]


def _wait(procs):
    """(return code, output) of each worker, both killed at the timeout."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"workers still running after {WORKER_TIMEOUT} s")
        outs.append((p.returncode, out))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case from both workers, each case's unsharded run, and JAX's
    unsharded XLA run of each case of ``JAX_BANDS`` (both taken here while
    the workers run)."""
    from babelbrain_tpu.ops import fdtd as J

    tmp = str(tmp_path_factory.mktemp("multiprocess"))
    procs = _launch(tmp)
    whole, jax_runs = {}, {}
    for name in CASES:
        idx, mats, g, kw, _ = _case(name)
        kw = {k: v for k, v in kw.items() if k != "fuse_steps"}
        whole[name] = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu",
                                 **kw)
        if name in JAX_BANDS:
            jax_runs[name] = J.run_fdtd(idx, mats, J.FDTDGrid(**g),
                                        backend="xla", **kw)
    for r, (rc, out) in enumerate(_wait(procs)):
        assert rc == 0, f"worker {r} failed:\n{out[-3000:]}"
    parts = {name: [dict(np.load(os.path.join(tmp, f"{name}.{r}.npz")))
                    for r in range(2)] for name in CASES}
    refusals = [json.load(open(os.path.join(tmp, f"refusals.{r}.json")))
                for r in range(2)]
    return whole, parts, refusals, jax_runs


@pytest.mark.parametrize("name", CASES)
def test_two_processes_bit_equal(runs, name):
    """Both processes return the whole result, equal to the unsharded run
    bit for bit in every field (maps and monitor series included)."""
    whole, parts = runs[:2]
    o1 = whole[name]
    assert np.isfinite(o1["p_amp"]).all() and o1["p_amp"].max() > 0
    for out in parts[name]:
        assert sorted(out) == sorted(o1)
        for k in o1:
            np.testing.assert_array_equal(out[k], o1[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(JAX_BANDS))
def test_case_matches_jax_xla(runs, name):
    """Each case that JAX runs across processes, from each of the two
    processes, against JAX's unsharded XLA run at its source's band; with
    maps, the maps and the monitor series at the plane band."""
    band, rtol = JAX_BANDS[name]
    oj = runs[3][name]
    keys = ("p_amp", "peak") + (MAPS if name == "maps" else ())
    for ot in runs[1][name]:
        for k in keys:
            scale = np.abs(oj[k]).max()
            assert scale > 0, k
            np.testing.assert_allclose(ot[k], oj[k], atol=band * scale,
                                       rtol=rtol, err_msg=k)
        if name == "maps":
            np.testing.assert_allclose(
                ot["sensor_series"], oj["sensor_series"],
                atol=band * np.abs(oj["sensor_series"]).max(), rtol=rtol)
            np.testing.assert_array_equal(ot["sensor_times"],
                                          oj["sensor_times"])


def test_processes_agree_on_the_sweep_plan(monkeypatch):
    """``overlap_plan`` across processes: those with shards propose their
    plan, one with none takes theirs, and plans that differ (devices of
    different kinds) are refused instead of running with different ghost
    depths."""
    idx, mats, g, kw, _ = _case("overlap")
    grid = T.FDTDGrid(**g)
    # rank 1 of three holds no shard
    mesh = H.DeviceMesh((torch.device("cpu"),) * 4, ("x",), (4,),
                        ranks=(0, 0, 2, 2), group=object(), rank=1)
    votes = []
    monkeypatch.setattr(D, "all_gather_object", lambda obj, group: votes)
    votes[:] = [(True, (3, 9)), (False, None), (True, (3, 9))]
    assert T.overlap_plan(mesh, mats, grid, fuse_steps=3) == (3, 9)
    votes[:] = [(True, (3, 9)), (False, None), (True, None)]
    with pytest.raises(ValueError, match="different sweep plans"):
        T.overlap_plan(mesh, mats, grid, fuse_steps=3)


def test_mesh_over_processes_refused_by_other_callers(runs):
    """``rayleigh_field``, ``run_fdtd_batch`` and ``run_multipoint`` (JAX
    runs none of them across processes) refuse the mesh, naming 6c."""
    for got in runs[2]:
        assert sorted(got) == ["rayleigh_field", "run_fdtd_batch",
                               "run_multipoint"]
        assert all("item 6c" in msg for msg in got.values())


def test_nccl_group_refused():
    """An NCCL group is refused before anything starts (two ranks cannot
    share a card under NCCL; the peer path is item 6c), never swapped for
    gloo."""
    with pytest.raises(NotImplementedError, match="item 6c"):
        D.initialize("file:///nonexistent", 2, 0, backend="nccl")
    with pytest.raises(NotImplementedError, match="item 6c"):
        D.check_backend("NCCL")
    assert not torch.distributed.is_initialized()


def test_a_dead_peer_fails_the_survivor(tmp_path):
    """When rank 1 leaves after the mesh is made, rank 0's run fails in
    its first ghost-plane exchange with a nonzero exit instead of
    hanging."""
    outs = _wait(_launch(str(tmp_path), "leave"))
    assert outs[1][0] == 3
    assert outs[0][0] != 0, outs[0][1][-2000:]
    assert "_exchange" in outs[0][1], outs[0][1][-2000:]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5])
