"""Port parity: the fluid fused sweeps of ``babelbrain_tpu_torch`` on the CPU.

``run_fdtd`` runs fluid plane and point sources in fused sweeps of K steps
(``ops.fdtd_fused_kernels.fluid_fused``, the port of the JAX package's
Pallas kernels B2/B3/B4) in the schedule of the JAX driver
``simulate_fluid_pallas``; on a mesh, plane sources run overlap and
discard (``ops.fdtd.sharded_plan``, the port of ``_sharded_fusedK_plan``
and ``_simulate_fluid_pallas_sharded_fused``). Here, with the plain
versions on the CPU:

* the port's ``run_fdtd(fuse_steps=3)`` against ``simulate_fluid_pallas(
  ..., interpret=True, fuse_steps=3)`` at the sizes and bands of
  `tests/test_fused_kernel.py` (plane 1e-4 of the peak with rtol 1e-3,
  point 1e-6, reflector 1e-5), and bit-equal to the pair step by step;
* the schedule, a list of (first step, K) sweeps and a tail, against the
  JAX driver's own split (its scans recorded, not run);
* the kernel's march: every cell of every stage is written once, by one
  block, and every load, staged a march step ahead, finds a value written
  at an earlier march step that nobody writes while the copy is in
  flight (a stage lag of 5 or a load two steps ahead fail); its tile of
  two cells a thread and its shared memory, three blocks an SM;
* the sharded plan against the JAX one with ``fuse_steps`` pinned (and
  its H <= L - (npml + 2) refusal), the overlap-and-discard run on
  ``["cpu"] * 4`` bit-equal to the unsharded run, H = 3K ghost planes the
  least that is, and within 1e-5 of the peak of JAX's sharded B4 driver
  in interpret mode on 4 CPU devices.

The CUDA kernel itself is held to its plain version in
`tests/test_torch_kernels.py` (``cuda``-marked) and by ``chip_smoke.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu.parallel.halo import DomainComm
from babelbrain_tpu.parallel.halo import make_mesh as j_make_mesh
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK
from babelbrain_tpu_torch.parallel import halo as H

torch.set_num_threads(2)

F0, C = 500e3, 1500.0


def _water(shape, cycles, **kw):
    """`tests/test_fused_kernel.py`'s water grid (9 PPW, CFL 0.9, a
    2-period window) as keyword arguments of FDTDGrid."""
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, C, 0.9)))
    ns = ppp * cycles
    return dict(dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns,
                     frequency=F0, sensor_start=ns - 2 * ppp,
                     source_plane_z=13), **kw)


MATS = np.array([[1000.0, C, 0.0, 20.0, 0.0]])


def _jax_b4(g, amp, ph, point_amp=0.0, refl=None, fuse_steps=3):
    """``simulate_fluid_pallas`` in interpret mode (B4 sweeps, then B3 and
    B1's tail): (p_amp, peak)."""
    shape = g["shape"]
    idx = np.zeros(shape, np.uint8)
    coefs = J.sls_coefficients(MATS, F0, g["dt"])
    fields = J._material_fields(idx, coefs, has_shear=False)
    if refl is not None:
        J._fold_reflector(fields, refl, False)  # in place
    props = {k: jnp.asarray(v) for k, v in fields.items()}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], C, 1e-5)
    acc_c, acc_s, peak = (np.asarray(o) for o in JP.simulate_fluid_pallas(
        props, jnp.asarray(amp, jnp.float32), jnp.asarray(ph, jnp.float32),
        jnp.float32(point_amp), grid=J.FDTDGrid(**g), profiles_np=prof,
        viscous=True, oz_scale=1.0 / (1000.0 * C), nb=2, interpret=True,
        fuse_steps=fuse_steps))
    n_win = g["n_steps"] - g["sensor_start"]
    return 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2), peak


def _pair(g, amp=None, ph=None, point_amp=0.0, refl=None):
    """The port's run step by step through the pair (its plain versions)."""
    grid = T.FDTDGrid(**g)
    step, st, co, oz, _ = T.fdtd_setup(np.zeros(g["shape"], np.uint8), MATS,
                                       grid, amp, ph, refl, device="cpu")
    T._time_loop([(step, st, co, None, None)], grid, oz, point_amp)
    return T._carrier(st, grid)


def _counts():
    for d in (FK.launches, FK.plain_calls):
        for k in d:
            d[k] = 0


@pytest.mark.parametrize("case", ["plane", "point", "reflector"])
def test_fused_run_matches_jax_b4_interpret(case):
    """`tests/test_fused_kernel.py:68, :178, :229` (32x32x64 water, K = 3,
    a quiet count not divisible by 3): the port's fused run equals its pair
    bit for bit and is held to JAX's B4 driver at that file's bands."""
    shape = (32, 32, 64)
    amp = np.zeros(shape[:2])
    ph = np.zeros(shape[:2])
    refl = None
    point_amp = 0.0
    if case == "point":
        g = _water(shape, 4, source_type="stress_point",
                   source_ijk=(17, 15, 40))
        point_amp = 50e3
        amp = ph = None
        band = 1e-6
    else:
        g = _water(shape, 4)
        band = 1e-4 if case == "plane" else 1e-5
        amp[8:-8, 8:-8] = 60e3
        ph = np.random.default_rng(5).uniform(-2, 2, shape[:2])
        if case == "reflector":
            amp[:] = 0.0
            amp[6:-6, 6:-6] = 60e3
            ph = np.zeros(shape[:2])
            refl = np.zeros(shape, bool)
            refl[:, :, 44:48] = True
    g["sensor_start"] -= 1  # 41 quiet steps: K-step sweeps, a 2-step, a tail
    _counts()
    ot = T.run_fdtd(np.zeros(shape, np.uint8), MATS, T.FDTDGrid(**g),
                    source_amp=amp, source_phase=ph, point_amp=point_amp,
                    reflector_mask=refl, fuse_steps=3, device="cpu")
    key = "fluid_fused_point" if case == "point" else "fluid_fused"
    assert FK.plain_calls[key] > 0 and FK.plain_calls[key + "_dft"] > 0
    ref = _pair(g, amp, ph, point_amp, refl)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(ot[k], ref[k], err_msg=k)
    j_amp, j_peak = _jax_b4(
        g, np.zeros(shape[:2]) if amp is None else amp,
        np.zeros(shape[:2]) if ph is None else ph, point_amp, refl)
    scale = j_amp.max()
    if case == "plane":
        reg = (slice(2, -2),) * 3
        np.testing.assert_allclose(ot["p_amp"][reg], j_amp[reg],
                                   atol=band * scale, rtol=1e-3)
    else:
        np.testing.assert_allclose(ot["p_amp"], j_amp, atol=band * scale)
        np.testing.assert_allclose(ot["peak"], j_peak, atol=band * scale)
    if case == "reflector":
        assert ot["p_amp"][refl].max() == 0.0


def _jax_split(monkeypatch, g, fuse_steps):
    """The sweeps JAX's ``simulate_fluid_pallas`` schedules for ``g`` with
    ``fuse_steps`` pinned: (sweeps [(first step, K)], tail steps), from its
    ``lax.scan`` calls, recorded and not run."""
    made = []

    def maker(k):
        def make(*a, **kw):
            def step(c, n):
                return c, None
            step.k = k
            return step
        return make

    monkeypatch.setattr(JP, "_make_fluid_fusedK_step_fn",
                        lambda grid, prof, visc, oz, K, *a, **kw:
                        maker(K)())
    monkeypatch.setattr(JP, "_make_fluid_fused2_step_fn", maker(2))
    monkeypatch.setattr(JP, "make_fluid_pallas_step", maker(1))

    def scan(f, carry, xs):
        made.append((f.k, [int(v) for v in np.asarray(xs)]))
        return carry, None

    monkeypatch.setattr(jax.lax, "scan", scan)
    shape = g["shape"]
    zeros2 = jnp.zeros(shape[:2], jnp.float32)
    props = {k: jnp.zeros(shape, jnp.float32)
             for k in ("rho_inv", "pi_u", "c_rp", "b_r")}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], C, 1e-5)
    JP.simulate_fluid_pallas(props, zeros2, zeros2, grid=J.FDTDGrid(**g),
                             profiles_np=prof, viscous=True, oz_scale=1.0,
                             nb=2, interpret=True, fuse_steps=fuse_steps)
    sweeps = [(n, k) for k, ns in made if k > 1 for n in ns]
    tail = [n for k, ns in made if k == 1 for n in ns]
    return sweeps, tail


@pytest.mark.parametrize("k,quiet,n_steps", [(3, 41, 97), (4, 42, 100),
                                             (5, 17, 61), (3, 0, 20),
                                             (4, 30, 30)])
def test_schedule_matches_jax_run_phase(monkeypatch, k, quiet, n_steps):
    """``fused_schedule`` with K pinned: the same sweeps and tail as the
    JAX driver's ``run_phase`` (K-step sweeps, 2-step sweeps, the one-step
    tail, in the quiet phase and in the window)."""
    g = _water((48, 16, 24), 2, n_steps=n_steps, sensor_start=quiet)
    sweeps, tail = _jax_split(monkeypatch, g, k)
    plan = T.fused_plan(g["shape"], "cpu", True, False, fuse_steps=k)
    ours = T.fused_schedule(T.FDTDGrid(**g), plan)
    assert [(n, m) for n, m, _ in ours if m > 1] == sweeps
    assert [n for n, m, _ in ours if m == 1] == tail
    # every step once, in order, the window's with the DFT
    steps = [n + j for n, m, _ in ours for j in range(m)]
    assert steps == list(range(n_steps))
    assert all(dft == (n >= quiet) for n, _, dft in ours)


def test_fuse_steps_none_and_refusals(monkeypatch):
    """``fuse_steps=None`` takes min(admitted, FUSE_BEST) in both phases
    (on the CPU nothing bounds the depth), with 2-step sweeps only while
    FUSE_BEST >= 2 (0: the pair for every step); pinned depths beyond the
    launch's K_CAP are refused."""
    plan = T.fused_plan((40, 40, 40), "cpu", True, False)
    assert plan == T.FusedPlan(FK.FUSE_BEST, FK.FUSE_BEST, FK.FUSE_BEST >= 2)
    for best, fused2 in ((0, False), (4, True)):
        monkeypatch.setattr(T, "FUSE_BEST", best)
        assert T.fused_plan((40, 40, 40), "cpu", True, False) == T.FusedPlan(
            best, best, fused2)
    with pytest.raises(ValueError):
        T.fused_plan((40, 40, 40), "cpu", True, False, FK.K_CAP + 1)
    g = _water((24, 24, 40), 2, n_steps=12, sensor_start=5)
    st = T.fdtd_setup(np.zeros(g["shape"], np.uint8), MATS, T.FDTDGrid(**g),
                      np.zeros((24, 24)), np.zeros((24, 24)), device="cpu")
    with pytest.raises(ValueError):
        FK.fluid_fused(st[1], st[2], [(0.0,) * 5] * (FK.K_CAP + 1))


def _march_errors(n1, k):
    """Read-before-write violations of ``march(n1, k)``. A stage's loads are
    issued a step ahead of the step that reads them and land before the
    barrier that ends their own step; each must find its value at the
    version the stage needs (its own input: version s of p's and of the
    velocities' family; the vy / vz ring of its pressure plane: version
    s + 1, the new velocities), written at an earlier march step than the
    one that issues the load, and nobody may write it in the step that
    issues it nor, but for a cell's own values, in the next (the copy is in
    flight; with 16-byte copies it may land after the barrier). The
    register windows must still hold
    the current version when they are read: p at planes i - 1..i + 2 for
    the velocity, p at the pressure's plane, the new vx at ip - 2..ip + 1
    written by this stage at the steps before."""
    ver = {f: [0] * n1 for f in ("p", "v")}  # updates applied to a plane
    when = {f: [-n1 - 9] * n1 for f in ("p", "v")}  # step of the last one
    vx_at = {}  # (stage, plane) -> march step of this stage's new vx
    in_flight = set()  # the copies issued in the step before
    errs = []
    for t, row in FK.march(n1, k):
        writes = []
        for s, i, ip, loads in row:
            for f, x, role in loads:
                need = s + 1 if (f, role) == ("v", "ring") else s
                if ver[f][x] != need or when[f][x] >= t:
                    errs.append(("load", t, s, f, x, role, ver[f][x], need))
            if i is not None:
                errs += [("window", t, s, "p", x) for x in range(i - 1, i + 3)
                         if 0 <= x < n1 and ver["p"][x] != s]
                writes.append(("v", i, s))
                vx_at[(s, i)] = t
            if ip is not None:
                if ver["p"][ip] != s:
                    errs.append(("window", t, s, "p", ip))
                errs += [("vx", t, s, x) for x in range(ip - 2, ip + 2)
                         if 0 <= x < n1 and not vx_at.get((s, x), t) < t]
                writes.append(("p", ip, s))
        issued = {(f, x) for _, _, _, loads in row for f, x, _ in loads}
        errs += [("race", t, s, f, x) for f, x, s in writes
                 if (f, x) in issued
                 or any(x == y and f == g and (role != "own" or s != u)
                        for u, g, y, role in in_flight)]
        # a copy may land after the barrier: nobody writes it in the next
        # step either, but a cell's owner (its stage), after it waits for
        # the copies
        in_flight = {(u, f, x, role) for u, _, _, loads in row
                     for f, x, role in loads}
        for f, x, s in writes:
            ver[f][x] += 1
            when[f][x] = t
    assert all(v == k for f in ver for v in ver[f]), "a plane not updated"
    return errs


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_march_and_launch_geometry(k):
    """The kernel's march at ragged plane counts: every plane of every
    stage updated once, every staged load and register window ordered by a
    barrier (``LAG`` = 6, ``PLAG`` = 2); the launch's blocks cover every
    (y, z) column of every stage once on ragged grids, a thread's
    ``CELLS`` cells ``TILE_Y`` rows apart in its block's ``ROWS`` rows."""
    for n1 in (27, 37, 50):
        assert _march_errors(n1, k) == []
    for shape in ((27, 45, 47), (37, 41, 57), (50, 192, 240)):
        geo = FK.fused_launch_geometry(shape, k)
        gz, gy, gs = geo.grid
        assert gs == k and geo.segment == shape[0]
        assert geo.tile_y == FK.ROWS == FK.TILE_Y * FK.CELLS
        hits = np.zeros((k,) + shape[1:], int)
        for s in range(gs):
            for by in range(gy):
                for bz in range(gz):
                    for ty in range(FK.TILE_Y):
                        rows = [j for c in range(FK.CELLS)
                                if (j := by * FK.ROWS + ty + c * FK.TILE_Y)
                                < shape[1]]
                        hits[s, rows, bz * FK.TILE_Z:(bz + 1) * FK.TILE_Z] \
                            += 1
        assert (hits == 1).all()


@pytest.mark.parametrize("name,value", [("LAG", FK.LAG - 1),
                                        ("PREFETCH", FK.PREFETCH + 1)])
def test_march_lag_is_the_least_that_orders(monkeypatch, name, value):
    """Five planes between the stages would let stage s load the newest
    plane of its p window in the step stage s - 1 writes it; a load issued
    two steps ahead would copy the vy / vz ring of its pressure plane in
    the step that writes it."""
    monkeypatch.setattr(FK, name, value)
    assert _march_errors(37, 3)


def test_fused_launch_fits_three_blocks_an_sm():
    """The shared memory a block takes (two ring buffers of whole 16-byte
    chunks, 17 staged values a cell, two mbarriers) and its 80 registers a
    thread (``__launch_bounds__(256, 3)``) let three blocks share an H100
    SM (228 KB of shared memory, 1 KB reserved a block; 64K registers):
    396 blocks, so K = 4 on the 192x192x240 and 216x216x224 grids, as
    ``admitted_depth`` would find from a capacity of 396."""
    ring = ((FK.ROWS + 3) * (FK.TILE_Z + 8) + (FK.ROWS + 3) * FK.TILE_Z
            + FK.ROWS * (FK.TILE_Z + 8))
    assert ring == FK.RING == 2008 and ring % 4 == 0
    assert FK.SMEM_BYTES == 16 + 4 * (2 * ring + FK.SLOTS * 512) == 50896
    assert 3 * (FK.SMEM_BYTES + 1024) <= 233472
    assert 3 * 256 * 80 <= 65536 < 4 * 256 * 80
    for shape in ((192, 192, 240), (216, 216, 224)):
        gz, gy, _ = FK.fused_launch_geometry(shape, 1).grid
        assert 396 // (gz * gy) == 4


def test_sharded_plan_matches_jax():
    """``sharded_plan`` with ``fuse_steps`` pinned against
    ``_sharded_fusedK_plan``: the same K wherever JAX finds a plan (H = 3K
    ghost planes here, 4K there), and both refuse a halo that would reach
    an edge neighbour's x-PML slab (H > L - (npml + 2))."""
    npml = 12
    ns = npml + 2
    g = _water((128, 16, 24), 2)
    for width in (24, 32, 40, 64):
        grid = J.FDTDGrid(**dict(g, shape=(width, 16, 24)))
        for k in (2, 3, 4, 5, 6):
            jp = JP._sharded_fusedK_plan(width, 2, npml, k, grid)
            tp = T.sharded_plan(width, T.FDTDGrid(**g), "cpu", True, k)
            if jp is not None:
                assert tp == (jp[0], 3 * jp[0])
            if tp is None:
                assert jp is None
                assert 3 * k > width - ns
            else:
                assert tp[1] <= width - ns
    # the guard itself: 24 planes a shard leave 10 for ghost planes
    assert T.sharded_plan(24, T.FDTDGrid(**g), "cpu", True, 4) is None
    assert T.sharded_plan(24, T.FDTDGrid(**g), "cpu", True, 3) == (3, 9)
    assert JP._sharded_fusedK_plan(24, 2, npml, 3, J.FDTDGrid(**g)) is None
    # None: the deepest K from FUSE_BEST down that fits (none below 2)
    assert T.sharded_plan(24, T.FDTDGrid(**g), "cpu", True) == (
        (3, 9) if T.FUSE_BEST >= 3 else None)
    try:
        best, T.FUSE_BEST = T.FUSE_BEST, 4
        assert T.sharded_plan(24, T.FDTDGrid(**g), "cpu", True) == (3, 9)
        assert T.sharded_plan(20, T.FDTDGrid(**g), "cpu", True) == (2, 6)
        assert T.sharded_plan(16, T.FDTDGrid(**g), "cpu", True) is None
    finally:
        T.FUSE_BEST = best


def _sharded_case():
    """`tests/test_torch_sharded.py:311`'s fluid case: (128, 32, 48) water,
    a seeded plane, 2 cycles."""
    shape = (128, 32, 48)
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, cfl=0.9)))
    ns = ppp * 2
    g = dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns, frequency=F0,
             npml=12, sensor_start=ns - 2 * ppp + 1, source_plane_z=13)
    rng = np.random.default_rng(3)
    amp = np.zeros(shape[:2], np.float32)
    amp[10:-10, 10:22] = 60e3 * rng.uniform(0.5, 1, (108, 12)).astype(
        np.float32)
    ph = rng.uniform(-2, 2, shape[:2]).astype(np.float32)
    return g, amp, ph


@functools.cache
def _sharded_runs():
    g, amp, ph = _sharded_case()
    idx = np.zeros(g["shape"], np.uint8)
    mesh = H.make_mesh(4, devices=["cpu"] * 4)
    plan = T.overlap_plan(mesh, MATS, T.FDTDGrid(**g), fuse_steps=3)
    _counts()
    sharded = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), amp, ph, mesh=mesh,
                         fuse_steps=3)
    calls = dict(FK.plain_calls)
    whole = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), amp, ph, device="cpu")
    return plan, calls, sharded, whole


def test_overlap_and_discard_is_bit_equal():
    """On ``["cpu"] * 4`` (32 planes a shard) the plane-source run goes
    overlap and discard with (K, H) = (3, 9): one fused launch a shard a
    sweep, equal to the unsharded run bit for bit."""
    plan, calls, sharded, whole = _sharded_runs()
    g = _sharded_case()[0]
    assert plan == (3, 9)
    sweeps = T.overlap_schedule(T.FDTDGrid(**g), 3)
    assert calls["fluid_fused"] == 4 * sum(not d for _, _, d in sweeps)
    assert calls["fluid_fused_dft"] == 4 * sum(d for _, _, d in sweeps)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(sharded[k], whole[k], err_msg=k)


def test_overlap_halo_covers_the_contamination():
    """H = 3K ghost planes keep the own planes exact, and the array's edge
    does contaminate: with K ghost planes the own planes differ (each step
    reaches 3 planes further, d_plus reading -1..+2 and d_minus -2..+1; the
    contributions of the farthest planes can round away in float32, so
    3K - 1 may still come out equal)."""
    g, amp, ph = _sharded_case()
    g = dict(g, n_steps=24, sensor_start=12)
    idx = np.zeros(g["shape"], np.uint8)
    mesh = H.make_mesh(4, devices=["cpu"] * 4)
    grid = T.FDTDGrid(**g)
    whole = T.run_fdtd(idx, MATS, grid, amp, ph, device="cpu")
    out = {}
    for h in (9, 3):
        xs, shards, oz = T.shard_setup(mesh, idx, MATS, grid, amp, ph,
                                       halo=h)
        for n, k, dft in T.overlap_schedule(grid, 3):
            T.sweep_shards(shards, xs, grid, n, k, dft, oz)
        out[h] = T._carrier_of(*(T.own_planes(xs, [getattr(sh.st, f)
                                                   for sh in shards])
                                 for f in ("acc_cos", "acc_sin", "peak")),
                               grid)
    assert all(np.array_equal(out[9][k], whole[k]) for k in whole)
    assert not np.array_equal(out[3]["peak"], whole["peak"])


def test_refresh_group_moves_each_group_once():
    """``Blocks.refresh_group`` fills the ghost planes of every tensor of a
    group as ``refresh`` does one by one."""
    xs = H.XSlabs(24, 3, halo=3)
    dd = H.Blocks(xs, H.XSlabs(4, 1, axis=1))
    rng = np.random.default_rng(0)
    groups = [[torch.as_tensor(rng.standard_normal((xs.planes(s), 4, 5)),
                               dtype=torch.float32) for _ in range(3)]
              for s in range(3)]
    ref = [[t.clone() for t in g] for g in groups]
    dd.refresh_group(groups)
    for f in range(3):
        dd.refresh([g[f] for g in ref], 0)
    for a, b in zip(groups, ref):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_overlap_run_matches_jax_b4_sharded():
    """The overlap-and-discard run against JAX's sharded B4 driver
    (``_simulate_fluid_pallas_sharded_fused``, K = 3) in interpret mode on
    4 CPU devices, within 1e-5 of the peak (`tests/test_torch_sharded.py
    :298`)."""
    g, amp, ph = _sharded_case()
    n = 4
    shape = g["shape"]
    idx = np.zeros(shape, np.uint8)
    coefs = J.sls_coefficients(MATS, F0, g["dt"])
    props = {k: jnp.asarray(v) for k, v in J._material_fields(
        idx, coefs, has_shear=False).items()}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], C, 1e-5)
    grid_local = dataclasses.replace(J.FDTDGrid(**g),
                                     shape=(shape[0] // n,) + shape[1:])
    spec3, spec2 = PS("x", None, None), PS("x", None)
    run = jax.jit(jax.shard_map(
        functools.partial(JP.simulate_fluid_pallas, grid=grid_local,
                          comm=DomainComm("x", n), interpret=True,
                          profiles_np=prof, viscous=True,
                          oz_scale=1.0 / (1000.0 * C), nb=2, fuse_steps=3),
        mesh=j_make_mesh(n),
        in_specs=({k: spec3 for k in props}, spec2, spec2),
        out_specs=(spec3, spec3, spec3), check_vma=False,
    ))
    acc_c, acc_s, peak = (np.asarray(o) for o in run(
        props, jnp.asarray(amp), jnp.asarray(ph)))
    n_win = g["n_steps"] - g["sensor_start"]
    j_amp = 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2)
    sharded = _sharded_runs()[2]
    scale = j_amp.max()
    np.testing.assert_allclose(sharded["p_amp"], j_amp, atol=1e-5 * scale)
    np.testing.assert_allclose(sharded["peak"], peak, atol=1e-5 * scale)
