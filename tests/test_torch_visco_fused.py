"""Port parity: the viscoelastic fused sweeps of ``babelbrain_tpu_torch`` on
the CPU.

``run_fdtd`` runs shear media with a plane or point source in fused sweeps
of K steps (``ops.fdtd_visco_fused_kernels.visco_fused``, the port of the
JAX package's Pallas kernels B6/B7/B8) in the schedule of the JAX driver
``simulate_visco_pallas``; on a mesh, plane sources run overlap and discard
(``ops.fdtd.sharded_plan(visco=True)``, the port of ``_sharded_fusedK_plan
(K_cap=4)`` and ``_simulate_visco_pallas_sharded_fused``). Here, with the
plain versions on the CPU:

* the port's ``run_fdtd(fuse_steps=3)`` with a stress point, indexed
  materials and a reflector against ``simulate_visco_pallas(...,
  interpret=True, fuse_steps=3, mat_idx=, mat_table=)`` at the reflector
  band of `tests/test_fused_kernel.py` (1e-5 of the peak), and bit-equal to
  the pair step by step;
* the schedule against the JAX driver's own split (its scans recorded, not
  run), and the refusals of a pinned K;
* the kernel's march: every plane of every stage is written once, and every
  value a thread reads was written at the step it needs, by an earlier march
  step where another thread wrote it, and is overwritten only at a later
  one (``LAG - 1`` and ``STRESS_LAG - 1`` fail);
* the sharded plan against the JAX one with ``fuse_steps`` pinned (and its
  H <= L - (npml + 2) refusal), the overlap-and-discard run on
  ``["cpu"] * 4`` bit-equal to the unsharded run, 4K ghost planes exact
  (and 3K, the edge's true reach, but not 3K - 1), and ``refresh_group``
  over the visco state's groups.

The CUDA kernel itself is held to its plain version and to K launches of
the pair in `tests/test_torch_kernels.py` (``cuda``-marked) and by
``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu_torch import convert
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
from babelbrain_tpu_torch.parallel import halo as H

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
CMAX = 2494.0
# water with attenuation, a cortical-bone slab with shear, skin
# (`tests/test_fused_kernel.py:393-435`)
MATS = np.array([[1000.0, C, 0.0, 20.0, 0.0],
                 [1896.5, CMAX, 1594.0, 106.0, 214.0],
                 [1116.0, 1537.0, 0.0, 2.99, 0.0]])


def _grid(shape, periods, **kw):
    """A 9-PPW grid at CFL 0.9 of the bone's speed, the window the last
    period (keyword arguments of FDTDGrid)."""
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, CMAX, 0.9)))
    ns = ppp * periods
    return dict(dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns,
                     frequency=F0, sensor_start=ns - ppp,
                     source_plane_z=13), **kw)


def _layers(shape):
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 30:38] = 1
    idx[:, :, 38:42] = 2
    return idx


def _counts():
    for mod in (VF, V):
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0


def _pair(idx, g, amp, ph, point_amp, refl):
    """The port's run step by step through the pair (its plain versions)."""
    grid = T.FDTDGrid(**g)
    step, st, co, oz, _ = T.fdtd_setup(idx, MATS, grid, amp, ph, refl,
                                       device="cpu")
    T._time_loop([(step, st, co, None, None)], grid, oz, point_amp)
    return T._carrier(st, grid)


def _jax_b8(idx, g, amp, ph, point_amp, refl):
    """``simulate_visco_pallas`` in interpret mode with K = 3 and the
    indexed materials (B8 sweeps, then B7's and the one-step tail):
    (p_amp, peak)."""
    shape = g["shape"]
    coefs = J.sls_coefficients(MATS, F0, g["dt"])
    props = J._material_fields(idx, coefs, has_shear=True)
    if refl is not None:
        J._fold_reflector(props, refl, True)
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], CMAX, 1e-5)
    mi, mt = J._build_indexed_materials(coefs, idx, refl, shape[2])
    acc_c, acc_s, peak = (np.asarray(o) for o in JP.simulate_visco_pallas(
        {k: jnp.asarray(v) for k, v in props.items()},
        jnp.asarray(amp, jnp.float32), jnp.asarray(ph, jnp.float32),
        jnp.float32(point_amp), grid=J.FDTDGrid(**g), profiles_np=prof,
        viscous=True, oz_scale=1.0 / (1000.0 * C), nb=2, interpret=True,
        fuse_steps=3, mat_idx=jnp.asarray(mi), mat_table=jnp.asarray(mt)))
    n_win = g["n_steps"] - g["sensor_start"]
    return 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2), peak


def test_fused_run_matches_jax_b8_interpret():
    """32x32x64 with the bone and skin slabs and an air-cavity reflector,
    a 50 kPa stress point 2 cells past the skin, K = 3: a 2-step quiet
    phase (two one-step tails: a 3-step sweep does not fit) and a 36-step
    window (twelve 3-step sweeps). The port's fused run (``visco_fused``,
    counted) equals its pair step by step bit for bit, and is held to JAX's
    B8 driver with the same indexed materials at `tests/test_fused_kernel
    .py`'s reflector band, 1e-5 of the peak (`:278`; its point band is 1e-6,
    `:224`, for a run without a reflector); the air stays silent on both.
    (JAX builds one kernel a phase and source: the 2-step sweeps are held
    to JAX's split below.)"""
    shape = (32, 32, 64)
    idx = _layers(shape)
    g = _grid(shape, 2, n_steps=38, sensor_start=2,
              source_type="stress_point", source_ijk=(17, 15, 44))
    point_amp = 50e3
    refl = np.zeros(shape, bool)
    refl[10:20, 10:20, 47:50] = True
    _counts()
    ot = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), point_amp=point_amp,
                    reflector_mask=refl, fuse_steps=3, device="cpu")
    assert VF.plain_calls == {"visco_fused": 0, "visco_fused_dft": 0,
                              "visco_fused_point": 0,
                              "visco_fused_point_dft": 12}
    assert V.plain_calls["visco_stress_point"] == 2
    assert V.plain_calls["visco_stress_point_dft"] == 36
    assert all(v == 0 for v in VF.launches.values())
    ref = _pair(idx, g, None, None, point_amp, refl)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(ot[k], ref[k], err_msg=k)
    zeros = np.zeros(shape[:2])
    j_amp, j_peak = _jax_b8(idx, g, zeros, zeros, point_amp, refl)
    scale = j_amp.max()
    assert scale > 0
    np.testing.assert_allclose(ot["p_amp"], j_amp, atol=1e-5 * scale)
    np.testing.assert_allclose(ot["peak"], j_peak, atol=1e-5 * scale)
    assert ot["p_amp"][refl].max() == 0.0 and j_amp[refl].max() == 0.0


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _jax_split(monkeypatch, g, fuse_steps):
    """The sweeps JAX's ``simulate_visco_pallas`` schedules for ``g`` with
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

    monkeypatch.setattr(JP, "_make_visco_fusedK_step_fn",
                        lambda grid, prof, visc, oz, K, *a, **kw:
                        maker(K)())
    monkeypatch.setattr(JP, "_make_visco_fused2_step_fn", maker(2))
    monkeypatch.setattr(JP, "make_visco_pallas_step", maker(1))

    def scan(f, carry, xs):
        made.append((f.k, [int(v) for v in np.asarray(xs)]))
        return carry, None

    monkeypatch.setattr(jax.lax, "scan", scan)
    shape = g["shape"]
    zeros2 = jnp.zeros(shape[:2], jnp.float32)
    props = {k: jnp.zeros(shape, jnp.float32)
             for k in ("rho_inv", "pi_u", "mu_u", "c_rp", "c_rs", "b_r")}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], CMAX, 1e-5)
    JP.simulate_visco_pallas(props, zeros2, zeros2, jnp.float32(0.0),
                             grid=J.FDTDGrid(**g), profiles_np=prof,
                             viscous=True, oz_scale=1.0, nb=2,
                             interpret=True, fuse_steps=fuse_steps)
    sweeps = [(n, k) for k, ns in made if k > 1 for n in ns]
    tail = [n for k, ns in made if k == 1 for n in ns]
    return sweeps, tail


@pytest.mark.parametrize("source", ["plane", "point"])
@pytest.mark.parametrize("k,quiet,n_steps", [(2, 41, 97), (3, 41, 97),
                                             (4, 42, 100), (3, 0, 20),
                                             (4, 30, 30), (1, 17, 60)])
def test_schedule_matches_jax_run_phase(monkeypatch, source, k, quiet,
                                        n_steps):
    """``fused_schedule`` of ``visco_plan`` with K pinned: the same sweeps
    and tail as the JAX driver's ``run_phase`` (K-step sweeps from K = 2,
    then 2-step sweeps for a plane source only, then the one-step tail, in
    the quiet phase and in the window; odd and even phase lengths)."""
    kw = {} if source == "plane" else dict(source_type="stress_point",
                                           source_ijk=(20, 8, 12))
    g = _grid((48, 16, 24), 2, n_steps=n_steps, sensor_start=quiet, **kw)
    sweeps, tail = _jax_split(monkeypatch, g, k)
    plan = T.visco_plan(g["shape"], "cpu", True, source == "point",
                        fuse_steps=k)
    ours = T.fused_schedule(T.FDTDGrid(**g), plan)
    assert [(n, m) for n, m, _ in ours if m > 1] == sweeps
    assert [n for n, m, _ in ours if m == 1] == tail
    # every step once, in order, the window's with the DFT
    steps = [n + j for n, m, _ in ours for j in range(m)]
    assert steps == list(range(n_steps))
    assert all(dft == (n >= quiet) for n, _, dft in ours)


def test_fuse_steps_none_and_refusals(monkeypatch):
    """``fuse_steps=None`` takes min(admitted, VISCO_FUSE_BEST) in both
    phases (on the CPU nothing bounds the depth), 2-step sweeps for a plane
    source only; a pinned K beyond ``K_CAP``, or beyond what the card holds
    (``admitted_depth``), is refused, K = 1 never; the wrapper refuses more
    than ``K_CAP`` rows."""
    best = VF.VISCO_FUSE_BEST
    assert T.visco_plan((40, 40, 40), "cpu", True, False) == T.FusedPlan(
        best, best, True, 2)
    assert T.visco_plan((40, 40, 40), "cpu", True, True) == T.FusedPlan(
        best, best, False, 2)
    for k in (VF.K_CAP + 1, -1):
        with pytest.raises(ValueError):
            T.visco_plan((40, 40, 40), "cpu", True, False, k)
    monkeypatch.setattr(VF, "admitted_depth", lambda *a, **kw: 1)
    with pytest.raises(ValueError, match="holds 1 stages"):
        T.visco_plan((40, 40, 40), "cpu", True, False, 2)
    assert T.visco_plan((40, 40, 40), "cpu", True, False, 1) == T.FusedPlan(
        1, 1, False, 2)
    assert T.visco_plan((40, 40, 40), "cpu", True, False) == T.FusedPlan(
        1, 1, False, 2)
    monkeypatch.undo()
    g = _grid((24, 24, 40), 2, n_steps=12, sensor_start=5)
    st = T.fdtd_setup(_layers(g["shape"]), MATS, T.FDTDGrid(**g),
                      np.zeros((24, 24)), np.zeros((24, 24)), device="cpu")
    with pytest.raises(ValueError):
        VF.visco_fused(st[1], st[2], [(0.0,) * 5] * (VF.K_CAP + 1))


def test_cpu_run_counts_plain_calls():
    """``run_fdtd`` in shear media (plane source, ``fuse_steps=None``) runs
    ``visco_fused``'s plain version a sweep and the pair's for the tails:
    12 quiet steps at K = 2 and a 5-step window (two sweeps, one tail);
    the pair's plain versions count the sweeps' steps too, and nothing is
    launched."""
    g = _grid((20, 20, 48), 2, n_steps=17, sensor_start=12)
    _counts()
    out = T.run_fdtd(_layers(g["shape"]), MATS, T.FDTDGrid(**g),
                     source_amp=np.full((20, 20), 1e3), device="cpu")
    assert VF.VISCO_FUSE_BEST == 2
    assert VF.plain_calls == {"visco_fused": 6, "visco_fused_dft": 2,
                              "visco_fused_point": 0,
                              "visco_fused_point_dft": 0}
    assert V.plain_calls == {
        "visco_velocity": 17, "visco_stress": 12, "visco_stress_dft": 5,
        "visco_stress_point": 0, "visco_stress_point_dft": 0}
    assert all(v == 0 for v in VF.launches.values())
    assert all(v == 0 for v in V.launches.values())
    assert np.isfinite(out["p_amp"]).all() and out["p_amp"].max() > 0


# ---------------------------------------------------------------------------
# the kernel's march
# ---------------------------------------------------------------------------


def _march_errors(n1, k):
    """Read-before-write violations of ``march(n1, k)``. Per field family
    ("v": the velocities; "s": the stresses, with each cell's SLS memories,
    psi and DFT sums) and plane, the updates applied and the march step of
    the last one. A velocity of plane i at stage s reads the stresses as
    stage s - 1 left them: its neighbours' in plane i, and along x its own
    column's as each plane enters its window (sxx at i + 2, sxy / sxz at
    i + 1; at i = 0 planes 0..2), and its own v. A stress of plane i reads
    the velocities of stage s: its neighbours' in plane i, and along x this
    thread's own new values of planes i - 2..i + 2 (held in registers, so
    written by this stage at this step or before); and its own cell's
    stress state. A value another thread wrote must have been written at an
    earlier march step, and no other thread may write what is read in the
    same step."""
    ver = {f: [0] * n1 for f in ("v", "s")}  # updates applied to a plane
    when = {f: [-1] * n1 for f in ("v", "s")}  # march step of the last one
    errs = []
    for t, row in enumerate(VF.march(n1, k)):
        reads, writes = [], []
        for s, i, js in row:
            if i is not None:
                reads.append(("s", i, s, s, "neighbour"))
                enter = range(0, 3) if i == 0 else (i + 1, i + 2)
                reads += [("s", x, s, s, "own") for x in enter if x < n1]
                reads.append(("v", i, s, s, "own"))
                writes.append(("v", i, s))
            if js is not None:
                # the x-windows: this thread's own velocities, the newest
                # (vy, vz at js + 2) written earlier in this march step
                errs += [(t, s, "v window", x)
                         for x in range(js - 2, js + 3)
                         if 0 <= x < n1 and not (ver["v"][x] == s + 1
                                                 or x == i)]
                reads.append(("v", js, s, s + 1, "neighbour"))
                reads.append(("s", js, s, s, "own"))
                writes.append(("s", js, s))
        for f, x, s, need, _ in reads:
            if ver[f][x] != need or (need > 0 and when[f][x] >= t):
                errs.append((t, s, f, x, ver[f][x], need))
        written = {(f, x): s for f, x, s in writes}
        errs += [("race", t, s, f, x) for f, x, s, _, kind in reads
                 if (f, x) in written
                 and (written[(f, x)] != s or kind == "neighbour")]
        for f, x, s in writes:
            ver[f][x] += 1
            when[f][x] = t
    assert all(v == k for f in ver for v in ver[f]), "a plane not updated"
    return errs


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_march_orders_every_read(k):
    """The kernel's march at ragged plane counts: every plane of every
    stage updated once, every cross-thread read ordered by a barrier; the
    launch's blocks cover every (y, z) column of every stage once."""
    for n1 in (27, 37, 50):
        assert _march_errors(n1, k) == []
    for shape in ((27, 45, 47), (50, 192, 240)):
        gz, gy, gs = VF.fused_launch_geometry(shape, k).grid
        assert gs == k and gz * 32 >= shape[2] > (gz - 1) * 32
        assert gy * 8 >= shape[1] > (gy - 1) * 8


@pytest.mark.parametrize("name", ["LAG", "STRESS_LAG"])
def test_march_lags_are_the_least_that_order(monkeypatch, name):
    """Four planes between the stages would let stage s + 1's velocity read
    an sxx stage s writes in the same march step (it reads 2 planes ahead,
    stage s's stress writes 2 planes behind its velocity); a stress one
    plane behind its velocity would read a vy, vz its thread has not
    computed yet."""
    monkeypatch.setattr(VF, name, getattr(VF, name) - 1)
    assert _march_errors(37, 3)


# ---------------------------------------------------------------------------
# x decomposition: overlap and discard
# ---------------------------------------------------------------------------


def test_sharded_plan_matches_jax():
    """``sharded_plan(visco=True)`` with ``fuse_steps`` pinned against
    ``_sharded_fusedK_plan(..., K_cap=4)``: the same (K, H = 4K) wherever
    JAX finds a plan, and both refuse a halo that would reach an edge
    neighbour's x-PML slab (H > L - (npml + 2)); ``None`` takes
    ``VISCO_FUSE_BEST``."""
    npml = 12
    ns = npml + 2
    g = _grid((128, 16, 24), 2)
    for width in (20, 24, 30, 32, 40, 64):
        grid = J.FDTDGrid(**dict(g, shape=(width, 16, 24)))
        for k in (2, 3, 4):
            jp = JP._sharded_fusedK_plan(width, 2, npml, k, grid, K_cap=4)
            tp = T.sharded_plan(width, T.FDTDGrid(**g), "cpu", True, k,
                                visco=True)
            assert tp == (None if jp is None else jp[:2])
            assert (tp is None) == (4 * k > width - ns)
    assert T.sharded_plan(30, T.FDTDGrid(**g), "cpu", True, 4,
                          visco=True) == (4, 16)
    assert T.sharded_plan(29, T.FDTDGrid(**g), "cpu", True, 4,
                          visco=True) is None
    best = VF.VISCO_FUSE_BEST
    assert T.sharded_plan(32, T.FDTDGrid(**g), "cpu", True,
                          visco=True) == (best, 4 * best)
    assert T.sharded_plan(21, T.FDTDGrid(**g), "cpu", True,
                          visco=True) is None


def _sharded_case(n_steps=None):
    """(128, 24, 48) water with the bone and skin slabs, a seeded plane, 2
    periods (32 planes a shard over 4)."""
    shape = (128, 24, 48)
    g = _grid(shape, 2)
    if n_steps is not None:
        g.update(n_steps=n_steps, sensor_start=n_steps // 2)
    rng = np.random.default_rng(3)
    amp = np.zeros(shape[:2], np.float32)
    amp[10:-10, 4:20] = 60e3 * rng.uniform(0.5, 1, (108, 16)).astype(
        np.float32)
    ph = rng.uniform(-2, 2, shape[:2]).astype(np.float32)
    return _layers(shape), g, amp, ph


@functools.cache
def _sharded_runs():
    idx, g, amp, ph = _sharded_case()
    mesh = H.make_mesh(4, devices=["cpu"] * 4)
    plan = T.overlap_plan(mesh, MATS, T.FDTDGrid(**g))
    _counts()
    sharded = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), amp, ph, mesh=mesh)
    calls = dict(VF.plain_calls)
    whole = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), amp, ph, device="cpu")
    return plan, calls, sharded, whole


def test_overlap_and_discard_is_bit_equal():
    """On ``["cpu"] * 4`` the shear plane-source run goes overlap and
    discard with (K, H) = (2, 8): one ``visco_fused`` launch a shard a
    sweep, equal to the unsharded run bit for bit."""
    plan, calls, sharded, whole = _sharded_runs()
    g = _sharded_case()[1]
    assert plan == (2, 8)
    sweeps = T.overlap_schedule(T.FDTDGrid(**g), 2)
    assert calls["visco_fused"] == 4 * sum(not d for _, _, d in sweeps)
    assert calls["visco_fused_dft"] == 4 * sum(d for _, _, d in sweeps)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(sharded[k], whole[k], err_msg=k)


def test_overlap_halo_covers_the_contamination():
    """H = 4K ghost planes (JAX's count) keep the own planes exact, and the
    array's edge does contaminate: a visco step reaches 3 planes further
    toward each side, as the fluid step does (each half-step reads +-2
    planes along x, but a chain of fields alternates between forward and
    backward differences: vx reads sxx up to 2 planes ahead, sxx reads vx 1
    ahead; vy, vz read sxy, sxz 1 ahead, which read them 2 ahead), so 3K
    ghost planes are exact too, and 3K - 1 are not."""
    idx, g, amp, ph = _sharded_case(n_steps=24)
    mesh = H.make_mesh(4, devices=["cpu"] * 4)
    grid = T.FDTDGrid(**g)
    whole = T.run_fdtd(idx, MATS, grid, amp, ph, device="cpu")
    k = 2
    out = {}
    for h in (4 * k, 3 * k, 3 * k - 1):
        xs, shards, oz = T.shard_setup(mesh, idx, MATS, grid, amp, ph,
                                       halo=h)
        for n, m, dft in T.overlap_schedule(grid, k):
            T.sweep_shards(shards, xs, grid, n, m, dft, oz)
        out[h] = T._carrier_of(*(T.own_planes(xs, [getattr(sh.st, f)
                                                   for sh in shards])
                                 for f in ("acc_cos", "acc_sin", "peak")),
                               grid)
    for h in (4 * k, 3 * k):
        assert all(np.array_equal(out[h][f], whole[f]) for f in whole), h
    assert not np.array_equal(out[3 * k - 1]["peak"], whole["peak"])


def test_refresh_group_over_the_visco_groups():
    """``state_groups`` of a visco state: the 15 fields, the 12 y psi slabs
    and the 12 z psi slabs, each group of one shape; ``refresh_group``
    fills every ghost plane of each group as ``refresh`` does one tensor at
    a time."""
    xs = H.XSlabs(60, 3, halo=4)
    rng = np.random.default_rng(0)
    states = []
    for s in range(3):
        st = V.ViscoState.zeros((xs.planes(s), 16, 18), 14, "cpu")
        for v in vars(st).values():
            for t in (v if isinstance(v, list) else [v]):
                t.copy_(torch.as_tensor(rng.standard_normal(t.shape)))
        states.append(st)
    groups = [T.state_groups(st) for st in states]
    assert [len(gr) for gr in groups[0]] == [15, 12, 12]
    assert [{tuple(t.shape[1:]) for t in gr} for gr in groups[0]] == [
        {(16, 18)}, {(14, 18)}, {(16, 14)}]
    ref = [[[t.clone() for t in gr] for gr in g] for g in groups]
    for g in range(3):
        xs.refresh_group([gr[g] for gr in groups])
        for f in range(len(groups[0][g])):
            xs.refresh([r[g][f] for r in ref])
    for a, b in zip(groups, ref):
        for ga, gb in zip(a, b):
            for x, y in zip(ga, gb):
                assert torch.equal(x, y)
    # shard 0's hi ghosts are shard 1's first own planes, shard 1's lo
    # ghosts shard 0's last
    assert torch.equal(groups[0][0][0][-4:], states[1].vx[4:8])
    assert torch.equal(groups[1][1][0][:4], states[0].psi_s[2][-8:-4])


def test_indexed_materials_carry_over():
    """The sweep reads the pair's coefficients and state (no layout of its
    own): the JAX indexed table carried over by ``convert`` gives the same
    fused run as the port's own table."""
    shape = (24, 24, 48)
    idx = _layers(shape)
    g = _grid(shape, 1, n_steps=10, sensor_start=5)
    coefs = J.sls_coefficients(MATS, F0, g["dt"])
    mi, mt = J._build_indexed_materials(coefs, idx, None, shape[2])
    ti, tt = convert.indexed_materials_from_reference(mi, mt)
    grid = T.FDTDGrid(**g)
    amp = np.full(shape[:2], 1e3)
    ph = np.zeros(shape[:2])
    prof = T._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], CMAX, 1e-5)
    out = []
    for i, t in ((ti, tt), T._build_indexed_materials(coefs, idx, None)):
        co = T.make_visco_coeffs(i, t, prof, amp, ph, grid, True, "cpu")
        st = V.ViscoState.zeros(shape, 14, "cpu")
        T._fused_loop([(st, co)], grid, 1.0 / (1000.0 * C), 0.0,
                      T.visco_plan(shape, "cpu", True, False))
        out.append(T._carrier(st, grid))
    for k in ("p_amp", "peak"):
        np.testing.assert_array_equal(out[0][k], out[1][k])
