"""Port parity: the visco halo sweep with a volumetric (dome) drive, on the
CPU.

``run_fdtd`` runs a shear-media run with a volumetric source in K-step
sweeps of ``ops.fdtd_visco_halo_kernels.visco_halo`` (the port of the JAX
package's Pallas kernel B8 with its volumetric drive) in the schedule of
the JAX driver's visco ``run_phase``, then a one-step tail on pair +
scatter. Here, with the plain versions on the CPU:

* the port's ``run_fdtd(volume_source=, fuse_steps=2)`` on a dome shell
  through a shear layer (`tests/test_fused_kernel.py:334-374`, shrunk)
  against ``simulate_visco_pallas(interpret=True, fuse_steps=2,
  volume_source=, mat_idx=, mat_table=)`` at 1e-5 of the peak p_amp, and
  bit-equal to pair + scatter step by step;
* the schedule against the JAX driver's own split (its scans recorded, not
  run);
* a plain-torch emulation of the kernel's blocks (each extended tile and
  x-segment stepped alone, everything beyond it zero, the owned cells
  stitched): bit-equal to the whole grid with a 3K halo, not with 3K - 1;
* the kernel's march, read by read;
* the refusals;
* label-mode ``run_dome_sim`` on the 60-element TestDome with the halo
  sweep pinned, against the JAX package.

The CUDA kernel itself is held to its plain version and to pair + scatter
in `tests/test_torch_kernels.py` (``cuda``-marked) and by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu.pipeline import acoustic as JA
from babelbrain_tpu.pipeline import domain as JD
from babelbrain_tpu.pipeline.profiles import TRANSDUCER_REGISTRY as J_REG
from babelbrain_tpu.pipeline.profiles import TransducerSpec as JSpec
from babelbrain_tpu.pipeline.profiles import build_transducer as j_build_tx
from babelbrain_tpu_torch import convert
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_sources as S
from babelbrain_tpu_torch.ops import fdtd_visco_halo_kernels as VH
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
from babelbrain_tpu_torch.pipeline import acoustic as TA
from babelbrain_tpu_torch.pipeline.profiles import TRANSDUCER_REGISTRY as T_REG
from babelbrain_tpu_torch.pipeline.profiles import TransducerSpec as TSpec

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
CMAX = 2494.0
# water and a bone layer with shear (`tests/test_fused_kernel.py:355-358`)
MATS = np.array([[1000.0, C, 0.0, 20.0, 0.0],
                 [1896.0, CMAX, 1500.0, 150.0, 300.0]])


def _grid(shape, n_steps, sensor_start, npml=6):
    """The dome test's grid (9 PPW, CFL 0.9 against the bone's speed)."""
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, CMAX, 0.9)))
    return dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=n_steps,
                frequency=F0, sensor_start=sensor_start, npml=npml,
                source_type="velocity_volume")


def _shell(shape, seed=4):
    """`tests/test_fused_kernel.py:361-374`'s shell scaled to ``shape``:
    radii 14-16 of 48 below the centre, random phases, inward normals (the
    dense dict)."""
    c = [n / 2.0 for n in shape]
    s = min(shape) / 48.0
    ii, jj, kk = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape),
                             indexing="ij")
    r = np.sqrt((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2)
    shell = (r > 14 * s) & (r < 16 * s) & (kk < c[2])
    rr = np.maximum(r, 1e-6)
    rng = np.random.default_rng(seed)
    return dict(amp=np.where(shell, 60e3, 0.0).astype(np.float32),
                phase=(rng.uniform(-2, 2, shape) * shell).astype(np.float32),
                ox=((c[0] - ii) / rr).astype(np.float32),
                oy=((c[1] - jj) / rr).astype(np.float32),
                oz=((c[2] - kk) / rr).astype(np.float32))


def _index(shape):
    """The bone layer of `tests/test_fused_kernel.py:359-360` (z 30..36 of
    48), scaled."""
    idx = np.zeros(shape, np.uint8)
    z = shape[2] * 30 // 48
    idx[:, :, z:z + max(2, shape[2] // 8)] = 1
    return idx


def _counts():
    for mod in (VH, V, S):
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0


def _pair(g, vs, idx):
    """The port's run step by step through pair + scatter (plain)."""
    grid = T.FDTDGrid(**g)
    step, st, co, oz, vsrc = T.fdtd_setup(idx, MATS, grid, volume_source=vs,
                                          device="cpu")
    T._time_loop([(step, st, co, vsrc, None)], grid, oz)
    return T._carrier(st, grid)


def test_visco_volume_run_matches_jax_b8_interpret():
    """(a) A 24x24x32 dome shell through a shear layer, K = 2, a quiet
    count and a window of odd length (both phases end in a one-step tail):
    the port's halo-sweep run equals pair + scatter bit for bit and JAX's
    B8 driver with its volumetric drive and indexed materials in interpret
    mode within 1e-5 of the peak, on p_amp and peak."""
    shape = (24, 24, 32)
    g = _grid(shape, 0, 0)
    ppp = int(round(1 / F0 / g["dt"]))
    g.update(n_steps=2 * ppp + 4, sensor_start=ppp + 1)
    vs = _shell(shape)
    idx = _index(shape)
    _counts()
    out = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), volume_source=vs,
                     fuse_steps=2, device="cpu")
    quiet, window = g["sensor_start"], g["n_steps"] - g["sensor_start"]
    assert quiet % 2 == window % 2 == 1
    assert VH.plain_calls["visco_halo_volume"] == quiet // 2
    assert VH.plain_calls["visco_halo_volume_dft"] == window // 2
    assert S.plain_calls["volume_source"] == g["n_steps"]
    assert V.plain_calls["visco_stress"] == 2 * (quiet // 2) + 1
    ref = _pair(g, vs, idx)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)

    coefs = J.sls_coefficients(MATS, F0, g["dt"])
    props = {k: jnp.asarray(v) for k, v in J._material_fields(
        idx, coefs, has_shear=True).items()}
    prof = J._build_cpml_profiles_np(shape, g["npml"], g["dx"], g["dt"],
                                     CMAX, 1e-5)
    mi, mt = J._build_indexed_materials(coefs, idx, None, shape[2])
    zeros2 = jnp.zeros(shape[:2], jnp.float32)
    acc_c, acc_s, peak = (np.asarray(o) for o in JP.simulate_visco_pallas(
        props, zeros2, zeros2, jnp.float32(0.0), grid=J.FDTDGrid(**g),
        profiles_np=prof, viscous=True, oz_scale=1.0 / (1000.0 * C), nb=2,
        interpret=True, fuse_steps=2, volume_source=vs,
        mat_idx=jnp.asarray(mi), mat_table=jnp.asarray(mt)))
    j_amp = 2.0 / window * np.sqrt(acc_c**2 + acc_s**2)
    scale = j_amp.max()
    assert scale > 0
    np.testing.assert_allclose(out["p_amp"], j_amp, atol=1e-5 * scale)
    np.testing.assert_allclose(out["peak"], peak, atol=1e-5 * scale)


def _jax_visco_volume_split(monkeypatch, g, fuse_steps):
    """The sweeps JAX's ``simulate_visco_pallas`` schedules for a
    volumetric run of ``g`` with ``fuse_steps`` pinned: (sweeps [(first
    step, K)], tail steps), from its ``lax.scan`` calls, recorded and not
    run."""
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
    zeros3 = np.zeros(shape, np.float32)
    props = {k: jnp.zeros(shape, jnp.float32)
             for k in ("rho_inv", "pi_u", "mu_u", "c_rp", "c_rs", "b_r")}
    prof = J._build_cpml_profiles_np(shape, g["npml"], g["dx"], g["dt"],
                                     CMAX, 1e-5)
    JP.simulate_visco_pallas(
        props, zeros2, zeros2, jnp.float32(0.0), grid=J.FDTDGrid(**g),
        profiles_np=prof, viscous=True, oz_scale=1.0, nb=2, interpret=True,
        fuse_steps=fuse_steps,
        volume_source={k: zeros3 for k in ("amp", "phase", "ox", "oy",
                                           "oz")})
    sweeps = [(n, k) for k, ns in made if k > 1 for n in ns]
    tail = [n for k, ns in made if k == 1 for n in ns]
    return sweeps, tail


@pytest.mark.parametrize("k,quiet,n_steps", [(2, 41, 97), (2, 40, 97),
                                             (2, 0, 21), (2, 30, 30),
                                             (2, 7, 8), (3, 41, 97),
                                             (3, 40, 100)])
def test_visco_volume_schedule_matches_jax_run_phase(monkeypatch, k, quiet,
                                                     n_steps):
    """(b) The schedule of a pinned K against JAX's visco ``run_phase``
    with a volumetric source: the same K-step sweeps and one-step tail, no
    2-step sweeps, in the quiet phase and in the window. K = 2 through
    ``visco_volume_plan``; K = 3, beyond ``VISCO_HALO_K_CAP``, through
    ``fused_schedule`` with its plan (the split is the same rule)."""
    g = _grid((48, 16, 24), n_steps, quiet)
    sweeps, tail = _jax_visco_volume_split(monkeypatch, g, k)
    plan = (T.visco_volume_plan(T.FDTDGrid(**g), k)
            if k <= VH.VISCO_HALO_K_CAP else T.FusedPlan(k, k, False, 2))
    ours = T.fused_schedule(T.FDTDGrid(**g), plan)
    steps = [n + j for n, m, _ in ours for j in range(m)]
    assert steps == list(range(n_steps))
    assert all(dft == (n >= quiet) for n, _, dft in ours)
    assert [(n, m) for n, m, _ in ours if m > 1] == sweeps
    assert [n for n, m, _ in ours if m == 1] == tail
    assert all(m in (1, k) for _, m, _ in ours)


def test_visco_volume_plan_and_refusals():
    """``None`` takes ``VISCO_VOLUME_FUSE_BEST``; 0 and 1 run every step on
    pair + scatter (as JAX's K < 2); K beyond ``VISCO_HALO_K_CAP`` and an
    x-extent JAX refuses are refused (JAX's message); the launch geometry
    refuses K outside 1..cap and grids of 2^31 cells; the wrapper refuses
    rows beyond the cap, a state whose fields alias and a shard's x-CPML
    flags; a shear run with a volumetric source pinned beyond the cap is
    refused by ``run_fdtd``."""
    g = _grid((24, 20, 28), 12, 5)
    grid = T.FDTDGrid(**g)
    assert T.visco_volume_plan(grid).k == VH.VISCO_VOLUME_FUSE_BEST
    for k in (0, 1):
        assert all(m == 1 for _, m, _ in T.fused_schedule(
            grid, T.visco_volume_plan(grid, k)))
    for k in (-1, VH.VISCO_HALO_K_CAP + 1):
        with pytest.raises(ValueError, match="outside"):
            T.visco_volume_plan(grid, k)
    # JAX: N1 // 2 >= ceil((npml + 2) / 2) + 2K - 1 (here 4 + 3 = 7)
    short = T.FDTDGrid(**dict(g, shape=(13, 20, 28)))
    with pytest.raises(ValueError, match="N1/nb >= 7"):
        T.visco_volume_plan(short, 2)
    T.visco_volume_plan(T.FDTDGrid(**dict(g, shape=(14, 20, 28))), 2)
    zeros3 = np.zeros((13, 20, 28), np.float32)
    with pytest.raises(ValueError, match="N1/nb >= 7"):
        JP.simulate_visco_pallas(
            {}, None, None, 0.0, grid=J.FDTDGrid(**dict(g, shape=(13, 20,
                                                                  28))),
            profiles_np=None, viscous=True, oz_scale=1.0, fuse_steps=2,
            volume_source={k: zeros3 for k in ("amp", "phase", "ox", "oy",
                                               "oz")})
    for k in (0, VH.VISCO_HALO_K_CAP + 1):
        with pytest.raises(ValueError):
            VH.visco_halo_launch_geometry((24, 20, 28), k)
    with pytest.raises(ValueError):
        VH.visco_halo_launch_geometry((2048, 1024, 1024), 2)
    VH.visco_halo_launch_geometry((2048, 1024, 1023), 2)
    vs = _shell(g["shape"])
    _, st, co, _, vsrc = T.fdtd_setup(_index(g["shape"]), MATS, grid,
                                      volume_source=vs, device="cpu")
    rows = [T.step_scalars(grid, n, 1e-6) for n in range(3)]
    with pytest.raises(ValueError):
        VH.visco_halo(st, co, rows, vsrc)
    with pytest.raises(ValueError):
        VH.visco_halo(st, co, [], vsrc)
    alias = V.ViscoState(**dict(vars(st), syz=st.sxy))
    with pytest.raises(ValueError, match="alias"):
        VH.visco_halo(alias, co, rows[:2], vsrc)
    shard = dataclasses.replace(co, x_hi=False)
    with pytest.raises(ValueError, match="whole grids"):
        VH.visco_halo(st, shard, rows[:2], vsrc)
    with pytest.raises(ValueError, match="outside"):
        T.run_fdtd(_index(g["shape"]), MATS, grid, volume_source=vs,
                   fuse_steps=VH.VISCO_HALO_K_CAP + 1, device="cpu")


def _random_state(shape, ns, rng):
    st = V.ViscoState.zeros(shape, ns, "cpu")
    for v in vars(st).values():
        for t in (v if isinstance(v, list) else [v]):
            t.copy_(torch.as_tensor(rng.standard_normal(t.shape) * 1e-3,
                                    dtype=torch.float32))
    return st


def _copy(st):
    return V.ViscoState(**{k: (v.clone() if torch.is_tensor(v)
                               else [t.clone() for t in v])
                           for k, v in vars(st).items()})


def _slab_cells(shape, ns):
    """For each psi slab of a state (psi_s then psi_v, [lo, hi] of each
    derivative): the (i, j, k) grid cell of each of its entries."""
    out = []
    for derivs in (V.VELOCITY_DERIVS, V.STRESS_DERIVS):
        for _, axis, _ in derivs:
            for hi in (False, True):
                sl = list(shape)
                sl[axis] = ns
                c = list(np.meshgrid(*(np.arange(m) for m in sl),
                                     indexing="ij"))
                if hi:
                    c[axis] = c[axis] + shape[axis] - ns
                out.append(c)
    return out


STRESS_FIELDS = V.STRESSES + V.MEMORIES
# the TestDome's radius (`tests/test_runner.py:437-449`)
DOME_F = 16e-3


def _emulate(st0, co, rows, vsrc, tile, seg, halo, cluster_rows):
    """The kernel's clusters in plain torch: for each (z-tile, y-tile,
    x-segment) cluster, K steps of pair + scatter with every field beyond
    the cluster's tile and segment extended by ``halo`` cells set to 0
    before each half-step reads it (the kernel computes only its extended
    tile and reads 0 beyond it); each block's owned cells (the
    ``cluster_rows`` rows of the extended tile it holds) are copied into
    the result. The blocks' slabs are row slices of the one computation
    of their cluster's extended tile, so what a block reads across the
    cluster's inner edge is exact here by construction: the exchange
    itself is tested on the card (``test_torch_kernels.py``
    ``test_visco_halo_kernel_cluster_edges``) and its ordering by
    ``test_march_read_by_read``."""
    shape = tuple(st0.vx.shape)
    ns = st0.psi_s[2].shape[1]
    tz, ty = tile
    out = _copy(st0)
    cells = _slab_cells(shape, ns)
    for x0 in range(0, shape[0], seg):
        for y0 in range(0, shape[1], ty):
            for z0 in range(0, shape[2], tz):
                own = (slice(x0, x0 + seg), slice(y0, y0 + ty),
                       slice(z0, z0 + tz))
                box = tuple(slice(max(0, o.start - halo), o.stop + halo)
                            for o in own)
                inside = torch.zeros(shape, dtype=torch.bool)
                inside[box] = True
                st = _copy(st0)

                def cut(fields):
                    for f in fields:
                        t = getattr(st, f)
                        t.copy_(torch.where(inside, t, torch.zeros(())))

                cut(VH.FIELDS)
                for s_sin, s_cos, cosw, sinw, _ in rows:
                    V.visco_velocity_ref(st, co, s_sin, s_cos)
                    S.velocity_volume_source_ref(st.vx, st.vy, st.vz, vsrc,
                                                 s_sin, s_cos)
                    cut(("vx", "vy", "vz"))
                    V.visco_stress_ref(st, co, cosw, sinw)
                    cut(STRESS_FIELDS)
                for b0 in range(y0 - halo, y0 + ty + halo, cluster_rows):
                    rows_b = slice(max(b0, y0), min(b0 + cluster_rows,
                                                    y0 + ty))
                    mine = torch.zeros(shape, dtype=torch.bool)
                    mine[own[0], rows_b, own[2]] = True
                    for f in VH.FIELDS + ("acc_cos", "acc_sin", "peak"):
                        getattr(out, f)[mine] = getattr(st, f)[mine]
                    for q, (a, b) in enumerate(zip(st.psi_s + st.psi_v,
                                                   out.psi_s + out.psi_v)):
                        i, j, k = cells[q]
                        m = torch.as_tensor(mine.numpy()[i, j, k])
                        b[m] = a[m]
    return out


def _state_diff(a, b):
    return [k for k, v in vars(a).items()
            if not all(torch.equal(x, y) for x, y in zip(
                v if isinstance(v, list) else [v],
                getattr(b, k) if isinstance(v, list) else [getattr(b, k)]))]


@pytest.mark.parametrize("k", [1, 2])
def test_block_emulation_needs_a_3k_halo(k):
    """(c) The clusters stepped alone and stitched are bit-equal to K steps
    of the whole grid with a 3K halo at the cluster's outer edge (the
    blocks' slabs are stitched from their cluster's one computation: no
    halo at the inner edges between them) and differ with 3K - 1; source
    voxels sit on a cluster corner, on the inner edges between its blocks
    and on a halo's outer edge, and the stresses are large on that edge's
    cells (the farthest a step's stencils reach: what they carry inward
    shrinks a step, so it must be large to survive rounding)."""
    h = VH.CONTAMINATION * k
    blocks = 2  # blocks a cluster: rows of (10 + 2h) / 2 each
    tile, seg = (8, 10), 7
    rows_b = (tile[1] + 2 * h) // blocks
    shape = (28, 30, 40)
    ns = 6
    g = _grid(shape, k, 0, npml=ns - 2)
    grid = T.FDTDGrid(**g)
    rng = np.random.default_rng(7)
    # a cluster in the middle: its owned box and the cells 3K beyond it
    x0, y0, z0 = 2 * seg, tile[1], 2 * tile[0]
    edge = [(x0 - h, y0 + 2, z0 + 3), (x0 + 3, y0 + tile[1] - 1 + h, z0 + 1),
            (x0 + 1, y0 + 1, z0 - h), (x0 + 2, y0 + 3, z0 + tile[0] - 1 + h),
            (x0 + seg - 1 + h, y0, z0 + 2), (x0 + 1, y0 - h, z0 + 4)]
    inner = [(x0 + 1, y0 - h + rows_b + d, z0 + 2) for d in (-1, 0)]
    corner = [(x0, y0, z0), (0, tile[1], tile[0]), (x0 + seg - 1,
                                                    y0 + tile[1] - 1,
                                                    z0 + tile[0] - 1)]
    voxels = [v for v in edge + inner + corner
              if all(0 <= c < n for c, n in zip(v, shape))]
    lin = np.ravel_multi_index(np.array(voxels).T, shape)
    sparse = dict(index=lin, amp=rng.uniform(0.5, 1.0, len(lin)) * 1e-3,
                  phase=rng.uniform(-2, 2, len(lin)),
                  ox=rng.uniform(-1, 1, len(lin)),
                  oy=rng.uniform(-1, 1, len(lin)),
                  oz=rng.uniform(-1, 1, len(lin)))
    vsrc = S.VolumeSource.from_sparse(sparse, shape, "cpu")
    _, _, co, _, _ = T.fdtd_setup(_index(shape), MATS, grid,
                                  volume_source=vsrc, device="cpu")
    st0 = _random_state(shape, ns, rng)
    for v in edge:
        if all(0 <= c < n for c, n in zip(v, shape)):
            for f in V.STRESSES:
                getattr(st0, f)[v] = 1e9  # ~1e-4 of it reaches a step in
    rows = [T.step_scalars(grid, 40 + m, 1.0) for m in range(k)]
    whole = _copy(st0)
    VH.visco_halo_ref(whole, co, rows, vsrc, with_dft=True)
    ok = _emulate(st0, co, rows, vsrc, tile, seg, h, rows_b)
    assert _state_diff(ok, whole) == []
    short = _emulate(st0, co, rows, vsrc, tile, seg, h - 1, rows_b - 1)
    assert set(_state_diff(short, whole)) & set(V.STRESSES)


def test_cluster_geometry_computes_less():
    """At the dome's 392x392x337 grid the clusters compute at most 0.6x
    the cells per cell owned of the independent blocks they replaced
    (4.279 at K = 2: at most 2.57), and every K's launch covers the grid
    once in whole clusters."""
    shape = (392, 392, 337)
    geo = VH.visco_halo_launch_geometry(shape, 2)
    assert geo.computed(shape) <= 0.6 * 4.279
    for k in range(1, VH.VISCO_HALO_K_CAP + 1):
        geo = VH.visco_halo_launch_geometry(shape, k)
        tz, ty = geo.tile
        gz, gy, gx = geo.grid
        assert gy % geo.cluster == 0
        assert ty == geo.cluster * geo.rows - 2 * geo.halo
        assert (gz - 1) * tz < shape[2] <= gz * tz
        assert (gy // geo.cluster - 1) * ty < shape[1] <= gy // geo.cluster \
            * ty
        assert (gx - 1) * geo.segment < shape[0] <= gx * geo.segment
        assert geo.threads <= 1024


def _march_errors(n, k, ring=VH.RING, windows=None, depth=VH.INDEX_RING,
                  ghost=None):
    """Every read of ``march(n, k)`` against the rings (``ring`` planes a
    slot set, their ghost rows ``ghost``, by default as many), the index
    ring (``depth`` planes) and register windows (``windows``: planes each
    holds, the kernel's by default) it implies: a ring read finds the plane
    it wants (a neighbour's in the block written at an earlier march step,
    so ordered by the step's barrier between them, and not rewritten in
    this one; the own column's not yet overwritten); a ghost-row read finds
    its plane stored by the next block at an earlier march step and not
    rewritten by any store of the next block that may land before it
    (those of this step and the next); every ring store and read lies
    between the step's wait and its arrive; an index read finds its plane;
    the values stage 0 takes are the ones loaded for the step; an
    x-window's first four entries (or its oldest) are the planes its step
    reads; every plane of every step is computed once."""
    size = {**dict(sxx=4, sxy=5, sxz=5, vx=5, vy=4, vz=4), **(windows or {})}
    ghost = ring if ghost is None else ghost
    slots, wins, index, ghosts = {}, {}, {}, {}
    done = {(e, s): [] for e in ("V", "S") for s in range(k)}
    errs = []
    loaded = None
    open_ = True  # the prologue's barrier precedes step 0
    for f, ev in enumerate(VH.march(n, k)):
        written = {(e[1], e[2], e[3] % ring) for e in ev if e[0] == "w"}
        for e in ev:
            kind = e[0]
            if kind == "ghost_w":
                _, r, s, pl, g = e
                ghosts[(r, s, pl % ghost)] = (pl, g)
            elif kind == "wait":
                open_ = True
            elif kind == "arrive":
                open_ = False
            elif kind == "copy":
                index[(e[1] - 2) % depth] = e[1] - 2
            elif kind == "load":
                loaded = e[1]
            elif kind == "w":
                _, r, s, pl = e
                if not open_:
                    errs.append(("outside the barrier", f, e))
                slots[(r, s, pl % ring)] = (pl, f)
            elif kind == "r":
                _, r, s, pl, how = e
                got = slots.get((r, s, pl % ring))
                if not open_:
                    errs.append(("outside the barrier", f, e))
                if pl < 0:
                    continue  # below the march: its values are never used
                if how == "ghost":
                    got = ghosts.get((r, s, pl % ghost))
                    if got is None or got[0] != pl or got[1] >= f:
                        errs.append(("ghost", f, e, got))
                elif got is None or got[0] != pl or (how == "lateral" and (
                        got[1] >= f or (r, s, pl % ring) in written)):
                    errs.append((f, e, got))
            elif kind == "push":
                _, w, s, pl = e
                wins[(w, s)] = (wins.get((w, s), []) + [pl])[-size[w]:]
            elif kind in ("xwin", "xold"):
                _, w, s, planes = e
                # registers start at 0: the planes below the march's first
                have = ([-1] * size[w] + wins.get((w, s), []))[-size[w]:]
                planes = planes if kind == "xwin" else (planes,)
                if any(x != y and not (x < 0 and y < 0)
                       for x, y in zip(have[:4], planes)):
                    errs.append((f, e, have))
            elif kind == "idx":
                if index.get(e[1] % depth) != e[1]:
                    errs.append((f, e, index.get(e[1] % depth)))
            elif kind == "stage_in":
                _, what, pl = e
                if loaded != f or pl != f - {"v": 2, "r": 4}[what]:
                    errs.append((f, e, loaded))
            else:
                done[(kind, e[1])].append(e[2])
    errs += [key for key, planes in done.items()
             if planes != list(range(n))]
    return errs


@pytest.mark.parametrize("n", [1, 7, 30])
@pytest.mark.parametrize("k", [1, 2])
def test_march_read_by_read(k, n):
    """(d) ``march`` over n planes: every shared-memory read finds the
    plane and step it needs, a neighbour's in the block written a march
    step earlier or more (the step's barrier orders it) and not rewritten
    within the step, a neighbour's across the cluster's inner edge stored
    into the ghost rows a march step earlier or more (the mbarrier wait
    orders it) and not rewritten by the next block running a step ahead, a
    step's own old values (the step before's velocities, stresses and
    memories) still in their slots, and every ring access lies between the
    barrier's wait and its arrive; the index ring holds each plane to its
    last reader; the x-windows hand each step the planes it reads; every
    plane of every step is computed once. At 30 planes: rings of 2 planes,
    ghost rows of 3, a 4-plane sxy window or an index ring of 4K - 2 would
    not do."""
    assert _march_errors(n, k) == []
    if n == 30:
        assert _march_errors(n, k, ring=2)
        assert _march_errors(n, k, ghost=VH.RING - 1)
        assert _march_errors(n, k, windows=dict(sxy=4))
        assert _march_errors(n, k, depth=4 * k - 2)


def test_label_dome_sim_matches_jax(monkeypatch):
    """Label-mode ``run_dome_sim`` (shear in the bone) on the 60-element
    TestDome, its FDTD pinned to the halo sweep (K = 2) as chip_smoke pins
    the dome-label slice, over the first 200 steps of the domain's
    schedule, against the JAX package's run: p_amp and peak within 1e-5 of
    the peak (`tests/test_fused_kernel.py:373`)."""
    meta = {"amplitude_1w": {"Rayleigh": 0.14,
                             "Visco": {500000: {6: 60000.0}}}}
    for reg, spec in ((J_REG, JSpec), (T_REG, TSpec)):
        reg["TestDome"] = spec("TestDome", "dome", diameter=2 * DOME_F,
                               focal_length=DOME_F, frequencies=(500e3,),
                               n_elements=60, elem_diameter=2.2e-3, meta=meta)
    mask = np.zeros((24, 24, 40), np.uint8)
    mask[:, :, 30:36] = 1
    mask[:, :, 24:30] = 2
    mask[:, :, :24] = 4
    mask[12, 12, 12] = 5
    mats = JD.build_label_materials(F0, False)
    offsets, shrinks = JD.fit_domain_offsets(
        np.flip(mask, axis=2), C / F0 / 6.0, 2 * DOME_F, DOME_F, dome=True)
    dom_j = JD.build_domain(mask, F0, 6.0, materials=mats, offsets=offsets,
                            shrink_cells=shrinks)
    assert (dom_j.materials[:, 2] > 0).any()
    dom_j = dataclasses.replace(dom_j, n_steps=200, sensor_start=140)
    # 60 element centers on the TestDome hemisphere
    # (`tests/test_torch_pipeline.py` _dome_centers(7))
    rng = np.random.default_rng(7)
    b = np.arccos(rng.uniform(0.15, 0.95, 60))
    a = rng.uniform(0, 2 * np.pi, 60)
    centers = np.stack([DOME_F * np.sin(b) * np.cos(a),
                        DOME_F * np.sin(b) * np.sin(a),
                        -DOME_F * np.cos(b)], axis=1)
    tx_j = j_build_tx(J_REG["TestDome"], F0, elem_centers=centers)
    oj = JA.run_dome_sim(dom_j, tx_j, 60e3, assemble=False)
    _counts()
    saved = TA.run_fdtd
    monkeypatch.setattr(TA, "run_fdtd",
                        lambda *a, **kw: saved(*a, fuse_steps=2, **kw))
    ot = TA.run_dome_sim(convert.domain_from_reference(dom_j),
                         convert.transducer_from_reference(tx_j), 60e3,
                         assemble=False, device="cpu")
    assert VH.plain_calls["visco_halo_volume"] == 70
    assert VH.plain_calls["visco_halo_volume_dft"] == 30
    assert S.plain_calls["volume_source"] == 200
    scale = oj["p_amp"].max()
    assert scale > 0
    for k in ("p_amp", "peak"):
        np.testing.assert_allclose(ot[k], oj[k], rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
