"""Port parity: the fluid halo sweep with a volumetric (dome) drive, on the
CPU.

``run_fdtd`` runs a fluid run with a volumetric source in K-step sweeps of
``ops.fdtd_halo_kernels.fluid_halo`` (the port of the JAX package's Pallas
kernel B4 with its volumetric drive) in the schedule of the JAX driver's
volumetric ``run_phase``, then a one-step tail on pair + scatter; on a mesh
it runs overlap and discard (the port of the volume branch of
``_simulate_fluid_pallas_sharded_fused``). Here, with the plain versions on
the CPU:

* the port's ``run_fdtd(volume_source=, fuse_steps=3)`` on a shrunk dome
  shell (`tests/test_fused_kernel.py:284-331`) against
  ``simulate_fluid_pallas(interpret=True, fuse_steps=3, volume_source=)``
  at that test's band (1e-5 of the peak p_amp), and bit-equal to pair +
  scatter step by step;
* the schedule against the JAX driver's own split (its scans recorded, not
  run), and its one deliberate divergence (2-step sweeps);
* a plain-torch emulation of the kernel's clusters (each cluster's
  extended tile and x-segment stepped alone, everything beyond it zero, its
  blocks' slabs of rows splitting it without overlap, the owned cells
  stitched): bit-equal to the whole grid with a 3K halo at the cluster's
  outer edge and none at its inner edges, not with 3K - 1;
* the kernel's march, read by read, and its cluster geometry's cells
  computed per cell owned at the dome's grid;
* the sharded volumetric run on ``["cpu"] * 4``, bit-equal to the
  unsharded run;
* the refusals.

The CUDA kernel itself is held to its plain version and to pair + scatter
in `tests/test_torch_kernels.py` (``cuda``-marked) and by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_sources as S
from babelbrain_tpu_torch.parallel import halo as H

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
# zero-shear media (`tests/test_fused_kernel.py:306-309`): water, CT-like
# bone without shear
MATS = np.array([[1000.0, C, 0.0, 20.0, 0.0],
                 [1896.0, 2494.0, 0.0, 150.0, 0.0]])


def _grid(shape, n_steps, sensor_start, npml=12):
    """The dome test's grid (9 PPW, CFL 0.9 against the bone's speed)."""
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, 0.9)))
    return dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=n_steps,
                frequency=F0, sensor_start=sensor_start, npml=npml,
                source_type="velocity_volume")


def _shell(shape, seed=4):
    """`tests/test_fused_kernel.py:311-323`'s shell scaled to ``shape``:
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
    idx = np.zeros(shape, np.uint8)
    z = shape[2] * 30 // 48
    idx[:, :, z:z + max(2, shape[2] // 8)] = 1
    return idx


def _counts():
    for mod in (HK, K, S):
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


def test_volume_run_matches_jax_b4_interpret():
    """(a) A 32^3 dome shell, K = 3 (a quiet count not divisible by 3, so
    both phases end in a tail): the port's halo-sweep run equals pair +
    scatter bit for bit and JAX's B4 driver with its volumetric drive in
    interpret mode within 1e-5 of the peak, on p_amp and peak."""
    shape = (32, 32, 32)
    g = _grid(shape, 0, 0)
    ppp = int(round(1 / F0 / g["dt"]))
    g.update(n_steps=2 * ppp + 4, sensor_start=ppp + 1)
    vs = _shell(shape)
    idx = _index(shape)
    _counts()
    out = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), volume_source=vs,
                     fuse_steps=3, device="cpu")
    quiet, window = g["sensor_start"], g["n_steps"] - g["sensor_start"]
    assert HK.plain_calls["fluid_halo_volume"] == quiet // 3
    assert HK.plain_calls["fluid_halo_volume_dft"] == window // 3
    assert S.plain_calls["volume_source"] == (
        3 * (quiet // 3 + window // 3) + quiet % 3 + window % 3)
    ref = _pair(g, vs, idx)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)

    coefs = J.sls_coefficients(MATS, F0, g["dt"])
    props = {k: jnp.asarray(v) for k, v in J._material_fields(
        idx, coefs, has_shear=False).items()}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], 2494.0,
                                     1e-5)
    zeros2 = jnp.zeros(shape[:2], jnp.float32)
    acc_c, acc_s, peak = (np.asarray(o) for o in JP.simulate_fluid_pallas(
        props, zeros2, zeros2, grid=J.FDTDGrid(**g), profiles_np=prof,
        viscous=True, oz_scale=1.0 / (1000.0 * C), nb=2, interpret=True,
        fuse_steps=3, volume_source=vs))
    j_amp = 2.0 / window * np.sqrt(acc_c**2 + acc_s**2)
    scale = j_amp.max()
    assert scale > 0
    np.testing.assert_allclose(out["p_amp"], j_amp, atol=1e-5 * scale)
    np.testing.assert_allclose(out["peak"], peak, atol=1e-5 * scale)


def _jax_volume_split(monkeypatch, g, fuse_steps):
    """The sweeps JAX's ``simulate_fluid_pallas`` schedules for a
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

    monkeypatch.setattr(JP, "_make_fluid_fusedK_step_fn",
                        lambda grid, prof, visc, oz, K, *a, **kw:
                        maker(K)())
    monkeypatch.setattr(JP, "_make_fluid_fused2_step_fn", maker(2))
    monkeypatch.setattr(JP, "_make_fluid_fused_step_fn", maker(1))
    monkeypatch.setattr(JP, "make_fluid_pallas_step", maker(-1))

    def scan(f, carry, xs):
        made.append((f.k, [int(v) for v in np.asarray(xs)]))
        return carry, None

    monkeypatch.setattr(jax.lax, "scan", scan)
    shape = g["shape"]
    zeros2 = jnp.zeros(shape[:2], jnp.float32)
    zeros3 = np.zeros(shape, np.float32)
    props = {k: jnp.zeros(shape, jnp.float32)
             for k in ("rho_inv", "pi_u", "c_rp", "b_r")}
    prof = J._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], C, 1e-5)
    JP.simulate_fluid_pallas(
        props, zeros2, zeros2, grid=J.FDTDGrid(**g), profiles_np=prof,
        viscous=True, oz_scale=1.0, nb=2, interpret=True,
        fuse_steps=fuse_steps,
        volume_source={k: zeros3 for k in ("amp", "phase", "ox", "oy",
                                           "oz")})
    assert all(k != -1 for k, _ in made), "a tail without the drive"
    sweeps = [(n, k) for k, ns in made if k > 1 for n in ns]
    tail = [n for k, ns in made if k == 1 for n in ns]
    return sweeps, tail


@pytest.mark.parametrize("k,quiet,n_steps", [(3, 41, 97), (3, 0, 20),
                                             (3, 30, 30), (3, 7, 8),
                                             (2, 41, 97)])
def test_volume_schedule_matches_jax_run_phase(monkeypatch, k, quiet,
                                               n_steps):
    """(b) ``volume_plan`` + ``fused_schedule`` with K pinned: at K = 3 the
    same K-step sweeps and one-step tail as JAX's volumetric ``run_phase``
    (no 2-step sweeps, in the quiet phase and in the window); at K = 2 the
    port's deliberate divergence: 2-step sweeps where JAX runs every step
    as a tail (the same result, bit for bit)."""
    g = _grid((48, 16, 24), n_steps, quiet)
    sweeps, tail = _jax_volume_split(monkeypatch, g, k)
    ours = T.fused_schedule(T.FDTDGrid(**g), T.volume_plan(k))
    steps = [n + j for n, m, _ in ours for j in range(m)]
    assert steps == list(range(n_steps))
    assert all(dft == (n >= quiet) for n, _, dft in ours)
    if k >= 3:
        assert [(n, m) for n, m, _ in ours if m > 1] == sweeps
        assert [n for n, m, _ in ours if m == 1] == tail
    else:
        assert sweeps == [] and tail == list(range(n_steps))
        two = [n for n0, n1 in ((0, quiet), (quiet, n_steps))
               for n in range(n0, n1 - (n1 - n0) % 2, 2)]
        assert [n for n, m, _ in ours if m == 2] == two
        assert all(m in (1, 2) for _, m, _ in ours)


def test_volume_plan_and_refusals():
    """``None`` takes ``VOLUME_FUSE_BEST``; 0 and 1 run every step on pair +
    scatter; K beyond ``HALO_K_CAP`` is refused (``volume_plan``, the
    launch, its geometry); a state whose fields alias, a grid of 2^31
    cells and a voxel listed twice are refused."""
    assert T.volume_plan().k == HK.VOLUME_FUSE_BEST
    g = _grid((24, 20, 28), 12, 5)
    for k in (0, 1):
        assert all(m == 1 for _, m, _ in T.fused_schedule(
            T.FDTDGrid(**g), T.volume_plan(k)))
    with pytest.raises(ValueError):
        T.volume_plan(HK.HALO_K_CAP + 1)
    with pytest.raises(ValueError):
        T.volume_plan(-1)
    for k in (0, HK.HALO_K_CAP + 1):
        with pytest.raises(ValueError):
            HK.halo_launch_geometry((24, 20, 28), k)
    with pytest.raises(ValueError):
        HK.halo_launch_geometry((2048, 1024, 1024), 2)
    HK.halo_launch_geometry((2048, 1024, 1023), 2)  # 2^31 - 2^21 cells
    vs = _shell(g["shape"])
    _, st, co, _, vsrc = T.fdtd_setup(_index(g["shape"]), MATS,
                                      T.FDTDGrid(**g), volume_source=vs,
                                      device="cpu")
    rows = [T.step_scalars(T.FDTDGrid(**g), n, 1e-6) for n in range(4)]
    with pytest.raises(ValueError):
        HK.fluid_halo(st, co, rows, vsrc)
    with pytest.raises(ValueError):
        HK.fluid_halo(st, co, [], vsrc)
    alias = K.FluidState(**dict(vars(st), vx=st.p))
    with pytest.raises(ValueError, match="alias"):
        HK.fluid_halo(alias, co, rows[:2], vsrc)
    twice = S.VolumeSource(**{k: torch.cat([getattr(vsrc, k)[:1],
                                            getattr(vsrc, k)])
                              for k in ("index", "amp", "cph", "sph", "ox",
                                        "oy", "oz")})
    with pytest.raises(ValueError, match="twice"):
        twice.slot_volume(g["shape"])
    slots = vsrc.slot_volume(g["shape"]).reshape(-1)
    assert slots.dtype == torch.int32 and int((slots >= 0).sum()) == \
        vsrc.n_src
    assert torch.equal(slots[vsrc.index.long()],
                       torch.arange(vsrc.n_src, dtype=torch.int32))


def _random_state(shape, ns, rng):
    st = K.FluidState.zeros(shape, ns, "cpu")
    for v in vars(st).values():
        for t in (v if isinstance(v, list) else [v]):
            t.copy_(torch.as_tensor(rng.standard_normal(t.shape) * 1e-3,
                                    dtype=torch.float32))
    return st


def _copy(st):
    return K.FluidState(**{k: (v.clone() if torch.is_tensor(v)
                               else [t.clone() for t in v])
                           for k, v in vars(st).items()})


def _slab_cells(shape, ns):
    """For each psi slab of a state (psi_p then psi_v, [x_lo, x_hi, y_lo,
    y_hi, z_lo, z_hi]): the (i, j, k) grid cell of each of its entries."""
    n = shape
    out = []
    for axis in range(3):
        for hi in (False, True):
            sl = list(n)
            sl[axis] = ns
            c = list(np.meshgrid(*(np.arange(m) for m in sl),
                                 indexing="ij"))
            if hi:
                c[axis] = c[axis] + n[axis] - ns
            out.append(c)
    return out + out


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
    ``test_halo_kernel_cluster_edges``) and its ordering by
    ``test_march_read_by_read``."""
    shape = tuple(st0.p.shape)
    ns = st0.psi_p[2].shape[1]
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

                def cut(*fields):
                    for f in fields:
                        t = getattr(st, f)
                        t.copy_(torch.where(inside, t, torch.zeros(())))

                cut("p", "vx", "vy", "vz", "r")
                for s_sin, s_cos, cosw, sinw, _ in rows:
                    K.fluid_velocity_ref(st, co, s_sin, s_cos)
                    if vsrc is not None:
                        S.velocity_volume_source_ref(st.vx, st.vy, st.vz,
                                                     vsrc, s_sin, s_cos)
                    cut("vx", "vy", "vz")
                    K.fluid_pressure_ref(st, co, cosw, sinw)
                    cut("p", "r")
                ey0 = y0 - halo  # the extended tile's first row
                for b0 in range(ey0, y0 + ty + halo, cluster_rows):
                    rows_b = slice(max(b0, y0), min(b0 + cluster_rows,
                                                    y0 + ty))
                    mine = torch.zeros(shape, dtype=torch.bool)
                    mine[own[0], rows_b, own[2]] = True
                    for f in ("p", "vx", "vy", "vz", "r", "acc_cos",
                              "acc_sin", "peak"):
                        getattr(out, f)[mine] = getattr(st, f)[mine]
                    for q, (a, b) in enumerate(zip(st.psi_p + st.psi_v,
                                                   out.psi_p + out.psi_v)):
                        i, j, k = cells[q]
                        m = torch.as_tensor(mine.numpy()[i, j, k])
                        b[m] = a[m]
    return out


def _state_diff(a, b):
    return [k for k, v in vars(a).items()
            if not all(torch.equal(x, y) for x, y in zip(
                v if isinstance(v, list) else [v],
                getattr(b, k) if isinstance(v, list) else [getattr(b, k)]))]


@pytest.mark.parametrize("k", [2, 3])
def test_block_emulation_needs_a_3k_halo(k):
    """(c) The clusters stepped alone and stitched are bit-equal to K steps
    of the whole grid with a 3K halo at the cluster's outer edge (the
    blocks' slabs are stitched from their cluster's one computation: no
    halo at the inner edges between them) and differ with 3K - 1; source
    voxels sit on a cluster corner, on the inner edges between its blocks
    and on a halo's outer edge, and the state is large on that edge's cells
    (the farthest a step's stencils reach: what they carry inward shrinks
    ~1e-4 a step, so it must be large to survive rounding)."""
    h = HK.CONTAMINATION * k
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
    _, _, co, oz, _ = T.fdtd_setup(_index(shape), MATS, grid,
                                   volume_source=vsrc, device="cpu")
    st0 = _random_state(shape, ns, rng)
    for v in edge:
        if all(0 <= c < n for c, n in zip(v, shape)):
            st0.p[v] = 1e9  # ~1e-4 of it reaches a step further in
    rows = [T.step_scalars(grid, 40 + m, 1.0) for m in range(k)]
    whole = _copy(st0)
    HK.fluid_halo_ref(whole, co, rows, vsrc, with_dft=True)
    ok = _emulate(st0, co, rows, vsrc, tile, seg, h, rows_b)
    assert _state_diff(ok, whole) == []
    short = _emulate(st0, co, rows, vsrc, tile, seg, h - 1, rows_b - 1)
    assert "p" in _state_diff(short, whole)


def test_cluster_geometry_computes_less():
    """At the dome's 392x392x337 grid the clusters compute at most 0.6x
    the cells per cell owned of the independent blocks they replaced
    (3.451 at K = 2: at most 2.07), and every K's launch covers the grid
    once in whole clusters."""
    shape = (392, 392, 337)
    geo = HK.halo_launch_geometry(shape, 2)
    assert geo.computed(shape) <= 0.6 * 3.451
    for k in range(1, HK.HALO_K_CAP + 1):
        geo = HK.halo_launch_geometry(shape, k)
        tz, ty = geo.tile
        gz, gy, gx = geo.grid
        assert gy % geo.cluster == 0
        assert ty == geo.cluster * geo.rows - 2 * geo.halo
        assert (gz - 1) * tz < shape[2] <= gz * tz
        assert (gy // geo.cluster - 1) * ty < shape[1] <= gy // geo.cluster \
            * ty
        assert (gx - 1) * geo.segment < shape[0] <= gx * geo.segment
        assert geo.threads <= 1024


def _march_errors(n, k, ring=HK.RING, depth=None, ghost=None):
    """Every read of ``march(n, k)`` against the rings (``ring`` planes a
    slot set, their ghost rows ``ghost``, by default as many), the index
    ring (``depth`` planes, the kernel's by default) and register windows
    it implies: a ring read finds the plane it wants, a neighbour's in the
    block written at an earlier march step, so ordered by the step's
    barrier between them, and not rewritten in this one; a ghost-row read
    finds its plane stored by the next block at an earlier march step (its
    rows of the step before are what the read waits on) and not rewritten
    by any store of the next block that may land before it (those of this
    step and the next); every ring store and read lies between the step's
    wait and its arrive; an index read finds its plane, copied in at an
    earlier step; the values stage 0 takes are the ones loaded for the
    step; an x-window holds the planes its step wants; the SLS memory
    handed on is the plane's; every plane of every step is computed once."""
    depth = HK.index_ring(k) if depth is None else depth
    ghost = ring if ghost is None else ghost
    slots, wins, rlist, index, ghosts = {}, {}, {}, {}, {}
    done = {("V", s): [] for s in range(k)}
    done.update({("P", s): [] for s in range(k)})
    errs = []
    loaded = None
    open_ = True  # the prologue's barrier precedes step 0
    for f, ev in enumerate(HK.march(n, k)):
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
                key = ("p", s) if r == "p" else ("vx", s) if r == "vy" \
                    else None
                if key:
                    wins.setdefault(key, []).append(pl)
                if r == "p" and s > 0:
                    rlist.setdefault(s - 1, []).append(pl)
            elif kind == "r":
                _, r, s, pl, how = e
                got = slots.get((r, s, pl % ring))
                if not open_:
                    errs.append(("outside the barrier", f, e))
                if how == "ghost":
                    got = ghosts.get((r, s, pl % ghost))
                    if got is None or got[0] != pl or got[1] >= f:
                        errs.append(("ghost", f, e, got))
                elif got is None or got[0] != pl:
                    errs.append((f, e, got))
                elif how == "lateral" and (got[1] >= f or (
                        r, s, pl % ring) in written):
                    errs.append(("race", f, e, got))
            elif kind == "idx":
                if index.get(e[1] % depth) != e[1]:
                    errs.append((f, e, index.get(e[1] % depth)))
            elif kind == "stage_in":
                _, what, pl = e
                if loaded != f or pl != f - {"v": 2, "r": 3}[what]:
                    errs.append((f, e, loaded))
            elif kind == "xwin":
                _, w, s, planes = e
                # registers start at 0: the planes below the march's first
                have = ([None] * 4 + wins.get((w, s), []))[-4:]
                have = [-1 if x is None else x for x in have]
                have = have[:len(planes)] if len(planes) == 1 else have
                if any(x != y and not (x < 0 and y < 0)
                       for x, y in zip(have, planes)):
                    errs.append((f, e, have))
            elif kind == "r_in":
                _, s, pl = e
                if s and rlist.get(s - 1, [None] * 4)[-4] != pl:
                    errs.append((f, e, rlist.get(s - 1)))
            else:
                done[(kind, e[1])].append(e[2])
    errs += [key for key, planes in done.items()
             if planes != list(range(n))]
    return errs


@pytest.mark.parametrize("n", [1, 7, 30])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_march_read_by_read(k, n):
    """(d) ``march`` over n planes: every shared-memory read finds the
    plane and step it needs, a neighbour's in the block written a march
    step earlier or more (the step's barrier orders it) and not rewritten
    within the step, a neighbour's across the cluster's inner edge stored
    into the ghost rows a march step earlier or more (the mbarrier wait
    orders it) and not rewritten by the next block running a step ahead,
    and every ring access lies between the barrier's wait and its arrive;
    the index ring holds each plane from its copy a step ahead to its last
    reader; the x-windows and the r ring hand each step what it reads;
    every plane of every step is computed once. At 30 planes: rings of 2
    planes, ghost rows of 3 (at K = 1 the own rows would do with 3, but
    the next block's stores of a step ahead land on a slot still read) or
    an index ring of 3K - 2 would not do."""
    assert _march_errors(n, k) == []
    if n == 30:
        if k > 1:
            assert _march_errors(n, k, ring=2)
        assert _march_errors(n, k, ghost=HK.RING - 1)
        assert _march_errors(n, k, depth=3 * k - 2)


@functools.cache
def _sharded_runs():
    shape = (96, 24, 32)
    g = _grid(shape, 30, 16)
    vs = _shell(shape)
    idx = _index(shape)
    mesh = H.make_mesh(4, devices=["cpu"] * 4)
    plan = T.overlap_plan(mesh, MATS, T.FDTDGrid(**g), fuse_steps=3)
    _counts()
    sharded = T.run_fdtd(idx, MATS, T.FDTDGrid(**g), volume_source=vs,
                         mesh=mesh, fuse_steps=3)
    calls = dict(HK.plain_calls)
    whole = _pair(g, vs, idx)
    return g, plan, calls, sharded, whole


def test_sharded_volume_run_is_bit_equal():
    """(e) On ``["cpu"] * 4`` (24 planes a shard) the volumetric run with
    ``fuse_steps=3`` goes overlap and discard with (K, H) = (3, 9): one
    halo sweep a shard a sweep, each shard driving its ghost planes from
    the global drive, equal to the unsharded run bit for bit; shear media
    keep the pair."""
    g, plan, calls, sharded, whole = _sharded_runs()
    assert plan == (3, 9)
    sweeps = T.overlap_schedule(T.FDTDGrid(**g), 3)
    assert calls["fluid_halo_volume"] == 4 * sum(not d for *_, d in sweeps)
    assert calls["fluid_halo_volume_dft"] == 4 * sum(d for *_, d in sweeps)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(sharded[k], whole[k], err_msg=k)
    # the default follows the unsharded one: the halo sweep only where
    # VOLUME_FUSE_BEST takes it (K >= 2), else the pair with 2 ghost planes
    mesh = H.make_mesh(4, devices=["cpu"] * 4)
    best = HK.VOLUME_FUSE_BEST
    assert T.overlap_plan(mesh, MATS, T.FDTDGrid(**g)) == (
        None if best < 2 else T.overlap_plan(mesh, MATS, T.FDTDGrid(**g),
                                             fuse_steps=best))
    # shear media keep the pair with 2 ghost planes
    assert T.overlap_plan(H.make_mesh(4, devices=["cpu"] * 4),
                          np.array([[1000.0, C, 0.0, 20.0, 0.0],
                                    [1896.0, 2494.0, 1400.0, 150.0, 50.0]]),
                          T.FDTDGrid(**g)) is None
