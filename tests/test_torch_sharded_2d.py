"""Port parity: the (x, y) decomposition of ``babelbrain_tpu_torch`` on the CPU.

Twins of the 2-D tests of `tests/test_sharded.py:64-122` on meshes of CPU
devices (``make_mesh_2d(nx, ny, devices=["cpu"] * (nx * ny))``): a ``run_fdtd``
cut along x and y must equal the port's unsharded run bit for bit (fluid
and shear media; plane, point and volumetric sources; maps and monitors
owned by shards on both axes; a 1-D mesh on axis "y"), and is held to the
JAX package's 2-D XLA run (its Pallas drivers decompose x only) on the
conftest's 8 CPU devices at the bands of ROADMAP "Ground rules": a plane
source 1e-4 of the peak with rtol 1e-3, a point 1e-6 of the peak, a
volumetric source 1e-5 (the band of `tests/test_torch_sharded.py`). Then
the refusals with JAX's messages, ``run_acoustic_sim`` on a 2 x 2 mesh
against JAX's, the y ghost-plane refresh (``Blocks``) and a check that
leaving any field out of the y refresh set (``ops.fdtd.HALO_FIELDS``)
changes the result. The grids are small (npml 4-6) so that the file runs
in about a minute on one worker.
"""

import functools

import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.parallel.halo import make_mesh as j_make_mesh
from babelbrain_tpu.parallel.halo import make_mesh_2d as j_make_mesh_2d
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
from babelbrain_tpu_torch.parallel import halo as H

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
SHEAR = [[1000.0, C, 0, 0, 0], [1896.5, 2494.0, 1594.0, 106.0, 214.0]]
FLUID = [[1000.0, C, 0.0, 20.0, 0.0], [1896.0, 2494.0, 0.0, 150.0, 0.0]]
PLANE, POINT, VOLUME = 1e-4, 1e-6, 1e-5  # bands, of the JAX run's peak


def mesh_2d(nx, ny):
    return H.make_mesh_2d(nx, ny, devices=["cpu"] * (nx * ny))


def _grid(shape, n_cycles, npml=6, **kw):
    """`tests/test_sharded.py`'s grid at npml 6, as FDTDGrid keywords."""
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, cfl=0.9)))
    nsteps = ppp * n_cycles
    return dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=nsteps,
                frequency=F0, npml=npml, sensor_start=nsteps - 2 * ppp,
                source_plane_z=npml + 1, **kw)


def _equal(a, b, keys=None):
    for k in keys or a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _band(ot, oj, band, rtol=0.0, keys=("p_amp", "peak")):
    for k in keys:
        scale = np.abs(oj[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(ot[k], oj[k], atol=band * scale,
                                   rtol=rtol, err_msg=k)


def _plane(shape, seed):
    rng = np.random.default_rng(seed)
    amp = np.zeros(shape[:2], np.float32)
    amp[6:-6, 6:-6] = 60e3 * rng.uniform(0.5, 1, (shape[0] - 12,
                                                   shape[1] - 12))
    ph = rng.uniform(-2, 2, shape[:2]).astype(np.float32)
    return dict(source_amp=amp, source_phase=ph)


@functools.cache
def _case(name):
    """(index, materials, grid keywords, run_fdtd keywords, the port's
    unsharded result) of each configuration."""
    if name == "shear":  # `tests/test_sharded.py:68`: a shear slab on 4x2
        shape = (48, 48, 40)
        g = _grid(shape, 3)
        mats = np.array(SHEAR)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 22:28] = 1
        kw = _plane(shape, 0)
    elif name == "fluid":  # `:81`: fluid on 2x4, y-dominant
        shape = (48, 64, 40)
        g = _grid(shape, 3)
        mats = np.array(FLUID[:1])
        idx = np.zeros(shape, np.uint8)
        kw = _plane(shape, 1)
    elif name in ("point", "point_shear"):  # `:97`: y-interior shard of 2x4
        shape = (48, 64, 40)
        g = _grid(shape, 4 if name == "point" else 3, npml=4,
                  source_type="stress_point", source_ijk=(30, 37, 20))
        g["source_plane_z"] = 5
        mats = np.array(SHEAR if name == "point_shear" else SHEAR[:1])
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 26:32] = name == "point_shear"
        kw = dict(point_amp=60e3)
    elif name in ("volume", "volume_shear"):  # a dome-like shell on 2x2
        shape = (48, 48, 40)
        g = _grid(shape, 3, source_type="velocity_volume")
        mats = np.array(SHEAR if name == "volume_shear" else FLUID)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 26:30] = 1
        kw = dict(volume_source=_shell_source(shape, (24.0, 24.0, 22.0)))
    else:  # maps and monitors on 2x2
        shape = (48, 48, 40)
        g = _grid(shape, 3)
        shear = name == "maps_shear"
        mats = np.array(SHEAR if shear else FLUID[:1])
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 24:30] = shear
        kw = dict(_plane(shape, 2), sel_maps=MAPS, monitor_ijk=MONITORS,
                  sensor_subsampling=2)
    o1 = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    return idx, mats, g, kw, o1


def _shell_source(shape, centre, seed=7):
    """The dome shell of `tests/test_torch_sharded.py` (phased), a dense
    dict; its voxels span the four shards of a 2 x 2 mesh."""
    ci, cj, ck = centre
    ii, jj, kk = np.mgrid[:shape[0], :shape[1], :shape[2]]
    r = np.sqrt((ii - ci) ** 2 + (jj - cj) ** 2 + (kk - ck) ** 2)
    shell = (r > 9) & (r < 11) & (kk < ck)
    rng = np.random.default_rng(seed)
    rr = np.maximum(r, 1e-6)
    return dict(amp=np.where(shell, 60e3, 0.0).astype(np.float32),
                phase=(rng.uniform(-2, 2, shape) * shell).astype(np.float32),
                ox=((ci - ii) / rr).astype(np.float32),
                oy=((cj - jj) / rr).astype(np.float32),
                oz=((ck - kk) / rr).astype(np.float32))


MAPS = ("Pressure_rms", "Vy_peak", "Sigmayy_rms", "Vx_peak")
# on the x boundary (i = 23 | 24), the y boundary (j = 23 | 24), a corner
# of all four shards, inside each shard, one voxel twice
MONITORS = np.array([[23, 10, 20], [24, 10, 20], [10, 23, 22], [10, 24, 22],
                     [23, 23, 24], [24, 24, 24], [36, 36, 18], [40, 8, 30],
                     [8, 40, 30], [24, 24, 24]])
MESHES = {"shear": (4, 2), "fluid": (2, 4), "point": (2, 4),
          "point_shear": (2, 4), "volume": (2, 2), "volume_shear": (2, 2),
          "maps": (2, 2), "maps_shear": (2, 2)}


@functools.cache
def _sharded(name):
    idx, mats, g, kw, _ = _case(name)
    return T.run_fdtd(idx, mats, T.FDTDGrid(**g), mesh=mesh_2d(*MESHES[name]),
                      **kw)


@pytest.mark.parametrize("name", list(MESHES))
def test_2d_mesh_bit_equal(name):
    """Every source type and both media on their mesh equal the unsharded
    run bit for bit, the maps and the monitor series included."""
    o1 = _case(name)[-1]
    assert np.isfinite(o1["p_amp"]).all() and o1["p_amp"].max() > 0
    _equal(o1, _sharded(name))
    if "sensor_series" in o1:
        assert o1["sensor_series"].shape == (len(MONITORS),
                                             len(o1["sensor_times"]))


def _jax(name, mesh):
    idx, mats, g, kw, _ = _case(name)
    return J.run_fdtd(idx, mats, J.FDTDGrid(**g), mesh=mesh, backend="xla",
                      **kw)


@pytest.mark.parametrize("name,band,rtol", [
    ("shear", PLANE, 1e-3), ("fluid", PLANE, 1e-3), ("point", POINT, 0.0),
    ("volume", VOLUME, 0.0)])
def test_2d_mesh_matches_jax_xla(name, band, rtol):
    """Against JAX's XLA run on the same (nx, ny) mesh of CPU devices, at
    the band of the source type, every cell: the point run's source cell
    too, whose 'peak' is an instantaneous value of the drive itself, since
    the port computes the drive in float32 as JAX's step does
    (``test_point_drive_is_jax_float32_drive``)."""
    ot, oj = _sharded(name), _jax(name, j_make_mesh_2d(*MESHES[name]))
    _band(ot, oj, band, rtol)


def _jax_point_drive(g, amp):
    """JAX's stress-point ``sval`` of every step, by the expressions of its
    XLA step (`babelbrain_tpu/ops/fdtd.py:521, :557-562, :855`), jitted in
    a scan as the step is."""
    import jax
    import jax.numpy as jnp

    grid = J.FDTDGrid(**g)
    omega = 2.0 * np.pi * grid.frequency

    def step(carry, n):
        t = n.astype(jnp.float32) * grid.dt
        ramp_steps = grid.ramp_cycles / grid.frequency / grid.dt
        ramp = jnp.where(n < ramp_steps,
                         0.5 * (1.0 - jnp.cos(np.pi * n / ramp_steps)),
                         1.0).astype(jnp.float32)
        return carry, carry * jnp.sin(omega * t) * ramp * jnp.float32(1.0)

    _, sval = jax.jit(lambda a: jax.lax.scan(
        step, a, jnp.arange(grid.n_steps, dtype=jnp.int32)))(
            jnp.float32(amp))
    return np.asarray(sval)


def test_point_drive_is_jax_float32_drive(monkeypatch):
    """ROADMAP C1: the port's stress-point drive (``step_scalars``' s_point,
    ``point_value``) equals JAX's float32 ``sval`` at every step of the
    point case, where the float64 drive cast to float32 misses it on most
    steps; and the source cell's 'peak' follows it: the unsharded run
    with the float64 drive misses JAX's unsharded XLA run there by more
    than the point band, the run with the float32 drive meets it (as every
    other cell does either way)."""
    idx, mats, g, kw, o1 = _case("point")
    grid = T.FDTDGrid(**g)
    amp = kw["point_amp"]
    sval = _jax_point_drive(g, amp)
    ours = np.array([T.step_scalars(grid, n, 1.0, amp)[4]
                     for n in range(grid.n_steps)], np.float32)
    np.testing.assert_array_equal(ours, sval)

    def float64_drive(grid, n, point_amp):
        omega = 2.0 * np.pi * grid.frequency
        ramp_steps = grid.ramp_cycles / grid.frequency / grid.dt
        ramp = (0.5 * (1.0 - np.cos(np.pi * n / ramp_steps))
                if n < ramp_steps else 1.0)
        return float(point_amp * np.sin(omega * (n * grid.dt)) * ramp)

    wide = np.array([float64_drive(grid, n, amp)
                     for n in range(grid.n_steps)], np.float32)
    assert (wide != sval).sum() > grid.n_steps // 2
    oj = _jax("point", None)
    cell = tuple(g["source_ijk"])
    scale = oj["peak"].max()
    _band(o1, oj, POINT)
    monkeypatch.setattr(T, "point_value", float64_drive)
    o64 = T.run_fdtd(idx, mats, grid, device="cpu", **kw)
    other = np.ones(oj["peak"].shape, bool)
    other[cell] = False
    np.testing.assert_allclose(o64["peak"][other], oj["peak"][other],
                               atol=POINT * scale)
    assert abs(o64["peak"][cell] - oj["peak"][cell]) > POINT * scale


def test_maps_and_monitors_match_jax_xla():
    """The fluid maps and monitor series of the 2 x 2 run against JAX's 2 x 2
    XLA run, at the plane band; the sample times exactly."""
    oj = _jax("maps", j_make_mesh_2d(2, 2))
    ot = _sharded("maps")
    _band(ot, oj, PLANE, rtol=1e-3, keys=MAPS + ("p_amp",))
    np.testing.assert_allclose(ot["sensor_series"], oj["sensor_series"],
                               atol=PLANE * np.abs(oj["sensor_series"]).max(),
                               rtol=1e-3)
    np.testing.assert_array_equal(ot["sensor_times"], oj["sensor_times"])


def test_y_mesh_bit_equal_and_matches_jax():
    """A 1-D mesh on axis "y" (one x slab, two y slabs) equals the unsharded
    run bit for bit and JAX's y-mesh XLA run at the plane band."""
    idx, mats, g, kw, o1 = _case("fluid")
    oy = T.run_fdtd(idx, mats, T.FDTDGrid(**g), **kw,
                    mesh=H.make_mesh(2, "y", devices=["cpu"] * 2))
    _equal(o1, oy)
    _band(oy, _jax("fluid", j_make_mesh(2, axis="y")), PLANE, rtol=1e-3)


def test_y_cpml_ownership():
    """On the 4 x 2 shear run's shards (``shard_setup`` + ``step_shards``,
    20 steps) each shard applies only the y slab of the edge it holds: the
    other slab's psi stays zero, the held one does not."""
    idx, mats, g, kw, _ = _case("shear")
    g = dict(g, n_steps=20, sensor_start=10)
    dd, shards, oz = T.shard_setup(mesh_2d(4, 2), idx, mats, T.FDTDGrid(**g),
                                   kw["source_amp"], kw["source_phase"])
    for n in range(g["n_steps"]):
        T.step_shards(shards, dd, T.FDTDGrid(**g), n, oz)
    for s, sh in enumerate(shards):
        x_lo, x_hi, y_lo, y_hi = dd.edges(s)
        assert (sh.co.y_lo, sh.co.y_hi) == (y_lo, y_hi) == (s % 2 == 0,
                                                            s % 2 == 1)
        for held, slabs in zip((y_lo, y_hi), _psi_y(sh.st)):
            assert any(t.any() for t in slabs) == held, s


def _psi_y(st):
    """The y-slab psi tensors of a state, as (lo list, hi list)."""
    if isinstance(st, K.FluidState):
        pairs = [(st.psi_p, 1), (st.psi_v, 1)]
    else:
        pairs = [(psi, q) for psi, derivs in ((st.psi_s, V.VELOCITY_DERIVS),
                                              (st.psi_v, V.STRESS_DERIVS))
                 for q, d in enumerate(derivs) if d[1] == 1]
    return ([psi[2 * q] for psi, q in pairs],
            [psi[2 * q + 1] for psi, q in pairs])


# ---------------------------------------------------------------------------
# refusals, the entry point, the refresh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,mesh,match", [
    ((64, 48, 40), (1, 8), "shard too thin for the PML slab"),
    ((64, 50, 40), (2, 4), r"not divisible by mesh \(2, 4\)")])
def test_2d_mesh_refusals_match_jax(shape, mesh, match):
    """`tests/test_sharded.py:114` twin (1 x 8 leaves 6 rows a shard, below
    npml + 2 = 14) and a grid whose N2 the mesh does not divide: both
    packages raise ValueError with the same message."""
    g = _grid(shape, 1, npml=12)
    idx = np.zeros(shape, np.uint8)
    amp = np.zeros(shape[:2])
    with pytest.raises(ValueError, match=match):
        J.run_fdtd(idx, np.array(SHEAR), J.FDTDGrid(**g), source_amp=amp,
                   mesh=j_make_mesh_2d(*mesh), backend="xla")
    with pytest.raises(ValueError, match=match):
        T.run_fdtd(idx, np.array(SHEAR), T.FDTDGrid(**g), source_amp=amp,
                   mesh=mesh_2d(*mesh))


def test_run_acoustic_sim_on_a_2d_mesh():
    """``run_acoustic_sim(mesh=make_mesh_2d(2, 2))`` at the 24x24x40
    multipoint mask (`tests/test_torch_sweep.py`): its DataForSim maps equal
    the unsharded run's bit for bit, and JAX's ``run_acoustic_sim`` on its
    2 x 2 mesh at the plane band."""
    from babelbrain_tpu.pipeline import acoustic as JA
    from babelbrain_tpu.pipeline import domain as JD
    from babelbrain_tpu.tx import make_annular_array
    from babelbrain_tpu_torch import convert
    from babelbrain_tpu_torch.pipeline import acoustic as TA

    mask = np.zeros((24, 24, 40), np.uint8)
    mask[6:18, 6:18, 10:30] = 4
    mask[12, 12, 20] = 5
    mats = JD.build_label_materials(500e3, False)[:1]
    dom_j = JD.build_domain(mask, 500e3, 6.0, materials=mats,
                            water_only=True)
    F = 62.94e-3
    tx_j = make_annular_array(
        500e3, F, [0.0, 31.6988e-3, 44.2688e-3, 53.6688e-3],
        [31.14e-3, 43.71e-3, 53.11e-3, 60.83e-3], 1500.0, ppw_surface=1.0,
    ).translated([0, 0, F])
    tx_j = JA.position_transducer(tx_j, dom_j, F)
    dom_t = convert.domain_from_reference(dom_j)
    tx_t = convert.transducer_from_reference(tx_j)
    n1, n2 = dom_t.material_map.shape[:2]
    assert n1 % 2 == n2 % 2 == 0 and min(n1, n2) // 2 >= dom_t.npml + 2
    r1 = TA.run_acoustic_sim(dom_t, tx_t, 60e3, device="cpu")
    r2 = TA.run_acoustic_sim(dom_t, tx_t, 60e3, device="cpu",
                             mesh=mesh_2d(2, 2))
    rj = JA.run_acoustic_sim(dom_j, tx_j, 60e3, mesh=j_make_mesh_2d(2, 2))
    keys = ("p_amp", "p_complex_re", "p_complex_im", "p_amp_water")
    _equal(r1.data_for_sim, r2.data_for_sim, keys)
    assert r2.p_amp.max() > 0
    np.testing.assert_allclose(r2.p_amp, rj.p_amp, rtol=1e-3,
                               atol=PLANE * rj.p_amp.max())


def test_blocks_refresh_ghost_planes():
    """On a 2 x 3 mesh of a 12 x 18 x 2 volume each shard's x and y ghost
    planes take their neighbours' own cells; the global edges have none.
    The corner cells (ghost along both axes) are not checked: the
    axis-aligned stencil of an owned cell never reads them."""
    dd = H.Blocks(H.XSlabs(12, 2), H.XSlabs(18, 3, axis=1))
    full = torch.arange(12 * 18 * 2.0).reshape(12, 18, 2)
    parts = []
    for s in range(dd.n_shards):
        p = torch.full(dd.planes(s) + (2,), -1.0)
        (a, b), (ox, oy) = dd.start(s), dd.own(s)
        p[ox, oy] = full[a + ox.start:a + ox.stop, b + oy.start:b + oy.stop]
        parts.append(p)
    dd.refresh(parts, 0)
    dd.refresh(parts, 1)
    assert [dd.planes(s) for s in range(6)] == [(8, 8), (8, 10), (8, 8)] * 2
    for s, p in enumerate(parts):
        (a, b), (ox, oy) = dd.start(s), dd.own(s)
        want = full[a:a + p.shape[0], b:b + p.shape[1]]
        read = torch.zeros(p.shape[:2], dtype=torch.bool)
        read[ox, :] = True
        read[:, oy] = True
        assert torch.equal(p[read], want[read]), s
    np.testing.assert_array_equal(T.own_planes(dd, parts), full.numpy())
    assert [dd.owner(i, j) for i, j in ((0, 0), (5, 6), (6, 5), (11, 17))] \
        == [0, 1, 3, 5]


# the y refresh set of each family, one field at a time
Y_FIELDS = [("fluid", 0, "vy"), ("fluid", 1, "p")] + [
    ("visco", 0, f) for f in ("vx", "vy", "vz")] + [
    ("visco", 1, f) for f in ("sxy", "syy", "syz")]


def _refresh_inputs(family):
    """(index, materials, grid, plane amplitude, phase): 20 steps of a
    plane over the whole (x, y) extent, so that every field is nonzero at
    the shards' y boundary from the first steps."""
    shape = (16, 32, 24)
    g = T.FDTDGrid(**dict(_grid(shape, 1, npml=4), n_steps=20,
                          sensor_start=10))
    mats = np.array(SHEAR if family == "visco" else FLUID[:1])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 12:16] = family == "visco"
    amp = np.full(shape[:2], 60e3)
    ph = np.random.default_rng(5).uniform(-2, 2, shape[:2])
    return idx, mats, g, amp, ph


@functools.cache
def _refresh_runs(family, drop=None):
    """The state's fields (own cells) after ``_refresh_inputs``'s steps:
    unsharded (``drop`` "whole"), or on a 1 x 2 mesh with ``HALO_FIELDS``
    as it is (None) or with the y field ``drop`` = (half-step, name) left
    out."""
    idx, mats, g, amp, ph = _refresh_inputs(family)
    if drop == "whole":
        step, st, co, oz, _ = T.fdtd_setup(idx, mats, g, amp, ph,
                                           device="cpu")
        for n in range(g.n_steps):
            step(st, co, g, n, oz)
        return {k: v.numpy() for k, v in vars(st).items()
                if torch.is_tensor(v)}
    state = V.ViscoState if family == "visco" else K.FluidState
    fields = dict(T.HALO_FIELDS[state])
    if drop is not None:
        half, name = drop
        fields[1] = tuple(tuple(f for f in names if f != name) if h == half
                          else names for h, names in enumerate(fields[1]))
    dd, shards, oz = T.shard_setup(mesh_2d(1, 2), idx, mats, g, amp, ph)
    with pytest.MonkeyPatch.context() as m:
        m.setitem(T.HALO_FIELDS, state, fields)
        for n in range(g.n_steps):
            T.step_shards(shards, dd, g, n, oz)
    names = [k for k, v in vars(shards[0].st).items() if torch.is_tensor(v)]
    return {k: T.own_planes(dd, [getattr(sh.st, k) for sh in shards])
            for k in names}


@pytest.mark.parametrize("family,half,name", Y_FIELDS)
def test_every_y_refresh_field_is_needed(family, half, name):
    """``HALO_FIELDS``'s y set is the fields the next half-step differences
    along y: with it the 1 x 2 run's every field equals the unsharded
    run's; without any one of them the owned cells differ."""
    full = _refresh_runs(family)
    for k, v in _refresh_runs(family, "whole").items():
        np.testing.assert_array_equal(full[k], v, err_msg=k)
    cut = _refresh_runs(family, (half, name))
    assert any(not np.array_equal(cut[k], full[k]) for k in full), name
