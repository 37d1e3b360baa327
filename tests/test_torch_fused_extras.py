"""The fluid sweep's extras route (CPU): B4's ``with_p2`` and monitor capture.

A fluid run whose diagnostics are only ``Pressure_rms`` / ``Pressure_peak``
and monitors (``ops.fdtd.extras_eligible``, JAX's rule for B4's Pallas
path) takes its window in the fused sweep's extras instantiations
(``ops.fdtd_fused_kernels.fluid_fused`` with ``extras`` / ``monitor``;
on the CPU their plain version: K steps of the pair's, the maps' pass and
the monitor gather after each). Held here:

* to JAX's ``run_fdtd(backend="pallas")`` in interpret mode, which is B4
  with ``with_p2`` and its driver's monitor capture (one interpret run):
  both maps at the plane band (1e-4 of the peak, rtol 1e-3), the series at
  JAX's sample steps, a subset of the port's;
* to the port's pair route (``fuse_steps=0``) bit for bit: plane and point
  sources, a window neither 3 nor 4 divides, ``sensor_subsampling`` 1, 2
  and 3, maps only, monitors only and both, a voxel listed twice;
* the route, by the plain-call counts: other maps, shear media, a mesh and
  a volumetric source keep the pair, ``EXTRAS_FUSE_BEST`` = 0 keeps every
  step on the pair, a larger one sweeps the window;
* the sweep's voxel list (``sweep_csr``): a numpy walk of the kernel's
  cursor visits each listed voxel once, at its plane, in the tile row
  whose lane writes it, for every stage.
"""

import functools

import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_extras as E
from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VK
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
from babelbrain_tpu_torch.parallel.halo import make_mesh

torch.set_num_threads(2)

F0 = 500e3
MAPS = ("Pressure_rms", "Pressure_peak")
# two voxels of the beam's plane and one listed twice
MONITORS = np.array([[32, 16, 40], [20, 10, 30], [32, 16, 40]])


def _config(n_win=21, source="velocity_plane"):
    """`tests/test_fused_kernel.py:525-556`'s B4 configuration (64x32x64
    water, two periods then an ``n_win``-step window; 21 is JAX's, which
    its depths divide); a stress point at the centre for ``source``."""
    C = 1500.0
    shape = (64, 32, 64)
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, C, 0.9)))
    ns = ppp * 2 + n_win
    g = dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns, frequency=F0,
             sensor_start=ns - n_win, source_plane_z=13, source_type=source,
             source_ijk=(32, 16, 32))
    mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
    amp = np.zeros(shape[:2])
    amp[8:-8, 8:-8] = 60e3
    kw = (dict(source_amp=amp) if source == "velocity_plane"
          else dict(point_amp=60e3))
    return np.zeros(shape, np.uint8), mats, g, kw


def _counts():
    """Every plain-call count of the FDTD wrappers, copied."""
    return {**FK.plain_calls, **K.plain_calls, **E.plain_calls,
            **VK.plain_calls, **V.plain_calls}


def _grown(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _run(idx, mats, g, kw, **extra):
    """(``run_fdtd`` on the CPU, the plain calls it made)."""
    before = _counts()
    out = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw, **extra)
    return out, _grown(before)


def _equal(out, ref):
    assert set(out) == set(ref)
    for name, v in ref.items():
        np.testing.assert_array_equal(out[name], v, err_msg=name)


@functools.cache
def _jax_b4():
    idx, mats, g, kw = _config()
    return J.run_fdtd(idx, mats, J.FDTDGrid(**g), backend="pallas",
                      sel_maps=MAPS, monitor_ijk=MONITORS[:2], **kw)


def test_extras_route_matches_jax_b4_interpret():
    """K = 3 extras sweeps against B4 with ``with_p2`` and its monitor
    capture (JAX's Pallas path, interpret mode): the maps at the plane band,
    the series at B4's sample steps (once a sweep), which the port samples
    too (every window step); the port's window runs in extras sweeps."""
    idx, mats, g, kw = _config()
    oj = _jax_b4()
    ot, grew = _run(idx, mats, g, kw, sel_maps=MAPS,
                    monitor_ijk=MONITORS[:2], fuse_steps=3)
    assert grew["fluid_fused_extras_dft"] == 21 // 3
    steps_j = np.round(oj["sensor_times"] / g["dt"]).astype(int)
    steps_t = np.round(ot["sensor_times"] / g["dt"]).astype(int)
    np.testing.assert_array_equal(steps_t, np.arange(g["sensor_start"],
                                                     g["n_steps"]))
    assert 0 < len(steps_j) < len(steps_t)
    pos = np.searchsorted(steps_t, steps_j)
    np.testing.assert_array_equal(steps_t[pos], steps_j)
    for name in MAPS + ("p_amp",):
        scale = np.abs(oj[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(ot[name], oj[name], atol=1e-4 * scale,
                                   rtol=1e-3, err_msg=name)
    s = np.abs(oj["sensor_series"]).max()
    assert s > 0
    np.testing.assert_allclose(ot["sensor_series"][:, pos],
                               oj["sensor_series"], atol=1e-4 * s, rtol=1e-3)


@pytest.mark.parametrize("what", ["maps", "monitors", "both"])
@pytest.mark.parametrize("subsampling", [1, 2, 3])
@pytest.mark.parametrize("source", ["velocity_plane", "stress_point"])
def test_extras_route_equals_the_pair_route(source, subsampling, what):
    """A 22-step window, which neither K = 3 nor K = 4 divides (JAX sends
    such a run to XLA): the extras sweeps at both depths equal the pair
    route (``fuse_steps=0``, every step on the pair) bit for bit, in the
    carrier, both maps and the series (a voxel listed twice)."""
    idx, mats, g, kw = _config(22, source)
    diag = dict(sensor_subsampling=subsampling)
    if what != "monitors":
        diag["sel_maps"] = MAPS
    if what != "maps":
        diag["monitor_ijk"] = MONITORS
    ref, grew = _run(idx, mats, g, kw, fuse_steps=0, **diag)
    assert not any(k.startswith("fluid_fused") for k in grew)
    assert grew["fluid_velocity"] == g["n_steps"]
    for k in (3, 4):
        out, grew = _run(idx, mats, g, kw, fuse_steps=k, **diag)
        key = FK.fused_key(True, None if source == "velocity_plane" else 0,
                           True)
        # 22 = 7 x 3 + a tail step; 5 x 4 + a 2-step sweep
        assert grew[key] == (7 if k == 3 else 6)
        if what != "monitors":
            assert float(np.abs(out["Pressure_rms"]).max()) > 0
        if what != "maps":
            assert out["sensor_series"].shape == (
                3, len(range(g["sensor_start"], g["n_steps"], subsampling)))
            np.testing.assert_array_equal(out["sensor_series"][0],
                                          out["sensor_series"][2])
        _equal(out, ref)


@pytest.mark.parametrize("source", ["velocity_plane", "stress_point"])
def test_pressure_peak_is_the_carrier_peak(source):
    """Every fluid run reads ``Pressure_peak`` from the carrier peak (no
    accumulator of its own), on the pair and in the extras sweeps alike;
    the carrier peak of the pair equals a Pressure_peak accumulator that
    the maps' pass feeds after each window step, bit for bit."""
    idx, mats, g, kw = _config(source=source)
    outs = []
    for k in (0, 3):
        out, grew = _run(idx, mats, g, kw, sel_maps=("Pressure_peak",),
                         fuse_steps=k)
        assert "extras_fluid" not in grew  # no accumulator fed
        np.testing.assert_array_equal(out["Pressure_peak"], out["peak"])
        outs.append(out)
    _equal(outs[1], outs[0])
    grid = T.FDTDGrid(**g)
    amp = kw.get("source_amp")
    step, st, co, oz, _ = T.fdtd_setup(
        idx, mats, grid, amp, None if amp is None else np.zeros_like(amp),
        device="cpu")
    own = E.Extras.zeros(("Pressure_peak",), g["shape"], "cpu", False)
    for n in range(grid.n_steps):
        step(st, co, grid, n, oz, kw.get("point_amp", 0.0))
        if n >= grid.sensor_start:
            E.extras_accumulate_ref(st, own)
    assert float(st.peak.max()) > 0
    torch.testing.assert_close(own.acc["Pressure_peak"], st.peak, rtol=0,
                               atol=0)
    np.testing.assert_array_equal(outs[0]["Pressure_peak"], st.peak.numpy())
    st = K.FluidState.zeros((4, 4, 4), 2, "cpu")
    ex = E.Extras.zeros(MAPS + ("Sigmaxx_peak",), (4, 4, 4), "cpu", False,
                        peak=st.peak)
    assert set(ex.acc) == {"Pressure_rms"}
    assert ex.carried["Pressure_peak"] is st.peak
    assert ex.mask == 1 << E.SEL_MAPS.index("Pressure_rms")
    st.peak.fill_(2.0)
    assert (ex.read(4)["Sigmaxx_peak"] == 2.0).all()
    diag = E.Diagnostics.create(st, 0, E.SEL_MAPS)
    assert "Pressure_peak" not in diag.extras.acc
    assert diag.extras.carried["Pressure_peak"] is st.peak


def _shear_config():
    """``_config``'s grid with a shear slab, at a time step stable in it."""
    idx, mats, g, kw = _config()
    mats = np.array([[1000.0, 1500.0, 0, 0, 0],
                     [1800.0, 2400.0, 1200.0, 50.0, 80.0]])
    idx = idx.copy()
    idx[:, :, 30:34] = 1
    ppp = int(np.ceil(1 / F0 / J.stable_dt(g["dx"], 2400.0, 0.5)))
    ns = ppp * 2 + 21
    g = dict(g, dt=1 / F0 / ppp, n_steps=ns, sensor_start=ns - 21)
    return idx, mats, g, kw


@pytest.mark.parametrize("case", ["other maps", "shear", "mesh", "volume",
                                  "best 0", "best 4"])
def test_route(monkeypatch, case):
    """Which runs take the extras sweeps, by the plain calls: a map other
    than the Pressure ones, shear media, a mesh of two CPU devices and a
    volumetric source keep the pair for every step; with ``fuse_steps=None``
    ``EXTRAS_FUSE_BEST`` = 0 keeps today's launches (the pair for every
    step), 4 sweeps the window at K = 4 after the quiet phase's sweeps."""
    idx, mats, g, kw = _config()
    diag = dict(sel_maps=MAPS, monitor_ijk=MONITORS)
    fuse = 3
    if case == "other maps":
        diag["sel_maps"] = MAPS + ("Vx_rms",)
    elif case == "shear":
        idx, mats, g, kw = _shear_config()
    elif case == "mesh":
        diag["mesh"] = make_mesh(2, devices=["cpu"] * 2)
    elif case == "volume":
        n1, n2, n3 = g["shape"]
        amp = np.zeros(g["shape"])
        amp[20:44, 8:24, 20] = 60e3
        zeros = np.zeros(g["shape"])
        g = dict(g, source_type="velocity_volume")
        kw = dict(volume_source=dict(amp=amp, phase=zeros, ox=zeros,
                                     oy=zeros, oz=zeros + 1.0))
    else:
        fuse = None
        monkeypatch.setattr(FK, "EXTRAS_FUSE_BEST", int(case[-1]))
    out, grew = _run(idx, mats, g, kw, fuse_steps=fuse, **diag)
    swept = {k: v for k, v in grew.items()
             if "fused" in k or "halo" in k}
    if case == "best 4":
        # the quiet phase as fused_plan gives it, the window K = 4 sweeps
        # (21 = 5 x 4 + a tail step on the pair with the maps' pass)
        plan = T.fused_plan(g["shape"], "cpu", True, False)
        quiet = T.phase_schedule(0, g["sensor_start"], plan.k, plan.fused2)
        assert swept == {k: v for k, v in (("fluid_fused", len(quiet[0])),
                                           ("fluid_fused_extras_dft", 5))
                         if v}
        assert grew["extras_fluid"] == 21 and grew["monitor_fluid"] == 21
    else:
        assert swept == {}
        fam = "visco" if case == "shear" else "fluid"
        n_runs = 2 if case == "mesh" else 1  # each shard steps
        assert grew[f"{fam}_velocity"] == n_runs * g["n_steps"]
    assert float(np.abs(out["p_amp"]).max()) > 0


def test_extras_plan():
    """``extras_plan``: the quiet phase as ``fused_plan``; a window depth
    below 2 keeps the pair (None); a pinned K above ``K_CAP`` is refused as
    ``fused_plan`` refuses it."""
    shape = (64, 32, 64)
    assert T.extras_plan(shape, "cpu", True, False) is None  # best 0
    for k in (0, 1):
        assert T.extras_plan(shape, "cpu", True, False, k) is None
    assert T.extras_plan(shape, "cpu", True, True, 2) == T.FusedPlan(2, 2,
                                                                     True)
    assert T.extras_plan(shape, "cpu", True, False, 4) == T.FusedPlan(4, 4,
                                                                      True)
    with pytest.raises(ValueError, match="outside"):
        T.extras_plan(shape, "cpu", True, False, FK.K_CAP + 1)


def test_extras_route_needs_the_window_and_a_whole_grid():
    """The wrapper refuses an extras sweep outside the window, on a shard's
    slab, with a map the sweep does not sum, or with rows that do not fit
    the launch."""
    idx, mats, g, kw = _config()
    grid = T.FDTDGrid(**g)
    _, st, co, oz, _ = T.fdtd_setup(idx, mats, grid, kw["source_amp"],
                                    np.zeros(g["shape"][:2]), device="cpu")
    rows = [T.step_scalars(grid, n, oz) for n in range(3)]
    ex = E.Extras.zeros(MAPS, g["shape"], "cpu", False, peak=st.peak)
    with pytest.raises(ValueError, match="window"):
        FK.fluid_fused(st, co, rows, with_dft=False, extras=ex)
    with pytest.raises(ValueError, match="p\\^2 only"):
        FK.fluid_fused(st, co, rows, with_dft=True,
                       extras=E.Extras.zeros(("Vx_rms",), g["shape"], "cpu",
                                             False))
    diag = E.Diagnostics.create(st, 0, MAPS, sample_steps=[0, 1],
                                index=E.monitor_index(MONITORS, g["shape"],
                                                      "cpu"), sweep=True)
    with pytest.raises(ValueError, match="sweep monitor"):
        FK.fluid_fused(st, co, rows, with_dft=True,
                       monitor=diag.sweep_monitor(0, 2))
    assert diag.sweep_monitor(0, 3).rows == (0, 1, -1)
    co.x_lo = False
    with pytest.raises(ValueError, match="whole grid"):
        FK.fluid_fused(st, co, rows, with_dft=True, extras=ex)


def _warp_of(shape, geo):
    """(N2, N3): the sweep warp whose lane writes each column, from the
    tile cover: (z-tile + gz * y-tile) * tile_y + the row, whatever the
    plane and the stage."""
    n1, n2, n3 = shape
    gz = geo.grid[0]
    bz = np.repeat(np.arange(geo.grid[0]), K.TILE_Z)[:n3]
    by = np.repeat(np.arange(geo.grid[1]), geo.tile_y)[:n2]
    row = np.tile(np.arange(geo.tile_y), geo.grid[1])[:n2]
    return (bz[None, :] + gz * by[:, None]) * geo.tile_y + row[:, None]


@pytest.mark.parametrize("shape", [(27, 45, 47), (216, 216, 224)])
def test_sweep_csr_walk(shape):
    """A numpy copy of the EXTRAS instantiations' cursor: each stage's
    cell walks its tile row's entries plane by plane and stores the entry
    whose cell it writes. Every listed voxel (repeats, the first and last
    cells and tile corners on the stages' hand-over planes included) is
    stored once a stage, at its own plane, by a lane of the row that
    writes it; the list is ``monitor_csr`` under the sweep's geometry."""
    n1, n2, n3 = shape
    geo = E.sweep_geometry(shape)
    assert geo == FK.fused_launch_geometry(shape, 1)
    rng = np.random.default_rng(3)
    lin = rng.integers(0, n1 * n2 * n3, 300)
    corners = [np.ravel_multi_index((i, j, k), shape)
               for i in (0, FK.LAG - 1, FK.LAG, n1 - 1)
               for j in (K.TILE_Y - 1, K.TILE_Y, FK.ROWS - 1, FK.ROWS)
               for k in (K.TILE_Z - 1, K.TILE_Z)]
    lin = np.concatenate([lin, lin[[4, 4, 17]], corners, [0, n1 * n2 * n3
                                                          - 1]])
    start, (cell, slot) = E.sweep_csr(lin, shape)
    ref_start, (ref_cell, ref_slot) = E.monitor_csr(lin, shape, geo)
    np.testing.assert_array_equal(start, ref_start)
    assert sorted(zip(cell, slot)) == sorted(zip(ref_cell, ref_slot))
    plane = n2 * n3
    owner = _warp_of(shape, geo).reshape(-1)[cell % plane]
    for stage in range(4):  # the walk does not depend on the stage
        stored = []
        for w in np.flatnonzero(np.diff(start)):
            e, e_end = start[w], start[w + 1]
            for ip in range(n1):
                while e < e_end and cell[e] < (ip + 1) * plane:
                    assert cell[e] // plane == ip
                    assert owner[e] == w
                    stored.append((stage, int(slot[e])))
                    e += 1
            assert e == e_end
        assert sorted(s for _, s in stored) == list(range(len(lin)))
    np.testing.assert_array_equal(lin[slot], cell)
