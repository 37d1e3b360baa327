"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These kernels have no CPU mode, so every test here needs a CUDA device (and
nvcc to build ``babelbrain_tpu_torch/csrc``); without one they skip. Run
them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q

``python3 chip_smoke.py`` runs the same comparisons at the main path's full
shapes. Kernels are built with --fmad=false in the plain versions'
operation order, so the comparisons are exact (tolerance 0), but for the
Rayleigh kernel's, which sums its pairs in another order than the plain
version's complex matrix product (within 2e-5 of the peak |p|); the CPU
tests hold the plain versions to the JAX package. The rigid registration (plain
PyTorch, no kernel of its own) is held on the card to its CPU run at the
bands of its JAX parity test. This file imports nothing of the JAX
package, so it runs where JAX is not installed.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from babelbrain_tpu_torch import probes as P
from babelbrain_tpu_torch.materials import (
    build_thermal_material_list,
    material_array,
)
from babelbrain_tpu_torch.ops import _build
from babelbrain_tpu_torch.ops import bhte as B
from babelbrain_tpu_torch.ops import bhte_kernels
from babelbrain_tpu_torch.ops import fdtd as F
from babelbrain_tpu_torch.ops import fdtd_extras as E
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_sources as S
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V
from babelbrain_tpu_torch.ops import rayleigh as R

pytestmark = pytest.mark.cuda

F0 = 500e3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


# Grids for the FDTD kernels' tiling (TILE_Z x TILE_Y columns a block,
# segments of x-planes), with the plane source's z: the grid of the other
# tests; N3 and N2 off the tile sizes, N1 = 27 < 2 ns (the lo and hi x-CPML
# slabs overlap inside a segment) and the plane on a z-tile edge; N1 = 37,
# which no segment length divides, and the plane on the other side of it.
VISCO_GRIDS = [((36, 40, 56), 13), ((27, 45, 47), K.TILE_Z),
               ((37, 41, 57), K.TILE_Z - 1)]


def _tile_corner(shape, geometry=V.visco_launch_geometry):
    """A cell on a (y, z) tile corner at the first plane of the second
    x-segment of a family's launch geometry."""
    geo = geometry(shape)
    return (geo.segment, geo.tile_y, K.TILE_Z)


# the material count of a 16-bit HU quantisation (65536 levels + water, skin
# and brain): a 1.5 MB table, beyond the 227 KB of shared memory a block may
# hold on an H100 (the fluid kernels gather it through __ldg)
LARGE_TABLE = 65539


def _fluid_setup(device, shape=(36, 40, 56), viscous=True,
                 source_type="velocity_plane", zsrc=13,
                 source_ijk=(17, 21, 34), reflector=False, n_mat=2):
    """Water with a bone slab along z (``n_mat`` > 2: a slab of random
    materials of increasing speed), a plane or point source; with
    ``reflector`` an air pocket in the slab (reflector twins)."""
    mats = np.array([[1000.0, 1500.0, 0, 0, 0]] + [
        [1900.0, c, 0, 80.0 if viscous else 0.0, 0]
        for c in np.linspace(2200.0, 2800.0, n_mat - 1)])
    dx = 1500.0 / F0 / 6
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, 2800.0, 0.5)))
    dt = 1 / F0 / ppp
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=60, frequency=F0,
                      sensor_start=40, source_plane_z=zsrc,
                      source_type=source_type, source_ijk=source_ijk)
    idx = np.zeros(shape, np.int32)
    idx[:, :, 24:30] = 1
    if n_mat > 2:  # random materials, and the last 64 of the table
        slab = np.random.default_rng(1).integers(1, n_mat,
                                                 (shape[0], shape[1], 6))
        slab.reshape(-1)[:64] = np.arange(n_mat - 64, n_mat)
        idx[:, :, 24:30] = slab
    refl = None
    if reflector:
        refl = np.zeros(shape, bool)
        refl[14:22, 14:22, 26:29] = True
    coefs = F.sls_coefficients(mats, F0, dt)
    mi, table = F._build_indexed_materials(coefs, idx, refl)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, 2800.0, 1e-5)
    amp = np.zeros(shape[:2])
    if source_type == "velocity_plane":
        amp[6:-6, 6:-6] = 60e3
    ph = np.random.default_rng(0).uniform(-1, 1, shape[:2])
    co = F.make_fluid_coeffs(mi, table, prof, amp, ph, grid, coefs["viscous"],
                             device)
    return grid, co


def _fluid_run_matches_plain(cuda, grid, co):
    """60 plane-source steps (20 in the DFT window) through the kernels and
    the plain versions: every field and psi slab bit-equal."""
    oz = 1.0 / (1000.0 * 1500.0)
    st_k = K.FluidState.zeros(grid.shape, 14, cuda)
    st_p = K.FluidState.zeros(grid.shape, 14, cuda)
    before = dict(K.launches)
    for n in range(grid.n_steps):
        F.fluid_step(st_k, co, grid, n, oz)
        s_sin, s_cos, cosw, sinw, _ = F.step_scalars(grid, n, oz)
        K.fluid_velocity_ref(st_p, co, s_sin, s_cos)
        if n >= grid.sensor_start:
            K.fluid_pressure_ref(st_p, co, cosw, sinw)
        else:
            K.fluid_pressure_ref(st_p, co)
    torch.cuda.synchronize()
    assert K.launches["fluid_velocity"] - before["fluid_velocity"] == 60
    assert K.launches["fluid_pressure"] - before["fluid_pressure"] == 40
    assert K.launches["fluid_pressure_dft"] - before["fluid_pressure_dft"] == 20
    assert float(st_p.p.abs().max()) > 0
    _fields_equal(st_k, st_p, ("p", "vx", "vy", "vz", "r", "acc_cos",
                               "acc_sin", "peak"), ("psi_p", "psi_v"))
    return st_p


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS)
@pytest.mark.parametrize("viscous", [True, False])
def test_fluid_kernels_match_plain(cuda, viscous, shape, zsrc):
    """On the tiling's ragged grids (see ``VISCO_GRIDS``)."""
    grid, co = _fluid_setup(cuda, shape=shape, viscous=viscous, zsrc=zsrc)
    _fluid_run_matches_plain(cuda, grid, co)


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS[:2])
def test_fluid_kernels_match_plain_with_reflector_twins(cuda, shape, zsrc):
    grid, co = _fluid_setup(cuda, shape=shape, zsrc=zsrc, reflector=True)
    assert co.table.shape[1] == 4 and float(co.table[1, 2:].abs().max()) == 0
    st = _fluid_run_matches_plain(cuda, grid, co)
    air = co.mat_idx >= 2
    assert int(air.sum()) > 0 and float(st.p[air].abs().max()) == 0.0


@pytest.mark.parametrize("viscous", [True, False])
def test_fluid_kernels_match_plain_large_table(cuda, viscous):
    """A table beyond the shared memory a block may hold, gathered at
    indices above 65535."""
    grid, co = _fluid_setup(cuda, viscous=viscous, n_mat=LARGE_TABLE)
    assert 4 * co.table.shape[1] > 232448  # one row beyond 227 KB
    assert int(co.mat_idx.max()) > 65535
    _fluid_run_matches_plain(cuda, grid, co)


# the fused sweep's cases: (K, source, viscous, with the DFT, x_lo, x_hi),
# on the tiling's ragged grids; the x-slab flags as a shard's launch sets
# them (one global edge, or none)
FUSED_CASES = (
    [(k, src, True, dft, True, True) for k in (1, 2, 3, 4, 8)
     for src in ("velocity_plane", "stress_point") for dft in (False, True)]
    + [(k, "velocity_plane", False, dft, True, True) for k in (1, 3)
       for dft in (False, True)]
    + [(3, "velocity_plane", True, True, lo, hi)
       for lo, hi in ((True, False), (False, True), (False, False))])


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS[1:])
@pytest.mark.parametrize("k,source,viscous,dft,x_lo,x_hi", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda, k, source, viscous, dft, x_lo,
                                    x_hi, shape, zsrc):
    """``fluid_fused`` (K steps a launch) against its plain version and
    against K steps of the pair, every field and psi slab bit-equal, from
    the state 20 pair steps leave; a stress point on a (y, z) tile corner."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    grid, co = _fluid_setup(cuda, shape=shape, viscous=viscous,
                            source_type=source, zsrc=zsrc,
                            source_ijk=(shape[0] // 2, K.TILE_Y, K.TILE_Z))
    co.x_lo, co.x_hi = x_lo, x_hi
    oz = 1.0 / (1000.0 * 1500.0)
    pamp = 60e3 if source == "stress_point" else 0.0
    st = K.FluidState.zeros(grid.shape, 14, cuda)
    for n in range(20):
        F.fluid_step(st, co, grid, n, oz, pamp)
    fused, plain, pair = (_copy(st) for _ in range(3))
    pt = F.point_index(grid)
    rows = [F.step_scalars(grid, n, oz, pamp) for n in range(20, 20 + k)]
    before = dict(FK.launches)
    FK.fluid_fused(fused, co, rows, pt, with_dft=dft)
    FK.fluid_fused_ref(plain, co, rows, pt, with_dft=dft)
    for s_sin, s_cos, cosw, sinw, s_pt in rows:
        K.fluid_velocity(pair, co, s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        if dft:
            K.fluid_pressure(pair, co, cosw, sinw, point)
        else:
            K.fluid_pressure(pair, co, point=point)
    torch.cuda.synchronize()
    key = K.pressure_key("fluid_fused", dft, pt)
    assert FK.launches[key] - before[key] == 1
    assert float(fused.p.abs().max()) > 0
    fields = ("p", "vx", "vy", "vz", "r", "acc_cos", "acc_sin", "peak")
    _fields_equal(fused, plain, fields, ("psi_p", "psi_v"))
    _fields_equal(fused, pair, fields, ("psi_p", "psi_v"))


def test_fused_run_fdtd_matches_the_pair(cuda):
    """``run_fdtd`` through the fused sweeps by default (its schedule's
    K-step, 2-step and tail steps) equals the pair step by step."""
    grid, co = _fluid_setup(cuda)
    idx = co.mat_idx.cpu().numpy()
    mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1900.0, 2200.0, 0, 80.0, 0]])
    amp = np.zeros(grid.shape[:2])
    amp[6:-6, 6:-6] = 60e3
    ph = np.random.default_rng(0).uniform(-1, 1, grid.shape[:2])
    out = F.run_fdtd(idx, mats, grid, amp, ph, device="cuda")
    step, st, co2, oz, _ = F.fdtd_setup(idx, mats, grid, amp, ph,
                                        device="cuda")
    F._time_loop([(step, st, co2, None, None)], grid, oz)
    ref = F._carrier(st, grid)
    for name in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


def _handover_monitors(shape):
    """Monitor voxels where the extras sweep's stages and warps meet: the
    planes where stage s + 1 follows stage s (0, 1, LAG - 1, LAG, LAG + 1,
    the last two) on (y, z) tile corners and at the centre, four repeated."""
    from babelbrain_tpu_torch.ops.fdtd_fused_kernels import LAG

    n1, n2, n3 = shape
    planes = sorted({0, 1, LAG - 1, LAG, LAG + 1, n1 - 2, n1 - 1})
    ijk = [[i, j, k] for i in planes for j in sorted({0, K.TILE_Y - 1,
                                                      K.TILE_Y, n2 - 1})
           for k in sorted({0, K.TILE_Z - 1, K.TILE_Z, n3 - 1})]
    ijk += [[i, n2 // 2, n3 // 2] for i in planes]
    return np.array(ijk + [ijk[0], ijk[5], ijk[5], ijk[-1]])


def _extras_sweep(cuda, shape, zsrc, k, source, viscous, maps, monitors):
    """One extras sweep of ``k`` window steps from the state 20 quiet pair
    steps leave (every step but the second sampled), its plain version and
    ``k`` steps of pair + extras + MONITOR: the three states and their
    ``Diagnostics``, and the launch counts the sweep added."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    grid, co = _fluid_setup(cuda, shape=shape, viscous=viscous,
                            source_type=source, zsrc=zsrc,
                            source_ijk=(shape[0] // 2, K.TILE_Y, K.TILE_Z))
    grid = dataclasses.replace(grid, sensor_start=20)
    oz = 1.0 / (1000.0 * 1500.0)
    pamp = 60e3 if source == "stress_point" else 0.0
    st = K.FluidState.zeros(grid.shape, 14, cuda)
    for n in range(20):
        F.fluid_step(st, co, grid, n, oz, pamp)
    states = [_copy(st) for _ in range(3)]
    index = (E.monitor_index(_handover_monitors(shape), shape, cuda)
             if monitors else None)
    sampled = [n for n in range(20, 20 + k) if n != 21] if monitors else ()
    diags = [E.Diagnostics.create(x, 20, maps, sample_steps=sampled,
                                  index=index, sweep=sweep)
             for x, sweep in zip(states, (True, True, False))]
    pt = F.point_index(grid)
    rows = [F.step_scalars(grid, n, oz, pamp) for n in range(20, 20 + k)]
    before = dict(FK.launches)
    for fn, x, d in zip((FK.fluid_fused, FK.fluid_fused_ref), states, diags):
        fn(x, co, rows, pt, with_dft=True, extras=d.extras,
           monitor=d.sweep_monitor(20, k))
    grew = {key: FK.launches[key] - before[key] for key in FK.launches}
    for n in range(20, 20 + k):
        F.fluid_step(states[2], co, grid, n, oz, pamp, None,
                     diags[2].monitor(n))
        diags[2].record(states[2], n)
    torch.cuda.synchronize()
    return states, diags, grew


def _extras_equal(states, diags, k):
    """The sweep's state, maps and series against its plain version's and
    the pair's, bit for bit."""
    fields = ("p", "vx", "vy", "vz", "r", "acc_cos", "acc_sin", "peak")
    maps = [d.extras.read(k) if d.extras is not None else {} for d in diags]
    for x, m, d in zip(states[1:], maps[1:], diags[1:]):
        _fields_equal(states[0], x, fields, ("psi_p", "psi_v"))
        assert set(m) == set(maps[0])
        for name, v in maps[0].items():
            np.testing.assert_array_equal(v, m[name], err_msg=name)
        if d.series is not None:
            torch.testing.assert_close(diags[0].series, d.series, rtol=0,
                                       atol=0)


# the extras sweep's cases: (K, source, viscous), on the ragged grids
EXTRAS_CASES = [(k, src, viscous) for k in (1, 2, 3, 4)
                for src in ("velocity_plane", "stress_point")
                for viscous in (True, False)]


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS[1:])
@pytest.mark.parametrize("k,source,viscous", EXTRAS_CASES)
def test_fused_extras_kernel_matches_plain(cuda, k, source, viscous, shape,
                                           zsrc):
    """The extras sweep (``fluid_fused`` with the Pressure_rms accumulator
    and monitors on the stages' hand-over planes and tile corners, some
    listed twice, one step not sampled) against its plain version and
    against K steps of pair + extras + MONITOR, bit for bit; Pressure_peak
    read from the carrier peak equals the pair's own map."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    states, diags, grew = _extras_sweep(
        cuda, shape, zsrc, k, source, viscous,
        ("Pressure_rms", "Pressure_peak"), True)
    key = FK.fused_key(True, 0 if source == "stress_point" else None, True)
    assert grew[key] == 1 and sum(grew.values()) == 1
    assert float(diags[0].series.abs().max()) > 0
    _extras_equal(states, diags, k)


@pytest.mark.parametrize("maps,monitors", [
    (("Pressure_rms", "Pressure_peak"), False), (("Pressure_peak",), True),
    ((), True)])
def test_fused_extras_maps_or_monitors_alone(cuda, maps, monitors):
    """Maps without monitors, the carrier peak alone (no p^2 sum) and
    monitors without maps, each through the same instantiation with a null
    pointer: bit for bit with the plain version and the pair."""
    states, diags, grew = _extras_sweep(cuda, (27, 45, 47), K.TILE_Z, 3,
                                        "velocity_plane", True, maps,
                                        monitors)
    assert grew["fluid_fused_extras_dft"] == 1
    _extras_equal(states, diags, 3)


@pytest.mark.parametrize("subsampling", [1, 3])
@pytest.mark.parametrize("source", ["velocity_plane", "stress_point"])
def test_fused_extras_run_fdtd_matches_the_pair(cuda, source, subsampling):
    """``run_fdtd`` with Pressure_rms / Pressure_peak and monitors through
    the extras sweeps (pinned at K = 3 and 4: a 20-step window, which
    neither divides) equals its pair route (``fuse_steps=0``) bit for bit."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    grid, co = _fluid_setup(cuda, source_type=source)
    idx = co.mat_idx.cpu().numpy()
    mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1900.0, 2200.0, 0, 80.0, 0]])
    amp = np.zeros(grid.shape[:2])
    amp[6:-6, 6:-6] = 60e3
    ph = np.random.default_rng(0).uniform(-1, 1, grid.shape[:2])
    kw = dict(sel_maps=("Pressure_rms", "Pressure_peak"),
              monitor_ijk=_handover_monitors(grid.shape),
              sensor_subsampling=subsampling, point_amp=60e3, device="cuda")
    ref = F.run_fdtd(idx, mats, grid, amp, ph, fuse_steps=0, **kw)
    point = F.point_index(grid)
    key = FK.fused_key(True, point, True)
    for k in (3, 4):
        plan = F.extras_plan(grid.shape, "cuda", True, point is not None, k)
        sweeps = sum(m >= 2 and dft for _, m, dft in
                     F.fused_schedule(grid, plan))
        before = FK.launches[key]
        out = F.run_fdtd(idx, mats, grid, amp, ph, fuse_steps=k, **kw)
        assert FK.launches[key] - before == sweeps > 0
        assert set(out) == set(ref)
        for name, v in ref.items():
            np.testing.assert_array_equal(out[name], v, err_msg=name)


def test_fused_extras_refuses_the_quiet_phase_and_shards(cuda):
    """An extras sweep outside the window or on a shard raises."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    grid, co = _fluid_setup(cuda)
    st = K.FluidState.zeros(grid.shape, 14, cuda)
    ex = E.Extras.zeros(("Pressure_rms",), grid.shape, cuda, False)
    rows = [F.step_scalars(grid, 20, 1.0)]
    with pytest.raises(ValueError, match="window"):
        FK.fluid_fused(st, co, rows, with_dft=False, extras=ex)
    co.x_hi = False
    with pytest.raises(ValueError, match="whole grid"):
        FK.fluid_fused(st, co, rows, with_dft=True, extras=ex)


# the halo sweep's cases: (K, volumetric drive, viscous, with the DFT,
# x_lo, x_hi), on the tiling's ragged grids
HALO_CASES = (
    [(k, vol, True, dft, True, True) for k in (1, 2, 3)
     for vol in (True, False) for dft in (False, True)]
    + [(k, True, False, dft, True, True) for k in (1, 3)
       for dft in (False, True)]
    + [(2, True, True, True, lo, hi)
       for lo, hi in ((True, False), (False, True), (False, False))])


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS)
@pytest.mark.parametrize("k,volume,viscous,dft,x_lo,x_hi", HALO_CASES)
def test_halo_kernel_matches_plain(cuda, k, volume, viscous, dft, x_lo, x_hi,
                                   shape, zsrc):
    """``fluid_halo`` (K steps a launch in halo-recomputing blocks) against
    its plain version and against K steps of pair + scatter, every field
    and psi slab bit-equal, from the state 20 steps leave; a shell of
    source voxels (or the plane), the input state left unchanged but for
    the swap."""
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK

    grid, co = _fluid_setup(cuda, shape=shape, viscous=viscous, zsrc=zsrc)
    co.x_lo, co.x_hi = x_lo, x_hi
    vsrc = _shell(grid.shape, cuda) if volume else None
    oz = 1.0 / (1000.0 * 1500.0)
    st = K.FluidState.zeros(grid.shape, 14, cuda)
    for n in range(20):
        F.fluid_step(st, co, grid, n, oz, 0.0, vsrc)
    halo, plain, pair = (_copy(st) for _ in range(3))
    rows = [F.step_scalars(grid, n, oz) for n in range(20, 20 + k)]
    before = dict(HK.launches)
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
    torch.cuda.synchronize()
    key = HK.halo_key(volume, dft)
    assert HK.launches[key] - before[key] == 1
    assert float(halo.p.abs().max()) > 0
    fields = ("p", "vx", "vy", "vz", "r", "acc_cos", "acc_sin", "peak")
    _fields_equal(halo, plain, fields, ("psi_p", "psi_v"))
    _fields_equal(halo, pair, fields, ("psi_p", "psi_v"))
    HK.release()


@pytest.mark.parametrize("k", [2, 3])
def test_halo_run_fdtd_matches_pair_and_scatter(cuda, k):
    """``run_fdtd`` with a volumetric source and ``fuse_steps=k`` (K-step
    halo sweeps, then pair + scatter) equals pair + scatter step by step."""
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK

    grid, co = _fluid_setup(cuda, source_type="velocity_volume")
    idx = co.mat_idx.cpu().numpy()
    mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1900.0, 2200.0, 0, 80.0, 0]])
    vsrc = _shell(grid.shape, cuda)
    before = dict(HK.launches)
    out = F.run_fdtd(idx, mats, grid, volume_source=vsrc, fuse_steps=k,
                     device="cuda")
    assert HK.launches["fluid_halo_volume"] > before["fluid_halo_volume"]
    step, st, co2, oz, vs = F.fdtd_setup(idx, mats, grid, volume_source=vsrc,
                                         device="cuda")
    F._time_loop([(step, st, co2, vs, None)], grid, oz)
    ref = F._carrier(st, grid)
    for name in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


def test_halo_entry_point_refuses_aliasing(cuda):
    """The C entry point refuses an output state that aliases its input
    (neighbouring blocks read the input's halo cells)."""
    from babelbrain_tpu_torch.ops import fdtd_halo_kernels as HK

    grid, co = _fluid_setup(cuda)
    st = K.FluidState.zeros(grid.shape, 14, cuda)
    HK.fluid_halo(st, co, [F.step_scalars(grid, 0, 1.0)])  # builds the twin
    twin, _ = HK._twin(st, 1)
    saved = twin.p
    twin.p = st.p
    try:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            HK.fluid_halo(st, co, [F.step_scalars(grid, 1, 1.0)])
    finally:
        twin.p = saved
        HK.release()


def test_fused_wrapper_rejects_mixed_devices(cuda):
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    grid, co = _fluid_setup(cuda)
    st = K.FluidState.zeros(grid.shape, 14, "cpu")
    with pytest.raises(ValueError, match="float32 on"):
        FK.fluid_fused(st, co, [F.step_scalars(grid, 0, 1.0)])


def test_fluid_wrapper_rejects_mixed_devices(cuda):
    grid, co = _fluid_setup(cuda)
    st = K.FluidState.zeros(grid.shape, 14, "cpu")
    with pytest.raises(ValueError, match="float32 on"):
        K.fluid_velocity(st, co, 0.0, 0.0)


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS)
@pytest.mark.parametrize("viscous,reflector", [(True, False), (True, True),
                                               (False, False)])
def test_visco_kernels_match_plain(cuda, viscous, reflector, shape, zsrc):
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    if not viscous:
        mats[:, 3:] = 0.0
    dx = 1102.5 / F0 / 6
    cmax = mats[:, 1].max()
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, 0.5)))
    dt = 1 / F0 / ppp
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=60, frequency=F0,
                      sensor_start=40, source_plane_z=zsrc)
    idx = np.zeros(shape, np.uint8)
    for label, (z0, z1) in {1: (18, 22), 2: (22, 25), 3: (25, 30),
                            4: (33, shape[2])}.items():
        idx[:, :, z0:z1] = label
    idx[:, :, 30:33] = 2
    refl = None
    if reflector:
        refl = np.zeros(shape, bool)
        refl[14:22, 14:22, 26:29] = True
    coefs = F.sls_coefficients(mats, F0, dt)
    mi, table = F._build_indexed_materials(coefs, idx, refl)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, cmax, 1e-5)
    amp = np.zeros(shape[:2])
    amp[6:-6, 6:-6] = 60e3
    ph = np.random.default_rng(0).uniform(-1, 1, shape[:2])
    co = F.make_visco_coeffs(mi, table, prof, amp, ph, grid, coefs["viscous"],
                             cuda)
    oz = 1.0 / (1000.0 * 1500.0)
    st_k = V.ViscoState.zeros(shape, 14, cuda)
    st_p = V.ViscoState.zeros(shape, 14, cuda)
    before = dict(V.launches)
    for n in range(grid.n_steps):
        F.visco_step(st_k, co, grid, n, oz)
        s_sin, s_cos, cosw, sinw, _ = F.step_scalars(grid, n, oz)
        V.visco_velocity_ref(st_p, co, s_sin, s_cos)
        if n >= grid.sensor_start:
            V.visco_stress_ref(st_p, co, cosw, sinw)
        else:
            V.visco_stress_ref(st_p, co)
    torch.cuda.synchronize()
    assert V.launches["visco_velocity"] - before["visco_velocity"] == 60
    assert V.launches["visco_stress"] - before["visco_stress"] == 40
    assert V.launches["visco_stress_dft"] - before["visco_stress_dft"] == 20
    assert float(st_p.peak.max()) > 0
    names = ("vx", "vy", "vz") + V.STRESSES + V.MEMORIES + (
        "acc_cos", "acc_sin", "peak")
    for name in names:
        torch.testing.assert_close(getattr(st_k, name), getattr(st_p, name),
                                   rtol=0, atol=0, msg=name)
    for a, b in zip(st_k.psi_s + st_k.psi_v, st_p.psi_s + st_p.psi_v):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_visco_entry_points_refuse_a_grid_off_the_volume(cuda, monkeypatch):
    """The kernels launch the grid the wrapper passes; one that leaves cells
    out or holds a block without a cell is refused before any launch."""
    shape = (27, 45, 47)
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    dx = 1102.5 / F0 / 6
    cmax = mats[:, 1].max()
    dt = 1 / F0 / int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, 0.5)))
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=10, frequency=F0,
                      sensor_start=5, source_plane_z=13)
    coefs = F.sls_coefficients(mats, F0, dt)
    mi, table = F._build_indexed_materials(coefs, np.zeros(shape, np.uint8),
                                           None)
    prof = F._build_cpml_profiles_np(shape, 12, dx, dt, cmax, 1e-5)
    plane = np.zeros(shape[:2])
    co = F.make_visco_coeffs(mi, table, prof, plane, plane, grid,
                             coefs["viscous"], cuda)
    st = V.ViscoState.zeros(shape, 14, cuda)
    good = V.visco_launch_geometry(shape)
    nz, ny, nx = good.grid
    before = dict(V.launches)
    for bad in ((nz, ny, nx - 1), (nz, ny - 1, nx), (nz + 1, ny, nx),
                (nz, ny, nx + 1)):
        geo = V.LaunchGeometry(good.tile_y, good.segment, bad)
        monkeypatch.setattr(V, "visco_launch_geometry", lambda s, g=geo: g)
        with pytest.raises(RuntimeError, match="cudaError"):
            V.visco_velocity(st, co, 0.0, 0.0)
        with pytest.raises(RuntimeError, match="cudaError"):
            V.visco_stress(st, co)
    assert V.launches == before


def _shell(shape, device):
    """A hemispherical shell of source voxels (radius ~0.3 of the grid)
    with random phases and inward normals, as a ``VolumeSource``."""
    c = [n / 2.0 for n in shape]
    ii, jj, kk = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    r = np.sqrt((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2)
    r0 = 0.3 * min(shape)
    shell = (r > r0 - 1) & (r < r0 + 1) & (kk < c[2])
    rr = np.maximum(r, 1e-6)
    rng = np.random.default_rng(4)
    return S.VolumeSource.from_dense(dict(
        amp=np.where(shell, 60e3, 0.0), phase=rng.uniform(-2, 2, shape),
        ox=(c[0] - ii) / rr, oy=(c[1] - jj) / rr, oz=(c[2] - kk) / rr,
    ), shape, device)


def _copy(st):
    """A copy of a fluid or visco state (every tensor and psi slab)."""
    return type(st)(**{k: (v.clone() if torch.is_tensor(v)
                           else [t.clone() for t in v])
                       for k, v in vars(st).items()})


def _fields_equal(st_k, st_p, names, psi):
    for name in names:
        torch.testing.assert_close(getattr(st_k, name), getattr(st_p, name),
                                   rtol=0, atol=0, msg=name)
    for a, b in zip(*(sum((getattr(st, f) for f in psi), [])
                      for st in (st_k, st_p))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(36, 40, 56), (27, 45, 47),
                                   (37, 41, 57)])
@pytest.mark.parametrize("source", ["stress_point", "velocity_volume"])
def test_fluid_point_and_volume_kernels_match_plain(cuda, source, shape):
    """On the first grid the point sits inside a tile; on the ragged ones
    on a (y, z) tile corner at an x-segment boundary."""
    ijk = ((17, 21, 34) if shape == (36, 40, 56)
           else _tile_corner(shape, K.fluid_launch_geometry))
    grid, co = _fluid_setup(cuda, shape=shape, source_type=source,
                            source_ijk=ijk)
    vsrc = _shell(grid.shape, cuda) if source == "velocity_volume" else None
    pamp = 50e3 if source == "stress_point" else 0.0
    pt = F.point_index(grid)
    oz = 1.0 / (1000.0 * 1500.0)
    st_k = K.FluidState.zeros(grid.shape, 14, cuda)
    st_p = K.FluidState.zeros(grid.shape, 14, cuda)
    before = {**K.launches, **S.launches}
    for n in range(grid.n_steps):
        F.fluid_step(st_k, co, grid, n, oz, pamp, vsrc)
        s_sin, s_cos, cosw, sinw, s_pt = F.step_scalars(grid, n, oz, pamp)
        K.fluid_velocity_ref(st_p, co, s_sin, s_cos)
        if vsrc is not None:
            S.velocity_volume_source_ref(st_p.vx, st_p.vy, st_p.vz, vsrc,
                                         s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        if n >= grid.sensor_start:
            K.fluid_pressure_ref(st_p, co, cosw, sinw, point)
        else:
            K.fluid_pressure_ref(st_p, co, point=point)
    torch.cuda.synchronize()
    after = {**K.launches, **S.launches}
    grew = {k: after[k] - before[k] for k in after}
    if source == "stress_point":
        assert grew["fluid_pressure_point"] == 40
        assert grew["fluid_pressure_point_dft"] == 20
        assert grew["volume_source"] == 0
    else:
        assert grew["volume_source"] == 60 and grew["fluid_pressure"] == 40
    assert float(st_p.p.abs().max()) > 0
    _fields_equal(st_k, st_p, ("p", "vx", "vy", "vz", "r", "acc_cos",
                               "acc_sin", "peak"), ("psi_p", "psi_v"))


@pytest.mark.parametrize("shape", [(36, 40, 56), (27, 45, 47),
                                   (37, 41, 57)])
@pytest.mark.parametrize("source", ["stress_point", "velocity_volume"])
def test_visco_point_and_volume_kernels_match_plain(cuda, source, shape):
    """On the first grid the point sits inside a tile; on the ragged ones
    on a (y, z) tile corner at an x-segment boundary."""
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    dx = 1102.5 / F0 / 6
    cmax = mats[:, 1].max()
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, 0.5)))
    ijk = (17, 21, 40) if shape == (36, 40, 56) else _tile_corner(shape)
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=60,
                      frequency=F0, sensor_start=40, source_type=source,
                      source_ijk=ijk)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 25:32] = 2
    coefs = F.sls_coefficients(mats, F0, grid.dt)
    mi, table = F._build_indexed_materials(coefs, idx, None)
    prof = F._build_cpml_profiles_np(shape, 12, dx, grid.dt, cmax, 1e-5)
    z2 = np.zeros(shape[:2])
    co = F.make_visco_coeffs(mi, table, prof, z2, z2, grid, coefs["viscous"],
                             cuda)
    vsrc = _shell(shape, cuda) if source == "velocity_volume" else None
    pamp = 50e3 if source == "stress_point" else 0.0
    pt = F.point_index(grid)
    oz = 1.0 / (1000.0 * 1500.0)
    st_k = V.ViscoState.zeros(shape, 14, cuda)
    st_p = V.ViscoState.zeros(shape, 14, cuda)
    before = {**V.launches, **S.launches}
    for n in range(grid.n_steps):
        F.visco_step(st_k, co, grid, n, oz, pamp, vsrc)
        s_sin, s_cos, cosw, sinw, s_pt = F.step_scalars(grid, n, oz, pamp)
        V.visco_velocity_ref(st_p, co, s_sin, s_cos)
        if vsrc is not None:
            S.velocity_volume_source_ref(st_p.vx, st_p.vy, st_p.vz, vsrc,
                                         s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        if n >= grid.sensor_start:
            V.visco_stress_ref(st_p, co, cosw, sinw, point)
        else:
            V.visco_stress_ref(st_p, co, point=point)
    torch.cuda.synchronize()
    after = {**V.launches, **S.launches}
    grew = {k: after[k] - before[k] for k in after}
    if source == "stress_point":
        assert grew["visco_stress_point"] == 40
        assert grew["visco_stress_point_dft"] == 20
    else:
        assert grew["volume_source"] == 60 and grew["visco_stress"] == 40
    assert float(st_p.peak.max()) > 0
    _fields_equal(st_k, st_p, ("vx", "vy", "vz") + V.STRESSES + V.MEMORIES
                  + ("acc_cos", "acc_sin", "peak"), ("psi_s", "psi_v"))


def test_volume_source_wrapper_rejects_mixed_devices(cuda):
    vs = _shell((20, 20, 20), "cpu")
    v = [torch.zeros((20, 20, 20), device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="int32 index"):
        S.velocity_volume_source(*v, vs, 0.0, 0.0)


def test_bhte_kernel_matches_plain(cuda):
    shape = (30, 34, 40)
    acoustic = material_array(500e3, tissues=("Water", "Skin", "Cortical",
                                              "Trabecular", "Brain"))
    mats = build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 10:14] = 1
    idx[:, :, 14:20] = 2
    idx[:, :, 20:] = 4
    p = np.zeros(shape, np.float32)
    p[10:20, 12:22, 24:32] = 1.2e7
    co = B.make_bhte_coeffs(B._build_coeff_maps(idx, mats, 5e-4, 0.01), cuda)
    q = torch.as_tensor(B.absorption_heating(p, idx, mats, 0.5), device=cuda)
    T0 = torch.full(shape, 37.0, device=cuda)
    states = []
    before = bhte_kernels.launches["bhte_step"]
    for step in (bhte_kernels.bhte_step, None):
        T, dose = T0.clone(), torch.zeros_like(T0)
        peak = torch.full_like(T0, -1e9)
        for n in range(60):
            qn = q if n < 40 else None
            if step is None:
                T = bhte_kernels.bhte_step_ref(T, dose, peak, co, qn, 37.0,
                                               torch.empty_like(T))
            else:
                T = step(T, dose, peak, co, qn, 37.0)
        states.append((T, dose, peak))
    torch.cuda.synchronize()
    assert bhte_kernels.launches["bhte_step"] - before == 60
    assert float(states[1][2].max()) > 43.0  # both dose branches exercised
    for a, b in zip(*states):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _bhte_schedule_case():
    """Two heat maps on the layers of ``test_bhte_kernel_matches_plain``."""
    shape = (30, 34, 40)
    acoustic = material_array(500e3, tissues=("Water", "Skin", "Cortical",
                                              "Trabecular", "Brain"))
    mats = build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 10:14] = 1
    idx[:, :, 14:20] = 2
    idx[:, :, 20:] = 4
    p = np.zeros((2,) + shape, np.float32)
    p[0, 10:20, 12:22, 24:32] = 1.2e7
    p[1, 14:24, 8:18, 22:30] = 1.0e7
    return p, idx, mats


# on/off with two fields and odd segment lengths
BHTE_SCHEDULE = [(0, 11, True), (-1, 7, False), (1, 9, True), (0, 13, False),
                 (0, 8, True), (1, 4, True)]


def test_bhte_schedule_matches_plain(cuda, monkeypatch):
    """``bhte_run(fuse_steps=1)`` over an on/off, two-field schedule on the
    card equals the same schedule through the plain step on the card bit
    for bit (temperature, peak, dose and the monitor series), with one
    launch a step."""
    p, idx, mats = _bhte_schedule_case()
    kw = dict(dt=0.01, duty_cycle=0.5, device=cuda, fuse_steps=1,
              monitor_points=[(15, 17, 28), (3, 4, 5), (29, 33, 39)],
              initial_temperature=np.full(idx.shape, 37.5, np.float32))
    n_steps = sum(n for _, n, _ in BHTE_SCHEDULE)
    before = bhte_kernels.launches["bhte_step"]
    kernel = B.bhte_run(p, idx, mats, 5e-4, BHTE_SCHEDULE, **kw)
    assert bhte_kernels.launches["bhte_step"] - before == n_steps
    monkeypatch.setattr(B, "bhte_step", bhte_kernels.bhte_step_ref)
    plain = B.bhte_run(p, idx, mats, 5e-4, BHTE_SCHEDULE, **kw)
    assert kernel.peak_temperature.max() > 43.0  # both dose branches
    for name in ("temperature", "peak_temperature", "dose", "monitor"):
        np.testing.assert_array_equal(getattr(kernel, name),
                                      getattr(plain, name), err_msg=name)
    assert kernel.monitor.shape == (3, n_steps)


@pytest.mark.parametrize("with_q", [True, False])
@pytest.mark.parametrize("k", range(1, bhte_kernels.BHTE_K_CAP + 1))
@pytest.mark.parametrize("shape", [(27, 45, 47), (64, 64, 80)])
def test_bhte_fused_matches_plain(cuda, shape, k, with_q):
    """``bhte_fused`` (K steps a launch) against its plain version and
    against K launches of ``bhte_step``, bit for bit in T, dose and peak,
    over three sweeps from a start that straddles 43 C (a ragged grid and
    one whose tiles and segments divide it unevenly)."""
    rng = np.random.default_rng(k)
    acoustic = material_array(500e3, tissues=("Water", "Skin", "Cortical",
                                              "Trabecular", "Brain"))
    mats = build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    idx = rng.integers(0, 5, shape).astype(np.uint8)
    co = B.make_bhte_coeffs(B._build_coeff_maps(idx, mats, 5e-4, 0.01), cuda)
    q = torch.as_tensor((rng.random(shape) * 4e6).astype(np.float32),
                        device=cuda) if with_q else None
    T0 = torch.as_tensor((37.0 + 9.0 * rng.random(shape)).astype(np.float32),
                         device=cuda)
    states = []
    before = dict(bhte_kernels.launches)
    for how in ("kernel", "plain", "steps"):
        T, dose = T0.clone(), torch.zeros_like(T0)
        peak = torch.full_like(T0, -1e9)
        for _ in range(3):
            if how == "steps":
                for _ in range(k):
                    T = bhte_kernels.bhte_step(T, dose, peak, co, q, 37.0)
            elif how == "kernel":
                T = bhte_kernels.bhte_fused(T, dose, peak, co, q, 37.0, k)
            else:
                T = bhte_kernels.bhte_fused_ref(T, dose, peak, co, q, 37.0, k,
                                                torch.empty_like(T))
        states.append((T, dose, peak))
    torch.cuda.synchronize()
    assert bhte_kernels.launches["bhte_fused"] - before["bhte_fused"] == 3
    assert bhte_kernels.launches["bhte_step"] - before["bhte_step"] == 3 * k
    assert float(states[0][2].min()) < 43.0 < float(states[0][2].max())
    for other in states[1:]:
        for a, b in zip(states[0], other):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bhte_fused_tile_matches_the_kernel(cuda, monkeypatch):
    """The launch geometry's tile is the built kernel's ``FusedTile<K>`` at
    every depth, and a wrapper whose tile drifted from it refuses to launch,
    naming both."""
    for k in range(1, bhte_kernels.BHTE_K_CAP + 1):
        tz, ty = ctypes.c_int(0), ctypes.c_int(0)
        rc = _build.library().bb_bhte_fused_tile(k, ctypes.byref(tz),
                                                 ctypes.byref(ty))
        assert rc == 0
        assert (tz.value, ty.value) == (bhte_kernels.FUSED_TILE_Z,
                                        bhte_kernels.fused_tile_y(k))
    T = torch.full((6, 20, 40), 37.0, device=cuda)
    co = bhte_kernels.BHTECoeffs([torch.zeros_like(T) for _ in range(6)],
                                 torch.zeros_like(T), torch.zeros_like(T))
    monkeypatch.setattr(bhte_kernels, "fused_tile_y", lambda k: 7)
    with pytest.raises(RuntimeError, match=r"FusedTile<2>.*fused_tile_y"):
        bhte_kernels.bhte_fused(T, torch.zeros_like(T), torch.zeros_like(T),
                                co, None, 37.0, 2)


def test_bhte_run_sweeps_on_the_card(cuda):
    """``bhte_run()`` on the card runs ``BHTE_FUSE_BEST``-step sweeps (and
    one-step tails), bit-equal to ``fuse_steps=1`` in temperature, peak and
    dose, the monitors equal at the sampled steps."""
    p, idx, mats = _bhte_schedule_case()
    kw = dict(dt=0.01, duty_cycle=0.5, device=cuda,
              monitor_points=[(15, 17, 28), (3, 4, 5), (29, 33, 39)],
              initial_temperature=np.full(idx.shape, 37.5, np.float32))
    k = bhte_kernels.BHTE_FUSE_BEST
    before = dict(bhte_kernels.launches)
    fused = B.bhte_run(p, idx, mats, 5e-4, BHTE_SCHEDULE, **kw)
    grew = {n: bhte_kernels.launches[n] - before[n] for n in before}
    assert grew == B.schedule_launches(BHTE_SCHEDULE, k)
    assert grew["bhte_fused"] > 0 and grew["bhte_step"] > 0
    one = B.bhte_run(p, idx, mats, 5e-4, BHTE_SCHEDULE, fuse_steps=1, **kw)
    for name in ("temperature", "peak_temperature", "dose"):
        np.testing.assert_array_equal(getattr(fused, name), getattr(one, name),
                                      err_msg=name)
    np.testing.assert_array_equal(fused.monitor_steps,
                                  B.monitor_steps(BHTE_SCHEDULE, k))
    np.testing.assert_array_equal(fused.monitor,
                                  one.monitor[:, fused.monitor_steps])
    assert fused.peak_temperature.max() > 43.0


def _visco_setup(device, shape=(36, 40, 56)):
    """Label-mode layers along z with a plane source (as in
    ``test_visco_kernels_match_plain``)."""
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    dx = 1102.5 / F0 / 6
    cmax = mats[:, 1].max()
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, 0.5)))
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=60,
                      frequency=F0, sensor_start=40, source_plane_z=13)
    idx = np.zeros(shape, np.uint8)
    for label, (z0, z1) in {1: (18, 22), 2: (22, 25), 3: (25, 30),
                            4: (33, 56)}.items():
        idx[:, :, z0:z1] = label
    coefs = F.sls_coefficients(mats, F0, grid.dt)
    mi, table = F._build_indexed_materials(coefs, idx, None)
    prof = F._build_cpml_profiles_np(shape, 12, dx, grid.dt, cmax, 1e-5)
    amp = np.zeros(shape[:2])
    amp[6:-6, 6:-6] = 60e3
    ph = np.random.default_rng(0).uniform(-1, 1, shape[:2])
    co = F.make_visco_coeffs(mi, table, prof, amp, ph, grid, coefs["viscous"],
                             device)
    return grid, co


# the visco sweep's cases: (K, source, viscous, with the DFT, x_lo, x_hi)
# on the tiling's ragged grids, as FUSED_CASES for the fluid sweep
VISCO_FUSED_CASES = (
    [(k, src, True, dft, True, True) for k in range(1, 5)
     for src in ("velocity_plane", "stress_point") for dft in (False, True)]
    + [(k, "velocity_plane", False, True, True, True) for k in (2, 4)]
    + [(2, "velocity_plane", True, True, lo, hi)
       for lo, hi in ((True, False), (False, True), (False, False))])


@pytest.mark.parametrize("shape,zsrc", VISCO_GRIDS[1:])
@pytest.mark.parametrize("k,source,viscous,dft,x_lo,x_hi", VISCO_FUSED_CASES)
def test_visco_fused_kernel_matches_plain(cuda, k, source, viscous, dft,
                                          x_lo, x_hi, shape, zsrc):
    """``visco_fused`` (K steps a launch) against its plain version and
    against K steps of the visco pair, every field and psi slab bit-equal,
    from the state 20 pair steps leave; a stress point on a (y, z) tile
    corner."""
    import dataclasses

    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF

    grid, co = _visco_setup(cuda, shape)
    grid = dataclasses.replace(grid, source_plane_z=zsrc, source_type=source,
                               source_ijk=(shape[0] // 2, K.TILE_Y, K.TILE_Z))
    co.zsrc = zsrc
    co.x_lo, co.x_hi = x_lo, x_hi
    co.viscous = co.viscous and viscous
    oz = 1.0 / (1000.0 * 1500.0)
    pamp = 60e3 if source == "stress_point" else 0.0
    st = V.ViscoState.zeros(grid.shape, 14, cuda)
    for n in range(20):
        F.visco_step(st, co, grid, n, oz, pamp)
    fused, plain, pair = (_copy(st) for _ in range(3))
    pt = F.point_index(grid)
    rows = [F.step_scalars(grid, n, oz, pamp) for n in range(20, 20 + k)]
    before = dict(VF.launches)
    VF.visco_fused(fused, co, rows, pt, with_dft=dft)
    VF.visco_fused_ref(plain, co, rows, pt, with_dft=dft)
    for s_sin, s_cos, cosw, sinw, s_pt in rows:
        V.visco_velocity(pair, co, s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        if dft:
            V.visco_stress(pair, co, cosw, sinw, point)
        else:
            V.visco_stress(pair, co, point=point)
    torch.cuda.synchronize()
    key = K.pressure_key("visco_fused", dft, pt)
    assert VF.launches[key] - before[key] == 1
    assert float(fused.sxx.abs().max()) > 0
    fields = (("vx", "vy", "vz") + V.STRESSES + V.MEMORIES
              + ("acc_cos", "acc_sin", "peak"))
    _fields_equal(fused, plain, fields, ("psi_s", "psi_v"))
    _fields_equal(fused, pair, fields, ("psi_s", "psi_v"))


@pytest.mark.parametrize("source", ["velocity_plane", "stress_point"])
def test_visco_fused_run_fdtd_matches_the_pair(cuda, source):
    """``run_fdtd`` in shear media through the visco sweeps by default (its
    schedule's sweeps, 2-step sweeps and tails) equals the pair step by
    step."""
    import dataclasses

    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF

    grid, co = _visco_setup(cuda)
    grid = dataclasses.replace(grid, n_steps=61, sensor_start=41,
                               source_type=source, source_ijk=(18, 20, 40))
    idx = co.mat_idx.cpu().numpy()
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    amp = np.zeros(grid.shape[:2])
    amp[6:-6, 6:-6] = 60e3
    ph = np.random.default_rng(0).uniform(-1, 1, grid.shape[:2])
    pamp = 60e3 if source == "stress_point" else 0.0
    before = sum(VF.launches.values())
    out = F.run_fdtd(idx, mats, grid, amp, ph, pamp, device="cuda")
    assert sum(VF.launches.values()) > before
    step, st, co2, oz, _ = F.fdtd_setup(idx, mats, grid, amp, ph,
                                        device="cuda")
    F._time_loop([(step, st, co2, None, None)], grid, oz, pamp)
    ref = F._carrier(st, grid)
    for name in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


# the visco halo sweep's cases: (K, viscous, with the DFT)
VISCO_HALO_CASES = [(k, viscous, dft) for k in (1, 2)
                    for viscous in (True, False) for dft in (False, True)]


@pytest.mark.parametrize("shape", [(36, 40, 56), (27, 45, 47),
                                   (37, 41, 57)])
@pytest.mark.parametrize("k,viscous,dft", VISCO_HALO_CASES)
def test_visco_halo_kernel_matches_plain(cuda, k, viscous, dft, shape):
    """``visco_halo`` (K visco steps a launch in halo-recomputing blocks,
    with the volumetric drive) against its plain version and against K
    steps of the visco pair + scatter, every field and psi slab bit-equal,
    from the state 20 steps leave, with a shell of source voxels."""
    from babelbrain_tpu_torch.ops import fdtd_visco_halo_kernels as VH

    grid, co = _visco_source_setup(cuda, shape, "velocity_volume")
    co.viscous = co.viscous and viscous
    vsrc = _shell(grid.shape, cuda)
    oz = 1.0 / (1000.0 * 1500.0)
    st = V.ViscoState.zeros(grid.shape, 14, cuda)
    for n in range(20):
        F.visco_step(st, co, grid, n, oz, 0.0, vsrc)
    halo, plain, pair = (_copy(st) for _ in range(3))
    rows = [F.step_scalars(grid, n, oz) for n in range(20, 20 + k)]
    before = dict(VH.launches)
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
    torch.cuda.synchronize()
    key = VH.halo_key(dft)
    assert VH.launches[key] - before[key] == 1
    assert float(halo.sxx.abs().max()) > 0
    fields = (VH.FIELDS + ("acc_cos", "acc_sin", "peak"))
    _fields_equal(halo, plain, fields, ("psi_s", "psi_v"))
    _fields_equal(halo, pair, fields, ("psi_s", "psi_v"))
    VH.release()


@pytest.mark.parametrize("n_steps", [60, 61])
@pytest.mark.parametrize("k", sorted({2, F.VISCO_HALO_K_CAP}))
def test_visco_halo_run_fdtd_matches_pair_and_scatter(cuda, k, n_steps):
    """``run_fdtd`` in shear media with a volumetric source and
    ``fuse_steps=k`` (K-step halo sweeps, then pair + scatter for the
    tail) equals pair + scatter step by step."""
    import dataclasses

    from babelbrain_tpu_torch.ops import fdtd_visco_halo_kernels as VH

    grid, co = _visco_source_setup(cuda, (36, 40, 56), "velocity_volume")
    grid = dataclasses.replace(grid, n_steps=n_steps, sensor_start=41)
    idx = co.mat_idx.cpu().numpy()
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    vsrc = _shell(grid.shape, cuda)
    before = dict(VH.launches)
    out = F.run_fdtd(idx, mats, grid, volume_source=vsrc, fuse_steps=k,
                     device="cuda")
    assert VH.launches["visco_halo_volume"] > before["visco_halo_volume"]
    step, st, co2, oz, vs = F.fdtd_setup(idx, mats, grid, volume_source=vsrc,
                                         device="cuda")
    F._time_loop([(step, st, co2, vs, None)], grid, oz)
    ref = F._carrier(st, grid)
    for name in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)


def test_visco_halo_entry_point_refuses_aliasing(cuda):
    """The C entry point refuses an output state that aliases its input
    (neighbouring blocks read the input's halo cells)."""
    from babelbrain_tpu_torch.ops import fdtd_visco_halo_kernels as VH

    grid, co = _visco_source_setup(cuda, (36, 40, 56), "velocity_volume")
    vsrc = _shell(grid.shape, cuda)
    st = V.ViscoState.zeros(grid.shape, 14, cuda)
    VH.visco_halo(st, co, [F.step_scalars(grid, 0, 1.0)], vsrc)  # the twin
    twin, _ = VH._twin(st, 1)
    saved = twin.syz
    twin.syz = st.syz
    try:
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            VH.visco_halo(st, co, [F.step_scalars(grid, 1, 1.0)], vsrc)
    finally:
        twin.syz = saved
        VH.release()


def test_visco_fused_wrapper_rejects_mixed_devices(cuda):
    from babelbrain_tpu_torch.ops import fdtd_visco_fused_kernels as VF

    grid, co = _visco_setup(cuda)
    st = V.ViscoState.zeros(grid.shape, 14, "cpu")
    with pytest.raises(ValueError,
                       match="int32 on cpu, got torch.int32 on cuda"):
        VF.visco_fused(st, co, [F.step_scalars(grid, 0, 1.0)])


SUBSET_MAPS = ("Pressure_rms", "Vy_peak", "Sigmazz_rms", "Sigmaxx_peak")


@pytest.mark.parametrize("family", ["fluid", "visco"])
@pytest.mark.parametrize("maps", ["all", "subset"])
def test_extras_and_monitor_kernels_match_plain(cuda, family, maps):
    """The extras pass and the monitor sample of the pressure / stress
    kernel (at 64 voxels, every window step) against their plain versions
    on the same states, bit for bit."""
    if family == "fluid":
        grid, co = _fluid_setup(cuda)
        st = K.FluidState.zeros(grid.shape, 14, cuda)
        step = F.fluid_step
    else:
        grid, co = _visco_setup(cuda)
        st = V.ViscoState.zeros(grid.shape, 14, cuda)
        step = F.visco_step
    names = E.SEL_MAPS if maps == "all" else SUBSET_MAPS
    rng = np.random.default_rng(2)
    ijk = np.stack([rng.integers(0, n, 64) for n in grid.shape], 1)
    index = E.monitor_index(ijk, grid.shape, cuda)
    window = range(grid.sensor_start, grid.n_steps)
    diag_k, diag_p = (E.Diagnostics.create(st, grid.sensor_start, names,
                                           sample_steps=window, index=index)
                      for _ in range(2))
    before = dict(E.launches)
    oz = 1.0 / (1000.0 * 1500.0)
    for n in range(grid.n_steps):
        step(st, co, grid, n, oz, monitor=diag_k.monitor(n))
        diag_k.record(st, n)
        diag_p.record(st, n, plain=True)
        if n in diag_p.rows:
            diag_p.monitor(n).gather_ref(st)
    torch.cuda.synchronize()
    grew = {k: E.launches[k] - before[k] for k in E.launches}
    assert grew[f"extras_{family}"] == len(window)
    assert grew[f"monitor_{family}"] == len(window)
    assert set(diag_k.extras.acc) == set(diag_p.extras.acc)
    if family == "fluid":  # Sigma maps ride on the Pressure accumulators
        assert not any(k.startswith("Sigma") for k in diag_k.extras.acc)
    for k, a in diag_k.extras.acc.items():
        assert float(a.abs().max()) > 0, k
        torch.testing.assert_close(a, diag_p.extras.acc[k], rtol=0, atol=0,
                                   msg=k)
    assert float(diag_p.series.abs().max()) > 0
    torch.testing.assert_close(diag_k.series, diag_p.series, rtol=0, atol=0)


def _visco_source_setup(device, shape, source):
    """``_visco_setup``'s layers with a plane, a stress point on a tile
    corner (the first grid: inside a tile) or a shell of source voxels."""
    if source == "velocity_plane":
        return _visco_setup(device, shape)
    mats = material_array(F0, tissues=("Water", "Skin", "Cortical",
                                       "Trabecular", "Brain"))
    dx = 1102.5 / F0 / 6
    cmax = mats[:, 1].max()
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, cmax, 0.5)))
    ijk = (17, 21, 40) if shape == (36, 40, 56) else _tile_corner(shape)
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=60,
                      frequency=F0, sensor_start=40, source_type=source,
                      source_ijk=ijk)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 25:32] = 2
    coefs = F.sls_coefficients(mats, F0, grid.dt)
    mi, table = F._build_indexed_materials(coefs, idx, None)
    prof = F._build_cpml_profiles_np(shape, 12, dx, grid.dt, cmax, 1e-5)
    z2 = np.zeros(shape[:2])
    return grid, F.make_visco_coeffs(mi, table, prof, z2, z2, grid,
                                     coefs["viscous"], device)


@pytest.mark.parametrize("where", ["listed", "full"])
@pytest.mark.parametrize("shape", [(36, 40, 56), (27, 45, 47)])
@pytest.mark.parametrize("source", ["velocity_plane", "stress_point",
                                    "velocity_volume"])
@pytest.mark.parametrize("family", ["fluid", "visco"])
def test_monitor_kernels_match_plain(cuda, family, source, shape, where):
    """The MONITOR instantiations of the pressure / stress kernel against
    the plain step followed by ``monitor_gather_ref``, bit for bit in the
    series and every field: ``listed``, 96 seeded voxels unsorted, five of
    them twice and a tile corner, sampled at steps 30-59 (before and
    inside the DFT window from 40); ``full``, every voxel at steps 35, 40
    and 59. The ragged grid has blocks with threads off the volume."""
    if family == "fluid":
        geometry, state = K.fluid_launch_geometry, K.FluidState
        step, velocity, stress = (F.fluid_step, K.fluid_velocity_ref,
                                  K.fluid_pressure_ref)
        corner = _tile_corner(shape, geometry)
        grid, co = _fluid_setup(cuda, shape=shape, source_type=source,
                                source_ijk=((17, 21, 34)
                                            if shape == (36, 40, 56)
                                            else corner))
    else:
        geometry, state = V.visco_launch_geometry, V.ViscoState
        step, velocity, stress = (F.visco_step, V.visco_velocity_ref,
                                  V.visco_stress_ref)
        corner = _tile_corner(shape, geometry)
        grid, co = _visco_source_setup(cuda, shape, source)
    vsrc = _shell(shape, cuda) if source == "velocity_volume" else None
    pamp = 50e3 if source == "stress_point" else 0.0
    pt = F.point_index(grid)
    oz = 1.0 / (1000.0 * 1500.0)
    st_k, st_p = (state.zeros(shape, 14, cuda) for _ in range(2))
    index, steps = None, (35, 40, 59)
    if where == "listed":
        rng = np.random.default_rng(3)
        ijk = np.stack([rng.integers(0, n, 96) for n in shape], 1)
        ijk = np.concatenate([ijk, ijk[[7, 3, 50, 3, 90]], [corner]])
        index, steps = E.monitor_index(ijk, shape, cuda), range(30, 60)
    diag_k, diag_p = (E.Diagnostics.create(st, grid.sensor_start,
                                           sample_steps=steps, index=index)
                      for st in (st_k, st_p))
    before = dict(E.launches)
    for n in range(grid.n_steps):
        step(st_k, co, grid, n, oz, pamp, vsrc, diag_k.monitor(n))
        s_sin, s_cos, cosw, sinw, s_pt = F.step_scalars(grid, n, oz, pamp)
        velocity(st_p, co, s_sin, s_cos)
        if vsrc is not None:
            S.velocity_volume_source_ref(st_p.vx, st_p.vy, st_p.vz, vsrc,
                                         s_sin, s_cos)
        point = None if pt is None else (pt, s_pt)
        dft = (cosw, sinw) if n >= grid.sensor_start else (None, None)
        stress(st_p, co, *dft, point, diag_p.monitor(n))
    torch.cuda.synchronize()
    assert E.launches[f"monitor_{family}"] - before[f"monitor_{family}"] == (
        len(steps))
    assert float(diag_p.series.abs().max()) > 0
    torch.testing.assert_close(diag_k.series, diag_p.series, rtol=0, atol=0)
    for name, a in vars(st_k).items():
        b = getattr(st_p, name)
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)


def test_extras_wrapper_rejects_mixed_devices(cuda):
    grid, co = _fluid_setup(cuda)
    st = K.FluidState.zeros(grid.shape, 14, cuda)
    ex = E.Extras.zeros(("Vx_rms",), grid.shape, "cpu", visco=False)
    with pytest.raises(ValueError, match="float32 on"):
        E.extras_accumulate(st, ex)
    out = torch.zeros((1, 3), device=cuda)
    # a voxel list not sorted for this launch (no CSR), or a CPU buffer
    for mon in (E.Monitor(torch.zeros(3, dtype=torch.int32, device=cuda),
                          out, 0),
                E.Monitor(None, torch.zeros((1, st.p.numel())), 0)):
        with pytest.raises(ValueError, match="monitor"):
            K.fluid_pressure(st, co, monitor=mon)


def test_probe_kernels_match_plain(cuda):
    """stream, the FMA chain and the table gather (the CT table over a
    (2, 192, 240) slab and P2's cost case) against their plain versions,
    bit for bit."""
    before = dict(P.launches)
    x = torch.rand(1 << 20, device=cuda)
    y_k, y_p = torch.empty_like(x), torch.empty_like(x)
    P.stream(x, y_k)
    P.stream_ref(x, y_p)
    rng = np.random.default_rng(0)
    xf = torch.as_tensor(rng.uniform(1, 2, P.FMA_BLOCK).astype(np.float32),
                         device=cuda)
    scale = torch.as_tensor(P.FMA_SCALE, device=cuda)
    f_k, f_p = torch.empty_like(xf), torch.empty_like(xf)
    P.fma_chain(xf, scale, f_k, 200)
    P.fma_chain_ref(xf, scale, f_p, 200)
    gathers = []
    for shape, m, n_coef in ((P.GATHER_SLAB, 1026, 4),
                             (P.P2_COST[:2], P.P2_COST[2], 1)):
        idx, tab = P.gather_inputs(shape, m, n_coef, device=cuda)
        g_k = torch.empty((n_coef,) + tuple(shape), device=cuda)
        g_p = torch.empty_like(g_k)
        P.table_gather(idx, tab, g_k)
        P.table_gather_ref(idx, tab, g_p)
        gathers.append((g_k, g_p))
    torch.cuda.synchronize()
    assert {k: P.launches[k] - before[k] for k in P.launches} == {
        "stream": 1, "fma_chain": 1, "table_gather": 2}
    torch.testing.assert_close(y_k, y_p, rtol=0, atol=0)
    torch.testing.assert_close(f_k, f_p, rtol=0, atol=0)
    for g_k, g_p in gathers:
        torch.testing.assert_close(g_k, g_p, rtol=0, atol=0)


def test_stream_kernel_ragged_length_and_alignment(cuda):
    """The vectorised stream kernel on a length that is no multiple of its
    float4s or of a block's share (the tail element by element), bit for
    bit; a view off 16-byte alignment is refused before any launch."""
    x = torch.rand((1 << 20) + 4 * 1000 + 3, device=cuda)
    y_k, y_p = torch.empty_like(x), torch.empty_like(x)
    P.stream(x, y_k)
    P.stream_ref(x, y_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(y_k, y_p, rtol=0, atol=0)
    with pytest.raises(ValueError, match="16-byte"):
        P.stream(x[1:], y_k[1:])


def test_register_rigid_on_the_card_matches_the_cpu(cuda):
    """`tests/test_torch_coreg.py`'s phantom and bands: parameters within
    0.25 deg and 0.25 voxel, quality within 1e-3."""
    from babelbrain_tpu_torch.ops.imaging import resample_affine
    from babelbrain_tpu_torch.pipeline import coreg as C

    n = 48
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n].astype(float)
    fixed = np.exp(-(((ii - 24) / 12) ** 2 + ((jj - 24) / 9) ** 2
                     + ((kk - 24) / 15) ** 2))
    fixed += 0.7 * np.exp(-(((ii - 30) / 2) ** 2 + ((jj - 18) / 2) ** 2))
    fixed += 0.5 * np.exp(-(((jj - 30) / 2) ** 2 + ((kk - 14) / 2) ** 2))
    p_true = np.array([0.06, -0.04, 0.08, 2.0, -1.5, 1.0])
    R = C.euler_matrix(*p_true[:3]).numpy().astype(np.float64)
    off = 24.0 - R @ np.full(3, 24.0) + p_true[3:]
    moving = resample_affine(fixed, np.linalg.inv(R), -np.linalg.inv(R) @ off,
                             fixed.shape, 1, device="cpu")
    pc, _, qc = C.register_rigid(fixed, moving, device="cpu",
                                 return_quality=True)
    pg, _, qg = C.register_rigid(fixed, moving, device=cuda,
                                 return_quality=True)
    assert np.rad2deg(np.abs(pg[:3] - pc[:3])).max() < 0.25, (pg, pc)
    assert np.abs(pg[3:] - pc[3:]).max() < 0.25, (pg, pc)
    assert abs(qg - qc) < 1e-3
    np.testing.assert_allclose(pg[:3], p_true[:3], atol=0.02)
    np.testing.assert_allclose(pg[3:], p_true[3:], atol=0.5)


# ---------------------------------------------------------------------------
# x decomposition: the kernels' x-CPML edge ownership
# ---------------------------------------------------------------------------


def _edge_case(family, shape, npml, source, viscous=True):
    """(grid, materials, index, plane amplitude, phase) of an edge-ownership
    check: a slab along z, a plane source or a stress point in the third
    quarter along x, 14 steps across the window's start."""
    mats = np.array([[1000.0, 1500.0, 0, 0, 0],
                     [1900.0, 2500.0, 1200.0 if family == "visco" else 0.0,
                      80.0 if viscous else 0.0,
                      90.0 if family == "visco" and viscous else 0.0]])
    dx = 1500.0 / F0 / 6
    ppp = int(np.ceil(1 / F0 / F.stable_dt(dx, 2500.0, 0.5)))
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=14,
                      frequency=F0, npml=npml, sensor_start=7,
                      source_plane_z=npml + 1, source_type=source,
                      source_ijk=(shape[0] * 5 // 8, shape[1] // 2,
                                  shape[2] // 2))
    idx = np.zeros(shape, np.uint8)
    idx[:, :, shape[2] // 2 - 3:shape[2] // 2 + 3] = 1
    amp = np.zeros(shape[:2])
    amp[2:-2, 3:-3] = 60e3
    ph = np.random.default_rng(2).uniform(-1, 1, shape[:2])
    return grid, mats, idx, amp, ph


def _edge_runs(cuda, family, shape, npml, n_shards, source, monitor,
               flags=None, viscous=True):
    """The kernels and their plain versions through ``F.step_shards`` on
    ``n_shards`` shards of one card (``flags``: the x-slab flags of a
    single shard instead of its own), every monitor sample taken (listed
    voxels or every voxel); both runs' shards."""
    grid, mats, idx, amp, ph = _edge_case(family, shape, npml, source,
                                          viscous)
    from babelbrain_tpu_torch.parallel.halo import make_mesh

    mesh = make_mesh(n_shards, devices=[cuda] * n_shards)
    steps = range(grid.sensor_start, grid.n_steps)
    mon = np.argwhere(idx[:, ::5, ::7] >= 0)[::11] * [1, 5, 7]
    runs = []
    for plain in (False, True):
        xs, shards, oz = F.shard_setup(
            mesh, idx, mats, grid, amp, ph, sel_maps=E.SEL_MAPS,
            monitor_ijk=mon if monitor == "listed" else None,
            sample_steps=steps)
        for sh in shards:
            if flags is not None:
                sh.co.x_lo, sh.co.x_hi = flags
            if monitor == "every":
                sh.diag = E.Diagnostics.create(sh.st, grid.sensor_start,
                                               sample_steps=steps)
        for n in range(grid.n_steps):
            F.step_shards(shards, xs, grid, n, oz, 60e3, plain=plain)
        runs.append(shards)
    if torch.device(cuda).type == "cuda":
        torch.cuda.synchronize()
    return runs


def _shards_equal(kernel, plain):
    for a, b in zip(kernel, plain):
        for k, v in vars(a.st).items():
            for t, u in zip(v if isinstance(v, list) else [v],
                            (getattr(b.st, k) if isinstance(v, list)
                             else [getattr(b.st, k)])):
                assert torch.equal(t, u), k
        if a.diag is not None:
            if a.diag.series is not None:
                assert torch.equal(a.diag.series, b.diag.series)
            if a.diag.extras is not None:
                for k, t in a.diag.extras.acc.items():
                    assert torch.equal(t, b.diag.extras.acc[k]), k


@pytest.mark.parametrize("monitor", ["listed", "every"])
@pytest.mark.parametrize("source", ["velocity_plane", "stress_point"])
@pytest.mark.parametrize("family,viscous", [("fluid", True),
                                            ("fluid", False),
                                            ("visco", True)])
def test_edge_ownership_kernels_match_plain(cuda, family, viscous, source,
                                            monitor):
    """Four shards of a 64-plane grid (npml 6: 16 planes a shard, ragged
    against both families' x-segments) and the ragged 27x45x47 grid as one
    shard with each pair of x-slab flags: the velocity and pressure /
    stress kernels (their POINT, DFT and MONITOR instantiations) against
    their plain versions, every field, psi slab, map and sample bit-equal.
    An interior shard leaves its x psi slabs at zero."""
    before = dict(K.launches, **V.launches)
    kernel, plain = _edge_runs(cuda, family, (64, 40, 56), 6, 4, source,
                               monitor, viscous=viscous)
    _shards_equal(kernel, plain)
    psi = kernel[1].st.psi_p if family == "fluid" else kernel[1].st.psi_s
    assert not psi[0].any() and not psi[1].any()
    if source == "velocity_plane":  # the plane reaches into both x slabs
        assert kernel[0].st.psi_v[0].any() and kernel[3].st.psi_v[1].any()
    for flags in ((True, True), (True, False), (False, True), (False, False)):
        _shards_equal(*_edge_runs(cuda, family, (27, 45, 47), 12, 1, source,
                                  monitor, flags=flags, viscous=viscous))
    after = dict(K.launches, **V.launches)
    stem = "fluid_pressure" if family == "fluid" else "visco_stress"
    point = "_point" if source == "stress_point" else ""
    for key in (stem + point, stem + point + "_dft"):
        assert after[key] > before[key], key


def _rayleigh_inputs(n_src, n_points, ki, seed=3):
    """A CTX-500-sized bowl patch set and points through its focal region,
    in the kernel's inputs (``sum_inputs``)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 0.5, n_src)
    phi = rng.uniform(0, 2 * np.pi, n_src)
    centers = 0.064 * np.stack([np.sin(theta) * np.cos(phi),
                                np.sin(theta) * np.sin(phi),
                                -np.cos(theta)], 1)
    u0 = 6e4 * np.exp(1j * rng.uniform(0, 0.3, n_src))
    points = rng.uniform([-0.02, -0.02, -0.04], [0.02, 0.02, 0.02],
                         (n_points, 3))
    k = 2 * np.pi * F0 / 1500.0 + 1j * ki
    return R.sum_inputs(k, centers, np.full(n_src, 2e-7), u0, points)


@pytest.mark.parametrize("n_src, n_points, ki", [
    (21893, 70001, 0.0), (255, 257, 0.0), (1, 1, 0.0), (4099, 9000, 30.0)])
def test_rayleigh_kernel_matches_plain(cuda, n_src, n_points, ki):
    """``rayleigh_kernel`` against its plain version on the card (source
    counts off the 256-source tile, points off the 256-point block, with
    and without attenuation), within chip_smoke's band of 2e-5 of the peak,
    and against float64 no worse than the plain version does."""
    kr, ki, c, w, pts = _rayleigh_inputs(n_src, n_points, ki)
    args = [torch.as_tensor(a, device=cuda) for a in (c, w, pts)]
    before = R.launches["rayleigh"]
    got = R.rayleigh_sum(kr, ki, *args)
    assert R.launches["rayleigh"] == before + 1
    plain = R.rayleigh_sum_ref(kr, ki, *args)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 2e-5 * scale
    few = args[2][:: max(1, n_points // 64)]
    exact = R.rayleigh_sum_ref(kr, ki, args[0].double(),
                               args[1].to(torch.complex128), few.double())
    step = max(1, n_points // 64)
    e_kernel = float((got[::step] - exact).abs().max())
    e_plain = float((plain[::step] - exact).abs().max())
    assert e_kernel <= max(2 * e_plain, 1e-6 * scale)


def test_rayleigh_kernel_values_do_not_depend_on_the_other_points(cuda):
    """A point's value is the same whichever points share its launch, bit
    for bit: the sharded ``rayleigh_field`` relies on it."""
    kr, ki, c, w, pts = _rayleigh_inputs(3000, 5000, 0.0)
    c, w, pts = (torch.as_tensor(a, device=cuda) for a in (c, w, pts))
    whole = R.rayleigh_sum(kr, ki, c, w, pts)
    for lo, hi in ((0, 1), (7, 300), (4095, 5000)):
        part = R.rayleigh_sum(kr, ki, c, w, pts[lo:hi].contiguous())
        assert torch.equal(part, whole[lo:hi])


def test_rayleigh_wrapper_rejects_mixed_devices(cuda):
    kr, ki, c, w, pts = _rayleigh_inputs(10, 10, 0.0)
    with pytest.raises(ValueError, match="centers must be contiguous"):
        R.rayleigh_sum(kr, ki, torch.as_tensor(c), torch.as_tensor(w,
                       device=cuda), torch.as_tensor(pts, device=cuda))
