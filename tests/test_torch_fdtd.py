"""Port parity: babelbrain_tpu_torch.ops.fdtd against the JAX fluid FDTD.

Host numerics are numpy copies and must be bit-equal. ``run_fdtd`` (CPU,
i.e. the plain PyTorch versions of the fluid-step kernels) is held to the
JAX XLA path at the band the JAX package holds its Pallas kernels to
(`tests/test_fused_kernel.py:61-63`: plane source atol 1e-4 peak, rtol 1e-3;
reflector 1e-5 peak; stress point 1e-6 peak, `:224`; volumetric source 1e-5
peak, `:328`) and to the committed goldens at the tol_1 bounds of
`tests/test_regression.py`. The plain step is also held to the JAX
single-sweep Pallas kernel B2 (``build_fluid_fused_step``) in interpret
mode, for a point and for a volumetric source.

Diagnostics: the 14 ``sel_maps``, the monitor series and
``run_fdtd_capture`` against the JAX XLA path (plane band 1e-4 of each
map's maximum with rtol 1e-3; point 1e-6; volumetric 1e-5; sample times
exactly equal), and ``Pressure_rms`` / ``Pressure_peak`` / the series
against the B4 kernel's ``with_p2`` and monitor capture in interpret mode.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import map_hu_to_properties
from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_extras, fdtd_kernels, fdtd_sources
from babelbrain_tpu_torch.ops.fdtd_sources import VolumeSource

torch.set_num_threads(2)

F0 = 500e3
GOLDEN_DIR = Path(__file__).parent / "golden"


def _config(name):
    """The water_plane / ct_slab_fluid golden configurations
    (`tests/test_regression.py:28-92`)."""
    if name == "water_plane":
        shape = (40, 40, 150)
        dx = 1500.0 / F0 / 9
        ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 1500.0, 0.9)))
        mats = np.array([[1000.0, 1500.0, 0, 0, 0]])
        idx = np.zeros(shape, np.uint8)
        amp = np.full(shape[:2], 60e3)
        ph = np.zeros(shape[:2])
    else:
        shape = (64, 48, 120)
        dx = 1482.3 / F0 / 6
        ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2900.0, 0.5)))
        hu = np.linspace(400, 2000, 20)
        rho, sos, att = map_hu_to_properties(hu, F0, "Webb-Marsac")
        mats = np.zeros((23, 5))
        mats[0] = [1000.0, 1500.0, 0, 0, 0]
        mats[1] = [1116.0, 1537.0, 0, 2.99, 0]
        mats[2] = [1041.0, 1562.0, 0, 4.49, 0]
        mats[3:, 0] = rho
        mats[3:, 1] = sos
        mats[3:, 3] = att
        rng = np.random.default_rng(7)
        idx = np.zeros(shape, np.uint8)
        idx[:, :, 44:48] = 1
        idx[:, :, 48:60] = rng.integers(3, 23, (64, 48, 12))
        idx[:, :, 60:] = 2
        amp = np.zeros(shape[:2])
        amp[16:-16, 16:-16] = 60e3
        ph = np.zeros(shape[:2])
    dt = 1 / F0 / ppp
    nsteps = ppp * 18
    grid = dict(shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0,
                sensor_start=nsteps - 2 * ppp, source_plane_z=13)
    return idx, mats, grid, amp, ph


@functools.cache
def _runs(name):
    """(JAX XLA output, port output) for a golden configuration."""
    idx, mats, g, amp, ph = _config(name)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, backend="xla")
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, device="cpu")
    return oj, ot


# ---------------------------------------------------------------------------
# host numerics: bit-equal copies
# ---------------------------------------------------------------------------


def test_cpml_profiles_bit_equal():
    for n, npml in ((40, 12), (150, 12), (20, 8)):
        a = J.cpml_profiles(n, npml, 1e-4, 3e-8, 2900.0)
        b = T.cpml_profiles(n, npml, 1e-4, 3e-8, 2900.0)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    pa = J._build_cpml_profiles_np((30, 32, 40), 12, 1e-4, 3e-8, 2900.0, 1e-5)
    pb = T._build_cpml_profiles_np((30, 32, 40), 12, 1e-4, 3e-8, 2900.0, 1e-5)
    for ea, eb in zip(pa, pb):
        for stag in ("int", "half"):
            for k in ea[stag]:
                np.testing.assert_array_equal(ea[stag][k], eb[stag][k])


def test_sls_coefficients_bit_equal():
    _, mats, g, _, _ = _config("ct_slab_fluid")
    a = J.sls_coefficients(mats, F0, g["dt"])
    b = T.sls_coefficients(mats, F0, g["dt"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_stable_dt_bit_equal():
    for dx, c, cfl in ((1e-4, 1500.0, 1.0), (3.7e-4, 2900.0, 0.5)):
        assert J.stable_dt(dx, c, cfl) == T.stable_dt(dx, c, cfl)


@pytest.mark.parametrize("reflector", [False, True])
def test_material_fields_and_reflector_fold_bit_equal(reflector):
    """The fluid kernels' indexed table, gathered at the index, equals the
    JAX expanded property volumes (``_material_fields``, folded with
    ``_fold_reflector`` when a reflector mask is given), bit for bit."""
    idx, mats, g, _, _ = _config("ct_slab_fluid")
    coefs = J.sls_coefficients(mats, F0, g["dt"])
    props = J._material_fields(idx, coefs, has_shear=False)
    refl = None
    if reflector:
        refl = np.random.default_rng(3).random(idx.shape) > 0.9
        J._fold_reflector(props, refl, False)
    ti, tt = T._build_indexed_materials(coefs, idx, refl)
    assert ti.dtype == np.int32 and tt.shape == (6, 46 if reflector else 23)
    co = T.make_fluid_coeffs(ti, tt, T._build_cpml_profiles_np(
        g["shape"], 12, g["dx"], g["dt"], 2900.0, 1e-5),
        np.zeros(g["shape"][:2]), np.zeros(g["shape"][:2]),
        T.FDTDGrid(**g), coefs["viscous"], "cpu")
    assert set(props) == {"pi_u", "c_rp", "b_r", "rho_inv"}
    for row, k in ((0, "rho_inv"), (1, "pi_u"), (3, "c_rp"), (5, "b_r")):
        got = fdtd_kernels._gather(co, row).numpy()
        np.testing.assert_array_equal(got, props[k], err_msg=k)
    if reflector:
        assert (props["pi_u"][refl] == 0).all()


# ---------------------------------------------------------------------------
# run_fdtd against the JAX XLA solver and the goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["water_plane", "ct_slab_fluid"])
def test_run_fdtd_matches_jax_xla(name):
    oj, ot = _runs(name)
    peak = oj["p_amp"].max()
    # the band JAX holds its Pallas kernels to: atol 1e-4 peak, rtol 1e-3
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-4 * peak,
                               rtol=1e-3)
    np.testing.assert_allclose(ot["peak"], oj["peak"],
                               atol=1e-4 * oj["peak"].max(), rtol=1e-3)
    assert set(ot) == {"p_amp", "p_phase", "peak"}
    assert ot["p_amp"].dtype == np.float32


@pytest.mark.tol_1
@pytest.mark.parametrize(
    "name,tol_l2,tol_linf", [("water_plane", 0.01, 0.01),
                             ("ct_slab_fluid", 0.01, 0.02)],
)
def test_run_fdtd_golden(name, tol_l2, tol_linf):
    _, ot = _runs(name)
    field = ot["p_amp"]
    gold = np.load(GOLDEN_DIR / f"{name}.npz")["p_amp_kpa"].astype(np.float32) * 1e3
    # tol_1 bounds of tests/test_regression.py:96-116
    l2 = np.linalg.norm(field - gold) / np.linalg.norm(gold)
    linf = np.abs(field - gold).max() / gold.max()
    assert l2 < tol_l2, f"{name}: L2 {l2:.4f}"
    assert linf < tol_linf, f"{name}: Linf {linf:.4f}"


def test_reflector_mask_matches_jax_xla():
    shape = (32, 32, 60)
    dx = 1500.0 / F0 / 6
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 1600.0, 0.5)))
    dt = 1 / F0 / ppp
    mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1050.0, 1600.0, 0, 5.0, 0]])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 30:] = 1
    refl = np.zeros(shape, bool)
    refl[12:20, 12:20, 36:40] = True
    amp = np.zeros(shape[:2])
    amp[8:-8, 8:-8] = 60e3
    ph = np.random.default_rng(5).uniform(-1, 1, shape[:2])
    n = ppp * 8
    g = dict(shape=shape, dx=dx, dt=dt, n_steps=n, frequency=F0,
             sensor_start=n - 2 * ppp, source_plane_z=13)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, reflector_mask=refl, backend="xla")
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, reflector_mask=refl, device="cpu")
    peak = oj["p_amp"].max()
    # reflector band of tests/test_fused_kernel.py: atol 1e-5 peak
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-5 * peak,
                               rtol=1e-3)
    # pressure-release voxels stay silent
    assert ot["p_amp"][refl].max() == 0.0


def test_cpu_run_counts_plain_calls_not_launches():
    idx, mats, g, amp, ph = _config("water_plane")
    g = dict(g, shape=(20, 20, 40), n_steps=12, sensor_start=8)
    for d in (fdtd_kernels.launches, fdtd_kernels.plain_calls):
        for k in d:
            d[k] = 0
    T.run_fdtd(np.zeros(g["shape"], np.uint8), mats, T.FDTDGrid(**g),
               source_amp=np.full((20, 20), 1e3), device="cpu")
    assert all(v == 0 for v in fdtd_kernels.launches.values())
    assert fdtd_kernels.plain_calls == {
        "fluid_velocity": 12, "fluid_pressure": 8, "fluid_pressure_dft": 4,
        "fluid_pressure_point": 0, "fluid_pressure_point_dft": 0,
    }


@pytest.mark.parametrize("case", ["mesh", "rayleigh_mesh"])
def test_paths_outside_the_slice_raise(case):
    """A mesh that is not a ``DeviceMesh`` is refused; a 2-D (x, y) mesh
    runs (ROADMAP Queue A item 6a) and gives the unsharded result bit for
    bit."""
    from babelbrain_tpu_torch.parallel.halo import make_mesh_2d

    idx, mats, g, amp, ph = _config("water_plane")
    g = dict(g, shape=(20, 20, 40), n_steps=12, sensor_start=6, npml=4,
             source_plane_z=6)
    mesh_2d = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    if case == "rayleigh_mesh":
        from babelbrain_tpu_torch.ops.rayleigh import rayleigh_field

        rng = np.random.default_rng(2)
        pts = rng.uniform(0.01, 0.02, (9, 3))

        def run(mesh):
            return {"p": rayleigh_field(1e3, np.zeros((1, 3)), np.ones(1),
                                        np.ones(1), pts, point_block=2,
                                        mesh=mesh, device="cpu")}
    else:
        def run(mesh):
            return T.run_fdtd(np.zeros(g["shape"], np.uint8), mats,
                              T.FDTDGrid(**g), np.full((20, 20), 1e3),
                              device="cpu", mesh=mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        run(object())
    whole, cut = run(None), run(mesh_2d)
    for k, v in whole.items():
        assert np.abs(v).max() > 0, k
        np.testing.assert_array_equal(cut[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# stress-point (refocusing) and volumetric (dome) sources
# ---------------------------------------------------------------------------


def _point_config(n_periods=4):
    """The fluid stress-point configuration of
    `tests/test_fused_kernel.py:192-206` (32x32x64 water, point at
    (17, 15, 40), amplitude 50 kPa)."""
    C = 1500.0
    shape = (32, 32, 64)
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, C, 0.9)))
    ns = ppp * n_periods
    g = dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns, frequency=F0,
             sensor_start=ns - min(2, n_periods - 1) * ppp,
             source_plane_z=13, source_type="stress_point",
             source_ijk=(17, 15, 40))
    mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
    return np.zeros(shape, np.uint8), mats, g, 50e3


def _shell_source(n, scale=1.0):
    """The hemispherical dome shell of `tests/test_fused_kernel.py:311-323`
    on an n^3 grid (radii 14-16 of 48, scaled with n): amplitude 60 kPa,
    random phase (seed 4), inward normals."""
    rng = np.random.default_rng(4)
    c = n / 2.0
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n]
    r = np.sqrt((ii - c) ** 2 + (jj - c) ** 2 + (kk - c) ** 2)
    shell = (r > 14 * n / 48 * scale) & (r < 16 * n / 48 * scale) & (kk < c)
    rr = np.maximum(r, 1e-6)
    return dict(
        amp=np.where(shell, 60e3, 0.0).astype(np.float32),
        phase=(rng.uniform(-2, 2, r.shape) * shell).astype(np.float32),
        ox=((c - ii) / rr).astype(np.float32),
        oy=((c - jj) / rr).astype(np.float32),
        oz=((c - kk) / rr).astype(np.float32),
    )


def _volume_config(n=48):
    """The zero-shear dome configuration of
    `tests/test_fused_kernel.py:294-324` (water + a shear-free bone slab)."""
    C = 1500.0
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, 0.9)))
    ns = ppp * 3
    g = dict(shape=(n, n, n), dx=dx, dt=1 / F0 / ppp, n_steps=ns,
             frequency=F0, sensor_start=ns - 2 * ppp,
             source_type="velocity_volume")
    mats = np.array([[1000.0, C, 0.0, 20.0, 0.0],
                     [1896.0, 2494.0, 0.0, 150.0, 0.0]])
    idx = np.zeros((n, n, n), np.uint8)
    idx[:, :, 30 * n // 48:36 * n // 48] = 1
    return idx, mats, g, _shell_source(n)


def test_stress_point_matches_jax_xla():
    idx, mats, g, pamp = _point_config()
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), point_amp=pamp, backend="xla")
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), point_amp=pamp, device="cpu")
    scale = oj["p_amp"].max()
    assert scale > 0
    # JAX's own point band (`tests/test_fused_kernel.py:224`): 1e-6 peak
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-6 * scale)
    np.testing.assert_allclose(ot["peak"], oj["peak"], atol=1e-6 * scale)
    # the source cell carries the drive
    i, j, k = g["source_ijk"]
    assert ot["p_amp"][i, j, k] == ot["p_amp"].max()


def test_velocity_volume_matches_jax_xla():
    idx, mats, g, vs = _volume_config()
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), volume_source=vs,
                    backend="xla")
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), volume_source=vs,
                    device="cpu")
    scale = oj["p_amp"].max()
    assert scale > 0
    # the band of `tests/test_fused_kernel.py:328`: 1e-5 peak
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-5 * scale)
    np.testing.assert_allclose(ot["peak"], oj["peak"], atol=1e-5 * scale)


def _b2_only(monkeypatch):
    """Count the JAX kernel builders that run: B2 must, B1/B3/B4 must not."""
    built = {}
    for name in ("build_fluid_fused_step", "build_fluid_pallas_step",
                 "build_fluid_fused2_step", "build_fluid_fusedK_step"):
        fn = getattr(JP, name)

        def counted(*a, _fn=fn, _name=name, **k):
            built[_name] = built.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(JP, name, counted)
    return built


@pytest.mark.parametrize("source", ["stress_point", "velocity_volume"])
def test_plain_step_matches_jax_b2_interpret(source, monkeypatch):
    """The plain step against B2 itself: ``simulate_fluid_pallas`` with
    ``fuse_steps=1`` and x-slabs of 8 planes (too few slabs for the 2-step
    kernel B3) runs ``build_fluid_fused_step`` for every step."""
    if source == "stress_point":
        idx, mats, g, pamp = _point_config(n_periods=2)
        vs = None
    else:
        idx, mats, g, vs = _volume_config(n=32)
        g = dict(g, n_steps=g["n_steps"] * 2 // 3,
                 sensor_start=g["sensor_start"] * 2 // 3)
        pamp = 0.0
    grid_j = J.FDTDGrid(**g)
    coefs = J.sls_coefficients(mats, F0, g["dt"])
    props = {k: jnp.asarray(v) for k, v in
             J._material_fields(idx, coefs, has_shear=False).items()}
    cmax = mats[:, 1].max()
    prof = J._build_cpml_profiles_np(g["shape"], 12, g["dx"], g["dt"], cmax,
                                     1e-5)
    z2 = jnp.zeros(g["shape"][:2], jnp.float32)
    built = _b2_only(monkeypatch)
    acc_c, acc_s, peak_j = (np.asarray(o) for o in JP.simulate_fluid_pallas(
        props, z2, z2, jnp.float32(pamp), grid=grid_j, profiles_np=prof,
        viscous=coefs["viscous"], oz_scale=1.0 / (mats[0, 0] * mats[0, 1]),
        nb=8, interpret=True, fuse_steps=1, volume_source=vs,
    ))
    assert set(built) == {"build_fluid_fused_step"}, built

    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), point_amp=pamp,
                    volume_source=vs, device="cpu")
    n_win = g["n_steps"] - g["sensor_start"]
    pj = 2.0 / n_win * np.sqrt(acc_c**2 + acc_s**2)
    scale = pj.max()
    assert scale > 0
    np.testing.assert_allclose(ot["p_amp"], pj, atol=1e-5 * scale)
    np.testing.assert_allclose(ot["peak"], peak_j, atol=1e-5 * scale)


def test_volume_source_is_the_positive_amplitude_voxels():
    _, _, g, vs = _volume_config(n=24)
    sparse = VolumeSource.from_dense(vs, g["shape"], "cpu")
    on = np.flatnonzero(vs["amp"] > 0)
    assert sparse.n_src == on.size > 0
    np.testing.assert_array_equal(sparse.index.numpy(), on.astype(np.int32))
    for k in ("amp", "ox", "oy", "oz"):
        np.testing.assert_array_equal(getattr(sparse, k).numpy(),
                                      vs[k].reshape(-1)[on])
    # the plain scatter SETS the three velocities at exactly those voxels
    v = [torch.full(g["shape"], 7.0) for _ in range(3)]
    fdtd_sources.velocity_volume_source(*v, sparse, 0.3, -0.2)
    sv = vs["amp"] * (np.float32(0.3) * np.cos(vs["phase"])
                      + np.float32(-0.2) * np.sin(vs["phase"]))
    for t, o in zip(v, ("ox", "oy", "oz")):
        got = t.numpy().reshape(-1)
        np.testing.assert_allclose(got[on], (sv * vs[o]).reshape(-1)[on],
                                   rtol=1e-6, atol=1e-3)
        assert (np.delete(got, on) == 7.0).all()


@pytest.mark.parametrize("case", ["unknown_type", "missing_volume",
                                  "volume_shape", "point_outside"])
def test_source_inputs_are_checked(case):
    idx, mats, g, _ = _point_config(n_periods=2)
    g = dict(g, shape=(20, 20, 40), n_steps=4, sensor_start=2)
    kw = {}
    if case == "unknown_type":
        g["source_type"] = "velocity_line"
    elif case == "missing_volume":
        g["source_type"] = "velocity_volume"
    elif case == "volume_shape":
        g["source_type"] = "velocity_volume"
        kw["volume_source"] = _shell_source(24)
    else:
        g["source_ijk"] = (25, 0, 0)
    with pytest.raises(ValueError):
        T.run_fdtd(np.zeros(g["shape"], np.uint8), mats, T.FDTDGrid(**g),
                   point_amp=1e3, device="cpu", **kw)


def test_point_and_volume_runs_count_their_plain_calls():
    idx, mats, g, pamp = _point_config(n_periods=2)
    g = dict(g, shape=(20, 20, 20), n_steps=12, sensor_start=8,
             source_ijk=(10, 10, 10))
    for mod in (fdtd_kernels, fdtd_sources):
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0
    T.run_fdtd(np.zeros(g["shape"], np.uint8), mats, T.FDTDGrid(**g),
               point_amp=pamp, device="cpu")
    assert fdtd_kernels.plain_calls == {
        "fluid_velocity": 12, "fluid_pressure": 0, "fluid_pressure_dft": 0,
        "fluid_pressure_point": 8, "fluid_pressure_point_dft": 4,
    }
    g = dict(g, source_type="velocity_volume")
    T.run_fdtd(np.zeros(g["shape"], np.uint8), mats, T.FDTDGrid(**g),
               volume_source=_shell_source(20), device="cpu")
    assert fdtd_sources.plain_calls == {"volume_source": 12}
    assert fdtd_kernels.plain_calls["fluid_pressure"] == 8
    assert not any(fdtd_kernels.launches.values())
    assert not any(fdtd_sources.launches.values())


# ---------------------------------------------------------------------------
# diagnostics: sel_maps, monitor series, raw capture
# ---------------------------------------------------------------------------


ALL_MAPS = fdtd_extras.SEL_MAPS


def _water_grid(shape, cycles, cfl=0.9, **kw):
    """The water grid of `tests/test_fdtd.py:22-38` (9 PPW, a 2-period
    window)."""
    dx = 1500.0 / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 1500.0, cfl)))
    ns = ppp * cycles
    return dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns, frequency=F0,
                sensor_start=ns - 2 * ppp, source_plane_z=13, **kw)


def _maps_match(ot, oj, names, band, rtol=0.0, series_band=None):
    """Each map of ``names`` and the monitor series within ``band`` (the
    series: ``series_band``, default ``band``) x its own maximum (and
    ``rtol``); the sample times exactly equal."""
    assert set(ot) == set(oj)
    bands = dict.fromkeys(names, band)
    if "sensor_series" in oj:
        bands["sensor_series"] = series_band or band
    for name, b in bands.items():
        scale = np.abs(oj[name]).max()
        assert scale > 0, name
        assert ot[name].dtype == np.float32 and ot[name].shape == oj[name].shape
        np.testing.assert_allclose(ot[name], oj[name], atol=b * scale,
                                   rtol=rtol, err_msg=name)
    if "sensor_times" in oj:
        np.testing.assert_array_equal(ot["sensor_times"], oj["sensor_times"])


def test_water_maps_and_monitors_match_jax_xla():
    """The `TestSelMapsAndSensors` water case (`tests/test_fdtd.py:381-393`)
    with all 14 maps, two monitors and subsampling 2: plane band (1e-4 of
    each map's maximum, rtol 1e-3)."""
    g = _water_grid((24, 24, 96), cycles=18)
    mats = np.array([[1000.0, 1500.0, 0.0, 0.0, 0.0]])
    idx = np.zeros(g["shape"], np.uint8)
    kw = dict(source_amp=np.full(g["shape"][:2], 60e3), sel_maps=ALL_MAPS,
              monitor_ijk=np.array([[12, 12, 40], [12, 12, 55]]),
              sensor_subsampling=2)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), backend="xla", **kw)
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    _maps_match(ot, oj, ALL_MAPS, 1e-4, rtol=1e-3)
    assert ot["sensor_series"].shape == (
        2, len(range(g["sensor_start"], g["n_steps"], 2)))
    # fluid: sigma_ii = -p, so the Sigma maps are the Pressure maps
    for kind in ("rms", "peak"):
        for s in ("Sigmaxx", "Sigmayy", "Sigmazz"):
            np.testing.assert_array_equal(ot[f"{s}_{kind}"],
                                          ot[f"Pressure_{kind}"])
    np.testing.assert_array_equal(ot["Pressure_peak"], ot["peak"])
    rms = ot["Pressure_rms"][12, 12, 30:70] / ot["p_amp"][12, 12, 30:70]
    np.testing.assert_allclose(rms, 1 / np.sqrt(2), rtol=0.03)


@pytest.mark.parametrize("source", ["stress_point", "velocity_volume"])
def test_point_and_volume_maps_match_jax_xla(source):
    """All 14 maps and two monitors with a stress point (band 1e-6 of each
    map's maximum) and with a volumetric shell (1e-5, the volumetric band
    of `tests/test_fused_kernel.py:328`). The series of the point run is
    held at 1e-5: an instantaneous sample carries the phase of JAX's
    float32 source scalar (omega t rounded in float32, ~1e-6 rad after four
    periods) against the port's float64 one, which the window sums of the
    maps average out."""
    if source == "stress_point":
        idx, mats, g, pamp = _point_config()
        kw, band = dict(point_amp=pamp), 1e-6
        mon = np.array([[17, 15, 40], [17, 15, 50]])
    else:
        idx, mats, g, vs = _volume_config(n=32)
        kw, band = dict(volume_source=vs), 1e-5
        mon = np.array([[16, 16, 16], [16, 16, 24]])
    kw.update(sel_maps=ALL_MAPS, monitor_ijk=mon)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), backend="xla", **kw)
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    _maps_match(ot, oj, ALL_MAPS, band, series_band=1e-5)


def _b4_config():
    """The B4 Pressure-map and monitor configuration of
    `tests/test_fused_kernel.py:525-556` (64x32x64 water, a window of 21
    steps, two monitors)."""
    C = 1500.0
    shape = (64, 32, 64)
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, C, 0.9)))
    n_win = (ppp // 3) * 3
    ns = ppp * 2 + n_win
    g = dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns, frequency=F0,
             sensor_start=ns - n_win, source_plane_z=13)
    mats = np.array([[1000.0, C, 0.0, 20.0, 0.0]])
    amp = np.zeros(shape[:2])
    amp[8:-8, 8:-8] = 60e3
    kw = dict(source_amp=amp, sel_maps=("Pressure_rms", "Pressure_peak"),
              monitor_ijk=np.array([[32, 16, 40], [20, 10, 30]]))
    return np.zeros(shape, np.uint8), mats, g, kw


@functools.cache
def _b4_jax():
    """JAX's Pallas path (B4 with ``with_p2`` and the monitor capture, in
    interpret mode) on ``_b4_config``, run once for both port routes."""
    idx, mats, g, kw = _b4_config()
    return J.run_fdtd(idx, mats, J.FDTDGrid(**g), backend="pallas", **kw)


@pytest.mark.parametrize("fuse_steps", [None, 3])
def test_pressure_maps_and_monitor_match_jax_b4_interpret(fuse_steps):
    """The port against B4 itself (``build_fluid_fusedK_step`` with
    ``with_p2`` and its driver's monitor capture), run by the JAX Pallas
    path in interpret mode: ``Pressure_rms`` and ``Pressure_peak`` at the
    plane band, and the series at B4's sample steps (every fused depth).
    The port's default (``EXTRAS_FUSE_BEST`` = 0: every step on the pair)
    and its extras sweeps at K = 3 (the window in the fused sweep, p^2 and
    the samples inside it)."""
    idx, mats, g, kw = _b4_config()
    oj = _b4_jax()
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu",
                    fuse_steps=fuse_steps, **kw)
    steps_j = np.round(oj["sensor_times"] / g["dt"]).astype(int)
    steps_t = np.round(ot["sensor_times"] / g["dt"]).astype(int)
    # the port samples every step of the window, B4 once per sweep
    np.testing.assert_array_equal(steps_t, np.arange(g["sensor_start"],
                                                     g["n_steps"]))
    assert 0 < len(steps_j) < len(steps_t)
    pos = np.searchsorted(steps_t, steps_j)
    np.testing.assert_array_equal(steps_t[pos], steps_j)
    ot = dict(ot, sensor_series=ot["sensor_series"][:, pos],
              sensor_times=ot["sensor_times"][pos])
    _maps_match(ot, oj, ("Pressure_rms", "Pressure_peak"), 1e-4, rtol=1e-3)


def _capture_config():
    """A small water + attenuating-slab plane-source case and a 3x3x3 mask
    in the slab's shadow."""
    g = _water_grid((20, 20, 64), cycles=6)
    mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1050.0, 1600.0, 0, 5.0, 0]])
    idx = np.zeros(g["shape"], np.uint8)
    idx[:, :, 30:36] = 1
    amp = np.zeros(g["shape"][:2])
    amp[4:-4, 4:-4] = 60e3
    mask = np.zeros(g["shape"], bool)
    mask[9:12, 9:12, 40:43] = True
    return idx, mats, g, dict(source_amp=amp), mask


@pytest.mark.parametrize("where", ["mask", "volume"])
def test_capture_matches_jax_and_the_monitor_series(where):
    """``run_fdtd_capture`` against JAX (plane band), with a mask over the
    whole sensor window and over the full volume every 5th step of the last
    20; the samples equal the port's own monitor series bit for bit, and the
    carrier outputs its ``run_fdtd``'s."""
    idx, mats, g, kw, mask = _capture_config()
    if where == "mask":
        cap = dict(t_start=g["sensor_start"], sensor_mask=mask)
    else:
        cap = dict(t_start=g["n_steps"] - 20, subsample=5)
    oj = J.run_fdtd_capture(idx, mats, J.FDTDGrid(**g), **kw, **cap)
    ot = T.run_fdtd_capture(idx, mats, T.FDTDGrid(**g), **kw, **cap,
                            device="cpu")
    assert set(ot) == set(oj)
    np.testing.assert_array_equal(ot["times"], oj["times"])
    scale = np.abs(oj["series"]).max()
    assert scale > 0 and ot["series"].shape == oj["series"].shape
    np.testing.assert_allclose(ot["series"], oj["series"], atol=1e-4 * scale,
                               rtol=1e-3)
    ijk = np.argwhere(mask)
    if where == "mask":
        np.testing.assert_array_equal(ot["sensor_ijk"], oj["sensor_ijk"])
    mon = T.run_fdtd(idx, mats, T.FDTDGrid(**g), **kw, monitor_ijk=ijk,
                     device="cpu")
    rows = np.round(ot["times"] / g["dt"]).astype(int) - g["sensor_start"]
    series = (ot["series"] if where == "mask"
              else ot["series"][:, ijk[:, 0], ijk[:, 1], ijk[:, 2]])
    np.testing.assert_array_equal(series, mon["sensor_series"][:, rows].T)
    for k in ("p_amp", "p_phase", "peak"):
        np.testing.assert_array_equal(ot[k], mon[k])


def test_shear_point_capture_matches_jax():
    """A stress point behind a shear slab, captured at a mask: JAX's band
    for visco point runs (1e-4 of the maximum, rtol 1e-3)."""
    g = _water_grid((20, 20, 48), cycles=3, cfl=0.5,
                    source_type="stress_point", source_ijk=(10, 9, 30))
    mats = np.array([[1000.0, 1500.0, 0, 0, 0],
                     [1800.0, 2400.0, 1200.0, 50.0, 80.0]])
    idx = np.zeros(g["shape"], np.uint8)
    idx[:, :, 20:24] = 1
    mask = np.zeros(g["shape"], bool)
    mask[10, 9, 14:18] = True
    cap = dict(point_amp=50e3, t_start=g["sensor_start"], subsample=3,
               sensor_mask=mask)
    oj = J.run_fdtd_capture(idx, mats, J.FDTDGrid(**g), **cap)
    ot = T.run_fdtd_capture(idx, mats, T.FDTDGrid(**g), **cap, device="cpu")
    scale = np.abs(oj["series"]).max()
    assert scale > 0
    np.testing.assert_array_equal(ot["times"], oj["times"])
    np.testing.assert_allclose(ot["series"], oj["series"], atol=1e-4 * scale,
                               rtol=1e-3)


@pytest.mark.parametrize("case", ["unknown_map", "capture_window",
                                  "subsampling", "monitor_outside",
                                  "capture_volume_source"])
def test_diagnostic_inputs_are_checked(case):
    """JAX's two errors (unknown map names, a capture window outside the
    run) with its messages, and the port's own checks."""
    g = _water_grid((16, 16, 40), cycles=2)
    mats = np.array([[1000.0, 1500.0, 0, 0, 0]])
    idx = np.zeros(g["shape"], np.uint8)
    if case == "unknown_map":
        with pytest.raises(ValueError, match="unknown sel_maps entries"):
            T.run_fdtd(idx, mats, T.FDTDGrid(**g), sel_maps=("Bogus_rms",),
                       device="cpu")
    elif case == "capture_window":
        with pytest.raises(ValueError, match="capture window"):
            T.run_fdtd_capture(idx, mats, T.FDTDGrid(**g), t_start=5,
                               t_end=5, device="cpu")
    elif case == "subsampling":
        with pytest.raises(ValueError, match="sensor_subsampling"):
            T.run_fdtd(idx, mats, T.FDTDGrid(**g), sensor_subsampling=0,
                       monitor_ijk=np.zeros((1, 3), int), device="cpu")
    elif case == "monitor_outside":
        with pytest.raises(ValueError, match="outside the grid"):
            T.run_fdtd(idx, mats, T.FDTDGrid(**g),
                       monitor_ijk=np.array([[0, 0, 40]]), device="cpu")
    else:
        g["source_type"] = "velocity_volume"
        with pytest.raises(ValueError, match="plane and point"):
            T.run_fdtd_capture(idx, mats, T.FDTDGrid(**g), device="cpu")


def test_diagnostics_count_their_plain_calls():
    """One extras pass a window step, one gather a sample step, no launch."""
    g = _water_grid((20, 20, 40), cycles=2)
    g = dict(g, n_steps=30, sensor_start=17)
    for d in (fdtd_extras.launches, fdtd_extras.plain_calls):
        for k in d:
            d[k] = 0
    T.run_fdtd(np.zeros(g["shape"], np.uint8),
               np.array([[1000.0, 1500.0, 0, 0, 0]]), T.FDTDGrid(**g),
               source_amp=np.full((20, 20), 1e3), sel_maps=("Vz_rms",),
               monitor_ijk=np.array([[10, 10, 20]]), sensor_subsampling=4,
               device="cpu")
    assert fdtd_extras.plain_calls == {
        "extras_fluid": 13, "extras_visco": 0,
        "monitor_fluid": len(range(17, 30, 4)), "monitor_visco": 0,
    }
    assert not any(fdtd_extras.launches.values())
