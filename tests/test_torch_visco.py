"""Port parity: the viscoelastic (label-mode) FDTD of babelbrain_tpu_torch.

* ``_build_indexed_materials``: the same index and table rows, bit for bit,
  as the JAX version, with and without a reflector mask.
* ``run_fdtd`` on shear media (CPU, i.e. the plain PyTorch versions of the
  visco kernels) against JAX ``run_fdtd(backend="xla")`` on the
  ``skull_slab_visco`` configuration of `tests/test_regression.py:37-59`, at
  the fluid band (atol 1e-4 peak, rtol 1e-3), and against its golden at the
  tol_1 bounds.
* The plain step loop with the JAX indexed materials (carried over by
  ``convert.indexed_materials_from_reference``) against JAX
  ``simulate_visco_pallas`` in interpret mode with ``fuse_steps=2`` (the
  B8 kernel), at the band of `tests/test_fused_kernel.py:172-174`.
* Stress-point (refocusing) and volumetric (dome) sources in shear media
  against JAX ``run_fdtd(backend="xla")`` at the visco plane band (atol
  1e-4 peak, rtol 1e-3), on the dome configuration of
  `tests/test_fused_kernel.py:340-369` and a cortical-bone slab with a point
  source behind it.
* The 14 ``sel_maps`` and a monitor series in shear media against JAX XLA
  on the shear case of `tests/test_fdtd.py:430-452`.
* A CPU run counts plain calls and launches no kernel.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu.ops import fdtd_pallas as JP
from babelbrain_tpu_torch import convert
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

torch.set_num_threads(2)

F0 = 500e3
GOLDEN_DIR = Path(__file__).parent / "golden"


def _skull_slab_visco():
    """The skull_slab_visco golden configuration
    (`tests/test_regression.py:37-59`)."""
    shape = (64, 48, 120)
    dx = 1102.5 / F0 / 6
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, 0.5)))
    mats = np.array([
        [1000.0, 1500.0, 0, 0, 0],
        [1116.0, 1537.0, 0, 2.3, 0],
        [1896.5, 2494.0, 1594.0, 106.0, 214.0],
        [1738.0, 2247.0, 1345.0, 105.0, 214.0],
        [1041.0, 1562.0, 0, 3.45, 0],
    ])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 44:48] = 1
    idx[:, :, 48:51] = 2
    idx[:, :, 51:56] = 3
    idx[:, :, 56:59] = 2
    idx[:, :, 59:] = 4
    rng = np.random.default_rng(42)
    amp = np.zeros(shape[:2])
    amp[16:-16, 16:-16] = 60e3 * rng.uniform(0.8, 1.0, (32, 16))
    ph = rng.uniform(-0.5, 0.5, shape[:2])
    dt = 1 / F0 / ppp
    nsteps = ppp * 18
    grid = dict(shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0,
                sensor_start=nsteps - 2 * ppp, source_plane_z=13)
    return idx, mats, grid, amp, ph


@functools.cache
def _slab_runs():
    """(JAX XLA output, port output) on skull_slab_visco."""
    idx, mats, g, amp, ph = _skull_slab_visco()
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, backend="xla")
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), source_amp=amp,
                    source_phase=ph, device="cpu")
    return oj, ot


def _indexed_setup():
    """The 32x32x64 setup of `tests/test_fused_kernel.py:393-435`: water
    with attenuation, a cortical-bone slab with shear, skin, an air-cavity
    reflector."""
    C = 1500.0
    shape = (32, 32, 64)
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, 0.9)))
    dt = 1 / F0 / ppp
    ns = ppp * 2
    grid = dict(shape=shape, dx=dx, dt=dt, n_steps=ns, frequency=F0,
                sensor_start=ns - ppp, source_plane_z=13)
    mats = np.array(
        [[1000.0, C, 0.0, 20.0, 0.0], [1896.5, 2494.0, 1594.0, 106.0, 214.0],
         [1116.0, 1537.0, 0.0, 2.99, 0.0]]
    )
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 30:38] = 1
    idx[:, :, 38:42] = 2
    refl = np.zeros(shape, bool)
    refl[10:20, 10:20, 50:53] = True
    amp = np.zeros(shape[:2])
    amp[8:-8, 8:-8] = 60e3
    ph = np.random.default_rng(5).uniform(-2, 2, shape[:2])
    return idx, mats, grid, amp, ph, refl


# ---------------------------------------------------------------------------
# indexed materials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_reflector", [False, True])
def test_indexed_materials_bit_equal(with_reflector):
    idx, mats, g, _, _, refl = _indexed_setup()
    refl = refl if with_reflector else None
    coefs = J.sls_coefficients(mats, F0, g["dt"])
    ji, jt = J._build_indexed_materials(coefs, idx, refl, g["shape"][2])
    ti, tt = T._build_indexed_materials(coefs, idx, refl)
    n_rows = 2 * len(mats) if with_reflector else len(mats)
    assert ti.dtype == np.int32 and tt.dtype == np.float32
    assert tt.shape == (6, n_rows)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tt, jt[:6, :n_rows])
    # the JAX table's padding is zero, so the carry-over recovers the table
    assert not jt[6:].any() and not jt[:, n_rows:].any()
    ci, ct = convert.indexed_materials_from_reference(ji, jt)
    np.testing.assert_array_equal(ci, ti)
    np.testing.assert_array_equal(ct, tt)
    # the gathered rows are the expanded (and reflector-folded) volumes
    props = J._material_fields(idx, coefs, has_shear=True)
    if with_reflector:
        J._fold_reflector(props, refl, True)
    for r, k in enumerate(("rho_inv", "pi_u", "mu_u", "c_rp", "c_rs", "b_r")):
        np.testing.assert_array_equal(tt[r][ti], props[k], err_msg=k)


def test_visco_coeffs_reject_index_outside_table():
    idx, mats, g, amp, ph, _ = _indexed_setup()
    coefs = T.sls_coefficients(mats, F0, g["dt"])
    ti, tt = T._build_indexed_materials(coefs, idx, None)
    prof = T._build_cpml_profiles_np(g["shape"], 12, g["dx"], g["dt"], 2494.0,
                                     1e-5)
    with pytest.raises(ValueError, match="outside the table"):
        T.make_visco_coeffs(ti, tt[:, :2], prof, amp, ph, T.FDTDGrid(**g),
                            True, "cpu")


# ---------------------------------------------------------------------------
# run_fdtd on shear media against the JAX XLA solver and the golden
# ---------------------------------------------------------------------------


def test_run_fdtd_shear_matches_jax_xla():
    oj, ot = _slab_runs()
    peak = oj["p_amp"].max()
    assert peak > 0
    # the band JAX holds its plane-source kernels to: atol 1e-4 peak, rtol 1e-3
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-4 * peak,
                               rtol=1e-3)
    np.testing.assert_allclose(ot["peak"], oj["peak"],
                               atol=1e-4 * oj["peak"].max(), rtol=1e-3)
    assert set(ot) == {"p_amp", "p_phase", "peak"}
    assert ot["p_amp"].dtype == np.float32


@pytest.mark.tol_1
def test_run_fdtd_shear_golden():
    _, ot = _slab_runs()
    field = ot["p_amp"]
    gold = np.load(GOLDEN_DIR / "skull_slab_visco.npz")["p_amp_kpa"].astype(
        np.float32
    ) * 1e3
    # tol_1 bounds of tests/test_regression.py:96-116
    l2 = np.linalg.norm(field - gold) / np.linalg.norm(gold)
    linf = np.abs(field - gold).max() / gold.max()
    assert l2 < 0.01, f"L2 {l2:.4f}"
    assert linf < 0.02, f"Linf {linf:.4f}"


# ---------------------------------------------------------------------------
# the plain step against the JAX indexed-material Pallas kernel (B8)
# ---------------------------------------------------------------------------


def test_plain_step_matches_jax_indexed_pallas_interpret():
    idx, mats, g, amp, ph, refl = _indexed_setup()
    coefs = J.sls_coefficients(mats, F0, g["dt"])
    props = J._material_fields(idx, coefs, has_shear=True)
    J._fold_reflector(props, refl, True)
    prof = J._build_cpml_profiles_np(g["shape"], 12, g["dx"], g["dt"], 2494.0,
                                     1e-5)
    mi, mt = J._build_indexed_materials(coefs, idx, refl, g["shape"][2])
    oz = 1.0 / (1000.0 * 1500.0)
    acc_c, acc_s, peak_j = (np.asarray(o) for o in JP.simulate_visco_pallas(
        {k: jnp.asarray(v) for k, v in props.items()},
        jnp.asarray(amp, jnp.float32), jnp.asarray(ph, jnp.float32),
        jnp.float32(0.0), grid=J.FDTDGrid(**g), profiles_np=prof,
        viscous=True, oz_scale=oz, nb=2, interpret=True, fuse_steps=2,
        mat_idx=jnp.asarray(mi), mat_table=jnp.asarray(mt),
    ))

    grid = T.FDTDGrid(**g)
    ti, tt = convert.indexed_materials_from_reference(mi, mt)
    co = T.make_visco_coeffs(ti, tt, T._build_cpml_profiles_np(
        g["shape"], 12, g["dx"], g["dt"], 2494.0, 1e-5), amp, ph, grid,
        coefs["viscous"], "cpu")
    st = V.ViscoState.zeros(g["shape"], 14, "cpu")
    for n in range(grid.n_steps):
        T.visco_step(st, co, grid, n, oz)

    n_win = grid.n_steps - grid.sensor_start

    def amp_of(c, s):
        return 2.0 / n_win * np.sqrt(c**2 + s**2)

    pj = amp_of(acc_c, acc_s)
    pt = amp_of(st.acc_cos.numpy(), st.acc_sin.numpy())
    reg = (slice(2, -2),) * 3
    scale = pj[reg].max()
    assert scale > 0
    # band of tests/test_fused_kernel.py:172-174 (Pallas vs XLA, visco)
    np.testing.assert_allclose(pt[reg], pj[reg], atol=2e-4 * scale, rtol=1e-3)
    np.testing.assert_allclose(st.peak.numpy()[reg], peak_j[reg],
                               atol=2e-4 * peak_j[reg].max(), rtol=1e-3)
    # pressure-release voxels stay silent on both
    assert pt[refl].max() == 0.0 and pj[refl].max() == 0.0


# ---------------------------------------------------------------------------
# stress-point and volumetric sources in shear media
# ---------------------------------------------------------------------------


def _shear_source_config(source):
    """The 48^3 shear dome configuration of
    `tests/test_fused_kernel.py:340-369` (water + a bone slab with shear),
    driven by its hemispherical shell (``velocity_volume``) or by a 50 kPa
    stress point at (24, 22, 40), beyond the slab (``stress_point``)."""
    C = 1500.0
    n = 48
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 2494.0, 0.9)))
    ns = ppp * 3
    g = dict(shape=(n, n, n), dx=dx, dt=1 / F0 / ppp, n_steps=ns,
             frequency=F0, sensor_start=ns - 2 * ppp, source_type=source,
             source_ijk=(24, 22, 40))
    mats = np.array([[1000.0, C, 0.0, 20.0, 0.0],
                     [1896.0, 2494.0, 1500.0, 150.0, 300.0]])
    idx = np.zeros(g["shape"], np.uint8)
    idx[:, :, 30:36] = 1
    kw = {}
    if source == "velocity_volume":
        rng = np.random.default_rng(4)
        ii, jj, kk = np.mgrid[0:n, 0:n, 0:n]
        r = np.sqrt((ii - 24.0) ** 2 + (jj - 24.0) ** 2 + (kk - 24.0) ** 2)
        shell = (r > 14) & (r < 16) & (kk < 24)
        rr = np.maximum(r, 1e-6)
        kw["volume_source"] = dict(
            amp=np.where(shell, 60e3, 0.0).astype(np.float32),
            phase=(rng.uniform(-2, 2, r.shape) * shell).astype(np.float32),
            ox=((24.0 - ii) / rr).astype(np.float32),
            oy=((24.0 - jj) / rr).astype(np.float32),
            oz=((24.0 - kk) / rr).astype(np.float32),
        )
    else:
        kw["point_amp"] = 50e3
    return idx, mats, g, kw


@pytest.mark.parametrize("source", ["stress_point", "velocity_volume"])
def test_shear_sources_match_jax_xla(source):
    idx, mats, g, kw = _shear_source_config(source)
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), backend="xla", **kw)
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    peak = oj["p_amp"].max()
    assert peak > 0
    # the visco plane band: atol 1e-4 peak, rtol 1e-3
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-4 * peak,
                               rtol=1e-3)
    np.testing.assert_allclose(ot["peak"], oj["peak"],
                               atol=1e-4 * oj["peak"].max(), rtol=1e-3)
    # the field crosses the shear slab in both directions
    assert ot["p_amp"][:, :, 30:36].max() > 1e-3 * peak


# ---------------------------------------------------------------------------
# diagnostics in shear media
# ---------------------------------------------------------------------------


def _shear_extras_config():
    """The shear case of `tests/test_fdtd.py:430-452`: 20x20x72 water with
    a 4-cell lossless shear slab at CFL 0.5, a full plane source and one
    monitor in front of the slab; 8 periods instead of 12. The slab crosses
    the CPML, where a mode grows from rounding noise in both packages
    (max p_amp 47.8 kPa at 4 periods, 145.7 kPa at 12, 9.8e9 Pa at 20): at
    12 periods the two runs differ by 0.85% of the peak at the slab, at 8 by
    4e-6."""
    shape = (20, 20, 72)
    dx = 1500.0 / F0 / 9
    ppp = int(np.ceil(1 / F0 / J.stable_dt(dx, 1500.0, 0.5)))
    ns = ppp * 8
    g = dict(shape=shape, dx=dx, dt=1 / F0 / ppp, n_steps=ns, frequency=F0,
             sensor_start=ns - 2 * ppp, source_plane_z=13)
    mats = np.array([[1000.0, 1500.0, 0.0, 0.0, 0.0],
                     [1800.0, 2400.0, 1200.0, 0.0, 0.0]])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 40:44] = 1
    return idx, mats, g, np.full(shape[:2], 60e3)


def test_shear_maps_and_monitor_match_jax_xla():
    """All 14 maps and a monitor in shear media against JAX XLA at the
    visco plane band (1e-4 of each map's maximum, rtol 1e-3), the sample
    times exactly; Pressure is -(sxx+syy+szz)/3, so its peak map is the
    DFT's peak bit for bit."""
    idx, mats, g, amp = _shear_extras_config()
    names = tuple(f"{f}_{k}" for f in ("Pressure", "Vx", "Vy", "Vz",
                                       "Sigmaxx", "Sigmayy", "Sigmazz")
                  for k in ("rms", "peak"))
    kw = dict(source_amp=amp, sel_maps=names,
              monitor_ijk=np.array([[10, 10, 30]]))
    oj = J.run_fdtd(idx, mats, J.FDTDGrid(**g), backend="xla", **kw)
    ot = T.run_fdtd(idx, mats, T.FDTDGrid(**g), device="cpu", **kw)
    assert set(ot) == set(oj)
    for name in names + ("sensor_series",):
        scale = np.abs(oj[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(ot[name], oj[name], atol=1e-4 * scale,
                                   rtol=1e-3, err_msg=name)
    np.testing.assert_array_equal(ot["sensor_times"], oj["sensor_times"])
    np.testing.assert_array_equal(ot["Pressure_peak"], ot["peak"])
    # the normal stresses differ from -p in a shear medium
    assert not np.array_equal(ot["Sigmaxx_peak"], ot["Pressure_peak"])
    pre = slice(22, 36)
    assert (ot["Pressure_rms"][10, 10, pre].mean()
            / ot["p_amp"][10, 10, pre].mean()) == pytest.approx(
                1 / np.sqrt(2), rel=0.08)


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------


def test_cpu_run_counts_plain_calls_not_launches():
    idx, mats, g, amp, _ = _skull_slab_visco()
    g = dict(g, shape=(20, 20, 40), n_steps=12, sensor_start=8)
    for d in (V.launches, V.plain_calls):
        for k in d:
            d[k] = 0
    out = T.run_fdtd(np.zeros(g["shape"], np.uint8) + 2, mats,
                     T.FDTDGrid(**g), source_amp=np.full((20, 20), 1e3),
                     device="cpu")
    assert all(v == 0 for v in V.launches.values())
    assert V.plain_calls == {
        "visco_velocity": 12, "visco_stress": 8, "visco_stress_dft": 4,
        "visco_stress_point": 0, "visco_stress_point_dft": 0,
    }
    assert np.isfinite(out["p_amp"]).all() and out["p_amp"].max() > 0


def test_visco_step_rejects_wrong_inputs():
    shape = (16, 16, 20)
    idx, mats, g, _, _ = _skull_slab_visco()
    g = dict(g, shape=shape)
    coefs = T.sls_coefficients(mats, F0, g["dt"])
    ti, tt = T._build_indexed_materials(coefs, np.full(shape, 2), None)
    prof = T._build_cpml_profiles_np(shape, 12, g["dx"], g["dt"], 2494.0, 1e-5)
    co = T.make_visco_coeffs(ti, tt, prof, np.zeros(shape[:2]),
                             np.zeros(shape[:2]), T.FDTDGrid(**g), True, "cpu")
    st = V.ViscoState.zeros(shape, 14, "cpu")
    st.sxy = st.sxy.double()
    with pytest.raises(ValueError, match="float32"):
        V.visco_velocity(st, co, 0.0, 0.0)
    st = V.ViscoState.zeros(shape, 14, "cpu")
    co.mat_idx = co.mat_idx.long()
    with pytest.raises(ValueError, match="int32"):
        V.visco_stress(st, co)
