"""Port parity: babelbrain_tpu_torch.ops.fdtd against the JAX fluid FDTD.

Host numerics are numpy copies and must be bit-equal. ``run_fdtd`` (CPU,
i.e. the plain PyTorch versions of the fluid-step kernels) is held to the
JAX XLA path at the band the JAX package holds its Pallas kernels to
(`tests/test_fused_kernel.py:61-63`: plane source atol 1e-4 peak, rtol 1e-3;
reflector 1e-5 peak) and to the committed goldens at the tol_1 bounds of
`tests/test_regression.py`.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import map_hu_to_properties
from babelbrain_tpu.ops import fdtd as J
from babelbrain_tpu_torch.ops import fdtd as T
from babelbrain_tpu_torch.ops import fdtd_kernels

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


def test_material_fields_and_reflector_fold_bit_equal():
    idx, mats, g, _, _ = _config("ct_slab_fluid")
    coefs = J.sls_coefficients(mats, F0, g["dt"])
    a = J._material_fields(idx, coefs, has_shear=False)
    b = T._material_fields(idx, coefs, has_shear=False)
    refl = np.random.default_rng(3).random(idx.shape) > 0.9
    J._fold_reflector(a, refl, False)
    T._fold_reflector(b, refl, False)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


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
    }


@pytest.mark.parametrize("case", ["mesh", "sel_maps", "monitor", "stress_point",
                                  "volume", "shear_stress_point"])
def test_paths_outside_the_slice_raise(case):
    idx, mats, g, amp, ph = _config("water_plane")
    g = dict(g, shape=(20, 20, 40), n_steps=4, sensor_start=2)
    kw = {}
    if case == "mesh":
        kw["mesh"] = object()
    elif case == "sel_maps":
        kw["sel_maps"] = ("Pressure_rms",)
    elif case == "monitor":
        kw["monitor_ijk"] = np.zeros((1, 3), int)
    elif case == "stress_point":
        g["source_type"] = "stress_point"
    elif case == "volume":
        g["source_type"] = "velocity_volume"
    else:  # shear media serve plane sources only
        mats = np.array([[1000.0, 1500.0, 0, 0, 0],
                         [1900.0, 2500.0, 1500.0, 100.0, 200.0]])
        g["source_type"] = "stress_point"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        T.run_fdtd(np.zeros(g["shape"], np.uint8), mats, T.FDTDGrid(**g),
                   device="cpu", **kw)
