"""``pipeline.benchmark`` of the port against the JAX package (CPU).

* the four ``TestBenchmarkFile`` cases of `tests/test_benchmark_multipoint.py`
  on the same 40x40x120 benchmark file: the load, the acoustic run (the
  plane-source band of `tests/test_torch_fdtd.py`: 1e-4 of the peak plus
  rtol 1e-3, and the JAX test's own assertions), the QCorr scaling (and its
  error) and the thermal regions;
* ``solid_layer_transmission`` equal to JAX's within 1e-12 over angles that
  cross the longitudinal and shear critical angles;
* the ``TestAnalyticLayer`` cases of `tests/test_shear_anchor.py` on the
  port's function (the FDTD anchors themselves run on the card in
  ``chip_smoke.py``'s anchors slice).
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu.pipeline import benchmark as JB
from babelbrain_tpu.pipeline.io import load_dict_h5, save_dict_h5
from babelbrain_tpu_torch.pipeline import benchmark as TB

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
FLUID = (1000.0, C)
SOLID = (1896.5, 2494.0, 1400.0)
DX = C / F0 / 9
SHAPE = (40, 40, 120)


@pytest.fixture(scope="module")
def bench_file(tmp_path_factory):
    """The `tests/test_benchmark_multipoint.py:20` benchmark file."""
    mm = np.zeros(SHAPE, np.uint32)
    mm[:, :, 60:70] = 1  # slab of material 1
    mm[:, :, 70:] = 2
    data = {
        "TestType": 2,
        "MaterialMap": mm,
        "Materials": [
            {"Density": 1000.0, "LongSoS": 1500.0, "ShearSoS": 0.0,
             "LongAtt": 0.0, "ShearAtt": 0.0, "SpecificHeat": 4178.0,
             "Conductivity": 0.6, "Perfusion": 0.0, "Absorption": 0.0},
            {"Density": 1850.0, "LongSoS": 2400.0, "ShearSoS": 0.0,
             "LongAtt": 150.0, "ShearAtt": 0.0, "SpecificHeat": 1700.0,
             "Conductivity": 0.32, "Perfusion": 20.0, "Absorption": 0.16},
            {"Density": 1041.0, "LongSoS": 1562.0, "ShearSoS": 0.0,
             "LongAtt": 4.0, "ShearAtt": 0.0, "SpecificHeat": 3630.0,
             "Conductivity": 0.51, "Perfusion": 559.0, "Absorption": 0.85},
        ],
    }
    d = tmp_path_factory.mktemp("bench")
    f = str(d / "bench.h5")
    save_dict_h5(data, f)
    data["QCorrArr"] = np.array([1.0, 2.0, 1.0])
    fq = str(d / "bench_q.h5")
    save_dict_h5(data, fq)
    data["QCorrArr"] = np.array([1.0, 2.0])
    fbad = str(d / "bench_qbad.h5")
    save_dict_h5(data, fbad)
    return f, fq, fbad


def _plane():
    amp = np.zeros(SHAPE[:2])
    amp[14:-14, 14:-14] = 60e3
    return amp, np.zeros(SHAPE[:2])


@pytest.fixture(scope="module")
def runs(bench_file):
    """The acoustic runs of both packages on the plain and the
    Q-corrected file (9 PPW, as the JAX tests run them)."""
    f, fq, _ = bench_file
    out = {}
    for name, path in (("base", f), ("q", fq)):
        out["jax", name] = JB.run_benchmark_acoustic(path, 500e3, 9.0,
                                                     *_plane())
        out["port", name] = TB.run_benchmark_acoustic(path, 500e3, 9.0,
                                                      *_plane(), device="cpu")
    return out


def test_load_matches_jax(bench_file):
    f, _, _ = bench_file
    bj, bt = JB.load_benchmark_file(f), TB.load_benchmark_file(f)
    assert bt["MaterialArray"].shape == (3, 5)
    assert bt["MaterialArray"][1, 1] == 2400.0
    assert bt["TestType"] == 2
    np.testing.assert_array_equal(bt["MaterialArray"], bj["MaterialArray"])
    np.testing.assert_array_equal(bt["MaterialMap"], bj["MaterialMap"])
    assert bt.keys() == bj.keys()


@pytest.mark.parametrize("which", ["base", "q"])
def test_acoustic_run_matches_jax(runs, which):
    oj, ot = runs["jax", which], runs["port", which]
    assert vars(ot["grid"]) == vars(oj["grid"])
    np.testing.assert_array_equal(ot["benchmark"]["MaterialArray"],
                                  oj["benchmark"]["MaterialArray"])
    peak = oj["p_amp"].max()
    np.testing.assert_allclose(ot["p_amp"], oj["p_amp"], atol=1e-4 * peak,
                               rtol=1e-3)
    # the JAX test's assertions, on the port's run
    pa = ot["p_amp"]
    assert np.isfinite(pa).all()
    line = pa[20, 20, :]
    if which == "base":
        assert line[30:55].mean() > 30e3
        assert line[80:100].mean() < line[30:55].mean()
        assert line[80:100].mean() > 0.05 * 60e3


def test_qcorr_scales_attenuation(runs, bench_file):
    """Doubling the slab's Q correction reduces the transmitted amplitude
    in the port as in the JAX package; a QCorrArr of the wrong length
    raises in both."""
    t = {pkg: runs[pkg, "q"]["p_amp"][20, 20, 80:100].mean()
         / runs[pkg, "base"]["p_amp"][20, 20, 80:100].mean()
         for pkg in ("jax", "port")}
    assert t["port"] < 0.8
    assert t["port"] == pytest.approx(t["jax"], rel=1e-3)
    np.testing.assert_array_equal(
        runs["port", "q"]["benchmark"]["MaterialArray"][:, 3],
        [0.0, 300.0, 4.0])
    _, _, fbad = bench_file
    for run in (JB.run_benchmark_acoustic, TB.run_benchmark_acoustic):
        kw = {} if run is JB.run_benchmark_acoustic else {"device": "cpu"}
        with pytest.raises(ValueError, match="QCorrArr"):
            run(fbad, 500e3, 9.0, *_plane(), **kw)


def test_thermal_regions_match_jax(bench_file):
    f, _, _ = bench_file
    mm = np.asarray(load_dict_h5(f)["MaterialMap"])
    for test_type in (1, 2, 3):
        skull_j, ids_j, reg_j = JB.thermal_benchmark_regions(mm, test_type)
        skull_t, ids_t, reg_t = TB.thermal_benchmark_regions(mm, test_type)
        np.testing.assert_array_equal(skull_t, skull_j)
        assert (ids_t, reg_t) == (ids_j, reg_j)
    skull, brain_ids, region = TB.thermal_benchmark_regions(mm, 2)
    assert skull.sum() == (mm == 1).sum()
    assert brain_ids == [2] and region == [0, 1]
    with pytest.raises(ValueError, match="TestType"):
        TB.thermal_benchmark_regions(mm, 4)


# a second solid whose shear speed exceeds the water's: both critical
# angles (longitudinal 32.4 deg, shear 69.6 deg) lie inside the sweep
FAST_SOLID = (1850.0, 2800.0, 1600.0)


@pytest.mark.parametrize("solid", [SOLID, FAST_SOLID, (1896.5, 2494.0, 1e-6)])
def test_solid_layer_transmission_matches_jax(solid):
    """Every degree from 0 to 89 at three thicknesses (a layer of zero
    thickness makes the two interfaces' shear-stress rows equal: solvable
    only where rounding separates them, as at the 0.4 rad of
    ``TestAnalyticLayer``)."""
    for theta in np.deg2rad(np.linspace(0.0, 89.0, 90)):
        for d in (6 * DX, 2.6e-3, 10 * DX):
            args = (theta, F0, d, FLUID, solid)
            tj, rj = JB.solid_layer_transmission(*args)
            tt, rt = TB.solid_layer_transmission(*args)
            assert abs(tt - tj) <= 1e-12 and abs(rt - rj) <= 1e-12, (
                np.rad2deg(theta), d)


class TestAnalyticLayer:
    """`tests/test_shear_anchor.py:48`'s self-checks of the analytic truth,
    on the port's copy."""

    def test_energy_conservation(self):
        for th in np.deg2rad([0, 10, 25, 40, 60]):
            T, R = TB.solid_layer_transmission(th, F0, 2.6e-3, FLUID, SOLID)
            assert abs(abs(R) ** 2 + abs(T) ** 2 - 1.0) < 1e-9

    def test_reduces_to_classic_normal_incidence(self):
        d = 2.6e-3
        rho1, c1 = FLUID
        rho, cL, _ = SOLID
        Z1, ZL = rho1 * c1, rho * cL
        kLd = 2 * np.pi * F0 / cL * d
        classic = 1.0 / np.sqrt(
            1 + 0.25 * (ZL / Z1 - Z1 / ZL) ** 2 * np.sin(kLd) ** 2
        )
        T, _ = TB.solid_layer_transmission(0.0, F0, d, FLUID, SOLID)
        assert abs(abs(T) - classic) < 1e-12

    def test_transparent_at_zero_thickness(self):
        T, R = TB.solid_layer_transmission(0.4, F0, 0.0, FLUID, SOLID)
        assert abs(abs(T) - 1.0) < 1e-9 and abs(R) < 1e-9

    def test_mode_conversion_discriminates(self):
        th = np.deg2rad(25.0)
        Te = abs(TB.solid_layer_transmission(th, F0, 6 * DX, FLUID, SOLID)[0])
        Tf = abs(TB.solid_layer_transmission(
            th, F0, 6 * DX, FLUID, (SOLID[0], SOLID[1], 1e-6))[0])
        assert Te > 0.9 and Tf < 0.55
