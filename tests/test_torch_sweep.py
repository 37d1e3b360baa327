"""Port parity of the planning sweep: thermal-profile lists, the case
matrix, the FDTD batch, multipoint steering, the sparse dome
source and the ZTE / PETRA / Density inputs.

Each piece runs in the JAX package (CPU, XLA) and in the port (CPU, the
plain versions of the kernels) on the same seeded inputs:

* ``run_all_combinations`` (`tests/test_bhte.py:183`): ``Index`` equal,
  final temperature and the target's temperature profile within 1e-5 C,
  dose rtol 1e-5 (the bands of `tests/test_torch_bhte.py`), metrics rtol
  1e-5, the same file names and ``_AllCombinations.h5`` keys; the helpers
  give equal results.
* ``run_cases`` with ``run_case`` stubbed (`tests/test_runner.py:611-660`)
  and shape bucketing (`:738`): two near-equal cells count one grid
  signature and one reuse, as JAX's memo counts one build and one hit.
* ``run_fdtd_batch`` (`tests/test_benchmark_multipoint.py:134`) and
  ``run_multipoint`` (`:176`): the plane-source band (1e-4 peak, rtol
  1e-3) against JAX; each batched case bit-equal to the port's own
  ``run_fdtd``, ``fanout=True`` bit-equal to ``fanout=False``.
* ``run_dome_sim`` through the sparse source equals the run through JAX's
  dense dict, bit for bit.
* ZTE, PETRA and Density inputs of ``run_case`` (`runner.py:363-444`):
  the pseudo-CT, the Step-1 outputs and the material table against JAX's
  ``run_case`` (both stopped at ``build_domain``), and the pseudo-CT cache
  reused across two targets.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import material_array as j_material_array
from babelbrain_tpu.ops import fdtd as JF
from babelbrain_tpu.pipeline import acoustic as JA
from babelbrain_tpu.pipeline import domain as JD
from babelbrain_tpu.pipeline import runner as JR
from babelbrain_tpu.pipeline import thermal as JT
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
)
from babelbrain_tpu.tx import make_annular_array
from babelbrain_tpu_torch import convert
from babelbrain_tpu_torch.materials import pseudo_ct as t_pseudo_ct
from babelbrain_tpu_torch.ops import bhte_kernels, fdtd_kernels
from babelbrain_tpu_torch.ops import fdtd as TF
from babelbrain_tpu_torch.parallel.halo import make_mesh_2d
from babelbrain_tpu_torch.pipeline import acoustic as TA
from babelbrain_tpu_torch.pipeline import domain as TD
from babelbrain_tpu_torch.pipeline import io as tio
from babelbrain_tpu_torch.pipeline import runner as TR
from babelbrain_tpu_torch.pipeline import thermal as TT
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
    TransducerSpec as TSpec,
)

torch.set_num_threads(2)

TARGET, DIRECTION = [0, 0, 25], [0, 0, -1]
MASK_SHAPE = (32, 32, 48)


# ---------------------------------------------------------------------------
# thermal profiles
# ---------------------------------------------------------------------------


def _profile_case():
    """The field, labels and two-entry profile of `tests/test_bhte.py:183`."""
    shape = (24, 24, 32)
    mm = np.zeros(shape, np.uint8)
    mm[:, :, 8:10] = 1   # skin
    mm[:, :, 10:12] = 2  # cortical
    mm[:, :, 12:14] = 3  # trabecular
    mm[:, :, 14:] = 4    # brain
    mats = j_material_array(
        5e5, ("Water", "Skin", "Cortical", "Trabecular", "Brain")
    )
    ii, jj, kk = np.mgrid[:24, :24, :32].astype(float)
    blob = np.exp(-(((ii - 12) ** 2 + (jj - 12) ** 2) / 8.0
                    + ((kk - 22) ** 2) / 18.0))
    p = (1e5 * blob).astype(np.float32)
    pw = (1.2e5 * blob).astype(np.float32)
    combos = [
        dict(duration_on=1.0, duration_off=0.5, duty_cycle=0.5, prf=100.0,
             isppa=8.0),
        dict(duration_on=2.0, duration_off=0.5, duty_cycle=0.3, prf=10.0,
             isppa=8.0),
    ]
    return p, pw, mm, mats, combos


def _thermal_files(d):
    return sorted(f for f in os.listdir(d) if "ThermalField-Duration" in f
                  or "_AllCombinations" in f)


@pytest.mark.parametrize("concatenate", [True, False])
def test_run_all_combinations_matches_jax(tmp_path, concatenate):
    p, pw, mm, mats, combos = _profile_case()
    dj, dt = tmp_path / "jax", tmp_path / "port"
    dj.mkdir()
    dt.mkdir()
    args = (p, pw, mm, mats, 1e-3, (12, 12, 22))
    rj, cj = JT.run_all_combinations(
        *args, [JT.SonicationParams(**c) for c in combos],
        out_base=str(dj / "tcase"), concatenate=concatenate,
    )
    rt, ct = TT.run_all_combinations(
        *args, [TT.SonicationParams(**c) for c in combos],
        out_base=str(dt / "tcase"), concatenate=concatenate, device="cpu",
    )
    assert len(rt) == len(rj) == 2
    np.testing.assert_array_equal(ct["Index"], cj["Index"])
    np.testing.assert_allclose(ct["Index"][1], [0.3, 10.0, 2.0, 0.5, 8.0])
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.temperature_end, b.temperature_end,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.dose, b.dose, rtol=1e-5)
        np.testing.assert_allclose(a.monitor[-1], b.monitor[-1], rtol=0,
                                   atol=1e-5)
        assert a.pressure_ratio == pytest.approx(b.pressure_ratio, rel=1e-12)
    assert set(ct["AllData"]) == set(cj["AllData"]) == {"0", "1"}
    for i in ("0", "1"):
        st, sj = ct["AllData"][i], cj["AllData"][i]
        assert set(st) == set(sj)
        for k in ("MaxBrainPressure", "MaxIsppa", "MaxIspta", "TI", "TIC",
                  "TIS", "Isppa", "Ispta", "MI"):
            assert st[k] == pytest.approx(sj[k], rel=1e-5, abs=1e-9), k
        np.testing.assert_allclose(st["TempProfileTarget"],
                                   sj["TempProfileTarget"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(st["TimeProfileTarget"],
                                      sj["TimeProfileTarget"])
    if concatenate:
        # the second run starts from the first's end state
        assert rt[1].monitor[-1][0] > 37.0 + 0.5 * (
            rt[0].monitor[-1][-1] - 37.0) - 0.3
    else:
        assert rt[1].monitor[-1][0] < rt[0].monitor[-1][-1]
    # the same files, and the same keys in the consolidated h5
    files = _thermal_files(dt)
    assert files == _thermal_files(dj)
    assert "tcase_AllCombinations.mat" in files
    assert sum("ThermalField-Duration" in f for f in files) == 2
    bt = tio.load_dict_h5(str(dt / "tcase_AllCombinations.h5"))
    bj = tio.load_dict_h5(str(dj / "tcase_AllCombinations.h5"))
    assert set(bt) == set(bj) >= {"AllData", "Index"}
    per = next(f for f in files if f.endswith("Hz.h5"))
    pt, pj = tio.load_dict_h5(str(dt / per)), tio.load_dict_h5(str(dj / per))
    # the port adds the step of each TemperaturePoints sample (every step on
    # the CPU)
    assert set(pt) == set(pj) | {"TemperaturePointsSteps"}
    np.testing.assert_array_equal(
        pt["TemperaturePointsSteps"],
        np.arange(np.asarray(pt["TemperaturePoints"]).shape[-1]))
    np.testing.assert_allclose(pt["FinalTemp"], pj["FinalTemp"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pt["FinalDose"], pj["FinalDose"], rtol=1e-5)


def test_run_all_combinations_on_cpu_launches_no_kernel():
    p, pw, mm, mats, combos = _profile_case()
    bhte_kernels.launches["bhte_step"] = 0
    bhte_kernels.plain_calls["bhte_step"] = 0
    TT.run_all_combinations(p, pw, mm, mats, 1e-3, (12, 12, 22),
                            [TT.SonicationParams(**combos[0])], device="cpu")
    assert bhte_kernels.launches["bhte_step"] == 0
    # the locating run (100 on) and the schedule (100 on, 50 off)
    assert bhte_kernels.plain_calls["bhte_step"] == 250


def test_bhte_run_leaves_the_initial_temperature_alone():
    """A chained run passes the previous result's temperature as the next
    one's start; on the CPU the loop must not write into that array."""
    from babelbrain_tpu_torch.ops import bhte as TB
    from babelbrain_tpu_torch.materials import build_thermal_material_list

    p, _, mm, mats, _ = _profile_case()
    tm = build_thermal_material_list(mats, ct_mode=False,
                                     segmented_brain=False)
    t0 = np.full(mm.shape, 38.0, np.float32)
    keep = t0.copy()
    res = TB.bhte_run(p * 20, mm, tm, 1e-3, [(0, 5, True)],
                      initial_temperature=t0, device="cpu")
    np.testing.assert_array_equal(t0, keep)
    assert res.temperature.max() > 38.0


@pytest.mark.parametrize("on, off, reps", [(30, 30, 1), (0.5, 0.25, 3),
                                          (2, 0.5, 2)])
def test_thermal_out_name_matches_jax(on, off, reps):
    args = ("/x/case", on, off, 0.3, 10.0, 1500.0, reps)
    assert TT.thermal_out_name(*args) == JT.thermal_out_name(*args)


def _result(mod):
    return mod.ThermalResult(
        temperature_end=np.zeros((2, 2, 2)),
        temperature_peak=np.zeros((2, 2, 2)),
        dose=np.zeros((2, 2, 2)),
        monitor=np.zeros((4, 10)),
        metrics={"TI": 1.5, "TIS": 0.5, "TIC": 2.0, "CEMBrain": 0.1,
                 "CEMSkin": 0.0, "CEMSkull": 0.3, "MI": 0.8,
                 "MaxBrainPressure": 5e5, "MaxIsppa": 10.0,
                 "MaxIspta": 3.0},
        ratio_losses=0.25,
        pressure_ratio=2.0,
    )


def test_summary_csv_matches_jax(tmp_path):
    """`tests/test_bhte.py:157`: the same rows and the same file."""
    kw = dict(duration_on=30, duration_off=30, duty_cycle=0.3, isppa=10.0)
    rows = {}
    for name, mod in (("jax", JT), ("port", TT)):
        row = mod.summary_row(mod.SonicationParams(**kw), _result(mod))
        rows[name] = row
        mod.export_summary_csv(str(tmp_path / f"{name}.csv"), [row, row])
    assert rows["port"] == rows["jax"]
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert "TIC" in text and "0.25" in text and "30" in text
    with open(tmp_path / "port.csv") as f:
        assert len(list(csv.DictReader(f))) == 2


def test_rescale_isppa_and_mat_match_jax(tmp_path):
    """`tests/test_bhte.py:237`, and the MATLAB twin of a thermal dict."""
    from scipy.io import loadmat

    p = np.random.default_rng(1).uniform(0, 1, (3, 4, 5))
    out = TT.rescale_isppa(_result(TT), p, new_isppa=20.0, old_isppa=5.0)
    np.testing.assert_array_equal(
        out, JT.rescale_isppa(_result(JT), p, new_isppa=20.0, old_isppa=5.0))
    np.testing.assert_allclose(out, p * 2.0 * 2.0)
    d = {"Final-Temp": p, "Index": np.arange(5.0), "dt": 0.01}
    TT.save_thermal_mat(str(tmp_path / "t.mat"), d)
    JT.save_thermal_mat(str(tmp_path / "j.mat"), d)
    mt, mj = loadmat(str(tmp_path / "t.mat")), loadmat(str(tmp_path / "j.mat"))
    keys = {k for k in mj if not k.startswith("__")}
    assert keys == {k for k in mt if not k.startswith("__")} == {
        "Final_Temp", "Index", "dt"}
    for k in keys:
        np.testing.assert_array_equal(mt[k], mj[k])


# ---------------------------------------------------------------------------
# case matrix and shape bucketing
# ---------------------------------------------------------------------------


class TestCaseMatrix:
    """Twins of `tests/test_runner.py:611-660`: ``run_cases`` with
    ``run_case`` stubbed out."""

    def test_matrix_naming_and_fanout(self, monkeypatch):
        calls = []

        def fake_run_case(cfg, labels, aff, target, direction, **kw):
            calls.append((cfg.prefix, cfg.frequency, cfg.ppw,
                          tuple(target), cfg.device))
            return {"files": {}, "cached": False}

        monkeypatch.setattr(TR, "run_case", fake_run_case)
        cfg = TR.CaseConfig(prefix="sweep", device="cpu")
        out = TR.run_cases(
            cfg, None, None,
            {"L-thal": (10, 0, 30), "R-thal": (-10, 0, 30)},
            [0, 0, -1],
            frequencies=[250e3, 500e3], ppws=[6],
        )
        assert len(out) == 4
        assert ("L-thal", 250e3, 6.0) in out
        assert {c[0] for c in calls} == {"sweep_L-thal", "sweep_R-thal"}
        assert {c[1] for c in calls} == {250e3, 500e3}
        assert {c[4] for c in calls} == {"cpu"}
        assert out.summary == {"cases": 4, "fdtd_executable_builds": 0,
                               "fdtd_executable_reuses": 0}

    def test_unnamed_targets_and_error_continuation(self, monkeypatch):
        def flaky_run_case(cfg, labels, aff, target, direction, **kw):
            if cfg.prefix.endswith("T0"):
                raise RuntimeError("boom")
            return {"ok": True}

        monkeypatch.setattr(TR, "run_case", flaky_run_case)
        cfg = TR.CaseConfig(prefix="m")
        out = TR.run_cases(cfg, None, None, [(0, 0, 0), (1, 1, 1)],
                           [0, 0, -1])
        assert isinstance(out[("T0", cfg.frequency, cfg.ppw)], RuntimeError)
        assert out[("T1", cfg.frequency, cfg.ppw)] == {"ok": True}
        with pytest.raises(RuntimeError):
            TR.run_cases(cfg, None, None, [(0, 0, 0)], [0, 0, -1],
                         stop_on_error=True)

    def test_summary_belongs_to_the_instance(self):
        a, b = TR.CaseResults(), TR.CaseResults()
        a.summary["cases"] = 3
        assert b.summary == {} and TR.CaseResults().summary == {}


def test_shape_bucket_shares_executable(monkeypatch):
    """Twin of `tests/test_runner.py:738`: two near-equal masks bucket to
    the JAX package's grid, and ``run_cases`` over the two cells counts one
    grid signature and one reuse, where the JAX package compiles one
    executable for that signature and serves the second run from its
    memo."""
    m1 = np.zeros((30, 28, 41), np.uint32)
    m2 = np.zeros((27, 31, 38), np.uint32)
    for m in (m1, m2):
        m[4:-4, 4:-4, 18:24] = 2
        m[m.shape[0] // 2, m.shape[1] // 2, 30] = 5
    doms = {}
    for name, m in (("a", m1), ("b", m2)):
        dj = JD.build_domain(m, 500e3, 6.0, npml=4, shape_bucket=32)
        dt = TD.build_domain(m, 500e3, 6.0, npml=4, shape_bucket=32)
        assert dt.material_map.shape == dj.material_map.shape
        assert dt.n_steps == dj.n_steps
        assert dt.crop(np.zeros(dt.material_map.shape)).shape == m.shape
        doms[name] = dt
        doms[name + "0"] = TD.build_domain(m, 500e3, 6.0, npml=4)
    assert (doms["a"].material_map.shape == doms["b"].material_map.shape
            != doms["a0"].material_map.shape)

    def run_case_on(suffix):
        def fake_run_case(cfg, labels, aff, target, direction, **kw):
            name = cfg.prefix.rsplit("_", 1)[1]
            if name == "cached":  # served from the output cache: no FDTD
                return {"domain": None, "cached": True}
            if name == "failed":
                raise RuntimeError("boom")
            return {"domain": doms[name + suffix], "cached": False}
        return fake_run_case

    targets = {k: (0, 0, 0) for k in ("a", "b", "cached", "failed")}
    cfg = TR.CaseConfig(prefix="mx", device="cpu")
    monkeypatch.setattr(TR, "run_case", run_case_on(""))
    bucketed = TR.run_cases(cfg, None, None, targets, [0, 0, -1])
    assert bucketed.summary == {"cases": 4, "fdtd_executable_builds": 1,
                                "fdtd_executable_reuses": 1}
    monkeypatch.setattr(TR, "run_case", run_case_on("0"))
    assert TR.run_cases(cfg, None, None, targets, [0, 0, -1]).summary == {
        "cases": 4, "fdtd_executable_builds": 2, "fdtd_executable_reuses": 0}

    # the JAX package's memo: one grid signature, one build and one hit (a
    # grid of its own: the memo lives as long as the process, and
    # `tests/test_runner.py:738` counts builds on the (16, 16, 32) grid)
    F0, C = 500e3, 1500.0
    dx = C / F0 / 6
    ppp = int(np.ceil(1 / F0 / JF.stable_dt(dx, C, 0.5)))
    dt = 1 / F0 / ppp
    ns = 2 * ppp
    grid = JF.FDTDGrid(shape=(16, 16, 28), dx=dx, dt=dt, n_steps=ns,
                       frequency=F0, npml=4, sensor_start=ns - ppp,
                       source_plane_z=5)
    mats = np.array([[1000.0, C, 0.0, 0.0, 0.0]])
    amp = np.zeros((16, 16), np.float32)
    amp[4:-4, 4:-4] = 60e3
    idx = np.zeros(grid.shape, np.uint8)
    JF.fdtd_executable_stats(reset=True)
    JF.run_fdtd(idx, mats, grid, source_amp=amp, backend="xla")
    JF.run_fdtd(idx, mats, grid, source_amp=amp * 0.5, backend="xla")
    assert JF.fdtd_executable_stats() == {"builds": 1, "hits": 1}


# ---------------------------------------------------------------------------
# run_fdtd_batch and run_multipoint
# ---------------------------------------------------------------------------


def test_run_fdtd_batch_matches_jax_and_run_fdtd():
    """Twin of `tests/test_benchmark_multipoint.py:134` at 32x32x48, B=3:
    JAX's vmapped batch against the port's cases in turn."""
    shape = (32, 32, 48)
    F0, C = 500e3, 1500.0
    dx = C / F0 / 6
    ppp = int(np.ceil(1 / F0 / TF.stable_dt(dx, 2400.0, cfl=0.9)))
    dt = 1 / F0 / ppp
    nsteps = ppp * 4
    kw = dict(shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0,
              npml=8, sensor_start=nsteps - 2 * ppp, source_plane_z=9)
    mats = np.array([[1000.0, C, 0, 0, 0], [1850.0, 2400.0, 0, 150.0, 0]])
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 28:32] = 1
    rng = np.random.default_rng(3)
    amps = np.zeros((3,) + shape[:2], np.float32)
    amps[:, 10:-10, 10:-10] = 60e3 * rng.uniform(0.3, 1, (3, 12, 12))
    phases = rng.uniform(-3, 3, (3,) + shape[:2]).astype(np.float32)

    bj = JF.run_fdtd_batch(idx, mats, JF.FDTDGrid(**kw), amps, phases)
    bt = TF.run_fdtd_batch(idx, mats, TF.FDTDGrid(**kw), amps, phases,
                           device="cpu")
    assert set(bt) == {"p_amp", "p_phase", "peak"}
    for k in ("p_amp", "peak"):
        assert bt[k].shape == (3,) + shape
        scale = bj[k].max()
        assert scale > 0
        np.testing.assert_allclose(bt[k], bj[k], rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=k)
    for b in range(3):
        single = TF.run_fdtd(idx, mats, TF.FDTDGrid(**kw),
                             source_amp=amps[b], source_phase=phases[b],
                             device="cpu")
        for k in ("p_amp", "p_phase", "peak"):
            np.testing.assert_array_equal(bt[k][b], single[k],
                                          err_msg=f"{k}[{b}]")
    # a mesh that is not a DeviceMesh, and a 2-D mesh, are refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TF.run_fdtd_batch(idx, mats, TF.FDTDGrid(**kw), amps, phases,
                          mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        TF.run_fdtd_batch(idx, mats, TF.FDTDGrid(**kw), amps, phases,
                          mesh=make_mesh_2d(2, 2, devices=["cpu"] * 4),
                          device="cpu")


def test_run_multipoint_matches_jax():
    """Twin of `tests/test_benchmark_multipoint.py:176` (water only) at a
    24x24x40 mask, the rings sampled at 1 point per wavelength: two
    z-steered points of the CTX-500 rings."""
    mask = np.zeros((24, 24, 40), np.uint8)
    mask[6:18, 6:18, 10:30] = 4
    mask[12, 12, 20] = 5
    mats = JD.build_label_materials(500e3, False)[:1]  # water only
    dom_j = JD.build_domain(mask, 500e3, 6.0, materials=mats, water_only=True)
    F = 62.94e-3
    tx_j = make_annular_array(
        500e3, F, [0.0, 31.6988e-3, 44.2688e-3, 53.6688e-3],
        [31.14e-3, 43.71e-3, 53.11e-3, 60.83e-3], 1500.0, ppw_surface=1.0,
    ).translated([0, 0, F])
    tx_j = JA.position_transducer(tx_j, dom_j, F)
    points = [[0, 0, -4e-3], [0, 0, 4e-3]]
    rj, cj = JA.run_multipoint(dom_j, tx_j, points, 60e3, fanout=False)
    dom_t = convert.domain_from_reference(dom_j)
    tx_t = convert.transducer_from_reference(tx_j)
    fdtd_kernels.plain_calls["fluid_velocity"] = 0
    rt, ct = TA.run_multipoint(dom_t, tx_t, points, 60e3, fanout=True,
                               device="cpu")
    assert fdtd_kernels.plain_calls["fluid_velocity"] == 2 * dom_t.n_steps
    rs, cs = TA.run_multipoint(dom_t, tx_t, points, 60e3, fanout=False,
                               device="cpu")
    assert len(rt) == len(rs) == len(rj) == 2
    # fanout=True (run_fdtd_batch) equals the per-point loop bit for bit
    for a, b in zip(rt, rs):
        for k in ("p_amp", "p_complex_re", "p_complex_im", "p_amp_water"):
            np.testing.assert_array_equal(a.data_for_sim[k],
                                          b.data_for_sim[k], err_msg=k)
    for k in ("p_amp_max", "p_amp_all", "steering_targets"):
        np.testing.assert_array_equal(ct[k], cs[k], err_msg=k)
    # against JAX: the plane band
    scale = cj["p_amp_max"].max()
    assert scale > 0
    np.testing.assert_allclose(ct["p_amp_all"], cj["p_amp_all"], rtol=1e-3,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(ct["steering_targets"],
                                  cj["steering_targets"])
    np.testing.assert_array_equal(ct["p_amp_max"],
                                  np.max(ct["p_amp_all"], axis=0))
    for a, b in zip(rt, rj):
        dphi = np.angle(a.phased_array_programming
                        * np.conj(b.phased_array_programming))
        assert np.abs(dphi).max() < 1e-3
    # the two points are steered apart
    assert not np.array_equal(ct["p_amp_all"][0], ct["p_amp_all"][1])
    # the spatial mesh of each point's run_fdtd: not a DeviceMesh, or 2-D
    with pytest.raises(TypeError, match="DeviceMesh"):
        TA.run_multipoint(dom_t, tx_t, points, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        TA.run_multipoint(dom_t, tx_t, points, device="cpu",
                          mesh=make_mesh_2d(2, 2, devices=["cpu"] * 4))


# ---------------------------------------------------------------------------
# the sparse dome source
# ---------------------------------------------------------------------------


def test_run_dome_sim_unchanged_by_the_sparse_source():
    """``run_dome_sim`` (one sparse ``VolumeSource`` for its passes) gives
    the fields of ``run_fdtd`` driven by JAX's dense dict, bit for bit."""
    F = 16e-3
    name = "SweepDome"
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg[name] = spec(name, "dome", diameter=2 * F, focal_length=F,
                         frequencies=(500e3,), n_elements=60,
                         elem_diameter=2.2e-3)
    rng = np.random.default_rng(7)
    b = np.arccos(rng.uniform(0.15, 0.95, 60))
    a = rng.uniform(0, 2 * np.pi, 60)
    centers = np.stack([F * np.sin(b) * np.cos(a), F * np.sin(b) * np.sin(a),
                        -F * np.cos(b)], axis=1)
    mask = np.zeros((24, 24, 40), np.uint8)
    mask[:, :, 30:36] = 1
    mask[:, :, :30] = 4
    mask[12, 12, 12] = 5
    mats = JD.build_label_materials(500e3, False)[:1]
    offsets, shrinks = JD.fit_domain_offsets(
        np.flip(mask, axis=2), 1500.0 / 500e3 / 6.0, 2 * F, F, dome=True)
    dom_j = JD.build_domain(mask, 500e3, 6.0, materials=mats, water_only=True,
                            offsets=offsets, shrink_cells=shrinks)
    dom_j = dataclasses.replace(dom_j, n_steps=120, sensor_start=80)
    from babelbrain_tpu.pipeline.profiles import build_transducer

    tx_j = build_transducer(J_REGISTRY[name], 500e3, elem_centers=centers)
    dom, tx = convert.domain_from_reference(dom_j), \
        convert.transducer_from_reference(tx_j)
    out = TA.run_dome_sim(dom, tx, 60e3, assemble=False, device="cpu")
    u0 = np.full(tx.num_subelements, 60e3, np.complex64)
    dense = JA.make_volume_source(dom_j, tx_j, u0)
    ref = TF.run_fdtd(dom.material_map, dom.materials,
                      TA._make_grid(dom, "velocity_volume"),
                      volume_source=dense, device="cpu")
    for k in ("p_amp", "p_phase", "peak"):
        assert ref[k].max() > 0 or k == "p_phase"
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_volume_source_from_sparse_rejects_bad_input():
    from babelbrain_tpu_torch.ops.fdtd_sources import VolumeSource

    ok = {"index": np.array([0, 5, 63]), "amp": np.ones(3),
          "phase": np.zeros(3), "ox": np.zeros(3), "oy": np.zeros(3),
          "oz": np.ones(3)}
    vs = VolumeSource.from_sparse(ok, (4, 4, 4), "cpu")
    assert vs.n_src == 3 and vs.index.dtype == torch.int32
    with pytest.raises(ValueError, match="outside the grid"):
        VolumeSource.from_sparse(dict(ok, index=np.array([0, 5, 64])),
                                 (4, 4, 4), "cpu")
    with pytest.raises(ValueError, match="'amp' has shape"):
        VolumeSource.from_sparse(dict(ok, amp=np.ones(2)), (4, 4, 4), "cpu")


# ---------------------------------------------------------------------------
# ZTE / PETRA / Density inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def head():
    """The sphere head of `tests/test_torch_pipeline.py` (4 mm voxels) and a
    MiniTest bowl in both registries."""
    n = 48
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    aff[:3, 3] = -96.0
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n]
    r = np.linalg.norm(np.stack([ii, jj, kk], -1) * 4.0 - 96.0, axis=-1)
    labels = np.zeros((n, n, n), np.int32)
    labels[r < 46] = 5
    labels[r < 42] = 7
    labels[r < 39] = 4
    labels[r < 36] = 2
    labels[r < 25] = 1
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg["MiniTest"] = spec("MiniTest", "single", diameter=20e-3,
                               focal_length=25e-3, frequencies=(500e3,))
    return labels, aff


def _image(labels, ct_type):
    """A synthetic MRI (`tests/test_runner.py:301-316`: bright soft tissue,
    dark bone, dark background; integer-valued for PETRA's histogram) or a
    density map (`:329-331`)."""
    bone = labels == 2  # as there: inside the head's 3-voxel erosion
    if ct_type == "Density":
        return np.where(bone, 1900.0, 1000.0)
    rng = np.random.default_rng(0)
    img = np.full(labels.shape, 30.0)
    img[labels > 0] = 1000.0
    img[bone] = 350.0
    return np.round(img + rng.normal(0, 5, labels.shape))


class _Stop(Exception):
    pass


def _step1_of(runner_mod, monkeypatch, cfg, labels, aff, image, **kw):
    """``run_case`` up to ``build_domain``: (mask, CT index, material
    table) that Step 1 and the material build gave it."""
    seen = {}

    def stop(mask, *a, **k):
        seen.update(mask=np.asarray(mask), ct_index=k["ct_index_map"],
                    materials=np.asarray(k["materials"]))
        raise _Stop

    monkeypatch.setattr(runner_mod, "build_domain", stop)
    with pytest.raises(_Stop):
        runner_mod.run_case(cfg, labels, aff, TARGET, DIRECTION,
                            ct_data=image, ct_affine=aff,
                            mask_shape=MASK_SHAPE, **kw)
    return seen


def _resample64(volume, from_affine, to_affine, to_shape):
    """The order-3 resample of ``ops.imaging`` (zero padding of 8 voxels,
    B-spline prefilter, grid-constant) in float64 throughout."""
    import scipy.ndimage as ndi

    pad = 8
    coeff = ndi.spline_filter(np.pad(np.asarray(volume, np.float64), pad),
                              order=3)
    m = np.linalg.inv(from_affine) @ to_affine
    src = (m[:3, :3] @ np.indices(to_shape).reshape(3, -1)
           + (m[:3, 3] + pad)[:, None])
    base = np.floor(src).astype(np.int64)
    w = [[wk / 6.0 for wk in ((1 - t) ** 3, 4 - 6 * t ** 2 + 3 * t ** 3,
                              1 + 3 * t + 3 * t ** 2 - 3 * t ** 3, t ** 3)]
         for t in src - base]  # per axis, the four B-spline weights
    out = np.zeros(src.shape[1])
    for a in range(4):
        for b in range(4):
            for c in range(4):
                ijk = base + np.array([a - 1, b - 1, c - 1])[:, None]
                ok = np.all((ijk >= 0)
                            & (ijk < np.array(coeff.shape)[:, None]), axis=0)
                val = coeff[tuple(np.where(ok, ijk, 0))]
                out += w[0][a] * w[1][b] * w[2][c] * np.where(ok, val, 0.0)
    return out.reshape(to_shape)


def _record_quantize(step1_mod, monkeypatch, seen):
    """Record the HU volume and bone mask that Step 1 quantises."""
    real = step1_mod.quantize_hu

    def rec(hu, bone, **kw):
        seen.update(hu=np.asarray(hu), bone=np.asarray(bone))
        return real(hu, bone, **kw)

    monkeypatch.setattr(step1_mod, "quantize_hu", rec)


def _explain_index_differences(sj, st, s64):
    """Step 1's HU volumes of JAX (``sj``) and the port (``st``) agree to
    float32 rounding, and every voxel whose CT index differs is explained:
    the two values straddle the bin edge between neighbouring indices, and
    the float64 reference (``s64``) puts the voxel within the float32
    computations' own error of that edge, so the bin is not decided at
    float32 precision, on either side."""
    np.testing.assert_allclose(st["hu"], sj["hu"], rtol=2e-6, atol=1e-3)
    bone = sj["bone"]
    err = max(np.abs(o["hu"] - s64["hu"])[bone].max() for o in (sj, st))
    vals = sj["hu"][bone].astype(np.float64)
    edges = np.linspace(vals.min(), vals.max(), 1023)  # quantize_hu's
    for v in map(tuple, np.argwhere(st["ct_index"] != sj["ct_index"])):
        hj, ht, h64 = (float(o["hu"][v]) for o in (sj, st, s64))
        edge = edges[np.searchsorted(edges, max(hj, ht), side="left") - 1]
        what = (f"voxel {v}: index {sj['ct_index'][v]} (JAX) vs "
                f"{st['ct_index'][v]}, HU {hj} / {ht} / {h64} (float64) "
                f"about the edge {edge}, float32 error {err}")
        assert abs(int(st["ct_index"][v]) - int(sj["ct_index"][v])) == 1, what
        assert min(hj, ht) <= edge <= max(hj, ht), what
        assert abs(h64 - edge) <= err, what


@pytest.mark.parametrize("ct_type", ["ZTE", "PETRA", "Density"])
def test_mri_and_density_inputs_match_jax(head, tmp_path, monkeypatch,
                                          ct_type):
    from babelbrain_tpu.pipeline import step1 as JS1
    from babelbrain_tpu_torch.materials.ct_mapping import quantize_hu
    from babelbrain_tpu_torch.ops import imaging as tim
    from babelbrain_tpu_torch.pipeline import step1 as TS1

    labels, aff = head
    image = _image(labels, ct_type)
    out = {}
    for name, mod, s1, extra in (("jax", JR, JS1, {}),
                                 ("port", TR, TS1, {"device": "cpu"}),
                                 ("f64", TR, TS1, {"device": "cpu"})):
        d = tmp_path / name
        cfg = mod.CaseConfig(tx_system="MiniTest", ct_type=ct_type,
                             output_dir=str(d), prefix="mri", **extra)
        q = {}
        _record_quantize(s1, monkeypatch, q)
        if name == "f64":
            # the port's Step 1 with the CT resample in float64
            real = tim.resample_from_to

            def resample(vol, a_from, a_to, shape, order=1, *, device="cuda"):
                if order == 3:
                    return _resample64(vol, a_from, a_to, shape)
                return real(vol, a_from, a_to, shape, order, device=device)

            monkeypatch.setattr(tim, "resample_from_to", resample)
        out[name] = _step1_of(mod, monkeypatch, cfg, labels, aff, image)
        out[name].update(dir=d, **q)
    sj, st, s64 = out["jax"], out["port"], out["f64"]
    np.testing.assert_array_equal(st["mask"], sj["mask"])
    np.testing.assert_array_equal(st["bone"], sj["bone"])
    # the quantiser gives JAX's index from JAX's HU volume: a difference in
    # the index comes from the HU volume alone
    np.testing.assert_array_equal(quantize_hu(sj["hu"], sj["bone"])[1],
                                  sj["ct_index"])
    # The HU volumes differ by the float32 rounding of the cubic resample
    # (XLA fuses the B-spline weights; ROADMAP Queue C): 2 voxels for ZTE,
    # 3 for Density here move into the neighbouring HU bin.
    _explain_index_differences(sj, st, s64)
    hu_j = np.load(next(sj["dir"].glob("*_CT-cal.npz")))["UniqueHU"]
    hu_t = np.load(next(st["dir"].glob("*_CT-cal.npz")))["UniqueHU"]
    np.testing.assert_allclose(hu_t, hu_j, rtol=1e-7)
    np.testing.assert_allclose(st["materials"], sj["materials"], rtol=1e-6)
    assert st["materials"].shape[0] > 4  # CT mode: per-HU materials
    if ct_type == "Density":
        # densities pass through as material densities (kg/m3 above the
        # 1200 bone threshold, not HU-like numbers)
        assert 1200.0 < st["materials"][:, 0].max() <= 1900.0
        assert not list(st["dir"].glob("pseudoCT_*.h5"))
    else:
        # the pseudo-CT itself, and its bone band
        pj = JR.pio.load_dict_h5(str(next(sj["dir"].glob("pseudoCT_*.h5"))))
        pt = tio.load_dict_h5(str(next(st["dir"].glob("pseudoCT_*.h5"))))
        np.testing.assert_array_equal(pt["pct"], pj["pct"])
        np.testing.assert_array_equal(pt["affine"], pj["affine"])
        assert hu_t.min() >= 300.0 and hu_t.max() <= 2100.0


def test_pseudo_ct_reused_across_targets(head, tmp_path, monkeypatch):
    """Twin of `tests/test_runner.py:341`: a second target on the same
    anatomy reads the ``pseudoCT_<hash>.h5`` of the first."""
    labels, aff = head
    calls = {"n": 0}
    real = t_pseudo_ct.mri_to_pseudo_ct

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(t_pseudo_ct, "mri_to_pseudo_ct", counting)
    zte = _image(labels, "ZTE")
    first = None
    for prefix, target in (("tgtA", TARGET), ("tgtB", [0, 4, 25])):
        cfg = TR.CaseConfig(tx_system="MiniTest", ct_type="ZTE",
                            output_dir=str(tmp_path), prefix=prefix,
                            device="cpu")
        seen = {}

        def stop(mask, *a, **k):
            seen["ct_index"] = k["ct_index_map"]
            raise _Stop

        monkeypatch.setattr(TR, "build_domain", stop)
        with pytest.raises(_Stop):
            TR.run_case(cfg, labels, aff, target, DIRECTION, ct_data=zte,
                        ct_affine=aff, mask_shape=MASK_SHAPE)
        assert calls["n"] == 1
        assert len(list(tmp_path.glob("pseudoCT_*.h5"))) == 1
        first = first if first is not None else seen["ct_index"]
    assert seen["ct_index"].shape == first.shape


def test_run_case_runs_a_thermal_profile(head, tmp_path):
    """``run_case`` with a list of profile entries (`runner.py:777-798`):
    one BHTE run per entry, the per-entry ThermalField files and
    ``<base>_AllCombinations.h5`` / ``.mat``; the case's thermal result is
    the last entry's."""
    labels, aff = head
    ct = np.where(np.isin(labels, [4, 7]), 1500.0, 40.0)
    cfg = TR.CaseConfig(tx_system="MiniTest", output_dir=str(tmp_path),
                        prefix="prof", device="cpu")
    profile = [TT.SonicationParams(duration_on=0.2, duration_off=0.1,
                                   duty_cycle=dc, isppa=5.0)
               for dc in (0.1, 0.3)]
    bhte_kernels.plain_calls["bhte_step"] = 0
    res = TR.run_case(cfg, labels, aff, TARGET, DIRECTION, ct_data=ct,
                      ct_affine=aff, mask_shape=MASK_SHAPE,
                      thermal_params=profile)
    # per entry: the locating run (20 on) and the schedule (20 on, 10 off)
    assert bhte_kernels.plain_calls["bhte_step"] == 2 * 50
    assert res["thermal"].metrics["Ispta"] == pytest.approx(5.0 * 0.3)
    base = res["files"]["acoustic"].replace("_DataForSim.h5", "")
    for ext in (".h5", ".mat"):
        assert os.path.isfile(base + "_AllCombinations" + ext)
    per = [f for f in os.listdir(tmp_path) if "ThermalField-Duration" in f]
    assert sorted(per) == sorted(
        os.path.basename(TT.thermal_out_name(base, 0.2, 0.1, dc, 5.0, 1500.0,
                                             1)) + ".h5"
        for dc in (0.1, 0.3))
    blob = tio.load_dict_h5(base + "_AllCombinations.h5")
    np.testing.assert_allclose(blob["Index"][:, 0], [0.1, 0.3])
