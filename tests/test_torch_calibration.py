"""``pipeline.calibration`` of the port against the JAX package (CPU).

* ``element_field_matrix`` and ``fit_element_weights`` on the annular array
  and scan plane of `tests/test_pipeline.py::TestCalibration`: the matrix
  within 1e-3 of its largest entry (the band of the port's Rayleigh against
  JAX's), the weights within that test's tolerance of the truth and of
  JAX's fit (also phase-only);
* ``scan_plane_points`` and the CSV profile round trip of
  `tests/test_pipeline.py::TestCalibrationIngestion` equal to JAX's; xlsx
  without openpyxl raises in both;
* ``calibrate_annular_from_profiles`` on a small three-ring array with
  profiles made from known ring weights, and ``run_calibration`` from a
  YAML file: the weights recovered at the JAX test's tolerance, and equal
  to JAX's fit within 1e-3. The CTX-500 at its full sub-element count runs
  on the card (``chip_smoke.py``'s anchors slice).
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import expand_element_weights as j_expand
from babelbrain_tpu.ops import rayleigh_field as j_rayleigh
from babelbrain_tpu.pipeline import calibration as JC
from babelbrain_tpu.pipeline.io import load_dict_h5 as j_load_h5
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
)
from babelbrain_tpu.tx import make_annular_array as j_annular
from babelbrain_tpu_torch.pipeline import calibration as TC
from babelbrain_tpu_torch.pipeline.io import load_dict_h5 as t_load_h5
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
    TransducerSpec as TSpec,
)
from babelbrain_tpu_torch.tx import make_annular_array as t_annular

torch.set_num_threads(2)

F0, C = 500e3, 1500.0
K = 2 * np.pi * F0 / C
RINGS = dict(in_d=[0.0, 31.6988e-3, 44.2688e-3, 53.6688e-3],
             out_d=[31.14e-3, 43.71e-3, 53.11e-3, 60.83e-3])


def _ring_tx(make):
    """The `tests/test_pipeline.py:565` four-ring array (3 PPW)."""
    return make(F0, 62.94e-3, RINGS["in_d"], RINGS["out_d"], C,
                ppw_surface=3).translated([0, 0, 62.94e-3])


@pytest.fixture(scope="module")
def scan():
    """The JAX test's synthetic measurement: known ring weights, a 21x21
    scan plane at 30 mm."""
    tx = _ring_tx(j_annular)
    rng = np.random.default_rng(11)
    w_true = rng.uniform(0.6, 1.1, 4) * np.exp(1j * rng.uniform(-1, 1, 4))
    u0 = j_expand(tx, w_true.astype(np.complex64))
    pts = JC.scan_plane_points(np.linspace(-20, 20, 21),
                               np.linspace(-20, 20, 21), 30e-3)
    measured = np.asarray(j_rayleigh(K, tx.centers, tx.areas, u0, pts))
    return w_true, pts, measured


def test_scan_plane_points_match_jax():
    args = (np.linspace(-20, 20, 21), np.linspace(-10, 10, 11), 30e-3)
    np.testing.assert_array_equal(TC.scan_plane_points(*args),
                                  JC.scan_plane_points(*args))


def test_element_field_matrix_matches_jax(scan):
    _, pts, _ = scan
    aj = JC.element_field_matrix(K, _ring_tx(j_annular), pts)
    at = TC.element_field_matrix(K, _ring_tx(t_annular), pts, device="cpu")
    assert at.shape == aj.shape == (len(pts), 4) and at.dtype == np.complex64
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-3 * np.abs(aj).max())


@pytest.mark.parametrize("phase_only", [False, True])
def test_fit_element_weights_matches_jax(scan, phase_only):
    w_true, pts, measured = scan
    wj, rj = JC.fit_element_weights(K, _ring_tx(j_annular), pts, measured,
                                    lam=1e-4, phase_only=phase_only)
    wt, rt = TC.fit_element_weights(K, _ring_tx(t_annular), pts, measured,
                                    lam=1e-4, phase_only=phase_only,
                                    device="cpu")
    assert wt.dtype == np.complex64 and wt.shape == (4,)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-3)
    assert rt == pytest.approx(rj, abs=1e-3)
    if phase_only:
        np.testing.assert_allclose(np.abs(wt), 1.0, rtol=1e-6)
        return
    # the JAX test's tolerance against the truth
    ratio = np.asarray(wt, np.complex128) / wt[0]
    np.testing.assert_allclose(ratio, w_true / w_true[0], atol=0.03)
    assert rt < 0.02


def _write_csv(path, z_mm, locs, cols):
    rows = [",".join(["0"] + [f"{v}" for v in locs])]
    for i, zz in enumerate(z_mm):
        rows.append(",".join([f"{zz}"] + [f"{c[i]}" for c in cols]))
    path.write_text("\n".join(rows))


def test_csv_profile_round_trip_matches_jax(tmp_path):
    z = np.arange(30.0, 80.0, 2.0)
    locs = np.array([40.0, 55.0, 70.0])
    vals = np.outer(np.hanning(len(z)), [1.0, 1.2, 0.8]) * 1e5
    p = tmp_path / "profiles.csv"
    _write_csv(p, z, locs, vals.T)
    zt, lt, vt = TC.load_hydrophone_profiles(p)
    np.testing.assert_allclose(zt, z)
    np.testing.assert_allclose(lt, locs)
    np.testing.assert_allclose(vt, vals)
    for a, b in zip((zt, lt, vt), JC.load_hydrophone_profiles(p)):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.csv").write_text("1,2,3\n")
    with pytest.raises(ValueError, match="header row"):
        TC.load_hydrophone_profiles(tmp_path / "bad.csv")


def test_xlsx_needs_openpyxl(tmp_path, monkeypatch):
    """Neither machine has openpyxl: an .xlsx asks for a CSV export in the
    port as in the JAX package (the import stays inside the function)."""
    import builtins

    real_import = builtins.__import__

    def no_openpyxl(name, *args, **kw):
        if name == "openpyxl":
            raise ImportError("no openpyxl")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_openpyxl)
    for load in (JC.load_hydrophone_profiles, TC.load_hydrophone_profiles):
        with pytest.raises(ImportError, match="export the sheet to CSV"):
            load(tmp_path / "profiles.xlsx")


# a three-ring bowl registered in both packages for the profile fits (the
# MiniRing of `tests/test_runner.py:512` under a name of its own)
SPEC = dict(kind="annular", diameter=20e-3, focal_length=25e-3,
            frequencies=(500e3,), in_diameters=(0.0, 10.5e-3, 15.5e-3),
            out_diameters=(10e-3, 15e-3, 20e-3),
            steering_range={"tpo_min": 10e-3, "tpo_max": 40e-3},
            meta={"natural_outplane": 21e-3})
W_TRUE = np.array([1.15, 0.85 * np.exp(0.25j), 0.9 * np.exp(-0.2j)],
                  np.complex64)
Z_MM = np.arange(12.0, 40.0, 1.0)
LOCS = [20.0, 30.0]


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    """Amplitude and phase profiles of the bowl steered to each location
    with ``W_TRUE`` on top (the JAX package's Rayleigh), as CSV files, and
    the bowl in both registries."""
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg["CalibRing"] = spec("CalibRing", **SPEC)
    from babelbrain_tpu.ops.rayleigh import steering_phases
    from babelbrain_tpu.pipeline.profiles import build_transducer

    spec = J_REGISTRY["CalibRing"]
    tx = build_transducer(spec, F0, sos_water=C)
    outplane = spec.meta["natural_outplane"]
    amp, ph = [], []
    for loc in LOCS:
        w_steer = steering_phases(K, JC._ring_centers(tx),
                                  [0.0, 0.0, loc * 1e-3 - outplane])
        u0 = JC._expand_ring_weights(tx, w_steer * W_TRUE)
        pts = np.zeros((len(Z_MM), 3), np.float32)
        pts[:, 2] = Z_MM * 1e-3 - outplane
        f = np.asarray(j_rayleigh(K, tx.centers, tx.areas, u0, pts))
        amp.append(np.abs(f))
        ph.append(np.angle(f))
    d = tmp_path_factory.mktemp("calib")
    _write_csv(d / "amp.csv", Z_MM, LOCS, amp)
    _write_csv(d / "phase.csv", Z_MM, LOCS, ph)
    return d


def _aligned(w):
    """``w`` with ring 0's phase set to the truth's (the global phase is
    unobservable)."""
    w = np.asarray(w, np.complex128)
    return w * np.exp(1j * (np.angle(W_TRUE[0]) - np.angle(w[0])))


def _check_recovered(w, residual):
    """The JAX test's tolerance (`tests/test_pipeline.py:770-777`)."""
    w = _aligned(w)
    np.testing.assert_allclose(np.abs(w), np.abs(W_TRUE), rtol=0.05)
    np.testing.assert_allclose(np.angle(w / W_TRUE), 0.0, atol=0.08)
    assert residual < 0.05


def test_calibrate_annular_from_profiles_matches_jax(profiles):
    z, locs, amp = TC.load_hydrophone_profiles(profiles / "amp.csv")
    _, _, ph = TC.load_hydrophone_profiles(profiles / "phase.csv")
    kw = dict(lam=1e-6, sos_water=C)
    fj = JC.calibrate_annular_from_profiles(J_REGISTRY["CalibRing"], F0, z,
                                            locs, amp, ph, **kw)
    ft = TC.calibrate_annular_from_profiles(T_REGISTRY["CalibRing"], F0, z,
                                            locs, amp, ph, device="cpu", **kw)
    assert sorted(ft) == sorted(fj) == LOCS
    for loc in LOCS:
        _check_recovered(ft[loc]["weights"], ft[loc]["residual"])
        np.testing.assert_allclose(ft[loc]["weights"], fj[loc]["weights"],
                                   rtol=0, atol=1e-3)
    # without a phase scan the model's phase is the target: the fit stays
    # near the steered drive, in both
    fj = JC.calibrate_annular_from_profiles(J_REGISTRY["CalibRing"], F0, z,
                                            locs, amp, **kw)
    ft = TC.calibrate_annular_from_profiles(T_REGISTRY["CalibRing"], F0, z,
                                            locs, amp, device="cpu", **kw)
    for loc in LOCS:
        np.testing.assert_allclose(ft[loc]["weights"], fj[loc]["weights"],
                                   rtol=0, atol=1e-3)


def test_run_calibration_matches_jax(profiles, tmp_path):
    import yaml

    written = {}
    for name, run, kw in (("jax", JC.run_calibration, {}),
                          ("port", TC.run_calibration, {"device": "cpu"})):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump({
            "TxSystem": "CalibRing", "Frequency": F0,
            "ExcelFileProfiles": str(profiles / "amp.csv"),
            "ExcelFilePhase": str(profiles / "phase.csv"),
            "Lambda": 1e-6, "OutputResultsPath": str(tmp_path / name),
        }))
        written[name] = sorted(run(str(cfg), **kw))
    assert [p.rsplit("/", 1)[1] for p in written["port"]] == [
        "RingAmplPhase_20.0.h5", "RingAmplPhase_30.0.h5"]
    for pj, pt in zip(written["jax"], written["port"]):
        fj, ft = j_load_h5(pj), t_load_h5(pt)
        assert sorted(ft) == sorted(fj)
        assert ft["TxSystem"] == "CalibRing" and ft["Frequency"] == F0
        assert ft["LocationMM"] == fj["LocationMM"]
        w, wj = (np.asarray(f["Amplitudes"])
                 * np.exp(1j * np.asarray(f["Phases"])) for f in (ft, fj))
        _check_recovered(w, ft["Residual"])
        np.testing.assert_allclose(w, wj, rtol=0, atol=1e-3)
