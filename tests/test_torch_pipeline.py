"""Port parity of the main paths: Step 1, Step 2 and the whole slices.

* ``generate_mask`` (CT branch): mask, CT index, HU table and air mask equal
  to the JAX package's; without CT (label mode) the same mask.
* ``run_acoustic_sim`` on a domain and transducer built by the JAX package
  and carried over with ``babelbrain_tpu_torch.convert``: the same
  DataForSim keys, fields within the FDTD band (atol 1e-4 peak, rtol 1e-3).
* The whole slices, CT mode (fluid FDTD) and label mode (no CT:
  viscoelastic FDTD): JAX ``run_case`` against the port's ``run_case`` (CPU,
  i.e. the plain versions of the kernels) on the sphere phantom of
  `tests/test_runner.py`: same focal voxel, peak pressure within 1%, peak
  temperature within 0.05 C, CEM43 at the target within 1%, the same
  DataForSim keys.
* Refocusing and dome transducers: ``make_volume_source``'s sparse form
  bit-equal to JAX's dense dict at its nonzero voxels; ``run_acoustic_sim(do_refocus=True)`` on the aberrating-wedge case
  of `tests/test_runner.py:131-170` (``p_amp_refocus`` within 1e-4 peak,
  the refocus phases within 1e-3 rad); ``run_dome_sim`` on the 60-element
  TestDome of `tests/test_runner.py:437-449`; the whole slice with a dome in
  CT mode and with refocusing in label mode.
* The port imports nothing of JAX or of the JAX package, and on CPU tensors
  no kernel launches.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import (
    build_thermal_material_list as j_thermal_mats,
    map_hu_to_properties,
)
from babelbrain_tpu.pipeline import acoustic as JA
from babelbrain_tpu.pipeline import domain as JD
from babelbrain_tpu.pipeline import step1 as JS
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
    amplitude_for_1w as j_amplitude_for_1w,
    build_transducer as j_build_tx,
)
from babelbrain_tpu.pipeline.runner import (
    CaseConfig as JCase,
    run_case as j_run_case,
)
from babelbrain_tpu.pipeline.thermal import SonicationParams as JSon
from babelbrain_tpu.pipeline.thermal import analyze_losses as j_analyze_losses
from babelbrain_tpu.tx import make_concave_array, make_focused_bowl
from babelbrain_tpu_torch import convert
from babelbrain_tpu_torch.materials import (
    build_thermal_material_list as t_thermal_mats,
)
from babelbrain_tpu_torch.ops import bhte_kernels, fdtd_kernels, fdtd_sources
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as visco_kernels
from babelbrain_tpu_torch.pipeline import acoustic as TA
from babelbrain_tpu_torch.pipeline import step1 as TS
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
    TransducerSpec as TSpec,
    amplitude_for_1w as t_amplitude_for_1w,
)
from babelbrain_tpu_torch.pipeline.runner import (
    CaseConfig as TCase,
    run_case as t_run_case,
)
from babelbrain_tpu_torch.pipeline.thermal import SonicationParams as TSon
from babelbrain_tpu_torch.pipeline.thermal import (
    analyze_losses as t_analyze_losses,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET, DIRECTION = [0, 0, 25], [0, 0, -1]
MASK_SHAPE = (32, 32, 48)


@pytest.fixture(scope="module")
def phantom():
    """The `tests/test_runner.py` sphere head at n=48 (4 mm voxels), with a
    CT volume of bone ~1500 HU and soft tissue ~40 HU."""
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
    ct = np.where(np.isin(labels, [2, 7]), 1500.0, 40.0) + np.random.default_rng(
        0
    ).normal(0, 30, labels.shape)
    return labels, aff, ct


@pytest.fixture(scope="module")
def mini_tx():
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg["MiniTest"] = spec("MiniTest", "single", diameter=20e-3,
                               focal_length=25e-3, frequencies=(500e3,))
    return "MiniTest"


# ---------------------------------------------------------------------------
# Step 1
# ---------------------------------------------------------------------------


def test_generate_mask_ct_matches_jax(phantom):
    labels, aff, ct = phantom
    kw = dict(shape=MASK_SHAPE, ct_data=ct, ct_affine=aff)
    sj = JS.generate_mask(labels, aff, TARGET, DIRECTION, 500e3, 6.0, **kw)
    st = TS.generate_mask(labels, aff, TARGET, DIRECTION, 500e3, 6.0,
                          device="cpu", **kw)
    np.testing.assert_array_equal(st.mask, sj.mask)
    np.testing.assert_array_equal(st.ct_index, sj.ct_index)
    # the HU table spans the resampled bone range: cubic interpolation
    # weights round differently in the last bit (rtol 1e-6)
    np.testing.assert_allclose(st.unique_hu, sj.unique_hu, rtol=1e-6)
    np.testing.assert_array_equal(st.air_mask, sj.air_mask)
    np.testing.assert_array_equal(st.affine, sj.affine)
    np.testing.assert_array_equal(st.target_idx, sj.target_idx)


def test_generate_mask_label_matches_jax(phantom):
    labels, aff, _ = phantom
    sj = JS.generate_mask(labels, aff, TARGET, DIRECTION, 500e3, 6.0,
                          shape=MASK_SHAPE)
    st = TS.generate_mask(labels, aff, TARGET, DIRECTION, 500e3, 6.0,
                          shape=MASK_SHAPE, device="cpu")
    assert st.ct_index is None and st.unique_hu is None
    assert st.air_mask is None and sj.air_mask is None
    np.testing.assert_array_equal(st.mask, sj.mask)
    assert {2, 4, 5} <= set(np.unique(st.mask).tolist())  # bone, brain, target
    np.testing.assert_array_equal(st.affine, sj.affine)
    np.testing.assert_array_equal(st.target_idx, sj.target_idx)
    assert st.dx_mm == sj.dx_mm


# ---------------------------------------------------------------------------
# Step 2 on a JAX-built domain
# ---------------------------------------------------------------------------


def _jax_domain_case():
    """A CT-mode domain and a 12 mm bowl built by the JAX package."""
    f0 = 500e3
    mask = np.zeros((24, 24, 40), np.uint8)
    mask[:, :, 30:36] = 1  # skin (NIfTI orientation: transducer at high z)
    mask[:, :, 24:30] = 2  # bone
    mask[:, :, :24] = 4  # brain
    mask[12, 12, 12] = 5  # target
    ct_index = np.zeros(mask.shape, np.int64)
    ct_index[:, :, 24:30] = np.random.default_rng(3).integers(0, 8, (24, 24, 6))
    rho, sos, att = map_hu_to_properties(np.linspace(400, 1800, 8), f0,
                                         "Webb-Marsac")
    mats = JD.build_ct_materials(f0, False, rho, sos, att)
    dom_j = JD.build_domain(mask, f0, 6.0, materials=mats, ct_index_map=ct_index)
    tx_j = JA.position_transducer(
        make_focused_bowl(f0, 12e-3, 8e-3, 1500.0), dom_j, 12e-3
    )
    return dom_j, tx_j


def test_run_acoustic_sim_on_jax_domain_matches():
    dom_j, tx_j = _jax_domain_case()
    rj = JA.run_acoustic_sim(dom_j, tx_j, 60e3)
    rt = TA.run_acoustic_sim(convert.domain_from_reference(dom_j),
                             convert.transducer_from_reference(tx_j), 60e3,
                             device="cpu")
    dj, dt = rj.data_for_sim, rt.data_for_sim
    assert set(dj) == set(dt)
    for k in ("MaterialMap", "Material", "x_vec", "y_vec", "z_vec",
              "SpatialStep", "TargetLocation"):
        np.testing.assert_array_equal(np.asarray(dt[k]), np.asarray(dj[k]))
    # Rayleigh-derived keys: rtol 1e-3 of the maximum
    for k in ("p_amp_water", "SourcePlane_re", "SourcePlane_im"):
        s = np.abs(dj[k]).max()
        np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=1e-3 * s)
    # FDTD fields: the band the JAX package holds its kernels to
    peak = dj["p_amp"].max()
    assert peak > 0
    for k in ("p_amp", "p_complex_re", "p_complex_im"):
        np.testing.assert_allclose(dt[k], dj[k], rtol=1e-3, atol=1e-4 * peak)


def test_run_acoustic_sim_diagnostics_match_jax():
    """All 14 ``sel_maps`` and a monitor line along the beam axis through
    the target (plus the target): the same ``extra_maps`` keys, the maps in
    the mask frame within the plane band (1e-4 of each map's maximum, rtol
    1e-3), the sample times exactly."""
    dom_j, tx_j = _jax_domain_case()
    fi, fj, fk = (int(v) for v in dom_j.focal_idx)
    nz = dom_j.material_map.shape[2]
    mon = np.array([[fi, fj, fk]] + [[fi, fj, k] for k in range(nz)])
    names = tuple(f"{f}_{k}" for f in ("Pressure", "Vx", "Vy", "Vz",
                                       "Sigmaxx", "Sigmayy", "Sigmazz")
                  for k in ("rms", "peak"))
    kw = dict(sel_maps=names, monitor_ijk=mon)
    rj = JA.run_acoustic_sim(dom_j, tx_j, 60e3, **kw)
    rt = TA.run_acoustic_sim(convert.domain_from_reference(dom_j),
                             convert.transducer_from_reference(tx_j), 60e3,
                             device="cpu", **kw)
    ej, et = rj.extra_maps, rt.extra_maps
    assert set(et) == set(ej) == set(names) | {"sensor_series",
                                               "sensor_times"}
    for name in names:
        assert et[name].shape == rt.p_amp.shape == ej[name].shape, name
        scale = np.abs(ej[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(et[name], ej[name], atol=1e-4 * scale,
                                   rtol=1e-3, err_msg=name)
    assert et["sensor_series"].shape == (len(mon), dom_j.n_steps
                                         - dom_j.sensor_start)
    s = np.abs(ej["sensor_series"]).max()
    np.testing.assert_allclose(et["sensor_series"], ej["sensor_series"],
                               atol=1e-4 * s, rtol=1e-3)
    np.testing.assert_array_equal(et["sensor_times"], ej["sensor_times"])
    # the first monitor is the target, sampled at every window step: its
    # largest |p| is the peak map there (mask frame), bit for bit
    t = tuple(rt.data_for_sim["TargetLocation"])
    assert np.abs(et["sensor_series"][0]).max() == et["Pressure_peak"][t]


def test_run_acoustic_sim_pressure_sensors_match_jax(monkeypatch):
    """The reference's own Step 2 selection: only ``Pressure_rms`` /
    ``Pressure_peak`` and the beam-axis monitors, the port's FDTD pinned at
    K = 3 so its window runs in the fluid sweep's extras instantiations
    (B4's ``with_p2`` and monitor capture), against JAX's
    ``run_acoustic_sim`` at the bands of the 14-map case; the window's
    sweeps ran, and the target's largest |p| is the peak map there, bit
    for bit."""
    from babelbrain_tpu_torch.ops import fdtd_fused_kernels as FK

    dom_j, tx_j = _jax_domain_case()
    fi, fj, fk = (int(v) for v in dom_j.focal_idx)
    nz = dom_j.material_map.shape[2]
    mon = np.array([[fi, fj, fk]] + [[fi, fj, k] for k in range(nz)])
    names = ("Pressure_rms", "Pressure_peak")
    kw = dict(sel_maps=names, monitor_ijk=mon)
    pinned = TA.run_fdtd
    monkeypatch.setattr(TA, "run_fdtd",
                        lambda *a, **k: pinned(*a, fuse_steps=3, **k))
    before = FK.plain_calls["fluid_fused_extras_dft"]
    rj = JA.run_acoustic_sim(dom_j, tx_j, 60e3, **kw)
    rt = TA.run_acoustic_sim(convert.domain_from_reference(dom_j),
                             convert.transducer_from_reference(tx_j), 60e3,
                             device="cpu", **kw)
    n_win = dom_j.n_steps - dom_j.sensor_start
    assert FK.plain_calls["fluid_fused_extras_dft"] - before == (
        n_win // 3 + n_win % 3 // 2)
    ej, et = rj.extra_maps, rt.extra_maps
    assert set(et) == set(ej) == set(names) | {"sensor_series",
                                               "sensor_times"}
    for name in names:
        assert et[name].shape == rt.p_amp.shape == ej[name].shape, name
        scale = np.abs(ej[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(et[name], ej[name], atol=1e-4 * scale,
                                   rtol=1e-3, err_msg=name)
    assert et["sensor_series"].shape == (len(mon), n_win)
    s = np.abs(ej["sensor_series"]).max()
    np.testing.assert_allclose(et["sensor_series"], ej["sensor_series"],
                               atol=1e-4 * s, rtol=1e-3)
    np.testing.assert_array_equal(et["sensor_times"], ej["sensor_times"])
    t = tuple(rt.data_for_sim["TargetLocation"])
    assert np.abs(et["sensor_series"][0]).max() == et["Pressure_peak"][t]


# ---------------------------------------------------------------------------
# refocusing and dome transducers on JAX-built domains
# ---------------------------------------------------------------------------


def _wedge_case():
    """The aberrating-wedge refocus case of `tests/test_runner.py:131-172`
    at half its size: water with a fast wedge (3-8 cells, thickening along
    x) between the source plane and the focus, and a 32-element concave
    array (F 16 mm, aperture 14 mm) whose per-element phases can correct
    it. Returns the JAX domain and the positioned JAX transducer."""
    f0 = 500e3
    mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1300.0, 2600.0, 0, 20.0, 0]])
    mask = np.zeros((32, 32, 48), np.uint8)
    mask[16, 16, 26] = 5  # target marker
    dom = JD.build_domain(mask, f0, 6.0, materials=mats, water_only=True)
    mm = dom.material_map
    n1 = mm.shape[0]
    z0 = dom.source_z + 6
    for i in range(n1):
        mm[i, :, z0:z0 + 2 + (6 * i) // n1] = 1
    F = 16e-3
    tx = make_concave_array(f0, F, 2.4e-3, _wedge_centers(), 1500.0,
                            ppw_surface=2.5).translated([0, 0, F])
    return dom, JA.position_transducer(tx, dom, F)


def _wedge_centers(F=16e-3, D=14e-3):
    """32 random element centers on a concave cap (F, aperture D)."""
    rng = np.random.default_rng(7)
    beta = np.sqrt(rng.uniform(0.03, 1.0, 32)) * np.arcsin(0.5 * D / F)
    az = rng.uniform(0, 2 * np.pi, 32)
    return np.stack([F * np.sin(beta) * np.cos(az),
                     F * np.sin(beta) * np.sin(az), -F * np.cos(beta)], axis=1)


def test_refocus_matches_jax():
    dom_j, tx_j = _wedge_case()
    rj = JA.run_acoustic_sim(dom_j, tx_j, 60e3, do_refocus=True)
    rt = TA.run_acoustic_sim(convert.domain_from_reference(dom_j),
                             convert.transducer_from_reference(tx_j), 60e3,
                             do_refocus=True, device="cpu")
    pj, pt = rj.p_amp_refocus, rt.p_amp_refocus
    assert pt is not None and pt.shape == pj.shape
    peak = pj.max()
    assert peak > 0
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4 * peak)
    np.testing.assert_allclose(rt.data_for_sim["p_amp_refocus"],
                               rj.data_for_sim["p_amp_refocus"], rtol=0,
                               atol=1e-4 * peak)
    # the backward Rayleigh's conjugate element phases
    assert rt.phased_array_refocus.shape == (32,)
    dphi = np.angle(rt.phased_array_refocus * np.conj(rj.phased_array_refocus))
    assert np.abs(dphi).max() < 1e-3
    # refocusing raises the pressure at the target through the wedge
    tl = tuple(int(v) for v in rt.data_for_sim["TargetLocation"])
    assert pt[tl] > rt.p_amp[tl]


DOME_F = 16e-3


def _dome_centers(seed, F=DOME_F):
    """60 element centers on the TestDome hemisphere of
    `tests/test_runner.py:443-449` (radius F)."""
    rng = np.random.default_rng(seed)
    b = np.arccos(rng.uniform(0.15, 0.95, 60))
    a = rng.uniform(0, 2 * np.pi, 60)
    return np.stack([F * np.sin(b) * np.cos(a), F * np.sin(b) * np.sin(a),
                     -F * np.cos(b)], axis=1)


def _register_dome(name, F, elem_diameter):
    meta = {"amplitude_1w": {"Rayleigh": 0.14,
                             "Visco": {500000: {6: 60000.0}}}}
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg[name] = spec(
            name, "dome", diameter=2 * F, focal_length=F,
            frequencies=(500e3,), n_elements=60,
            elem_diameter=elem_diameter, meta=meta,
        )
    return name


@pytest.fixture(scope="module")
def test_dome():
    """The TestDome of `tests/test_runner.py:437-442`, in both registries."""
    return _register_dome("TestDome", DOME_F, 2.2e-3)


@pytest.fixture(scope="module")
def dome_domain(test_dome):
    """A JAX CT-mode domain (skin, bone slab, brain) grown around the
    TestDome by ``fit_domain_offsets(dome=True)``, and the JAX dome."""
    f0 = 500e3
    mask = np.zeros((24, 24, 40), np.uint8)
    mask[:, :, 30:36] = 1
    mask[:, :, 24:30] = 2
    mask[:, :, :24] = 4
    mask[12, 12, 12] = 5
    ct_index = np.zeros(mask.shape, np.int64)
    ct_index[:, :, 24:30] = np.random.default_rng(3).integers(0, 8,
                                                              (24, 24, 6))
    rho, sos, att = map_hu_to_properties(np.linspace(400, 1800, 8), f0,
                                         "Webb-Marsac")
    mats = JD.build_ct_materials(f0, False, rho, sos, att)
    offsets, shrinks = JD.fit_domain_offsets(
        np.flip(mask, axis=2), 1500.0 / f0 / 6.0, 2 * DOME_F, DOME_F,
        dome=True,
    )
    dom = JD.build_domain(mask, f0, 6.0, materials=mats,
                          ct_index_map=ct_index, offsets=offsets,
                          shrink_cells=shrinks)
    tx = j_build_tx(J_REGISTRY[test_dome], f0, elem_centers=_dome_centers(7))
    return dom, tx


def test_make_volume_source_bit_equal(dome_domain):
    dom_j, tx_j = dome_domain
    u0 = (60e3 * np.exp(1j * np.random.default_rng(2).uniform(
        -np.pi, np.pi, tx_j.num_subelements))).astype(np.complex64)
    vj = JA.make_volume_source(dom_j, tx_j, u0)
    vt = TA.make_volume_source(convert.domain_from_reference(dom_j),
                               convert.transducer_from_reference(tx_j), u0)
    # the port's sparse form: JAX's amp > 0 voxels and its values there,
    # bit for bit; JAX's dense dict is zero everywhere else
    assert set(vt) == set(vj) | {"index"}
    on = np.flatnonzero(vj["amp"] > 0)
    np.testing.assert_array_equal(vt["index"], on)
    for k in vj:
        assert vt[k].dtype == np.float32
        np.testing.assert_array_equal(vt[k], vj[k].reshape(-1)[on], err_msg=k)
        off = np.delete(vj[k].reshape(-1), on)
        assert not off.any(), k
    # sub-elements land on far fewer voxels than the grid has
    assert 0 < on.size < 0.01 * vj["amp"].size


def test_run_dome_sim_matches_jax(dome_domain):
    """The volumetric dome FDTD with the elements steered 2 mm deep, over the
    first 450 steps of the domain's schedule (the assembled run, with its
    forward Rayleigh and water pass, is the whole-slice test's)."""
    dom_j, tx_j = dome_domain
    dom_j = dataclasses.replace(dom_j, n_steps=450, sensor_start=330)
    steer = np.array([0.0, 0.0, 2e-3])
    oj = JA.run_dome_sim(dom_j, tx_j, 60e3, steering_target=steer,
                         assemble=False)
    for mod in (fdtd_kernels, fdtd_sources):
        for k in mod.plain_calls:
            mod.plain_calls[k] = 0
    ot = TA.run_dome_sim(convert.domain_from_reference(dom_j),
                         convert.transducer_from_reference(tx_j), 60e3,
                         steering_target=steer, assemble=False, device="cpu")
    assert set(ot) == set(oj)
    dphi = np.angle(ot["programming"] * np.conj(oj["programming"]))
    assert ot["programming"].shape == (60,) and np.abs(dphi).max() < 1e-3
    scale = oj["p_amp"].max()
    assert scale > 0
    # the band of `tests/test_fused_kernel.py:328` (volumetric, 1e-5 peak)
    for k in ("p_amp", "peak"):
        np.testing.assert_allclose(ot[k], oj[k], rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
    assert fdtd_sources.plain_calls["volume_source"] == 450
    assert fdtd_kernels.plain_calls["fluid_velocity"] == 450


def test_dome_thermal_losses_and_1w_drive_match_jax(test_dome):
    """The DomeTx peak-ratio losses branch (`tests/test_bhte.py:338`) and
    the calibrated 1 W amplitude, against the JAX package."""
    rng = np.random.default_rng(5)
    shape = (16, 16, 20)
    mm = rng.integers(0, 5, shape).astype(np.uint32)
    acoustic = np.array([[1000.0, 1500.0, 0, 0, 0], [1116.0, 1537.0, 0, 3, 0],
                         [1850.0, 2800.0, 0, 100, 0],
                         [1700.0, 2300.0, 0, 80, 0],
                         [1041.0, 1562.0, 0, 4, 0]])
    p = rng.uniform(0, 1e5, shape).astype(np.float32)
    pw = rng.uniform(0, 1.2e5, shape).astype(np.float32)
    brain = mm == 4
    for dome in (True, False):
        kw = dict(brain_mask=brain, single_point_ratio=dome)
        mk = dict(ct_mode=False, segmented_brain=False)
        aj = j_analyze_losses(p, pw, mm, j_thermal_mats(acoustic, **mk),
                              (8, 8, 10), 5e-4, 10.0, **kw)
        at = t_analyze_losses(p, pw, mm, t_thermal_mats(acoustic, **mk),
                              (8, 8, 10), 5e-4, 10.0, **kw)
        assert at == pytest.approx(aj, rel=1e-12)
        assert at[1] > 0
    for name in (test_dome, "DomeTx"):
        for f, ppw in ((500e3, 6), (220e3, 6)):
            try:
                want = j_amplitude_for_1w(J_REGISTRY[name], f, ppw)
            except ValueError:
                with pytest.raises(ValueError):
                    t_amplitude_for_1w(T_REGISTRY[name], f, ppw)
                continue
            assert t_amplitude_for_1w(T_REGISTRY[name], f, ppw) == want


def test_convert_grid_roundtrip():
    from babelbrain_tpu.ops.fdtd import FDTDGrid

    g = FDTDGrid(shape=(8, 9, 10), dx=1e-4, dt=2e-8, n_steps=7,
                 frequency=5e5, sensor_start=3, source_plane_z=4)
    t = convert.grid_from_reference(g)
    assert type(t).__module__ == "babelbrain_tpu_torch.ops.fdtd"
    assert t.__dict__ == g.__dict__


# ---------------------------------------------------------------------------
# the whole slice: JAX run_case against the port's run_case
# ---------------------------------------------------------------------------


_COUNTERS = (fdtd_kernels, visco_kernels, fdtd_sources, bhte_kernels)


def _run_slices(labels, aff, tx_system, tmp_path_factory, case=None,
                mask_shape=MASK_SHAPE, **kw):
    """(JAX run_case, port run_case, (launches, plain calls) of the port);
    ``case``: extra ``CaseConfig`` fields of both runs."""
    kw.update(target_ras=TARGET, direction_ras=DIRECTION,
              mask_shape=mask_shape)
    case = dict(tx_system=tx_system, frequency=500e3, ppw=6.0, **(case or {}))
    son = dict(duration_on=0.5, duration_off=0.5, duty_cycle=0.3, isppa=10.0)
    rj = j_run_case(
        JCase(output_dir=str(tmp_path_factory.mktemp("jax")), prefix="j",
              **case),
        labels, aff, thermal_params=JSon(**son), **kw,
    )
    for mod in _COUNTERS:
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0
    rt = t_run_case(
        TCase(device="cpu", output_dir=str(tmp_path_factory.mktemp("torch")),
              prefix="t", **case),
        labels, aff, thermal_params=TSon(**son), **kw,
    )
    launches, plain = {}, {}
    for mod in _COUNTERS:
        launches.update(mod.launches)
        plain.update(mod.plain_calls)
    return rj, rt, (launches, plain)


@pytest.fixture(scope="module")
def slice_runs(phantom, mini_tx, tmp_path_factory):
    """The whole slice in CT mode (CT volume given: fluid FDTD)."""
    labels, aff, ct = phantom
    return _run_slices(labels, aff, mini_tx, tmp_path_factory, ct_data=ct,
                       ct_affine=aff)


@pytest.fixture(scope="module")
def label_slice_runs(phantom, mini_tx, tmp_path_factory):
    """The whole slice in label mode (no CT: viscoelastic FDTD)."""
    labels, aff, _ = phantom
    return _run_slices(labels, aff, mini_tx, tmp_path_factory)


@pytest.fixture(scope="module")
def dome_slice_runs(phantom, tmp_path_factory):
    """The whole slice with a dome in CT mode (`tests/test_runner.py:
    663-700`: shear-free media, volumetric drive, dome thermal losses),
    driven at its calibrated 1 W amplitude. The dome is the TestDome at
    10 mm radius (elements 1.4 mm): at 16 mm the dome-fitted domain takes
    the plain versions ~2 min."""
    labels, aff, ct = phantom
    F = 10e-3
    return _run_slices(labels, aff, _register_dome("SmallDome", F, 1.4e-3),
                       tmp_path_factory,
                       case=dict(elem_centers=_dome_centers(11, F),
                                 drive_1w=True),
                       ct_data=ct, ct_affine=aff)


@pytest.fixture(scope="module")
def refocus_slice_runs(phantom, tmp_path_factory):
    """The whole slice in label mode with refocusing (``do_refocus``), with
    the 32-element concave array of ``_wedge_case`` (per-element phases to
    correct with), on a 24x24x36 mask: three viscoelastic passes of the
    plain versions on the 32x32x48 mask would take ~1 min."""
    labels, aff, _ = phantom
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg["MiniArray"] = spec("MiniArray", "concave", diameter=14e-3,
                                focal_length=16e-3, frequencies=(500e3,),
                                n_elements=32, elem_diameter=2.4e-3)
    return _run_slices(labels, aff, "MiniArray", tmp_path_factory,
                       case=dict(do_refocus=True,
                                 elem_centers=_wedge_centers()),
                       mask_shape=(24, 24, 36))


def _same_focal_voxel_and_peak(rj, rt):
    pj = np.asarray(rj["data_for_sim"]["p_amp"])
    pt = np.asarray(rt["data_for_sim"]["p_amp"])
    assert np.unravel_index(pt.argmax(), pt.shape) == np.unravel_index(
        pj.argmax(), pj.shape
    )
    assert abs(pt.max() / pj.max() - 1) < 0.01  # peak within 1%
    assert set(rt["data_for_sim"]) == set(rj["data_for_sim"])


def _thermal_matches(rj, rt):
    tj, tt = rj["thermal"], rt["thermal"]
    # max temperature within 0.05 C
    assert abs(tt.temperature_peak.max() - tj.temperature_peak.max()) < 0.05
    tl = tuple(int(v) for v in np.asarray(rj["data_for_sim"]["TargetLocation"]))
    assert tj.dose[tl] > 0
    # CEM43 at the target within 1%
    assert abs(tt.dose[tl] / tj.dose[tl] - 1) < 0.01
    assert tt.monitor.shape == tj.monitor.shape
    for k in ("TI", "TIS", "TIC", "MI"):
        assert tt.metrics[k] == pytest.approx(tj.metrics[k], rel=0.01, abs=0.05)


def _writes_the_same_files(rj, rt):
    for k in ("mask", "acoustic", "thermal"):
        assert os.path.isfile(rt["files"][k]), k
        assert os.path.basename(rt["files"][k])[1:] == os.path.basename(
            rj["files"][k]
        )[1:]


def _launches_no_kernel(rt, launches, plain, fdtd, stress, runs=1,
                        point_runs=0, volume_runs=0):
    """No launch on CPU; the plain calls of the ``fdtd`` step ("fluid" /
    "visco", with its "pressure" / "stress" half) match the step counts of
    ``runs`` plane or volumetric FDTD runs (``volume_runs`` of them
    volumetric) and ``point_runs`` stress-point runs."""
    dom = rt["domain"]
    n, s = dom.n_steps, dom.sensor_start
    assert all(v == 0 for v in launches.values()), launches
    assert plain[f"{fdtd}_velocity"] == (runs + point_runs) * n
    assert plain[f"{fdtd}_{stress}"] == runs * s
    assert plain[f"{fdtd}_{stress}_dft"] == runs * (n - s)
    assert plain[f"{fdtd}_{stress}_point"] == point_runs * s
    assert plain[f"{fdtd}_{stress}_point_dft"] == point_runs * (n - s)
    assert plain["volume_source"] == volume_runs * n
    other = "visco" if fdtd == "fluid" else "fluid"
    assert not any(v for k, v in plain.items() if k.startswith(other))
    assert plain["bhte_step"] == 50 + 100  # locating run + on/off schedule


def test_slice_same_focal_voxel_and_peak(slice_runs):
    _same_focal_voxel_and_peak(*slice_runs[:2])


def test_slice_thermal_matches(slice_runs):
    _thermal_matches(*slice_runs[:2])


def test_slice_writes_the_same_files(slice_runs):
    _writes_the_same_files(*slice_runs[:2])


def test_slice_on_cpu_launches_no_kernel(slice_runs):
    _, rt, (launches, plain) = slice_runs
    _launches_no_kernel(rt, launches, plain, "fluid", "pressure")


def test_label_slice_same_focal_voxel_and_peak(label_slice_runs):
    _same_focal_voxel_and_peak(*label_slice_runs[:2])


def test_label_slice_thermal_matches(label_slice_runs):
    _thermal_matches(*label_slice_runs[:2])


def test_label_slice_writes_the_same_files(label_slice_runs):
    _writes_the_same_files(*label_slice_runs[:2])


def test_label_slice_on_cpu_launches_no_kernel(label_slice_runs):
    _, rt, (launches, plain) = label_slice_runs
    _launches_no_kernel(rt, launches, plain, "visco", "stress")
    # tissue-label materials with shear in the skull, and no CT-only keys
    assert (np.asarray(rt["domain"].materials)[:, 2] > 0).any()
    assert "SDR" not in rt["data_for_sim"]
    assert "AirMask" not in rt["data_for_sim"]


def test_dome_slice_matches_jax(dome_slice_runs):
    rj, rt, (launches, plain) = dome_slice_runs
    _same_focal_voxel_and_peak(rj, rt)
    _thermal_matches(rj, rt)
    _writes_the_same_files(rj, rt)
    assert rt["acoustic"].meta["tx_is_dome"] is True
    assert "SDR" in rt["data_for_sim"]  # CT mode
    # dome losses: the peak ratio of tissue and water-pass fields
    lj, lt = rj["thermal"].ratio_losses, rt["thermal"].ratio_losses
    assert 0 < lt <= 1.5 and lt == pytest.approx(lj, rel=1e-3)
    # tissue and water passes, both volumetric
    _launches_no_kernel(rt, launches, plain, "fluid", "pressure", runs=2,
                        volume_runs=2)


def test_dome_slice_focuses_near_the_target(dome_slice_runs):
    """`tests/test_runner.py:481-495`: the target's 5x5x5 neighbourhood is
    strongly driven against the median of the field."""
    _, rt, _ = dome_slice_runs
    pa = rt["acoustic"].p_amp
    t = np.asarray(rt["data_for_sim"]["TargetLocation"])
    near = pa[tuple(slice(max(v - 2, 0), v + 3) for v in t)]
    assert np.isfinite(pa).all()
    assert near.max() > 5 * np.median(pa[pa > 0])


def test_refocus_label_slice_matches_jax(refocus_slice_runs):
    rj, rt, (launches, plain) = refocus_slice_runs
    _same_focal_voxel_and_peak(rj, rt)
    _thermal_matches(rj, rt)
    pj = np.asarray(rj["data_for_sim"]["p_amp_refocus"])
    pt = np.asarray(rt["data_for_sim"]["p_amp_refocus"])
    assert np.unravel_index(pt.argmax(), pt.shape) == np.unravel_index(
        pj.argmax(), pj.shape)
    assert abs(pt.max() / pj.max() - 1) < 0.01
    assert os.path.isfile(rt["files"]["acoustic"].replace(
        "_DataForSim.h5", "_FullElasticSolutionRefocus.nii.gz"))
    # forward, refocused forward, and the backward point-source run
    _launches_no_kernel(rt, launches, plain, "visco", "stress", runs=2,
                        point_runs=1)


# ---------------------------------------------------------------------------
# package boundary
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, import with neither JAX nor
    any module of the JAX package loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import babelbrain_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'babelbrain_tpu' "
        "or m.startswith('babelbrain_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 20, names\n"
        "assert {'babelbrain_tpu_torch.ops.fdtd_extras', "
        "'babelbrain_tpu_torch.probes', "
        "'babelbrain_tpu_torch.pipeline.coreg', 'babelbrain_tpu_torch.cli', "
        "'babelbrain_tpu_torch.__main__', 'babelbrain_tpu_torch.ops.mesh', "
        "'babelbrain_tpu_torch.pipeline.plantus', "
        "'babelbrain_tpu_torch.pipeline.benchmark', "
        "'babelbrain_tpu_torch.pipeline.calibration', "
        "'babelbrain_tpu_torch.pipeline.workers', "
        "'babelbrain_tpu_torch.parallel.halo'} <= set(names), names\n"
        "from babelbrain_tpu_torch.ops.fdtd import run_fdtd_batch\n"
        "from babelbrain_tpu_torch.pipeline.acoustic import run_multipoint\n"
        "from babelbrain_tpu_torch.pipeline.runner import (make_pseudo_ct, "
        "run_cases)\n"
        "from babelbrain_tpu_torch.pipeline.thermal import "
        "run_all_combinations\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'babelbrain_tpu.', 'optax')))\n"
        "assert not bad, bad\n"
        "print('imported', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # importing the package's __main__ ran no command: the only output is
    # the script's own line
    assert proc.stdout.splitlines() == [
        f"imported {proc.stdout.split()[-1]}"], proc.stdout

