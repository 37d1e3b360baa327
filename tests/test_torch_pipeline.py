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
* The port imports nothing of JAX or of the JAX package, and on CPU tensors
  no kernel launches.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import map_hu_to_properties
from babelbrain_tpu.pipeline import acoustic as JA
from babelbrain_tpu.pipeline import domain as JD
from babelbrain_tpu.pipeline import step1 as JS
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
)
from babelbrain_tpu.pipeline.runner import (
    CaseConfig as JCase,
    run_case as j_run_case,
)
from babelbrain_tpu.pipeline.thermal import SonicationParams as JSon
from babelbrain_tpu.tx import make_focused_bowl
from babelbrain_tpu_torch import convert
from babelbrain_tpu_torch.ops import bhte_kernels, fdtd_kernels
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as visco_kernels
from babelbrain_tpu_torch.pipeline import acoustic as TA
from babelbrain_tpu_torch.pipeline import step1 as TS
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
    TransducerSpec as TSpec,
)
from babelbrain_tpu_torch.pipeline.runner import (
    CaseConfig as TCase,
    run_case as t_run_case,
)
from babelbrain_tpu_torch.pipeline.thermal import SonicationParams as TSon

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


def test_run_acoustic_sim_on_jax_domain_matches():
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


_COUNTERS = (fdtd_kernels, visco_kernels, bhte_kernels)


def _run_slices(labels, aff, mini_tx, tmp_path_factory, **kw):
    """(JAX run_case, port run_case, (launches, plain calls) of the port)."""
    kw.update(target_ras=TARGET, direction_ras=DIRECTION,
              mask_shape=MASK_SHAPE)
    son = dict(duration_on=0.5, duration_off=0.5, duty_cycle=0.3, isppa=10.0)
    rj = j_run_case(
        JCase(tx_system=mini_tx, frequency=500e3, ppw=6.0,
              output_dir=str(tmp_path_factory.mktemp("jax")), prefix="j"),
        labels, aff, thermal_params=JSon(**son), **kw,
    )
    for mod in _COUNTERS:
        for d in (mod.launches, mod.plain_calls):
            for k in d:
                d[k] = 0
    rt = t_run_case(
        TCase(tx_system=mini_tx, frequency=500e3, ppw=6.0, device="cpu",
              output_dir=str(tmp_path_factory.mktemp("torch")), prefix="t"),
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


def _launches_no_kernel(rt, launches, plain, fdtd, stress):
    """No launch on CPU; the plain calls of the ``fdtd`` step ("fluid" /
    "visco", with its "pressure" / "stress" half) match the step counts."""
    dom = rt["domain"]
    assert all(v == 0 for v in launches.values()), launches
    assert plain[f"{fdtd}_velocity"] == dom.n_steps
    assert plain[f"{fdtd}_{stress}"] == dom.sensor_start
    assert plain[f"{fdtd}_{stress}_dft"] == dom.n_steps - dom.sensor_start
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
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("case", ["dome", "zte", "refocus", "profile_list"])
def test_run_case_outside_the_slice_raises(phantom, mini_tx, tmp_path, case):
    labels, aff, ct = phantom
    cfg = TCase(tx_system=mini_tx, device="cpu", output_dir=str(tmp_path))
    kw = dict(ct_data=ct, ct_affine=aff)
    if case == "dome":
        cfg.tx_system = "DomeTx"
        kw = {}
    elif case == "zte":
        cfg.ct_type = "ZTE"
    elif case == "refocus":
        cfg.do_refocus = True
    else:
        kw["thermal_params"] = [TSon(duration_on=1.0, duration_off=1.0)]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        t_run_case(cfg, labels, aff, TARGET, DIRECTION, **kw)
