"""The inputs of the port's slow validation tier against the reference's.

`tests/test_torch_digital_head.py` and
`tests/test_torch_registration_robustness.py` run on a GPU machine without
JAX, so each keeps its own copy of the reference's input generators. This
file holds those copies to the reference test modules on the CPU:

* the digital head (`tests/test_digital_head.py` ``build_head``): all six
  arrays bit for bit;
* the registration pair (`tests/test_registration_robustness.py`
  ``_head_pair``) for seeds 3, 4 and 5 bit for bit, ``_apply_rigid`` on an
  NCC case bit for bit, the case lists and ``_recovered_error``; the
  phantom of `tests/test_pipeline.py:450-458` bit for bit and its
  ``_misalign`` within rtol 1e-5 and 1e-6 of the peak (the port's resampler differs from
  JAX's in the last bit, ROADMAP "Imaging");
* the digital head's Step 1 in CT and PETRA mode: the port's ``run_case``
  against JAX's, both stopped at ``build_domain`` as in
  `tests/test_torch_sweep.py`, on the CPU: the mask equal, every CT-index
  voxel equal or explained by a float64 resample, the HU table rtol 1e-7,
  the material table rtol 1e-6 with more than 4 materials;
* the two slow-tier files import nothing of JAX or of the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_digital_head as ref_dh
import test_pipeline as ref_pipeline
import test_registration_robustness as ref_rr
import test_torch_digital_head as port_dh
import test_torch_registration_robustness as port_rr
from babelbrain_tpu.pipeline import runner as JR
from babelbrain_tpu.pipeline import step1 as JS1
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
)
from babelbrain_tpu_torch.pipeline import runner as TR
from babelbrain_tpu_torch.pipeline import step1 as TS1
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
)
from test_torch_sweep import (
    _explain_index_differences,
    _record_quantize,
    _step1_of,
    _use_resample64,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


@pytest.fixture(scope="module")
def head():
    return ref_dh.build_head()


def test_build_head_is_the_references(head):
    ours = port_dh.build_head()
    assert len(ours) == len(head) == 6
    for port, ref in zip(ours, head):
        _assert_same(port, ref)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_head_pair_is_the_references(seed):
    ours = port_rr.head_pair(np.random.default_rng(seed))
    theirs = ref_rr._head_pair(np.random.default_rng(seed))
    for port, ref in zip(ours, theirs):
        _assert_same(port, ref)


def test_apply_rigid_is_the_references():
    ct, _ = ref_rr._head_pair(np.random.default_rng(3))
    rot, axis, tr = ref_rr.CASES_NCC[-1]  # 10 deg about z and 5/5/-5 voxels
    _assert_same(port_rr.apply_rigid(ct, rot, tr, axis),
                 ref_rr._apply_rigid(ct, rot, tr, axis))


def test_cases_and_error_are_the_references():
    for name in ("CASES_NCC", "CASES_MI", "CASES_SMALL", "CASES_SMALL_Y",
                 "N", "VOX_MM"):
        assert getattr(port_rr, name) == getattr(ref_rr, name), name
    params = np.array([0.01, -0.02, -0.17, -4.6, -5.3, 4.9], np.float32)
    for rot, axis, tr in ref_rr.CASES_NCC + ref_rr.CASES_SMALL_Y:
        np.testing.assert_array_equal(
            port_rr.recovered_error(params, rot, tr, axis),
            ref_rr._recovered_error(params, rot, tr, axis))


@pytest.mark.parametrize("p_true", [[0.2, -0.15, 0.12, 5.0, -4.0, 3.0],
                                    [0.05, 0.08, -0.06, 2.0, -2.5, 1.5]])
def test_misalign_matches_the_references(p_true):
    """`tests/test_pipeline.py:471-510`'s two misalignments."""
    ref = ref_pipeline.TestCoregistration()
    fixed = port_rr.phantom()
    _assert_same(fixed, ref._phantom())
    p_true = np.array(p_true)
    theirs = np.asarray(ref._misalign(fixed, p_true))
    ours = port_rr.misalign(fixed, p_true)
    assert ours.shape == theirs.shape
    # the band `tests/test_torch_coreg.py` holds the port's resamples to
    np.testing.assert_allclose(ours, theirs, rtol=1e-5,
                               atol=1e-6 * np.abs(theirs).max())


@pytest.fixture
def head_tx():
    J_REGISTRY["HeadTest"] = JSpec("HeadTest", "single", diameter=30e-3,
                                   focal_length=55e-3, frequencies=(500e3,))
    T_REGISTRY["HeadTest"] = port_dh.HEAD_TX
    yield "HeadTest"
    J_REGISTRY.pop("HeadTest", None)
    T_REGISTRY.pop("HeadTest", None)


# CT and one MRI mode: ZTE and Density take the same resample and
# quantisation as these two, and each mode costs ~15 s here
@pytest.mark.parametrize("mode", ["CT", "PETRA"])
def test_step1_matches_jax(head, head_tx, tmp_path, monkeypatch, mode):
    labels, aff = head[0], head[-1]
    volume = port_dh.mode_volume(head, mode)
    out = {}
    for name, runner_mod, step1_mod, extra in (
            ("jax", JR, JS1, {}),
            ("port", TR, TS1, {"device": "cpu"}),
            ("f64", TR, TS1, {"device": "cpu"})):
        d = tmp_path / name
        cfg = runner_mod.CaseConfig(
            tx_system=head_tx, frequency=500e3, ppw=6.0, ct_type=mode,
            output_dir=str(d), prefix=f"dh_{mode.lower()}", **extra)
        q = {}
        _record_quantize(step1_mod, monkeypatch, q)
        if name == "f64":
            # the port's Step 1 with the cubic resample in float64
            _use_resample64(monkeypatch)
        out[name] = _step1_of(runner_mod, monkeypatch, cfg, labels, aff,
                              volume, target=port_dh.TARGET,
                              direction=port_dh.DIRECTION,
                              mask_shape=port_dh.MASK_SHAPE)
        out[name].update(dir=d, **q)
    sj, st, s64 = out["jax"], out["port"], out["f64"]
    assert st["mask"].shape == port_dh.MASK_SHAPE
    np.testing.assert_array_equal(st["mask"], sj["mask"])
    np.testing.assert_array_equal(st["bone"], sj["bone"])
    # a CT-index voxel that differs is one the float32 cubic resample puts
    # on the other side of a bin edge (ROADMAP "Imaging")
    _explain_index_differences(sj, st, s64)
    hu_j = np.load(next(sj["dir"].glob("*_CT-cal.npz")))["UniqueHU"]
    hu_t = np.load(next(st["dir"].glob("*_CT-cal.npz")))["UniqueHU"]
    np.testing.assert_allclose(hu_t, hu_j, rtol=1e-7)
    assert st["materials"].shape == sj["materials"].shape
    assert st["materials"].shape[0] > 4  # per-HU materials
    np.testing.assert_allclose(st["materials"], sj["materials"], rtol=1e-6)


def test_slow_tier_imports_no_jax():
    """The slow tier runs where JAX is not installed: importing its two
    files loads neither JAX nor any module of the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_digital_head, test_torch_registration_robustness\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'babelbrain_tpu' "
        "or m.startswith('babelbrain_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'babelbrain_tpu_torch.pipeline.runner' in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
