"""``pipeline.workers`` of the port (CPU): the out-of-process contract.

The five cases of `tests/test_workers.py` on the port's module: the result
and the live ``CTS:`` log lines, the error sentinel and the traceback, a
large array result (no deadlock), the queue writer's line buffering, and
``calculate_mask_process``; its mask also equals the JAX package's
``generate_mask`` on the same phantom, and ``calculate_field_process``
writes ``run_case``'s files in a child (HDF5, so on the CPU only). The step
functions live in this module, which imports nothing of JAX at its top, so
the spawned children import torch and the port only.
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu_torch.pipeline.workers import (
    ERROR_SENTINEL,
    QueueWriter,
    calculate_field_process,
    calculate_mask_process,
    run_step_in_process,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _child_threads(monkeypatch):
    """A spawned child inherits this environment: its torch then takes two
    threads, as this process does, not every core of the machine (beside
    other busy test workers, a child with every core's threads ran the
    field case ~28x slower than alone)."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(name, "2")


def _ok_step(x, y=1):
    print("CTS:L2:S1: doing work")
    return x + y


def _boom_step():
    print("before the crash")
    raise ValueError("synthetic failure")


def _array_step(n):
    return np.ones((n, n, n), np.float32)


class TestRunStepInProcess:
    def test_result_and_live_logs(self):
        logs = []
        out = run_step_in_process(_ok_step, 2, y=3, on_log=logs.append)
        assert out == 5
        assert any("CTS:L2:S1" in ln for ln in logs)

    def test_error_sentinel_and_traceback(self):
        logs = []
        with pytest.raises(RuntimeError) as exc:
            run_step_in_process(_boom_step, on_log=logs.append)
        assert "synthetic failure" in str(exc.value)
        assert any(ln.strip() == ERROR_SENTINEL for ln in logs)
        assert ERROR_SENTINEL == "--Babel-Brain-Low-Error"
        assert any("before the crash" in ln for ln in logs)
        assert any("Traceback" in ln for ln in logs)

    def test_large_array_result_no_deadlock(self):
        out = run_step_in_process(_array_step, 64)
        assert out.shape == (64, 64, 64)
        assert out.dtype == np.float32


def test_queue_writer_line_buffering():
    class Q:
        def __init__(self):
            self.items = []

        def put(self, x):
            self.items.append(x)

    q = Q()
    w = QueueWriter(q)
    w.write("partial")
    assert q.items == []
    w.write(" line\nsecond\ntail")
    assert q.items == ["partial line", "second"]
    w.flush()
    assert q.items[-1] == "tail"


def _sphere_labels(n=64):
    """The `tests/test_workers.py:78` phantom: 2 mm voxels, skin, skull,
    brain shells."""
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    aff[:3, 3] = -64.0
    ii = np.indices((n, n, n)).astype(float)
    r = np.linalg.norm(ii * 2.0 - 64.0, axis=0)
    labels = np.zeros((n, n, n), np.int32)
    labels[r < 40] = 5
    labels[r < 36] = 7
    labels[r < 30] = 2
    return labels, aff


def test_calculate_mask_process_roundtrip_matches_jax():
    """Step 1 runs out of process and returns the Step1Result; its mask
    equals the JAX package's ``generate_mask`` in this process."""
    from babelbrain_tpu.pipeline.step1 import generate_mask as j_generate

    labels, aff = _sphere_labels()
    kw = dict(labels_data=labels, labels_affine=aff, target_ras=[0, 0, 20],
              direction_ras=[0, 0, -1], frequency=500e3, ppw=6.0,
              shape=(48, 48, 80))
    logs = []
    res = calculate_mask_process(on_log=logs.append, device="cpu", **kw)
    assert res.mask.shape == (48, 48, 80)
    assert res.mask[tuple(res.target_idx)] == 5
    ref = j_generate(**kw)
    np.testing.assert_array_equal(res.mask, ref.mask)
    np.testing.assert_array_equal(res.affine, ref.affine)
    np.testing.assert_array_equal(res.target_idx, ref.target_idx)
    assert res.dx_mm == ref.dx_mm


def test_calculate_field_process_writes_the_files_of_run_case(tmp_path):
    """Steps 1-3 of a label-mode case with the built-in single-element bowl
    (200 kHz, the registry's cheapest Rayleigh) in a child: the output
    file map of ``run_case``, with a finite, non-zero field and the thermal
    maps in its files."""
    from babelbrain_tpu_torch.pipeline.io import load_dict_h5
    from babelbrain_tpu_torch.pipeline.thermal import SonicationParams

    labels, aff = _sphere_labels()
    son = SonicationParams(duration_on=0.5, duration_off=0.5,
                           duty_cycle=0.3, isppa=10.0)
    case_args = dict(labels_data=labels, labels_affine=aff,
                     target_ras=[0, 0, 20], direction_ras=[0, 0, -1],
                     thermal_params=son, mask_shape=(24, 24, 32))
    cfg = dict(tx_system="Single", frequency=200e3, ppw=6.0, device="cpu",
               prefix="w", output_dir=str(tmp_path))
    logs = []
    files = calculate_field_process(cfg, case_args, on_log=logs.append)
    assert {"acoustic", "thermal"} <= set(files)
    assert all(v.startswith(str(tmp_path)) for v in files.values())
    p_amp = np.asarray(load_dict_h5(files["acoustic"])["p_amp"])
    assert p_amp.shape == (24, 24, 32)
    assert np.isfinite(p_amp).all() and p_amp.max() > 0
    thermal = load_dict_h5(files["thermal"])
    assert np.isfinite(np.asarray(thermal["FinalTemp"])).all()
    assert any("CTS:" in ln for ln in logs)
    assert not any(ln.strip() == ERROR_SENTINEL for ln in logs)
