"""``python -m babelbrain_tpu_torch`` against ``python -m babelbrain_tpu``:
the same arguments give the same output.

* ``list-tx``: the same text;
* ``plan`` on the `tests/test_cli.py` phantom: the same JSON summary, CSV
  and Brainsight trajectory, byte for byte;
* ``run --device cpu`` in CT mode with a MiniTest bowl and
  ``--mask-shape 32,32,48``: the same JSON keys and file names, the
  metrics within the slice bands of `tests/test_torch_pipeline.py` (peak
  pressure 5e-7 relative, temperatures 2e-4 C), the peak ``p_amp`` and
  peak temperature of the written files too;
* a two-target matrix ``run`` (label mode, ``--mask-shape 24,24,32``): the
  same cells and ``_sweep`` summary;
* ``--device`` defaults to ``cuda``; ``bench`` is not ported.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from babelbrain_tpu.cli import main as j_main
from babelbrain_tpu.ops import fdtd as JF
from babelbrain_tpu.pipeline.io import load_dict_h5, save_nifti
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
)
from babelbrain_tpu.pipeline.step1 import LABELS
from babelbrain_tpu_torch.cli import main as t_main
from babelbrain_tpu_torch.pipeline import runner as TR
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
    TransducerSpec as TSpec,
)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(capsys):
    """The JSON object that ends the command's output."""
    out = capsys.readouterr().out
    return json.loads(out[out.rindex("\n{") + 1:] if "\n{" in out else out)


def _builtin_tx_names():
    """The names the JAX package's registry ships with: its profiles module
    executed afresh, so entries that other test files add to the loaded
    registry (``TestOptimizedWeightsLoader``'s MiniRing) are not among
    them."""
    spec = importlib.util.find_spec("babelbrain_tpu.pipeline.profiles")
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    return sorted(fresh.TRANSDUCER_REGISTRY)


def test_list_tx_matches_jax(capsys, monkeypatch):
    """Both commands list the same registry byte for byte. The registries
    are module globals that other test files add to (only to the JAX one,
    or under other specs), so for this test each drops the names the other
    lacks, whatever ran before in the process."""
    builtin = _builtin_tx_names()
    shared = set(J_REGISTRY) & set(T_REGISTRY)
    for reg in (J_REGISTRY, T_REGISTRY):
        for name in set(reg) - shared:
            monkeypatch.delitem(reg, name)
    j_main(["list-tx"])
    ref = capsys.readouterr().out
    t_main(["list-tx"])
    assert capsys.readouterr().out == ref
    listed = {line.split()[0] for line in ref.splitlines()}
    assert set(builtin) <= listed, sorted(set(builtin) - listed)
    assert "CTX_500" in ref and "DomeTx" in ref


def test_module_entry_point_lists_the_transducers():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "babelbrain_tpu_torch", "list-tx"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0].startswith("ATAC")


def test_plan_matches_jax(tmp_path, capsys):
    """The `tests/test_cli.py:21` phantom and arguments."""
    n = 72
    lab = np.zeros((n, n, n), np.uint8)
    c = np.array([36.0, 36, 36])
    ii = np.indices(lab.shape).astype(float)
    r = np.sqrt(((ii - c[:, None, None, None]) ** 2).sum(0))
    lab[r < 32] = LABELS["skin"]
    lab[r < 29] = LABELS["cortical"]
    lab[r < 25] = LABELS["brain"]
    labels = str(tmp_path / "lab.nii.gz")
    save_nifti(labels, lab, np.eye(4))
    out = {}
    for name, main in (("jax", j_main), ("port", t_main)):
        main(["plan", "--labels", labels, "--target", "36,36,48",
              "--max-distance", "60", "--min-distance", "5",
              "--optimal-distance", "22", "--max-angle", "20",
              "--out", str(tmp_path / f"{name}.csv"),
              "--trajectory-out", str(tmp_path / f"{name}.txt")])
        out[name] = _json(capsys)
    assert out["port"].pop("csv").endswith("port.csv")
    assert out["jax"].pop("csv").endswith("jax.csv")
    assert out["port"] == out["jax"]
    assert out["port"]["candidates"] > 100
    for ext in ("csv", "txt"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (
            tmp_path / f"jax.{ext}").read_bytes()


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    """The sphere head of `tests/test_torch_pipeline.py` (4 mm voxels) as
    label and CT NIfTI files, and a MiniTest bowl in both registries."""
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
    ct = np.where(np.isin(labels, [2, 7]), 1500.0, 40.0) + \
        np.random.default_rng(0).normal(0, 30, labels.shape)
    d = tmp_path_factory.mktemp("head")
    save_nifti(str(d / "labels.nii.gz"), labels, aff)
    save_nifti(str(d / "ct.nii.gz"), ct, aff)
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg["MiniTest"] = spec("MiniTest", "single", diameter=20e-3,
                               focal_length=25e-3, frequencies=(500e3,))
    return d


def _run_args(head, out, *extra, mask_shape="32,32,48"):
    return ["run", "--labels", str(head / "labels.nii.gz"), "--tx",
            "MiniTest", "--mask-shape", mask_shape, "--out", str(out),
            "--thermal", "0.3,10,5,5", *extra]


def test_run_on_cpu_matches_jax(head, tmp_path, capsys):
    out = {}
    for name, main, extra in (("jax", j_main, []),
                              ("port", t_main, ["--device", "cpu"])):
        main(_run_args(head, tmp_path / name, "--ct", str(head / "ct.nii.gz"),
                       "--target", "0,0,25", *extra))
        out[name] = _json(capsys)
    sj, st = out["jax"], out["port"]
    assert st.keys() == sj.keys() == {"files", "metrics"}
    assert {k: os.path.basename(v) for k, v in st["files"].items()} == {
        k: os.path.basename(v) for k, v in sj["files"].items()}
    mj, mt = sj["metrics"], st["metrics"]
    assert mt.keys() == mj.keys()
    for k, vj in mj.items():
        if k in ("TI", "TIS", "TIC"):  # temperatures (C)
            assert mt[k] == pytest.approx(vj, rel=0, abs=2e-4), k
        elif k.startswith("CEM"):  # thermal dose: the BHTE band
            assert mt[k] == pytest.approx(vj, rel=1e-5, abs=0), k
        elif k == "MaxBrainPressure":
            assert mt[k] == pytest.approx(vj, rel=5e-7, abs=0), k
        else:  # intensities and MI: square and root of the pressure
            assert mt[k] == pytest.approx(vj, rel=1e-6, abs=0), k
    pj = np.asarray(load_dict_h5(sj["files"]["acoustic"])["p_amp"])
    pt = np.asarray(load_dict_h5(st["files"]["acoustic"])["p_amp"])
    assert abs(pt.max() / pj.max() - 1) < 5e-7
    tj, tt = (load_dict_h5(s["files"]["thermal"]) for s in (sj, st))
    for k in ("TempEndFUS", "FinalTemp"):
        assert abs(np.asarray(tt[k]).max() - np.asarray(tj[k]).max()) < 2e-4


def test_matrix_run_sweep_summary_matches_jax(head, tmp_path, capsys,
                                              monkeypatch):
    """Two targets in label mode, where both packages see one grid
    signature: JAX compiles once and reuses once (its executable memo starts
    empty here), the port counts the same."""
    monkeypatch.setattr(JF, "_JIT_CACHE", {})
    out = {}
    for name, main, extra in (("jax", j_main, []),
                              ("port", t_main, ["--device", "cpu"])):
        main(_run_args(head, tmp_path / name, "--target", "0,0,25;0,4,25",
                       *extra, mask_shape="24,24,32"))
        out[name] = _json(capsys)
    sj, st = out["jax"], out["port"]
    assert st.keys() == sj.keys() == {"T0_500kHz_6PPW", "T1_500kHz_6PPW",
                                      "_sweep"}
    assert st["_sweep"] == sj["_sweep"] == {
        "cases": 2, "fdtd_executable_builds": 1, "fdtd_executable_reuses": 1}
    for cell in ("T0_500kHz_6PPW", "T1_500kHz_6PPW"):
        assert st[cell]["cached"] is sj[cell]["cached"] is False
        assert {k: os.path.basename(v) for k, v in st[cell]["files"].items()
                } == {k: os.path.basename(v)
                      for k, v in sj[cell]["files"].items()}


def test_run_device_defaults_to_cuda(head, tmp_path, capsys, monkeypatch):
    seen = []

    def fake_run_case(cfg, *a, **k):
        seen.append((cfg.device, cfg.coregister, cfg.ct_type,
                     cfg.export_meshes, k["t1_data"] is not None))
        return {"files": {}, "thermal": None}

    monkeypatch.setattr(TR, "run_case", fake_run_case)
    args = _run_args(head, tmp_path, "--ct", str(head / "ct.nii.gz"),
                     "--ct-type", "ZTE", "--t1", str(head / "ct.nii.gz"),
                     "--coregister", "--export-meshes")
    t_main(args)
    t_main(args + ["--device", "cpu"])
    assert seen == [("cuda", True, "ZTE", True, True),
                    ("cpu", True, "ZTE", True, True)]
    assert _json(capsys) == {"files": {}}


def test_bench_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 1"):
        t_main(["bench"])
