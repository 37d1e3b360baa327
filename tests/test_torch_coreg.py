"""Port parity of the rigid coregistration (``pipeline/coreg.py``) and of the
Step-1 paths that use it or follow it in ``run_case``.

Each piece runs in the JAX package (CPU, XLA) and in the port (CPU, plain
PyTorch) on the same seeded numpy inputs:

* the pieces of ``coreg`` (Euler matrix, rigid resample, NCC, MI, gradient
  magnitude, NGF, downsample, interior crop) at n = 24-48: rtol 1e-5 and
  atol 1e-6 of the reference's largest magnitude; the NCC and MI losses of a
  pyramid level and their gradients (``torch.autograd`` against
  ``jax.value_and_grad``) at three parameter vectors: rtol 1e-4;
* ``register_rigid`` end to end on the phantom of `tests/test_pipeline.py:
  424-448`: parameters within 0.25 deg and 0.25 voxel (the finest descent
  step) of JAX's, quality within 1e-3, both within that test's truth
  bands; and the failure case of `:513-526` with the same verdict;
* ``run_case`` with a ZTE MRI displaced from its T1 and ``coregister=True``,
  both stopped at ``build_domain``; and ``export_meshes=True``, whose STL
  triangles must equal JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from babelbrain_tpu.materials import pseudo_ct as JP
from babelbrain_tpu.ops import imaging as JI
from babelbrain_tpu.ops.voxelize import read_stl as j_read_stl
from babelbrain_tpu.pipeline import coreg as JC
from babelbrain_tpu.pipeline import runner as JR
from babelbrain_tpu.pipeline import step1 as JS1
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY as J_REGISTRY,
    TransducerSpec as JSpec,
)
from babelbrain_tpu_torch.materials import pseudo_ct as TP
from babelbrain_tpu_torch.ops import imaging as TI
from babelbrain_tpu_torch.ops.voxelize import read_stl as t_read_stl
from babelbrain_tpu_torch.pipeline import coreg as TC
from babelbrain_tpu_torch.pipeline import runner as TR
from babelbrain_tpu_torch.pipeline import step1 as TS1
from babelbrain_tpu_torch.pipeline.profiles import (
    TRANSDUCER_REGISTRY as T_REGISTRY,
    TransducerSpec as TSpec,
)
from test_torch_sweep import (
    _Stop,
    _explain_index_differences,
    _record_quantize,
    _step1_of,
    _use_resample64,
)

torch.set_num_threads(2)


def _close(port, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(port, np.float64), ref, rtol=rtol,
                               atol=1e-6 * np.abs(ref).max())


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _phantom(n=48):
    """The ellipsoid-and-rods phantom of `tests/test_pipeline.py:424-448`."""
    c = n / 2
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n].astype(float)
    v = np.exp(-(((ii - c) / 12) ** 2 + ((jj - c) / 9) ** 2
                 + ((kk - c) / 15) ** 2))
    v += 0.7 * np.exp(-(((ii - c - 6) / 2) ** 2 + ((jj - c + 6) / 2) ** 2))
    v += 0.5 * np.exp(-(((jj - c - 6) / 2) ** 2 + ((kk - c + 10) / 2) ** 2))
    return v


def _misalign(fixed, p_true):
    """``fixed`` moved by the rigid transform ``p_true`` (JAX's resample, as
    `tests/test_pipeline.py:450-459`)."""
    n = fixed.shape[0]
    R = np.asarray(JC.euler_matrix(*p_true[:3]))
    c = np.full(3, n / 2.0)
    off = c - R @ c + p_true[3:]
    return JI.resample_affine(fixed, np.linalg.inv(R),
                              -np.linalg.inv(R) @ off, fixed.shape, 1)


P_TRUE = np.array([0.06, -0.04, 0.08, 2.0, -1.5, 1.0])
PARAMS = [np.zeros(6), np.array([0.05, -0.03, 0.04, 1.0, -0.5, 0.7]),
          np.array([-0.08, 0.06, 0.1, -2.0, 1.5, 0.3])]


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (0.3, -0.2, 0.1),
                                    (-1.1, 0.7, 2.5)])
def test_euler_matrix_matches_jax(angles):
    _close(TC.euler_matrix(*(np.float32(a) for a in angles)).numpy(),
           JC.euler_matrix(*(jnp.float32(a) for a in angles)))


def test_resample_rigid_matches_jax():
    """A rotation of 0.35 rad and a 3-voxel shift pull zero padding in at
    the corners."""
    rng = np.random.default_rng(0)
    moving = (_phantom(40) + 0.1 * rng.normal(size=(40,) * 3)).astype(
        np.float32)
    shape = (36, 40, 44)
    params = np.array([0.35, -0.1, 0.2, 3.0, -2.0, 1.0], np.float32)
    center = np.array(shape, np.float32) / 2.0
    ref = JC._resample_rigid(jnp.asarray(moving), jnp.asarray(params), shape,
                             jnp.asarray(center))
    out = TC._resample_rigid(_t(moving), _t(params), shape, _t(center))
    assert out.shape == shape
    assert (np.asarray(ref) == 0).mean() > 0.05  # padding came in
    _close(out, ref)


def _pair(n):
    rng = np.random.default_rng(n)
    a = _phantom(n) + 0.05 * rng.normal(size=(n,) * 3)
    b = _misalign(_phantom(n), PARAMS[1]) + 0.05 * rng.normal(size=(n,) * 3)
    return a.astype(np.float32), b.astype(np.float32)


PIECES = {
    "ncc": (lambda m, a, b: m._ncc(a, b)),
    "mutual_information": (lambda m, a, b: m._mutual_information(a, b)),
    "grad_mag": (lambda m, a, b: m._grad_mag(a)),
    "ngf": (lambda m, a, b: m._ngf(a, b, 0.02)),
    "downsample_2": (lambda m, a, b: m._downsample(a, 2)),
    "downsample_3": (lambda m, a, b: m._downsample(a, 3)),
    "interior": (lambda m, a, b: m._interior(a)),
}


@pytest.mark.parametrize("n", [24, 48])
@pytest.mark.parametrize("piece", sorted(PIECES))
def test_coreg_pieces_match_jax(piece, n):
    a, b = _pair(n)
    fn = PIECES[piece]
    ref = fn(JC, jnp.asarray(a), jnp.asarray(b))
    out = fn(TC, _t(a), _t(b))
    assert tuple(out.shape) == tuple(np.shape(ref))
    _close(out, ref)


def _jax_level_loss(fixed, moving, f, metric):
    """The loss of one pyramid level as `coreg.py:223-241` builds it."""
    fx = jnp.asarray(JC._downsample(fixed, f))
    mv = jnp.asarray(JC._downsample(moving, f))
    if metric == "ncc":
        fx, mv = JC._grad_mag(fx), JC._grad_mag(mv)
    fx = (fx - fx.mean()) / (fx.std() + 1e-6)
    mv = (mv - mv.mean()) / (mv.std() + 1e-6)
    center = jnp.asarray(np.array(fx.shape, np.float32) / 2.0)
    fx_in = JC._interior(fx)
    sim = JC._mutual_information if metric == "mi" else JC._ncc

    def loss(p):
        p_level = jnp.concatenate([p[:3], p[3:] / f])
        return -sim(JC._interior(JC._resample_rigid(mv, p_level, fx.shape,
                                                    center)), fx_in)

    return jax.value_and_grad(loss)


@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_level_loss_and_gradient_match_jax(metric):
    fixed = _phantom(48).astype(np.float32)
    moving = _misalign(_phantom(48), P_TRUE).astype(np.float32)
    f = 2
    value_and_grad = _jax_level_loss(fixed, moving, f, metric)
    fx, mv = TC._downsample(_t(fixed), f), TC._downsample(_t(moving), f)
    if metric == "ncc":
        fx, mv = TC._grad_mag(fx), TC._grad_mag(mv)
    counts = {"evals": 0, "syncs": 0}
    level = TC._Level(TC._standardize(fx), TC._standardize(mv), f,
                      TC._mutual_information if metric == "mi" else TC._ncc,
                      counts)
    for params in PARAMS:
        vj, gj = value_and_grad(jnp.asarray(params, jnp.float32))
        p = _t(params).requires_grad_(True)
        vt = level.loss(p)
        vt.backward()
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-4)
        gj = np.asarray(gj)
        np.testing.assert_allclose(p.grad.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * np.abs(gj).max())
    assert counts == {"evals": 3, "syncs": 0}


# ---------------------------------------------------------------------------
# register_rigid end to end
# ---------------------------------------------------------------------------


def _same_registration(rj, rt):
    """The port's parameters within the finest descent step (0.25 deg,
    0.25 voxel) of JAX's; the quality within 1e-3; the matrices built the
    same way from them."""
    pj, pt = rj[0], rt[0]
    assert pt.dtype == np.float32 and pt.shape == (6,)
    assert np.rad2deg(np.abs(pt[:3] - pj[:3])).max() < 0.25, (pt, pj)
    assert np.abs(pt[3:] - pj[3:]).max() < 0.25, (pt, pj)
    assert rt[1].shape == (4, 4)
    np.testing.assert_allclose(rt[1][:3, :3], np.asarray(
        JC.euler_matrix(*pt[:3])), rtol=1e-6, atol=1e-7)
    if len(rj) == 3:
        assert abs(rt[2] - rj[2]) < 1e-3


@pytest.mark.parametrize("kw", [dict(levels=(2,), iters_per_level=200),
                                dict(return_quality=True)],
                         ids=["level2_200", "defaults_quality"])
def test_register_rigid_matches_jax(kw):
    fixed = _phantom()
    moving = _misalign(fixed, P_TRUE)
    rj = JC.register_rigid(fixed, moving, **kw)
    stats = []
    rt = TC.register_rigid(fixed, moving, device="cpu", stats=stats, **kw)
    _same_registration(rj, rt)
    for p in (rj[0], rt[0]):  # the truth bands of `tests/test_pipeline.py`
        np.testing.assert_allclose(p[:3], P_TRUE[:3], atol=0.02)
        np.testing.assert_allclose(p[3:], P_TRUE[3:], atol=0.5)
    levels = kw.get("levels", (4, 2, 1))
    assert [s["stage"] for s in stats] == ["pre-search"] + [
        f"level {f}" for f in levels]
    assert stats[0]["evals"] == stats[0]["syncs"] == 37
    # Adam's value-and-gradient calls read nothing back to the host
    assert all(s["evals"] - s["syncs"] >= kw.get("iters_per_level", 100) - 2
               for s in stats[1:])


def test_failure_detection_gives_jax_verdict():
    """`tests/test_pipeline.py:513-526`: unrelated volumes score low, a
    volume against itself high, in both packages. On noise the optimizers
    wander to different optima, so only the verdict must agree there."""
    rng = np.random.default_rng(0)
    fixed = _phantom()
    garbage = rng.normal(size=fixed.shape)
    kw = dict(levels=(4,), iters_per_level=40, return_quality=True)
    for moving, good in ((garbage, False), (fixed.copy(), True)):
        rj = JC.register_rigid(fixed, moving, **kw)
        rt = TC.register_rigid(fixed, moving, device="cpu", **kw)
        if good:
            assert abs(rt[2] - rj[2]) < 1e-3, (rt[2], rj[2])
        assert TC.registration_ok(rt[2]) == JC.registration_ok(rj[2]) == good
        for q in (rt[2], rj[2]):
            assert (q > 0.95) if good else (q < 0.4), q
        assert TC.QUALITY_THRESHOLD == JC.QUALITY_THRESHOLD


# ---------------------------------------------------------------------------
# run_case: ZTE coregistered to a T1, and the surface meshes
# ---------------------------------------------------------------------------

TARGET, DIRECTION = [0, 0, 25], [0, 0, -1]
ZTE_MOVE = (4.0, 2, (1.5, -1.0, 0.5))  # degrees about z, voxel shift


@pytest.fixture(scope="module")
def phantom():
    """``_zte_t1_head()``, and a MiniTest bowl in both registries."""
    for reg, spec in ((J_REGISTRY, JSpec), (T_REGISTRY, TSpec)):
        reg["MiniTest"] = spec("MiniTest", "single", diameter=20e-3,
                               focal_length=25e-3, frequencies=(500e3,))
    return _zte_t1_head()


def _zte_t1_head():
    """The sphere head of `tests/test_torch_pipeline.py` (4 mm voxels), a
    T1-contrast image of it (dark skull, graded brain, an air pocket and a
    bright blob off centre, noise) and a ZTE-contrast image (bright soft
    tissue, dark skull and pocket) moved off the T1 by ``ZTE_MOVE``."""
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
    rng = np.random.default_rng(0)
    pocket = np.linalg.norm(np.stack([ii - 30, jj - 17, kk - 31], -1), axis=-1) < 5
    blob = np.linalg.norm(np.stack([ii - 18, jj - 28, kk - 20], -1), axis=-1) < 4
    brain = np.isin(labels, (1, 2))
    t1 = np.zeros(labels.shape)
    t1[labels == 5] = 620.0
    t1[labels == 7] = 120.0
    t1[labels == 4] = 300.0
    t1[brain] = 800.0 + 4.0 * (36 - r[brain] / 4.0)
    t1[blob] = 1100.0
    t1[pocket] = 30.0
    t1 = t1 + rng.normal(0, 10, t1.shape)
    zte = np.full(labels.shape, 30.0)
    zte[labels > 0] = 1000.0
    zte[labels == 7] = 350.0
    zte[pocket] = 30.0
    deg, axis, shift = ZTE_MOVE
    angles = [0.0, 0.0, 0.0]
    angles[axis] = np.deg2rad(deg)
    R = np.asarray(JC.euler_matrix(*angles))
    c = np.array(zte.shape) / 2.0
    zte = ndimage.affine_transform(zte, R, offset=c - R @ c + np.asarray(shift),
                                   order=1)
    zte = np.round(zte + rng.normal(0, 5, zte.shape))
    return labels, aff, t1, zte


def _jax_resample_affine_4x4(monkeypatch):
    """The JAX runner applies the registration as
    ``resample_affine(mv, mat, t1.shape, order=1)`` (`runner.py:419`), a
    call that ``resample_affine(volume, matrix, offset, out_shape, order)``
    refuses (TypeError). Let that one call take the 4x4 matrix's linear
    part and offset, as the port's runner passes them."""
    real = JI.resample_affine

    def resample_affine(volume, matrix, offset, out_shape=None, order=1):
        if out_shape is None and np.shape(matrix) == (4, 4):
            m = np.asarray(matrix)
            return real(volume, m[:3, :3], m[:3, 3], offset, order)
        return real(volume, matrix, offset, out_shape, order)

    monkeypatch.setattr(JI, "resample_affine", resample_affine)


def test_run_case_zte_coregistered_to_t1_matches_jax(phantom, tmp_path,
                                                     monkeypatch):
    """``run_case(ct_type="ZTE", coregister=True)`` up to ``build_domain``
    in both packages. The registrations agree to the descent's finest step
    (``_same_registration``); JAX's Step 1 then consumes the port's
    transform, so that what follows is compared at float32 rounding: the
    registered MRI within the resample band, the masks and bone equal, the
    CT index equal but for voxels a float64 resample explains."""
    labels, aff, t1, zte = phantom
    runs = {}

    def recording(mod, name, serve=None):
        real_reg = mod.register_rigid
        seen = runs.setdefault(name, {})

        def register_rigid(fixed, moving, **kw):
            if serve is not None:  # the port's own result, served again
                return serve
            out = real_reg(fixed, moving, **kw)
            seen["reg"] = out
            if name == "jax":  # apply the port's transform
                return out[0], runs["port"]["reg"][1], out[2]
            return out

        return register_rigid

    def recording_pct(mod, name):
        real_pct = mod.mri_to_pseudo_ct

        def mri_to_pseudo_ct(image, head, *a, **k):
            runs[name]["mri"] = np.array(image)
            return real_pct(image, head, *a, **k)

        return mri_to_pseudo_ct

    _jax_resample_affine_4x4(monkeypatch)
    out = {}
    for name, mod, coreg, pct, s1, extra in (
            ("port", TR, TC, TP, TS1, {"device": "cpu"}),
            ("jax", JR, JC, JP, JS1, {}),
            ("f64", TR, TC, TP, TS1, {"device": "cpu"})):
        serve = runs["port"]["reg"] if name == "f64" else None
        monkeypatch.setattr(coreg, "register_rigid",
                            recording(coreg, name, serve))
        monkeypatch.setattr(pct, "mri_to_pseudo_ct", recording_pct(pct, name))
        cfg = mod.CaseConfig(tx_system="MiniTest", ct_type="ZTE",
                             coregister=True, output_dir=str(tmp_path / name),
                             prefix="coreg", **extra)
        q = {}
        _record_quantize(s1, monkeypatch, q)
        if name == "f64":
            _use_resample64(monkeypatch)
        out[name] = _step1_of(mod, monkeypatch, cfg, labels, aff, zte,
                              t1_data=t1, t1_affine=aff)
        out[name].update(q)
    _same_registration(runs["jax"]["reg"], runs["port"]["reg"])
    assert TC.registration_ok(runs["port"]["reg"][2])
    # the registration moved the image: it now lines up with the T1
    mj, mt = runs["jax"]["mri"], runs["port"]["mri"]
    assert mt.shape == t1.shape
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5 * np.ptp(mj))
    np.testing.assert_array_equal(runs["f64"]["mri"], mt)
    sj, st, s64 = out["jax"], out["port"], out["f64"]
    np.testing.assert_array_equal(st["mask"], sj["mask"])
    np.testing.assert_array_equal(st["bone"], sj["bone"])
    _explain_index_differences(sj, st, s64)
    np.testing.assert_allclose(st["materials"], sj["materials"], rtol=1e-6)


def test_run_case_without_t1_skips_the_registration(phantom, tmp_path,
                                                    monkeypatch):
    """``coregister=True`` with no T1 converts the MRI where it lies, as
    the JAX runner does (`runner.py:393`)."""
    labels, aff, _, zte = phantom

    def boom(*a, **k):
        raise AssertionError("registered without a T1")

    monkeypatch.setattr(TC, "register_rigid", boom)
    cfg = TR.CaseConfig(tx_system="MiniTest", ct_type="ZTE", coregister=True,
                        output_dir=str(tmp_path), device="cpu")
    seen = _step1_of(TR, monkeypatch, cfg, labels, aff, zte)
    assert seen["ct_index"] is not None


def test_run_case_refuses_a_failed_registration(phantom, tmp_path,
                                                monkeypatch):
    """A registration under the quality threshold stops the case unless
    ``BBT_IGNORE_COREG_QUALITY`` is set (`runner.py:402-414`)."""
    labels, aff, t1, zte = phantom
    real = TC.register_rigid

    def poor(*a, **k):
        p, m, _ = real(*a, **dict(k, levels=(4,), iters_per_level=1))
        return p, m, 0.1

    monkeypatch.setattr(TC, "register_rigid", poor)
    cfg = TR.CaseConfig(tx_system="MiniTest", ct_type="ZTE", coregister=True,
                        output_dir=str(tmp_path), device="cpu")
    monkeypatch.delenv("BBT_IGNORE_COREG_QUALITY", raising=False)
    with pytest.raises(RuntimeError, match="coregistration quality 0.100"):
        TR.run_case(cfg, labels, aff, TARGET, DIRECTION, ct_data=zte,
                    ct_affine=aff, t1_data=t1, t1_affine=aff,
                    mask_shape=(32, 32, 48))
    monkeypatch.setenv("BBT_IGNORE_COREG_QUALITY", "1")
    seen = _step1_of(TR, monkeypatch, cfg, labels, aff, zte, t1_data=t1,
                     t1_affine=aff)
    assert seen["ct_index"] is not None


@pytest.mark.parametrize("ct", [False, True], ids=["label", "ct"])
def test_export_meshes_matches_jax(phantom, tmp_path, monkeypatch, ct):
    """``export_meshes=True`` writes the skin / bone / csf STLs of Step 1
    (`runner.py:586-590`) with JAX's triangles."""
    labels, aff, t1, _ = phantom
    kw = dict(ct_data=np.where(labels == 7, 1500.0, 40.0), ct_affine=aff) \
        if ct else {}
    for name, mod, extra in (("jax", JR, {}), ("port", TR, {"device": "cpu"})):
        cfg = mod.CaseConfig(tx_system="MiniTest", export_meshes=True,
                             output_dir=str(tmp_path / name), prefix="m",
                             **extra)

        def stop(mask, *a, **k):
            raise _Stop

        monkeypatch.setattr(mod, "build_domain", stop)
        with pytest.raises(_Stop):
            mod.run_case(cfg, labels, aff, TARGET, DIRECTION,
                         mask_shape=(32, 32, 48), **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    stls = [f for f in names if f.endswith(".stl")]
    assert [f.rsplit("_", 1)[1] for f in stls] == ["bone.stl", "csf.stl",
                                                   "skin.stl"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for f in stls:
        tj = j_read_stl(str(tmp_path / "jax" / f))
        tt = t_read_stl(str(tmp_path / "port" / f))
        assert len(tj) > 100
        np.testing.assert_array_equal(tt, tj)


if __name__ == "__main__":
    # The port-vs-JAX gaps that the registration tests above bound, printed:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_coreg.py
    fixed = _phantom()
    moving = _misalign(fixed, P_TRUE)
    _, aff, t1, zte = _zte_t1_head()
    t1 = t1.astype(np.float32)
    zte = np.asarray(zte, np.float32)
    cases = [
        ("phantom, levels=(2,), 200 iterations", fixed, moving, moving,
         dict(levels=(2,), iters_per_level=200, return_quality=True)),
        ("phantom, defaults", fixed, moving, moving,
         dict(return_quality=True)),
        # run_case's inputs: each package's own linear resample of the ZTE
        ("sphere head ZTE -> T1", t1,
         JI.resample_from_to(zte, aff, aff, t1.shape, order=1),
         TI.resample_from_to(zte, aff, aff, t1.shape, order=1, device="cpu"),
         dict(return_quality=True)),
    ]
    for name, fx, mv_j, mv_t, kw in cases:
        pj, _, qj = JC.register_rigid(fx, mv_j, **kw)
        pt, _, qt = TC.register_rigid(fx, mv_t, device="cpu", **kw)
        print(f"{name}: {np.rad2deg(np.abs(pt[:3] - pj[:3])).max():.4g} deg, "
              f"{np.abs(pt[3:] - pj[3:]).max():.4g} voxel, quality "
              f"{qj:.6f} (JAX) / {qt:.6f} (port)")
