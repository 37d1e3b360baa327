"""The port's rigid registration against the reference's robustness
harness, on a GPU.

Port of `tests/test_registration_robustness.py` (the capture-range sweep
on a 72^3 CT / T1-like pair with noise and coil shading, the failure
verdicts, the threshold constants, the B-spline bias hot spot) and of the
two `slow` registrations of `tests/test_pipeline.py:471-510` (an 11 deg /
5-voxel misalignment, and an inverted contrast under NCC and MI). Every
case runs the port's ``register_rigid(device="cuda")``, ``registration_ok``
and ``QUALITY_THRESHOLD`` of ``pipeline/coreg.py`` (``correct_bias_field``
of ``pipeline/bias.py`` on the host) on the reference's seeded inputs, at
the reference's bounds.

Marked ``slow`` and ``cuda``: run it on a GPU machine with

    python -m pytest -m "slow and cuda" \
        tests/test_torch_registration_robustness.py

This file imports nothing of the JAX package, so it runs where JAX is not
installed: ``head_pair``, ``apply_rigid`` and ``phantom`` are the
reference's, held to it bit for bit by
`tests/test_torch_validation_inputs.py`; ``misalign`` resamples with the
port's ``ops/imaging.resample_affine`` on the CPU where the reference takes
JAX's (the two differ in the last bit, ROADMAP "Imaging").
"""

import time

import numpy as np
import pytest
import torch

from babelbrain_tpu_torch.ops.imaging import resample_affine
from babelbrain_tpu_torch.pipeline.bias import correct_bias_field
from babelbrain_tpu_torch.pipeline.coreg import (
    QUALITY_THRESHOLD,
    euler_matrix,
    register_rigid,
    registration_ok,
)

pytestmark = [pytest.mark.slow, pytest.mark.cuda]

VOX_MM = 2.0
N = 72


def head_pair(rng):
    """(ct, t1) volumes with distinct modality contrasts, noise and a coil
    bias (`tests/test_registration_robustness.py:35-98`)."""
    ii, jj, kk = np.mgrid[0:N, 0:N, 0:N]
    c = (N - 1) / 2.0
    r = np.sqrt(
        ((ii - c) / 1.0) ** 2 + ((jj - c) / 0.92) ** 2
        + ((kk - c) / 1.15) ** 2
    ) + 1e-9
    # angular shape and thickness modulation: without them the shell is
    # rotation-invariant and no optimizer can see rotations
    ux = (ii - c) / (r + 1e-6)
    uy = (jj - c) / (r + 1e-6)
    uz = (kk - c) / (r + 1e-6)
    shape_mod = 1.0 + 0.10 * ux - 0.06 * uy + 0.08 * ux * uz - 0.05 * uz
    r_out = 26.0 * shape_mod
    thick = 4.0 + 2.5 * uz - 1.5 * ux * uy
    r_in = r_out - thick
    skull = (r > r_in) & (r < r_out)
    skin = (r >= r_out) & (r < r_out + 3.0)
    brain = r <= r_in
    ventricle = (
        np.sqrt((ii - c - 4) ** 2 + (jj - c) ** 2 + (kk - c + 3) ** 2) < 6
    )
    # asymmetric internal structure
    blob1 = (
        np.sqrt((ii - c - 11) ** 2 + (jj - c - 4) ** 2 + (kk - c + 7) ** 2)
        < 5
    )
    blob2 = (
        np.sqrt((ii - c + 8) ** 2 + (jj - c - 10) ** 2 + (kk - c - 8) ** 2)
        < 4
    )
    sinus = (
        np.sqrt((ii - c) ** 2 + (jj - c + 18) ** 2 + (kk - c - 12) ** 2) < 5
    )
    ct = np.zeros((N, N, N))
    ct[skin] = 40.0
    ct[brain] = 35.0
    ct[skull] = 1400.0
    ct[ventricle & brain] = 8.0
    ct[blob1 & brain] = 90.0
    ct[blob2 & brain] = 500.0
    ct[sinus] = -600.0  # air pocket
    t1 = np.zeros((N, N, N))
    t1[skin] = 620.0
    t1[brain] = 800.0 + 4.0 * (r[brain] - 10)  # graded gm/wm-ish
    t1[skull] = 120.0
    t1[ventricle & brain] = 300.0
    t1[blob1 & brain] = 1100.0
    t1[blob2 & brain] = 450.0
    t1[sinus] = 30.0
    # coil-shading bias on the MR, independent noise on both
    x = (ii - c) / N
    y = (jj - c) / N
    z = (kk - c) / N
    bias = np.exp(0.5 * x + 0.35 * y - 0.3 * z + 0.4 * x * y)
    t1 = t1 * bias
    ct = ct + rng.normal(0, 12.0, ct.shape)
    t1 = t1 + rng.normal(0, 25.0, t1.shape)
    return ct, t1


def apply_rigid(vol, rot_deg, trans_vox, rng_axis=0):
    """``vol`` misaligned by a known rotation (deg, about ``rng_axis``) and
    translation (voxels), linear interpolation (`:101-111`)."""
    from scipy import ndimage  # used only to build the ground truth

    angles = [0.0, 0.0, 0.0]
    angles[rng_axis] = np.deg2rad(rot_deg)
    R = np.asarray(euler_matrix(*angles))
    c = np.array(vol.shape) / 2.0
    offset = c - R @ c + np.asarray(trans_vox, float)
    return ndimage.affine_transform(vol, R, offset=offset, order=1)


def recovered_error(params, rot_deg, trans_vox, axis):
    """Error of the recovered transform against the inverse of the applied
    one: -rot about the axis, and -R^-1 t (`:114-129`)."""
    angles = [0.0, 0.0, 0.0]
    angles[axis] = np.deg2rad(rot_deg)
    R = np.asarray(euler_matrix(*angles))
    want_rot = np.zeros(3)
    want_rot[axis] = -rot_deg
    want_t = -R.T @ np.asarray(trans_vox, float)
    rots = np.rad2deg(params[:3])
    rot_err = np.abs(rots - want_rot).max()
    tr_err = np.abs(params[3:6] - want_t).max()
    return rot_err, tr_err


def phantom(n=48):
    """The ellipsoid-and-rods phantom of `tests/test_pipeline.py:450-458`."""
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n].astype(float)
    v = np.exp(
        -(((ii - 24) / 12) ** 2 + ((jj - 24) / 9) ** 2
          + ((kk - 24) / 15) ** 2)
    )
    v += 0.7 * np.exp(-(((ii - 30) / 2) ** 2 + ((jj - 18) / 2) ** 2))
    v += 0.5 * np.exp(-(((jj - 30) / 2) ** 2 + ((kk - 14) / 2) ** 2))
    return v


def misalign(fixed, p_true):
    """``fixed`` moved by the rigid transform ``p_true`` (`:460-469`), with
    the port's resampler on the CPU."""
    n = fixed.shape[0]
    R = np.asarray(euler_matrix(*p_true[:3]))
    c = np.full(3, n / 2.0)
    off = c - R @ c + p_true[3:]
    return resample_affine(fixed, np.linalg.inv(R), -np.linalg.inv(R) @ off,
                           fixed.shape, 1, device="cpu")


def register(tag, fixed, moving, **kw):
    """``register_rigid`` on the card, timed; prints its stages' loss
    evaluations (``stats=``) and returns its result."""
    stats = []
    t0 = time.time()
    out = register_rigid(fixed, moving, device="cuda", stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    evals = sum(s["evals"] for s in stats)
    print(f"[registration] {tag}: {wall:.3f} s, {evals} evaluations ("
          + ", ".join(f"{s['stage']} {s['evals']}" for s in stats) + ")")
    return out


CASES_NCC = [
    # (rot_deg, axis, translation_vox)  - 1 vox = 2 mm
    (5.0, 2, (0, 0, 0)),
    (10.0, 2, (0, 0, 0)),
    (15.0, 0, (0, 0, 0)),
    (-15.0, 1, (0, 0, 0)),
    (0.0, 2, (5, -3, 2)),       # 10/6/4 mm
    (0.0, 2, (10, 0, -10)),     # 20 mm
    (10.0, 2, (5, 5, -5)),      # combined 10 deg + 10 mm
]
CASES_MI = [
    (10.0, 2, (0, 0, 0)),
    (0.0, 2, (7, 0, -4)),       # 14 mm
]
# the small-angle regime the terminal NGF polish serves (the reference's
# floors: < 0.5 deg / 0.5 voxel), and the phantom's weakest rotation axis,
# y (< 1.0 deg / 0.5 voxel)
CASES_SMALL = [
    (2.5, 2, (0, 0, 0)),
    (0.5, 0, (0.5, 0.5, 0)),
    (2.0, 0, (1.0, 0, 0)),
    (3.0, 1, (0, 0, 1.5)),
]
CASES_SMALL_Y = [(1.0, 1, (0, 2.0, 0))]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these registrations run the port "
                    "on the card")
    return "cuda"


class TestCaptureRange:
    @pytest.fixture(scope="class")
    def pair(self, cuda):
        return head_pair(np.random.default_rng(3))

    def _run(self, pair, rot, axis, tr, metric):
        ct, t1 = pair
        moved = apply_rigid(ct, rot, tr, axis)
        p, _, q = register(f"{metric} {rot} deg about {axis}, {tr} vox", t1,
                           moved, metric=metric, return_quality=True)
        rot_err, tr_err = recovered_error(p, rot, tr, axis)
        print(f"[registration]   error {rot_err:.4f} deg, {tr_err:.4f} vox; "
              f"quality {q:.4f}")
        return rot_err, tr_err, q

    @pytest.mark.parametrize("rot,axis,tr", CASES_NCC)
    def test_ncc_capture(self, pair, rot, axis, tr):
        rot_err, tr_err, q = self._run(pair, rot, axis, tr, "ncc")
        assert rot_err < 1.0, (rot_err, tr_err, q)
        assert tr_err < 1.0, (rot_err, tr_err, q)
        assert registration_ok(q, "ncc"), q

    @pytest.mark.parametrize("rot,axis,tr", CASES_MI)
    def test_mi_capture(self, pair, rot, axis, tr):
        rot_err, tr_err, q = self._run(pair, rot, axis, tr, "mi")
        assert rot_err < 1.5, (rot_err, tr_err, q)
        assert tr_err < 1.5, (rot_err, tr_err, q)
        assert registration_ok(q, "mi"), q

    @pytest.mark.parametrize("rot,axis,tr", CASES_SMALL)
    def test_small_angle_accuracy_floor(self, pair, rot, axis, tr):
        rot_err, tr_err, q = self._run(pair, rot, axis, tr, "ncc")
        assert rot_err < 0.5, (rot_err, tr_err, q)
        assert tr_err < 0.5, (rot_err, tr_err, q)

    @pytest.mark.parametrize("rot,axis,tr", CASES_SMALL_Y)
    def test_small_angle_floor_weak_y_axis(self, pair, rot, axis, tr):
        rot_err, tr_err, q = self._run(pair, rot, axis, tr, "ncc")
        assert rot_err < 1.0, (rot_err, tr_err, q)
        assert tr_err < 0.5, (rot_err, tr_err, q)


class TestFailureDetection:
    """The quality score separates successes from failures at the
    thresholds of ``QUALITY_THRESHOLD``."""

    def test_wrong_anatomy_scores_below_threshold(self, cuda):
        rng = np.random.default_rng(4)
        ct, t1 = head_pair(rng)
        # "wrong anatomy": a shifted, differently-shaped ellipsoid set
        ii, jj, kk = np.mgrid[0:N, 0:N, 0:N]
        c = (N - 1) / 2.0
        r2 = np.sqrt(
            ((ii - c - 9) / 1.4) ** 2 + ((jj - c + 7) / 0.7) ** 2
            + ((kk - c) / 0.9) ** 2
        )
        other = np.where((r2 > 15) & (r2 < 18), 1400.0, 30.0)
        other = other + rng.normal(0, 12.0, other.shape)
        _, _, q_bad = register("wrong anatomy", t1, other, metric="ncc",
                               return_quality=True)
        print(f"[registration]   quality {q_bad:.4f}")
        assert not registration_ok(q_bad, "ncc"), q_bad

    def test_diverged_registration_scores_below_threshold(self, cuda):
        rng = np.random.default_rng(5)
        ct, t1 = head_pair(rng)
        # far outside the capture range (40 deg + 30 mm) with a handful of
        # iterations
        moved = apply_rigid(ct, 40.0, (15, -15, 10), 2)
        p, _, q = register("diverged", t1, moved, metric="ncc",
                           return_quality=True, levels=(4,),
                           iters_per_level=30)
        rot_err, tr_err = recovered_error(p, 40.0, (15, -15, 10), 2)
        print(f"[registration]   error {rot_err:.4f} deg, {tr_err:.4f} vox; "
              f"quality {q:.4f}")
        assert rot_err > 2.0 or tr_err > 2.0  # genuinely failed
        assert not registration_ok(q, "ncc"), q

    def test_threshold_gap_documented(self):
        assert 0.2 < QUALITY_THRESHOLD["ncc"] < 0.6
        assert 0.1 < QUALITY_THRESHOLD["mi"] < 0.5


def test_bspline_bias_recovers_local_hotspot(cuda):
    """The B-spline bias basis captures a local coil hot spot that the
    global polynomial cannot (`tests/test_registration_robustness.py:
    253-287`)."""
    rng = np.random.default_rng(6)
    n = 64
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n]
    c = (n - 1) / 2
    r = np.sqrt((ii - c) ** 2 + (jj - c) ** 2 + (kk - c) ** 2)
    head = r < 26
    img = np.where(head, 1000.0, 0.0)
    # local hot spot in one octant (surface coil), plus a global tilt
    hot = np.exp(
        0.9 * np.exp(-(((ii - 10.0) ** 2 + (jj - 10.0) ** 2
                        + (kk - 32.0) ** 2) / (2 * 14.0**2)))
        + 0.15 * (ii - c) / n
    )
    meas = img * hot + rng.normal(0, 8.0, img.shape)

    out_p, bias_p = correct_bias_field(meas, head, basis="poly", order=3)
    out_b, bias_b = correct_bias_field(meas, head, basis="bspline", n_ctrl=7)

    def cv(v):
        x = v[head]
        return np.std(x) / np.mean(x)

    bb = bias_b[head] / np.mean(bias_b[head])
    hh = hot[head] / np.mean(hot[head])
    corr = np.corrcoef(bb, hh)[0, 1]
    print(f"[bias] cv: measured {cv(meas):.5f}, poly {cv(out_p):.5f}, "
          f"bspline {cv(out_b):.5f}; correlation {corr:.5f}")
    assert cv(out_b) < cv(meas) * 0.45
    assert cv(out_b) <= cv(out_p) * 1.02  # at least matches the polynomial
    assert corr > 0.9, corr


class TestLargeMisalignment:
    """`tests/test_pipeline.py:471-510`."""

    def test_convergence_radius_large_misalignment(self, cuda):
        """~11 deg rotation and 5-voxel shifts converge."""
        fixed = phantom()
        p_true = np.array([0.2, -0.15, 0.12, 5.0, -4.0, 3.0])
        moving = misalign(fixed, p_true)
        p, m, q = register("11 deg / 5 voxels", fixed, moving,
                           levels=(4, 2), iters_per_level=300,
                           return_quality=True)
        print(f"[registration]   params {p}, truth {p_true}; quality {q:.4f}")
        np.testing.assert_allclose(p[:3], p_true[:3], atol=0.03)
        np.testing.assert_allclose(p[3:], p_true[3:], atol=0.8)
        assert q > 0.9  # NCC quality signals success

    def test_multimodal_contrast(self, cuda):
        """An inverted, nonlinearly remapped contrast: gradient NCC and
        Parzen MI both recover the transform."""
        fixed = phantom()
        p_true = np.array([0.05, 0.08, -0.06, 2.0, -2.5, 1.5])
        shifted = misalign(fixed, p_true)
        moving = 1.0 / (0.3 + shifted) - 0.5 * shifted**2
        p, _ = register("inverted contrast, ncc", fixed, moving,
                        levels=(2, 1), iters_per_level=150)
        print(f"[registration]   params {p}, truth {p_true}")
        np.testing.assert_allclose(p[:3], p_true[:3], atol=0.03)
        np.testing.assert_allclose(p[3:], p_true[3:], atol=0.8)
        p_mi, _, q_mi = register("inverted contrast, mi", fixed, moving,
                                 levels=(2, 1), iters_per_level=150,
                                 metric="mi", return_quality=True)
        print(f"[registration]   params {p_mi}, truth {p_true}; quality "
              f"{q_mi:.4f}")
        np.testing.assert_allclose(p_mi[:3], p_true[:3], atol=0.05)
        np.testing.assert_allclose(p_mi[3:], p_true[3:], atol=1.0)
        assert q_mi > 0.2
