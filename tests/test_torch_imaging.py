"""Port parity: babelbrain_tpu_torch.ops.imaging against the JAX image ops.

Median, closing, erosion, labeling, largest component and the quantized
table lookup are exact on integer / binary volumes; nearest-neighbour
resampling is exact; linear resampling agrees within atol 1e-5 on O(1)
data (float32 interpolation weights summed in the same order), cubic within
1e-5 of the data range.
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import imaging as J
from babelbrain_tpu_torch.ops import imaging as T

torch.set_num_threads(2)


@pytest.fixture
def vols():
    rng = np.random.default_rng(0)
    return {
        "labels": rng.integers(0, 5, (20, 22, 19)).astype(np.uint8),
        "hu": rng.normal(0, 100, (20, 22, 19)).astype(np.float32),
        "mask": rng.random((20, 22, 19)) > 0.6,
        "unit": rng.normal(0, 1, (20, 22, 19)).astype(np.float32),
    }


@pytest.mark.parametrize("key", ["labels", "hu"])
def test_median_filter3d_exact(vols, key):
    a = J.median_filter3d(vols[key], 3)
    b = T.median_filter3d(vols[key], 3, device="cpu")
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [3, 5])
def test_binary_close_and_erode_exact(vols, size):
    m = vols["mask"]
    np.testing.assert_array_equal(J.binary_close(m, size),
                                  T.binary_close(m, size, device="cpu"))
    np.testing.assert_array_equal(J.binary_erode(m, size),
                                  T.binary_erode(m, size, device="cpu"))


def test_label_and_largest_component_exact(vols):
    m = vols["mask"]
    la, ka = J.label_components(m)
    lb, kb = T.label_components(m, device="cpu")
    assert ka == kb
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(J.largest_component(m),
                                  T.largest_component(m, device="cpu"))
    empty = np.zeros((4, 5, 6), bool)
    assert not T.largest_component(empty, device="cpu").any()


def test_map_to_unique_exact(vols):
    uv = np.sort(np.random.default_rng(1).normal(0, 100, 50)).astype(np.float32)
    for mask in (None, vols["mask"]):
        np.testing.assert_array_equal(
            J.map_to_unique(vols["hu"], uv, mask),
            T.map_to_unique(vols["hu"], uv, mask, device="cpu"),
        )


def _affines():
    a1 = np.diag([2.0, 2.0, 2.0, 1.0])
    a1[:3, 3] = -20.0
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th), 0.0],
                    [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    a2 = np.eye(4)
    a2[:3, :3] = rot * 0.7
    a2[:3, 3] = [-5.0, -6.0, -7.0]
    return a1, a2


def test_resample_nearest_exact(vols):
    a1, a2 = _affines()
    for key in ("labels", "hu"):
        v = vols[key].astype(np.float32)
        np.testing.assert_array_equal(
            J.resample_from_to(v, a1, a2, (25, 24, 23), order=0),
            T.resample_from_to(v, a1, a2, (25, 24, 23), order=0, device="cpu"),
        )


def test_resample_linear_close(vols):
    a1, a2 = _affines()
    v = vols["unit"]
    np.testing.assert_allclose(
        T.resample_from_to(v, a1, a2, (25, 24, 23), order=1, device="cpu"),
        J.resample_from_to(v, a1, a2, (25, 24, 23), order=1),
        rtol=0, atol=1e-5,
    )


def test_resample_cubic_close(vols):
    a1, a2 = _affines()
    v = vols["hu"]
    span = float(v.max() - v.min())
    np.testing.assert_allclose(
        T.resample_from_to(v, a1, a2, (25, 24, 23), order=3, device="cpu"),
        J.resample_from_to(v, a1, a2, (25, 24, 23), order=3),
        rtol=0, atol=1e-5 * span,
    )
