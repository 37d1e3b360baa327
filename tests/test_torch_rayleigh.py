"""Port parity: babelbrain_tpu_torch.ops.rayleigh (plain PyTorch) against the
JAX Rayleigh integral and the analytic piston/bowl checks of
`tests/test_rayleigh.py`.

The port computes distances by direct differences (the JAX package expands
|p|^2 - 2 p.c + |c|^2 for the TPU's matrix unit), so the two agree to
float32 rounding of the phases k r ~ 1e2-1e3 rad: rtol 1e-3 of max|p|.
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu.ops import rayleigh as J
from babelbrain_tpu.tx import make_annular_array, make_focused_bowl
from babelbrain_tpu_torch.ops import rayleigh as T

torch.set_num_threads(2)

F0 = 500e3
C0 = 1500.0
K0 = 2 * np.pi * F0 / C0


def bowl_on_axis(u0, k, F, beta2, zeta):
    """Exact on-axis bowl solution (geometric focus at origin)."""
    zeta = np.asarray(zeta, np.float64)
    r0 = np.abs(F + zeta)
    r2 = np.sqrt(F**2 + zeta**2 + 2 * F * zeta * np.cos(beta2))
    with np.errstate(invalid="ignore", divide="ignore"):
        p = u0 * F / zeta * (np.exp(-1j * k * r2) - np.exp(-1j * k * r0))
    focus = 1j * k * F * (1 - np.cos(beta2)) * u0 * np.exp(-1j * k * F)
    return np.where(np.abs(zeta) < 1e-12, focus, p)


@pytest.mark.parametrize("alpha", [0.0, 30.0])
def test_matches_jax_rayleigh_field(alpha):
    tx = make_focused_bowl(F0, 63.2e-3, 64e-3, C0, ppw_surface=4)
    rng = np.random.default_rng(7)
    u0 = (rng.uniform(0.5, 1, tx.num_subelements)
          * np.exp(1j * rng.uniform(-3, 3, tx.num_subelements))
          ).astype(np.complex64) * 60e3
    pts = rng.uniform(-30e-3, 30e-3, (1500, 3)).astype(np.float32)
    k = K0 + 1j * alpha
    pj = np.asarray(J.rayleigh_field(k, tx.centers, tx.areas, u0, pts))
    pt = T.rayleigh_field(k, tx.centers, tx.areas, u0, pts, device="cpu")
    assert pt.dtype == np.complex64 and pt.shape == pj.shape
    scale = np.abs(pj).max()
    # rtol 1e-3 of max|p|
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-3 * scale)


def test_focal_pressure_exact():
    F, D = 63.2e-3, 64e-3
    tx = make_focused_bowl(F0, F, D, C0)
    u0 = np.full(tx.num_subelements, 60e3, np.complex64)
    p = T.rayleigh_field(K0, tx.centers, tx.areas, u0,
                         np.zeros((1, 3), np.float32), device="cpu")
    beta2 = np.arcsin(D / 2 / F)
    expected = K0 * F * (1 - np.cos(beta2)) * 60e3
    assert np.abs(p[0]) == pytest.approx(expected, rel=2e-3)


def test_on_axis_profile():
    F, D = 63.2e-3, 64e-3
    tx = make_focused_bowl(F0, F, D, C0)
    u0 = np.full(tx.num_subelements, 1.0, np.complex64)
    zeta = np.linspace(-20e-3, 25e-3, 91)
    pts = np.zeros((len(zeta), 3), np.float32)
    pts[:, 2] = zeta
    p = T.rayleigh_field(K0, tx.centers, tx.areas, u0, pts, device="cpu")
    p_ref = bowl_on_axis(1.0, K0, F, np.arcsin(D / 2 / F), zeta)
    err = np.abs(p - p_ref) / np.abs(p_ref).max()
    assert err.max() < 5e-3


def test_attenuating_medium():
    alpha = 50.0  # Np/m
    F, D = 63.2e-3, 64e-3
    tx = make_focused_bowl(F0, F, D, C0)
    u0 = np.full(tx.num_subelements, 1.0, np.complex64)
    p0 = T.rayleigh_field(K0, tx.centers, tx.areas, u0, np.zeros((1, 3)),
                          device="cpu")
    pa = T.rayleigh_field(K0 + 1j * alpha, tx.centers, tx.areas, u0,
                          np.zeros((1, 3)), device="cpu")
    ratio = np.abs(pa[0]) / np.abs(p0[0])
    assert ratio == pytest.approx(np.exp(-alpha * F), rel=2e-3)


def test_blocking_invariance():
    tx = make_focused_bowl(F0, 63.2e-3, 64e-3, C0, ppw_surface=4)
    rng = np.random.default_rng(0)
    u0 = rng.normal(size=(tx.num_subelements, 2)).astype(np.float32)
    u0 = (u0[:, 0] + 1j * u0[:, 1]).astype(np.complex64)
    pts = np.random.default_rng(1).uniform(-0.03, 0.03, (257, 3)).astype(np.float32)
    p1 = T.rayleigh_field(K0, tx.centers, tx.areas, u0, pts, point_block=64,
                          elem_block=128, device="cpu")
    p2 = T.rayleigh_field(K0, tx.centers, tx.areas, u0, pts, point_block=512,
                          elem_block=4096, device="cpu")
    np.testing.assert_allclose(p1, p2, rtol=2e-4, atol=np.abs(p1).max() * 2e-4)


def test_steering_and_weights_match_jax():
    F = 62.94e-3
    tx = make_annular_array(
        F0, F, [0.0, 31.6988e-3, 44.2688e-3, 53.6688e-3],
        [31.14e-3, 43.71e-3, 53.11e-3, 60.83e-3], C0, ppw_surface=4,
    )
    wj = J.steering_phases(K0, tx.elem_centers, [0.0, 0.0, 8e-3])
    wt = T.steering_phases(K0, tx.elem_centers, [0.0, 0.0, 8e-3], device="cpu")
    np.testing.assert_allclose(np.angle(wt * np.conj(wj)), 0.0, atol=1e-4)
    np.testing.assert_array_equal(T.expand_element_weights(tx, wj),
                                  J.expand_element_weights(tx, wj))


def test_mesh_is_outside_the_slice():
    """``mesh`` takes a 1-D ``DeviceMesh``: another object, or a 2-D mesh
    (ROADMAP Queue A item 6), is refused."""
    from babelbrain_tpu_torch.parallel.halo import make_mesh_2d

    for mesh, err, match in ((object(), TypeError, "DeviceMesh"),
                             (make_mesh_2d(2, 2, devices=["cpu"] * 4),
                              NotImplementedError, "ROADMAP Queue A item 6")):
        with pytest.raises(err, match=match):
            T.rayleigh_field(K0, np.zeros((1, 3)), np.ones(1), np.ones(1),
                             np.ones((1, 3)), mesh=mesh, device="cpu")


def test_plain_version_runs_on_the_cpu_and_is_counted():
    """On CPU tensors ``rayleigh_sum`` runs its plain version (counted in
    ``plain_calls``, never in ``launches``) and equals it; ``rayleigh_field``
    hands it ``sum_inputs``'s arrays."""
    tx = make_focused_bowl(F0, 63.2e-3, 64e-3, C0, ppw_surface=2)
    u0 = np.full(tx.num_subelements, 6e4, np.complex64)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.01, 0.01, (300, 3))
    kr, ki, c, w, p = T.sum_inputs(K0, tx.centers, tx.areas, u0, pts)
    assert (c.dtype, w.dtype, p.dtype) == (np.float32, np.complex64,
                                           np.float32)
    args = [torch.as_tensor(a) for a in (c, w, p)]
    launches, plain = T.launches["rayleigh"], T.plain_calls["rayleigh"]
    got = T.rayleigh_sum(kr, ki, *args)
    assert T.plain_calls["rayleigh"] == plain + 1
    assert torch.equal(got, T.rayleigh_sum_ref(kr, ki, *args))
    field = T.rayleigh_field(K0, tx.centers, tx.areas, u0, pts, device="cpu")
    np.testing.assert_array_equal(field, got.numpy())
    assert T.launches["rayleigh"] == launches


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_rayleigh_sum_refuses_bad_inputs(bad):
    c = torch.zeros((4, 3))
    w = torch.zeros(4, dtype=torch.complex64)
    p = torch.zeros((5, 3))
    if bad == "dtype":
        with pytest.raises(ValueError, match="points must be contiguous"):
            T.rayleigh_sum(1.0, 0.0, c, w, p.double())
    elif bad == "shape":
        with pytest.raises(ValueError, match="expected"):
            T.rayleigh_sum(1.0, 0.0, c, w[:3].contiguous(), p)
    else:
        with pytest.raises(ValueError, match="unsupported device"):
            T.rayleigh_sum(1.0, 0.0, *(t.to("meta") for t in (c, w, p)))
