"""Port parity: babelbrain_tpu_torch.ops.rayleigh (plain PyTorch) against the
JAX Rayleigh integral and the analytic piston/bowl checks of
`tests/test_rayleigh.py`.

The port computes distances by direct differences (the JAX package expands
|p|^2 - 2 p.c + |c|^2 for the TPU's matrix unit), so the two agree to
float32 rounding of the phases k r ~ 1e2-1e3 rad: rtol 1e-3 of max|p|.
The grid form (``rayleigh_field_grid``, the forward Rayleigh, whose points
the CUDA kernel builds from the axes) is held to the point list bit for
bit, to JAX's ``rayleigh_field_volume`` and split over CPU devices; a
float32 emulation of the kernel's pair (its phase reduced by whole turns)
is held to float64, since the kernel itself runs only on a card
(`tests/test_torch_kernels.py`).
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
    launches, plain = T.launches["rayleigh"], dict(T.plain_calls)
    got = T.rayleigh_sum(kr, ki, *args)
    assert T.plain_calls == {"rayleigh": plain["rayleigh"] + 1,
                             "rayleigh_grid": plain["rayleigh_grid"]}
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


def _grid_case(seed=5):
    """A CTX-500-sized bowl, its source terms and a small grid through its
    focal region, the axes off the bowl's axis and of unequal lengths."""
    tx = make_focused_bowl(F0, 63.2e-3, 64e-3, C0, ppw_surface=3)
    rng = np.random.default_rng(seed)
    u0 = (rng.uniform(0.5, 1, tx.num_subelements)
          * np.exp(1j * rng.uniform(-3, 3, tx.num_subelements))
          ).astype(np.complex64) * 60e3
    x = np.linspace(-6e-3, 5e-3, 9)
    y = np.linspace(-4e-3, 7e-3, 6)
    z = np.linspace(-12e-3, 10e-3, 11)
    return tx, u0, x, y, z


def _meshgrid_points(x, y, z):
    """The points a float32 meshgrid of the axes holds, in C order (the
    point list the forward Rayleigh built before its grid form)."""
    xp, yp, zp = np.meshgrid(x, y, z, indexing="ij")
    return np.stack([xp.ravel(), yp.ravel(), zp.ravel()], 1).astype(
        np.float32)


@pytest.mark.parametrize("alpha", [0.0, 30.0])
def test_grid_form_equals_the_point_list(alpha):
    """``rayleigh_field_grid`` on the axes equals ``rayleigh_field`` at the
    float32 meshgrid of them bit for bit: ``grid_inputs`` gives every point
    the coordinates ``sum_inputs`` gives it, and both sum alike."""
    tx, u0, x, y, z = _grid_case()
    k = K0 + 1j * alpha
    pts = _meshgrid_points(x, y, z)
    grid = T.rayleigh_field_grid(k, tx.centers, tx.areas, u0, x, y, z,
                                 device="cpu")
    flat = T.rayleigh_field(k, tx.centers, tx.areas, u0, pts, device="cpu")
    assert grid.shape == (len(x), len(y), len(z))
    np.testing.assert_array_equal(grid.reshape(-1), flat)
    kr, ki, c, w, (xs, ys, zs) = T.grid_inputs(k, tx.centers, tx.areas, u0,
                                               x, y, z)
    _, _, c2, w2, p2 = T.sum_inputs(k, tx.centers, tx.areas, u0, pts)
    np.testing.assert_array_equal(c, c2)
    np.testing.assert_array_equal(w, w2)
    np.testing.assert_array_equal(_meshgrid_points(xs, ys, zs), p2)
    t = [torch.as_tensor(a) for a in (c, w, xs, ys, zs)]
    np.testing.assert_array_equal(
        T.grid_points(*t[2:]).numpy(), p2)


@pytest.mark.parametrize("alpha", [0.0, 30.0])
def test_grid_form_matches_jax(alpha):
    """The grid form against JAX's ``rayleigh_field_volume`` at the point
    list's band (1e-3 of the peak), with and without attenuation."""
    tx, u0, x, y, z = _grid_case(9)
    k = K0 + 1j * alpha
    pj = np.asarray(J.rayleigh_field_volume(k, tx, u0, x, y, z))
    pt = T.rayleigh_field_volume(k, tx, u0, x, y, z, device="cpu")
    assert pt.dtype == np.complex64 and pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-3 * np.abs(pj).max())


@pytest.mark.parametrize("n_dev", [3, 4])
def test_grid_form_split_over_a_mesh_is_bit_equal(n_dev):
    """``mesh=`` splits the grid form in whole x planes (9 planes: runs of
    3 and of 3, 3, 3, 0); every point is the unsharded value bit for bit."""
    from babelbrain_tpu_torch.parallel.halo import make_mesh

    tx, u0, x, y, z = _grid_case()
    whole = T.rayleigh_field_grid(K0, tx.centers, tx.areas, u0, x, y, z,
                                  device="cpu")
    calls = dict(T.plain_calls)
    split = T.rayleigh_field_grid(
        K0, tx.centers, tx.areas, u0, x, y, z,
        mesh=make_mesh(n_dev, devices=["cpu"] * n_dev))
    # one plain call a non-empty run, counted once, under the grid form's key
    assert T.plain_calls == {"rayleigh": calls["rayleigh"],
                             "rayleigh_grid": calls["rayleigh_grid"] + 3}
    np.testing.assert_array_equal(split, whole)


def _kernel_pairs(r, kr, ki=0.0):
    """A float32 numpy emulation of ``csrc/rayleigh.cu`` pair()'s phase and
    amplitude for distances ``r`` (float32, the plain version's correctly
    rounded sqrt): theta = fl(r * fl(-kr)); n = rint(fl(theta / 2 pi));
    theta - n 2 pi by the kernel's two FMAs of its split 2 pi (each FMA one
    rounding: exact products and differences in float64, then float32);
    returns the reduced phase and the decay, float64 of float32 values."""
    f32 = np.float32
    th = (r * f32(-kr)).astype(f32)
    n = np.rint((th * f32(0.15915494309189535)).astype(f32)).astype(f32)
    red = (th.astype(np.float64) - n.astype(np.float64)
           * np.float64(f32(6.28125))).astype(f32)
    red = (red.astype(np.float64) - n.astype(np.float64)
           * np.float64(f32(1.9353071795864769e-3))).astype(f32)
    decay = (1.0 / r.astype(np.float64)) * np.exp(-ki * r.astype(np.float64))
    return red.astype(np.float64), th.astype(np.float64), decay


def test_kernel_phase_reduction_keeps_the_float32_phase():
    """The kernel reduces the phase kr r after its float32 product, by whole
    turns with a 2 pi split in two: against float64 its phase is off by the
    float32 product's rounding and at most 3e-7 rad more, at every distance
    of a 220 kHz dome and a 500 kHz CTX-500 grid (kr r up to ~1e3 rad);
    subtracting float32 multiples of 2 pi instead loses up to ~1e-4 rad."""
    rng = np.random.default_rng(2)
    for f, rmax in ((220e3, 0.25), (500e3, 0.16)):
        kr = 2 * np.pi * f / C0
        r = rng.uniform(1e-4, rmax, 200000).astype(np.float32)
        red, th, _ = _kernel_pairs(r, kr)
        exact = np.float64(np.float32(-kr)) * r.astype(np.float64)
        wrap = np.angle(np.exp(1j * (red - exact)))
        wrap32 = np.angle(np.exp(1j * (th - exact)))
        assert np.abs(red).max() <= np.pi + 1e-6
        assert np.abs(wrap - wrap32).max() <= 3e-7
        naive = (th - np.rint(th / (2 * np.pi)).astype(np.float32)
                 * np.float32(2 * np.pi)).astype(np.float32)
        lost = np.angle(np.exp(1j * (naive.astype(np.float64) - exact)))
        assert np.abs(lost - wrap32).max() > 1e-5


@pytest.mark.parametrize("alpha", [0.0, 30.0])
def test_kernel_pair_emulation_within_the_band(alpha):
    """The emulated kernel pairs (float32 phase, its reduction, the sine
    and cosine of the reduced phase), summed over a CTX-500 bowl's sources
    at points through the focus, agree with a float64 Rayleigh sum within
    chip_smoke's band of 2e-5 of the peak, as the plain version does."""
    tx, u0, x, y, z = _grid_case(4)
    k = K0 + 1j * alpha
    kr, ki, c, w, (xs, ys, zs) = T.grid_inputs(k, tx.centers, tx.areas, u0,
                                               x, y, z)
    pts = _meshgrid_points(xs, ys, zs)[::3]
    d = pts[:, None, :].astype(np.float32) - c[None, :, :]
    r2 = (((d[..., 0] * d[..., 0]).astype(np.float32)
           + (d[..., 1] * d[..., 1]).astype(np.float32)).astype(np.float32)
          + (d[..., 2] * d[..., 2]).astype(np.float32)).astype(np.float32)
    r = np.sqrt(r2.astype(np.float64)).astype(np.float32)
    red, _, decay = _kernel_pairs(r, kr, ki)
    got = (decay * np.exp(1j * red)) @ w.astype(np.complex128)
    r64 = np.sqrt((d.astype(np.float64) ** 2).sum(-1))
    exact = (np.exp(-ki * r64) / r64 * np.exp(-1j * kr * r64)) @ w.astype(
        np.complex128)
    plain = T.rayleigh_sum_ref(kr, ki, *(torch.as_tensor(a) for a in
                                         (c, w, pts))).numpy()
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() <= 2e-5 * scale
    assert np.abs(plain - exact).max() <= 2e-5 * scale


def test_rayleigh_leaves_tf32_as_it_found_it():
    """The plain version switches TF32 off for its own products only:
    ``torch.backends.cuda.matmul.allow_tf32`` is as before after a call,
    whichever way it was set, and off inside the call."""
    tx, u0, x, y, z = _grid_case()
    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(a, b)

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.Tensor.__matmul__ = spy
            try:
                T.rayleigh_field(K0, tx.centers, tx.areas, u0,
                                 _meshgrid_points(x, y, z), device="cpu")
                T.rayleigh_field_grid(K0, tx.centers, tx.areas, u0, x, y, z,
                                      device="cpu")
            finally:
                torch.Tensor.__matmul__ = matmul
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        assert seen and not any(seen)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
