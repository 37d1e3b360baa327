"""Port parity: babelbrain_tpu_torch.ops.bhte against the JAX BHTE.

The port's CPU path runs the plain PyTorch version of the BHTE step kernel
(6 interface conductivities pre-scaled by 1/dx^2, the Pallas formulation);
the JAX XLA scan scales the Laplacian after summing. Tolerances: temperature
and peak atol 1e-5 C; dose rtol 1e-5 (exp2 may differ by an ulp between
libraries); host-side maps and ``cem43`` exact.
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu.materials import build_thermal_material_list, material_array
from babelbrain_tpu.ops import bhte as J
from babelbrain_tpu_torch.ops import bhte as T
from babelbrain_tpu_torch.ops import bhte_kernels

torch.set_num_threads(2)


def _setup():
    """The fused-kernel parity setup of `tests/test_bhte.py`."""
    shape = (32, 32, 40)
    acoustic = material_array(
        500e3, tissues=("Water", "Skin", "Cortical", "Trabecular", "Brain")
    )
    mats = build_thermal_material_list(acoustic, ct_mode=False,
                                       segmented_brain=False)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 10:14] = 1
    idx[:, :, 14:20] = 2
    idx[:, :, 20:] = 4
    p = np.zeros(shape, np.float32)
    p[12:20, 12:20, 24:32] = 2e6
    return shape, mats, idx, p


def test_host_maps_bit_equal():
    _, mats, idx, p = _setup()
    a = J._build_coeff_maps(idx, mats, 5e-4, 0.01)
    b = T._build_coeff_maps(idx, mats, 5e-4, 0.01)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(J.absorption_heating(p, idx, mats, 0.3),
                                  T.absorption_heating(p, idx, mats, 0.3))


@pytest.mark.parametrize("initial", [False, True])
def test_on_off_schedule_matches_jax_xla(initial):
    shape, mats, idx, p = _setup()
    sched = [(0, 13, True), (0, 8, False), (0, 5, True)]
    common = dict(dt=0.01, duty_cycle=0.3,
                  monitor_points=[(16, 16, 28), (3, 4, 5), (31, 31, 39)],
                  arterial_temperature=37.0)
    if initial:
        rng = np.random.default_rng(2)
        common["initial_temperature"] = 37.0 + rng.uniform(0, 8, shape)
        common["initial_dose"] = rng.uniform(0, 1, shape)
    rx = J.bhte_run(p, idx, mats, 5e-4, sched, backend="xla", **common)
    rt = T.bhte_run(p, idx, mats, 5e-4, sched, device="cpu", **common)
    np.testing.assert_allclose(rt.temperature, rx.temperature, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.peak_temperature, rx.peak_temperature,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.dose, rx.dose, rtol=1e-5)
    # monitors are sampled after every step on both paths
    assert rt.monitor.shape == rx.monitor.shape == (3, 26)
    np.testing.assert_array_equal(rt.monitor_steps, rx.monitor_steps)
    np.testing.assert_allclose(rt.monitor, rx.monitor, rtol=0, atol=1e-5)


def test_multi_field_schedule_matches_jax_xla():
    shape, mats, idx, p = _setup()
    p2 = np.roll(p, 6, axis=0)
    sched = [(0, 6, True), (1, 6, True), (-1, 4, False), (1, 3, True)]
    kw = dict(dt=0.01, duty_cycle=0.5, monitor_points=[(16, 16, 28)])
    rx = J.bhte_run(np.stack([p, p2]), idx, mats, 5e-4, sched, backend="xla", **kw)
    rt = T.bhte_run(np.stack([p, p2]), idx, mats, 5e-4, sched, device="cpu", **kw)
    np.testing.assert_allclose(rt.temperature, rx.temperature, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.dose, rx.dose, rtol=1e-5)


def test_cem43_exact():
    rng = np.random.default_rng(4)
    temps = rng.uniform(36.0, 48.0, 200)
    assert T.cem43(0.01, temps) == J.cem43(0.01, temps)
    assert T.cem43(0.01, [43.0]) == pytest.approx(0.01)


def test_cpu_run_launches_no_kernel():
    shape, mats, idx, p = _setup()
    bhte_kernels.launches["bhte_step"] = 0
    bhte_kernels.plain_calls["bhte_step"] = 0
    T.bhte_run(p, idx, mats, 5e-4, [(0, 3, True), (0, 2, False)], device="cpu")
    assert bhte_kernels.launches["bhte_step"] == 0
    assert bhte_kernels.plain_calls["bhte_step"] == 5


def test_wrapper_rejects_bad_inputs():
    shape, mats, idx, p = _setup()
    co = T.make_bhte_coeffs(T._build_coeff_maps(idx, mats, 5e-4, 0.01), "cpu")
    Tm = torch.full(shape, 37.0)
    dose, peak = torch.zeros(shape), torch.zeros(shape)
    with pytest.raises(ValueError, match="alias"):
        bhte_kernels.bhte_step(Tm, dose, peak, co, None, 37.0, T_out=Tm)
    with pytest.raises(ValueError, match="float32"):
        bhte_kernels.bhte_step(Tm.double(), dose, peak, co, None, 37.0)
    with pytest.raises(ValueError, match="contiguous"):
        bhte_kernels.bhte_step(Tm, dose.transpose(0, 1), peak, co, None, 37.0)


@pytest.mark.parametrize("ct_mode", [False, True])
@pytest.mark.parametrize("segmented", [False, True])
def test_tissue_region_masks_match_jax(ct_mode, segmented):
    """Step 3's skin / skull / brain masks in label mode and CT mode."""
    from babelbrain_tpu.pipeline import thermal as JT
    from babelbrain_tpu_torch.pipeline import thermal as TT

    mm = np.random.default_rng(6).integers(0, 12, (12, 14, 16)).astype(np.uint32)
    a = JT.tissue_region_masks(mm, ct_mode=ct_mode, segmented=segmented)
    b = TT.tissue_region_masks(mm, ct_mode=ct_mode, segmented=segmented)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert all(m.any() for m in b)
