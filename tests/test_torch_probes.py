"""Port parity: the roofline and gather probes of babelbrain_tpu_torch.

* P2: the table gather (``probes.table_gather``, on the CPU its plain
  version) against the JAX probe's own Pallas kernels
  (``tools/probe_gather.py`` ``kernel_axis0`` / ``kernel_axis1``) in
  interpret mode, on every (R, C, M) case of its ``main``: equal bit for
  bit.
* P1: the CT (4 coefficients of 1026) and label (6 of 16) expansions of
  ``probe_gather`` equal ``table[r][idx]``; the FMA chain of ``probe_vpu``
  equals the same chain with one rounding a step, computed in numpy's
  extended precision.
* ``run_probes`` on the CPU at a small size: every probe exact, no device
  time, no launch.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from babelbrain_tpu_torch import probes

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import probe_gather as PG  # noqa: E402

torch.set_num_threads(2)

AXIS0_CASES = ((8, 128, 8), (64, 128, 8), (64, 128, 64), (960, 192, 960),
               (960, 192, 1152), (1152, 192, 1152))
AXIS1_CASES = ((8, 128, 128), (64, 192, 128), (64, 192, 16), (64, 256, 256),
               (64, 1024, 1024))


def test_p2_cases_are_the_jax_probe_cases():
    assert probes.P2_CASES == AXIS0_CASES + AXIS1_CASES


@pytest.mark.parametrize("axis,case", [(0, c) for c in AXIS0_CASES]
                         + [(1, c) for c in AXIS1_CASES])
def test_table_gather_matches_jax_p2_kernel(axis, case):
    """The inputs of `tools/probe_gather.py` ``try_case`` (seed 0) through
    its Pallas kernel (interpret mode) and through the port's gather."""
    r, c, m = case
    rng = np.random.default_rng(0)
    idx = rng.integers(0, m, size=(r, c)).astype(np.int32)
    tab_shape = (m, 1) if axis == 0 else (1, m)
    tab = rng.standard_normal(tab_shape).astype(np.float32)
    kern = PG.kernel_axis0 if axis == 0 else PG.kernel_axis1
    f = pl.pallas_call(functools.partial(kern, M=m),
                       out_shape=jax.ShapeDtypeStruct((r, c), jnp.float32),
                       interpret=True)
    want = np.asarray(jax.jit(f)(jnp.asarray(idx), jnp.asarray(tab)))
    out = torch.empty((1, r, c))
    probes.table_gather(torch.as_tensor(idx),
                        torch.as_tensor(tab.reshape(1, m)), out)
    np.testing.assert_array_equal(out[0].numpy(), want)


@pytest.mark.parametrize("n_coef,m", [(4, 1026), (6, 16)])
def test_table_expansion_is_the_table_row(n_coef, m):
    idx, tab = probes.gather_inputs(probes.GATHER_SLAB, m, n_coef,
                                    device="cpu")
    out = torch.empty((n_coef,) + probes.GATHER_SLAB)
    probes.table_gather(idx, tab, out)
    t, i = tab.numpy(), idx.numpy()
    for r in range(n_coef):
        np.testing.assert_array_equal(out[r].numpy(), t[r][i])


def test_fma_chain_rounds_once_a_step():
    """Each step a = a * 1.000001 + x rounded once to float32, against the
    same chain in numpy's extended precision (its 64-bit significand holds
    the exact product and sum), from x in [1, 2)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(1.0, 2.0, (16, 32)).astype(np.float32)
    rep = 300
    out = torch.empty(x.shape)
    probes.fma_chain(torch.as_tensor(x), torch.as_tensor(probes.FMA_SCALE),
                     out, rep)
    xl = x.astype(np.longdouble)
    mul = np.longdouble(probes.FMA_MUL)
    a = [x * s for s in probes.FMA_SCALE]  # float32 products
    for _ in range(rep):
        a = [(ai.astype(np.longdouble) * mul + xl).astype(np.float32)
             for ai in a]
    want = a[0]
    for aj in a[1:]:
        want = want + aj
    np.testing.assert_array_equal(out.numpy(), want)
    # and the fused step differs from a separately rounded multiply and add
    sep = [x * s for s in probes.FMA_SCALE]
    for _ in range(rep):
        sep = [ai * probes.FMA_MUL + x for ai in sep]
    assert not np.array_equal(sum(sep[1:], sep[0]), want)


def test_run_probes_on_cpu_takes_no_device_time():
    for d in (probes.launches, probes.plain_calls):
        for k in d:
            d[k] = 0
    res = probes.run_probes(device="cpu", small=True)
    names = [r["probe"] for r in res]
    assert names == ["stream", "fma_chain", "gather_ct", "gather_label",
                     "gather_cases"]
    for r in res:
        assert r.get("exact", True) and not r.get("wrong"), r
        assert r["ms"] is None or r["ms"] == [None, None], r
    assert not any(probes.launches.values())
    assert all(probes.plain_calls.values())


def test_probe_wrappers_check_their_inputs():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="float32"):
        probes.stream(x.double(), x)
    with pytest.raises(ValueError, match="8 scales"):
        probes.fma_chain(x, torch.ones(3), x, 1)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="table of"):
        probes.table_gather(idx, torch.zeros((4, 4096)),
                            torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="int32"):
        probes.table_gather(idx.long(), torch.zeros((1, 4)),
                            torch.zeros((1, 8)))
