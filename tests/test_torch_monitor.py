"""The monitor voxel list of the MONITOR kernels (CPU).

The pressure / stress kernels of both FDTD families take the pressure
series themselves at a sample step (``csrc/fdtd_stencil.cuh`` Monitor):
each warp copies the listed voxels it has just written, found through
``ops.fdtd_extras.monitor_csr``, which sorts the voxels by the warp that
owns them under the family's launch geometry. The kernels need a card
(``tests/test_torch_kernels.py`` holds them to ``monitor_gather_ref`` bit
for bit); what they are given is checked here: every entry lies in the
warp that writes its voxel (the warps' cells enumerated from the tile
cover, independently of ``monitor_csr``'s arithmetic), every slot appears
once and names its voxel, repeats and unsorted input included; and on the
CPU the wrappers' plain path takes the same sample as the gather.
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu_torch.ops import fdtd as F
from babelbrain_tpu_torch.ops import fdtd_extras as E
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

GEOMETRIES = {"fluid": K.fluid_launch_geometry,
              "visco": V.visco_launch_geometry}


def _owner_volume(shape, geo):
    """The number of the warp whose threads write each cell, from the tile
    cover: thread (tx, ty) of block (bx, by, bz) takes k = bx TILE_Z + tx,
    j = by tile_y + ty and the planes of segment bz; its warp is row ty of
    block bx + gz (by + gy bz), numbered block * tile_y + ty."""
    n1, n2, n3 = shape
    gz, gy, gx = geo.grid
    seg_of = np.empty(n1, np.int64)
    for s in range(gx):
        seg_of[list(geo.planes(s, n1))] = s
    bx = np.repeat(np.arange(gz), K.TILE_Z)[:n3]
    by = np.repeat(np.arange(gy), geo.tile_y)[:n2]
    ty = np.tile(np.arange(geo.tile_y), gy)[:n2]
    block = (bx[None, None, :]
             + gz * (by[None, :, None] + gy * seg_of[:, None, None]))
    return block * geo.tile_y + ty[None, :, None]


def _voxels(shape, geo, rng):
    """Seeded voxels in no order, some twice, with the grid's first and
    last cells and a cell on a (y, z) tile corner at a segment start."""
    n = int(np.prod(shape))
    lin = rng.integers(0, n, 500)
    corner = np.ravel_multi_index(
        (min(geo.segment, shape[0] - 1), geo.tile_y, K.TILE_Z), shape)
    return np.concatenate([lin, lin[[3, 3, 41, 499]], [0, n - 1, corner]])


@pytest.mark.parametrize("shape", [(27, 45, 47), (216, 216, 224)])
@pytest.mark.parametrize("family", ["fluid", "visco"])
def test_monitor_csr_warps_own_their_voxels(family, shape):
    geo = GEOMETRIES[family](shape)
    lin = _voxels(shape, geo, np.random.default_rng(8))
    start, entries = E.monitor_csr(lin, shape, geo)
    n_warps = int(np.prod(geo.grid)) * geo.tile_y
    assert start.dtype == entries.dtype == np.int32
    assert start.shape == (n_warps + 1,) and entries.shape == (2, len(lin))
    assert start[0] == 0 and start[-1] == len(lin)
    assert (np.diff(start) >= 0).all()
    cell, slot = entries
    warp = np.repeat(np.arange(n_warps), np.diff(start))
    assert np.array_equal(_owner_volume(shape, geo).reshape(-1)[cell], warp)
    assert np.array_equal(np.sort(slot), np.arange(len(lin)))
    assert np.array_equal(lin[slot], cell)
    if shape[0] > 100:  # most warps hold no monitor: equal offsets
        assert (np.diff(start) == 0).mean() > 0.5


def test_monitor_csr_keeps_the_order_of_repeats_within_a_warp():
    shape = (27, 45, 47)
    geo = K.fluid_launch_geometry(shape)
    lin = np.array([5, 5, 7, 5, 3])
    start, (cell, slot) = E.monitor_csr(lin, shape, geo)
    assert np.diff(start).max() == 5  # one warp owns them all
    assert list(slot) == [0, 1, 2, 3, 4] and list(cell) == list(lin)


@pytest.mark.parametrize("family", ["fluid", "visco"])
def test_cpu_monitor_sample_equals_the_gather(family):
    """On CPU tensors the pressure / stress wrapper with a ``Monitor``
    runs the plain step and then ``monitor_gather_ref``: the sample is the
    new pressure at the listed voxels (repeats and order kept), or at every
    voxel."""
    shape = (20, 20, 24)
    mats = np.array([[1000.0, 1500.0, 0, 0, 0],
                     [1900.0, 2800.0, 1400.0 if family == "visco" else 0,
                      40.0, 0]])
    dx = 1500.0 / 500e3 / 6
    dt = 1 / 500e3 / int(np.ceil(1 / 500e3 / F.stable_dt(dx, 2800.0, 0.5)))
    grid = F.FDTDGrid(shape=shape, dx=dx, dt=dt, n_steps=12, frequency=500e3,
                      sensor_start=6)
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 16:20] = 1
    amp = np.full(shape[:2], 60e3)
    step, st, co, oz, _ = F.fdtd_setup(idx, mats, grid, amp,
                                       np.zeros(shape[:2]), device="cpu")
    assert isinstance(st, V.ViscoState if family == "visco" else K.FluidState)
    ijk = np.array([[10, 10, 22], [3, 4, 5], [10, 10, 22], [19, 0, 23]])
    index = E.monitor_index(ijk, shape, "cpu")
    listed = E.Diagnostics.create(st, grid.sensor_start, sample_steps=[11],
                                  index=index)
    full = E.Diagnostics.create(st, grid.sensor_start, sample_steps=[11])
    before = E.plain_calls[f"monitor_{family}"]
    for n in range(grid.n_steps):
        step(st, co, grid, n, oz, monitor=listed.monitor(n))
    assert listed.monitor(10) is None and full.monitor(11).row == 0
    full.monitor(11).gather_ref(st)
    assert E.plain_calls[f"monitor_{family}"] - before == 2
    p = (st.p if family == "fluid"
         else -(st.sxx + st.syy + st.szz) * (1.0 / 3.0))
    assert float(p.abs().max()) > 0
    want = p[tuple(torch.as_tensor(ijk.T))]
    assert torch.equal(listed.series[0], want)
    assert torch.equal(full.series[0], p.reshape(-1))
    assert not any(E.launches.values())
