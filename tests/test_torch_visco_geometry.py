"""The launch geometry of the FDTD kernels (CPU): visco and fluid.

``ops.fdtd_kernels.launch_geometry`` chooses how the kernels of
``csrc/fdtd_visco.cu`` and ``csrc/fdtd_fluid.cu`` cut the grid
(``visco_launch_geometry``, ``fluid_launch_geometry``: each family's
segment length): blocks of ``TILE_Z`` x ``tile_y`` threads, each owning a
(y, z) tile of columns (thread (tx, ty) of block (bx, by, bz) takes k = bx
TILE_Z + tx, j = by tile_y + ty) and marching along x over the planes of
segment bz. The wrappers launch exactly that grid, and the entry points
refuse one that does not cover the volume once. The kernels need a card;
what they are given is checked here: every cell is updated by exactly one
thread, every block owns at least one cell, and the grid holds enough
blocks for the card's SMs at the main path's shapes. The planes a segment
reads beyond its ends are bounded inside the kernels (a plane outside
[0, N1) reads as zero); the card tests hold that bit for bit at ragged N1.
The fluid wrappers' input checks (the material index against its table,
the 32-bit offsets) are checked here too.
"""

import numpy as np
import pytest
import torch

from babelbrain_tpu_torch.ops import fdtd as F
from babelbrain_tpu_torch.ops import fdtd_kernels as K
from babelbrain_tpu_torch.ops import fdtd_visco_kernels as V

# the kernel phase's grid, the label slices' FDTD grid, and ragged grids
# (N3 off the 32-wide z-tile, N2 off the y-tile, N1 < 2 ns, N1 that no
# segment length divides, a grid no larger than one CPML slab, a last
# segment of one plane)
SHAPES = [(192, 192, 240), (216, 216, 224), (27, 45, 47), (37, 41, 57),
          (14, 14, 14), (57, 19, 33)]
LARGE = {(192, 192, 240), (216, 216, 224)}
H100_SMS = 132


def _axis_cover(n_tiles, tile, n):
    """How often each index in [0, n) is taken by the tiles' threads."""
    idx = (np.arange(n_tiles)[:, None] * tile + np.arange(tile)).ravel()
    return np.bincount(idx[idx < n], minlength=n)


def _check_geometry(geo, shape, segment_planes):
    n1, n2, n3 = shape
    nz, ny, nx = geo.grid
    # every (j, k) column by exactly one thread, every plane by one segment
    assert np.array_equal(_axis_cover(nz, K.TILE_Z, n3), np.ones(n3))
    assert np.array_equal(_axis_cover(ny, geo.tile_y, n2), np.ones(n2))
    planes = np.concatenate([list(geo.planes(s, n1)) for s in range(nx)])
    assert np.array_equal(planes, np.arange(n1))
    # no block without a cell (the entry points refuse such a grid)
    assert (nz - 1) * K.TILE_Z < n3 and (ny - 1) * geo.tile_y < n2
    assert all(len(geo.planes(s, n1)) > 0 for s in range(nx))
    assert K.TILE_Z == 32  # a warp along z: 128-byte rows
    assert K.TILE_Z * geo.tile_y <= 1024
    if shape in LARGE:
        assert np.prod(geo.grid) >= 2 * H100_SMS
        assert geo.segment <= segment_planes


@pytest.mark.parametrize("shape", SHAPES)
def test_visco_launch_geometry_covers_the_grid(shape):
    _check_geometry(V.visco_launch_geometry(shape), shape, V.SEGMENT_PLANES)


@pytest.mark.parametrize("shape", SHAPES)
def test_fluid_launch_geometry_covers_the_grid(shape):
    _check_geometry(K.fluid_launch_geometry(shape), shape, K.SEGMENT_PLANES)


def test_visco_step_rejects_grids_beyond_32_bit_offsets():
    """The kernels index cells with 32-bit offsets: a grid of 2^31 cells or
    more is refused before any launch; one just below is not."""
    with pytest.raises(ValueError, match="32-bit"):
        V._check_size((1300, 1300, 1300))
    with pytest.raises(ValueError, match="32-bit"):
        V._check_size((2, 1024, 1024 * 1024))  # exactly 2^31
    V._check_size((1290, 1290, 1290))
    V._check_size((392, 392, 337))


def _fluid_inputs(shape=(16, 18, 20), n_mat=3):
    """A quiet fluid state and coefficients on the CPU, index 0 everywhere."""
    grid = F.FDTDGrid(shape=shape, dx=5e-4, dt=5e-8, n_steps=2,
                      frequency=5e5, npml=4)
    mats = np.tile([[1000.0, 1500.0, 0.0, 1.0, 0.0]], (n_mat, 1))
    coefs = F.sls_coefficients(mats, grid.frequency, grid.dt)
    idx, table = F._build_indexed_materials(coefs, np.zeros(shape), None)
    prof = F._build_cpml_profiles_np(shape, 4, grid.dx, grid.dt, 1500.0, 1e-5)
    z2 = np.zeros(shape[:2])
    co = F.make_fluid_coeffs(idx, table, prof, z2, z2, grid, True, "cpu")
    return K.FluidState.zeros(shape, 6, "cpu"), co


@pytest.mark.parametrize("case", ["above", "negative", "int64", "float"])
def test_fluid_step_refuses_a_bad_material_index(case):
    """The fluid wrappers refuse an index outside the table or not int32,
    before any work; an index that the table holds passes."""
    st, co = _fluid_inputs()
    K.fluid_velocity(st, co, 0.0, 0.0)
    if case == "above":
        co.mat_idx[3, 4, 5] = co.table.shape[1]  # one past the last
        match = "outside the table"
    elif case == "negative":
        co.mat_idx[0, 0, 0] = -1
        match = "outside the table"
    else:
        co.mat_idx = co.mat_idx.to(torch.int64 if case == "int64"
                                   else torch.float32)
        match = "int32"
    before = dict(K.plain_calls)
    for call in (lambda: K.fluid_velocity(st, co, 0.0, 0.0),
                 lambda: K.fluid_pressure(st, co)):
        with pytest.raises(ValueError, match=match):
            call()
    assert K.plain_calls == before
    with pytest.raises(ValueError, match="outside the table"):
        F.make_fluid_coeffs(np.full((16, 18, 20), 3), co.table.numpy(),
                            F._build_cpml_profiles_np((16, 18, 20), 4, 5e-4,
                                                      5e-8, 1500.0, 1e-5),
                            np.zeros((16, 18)), np.zeros((16, 18)),
                            F.FDTDGrid(shape=(16, 18, 20), dx=5e-4, dt=5e-8,
                                       n_steps=2, frequency=5e5),
                            True, "cpu")


def test_fluid_step_rejects_grids_beyond_32_bit_offsets():
    """The fluid kernels index cells with 32-bit offsets too: the CUDA
    route refuses a grid of 2^31 cells or more, naming the fluid step."""
    with pytest.raises(ValueError, match="fluid step: .* 32-bit"):
        K._check_size((2, 1024, 1024 * 1024), "fluid step")  # exactly 2^31
    with pytest.raises(ValueError, match="32-bit"):
        K._check_size((392 * 4, 392 * 4, 337 * 4), "fluid step")
    K._check_size((1290, 1290, 1290), "fluid step")
    K._check_size((392, 392, 337), "fluid step")
