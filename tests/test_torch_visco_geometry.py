"""The launch geometry of the viscoelastic FDTD kernels (CPU).

``ops.fdtd_visco_kernels.visco_launch_geometry`` chooses how the kernels of
``csrc/fdtd_visco.cu`` cut the grid: blocks of ``TILE_Z`` x ``tile_y``
threads, each owning a (y, z) tile of columns (thread (tx, ty) of block
(bx, by, bz) takes k = bx TILE_Z + tx, j = by tile_y + ty) and marching along
x over the planes of segment bz. The wrappers launch exactly that grid, and
the entry points refuse one that does not cover the volume once. The kernels
need a card; what they are given is checked here: every cell is updated by
exactly one thread, every block owns at least one cell, and the grid holds
enough blocks for the card's SMs at the main path's shapes. The planes a
segment reads beyond its ends are bounded inside the kernels (a plane
outside [0, N1) reads as zero); the card tests hold that bit for bit at
ragged N1.
"""

import numpy as np
import pytest

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


@pytest.mark.parametrize("shape", SHAPES)
def test_visco_launch_geometry_covers_the_grid(shape):
    n1, n2, n3 = shape
    geo = V.visco_launch_geometry(shape)
    nz, ny, nx = geo.grid
    # every (j, k) column by exactly one thread, every plane by one segment
    assert np.array_equal(_axis_cover(nz, V.TILE_Z, n3), np.ones(n3))
    assert np.array_equal(_axis_cover(ny, geo.tile_y, n2), np.ones(n2))
    planes = np.concatenate([list(geo.planes(s, n1)) for s in range(nx)])
    assert np.array_equal(planes, np.arange(n1))
    # no block without a cell (the entry points refuse such a grid)
    assert (nz - 1) * V.TILE_Z < n3 and (ny - 1) * geo.tile_y < n2
    assert all(len(geo.planes(s, n1)) > 0 for s in range(nx))
    assert V.TILE_Z == 32  # a warp along z: 128-byte rows
    assert V.TILE_Z * geo.tile_y <= 1024
    if shape in LARGE:
        assert np.prod(geo.grid) >= 2 * H100_SMS
        assert geo.segment <= V.SEGMENT_PLANES


def test_visco_step_rejects_grids_beyond_32_bit_offsets():
    """The kernels index cells with 32-bit offsets: a grid of 2^31 cells or
    more is refused before any launch; one just below is not."""
    with pytest.raises(ValueError, match="32-bit"):
        V._check_size((1300, 1300, 1300))
    with pytest.raises(ValueError, match="32-bit"):
        V._check_size((2, 1024, 1024 * 1024))  # exactly 2^31
    V._check_size((1290, 1290, 1290))
    V._check_size((392, 392, 337))
