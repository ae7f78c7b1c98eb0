"""The CUDA hyperbolic-TV kernel's decomposition, on the CPU.

The kernel cannot run here, so these tests hold what surrounds it: the
wrapper's launch geometry (``tv_launch``: grid, z ranges, partials per
volume, the 65535 limit, the choice of instantiation), and a float64 NumPy
walk of that geometry that does what each block does — stage each plane's
footprint (rows y0-1 .. y0+TY, columns x0-4 .. x0+TX+3, zero outside the
volume), rebuild the incoming w_z from the plane before its z range, take
the halo row's w_y and the halo column's w_x from the staged planes, sum
one cost partial per block and the volume's partials in index order. At
awkward shapes it must give the plain versions' cost and gradient, which
tests/test_torch_tv.py and tests/test_torch_batched_tv.py hold to the JAX
package. The whole-volume launch's z range is a compile-time constant
(``hv.Z_RANGE``, 32 planes); the walk also takes shorter ones, so that
volumes this small still have z ranges that end mid-volume. It also walks a
z-slab with its halo planes as the slab entry stages them
(tests/test_torch_tv_slabs.py).
"""

import numpy as np
import pytest
import torch

from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

TX, TY, HALO_X = hv.TILE_X, hv.TILE_Y, 4
TOL = 1e-12


def _weights(v0, vz, vy, vx, hz, hy, hx, inv, eps):
    """D, w_z, w_y, w_x from a point's value and its forward neighbours,
    each difference masked where the neighbour is outside the volume."""
    dz = np.where(hz, (vz - v0) * inv[0], 0.0)
    dy = np.where(hy, (vy - v0) * inv[1], 0.0)
    dx = np.where(hx, (vx - v0) * inv[2], 0.0)
    den = np.sqrt(dz * dz + dy * dy + dx * dx + eps * eps)
    return den, dz / den * inv[0], dy / den * inv[1], dx / den * inv[2]


def kernel_walk(x: np.ndarray, eps: float, scales=None, z_range: int | None = None, prev=None, next_=None,
                group=None):
    """(costs (B,), grad) of a batch (B, nz, ny, nx) computed block by block
    as the kernel's geometry cuts it, from staged planes only, with z ranges
    of ``z_range`` planes (by default the launch's own). With ``group`` (the
    shapes of a grouped slab launch, ``x``'s among them) ``x`` is a z-slab:
    ``prev``/``next_`` (B, ny, nx, or None at the volume's faces) are its
    halo planes, staged as its planes -1 and nz, the costs are the slab's own
    planes' (a partial a tile and COST_PLANES planes) and the gradient the
    volume's at them."""
    nb, nz, ny, nx = x.shape
    inv = [1.0 / s for s in (scales or (1.0, 1.0, 1.0))]
    geo = hv.tv_launch(x.shape, 0, group)
    z_range = geo.z_range if z_range is None else z_range
    gx, gy = geo.grid[:2]
    ranges = -(-nz // z_range)
    gz, per_vol = nb * ranges, gx * gy * (ranges if group is None else -(-nz // hv.COST_PLANES))
    if z_range == geo.z_range:
        assert (geo.grid[2], geo.ranges, geo.partials) == (gz, ranges, per_vol)
    lo, hi = -1 if prev is not None else 0, nz + 1 if next_ is not None else nz

    def slot(rz, by, bx, z):
        """The cost partial that plane z of block (rz, by, bx) adds to."""
        return (rz * gy + by) * gx + bx if group is None else (z // hv.COST_PLANES * gy + by) * gx + bx

    def plane(vol, p):
        return prev[vol] if p < 0 else next_[vol] if p >= nz else x[vol, p]

    grad = np.full(x.shape, np.nan)
    writes = np.zeros(x.shape, int)
    partials = np.zeros((nb, per_vol))
    # Global row / column of each staged row / column, relative to the tile origin.
    rows, cols = np.arange(-1, TY + 1), np.arange(-HALO_X, TX + HALO_X)
    for bz in range(gz):
        vol, rz = divmod(bz, ranges)
        z0, z1 = rz * z_range, min(rz * z_range + z_range, nz)
        pstart, pend = max(z0 - 1, lo), min(z1 + 1, hi)
        for by in range(gy):
            for bx in range(gx):
                y0, x0 = by * TY, bx * TX
                ys, xs = y0 + rows, x0 + cols
                oky, okx = (ys >= 0) & (ys < ny), (xs >= 0) & (xs < nx)

                def stage(p):
                    st = np.zeros((TY + 2, TX + 2 * HALO_X))
                    st[np.ix_(oky, okx)] = plane(vol, p)[np.ix_(ys[oky], xs[okx])]
                    return st

                ring = {p: stage(p) for p in range(pstart, pend)}
                # Points of rows y0-1 .. y0+TY-1 and columns x0-1 .. x0+TX-1:
                # the tile, its halo row (first row) and halo column (first column).
                py, px = ys[:TY + 1, None], xs[None, HALO_X - 1:HALO_X + TX]
                hy, hx = py + 1 < ny, px + 1 < nx
                wz_prev = np.zeros((TY, TX))
                ye, xe = min(y0 + TY, ny) - y0, min(x0 + TX, nx) - x0
                for z in range(pstart, z1):
                    hz = z + 1 < hi
                    cur = ring[z]
                    nxt = ring[z + 1] if hz else cur
                    sl = (slice(0, TY + 1), slice(HALO_X - 1, HALO_X + TX))
                    den, wz, wy, wx = _weights(
                        cur[sl], nxt[sl], cur[1:TY + 2, HALO_X - 1:HALO_X + TX],
                        cur[0:TY + 1, HALO_X:HALO_X + TX + 1], hz, hy, hx, inv, eps)
                    wy_up, wx_left = wy[:TY, 1:].copy(), wx[1:, :TX].copy()
                    if y0 == 0:
                        wy_up[0] = 0.0  # leading face: no incoming w_y
                    if x0 == 0:
                        wx_left[:, 0] = 0.0
                    wz_own, wy_own, wx_own = wz[1:, 1:], wy[1:, 1:], wx[1:, 1:]
                    if z >= z0:
                        g = wz_prev - wz_own + wy_up - wy_own + wx_left - wx_own
                        grad[vol, z, y0:y0 + ye, x0:x0 + xe] = g[:ye, :xe]
                        writes[vol, z, y0:y0 + ye, x0:x0 + xe] += 1
                        partials[vol, slot(rz, by, bx, z)] += float(np.sum(den[1:, 1:][:ye, :xe] - eps))
                    wz_prev = wz_own
    assert (writes == 1).all(), "every voxel's gradient is written by exactly one block"
    costs = np.array([sum(partials[v]) for v in range(nb)])  # index order
    return costs, grad


# (shape, z_range): ragged tiles in y and x, z ranges that end mid-volume,
# nx % 4 != 0, B > 1, nz = 1, several x and y tiles.
CASES = [
    ((1, 9, 18, 70), 4),
    ((3, 5, 18, 68), 2),
    ((2, 1, 17, 65), hv.Z_RANGE),
    ((1, 33, 15, 66), hv.Z_RANGE),
    ((1, 7, 33, 130), 3),
]


@pytest.mark.parametrize("shape,z_range", CASES)
@pytest.mark.parametrize("eps,scales", [(0.1, None), (1.0, (2.0, 1.0, 0.5))])
def test_kernel_walk_matches_plain(shape, z_range, eps, scales):
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    costs, grad = kernel_walk(x, eps, scales, z_range)
    f, g = hv.hyperbolic_tv_batched_plain(torch.tensor(x), eps, scales)
    np.testing.assert_allclose(costs, f.numpy(), rtol=TOL)
    np.testing.assert_allclose(grad, g.numpy(), rtol=TOL, atol=TOL)
    if shape[0] == 1:
        f1, g1 = hv.hyperbolic_tv_plain(torch.tensor(x[0]), eps, scales)
        np.testing.assert_allclose(costs[0], f1.item(), rtol=TOL)
        np.testing.assert_allclose(grad[0], g1.numpy(), rtol=TOL, atol=TOL)


def test_kernel_walk_zero_on_a_constant_batch():
    costs, grad = kernel_walk(np.full((2, 6, 20, 70), 2.5), 0.1, z_range=4)
    np.testing.assert_allclose(costs, 0.0, atol=1e-12)
    assert np.abs(grad).max() == 0.0


@pytest.mark.parametrize("shape,grid,ranges", [
    ((256, 256, 256), (4, 16, 8), 8),
    ((4, 64, 256, 256), (4, 16, 8), 2),
    ((4, 256, 256, 256), (4, 16, 32), 8),
    ((3, 256, 256, 256), (4, 16, 24), 8),
    ((37, 64, 96), (2, 4, 2), 2),
    ((1, 17, 65), (2, 2, 1), 1),
])
def test_launch_geometry_of_the_main_shapes(shape, grid, ranges):
    geo = hv.tv_launch(shape, 0)
    assert geo.grid == grid and geo.ranges == ranges and hv.Z_RANGE == 32
    assert geo.partials == grid[0] * grid[1] * ranges


def test_launch_geometry_refuses_grids_above_the_limit():
    hv.tv_launch((65535, 1, 1, 4), 0)  # one z range a volume: 65535 blocks in z
    with pytest.raises(ValueError, match="65535"):
        hv.tv_launch((65536, 1, 1, 4), 0)
    hv.tv_launch((hv.Z_RANGE * 65535, 1, 4), 0)
    with pytest.raises(ValueError, match="65535"):
        hv.tv_launch((hv.Z_RANGE * 65535 + 1, 1, 4), 0)
    with pytest.raises(ValueError, match="65535"):
        hv.tv_launch((40000, hv.Z_RANGE + 1, 1, 4), 0)  # two z ranges a volume
    with pytest.raises(ValueError, match="65535"):
        hv.tv_launch((1, hv.TILE_Y * 65535 + 1, 4), 0)


@pytest.mark.parametrize("nx,ptr,aligned", [
    (256, 0, True), (68, 16 * 7, True), (67, 0, False), (66, 0, False), (68, 4, False), (68, 8, False),
    (256, 16 * 3 + 12, False),
])
def test_instantiation_follows_nx_and_the_base_address(nx, ptr, aligned):
    """TMA needs nx % 4 == 0 and a 16-byte-aligned base; anything else takes
    the 4-byte-copy instantiation."""
    assert hv.tv_launch((2, 5, 9, nx), ptr).aligned is aligned
    assert hv.tv_launch((5, 9, nx), ptr).aligned is aligned


def test_lane_views_of_an_odd_batch_are_unaligned():
    """x[b] of a (3, 33, 45, 67) batch starts 12 or 8 bytes off alignment;
    a batch with nx % 4 == 0 keeps every lane aligned."""
    odd = torch.zeros(3, 33, 45, 67)
    assert [hv.tv_launch(v.shape, v.data_ptr() - odd.data_ptr()).aligned for v in odd] == [False] * 3
    assert [(v.data_ptr() - odd.data_ptr()) % 16 for v in odd] == [0, 12, 8]
    even = torch.zeros(3, 5, 7, 68)
    assert all(hv.tv_launch(v.shape, v.data_ptr() - even.data_ptr()).aligned for v in even)


def test_prepare_launch_refuses_what_the_kernel_does_not_take():
    """The checks run before the library is built or loaded."""
    with pytest.raises(TypeError):
        hv.prepare_launch(torch.zeros(4, 8, 8, dtype=torch.float64), 0.1)
    with pytest.raises(ValueError):
        hv.prepare_launch(torch.zeros(2, 2, 4, 8, 8), 0.1)
    with pytest.raises(ValueError):
        hv.prepare_launch(torch.zeros(4, 8, 8).transpose(1, 2), 0.1)
    assert hv._library.cache_info().currsize == 0
