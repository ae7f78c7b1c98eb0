"""The TV kernel's grouped slab entry, on the CPU.

The kernel cannot run here, so these tests hold what decides its launches:
the z range ``tv_launch`` gives a slab against a whole volume, the table a
grouped launch builds (``prepare_slabs`` up to the library call: which halo
plane is read in place through a slab's own tensor map and which gets a map
of its own), the sharded TV's plan of launches over a mesh's devices
(``parallel.deconv.plan_slab_launches``, at most ``GROUP_SLABS`` slabs a
launch) and the tables its halo planes make (read in place on one device,
sent across two), and the NumPy walk of
tests/test_torch_tv_tiling.py over a group of slabs whose halo planes are
read through that table, against the slab and batched plain versions.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from test_torch_tv_tiling import kernel_walk

from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
from microtipi_tpu_torch.parallel import deconv as pd
from microtipi_tpu_torch.parallel import make_mesh, shard
from microtipi_tpu_torch.parallel.mesh import Z_AXIS

TOL = 1e-12
CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S64, S16 = (1, 64, 256, 256), (1, 16, 256, 256)


@pytest.mark.parametrize("shape,group,z_range,blocks", [
    ((256, 256, 256), None, 32, 512),  # the whole-volume launch keeps its 32 planes
    ((4, 64, 256, 256), None, 32, 512),  # and the batched one
    (S64, None, 32, 128),  # a batch of one 64-plane volume: the whole-volume geometry
    (S64, [S64], 8, 512),  # a slab of 256^3 on a (1, 4) mesh of four cards
    (S16, [S16], 4, 256),  # RL-TV's and depthvar's slab there: the shortest range
    (S64, [S64] * 4, 32, 128),  # 256^3 on (1, 4) of one card: one launch of 512 blocks, as the whole volume
    (S16, [S16] * 4, 8, 128),  # 64x256x256 on (1, 4) of one card
    ((1, 128, 256, 256), [(1, 128, 256, 256)], 16, 512),
    ((1, 128, 256, 256), [(1, 128, 256, 256)] * 4, 32, 256),  # 2 x 256^3 on (2, 2) of one card
    ((1, 256, 256, 256), [(1, 256, 256, 256)], 32, 512),  # 256^3 on (1, 1)
    ((1, 3, 16, 16), [(1, 3, 16, 16)] * 2, 4, 1),
])
def test_geometry_rule(shape, group, z_range, blocks):
    geo = hv.tv_launch(shape, 0, group)
    assert geo.z_range == z_range and geo.grid[0] * geo.grid[1] * geo.grid[2] == blocks
    assert geo.ranges == -(-shape[-3] // z_range)
    chunks = geo.ranges if group is None else -(-shape[-3] // hv.COST_PLANES)
    assert geo.partials == geo.grid[0] * geo.grid[1] * chunks
    assert all(zr % hv.COST_PLANES == 0 for zr in hv.SLAB_Z_RANGES)


def test_slab_geometry_refuses_grids_above_the_limit():
    hv.tv_launch((65535, 1, 1, 4), 0, [(65535, 1, 1, 4)])
    with pytest.raises(ValueError, match="65535"):
        hv.tv_launch((65536, 1, 1, 4), 0, [(65536, 1, 1, 4)])
    two = [torch.zeros(40000, 1, 1, 4) for _ in range(2)]  # 40000 blocks in grid z each
    with pytest.raises(ValueError, match="65535"):
        hv.prepare_slabs(two, [None, two[0][:, -1]], [two[1][:, 0], None], 1.0)


@pytest.fixture
def fake_library(monkeypatch):
    """The grouped launch's arguments as the C launcher would get them: the
    library and the card's stream replaced by recorders."""
    calls = []
    monkeypatch.setattr(hv, "_library", lambda: types.SimpleNamespace(
        hyperbolic_tv_group_f32=lambda *a: calls.append(a) or 0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


def _cut(x, cuts):
    """Contiguous slabs of ``x`` at ``cuts`` and, as a launch on one device
    takes them, views of each neighbour's boundary plane."""
    slabs = [x[:, a:b].contiguous() for a, b in zip(cuts[:-1], cuts[1:])]
    return slabs, [None] + [t[:, -1] for t in slabs[:-1]], [t[:, 0] for t in slabs[1:]] + [None]


def test_table_reads_neighbours_in_place_and_halo_buffers_through_maps_of_their_own(fake_library):
    x = torch.zeros(2, 10, 20, 68)
    slabs, prevs, nexts = _cut(x, (0, 1, 4, 10))
    nexts[1] = nexts[1].clone()  # slab 2's first plane, sent over from another device
    launch, costs, grads, geo = hv.prepare_slabs(slabs, prevs, nexts, 1.0)
    launch()
    (args,) = fake_library
    nslabs, nmaps, planes, depths, _, nz, sources = args[:7]
    assert (nslabs, nmaps, geo.maps, geo.aligned, args[13]) == (3, 4, 4, True, 4)
    assert list(depths) == [2, 6, 12, 2] and list(nz) == [1, 3, 6]
    assert list(planes)[:3] == [t.data_ptr() for t in slabs] and planes[3] == nexts[1].data_ptr()
    # (map, z0, zstep) of each slab's prev, then next: slab j's map is j, the buffer's map 3.
    assert list(sources) == [-1, 0, 0, 1, 0, 3,
                             0, 0, 1, 3, 0, 1,
                             1, 2, 3, -1, 0, 0]
    assert geo.grid == (2, 2, 2 * (1 + 1 + 2)) and [len(c) for c in costs] == [2, 2, 2]
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in slabs]


def test_a_plane_of_a_slab_outside_the_launch_is_read_in_place_through_a_map_of_its_own(fake_library):
    x = torch.zeros(3, 8, 16, 64)
    slabs, prevs, nexts = _cut(x, (0, 4, 8))
    hv.prepare_slabs(slabs[1:], prevs[1:], nexts[1:], 1.0)[0]()
    (args,) = fake_library
    # slab 0's last plane of each volume: 4 planes apart from its view's first element, 3 volumes.
    assert args[1] == 2 and args[2][1] == prevs[1].data_ptr() and list(args[3]) == [12, 9]
    assert list(args[6]) == [1, 0, 4, -1, 0, 0]


@pytest.mark.parametrize("nx,aligned", [(68, True), (67, False)])
def test_table_instantiation(fake_library, nx, aligned):
    slabs, prevs, nexts = _cut(torch.zeros(1, 6, 9, nx), (0, 3, 6))
    assert hv.prepare_slabs(slabs, prevs, nexts, 1.0)[3].aligned is aligned


def test_group_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 36, 8, 8)
    slabs, prevs, nexts = _cut(x, tuple(range(0, 37, 4)))
    with pytest.raises(ValueError, match="1 to 8 slabs"):
        hv.prepare_slabs(slabs, prevs, nexts, 1.0)
    with pytest.raises(ValueError, match="one B, Ny, Nx"):
        hv.prepare_slabs([slabs[0], torch.zeros(1, 4, 8, 12)], [None, None], [None, None], 1.0)
    with pytest.raises(ValueError, match="whole planes"):
        hv.prepare_slabs(slabs[:1], [torch.zeros(1, 8, 16)[:, :, :8]], [None], 1.0)
    assert hv._library.cache_info().currsize == 0


def _plan(mesh):
    return [(launch.device, launch.cells, launch.prev, launch.next)
            for launch in pd.plan_slab_launches(mesh, mesh.cells())]


def _tables(mesh, fake_library, shape=(1, 16, 8, 12)):
    """Each planned launch's table as the C launcher gets it, from the
    halo planes ``_launch_inputs`` hands the wrapper (the mesh's devices are
    labels here; the tiles are CPU tensors): (slabs, maps, sources) a launch."""
    cuts = np.linspace(0, shape[1], mesh.shape[Z_AXIS] + 1).astype(int)
    by = {(b, z): torch.zeros(shape[0], cuts[z + 1] - cuts[z], *shape[2:]) for b, z in mesh.cells()}
    fake_library.clear()
    for launch in pd.plan_slab_launches(mesh, mesh.cells()):
        hv.prepare_slabs(*pd._launch_inputs(mesh, by, launch), 1.0)[0]()
    return [(args[0], args[1], list(args[6])) for args in fake_library]


def test_plan_on_one_card_is_one_launch_reading_in_place(fake_library):
    mesh = make_mesh(1, 4, devices=[CUDA0] * 4)
    assert _plan(mesh) == [(CUDA0, ((0, 0), (0, 1), (0, 2), (0, 3)),
                            (None, (0, 0), (0, 1), (0, 2)), ((0, 1), (0, 2), (0, 3), None))]
    pd.halo_sends = 0
    # every interior halo is the last or the first plane of a slab of the launch, through that slab's map
    assert _tables(mesh, fake_library) == [(4, 4, [-1, 0, 0, 1, 0, 4,
                                                   0, 3, 4, 2, 0, 4,
                                                   1, 3, 4, 3, 0, 4,
                                                   2, 3, 4, -1, 0, 0])]
    assert pd.halo_sends == 0


def test_plan_across_two_cards_sends_every_halo():
    mesh = make_mesh(1, 4, devices=[CUDA0, CUDA1] * 2)
    assert _plan(mesh) == [
        (CUDA0, ((0, 0), (0, 2)), (None, (0, 1)), ((0, 1), (0, 3))),
        (CUDA1, ((0, 1), (0, 3)), ((0, 0), (0, 2)), ((0, 2), None)),
    ]
    # a neighbour on the other device is a copy: cpu and cpu:0 stand for the two devices
    cpu = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    two = make_mesh(1, 4, devices=cpu)
    by = {c: torch.zeros(1, 2, 3, 4) for c in two.cells()}
    pd.halo_sends = 0
    for launch in pd.plan_slab_launches(two, two.cells()):
        _, prevs, nexts = pd._launch_inputs(two, by, launch)
        assert all(h is None or all(h.data_ptr() != t.data_ptr() for t in by.values()) for h in prevs + nexts)
    assert pd.halo_sends == 6


@pytest.mark.parametrize("devices", [[CUDA0] * 4, [CUDA0, CUDA0, CUDA1, CUDA1]])
def test_plan_of_the_2x2_mesh_keeps_its_rows_apart(devices, fake_library):
    """No halo crosses a batch row: each row's slabs read each other in
    place; one launch a device."""
    mesh = make_mesh(2, 2, devices=devices)
    plan = _plan(mesh)
    assert [cells for _, cells, _, _ in plan] == ([tuple(mesh.cells())] if len(set(devices)) == 1
                                                  else [((0, 0), (0, 1)), ((1, 0), (1, 1))])
    for _, cells, prev, nxt in plan:
        for (b, z), p, n in zip(cells, prev, nxt):
            assert p == (None if z == 0 else (b, 0))
            assert n == (None if z == 1 else (b, 1))
    pd.halo_sends = 0
    for nslabs, nmaps, sources in _tables(mesh, fake_library):
        assert nmaps == nslabs and all(m < nslabs for m in sources[::3])
    assert pd.halo_sends == 0


def test_plan_caps_the_slabs_of_a_launch(fake_library):
    """Twelve slabs of one card: two launches of 8 and 4; the plane a launch
    needs from a slab of the other one is read in place through a map of its
    own, not copied."""
    mesh = make_mesh(1, 12, devices=[CUDA0] * 12)
    plan = pd.plan_slab_launches(mesh, mesh.cells())
    assert [len(launch.cells) for launch in plan] == [hv.GROUP_SLABS, 12 - hv.GROUP_SLABS]
    assert plan[1].prev[0] == (0, 7) and plan[0].next[-1] == (0, 8)
    pd.halo_sends = 0
    (n0, m0, s0), (n1, m1, s1) = _tables(mesh, fake_library, (1, 24, 8, 12))
    assert (n0, m0, s0[-3:]) == (8, 9, [8, 0, 1]) and (n1, m1, s1[:3]) == (4, 5, [4, 0, 1])
    assert pd.halo_sends == 0


def test_sharded_tv_sends_only_across_devices():
    """``_slab_tv`` on the CPU follows the plan: on one device no halo is
    copied; with the cells on two (``cpu`` and ``cpu:0`` are two device
    entries of the host) every halo is, and the results are the same."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 12, 10, 20)))
    out = {}
    for devices in ([torch.device("cpu")] * 4, [torch.device("cpu"), torch.device("cpu", 0)] * 2):
        pd.halo_sends = 0
        out[len(set(devices))] = (pd._slab_tv(shard(x, make_mesh(2, 2, devices=devices)), 0.5, None), pd.halo_sends)
    (one, sends_one), (two, sends_two) = out[1], out[2]
    assert (sends_one, sends_two) == (0, 4)
    assert torch.equal(one[0], two[0]) and all(torch.equal(a, b) for a, b in zip(one[1], two[1]))
    want_c, want_g = hv.hyperbolic_tv_batched_plain(x, 0.5)
    np.testing.assert_allclose(one[0].item(), want_c.sum().item(), rtol=TOL)
    grads = [torch.cat(one[1][2 * b:2 * b + 2], 1) for b in range(2)]
    np.testing.assert_allclose(torch.cat(grads).numpy(), want_g.numpy(), rtol=TOL, atol=TOL)


def group_walk(slabs, prevs, nexts, eps, scales=None):
    """(costs, grads) of a grouped launch, each slab walked by
    :func:`kernel_walk` with the halo planes it stages read through the
    launch's table (``hv._source``): plane z0 + volume * zstep of a slab's
    own planes, or of a map of a halo buffer's own."""
    maps = [(t, t.data_ptr(), t.shape[0] * t.shape[1]) for t in slabs]
    sources = [[hv._source(h, slabs, maps) for h in (p, n)] for p, n in zip(prevs, nexts)]
    ny, nx = slabs[0].shape[2:]
    planes = [torch.as_strided(t, (depth, ny, nx), (ny * nx, nx, 1), t.storage_offset()).numpy()
              for t, _, depth in maps]

    def halo(src, nb):
        m, z0, zstep = src
        return None if m < 0 else np.stack([planes[m][z0 + v * zstep] for v in range(nb)])

    group = [tuple(t.shape) for t in slabs]
    out = [kernel_walk(t.numpy(), eps, scales, prev=halo(p, t.shape[0]), next_=halo(n, t.shape[0]), group=group)
           for t, (p, n) in zip(slabs, sources)]
    return [c for c, _ in out], [g for _, g in out]


# (shape, cuts, halo buffers: indices of slabs whose prev plane comes as a copy): ragged tiles, 1-plane slabs,
# nx % 4 != 0, B > 1, the volume's faces inside a group and a neighbour on another device.
GROUPS = [
    ((2, 9, 18, 70), (0, 1, 4, 9), ()),
    ((1, 12, 17, 66), (0, 5, 6, 12), (2,)),
    ((3, 6, 18, 68), (0, 3, 6), (1,)),
    ((1, 7, 33, 130), (0, 2, 3, 4, 7), ()),
    ((2, 4, 20, 65), (0, 4), ()),
]


@pytest.mark.parametrize("shape,cuts,copied", GROUPS)
@pytest.mark.parametrize("eps,scales", [(0.1, None), (1.0, (2.0, 1.0, 0.5))])
def test_group_walk_matches_the_slab_and_batched_plain_versions(shape, cuts, copied, eps, scales):
    x = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(shape))
    slabs, prevs, nexts = _cut(x, cuts)
    for i in copied:
        prevs[i], nexts[i - 1] = prevs[i].clone(), nexts[i - 1].clone()
    costs, grads = group_walk(slabs, prevs, nexts, eps, scales)
    plain_c, plain_g = hv.hyperbolic_tv_slab_group_plain(slabs, prevs, nexts, eps, scales)
    for c, g, cp, gp in zip(costs, grads, plain_c, plain_g):
        np.testing.assert_allclose(c, cp.numpy(), rtol=TOL)
        np.testing.assert_allclose(g, gp.numpy(), rtol=TOL, atol=TOL)
    want_c, want_g = hv.hyperbolic_tv_batched_plain(x, eps, scales)
    np.testing.assert_allclose(np.sum(costs, axis=0), want_c.numpy(), rtol=TOL)
    np.testing.assert_allclose(np.concatenate(grads, 1), want_g.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("z_range", [4, 8, 16])
def test_slab_walk_at_every_z_range(z_range):
    """A slab's result does not depend on the z range its launch gives it
    (its cost partials are chunks of COST_PLANES planes): a 13-plane slab
    with both halos, walked in ranges of 4, 8 and 16 planes."""
    x = np.random.default_rng(z_range).standard_normal((2, 17, 18, 68))
    slab, prev, nxt = x[:, 3:16], x[:, 2], x[:, 16]
    c, g = kernel_walk(slab, 0.3, (1.5, 1.0, 1.0), z_range, prev, nxt, group=[slab.shape])
    cp, gp = hv.hyperbolic_tv_slab_plain(torch.tensor(slab), torch.tensor(prev), torch.tensor(nxt), 0.3,
                                         (1.5, 1.0, 1.0))
    np.testing.assert_allclose(c, cp.numpy(), rtol=TOL)
    np.testing.assert_allclose(g, gp.numpy(), rtol=TOL, atol=TOL)
