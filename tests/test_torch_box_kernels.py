"""The box-box and box-hull kernels (csrc/collide_box_box.cu, and
csrc/collide_box_hull.cu on the team body of csrc/collide_hull_team.cuh)
on the host.

Box-box gives each (pair, scenario) a team of 8 lanes (one corner of each
box per lane, the deepest 4 of each way by ranks, the 15 SAT axes split
between the lanes); box-hull runs the hull-hull team body with side 1 made
from the box's size. Each source compiles once with g++ through the
threaded host shim of tests/test_torch_host_shim.py (warp shuffles and
barriers emulated) and, called through its C entry point on CPU tensors,
must equal ``cuda_collide.box_box_plain`` / ``box_hull_plain`` to the bit
in every output slot, inactive ones included, as on the card (built with
-fmad=false). The cases:

* seeded random pairs, 145 box-box and 185 box-hull instances (no
  multiple of a block's 16 or 32 teams), the hull rows mixed within every
  warp: a cylinder's prism (32 vertices, 18 faces), the finger pad's hull
  (24, 34), a tetrahedron (4 vertices: where the box's face wins, 4 slots
  carry BIG at the padded vertices' indices) and a cube, padded to 32 x 34;
* a cube resting face to face on a larger cube: its four bottom corners
  tie, and the two boxes' z faces tie with each other and with the cross
  axes along z, so the first face axis must win and the edge slot carry
  (0, 0, 1) and BIG; the same cube on the hull table's cube row; a small
  cube row turned 45 degrees inside a box, so that the box's faces tie
  and the first (+x) must win;
* two boxes crossed edge to edge (each turned 45 degrees about its long
  axis), so that a cross axis wins the edge slot.
"""

import numpy as np
import pytest
import torch
from test_torch_host_shim import host_build
from test_torch_hull_hull import F, V, _f32, _tables

from mujoco_rl_ur5_tpu_torch.physics import cuda_collide

BIG = 1e10


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    d = tmp_path_factory.mktemp("box_kernels")
    return {k: host_build(cuda_collide.source(k), d / k)
            for k in ("box_box", "box_hull")}


def _quat_axis(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * a])


def _random_poses(rng, B, G, spread):
    pos = rng.uniform(-spread, spread, (B, G, 3))
    q = rng.normal(size=(B, G, 4))
    return pos, q / np.linalg.norm(q, axis=-1, keepdims=True)


def _run_box_box(fn, pos, quat, size, g1, g2):
    B, G = pos.shape[:2]
    n = g1.shape[1]
    z = torch.zeros(1)
    outs = [torch.empty(B, n, 9, 3), torch.empty(B, n, 9, 3),
            torch.empty(B, n, 9)]
    keep = [pos, quat, size, torch.zeros(G, dtype=torch.int32), z, z, z,
            g1.to(torch.int32), g2.to(torch.int32), *outs]
    assert fn(*(x.data_ptr() for x in keep), B, n, G, 0, 0, None) == 0
    return outs


def _box_box_problem():
    """Five scenarios of 29 pairs among 10 boxes; scenario 0's pair 0 rests
    a cube on a cube, pair 1 crosses two boxes edge to edge."""
    rng = np.random.default_rng(21)
    B, n, G = 5, 29, 10
    size = rng.uniform(0.02, 0.06, (G, 3))
    pos, quat = _random_poses(rng, B, G, 0.06)
    # exact in float32: the small cube sinks 2^-7 into the large one
    size[0], size[1] = 0.0625, 0.03125
    pos[0, 0], pos[0, 1] = 0.0, [0.0, 0.0, 0.0859375]
    quat[0, 0] = quat[0, 1] = [1.0, 0.0, 0.0, 0.0]
    # a bar along x turned 45 degrees about x (an edge up), a bar along y
    # turned 45 degrees about y (an edge down) just above it
    size[2], size[3] = [0.1, 0.02, 0.02], [0.02, 0.1, 0.02]
    pos[0, 2], pos[0, 3] = [0.0, 0.0, 0.0], [0.0, 0.0, 0.055]
    quat[0, 2] = _quat_axis([1, 0, 0], np.pi / 4)
    quat[0, 3] = _quat_axis([0, 1, 0], np.pi / 4)
    g1 = rng.integers(0, G, (B, n))
    g2 = (g1 + rng.integers(1, G, (B, n))) % G          # another box
    g1[0, :2], g2[0, :2] = [0, 2], [1, 3]
    return (_f32(pos), _f32(quat), _f32(size), torch.from_numpy(g1),
            torch.from_numpy(g2))


def test_box_box_kernel_source_equals_plain_on_the_host(kernels):
    pos, quat, size, g1, g2 = _box_box_problem()
    outs = _run_box_box(kernels["box_box"], pos, quat, size, g1, g2)
    want = cuda_collide.box_box_plain(pos, quat, size, None, g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    dist, nrm = want[2], want[1]
    assert int((dist[..., :8] < 1.0).sum()) > 100       # corners inside
    # slot 8: a cross axis wins with contact (active), a face axis wins
    # (inactive, the fixed normal), or a cross axis wins but an axis
    # separates (inactive, the cross axis)
    edge = dist[..., 8] < 1.0
    face = (nrm[..., 8, :] == torch.tensor([0.0, 0.0, 1.0])).all(-1) & ~edge
    assert int(edge.sum()) > 20 and int(face.sum()) > 20
    assert int((~edge & ~face).sum()) > 5
    # the resting cube: its four bottom corners (corners 0, 2, 4, 6 of box
    # 2 inside box 1: slots 4-7) tie at 2^-7 deep in index order, the large
    # cube's corners reach none of the small one's, the face axes tie
    assert dist[0, 0, :4].tolist() == [BIG] * 4
    assert dist[0, 0, 4:8].tolist() == [-0.0078125] * 4
    assert nrm[0, 0, 8].tolist() == [0.0, 0.0, 1.0]
    assert dist[0, 0, 8].item() == BIG
    # the crossed bars: a cross axis (x of box 1 by y of box 2) wins, along z
    assert 0.0 < -dist[0, 1, 8].item() < 2e-3
    assert nrm[0, 1, 8, 2].item() > 0.999


def _hull_problem():
    """Five scenarios of 37 box-hull pairs: boxes 0-4 against prisms (5,
    6), pads (7, 8), tetrahedra (9, 10) and the cube rows (11, 12);
    scenario 0's pair 0 rests box 0 on the large cube row face to face,
    pair 1 holds the small cube row, turned 45 degrees about z, at the
    centre of box 1, whose x and y faces then tie and win."""
    rng = np.random.default_rng(5)
    B, n, G = 5, 37, 13
    meshid = torch.tensor([-1] * 5 + [0, 0, 1, 1, 2, 2, 3, 4])
    size = rng.uniform(0.015, 0.05, (G, 3))
    pos, quat = _random_poses(rng, B, G, 0.07)
    size[0], size[1] = 0.015625, [0.0625, 0.0625, 0.1]
    pos[0, 0], pos[0, 11] = [0.0, 0.0, 0.0703125], 0.0   # sinks 2^-7
    pos[0, 1] = pos[0, 12] = 0.0
    quat[0, 0] = quat[0, 1] = quat[0, 11] = [1.0, 0.0, 0.0, 0.0]
    quat[0, 12] = _quat_axis([0, 0, 1], np.pi / 4)
    g1 = rng.integers(0, 5, (B, n))
    g2 = rng.integers(5, G, (B, n))
    g1[0, :2], g2[0, :2] = [0, 1], [11, 12]
    verts, vmask, fnorm, fdist = (_f32(a) for a in _tables())
    hulls = cuda_collide.Hulls(meshid, verts, vmask, fnorm, fdist,
                               *cuda_collide.hull_counts(vmask, fdist))
    return (_f32(pos), _f32(quat), _f32(size), hulls, torch.from_numpy(g1),
            torch.from_numpy(g2))


def _run_box_hull(fn, pos, quat, size, hulls, g1, g2, nface=None):
    B, G = pos.shape[:2]
    n = g1.shape[1]
    outs = [torch.empty(B, n, 8, 3), torch.empty(B, n, 8, 3),
            torch.empty(B, n, 8)]
    keep = [pos, quat, size, hulls.meshid.to(torch.int32), hulls.verts,
            hulls.fnorm, hulls.fdist, hulls.nvert,
            hulls.nface if nface is None else nface, g1.to(torch.int32),
            g2.to(torch.int32), *outs]
    M = hulls.verts.shape[0]
    assert fn(*(x.data_ptr() for x in keep), B, n, G, M, V, F, None) == 0
    return outs


def test_box_hull_kernel_source_equals_plain_on_the_host(kernels):
    pos, quat, size, hulls, g1, g2 = _hull_problem()
    assert hulls.nvert.tolist() == [32, 24, 4, 8, 8]
    assert hulls.nface.tolist() == [18, 34, 4, 6, 6]
    outs = _run_box_hull(kernels["box_hull"], pos, quat, size, hulls, g1,
                         g2)
    want = cuda_collide.box_hull_plain(pos, quat, size, hulls, g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    assert int((want[2] < 1.0).sum()) > 200
    rows = hulls.meshid[g2]
    assert {0, 1, 2, 3, 4} <= set(rows.flatten().tolist())
    assert all(len(set(rows.flatten()[w:w + 8].tolist())) > 1     # mixed
               for w in range(0, rows.numel() - 8, 8))             # warps
    # the tetrahedron's pairs where the box's face wins: BIG past its 4 real
    # vertices
    tet = rows == 2
    assert bool((want[2][tet][:, 4:] == BIG).any())
    # the resting box: the first of the cube row's tied faces (+z, on side
    # 2) wins over the box's -z face, normal -n2, and the box's four bottom
    # corners tie in index order
    assert want[1][0, 0, 0].tolist() == [0.0, 0.0, -1.0]
    assert want[2][0, 0, :4].tolist() == [-0.0078125] * 4
    # the cube inside box 1: the first of the box's tied faces (+x) wins,
    # normal +n1
    assert want[1][0, 1, 0].tolist() == [1.0, 0.0, 0.0]


def test_box_hull_kernel_takes_the_counts_it_is_given(kernels):
    """The pad row's face count one short changes the answer of pairs whose
    best face is its last one, and nothing else (the card's planted fault
    in phase 9)."""
    pos, quat, size, hulls, g1, g2 = _hull_problem()
    short = hulls.nface.clone()
    short[1] -= 1                                        # the pad's face 33
    outs = _run_box_hull(kernels["box_hull"], pos, quat, size, hulls, g1,
                         g2, nface=short)
    fdist = hulls.fdist.clone()
    fdist[1, 33] = 1e10
    want = cuda_collide.box_hull_plain(pos, quat, size,
                                       hulls._replace(fdist=fdist), g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    full = cuda_collide.box_hull_plain(pos, quat, size, hulls, g1, g2)
    assert not torch.equal(outs[2], full[2])
