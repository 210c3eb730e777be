"""The plane-hull, sphere-hull and capsule-hull kernels
(csrc/collide_plane_hull.cu on the team body of csrc/collide_hull_team.cuh,
csrc/collide_sphere_hull.cu and csrc/collide_capsule_hull.cu on its
staging, team, joins and probe loop) on the host.

Plane-hull runs the team body with a plane on side 1: no face pass, the
plane's z axis the winning face, the 8 deepest of the hull's real vertices
by ranks. Sphere-hull and capsule-hull give each (pair, scenario) a team of
4 lanes that run one probe loop (``probe_faces``): each lane's real faces
scored against the probe centres (the sphere's centre; the capsule's five,
about the hull's mean vertex summed in index order), each probe's first
maximum joined by shuffles. Each source compiles once with g++ through the
threaded host shim of tests/test_torch_host_shim.py (warp shuffles and
barriers emulated) and, called through its C entry point on CPU tensors,
must equal ``cuda_collide.plane_hull_plain`` / ``sphere_hull_plain`` /
``capsule_hull_plain`` to the bit in every output slot, inactive ones
included, as on the card (built with -fmad=false). The cases:

* seeded random pairs, 145 plane-hull, 155 sphere-hull and 185
  capsule-hull instances (no multiple of a block's 32 teams), the hull
  rows mixed within every warp:
  a cylinder's prism (32 vertices, 18 faces), the finger pad's hull (24,
  34), a tetrahedron (4 vertices: plane-hull's slots 4-7 carry BIG at the
  padded vertices' indices) and two cubes, padded to 32 x 34;
* an upright prism resting flat on a plane: its 16 bottom vertices tie,
  and the lower indices (16-23) must win;
* a capsule standing along a prism's side, where two side faces (7 and 8,
  mirror images across the x axis) meet: every probe scores both equally,
  and face 7, held by a later lane than face 8, must win; a sphere at the
  same centre, likewise;
* a sphere whose centre lies inside the hull (every face scores below 0:
  the nearest face wins, and the contact is deeper than the radius);
* capsules whose probe at the hull centre (``tmid``) clamps at either end;
* each row's counts one short, which the kernels take as given.
"""

import numpy as np
import pytest
import torch
from test_torch_host_shim import host_build
from test_torch_hull_hull import F, V, _f32, _tables

from mujoco_rl_ur5_tpu_torch.physics import cuda_collide

BIG = 1e10
ROWS = (0, 1, 2, 3, 4)                      # prism, pad, tetra, two cubes


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe_kernels")
    return {k: host_build(cuda_collide.source(k), d / k)
            for k in ("plane_hull", "sphere_hull", "capsule_hull")}


def _quat_axis(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * a])


def _problem():
    """Five scenarios of 20 geoms: planes 0-1, capsules 2-6 (spheres of
    their radii in sphere-hull's pairs) and the hulls 7-19 (table rows prism, prism, prism, prism, pad, pad, pad,
    tetrahedron, tetrahedron and each cube twice). Scenario 0 stands hull 7
    (a prism) upright on plane 0, sunk 2^-7 into it; puts hull 8 (a prism)
    at the origin, capsule 2 upright along its side where faces 7 and 8
    meet, and capsules 3 and 4 along x, 0.1 m from its centre on either
    side."""
    rng = np.random.default_rng(9)
    B, G = 5, 20
    meshid = torch.tensor([-1] * 7 + [0] * 4 + [1] * 3 + [2, 2, 3, 3, 4, 4])
    pos = rng.uniform(-0.07, 0.07, (B, G, 3)).astype(np.float32)
    q = rng.normal(size=(B, G, 4))
    quat = q / np.linalg.norm(q, axis=-1, keepdims=True)
    size = np.zeros((G, 3))
    size[2:7, 0] = rng.uniform(0.005, 0.02, 5)     # capsule radius
    size[2:7, 1] = rng.uniform(0.01, 0.04, 5)      # and half-length
    eye = [1.0, 0.0, 0.0, 0.0]
    quat[0, [0, 2, 7, 8]] = eye
    pos[0, 0] = 0.0
    # the bottom ring at -2^-7, exactly: float32 0.05 less 2^-7 is exact
    pos[0, 7] = [0.25, -0.125, np.float32(0.05) - np.float32(0.0078125)]
    pos[0, 8] = 0.0
    pos[0, 2], size[2] = [-0.0390625, 0.0, 0.0], [0.0078125, 0.015625, 0.0]
    turn = _quat_axis([0, 1, 0], np.pi / 2)          # the axis along x
    pos[0, 3], quat[0, 3] = [0.1, 0.0, 0.0], turn
    pos[0, 4], quat[0, 4] = [-0.1, 0.0, 0.0], turn
    verts, vmask, fnorm, fdist = (_f32(a) for a in _tables())
    hulls = cuda_collide.Hulls(meshid, verts, vmask, fnorm, fdist,
                               *cuda_collide.hull_counts(vmask, fdist))
    return _f32(pos), _f32(quat), _f32(size), hulls, rng


def _ids(rng, B, n, lo, hi, fixed):
    """Pairs (B, n) of geoms g1 in [lo, hi) against hulls, scenario 0's
    first pairs ``fixed``."""
    g1 = rng.integers(lo, hi, (B, n))
    g2 = rng.integers(7, 20, (B, n))
    for j, (a, c) in enumerate(fixed):
        g1[0, j], g2[0, j] = a, c
    return torch.from_numpy(g1), torch.from_numpy(g2)


def _run(fn, kernel, pos, quat, size, hulls, g1, g2, nvert=None,
         nface=None):
    B, G = pos.shape[:2]
    n = g1.shape[1]
    K, sized = cuda_collide.TEAM[kernel]
    outs = [torch.empty(B, n, K, 3), torch.empty(B, n, K, 3),
            torch.empty(B, n, K)]
    keep = [pos, quat, *([size] if sized else []),
            hulls.meshid.to(torch.int32), hulls.verts, hulls.fnorm,
            hulls.fdist, hulls.nvert if nvert is None else nvert,
            hulls.nface if nface is None else nface, g1.to(torch.int32),
            g2.to(torch.int32), *outs]
    M = hulls.verts.shape[0]
    assert fn(*(x.data_ptr() for x in keep), B, n, G, M, V, F, None) == 0
    return outs


def _mixed(hulls, g2):
    rows = hulls.meshid[g2].flatten()
    assert set(ROWS) <= set(rows.tolist())
    assert all(len(set(rows[w:w + 8].tolist())) > 1          # mixed warps
               for w in range(0, rows.numel() - 8, 8))


def test_plane_hull_kernel_source_equals_plain_on_the_host(kernels):
    pos, quat, size, hulls, rng = _problem()
    g1, g2 = _ids(rng, 5, 29, 0, 2, [(0, 7)])
    outs = _run(kernels["plane_hull"], "plane_hull", pos, quat, size, hulls,
                g1, g2)
    want = cuda_collide.plane_hull_plain(pos, quat, size, hulls, g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    _mixed(hulls, g2)
    assert hulls.nvert.tolist() == [32, 24, 4, 8, 8]
    # the tetrahedron: BIG past its 4 real vertices, at their indices
    tet = hulls.meshid[g2] == 2
    assert bool((want[2][tet][:, 4:] == BIG).all())
    assert bool((want[2][~tet] < 1.0).all())
    # the resting prism: its bottom ring ties 2^-7 deep, vertices 16-23 win
    assert want[2][0, 0].tolist() == [-0.0078125] * 8
    ring = hulls.verts[0, 16:24, :2] + pos[0, 7, :2]
    assert torch.equal(want[0][0, 0, :, :2], ring)
    assert want[1][0, 0, 0].tolist() == [0.0, 0.0, 1.0]


def test_capsule_hull_kernel_source_equals_plain_on_the_host(kernels):
    pos, quat, size, hulls, rng = _problem()
    g1, g2 = _ids(rng, 5, 37, 2, 7, [(2, 8), (3, 8), (4, 8)])
    outs = _run(kernels["capsule_hull"], "capsule_hull", pos, quat, size,
                hulls, g1, g2)
    want = cuda_collide.capsule_hull_plain(pos, quat, size, hulls, g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    _mixed(hulls, g2)
    assert hulls.nface.tolist() == [18, 34, 4, 6, 6]
    # along the prism's side: faces 7 and 8 tie for every probe (8 on lane
    # 0, 7 on lane 3), and face 7 wins
    n7, n8 = hulls.fnorm[0, 7], hulls.fnorm[0, 8]
    assert n7[0] == n8[0] and n7[1] == -n8[1] != 0.0
    assert torch.equal(want[1][0, 0], (-n7).expand(5, 3))
    # the probe at the hull's centre (slot 2) clamps to the end nearer it:
    # capsule 3's -hl (slot 0's probe), capsule 4's +hl (slot 1's)
    for j, end in ((1, 0), (2, 1)):
        for x in want:
            assert torch.equal(x[0, j, 2], x[0, j, end])
        assert not torch.equal(want[0][0, j, 0], want[0][0, j, 1])


def test_sphere_hull_kernel_source_equals_plain_on_the_host(kernels):
    pos, quat, size, hulls, rng = _problem()
    # sphere 5 inside prism 8 (at the origin, upright) in scenario 0
    pos[0, 5] = torch.tensor([0.005, 0.0078125, 0.02])
    g1, g2 = _ids(rng, 5, 31, 2, 7, [(2, 8), (5, 8)])
    outs = _run(kernels["sphere_hull"], "sphere_hull", pos, quat, size,
                hulls, g1, g2)
    want = cuda_collide.sphere_hull_plain(pos, quat, size, hulls, g1, g2)
    assert want[2].shape == (5, 31, 1)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    _mixed(hulls, g2)
    # on the prism's side where faces 7 and 8 meet: both score alike, and
    # face 7 (lane 3) wins over face 8 (lane 0)
    n7 = hulls.fnorm[0, 7]
    assert torch.equal(want[1][0, 0, 0], -n7)
    # the centre inside: every face scores below 0, the nearest wins and
    # the contact lies deeper than the radius
    c = pos[0, 5].double()
    scores = (hulls.fnorm[0, :18].double() @ c - hulls.fdist[0, :18].double())
    r = float(size[5, 0])
    assert float(scores.max()) < 0.0
    assert abs(float(want[2][0, 1, 0]) + r - float(scores.max())) < 1e-6
    assert float(want[2][0, 1, 0]) < -r


@pytest.mark.parametrize("kernel", ["plane_hull", "sphere_hull",
                                    "capsule_hull"])
def test_probe_kernel_takes_the_counts_it_is_given(kernels, kernel):
    """Each row's vertex count (plane-hull) or face count (sphere-hull and
    capsule-hull) one short gives the plain version with that vertex or
    face padded, and changes the answer (the card's planted faults)."""
    pos, quat, size, hulls, rng = _problem()
    lo, hi = (0, 2) if kernel == "plane_hull" else (2, 7)
    g1, g2 = _ids(rng, 5, 29, lo, hi, [])
    plain = getattr(cuda_collide, f"{kernel}_plain")
    if kernel == "plane_hull":
        short = hulls.nvert - 1
        vmask = hulls.vmask.clone()
        vmask[torch.arange(len(short)), short.long()] = 0.0
        faulty = hulls._replace(vmask=vmask)
        outs = _run(kernels[kernel], kernel, pos, quat, size, hulls, g1, g2,
                    nvert=short)
    else:
        short = hulls.nface - 1
        fdist = hulls.fdist.clone()
        fdist[torch.arange(len(short)), short.long()] = 1e10
        faulty = hulls._replace(fdist=fdist)
        outs = _run(kernels[kernel], kernel, pos, quat, size, hulls, g1, g2,
                    nface=short)
    want = plain(pos, quat, size, faulty, g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    full = plain(pos, quat, size, hulls, g1, g2)
    assert not torch.equal(outs[0], full[0])
