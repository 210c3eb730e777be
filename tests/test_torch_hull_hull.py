"""The hull-hull kernel (csrc/collide_hull_hull.cu) on the host.

The kernel gives each (pair, scenario) a team of lanes that share the face
loop, stages the hull table in shared memory and loops over each row's
real vertices and faces only. Compiled with g++ through the threaded host
shim of tests/test_torch_host_shim.py (warp shuffles and barriers
emulated) and called through its C entry point on CPU tensors, it must
equal
``cuda_collide.hull_hull_plain`` to the bit in every output slot, as on the
card (built with -fmad=false). The tables mix the cylinder prism (32
vertices, 18 faces), the finger pad's hull (24, 34), a tetrahedron (4
vertices: fewer than the 8 slots, so 4 slots carry BIG at the padded
vertices' indices) and two cubes placed so that faces tie: within each
hull, -x and -y (+x and +y) separate equally, and the two hulls' best
faces separate equally, so the first face of hull 2 must win. The pairs
mix the rows within every warp, and 145 instances are no multiple of a
block's 32.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_host_shim import host_build

from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.physics import cuda_collide

V, F = 32, 34


def _tetra(s):
    v = s * np.array([[1.0, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]])
    n, d = [], []
    for i in range(4):
        a, b, c = (v[j] for j in range(4) if j != i)
        nn = np.cross(b - a, c - a)
        nn /= np.linalg.norm(nn)
        if nn @ (v[i] - a) > 0:
            nn = -nn
        n.append(nn)
        d.append(nn @ a)
    return v, np.array(n), np.array(d)


def _cube(s):
    v = np.array([[(c & 4 and 1 or -1) * s, (c & 2 and 1 or -1) * s,
                   (c & 1 and 1 or -1) * s] for c in range(8)])
    n = np.concatenate([np.eye(3), -np.eye(3)])          # +x +y +z -x -y -z
    return v, n, np.full(6, s)


def _tables():
    from mujoco_rl_ur5_tpu_torch.scene.compile import _cylinder_prism_hull
    from mujoco_rl_ur5_tpu_torch.scene.mesh import process_mesh
    pad = process_mesh("pad", os.path.join(os.path.dirname(OBJECTS),
                                           "finger_pad.stl"), np.full(3, 2e-3))
    prism = _cylinder_prism_hull(0.03, 0.05)
    rows = [(prism.hull_verts, prism.hull_fnorm, prism.hull_fdist),
            (pad.hull_verts, pad.hull_fnorm, pad.hull_fdist),
            _tetra(0.04), _cube(0.0625), _cube(0.015625)]
    verts, vmask = np.zeros((len(rows), V, 3)), np.zeros((len(rows), V))
    fnorm, fdist = np.zeros((len(rows), F, 3)), np.full((len(rows), F), 1e10)
    for i, (v, n, d) in enumerate(rows):
        verts[i, :len(v)], vmask[i, :len(v)] = v, 1.0
        fnorm[i, :len(n)], fdist[i, :len(n)] = n, d
    return verts, vmask, fnorm, fdist


def _f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _problem():
    """Five scenarios of 29 pairs among 12 geoms: prisms (0-3), pads (4-7),
    tetrahedra (8, 9) and the two cubes (10, 11), which scenario 0's pair 0
    places face to face with tied faces."""
    rng = np.random.default_rng(11)
    B, n, G = 5, 29, 12
    meshid = torch.tensor([0] * 4 + [1] * 4 + [2, 2, 3, 4])
    pos = rng.uniform(-0.08, 0.08, (B, G, 3))
    q = rng.normal(size=(B, G, 4))
    quat = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pos[0, 10], pos[0, 11] = 0.0, [0.09375, 0.09375, 0.0]   # exact in f32
    quat[0, 10] = quat[0, 11] = [1.0, 0.0, 0.0, 0.0]
    g1 = rng.integers(0, 10, (B, n))
    g2 = (g1 + rng.integers(1, 10, (B, n))) % 10       # another geom
    g1[0, 0], g2[0, 0] = 10, 11
    verts, vmask, fnorm, fdist = (_f32(a) for a in _tables())
    hulls = cuda_collide.Hulls(meshid, verts, vmask, fnorm, fdist,
                               *cuda_collide.hull_counts(vmask, fdist))
    return (_f32(pos), _f32(quat), hulls, torch.from_numpy(g1),
            torch.from_numpy(g2))


def test_hull_hull_kernel_source_equals_plain_on_the_host(tmp_path):
    fn = host_build(cuda_collide.source("hull_hull"), tmp_path)
    pos, quat, hulls, g1, g2 = _problem()
    B, G = pos.shape[:2]
    n = g1.shape[1]
    nvert, nface = hulls.nvert, hulls.nface
    assert nvert.tolist() == [32, 24, 4, 8, 8]
    assert nface.tolist() == [18, 34, 4, 6, 6]
    outs = [torch.empty(B, n, 8, 3), torch.empty(B, n, 8, 3),
            torch.empty(B, n, 8)]
    keep = [pos, quat, hulls.meshid.to(torch.int32), hulls.verts,
            hulls.fnorm, hulls.fdist, nvert, nface, g1.to(torch.int32),
            g2.to(torch.int32), *outs]
    M = hulls.verts.shape[0]
    assert fn(*(x.data_ptr() for x in keep), B, n, G, M, V, F, None) == 0
    want = cuda_collide.hull_hull_plain(pos, quat, None, hulls, g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    act = want[2] < 1.0
    assert int(act.sum()) > 200
    rows = {(int(a), int(b)) for a, b in zip(hulls.meshid[g1].flatten(),
                                             hulls.meshid[g2].flatten())}
    assert {(0, 1), (1, 0), (1, 1), (0, 0), (2, 0)} <= rows   # mixed warps
    # the tetrahedron's pairs: BIG in the slots past its 4 real vertices
    tet = (hulls.meshid[g1] == 2) | (hulls.meshid[g2] == 2)
    assert bool((want[2][tet][:, 4:] == 1e10).any())
    # the tied cubes: the first of hull 2's tied faces (-x), its normal
    # negated, and its four tied deepest vertices in index order
    assert want[1][0, 0, 0].tolist() == [1.0, 0.0, 0.0]
    assert want[2][0, 0, :4].tolist() == [0.015625] * 4


def test_hull_hull_kernel_takes_the_counts_it_is_given(tmp_path):
    """The counts decide what the kernel reads: the pad row's face count one
    short changes the answer of pairs whose best face is its last one, and
    nothing else (the card's planted fault in phase 9)."""
    fn = host_build(cuda_collide.source("hull_hull"), tmp_path)
    pos, quat, hulls, g1, g2 = _problem()
    B, G = pos.shape[:2]
    n = g1.shape[1]
    nvert, nface = hulls.nvert, hulls.nface
    short = nface.clone()
    short[1] -= 1                                        # the pad's face 33
    outs = [torch.empty(B, n, 8, 3), torch.empty(B, n, 8, 3),
            torch.empty(B, n, 8)]
    keep = [pos, quat, hulls.meshid.to(torch.int32), hulls.verts,
            hulls.fnorm, hulls.fdist, nvert, short, g1.to(torch.int32),
            g2.to(torch.int32), *outs]
    M = hulls.verts.shape[0]
    assert fn(*(x.data_ptr() for x in keep), B, n, G, M, V, F, None) == 0
    # the plain version with the pad's last face moved out of reach
    fdist = hulls.fdist.clone()
    fdist[1, 33] = 1e10
    want = cuda_collide.hull_hull_plain(
        pos, quat, None, hulls._replace(fdist=fdist), g1, g2)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    full = cuda_collide.hull_hull_plain(pos, quat, None, hulls, g1, g2)
    assert not torch.equal(outs[2], full[2])


@pytest.mark.parametrize("scene", ["PILE", "OBJECTS"])
def test_model_hulls_carry_real_counts_first(scene):
    """The hull tables the step hands the kernel: each row's real vertices
    and faces come first, and ``constraints.hulls`` carries their counts
    (the box pile's prisms 32 and 18; the object pile's pad 24 and 34)."""
    import mujoco_rl_ur5_tpu_torch as port
    from mujoco_rl_ur5_tpu_torch.physics import constraints
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
    h = constraints.hulls(load_model(getattr(port, scene), device="cpu"))
    assert h.nvert.dtype == h.nface.dtype == torch.int32
    V, F = h.verts.shape[1], h.fnorm.shape[1]
    assert torch.equal(h.vmask > 0.5, torch.arange(V) < h.nvert[:, None])
    assert torch.equal(h.fdist < 1e9, torch.arange(F) < h.nface[:, None])
    rows = set(zip(h.nvert.tolist(), h.nface.tolist()))
    assert (32, 18) in rows and ((24, 34) in rows) == (scene == "OBJECTS")


def test_hull_hull_launch_needs_the_counts():
    pos, quat, hulls, g1, g2 = _problem()
    with pytest.raises(ValueError, match="counts"):
        cuda_collide.team_launch("hull_hull", pos, quat, None,
                                 hulls._replace(nvert=None), g1, g2)


def test_hull_hull_raises_where_the_table_does_not_fit():
    """The table is staged in one block's shared memory: a table too large
    for it raises before any build or launch."""
    pos, quat, hulls, g1, g2 = _problem()
    assert cuda_collide.team_smem("hull_hull", 11, 32, 34) < 48 * 1024
    M = 2000
    big = cuda_collide.Hulls(hulls.meshid, *(t[:1].expand((M,) + t.shape[1:])
                                             for t in hulls[1:]))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_collide.team_launch("hull_hull", pos, quat, None, big, g1, g2)
