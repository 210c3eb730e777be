"""Every plain narrowphase of the port's physics/collision.py against the
JAX package's physics/collision.py (vmapped over the same (B, N) batch).

Inputs are seeded random poses, sizes and convex hulls (scipy's hull of
random points, padded as the compiler pads hull tables), plus exact ties:
a box lying flat on a plane, an axis-aligned box on a box, and an upright
16-gon prism on a plane, where several candidates have the same depth.

Slots are compared in place, not sorted: the stable top-k order keys the
contact solver's warm start. Where the JAX slot is active (dist < 1) the
port's dist, point and normal agree to 2e-5 absolute (the same float32
arithmetic in another order, at coordinates of 0.1 m); where it is inactive
(BIG), the port's is inactive too. (Box-box's inactive edge slot carries
the TPU kernel's normal in the port; see collision.py.)
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

from mujoco_rl_ur5_tpu.physics import collision as jc
from mujoco_rl_ur5_tpu_torch.physics import collision as tc
from mujoco_rl_ur5_tpu_torch.scene.compile import _cylinder_prism_hull

B, N = 5, 7
ATOL = 2e-5
PRIMS = ["plane_sphere", "plane_capsule", "plane_box", "sphere_sphere",
         "sphere_capsule", "sphere_box", "capsule_capsule", "capsule_box",
         "box_box"]
HULLS = ["plane_hull", "sphere_hull", "capsule_hull", "box_hull",
         "hull_hull"]


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _hull_tables(rng, V=16, F=24):
    verts = np.zeros((B, N, V, 3))
    vmask = np.zeros((B, N, V))
    fnorm = np.zeros((B, N, F, 3))
    fdist = np.full((B, N, F), 1e10)
    for b, n in itertools.product(range(B), range(N)):
        pts = rng.uniform(-0.08, 0.08, size=(12, 3))
        h = ConvexHull(pts)
        hv, eq = pts[h.vertices], h.equations[:F]
        verts[b, n, :len(hv)] = hv
        vmask[b, n, :len(hv)] = 1.0
        fnorm[b, n, :len(eq)] = eq[:, :3]
        fdist[b, n, :len(eq)] = -eq[:, 3]
    return [verts, vmask, fnorm, fdist]


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    spread = 0.08 if name.startswith("plane") else 0.15
    p1 = rng.uniform(-spread, spread, (B, N, 3))
    if name.startswith("plane"):
        p1 = rng.uniform(-0.05, 0.0, (B, N, 3))
    q1 = _quats(rng, (B, N))
    s1 = rng.uniform(0.03, 0.12, (B, N, 3))
    p2 = rng.uniform(-spread, spread, (B, N, 3))
    q2 = _quats(rng, (B, N))
    if name in HULLS:
        h2 = _hull_tables(rng)
        if name == "hull_hull":
            return [p1, q1, *_hull_tables(rng), p2, q2, *h2]
        return [p1, q1, s1, p2, q2, *h2]
    return [p1, q1, s1, p2, q2, rng.uniform(0.03, 0.12, (B, N, 3))]


def _ties():
    """Flat and axis-aligned configurations with equal-depth candidates."""
    ident = np.tile([1.0, 0, 0, 0], (B, N, 1))
    rng = np.random.default_rng(5)
    s = rng.uniform(0.02, 0.05, (B, N, 3)).round(3)
    z = np.zeros((B, N, 3))
    box_on_plane = [z, ident, s, z + [0, 0, 0.0], ident, s]
    box_on_plane[3] = np.concatenate([rng.uniform(-0.1, 0.1, (B, N, 2)),
                                      s[..., 2:] - 0.001], -1)
    top = np.concatenate([z[..., :2] + 0.005, 1.5 * s[..., 2:] - 0.0005],
                         -1)
    box_on_box = [z, ident, s, top, ident, 0.5 * s]
    h = _cylinder_prism_hull(0.02, 0.03)
    V, F = len(h.hull_verts), len(h.hull_fnorm)
    tab = [np.broadcast_to(h.hull_verts, (B, N, V, 3)), np.ones((B, N, V)),
           np.broadcast_to(h.hull_fnorm, (B, N, F, 3)),
           np.broadcast_to(h.hull_fdist, (B, N, F))]
    prism_on_plane = [z, ident, s, z + [0.0, 0.0, 0.0295], ident, *tab]
    return {"plane_box": box_on_plane, "box_box": box_on_box,
            "plane_hull": prism_on_plane}


def _compare(name, args):
    args = [np.asarray(a, np.float32) for a in args]
    ref = jax.jit(jax.vmap(jax.vmap(getattr(jc, name))))(
        *(jnp.asarray(a) for a in args))
    got = getattr(tc, name)(*(torch.from_numpy(a.copy()) for a in args))
    rp, rn, rd = (np.asarray(r) for r in ref)
    gp, gn, gd = (g.numpy() for g in got)
    assert gd.shape == rd.shape and gp.shape == rp.shape
    act = rd < 1.0
    assert act.any()
    np.testing.assert_allclose(gd[act], rd[act], atol=ATOL, rtol=0)
    np.testing.assert_allclose(gp[act], rp[act], atol=ATOL, rtol=0)
    np.testing.assert_allclose(gn[act], rn[act], atol=ATOL, rtol=0)
    assert np.all(gd[~act] >= 1.0)
    return act


@pytest.mark.parametrize("name", PRIMS + HULLS)
def test_narrowphase_matches_jax(name):
    _compare(name, _inputs(name, seed=PRIMS.__len__() + len(name)))


@pytest.mark.parametrize("name", ["plane_box", "box_box", "plane_hull"])
def test_exact_ties_keep_the_jax_slot_order(name):
    """Equal depths: the same candidates in the same slots."""
    act = _compare(name, _ties()[name])
    # every pair has tied candidates among its active slots
    assert act.sum(-1).min() >= 4


def test_pair_points_match_jax():
    for table in ("NARROWPHASE", "HULL_NARROWPHASE"):
        mine, ref = getattr(tc, table), getattr(jc, table)
        assert set(mine) == set(ref)
        for k in ref:
            assert mine[k][1] == ref[k][1] == tc.pair_points(*k)
            assert mine[k][0].__name__ == ref[k][0].__name__
