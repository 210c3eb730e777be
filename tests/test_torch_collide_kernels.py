"""The four narrowphase kernel wrappers of physics/cuda_collide.py, on CPU
tensors (their plain versions), against the JAX package's reference
functions vmapped over the batch: ``jax.vmap(jax.vmap(collision.*))``,
which tests/test_pallas_collide.py holds equal to the TPU kernels.

Shapes are those of test_pallas_collide.py: B=5 scenarios of N=7 pairs,
seeded random poses, box sizes 0.03-0.12 m and random convex hulls (16
vertices and 24 faces, padded). The wrappers read per-geom poses and the
model's hull tables by geom id; here every (scenario, pair, side) gets a
geom of its own, so the same per-pair operands reach both. Compared slot
by slot where the reference is active (dist < 1): dist, point and normal
to 2e-5 absolute (float32 in another order); inactive slots stay inactive.
The CPU route launches nothing, and the sphere-hull and capsule-hull
groups, which have no kernel yet, run their plain versions on the CPU and
raise where a kernel would be launched.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

from mujoco_rl_ur5_tpu.physics import collision as jc
from mujoco_rl_ur5_tpu_torch.physics import cuda_collide as cc

B, N = 5, 7
ATOL = 2e-5


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _hulls(rng, V=16, F=24):
    verts = np.zeros((B, N, V, 3), np.float32)
    vmask = np.zeros((B, N, V), np.float32)
    fnorm = np.zeros((B, N, F, 3), np.float32)
    fdist = np.full((B, N, F), 1e10, np.float32)
    for b, n in itertools.product(range(B), range(N)):
        pts = rng.uniform(-0.08, 0.08, size=(12, 3))
        h = ConvexHull(pts)
        hv, eq = pts[h.vertices], h.equations[:F]
        verts[b, n, :len(hv)] = hv
        vmask[b, n, :len(hv)] = 1.0
        fnorm[b, n, :len(eq)] = eq[:, :3]
        fdist[b, n, :len(eq)] = -eq[:, 3]
    return verts, vmask, fnorm, fdist


def _case(kernel, seed):
    """Per-pair operands (as the JAX reference takes them) and the same
    operands as per-geom tables with pair ids (as the wrappers take them)."""
    rng = np.random.default_rng(seed)
    spread = 0.1 if kernel != "box_box" else 0.15
    if kernel == "plane_hull":
        p1 = rng.uniform(-0.05, 0.0, (B, N, 3)).astype(np.float32)
        spread = 0.08
    else:
        p1 = rng.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    q1 = _quats(rng, (B, N))
    s1 = rng.uniform(0.03, 0.12, (B, N, 3)).astype(np.float32)
    p2 = rng.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    q2 = _quats(rng, (B, N))
    s2 = rng.uniform(0.03, 0.12, (B, N, 3)).astype(np.float32)
    h1, h2 = _hulls(rng), _hulls(rng)

    # geom id of (side, b, n): side * B * N + b * N + n
    G = 2 * B * N
    pos = np.zeros((B, G, 3), np.float32)
    quat = np.tile(np.array([1, 0, 0, 0], np.float32), (B, G, 1))
    size = np.zeros((G, 3), np.float32)
    ids = np.arange(B * N).reshape(B, N)
    for side, (p, q, s) in enumerate(((p1, q1, s1), (p2, q2, s2))):
        for b in range(B):
            pos[b, side * B * N + ids[b]] = p[b]
            quat[b, side * B * N + ids[b]] = q[b]
        size[side * B * N: (side + 1) * B * N] = s.reshape(-1, 3)
    tables = [np.concatenate([a.reshape((B * N,) + a.shape[2:]),
                              b.reshape((B * N,) + b.shape[2:])])
              for a, b in zip(h1, h2)]
    hulls = cc.Hulls(torch.arange(G), *(torch.from_numpy(t) for t in tables))
    g1, g2 = torch.from_numpy(ids), torch.from_numpy(B * N + ids)
    t = torch.from_numpy
    wrapper_args = (t(pos), t(quat), t(size), hulls, g1, g2)
    ref_args = {"box_box": (p1, q1, s1, p2, q2, s2),
                "hull_hull": (p1, q1, *h1, p2, q2, *h2),
                "box_hull": (p1, q1, s1, p2, q2, *h2),
                "plane_hull": (p1, q1, s1, p2, q2, *h2),
                "sphere_hull": (p1, q1, s1, p2, q2, *h2),
                "capsule_hull": (p1, q1, s1, p2, q2, *h2)}[kernel]
    return ref_args, wrapper_args


def _launches():
    return tuple(getattr(cc, k + "_batched").launches for k in cc.KERNELS)


@pytest.mark.parametrize("kernel", cc.KERNELS + ("sphere_hull",
                                                 "capsule_hull"))
def test_wrapper_on_cpu_matches_jax_reference(kernel):
    ref_args, args = _case(kernel, seed=11 + len(kernel))
    ref = jax.jit(jax.vmap(jax.vmap(getattr(jc, kernel))))(
        *(jnp.asarray(a) for a in ref_args))
    before = _launches()
    got = getattr(cc, kernel + "_batched")(*args)
    assert _launches() == before
    rp, rn, rd = (np.asarray(r) for r in ref)
    gp, gn, gd = (g.numpy() for g in got)
    assert gp.shape == rp.shape and gd.shape == rd.shape
    act = rd < 1.0
    assert act.sum() >= 10
    np.testing.assert_allclose(gd[act], rd[act], atol=ATOL, rtol=0)
    np.testing.assert_allclose(gp[act], rp[act], atol=ATOL, rtol=0)
    np.testing.assert_allclose(gn[act], rn[act], atol=ATOL, rtol=0)
    assert np.all(gd[~act] >= 1.0)


@pytest.mark.parametrize("kernel", ["sphere_hull", "capsule_hull"])
def test_groups_without_a_kernel_raise_where_one_would_launch(
        monkeypatch, kernel):
    _, args = _case(kernel, seed=3)
    monkeypatch.setattr(cc, "_route", lambda *ts: True)
    with pytest.raises(NotImplementedError, match="row 1[01]"):
        getattr(cc, kernel + "_batched")(*args)


def test_kernel_sources_are_in_the_package():
    srcs = cc.kernel_sources()
    assert [s.name for s in srcs] == ["collide_" + k for k in cc.KERNELS]
    assert len({s.key for s in srcs}) == 4
    for s in srcs:
        assert "collide_common.cuh" in s.headers
        assert f"COLLIDE_ENTRY({s.entry[len('collide_'):]})" in s.text
