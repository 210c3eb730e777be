# Frozen copy of mujoco_rl_ur5_tpu_torch/physics/collision.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference.
"""Plain narrowphase for the scene's collision primitives, over leading
batch dims: the port's counterpart of the JAX package's
physics/collision.py.

Every function takes poses and shapes with any leading dims (the contact
step passes (B, npair)) and returns a fixed number K of candidate points:
pos (..., K, 3), normal (..., K, 3) pointing from geom1 into geom2, and
the signed surface distance dist (..., K) (negative = penetrating; BIG
marks an inactive slot). Cylinders collide as 16-gon prism hulls
(scene/compile.py ``_cylinder_prism_hull``).

The arithmetic, guards and tie rules are the JAX package's: ``lax.top_k``
keeps ascending order with ties to the lower index, which
``torch.argsort(stable=True)`` reproduces (``torch.topk`` promises no tie
order), and ``argmin``/``argmax`` keep the first extremum in both. A
resting box has four equal bottom corners, and the candidate slot order
keys the solver's warm start, so the order matters.

The plain versions of the four kernels (box-box, box-hull, hull-hull and
plane-hull, physics/cuda_collide.py) spell out every product and sum in
the kernels' order (``_dot3``, ``_rot``), elementwise, where the JAX
package uses matrix products: the kernels are built without contracting
multiply-adds, so kernel and plain version agree to the bit, on the CPU
and on the card alike (box-box's cross axes take the correctly rounded
root, ``_sqrt``, as the kernel's sqrtf does). A resting object has candidates of equal depth
(the four bottom corners of a box, sixteen rim vertices of an upright
prism), and a difference in the last bit would break their tie otherwise
in the two versions.

One deliberate difference: when a face axis wins box-box's edge SAT, the
inactive edge slot (dist = BIG) carries the normal (0, 0, 1) and the
midpoint of the two boxes' supporting corners, as the TPU kernel emits it
(physics/pallas_collide.py ``_box_box_edge_rows``); the JAX package's plain
path emits a cross axis there. Nothing reads an inactive slot's geometry.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from benchmark.reference.ops.consts import const
from benchmark.reference.ops.spatial import (
    cross, quat_rotate, quat_rotate_inv, quat_to_mat,
)
from benchmark.reference.scene.mjcf import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_MESH, GEOM_PLANE, GEOM_SPHERE,
)

BIG = 1e10
SIGNS8 = np.array(list(itertools.product((-1.0, 1.0), repeat=3)))


def _dot3(a, b):
    """a . b over the last axis as ((a0 b0 + a1 b1) + a2 b2), the order
    the kernels use (csrc/collide_common.cuh dot3)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _rot(R, v):
    """R @ v, row by row in the kernels' order (R (..., 3, 3) broadcast
    against v (..., 3))."""
    return torch.stack([_dot3(R[..., r, :], v) for r in range(3)], -1)


def _rot_t(R, v):
    """R^T @ v in the kernels' order."""
    return torch.stack([_dot3(R[..., :, a], v) for a in range(3)], -1)


def _norm(a):
    return torch.sqrt(_dot3(a, a))


def _sqrt(x):
    """The correctly rounded float32 square root, as a kernel's sqrtf
    (torch's vectorised CPU sqrt is off by an ulp in about 0.7% of cases;
    the float64 root rounded to float32 is exact)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _zaxis(q, like):
    return quat_rotate(q, const([0.0, 0.0, 1.0], like))


def _smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of d along its last axis in
    ``lax.top_k(-d, k)`` order: ascending, ties to the lower index."""
    return torch.argsort(d, dim=-1, stable=True)[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, 3) rows at idx (..., k)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))


def _bc(n, k):
    """A per-pair (..., 3) vector as k identical rows (..., k, 3)."""
    return n[..., None, :].expand(n.shape[:-1] + (k, 3))


# -- plane-X (the plane's z-axis is its outward normal) -------------------------


def plane_sphere(p1, q1, s1, p2, q2, s2):
    n = _zaxis(q1, p1)
    dist = _dot3(n, p2 - p1) - s2[..., 0]
    pos = p2 - n * (s2[..., 0] + 0.5 * dist)[..., None]
    return pos[..., None, :], n[..., None, :], dist[..., None]


def plane_capsule(p1, q1, s1, p2, q2, s2):
    n = _zaxis(q1, p1)
    axis = _zaxis(q2, p1)
    r, hl = s2[..., 0], s2[..., 1]
    ends = torch.stack([p2 + axis * hl[..., None],
                        p2 - axis * hl[..., None]], -2)
    dist = (ends @ n[..., None])[..., 0] - _dot3(n, p1)[..., None] - r[
        ..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    return pos, _bc(n, 2), dist


def _box_corners(p, q, s):
    """World corners (..., 8, 3) in SIGNS8 order."""
    R = quat_to_mat(q)[..., None, :, :]
    return p[..., None, :] + _rot(R, const(SIGNS8, p) * s[..., None, :])


def plane_box(p1, q1, s1, p2, q2, s2):
    n = _zaxis(q1, p1)
    corners = _box_corners(p2, q2, s2)                       # (..., 8, 3)
    d = (corners @ n[..., None])[..., 0] - _dot3(n, p1)[..., None]
    # the 4 lowest corners (a resting box has exactly 4)
    idx = _smallest(d, 4)
    dist = torch.gather(d, -1, idx)
    pos = _take(corners, idx) - 0.5 * dist[..., None] * n[..., None, :]
    return pos, _bc(n, 4), dist


# -- sphere-X --------------------------------------------------------------------


def sphere_sphere(p1, q1, s1, p2, q2, s2):
    d = p2 - p1
    L = _norm(d)
    n = d / torch.clamp_min(L, 1e-12)[..., None]
    dist = L - (s1[..., 0] + s2[..., 0])
    pos = p1 + n * (s1[..., 0] + 0.5 * dist)[..., None]
    return pos[..., None, :], n[..., None, :], dist[..., None]


def sphere_capsule(p1, q1, s1, p2, q2, s2):
    axis = _zaxis(q2, p1)
    tt = torch.clamp(_dot3(p1 - p2, axis), -s2[..., 1], s2[..., 1])
    d = p2 + axis * tt[..., None] - p1
    L = _norm(d)
    n = d / torch.clamp_min(L, 1e-12)[..., None]
    dist = L - (s1[..., 0] + s2[..., 0])
    pos = p1 + n * (s1[..., 0] + 0.5 * dist)[..., None]
    return pos[..., None, :], n[..., None, :], dist[..., None]


def _sphere_box_core(center, r, pb, qb, sb):
    """Sphere center vs box: (pos, outward box normal, dist), world."""
    c_l = quat_rotate_inv(qb, center - pb)
    clamped = torch.clamp(c_l, -sb, sb)
    delta = c_l - clamped
    d_out = _norm(delta)
    outside = d_out > 1e-9
    n_out = delta / torch.clamp_min(d_out, 1e-12)[..., None]
    # inside: push out through the nearest face
    face_d = sb - c_l.abs()
    k = torch.argmin(face_d, -1, keepdim=True)
    ck = torch.gather(c_l, -1, k)
    sgn = torch.sign(ck) + (ck == 0.0).to(ck.dtype)
    n_in = torch.zeros_like(c_l).scatter(-1, k, sgn)
    d_in = -torch.gather(face_d, -1, k)[..., 0]
    n_l = torch.where(outside[..., None], n_out, n_in)
    dist_c = torch.where(outside, d_out, d_in)
    surf_l = torch.where(outside[..., None], clamped,
                         c_l - n_in * d_in[..., None])
    n_w = quat_rotate(qb, n_l)
    dist = dist_c - r
    pos = quat_rotate(qb, surf_l) + pb + 0.5 * dist[..., None] * n_w
    return pos, n_w, dist


def sphere_box(p1, q1, s1, p2, q2, s2):
    pos, n_w, dist = _sphere_box_core(p1, s1[..., 0], p2, q2, s2)
    return pos[..., None, :], (-n_w)[..., None, :], dist[..., None]


# -- capsule-X -------------------------------------------------------------------


def _segment_closest(pa, ua, ha, pb, ub, hb):
    """Closest parameters (s, t) between segments pa + s ua, pb + t ub."""
    r = pa - pb
    a, e, f = _dot3(ua, ua), _dot3(ub, ub), _dot3(ub, r)
    c, b = _dot3(ua, r), _dot3(ua, ub)
    denom = a * e - b * b
    ok = denom.abs() > 1e-12
    s = torch.where(ok, (b * f - c * e) / torch.where(ok, denom, 1.0), 0.0)
    s = torch.clamp(s, -ha, ha)
    t = torch.clamp((b * s + f) / torch.clamp_min(e, 1e-12), -hb, hb)
    s = torch.clamp((b * t - c) / torch.clamp_min(a, 1e-12), -ha, ha)
    return s, t


def capsule_capsule(p1, q1, s1, p2, q2, s2):
    u1, u2 = _zaxis(q1, p1), _zaxis(q2, p1)
    s, t = _segment_closest(p1, u1, s1[..., 1], p2, u2, s2[..., 1])
    a = p1 + u1 * s[..., None]
    d = p2 + u2 * t[..., None] - a
    L = _norm(d)
    n = d / torch.clamp_min(L, 1e-12)[..., None]
    dist = L - (s1[..., 0] + s2[..., 0])
    pos = a + n * (s1[..., 0] + 0.5 * dist)[..., None]
    return pos[..., None, :], n[..., None, :], dist[..., None]


def capsule_box(p1, q1, s1, p2, q2, s2):
    """5 axis samples (ends, midpoints, the point nearest the box center),
    each a sphere against the box."""
    u = _zaxis(q1, p1)
    r, hl = s1[..., 0], s1[..., 1]
    tmid = torch.clamp(_dot3(p2 - p1, u), -hl, hl)
    ts = torch.stack([hl, -hl, 0.5 * (hl + tmid), 0.5 * (-hl + tmid), tmid],
                     -1)
    cands = p1[..., None, :] + u[..., None, :] * ts[..., None]
    pos, n_w, dist = _sphere_box_core(cands, r[..., None], p2[..., None, :],
                                      q2[..., None, :], s2[..., None, :])
    return pos, -n_w, dist


# -- box-box: corners both ways and the 15-axis edge SAT --------------------------


def _corner_in_box(c, pb, Rb, sb):
    d = c - pb
    c_l = _rot_t(Rb, d)
    face_d = sb - c_l.abs()
    inside = (face_d > 0).all(-1)
    k = torch.argmin(face_d, -1, keepdim=True)
    ck = torch.gather(c_l, -1, k)
    sgn = torch.sign(ck) + (ck == 0.0).to(ck.dtype)
    col = torch.gather(Rb.expand(c.shape[:-1] + (3, 3)), -1,
                       k[..., None, :].expand(c.shape[:-1] + (3, 1)))
    n_w = col[..., 0] * sgn
    dist = torch.where(inside, -torch.gather(face_d, -1, k)[..., 0], BIG)
    pos = c - n_w * (0.5 * dist * inside.to(c.dtype))[..., None]
    return pos, n_w, dist


def box_box(p1, q1, s1, p2, q2, s2):
    R1, R2 = quat_to_mat(q1), quat_to_mat(q2)
    c1, c2 = _box_corners(p1, q1, s1), _box_corners(p2, q2, s2)
    ex = lambda a: a[..., None, :]          # noqa: E731 (per-corner bcast)
    pos_a, n_a, d_a = _corner_in_box(c1, ex(p2), R2[..., None, :, :], ex(s2))
    pos_b, n_b, d_b = _corner_in_box(c2, ex(p1), R1[..., None, :, :], ex(s1))
    # corner of 1 inside 2: normal(1->2) = -n; corner of 2 inside 1: +n
    ia, ib = _smallest(d_a, 4), _smallest(d_b, 4)
    pos_e, n_e, d_e = _box_box_edge(p1, R1, s1, p2, R2, s2)
    pos = torch.cat([_take(pos_a, ia), _take(pos_b, ib),
                     pos_e[..., None, :]], -2)
    nrm = torch.cat([-_take(n_a, ia), _take(n_b, ib), n_e[..., None, :]], -2)
    dist = torch.cat([torch.gather(d_a, -1, ia), torch.gather(d_b, -1, ib),
                      d_e[..., None]], -1)
    return pos, nrm, dist


def _box_box_edge(p1, R1, s1, p2, R2, s2):
    """Edge-edge SAT contact: one contact at the closest points of the two
    supporting edges when no axis separates and a cross axis has the least
    penetration (dist = BIG otherwise; see the module note for the
    inactive slot's geometry)."""
    d12 = p2 - p1
    A = R1.transpose(-1, -2)        # rows: box 1's axes in world
    Bx = R2.transpose(-1, -2)
    crs = cross(A[..., :, None, :], Bx[..., None, :, :])      # (..., 3, 3, 3)
    crs = crs.reshape(crs.shape[:-3] + (9, 3))
    cn = _sqrt(_dot3(crs, crs))
    valid = cn > 1e-8
    cu = crs / torch.clamp_min(cn, 1e-12)[..., None]
    axes = torch.cat([A, Bx, cu], -2)                          # (..., 15, 3)

    def proj(M, s):                  # sum_m |M_m . L| s_m, m in order
        t = [_dot3(M[..., m, None, :], axes).abs() * s[..., m, None]
             for m in range(3)]
        return t[0] + t[1] + t[2]

    sep = _dot3(d12[..., None, :], axes).abs() - (proj(A, s1)
                                                  + proj(Bx, s2))
    ones6 = torch.ones_like(valid[..., :6])
    valid15 = torch.cat([ones6, valid], -1)
    sep = torch.where(valid15, sep, -BIG)
    separated = (sep > 0).any(-1)
    pen = torch.where(valid15, -sep, BIG)
    best = torch.argmin(pen, -1)
    edge_wins = best >= 6
    k = torch.clamp(best - 6, 0, 8)
    i = torch.div(k, 3, rounding_mode="floor")
    j = k % 3
    L = torch.gather(cu, -2, k[..., None, None].expand(k.shape + (1, 3)))[
        ..., 0, :]
    L = L * torch.sign(_dot3(L, d12))[..., None]
    L = torch.where(edge_wins[..., None], L, const([0.0, 0.0, 1.0], L))

    def row(M, idx):                 # M[..., idx, :], or 0 if a face wins
        r = torch.gather(M, -2, idx[..., None, None].expand(idx.shape
                                                            + (1, 3)))
        return torch.where(edge_wins[..., None], r[..., 0, :], 0.0)

    Ai, Bj = row(A, i), row(Bx, j)
    s1i = torch.where(edge_wins, torch.gather(s1, -1, i[..., None])[..., 0],
                      0.0)
    s2j = torch.where(edge_wins, torch.gather(s2, -1, j[..., None])[..., 0],
                      0.0)
    # supporting edges along A[i] and B[j]; the other axes at the corner
    # signs that face the other box (+L side of box 1, -L side of box 2)
    e1, e2 = p1, p2
    for m in range(3):
        hot_i = edge_wins & (i == m)
        hot_j = edge_wins & (j == m)
        w1 = torch.where(hot_i, 0.0, torch.sign(_dot3(A[..., m, :], L))
                         * s1[..., m])
        w2 = torch.where(hot_j, 0.0, torch.sign(_dot3(Bx[..., m, :], L))
                         * s2[..., m])
        e1 = e1 + A[..., m, :] * w1[..., None]
        e2 = e2 - Bx[..., m, :] * w2[..., None]
    s_, t_ = _segment_closest(e1, Ai, s1i, e2, Bj, s2j)
    mid = 0.5 * ((e1 + Ai * s_[..., None]) + (e2 + Bj * t_[..., None]))
    pen_best = torch.gather(pen, -1, best[..., None])[..., 0]
    dist = torch.where(separated | ~edge_wins, BIG, -pen_best)
    return mid, L, dist


# -- convex hulls (meshes, and cylinders as prisms) -------------------------------


def _hull_world(p, q, verts, fnorm, fdist):
    """Hull tables in world: verts (..., V, 3), faces {n . x <= d}."""
    R = quat_to_mat(q)[..., None, :, :]
    nw = _rot(R, fnorm)
    return (p[..., None, :] + _rot(R, verts), nw,
            fdist + _dot3(nw, p[..., None, :]))


def _deepest(vw, m, n, d, k=8):
    """The k vertices deepest below the face (n, d), stable order."""
    dist = torch.where(m > 0.5, _dot3(vw, n[..., None, :]) - d[..., None],
                       BIG)
    idx = _smallest(dist, k)
    dk = torch.gather(dist, -1, idx)
    return _take(vw, idx) - (0.5 * dk)[..., None] * n[..., None, :], dk


def _best_face(vw, m, nw, dw):
    """argmax over the faces (nw, dw) of min over masked vertices of
    (v . n_f) - d_f, first maximum: (sep, n, d)."""
    s = torch.where(m[..., :, None] > 0.5,
                    _dot3(vw[..., :, None, :], nw[..., None, :, :]), BIG)
    sep = s.min(-2).values - dw
    f = torch.argmax(sep, -1, keepdim=True)
    n = torch.gather(nw, -2, f[..., None].expand(f.shape + (3,)))[..., 0, :]
    return (torch.gather(sep, -1, f)[..., 0], n,
            torch.gather(dw, -1, f)[..., 0])


def hull_hull(p1, q1, v1, m1, n1, d1, p2, q2, v2, m2, n2, d2):
    """Face-normal SAT over both hulls' faces: the single least-overlap
    face, then the 8 deepest opposing vertices along it."""
    vw1, nw1, dw1 = _hull_world(p1, q1, v1, n1, d1)
    vw2, nw2, dw2 = _hull_world(p2, q2, v2, n2, d2)
    sep2, nA, dA = _best_face(vw1, m1, nw2, dw2)      # face on hull 2
    sep1, nB, dB = _best_face(vw2, m2, nw1, dw1)      # face on hull 1
    use2 = sep2 >= sep1
    posA, distA = _deepest(vw1, m1, nA, dA)
    posB, distB = _deepest(vw2, m2, nB, dB)
    # vertex of 1 on a face of 2: normal -n2; vertex of 2 on a face of 1: +n1
    pos = torch.where(use2[..., None, None], posA, posB)
    nrm = torch.where(use2[..., None], -nA, nB)
    dist = torch.where(use2[..., None], distA, distB)
    return pos, _bc(nrm, 8), dist


def plane_hull(p1, q1, s1, p2, q2, v2, m2, n2, d2):
    """The 8 deepest hull vertices under the plane (a flat-resting prism
    end needs its support polygon around the center of mass)."""
    n = quat_to_mat(q1)[..., :, 2]                   # the plane's z-axis
    vw = p2[..., None, :] + _rot(quat_to_mat(q2)[..., None, :, :], v2)
    dv = torch.where(m2 > 0.5, _dot3(vw, n[..., None, :])
                     - _dot3(n, p1)[..., None], BIG)
    idx = _smallest(dv, 8)
    dist = torch.gather(dv, -1, idx)
    pos = _take(vw, idx) - (0.5 * dist)[..., None] * n[..., None, :]
    return pos, _bc(n, 8), dist


def _sphere_hull_point(c, r, nw, dw):
    """Sphere center c (..., 3) against world faces (..., F, 3): the face
    of largest signed distance, the first of equals."""
    nw = nw.expand(c.shape[:-1] + nw.shape[-2:])
    scores = _dot3(nw, c[..., None, :]) - dw
    f = torch.argmax(scores, -1, keepdim=True)
    sdf = torch.gather(scores, -1, f)[..., 0]
    nf = torch.gather(nw, -2, f[..., None].expand(f.shape + (3,)))[..., 0, :]
    dist = sdf - r
    return c - nf * (r + 0.5 * dist)[..., None], -nf, dist


def sphere_hull(p1, q1, s1, p2, q2, v2, m2, n2, d2):
    _, nw, dw = _hull_world(p2, q2, v2, n2, d2)
    pos, nrm, dist = _sphere_hull_point(p1, s1[..., 0], nw, dw)
    return pos[..., None, :], nrm[..., None, :], dist[..., None]


def capsule_hull(p1, q1, s1, p2, q2, v2, m2, n2, d2):
    """5 axis samples as spheres (ends, center-nearest, midpoints). The
    hull's center is the mean of its real vertices, summed in index order,
    and the axis the rotation's z column (as the kernel computes both)."""
    vw, nw, dw = _hull_world(p2, q2, v2, n2, d2)
    mk = (m2 > 0.5).to(vw.dtype)
    acc = vw[..., 0, :] * mk[..., 0, None]
    for v in range(1, vw.shape[-2]):
        acc = acc + vw[..., v, :] * mk[..., v, None]
    center = acc / torch.clamp_min(mk.sum(-1), 1.0)[..., None]
    u = quat_to_mat(q1)[..., :, 2]
    r, hl = s1[..., 0], s1[..., 1]
    tmid = torch.clamp(_dot3(center - p1, u), -hl, hl)
    ts = torch.stack([-hl, hl, tmid, 0.5 * (hl + tmid), 0.5 * (-hl + tmid)],
                     -1)
    c = p1[..., None, :] + u[..., None, :] * ts[..., None]
    return _sphere_hull_point(c, r[..., None], nw[..., None, :, :],
                              dw[..., None, :])


def box_as_hull(s):
    """A box as an 8-vertex / 6-face hull: (verts, vmask, fnorm, fdist)."""
    v = const(SIGNS8, s) * s[..., None, :]
    eye = const(np.concatenate([np.eye(3), -np.eye(3)]), s)
    return (v, torch.ones_like(v[..., 0]), eye.expand(s.shape[:-1] + (6, 3)),
            torch.cat([s, s], -1))


def box_hull(p1, q1, s1, p2, q2, v2, m2, n2, d2):
    """Box (an 8-vertex / 6-face hull) against a hull."""
    return hull_hull(p1, q1, *box_as_hull(s1), p2, q2, v2, m2, n2, d2)


# (type1, type2) -> (function, points per pair); types are mjcf's enums
NARROWPHASE = {
    (GEOM_PLANE, GEOM_SPHERE): (plane_sphere, 1),
    (GEOM_PLANE, GEOM_CAPSULE): (plane_capsule, 2),
    (GEOM_PLANE, GEOM_BOX): (plane_box, 4),
    (GEOM_SPHERE, GEOM_SPHERE): (sphere_sphere, 1),
    (GEOM_SPHERE, GEOM_CAPSULE): (sphere_capsule, 1),
    (GEOM_SPHERE, GEOM_BOX): (sphere_box, 1),
    (GEOM_CAPSULE, GEOM_CAPSULE): (capsule_capsule, 1),
    (GEOM_CAPSULE, GEOM_BOX): (capsule_box, 5),
    (GEOM_BOX, GEOM_BOX): (box_box, 9),
}

# hull pairs (geom2 is the hull; GEOM_MESH is the largest type, so the
# canonical pair order puts it second): the hull tables (verts, vmask,
# fnorm, fdist) follow (p2, q2)
HULL_NARROWPHASE = {
    (GEOM_PLANE, GEOM_MESH): (plane_hull, 8),
    (GEOM_SPHERE, GEOM_MESH): (sphere_hull, 1),
    (GEOM_CAPSULE, GEOM_MESH): (capsule_hull, 5),
    (GEOM_BOX, GEOM_MESH): (box_hull, 8),
    (GEOM_MESH, GEOM_MESH): (hull_hull, 8),
}


def pair_points(t1: int, t2: int) -> int:
    """Candidate points generated per pair of collision types."""
    if (t1, t2) in NARROWPHASE:
        return NARROWPHASE[(t1, t2)][1]
    return HULL_NARROWPHASE[(t1, t2)][1]
