# Frozen copy of mujoco_rl_ur5_tpu_torch/scene/mesh.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference.
"""Host-side mesh processing for the MJCF compiler: the port's copy of the
JAX package's scene/mesh.py, in numpy and scipy.

A mesh geom takes its mass properties from the STL's triangles and collides
(and renders) as a convex hull:

  * binary and ASCII STL loading, vertices deduplicated;
  * signed-volume and MuJoCo's legacy (absolute tetrahedra about the
    running centre of mass) mass properties, and the principal axes;
  * the convex hull (scipy.spatial.ConvexHull), decimated to at most
    ``max_verts`` vertices by farthest-point sampling, and its halfspaces
    {x : n . x <= d} with coplanar triangles merged: the hull tables of the
    narrowphase and the renderer;
  * the fitted box or capsule (PCA) that the JAX package keeps beside the
    hull.

Everything runs once on the host while a scene compiles.
"""

from __future__ import annotations

import io
import struct as _struct
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class MeshData:
    """Processed mesh: raw geometry + mass properties + collision proxies."""

    name: str
    verts: np.ndarray          # (nv, 3) float64, deduplicated
    faces: np.ndarray          # (nf, 3) int32 into verts
    volume: float              # signed volume (abs)
    com: np.ndarray            # (3,) center of mass
    inertia_com: np.ndarray    # (3,3) unit-density inertia about COM
    hull_verts: np.ndarray     # (nh, 3) convex hull vertices
    # halfspace hull {x: fnorm.x <= fdist} over the decimated hull_verts —
    # the on-device collision representation (MuJoCo also collides meshes
    # through their convex hulls)
    hull_fnorm: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    hull_fdist: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # fitted collision primitive in mesh frame: "box" or "capsule"
    fit_kind: str = "box"
    fit_size: np.ndarray = field(default_factory=lambda: np.zeros(3))
    fit_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    fit_quat: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))


def load_stl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load an STL file (binary or ASCII) -> (verts (n,3) f64, faces (m,3) i32).

    Vertices are deduplicated with exact matching (STL repeats each vertex per
    triangle).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:5] == b"solid" and b"facet" in data[:500]:
        tris = _parse_ascii_stl(data)
    else:
        ntri = _struct.unpack("<I", data[80:84])[0]
        # each record: normal (3f) + 3 verts (9f) + attr (H) = 50 bytes
        rec = np.frombuffer(data[84 : 84 + ntri * 50], dtype=np.uint8).reshape(ntri, 50)
        floats = rec[:, :48].copy().view("<f4").reshape(ntri, 12)
        tris = floats[:, 3:].reshape(ntri, 3, 3).astype(np.float64)
    flat = tris.reshape(-1, 3)
    verts, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts, faces


def _parse_ascii_stl(data: bytes) -> np.ndarray:
    tris = []
    cur = []
    for line in io.StringIO(data.decode("ascii", errors="ignore")):
        t = line.split()
        if len(t) >= 4 and t[0] == "vertex":
            cur.append([float(t[1]), float(t[2]), float(t[3])])
            if len(cur) == 3:
                tris.append(cur)
                cur = []
    return np.asarray(tris, dtype=np.float64)


def mass_properties(verts: np.ndarray, faces: np.ndarray):
    """Unit-density mass properties via signed tetrahedra against the origin.

    Returns (volume, com, inertia_about_com). Matches MuJoCo's exact mesh
    inertia (legacy ``exactmeshinertia`` / volume integration) to float
    precision for watertight meshes.
    """
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    # signed volume of tet (0, a, b, c)
    d = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0
    vol = d.sum()
    com = ((a + b + c) / 4.0 * d[:, None]).sum(axis=0) / vol
    # inertia: integrate x_i x_j over each tet (canonical tet formula)
    # For tet with verts 0,A,B,C: ∫ x x^T dV = (detJ/120) * Σ_{k<=l}(v_k v_l^T + v_l v_k^T)
    # with v over {A,B,C}; equivalently (detJ/20)*(Σ v v^T + (Σv)(Σv)^T) where Σ over A,B,C
    def outer_sum(p, q):
        return np.einsum("ni,nj->nij", p, q)

    s = a + b + c
    integ = (
        outer_sum(a, a) + outer_sum(b, b) + outer_sum(c, c) + outer_sum(s, s)
    ) * (6.0 * d / 120.0)[:, None, None]
    second_moment = integ.sum(axis=0)  # ∫ x x^T dV about origin
    # shift to COM: ∫(x-c)(x-c)^T = ∫xx^T - V c c^T
    sm_com = second_moment - vol * np.outer(com, com)
    inertia = np.trace(sm_com) * np.eye(3) - sm_com
    return float(vol), com, inertia


def legacy_mass_properties(verts: np.ndarray, faces: np.ndarray, iters: int = 20):
    """MuJoCo *legacy* mesh-inertia algorithm (mjMESH_INERTIA_LEGACY — the mode
    mujoco_py 2.x and therefore the reference's compiled model used).

    Unlike the exact signed-volume integral, legacy decomposes the surface into
    tetrahedra against the running center of mass and takes **absolute** tet
    volumes (robust to non-watertight VCG meshes like the UR5 STLs), iterating
    the reference point to a fixed point. Verified against MuJoCo-compiled
    body_mass/body_inertia for the UR5 meshes to ~1e-3 relative
    (e.g. upper_arm_link 20.0554 vs 20.0576 kg).

    Returns (volume, com, inertia_about_com) at unit density.
    """
    ref = verts.mean(axis=0)
    a0, b0, c0 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    for _ in range(iters):
        a, b, c = a0 - ref, b0 - ref, c0 - ref
        d = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0)
        vol = d.sum()
        ref = ref + (((a + b + c) / 4.0) * d[:, None]).sum(axis=0) / vol
    a, b, c = a0 - ref, b0 - ref, c0 - ref
    d = np.abs(np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0)
    vol = float(d.sum())
    s = a + b + c
    integ = (
        np.einsum("ni,nj->nij", a, a)
        + np.einsum("ni,nj->nij", b, b)
        + np.einsum("ni,nj->nij", c, c)
        + np.einsum("ni,nj->nij", s, s)
    ) * (d / 20.0)[:, None, None]
    sm = integ.sum(axis=0)
    inertia = np.trace(sm) * np.eye(3) - sm
    return vol, ref, inertia


def principal_inertia(mass: float, inertia_com: np.ndarray):
    """Diagonalize an inertia tensor -> (diag (3,), quat (4,) w-first) with a
    right-handed eigenbasis, eigenvalues descending.

    Already-diagonal tensors keep their axis order with identity orientation —
    matching MuJoCo, whose compiler marks such (free) bodies "simple" and
    assumes an identity iquat downstream."""
    scale = max(np.abs(inertia_com).max(), 1e-30)
    off = inertia_com - np.diag(np.diag(inertia_com))
    if np.abs(off).max() < 1e-9 * scale:
        return np.diag(inertia_com) * mass, np.array([1.0, 0, 0, 0])
    w, v = np.linalg.eigh(inertia_com)
    order = np.argsort(w)[::-1]
    w = w[order]
    v = v[:, order]
    if np.linalg.det(v) < 0:
        v[:, 2] *= -1
    return w * mass, _mat2quat(v)


def _mat2quat(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    else:
        i = np.argmax(np.diag(m))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-18)) * 2
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


def hull_faces(verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Convex hull as (verts, outward-oriented faces). MuJoCo's default mesh
    inertia mode is ``convex`` — mass properties are integrated over the hull,
    not the raw triangle soup — so the compiler integrates over these faces to
    match MuJoCo-compiled body masses (e.g. upper_arm_link 20.06 kg)."""
    from scipy.spatial import ConvexHull

    h = ConvexHull(verts)
    hv = verts[h.vertices]
    remap = np.full(len(verts), -1, dtype=np.int64)
    remap[h.vertices] = np.arange(len(h.vertices))
    faces = remap[h.simplices]
    # orient each face outward w.r.t. the hull centroid
    centroid = hv.mean(axis=0)
    a, b, c = hv[faces[:, 0]], hv[faces[:, 1]], hv[faces[:, 2]]
    n = np.cross(b - a, c - a)
    flip = np.einsum("ij,ij->i", n, a - centroid) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return hv, faces.astype(np.int32)


def convex_hull(verts: np.ndarray, max_verts: int = 64) -> np.ndarray:
    """Convex hull vertex set, decimated to <= max_verts (farthest-point)."""
    try:
        hv, _ = hull_faces(verts)
    except Exception:
        hv = verts
    if len(hv) > max_verts:
        # farthest-point sampling keeps extremal support points
        sel = [int(np.argmax(np.linalg.norm(hv - hv.mean(0), axis=1)))]
        d = np.linalg.norm(hv - hv[sel[0]], axis=1)
        for _ in range(max_verts - 1):
            nxt = int(np.argmax(d))
            sel.append(nxt)
            d = np.minimum(d, np.linalg.norm(hv - hv[nxt], axis=1))
        hv = hv[sel]
    return hv


def hull_halfspaces(hull_verts: np.ndarray):
    """Halfspace representation {x : n_f . x <= d_f} of a convex vertex set.

    Recomputes the hull over the (possibly decimated) vertex set and merges
    coplanar triangle faces, so a box mesh yields 6 planes, not 12 triangles.
    This is the collision representation MuJoCo itself uses for mesh geoms
    (convex hull), replacing the fitted-primitive proxy that over-approximated
    e.g. the UR5 wrist rings and produced phantom arm self-contacts.

    Returns (normals (nf, 3) unit outward, offsets (nf,)).
    """
    hv, faces = hull_faces(hull_verts)
    a, b, c = hv[faces[:, 0]], hv[faces[:, 1]], hv[faces[:, 2]]
    n = np.cross(b - a, c - a)
    ln = np.linalg.norm(n, axis=1)
    keep = ln > 1e-12
    n = n[keep] / ln[keep, None]
    d = np.einsum("ij,ij->i", n, a[keep])
    # merge coplanar faces
    out_n, out_d = [], []
    for i in range(len(n)):
        dup = False
        for j in range(len(out_n)):
            if np.dot(n[i], out_n[j]) > 1.0 - 1e-9 and abs(d[i] - out_d[j]) < 1e-9:
                dup = True
                break
        if not dup:
            out_n.append(n[i])
            out_d.append(d[i])
    return np.asarray(out_n), np.asarray(out_d)


def fit_primitive(verts: np.ndarray):
    """Fit an oriented box or capsule to a vertex cloud (PCA OBB; capsule when
    strongly elongated). Returns (kind, size, pos, quat) in mesh frame.

    Kept beside the hull as the JAX package keeps it; the narrowphase and
    the renderer use the hull.
    """
    com = verts.mean(axis=0)
    x = verts - com
    cov = x.T @ x / len(x)
    w, v = np.linalg.eigh(cov)
    order = np.argsort(w)[::-1]
    v = v[:, order]
    if np.linalg.det(v) < 0:
        v[:, 2] *= -1
    local = x @ v
    lo, hi = local.min(axis=0), local.max(axis=0)
    half = (hi - lo) / 2.0
    center_local = (hi + lo) / 2.0
    pos = com + v @ center_local
    quat = _mat2quat(v)
    if half[0] > 2.5 * half[1] and abs(half[1] - half[2]) < 0.5 * half[1]:
        # elongated + round-ish cross-section -> capsule along first axis
        radius = float((half[1] + half[2]) / 2.0)
        half_len = max(float(half[0]) - radius, 1e-4)
        # capsule axis is local z in MuJoCo: rotate so principal axis -> z
        swap = np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])  # z<-x
        quat = _mat2quat(v @ swap.T)
        return "capsule", np.array([radius, half_len, 0.0]), pos, quat
    return "box", half, pos, quat


def process_mesh(
    name: str, path: str, scale: np.ndarray | None = None, inertia_mode: str = "legacy"
) -> MeshData:
    verts, faces = load_stl(path)
    if scale is not None:
        verts = verts * scale
    if inertia_mode == "legacy":
        vol, com, inertia = legacy_mass_properties(verts, faces)
    elif inertia_mode == "convex":
        hv, hf = hull_faces(verts)
        vol, com, inertia = mass_properties(hv, hf)
    else:  # exact
        vol, com, inertia = mass_properties(verts, faces)
    if vol < 0:  # inward-wound mesh
        vol, inertia = -vol, -inertia
    hull = convex_hull(verts, max_verts=24)
    fnorm, fdist = hull_halfspaces(hull)
    kind, size, pos, quat = fit_primitive(hull)
    return MeshData(
        name=name, verts=verts, faces=faces, volume=vol, com=com,
        inertia_com=inertia, hull_verts=hull, hull_fnorm=fnorm, hull_fdist=fdist,
        fit_kind=kind, fit_size=size, fit_pos=pos, fit_quat=quat,
    )
