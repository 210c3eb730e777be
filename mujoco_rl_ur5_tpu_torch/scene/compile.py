"""Lower a parsed :class:`SceneSpec` to a :class:`Model`.

The port's copy of the JAX package's ``compile_spec`` (scene/compile.py
there), for scenes of primitive geoms:

  * bodies flattened in document (MuJoCo) order, qpos/dof addressing as
    MuJoCo's, kinematic trees with the per-tree dof layout (``dof_tree``,
    ``dof_treeidx``, ``mtdof``, ``dof_ancestors``), body levels, and the
    qpos0 rest kinematics;
  * inertials, explicit or from the geoms (``inertiafromgeom``, or a body
    without ``<inertial>``): the primitive types' mass properties at the
    geom density; ``fullinertia`` is diagonalised as MuJoCo does;
  * geoms and their collision proxies: cylinders collide as 16-gon prism
    hulls (``_cylinder_prism_hull``), built without any mesh file, in the
    padded hull tables; bounding radii for the broadphase;
  * joint limits, motors and joint equalities;
  * the static contact pairs (weld filter, contype/conaffinity, excludes,
    no plane-plane, plane/lower type first), grouped by type pair, with
    MuJoCo's mixing of the pair parameters and the per-body ancestor slots;
  * the pruning of pairs between bodies that are not free whose proxies
    already overlap at qpos0, and the qpos0 constraint-mass constants
    ``dof_invweight0``/``geom_invweight0``, both through the port's own
    batched FK, collide and dynamics on the CPU.

Mesh geoms (STL loading, scene/mesh.py) are not compiled yet and raise.
``compile_spec``/``compile_file`` give the host (numpy) model;
``load_model`` gives it on a device, the card unless the caller asks for
the CPU.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.spatial import cross
from mujoco_rl_ur5_tpu_torch.physics import dynamics
from mujoco_rl_ur5_tpu_torch.physics.collision import (
    HULL_NARROWPHASE, NARROWPHASE, pair_points,
)
from mujoco_rl_ur5_tpu_torch.physics.constraints import collide
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH,
    GEOM_PLANE, GEOM_SPHERE, JNT_BALL, JNT_DOF, JNT_FREE, JNT_HINGE, JNT_NQ,
    JNT_SLIDE, BodySpec, GeomSpec, SceneSpec, parse_mjcf, quat_mul,
)
from mujoco_rl_ur5_tpu_torch.scene.model import Model, Topology


def _quat_rot(q, v):
    w, u = q[0], q[1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _mat2quat(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-18)) * 2
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


def principal_inertia(inertia: np.ndarray):
    """Diagonalise a 3x3 inertia -> (diag (3,), quat (4,) w-first): a
    right-handed eigenbasis with eigenvalues descending; an already
    diagonal tensor keeps its axis order and the identity orientation."""
    scale = max(np.abs(inertia).max(), 1e-30)
    off = inertia - np.diag(np.diag(inertia))
    if np.abs(off).max() < 1e-9 * scale:
        return np.diag(inertia).copy(), np.array([1.0, 0, 0, 0])
    w, v = np.linalg.eigh(inertia)
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order]
    if np.linalg.det(v) < 0:
        v[:, 2] *= -1
    return w, _mat2quat(v)


def _quat_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _geom_mass_props(g: GeomSpec):
    """(mass, com, inertia about the COM in the geom frame) at the geom's
    density; planes are massless."""
    t, s, rho = g.type, g.size, g.density
    if t == GEOM_SPHERE:
        m = rho * 4.0 / 3.0 * np.pi * s[0] ** 3
        return m, np.zeros(3), 2.0 / 5.0 * m * s[0] ** 2 * np.eye(3)
    if t == GEOM_BOX:
        m = rho * 8.0 * s[0] * s[1] * s[2]
        return m, np.zeros(3), m / 3.0 * np.diag(
            [s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2,
             s[0] ** 2 + s[1] ** 2])
    if t == GEOM_ELLIPSOID:
        m = rho * 4.0 / 3.0 * np.pi * s[0] * s[1] * s[2]
        return m, np.zeros(3), m / 5.0 * np.diag(
            [s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2,
             s[0] ** 2 + s[1] ** 2])
    if t == GEOM_CYLINDER:
        r, h = s[0], s[1]
        m = rho * 2.0 * np.pi * r * r * h
        ixy = m * (3 * r * r + 4 * h * h) / 12.0
        return m, np.zeros(3), np.diag([ixy, ixy, m * r * r / 2.0])
    if t == GEOM_CAPSULE:
        r, h = s[0], s[1]
        m_cyl = rho * 2.0 * np.pi * r * r * h
        m_hs = rho * 2.0 / 3.0 * np.pi * r ** 3      # each hemisphere
        iz = m_cyl * r * r / 2.0 + 2 * m_hs * (2.0 / 5.0) * r * r
        d = h + 3.0 * r / 8.0
        ixy = (m_cyl * (3 * r * r + 4 * h * h) / 12.0
               + 2 * ((83.0 / 320.0) * m_hs * r * r + m_hs * d * d))
        return m_cyl + 2 * m_hs, np.zeros(3), np.diag([ixy, ixy, iz])
    if t == GEOM_MESH:
        raise ValueError(_mesh_error(g))
    return 0.0, np.zeros(3), np.zeros((3, 3))


def _mesh_error(g: GeomSpec) -> str:
    return (f"geom '{g.name}': mesh geoms need scene/mesh.py (STL loading, "
            "hulls and the mass properties inertiafromgeom takes from them), "
            "which the port does not compile yet")


def _body_inertial(body: BodySpec, inertiafromgeom: bool):
    """Mass, COM, principal inertia and its orientation: from <inertial>,
    or from the geoms (inertiafromgeom, or a body without <inertial>)."""
    it = body.inertial
    if not (inertiafromgeom or it is None):
        if it.diaginertia is not None:
            return it.mass, it.pos, it.diaginertia, it.quat
        f = it.fullinertia if it.fullinertia is not None else np.zeros(6)
        full = np.array([[f[0], f[3], f[4]], [f[3], f[1], f[5]],
                         [f[4], f[5], f[2]]])
        diag, q = principal_inertia(full)
        return it.mass, it.pos, diag, quat_mul(it.quat, q)
    props = [_geom_mass_props(g) for g in body.geoms]
    total = sum(m for m, _, _ in props)
    if total <= 0.0:
        return 0.0, np.zeros(3), np.zeros(3), np.array([1.0, 0, 0, 0])
    com = sum(m * (g.pos + _quat_rot(g.quat, c))
              for g, (m, c, _) in zip(body.geoms, props)) / total
    itot = np.zeros((3, 3))
    for g, (m, c, i_local) in zip(body.geoms, props):
        r = _quat_mat(g.quat)
        d = g.pos + _quat_rot(g.quat, c) - com
        itot += r @ i_local @ r.T + m * (np.dot(d, d) * np.eye(3)
                                         - np.outer(d, d))
    diag, q = principal_inertia(itot)
    return total, com, diag, q


def _cylinder_prism_hull(r: float, hl: float, nseg: int = 16):
    """Convex prism for a cylinder: 2 nseg rim vertices on the true radius,
    nseg side halfspaces at the mid-radius between inscribed and true
    (faceting error +-r (1 - cos(pi / nseg)) / 2), and the two end caps."""
    ang = np.arange(nseg) * (2 * np.pi / nseg)
    ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
    verts = np.concatenate([
        np.concatenate([ring, np.full((nseg, 1), hl)], axis=1),
        np.concatenate([ring, np.full((nseg, 1), -hl)], axis=1)])
    mid = ang + np.pi / nseg
    side_n = np.stack([np.cos(mid), np.sin(mid), np.zeros(nseg)], axis=1)
    side_d = np.full(nseg, r * (1 + np.cos(np.pi / nseg)) / 2)
    return types.SimpleNamespace(
        hull_verts=verts,
        hull_fnorm=np.concatenate([side_n, [[0.0, 0, 1.0], [0.0, 0, -1.0]]]),
        hull_fdist=np.concatenate([side_d, [hl, hl]]))


def _geom_rbounds(col_type, col_size, geom_meshid, hull_verts, hull_vmask):
    """Bounding-sphere radius per geom about its collision frame (planes
    1e10: never pruned by the broadphase)."""
    rb = np.zeros(len(col_type))
    for gi, (ty, s) in enumerate(zip(col_type, col_size)):
        if ty == GEOM_PLANE:
            rb[gi] = 1e10
        elif ty == GEOM_SPHERE:
            rb[gi] = s[0]
        elif ty == GEOM_CAPSULE:
            rb[gi] = s[0] + s[1]
        elif ty == GEOM_BOX:
            rb[gi] = float(np.linalg.norm(s))
        elif ty == GEOM_MESH:
            mid = int(geom_meshid[gi])
            vn = np.linalg.norm(hull_verts[mid], axis=1)
            rb[gi] = float((vn * hull_vmask[mid]).max())
        else:
            rb[gi] = float(np.linalg.norm(s)) + 1e-3
    return rb


def compile_spec(spec: SceneSpec, dtype=np.float32) -> Model:
    bodies: list[BodySpec] = []
    parent: list[int] = []

    def flatten(b: BodySpec, pid: int):
        bid = len(bodies)
        bodies.append(b)
        parent.append(pid)
        for c in b.bodies:
            flatten(c, bid)

    flatten(spec.worldbody, -1)
    nbody = len(bodies)
    body_names = tuple(b.name for b in bodies)

    # joints and qpos/dof addressing (document order == MuJoCo order)
    jnt_specs, jnt_body, body_jntadr, body_jntnum = [], [], [], []
    for bid, b in enumerate(bodies):
        body_jntadr.append(len(jnt_specs) if b.joints else -1)
        body_jntnum.append(len(b.joints))
        for j in b.joints:
            jnt_specs.append(j)
            jnt_body.append(bid)
    njnt = len(jnt_specs)
    jnt_type = np.array([j.type for j in jnt_specs], np.int32)
    jnt_qposadr = np.zeros(njnt, np.int32)
    jnt_dofadr = np.zeros(njnt, np.int32)
    nq = nv = 0
    for i, j in enumerate(jnt_specs):
        jnt_qposadr[i], jnt_dofadr[i] = nq, nv
        nq += JNT_NQ[j.type]
        nv += JNT_DOF[j.type]
    dof_jnt = np.concatenate(
        [np.full(JNT_DOF[j.type], i, np.int32)
         for i, j in enumerate(jnt_specs)]) if njnt else np.zeros(0, np.int32)
    dof_body = np.array([jnt_body[j] for j in dof_jnt], np.int32)

    # kinematic trees: a tree starts at a jointed child of a static body
    body_tree = np.full(nbody, -1, np.int32)
    tree_root = []
    for bid in range(1, nbody):
        pid = parent[bid]
        if body_tree[pid] >= 0:
            body_tree[bid] = body_tree[pid]
        elif body_jntnum[bid] > 0:
            body_tree[bid] = len(tree_root)
            tree_root.append(bid)
    ntree = len(tree_root)
    dof_tree = body_tree[dof_body] if nv else np.zeros(0, np.int32)
    dof_treeidx = np.zeros(nv, np.int32)
    counts = [0] * ntree
    for d in range(nv):
        dof_treeidx[d] = counts[dof_tree[d]]
        counts[dof_tree[d]] += 1
    mtdof = max(counts) if counts else 1

    # per-dof ancestor chains within the tree (self included, -1 padded)
    body_dofs: list[list[int]] = [[] for _ in range(nbody)]
    for d in range(nv):
        body_dofs[dof_body[d]].append(d)
    dof_ancestors = np.full((nv, mtdof), -1, np.int32)
    for d in range(nv):
        bid = int(dof_body[d])
        chain = [x for x in body_dofs[bid] if x <= d]
        pid = parent[bid]
        while pid >= 0 and body_tree[pid] == body_tree[bid]:
            chain.extend(body_dofs[pid])
            pid = parent[pid]
        chain = sorted(chain)
        dof_ancestors[d, : len(chain)] = chain

    # body levels (moving bodies, parent before child)
    depth = np.zeros(nbody, np.int32)
    for bid in range(1, nbody):
        depth[bid] = depth[parent[bid]] + 1
    moving = body_tree >= 0
    levels = []
    if moving.any():
        for lev in range(1, int(depth[moving].max()) + 1):
            ids = np.nonzero(moving & (depth == lev))[0].astype(np.int32)
            if ids.size:
                levels.append(ids)

    # rest kinematics at qpos0 (also the static bodies' world poses)
    qpos0 = np.zeros(nq)
    xpos0 = np.zeros((nbody, 3))
    xquat0 = np.zeros((nbody, 4))
    xquat0[:, 0] = 1.0
    for bid in range(1, nbody):
        pid = parent[bid]
        xpos0[bid] = xpos0[pid] + _quat_rot(xquat0[pid], bodies[bid].pos)
        xquat0[bid] = quat_mul(xquat0[pid], bodies[bid].quat)
    for i, j in enumerate(jnt_specs):
        qa = jnt_qposadr[i]
        if j.type == JNT_FREE:
            qpos0[qa: qa + 3] = xpos0[jnt_body[i]]
            qpos0[qa + 3: qa + 7] = xquat0[jnt_body[i]]
        elif j.type == JNT_BALL:
            qpos0[qa: qa + 4] = [1, 0, 0, 0]
        else:
            qpos0[qa] = j.ref

    # geoms and collision proxies: cylinders as prism hulls
    geom_specs, geom_body = [], []
    for bid, b in enumerate(bodies):
        for g in b.geoms:
            geom_specs.append(g)
            geom_body.append(bid)
    ngeom = len(geom_specs)
    geom_body = np.array(geom_body, np.int32)
    g_type = np.array([g.type for g in geom_specs], np.int32)
    g_size = np.array([g.size for g in geom_specs]).reshape(ngeom, 3)
    g_fric = np.array([g.friction for g in geom_specs]).reshape(ngeom, 3)
    g_solref = np.array([g.solref for g in geom_specs]).reshape(ngeom, 2)
    g_solimp = np.array([g.solimp for g in geom_specs]).reshape(ngeom, 3)
    g_margin = np.array([g.margin for g in geom_specs])
    g_condim = np.array([g.condim for g in geom_specs], np.int32)
    col_type = g_type.copy()
    hulls, cyl_hull = {}, {}
    for gi, g in enumerate(geom_specs):
        if g.type == GEOM_MESH:
            raise ValueError(_mesh_error(g))
        if g.type == GEOM_CYLINDER:
            key = (round(float(g_size[gi, 0]), 6),
                   round(float(g_size[gi, 1]), 6))
            name = f"__cylinder_{key[0]}_{key[1]}"
            if name not in hulls:
                hulls[name] = _cylinder_prism_hull(*key)
            cyl_hull[gi] = name
            col_type[gi] = GEOM_MESH
    mesh_order = sorted(hulls)
    mesh_index = {n: i for i, n in enumerate(mesh_order)}
    geom_meshid = np.full(ngeom, -1, np.int32)
    for gi, name in cyl_hull.items():
        geom_meshid[gi] = mesh_index[name]
    # padded hull tables: padded vertices masked out, padded faces at
    # offset 1e10 so they never win a signed-distance maximum
    nmesh = len(mesh_order)
    maxv = max((len(hulls[n].hull_verts) for n in mesh_order), default=1)
    maxf = max((len(hulls[n].hull_fnorm) for n in mesh_order), default=1)
    hull_verts = np.zeros((nmesh, maxv, 3))
    hull_vmask = np.zeros((nmesh, maxv))
    hull_fnorm = np.zeros((nmesh, maxf, 3))
    hull_fdist = np.full((nmesh, maxf), 1e10)
    for mi, name in enumerate(mesh_order):
        h = hulls[name]
        nv_, nf_ = len(h.hull_verts), len(h.hull_fnorm)
        hull_verts[mi, :nv_] = h.hull_verts
        hull_vmask[mi, :nv_] = 1.0
        hull_fnorm[mi, :nf_] = h.hull_fnorm
        hull_fdist[mi, :nf_] = h.hull_fdist

    body_mass = np.zeros(nbody)
    body_inertia = np.zeros((nbody, 3))
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    for bid in range(1, nbody):
        m, com, diag, q = _body_inertial(bodies[bid], spec.inertiafromgeom)
        body_mass[bid], body_ipos[bid] = m, com
        body_inertia[bid], body_iquat[bid] = diag, q

    joint_names = tuple(j.name for j in jnt_specs)
    act_jnt = np.array([joint_names.index(a.joint) for a in spec.actuators],
                       np.int32)
    nu = len(spec.actuators)
    neq = len(spec.equalities)
    eq_j1 = np.array([joint_names.index(e.joint1) for e in spec.equalities],
                     np.int32)
    eq_j2 = np.array([joint_names.index(e.joint2) for e in spec.equalities],
                     np.int32)

    # joint limits (hinge and slide joints)
    limited = [i for i, j in enumerate(jnt_specs)
               if j.limited and j.type in (JNT_HINGE, JNT_SLIDE)]
    nlimit = len(limited)
    limit_dof = jnt_dofadr[limited].astype(np.int32)
    limit_qadr = jnt_qposadr[limited].astype(np.int32)

    # static contact pairs. Weld groups (MuJoCo's filter): a body without
    # joints is welded to its parent; pairs inside a weld, and between a
    # weld and its parent weld (unless that is the world), are excluded
    weldid = np.zeros(nbody, np.int32)
    for bid in range(1, nbody):
        weldid[bid] = bid if body_jntnum[bid] > 0 else weldid[parent[bid]]
    excl = set()
    for b1, b2 in spec.excludes:
        i1, i2 = body_names.index(b1), body_names.index(b2)
        excl.add((min(i1, i2), max(i1, i2)))
    pair1, pair2 = [], []
    for gi in range(ngeom):
        for gj in range(gi + 1, ngeom):
            b1, b2 = int(geom_body[gi]), int(geom_body[gj])
            w1, w2 = int(weldid[b1]), int(weldid[b2])
            if w1 == w2:
                continue
            g1, g2 = geom_specs[gi], geom_specs[gj]
            if not ((g1.contype & g2.conaffinity)
                    or (g2.contype & g1.conaffinity)):
                continue
            if (min(b1, b2), max(b1, b2)) in excl:
                continue
            pw1 = int(weldid[parent[w1]]) if w1 > 0 else -1
            pw2 = int(weldid[parent[w2]]) if w2 > 0 else -1
            if (pw1 == w2 and w2 != 0) or (pw2 == w1 and w1 != 0):
                continue
            if col_type[gi] == GEOM_PLANE and col_type[gj] == GEOM_PLANE:
                continue
            if col_type[gi] <= col_type[gj]:
                pair1.append(gi)
                pair2.append(gj)
            else:
                pair1.append(gj)
                pair2.append(gi)
    pair_geom1 = np.array(pair1, np.int32)
    pair_geom2 = np.array(pair2, np.int32)
    groups = {}
    for pidx in range(len(pair_geom1)):
        key = (int(col_type[pair_geom1[pidx]]),
               int(col_type[pair_geom2[pidx]]))
        if key in NARROWPHASE or key in HULL_NARROWPHASE:
            groups.setdefault(key, []).append(pidx)
    pair_groups = tuple((k[0], k[1], np.array(v, np.int32))
                        for k, v in sorted(groups.items()))
    # MuJoCo's mixing with equal solmix: solref and solimp averaged,
    # friction, margin and condim the larger
    p1g, p2g = pair_geom1, pair_geom2
    pair_friction = np.maximum(g_fric[p1g], g_fric[p2g])
    pair_solref = 0.5 * (g_solref[p1g] + g_solref[p2g])
    pair_solimp = 0.5 * (g_solimp[p1g] + g_solimp[p2g])
    pair_margin = np.maximum(g_margin[p1g], g_margin[p2g])
    pair_condim = np.maximum(g_condim[p1g], g_condim[p2g]).astype(np.int32)

    # which tree slots move each body
    body_ancestor_slots = np.zeros((nbody, mtdof), dtype=bool)
    for bid in range(nbody):
        cur = bid
        while body_tree[bid] >= 0 and cur >= 0 \
                and body_tree[cur] == body_tree[bid]:
            for d in body_dofs[cur]:
                body_ancestor_slots[bid, dof_treeidx[d]] = True
            cur = parent[cur]

    topo = Topology(
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, ngeom=ngeom, neq=neq,
        nlimit=nlimit, ntree=ntree, mtdof=mtdof,
        timestep=spec.option.timestep, gravity=tuple(spec.option.gravity),
        iterations=spec.option.iterations, impratio=spec.option.impratio,
        body_parent=np.array(parent, np.int32),
        body_jntadr=np.array(body_jntadr, np.int32),
        body_jntnum=np.array(body_jntnum, np.int32),
        body_levels=tuple(levels), body_tree=body_tree,
        tree_rootbody=np.array(tree_root, np.int32),
        jnt_type=jnt_type, jnt_body=np.array(jnt_body, np.int32),
        jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
        dof_jnt=dof_jnt, dof_body=dof_body, dof_tree=dof_tree,
        dof_treeidx=dof_treeidx, dof_ancestors=dof_ancestors,
        geom_body=geom_body, geom_type=g_type, geom_meshid=geom_meshid,
        nmesh=nmesh, hull_maxv=maxv, hull_maxf=maxf,
        act_dofadr=jnt_dofadr[act_jnt] if nu else np.zeros(0, np.int32),
        act_jnt=act_jnt,
        eq_j1_dof=jnt_dofadr[eq_j1] if neq else np.zeros(0, np.int32),
        eq_j2_dof=jnt_dofadr[eq_j2] if neq else np.zeros(0, np.int32),
        eq_j1_qadr=jnt_qposadr[eq_j1] if neq else np.zeros(0, np.int32),
        eq_j2_qadr=jnt_qposadr[eq_j2] if neq else np.zeros(0, np.int32),
        limit_dof=limit_dof, limit_qadr=limit_qadr,
        pair_geom1=pair_geom1, pair_geom2=pair_geom2,
        pair_groups=pair_groups, pair_condim=pair_condim,
        ncand=sum(pair_points(a, b) * len(v) for a, b, v in pair_groups),
        body_ancestor_slots=body_ancestor_slots,
        xpos0=xpos0, xquat0=xquat0, body_names=body_names,
        joint_names=joint_names,
        geom_names=tuple(g.name for g in geom_specs))

    def arr(x, shape):
        return np.asarray(x, dtype).reshape(shape)

    nlim2 = (nlimit, 2)
    model = Model(
        topo=topo,
        qpos0=arr(qpos0, (nq,)),
        body_pos=arr([b.pos for b in bodies], (nbody, 3)),
        body_quat=arr([b.quat for b in bodies], (nbody, 4)),
        body_mass=arr(body_mass, (nbody,)),
        body_inertia=arr(body_inertia, (nbody, 3)),
        body_ipos=arr(body_ipos, (nbody, 3)),
        body_iquat=arr(body_iquat, (nbody, 4)),
        jnt_pos=arr([j.pos for j in jnt_specs], (njnt, 3)),
        jnt_axis=arr([j.axis for j in jnt_specs], (njnt, 3)),
        jnt_range=arr([j.range for j in jnt_specs], (njnt, 2)),
        jnt_ref=arr([j.ref for j in jnt_specs], (njnt,)),
        dof_damping=arr([jnt_specs[j].damping for j in dof_jnt], (nv,)),
        dof_armature=arr([jnt_specs[j].armature for j in dof_jnt], (nv,)),
        geom_pos=arr([g.pos for g in geom_specs], (ngeom, 3)),
        geom_quat=arr([g.quat for g in geom_specs], (ngeom, 4)),
        geom_size=arr(g_size, (ngeom, 3)),
        geom_rbound=arr(_geom_rbounds(col_type, g_size, geom_meshid,
                                      hull_verts, hull_vmask), (ngeom,)),
        geom_friction=arr(g_fric, (ngeom, 3)),
        geom_margin=arr(g_margin, (ngeom,)),
        geom_solref=arr(g_solref, (ngeom, 2)),
        geom_solimp=arr(g_solimp, (ngeom, 3)),
        geom_condim=g_condim,
        col_type=col_type,
        col_size=arr(g_size, (ngeom, 3)),
        col_pos=arr(np.zeros((ngeom, 3)), (ngeom, 3)),
        col_quat=arr(np.tile([1.0, 0, 0, 0], (ngeom, 1)), (ngeom, 4)),
        hull_verts=arr(hull_verts, hull_verts.shape),
        hull_vmask=arr(hull_vmask, hull_vmask.shape),
        hull_fnorm=arr(hull_fnorm, hull_fnorm.shape),
        hull_fdist=arr(hull_fdist, hull_fdist.shape),
        act_gear=arr([a.gear for a in spec.actuators], (nu,)),
        act_ctrlrange=arr([a.ctrlrange for a in spec.actuators], (nu, 2)),
        eq_poly=arr([e.polycoef for e in spec.equalities], (neq, 5)),
        eq_solref=arr([e.solref for e in spec.equalities], (neq, 2)),
        eq_solimp=arr([e.solimp for e in spec.equalities], (neq, 3)),
        limit_range=arr([jnt_specs[i].range for i in limited], nlim2),
        limit_solref=arr([[0.02, 1.0]] * nlimit, nlim2),
        limit_solimp=arr([[0.9, 0.95, 0.001]] * nlimit, (nlimit, 3)),
        pair_friction=arr(pair_friction, (len(p1g), 3)),
        pair_solref=arr(pair_solref, (len(p1g), 2)),
        pair_solimp=arr(pair_solimp, (len(p1g), 3)),
        pair_margin=arr(pair_margin, (len(p1g),)),
    )
    model = _prune_rest_penetrating_pairs(model)
    return _compute_invweight0(model)


def _compute_invweight0(model: Model) -> Model:
    """MuJoCo's mj_setConst constants at qpos0: dof_invweight0 =
    diag(M^-1), and each geom's body translational invweight
    trace(J_com M^-1 J_com^T) / 3 (the Jacobian at the body COM). The
    constraint solver's R is built from these."""
    t = model.topo
    m = model.to("cpu")
    with torch.no_grad():
        kin = fk(m, m.qpos0[None])
        crb = dynamics.composite_inertia(m, dynamics.com_inertia(m, kin))
        minv = dynamics.inv_blocks(dynamics.mass_blocks(m, kin, crb))[0]
        dof_tree, dof_idx = t.dof_tree, t.dof_treeidx
        dof_iw = minv[dof_tree, dof_idx, dof_idx]
        mt = t.mtdof
        cdof_tree = kin.cdof.new_zeros(t.ntree, mt, 6)
        cdof_tree[dof_tree, dof_idx] = kin.cdof[0]
        bt = np.where(t.body_tree >= 0, t.body_tree, 0)
        cd = cdof_tree[bt]                                  # (nbody, mt, 6)
        slots = torch.as_tensor(t.body_ancestor_slots, dtype=cd.dtype)
        ang, lin = cd[..., :3], cd[..., 3:]
        lever = kin.xipos[0] - kin.tree_org[0][bt]
        Jlin = (lin + cross(ang, lever[:, None, :])) * slots[..., None]
        A = torch.einsum("bmd,bmn,bnd->b", Jlin, minv[bt], Jlin) / 3.0
        body_iw = torch.where(torch.as_tensor(t.body_tree >= 0), A, 0.0)
    model.dof_invweight0 = dof_iw.numpy().astype(model.qpos0.dtype)
    model.geom_invweight0 = body_iw.numpy()[t.geom_body].astype(
        model.qpos0.dtype)
    return model


def _prune_rest_penetrating_pairs(model: Model) -> Model:
    """Drop the pairs between bodies that are not free whose collision
    proxies already overlap at qpos0 (dist < margin / 2): such a pair would
    press phantom friction into the arm for ever. Pairs with a free-jointed
    object are kept (objects may spawn overlapping)."""
    t = model.topo
    if len(t.pair_geom1) == 0:
        return model
    m = model.to("cpu")
    with torch.no_grad():
        _, _, dist, cand_pair = collide(m, fk(m, m.qpos0[None]))
    dist, cand_pair = dist[0].numpy(), cand_pair[0].numpy()
    tree_has_free = np.zeros(t.ntree + 1, dtype=bool)
    for j in range(t.njnt):
        if t.jnt_type[j] == JNT_FREE and t.body_tree[t.jnt_body[j]] >= 0:
            tree_has_free[t.body_tree[t.jnt_body[j]]] = True
    bt = np.where(t.body_tree >= 0, t.body_tree, t.ntree)
    g_free = tree_has_free[bt[t.geom_body]]
    keepable = ~(g_free[t.pair_geom1[cand_pair]]
                 | g_free[t.pair_geom2[cand_pair]])
    bad = keepable & (dist < 0.5 * model.pair_margin[cand_pair])
    bad_pair = np.zeros(len(t.pair_geom1), dtype=bool)
    bad_pair[cand_pair[bad]] = True
    if not bad_pair.any():
        return model
    kidx = np.nonzero(~bad_pair)[0]
    remap = np.full(len(bad_pair), -1, np.int64)
    remap[kidx] = np.arange(len(kidx))
    t.pair_geom1, t.pair_geom2 = t.pair_geom1[kidx], t.pair_geom2[kidx]
    t.pair_condim = t.pair_condim[kidx]
    groups = []
    for (a, b, idx) in t.pair_groups:
        nidx = remap[idx]
        nidx = nidx[nidx >= 0].astype(np.int32)
        if len(nidx):
            groups.append((a, b, nidx))
    t.pair_groups = tuple(groups)
    t.ncand = sum(pair_points(a, b) * len(idx) for a, b, idx in groups)
    for f in ("pair_friction", "pair_solref", "pair_solimp", "pair_margin"):
        setattr(model, f, getattr(model, f)[kidx])
    return model


def compile_file(path: str, dtype=np.float32) -> Model:
    """Parse and compile an MJCF file: the host (numpy) model."""
    return compile_spec(parse_mjcf(path), dtype=dtype)


def load_model(path: str, dtype=np.float32, device="cuda") -> Model:
    """Parse and compile an MJCF file onto ``device``: the card by default
    (raises without one); the CPU only when the caller asks for it."""
    return compile_file(path, dtype=dtype).to(device)
