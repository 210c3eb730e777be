"""Lower a parsed :class:`SceneSpec` to a :class:`Model` (host, numpy).

The subset of the JAX package's ``compile_spec`` the arm planner needs:
body flattening in document (MuJoCo) order and kinematic trees, qpos/dof
addressing identical to MuJoCo's, the qpos0 rest kinematics (``qpos0``,
``xpos0``, ``xquat0``), explicit body inertials (``fullinertia`` is
diagonalised as MuJoCo does), joint damping and armature, motors and joint
equalities. Inertials derived from geoms (``inertiafromgeom="true"``, or a
body without ``<inertial>``), meshes and contact tables belong to the
contact-step slice and raise here.
"""

from __future__ import annotations

import numpy as np

from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    JNT_BALL, JNT_DOF, JNT_FREE, JNT_NQ, BodySpec, SceneSpec, parse_mjcf,
    quat_mul,
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


def _body_inertial(body: BodySpec, inertiafromgeom: bool):
    """Mass, COM, principal inertia and its orientation from <inertial>."""
    if inertiafromgeom:
        raise ValueError(
            'inertiafromgeom="true" needs geom mass properties, which the '
            'port does not compile yet: give every body an explicit '
            '<inertial> and set <compiler inertiafromgeom="false"/>')
    it = body.inertial
    if it is None:
        raise ValueError(f"body '{body.name}' has no <inertial>; geom mass "
                         "properties are not compiled by the port yet")
    if it.diaginertia is not None:
        return it.mass, it.pos, it.diaginertia, it.quat
    f = it.fullinertia if it.fullinertia is not None else np.zeros(6)
    full = np.array([[f[0], f[3], f[4]], [f[3], f[1], f[5]],
                     [f[4], f[5], f[2]]])
    diag, q = principal_inertia(full)
    return it.mass, it.pos, diag, quat_mul(it.quat, q)


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

    # joints and qpos/dof addressing (document order == MuJoCo order)
    jnt_specs, jnt_body, body_jntnum = [], [], []
    for bid, b in enumerate(bodies):
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

    dof_damping = np.array([jnt_specs[j].damping for j in dof_jnt])
    dof_armature = np.array([jnt_specs[j].armature for j in dof_jnt])

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

    topo = Topology(
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, neq=neq,
        ntree=len(tree_root), timestep=spec.timestep,
        gravity=tuple(spec.gravity),
        body_parent=np.array(parent, np.int32),
        body_jntnum=np.array(body_jntnum, np.int32),
        body_tree=body_tree, tree_rootbody=np.array(tree_root, np.int32),
        jnt_type=jnt_type, jnt_body=np.array(jnt_body, np.int32),
        jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
        act_dofadr=jnt_dofadr[act_jnt] if nu else np.zeros(0, np.int32),
        act_jnt=act_jnt,
        eq_j1_dof=jnt_dofadr[eq_j1] if neq else np.zeros(0, np.int32),
        eq_j2_dof=jnt_dofadr[eq_j2] if neq else np.zeros(0, np.int32),
        eq_j1_qadr=jnt_qposadr[eq_j1] if neq else np.zeros(0, np.int32),
        eq_j2_qadr=jnt_qposadr[eq_j2] if neq else np.zeros(0, np.int32),
        xpos0=xpos0, xquat0=xquat0,
        body_names=tuple(b.name for b in bodies), joint_names=joint_names,
    )

    def arr(x, shape):
        return np.asarray(x, dtype).reshape(shape)

    return Model(
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
        jnt_ref=arr([j.ref for j in jnt_specs], (njnt,)),
        dof_damping=arr(dof_damping, (nv,)),
        dof_armature=arr(dof_armature, (nv,)),
        act_gear=arr([a.gear for a in spec.actuators], (nu,)),
        act_ctrlrange=arr([a.ctrlrange for a in spec.actuators], (nu, 2)),
        eq_poly=arr([e.polycoef for e in spec.equalities], (neq, 5)),
        eq_solref=arr([e.solref for e in spec.equalities], (neq, 2)),
        eq_solimp=arr([e.solimp for e in spec.equalities], (neq, 3)),
    )


def load_model(path: str, dtype=np.float32) -> Model:
    """Parse and compile an MJCF file (the full scene, free bodies too)."""
    return compile_spec(parse_mjcf(path), dtype=dtype)
