"""Specialized all-hinge chain dynamics for the MPC hot path, in torch.

The planning model is a fixed-base arm and gripper tree of a few hinge dofs
(scene/reduce.py). Its dynamics (MuJoCo-convention CRBA + RNE, implicit
joint damping, semi-implicit Euler, and the finger-coupling equality as an
implicit spring) are re-expressed for a static chain:

  * :class:`ChainPlan` bakes the topology (parent slots, ancestor and
    subtree masks) and the model constants into numpy arrays, so the
    kinematic recursion unrolls over the moving bodies;
  * ``chain_fk``, ``chain_mass_bias``, ``chain_hold_ctrl`` and
    ``chain_step`` are the plain torch functions over any leading batch
    dims. They are the reference for the generated substep in
    physics/cuda_chain.py, which emits the same physics as straight-line
    code with the constants folded;
  * ``chain_body_pos``, ``chain_body_xaxis`` and ``chain_ee_geom`` give one
    body frame's world position, X axis and their geometric Jacobians (the
    reach costs of mpc/grasp_mpc.py).

Every function is free of in-place writes and data-dependent branches, so
``torch.func`` transforms (``vmap``, ``jacfwd``) pass through them.

The port's counterpart of the JAX package's physics/chain.py; the plan's
fields and their meaning are identical (mujoco_rl_ur5_tpu_torch/carry.py
builds one from the JAX plan's arrays).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.blockchol import solve_spd_scaled
from mujoco_rl_ur5_tpu_torch.ops.consts import const
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_HINGE
from mujoco_rl_ur5_tpu_torch.scene.model import Model


@dataclass(eq=False)
class ChainPlan:
    """Static unrolled-chain schedule + baked numeric constants (numpy)."""

    nv: int
    nu: int
    nmov: int
    body_ids: np.ndarray        # (nmov,) compiled-model body id per slot
    parent_slot: np.ndarray     # (nmov,) parent slot, -1 = static parent
    parent_pose: np.ndarray     # (nmov, 3+9) static-parent world pos+rot
    body_pos: np.ndarray        # (nmov, 3) frame offset in parent
    body_rot: np.ndarray        # (nmov, 3, 3)
    jnt_dof: np.ndarray         # (nmov,) dof index of this body's hinge, -1
    jnt_pos: np.ndarray         # (nmov, 3) local joint anchor
    jnt_axis: np.ndarray        # (nmov, 3) local joint axis (unit)
    jnt_ref: np.ndarray         # (nmov,)
    dof_slot: np.ndarray        # (nv,) body slot per dof
    dof_parent_slot: np.ndarray  # (nv,) parent slot of the dof's body
    qadr: np.ndarray            # (nv,) qpos address per dof
    ipos: np.ndarray            # (nmov, 3)
    irot: np.ndarray            # (nmov, 3, 3) principal-axes rotation
    idiag: np.ndarray           # (nmov, 3)
    mass: np.ndarray            # (nmov,)
    damping: np.ndarray         # (nv,)
    armature: np.ndarray        # (nv,)
    act_dof: np.ndarray         # (nu,)
    gear: np.ndarray            # (nu,)
    ctrlrange: np.ndarray       # (nu, 2)
    org: np.ndarray             # (3,) spatial origin (root body rest pos)
    sub_body: np.ndarray        # (nmov, nmov) 1.0: col-body in subtree of row
    anc_dof: np.ndarray         # (nmov, nv) 1.0: dof moves this body
    dof_sub_body: np.ndarray    # (nv, nmov) 1.0: body in subtree of dof's body
    m_mask: np.ndarray          # (nv, nv) 1.0: dof j ancestor-or-self of dof i
    act_mat: np.ndarray         # (nv, nu) scatter matrix dofs<-actuators
    timestep: float
    gravity: np.ndarray         # (3,)
    # joint-coupling equalities as implicit springs: dof pairs, rest
    # offsets, polycoef, and (stiffness, damping) from solref and the
    # effective inertia
    eq_d1: np.ndarray = None    # (neq,) constrained dof
    eq_d2: np.ndarray = None    # (neq,) driving dof
    eq_q01: np.ndarray = None   # (neq,) qpos0 of d1's joint
    eq_q02: np.ndarray = None   # (neq,)
    eq_poly: np.ndarray = None  # (neq, 5)
    eq_kc: np.ndarray = None    # (neq, 2) [k (N m/rad), c (N m s/rad)]


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def make_chain_plan(model: Model) -> ChainPlan:
    """Build the static plan; raises ValueError for non-chain models (any
    non-hinge joint, or more than one joint on a body).

    The joint-coupling equalities (the finger coupling base_to_rik =
    base_to_lik) are baked as near-rigid implicit springs,
    sized from solref and the joints' effective inertia at qpos0: MuJoCo's
    soft constraint at impedance dmax, k = g / (dmax tc)^2 and
    c = 2 g dampratio / (dmax tc) with g = m_eff dmax / (1 - dmax)."""
    t = model.topo
    if t.njnt == 0 or np.any(t.jnt_type != JNT_HINGE):
        raise ValueError("chain dynamics requires an all-hinge model")
    if np.any(t.body_jntnum > 1):
        raise ValueError("chain dynamics requires <= 1 joint per body")

    mov = np.array(sorted(np.nonzero(t.body_tree >= 0)[0]))
    slot_of = {int(b): i for i, b in enumerate(mov)}
    nmov, nv, nu = len(mov), t.nv, t.nu

    def f64(a):
        return np.asarray(a, np.float64)

    body_pos = f64(model.body_pos)[mov]
    body_rot = np.stack([quat_to_mat(q) for q in f64(model.body_quat)[mov]])
    parent_slot = np.full(nmov, -1, np.int64)
    parent_pose = np.zeros((nmov, 12))
    for i, b in enumerate(mov):
        p = int(t.body_parent[b])
        if p in slot_of:
            parent_slot[i] = slot_of[p]
        else:
            parent_pose[i, :3] = t.xpos0[p]
            parent_pose[i, 3:] = quat_to_mat(t.xquat0[p]).reshape(-1)

    jnt_dof = np.full(nmov, -1, np.int64)
    jnt_pos = np.zeros((nmov, 3))
    jnt_axis = np.zeros((nmov, 3))
    jnt_ref = np.zeros(nmov)
    dof_slot = np.zeros(nv, np.int64)
    dof_parent_slot = np.zeros(nv, np.int64)
    for j in range(t.njnt):
        s = slot_of[int(t.jnt_body[j])]
        d = int(t.jnt_dofadr[j])
        jnt_dof[s] = d
        jnt_pos[s] = f64(model.jnt_pos)[j]
        jnt_axis[s] = f64(model.jnt_axis)[j]
        jnt_ref[s] = float(model.jnt_ref[j])
        dof_slot[d] = s
        dof_parent_slot[d] = parent_slot[s]

    anc = np.zeros((nmov, nmov), bool)   # anc[s, a]: a is ancestor-or-self
    for i in range(nmov):
        s = i
        while s >= 0:
            anc[i, s] = True
            s = int(parent_slot[s])
    sub_body = anc.T.astype(np.float64)
    anc_dof = anc[:, dof_slot].astype(np.float64)
    dof_sub_body = sub_body[dof_slot]
    m_mask = anc[dof_slot][:, dof_slot].astype(np.float64)
    act_mat = np.zeros((nv, nu))
    act_mat[np.asarray(t.act_dofadr), np.arange(nu)] = 1.0

    # chain_step integrates qpos += h qvel as a full-vector add, which needs
    # qpos and dof addresses to coincide (all-hinge models guarantee it)
    qadr = np.asarray(t.jnt_qposadr)[np.argsort(t.jnt_dofadr)]
    assert np.array_equal(qadr, np.arange(nv)), \
        "chain plan requires qpos addresses == dof addresses (all-hinge)"

    root = int(t.tree_rootbody[0])
    plan = ChainPlan(
        nv=nv, nu=nu, nmov=nmov, body_ids=mov, parent_slot=parent_slot,
        parent_pose=parent_pose, body_pos=body_pos, body_rot=body_rot,
        jnt_dof=jnt_dof, jnt_pos=jnt_pos, jnt_axis=jnt_axis, jnt_ref=jnt_ref,
        dof_slot=dof_slot, dof_parent_slot=dof_parent_slot, qadr=qadr,
        ipos=f64(model.body_ipos)[mov],
        irot=np.stack([quat_to_mat(q) for q in f64(model.body_iquat)[mov]]),
        idiag=f64(model.body_inertia)[mov], mass=f64(model.body_mass)[mov],
        damping=f64(model.dof_damping), armature=f64(model.dof_armature),
        act_dof=np.asarray(t.act_dofadr), gear=f64(model.act_gear),
        ctrlrange=f64(model.act_ctrlrange), org=np.array(t.xpos0[root]),
        sub_body=sub_body, anc_dof=anc_dof, dof_sub_body=dof_sub_body,
        m_mask=m_mask, act_mat=act_mat, timestep=float(t.timestep),
        gravity=np.asarray(t.gravity, np.float64),
        eq_d1=np.zeros(0, np.int64), eq_d2=np.zeros(0, np.int64),
        eq_q01=np.zeros(0), eq_q02=np.zeros(0),
        eq_poly=np.zeros((0, 5)), eq_kc=np.zeros((0, 2)),
    )
    if t.neq:
        q0 = torch.as_tensor(f64(model.qpos0))
        M0, _ = chain_mass_bias(plan, q0, torch.zeros_like(q0))
        M0 = M0.numpy()
        solref, solimp = f64(model.eq_solref), f64(model.eq_solimp)
        poly = f64(model.eq_poly)
        d1 = np.asarray(t.eq_j1_dof, np.int64)
        d2 = np.asarray(t.eq_j2_dof, np.int64)
        kc = np.zeros((t.neq, 2))
        for e in range(t.neq):
            dp = poly[e, 1]              # dpoly at rest (x2 = 0)
            m_eff = 1.0 / (1.0 / M0[d1[e], d1[e]]
                           + dp * dp / M0[d2[e], d2[e]])
            tc, damp = float(solref[e, 0]), float(solref[e, 1])
            dmax = float(solimp[e, 1])
            gain = m_eff * dmax / (1.0 - dmax)
            kc[e, 0] = gain / (dmax * dmax * tc * tc)
            kc[e, 1] = gain * 2.0 * damp / (dmax * tc)
        plan.eq_d1, plan.eq_d2 = d1, d2
        plan.eq_q01 = f64(model.qpos0)[np.asarray(t.eq_j1_qadr)]
        plan.eq_q02 = f64(model.qpos0)[np.asarray(t.eq_j2_qadr)]
        plan.eq_poly, plan.eq_kc = poly, kc
    return plan


def chain_fk(plan: ChainPlan, qpos: torch.Tensor):
    """Unrolled FK over leading batch dims: qpos (..., nv) -> (xpos
    (..., nmov, 3), xrot (..., nmov, 3, 3), anchor (..., nv, 3), axis_w
    (..., nv, 3))."""
    xpos, xrot = [], []
    anchor = [None] * plan.nv
    axis_w = [None] * plan.nv
    batch = qpos.shape[:-1]
    for i in range(plan.nmov):
        ps = int(plan.parent_slot[i])
        if ps >= 0:
            pr = xrot[ps]
            p_pre = xpos[ps] + pr @ const(plan.body_pos[i], qpos)
            r_pre = pr @ const(plan.body_rot[i], qpos)
        else:
            pr0 = plan.parent_pose[i, 3:].reshape(3, 3)
            p_pre = const(plan.parent_pose[i, :3] + pr0 @ plan.body_pos[i],
                           qpos).expand(*batch, 3)
            r_pre = const(pr0 @ plan.body_rot[i], qpos).expand(*batch, 3, 3)
        d = int(plan.jnt_dof[i])
        if d >= 0:
            # (a tensor, not a float: see chain_step on torch.func.jvp)
            th = qpos[..., int(plan.qadr[d])] - const(plan.jnt_ref[i], qpos)
            ax = plan.jnt_axis[i]
            K = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                          [-ax[1], ax[0], 0.0]])
            aa = np.outer(ax, ax)
            rj = (torch.cos(th)[..., None, None] * const(np.eye(3) - aa, qpos)
                  + torch.sin(th)[..., None, None] * const(K, qpos)
                  + const(aa, qpos))
            jp = const(plan.jnt_pos[i], qpos)
            anchor[d] = p_pre + r_pre @ jp
            p = p_pre + (r_pre @ (jp - rj @ jp)[..., None])[..., 0]
            r = r_pre @ rj
            axis_w[d] = r @ const(ax, qpos)
        else:
            p, r = p_pre, r_pre
        xpos.append(p)
        xrot.append(r)
    return (torch.stack(xpos, -2), torch.stack(xrot, -3),
            torch.stack(anchor, -2), torch.stack(axis_w, -2))


def body_slot(plan: ChainPlan, body_id: int) -> int:
    """The plan's slot of a compiled-model body id."""
    return int(np.nonzero(plan.body_ids == body_id)[0][0])


def chain_body_pos(plan: ChainPlan, qpos: torch.Tensor,
                   body_id: int) -> torch.Tensor:
    """World position (..., 3) of one body frame (e.g. ee_link)."""
    return chain_fk(plan, qpos)[0][..., body_slot(plan, body_id), :]


def chain_body_xaxis(plan: ChainPlan, qpos: torch.Tensor,
                     body_id: int) -> torch.Tensor:
    """World direction (..., 3) of one body frame's X axis; for ee_link the
    gripper approach axis."""
    return chain_fk(plan, qpos)[1][..., body_slot(plan, body_id), :, 0]


def chain_ee_geom(plan: ChainPlan, qpos: torch.Tensor, body_id: int):
    """Position, frame X axis and their geometric Jacobians from one FK
    pass: J_pos[:, d] = z_d x (p - anchor_d), J_axis[:, d] = z_d x xaxis for
    the dofs d that move the body (zero otherwise). Equal to the autodiff
    Jacobians of chain_body_pos / chain_body_xaxis.

    Returns (p (..., 3), xaxis (..., 3), J_pos (..., 3, nv),
    J_axis (..., 3, nv))."""
    slot = body_slot(plan, body_id)
    xpos, xrot, anchor, ax = chain_fk(plan, qpos)
    p = xpos[..., slot, :]
    xa = xrot[..., slot, :, 0]
    mask = const(plan.anc_dof[slot], qpos)[:, None]           # (nv, 1)
    Jp = torch.cross(ax, p[..., None, :] - anchor, dim=-1) * mask
    Ja = torch.cross(ax, xa[..., None, :].expand_as(ax), dim=-1) * mask
    return p, xa, Jp.transpose(-1, -2), Ja.transpose(-1, -2)


def _imul(inert: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """10-parameter spatial inertia (..., 10) times motion (..., 6)."""
    m, h = inert[..., 0:1], inert[..., 1:4]
    w, vl = v[..., :3], v[..., 3:]
    i = inert
    iw = torch.stack([
        i[..., 4] * w[..., 0] + i[..., 7] * w[..., 1] + i[..., 8] * w[..., 2],
        i[..., 7] * w[..., 0] + i[..., 5] * w[..., 1] + i[..., 9] * w[..., 2],
        i[..., 8] * w[..., 0] + i[..., 9] * w[..., 1] + i[..., 6] * w[..., 2],
    ], -1)
    return torch.cat([iw + torch.cross(h, vl, dim=-1),
                      m * vl - torch.cross(h, w, dim=-1)], -1)


def chain_mass_bias(plan: ChainPlan, qpos: torch.Tensor, qvel: torch.Tensor):
    """(M (..., nv, nv) incl. armature, qfrc_bias (..., nv)): CRBA and RNE
    at qacc = 0 over the baked topology masks."""
    xpos, xrot, anchor, ax = chain_fk(plan, qpos)
    org = const(plan.org, qpos)
    cdof = torch.cat([ax, torch.cross(anchor - org, ax, dim=-1)], -1)
    ri = xrot @ const(plan.irot, qpos)
    icom = (ri * const(plan.idiag, qpos)[:, None, :]) @ ri.transpose(-1, -2)
    com = xpos + (xrot @ const(plan.ipos, qpos)[..., None])[..., 0]
    c = com - org
    mass = const(plan.mass, qpos)
    cc = c[..., :, None] * c[..., None, :]
    c2 = (c * c).sum(-1)[..., None, None]
    iorg = icom + mass[:, None, None] * (c2 * const(np.eye(3), qpos) - cc)
    cinert = torch.cat([
        mass.expand(c.shape[:-1])[..., None], mass[:, None] * c,
        iorg[..., 0, 0, None], iorg[..., 1, 1, None], iorg[..., 2, 2, None],
        iorg[..., 0, 1, None], iorg[..., 0, 2, None], iorg[..., 1, 2, None],
    ], -1)                                                  # (..., nmov, 10)

    crb = const(plan.sub_body, qpos) @ cinert
    fmom = _imul(crb[..., plan.dof_slot, :], cdof)
    mlow = const(plan.m_mask, qpos) * (fmom @ cdof.transpose(-1, -2))
    M = (mlow + mlow.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(mlow, dim1=-2, dim2=-1))
        + torch.diag(const(plan.armature, qpos)))

    vbody = const(plan.anc_dof, qpos) @ (cdof * qvel[..., None])
    zero6 = torch.zeros_like(vbody[..., 0, :])
    parent_v = torch.stack([vbody[..., int(s), :] if s >= 0 else zero6
                            for s in plan.dof_parent_slot], -2)
    cross = torch.cross
    cdofdot = torch.cat([
        cross(parent_v[..., :3], cdof[..., :3], dim=-1),
        cross(parent_v[..., :3], cdof[..., 3:], dim=-1)
        + cross(parent_v[..., 3:], cdof[..., :3], dim=-1)], -1)
    a0 = torch.cat([torch.zeros(3, dtype=qpos.dtype, device=qpos.device),
                    -const(plan.gravity, qpos)])
    abody = a0 + const(plan.anc_dof, qpos) @ (cdofdot * qvel[..., None])
    iv = _imul(cinert, vbody)
    fb = _imul(cinert, abody) + torch.cat([
        cross(vbody[..., :3], iv[..., :3], dim=-1)
        + cross(vbody[..., 3:], iv[..., 3:], dim=-1),
        cross(vbody[..., :3], iv[..., 3:], dim=-1)], -1)
    fsub = const(plan.dof_sub_body, qpos) @ fb
    return M, (cdof * fsub).sum(-1)


def chain_hold_ctrl(plan: ChainPlan, qpos: torch.Tensor) -> torch.Tensor:
    """Gravity-compensation controls (the iLQR warm start): bias / gear,
    clipped to the actuator range."""
    _, bias = chain_mass_bias(plan, qpos, torch.zeros_like(qpos))
    u = bias[..., plan.act_dof] / const(plan.gear, qpos)
    return torch.clamp(u, const(plan.ctrlrange[:, 0], qpos),
                       const(plan.ctrlrange[:, 1], qpos))


def chain_step(plan: ChainPlan, qpos: torch.Tensor, qvel: torch.Tensor,
               ctrl: torch.Tensor):
    """One semi-implicit Euler step with implicit joint damping and the
    implicit equality springs: (qpos, qvel, ctrl) over leading batch dims
    -> (qpos2, qvel2)."""
    h = plan.timestep
    M, bias = chain_mass_bias(plan, qpos, qvel)
    c = torch.clamp(ctrl, const(plan.ctrlrange[:, 0], qpos),
                    const(plan.ctrlrange[:, 1], qpos))
    tau = (c * const(plan.gear, qpos)) @ const(plan.act_mat, qpos).T
    damp = const(plan.damping, qpos)
    qfrc = tau - bias - damp * qvel
    a = M + h * torch.diag(damp)
    # equality springs: residual r = dq1 - poly(dq2), force -(k r +
    # (h k + c_d) rdot) along G = e_d1 - dpoly e_d2; the velocity term goes
    # implicit like the joint damping. Model constants enter as tensors,
    # not Python floats: torch.func.jvp gives a 0-dim tensor combined with a
    # Python float a float64 tangent
    for e in range(len(plan.eq_d1)):
        d1, d2 = int(plan.eq_d1[e]), int(plan.eq_d2[e])
        pc = plan.eq_poly[e]
        k, cd = float(plan.eq_kc[e, 0]), float(plan.eq_kc[e, 1])
        p = const(pc, qpos)
        dp = const([pc[1], 2 * pc[2], 3 * pc[3], 4 * pc[4]], qpos)
        x2 = qpos[..., d2] - const(plan.eq_q02[e], qpos)
        poly = p[0] + p[1] * x2 + p[2] * x2 ** 2 + p[3] * x2 ** 3 \
            + p[4] * x2 ** 4
        dpoly = dp[0] + dp[1] * x2 + dp[2] * x2 ** 2 + dp[3] * x2 ** 3
        r = (qpos[..., d1] - const(plan.eq_q01[e], qpos)) - poly
        rdot = qvel[..., d1] - dpoly * qvel[..., d2]
        e1 = const(np.eye(plan.nv)[d1], qpos)
        e2 = const(np.eye(plan.nv)[d2], qpos)
        g = e1 - dpoly[..., None] * e2
        qfrc = qfrc - (const(k, qpos) * r
                       + const(h * k + cd, qpos) * rdot)[..., None] * g
        a = a + const(h * (h * k + cd), qpos) * (g[..., :, None]
                                                  * g[..., None, :])
    qacc = solve_spd_scaled(a, qfrc)
    qvel2 = qvel + h * qacc
    return qpos + h * qvel2, qvel2
