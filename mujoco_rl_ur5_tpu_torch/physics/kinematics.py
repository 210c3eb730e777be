"""Forward kinematics and per-dof motion subspaces over a batch of
scenarios: the port's counterpart of the JAX package's
physics/kinematics.py.

The JAX function is written for one scenario and vmapped; here every
function takes a leading batch axis (qpos (B, nq)). Per-body work is
scheduled by the compile-time levels (parent before child), and every
static table is read through ``ops.consts.ix`` so that nothing is copied
to the device per call. Spatial quantities (cdof) are in world axes about
each tree's origin, the tree root body's position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.consts import const, ix
from mujoco_rl_ur5_tpu_torch.ops.spatial import (
    cross, quat_from_axis_angle, quat_mul, quat_normalize, quat_rotate,
    quat_to_mat,
)
from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    JNT_BALL, JNT_FREE, JNT_HINGE, JNT_SLIDE,
)
from mujoco_rl_ur5_tpu_torch.scene.model import Model
from mujoco_rl_ur5_tpu_torch.trace import spanned


@dataclass
class Kin:
    """World-frame kinematics of a batch of scenarios (leading dims B)."""

    xpos: torch.Tensor      # (B, nbody, 3) body frame origins
    xquat: torch.Tensor     # (B, nbody, 4)
    xipos: torch.Tensor     # (B, nbody, 3) body COM
    xanchor: torch.Tensor   # (B, njnt, 3) joint anchors
    xaxis: torch.Tensor     # (B, njnt, 3) joint axes
    cdof: torch.Tensor      # (B, nv, 6) motion subspace about tree origin
    tree_org: torch.Tensor  # (B, ntree, 3)
    dof_org: torch.Tensor   # (B, nv, 3)
    body_org: torch.Tensor  # (B, nbody, 3), static bodies 0


def _gather_q(qpos, qadr, n, nq, dev):
    """qpos[..., qadr + 0..n-1] (slots past nq clamp, as XLA's gather
    clamps; those slots belong to other joint types and are discarded)."""
    idx = np.minimum(np.asarray(qadr)[:, None] + np.arange(n), nq - 1)
    return qpos[..., ix(idx, dev)]


@spanned("fk")
def fk(model: Model, qpos: torch.Tensor) -> Kin:
    t = model.topo
    dev = qpos.device
    batch = qpos.shape[:-1]
    xpos = qpos.new_zeros(batch + (t.nbody, 3))
    xquat = qpos.new_zeros(batch + (t.nbody, 4))
    xquat[..., 0] = 1.0
    static = np.nonzero(t.body_tree < 0)[0]
    if len(static):
        xpos[..., ix(static, dev), :] = const(t.xpos0[static], qpos)
        xquat[..., ix(static, dev), :] = const(t.xquat0[static], qpos)
    xanchor = qpos.new_zeros(batch + (t.njnt, 3))
    xaxis = qpos.new_zeros(batch + (t.njnt, 3))
    ident = const([1.0, 0.0, 0.0, 0.0], qpos)

    for level in t.body_levels:
        lv = ix(level, dev)
        pid = ix(t.body_parent[level], dev)
        p_pos, p_quat = xpos[..., pid, :], xquat[..., pid, :]
        pos = p_pos + quat_rotate(p_quat, model.body_pos[lv])
        quat = quat_mul(p_quat, model.body_quat[lv])
        for k in range(int(t.body_jntnum[level].max())):
            has = t.body_jntnum[level] > k
            jid = np.where(has, t.body_jntadr[level] + k, 0)
            jtype = t.jnt_type[jid]
            qadr = t.jnt_qposadr[jid]
            ji = ix(jid, dev)
            jpos, jaxis = model.jnt_pos[ji], model.jnt_axis[ji]
            sel = np.nonzero(has)[0]
            si, sj = ix(sel, dev), ix(jid[sel], dev)
            xanchor[..., sj, :] = (pos + quat_rotate(quat, jpos))[..., si, :]
            xaxis[..., sj, :] = quat_rotate(quat, jaxis)[..., si, :]

            # per-type local joint transform; the types are static, so a
            # branch no joint of this slot takes is not computed
            th = qpos[..., ix(qadr, dev)] - model.jnt_ref[ji]
            is_h = ix(jtype == JNT_HINGE, dev)[:, None]
            tm_quat = ident.expand_as(quat)
            if np.any(jtype == JNT_HINGE):
                tm_quat = torch.where(is_h, quat_from_axis_angle(jaxis, th),
                                      tm_quat)
            if np.any(jtype == JNT_BALL):
                tm_quat = torch.where(
                    ix(jtype == JNT_BALL, dev)[:, None],
                    quat_normalize(_gather_q(qpos, qadr, 4, t.nq, dev)),
                    tm_quat)
            tm_pos = jpos - quat_rotate(tm_quat, jpos)
            if np.any(jtype == JNT_SLIDE):
                tm_pos = torch.where(ix(jtype == JNT_SLIDE, dev)[:, None],
                                     jaxis * th[..., None], tm_pos)
            new_pos = pos + quat_rotate(quat, tm_pos)
            new_quat = quat_mul(quat, tm_quat)
            if np.any(jtype == JNT_FREE):
                is_f = ix(jtype == JNT_FREE, dev)[:, None]
                q7 = _gather_q(qpos, qadr, 7, t.nq, dev)
                new_pos = torch.where(is_f, q7[..., :3], new_pos)
                new_quat = torch.where(is_f, quat_normalize(q7[..., 3:]),
                                       new_quat)
            if has.all():
                pos, quat = new_pos, new_quat
            else:
                apply = ix(has, dev)[:, None]
                pos = torch.where(apply, new_pos, pos)
                quat = torch.where(apply, new_quat, quat)
        xpos[..., lv, :] = pos
        xquat[..., lv, :] = quat

    # free joints: the anchor is the body origin, after the frame override
    free_j = np.nonzero(t.jnt_type == JNT_FREE)[0]
    if len(free_j):
        xanchor[..., ix(free_j, dev), :] = xpos[..., ix(t.jnt_body[free_j],
                                                        dev), :]
    xipos = xpos + quat_rotate(xquat, model.body_ipos)
    tree_org = xpos[..., ix(t.tree_rootbody, dev), :]
    body_org = torch.where(
        ix(t.body_tree >= 0, dev)[:, None],
        tree_org[..., ix(np.maximum(t.body_tree, 0), dev), :],
        qpos.new_zeros(()))
    dof_org = tree_org[..., ix(t.dof_tree, dev), :]
    cdof = _compute_cdof(model, qpos, xquat, xanchor, xaxis, dof_org)
    return Kin(xpos=xpos, xquat=xquat, xipos=xipos, xanchor=xanchor,
               xaxis=xaxis, cdof=cdof, tree_org=tree_org, dof_org=dof_org,
               body_org=body_org)


def _compute_cdof(model, qpos, xquat, xanchor, xaxis, dof_org):
    """Motion subspace per dof, world axes, about the dof's tree origin:
    hinge [axis; (anchor - org) x axis]; slide [0; axis]; ball three such
    columns of the body rotation; free three world translations, then
    three rotations about the body origin (angular velocity body-local)."""
    t = model.topo
    dev = qpos.device
    cdof = qpos.new_zeros(qpos.shape[:-1] + (t.nv, 6))
    jt = t.jnt_type

    def rot_cols(j, axes, off=0):
        for i, ax in enumerate(axes):
            d = ix(t.jnt_dofadr[j] + off + i, dev)
            arm = xanchor[..., ix(j, dev), :] - dof_org[..., d, :]
            cdof[..., d, :] = torch.cat([ax, cross(arm, ax)], -1)

    h = np.nonzero(jt == JNT_HINGE)[0]
    if len(h):
        rot_cols(h, [xaxis[..., ix(h, dev), :]])
    s = np.nonzero(jt == JNT_SLIDE)[0]
    if len(s):
        cdof[..., ix(t.jnt_dofadr[s], dev), 3:] = xaxis[..., ix(s, dev), :]
    b = np.nonzero(jt == JNT_BALL)[0]
    if len(b):
        R = quat_to_mat(xquat[..., ix(t.jnt_body[b], dev), :])
        rot_cols(b, [R[..., :, i] for i in range(3)])
    fj = np.nonzero(jt == JNT_FREE)[0]
    if len(fj):
        for i in range(3):
            cdof[..., ix(t.jnt_dofadr[fj] + i, dev), 3 + i] = 1.0
        R = quat_to_mat(xquat[..., ix(t.jnt_body[fj], dev), :])
        rot_cols(fj, [R[..., :, i] for i in range(3)], off=3)
    return cdof


def geom_poses(model: Model, kin: Kin):
    """World poses of all geoms: (B, ngeom, 3) positions, (B, ngeom, 4)
    quats."""
    gb = ix(model.topo.geom_body, kin.xpos.device)
    bp, bq = kin.xpos[..., gb, :], kin.xquat[..., gb, :]
    return bp + quat_rotate(bq, model.geom_pos), quat_mul(bq, model.geom_quat)
