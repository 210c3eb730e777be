"""Batched damped Gauss-Newton IK over the compiled kinematic chain: the
port's counterpart of the JAX package's control/ik.py.

The position target is the gripper's grasp centre (ee_link plus
``EE_OFFSET``) with the vertical-gripper constraint (ee_link's local x axis
along world -z), solved for the five arm joints [shoulder_pan,
shoulder_lift, elbow, wrist_1, wrist_2]; wrist_3 stays as the given qpos
holds it. Each update is clamped to the URDF bounds ``ARM_LO``/``ARM_HI``
(shoulder_lift in [-pi, -0.9] pins the elbow-up family) and its norm to
``max_step``. Six fixed seeds (home, and azimuth-informed ones) run 30
steps each, and the seed of least round-trip error wins (the first on
ties, as ``argmin``); ``ok`` is the reference's 0.02 m gate.

Where the JAX function is written for one target and vmapped, here every
argument carries leading batch dims and the (batch, 6 seeds) problems are
solved together: each step is one batched 5 x 5 solve.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.spatial import (
    cross, quat_mul, quat_rotate, quat_to_mat,
)
from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_HINGE
from mujoco_rl_ur5_tpu_torch.scene.model import Model

# gripper grasp centre: chain-tip target = world target + EE_OFFSET (the
# base frame is aligned with the world, so the offset is a world vector)
EE_OFFSET = np.array([0.0, -0.005, 0.16])
# URDF joint bounds: +-pi, except shoulder_lift
ARM_LO = np.array([-np.pi, -np.pi, -np.pi, -np.pi, -np.pi])
ARM_HI = np.array([np.pi, -0.9, np.pi, np.pi, np.pi])


class ArmChain:
    """The arm chain read from the Topology: ``bodies`` the path from the
    world to the tip (moving bodies only), ``jnt`` each path body's joint
    (-1 fixed), ``solve_mask``/``out_slot`` which path joints are solved
    and their slot in the solution."""

    def __init__(self, model: Model, tip_body: str = "ee_link",
                 solve_joints=("shoulder_pan_joint", "shoulder_lift_joint",
                               "elbow_joint", "wrist_1_joint",
                               "wrist_2_joint")):
        t = model.topo
        path, b = [], t.body_id(tip_body)
        while b != 0:
            path.append(b)
            b = int(t.body_parent[b])
        self.bodies = np.array(path[::-1], np.int64)
        jnt = []
        for b in self.bodies:
            if t.body_jntnum[b] > 0:
                j = int(t.body_jntadr[b])
                if t.jnt_type[j] != JNT_HINGE or t.body_jntnum[b] != 1:
                    raise ValueError("the IK chain takes one hinge per body")
                jnt.append(j)
            else:
                jnt.append(-1)
        self.jnt = np.array(jnt, np.int64)
        solve_ids = [t.joint_id(n) for n in solve_joints]
        self.solve_jnt = np.array(solve_ids, np.int64)
        self.qadr = np.asarray(t.jnt_qposadr)[self.jnt.clip(0)]
        self.solve_mask = np.isin(self.jnt, solve_ids)
        self.out_slot = np.array(
            [solve_ids.index(j) if j in solve_ids else -1 for j in self.jnt],
            np.int64)
        self.n_solve = len(solve_ids)


def _chain_fk(model: Model, chain: ArmChain, q_solve: torch.Tensor,
              qpos_rest: torch.Tensor):
    """FK along the chain over leading dims: q_solve (..., n_solve) the
    solved angles, qpos_rest (..., nq) the other chain joints' values.
    Returns the tip's position and quaternion and each solved joint's
    world anchor and axis (..., n_solve, 3)."""
    pos = q_solve.new_zeros(3)
    quat = q_solve.new_tensor([1.0, 0.0, 0.0, 0.0])
    anchors, axes = [], []
    for k, b in enumerate(chain.bodies):
        pos = pos + quat_rotate(quat, model.body_pos[b])
        quat = quat_mul(quat, model.body_quat[b])
        j = int(chain.jnt[k])
        if j < 0:
            continue
        theta = (q_solve[..., chain.out_slot[k]] if chain.solve_mask[k]
                 else qpos_rest[..., chain.qadr[k]]) - model.jnt_ref[j]
        ax_l = model.jnt_axis[j]
        anchor_w = pos + quat_rotate(quat, model.jnt_pos[j])
        half = 0.5 * theta
        qj = torch.cat([torch.cos(half)[..., None],
                        torch.sin(half)[..., None] * ax_l], -1)
        # rotate about the anchor: p' = anchor + R_j (p - anchor)
        jpos = model.jnt_pos[j]
        pos = pos + quat_rotate(quat, jpos - quat_rotate(qj, jpos))
        quat = quat_mul(quat, qj)
        if chain.solve_mask[k]:
            anchors.append(anchor_w.expand_as(pos))
            axes.append(quat_rotate(quat, ax_l))
    return pos, quat, torch.stack(anchors, -2), torch.stack(axes, -2)


def ik_solve(model: Model, chain: ArmChain, target: torch.Tensor,
             qpos: torch.Tensor, iterations: int = 30, damping: float = 1e-3,
             ori_weight: float = 0.5, down=(0.0, 0.0, -1.0),
             max_step: float = 0.5):
    """Arm IK for world grasp-centre targets (..., 3) from full-scene qpos
    (..., nq): (q5 (..., 5), err (...,) the round-trip position error,
    ok (...,) = err <= 0.02)."""
    dt = target.dtype
    tip_target = target + torch.as_tensor(EE_OFFSET, dtype=dt,
                                          device=target.device)
    downv = target.new_tensor(down)
    lo, hi = target.new_tensor(ARM_LO), target.new_tensor(ARM_HI)
    azim = torch.atan2(target[..., 1], target[..., 0])[..., None]
    rest = target.new_tensor([-1.29, 1.36, -1.64, -1.57]).expand(
        *azim.shape[:-1], 4)
    # far-reach family: shoulder_lift pinned at its URDF bound (-0.9)
    rest_far = target.new_tensor([-0.9, 1.15, -1.82, -1.57]).expand(
        *azim.shape[:-1], 4)
    home = target.new_tensor([0.0, -1.57, 1.57, -1.57, -1.57]).expand(
        *azim.shape[:-1], 5)
    seeds = torch.stack([
        home,
        torch.cat([azim, rest], -1),
        torch.cat([azim + 0.25, rest], -1),
        torch.cat([azim - 0.25, rest], -1),
        torch.cat([azim, rest_far], -1),
        torch.cat([azim + 0.2, rest_far], -1),
    ], -2)                                             # (..., 6, 5)
    qrest = qpos[..., None, :]
    tip = tip_target[..., None, :]
    eye = damping * torch.eye(chain.n_solve, dtype=dt, device=target.device)

    def residual(q):
        pos, quat, anchors, axes = _chain_fk(model, chain, q, qrest)
        xaxis = quat_to_mat(quat)[..., :, 0]
        return pos - tip, ori_weight * (xaxis - downv), pos, anchors, \
            axes, xaxis

    q = seeds
    for _ in range(iterations):
        r_pos, r_ori, pos, anchors, axes, xaxis = residual(q)
        # position rows: dp/dq_i = axis_i x (tip - anchor_i); orientation
        # rows: d(R ex)/dq_i = axis_i x (R ex)
        Jp = cross(axes, pos[..., None, :] - anchors)           # (.., 5, 3)
        Jo = ori_weight * cross(axes, xaxis[..., None, :])
        JT = torch.cat([Jp, Jo], -1)                            # (.., 5, 6)
        r = torch.cat([r_pos, r_ori], -1)
        Hm = JT @ JT.transpose(-1, -2) + eye
        dq = torch.linalg.solve_ex(Hm, (JT @ r[..., None]))[0][..., 0]
        scale = torch.clamp_max(
            max_step / torch.clamp_min(torch.linalg.vector_norm(dq, dim=-1),
                                       1e-9), 1.0)
        q = torch.clamp(q - dq * scale[..., None], lo, hi)
    errs = torch.linalg.vector_norm(residual(q)[0], dim=-1)    # (..., 6)
    best = torch.argmin(errs, -1, keepdim=True)               # first on ties
    err = torch.gather(errs, -1, best)[..., 0]
    q5 = torch.gather(q, -2, best[..., None].expand(
        *best.shape[:-1], 1, chain.n_solve))[..., 0, :]
    return q5, err, err <= 0.02
