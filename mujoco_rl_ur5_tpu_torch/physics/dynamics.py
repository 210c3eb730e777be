"""Batched dynamics: CRBA mass blocks, RNE bias, the constraint solve and
semi-implicit Euler with implicit joint damping. The port's counterpart of
the JAX package's physics/dynamics.py, over a leading batch axis.

As there, the mass matrix lives in per-tree padded blocks ``(B, ntree,
mtdof, mtdof)`` and spatial quantities are in world axes about per-tree
origins. JAX drops scatter indices that fall out of range (static parents,
padded ancestor slots); here those entries are masked out with static
numpy selections before each scatter. Sums into repeated rows (a body's
dofs, a parent's children) run in a fixed order (``_add_rows``), so a
step gives the same bits on every run, on the card as on the CPU.

``step_warm(model, state, warm, ncon, iterations)`` is the contact step:
FK, CRBA, RNE, the narrowphase and the pyramidal-facet FISTA solve of
physics/constraints.py, then the integration. The state's device decides
the route: on CUDA tensors the four narrowphase groups of the pile run the
hand-written kernels of physics/cuda_collide.py, on CPU tensors their
plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.blockchol import chol_small, cho_solve_small
from mujoco_rl_ur5_tpu_torch.ops.consts import const, ix
from mujoco_rl_ur5_tpu_torch.ops.spatial import (
    force_cross, inertia_from_body, inertia_mul, motion_cross, quat_integrate,
    quat_mul,
)
from mujoco_rl_ur5_tpu_torch.physics.constraints import constraint_forces
from mujoco_rl_ur5_tpu_torch.physics.kinematics import Kin, fk
from mujoco_rl_ur5_tpu_torch.scene.mjcf import (
    JNT_BALL, JNT_FREE, JNT_HINGE, JNT_SLIDE,
)
from mujoco_rl_ur5_tpu_torch.scene.model import Model, State
from mujoco_rl_ur5_tpu_torch.trace import spanned

# -- inertia pipeline -----------------------------------------------------------


def com_inertia(model: Model, kin: Kin) -> torch.Tensor:
    """Per-body 10-parameter spatial inertia about the body's tree origin
    (B, nbody, 10); static bodies zero."""
    t = model.topo
    cinert = inertia_from_body(model.body_mass, model.body_inertia,
                               kin.xipos - kin.body_org,
                               quat_mul(kin.xquat, model.body_iquat))
    return cinert * const((t.body_tree >= 0)[:, None], cinert)


@functools.lru_cache(maxsize=None)
def _repeat_passes(dst: tuple) -> tuple:
    """Positions of ``dst`` split into passes: pass r holds, in order, the
    positions where a target occurs for the (r+1)-th time."""
    seen, rank = {}, []
    for d in dst:
        rank.append(seen.get(d, 0))
        seen[d] = rank[-1] + 1
    rank = np.asarray(rank)
    return tuple(np.nonzero(rank == r)[0] for r in range(max(rank, default=-1)
                                                         + 1))


def _add_rows(out: torch.Tensor, dst: np.ndarray,
              rows: torch.Tensor) -> torch.Tensor:
    """out[..., dst[i], :] += rows[..., i, :] for every i, in place, summed
    in the order of i on every device and run. ``index_add_`` with repeated
    targets adds atomically on CUDA, in an order that changes from run to
    run; here each pass writes distinct rows."""
    dev = out.device
    for pos in _repeat_passes(tuple(int(d) for d in dst)):
        out[..., ix(dst[pos], dev), :] += rows[..., ix(pos, dev), :]
    return out


def _add_up(model: Model, x: torch.Tensor) -> torch.Tensor:
    """Accumulate per-body rows into their moving parents, leaves first
    (static parents receive nothing)."""
    t = model.topo
    dev = x.device
    x = x.clone()
    for level in reversed(t.body_levels):
        pid = t.body_parent[level]
        keep = t.body_tree[pid] >= 0
        if keep.any():
            _add_rows(x, pid[keep], x[..., ix(level[keep], dev), :])
    return x


def composite_inertia(model: Model, cinert: torch.Tensor) -> torch.Tensor:
    """Subtree composite inertias, bottom-up (CRB)."""
    return _add_up(model, cinert)


def _diag(model: Model, vals: torch.Tensor, like: torch.Tensor):
    """Per-dof values (nv,) on the block diagonals: (ntree, mt, mt)."""
    t = model.topo
    mt = t.mtdof
    out = like.new_zeros(t.ntree * mt * mt)
    out[ix(t.dof_tree * mt * mt + t.dof_treeidx * mt + t.dof_treeidx,
           like.device)] = vals
    return out.reshape(t.ntree, mt, mt)


def mass_blocks(model: Model, kin: Kin, crb: torch.Tensor) -> torch.Tensor:
    """CRBA -> per-tree padded mass blocks (B, ntree, mtdof, mtdof)."""
    t = model.topo
    mt = t.mtdof
    dev = crb.device
    f = inertia_mul(crb[..., ix(t.dof_body, dev), :], kin.cdof)   # (B, nv, 6)
    anc = t.dof_ancestors
    cdof_anc = kin.cdof[..., ix(np.maximum(anc, 0), dev), :]      # (B,nv,mt,6)
    vals = torch.einsum("...nk,...nmk->...nm", f, cdof_anc)
    valid = anc >= 0
    idx_j = t.dof_treeidx[np.maximum(anc, 0)]
    flat = (t.dof_tree[:, None] * mt * mt + t.dof_treeidx[:, None] * mt
            + idx_j)
    batch = crb.shape[:-2]
    blocks = crb.new_zeros(batch + (t.ntree * mt * mt,))
    blocks[..., ix(flat[valid], dev)] = vals[..., ix(valid, dev)]
    blocks = blocks.reshape(batch + (t.ntree, mt, mt))
    # lower triangle (ancestors precede descendants) -> symmetric
    off = const(1.0 - np.eye(mt), crb)
    blocks = blocks + blocks.transpose(-1, -2) * off
    # armature on the diagonal, a unit diagonal on padding slots
    used = np.zeros((t.ntree, mt), dtype=bool)
    used[t.dof_tree, t.dof_treeidx] = True
    pad = const((~used)[:, :, None] * np.eye(mt), crb)
    return blocks + _diag(model, model.dof_armature, crb) + pad


# -- velocities and RNE bias ------------------------------------------------------


def _segment_sum(model: Model, contrib: torch.Tensor) -> torch.Tensor:
    """Per-dof rows summed into their bodies: (B, nv, 6) -> (B, nbody, 6)."""
    t = model.topo
    out = contrib.new_zeros(contrib.shape[:-2] + (t.nbody, 6))
    return _add_rows(out, t.dof_body, contrib)


def _propagate_down(model: Model, base: torch.Tensor,
                    add: torch.Tensor) -> torch.Tensor:
    """x[level] = x[parent] + add[level], root levels first."""
    t = model.topo
    dev = add.device
    x = base.clone()
    for level in t.body_levels:
        x[..., ix(level, dev), :] = (x[..., ix(t.body_parent[level], dev), :]
                                     + add[..., ix(level, dev), :])
    return x


def com_vel(model: Model, kin: Kin, qvel: torch.Tensor):
    """Body spatial velocities (B, nbody, 6) and cdof time-derivatives
    (B, nv, 6), MuJoCo's conventions."""
    t = model.topo
    dev = qvel.device
    contrib = kin.cdof * qvel[..., None]
    bodysum = _segment_sum(model, contrib)
    cvel = _propagate_down(model, torch.zeros_like(bodysum), bodysum)

    include, keep = _partial_tables(t)
    a0 = np.maximum(t.dof_ancestors, 0)
    pre = torch.einsum("nm,...nmk->...nk", const(include, qvel),
                       contrib[..., ix(a0, dev), :])
    partial = cvel[..., ix(t.body_parent[t.dof_body], dev), :] + pre
    # a free joint's translational cdof is constant in world: no derivative
    return cvel, motion_cross(partial, kin.cdof) * const(keep[:, None], qvel)


@functools.lru_cache(maxsize=None)
def _partial_tables(t):
    """Static tables of com_vel: which ancestor dofs enter each dof's
    partial velocity (the same body's dofs before its joint, +3 for a free
    joint's rotations), and 0 on free joints' translational dofs."""
    thresh = np.zeros(t.nv, dtype=np.int64)
    for d in range(t.nv):
        j = t.dof_jnt[d]
        thresh[d] = t.jnt_dofadr[j]
        if t.jnt_type[j] == JNT_FREE and d >= t.jnt_dofadr[j] + 3:
            thresh[d] = t.jnt_dofadr[j] + 3
    anc = t.dof_ancestors
    a0 = np.maximum(anc, 0)
    include = ((anc >= 0) & (t.dof_body[a0] == t.dof_body[:, None])
               & (anc < thresh[:, None]))
    keep = np.ones(t.nv)
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        keep[t.jnt_dofadr[j]: t.jnt_dofadr[j] + 3] = 0.0
    return include, keep


def rne_bias(model: Model, kin: Kin, cinert: torch.Tensor,
             qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_bias = C(q, v) + gravity (MuJoCo mj_rne with qacc = 0), (B, nv)."""
    t = model.topo
    cvel, cdofdot = com_vel(model, kin, qvel)
    a0 = const(np.concatenate([np.zeros(3), -np.asarray(t.gravity)]), qvel)
    accsum = _segment_sum(model, cdofdot * qvel[..., None])
    cacc = _propagate_down(model, a0.expand_as(accsum), accsum)
    fb = (inertia_mul(cinert, cacc)
          + force_cross(cvel, inertia_mul(cinert, cvel)))
    ftot = _add_up(model, fb)
    return (kin.cdof * ftot[..., ix(t.dof_body, qvel.device), :]).sum(-1)


# -- block solves -----------------------------------------------------------------


def factor_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Per-tree Cholesky factors (the unrolled small-block version)."""
    return chol_small(blocks)


def _to_tree(model: Model, vec: torch.Tensor) -> torch.Tensor:
    """(B, nv) -> (B, ntree, mt), padding slots zero."""
    t = model.topo
    out = vec.new_zeros(vec.shape[:-1] + (t.ntree * t.mtdof,))
    out[..., ix(t.dof_tree * t.mtdof + t.dof_treeidx, vec.device)] = vec
    return out.reshape(vec.shape[:-1] + (t.ntree, t.mtdof))


def _from_tree(model: Model, x: torch.Tensor) -> torch.Tensor:
    """(B, ntree(+1), mt) -> (B, nv)."""
    t = model.topo
    flat = x.reshape(x.shape[:-2] + (-1,))
    return flat[..., ix(t.dof_tree * t.mtdof + t.dof_treeidx, x.device)]


def solve_blocks(model: Model, chol: torch.Tensor,
                 vec: torch.Tensor) -> torch.Tensor:
    """x = M^-1 vec with the per-tree Cholesky factors."""
    x = cho_solve_small(chol, _to_tree(model, vec)[..., None])[..., 0]
    return _from_tree(model, x)


def inv_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Explicit per-tree M^-1 blocks, Jacobi-equilibrated: the arm block
    mixes 20 kg links with 1e-6 kg m^2 finger inertias (cond ~1e7), so the
    inverse of D^-1/2 M D^-1/2 (cond ~1e2) is taken and unscaled."""
    mt = blocks.shape[-1]
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(blocks, dim1=-2, dim2=-1),
                                    1e-30))
    scaled = blocks * s[..., :, None] * s[..., None, :]
    eye = const(np.eye(mt), blocks).expand_as(blocks)
    inv_scaled = cho_solve_small(chol_small(scaled), eye)
    return inv_scaled * s[..., :, None] * s[..., None, :]


def minv_apply(model: Model, minv: torch.Tensor,
               vec: torch.Tensor) -> torch.Tensor:
    """x = M^-1 vec with the explicit per-tree inverse blocks."""
    x = torch.einsum("...tij,...tj->...ti", minv, _to_tree(model, vec))
    return _from_tree(model, x)


# -- actuation and integration ------------------------------------------------------


def actuator_force(model: Model, ctrl: torch.Tensor) -> torch.Tensor:
    """Torque motors: qfrc[dof] += gear * clip(ctrl, ctrlrange)."""
    t = model.topo
    c = torch.minimum(torch.maximum(ctrl, model.act_ctrlrange[:, 0]),
                      model.act_ctrlrange[:, 1])
    out = ctrl.new_zeros(ctrl.shape[:-1] + (t.nv,))
    return out.index_add_(-1, ix(t.act_dofadr, ctrl.device),
                          model.act_gear * c)


def integrate_qpos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   h: float) -> torch.Tensor:
    """qpos + h * qvel per joint type (quaternions integrated)."""
    t = model.topo
    dev = qpos.device
    out = qpos.clone()
    r3, r4 = np.arange(3), np.arange(4)
    scal = np.nonzero((t.jnt_type == JNT_HINGE)
                      | (t.jnt_type == JNT_SLIDE))[0]
    if len(scal):
        qa = ix(t.jnt_qposadr[scal], dev)
        out[..., qa] = qpos[..., qa] + h * qvel[..., ix(t.jnt_dofadr[scal],
                                                         dev)]
    ball = np.nonzero(t.jnt_type == JNT_BALL)[0]
    if len(ball):
        qa = ix(t.jnt_qposadr[ball][:, None] + r4, dev)
        da = ix(t.jnt_dofadr[ball][:, None] + r3, dev)
        out[..., qa] = quat_integrate(qpos[..., qa], qvel[..., da], h)
    fj = np.nonzero(t.jnt_type == JNT_FREE)[0]
    if len(fj):
        qa, da = t.jnt_qposadr[fj][:, None], t.jnt_dofadr[fj][:, None]
        qt, qr = ix(qa + r3, dev), ix(qa + 3 + r4, dev)
        out[..., qt] = qpos[..., qt] + h * qvel[..., ix(da + r3, dev)]
        out[..., qr] = quat_integrate(qpos[..., qr], qvel[..., ix(da + 3 + r3,
                                                                  dev)], h)
    return out


# -- forward and step ----------------------------------------------------------------


def forward(model: Model, state: State, ncon: int = 0, iterations: int = 30):
    """Forward dynamics with constraints: (qacc, kin, contacts). ``ncon``
    is the active-contact cap; 0 gives smooth dynamics (no contact,
    equality or limit rows)."""
    qacc, kin, contacts, _ = forward_warm(model, state, None, ncon,
                                          iterations)
    return qacc, kin, contacts


def forward_warm(model: Model, state: State, warm, ncon: int = 0,
                 iterations: int = 30):
    """``forward`` with the constraint solver warm-started from ``warm``
    (constraints.init_warm for the first step, None for a cold start);
    returns (qacc, kin, contacts, warm')."""
    t = model.topo
    h = t.timestep
    kin = fk(model, state.qpos)
    cinert = com_inertia(model, kin)
    crb = composite_inertia(model, cinert)
    mblocks = mass_blocks(model, kin, crb)
    # implicit damping: factor M + h diag(damping)
    chol_mhb = factor_blocks(
        mblocks + _diag(model, h * model.dof_damping, mblocks))
    bias = rne_bias(model, kin, cinert, state.qvel)
    qfrc_smooth = (actuator_force(model, state.ctrl) - bias
                   - model.dof_damping * state.qvel)
    qfrc = qfrc_smooth
    contacts, warm_new = None, warm
    if ncon > 0:
        minv = inv_blocks(mblocks)
        qacc_smooth = minv_apply(model, minv, qfrc_smooth)
        qfrc_c, contacts, warm_new = constraint_forces(
            model, state, kin, minv, qacc_smooth, ncon, iterations,
            warm=warm)
        qfrc = qfrc_smooth + qfrc_c
    qacc = solve_blocks(model, chol_mhb, qfrc)
    return qacc, kin, contacts, warm_new


def step(model: Model, state: State, ncon: int = 0,
         iterations: int = 30) -> State:
    """One semi-implicit Euler step of every scenario (cold solver)."""
    return step_warm(model, state, None, ncon=ncon, iterations=iterations)[0]


@spanned("step")
def step_warm(model: Model, state: State, warm, ncon: int = 0,
              iterations: int = 30):
    """One step with the solver warm start; returns (State, warm')."""
    h = model.topo.timestep
    qacc, _, _, warm_new = forward_warm(model, state, warm, ncon=ncon,
                                        iterations=iterations)
    qvel = state.qvel + h * qacc
    qpos = integrate_qpos(model, state.qpos, qvel, h)
    return (state.replace(qpos=qpos, qvel=qvel, time=state.time + h),
            warm_new)
