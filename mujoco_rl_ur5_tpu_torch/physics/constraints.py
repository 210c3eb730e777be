"""Soft-constraint solver: contacts, joint limits and equality couplings,
over a batch of scenarios. The port's counterpart of the JAX package's
physics/constraints.py; its docstring sets out the formulation, which is
kept here unchanged:

  * MuJoCo's soft constraints: impedance from solimp, spring and damper
    from solref, aref = -b (J qvel) - k imp (dist - margin);
  * pyramidal friction facets J_n +- mu_i J_i (2 (condim - 1) rows per
    contact) sharing one regularizer R built from the qpos0 invweights;
  * equality and limit rows solved jointly with the contacts;
  * FISTA in Jacobi-preconditioned coordinates with a step from a
    mixed-symmetry power iteration, gradient restart and step halving;
  * a warm start keyed by candidate slot.

What differs is how tables are read. The JAX package gathers with one-hot
matrix products (the TPU's idiom: row gathers there are serial loops);
here they are ``gather``/``index_select``/``scatter``, the same function
and exact: at B=4096, ncon=128 and the pile's 1,848 candidates the one-hot
selection matrix alone would take 3.9 GB. The sums of contact forces into
their trees keep the JAX package's one-hot products (B, K, ntree + 1):
small, and summed in a fixed order, so a step repeats to the bit. ``lax.top_k`` is a
stable ascending ``argsort`` (ties to the lower index), for the
broadphase cap and the contact selection alike.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch.ops.consts import const, ix
from mujoco_rl_ur5_tpu_torch.ops.spatial import cross, quat_mul, quat_rotate
from mujoco_rl_ur5_tpu_torch.physics import collision, cuda_collide
from mujoco_rl_ur5_tpu_torch.physics.collision import _smallest
from mujoco_rl_ur5_tpu_torch.physics.kinematics import Kin, geom_poses
from mujoco_rl_ur5_tpu_torch.scene.model import Model, State
from mujoco_rl_ur5_tpu_torch.trace import count, spanned

BROADPHASE_CAP = 64   # max pairs per type group fed to the narrowphase
FACET_AXIS = np.repeat(np.arange(5), 2)   # friction axis per facet slot
FACET_SGN = np.tile([1.0, -1.0], 5)       # facet sign per slot
NFACET = 10                               # 2 (condim - 1) at condim 6


# -- the soft-constraint scalar model -----------------------------------------------


def impedance(solimp: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """MuJoCo's solimp sigmoid (dmin, dmax, width), mid 0.5, power 2."""
    dmin, dmax, width = solimp[..., 0], solimp[..., 1], solimp[..., 2]
    x = torch.clamp(r.abs() / torch.clamp_min(width, 1e-12), 0.0, 1.0)
    y = torch.where(x <= 0.5, 2.0 * x ** 2.0, 1.0 - (1.0 - x) ** 2.0 / 0.5)
    return torch.clamp(dmin + y * (dmax - dmin), 1e-4, 1.0 - 1e-6)


def kb_from_solref(solref: torch.Tensor, dmax: torch.Tensor):
    """Stiffness and damping of the virtual constraint spring."""
    tc = torch.clamp_min(solref[..., 0], 1e-6)
    dr = torch.clamp_min(solref[..., 1], 1e-6)
    return 1.0 / (dmax * dmax * tc * tc * dr * dr), 2.0 / (dmax * tc)


# -- candidates and selection ---------------------------------------------------------


def hulls(model: Model) -> cuda_collide.Hulls:
    """The model's hull tables as the narrowphase wrappers take them, with
    each row's real vertex and face counts."""
    return cuda_collide.Hulls(ix(model.topo.geom_meshid, model.hull_verts
                                 .device), model.hull_verts, model.hull_vmask,
                              model.hull_fnorm, model.hull_fdist,
                              *cuda_collide.hull_counts(model.hull_vmask,
                                                        model.hull_fdist))


def collision_poses(model: Model, kin: Kin):
    """World poses of every geom's collision proxy: (B, G, 3), (B, G, 4)."""
    gpos, gquat = geom_poses(model, kin)
    return (gpos + quat_rotate(gquat, model.col_pos),
            quat_mul(gquat, model.col_quat))


def pair_groups(model: Model, cpos: torch.Tensor):
    """The narrowphase groups of one call: (type1, type2, g1, g2, pair), the
    last three (B, n) int64. Groups with more than BROADPHASE_CAP pairs
    keep, per scenario, the CAP pairs nearest by bounding-sphere separation
    (stable order)."""
    t = model.topo
    dev, B = cpos.device, cpos.shape[0]
    out = []
    for (t1, t2, idx) in t.pair_groups:
        g1 = ix(t.pair_geom1[idx], dev).expand(B, len(idx))
        g2 = ix(t.pair_geom2[idx], dev).expand(B, len(idx))
        pid = ix(idx, dev).expand(B, len(idx))
        if len(idx) > BROADPHASE_CAP:
            c1, c2 = cpos[:, g1[0]], cpos[:, g2[0]]
            sep = (torch.sqrt(((c1 - c2) ** 2).sum(-1))
                   - model.geom_rbound[g1[0]] - model.geom_rbound[g2[0]])
            sel = _smallest(sep, BROADPHASE_CAP)
            g1, g2, pid = (torch.gather(a, 1, sel) for a in (g1, g2, pid))
        out.append((t1, t2, g1, g2, pid))
    return out


@spanned("collide", device=True)
def collide(model: Model, kin: Kin):
    """Every narrowphase group -> flat candidates: (pos (B, ncand, 3),
    normal (B, ncand, 3), dist (B, ncand), pair (B, ncand) int64, each
    candidate's pair id)."""
    cpos, cquat = collision_poses(model, kin)
    B = cpos.shape[0]
    hull_tables = hulls(model)
    pos_l, n_l, d_l, p_l = [], [], [], []
    for t1, t2, g1, g2, pid in pair_groups(model, cpos):
        batched = cuda_collide.BATCHED.get((t1, t2))
        if batched is not None:
            p, n, d = batched(cpos, cquat, model.col_size, hull_tables, g1,
                              g2)
        else:
            fn = collision.NARROWPHASE[(t1, t2)][0]
            rows = cuda_collide._rows
            p, n, d = fn(rows(cpos, g1), rows(cquat, g1), model.col_size[g1],
                         rows(cpos, g2), rows(cquat, g2), model.col_size[g2])
        k = d.shape[-1]
        pos_l.append(p.reshape(B, -1, 3))
        n_l.append(n.reshape(B, -1, 3))
        d_l.append(d.reshape(B, -1))
        p_l.append(pid[..., None].expand(pid.shape + (k,)).reshape(B, -1))
    if not pos_l:
        z = cpos.new_zeros(B, 0, 3)
        return z, z, cpos.new_zeros(B, 0), torch.zeros(
            B, 0, dtype=torch.long, device=cpos.device)
    return (torch.cat(pos_l, 1), torch.cat(n_l, 1), torch.cat(d_l, 1),
            torch.cat(p_l, 1))


@dataclass
class ContactSet:
    """The ncon selected contacts of each scenario, with their Jacobians."""

    pos: torch.Tensor       # (B, K, 3)
    frame: torch.Tensor     # (B, K, 3, 3) rows: normal, tangent1, tangent2
    dist: torch.Tensor      # (B, K)
    active: torch.Tensor    # (B, K) bool
    dim_mask: torch.Tensor  # (B, K, 6)
    friction: torch.Tensor  # (B, K, 3)
    solref: torch.Tensor    # (B, K, 2)
    solimp: torch.Tensor    # (B, K, 3)
    margin: torch.Tensor    # (B, K)
    tree1: torch.Tensor     # (B, K) int64 (ntree for a static side)
    tree2: torch.Tensor
    J1: torch.Tensor        # (B, K, 6, mtdof) side 1 (negated)
    J2: torch.Tensor        # (B, K, 6, mtdof)
    geom1: torch.Tensor     # (B, K)
    geom2: torch.Tensor
    sel: torch.Tensor       # (B, K) candidate slot: the warm-start key
    forces: torch.Tensor = None   # (B, K, 6) solved impulses


def _tangent_frame(n):
    """Orthonormal (t1, t2) completing the unit normal n."""
    ref = torch.where(n[..., 2:3].abs() < 0.7, const([0.0, 0.0, 1.0], n),
                      const([1.0, 0.0, 0.0], n))
    t1 = cross(n, ref)
    t1 = t1 / torch.clamp_min(torch.sqrt((t1 * t1).sum(-1, keepdim=True)),
                              1e-12)
    return t1, cross(n, t1)


def _gather_rows(x, idx):
    """x (B, N, *rest) at idx (B, K) -> (B, K, *rest)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def _tree_pad(model: Model, vec: torch.Tensor) -> torch.Tensor:
    """(B, nv) -> (B, ntree + 1, mt): per-tree slots and a zero row for
    the static side of a contact."""
    t = model.topo
    out = vec.new_zeros(vec.shape[0], (t.ntree + 1) * t.mtdof)
    out[:, ix(t.dof_tree * t.mtdof + t.dof_treeidx, vec.device)] = vec
    return out.reshape(vec.shape[0], t.ntree + 1, t.mtdof)


def make_contacts(model: Model, kin: Kin, ncon: int) -> ContactSet:
    t = model.topo
    dev = kin.xpos.device
    cand_pos, cand_n, cand_dist, cand_pair = collide(model, kin)
    score = cand_dist - model.pair_margin[cand_pair]
    sel = _smallest(score, min(ncon, score.shape[1]))          # (B, K)
    pos, n = _gather_rows(cand_pos, sel), _gather_rows(cand_n, sel)
    dist = torch.gather(cand_dist, 1, sel)
    pair = torch.gather(cand_pair, 1, sel)
    margin = model.pair_margin[pair]
    condim = ix(t.pair_condim, dev)[pair]
    g1, g2 = ix(t.pair_geom1, dev)[pair], ix(t.pair_geom2, dev)[pair]
    t1v, t2v = _tangent_frame(n)
    frame = torch.stack([n, t1v, t2v], -2)

    # cdof regrouped per (tree, slot) with a zero tree for static sides
    B, mt = kin.cdof.shape[0], t.mtdof
    cdof_tree = kin.cdof.new_zeros(B, (t.ntree + 1) * mt, 6)
    cdof_tree[:, ix(t.dof_tree * mt + t.dof_treeidx, dev)] = kin.cdof
    cdof_tree = cdof_tree.reshape(B, t.ntree + 1, mt, 6)
    tree_org = torch.cat([kin.tree_org, kin.tree_org.new_zeros(B, 1, 3)], 1)
    b_tree = np.where(t.body_tree >= 0, t.body_tree, t.ntree)
    geom_tree = b_tree[t.geom_body]
    geom_slots = (t.body_ancestor_slots[t.geom_body]
                  * (geom_tree != t.ntree)[:, None])

    def side_jac(g):
        tr = ix(geom_tree, dev)[g]                              # (B, K)
        cd = _gather_rows(cdof_tree, tr)                        # (B, K, mt, 6)
        org = _gather_rows(tree_org, tr)
        ang = cd[..., :3]
        lin = cd[..., 3:] + cross(ang, (pos - org)[..., None, :])
        Jlin = torch.einsum("bkrd,bkmd->bkrm", frame, lin)
        Jang = torch.einsum("bkrd,bkmd->bkrm", frame, ang)
        slots = const(geom_slots, pos)[g]                       # (B, K, mt)
        return tr, torch.cat([Jlin, Jang], -2) * slots[..., None, :]

    tree1, J1 = side_jac(g1)
    tree2, J2 = side_jac(g2)
    return ContactSet(
        pos=pos, frame=frame, dist=dist, active=(dist - margin) < 0.0,
        dim_mask=torch.arange(6, device=dev) < condim[..., None],
        friction=model.pair_friction[pair], solref=model.pair_solref[pair],
        solimp=model.pair_solimp[pair], margin=margin, tree1=tree1,
        tree2=tree2, J1=-J1, J2=J2, geom1=g1, geom2=g2, sel=sel)


# -- equality and limit rows ----------------------------------------------------------


def _scalar_rows(model: Model, state: State):
    """Equality and joint-limit rows: dense Jacobians (B, S, nv) with their
    aref, impedance, activity, lower-bound flags and R; None if none."""
    t = model.topo
    qpos, qvel = state.qpos, state.qvel
    B = qpos.shape[0]
    J, posv, velv, solref, solimp, lb, iws = [], [], [], [], [], [], []
    for e in range(t.neq):
        d1, d2 = int(t.eq_j1_dof[e]), int(t.eq_j2_dof[e])
        qa1, qa2 = int(t.eq_j1_qadr[e]), int(t.eq_j2_qadr[e])
        q1 = qpos[:, qa1] - model.qpos0[qa1]
        q2 = qpos[:, qa2] - model.qpos0[qa2]
        c = model.eq_poly[e]
        poly = c[0] + c[1] * q2 + c[2] * q2 ** 2 + c[3] * q2 ** 3 \
            + c[4] * q2 ** 4
        dpoly = c[1] + 2 * c[2] * q2 + 3 * c[3] * q2 ** 2 + 4 * c[4] * q2 ** 3
        row = qpos.new_zeros(B, t.nv)
        row[:, d1] = 1.0
        row[:, d2] = row[:, d2] - dpoly
        J.append(row)
        posv.append(q1 - poly)
        velv.append(qvel[:, d1] - dpoly * qvel[:, d2])
        solref.append(model.eq_solref[e])
        solimp.append(model.eq_solimp[e])
        lb.append(False)
        iws.append(model.dof_invweight0[d1] + model.dof_invweight0[d2])
    for lim in range(t.nlimit):
        d = int(t.limit_dof[lim])
        q = qpos[:, int(t.limit_qadr[lim])]
        lo, hi = model.limit_range[lim, 0], model.limit_range[lim, 1]
        for sign, dist in ((1.0, q - lo), (-1.0, hi - q)):
            row = qpos.new_zeros(B, t.nv)
            row[:, d] = sign
            J.append(row)
            posv.append(torch.clamp_max(dist, 0.0))
            velv.append(sign * qvel[:, d])
            solref.append(model.limit_solref[lim])
            solimp.append(model.limit_solimp[lim])
            lb.append(True)
            iws.append(model.dof_invweight0[d])
    if not J:
        return None
    J, posv, velv = torch.stack(J, 1), torch.stack(posv, 1), torch.stack(
        velv, 1)
    solref, solimp = torch.stack(solref), torch.stack(solimp)
    imp = impedance(solimp, posv)
    ks, bs = kb_from_solref(solref, solimp[..., 1])
    aref = -bs * velv - ks * imp * posv
    lb = ix(np.array(lb), qpos.device)
    act = torch.where(lb, posv < 0.0, True)
    R = (1.0 - imp) / imp * torch.clamp_min(torch.stack(iws), 1e-12)
    return J, aref, imp, act, lb, R


# -- the facet system -------------------------------------------------------------------


@dataclass
class _System:
    con: ContactSet
    E: torch.Tensor          # (B, K, 6, NFACET) facet basis
    rowmask: torch.Tensor    # (B, K, NFACET) live facet rows
    R_f: torch.Tensor        # (B, K)
    bm: torch.Tensor         # (B, K, NFACET)
    D_f: torch.Tensor        # (B, K, NFACET) diag(A + R)
    srows: tuple | None
    b_s: torch.Tensor | None
    D_s: torch.Tensor | None
    model: Model
    minv: torch.Tensor
    T1: torch.Tensor         # (B, K, ntree + 1) one-hot tree of side 1
    T2: torch.Tensor

    def rows_dot(self, X):
        """J . X[tree] per contact for a per-tree field X (B, ntree+1, mt)."""
        c = self.con
        return (torch.einsum("bkrm,bkm->bkr", c.J1, _gather_rows(X, c.tree1))
                + torch.einsum("bkrm,bkm->bkr", c.J2,
                               _gather_rows(X, c.tree2)))

    def scatter_forces(self, f_con):
        """Contact forces (B, K, 6) -> generalized forces (B, ntree+1, mt),
        through the one-hot tree maps T1, T2 as in the JAX package: a
        product sums in a fixed order, where ``scatter_add`` into shared
        tree rows adds atomically on CUDA, in an order that changes from
        run to run."""
        c = self.con
        return (torch.einsum("bkt,bkm->btm", self.T1, torch.einsum(
                    "bkrm,bkr->bkm", c.J1, f_con))
                + torch.einsum("bkt,bkm->btm", self.T2, torch.einsum(
                    "bkrm,bkr->bkm", c.J2, f_con)))

    def matvec(self, x, f_s):
        """(A + R) applied to facet forces x and scalar-row forces f_s."""
        t = self.model.topo
        x = torch.where(self.rowmask, x, 0.0)
        F = self.scatter_forces(torch.einsum("bkij,bkj->bki", self.E, x))
        if self.srows is not None:
            F = F + _tree_pad(self.model, torch.einsum(
                "bsv,bs->bv", self.srows[0], f_s))
        X = torch.einsum("btij,btj->bti", self.minv, F[:, : t.ntree])
        X = torch.cat([X, X.new_zeros(X.shape[0], 1, X.shape[2])], 1)
        a_f = torch.einsum("bkij,bki->bkj", self.E, self.rows_dot(X))
        a_f = torch.where(self.rowmask, a_f + self.R_f[..., None] * x, 0.0)
        if self.srows is None:
            return a_f, f_s
        Js, _, _, act, _, R_s = self.srows
        xdof = X.reshape(X.shape[0], -1)[:, ix(
            t.dof_tree * t.mtdof + t.dof_treeidx, X.device)]
        a_s = torch.einsum("bsv,bv->bs", Js, xdof)
        return a_f, torch.where(act, a_s + R_s * f_s, 0.0)

    def project_f(self, x):
        return torch.where(self.rowmask, torch.clamp_min(x, 0.0), 0.0)

    def project_s(self, f_s):
        if self.srows is None:
            return f_s
        _, _, _, act, lb, _ = self.srows
        f_s = torch.where(lb, torch.clamp_min(f_s, 0.0), f_s)
        return torch.where(act, f_s, 0.0)


def _assemble(model: Model, state: State, kin: Kin, minv: torch.Tensor,
              qacc_smooth: torch.Tensor, ncon: int) -> _System:
    """The facet-space system: contacts, masks, R, b, the Jacobi diagonal."""
    t = model.topo
    dev = minv.device
    con = make_contacts(model, kin, ncon)
    B, K = con.dist.shape
    minv_pad = torch.cat([minv, minv.new_zeros(B, 1, t.mtdof, t.mtdof)], 1)

    r = con.dist - con.margin
    imp = impedance(con.solimp, r)
    ks, bs = kb_from_solref(con.solref, con.solimp[..., 1])

    # exact per-contact Delassus blocks G = sum_side J M^-1 J^T: the normal
    # diagonal marks contacts no dof can resist, the block feeds the
    # preconditioner (R uses the invweight0 constants instead)
    G = sum(torch.einsum("bkrm,bkmn,bksn->bkrs", J, _gather_rows(minv_pad, tr),
                         J) for J, tr in ((con.J1, con.tree1),
                                          (con.J2, con.tree2)))
    active = con.active & (G[..., 0, 0] > 1e-9)

    # pyramidal facets J_n +- mu_i J_i; condim c uses the first 2 (c - 1)
    # slots, condim 1 one normal-only row in slot 0
    condim = con.dim_mask.sum(-1)
    condim1 = condim <= 1
    fr = con.friction
    mu5 = torch.stack([fr[..., 0], fr[..., 0], fr[..., 1], fr[..., 2],
                       fr[..., 2]], -1)
    MU = torch.where(condim1[..., None], 0.0,
                     mu5[..., ix(FACET_AXIS, dev)] * const(FACET_SGN, mu5))
    slot = torch.arange(NFACET, device=dev)
    fmask = torch.where(condim1[..., None], slot == 0,
                        ix(FACET_AXIS, dev) < (condim - 1)[..., None])
    rowmask = fmask & active[..., None]
    O5 = np.zeros((NFACET, 5))
    O5[np.arange(NFACET), FACET_AXIS] = 1.0
    E = torch.cat([torch.ones_like(MU)[..., None, :],
                   const(O5.T, MU) * MU[..., None, :]], -2)   # (B, K, 6, 10)
    E = E * rowmask[..., None, :].to(E.dtype)

    # one regularizer per contact, shared by its facets
    iw = model.geom_invweight0[con.geom1] + model.geom_invweight0[con.geom2]
    mu0 = fr[..., 0]
    factor = torch.where(condim1, 1.0, 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0)
                         / t.impratio)
    R_f = torch.clamp_min((1.0 - imp) / imp * iw * factor, 1e-10)

    # b = E^T (J qacc_smooth) - aref per facet (its own velocity, the
    # contact's position spring)
    sysd = _System(con=con, E=E, rowmask=rowmask, R_f=R_f, bm=None, D_f=None,
                   srows=_scalar_rows(model, state), b_s=None, D_s=None,
                   model=model, minv=minv,
                   T1=torch.nn.functional.one_hot(con.tree1, t.ntree + 1)
                   .to(minv.dtype),
                   T2=torch.nn.functional.one_hot(con.tree2, t.ntree + 1)
                   .to(minv.dtype))
    jv = sysd.rows_dot(_tree_pad(model, state.qvel))
    jq6 = sysd.rows_dot(_tree_pad(model, qacc_smooth))
    aref_f = (-bs[..., None] * torch.einsum("bkij,bki->bkj", E, jv)
              - (ks * imp * r)[..., None])
    b_f = torch.einsum("bkij,bki->bkj", E, jq6) - aref_f
    sysd.bm = torch.where(rowmask, b_f, 0.0)
    D_f = torch.einsum("zkaj,zkac,zkcj->zkj", E, G, E) + R_f[..., None]
    sysd.D_f = torch.where(rowmask, torch.clamp_min(D_f, 1e-12), 1.0)
    if sysd.srows is not None:
        from mujoco_rl_ur5_tpu_torch.physics.dynamics import minv_apply

        Js, aref_s, _, act_s, _, R_s = sysd.srows
        sysd.b_s = torch.einsum("bsv,bv->bs", Js, qacc_smooth) - aref_s
        S = Js.shape[1]
        AinvJsT = torch.stack([minv_apply(model, minv, Js[:, s])
                               for s in range(S)], 1)
        diag = (Js * AinvJsT).sum(-1)
        sysd.D_s = torch.where(act_s, torch.clamp_min(diag + R_s, 1e-12), 1.0)
    return sysd


@spanned("constraints", device=True)
def constraint_forces(model: Model, state: State, kin: Kin,
                      minv: torch.Tensor, qacc_smooth: torch.Tensor,
                      ncon: int, iterations: int, warm=None):
    """Solve for the constraint impulses; returns (qfrc (B, nv), ContactSet,
    warm'). ``warm`` is the previous step's solution in candidate space,
    (facet forces (B, ncand, NFACET), scalar-row forces (B, S)), from
    ``init_warm`` or the previous call; None starts cold."""
    t = model.topo
    sysd = _assemble(model, state, kin, minv, qacc_smooth, ncon)
    con, rowmask = sysd.con, sysd.rowmask
    B, K = con.dist.shape
    count("constraints.live_rows", rowmask)
    count("constraints.rows", rowmask.numel())
    scal = sysd.srows is not None
    S = sysd.srows[0].shape[1] if scal else 0
    act_s = sysd.srows[3] if scal else None

    # Jacobi-preconditioned coordinates z = D^1/2 x
    Pf = 1.0 / torch.sqrt(sysd.D_f)
    Ps = (1.0 / torch.sqrt(torch.clamp_min(sysd.D_s, 1e-12)) if scal
          else minv.new_zeros(B, 0))
    bt_f = Pf * sysd.bm
    bt_s = Ps * torch.where(act_s, sysd.b_s, 0.0) if scal else Ps

    def pc_matvec(z, zs):
        a_f, a_s = sysd.matvec(Pf * z, Ps * zs)
        return Pf * a_f, Ps * a_s

    def sq(a, a_s):                      # per-scenario squared norm
        return (a * a).sum((1, 2)) + (a_s * a_s).sum(1)

    # step 1 / lambda_max from 10 power iterations, started on both facet
    # parity classes (1 + 0.5 sgn): the dominant eigenvector of the facet
    # operator can be nearly antisymmetric across each +- pair
    v = rowmask.to(Pf.dtype) * (1.0 + 0.5 * const(FACET_SGN, Pf))
    vs = (torch.where(act_s, 1.0, 0.0) * (1.0 + 0.5 * const(
        np.where(np.arange(S) % 2 == 0, 1.0, -1.0), Pf)) if scal else Ps)
    nrm = torch.clamp_min(torch.sqrt(sq(v, vs)), 1e-12)
    v, vs = v / nrm[:, None, None], vs / nrm[:, None]
    for _ in range(10):
        a_f, a_s = pc_matvec(v, vs)
        nrm = torch.clamp_min(torch.sqrt(sq(a_f, a_s)), 1e-12)
        v, vs = a_f / nrm[:, None, None], a_s / nrm[:, None]
    step = 1.0 / torch.clamp_min(1.25 * nrm, 1e-6)

    if warm is not None:
        f = sysd.project_f(_gather_rows(warm[0], con.sel)) / Pf
        fs = sysd.project_s(warm[1]) / Ps if scal else warm[1]
    else:
        f = Pf.new_zeros(B, K, NFACET)
        fs = Pf.new_zeros(B, S)

    # FISTA with O'Donoghue-Candes gradient restart, and step halving after
    # two consecutive > 2x jumps of the update (the power iteration can
    # still underestimate lambda_max)
    y, ys = f, fs
    tk = Pf.new_ones(B)
    dprev = Pf.new_full((B,), float("inf"))
    grow = torch.zeros(B, dtype=torch.long, device=Pf.device)
    for _ in range(iterations):
        a_f, a_s = pc_matvec(y, ys)
        f_new = sysd.project_f(y - step[:, None, None] * (a_f + bt_f))
        fs_new = (sysd.project_s(ys - step[:, None] * (a_s + bt_s)) if scal
                  else fs)
        df, dfs = f_new - f, fs_new - fs
        delta = sq(df, dfs)
        grow = torch.where(delta > 4.0 * dprev + 1e-30, grow + 1, 0)
        diverging = grow >= 2
        restart = (((y - f_new) * df).sum((1, 2))
                   + ((ys - fs_new) * dfs).sum(1)) > 0.0
        reset = restart | diverging
        t_new = torch.where(reset, 1.0, 0.5 * (1.0 + torch.sqrt(
            1.0 + 4.0 * tk * tk)))
        mom = torch.where(reset, 0.0, (tk - 1.0) / t_new)
        y = f_new + mom[:, None, None] * df
        ys = fs_new + mom[:, None] * dfs if scal else ys
        step = torch.where(diverging, 0.5 * step, step)
        grow = torch.where(diverging, 0, grow)
        f, fs, tk, dprev = f_new, fs_new, t_new, delta
    x = sysd.project_f(Pf * f)
    f_s = sysd.project_s(Ps * fs) if scal else fs

    # the total force in the 6-row contact basis (normal, two tangents,
    # torsion, two rolling)
    f_con = torch.einsum("bkij,bkj->bki", sysd.E, x)
    qfrc = sysd.scatter_forces(f_con)[:, : t.ntree].reshape(B, -1)[
        :, ix(t.dof_tree * t.mtdof + t.dof_treeidx, x.device)]
    if scal:
        qfrc = qfrc + torch.einsum("bsv,bs->bv", sysd.srows[0], f_s)
    warm_f = x.new_zeros(B, n_candidates(model), NFACET)
    warm_f = warm_f.scatter(1, con.sel[..., None].expand(B, K, NFACET), x)
    return qfrc, replace(con, forces=f_con), (warm_f, f_s)


def n_candidates(model: Model) -> int:
    """Candidate points after the broadphase cap: the warm state's length."""
    return sum(min(len(idx), BROADPHASE_CAP) * collision.pair_points(a, b)
               for a, b, idx in model.topo.pair_groups)


def init_warm(model: Model, state: State):
    """A zero warm start: (facet forces (B, ncand, NFACET), scalar-row
    forces (B, S)) on the state's device."""
    t = model.topo
    B = state.qpos.shape[0]
    S = t.neq + 2 * t.nlimit
    z = state.qvel.new_zeros
    return z(B, n_candidates(model), NFACET), z(B, S)
