"""The arm chain's plain dynamics in numpy: ``chain_fk``, ``chain_mass_bias``
and ``chain_step`` of ``chain.py`` (the frozen copy of the program's plain
chain dynamics) written over numpy arrays, for the reference solver's
rollouts, which step the chain 512 times per rollout and are bound by the
cost of each small operation. Same arithmetic, the solve a plain LU solve
of the SPD system. ``tf32`` rounds the operands of every product of two
state-dependent matrices to TF32 first (the control's precision).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.physics.chain import ChainPlan


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    keep = 13
    half = (1 << (keep - 1)) - 1 + ((i >> keep) & 1)
    r = (((i + half) >> keep) << keep).view(np.float32)
    return np.where(np.isfinite(x), r, x)


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


class Chain:
    """``plan``'s dynamics in ``dtype``."""

    def __init__(self, plan: ChainPlan, dtype=np.float64, tf32=False):
        self.p, self.dt, self.tf32 = plan, np.dtype(dtype), tf32
        c = self.c = lambda a: np.asarray(a, np.float64).astype(self.dt)
        p = plan
        self.joint = []
        for i in range(p.nmov):
            ax = p.jnt_axis[i]
            K = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                          [-ax[1], ax[0], 0.0]])
            aa = np.outer(ax, ax)
            self.joint.append((c(np.eye(3) - aa), c(K), c(aa),
                               c(p.jnt_pos[i]), c(ax)))
        self.root = []
        for i in range(p.nmov):
            pr0 = p.parent_pose[i, 3:].reshape(3, 3)
            self.root.append((c(p.parent_pose[i, :3] + pr0 @ p.body_pos[i]),
                              c(pr0 @ p.body_rot[i])))
        self.eye3 = c(np.eye(3))

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return np.matmul(a, b)

    def fk(self, q):
        p, c, mm = self.p, self.c, self.mm
        xpos, xrot = [], []
        anchor, axis = [None] * p.nv, [None] * p.nv
        n = q.shape[:-1]
        for i in range(p.nmov):
            ps = int(p.parent_slot[i])
            if ps >= 0:
                pr = xrot[ps]
                p_pre = xpos[ps] + mm(pr, c(p.body_pos[i]))
                r_pre = mm(pr, c(p.body_rot[i]))
            else:
                p_pre = np.broadcast_to(self.root[i][0], n + (3,))
                r_pre = np.broadcast_to(self.root[i][1], n + (3, 3))
            d = int(p.jnt_dof[i])
            if d >= 0:
                ia, K, aa, jp, ax = self.joint[i]
                th = q[..., int(p.qadr[d])] - c(p.jnt_ref[i])
                rj = (np.cos(th)[..., None, None] * ia
                      + np.sin(th)[..., None, None] * K + aa)
                anchor[d] = p_pre + mm(r_pre, jp)
                pos = p_pre + mm(r_pre, (jp - mm(rj, jp))[..., None])[..., 0]
                rot = mm(r_pre, rj)
                axis[d] = mm(rot, ax)
            else:
                pos, rot = p_pre, r_pre
            xpos.append(pos)
            xrot.append(rot)
        return (np.stack(xpos, -2), np.stack(xrot, -3), np.stack(anchor, -2),
                np.stack(axis, -2))

    @staticmethod
    def _imul(i, v):
        m, h = i[..., 0:1], i[..., 1:4]
        w, vl = v[..., :3], v[..., 3:]
        iw = np.stack([
            i[..., 4] * w[..., 0] + i[..., 7] * w[..., 1] + i[..., 8] * w[..., 2],
            i[..., 7] * w[..., 0] + i[..., 5] * w[..., 1] + i[..., 9] * w[..., 2],
            i[..., 8] * w[..., 0] + i[..., 9] * w[..., 1] + i[..., 6] * w[..., 2],
        ], -1)
        return np.concatenate([iw + _cross(h, vl), m * vl - _cross(h, w)],
                              -1)

    def mass_bias(self, q, v):
        p, c, mm = self.p, self.c, self.mm
        xpos, xrot, anchor, ax = self.fk(q)
        org = c(p.org)
        cdof = np.concatenate([ax, _cross(anchor - org, ax)], -1)
        ri = mm(xrot, c(p.irot))
        icom = mm(ri * c(p.idiag)[:, None, :], np.swapaxes(ri, -1, -2))
        com = xpos + mm(xrot, c(p.ipos)[..., None])[..., 0]
        cc = com - org
        mass = c(p.mass)
        outer = cc[..., :, None] * cc[..., None, :]
        c2 = (cc * cc).sum(-1)[..., None, None]
        iorg = icom + mass[:, None, None] * (c2 * self.eye3 - outer)
        cinert = np.concatenate([
            np.broadcast_to(mass, cc.shape[:-1])[..., None],
            mass[:, None] * cc, iorg[..., 0, 0, None], iorg[..., 1, 1, None],
            iorg[..., 2, 2, None], iorg[..., 0, 1, None],
            iorg[..., 0, 2, None], iorg[..., 1, 2, None]], -1)
        crb = mm(c(p.sub_body), cinert)
        fmom = self._imul(crb[..., p.dof_slot, :], cdof)
        mlow = c(p.m_mask) * mm(fmom, np.swapaxes(cdof, -1, -2))
        dg = np.diagonal(mlow, axis1=-2, axis2=-1)
        M = (mlow + np.swapaxes(mlow, -1, -2)
             - dg[..., :, None] * self.c(np.eye(p.nv))
             + np.diag(c(p.armature)))
        vbody = mm(c(p.anc_dof), cdof * v[..., None])
        zero6 = np.zeros_like(vbody[..., 0, :])
        pv = np.stack([vbody[..., int(s), :] if s >= 0 else zero6
                       for s in p.dof_parent_slot], -2)
        cdofdot = np.concatenate([
            _cross(pv[..., :3], cdof[..., :3]),
            _cross(pv[..., :3], cdof[..., 3:])
            + _cross(pv[..., 3:], cdof[..., :3])], -1)
        a0 = np.concatenate([np.zeros(3, self.dt), -c(p.gravity)])
        abody = a0 + mm(c(p.anc_dof), cdofdot * v[..., None])
        iv = self._imul(cinert, vbody)
        fb = self._imul(cinert, abody) + np.concatenate([
            _cross(vbody[..., :3], iv[..., :3])
            + _cross(vbody[..., 3:], iv[..., 3:]),
            _cross(vbody[..., :3], iv[..., 3:])], -1)
        fsub = mm(c(p.dof_sub_body), fb)
        return M, (cdof * fsub).sum(-1)

    def hold(self, q):
        """Gravity-compensation controls, clipped to the actuator range."""
        p, c = self.p, self.c
        _, bias = self.mass_bias(q, np.zeros_like(q))
        u = bias[..., p.act_dof] / c(p.gear)
        return np.clip(u, c(p.ctrlrange[:, 0]), c(p.ctrlrange[:, 1]))

    def step(self, q, v, ctrl):
        """One semi-implicit Euler step with implicit joint damping and the
        implicit equality springs."""
        p, c = self.p, self.c
        h = p.timestep
        M, bias = self.mass_bias(q, v)
        u = np.clip(ctrl, c(p.ctrlrange[:, 0]), c(p.ctrlrange[:, 1]))
        tau = self.mm(u * c(p.gear), c(p.act_mat).T)
        damp = c(p.damping)
        qfrc = tau - bias - damp * v
        a = M + c(h) * np.diag(damp)
        eye = np.eye(p.nv)
        for e in range(len(p.eq_d1)):
            d1, d2 = int(p.eq_d1[e]), int(p.eq_d2[e])
            pc = p.eq_poly[e]
            k, cd = float(p.eq_kc[e, 0]), float(p.eq_kc[e, 1])
            pp = c(pc)
            dp = c([pc[1], 2 * pc[2], 3 * pc[3], 4 * pc[4]])
            x2 = q[..., d2] - c(p.eq_q02[e])
            poly = (pp[0] + pp[1] * x2 + pp[2] * x2 ** 2 + pp[3] * x2 ** 3
                    + pp[4] * x2 ** 4)
            dpoly = dp[0] + dp[1] * x2 + dp[2] * x2 ** 2 + dp[3] * x2 ** 3
            r = (q[..., d1] - c(p.eq_q01[e])) - poly
            rdot = v[..., d1] - dpoly * v[..., d2]
            g = c(eye[d1]) - dpoly[..., None] * c(eye[d2])
            qfrc = qfrc - (c(k) * r + c(h * k + cd) * rdot)[..., None] * g
            a = a + c(h * (h * k + cd)) * (g[..., :, None] * g[..., None, :])
        qacc = np.linalg.solve(a, qfrc[..., None])[..., 0]
        v2 = v + c(h) * qacc
        return q + c(h) * v2, v2
