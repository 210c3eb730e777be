"""Fused arm dynamics: the grasp-MPC hot path as hand-written CUDA kernels.

A solve steps the 8-dof arm thousands of times in sequence; as plain torch
each generated substep is about 4.3k small tensor operations, so a rollout is
launch-bound. The port keeps the JAX package's remedy and moves it to
Hopper:

  * **Symbolic scalar layer.** Entries are Python floats (constants of the
    plan) or values; ``smul``/``sadd``/... fold constants, so topology zeros
    and ones vanish from the emitted code. A value is either a torch tensor
    (the plain versions below run the generated physics directly on tensors
    of any shape) or a :class:`Var`, an SSA name in emitted C++.
  * **Generated substep.** ``make_substep`` writes FK, CRBA, RNE, the
    equality springs, the Jacobi-equilibrated unrolled Cholesky solve and
    semi-implicit Euler as straight-line code with the plan's constants
    folded (each joint's cosine and sine from one ``sincosf``).
    ``substep_header`` emits it once as a ``__device__`` function
    (``chain_substep.cuh``); ``cost_header`` does the same for the fused
    line-search costs (``chain_cost.cuh``).
  * **Kernels** (``csrc/chain_*.cu``, written by hand around those
    headers): ``rollout_open``, ``lin_fd`` (the forward differences, with
    ``lin_fd_fast``'s composition of one-substep Jacobians in the same
    launch) and ``rollout_closed``. Each calls the one-substep function
    inside runtime loops, so nvcc compiles one substep, as Mosaic did for
    the TPU kernels. ``rollout_open`` runs instead a team of ``OPEN_TEAM``
    lanes per scenario, each owning a dof and its body, on the plan recast
    per dof and padded to a whole team (``team_plan``; its constants in
    ``team_header``, ``chain_team.cuh``), with generic code over those
    constants.
  * **Reach quadratization.** ``make_ee_quad`` builds the Gauss-Newton
    blocks of the end-effector reach cost (FK, geometric Jacobians, outer
    products) and its gradient over the same entries; ``ee_quad_header``
    emits it (``chain_ee_quad.cuh``) for the ``ee_quad_gn`` kernel, which
    writes the solver's full stage blocks X and g.

Every kernel wrapper has its plain version beside it: a CPU tensor runs
the plain version; a CUDA tensor launches the kernel (and counts the
launch in ``<wrapper>.launches``) or raises. The port's counterpart of the
JAX package's physics/pallas_chain.py.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from mujoco_rl_ur5_tpu_torch import _build
from mujoco_rl_ur5_tpu_torch.physics.chain import ChainPlan
from mujoco_rl_ur5_tpu_torch.trace import spanned

EPS = 1e-3          # forward-difference step of lin_fd (rad, rad/s, ctrl)
_FD_CHUNK = 1 << 15  # instances per pass of lin_fd_plain (bounds its memory)

# -- symbolic scalar layer ----------------------------------------------------


def _isf(x) -> bool:
    return isinstance(x, float)


def _c(x) -> float:
    """Snap tiny parser noise to an exact zero so it folds."""
    x = float(x)
    return 0.0 if abs(x) < 1e-13 else x


def smul(a, b):
    if _isf(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
    if _isf(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def sadd(*terms):
    live = [t for t in terms if not (_isf(t) and t == 0.0)]
    consts = [t for t in live if _isf(t)]
    vals = [t for t in live if not _isf(t)]
    acc = None
    if consts:
        s = float(sum(consts))
        if s != 0.0 or not vals:
            acc = s
    for a in vals:
        acc = a if acc is None else acc + a
    return 0.0 if acc is None else acc


def sneg(a):
    return -a


def ssub(a, b):
    return sadd(a, sneg(b))


def sdot(a, b):
    return sadd(*[smul(x, y) for x, y in zip(a, b)])


def smv(M, v):
    return [sdot(row, v) for row in M]


def smm(A, B):
    return [[sadd(*[smul(A[i][k], B[k][j]) for k in range(len(B))])
             for j in range(len(B[0]))] for i in range(len(A))]


def scross(a, b):
    return [ssub(smul(a[1], b[2]), smul(a[2], b[1])),
            ssub(smul(a[2], b[0]), smul(a[0], b[2])),
            ssub(smul(a[0], b[1]), smul(a[1], b[0]))]


def svadd(a, b):
    return [sadd(x, y) for x, y in zip(a, b)]


def svsub(a, b):
    return [ssub(x, y) for x, y in zip(a, b)]


def svscale(s, v):
    return [smul(s, x) for x in v]


def scos(x):
    return math.cos(x) if _isf(x) else x.cos()


def ssin(x):
    return math.sin(x) if _isf(x) else x.sin()


def ssincos(x):
    """(cos x, sin x); emitted C++ takes both from one sincosf call."""
    if isinstance(x, Var):
        return x.sincos()
    return scos(x), ssin(x)


def ssqrt(x):
    return math.sqrt(x) if _isf(x) else x.sqrt()


def srsqrt(x):
    return 1.0 / math.sqrt(x) if _isf(x) else x.rsqrt()


def smax(x, c: float):
    return max(x, c) if _isf(x) else x.clamp_min(c)


def sclip(x, lo: float, hi: float):
    return min(max(x, lo), hi) if _isf(x) else x.clamp(lo, hi)


def _cmat(M) -> list:
    return [[_c(M[i][j]) for j in range(len(M[0]))] for i in range(len(M))]


def _cvec(v) -> list:
    return [_c(x) for x in v]


# -- C++ emission -------------------------------------------------------------


def _lit(x) -> str:
    if isinstance(x, Var):
        return x.name
    f = float(np.float32(x))
    if not math.isfinite(f):
        raise ValueError(f"non-finite constant {x} in generated code")
    s = repr(f) + "f"
    return f"({s})" if s.startswith("-") else s


class _Emitter:
    """Collects SSA statements ``const float tN = ...;`` and counts the
    arithmetic operations they perform; each value also carries its depth,
    the longest chain of dependent operations that leads to it (an
    operation counts one level, a clamp two, a negation none: it folds into
    its consumer)."""

    def __init__(self):
        self.lines: list[str] = []
        self.ops = 0

    def value(self, expr: str, ops: int = 1, deps=()) -> "Var":
        name = f"t{len(self.lines)}"
        self.lines.append(f"  const float {name} = {expr};")
        self.ops += ops
        return Var(self, name, ops + max((d.depth for d in deps), default=0))

    def inputs(self, array: str, n: int) -> list:
        return [self.value(f"{array}[{i}]", ops=0) for i in range(n)]


def depth(values) -> int:
    """The deepest of emitted values (floats, the folded constants: 0)."""
    return max((x.depth for x in values if isinstance(x, Var)), default=0)


class Var:
    """A scalar value in emitted C++: arithmetic emits a new statement.
    Mirrors the few torch.Tensor methods the generated physics calls."""

    __slots__ = ("em", "name", "depth")

    def __init__(self, em: _Emitter, name: str, depth: int = 0):
        self.em, self.name, self.depth = em, name, depth

    def _bin(self, op, a, b):
        return self.em.value(f"{_lit(a)} {op} {_lit(b)}",
                             deps=[x for x in (a, b) if isinstance(x, Var)])

    def _un(self, expr: str, ops: int = 1):
        return self.em.value(expr, ops, (self,))

    def __add__(self, o): return self._bin("+", self, o)
    def __radd__(self, o): return self._bin("+", o, self)
    def __mul__(self, o): return self._bin("*", self, o)
    def __rmul__(self, o): return self._bin("*", o, self)
    def __rtruediv__(self, o): return self._bin("/", o, self)
    def __neg__(self): return self._un(f"-{self.name}", ops=0)
    def cos(self): return self._un(f"cosf({self.name})")
    def sin(self): return self._un(f"sinf({self.name})")
    def sqrt(self): return self._un(f"sqrtf({self.name})")
    def rsqrt(self): return self._un(f"rsqrtf({self.name})")

    def sincos(self):
        n = f"t{len(self.em.lines)}"
        self.em.lines.append(f"  float {n}c, {n}s; "
                             f"sincosf({self.name}, &{n}s, &{n}c);")
        self.em.ops += 2
        return (Var(self.em, n + "c", self.depth + 1),
                Var(self.em, n + "s", self.depth + 1))

    def clamp_min(self, c):
        return self._un(f"fmaxf({self.name}, {_lit(c)})")

    def clamp(self, lo, hi):
        return self._un(f"fminf(fmaxf({self.name}, {_lit(lo)}), {_lit(hi)})",
                        ops=2)


@dataclass(frozen=True)
class Generated:
    """An emitted header and the operations its functions perform."""

    text: str
    ops: dict


# -- generated substep --------------------------------------------------------


def make_fk(plan: ChainPlan):
    """Symbolic FK over entry lists: fk(q) -> (xpos, xrot, anchor, axis_w)
    per slot / per dof. Shared by the substep and the fused costs."""
    nv, nmov = plan.nv, plan.nmov
    body_pos = [_cvec(p) for p in plan.body_pos]
    body_rot = [_cmat(r) for r in plan.body_rot]
    parent_slot = [int(s) for s in plan.parent_slot]
    parent_p = [_cvec(p[:3]) for p in plan.parent_pose]
    parent_r = [_cmat(p[3:].reshape(3, 3)) for p in plan.parent_pose]
    jnt_dof = [int(d) for d in plan.jnt_dof]
    jnt_pos = [_cvec(p) for p in plan.jnt_pos]
    jnt_axis = [_cvec(a) for a in plan.jnt_axis]
    jnt_ref = [_c(r) for r in plan.jnt_ref]

    def fk(q):
        xpos, xrot = [], []
        anchor = [None] * nv
        axis_w = [None] * nv
        for i in range(nmov):
            ps = parent_slot[i]
            if ps >= 0:
                pp, pr = xpos[ps], xrot[ps]
            else:
                pp, pr = parent_p[i], parent_r[i]
            p_pre = svadd(pp, smv(pr, body_pos[i]))
            r_pre = smm(pr, body_rot[i])
            d = jnt_dof[i]
            if d >= 0:
                th = ssub(q[d], jnt_ref[i])
                cth, sth = ssincos(th)
                ax = jnt_axis[i]
                aa = [[_c(ax[a] * ax[b]) for b in range(3)]
                      for a in range(3)]
                K = [[0.0, -ax[2], ax[1]],
                     [ax[2], 0.0, -ax[0]],
                     [-ax[1], ax[0], 0.0]]
                rj = [[sadd(aa[a][b],
                            smul(cth,
                                 _c((1.0 if a == b else 0.0) - aa[a][b])),
                            smul(sth, _c(K[a][b])))
                       for b in range(3)] for a in range(3)]
                jp = jnt_pos[i]
                anchor[d] = svadd(p_pre, smv(r_pre, jp))
                p = svadd(p_pre, smv(r_pre, svsub(jp, smv(rj, jp))))
                r = smm(r_pre, rj)
                axis_w[d] = smv(r, ax)
            else:
                p, r = p_pre, r_pre
            xpos.append(p)
            xrot.append(r)
        return xpos, xrot, anchor, axis_w

    return fk


def make_substep(plan: ChainPlan):
    """substep(q, v, u) -> (q2, v2) over entry lists: the semantics of
    physics/chain.chain_step with every model constant folded."""
    nv, nmov = plan.nv, plan.nmov
    h = float(plan.timestep)
    grav = _cvec(plan.gravity)
    damping = _cvec(plan.damping)
    armature = _cvec(plan.armature)
    gear = _cvec(plan.gear)
    lo = _cvec(plan.ctrlrange[:, 0])
    hi = _cvec(plan.ctrlrange[:, 1])
    org = _cvec(plan.org)
    anc = plan.anc_dof.astype(bool)            # (nmov, nv)
    subb = plan.sub_body.astype(bool)          # (nmov, nmov)
    dof_subb = plan.dof_sub_body.astype(bool)  # (nv, nmov)
    mmask = plan.m_mask.astype(bool)           # (nv, nv)
    act_dof = [int(d) for d in plan.act_dof]
    ipos = [_cvec(p) for p in plan.ipos]
    irot = [_cmat(r) for r in plan.irot]
    idiag = [_cvec(d) for d in plan.idiag]
    mass = [_c(m) for m in plan.mass]
    dof_slot = [int(s) for s in plan.dof_slot]
    dof_parent = [int(s) for s in plan.dof_parent_slot]
    eqs = [(int(plan.eq_d1[e]), int(plan.eq_d2[e]),
            [_c(p) for p in plan.eq_poly[e]],
            _c(plan.eq_q01[e]), _c(plan.eq_q02[e]),
            float(plan.eq_kc[e, 0]), float(plan.eq_kc[e, 1]))
           for e in range(len(plan.eq_d1))]
    # solver sparsity: tree coupling plus the equality pairs
    smask = [[bool(mmask[i][j]) or bool(mmask[j][i]) for j in range(nv)]
             for i in range(nv)]
    for d1, d2, *_ in eqs:
        smask[d1][d2] = smask[d2][d1] = True
    fk = make_fk(plan)

    def imul(inert, v6):
        """10-parameter spatial inertia times a motion 6-vector."""
        m, hx, hy, hz = inert[0], inert[1], inert[2], inert[3]
        ixx, iyy, izz, ixy, ixz, iyz = inert[4:]
        w, vl = v6[:3], v6[3:]
        iw = [sadd(smul(ixx, w[0]), smul(ixy, w[1]), smul(ixz, w[2])),
              sadd(smul(ixy, w[0]), smul(iyy, w[1]), smul(iyz, w[2])),
              sadd(smul(ixz, w[0]), smul(iyz, w[1]), smul(izz, w[2]))]
        hv = [hx, hy, hz]
        return (svadd(iw, scross(hv, vl))
                + svsub(svscale(m, vl), scross(hv, w)))

    def mass_bias(q, v):
        xpos, xrot, anchor, axis_w = fk(q)
        cdof = [axis_w[d] + scross(svsub(anchor[d], org), axis_w[d])
                for d in range(nv)]
        cinert = []
        for i in range(nmov):
            ri = smm(xrot[i], irot[i])
            rd = [[smul(ri[a][b], idiag[i][b]) for b in range(3)]
                  for a in range(3)]
            icom = [[sdot(rd[a], ri[b]) for b in range(3)] for a in range(3)]
            cv = svsub(svadd(xpos[i], smv(xrot[i], ipos[i])), org)
            c2 = sdot(cv, cv)
            m = mass[i]
            iorg = [[sadd(icom[a][b],
                          smul(m, ssub(c2 if a == b else 0.0,
                                       smul(cv[a], cv[b]))))
                     for b in range(3)] for a in range(3)]
            cinert.append([m] + svscale(m, cv)
                          + [iorg[0][0], iorg[1][1], iorg[2][2],
                             iorg[0][1], iorg[0][2], iorg[1][2]])
        # CRBA
        crb = [[sadd(*[cinert[b][k] for b in range(nmov) if subb[s][b]])
                for k in range(10)] for s in range(nmov)]
        fmom = [imul(crb[dof_slot[d]], cdof[d]) for d in range(nv)]
        A = [[0.0] * nv for _ in range(nv)]
        for i in range(nv):
            for j in range(i + 1):
                if mmask[i][j]:
                    A[i][j] = sdot(fmom[i], cdof[j])
                    A[j][i] = A[i][j]
            A[i][i] = sadd(A[i][i], armature[i], h * damping[i])
        # RNE at qacc = 0
        contrib = [svscale(v[d], cdof[d]) for d in range(nv)]
        vbody = [[sadd(*[contrib[d][k] for d in range(nv) if anc[s][d]])
                  for k in range(6)] for s in range(nmov)]
        a0 = [0.0, 0.0, 0.0] + [sneg(g) for g in grav]
        acontrib = []
        for d in range(nv):
            pv = [0.0] * 6 if dof_parent[d] < 0 else vbody[dof_parent[d]]
            cd = cdof[d]
            cdd = (scross(pv[:3], cd[:3])
                   + svadd(scross(pv[:3], cd[3:]), scross(pv[3:], cd[:3])))
            acontrib.append(svscale(v[d], cdd))
        fb = []
        for s in range(nmov):
            acc = list(a0)
            for d in range(nv):
                if anc[s][d]:
                    acc = svadd(acc, acontrib[d])
            iv = imul(cinert[s], vbody[s])
            f6 = imul(cinert[s], acc)
            w, vl = vbody[s][:3], vbody[s][3:]
            fb.append(svadd(f6, svadd(scross(w, iv[:3]), scross(vl, iv[3:]))
                            + scross(w, iv[3:])))
        bias = []
        for d in range(nv):
            fsub = [sadd(*[fb[b][k] for b in range(nmov) if dof_subb[d][b]])
                    for k in range(6)]
            bias.append(sdot(cdof[d], fsub))
        return A, bias

    def solve_scaled(A, b):
        """Jacobi-equilibrated unrolled Cholesky solve; topology zeros of A
        fold out of the factorization."""
        s = [srsqrt(smax(A[i][i], 1e-30)) for i in range(nv)]
        As = [[smul(smul(A[i][j], s[i]), s[j]) if smask[i][j] else 0.0
               for j in range(nv)] for i in range(nv)]
        bs = [smul(b[i], s[i]) for i in range(nv)]
        L = [[0.0] * nv for _ in range(nv)]
        Linv_d = [None] * nv
        for j in range(nv):
            d = ssub(As[j][j], sadd(*[smul(L[j][k], L[j][k])
                                      for k in range(j)]))
            Ld = ssqrt(smax(d, 1e-12))
            L[j][j] = Ld
            Linv_d[j] = 1.0 / Ld
            for i in range(j + 1, nv):
                off = ssub(As[i][j], sadd(*[smul(L[i][k], L[j][k])
                                            for k in range(j)]))
                L[i][j] = smul(off, Linv_d[j])
        y = [None] * nv
        for i in range(nv):
            y[i] = smul(ssub(bs[i], sadd(*[smul(L[i][k], y[k])
                                           for k in range(i)])), Linv_d[i])
        x = [None] * nv
        for i in reversed(range(nv)):
            x[i] = smul(ssub(y[i], sadd(*[smul(L[k][i], x[k])
                                          for k in range(i + 1, nv)])),
                        Linv_d[i])
        return [smul(x[i], s[i]) for i in range(nv)]

    def substep(q: Sequence, v: Sequence, u: Sequence):
        A, bias = mass_bias(q, v)
        tau = [0.0] * nv
        for j, d in enumerate(act_dof):
            tau[d] = smul(gear[j], sclip(u[j], lo[j], hi[j]))
        qfrc = [ssub(tau[i], sadd(bias[i], smul(damping[i], v[i])))
                for i in range(nv)]
        for d1, d2, pc, q01, q02, k, cd in eqs:
            x2 = ssub(q[d2], q02)
            poly = sadd(pc[0], smul(pc[1], x2),
                        smul(pc[2], smul(x2, x2)),
                        smul(pc[3], smul(x2, smul(x2, x2))),
                        smul(pc[4], smul(smul(x2, x2), smul(x2, x2))))
            dpoly = sadd(pc[1], smul(2.0 * pc[2], x2),
                         smul(3.0 * pc[3], smul(x2, x2)),
                         smul(4.0 * pc[4], smul(x2, smul(x2, x2))))
            r = ssub(ssub(q[d1], q01), poly)
            rdot = ssub(v[d1], smul(dpoly, v[d2]))
            fm = sneg(sadd(smul(k, r), smul(h * k + cd, rdot)))
            qfrc[d1] = sadd(qfrc[d1], fm)
            qfrc[d2] = sadd(qfrc[d2], sneg(smul(dpoly, fm)))
            w = h * (h * k + cd)
            A[d1][d1] = sadd(A[d1][d1], w)
            A[d2][d2] = sadd(A[d2][d2], smul(w, smul(dpoly, dpoly)))
            off = sneg(smul(w, dpoly))
            A[d1][d2] = sadd(A[d1][d2], off)
            A[d2][d1] = sadd(A[d2][d1], off)
        qacc = solve_scaled(A, qfrc)
        v2 = [sadd(v[i], smul(h, qacc[i])) for i in range(nv)]
        q2 = [sadd(q[i], smul(h, v2[i])) for i in range(nv)]
        return q2, v2

    return substep


@functools.lru_cache(maxsize=None)
def _substep(plan: ChainPlan):
    return make_substep(plan)


def make_knot_step(plan: ChainPlan, substeps: int):
    """One MPC knot = ``substeps`` generated substeps under the same u."""
    substep = _substep(plan)

    def knot(q, v, u):
        for _ in range(substeps):
            q, v = substep(q, v, u)
        return q, v

    return knot


# -- emitted headers ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def substep_header(plan: ChainPlan) -> Generated:
    """``chain_substep.cuh``: the substep and the control clip as
    ``__device__`` functions over register arrays."""
    nv, nu = plan.nv, plan.nu
    em = _Emitter()
    q, v, u = em.inputs("q", nv), em.inputs("v", nv), em.inputs("u", nu)
    q2, v2 = _substep(plan)(q, v, u)
    stores = ([f"  q[{i}] = {_lit(x)};" for i, x in enumerate(q2)]
              + [f"  v[{i}] = {_lit(x)};" for i, x in enumerate(v2)])
    clip = [f"  u[{j}] = fminf(fmaxf(u[{j}], {_lit(lo)}), {_lit(hi)});"
            for j, (lo, hi) in enumerate(plan.ctrlrange)]
    text = "\n".join([
        "// Generated by mujoco_rl_ur5_tpu_torch/physics/cuda_chain.py",
        "#pragma once",
        f"#define CHAIN_NV {nv}",
        f"#define CHAIN_NU {nu}",
        "__device__ __forceinline__ void chain_substep(",
        "    float* __restrict__ q, float* __restrict__ v,",
        "    const float* __restrict__ u) {",
        *em.lines, *stores, "}",
        "__device__ __forceinline__ void chain_clip_ctrl(float* u) {",
        *clip, "}", ""])
    return Generated(text, {"substep": em.ops, "clip": 2 * nu,
                            "depth": depth(q2 + v2)})


@functools.lru_cache(maxsize=None)
def cost_header(cost, nv: int, nu: int, R: int, RT: int) -> Generated:
    """``chain_cost.cuh``: the fused stage and terminal costs (a pair of
    symbolic builders, or None for no cost) as ``__device__`` functions."""
    out, ops = [], {}
    for which, args in (("stage", (("q", nv), ("v", nv), ("u", nu),
                                   ("sr", R), ("tr", RT))),
                        ("term", (("q", nv), ("v", nv), ("tr", RT)))):
        em = _Emitter()
        ins = [em.inputs(n, k) for n, k in args]
        res = 0.0 if cost is None else cost[which == "term"](*ins)
        sig = ", ".join(f"const float* __restrict__ {n}" for n, _ in args)
        out += [f"__device__ __forceinline__ float chain_{which}_cost({sig}) "
                "{", *em.lines, f"  return {_lit(res)};", "}"]
        ops[which] = em.ops
    text = "\n".join([
        "// Generated by mujoco_rl_ur5_tpu_torch/physics/cuda_chain.py",
        "#pragma once",
        f"#define CHAIN_NSR {R}",
        f"#define CHAIN_NTR {RT}",
        f"#define CHAIN_NSR_ALLOC {max(R, 1)}",
        f"#define CHAIN_NTR_ALLOC {max(RT, 1)}",
        *out, ""])
    return Generated(text, ops)


def make_ee_quad(plan: ChainPlan, slot: int, off: tuple, w_ee: float,
                 w_orient: float, w_posture: float, w_vel: float,
                 home: tuple):
    """quad(q, qd, tgt) -> (Xu, g) over entry lists: the Gauss-Newton blocks
    of the reach stage cost at body slot ``slot``.

        Xq = w_ee J'J + w_orient Ja'Ja + w_posture I
        g  = [w_ee J'e + w_orient Ja'a + w_posture (q - home), w_vel qd]

    with e = p - off - tgt, a = xaxis - (0, 0, -1) and the geometric
    Jacobians J[:, d] = z_d x (p - anchor_d), Ja[:, d] = z_d x xaxis for the
    dofs that move the body. ``Xu`` holds the nv (nv + 1) / 2 distinct
    entries of the symmetric Xq, row by row from the diagonal; dofs that do
    not move the body give constant entries (floats). The stage Hessian is
    Xq beside w_vel on the velocity diagonal (``ee_quad_gn``)."""
    nv = plan.nv
    fk = make_fk(plan)
    offc = [float(o) for o in off]
    homec = [float(h) for h in home]
    anc = [bool(a) for a in plan.anc_dof[slot]]

    def quad(q: Sequence, qd: Sequence, tgt: Sequence):
        xpos, xrot, anchor, axis_w = fk(q)
        praw = xpos[slot]
        e = [ssub(ssub(praw[i], offc[i]), tgt[i]) for i in range(3)]
        xa = [xrot[slot][i][0] for i in range(3)]
        a = [xa[0], xa[1], sadd(xa[2], 1.0)]
        Jp, Ja = [], []
        for d in range(nv):
            if anc[d] and axis_w[d] is not None:
                Jp.append(scross(axis_w[d], svsub(praw, anchor[d])))
                Ja.append(scross(axis_w[d], xa))
            else:
                Jp.append([0.0, 0.0, 0.0])
                Ja.append([0.0, 0.0, 0.0])
        Xu = [sadd(smul(w_ee, sdot(Jp[i], Jp[j])),
                   smul(w_orient, sdot(Ja[i], Ja[j])),
                   w_posture if i == j else 0.0)
              for i in range(nv) for j in range(i, nv)]
        g = [sadd(smul(w_ee, sdot(Jp[i], e)), smul(w_orient, sdot(Ja[i], a)),
                  smul(w_posture, ssub(q[i], homec[i]))) for i in range(nv)]
        return Xu, g + [smul(w_vel, v) for v in qd]

    return quad


@functools.lru_cache(maxsize=None)
def _ee_quad(plan: ChainPlan, *cfg):
    return make_ee_quad(plan, *cfg)


@functools.lru_cache(maxsize=None)
def ee_quad_header(plan: ChainPlan, *cfg) -> Generated:
    """``chain_ee_quad.cuh``: the reach quadratization as a ``__device__``
    function over register arrays (Xu the nv (nv + 1) / 2 distinct entries
    of Xq, g the 2 nv entries of the gradient), with the weights, offset and
    home of ``cfg`` (the arguments of make_ee_quad after the plan) folded,
    and the velocity weight as ``CHAIN_W_VEL``."""
    nv = plan.nv
    w_vel = cfg[5]        # _quad_cfg's order: slot, off, the four weights
    em = _Emitter()
    Xu, g = _ee_quad(plan, *cfg)(em.inputs("q", nv), em.inputs("qd", nv),
                                 em.inputs("tg", 3))
    stores = ([f"  Xu[{i}] = {_lit(x)};" for i, x in enumerate(Xu)]
              + [f"  g[{i}] = {_lit(x)};" for i, x in enumerate(g)])
    text = "\n".join([
        "// Generated by mujoco_rl_ur5_tpu_torch/physics/cuda_chain.py",
        "#pragma once",
        f"#define CHAIN_NV {nv}",
        f"#define CHAIN_W_VEL {_lit(w_vel)}",
        "__device__ __forceinline__ void chain_ee_quad(",
        "    const float* __restrict__ q, const float* __restrict__ qd,",
        "    const float* __restrict__ tg, float* __restrict__ Xu,",
        "    float* __restrict__ g) {",
        *em.lines, *stores, "}", ""])
    return Generated(text, {"quad": em.ops})


# -- the team variant of rollout_open -------------------------------------------

OPEN_TEAM = 8    # lanes per scenario of csrc/chain_rollout_open.cu (its T)


def _team_fields(nroles: int) -> tuple:
    """The per-role float constants of chain_team.cuh, in this order:
    (name, width); the four masks over the roles are nroles wide."""
    return (("BROT", 9), ("BPOS", 3), ("JPOS", 3), ("AXIS", 3), ("AA", 9),
            ("IMAA", 9), ("KX", 9), ("JREF", 1), ("IPOS", 3), ("ILOC", 6),
            ("MASS", 1), ("ADIAG", 1), ("DAMP", 1), ("GEAR", 1), ("LO", 1),
            ("HI", 1), ("WANC", nroles), ("WSUB", nroles), ("WM", nroles),
            ("WS", nroles))


def _team_offsets(nroles: int) -> tuple:
    """({name: offset} of the per-role constants, their width)."""
    off, at = {}, 0
    for name, w in _team_fields(nroles):
        off[name], at = at, at + w
    return off, at


@dataclass(frozen=True)
class TeamPlan:
    """The plan recast for lanes that own one dof each (a role): bodies
    without a joint merged into their parent (transforms composed into the
    children's, mass properties combined), each role's constants in
    ``rows`` (nroles, width of _team_fields), its actuator ``act``, the
    2^k-th ancestor role of each pointer-jumping round ``jump`` (-1 past
    the root), and each equality's dofs and folded constants. The nv real
    roles come first; nroles rounds nv up to a whole team of OPEN_TEAM
    lanes with inert roles: no body, no actuator, no ancestor, and a mass
    matrix row and column of the identity, so their accelerations are 0
    and the real roles' sums only add zeros."""

    nroles: int
    rows: np.ndarray        # (nroles, ncols) float64
    act: tuple              # actuator per role, -1 for none
    jump: tuple             # (rounds, nroles)
    eqs: tuple              # (d1, d2, poly[5], q01, q02, k, hk+cd, h(hk+cd))
    org: tuple
    a0: tuple               # -gravity
    h: float


def _pose(p, R):
    return np.asarray(p, float), np.asarray(R, float)


def _compose(a, b):
    """a then b (b's frame in a's): (pa + Ra pb, Ra Rb)."""
    return a[0] + a[1] @ b[0], a[1] @ b[1]


@functools.lru_cache(maxsize=None)
def team_plan(plan: ChainPlan) -> TeamPlan:
    nv, nmov = plan.nv, plan.nmov
    dof = [int(d) for d in plan.jnt_dof]
    parent = [int(s) for s in plan.parent_slot]
    role_slot = [int(s) for s in plan.dof_slot]
    if sorted(d for d in dof if d >= 0) != list(range(nv)):
        raise ValueError("team rollout: every dof needs its own body")
    local = [_pose(plan.body_pos[i], plan.body_rot[i]) for i in range(nmov)]
    # each role's pre-joint transform from its parent role's frame (or the
    # world), through the bodies without a joint between them
    pre, prole = [], []
    for r in range(nv):
        i = role_slot[r]
        t = local[i]
        ps = parent[i]
        while ps >= 0 and dof[ps] < 0:
            t = _compose(local[ps], t)
            ps = parent[ps]
        if ps < 0:                    # the chain's static parent, in world
            j = i
            while parent[j] >= 0:
                j = parent[j]
            t = _compose(_pose(plan.parent_pose[j][:3],
                               plan.parent_pose[j][3:].reshape(3, 3)), t)
        pre.append(t)
        prole.append(dof[ps] if ps >= 0 else -1)
        if prole[-1] >= r:
            raise ValueError("team rollout: dofs must follow their parents")
    # mass properties about each role body's frame, with its fixed bodies
    parts = [[(float(plan.mass[role_slot[r]]),
               np.asarray(plan.ipos[role_slot[r]], float),
               plan.irot[role_slot[r]] @ np.diag(plan.idiag[role_slot[r]])
               @ plan.irot[role_slot[r]].T)] for r in range(nv)]
    for f in range(nmov):
        if dof[f] >= 0:
            continue
        t = (np.zeros(3), np.eye(3))
        ps = f
        while ps >= 0 and dof[ps] < 0:
            t = _compose(local[ps], t)
            ps = parent[ps]
        if ps < 0:
            continue                   # static: moves with no dof
        Rr = t[1] @ plan.irot[f]
        parts[dof[ps]].append((float(plan.mass[f]), t[0] + t[1] @ plan.ipos[f],
                               Rr @ np.diag(plan.idiag[f]) @ Rr.T))
    anc = np.asarray(plan.anc_dof, bool)[role_slot]          # (nv, nv)
    mm = np.asarray(plan.m_mask, bool)
    sm = mm | mm.T
    for d1, d2 in zip(plan.eq_d1, plan.eq_d2):
        sm[int(d1), int(d2)] = sm[int(d2), int(d1)] = True
    act = [-1] * nv
    for j, d in enumerate(plan.act_dof):
        act[int(d)] = j
    h = float(plan.timestep)
    nr = -(-nv // OPEN_TEAM) * OPEN_TEAM
    pad = [0.0] * (nr - nv)
    rows = []
    for r in range(nv):
        i = role_slot[r]
        ms = [m for m, _, _ in parts[r]]
        M = sum(ms)
        C = sum(m * c for m, c, _ in parts[r]) / M
        Iloc = sum(I + m * (np.dot(c - C, c - C) * np.eye(3)
                            - np.outer(c - C, c - C))
                   for m, c, I in parts[r])
        ax = np.asarray(plan.jnt_axis[i], float)
        aa = np.outer(ax, ax)
        K = np.array([[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]],
                      [-ax[1], ax[0], 0.0]])
        j = act[r]
        gear, lo, hi = ((float(plan.gear[j]), *map(float, plan.ctrlrange[j]))
                        if j >= 0 else (0.0, 0.0, 0.0))
        wm = [1.0 if (k == r or (k < r and mm[r, k]) or (k > r and mm[k, r]))
              else 0.0 for k in range(nv)]
        row = ([*pre[r][1].ravel(), *pre[r][0], *plan.jnt_pos[i], *ax,
                *aa.ravel(), *(np.eye(3) - aa).ravel(), *K.ravel(),
                float(plan.jnt_ref[i]), *C,
                Iloc[0, 0], Iloc[1, 1], Iloc[2, 2], Iloc[0, 1], Iloc[0, 2],
                Iloc[1, 2], M, float(plan.armature[r]) + h
                * float(plan.damping[r]), float(plan.damping[r]), gear, lo,
                hi, *anc[r].astype(float), *pad, *anc[:, r].astype(float),
                *pad, *wm, *pad, *sm[r].astype(float), *pad])
        rows.append(row)
    off, width = _team_offsets(nr)
    for r in range(nv, nr):                       # the inert roles
        row = [0.0] * width
        row[off["ADIAG"]] = row[off["WM"] + r] = row[off["WS"] + r] = 1.0
        rows.append(row)
    depth = [0] * nv
    for r in range(nv):
        depth[r] = 0 if prole[r] < 0 else depth[prole[r]] + 1
    rounds = max(1, int(math.ceil(math.log2(max(depth) + 1))))
    jump, cur = [], list(prole)
    for _ in range(rounds):
        jump.append(tuple(cur) + (-1,) * (nr - nv))
        cur = [cur[a] if a >= 0 else -1 for a in cur]
    eqs = tuple((int(plan.eq_d1[e]), int(plan.eq_d2[e]),
                 tuple(float(c) for c in plan.eq_poly[e]),
                 float(plan.eq_q01[e]), float(plan.eq_q02[e]),
                 float(plan.eq_kc[e, 0]),
                 h * float(plan.eq_kc[e, 0]) + float(plan.eq_kc[e, 1]),
                 h * (h * float(plan.eq_kc[e, 0]) + float(plan.eq_kc[e, 1])))
                for e in range(len(plan.eq_d1)))
    return TeamPlan(nr, np.asarray(rows), tuple(act) + (-1,) * (nr - nv),
                    tuple(jump), eqs,
                    tuple(float(o) for o in plan.org),
                    tuple(-float(g) for g in plan.gravity), h)


def team_depth(plan: ChainPlan) -> tuple:
    """An estimate, counted by hand from the stages of
    csrc/chain_rollout_open.cu and not derived from its code (unlike the
    emitter's ``depth`` of the one-thread substep), of the team substep's
    critical path: (arithmetic levels, exchange levels), a multiply-add one
    level as nvcc contracts them, an exchange a shuffle or a shared-memory
    round trip between __syncwarp()s. The path: the joint transform (12),
    the pointer-jumping rounds (an exchange and 4 each), the motion axis
    and the bias forces (27 + 3 masked sums over the roles, 3 exchanges),
    the scaling (5, 1), the Cholesky factor (j + 5 and 2 exchanges for
    column j), both substitutions (3 and 1 per role, the transpose 1) and
    Euler (3), over the plan's roles (its dofs padded to a whole team). A
    floor for this design, not for the function."""
    tp = team_plan(plan)
    n, rounds = tp.nroles, len(tp.jump)
    arith = (12 + 4 * rounds + 27 + 3 * n + 5 + n * (n - 1) // 2 + 5 * n
             + 6 * n + 3)
    return arith, rounds + 3 + 1 + 2 * n + 2 * n + 1


@functools.lru_cache(maxsize=None)
def team_header(plan: ChainPlan) -> Generated:
    """``chain_team.cuh``: the team rollout's per-role constants (field
    offsets ``TC_<name>``, the table ``TEAM_C``, actuators, pointer-jumping
    ancestors, equalities: ``TEAM_EQ_EACH(F)`` expands F(e) for each) for
    csrc/chain_rollout_open.cu: ``TEAM_NR`` roles, the first ``TEAM_NV``
    real."""
    tp = team_plan(plan)
    nr = tp.nroles
    offs, off = _team_offsets(nr)
    defs = [f"#define TC_{name} {o}" for name, o in offs.items()]
    if off != tp.rows.shape[1]:
        raise AssertionError("team constants out of step with _team_fields")
    lit = lambda x: _lit(float(x))                           # noqa: E731
    table = ",\n".join("  {" + ", ".join(lit(x) for x in row) + "}"
                       for row in tp.rows)
    eqs = []
    for e, (d1, d2, pc, q01, q02, k, hkc, w) in enumerate(tp.eqs):
        eqs += [f"#define TEAM_EQ{e}_D1 {d1}", f"#define TEAM_EQ{e}_D2 {d2}",
                f"__device__ const float TEAM_EQ{e}_F[10] = {{"
                + ", ".join(lit(x) for x in (*pc, q01, q02, k, hkc, w))
                + "};"]
    each = " ".join(f"F({e})" for e in range(len(tp.eqs)))
    text = "\n".join([
        "// Generated by mujoco_rl_ur5_tpu_torch/physics/cuda_chain.py",
        "#pragma once",
        f"#define TEAM_NR {nr}",
        f"#define TEAM_NV {plan.nv}",
        f"#define TEAM_NU {plan.nu}",
        f"#define TEAM_NC {off}",
        f"#define TEAM_ROUNDS {len(tp.jump)}",
        f"#define TEAM_H {lit(tp.h)}",
        *defs,
        f"__device__ const float TEAM_C[{nr}][{off}] = {{", table, "};",
        f"__device__ const int TEAM_ACT[{nr}] = {{"
        + ", ".join(map(str, tp.act)) + "};",
        f"__device__ const int TEAM_JUMP[{len(tp.jump)}][{nr}] = {{"
        + ", ".join("{" + ", ".join(map(str, j)) + "}" for j in tp.jump)
        + "};",
        "__device__ const float TEAM_ORG[3] = {"
        + ", ".join(map(lit, tp.org)) + "};",
        "__device__ const float TEAM_A0[3] = {"
        + ", ".join(map(lit, tp.a0)) + "};",
        *eqs,
        f"#define TEAM_EQ_EACH(F) {each}",
        ""])
    return Generated(text, {})


_P, _I = ctypes.c_void_p, ctypes.c_int
_NALPHA = 8          # alphas rollout_closed takes as launch arguments


@functools.lru_cache(maxsize=None)
def _open_src(plan: ChainPlan) -> _build.KernelSource:
    return _build.KernelSource(
        "chain_rollout_open", "rollout_open", (_P, _P, _P, _I, _I, _I, _P),
        {"chain_team.cuh": team_header(plan).text})


@functools.lru_cache(maxsize=None)
def _lin_src(plan: ChainPlan) -> _build.KernelSource:
    return _build.KernelSource(
        "chain_lin_fd", "lin_fd",
        (_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I, _P),
        {"chain_substep.cuh": substep_header(plan).text})


@functools.lru_cache(maxsize=None)
def _closed_src(plan: ChainPlan, cost, R: int, RT: int) -> _build.KernelSource:
    return _build.KernelSource(
        "chain_rollout_closed", "rollout_closed",
        (ctypes.c_float,) * _NALPHA + (_P,) * 10 + (_I,) * 4 + (_P,),
        {"chain_substep.cuh": substep_header(plan).text,
         "chain_cost.cuh": cost_header(cost, plan.nv, plan.nu, R, RT).text})


@functools.lru_cache(maxsize=None)
def _quad_src(plan: ChainPlan, *cfg) -> _build.KernelSource:
    return _build.KernelSource(
        "chain_ee_quad_gn", "ee_quad_gn",
        (_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _P),
        {"chain_ee_quad.cuh": ee_quad_header(plan, *cfg).text})


def kernel_sources(plan: ChainPlan, cost=None, R: int = 0, RT: int = 0):
    """The three chain kernels' sources for a plan (and line-search cost),
    for building them together with ``_build.build_many``."""
    return [_open_src(plan), _lin_src(plan), _closed_src(plan, cost, R, RT)]


def _quad_cfg(slot, off, w_ee, w_orient, w_posture, w_vel, home) -> tuple:
    return (int(slot), tuple(float(o) for o in off), float(w_ee),
            float(w_orient), float(w_posture), float(w_vel),
            tuple(float(h) for h in home))


def ee_quad_source(plan: ChainPlan, slot: int, off, w_ee: float,
                   w_orient: float, w_posture: float, w_vel: float,
                   home) -> _build.KernelSource:
    """The ``ee_quad_gn`` kernel's source for a plan and a reach cost."""
    return _quad_src(plan, *_quad_cfg(slot, off, w_ee, w_orient, w_posture,
                                      w_vel, home))


# -- wrappers -----------------------------------------------------------------


def _route(*ts: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensors, checked); False: run the plain
    version (CPU tensors). Anything else raises."""
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    for t in ts:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError("kernel inputs must be float32 on one CUDA "
                            f"device, got {t.dtype} on {t.device}")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _stack(entries, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.full_like(like, e) if _isf(e) else e
                        for e in entries], -1)


def rollout_open_plain(plan: ChainPlan, substeps: int, x0: torch.Tensor,
                       us: torch.Tensor) -> torch.Tensor:
    nv = plan.nv
    knot = make_knot_step(plan, substeps)
    q = [x0[:, i] for i in range(nv)]
    v = [x0[:, nv + i] for i in range(nv)]
    xs = [x0]
    for k in range(us.shape[1]):
        q, v = knot(q, v, [us[:, k, j] for j in range(plan.nu)])
        xs.append(_stack(q + v, x0[:, 0]))
    return torch.stack(xs, 1)


def check_open_inputs(plan: ChainPlan, x0, us) -> tuple:
    """Raise unless the open-loop rollout's inputs are what its kernel
    reads: float32, contiguous, x0 (B, nx) 16-byte aligned (the chain
    kernels' common contract; torch's own allocations are), us (B, H, nu),
    B >= 1. Returns (B, H)."""
    nx, nu = 2 * plan.nv, plan.nu
    B, H = (us.shape[0], us.shape[1]) if us.dim() == 3 else (0, 0)
    for name, t, shape in (("x0", x0, (B, nx)), ("us", us, (B, H, nu))):
        if us.dim() != 3 or tuple(t.shape) != shape:
            raise ValueError(f"rollout_open: {name} is {tuple(t.shape)}, "
                             f"the kernel takes {shape} with us (B, H, {nu})")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"rollout_open: {name} must be contiguous "
                             f"float32, got {t.dtype} with strides "
                             f"{t.stride()}")
    if x0.data_ptr() % 16:
        raise ValueError("rollout_open: x0 is not 16-byte aligned")
    if B < 1:
        raise ValueError(f"rollout_open: B={B} scenarios")
    return B, H


@spanned("chain.rollout_open")
def rollout_open(plan: ChainPlan, substeps: int, x0: torch.Tensor,
                 us: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout: x0 (B, nx), us (B, H, nu) -> xs (B, H+1, nx).
    On CUDA tensors one launch, OPEN_TEAM lanes per scenario (any plan:
    ``team_plan`` pads its dofs to a whole team), reads and writes these
    tensors as they are (``check_open_inputs``)."""
    if not _route(x0, us):
        return rollout_open_plain(plan, substeps, x0, us)
    B, H = check_open_inputs(plan, x0, us)
    xs = torch.empty(B, H + 1, 2 * plan.nv, device=x0.device)
    _build.call(_open_src(plan), x0.data_ptr(), us.data_ptr(),
                xs.data_ptr(), B, H, substeps, _stream(x0))
    rollout_open.launches += 1
    return xs


rollout_open.launches = 0


def lin_fd_plain(plan: ChainPlan, substeps: int, xs: torch.Tensor,
                 us: torch.Tensor):
    nv, nu = plan.nv, plan.nu
    nx = 2 * nv
    B, H = us.shape[0], us.shape[1]
    knot = make_knot_step(plan, substeps)
    xu = torch.cat([xs.reshape(B * H, nx), us.reshape(B * H, nu)], -1)
    # row p perturbs input p; the last row (no perturbation) is the base
    pert = torch.cat([EPS * torch.eye(nx + nu, dtype=xs.dtype),
                      torch.zeros(1, nx + nu, dtype=xs.dtype)]).to(xs.device)
    F = torch.empty(B * H, nx, nx, dtype=xs.dtype, device=xs.device)
    L = torch.empty(B * H, nx, nu, dtype=xs.dtype, device=xs.device)
    for c0 in range(0, B * H, _FD_CHUNK):
        z = xu[None, c0: c0 + _FD_CHUNK] + pert[:, None]  # (P, n, nx+nu)
        q, v = knot([z[..., i] for i in range(nv)],
                    [z[..., nv + i] for i in range(nv)],
                    [z[..., nx + j] for j in range(nu)])
        res = _stack(q + v, z[..., 0])                     # (P, n, nx)
        diff = (res[:-1] - res[-1]) * (1.0 / EPS)          # (nx+nu, n, nx)
        F[c0: c0 + _FD_CHUNK] = diff[:nx].permute(1, 2, 0)
        L[c0: c0 + _FD_CHUNK] = diff[nx:].permute(1, 2, 0)
    return F.reshape(B, H, nx, nx), L.reshape(B, H, nx, nu)


def _lin_launch(plan: ChainPlan, xs: torch.Tensor, us: torch.Tensor,
                fd_substeps: int, rounds: int):
    """One csrc/chain_lin_fd.cu launch: differences over ``fd_substeps``
    substeps, then ``rounds`` squarings (0: none). xs (B, H, nx) with unit
    element and knot strides (any batch stride: the solver's xs[:, :-1]),
    us (B, H, nu) contiguous; F, L come out contiguous, batch-first."""
    nx, nu = 2 * plan.nv, plan.nu
    B, H = us.shape[0], us.shape[1]
    if tuple(xs.shape) != (B, H, nx) or tuple(us.shape) != (B, H, nu):
        raise ValueError(f"lin_fd: xs {tuple(xs.shape)} and us "
                         f"{tuple(us.shape)} are not (B, H, {nx}) and "
                         f"(B, H, {nu})")
    if xs.stride(2) != 1 or xs.stride(1) != nx or not us.is_contiguous():
        raise ValueError(f"lin_fd: xs needs rows of {nx} contiguous knots "
                         f"(strides {xs.stride()}), us must be contiguous")
    if B * H >= 2 ** 31:
        raise ValueError(f"lin_fd: B * H = {B * H} instances exceed the "
                         "kernel's int count")
    F = torch.empty(B, H, nx, nx, device=xs.device)
    L = torch.empty(B, H, nx, nu, device=xs.device)
    _build.call(_lin_src(plan), xs.data_ptr(), us.data_ptr(), F.data_ptr(),
                L.data_ptr(), B * H, H, xs.stride(0), fd_substeps, rounds,
                _stream(xs))
    lin_fd.launches += 1
    return F, L


@spanned("chain.lin_fd")
def lin_fd(plan: ChainPlan, substeps: int, xs: torch.Tensor,
           us: torch.Tensor):
    """Forward-difference knot Jacobians over ``substeps`` substeps (step
    1e-3): xs (B, H, nx), us (B, H, nu) -> F (B, H, nx, nx),
    L (B, H, nx, nu)."""
    if not _route(xs, us):
        return lin_fd_plain(plan, substeps, xs, us)
    return _lin_launch(plan, xs, us, substeps, 0)


lin_fd.launches = 0


def compose_substeps(A: torch.Tensor, Bm: torch.Tensor, substeps: int):
    """One substep's Jacobians (A, Bm) -> the knot's F = A^s and
    L = (I + A + ... + A^{s-1}) Bm by repeated squaring, as batched
    matmul (s a power of two)."""
    F = A
    S = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    m = 1
    while m < substeps:                   # S_2m = S_m + F_m S_m
        S = S + F @ S
        F = F @ F
        m *= 2
    return F, S @ Bm


def lin_fd_fast_plain(plan: ChainPlan, substeps: int, xs: torch.Tensor,
                      us: torch.Tensor):
    return compose_substeps(*lin_fd_plain(plan, 1, xs, us), substeps)


@spanned("chain.lin_fd")
def lin_fd_fast(plan: ChainPlan, substeps: int, xs: torch.Tensor,
                us: torch.Tensor):
    """Knot Jacobians from a one-substep FD and a composition by repeated
    squaring: F = A^s, L = (I + A + ... + A^{s-1}) B. The knot applies one
    u to every substep, so L is the geometric sum. On CUDA tensors both
    happen in one ``lin_fd`` launch (counted in ``lin_fd.launches``); the
    plain version composes by batched matmul."""
    if substeps < 1 or substeps & (substeps - 1):
        raise ValueError("lin_fd_fast: substeps must be a power of two")
    if not _route(xs, us):
        return lin_fd_fast_plain(plan, substeps, xs, us)
    return _lin_launch(plan, xs, us, 1, substeps.bit_length() - 1)


def rollout_closed_plain(plan: ChainPlan, substeps: int, x0, xbar, ubar, K,
                         d, alphas: tuple, cost=None, sref=None, tref=None):
    nv, nu = plan.nv, plan.nu
    B, H = ubar.shape[0], ubar.shape[1]
    knot = make_knot_step(plan, substeps)
    al = torch.tensor(alphas, dtype=torch.float32).to(x0.dtype)
    al = al.to(x0.device)[:, None]                      # (A, 1)
    lane = torch.zeros(len(alphas), B, dtype=x0.dtype, device=x0.device)
    q = [x0[:, i] + lane for i in range(nv)]
    v = [x0[:, nv + i] + lane for i in range(nv)]
    tr = [] if tref is None else [tref[:, i] for i in range(tref.shape[-1])]
    xs, us, acc = [_stack(q + v, lane)], [], 0.0
    for k in range(H):
        dx = [xi - xbar[:, k, i] for i, xi in enumerate(q + v)]
        u = []
        for j in range(nu):
            uacc = ubar[:, k, j] + al * d[:, k, j]
            for i in range(2 * nv):
                uacc = uacc + K[:, k, j, i] * dx[i]
            u.append(uacc.clamp(float(plan.ctrlrange[j, 0]),
                                float(plan.ctrlrange[j, 1])))
        us.append(torch.stack(u, -1))
        if cost is not None:
            sr = ([] if sref is None
                  else [sref[:, k, i] for i in range(sref.shape[-1])])
            acc = acc + cost[0](q, v, u, sr, tr)
        q, v = knot(q, v, u)
        xs.append(_stack(q + v, lane))
    xs = torch.stack(xs, 1).permute(2, 0, 1, 3)        # (B, A, H+1, nx)
    us = torch.stack(us, 1).permute(2, 0, 1, 3)        # (B, A, H, nu)
    if cost is None:
        return xs, us
    costs = lane + (acc + cost[1](q, v, tr))
    return xs, us, costs.t()


def check_closed_inputs(plan: ChainPlan, x0, xbar, ubar, K, d, alphas,
                        sref=None, tref=None) -> tuple:
    """Raise unless the line search's inputs are what its kernel reads:
    float32, contiguous, x0 (B, nx), xbar (B, H+1, nx), ubar (B, H, nu),
    K (B, H, nu, nx), d (B, H, nu), sref (B, H, R) and tref (B, RT) or None,
    16-byte aligned where it reads rows of 16 bytes, and 1 to 8 alphas.
    Returns (B, H, A, R, RT)."""
    nx, nu = 2 * plan.nv, plan.nu
    B, H = ubar.shape[0], ubar.shape[1]
    R = 0 if sref is None else sref.shape[-1]
    RT = 0 if tref is None else tref.shape[-1]
    want = {"x0": (x0, (B, nx)), "xbar": (xbar, (B, H + 1, nx)),
            "ubar": (ubar, (B, H, nu)), "K": (K, (B, H, nu, nx)),
            "d": (d, (B, H, nu))}
    if sref is not None:
        want["sref"] = (sref, (B, H, R))
    if tref is not None:
        want["tref"] = (tref, (B, RT))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"rollout_closed: {name} is {tuple(t.shape)}, "
                             f"the kernel takes {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"rollout_closed: {name} must be contiguous "
                             f"float32, got {t.dtype} with strides "
                             f"{t.stride()}")
    for name in ("x0", "xbar", "K") + (("sref",) if R % 4 == 0 and R
                                       else ()):
        if want[name][0].data_ptr() % 16:
            raise ValueError(f"rollout_closed: {name} is not 16-byte "
                             "aligned")
    A = len(alphas)
    if not 1 <= A <= _NALPHA or B < 1 or H < 1:
        raise ValueError(f"rollout_closed: B={B}, H={H} and {A} alphas "
                         f"(the kernel takes 1 to {_NALPHA})")
    return B, H, A, R, RT


@spanned("chain.rollout_closed")
def rollout_closed(plan: ChainPlan, substeps: int, x0: torch.Tensor,
                   xbar: torch.Tensor, ubar: torch.Tensor, K: torch.Tensor,
                   d: torch.Tensor, alphas: tuple, cost=None,
                   sref: torch.Tensor = None, tref: torch.Tensor = None):
    """Line-search rollouts for all alphas in one launch.

    x0 (B, nx), xbar (B, H+1, nx), ubar (B, H, nu), K (B, H, nu, nx),
    d (B, H, nu) -> xs (B, A, H+1, nx), us (B, A, H, nu) with
    u = clip(ubar + a d + K (x - xbar)). ``cost`` = (stage_cb, term_cb)
    fuses the candidates' costs: stage_cb(q, v, u, sref_k, tref) and
    term_cb(q, v, tref) over entry lists, with per-knot references
    ``sref`` (B, H, R) and per-scenario ``tref`` (B, RT); the return is
    then (xs, us, costs (B, A)). On CUDA tensors every input must be
    contiguous (``check_closed_inputs``)."""
    if not _route(x0, xbar, ubar, K, d):
        return rollout_closed_plain(plan, substeps, x0, xbar, ubar, K, d,
                                    alphas, cost, sref, tref)
    B, H, A, R, RT = check_closed_inputs(plan, x0, xbar, ubar, K, d, alphas,
                                         sref, tref)
    dev = x0.device
    xs = torch.empty(B, A, H + 1, 2 * plan.nv, device=dev)
    us = torch.empty(B, A, H, plan.nu, device=dev)
    costs = torch.empty(B, A, device=dev)
    ptrs = [0 if t is None else t.data_ptr()
            for t in (x0, xbar, ubar, K, d, sref, tref, xs, us, costs)]
    al = [float(a) for a in alphas] + [0.0] * (_NALPHA - A)
    _build.call(_closed_src(plan, cost, R, RT), *al, *ptrs, B, H, A,
                substeps, _stream(x0))
    rollout_closed.launches += 1
    if cost is None:
        return xs, us
    return xs, us, costs


rollout_closed.launches = 0


def ee_quad_gn_plain(plan: ChainPlan, slot: int, off, w_ee: float,
                     w_orient: float, w_posture: float, w_vel: float, home,
                     xs: torch.Tensor, targets: torch.Tensor):
    nv = plan.nv
    quad = _ee_quad(plan, *_quad_cfg(slot, off, w_ee, w_orient, w_posture,
                                     w_vel, home))
    Xu, g = quad([xs[..., i] for i in range(nv)],
                 [xs[..., nv + i] for i in range(nv)],
                 [targets[:, None, i] for i in range(3)])
    X = xs.new_zeros(xs.shape[:-1] + (2 * nv, 2 * nv))
    it = iter(Xu)
    for i in range(nv):
        for j in range(i, nv):
            X[..., i, j] = X[..., j, i] = next(it)
    vel = torch.arange(nv, 2 * nv, device=xs.device)
    X[..., vel, vel] = w_vel
    return X, _stack(g, xs[..., 0])


def check_quad_inputs(plan: ChainPlan, xs, targets) -> tuple:
    """Raise unless ee_quad_gn's inputs are what its kernel reads in place:
    float32, xs (B, H, nx) with contiguous rows of nx and any batch stride
    that keeps each row 16-byte aligned (the solver's ``xs[:, :-1]``),
    targets (B, 3) contiguous, B, H >= 1. Returns (B, H)."""
    nx = 2 * plan.nv
    B, H = (xs.shape[0], xs.shape[1]) if xs.dim() == 3 else (0, 0)
    if (xs.dim() != 3 or xs.shape[2] != nx
            or tuple(targets.shape) != (B, 3)):
        raise ValueError(f"ee_quad_gn: xs {tuple(xs.shape)} and targets "
                         f"{tuple(targets.shape)} are not (B, H, {nx}) and "
                         "(B, 3)")
    if B < 1 or H < 1:
        raise ValueError(f"ee_quad_gn: B={B}, H={H}")
    if xs.dtype != torch.float32 or targets.dtype != torch.float32:
        raise ValueError(f"ee_quad_gn: float32 inputs, got {xs.dtype} and "
                         f"{targets.dtype}")
    if (xs.stride(2) != 1 or xs.stride(1) != nx or xs.stride(0) % 4
            or xs.data_ptr() % 16):
        raise ValueError("ee_quad_gn: xs must have contiguous 16-byte "
                         f"aligned rows of {nx}, got strides {xs.stride()}")
    if not targets.is_contiguous():
        raise ValueError("ee_quad_gn: targets must be contiguous")
    return B, H


@spanned("chain.ee_quad_gn")
def ee_quad_gn(plan: ChainPlan, slot: int, off, w_ee: float, w_orient: float,
               w_posture: float, w_vel: float, home, xs: torch.Tensor,
               targets: torch.Tensor):
    """The reach cost's Gauss-Newton stage blocks (see make_ee_quad) for all
    B x H knots in one launch, in the solver's layout: xs (B, H, nx) and
    targets (B, 3), read where they are, -> X (B, H, nx, nx), Xq in its
    top-left block, w_vel on the velocity diagonal and exact zeros
    elsewhere, and g (B, H, nx)."""
    if not _route(xs, targets):
        return ee_quad_gn_plain(plan, slot, off, w_ee, w_orient, w_posture,
                                w_vel, home, xs, targets)
    B, H = check_quad_inputs(plan, xs, targets)
    nx = 2 * plan.nv
    X = torch.empty(B, H, nx, nx, device=xs.device)
    g = torch.empty(B, H, nx, device=xs.device)
    src = ee_quad_source(plan, slot, off, w_ee, w_orient, w_posture, w_vel,
                         home)
    _build.call(src, xs.data_ptr(), xs.stride(0), targets.data_ptr(),
                X.data_ptr(), g.data_ptr(), B * H, H, _stream(xs))
    ee_quad_gn.launches += 1
    return X, g


ee_quad_gn.launches = 0
