"""Quaternion, rotation and spatial (6D) algebra over leading batch dims.

The port's copy of the JAX package's ops/spatial.py, the functions that
kinematics and dynamics call. Conventions (MuJoCo's):

  * quaternions are (w, x, y, z), unit norm, Hamilton product;
  * rotation matrices are world-from-local (R @ v_local = v_world);
  * spatial motion vectors are 6D ``[angular(3), linear(3)]``;
  * spatial inertias are 10-parameter ``[mass, h (3), Ixx, Iyy, Izz, Ixy,
    Ixz, Iyz]`` about the frame origin, h = m * com.

Every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (broadcasting), as ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    uw, ux, uy, uz = u.unbind(-1)
    vw, vx, vy, vz = v.unbind(-1)
    return torch.stack([
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw,
    ], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                        keepdim=True), eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v for quats (..., 4) and vectors (..., 3)."""
    w, u = q[..., :1], q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T @ v."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3), world-from-local."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3), angle (...) -> quat (..., 4)."""
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], -1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q * exp(dt/2 * omega) for a body-local angular velocity omega
    (MuJoCo's mju_quatIntegrate), renormalized."""
    angle = torch.linalg.vector_norm(omega, dim=-1)
    axis = omega / torch.clamp_min(angle, 1e-12)[..., None]
    return quat_normalize(quat_mul(q, quat_from_axis_angle(axis,
                                                           angle * dt)))


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m."""
    vw, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(vw, mw), cross(vw, ml) + cross(vl, mw)], -1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f."""
    vw, vl = v[..., :3], v[..., 3:]
    fw, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(vw, fw) + cross(vl, fl), cross(vw, fl)], -1)


def inertia_mul(inert: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """10-parameter spatial inertia times a motion vector -> force
    (MuJoCo mju_mulInertVec)."""
    mass = inert[..., 0:1]
    h = inert[..., 1:4]
    ixx, iyy, izz, ixy, ixz, iyz = inert[..., 4:10].unbind(-1)
    w, vl = v[..., :3], v[..., 3:]
    w0, w1, w2 = w.unbind(-1)
    iw = torch.stack([ixx * w0 + ixy * w1 + ixz * w2,
                      ixy * w0 + iyy * w1 + iyz * w2,
                      ixz * w0 + iyz * w1 + izz * w2], -1)
    return torch.cat([iw + cross(h, vl), mass * vl - cross(h, w)], -1)


def inertia_from_body(mass, diag_inertia, ipos, iquat) -> torch.Tensor:
    """10-parameter inertia of a body with its COM at ``ipos`` and principal
    inertia ``diag_inertia`` oriented by ``iquat`` (parallel axis)."""
    mass = mass.expand(ipos.shape[:-1])
    r = quat_to_mat(iquat)
    i_com = (r * diag_inertia[..., None, :]) @ r.transpose(-1, -2)
    c = ipos
    cc = c[..., :, None] * c[..., None, :]
    c2 = (c * c).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=mass.dtype, device=mass.device)
    i_org = i_com + mass[..., None, None] * (c2 * eye - cc)
    return torch.cat([
        mass[..., None], mass[..., None] * c,
        i_org[..., 0, 0, None], i_org[..., 1, 1, None],
        i_org[..., 2, 2, None], i_org[..., 0, 1, None],
        i_org[..., 0, 2, None], i_org[..., 1, 2, None]], -1)
