"""Batched Riccati backward pass as one CUDA kernel launch.

``backward`` is the iLQR's backward pass at c = 0 (the subproblem is in
deviation coordinates, mpc/cuda_ilqr.py). On CUDA tensors it launches
``csrc/lqr_backward.cu``: one thread per scenario walks the horizon
backwards with the value function in thread-local memory, replacing the
TPU kernel mujoco_rl_ur5_tpu/mpc/pallas_lqr.py backward_pallas. It is bound
by the bytes it must move (F, L, X, U in; K, d, S, s out). On CPU tensors
it runs ``backward_plain``: mpc/lqr.backward_sequential with c = 0.
"""

from __future__ import annotations

import ctypes

import torch

from mujoco_rl_ur5_tpu_torch import _build
from mujoco_rl_ur5_tpu_torch.mpc.lqr import LQR, Gains, backward_sequential
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import (
    _bfast, _bslow, _route, _stream,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCE = _build.KernelSource("lqr_backward", "riccati_backward",
                             (_P,) * 13 + (_I,) * 4 + (_P,))


def backward_plain(F, L, X, q, U, r, XH, qH, reg) -> Gains:
    c = torch.zeros_like(q)
    return backward_sequential(LQR(F, L, c, X, q, U, r, XH, qH), reg)


def backward(F: torch.Tensor, L: torch.Tensor, X: torch.Tensor,
             q: torch.Tensor, U: torch.Tensor, r: torch.Tensor,
             XH: torch.Tensor, qH: torch.Tensor, reg: torch.Tensor) -> Gains:
    """F (B,H,nx,nx), L (B,H,nx,nu), X (B,H,nx,nx), q (B,H,nx),
    U (B,H,nu,nu), r (B,H,nu), XH (B,nx,nx), qH (B,nx), reg (B,) -> Gains
    (K (B,H,nu,nx), d (B,H,nu), S (B,H+1,nx,nx), s (B,H+1,nx))."""
    if not _route(F, L, X, q, U, r, XH, qH, reg):
        return backward_plain(F, L, X, q, U, r, XH, qH, reg)
    B, H, nx, nu = L.shape
    if (nx, nu) != (16, 7):
        raise ValueError(f"the backward kernel is built for nx=16, nu=7, "
                         f"got nx={nx}, nu={nu}")
    dev = F.device
    ins = [_bfast(t) for t in (F, L, X, q, U, r, XH, qH)]
    ins.append(reg.contiguous())
    K = torch.empty(H, nu, nx, B, device=dev)
    d = torch.empty(H, nu, B, device=dev)
    S = torch.empty(H + 1, nx, nx, B, device=dev)
    s = torch.empty(H + 1, nx, B, device=dev)
    _build.call(SOURCE, *[t.data_ptr() for t in ins + [K, d, S, s]],
                B, H, nx, nu, _stream(F))
    backward.launches += 1
    return Gains(K=_bslow(K), d=_bslow(d), S=_bslow(S), s=_bslow(s))


backward.launches = 0
