"""Batched Riccati backward pass as one CUDA kernel launch.

``backward`` is the iLQR's backward pass at c = 0 (the subproblem is in
deviation coordinates, mpc/cuda_ilqr.py). On CUDA tensors it launches
``csrc/lqr_backward.cu``: a team of 16 lanes per scenario walks the horizon
backwards, lane i owning row i of the value Hessian, with each knot's
blocks copied into shared memory while the knot after it computes. It
replaces the TPU kernel mujoco_rl_ur5_tpu/mpc/pallas_lqr.py backward_pallas,
reads and writes the public batch-first layout as it is, and is bound by
the bytes it must move (F, L, X, U in; K, d, S, s out). On CPU tensors it
runs ``backward_plain``: mpc/lqr.backward_sequential with c = 0.
"""

from __future__ import annotations

import ctypes

import torch

from mujoco_rl_ur5_tpu_torch import _build
from mujoco_rl_ur5_tpu_torch.mpc.lqr import LQR, Gains, backward_sequential
from mujoco_rl_ur5_tpu_torch.physics.cuda_chain import _route, _stream
from mujoco_rl_ur5_tpu_torch.trace import spanned

_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCE = _build.KernelSource("lqr_backward", "riccati_backward",
                             (_P,) * 13 + (_I,) * 4 + (_P,))
NX, NU = 16, 7          # the widths the kernel is built for


def backward_plain(F, L, X, q, U, r, XH, qH, reg) -> Gains:
    c = torch.zeros_like(q)
    return backward_sequential(LQR(F, L, c, X, q, U, r, XH, qH), reg)


def check_inputs(F, L, X, q, U, r, XH, qH, reg) -> tuple:
    """Raise unless the inputs are what the kernel reads: float32,
    contiguous, the shapes below at nx=16, nu=7, and 16-byte aligned where
    it reads rows of 16 bytes. Returns (B, H)."""
    B, H = F.shape[0], F.shape[1]
    want = {"F": (F, (B, H, NX, NX)), "L": (L, (B, H, NX, NU)),
            "X": (X, (B, H, NX, NX)), "q": (q, (B, H, NX)),
            "U": (U, (B, H, NU, NU)), "r": (r, (B, H, NU)),
            "XH": (XH, (B, NX, NX)), "qH": (qH, (B, NX)), "reg": (reg, (B,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"backward: {name} is {tuple(t.shape)}, the "
                             f"kernel takes {shape} (nx={NX}, nu={NU})")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"backward: {name} must be contiguous float32, "
                             f"got {t.dtype} with strides {t.stride()}")
    for name in ("F", "L", "X", "q", "XH"):
        if want[name][0].data_ptr() % 16:
            raise ValueError(f"backward: {name} is not 16-byte aligned")
    if B < 1 or H < 1:
        raise ValueError(f"backward: empty problem B={B}, H={H}")
    return B, H


@spanned("chain.backward")
def backward(F: torch.Tensor, L: torch.Tensor, X: torch.Tensor,
             q: torch.Tensor, U: torch.Tensor, r: torch.Tensor,
             XH: torch.Tensor, qH: torch.Tensor, reg: torch.Tensor) -> Gains:
    """F (B,H,nx,nx), L (B,H,nx,nu), X (B,H,nx,nx), q (B,H,nx),
    U (B,H,nu,nu), r (B,H,nu), XH (B,nx,nx), qH (B,nx), reg (B,) -> Gains
    (K (B,H,nu,nx), d (B,H,nu), S (B,H+1,nx,nx), s (B,H+1,nx)). On CUDA
    tensors every input must be contiguous (``check_inputs``)."""
    if not _route(F, L, X, q, U, r, XH, qH, reg):
        return backward_plain(F, L, X, q, U, r, XH, qH, reg)
    B, H = check_inputs(F, L, X, q, U, r, XH, qH, reg)
    dev = F.device
    K = torch.empty(B, H, NU, NX, device=dev)
    d = torch.empty(B, H, NU, device=dev)
    S = torch.empty(B, H + 1, NX, NX, device=dev)
    s = torch.empty(B, H + 1, NX, device=dev)
    ptrs = [t.data_ptr() for t in (F, L, X, q, U, r, XH, qH, reg, K, d, S, s)]
    _build.call(SOURCE, *ptrs, B, H, NX, NU, _stream(F))
    backward.launches += 1
    return Gains(K=K, d=d, S=S, s=s)


backward.launches = 0
