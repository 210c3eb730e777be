"""iLQR result container (the port's counterpart of the JAX package's
mpc/ilqr.ILQRResult; its generic per-instance optimizer is not on the
batched path)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mujoco_rl_ur5_tpu_torch.mpc.lqr import Gains


class ILQRResult(NamedTuple):
    xs: torch.Tensor   # (B, H+1, nx) optimized state trajectories
    us: torch.Tensor   # (B, H, nu) optimized controls
    cost: torch.Tensor  # (B,) final total costs
    gains: Gains       # feedback policy around the solution (warm starts
                       # and closed-loop execution)
