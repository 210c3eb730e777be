"""The bank of joint PIDs, evaluated for every actuator at once: the port's
counterpart of the JAX package's control/pid.py.

The reference runs seven PIDs with hand-tuned gains and evaluates all seven
every simulation step, whatever joint group moves. Here the bank is a few
elementwise operations over (B, nu) tensors. The derivative acts on the
measurement, the first call after ``pid_init`` emits none (the ``primed``
flag), the integral is clamped to the output limits, and dt is the fixed
physics timestep (the reference's wall-clock dt is not deterministic).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(eq=False)
class PIDParams:
    kp: torch.Tensor       # (..., nu)
    ki: torch.Tensor
    kd: torch.Tensor
    out_lo: torch.Tensor
    out_hi: torch.Tensor

    def replace(self, **kw) -> "PIDParams":
        return dataclasses.replace(self, **kw)


@dataclass(eq=False)
class PIDState:
    integral: torch.Tensor   # (B, nu)
    last_meas: torch.Tensor  # (B, nu)
    primed: torch.Tensor     # (B,) bool: False until the first call

    def replace(self, **kw) -> "PIDState":
        return dataclasses.replace(self, **kw)


def reference_gains(dtype=torch.float32, device="cpu") -> PIDParams:
    """The reference's seven controllers in actuator order [shoulder_pan,
    shoulder_lift, elbow, wrist_1, wrist_2, wrist_3, gripper], each (nu,)."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    lo = t([-2.0, -2.0, -2.0, -1.0, -1.0, -1.0, -1.0])
    return PIDParams(kp=t([21.0, 30.0, 15.0, 21.0, 15.0, 15.0, 7.5]),
                     ki=torch.zeros(7, dtype=dtype, device=device),
                     kd=t([0.11, 0.10, 0.05, 0.01, 0.01, 0.01, 0.0]),
                     out_lo=lo, out_hi=-lo)


def pid_init(nu: int, batch: int, dtype=torch.float32,
             device="cpu") -> PIDState:
    z = torch.zeros(batch, nu, dtype=dtype, device=device)
    return PIDState(integral=z, last_meas=z.clone(),
                    primed=torch.zeros(batch, dtype=torch.bool,
                                       device=device))


def pid_output(params: PIDParams, pstate: PIDState, setpoint: torch.Tensor,
               meas: torch.Tensor, dt: float):
    """One evaluation of the whole bank: (ctrl, new state)."""
    err = setpoint - meas
    integral = torch.clamp(pstate.integral + params.ki * err * dt,
                           params.out_lo, params.out_hi)
    d_meas = torch.where(pstate.primed[..., None], meas - pstate.last_meas,
                         torch.zeros_like(meas))
    deriv = -params.kd * d_meas / dt
    out = torch.clamp(params.kp * err + integral + deriv, params.out_lo,
                      params.out_hi)
    return out, PIDState(integral=integral, last_meas=meas,
                         primed=torch.ones_like(pstate.primed))
