"""The port's MPC pick policy: ``execute`` of a plan carried across and
the policy's errors, against the JAX package's, as tests/test_torch_policy.py
holds the policy's other parts (its docstring sets out the fixture and the
limits; its fixtures and helpers serve both files). These two need no
JAX move program, so the file is apart from the other half without
compiling that program twice.

* ``execute`` of a plan carried across (B=2, H=4, substeps=4, seeded
  controls, knot states and feedback gains): qpos and qvel within 1e-4.
* Without a policy ``step_mpc`` raises; a GraspMPC on another device than
  the policy's raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.control.pid import pid_init as jpid_init
from mujoco_rl_ur5_tpu.mpc.grasp_mpc import GraspMPC as JGraspMPC
from mujoco_rl_ur5_tpu.mpc.ilqr import ILQRResult as JResult
from mujoco_rl_ur5_tpu.mpc.lqr import Gains as JGains
from mujoco_rl_ur5_tpu.mpc.policy import MPCGraspPolicy as JPolicy
from mujoco_rl_ur5_tpu.scene.reduce import load_arm_model as jax_load_arm
from mujoco_rl_ur5_tpu_torch import OBJECTS, carry
from mujoco_rl_ur5_tpu_torch.control.pid import pid_init
from mujoco_rl_ur5_tpu_torch.env import GraspEnv
from mujoco_rl_ur5_tpu_torch.mpc import GraspMPC, MPCGraspPolicy
from mujoco_rl_ur5_tpu_torch.mpc.policy import GRIP_CLOSE, GRIP_OPEN
from tests.test_torch_policy import (  # noqa: F401 -- fixtures
    KW, _close, _jstate, _parked, one_thread, scene,
)


def test_execute_matches_jax(scene):
    jm, host, m, jenv, env = scene
    B, Hx, Sx = 2, 4, 4
    jpol = JPolicy(jm, JGraspMPC(jm, arm_model=jax_load_arm(OBJECTS),
                                 horizon=Hx, substeps=Sx, use_pallas=False),
                   ncon=96, iterations=15)
    mpc = GraspMPC.from_scene(OBJECTS, horizon=Hx, substeps=Sx,
                              device="cpu")
    pol = MPCGraspPolicy(m, mpc, ncon=96, iterations=15, device="cpu")
    rng = np.random.default_rng(5)
    q = _parked(m, B, 1)
    st = env._settle(q).sim
    x0 = mpc.x_from_state(st.qpos, st.qvel)
    nx, nu = mpc.nx, mpc.nu
    us = mpc.hold_ctrl(x0[:, :8])[:, None].numpy() + 0.2 * rng.standard_normal(
        (B, Hx, nu))
    xs = x0[:, None].numpy() + 0.02 * rng.standard_normal((B, Hx + 1, nx))
    f32 = np.float32
    jres = JResult(xs=jnp.asarray(xs, f32), us=jnp.asarray(us, f32),
                   cost=jnp.zeros(B),
                   gains=JGains(K=jnp.asarray(0.5 * rng.standard_normal(
                       (B, Hx, nu, nx)), f32), d=jnp.zeros((B, Hx, nu)),
                       S=jnp.zeros((B, Hx + 1, nx, nx)),
                       s=jnp.zeros((B, Hx + 1, nx))))
    grip = np.array([GRIP_OPEN, GRIP_CLOSE], f32)
    pid = pid_init(7, B)
    jst, jps = jax.jit(jax.vmap(jpol.execute))(
        _jstate(st), jpid_init(7, (B,)), jres, jnp.asarray(grip))
    tst, tps = pol.execute(st, pid, carry.ilqr_from_arrays(jres),
                           torch.from_numpy(grip))
    _close(tst.qpos, jst.qpos, 1e-4, "qpos")
    _close(tst.qvel, jst.qvel, 1e-4, "qvel")
    _close(tps.integral, jps.integral, 1e-4, "pid")
    # the plan moved the arm
    assert (tst.qpos[:, :6] - st.qpos[:, :6]).abs().max() > 1e-3


def test_policy_errors(scene):
    jm, host, m, jenv, env = scene
    plain = GraspEnv(m, device="cpu", **KW)
    es = plain._settle(_parked(m, 1, 0))
    with pytest.raises(ValueError, match="step_mpc"):
        plain.step_mpc(es, torch.tensor([[0, 0]]))
    with pytest.raises(RuntimeError, match="cuda"):
        MPCGraspPolicy(m, env.policy.mpc, device="cuda")
