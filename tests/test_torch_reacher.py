"""The port's ReacherEnv (env/reacher.py) against the JAX package's, both on
the port's reacher fixture (assets/ur5_2finger_reacher.xml; JAX's compiled
arrays carried across with ``carry.model_from_arrays``, so that both step
on identical arrays), contact-free (ncon=0), frame_skip 5.

* ``reset`` through a generator: every target inside the slide joints'
  world envelope (x [-.27, .27], y [-.7, -.3], z [.95, 1.25]: the body at
  (0.1, -0.6, 1.0) plus range minus ref), the arm at home; JAX's targets
  too, and the port's FK of JAX's drawn qpos gives JAX's target (1e-6 m).
* ``observe``'s layout (B, 18) = [q_arm, qd_arm, target, ee] on JAX's
  reset carried across (``carry.reacher_state_from_arrays``): equal to
  JAX's within 1e-6.
* 20 ``step``s of a fixed setpoint from that state: qpos within 1e-4 rad,
  reward and distance within 1e-4, success equal.
* ``reach_ik(max_steps=500)`` at B=4 (the BASELINE config-1 workload):
  ``ik_ok`` and ``converged`` equal, ``steps`` within 1 per scenario, qpos
  within 1e-3 rad, ``dist`` within 1e-4 m of JAX's, below the start's in
  every scenario and below 0.08 m where the joints converged. This
  fixture's arm needs more than 500 steps to bring every joint within
  0.05 rad of most targets (660-1,406 steps for the four of the port's
  ``reset`` with generator seed 0, max_steps=1500; about one target in
  seven converges within 500), so the reach starts from JAX's reset with
  the targets of four of the port's draws (generator seed 5, rows 45, 18,
  0 and 2 of 128): the first two converge, in 61 and 293 steps, and the
  last two do not, so that the masked freeze and the per-scenario step
  count are held on both sides. The qpos limit follows the
  reach's own conditioning: the setpoints agree to 5e-7 rad and the
  joints to 3e-6 rad after 300 steps, but by 500 steps of the saturated
  PID a one-ulp change of the start angles moves the port's own wrist_2
  by 1.5e-4 rad (and JAX's differs by 2.7e-4); the distance moves by
  1.5e-5 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.env.reacher import ReacherEnv as JReacherEnv
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu_torch import REACHER, carry
from mujoco_rl_ur5_tpu_torch.env import ReacherEnv
from mujoco_rl_ur5_tpu_torch.env.reacher import ARM_HOME
from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS

B = 4
ENVELOPE = np.array([[-0.27, 0.27], [-0.7, -0.3], [0.95, 1.25]])
ACTION = np.array([0.5, -1.2, 1.2, -1.57, -1.57, 0.0], np.float32)
# the JAX programs compile without XLA:CPU's expensive LLVM passes (the
# reach's compile and run take 15 s instead of 26 here)
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU ops are small: one thread runs them faster here and
    leaves the other workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    jm = jax_compile_spec(jax_parse_mjcf(REACHER))
    m = carry.model_from_arrays(compile_file(REACHER).topo,
                                {n: np.asarray(getattr(jm, n))
                                 for n in ARRAY_FIELDS})
    return JReacherEnv(jm, frame_skip=5), ReacherEnv(m, frame_skip=5,
                                                     device="cpu")


@pytest.fixture(scope="module")
def jax_reset(envs):
    jenv = envs[0]
    return jax.jit(jax.vmap(jenv.reset), compiler_options=FAST_COMPILE)(
        jax.random.split(jax.random.PRNGKey(7), B))


def _carried(jes):
    return carry.reacher_state_from_arrays(
        jax.tree.map(np.asarray, jes), device="cpu")


def _inside(t):
    t = np.asarray(t)
    return bool(((t >= ENVELOPE[:, 0] - 1e-6)
                 & (t <= ENVELOPE[:, 1] + 1e-6)).all())


def test_reset_envelope(envs, jax_reset):
    jenv, env = envs
    es = env.reset(torch.Generator().manual_seed(0), 64)
    assert es.target.shape == (64, 3) and _inside(es.target)
    # the draws spread over the envelope
    assert (es.target.amax(0) - es.target.amin(0) > 0.2).all()
    np.testing.assert_allclose(es.sim.qpos[:, env.arm_qadr].numpy(),
                               np.broadcast_to(ARM_HOME, (64, 6)), atol=1e-6)
    assert _inside(jax_reset.target)
    other = env.reset(torch.Generator().manual_seed(1), 64)
    assert not torch.equal(other.target, es.target)
    # the port's FK of JAX's drawn qpos places the target where JAX does
    q = torch.from_numpy(np.array(jax_reset.sim.qpos))
    np.testing.assert_allclose(
        fk(env.model, q).xpos[:, env.target_body].numpy(),
        np.asarray(jax_reset.target), atol=1e-6)


def test_observe_layout(envs, jax_reset):
    jenv, env = envs
    es = _carried(jax_reset)
    obs = env.observe(es)
    assert obs.shape == (B, 18)
    np.testing.assert_array_equal(obs[:, 12:15].numpy(),
                                  np.asarray(jax_reset.target))
    np.testing.assert_allclose(
        obs.numpy(), np.asarray(jax.jit(jax.vmap(jenv.observe),
                                   compiler_options=FAST_COMPILE)(jax_reset)),
        atol=1e-6)


def test_steps_match_jax(envs, jax_reset):
    jenv, env = envs
    es = _carried(jax_reset)
    jes = jax_reset
    jstep = jax.jit(jax.vmap(jenv.step), compiler_options=FAST_COMPILE)
    a = np.broadcast_to(ACTION, (B, 6)).copy()
    d0 = (es.sim.qpos[:, env.arm_qadr[0]] - float(ACTION[0])).abs()
    for _ in range(20):
        jes, jr, jdone, jinfo = jstep(jes, jnp.asarray(a))
        es, r, done, info = env.step(es, torch.from_numpy(a))
    np.testing.assert_allclose(es.sim.qpos.numpy(), np.asarray(jes.sim.qpos),
                               atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(info["dist"].numpy(),
                               np.asarray(jinfo["dist"]), atol=1e-4)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    # the setpoint pulls the base joint closer, and reward = -dist (+1)
    assert bool(((es.sim.qpos[:, env.arm_qadr[0]] - float(ACTION[0])).abs()
                 < d0).all())
    np.testing.assert_allclose(
        r.numpy(), -info["dist"].numpy() + info["success"].numpy(),
        atol=1e-6)


@pytest.fixture(scope="module")
def mixed_start(envs, jax_reset):
    """JAX's reset with its targets moved to four of the port's draws, two
    that converge within 500 steps and two that do not."""
    jenv, env = envs
    drawn = env.reset(torch.Generator().manual_seed(5), 128)
    q = np.array(jax_reset.sim.qpos)
    q[:, env.target_qadr] = drawn.sim.qpos[[45, 18, 0, 2]][
        :, env.target_qadr].numpy()
    target = fk(env.model, torch.from_numpy(q)).xpos[:, env.target_body]
    return jax_reset.replace(sim=jax_reset.sim.replace(qpos=jnp.asarray(q)),
                             target=jnp.asarray(target.numpy()))


def test_reach_ik_matches_jax(envs, mixed_start):
    jenv, env = envs
    jax_reset = mixed_start
    jes, jinfo = jax.jit(jax.vmap(lambda e: jenv.reach_ik(
        e, max_steps=500)), compiler_options=FAST_COMPILE)(jax_reset)
    es, info = env.reach_ik(_carried(jax_reset), max_steps=500)
    for k in ("ik_ok", "converged"):
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]))
    assert info["ik_ok"].all()
    # two scenarios converge (frozen early, their steps counted), two not
    assert info["converged"].tolist() == [True, True, False, False]
    assert (info["steps"][:2] < 400).all() and (info["steps"][2:] == 500).all()
    assert np.abs(info["steps"].numpy()
                  - np.asarray(jinfo["steps"])).max() <= 1
    np.testing.assert_allclose(es.sim.qpos.numpy(), np.asarray(jes.sim.qpos),
                               atol=1e-3)
    np.testing.assert_allclose(info["dist"].numpy(), np.asarray(jinfo["dist"]),
                               atol=1e-4)
    # the reach closes in on every target; where the joints converged the
    # grasp centre is within 8 cm (a 0.05 rad joint tolerance)
    d0 = torch.linalg.vector_norm(
        env.ee_pos(torch.from_numpy(np.array(jax_reset.sim.qpos)))
        - torch.from_numpy(np.array(jax_reset.target)), dim=-1)
    assert (info["dist"] < d0).all(), (info["dist"], d0)
    assert (info["dist"][info["converged"]] < 0.08).all(), info["dist"]
    np.testing.assert_allclose(es.setpoints.numpy(),
                               np.asarray(jes.setpoints), atol=1e-4)
