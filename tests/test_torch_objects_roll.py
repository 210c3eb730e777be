"""The dropped object pile rolled by the port and by the JAX package side
by side: 100 contact steps of the object fixture (B=2, ncon=128,
iterations=30, warm started), from the grid of spheres, boxes, cylinders
and capsules above the bin with seeded orientations and heights, on
identical compiled arrays (model_from_arrays), as
tests/test_torch_pile_roll.py holds the box-and-cylinder pile.

The first 100 steps take the objects through free fall into their first
impacts. Three columns of the grid are restacked so that a sphere, a
capsule and a cylinder each fall onto a cylinder on the bottom layer
(their bounding spheres 3 mm apart): every narrowphase group that can
meet inside the bin brings an active contact (distance below the 1 mm
margin) in some step of the roll, the sphere-hull and capsule-hull groups
(the port's plain versions of their kernels) included; the floor's groups
meet nothing in a drop into the bin. Both packages run the same float32
arithmetic in another order; the roll stays on one trajectory: object
positions within 1e-4 m, the largest object speed within 1e-3 of its
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.physics import constraints as jcon
from mujoco_rl_ur5_tpu.physics import dynamics as jdyn
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays
from mujoco_rl_ur5_tpu_torch.physics import constraints, cuda_collide, dynamics
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file, load_model
from mujoco_rl_ur5_tpu_torch.scene.mjcf import GEOM_PLANE, JNT_FREE
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, State

B, STEPS, ITERS = 2, 100, 30


def test_dropped_object_pile_rolls_like_jax(monkeypatch):
    jm = jax_compile_spec(jax_parse_mjcf(OBJECTS))
    m = model_from_arrays(compile_file(OBJECTS).topo,
                          {n: np.asarray(getattr(jm, n))
                           for n in ARRAY_FIELDS})
    t = m.topo
    rng = np.random.default_rng(5)
    q = np.tile(m.qpos0.numpy().astype(np.float64), (B, 1))
    dz = rng.uniform(0.0, 0.1, B)
    free = np.nonzero(t.jnt_type == JNT_FREE)[0]
    for j in free:
        qa = t.jnt_qposadr[j]
        q[:, qa: qa + 2] += rng.uniform(-0.003, 0.003, (B, 2))
        q[:, qa + 2] += dz
        quat = rng.normal(size=(B, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)

    def qadr(i):
        return t.jnt_qposadr[t.joint_id(f"free_joint_{i}")]

    slot = {i: q[:, qadr(i): qadr(i) + 3].copy() for i in range(40)}
    rb = {i: float(m.geom_rbound[t.geom_id(f"object_{i}_geom")])
          for i in range(40)}
    # (lower cylinder, upper object, bottom-layer slot's object, where the
    # displaced objects go): sphere 7 on cylinder 20, capsule 36 on
    # cylinder 26, cylinder 21 on cylinder 24
    moves = {}
    for lo, up, bottom, away in ((20, 7, 7, {8: 20}), (26, 36, 36, {}),
                                 (24, 21, 24, {34: 21})):
        moves[lo] = slot[bottom]
        moves[up] = slot[bottom] + [0.0, 0.0, rb[lo] + rb[up] + 0.003]
        moves.update({i: slot[j] for i, j in away.items()})
    for i, p in moves.items():
        q[:, qadr(i): qadr(i) + 3] = p
    qpos = q.astype(np.float32)
    zeros = np.zeros((B, t.nv), np.float32)
    ctrl = np.zeros((B, t.nu), np.float32)
    s = State(torch.from_numpy(qpos), torch.from_numpy(zeros),
              torch.from_numpy(ctrl), torch.zeros(B))
    js = JState(jnp.asarray(qpos), jnp.asarray(zeros), jnp.asarray(ctrl),
                jnp.zeros(B))

    # the deepest candidate each wrapped group produced over the roll
    deepest = {}
    for key, wrapper in list(cuda_collide.BATCHED.items()):
        def seen(*args, _w=wrapper, _k=key):
            out = _w(*args)
            deepest[_k] = min(deepest.get(_k, np.inf), float(out[2].min()))
            return out
        monkeypatch.setitem(cuda_collide.BATCHED, key, seen)

    w = constraints.init_warm(m, s)
    jw = jax.vmap(lambda st: jcon.init_warm(jm, st))(js)
    jstep = jax.jit(jax.vmap(lambda st, ww: jdyn.step_warm(jm, st, ww, 128,
                                                           ITERS)))
    for _ in range(STEPS):
        s, w = dynamics.step_warm(m, s, w, 128, ITERS)
        js, jw = jstep(js, jw)
    pos = t.jnt_qposadr[free][:, None] + np.arange(3)
    got, ref = s.qpos.numpy()[:, pos], np.asarray(js.qpos)[:, pos]
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    vmax = np.abs(np.asarray(js.qvel)[:, 8:]).max()
    assert vmax > 1.0                              # the objects have landed
    assert abs(float(s.qvel[:, 8:].abs().max()) - vmax) <= 1e-3 * vmax
    in_scene = {(a, b) for a, b, _ in t.pair_groups}
    for key in cuda_collide.BATCHED:
        if key in in_scene and key[0] != GEOM_PLANE:
            assert deepest[key] < 1e-3, (key, deepest[key])   # the margin


# -- the port's roll on its own: a repeat, and scenarios rolled alone -------

SHORT, LOWER = 40, 0.045


def _short_roll(m, qpos):
    """SHORT warm-started contact steps of the port from ``qpos`` at rest."""
    t = m.topo
    n = qpos.shape[0]
    s = State(torch.from_numpy(qpos), torch.zeros(n, t.nv),
              torch.zeros(n, t.nu), torch.zeros(n))
    w = constraints.init_warm(m, s)
    for _ in range(SHORT):
        s, w = dynamics.step_warm(m, s, w, 128, ITERS)
    return s


@pytest.fixture(scope="module")
def one_thread():
    """The port's small CPU ops run faster on one thread, and leave the
    other workers' cores alone (the JAX comparison above keeps its
    threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def short_roll(one_thread):
    """The object pile's grid with seeded orientations, lowered by LOWER so
    that its lowest layer lands within the first SHORT steps, in 3
    scenarios; their roll."""
    m = load_model(OBJECTS, device="cpu")
    t = m.topo
    rng = np.random.default_rng(6)
    q = np.tile(m.qpos0.numpy().astype(np.float64), (3, 1))
    free = np.nonzero(t.jnt_type == JNT_FREE)[0]
    for j in free:
        qa = t.jnt_qposadr[j]
        q[:, qa + 2] -= LOWER
        quat = rng.normal(size=(3, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    qpos = q.astype(np.float32)
    return m, qpos, _short_roll(m, qpos)


def test_objects_roll_repeats_to_the_bit(short_roll):
    m, qpos, s = short_roll
    again = _short_roll(m, qpos)
    assert torch.equal(again.qpos, s.qpos) and torch.equal(again.qvel,
                                                           s.qvel)


def test_objects_roll_scenarios_roll_alone(short_roll):
    """Scenario 1 rolled as a batch of its own equals its row of the batch
    to the bit (the premise of scenario-parallel envs), through the first
    impacts: some object's fall has been stopped."""
    m, qpos, s = short_roll
    t = m.topo
    alone = _short_roll(m, qpos[1:2])
    assert torch.equal(alone.qpos, s.qpos[1:2])
    assert torch.equal(alone.qvel, s.qvel[1:2])
    vz = [t.jnt_dofadr[j] + 2 for j in np.nonzero(t.jnt_type == JNT_FREE)[0]]
    free_fall = 9.81 * SHORT * t.timestep
    assert float(s.qvel[:, vz].max()) > -0.5 * free_fall
