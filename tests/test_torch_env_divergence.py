"""A contact step that diverges in the JAX package as in the port.

``chip_smoke.py`` phase 11d picks at bench_env's quick scale (B=64, the
draw from a CUDA generator seeded with 64, budget_scale=0.1,
iterations=30, ncon=128). Scenario 0 of that pick went non-finite on the
card: in phase 0 (the move to the pre-grasp) its largest speed rose to
23.8 at contact step 29 and fell back to 15.7 at step 38; step 39 took it
to 9.2e5, and the state overflowed six steps later. The card's inputs of
steps 38 and 39 for that scenario (state, control and the solver's warm
start), recorded by ``scripts/torch_env_witness.py``, are in
``tests/data/env_divergence.npz`` with the card's largest output speed of
every step of the pick.

From those inputs, on identical compiled arrays (``model_from_arrays``):

* step 38: the port's plain step and JAX's ``step_warm`` agree, qpos and
  qvel within 1e-4, and both keep the card's largest speed within 1e-3 of
  its value;
* step 39: both blow up as the card did, the largest speed above 1e5
  (the card 9.2e5), on the same dof, and within a factor of 1.5 of each
  other.

So the divergence belongs to the contact model both packages share, not
to a kernel of the port: ``chip_smoke.py`` exempts that one scenario and
raises on any other that goes non-finite.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_rl_ur5_tpu.physics import dynamics as jdyn
from mujoco_rl_ur5_tpu.scene.compile import compile_spec as jax_compile_spec
from mujoco_rl_ur5_tpu.scene.mjcf import parse_mjcf as jax_parse_mjcf
from mujoco_rl_ur5_tpu.scene.model import State as JState
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.carry import model_from_arrays
from mujoco_rl_ur5_tpu_torch.physics import dynamics
from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
from mujoco_rl_ur5_tpu_torch.scene.model import ARRAY_FIELDS, State

NCON, ITERS = 128, 30
DATA = os.path.join(os.path.dirname(__file__), "data", "env_divergence.npz")


def test_recorded_divergence_is_shared_with_jax():
    rec = np.load(DATA)
    card = rec["card_max_qvel_out"]
    jm = jax_compile_spec(jax_parse_mjcf(OBJECTS))
    m = model_from_arrays(compile_file(OBJECTS).topo,
                          {n: np.asarray(getattr(jm, n))
                           for n in ARRAY_FIELDS})
    jstep = jax.jit(lambda st, w: jdyn.step_warm(jm, st, w, NCON, ITERS))
    outs = {}
    for k in (38, 39):
        qpos, qvel, ctrl, t = (rec[f"s{k}_{f}"] for f in ("qpos", "qvel",
                                                         "ctrl", "time"))
        warm = (rec[f"s{k}_warm_f"], rec[f"s{k}_warm_s"])
        s, _ = dynamics.step_warm(
            m, State(*(torch.from_numpy(a) for a in (qpos, qvel, ctrl, t))),
            tuple(torch.from_numpy(w) for w in warm), NCON, ITERS)
        js, _ = jstep(JState(*(jnp.asarray(a[0]) for a in (qpos, qvel, ctrl,
                                                           t))),
                      tuple(jnp.asarray(w[0]) for w in warm))
        outs[k] = (s.qpos[0].numpy(), s.qvel[0].numpy(),
                   np.asarray(js.qpos), np.asarray(js.qvel))
    q, v, jq, jv = outs[38]
    np.testing.assert_allclose(q, jq, atol=1e-4, rtol=0)
    np.testing.assert_allclose(v, jv, atol=1e-4, rtol=0)
    for speed in (np.abs(v).max(), np.abs(jv).max()):
        assert abs(speed - card[38]) <= 1e-3 * card[38]
    _, v, _, jv = outs[39]
    assert card[38] < 20.0 and card[39] > 1e5
    assert np.abs(v).max() > 1e5 and np.abs(jv).max() > 1e5
    assert np.abs(v).argmax() == np.abs(jv).argmax()
    assert 1 / 1.5 < np.abs(v).max() / np.abs(jv).max() < 1.5
