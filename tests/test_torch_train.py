"""The slice as a whole: the port's online Trainer (learn/train.py) on the
object pile on the CPU, its learning step replayed through the JAX
package's ``train_step``.

JAX's tests/test_train.py sizes: ncon=96, iterations=15, 24 x 24 images,
``budget_scale=0.005``, batch 4, memory 32, ``batch_envs=4``, 1 episode x 2
steps, float32. The Trainer starts from JAX's initial TrainState, carried
across with ``carry.train_state_from_arrays``. Learning starts once 8
transitions are banked, so ``learn`` trains once, at step 2; its input
(the sampled states, actions and rewards) is recorded and replayed:

* through the port's own ``train_step`` from the same state: loss and
  every gradient equal to the bit (the recording is the step);
* through JAX's ``train_step`` from the same state, with the limits of
  tests/test_torch_learn.py: in float32 the loss within 3e-5 relative and
  the new BatchNorm statistics within 1e-5 of their largest entry; in
  float64 (JAX under x64 with a float64 network, the port's model in
  float64) the loss within 1e-5, each gradient within 1e-3 of its
  tensor's norm and each Adam moment within 1e-5 of its largest entry.

The counters, the step and the replay's size equal 8; the rewards are in
{0, 1}; the checkpoint written at the end restores them, the model and the
replay ring.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.learn.agent import AgentConfig as JConfig
from mujoco_rl_ur5_tpu.learn.agent import GraspAgent as JAgent
from mujoco_rl_ur5_tpu.learn.networks import MultidiscreteResnet as JNet
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.carry import (
    agent_from_arrays, train_state_from_arrays,
)
from mujoco_rl_ur5_tpu_torch.learn.agent import COUNTERS, AgentConfig
from mujoco_rl_ur5_tpu_torch.learn.train import Trainer
from mujoco_rl_ur5_tpu_torch.utils.config import (
    Config, EnvConfig, SceneConfig, SolverConfig, TrainConfig,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the suite runs several test files
    at once, and each file's threads would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S = 24
AGENT = dict(width=S, height=S, memory_size=32, batch_size=4,
             dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    cfg = Config(
        scene=SceneConfig(path=OBJECTS),
        solver=SolverConfig(ncon=96, iterations=15),
        env=EnvConfig(image_width=S, image_height=S, budget_scale=0.005),
        agent=AgentConfig(**AGENT),
        train=TrainConfig(episodes=1, steps_per_episode=2, batch_envs=4,
                          seed=3, save_every_episodes=1,
                          checkpoint_dir=ckpt, logdir=None))
    tr = Trainer(cfg, device="cpu")
    ja = JAgent(JConfig(**AGENT))
    jts0 = ja.init(jax.random.PRNGKey(3))
    agent = tr.agent
    agent.init = lambda generator: train_state_from_arrays(agent, _np(jts0))
    learned = []
    step = agent.train_step

    def recording(ts, states, actions, rewards):
        out = step(ts, states, actions, rewards)
        learned.append(dict(
            states=states.clone(), actions=actions.clone(),
            rewards=rewards.clone(), loss=out[1].clone(),
            grads={n: p.grad.clone()
                   for n, p in out[0].model.named_parameters()},
            state=copy.deepcopy(out[0].model.state_dict())))
        return out

    agent.train_step = recording
    ts, buf = tr.run(verbose=False)
    return dict(cfg=cfg, tr=tr, ts=ts, buf=buf, learned=learned, ja=ja,
                jts0=jts0, ckpt=ckpt)


def test_trainer_runs_the_slice(run):
    tr, ts, buf = run["tr"], run["ts"], run["buf"]
    # the agent's camera-dependent fields come from the env
    assert tr.agent.cfg.cam_z == pytest.approx(2.0)
    assert tr.agent.cfg.depth_clip == pytest.approx(1.1)
    # 1 episode x 2 steps x 4 envs
    assert ts.step == 8 and buf.size == 8 and buf.position == 8
    assert sum(int(getattr(ts, k).sum()) for k in COUNTERS) <= 8
    rewards = buf.rewards[:8]
    assert set(rewards.tolist()) <= {0.0, 1.0}
    assert bool(torch.isfinite(buf.states[:8]).all())
    assert int((buf.states[8:] != 0).sum()) == 0
    assert len(tr.tracker.last_1000_rewards) == 8
    assert len(run["learned"]) == 1 and len(tr.tracker.last_100_loss) == 4
    assert np.isfinite(float(run["learned"][0]["loss"]))


def test_learn_input_replays_through_the_port_to_the_bit(run):
    rec, agent = run["learned"][0], run["tr"].agent
    ts = train_state_from_arrays(agent, _np(run["jts0"]))
    ts, loss = agent.train_step(ts, rec["states"], rec["actions"],
                                rec["rewards"])
    assert torch.equal(loss, rec["loss"])
    for n, p in ts.model.named_parameters():
        assert torch.equal(p.grad, rec["grads"][n]), n
    for n, v in ts.model.state_dict().items():
        assert torch.equal(v, rec["state"][n]), n


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_learn_input_replays_through_jax(run, dtype):
    rec, agent, jts0 = run["learned"][0], run["tr"].agent, run["jts0"]
    s, a, r = (rec[k].numpy() for k in ("states", "actions", "rewards"))
    with jax.enable_x64(dtype == "float64"):
        ja = JAgent(JConfig(**AGENT))
        jdt = jnp.float32
        if dtype == "float64":
            ja.net, jdt = JNet(rotations=6, dtype=jnp.float64), jnp.float64
        jts = jax.tree.map(jnp.array, jts0)          # train_step donates
        params = jax.tree.map(lambda v: jnp.asarray(v, jdt), jts.params)
        jts = jts.replace(params=params, opt_state=ja.tx.init(params),
                          batch_stats=jax.tree.map(
                              lambda v: jnp.asarray(v, jdt), jts.batch_stats))
        if dtype == "float32":       # the Trainer's own step
            loss, grads, state = rec["loss"], rec["grads"], rec["state"]
            tol = 3e-5
        else:                        # the port's step in float64
            ts = train_state_from_arrays(agent, _np(jts))
            ts, loss = agent.train_step(ts, *map(torch.from_numpy, (s, a, r)))
            grads = {n: p.grad for n, p in ts.model.named_parameters()}
            state = ts.model.state_dict()
            tol = 1e-5
        jts, jloss = ja.train_step(jts, jnp.asarray(s, jdt), jnp.asarray(a),
                                   jnp.asarray(r))
        assert abs(float(loss) / float(jloss) - 1) < tol
        for name, want in agent_from_arrays({}, _np(jts.batch_stats)).items():
            assert _rel(state[name], want) < 1e-5, name
        if dtype == "float64":
            adam = jts.opt_state[0]
            mu = agent_from_arrays(_np(adam.mu))
            nu = agent_from_arrays(_np(adam.nu))
            for name, p in ts.model.named_parameters():
                st = ts.optimizer.state[p]
                assert _rel(st["exp_avg"], mu[name]) < 1e-5, name
                assert _rel(st["exp_avg_sq"], nu[name]) < 1e-5, name
                gj = mu[name] / 0.1      # mu = (1 - b1) g from zero moments
                assert float((grads[name] - gj).abs().max()
                             / gj.norm()) < 1e-3, name


def test_checkpoint_resumes_the_run(run):
    ts, buf = run["ts"], run["buf"]
    final = os.path.join(run["ckpt"], "final.pt")
    assert os.path.exists(final)
    assert os.path.exists(os.path.join(run["ckpt"], "ep00001.pt"))
    agent = run["tr"].agent
    fresh = agent.state_for(agent.make_model())
    ts2, buf2 = agent.restore(final, fresh, agent.memory.init())
    assert ts2.step == 8 and buf2.size == 8
    for k in COUNTERS:
        assert torch.equal(getattr(ts2, k), getattr(ts, k))
    for (n, v), (_, w) in zip(ts.model.state_dict().items(),
                              ts2.model.state_dict().items()):
        assert torch.equal(v, w), n
    for f in ("states", "actions", "rewards"):
        assert torch.equal(getattr(buf2, f), getattr(buf, f))
