"""The port's learning stack (mujoco_rl_ur5_tpu_torch/learn/) against the
JAX package's learn/ on the CPU.

Inputs come from numpy seeds, the JAX network runs at ``dtype=float32`` and
its weights come across with ``carry.agent_from_arrays`` /
``carry.train_state_from_arrays``. Tolerances:

* the network at full widths (64-512) on 32 x 32: logits within 1e-4 of
  max|logit| in eval and train mode, the new BatchNorm statistics within
  1e-5 of each tensor's largest entry, ``count_parameters`` equal; the 2x
  resize within 1e-6 of ``jax.image.resize``, edges included;
* ``train_step`` on a batch of 4 from carried weights, and a second step
  from JAX's state after the first, in float32 (32 x 32) and in float64
  (16 x 16; JAX under x64 with a float64 network, the port's model in
  float64): the loss
  within 1e-5 relative (3e-5 in float32: JAX's own float32 loss lies up to
  1.4e-5 from the float64 loss on these batches, the port's 2.8e-6), the
  new BatchNorm statistics within 1e-5 of their largest entry; in float64
  each gradient within 1e-3 of its tensor's norm and each Adam moment
  within 1e-5 of its tensor's largest entry. Gradients and moments are not
  held in float32: there both packages' gradients lie up to 1.6e-3 (JAX)
  and 8.8e-3 (the port: one ReLU input within roundoff of 0 takes the
  other side) of a tensor's norm from the float64 gradient (the BatchNorm
  backward's cancellation);
* ``transform_observation`` in both modes and depth-only, fed JAX's own
  draws (the same key splits), within 1e-5;
* the greedy action equal to JAX's flat argmax, ties planted (the first
  index wins); the random branch only on pixels at table height or above,
  over all rotations; the eps schedule within 1e-12 of JAX's;
* the replay ring, its newest-plus-random sample, the batched push and the
  rotation counters equal to JAX's exactly; a checkpoint round trip equal
  to the bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.learn.agent import AgentConfig as JConfig
from mujoco_rl_ur5_tpu.learn.agent import GraspAgent as JAgent
from mujoco_rl_ur5_tpu.learn.networks import MultidiscreteResnet as JNet
from mujoco_rl_ur5_tpu.learn.networks import PolicyResnet as JPolicy
from mujoco_rl_ur5_tpu.learn.networks import _resize2x as j_resize
from mujoco_rl_ur5_tpu.learn.networks import (
    count_parameters as j_count_parameters,
)
from mujoco_rl_ur5_tpu.learn.replay import ReplayBuffer as JReplay
from mujoco_rl_ur5_tpu_torch.carry import (
    agent_from_arrays, replay_from_arrays, train_state_from_arrays,
)
from mujoco_rl_ur5_tpu_torch.learn import (
    AgentConfig, GraspAgent, MultidiscreteResnet, ReplayBuffer,
    count_parameters,
)
from mujoco_rl_ur5_tpu_torch.learn.agent import COUNTERS, TABLE_HEIGHT
from mujoco_rl_ur5_tpu_torch.learn.networks import PolicyResnet, _resize2x


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the suite runs several test files
    at once, and each file's threads would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, NB = 32, 4          # image side, batch
KW = dict(width=S, height=S, memory_size=16, batch_size=NB, dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def agents():
    ja = JAgent(JConfig(**KW))
    pa = GraspAgent(AgentConfig(**KW), device="cpu")
    jts = ja.init(jax.random.PRNGKey(0))
    return ja, pa, jts


def _batch(seed, n=NB, side=S):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, side, side, 4)).astype(np.float32)
    a = rng.integers(0, 6 * side * side, n).astype(np.int32)
    r = (np.arange(n) % 2 == 0).astype(np.float32)
    return x, a, r


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_depth_clip_derived_from_camera_height():
    assert AgentConfig().depth_clip == pytest.approx(1.1)
    assert AgentConfig(cam_z=1.7).depth_clip == pytest.approx(0.8)
    for cam_z in (2.0, 1.7, 1.234):
        assert (AgentConfig(cam_z=cam_z).depth_clip
                == JConfig(cam_z=cam_z).depth_clip)


# -- the network -------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_network_matches_jax(agents, train):
    ja, pa, jts = agents
    ts = train_state_from_arrays(pa, _np(jts))
    x, _, _ = _batch(1)
    out = ja.net.apply({"params": jts.params, "batch_stats": jts.batch_stats},
                       jnp.asarray(x), train=train,
                       mutable=["batch_stats"] if train else False)
    qj, bj = (out[0], out[1]["batch_stats"]) if train else (out, None)
    qp = ts.model(torch.from_numpy(x), train=train).detach().numpy()
    assert qp.shape == (NB, 6, S, S) and qp.dtype == np.float32
    assert _rel(qp, qj) < 1e-4
    assert count_parameters(ts.model) == j_count_parameters(jts.params)
    if train:
        sd = ts.model.state_dict()
        for name, want in agent_from_arrays({}, _np(bj)).items():
            assert _rel(sd[name], want) < 1e-5, name


def test_policy_resnet_sums_to_one():
    jp = JPolicy(dtype=jnp.float32)
    v = jp.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 4)))
    net = PolicyResnet(dtype="float32")
    net.load_state_dict(agent_from_arrays(_np(v["params"]),
                                          _np(v["batch_stats"])))
    x = np.random.default_rng(2).uniform(0, 1, (2, 16, 16, 4)).astype(
        np.float32)
    p = net(torch.from_numpy(x)).detach().numpy()
    assert p.shape == (2, 16 * 16)
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)
    want = np.asarray(jp.apply(v, jnp.asarray(x)))
    assert _rel(p, want) < 1e-4


def test_resize_matches_jax_image_resize():
    x = np.random.default_rng(4).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x)))
    got = _resize2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    assert got.shape == (2, 10, 14, 3)
    assert np.abs(got - want).max() < 1e-6


# -- the train step ----------------------------------------------------------


def _jax_agent(dtype):
    """JAX's agent; at float64 with a float64 network (x64 must be on)."""
    ja = JAgent(JConfig(**KW))
    if dtype == "float64":
        ja.net = JNet(rotations=6, dtype=jnp.float64)
    return ja


# the loss, port vs JAX: 1e-5 relative in float64; in float32 3e-5, since
# JAX's own float32 loss lies up to 1.4e-5 from the float64 loss on these
# batches (the port's 2.8e-6)
LOSS_TOL = {"float32": 3e-5, "float64": 1e-5}
# the float64 steps at 16 x 16: XLA's float64 convolutions on the CPU take
# ~28 s per step at 32 x 32 on one core
SIDE = {"float32": S, "float64": 16}


def _jax_state(ja, jts, dtype):
    """A copy of ``jts`` (train_step donates its state) with its network
    in ``dtype`` and a fresh optimiser state."""
    jts = jax.tree.map(jnp.array, jts)
    params = jax.tree.map(lambda v: jnp.asarray(v, dtype), jts.params)
    return jts.replace(params=params, opt_state=ja.tx.init(params),
                       batch_stats=jax.tree.map(
                           lambda v: jnp.asarray(v, dtype), jts.batch_stats))


def _moments(ts):
    """{name: (exp_avg, exp_avg_sq)} of the port's optimiser."""
    return {n: (ts.optimizer.state[p]["exp_avg"],
                ts.optimizer.state[p]["exp_avg_sq"])
            for n, p in ts.model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_matches_jax(agents, dtype):
    _, pa, jts0 = agents
    with jax.enable_x64(dtype == "float64"):
        ja = _jax_agent(dtype)
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        jts = _jax_state(ja, jts0, jdt)
        # step 1 from the carried weights, step 2 from JAX's state after it
        ts = train_state_from_arrays(pa, _np(jts))
        for step, seed in ((1, 5), (2, 6)):
            x, a, r = _batch(seed, side=SIDE[dtype])
            jts, jloss = ja.train_step(jts, jnp.asarray(x, jdt),
                                       jnp.asarray(a), jnp.asarray(r))
            ts, loss = pa.train_step(ts, torch.from_numpy(x),
                                     torch.from_numpy(a), torch.from_numpy(r))
            assert abs(float(loss) / float(jloss) - 1) < LOSS_TOL[dtype], step
            sd = ts.model.state_dict()
            for name, want in agent_from_arrays(
                    {}, _np(jts.batch_stats)).items():
                assert _rel(sd[name], want) < 1e-5, (step, name)
            if dtype == "float64":
                adam = jts.opt_state[0]
                mu = agent_from_arrays(_np(adam.mu))
                nu = agent_from_arrays(_np(adam.nu))
                for name, (m, v) in _moments(ts).items():
                    assert _rel(m, mu[name]) < 1e-5, (step, name)
                    assert _rel(v, nu[name]) < 1e-5, (step, name)
                    if step == 1:      # mu = (1 - b1) g from zero moments
                        g = ts.model.get_parameter(name).grad
                        gj = mu[name] / 0.1
                        assert float((g - gj).abs().max()
                                     / gj.norm()) < 1e-3, name
            # the next step starts from JAX's state, carried across
            ts = train_state_from_arrays(pa, _np(jts))
    assert ts.optimizer.state[next(ts.model.parameters())]["step"] == 2


def test_accumulated_steps_average_the_gradients():
    """accum_steps=2: the first call banks, the second steps with the mean
    gradient (optax.MultiSteps); equal to one step on the mean gradient."""
    kw = dict(KW, width=16, height=16)
    acc = GraspAgent(AgentConfig(**kw, accum_steps=2), device="cpu")
    one = GraspAgent(AgentConfig(**kw), device="cpu")
    ts = acc.init(torch.Generator().manual_seed(0))
    ref = one.state_for(copy.deepcopy(ts.model).double())
    ts = acc.state_for(ts.model.double())
    rng = np.random.default_rng(8)
    xs = torch.from_numpy(rng.uniform(0, 1, (2, NB, 16, 16, 4)))
    a = torch.from_numpy(rng.integers(0, 6 * 256, (2, NB)))
    r = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    w0 = [p.detach().clone() for p in ts.model.parameters()]
    ts, _ = acc.train_step(ts, xs[0], a[0], r)
    assert ts.mini_step == 1
    assert all(torch.equal(p, w) for p, w in zip(ts.model.parameters(), w0))
    ts, _ = acc.train_step(ts, xs[1], a[1], r)
    assert ts.mini_step == 0
    # the reference: the mean of the two batches' gradients, one step
    grads = []
    for i in range(2):
        ref.model.zero_grad()
        one.loss(ref, xs[i], a[i], r)[0].backward()
        grads.append([p.grad.clone() for p in ref.model.parameters()])
    for p, g0, g1 in zip(ref.model.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    ref.optimizer.step()
    for p, q in zip(ts.model.parameters(), ref.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-12)


# -- the observation transform -----------------------------------------------


def _jax_draws(keys, cfg, shape):
    """JAX's transform draws from ``keys`` (its own splits): the noise map
    and the jitter factors (b, c, s, h) per key."""
    def one(key):
        knoise, kjit = jax.random.split(key)
        noise = cfg.noise_sigma * jax.random.normal(knoise, shape)
        kb, kc, ks, kh, _ = jax.random.split(kjit, 5)
        u = [jax.random.uniform(k, (), minval=lo, maxval=hi)
             for k, lo, hi in ((kb, .5, 1.5), (kc, .5, 1.5), (ks, .5, 1.5),
                               (kh, -.5, .5))]
        return noise, jnp.stack(u)
    return jax.vmap(one)(keys)


@pytest.mark.parametrize("mode", ["normalize", "standardize", "depth_only"])
def test_transform_observation_matches_jax(mode):
    kw = dict(KW, normalization="standardize" if mode == "standardize"
              else "normalize", depth_only=mode == "depth_only")
    ja, pa = JAgent(JConfig(**kw)), GraspAgent(AgentConfig(**kw),
                                               device="cpu")
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (3, S, S, 3)).astype(np.uint8)
    depth = rng.uniform(0.9, 1.3, (3, S, S)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    want = np.asarray(jax.vmap(ja.transform_observation)(
        None if mode == "depth_only" else jnp.asarray(rgb),
        jnp.asarray(depth), keys))
    noise, jitter = _jax_draws(keys, ja.cfg, (S, S))
    got = pa.apply_observation(torch.from_numpy(rgb), torch.from_numpy(depth),
                               torch.from_numpy(np.array(noise)),
                               torch.from_numpy(np.array(jitter))).numpy()
    assert got.shape == want.shape == (3, S, S, 1 if mode == "depth_only"
                                       else 4)
    assert np.abs(got - want).max() < 1e-5
    # the port's own draws: the noise's scale, the jitter's ranges
    g = torch.Generator().manual_seed(0)
    noise, jitter = pa.draw_observation_noise(g, (64, S, S))
    assert abs(float(noise.std()) / pa.cfg.noise_sigma - 1) < 0.01
    lo = torch.tensor([0.5, 0.5, 0.5, -0.5])
    assert bool(((jitter >= lo) & (jitter < lo + 1)).all())
    out = pa.transform_observation(torch.from_numpy(rgb),
                                   torch.from_numpy(depth), g)
    assert out.shape == got.shape and bool(torch.isfinite(out).all())


# -- action selection --------------------------------------------------------


class _Fixed(torch.nn.Module):
    """A stand-in network that returns the given logits."""

    def __init__(self, q):
        super().__init__()
        self.q = q

    def forward(self, x, train=False):
        return self.q


def test_greedy_matches_jax_argmax_ties_included(agents):
    ja, pa, jts = agents
    ts = train_state_from_arrays(pa, _np(jts))
    x, _, _ = _batch(12, 2)
    # the network's own maps
    got, _ = pa.greedy(ts, torch.from_numpy(x))
    want = [int(ja.greedy(jts, jnp.asarray(x[b]))[0]) for b in range(2)]
    assert got.tolist() == want
    # planted ties: the first flat index wins in both
    rng = np.random.default_rng(13)
    q = rng.normal(size=(4, 6, S, S)).astype(np.float32)
    top = q.max() + 1
    q[0, 2, 3, 4] = q[0, 5, 0, 0] = q[0, 2, 3, 5] = top
    q[1, :, :, :] = 0.0
    q[2, 0, 7, 7] = q[2, 0, 7, 6] = top
    q[3, 1, 0, 0] = q[3, 0, 31, 31] = top
    got, _ = pa.greedy(ts.replace(model=_Fixed(torch.from_numpy(q))),
                       torch.zeros(4, S, S, 4))
    want = np.asarray(jnp.argmax(jnp.asarray(q).reshape(4, -1), axis=1))
    assert got.tolist() == want.tolist() == [
        2 * S * S + 3 * S + 4, 0, 7 * S + 6, S * S - 1]
    # far into the schedule (eps ~ 0.2) the greedy draws take that action
    flat, was = pa.epsilon_greedy(
        ts.replace(model=_Fixed(torch.from_numpy(q)), step=800000),
        torch.zeros(4, S, S, 4), torch.ones(4, S, S),
        torch.Generator().manual_seed(1))
    assert torch.equal(flat[was], got[was])


def test_random_branch_stays_on_the_table(agents):
    _, pa, jts = agents
    # the random branch does not read the network: a stand-in keeps it cheap
    ts = train_state_from_arrays(pa, _np(jts))
    ts = ts.replace(model=_Fixed(torch.zeros(256, 6 * S * S)))
    c = pa.cfg
    assert pa.epsilon(ts) == 1.0                 # step 0: every draw random
    depth = torch.full((256, S, S), c.cam_z - TABLE_HEIGHT)   # z = 0.91
    depth[:, :, S // 2:] = c.cam_z - 0.5                      # z = 0.50
    obs = torch.zeros(256, S, S, 4)
    g = torch.Generator().manual_seed(3)
    pix, rots = set(), set()
    for _ in range(4):
        flat, was = pa.epsilon_greedy(ts, obs, depth, g)
        assert not bool(was.any())
        p = (flat % (S * S)).tolist()
        assert all(i % S < S // 2 for i in p), "a pixel below the table"
        pix.update(p)
        rots.update((flat // (S * S)).tolist())
    assert rots == set(range(6))
    assert len(pix) > 0.5 * S * S // 2           # spread over the table
    # no pixel on the table: pixel 0, as JAX's categorical over all -inf
    ts = ts.replace(model=_Fixed(torch.zeros(8, 6 * S * S)))
    flat, _ = pa.epsilon_greedy(ts, obs[:8], torch.full((8, S, S), 1.9), g)
    assert ((flat % (S * S)) == 0).all()


def test_epsilon_schedule_matches_jax(agents):
    ja, pa, jts = agents
    ts = train_state_from_arrays(pa, _np(jts))
    for step in (0, 1, 100, 8000, 50000):
        want = ja.epsilon(jts.replace(step=jnp.asarray(step, jnp.int32)))
        assert abs(pa.epsilon(ts.replace(step=step)) - want) < 1e-12


def test_transform_action():
    pa = GraspAgent(AgentConfig(**KW), device="cpu")
    flat = torch.tensor([0, 5, 2 * S * S + 37, 6 * S * S - 1])
    assert pa.transform_action(flat).tolist() == [
        [0, 0], [5, 0], [37, 2], [S * S - 1, 5]]


# -- replay and counters -----------------------------------------------------


def test_replay_ring_matches_jax():
    jb, pb = JReplay(8, (2, 2, 1)), ReplayBuffer(8, (2, 2, 1), device="cpu")
    js, ps = jb.init(), pb.init()
    for i in range(10):                      # wraps: slots hold 2..9
        s = np.full((2, 2, 1), float(i), np.float32)
        js = jb.push(js, jnp.asarray(s), jnp.int32(i), jnp.float32(i))
        ps = pb.push(ps, torch.from_numpy(s), i, float(i))
    # a batch of 5 across the wrap
    s = (20 + np.arange(5, dtype=np.float32))[:, None, None, None] \
        * np.ones((1, 2, 2, 1), np.float32)
    a = 20 + np.arange(5, dtype=np.int32)
    js = jb.push(js, jnp.asarray(s), jnp.asarray(a), jnp.asarray(a, float))
    ps = pb.push(ps, torch.from_numpy(s), torch.from_numpy(a),
                 torch.from_numpy(a.astype(np.float32)))
    want = replay_from_arrays(_np(js))
    for f in ("states", "actions", "rewards"):
        assert torch.equal(getattr(ps, f), getattr(want, f)), f
    assert (ps.position, ps.size) == (want.position, want.size) == (7, 8)
    # a batch longer than the ring: the newest write of each slot wins, as
    # one push at a time gives (JAX leaves repeated scatter indices
    # unordered, so this is held against single pushes)
    one = copy.deepcopy(ps)
    for i in range(11):
        one = pb.push(one, torch.full((2, 2, 1), 40.0 + i), 40 + i,
                      40.0 + i)
    ps = pb.push(ps, 40 + torch.arange(11.0)[:, None, None, None]
                 * torch.ones(1, 2, 2, 1), 40 + torch.arange(11),
                 40 + torch.arange(11.0))
    for f in ("states", "actions", "rewards"):
        assert torch.equal(getattr(ps, f), getattr(one, f)), f
    assert (ps.position, ps.size) == (one.position, one.size) == (2, 8)
    assert ps.actions.tolist() == [49, 50, 43, 44, 45, 46, 47, 48]


def test_replay_sample_quirk():
    buf = ReplayBuffer(8, (2, 2, 1), device="cpu")
    st = buf.init()
    for i in range(10):
        st = buf.push(st, torch.full((2, 2, 1), float(i)), i, float(i))
    assert (st.size, st.position) == (8, 2)
    s, a, r = buf.sample(st, torch.Generator().manual_seed(0), 4)
    assert int(a[-1]) == 9                   # the newest, last
    assert set(a.tolist()) <= set(range(2, 10))
    assert torch.equal(s[:, 0, 0, 0], a.float()) and torch.equal(r, a.float())
    with pytest.raises(ValueError):
        buf.sample(buf.init(), torch.Generator(), 4)


def test_replay_sample_without_replacement():
    buf = ReplayBuffer(32, (1,), device="cpu")
    st = buf.init()
    for i in range(32):
        st = buf.push(st, torch.full((1,), float(i)), i, 0.0)
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(10):
        _, a, _ = buf.sample(st, g, 12)
        assert len(set(a[:-1].tolist())) == 11, "duplicate random draws"
        seen.update(a[:-1].tolist())
    assert len(seen) > 24                     # every slot can be drawn


def test_replay_batched_push():
    buf = ReplayBuffer(16, (1,), device="cpu")
    st = buf.push(buf.init(), torch.arange(5.0)[:, None], torch.arange(5),
                  torch.ones(5))
    assert st.size == 5 and st.position == 5
    assert st.actions[:5].tolist() == list(range(5))


def test_record_action_counters_match_jax(agents):
    ja, pa, jts = agents
    rng = np.random.default_rng(14)
    B = 24
    flat = rng.integers(0, 6 * S * S, B).astype(np.int32)
    reward = (rng.uniform(size=B) > 0.5).astype(np.float32)
    greedy = rng.uniform(size=B) > 0.5
    for b in range(B):                       # JAX's per-scenario loop
        jts = ja.record_action(jts, jnp.asarray(flat[b]),
                               jnp.asarray(reward[b]),
                               jnp.asarray(greedy[b]))
    ts = pa.state_for(MultidiscreteResnet(dtype="float32"))
    ts = pa.record_action(ts, torch.from_numpy(flat), torch.from_numpy(reward),
                          torch.from_numpy(greedy))
    assert ts.step == int(jts.step) == B
    for k in COUNTERS:
        assert getattr(ts, k).tolist() == np.asarray(getattr(jts, k)).tolist()
        assert getattr(ts, k).dtype == torch.int32


def test_checkpoint_roundtrip_to_the_bit(tmp_path):
    kw = dict(KW, width=16, height=16)
    pa = GraspAgent(AgentConfig(**kw), device="cpu")
    ts = pa.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(15)
    buf = pa.memory.init()
    buf = pa.memory.push(buf, torch.from_numpy(
        rng.uniform(size=(10, 16, 16, 4)).astype(np.float32)),
        torch.arange(10), torch.ones(10))
    ts, _ = pa.learn(ts, buf, torch.Generator().manual_seed(4))
    ts = pa.record_action(ts, torch.tensor([3, 700]), torch.tensor([1., 0.]),
                          torch.tensor([True, False]))
    path = str(tmp_path / "ckpt.pt")
    pa.save(path, ts, buf)
    fresh = pa.init(torch.Generator().manual_seed(5))
    ts2, buf2 = pa.restore(path, fresh, pa.memory.init())
    assert ts2.step == ts.step == 2
    for (n, a), (_, b) in zip(ts.model.state_dict().items(),
                              ts2.model.state_dict().items()):
        assert torch.equal(a, b), n
    st, st2 = ts.optimizer.state_dict(), ts2.optimizer.state_dict()
    assert st["param_groups"] == st2["param_groups"]
    for i, s in st["state"].items():
        for k, v in s.items():
            assert torch.equal(v, st2["state"][i][k]), (i, k)
    for k in COUNTERS:
        assert torch.equal(getattr(ts, k), getattr(ts2, k))
    for f in ("states", "actions", "rewards"):
        assert torch.equal(getattr(buf, f), getattr(buf2, f))
    assert (buf2.position, buf2.size) == (buf.position, buf.size)
