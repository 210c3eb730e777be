"""The port's offline pipeline (learn/offline.py, learn/generate_data.py)
against the JAX package's on the CPU.

* Shards: a shard set written by JAX's ShardWriter is united, filtered and
  loaded by the port, and one written by the port's is read by JAX's,
  every array equal exactly (dtype included);
* ``GraspingDataset.split`` takes the same 80/20 as JAX's for a seed;
  ``binary_accuracy`` and ``AverageMeter`` equal JAX's;
* a short ``train_offline`` at 16 x 16 lowers the loss, as JAX's test asks;
* ``generate`` on the object pile (B=2, 16 x 16, ``budget_scale=0.004``)
  banks B transitions per step into shards of JAX's keys and dtypes;
* ``compute_mean_std`` takes one batched reset's per-channel mean and
  population std (1e-5 / 1e-4 relative of a float64 reduction), and its
  .npz is read by the JAX package's ``load_mean_std`` and the reverse.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.learn import offline as joff
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.learn import AgentConfig, GraspAgent
from mujoco_rl_ur5_tpu_torch.learn.offline import (
    AverageMeter, GraspingDataset, ShardWriter, binary_accuracy,
    extract_positives, train_offline, unite_data,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the suite runs several test files
    at once, and each file's threads would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _push_all(writer, torch_in):
    for i in range(10):
        s = np.full((8, 8, 4), float(i), np.float32)
        writer.push(torch.from_numpy(s) if torch_in else s, i, float(i % 2))
    s = np.zeros((2, 8, 8, 4), np.float32)
    a, r = np.array([90, 91]), np.array([1.0, 0.0])
    if torch_in:
        s, a, r = map(torch.from_numpy, (s, a, r))
    writer.push(s, a, r)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_cross_between_the_packages(tmp_path, writer):
    """Shards written by one package: united, filtered and loaded by the
    other, equal to the first's own reading exactly."""
    w = (joff.ShardWriter if writer == "jax" else ShardWriter)(
        str(tmp_path / "data"), file_size=4)
    _push_all(w, writer == "port")
    assert w.n_files == 3
    glob_ = str(tmp_path / "data" / "*.npz")
    outs = {}
    for name, unite, extract in (
            ("jax", joff.unite_data, joff.extract_positives),
            ("port", unite_data, extract_positives)):
        all_, pos = tmp_path / f"all_{name}.npz", tmp_path / f"pos_{name}.npz"
        assert unite(glob_, str(all_)) == 12
        n_pos = extract(str(all_), str(pos))
        outs[name] = (np.load(all_), np.load(pos), n_pos)
    (ja, jp, jn), (pa, pp, pn) = outs["jax"], outs["port"]
    assert jn == pn == 6
    for k in ("states", "actions", "rewards"):
        for x, y in ((ja[k], pa[k]), (jp[k], pp[k])):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    ds = GraspingDataset(str(tmp_path / "all_jax.npz"), device="cpu")
    jd = joff.GraspingDataset(str(tmp_path / "all_port.npz"))
    for x, y in ((ds.states, jd.states), (ds.actions, jd.actions),
                 (ds.rewards, jd.rewards)):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert ds.actions.dtype == torch.int32 and len(ds) == len(jd) == 12


def test_dataset_split_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    n = 40
    path = str(tmp_path / "ds.npz")
    np.savez_compressed(
        path, states=rng.uniform(0, 1, (n, 16, 16, 4)).astype(np.float32),
        actions=rng.integers(0, 6 * 16 * 16, n).astype(np.int32),
        rewards=(rng.uniform(0, 1, n) > 0.5).astype(np.float32))
    ds, jd = GraspingDataset(path, device="cpu"), joff.GraspingDataset(path)
    for seed in (0, 7):
        for part, jpart in zip(ds.split(0.8, seed), jd.split(0.8, seed)):
            for x, y in zip(part, jpart):
                assert np.array_equal(x.numpy(), np.asarray(y))
    (s_tr, _, _), (s_te, _, _) = ds.split(0.8, seed=0)
    assert s_tr.shape[0] == 32 and s_te.shape[0] == 8


def test_binary_accuracy_and_meter_match_jax():
    rng = np.random.default_rng(1)
    for q, r in ((np.array([0.9, 0.6, 0.2, 0.4]), np.array([1., 0., 0., 1.])),
                 (rng.uniform(size=50), (rng.uniform(size=50) > 0.3) * 1.0),
                 (rng.uniform(size=5), np.zeros(5))):
        got = binary_accuracy(torch.tensor(q, dtype=torch.float32),
                              torch.tensor(r, dtype=torch.float32))
        want = joff.binary_accuracy(jnp.asarray(q, jnp.float32),
                                    jnp.asarray(r, jnp.float32))
        for g, w in zip(got, want):
            assert float(g) == pytest.approx(float(w), abs=1e-7)
    ap, an = binary_accuracy(torch.tensor([0.9, 0.6, 0.2, 0.4]),
                             torch.tensor([1.0, 0.0, 0.0, 1.0]))
    assert float(ap) == pytest.approx(0.5) and float(an) == pytest.approx(0.5)
    m, jm = AverageMeter(), joff.AverageMeter()
    for v, n in ((2.0, 2), (4.0, 2), (torch.tensor(7.0), 3)):
        m.update(v, n)
        jm.update(float(v), n)
        assert (m.val, m.sum, m.count, m.avg) == (jm.val, jm.sum, jm.count,
                                                  jm.avg)
    assert AverageMeter().avg == 0.0


def test_train_offline_lowers_the_loss(tmp_path):
    rng = np.random.default_rng(0)
    n = 40
    path = str(tmp_path / "ds.npz")
    np.savez_compressed(
        path, states=rng.uniform(0, 1, (n, 16, 16, 4)).astype(np.float32),
        actions=rng.integers(0, 6 * 16 * 16, n).astype(np.int32),
        rewards=(rng.uniform(0, 1, n) > 0.5).astype(np.float32))
    agent = GraspAgent(AgentConfig(width=16, height=16, memory_size=16,
                                   batch_size=8, dtype="float32"),
                       device="cpu")
    ts = agent.init(torch.Generator().manual_seed(0))
    lines = []
    ts, hist = train_offline(agent, ts, GraspingDataset(path, device="cpu"),
                             epochs=3, batch=8, log=lines.append)
    assert len(hist) == len(lines) == 3
    assert np.isfinite([h["train_loss"] for h in hist]).all()
    assert hist[-1]["train_loss"] < hist[0]["train_loss"] * 1.5
    for h in hist:
        assert 0 <= h["pos_acc"] <= 1 and 0 <= h["neg_acc"] <= 1
    assert ts.optimizer.state[next(ts.model.parameters())]["step"] == 12


def test_generate_banks_shards_end_to_end(tmp_path):
    from mujoco_rl_ur5_tpu_torch.learn.generate_data import generate
    from mujoco_rl_ur5_tpu_torch.utils.config import (
        Config, EnvConfig, SceneConfig, SolverConfig, TrainConfig,
    )

    cfg = Config(
        scene=SceneConfig(path=OBJECTS),
        solver=SolverConfig(ncon=64, iterations=5),
        env=EnvConfig(image_width=16, image_height=16, budget_scale=0.004),
        agent=AgentConfig(width=16, height=16, memory_size=16, batch_size=4,
                          dtype="float32"),
        train=TrainConfig(batch_envs=2, seed=5))
    out = str(tmp_path / "Data")
    total, files, positives = generate(cfg, out_dir=out, episodes=1,
                                       steps_per_episode=3, file_size=3,
                                       verbose=False, device="cpu")
    assert total == 6 and files == 2 and 0 <= positives <= 6
    shards = sorted(glob.glob(os.path.join(out, "*.npz")))
    assert [os.path.basename(p) for p in shards] == [
        "grasping_data_0.npz", "grasping_data_1.npz"]
    d = np.load(shards[0])
    assert d["states"].shape == (3, 16, 16, 4)
    assert d["states"].dtype == np.float32 and d["actions"].dtype == np.int32
    assert d["rewards"].dtype == np.float32
    assert set(np.concatenate([np.load(p)["rewards"] for p in shards])
               ) <= {0.0, 1.0}


def test_mean_std_from_a_batched_reset_and_its_file(tmp_path):
    """compute_mean_std: one batched reset's per-channel mean and
    population std; the .npz crosses between the packages."""
    from mujoco_rl_ur5_tpu.learn import normalize as jnorm
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv
    from mujoco_rl_ur5_tpu_torch.learn.normalize import (
        compute_mean_std, load_mean_std, save_mean_std,
    )
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model

    env = GraspEnv(load_model(OBJECTS, device="cpu"), ncon=64, iterations=5,
                   image_width=16, image_height=16, budget_scale=0.004,
                   device="cpu")
    means, stds = compute_mean_std(env, torch.Generator().manual_seed(2), 3)
    es = env.reset(torch.Generator().manual_seed(2), 3)
    obs = np.concatenate([es.rgb.numpy().astype(np.float64),
                          es.depth.numpy()[..., None]], -1).reshape(-1, 4)
    np.testing.assert_allclose(means, obs.mean(0), rtol=1e-5)
    np.testing.assert_allclose(stds, obs.std(0), rtol=1e-4)
    assert means.shape == stds.shape == (4,) and 1.0 < means[3] < 2.0
    for save, load in ((save_mean_std, jnorm.load_mean_std),
                       (jnorm.save_mean_std, load_mean_std)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, means, stds)
        m, s = load(path)
        assert np.array_equal(m, means) and np.array_equal(s, stds)
