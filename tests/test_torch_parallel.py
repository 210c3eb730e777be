"""The port's parallel/ on torch.distributed, on the CPU with gloo.

One pair of ranks is spawned for every two-rank check (an interpreter
start-up each); each rank answers, and the tests read the answers:

* an all-reduce across the two processes (1 + 2 = 3);
* ``dp_train_step`` on the two halves of a batch of 4 equals
  ``GraspAgent.train_step`` on the whole batch, in float64 (the network
  ``.double()``, 16 x 16 inputs): the loss, every parameter after the
  AdamW step, every gradient and every BatchNorm running statistic within
  1e-9 of its tensor's norm, on both ranks (the BatchNorm moments are
  all-reduced: a per-rank BatchNorm would miss by far more, which the
  ranks also report);
* ``GraspMPC.solve_batch_x`` on each rank's share of 8 scenarios equals
  the unsharded solve's rows, to the JAX package's limits for its sharded
  solve (tests/test_parallel.py: controls within 0.05, costs within 1e-2
  relative);
* ``dp_env_reset``/``dp_env_rollout`` of the object pile's GraspEnv (B=4,
  16 x 16, budget_scale=0.004, iterations=5, ncon=64) equal ``reset`` and
  ``step`` on the whole batch: the settled qpos within 1e-6, rewards
  equal, the stepped qpos within 5e-4 (JAX's limits);
* the tensor-parallel placement on a 1 x 2 mesh: exactly the weights with
  at least 128 output features are ``Shard(0)`` over "model", and one
  ``train_step`` from the placed state gives the unplaced step's loss and
  parameters within 1e-9;
* ``Trainer(mesh=...)`` with 2 envs (one per rank) takes one env step:
  two transitions, rewards in {0, 1}, the same on both ranks.

In this process: ``initialize_multihost`` without a coordinator is a
no-op, and ``elastic_run`` restarts from the newest of the Trainer's
checkpoints and gives up after ``max_restarts``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9


def _read(model, name: str):
    """The parameter ``name`` as its layer reads it (whole, where the
    tensor-parallel placement holds it sharded behind a parametrization)."""
    mod, _, leaf = name.rpartition(".")
    return getattr(model.get_submodule(mod), leaf)


def _rank_main(rank: int, port: int) -> None:
    """One rank of the pair: every two-rank check, printed as one JSON
    line."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from mujoco_rl_ur5_tpu_torch import ASSET, OBJECTS
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv
    from mujoco_rl_ur5_tpu_torch.learn.agent import AgentConfig, GraspAgent
    from mujoco_rl_ur5_tpu_torch.learn.train import Trainer
    from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
    from mujoco_rl_ur5_tpu_torch.parallel import (
        dp_env_reset, dp_env_rollout, dp_train_step, initialize_multihost,
        make_mesh, replicate, shard_batch, tp_param_shardings,
        tp_place_train_state,
    )
    from mujoco_rl_ur5_tpu_torch.parallel.distributed import is_coordinator
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
    from mujoco_rl_ur5_tpu_torch.utils.config import (
        Config, EnvConfig, SceneConfig, SolverConfig, TrainConfig,
    )

    assert initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
    out = {"rank": rank, "coordinator": is_coordinator()}
    mesh = make_mesh(data=-1, model=1)
    out["mesh"] = [list(mesh.mesh.shape), list(mesh.mesh_dim_names)]
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    out["all_reduce"] = float(t)
    out["replicate"] = float(replicate(mesh, torch.tensor([rank + 5.0])))

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    # the data-parallel learner step, float64
    agent = GraspAgent(AgentConfig(width=16, height=16, batch_size=4,
                                   dtype="float32"), device="cpu")
    model = agent.init(torch.Generator().manual_seed(0)).model.double()
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.uniform(0, 1, (4, 16, 16, 4)))
    a = torch.from_numpy(rng.integers(0, agent.n_actions, 4))
    r = torch.from_numpy((np.arange(4) % 2).astype(np.float32))
    ref = agent.state_for(copy.deepcopy(model))
    ref, loss_ref = agent.train_step(ref, s, a, r)
    dp = agent.state_for(copy.deepcopy(model))
    dp, loss_dp = dp_train_step(agent, mesh)(dp, *shard_batch(mesh, (s, a,
                                                                     r)))
    refp = dict(ref.model.named_parameters())
    refb = dict(ref.model.named_buffers())
    out["dp"] = {
        "loss": abs(float(loss_dp) - float(loss_ref)) / abs(float(loss_ref)),
        "params": max(rel(p.detach(), refp[n].detach())
                      for n, p in dp.model.named_parameters()),
        "grads": max(rel(p.grad, refp[n].grad)
                     for n, p in dp.model.named_parameters()),
        "stats": max(rel(b, refb[n]) for n, b in dp.model.named_buffers()
                     if b.is_floating_point())}
    # the same step with each rank's BatchNorm on its own shard
    own = agent.state_for(copy.deepcopy(model))
    own, _ = agent.train_step(own, *shard_batch(mesh, (s, a, r)))
    out["dp"]["own_stats"] = max(rel(b, refb[n]) for n, b in
                                 own.model.named_buffers()
                                 if b.is_floating_point())

    # the sharded reach solve
    mpc = GraspMPC.from_scene(ASSET, horizon=4, substeps=2, iters=2,
                              device="cpu")
    home = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])
    g = np.random.default_rng(1)
    x0 = torch.from_numpy((np.concatenate([home, np.zeros(8)])[None]
                           + 0.01 * g.standard_normal((8, 16))
                           ).astype(np.float32))
    tg = torch.tensor([[0.0, -0.6, 1.0]]).expand(8, 3)
    full = mpc.solve_batch_x(x0, tg)
    part = mpc.solve_batch_x(*shard_batch(mesh, (x0, tg)))
    mine = shard_batch(mesh, full)
    out["mpc"] = {"du": float((part.us - mine.us).abs().max()),
                  "dcost": float(((part.cost - mine.cost).abs()
                                  / mine.cost.abs()).max()),
                  "finite": bool(torch.isfinite(part.us).all())}

    # the scenario-parallel env
    env = GraspEnv(load_model(OBJECTS, device="cpu"), ncon=64, iterations=5,
                   image_width=16, image_height=16, budget_scale=0.004,
                   device="cpu")
    es_full = env.reset(torch.Generator().manual_seed(0), 4)
    es_sh = dp_env_reset(env, mesh)(torch.Generator().manual_seed(0), 4)
    mine = shard_batch(mesh, es_full)
    pix = es_full.depth.reshape(4, -1).argmin(1)
    actions = torch.stack([pix, torch.arange(4) % 6], 1)
    es1, rw, _, _ = env.step(es_full, actions)
    es1s, rws, _, _ = dp_env_rollout(env, mesh)(es_sh, actions)
    out["env"] = {
        "reset_dq": float((es_sh.sim.qpos - mine.sim.qpos).abs().max()),
        "rewards_equal": bool(torch.equal(rws, shard_batch(mesh, rw))),
        "step_dq": float((es1s.sim.qpos
                          - shard_batch(mesh, es1.sim.qpos)).abs().max())}

    # the tensor-parallel placement on a 1 x 2 mesh
    tp_mesh = make_mesh(data=1, model=2)
    places = tp_param_shardings(tp_mesh, model)
    out["tp_sharded"] = sorted(
        n for n, pl in places.items() if "Shard" in repr(pl[1]))
    out["tp_expected"] = sorted(
        n for n, p in model.named_parameters()
        if n.endswith("weight") and p.dim() >= 2 and p.shape[0] >= 128)
    ref2 = agent.state_for(copy.deepcopy(model))
    ref2, l_ref = agent.train_step(ref2, s, a, r)
    tp = tp_place_train_state(agent, tp_mesh,
                              agent.state_for(copy.deepcopy(model)))
    tp, l_tp = agent.train_step(tp, s, a, r)
    rp = dict(ref2.model.named_parameters())
    out["tp"] = {
        "loss": abs(float(l_tp) - float(l_ref)) / abs(float(l_ref)),
        "params": max(rel(_read(tp.model, n).detach(), p.detach())
                      for n, p in rp.items())}

    # the Trainer over the mesh, one env step of two scenarios
    cfg = Config(
        scene=SceneConfig(path=OBJECTS), solver=SolverConfig(ncon=64,
                                                             iterations=5),
        env=EnvConfig(image_width=16, image_height=16, budget_scale=0.003),
        agent=AgentConfig(width=16, height=16, memory_size=8, batch_size=4,
                          dtype="float32"),
        train=TrainConfig(episodes=1, steps_per_episode=1, batch_envs=2,
                          seed=0))
    trainer = Trainer(cfg, mesh=mesh, device="cpu")
    ts, buf = trainer.run(verbose=False)
    out["trainer"] = {"size": buf.size, "step": ts.step,
                      "rewards": buf.rewards[:buf.size].tolist()}
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)


@pytest.fixture(scope="module")
def ranks():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    code = ("import sys; from tests.test_torch_parallel import _rank_main; "
            "_rank_main(int(sys.argv[1]), int(sys.argv[2]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(i), str(port)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=300)
        finally:
            p.kill()
        outs.append((p.returncode, o, e))
    res = []
    for rc, o, e in outs:
        lines = [ln for ln in o.splitlines() if ln.startswith("RESULT ")]
        assert rc == 0 and lines, (rc, o[-2000:], e[-4000:])
        res.append(json.loads(lines[-1][len("RESULT "):]))
    return res


def test_two_ranks_all_reduce(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert [r["coordinator"] for r in ranks] == [True, False]
    for r in ranks:
        assert r["all_reduce"] == 3.0
        assert r["replicate"] == 5.0
        assert r["mesh"] == [[2, 1], ["data", "model"]]


def test_dp_train_step_equals_whole_batch(ranks):
    for r in ranks:
        d = r["dp"]
        for k in ("loss", "params", "grads", "stats"):
            assert d[k] <= TOL, (r["rank"], k, d[k])
        # each rank's own BatchNorm moments would not do
        assert d["own_stats"] > 1e3 * TOL, d["own_stats"]


def test_sharded_solve_equals_unsharded(ranks):
    for r in ranks:
        m = r["mpc"]
        assert m["finite"]
        assert m["du"] <= 0.05 and m["dcost"] <= 1e-2, m


def test_dp_env_equals_unsharded(ranks):
    for r in ranks:
        e = r["env"]
        assert e["reset_dq"] <= 1e-6, e
        assert e["rewards_equal"], e
        assert e["step_dq"] <= 5e-4, e


def test_tp_placement(ranks):
    for r in ranks:
        assert r["tp_sharded"] == r["tp_expected"] and r["tp_sharded"]
        assert r["tp"]["loss"] <= TOL and r["tp"]["params"] <= TOL, r["tp"]


def test_trainer_over_mesh_one_step(ranks):
    for r in ranks:
        t = r["trainer"]
        assert t["size"] == 2 and t["step"] == 2
        assert set(t["rewards"]) <= {0.0, 1.0}
    assert ranks[0]["trainer"] == ranks[1]["trainer"]


def test_initialize_multihost_noop(monkeypatch):
    from mujoco_rl_ur5_tpu_torch.parallel import initialize_multihost
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert not dist.is_initialized()


def test_elastic_run_restarts_from_checkpoint(tmp_path):
    from mujoco_rl_ur5_tpu_torch.parallel.distributed import elastic_run

    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    (ckdir / "ep00010.pt").write_bytes(b"")
    (ckdir / "ep00020.pt").write_bytes(b"")
    (ckdir / "notes.txt").write_text("not a checkpoint")
    calls = []

    def train_fn(resume):
        calls.append(resume)
        if len(calls) < 3:
            (ckdir / f"ep000{20 + 10 * len(calls)}.pt").write_bytes(b"")
            raise RuntimeError(f"injected failure {len(calls)}")

    elastic_run(train_fn, str(ckdir), max_restarts=3, backoff_s=0.01)
    assert calls == [str(ckdir / "ep00020.pt"), str(ckdir / "ep00030.pt"),
                     str(ckdir / "ep00040.pt")]


def test_elastic_run_exhausts_restarts(tmp_path):
    from mujoco_rl_ur5_tpu_torch.parallel.distributed import elastic_run

    calls = []

    def train_fn(resume):
        calls.append(resume)
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="always fails"):
        elastic_run(train_fn, str(tmp_path), max_restarts=2, backoff_s=0.01)
    assert calls == [None, None, None]
