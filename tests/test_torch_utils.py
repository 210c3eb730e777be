"""The port's utils/ (decorators, metrics, config) on the CPU: the cases of
tests/test_utils.py against the port's objects, the run name equal to the
JAX package's for the same agent config, the reference's tensorboard tags,
and the torch.profiler trace."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu.learn.agent import AgentConfig as JConfig
from mujoco_rl_ur5_tpu.utils.metrics import MetricsTracker as JTracker
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.learn.agent import AgentConfig
from mujoco_rl_ur5_tpu_torch.utils import (
    Config, MetricsTracker, block_timer, debug, dict2list, timer,
    torch_trace, typeassert,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the suite runs several test files
    at once, and each file's threads would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_timer_returns_and_prints(capsys):
    @timer
    def f(x):
        return {"y": torch.as_tensor(x) * 2}

    out = f(3.0)
    assert float(out["y"]) == 6.0
    assert "'f' took" in capsys.readouterr().out


def test_block_timer_records():
    times = []
    with block_timer("x", out=times):
        sum(range(1000))
    assert len(times) == 1 and times[0] >= 0


def test_debug_prints_shapes(capsys):
    @debug
    def f(a):
        return {"arr": np.zeros((2, 3)), "t": torch.zeros(4, 5), "n": 5}

    f(torch.ones(4))
    out = capsys.readouterr().out
    assert "Debugging f" in out
    assert "shape=(2, 3)" in out and "shape=(4, 5)" in out
    assert "Tensor(shape=(4,), dtype=torch.float32)" in out


def test_typeassert_rejects():
    @typeassert(int, str)
    def f(a, b):
        return a

    assert f(1, "x") == 1
    with pytest.raises(TypeError):
        f("bad", "x")


def test_dict2list_stacks():
    @dict2list
    def f():
        return {"a": np.arange(3), "b": torch.arange(3) + 10}

    out = f()
    assert out.shape == (2, 3)
    np.testing.assert_array_equal(out[1], [10, 11, 12])


def test_torch_trace_writes_a_chrome_trace(tmp_path, capsys):
    with torch_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace.json"
    assert path.exists() and "trace written" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in k.key for k in prof.key_averages())


def test_metrics_tracker_windows():
    tr = MetricsTracker(logdir=None)
    for i in range(1200):
        tr.step(i, float(i % 2), i % 6, 0.5, loss=0.1)
    assert len(tr.last_1000_rewards) == 1000
    assert len(tr.last_100_loss) == 100
    assert len(tr.last_1000_actions) == 1000


def test_metrics_writer_emits_reference_names(tmp_path):
    """The reference's scalar tags in the event file
    (Grasping_Agent_multidiscrete.py:493-511)."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    tr = MetricsTracker(logdir=str(tmp_path), run_name="t")
    counters = {"greedy_rotations": np.zeros(6, np.int32),
                "greedy_successes": np.zeros(6, np.int32),
                "random_successes": np.zeros(6, np.int32)}
    for i in range(110):
        tr.step(i, 1.0, 0, 0.9, loss=0.5, counters=counters)
    tr.close()
    runs = os.listdir(tmp_path)
    acc = EventAccumulator(str(tmp_path / "t"))
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert {"Epsilon", "Mean reward/Last100", "Mean loss/Last100"} <= set(
        tags)
    # add_scalars writes each group's members under their own run folders
    assert any("Total number of rotation actions_Greedy" in d for d in
               os.listdir(tmp_path / "t")), runs


def test_run_name_equals_jax():
    for kw in ({}, {"gamma": 0.9, "batch_size": 4, "memory_size": 64},
               {"width": 32, "height": 24, "eps_decay": 100}):
        for seed, desc in ((81, ""), (3, "run")):
            name = MetricsTracker.run_name(AgentConfig(**kw), seed, desc)
            assert name == JTracker.run_name(JConfig(**kw), seed, desc)
    name = MetricsTracker.run_name(AgentConfig(), 81)
    assert "SEED=81" in name and "M=2000" in name and "B=12" in name
    assert name.startswith("SHORTSIGHTED")


def test_banners(capsys):
    MetricsTracker.episode_banner(2, 5)
    msg = MetricsTracker.step_banner(7, np.array([1.0, 0.0]),
                                     np.array([True, False]))
    assert "EPISODE 2 of 5" in capsys.readouterr().out
    assert msg == JTracker.step_banner(7, np.array([1.0, 0.0]),
                                       np.array([True, False]))


def test_config_tree_replace():
    cfg = Config()
    assert cfg.agent.depth_clip == pytest.approx(1.1)
    assert cfg.scene.path == OBJECTS and os.path.exists(cfg.scene.path)
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, episodes=3))
    assert cfg2.train.episodes == 3 and cfg.train.episodes == 1000
    assert (cfg.solver.ncon, cfg.env.image_width, cfg.mesh.data) == (
        128, 200, -1)
