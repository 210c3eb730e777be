"""Online training loop, the port's counterpart of the JAX package's
learn/train.py: the runnable entry point the framework exists for.

Reproduces ``Grasping_Agent_multidiscrete.main()`` (:515-583): for each
episode, reset the env, then for each step run the observation transform
-> eps_greedy -> env.step (one full scripted pick-and-place) -> replay push
-> counters -> learn -> metrics, checkpointing at episode ends (:560-572)
and at the end.

The loop drives ``batch_envs`` scenarios in lockstep on the env's batch
axis, so each env step banks ``batch_envs`` transitions (the reference is
strictly one env). Every draw comes from one ``torch.Generator`` on the
device, seeded by ``TrainConfig.seed``; the weights from a CPU generator
of the same seed. The contact steps run the six collide kernels and each
observation the ray cast on the card; the network, its optimiser and the
replay ring run there too. The host reads back the rewards, rotations,
counters and loss once per env step, for the metrics.

    python -m mujoco_rl_ur5_tpu_torch.learn.train --budget-scale 0.01 \\
        --episodes 1 --steps 3 --batch-envs 16     # on "cuda"

A resume restores the model with its BatchNorm statistics, the optimiser,
the step, the counters and the replay ring (the generator starts again
from the seed, as the JAX package's key does).
"""

from __future__ import annotations

import os
import time

import torch

from mujoco_rl_ur5_tpu_torch.env import GraspEnv
from mujoco_rl_ur5_tpu_torch.learn.agent import (
    COUNTERS, AgentConfig, GraspAgent,
)
from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
from mujoco_rl_ur5_tpu_torch.scene.model import resolve_device
from mujoco_rl_ur5_tpu_torch.utils.config import Config
from mujoco_rl_ur5_tpu_torch.utils.metrics import MetricsTracker

AGENT_FIELDS = ("rotations", "memory_size", "batch_size", "accum_steps",
                "gamma", "learning_rate", "weight_decay", "eps_start",
                "eps_end", "eps_decay", "depth_only", "normalization",
                "noise_sigma", "dtype")


class Trainer:
    """Owns env + agent + replay + metrics on ``device`` (the card by
    default, raises without one); ``run()`` is the main loop."""

    def __init__(self, config: Config = Config(), mesh=None, device="cuda"):
        """``mesh`` (parallel.make_mesh) with ``batch_envs`` > 1 runs the
        env's reset and step on this rank's share of the scenarios and
        gathers the results, so that every rank holds the whole batch and
        learns as one process would."""
        self.cfg = config
        self.device = resolve_device(device, "Trainer")
        e, s = config.env, config.solver
        self.env = GraspEnv(load_model(config.scene.path, device=self.device),
                            ncon=s.ncon, iterations=s.iterations,
                            image_width=e.image_width,
                            image_height=e.image_height, camera=e.camera,
                            demo=e.demo, budget_scale=e.budget_scale,
                            device=self.device)
        self.model = self.env.model
        acfg = AgentConfig.for_env(
            self.env, **{k: getattr(config.agent, k) for k in AGENT_FIELDS})
        t = config.train
        self.agent = GraspAgent(acfg, seed=t.seed, device=self.device)
        self.tracker = MetricsTracker(
            logdir=t.logdir,
            run_name=MetricsTracker.run_name(acfg, t.seed, t.description),
            rotations=acfg.rotations)
        self.B = t.batch_envs
        self._dp = None
        if mesh is not None and self.B > 1:
            from mujoco_rl_ur5_tpu_torch.parallel.mesh import (
                dp_env_reset, dp_env_rollout, gather_batch, shard_batch,
            )

            reset = dp_env_reset(self.env, mesh)
            step = dp_env_rollout(self.env, mesh)
            self._dp = (lambda gen, B: gather_batch(mesh, reset(gen, B)),
                        lambda es, a: gather_batch(
                            mesh, step(shard_batch(mesh, es), a)))

    # -- one episode -----------------------------------------------------------

    def run_episode(self, ts, buf, generator: torch.Generator, episode: int,
                    steps: int, verbose: bool = True):
        """One reset and ``steps`` env steps, every draw from ``generator``
        (on the device). Returns (ts, buf, rewards per step)."""
        agent, B = self.agent, self.B
        hw = agent.cfg.height * agent.cfg.width
        reset, step = self._dp or (self.env.reset, self.env.step)
        es = reset(generator, B)
        rewards_hist = []
        for _ in range(steps):
            obs = agent.transform_observation(es.rgb, es.depth, generator)
            flat, was_greedy = agent.epsilon_greedy(ts, obs, es.depth,
                                                    generator)
            es, rewards, _, info = step(es, agent.transform_action(flat))

            # bank the transitions and count them (both batched)
            buf = agent.memory.push(buf, obs, flat, rewards)
            ts = agent.record_action(ts, flat, rewards, was_greedy)
            ts, loss = agent.learn(ts, buf, generator)

            # host-side metrics
            r_np = rewards.cpu().numpy()
            rot_np = (flat // hw).cpu().numpy()
            eps = agent.epsilon(ts)
            lf = None if loss is None else float(loss)
            counters = {k: getattr(ts, k).cpu().numpy() for k in COUNTERS}
            for b in range(B):
                self.tracker.step(ts.step - (B - 1 - b), float(r_np[b]),
                                  int(rot_np[b]), eps, loss=lf,
                                  counters=counters)
            if verbose:
                self.tracker.step_banner(ts.step, r_np,
                                         info["grasped"].cpu().numpy())
            rewards_hist.append(r_np)
        return ts, buf, rewards_hist

    # -- full run ----------------------------------------------------------------

    def run(self, episodes: int | None = None,
            steps_per_episode: int | None = None, resume: str | None = None,
            verbose: bool = True):
        """The main loop; returns the final (TrainState, ReplayState)."""
        t = self.cfg.train
        episodes = t.episodes if episodes is None else episodes
        steps = (t.steps_per_episode if steps_per_episode is None
                 else steps_per_episode)
        agent = self.agent
        generator = torch.Generator(device=self.device).manual_seed(t.seed)
        ts = agent.init(torch.Generator().manual_seed(t.seed))
        buf = agent.memory.init()
        if resume:
            ts, buf = agent.restore(resume, ts, buf)
            print(f"resumed from {resume} at step {ts.step}")

        for ep in range(1, episodes + 1):
            if verbose:
                self.tracker.episode_banner(ep, episodes)
            t0 = time.perf_counter()
            ts, buf, _ = self.run_episode(ts, buf, generator, ep, steps,
                                          verbose=verbose)
            if verbose:
                print(f"episode {ep}: {steps} steps x {self.B} envs in "
                      f"{time.perf_counter() - t0:.1f}s "
                      f"(eps={agent.epsilon(ts):.3f})")
            if t.checkpoint_dir and ep % t.save_every_episodes == 0:
                path = os.path.join(os.path.abspath(t.checkpoint_dir),
                                    f"ep{ep:05d}.pt")
                agent.save(path, ts, buf)
                if verbose:
                    print(f"checkpoint saved: {path}")
        if t.checkpoint_dir:
            path = os.path.join(os.path.abspath(t.checkpoint_dir), "final.pt")
            agent.save(path, ts, buf)
        self.tracker.close()
        return ts, buf


def main(argv=None):
    """CLI: python -m mujoco_rl_ur5_tpu_torch.learn.train [--episodes N] ..."""
    import argparse
    import dataclasses

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--episodes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-envs", type=int, default=1)
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--logdir", default=None, help="tensorboard directory "
                   "(needs tensorboard; none by default)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", default=None)
    p.add_argument("--image", type=int, default=200)
    p.add_argument("--budget-scale", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    cfg = Config()
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, image_width=a.image,
                                image_height=a.image,
                                budget_scale=a.budget_scale),
        train=dataclasses.replace(cfg.train, episodes=a.episodes,
                                  steps_per_episode=a.steps,
                                  batch_envs=a.batch_envs, seed=a.seed,
                                  logdir=a.logdir,
                                  checkpoint_dir=a.checkpoint_dir))
    Trainer(cfg, device=a.device).run(resume=a.resume)


if __name__ == "__main__":
    main()
