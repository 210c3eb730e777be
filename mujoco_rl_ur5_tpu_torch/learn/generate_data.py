"""Offline data generation, the port's counterpart of the JAX
package's learn/generate_data.py (the reference's Offline
RL/generate_data.py :14-132): run a (optionally pretrained) agent in the
batched env and bank (state, action, reward) transitions into shard files.

Reference behaviour reproduced: the online loop's episode/step loop
(:29-79), but transitions go to ``ShardWriter`` (FILE_SIZE=12 ``.npz``
shards, :80-94) instead of the replay ring and no learning happens; a
checkpoint restores a trained policy first (:24-28), and eps follows the
restored step. ``batch_envs`` scenarios run in lockstep, so every env step
banks a batch of transitions.
"""

from __future__ import annotations

import torch

from mujoco_rl_ur5_tpu_torch.learn.offline import ShardWriter
from mujoco_rl_ur5_tpu_torch.learn.train import Trainer
from mujoco_rl_ur5_tpu_torch.utils.config import Config


def generate(config: Config = Config(), out_dir: str = "Data",
             episodes: int = 10, steps_per_episode: int = 50,
             checkpoint: str | None = None, file_size: int = 12,
             verbose: bool = True, device="cuda"):
    """Returns (n_transitions, n_files, positives)."""
    tr = Trainer(config, device=device)
    agent, env, B = tr.agent, tr.env, tr.B
    ts = agent.init(torch.Generator().manual_seed(config.train.seed))
    if checkpoint:
        ts, _ = agent.restore(checkpoint, ts)
        if verbose:
            print(f"policy restored from {checkpoint} "
                  f"(step {ts.step}, eps {agent.epsilon(ts):.3f})")

    writer = ShardWriter(out_dir, file_size=file_size)
    gen = torch.Generator(device=tr.device).manual_seed(config.train.seed + 1)
    total = positives = 0
    for ep in range(1, episodes + 1):
        es = env.reset(gen, B)
        for _ in range(steps_per_episode):
            obs = agent.transform_observation(es.rgb, es.depth, gen)
            flat, was_greedy = agent.epsilon_greedy(ts, obs, es.depth, gen)
            es, rewards, _, _ = env.step(es, agent.transform_action(flat))
            # bank the NETWORK INPUT like the reference (it stores the
            # transformed observation, generate_data.py:60-76)
            writer.push(obs, flat, rewards)
            # the step count advances so the restored eps keeps decaying
            ts = agent.record_action(ts, flat, rewards, was_greedy)
            r = rewards.cpu().numpy()
            total += len(r)
            positives += int((r > 0.5).sum())
        if verbose:
            print(f"episode {ep}/{episodes}: {total} transitions banked "
                  f"({positives} positive), {writer.n_files} shards")
    return total, writer.n_files, positives


def main(argv=None):
    import argparse
    import dataclasses

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default="Data")
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-envs", type=int, default=8)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--image", type=int, default=200)
    p.add_argument("--budget-scale", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    cfg = Config()
    cfg = cfg.replace(
        env=dataclasses.replace(cfg.env, image_width=a.image,
                                image_height=a.image,
                                budget_scale=a.budget_scale),
        train=dataclasses.replace(cfg.train, batch_envs=a.batch_envs))
    generate(cfg, out_dir=a.out_dir, episodes=a.episodes,
             steps_per_episode=a.steps, checkpoint=a.checkpoint,
             device=a.device)


if __name__ == "__main__":
    main()
