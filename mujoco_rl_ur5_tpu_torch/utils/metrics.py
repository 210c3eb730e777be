"""Training observability, the port's counterpart of the JAX package's
utils/metrics.py: tensorboard scalars and histograms with the reference's
exact metric names, and console step banners.

Reference surface reproduced (Grasping_Agent_multidiscrete.py):
  * run-name encodes the hyperparameters (:183-219);
  * scalars: "Epsilon" (:245), "Mean reward/Last100" and
    "Mean reward/Last1000" (:493-506), "Mean loss/Last100" (:508-511);
  * histogram "Rotation action distribution/Last1000" every 1000 steps
    (:467-473);
  * scalar groups "Total number of rotation actions/Greedy",
    "Total number of successful rotation actions/{Greedy,Random}" every 10
    steps (:475-488);
  * console episode/step banners (:526-542, GraspingEnv.py:354-379).
"""

from __future__ import annotations

from collections import deque

import numpy as np


class MetricsTracker:
    """Rolling reward/loss windows + tensorboard writing.

    `writer=None` keeps all tracking (windows, counters) but skips
    tensorboard entirely — the mode tests use.
    """

    def __init__(self, logdir: str | None = None, run_name: str = "",
                 rotations: int = 6):
        self.writer = None
        if logdir is not None:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(
                log_dir=f"{logdir.rstrip('/')}/{run_name}" if run_name
                else logdir)
        self.last_1000_rewards = deque(maxlen=1000)
        self.last_100_loss = deque(maxlen=100)
        self.last_1000_actions = deque(maxlen=1000)
        self.rotations = rotations

    @staticmethod
    def run_name(cfg, seed: int, description: str = "") -> str:
        """Hyperparameter-encoding run name (:183-219)."""
        algo = "SHORTSIGHTED" if cfg.gamma == 0.0 else "DQN"
        parts = [
            algo, f"H={cfg.height}", f"W={cfg.width}",
            f"M={cfg.memory_size}", f"B={cfg.batch_size}",
            f"G={cfg.gamma}", f"LR={cfg.learning_rate}",
            f"EPSSTART={cfg.eps_start}", f"EPSEND={cfg.eps_end}",
            f"EPSDECAY={cfg.eps_decay}", f"SEED={seed}",
        ]
        if description:
            parts.append(description)
        return "_".join(parts)

    # -- per-step update (update_tensorboard :448-511) -------------------------

    def step(self, global_step: int, reward: float, rotation: int,
             epsilon: float, loss: float | None = None,
             counters: dict | None = None):
        """Record one env step. `counters` carries the agent's per-rotation
        int arrays {"greedy_rotations", "greedy_successes",
        "random_successes"} (TrainState fields)."""
        self.last_1000_rewards.append(float(reward))
        self.last_1000_actions.append(int(rotation))
        if loss is not None:
            self.last_100_loss.append(float(loss))
        if self.writer is None:
            return
        w = self.writer
        w.add_scalar("Epsilon", epsilon, global_step=global_step)
        if global_step % 1000 == 0 and self.last_1000_actions:
            w.add_histogram("Rotation action distribution/Last1000",
                            np.array(self.last_1000_actions),
                            global_step=global_step,
                            bins=list(range(self.rotations)))
        if global_step % 10 == 0:
            if counters is not None:
                def scalars(tag, arr):
                    w.add_scalars(
                        tag, {str(i): int(v) for i, v in enumerate(arr)},
                        global_step)

                scalars("Total number of rotation actions/Greedy",
                        counters["greedy_rotations"])
                scalars("Total number of successful rotation actions/Greedy",
                        counters["greedy_successes"])
                scalars("Total number of successful rotation actions/Random",
                        counters["random_successes"])
            if len(self.last_1000_rewards) > 99:
                last100 = list(self.last_1000_rewards)[-100:]
                w.add_scalar("Mean reward/Last100", float(np.mean(last100)),
                             global_step=global_step)
            if len(self.last_1000_rewards) > 999:
                w.add_scalar("Mean reward/Last1000",
                             float(np.mean(self.last_1000_rewards)),
                             global_step=global_step)
            if len(self.last_100_loss) > 99:
                w.add_scalar("Mean loss/Last100",
                             float(np.mean(self.last_100_loss)),
                             global_step=global_step)

    def add_scalar(self, tag: str, value: float, global_step: int):
        """Any other scalar (solves/s, an error against a reference)."""
        if self.writer is not None:
            self.writer.add_scalar(tag, value, global_step=global_step)

    # -- console banners (:526-542; GraspingEnv.py:106-121) ---------------------

    @staticmethod
    def episode_banner(episode: int, total: int):
        print(f"{'#' * 10} EPISODE {episode} of {total} {'#' * 10}")

    @staticmethod
    def step_banner(step: int, rewards, grasped) -> str:
        rewards = np.atleast_1d(np.asarray(rewards))
        grasped = np.atleast_1d(np.asarray(grasped))
        n = int(grasped.sum())
        msg = (f"STEP {step}: {n}/{len(grasped)} grasps succeeded, "
               f"mean reward {rewards.mean():.3f}")
        print(msg)
        return msg

    def close(self):
        if self.writer is not None:
            self.writer.close()
