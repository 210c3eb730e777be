"""Config tree for the whole port, the counterpart of the JAX package's
utils/config.py.

The reference configures itself through three ad-hoc mechanisms
(module-level UPPERCASE constants, Grasping_Agent_multidiscrete.py:22-41;
constructor kwargs, GraspingEnv.py:28-36; gym.make passthrough, :85-97).
This module replaces all three with one frozen dataclass tree that reaches
every subsystem: scene selection, solver budgets, env phase budgets, the
agent, the training loop and the device mesh.

One divergence from the JAX package: ``SceneConfig.path`` defaults to the
port's own object pile (``OBJECTS``, assets/ur5_2finger_objects.xml: the
reference pile's composition and mesh finger pads), because the JAX
package's default, the reference's UR5gripper_2_finger_many_objects.xml,
is not part of this repository. ``MeshConfig`` is kept as data: nothing
reads it until the port has parallel/.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu_torch.learn.agent import AgentConfig


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Which MJCF to compile (reference: XML path kwarg, GraspingEnv.py:30)."""

    path: str = OBJECTS
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Contact solver budgets. ``iterations=None`` follows the scene's
    <option iterations> (100 in the grasp scenes) -- the parity default."""

    ncon: int = 128
    iterations: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """GraspEnv knobs (GraspingEnv.py:28-36 constructor kwargs)."""

    image_width: int = 200
    image_height: int = 200
    camera: str = "top_down"
    demo: bool = False
    budget_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop schedule (Grasping_Agent_multidiscrete.py:22-41,
    :515-583). ``batch_envs`` scenarios run in lockstep per env step (the
    reference is strictly batch_envs=1)."""

    episodes: int = 1000
    steps_per_episode: int = 50
    batch_envs: int = 1
    seed: int = 20
    save_every_episodes: int = 10
    checkpoint_dir: Optional[str] = None
    logdir: Optional[str] = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape: data x model axes."""

    data: int = -1      # -1: all devices on the data axis
    model: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    scene: SceneConfig = SceneConfig()
    solver: SolverConfig = SolverConfig()
    env: EnvConfig = EnvConfig()
    agent: AgentConfig = AgentConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
