"""learn/ of the PyTorch port: the fully convolutional grasp Q-network, the
device-resident replay ring, the shortsighted-DQN grasp agent,
normalization statistics, the online Trainer and the offline pipeline (the
JAX package's learn/ on a leading batch axis; the reference's Modules.py,
Grasping_Agent_multidiscrete.py, normalize.py and Offline RL/).
"""

from mujoco_rl_ur5_tpu_torch.learn.networks import (
    MultidiscreteResnet, count_parameters, multidiscrete_resnet,
    policy_resnet, resnet,
)
from mujoco_rl_ur5_tpu_torch.learn.replay import ReplayBuffer
from mujoco_rl_ur5_tpu_torch.learn.agent import AgentConfig, GraspAgent

__all__ = [
    "MultidiscreteResnet", "multidiscrete_resnet", "resnet", "policy_resnet",
    "count_parameters", "ReplayBuffer", "GraspAgent", "AgentConfig",
    "Trainer",
]


def __getattr__(name):
    # Trainer pulls in env/scene/utils; import it on first use to keep
    # `import mujoco_rl_ur5_tpu_torch.learn` light for pure-learning users.
    if name == "Trainer":
        from mujoco_rl_ur5_tpu_torch.learn.train import Trainer

        return Trainer
    raise AttributeError(name)
