"""env/ of the PyTorch port: the batched functional core (``GraspEnv``,
``ReacherEnv``) and the Gymnasium single-env wrapper (``GrasperEnv``,
registered as "mujoco_rl_ur5_tpu_torch/Grasper-v0"), as the JAX package's
env/ exports them."""

from mujoco_rl_ur5_tpu_torch.env.grasp_env import EnvState, GraspEnv

__all__ = ["EnvState", "GraspEnv", "GrasperEnv", "ReacherEnv",
           "register_envs"]


def __getattr__(name):
    # gymnasium and the reacher stay lazy, so that the batched core does
    # not import them
    if name in ("GrasperEnv", "register_envs"):
        from mujoco_rl_ur5_tpu_torch.env import gym_wrapper

        return getattr(gym_wrapper, name)
    if name == "ReacherEnv":
        from mujoco_rl_ur5_tpu_torch.env.reacher import ReacherEnv

        return ReacherEnv
    raise AttributeError(name)
