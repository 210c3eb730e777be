"""env/ of the PyTorch port: the batched grasping environment
(``GraspEnv``, ``EnvState``). The JAX package's ``GrasperEnv``,
``register_envs`` and ``ReacherEnv`` have no port yet."""

from mujoco_rl_ur5_tpu_torch.env.grasp_env import EnvState, GraspEnv

__all__ = ["EnvState", "GraspEnv"]
