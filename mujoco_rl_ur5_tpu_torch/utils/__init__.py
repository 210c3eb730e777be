"""utils/ of the PyTorch port: cross-cutting utilities.

  * ``decorators`` -- timer/debug/typeassert/dict2list as the reference's
    decorators.py, ``block_timer``, and ``torch_trace`` (a torch.profiler
    Chrome trace, the counterpart of the JAX package's ``jax_trace``);
  * ``metrics``    -- tensorboard writer with the reference's exact metric
    names (Grasping_Agent_multidiscrete.py:448-511) and console banners;
  * ``config``     -- dataclass config tree (scene, solver, env, agent,
    train, mesh).

The JAX package's ``utils/cache.py`` (XLA's persistent compile cache) has
no counterpart: the port's kernels are built once per source by
``_build.py`` and kept under ``build/kernels/``.
"""

from mujoco_rl_ur5_tpu_torch.utils.decorators import (
    block_timer, debug, dict2list, timer, torch_trace, typeassert,
)
from mujoco_rl_ur5_tpu_torch.utils.metrics import MetricsTracker
from mujoco_rl_ur5_tpu_torch.utils.config import (
    Config, EnvConfig, MeshConfig, SceneConfig, SolverConfig, TrainConfig,
)

__all__ = [
    "timer", "debug", "typeassert", "dict2list", "block_timer", "torch_trace",
    "MetricsTracker", "SceneConfig", "SolverConfig", "EnvConfig",
    "TrainConfig", "MeshConfig", "Config",
]
