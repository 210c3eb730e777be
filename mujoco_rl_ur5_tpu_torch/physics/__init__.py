"""physics/ of the PyTorch port: batched kinematics, the contact step and
the arm chain, with their kernels (cuda_chain.py, cuda_collide.py).

Exports what the JAX package's physics/ exports (``Kin``, ``fk``,
``step``, ``forward``); its submodules ``constraints`` and ``dynamics`` are
attributes, so that ``from mujoco_rl_ur5_tpu_torch.physics import
constraints, dynamics, fk`` works as it does there.
"""

from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics  # noqa: F401
from mujoco_rl_ur5_tpu_torch.physics.dynamics import forward, step  # noqa: F401
from mujoco_rl_ur5_tpu_torch.physics.kinematics import Kin, fk  # noqa: F401
