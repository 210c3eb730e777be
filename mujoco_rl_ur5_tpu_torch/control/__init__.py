"""control/ of the PyTorch port: the PID bank, joint groups and motion
primitives as masked fixed-horizon rollouts, and batched IK (the JAX
package's control/ on a leading batch axis)."""

from mujoco_rl_ur5_tpu_torch.control.pid import (  # noqa: F401
    PIDParams, PIDState, pid_init, pid_output, reference_gains,
)
from mujoco_rl_ur5_tpu_torch.control.controller import (  # noqa: F401
    Controller, CtrlState, MoveResult,
)
from mujoco_rl_ur5_tpu_torch.control.ik import ik_solve  # noqa: F401
from mujoco_rl_ur5_tpu_torch.control.introspect import (  # noqa: F401
    show_model_info, display_current_values, joint_angle_plot,
)
