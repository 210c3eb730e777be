"""ops/ of the PyTorch port: small-block Cholesky solves, quaternion and
spatial algebra, device-resident constant tables."""

from mujoco_rl_ur5_tpu_torch.ops import spatial  # noqa: F401
