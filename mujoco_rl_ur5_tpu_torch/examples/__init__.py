"""The reference's two example scripts on the port: ``example`` (the
controller walkthrough) and ``example_agent`` (a random agent through
gymnasium). Run as ``python -m mujoco_rl_ur5_tpu_torch.examples.example``."""
