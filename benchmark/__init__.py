"""The benchmark of mujoco_rl_ur5_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA H100: ``python3 -m benchmark.run`` (see run.py). It measures the
port alone and holds its answers against the plain reference under
reference/, which imports nothing of the port."""
