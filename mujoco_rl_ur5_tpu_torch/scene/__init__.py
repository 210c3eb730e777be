"""scene/ of the PyTorch port: the MJCF parser and compiler, the arm
reduction and the model and state containers.

Exports what the JAX package's scene/ exports. ``compile_spec`` and
``load_model`` are read on first use: the compiler steps the physics (the
invweights), and physics/ imports scene.model, so an eager import here
would be circular.
"""

from mujoco_rl_ur5_tpu_torch.scene.model import (  # noqa: F401
    Model, State, Topology, make_state,
)

__all__ = ["compile_spec", "load_model", "Model", "State", "Topology",
           "make_state"]


def __getattr__(name):
    if name in ("compile_spec", "load_model"):
        from mujoco_rl_ur5_tpu_torch.scene import compile as _compile

        return getattr(_compile, name)
    raise AttributeError(name)
