# Frozen copy of mujoco_rl_ur5_tpu_torch/scene/model.py at commit c4951def7b192ba06c207f9c1c9298bddc6ddcb8, imports
# rewritten to this package; the benchmark's plain reference. Dropped, as no
# check or count calls them: joint_id, geom_id, make_state.
"""Compiled scene: static structure (:class:`Topology`), numeric arrays
(:class:`Model`) and the batched dynamic state (:class:`State`).

The port's counterpart of the JAX package's model pytrees. The compiler
(scene/compile.py) gives a host model whose numeric arrays are numpy,
float32 by default as the JAX package compiles them, so that a chain plan
built here carries the same values as one built there. ``Model.to(device)``
returns the same model with every numeric array a torch tensor on the
device, uploaded once: the contact step (physics/dynamics.py) reads a
device model and never copies a model array per step.

Design note (as in the JAX package): the mass matrix is block-diagonal
over kinematic trees (the 8-dof arm and each free object), so dynamics runs
on ``(ntree, mtdof, mtdof)`` padded blocks laid out by ``dof_tree`` and
``dof_treeidx``, never on the dense (nv, nv) matrix.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def resolve_device(device, who: str) -> torch.device:
    """The device to run on; CUDA that is absent raises, never falls back.
    On CUDA, TF32 is switched off for matmuls and cuDNN: the solvers need
    full float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: device 'cuda' was asked for but "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"{who}: unsupported device {dev}")
    return dev


@dataclass(eq=False)
class Topology:
    nq: int = 0
    nv: int = 0
    nu: int = 0
    nbody: int = 0
    njnt: int = 0
    ngeom: int = 0
    neq: int = 0
    nlimit: int = 0
    ntree: int = 0
    mtdof: int = 0                    # max dofs per kinematic tree
    timestep: float = 0.002
    gravity: tuple = (0.0, 0.0, -9.81)
    iterations: int = 100
    impratio: float = 1.0
    ncam: int = 0
    znear: float = 0.01               # visual/map, fractions of the extent
    zfar: float = 50.0
    extent: float = 1.0               # stat.extent (depth near / far scale)
    body_parent: np.ndarray = None    # (nbody,)
    body_jntadr: np.ndarray = None    # (nbody,) first joint, -1 if none
    body_jntnum: np.ndarray = None    # (nbody,)
    body_levels: tuple = ()           # moving body ids per depth level
    body_tree: np.ndarray = None      # (nbody,) tree id, -1 for static
    tree_rootbody: np.ndarray = None  # (ntree,)
    jnt_type: np.ndarray = None       # (njnt,)
    jnt_body: np.ndarray = None
    jnt_qposadr: np.ndarray = None
    jnt_dofadr: np.ndarray = None
    dof_jnt: np.ndarray = None        # (nv,)
    dof_body: np.ndarray = None
    dof_tree: np.ndarray = None
    dof_treeidx: np.ndarray = None    # slot within the tree block
    dof_ancestors: np.ndarray = None  # (nv, mtdof) ancestor dofs, -1 pad
    geom_body: np.ndarray = None      # (ngeom,)
    geom_type: np.ndarray = None      # (ngeom,) MJCF geom type
    geom_meshid: np.ndarray = None    # (ngeom,) hull-table row, -1 if none
    nmesh: int = 0
    hull_maxv: int = 0
    hull_maxf: int = 0
    act_dofadr: np.ndarray = None     # (nu,)
    act_jnt: np.ndarray = None
    eq_j1_dof: np.ndarray = None      # (neq,)
    eq_j2_dof: np.ndarray = None
    eq_j1_qadr: np.ndarray = None
    eq_j2_qadr: np.ndarray = None
    limit_dof: np.ndarray = None      # (nlimit,)
    limit_qadr: np.ndarray = None
    pair_geom1: np.ndarray = None     # (npair,) candidate pairs
    pair_geom2: np.ndarray = None
    pair_groups: tuple = ()           # ((type1, type2, pair ids), ...)
    pair_condim: np.ndarray = None    # (npair,) mixed condim
    ncand: int = 0                    # candidate points before the cap
    body_ancestor_slots: np.ndarray = None  # (nbody, mtdof) bool
    xpos0: np.ndarray = None          # (nbody, 3) world poses at qpos0
    xquat0: np.ndarray = None         # (nbody, 4)
    body_names: tuple = ()
    joint_names: tuple = ()
    geom_names: tuple = ()
    cam_names: tuple = ()

    def cam_id(self, name: str) -> int:
        return self.cam_names.index(name)

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)


@dataclass(eq=False)
class Model:
    """Numeric scene arrays: numpy on the host, torch after ``to``."""

    topo: Topology
    qpos0: np.ndarray = None          # (nq,)
    body_pos: np.ndarray = None       # (nbody, 3)
    body_quat: np.ndarray = None      # (nbody, 4)
    body_mass: np.ndarray = None      # (nbody,)
    body_inertia: np.ndarray = None   # (nbody, 3) principal inertia
    body_ipos: np.ndarray = None      # (nbody, 3)
    body_iquat: np.ndarray = None     # (nbody, 4)
    jnt_pos: np.ndarray = None        # (njnt, 3)
    jnt_axis: np.ndarray = None       # (njnt, 3)
    jnt_range: np.ndarray = None      # (njnt, 2)
    jnt_ref: np.ndarray = None        # (njnt,)
    dof_damping: np.ndarray = None    # (nv,)
    dof_armature: np.ndarray = None   # (nv,)
    geom_pos: np.ndarray = None       # (ngeom, 3)
    geom_quat: np.ndarray = None      # (ngeom, 4)
    geom_size: np.ndarray = None      # (ngeom, 3)
    geom_rgba: np.ndarray = None      # (ngeom, 4)
    geom_rbound: np.ndarray = None    # (ngeom,) bounding radius, planes 1e10
    geom_friction: np.ndarray = None  # (ngeom, 3)
    geom_margin: np.ndarray = None    # (ngeom,)
    geom_solref: np.ndarray = None    # (ngeom, 2)
    geom_solimp: np.ndarray = None    # (ngeom, 3)
    geom_condim: np.ndarray = None    # (ngeom,) int
    col_type: np.ndarray = None       # (ngeom,) int collision type
    col_size: np.ndarray = None       # (ngeom, 3)
    col_pos: np.ndarray = None        # (ngeom, 3) proxy offset in the geom
    col_quat: np.ndarray = None       # (ngeom, 4)
    hull_verts: np.ndarray = None     # (nmesh, maxv, 3)
    hull_vmask: np.ndarray = None     # (nmesh, maxv) 1 = real vertex
    hull_fnorm: np.ndarray = None     # (nmesh, maxf, 3) outward normals
    hull_fdist: np.ndarray = None     # (nmesh, maxf) padding 1e10
    act_gear: np.ndarray = None       # (nu,)
    act_ctrlrange: np.ndarray = None  # (nu, 2)
    eq_poly: np.ndarray = None        # (neq, 5)
    eq_solref: np.ndarray = None      # (neq, 2)
    eq_solimp: np.ndarray = None      # (neq, 3)
    limit_range: np.ndarray = None    # (nlimit, 2)
    limit_solref: np.ndarray = None   # (nlimit, 2)
    limit_solimp: np.ndarray = None   # (nlimit, 3)
    pair_friction: np.ndarray = None  # (npair, 3) mixed pair parameters
    pair_solref: np.ndarray = None    # (npair, 2)
    pair_solimp: np.ndarray = None    # (npair, 3)
    pair_margin: np.ndarray = None    # (npair,)
    dof_invweight0: np.ndarray = None   # (nv,) diag(M^-1) at qpos0
    geom_invweight0: np.ndarray = None  # (ngeom,) body translational
    cam_pos: np.ndarray = None        # (ncam, 3) world (worldbody cameras)
    cam_quat: np.ndarray = None       # (ncam, 4)
    cam_fovy: np.ndarray = None       # (ncam,) degrees

    def to(self, device) -> "Model":
        """The model with every numeric array a torch tensor on ``device``
        (floats keep their width, integers become int64), uploaded once."""
        dev = resolve_device(device, "Model.to")
        kw = {}
        for f in ARRAY_FIELDS:
            a = getattr(self, f)
            if a is None:
                continue
            a = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
            if not a.is_floating_point():
                a = a.long()
            kw[f] = a.to(dev)
        return dataclasses.replace(self, **kw)


ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(Model)
                     if f.name != "topo")


@dataclass(eq=False)
class State:
    """Batched dynamic state: qpos (B, nq), qvel (B, nv), ctrl (B, nu),
    time (B,)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    ctrl: torch.Tensor
    time: torch.Tensor

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)
