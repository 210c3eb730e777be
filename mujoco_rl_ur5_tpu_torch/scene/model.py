"""Compiled scene: static structure (:class:`Topology`) and numeric arrays
(:class:`Model`), numpy only.

The port's counterpart of the JAX package's model pytrees, holding only
what the chain plan (physics/chain.make_chain_plan) and the MPC
(mpc/grasp_mpc.GraspMPC) read. Numeric arrays are float32 by default, as
the JAX package compiles them, so that a plan built here carries the same
values as one built there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(eq=False)
class Topology:
    nq: int = 0
    nv: int = 0
    nu: int = 0
    nbody: int = 0
    njnt: int = 0
    neq: int = 0
    ntree: int = 0
    timestep: float = 0.002
    gravity: tuple = (0.0, 0.0, -9.81)
    body_parent: np.ndarray = None    # (nbody,)
    body_jntnum: np.ndarray = None    # (nbody,)
    body_tree: np.ndarray = None      # (nbody,) tree id, -1 for static
    tree_rootbody: np.ndarray = None  # (ntree,)
    jnt_type: np.ndarray = None       # (njnt,)
    jnt_body: np.ndarray = None
    jnt_qposadr: np.ndarray = None
    jnt_dofadr: np.ndarray = None
    act_dofadr: np.ndarray = None     # (nu,)
    act_jnt: np.ndarray = None
    eq_j1_dof: np.ndarray = None      # (neq,)
    eq_j2_dof: np.ndarray = None
    eq_j1_qadr: np.ndarray = None
    eq_j2_qadr: np.ndarray = None
    xpos0: np.ndarray = None          # (nbody, 3) world poses at qpos0
    xquat0: np.ndarray = None         # (nbody, 4)
    body_names: tuple = ()
    joint_names: tuple = ()

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)

    def joint_id(self, name: str) -> int:
        return self.joint_names.index(name)


@dataclass(eq=False)
class Model:
    topo: Topology
    qpos0: np.ndarray          # (nq,)
    body_pos: np.ndarray       # (nbody, 3)
    body_quat: np.ndarray      # (nbody, 4)
    body_mass: np.ndarray      # (nbody,)
    body_inertia: np.ndarray   # (nbody, 3) principal inertia
    body_ipos: np.ndarray      # (nbody, 3)
    body_iquat: np.ndarray     # (nbody, 4)
    jnt_pos: np.ndarray        # (njnt, 3)
    jnt_axis: np.ndarray       # (njnt, 3)
    jnt_ref: np.ndarray        # (njnt,)
    dof_damping: np.ndarray    # (nv,)
    dof_armature: np.ndarray   # (nv,)
    act_gear: np.ndarray       # (nu,)
    act_ctrlrange: np.ndarray  # (nu, 2)
    eq_poly: np.ndarray        # (neq, 5)
    eq_solref: np.ndarray      # (neq, 2)
    eq_solimp: np.ndarray      # (neq, 3)
