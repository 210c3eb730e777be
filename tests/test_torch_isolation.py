"""The port stands alone, routes CPU tensors to its plain versions, and never
falls back to the CPU when CUDA is asked for.

* Importing every module of mujoco_rl_ur5_tpu_torch in a fresh interpreter
  loads neither jax, flax, optax, orbax nor any module of the JAX package,
  and no port source names them (imports inside functions included).
* Each kernel wrapper given CPU tensors returns its plain version's result
  and launches nothing; a tensor on any other non-CUDA device raises.
* ``GraspMPC``, ``Controller``, ``GraspEnv``, ``MPCGraspPolicy``,
  ``GraspAgent``, ``ReplayBuffer`` and ``Trainer`` asked for ``cuda`` where
  there is none raise (the default device included).
* The subpackages export what the JAX package's export, where the port
  has them, each name the port's own object (``from
  mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics, fk``);
  ``env`` and ``parallel`` every name of the JAX package's.
* chip_smoke.py imports no gymnasium (the card's machine has none), and
  the port's modules it drives import without it.
* ``plan_from_arrays`` carries the JAX package's chain plan across: the port
  computes the same rollout on it as on the plan it loads itself.
* The six narrowphase kernels (csrc/collide_*.cu) compile on the host with
  g++ through the shim of tests/test_torch_host_shim.py, which stands in
  for the CUDA runtime and runs the kernels' launch (``COLLIDE_LAUNCH``)
  block by block, a host thread per CUDA thread; called through their C
  entry points on CPU tensors, with hull tables of 34 faces (the finger
  pad's hull beside a cylinder's prism), they give their plain versions'
  outputs to the bit (both round every product and sum in the same order;
  the host build, like nvcc's, does not contract them). Box-hull's
  launch, like hull-hull's and the probe kernels', raises without the hull
  rows' real counts and where the table does not fit one block's shared
  memory. The ray cast
  (csrc/raycast.cu, a block per 16 x 16 tile of a frame, its geoms culled
  per tile) does the same on three 24 x 20 frames of the object pile with
  a geom hidden: s*, geom id and normal equal to render/raycast.py's plain
  cast to the bit.
"""

import os
import pkgutil
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_host_shim import host_build

import mujoco_rl_ur5_tpu_torch as port
from mujoco_rl_ur5_tpu_torch import OBJECTS
from mujoco_rl_ur5_tpu.physics.chain import make_chain_plan as jax_make_plan
from mujoco_rl_ur5_tpu.physics.pallas_chain import (
    make_knot_step as jax_knot_step,
)
from mujoco_rl_ur5_tpu.scene.reduce import load_arm_model as jax_load_arm
from mujoco_rl_ur5_tpu_torch import ASSET, _build
from mujoco_rl_ur5_tpu_torch.carry import PLAN_FIELDS, plan_from_arrays
from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import EE_OFFSET, GraspMPC
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc
from mujoco_rl_ur5_tpu_torch.physics import cuda_collide
from mujoco_rl_ur5_tpu_torch.physics.chain import make_chain_plan
from mujoco_rl_ur5_tpu_torch.scene.reduce import load_arm_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="mujoco_rl_ur5_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 46
    for m in ("learn.networks", "learn.replay", "learn.agent",
              "learn.normalize", "learn.train", "learn.offline",
              "learn.generate_data", "utils.decorators", "utils.metrics",
              "utils.config", "mpc.ilqr", "mpc.lqr", "mpc.cuda_ilqr", "mpc.grasp_mpc",
              "mpc.policy", "control.pid", "control.ik",
              "control.controller", "control.introspect", "env.grasp_env",
              "physics.chain", "physics.cuda_chain", "ops.blockchol",
              "ops.spatial", "ops.consts", "physics.kinematics",
              "physics.dynamics", "physics.collision",
              "physics.cuda_collide", "physics.constraints", "scene.mesh",
              "render.camera", "render.raycast", "render.cuda_raycast",
              "env.reacher", "env.gym_wrapper", "parallel.mesh",
              "parallel.distributed", "examples.example",
              "examples.example_agent"):
        assert "mujoco_rl_ur5_tpu_torch." + m in mods
    code = (
        "import sys\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax') or "
        "m == 'mujoco_rl_ur5_tpu' or m.startswith('mujoco_rl_ur5_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|flax|optax|orbax|mujoco_rl_ur5_tpu)\b"
    r"|from\s+(jax|jaxlib|flax|optax|orbax)\b"
    r"|from\s+mujoco_rl_ur5_tpu(\.|\s+import))", re.M)


def test_no_port_source_names_jax_or_the_jax_package():
    pkg = os.path.dirname(port.__file__)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
               for f in fs if f.endswith(".py")]
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in sources:
        with open(path) as f:
            hit = _FORBIDDEN.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


@pytest.fixture(scope="module")
def mpc():
    return GraspMPC.from_scene(ASSET, horizon=3, substeps=2, iters=1,
                               device="cpu")


def _inputs(mpc, B=3, seed=0):
    rng = np.random.default_rng(seed)
    H = mpc.H
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x0 = t(np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                           0.05 * rng.standard_normal((B, 8))], -1))
    us = t(0.1 * rng.standard_normal((B, H, 7)))
    return rng, t, x0, us


def _launches():
    return (cc.rollout_open.launches, cc.lin_fd.launches,
            cc.rollout_closed.launches, cuda_lqr.backward.launches,
            cc.ee_quad_gn.launches)


@pytest.mark.parametrize("kernel", ["rollout_open", "lin_fd",
                                    "rollout_closed", "backward",
                                    "ee_quad_gn"])
def test_cpu_tensors_route_to_the_plain_version(mpc, kernel):
    rng, t, x0, us = _inputs(mpc)
    plan, S, H = mpc.plan, mpc.substeps, mpc.H
    B = x0.shape[0]
    xs = cc.rollout_open_plain(plan, S, x0, us)
    K = t(0.05 * rng.standard_normal((B, H, 7, 16)))
    d = t(0.1 * rng.standard_normal((B, H, 7)))
    F = t(np.eye(16) + 0.1 * rng.standard_normal((B, H, 16, 16)))
    L = t(0.1 * rng.standard_normal((B, H, 16, 7)))
    X, q, U, r = mpc._track_quad(xs[:, :-1], us, (xs[:, :-1, :8],
                                                  xs[:, :-1, 8:]))
    XH, qH = mpc._track_term_quad(xs[:, -1], (xs[:, -1, :8], xs[:, -1, 8:]))
    reg = t([1e-6, 1e-3, 1.0])
    w = mpc.w
    quad_args = (plan, mpc.ee_slot, EE_OFFSET, w.w_ee_run, w.w_orient,
                 w.w_posture, w.w_vel, mpc.home, xs[:, :-1],
                 t([[0.0, -0.6, 1.0]] * B))
    calls = {
        "rollout_open": (cc.rollout_open, cc.rollout_open_plain,
                         (plan, S, x0, us)),
        "lin_fd": (cc.lin_fd, cc.lin_fd_plain, (plan, S, xs[:, :-1], us)),
        "rollout_closed": (cc.rollout_closed, cc.rollout_closed_plain,
                           (plan, S, x0, xs, us, K, d, (1.0, 0.3))),
        "backward": (cuda_lqr.backward, cuda_lqr.backward_plain,
                     (F, L, X, q, U, r, XH, qH, reg)),
        "ee_quad_gn": (cc.ee_quad_gn, cc.ee_quad_gn_plain, quad_args),
    }
    wrapper, plain, args = calls[kernel]
    before = _launches()
    got, want = wrapper(*args), plain(*args)
    assert _launches() == before
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tensor_on_another_device_raises(mpc):
    x0 = torch.zeros(2, 16, device="meta")
    us = torch.zeros(2, mpc.H, 7, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cc.rollout_open(mpc.plan, mpc.substeps, x0, us)
    w = mpc.w
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cc.ee_quad_gn(mpc.plan, mpc.ee_slot, EE_OFFSET, w.w_ee_run,
                      w.w_orient, w.w_posture, w.w_vel, mpc.home,
                      torch.zeros(2, mpc.H, 16, device="meta"),
                      torch.zeros(2, 3, device="meta"))


def test_every_kernel_source_is_in_the_package(mpc):
    names = {s.name for s in mpc.kernel_sources()}
    assert names == {"chain_rollout_open", "chain_lin_fd",
                     "chain_rollout_closed", "lqr_backward",
                     "chain_ee_quad_gn"}
    for n in names:
        assert os.path.exists(os.path.join(_build.CSRC, n + ".cu")), n


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GraspMPC.from_scene(ASSET, horizon=3, substeps=2)   # default device
    with pytest.raises(RuntimeError, match="cuda"):
        GraspMPC.from_scene(ASSET, horizon=3, substeps=2, device="cuda:0")


def test_entry_points_on_cuda_without_a_card_raise(monkeypatch, mpc):
    from mujoco_rl_ur5_tpu_torch.control import Controller
    from mujoco_rl_ur5_tpu_torch.env import GraspEnv
    from mujoco_rl_ur5_tpu_torch.learn import (
        AgentConfig, GraspAgent, ReplayBuffer, Trainer,
    )
    from mujoco_rl_ur5_tpu_torch.mpc import MPCGraspPolicy
    from mujoco_rl_ur5_tpu_torch.scene.compile import compile_file
    from mujoco_rl_ur5_tpu_torch.utils import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = compile_file(OBJECTS)
    for make in (lambda d: Controller(host, **d),
                 lambda d: GraspEnv(host, image_width=8, image_height=8,
                                    **d),
                 lambda d: MPCGraspPolicy(host, mpc, **d),
                 lambda d: GraspAgent(AgentConfig(width=8, height=8), **d),
                 lambda d: ReplayBuffer(4, (8, 8, 4), **d),
                 lambda d: Trainer(Config(), **d)):
        for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
            with pytest.raises(RuntimeError, match="cuda"):
                make(kw)


EXPORTS = {
    "physics": {"Kin": "physics.kinematics", "fk": "physics.kinematics",
                "step": "physics.dynamics", "forward": "physics.dynamics",
                "constraints": "physics.constraints",
                "dynamics": "physics.dynamics"},
    "render": {n: "render.camera" for n in ("Camera", "make_camera",
                                            "pixel_2_world",
                                            "world_2_pixel")}
    | {n: "render.raycast" for n in ("render_depth", "render_rgbd")},
    "scene": {"compile_spec": "scene.compile", "load_model": "scene.compile",
              "Model": "scene.model", "State": "scene.model",
              "Topology": "scene.model", "make_state": "scene.model"},
    "mpc": {"LQR": "mpc.lqr", "Gains": "mpc.lqr",
            "backward_sequential": "mpc.lqr",
            "backward_parallel": "mpc.lqr", "rollout_policy": "mpc.lqr",
            "ILQRResult": "mpc.ilqr", "ilqr": "mpc.ilqr",
            "ilqr_chain_batch": "mpc.cuda_ilqr", "GraspMPC": "mpc.grasp_mpc",
            "MPCWeights": "mpc.grasp_mpc", "MPCGraspPolicy": "mpc.policy",
            "PickResult": "mpc.policy"},
    "ops": {"spatial": "ops.spatial"},
    "control": {n: "control.pid" for n in ("PIDParams", "PIDState",
                                           "pid_init", "pid_output",
                                           "reference_gains")}
    | {n: "control.controller" for n in ("Controller", "CtrlState",
                                         "MoveResult")}
    | {"ik_solve": "control.ik"}
    | {n: "control.introspect" for n in ("show_model_info",
                                         "display_current_values",
                                         "joint_angle_plot")},
    "env": {"EnvState": "env.grasp_env", "GraspEnv": "env.grasp_env",
            "GrasperEnv": "env.gym_wrapper",
            "register_envs": "env.gym_wrapper", "ReacherEnv": "env.reacher"},
    "parallel": {n: "parallel.mesh" for n in (
        "make_mesh", "shard_batch", "replicate", "dp_train_step",
        "dp_env_rollout", "dp_env_reset", "tp_param_shardings",
        "tp_place_train_state")}
    | {"initialize_multihost": "parallel.distributed"},
    "learn": {n: "learn.networks" for n in (
        "MultidiscreteResnet", "multidiscrete_resnet", "resnet",
        "policy_resnet", "count_parameters")}
    | {"ReplayBuffer": "learn.replay", "GraspAgent": "learn.agent",
       "AgentConfig": "learn.agent", "Trainer": "learn.train"},
    "utils": {n: "utils.decorators" for n in (
        "timer", "debug", "typeassert", "dict2list", "block_timer",
        "torch_trace")}
    | {"MetricsTracker": "utils.metrics"}
    | {n: "utils.config" for n in ("SceneConfig", "SolverConfig",
                                   "EnvConfig", "TrainConfig", "MeshConfig",
                                   "Config")},
}


def test_learn_and_utils_export_the_jax_packages_names():
    """learn/ and utils/ export every name of the JAX package's, the JAX
    package's ``jax_trace`` as the port's ``torch_trace``."""
    import mujoco_rl_ur5_tpu.learn as jlearn
    import mujoco_rl_ur5_tpu.utils as jutils
    import mujoco_rl_ur5_tpu_torch.learn as learn
    import mujoco_rl_ur5_tpu_torch.utils as utils

    assert learn.__all__ == jlearn.__all__
    assert utils.__all__ == [n.replace("jax_trace", "torch_trace")
                             for n in jutils.__all__]


def test_env_and_parallel_export_the_jax_packages_names():
    """env/ and parallel/ export every name of the JAX package's."""
    import mujoco_rl_ur5_tpu.env as jenv
    import mujoco_rl_ur5_tpu.parallel as jparallel
    import mujoco_rl_ur5_tpu_torch.env as env
    import mujoco_rl_ur5_tpu_torch.parallel as parallel

    assert env.__all__ == jenv.__all__
    assert parallel.__all__ == jparallel.__all__


_GYM = re.compile(r"^\s*(import|from)\s+\S*(gymnasium|gym_wrapper|"
                  r"example_agent)\b", re.M)


def test_chip_smoke_needs_no_gymnasium():
    """The card's machine has no gymnasium: chip_smoke.py imports neither
    it nor a module of the port that does, and the modules it drives
    import without it."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        hit = _GYM.search(f.read())
    assert hit is None, hit.group(0)
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import mujoco_rl_ur5_tpu_torch.env as env\n"
        "assert env.ReacherEnv and env.GraspEnv\n"
        "for m in ('env.reacher', 'parallel', 'parallel.mesh',\n"
        "          'parallel.distributed', 'examples.example',\n"
        "          'learn.train', 'mpc.grasp_mpc'):\n"
        "    __import__('mujoco_rl_ur5_tpu_torch.' + m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the exports that are submodules (mpc's ``ilqr`` is the function, which
# shadows its module there as in the JAX package)
SUBMODULES = {("physics", "constraints"), ("physics", "dynamics"),
              ("ops", "spatial")}


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_subpackage_exports_are_the_ports_own(package):
    import importlib

    pkg = importlib.import_module("mujoco_rl_ur5_tpu_torch." + package)
    for name, where in EXPORTS[package].items():
        mod = importlib.import_module("mujoco_rl_ur5_tpu_torch." + where)
        obj = getattr(pkg, name)
        want = mod if (package, name) in SUBMODULES else getattr(mod, name)
        assert obj is want, (package, name)
        owner = obj.__name__ if hasattr(obj, "__file__") else obj.__module__
        assert owner.startswith("mujoco_rl_ur5_tpu_torch."), (name, owner)
    if hasattr(pkg, "__all__"):
        assert set(pkg.__all__) <= set(EXPORTS[package])
    from mujoco_rl_ur5_tpu_torch.physics import constraints, dynamics, fk
    assert fk is dynamics.fk and constraints.init_warm


def test_kernel_build_key_follows_the_emitted_source(mpc):
    a, b, c = cc.kernel_sources(mpc.plan, mpc._k_track, 16, 16)
    again = cc.kernel_sources(mpc.plan, mpc._k_track, 16, 16)
    assert [s.key for s in (a, b, c)] == [s.key for s in again]
    assert len({a.key, b.key, c.key, cuda_lqr.SOURCE.key}) == 4
    other = _build.KernelSource(a.name, a.entry, a.argtypes,
                                {"chain_substep.cuh": "// another model"})
    assert other.key != a.key
    text = cc.substep_header(mpc.plan).text
    assert "#define CHAIN_NV 8" in text and "#define CHAIN_NU 7" in text


def test_plan_from_arrays_gives_the_same_rollout():
    jplan = jax_make_plan(jax_load_arm(ASSET))
    carried = plan_from_arrays({f: np.asarray(getattr(jplan, f))
                                for f in PLAN_FIELDS})
    own = make_chain_plan(load_arm_model(ASSET))
    for f in PLAN_FIELDS:
        a = getattr(carried, f)
        if isinstance(a, np.ndarray):
            assert a.dtype in (np.int64, np.float64), (f, a.dtype)
    rng = np.random.default_rng(3)
    x0 = np.concatenate([HOME + 0.05 * rng.standard_normal((4, 8)),
                         0.05 * rng.standard_normal((4, 8))], -1)
    us = 0.1 * rng.standard_normal((4, 3, 7))
    x0t, ust = (torch.from_numpy(a.astype(np.float32)) for a in (x0, us))
    xs_c = cc.rollout_open_plain(carried, 2, x0t, ust)
    xs_o = cc.rollout_open_plain(own, 2, x0t, ust)
    # the JAX package derives the finger spring's stiffness eq_kc from an
    # f32 mass matrix (5e-5 relative to the port's f64 one); everything
    # else in the two plans is identical
    np.testing.assert_allclose(xs_c.numpy(), xs_o.numpy(), rtol=1e-5,
                               atol=1e-5)
    # and the carried plan steps as the JAX package's generated knot does
    knot = jax_knot_step(jplan, 2, unroll=True)
    q = [jnp.asarray(x0[:, i], jnp.float32) for i in range(8)]
    v = [jnp.asarray(x0[:, 8 + i], jnp.float32) for i in range(8)]
    q, v = knot(q, v, [jnp.asarray(us[:, 0, j], jnp.float32)
                       for j in range(7)])
    ref = np.stack([np.asarray(a) for a in q + v], -1)
    np.testing.assert_allclose(xs_c[:, 1].numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", cuda_collide.KERNELS)
def test_collide_kernel_source_runs_on_the_host(tmp_path, kernel):
    fn = host_build(cuda_collide.source(kernel), tmp_path)
    rng = np.random.default_rng(7)
    B, n, G = 3, 5, 10
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pos = t(rng.uniform(-0.08, 0.08, (B, G, 3)))
    q = rng.normal(size=(B, G, 4))
    quat = t(q / np.linalg.norm(q, axis=-1, keepdims=True))
    size = t(rng.uniform(0.03, 0.1, (G, 3)))
    # a cylinder's prism (32 vertices, 18 faces) and the finger pad's hull
    # scaled up (24 vertices, 34 faces), padded to 32 x 34 as a model pads
    from mujoco_rl_ur5_tpu_torch.scene.compile import _cylinder_prism_hull
    from mujoco_rl_ur5_tpu_torch.scene.mesh import process_mesh
    pad = process_mesh("pad", os.path.join(os.path.dirname(OBJECTS),
                                           "finger_pad.stl"),
                       np.full(3, 2e-3))
    h = [_cylinder_prism_hull(0.03, 0.05), pad]
    V, F = 32, 34
    verts, vmask = np.zeros((2, V, 3)), np.zeros((2, V))
    fnorm, fdist = np.zeros((2, F, 3)), np.full((2, F), 1e10)
    for i, x in enumerate(h):
        nv, nf = len(x.hull_verts), len(x.hull_fnorm)
        verts[i, :nv], vmask[i, :nv] = x.hull_verts, 1.0
        fnorm[i, :nf], fdist[i, :nf] = x.hull_fnorm, x.hull_fdist
    assert len(pad.hull_fnorm) == 34 and len(pad.hull_verts) == 24
    hulls = cuda_collide.Hulls(torch.arange(G) % 2, t(verts), t(vmask),
                               t(fnorm), t(fdist))
    g1 = torch.from_numpy(rng.integers(0, G // 2, (B, n)))
    g2 = torch.from_numpy(rng.integers(G // 2, G, (B, n)))
    K = cuda_collide.TEAM[kernel][0] if kernel in cuda_collide.TEAM else 9
    outs = [torch.empty(B, n, K, 3), torch.empty(B, n, K, 3),
            torch.empty(B, n, K)]
    ids = [g1.to(torch.int32), g2.to(torch.int32)]
    if kernel in cuda_collide.TEAM:           # real counts, table staged
        sizes = [size] if cuda_collide.TEAM[kernel][1] else []
        keep = [pos, quat, *sizes, hulls.meshid.to(torch.int32), hulls.verts,
                hulls.fnorm, hulls.fdist,
                *cuda_collide.hull_counts(hulls.vmask, hulls.fdist), *ids,
                *outs]
        assert fn(*(x.data_ptr() for x in keep), B, n, G, 2, V, F,
                  None) == 0
    else:                                     # box-box: sizes, no counts
        keep = [pos, quat, size, hulls.meshid.to(torch.int32), hulls.verts,
                hulls.fnorm, hulls.fdist, *ids, *outs]
        assert fn(*(x.data_ptr() for x in keep), B, n, G, V, F, None) == 0
    want = getattr(cuda_collide, f"{kernel}_batched").plain(
        pos, quat, size, hulls, g1, g2)
    act = want[2] < 1.0
    assert act.sum() >= 5
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got[act].numpy(), ref[act].numpy())
    assert bool((outs[2][~act] >= 1.0).all())


def _box_hull_operands(M=2, V=32, F=34):
    """CPU operands of a box-hull launch: 4 geoms (boxes 0-1, hulls 2-3),
    tables of M rows with their counts."""
    B, n, G = 2, 3, 4
    hulls = cuda_collide.Hulls(
        torch.tensor([-1, -1, 0, M - 1]), torch.zeros(M, V, 3),
        torch.ones(M, V), torch.zeros(M, F, 3), torch.zeros(M, F),
        torch.full((M,), V, dtype=torch.int32),
        torch.full((M,), F, dtype=torch.int32))
    return (torch.zeros(B, G, 3), torch.zeros(B, G, 4), torch.ones(G, 3),
            hulls, torch.zeros(B, n, dtype=torch.long),
            torch.full((B, n), 2))


def test_box_hull_launch_needs_the_counts():
    pos, quat, size, hulls, g1, g2 = _box_hull_operands()
    for missing in ("nvert", "nface"):
        with pytest.raises(ValueError, match="counts"):
            cuda_collide.team_launch("box_hull", pos, quat, size,
                                     hulls._replace(**{missing: None}), g1,
                                     g2)


def test_box_hull_raises_where_the_table_does_not_fit():
    """Box-hull stages the hull table in one block's shared memory, as
    hull-hull does (with 8 rows for the box's corners in place of V): a
    table too large for it raises before any build or launch."""
    assert (cuda_collide.team_smem("box_hull", 11, 32, 34)
            == cuda_collide.team_smem("hull_hull", 11, 32, 34) - 32 * 24 * 16)
    pos, quat, size, hulls, g1, g2 = _box_hull_operands(M=2000)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_collide.team_launch("box_hull", pos, quat, size, hulls, g1, g2)


@pytest.mark.parametrize("kernel", ["plane_hull", "sphere_hull",
                                    "capsule_hull"])
def test_probe_launch_needs_the_counts_and_a_table_that_fits(kernel):
    """Plane-hull, sphere-hull and capsule-hull take the team launch's
    checks: each row's real counts, and a table staged in one block's
    shared memory (plane-hull stages no faces: V + 1 rows per instance and
    the vertices; capsule-hull also the faces; sphere-hull the faces and
    the counts alone)."""
    pos, quat, size, hulls, g1, g2 = _box_hull_operands()
    for missing in ("nvert", "nface"):
        with pytest.raises(ValueError, match="counts"):
            cuda_collide.team_launch(kernel, pos, quat, size,
                                     hulls._replace(**{missing: None}), g1,
                                     g2)
    faces = 0 if kernel == "plane_hull" else 11 * 34 * 16
    rows = 0 if kernel == "sphere_hull" else 32 * 33 * 16 + 11 * 32 * 12
    assert (cuda_collide.team_smem(kernel, 11, 32, 34)
            == rows + faces + 11 * 8)
    pos, quat, size, hulls, g1, g2 = _box_hull_operands(M=2000)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_collide.team_launch(kernel, pos, quat, size, hulls, g1, g2)


def test_raycast_kernel_source_runs_on_the_host(tmp_path):
    from mujoco_rl_ur5_tpu_torch.physics.kinematics import fk
    from mujoco_rl_ur5_tpu_torch.render import cuda_raycast, raycast
    from mujoco_rl_ur5_tpu_torch.render.camera import make_camera
    from mujoco_rl_ur5_tpu_torch.scene.compile import load_model
    from mujoco_rl_ur5_tpu_torch.scene.mjcf import JNT_FREE
    fn = host_build(cuda_raycast.SOURCE, tmp_path)
    m = load_model(OBJECTS, device="cpu")
    t = m.topo
    rng = np.random.default_rng(4)
    B = 3
    q = np.tile(m.qpos0.numpy().astype(np.float64), (B, 1))
    q[:, :6] = [-1.42, -1.08, 0.348, -1.739, 3.142, 0.671]  # pads over the bin
    for j in np.nonzero(t.jnt_type == JNT_FREE)[0]:
        qa = t.jnt_qposadr[j]
        quat = rng.normal(size=(B, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                     keepdims=True)
    cam = make_camera(m, "top_down", 24, 20)
    dirs = cam.dirs
    par, code, faces = raycast.geom_table(
        m, fk(m, torch.from_numpy(q.astype(np.float32))), cam,
        hidden_geoms=(t.geom_id("object_3_geom"),))
    cull = raycast.render_tables(m, cam, (t.geom_id("object_3_geom"),)).cull
    N, G, F = dirs.shape[0], par.shape[1], faces.shape[1]
    outs = [torch.empty(B, N), torch.empty(B, N, dtype=torch.int32),
            torch.empty(B, N, 3)]
    keep = [par, code.to(torch.int32).contiguous(), faces, dirs,
            cull.planes, cull.radius, *outs]
    assert fn(*(x.data_ptr() for x in keep), None, None, B, 24, 20, G, F,
              cull.nhull, None) == 0
    want = cuda_raycast.cast_rays.plain(par, code, faces, dirs)
    wins = code[want[1].long(), 0][want[0] < 1e9]
    assert set(wins.tolist()) == set(range(6))             # every branch
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
