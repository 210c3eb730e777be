"""The port stands alone, routes CPU tensors to its plain versions, and never
falls back to the CPU when CUDA is asked for.

* Importing every module of mujoco_rl_ur5_tpu_torch in a fresh interpreter
  loads neither jax nor any module of the JAX package, and no port source
  names them (imports inside functions included).
* Each kernel wrapper given CPU tensors returns its plain version's result
  and launches nothing; a tensor on any other non-CUDA device raises.
* ``GraspMPC`` asked for ``cuda`` where there is none raises.
* ``plan_from_arrays`` carries the JAX package's chain plan across: the port
  computes the same rollout on it as on the plan it loads itself.
* The four narrowphase kernels (csrc/collide_*.cu) compile on the host with
  g++ through a shim header that stands in for the CUDA runtime and
  defines the kernels' launch (``COLLIDE_LAUNCH``) as loops over blocks
  and threads; called
  through their C entry points on CPU tensors, they give their plain
  versions' outputs to the bit (both round every product and sum in the
  same order; the host build, like nvcc's, does not contract them).
"""

import ctypes
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_rl_ur5_tpu_torch as port
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
    assert len(mods) >= 24
    for m in ("mpc.ilqr", "mpc.lqr", "mpc.cuda_ilqr", "mpc.grasp_mpc",
              "physics.chain", "physics.cuda_chain", "ops.blockchol",
              "ops.spatial", "ops.consts", "physics.kinematics",
              "physics.dynamics", "physics.collision",
              "physics.cuda_collide", "physics.constraints"):
        assert "mujoco_rl_ur5_tpu_torch." + m in mods
    code = (
        "import sys\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'mujoco_rl_ur5_tpu' or m.startswith('mujoco_rl_ur5_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|mujoco_rl_ur5_tpu)\b"
    r"|from\s+(jax|jaxlib)\b"
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
                 w.w_posture, mpc.home, xs[:, :-1],
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
                      w.w_orient, w.w_posture, mpc.home,
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


# a host stand-in for the CUDA runtime: kernels become plain functions
_SHIM = """#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
struct ShimDim { unsigned x = 0, y = 0, z = 0; };
static ShimDim blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
static inline int cudaGetLastError() { return 0; }
#define COLLIDE_LAUNCH(kernel, blocks, stream, ...)                  \\
  do {                                                               \\
    gridDim.x = (blocks);                                            \\
    blockDim.x = COLLIDE_THREADS;                                    \\
    for (blockIdx.x = 0; blockIdx.x < gridDim.x; ++blockIdx.x)       \\
      for (threadIdx.x = 0; threadIdx.x < blockDim.x; ++threadIdx.x) \\
        kernel(__VA_ARGS__);                                         \\
  } while (0)
"""


def _host_build(kernel, d):
    src = cuda_collide.source(kernel)
    (d / "cuda_runtime.h").write_text(_SHIM)
    for name, text in src.headers.items():
        (d / name).write_text(text)
    (d / f"{kernel}.cpp").write_text(src.text)
    so = d / f"{kernel}.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I",
                    os.fspath(d), "-o", os.fspath(so),
                    os.fspath(d / f"{kernel}.cpp")], check=True, timeout=120)
    fn = getattr(ctypes.CDLL(os.fspath(so)), src.entry)
    fn.argtypes, fn.restype = list(src.argtypes), ctypes.c_int
    return fn


@pytest.mark.parametrize("kernel", cuda_collide.KERNELS)
def test_collide_kernel_source_runs_on_the_host(tmp_path, kernel):
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the kernel sources on the host")
    fn = _host_build(kernel, tmp_path)
    rng = np.random.default_rng(7)
    B, n, G = 3, 5, 10
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pos = t(rng.uniform(-0.08, 0.08, (B, G, 3)))
    q = rng.normal(size=(B, G, 4))
    quat = t(q / np.linalg.norm(q, axis=-1, keepdims=True))
    size = t(rng.uniform(0.03, 0.1, (G, 3)))
    from mujoco_rl_ur5_tpu_torch.scene.compile import _cylinder_prism_hull
    h = [_cylinder_prism_hull(0.03, 0.05), _cylinder_prism_hull(0.05, 0.02)]
    hulls = cuda_collide.Hulls(
        torch.arange(G) % 2, t([x.hull_verts for x in h]),
        t(np.ones((2, 32))), t([x.hull_fnorm for x in h]),
        t([x.hull_fdist for x in h]))
    g1 = torch.from_numpy(rng.integers(0, G // 2, (B, n)))
    g2 = torch.from_numpy(rng.integers(G // 2, G, (B, n)))
    K = 9 if kernel == "box_box" else 8
    outs = [torch.empty(B, n, K, 3), torch.empty(B, n, K, 3),
            torch.empty(B, n, K)]
    keep = [pos, quat, size, hulls.meshid.to(torch.int32), *hulls[1:],
            g1.to(torch.int32), g2.to(torch.int32), *outs]
    assert fn(*(x.data_ptr() for x in keep), B, n, G, 32, 18, None) == 0
    want = getattr(cuda_collide, f"{kernel}_batched").plain(
        pos, quat, size, hulls, g1, g2)
    act = want[2] < 1.0
    assert act.sum() >= 5
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got[act].numpy(), ref[act].numpy())
    assert bool((outs[2][~act] >= 1.0).all())
