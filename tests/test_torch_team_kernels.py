"""The two kernels redesigned for Hopper, checked on the host.

* ``lqr_backward`` (a team of 16 lanes per scenario) and ``rollout_closed``
  (the alphas of 32 scenarios in one block) compile with g++ through a
  shim header that runs every CUDA thread of a block as a host thread:
  ``__syncwarp`` and ``__syncthreads`` become one barrier over the block
  (stronger than the card's, which the kernels never need weaker), and
  ``cp.async`` copies complete at once. Called through their C entry
  points on CPU tensors at ragged batches (11 scenarios for blocks of 8,
  37 for blocks of 32), they are held as chip_smoke.py's phase 3 holds
  them on the card: against the plain version run in float64, each
  output's error at most twice the plain float32 version's plus 1e-6 of
  its scale (the host's sinf/cosf and 1/sqrt stand in for the card's).
  ``rollout_closed`` runs with the solver's 5 alphas and with the 8 its
  launch takes at most (a block of 256 threads).
* The wrappers' input checks raise on what the kernels do not take,
  before any launch.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mujoco_rl_ur5_tpu_torch import ASSET
from mujoco_rl_ur5_tpu_torch.mpc import cuda_lqr
from mujoco_rl_ur5_tpu_torch.mpc.grasp_mpc import GraspMPC
from mujoco_rl_ur5_tpu_torch.physics import cuda_chain as cc

HOME = np.array([0.0, -1.57, 1.57, -1.57, -1.57, 0.0, 0.0, 0.0])
ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.03)
ALPHAS8 = (1.0, 0.8, 0.6, 0.45, 0.3, 0.2, 0.1, 0.03)

# a host stand-in for the CUDA runtime: one std::thread per CUDA thread of
# a block, one barrier over the block, shared memory one static array
_SHIM = """#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <math.h>
#include <thread>
#include <vector>
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
struct ShimDim { unsigned x = 0, y = 0, z = 0; };
static thread_local ShimDim threadIdx;
static ShimDim blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 0;
  return 0;
}
static std::barrier<>* shim_bar = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) { shim_bar->arrive_and_wait(); }
inline void __syncthreads() { shim_bar->arrive_and_wait(); }
alignas(16) static float4 smem4[65536];
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) {
  std::memcpy(d, s, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
template <class K, class... A>
void shim_launch(unsigned grid, unsigned threads, K kernel, A... args) {
  gridDim.x = grid;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(smem4, 0x7f, sizeof(smem4));   // stale shared memory: NaN
    std::barrier<> bar(threads);
    shim_bar = &bar;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([=] { threadIdx.x = t; kernel(args...); });
    for (auto& th : ts) th.join();
  }
}
"""


def _host_build(src, d):
    """Compile a kernel source for the host with the threaded shim: the
    launch becomes shim_launch."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the kernel sources on the host")
    d.mkdir(parents=True, exist_ok=True)
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "cuda_pipeline.h").write_text("#pragma once\n")
    for name, text in src.headers.items():
        (d / name).write_text(text)
    text = src.text.replace("extern __shared__ float4 smem4[];", "")
    text = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),[^>]*>>>\(",
                  r"shim_launch(\2, \3, \1, ", text)
    (d / f"{src.name}.cpp").write_text(text)
    so = d / f"{src.name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-I",
                    os.fspath(d), "-o", os.fspath(so),
                    os.fspath(d / f"{src.name}.cpp")], check=True,
                   timeout=300)
    fn = getattr(ctypes.CDLL(os.fspath(so)), src.entry)
    fn.argtypes, fn.restype = list(src.argtypes), ctypes.c_int
    return fn


def _hold(outs, plain32, plain64):
    """chip_smoke.py's phase 3 rule, output by output."""
    for k, p, r in zip(outs, plain32, plain64):
        assert bool(torch.isfinite(k).all())
        scale = float(r.abs().max())
        ek = float((k.double() - r).abs().max()) / scale
        ep = float((p.double() - r).abs().max()) / scale
        assert ek <= 2 * ep + 1e-6, (ek, ep)


@pytest.fixture(scope="module")
def mpc():
    return GraspMPC.from_scene(ASSET, horizon=3, substeps=2, iters=1,
                               device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _riccati_problem(B, H, seed=1):
    rng = np.random.default_rng(seed)

    def spd(shape, n, scale=1.0, floor=0.1):
        W = rng.standard_normal(shape + (n, n))
        return scale * W @ np.swapaxes(W, -1, -2) / n + floor * np.eye(n)

    return (_t(np.eye(16) + 0.1 * rng.standard_normal((B, H, 16, 16))),
            _t(0.1 * rng.standard_normal((B, H, 16, 7))),
            _t(spd((B, H), 16, floor=1.0)), _t(rng.standard_normal((B, H, 16))),
            _t(spd((B, H), 7, 0.1, 1e-3)), _t(rng.standard_normal((B, H, 7))),
            _t(spd((B,), 16, floor=1.0)), _t(rng.standard_normal((B, 16))),
            _t(10.0 ** rng.uniform(-6, 1, B)))


def test_riccati_kernel_source_runs_on_the_host(tmp_path):
    fn = _host_build(cuda_lqr.SOURCE, tmp_path)
    B, H = 11, 5                       # one full block of 8 and a ragged one
    ins = _riccati_problem(B, H)
    assert cuda_lqr.check_inputs(*ins) == (B, H)
    outs = (torch.empty(B, H, 7, 16), torch.empty(B, H, 7),
            torch.empty(B, H + 1, 16, 16), torch.empty(B, H + 1, 16))
    assert fn(*[t.data_ptr() for t in ins + outs], B, H, 16, 7, None) == 0
    _hold(outs, cuda_lqr.backward_plain(*ins),
          cuda_lqr.backward_plain(*[t.double() for t in ins]))
    assert torch.equal(outs[2], outs[2].transpose(-1, -2))   # S symmetric


def _closed_problem(mpc, B, seed=0):
    rng = np.random.default_rng(seed)
    H, S = mpc.H, mpc.substeps
    x0 = _t(np.concatenate([HOME + 0.05 * rng.standard_normal((B, 8)),
                            0.1 * rng.standard_normal((B, 8))], -1))
    us = _t(0.1 * rng.standard_normal((B, H, 7)))
    xbar = cc.rollout_open_plain(mpc.plan, S, x0, us).contiguous()
    K = _t(0.05 * rng.standard_normal((B, H, 7, 16)))
    d = _t(0.1 * rng.standard_normal((B, H, 7)))
    sref = _t(np.concatenate([xbar[:, :-1, :8].numpy()
                              + 0.05 * rng.standard_normal((B, H, 8)),
                              np.zeros((B, H, 8))], -1))
    tref = _t(np.concatenate([xbar[:, -1, :8].numpy(), np.zeros((B, 8))], -1))
    targets = _t(np.array([0.0, -0.6, 1.0])
                 + 0.1 * rng.uniform(-1, 1, (B, 3)))
    return (x0, xbar, us, K, d), {"track": (sref, tref),
                                  "reach": (None, targets)}


@pytest.fixture(scope="module")
def closed_kernel(mpc, tmp_path_factory):
    """The host build of rollout_closed for each fused cost pair, made once
    for the module."""
    built = {}

    def get(mode, R, RT):
        if mode not in built:
            cost = mpc._k_track if mode == "track" else mpc._k_reach
            src = cc._closed_src(mpc.plan, cost, R, RT)
            built[mode] = _host_build(src, tmp_path_factory.mktemp(mode))
        return built[mode]
    return get


@pytest.mark.parametrize("alphas", [ALPHAS, ALPHAS8], ids=["A5", "A8"])
@pytest.mark.parametrize("mode", ["track", "reach"])
def test_rollout_closed_kernel_source_runs_on_the_host(mpc, closed_kernel,
                                                        mode, alphas):
    B, H, A, S = 37, mpc.H, len(alphas), mpc.substeps   # 32 + a ragged 5
    args, refs = _closed_problem(mpc, B)
    sref, tref = refs[mode]
    cost = mpc._k_track if mode == "track" else mpc._k_reach
    R, RT = 0 if sref is None else sref.shape[-1], tref.shape[-1]
    fn = closed_kernel(mode, R, RT)
    assert cc.check_closed_inputs(mpc.plan, *args, alphas, sref,
                                  tref) == (B, H, A, R, RT)
    outs = (torch.empty(B, A, H + 1, 16), torch.empty(B, A, H, 7),
            torch.empty(B, A))
    ptrs = [0 if t is None else t.data_ptr()
            for t in (*args, sref, tref, *outs)]
    al = list(alphas) + [0.0] * (cc._NALPHA - A)
    assert fn(*al, *ptrs, B, H, A, S, None) == 0
    plain = cc.rollout_closed_plain(mpc.plan, S, *args, alphas, cost, sref,
                                    tref)
    plain64 = cc.rollout_closed_plain(
        mpc.plan, S, *[t.double() for t in args], alphas, cost,
        None if sref is None else sref.double(), tref.double())
    _hold(outs, plain, plain64)


def _bad(t, how):
    """A wrong version of a good input: another dtype, strides, shape or
    alignment."""
    if how == "float64":
        return t.double()
    if how == "strided":
        return torch.stack([t, t], -1)[..., 0]
    if how == "shape":                         # one scenario short
        return t[:-1].contiguous()
    flat = torch.empty(t.numel() + 1)          # 4 bytes off 16-byte alignment
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


_HOWS = ("float64", "strided", "shape")


# F L X q U r XH qH reg; the kernel reads F, L, X, q and XH by 16 bytes
@pytest.mark.parametrize("which, how", [(w, h) for w in range(9)
                                        for h in _HOWS]
                         + [(w, "unaligned") for w in (0, 1, 2, 3, 6)])
def test_backward_input_check_raises(which, how):
    ins = list(_riccati_problem(2, 3))
    ins[which] = _bad(ins[which], how)
    with pytest.raises(ValueError, match="backward"):
        cuda_lqr.check_inputs(*ins)


def test_backward_input_check_takes_only_its_widths():
    F, L, X, q, U, r, XH, qH, reg = _riccati_problem(2, 3)
    with pytest.raises(ValueError, match="nu=7"):
        cuda_lqr.check_inputs(F, L[..., :6].contiguous(), X, q,
                              U[..., :6, :6].contiguous(), r[..., :6]
                              .contiguous(), XH, qH, reg)


# the kernel reads x0, xbar, K and sref by 16 bytes
@pytest.mark.parametrize("which, how", [
    (w, h) for w in ("x0", "xbar", "ubar", "K", "d", "sref", "tref")
    for h in _HOWS] + [(w, "unaligned") for w in ("x0", "xbar", "K", "sref")])
def test_rollout_closed_input_check_raises(mpc, which, how):
    args, refs = _closed_problem(mpc, 3)
    named = dict(zip(("x0", "xbar", "ubar", "K", "d"), args))
    named["sref"], named["tref"] = refs["track"]
    named[which] = _bad(named[which], how)
    with pytest.raises(ValueError, match="rollout_closed"):
        cc.check_closed_inputs(mpc.plan, *(named[k] for k in (
            "x0", "xbar", "ubar", "K", "d")), ALPHAS, named["sref"],
            named["tref"])


def test_rollout_closed_input_check_counts_alphas(mpc):
    args, refs = _closed_problem(mpc, 3)
    cc.check_closed_inputs(mpc.plan, *args, (1.0,) * 8, *refs["track"])
    with pytest.raises(ValueError, match="alphas"):
        cc.check_closed_inputs(mpc.plan, *args, (1.0,) * 9, *refs["track"])
    with pytest.raises(ValueError, match="alphas"):
        cc.check_closed_inputs(mpc.plan, *args, (), *refs["track"])
