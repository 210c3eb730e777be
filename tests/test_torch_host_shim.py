"""The host shim that runs the port's CUDA kernel sources on the CPU.

The card's compiler is not at hand where these tests run, so the kernel
sources (csrc/*.cu) compile with g++ against a stand-in ``cuda_runtime.h``
(``SHIM``): every CUDA thread of a block runs as a host thread, a block at
a time; ``__syncthreads`` and ``__syncwarp`` are one barrier over the
block (stronger than the card's, which the kernels never need weaker);
``__ballot_sync`` is a vote over each warp's 32 threads between two
barriers, so every thread of the block must reach it together, as the
kernels call it; ``__shared__`` variables are static (one block runs at a
time) and the dynamic shared memory is one static array, filled with NaN
before each block; ``cp.async`` copies complete at once. A launch
``kernel<<<grid, threads, ...>>>(args)`` (or the collide kernels'
``COLLIDE_LAUNCH``) becomes ``shim_launch``. ``host_build`` compiles one
build unit and returns its C entry point with the wrapper's ctypes
signature; g++ does not contract multiply-adds (-ffp-contract=off), as the
kernels built with -fmad=false do not on the card.

tests/test_torch_isolation.py and tests/test_torch_team_kernels.py run the
kernels through it; the test below checks the shim's warp vote.
"""

import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest

SHIM = """#pragma once
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
#define __shared__ static
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
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
static int shim_vote[1024];
inline unsigned __ballot_sync(unsigned, int pred) {
  shim_vote[threadIdx.x] = pred != 0;
  shim_bar->arrive_and_wait();
  const unsigned w0 = threadIdx.x & ~31u;
  unsigned m = 0;
  for (unsigned l = 0; l < 32 && w0 + l < blockDim.x; ++l)
    m |= shim_vote[w0 + l] ? 1u << l : 0u;
  shim_bar->arrive_and_wait();
  return m;
}
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
#define COLLIDE_LAUNCH(kernel, blocks, stream, ...) \\
  shim_launch((blocks), COLLIDE_THREADS, kernel, __VA_ARGS__)
"""


def host_build(src, d):
    """Compile a kernel's build unit (a ``_build.KernelSource``: its text,
    generated headers, entry point and argument types) for the host with
    ``SHIM`` in directory ``d``; returns the C entry point."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the kernel sources on the host")
    d.mkdir(parents=True, exist_ok=True)
    (d / "cuda_runtime.h").write_text(SHIM)
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


_VOTE = """#include <cuda_runtime.h>
// each thread whose flag is set writes its id at its ordered place
__global__ void compact_kernel(const int* flag, int* out, int* total, int n) {
  __shared__ int warp_n[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool p = t < n && flag[t];
  const unsigned m = __ballot_sync(0xffffffffu, p);
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int off = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) {
    off += w < warp ? warp_n[w] : 0;
    all += warp_n[w];
  }
  if (p) out[off + __popc(m & ((1u << lane) - 1u))] = t;
  if (t == 0) *total = all;
}
extern "C" int compact(const int* flag, int* out, int* total, int n,
                       int threads) {
  compact_kernel<<<1, threads, 0, nullptr>>>(flag, out, total, n);
  return 0;
}
"""


@pytest.mark.parametrize("threads", [96, 256])
def test_shim_warp_vote_compacts_in_order(tmp_path, threads):
    P = ctypes.c_void_p
    fn = host_build(types.SimpleNamespace(
        name="vote", text=_VOTE, headers={}, entry="compact",
        argtypes=(P, P, P, ctypes.c_int, ctypes.c_int)), tmp_path)
    rng = np.random.default_rng(threads)
    n = threads - 5                       # a ragged last warp
    flag = (rng.random(threads) < 0.4).astype(np.int32)
    out = np.full(threads, -1, np.int32)
    total = np.zeros(1, np.int32)
    assert fn(flag.ctypes.data, out.ctypes.data, total.ctypes.data, n,
              threads) == 0
    want = np.nonzero(flag[:n])[0]
    assert total[0] == len(want) > 10
    np.testing.assert_array_equal(out[:len(want)], want)
