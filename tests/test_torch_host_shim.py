"""The host shim that runs the port's CUDA kernel sources on the CPU.

The card's compiler is not at hand where these tests run, so the kernel
sources (csrc/*.cu) compile with g++ against a stand-in ``cuda_runtime.h``
(``SHIM``): every CUDA thread of a block runs as a host thread, a block at
a time; ``__syncthreads`` and ``__syncwarp`` are one barrier over the
block (stronger than the card's, which the kernels never need weaker);
``__ballot_sync`` is a vote over each warp's 32 threads between two
barriers, and the shuffles (``__shfl_sync``, ``__shfl_xor_sync``,
``__shfl_down_sync`` on 32-bit values, with a width) post and read
between two barriers likewise, so every thread of the block must reach
them together, as the kernels call them; ``__shared__`` variables are
static (one block runs at a time) and the dynamic shared memory is one
static array, filled with NaN before each block; ``cp.async`` copies complete at once. A launch
``kernel<<<grid, threads, ...>>>(args)`` (or the collide kernels'
``COLLIDE_LAUNCH``) becomes ``shim_launch``. ``host_build`` compiles one
build unit and returns its C entry point with the wrapper's ctypes
signature; g++ does not contract multiply-adds (-ffp-contract=off), as the
kernels built with -fmad=false do not on the card.

tests/test_torch_isolation.py, tests/test_torch_team_kernels.py and
tests/test_torch_hull_hull.py run the kernels through it; the tests below
check the shim's warp vote and its shuffles against their definitions.
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
#define __host__
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
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
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
static unsigned shim_lanes[1024];
// a warp shuffle: every thread of the block posts its value, then reads the
// one of thread ``src`` (its own where src lies outside the block)
template <class V> V shim_shfl(V v, unsigned src) {
  static_assert(sizeof(V) == 4, "32-bit shuffles");
  unsigned u;
  std::memcpy(&u, &v, 4);
  shim_lanes[threadIdx.x] = u;
  shim_bar->arrive_and_wait();
  const unsigned r = shim_lanes[src < blockDim.x ? src : threadIdx.x];
  shim_bar->arrive_and_wait();
  V out;
  std::memcpy(&out, &r, 4);
  return out;
}
template <class V> V __shfl_sync(unsigned, V v, int src, int width = 32) {
  const unsigned base = threadIdx.x & ~(unsigned)(width - 1);
  return shim_shfl(v, base + ((unsigned)src & (unsigned)(width - 1)));
}
template <class V> V __shfl_xor_sync(unsigned, V v, int mask, int width = 32) {
  // the warp lane ^ mask; a lane of a later group of ``width`` gives the
  // caller its own value
  const unsigned wl = threadIdx.x & 31u, warp = threadIdx.x & ~31u;
  const unsigned to = (wl ^ (unsigned)mask) & 31u;
  const unsigned end = (wl & ~(unsigned)(width - 1)) + (unsigned)width;
  return shim_shfl(v, to < end ? warp + to : threadIdx.x);
}
template <class V> V __shfl_down_sync(unsigned, V v, unsigned d,
                                      int width = 32) {
  const unsigned lane = threadIdx.x & (unsigned)(width - 1);
  const unsigned base = threadIdx.x & ~(unsigned)(width - 1);
  return shim_shfl(v, lane + d < (unsigned)width ? base + lane + d
                                                 : threadIdx.x);
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
static inline int cudaGetDevice(int* d) { *d = 0; return 0; }
static inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;                               // a grid-stride loop runs twice
  return 0;
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


_SHUFFLE = """#include <cuda_runtime.h>
// per thread, for each width: shfl from lane (3 t + 5), xor with 1, 2 and
// the width's half, down by 1 and 3, on an int and on a float
__global__ void shuffle_kernel(int* out, float* fout, const int* widths,
                               int nw) {
  const int t = threadIdx.x;
  const int v = 1000 + 7 * t;
  int k = 0;
  for (int i = 0; i < nw; ++i) {
    const int w = widths[i];
    out[(k++) * blockDim.x + t] = __shfl_sync(0xffffffffu, v, 3 * t + 5, w);
    out[(k++) * blockDim.x + t] = __shfl_xor_sync(0xffffffffu, v, 1, w);
    out[(k++) * blockDim.x + t] = __shfl_xor_sync(0xffffffffu, v, 2, w);
    out[(k++) * blockDim.x + t] = __shfl_xor_sync(0xffffffffu, v, w / 2, w);
    out[(k++) * blockDim.x + t] = __shfl_down_sync(0xffffffffu, v, 1u, w);
    out[(k++) * blockDim.x + t] = __shfl_down_sync(0xffffffffu, v, 3u, w);
    fout[i * blockDim.x + t] =
        __shfl_xor_sync(0xffffffffu, 0.5f * (float)v, 1, w);
  }
}
extern "C" int shuffle(int* out, float* fout, const int* widths, int nw,
                       int threads) {
  shuffle_kernel<<<1, threads, 0, nullptr>>>(out, fout, widths, nw);
  return 0;
}
"""


def _shfl_want(v, src, width):
    """CUDA's definition: within each group of ``width`` lanes of a warp,
    the value of lane ``src`` (per thread; taken modulo the width)."""
    t = np.arange(len(v))
    return v[(t & ~(width - 1)) + (src & (width - 1))]


def _xor_want(v, mask, width):
    t = np.arange(len(v))
    wl, warp = t & 31, t & ~31
    to = (wl ^ mask) & 31
    end = (wl & ~(width - 1)) + width
    return np.where(to < end, v[warp + to], v)


def _down_want(v, d, width):
    t = np.arange(len(v))
    lane = t & (width - 1)
    return np.where(lane + d < width, v[np.minimum(t + d, len(v) - 1)], v)


def test_shim_shuffles_follow_their_definition(tmp_path):
    P = ctypes.c_void_p
    fn = host_build(types.SimpleNamespace(
        name="shuffle", text=_SHUFFLE, headers={}, entry="shuffle",
        argtypes=(P, P, P, ctypes.c_int, ctypes.c_int)), tmp_path)
    threads, widths = 64, np.array([32, 16, 8, 4, 2], np.int32)
    out = np.zeros((6 * len(widths), threads), np.int32)
    fout = np.zeros((len(widths), threads), np.float32)
    assert fn(out.ctypes.data, fout.ctypes.data, widths.ctypes.data,
              len(widths), threads) == 0
    t = np.arange(threads)
    v = 1000 + 7 * t
    for i, w in enumerate(widths.tolist()):
        want = [_shfl_want(v, 3 * t + 5, w), _xor_want(v, 1, w),
                _xor_want(v, 2, w), _xor_want(v, w // 2, w),
                _down_want(v, 1, w), _down_want(v, 3, w)]
        for j, x in enumerate(want):
            np.testing.assert_array_equal(out[6 * i + j], x,
                                          err_msg=f"width {w}, case {j}")
        np.testing.assert_array_equal(fout[i], 0.5 * _xor_want(v, 1, w))
