// Line search: every alpha's closed-loop rollout u = clip(ub + a d +
// K (x - xb)) with the stage and terminal costs summed in the same pass.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py
// rollout_closed (:579), fused costs included. Arrays are in the public
// batch-first layout, contiguous: x0 (B,16), xb (B,H+1,16), ub (B,H,7),
// K (B,H,7,16), d (B,H,7), sref (B,H,R), tref (B,RT) in; xs (B,A,H+1,16),
// us (B,A,H,7), costs (B,A) out. The alphas come as launch arguments.
//
// Bound: operations. The generated substep is ~4.3k float32 operations
// and each rollout runs H * substeps of them: 4.6e10 at B=4096, A=5,
// H=64, substeps=8, 0.689 ms at 67 TFLOP/s; the bytes are 0.3 GB. On an
// H100 (80GB HBM3, 700 W) the one-thread-per-rollout kernel ran at 17
// TFLOP/s, 25% of that rate: a substep is one long dependent chain in 255
// registers, and 20,480 rollouts are 640 warps for 528 schedulers, so the
// schedulers that hold two warps set the time. What the design does:
//  * fewer instructions per substep: the generated FK takes each joint's
//    cosine and sine from one sincosf (one range reduction, not two; the
//    other chain kernels share that header);
//  * a block holds 32 scenarios and all A alphas of each: warp a runs
//    alpha a, lane m scenario m. Per knot, the block stages K_k, xb_k,
//    ub_k, d_k and sref_k of its 32 scenarios in shared memory once for
//    all alphas, copied asynchronously (cp.async) one knot ahead while
//    the current knot's substeps run. Rows of a scenario are padded so
//    that a warp's 16-byte reads of 32 scenarios hit no bank twice;
//  * each rollout stores its 64-byte state row per knot with 16-byte
//    stores into the public xs, so no layout copy follows the launch.
// A warp-specialised variant (FK + mass matrix and FK + bias forces in
// partner warps behind a named barrier) was measured on an H100 and was
// slower: FK and the solve ran twice, 6.1k operations per rollout and
// substep against 4.3k (PERF.md).
// Every sum runs in a fixed order and nothing is added atomically, so two
// calls agree to the bit.
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include "chain_substep.cuh"
#include "chain_cost.cuh"

#define NV CHAIN_NV
#define NU CHAIN_NU
#define NX (2 * CHAIN_NV)

namespace {

constexpr int M = 32;                 // scenarios per block (one per lane)
constexpr int NARGS = 8;              // alphas passed at launch
constexpr int MAX_A = NARGS;          // alphas a launch takes (one warp each)
// one scenario's knot tile (floats): K | xb | sref | ub | d
constexpr int T_K = 0, T_XB = NU * NX, T_SR = T_XB + NX;
constexpr int NSR4 = (CHAIN_NSR + 3) / 4 * 4;
constexpr int T_UB = T_SR + NSR4, T_D = T_UB + 8;
// padded to 4 (mod 8) floats: 16-byte reads of 32 scenarios in a warp fall
// on distinct banks in every quarter-warp
constexpr int TILE = (T_D + 8 + 7) / 8 * 8 + 4;
constexpr int STAGE = M * TILE;

struct Alphas {
  float a[NARGS];
};

// start the copies of knot k's tiles of scenarios b0 .. b0+M-1 (the
// ragged edge repeats the last scenario)
__device__ __forceinline__ void load_knot(
    float* st, const float* xb, const float* ub, const float* K,
    const float* d, const float* sref, int b0, int B, int H, int k) {
  constexpr int C4 = (NU * NX + NX) / 4 + (CHAIN_NSR % 4 == 0 ? CHAIN_NSR / 4 : 0);
  for (int c = threadIdx.x; c < M * C4; c += blockDim.x) {
    const int m = c / C4, w = c - m * C4;
    const int b = min(b0 + m, B - 1);
    const size_t bk = (size_t)b * H + k;
    const float* src;
    int dst;
    if (w < NU * NX / 4) {
      src = K + bk * NU * NX + 4 * w;
      dst = T_K + 4 * w;
    } else if (w < NU * NX / 4 + NX / 4) {
      src = xb + ((size_t)b * (H + 1) + k) * NX + 4 * (w - NU * NX / 4);
      dst = T_XB + 4 * (w - NU * NX / 4);
    } else {
      const int i = 4 * (w - NU * NX / 4 - NX / 4);
      src = sref + bk * CHAIN_NSR + i;
      dst = T_SR + i;
    }
    __pipeline_memcpy_async(st + m * TILE + dst, src, 16);
  }
  constexpr int C1 = 2 * NU + (CHAIN_NSR % 4 == 0 ? 0 : CHAIN_NSR);
  for (int c = threadIdx.x; c < M * C1; c += blockDim.x) {
    const int m = c / C1, w = c - m * C1;
    const int b = min(b0 + m, B - 1);
    const size_t bk = (size_t)b * H + k;
    const float* src;
    int dst;
    if (w < NU) {
      src = ub + bk * NU + w;
      dst = T_UB + w;
    } else if (w < 2 * NU) {
      src = d + bk * NU + (w - NU);
      dst = T_D + (w - NU);
    } else {
      src = sref + bk * CHAIN_NSR + (w - 2 * NU);
      dst = T_SR + (w - 2 * NU);
    }
    __pipeline_memcpy_async(st + m * TILE + dst, src, 4);
  }
}

__device__ __forceinline__ void load16(float* dst, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < NX / 4; ++c) {
    const float4 v = s4[c];
    dst[4 * c] = v.x; dst[4 * c + 1] = v.y;
    dst[4 * c + 2] = v.z; dst[4 * c + 3] = v.w;
  }
}

__device__ __forceinline__ void store_state(float* dst, const float* q,
                                            const float* v) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int c = 0; c < NV / 4; ++c)
    d4[c] = make_float4(q[4 * c], q[4 * c + 1], q[4 * c + 2], q[4 * c + 3]);
#pragma unroll
  for (int c = 0; c < NV / 4; ++c)
    d4[NV / 4 + c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                                 v[4 * c + 3]);
}

}  // namespace

__global__ void __launch_bounds__(32 * MAX_A, 1) rollout_closed_kernel(
    Alphas al, const float* __restrict__ x0, const float* __restrict__ xb,
    const float* __restrict__ ub, const float* __restrict__ K,
    const float* __restrict__ d, const float* __restrict__ sref,
    const float* __restrict__ tref, float* __restrict__ xs,
    float* __restrict__ us, float* __restrict__ costs, int B, int H, int A,
    int substeps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % 32;
  const int a = threadIdx.x / 32;     // this warp's alpha
  const int b0 = blockIdx.x * M;
  const bool live = b0 + lane < B;
  const int b = min(b0 + lane, B - 1);
  float alpha = 0.0f;
#pragma unroll
  for (int i = 0; i < NARGS; ++i) alpha = i == a ? al.a[i] : alpha;

  float q[NV], v[NV], u[NU];
  float sr[CHAIN_NSR_ALLOC], tr[CHAIN_NTR_ALLOC];
#pragma unroll
  for (int i = 0; i < CHAIN_NTR; ++i) tr[i] = tref[(size_t)b * CHAIN_NTR + i];
  {
    float x[NX];
    load16(x, x0 + (size_t)b * NX);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      q[i] = x[i];
      v[i] = x[NV + i];
    }
  }
  float* xo = xs + ((size_t)b * A + a) * (H + 1) * NX;
  float* uo = us + ((size_t)b * A + a) * H * NU;
  if (live) store_state(xo, q, v);

  load_knot(smem, xb, ub, K, d, sref, b0, B, H, 0);
  __pipeline_commit();
  if (H >= 2) load_knot(smem + STAGE, xb, ub, K, d, sref, b0, B, H, 1);
  __pipeline_commit();
  float acc = 0.0f;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* tile = smem + (k & 1) * STAGE + lane * TILE;
    {
      float dx[NX], xbk[NX];
      load16(xbk, tile + T_XB);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        dx[i] = q[i] - xbk[i];
        dx[NV + i] = v[i] - xbk[NV + i];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float Kr[NX];
        load16(Kr, tile + T_K + j * NX);
        float uacc = tile[T_UB + j] + alpha * tile[T_D + j];
#pragma unroll
        for (int i = 0; i < NX; ++i) uacc += Kr[i] * dx[i];
        u[j] = uacc;
      }
    }
    chain_clip_ctrl(u);
    if (live) {
#pragma unroll
      for (int j = 0; j < NU; ++j) uo[(size_t)k * NU + j] = u[j];
    }
#pragma unroll
    for (int i = 0; i < CHAIN_NSR; ++i) sr[i] = tile[T_SR + i];
    acc = acc + chain_stage_cost(q, v, u, sr, tr);
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) chain_substep(q, v, u);
    if (live) store_state(xo + (size_t)(k + 1) * NX, q, v);
    __syncthreads();                  // every warp is done with this stage
    if (k + 2 < H)
      load_knot(smem + (k & 1) * STAGE, xb, ub, K, d, sref, b0, B, H, k + 2);
    __pipeline_commit();
  }
  if (live) costs[(size_t)b * A + a] = acc + chain_term_cost(q, v, tr);
}

constexpr size_t SMEM = 2 * (size_t)STAGE * sizeof(float);

extern "C" int rollout_closed(float a0, float a1, float a2, float a3, float a4,
                              float a5, float a6, float a7, const float* x0,
                              const float* xb, const float* ub, const float* K,
                              const float* d, const float* sref,
                              const float* tref, float* xs, float* us,
                              float* costs, int B, int H, int A, int substeps,
                              void* stream) {
  if (A < 1 || A > MAX_A || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Alphas al = {{a0, a1, a2, a3, a4, a5, a6, a7}};
  cudaError_t err = cudaFuncSetAttribute(
      rollout_closed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  rollout_closed_kernel<<<(B + M - 1) / M, 32 * A, SMEM,
                          (cudaStream_t)stream>>>(
      al, x0, xb, ub, K, d, sref, tref, xs, us, costs, B, H, A, substeps);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) at A alphas, for the build report
extern "C" int rollout_closed_occupancy(int* out, int A) {
  out[1] = 32 * A;
  out[2] = (int)SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      rollout_closed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      out[2]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], rollout_closed_kernel, out[1], out[2]);
}
