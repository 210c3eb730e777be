// Open-loop rollout of the arm chain: one thread per scenario, all H knots
// of `substeps` generated substeps in one launch.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py
// rollout_open (:530). Bound: operations (about 4.3k f32 operations per
// substep, see chain_substep.cuh; the bytes moved are x0, us and xs once).
// Design: the substep is straight-line code with the plan's constants folded
// (emitted by physics/cuda_chain.py into chain_substep.cuh), called inside
// runtime loops over substeps and knots so the code stays one substep long;
// the (q, v) state lives in registers. Arrays are batch-fastest (the wrapper
// transposes from and to the public layout), so neighbouring threads load
// and store neighbouring addresses.
#include <cuda_runtime.h>
#include "chain_substep.cuh"

#define NV CHAIN_NV
#define NU CHAIN_NU
#define NX (2 * CHAIN_NV)

__global__ void rollout_open_kernel(const float* __restrict__ x0,  // (NX, B)
                                    const float* __restrict__ us,  // (H, NU, B)
                                    float* __restrict__ xs,        // (H+1, NX, B)
                                    int B, int H, int substeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float q[NV], v[NV], u[NU];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    q[i] = x0[(size_t)i * B + b];
    v[i] = x0[(size_t)(NV + i) * B + b];
    xs[(size_t)i * B + b] = q[i];
    xs[(size_t)(NV + i) * B + b] = v[i];
  }
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int j = 0; j < NU; ++j) u[j] = us[((size_t)k * NU + j) * B + b];
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) chain_substep(q, v, u);
    float* out = xs + (size_t)(k + 1) * NX * B;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      out[(size_t)i * B + b] = q[i];
      out[(size_t)(NV + i) * B + b] = v[i];
    }
  }
}

extern "C" int rollout_open(const float* x0, const float* us, float* xs, int B,
                            int H, int substeps, void* stream) {
  const int threads = 32;  // B=4096 -> 128 blocks: one warp on most SMs
  rollout_open_kernel<<<(B + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(x0, us, xs, B, H, substeps);
  return (int)cudaGetLastError();
}
