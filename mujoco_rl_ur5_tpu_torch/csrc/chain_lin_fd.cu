// Forward-difference knot Jacobians: one thread per (scenario, knot)
// instance runs the base knot and the NX+NU perturbed knots and writes the
// differenced columns of F and L directly.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py lin_fd
// (:759), reached through lin_fd_fast (:921) at substeps=1. Bound:
// operations ((NX+NU+1) substep evaluations of about 4.3k f32 operations per
// instance). Design: the TPU kernel wrote all 24 perturbed end states, a
// (B*H, 24, 16) intermediate (403 MB at B=4096, H=64) differenced outside;
// here each thread keeps the base state in registers and forms F and L
// itself, so only F and L reach device memory. Arrays are batch-fastest.
#include <cuda_runtime.h>
#include "chain_substep.cuh"

#define NV CHAIN_NV
#define NU CHAIN_NU
#define NX (2 * CHAIN_NV)

__global__ void lin_fd_kernel(const float* __restrict__ xs,  // (NX, N)
                              const float* __restrict__ us,  // (NU, N)
                              float* __restrict__ F,         // (NX, NX, N)
                              float* __restrict__ L,         // (NX, NU, N)
                              int N, int substeps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float eps = 1e-3f;
  const float inv_eps = 1000.0f;
  float x[NX], u0[NU], base[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[(size_t)i * N + n];
#pragma unroll
  for (int j = 0; j < NU; ++j) u0[j] = us[(size_t)j * N + n];
  // p = -1 is the unperturbed base; p >= 0 perturbs input p. One loop keeps
  // a single inlined copy of the substep in the kernel.
#pragma unroll 1
  for (int p = -1; p < NX + NU; ++p) {
    float q[NV], v[NV], u[NU];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      q[i] = x[i] + (p == i ? eps : 0.0f);
      v[i] = x[NV + i] + (p == NV + i ? eps : 0.0f);
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) u[j] = u0[j] + (p == NX + j ? eps : 0.0f);
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) chain_substep(q, v, u);
    if (p < 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) { base[i] = q[i]; base[NV + i] = v[i]; }
      continue;
    }
    float* col = p < NX ? F + (size_t)p * N : L + (size_t)(p - NX) * N;
    const size_t row = p < NX ? (size_t)NX * N : (size_t)NU * N;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      col[i * row + n] = (q[i] - base[i]) * inv_eps;
      col[(NV + i) * row + n] = (v[i] - base[NV + i]) * inv_eps;
    }
  }
}

extern "C" int lin_fd(const float* xs, const float* us, float* F, float* L,
                      int N, int substeps, void* stream) {
  const int threads = 128;
  lin_fd_kernel<<<(N + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>(xs, us, F, L, N, substeps);
  return (int)cudaGetLastError();
}
