// Line search: every alpha's closed-loop rollout u = clip(ub + a d +
// K (x - xb)) with the stage and terminal costs summed in the same pass.
// One thread per (alpha, scenario).
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py
// rollout_closed (:579), fused costs included. Bound: operations (H *
// substeps generated substeps per thread); K (B, H, NU, NX) is the largest
// input. Design: the TPU kernel streamed K through VMEM chunk by chunk with
// (alpha, chunk) as sequential grid axes; here the alphas are threads, the
// knots a runtime loop, and threads a*B + b of one alpha read neighbouring
// scenarios, so the A threads of one scenario share K through the caches.
// The state and the cost accumulator live in registers. Arrays are
// batch-fastest.
#include <cuda_runtime.h>
#include "chain_substep.cuh"
#include "chain_cost.cuh"

#define NV CHAIN_NV
#define NU CHAIN_NU
#define NX (2 * CHAIN_NV)

__global__ void rollout_closed_kernel(
    const float* __restrict__ alphas,  // (A,)
    const float* __restrict__ x0,      // (NX, B)
    const float* __restrict__ xb,      // (H, NX, B)
    const float* __restrict__ ub,      // (H, NU, B)
    const float* __restrict__ K,       // (H, NU, NX, B)
    const float* __restrict__ d,       // (H, NU, B)
    const float* __restrict__ sref,    // (H, NSR, B)
    const float* __restrict__ tref,    // (NTR, B)
    float* __restrict__ xs,            // (A, H+1, NX, B)
    float* __restrict__ us,            // (A, H, NU, B)
    float* __restrict__ costs,         // (A, B)
    int B, int H, int A, int substeps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= A * B) return;
  const int a = t / B;
  const int b = t - a * B;
  const float alpha = alphas[a];
  float q[NV], v[NV], u[NU];
  float sr[CHAIN_NSR_ALLOC], tr[CHAIN_NTR_ALLOC];
#pragma unroll
  for (int i = 0; i < CHAIN_NTR; ++i) tr[i] = tref[(size_t)i * B + b];
  float* xo = xs + (size_t)a * (H + 1) * NX * B;
  float* uo = us + (size_t)a * H * NU * B;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    q[i] = x0[(size_t)i * B + b];
    v[i] = x0[(size_t)(NV + i) * B + b];
    xo[(size_t)i * B + b] = q[i];
    xo[(size_t)(NV + i) * B + b] = v[i];
  }
  float acc = 0.0f;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
    float dx[NX];
    const float* xbk = xb + (size_t)k * NX * B;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      dx[i] = q[i] - xbk[(size_t)i * B + b];
      dx[NV + i] = v[i] - xbk[(size_t)(NV + i) * B + b];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const size_t kj = (size_t)k * NU + j;
      float uacc = ub[kj * B + b] + alpha * d[kj * B + b];
      const float* Kkj = K + kj * NX * B;
#pragma unroll
      for (int i = 0; i < NX; ++i) uacc += Kkj[(size_t)i * B + b] * dx[i];
      u[j] = uacc;
    }
    chain_clip_ctrl(u);
#pragma unroll
    for (int j = 0; j < NU; ++j) uo[((size_t)k * NU + j) * B + b] = u[j];
#pragma unroll
    for (int i = 0; i < CHAIN_NSR; ++i)
      sr[i] = sref[((size_t)k * CHAIN_NSR + i) * B + b];
    acc = acc + chain_stage_cost(q, v, u, sr, tr);
#pragma unroll 1
    for (int s = 0; s < substeps; ++s) chain_substep(q, v, u);
    float* xk = xo + (size_t)(k + 1) * NX * B;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xk[(size_t)i * B + b] = q[i];
      xk[(size_t)(NV + i) * B + b] = v[i];
    }
  }
  costs[(size_t)a * B + b] = acc + chain_term_cost(q, v, tr);
}

extern "C" int rollout_closed(const float* alphas, const float* x0,
                              const float* xb, const float* ub, const float* K,
                              const float* d, const float* sref,
                              const float* tref, float* xs, float* us,
                              float* costs, int B, int H, int A, int substeps,
                              void* stream) {
  const int threads = 64;
  const int n = A * B;
  rollout_closed_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      alphas, x0, xb, ub, K, d, sref, tref, xs, us, costs, B, H, A, substeps);
  return (int)cudaGetLastError();
}
