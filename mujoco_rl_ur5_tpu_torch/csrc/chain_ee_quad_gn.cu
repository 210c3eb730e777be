// Gauss-Newton stage quadratization of the end-effector reach cost: one
// thread per (scenario, knot) instance runs the generated FK, forms the
// geometric Jacobians J and Ja and writes
//   Xq = w_ee J'J + w_orient Ja'Ja + w_posture I        (NV x NV)
//   gq = w_ee J'e + w_orient Ja'a + w_posture (q - home)
// The generated header computes the NV (NV + 1) / 2 distinct entries of Xq
// once; this kernel mirrors them into the full block.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py
// ee_quad_gn (:885, built by _quad_gn_call :817). Bound: bytes. An instance
// reads its NV joint angles (the velocity half of the state is not read)
// and its scenario's target and writes NV * NV + NV = 72 floats against
// about 700 f32 operations (the UR5 arm), so the stores set the time.
// Design: the TPU kernel ran a sequential (tile,) grid whose steps each
// handled an (8, 128) lane tile of 1024 instances packed by a transposing
// copy; here the N = B * H instances are independent threads. Arrays are
// batch-fastest (entry, N), so the 32 threads of a warp load neighbouring
// angles and each of their 72 stores is one coalesced 128-byte line.
// Instances are ordered n = b * H + k; the target of scenario b = n / H is
// read per thread (a warp touches at most two scenarios when H >= 32), so
// the targets are never expanded to N rows.
#include <cuda_runtime.h>
#include "chain_ee_quad.cuh"

#define NV CHAIN_NV
#define NXU (NV * (NV + 1) / 2)

__global__ void ee_quad_gn_kernel(const float* __restrict__ qs,   // (NV, N)
                                  const float* __restrict__ tgt,  // (3, B)
                                  float* __restrict__ Xq,  // (NV, NV, N)
                                  float* __restrict__ gq,  // (NV, N)
                                  int N, int H) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int B = N / H;
  const int b = n / H;
  float q[NV], tg[3], Xu[NXU], g[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) q[i] = qs[(size_t)i * N + n];
#pragma unroll
  for (int i = 0; i < 3; ++i) tg[i] = tgt[(size_t)i * B + b];
  chain_ee_quad(q, tg, Xu, g);
  int e = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = i; j < NV; ++j) {
      const float x = Xu[e++];
      Xq[((size_t)i * NV + j) * N + n] = x;
      if (j != i) Xq[((size_t)j * NV + i) * N + n] = x;
    }
    gq[(size_t)i * N + n] = g[i];
  }
}

extern "C" int ee_quad_gn(const float* qs, const float* tgt, float* Xq,
                          float* gq, int N, int H, void* stream) {
  const int threads = 128;
  ee_quad_gn_kernel<<<(N + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(qs, tgt, Xq, gq, N, H);
  return (int)cudaGetLastError();
}
