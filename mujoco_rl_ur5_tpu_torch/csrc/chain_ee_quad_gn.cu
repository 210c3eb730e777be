// Gauss-Newton stage quadratization of the end-effector reach cost, written
// as the solver's full stage blocks: per (scenario, knot) instance the
// generated FK, the geometric Jacobians J and Ja at the end-effector and
//   X = [[w_ee J'J + w_orient Ja'Ja + w_posture I, 0], [0, w_vel I]]
//   g = [w_ee J'e + w_orient Ja'a + w_posture (q - home), w_vel qd]
// (NX x NX and NX, NX = 2 NV). The generated header computes the
// NV (NV + 1) / 2 distinct entries of the top-left block and g.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py
// ee_quad_gn (:885, built by _quad_gn_call :817) together with its caller's
// assembly of the stage blocks (mujoco_rl_ur5_tpu/mpc/grasp_mpc.py
// _reach_quad_batch_kernel: zeros, the block, the velocity diagonal, the
// gradient's velocity half). Bound: bytes. An instance reads its state row
// (NX floats) and its scenario's target and writes NX * NX + NX = 272
// floats against about 700 f32 operations (the UR5 arm), so the stores of
// X set the time.
//
// Design: one thread per instance, instances n = b * H + k in order, so a
// warp's 32 instances own one contiguous span of X (32 KB) and of g (2 KB).
//  * inputs where they are: each thread loads its own state row of xs
//    (B, H, NX) with NX / 4 float4 loads (any batch stride sxb that keeps
//    rows 16-byte aligned: the solver's xs[:, :-1]) and its target (B, 3);
//  * each thread stages its mirrored NV x NV block and its g row in the
//    warp's shared memory (rows padded to an odd number of float4, so a
//    warp's float4 stores hit every bank once per phase);
//  * the warp then writes its spans of X and g from first to last float4:
//    every store instruction covers 512 contiguous bytes. A float4 of X
//    takes the staged block where it lies in the top-left block, the
//    velocity weight where it holds the diagonal past NV, exact zeros
//    elsewhere: no memset and no copy before or after the launch. A
//    lane whose instance lies past N computes the last instance and
//    stores nothing (every lane reaches the warp's barrier).
// Why the block and not a row of X per round through shared memory (the
// other way, 2 KB per warp and round): only the block's 64 floats and g's 16
// carry data, the rest of X is written from constants, so one barrier per
// warp serves the whole span (44 KB of shared memory per block).
#include <cuda_runtime.h>
#include "chain_ee_quad.cuh"

#define NV CHAIN_NV
#define NX (2 * NV)
#define NXU (NV * (NV + 1) / 2)

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int QB4 = NV * NV / 4;        // float4 of the top-left block
constexpr int X4 = NX * NX / 4;         // float4 of X per instance
constexpr int G4 = NX / 4;              // float4 of g (and of a state row)
constexpr int QS4 = QB4 | 1;            // staged rows: an odd float4 count
constexpr int GS4 = G4 | 1;
static_assert(NV % 4 == 0, "rows of the top-left block are whole float4");

struct Smem {
  float4 x[WARPS][32][QS4];
  float4 g[WARPS][32][GS4];
};

}  // namespace

__global__ void __launch_bounds__(THREADS)
ee_quad_gn_kernel(const float* __restrict__ xs, long long sxb,
                  const float* __restrict__ tgt, float* __restrict__ X,
                  float* __restrict__ g, int N, int H) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long n0 = ((long)blockIdx.x * WARPS + warp) * 32;
  const long n = n0 + lane < N ? n0 + lane : (long)N - 1;
  const long b = n / H, k = n % H;
  const float4* row =
      reinterpret_cast<const float4*>(xs + b * sxb + k * NX);
  float x[NX];
#pragma unroll
  for (int c = 0; c < G4; ++c) {
    const float4 v = row[c];
    x[4 * c] = v.x;
    x[4 * c + 1] = v.y;
    x[4 * c + 2] = v.z;
    x[4 * c + 3] = v.w;
  }
  const float tg[3] = {tgt[b * 3], tgt[b * 3 + 1], tgt[b * 3 + 2]};
  float Xu[NXU], gv[NX], blk[NV * NV];
  chain_ee_quad(x, x + NV, tg, Xu, gv);
  int e = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = i; j < NV; ++j) blk[i * NV + j] = blk[j * NV + i] = Xu[e++];
  float4* sx = sm.x[warp][lane];
  float4* sg = sm.g[warp][lane];
#pragma unroll
  for (int c = 0; c < QB4; ++c)
    sx[c] = make_float4(blk[4 * c], blk[4 * c + 1], blk[4 * c + 2],
                        blk[4 * c + 3]);
#pragma unroll
  for (int c = 0; c < G4; ++c)
    sg[c] = make_float4(gv[4 * c], gv[4 * c + 1], gv[4 * c + 2],
                        gv[4 * c + 3]);
  __syncwarp();
  const long left = (long)N - n0;
  const int cnt = left < 32 ? (left > 0 ? (int)left : 0) : 32;
  float4* Xw = reinterpret_cast<float4*>(X) + n0 * X4;
  for (int f = lane; f < cnt * X4; f += 32) {
    const int i = f / X4, r = (f % X4) / G4, c = f % G4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < NV && c < NV / 4) {
      v = sm.x[warp][i][r * (NV / 4) + c];
    } else if (r >= NV && c == r / 4) {     // the velocity diagonal
      const int d = r % 4;
      v.x = d == 0 ? CHAIN_W_VEL : 0.f;
      v.y = d == 1 ? CHAIN_W_VEL : 0.f;
      v.z = d == 2 ? CHAIN_W_VEL : 0.f;
      v.w = d == 3 ? CHAIN_W_VEL : 0.f;
    }
    Xw[f] = v;
  }
  float4* gw = reinterpret_cast<float4*>(g) + n0 * G4;
  for (int f = lane; f < cnt * G4; f += 32)
    gw[f] = sm.g[warp][f / G4][f % G4];
}

// xs (B, H, NX) with batch stride sxb (floats; rows contiguous and 16-byte
// aligned), targets (B, 3), N = B * H instances -> X (B, H, NX, NX) and
// g (B, H, NX), contiguous; physics/cuda_chain.py check_quad_inputs raises
// before the call on what the kernel does not take
extern "C" int ee_quad_gn(const float* xs, long long sxb, const float* tgt,
                          float* X, float* g, int N, int H, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  ee_quad_gn_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(xs, sxb, tgt, X, g, N, H);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and shared memory per block
// (bytes), for the build report
extern "C" int ee_quad_gn_occupancy(int* out) {
  out[1] = THREADS;
  out[2] = (int)sizeof(Smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], ee_quad_gn_kernel, THREADS, 0);
}
