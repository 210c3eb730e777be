// Knot Jacobians by forward differences, composed over the knot's substeps
// in the same launch: F = A^s and L = (I + A + ... + A^{s-1}) Bm from the
// one-substep Jacobians (A, Bm), or the full-knot differences themselves.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py lin_fd
// (:759) and, with it, the composition that lin_fd_fast (:921) runs outside
// the kernel. Arrays are in the public batch-first layout: xs (B, H, 16)
// with any batch stride (the solver hands over xs[:, :-1] of its
// (B, H+1, 16) states), us (B, H, 7) in; F (B, H, 16, 16) and L (B, H, 16, 7)
// out, contiguous.
//
// Bound: operations. Per (scenario, knot) instance, 24 one-substep
// evaluations of ~4.3k f32 operations (the base and one per perturbed
// input), 23 x 16 differences, and for s = 8 five 16 x 16 x 16 products and
// one 16 x 16 x 7: about 0.6 ms at B*H = 262,144 and 67 TFLOP/s, against
// 4.1e8 bytes (0.12 ms). What the design does:
//  * a block holds 4 instances x 24 threads: thread (i, p) runs input p's
//    perturbed substep of instance i (p = 23 the base), so 24 threads share
//    what one thread ran in sequence before, and the block writes the 24
//    end states to shared memory (rows padded to 17 floats: the column
//    reads that form A hit no bank twice);
//  * the block forms A (16 x 16) and Bm (16 x 7) there with the same
//    (x_p - x_base) * 1000 arithmetic, then composes by squaring:
//    S <- I + A, F <- A A, then log2(s) - 1 times S <- S + F S, F <- F F,
//    and L = S Bm. Every thread owns fixed output entries (4 adjacent ones
//    of a row in the squarings, so that a row entry read from shared
//    memory serves 8 multiply-adds), each a 16-term sum in a fixed order,
//    held in registers across the barrier that ends the round: no atomics,
//    no scratch matrix, two calls agree to the bit;
//  * the last round writes F, and the product with Bm writes L, straight
//    from registers: the block's instances are consecutive, so its
//    outputs are one contiguous run that consecutive threads store to
//    consecutive addresses. No layout copy or matrix product follows the
//    launch.
#include <cuda_runtime.h>
#include "chain_substep.cuh"

#define NV CHAIN_NV
#define NU CHAIN_NU
#define NX (2 * CHAIN_NV)

namespace {

constexpr int NIN = NX + NU;          // perturbed inputs
constexpr int NP = NIN + 1;           // threads per instance (last: the base)
constexpr int INST = 4;               // instances per block
// resident blocks asked of ptxas: 168 registers (a few bytes spilled), four
// blocks of 3 warps per SM; uncapped, the substep takes 255 and two fit
constexpr int THREADS = INST * NP;
constexpr int YROW = NX + 1;          // padded end-state row
// padded matrix row: a multiple of 4 (16-byte column reads) whose rows
// 0..7 fall on distinct banks
constexpr int MROW = NX + 4;
constexpr int NXX = NX * NX, NXU = NX * NU;
// a squaring round's work item: 4 adjacent entries of one row
constexpr int ITEMS = INST * NX * (NX / 4);
constexpr int PER = (ITEMS + THREADS - 1) / THREADS;

struct Smem {
  float in[INST][NIN];
  float y[INST][NP][YROW];
  alignas(16) float f[INST][NX * MROW];   // A, then F
  alignas(16) float s[INST][NX * MROW];
  float b[INST][NXU];
};

}  // namespace

// One squaring round over the block's instances. Thread tid owns the work
// items w = tid + j * THREADS, each the 4 entries (r, 4q..4q+3) of one
// instance's F and S: it sums each entry's 16 terms in order (the row
// entry F[r][k] read once for the 8 sums, the columns 16 bytes at a time),
// holds its new entries in registers across the barrier, then writes them
// (F of the last round straight to the output, 16 bytes per store).
template <bool FIRST>
__device__ __forceinline__ void compose_round(Smem& sm, float* Fo, int tid,
                                              int live, bool last) {
  float4 fn[PER], sn[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int w = tid + j * THREADS;
    const int i = w / (NX * NX / 4), r = (w / (NX / 4)) % NX, c = 4 * (w % 4);
    if (w >= ITEMS || i >= live) continue;
    const float* fr = sm.f[i] + r * MROW;
    float4 ff = make_float4(0.f, 0.f, 0.f, 0.f), fs = ff;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float a = fr[k];
      const float4 fk = *reinterpret_cast<const float4*>(sm.f[i] + k * MROW + c);
      ff.x += a * fk.x;
      ff.y += a * fk.y;
      ff.z += a * fk.z;
      ff.w += a * fk.w;
      if (!FIRST) {
        const float4 sk =
            *reinterpret_cast<const float4*>(sm.s[i] + k * MROW + c);
        fs.x += a * sk.x;
        fs.y += a * sk.y;
        fs.z += a * sk.z;
        fs.w += a * sk.w;
      }
    }
    fn[j] = ff;
    if (FIRST) {   // S_2 = I + A
      sn[j] = make_float4(r == c ? fr[c] + 1.0f : fr[c],
                          r == c + 1 ? fr[c + 1] + 1.0f : fr[c + 1],
                          r == c + 2 ? fr[c + 2] + 1.0f : fr[c + 2],
                          r == c + 3 ? fr[c + 3] + 1.0f : fr[c + 3]);
    } else {
      const float* sr = sm.s[i] + r * MROW + c;
      sn[j] = make_float4(sr[0] + fs.x, sr[1] + fs.y, sr[2] + fs.z,
                          sr[3] + fs.w);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int w = tid + j * THREADS;
    const int i = w / (NX * NX / 4), r = (w / (NX / 4)) % NX, c = 4 * (w % 4);
    if (w >= ITEMS || i >= live) continue;
    *reinterpret_cast<float4*>(sm.s[i] + r * MROW + c) = sn[j];
    if (last)
      reinterpret_cast<float4*>(Fo)[w] = fn[j];
    else
      *reinterpret_cast<float4*>(sm.f[i] + r * MROW + c) = fn[j];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 4)
    lin_fd_kernel(const float* __restrict__ xs, const float* __restrict__ us,
                  float* __restrict__ F, float* __restrict__ L, int N, int H,
                  long long sxb, int fd_substeps, int rounds) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * INST;
  const int live = (int)min((long long)INST, N - n0);  // ragged last block
  const float eps = 1e-3f;
  const float inv_eps = 1000.0f;

  for (int e = tid; e < live * NIN; e += THREADS) {
    const int i = e / NIN, k = e % NIN;
    const long long n = n0 + i;
    const long long b = n / H, h = n % H;
    sm.in[i][k] = k < NX ? xs[b * sxb + h * NX + k] : us[n * NU + k - NX];
  }
  __syncthreads();

  {
    const int i = tid / NP, p = tid % NP;
    if (i < live) {
      const float* x = sm.in[i];
      float q[NV], v[NV], u[NU];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        q[k] = x[k] + (p == k ? eps : 0.0f);
        v[k] = x[NV + k] + (p == NV + k ? eps : 0.0f);
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) u[j] = x[NX + j] + (p == NX + j ? eps : 0.0f);
#pragma unroll 1
      for (int s = 0; s < fd_substeps; ++s) chain_substep(q, v, u);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        sm.y[i][p][k] = q[k];
        sm.y[i][p][NV + k] = v[k];
      }
    }
  }
  __syncthreads();

  // the differenced columns: A[r][c] from input c, Bm[r][j] from input NX+j
  float* Fo = F + n0 * NXX;
  float* Lo = L + n0 * NXU;
  for (int e = tid; e < live * NXX; e += THREADS) {
    const int i = e / NXX, r = (e % NXX) / NX, c = e % NX;
    const float a = (sm.y[i][c][r] - sm.y[i][NP - 1][r]) * inv_eps;
    if (rounds == 0)
      Fo[e] = a;
    else
      sm.f[i][r * MROW + c] = a;
  }
  for (int e = tid; e < live * NXU; e += THREADS) {
    const int i = e / NXU, r = (e % NXU) / NU, j = e % NU;
    const float bm = (sm.y[i][NX + j][r] - sm.y[i][NP - 1][r]) * inv_eps;
    if (rounds == 0)
      Lo[e] = bm;
    else
      sm.b[i][r * NU + j] = bm;
  }
  if (rounds == 0) return;            // the full-knot differences: done
  __syncthreads();

  // squaring: S_2m = S_m + F_m S_m, F_2m = F_m F_m (S_1 = I, so the first
  // round is S_2 = I + A)
  compose_round<true>(sm, Fo, tid, live, rounds == 1);
  for (int round = 1; round < rounds; ++round)
    compose_round<false>(sm, Fo, tid, live, round == rounds - 1);

  for (int e = tid; e < live * NXU; e += THREADS) {
    const int i = e / NXU, r = (e % NXU) / NU, j = e % NU;
    const float* sr = sm.s[i] + r * MROW;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) acc += sr[k] * sm.b[i][k * NU + j];
    Lo[e] = acc;
  }
}

// N = B * H instances; sxb: xs's batch stride in floats; each perturbed
// knot runs fd_substeps substeps; rounds = log2(substeps) squarings compose
// one-substep Jacobians (0: F and L are the differences themselves)
extern "C" int lin_fd(const float* xs, const float* us, float* F, float* L,
                      int N, int H, long long sxb, int fd_substeps,
                      int rounds, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  lin_fd_kernel<<<(N + INST - 1) / INST, THREADS, 0,
                  (cudaStream_t)stream>>>(xs, us, F, L, N, H, sxb,
                                          fd_substeps, rounds);
  return (int)cudaGetLastError();
}

extern "C" int lin_fd_occupancy(int* out) {
  out[1] = THREADS;
  out[2] = (int)sizeof(Smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], lin_fd_kernel, THREADS, 0);
}
