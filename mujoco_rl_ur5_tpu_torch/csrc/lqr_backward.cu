// Batched Riccati backward pass (c = 0): a team of 16 lanes per scenario
// walks the horizon backwards; lane i owns row i of the value Hessian.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/mpc/pallas_lqr.py
// backward_pallas (:90). Semantics: vmap(backward_sequential) with c = 0 and
// per-scenario Levenberg-Marquardt reg, Quu + reg I factored by an unrolled
// Cholesky whose pivots clamp at 1e-12 (pallas_lqr.py _chol/_cho_solve).
// Arrays are in the public batch-first layout, contiguous: F (B,H,16,16),
// L (B,H,16,7), X (B,H,16,16), q (B,H,16), U (B,H,7,7), r (B,H,7),
// XH (B,16,16), qH (B,16), reg (B,) in; K (B,H,7,16), d (B,H,7),
// S (B,H+1,16,16), s (B,H+1,16) out.
//
// Bound: bytes. F, L, X, U, q, r read once and K, d, S, s written once are
// 1.149e9 B at B=4096, H=64 (X and U at full size), 0.343 ms at 3.35 TB/s;
// the arithmetic, about 15k multiply-adds per knot, is 0.12 ms at the
// card's float32 rate. Design, against that bound:
//  * one scenario's knot is a contiguous kilobyte per 16x16 block, so its
//    team reads F, L and q with 16-byte asynchronous copies (cp.async) into
//    shared memory, and X row by row straight into the registers of the
//    lane that owns the row; U and r (196 and 28 bytes per knot, not
//    16-byte aligned) go by 4-byte copies. Knot k-1's copies are in flight
//    while knot k computes (two stages per scenario);
//  * S_{k+1}, K_k and the other outputs leave as contiguous rows: lane i
//    stores row i of S with 16-byte stores, and the 16 lanes store one row
//    of K together;
//  * 16 lanes per scenario make B=4096 scenarios 2,048 warps, 16 on every
//    SM at once (4 blocks of 8 scenarios, 45.8 KB of shared memory each),
//    enough to keep the copies and the dependent multiply-adds overlapped.
//    A lane holds only rows and columns (16 or 7 floats each), so nothing
//    spills;
//  * the team synchronises with __syncwarp only: scenarios are independent
//    and no block-wide barrier is needed. Every sum runs in a fixed order
//    and nothing is added atomically, so two calls agree to the bit.
// Tensor cores are not used: Hopper has no float32 wgmma, and TF32 would
// take the recursion outside the port's float32 parity checks.
#include <cuda_runtime.h>
#include <cuda_pipeline.h>

namespace {

constexpr int NX = 16, NU = 7;
constexpr int TEAM = 16;        // lanes per scenario; lane i owns row i
constexpr int PER_BLOCK = 8;    // scenarios per block: 4 warps
constexpr int THREADS = TEAM * PER_BLOCK;

// one knot's inputs in shared memory (floats): F | L | q | U | r
constexpr int ST_F = 0, ST_L = 256, ST_Q = 368, ST_U = 384, ST_R = 433;
constexpr int STAGE = 440;      // 16-byte multiple
// working blocks: SLs = [S L | s] (16 x 8), T = S F then M (16 x 16),
// Quu (7 x 7), Qu (7), K (7 x 16)
constexpr int W_SL = 0, W_T = 128, W_QUU = 384, W_QU = 433, W_K = 440;
constexpr int WORK = 552;
constexpr int PER_SCEN = 2 * STAGE + WORK;   // 1432 floats, 5,728 bytes
constexpr int SMEM = PER_BLOCK * PER_SCEN * 4;

// start the copies of one knot's F, L, q (16-byte) and U, r (4-byte)
__device__ __forceinline__ void load_knot(float* st, const float* F,
                                          const float* L, const float* q,
                                          const float* U, const float* r,
                                          size_t bk, int lane) {
  const float4* F4 = reinterpret_cast<const float4*>(F + bk * NX * NX);
  const float4* L4 = reinterpret_cast<const float4*>(L + bk * NX * NU);
  const float4* q4 = reinterpret_cast<const float4*>(q + bk * NX);
  float4* s4 = reinterpret_cast<float4*>(st);
  for (int c = lane; c < 96; c += TEAM) {
    const float4* src = c < 64 ? F4 + c : (c < 92 ? L4 + (c - 64) : q4 + (c - 92));
    __pipeline_memcpy_async(s4 + c, src, 16);
  }
  const float* Uk = U + bk * NU * NU;
  const float* rk = r + bk * NU;
  for (int c = lane; c < NU * NU + NU; c += TEAM) {
    const float* src = c < NU * NU ? Uk + c : rk + (c - NU * NU);
    __pipeline_memcpy_async(st + ST_U + c, src, 4);
  }
}

__device__ __forceinline__ void row_load(float* dst, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = s4[c];
    dst[4 * c] = v.x; dst[4 * c + 1] = v.y;
    dst[4 * c + 2] = v.z; dst[4 * c + 3] = v.w;
  }
}

__device__ __forceinline__ void row_store(float* dst, const float* src) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    d4[c] = make_float4(src[4 * c], src[4 * c + 1], src[4 * c + 2],
                        src[4 * c + 3]);
}

}  // namespace

__global__ void __launch_bounds__(THREADS, 4) riccati_backward_kernel(
    const float* __restrict__ F, const float* __restrict__ L,
    const float* __restrict__ X, const float* __restrict__ q,
    const float* __restrict__ U, const float* __restrict__ r,
    const float* __restrict__ XH, const float* __restrict__ qH,
    const float* __restrict__ reg, float* __restrict__ Ko,
    float* __restrict__ dout, float* __restrict__ So,
    float* __restrict__ so, int B, int H) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % TEAM;
  const int team = threadIdx.x / TEAM;
  const int b_raw = blockIdx.x * PER_BLOCK + team;
  const bool live = b_raw < B;
  const int b = live ? b_raw : B - 1;   // a ragged edge recomputes the last
  float* base = reinterpret_cast<float*>(smem4) + team * PER_SCEN;
  float* W = base + 2 * STAGE;
  const size_t bH = (size_t)b * H;

  float Sr[NX];                  // row `lane` of S_{k+1}
  row_load(Sr, XH + ((size_t)b * NX + lane) * NX);
  float si = qH[(size_t)b * NX + lane];
  const float rg = reg[b];

  load_knot(base + ((H - 1) & 1) * STAGE, F, L, q, U, r, bH + H - 1, lane);
  __pipeline_commit();
  if (H >= 2)
    load_knot(base + ((H - 2) & 1) * STAGE, F, L, q, U, r, bH + H - 2, lane);
  __pipeline_commit();

  for (int k = H - 1; k >= 0; --k) {
    float* st = base + (k & 1) * STAGE;
    const float* Fs = st + ST_F;
    const float* Ls = st + ST_L;
    float Xr[NX];                // row `lane` of X_k, used in phase d
    row_load(Xr, X + ((bH + k) * NX + lane) * NX);
    __pipeline_wait_prior(1);
    __syncwarp();

    // a. the carry is the value function of knot k+1: store it; then
    //    SLs row i = [S L | s]_i and T row i = (S F)_i
    if (live) {
      row_store(So + ((bH + b + k + 1) * NX + lane) * NX, Sr);
      so[(bH + b + k + 1) * NX + lane] = si;
    }
    {
      float sl[NU + 1];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) acc += Sr[j] * Ls[j * NU + a];
        sl[a] = acc;
      }
      sl[NU] = si;
      float4* d4 = reinterpret_cast<float4*>(W + W_SL + lane * 8);
      d4[0] = make_float4(sl[0], sl[1], sl[2], sl[3]);
      d4[1] = make_float4(sl[4], sl[5], sl[6], sl[7]);
      float t[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) t[j] = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        float fr[NX];
        row_load(fr, Fs + m * NX);
#pragma unroll
        for (int j = 0; j < NX; ++j) t[j] += Sr[m] * fr[j];
      }
      row_store(W + W_T + lane * NX, t);
    }
    __syncwarp();

    // b. lane j: column j of Qux = (S L)' F and Qx_j = q_j + (F' s)_j;
    //    the 35 entries (a, c >= a) of [L'S L | L's]: Quu and Qu
    float Qux[NU], Qxj;
    {
      float acc[NU + 1];
#pragma unroll
      for (int a = 0; a <= NU; ++a) acc[a] = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float f = Fs[i * NX + lane];
        const float4* r4 = reinterpret_cast<const float4*>(W + W_SL + i * 8);
        const float4 lo = r4[0], hi = r4[1];
        acc[0] += lo.x * f; acc[1] += lo.y * f; acc[2] += lo.z * f;
        acc[3] += lo.w * f; acc[4] += hi.x * f; acc[5] += hi.y * f;
        acc[6] += hi.z * f; acc[7] += hi.w * f;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) Qux[a] = acc[a];
      Qxj = st[ST_Q + lane] + acc[NU];
    }
    for (int e = lane; e < 35; e += TEAM) {
      int a = 0, c = e;
      while (c >= NU + 1 - a) { c -= NU + 1 - a; ++a; }
      c += a;                    // pair (a, c), a <= c <= NU
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) acc += Ls[i * NU + a] * W[W_SL + i * 8 + c];
      if (c < NU) {
        float val = st[ST_U + a * NU + c] + acc;
        if (a == c) val += rg;
        W[W_QUU + a * NU + c] = val;
        W[W_QUU + c * NU + a] = val;
      } else {
        W[W_QU + a] = st[ST_R + a] + acc;
      }
    }
    __syncwarp();

    // c. every lane factors Quu; lane j solves column j of K, every lane d
    float Lc[NU][NU], invd[NU], Kc[NU], dv[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < j; ++m) acc += Lc[j][m] * Lc[j][m];
      const float root = sqrtf(fmaxf(W[W_QUU + j * NU + j] - acc, 1e-12f));
      Lc[j][j] = root;
      invd[j] = 1.0f / root;
#pragma unroll
      for (int i = j + 1; i < NU; ++i) {
        float off = 0.0f;
#pragma unroll
        for (int m = 0; m < j; ++m) off += Lc[i][m] * Lc[j][m];
        Lc[i][j] = (W[W_QUU + i * NU + j] - off) * invd[j];
      }
    }
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      float y[NU], x[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < i; ++m) acc += Lc[i][m] * y[m];
        const float rhs = col == 0 ? Qux[i] : W[W_QU + i];
        y[i] = (rhs - acc) * invd[i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        float acc = 0.0f;
#pragma unroll
        for (int m = i + 1; m < NU; ++m) acc += Lc[m][i] * x[m];
        x[i] = (y[i] - acc) * invd[i];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        if (col == 0) Kc[a] = -x[a];
        else dv[a] = -x[a];
      }
    }
    float* Kk = Ko + (bH + k) * NU * NX;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      W[W_K + a * NX + lane] = Kc[a];
      if (live) Kk[a * NX + lane] = Kc[a];
    }
    if (live && lane < NU) {
      float dl = 0.0f;
#pragma unroll
      for (int a = 0; a < NU; ++a) dl = a == lane ? dv[a] : dl;
      dout[(bH + k) * NU + lane] = dl;
    }
    __syncwarp();

    // d. lane i: row i of M = X + F'S F + Qux'K, and s_i <- Qx_i + (K'Qu)_i
    //    + ((K'Quu + Qux') d)_i
    float Mr[NX];
    {
      float fc[NX];
#pragma unroll
      for (int m = 0; m < NX; ++m) fc[m] = Fs[m * NX + lane];
#pragma unroll
      for (int j = 0; j < NX; ++j) Mr[j] = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        float tr[NX];
        row_load(tr, W + W_T + m * NX);
#pragma unroll
        for (int j = 0; j < NX; ++j) Mr[j] += fc[m] * tr[j];
      }
      float g[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) g[j] = 0.0f;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float kr[NX];
        row_load(kr, W + W_K + a * NX);
#pragma unroll
        for (int j = 0; j < NX; ++j) g[j] += Qux[a] * kr[j];
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) Mr[j] = (Xr[j] + Mr[j]) + g[j];
      float kq = 0.0f, kd = 0.0f;
#pragma unroll
      for (int a = 0; a < NU; ++a) kq += Kc[a] * W[W_QU + a];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float kquu = 0.0f;
#pragma unroll
        for (int a = 0; a < NU; ++a) kquu += Kc[a] * W[W_QUU + a * NU + c];
        kd += (kquu + Qux[c]) * dv[c];
      }
      si = Qxj + kq + kd;
    }
    __syncwarp();                // every lane has read T
    row_store(W + W_T + lane * NX, Mr);
    __syncwarp();

    // e. S <- (M + M') / 2, then refill this stage with knot k-2
#pragma unroll
    for (int j = 0; j < NX; ++j) Sr[j] = 0.5f * (Mr[j] + W[W_T + j * NX + lane]);
    __syncwarp();
    if (k >= 2) load_knot(st, F, L, q, U, r, bH + k - 2, lane);
    __pipeline_commit();
  }
  if (live) {
    row_store(So + ((bH + b) * NX + lane) * NX, Sr);
    so[(bH + b) * NX + lane] = si;
  }
}

extern "C" int riccati_backward(const float* F, const float* L, const float* X,
                                const float* q, const float* U, const float* r,
                                const float* XH, const float* qH,
                                const float* reg, float* K, float* d, float* S,
                                float* s, int B, int H, int nx, int nu,
                                void* stream) {
  if (nx != NX || nu != NU || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  riccati_backward_kernel<<<(B + PER_BLOCK - 1) / PER_BLOCK, THREADS, SMEM,
                            (cudaStream_t)stream>>>(
      F, L, X, q, U, r, XH, qH, reg, K, d, S, s, B, H);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes), for the build report
extern "C" int riccati_backward_occupancy(int* out) {
  out[1] = THREADS;
  out[2] = SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], riccati_backward_kernel, THREADS, SMEM);
}
