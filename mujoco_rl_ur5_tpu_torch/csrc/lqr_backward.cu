// Batched Riccati backward pass (c = 0): one thread per scenario walks the
// horizon backwards with the value function (S, s) in thread-local memory.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/mpc/pallas_lqr.py
// backward_pallas (:90). Semantics: vmap(backward_sequential) with c = 0 and
// per-scenario Levenberg-Marquardt reg, Quu + reg I factored by an unrolled
// Cholesky whose pivots clamp at 1e-12 (pallas_lqr.py _chol/_cho_solve).
// Bound: bytes (F, L, X, U read once and K, d, S, s written once: about
// 1.1 GB at B=4096, H=64, NX=16, NU=7); about 15k FMAs per step.
// Design: the TPU kernel ran the horizon as a reversed sequential grid axis
// with (S, s) carried in VMEM scratch, one scenario per vector lane; here a
// loop inside the thread takes the place of that axis. The 16x16 blocks do
// not fit in registers and spill to local memory (L1-resident), and
// B=4096 threads fill only part of the card: both are left for a later
// optimisation. Arrays are batch-fastest.
#include <cuda_runtime.h>

template <int NX, int NU>
__global__ void __launch_bounds__(32) riccati_backward_kernel(
    const float* __restrict__ F,   // (H, NX, NX, B)
    const float* __restrict__ L,   // (H, NX, NU, B)
    const float* __restrict__ X,   // (H, NX, NX, B)
    const float* __restrict__ q,   // (H, NX, B)
    const float* __restrict__ U,   // (H, NU, NU, B)
    const float* __restrict__ r,   // (H, NU, B)
    const float* __restrict__ XH,  // (NX, NX, B)
    const float* __restrict__ qH,  // (NX, B)
    const float* __restrict__ reg, // (B,)
    float* __restrict__ Ko,        // (H, NU, NX, B)
    float* __restrict__ dout,      // (H, NU, B)
    float* __restrict__ So,        // (H+1, NX, NX, B)
    float* __restrict__ so,        // (H+1, NX, B)
    int B, int H) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float S[NX * NX], s[NX];
  float Fm[NX * NX], Lm[NX * NU], T[NX * NX];
  float SL[NX * NU], Quu[NU * NU], Qux[NU * NX], Qu[NU], Qx[NX];
  float Lc[NU * NU], invd[NU], Km[NU * NX], dv[NU];
  for (int i = 0; i < NX * NX; ++i) S[i] = XH[(size_t)i * B + b];
  for (int i = 0; i < NX; ++i) s[i] = qH[(size_t)i * B + b];
  const float rg = reg[b];

  for (int k = H - 1; k >= 0; --k) {
    // the carry is the value function of step k+1
    for (int i = 0; i < NX * NX; ++i)
      So[((size_t)(k + 1) * NX * NX + i) * B + b] = S[i];
    for (int i = 0; i < NX; ++i) so[((size_t)(k + 1) * NX + i) * B + b] = s[i];
    for (int i = 0; i < NX * NX; ++i)
      Fm[i] = F[((size_t)k * NX * NX + i) * B + b];
    for (int i = 0; i < NX * NU; ++i)
      Lm[i] = L[((size_t)k * NX * NU + i) * B + b];

    // SL = S L; Qu = r + L' s; Qx = q + F' s
    for (int i = 0; i < NX; ++i)
      for (int a = 0; a < NU; ++a) {
        float acc = 0.0f;
        for (int j = 0; j < NX; ++j) acc += S[i * NX + j] * Lm[j * NU + a];
        SL[i * NU + a] = acc;
      }
    for (int a = 0; a < NU; ++a) {
      float acc = 0.0f;
      for (int i = 0; i < NX; ++i) acc += Lm[i * NU + a] * s[i];
      Qu[a] = r[((size_t)k * NU + a) * B + b] + acc;
    }
    for (int i = 0; i < NX; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < NX; ++j) acc += Fm[j * NX + i] * s[j];
      Qx[i] = q[((size_t)k * NX + i) * B + b] + acc;
    }
    // Quu = U + L' S L + reg I (upper triangle, mirrored); Qux = L' S F
    for (int a = 0; a < NU; ++a)
      for (int c = a; c < NU; ++c) {
        float acc = 0.0f;
        for (int i = 0; i < NX; ++i) acc += Lm[i * NU + a] * SL[i * NU + c];
        float val = U[((size_t)k * NU * NU + a * NU + c) * B + b] + acc;
        if (a == c) val += rg;
        Quu[a * NU + c] = val;
        Quu[c * NU + a] = val;
      }
    for (int a = 0; a < NU; ++a)
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int i = 0; i < NX; ++i) acc += SL[i * NU + a] * Fm[i * NX + j];
        Qux[a * NX + j] = acc;
      }
    // Cholesky of Quu, then K = -Quu^-1 Qux, d = -Quu^-1 Qu
    for (int j = 0; j < NU; ++j) {
      float acc = 0.0f;
      for (int m = 0; m < j; ++m) acc += Lc[j * NU + m] * Lc[j * NU + m];
      const float root = sqrtf(fmaxf(Quu[j * NU + j] - acc, 1e-12f));
      Lc[j * NU + j] = root;
      invd[j] = 1.0f / root;
      for (int i = j + 1; i < NU; ++i) {
        float off = 0.0f;
        for (int m = 0; m < j; ++m) off += Lc[i * NU + m] * Lc[j * NU + m];
        Lc[i * NU + j] = (Quu[i * NU + j] - off) * invd[j];
      }
    }
    for (int col = 0; col <= NX; ++col) {
      float y[NU], x[NU];
      for (int i = 0; i < NU; ++i) {
        float acc = 0.0f;
        for (int m = 0; m < i; ++m) acc += Lc[i * NU + m] * y[m];
        const float rhs = col < NX ? Qux[i * NX + col] : Qu[i];
        y[i] = (rhs - acc) * invd[i];
      }
      for (int i = NU - 1; i >= 0; --i) {
        float acc = 0.0f;
        for (int m = i + 1; m < NU; ++m) acc += Lc[m * NU + i] * x[m];
        x[i] = (y[i] - acc) * invd[i];
      }
      for (int a = 0; a < NU; ++a) {
        if (col < NX) Km[a * NX + col] = -x[a];
        else dv[a] = -x[a];
      }
    }
    for (int i = 0; i < NU * NX; ++i)
      Ko[((size_t)k * NU * NX + i) * B + b] = Km[i];
    for (int a = 0; a < NU; ++a) dout[((size_t)k * NU + a) * B + b] = dv[a];

    // T = S F, then S <- sym(X + F' S F + Qux' K) and
    // s <- Qx + K' Qu + (K' Quu + Qux') d
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int m = 0; m < NX; ++m) acc += S[i * NX + m] * Fm[m * NX + j];
        T[i * NX + j] = acc;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = i; j < NX; ++j) {
        float qxx = 0.0f;
        for (int m = 0; m < NX; ++m) qxx += Fm[m * NX + i] * T[m * NX + j];
        qxx = X[((size_t)k * NX * NX + i * NX + j) * B + b] + qxx;
        float gij = 0.0f, gji = 0.0f;
        for (int a = 0; a < NU; ++a) {
          gij += Qux[a * NX + i] * Km[a * NX + j];
          gji += Qux[a * NX + j] * Km[a * NX + i];
        }
        const float val = qxx + 0.5f * (gij + gji);
        S[i * NX + j] = val;
        S[j * NX + i] = val;
      }
    for (int i = 0; i < NX; ++i) {
      float kq = 0.0f, kd = 0.0f;
      for (int a = 0; a < NU; ++a) kq += Km[a * NX + i] * Qu[a];
      for (int c = 0; c < NU; ++c) {
        float kquu = 0.0f;
        for (int a = 0; a < NU; ++a) kquu += Km[a * NX + i] * Quu[a * NU + c];
        kd += (kquu + Qux[c * NX + i]) * dv[c];
      }
      s[i] = Qx[i] + kq + kd;
    }
  }
  for (int i = 0; i < NX * NX; ++i) So[(size_t)i * B + b] = S[i];
  for (int i = 0; i < NX; ++i) so[(size_t)i * B + b] = s[i];
}

extern "C" int riccati_backward(const float* F, const float* L, const float* X,
                                const float* q, const float* U, const float* r,
                                const float* XH, const float* qH,
                                const float* reg, float* K, float* d, float* S,
                                float* s, int B, int H, int nx, int nu,
                                void* stream) {
  if (nx != 16 || nu != 7) return (int)cudaErrorInvalidValue;
  const int threads = 32;  // B=4096 -> 128 blocks: one warp on most SMs
  riccati_backward_kernel<16, 7><<<(B + threads - 1) / threads, threads, 0,
                                   (cudaStream_t)stream>>>(
      F, L, X, q, U, r, XH, qH, reg, K, d, S, s, B, H);
  return (int)cudaGetLastError();
}
