// Open-loop rollout of a hinge chain (the arm: nv = 8, nu = 7): x0 (B, 2 nv)
// and us (B, H, nu) in, xs (B, H+1, 2 nv) out, all H knots of `substeps`
// substeps in one launch.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_chain.py
// rollout_open (:530). Bound: operations (about 4.3k f32 operations per
// substep, see chain_substep.cuh; the bytes moved are x0, us and xs once),
// and latency: the H x substeps substeps of a scenario run in sequence, so
// a scenario's time is at least their chain of dependent operations.
//
// The arrays are in the public batch-first layout, read and written as the
// caller holds them (physics/cuda_chain.py check_open_inputs: contiguous
// float32): no transposes around the launch.
//
// A team of OPEN_TEAM = 8 lanes of one warp shares a scenario, lane l owning
// the dofs (roles) l, l + 8, ...: the plan recast so each role is one body
// (chain_team.cuh: bodies without a joint merged into their parents; a plan
// whose dof count is no multiple of 8 padded with inert roles that move
// nothing, read and write no state and leave the real roles' bits alone).
// Each lane forms its roles' joint transforms, then world poses by pointer
// jumping over the role tree, their motion axes and spatial inertias; the
// subtree inertias, mass-matrix rows, body velocities and accelerations,
// and the subtree forces of the bias are masked sums over the roles, read
// from the team's rows in shared memory (a 128-bit load carries 4 values
// where a shuffle carries 1) between __syncwarp()s; lanes own the rows of
// the Jacobi-scaled Cholesky factor, and the pivots, rows and substitutions
// pass by __shfl_sync; each lane integrates its own dofs. No named
// barriers, no atomics. The team recomputes no constant folding of the
// one-thread substep (chain_substep.cuh, which lin_fd and rollout_closed
// run), so it runs more operations per substep in all, spread over 8 lanes;
// at B=4096 that is 1,024 warps for the card's 528 schedulers where one
// thread per scenario gave 128.
#include <cuda_runtime.h>

#include "chain_team.cuh"

namespace {

constexpr int T = 8;                       // OPEN_TEAM: lanes per scenario
constexpr int NR = TEAM_NR;                // roles: one dof and its body
constexpr int NV = TEAM_NV;                // the real ones, first
constexpr int NU = TEAM_NU;
constexpr int NX = 2 * NV;
constexpr int S = NR / T;                  // roles per lane
constexpr int TPB = 16;                    // scenarios per block
constexpr int THREADS = TPB * T;
static_assert(32 % T == 0 && NR % T == 0 && NV <= NR, "a team within a warp");
// a role's row in the team's exchange area (floats; 16-byte fields)
constexpr int EX_X = 0;                    // world rotation 9, position 3
constexpr int EX_CD = 12;                  // motion axis (cdof) 6
constexpr int EX_CIN = 20;                 // spatial inertia 10
constexpr int EX_FM = 32;                  // subtree inertia x axis 6
constexpr int EX_VC = 40;                  // v x axis 6
constexpr int EX_AC = 48;                  // velocity-product acceleration 6
constexpr int EX_FB = 56;                  // body bias force 6
constexpr int EX_S = 64;                   // Jacobi scale 1
constexpr int EX_L = 65;                   // Cholesky row NR
constexpr int EXW = (EX_L + NR + 3) / 4 * 4;
constexpr int TEAM_FLOATS = NR * EXW + 4;  // + 4: teams start on other banks
constexpr size_t SMEM = (size_t)TPB * TEAM_FLOATS * sizeof(float);

__device__ __forceinline__ float c_(int r, int k) { return TEAM_C[r][k]; }

__device__ __forceinline__ unsigned team_mask() {
  const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(T - 1);
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u) << first;
}

// 6 or 10 values of role k's row from the exchange area
template <int N>
__device__ __forceinline__ void row_get(const float* ex, int k, int f,
                                        float* o) {
  const float4* p = reinterpret_cast<const float4*>(ex + k * EXW + f);
#pragma unroll
  for (int i = 0; i < (N + 3) / 4; ++i) {
    const float4 w = p[i];
    const float e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * i + c < N) o[4 * i + c] = e[c];
  }
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// 10-parameter spatial inertia times a motion 6-vector (cuda_chain imul)
__device__ __forceinline__ void imul(const float* in, const float* v6,
                                     float* o) {
  const float m = in[0], h[3] = {in[1], in[2], in[3]};
  const float ixx = in[4], iyy = in[5], izz = in[6], ixy = in[7],
              ixz = in[8], iyz = in[9];
  const float* w = v6;
  const float* vl = v6 + 3;
  float hv[3], hw[3];
  cross3(h, vl, hv);
  cross3(h, w, hw);
  o[0] = (ixx * w[0] + ixy * w[1] + ixz * w[2]) + hv[0];
  o[1] = (ixy * w[0] + iyy * w[1] + iyz * w[2]) + hv[1];
  o[2] = (ixz * w[0] + iyz * w[1] + izz * w[2]) + hv[2];
  o[3] = m * vl[0] - hw[0];
  o[4] = m * vl[1] - hw[1];
  o[5] = m * vl[2] - hw[2];
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] + a[4] * b[4] +
         a[5] * b[5];
}

// one substep of the team's scenario: the lane's roles' q, v in, out, and
// their actuators' controls u (0 for a role without one)
__device__ __forceinline__ void team_substep(float* ex, int lane,
                                             const float (&u)[S],
                                             float (&q)[S], float (&v)[S]) {
  const unsigned m = team_mask();
  float R[S][9], p[S][3];
  // joint transforms in the parent role's frame (the world for a root)
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float sn, cs;
    sincosf(q[s] - c_(r, TC_JREF), &sn, &cs);
    float rj[9];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      rj[e] = c_(r, TC_AA + e) + cs * c_(r, TC_IMAA + e) +
              sn * c_(r, TC_KX + e);
    float t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      t[a] = c_(r, TC_JPOS + a) -
             (rj[3 * a] * c_(r, TC_JPOS) + rj[3 * a + 1] * c_(r, TC_JPOS + 1) +
              rj[3 * a + 2] * c_(r, TC_JPOS + 2));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        R[s][3 * a + b] = c_(r, TC_BROT + 3 * a) * rj[b] +
                          c_(r, TC_BROT + 3 * a + 1) * rj[3 + b] +
                          c_(r, TC_BROT + 3 * a + 2) * rj[6 + b];
      p[s][a] = c_(r, TC_BPOS + a) +
                (c_(r, TC_BROT + 3 * a) * t[0] +
                 c_(r, TC_BROT + 3 * a + 1) * t[1] +
                 c_(r, TC_BROT + 3 * a + 2) * t[2]);
    }
  }
  // world poses: X_r <- X_anc o X_r over the 2^k-th ancestors
#pragma unroll
  for (int k = 0; k < TEAM_ROUNDS; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float* row = ex + (lane + s * T) * EXW + EX_X;
#pragma unroll
      for (int e = 0; e < 9; ++e) row[e] = R[s][e];
#pragma unroll
      for (int e = 0; e < 3; ++e) row[9 + e] = p[s][e];
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int a = TEAM_JUMP[k][lane + s * T];
      if (a >= 0) {
        float X[12];
        const float4* xa = reinterpret_cast<const float4*>(ex + a * EXW);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 w = xa[i];
          X[4 * i] = w.x; X[4 * i + 1] = w.y; X[4 * i + 2] = w.z;
          X[4 * i + 3] = w.w;
        }
        float R2[9], p2[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            R2[3 * i + j] = X[3 * i] * R[s][j] + X[3 * i + 1] * R[s][3 + j] +
                            X[3 * i + 2] * R[s][6 + j];
          p2[i] = X[9 + i] + (X[3 * i] * p[s][0] + X[3 * i + 1] * p[s][1] +
                              X[3 * i + 2] * p[s][2]);
        }
#pragma unroll
        for (int e = 0; e < 9; ++e) R[s][e] = R2[e];
#pragma unroll
        for (int e = 0; e < 3; ++e) p[s][e] = p2[e];
      }
    }
    __syncwarp();
  }
  // motion axes and spatial inertias about the origin
  float cd[S][6], cin[S][10];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float anc[3], ax[3], dd[3], cv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      anc[a] = p[s][a] + (R[s][3 * a] * c_(r, TC_JPOS) +
                          R[s][3 * a + 1] * c_(r, TC_JPOS + 1) +
                          R[s][3 * a + 2] * c_(r, TC_JPOS + 2));
      ax[a] = R[s][3 * a] * c_(r, TC_AXIS) +
              R[s][3 * a + 1] * c_(r, TC_AXIS + 1) +
              R[s][3 * a + 2] * c_(r, TC_AXIS + 2);
      dd[a] = anc[a] - TEAM_ORG[a];
      cv[a] = p[s][a] + (R[s][3 * a] * c_(r, TC_IPOS) +
                         R[s][3 * a + 1] * c_(r, TC_IPOS + 1) +
                         R[s][3 * a + 2] * c_(r, TC_IPOS + 2)) - TEAM_ORG[a];
      cd[s][a] = ax[a];
    }
    cross3(dd, ax, cd[s] + 3);
    const float I[9] = {c_(r, TC_ILOC), c_(r, TC_ILOC + 3), c_(r, TC_ILOC + 4),
                        c_(r, TC_ILOC + 3), c_(r, TC_ILOC + 1),
                        c_(r, TC_ILOC + 5), c_(r, TC_ILOC + 4),
                        c_(r, TC_ILOC + 5), c_(r, TC_ILOC + 2)};
    float RI[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        RI[3 * a + b] = R[s][3 * a] * I[b] + R[s][3 * a + 1] * I[3 + b] +
                        R[s][3 * a + 2] * I[6 + b];
    const int ia[6] = {0, 1, 2, 0, 0, 1}, ib[6] = {0, 1, 2, 1, 2, 2};
    const float ms = c_(r, TC_MASS);
    const float c2 = cv[0] * cv[0] + cv[1] * cv[1] + cv[2] * cv[2];
    cin[s][0] = ms;
#pragma unroll
    for (int a = 0; a < 3; ++a) cin[s][1 + a] = ms * cv[a];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int a = ia[e], b = ib[e];
      const float ic = RI[3 * a] * R[s][3 * b] +
                       RI[3 * a + 1] * R[s][3 * b + 1] +
                       RI[3 * a + 2] * R[s][3 * b + 2];
      cin[s][4 + e] = ic + ms * ((a == b ? c2 : 0.f) - cv[a] * cv[b]);
    }
    float* row = ex + r * EXW;
#pragma unroll
    for (int e = 0; e < 6; ++e) row[EX_CD + e] = cd[s][e];
#pragma unroll
    for (int e = 0; e < 10; ++e) row[EX_CIN + e] = cin[s][e];
  }
  __syncwarp();
  // mass-matrix rows: the subtree inertia times the axis, against every
  // role's axis (ancestors) or every descendant's product with this axis
  float A[S][NR];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float crb[10];
#pragma unroll
    for (int e = 0; e < 10; ++e) crb[e] = 0.f;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      float o[10];
      row_get<10>(ex, k, EX_CIN, o);
      const float w = c_(r, TC_WSUB + k);
#pragma unroll
      for (int e = 0; e < 10; ++e) crb[e] += w * o[e];
    }
    float fm[6];
    imul(crb, cd[s], fm);
    float* row = ex + r * EXW + EX_FM;
#pragma unroll
    for (int e = 0; e < 6; ++e) row[e] = fm[e];
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float fm[6];
    row_get<6>(ex, r, EX_FM, fm);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      float cj[6], fj[6];
      row_get<6>(ex, j, EX_CD, cj);
      row_get<6>(ex, j, EX_FM, fj);
      const float a1 = dot6(fm, cj), a2 = dot6(fj, cd[s]);
      A[s][j] = c_(r, TC_WM + j) * (j <= r ? a1 : a2);
      if (j == r) A[s][j] = A[s][j] + c_(r, TC_ADIAG);
    }
  }
  // bias forces (RNE at qacc = 0): body velocities and velocity-product
  // accelerations down the tree, forces up it
  float vb[S][6], vc[S][6];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float* row = ex + r * EXW + EX_VC;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      vc[s][e] = v[s] * cd[s][e];
      row[e] = vc[s][e];
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
#pragma unroll
    for (int e = 0; e < 6; ++e) vb[s][e] = 0.f;
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      float o[6];
      row_get<6>(ex, k, EX_VC, o);
      const float w = c_(r, TC_WANC + k);
#pragma unroll
      for (int e = 0; e < 6; ++e) vb[s][e] += w * o[e];
    }
    float pv[6], c1[3], c2[3], c3[3], ac[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) pv[e] = vb[s][e] - vc[s][e];
    cross3(pv, cd[s], c1);
    cross3(pv, cd[s] + 3, c2);
    cross3(pv + 3, cd[s], c3);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ac[a] = v[s] * c1[a];
      ac[3 + a] = v[s] * (c2[a] + c3[a]);
    }
    float* row = ex + r * EXW + EX_AC;
#pragma unroll
    for (int e = 0; e < 6; ++e) row[e] = ac[e];
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float acc[6] = {0.f, 0.f, 0.f, TEAM_A0[0], TEAM_A0[1], TEAM_A0[2]};
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      float o[6];
      row_get<6>(ex, k, EX_AC, o);
      const float w = c_(r, TC_WANC + k);
#pragma unroll
      for (int e = 0; e < 6; ++e) acc[e] += w * o[e];
    }
    float iv[6], f6[6], x1[3], x2[3], x3[3];
    imul(cin[s], vb[s], iv);
    imul(cin[s], acc, f6);
    cross3(vb[s], iv, x1);
    cross3(vb[s] + 3, iv + 3, x2);
    cross3(vb[s], iv + 3, x3);
    float* row = ex + r * EXW + EX_FB;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      row[a] = f6[a] + (x1[a] + x2[a]);
      row[3 + a] = f6[3 + a] + x3[a];
    }
  }
  __syncwarp();
  float qf[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float fs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      float o[6];
      row_get<6>(ex, k, EX_FB, o);
      const float w = c_(r, TC_WSUB + k);
#pragma unroll
      for (int e = 0; e < 6; ++e) fs[e] += w * o[e];
    }
    const float tau =
        c_(r, TC_GEAR) * fminf(fmaxf(u[s], c_(r, TC_LO)), c_(r, TC_HI));
    qf[s] = tau - (dot6(cd[s], fs) + c_(r, TC_DAMP) * v[s]);
  }
  // equality springs (the finger coupling): every lane forms the spring,
  // its two dofs' lanes add it to their rows
#define TEAM_EQ(e)                                                            \
  {                                                                           \
    const int d1 = TEAM_EQ##e##_D1, d2 = TEAM_EQ##e##_D2;                     \
    const float* cf = TEAM_EQ##e##_F;                                         \
    const float q1 = __shfl_sync(m, q[d1 / T], d1 % T, T);                    \
    const float q2 = __shfl_sync(m, q[d2 / T], d2 % T, T);                    \
    const float v1 = __shfl_sync(m, v[d1 / T], d1 % T, T);                    \
    const float v2 = __shfl_sync(m, v[d2 / T], d2 % T, T);                    \
    const float x = q2 - cf[6], xx = x * x;                                   \
    const float poly = cf[0] + cf[1] * x + cf[2] * xx + cf[3] * (x * xx) +  \
                       cf[4] * (xx * xx);                                     \
    const float dp = cf[1] + 2.f * cf[2] * x + 3.f * cf[3] * xx +             \
                     4.f * cf[4] * (x * xx);                                  \
    const float rr = (q1 - cf[5]) - poly, rd = v1 - dp * v2;                  \
    const float fq = -(cf[7] * rr + cf[8] * rd);                              \
    const float w = cf[9], off = -(w * dp);                                   \
    _Pragma("unroll") for (int s = 0; s < S; ++s) {                           \
      const int r = lane + s * T;                                             \
      if (r == d1) {                                                          \
        qf[s] += fq;                                                          \
        A[s][d1] += w;                                                        \
        A[s][d2] += off;                                                      \
      }                                                                       \
      if (r == d2) {                                                          \
        qf[s] += -(dp * fq);                                                  \
        A[s][d2] += w * (dp * dp);                                            \
        A[s][d1] += off;                                                      \
      }                                                                       \
    }                                                                         \
  }
  TEAM_EQ_EACH(TEAM_EQ)
#undef TEAM_EQ
  // Jacobi-equilibrated Cholesky solve, lane r owning row r
  float sc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    float dg = 0.f;
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if (j == r) dg = A[s][j];
    sc[s] = rsqrtf(fmaxf(dg, 1e-30f));
    ex[r * EXW + EX_S] = sc[s];
  }
  __syncwarp();
  float L[S][NR], bs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      A[s][j] = c_(r, TC_WS + j) != 0.f
                    ? (A[s][j] * sc[s]) * ex[j * EXW + EX_S] : 0.f;
      L[s][j] = 0.f;
    }
    bs[s] = qf[s] * sc[s];
  }
  float linv[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    float t[S];
#pragma unroll
    for (int s = 0; s < S; ++s) t[s] = 0.f;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const float ljk = __shfl_sync(m, L[j / T][k], j % T, T);
#pragma unroll
      for (int s = 0; s < S; ++s) t[s] += L[s][k] * ljk;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) t[s] = A[s][j] - t[s];
    const float ld =
        __shfl_sync(m, sqrtf(fmaxf(t[j / T], 1e-12f)), j % T, T);
    linv[j] = 1.f / ld;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lane + s * T;
      if (r > j) L[s][j] = t[s] * linv[j];
      if (r == j) L[s][j] = ld;
    }
  }
  float acc[S], y[S], x[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.f;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const float yk =
        __shfl_sync(m, (bs[k / T] - acc[k / T]) * linv[k], k % T, T);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lane + s * T;
      if (r > k) acc[s] += L[s][k] * yk;
      if (r == k) y[s] = yk;
    }
  }
  // the factor's columns by the rows of shared memory
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float* row = ex + (lane + s * T) * EXW + EX_L;
#pragma unroll
    for (int j = 0; j < NR; ++j) row[j] = L[s][j];
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.f;
#pragma unroll
  for (int k = NR - 1; k >= 0; --k) {
    const float xk =
        __shfl_sync(m, (y[k / T] - acc[k / T]) * linv[k], k % T, T);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lane + s * T;
      if (r < k) acc[s] += ex[k * EXW + EX_L + r] * xk;
      if (r == k) x[s] = xk;
    }
  }
  __syncwarp();        // the rows are written again by the next substep
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = v[s] + TEAM_H * (x[s] * sc[s]);
    q[s] = q[s] + TEAM_H * v[s];
  }
}

}  // namespace

__global__ void __launch_bounds__(THREADS)
rollout_open_kernel(const float* __restrict__ x0,  // (B, NX)
                    const float* __restrict__ us,  // (B, H, NU)
                    float* __restrict__ xs,        // (B, H+1, NX)
                    int B, int H, int substeps) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  float* ex = reinterpret_cast<float*>(smem4) + team * TEAM_FLOATS;
  const int bt = blockIdx.x * TPB + team;
  const bool live = bt < B;
  const int b = live ? bt : B - 1;   // every lane runs: the team's shuffles
  float q[S], v[S], u[S];
  const float* xb = x0 + (size_t)b * NX;
  float* ob = xs + (size_t)b * (H + 1) * NX;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = lane + s * T;
    q[s] = r < NV ? xb[r] : 0.f;          // an inert role rests at 0
    v[s] = r < NV ? xb[NV + r] : 0.f;
    if (live && r < NV) {
      ob[r] = q[s];
      ob[NV + r] = v[s];
    }
  }
  const float* ub = us + (size_t)b * H * NU;
#pragma unroll 1
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = TEAM_ACT[lane + s * T];
      u[s] = j >= 0 ? ub[(size_t)k * NU + j] : 0.f;
    }
#pragma unroll 1
    for (int st = 0; st < substeps; ++st) team_substep(ex, lane, u, q, v);
    float* row = ob + (size_t)(k + 1) * NX;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lane + s * T;
      if (live && r < NV) {
        row[r] = q[s];
        row[NV + r] = v[s];
      }
    }
  }
}

extern "C" int rollout_open(const float* x0, const float* us, float* xs, int B,
                            int H, int substeps, void* stream) {
  if (B < 1 || H < 0 || substeps < 0) return (int)cudaErrorInvalidValue;
  rollout_open_kernel<<<(B + TPB - 1) / TPB, THREADS, SMEM,
                        (cudaStream_t)stream>>>(x0, us, xs, B, H, substeps);
  return (int)cudaGetLastError();
}

extern "C" int rollout_open_occupancy(int* out) {
  out[1] = THREADS;
  out[2] = (int)SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], rollout_open_kernel, THREADS, SMEM);
}
