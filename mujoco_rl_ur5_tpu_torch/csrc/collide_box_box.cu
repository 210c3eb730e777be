// Box-box narrowphase: per (pair, scenario) the 8 corners of each box tested
// against the other (the 4 deepest of each way) and the 15-axis edge SAT
// contact, 9 slots.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// box_box_batched (:675; body _make_box_box_body :323, edge SAT
// _box_box_edge_rows :351). Bound: bytes at the pile's shapes (about 2.3k
// f32 operations per instance against 28 bytes read and 252 written).
//
// Design (a team of 8 lanes of one warp per instance, 16 instances per
// block of 128 threads):
//  * lane l tests corner l of each box against the other with
//    corner_in_box once and keeps its point, normal and distance;
//  * the deepest 4 of each way are ranks over the way's 8 corners in
//    (distance, index) order, exchanged by shuffles: the plain top-4's
//    stable order. The lane whose corner ranks j < 4 writes slot way * 4 + j;
//  * the 15 SAT axes are split over the lanes (lane l: axes l and l + 8;
//    0-5 the boxes' face axes, 6-14 the cross products A_i x B_j). sep_any
//    is a max, exact in any order; the penetration's argmin keeps the first
//    minimum (ties to the lower axis), as the serial loop does, and the
//    winning cross axis goes to every lane by shuffle from the lane that
//    computed it, with the same sqrtf and divisions;
//  * the edge contact (segment_closest, slot 8) runs on one lane with the
//    serial arithmetic of collision._box_box_edge;
//  * each slot is written by the lane that owns it, so an instance's 9
//    slots leave its team together. Every value keeps the plain version's
//    operations and order (built with -fmad=false), so every output equals
//    it to the bit. No shared memory, no local memory, no atomics.
#include "collide_common.cuh"

namespace {

constexpr int T = 8;                     // lanes per instance: one corner each
constexpr int IPB = COLLIDE_THREADS / T; // instances per block
constexpr int EDGE_LANE = 7;             // the lane with one SAT axis
static_assert(32 % T == 0, "a team lies within one warp");

__device__ __forceinline__ unsigned team_mask() {
  const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(T - 1);
  return ((1u << T) - 1u) << first;
}

__device__ __forceinline__ void box_corner(const Pose& P, const float* s,
                                           int c, float* o) {
  const float v[3] = {(c & 4) ? s[0] : -s[0], (c & 2) ? s[1] : -s[1],
                      (c & 1) ? s[2] : -s[2]};
  to_world(P, v, o);
}

// a corner c (world) against box (Pb, sb): (pos, outward normal, dist)
__device__ __forceinline__ float corner_in_box(const float* c, const Pose& Pb,
                                               const float* sb, float* pos,
                                               float* nw) {
  const float d[3] = {c[0] - Pb.p[0], c[1] - Pb.p[1], c[2] - Pb.p[2]};
  float cl[3], fd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    cl[a] = Pb.R[0][a] * d[0] + Pb.R[1][a] * d[1] + Pb.R[2][a] * d[2];
    fd[a] = sb[a] - fabsf(cl[a]);
  }
  const bool inside = fd[0] > 0.f && fd[1] > 0.f && fd[2] > 0.f;
  int k = 0;
  float fmin = fd[0];
  if (fd[1] < fmin) { k = 1; fmin = fd[1]; }
  if (fd[2] < fmin) { k = 2; fmin = fd[2]; }
  const float clk = k == 0 ? cl[0] : (k == 1 ? cl[1] : cl[2]);
  const float sgn = signf(clk) + (clk == 0.f ? 1.f : 0.f);
  const float dist = inside ? -fmin : COLLIDE_BIG;
  const float h = 0.5f * dist * (inside ? 1.f : 0.f);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    // column k by selects: an index into the pose would put it on the stack
    nw[r] = (k == 0 ? Pb.R[r][0] : (k == 1 ? Pb.R[r][1] : Pb.R[r][2])) * sgn;
    pos[r] = c[r] - nw[r] * h;
  }
  return dist;
}

// collision._segment_closest
__device__ __forceinline__ void segment_closest(const float* pa,
                                                const float* ua, float ha,
                                                const float* pb,
                                                const float* ub, float hb,
                                                float& s, float& t) {
  const float r[3] = {pa[0] - pb[0], pa[1] - pb[1], pa[2] - pb[2]};
  const float a = dot3(ua, ua), e = dot3(ub, ub), f = dot3(ub, r);
  const float c = dot3(ua, r), bb = dot3(ua, ub);
  const float denom = a * e - bb * bb;
  const bool ok = fabsf(denom) > 1e-12f;
  s = ok ? (bb * f - c * e) / denom : 0.f;
  s = fminf(fmaxf(s, -ha), ha);
  t = fminf(fmaxf((bb * s + f) / fmaxf(e, 1e-12f), -hb), hb);
  s = fminf(fmaxf((bb * t - c) / fmaxf(a, 1e-12f), -ha), ha);
}

// row m (a lane's runtime index) of a 3 x 3 array, by selects: no local
// memory
__device__ __forceinline__ void pick(const float (*M)[3], int m, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = m == 0 ? M[0][r] : (m == 1 ? M[1][r] : M[2][r]);
}

}  // namespace

__global__ void __launch_bounds__(COLLIDE_THREADS)
box_box_kernel(COLLIDE_PARAMS) {
  const int lane = threadIdx.x % T;
  const long total = (long)B * n;
  const long inst = (long)blockIdx.x * IPB + threadIdx.x / T;
  // a team past the end computes the last instance and writes nothing: its
  // lanes still take part in the team's shuffles
  const bool live = inst < total;
  const long ii = live ? inst : total - 1;
  const int b = (int)(ii / n);
  const int a = g1[ii], c = g2[ii];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const float s1[3] = {size[a * 3], size[a * 3 + 1], size[a * 3 + 2]};
  const float s2[3] = {size[c * 3], size[c * 3 + 1], size[c * 3 + 2]};
  const unsigned m = team_mask();
  const size_t slot0 = (size_t)ii * 9;

  // corner `lane` of 1 inside 2 (normal(1->2) = -n) and of 2 inside 1 (+n)
#pragma unroll
  for (int way = 0; way < 2; ++way) {
    const Pose& Pc = way == 0 ? P1 : P2;
    const Pose& Pb = way == 0 ? P2 : P1;
    float cw[3], p[3], nw[3];
    box_corner(Pc, way == 0 ? s1 : s2, lane, cw);
    const float d = corner_in_box(cw, Pb, way == 0 ? s2 : s1, p, nw);
    int rank = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) {
      const float dk = __shfl_sync(m, d, k, T);
      rank += (dk < d || (dk == d && k < lane)) ? 1 : 0;
    }
    if (live && rank < 4) {
      if (way == 0) { nw[0] = -nw[0]; nw[1] = -nw[1]; nw[2] = -nw[2]; }
      store(out_pos, out_nrm, out_dist, slot0 + way * 4 + rank, p, nw, d);
    }
  }

  // collision._box_box_edge: the lane's SAT axes
  const float d12[3] = {P2.p[0] - P1.p[0], P2.p[1] - P1.p[1],
                        P2.p[2] - P1.p[2]};
  float A[3][3], Bx[3][3];  // rows: the boxes' axes in world
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      A[k][r] = P1.R[r][k];
      Bx[k][r] = P2.R[r][k];
    }
  auto overlap = [&](const float* ax) {
    float proj = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) proj += fabsf(dot3(A[k], ax)) * s1[k];
    float proj2 = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) proj2 += fabsf(dot3(Bx[k], ax)) * s2[k];
    return fabsf(dot3(d12, ax)) - (proj + proj2);
  };
  float sep_any = -COLLIDE_HUGE, best = COLLIDE_HUGE, cu[3] = {0.f, 0.f, 0.f};
  int bi = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ax = lane + k * T;
    if (ax >= 15) break;
    float u[3], sep, pen;
    if (ax < 6) {
      float ua[3], ub[3];
      pick(A, ax, ua);
      pick(Bx, ax - 3, ub);
#pragma unroll
      for (int r = 0; r < 3; ++r) u[r] = ax < 3 ? ua[r] : ub[r];
      sep = overlap(u);
      pen = -sep;
    } else {
      float Ai[3], Bj[3];
      pick(A, (ax - 6) / 3, Ai);
      pick(Bx, (ax - 6) % 3, Bj);
      const float cr[3] = {Ai[1] * Bj[2] - Ai[2] * Bj[1],
                           Ai[2] * Bj[0] - Ai[0] * Bj[2],
                           Ai[0] * Bj[1] - Ai[1] * Bj[0]};
      const float cn = sqrtf(dot3(cr, cr));
      const bool valid = cn > 1e-8f;
      const float inv = fmaxf(cn, 1e-12f);
      u[0] = cr[0] / inv;
      u[1] = cr[1] / inv;
      u[2] = cr[2] / inv;
      sep = valid ? overlap(u) : -COLLIDE_BIG;
      pen = valid ? -sep : COLLIDE_BIG;
    }
    sep_any = fmaxf(sep_any, sep);
    if (pen < best) {                    // a lane's axes come in order
      best = pen;
      bi = ax;
      cu[0] = u[0];
      cu[1] = u[1];
      cu[2] = u[2];
    }
  }
  // the team's max of sep and first minimum of pen (ties to the lower axis)
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    sep_any = fmaxf(sep_any, __shfl_xor_sync(m, sep_any, off, T));
    const float ob = __shfl_xor_sync(m, best, off, T);
    const int oi = __shfl_xor_sync(m, bi, off, T);
    if (ob < best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  // the winner's axis, from the lane that computed it (a face axis's is
  // never read)
  float cu_best[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    cu_best[r] = __shfl_sync(m, cu[r], bi & (T - 1), T);
  if (lane != EDGE_LANE || !live) return;

  // the edge contact: slot 8
  const bool separated = sep_any > 0.f;
  const bool edge_wins = bi >= 6;
  const int ei = edge_wins ? (bi - 6) / 3 : -1;
  const int ej = edge_wins ? (bi - 6) % 3 : -1;
  const float sg = signf(dot3(cu_best, d12));
  float L[3];
  if (edge_wins) {
    L[0] = cu_best[0] * sg;
    L[1] = cu_best[1] * sg;
    L[2] = cu_best[2] * sg;
  } else {
    L[0] = 0.f;
    L[1] = 0.f;
    L[2] = 1.f;
  }
  // supporting edges along A[i] and B[j]; the other axes at the corner
  // signs facing the other box
  float e1[3] = {P1.p[0], P1.p[1], P1.p[2]};
  float e2[3] = {P2.p[0], P2.p[1], P2.p[2]};
  float Ai[3] = {0.f, 0.f, 0.f}, Bj[3] = {0.f, 0.f, 0.f};
  float s1i = 0.f, s2j = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w1 = k == ei ? 0.f : signf(dot3(A[k], L)) * s1[k];
    const float w2 = k == ej ? 0.f : signf(dot3(Bx[k], L)) * s2[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e1[r] += A[k][r] * w1;
      e2[r] -= Bx[k][r] * w2;
    }
    if (k == ei) {
      Ai[0] = A[k][0]; Ai[1] = A[k][1]; Ai[2] = A[k][2];
      s1i = s1[k];
    }
    if (k == ej) {
      Bj[0] = Bx[k][0]; Bj[1] = Bx[k][1]; Bj[2] = Bx[k][2];
      s2j = s2[k];
    }
  }
  float s, t, mid[3];
  segment_closest(e1, Ai, s1i, e2, Bj, s2j, s, t);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    mid[r] = 0.5f * ((e1[r] + Ai[r] * s) + (e2[r] + Bj[r] * t));
  store(out_pos, out_nrm, out_dist, slot0 + 8, mid, L,
        (separated || !edge_wins) ? COLLIDE_BIG : -best);
}

COLLIDE_ENTRY_IPB(box_box, IPB)

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes), for the build report
extern "C" int collide_box_box_occupancy(int* out) {
  out[1] = COLLIDE_THREADS;
  out[2] = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], box_box_kernel, COLLIDE_THREADS, 0);
}
