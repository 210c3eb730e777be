// Shared device code of the six narrowphase kernels (collide_*.cu): small
// vector helpers, the stable top-k, the box-box and hull-hull bodies and the
// sphere probes of sphere-hull and capsule-hull.
//
// Each body computes one (pair, scenario) in registers, with the arithmetic,
// guards and tie rules of mujoco_rl_ur5_tpu_torch/physics/collision.py (the
// JAX package's physics/collision.py and the TPU kernels of
// physics/pallas_collide.py):
//   * stable top-k: ascending distance, ties to the lower index (lax.top_k);
//   * running argmax over faces and the SAT argmin keep the first extremum;
//   * BIG = 1e10 marks an inactive slot; box-box's edge slot carries the
//     normal (0, 0, 1) when a face axis wins (pallas_collide.py:417-425).
//
// Operand layout (all float32 unless noted, row-major):
//   pos (B, G, 3), quat (B, G, 4)  per-scenario collision poses of the geoms
//   size (G, 3)                    collision sizes
//   meshid (G,) int32              hull row of a geom (-1: no hull)
//   verts (M, V, 3), vmask (M, V), fnorm (M, F, 3), fdist (M, F)
//   g1, g2 (B, n) int32            the pair's geoms in each scenario
//   out_pos, out_nrm (B, n, K, 3), out_dist (B, n, K)
#pragma once
#include <cuda_runtime.h>

#define COLLIDE_BIG 1e10f
#define COLLIDE_HUGE 3.0e38f  // above every distance, BIG included

struct Pose {
  float p[3];
  float R[3][3];  // world from local
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// ops/spatial.py quat_to_mat
__device__ __forceinline__ void load_pose(const float* __restrict__ pos,
                                          const float* __restrict__ quat,
                                          int b, int G, int g, Pose& P) {
  const float* p = pos + ((size_t)b * G + g) * 3;
  const float* q = quat + ((size_t)b * G + g) * 4;
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  P.p[0] = p[0];
  P.p[1] = p[1];
  P.p[2] = p[2];
  P.R[0][0] = 1.f - 2.f * (y * y + z * z);
  P.R[0][1] = 2.f * (x * y - w * z);
  P.R[0][2] = 2.f * (x * z + w * y);
  P.R[1][0] = 2.f * (x * y + w * z);
  P.R[1][1] = 1.f - 2.f * (x * x + z * z);
  P.R[1][2] = 2.f * (y * z - w * x);
  P.R[2][0] = 2.f * (x * z - w * y);
  P.R[2][1] = 2.f * (y * z + w * x);
  P.R[2][2] = 1.f - 2.f * (x * x + y * y);
}

// world point of a local point
__device__ __forceinline__ void to_world(const Pose& P, const float* v,
                                         float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = P.p[r] + (P.R[r][0] * v[0] + P.R[r][1] * v[1] + P.R[r][2] * v[2]);
}

// world direction of a local direction
__device__ __forceinline__ void rot(const Pose& P, const float* v, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = P.R[r][0] * v[0] + P.R[r][1] * v[1] + P.R[r][2] * v[2];
}

// The K smallest (distance, index) pairs seen so far, ascending; an equal
// distance stays behind the earlier ones (lax.top_k's stable order).
template <int K>
struct TopK {
  float d[K];
  int i[K];
  __device__ __forceinline__ TopK() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = COLLIDE_HUGE;
      i[j] = 0;
    }
  }
  __device__ __forceinline__ void push(float dist, int idx) {
    if (!(dist < d[K - 1])) return;
    bool shift = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool take = shift || dist < d[j];
      const float td = d[j];
      const int ti = i[j];
      if (take) {
        d[j] = dist;
        i[j] = idx;
        dist = td;
        idx = ti;
      }
      shift = take;
    }
  }
};

__device__ __forceinline__ void store(float* __restrict__ out_pos,
                                      float* __restrict__ out_nrm,
                                      float* __restrict__ out_dist,
                                      size_t slot, const float* p,
                                      const float* nrm, float d) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out_pos[slot * 3 + r] = p[r];
    out_nrm[slot * 3 + r] = nrm[r];
  }
  out_dist[slot] = d;
}

// ---------------------------------------------------------------------------
// box-box (collision.box_box): corners of each box inside the other, 4 each,
// and the 15-axis edge SAT contact: 9 slots
// ---------------------------------------------------------------------------

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
    nw[r] = Pb.R[r][k] * sgn;
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

// collision._box_box_edge: returns dist, writes the midpoint and normal
__device__ __forceinline__ float box_box_edge(const Pose& P1, const float* s1,
                                              const Pose& P2, const float* s2,
                                              float* mid, float* L) {
  const float d12[3] = {P2.p[0] - P1.p[0], P2.p[1] - P1.p[1],
                        P2.p[2] - P1.p[2]};
  float A[3][3], Bx[3][3];  // rows: the boxes' axes in world
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      A[m][r] = P1.R[r][m];
      Bx[m][r] = P2.R[r][m];
    }
  auto overlap = [&](const float* ax) {
    float proj = 0.f;
#pragma unroll
    for (int m = 0; m < 3; ++m) proj += fabsf(dot3(A[m], ax)) * s1[m];
    float proj2 = 0.f;
#pragma unroll
    for (int m = 0; m < 3; ++m) proj2 += fabsf(dot3(Bx[m], ax)) * s2[m];
    return fabsf(dot3(d12, ax)) - (proj + proj2);
  };
  float sep_any = -COLLIDE_HUGE, best = COLLIDE_HUGE;
  int best_idx = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float sep = overlap(a < 3 ? A[a] : Bx[a - 3]);
    sep_any = fmaxf(sep_any, sep);
    if (-sep < best) { best = -sep; best_idx = a; }
  }
  float cu_best[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float cr[3] = {A[i][1] * Bx[j][2] - A[i][2] * Bx[j][1],
                     A[i][2] * Bx[j][0] - A[i][0] * Bx[j][2],
                     A[i][0] * Bx[j][1] - A[i][1] * Bx[j][0]};
      const float cn = sqrtf(dot3(cr, cr));
      const bool valid = cn > 1e-8f;
      const float inv = fmaxf(cn, 1e-12f);
      float cu[3] = {cr[0] / inv, cr[1] / inv, cr[2] / inv};
      const float sep = valid ? overlap(cu) : -COLLIDE_BIG;
      sep_any = fmaxf(sep_any, sep);
      const float pen = valid ? -sep : COLLIDE_BIG;
      if (pen < best) {
        best = pen;
        best_idx = 6 + 3 * i + j;
        cu_best[0] = cu[0];
        cu_best[1] = cu[1];
        cu_best[2] = cu[2];
      }
    }
  const bool separated = sep_any > 0.f;
  const bool edge_wins = best_idx >= 6;
  const int ei = edge_wins ? (best_idx - 6) / 3 : -1;
  const int ej = edge_wins ? (best_idx - 6) % 3 : -1;
  const float sg = signf(dot3(cu_best, d12));
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
  for (int m = 0; m < 3; ++m) {
    const float w1 = m == ei ? 0.f : signf(dot3(A[m], L)) * s1[m];
    const float w2 = m == ej ? 0.f : signf(dot3(Bx[m], L)) * s2[m];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      e1[r] += A[m][r] * w1;
      e2[r] -= Bx[m][r] * w2;
    }
    if (m == ei) {
      Ai[0] = A[m][0]; Ai[1] = A[m][1]; Ai[2] = A[m][2];
      s1i = s1[m];
    }
    if (m == ej) {
      Bj[0] = Bx[m][0]; Bj[1] = Bx[m][1]; Bj[2] = Bx[m][2];
      s2j = s2[m];
    }
  }
  float s, t;
  segment_closest(e1, Ai, s1i, e2, Bj, s2j, s, t);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    mid[r] = 0.5f * ((e1[r] + Ai[r] * s) + (e2[r] + Bj[r] * t));
  return (separated || !edge_wins) ? COLLIDE_BIG : -best;
}

// ---------------------------------------------------------------------------
// hull-hull (collision.hull_hull): the least-overlap face over both hulls,
// then the 8 deepest opposing vertices along it: 8 slots. A hull is either a
// table row (verts, vmask, fnorm, fdist) or a box (8 vertices, 6 faces)
// ---------------------------------------------------------------------------

struct Hull {
  const float* verts;  // (V, 3), or null for a box
  const float* vmask;  // (V,)
  const float* fnorm;  // (F, 3)
  const float* fdist;  // (F,)
  float s[3];          // a box's half-extents (held by value: registers)
  bool box;
  int V, F;
};

__device__ __forceinline__ Hull table_hull(const float* __restrict__ verts,
                                           const float* __restrict__ vmask,
                                           const float* __restrict__ fnorm,
                                           const float* __restrict__ fdist,
                                           int mesh, int V, int F) {
  Hull h;
  h.verts = verts + (size_t)mesh * V * 3;
  h.vmask = vmask + (size_t)mesh * V;
  h.fnorm = fnorm + (size_t)mesh * F * 3;
  h.fdist = fdist + (size_t)mesh * F;
  h.box = false;
  h.V = V;
  h.F = F;
  return h;
}

__device__ __forceinline__ Hull box_hull_of(const float* s) {
  Hull h;
  h.verts = h.vmask = h.fnorm = h.fdist = nullptr;
  h.s[0] = s[0];
  h.s[1] = s[1];
  h.s[2] = s[2];
  h.box = true;
  h.V = 8;
  h.F = 6;
  return h;
}

// local vertex v of a hull; false for a padded (masked) vertex
__device__ __forceinline__ bool hull_vert(const Hull& h, int v, float* o) {
  if (h.box) {  // collision.box_as_hull: signs of corner v
    o[0] = (v & 4) ? h.s[0] : -h.s[0];
    o[1] = (v & 2) ? h.s[1] : -h.s[1];
    o[2] = (v & 1) ? h.s[2] : -h.s[2];
    return true;
  }
  o[0] = h.verts[v * 3 + 0];
  o[1] = h.verts[v * 3 + 1];
  o[2] = h.verts[v * 3 + 2];
  return h.vmask[v] > 0.5f;
}

// world face f of a hull: normal n and offset d (n . x <= d)
__device__ __forceinline__ float hull_face(const Hull& h, const Pose& P,
                                           int f, float* n) {
  float nl[3] = {0.f, 0.f, 0.f};
  float d;
  if (h.box) {  // faces +x, +y, +z, -x, -y, -z
    nl[f % 3] = f < 3 ? 1.f : -1.f;
    d = h.s[f % 3];
  } else {
    nl[0] = h.fnorm[f * 3 + 0];
    nl[1] = h.fnorm[f * 3 + 1];
    nl[2] = h.fnorm[f * 3 + 2];
    d = h.fdist[f];
  }
  rot(P, nl, n);
  return d + (n[0] * P.p[0] + n[1] * P.p[1] + n[2] * P.p[2]);
}

// max over the faces of hv (on Pf) of min over the vertices of hv (on Pv)
// of v . n_f - d_f, first maximum; writes that face's normal and offset
__device__ __forceinline__ float best_face(const Hull& hv, const Pose& Pv,
                                           const Hull& hf, const Pose& Pf,
                                           float* nbest, float& dbest) {
  float best = -COLLIDE_HUGE;
  for (int f = 0; f < hf.F; ++f) {
    float n[3];
    const float d = hull_face(hf, Pf, f, n);
    float mn = COLLIDE_BIG;
    for (int v = 0; v < hv.V; ++v) {
      float vl[3], vw[3];
      const bool real = hull_vert(hv, v, vl);
      to_world(Pv, vl, vw);
      const float score = real ? dot3(vw, n) : COLLIDE_BIG;
      mn = fminf(mn, score);
    }
    const float sep = mn - d;
    if (f == 0 || sep > best) {
      best = sep;
      nbest[0] = n[0];
      nbest[1] = n[1];
      nbest[2] = n[2];
      dbest = d;
    }
  }
  return best;
}

__device__ __forceinline__ void hull_hull(const Hull& h1, const Pose& P1,
                                          const Hull& h2, const Pose& P2,
                                          float* __restrict__ out_pos,
                                          float* __restrict__ out_nrm,
                                          float* __restrict__ out_dist,
                                          size_t slot0) {
  float nA[3], nB[3], dA, dB;
  const float sep2 = best_face(h1, P1, h2, P2, nA, dA);  // face on hull 2
  const float sep1 = best_face(h2, P2, h1, P1, nB, dB);  // face on hull 1
  const bool use2 = sep2 >= sep1;
  // copies, not references: selecting between two register structs by a
  // runtime flag would otherwise send both to local memory
  const Hull hv = use2 ? h1 : h2;
  const Pose Pv = use2 ? P1 : P2;
  const float n[3] = {use2 ? nA[0] : nB[0], use2 ? nA[1] : nB[1],
                      use2 ? nA[2] : nB[2]};
  const float d = use2 ? dA : dB;
  TopK<8> top;
  for (int v = 0; v < hv.V; ++v) {
    float vl[3], vw[3];
    const bool real = hull_vert(hv, v, vl);
    to_world(Pv, vl, vw);
    top.push(real ? dot3(vw, n) - d : COLLIDE_BIG, v);
  }
  // vertex of 1 on a face of 2: normal -n2; vertex of 2 on a face of 1: +n1
  const float nrm[3] = {use2 ? -n[0] : n[0], use2 ? -n[1] : n[1],
                        use2 ? -n[2] : n[2]};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float vl[3], vw[3], p[3];
    hull_vert(hv, top.i[k], vl);
    to_world(Pv, vl, vw);
    const float dk = top.d[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) p[r] = vw[r] - 0.5f * dk * n[r];
    store(out_pos, out_nrm, out_dist, slot0 + k, p, nrm, dk);
  }
}

// ---------------------------------------------------------------------------
// sphere probes against a hull (collision._sphere_hull_point): for each of P
// sphere centers, the hull face of largest signed distance (the first of
// equals), then one contact along it: 1 slot for a sphere, 5 for a capsule.
// The faces are moved to world once and scored against every center
// ---------------------------------------------------------------------------

template <int P>
__device__ __forceinline__ void sphere_probes(const Hull& h, const Pose& Ph,
                                              const float (*c)[3], float r,
                                              float* __restrict__ out_pos,
                                              float* __restrict__ out_nrm,
                                              float* __restrict__ out_dist,
                                              size_t slot0) {
  float best[P], nb[P][3];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    best[k] = -COLLIDE_HUGE;
    nb[k][0] = nb[k][1] = nb[k][2] = 0.f;
  }
  for (int f = 0; f < h.F; ++f) {
    float n[3];
    const float d = hull_face(h, Ph, f, n);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float score = dot3(n, c[k]) - d;
      if (f == 0 || score > best[k]) {
        best[k] = score;
        nb[k][0] = n[0];
        nb[k][1] = n[1];
        nb[k][2] = n[2];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float dist = best[k] - r;
    const float h2 = r + 0.5f * dist;
    const float p[3] = {c[k][0] - nb[k][0] * h2, c[k][1] - nb[k][1] * h2,
                        c[k][2] - nb[k][2] * h2};
    const float nrm[3] = {-nb[k][0], -nb[k][1], -nb[k][2]};
    store(out_pos, out_nrm, out_dist, slot0 + k, p, nrm, dist);
  }
}

// ---------------------------------------------------------------------------
// the kernels' shared parameter list, launch shape and C entry point: one
// thread per (pair, scenario), pairs of one scenario on neighbouring threads
// ---------------------------------------------------------------------------

#define COLLIDE_THREADS 128

#define COLLIDE_PARAMS                                                       \
  const float *__restrict__ pos, const float *__restrict__ quat,              \
      const float *__restrict__ size, const int *__restrict__ meshid,         \
      const float *__restrict__ verts, const float *__restrict__ vmask,       \
      const float *__restrict__ fnorm, const float *__restrict__ fdist,       \
      const int *__restrict__ g1, const int *__restrict__ g2,                 \
      float *__restrict__ out_pos, float *__restrict__ out_nrm,               \
      float *__restrict__ out_dist, int B, int n, int G, int V, int F

#ifndef COLLIDE_LAUNCH
#define COLLIDE_LAUNCH(kernel, blocks, stream, ...)                          \
  kernel<<<(blocks), COLLIDE_THREADS, 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// extern "C" int collide_<name>(...): launches <name>_kernel on ``stream``
// and returns cudaGetLastError()
#define COLLIDE_ENTRY(name)                                                  \
  extern "C" int collide_##name(                                             \
      const float* pos, const float* quat, const float* size,                \
      const int* meshid, const float* verts, const float* vmask,             \
      const float* fnorm, const float* fdist, const int* g1, const int* g2,  \
      float* out_pos, float* out_nrm, float* out_dist, int B, int n, int G,  \
      int V, int F, void* stream) {                                          \
    COLLIDE_LAUNCH(name##_kernel,                                            \
                   (B * n + COLLIDE_THREADS - 1) / COLLIDE_THREADS, stream,  \
                   pos, quat, size, meshid, verts, vmask, fnorm, fdist, g1,  \
                   g2, out_pos, out_nrm, out_dist, B, n, G, V, F);           \
    return (int)cudaGetLastError();                                          \
  }
