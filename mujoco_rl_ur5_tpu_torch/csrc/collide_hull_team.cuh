// The team hull body of collide_hull_hull.cu, collide_box_hull.cu and
// collide_plane_hull.cu: per (pair, scenario) the least-overlap face over
// both sides' faces, then the 8 deepest vertices of the other side along
// it, 8 slots. Side 2 is a row of the hull table; side 1 is chosen at
// compile time (Side1): a row too (hull-hull), a box made from its size
// (box-hull), or a plane (plane-hull), whose z axis is the winning face
// with no face pass. The probe kernels, collide_sphere_hull.cu and
// collide_capsule_hull.cu, share the staging, the team and the joins below
// and run one probe loop (probe_faces) for their 1 and 5 probes.
//
// Design (a team of 4 lanes of one warp per instance; 2 and 8 ran no
// faster on the H100 for hull-hull):
//  * the block stages the model's hull table (local vertices, face normals
//    and offsets, each mesh's real vertex and face counts; a plane's kernel
//    reads no faces and stages none, sphere-hull reads no vertices and
//    stages none) in shared memory once, then walks its instances
//    grid-stride;
//  * each vertex and each face moves to world once per instance: the team's
//    lanes move both sides' vertices into the instance's shared rows, and
//    each lane moves its own faces (f = lane, lane + T, ...) into registers,
//    with collide_common.cuh's operations, so every score keeps its bits. A
//    box's 8 corners take collision.box_as_hull's signs (corner v: x from
//    bit 2, y from bit 1, z from bit 0), its 6 faces the unit normals +x,
//    +y, +z, -x, -y, -z turned by the same rotation, offsets its sizes; a
//    plane's face is its rotation's z column as it stands (collision.
//    plane_hull's normal: turning (0, 0, 1) could change a zero's sign),
//    its offset n . p;
//  * the loops run over the real vertices and faces only (the counts), not
//    the padded table: a padded face scores about -1e10 and never wins after
//    face 0, a padded vertex scores BIG and never lowers a minimum, so
//    skipping both leaves every output the same. A hull with fewer than 8
//    real vertices still fills its 8 slots with BIG distances at the padded
//    vertices' indices, as the plain version's stable order does;
//  * each lane keeps its faces' first maximum of (min over vertices of
//    v . n) - d; shuffles within the team take the maximum, ties to the
//    lower face index (the min is exact in any order), so the team agrees
//    on the face the plain argmax picks, and each lane moves that face to
//    world again by the same operations;
//  * the deepest 8 are ranks: each lane ranks its own vertices against all
//    of the side's in (distance, index) order, the stable order of the
//    plain version's sort, compared as one 64-bit key per vertex (the
//    distance's order-preserving bits, then the index: a third fewer
//    instructions than the float comparison with its tie rule), and the
//    lane whose vertex has rank k < 8 writes slot k from the values it
//    holds. No local memory, no atomics.
#pragma once
#include "collide_common.cuh"

namespace {

constexpr int T = 4;                       // lanes per instance (HULL_TEAM)
constexpr int THREADS = 128;
constexpr int IPB = THREADS / T;           // instances per block
constexpr int VPL = (32 + T - 1) / T;      // ranked vertices per lane per pass
static_assert(32 % T == 0, "a team lies within one warp");

// side 1 of the team body
enum Side1 { HULL1, BOX1, PLANE1 };

// shared memory, in floats: per instance both sides' world vertices as
// float4 rows (side 1's rows1: a table row V, a box 8, a plane none; side
// 2's V; and 1 more: consecutive instances start on other banks; .w of the
// deepest pass's side holds its distances), then the table (its vertices
// and its faces where the kernel reads them)
__host__ __device__ constexpr int side1_rows(Side1 s1, int V) {
  return s1 == HULL1 ? V : (s1 == BOX1 ? 8 : 0);
}
__host__ __device__ constexpr size_t inst_rows(int rows1, int V) {
  return (size_t)rows1 + V + 1;
}
__host__ __device__ constexpr size_t table_floats(int M, int V, int F,
                                                  bool verts, bool faces) {
  return (verts ? (size_t)M * V * 3 : 0) + (faces ? (size_t)M * F * 4 : 0)
         + 2 * (size_t)M;
}
__host__ __device__ constexpr size_t smem_bytes(int M, int V, int F,
                                               int rows1, bool faces) {
  return (IPB * inst_rows(rows1, V) * 4 + table_floats(M, V, F, true, faces))
         * sizeof(float);
}
// the shared memory of a hull_team<s1> block
__host__ __device__ constexpr size_t hull_team_smem(Side1 s1, int M, int V,
                                                   int F) {
  return smem_bytes(M, V, F, side1_rows(s1, V), s1 != PLANE1);
}

// the hull table in shared memory: verts (M, V, 3), fnorm (M, F, 3), fdist
// (M, F) (no vertices or no faces where the kernel reads none), each row's
// real counts nv, nf (M,)
struct Table {
  const float* verts;
  const float* fnorm;
  const float* fdist;
  const int* nv;
  const int* nf;
};

// the block copies the table to ``tab`` (after its instances' rows), then
// waits for every thread
__device__ __forceinline__ Table stage_table(
    float* tab, const float* __restrict__ verts,
    const float* __restrict__ fnorm, const float* __restrict__ fdist,
    const int* __restrict__ nvert, const int* __restrict__ nface, int M,
    int V, int F, bool vertices, bool faces) {
  float* s_verts = tab;
  float* s_fnorm = s_verts + (vertices ? (size_t)M * V * 3 : 0);
  float* s_fdist = s_fnorm + (faces ? (size_t)M * F * 3 : 0);
  int* s_nv = reinterpret_cast<int*>(s_fdist + (faces ? (size_t)M * F : 0));
  int* s_nf = s_nv + M;
  if (vertices)
    for (int i = threadIdx.x; i < M * V * 3; i += THREADS)
      s_verts[i] = verts[i];
  if (faces) {
    for (int i = threadIdx.x; i < M * F * 3; i += THREADS)
      s_fnorm[i] = fnorm[i];
    for (int i = threadIdx.x; i < M * F; i += THREADS) s_fdist[i] = fdist[i];
  }
  for (int i = threadIdx.x; i < M; i += THREADS) {
    s_nv[i] = nvert[i];
    s_nf[i] = nface[i];
  }
  __syncthreads();
  return {s_verts, s_fnorm, s_fdist, s_nv, s_nf};
}

__device__ __forceinline__ unsigned team_mask() {
  const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(T - 1);
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u) << first;
}

// (distance d, index i) as one key whose unsigned order is the plain
// version's stable order: ascending distance, ties to the lower index. The
// float's bits, -0 made +0, map to an unsigned order-preserving code
__device__ __forceinline__ unsigned long long rank_key(float d, int i) {
  unsigned b = __float_as_uint(d + 0.f);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned)i;
}

// world face of a local normal nl and offset fd: normal n, returns its
// offset (hull_face's operations)
__device__ __forceinline__ float face_world(const Pose& P, const float* nl,
                                            float fd, float* n) {
  rot(P, nl, n);
  return fd + (n[0] * P.p[0] + n[1] * P.p[1] + n[2] * P.p[2]);
}

// the faces of a table row
struct TableFaces {
  static constexpr int FPL = (20 + T - 1) / T;   // faces per lane per pass
  const float* fn;                               // (F, 3) in shared memory
  const float* fd;                               // (F,)
  __device__ __forceinline__ float world(const Pose& P, int f,
                                         float* n) const {
    return face_world(P, fn + f * 3, fd[f], n);
  }
};

// the faces of a box (collision.box_as_hull): +x, +y, +z, -x, -y, -z
struct BoxFaces {
  static constexpr int FPL = (6 + T - 1) / T;
  float s[3];
  __device__ __forceinline__ float world(const Pose& P, int f,
                                         float* n) const {
    const int k = f < 3 ? f : f - 3;
    const float sg = f < 3 ? 1.f : -1.f;
    const float nl[3] = {k == 0 ? sg : 0.f, k == 1 ? sg : 0.f,
                         k == 2 ? sg : 0.f};
    return face_world(P, nl, k == 0 ? s[0] : (k == 1 ? s[1] : s[2]), n);
  }
};

// The team's first maximum over the nf faces (pose Pf) of min over the nv
// world vertices wv of v . n - d; returns the separation, the face in f_out
template <class Faces>
__device__ __forceinline__ float team_best_face(const float4* wv, int nv,
                                                const Pose& Pf,
                                                const Faces& faces, int nf,
                                                int lane, int& f_out) {
  constexpr int FPL = Faces::FPL;
  float best = -COLLIDE_HUGE;
  int bf = 0x7fffffff;
  for (int f0 = lane; f0 < nf; f0 += T * FPL) {
    float n[FPL][3], d[FPL], mn[FPL];
#pragma unroll
    for (int c = 0; c < FPL; ++c) {
      const int f = f0 + c * T;
      n[c][0] = n[c][1] = n[c][2] = 0.f;
      d[c] = 0.f;
      if (f < nf) d[c] = faces.world(Pf, f, n[c]);
      mn[c] = COLLIDE_BIG;
    }
    for (int v = 0; v < nv; ++v) {
      const float4 w = wv[v];
      const float p[3] = {w.x, w.y, w.z};
#pragma unroll
      for (int c = 0; c < FPL; ++c) mn[c] = fminf(mn[c], dot3(p, n[c]));
    }
#pragma unroll
    for (int c = 0; c < FPL; ++c) {
      const int f = f0 + c * T;
      const float sep = mn[c] - d[c];
      if (f < nf && sep > best) {      // a lane's faces come in order
        best = sep;
        bf = f;
      }
    }
  }
  const unsigned m = team_mask();
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(m, best, off, T);
    const int of = __shfl_xor_sync(m, bf, off, T);
    if (ob > best || (ob == best && of < bf)) {
      best = ob;
      bf = of;
    }
  }
  f_out = bf;
  return best;
}

// One block's work: hull tables verts (M, V, 3), fnorm (M, F, 3), fdist
// (M, F), each row's real counts nvert, nface (M,); side 1 (S1) the table
// row meshid[g1], a box of size size[g1] or a plane; side 2 the row
// meshid[g2]. smem4: the block's dynamic shared memory (smem_bytes)
template <Side1 S1>
__device__ __forceinline__ void hull_team(
    float4* smem4, const float* __restrict__ pos,
    const float* __restrict__ quat, const float* __restrict__ size,
    const int* __restrict__ meshid, const float* __restrict__ verts,
    const float* __restrict__ fnorm, const float* __restrict__ fdist,
    const int* __restrict__ nvert, const int* __restrict__ nface,
    const int* __restrict__ g1, const int* __restrict__ g2,
    float* __restrict__ out_pos, float* __restrict__ out_nrm,
    float* __restrict__ out_dist, int B, int n, int G, int M, int V, int F) {
  const int rows1 = side1_rows(S1, V);
  const Table tab = stage_table(
      reinterpret_cast<float*>(smem4 + IPB * inst_rows(rows1, V)), verts,
      fnorm, fdist, nvert, nface, M, V, F, true, S1 != PLANE1);

  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  float4* w1 = smem4 + team * inst_rows(rows1, V);  // side 1's world vertices
  float4* w2 = w1 + rows1;                          // side 2's
  const long total = (long)B * n;
  // every thread of the block runs the same iterations: the team's
  // shuffles and the warp's barriers need all their lanes
  for (long base = (long)blockIdx.x * IPB; base < total;
       base += (long)gridDim.x * IPB) {
    const long inst = base + team;
    const bool live = inst < total;
    const long ii = live ? inst : total - 1;
    const int b = (int)(ii / n);
    const int a = g1[ii], c = g2[ii];
    Pose P1, P2;
    load_pose(pos, quat, b, G, a, P1);
    load_pose(pos, quat, b, G, c, P2);
    const int m2 = meshid[c];
    const int m1 = S1 == HULL1 ? meshid[a] : 0;
    const int nv1 = S1 == HULL1 ? tab.nv[m1] : 8, nv2 = tab.nv[m2];
    // the deepest pass ranks at least 8 vertices (padded ones at BIG)
    const int nx1 = nv1 > 8 ? nv1 : 8, nx2 = nv2 > 8 ? nv2 : 8;
    BoxFaces box{{0.f, 0.f, 0.f}};
    if constexpr (S1 == BOX1) {
      box.s[0] = size[a * 3 + 0];
      box.s[1] = size[a * 3 + 1];
      box.s[2] = size[a * 3 + 2];
    }
    if constexpr (S1 != PLANE1) {
      for (int v = lane; v < nx1; v += T) {
        float o[3];
        if constexpr (S1 == BOX1) {
          const float vl[3] = {(v & 4) ? box.s[0] : -box.s[0],
                               (v & 2) ? box.s[1] : -box.s[1],
                               (v & 1) ? box.s[2] : -box.s[2]};
          to_world(P1, vl, o);
        } else {
          to_world(P1, tab.verts + ((size_t)m1 * V + v) * 3, o);
        }
        w1[v] = make_float4(o[0], o[1], o[2], 0.f);
      }
    }
    for (int v = lane; v < nx2; v += T) {
      float o[3];
      to_world(P2, tab.verts + ((size_t)m2 * V + v) * 3, o);
      w2[v] = make_float4(o[0], o[1], o[2], 0.f);
    }
    __syncwarp();
    bool use2 = false;
    float nw[3], d;
    if constexpr (S1 == PLANE1) {      // the plane's z axis, as it stands
      nw[0] = P1.R[0][2];
      nw[1] = P1.R[1][2];
      nw[2] = P1.R[2][2];
      d = dot3(nw, P1.p);
    } else {
      const TableFaces faces2{tab.fnorm + (size_t)m2 * F * 3,
                              tab.fdist + (size_t)m2 * F};
      const TableFaces faces1{tab.fnorm + (size_t)m1 * F * 3,
                              tab.fdist + (size_t)m1 * F};
      int fa, fb;
      const float sep2 = team_best_face(w1, nv1, P2, faces2, tab.nf[m2],
                                        lane, fa);        // face on side 2
      float sep1;                                         // face on side 1
      if constexpr (S1 == BOX1)
        sep1 = team_best_face(w2, nv2, P1, box, 6, lane, fb);
      else
        sep1 = team_best_face(w2, nv2, P1, faces1, tab.nf[m1], lane, fb);
      use2 = sep2 >= sep1;
      d = use2 ? faces2.world(P2, fa, nw)
               : (S1 == BOX1 ? box.world(P1, fb, nw)
                             : faces1.world(P1, fb, nw));
    }
    float4* wv = use2 ? w1 : w2;
    const int nv = use2 ? nv1 : nv2, nx = use2 ? nx1 : nx2;
    for (int v = lane; v < nx; v += T) {
      const float4 w = wv[v];
      const float p[3] = {w.x, w.y, w.z};
      wv[v].w = v < nv ? dot3(p, nw) - d : COLLIDE_BIG;
    }
    __syncwarp();
    // vertex of 1 on a face of 2: normal -n2; vertex of 2 on a face of 1
    // (or under the plane): +n1
    const float nrm[3] = {use2 ? -nw[0] : nw[0], use2 ? -nw[1] : nw[1],
                          use2 ? -nw[2] : nw[2]};
    for (int v0 = lane; v0 < nx; v0 += T * VPL) {
      float dv[VPL];
      int rank[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = v0 + j * T;
        dv[j] = v < nx ? wv[v].w : COLLIDE_HUGE;
        rank[j] = 0;
      }
      unsigned long long kv[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) kv[j] = rank_key(dv[j], v0 + j * T);
      for (int u = 0; u < nx; ++u) {
        const unsigned long long ku = rank_key(wv[u].w, u);
#pragma unroll
        for (int j = 0; j < VPL; ++j) rank[j] += ku < kv[j] ? 1 : 0;
      }
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = v0 + j * T;
        if (live && v < nx && rank[j] < 8) {
          const float4 w = wv[v];
          const float p[3] = {w.x - 0.5f * dv[j] * nw[0],
                              w.y - 0.5f * dv[j] * nw[1],
                              w.z - 0.5f * dv[j] * nw[2]};
          store(out_pos, out_nrm, out_dist, (size_t)inst * 8 + rank[j], p,
                nrm, dv[j]);
        }
      }
    }
    __syncwarp();        // the rows are written again by the next instance
  }
}

// The probe loop of the probe kernels (sphere-hull: 1 probe, capsule-hull:
// 5): P spheres of radius rad at centres ctr against the table row m2 at
// pose P2, collision._sphere_hull_point for each. Lane l moves its real
// faces (f = l, l + T, ... below the row's face count) to world once and
// scores each against every centre, each probe keeping its first maximum
// of n . c - d (face 0 taken as it is, as the plain argmax does; no real
// face: face 0 alone). Padded faces score about -1e10 and never win after
// face 0, so they are skipped. Shuffles within the team take each probe's
// maximum, ties to the lower face index; the lane that owns slot k (k mod
// T) moves the winning face to world again by the same operations and
// writes the contact along it to slot inst * P + k where the instance is
// live. Every lane of the team calls it (the shuffles need all four)
template <int P>
__device__ __forceinline__ void probe_faces(
    const Table& tab, int m2, int F, const Pose& P2, const float (*ctr)[3],
    float rad, int lane, bool live, long inst, float* __restrict__ out_pos,
    float* __restrict__ out_nrm, float* __restrict__ out_dist) {
  const unsigned m = team_mask();
  const float* fn = tab.fnorm + (size_t)m2 * F * 3;
  const float* fd = tab.fdist + (size_t)m2 * F;
  const int nf = tab.nf[m2];
  const int nfx = nf > 0 ? nf : 1;     // no real face: face 0, as the argmax
  float best[P];
  int bf[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    best[k] = -COLLIDE_HUGE;
    bf[k] = 0x7fffffff;
  }
  for (int f = lane; f < nfx; f += T) {
    float nw[3];
    const float d = face_world(P2, fn + f * 3, fd[f], nw);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float score = dot3(nw, ctr[k]) - d;
      if (f == 0 || score > best[k]) {     // a lane's faces come in order
        best[k] = score;
        bf[k] = f;
      }
    }
  }
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float ob = __shfl_xor_sync(m, best[k], off, T);
      const int of = __shfl_xor_sync(m, bf[k], off, T);
      if (ob > best[k] || (ob == best[k] && of < bf[k])) {
        best[k] = ob;
        bf[k] = of;
      }
    }
  }
  // _sphere_hull_point's contact along the winning face
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (live && k % T == lane) {
      float nw[3];
      face_world(P2, fn + bf[k] * 3, fd[bf[k]], nw);
      const float dist = best[k] - rad;
      const float h = rad + 0.5f * dist;
      const float p[3] = {ctr[k][0] - nw[0] * h, ctr[k][1] - nw[1] * h,
                          ctr[k][2] - nw[2] * h};
      const float nrm[3] = {-nw[0], -nw[1], -nw[2]};
      store(out_pos, out_nrm, out_dist, (size_t)inst * P + k, p, nrm, dist);
    }
  }
}

// Before a launch of ``kernel`` (a hull_team instance) over ``total``
// instances with ``smem`` bytes of shared memory: the checks of the tables
// (cudaErrorInvalidValue where V < 8, the table is empty or does not fit one
// block: physics/cuda_collide.py team_smem raises before the call), the
// shared-memory attribute, and the grid (0 for no instance): at most the
// blocks the card keeps resident
template <class K>
int team_grid(K kernel, long total, int M, int V, int F, size_t smem,
              int& grid) {
  grid = 0;
  if (V < 8 || M < 1 || F < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (total < 1) return 0;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                smem);
  const long need = (total + IPB - 1) / IPB;
  const long most = (long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  grid = (int)(need < most ? need : most);
  return 0;
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) of ``kernel`` with ``smem`` bytes, for the build report
template <class K>
int team_occupancy(K kernel, int* out, size_t smem) {
  out[1] = THREADS;
  out[2] = (int)smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, THREADS, out[2]);
}

}  // namespace
