// Hull-hull narrowphase (cylinders as 16-gon prisms, mesh finger pads): per
// (pair, scenario) the least-overlap face over both hulls' faces, then the 8
// deepest vertices of the other hull along it.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// hull_hull_batched (:689; body _make_hull_hull_body :527, _best_face :465,
// _deepest8 :484). Bound: operations (2 V F vertex-face products over the
// real vertices and faces, about 9.2k f32 operations per instance on the
// object pile), then the 7 output floats of 8 slots.
//
// Design (a team of 4 lanes of one warp per instance; 2 and 8 ran no
// faster on the H100):
//  * the block stages the model's hull table (local vertices, face normals
//    and offsets, each mesh's real vertex and face counts) in shared memory
//    once, then walks its instances grid-stride;
//  * each vertex and each face moves to world once per instance: the team's
//    lanes move both hulls' vertices into the instance's shared rows, and
//    each lane moves its own faces (f = lane, lane + T, ...) into registers,
//    with collide_common.cuh's operations, so every score keeps its bits;
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
//    of the hull's in (distance, index) order, the stable order of the
//    plain version's sort, and the lane whose vertex has rank k < 8 writes
//    slot k. No local memory, no atomics.
#include "collide_common.cuh"

namespace {

constexpr int T = 4;                       // lanes per instance (HULL_TEAM)
constexpr int THREADS = 128;
constexpr int IPB = THREADS / T;           // instances per block
constexpr int FPL = (20 + T - 1) / T;      // faces per lane per pass
constexpr int VPL = (32 + T - 1) / T;      // ranked vertices per lane per pass
static_assert(32 % T == 0, "a team lies within one warp");

// shared memory, in floats: per instance both hulls' world vertices as
// float4 rows (2 V + 1 of them: consecutive instances start on other banks;
// .w of the deepest pass's hull holds its distances), then the table
__host__ __device__ constexpr size_t inst_rows(int V) { return 2 * V + 1; }
__host__ __device__ constexpr size_t table_floats(int M, int V, int F) {
  return (size_t)M * V * 3 + (size_t)M * F * 4 + 2 * (size_t)M;
}
__host__ __device__ constexpr size_t smem_bytes(int M, int V, int F) {
  return (IPB * inst_rows(V) * 4 + table_floats(M, V, F)) * sizeof(float);
}

__device__ __forceinline__ unsigned team_mask() {
  const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(T - 1);
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u) << first;
}

// world face f of a table hull: normal n, returns its offset (hull_face's
// operations)
__device__ __forceinline__ float face_world(const Pose& P, const float* nl,
                                            float fd, float* n) {
  rot(P, nl, n);
  return fd + (n[0] * P.p[0] + n[1] * P.p[1] + n[2] * P.p[2]);
}

// The team's first maximum over the nf faces of mesh row fn/fdt (pose Pf)
// of min over the nv world vertices wv of v . n - d; returns the separation,
// the face in f_out
__device__ __forceinline__ float team_best_face(const float4* wv, int nv,
                                                const Pose& Pf,
                                                const float* fn,
                                                const float* fdt, int nf,
                                                int lane, int& f_out) {
  float best = -COLLIDE_HUGE;
  int bf = 0x7fffffff;
  for (int f0 = lane; f0 < nf; f0 += T * FPL) {
    float n[FPL][3], d[FPL], mn[FPL];
#pragma unroll
    for (int c = 0; c < FPL; ++c) {
      const int f = f0 + c * T;
      n[c][0] = n[c][1] = n[c][2] = 0.f;
      d[c] = 0.f;
      if (f < nf) d[c] = face_world(Pf, fn + f * 3, fdt[f], n[c]);
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

}  // namespace

__global__ void __launch_bounds__(THREADS)
hull_hull_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                 const int* __restrict__ meshid,
                 const float* __restrict__ verts,
                 const float* __restrict__ fnorm,
                 const float* __restrict__ fdist,
                 const int* __restrict__ nvert, const int* __restrict__ nface,
                 const int* __restrict__ g1, const int* __restrict__ g2,
                 float* __restrict__ out_pos, float* __restrict__ out_nrm,
                 float* __restrict__ out_dist, int B, int n, int G, int M,
                 int V, int F) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4 + IPB * inst_rows(V));
  float* s_verts = tab;                              // (M, V, 3)
  float* s_fnorm = s_verts + (size_t)M * V * 3;      // (M, F, 3)
  float* s_fdist = s_fnorm + (size_t)M * F * 3;      // (M, F)
  int* s_nv = reinterpret_cast<int*>(s_fdist + (size_t)M * F);
  int* s_nf = s_nv + M;
  for (int i = threadIdx.x; i < M * V * 3; i += THREADS) s_verts[i] = verts[i];
  for (int i = threadIdx.x; i < M * F * 3; i += THREADS) s_fnorm[i] = fnorm[i];
  for (int i = threadIdx.x; i < M * F; i += THREADS) s_fdist[i] = fdist[i];
  for (int i = threadIdx.x; i < M; i += THREADS) {
    s_nv[i] = nvert[i];
    s_nf[i] = nface[i];
  }
  __syncthreads();

  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  float4* w1 = smem4 + team * inst_rows(V);          // hull 1's world vertices
  float4* w2 = w1 + V;                               // hull 2's
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
    const int m1 = meshid[a], m2 = meshid[c];
    const int nv1 = s_nv[m1], nv2 = s_nv[m2];
    // the deepest pass ranks at least 8 vertices (padded ones at BIG)
    const int nx1 = nv1 > 8 ? nv1 : 8, nx2 = nv2 > 8 ? nv2 : 8;
    for (int v = lane; v < nx1; v += T) {
      float o[3];
      to_world(P1, s_verts + ((size_t)m1 * V + v) * 3, o);
      w1[v] = make_float4(o[0], o[1], o[2], 0.f);
    }
    for (int v = lane; v < nx2; v += T) {
      float o[3];
      to_world(P2, s_verts + ((size_t)m2 * V + v) * 3, o);
      w2[v] = make_float4(o[0], o[1], o[2], 0.f);
    }
    __syncwarp();
    int fa, fb;
    const float* fn2 = s_fnorm + (size_t)m2 * F * 3;
    const float* fd2 = s_fdist + (size_t)m2 * F;
    const float* fn1 = s_fnorm + (size_t)m1 * F * 3;
    const float* fd1 = s_fdist + (size_t)m1 * F;
    const float sep2 = team_best_face(w1, nv1, P2, fn2, fd2, s_nf[m2], lane,
                                      fa);                  // face on hull 2
    const float sep1 = team_best_face(w2, nv2, P1, fn1, fd1, s_nf[m1], lane,
                                      fb);                  // face on hull 1
    const bool use2 = sep2 >= sep1;
    float nw[3];
    const float d = use2 ? face_world(P2, fn2 + fa * 3, fd2[fa], nw)
                         : face_world(P1, fn1 + fb * 3, fd1[fb], nw);
    float4* wv = use2 ? w1 : w2;
    const int nv = use2 ? nv1 : nv2, nx = use2 ? nx1 : nx2;
    for (int v = lane; v < nx; v += T) {
      const float4 w = wv[v];
      const float p[3] = {w.x, w.y, w.z};
      wv[v].w = v < nv ? dot3(p, nw) - d : COLLIDE_BIG;
    }
    __syncwarp();
    // vertex of 1 on a face of 2: normal -n2; vertex of 2 on a face of 1: +n1
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
      for (int u = 0; u < nx; ++u) {
        const float du = wv[u].w;
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          rank[j] += (du < dv[j] || (du == dv[j] && u < v0 + j * T)) ? 1 : 0;
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

namespace {

int hh_grid(long total, size_t smem) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hull_hull_kernel,
                                                THREADS, smem);
  const long need = (total + IPB - 1) / IPB;
  const long most = (long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (int)(need < most ? need : most);
}

}  // namespace

// hull tables verts (M, V, 3), fnorm (M, F, 3), fdist (M, F) with each
// row's real vertex and face counts nvert, nface (M,) int32; the rest as
// COLLIDE_PARAMS. Returns cudaErrorInvalidValue where the table does not fit
// one block's shared memory (physics/cuda_collide.py hull_hull_smem raises
// before the call)
extern "C" int collide_hull_hull(const float* pos, const float* quat,
                                 const int* meshid, const float* verts,
                                 const float* fnorm, const float* fdist,
                                 const int* nvert, const int* nface,
                                 const int* g1, const int* g2, float* out_pos,
                                 float* out_nrm, float* out_dist, int B, int n,
                                 int G, int M, int V, int F, void* stream) {
  const size_t smem = smem_bytes(M, V, F);
  if (V < 8 || M < 1 || F < 1 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hull_hull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long total = (long)B * n;
  if (total < 1) return 0;
  const int grid = hh_grid(total, smem);
  hull_hull_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, quat, meshid, verts, fnorm, fdist, nvert, nface, g1, g2, out_pos,
      out_nrm, out_dist, B, n, G, M, V, F);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) for tables of (M, V, F), for the build report
extern "C" int collide_hull_hull_occupancy(int* out, int M, int V, int F) {
  out[1] = THREADS;
  out[2] = (int)smem_bytes(M, V, F);
  cudaError_t err = cudaFuncSetAttribute(
      hull_hull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], hull_hull_kernel, THREADS, out[2]);
}
