// Capsule-hull narrowphase (the pile's capsules against its cylinders and
// the finger pads): five sphere probes along the capsule's axis, each
// scored against every face of the hull as in sphere-hull, 5 slots. The
// probes sit at both ends, at the axis point nearest the mean of the hull's
// real vertices (clamped to the segment) and half-way from it to each end.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// capsule_hull_batched (:739; body _make_capsule_hull_body :632, the masked
// vertex mean :652-656, _sphere_hull_point_rows :593). Bound: bytes (about
// 24 operations per vertex for the mean and 55 per face for the five
// probes, 140 bytes written per instance).
//
// Design: the staging, team, joins and probe loop (probe_faces) of
// collide_hull_team.cuh, which sphere-hull runs with one probe (a team of
// T = 4 lanes per (pair, scenario), the hull table in shared memory per
// block, grid-stride blocks):
//  * the lanes move the row's vertices to world once, into the instance's
//    shared rows; lanes 0-2 each sum one coordinate over them in index
//    order, as the plain version does (a tree sum would change the bits),
//    and the team shares the three sums by shuffles. The padded vertices
//    are moved and added too, times 0: a signed zero, which keeps the sum's
//    bits where it is -0;
//  * every lane forms the five probe centres with the plain operations;
//    then probe_faces<5>: lane l moves its real faces (f = l, l + T, ...
//    below the row's face count) to world once and scores each against all
//    five centres, each probe keeping its first maximum; shuffles within the
//    team take each probe's maximum, ties to the lower face index; the lane
//    that owns slot k (k mod T) moves the winning face to world again by the
//    same operations and writes the slot.
#include "collide_hull_team.cuh"

constexpr int PROBES = 5;
static_assert(T >= 3, "a lane per coordinate of the hull's centre");

__global__ void __launch_bounds__(THREADS)
capsule_hull_kernel(const float* __restrict__ pos,
                    const float* __restrict__ quat,
                    const float* __restrict__ size,
                    const int* __restrict__ meshid,
                    const float* __restrict__ verts,
                    const float* __restrict__ fnorm,
                    const float* __restrict__ fdist,
                    const int* __restrict__ nvert,
                    const int* __restrict__ nface,
                    const int* __restrict__ g1, const int* __restrict__ g2,
                    float* __restrict__ out_pos, float* __restrict__ out_nrm,
                    float* __restrict__ out_dist, int B, int n, int G, int M,
                    int V, int F) {
  extern __shared__ float4 smem4[];
  const Table tab = stage_table(
      reinterpret_cast<float*>(smem4 + IPB * inst_rows(0, V)), verts, fnorm,
      fdist, nvert, nface, M, V, F, true, true);
  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  float4* wv = smem4 + team * inst_rows(0, V);     // the hull's world vertices
  const unsigned m = team_mask();
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
    const int nv = tab.nv[m2];
    for (int v = lane; v < V; v += T) {
      float o[3];
      to_world(P2, tab.verts + ((size_t)m2 * V + v) * 3, o);
      wv[v] = make_float4(o[0], o[1], o[2], 0.f);
    }
    __syncwarp();
    // collision.capsule_hull's centre: the masked sum in index order, lane
    // r < 3 summing coordinate r (a real vertex's term is the vertex, as
    // times 1; a padded one's times 0), shared by shuffles
    float s = 0.f;
    if (lane < 3) {
      const float* col = reinterpret_cast<const float*>(wv) + lane;
      s = nv > 0 ? col[0] : col[0] * 0.f;
      for (int v = 1; v < nv; ++v) s = s + col[v * 4];
      for (int v = nv > 1 ? nv : 1; v < V; ++v) s = s + col[v * 4] * 0.f;
    }
    const float acc[3] = {__shfl_sync(m, s, 0, T), __shfl_sync(m, s, 1, T),
                          __shfl_sync(m, s, 2, T)};
    __syncwarp();        // the rows are written again by the next instance
    const float den = fmaxf((float)nv, 1.f);
    const float u[3] = {P1.R[0][2], P1.R[1][2], P1.R[2][2]};
    const float rad = size[(size_t)a * 3], hl = size[(size_t)a * 3 + 1];
    const float dc[3] = {acc[0] / den - P1.p[0], acc[1] / den - P1.p[1],
                         acc[2] / den - P1.p[2]};
    const float tmid = fminf(fmaxf(dot3(dc, u), -hl), hl);
    const float ts[PROBES] = {-hl, hl, tmid, 0.5f * (hl + tmid),
                              0.5f * (-hl + tmid)};
    float ctr[PROBES][3];
#pragma unroll
    for (int k = 0; k < PROBES; ++k)
#pragma unroll
      for (int r = 0; r < 3; ++r) ctr[k][r] = P1.p[r] + u[r] * ts[k];
    probe_faces<PROBES>(tab, m2, F, P2, ctr, rad, lane, live, inst,
                        out_pos, out_nrm, out_dist);
  }
}

// capsule sizes size (G, 3) (radius, half-length) of geoms g1; hull tables
// verts (M, V, 3), fnorm (M, F, 3), fdist (M, F) of geoms g2 with each
// row's real vertex and face counts nvert, nface (M,) int32; the rest as
// COLLIDE_PARAMS. Returns cudaErrorInvalidValue where the table does not
// fit one block's shared memory (physics/cuda_collide.py raises before the
// call)
extern "C" int collide_capsule_hull(const float* pos, const float* quat,
                                    const float* size, const int* meshid,
                                    const float* verts, const float* fnorm,
                                    const float* fdist, const int* nvert,
                                    const int* nface, const int* g1,
                                    const int* g2, float* out_pos,
                                    float* out_nrm, float* out_dist, int B,
                                    int n, int G, int M, int V, int F,
                                    void* stream) {
  const size_t smem = smem_bytes(M, V, F, 0, true);
  int grid = 0;
  const int err = team_grid(capsule_hull_kernel, (long)B * n, M, V, F, smem,
                            grid);
  if (err != 0 || grid == 0) return err;
  capsule_hull_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, quat, size, meshid, verts, fnorm, fdist, nvert, nface, g1, g2,
      out_pos, out_nrm, out_dist, B, n, G, M, V, F);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) for tables of (M, V, F), for the build report
extern "C" int collide_capsule_hull_occupancy(int* out, int M, int V,
                                              int F) {
  return team_occupancy(capsule_hull_kernel, out,
                        smem_bytes(M, V, F, 0, true));
}
