// Hull-hull narrowphase (cylinders as 16-gon prisms, mesh finger pads): per
// (pair, scenario) the least-overlap face over both hulls' faces, then the 8
// deepest vertices of the other hull along it, on the team body of
// collide_hull_team.cuh (its design notes are there).
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// hull_hull_batched (:689; body _make_hull_hull_body :527, _best_face :465,
// _deepest8 :484). Bound: operations (2 V F vertex-face products over the
// real vertices and faces, about 9.2k f32 operations per instance on the
// object pile), then the 7 output floats of 8 slots.
#include "collide_hull_team.cuh"

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
  hull_team<HULL1>(smem4, pos, quat, nullptr, meshid, verts, fnorm, fdist,
                   nvert, nface, g1, g2, out_pos, out_nrm, out_dist, B, n, G,
                   M, V, F);
}

// hull tables verts (M, V, 3), fnorm (M, F, 3), fdist (M, F) with each
// row's real vertex and face counts nvert, nface (M,) int32; the rest as
// COLLIDE_PARAMS. Returns cudaErrorInvalidValue where the table does not fit
// one block's shared memory (physics/cuda_collide.py raises before the call)
extern "C" int collide_hull_hull(const float* pos, const float* quat,
                                 const int* meshid, const float* verts,
                                 const float* fnorm, const float* fdist,
                                 const int* nvert, const int* nface,
                                 const int* g1, const int* g2, float* out_pos,
                                 float* out_nrm, float* out_dist, int B, int n,
                                 int G, int M, int V, int F, void* stream) {
  const size_t smem = hull_team_smem(HULL1, M, V, F);
  int grid = 0;
  const int err = team_grid(hull_hull_kernel, (long)B * n, M, V, F, smem,
                            grid);
  if (err != 0 || grid == 0) return err;
  hull_hull_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, quat, meshid, verts, fnorm, fdist, nvert, nface, g1, g2, out_pos,
      out_nrm, out_dist, B, n, G, M, V, F);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) for tables of (M, V, F), for the build report
extern "C" int collide_hull_hull_occupancy(int* out, int M, int V, int F) {
  return team_occupancy(hull_hull_kernel, out,
                        hull_team_smem(HULL1, M, V, F));
}
