// Plane-hull narrowphase: the 8 hull vertices deepest below the plane (the
// floor against the pile's cylinders and the finger pads), 8 slots, on the
// team body of collide_hull_team.cuh (its design notes are there) with a
// plane on side 1: no face pass, the winning face the plane's z axis, and
// the body's deepest pass over the hull's real vertices, each moved to world
// once and written from the values its lane holds.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// plane_hull_batched (:715; body _make_plane_hull_body :564). Bound: bytes
// (about 25 f32 operations per vertex against 224 bytes written per
// instance). The kernel reads the table's vertices and vertex counts only;
// it takes hull-hull's argument list.
#include "collide_hull_team.cuh"

__global__ void __launch_bounds__(THREADS)
plane_hull_kernel(const float* __restrict__ pos,
                  const float* __restrict__ quat,
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
  hull_team<PLANE1>(smem4, pos, quat, nullptr, meshid, verts, fnorm, fdist,
                    nvert, nface, g1, g2, out_pos, out_nrm, out_dist, B, n,
                    G, M, V, F);
}

// plane geoms g1; hull tables verts (M, V, 3) with each row's real vertex
// count nvert (M,) int32 of geoms g2 (fnorm, fdist and nface are not read);
// the rest as COLLIDE_PARAMS. Returns cudaErrorInvalidValue where the table
// does not fit one block's shared memory (physics/cuda_collide.py raises
// before the call)
extern "C" int collide_plane_hull(const float* pos, const float* quat,
                                  const int* meshid, const float* verts,
                                  const float* fnorm, const float* fdist,
                                  const int* nvert, const int* nface,
                                  const int* g1, const int* g2,
                                  float* out_pos, float* out_nrm,
                                  float* out_dist, int B, int n, int G, int M,
                                  int V, int F, void* stream) {
  const size_t smem = hull_team_smem(PLANE1, M, V, F);
  int grid = 0;
  const int err = team_grid(plane_hull_kernel, (long)B * n, M, V, F, smem,
                            grid);
  if (err != 0 || grid == 0) return err;
  plane_hull_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, quat, meshid, verts, fnorm, fdist, nvert, nface, g1, g2, out_pos,
      out_nrm, out_dist, B, n, G, M, V, F);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) for tables of (M, V, F), for the build report
extern "C" int collide_plane_hull_occupancy(int* out, int M, int V, int F) {
  return team_occupancy(plane_hull_kernel, out,
                        hull_team_smem(PLANE1, M, V, F));
}
