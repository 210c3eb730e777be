// Box-hull narrowphase: a box as an 8-vertex / 6-face hull against a hull
// (box objects, fingers and bin walls against the pile's cylinders and the
// finger pads), 8 slots, on the team body of collide_hull_team.cuh (its
// design notes are there) with side 1 made from the box's size.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// box_hull_batched (:703; _make_hull_hull_body with box1=True,
// _box_as_hull :511). Bound: operations (8 F + 6 V vertex-face products
// over the hull's real vertices and faces, about 3.4k f32 operations per
// instance against a cylinder's prism), then the 7 output floats of 8
// slots.
#include "collide_hull_team.cuh"

__global__ void __launch_bounds__(THREADS)
box_hull_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                const float* __restrict__ size,
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
  hull_team<BOX1>(smem4, pos, quat, size, meshid, verts, fnorm, fdist, nvert,
                  nface, g1, g2, out_pos, out_nrm, out_dist, B, n, G, M, V,
                  F);
}

// box sizes size (G, 3) of geoms g1; hull tables verts (M, V, 3), fnorm
// (M, F, 3), fdist (M, F) of geoms g2 with each row's real vertex and face
// counts nvert, nface (M,) int32; the rest as COLLIDE_PARAMS. Returns
// cudaErrorInvalidValue where the table does not fit one block's shared
// memory (physics/cuda_collide.py raises before the call)
extern "C" int collide_box_hull(const float* pos, const float* quat,
                                const float* size, const int* meshid,
                                const float* verts, const float* fnorm,
                                const float* fdist, const int* nvert,
                                const int* nface, const int* g1, const int* g2,
                                float* out_pos, float* out_nrm,
                                float* out_dist, int B, int n, int G, int M,
                                int V, int F, void* stream) {
  const size_t smem = hull_team_smem(BOX1, M, V, F);
  int grid = 0;
  const int err = team_grid(box_hull_kernel, (long)B * n, M, V, F, smem,
                            grid);
  if (err != 0 || grid == 0) return err;
  box_hull_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, quat, size, meshid, verts, fnorm, fdist, nvert, nface, g1, g2,
      out_pos, out_nrm, out_dist, B, n, G, M, V, F);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) for tables of (M, V, F), for the build report
extern "C" int collide_box_hull_occupancy(int* out, int M, int V, int F) {
  return team_occupancy(box_hull_kernel, out,
                        hull_team_smem(BOX1, M, V, F));
}
