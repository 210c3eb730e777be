// Sphere-hull narrowphase (the pile's spheres against its cylinders and the
// finger pads): the sphere's centre scored against every real face of the
// hull in world, one contact along the face of largest signed distance, 1
// slot.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// sphere_hull_batched (:727; body _make_sphere_hull_body :611, face loop
// _sphere_hull_point_rows :593, first-max rule _running_argmax :189).
// Bound: bytes (about 27 f32 operations per face against 28 bytes written
// and the two poses read per instance). On the H100 the kernel is bound by
// its instructions instead: each lane of a team repeats the hull's pose,
// the pair's loads, the join and the contact, which for one probe costs
// about what skipping the padded faces saves (PERF.md).
//
// Design: capsule-hull's loop with one probe, on the staging, team, joins
// and probe loop (probe_faces<1>) of collide_hull_team.cuh: a team of
// T = 4 lanes per (pair, scenario), grid-stride blocks. The block stages
// the hull table's faces and each row's counts in shared memory once and
// no vertices (the kernel reads none, so it keeps no per-instance rows
// either: 16 bytes per face and 8 per row, 6,072 bytes at the object
// pile's 11 rows of 34 faces); lane l moves its real faces to world once and
// scores each against the centre, the team's first maxima are joined by
// shuffles (ties to the lower face) and lane 0 moves the winning face again
// and writes the slot. Every value keeps the plain version's operations
// (built with -fmad=false), so every output equals it to the bit.
#include "collide_hull_team.cuh"

__global__ void __launch_bounds__(THREADS)
sphere_hull_kernel(const float* __restrict__ pos,
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
  const Table tab = stage_table(reinterpret_cast<float*>(smem4), verts,
                                fnorm, fdist, nvert, nface, M, V, F, false,
                                true);
  const int lane = threadIdx.x % T, team = threadIdx.x / T;
  const long total = (long)B * n;
  // every thread of the block runs the same iterations: the team's
  // shuffles need all their lanes
  for (long base = (long)blockIdx.x * IPB; base < total;
       base += (long)gridDim.x * IPB) {
    const long inst = base + team;
    const bool live = inst < total;
    const long ii = live ? inst : total - 1;
    const int b = (int)(ii / n);
    const int a = g1[ii], c = g2[ii];
    Pose P2;
    load_pose(pos, quat, b, G, c, P2);
    const float* p1 = pos + ((size_t)b * G + a) * 3;
    const float ctr[1][3] = {{p1[0], p1[1], p1[2]}};
    probe_faces<1>(tab, meshid[c], F, P2, ctr, size[(size_t)a * 3], lane,
                   live, inst, out_pos, out_nrm, out_dist);
  }
}

// the shared memory of a block: the table's faces and each row's counts
__host__ __device__ constexpr size_t sphere_smem(int M, int V, int F) {
  return table_floats(M, V, F, false, true) * sizeof(float);
}

// sphere sizes size (G, 3) (radius first) of geoms g1; hull tables fnorm
// (M, F, 3), fdist (M, F) of geoms g2 with each row's real face count
// nface (M,) int32 (verts and nvert are not read: the kernel takes
// capsule-hull's argument list); the rest as COLLIDE_PARAMS. Returns
// cudaErrorInvalidValue where the table does not fit one block's shared
// memory (physics/cuda_collide.py raises before the call)
extern "C" int collide_sphere_hull(const float* pos, const float* quat,
                                   const float* size, const int* meshid,
                                   const float* verts, const float* fnorm,
                                   const float* fdist, const int* nvert,
                                   const int* nface, const int* g1,
                                   const int* g2, float* out_pos,
                                   float* out_nrm, float* out_dist, int B,
                                   int n, int G, int M, int V, int F,
                                   void* stream) {
  const size_t smem = sphere_smem(M, V, F);
  int grid = 0;
  const int err = team_grid(sphere_hull_kernel, (long)B * n, M, V, F, smem,
                            grid);
  if (err != 0 || grid == 0) return err;
  sphere_hull_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      pos, quat, size, meshid, verts, fnorm, fdist, nvert, nface, g1, g2,
      out_pos, out_nrm, out_dist, B, n, G, M, V, F);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads per block and dynamic shared memory per
// block (bytes) for tables of (M, V, F), for the build report
extern "C" int collide_sphere_hull_occupancy(int* out, int M, int V,
                                             int F) {
  return team_occupancy(sphere_hull_kernel, out, sphere_smem(M, V, F));
}
