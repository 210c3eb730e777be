// Shared device code of the six narrowphase kernels (collide_*.cu): small
// vector helpers, poses and the output store, and box-box's parameter list
// and launch. The kernels keep their own bodies: box-box in
// collide_box_box.cu; hull-hull, box-hull and plane-hull in
// collide_hull_team.cuh, whose staging, team and joins sphere-hull and
// capsule-hull (collide_sphere_hull.cu, collide_capsule_hull.cu) share with
// its probe loop.
//
// Each body computes one (pair, scenario), with the arithmetic,
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
//   verts (M, V, 3), fnorm (M, F, 3), fdist (M, F)
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
// box-box's parameter list, launch shape and C entry point: pairs of one
// scenario on neighbouring teams (the hull kernels have their own entries)
// ---------------------------------------------------------------------------

#define COLLIDE_THREADS 128

#define COLLIDE_PARAMS                                                       \
  const float *__restrict__ pos, const float *__restrict__ quat,              \
      const float *__restrict__ size, const int *__restrict__ meshid,         \
      const float *__restrict__ verts, const float *__restrict__ fnorm,       \
      const float *__restrict__ fdist,                                        \
      const int *__restrict__ g1, const int *__restrict__ g2,                 \
      float *__restrict__ out_pos, float *__restrict__ out_nrm,               \
      float *__restrict__ out_dist, int B, int n, int G, int V, int F

#ifndef COLLIDE_LAUNCH
#define COLLIDE_LAUNCH(kernel, blocks, stream, ...)                          \
  kernel<<<(blocks), COLLIDE_THREADS, 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// extern "C" int collide_<name>(...): launches <name>_kernel on ``stream``
// with ``ipb`` (pair, scenario) instances per block and returns
// cudaGetLastError()
#define COLLIDE_ENTRY_IPB(name, ipb)                                         \
  extern "C" int collide_##name(                                             \
      const float* pos, const float* quat, const float* size,                \
      const int* meshid, const float* verts, const float* fnorm,             \
      const float* fdist, const int* g1, const int* g2,                      \
      float* out_pos, float* out_nrm, float* out_dist, int B, int n, int G,  \
      int V, int F, void* stream) {                                          \
    COLLIDE_LAUNCH(name##_kernel, (B * n + (ipb) - 1) / (ipb), stream,       \
                   pos, quat, size, meshid, verts, fnorm, fdist, g1, g2,     \
                   out_pos, out_nrm, out_dist, B, n, G, V, F);               \
    return (int)cudaGetLastError();                                          \
  }
