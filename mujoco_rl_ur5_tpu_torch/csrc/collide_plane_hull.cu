// Plane-hull narrowphase: one thread per (pair, scenario) writes the 8 hull
// vertices deepest below the plane (the floor against the pile's
// cylinders), 8 slots.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// plane_hull_batched (:715; body _make_plane_hull_body :564). Bound: bytes
// (about 20 f32 operations per vertex against 224 bytes written per
// instance); the vertices are read by id and the top 8 kept in registers.
#include "collide_common.cuh"

__global__ void plane_hull_kernel(COLLIDE_PARAMS) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * n) return;
  const int b = tid / n;
  const int a = g1[tid], c = g2[tid];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const Hull h2 = table_hull(verts, vmask, fnorm, fdist, meshid[c], V, F);
  const float nz[3] = {P1.R[0][2], P1.R[1][2], P1.R[2][2]};  // plane z
  const float off = dot3(nz, P1.p);
  TopK<8> top;
  for (int v = 0; v < h2.V; ++v) {
    float vl[3], vw[3];
    const bool real = hull_vert(h2, v, vl);
    to_world(P2, vl, vw);
    top.push(real ? dot3(vw, nz) - off : COLLIDE_BIG, v);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float vl[3], vw[3], p[3];
    hull_vert(h2, top.i[k], vl);
    to_world(P2, vl, vw);
    const float dk = top.d[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) p[r] = vw[r] - 0.5f * dk * nz[r];
    store(out_pos, out_nrm, out_dist, (size_t)tid * 8 + k, p, nz, dk);
  }
}

COLLIDE_ENTRY(plane_hull)
