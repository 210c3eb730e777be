// Capsule-hull narrowphase (the pile's capsules against its cylinders and
// the finger pads): five sphere probes along the capsule's axis, each
// scored against every face of the hull as in sphere-hull, 5 slots. The
// probes sit at both ends, at the axis point nearest the mean of the hull's
// real vertices (clamped to the segment) and half-way from it to each end.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// capsule_hull_batched (:739; body _make_capsule_hull_body :632, the masked
// vertex mean :652-656, _sphere_hull_point_rows :593). Bound: bytes (about
// 18 operations per vertex for the mean and 5 x 8 per face, 140 bytes
// written per instance); the vertex mean is summed in index order as the
// plain version sums it, and each face is moved to world once for all five
// probes.
#include "collide_common.cuh"

__global__ void capsule_hull_kernel(COLLIDE_PARAMS) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * n) return;
  const int b = tid / n;
  const int a = g1[tid], c = g2[tid];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const Hull h2 = table_hull(verts, vmask, fnorm, fdist, meshid[c], V, F);
  float acc[3], cnt = 0.f;
  for (int v = 0; v < h2.V; ++v) {
    float vl[3], vw[3];
    const float mk = hull_vert(h2, v, vl) ? 1.f : 0.f;
    to_world(P2, vl, vw);
#pragma unroll
    for (int r = 0; r < 3; ++r) acc[r] = v == 0 ? vw[r] * mk
                                                 : acc[r] + vw[r] * mk;
    cnt += mk;
  }
  const float den = fmaxf(cnt, 1.f);
  const float u[3] = {P1.R[0][2], P1.R[1][2], P1.R[2][2]};
  const float rad = size[(size_t)a * 3], hl = size[(size_t)a * 3 + 1];
  const float dc[3] = {acc[0] / den - P1.p[0], acc[1] / den - P1.p[1],
                       acc[2] / den - P1.p[2]};
  const float tmid = fminf(fmaxf(dot3(dc, u), -hl), hl);
  const float ts[5] = {-hl, hl, tmid, 0.5f * (hl + tmid),
                       0.5f * (-hl + tmid)};
  float ctr[5][3];
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int r = 0; r < 3; ++r) ctr[k][r] = P1.p[r] + u[r] * ts[k];
  sphere_probes<5>(h2, P2, ctr, rad, out_pos, out_nrm, out_dist,
                   (size_t)tid * 5);
}

COLLIDE_ENTRY(capsule_hull)
