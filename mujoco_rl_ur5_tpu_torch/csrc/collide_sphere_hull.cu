// Sphere-hull narrowphase (the pile's spheres against its cylinders and the
// finger pads): one thread per (pair, scenario) scores the sphere's center
// against every face of the hull in world and writes one contact along the
// face of largest signed distance, 1 slot.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// sphere_hull_batched (:727; body _make_sphere_hull_body :611, face loop
// _sphere_hull_point_rows :593, first-max rule _running_argmax :189).
// Bound: bytes (about 25 f32 operations per face, 28 bytes written per
// instance); the hull's faces are read by id from the model's small table
// (L1/L2 resident) instead of the TPU kernel's per-pair copies.
#include "collide_common.cuh"

__global__ void sphere_hull_kernel(COLLIDE_PARAMS) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * n) return;
  const int b = tid / n;
  const int a = g1[tid], c = g2[tid];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const Hull h2 = table_hull(verts, vmask, fnorm, fdist, meshid[c], V, F);
  const float ctr[1][3] = {{P1.p[0], P1.p[1], P1.p[2]}};
  sphere_probes<1>(h2, P2, ctr, size[(size_t)a * 3], out_pos, out_nrm,
                   out_dist, (size_t)tid);
}

COLLIDE_ENTRY(sphere_hull)
