// Box-hull narrowphase: a box as an 8-vertex / 6-face hull against a hull
// (box objects, fingers and bin walls against the pile's cylinders), the
// hull-hull body of collide_common.cuh, 8 slots.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// box_hull_batched (:703; _make_hull_hull_body with box1=True,
// _box_as_hull :511). Bound: operations (about 2 x 8 x 18 + 6 x 32 vertex-
// face products per instance); the box's vertices and faces are made from
// its size in registers, the hull's read by id.
#include "collide_common.cuh"

__global__ void box_hull_kernel(COLLIDE_PARAMS) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * n) return;
  const int b = tid / n;
  const int a = g1[tid], c = g2[tid];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const Hull h1 = box_hull_of(size + (size_t)a * 3);
  const Hull h2 = table_hull(verts, vmask, fnorm, fdist, meshid[c], V, F);
  hull_hull(h1, P1, h2, P2, out_pos, out_nrm, out_dist, (size_t)tid * 8);
}

COLLIDE_ENTRY(box_hull)
