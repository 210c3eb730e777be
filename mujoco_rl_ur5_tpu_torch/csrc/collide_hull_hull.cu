// Hull-hull narrowphase (cylinders as 16-gon prisms in the pile): one
// thread per (pair, scenario) finds the least-overlap face over both hulls'
// faces and writes the 8 deepest vertices of the other hull along it.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// hull_hull_batched (:689; body _make_hull_hull_body :527, _best_face :465,
// _deepest8 :484). Bound: operations (2 V F vertex-face products, about 14k
// f32 operations per instance at V=32, F=18); the hull tables are read by
// id from the model's small table (L1/L2 resident) instead of the TPU
// kernel's per-pair copies, and vertices are transformed on the fly instead
// of being held (96 registers a hull).
#include "collide_common.cuh"

__global__ void hull_hull_kernel(COLLIDE_PARAMS) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * n) return;
  const int b = tid / n;
  const int a = g1[tid], c = g2[tid];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const int m1 = meshid[a], m2 = meshid[c];
  const Hull h1 = table_hull(verts, vmask, fnorm, fdist, m1, V, F);
  const Hull h2 = table_hull(verts, vmask, fnorm, fdist, m2, V, F);
  hull_hull(h1, P1, h2, P2, out_pos, out_nrm, out_dist, (size_t)tid * 8);
}

COLLIDE_ENTRY(hull_hull)
