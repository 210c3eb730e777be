// Box-box narrowphase: one thread per (pair, scenario) computes the 8
// corners of each box tested against the other (the 4 deepest of each way)
// and the 15-axis edge SAT contact, 9 slots.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/physics/pallas_collide.py
// box_box_batched (:675; body _make_box_box_body :323, edge SAT
// _box_box_edge_rows :351). Bound: bytes at the pile's shapes (about 1.6k
// f32 operations per instance against 28 bytes read and 252 written), so
// the outputs' writes set the floor; the design keeps every intermediate in
// registers and reads each pose once per instance.
#include "collide_common.cuh"

__global__ void box_box_kernel(COLLIDE_PARAMS) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * n) return;
  const int b = tid / n;
  const int a = g1[tid], c = g2[tid];
  Pose P1, P2;
  load_pose(pos, quat, b, G, a, P1);
  load_pose(pos, quat, b, G, c, P2);
  const float* s1 = size + (size_t)a * 3;
  const float* s2 = size + (size_t)c * 3;
  const float sa[3] = {s1[0], s1[1], s1[2]}, sb[3] = {s2[0], s2[1], s2[2]};
  const size_t slot0 = (size_t)tid * 9;
  // corners of 1 inside 2 (normal(1->2) = -n) and of 2 inside 1 (+n)
#pragma unroll
  for (int way = 0; way < 2; ++way) {
    const Pose& Pc = way == 0 ? P1 : P2;
    const Pose& Pb = way == 0 ? P2 : P1;
    const float* sc = way == 0 ? sa : sb;
    const float* sbox = way == 0 ? sb : sa;
    TopK<4> top;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float cw[3], p[3], nw[3];
      box_corner(Pc, sc, k, cw);
      top.push(corner_in_box(cw, Pb, sbox, p, nw), k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float cw[3], p[3], nw[3];
      box_corner(Pc, sc, top.i[j], cw);
      const float d = corner_in_box(cw, Pb, sbox, p, nw);
      if (way == 0) { nw[0] = -nw[0]; nw[1] = -nw[1]; nw[2] = -nw[2]; }
      store(out_pos, out_nrm, out_dist, slot0 + way * 4 + j, p, nw, d);
    }
  }
  float mid[3], L[3];
  const float d = box_box_edge(P1, sa, P2, sb, mid, L);
  store(out_pos, out_nrm, out_dist, slot0 + 8, mid, L, d);
}

COLLIDE_ENTRY(box_box)
