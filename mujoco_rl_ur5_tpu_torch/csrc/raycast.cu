// Z-buffer ray cast of the RGB-D observation: one thread per (frame, pixel)
// runs a strict running minimum of the hit distance over the frame's visible
// geoms (plane, sphere, box, capsule, cylinder, convex hull) and writes the
// nearest hit's distance s*, geom id and world normal.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/render/pallas_raycast.py _kernel
// (:50, launched by _cast :276 and cast_rays :305, its operands packed by
// pack_geoms :236). Its per-scene generated straight-line code becomes one
// loop over the geoms with a switch on each geom's branch code: the threads
// of a block belong to one frame, so every branch is uniform in a warp. The
// per-frame geom table and the hull faces are small and read from global
// memory through L1. Bound: operations (about 30-40 f32 operations per ray
// and geom, ~25 per hull face); bytes are the rays in and 20 bytes out per
// pixel. Every intersection repeats render/raycast.py's plain version
// operation for operation (built with -fmad=false), including its
// normalisation n / max(|n|, 1e-12), the strict s < s* update (of equal hits
// the geom listed first wins) and the miss sentinel BIG = 1e10.
//
// Operands (float32 unless noted, row-major):
//   par (B, G, 16)   per frame and geom: R (world from local) 9, R^T (cam - p)
//                    3, size 3, unused 1
//   code (G, 2) int32  branch (0 plane, 1 sphere, 2 box, 3 capsule,
//                    4 cylinder, 5 hull, -1 hidden) and hull face row
//   faces (M, F, 4)  hull faces: outward normal 3, offset (n . x <= d)
//   dirs (N, 3)      unit ray directions in world, from the camera
//   out_s (B, N), out_gid (B, N) int32, out_n (B, N, 3)
#include <cuda_runtime.h>

#define RAYCAST_BIG 1e10f
#define RAYCAST_EPS 1e-12f
#define RAYCAST_THREADS 128

#ifndef RAYCAST_LAUNCH
#define RAYCAST_LAUNCH(kernel, gx, gy, stream, ...)                         \
  kernel<<<dim3((gx), (gy)), RAYCAST_THREADS, 0, (cudaStream_t)(stream)>>>( \
      __VA_ARGS__)
#endif

__device__ __forceinline__ float rc_sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ void rc_unit(float x, float y, float z, float* n) {
  const float len = fmaxf(sqrtf(x * x + y * y + z * z), RAYCAST_EPS);
  n[0] = x / len;
  n[1] = y / len;
  n[2] = z / len;
}

struct LocalRay {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float ray_plane(const LocalRay& r, float* n) {
  float s = fabsf(r.dz) > RAYCAST_EPS ? -r.oz / r.dz : RAYCAST_BIG;
  s = (s > 0.f && r.oz > 0.f) ? s : RAYCAST_BIG;
  n[0] = 0.f;
  n[1] = 0.f;
  n[2] = 1.f;
  return s;
}

__device__ __forceinline__ float ray_sphere(const LocalRay& r, float rad,
                                            float* n) {
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float b = 2.f * (r.ox * r.dx + r.oy * r.dy + r.oz * r.dz);
  const float c = (r.ox * r.ox + r.oy * r.oy + r.oz * r.oz) - rad * rad;
  const float disc = b * b - 4.f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  float s = (-b - sq) / (2.f * a);
  s = (disc > 0.f && s > 0.f) ? s : RAYCAST_BIG;
  rc_unit(r.ox + s * r.dx, r.oy + s * r.dy, r.oz + s * r.dz, n);
  return s;
}

__device__ __forceinline__ float ray_box(const LocalRay& r, const float* h,
                                         float* n) {
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  float tmin[3], tmax[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dinv = fabsf(d[a]) > RAYCAST_EPS ? 1.f / d[a] : RAYCAST_BIG;
    const float t1 = (-h[a] - o[a]) * dinv, t2 = (h[a] - o[a]) * dinv;
    tmin[a] = fminf(t1, t2);
    tmax[a] = fmaxf(t1, t2);
  }
  const float t_in = fmaxf(fmaxf(tmin[0], tmin[1]), tmin[2]);
  const float t_out = fminf(fminf(tmax[0], tmax[1]), tmax[2]);
  const bool hit = t_in <= t_out && t_out > 0.f && t_in > 0.f;
  const bool is0 = tmin[0] >= tmin[1] && tmin[0] >= tmin[2];
  const bool is1 = !is0 && tmin[1] >= tmin[2];
  const bool is2 = !is0 && !is1;
  n[0] = is0 ? -rc_sign(d[0]) : 0.f;
  n[1] = is1 ? -rc_sign(d[1]) : 0.f;
  n[2] = is2 ? -rc_sign(d[2]) : 0.f;
  return hit ? t_in : RAYCAST_BIG;
}

__device__ __forceinline__ float ray_cyl_side(const LocalRay& r, float rad) {
  const float a = r.dx * r.dx + r.dy * r.dy;
  const float b = 2.f * (r.ox * r.dx + r.oy * r.dy);
  const float c = (r.ox * r.ox + r.oy * r.oy) - rad * rad;
  const float disc = b * b - 4.f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float s = a > RAYCAST_EPS
                      ? (-b - sq) / (2.f * fmaxf(a, RAYCAST_EPS))
                      : RAYCAST_BIG;
  return (disc > 0.f && s > 0.f) ? s : RAYCAST_BIG;
}

__device__ __forceinline__ float ray_cap(const LocalRay& r, float rad,
                                         float cz) {
  const float ocz = r.oz - cz;
  const float b = 2.f * (r.ox * r.dx + r.oy * r.dy + ocz * r.dz);
  const float c = (r.ox * r.ox + r.oy * r.oy + ocz * ocz) - rad * rad;
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float disc = b * b - 4.f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float s = (-b - sq) / (2.f * a);
  const bool ok = disc > 0.f && s > 0.f && (ocz + s * r.dz) * rc_sign(cz) > 0.f;
  return ok ? s : RAYCAST_BIG;
}

__device__ __forceinline__ float ray_capsule(const LocalRay& r, float rad,
                                             float hl, float* n) {
  float s_side = ray_cyl_side(r, rad);
  s_side = fabsf(r.oz + s_side * r.dz) <= hl ? s_side : RAYCAST_BIG;
  const float s = fminf(s_side, fminf(ray_cap(r, rad, hl),
                                      ray_cap(r, rad, -hl)));
  const float pz = r.oz + s * r.dz;
  rc_unit(r.ox + s * r.dx, r.oy + s * r.dy, pz - fminf(fmaxf(pz, -hl), hl),
          n);
  return s;
}

__device__ __forceinline__ float ray_cylinder(const LocalRay& r, float rad,
                                              float hl, float* n) {
  float s_side = ray_cyl_side(r, rad);
  s_side = fabsf(r.oz + s_side * r.dz) <= hl ? s_side : RAYCAST_BIG;
  const float sgn = -rc_sign(r.dz);
  float s_disc = fabsf(r.dz) > RAYCAST_EPS ? (sgn * hl - r.oz) / r.dz
                                           : RAYCAST_BIG;
  const float px = r.ox + s_disc * r.dx, py = r.oy + s_disc * r.dy;
  s_disc = (s_disc > 0.f && px * px + py * py <= rad * rad) ? s_disc
                                                            : RAYCAST_BIG;
  const float s = fminf(s_side, s_disc);
  float side[3];
  rc_unit(r.ox + s * r.dx, r.oy + s * r.dy, 0.f, side);
  const bool disc_wins = s_disc < s_side;
  n[0] = disc_wins ? 0.f : side[0];
  n[1] = disc_wins ? 0.f : side[1];
  n[2] = disc_wins ? sgn : 0.f;
  return s;
}

// convex polytope {n . x <= d}: the last entering plane against the first
// exiting one; a padded face (normal 0, offset 1e10) imposes nothing
__device__ __forceinline__ float ray_hull(const LocalRay& r,
                                          const float* __restrict__ face,
                                          int F, float* n) {
  float t_in = -RAYCAST_BIG, t_out = RAYCAST_BIG;
  bool outside = false;
  n[0] = n[1] = n[2] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float fx = face[4 * f], fy = face[4 * f + 1], fz = face[4 * f + 2];
    const float fd = face[4 * f + 3];
    const float nd = fx * r.dx + fy * r.dy + fz * r.dz;
    const float no = fx * r.ox + fy * r.oy + fz * r.oz;
    const float t = fabsf(nd) > RAYCAST_EPS ? (fd - no) / nd : 0.f;
    const float t_ent = nd < -RAYCAST_EPS ? t : -RAYCAST_BIG;
    if (t_ent > t_in) {
      n[0] = fx;
      n[1] = fy;
      n[2] = fz;
    }
    t_in = fmaxf(t_in, t_ent);
    t_out = fminf(t_out, nd > RAYCAST_EPS ? t : RAYCAST_BIG);
    outside = outside || (fabsf(nd) <= RAYCAST_EPS && no > fd);
  }
  const bool hit = t_in <= t_out && t_in > 0.f && !outside;
  return hit ? t_in : RAYCAST_BIG;
}

__global__ void raycast_kernel(const float* __restrict__ par,
                               const int* __restrict__ code,
                               const float* __restrict__ faces,
                               const float* __restrict__ dirs,
                               float* __restrict__ out_s,
                               int* __restrict__ out_gid,
                               float* __restrict__ out_n, int B, int N,
                               int G, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= N || b >= B) return;
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  float s_min = RAYCAST_BIG, nw[3] = {0.f, 0.f, 0.f};
  int gid = 0;
  for (int g = 0; g < G; ++g) {
    const int branch = code[2 * g];
    if (branch < 0) continue;  // hidden: the same for every thread
    const float* p = par + ((size_t)b * G + g) * 16;
    const float R[9] = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
    LocalRay r;
    r.ox = p[9];
    r.oy = p[10];
    r.oz = p[11];
    r.dx = R[0] * dx + R[3] * dy + R[6] * dz;  // R^T d
    r.dy = R[1] * dx + R[4] * dy + R[7] * dz;
    r.dz = R[2] * dx + R[5] * dy + R[8] * dz;
    float s, nl[3];
    switch (branch) {
      case 0:
        s = ray_plane(r, nl);
        break;
      case 1:
        s = ray_sphere(r, p[12], nl);
        break;
      case 2:
        s = ray_box(r, p + 12, nl);
        break;
      case 3:
        s = ray_capsule(r, p[12], p[13], nl);
        break;
      case 4:
        s = ray_cylinder(r, p[12], p[13], nl);
        break;
      default:
        s = ray_hull(r, faces + (size_t)code[2 * g + 1] * F * 4, F, nl);
        break;
    }
    if (s < s_min) {
      s_min = s;
      gid = g;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        nw[k] = R[3 * k] * nl[0] + R[3 * k + 1] * nl[1] + R[3 * k + 2] * nl[2];
    }
  }
  const size_t o = (size_t)b * N + i;
  out_s[o] = s_min;
  out_gid[o] = gid;
  out_n[3 * o] = nw[0];
  out_n[3 * o + 1] = nw[1];
  out_n[3 * o + 2] = nw[2];
}

// launches raycast_kernel on ``stream``; returns cudaGetLastError()
extern "C" int raycast(const float* par, const int* code, const float* faces,
                       const float* dirs, float* out_s, int* out_gid,
                       float* out_n, int B, int N, int G, int F,
                       void* stream) {
  RAYCAST_LAUNCH(raycast_kernel, (N + RAYCAST_THREADS - 1) / RAYCAST_THREADS,
                 B, stream, par, code, faces, dirs, out_s, out_gid, out_n, B,
                 N, G, F);
  return (int)cudaGetLastError();
}
