// Z-buffer ray cast of the RGB-D observation: per frame and pixel, a strict
// running minimum of the hit distance over the frame's visible geoms
// (plane, sphere, box, capsule, cylinder, convex hull), and the nearest
// hit's distance s*, geom id and world normal.
//
// Replaces the TPU kernel mujoco_rl_ur5_tpu/render/pallas_raycast.py _kernel
// (:50, launched by _cast :276 and cast_rays :305, its operands packed by
// pack_geoms :236).
//
// Bound: bytes. A top-down tile of pixels sees the floor, the bin and a
// few objects of the 48 visible geoms; counting only those, the operations
// take less time than writing 20 bytes per pixel (with every geom on every
// ray, the operations would bound it, 13x higher). What the design does:
//  * a block is one 16 x 16 tile of one frame (the ragged edge masked).
//    First its threads test the frame's geoms against the tile's frustum,
//    one geom per thread: the geom's bounding sphere (centre -R o from its
//    table row, radius from render/raycast.py's cull table) against the
//    four side planes through the camera and the tile's outermost rays. A
//    geom wholly outside one plane, by a margin, cannot be hit by a ray of
//    the tile: it would return the miss sentinel on every one of them, so
//    it is dropped. The plane is never dropped, nor a geom whose sphere
//    holds the camera (the test cannot fail then). The survivors are
//    listed in ascending geom id (a warp ballot and a prefix count over the
//    warps), so the strict s < s* rule (of equal hits the geom listed
//    first wins) is the unculled one;
//  * the survivors' table rows (16 floats) and their hull faces are staged
//    in shared memory, and every pixel of the tile casts against the
//    survivors only; the branch of a geom is the same for the whole block;
//  * an intersection computes s only; the winner's local normal (its
//    sqrt and divisions) and world normal are computed once per pixel,
//    after the loop, by the same operations as before.
// Every intersection repeats render/raycast.py's plain version operation
// for operation (built with -fmad=false), including its normalisation
// n / max(|n|, 1e-12) and the miss sentinel BIG = 1e10, so the outputs are
// cast_plain's to the bit.
//
// Operands (float32 unless noted, row-major):
//   par (B, G, 16)   per frame and geom: R (world from local) 9, R^T (cam - p)
//                    3, size 3, unused 1
//   code (G, 2) int32  branch (0 plane, 1 sphere, 2 box, 3 capsule,
//                    4 cylinder, 5 hull, -1 hidden) and hull face row
//   faces (M, F, 4)  hull faces: outward normal 3, offset (n . x <= d)
//   dirs (N, 3)      unit ray directions in world, N = W * Hi row-major
//   planes (T, 4, 4) per tile of TX x TY (TX = ceil(W / 16)): each side
//                    plane's inward unit normal 3 and its slack w; a geom
//                    is culled when n . c + r + w |c| < 0 for one plane
//   radius (G,)      bounding radius about the geom's frame
//   out_s (B, N), out_gid (B, N) int32, out_n (B, N, 3)
//   tile_count (B, T), tile_list (B, T, G) int32: the survivors, written
//                    only where the pointers are not null
#include <cuda_runtime.h>

#define RAYCAST_BIG 1e10f
#define RAYCAST_EPS 1e-12f
#define RAYCAST_TILE 16
#define RAYCAST_THREADS (RAYCAST_TILE * RAYCAST_TILE)
#define RAYCAST_WARPS (RAYCAST_THREADS / 32)

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

// Each intersection returns s (BIG on a miss); with NRM it also writes the
// local normal at the hit, whose operations never feed s.
template <bool NRM>
__device__ __forceinline__ float ray_plane(const LocalRay& r, float* n) {
  float s = fabsf(r.dz) > RAYCAST_EPS ? -r.oz / r.dz : RAYCAST_BIG;
  s = (s > 0.f && r.oz > 0.f) ? s : RAYCAST_BIG;
  if (NRM) {
    n[0] = 0.f;
    n[1] = 0.f;
    n[2] = 1.f;
  }
  return s;
}

template <bool NRM>
__device__ __forceinline__ float ray_sphere(const LocalRay& r, float rad,
                                            float* n) {
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float b = 2.f * (r.ox * r.dx + r.oy * r.dy + r.oz * r.dz);
  const float c = (r.ox * r.ox + r.oy * r.oy + r.oz * r.oz) - rad * rad;
  const float disc = b * b - 4.f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  float s = (-b - sq) / (2.f * a);
  s = (disc > 0.f && s > 0.f) ? s : RAYCAST_BIG;
  if (NRM) rc_unit(r.ox + s * r.dx, r.oy + s * r.dy, r.oz + s * r.dz, n);
  return s;
}

template <bool NRM>
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
  if (NRM) {
    const bool is0 = tmin[0] >= tmin[1] && tmin[0] >= tmin[2];
    const bool is1 = !is0 && tmin[1] >= tmin[2];
    const bool is2 = !is0 && !is1;
    n[0] = is0 ? -rc_sign(d[0]) : 0.f;
    n[1] = is1 ? -rc_sign(d[1]) : 0.f;
    n[2] = is2 ? -rc_sign(d[2]) : 0.f;
  }
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

template <bool NRM>
__device__ __forceinline__ float ray_capsule(const LocalRay& r, float rad,
                                             float hl, float* n) {
  float s_side = ray_cyl_side(r, rad);
  s_side = fabsf(r.oz + s_side * r.dz) <= hl ? s_side : RAYCAST_BIG;
  const float s = fminf(s_side, fminf(ray_cap(r, rad, hl),
                                      ray_cap(r, rad, -hl)));
  if (NRM) {
    const float pz = r.oz + s * r.dz;
    rc_unit(r.ox + s * r.dx, r.oy + s * r.dy,
            pz - fminf(fmaxf(pz, -hl), hl), n);
  }
  return s;
}

template <bool NRM>
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
  if (NRM) {
    float side[3];
    rc_unit(r.ox + s * r.dx, r.oy + s * r.dy, 0.f, side);
    const bool disc_wins = s_disc < s_side;
    n[0] = disc_wins ? 0.f : side[0];
    n[1] = disc_wins ? 0.f : side[1];
    n[2] = disc_wins ? sgn : 0.f;
  }
  return s;
}

// convex polytope {n . x <= d}: the last entering plane against the first
// exiting one; a padded face (normal 0, offset 1e10) imposes nothing
template <bool NRM>
__device__ __forceinline__ float ray_hull(const LocalRay& r,
                                          const float* face, int F,
                                          float* n) {
  float t_in = -RAYCAST_BIG, t_out = RAYCAST_BIG;
  bool outside = false;
  if (NRM) n[0] = n[1] = n[2] = 0.f;
  for (int f = 0; f < F; ++f) {
    const float fx = face[4 * f], fy = face[4 * f + 1], fz = face[4 * f + 2];
    const float fd = face[4 * f + 3];
    const float nd = fx * r.dx + fy * r.dy + fz * r.dz;
    const float no = fx * r.ox + fy * r.oy + fz * r.oz;
    const float t = fabsf(nd) > RAYCAST_EPS ? (fd - no) / nd : 0.f;
    const float t_ent = nd < -RAYCAST_EPS ? t : -RAYCAST_BIG;
    if (NRM && t_ent > t_in) {
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

// a staged geom row p against the world ray d: s, and with NRM the local
// normal n
template <bool NRM>
__device__ __forceinline__ float cast_one(int branch, const float* p,
                                          const float* face, int F, float dx,
                                          float dy, float dz, float* n) {
  LocalRay r;
  r.ox = p[9];
  r.oy = p[10];
  r.oz = p[11];
  r.dx = p[0] * dx + p[3] * dy + p[6] * dz;  // R^T d
  r.dy = p[1] * dx + p[4] * dy + p[7] * dz;
  r.dz = p[2] * dx + p[5] * dy + p[8] * dz;
  switch (branch) {
    case 0:
      return ray_plane<NRM>(r, n);
    case 1:
      return ray_sphere<NRM>(r, p[12], n);
    case 2:
      return ray_box<NRM>(r, p + 12, n);
    case 3:
      return ray_capsule<NRM>(r, p[12], p[13], n);
    case 4:
      return ray_cylinder<NRM>(r, p[12], p[13], n);
    default:
      return ray_hull<NRM>(r, face, F, n);
  }
}

// An ordered compaction over the block: each thread's offset among the
// threads before it whose pred holds; *total gets their count. Every
// thread of the block calls it together.
__device__ __forceinline__ int block_prefix(bool pred, int* warp_n,
                                            int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_n[warp] = __popc(m);
  __syncthreads();
  int off = 0, all = 0;
  for (int w = 0; w < RAYCAST_WARPS; ++w) {
    off += w < warp ? warp_n[w] : 0;
    all += warp_n[w];
  }
  __syncthreads();  // warp_n is read by all before its next use
  *total = all;
  return off + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(RAYCAST_THREADS)
    raycast_kernel(const float* __restrict__ par, const int* __restrict__ code,
                   const float* __restrict__ faces,
                   const float* __restrict__ dirs,
                   const float* __restrict__ planes,
                   const float* __restrict__ radius, float* __restrict__ out_s,
                   int* __restrict__ out_gid, float* __restrict__ out_n,
                   int* __restrict__ tile_count, int* __restrict__ tile_list,
                   int W, int Hi, int G, int F, int nhull) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_n[RAYCAST_WARPS];
  float* rows = reinterpret_cast<float*>(smem4);   // (G, 16) survivors
  float* hface = rows + 16 * G;                    // (nhull, F, 4)
  int* ids = reinterpret_cast<int*>(hface + 4 * F * nhull);   // (G,)
  int* branch = ids + G;                           // (G,)
  int* hslot = branch + G;                         // (G,) hull slot
  int* hrow = hslot + G;                           // (nhull,) face row

  const int TX = (W + RAYCAST_TILE - 1) / RAYCAST_TILE;
  const int T = TX * ((Hi + RAYCAST_TILE - 1) / RAYCAST_TILE);
  const int tile = blockIdx.x % T;
  const long long b = blockIdx.x / T;
  const int tid = threadIdx.x;
  const float* pb = par + b * G * 16;
  const float* pl = planes + 16 * tile;

  // 1. the survivors of this tile, in ascending geom id
  int count = 0;
  for (int g0 = 0; g0 < G; g0 += RAYCAST_THREADS) {
    const int g = g0 + tid;
    const int br = g < G ? code[2 * g] : -1;
    bool keep = br == 0;
    if (br > 0) {
      const float* p = pb + 16 * g;
      const float cx = -(p[0] * p[9] + p[1] * p[10] + p[2] * p[11]);
      const float cy = -(p[3] * p[9] + p[4] * p[10] + p[5] * p[11]);
      const float cz = -(p[6] * p[9] + p[7] * p[10] + p[8] * p[11]);
      const float len = sqrtf(cx * cx + cy * cy + cz * cz);
      const float rad = radius[g];
      keep = true;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (pl[4 * k] * cx + pl[4 * k + 1] * cy + pl[4 * k + 2] * cz + rad +
                pl[4 * k + 3] * len < 0.f)
          keep = false;
    }
    int n;
    const int at = count + block_prefix(keep, warp_n, &n);
    if (keep) {
      ids[at] = g;
      branch[at] = br;
    }
    count += n;
  }
  __syncthreads();

  // 2. hull slots in survivor order, then the rows and faces staged
  int nh = 0;
  for (int k0 = 0; k0 < count; k0 += RAYCAST_THREADS) {
    const int k = k0 + tid;
    const bool hull = k < count && branch[k] == 5;
    int n;
    const int at = nh + block_prefix(hull, warp_n, &n);
    if (hull) {
      hslot[k] = at;
      hrow[at] = code[2 * ids[k] + 1];
    }
    nh += n;
  }
  __syncthreads();
  const float4* par4 = reinterpret_cast<const float4*>(pb);
  for (int e = tid; e < 4 * count; e += RAYCAST_THREADS)
    smem4[e] = par4[4 * ids[e >> 2] + (e & 3)];
  const float4* face4 = reinterpret_cast<const float4*>(faces);
  float4* hface4 = reinterpret_cast<float4*>(hface);
  for (int e = tid; e < nh * F; e += RAYCAST_THREADS)
    hface4[e] = face4[(long long)hrow[e / F] * F + e % F];
  if (tile_count != nullptr) {
    const long long bt = b * T + tile;
    if (tid == 0) tile_count[bt] = count;
    for (int k = tid; k < count; k += RAYCAST_THREADS)
      tile_list[bt * G + k] = ids[k];
  }
  __syncthreads();

  // 3. each pixel of the tile against the survivors
  const int tx = tile % TX, ty = tile / TX;
  const int px = tx * RAYCAST_TILE + (tid % RAYCAST_TILE);
  const int py = ty * RAYCAST_TILE + (tid / RAYCAST_TILE);
  if (px >= W || py >= Hi) return;
  const long long i = (long long)py * W + px;
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  float s_min = RAYCAST_BIG;
  int kmin = -1;
  for (int k = 0; k < count; ++k) {
    const int br = branch[k];   // the same for every thread of the block
    const float s = cast_one<false>(
        br, rows + 16 * k, br == 5 ? hface + 4 * F * hslot[k] : nullptr, F,
        dx, dy, dz, nullptr);
    if (s < s_min) {
      s_min = s;
      kmin = k;
    }
  }
  float nw[3] = {0.f, 0.f, 0.f};
  int gid = 0;
  if (kmin >= 0) {  // the winner's normal, as its intersection gives it
    const int br = branch[kmin];
    const float* p = rows + 16 * kmin;
    float nl[3];
    cast_one<true>(br, p, br == 5 ? hface + 4 * F * hslot[kmin] : nullptr, F,
                   dx, dy, dz, nl);
    gid = ids[kmin];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      nw[k] = p[3 * k] * nl[0] + p[3 * k + 1] * nl[1] + p[3 * k + 2] * nl[2];
  }
  const long long o = b * W * Hi + i;
  out_s[o] = s_min;
  out_gid[o] = gid;
  out_n[3 * o] = nw[0];
  out_n[3 * o + 1] = nw[1];
  out_n[3 * o + 2] = nw[2];
}

// shared memory of one block: the survivors' rows, the surviving hulls'
// faces and four int tables
static size_t raycast_smem(int G, int F, int nhull) {
  return sizeof(float) * (16 * (size_t)G + 4 * (size_t)F * nhull) +
         sizeof(int) * (3 * (size_t)G + nhull);
}

// launches raycast_kernel on ``stream`` over B frames of W x Hi pixels,
// one block per (frame, tile); returns the first CUDA error
extern "C" int raycast(const float* par, const int* code, const float* faces,
                       const float* dirs, const float* planes,
                       const float* radius, float* out_s, int* out_gid,
                       float* out_n, int* tile_count, int* tile_list, int B,
                       int W, int Hi, int G, int F, int nhull, void* stream) {
  const long long T = (long long)((W + RAYCAST_TILE - 1) / RAYCAST_TILE) *
                      ((Hi + RAYCAST_TILE - 1) / RAYCAST_TILE);
  const long long blocks = T * B;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = raycast_smem(G, F, nhull);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        raycast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
  }
  raycast_kernel<<<(unsigned)blocks, RAYCAST_THREADS, smem,
                   (cudaStream_t)stream>>>(
      par, code, faces, dirs, planes, radius, out_s, out_gid, out_n,
      tile_count, tile_list, W, Hi, G, F, nhull);
  return (int)cudaGetLastError();
}

// (resident blocks per SM, threads per block, dynamic shared memory per
// block) for a launch over G geoms, F faces per hull and nhull hulls
extern "C" int raycast_occupancy(int* out, int G, int F, int nhull) {
  out[1] = RAYCAST_THREADS;
  out[2] = (int)raycast_smem(G, F, nhull);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], raycast_kernel, RAYCAST_THREADS, out[2]);
}
