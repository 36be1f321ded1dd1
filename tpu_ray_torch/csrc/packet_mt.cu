// Closest-hit and any-hit Möller–Trumbore over the packet accel: two kernels
// over one per-ray walk.
//
// `packet_kernel` replaces the Pallas kernel `intersect_packet_streamed`
// (tpu_ray/kernels/pallas_mt.py:347); `packet_resident_kernel` replaces
// `intersect_packet` (pallas_mt.py:102, with `any_hit_packet` :589), which
// visits the supers in a given order: by distance from a point (primary
// rays from one camera), by projection on a direction (shadow rays toward
// one light), or in slot order. Both share the chunk update `_mt_chunk_update`
// (:60-99) and the slot-to-id mapping `_finalize_hits` (:249-262). Plain
// PyTorch versions: intersect_packet_streamed_torch and
// intersect_packet_torch in tpu_ray_torch/kernels/cuda_mt.py. Layout of the
// accel: tpu_ray_torch/accel/packet.py.
//
// What bounds them on an H100: memory latency on the corner rows. Each
// surviving chunk costs 9 dependent loads per triangle before ~40 flops of
// MT; a 70k-triangle accel (4.9 MB) or one 12 MiB part sits in the 50 MB L2
// cache, and the rays of one warp are neighbouring samples that mostly walk
// the same chunks, so most loads are warp-wide broadcasts from L1. Visiting
// the supers front to back shrinks a lane's best t early, so the slab tests
// cull more of what lies behind it.
//
// The simple design: one thread per ray walks the supers, in slot order
// (#3) or in the order the wrapper gives (#4). It slab-tests the super's
// box against its own best t, then each chunk's box, then runs MT on the
// chunk's 128 triangles. It keeps the TPU kernels' rules: best t starts at
// min(t_init, t_far); a triangle is valid only with t in (T_MIN, t_far) for
// the static t_far; a hit is recorded only when strictly better, so a tie
// keeps the first slot visited; in any-hit mode a lane stops at its first
// hit. The TPU kernels branch per (16,128) ray tile; the per-tile candidate
// lists, early stop and double buffering of #3 are later work.
//
// The per-ray walk is plain C++ above the __CUDACC__ guard, so the CPU tests
// build it with g++ and hold it against the plain versions.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else  // a host build of the per-ray walk, for the CPU tests
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace trmt {

constexpr int kChunk = 128;
constexpr int kRowsPerChunk = 16;
constexpr int kSuper = 16;
constexpr float kDetEps = 1e-10f;
constexpr float kTMin = 1e-5f;
constexpr float kBig = 1e10f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__host__ __device__ __forceinline__ float inv_dir(float v) {
  return (v >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(v), 1e-12f);
}

__host__ __device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                                 int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  return r;
}

// Slab test of one AABB row (lanes 0..5 = lo.xyz, hi.xyz) against the ray,
// in the reference's op order: (tf >= max(tn, 0)) & (max(tn, 0) < best).
__host__ __device__ __forceinline__ bool slab(const float* ab, const Ray& r,
                                              float best) {
  const float t0x = (ab[0] - r.ox) * r.ix, t1x = (ab[3] - r.ox) * r.ix;
  const float t0y = (ab[1] - r.oy) * r.iy, t1y = (ab[4] - r.oy) * r.iy;
  const float t0z = (ab[2] - r.oz) * r.iz, t1z = (ab[5] - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tn = fmaxf(tn, 0.0f);
  return (tf >= tn) && (tn < best);
}

// MT against the 128 triangles of chunk ci; a strictly closer valid hit
// replaces (best, slot).
__host__ __device__ __forceinline__ void chunk_mt(const float* corners, int ci,
                                                  const Ray& r, float t_far,
                                                  float& best, int& slot) {
  const float* rows = corners + (size_t)ci * kRowsPerChunk * kChunk;
  for (int j = 0; j < kChunk; ++j) {
    const float v0x = rows[0 * kChunk + j], v0y = rows[1 * kChunk + j],
                v0z = rows[2 * kChunk + j];
    const float e1x = rows[3 * kChunk + j], e1y = rows[4 * kChunk + j],
                e1z = rows[5 * kChunk + j];
    const float e2x = rows[6 * kChunk + j], e2y = rows[7 * kChunk + j],
                e2z = rows[8 * kChunk + j];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok = fabsf(det) > kDetEps;
    const float inv_det = 1.0f / (ok ? det : 1.0f);
    const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool valid = ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                       (t > kTMin) && (t < t_far);
    if (valid && t < best) {
      best = t;
      slot = ci * kChunk + j;
    }
  }
}

// One ray's walk over the supers, visited as order[0..n_supers) (slot order
// without one), then its outputs: t and the original triangle id on a
// closest hit; t BIG and tri 0 on an any-hit lane that hit; BIG and -1 on a
// miss.
__host__ __device__ __forceinline__ void walk_ray(
    int i, const float* o, const float* d, const float* t_init, float t_far,
    const float* corners, const float* chunk_aabb, const float* super_aabb,
    const int* order, int n_supers, const int* perm, int perm_len, int any_hit,
    float* t_out, int* tri_out, uint8_t* hit_out) {
  const Ray r = load_ray(o, d, i);
  float best = t_init ? fminf(t_init[i], t_far) : t_far;
  int slot = -1;
  for (int k = 0; k < n_supers && !(any_hit && slot >= 0); ++k) {
    const int s = order ? order[k] : k;
    if (!slab(super_aabb + (size_t)s * 128, r, best)) continue;
    for (int c = 0; c < kSuper; ++c) {
      const int ci = s * kSuper + c;
      if (!slab(chunk_aabb + (size_t)ci * 128, r, best)) continue;
      chunk_mt(corners, ci, r, t_far, best, slot);
      // any-hit: a lane with a hit has best t 0 for every later cull
      if (any_hit && slot >= 0) break;
    }
  }
  const bool hit = slot >= 0;
  hit_out[i] = hit ? 1 : 0;
  if (any_hit) {
    t_out[i] = kBig;
    tri_out[i] = hit ? 0 : -1;
  } else {
    t_out[i] = hit ? best : kBig;
    const int clipped = slot < 0 ? 0 : (slot < perm_len ? slot : perm_len - 1);
    tri_out[i] = hit ? perm[clipped] : -1;
  }
}

}  // namespace trmt

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;

// TPU kernel #3: every super in slot order.
__global__ void packet_kernel(const float* __restrict__ o,
                              const float* __restrict__ d,
                              const float* __restrict__ t_init, int n,
                              float t_far, const float* __restrict__ corners,
                              const float* __restrict__ chunk_aabb,
                              const float* __restrict__ super_aabb,
                              int n_supers, const int* __restrict__ perm,
                              int perm_len, int any_hit,
                              float* __restrict__ t_out,
                              int* __restrict__ tri_out,
                              uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trmt::walk_ray(i, o, d, t_init, t_far, corners, chunk_aabb, super_aabb,
                 nullptr, n_supers, perm, perm_len, any_hit, t_out, tri_out,
                 hit_out);
}

// TPU kernel #4: every super in `super_order` (the wrapper's sort).
__global__ void packet_resident_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_init, int n, float t_far,
    const float* __restrict__ corners, const float* __restrict__ chunk_aabb,
    const float* __restrict__ super_aabb, const int* __restrict__ super_order,
    int n_supers, const int* __restrict__ perm, int perm_len, int any_hit,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    uint8_t* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trmt::walk_ray(i, o, d, t_init, t_far, corners, chunk_aabb, super_aabb,
                 super_order, n_supers, perm, perm_len, any_hit, t_out,
                 tri_out, hit_out);
}

}  // namespace

extern "C" int tr_intersect_packet_streamed(
    const float* o, const float* d, const float* t_init, int n, float t_far,
    const float* corners, const float* chunk_aabb, const float* super_aabb,
    int n_supers, const int* perm, int perm_len, int any_hit, float* t,
    int* tri, uint8_t* hit, void* stream) {
  if (n <= 0) return 0;
  packet_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb, n_supers, perm,
      perm_len, any_hit, t, tri, hit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tr_intersect_packet_resident(
    const float* o, const float* d, const float* t_init, int n, float t_far,
    const float* corners, const float* chunk_aabb, const float* super_aabb,
    const int* super_order, int n_supers, const int* perm, int perm_len,
    int any_hit, float* t, int* tri, uint8_t* hit, void* stream) {
  if (n <= 0) return 0;
  packet_resident_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb, super_order,
      n_supers, perm, perm_len, any_hit, t, tri, hit);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
