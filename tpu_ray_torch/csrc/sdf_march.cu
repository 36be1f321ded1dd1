// Sphere-trace march, hard-shadow march and soft-shadow march over the
// scene distance field.
//
// Replaces the Pallas kernels `march_pallas` (tpu_ray/kernels/pallas_sdf.py:223)
// and `shadow_pallas` in hard mode and in soft mode (pallas_sdf.py:328,
// the soft step rule at :393-415). Plain PyTorch versions: march_torch,
// shadow_hard_torch and shadow_soft_torch in
// tpu_ray_torch/kernels/cuda_sdf.py.
//
// What bounds them on an H100: compute and divergence. Each step evaluates
// the distance field (twelve Mandelbulb iterations of ~70 flops; the generic
// field's also take two atan2f, three sinf/cosf and a powf) and rays of one
// warp converge after different step counts. Memory traffic is a few dozen
// bytes per ray. Every kernel is built twice, for the power-8 field and for
// the generic one (sdf.cuh), and the entry points launch the one the
// mb_pow8 argument names, so the power-8 paths carry none of the generic
// field's code.
//
// The simple design: one thread per ray, running the reference's step rule
// until it hits, leaves, or spends its step budget. The TPU kernel's
// per-tile early exit becomes this per-thread loop exit, so a ray's result
// does not depend on its neighbours. The packed scene parameters are a few
// hundred bytes, read through the L1 cache. Rays keep the reference's
// bounding-sphere culls: a primary ray that misses every bound starts at
// t_far, a hard-shadow ray marches only up to its last bound exit. The soft
// march has no cull (its penumbra darkens rays that pass near a bound
// without entering it), so its bound is compute: one DE per step, every
// step up to the ray's own cutoff or the step budget. It is as chaotic near
// the Mandelbulb as the primary march: the argmin t flips on one rounding
// difference, so it keeps the reference's op order (and the library builds
// with --fmad=false).
//
// The soft march's per-ray loop is plain C++ above the __CUDACC__ guard, so
// that it also builds as host code (tests/test_torch_shade_bwd.py holds
// that build against shadow_soft_torch on the CPU).
#include <stdint.h>

#include "sdf.cuh"

namespace tr {

// One soft-shadow ray: the penumbra s = min over the march of
// soft_k * DE / max(t, bias) from 1, the step DE clipped to [eps/2, 0.4],
// until t >= tf or the step budget is spent. Writes clip(s, 0, 1) and the t
// of the first step that attained the min (bias when none went below 1).
template <bool kPow8>
__device__ __forceinline__ void shadow_soft_ray(
    const SdfParams& sdf, float px, float py, float pz, float lx, float ly,
    float lz, float tf, float eps, int max_steps, float bias, float soft_k,
    float* vis, float* ts_out) {
  float t = bias, s = 1.0f, ts = bias;
  for (int k = 0; k < max_steps; ++k) {
    if (!(t < tf)) break;
    const float dd = scene_de<kPow8>(sdf, px + t * lx, py + t * ly, pz + t * lz);
    const float s_new = soft_k * dd / fmaxf(t, bias);
    if (s_new < s) {
      ts = t;
      s = s_new;
    }
    t = t + fminf(fmaxf(dd, eps * 0.5f), 0.4f);
  }
  *vis = fminf(fmaxf(s, 0.0f), 1.0f);
  *ts_out = ts;
}

}  // namespace tr

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;

template <bool kPow8>
__global__ void march_kernel(const float* __restrict__ o,
                             const float* __restrict__ d, int n,
                             tr::SdfParams sdf, const float* __restrict__ bounds,
                             int n_bounds, float t0, int max_steps, float eps,
                             float t_far, float* __restrict__ t_out,
                             uint8_t* __restrict__ hit_out,
                             int* __restrict__ steps_out,
                             float* __restrict__ tmin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float t = t0;
  if (n_bounds > 0) {
    // lanes whose ray misses every bound start dead at t_far
    bool reach = false;
    for (int k = 0; k < n_bounds; ++k) {
      const float* b = bounds + 4 * k;
      const float ocx = ox - b[0], ocy = oy - b[1], ocz = oz - b[2];
      const float bb = ocx * dx + ocy * dy + ocz * dz;
      const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - b[3] * b[3];
      const float disc = bb * bb - c2;
      reach = reach || ((disc >= 0.0f) && (sqrtf(fmaxf(disc, 0.0f)) - bb > 0.0f));
    }
    if (!reach) t = t_far;
  }
  float tmin = t0, dmin = 1e10f;
  bool hit = false;
  int steps = 0;
  for (int s = 0; s < max_steps; ++s) {
    if (!(t < t_far)) break;
    const float dist = tr::scene_de<kPow8>(sdf, ox + t * dx, oy + t * dy, oz + t * dz);
    if (dist < dmin) {
      dmin = dist;
      tmin = t;
    }
    ++steps;
    if (dist < eps) {
      hit = true;
      break;
    }
    t = t + dist;
  }
  t_out[i] = t;
  hit_out[i] = hit ? 1 : 0;
  steps_out[i] = steps;
  tmin_out[i] = tmin;
}

template <bool kPow8>
__global__ void shadow_hard_kernel(const float* __restrict__ p,
                                   const float* __restrict__ l,
                                   const float* __restrict__ t_far_rays, int n,
                                   tr::SdfParams sdf,
                                   const float* __restrict__ bounds,
                                   int n_bounds, float eps, float t_far,
                                   int max_steps, float bias,
                                   float* __restrict__ vis_out,
                                   float* __restrict__ ts_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
  const float lx = l[3 * i], ly = l[3 * i + 1], lz = l[3 * i + 2];
  float tf = t_far_rays ? t_far_rays[i] : t_far;
  if (n_bounds > 0) {
    // a blocker needs DE < eps, so only inside a bound inflated by eps:
    // clamp the march at the last bound exit (0 when every bound is missed)
    float t_cut = 0.0f;
    for (int k = 0; k < n_bounds; ++k) {
      const float* b = bounds + 4 * k;
      const float r = b[3] + eps;
      const float ocx = px - b[0], ocy = py - b[1], ocz = pz - b[2];
      const float bb = ocx * lx + ocy * ly + ocz * lz;
      const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
      const float disc = bb * bb - c2;
      const float texit = sqrtf(fmaxf(disc, 0.0f)) - bb;
      t_cut = fmaxf(t_cut, disc >= 0.0f ? texit : 0.0f);
    }
    tf = fminf(tf, t_cut);
  }
  float t = bias;
  bool blocked = false;
  for (int s = 0; s < max_steps; ++s) {
    if (!(t < tf)) break;
    const float dd = tr::scene_de<kPow8>(sdf, px + t * lx, py + t * ly, pz + t * lz);
    if (dd < eps) {
      blocked = true;
      break;
    }
    t = t + fmaxf(dd, eps * 0.5f);
  }
  vis_out[i] = blocked ? 0.0f : 1.0f;
  ts_out[i] = bias;
}

template <bool kPow8>
__global__ void shadow_soft_kernel(const float* __restrict__ p,
                                   const float* __restrict__ l,
                                   const float* __restrict__ t_far_rays, int n,
                                   tr::SdfParams sdf, float eps, float t_far,
                                   int max_steps, float bias, float soft_k,
                                   float* __restrict__ vis_out,
                                   float* __restrict__ ts_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tr::shadow_soft_ray<kPow8>(sdf, p[3 * i], p[3 * i + 1], p[3 * i + 2], l[3 * i],
                      l[3 * i + 1], l[3 * i + 2],
                      t_far_rays ? t_far_rays[i] : t_far, eps, max_steps, bias,
                      soft_k, vis_out + i, ts_out + i);
}

}  // namespace

// Launches kernel<true> (the power-8 field) or kernel<false> (the generic
// one), as sdf.mb_pow8 says, and returns cudaGetLastError().
#define TR_LAUNCH_SDF(kernel, n, stream, ...)                                 \
  do {                                                                        \
    const unsigned blocks = (n + kThreads - 1) / kThreads;                    \
    if (sdf.mb_pow8)                                                          \
      kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
          __VA_ARGS__);                                                       \
    else                                                                      \
      kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
          __VA_ARGS__);                                                       \
  } while (0)

extern "C" int tr_march(const float* o, const float* d, int n,
                        const float* params, int n_sph, int n_pln, int n_box,
                        int n_mb, int mb_iters, int mb_pow8,
                        const float* bounds, int n_bounds, float t0,
                        int max_steps, float eps, float t_far, float* t,
                        uint8_t* hit, int* steps, float* tmin, void* stream) {
  if (n <= 0) return 0;
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  TR_LAUNCH_SDF(march_kernel, n, stream, o, d, n, sdf, bounds, n_bounds, t0,
                max_steps, eps, t_far, t, hit, steps, tmin);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tr_shadow_hard(const float* p, const float* l,
                              const float* t_far_rays, int n,
                              const float* params, int n_sph, int n_pln,
                              int n_box, int n_mb, int mb_iters, int mb_pow8,
                              const float* bounds, int n_bounds, float eps,
                              float t_far, int steps, float bias, float* vis,
                              float* ts, void* stream) {
  if (n <= 0) return 0;
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  TR_LAUNCH_SDF(shadow_hard_kernel, n, stream, p, l, t_far_rays, n, sdf,
                bounds, n_bounds, eps, t_far, steps, bias, vis, ts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tr_shadow_soft(const float* p, const float* l,
                              const float* t_far_rays, int n,
                              const float* params, int n_sph, int n_pln,
                              int n_box, int n_mb, int mb_iters, int mb_pow8,
                              float eps, float t_far, int steps, float bias,
                              float soft_k, float* vis, float* ts,
                              void* stream) {
  if (n <= 0) return 0;
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  TR_LAUNCH_SDF(shadow_soft_kernel, n, stream, p, l, t_far_rays, n, sdf, eps,
                t_far, steps, bias, soft_k, vis, ts);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
