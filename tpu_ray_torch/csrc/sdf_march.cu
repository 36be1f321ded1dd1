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
// The design: one thread per ray, running the reference's step rule until
// it hits, leaves, or spends its step budget. The TPU kernel's per-tile
// early exit becomes this per-thread loop exit, so a ray's result does not
// depend on its neighbours. Rays keep the reference's bounding-sphere
// culls, taken first: a primary ray that misses every bound starts at
// t_far, a hard-shadow ray marches only up to its last bound exit, and a
// shadow ray whose cutoff leaves it no step writes (1, bias) at once. The
// soft march has no cull (its penumbra darkens rays that pass near a bound
// without entering it), so its bound is compute: one DE per step, every
// step up to the ray's own cutoff or the step budget. It is as chaotic
// near the Mandelbulb as the primary march: the argmin t flips on one
// rounding difference, so it keeps the reference's op order (and the
// library builds with --fmad=false). The packed scene parameters are a few
// hundred bytes, read through the L1 cache.
//
// What was measured at the main path's launch size (32,768 or 65,536
// rays; chip_smoke.py phase `launch`, with the optional counters): lane
// efficiency is 0.97-1.0 on every block but one (every soft ray takes all
// its steps), and a launch lasts as long as its slowest warp's chain. A
// grid whose warps refill from a ray counter cannot shorten that chain, and
// at this size every ray already has a thread, so the kernel keeps one
// thread a ray. A copy of the parameters in shared memory moved the soft
// march by -1.0% (generic field) and +1.6% (power 8) in one run: not kept.
// The primary march depends on nothing but the camera rays, so the render
// launches it once per group of 32 blocks (render.march_group): one block
// put ~2 warps on each of the card's schedulers, and a launch lasted as
// long as its slowest warp (`mixed`, a bulb block: warps 9,627 cycles on
// average, 27,228 at most); a group holds 32 such blocks' warps at once,
// and a `mixed` frame's march fell from 7.87 ms in groups of 4 blocks to
// 3.53 ms in groups of 32. Its lane efficiency over a group stays >= 0.8
// (0.84 `mixed`, 0.81 `mandelbulb`), so the rays are not compacted.
//
// The per-ray marches (the primary one and the hard one with their culls,
// the soft one) are plain C++ above the __CUDACC__ guard, so that they also
// build as host code (tests/test_torch_shade_bwd.py and
// tests/test_torch_sdf.py hold that build against march_torch,
// shadow_hard_torch and shadow_soft_torch on the CPU).
#include <stdint.h>

#include "sdf.cuh"

namespace tr {

// One primary ray: the bound cull (a ray that misses every bounding sphere
// starts dead at t_far), then steps of t += DE until a DE below eps hits, t
// reaches t_far or the step budget is spent. Writes t, hit and the t of the
// smallest DE seen (tmin, t0 when none was below 1e10); sets *reach to
// whether the ray reached a bound (true without bounds); returns the DE steps
// taken.
template <bool kPow8>
__device__ __forceinline__ int march_ray(const SdfParams& sdf, const float* bounds,
                                         int n_bounds, float ox, float oy, float oz, float dx,
                                         float dy, float dz, float t0, int max_steps,
                                         float eps, float t_far, float* t_out, bool* hit_out,
                                         float* tmin_out, bool* reach_out) {
  float t = t0;
  bool reach = true;
  if (n_bounds > 0) {
    reach = false;
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
    const float dist = scene_de<kPow8>(sdf, ox + t * dx, oy + t * dy, oz + t * dz);
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
  *t_out = t;
  *hit_out = hit;
  *tmin_out = tmin;
  *reach_out = reach;
  return steps;
}

// A hard-shadow ray's march end: its cutoff tf clamped at the last exit
// from the bounding spheres grown by eps (a blocker needs DE < eps, so only
// inside one), or at 0 when it misses them all; tf without bounds.
__device__ __forceinline__ float shadow_hard_cut(const float* bounds, int n_bounds, float eps,
                                                 float px, float py, float pz, float lx,
                                                 float ly, float lz, float tf) {
  if (n_bounds <= 0) return tf;
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
  return fminf(tf, t_cut);
}

// One hard-shadow ray: the cull, then steps of max(DE, eps/2) until a DE
// below eps blocks it, t reaches the cut-off tf or the step budget is
// spent. Writes the visibility (0 or 1) and ts = bias; returns the DE steps
// taken (0 for a ray that the cull or its cutoff leaves no step).
template <bool kPow8>
__device__ __forceinline__ int shadow_hard_ray(const SdfParams& sdf, const float* bounds,
                                               int n_bounds, float px, float py, float pz,
                                               float lx, float ly, float lz, float tf,
                                               float eps, int max_steps, float bias,
                                               float* vis, float* ts) {
  tf = shadow_hard_cut(bounds, n_bounds, eps, px, py, pz, lx, ly, lz, tf);
  float t = bias, v = 1.0f;
  int k = 0;
  for (; k < max_steps; ++k) {
    if (!(t < tf)) break;
    const float dd = scene_de<kPow8>(sdf, px + t * lx, py + t * ly, pz + t * lz);
    if (dd < eps) {
      v = 0.0f;
      ++k;
      break;
    }
    t = t + fmaxf(dd, eps * 0.5f);
  }
  *vis = v;
  *ts = bias;
  return k;
}

// One soft-shadow ray: the penumbra s = min over the march of
// soft_k * DE / max(t, bias) from 1, the step DE clipped to [eps/2, 0.4],
// until t >= tf or the step budget is spent. Writes clip(s, 0, 1) and the t
// of the first step that attained the min (bias when none went below 1);
// returns the DE steps taken.
template <bool kPow8>
__device__ __forceinline__ int shadow_soft_ray(
    const SdfParams& sdf, float px, float py, float pz, float lx, float ly,
    float lz, float tf, float eps, int max_steps, float bias, float soft_k,
    float* vis, float* ts_out) {
  float t = bias, s = 1.0f, ts = bias;
  int k = 0;
  for (; k < max_steps; ++k) {
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
  return k;
}

}  // namespace tr

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;

// The marches' optional counters (cuda_sdf.SHADOW_COUNTERS), added to by a
// launch given a counters pointer: rays whose cutoff lets them
// march (live), rays left to march after the bound cull, their DE steps (sum
// and max), warp-steps (the DE steps each warp issues, so that lane
// efficiency is steps / (32 warp-steps)), and clock64() cycles a warp
// takes (sum and max) over the warps counted.
enum ShadowCounter { kLive, kMarching, kSteps, kStepsMax, kWarpSteps, kWarpCycles,
                     kWarpCyclesMax, kWarps, kNumShadowCounters };

// One lane's share of the counters: its ray's live / marching flags and
// steps; the warp's first lane adds the warp's sums, its warp-steps (its
// lanes' most steps) and its cycles since c0.
__device__ __forceinline__ void shadow_count(unsigned long long* counters, unsigned mask,
                                             bool live, bool marching, int steps,
                                             long long c0) {
  const unsigned n_live = __popc(__ballot_sync(mask, live));
  const unsigned n_march = __popc(__ballot_sync(mask, marching));
  const unsigned sum = __reduce_add_sync(mask, static_cast<unsigned>(steps));
  const unsigned most = __reduce_max_sync(mask, static_cast<unsigned>(steps));
  __syncwarp(mask);
  const long long cycles = clock64() - c0;
  if ((threadIdx.x & 31) == __ffs(mask) - 1) {
    using u64 = unsigned long long;
    atomicAdd(counters + kLive, static_cast<u64>(n_live));
    atomicAdd(counters + kMarching, static_cast<u64>(n_march));
    atomicAdd(counters + kSteps, static_cast<u64>(sum));
    atomicMax(counters + kStepsMax, static_cast<u64>(most));
    atomicAdd(counters + kWarpSteps, static_cast<u64>(most));
    atomicAdd(counters + kWarpCycles, static_cast<unsigned long long>(cycles));
    atomicMax(counters + kWarpCyclesMax, static_cast<unsigned long long>(cycles));
    atomicAdd(counters + kWarps, 1ull);
  }
}

// One thread a ray; the optional counters (the shadow marches' layout, with
// live the rays that reach a bound and marching those that take a step).
template <bool kPow8>
__global__ void march_kernel(const float* __restrict__ o,
                             const float* __restrict__ d, int n,
                             tr::SdfParams sdf, const float* __restrict__ bounds,
                             int n_bounds, float t0, int max_steps, float eps,
                             float t_far, float* __restrict__ t_out,
                             uint8_t* __restrict__ hit_out,
                             int* __restrict__ steps_out,
                             float* __restrict__ tmin_out,
                             unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned mask = __ballot_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const long long c0 = clock64();
  bool hit, reach;
  const int steps = tr::march_ray<kPow8>(sdf, bounds, n_bounds, o[3 * i], o[3 * i + 1],
                                         o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2],
                                         t0, max_steps, eps, t_far, t_out + i, &hit,
                                         tmin_out + i, &reach);
  hit_out[i] = hit ? 1 : 0;
  steps_out[i] = steps;
  if (counters) shadow_count(counters, mask, reach, steps > 0, steps, c0);
}

// One thread a shadow ray, its cull first: a ray whose cutoff (with the
// hard march's bound cull) leaves it no step writes (1, bias) at once.
template <bool kPow8, bool kSoft>
__global__ void shadow_kernel(
    const float* __restrict__ p, const float* __restrict__ l,
    const float* __restrict__ t_far_rays, int n, tr::SdfParams sdf,
    const float* __restrict__ bounds, int n_bounds, float eps, float t_far, int max_steps,
    float bias, float soft_k, float* __restrict__ vis_out, float* __restrict__ ts_out,
    unsigned long long* __restrict__ counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned mask = __ballot_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const long long c0 = clock64();
  const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
  const float lx = l[3 * i], ly = l[3 * i + 1], lz = l[3 * i + 2];
  const float tf = t_far_rays ? t_far_rays[i] : t_far;
  const int steps =
      kSoft ? tr::shadow_soft_ray<kPow8>(sdf, px, py, pz, lx, ly, lz, tf, eps, max_steps, bias,
                                         soft_k, vis_out + i, ts_out + i)
            : tr::shadow_hard_ray<kPow8>(sdf, bounds, n_bounds, px, py, pz, lx, ly, lz, tf, eps,
                                         max_steps, bias, vis_out + i, ts_out + i);
  if (counters) shadow_count(counters, mask, bias < tf, steps > 0, steps, c0);
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

// Launches the shadow march of the field sdf.mb_pow8 names, hard or soft.
template <bool kSoft>
int launch_shadow(const float* p, const float* l, const float* t_far_rays, int n,
                  const tr::SdfParams& sdf, const float* bounds, int n_bounds, float eps,
                  float t_far, int steps, float bias, float soft_k, float* vis, float* ts,
                  unsigned long long* counters, void* stream) {
  if (n <= 0) return 0;
  auto kernel = sdf.mb_pow8 ? shadow_kernel<true, kSoft> : shadow_kernel<false, kSoft>;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, l, t_far_rays, n, sdf, bounds, n_bounds, eps, t_far, steps, bias, soft_k, vis, ts,
      counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tr_march(const float* o, const float* d, int n,
                        const float* params, int n_sph, int n_pln, int n_box,
                        int n_mb, int mb_iters, int mb_pow8,
                        const float* bounds, int n_bounds, float t0,
                        int max_steps, float eps, float t_far, float* t,
                        uint8_t* hit, int* steps, float* tmin,
                        unsigned long long* counters, void* stream) {
  if (n <= 0) return 0;
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  TR_LAUNCH_SDF(march_kernel, n, stream, o, d, n, sdf, bounds, n_bounds, t0,
                max_steps, eps, t_far, t, hit, steps, tmin, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tr_shadow_hard(const float* p, const float* l,
                              const float* t_far_rays, int n,
                              const float* params, int n_sph, int n_pln,
                              int n_box, int n_mb, int mb_iters, int mb_pow8,
                              const float* bounds, int n_bounds, float eps,
                              float t_far, int steps, float bias, float* vis,
                              float* ts, unsigned long long* counters,
                              void* stream) {
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  return launch_shadow<false>(p, l, t_far_rays, n, sdf, bounds, n_bounds, eps, t_far, steps,
                              bias, 0.0f, vis, ts, counters, stream);
}

extern "C" int tr_shadow_soft(const float* p, const float* l,
                              const float* t_far_rays, int n,
                              const float* params, int n_sph, int n_pln,
                              int n_box, int n_mb, int mb_iters, int mb_pow8,
                              float eps, float t_far, int steps, float bias,
                              float soft_k, float* vis, float* ts,
                              unsigned long long* counters, void* stream) {
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  return launch_shadow<true>(p, l, t_far_rays, n, sdf, nullptr, 0, eps, t_far, steps, bias,
                             soft_k, vis, ts, counters, stream);
}

#endif  // __CUDACC__
