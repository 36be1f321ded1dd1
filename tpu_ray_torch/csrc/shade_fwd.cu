// Fused forward of the shade chain: the colour of each ray from the
// geometry residuals, in one pass.
//
// Replaces the Pallas kernel `shade_fwd_pallas` (tpu_ray/kernels/
// pallas_shade.py:510) and every chain it takes: methods sdf, mesh_* and
// mixed; directional and point lights; static shadow visibility (hard,
// soft or none); the diff_vis soft-shadow penumbra; the 5-tap AO with its
// SDF and mesh terms; the soft SDF silhouette and the mesh edge band. The
// per-ray chain is shade_chain.cuh's, which the backward (shade_bwd.cu)
// recomputes too. The plain PyTorch version is shade_fwd_torch
// (tpu_ray_torch/kernels/cuda_shade.py): the port's plain shade without
// gradient.
//
// What bounds it on an H100: compute on the rays whose selected hit is the
// Mandelbulb. Such a ray runs the field's first-order adjoint at the hit for
// the normal (twelve stored iterations), the argmin DE, and with AO five tap
// DEs, with the penumbra one DE per light. A sky ray reads ~40 bytes and
// writes 12. Memory traffic is ~70-130 bytes per ray. The kernel is built
// for the power-8 field and for the generic one (sdf.cuh); the entry point
// launches the one mb_pow8 names.
//
// The simple design: one thread per ray, and a per-ray branch in place of
// the Pallas kernel's per-tile class dispatch (pallas_shade.py:379-438):
// a lane that selects no surface writes the sky, a selected mesh hit runs
// the Moller-Trumbore re-solve, a selected SDF hit the normal's adjoint. The
// branch is exact: it is the plain version's own select. No reduction.
//
// At the path's launch size (32,768 or 65,536 rays) a bulb ray's chain is
// arithmetic latency at ~2 warps a scheduler (the argmin's DE, the
// adjoint's forward and reverse, the AO taps). The chain runs the bulb's
// forward at the hit once: the argmin's, whose stored iterations the
// normal's reverse pass reads (shade_chain.cuh); with the power-8 field the
// five AO taps run in lock-step, five independent chains a thread. The
// wrapper takes the parameters packed once a frame (cuda_shade.pack), which
// were 0.0077 ms of a 0.019 ms `mixed` launch when packed per launch.
#include <stdint.h>

#include "shade_chain.cuh"

namespace tr {

// Ray r's colour: the sky where it selects no surface, else the surface
// colour blended over the sky by its coverage, bg + cov * (colour - bg).
template <bool kPow8>
__device__ __forceinline__ void shade_fwd_ray(const ShadeParams& s, const RayIn& r,
                                              float* rgb, const MbStore& st) {
  const float sb = 0.5f * (r.d[1] + 1.0f);
  SurfFwd f;
  if (!shade_surface<kPow8, kPow8>(s, r, &f, st)) {
    for (int c = 0; c < 3; ++c) rgb[c] = sky(s, c, sb);
    return;
  }
  const float* alb = s.sdf.p + s.off_alb + 3 * f.mat;
  for (int c = 0; c < 3; ++c) {
    const float bg = sky(s, c, sb);
    rgb[c] = bg + f.cov * (alb[c] * f.rad[c] - bg);
  }
}

}  // namespace tr

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;

// Dynamic shared memory: each thread's MbStore column (slots floats: the
// normal's Mandelbulb adjoint's stored iterations). The launch bounds name
// one block an SM, as shade_bwd.cu's do (with the thread count alone ptxas
// spilled).
template <bool kPow8>
__global__ void __launch_bounds__(kThreads, 1) shade_fwd_kernel(
    tr::ShadeParams s, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ corners, const float* __restrict__ t_bar,
    const float* __restrict__ tmin, const uint8_t* __restrict__ hs,
    const uint8_t* __restrict__ hm, const uint8_t* __restrict__ closer,
    const int* __restrict__ mat, const float* __restrict__ vis,
    const float* __restrict__ ts, const float* __restrict__ ao_tmesh, int n,
    float* __restrict__ out) {
  extern __shared__ float store[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, tmin, hs, hm,
                                   closer, mat, vis, ts, ao_tmesh, nullptr);
  float rgb[3];
  tr::shade_fwd_ray<kPow8>(s, r, rgb, tr::MbStore{store + threadIdx.x, kThreads, 0});
  for (int c = 0; c < 3; ++c) out[3 * i + c] = rgb[c];
}

}  // namespace

extern "C" int tr_shade_fwd(
    const float* o, const float* d, const float* corners, const float* t_bar,
    const float* tmin, const uint8_t* hs, const uint8_t* hm,
    const uint8_t* closer, const int* mat, const float* vis, const float* ts,
    const float* ao_tmesh, int n, const float* small, int n_sph, int n_pln,
    int n_box, int n_mb, int mb_iters, int mb_pow8, int n_mat, int n_dir, int n_pos,
    int use_sdf, int use_mesh, int ao_sdf, int ao_mesh, int soft_diff,
    float soft_sil, float mesh_sil, double ao_step, float ao_strength,
    float soft_k, float bias, float* out, void* stream) {
  const tr::ShadeParams s = tr::make_params(
      small, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, n_mat, n_dir, n_pos, use_sdf,
      use_mesh, ao_sdf, ao_mesh, soft_diff, soft_sil, mesh_sil, ao_step,
      ao_strength, soft_k, bias);
  if (n_mat < 1 || (soft_diff && !ts) ||
      (ao_mesh && !ao_tmesh) || (soft_sil > 0.0f && !tmin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    auto kernel = mb_pow8 ? shade_fwd_kernel<true> : shade_fwd_kernel<false>;
    const size_t smem =
        static_cast<size_t>(n_mb > 0 ? tr::mb_store_slots(mb_iters) : 0) * kThreads * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        s, o, d, corners, t_bar, tmin, hs, hm, closer, mat, vis, ts, ao_tmesh,
        n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
