// Scene distance field as a device function, shared by the march and the
// hard-shadow kernels (sdf_march.cu).
//
// Replaces the Pallas device functions `de_tile` (tpu_ray/kernels/
// pallas_sdf.py:126-162) and `mandelbulb_de_pow8_components`
// (tpu_ray/sdf/mandelbulb.py:26-93), in their op order. The plain PyTorch
// version is tpu_ray_torch/sdf/primitives.py, written per component in the
// same order; the library builds with --fmad=false so that no multiply-add
// is contracted and both round alike. One difference from de_tile: the
// box's outside length clamps at 1e-12, as the reference's sdf_distance does
// (de_tile uses 1e-24; the two differ by 1e-6 only inside a box).
//
// Packed parameter layout (float32, contiguous), in this order:
//   spheres  n_sph x 4 : cx cy cz radius
//   planes   n_pln x 4 : nx ny nz offset          (dot(p, n) - offset)
//   boxes    n_box x 7 : cx cy cz hx hy hz round
//   bulbs    n_mb  x 4 : cx cy cz scale           (power 8 only)
// Bounding spheres ride separately as (n_bounds, 4): cx cy cz r.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else  // a host build of the device arithmetic, for the CPU tests
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace tr {

constexpr float kBig = 1e10f;
constexpr float kRmin = 1e-6f;
constexpr float kBailout = 4.0f;
// kRmin squared as the reference writes it (1e-6 * 1e-6 rounded once)
constexpr float kRmin2 = 1e-12f;

struct SdfParams {
  const float* p;
  int n_sph, n_pln, n_box, n_mb, mb_iters;
};

// Trig-free power-8 Mandelbulb DE in the bulb's local frame. A lane records
// |z| on the iteration it escapes and then freezes; the loop exit below is
// that freeze (nothing changes after it).
__device__ __forceinline__ float mandelbulb_pow8(float px, float py, float pz,
                                                 int iters) {
  float r = sqrtf(fmaxf(px * px + py * py + pz * pz, kRmin2));
  float zx = px, zy = py, zz = pz, dr = 1.0f;
  for (int it = 0; it < iters; ++it) {
    const float r_new = sqrtf(fmaxf(zx * zx + zy * zy + zz * zz, kRmin2));
    r = r_new;
    if (!(r_new <= kBailout)) break;
    const float r_safe = fminf(fmaxf(r_new, kRmin), kBailout);
    const float rho2 = fmaxf(zx * zx + zy * zy, kRmin2);
    const float rho = sqrtf(rho2);
    const float h = sqrtf(rho2 + zz * zz);
    const float inv_h = 1.0f / h;
    float st = rho * inv_h, ct = zz * inv_h;  // theta = atan2(rho, z)
    const float inv_rho = 1.0f / rho;
    float sp = zy * inv_rho, cp = zx * inv_rho;  // phi = atan2(y, x)
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // angle * 8: three double-angle steps
      const float st2 = 2.0f * st * ct, ct2 = ct * ct - st * st;
      const float sp2 = 2.0f * sp * cp, cp2 = cp * cp - sp * sp;
      st = st2; ct = ct2; sp = sp2; cp = cp2;
    }
    const float r2s = r_safe * r_safe;
    const float r4 = r2s * r2s;
    const float r7 = r4 * r2s * r_safe;
    const float r8 = r4 * r4;
    dr = 8.0f * r7 * dr + 1.0f;
    zx = r8 * st * cp + px;
    zy = r8 * st * sp + py;
    zz = r8 * ct + pz;
  }
  r = fmaxf(r, kRmin);
  return 0.5f * logf(r) * r / dr;
}

__device__ __forceinline__ float scene_de(const SdfParams& s, float px,
                                          float py, float pz) {
  float d = kBig;
  const float* q = s.p;
  for (int i = 0; i < s.n_sph; ++i, q += 4) {
    const float qx = px - q[0], qy = py - q[1], qz = pz - q[2];
    d = fminf(d, sqrtf(fmaxf(qx * qx + qy * qy + qz * qz, 1e-12f)) - q[3]);
  }
  for (int i = 0; i < s.n_pln; ++i, q += 4) {
    d = fminf(d, px * q[0] + py * q[1] + pz * q[2] - q[3]);
  }
  for (int i = 0; i < s.n_box; ++i, q += 7) {
    const float qx = fabsf(px - q[0]) - q[3];
    const float qy = fabsf(py - q[1]) - q[4];
    const float qz = fabsf(pz - q[2]) - q[5];
    const float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
    const float outside = sqrtf(fmaxf(ox * ox + oy * oy + oz * oz, 1e-12f));
    const float inside = fminf(fmaxf(fmaxf(qx, qy), qz), 0.0f);
    d = fminf(d, outside + inside - q[6]);
  }
  for (int i = 0; i < s.n_mb; ++i, q += 4) {
    const float sc = q[3];
    const float lx = (px - q[0]) / sc;
    const float ly = (py - q[1]) / sc;
    const float lz = (pz - q[2]) / sc;
    d = fminf(d, mandelbulb_pow8(lx, ly, lz, s.mb_iters) * sc);
  }
  return d;
}

}  // namespace tr
