// Scene distance field as a device function, shared by the march and the
// hard-shadow kernels (sdf_march.cu).
//
// Replaces the Pallas device functions `de_tile` (tpu_ray/kernels/
// pallas_sdf.py:126-162), `mandelbulb_de_pow8_components`
// (tpu_ray/sdf/mandelbulb.py:26-93) and `_mandelbulb_de_tile`
// (pallas_sdf.py:77-123), in their op order. The plain PyTorch version is
// tpu_ray_torch/sdf/primitives.py, written per component in the same order;
// the library builds with --fmad=false so that no multiply-add is
// contracted and both round alike. One difference from de_tile: the box's
// outside length clamps at 1e-12, as the reference's sdf_distance does
// (de_tile uses 1e-24; the two differ by 1e-6 only inside a box).
//
// Two Mandelbulb fields, picked per kernel instantiation by the template
// flag kPow8 (SdfScene.mb_pow8, passed by the wrappers as mb_pow8):
//   * mandelbulb_pow8, trig-free, for bulbs of power exactly 8;
//   * mandelbulb_generic, any power, in the op order of the port's plain
//     mandelbulb_de (tpu_ray_torch/sdf/mandelbulb.py). It calls atan2f,
//     sinf, cosf, powf and logf: the Pallas kernel's polynomial atan2_tile
//     (pallas_sdf.py:52-70) was a workaround for Mosaic, which lowers no
//     atan2; the plain versions and the reference's XLA path take a true
//     atan2. CUDA's transcendentals round otherwise than glibc's and
//     torch's, so this field equals its plain version to a few ulps per
//     iteration, not bit for bit (the power-8 field does).
//
// Packed parameter layout (float32, contiguous), in this order:
//   spheres  n_sph x 4 : cx cy cz radius
//   planes   n_pln x 4 : nx ny nz offset          (dot(p, n) - offset)
//   boxes    n_box x 7 : cx cy cz hx hy hz round
//   bulbs    n_mb  x 5 : cx cy cz scale power     (power unread by kPow8)
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

constexpr int kBulbStride = 5;  // packed floats a bulb

struct SdfParams {
  const float* p;
  int n_sph, n_pln, n_box, n_mb, mb_iters;
  int mb_pow8;  // the field the entry points instantiate: 1 power 8, 0 generic
};

// Scalar functions the Mandelbulb fields share with their adjoint
// (sdf_adj.cuh overloads them on its Dual type).
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float pow_(float b, float e) { return powf(b, e); }
// ... and on double (the reconstruct kernel's generic-field normal)
__device__ __forceinline__ double val(double x) { return x; }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ double pow_(double b, double e) { return pow(b, e); }
// max(x, c) and min(x, c) with torch's clamp gradients: x passes through
// where x >= c (resp. x <= c), the constant elsewhere.
template <typename T>
__device__ __forceinline__ T max_c(T x, float c) { return val(x) >= c ? x : T(c); }
template <typename T>
__device__ __forceinline__ T min_c(T x, float c) { return val(x) <= c ? x : T(c); }

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

// One live iteration of the generic field, z <- z^power + p with its
// running derivative dr, given r_new = |z| (clamped at kRmin): the op order
// of mandelbulb_de's loop body.
template <typename T>
__device__ __forceinline__ void mb_generic_step(T& zx, T& zy, T& zz, T& dr, T r_new,
                                                T px, T py, T pz, T power) {
  const T r_safe = min_c(max_c(r_new, kRmin), kBailout);
  const T rho = sqrt_(max_c(zx * zx + zy * zy, kRmin2));
  const T theta = atan2_(rho, zz);
  const T phi = atan2_(zy, zx);
  const T r_pm1 = pow_(r_safe, power - T(1.0f));
  dr = r_pm1 * power * dr + T(1.0f);
  const T zr = r_pm1 * r_safe;
  const T th = theta * power;
  const T ph = phi * power;
  const T sin_th = sin_(th);
  zx = zr * (sin_th * cos_(ph)) + px;
  zy = zr * (sin_(ph) * sin_th) + py;
  zz = zr * cos_(th) + pz;
}

// Generic-power Mandelbulb DE in the bulb's local frame, with the same
// escape-freeze as mandelbulb_pow8 (the loop exit).
__device__ __forceinline__ float mandelbulb_generic(float px, float py, float pz,
                                                    float power, int iters) {
  float r = sqrtf(fmaxf(px * px + py * py + pz * pz, kRmin2));
  float zx = px, zy = py, zz = pz, dr = 1.0f;
  for (int it = 0; it < iters; ++it) {
    const float r_new = sqrtf(fmaxf(zx * zx + zy * zy + zz * zz, kRmin2));
    r = r_new;
    if (!(r_new <= kBailout)) break;
    mb_generic_step(zx, zy, zz, dr, r_new, px, py, pz, power);
  }
  r = fmaxf(r, kRmin);
  return 0.5f * logf(r) * r / dr;
}

// One bulb's distance at p (its packed row q), by the field kPow8 picks.
template <bool kPow8>
__device__ __forceinline__ float bulb_de(const float* q, float px, float py,
                                         float pz, int iters) {
  const float sc = q[3];
  const float lx = (px - q[0]) / sc;
  const float ly = (py - q[1]) / sc;
  const float lz = (pz - q[2]) / sc;
  return (kPow8 ? mandelbulb_pow8(lx, ly, lz, iters)
                : mandelbulb_generic(lx, ly, lz, q[4], iters)) * sc;
}

// The three closed-form primitives' distances at p, from their packed rows.
__device__ __forceinline__ float sphere_de(const float* q, float px, float py, float pz) {
  const float qx = px - q[0], qy = py - q[1], qz = pz - q[2];
  return sqrtf(fmaxf(qx * qx + qy * qy + qz * qz, 1e-12f)) - q[3];
}
__device__ __forceinline__ float plane_de(const float* q, float px, float py, float pz) {
  return px * q[0] + py * q[1] + pz * q[2] - q[3];
}
__device__ __forceinline__ float box_de(const float* q, float px, float py, float pz) {
  const float qx = fabsf(px - q[0]) - q[3];
  const float qy = fabsf(py - q[1]) - q[4];
  const float qz = fabsf(pz - q[2]) - q[5];
  const float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
  const float outside = sqrtf(fmaxf(ox * ox + oy * oy + oz * oz, 1e-12f));
  const float inside = fminf(fmaxf(fmaxf(qx, qy), qz), 0.0f);
  return outside + inside - q[6];
}

template <bool kPow8>
__device__ __forceinline__ float scene_de(const SdfParams& s, float px,
                                          float py, float pz) {
  float d = kBig;
  const float* q = s.p;
  for (int i = 0; i < s.n_sph; ++i, q += 4) d = fminf(d, sphere_de(q, px, py, pz));
  for (int i = 0; i < s.n_pln; ++i, q += 4) d = fminf(d, plane_de(q, px, py, pz));
  for (int i = 0; i < s.n_box; ++i, q += 7) d = fminf(d, box_de(q, px, py, pz));
  for (int i = 0; i < s.n_mb; ++i, q += kBulbStride) {
    d = fminf(d, bulb_de<kPow8>(q, px, py, pz, s.mb_iters));
  }
  return d;
}

}  // namespace tr
