// Reverse-mode adjoint of the scene distance field, for the fused shade
// kernels (shade_chain.cuh, shade_fwd.cu, shade_bwd.cu).
//
// Replaces what `jax.vjp` of `de_tile` computes inside the Pallas backward
// `shade_bwd_pallas` (tpu_ray/kernels/pallas_shade.py:148-151 and 258-260):
// the gradient of the DE with respect to the point p and to the packed
// parameters of sdf.cuh, written by hand, for both Mandelbulb fields (the
// generic one's gradient includes d/d power, the reference's mb_power
// cotangent).
//
// Everything is a template on the scalar type T:
//   * T = float gives the first-order adjoint (the IFT numerator, the
//     denominator <grad_p DE, d> and the normal's grad_p DE); T = double
//     the same in double (the reconstruct kernel's generic-field normal);
//   * T = Dual, a value plus one tangent, run on p + eps*u, gives in its
//     tangent parts H*u and d2DE/dtheta dp * u: the pullback of the normal
//     (forward-over-reverse). Nothing of the Mandelbulb's second-order chain
//     is derived by hand, the generic field's d2DE/dp dpower included.
// Branches (escape, clamps, the min over primitives) read the value part
// only, as autograd's masks do. The Mandelbulb keeps sdf.cuh's escape-freeze
// and clamps. The forward keeps each iteration's z and dr, up to
// kMaxMbIters of them, in an MbStore, and the reverse pass reads them back;
// an iteration past those is recomputed forward from the last stored one,
// so any mb_iters works and a field of at most kMaxMbIters iterations
// recomputes nothing. The store is the caller's:
// the kernels give each thread a column of shared memory (a local array
// indexed by the loop's runtime iteration lived in local memory, ~800 B a
// thread, read back through the L1 and L2 caches), the host build a local
// array.
//
// The gradient of the min over primitives goes to the first primitive that
// attains it (torch.amin splits a tie evenly; ties have measure zero). Only
// that primitive's adjoint runs. In a scene of one bulb the argmin can run
// the bulb's DE as the adjoint's forward, so that a caller who takes the
// bulb's gradient at the same point runs the iterations once, not twice.
#pragma once

#include "sdf.cuh"

namespace tr {

constexpr int kMaxMbIters = 16;  // stored iterations of the reverse pass

// v + e * eps with eps^2 = 0.
struct Dual {
  float v, e;
  Dual() = default;
  __device__ __forceinline__ Dual(float v_, float e_ = 0.0f) : v(v_), e(e_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.e + b.e); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.e - b.e); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.e); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.v * b.e + a.e * b.v);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.e - q * b.e) / b.v);
}
__device__ __forceinline__ Dual& operator+=(Dual& a, Dual b) { a = a + b; return a; }
__device__ __forceinline__ Dual& operator-=(Dual& a, Dual b) { a = a - b; return a; }

// Where the reverse pass keeps the stored iterations: slot 4 it + c holds
// iteration it's z (c = 0, 1, 2) and dr (c = 3), its value at
// p[slot * stride] and, for a Dual, its tangent tan_off floats further; a
// double at p64[slot * stride].
struct MbStore {
  float* p;
  int stride, tan_off;
  double* p64;
};

// Slots a Mandelbulb of `iters` iterations stores (a Dual takes two floats
// a slot, a float one).
__host__ __device__ __forceinline__ int mb_store_slots(int iters) {
  return 4 * (iters < kMaxMbIters ? iters : kMaxMbIters);
}
__device__ __forceinline__ void mb_put(const MbStore& st, int slot, float x) {
  st.p[slot * st.stride] = x;
}
__device__ __forceinline__ void mb_put(const MbStore& st, int slot, Dual x) {
  st.p[slot * st.stride] = x.v;
  st.p[slot * st.stride + st.tan_off] = x.e;
}
__device__ __forceinline__ void mb_get(const MbStore& st, int slot, float& x) {
  x = st.p[slot * st.stride];
}
__device__ __forceinline__ void mb_put(const MbStore& st, int slot, double x) {
  st.p64[slot * st.stride] = x;
}
__device__ __forceinline__ void mb_get(const MbStore& st, int slot, double& x) {
  x = st.p64[slot * st.stride];
}
__device__ __forceinline__ void mb_get(const MbStore& st, int slot, Dual& x) {
  x = Dual(st.p[slot * st.stride], st.p[slot * st.stride + st.tan_off]);
}

__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float tan_(Dual x) { return x.e; }
__device__ __forceinline__ Dual sqrt_(Dual x) {
  const float s = sqrtf(x.v);
  return Dual(s, x.e / (2.0f * s));
}
__device__ __forceinline__ Dual log_(Dual x) { return Dual(logf(x.v), x.e / x.v); }
__device__ __forceinline__ Dual sin_(Dual x) { return Dual(sinf(x.v), cosf(x.v) * x.e); }
__device__ __forceinline__ Dual cos_(Dual x) { return Dual(cosf(x.v), -(sinf(x.v) * x.e)); }
__device__ __forceinline__ Dual atan2_(Dual y, Dual x) {
  return Dual(atan2f(y.v, x.v), (x.v * y.e - y.v * x.e) / (x.v * x.v + y.v * y.v));
}
// b^e, differentiable in both: d b^e = b^e (e / b db + ln b de)
__device__ __forceinline__ Dual pow_(Dual b, Dual e) {
  const float v = powf(b.v, e.v);
  return Dual(v, v * (e.v / b.v * b.e + logf(b.v) * e.e));
}

// Primitive kinds, in the packed layout's order.
enum PrimKind { kSphere = 0, kPlane = 1, kBox = 2, kBulb = 3 };
__device__ __forceinline__ int prim_stride(int kind) {
  return kind == kBox ? 7 : (kind == kBulb ? kBulbStride : 4);
}

// One live power-8 iteration (sdf.cuh's mandelbulb_pow8 loop body).
template <typename T>
__device__ __forceinline__ void mb_pow8_step(T& zx, T& zy, T& zz, T& dr, T r_new,
                                             T px, T py, T pz) {
  const T r_safe = min_c(max_c(r_new, kRmin), kBailout);
  const T rho2 = max_c(zx * zx + zy * zy, kRmin2);
  const T rho = sqrt_(rho2);
  const T h = sqrt_(rho2 + zz * zz);
  const T inv_h = T(1.0f) / h;
  T st = rho * inv_h, ct = zz * inv_h;
  const T inv_rho = T(1.0f) / rho;
  T sp = zy * inv_rho, cp = zx * inv_rho;
  for (int k = 0; k < 3; ++k) {
    const T st2 = T(2.0f) * st * ct, ct2 = ct * ct - st * st;
    const T sp2 = T(2.0f) * sp * cp, cp2 = cp * cp - sp * sp;
    st = st2; ct = ct2; sp = sp2; cp = cp2;
  }
  const T r2s = r_safe * r_safe;
  const T r4 = r2s * r2s;
  const T r7 = r4 * r2s * r_safe;
  const T r8 = r4 * r4;
  dr = T(8.0f) * r7 * dr + T(1.0f);
  zx = r8 * st * cp + px;
  zy = r8 * st * sp + py;
  zz = r8 * ct + pz;
}

// One live iteration of the field kPow8 picks, from z (and dr) to the next.
template <bool kPow8, typename T>
__device__ __forceinline__ void mb_step(T& zx, T& zy, T& zz, T& dr, T px, T py,
                                        T pz, T power) {
  const T r_new = sqrt_(max_c(zx * zx + zy * zy + zz * zz, kRmin2));
  if (kPow8)
    mb_pow8_step(zx, zy, zz, dr, r_new, px, py, pz);
  else
    mb_generic_step(zx, zy, zz, dr, r_new, px, py, pz, power);
}

// Reverse of one power-8 iteration from z0 = (zx0, zy0, zz0), dr0: given the
// cotangents of the next z (dz) and dr (d_dr), sets d_dr to that of dr0 and
// returns in d_rs the cotangent of r_safe (its r_new's clamp is the
// caller's); dz becomes the cotangent of z0 through the angles.
template <typename T>
__device__ __forceinline__ void mb_pow8_step_adj(T zx0, T zy0, T zz0, T dr0, T r_safe,
                                                 T dz[3], T& d_dr, T& d_rs) {
  const T rho2_raw = zx0 * zx0 + zy0 * zy0;
  const T rho2 = max_c(rho2_raw, kRmin2);
  const T rho = sqrt_(rho2);
  const T h = sqrt_(rho2 + zz0 * zz0);
  const T inv_h = T(1.0f) / h;
  const T inv_rho = T(1.0f) / rho;
  T sts[4], cts[4], sps[4], cps[4];
  sts[0] = rho * inv_h; cts[0] = zz0 * inv_h;
  sps[0] = zy0 * inv_rho; cps[0] = zx0 * inv_rho;
  for (int k = 0; k < 3; ++k) {
    sts[k + 1] = T(2.0f) * sts[k] * cts[k];
    cts[k + 1] = cts[k] * cts[k] - sts[k] * sts[k];
    sps[k + 1] = T(2.0f) * sps[k] * cps[k];
    cps[k + 1] = cps[k] * cps[k] - sps[k] * sps[k];
  }
  const T st = sts[3], ct = cts[3], sp = sps[3], cp = cps[3];
  const T r2s = r_safe * r_safe;
  const T r4 = r2s * r2s;
  const T r8 = r4 * r4;
  const T r7 = r4 * r2s * r_safe;

  const T dzx = dz[0], dzy = dz[1], dzz = dz[2];
  const T d_r8 = dzx * st * cp + dzy * st * sp + dzz * ct;
  T d_st = (dzx * cp + dzy * sp) * r8;
  T d_cp = dzx * r8 * st;
  T d_sp = dzy * r8 * st;
  T d_ct = dzz * r8;
  const T d_r7 = d_dr * T(8.0f) * dr0;
  d_dr = d_dr * T(8.0f) * r7;
  T d_r4 = T(2.0f) * r4 * d_r8 + d_r7 * r2s * r_safe;
  T d_r2s = d_r7 * r4 * r_safe;
  d_rs = d_r7 * r4 * r2s;
  d_r2s += T(2.0f) * r2s * d_r4;
  d_rs += T(2.0f) * r_safe * d_r2s;
  for (int k = 2; k >= 0; --k) {
    const T n_st = d_st * T(2.0f) * cts[k] - d_ct * T(2.0f) * sts[k];
    const T n_ct = d_st * T(2.0f) * sts[k] + d_ct * T(2.0f) * cts[k];
    const T n_sp = d_sp * T(2.0f) * cps[k] - d_cp * T(2.0f) * sps[k];
    const T n_cp = d_sp * T(2.0f) * sps[k] + d_cp * T(2.0f) * cps[k];
    d_st = n_st; d_ct = n_ct; d_sp = n_sp; d_cp = n_cp;
  }
  // st0 = rho/h, ct0 = z/h, sp0 = y/rho, cp0 = x/rho
  T d_rho = d_st * inv_h;
  const T d_inv_h = d_st * rho + d_ct * zz0;
  T nzz = d_ct * inv_h;
  T nzy = d_sp * inv_rho;
  T nzx = d_cp * inv_rho;
  const T d_inv_rho = d_sp * zy0 + d_cp * zx0;
  d_rho -= d_inv_rho * inv_rho * inv_rho;
  const T d_h = -(d_inv_h * inv_h * inv_h);
  const T d_hin = d_h * T(0.5f) / h;  // h = sqrt(rho2 + z^2)
  T d_rho2 = d_hin + d_rho * T(0.5f) / rho;
  nzz += T(2.0f) * zz0 * d_hin;
  if (val(rho2_raw) >= kRmin2) {
    nzx += T(2.0f) * zx0 * d_rho2;
    nzy += T(2.0f) * zy0 * d_rho2;
  }
  dz[0] = nzx; dz[1] = nzy; dz[2] = nzz;
}

// Reverse of one generic iteration (sdf.cuh's mb_generic_step), as
// mb_pow8_step_adj, adding the iteration's d/d power to d_pow. Where
// autograd's rules have a formula (atan2, pow) it is theirs; like autograd,
// phi = atan2(y, x) gives NaN on the z axis.
template <typename T>
__device__ __forceinline__ void mb_generic_step_adj(T zx0, T zy0, T zz0, T dr0, T r_safe,
                                                    T power, T dz[3], T& d_dr, T& d_rs,
                                                    T& d_pow) {
  const T rho2_raw = zx0 * zx0 + zy0 * zy0;
  const T rho = sqrt_(max_c(rho2_raw, kRmin2));
  const T theta = atan2_(rho, zz0);
  const T phi = atan2_(zy0, zx0);
  const T pm1 = power - T(1.0f);
  const T r_pm1 = pow_(r_safe, pm1);
  const T zr = r_pm1 * r_safe;
  const T th = theta * power;
  const T ph = phi * power;
  const T sin_th = sin_(th), cos_th = cos_(th), sin_ph = sin_(ph), cos_ph = cos_(ph);
  // z' = zr * (sin_th cos_ph, sin_ph sin_th, cos_th) + p
  const T dzx = dz[0], dzy = dz[1], dzz = dz[2];
  const T d_zr = dzx * (sin_th * cos_ph) + dzy * (sin_ph * sin_th) + dzz * cos_th;
  const T d_a = dzx * zr, d_b = dzy * zr, d_c = dzz * zr;
  const T d_sin_th = d_a * cos_ph + d_b * sin_ph;
  const T d_th = d_sin_th * cos_th - d_c * sin_th;
  const T d_ph = d_b * sin_th * cos_ph - d_a * sin_th * sin_ph;
  const T d_theta = d_th * power;
  const T d_phi = d_ph * power;
  d_pow += d_th * theta + d_ph * phi;
  // dr' = (r_pm1 * power) * dr + 1
  const T d_m = d_dr * dr0;
  d_dr = d_dr * (r_pm1 * power);
  const T d_rpm1 = d_zr * r_safe + d_m * power;
  d_pow += d_m * r_pm1;
  // r_pm1 = r_safe^(power - 1): torch's pow rules for base and exponent
  d_rs = d_zr * r_pm1 + d_rpm1 * (pm1 * pow_(r_safe, pm1 - T(1.0f)));
  d_pow += d_rpm1 * (r_pm1 * log_(r_safe));
  // theta = atan2(rho, z), phi = atan2(y, x): torch's atan2 rule
  const T rec_t = T(1.0f) / (rho * rho + zz0 * zz0);
  const T d_rho = d_theta * zz0 * rec_t;
  T nzz = d_theta * -rho * rec_t;
  const T rec_p = T(1.0f) / (zy0 * zy0 + zx0 * zx0);
  T nzy = d_phi * zx0 * rec_p;
  T nzx = d_phi * -zy0 * rec_p;
  if (val(rho2_raw) >= kRmin2) {  // rho = sqrt(max(x^2 + y^2, rmin^2))
    const T d_rho2 = d_rho / (T(2.0f) * rho);
    nzx += T(2.0f) * zx0 * d_rho2;
    nzy += T(2.0f) * zy0 * d_rho2;
  }
  dz[0] = nzx; dz[1] = nzy; dz[2] = nzz;
}

// The Mandelbulb forward as its adjoint runs it: from z_0 = p, each live
// iteration's z and dr stored in st (up to kMaxMbIters of them) before its
// update. What the reverse pass starts from besides the store: the last z
// and dr, the final r (|z| at the escape or the last iteration; |p| when no
// iteration ran), the updates made and the iteration whose |z| is r (-1:
// none). `valid` marks a forward that a caller kept for prim_adj.
template <typename T>
struct MbFwd {
  T zx, zy, zz, dr, r;
  int n_upd, last;
  bool valid;
};

// The forward of the field kPow8 picks at the local point p (z_0 = p),
// filling f and st; returns the DE, op for op as mandelbulb_pow8 and
// mandelbulb_generic (sdf.cuh) compute it.
template <typename T, bool kPow8>
__device__ __forceinline__ T mandelbulb_fwd(T px, T py, T pz, T power, int iters,
                                            MbFwd<T>* f, const MbStore& st) {
  T zx = px, zy = py, zz = pz, dr = T(1.0f);
  T r = sqrt_(max_c(px * px + py * py + pz * pz, kRmin2));
  int n_upd = 0;   // z updates made
  int last = -1;   // iteration whose |z| is the final r (-1: the initial r)
  for (int it = 0; it < iters; ++it) {
    const T r_new = sqrt_(max_c(zx * zx + zy * zy + zz * zz, kRmin2));
    r = r_new;
    last = it;
    if (!(val(r_new) <= kBailout)) break;
    if (it < kMaxMbIters) {
      mb_put(st, 4 * it, zx);
      mb_put(st, 4 * it + 1, zy);
      mb_put(st, 4 * it + 2, zz);
      mb_put(st, 4 * it + 3, dr);
    }
    if (kPow8)
      mb_pow8_step(zx, zy, zz, dr, r_new, px, py, pz);
    else
      mb_generic_step(zx, zy, zz, dr, r_new, px, py, pz, power);
    n_upd = it + 1;
  }
  f->zx = zx; f->zy = zy; f->zz = zz; f->dr = dr; f->r = r;
  f->n_upd = n_upd; f->last = last;
  const T rr = max_c(r, kRmin);
  const T a = T(0.5f) * log_(rr);
  return a * rr / dr;
}

// The reverse pass from mandelbulb_fwd's f (and its store) at the same
// local point p: the gradient g with respect to p; the generic field also
// adds d/d power to *d_pow (the power-8 field does not read it). Returns
// the DE.
template <typename T, bool kPow8>
__device__ T mandelbulb_rev(T px, T py, T pz, T power, MbFwd<T> f, T g[3], T* d_pow,
                            const MbStore& st) {
  const T zx = f.zx, zy = f.zy, zz = f.zz, dr = f.dr, r = f.r;
  const int n_upd = f.n_upd, last = f.last;
  const T rr = max_c(r, kRmin);
  const T a = T(0.5f) * log_(rr);
  const T b = a * rr;
  const T de = b / dr;

  // reverse: de = (0.5 log(rr) * rr) / dr
  T d_dr = -(b / dr) / dr;
  const T d_b = T(1.0f) / dr;
  const T d_rr = d_b * a + d_b * rr * T(0.5f) / rr;
  const T d_r = val(r) >= kRmin ? d_rr : T(0.0f);
  T gx = T(0.0f), gy = T(0.0f), gz = T(0.0f);  // d/d(local p)
  T dz[3] = {T(0.0f), T(0.0f), T(0.0f)};  // d/d(z of the step)
  T d_pw = T(0.0f);
  if (last < 0) {  // no iteration: r is |p|
    if (val(px * px + py * py + pz * pz) >= kRmin2) {
      const T w = d_r / r;
      gx += px * w; gy += py * w; gz += pz * w;
    }
  } else if (last == n_upd) {  // escaped: r is |z| after the last update
    if (val(zx * zx + zy * zy + zz * zz) >= kRmin2) {
      const T w = d_r / r;
      dz[0] = zx * w; dz[1] = zy * w; dz[2] = zz * w;
    }
  }
  for (int it = n_upd - 1; it >= 0; --it) {
    // z_{it+1} = f(z_it) + p
    gx += dz[0]; gy += dz[1]; gz += dz[2];
    T zx0, zy0, zz0, dr0;
    const int row = 4 * (it < kMaxMbIters ? it : kMaxMbIters - 1);
    mb_get(st, row, zx0);
    mb_get(st, row + 1, zy0);
    mb_get(st, row + 2, zz0);
    mb_get(st, row + 3, dr0);
    if (it >= kMaxMbIters) {  // past the stored iterations: forward from the last stored one
      for (int j = kMaxMbIters - 1; j < it; ++j)
        mb_step<kPow8>(zx0, zy0, zz0, dr0, px, py, pz, power);
    }
    const T s2 = zx0 * zx0 + zy0 * zy0 + zz0 * zz0;
    const T r_new = sqrt_(max_c(s2, kRmin2));
    const T r_safe = min_c(max_c(r_new, kRmin), kBailout);
    T d_rs;
    if (kPow8)
      mb_pow8_step_adj(zx0, zy0, zz0, dr0, r_safe, dz, d_dr, d_rs);
    else
      mb_generic_step_adj(zx0, zy0, zz0, dr0, r_safe, power, dz, d_dr, d_rs, d_pw);
    const auto rn = val(r_new);
    T d_rnew = (rn >= kRmin && rn <= kBailout) ? d_rs : T(0.0f);
    if (it == last) d_rnew += d_r;  // no escape: r is this step's |z|
    if (val(s2) >= kRmin2) {
      const T w = d_rnew / r_new;
      dz[0] += zx0 * w; dz[1] += zy0 * w; dz[2] += zz0 * w;
    }
  }
  if (last >= 0) {  // z_0 is p
    gx += dz[0]; gy += dz[1]; gz += dz[2];
  }
  g[0] = gx; g[1] = gy; g[2] = gz;
  if (!kPow8) *d_pow += d_pw;
  return de;
}

// The Mandelbulb DE of the field kPow8 picks (sdf.cuh) and its gradient g
// with respect to the local point (the forward, then the reverse pass).
template <typename T, bool kPow8>
__device__ T mandelbulb_adj(T px, T py, T pz, T power, int iters, T g[3], T* d_pow,
                            const MbStore& st) {
  MbFwd<T> f;
  mandelbulb_fwd<T, kPow8>(px, py, pz, power, iters, &f, st);
  return mandelbulb_rev<T, kPow8>(px, py, pz, power, f, g, d_pow, st);
}

// The primitive that attains the scene DE at p (first on a tie), by the
// float forward of sdf.cuh in its op order. Returns its packed offset and
// kind, or -1 when the scene has no primitive; dmin, when given, receives
// the DE itself. Given fwd and st in a scene of one bulb, the bulb's DE
// runs as its adjoint's forward (mandelbulb_fwd, the same ops): its
// iterations go to st and its end state to fwd, marked valid, so that
// prim_adj at p need not run them again.
template <bool kPow8>
__device__ __forceinline__ int scene_argmin(const SdfParams& s, float px,
                                            float py, float pz, int* kind,
                                            float* dmin = nullptr,
                                            MbFwd<float>* fwd = nullptr,
                                            const MbStore* st = nullptr) {
  float d = kBig;
  int best = -1;
  const float* q = s.p;
  for (int i = 0; i < s.n_sph; ++i, q += 4) {
    const float qx = px - q[0], qy = py - q[1], qz = pz - q[2];
    const float di = sqrtf(fmaxf(qx * qx + qy * qy + qz * qz, 1e-12f)) - q[3];
    if (di < d) { d = di; best = static_cast<int>(q - s.p); *kind = kSphere; }
  }
  for (int i = 0; i < s.n_pln; ++i, q += 4) {
    const float di = px * q[0] + py * q[1] + pz * q[2] - q[3];
    if (di < d) { d = di; best = static_cast<int>(q - s.p); *kind = kPlane; }
  }
  for (int i = 0; i < s.n_box; ++i, q += 7) {
    const float qx = fabsf(px - q[0]) - q[3];
    const float qy = fabsf(py - q[1]) - q[4];
    const float qz = fabsf(pz - q[2]) - q[5];
    const float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
    const float outside = sqrtf(fmaxf(ox * ox + oy * oy + oz * oz, 1e-12f));
    const float inside = fminf(fmaxf(fmaxf(qx, qy), qz), 0.0f);
    const float di = outside + inside - q[6];
    if (di < d) { d = di; best = static_cast<int>(q - s.p); *kind = kBox; }
  }
  if (fwd) fwd->valid = st != nullptr && s.n_mb == 1;
  for (int i = 0; i < s.n_mb; ++i, q += kBulbStride) {
    float di;
    if (fwd && fwd->valid) {  // bulb_de's local point and scale, its field's forward
      const float sc = q[3];
      const float lx = (px - q[0]) / sc, ly = (py - q[1]) / sc, lz = (pz - q[2]) / sc;
      di = mandelbulb_fwd<float, kPow8>(lx, ly, lz, q[4], s.mb_iters, fwd, *st) * sc;
    } else {
      di = bulb_de<kPow8>(q, px, py, pz, s.mb_iters);
    }
    if (di < d) { d = di; best = static_cast<int>(q - s.p); *kind = kBulb; }
  }
  if (dmin) *dmin = d;
  return best;
}

// Gradient of one primitive's distance at p: dp (3) and dth (its packed
// parameters, prim_stride(kind) of them, in layout order). fwd: a valid
// forward of this bulb at p (scene_argmin's), whose store the reverse pass
// reads instead of running the iterations again.
template <typename T, bool kPow8>
__device__ __forceinline__ void prim_adj(const float* q, int kind, int mb_iters, T px, T py,
                                         T pz, T dp[3], T dth[7], const MbStore& st,
                                         const MbFwd<T>* fwd = nullptr) {
  for (int k = 0; k < 7; ++k) dth[k] = T(0.0f);
  if (kind == kSphere) {  // |p - c| - r
    const T ax = px - T(q[0]), ay = py - T(q[1]), az = pz - T(q[2]);
    const T s = ax * ax + ay * ay + az * az;
    const T len = sqrt_(max_c(s, 1e-12f));
    const T w = val(s) >= 1e-12f ? T(1.0f) / len : T(0.0f);
    dp[0] = ax * w; dp[1] = ay * w; dp[2] = az * w;
    dth[0] = -dp[0]; dth[1] = -dp[1]; dth[2] = -dp[2];
    dth[3] = T(-1.0f);
  } else if (kind == kPlane) {  // dot(p, n) - offset
    dp[0] = T(q[0]); dp[1] = T(q[1]); dp[2] = T(q[2]);
    dth[0] = px; dth[1] = py; dth[2] = pz;
    dth[3] = T(-1.0f);
  } else if (kind == kBox) {  // |max(q, 0)| + min(max(q), 0) - round
    const T a[3] = {px - T(q[0]), py - T(q[1]), pz - T(q[2])};
    T qq[3], o[3];
    for (int k = 0; k < 3; ++k) {
      const float sg = val(a[k]) > 0.0f ? 1.0f : (val(a[k]) < 0.0f ? -1.0f : 0.0f);
      qq[k] = a[k] * T(sg) - T(q[3 + k]);
      o[k] = max_c(qq[k], 0.0f);
    }
    const T s = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
    const T outside = sqrt_(max_c(s, 1e-12f));
    T dq[3];
    const T w = val(s) >= 1e-12f ? T(1.0f) / outside : T(0.0f);
    for (int k = 0; k < 3; ++k) dq[k] = val(qq[k]) >= 0.0f ? o[k] * w : T(0.0f);
    // inside = min(max(qx, qy, qz), 0): the first largest component (the
    // selects keep dq in registers, where a runtime index would not)
    int kmax = 0;
    if (val(qq[1]) > val(qq[0])) kmax = 1;
    if (val(qq[2]) > (kmax == 1 ? val(qq[1]) : val(qq[0]))) kmax = 2;
    const float qmax = kmax == 0 ? val(qq[0]) : (kmax == 1 ? val(qq[1]) : val(qq[2]));
    for (int k = 0; k < 3; ++k)
      if (k == kmax && qmax <= 0.0f) dq[k] += T(1.0f);
    for (int k = 0; k < 3; ++k) {
      const float sg = val(a[k]) > 0.0f ? 1.0f : (val(a[k]) < 0.0f ? -1.0f : 0.0f);
      dp[k] = dq[k] * T(sg);
      dth[k] = -dp[k];
      dth[3 + k] = -dq[k];
    }
    dth[6] = T(-1.0f);
  } else {  // bulb: mb((p - c) / s, power) * s
    const T sc = T(q[3]);
    const T lx = (px - T(q[0])) / sc, ly = (py - T(q[1])) / sc,
            lz = (pz - T(q[2])) / sc;
    T gl[3], d_pow = T(0.0f);
    MbFwd<T> f;
    if (fwd && fwd->valid)
      f = *fwd;
    else
      mandelbulb_fwd<T, kPow8>(lx, ly, lz, T(q[4]), mb_iters, &f, st);
    const T m = mandelbulb_rev<T, kPow8>(lx, ly, lz, T(q[4]), f, gl, &d_pow, st);
    dp[0] = gl[0]; dp[1] = gl[1]; dp[2] = gl[2];
    dth[0] = -gl[0]; dth[1] = -gl[1]; dth[2] = -gl[2];
    dth[3] = m - (gl[0] * lx + gl[1] * ly + gl[2] * lz);
    dth[4] = d_pow * sc;
  }
}

}  // namespace tr
