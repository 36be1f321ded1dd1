// The shade chain's per-ray forward, shared by the fused forward kernel
// (shade_fwd.cu) and the fused backward (shade_bwd.cu), so that the two
// recompute one and the same chain.
//
// It follows the port's plain shade (tpu_ray_torch/render/render.py
// `_shade_plain`: reconstruct_hits + shading.shade), which is the Pallas
// chain `_local_shade` (tpu_ray/kernels/pallas_shade.py:117-376) in
// torch's op order: the selected hit (the SDF hit at the march t, or at the
// closest approach tmin with soft silhouettes; the Moller-Trumbore re-solve
// of the selected triangle), the normal (grad_p DE, or the triangle's), the
// two-sided flip, the 5-tap AO, the lights with the static visibility and
// the diff_vis penumbra, and the coverage: the soft SDF silhouette
// sigmoid(-DE(o + tmin d) / width), the mesh edge band
// clip(margin / width, 0, 1), and their mixed select.
//
// Everything here is plain C++ apart from the qualifiers, so that it also
// builds as host code (the CPU tests hold that build against the plain
// version). Two steps of the chain run in an order of their own, each with
// the same ops per value as the plain one: the bulb's forward at the hit
// runs once (scene_argmin's, stored for the normal's adjoint), and in the
// forward's power-8 build and the backward's generic one the five AO taps'
// DEs run in lock-step (scene_de_taps). Built with TR_SHADE_SERIAL, the chain takes the serial
// order (the argmin, then the adjoint's own forward; the taps one after
// another): the CPU tests hold the two builds bit-equal. The functions that read the distance field are templates on its
// Mandelbulb (kPow8: sdf.cuh), as are the kernels over them; those that run
// its adjoint take the thread's MbStore (sdf_adj.cuh). The functions a
// kernel calls once are forced inline, so that the arrays they fill stay in
// registers.
#pragma once

#include <stdint.h>

#include "sdf_adj.cuh"

namespace tr {

// The chain in its serial order (TR_SHADE_SERIAL, host tests only): the
// argmin, then the normal's adjoint with its own forward of the bulb; the
// AO taps one after another.
#ifdef TR_SHADE_SERIAL
constexpr bool kSerialChain = true;
#else
constexpr bool kSerialChain = false;
#endif

constexpr float kDenomMin = 1e-6f;  // the IFT denominator's clamp
constexpr float kDetEps = 1e-10f;   // the Moller-Trumbore determinant's
constexpr int kAoTaps = 5;

// The small parameters, packed in one float block whose layout is also the
// layout of their cotangents: the SDF block of sdf.cuh, then albedo (K,3),
// light directions and colours (L,3 each), ambient, bg_top, bg_bottom (3
// each), point-light positions and colours (P,3 each). The chain's flags
// and constants ride beside it.
struct ShadeParams {
  SdfParams sdf;  // sdf.p is the start of the block
  int n_mat, n_dir, n_pos;
  int use_sdf, use_mesh;
  int ao_sdf, ao_mesh;  // the AO taps' SDF term, their mesh term (ao_tmesh)
  int soft_diff;        // the penumbra recompute at the sh_ts residual
  float soft_sil;       // the soft SDF silhouette's width (0: hard)
  float mesh_sil;       // the mesh edge band's width (0: hard)
  double ao_step;       // in double: the tap heights round as the host's do
  float ao_strength, soft_k, bias;
  int off_alb, off_ldir, off_lcol, off_amb, off_bgt, off_bgb, off_lpos, off_lpcol;
  int n_par;
};

__host__ __device__ __forceinline__ ShadeParams make_params(
    const float* small, int n_sph, int n_pln, int n_box, int n_mb,
    int mb_iters, int mb_pow8, int n_mat, int n_dir, int n_pos, int use_sdf, int use_mesh,
    int ao_sdf, int ao_mesh, int soft_diff, float soft_sil, float mesh_sil,
    double ao_step, float ao_strength, float soft_k, float bias) {
  ShadeParams s;
  s.sdf = SdfParams{small, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  s.n_mat = n_mat; s.n_dir = n_dir; s.n_pos = n_pos;
  s.use_sdf = use_sdf; s.use_mesh = use_mesh;
  s.ao_sdf = ao_sdf; s.ao_mesh = ao_mesh; s.soft_diff = soft_diff;
  s.soft_sil = soft_sil; s.mesh_sil = mesh_sil;
  s.ao_step = ao_step; s.ao_strength = ao_strength;
  s.soft_k = soft_k; s.bias = bias;
  s.off_alb = 4 * n_sph + 4 * n_pln + 7 * n_box + kBulbStride * n_mb;
  s.off_ldir = s.off_alb + 3 * n_mat;
  s.off_lcol = s.off_ldir + 3 * n_dir;
  s.off_amb = s.off_lcol + 3 * n_dir;
  s.off_bgt = s.off_amb + 3;
  s.off_bgb = s.off_bgt + 3;
  s.off_lpos = s.off_bgb + 3;
  s.off_lpcol = s.off_lpos + 3 * n_pos;
  s.n_par = s.off_lpcol + 3 * n_pos;
  return s;
}

// One ray's inputs: the residuals of the geometry pass (and, for the
// backward, its output cotangent).
struct RayIn {
  float o[3], d[3], c[9];  // c: the selected triangle's v0, v1, v2
  float t_bar;             // SDF march t
  float tmin;              // the march's closest approach (soft silhouettes)
  bool hs, hm, closer;     // SDF hit, mesh hit, SDF selected (mixed)
  int mat;
  const float* vis;        // one value per light at stride vis_stride, or null
  const float* ts;         // the soft march's argmin t, as vis, or null
  int vis_stride;
  float t_mesh;            // ao_tmesh: the closest mesh hit along the normal
  float ct[3];
};

// Ray i of the kernels' inputs (null masks read as false, null corners and
// t's as 0, a null ct as 0).
__device__ __forceinline__ RayIn load_ray(
    int i, int n, const float* o, const float* d, const float* corners,
    const float* t_bar, const float* tmin, const uint8_t* hs,
    const uint8_t* hm, const uint8_t* closer, const int* mat,
    const float* vis, const float* ts, const float* ao_tmesh,
    const float* ct) {
  RayIn r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[3 * i + k];
    r.d[k] = d[3 * i + k];
    r.ct[k] = ct ? ct[3 * i + k] : 0.0f;
  }
  for (int k = 0; k < 9; ++k) r.c[k] = corners ? corners[9 * i + k] : 0.0f;
  r.t_bar = t_bar ? t_bar[i] : 0.0f;
  r.tmin = tmin ? tmin[i] : 0.0f;
  r.hs = hs ? hs[i] != 0 : false;
  r.hm = hm ? hm[i] != 0 : false;
  r.closer = closer ? closer[i] != 0 : false;
  r.mat = mat[i];
  r.vis = vis ? vis + i : nullptr;
  r.ts = ts ? ts + i : nullptr;
  r.vis_stride = n;
  r.t_mesh = ao_tmesh ? ao_tmesh[i] : 0.0f;
  return r;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// The soft-shadow penumbra recomputed at the march's argmin t:
// clip(soft_k * DE(q) / max(ts, bias), 0, 1) at q = p_off + ts * l. Writes q
// and whether the clip passes a gradient.
template <bool kPow8>
__device__ __forceinline__ float penumbra(const ShadeParams& s, const float* p_off,
                                 const float* l, float ts, float* q, bool* pass) {
  for (int k = 0; k < 3; ++k) q[k] = p_off[k] + ts * l[k];
  const float dd = scene_de<kPow8>(s.sdf, q[0], q[1], q[2]);
  const float raw = s.soft_k * dd / fmaxf(ts, s.bias);
  *pass = raw >= 0.0f && raw <= 1.0f;
  return fminf(fmaxf(raw, 0.0f), 1.0f);
}

// The scene DE at the five AO tap points p + h_i n, h_i = ao_step (i + 1):
// the closed-form primitives tap by tap, each bulb's iterations in
// lock-step over the taps. A tap's escape freezes it (its own live flag:
// its step is still computed, and dropped) and the loop runs while any tap
// lives, so each tap's DE is scene_de's, op for op, while the thread holds
// five independent chains for the scheduler to issue.
template <bool kPow8>
__device__ __forceinline__ void scene_de_taps(const SdfParams& s, const float* p,
                                              const float* n, double ao_step,
                                              float dd[kAoTaps]) {
  float px[kAoTaps], py[kAoTaps], pz[kAoTaps];
#pragma unroll
  for (int i = 0; i < kAoTaps; ++i) {
    const float h = static_cast<float>(ao_step * (i + 1));
    px[i] = p[0] + h * n[0];
    py[i] = p[1] + h * n[1];
    pz[i] = p[2] + h * n[2];
    dd[i] = kBig;
  }
  const float* q = s.p;
  for (int k = 0; k < s.n_sph; ++k, q += 4) {
#pragma unroll
    for (int i = 0; i < kAoTaps; ++i) dd[i] = fminf(dd[i], sphere_de(q, px[i], py[i], pz[i]));
  }
  for (int k = 0; k < s.n_pln; ++k, q += 4) {
#pragma unroll
    for (int i = 0; i < kAoTaps; ++i) dd[i] = fminf(dd[i], plane_de(q, px[i], py[i], pz[i]));
  }
  for (int k = 0; k < s.n_box; ++k, q += 7) {
#pragma unroll
    for (int i = 0; i < kAoTaps; ++i) dd[i] = fminf(dd[i], box_de(q, px[i], py[i], pz[i]));
  }
  for (int k = 0; k < s.n_mb; ++k, q += kBulbStride) {
    const float sc = q[3];
    float lx[kAoTaps], ly[kAoTaps], lz[kAoTaps], zx[kAoTaps], zy[kAoTaps], zz[kAoTaps];
    float dr[kAoTaps], r[kAoTaps];
    bool live[kAoTaps];
#pragma unroll
    for (int i = 0; i < kAoTaps; ++i) {  // bulb_de's local point, the field's start
      lx[i] = (px[i] - q[0]) / sc;
      ly[i] = (py[i] - q[1]) / sc;
      lz[i] = (pz[i] - q[2]) / sc;
      r[i] = sqrtf(fmaxf(lx[i] * lx[i] + ly[i] * ly[i] + lz[i] * lz[i], kRmin2));
      zx[i] = lx[i]; zy[i] = ly[i]; zz[i] = lz[i];
      dr[i] = 1.0f;
      live[i] = true;
    }
    for (int it = 0; it < s.mb_iters; ++it) {
      bool any = false;
#pragma unroll
      for (int i = 0; i < kAoTaps; ++i) {
        const float r_new = sqrtf(fmaxf(zx[i] * zx[i] + zy[i] * zy[i] + zz[i] * zz[i], kRmin2));
        if (live[i]) r[i] = r_new;
        live[i] = live[i] && r_new <= kBailout;
        float x = zx[i], y = zy[i], z = zz[i], w = dr[i];
        if (kPow8)
          mb_pow8_step(x, y, z, w, r_new, lx[i], ly[i], lz[i]);
        else
          mb_generic_step(x, y, z, w, r_new, lx[i], ly[i], lz[i], q[4]);
        if (live[i]) {
          zx[i] = x; zy[i] = y; zz[i] = z;
          dr[i] = w;
        }
        any = any || live[i];
      }
      if (!any) break;
    }
#pragma unroll
    for (int i = 0; i < kAoTaps; ++i) {
      const float rr = fmaxf(r[i], kRmin);
      dd[i] = fminf(dd[i], 0.5f * logf(rr) * rr / dr[i] * sc);
    }
  }
}

// The Moller-Trumbore re-solve of the ray's selected triangle
// (moller_trumbore.recompute_hit_corners).
struct MtSolve {
  float e1[3], e2[3], pv[3], qv[3], tv[3], cn[3];
  float det, inv_det, tm, cl;
  bool det_ok;
};

__device__ __forceinline__ void mt_solve(const RayIn& r, MtSolve* m) {
  const float* v0 = r.c;
  for (int k = 0; k < 3; ++k) {
    m->e1[k] = r.c[3 + k] - v0[k];
    m->e2[k] = r.c[6 + k] - v0[k];
    m->tv[k] = r.o[k] - v0[k];
  }
  cross3(r.d, m->e2, m->pv);
  m->det = dot3(m->e1, m->pv);
  m->det_ok = fabsf(m->det) > kDetEps;
  const float det_safe = m->det_ok ? m->det : (m->det >= 0.0f ? kDetEps : -kDetEps);
  m->inv_det = 1.0f / det_safe;
  cross3(m->tv, m->e1, m->qv);
  m->tm = dot3(m->e2, m->qv) * m->inv_det;
  cross3(m->e1, m->e2, m->cn);
  m->cl = sqrtf(fmaxf(dot3(m->cn, m->cn), 1e-12f));
}

// The mesh edge band's terms (moller_trumbore.edge_margin_corners): the
// barycentrics u, v, twice the area (floored at 1e-24 under the root, not
// the normal's 1e-12), the edge lengths l0 = |v2 - v1|, l1 = |e2|,
// l2 = |e1|, and the in-plane distances b_i * 2A / L_i to each edge, whose
// min is the margin.
struct EdgeBand {
  float u, v, two_area, l[3], dist[3];
};

__device__ __forceinline__ float edge_band(const RayIn& r, const MtSolve& m,
                                           EdgeBand* b) {
  b->u = dot3(m.tv, m.pv) * m.inv_det;
  b->v = dot3(r.d, m.qv) * m.inv_det;
  b->two_area = sqrtf(fmaxf(dot3(m.cn, m.cn), 1e-24f));
  float ex[3];
  for (int k = 0; k < 3; ++k) ex[k] = r.c[6 + k] - r.c[3 + k];
  b->l[0] = sqrtf(fmaxf(dot3(ex, ex), 1e-24f));
  b->l[1] = sqrtf(fmaxf(dot3(m.e2, m.e2), 1e-24f));
  b->l[2] = sqrtf(fmaxf(dot3(m.e1, m.e1), 1e-24f));
  b->dist[0] = (1.0f - b->u - b->v) * b->two_area / b->l[0];
  b->dist[1] = b->u * b->two_area / b->l[1];
  b->dist[2] = b->v * b->two_area / b->l[2];
  return fminf(b->dist[0], fminf(b->dist[1], b->dist[2]));
}

// One ray's forward up to its surface colour and coverage: what the
// backward pulls back through.
struct SurfFwd {
  bool sel_sdf;          // the SDF hit is selected (else the mesh hit)
  float t_eff;           // SDF: the ray parameter of p (t, or tmin on a miss)
  float p[3], n[3], nf[3], flip;
  int prim, kind;        // SDF: the primitive that attains the DE at p
  float g[3], gth[7], glen;  // SDF: grad_p DE and grad_theta DE at p
  float cov_s, cm, ratio, cov;  // coverages; ratio = margin / mesh_sil
  int mat;
  float ao;
  bool ao_pass;          // the AO clip passes
  unsigned tap_sdf;      // bit i: tap i's occluder is its DE (a mask, not an
                         // array: a runtime index would put f in local memory)
  float p_off[3];        // the shadow rays' origin
  float rad[3];
};

// The hit ray r's chain takes, as reconstruct_hits selects it: with an SDF
// and a mesh (mixed) the closest-select mask `closer` picks the SDF branch;
// on a lane that hits nothing `closer` is true (BIG <= BIG), so with soft
// silhouettes the SDF branch at tmin carries it.
__device__ __forceinline__ void select_hit(const ShadeParams& s, const RayIn& r,
                                           bool* sel_sdf, bool* sel_mesh) {
  const bool soft_sil = s.soft_sil > 0.0f;
  if (s.use_sdf && s.use_mesh) {
    *sel_sdf = r.closer && (r.hs || soft_sil);
    *sel_mesh = !r.closer && r.hm;
  } else {
    *sel_sdf = s.use_sdf && (r.hs || soft_sil);
    *sel_mesh = s.use_mesh && r.hm;
  }
}

// The ray parameter of an SDF-selected lane's point: the march t, or the
// closest approach tmin on a soft silhouette's miss.
__device__ __forceinline__ float sdf_t_eff(const ShadeParams& s, const RayIn& r) {
  return (r.hs || !(s.soft_sil > 0.0f)) ? r.t_bar : r.tmin;
}

// The ray's selected surface and its radiance, or false for a lane that
// selects no surface (its output is the sky and its coverage 0). Coverage,
// as reconstruct_hits: cov = (hm && !closer) ? cm : max(cov_s, cm); an
// SDF-only chain has cov_s, a mesh-only one cm. kLockstepTaps: the AO taps'
// DEs by scene_de_taps, where it measured faster on an H100 (chip_smoke.py
// phase launch, `mandelbulb` and `mandelbulb_power` blocks): in the
// forward with the power-8 field, in the backward with the generic one
// (7% off a launch). The generic forward ran 4% slower with it (a dead
// tap's step, still computed, costs its transcendentals) and the power-8
// backward 15% slower.
template <bool kPow8, bool kLockstepTaps = false>
__device__ __forceinline__ bool shade_surface(const ShadeParams& s, const RayIn& r,
                                              SurfFwd* f, const MbStore& st) {
  const float* P = s.sdf.p;
  const bool soft_sil = s.soft_sil > 0.0f;
  const bool mixed = s.use_sdf && s.use_mesh;
  bool sel_sdf, sel_mesh;
  select_hit(s, r, &sel_sdf, &sel_mesh);
  if (!sel_sdf && !sel_mesh) return false;
  f->sel_sdf = sel_sdf;

  // the mesh hit: its point and normal where selected, its edge band
  // wherever it hits (the mixed coverage reads cm on SDF-selected lanes too)
  f->cm = r.hm ? 1.0f : 0.0f;
  f->ratio = 0.0f;
  if (s.use_mesh && r.hm && (sel_mesh || s.mesh_sil > 0.0f)) {
    MtSolve m;
    mt_solve(r, &m);
    if (s.mesh_sil > 0.0f) {
      EdgeBand b;
      f->ratio = edge_band(r, m, &b) / s.mesh_sil;
      f->cm = fminf(fmaxf(f->ratio, 0.0f), 1.0f);
    }
    if (sel_mesh) {
      for (int k = 0; k < 3; ++k) {
        f->p[k] = r.o[k] + m.tm * r.d[k];
        f->n[k] = m.cn[k] / m.cl;
      }
    }
  }
  f->cov_s = r.hs ? 1.0f : 0.0f;
  f->prim = -1;
  if (sel_sdf) {
    f->t_eff = sdf_t_eff(s, r);
    for (int k = 0; k < 3; ++k) f->p[k] = r.o[k] + f->t_eff * r.d[k];
    float dmin;
    // the bulb's forward at p runs once: the argmin's, stored for the normal
    MbFwd<float> mb;
    f->prim = scene_argmin<kPow8>(s.sdf, f->p[0], f->p[1], f->p[2], &f->kind, &dmin,
                                  kSerialChain ? nullptr : &mb, &st);
    if (f->prim < 0) return false;  // no primitive: the wrappers never send such a scene
    prim_adj<float, kPow8>(P + f->prim, f->kind, s.sdf.mb_iters, f->p[0], f->p[1],
                           f->p[2], f->g, f->gth, st, kSerialChain ? nullptr : &mb);
    f->glen = sqrtf(fmaxf(dot3(f->g, f->g), 1e-12f));
    for (int k = 0; k < 3; ++k) f->n[k] = f->g[k] / f->glen;
    // on a miss the closest-approach point o + tmin d is p itself
    if (!r.hs && soft_sil) f->cov_s = 1.0f / (1.0f + expf(-(-dmin / s.soft_sil)));
  }
  if (mixed)
    f->cov = sel_mesh ? f->cm : fmaxf(f->cov_s, f->cm);
  else
    f->cov = s.use_sdf ? f->cov_s : f->cm;

  // two-sided: face the normal against the ray
  f->flip = dot3(f->n, r.d) > 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 3; ++k) f->nf[k] = f->flip * f->n[k];
  f->mat = r.mat < 0 ? 0 : (r.mat >= s.n_mat ? s.n_mat - 1 : r.mat);

  // 5-tap AO: occ = sum_i 0.7^(i-1) (h_i - min(DE(p + h_i nf), |t_mesh - h_i|))
  // over h_i = ao_step * i, ao = clip(1 - ao_strength * occ, 0, 1)
  f->ao = 1.0f;
  f->ao_pass = false;
  f->tap_sdf = 0u;
  if (s.ao_sdf || s.ao_mesh) {
    float occ = 0.0f;
    double w = 1.0;
    constexpr bool kLockstep = kLockstepTaps && !kSerialChain;
    float dd_sdf[kAoTaps];
    if (kLockstep && s.ao_sdf) scene_de_taps<kPow8>(s.sdf, f->p, f->nf, s.ao_step, dd_sdf);
#pragma unroll
    for (int i = 0; i < kAoTaps; ++i) {
      const float h = static_cast<float>(s.ao_step * (i + 1));
      float dd = 0.0f;
      bool tap_sdf = s.ao_sdf != 0;
      if (s.ao_sdf)
        dd = kLockstep ? dd_sdf[i]
                       : scene_de<kPow8>(s.sdf, f->p[0] + h * f->nf[0],
                                         f->p[1] + h * f->nf[1], f->p[2] + h * f->nf[2]);
      if (s.ao_mesh) {
        const float dm = fabsf(r.t_mesh - h);
        if (!s.ao_sdf || dm < dd) {
          dd = dm;
          tap_sdf = false;
        }
      }
      if (tap_sdf) f->tap_sdf |= 1u << i;
      occ = occ + static_cast<float>(w) * (h - dd);
      w *= 0.7;
    }
    const float ao_raw = 1.0f - s.ao_strength * occ;
    f->ao = fminf(fmaxf(ao_raw, 0.0f), 1.0f);
    f->ao_pass = ao_raw >= 0.0f && ao_raw <= 1.0f;
  }
  for (int k = 0; k < 3; ++k) f->p_off[k] = f->p[k] + s.bias * f->nf[k];

  // radiance = ambient * ao + sum of the lights' terms
  for (int c = 0; c < 3; ++c) f->rad[c] = P[s.off_amb + c] * f->ao;
  for (int li = 0; li < s.n_dir; ++li) {
    const float* lraw = P + s.off_ldir + 3 * li;
    const float ll = sqrtf(fmaxf(dot3(lraw, lraw), 1e-12f));
    const float l[3] = {lraw[0] / ll, lraw[1] / ll, lraw[2] / ll};
    const float ndotl = fmaxf(dot3(f->nf, l), 0.0f);
    float vis = r.vis ? r.vis[li * r.vis_stride] : 1.0f;
    if (s.soft_diff) {
      float q[3];
      bool pass;
      vis = vis * penumbra<kPow8>(s, f->p_off, l, r.ts[li * r.vis_stride], q, &pass);
    }
    for (int c = 0; c < 3; ++c) f->rad[c] += P[s.off_lcol + 3 * li + c] * (ndotl * vis);
  }
  for (int pi = 0; pi < s.n_pos; ++pi) {
    const float* lp = P + s.off_lpos + 3 * pi;
    const float lv[3] = {lp[0] - f->p[0], lp[1] - f->p[1], lp[2] - f->p[2]};
    const float dist2 = dot3(lv, lv);
    const float dist = sqrtf(fmaxf(dist2, 1e-12f));
    const float l[3] = {lv[0] / dist, lv[1] / dist, lv[2] / dist};
    const float ndotl = fmaxf(dot3(f->nf, l), 0.0f);
    float vis = r.vis ? r.vis[(s.n_dir + pi) * r.vis_stride] : 1.0f;
    if (s.soft_diff) {
      const float lvo[3] = {lp[0] - f->p_off[0], lp[1] - f->p_off[1], lp[2] - f->p_off[2]};
      const float dist_o = sqrtf(fmaxf(dot3(lvo, lvo), 1e-12f));
      const float lo[3] = {lvo[0] / dist_o, lvo[1] / dist_o, lvo[2] / dist_o};
      float q[3];
      bool pass;
      vis = vis * penumbra<kPow8>(s, f->p_off, lo, r.ts[(s.n_dir + pi) * r.vis_stride], q, &pass);
    }
    const float falloff = ndotl * vis / fmaxf(dist2, 1e-8f);
    for (int c = 0; c < 3; ++c) f->rad[c] += P[s.off_lpcol + 3 * pi + c] * falloff;
  }
  return true;
}

// The cost class of ray r's chain in the shade kernels, cheapest first:
// no surface (the sky), a selected mesh hit, a selected SDF hit whose point
// a sphere, plane or box attains, and one the Mandelbulb attains (its
// adjoint's iterations). One scene_argmin on SDF-selected lanes, at the
// point shade_surface takes.
enum RayClass { kClassSky = 0, kClassMesh, kClassSdf, kClassBulb, kNumClasses };

template <bool kPow8>
__device__ __forceinline__ int ray_class(const ShadeParams& s, const RayIn& r) {
  bool sel_sdf, sel_mesh;
  select_hit(s, r, &sel_sdf, &sel_mesh);
  if (!sel_sdf) return sel_mesh ? kClassMesh : kClassSky;
  const float t = sdf_t_eff(s, r);
  float p[3];
  for (int k = 0; k < 3; ++k) p[k] = r.o[k] + t * r.d[k];
  int kind = 0;
  if (scene_argmin<kPow8>(s.sdf, p[0], p[1], p[2], &kind) < 0) return kClassSky;
  return kind == kBulb ? kClassBulb : kClassSdf;
}

// The sky gradient by d.y: bg_bottom + (bg_top - bg_bottom) * s.
__device__ __forceinline__ float sky(const ShadeParams& s, int c, float sb) {
  const float* P = s.sdf.p;
  return P[s.off_bgb + c] + (P[s.off_bgt + c] - P[s.off_bgb + c]) * sb;
}

}  // namespace tr
