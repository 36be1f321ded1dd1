// Fused backward of the shade chain: reconstruct + shade from the geometry
// residuals, pulled back to the scene parameters and to the per-ray o, d
// and selected-triangle corners.
//
// Replaces the Pallas kernel `shade_bwd_pallas` (tpu_ray/kernels/
// pallas_shade.py:591) for the chains it takes here: methods sdf, mesh_*
// and mixed; directional and point lights; static shadow visibility (the
// sh_vis residual: hard, soft or none); the 5-tap distance-field AO with its
// SDF and mesh terms (pallas_shade.py:278-296); the differentiable soft-
// shadow penumbra, recomputed from one DE at the march's argmin t
// (diff_vis, pallas_shade.py:302-355). Not the silhouettes. The plain
// PyTorch version is shade_bwd_torch (tpu_ray_torch/kernels/cuda_shade.py):
// torch.autograd of the port's plain shade.
//
// What bounds it on an H100: compute on the rays whose selected hit is the
// Mandelbulb. Such a ray runs the field's first-order adjoint at the hit
// (IFT numerator and denominator, the normal) and the same adjoint again on
// Dual numbers for the normal's Hessian term (sdf_adj.cuh), each over twelve
// stored iterations; with AO, five tap DEs and their first-order adjoints;
// with the penumbra, one DE and its adjoint per light. Memory traffic is
// ~100 bytes per ray.
//
// The simple design: one thread per ray, and a per-ray branch in place of
// the Pallas kernel's per-tile class dispatch (pallas_shade.py:379-438): a
// miss runs the sky's pullback, a selected mesh hit the Moller-Trumbore
// re-solve of its triangle, a selected SDF hit the IFT attach and the
// normal. The branch is exact: the unselected branches' cotangents are zero
// in the reference too. The parameter cotangents are reduced without
// atomics: each thread writes its ray's into its own column of shared
// memory, each block sums its columns in a fixed order into one partial row,
// and a second kernel sums the rows in a fixed order, so two runs give
// bit-identical parameter gradients.
//
// Everything above the kernels is plain C++, so that the per-ray arithmetic
// also builds as host code (tests/test_torch_shade_bwd.py holds that build
// against the plain version on the CPU).
#include <stdint.h>

#include "sdf_adj.cuh"

namespace tr {

constexpr float kDenomMin = 1e-6f;  // the IFT denominator's clamp
constexpr float kDetEps = 1e-10f;   // the Moller-Trumbore determinant's

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
  double ao_step;       // in double: the tap heights round as the host's do
  float ao_strength, soft_k, bias;
  int off_alb, off_ldir, off_lcol, off_amb, off_bgt, off_bgb, off_lpos, off_lpcol;
  int n_par;
};

__host__ __device__ __forceinline__ ShadeParams make_params(
    const float* small, int n_sph, int n_pln, int n_box, int n_mb,
    int mb_iters, int n_mat, int n_dir, int n_pos, int use_sdf, int use_mesh,
    int ao_sdf, int ao_mesh, int soft_diff, double ao_step, float ao_strength,
    float soft_k, float bias) {
  ShadeParams s;
  s.sdf = SdfParams{small, n_sph, n_pln, n_box, n_mb, mb_iters};
  s.n_mat = n_mat; s.n_dir = n_dir; s.n_pos = n_pos;
  s.use_sdf = use_sdf; s.use_mesh = use_mesh;
  s.ao_sdf = ao_sdf; s.ao_mesh = ao_mesh; s.soft_diff = soft_diff;
  s.ao_step = ao_step; s.ao_strength = ao_strength;
  s.soft_k = soft_k; s.bias = bias;
  s.off_alb = 4 * n_sph + 4 * n_pln + 7 * n_box + 4 * n_mb;
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

// One ray's inputs: the residuals of the geometry pass and its cotangent.
struct RayIn {
  float o[3], d[3], c[9];  // c: the selected triangle's v0, v1, v2
  float t_bar;             // SDF march t
  bool hs, hm, closer;     // SDF hit, mesh hit, SDF selected (mixed)
  int mat;
  const float* vis;        // one value per light at stride vis_stride, or null
  const float* ts;         // the soft march's argmin t, as vis, or null
  int vis_stride;
  float t_mesh;            // ao_tmesh: the closest mesh hit along the normal
  float ct[3];
};

// Ray i of the kernel's inputs (null masks read as false, null corners as 0).
__device__ __forceinline__ RayIn load_ray(
    int i, int n, const float* o, const float* d, const float* corners,
    const float* t_bar, const uint8_t* hs, const uint8_t* hm,
    const uint8_t* closer, const int* mat, const float* vis, const float* ts,
    const float* ao_tmesh, const float* ct) {
  RayIn r;
  for (int k = 0; k < 3; ++k) {
    r.o[k] = o[3 * i + k];
    r.d[k] = d[3 * i + k];
    r.ct[k] = ct[3 * i + k];
  }
  for (int k = 0; k < 9; ++k) r.c[k] = corners ? corners[9 * i + k] : 0.0f;
  r.t_bar = t_bar ? t_bar[i] : 0.0f;
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

// Cotangent of a in n = a / sqrt(max(a.a, 1e-12)) given the cotangent of n.
__device__ __forceinline__ void normalize_adj(const float* a, const float* d_n,
                                              float* d_a) {
  const float a2 = dot3(a, a);
  const float len = sqrtf(fmaxf(a2, 1e-12f));
  const float w = a2 >= 1e-12f ? dot3(d_n, a) / (len * len * len) : 0.0f;
  for (int k = 0; k < 3; ++k) d_a[k] = d_n[k] / len - a[k] * w;
}

constexpr int kAoTaps = 5;

// The cotangent w of DE(q) pulled back to first order: the parameters of the
// primitive that attains the DE at q (first on a tie) gain w * dDE/dtheta in
// acc, and d_q gains w * grad_q DE.
__device__ void de_adj_add(const ShadeParams& s, const float* q, float w,
                           float* acc, int stride, float* d_q) {
  if (w == 0.0f) return;
  int kind = 0;
  const int prim = scene_argmin(s.sdf, q[0], q[1], q[2], &kind);
  if (prim < 0) return;
  float g[3], gth[7];
  prim_adj<float>(s.sdf.p + prim, kind, s.sdf.mb_iters, q[0], q[1], q[2], g, gth);
  for (int k = 0; k < prim_stride(kind); ++k) acc[(prim + k) * stride] += w * gth[k];
  for (int k = 0; k < 3; ++k) d_q[k] += w * g[k];
}

// The soft-shadow penumbra recomputed at the march's argmin t:
// clip(soft_k * DE(q) / max(ts, bias), 0, 1) at q = p_off + ts * l. Writes q
// and whether the clip passes a gradient.
__device__ float penumbra(const ShadeParams& s, const float* p_off,
                          const float* l, float ts, float* q, bool* pass) {
  for (int k = 0; k < 3; ++k) q[k] = p_off[k] + ts * l[k];
  const float dd = scene_de(s.sdf, q[0], q[1], q[2]);
  const float raw = s.soft_k * dd / fmaxf(ts, s.bias);
  *pass = raw >= 0.0f && raw <= 1.0f;
  return fminf(fmaxf(raw, 0.0f), 1.0f);
}

// Adds ray r's parameter cotangents into acc (parameter j at acc[j * stride])
// and writes its cotangents of o, d (3 each) and of the corners (9).
__device__ void shade_bwd_ray(const ShadeParams& s, const RayIn& r, float* acc,
                              int stride, float* d_o, float* d_d, float* d_c) {
  for (int k = 0; k < 3; ++k) d_o[k] = d_d[k] = 0.0f;
  for (int k = 0; k < 9; ++k) d_c[k] = 0.0f;
  const float* P = s.sdf.p;
  bool sel_sdf, sel_mesh;
  if (s.use_sdf && s.use_mesh) {
    sel_sdf = r.closer && r.hs;
    sel_mesh = !r.closer && r.hm;
  } else {
    sel_sdf = s.use_sdf && r.hs;
    sel_mesh = s.use_mesh && r.hm;
  }

  if (!sel_sdf && !sel_mesh) {  // miss: the sky gradient by d.y
    const float sb = 0.5f * (r.d[1] + 1.0f);
    float d_s = 0.0f;
    for (int c = 0; c < 3; ++c) {
      acc[(s.off_bgb + c) * stride] += r.ct[c] - r.ct[c] * sb;
      acc[(s.off_bgt + c) * stride] += r.ct[c] * sb;
      d_s += r.ct[c] * (P[s.off_bgt + c] - P[s.off_bgb + c]);
    }
    d_d[1] = 0.5f * d_s;
    return;
  }

  // --- forward: the selected hit point p and normal n --------------------
  float p[3], n[3];
  float g[3], gth[7], glen = 1.0f;  // SDF: grad_p DE and grad_theta DE at p
  int prim = -1, kind = 0;
  float e1[3], e2[3], pv[3], qv[3], tv[3], cn[3];  // mesh: the MT re-solve
  float det = 0.0f, inv_det = 0.0f, tm = 0.0f, cl = 1.0f;
  bool det_ok = false;
  if (sel_sdf) {
    for (int k = 0; k < 3; ++k) p[k] = r.o[k] + r.t_bar * r.d[k];
    prim = scene_argmin(s.sdf, p[0], p[1], p[2], &kind);
    if (prim < 0) return;  // no primitive: the wrapper never sends such a scene
    prim_adj<float>(P + prim, kind, s.sdf.mb_iters, p[0], p[1], p[2], g, gth);
    glen = sqrtf(fmaxf(dot3(g, g), 1e-12f));
    for (int k = 0; k < 3; ++k) n[k] = g[k] / glen;
  } else {
    const float* v0 = r.c;
    for (int k = 0; k < 3; ++k) {
      e1[k] = r.c[3 + k] - v0[k];
      e2[k] = r.c[6 + k] - v0[k];
      tv[k] = r.o[k] - v0[k];
    }
    cross3(r.d, e2, pv);
    det = dot3(e1, pv);
    det_ok = fabsf(det) > kDetEps;
    const float det_safe = det_ok ? det : (det >= 0.0f ? kDetEps : -kDetEps);
    inv_det = 1.0f / det_safe;
    cross3(tv, e1, qv);
    tm = dot3(e2, qv) * inv_det;
    for (int k = 0; k < 3; ++k) p[k] = r.o[k] + tm * r.d[k];
    cross3(e1, e2, cn);
    cl = sqrtf(fmaxf(dot3(cn, cn), 1e-12f));
    for (int k = 0; k < 3; ++k) n[k] = cn[k] / cl;
  }
  // two-sided: face the normal against the ray
  const float flip = dot3(n, r.d) > 0.0f ? -1.0f : 1.0f;
  float nf[3];
  for (int k = 0; k < 3; ++k) nf[k] = flip * n[k];
  const int mat = r.mat < 0 ? 0 : (r.mat >= s.n_mat ? s.n_mat - 1 : r.mat);
  const float* alb = P + s.off_alb + 3 * mat;

  // 5-tap AO: occ = sum_i 0.7^(i-1) (h_i - min(DE(p + h_i nf), |t_mesh - h_i|))
  // over h_i = ao_step * i, ao = clip(1 - ao_strength * occ, 0, 1)
  const bool use_ao = s.ao_sdf || s.ao_mesh;
  bool tap_sdf[kAoTaps];  // the tap's occluder distance is its DE
  float ao = 1.0f;
  bool ao_pass = false;
  if (use_ao) {
    float occ = 0.0f;
    double w = 1.0;
    for (int i = 0; i < kAoTaps; ++i) {
      const float h = static_cast<float>(s.ao_step * (i + 1));
      float dd = 0.0f;
      tap_sdf[i] = s.ao_sdf != 0;
      if (s.ao_sdf) dd = scene_de(s.sdf, p[0] + h * nf[0], p[1] + h * nf[1], p[2] + h * nf[2]);
      if (s.ao_mesh) {
        const float dm = fabsf(r.t_mesh - h);
        if (!s.ao_sdf || dm < dd) {
          dd = dm;
          tap_sdf[i] = false;
        }
      }
      occ = occ + static_cast<float>(w) * (h - dd);
      w *= 0.7;
    }
    const float ao_raw = 1.0f - s.ao_strength * occ;
    ao = fminf(fmaxf(ao_raw, 0.0f), 1.0f);
    ao_pass = ao_raw >= 0.0f && ao_raw <= 1.0f;
  }
  // the shadow rays' origin (the penumbra recompute marches from it)
  float p_off[3];
  for (int k = 0; k < 3; ++k) p_off[k] = p[k] + s.bias * nf[k];

  // radiance = ambient * ao + sum of the lights' terms
  float rad[3];
  for (int c = 0; c < 3; ++c) rad[c] = P[s.off_amb + c] * ao;
  for (int li = 0; li < s.n_dir; ++li) {
    const float* lraw = P + s.off_ldir + 3 * li;
    const float ll = sqrtf(fmaxf(dot3(lraw, lraw), 1e-12f));
    const float l[3] = {lraw[0] / ll, lraw[1] / ll, lraw[2] / ll};
    const float ndotl = fmaxf(dot3(nf, l), 0.0f);
    float vis = r.vis ? r.vis[li * r.vis_stride] : 1.0f;
    if (s.soft_diff) {
      float q[3];
      bool pass;
      vis = vis * penumbra(s, p_off, l, r.ts[li * r.vis_stride], q, &pass);
    }
    for (int c = 0; c < 3; ++c) rad[c] += P[s.off_lcol + 3 * li + c] * (ndotl * vis);
  }
  for (int pi = 0; pi < s.n_pos; ++pi) {
    const float* lp = P + s.off_lpos + 3 * pi;
    const float lv[3] = {lp[0] - p[0], lp[1] - p[1], lp[2] - p[2]};
    const float dist2 = dot3(lv, lv);
    const float dist = sqrtf(fmaxf(dist2, 1e-12f));
    const float l[3] = {lv[0] / dist, lv[1] / dist, lv[2] / dist};
    const float ndotl = fmaxf(dot3(nf, l), 0.0f);
    float vis = r.vis ? r.vis[(s.n_dir + pi) * r.vis_stride] : 1.0f;
    if (s.soft_diff) {
      const float lvo[3] = {lp[0] - p_off[0], lp[1] - p_off[1], lp[2] - p_off[2]};
      const float dist_o = sqrtf(fmaxf(dot3(lvo, lvo), 1e-12f));
      const float lo[3] = {lvo[0] / dist_o, lvo[1] / dist_o, lvo[2] / dist_o};
      float q[3];
      bool pass;
      vis = vis * penumbra(s, p_off, lo, r.ts[(s.n_dir + pi) * r.vis_stride], q, &pass);
    }
    const float falloff = ndotl * vis / fmaxf(dist2, 1e-8f);
    for (int c = 0; c < 3; ++c) rad[c] += P[s.off_lpcol + 3 * pi + c] * falloff;
  }

  // --- reverse: colour = albedo[mat] * radiance ---------------------------
  float d_rad[3], d_ao = 0.0f;
  for (int c = 0; c < 3; ++c) {
    acc[(s.off_alb + 3 * mat + c) * stride] += r.ct[c] * rad[c];
    d_rad[c] = r.ct[c] * alb[c];
    acc[(s.off_amb + c) * stride] += d_rad[c] * ao;
    d_ao += d_rad[c] * P[s.off_amb + c];
  }
  // d_n, d_p: cotangents of the flipped normal nf and of p; d_poff: of p_off
  float d_n[3] = {0.0f, 0.0f, 0.0f}, d_p[3] = {0.0f, 0.0f, 0.0f};
  float d_poff[3] = {0.0f, 0.0f, 0.0f};
  for (int li = 0; li < s.n_dir; ++li) {
    const float* lraw = P + s.off_ldir + 3 * li;
    const float ll = sqrtf(fmaxf(dot3(lraw, lraw), 1e-12f));
    const float l[3] = {lraw[0] / ll, lraw[1] / ll, lraw[2] / ll};
    const float raw = dot3(nf, l);
    const float ndotl = fmaxf(raw, 0.0f);
    const float vs = r.vis ? r.vis[li * r.vis_stride] : 1.0f;
    float vis = vs, ts = 0.0f, q[3];
    bool pen_pass = false;
    if (s.soft_diff) {
      ts = r.ts[li * r.vis_stride];
      vis = vs * penumbra(s, p_off, l, ts, q, &pen_pass);
    }
    float d_term = 0.0f;
    for (int c = 0; c < 3; ++c) {
      acc[(s.off_lcol + 3 * li + c) * stride] += d_rad[c] * (ndotl * vis);
      d_term += d_rad[c] * P[s.off_lcol + 3 * li + c];
    }
    float d_l[3] = {0.0f, 0.0f, 0.0f};
    if (raw >= 0.0f) {
      const float d_raw = d_term * vis;
      for (int k = 0; k < 3; ++k) {
        d_n[k] += d_raw * l[k];
        d_l[k] = d_raw * nf[k];
      }
    }
    if (pen_pass) {  // vis = vs * clip(soft_k * DE(p_off + ts l) / max(ts, bias))
      const float d_pen = d_term * ndotl * vs;
      float d_q[3] = {0.0f, 0.0f, 0.0f};
      de_adj_add(s, q, s.soft_k * (d_pen / fmaxf(ts, s.bias)), acc, stride, d_q);
      for (int k = 0; k < 3; ++k) {
        d_poff[k] += d_q[k];
        d_l[k] += ts * d_q[k];
      }
    }
    if (raw >= 0.0f || pen_pass) {
      float d_lraw[3];
      normalize_adj(lraw, d_l, d_lraw);
      for (int k = 0; k < 3; ++k) acc[(s.off_ldir + 3 * li + k) * stride] += d_lraw[k];
    }
  }
  for (int pi = 0; pi < s.n_pos; ++pi) {
    const float* lp = P + s.off_lpos + 3 * pi;
    const float lv[3] = {lp[0] - p[0], lp[1] - p[1], lp[2] - p[2]};
    const float dist2 = dot3(lv, lv);
    const float dist = sqrtf(fmaxf(dist2, 1e-12f));
    const float l[3] = {lv[0] / dist, lv[1] / dist, lv[2] / dist};
    const float raw = dot3(nf, l);
    const float ndotl = fmaxf(raw, 0.0f);
    const float vs = r.vis ? r.vis[(s.n_dir + pi) * r.vis_stride] : 1.0f;
    float vis = vs, ts = 0.0f, q[3], lvo[3], lo[3];
    bool pen_pass = false;
    if (s.soft_diff) {
      for (int k = 0; k < 3; ++k) lvo[k] = lp[k] - p_off[k];
      const float dist_o = sqrtf(fmaxf(dot3(lvo, lvo), 1e-12f));
      for (int k = 0; k < 3; ++k) lo[k] = lvo[k] / dist_o;
      ts = r.ts[(s.n_dir + pi) * r.vis_stride];
      vis = vs * penumbra(s, p_off, lo, ts, q, &pen_pass);
    }
    const float den = fmaxf(dist2, 1e-8f);
    const float falloff = ndotl * vis / den;
    float d_f = 0.0f;
    for (int c = 0; c < 3; ++c) {
      acc[(s.off_lpcol + 3 * pi + c) * stride] += d_rad[c] * falloff;
      d_f += d_rad[c] * P[s.off_lpcol + 3 * pi + c];
    }
    float d_dist2 = dist2 >= 1e-8f ? -(d_f * (ndotl * vis)) / (den * den) : 0.0f;
    float d_l[3] = {0.0f, 0.0f, 0.0f};
    if (raw >= 0.0f) {
      const float d_raw = d_f * vis / den;
      for (int k = 0; k < 3; ++k) {
        d_n[k] += d_raw * l[k];
        d_l[k] = d_raw * nf[k];
      }
    }
    const float d_dist = -dot3(d_l, lv) / (dist * dist);
    if (dist2 >= 1e-12f) d_dist2 += d_dist * 0.5f / dist;
    for (int k = 0; k < 3; ++k) {
      const float d_lv = d_l[k] / dist + 2.0f * lv[k] * d_dist2;
      acc[(s.off_lpos + 3 * pi + k) * stride] += d_lv;
      d_p[k] -= d_lv;
    }
    if (pen_pass) {  // the penumbra along lo = normalize(lpos - p_off)
      const float d_pen = d_f / den * ndotl * vs;
      float d_q[3] = {0.0f, 0.0f, 0.0f}, d_lo[3], d_lvo[3];
      de_adj_add(s, q, s.soft_k * (d_pen / fmaxf(ts, s.bias)), acc, stride, d_q);
      for (int k = 0; k < 3; ++k) {
        d_poff[k] += d_q[k];
        d_lo[k] = ts * d_q[k];
      }
      normalize_adj(lvo, d_lo, d_lvo);
      for (int k = 0; k < 3; ++k) {
        acc[(s.off_lpos + 3 * pi + k) * stride] += d_lvo[k];
        d_poff[k] -= d_lvo[k];
      }
    }
  }
  for (int k = 0; k < 3; ++k) {  // p_off = p + bias * nf
    d_p[k] += d_poff[k];
    d_n[k] += s.bias * d_poff[k];
  }
  if (ao_pass) {  // each tap's DE pulled back into p, nf and its primitive
    const float d_occ = -(s.ao_strength * d_ao);
    double w = 1.0;
    for (int i = 0; i < kAoTaps; ++i) {
      if (tap_sdf[i]) {
        const float h = static_cast<float>(s.ao_step * (i + 1));
        const float q[3] = {p[0] + h * nf[0], p[1] + h * nf[1], p[2] + h * nf[2]};
        float d_q[3] = {0.0f, 0.0f, 0.0f};
        de_adj_add(s, q, -(static_cast<float>(w) * d_occ), acc, stride, d_q);
        for (int k = 0; k < 3; ++k) {
          d_p[k] += d_q[k];
          d_n[k] += h * d_q[k];
        }
      }
      w *= 0.7;
    }
  }
  for (int k = 0; k < 3; ++k) d_n[k] *= flip;  // cotangent of the unflipped n

  if (sel_sdf) {
    // n = g / |g| at p = o + t d: its pullback u on g, then (H u, d2DE/dth dp
    // u) from the adjoint run on Dual numbers at p + eps u
    const float nd = dot3(n, d_n);
    const bool n_ok = dot3(g, g) >= 1e-12f;
    float u[3];
    for (int k = 0; k < 3; ++k) u[k] = (d_n[k] - (n_ok ? n[k] * nd : 0.0f)) / glen;
    Dual hp[3], hth[7];
    prim_adj<Dual>(P + prim, kind, s.sdf.mb_iters, Dual(p[0], u[0]),
                   Dual(p[1], u[1]), Dual(p[2], u[2]), hp, hth);
    const int np = prim_stride(kind);
    float d_ps[3];
    for (int k = 0; k < 3; ++k) d_ps[k] = d_p[k] + tan_(hp[k]);
    // p = o + t d, t the IFT-attached march t
    const float d_t = dot3(d_ps, r.d);
    for (int k = 0; k < 3; ++k) {
      d_o[k] += d_ps[k];
      d_d[k] += r.t_bar * d_ps[k];
    }
    // IFT: dt/d(theta, o, d) = -dDE/d(theta, o, d) / <grad_p DE, d>
    const float denom = dot3(g, r.d);
    const float denom_safe = fabsf(denom) < kDenomMin
                                 ? (denom < 0.0f ? -kDenomMin : kDenomMin)
                                 : denom;
    const float scale = -d_t / denom_safe;
    for (int k = 0; k < np; ++k) acc[(prim + k) * stride] += tan_(hth[k]) + scale * gth[k];
    for (int k = 0; k < 3; ++k) {
      d_o[k] += scale * g[k];
      d_d[k] += scale * r.t_bar * g[k];
    }
  } else {
    // p = o + tm d, tm = <e2, q> / det, n = normalize(e1 x e2)
    for (int k = 0; k < 3; ++k) {
      d_o[k] += d_p[k];
      d_d[k] += tm * d_p[k];
    }
    const float d_tm = dot3(d_p, r.d);
    const float d_inv = d_tm * dot3(e2, qv);
    const float d_det = det_ok ? -d_inv * inv_det * inv_det : 0.0f;
    float d_e1[3], d_e2[3], d_qv[3], d_pv[3], d_tv[3], d_cn[3], tmp[3];
    for (int k = 0; k < 3; ++k) {
      d_e2[k] = d_tm * inv_det * qv[k];
      d_qv[k] = d_tm * inv_det * e2[k];
      d_e1[k] = d_det * pv[k];
      d_pv[k] = d_det * e1[k];
    }
    cross3(e2, d_pv, tmp);  // pv = d x e2
    for (int k = 0; k < 3; ++k) d_d[k] += tmp[k];
    cross3(d_pv, r.d, tmp);
    for (int k = 0; k < 3; ++k) d_e2[k] += tmp[k];
    cross3(e1, d_qv, d_tv);  // qv = tv x e1
    cross3(d_qv, tv, tmp);
    for (int k = 0; k < 3; ++k) d_e1[k] += tmp[k];
    normalize_adj(cn, d_n, d_cn);  // cn = e1 x e2
    cross3(e2, d_cn, tmp);
    for (int k = 0; k < 3; ++k) d_e1[k] += tmp[k];
    cross3(d_cn, e1, tmp);
    for (int k = 0; k < 3; ++k) d_e2[k] += tmp[k];
    for (int k = 0; k < 3; ++k) {
      d_o[k] += d_tv[k];
      d_c[k] = -d_tv[k] - d_e1[k] - d_e2[k];
      d_c[3 + k] = d_e1[k];
      d_c[6 + k] = d_e2[k];
    }
  }
}

}  // namespace tr

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;
constexpr int kStride = kThreads + 1;  // shared columns, padded: no bank conflicts
constexpr int kMaxSmem = 227 * 1024;

__global__ void shade_bwd_kernel(
    tr::ShadeParams s, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ corners, const float* __restrict__ t_bar,
    const uint8_t* __restrict__ hs, const uint8_t* __restrict__ hm,
    const uint8_t* __restrict__ closer, const int* __restrict__ mat,
    const float* __restrict__ vis, const float* __restrict__ ts,
    const float* __restrict__ ao_tmesh, const float* __restrict__ ct, int n,
    float* __restrict__ d_o, float* __restrict__ d_d,
    float* __restrict__ d_corners, float* __restrict__ partials) {
  extern __shared__ float acc[];  // [n_par][kStride]: column tid is ray tid's
  const int tid = threadIdx.x;
  for (int j = 0; j < s.n_par; ++j) acc[j * kStride + tid] = 0.0f;
  const int i = blockIdx.x * kThreads + tid;
  if (i < n) {
    const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, hs, hm,
                                     closer, mat, vis, ts, ao_tmesh, ct);
    float go[3], gd[3], gc[9];
    tr::shade_bwd_ray(s, r, acc + tid, kStride, go, gd, gc);
    for (int k = 0; k < 3; ++k) {
      d_o[3 * i + k] = go[k];
      d_d[3 * i + k] = gd[k];
    }
    if (d_corners)
      for (int k = 0; k < 9; ++k) d_corners[9 * i + k] = gc[k];
  }
  __syncthreads();
  // the block's partial row: each parameter's column sum, in ray order
  for (int j = tid; j < s.n_par; j += kThreads) {
    float sum = 0.0f;
    for (int k = 0; k < kThreads; ++k) sum += acc[j * kStride + k];
    partials[blockIdx.x * s.n_par + j] = sum;
  }
}

// d_small[j] = sum of the partial rows' column j, in block order.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int n_rows, int n_par,
                                    float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_par) return;
  float sum = 0.0f;
  for (int b = 0; b < n_rows; ++b) sum += partials[b * n_par + j];
  out[j] = sum;
}

}  // namespace

extern "C" int tr_shade_bwd_threads() { return kThreads; }

extern "C" int tr_shade_bwd(
    const float* o, const float* d, const float* corners, const float* t_bar,
    const uint8_t* hs, const uint8_t* hm, const uint8_t* closer,
    const int* mat, const float* vis, const float* ts, const float* ao_tmesh,
    const float* ct, int n, const float* small, int n_sph, int n_pln,
    int n_box, int n_mb, int mb_iters, int n_mat, int n_dir, int n_pos,
    int use_sdf, int use_mesh, int ao_sdf, int ao_mesh, int soft_diff,
    double ao_step, float ao_strength, float soft_k, float bias, float* d_o,
    float* d_d, float* d_corners, float* partials, int n_partial_rows,
    float* d_small, void* stream) {
  const tr::ShadeParams s = tr::make_params(
      small, n_sph, n_pln, n_box, n_mb, mb_iters, n_mat, n_dir, n_pos, use_sdf,
      use_mesh, ao_sdf, ao_mesh, soft_diff, ao_step, ao_strength, soft_k, bias);
  const int n_blocks = n > 0 ? (n + kThreads - 1) / kThreads : 0;
  const size_t smem = static_cast<size_t>(s.n_par) * kStride * sizeof(float);
  if (mb_iters > tr::kMaxMbIters || n_mat < 1 || smem > kMaxSmem ||
      n_partial_rows != n_blocks || (soft_diff && !ts) || (ao_mesh && !ao_tmesh))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          shade_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    shade_bwd_kernel<<<n_blocks, kThreads, smem, st>>>(
        s, o, d, corners, t_bar, hs, hm, closer, mat, vis, ts, ao_tmesh, ct, n,
        d_o, d_d, d_corners, partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sum_partials_kernel<<<(s.n_par + 127) / 128, 128, 0, st>>>(
      partials, n_blocks, s.n_par, d_small);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
