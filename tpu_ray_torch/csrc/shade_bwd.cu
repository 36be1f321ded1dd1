// Fused backward of the shade chain: reconstruct + shade from the geometry
// residuals, pulled back to the scene parameters and to the per-ray o, d
// and selected-triangle corners.
//
// Replaces the Pallas kernel `shade_bwd_pallas` (tpu_ray/kernels/
// pallas_shade.py:591) and every chain it takes: methods sdf, mesh_* and
// mixed; directional and point lights; static shadow visibility (the
// sh_vis residual: hard, soft or none); the 5-tap distance-field AO with its
// SDF and mesh terms (pallas_shade.py:278-296); the differentiable soft-
// shadow penumbra, recomputed from one DE at the march's argmin t
// (diff_vis, pallas_shade.py:302-355); the soft SDF silhouette (sigmoid
// coverage from the DE at the march's closest approach tmin) and the mesh
// edge band (pallas_shade.py:158-172, 202-223, 226-240, 370-375). The
// forward it pulls back is shade_chain.cuh's, the same as the forward
// kernel's (shade_fwd.cu). The plain PyTorch version is shade_bwd_torch
// (tpu_ray_torch/kernels/cuda_shade.py): torch.autograd of the port's plain
// shade.
//
// What bounds it on an H100: compute on the rays whose selected hit is the
// Mandelbulb. Such a ray runs the field's first-order adjoint at the hit
// (IFT numerator and denominator, the normal) and the same adjoint again on
// Dual numbers for the normal's Hessian term (sdf_adj.cuh), each over twelve
// stored iterations; with AO, five tap DEs and their first-order adjoints;
// with the penumbra, one DE and its adjoint per light. With soft
// silhouettes every lane that misses runs that chain at its closest
// approach. Memory traffic is ~100 bytes per ray. The kernel is built for the
// power-8 field and for the generic one (sdf.cuh; the generic adjoint also
// gives d/d mb_power, the bulb row's fifth cotangent); the entry point
// launches the one mb_pow8 names.
//
// The design: one thread per ray, and a per-ray branch in place of the
// Pallas kernel's per-tile class dispatch (pallas_shade.py:379-438): a lane
// that selects no surface runs the sky's pullback, a selected mesh hit the
// Moller-Trumbore re-solve of its triangle, a selected SDF hit the IFT
// attach and the normal. The branch is exact: the unselected branches'
// cotangents are zero in the reference too. Ties of the coverage's max and
// min split the cotangent in halves and clips pass it at their bounds, as
// torch's autograd does. With the generic field a block first sorts its
// rays by the class of their chain, so that a warp runs one chain. The
// Mandelbulb adjoint keeps its stored iterations in the thread's column of
// shared memory (sdf_adj.cuh's MbStore), not in local memory. The
// parameter cotangents are reduced without atomics: each thread writes its
// ray's into the ray's own column of shared memory, each block sums its
// columns (a warp a column, in a fixed order) into one partial row, and a
// second kernel sums the rows (a warp a parameter, the same order), so two
// runs give bit-identical parameter gradients.
//
// Everything above the kernels is plain C++, so that the per-ray arithmetic
// also builds as host code (tests/test_torch_shade_bwd.py holds that build
// against the plain version on the CPU).
#include <stdint.h>

#include "shade_chain.cuh"

namespace tr {

// Cotangent of a in n = a / sqrt(max(a.a, 1e-12)) given the cotangent of n.
__device__ __forceinline__ void normalize_adj(const float* a, const float* d_n,
                                              float* d_a) {
  const float a2 = dot3(a, a);
  const float len = sqrtf(fmaxf(a2, 1e-12f));
  const float w = a2 >= 1e-12f ? dot3(d_n, a) / (len * len * len) : 0.0f;
  for (int k = 0; k < 3; ++k) d_a[k] = d_n[k] / len - a[k] * w;
}

// Cotangent of x in l = sqrt(max(x.x, 1e-24)) given the cotangent of l,
// added to d_x with the sign given.
__device__ __forceinline__ void length_adj(const float* x, float l, float d_l,
                                           float sign, float* d_x) {
  if (dot3(x, x) < 1e-24f) return;
  for (int k = 0; k < 3; ++k) d_x[k] += sign * (x[k] * (d_l / l));
}

// The cotangents of a = min(x, y) on x and y: the smaller takes it, a tie
// splits it in halves (torch.minimum).
__device__ __forceinline__ void min_adj(float x, float y, float d_a, float* d_x,
                                        float* d_y) {
  *d_x = x < y ? d_a : (x == y ? d_a / 2.0f : 0.0f);
  *d_y = y < x ? d_a : (x == y ? d_a / 2.0f : 0.0f);
}

// The cotangent w of DE(q) pulled back to first order: the parameters of the
// primitive that attains the DE at q (first on a tie) gain w * dDE/dtheta in
// acc, and d_q gains w * grad_q DE. The argmin's bulb forward is the
// adjoint's (shade_chain.cuh).
template <bool kPow8>
__device__ void de_adj_add(const ShadeParams& s, const float* q, float w,
                           float* acc, int stride, float* d_q, const MbStore& st) {
  if (w == 0.0f) return;
  int kind = 0;
  float g[3], gth[7];
  MbFwd<float> mb;
  const int prim = scene_argmin<kPow8>(s.sdf, q[0], q[1], q[2], &kind, nullptr,
                                       kSerialChain ? nullptr : &mb, &st);
  if (prim < 0) return;
  prim_adj<float, kPow8>(s.sdf.p + prim, kind, s.sdf.mb_iters, q[0], q[1], q[2], g, gth, st,
                         kSerialChain ? nullptr : &mb);
  const int np = prim_stride(kind);
#pragma unroll
  for (int k = 0; k < 7; ++k)  // a constant index: gth stays in registers
    if (k < np) acc[(prim + k) * stride] += w * gth[k];
  for (int k = 0; k < 3; ++k) d_q[k] += w * g[k];
}

// The mesh chain's pullback into o, d and the corners: p = o + tm d and
// n = normalize(e1 x e2) with cotangents d_p and d_n (where the mesh hit is
// selected), and the edge band's margin with cotangent d_margin.
__device__ __forceinline__ void mesh_bwd(const RayIn& r, const float* d_p, const float* d_n,
                                         float d_margin, float* d_o, float* d_d, float* d_c) {
  MtSolve m;
  mt_solve(r, &m);
  for (int k = 0; k < 3; ++k) {
    d_o[k] += d_p[k];
    d_d[k] += m.tm * d_p[k];
  }
  const float d_tm = dot3(d_p, r.d);
  float d_inv = d_tm * dot3(m.e2, m.qv);
  float d_e1[3], d_e2[3], d_qv[3], d_pv[3], d_tv[3], d_cn[3], d_ex[3], tmp[3];
  for (int k = 0; k < 3; ++k) {
    d_e2[k] = d_tm * m.inv_det * m.qv[k];
    d_qv[k] = d_tm * m.inv_det * m.e2[k];
    d_e1[k] = d_pv[k] = d_tv[k] = d_ex[k] = 0.0f;
  }
  normalize_adj(m.cn, d_n, d_cn);  // cn = e1 x e2
  if (d_margin != 0.0f) {
    // margin = min(b0 2A / l0, min(u 2A / l1, v 2A / l2)), b0 = 1 - u - v
    EdgeBand b;
    edge_band(r, m, &b);
    float d_dist[3], d_inner;
    min_adj(b.dist[0], fminf(b.dist[1], b.dist[2]), d_margin, &d_dist[0], &d_inner);
    min_adj(b.dist[1], b.dist[2], d_inner, &d_dist[1], &d_dist[2]);
    const float bary[3] = {1.0f - b.u - b.v, b.u, b.v};
    float d_bary[3], d_area = 0.0f, d_len[3];
    for (int e = 0; e < 3; ++e) {
      const float d_num = d_dist[e] / b.l[e];  // dist = (bary * 2A) / l
      d_len[e] = -(d_dist[e] * (bary[e] * b.two_area) / (b.l[e] * b.l[e]));
      d_bary[e] = d_num * b.two_area;
      d_area += d_num * bary[e];
    }
    const float d_u = d_bary[1] - d_bary[0];
    const float d_v = d_bary[2] - d_bary[0];
    float ex[3];
    for (int k = 0; k < 3; ++k) ex[k] = r.c[6 + k] - r.c[3 + k];
    length_adj(ex, b.l[0], d_len[0], 1.0f, d_ex);
    length_adj(m.e2, b.l[1], d_len[1], 1.0f, d_e2);
    length_adj(m.e1, b.l[2], d_len[2], 1.0f, d_e1);
    length_adj(m.cn, b.two_area, d_area, 1.0f, d_cn);
    // u = <tv, pv> / det, v = <d, qv> / det
    d_inv += d_u * dot3(m.tv, m.pv) + d_v * dot3(r.d, m.qv);
    for (int k = 0; k < 3; ++k) {
      d_tv[k] += d_u * m.inv_det * m.pv[k];
      d_pv[k] += d_u * m.inv_det * m.tv[k];
      d_d[k] += d_v * m.inv_det * m.qv[k];
      d_qv[k] += d_v * m.inv_det * r.d[k];
    }
  }
  const float d_det = m.det_ok ? -d_inv * m.inv_det * m.inv_det : 0.0f;
  for (int k = 0; k < 3; ++k) {
    d_e1[k] += d_det * m.pv[k];
    d_pv[k] += d_det * m.e1[k];
  }
  cross3(m.e2, d_pv, tmp);  // pv = d x e2
  for (int k = 0; k < 3; ++k) d_d[k] += tmp[k];
  cross3(d_pv, r.d, tmp);
  for (int k = 0; k < 3; ++k) d_e2[k] += tmp[k];
  cross3(m.e1, d_qv, tmp);  // qv = tv x e1
  for (int k = 0; k < 3; ++k) d_tv[k] += tmp[k];
  cross3(d_qv, m.tv, tmp);
  for (int k = 0; k < 3; ++k) d_e1[k] += tmp[k];
  cross3(m.e2, d_cn, tmp);
  for (int k = 0; k < 3; ++k) d_e1[k] += tmp[k];
  cross3(d_cn, m.e1, tmp);
  for (int k = 0; k < 3; ++k) d_e2[k] += tmp[k];
  for (int k = 0; k < 3; ++k) {  // e1 = v1 - v0, e2 = v2 - v0, tv = o - v0, ex = v2 - v1
    d_o[k] += d_tv[k];
    d_c[k] = -d_tv[k] - d_e1[k] - d_e2[k];
    d_c[3 + k] = d_e1[k] - d_ex[k];
    d_c[6 + k] = d_e2[k] + d_ex[k];
  }
}

// Adds ray r's parameter cotangents into acc (parameter j at acc[j * stride])
// and writes its cotangents of o, d (3 each) and of the corners (9).
template <bool kPow8>
__device__ __forceinline__ void shade_bwd_ray(const ShadeParams& s, const RayIn& r,
                                              float* acc, int stride, float* d_o, float* d_d,
                                              float* d_c, const MbStore& st) {
  for (int k = 0; k < 3; ++k) d_o[k] = d_d[k] = 0.0f;
  for (int k = 0; k < 9; ++k) d_c[k] = 0.0f;
  const float* P = s.sdf.p;
  const float sb = 0.5f * (r.d[1] + 1.0f);
  SurfFwd f;
  const bool surf = shade_surface<kPow8, !kPow8>(s, r, &f, st);

  // --- reverse: out = bg + cov * (colour - bg), colour = albedo[mat] * rad
  float d_bg[3], d_color[3], d_cov = 0.0f;
  for (int c = 0; c < 3; ++c) {
    if (!surf) {  // the sky alone
      d_bg[c] = r.ct[c];
      continue;
    }
    const float bg = sky(s, c, sb);
    d_color[c] = r.ct[c] * f.cov;
    d_cov += r.ct[c] * (P[s.off_alb + 3 * f.mat + c] * f.rad[c] - bg);
    d_bg[c] = r.ct[c] - r.ct[c] * f.cov;
  }
  float d_s = 0.0f;  // the sky gradient by d.y
  for (int c = 0; c < 3; ++c) {
    acc[(s.off_bgb + c) * stride] += d_bg[c] - d_bg[c] * sb;
    acc[(s.off_bgt + c) * stride] += d_bg[c] * sb;
    d_s += d_bg[c] * (P[s.off_bgt + c] - P[s.off_bgb + c]);
  }
  d_d[1] = 0.5f * d_s;
  if (!surf) return;

  const float* alb = P + s.off_alb + 3 * f.mat;
  float d_rad[3], d_ao = 0.0f;
  for (int c = 0; c < 3; ++c) {
    acc[(s.off_alb + 3 * f.mat + c) * stride] += d_color[c] * f.rad[c];
    d_rad[c] = d_color[c] * alb[c];
    acc[(s.off_amb + c) * stride] += d_rad[c] * f.ao;
    d_ao += d_rad[c] * P[s.off_amb + c];
  }
  const float* nf = f.nf;
  const float* p = f.p;
  const float* p_off = f.p_off;
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
      vis = vs * penumbra<kPow8>(s, p_off, l, ts, q, &pen_pass);
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
      de_adj_add<kPow8>(s, q, s.soft_k * (d_pen / fmaxf(ts, s.bias)), acc, stride, d_q, st);
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
      vis = vs * penumbra<kPow8>(s, p_off, lo, ts, q, &pen_pass);
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
      de_adj_add<kPow8>(s, q, s.soft_k * (d_pen / fmaxf(ts, s.bias)), acc, stride, d_q, st);
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
  if (f.ao_pass) {  // each tap's DE pulled back into p, nf and its primitive
    const float d_occ = -(s.ao_strength * d_ao);
    double w = 1.0;
    for (int i = 0; i < kAoTaps; ++i) {
      if ((f.tap_sdf >> i) & 1u) {
        const float h = static_cast<float>(s.ao_step * (i + 1));
        const float q[3] = {p[0] + h * nf[0], p[1] + h * nf[1], p[2] + h * nf[2]};
        float d_q[3] = {0.0f, 0.0f, 0.0f};
        de_adj_add<kPow8>(s, q, -(static_cast<float>(w) * d_occ), acc, stride, d_q, st);
        for (int k = 0; k < 3; ++k) {
          d_p[k] += d_q[k];
          d_n[k] += h * d_q[k];
        }
      }
      w *= 0.7;
    }
  }
  for (int k = 0; k < 3; ++k) d_n[k] *= f.flip;  // cotangent of the unflipped n

  // the coverage: cov_s on an SDF chain, cm on a mesh chain, and in mixed
  // (hm && !closer) ? cm : max(cov_s, cm)
  float d_cov_s = 0.0f, d_cm = 0.0f;
  if (s.use_sdf && s.use_mesh) {
    if (f.sel_sdf)
      min_adj(-f.cov_s, -f.cm, d_cov, &d_cov_s, &d_cm);  // max(a, b) = -min(-a, -b)
    else
      d_cm = d_cov;
  } else if (s.use_sdf) {
    d_cov_s = d_cov;
  } else {
    d_cm = d_cov;
  }
  // cov_s = sigmoid(-DE(o + tmin d) / soft_sil) on a miss, whose point is p
  float d_dmin = 0.0f;
  if (f.sel_sdf && !r.hs && s.soft_sil > 0.0f)
    d_dmin = -(d_cov_s * (1.0f - f.cov_s) * f.cov_s / s.soft_sil);
  // cm = clip(margin / mesh_sil, 0, 1) on a mesh hit; the clip passes at its bounds
  const float d_margin = s.mesh_sil > 0.0f && r.hm && f.ratio >= 0.0f && f.ratio <= 1.0f
                             ? d_cm / s.mesh_sil : 0.0f;

  if (f.sel_sdf) {
    // n = g / |g| at p = o + t d: its pullback u on g, then (H u, d2DE/dth dp
    // u) from the adjoint run on Dual numbers at p + eps u
    const float nd = dot3(f.n, d_n);
    const bool n_ok = dot3(f.g, f.g) >= 1e-12f;
    float u[3];
    for (int k = 0; k < 3; ++k) u[k] = (d_n[k] - (n_ok ? f.n[k] * nd : 0.0f)) / f.glen;
    Dual hp[3], hth[7];
    prim_adj<Dual, kPow8>(P + f.prim, f.kind, s.sdf.mb_iters, Dual(p[0], u[0]),
                          Dual(p[1], u[1]), Dual(p[2], u[2]), hp, hth, st);
    const int np = prim_stride(f.kind);
    float d_ps[3];
    for (int k = 0; k < 3; ++k) d_ps[k] = d_p[k] + tan_(hp[k]) + d_dmin * f.g[k];
    // p = o + t d, t the IFT-attached march t (tmin on a miss: no gradient)
    for (int k = 0; k < 3; ++k) {
      d_o[k] += d_ps[k];
      d_d[k] += f.t_eff * d_ps[k];
    }
    float scale = 0.0f;
    if (r.hs) {
      // IFT: dt/d(theta, o, d) = -dDE/d(theta, o, d) / <grad_p DE, d>
      const float d_t = dot3(d_ps, r.d);
      const float denom = dot3(f.g, r.d);
      const float denom_safe = fabsf(denom) < kDenomMin
                                   ? (denom < 0.0f ? -kDenomMin : kDenomMin)
                                   : denom;
      scale = -d_t / denom_safe;
      for (int k = 0; k < 3; ++k) {
        d_o[k] += scale * f.g[k];
        d_d[k] += scale * r.t_bar * f.g[k];
      }
    }
    // on a hit the IFT's scale, on a miss the silhouette's d_dmin: one is 0
#pragma unroll
    for (int k = 0; k < 7; ++k)  // a constant index: hth and gth stay in registers
      if (k < np) acc[(f.prim + k) * stride] += tan_(hth[k]) + (scale + d_dmin) * f.gth[k];
  }
  if (s.use_mesh && r.hm && (!f.sel_sdf || d_margin != 0.0f)) {
    // the point's and the normal's cotangents where the mesh hit is selected
    // (selected per element: a pointer chosen at run time would put both
    // arrays in local memory)
    float dp_m[3], dn_m[3];
    for (int k = 0; k < 3; ++k) {
      dp_m[k] = f.sel_sdf ? 0.0f : d_p[k];
      dn_m[k] = f.sel_sdf ? 0.0f : d_n[k];
    }
    mesh_bwd(r, dp_m, dn_m, d_margin, d_o, d_d, d_c);
  }
}

// The order in which the kernels sum n values v[0], v[stride], ... (a
// column of the block's cotangents, or a parameter's partial rows): lane l
// of a warp adds v[l], v[l + 32], ... in turn, then the 32 lane sums meet in
// a butterfly, each lane adding the sum of lane l ^ 16, then l ^ 8, l ^ 4,
// l ^ 2 and l ^ 1 to its own. The kernels run it with warp shuffles
// (warp_sum); this is its host build, lane by lane.
__device__ __forceinline__ float lane_tree_sum(const float* v, int n, int stride) {
  float lanes[32], next[32];
  for (int l = 0; l < 32; ++l) {
    float sum = 0.0f;
    for (int k = l; k < n; k += 32) sum += v[k * stride];
    lanes[l] = sum;
  }
  for (int off = 16; off; off >>= 1) {
    for (int l = 0; l < 32; ++l) next[l] = lanes[l] + lanes[l ^ off];
    for (int l = 0; l < 32; ++l) lanes[l] = next[l];
  }
  return lanes[0];
}

}  // namespace tr

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;
constexpr int kBlockWarps = kThreads / 32;
constexpr int kStride = kThreads + 1;  // shared columns, padded: no bank conflicts
// the dynamic shared memory a block may take beside its static arrays
constexpr int kMaxSmem = 227 * 1024 - (2 * kThreads + (tr::kNumClasses + 1) * kBlockWarps) * 4;

// The optional counters (cuda_shade.SHADE_BWD_COUNTERS), added to by a
// launch given a counters pointer: its rays by class (tr::RayClass) and the
// Mandelbulb rays that also run the AO taps or the penumbra; its warps,
// those whose 32 rays mix classes as they run and as they were loaded;
// by each warp's costliest class, its warps and their clock64() cycles
// (sum and max) from the chain's start to its last lane's end; the block
// reduction's cycles (sum and max over blocks), the blocks, and the most
// cycles a thread of the second kernel spent on its sums.
enum ShadeCounter {
  kRays = 0, kRaysBulbAo = 4, kWarps = 5, kWarpsMixed = 6, kWarpsMixedLoaded = 7,
  kClassWarps = 8, kClassCycles = 12, kClassCyclesMax = 16, kEpilogueCycles = 20,
  kEpilogueCyclesMax = 21, kBlocks = 22, kSumCyclesMax = 23, kNumShadeCounters = 24};

// One warp's share of the counters: lane k's ray has class cls (as run)
// and the ray lane k loaded class cls_loaded; valid: lane k has a ray.
__device__ void shade_count_warp(unsigned long long* counters, bool valid, int cls,
                                 int cls_loaded, bool bulb_ao, long long c0) {
  using u64 = unsigned long long;
  const unsigned full = 0xffffffffu;
  __syncwarp(full);
  const long long cycles = clock64() - c0;
  const unsigned lane = threadIdx.x & 31;
  for (int c = 0; c < tr::kNumClasses; ++c) {
    const unsigned n_c = __popc(__ballot_sync(full, valid && cls == c));
    if (lane == 0 && n_c) atomicAdd(counters + kRays + c, static_cast<u64>(n_c));
  }
  const unsigned n_ao = __popc(__ballot_sync(full, valid && bulb_ao && cls == tr::kClassBulb));
  const unsigned any = __ballot_sync(full, valid);
  const int none = tr::kNumClasses;
  const int top = __reduce_max_sync(full, valid ? cls : 0);
  const bool mixed = __reduce_min_sync(full, valid ? cls : none) < top;
  const bool mixed_loaded = __reduce_min_sync(full, valid ? cls_loaded : none) <
                            __reduce_max_sync(full, valid ? cls_loaded : 0);
  if (lane == 0 && any) {
    atomicAdd(counters + kRaysBulbAo, static_cast<u64>(n_ao));
    atomicAdd(counters + kWarps, 1ull);
    atomicAdd(counters + kWarpsMixed, static_cast<u64>(mixed));
    atomicAdd(counters + kWarpsMixedLoaded, static_cast<u64>(mixed_loaded));
    atomicAdd(counters + kClassWarps + top, 1ull);
    atomicAdd(counters + kClassCycles + top, static_cast<u64>(cycles));
    atomicMax(counters + kClassCyclesMax + top, static_cast<u64>(cycles));
  }
}

// The fixed-order sum of lane_tree_sum with warp shuffles (the second
// pass; the block's column sums run the same order four columns at a
// time): every lane of the warp returns the total.
__device__ __forceinline__ float warp_sum(const float* v, int n, int stride) {
  float sum = 0.0f;
  for (int k = threadIdx.x & 31; k < n; k += 32) sum += v[k * stride];
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return sum;
}

// One block of kThreads rays. Dynamic shared memory: acc[n_par][kStride]
// (column j is ray j's parameter cotangents), then each thread's MbStore
// column (2 * slots floats a thread: the Mandelbulb adjoint's stored
// iterations, values then Dual tangents). The launch bounds name one block
// an SM: with the thread count alone ptxas held the generic build at 128
// registers and spilled.
template <bool kPow8>
__global__ void __launch_bounds__(kThreads, 1) shade_bwd_kernel(
    tr::ShadeParams s, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ corners, const float* __restrict__ t_bar,
    const float* __restrict__ tmin, const uint8_t* __restrict__ hs,
    const uint8_t* __restrict__ hm, const uint8_t* __restrict__ closer,
    const int* __restrict__ mat, const float* __restrict__ vis,
    const float* __restrict__ ts, const float* __restrict__ ao_tmesh,
    const float* __restrict__ ct, int n, int slots, float* __restrict__ d_o,
    float* __restrict__ d_d, float* __restrict__ d_corners,
    float* __restrict__ partials, unsigned long long* __restrict__ counters) {
  extern __shared__ float acc[];
  __shared__ int cls_of[kThreads], perm[kThreads];
  __shared__ int class_count[tr::kNumClasses + 1][kBlockWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < s.n_par; ++j) acc[j * kStride + tid] = 0.0f;
  const tr::MbStore st{acc + s.n_par * kStride + tid, kThreads, slots * kThreads};

  // With the generic field, the block's rays in a stable order by class
  // (lanes past n last), so that a warp's 32 rays run one chain: its bulb
  // lanes take ~13x an SDF lane's cycles, and the sort made the silhouette
  // block 11% faster. With the power-8 field (~4.5x) the class's scene_argmin
  // cost more than the sort saved (3-5% slower), and the rays keep their
  // load order.
  const int i_loaded = blockIdx.x * kThreads + tid;
  int cls = tr::kNumClasses;
  if (i_loaded < n && (!kPow8 || counters))
    cls = tr::ray_class<kPow8>(s, tr::load_ray(i_loaded, n, o, d, corners, t_bar, tmin, hs,
                                               hm, closer, mat, vis, ts, ao_tmesh, ct));
  cls_of[tid] = cls;
  int pos = tid;
  if (!kPow8) {
    for (int c = 0; c <= tr::kNumClasses; ++c) {
      const unsigned m = __ballot_sync(0xffffffffu, cls == c);
      if (cls == c) pos = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) class_count[c][warp] = __popc(m);
    }
    __syncthreads();
    for (int c = 0; c <= cls; ++c)
      for (int w = 0; w < kBlockWarps; ++w)
        if (c < cls || w < warp) pos += class_count[c][w];
  }
  perm[pos] = tid;
  __syncthreads();

  // thread tid runs ray j and adds into its column j: the column sums below
  // take the same values in the same order as without the sort
  const int j = perm[tid];
  const int i = blockIdx.x * kThreads + j;
  const bool valid = i < n;
  long long c0 = 0;
  if (counters) {
    __syncwarp();
    c0 = clock64();
  }
  if (valid) {
    const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, tmin, hs, hm, closer, mat,
                                     vis, ts, ao_tmesh, ct);
    float go[3], gd[3], gc[9];
    tr::shade_bwd_ray<kPow8>(s, r, acc + j, kStride, go, gd, gc, st);
    for (int k = 0; k < 3; ++k) {
      d_o[3 * i + k] = go[k];
      d_d[3 * i + k] = gd[k];
    }
    if (d_corners)
      for (int k = 0; k < 9; ++k) d_corners[9 * i + k] = gc[k];
  }
  if (counters)
    shade_count_warp(counters, valid, cls_of[j], cls, s.ao_sdf || s.soft_diff, c0);
  __syncthreads();
  const long long e0 = clock64();
  // the block's partial row: a warp a column, each column in warp_sum's
  // order, four columns of a warp at a time (their shuffles overlap)
  for (int col0 = warp; col0 < s.n_par; col0 += 4 * kBlockWarps) {
    float sum[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + c * kBlockWarps;
      sum[c] = 0.0f;
      if (col < s.n_par)
        for (int k = lane; k < kThreads; k += 32) sum[c] += acc[col * kStride + k];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (lane == 0 && col0 + c * kBlockWarps < s.n_par)
        partials[blockIdx.x * s.n_par + col0 + c * kBlockWarps] = sum[c];
  }
  if (counters) {
    __syncthreads();
    if (tid == 0) {
      const unsigned long long e = static_cast<unsigned long long>(clock64() - e0);
      atomicAdd(counters + kEpilogueCycles, e);
      atomicMax(counters + kEpilogueCyclesMax, e);
      atomicAdd(counters + kBlocks, 1ull);
    }
  }
}

// d_small[j] = the sum of the partial rows' column j: a warp a parameter,
// in warp_sum's order.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int n_rows, int n_par,
                                    float* __restrict__ out,
                                    unsigned long long* __restrict__ counters) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (j >= n_par) return;  // the whole warp
  const long long c0 = clock64();
  const float sum = warp_sum(partials + j, n_rows, n_par);
  if ((threadIdx.x & 31) == 0) {
    out[j] = sum;
    if (counters)
      atomicMax(counters + kSumCyclesMax, static_cast<unsigned long long>(clock64() - c0));
  }
}

}  // namespace

extern "C" int tr_shade_bwd_threads() { return kThreads; }

extern "C" int tr_shade_bwd(
    const float* o, const float* d, const float* corners, const float* t_bar,
    const float* tmin, const uint8_t* hs, const uint8_t* hm,
    const uint8_t* closer, const int* mat, const float* vis, const float* ts,
    const float* ao_tmesh, const float* ct, int n, const float* small,
    int n_sph, int n_pln, int n_box, int n_mb, int mb_iters, int mb_pow8, int n_mat,
    int n_dir, int n_pos, int use_sdf, int use_mesh, int ao_sdf, int ao_mesh,
    int soft_diff, float soft_sil, float mesh_sil, double ao_step,
    float ao_strength, float soft_k, float bias, float* d_o, float* d_d,
    float* d_corners, float* partials, int n_partial_rows, float* d_small,
    unsigned long long* counters, void* stream) {
  const tr::ShadeParams s = tr::make_params(
      small, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, n_mat, n_dir, n_pos, use_sdf,
      use_mesh, ao_sdf, ao_mesh, soft_diff, soft_sil, mesh_sil, ao_step,
      ao_strength, soft_k, bias);
  const int n_blocks = n > 0 ? (n + kThreads - 1) / kThreads : 0;
  const int slots = n_mb > 0 ? tr::mb_store_slots(mb_iters) : 0;
  const size_t smem =
      (static_cast<size_t>(s.n_par) * kStride + 2 * slots * kThreads) * sizeof(float);
  if (n_mat < 1 || smem > kMaxSmem ||
      n_partial_rows != n_blocks || (soft_diff && !ts) || (ao_mesh && !ao_tmesh) ||
      (soft_sil > 0.0f && !tmin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0) {
    auto kernel = mb_pow8 ? shade_bwd_kernel<true> : shade_bwd_kernel<false>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<n_blocks, kThreads, smem, st>>>(
        s, o, d, corners, t_bar, tmin, hs, hm, closer, mat, vis, ts, ao_tmesh,
        ct, n, slots, d_o, d_d, d_corners, partials, counters);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sum_partials_kernel<<<(32 * s.n_par + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      partials, n_blocks, s.n_par, d_small, counters);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
