// The geometry pass's values-only reconstruct: each ray's hit state and its
// shadow-ray origin from the primary residuals, in one pass.
//
// The JAX package has no Pallas kernel here: XLA fuses its `_sdf_from_res`
// and `_mesh_from_res` (tpu_ray/render/render.py:272-340). The plain
// PyTorch version is the port's `render.shadow_ray_origins` over
// `reconstruct_hits(lite=True)` (tpu_ray_torch/render/render.py), which ran
// ~4,400 elementwise launches a block on the card: autograd through the
// plain distance field for the normal, a third DE pass for the material,
// the mesh corners gathered and re-solved.
//
// Per ray, as reconstruct_hits selects it: the SDF hit at the march t (or
// at its closest approach tmin, on a soft silhouette's miss), its normal
// grad_p DE / sqrt(max(|grad_p DE|^2, 1e-12)) and the material of the first
// primitive that attains the DE; the selected triangle's Moller-Trumbore
// re-solve from its row of the frame's (T, 10) table, t = BIG on a mesh
// miss; with both, the closest-select BIG <= BIG. Then the ray-facing
// normal and the shadow origin p + bias * nf, parked at o on a lane that
// hits nothing when there is no soft silhouette. The arithmetic is the
// shade chain's (shade_chain.cuh: sdf_t_eff, mt_solve; sdf_adj.cuh:
// scene_argmin with the bulb's forward stored, prim_adj), so the geometry
// pass and the shade kernels reconstruct one and the same hit. t, hit, p,
// mat and the masks equal the plain version bit for bit under
// --fmad=false; the normal is the hand adjoint, not autograd's op order.
//
// The generic field's normal runs in double. Its float32 gradient is ill-
// conditioned (sinf, atan2f and powf through a dozen iterations): the plain
// version's float32 normal leaves its float64 evaluation at the same hit
// point by over 1e-5 on a large share of the rays (PERF.md §6), and a
// float32 adjoint in another op order than autograd's lands as far from the
// plain version, on some rays farther from float64 than the plain one. In
// double the kernel's normal is the float64 one rounded: wherever it leaves
// the plain version, float64 sides with the kernel. The power-8 field's
// float32 normal stays within 1e-4 of the plain version on every hit ray,
// and runs in float32 as the shade kernels' does.
//
// What bounds it on an H100: compute on the rays whose SDF point the
// Mandelbulb attains (the argmin's DE, then the adjoint's reverse pass
// over its stored iterations), as in #5 without the AO taps and the
// lights. Every other ray reads ~50 bytes and writes ~60.
//
// The design: one thread per ray, every lane through the same selects as
// the plain version (misses included, whose values the plain version
// computes too). The bulb's stored iterations live in the thread's column
// of shared memory, as in #5 (the generic field's double iterations in a
// local array). The field is a template (kPow8); the method's SDF and mesh
// flags and the soft silhouette are runtime arguments.
//
// Everything above the kernel is plain C++, so that the per-ray arithmetic
// also builds as host code (tests/test_torch_reconstruct.py holds that
// build against the plain version on the CPU).
#include <stdint.h>

#include "shade_chain.cuh"

namespace tr {

// One ray's values-only hit state and shadow origin.
struct Recon {
  float t;
  bool hit, closer;  // closer: the SDF hit selected (BIG <= BIG on no hit)
  float p[3], n[3], nf[3], p_off[3];
  int mat;
  float cov;
};

// The index of the primitive at packed offset off (of kind kind) in the
// layout order of the material ids.
__device__ __forceinline__ int prim_index(const SdfParams& s, int off, int kind) {
  if (kind == kSphere) return off / 4;
  off -= 4 * s.n_sph;
  int base = s.n_sph;
  if (kind == kPlane) return base + off / 4;
  off -= 4 * s.n_pln;
  base += s.n_pln;
  if (kind == kBox) return base + off / 7;
  off -= 7 * s.n_box;
  return base + s.n_box + off / kBulbStride;
}

// Ray r's reconstruct (r.c: its selected triangle's corners, tri_mat that
// triangle's material; prim_mat: the primitives' materials in layout order).
template <bool kPow8>
__device__ __forceinline__ void reconstruct_ray(const ShadeParams& s, const int* prim_mat,
                                                const RayIn& r, int tri_mat, Recon* out,
                                                const MbStore& st) {
  float ps[3] = {0.0f, 0.0f, 0.0f}, ns[3] = {0.0f, 0.0f, 0.0f};
  int ms = 0;
  if (s.use_sdf) {
    const float t_eff = sdf_t_eff(s, r);
    for (int k = 0; k < 3; ++k) ps[k] = r.o[k] + t_eff * r.d[k];
    int kind = 0;
    MbFwd<float> mb;
    // the power-8 adjoint reads the argmin's stored forward; the generic
    // one runs its own, in double
    const bool reuse = kPow8 && !kSerialChain;
    const int prim = scene_argmin<kPow8>(s.sdf, ps[0], ps[1], ps[2], &kind, nullptr,
                                         reuse ? &mb : nullptr, reuse ? &st : nullptr);
    if (prim >= 0) {
      if (kPow8) {
        float g[3], gth[7];
        prim_adj<float, kPow8>(s.sdf.p + prim, kind, s.sdf.mb_iters, ps[0], ps[1], ps[2],
                               g, gth, st, reuse ? &mb : nullptr);
        const float glen = sqrtf(fmaxf(dot3(g, g), 1e-12f));
        for (int k = 0; k < 3; ++k) ns[k] = g[k] / glen;
      } else {
        double buf[4 * kMaxMbIters], g[3], gth[7];
        prim_adj<double, kPow8>(s.sdf.p + prim, kind, s.sdf.mb_iters, double(ps[0]),
                                double(ps[1]), double(ps[2]), g, gth,
                                MbStore{nullptr, 1, 0, buf});
        const double glen = sqrt(fmax(g[0] * g[0] + g[1] * g[1] + g[2] * g[2], 1e-12));
        for (int k = 0; k < 3; ++k) ns[k] = static_cast<float>(g[k] / glen);
      }
      ms = prim_mat[prim_index(s.sdf, prim, kind)];
    }
  }
  float tm = kBig, pm[3] = {0.0f, 0.0f, 0.0f}, nm[3] = {0.0f, 0.0f, 0.0f};
  int mm = 0;
  if (s.use_mesh) {
    MtSolve m;
    mt_solve(r, &m);
    tm = r.hm ? m.tm : kBig;
    for (int k = 0; k < 3; ++k) {
      pm[k] = r.o[k] + tm * r.d[k];
      nm[k] = m.cn[k] / m.cl;
    }
    mm = r.hm ? tri_mat : 0;
  }
  // the closest-select of reconstruct_hits (an SDF-only or mesh-only
  // method selects its own branch)
  bool sel_sdf = s.use_sdf != 0;
  if (s.use_sdf && s.use_mesh) sel_sdf = (r.hs ? r.t_bar : kBig) <= tm;
  out->closer = sel_sdf;
  out->hit = (s.use_sdf && r.hs) || (s.use_mesh && r.hm);
  out->t = sel_sdf ? r.t_bar : tm;
  out->mat = sel_sdf ? ms : mm;
  out->cov = out->hit ? 1.0f : 0.0f;
  for (int k = 0; k < 3; ++k) {
    out->p[k] = sel_sdf ? ps[k] : pm[k];
    out->n[k] = sel_sdf ? ns[k] : nm[k];
  }
  // two-sided: face the normal against the ray; the shadow rays' origin
  const float flip = dot3(out->n, r.d) > 0.0f ? -1.0f : 1.0f;
  const bool park = !(s.soft_sil > 0.0f) && !out->hit;
  for (int k = 0; k < 3; ++k) {
    out->nf[k] = flip * out->n[k];
    out->p_off[k] = park ? r.o[k] : out->p[k] + s.bias * out->nf[k];
  }
}

// The kernel's pointers: the per-ray inputs (null where the method reads
// none), the (T, 10) triangle table, the primitives' materials in layout
// order, and the per-ray outputs (closer null unless the method is mixed).
struct ReconArgs {
  const float *o, *d, *t_bar, *tmin;
  const uint8_t* hs;
  const int* tri;
  const uint8_t* hm;
  const float* rows;
  int n_tris;
  const int* prim_mat;
  float* t;
  uint8_t* hit;
  float *p, *n;
  int* mat;
  float* cov;
  uint8_t* closer;
  float *nf, *p_off;
};

// Ray i: its inputs as the shade chain's RayIn (null inputs read as 0 and
// false), its triangle's corners and material from the row clamp(tri, 0,
// T - 1) of the table; its reconstruct, written to the outputs.
template <bool kPow8>
__device__ __forceinline__ void reconstruct_one(const ShadeParams& s, const ReconArgs& a,
                                                int i, const MbStore& st) {
  RayIn r = {};
  for (int k = 0; k < 3; ++k) {
    r.o[k] = a.o[3 * i + k];
    r.d[k] = a.d[3 * i + k];
  }
  r.t_bar = a.t_bar ? a.t_bar[i] : 0.0f;
  r.tmin = a.tmin ? a.tmin[i] : 0.0f;
  r.hs = a.hs ? a.hs[i] != 0 : false;
  r.hm = a.hm ? a.hm[i] != 0 : false;
  int tri_mat = 0;
  if (a.rows) {
    const int t = a.tri[i];
    const float* row = a.rows + 10 * (t < 0 ? 0 : (t >= a.n_tris ? a.n_tris - 1 : t));
    for (int k = 0; k < 9; ++k) r.c[k] = row[k];
    tri_mat = static_cast<int>(row[9]);
  }
  Recon out;
  reconstruct_ray<kPow8>(s, a.prim_mat, r, tri_mat, &out, st);
  a.t[i] = out.t;
  a.hit[i] = out.hit ? 1 : 0;
  a.mat[i] = out.mat;
  a.cov[i] = out.cov;
  if (a.closer) a.closer[i] = out.closer ? 1 : 0;
  for (int k = 0; k < 3; ++k) {
    a.p[3 * i + k] = out.p[k];
    a.n[3 * i + k] = out.n[k];
    a.nf[3 * i + k] = out.nf[k];
    a.p_off[3 * i + k] = out.p_off[k];
  }
}

// The kernel's parameters from the entry point's arguments, or false where
// the method lacks an input it reads.
__host__ __device__ __forceinline__ bool recon_params(
    const float* params, int n_sph, int n_pln, int n_box, int n_mb, int mb_iters,
    int mb_pow8, int use_sdf, int use_mesh, float soft_sil, float bias, const ReconArgs& a,
    ShadeParams* s) {
  *s = make_params(params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, 0, 0, 0, use_sdf,
                   use_mesh, 0, 0, 0, soft_sil, 0.0f, 0.0, 0.0f, 0.0f, bias);
  return (use_sdf || use_mesh) &&
         !(use_sdf && (!a.t_bar || !a.hs || !a.prim_mat || (soft_sil > 0.0f && !a.tmin))) &&
         !(use_mesh && (!a.tri || !a.hm || !a.rows || a.n_tris < 1)) &&
         !(use_sdf && use_mesh && !a.closer);
}

}  // namespace tr

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 128;

// Dynamic shared memory: each thread's MbStore column (the power-8 normal's
// Mandelbulb adjoint's stored iterations).
template <bool kPow8>
__global__ void __launch_bounds__(kThreads) reconstruct_kernel(tr::ShadeParams s,
                                                               tr::ReconArgs a, int n) {
  extern __shared__ float store[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  tr::reconstruct_one<kPow8>(s, a, i, tr::MbStore{store + threadIdx.x, kThreads, 0});
}

}  // namespace

extern "C" int tr_reconstruct(
    const float* o, const float* d, const float* t_bar, const float* tmin,
    const uint8_t* hs, const int* tri, const uint8_t* hm, const float* rows, int n_tris,
    int n, const float* params, const int* prim_mat, int n_sph, int n_pln, int n_box,
    int n_mb, int mb_iters, int mb_pow8, int use_sdf, int use_mesh, float soft_sil,
    float bias, float* t, uint8_t* hit, float* p, float* nrm, int* mat, float* cov,
    uint8_t* closer, float* nf, float* p_off, void* stream) {
  const tr::ReconArgs a{o, d, t_bar, tmin, hs, tri, hm, rows, n_tris, prim_mat,
                        t, hit, p, nrm, mat, cov, closer, nf, p_off};
  tr::ShadeParams s;
  if (!tr::recon_params(params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, use_sdf,
                        use_mesh, soft_sil, bias, a, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    auto kernel = mb_pow8 ? reconstruct_kernel<true> : reconstruct_kernel<false>;
    const size_t smem =
        static_cast<size_t>(use_sdf && n_mb > 0 && mb_pow8 ? tr::mb_store_slots(mb_iters) : 0) *
        kThreads * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(s, a, n);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
