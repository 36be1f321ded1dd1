"""The CUDA kernels' per-ray arithmetic built as host C++ with g++, for the
port's tests (tests/test_torch_shade_*.py, test_torch_packet_resident.py,
test_torch_mandelbulb.py, test_torch_sdf.py, test_torch_reconstruct.py,
test_torch_corner_scatter.py): the shade forward, the shade backward, the
primary, hard and soft marches, the Mandelbulb fields and their adjoint, the
packet walk, the values-only reconstruct and the corner gather and scatter,
called
with the arguments their CUDA wrappers pass. The sources keep their arithmetic above the `__CUDACC__` guard, so
g++ builds the same code nvcc does, without `-ffp-contract` (as nvcc's
`--fmad=false`)."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from tpu_ray_torch.kernels import cuda_shade
from tpu_ray_torch.render import plain as tplain
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.render.chain import frame_chain
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.scene.types import Lights

HOST_MAIN = r"""
#include "sdf_march.cu"
#include "shade_bwd.cu"
#include "shade_fwd.cu"
#define SHADE_ARGS                                                            \
    const float *o, const float *d, const float *corners, const float *t_bar, \
    const float *tmin, const uint8_t *hs, const uint8_t *hm,                  \
    const uint8_t *closer, const int *mat, const float *vis, const float *ts, \
    const float *ao_tmesh
#define SHADE_STATICS                                                         \
    int n, const float *small, int n_sph, int n_pln, int n_box, int n_mb,     \
    int mb_iters, int mb_pow8, int n_mat, int n_dir, int n_pos, int use_sdf,  \
    int use_mesh, int ao_sdf, int ao_mesh, int soft_diff, float soft_sil,     \
    float mesh_sil, double ao_step, float ao_strength, float soft_k,          \
    float bias
#define MAKE_PARAMS                                                           \
  tr::make_params(small, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, n_mat, \
                  n_dir, n_pos, use_sdf, use_mesh, ao_sdf, ao_mesh, soft_diff, \
                  soft_sil, mesh_sil, ao_step, ao_strength, soft_k, bias)
// A thread's MbStore, as a local array.
struct HostStore {
  float buf[2 * 4 * tr::kMaxMbIters];
  tr::MbStore st{buf, 1, 4 * tr::kMaxMbIters};
};
extern "C" void host_shade_bwd(SHADE_ARGS, const float* ct, SHADE_STATICS,
                               float* d_o, float* d_d, float* d_corners,
                               double* d_small) {
  const tr::ShadeParams s = MAKE_PARAMS;
  float* one = new float[s.n_par];
  HostStore hs_;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < s.n_par; ++j) one[j] = 0.0f;
    const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, tmin, hs, hm,
                                     closer, mat, vis, ts, ao_tmesh, ct);
    if (mb_pow8)
      tr::shade_bwd_ray<true>(s, r, one, 1, d_o + 3 * i, d_d + 3 * i, d_corners + 9 * i,
                              hs_.st);
    else
      tr::shade_bwd_ray<false>(s, r, one, 1, d_o + 3 * i, d_d + 3 * i, d_corners + 9 * i,
                               hs_.st);
    for (int j = 0; j < s.n_par; ++j) d_small[j] += one[j];
  }
  delete[] one;
}
// The backward kernel's blocks of `block` rays, lane by lane as the kernel
// runs them: the block's rays in a stable order by class (tr::ray_class,
// rays past n last) when `sorted`, else in load order; each ray adds into
// its own column of acc[n_par][block]; then each column's sum, in the
// kernels' lane_tree_sum order, into the block's row of partials.
extern "C" void host_shade_bwd_blocks(SHADE_ARGS, const float* ct, SHADE_STATICS,
                                      int block, int sorted, float* d_o, float* d_d,
                                      float* d_corners, float* partials) {
  const tr::ShadeParams s = MAKE_PARAMS;
  float* acc = new float[s.n_par * block];
  int* order = new int[block];
  int* cls = new int[block];
  HostStore hs_;
  for (int b = 0; b * block < n; ++b) {
    for (int j = 0; j < s.n_par * block; ++j) acc[j] = 0.0f;
    for (int k = 0; k < block; ++k) {
      const int i = b * block + k;
      cls[k] = tr::kNumClasses;
      if (i < n) {
        const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, tmin, hs, hm, closer,
                                         mat, vis, ts, ao_tmesh, ct);
        cls[k] = mb_pow8 ? tr::ray_class<true>(s, r) : tr::ray_class<false>(s, r);
      }
    }
    int pos = 0;
    for (int c = 0; c <= tr::kNumClasses; ++c)
      for (int k = 0; k < block; ++k)
        if (!sorted ? c == 0 : cls[k] == c) order[pos++] = k;
    for (int lane = 0; lane < block; ++lane) {
      const int j = order[lane], i = b * block + j;
      if (i >= n) continue;
      const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, tmin, hs, hm, closer, mat,
                                       vis, ts, ao_tmesh, ct);
      if (mb_pow8)
        tr::shade_bwd_ray<true>(s, r, acc + j, block, d_o + 3 * i, d_d + 3 * i,
                                d_corners + 9 * i, hs_.st);
      else
        tr::shade_bwd_ray<false>(s, r, acc + j, block, d_o + 3 * i, d_d + 3 * i,
                                 d_corners + 9 * i, hs_.st);
    }
    for (int j = 0; j < s.n_par; ++j)
      partials[b * s.n_par + j] = tr::lane_tree_sum(acc + j * block, block, 1);
  }
  delete[] cls;
  delete[] order;
  delete[] acc;
}
// The kernels' fixed-order sum of n values at stride.
extern "C" float host_lane_tree_sum(const float* v, int n, int stride) {
  return tr::lane_tree_sum(v, n, stride);
}
extern "C" void host_shade_fwd(SHADE_ARGS, SHADE_STATICS, float* out) {
  const tr::ShadeParams s = MAKE_PARAMS;
  HostStore hs_;
  for (int i = 0; i < n; ++i) {
    const tr::RayIn r = tr::load_ray(i, n, o, d, corners, t_bar, tmin, hs, hm,
                                     closer, mat, vis, ts, ao_tmesh, nullptr);
    if (mb_pow8)
      tr::shade_fwd_ray<true>(s, r, out + 3 * i, hs_.st);
    else
      tr::shade_fwd_ray<false>(s, r, out + 3 * i, hs_.st);
  }
}
extern "C" void host_shadow_soft(
    const float* p, const float* l, const float* t_far_rays, int n,
    const float* params, int n_sph, int n_pln, int n_box, int n_mb,
    int mb_iters, int mb_pow8, float eps, float t_far, int steps, float bias,
    float soft_k, float* vis, float* ts) {
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  for (int i = 0; i < n; ++i) {
    const float tf = t_far_rays ? t_far_rays[i] : t_far;
    if (mb_pow8)
      tr::shadow_soft_ray<true>(sdf, p[3 * i], p[3 * i + 1], p[3 * i + 2], l[3 * i],
                                l[3 * i + 1], l[3 * i + 2], tf, eps, steps, bias,
                                soft_k, vis + i, ts + i);
    else
      tr::shadow_soft_ray<false>(sdf, p[3 * i], p[3 * i + 1], p[3 * i + 2], l[3 * i],
                                 l[3 * i + 1], l[3 * i + 2], tf, eps, steps, bias,
                                 soft_k, vis + i, ts + i);
  }
}
extern "C" void host_march(
    const float* o, const float* d, int n, const float* params, int n_sph, int n_pln,
    int n_box, int n_mb, int mb_iters, int mb_pow8, const float* bounds, int n_bounds,
    float t0, int max_steps, float eps, float t_far, float* t, uint8_t* hit, int* steps,
    float* tmin) {
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  for (int i = 0; i < n; ++i) {
    bool h, reach;
    steps[i] = mb_pow8
        ? tr::march_ray<true>(sdf, bounds, n_bounds, o[3 * i], o[3 * i + 1], o[3 * i + 2],
                              d[3 * i], d[3 * i + 1], d[3 * i + 2], t0, max_steps, eps, t_far,
                              t + i, &h, tmin + i, &reach)
        : tr::march_ray<false>(sdf, bounds, n_bounds, o[3 * i], o[3 * i + 1], o[3 * i + 2],
                               d[3 * i], d[3 * i + 1], d[3 * i + 2], t0, max_steps, eps, t_far,
                               t + i, &h, tmin + i, &reach);
    hit[i] = h ? 1 : 0;
  }
}
extern "C" void host_shadow_hard(
    const float* p, const float* l, const float* t_far_rays, int n,
    const float* params, int n_sph, int n_pln, int n_box, int n_mb,
    int mb_iters, int mb_pow8, const float* bounds, int n_bounds, float eps,
    float t_far, int steps, float bias, float* vis, float* ts) {
  const tr::SdfParams sdf{params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8};
  for (int i = 0; i < n; ++i) {
    const float tf = t_far_rays ? t_far_rays[i] : t_far;
    if (mb_pow8)
      tr::shadow_hard_ray<true>(sdf, bounds, n_bounds, p[3 * i], p[3 * i + 1], p[3 * i + 2],
                                l[3 * i], l[3 * i + 1], l[3 * i + 2], tf, eps, steps, bias,
                                vis + i, ts + i);
    else
      tr::shadow_hard_ray<false>(sdf, bounds, n_bounds, p[3 * i], p[3 * i + 1], p[3 * i + 2],
                                 l[3 * i], l[3 * i + 1], l[3 * i + 2], tf, eps, steps, bias,
                                 vis + i, ts + i);
  }
}
// The Mandelbulb field of the local points p (n, 3): the DE as the marches
// evaluate it (de), and as its adjoint evaluates it (de_adj) with the
// gradient g (n, 3) and d/d power (n).
extern "C" void host_mandelbulb(const float* p, int n, float power, int iters,
                                int pow8, float* de, float* de_adj, float* g,
                                float* d_power) {
  HostStore hs_;
  for (int i = 0; i < n; ++i) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    float dp = 0.0f;
    if (pow8) {
      de[i] = tr::mandelbulb_pow8(x, y, z, iters);
      de_adj[i] = tr::mandelbulb_adj<float, true>(x, y, z, power, iters, g + 3 * i, &dp,
                                                  hs_.st);
    } else {
      de[i] = tr::mandelbulb_generic(x, y, z, power, iters);
      de_adj[i] = tr::mandelbulb_adj<float, false>(x, y, z, power, iters, g + 3 * i, &dp,
                                                   hs_.st);
    }
    d_power[i] = dp;
  }
}
"""

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_STATICS = [_I, _P] + [_I] * 14 + [_F, _F, _D, _F, _F, _F]


def build(tmp_dir, serial: bool = False):
    """The host library built into tmp_dir, or None without g++. serial:
    the shade chain in its plain order (csrc/shade_chain.cuh,
    TR_SHADE_SERIAL), against which the tests hold the kernels' order."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    (tmp_dir / "main.cpp").write_text(HOST_MAIN)
    lib = tmp_dir / ("libshade_host_serial.so" if serial else "libshade_host.so")
    csrc = cuda_shade.__file__.rsplit("/kernels/", 1)[0] + "/csrc"
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    *(["-DTR_SHADE_SERIAL"] if serial else []),
                    "-I", csrc, "-o", str(lib), str(tmp_dir / "main.cpp")], check=True,
                   capture_output=True, timeout=180)
    so = ctypes.CDLL(str(lib))
    so.host_shade_bwd.argtypes = [_P] * 13 + _STATICS + [_P] * 4
    so.host_shade_fwd.argtypes = [_P] * 12 + _STATICS + [_P]
    so.host_shade_bwd_blocks.argtypes = [_P] * 13 + _STATICS + [_I, _I] + [_P] * 4
    so.host_shade_bwd_blocks.restype = None
    so.host_lane_tree_sum.argtypes = [_P, _I, _I]
    so.host_lane_tree_sum.restype = ctypes.c_float
    so.host_shadow_soft.argtypes = [_P, _P, _P, _I, _P] + [_I] * 6 + [_F, _F, _I, _F, _F, _P, _P]
    so.host_shadow_hard.argtypes = ([_P, _P, _P, _I, _P] + [_I] * 6 + [_P, _I, _F, _F, _I, _F]
                                    + [_P, _P])
    so.host_mandelbulb.argtypes = [_P, _I, _F, _I, _I, _P, _P, _P, _P]
    so.host_march.argtypes = ([_P, _P, _I, _P] + [_I] * 6 + [_P, _I, _F, _I, _F, _F]
                              + [_P] * 4)
    for fn in (so.host_shade_bwd, so.host_shade_fwd, so.host_shadow_soft, so.host_shadow_hard,
               so.host_mandelbulb, so.host_march):
        fn.restype = None
    return so


PACKET_MAIN = r"""
#include "packet_mt.cu"
// The kernels' block walk, each block's kThreads lanes emulated in turn.
extern "C" void host_packet_walk(
    const float* o, const float* d, const float* t_init, int n, float t_far,
    const float* corners, const float* chunk_aabb, const float* super_aabb,
    const float* tree, const int* order, int n_supers, const int* perm, int perm_len,
    int any_hit, float* t, int* tri, uint8_t* hit, unsigned long long* counters) {
  trmt::Shared* sh = new trmt::Shared;
  trmt::Lane* lanes = new trmt::Lane[trmt::kThreads];
  for (int b = 0; b * trmt::kRays < n; ++b) {
    for (int k = 0; k < trmt::kThreads; ++k) lanes[k].tid = k;
    if (order)
      trmt::walk_block<false>(b, o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb,
                              tree, order, n_supers, perm, perm_len, any_hit, t, tri, hit,
                              counters, *sh, lanes);
    else
      trmt::walk_block<true>(b, o, d, t_init, n, t_far, corners, chunk_aabb, super_aabb,
                             tree, order, n_supers, perm, perm_len, any_hit, t, tri, hit,
                             counters, *sh, lanes);
  }
  delete[] lanes;
  delete sh;
}
"""


def build_packet(tmp_dir):
    """The packet kernels' per-ray walk (csrc/packet_mt.cu) built into
    tmp_dir, or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    (tmp_dir / "packet_main.cpp").write_text(PACKET_MAIN)
    lib = tmp_dir / "libpacket_host.so"
    csrc = cuda_shade.__file__.rsplit("/kernels/", 1)[0] + "/csrc"
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", csrc, "-o", str(lib), str(tmp_dir / "packet_main.cpp")], check=True,
                   capture_output=True, timeout=180)
    so = ctypes.CDLL(str(lib))
    so.host_packet_walk.argtypes = [_P, _P, _P, _I, _F, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                                    _P, _P, _P, _P]
    so.host_packet_walk.restype = None
    return so


RECON_MAIN = r"""
#include "reconstruct.cu"
// The reconstruct kernel's rays one after another, with tr_reconstruct's
// arguments; returns 0, or 1 where the entry point refuses them.
extern "C" int host_reconstruct(
    const float* o, const float* d, const float* t_bar, const float* tmin,
    const uint8_t* hs, const int* tri, const uint8_t* hm, const float* rows, int n_tris,
    int n, const float* params, const int* prim_mat, int n_sph, int n_pln, int n_box,
    int n_mb, int mb_iters, int mb_pow8, int use_sdf, int use_mesh, float soft_sil,
    float bias, float* t, uint8_t* hit, float* p, float* nrm, int* mat, float* cov,
    uint8_t* closer, float* nf, float* p_off) {
  const tr::ReconArgs a{o, d, t_bar, tmin, hs, tri, hm, rows, n_tris, prim_mat,
                        t, hit, p, nrm, mat, cov, closer, nf, p_off};
  tr::ShadeParams s;
  if (!tr::recon_params(params, n_sph, n_pln, n_box, n_mb, mb_iters, mb_pow8, use_sdf,
                        use_mesh, soft_sil, bias, a, &s))
    return 1;
  float buf[4 * tr::kMaxMbIters];
  const tr::MbStore st{buf, 1, 0};
  for (int i = 0; i < n; ++i) {
    if (mb_pow8)
      tr::reconstruct_one<true>(s, a, i, st);
    else
      tr::reconstruct_one<false>(s, a, i, st);
  }
  return 0;
}
"""


def build_reconstruct(tmp_dir):
    """The reconstruct kernel's per-ray arithmetic (csrc/reconstruct.cu)
    built into tmp_dir, or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    (tmp_dir / "recon_main.cpp").write_text(RECON_MAIN)
    lib = tmp_dir / "librecon_host.so"
    csrc = cuda_shade.__file__.rsplit("/kernels/", 1)[0] + "/csrc"
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", csrc, "-o", str(lib), str(tmp_dir / "recon_main.cpp")], check=True,
                   capture_output=True, timeout=180)
    so = ctypes.CDLL(str(lib))
    so.host_reconstruct.argtypes = ([_P] * 8 + [_I, _I, _P, _P] + [_I] * 8 + [_F, _F]
                                    + [_P] * 9)
    so.host_reconstruct.restype = ctypes.c_int
    return so


def reconstruct(so, scene, cfg, o, d, res, method, mesh_rows=None):
    """The host build of the reconstruct kernel on CPU tensors, with the
    arguments cuda_reconstruct.reconstruct passes -> its Recon."""
    from tpu_ray_torch.kernels import cuda_sdf

    chain = frame_chain(scene, cfg, method)
    use_sdf, use_mesh = chain.use_sdf, chain.use_mesh
    sil = max(float(cfg.soft_silhouette), 0.0)
    packed = cuda_sdf.pack(scene.sdf)
    rows = None
    if use_mesh:
        rows = (tplain.mesh_table(scene.mesh) if mesh_rows is None else mesh_rows).detach()
    ins = [o.contiguous(), d.contiguous(), res["sdf_t"] if use_sdf else None,
           res["sdf_tmin"] if chain.soft_sil else None,
           res["sdf_hit"] if use_sdf else None, res["mesh_tri"] if use_mesh else None,
           res["mesh_hit"] if use_mesh else None, rows]
    for x in ins:
        assert x is None or x.is_contiguous()
    R = o.shape[0]
    t, cov, hit, mat = (torch.empty(R), torch.empty(R), torch.empty(R, dtype=torch.bool),
                        torch.empty(R, dtype=torch.int32))
    p, n, nf, p_off = (torch.empty(R, 3) for _ in range(4))
    closer = torch.empty(R, dtype=torch.bool) if chain.mixed else None
    rc = so.host_reconstruct(*[None if x is None else x.data_ptr() for x in ins],
                             0 if rows is None else rows.shape[0], R, packed.params.data_ptr(),
                             packed.mats.data_ptr(), *packed.counts, int(use_sdf),
                             int(use_mesh), sil, float(cfg.shadow_bias), t.data_ptr(),
                             hit.data_ptr(), p.data_ptr(), n.data_ptr(), mat.data_ptr(),
                             cov.data_ptr(), None if closer is None else closer.data_ptr(),
                             nf.data_ptr(), p_off.data_ptr())
    assert rc == 0
    return tplain.Recon((t, hit, p, n, mat, cov), closer, nf, p_off,
                        hit if sil <= 0.0 else None)


def march(so, sdf, o, d, *, t0, max_steps, eps, t_far, bound_pad=0.0):
    """The host build of the primary march on CPU tensors, with the
    arguments cuda_sdf.march passes (the bounds grown by bound_pad) -> (t,
    hit, steps, tmin) as march_torch returns them."""
    from tpu_ray_torch.kernels import cuda_sdf

    packed = cuda_sdf.pack(sdf, bound_pad)
    params, counts, bounds = packed.params, packed.counts, packed.march_bounds
    n = o.shape[0]
    o, d = o.contiguous(), d.contiguous()
    t, tmin = torch.empty(n), torch.empty(n)
    hit = torch.empty(n, dtype=torch.bool)
    steps = torch.empty(n, dtype=torch.int32)
    so.host_march(o.data_ptr(), d.data_ptr(), n, params.data_ptr(), *counts,
                  None if bounds is None else bounds.data_ptr(),
                  0 if bounds is None else bounds.shape[0], float(t0), int(max_steps),
                  float(eps), float(t_far), t.data_ptr(), hit.data_ptr(), steps.data_ptr(),
                  tmin.data_ptr())
    return t, hit, steps, tmin


def packet_walk(so, accel, o, d, t_max, any_hit, order=None, t_init=None, counters=None):
    """The host build of the block walk on CPU tensors, with the arguments
    the CUDA wrappers pass (order None: kernel #3, the tree walk over
    `accel.tree`; else #4's walk of the supers in `order`) -> (t, tri,
    hit). counters: an int64 tensor of len(cuda_mt.COUNTERS), added to."""
    n = o.shape[0]
    o, d = o.contiguous(), d.contiguous()  # as the wrappers require
    t = torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    hit = torch.empty(n, dtype=torch.bool)
    so.host_packet_walk(o.data_ptr(), d.data_ptr(),
                        None if t_init is None else t_init.data_ptr(), n,
                        float(min(t_max, 1e10)), accel.corners.data_ptr(),
                        accel.chunk_aabb.data_ptr(), accel.super_aabb.data_ptr(),
                        accel.tree.data_ptr(), None if order is None else order.data_ptr(),
                        accel.super_aabb.shape[0], accel.perm.data_ptr(),
                        accel.perm.shape[0], int(any_hit), t.data_ptr(), tri.data_ptr(),
                        hit.data_ptr(), None if counters is None else counters.data_ptr())
    return t, tri, hit


def _args(scene, cfg, o, d, res, corners, method):
    """The shade kernels' arguments as their CUDA wrapper assembles them
    (cuda_shade.kernel_args), on CPU tensors: (pointers, statics, small)."""
    aux = cuda_shade._make_aux(scene, cfg, method, o, d, res)
    _, small, rays, statics = cuda_shade.kernel_args(scene, cfg, o, d, res, aux, corners,
                                                     method)
    for t in rays:
        assert t is None or t.is_contiguous()
    statics[1] = small.data_ptr()
    return [None if t is None else t.data_ptr() for t in rays], statics, small


def shade_bwd(so, scene, cfg, o, d, res, corners, ct, method):
    """The host build of the shade backward, the parameter sums in float64;
    the result as shade_bwd_torch's."""
    pointers, statics, small = _args(scene, cfg, o, d, res, corners, method)
    n = o.shape[0]
    out = [torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n, 9)]
    d_small = torch.zeros(small.numel(), dtype=torch.float64)
    ct = ct.contiguous()
    so.host_shade_bwd(*pointers, ct.data_ptr(), *statics, *(x.data_ptr() for x in out),
                      d_small.data_ptr())
    got = cuda_shade.unpack_small(d_small.float(), scene)
    got.update(o=out[0], d=out[1], corners=out[2])
    return got


def shade_bwd_blocks(so, scene, cfg, o, d, res, corners, ct, method, sorted_: bool,
                     block: int = 128):
    """The host build of the backward kernel's blocks (host_shade_bwd_blocks)
    -> (d_o, d_d, d_corners, partials (n_blocks, n_par))."""
    pointers, statics, small = _args(scene, cfg, o, d, res, corners, method)
    n = o.shape[0]
    out = [torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n, 9)]
    partials = torch.zeros(-(-n // block), small.numel())
    ct = ct.contiguous()
    so.host_shade_bwd_blocks(*pointers, ct.data_ptr(), *statics, block, int(sorted_),
                             *(x.data_ptr() for x in out), partials.data_ptr())
    return (*out, partials)


def shade_fwd(so, scene, cfg, o, d, res, corners, method):
    """The host build of the shade forward -> (R, 3)."""
    pointers, statics, _small = _args(scene, cfg, o, d, res, corners, method)
    out = torch.zeros(o.shape[0], 3)
    so.host_shade_fwd(*pointers, *statics, out.data_ptr())
    return out


# (scene, an added point light, config overrides, with the SdfScene's under
# "sdf"): the hard-shadow cases hold the static chains, the others add the AO
# taps, the penumbra, the silhouettes and the generic-power Mandelbulb
HOST_CASES = [
    pytest.param("mixed", False, dict(shadow="hard"), id="mixed-False"),
    pytest.param("mixed", True, dict(shadow="hard"), id="mixed-True"),
    pytest.param("sphere", True, dict(shadow="hard"), id="sphere-True"),
    pytest.param("triangles", True, dict(shadow="hard"), id="triangles-True"),
    pytest.param("mandelbulb", False, dict(diff_vis=True), id="mandelbulb-ao-diffvis"),
    pytest.param("pointlight", False, dict(diff_vis=True), id="pointlight-diffvis"),
    pytest.param("mandelbulb", False, dict(diff_vis=True, sdf=dict(mb_pow8=False, mb_power=[7.5])),
                 id="mandelbulb-generic"),
    pytest.param("mixed", False, dict(shadow="hard", ao="sdf5"), id="mixed-ao"),
    pytest.param("sphere", True, dict(shadow="hard", soft_silhouette=0.05),
                 id="sphere-soft-silhouette"),
    pytest.param("triangles", True, dict(shadow="hard", mesh_silhouette=0.06),
                 id="triangles-mesh-silhouette"),
    pytest.param("mixed", False, dict(shadow="hard", soft_silhouette=0.05,
                                      mesh_silhouette=0.05), id="mixed-silhouettes"),
]


_CASES = {}


def case(name, point_light, over, mixed_size=(48, 27)):
    """A HOST_CASES frame (mixed_size for `mixed`, else 24x24, 1 spp):
    (scene, cfg, method, o, d, residuals, corners or None), made once per
    process (the tests only read it)."""
    key = (name, point_light, repr(over), mixed_size)
    if key not in _CASES:
        _CASES[key] = _case(name, point_light, over, mixed_size)
    return _CASES[key]


def _case(name, point_light, over, mixed_size):
    scene, cfg = tscenes.build_scene(name, device="cpu")
    over = dict(over)
    sdf_over = {k: torch.tensor(v) if isinstance(v, list) else v
                for k, v in over.pop("sdf", {}).items()}
    scene = scene.replace(sdf=scene.sdf.replace(**sdf_over))
    if point_light:
        lt = scene.lights
        scene = scene.replace(lights=Lights(lt.direction, lt.color, lt.ambient,
                                            torch.tensor([[0.5, 2.5, 1.0]]),
                                            torch.tensor([[2.0, 1.5, 1.0]])))
    w, h = mixed_size if name == "mixed" else (24, 24)
    cfg = cfg.replace(width=w, height=h, spp=1, block_size=0, **over)
    method = trender.resolve_method(scene, cfg)
    sx, sy = trender.pixel_sample_coords(cfg)
    o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), w, h)
    res = trender.geometry_residuals(scene, cfg, o, d, method)
    corners = None
    if scene.has_mesh:
        rows = tplain.mesh_table(scene.mesh)
        corners = rows[torch.clamp(res["mesh_tri"], 0, rows.shape[0] - 1).long()][:, :9]
        corners = corners.contiguous()
    return scene, cfg, method, o, d, res, corners


SCATTER_MAIN = r"""
#include "corner_scatter.cu"
extern "C" long long host_corner_scatter_scratch(int n, int n_tris) {
  return trcs::scratch_bytes(n, n_tris);
}
extern "C" void host_corner_gather(const float* rows, int n_tris, const int* idx, int n,
                                   float* out) {
  for (long long e = 0; e < 9LL * n; ++e) out[e] = trcs::gather_one(rows, n_tris, idx, e);
}
// tr_corner_scatter with its arguments: the zero fills, then the tile and
// the combine kernels' blocks in turn, each block's threads emulated.
extern "C" void host_corner_scatter(const float* ct, const int* idx, int n, int n_tris,
                                    float* grad, void* scratch, unsigned long long* counters) {
  const trcs::Scratch s = trcs::carve(scratch, n, n_tris);
  memset(grad, 0, sizeof(float) * 10 * static_cast<size_t>(n_tris));
  if (n <= 0) return;
  memset(s.mask, 0, 8 * static_cast<size_t>(s.n_words) * n_tris);
  trcs::TileShared* ts = new trcs::TileShared;
  trcs::TileLane* tl = new trcs::TileLane[trcs::kTileThreads];
  for (int b = 0; b < s.n_tiles; ++b) {
    for (int k = 0; k < trcs::kTileThreads; ++k) tl[k].tid = k;
    trcs::tile_block(b, ct, idx, n, n_tris, s, counters, *ts, tl);
  }
  trcs::CombineShared* cs = new trcs::CombineShared;
  trcs::CombineLane* cl = new trcs::CombineLane[trcs::kCombineThreads];
  const long long rows = static_cast<long long>(s.n_tiles) * trcs::kTile;
  for (int b = 0; static_cast<long long>(b) * trcs::kCombineRows < rows; ++b) {
    for (int k = 0; k < trcs::kCombineThreads; ++k) cl[k].tid = k;
    trcs::combine_block(b, s, grad, counters, *cs, cl);
  }
  delete[] cl;
  delete cs;
  delete[] tl;
  delete ts;
}
"""


def build_scatter(tmp_dir):
    """The corner gather's and scatter's kernels (csrc/corner_scatter.cu)
    built into tmp_dir, or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    (tmp_dir / "scatter_main.cpp").write_text(SCATTER_MAIN)
    lib = tmp_dir / "libscatter_host.so"
    csrc = cuda_shade.__file__.rsplit("/kernels/", 1)[0] + "/csrc"
    subprocess.run([gxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", csrc, "-o", str(lib), str(tmp_dir / "scatter_main.cpp")], check=True,
                   capture_output=True, timeout=180)
    so = ctypes.CDLL(str(lib))
    so.host_corner_scatter_scratch.argtypes = [_I, _I]
    so.host_corner_scatter_scratch.restype = ctypes.c_longlong
    so.host_corner_gather.argtypes = [_P, _I, _P, _I, _P]
    so.host_corner_gather.restype = None
    so.host_corner_scatter.argtypes = [_P, _P, _I, _I, _P, _P, _P]
    so.host_corner_scatter.restype = None
    return so


def corner_gather(so, rows, idx):
    """The host build of the gather on CPU tensors, with the arguments
    cuda_scatter passes -> (R, 9)."""
    rows, idx = rows.contiguous(), idx.to(torch.int32).contiguous()
    out = torch.empty((idx.shape[0], 9))
    so.host_corner_gather(rows.data_ptr(), rows.shape[0], idx.data_ptr(), idx.shape[0],
                          out.data_ptr())
    return out


def corner_scatter(so, ct, idx, n_tris, counters=None):
    """The host build of the scatter on CPU tensors, with the arguments
    cuda_scatter passes -> the (n_tris, 10) gradient. counters: an int64
    tensor of len(cuda_scatter.COUNTERS), added to."""
    from tpu_ray_torch.kernels import cuda_scatter

    ct, idx = ct.contiguous(), idx.to(torch.int32).contiguous()
    n = idx.shape[0]
    grad = torch.empty((n_tris, 10))
    scratch = torch.empty(int(so.host_corner_scatter_scratch(n, n_tris)), dtype=torch.uint8)
    if counters is None:
        counters = torch.zeros(len(cuda_scatter.COUNTERS), dtype=torch.int64)
    so.host_corner_scatter(ct.data_ptr(), idx.data_ptr(), n, n_tris, grad.data_ptr(),
                           scratch.data_ptr(), counters.data_ptr())
    return grad
