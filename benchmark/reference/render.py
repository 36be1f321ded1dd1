"""The benchmark's plain reference renderer: what a frame of the renderer
is, written out in plain PyTorch.

It imports nothing of the program under test and takes nothing that the
program made: the scene arrives as the benchmark's own tensors (by dotted
path, the same paths the program's scene uses), and every derived table
(ray sets, mesh candidates) is worked out here again.

The arithmetic is a frozen copy of the renderer's plain float path as it
stood at commit c4adc4a (tpu_ray_torch/render/camera.py:38-53,
sdf/primitives.py:74-172, sdf/mandelbulb.py:18-99, kernels/cuda_sdf.py:48-
163, kernels/sphere_trace.py:50-115, kernels/moller_trumbore.py:30-85,
render/render.py:238-332 and 491-545, render/shading.py:47-128), in its op
order, so that float32 rounds alike. Two things differ in how, not in
what, is computed:

  * marches compact their live rays every step (a ray's march is its own);
  * the mesh closest hit and any-hit test only the (ray, triangle) pairs
    whose 2D projections can overlap: rays sharing an origin project
    through it (a pinhole), parallel rays along their direction; each
    triangle's projected box, padded, is binned over a grid of the rays.
    Triangles that reach behind the eye or span many cells are tested
    against every ray. The tests are the brute-force oracle's, and a pair
    that is never tested cannot hit.

Silhouette bands, point lights and the AO's mesh term are not part of any
configuration the benchmark runs; a configuration that asks for them is
refused here.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

BIG = 1e10
_EPS = 1e-12
_DET_EPS = 1e-10
_T_MIN = 1e-5
_DENOM_MIN = 1e-6
_BAILOUT = 4.0
_RMIN = 1e-6
SDF_FIELDS = ("sph_center", "sph_radius", "pln_normal", "pln_offset", "box_center",
              "box_half", "box_round", "mb_center", "mb_scale", "mb_power")
# (ray, triangle) pairs tested at a time; rays a geometry pass and a
# differentiable shade take at a time (the shade's autograd graph of the
# Mandelbulb's normal and AO taps holds ~10 KB a ray in float32)
PAIRS = 1 << 23
GEOMETRY_RAYS = 1 << 22
SHADE_RAYS = 1 << 20


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(a):
    return a / torch.sqrt(torch.clamp_min(dot(a, a), _EPS))[..., None]


def clamp01(x):
    return torch.clamp(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the scene: tensors by dotted path
# ---------------------------------------------------------------------------

class Scene:
    """The scene's tensors by dotted path ("camera.origin", "sdf.mb_scale",
    "mesh.verts", ...) and the two static fields of the distance field."""

    def __init__(self, arrays: dict, mb_iters: int, mb_pow8: bool):
        self.a = dict(arrays)
        self.mb_iters, self.mb_pow8 = int(mb_iters), bool(mb_pow8)

    def __getitem__(self, path):
        return self.a[path]

    def replace(self, values: dict) -> "Scene":
        return Scene({**self.a, **values}, self.mb_iters, self.mb_pow8)

    def n(self, path) -> int:
        return self.a[path].shape[0]

    @property
    def has_sdf(self) -> bool:
        return sum(self.n(f"sdf.{k}") for k in ("sph_center", "pln_normal", "box_center",
                                                   "mb_center")) > 0

    @property
    def has_mesh(self) -> bool:
        return self.n("mesh.tris") > 0

    def sdf_leaves(self):
        return [self.a[f"sdf.{f}"] for f in SDF_FIELDS]


def check_supported(cfg: dict, scene: Scene) -> None:
    """Refuse what this reference does not compute."""
    if cfg.get("soft_silhouette", 0.0) > 0 or cfg.get("mesh_silhouette", 0.0) > 0:
        raise NotImplementedError("silhouette bands")
    if scene.n("lights.position"):
        raise NotImplementedError("point lights")
    if cfg["ao"] == "sdf5" and _use_mesh(scene, cfg):
        raise NotImplementedError("the AO's mesh term")
    if cfg["method"] not in ("sdf", "mesh_grid", "mesh_brute", "mixed"):
        raise NotImplementedError(f"method {cfg['method']!r}")


def _use_sdf(scene, cfg) -> bool:
    return cfg["method"] in ("sdf", "mixed") and scene.has_sdf


def _use_mesh(scene, cfg) -> bool:
    return cfg["method"] in ("mesh_brute", "mesh_grid", "mixed") and scene.has_mesh


# ---------------------------------------------------------------------------
# samples and rays
# ---------------------------------------------------------------------------

def sample_xy(cfg: dict, pix: torch.Tensor, dtype):
    """The stratified samples of row-major pixels `pix` -> flat (xs, ys), a
    pixel's spp samples contiguous (x varies fastest over the strata)."""
    k = int(round(math.sqrt(cfg["spp"])))
    centers = (torch.arange(k, dtype=dtype, device=pix.device) + 0.5) / k
    ox = centers.repeat(k)
    oy = centers.repeat_interleave(k)
    px = (pix % cfg["width"]).to(dtype)
    py = (pix // cfg["width"]).to(dtype)
    return (px[:, None] + ox).reshape(-1), (py[:, None] + oy).reshape(-1)


def generate_rays(scene: Scene, xs, ys, width: int, height: int):
    origin, look_at, up = scene["camera.origin"], scene["camera.look_at"], scene["camera.up"]
    fwd = normalize(look_at - origin)
    right = normalize(cross(fwd, up))
    up2 = cross(right, fwd)
    half_h = torch.tan(torch.deg2rad(scene["camera.vfov_deg"]) * 0.5)
    aspect = width / height
    px = (2.0 * xs / width - 1.0) * half_h * aspect
    py = (1.0 - 2.0 * ys / height) * half_h
    d = normalize(fwd + px[..., None] * right + py[..., None] * up2)
    return origin.expand(d.shape).contiguous(), d


# ---------------------------------------------------------------------------
# the distance field
# ---------------------------------------------------------------------------

def _mandelbulb_pow8(px, py, pz, iters: int):
    r = torch.sqrt(torch.clamp_min(px * px + py * py + pz * pz, _RMIN * _RMIN))
    zx, zy, zz = px, py, pz
    dr = torch.ones_like(px)
    live = torch.ones_like(px, dtype=torch.bool)
    for _ in range(iters):
        r_new = torch.sqrt(torch.clamp_min(zx * zx + zy * zy + zz * zz, _RMIN * _RMIN))
        r = torch.where(live, r_new, r)
        live = live & (r_new <= _BAILOUT)
        r_safe = torch.clamp(r_new, _RMIN, _BAILOUT)
        rho2 = torch.clamp_min(zx * zx + zy * zy, _RMIN * _RMIN)
        rho = torch.sqrt(rho2)
        h = torch.sqrt(rho2 + zz * zz)
        inv_h = 1.0 / h
        st, ct = rho * inv_h, zz * inv_h
        inv_rho = 1.0 / rho
        sp, cp = zy * inv_rho, zx * inv_rho
        for _ in range(3):
            st, ct = 2.0 * st * ct, ct * ct - st * st
            sp, cp = 2.0 * sp * cp, cp * cp - sp * sp
        r2s = r_safe * r_safe
        r4 = r2s * r2s
        r7 = r4 * r2s * r_safe
        r8 = r4 * r4
        dr_new = 8.0 * r7 * dr + 1.0
        nzx = r8 * st * cp + px
        nzy = r8 * st * sp + py
        nzz = r8 * ct + pz
        zx = torch.where(live, nzx, zx)
        zy = torch.where(live, nzy, zy)
        zz = torch.where(live, nzz, zz)
        dr = torch.where(live, dr_new, dr)
    r = torch.clamp_min(r, _RMIN)
    return 0.5 * torch.log(r) * r / dr


def _mandelbulb_generic(p, power, iters: int):
    power = power.expand(p.shape[:-1])
    z = p
    dr = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    r = torch.sqrt(torch.clamp_min(torch.sum(p * p, dim=-1), _RMIN * _RMIN))
    live = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for _ in range(iters):
        r_new = torch.sqrt(torch.clamp_min(torch.sum(z * z, dim=-1), _RMIN * _RMIN))
        r = torch.where(live, r_new, r)
        live = live & (r_new <= _BAILOUT)
        r_safe = torch.clamp(r_new, _RMIN, _BAILOUT)
        rho = torch.sqrt(torch.clamp_min(z[..., 0] ** 2 + z[..., 1] ** 2, _RMIN * _RMIN))
        theta = torch.atan2(rho, z[..., 2])
        phi = torch.atan2(z[..., 1], z[..., 0])
        r_pm1 = torch.pow(r_safe, power - 1.0)
        dr_new = r_pm1 * power * dr + 1.0
        zr = r_pm1 * r_safe
        th, ph = theta * power, phi * power
        sin_th = torch.sin(th)
        z_next = zr[..., None] * torch.stack(
            [sin_th * torch.cos(ph), torch.sin(ph) * sin_th, torch.cos(th)], dim=-1) + p
        z = torch.where(live[..., None], z_next, z)
        dr = torch.where(live, dr_new, dr)
    r = torch.clamp_min(r, _RMIN)
    return 0.5 * torch.log(r) * r / dr


def _distances(scene: Scene, leaves, p):
    """(..., N) distances of the primitives in the order spheres, planes,
    boxes, bulbs, and their (N,) material ids."""
    f = dict(zip(SDF_FIELDS, leaves))
    px, py, pz = p[..., None, 0], p[..., None, 1], p[..., None, 2]
    parts, mats = [], []
    if f["sph_center"].shape[0]:
        c = f["sph_center"]
        qx, qy, qz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
        parts.append(torch.sqrt(torch.clamp_min(qx * qx + qy * qy + qz * qz, 1e-12))
                     - f["sph_radius"])
        mats.append(scene["sdf.sph_mat"])
    if f["pln_normal"].shape[0]:
        n = f["pln_normal"]
        parts.append(px * n[:, 0] + py * n[:, 1] + pz * n[:, 2] - f["pln_offset"])
        mats.append(scene["sdf.pln_mat"])
    if f["box_center"].shape[0]:
        c, h = f["box_center"], f["box_half"]
        qx = torch.abs(px - c[:, 0]) - h[:, 0]
        qy = torch.abs(py - c[:, 1]) - h[:, 1]
        qz = torch.abs(pz - c[:, 2]) - h[:, 2]
        ox, oy, oz = (torch.clamp_min(q, 0.0) for q in (qx, qy, qz))
        outside = torch.sqrt(torch.clamp_min(ox * ox + oy * oy + oz * oz, 1e-12))
        inside = torch.clamp_max(torch.maximum(torch.maximum(qx, qy), qz), 0.0)
        parts.append(outside + inside - f["box_round"])
        mats.append(scene["sdf.box_mat"])
    if f["mb_center"].shape[0]:
        c, s = f["mb_center"], f["mb_scale"]
        lx, ly, lz = (px - c[:, 0]) / s, (py - c[:, 1]) / s, (pz - c[:, 2]) / s
        if scene.mb_pow8:
            dd = _mandelbulb_pow8(lx, ly, lz, scene.mb_iters)
        else:
            dd = _mandelbulb_generic(torch.stack([lx, ly, lz], dim=-1), f["mb_power"],
                                     scene.mb_iters)
        parts.append(dd * s)
        mats.append(scene["sdf.mb_mat"])
    return torch.cat(parts, dim=-1), torch.cat(mats)


def sdf_distance(scene: Scene, p, leaves=None):
    return torch.amin(_distances(scene, leaves or scene.sdf_leaves(), p)[0], dim=-1)


def sdf_material(scene: Scene, p):
    d, mats = _distances(scene, scene.sdf_leaves(), p)
    return mats[torch.argmin(d, dim=-1)]


def bounding_spheres(scene: Scene):
    """(K, 4) [c, r] over the finite primitives, None with a plane."""
    if scene.n("sdf.pln_normal"):
        return None
    rows = []
    if scene.n("sdf.sph_center"):
        rows.append(torch.cat([scene["sdf.sph_center"], scene["sdf.sph_radius"][:, None]], 1))
    if scene.n("sdf.box_center"):
        h = scene["sdf.box_half"]
        r = (torch.sqrt(torch.clamp_min(h[:, 0] * h[:, 0] + h[:, 1] * h[:, 1]
                                        + h[:, 2] * h[:, 2], 1e-12)) + scene["sdf.box_round"])
        rows.append(torch.cat([scene["sdf.box_center"], r[:, None]], 1))
    if scene.n("sdf.mb_center"):
        rows.append(torch.cat([scene["sdf.mb_center"], 1.5 * scene["sdf.mb_scale"][:, None]], 1))
    return torch.cat(rows, 0) if rows else None


def _bound_terms(bounds, o, d, inflate: float):
    ox, oy, oz = o[:, None, 0], o[:, None, 1], o[:, None, 2]
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    r = bounds[:, 3] + inflate
    ocx, ocy, ocz = ox - bounds[:, 0], oy - bounds[:, 1], oz - bounds[:, 2]
    b = ocx * dx + ocy * dy + ocz * dz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    return b, b * b - c2


# ---------------------------------------------------------------------------
# marches (no gradient); each ray's march is its own, so the live rays are
# compacted at every step
# ---------------------------------------------------------------------------

@torch.no_grad()
def march(scene: Scene, o, d, *, max_steps: int, eps: float, t_far: float,
          bound_pad: float, visit=None):
    """Primary sphere trace -> (t, hit, steps, tmin). visit(points): called
    each step with the points whose distance the step evaluates."""
    R = o.shape[0]
    t = torch.zeros((R,), dtype=o.dtype, device=o.device)
    tmin = t.clone()
    bounds = bounding_spheres(scene)
    if bounds is not None:
        b, disc = _bound_terms(bounds, o, d, bound_pad)
        reach = ((disc >= 0.0) & (torch.sqrt(torch.clamp_min(disc, 0.0)) - b > 0.0)).any(1)
        t = torch.where(reach, t, torch.full_like(t, t_far))
    hit = torch.zeros((R,), dtype=torch.bool, device=o.device)
    steps = torch.zeros((R,), dtype=torch.int32, device=o.device)
    idx = torch.nonzero(t < t_far)[:, 0]
    tt, dm, tm = t[idx], torch.full((idx.shape[0],), 1e10, dtype=o.dtype, device=o.device), tmin[idx]
    st = torch.zeros_like(idx, dtype=torch.int32)
    for _ in range(max_steps):
        if idx.shape[0] == 0:
            break
        q = o[idx] + tt[:, None] * d[idx]
        if visit is not None:
            visit(q)
        dist = sdf_distance(scene, q)
        closer = dist < dm
        dm = torch.where(closer, dist, dm)
        tm = torch.where(closer, tt, tm)
        hit_now = dist < eps
        tt = torch.where(~hit_now, tt + dist, tt)
        st = st + 1
        done = hit_now | ~(tt < t_far)
        if bool(done.any()):
            di = idx[done]
            t[di], tmin[di], steps[di], hit[di] = tt[done], tm[done], st[done], hit_now[done]
            keep = ~done
            idx, tt, dm, tm, st = idx[keep], tt[keep], dm[keep], tm[keep], st[keep]
    t[idx], tmin[idx], steps[idx] = tt, tm, st
    return t, hit, steps, tmin


@torch.no_grad()
def shadow_hard(scene: Scene, p, l_dir, *, eps: float, t_far_rays, steps: int, bias: float):
    """0/1 visibility toward l_dir -> (R,)."""
    tf = t_far_rays
    bounds = bounding_spheres(scene)
    if bounds is not None:
        b, disc = _bound_terms(bounds, p, l_dir, eps)
        texit = torch.sqrt(torch.clamp_min(disc, 0.0)) - b
        t_cut = torch.where(disc >= 0.0, texit, torch.zeros_like(texit))
        tf = torch.minimum(tf, torch.clamp_min(t_cut.amax(1), 0.0))
    R = p.shape[0]
    blocked = torch.zeros((R,), dtype=torch.bool, device=p.device)
    t = torch.full((R,), float(bias), dtype=p.dtype, device=p.device)
    idx = torch.nonzero(t < tf)[:, 0]
    tt, tfi = t[idx], tf[idx]
    for _ in range(steps):
        if idx.shape[0] == 0:
            break
        dd = sdf_distance(scene, p[idx] + tt[:, None] * l_dir[idx])
        hit_now = dd < eps
        tt = tt + torch.clamp_min(dd, eps * 0.5)
        blocked[idx[hit_now]] = True
        keep = ~hit_now & (tt < tfi)
        idx, tt, tfi = idx[keep], tt[keep], tfi[keep]
    return 1.0 - blocked.to(p.dtype)


@torch.no_grad()
def shadow_soft(scene: Scene, p, l_dir, *, eps: float, t_far_rays, steps: int, bias: float,
                soft_k: float):
    """Penumbra visibility and the t of its minimum -> (vis, ts)."""
    R = p.shape[0]
    t = torch.full((R,), float(bias), dtype=p.dtype, device=p.device)
    s = torch.ones_like(t)
    ts = t.clone()
    idx = torch.nonzero(t < t_far_rays)[:, 0]
    tt, si, tsi, tfi = t[idx], s[idx], ts[idx], t_far_rays[idx]
    for _ in range(steps):
        if idx.shape[0] == 0:
            break
        dd = sdf_distance(scene, p[idx] + tt[:, None] * l_dir[idx])
        s_new = soft_k * dd / torch.clamp_min(tt, bias)
        better = s_new < si
        tsi = torch.where(better, tt, tsi)
        si = torch.where(better, s_new, si)
        tt = tt + torch.clamp(dd, eps * 0.5, 0.4)
        done = ~(tt < tfi)
        if bool(done.any()):
            s[idx[done]], ts[idx[done]] = si[done], tsi[done]
            keep = ~done
            idx, tt, si, tsi, tfi = idx[keep], tt[keep], si[keep], tsi[keep], tfi[keep]
    s[idx], ts[idx] = si, tsi
    return torch.clamp(s, 0.0, 1.0), ts


# ---------------------------------------------------------------------------
# the mesh: Moller-Trumbore over the pairs whose projections can overlap
# ---------------------------------------------------------------------------

def _mt_t(o, d, v0, v1, v2, t_max):
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _T_MIN) & (t < t_max)
    return t, valid


def _basis(axis):
    a = normalize(axis.double())
    helper = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    if abs(float(a[0])) > 0.9:
        helper = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    e1 = normalize(cross(a, helper))
    return a, e1, cross(a, e1)


def _project(verts, o, d, eye):
    """2D keys of the rays and of the vertices, and which vertices are
    usable: through `eye` when the rays share it (perspective), else along
    the rays' common direction (parallel)."""
    if eye is not None:
        f, e1, e2 = _basis(d.double().mean(0))
        dd = d.double()
        z = dot(dd, f.expand_as(dd))
        if float(z.min()) <= 0.05:
            return None
        ray_uv = torch.stack([dot(dd, e1.expand_as(dd)) / z, dot(dd, e2.expand_as(dd)) / z], 1)
        v = verts.double() - eye.double()
        vz = dot(v, f.expand_as(v))
        front = vz > 1e-6
        vz = torch.where(front, vz, torch.ones_like(vz))
        vert_uv = torch.stack([dot(v, e1.expand_as(v)) / vz, dot(v, e2.expand_as(v)) / vz], 1)
        return ray_uv, vert_uv, front
    f, e1, e2 = _basis(d[0])
    oo, v = o.double(), verts.double()
    ray_uv = torch.stack([dot(oo, e1.expand_as(oo)), dot(oo, e2.expand_as(oo))], 1)
    vert_uv = torch.stack([dot(v, e1.expand_as(v)), dot(v, e2.expand_as(v))], 1)
    return ray_uv, vert_uv, torch.ones(v.shape[0], dtype=torch.bool, device=v.device)


def _pair_tests(o, d, v0, v1, v2, t_max, rays, tris, any_hit, best):
    """Fold the tests of pairs (rays[i], tris[i]) into best: per ray the
    packed (t bits, triangle) key of its closest hit (amin), or its
    blocked flag (amax) for any_hit."""
    for s in range(0, rays.shape[0], PAIRS):
        r, k = rays[s:s + PAIRS], tris[s:s + PAIRS]
        t, valid = _mt_t(o[r], d[r], v0[k], v1[k], v2[k], t_max)
        if any_hit:
            best.scatter_reduce_(0, r, valid.to(torch.int64), "amax")
        else:
            key = (t.float().view(torch.int32).to(torch.int64) << 32) | k
            key = torch.where(valid, key, torch.full_like(key, torch.iinfo(torch.int64).max))
            best.scatter_reduce_(0, r, key, "amin")


@torch.no_grad()
def mesh_hits(verts, tris, o, d, t_max: float, any_hit: bool, eye=None, max_span: int = 16):
    """Closest hit (tri int64, -1 on a miss; hit) or any-hit (blocked) of
    rays o, d against the mesh within t_max. eye: the rays' shared origin,
    or None for rays along one direction."""
    R, dev = o.shape[0], o.device
    tri_l = tris.long()
    v0, v1, v2 = verts[tri_l[:, 0]], verts[tri_l[:, 1]], verts[tri_l[:, 2]]
    T = tri_l.shape[0]
    best = (torch.zeros(R, dtype=torch.int64, device=dev) if any_hit else
            torch.full((R,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev))
    proj = _project(verts, o, d, eye) if R else None
    big = torch.ones(T, dtype=torch.bool, device=dev)
    if proj is not None:
        ray_uv, vert_uv, front = proj
        tri_uv = vert_uv[tri_l]  # (T, 3, 2)
        lo, hi = tri_uv.amin(1), tri_uv.amax(1)
        in_front = front[tri_l].all(1)
        r_lo, r_hi = ray_uv.amin(0), ray_uv.amax(0)
        ext = float((r_hi - r_lo).max()) + 1e-9
        span = (hi - lo).amax(1)
        usable = in_front & (span < ext)
        cell = float(span[usable].median()) if bool(usable.any()) else ext
        cell = max(cell, ext / 4096.0)
        pad = 1e-4 * cell + 1e-6 * ext
        ncx = int((float(r_hi[0] - r_lo[0]) + 2 * pad) / cell) + 1
        ncy = int((float(r_hi[1] - r_lo[1]) + 2 * pad) / cell) + 1
        rc = torch.floor((ray_uv - r_lo + pad) / cell).long()
        rkey = rc[:, 1] * ncx + rc[:, 0]
        rkey, order = torch.sort(rkey)
        c_lo = torch.floor((lo - pad - r_lo + pad) / cell).long()
        c_hi = torch.floor((hi + pad - r_lo + pad) / cell).long()
        c_lo[:, 0].clamp_(min=0)
        c_lo[:, 1].clamp_(min=0)
        c_hi[:, 0].clamp_(max=ncx - 1)
        c_hi[:, 1].clamp_(max=ncy - 1)
        wide = (c_hi - c_lo + 1).amax(1) > max_span
        big = ~in_front | wide
        live = ~big & (c_hi[:, 0] >= c_lo[:, 0]) & (c_hi[:, 1] >= c_lo[:, 1])
        tid = torch.nonzero(live)[:, 0]
        for s in range(0, tid.shape[0], 1 << 16):
            k = tid[s:s + (1 << 16)]
            w = c_hi[k, 0] - c_lo[k, 0] + 1
            n = w * (c_hi[k, 1] - c_lo[k, 1] + 1)
            rep = torch.repeat_interleave(torch.arange(k.shape[0], device=dev), n)
            off = torch.cumsum(n, 0) - n
            local = torch.arange(rep.shape[0], device=dev) - off[rep]
            cx = c_lo[k, 0][rep] + local % w[rep]
            cy = c_lo[k, 1][rep] + local // w[rep]
            ck = cy * ncx + cx
            a = torch.searchsorted(rkey, ck, right=False)
            b = torch.searchsorted(rkey, ck, right=True)
            cnt = b - a
            rep2 = torch.repeat_interleave(torch.arange(ck.shape[0], device=dev), cnt)
            off2 = torch.cumsum(cnt, 0) - cnt
            pos = a[rep2] + torch.arange(rep2.shape[0], device=dev) - off2[rep2]
            _pair_tests(o, d, v0, v1, v2, t_max, order[pos], k[rep][rep2], any_hit, best)
    bid = torch.nonzero(big)[:, 0]
    if bid.shape[0]:
        per = max(1, PAIRS // max(R, 1))
        for s in range(0, bid.shape[0], per):
            k = bid[s:s + per]
            rays = torch.arange(R, device=dev).repeat(k.shape[0])
            _pair_tests(o, d, v0, v1, v2, t_max, rays, k.repeat_interleave(R), any_hit, best)
    if any_hit:
        return best > 0
    hit = best < torch.iinfo(torch.int64).max
    tri = torch.where(hit, best & 0xFFFFFFFF, torch.full_like(best, -1))
    return tri, hit


def recompute_hit_corners(v0, v1, v2, o, d):
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    det_safe = torch.where(torch.abs(det) > _DET_EPS, det,
                           torch.where(det >= 0, _DET_EPS, -_DET_EPS).to(det.dtype))
    inv_det = 1.0 / det_safe
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, u, v, normalize(cross(e1, e2))


# ---------------------------------------------------------------------------
# the SDF hit's gradient (implicit function) and normal
# ---------------------------------------------------------------------------

class _Ift(torch.autograd.Function):
    """t = _Ift.apply(scene, t_bar, hit_f, o, d, *sdf leaves): the march's t
    with the implicit-function gradient at p = o + t_bar d."""

    @staticmethod
    def forward(ctx, scene, t_bar, hit_f, o, d, *leaves):
        ctx.scene = scene
        ctx.save_for_backward(t_bar, hit_f, o, d, *leaves)
        return t_bar.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_t):
        t_bar, hit_f, o, d, *leaves = ctx.saved_tensors
        scene, want = ctx.scene, ctx.needs_input_grad
        with torch.enable_grad():
            fixed = [x.detach() for x in leaves]
            p = (o + t_bar[..., None] * d).detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sdf_distance(scene, p, fixed).sum(), p)
            denom = dot(g, d)
            denom_safe = torch.where(
                torch.abs(denom) < _DENOM_MIN,
                torch.where(denom < 0, -_DENOM_MIN, _DENOM_MIN).to(denom.dtype), denom)
            scale = torch.where(hit_f > 0.5, -ct_t / denom_safe, torch.zeros_like(ct_t))
            args = [x.detach().requires_grad_(bool(w and x.numel()))
                    for x, w in zip((o, d, *leaves), want[3:])]
            o_, d_, lv = args[0], args[1], args[2:]
            value = sdf_distance(scene, o_ + t_bar[..., None] * d_, lv)
            inputs = [x for x in args if x.requires_grad]
            got = iter(torch.autograd.grad(value, inputs, grad_outputs=scale,
                                           allow_unused=True) if inputs else ())
            out = [next(got) if x.requires_grad else None for x in args]
        return (None, None, None, *out)


def surface_normal(scene: Scene, p, create_graph: bool):
    with torch.enable_grad():
        pp = p if create_graph else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_distance(scene, pp).sum(), pp, create_graph=create_graph)
    n2 = torch.sum(g * g, dim=-1, keepdim=True)
    return g / torch.sqrt(torch.clamp_min(n2, 1e-12))


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def _background(scene: Scene, d):
    s = 0.5 * (d[..., 1] + 1.0)
    return scene["bg_bottom"] + (scene["bg_top"] - scene["bg_bottom"]) * s[..., None]


def _corners(scene: Scene, tri):
    t = scene["mesh.tris"].long()[tri]
    v = scene["mesh.verts"]
    return v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]


@torch.no_grad()
def geometry(scene: Scene, cfg: dict, o, d) -> dict:
    """The no-gradient pass over rays o, d: which surface each ray meets,
    and its shadow visibility and penumbra argmin per light."""
    R = o.shape[0]
    g = {"sdf": torch.zeros(R, dtype=torch.bool, device=o.device),
         "mesh": torch.zeros(R, dtype=torch.bool, device=o.device)}
    use_sdf, use_mesh = _use_sdf(scene, cfg), _use_mesh(scene, cfg)
    t_s = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    t_m = t_s.clone()
    p = torch.zeros_like(o)
    n = torch.zeros_like(o)
    if use_sdf:
        t, hit, _steps, _tmin = march(scene, o, d, max_steps=cfg["max_steps"], eps=cfg["eps"],
                                      t_far=cfg["t_far"], bound_pad=cfg["eps"])
        g["t_bar"], g["sdf_hit"] = t, hit
        t_s = torch.where(hit, t, t_s)
    if use_mesh:
        tri, mhit = mesh_hits(scene["mesh.verts"], scene["mesh.tris"], o, d, cfg["t_far"],
                              any_hit=False, eye=o[0])
        g["tri"], g["mesh_hit"] = tri, mhit
        idx = torch.clamp(tri, 0, scene.n("mesh.tris") - 1)
        tm, _u, _v, nm = recompute_hit_corners(*_corners(scene, idx), o, d)
        t_m = torch.where(mhit, tm, t_m)
    sdf_closer = t_s <= t_m
    g["sdf"] = sdf_closer & (g["sdf_hit"] if use_sdf else g["sdf"])
    g["mesh"] = ~sdf_closer & (g["mesh_hit"] if use_mesh else g["mesh"])
    live = g["sdf"] | g["mesh"]
    if cfg["shadow"] == "none":
        return g
    if use_sdf and bool(g["sdf"].any()):
        i = torch.nonzero(g["sdf"])[:, 0]
        ps = o[i] + g["t_bar"][i, None] * d[i]
        p[i], n[i] = ps, surface_normal(scene, ps, create_graph=False)
    if use_mesh and bool(g["mesh"].any()):
        i = torch.nonzero(g["mesh"])[:, 0]
        p[i], n[i] = o[i] + t_m[i, None] * d[i], nm[i]
    n = torch.where(dot(n, d)[..., None] > 0.0, -n, n)
    p_off = torch.where(live[:, None], p + cfg["shadow_bias"] * n, o)
    t_far_rays = torch.where(live, cfg["t_far"], 0.0).to(o.dtype)
    vis_rows, ts_rows = [], []
    soft = cfg["shadow"] == "soft"
    soft_diff = soft and cfg["diff_vis"] and use_sdf
    for li in range(scene.n("lights.direction")):
        l_dir = normalize(scene["lights.direction"][li]).expand_as(p_off).contiguous()
        vis = torch.ones((R,), dtype=o.dtype, device=o.device)
        ts = torch.full((R,), cfg["shadow_bias"], dtype=o.dtype, device=o.device)
        if use_sdf:
            if soft:
                v, ts_m = shadow_soft(scene, p_off, l_dir, eps=cfg["eps"], t_far_rays=t_far_rays,
                                      steps=cfg["shadow_steps"], bias=cfg["shadow_bias"],
                                      soft_k=cfg["soft_k"])
            else:
                v = shadow_hard(scene, p_off, l_dir, eps=cfg["eps"], t_far_rays=t_far_rays,
                                steps=cfg["shadow_steps"], bias=cfg["shadow_bias"])
                ts_m = ts
            if soft_diff:
                ts = ts_m
            else:
                vis = vis * v
        if use_mesh:
            blocked = torch.zeros((R,), dtype=torch.bool, device=o.device)
            i = torch.nonzero(live)[:, 0]
            blocked[i] = mesh_hits(scene["mesh.verts"], scene["mesh.tris"], p_off[i], l_dir[i],
                                   cfg["t_far"], any_hit=True)
            vis = vis * (1.0 - blocked.to(o.dtype))
        vis_rows.append(vis)
        ts_rows.append(ts)
    g["sh_vis"] = torch.stack(vis_rows)
    if soft_diff:
        g["sh_ts"] = torch.stack(ts_rows)
    return g


def _shade(scene: Scene, cfg: dict, g: dict, i, p, n, d, mat):
    """Colours of the hit rays i (their points, normals, directions and
    materials) from the geometry pass's visibility."""
    albedo = scene["materials.albedo"][mat.long()]
    n = torch.where(dot(n, d)[..., None] > 0.0, -n, n)
    if cfg["ao"] == "sdf5" and scene.has_sdf:
        occ = torch.zeros_like(p[..., 0])
        w = 1.0
        for k in range(1, 6):
            h = cfg["ao_step"] * k
            occ = occ + w * (h - sdf_distance(scene, p + h * n))
            w *= 0.7
        ao = clamp01(1.0 - cfg["ao_strength"] * occ)
    else:
        ao = torch.ones_like(p[..., 0])
    radiance = scene["lights.ambient"] * ao[..., None]
    soft_diff = "sh_ts" in g
    for li in range(scene.n("lights.direction")):
        l_dir = normalize(scene["lights.direction"][li])
        ndotl = torch.clamp_min(dot(n, l_dir.expand_as(n)), 0.0)
        vis = g["sh_vis"][li][i] if "sh_vis" in g else torch.ones_like(ndotl)
        if soft_diff:
            ts = g["sh_ts"][li][i]
            p_off = p + cfg["shadow_bias"] * n
            dd = sdf_distance(scene, p_off + ts[..., None] * l_dir.expand_as(p))
            vis = vis * clamp01(cfg["soft_k"] * dd / torch.clamp_min(ts, cfg["shadow_bias"]))
        if not cfg["diff_vis"]:
            vis = vis.detach()
        radiance = radiance + scene["lights.color"][li] * (ndotl * vis)[..., None]
    color = albedo * radiance
    bg = _background(scene, d)
    return bg + 1.0 * (color - bg)


def shade(scene: Scene, cfg: dict, g: dict, o, d):
    """(R, 3) sample colours from the geometry pass, differentiable with
    respect to the scene's tensors that require grad: the SDF hit through
    the implicit function, its normal through autograd of the distance
    field, the mesh hit re-solved from its triangle's corners."""
    out = _background(scene, d)
    if bool(g["sdf"].any()):
        i = torch.nonzero(g["sdf"])[:, 0]
        oi, di = o[i], d[i]
        t = _Ift.apply(scene, g["t_bar"][i], torch.ones_like(g["t_bar"][i]), oi, di,
                       *scene.sdf_leaves())
        p = oi + t[..., None] * di
        n = surface_normal(scene, p, create_graph=p.requires_grad)
        mat = sdf_material(scene, p.detach())
        out = out.index_put((i,), _shade(scene, cfg, g, i, p, n, di, mat))
    if bool(g["mesh"].any()):
        i = torch.nonzero(g["mesh"])[:, 0]
        oi, di = o[i], d[i]
        tri = g["tri"][i]
        t, _u, _v, n = recompute_hit_corners(*_corners(scene, tri), oi, di)
        p = oi + t[..., None] * di
        mat = scene["mesh.tri_mat"][tri]
        out = out.index_put((i,), _shade(scene, cfg, g, i, p, n, di, mat))
    return out


def render_pixels(scene: Scene, cfg: dict, pix, each=None):
    """The spp-averaged colours of row-major pixels pix: rays, the geometry
    pass (GEOMETRY_RAYS at a time), the shade (SHADE_RAYS at a time,
    differentiable where the scene's tensors require grad). Without
    `each`, -> (P, 3); with it, each(pixels, their (n, 3) colours) is
    called for every piece in turn (a fit differentiates one piece at a
    time) and the sum of what it returns comes back."""
    dtype = scene["camera.origin"].dtype
    spp = cfg["spp"]
    out, total = [], 0.0
    for c in range(0, pix.shape[0], max(1, GEOMETRY_RAYS // spp)):
        p_geo = pix[c:c + max(1, GEOMETRY_RAYS // spp)]
        xs, ys = sample_xy(cfg, p_geo, dtype)
        with torch.no_grad():
            o, d = generate_rays(scene, xs, ys, cfg["width"], cfg["height"])
            g = geometry(scene, cfg, o, d)
        step = max(1, SHADE_RAYS // spp)
        for s in range(0, p_geo.shape[0], step):
            a, b = s * spp, min(s + step, p_geo.shape[0]) * spp
            o_s, d_s = generate_rays(scene, xs[a:b], ys[a:b], cfg["width"], cfg["height"])
            sub = {k: (v[:, a:b] if k in ("sh_vis", "sh_ts") else v[a:b]) for k, v in g.items()}
            colors = shade(scene, cfg, sub, o_s, d_s).reshape(-1, spp, 3).mean(1)
            if each is None:
                out.append(colors)
            else:
                total += each(p_geo[s:s + step], colors)
    return torch.cat(out) if each is None else total
