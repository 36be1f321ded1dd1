"""The hit reconstruction and the shade composition as plain PyTorch: the
CPU path and the reference of the reconstruct and shade kernels.

Counterpart of the reconstruct and shade half of `tpu_ray/render/render.py`
(`_sdf_from_res`, `_mesh_from_res`, its hit reconstruction and `_shade_xla`).
`reconstruct_plain` rebuilds hit state from the geometry pass's per-ray
residuals (the SDF hit t by the IFT attach, the normal by autograd of the
distance field, the mesh hit by re-solving the selected triangle), with
the soft SDF silhouette and the mesh edge band as coverage; `lite` gives
the values only. `shadow_ray_origins_plain` adds the shadow rays' origins
(a `Recon`, what `cuda_reconstruct.reconstruct` gives in one launch), and
`shade_plain` shades a block from its residuals, differentiably. Both
render.render and the kernel wrappers (`cuda_reconstruct`, `cuda_shade`)
import this module; it imports no wrapper.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_ray_torch.core.math3d import clamp01, dot
from tpu_ray_torch.kernels import moller_trumbore as mt
from tpu_ray_torch.kernels.moller_trumbore import BIG
from tpu_ray_torch.kernels.sphere_trace import IftAttach, surface_normal
from tpu_ray_torch.render import shading
from tpu_ray_torch.render.chain import Chain, frame_chain
from tpu_ray_torch.scene.types import Scene
from tpu_ray_torch.sdf.primitives import sdf_distance, sdf_distance_and_mat
from tpu_ray_torch.utils.config import RenderConfig


class Recon(NamedTuple):
    """One ray block's values-only reconstruct."""
    hits: tuple                      # (t, hit, p, n, mat, cov), as reconstruct_plain's
    closer: Optional[torch.Tensor]   # the mixed closest-select mask, else None
    nf: torch.Tensor                 # the ray-facing normal
    p_off: torch.Tensor              # the shadow rays' origins
    live: Optional[torch.Tensor]     # the lanes whose shadows reach the image (None
                                     # with soft silhouettes)


def mesh_table(mesh) -> torch.Tensor:
    """(T, 10) packed per-triangle table [v0 | v1 | v2 | mat]."""
    v, t = mesh.verts, mesh.tris.long()
    return torch.cat([v[t[:, 0]], v[t[:, 1]], v[t[:, 2]],
                      mesh.tri_mat[:, None].to(v.dtype)], dim=-1)


def _sdf_from_res(scene: Scene, cfg: RenderConfig, chain: Chain, o, d, res, lite=False):
    """SDF hit state from the march residuals.

    lite: values only, for the geometry pass: no IFT attach, no Hessian
    term in the normal, no soft-silhouette coverage DE. Gradient callers
    keep lite=False."""
    t_bar, hit = res["sdf_t"], res["sdf_hit"]
    t = t_bar if lite else IftAttach.apply(
        sdf_distance, scene.sdf, o, d, t_bar, hit.to(o.dtype),
        *scene.sdf.float_leaves())
    cov = hit.to(o.dtype)
    t_eff = t
    if chain.soft_sil:
        tmin = res["sdf_tmin"]
        if not lite:
            # coverage from the DE at the closest-approach point
            d_min = sdf_distance(scene.sdf, o + tmin[..., None] * d)
            cov = torch.where(hit, torch.ones_like(d_min),
                              torch.sigmoid(-d_min / cfg.soft_silhouette))
        t_eff = torch.where(hit, t, tmin)
    p = o + t_eff[..., None] * d
    # the Hessian term only where p carries a gradient (o, d or the field)
    n = surface_normal(sdf_distance, scene.sdf, p,
                       create_graph=not lite and p.requires_grad)
    _, mat = sdf_distance_and_mat(scene.sdf, p.detach())
    return t, hit, p, n, mat, cov


def _mesh_from_res(scene: Scene, cfg: RenderConfig, chain: Chain, o, d, res,
                   mesh_rows=None, lite=False, corners=None):
    """Mesh hit state re-solved from the selected triangle. mesh_rows: the
    packed (T, 10) table of mesh_table, one row gather per ray; corners:
    the (R, 9) gathered corners themselves, when the caller has them."""
    tri, hit = res["mesh_tri"], res["mesh_hit"]
    idx = torch.clamp(tri, 0, scene.mesh.num_tris - 1).long()
    if corners is None:
        if mesh_rows is None:
            mesh_rows = mesh_table(scene.mesh)
        rows = mesh_rows[idx]
        corners, tri_mat = rows[:, :9], rows[:, 9].to(torch.int32)
    else:
        tri_mat = scene.mesh.tri_mat[idx]
    v0, v1, v2 = corners[:, 0:3], corners[:, 3:6], corners[:, 6:9]
    t, u, v, n = mt.recompute_hit_corners(v0, v1, v2, o, d)
    mat = torch.where(hit, tri_mat, torch.zeros_like(tri))
    if chain.mesh_sil and not lite:
        margin = mt.edge_margin_corners(v0, v1, v2, u, v)
        cov = torch.where(hit, clamp01(margin / cfg.mesh_silhouette),
                          torch.zeros_like(margin))
    else:
        cov = hit.to(o.dtype)
    t = torch.where(hit, t, torch.full_like(t, BIG))
    p = o + t[..., None] * d
    return t, hit, p, n, mat, cov


def reconstruct_plain(scene: Scene, cfg: RenderConfig, o, d, res, method: str,
                      lite: bool = False, mesh_rows=None, corners=None):
    """(t, hit, p, n, mat, cov) from the geometry residuals -> (that hit
    state, the mixed closest-select mask or None). lite: values only (see
    _sdf_from_res)."""
    chain = frame_chain(scene, cfg, method)
    if not chain.traced:
        raise NotImplementedError(f"reconstruct: {chain.why}")
    if chain.use_sdf:
        sdf = _sdf_from_res(scene, cfg, chain, o, d, res, lite=lite)
    if chain.use_mesh:
        mesh = _mesh_from_res(scene, cfg, chain, o, d, res, mesh_rows=mesh_rows, lite=lite,
                              corners=corners)
    if not chain.mixed:
        return (sdf if chain.use_sdf else mesh), None
    ts, hs, ps, ns, ms, cs = sdf
    tm, hm, pm, nm, mm, cm = mesh
    ts_eff = torch.where(hs, ts, torch.full_like(ts, BIG))
    tm_eff = torch.where(hm, tm, torch.full_like(tm, BIG))
    sdf_closer = ts_eff <= tm_eff
    t = torch.where(sdf_closer, ts, tm)
    hit = hs | hm
    p = torch.where(sdf_closer[..., None], ps, pm)
    n = torch.where(sdf_closer[..., None], ns, nm)
    mat = torch.where(sdf_closer, ms.to(mm.dtype), mm)
    # soft SDF coverage applies only where the mesh does not hit in front
    cov = torch.where(hm & (~sdf_closer), cm, torch.maximum(cs, cm))
    return (t, hit, p, n, mat, cov), sdf_closer


def shadow_ray_origins_plain(scene: Scene, cfg: RenderConfig, o, d, res, method: str,
                             mesh_rows=None) -> Recon:
    """The values-only reconstruct and the shadow rays' origins -> Recon:
    the hit points offset along the ray-facing normal, and the lanes whose
    shadows can reach the image (None with soft silhouettes, where every
    lane may).

    Without soft silhouettes a miss lane's shadow never reaches the image
    and o + BIG*d is a garbage origin: such lanes are parked at the camera,
    and the shadow queries give them a zero budget."""
    hits, closer = reconstruct_plain(scene, cfg, o, d, res, method, lite=True,
                                     mesh_rows=mesh_rows)
    _t, hit_any, p, n, _mat, _cov = hits
    n = torch.where(dot(n, d)[..., None] > 0.0, -n, n)
    p_off = p + cfg.shadow_bias * n
    live = None
    if cfg.soft_silhouette <= 0.0:
        live = hit_any
        p_off = torch.where(hit_any[..., None], p_off, o)
    return Recon(hits, closer, n, p_off, live)


def make_residual_occluder(scene: Scene, cfg: RenderConfig, res, chain: Chain):
    """Shadow callback for shade(): the geometry pass's static visibility,
    times, with diff_vis soft shadows, the penumbra recomputed from one DE
    at the saved argmin t, clip(soft_k * DE / max(ts, bias), 0, 1): the
    march's own min value, now with gradients."""
    if cfg.shadow == "none":
        return None

    def occluder(p, l_dir, li):
        vis = res["sh_vis"][li]
        if chain.soft_diff:
            ts = res["sh_ts"][li]
            dd = sdf_distance(scene.sdf, p + ts[..., None] * l_dir)
            vis = vis * clamp01(cfg.soft_k * dd / torch.clamp_min(ts, cfg.shadow_bias))
        return vis

    return occluder


def make_ao(scene: Scene, cfg: RenderConfig, res, chain: Chain):
    """5-tap distance-field AO callback for shade(), or None: its SDF term
    (chain.ao_sdf) and its mesh term (chain.ao_mesh, the geometry pass's
    `ao_tmesh`, where the pass left it)."""
    sdf = scene.sdf if chain.ao_sdf else None
    t_mesh = res.get("ao_tmesh") if chain.ao_mesh else None
    if sdf is None and t_mesh is None:
        return None
    return lambda p, n: shading.sdf_ambient_occlusion(sdf_distance, sdf, p, n, cfg,
                                                      t_mesh=t_mesh)


def shade_plain(scene: Scene, cfg: RenderConfig, o, d, res, method: str,
                mesh_rows=None, corners=None) -> torch.Tensor:
    """The shade computation itself: reconstruct + occluder + shade, plain
    PyTorch and differentiable (counterpart of `_shade_xla`). Without a
    gradient it reuses the geometry pass's hit state where there is one."""
    chain = frame_chain(scene, cfg, method)
    hits = None if torch.is_grad_enabled() else res.get("hits")
    if hits is None:
        hits = reconstruct_plain(scene, cfg, o, d, res, method, mesh_rows=mesh_rows,
                                 corners=corners)[0]
    _t, hit, p, n, mat, cov = hits
    return shading.shade(scene, cfg, p, n, d, mat, hit,
                         make_residual_occluder(scene, cfg, res, chain),
                         make_ao(scene, cfg, res, chain), coverage=cov)
