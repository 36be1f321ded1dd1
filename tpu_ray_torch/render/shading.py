"""Lambertian shading with occluder and ambient-occlusion callbacks, the
distance-field soft shadow and the 5-tap distance-field AO (counterpart of
`tpu_ray/render/shading.py`).

Visibility comes from an `occluder(p_off, l_dir, light_index)` callback, so
one shading function serves the SDF, mesh and mixed paths; the renderer's
occluder reads the geometry pass's shadow visibility and, with `diff_vis`
soft shadows, recomputes the penumbra differentiably. Without `diff_vis`
the visibility carries no gradient; the AO always does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_ray_torch.core.math3d import clamp01, dot, normalize
from tpu_ray_torch.kernels import cuda_sdf
from tpu_ray_torch.scene.types import Scene, background_color
from tpu_ray_torch.utils.config import RenderConfig


def sdf_soft_shadow_argmin(sdf_scene, p, l_dir, cfg: RenderConfig, t_far=None,
                           packed=None):
    """Penumbra visibility and the march parameter t_s at which its min was
    attained: (vis, t_s), both (R,), through `cuda_sdf.shadow_soft` (the
    kernel on a CUDA device, its plain version on the CPU). t_far: None
    (cfg.t_far), a number, or a per-ray (R,) cutoff. The distance field is
    the scene's, the one the kernel evaluates: the reference's `de_fn`
    argument has no counterpart here. packed: the kernel's parameters
    packed once (cuda_sdf.pack)."""
    per_ray = isinstance(t_far, torch.Tensor)
    return cuda_sdf.shadow_soft(
        sdf_scene, p, l_dir, eps=cfg.eps,
        t_far=cfg.t_far if t_far is None or per_ray else t_far,
        steps=cfg.shadow_steps, bias=cfg.shadow_bias, soft_k=cfg.soft_k,
        t_far_rays=t_far if per_ray else None, packed=packed)


def sdf_soft_shadow(sdf_scene, p, l_dir, cfg: RenderConfig, t_far=None):
    """Penumbra visibility: min over the march of k * DE / t, clamped to
    [0, 1]. (R,3),(R,3) -> (R,)."""
    return sdf_soft_shadow_argmin(sdf_scene, p, l_dir, cfg, t_far)[0]


def sdf_ambient_occlusion(de_fn, sdf_scene, p, n, cfg: RenderConfig,
                          t_mesh=None):
    """5-tap distance-field AO: the DE at heights h = ao_step * i (i = 1..5)
    along the normal against h, weighted 0.7^(i-1) -> (R,) in [0, 1].

    t_mesh: optional (R,) closest mesh hit distance along n from p (BIG on a
    miss), no gradient: each tap's occluder distance becomes
    min(DE, |t_mesh - h|). sdf_scene=None skips the DE (mesh-only AO)."""
    occ = torch.zeros_like(p[..., 0])
    w = 1.0
    for i in range(1, 6):
        h = cfg.ao_step * i
        d = de_fn(sdf_scene, p + h * n) if sdf_scene is not None else None
        if t_mesh is not None:
            dm = torch.abs(t_mesh - h)
            d = dm if d is None else torch.minimum(d, dm)
        occ = occ + w * (h - d)
        w *= 0.7
    return clamp01(1.0 - cfg.ao_strength * occ)


def shade(
    scene: Scene,
    cfg: RenderConfig,
    p: torch.Tensor,  # (R, 3) hit points
    n: torch.Tensor,  # (R, 3) unit normals
    d: torch.Tensor,  # (R, 3) incoming ray dirs
    mat_id: torch.Tensor,  # (R,) int
    hit: torch.Tensor,  # (R,) bool
    occluder: Optional[Callable] = None,  # (p, l_dir, light_idx) -> vis
    ao_fn: Optional[Callable] = None,  # (p, n) -> ao in [0, 1]
    coverage: Optional[torch.Tensor] = None,  # (R,) in [0, 1]
) -> torch.Tensor:
    """Lambertian shade of hit rays, background for misses -> (R, 3). With
    `coverage`, the surface color blends over the background instead."""
    albedo = scene.materials.albedo[mat_id.long()]
    # two-sided shading: face the normal against the incoming ray
    n = torch.where(dot(n, d)[..., None] > 0.0, -n, n)

    ao = ao_fn(p, n) if ao_fn is not None else torch.ones_like(p[..., 0])
    radiance = scene.lights.ambient * ao[..., None]

    for li in range(scene.lights.direction.shape[0]):
        l_dir = normalize(scene.lights.direction[li])
        ndotl = torch.clamp_min(dot(n, l_dir.expand_as(n)), 0.0)
        if occluder is not None:
            p_off = p + cfg.shadow_bias * n  # escape the surface band
            vis = occluder(p_off, l_dir.expand_as(p), li)
            if not cfg.diff_vis:
                vis = vis.detach()
        else:
            vis = torch.ones_like(ndotl)
        radiance = radiance + scene.lights.color[li] * (ndotl * vis)[..., None]

    n_dir_lights = scene.lights.direction.shape[0]
    for pi in range(scene.lights.position.shape[0]):
        # inverse-square point light; its shadow index follows the
        # directional lights
        lvec = scene.lights.position[pi] - p
        dist2 = dot(lvec, lvec)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
        l_dir = lvec / dist[..., None]
        ndotl = torch.clamp_min(dot(n, l_dir), 0.0)
        if occluder is not None:
            # shadow direction from the offset point, the ray the geometry
            # pass marched
            p_off = p + cfg.shadow_bias * n
            lvec_off = scene.lights.position[pi] - p_off
            dist_off = torch.sqrt(torch.clamp_min(dot(lvec_off, lvec_off), 1e-12))
            vis = occluder(p_off, lvec_off / dist_off[..., None], n_dir_lights + pi)
            if not cfg.diff_vis:
                vis = vis.detach()
        else:
            vis = torch.ones_like(ndotl)
        falloff = ndotl * vis / torch.clamp_min(dist2, 1e-8)
        radiance = radiance + scene.lights.pos_color[pi] * falloff[..., None]

    color = albedo * radiance
    bg = background_color(scene, d)
    if coverage is not None:
        return bg + coverage[..., None] * (color - bg)
    return torch.where(hit[..., None], color, bg)
