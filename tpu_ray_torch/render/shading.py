"""Lambertian shading with occluder and ambient-occlusion callbacks
(counterpart of `shade` in `tpu_ray/render/shading.py`).

Visibility comes from an `occluder(p_off, l_dir, light_index)` callback, so
one shading function serves the SDF, mesh and mixed paths; the renderer's
occluder reads the geometry pass's shadow visibility.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_ray_torch.core.math3d import dot, normalize
from tpu_ray_torch.scene.types import Scene, background_color
from tpu_ray_torch.utils.config import RenderConfig


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
        else:
            vis = torch.ones_like(ndotl)
        falloff = ndotl * vis / torch.clamp_min(dist2, 1e-8)
        radiance = radiance + scene.lights.pos_color[pi] * falloff[..., None]

    color = albedo * radiance
    bg = background_color(scene, d)
    if coverage is not None:
        return bg + coverage[..., None] * (color - bg)
    return torch.where(hit[..., None], color, bg)
