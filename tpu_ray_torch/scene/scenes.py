"""Scene registry (counterpart of `tpu_ray/scene/scenes.py`).

    sphere     config 1: single-sphere SDF, 256x256, no shadows
    triangles  config 2: 10 triangles + ground quad, brute MT, hard shadows
    bunny      config 3: the ~70k-triangle knot on a ground quad, hard
               shadows, through the packet accel; its uniform grid is
               built too, as the walks' oracle
    knot1m     a ~1.05M-triangle torus knot on a ground quad, 1024x1024,
               hard shadows, 64k-ray blocks
    mandelbulb config 4: a power-8 Mandelbulb on a ground plane, 1024x1024
               at 4 spp, soft shadows and 5-tap distance-field AO,
               64k-ray blocks
    pointlight a sphere and a rounded box on a plane, lit by a point light
               with inverse-square falloff and soft shadows, 512x512
    knot8m     an ~8.39M-triangle torus knot on a ground quad, 1024x1024,
               hard shadows, 64k-ray blocks: one whole-mesh accel part just
               below TRI_SLOT_LIMIT (the native build and the disk cache
               of accel/packet.py make it in seconds)
    mixed      config 5: a ~70k-triangle knot on a ground quad, a power-8
               Mandelbulb and a sphere, 1920x1080 at 16 spp, hard shadows,
               32k-ray blocks; the mesh is walked through the packet accel
               (its uniform grid is built too, as in the reference)

Same parameters as the reference. Scenes are built on the CUDA device
unless the caller names another.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tpu_ray_torch.render.camera import Camera
from tpu_ray_torch.scene.mesh import (MeshScene, bunny_standin, concat_meshes,
                                      ground_plane_quad, torus_knot)
from tpu_ray_torch.scene.types import Lights, Materials, Scene
from tpu_ray_torch.sdf.primitives import SdfScene
from tpu_ray_torch.utils.config import RenderConfig

_REGISTRY: Dict[str, Callable[..., Tuple[Scene, RenderConfig]]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def scene_names():
    return sorted(_REGISTRY)


def build_scene(name: str, device="cuda", dtype=torch.float32) -> Tuple[Scene, RenderConfig]:
    return _REGISTRY[name](device=torch.device(device), dtype=dtype)


def _base(device, dtype, camera, sdf=None, mesh=None, albedos=None,
          light_dir=(0.6, 0.8, 0.3), light_color=(1.0, 1.0, 1.0),
          ambient=(0.08, 0.09, 0.11)):
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Scene(
        camera=camera,
        sdf=sdf if sdf is not None else SdfScene.empty(device, dtype),
        mesh=mesh if mesh is not None else MeshScene.empty(device, dtype),
        materials=Materials.make(albedos if albedos is not None else [[0.8, 0.8, 0.8]],
                                 device, dtype),
        lights=Lights.make([light_dir], [light_color], ambient, device, dtype),
        bg_top=t([0.45, 0.65, 0.95]),
        bg_bottom=t([0.9, 0.93, 1.0]),
    )


@register("sphere")
def sphere_scene(device, dtype):
    """BASELINE config 1: single-sphere SDF, pinhole, Lambertian."""
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    i = lambda v: torch.as_tensor(v, dtype=torch.int32, device=device)
    sdf = SdfScene.empty(device, dtype).replace(
        sph_center=f([[0.0, 0.0, 0.0]]), sph_radius=f([1.0]), sph_mat=i([0]))
    cam = Camera.make((0.0, 0.4, 3.5), (0.0, 0.0, 0.0), vfov_deg=45.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, sdf=sdf, albedos=[[0.9, 0.35, 0.25]])
    cfg = RenderConfig(width=256, height=256, spp=1, method="sdf",
                       shadow="none", max_steps=96, eps=1e-3, t_far=20.0)
    return scene, cfg


@register("triangles")
def triangles_scene(device, dtype):
    """BASELINE config 2: 10 triangles + ground plane, brute-force MT."""
    rng = np.random.default_rng(42)
    centers = rng.uniform([-1.6, 0.1, -1.6], [1.6, 1.6, 1.6], (10, 3))
    tris = []
    for c in centers:
        e0 = rng.normal(size=3) * 0.45
        e1 = rng.normal(size=3) * 0.45
        tris.append([c - e0, c + e1, c + e0 - e1])
    verts = np.asarray(tris, np.float64).reshape(-1, 3)
    faces = np.arange(30, dtype=np.int32).reshape(10, 3)
    mesh = MeshScene.from_numpy(verts, faces, mat_id=np.arange(10, dtype=np.int32) % 3,
                                device=device, dtype=dtype)
    gv, gf = ground_plane_quad(0.0, 8.0)
    ground = MeshScene.from_numpy(gv, gf, mat_id=3, device=device, dtype=dtype)
    mesh = concat_meshes(mesh, ground)
    cam = Camera.make((0.0, 1.6, 4.5), (0.0, 0.7, 0.0), vfov_deg=50.0,
                      device=device, dtype=dtype)
    scene = _base(
        device, dtype, cam, mesh=mesh,
        albedos=[[0.9, 0.3, 0.25], [0.25, 0.8, 0.35], [0.3, 0.4, 0.9], [0.75, 0.72, 0.68]],
    )
    cfg = RenderConfig(width=512, height=512, spp=1, method="mesh_brute",
                       shadow="hard", t_far=40.0)
    return scene, cfg


@register("bunny")
def bunny_scene(device, dtype):
    """BASELINE config 3: the ~70k-triangle stand-in voxelized into a uniform
    grid, hard shadows. The frame walks the packet accel, as the reference's
    kernel path does; the grid is its oracle (kernels/dda.py)."""
    bv, bf = bunny_standin()
    bv = bv + np.array([0.0, 1.02, 0.0])  # rest on the ground plane
    body = MeshScene.from_numpy(bv, bf, mat_id=0, device=device, dtype=dtype)
    gv, gf = ground_plane_quad(0.0, 8.0)
    mesh = concat_meshes(body, MeshScene.from_numpy(gv, gf, mat_id=1,
                                                    device=device, dtype=dtype))
    cam = Camera.make((0.0, 1.7, 3.6), (0.0, 0.9, 0.0), vfov_deg=45.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, mesh=mesh,
                  albedos=[[0.82, 0.71, 0.55], [0.7, 0.73, 0.72]]).with_grid()
    cfg = RenderConfig(width=512, height=512, spp=1, method="mesh_grid",
                       shadow="hard", t_far=40.0)
    return scene, cfg


@register("knot1m")
def knot1m_scene(device, dtype):
    """A ~1.05M-triangle torus knot on a ground quad, hard shadows: its
    packet accel (72 MB) is 5.5x VMEM_BUDGET_BYTES, so it is one whole-mesh
    part for the streamed kernel, or 6 parts for the resident kernel when
    built with build_packet_parts(streamed=False)."""
    kv, kf = torus_knot(2, 3, 724, 724)
    kv = kv + np.array([0.0, 1.12, 0.0])  # rest on the ground plane
    body = MeshScene.from_numpy(kv, kf, mat_id=0, device=device, dtype=dtype)
    gv, gf = ground_plane_quad(0.0, 8.0)
    mesh = concat_meshes(body, MeshScene.from_numpy(gv, gf, mat_id=1,
                                                    device=device, dtype=dtype))
    cam = Camera.make((0.0, 1.9, 3.4), (0.0, 1.0, 0.0), vfov_deg=45.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, mesh=mesh,
                  albedos=[[0.62, 0.7, 0.82], [0.7, 0.73, 0.72]]).with_packet()
    cfg = RenderConfig(width=1024, height=1024, spp=1, method="mesh_grid",
                       shadow="hard", t_far=40.0, block_size=1 << 16)
    return scene, cfg


@register("knot8m")
def knot8m_scene(device, dtype):
    """An ~8.39M-triangle torus knot on a ground quad, hard shadows: 65,537
    chunks in one whole-mesh accel part (4,097 supers, ~537 MB of corners)
    below TRI_SLOT_LIMIT, walked by the streamed kernel. The host build is
    the native one (seconds), then a load from the disk cache."""
    kv, kf = torus_knot(3, 5, 2048, 2048, radius=0.65, tube=0.16)
    kv = kv + np.array([0.0, 1.12, 0.0])  # rest on the ground plane
    body = MeshScene.from_numpy(kv, kf, mat_id=0, device=device, dtype=dtype)
    gv, gf = ground_plane_quad(0.0, 8.0)
    mesh = concat_meshes(body, MeshScene.from_numpy(gv, gf, mat_id=1,
                                                    device=device, dtype=dtype))
    cam = Camera.make((0.0, 1.9, 3.4), (0.0, 1.0, 0.0), vfov_deg=45.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, mesh=mesh,
                  albedos=[[0.82, 0.55, 0.38], [0.7, 0.73, 0.72]]).with_packet()
    cfg = RenderConfig(width=1024, height=1024, spp=1, method="mesh_grid",
                       shadow="hard", t_far=40.0, block_size=1 << 16)
    return scene, cfg


@register("mandelbulb")
def mandelbulb_scene(device, dtype):
    """BASELINE config 4: Mandelbulb DE, 4x supersampling, soft shadows + AO."""
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    i = lambda v: torch.as_tensor(v, dtype=torch.int32, device=device)
    sdf = SdfScene.empty(device, dtype).replace(
        mb_center=f([[0.0, 1.1, 0.0]]),
        mb_scale=f([1.0]),
        mb_power=f([8.0]),
        mb_mat=i([0]),
        mb_pow8=True,  # power is exactly 8 -> trig-free DE
        pln_normal=f([[0.0, 1.0, 0.0]]),
        pln_offset=f([0.0]),
        pln_mat=i([1]),
    )
    cam = Camera.make((0.0, 1.9, 3.2), (0.0, 1.0, 0.0), vfov_deg=45.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, sdf=sdf,
                  albedos=[[0.85, 0.5, 0.3], [0.6, 0.62, 0.65]],
                  light_dir=(0.5, 0.75, 0.45))
    # diff_vis=False: the shadow penumbra is static; turn it on to fit
    # through the soft-shadow factor
    cfg = RenderConfig(width=1024, height=1024, spp=4, method="sdf",
                       shadow="soft", ao="sdf5", max_steps=128, eps=6e-4,
                       t_far=20.0, block_size=1 << 16, diff_vis=False)
    return scene, cfg


@register("pointlight")
def pointlight_scene(device, dtype):
    """A sphere and a rounded box on a plane, lit by one point light with
    inverse-square falloff and soft shadows: per-ray shadow directions and
    shadow marches cut at the light's distance."""
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    i = lambda v: torch.as_tensor(v, dtype=torch.int32, device=device)
    sdf = SdfScene.empty(device, dtype).replace(
        sph_center=f([[-0.7, 0.6, 0.0]]),
        sph_radius=f([0.6]),
        sph_mat=i([0]),
        box_center=f([[0.9, 0.45, -0.2]]),
        box_half=f([[0.45, 0.45, 0.45]]),
        box_round=f([0.08]),
        box_mat=i([2]),
        pln_normal=f([[0.0, 1.0, 0.0]]),
        pln_offset=f([0.0]),
        pln_mat=i([1]),
    )
    cam = Camera.make((0.0, 1.7, 4.2), (0.0, 0.6, 0.0), vfov_deg=45.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, sdf=sdf,
                  albedos=[[0.85, 0.4, 0.3], [0.66, 0.68, 0.7], [0.3, 0.55, 0.85]])
    scene = scene.replace(lights=Lights.make(
        [[0.5, 0.8, 0.4]], [[0.25, 0.25, 0.25]], ambient=(0.06, 0.06, 0.07),
        device=device, dtype=dtype, positions=[[1.3, 2.6, 1.4]],
        pos_colors=[[6.0, 5.7, 5.2]]))
    cfg = RenderConfig(width=512, height=512, spp=1, method="sdf",
                       shadow="soft", t_far=30.0, diff_vis=False)
    return scene, cfg


@register("mixed")
def mixed_scene(device, dtype):
    """BASELINE config 5: tri-mesh + SDF, 1080p, 16 spp, the headline scene."""
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    i = lambda v: torch.as_tensor(v, dtype=torch.int32, device=device)
    bv, bf = bunny_standin()
    bv = 0.8 * bv + np.array([-1.3, 0.82, 0.0])
    body = MeshScene.from_numpy(bv, bf, mat_id=0, device=device, dtype=dtype)
    gv, gf = ground_plane_quad(0.0, 10.0)
    mesh = concat_meshes(body, MeshScene.from_numpy(gv, gf, mat_id=1,
                                                    device=device, dtype=dtype))
    sdf = SdfScene.empty(device, dtype).replace(
        mb_center=f([[1.4, 1.05, 0.0]]),
        mb_scale=f([0.9]),
        mb_power=f([8.0]),
        mb_mat=i([2]),
        mb_pow8=True,  # power is exactly 8 -> trig-free DE
        sph_center=f([[0.0, 0.55, -1.6]]),
        sph_radius=f([0.55]),
        sph_mat=i([3]),
    )
    cam = Camera.make((0.1, 1.9, 4.6), (0.0, 0.9, 0.0), vfov_deg=48.0,
                      device=device, dtype=dtype)
    scene = _base(device, dtype, cam, sdf=sdf, mesh=mesh,
                  albedos=[[0.82, 0.71, 0.55], [0.68, 0.7, 0.7],
                           [0.85, 0.45, 0.3], [0.3, 0.5, 0.85]]).with_grid()
    cfg = RenderConfig(width=1920, height=1080, spp=16, method="mixed",
                       shadow="hard", max_steps=96, eps=1e-3, t_far=40.0,
                       block_size=1 << 15, diff_vis=False)
    return scene, cfg
