"""Scene containers: materials, lights and the top-level Scene
(counterpart of `tpu_ray/scene/types.py`)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from tpu_ray_torch.accel.grid_build import UniformGrid, build_grid
from tpu_ray_torch.accel.packet import PacketAccel, build_packet_parts
from tpu_ray_torch.render.camera import Camera
from tpu_ray_torch.scene.mesh import MeshScene
from tpu_ray_torch.sdf.primitives import SdfScene


@dataclasses.dataclass
class Materials:
    albedo: torch.Tensor  # (K, 3) Lambertian albedo per material id

    @staticmethod
    def make(albedos, device="cpu", dtype=torch.float32) -> "Materials":
        return Materials(albedo=torch.as_tensor(albedos, dtype=dtype, device=device))


@dataclasses.dataclass
class Lights:
    """Directional and point lights plus a constant ambient term.

    `direction` points from the surface toward the light (normalized at
    use). Point lights fall off with the inverse square of the distance;
    `pos_color` is their radiance at unit distance.
    """

    direction: torch.Tensor  # (L, 3)
    color: torch.Tensor  # (L, 3)
    ambient: torch.Tensor  # (3,)
    position: torch.Tensor  # (P, 3)
    pos_color: torch.Tensor  # (P, 3)

    @staticmethod
    def make(directions, colors, ambient=(0.05, 0.05, 0.05), device="cpu",
             dtype=torch.float32, positions=None, pos_colors=None) -> "Lights":
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        z3 = torch.zeros((0, 3), dtype=dtype, device=device)
        return Lights(
            direction=t(directions).reshape(-1, 3),
            color=t(colors).reshape(-1, 3),
            ambient=t(ambient),
            position=z3 if positions is None else t(positions).reshape(-1, 3),
            pos_color=z3 if pos_colors is None else t(pos_colors).reshape(-1, 3),
        )


@dataclasses.dataclass
class Scene:
    camera: Camera
    sdf: SdfScene
    mesh: MeshScene
    materials: Materials
    lights: Lights
    bg_top: torch.Tensor  # (3,) sky gradient top color
    bg_bottom: torch.Tensor  # (3,)
    # Morton-chunked packet accel of the mesh as a list of parts (None until
    # built; one whole-mesh part unless built split); selection only, never
    # differentiated
    packet: Optional[List[PacketAccel]] = None
    # uniform grid of the mesh (accel/grid_build.UniformGrid, None unless
    # built by with_grid): the oracle of the packet walks (kernels/dda.py),
    # never a render path; dropped when vertices move (fit, poses)
    grid: Optional[UniformGrid] = None
    # per-object differentiable transforms (scene/transform.MeshPoses),
    # folded into world-space vertices at render entry
    poses: Optional[object] = None
    # this process's shard of the packet accel partitioned across a process
    # group (dist/scene_shard.RingPacket); the geometry pass then walks the
    # ring's shards in place of `packet`
    ring: Optional[object] = None

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.camera.origin.device

    def with_grid(self, density: float = 5.0) -> "Scene":
        """Build the packet accel and the uniform grid on the host from the
        current vertices."""
        grid = build_grid(self.mesh.verts.detach().cpu().numpy(),
                          self.mesh.tris.cpu().numpy(), density=density, device=self.device)
        return self.with_packet().replace(grid=grid)

    def with_packet(self) -> "Scene":
        """Build the packet accel on the host from the current vertices: one
        whole-mesh part (build_packet_parts' default)."""
        tris = self.mesh.tris.cpu().numpy()
        packet = (build_packet_parts(self.mesh.verts.detach().cpu().numpy(),
                                     tris, device=self.device)
                  if tris.shape[0] else None)
        return self.replace(packet=packet)

    @property
    def has_sdf(self) -> bool:
        return self.sdf.num_primitives > 0

    @property
    def has_mesh(self) -> bool:
        return self.mesh.num_tris > 0


def get_param(scene: Scene, path: str):
    """A scene leaf by dotted path ("sdf.sph_radius", "mesh.verts", ...)."""
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _set(obj, parts, value):
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    return dataclasses.replace(
        obj, **{parts[0]: _set(getattr(obj, parts[0]), parts[1:], value)})


def set_param(scene: Scene, path: str, value) -> Scene:
    """A copy of the scene with one leaf replaced; the others are shared."""
    return _set(scene, path.split("."), value)


def apply_params(scene: Scene, params: dict) -> Scene:
    """A copy of the scene with the {dotted path: tensor} leaves replaced."""
    for path, value in params.items():
        scene = set_param(scene, path, value)
    return scene


def background_color(scene: Scene, d: torch.Tensor) -> torch.Tensor:
    """Vertical sky gradient by ray direction: (..., 3) -> (..., 3)."""
    s = 0.5 * (d[..., 1] + 1.0)
    return scene.bg_bottom + (scene.bg_top - scene.bg_bottom) * s[..., None]
