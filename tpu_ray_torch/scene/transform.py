"""Differentiable per-object rigid transforms (translate, axis-angle rotate,
isotropic scale) on mesh instances (counterpart of
`tpu_ray/scene/transform.py`).

Each vertex maps to an instance by a fixed id; `realize_scene` folds the
poses into world-space vertices once per frame and refits the packet accel
to them, so everything downstream sees ordinary geometry and the vertex
gradient flows back into the poses through autograd of the fold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ray_torch.accel.packet import refit_packet_accel
from tpu_ray_torch.core.math3d import cross


@dataclasses.dataclass
class MeshPoses:
    """Per-instance transform of `Scene.mesh.verts` in object space.

    translate: (K, 3); rotate: (K, 3) axis-angle (direction = axis, norm =
    angle in radians); scale: (K,) isotropic; vert_instance: (V,) int32
    instance id per vertex (-1 = static vertex, untouched)."""

    translate: torch.Tensor
    rotate: torch.Tensor
    scale: torch.Tensor
    vert_instance: torch.Tensor

    @staticmethod
    def identity(n_instances: int, vert_instance, device="cuda",
                 dtype=torch.float32) -> "MeshPoses":
        return MeshPoses(
            translate=torch.zeros((n_instances, 3), dtype=dtype, device=device),
            rotate=torch.zeros((n_instances, 3), dtype=dtype, device=device),
            scale=torch.ones((n_instances,), dtype=dtype, device=device),
            vert_instance=torch.as_tensor(np.asarray(vert_instance, np.int32),
                                          device=device))

    def replace(self, **kw) -> "MeshPoses":
        return dataclasses.replace(self, **kw)


def rodrigues_apply(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by axis-angle rot (..., 3), smooth at 0:
    R v = v + sinc(th) (r x v) + ((1 - cos th) / th^2) (r x (r x v)).

    Both coefficients have removable singularities at th = 0; below
    th^2 = 1e-8 their 2-term Taylor series stand in, and the exact branch
    sees a safe th^2 = 1, so the gradient is finite and exact at the
    identity pose, where every pose fit starts."""
    th2 = torch.sum(rot * rot, dim=-1, keepdim=True)
    small = th2 < 1e-8
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)
    sinc = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    cosc = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    rxv = cross(rot, v)
    rxrxv = cross(rot, rxv)
    return v + sinc * rxv + cosc * rxrxv


def apply_poses(poses: MeshPoses, verts: torch.Tensor) -> torch.Tensor:
    """Object -> world: v' = R(rotate) (scale v) + translate, per vertex by
    its instance id; id -1 leaves the vertex untouched."""
    idx = torch.clamp(poses.vert_instance, 0, poses.translate.shape[0] - 1).long()
    moved = poses.vert_instance >= 0
    s = poses.scale[idx][..., None]
    world = rodrigues_apply(poses.rotate[idx], verts * s) + poses.translate[idx]
    return torch.where(moved[..., None], world, verts)


def realize_scene(scene):
    """The scene with its poses folded into world-space vertices, poses=None
    (so a second call changes nothing), its packet accel, if any, refit
    to the posed vertices, and its uniform grid dropped."""
    if scene.poses is None:
        return scene
    verts = apply_poses(scene.poses, scene.mesh.verts)
    # the grid's cell lists cannot follow the posed vertices: dropped
    scene = scene.replace(mesh=dataclasses.replace(scene.mesh, verts=verts), poses=None,
                          grid=None)
    if scene.packet is not None:
        scene = scene.replace(packet=[refit_packet_accel(a, verts, scene.mesh.tris)
                                      for a in scene.packet])
    return scene
