"""Build the port's Scene, and carry fit parameters, as arrays addressed by
dotted path.

The paths are those of the reference's scene parameters ("sdf.mb_center",
"mesh.verts", "camera.origin", "lights.direction", "bg_top",
"poses.translate", ...), so a
scene defined anywhere as plain arrays renders the same in both packages,
and a gradient dict of one compares with the other's by key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_ray_torch.render.camera import Camera
from tpu_ray_torch.scene.mesh import MeshScene
from tpu_ray_torch.scene.transform import MeshPoses
from tpu_ray_torch.scene.types import Lights, Materials, Scene
from tpu_ray_torch.sdf.primitives import SdfScene

_GROUPS = {"camera": Camera, "sdf": SdfScene, "mesh": MeshScene,
           "materials": Materials, "lights": Lights}
_INT_FIELDS = {"sdf.sph_mat", "sdf.pln_mat", "sdf.box_mat", "sdf.mb_mat",
               "mesh.tris", "mesh.tri_mat", "poses.vert_instance"}
_STATIC_FIELDS = {"mb_iters", "mb_pow8"}


def scene_from_numpy(arrays: dict[str, np.ndarray], statics: dict,
                     device="cuda", dtype=torch.float32) -> Scene:
    """arrays: every array field of the scene by dotted path (the `poses.*`
    fields only for a scene with object poses); statics: `mb_iters`,
    `mb_pow8` and `num_tris`. Builds the packet accel when the mesh has
    triangles."""
    def tensor(path):
        return _tensor(path, arrays[path], device, dtype)

    groups = {}
    for name, cls in _GROUPS.items():
        kw = {f.name: tensor(f"{name}.{f.name}") for f in dataclasses.fields(cls)
              if f.name not in _STATIC_FIELDS}
        if cls is SdfScene:
            kw.update(mb_iters=int(statics["mb_iters"]),
                      mb_pow8=bool(statics["mb_pow8"]))
        groups[name] = cls(**kw)
    if groups["mesh"].num_tris != int(statics["num_tris"]):
        raise ValueError(f"mesh.tris has {groups['mesh'].num_tris} triangles, "
                         f"statics say {statics['num_tris']}")
    poses = None
    if "poses.translate" in arrays:
        poses = MeshPoses(**{f.name: tensor(f"poses.{f.name}")
                             for f in dataclasses.fields(MeshPoses)})
    scene = Scene(**groups, bg_top=tensor("bg_top"), bg_bottom=tensor("bg_bottom"),
                  poses=poses)
    return scene.with_packet()


def _tensor(path: str, value, device, dtype) -> torch.Tensor:
    a = np.asarray(value)
    if path in _INT_FIELDS:
        return torch.as_tensor(a.astype(np.int32), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def params_to_numpy(params: dict) -> dict[str, np.ndarray]:
    """{dotted path: tensor} -> {dotted path: numpy array} (detached)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def params_from_numpy(arrays: dict, device="cuda",
                      dtype=torch.float32) -> dict[str, torch.Tensor]:
    """{dotted path: array} -> {dotted path: tensor} on `device` (the
    integer fields, such as `poses.vert_instance`, as int32)."""
    return {k: _tensor(k, v, device, dtype) for k, v in arrays.items()}
