"""Carry a scene and a render config from the JAX package to the port, for
the port's tests (tests/test_torch_*.py): the same parameters, by dotted
path, in both packages."""

import dataclasses

import numpy as np

from tpu_ray_torch.scene.convert import scene_from_numpy
from tpu_ray_torch.utils.config import RenderConfig


def flatten(scene):
    """A JAX scene's arrays by dotted path (its object poses' too), plus its
    static fields."""
    arrays = {}
    for group in ("camera", "sdf", "mesh", "materials", "lights"):
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if hasattr(v, "shape"):
                arrays[f"{group}.{f.name}"] = np.asarray(v)
    arrays["bg_top"] = np.asarray(scene.bg_top)
    arrays["bg_bottom"] = np.asarray(scene.bg_bottom)
    if scene.poses is not None:
        for f in dataclasses.fields(scene.poses):
            arrays[f"poses.{f.name}"] = np.asarray(getattr(scene.poses, f.name))
    statics = {"mb_iters": scene.sdf.mb_iters, "mb_pow8": scene.sdf.mb_pow8,
               "num_tris": scene.mesh.num_tris}
    return arrays, statics


def port_scene(jscene):
    """The port's copy of a JAX scene (with its packet accel), on the CPU."""
    return scene_from_numpy(*flatten(jscene), device="cpu")


def port_cfg(jcfg) -> RenderConfig:
    """The port's RenderConfig with a JAX config's values (minus `pallas`)."""
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(RenderConfig)})
