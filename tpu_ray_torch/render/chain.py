"""What a frame traces and shades, decided in one place.

A frame's chain follows from its scene, its config and the traced method
(`resolve_method`): which geometry the geometry pass traces, which accel
the mesh walks take, which terms the AO reads, whether the shade
recomputes the soft-shadow penumbra, which silhouettes it blends, and
whether the shade kernels take the chain at all. `frame_chain` builds it;
render/, the kernel wrappers and the tools read a `Chain` and derive none
of its fields from the config or the method themselves. This module
imports no kernel wrapper and nothing else of render/.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_ray_torch.scene.types import Scene
from tpu_ray_torch.utils.config import RenderConfig

METHODS = ("sdf", "mesh_brute", "mesh_grid", "mixed")


def resolve_method(scene: Scene, cfg: RenderConfig) -> str:
    if cfg.method != "auto":
        return cfg.method
    if scene.has_mesh and scene.has_sdf:
        return "mixed"
    if scene.has_mesh:
        return "mesh_brute" if scene.mesh.num_tris <= 4096 else "mesh_grid"
    return "sdf"


def check_supported(cfg: RenderConfig) -> None:
    if cfg.shadow not in ("none", "hard", "soft"):
        raise ValueError(f"unknown shadow mode {cfg.shadow!r}")
    if cfg.ao not in ("none", "sdf5"):
        raise ValueError(f"unknown ao mode {cfg.ao!r}")


@dataclasses.dataclass(frozen=True)
class Chain:
    """One frame's chain (see the module docstring)."""
    use_sdf: bool    # the primary rays march the SDF (sdf, mixed)
    use_mesh: bool   # the primary rays walk the mesh (mesh_*, mixed)
    mixed: bool      # both: the SDF hit seeds the mesh walk, the closer hit is shaded
    packet: bool     # the primary and shadow walks take the packet accel (mesh_grid, mixed)
    # the AO taps' mesh term takes the packet accel whenever the scene has
    # one, whatever the method (ROADMAP E6)
    ao_packet: bool
    n_dir: int       # directional lights
    n_pos: int       # point lights
    ao_sdf: bool     # the AO's SDF term: whenever the scene has an SDF, whatever the method
    ao_mesh: bool    # the AO's mesh term: with a traced mesh (the geometry pass's ao_tmesh)
    soft_diff: bool  # the shade recomputes the soft-shadow penumbra with gradients
    soft_sil: bool   # the soft SDF silhouette
    mesh_sil: bool   # the mesh edge band
    traced: bool     # the scene holds the geometry the method traces (mixed: both)
    why: str | None  # why the shade kernels refuse the chain; None: they take it

    def check_kernels(self) -> None:
        """Raise NotImplementedError when the shade kernels refuse the
        chain: on a CUDA device there is no plain fallback."""
        if self.why is not None:
            raise NotImplementedError(f"the shade kernels do not take {self.why}")


def frame_chain(scene: Scene, cfg: RenderConfig, method: str) -> Chain:
    """The chain of (scene, cfg, method); method as resolve_method gives it."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    use_sdf = method in ("sdf", "mixed") and scene.has_sdf
    use_mesh = method in ("mesh_brute", "mesh_grid", "mixed") and scene.has_mesh
    mixed = use_sdf and use_mesh
    traced = mixed if method == "mixed" else use_sdf or use_mesh
    n_dir, n_pos = scene.lights.direction.shape[0], scene.lights.position.shape[0]
    dtype = scene.camera.origin.dtype
    why = None
    if not (use_sdf or use_mesh):
        why = f"method {method!r} on a scene without its geometry"
    elif not traced:
        why = "method 'mixed' without both an SDF and a mesh"
    elif n_dir + n_pos == 0:
        why = "a scene without lights"
    elif dtype != torch.float32:
        why = f"dtype {dtype}"
    return Chain(
        use_sdf=use_sdf, use_mesh=use_mesh, mixed=mixed,
        packet=method in ("mesh_grid", "mixed") and scene.packet is not None,
        ao_packet=scene.packet is not None, n_dir=n_dir, n_pos=n_pos,
        ao_sdf=cfg.ao == "sdf5" and scene.has_sdf,
        ao_mesh=cfg.ao == "sdf5" and use_mesh,
        soft_diff=cfg.shadow == "soft" and cfg.diff_vis and use_sdf,
        soft_sil=cfg.soft_silhouette > 0.0 and use_sdf,
        mesh_sil=cfg.mesh_silhouette > 0.0 and use_mesh,
        traced=traced, why=why)
