"""The differentiable fit loop: optimize scene parameters against a target
image (inverse rendering). Counterpart of `tpu_ray/fit.py`.

Any float leaf of the Scene can be optimized, addressed by dotted path
("sdf.sph_radius", "camera.origin", "mesh.verts", "materials.albedo",
"poses.translate", ...). The parameters are leaf tensors that require grad;
`apply_params` puts them into a copy of the scene that shares every other
tensor.

Not ported yet: the sharded step and checkpoints.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from tpu_ray_torch.accel.packet import refit_packet_accel
from tpu_ray_torch.render.render import render_image
from tpu_ray_torch.scene.types import Scene, apply_params, get_param, set_param
from tpu_ray_torch.utils.config import FitConfig, RenderConfig

ParamDict = Dict[str, torch.Tensor]

__all__ = ["get_param", "set_param", "extract_params", "apply_params",
           "make_fit_step", "fit"]


def extract_params(scene: Scene, paths: Sequence[str]) -> ParamDict:
    """Fresh leaf tensors (copies that require grad) of the given leaves."""
    return {p: get_param(scene, p).detach().clone().requires_grad_(True)
            for p in paths}


def _maybe_refit(scene: Scene, refit_accel: bool) -> Scene:
    """Refit the packet accel to the current vertices (never differentiated):
    keeps the accel valid while mesh.verts move."""
    if not refit_accel or scene.packet is None:
        return scene
    return scene.replace(packet=refit_packet_accel(scene.packet, scene.mesh.verts,
                                                   scene.mesh.tris))


def make_fit_step(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
                  params: ParamDict, optimizer: torch.optim.Optimizer,
                  refit_accel: bool = False) -> Callable[[], float]:
    """step() -> the MSE loss at the current params, after which the
    optimizer has taken one step on its gradient."""

    def step() -> float:
        optimizer.zero_grad(set_to_none=True)
        # render_image folds object poses in (and refits the accel to them)
        img = render_image(_maybe_refit(apply_params(scene, params), refit_accel), cfg)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        return float(loss.detach())

    return step


def fit(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
        trainable: Sequence[str], fit_cfg: FitConfig = FitConfig(),
        verbose: bool = True) -> Tuple[Scene, list]:
    """Optimize `trainable` scene leaves with Adam to match `target`.
    Returns (fitted_scene, loss_history)."""
    if fit_cfg.checkpoint_dir:
        raise NotImplementedError("fit checkpoints are not ported yet")
    if "sdf.mb_power" in trainable and scene.sdf.mb_pow8:
        # the power-8 field ignores mb_power: use the generic DE, whose
        # power has a gradient (the CUDA kernels take power 8 only)
        scene = scene.replace(sdf=scene.sdf.replace(mb_pow8=False))
    # moving vertices: the packet accel is refit every step
    refit_accel = any(p.split(".")[0] == "mesh" for p in trainable)

    params = extract_params(scene, trainable)
    optimizer = torch.optim.Adam(params.values(), lr=fit_cfg.learning_rate)
    step = make_fit_step(scene, cfg, target, params, optimizer, refit_accel)
    history = []
    for i in range(fit_cfg.steps):
        history.append(step())
        if verbose and (i % fit_cfg.log_every == 0 or i == fit_cfg.steps - 1):
            print(f"[fit] step {i} loss {history[-1]:.3e}")
    fitted = apply_params(scene, {p: v.detach() for p, v in params.items()})
    return _maybe_refit(fitted, refit_accel), history
