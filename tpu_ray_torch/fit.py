"""The differentiable fit loop: optimize scene parameters against a target
image (inverse rendering). Counterpart of `tpu_ray/fit.py`.

Any float leaf of the Scene can be optimized, addressed by dotted path
("sdf.sph_radius", "camera.origin", "mesh.verts", "materials.albedo",
"poses.translate", ...). The parameters are leaf tensors that require grad;
`apply_params` puts them into a copy of the scene that shares every other
tensor. With `FitConfig.checkpoint_dir`, `fit` resumes from the newest
checkpoint there and saves one every `checkpoint_every` steps and at the
end (utils/checkpoint.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_ray_torch.accel.packet import refit_packet_accel
from tpu_ray_torch.dist.grad_allreduce import bucket_sum
from tpu_ray_torch.dist.multihost import live_group, world
from tpu_ray_torch.dist.scene_shard import refit_ring_packet
from tpu_ray_torch.dist.sharding import ring_scene, shard_sample_coords
from tpu_ray_torch.render.graphs import render_pixels_flat_jit
from tpu_ray_torch.render.render import render_image_jit
from tpu_ray_torch.scene.transform import realize_scene
from tpu_ray_torch.scene.types import Scene, apply_params, get_param, set_param
from tpu_ray_torch.utils import checkpoint as ckpt_lib
from tpu_ray_torch.utils.config import FitConfig, RenderConfig
from tpu_ray_torch.utils.metrics import span

ParamDict = Dict[str, torch.Tensor]

__all__ = ["get_param", "set_param", "extract_params", "apply_params",
           "make_fit_step", "make_sharded_fit_step", "fit"]


def extract_params(scene: Scene, paths: Sequence[str]) -> ParamDict:
    """Fresh leaf tensors (copies that require grad) of the given leaves."""
    return {p: get_param(scene, p).detach().clone().requires_grad_(True)
            for p in paths}


def _maybe_refit(scene: Scene, refit_accel: bool) -> Scene:
    """Refit the packet accel's parts to the current vertices (never
    differentiated): keeps the accel valid while mesh.verts move."""
    if not refit_accel or scene.packet is None:
        return scene
    return scene.replace(packet=[refit_packet_accel(a, scene.mesh.verts, scene.mesh.tris)
                                 for a in scene.packet])


def make_fit_step(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
                  params: ParamDict, optimizer: torch.optim.Optimizer,
                  refit_accel: bool = False) -> Callable[[], float]:
    """step() -> the MSE loss at the current params, after which the
    optimizer has taken one step on its gradient. The frame and its
    gradient go through render_image_jit (the reference jits the step); the
    loss, `backward` and the optimizer's step run eagerly. Spans
    (utils.metrics.span): `fit.params` (zero_grad, apply_params, the refit),
    `fit.forward` (the frame), `fit.backward` (the loss and its backward),
    `fit.optimizer` (the step and the loss's read-back)."""

    def step() -> float:
        with span("fit.params"):
            optimizer.zero_grad(set_to_none=True)
            s = _maybe_refit(apply_params(scene, params), refit_accel)
        with span("fit.forward"):
            # render_image_jit folds object poses in (and refits the accel to
            # them) outside its graphs
            img = render_image_jit(s, cfg)
        with span("fit.backward"):
            loss = torch.mean((img - target) ** 2)
            loss.backward()
        with span("fit.optimizer"):
            optimizer.step()
            return float(loss.detach())

    return step


def make_sharded_fit_step(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
                          params: ParamDict, optimizer: torch.optim.Optimizer,
                          group=None, scene_shards: bool = False,
                          refit_accel: bool = False) -> Callable[[], float]:
    """The data-parallel fit step over a process group (counterpart of the
    reference's jitted `make_sharded_fit_step`): step() -> the global loss.

    Each rank renders and differentiates its own whole pixels
    (dist.sharding.shard_sample_coords) through the per-block CUDA graphs
    (render.graphs.render_pixels_flat_jit: the frame's Function, its
    backward by the vjp graph); its loss is sum(w * (px - t)**2) / (n_px *
    3), so the sum over ranks is the MSE of the spp-averaged image, the
    objective of make_fit_step. After `backward` the parameter gradients
    and the loss are summed over the group by one captured graph of
    bucketed all_reduces (grad_allreduce.bucket_sum, whenever a process
    group is live), and every rank takes the same optimizer step, eagerly:
    the parameters stay replicated. target: (H, W, 3), the full frame.

    scene_shards partitions the accel around the ring: the geometry pass
    walks the rotating shards (inside the block graph), the differentiable
    re-solve reads the replicated mesh, so vertex gradients stay exact.
    When `mesh.*` or `poses.*` is trained (or refit_accel), each rank
    refits its shard to the current posed vertices before the ring turns.
    apply_params, the pose fold and the refits run outside the graphs; the
    plan copies their new tensors in at every step. Spans as
    make_fit_step's, `fit.backward` holding the gradients' all-reduce."""
    group = live_group(group)
    n, r = world(group)
    dev, dtype = scene.device, scene.camera.origin.dtype
    ring = None
    if scene_shards and scene.has_mesh:
        ring = ring_scene(scene, group).ring  # built from the posed vertices
        scene = scene.replace(packet=None)
    flat_x, flat_y, n_px, perm = shard_sample_coords(cfg, n, dev, dtype)
    per = flat_x.shape[0] // n
    per_px = per // cfg.spp
    xs, ys = flat_x[r * per:(r + 1) * per], flat_y[r * per:(r + 1) * per]
    p = torch.from_numpy(perm.astype(np.int64)).to(dev)
    n_pad = flat_x.shape[0] // cfg.spp - n_px
    tgt = torch.cat([target.reshape(-1, 3).T.to(dtype)[:, p],
                     torch.zeros((3, n_pad), dtype=dtype, device=dev)], dim=1)
    w = torch.cat([torch.ones(n_px, dtype=dtype, device=dev),
                   torch.zeros(n_pad, dtype=dtype, device=dev)])
    tgt, w = tgt[:, r * per_px:(r + 1) * per_px], w[r * per_px:(r + 1) * per_px]
    moving = refit_accel or any(k.split(".")[0] in ("mesh", "poses") for k in params)

    def step() -> float:
        with span("fit.params"):
            optimizer.zero_grad(set_to_none=True)
            s = _maybe_refit(realize_scene(apply_params(scene, params)), refit_accel)
            if ring is not None:
                s = s.replace(ring=refit_ring_packet(ring, s.mesh.verts, s.mesh.tris)
                              if moving else ring)
        with span("fit.forward"):
            px = render_pixels_flat_jit(s, cfg, xs, ys)  # (3, per_px)
        with span("fit.backward"):
            loss = torch.sum(w[None, :] * (px - tgt) ** 2) / (n_px * 3)
            loss.backward()
            grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                     for k, v in params.items()}
            total = loss.detach()
            if group is not None:
                grads, total = bucket_sum(grads, total, group)
            for k, v in params.items():
                v.grad = grads[k]
        with span("fit.optimizer"):
            optimizer.step()
            return float(total)

    return step


def _save(mngr, step: int, params: ParamDict, optimizer, group) -> None:
    """Rank 0 writes the checkpoint; with a process group every rank waits
    for the write."""
    if world(group)[1] == 0:
        ckpt_lib.save(mngr, step, params, optimizer)
    if group is not None:
        dist.barrier(group)


def fit(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
        trainable: Sequence[str], fit_cfg: FitConfig = FitConfig(),
        verbose: bool = True, group=None) -> Tuple[Scene, list]:
    """Optimize `trainable` scene leaves with Adam to match `target`.
    Returns (fitted_scene, loss_history). With a process group, every rank
    calls it and takes the data-parallel step (make_sharded_fit_step).

    With fit_cfg.checkpoint_dir, the parameters and Adam's state are
    restored from the newest checkpoint there (every rank reads it), the
    steps run from its step to fit_cfg.steps, and the history holds those
    steps only; rank 0 saves every checkpoint_every steps and after the
    last step."""
    if "sdf.mb_power" in trainable and scene.sdf.mb_pow8:
        # the power-8 field ignores mb_power: use the generic DE, whose
        # power has a gradient (the CUDA kernels have both fields)
        scene = scene.replace(sdf=scene.sdf.replace(mb_pow8=False))
    # moving vertices: the packet accel is refit every step
    refit_accel = any(p.split(".")[0] == "mesh" for p in trainable)
    if any(p.split(".")[0] in ("mesh", "poses") for p in trainable):
        # the grid was voxelized from the first vertices and would go stale
        scene = scene.replace(grid=None)

    params = extract_params(scene, trainable)
    optimizer = torch.optim.Adam(params.values(), lr=fit_cfg.learning_rate)
    start, mngr = 0, None
    if fit_cfg.checkpoint_dir:
        mngr = ckpt_lib.make_manager(fit_cfg.checkpoint_dir)
        restored = ckpt_lib.restore_latest(mngr, params, optimizer)
        if restored is not None:
            start = restored
            if verbose:
                print(f"[fit] resumed from step {start}")
    if group is not None:
        step = make_sharded_fit_step(scene, cfg, target, params, optimizer, group=group,
                                     refit_accel=refit_accel)
    else:
        step = make_fit_step(scene, cfg, target, params, optimizer, refit_accel)
    history = []
    for i in range(start, fit_cfg.steps):
        history.append(step())
        if verbose and (i % fit_cfg.log_every == 0 or i == fit_cfg.steps - 1):
            print(f"[fit] step {i} loss {history[-1]:.3e}")
        if mngr is not None and ((i + 1) % fit_cfg.checkpoint_every == 0
                                 or i + 1 == fit_cfg.steps):
            _save(mngr, i + 1, params, optimizer, group)
    fitted = apply_params(scene, {p: v.detach() for p, v in params.items()})
    return _maybe_refit(fitted, refit_accel), history
