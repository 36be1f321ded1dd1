"""Gradient checks: central finite differences against autograd
(counterpart of `tpu_ray/utils/gradcheck.py`), the card's float32 gradient
against the float64 one, and BASELINE config 3's vertex check.

Silhouettes carry measure-zero (Dirac) gradients that finite differences
see and autograd does not, so image losses are restricted to interior
pixels by an eroded hit mask (`interior_mask`, `masked_loss`).

The float64 checks run on CPU tensors: the CUDA kernels take float32 only
(render/chain.py refuses anything else on the card), as the reference sends
float64 to XLA and never to its Pallas kernels. `card_grad_check` holds
the kernels' float32 gradient on the card against the float64 autograd
gradient of the plain path at the same parameters and eps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

# the card's float32 gradients against the float64 ones: |g32 - g64| <=
# CARD_RTOL * max|g64| (the plain float32 path on the CPU stays within 3e-5)
CARD_RTOL = 1e-3


def erode_mask(mask: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Binary erosion of an (H, W) mask: keeps the pixels whose 3x3
    neighbourhood (wrapping at the borders) lies fully inside."""
    m = mask.to(torch.float32)
    for _ in range(iters):
        acc = torch.ones_like(m)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = acc * torch.roll(torch.roll(m, dy, 0), dx, 1)
        m = acc
    return m > 0.5


def interior_mask(hit_image: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """True strictly inside both the hit and the miss regions: everywhere
    but a band around the silhouettes."""
    return erode_mask(hit_image, iters) | erode_mask(~hit_image, iters)


def finite_diff_grad(f: Callable[[np.ndarray], float], x0: np.ndarray,
                     eps: float = 1e-4) -> np.ndarray:
    """Central finite differences of a scalar function, element by element."""
    x0 = np.asarray(x0, np.float64)
    g = np.zeros_like(x0)
    flat = x0.ravel()
    gf = g.ravel()
    for i in range(flat.size):
        xp = flat.copy()
        xp[i] += eps
        xm = flat.copy()
        xm[i] -= eps
        gf[i] = (f(xp.reshape(x0.shape)) - f(xm.reshape(x0.shape))) / (2 * eps)
    return g


def check_grad(loss_fn: Callable, x0, eps: float = 1e-4, rtol: float = 2e-3,
               atol: float = 1e-6):
    """Autograd's gradient of loss_fn at x0 (float64, on x0's device) against
    central differences. Returns (autograd_grad, fd_grad) as numpy arrays;
    raises AssertionError where an element is off by more than atol and
    by more than rtol relative to the larger of the two."""
    dev = x0.device if isinstance(x0, torch.Tensor) else torch.device("cpu")
    x = torch.as_tensor(x0, dtype=torch.float64, device=dev).detach().clone()
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(x), x)
    g_ad = g.detach().cpu().numpy().astype(np.float64)
    with torch.no_grad():
        g_fd = finite_diff_grad(
            lambda v: float(loss_fn(torch.as_tensor(v, dtype=torch.float64, device=dev))),
            x.detach().cpu().numpy(), eps)
    denom = np.maximum(np.abs(g_fd), np.maximum(np.abs(g_ad), 1e-8))
    rel = np.abs(g_ad - g_fd) / denom
    ok = (np.abs(g_ad - g_fd) <= atol) | (rel <= rtol)
    if not np.all(ok):
        bad = np.argwhere(~ok)
        raise AssertionError(
            f"gradcheck failed at {bad[:5].tolist()}: ad={g_ad[~ok][:5]} "
            f"fd={g_fd[~ok][:5]} rel={rel[~ok][:5]}")
    return g_ad, g_fd


def gradcheck_config(cfg):
    """The CLI gradcheck's frame: 24x24, one block, and the march tightened
    for float64 (eps <= 1e-6, at least 256 steps)."""
    return cfg.replace(width=24, height=24, block_size=0, eps=min(cfg.eps, 1e-6),
                       max_steps=max(cfg.max_steps, 256))


def mse_loss(scene, cfg, target: torch.Tensor, path: str) -> Callable:
    """v -> mean((render(scene with `path` = v) - target)^2)."""
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.scene.types import apply_params

    return lambda v: torch.mean((render_image(apply_params(scene, {path: v}), cfg)
                                 - target) ** 2)


def card_grad_check(scene64, cfg, path: str, target64: torch.Tensor, device) -> dict:
    """The float32 gradient of the MSE loss on `device` (the kernels on a
    CUDA device) against the float64 autograd gradient of the plain path on
    the CPU, at the same parameters, frame and eps. Passes when
    |g32 - g64| <= CARD_RTOL * max|g64| element by element. -> dict with both
    gradients, the error and `ok`."""
    from tpu_ray_torch.scene.types import get_param

    scene32 = to_device(scene64, device, torch.float32)
    target32 = target64.to(device, torch.float32)
    p64 = get_param(scene64, path).detach().clone().requires_grad_(True)
    (g64,) = torch.autograd.grad(mse_loss(scene64, cfg, target64, path)(p64), p64)
    p32 = get_param(scene32, path).detach().clone().requires_grad_(True)
    (g32,) = torch.autograd.grad(mse_loss(scene32, cfg, target32, path)(p32), p32)
    g32 = g32.detach().cpu().double()
    scale = float(g64.abs().max())
    err = float((g32 - g64).abs().max())
    return {"g32": g32.numpy(), "g64": g64.numpy(), "max_abs_err": err,
            "rel_err": err / max(scale, 1e-30), "ok": err <= CARD_RTOL * scale}


def to_device(scene, device, dtype):
    """A copy of a scene with its float tensors on `device` in `dtype` (ints
    keep their type), the packet accel and grid rebuilt there."""
    def move(obj):
        if isinstance(obj, torch.Tensor):
            return obj.to(device, dtype) if obj.is_floating_point() else obj.to(device)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{f.name: move(getattr(obj, f.name))
                                               for f in dataclasses.fields(obj)})
        return obj

    moved = scene.replace(**{g: move(getattr(scene, g))
                             for g in ("camera", "sdf", "mesh", "materials", "lights",
                                       "bg_top", "bg_bottom", "poses")})
    if scene.grid is not None:
        return moved.with_grid()
    return moved.with_packet() if scene.packet is not None else moved


def render_and_interior(scene, cfg):
    """(render, interior mask (H, W)): the scene's frame and the pixels away
    from every silhouette (the hit mask: where the frame differs from the
    sky)."""
    from tpu_ray_torch.render.camera import generate_rays
    from tpu_ray_torch.render.render import pixel_sample_coords, render_image
    from tpu_ray_torch.scene.types import background_color

    with torch.no_grad():
        base = render_image(scene, cfg)
        sx, sy = pixel_sample_coords(cfg, scene.device, base.dtype)
        _, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), cfg.width,
                             cfg.height)
        bg = background_color(scene, d).reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2)
        hit = torch.any(torch.abs(base - bg) > 1e-6, dim=-1)
    return base, interior_mask(hit, iters=2)


def masked_loss(scene, cfg, target_shift: float = 0.1, like=None) -> Callable:
    """img -> MSE against the scene's own frame shifted by target_shift, over
    the interior pixels (render_and_interior). like: a scene whose device
    and dtype the mask and target take (the scene's own by default)."""
    base, interior = render_and_interior(scene, cfg)
    like = like or scene
    dev, dtype = like.device, like.camera.origin.dtype
    mask = interior.to(dev, dtype)[..., None]
    target = (base + target_shift).to(dev, dtype)
    norm = mask.sum() * 3.0
    return lambda img: torch.sum(mask * (img - target) ** 2) / norm


def vertex_direction(scene, cfg, n_tris: int = 4, n_verts: int = 6, seed: int = 0,
                     interior_only: bool = False):
    """BASELINE config 3's direction V (V, 3): random normal on at most
    n_verts vertices of the first n_tris body triangles (by id; not the
    ground quad's last two) that the frame's primary rays hit, found by the
    uniform grid's DDA (kernels/dda.py). With interior_only, only the rays
    of interior pixels count: the reference's choice (all rays) can land on
    triangles seen only at masked silhouette pixels, where the masked
    loss's derivative along V is 0 and the check holds trivially. Then the
    triangles are taken from the brightest interior pixels first: a
    triangle that faces away from the light shades with the ambient term
    alone, and its derivative is 0 as well."""
    from tpu_ray_torch.kernels.dda import intersect_grid
    from tpu_ray_torch.render.camera import generate_rays
    from tpu_ray_torch.render.render import pixel_sample_coords

    dtype = scene.camera.origin.dtype
    sx, sy = pixel_sample_coords(cfg, scene.device, dtype)
    o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), cfg.width, cfg.height)
    res = intersect_grid(scene.mesh, scene.grid, o, d, t_max=cfg.t_far)
    tri = res.tri.cpu().numpy()
    keep = res.hit.cpu().numpy() & (tri < scene.mesh.num_tris - 2)
    if interior_only:
        base, interior = render_and_interior(scene, cfg)
        px = lambda a: a.reshape(-1, *a.shape[2:]).cpu().numpy().repeat(cfg.spp, axis=0)
        keep &= px(interior)
        order = np.argsort(-px(base.sum(-1))[keep], kind="stable")
        seen = list(dict.fromkeys(tri[keep][order].tolist()))
        body = np.asarray(seen[:n_tris], np.int64)
    else:
        body = np.unique(tri[keep])[:n_tris]
    if body.size == 0:
        raise AssertionError("no body triangle hit by the frame's primary rays")
    vidx = np.unique(scene.mesh.tris.cpu().numpy()[body].ravel())[:n_verts]
    rng = np.random.default_rng(seed)
    V = np.zeros(tuple(scene.mesh.verts.shape))
    V[vidx] = rng.normal(size=(len(vidx), 3))
    return torch.as_tensor(V, dtype=dtype, device=scene.device)


def vertex_loss(scene, cfg, V: torch.Tensor, loss_of_img=None) -> Callable:
    """alpha -> masked_loss of the frame with the vertices moved by alpha * V
    (loss_of_img: a masked_loss built elsewhere, the scene's own by
    default)."""
    from tpu_ray_torch.render.render import render_image

    loss_of_img = loss_of_img or masked_loss(scene, cfg)
    v0 = scene.mesh.verts.detach()

    def loss(alpha):
        mesh = dataclasses.replace(scene.mesh, verts=v0 + alpha * V)
        return loss_of_img(render_image(scene.replace(mesh=mesh), cfg))

    return loss


def card_vertex_check(scene64, cfg, V: torch.Tensor, device) -> dict:
    """Config 3's directional derivative on `device` in float32 (the
    kernels on a CUDA device) against the float64 autograd one on the CPU,
    with the float64 frame's mask and target in both. Passes when
    |d32 - d64| <= CARD_RTOL * |d64|."""
    scene32 = to_device(scene64, device, torch.float32)
    loss64 = masked_loss(scene64, cfg)
    loss32 = masked_loss(scene64, cfg, like=scene32)
    out = {}
    for key, scene, loss_of_img in (("d64", scene64, loss64), ("d32", scene32, loss32)):
        dtype = scene.camera.origin.dtype
        alpha = torch.zeros((), dtype=dtype, device=scene.device, requires_grad=True)
        f = vertex_loss(scene, cfg, V.to(scene.device, dtype), loss_of_img)
        (g,) = torch.autograd.grad(f(alpha), alpha)
        out[key] = float(g)
    err = abs(out["d32"] - out["d64"])
    return dict(out, max_abs_err=err, rel_err=err / max(abs(out["d64"]), 1e-30),
                ok=err <= CARD_RTOL * abs(out["d64"]))
