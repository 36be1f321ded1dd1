"""The reference's fit steps: the frame's mean squared error against a
target image, its gradient by autograd through the plain renderer, and
Adam's step as `torch.optim.Adam` defines it (default betas and eps, no
weight decay), written out here. Plain PyTorch; imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference import render

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def frame_loss_grad(scene: render.Scene, cfg: dict, target, params: dict, keep=None):
    """The loss mean((frame - target)**2) over the pixels `keep` (every
    pixel for None), and its gradient into params[*].grad; the frame is
    rendered in chunks, each differentiated in turn."""
    H, W = cfg["height"], cfg["width"]
    flat_t = target.reshape(-1, 3)
    pix = torch.arange(H * W, device=flat_t.device) if keep is None else keep
    denom = float(pix.shape[0] * 3)

    def each(p, img):
        loss = torch.sum((img - flat_t[p].to(img.dtype)) ** 2) / denom
        loss.backward()
        return float(loss.detach())

    return render.render_pixels(scene.replace(params), cfg, pix, each)


def frame_loss(scene: render.Scene, cfg: dict, target, params: dict) -> float:
    """The loss mean((frame - target)**2) over every pixel, without its
    gradient."""
    flat_t = target.reshape(-1, 3)
    pix = torch.arange(cfg["height"] * cfg["width"], device=flat_t.device)

    def each(p, img):
        return float(torch.sum((img - flat_t[p].to(img.dtype)) ** 2))

    with torch.no_grad():
        return render.render_pixels(scene.replace(params), cfg, pix, each) / (pix.shape[0] * 3)


def fit_steps(scene: render.Scene, cfg: dict, target, theta0: dict, lr: float, steps: int,
              keep=None) -> dict:
    """`steps` Adam steps from theta0 -> {"losses": each step's loss, "grad":
    the first step's gradient by leaf, "delta": theta - theta0 after the
    steps, by leaf, "states": theta before each step after the first}."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in theta0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first, states = [], None, []
    b1, b2 = BETAS
    for i in range(1, steps + 1):
        if i > 1:
            states.append({k: p.detach().clone() for k, p in params.items()})
        for p in params.values():
            p.grad = None
        losses.append(frame_loss_grad(scene, cfg, target, params, keep))
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** i, 1 - b2 ** i
                denom = (v2[k].sqrt() / c2 ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / c1)
    delta = {k: (p.detach() - theta0[k]) for k, p in params.items()}
    return {"losses": losses, "grad": first, "delta": delta, "states": states}
