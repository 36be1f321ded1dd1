"""Inverse-lighting demo: recover a point light's position and intensity from
one image (counterpart of `examples/inverse_lighting.py`).

    python -m tpu_ray_torch.examples.inverse_lighting [outdir] [--device cpu]
        [--size 256] [--steps 150]

Renders a target of the `pointlight` scene with the differentiable soft-
shadow penumbra (diff_vis), moves the light to (-1, 2, 2.2) at intensity 4,
then fits `lights.position` and `lights.pos_color` back by image MSE (Adam,
lr 3e-2). Gradients flow through the inverse-square falloff, N.L and the
penumbra recomputed at the soft march's argmin. Writes light_target /
light_init / light_fitted PNGs. On a CUDA device the frames run the primary
and soft shadow marches, the fused shade forward and, in the fit, the fused
shade backward.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu_ray_torch.fit import apply_params, fit
from tpu_ray_torch.render.render import render_image
from tpu_ray_torch.scene.scenes import build_scene
from tpu_ray_torch.utils.config import FitConfig
from tpu_ray_torch.utils.image_io import write_png

INIT_POSITION = [[-1.0, 2.0, 2.2]]
INIT_POS_COLOR = [[4.0, 4.0, 4.0]]


def main(outdir: str = ".", device="cuda", size: int = 256, steps: int = 150,
         verbose: bool = True):
    """Returns (true scene, fitted scene, loss history)."""
    os.makedirs(outdir, exist_ok=True)
    scene, cfg = build_scene("pointlight", device=device)
    cfg = cfg.replace(width=size, height=size, diff_vis=True)

    def png(name, s):
        with torch.no_grad():
            write_png(os.path.join(outdir, name), render_image(s, cfg).cpu().numpy())

    with torch.no_grad():
        target = render_image(scene, cfg)
    write_png(os.path.join(outdir, "light_target.png"), target.cpu().numpy())
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    init = apply_params(scene, {"lights.position": t(INIT_POSITION),
                                "lights.pos_color": t(INIT_POS_COLOR)})
    png("light_init.png", init)
    fitted, history = fit(init, cfg, target, ["lights.position", "lights.pos_color"],
                          FitConfig(steps=steps, learning_rate=3e-2), verbose=False)
    png("light_fitted.png", fitted)
    if verbose:
        true_pos = scene.lights.position[0].cpu().numpy()
        got_pos = fitted.lights.position[0].cpu().numpy()
        print(f"true light position   {true_pos}")
        print(f"fitted light position {got_pos}")
        print(f"position error        {np.linalg.norm(true_pos - got_pos):.4f}")
        print(f"loss {history[0]:.3e} -> {history[-1]:.3e}")
    return scene, fitted, history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="tpu_ray_torch.examples.inverse_lighting")
    ap.add_argument("outdir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=256, help="image width and height")
    ap.add_argument("--steps", type=int, default=150, help="Adam steps")
    a = ap.parse_args()
    main(a.outdir, a.device, a.size, a.steps)
