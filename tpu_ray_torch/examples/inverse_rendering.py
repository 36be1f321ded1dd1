"""Inverse-rendering demo: recover a sphere's radius, centre and albedo from
one image (counterpart of `examples/inverse_rendering.py`).

    python -m tpu_ray_torch.examples.inverse_rendering [outdir] [--device cpu]
        [--size 256]

Renders a target of the `sphere` scene with hard silhouettes, perturbs the
sphere's radius, centre and albedo, then fits them back with the soft
silhouette coverage on (width 0.05), which gives the silhouette's motion a
gradient a few pixels past the edge. Writes target / initial / fitted PNGs.
On a CUDA device every shade runs the fused forward and backward kernels.
"""

from __future__ import annotations

import argparse
import os

import torch

from tpu_ray_torch.fit import apply_params, fit
from tpu_ray_torch.render.render import render_image
from tpu_ray_torch.scene.scenes import build_scene
from tpu_ray_torch.utils.config import FitConfig
from tpu_ray_torch.utils.image_io import write_png


def main(outdir: str = ".", device="cuda", size: int = 256, verbose: bool = True):
    """Returns (fitted scene, loss history)."""
    os.makedirs(outdir, exist_ok=True)
    scene, cfg = build_scene("sphere", device=device)
    cfg = cfg.replace(width=size, height=size, soft_silhouette=0.05)
    hard = cfg.replace(soft_silhouette=0.0)

    def png(name, s):
        with torch.no_grad():
            write_png(os.path.join(outdir, name), render_image(s, hard).cpu().numpy())

    with torch.no_grad():
        target = render_image(scene, hard)
    png("fit_target.png", scene)
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    init = apply_params(scene, {"sdf.sph_radius": t([0.55]),
                                "sdf.sph_center": t([[0.25, 0.15, 0.0]]),
                                "materials.albedo": t([[0.2, 0.5, 0.8]])})
    png("fit_init.png", init)
    fitted, hist = fit(init, cfg, target,
                       ["sdf.sph_radius", "sdf.sph_center", "materials.albedo"],
                       FitConfig(steps=200, learning_rate=1e-2), verbose=False)
    png("fit_result.png", fitted)
    if verbose:
        print(f"loss: {hist[0]:.4f} -> {hist[-1]:.2e}")
        print("radius:", round(float(fitted.sdf.sph_radius[0]), 4), "(target 1.0)")
        print("center:", fitted.sdf.sph_center[0].cpu().numpy().round(3), "(target 0 0 0)")
        print("albedo:", fitted.materials.albedo[0].cpu().numpy().round(3),
              "(target 0.9 0.35 0.25)")
    return fitted, hist


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="tpu_ray_torch.examples.inverse_rendering")
    ap.add_argument("outdir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=256, help="image width and height")
    a = ap.parse_args()
    main(a.outdir, a.device, a.size)
