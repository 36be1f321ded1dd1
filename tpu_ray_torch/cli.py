"""Command-line entry point of the port.

    python -m tpu_ray_torch.cli render --scene mixed --out mixed.png
    python -m tpu_ray_torch.cli render --scene mandelbulb --out bulb.png
    python -m tpu_ray_torch.cli render --scene sphere --width 64 --height 64 --device cpu --out s.png
    python -m tpu_ray_torch.cli fit --scene sphere --steps 20 --width 32 --height 32 --device cpu
    torchrun --nproc_per_node=N -m tpu_ray_torch.cli render --sharded --scene mixed

The device is the CUDA device unless `--device cpu` is given; without a
CUDA device and without `--device cpu` the CLI stops with an error. On a
CUDA device the geometry pass and the shade backward run the hand-written
kernels; on the CPU they run their plain PyTorch versions (slow for large
frames). `fit` recovers a demo target: the render of the scene with every
trainable leaf v set to v * 1.15 + 0.02. `--sharded` renders (or fits)
pixel-parallel over the processes torchrun starts, one card each (gloo
processes with `--device cpu`), the scene replicated; rank 0 prints and
writes the PNG.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from tpu_ray_torch.scene.scenes import build_scene, scene_names

_CFG_FLAGS = ("width", "height", "spp", "method", "shadow", "ao", "max_steps",
              "block_size", "soft_silhouette", "mesh_silhouette")


def _add_cfg_flags(p):
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--method")
    p.add_argument("--shadow")
    p.add_argument("--ao", help="none or sdf5")
    p.add_argument("--max-steps", type=int, dest="max_steps")
    p.add_argument("--block-size", type=int, dest="block_size")
    p.add_argument("--soft-silhouette", type=float, dest="soft_silhouette")
    p.add_argument("--mesh-silhouette", type=float, dest="mesh_silhouette")


def cmd_render(args):
    from tpu_ray_torch.dist.multihost import is_main, main_print
    from tpu_ray_torch.dist.sharding import render_image_sharded
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.utils.image_io import write_png

    device, scene, cfg, n_proc = _device_and_scene(args)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        img = render_image_sharded(scene, cfg) if args.sharded else render_image(scene, cfg)
        sync()
        dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    main_print(f"[render] {args.scene} {cfg.width}x{cfg.height} spp={cfg.spp} on {where}"
               f"{f' x {n_proc} processes' if args.sharded else ''}: {dt * 1e3:.1f} ms, "
               f"{cfg.num_rays / dt / 1e6:.2f} Mrays/s (first frame: on CUDA it includes "
               f"the kernel build)")
    if is_main():
        write_png(args.out, img.cpu().numpy())
    main_print(f"[render] wrote {args.out}")


def _device_and_scene(args):
    """(device, scene, cfg, processes). With --sharded, join the process
    group torchrun describes (gloo on the CPU, NCCL between cards, one card
    per process: cuda:LOCAL_RANK)."""
    from tpu_ray_torch.dist.multihost import initialize, world

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpu_ray_torch: no CUDA device; pass --device cpu to "
                         "run the plain PyTorch versions on the CPU")
    if args.sharded:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        initialize(backend="gloo" if device.type == "cpu" else "nccl")
    scene, cfg = build_scene(args.scene, device=device)
    overrides = {k: getattr(args, k) for k in _CFG_FLAGS if getattr(args, k) is not None}
    return device, scene, cfg.replace(**overrides), world()[0]


def demo_target(scene, cfg, trainable):
    """The fit demo's target: the render with each trainable leaf v set to
    v * 1.15 + 0.02 (the packet accel refit to perturbed vertices)."""
    from tpu_ray_torch.fit import _maybe_refit, apply_params
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.scene.types import get_param

    if "sdf.mb_power" in trainable and scene.sdf.mb_pow8:
        # as fit does: the power-8 field would render the target without
        # the perturbed power
        scene = scene.replace(sdf=scene.sdf.replace(mb_pow8=False))
    perturbed = {p: get_param(scene, p) * 1.15 + 0.02 for p in trainable}
    moved = _maybe_refit(apply_params(scene, perturbed),
                         any(p.split(".")[0] == "mesh" for p in trainable))
    with torch.no_grad():
        return render_image(moved, cfg)


def cmd_fit(args):
    import torch.distributed as dist

    from tpu_ray_torch.dist.multihost import is_main, main_print
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.utils.config import FitConfig
    from tpu_ray_torch.utils.image_io import write_png

    device, scene, cfg, n_proc = _device_and_scene(args)
    target = demo_target(scene, cfg, args.trainable)
    # the data-parallel step over the process group, when there is one
    group = dist.group.WORLD if args.sharded and dist.is_initialized() else None
    t0 = time.perf_counter()
    fitted, history = fit(scene, cfg, target, args.trainable,
                          FitConfig(steps=args.steps, learning_rate=args.lr),
                          verbose=is_main(), group=group)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    main_print(f"[fit] {args.steps} steps of {args.scene} {cfg.width}x{cfg.height} "
               f"spp={cfg.spp} on {where}{f' x {n_proc} processes' if args.sharded else ''}: "
               f"{time.perf_counter() - t0:.2f} s")
    main_print(f"[fit] final loss {history[-1]:.3e}" if history else "[fit] no steps")
    if args.out and is_main():
        with torch.no_grad():
            write_png(args.out, render_image(fitted, cfg).cpu().numpy())
        print(f"[fit] wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_ray_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a registry scene to PNG")
    r.add_argument("--scene", default="mixed", choices=scene_names())
    r.add_argument("--out", default="render.png")
    r.add_argument("--device", help="cuda (the default) or cpu")
    r.add_argument("--sharded", action="store_true",
                   help="pixel-parallel over the processes torchrun starts")
    _add_cfg_flags(r)
    r.set_defaults(fn=cmd_render)
    f = sub.add_parser("fit", help="inverse-render: recover perturbed scene leaves")
    f.add_argument("--scene", default="sphere", choices=scene_names())
    f.add_argument("--trainable", nargs="+", default=["sdf.sph_radius"])
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--out", help="PNG of the fitted scene")
    f.add_argument("--device", help="cuda (the default) or cpu")
    f.add_argument("--sharded", action="store_true",
                   help="data-parallel over the processes torchrun starts")
    _add_cfg_flags(f)
    f.set_defaults(fn=cmd_fit)
    args = ap.parse_args(argv)
    try:
        args.fn(args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
