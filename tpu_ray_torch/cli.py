"""Command-line entry point of the port: render / fit / bench / scenes.

    python -m tpu_ray_torch.cli render --scene mixed --out mixed.png
    python -m tpu_ray_torch.cli render --scene mandelbulb --out bulb.png --stats
    python -m tpu_ray_torch.cli render --scene sphere --turntable 8 --out orbit.png
    python -m tpu_ray_torch.cli render --scene mixed --progressive 3 --out mixed.png
    python -m tpu_ray_torch.cli render --scene sphere --width 64 --height 64 --device cpu --out s.png
    python -m tpu_ray_torch.cli fit --scene sphere --steps 20 --width 32 --height 32 --device cpu
    python -m tpu_ray_torch.cli fit --scene sphere --target t.png --checkpoint-dir ck
    python -m tpu_ray_torch.cli bench --scene mandelbulb
    python -m tpu_ray_torch.cli scenes
    python -m tpu_ray_torch.cli gradcheck --scene sphere --device cpu
    torchrun --nproc_per_node=N -m tpu_ray_torch.cli render --sharded --scene mixed

The device is the CUDA device unless `--device cpu` is given; without a
CUDA device and without `--device cpu` the CLI stops with an error. On a
CUDA device the geometry pass and the shade backward run the hand-written
kernels; on the CPU they run their plain PyTorch versions (slow for large
frames). `render`, the turntable, the previews and `fit` render through
render.render_image_jit (per-block CUDA graphs on the card); with
`--sharded`, `render` through dist.sharding.render_image_sharded_jit (the
same graphs for each rank's pixels, the frame's all_gather captured under
NCCL) and `fit` through fit.make_sharded_fit_step (its all_reduces
captured too). `render` times one frame (on CUDA it includes the kernel
build and the graphs' capture) and writes it; `--stats` adds the frame's
ray statistics
(render.frame_stats), `--profile DIR` a torch.profiler trace of the frame
(its host spans `render.*` and, on the card, the stage markers
`trace_stage_*` that name the device work after them; utils/metrics.py),
`--turntable N` renders N frames orbiting the look-at point instead,
`--progressive K` K coarse previews (half the resolution each, 1 spp, one
block) before the full frame. `fit` fits a target PNG (`--target`) or
recovers a demo target: the render of the scene with every trainable leaf
v set to v * 1.15 + 0.02; `--checkpoint-dir` resumes from and saves to a
directory. `bench` prints tpu_ray_torch.bench's JSON line. `--sharded`
renders (or fits) pixel-parallel over the processes torchrun starts, one
card each (gloo processes with `--device cpu`), the scene replicated; rank
0 prints and writes the PNG.

`gradcheck` checks each trainable's gradient against central finite
differences in float64 (24x24, one block, eps <= 1e-6, >= 256 march
steps, target = render + 0.1, FD step 1e-5, `--rtol`); it exits 1 when one
fails. Its device rule: float64 runs on CPU tensors only (the CUDA kernels
take float32), so that check runs on the CPU whatever `--device` says;
with a CUDA device (the default) it then checks the card: the float32
gradient through the kernels against the float64 autograd gradient of the
plain path, at the scene's own eps, within gradcheck.CARD_RTOL (1e-3) of
the largest component.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
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
    from tpu_ray_torch.dist.sharding import render_image_sharded_jit
    from tpu_ray_torch.render.render import frame_stats, render_image_jit
    from tpu_ray_torch.utils.image_io import write_png
    from tpu_ray_torch.utils.metrics import profile_trace

    device, scene, cfg, n_proc = _device_and_scene(args)
    if args.turntable:
        _render_turntable(args, device, scene, cfg)
        return
    if args.progressive:
        _render_progressive(args, device, scene, cfg)
        return
    with torch.no_grad(), profile_trace(args.profile):
        _sync(device)
        t0 = time.perf_counter()
        img = (render_image_sharded_jit(scene, cfg) if args.sharded
               else render_image_jit(scene, cfg))
        _sync(device)
        dt = time.perf_counter() - t0
    main_print(f"[render] {args.scene} {cfg.width}x{cfg.height} spp={cfg.spp} on "
               f"{_where(device)}{f' x {n_proc} processes' if args.sharded else ''}: "
               f"{dt * 1e3:.1f} ms, {cfg.num_rays / dt / 1e6:.2f} Mrays/s (first frame: on "
               f"CUDA it includes the kernel build and the graphs' capture)")
    if is_main():
        write_png(args.out, img.cpu().numpy())
    main_print(f"[render] wrote {args.out}")
    if args.profile:
        main_print(f"[render] profiler trace in {args.profile}")
    if args.stats:
        main_print("[render] stats:", json.dumps(frame_stats(scene, cfg)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _where(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _render_turntable(args, device, scene, cfg):
    """N frames orbiting the scene's look_at point about the y axis (the
    CLI's stand-in for the reference's interactive orbit view); the PNGs
    get _000.. suffixes."""
    from tpu_ray_torch.dist.multihost import is_main, main_print
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.utils.image_io import write_png
    from tpu_ray_torch.utils.metrics import Timer, mrays_per_sec, rays_per_frame

    n = args.turntable
    cam = scene.camera
    center = cam.look_at.detach().cpu().numpy()
    offset = cam.origin.detach().cpu().numpy() - center
    radius = float(np.hypot(offset[0], offset[2]))
    phi0 = float(np.arctan2(offset[0], offset[2]))
    root, ext = os.path.splitext(args.out)
    total = Timer().start()
    for i in range(n):
        phi = phi0 + 2.0 * np.pi * i / n
        origin = center + np.asarray([radius * np.sin(phi), offset[1], radius * np.cos(phi)])
        s = scene.replace(camera=dataclasses.replace(
            cam, origin=torch.as_tensor(origin, dtype=cam.origin.dtype, device=device)))
        with torch.no_grad():
            img = render_image_jit(s, cfg).cpu().numpy()
        if is_main():
            write_png(f"{root}_{i:03d}{ext}", img)
    secs = total.stop()
    rays = rays_per_frame(cfg, scene) * n
    main_print(f"[render] turntable {n} frames in {secs:.2f}s ({secs / n * 1e3:.0f} ms/frame "
               f"incl. PNG IO, {mrays_per_sec(rays, secs):.2f} Mrays/s) on {_where(device)} "
               f"-> {root}_NNN{ext}")


def _render_progressive(args, device, scene, cfg):
    """Coarse-to-fine: level k renders at 1/2^k of the resolution (at least
    8 pixels a side) with 1 spp as one block (block_size 0) and writes an
    upscaled preview; the last frame is the full one. The previews cost at
    most 1/3 of the full frame's primary rays."""
    from tpu_ray_torch.dist.multihost import is_main, main_print
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.utils.image_io import write_png
    from tpu_ray_torch.utils.metrics import Timer, mrays_per_sec, rays_per_frame

    levels = args.progressive
    root, ext = os.path.splitext(args.out)
    total = Timer().start()
    for k in range(levels, 0, -1):
        w, h = max(cfg.width >> k, 8), max(cfg.height >> k, 8)
        with torch.no_grad():
            img = render_image_jit(scene, cfg.replace(width=w, height=h, spp=1, block_size=0))
        up = img.cpu().numpy().repeat(1 << k, axis=0).repeat(1 << k, axis=1)
        path = f"{root}_prog{levels - k}{ext}"
        if is_main():
            write_png(path, up[:cfg.height, :cfg.width])
        main_print(f"[render] progressive level {levels - k}: {w}x{h} -> {path}")
    with torch.no_grad():
        img = render_image_jit(scene, cfg).cpu().numpy()
    if is_main():
        write_png(args.out, img)
    secs = total.stop()
    main_print(f"[render] progressive final {cfg.width}x{cfg.height} spp={cfg.spp} total "
               f"{secs:.2f}s ({mrays_per_sec(rays_per_frame(cfg, scene), secs):.2f} Mrays/s "
               f"over the full sequence) on {_where(device)} -> {args.out}")


def _device(args) -> torch.device:
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpu_ray_torch: no CUDA device; pass --device cpu to "
                         "run the plain PyTorch versions on the CPU")
    return device


def _device_and_scene(args):
    """(device, scene, cfg, processes). With --sharded, join the process
    group torchrun describes (gloo on the CPU, NCCL between cards, one card
    per process: cuda:LOCAL_RANK)."""
    from tpu_ray_torch.dist.multihost import initialize, world

    device = _device(args)
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
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.scene.types import get_param

    if "sdf.mb_power" in trainable and scene.sdf.mb_pow8:
        # as fit does: the power-8 field would render the target without
        # the perturbed power
        scene = scene.replace(sdf=scene.sdf.replace(mb_pow8=False))
    perturbed = {p: get_param(scene, p) * 1.15 + 0.02 for p in trainable}
    moved = _maybe_refit(apply_params(scene, perturbed),
                         any(p.split(".")[0] == "mesh" for p in trainable))
    with torch.no_grad():
        return render_image_jit(moved, cfg)


def cmd_fit(args):
    import torch.distributed as dist

    from tpu_ray_torch.dist.multihost import is_main, main_print
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.utils.config import FitConfig
    from tpu_ray_torch.utils.image_io import read_png, write_png

    device, scene, cfg, n_proc = _device_and_scene(args)
    if args.target:
        target = torch.as_tensor(read_png(args.target), dtype=scene.camera.origin.dtype,
                                 device=device)
        if tuple(target.shape) != (cfg.height, cfg.width, 3):
            raise SystemExit(f"tpu_ray_torch: --target {args.target} is "
                             f"{target.shape[1]}x{target.shape[0]}, the frame "
                             f"{cfg.width}x{cfg.height}")
    else:
        target = demo_target(scene, cfg, args.trainable)
    # the data-parallel step over the process group, when there is one
    group = dist.group.WORLD if args.sharded and dist.is_initialized() else None
    t0 = time.perf_counter()
    fitted, history = fit(scene, cfg, target, args.trainable,
                          FitConfig(steps=args.steps, learning_rate=args.lr,
                                    checkpoint_dir=args.checkpoint_dir),
                          verbose=is_main(), group=group)
    main_print(f"[fit] {len(history)} steps of {args.scene} {cfg.width}x{cfg.height} "
               f"spp={cfg.spp} on {_where(device)}"
               f"{f' x {n_proc} processes' if args.sharded else ''}: "
               f"{time.perf_counter() - t0:.2f} s")
    main_print(f"[fit] final loss {history[-1]:.3e}" if history else
               "[fit] checkpoint already at the requested step count; nothing to do")
    if args.out and is_main():
        with torch.no_grad():
            write_png(args.out, render_image_jit(fitted, cfg).cpu().numpy())
        print(f"[fit] wrote {args.out}")


def cmd_bench(args):
    from tpu_ray_torch.bench import run_bench

    print(json.dumps(run_bench(args.scene, backward=not args.forward_only,
                               device=args.device or "cuda")), flush=True)


def cmd_gradcheck(args):
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf, cuda_shade
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.scene.types import get_param
    from tpu_ray_torch.utils.gradcheck import (CARD_RTOL, card_grad_check, check_grad,
                                               gradcheck_config, mse_loss)

    device = _device(args)
    if device.type != "cpu":
        print(f"[gradcheck] float64 runs on CPU tensors only (the kernels take float32): "
              f"the finite-difference check runs on the CPU, then the card's float32 "
              f"gradient is held against it on {_where(device)}")
    cpu = torch.device("cpu")
    scene, cfg = build_scene(args.scene, device=cpu, dtype=torch.float64)
    fd_cfg = gradcheck_config(cfg)
    with torch.no_grad():
        target = render_image(scene, fd_cfg) + 0.1
    failures = []
    for path in args.trainable:
        try:
            check_grad(mse_loss(scene, fd_cfg, target, path), get_param(scene, path),
                       eps=1e-5, rtol=args.rtol)
            print(f"[gradcheck] {path}: OK")
        except AssertionError as e:
            failures.append(path)
            print(f"[gradcheck] {path}: FAIL — {e}")
    if device.type != "cpu":
        card_cfg = fd_cfg.replace(eps=cfg.eps)  # the scene's own float32 eps
        with torch.no_grad():
            card_target = render_image(scene, card_cfg) + 0.1
        for table in (cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES):
            for k in table:
                table[k] = 0
        for path in args.trainable:
            r = card_grad_check(scene, card_cfg, path, card_target, device)
            print(f"[gradcheck] card {path}: {'OK' if r['ok'] else 'FAIL'} — float32 "
                  f"{np.array2string(r['g32'].ravel(), precision=6)} float64 "
                  f"{np.array2string(r['g64'].ravel(), precision=6)} max|diff| / max|g64| "
                  f"{r['rel_err']:.3e} (rtol {CARD_RTOL})")
            if not r["ok"]:
                failures.append(f"card {path}")
        launched = {k: v for t in (cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES)
                    for k, v in t.items() if v}
        print(f"[gradcheck] card launches: {json.dumps(launched)}")
    if failures:
        sys.exit(1)


def cmd_scenes(args):
    device = _device(args)
    for name in scene_names():
        scene, cfg = build_scene(name, device=device)
        print(f"{name:12s} {cfg.width}x{cfg.height} spp={cfg.spp} method={cfg.method} "
              f"tris={scene.mesh.num_tris} sdf_prims={scene.sdf.num_primitives}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_ray_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a registry scene to PNG")
    r.add_argument("--scene", default="mixed", choices=scene_names())
    r.add_argument("--out", default="render.png")
    r.add_argument("--device", help="cuda (the default) or cpu")
    r.add_argument("--sharded", action="store_true",
                   help="pixel-parallel over the processes torchrun starts")
    r.add_argument("--stats", action="store_true",
                   help="print the frame's ray statistics (hit rate, march steps)")
    r.add_argument("--turntable", type=int, metavar="N",
                   help="render N frames orbiting the scene (out gets _000.. suffixes)")
    r.add_argument("--progressive", type=int, metavar="K",
                   help="K coarse previews (half the resolution each), then the full frame")
    r.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of the frame to DIR/trace.json, "
                        "with the program's render.* spans and, on the card, its "
                        "trace_stage_* markers")
    _add_cfg_flags(r)
    r.set_defaults(fn=cmd_render)
    f = sub.add_parser("fit", help="inverse-render: recover perturbed scene leaves")
    f.add_argument("--scene", default="sphere", choices=scene_names())
    f.add_argument("--trainable", nargs="+", default=["sdf.sph_radius"])
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=1e-2)
    f.add_argument("--target", help="target PNG (default: the demo target)")
    f.add_argument("--checkpoint-dir", help="resume from and save checkpoints to DIR")
    f.add_argument("--out", help="PNG of the fitted scene")
    f.add_argument("--device", help="cuda (the default) or cpu")
    f.add_argument("--sharded", action="store_true",
                   help="data-parallel over the processes torchrun starts")
    _add_cfg_flags(f)
    f.set_defaults(fn=cmd_fit)
    b = sub.add_parser("bench", help="Mrays/s benchmark (one JSON line)")
    b.add_argument("--scene", default="mandelbulb", choices=scene_names())
    b.add_argument("--forward-only", action="store_true")
    b.add_argument("--device", help="cuda (the default) or cpu")
    b.set_defaults(fn=cmd_bench)
    g = sub.add_parser("gradcheck", help="finite-difference gradient check (float64 on "
                                         "the CPU), then the card's float32 gradient")
    g.add_argument("--scene", default="sphere", choices=scene_names())
    g.add_argument("--trainable", nargs="+",
                   default=["sdf.sph_radius", "camera.origin", "materials.albedo"])
    g.add_argument("--rtol", type=float, default=2e-3)
    g.add_argument("--device", help="cuda (the default) or cpu: float64 always runs on "
                                    "the CPU; cuda adds the card's float32 check")
    g.set_defaults(fn=cmd_gradcheck)
    sc = sub.add_parser("scenes", help="list the registry's scenes")
    sc.add_argument("--device", help="cuda (the default) or cpu")
    sc.set_defaults(fn=cmd_scenes)
    args = ap.parse_args(argv)
    try:
        args.fn(args)
    finally:
        from tpu_ray_torch.dist.multihost import destroy

        destroy()  # the graphs that captured its collectives first


if __name__ == "__main__":
    sys.exit(main())
