"""The port's benchmark: Mrays/s on one device, forward and forward +
backward (counterpart of `tpu_ray/bench_lib.py`).

    python -m tpu_ray_torch.bench [scene] [--forward-only] [--diff-vis] [--device cpu]

prints one JSON line. The metric is BASELINE.json's, "Mrays/sec/chip (fwd
and fwd+bwd) at 1080p": rays_per_frame (primary samples plus one shadow
ray per directional light per sample) over the best of `iters` timed
windows, after `warmup` untimed ones.

  * forward: `render_image_jit` under no_grad (the reference times its
    jitted frame), after the warm-up that captures its graphs.
  * forward + backward: mean(render_image_jit(apply_params(scene, params),
    cfg_b)**2).backward(), timed together, for the reference's six
    trainables that the scene has; cfg_b is the frame's config with
    diff_vis as asked and its block size capped at 65,536.
  * persistent: a frame of fewer than PERSISTENT_BELOW_RAYS rays is timed
    as the reference times it, over TURNTABLE_POSES camera origins on a
    circle about the y axis, one frame after another in one timed window,
    the time divided by their number. The backward's origin of each frame
    is the trainable origin plus that frame's offset, and each frame's
    mean(img**2) / TURNTABLE_POSES is differentiated in turn (its graph
    freed before the next frame's).

The device is the CUDA device unless the caller names another; a CUDA
run without a card stops with an error. The line names the device and,
on CUDA, its nvidia-smi power limit. vs_baseline is null: the
reference's baseline is its TPU's `BENCH_r*.json`, and no TPU number
carries over to this device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys

import torch

from tpu_ray_torch.utils.metrics import block_and_time, mrays_per_sec, rays_per_frame

# frames smaller than this are timed over the turntable (the reference's
# threshold, kept so that a small scene times the same frames here)
PERSISTENT_BELOW_RAYS = 4_000_000
TURNTABLE_POSES = 16
# the reference's backward bench trainables (mb_scale, not mb_power: the
# power-8 field hard-codes the exponent)
BENCH_TRAINABLES = ("sdf.sph_radius", "sdf.mb_scale", "camera.origin",
                    "materials.albedo", "lights.color", "mesh.verts")
BWD_BLOCK_CAP = 1 << 16


def turntable_origins(origin: torch.Tensor, k: int = TURNTABLE_POSES) -> torch.Tensor:
    """(k, 3) camera origins at the radius of `origin` about the y axis, at
    its height, angles 2 pi i / k from +z toward +x."""
    ang = torch.arange(k, dtype=torch.float64) * (2.0 * math.pi / k)
    o0 = origin.detach().cpu().double()
    r = torch.sqrt(o0[0] ** 2 + o0[2] ** 2)
    out = torch.stack([r * torch.sin(ang), o0[1].expand(k), r * torch.cos(ang)], -1)
    return out.to(device=origin.device, dtype=origin.dtype)


def has_param(scene, path: str) -> bool:
    from tpu_ray_torch.scene.types import get_param

    try:
        v = get_param(scene, path)
    except AttributeError:
        return False
    return isinstance(v, torch.Tensor) and v.numel() > 0


def power_limit(device: torch.device):
    """The card's power limit as nvidia-smi gives it ("700.00 W")."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    line = out.stdout.strip().splitlines()[device.index or 0]
    return line.rsplit(",", 1)[1].strip()


def bench_trainables(scene) -> list:
    """BENCH_TRAINABLES that the scene has, in their order."""
    return [p for p in BENCH_TRAINABLES if has_param(scene, p)]


def backward_config(cfg, diff_vis: bool = False):
    """The fit step's config of the backward bench: diff_vis as asked, the
    block capped at BWD_BLOCK_CAP rays."""
    cfg_b = cfg.replace(diff_vis=diff_vis)
    if cfg_b.block_size:
        cfg_b = cfg_b.replace(block_size=min(cfg_b.block_size, BWD_BLOCK_CAP))
    return cfg_b


def require_device(device, prog: str) -> torch.device:
    """torch.device(device); a CUDA device without a card stops the
    program (prog names it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; pass --device cpu to measure the "
                         "plain PyTorch versions on the CPU")
    return device


def _with_origin(scene, origin):
    return scene.replace(camera=dataclasses.replace(scene.camera, origin=origin))


def run_bench(scene_name: str = "mixed", backward: bool = True,
              warmup: int = 1, iters: int = 2,
              persistent: bool | None = None,
              diff_vis: bool = False, device="cuda") -> dict:
    """Measure one registry scene at its own config -> the JSON line's dict."""
    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.scene.scenes import build_scene

    device = require_device(device, "tpu_ray_torch.bench")
    scene, cfg = build_scene(scene_name, device=device)
    rays = rays_per_frame(cfg, scene)
    if persistent is None:
        persistent = rays < PERSISTENT_BELOW_RAYS
    k = TURNTABLE_POSES if persistent else 1
    o0 = scene.camera.origin
    origins = turntable_origins(o0) if persistent else o0[None]

    @torch.no_grad()
    def frames():
        return [render_image_jit(_with_origin(scene, org), cfg) for org in origins]

    _, fwd_k = block_and_time(frames, warmup=warmup, iters=iters)
    fwd_s = fwd_k / k
    on_cuda = device.type == "cuda"
    result = {
        "metric": f"Mrays_per_sec_per_chip_fwd_{scene_name}_{cfg.width}x{cfg.height}"
                  f"_spp{cfg.spp}",
        "value": round(mrays_per_sec(rays, fwd_s), 4),
        "unit": "Mrays/s/chip",
        "scene": scene_name,
        "resolution": f"{cfg.width}x{cfg.height}",
        "spp": cfg.spp,
        "rays_per_frame": rays,
        "fwd_seconds": round(fwd_s, 4),
        "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "power_limit": power_limit(device) if on_cuda else None,
        "chips_used": 1,
        "persistent_loop": bool(persistent),
    }

    if backward:
        trainable = bench_trainables(scene)
        cfg_b = backward_config(cfg, diff_vis)
        deltas = origins - o0

        def fwd_bwd():
            params = extract_params(scene, trainable)
            s = apply_params(scene, params)
            base = s.camera.origin
            for delta in deltas:
                img = render_image_jit(_with_origin(s, base + delta), cfg_b)
                (torch.mean(img ** 2) / k).backward()
            return {p: v.grad for p, v in params.items()}

        _, bwd_k = block_and_time(fwd_bwd, warmup=warmup, iters=max(iters - 1, 1))
        bwd_s = bwd_k / k
        result["fwdbwd_seconds"] = round(bwd_s, 4)
        result["mrays_fwdbwd"] = round(mrays_per_sec(rays, bwd_s), 4)
        result["backward_diff_vis"] = bool(diff_vis)
        result["trainables"] = trainable
    result["vs_baseline"] = None
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu_ray_torch.bench", description=__doc__.split("\n")[0])
    ap.add_argument("scene", nargs="?", default="mixed")
    ap.add_argument("--forward-only", action="store_true")
    ap.add_argument("--diff-vis", action="store_true",
                    help="the backward through the differentiable soft-shadow penumbra")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    result = run_bench(args.scene, backward=not args.forward_only, diff_vis=args.diff_vis,
                       device=args.device)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
