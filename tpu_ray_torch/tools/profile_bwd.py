"""The backward of a registry scene's frame, split by trainable subset and
by one-block pieces (counterpart of `tools/profile_bwd.py`).

    python -m tpu_ray_torch.tools.profile_bwd [scene] [subset ...] [--device cpu]

1. the full forward (render_image under no_grad);
2. forward + backward of mean(render_image(apply_params(scene, p),
   cfg_b)**2) for each trainable subset the scene has (the subset names
   given after the scene filter them): `all` the bench's six, `no-verts`
   without mesh.verts (no corner-gather backward, no triangle-to-vertex
   conversion), `verts-only`, `albedo-only` (the shade backward kernel and
   the ray generation's backward alone). verts-only minus albedo-only is
   what the vertex gradient's gathers cost inside the frame;
3. one-block pieces on the frame's first block (render_image's Morton
   order), its geometry residuals made once: the shade forward + backward
   (to the parameters and the per-frame mesh table), the shade forward,
   and the geometry pass alone, each times the frame's block count;
4. one profiled window (tools.window) of the frame's middle march group,
   forward and backward of mean(colours**2) for the `all` subset through
   the per-block CUDA graphs (render.graphs.render_pixels_flat_jit, as the
   benchmark's traced fit window runs them), after a call that captures
   them: device ms a block by the program's stages, the vjp graph's
   `vjp.forward`, `vjp.backward`, `vjp.accumulate` among them.

Times: host clock, synchronized, after a warm-up on a 160x90 cut of the
frame; the frame's the best of 2 runs (3 for the subsets), of 1 for frames
of bench.PERSISTENT_BELOW_RAYS rays or more (so that `mixed` fits a 1200 s
call); the pieces' the best of 5. With each, the kernels' launches.
"""

from __future__ import annotations

import sys

import torch

from tpu_ray_torch import tools
from tpu_ray_torch.bench import (BENCH_TRAINABLES, PERSISTENT_BELOW_RAYS, backward_config,
                                 has_param, require_device)
from tpu_ray_torch.fit import apply_params, extract_params
from tpu_ray_torch.render import graphs
from tpu_ray_torch.render import render as R
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.tools.profile_stages import WARM, frame_of
from tpu_ray_torch.utils.metrics import rays_per_frame

SUBSETS = {"all": BENCH_TRAINABLES,
           "no-verts": tuple(p for p in BENCH_TRAINABLES if p != "mesh.verts"),
           "verts-only": ("mesh.verts",),
           "albedo-only": ("materials.albedo",)}
PIECE_ITERS = 5


def subsets(scene, only=()) -> dict:
    """{subset: its paths the scene has}, the subsets named in `only` (all
    when empty), those with no path left out."""
    out = {}
    for tag, paths in SUBSETS.items():
        if only and tag not in only:
            continue
        paths = [p for p in paths if has_param(scene, p)]
        if paths:
            out[tag] = paths
    return out


def fwd_bwd(scene, cfg, paths) -> dict:
    """mean(render_image(apply_params(scene, p), cfg)**2).backward() ->
    the gradients."""
    params = extract_params(scene, paths)
    torch.mean(R.render_image(apply_params(scene, params), cfg) ** 2).backward()
    return {p: v.grad for p, v in params.items()}


def first_block(scene, cfg):
    """The frame's first block as render_pixels_flat renders it -> (the
    realized scene, o, d, the frame's block count)."""
    fr = frame_of(scene, cfg)
    with torch.no_grad():
        o, d = generate_rays(fr.scene.camera, fr.xs[:fr.bs], fr.ys[:fr.bs], cfg.width,
                             cfg.height)
    return fr.scene, o, d, fr.n_blocks


def pieces(scene, cfg, device, log=print) -> dict:
    """The one-block pieces on the first block of the frame of (scene,
    cfg) -> ms a block and seconds a frame of each."""
    scene, o, d, n_blocks = first_block(scene, cfg)
    method = R.resolve_method(scene, cfg)
    rows, packed = R.frame_tables(scene, cfg, method)
    res = R.geometry_residuals(scene, cfg, o, d, method, mesh_rows=rows, packed=packed)
    paths = [p for p in BENCH_TRAINABLES if has_param(scene, p)]

    def shade_fwd_bwd():
        params = extract_params(scene, paths)
        table = None if rows is None else rows.detach().requires_grad_(True)
        img = R.shade_with_residuals(apply_params(scene, params), cfg, o, d, res, method,
                                     mesh_rows=table, packed=packed)
        torch.mean(img ** 2).backward()
        return [v.grad for v in params.values() if v.grad is not None] + (
            [] if table is None else [table.grad])

    @torch.no_grad()
    def shade_fwd():
        return torch.mean(R.shade_with_residuals(scene, cfg, o, d, res, method,
                                                 mesh_rows=rows, packed=packed) ** 2)

    @torch.no_grad()
    def geometry():
        g = R.geometry_residuals(scene, cfg, o, d, method, mesh_rows=rows, packed=packed)
        return sum(v.sum(dtype=torch.float64) for k, v in g.items() if k != "hits")

    out = {}
    for tag, fn in (("shade fwd+bwd", shade_fwd_bwd), ("shade fwd", shade_fwd),
                    ("geometry", geometry)):
        _, sec, launches = tools.timed(fn, device, PIECE_ITERS)
        out[tag] = {"ms_a_block": sec * 1e3, "blocks": n_blocks, "seconds_a_frame": sec * n_blocks,
                    "launches": launches}
        extra = ""
        if tag == "shade fwd":
            inc = out["shade fwd+bwd"]["ms_a_block"] - sec * 1e3
            out[tag]["bwd_increment_ms_a_block"] = inc
            extra = f"  (bwd increment {inc:.2f} ms/block)"
        log(f"one-block {tag:<16} {sec * 1e3:8.2f} ms x {n_blocks} blocks = "
            f"{sec * n_blocks:6.3f}s{extra}; launches {launches}")
    out["rays_a_block"] = int(o.shape[0])
    return out


def graphed_window(scene, cfg, device, log=print) -> dict:
    """Item 4 of the module's doc on the frame of (scene, cfg) -> the
    window a block (tools.per_block) and its march group."""
    fr = frame_of(scene, cfg)
    g = fr.n_groups // 2
    xs, ys = fr.group(g)
    params = extract_params(fr.scene, [p for p in BENCH_TRAINABLES if has_param(fr.scene, p)])

    def fwd_bwd():
        px = graphs.render_pixels_flat_jit(apply_params(fr.scene, params), fr.cfg, xs, ys)
        torch.mean(px ** 2).backward()

    fwd_bwd()  # captures the plan's graphs
    win = tools.per_block(tools.window(fwd_bwd, device)[0], fr.blocks_of(g))
    log(f"graphed fwd+bwd, group {g} ({win['blocks']} blocks): {tools.window_line(win)}")
    return dict(win, group=g)


def profile(scene, cfg, device, only=(), iters=None, log=print) -> dict:
    """The frame's forward, each subset's forward + backward and the
    one-block pieces -> the report (see the module's doc)."""
    rays = rays_per_frame(cfg, scene)
    big = rays >= PERSISTENT_BELOW_RAYS
    fwd_iters, sub_iters = (1, 1) if big else (2, 3)
    if iters is not None:
        fwd_iters = sub_iters = iters
    cfg_b = backward_config(cfg)
    cut = dict(width=min(cfg.width, WARM["width"]), height=min(cfg.height, WARM["height"]))
    info = tools.card(device)
    one = ": one timed run, a frame of 4M rays or more" if big else ""
    log(f"[profile_bwd] {cfg.width}x{cfg.height} spp{cfg.spp}, {rays} rays, "
        f"block {cfg_b.block_size or cfg.num_rays} (the backward's); frames timed "
        f"{fwd_iters}x, subsets {sub_iters}x{one} {tools.card_line(info)}")

    @torch.no_grad()
    def frame(c):
        return R.render_image(scene, c)

    _, fwd_s, fwd_launches = tools.timed(lambda: frame(cfg), device, fwd_iters,
                                         warm=lambda: frame(cfg.replace(**cut)))
    log(f"full fwd                     {fwd_s:8.3f}s  ({rays / fwd_s / 1e6:6.2f} Mrays/s); "
        f"launches {fwd_launches}")
    out = {"tool": "profile_bwd", "resolution": f"{cfg.width}x{cfg.height}", "spp": cfg.spp,
           "rays_per_frame": rays, **info, "fwd_iters": fwd_iters, "subset_iters": sub_iters,
           "fwd_seconds": fwd_s, "fwd_launches": fwd_launches, "subsets": {}}
    for tag, paths in subsets(scene, only).items():
        grads, sec, launches = tools.timed(
            lambda: fwd_bwd(scene, cfg_b, paths), device, sub_iters,
            warm=lambda: fwd_bwd(scene, cfg_b.replace(**cut), paths))
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values() if g is not None)
        out["subsets"][tag] = {"paths": paths, "seconds": sec, "over_fwd": sec - fwd_s,
                               "mrays": rays / sec / 1e6, "launches": launches,
                               "grads_finite": finite}
        log(f"fwd+bwd [{tag:<12}]        {sec:8.3f}s  (+{sec - fwd_s:6.3f}s"
            f" over fwd, {rays / sec / 1e6:6.2f} Mrays/s); launches {launches}")
    sub = out["subsets"]
    if "verts-only" in sub and "albedo-only" in sub:
        inc = sub["verts-only"]["seconds"] - sub["albedo-only"]["seconds"]
        n_blocks = frame_of(scene, cfg_b).n_blocks
        out["verts_over_albedo"] = {"seconds": inc, "ms_a_block": inc * 1e3 / n_blocks,
                                    "blocks": n_blocks}
        log(f"verts-only - albedo-only       {inc:8.3f}s a frame = {inc * 1e3 / n_blocks:.3f} "
            f"ms a block over {n_blocks} blocks (the vertex gradient's gathers)")
    out["pieces"] = pieces(scene, cfg_b, device, log)
    out["graphed_window"] = graphed_window(scene, cfg_b, device, log)
    return out


def main(scene_name: str = "mixed", only=(), device="cuda") -> dict:
    from tpu_ray_torch.scene.scenes import build_scene

    device = require_device(device, "tpu_ray_torch.tools.profile_bwd")
    scene, cfg = build_scene(scene_name, device=device)
    out = dict(profile(scene, cfg, device, only), scene=scene_name)
    tools.emit(out)
    return out


def cli(argv=None):
    ap = tools.parser("profile_bwd", __doc__)
    ap.add_argument("scene", nargs="?", default="mixed")
    ap.add_argument("only", nargs="*", metavar="subset", help=f"any of {list(SUBSETS)}")
    args = ap.parse_args(argv)
    main(args.scene, args.only, args.device)


if __name__ == "__main__":
    sys.exit(cli())
