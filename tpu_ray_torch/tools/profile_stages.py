"""Time by cumulative stage of a registry scene's frame on one device
(counterpart of `tools/profile_stages.py`).

    python -m tpu_ray_torch.tools.profile_stages [scene] [--device cpu]

Each stage is a pipeline over the whole frame with the block structure
render_pixels_flat gives it: the samples in render_image's Morton order,
padded with the last sample to whole blocks, the primary march once per
group of render.MARCH_GROUP blocks (march_group), each block taking its
slice. The stages, each the one before plus:

  march           march_group, a launch per group
  march+mesh      the mesh closest hit of each block, seeded with the SDF t
  +reconstruct    shadow_ray_origins: the values-only reconstruct of the
                  hits and the shadow rays' origins, plain PyTorch op by op
  geometry(all)   geometry_residuals whole: the shadow marches and any-hits
  full fwd        render_image under no_grad
  fwd+bwd         mean(render_image(apply_params(scene, p), cfg_b)**2)
                  .backward() for the bench's trainables (bench.backward_config)

Every stage reduces its outputs to sums (fwd+bwd: the loss and each
gradient's norm), which it reports. For each stage:
the frame's wall time (host clock, synchronized, after a warm-up on a
160x90 cut of the frame; the best of 2 runs, of 1 for frames of
bench.PERSISTENT_BELOW_RAYS rays or more), its increment over the stage
before, the cumulative Mrays/s (the bench's ray count), each kernel's
launches over the frame; and over one window of one march group (the
frame's middle group), run once untimed by the profiler and once under
torch.profiler: the host ms a block, device ms a block, the busy share
(the profiled window's union of device intervals over its own wall),
CUDA kernel launches a block, host ops a block (aten operators called from
outside another one), each hand-written kernel's device time and the
device time by the program's stages (tools.stage_ms; fwd+bwd marks its
backward `vjp.backward`).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from tpu_ray_torch import tools
from tpu_ray_torch.bench import (PERSISTENT_BELOW_RAYS, backward_config, bench_trainables,
                                 require_device)
from tpu_ray_torch.fit import apply_params, extract_params
from tpu_ray_torch.kernels import cuda_shade
from tpu_ray_torch.render import render as R
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.utils import metrics
from tpu_ray_torch.utils.metrics import rays_per_frame

STAGES = ("march", "march+mesh", "+reconstruct", "geometry(all)", "full fwd", "fwd+bwd")
# the warm-up frame's cut: every code path of the stage once (eager PyTorch
# compiles nothing per shape; the kernels build once a process)
WARM = dict(width=160, height=90)


@dataclasses.dataclass
class Frame:
    """A frame's samples as render_image hands them to render_pixels_flat
    and as that splits them (render.frame_samples, render.whole_blocks):
    xs, ys padded to whole blocks of bs, in the march groups of
    render.march_groups."""

    scene: object
    cfg: object
    method: str
    xs: torch.Tensor
    ys: torch.Tensor
    bs: int

    @property
    def sdf(self) -> bool:
        return R._use_sdf(self.scene, self.method)

    @property
    def n_blocks(self) -> int:
        return self.xs.shape[0] // self.bs

    @property
    def groups(self) -> list:
        return R.march_groups(self.xs.shape[0], self.bs)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group(self, g: int):
        """The samples of march group g (its last may hold fewer blocks)."""
        sl = self.groups[g]
        return self.xs[sl], self.ys[sl]

    def blocks_of(self, g: int) -> int:
        return self.group(g)[0].shape[0] // self.bs


def frame_of(scene, cfg) -> Frame:
    """The frame of (scene, cfg) split into blocks as render_image splits
    it."""
    scene, xs, ys, _perm = R.frame_samples(scene, cfg)
    xs, ys, bs = R.whole_blocks(cfg, xs, ys)
    return Frame(scene, cfg, R.resolve_method(scene, cfg), xs, ys, bs)


def block_outputs(stage: str, fr: Frame, o, d, march, packed, mesh_rows) -> dict:
    """One block's outputs at a geometry stage (march+mesh, +reconstruct,
    geometry(all)), per ray. march: the block's slice of march_group's
    result (None without an SDF)."""
    scene, cfg, method = fr.scene, fr.cfg, fr.method
    if stage == "geometry(all)":
        res = R.geometry_residuals(scene, cfg, o, d, method, mesh_rows=mesh_rows,
                                   march=march, packed=packed)
        return {k: v for k, v in res.items() if k != "hits"}
    res, t_seed = {}, None
    if march is not None:
        t, hit, _steps, tmin = march
        res.update(sdf_t=t, sdf_hit=hit, sdf_tmin=tmin)
        if method == "mixed":  # as geometry_residuals seeds the mesh walk
            t_seed = torch.where(hit, t, torch.full_like(t, cfg.t_far))
    if R._use_mesh(scene, method):
        res["mesh_tri"], res["mesh_hit"] = R._mesh_intersect(scene, cfg, o, d, method,
                                                             t_init=t_seed)
    out = {k: res[k] for k in ("sdf_t", "sdf_tmin", "mesh_tri", "mesh_hit") if k in res}
    ao_mesh = cfg.ao == "sdf5" and R._use_mesh(scene, method)
    if stage == "+reconstruct" and (cfg.shadow != "none" or ao_mesh):
        _hits, out["p_off"], out["n"], _live = R.shadow_ray_origins(
            scene, cfg, o, d, res, method, mesh_rows=mesh_rows, aux_out={})
    return out


def _add(sums: dict, outputs: dict) -> None:
    for k, v in outputs.items():
        sums[k] = sums.get(k, 0.0) + v.sum(dtype=torch.float64)


@torch.no_grad()
def geometry_stage(stage: str, fr: Frame, groups) -> dict:
    """march, march+mesh, +reconstruct or geometry(all) over the march
    groups `groups` -> the sums of its outputs. The parameters are packed
    and the mesh table made once, as render_pixels_flat makes them."""
    scene, cfg, bs = fr.scene, fr.cfg, fr.bs
    packed = cuda_shade.pack(scene, R._bound_pad(cfg))
    mesh_rows = R.mesh_table(scene.mesh) if R._use_mesh(scene, fr.method) else None
    sums = {}
    for g in groups:
        gx, gy = fr.group(g)
        marched = R.march_group(scene, cfg, gx, gy, packed, bs) if fr.sdf else None
        if stage == "march":
            if marched is not None:
                _add(sums, {"sdf_t": marched[0], "sdf_tmin": marched[3]})
            continue
        for s in range(0, gx.shape[0], bs):
            o, d = generate_rays(scene.camera, gx[s:s + bs], gy[s:s + bs], cfg.width,
                                 cfg.height)
            block = None if marched is None else tuple(v[s:s + bs] for v in marched)
            _add(sums, block_outputs(stage, fr, o, d, block, packed, mesh_rows))
    return sums


def run_stage(stage: str, fr: Frame, groups=None) -> dict:
    """One stage over the whole frame (groups None: full fwd and fwd+bwd
    through render_image) or over the given march groups (the last two
    through render_pixels_flat on each group's samples) -> its sums. For
    fwd+bwd, fr is the frame of the backward's config."""
    if stage not in ("full fwd", "fwd+bwd"):
        return geometry_stage(stage, fr, range(fr.n_groups) if groups is None else groups)

    def image(scene):
        if groups is None:
            return R.render_image(scene, fr.cfg)
        return torch.cat([R.render_pixels_flat(scene, fr.cfg, *fr.group(g)) for g in groups], 1)

    if stage == "full fwd":
        with torch.no_grad():
            return {"image": image(fr.scene).sum(dtype=torch.float64)}
    params = extract_params(fr.scene, bench_trainables(fr.scene))
    loss = torch.mean(image(apply_params(fr.scene, params)) ** 2)
    with metrics.stage("vjp.backward", loss.device):  # the eager backward's device work
        loss.backward()
    return {"loss": loss.detach(), **{f"|d {p}|": v.grad.double().norm()
                                      for p, v in params.items()}}


def profile(scene, cfg, device, iters=None, log=print) -> dict:
    """Every stage over the frame of (scene, cfg) -> the report (see the
    module's doc); log gets its lines."""
    fr = frame_of(scene, cfg)
    fr_b = frame_of(scene, backward_config(cfg))
    rays = rays_per_frame(cfg, fr.scene)
    if iters is None:
        iters = 1 if rays >= PERSISTENT_BELOW_RAYS else 2
    warm = {s: frame_of(scene, c.replace(width=min(c.width, WARM["width"]),
                                         height=min(c.height, WARM["height"])))
            for s, c in (("fwd", cfg), ("bwd", fr_b.cfg))}
    info = tools.card(device)
    g = fr.n_groups // 2
    head = (f"{cfg.width}x{cfg.height} spp{cfg.spp}, {rays} rays ({cfg.num_rays} primary), "
            f"{fr.n_blocks} blocks of {fr.bs} in {fr.n_groups} groups of "
            f"{R.MARCH_GROUP}, method={fr.method}; timed {iters}x after a "
            f"{warm['fwd'].cfg.width}x{warm['fwd'].cfg.height} warm-up; window: group {g}")
    log(f"[profile_stages] {head} {tools.card_line(info)}")
    report, prev = [], 0.0
    for stage in STAGES:
        f, w = (fr_b, warm["bwd"]) if stage == "fwd+bwd" else (fr, warm["fwd"])
        sums, sec, launches = tools.timed(lambda: run_stage(stage, f), device, iters,
                                          warm=lambda: run_stage(stage, w))
        gw = f.n_groups // 2
        win = tools.per_block(tools.window(lambda: run_stage(stage, f, [gw]), device)[0],
                              f.blocks_of(gw))
        row = {"stage": stage, "seconds": sec, "increment": sec - prev,
               "mrays_cumulative": rays / sec / 1e6,
               "sums": {k: float(v) for k, v in sums.items()},
               "launches": launches,
               "window": dict(win, group=gw, rays=f.blocks_of(gw) * f.bs)}
        report.append(row)
        log(f"  {stage:<16} {sec:8.3f}s  (+{sec - prev:8.3f}s)  "
            f"{row['mrays_cumulative']:6.2f} Mrays/s cumulative; launches a frame "
            f"{row['launches']}; window of {win['blocks']} blocks: {tools.window_line(win)}")
        prev = sec
    return {"tool": "profile_stages", "resolution": f"{cfg.width}x{cfg.height}", "spp": cfg.spp,
            "rays_per_frame": rays, "primary_rays": cfg.num_rays, "blocks": fr.n_blocks,
            "block_size": fr.bs, "march_group": R.MARCH_GROUP, "groups": fr.n_groups,
            "method": fr.method, "iters": iters, "window_group": g, **info,
            "stages": report}


def main(scene_name: str = "mixed", device="cuda") -> dict:
    from tpu_ray_torch.scene.scenes import build_scene

    device = require_device(device, "tpu_ray_torch.tools.profile_stages")
    scene, cfg = build_scene(scene_name, device=device)
    out = dict(profile(scene, cfg, device), scene=scene_name)
    tools.emit(out)
    return out


def cli(argv=None):
    ap = tools.parser("profile_stages", __doc__)
    ap.add_argument("scene", nargs="?", default="mixed")
    args = ap.parse_args(argv)
    main(args.scene, args.device)


if __name__ == "__main__":
    sys.exit(cli())
