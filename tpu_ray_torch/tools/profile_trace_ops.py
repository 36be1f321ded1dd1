"""Top device and host ops of a traced forward or forward + backward of a
registry scene (counterpart of `tools/profile_trace_ops.py`, torch.profiler
in place of xprof).

    python -m tpu_ray_torch.tools.profile_trace_ops [scene] [fwd|bwd] [top_n]
        [--trace-dir DIR] [--device cpu]

After a warm-up on a 160x90 cut of the frame, one window is traced: whole
march groups of the frame's blocks, rendered group by group through
render_pixels_flat (profile_stages' `full fwd` and `fwd+bwd` over
groups): the frame's middle group for frames of
bench.PERSISTENT_BELOW_RAYS rays or more, every group below. `fwd` runs
under no_grad; `bwd` is mean(colors**2) over the window's pixels,
backward, for the bench's trainables at the backward's config. The Chrome
trace goes to --trace-dir (default build/trace_ops_<scene>_<mode>).
Printed: the window (blocks and rays of the frame's), the total device
self time, the device time by category (each hand-written kernel, the
other kernels, memcpy / memset), the top_n device ops by self time and
the top_n host ops by self CPU time, each with its count, the device
time by the program's stages (the work after each stage's marker,
tools.stage_ms) and the device's idle time by the program span that
holds it (tools.idle_by_span). The window runs once untraced first, for
its wall time; the busy share is the traced window's union of device
intervals over its own wall.
"""

from __future__ import annotations

import os
import sys
import time

from tpu_ray_torch import tools
from tpu_ray_torch.bench import PERSISTENT_BELOW_RAYS, backward_config, require_device
from tpu_ray_torch.tools.profile_stages import WARM, frame_of, run_stage
from tpu_ray_torch.utils.metrics import rays_per_frame

MODES = {"fwd": "full fwd", "bwd": "fwd+bwd"}


def report(win: dict, events, top_n: int = 40) -> dict:
    """A window's totals (tools.window -> win, events): device self time
    (all, by category, by stage, the top_n ops), the top_n host ops by
    self CPU time, each with its count, and the idle time by span."""
    device = [(name, ms, count) for name, (ms, count) in tools.device_totals(events).items()]
    host = [(name, ms, count) for name, (ms, count) in tools.host_self(events).items()]
    device.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return {"device_ms": win["device_ms"] or 0.0,
            "by_category": dict(sorted(win["by_category"].items(), key=lambda kv: -kv[1])),
            "top_device": [{"name": n, "ms": ms, "count": c} for n, ms, c in device[:top_n]],
            "host_ms": sum(ms for _, ms, _ in host),
            "top_host": [{"name": n, "self_ms": ms, "count": c} for n, ms, c in host[:top_n]],
            "host_ops": win["host_ops"], "stages": win["stages"], "idle": win["idle"]}


def print_report(rep: dict, log=print) -> None:
    total = rep["device_ms"]
    log(f"\ntotal device self time: {total / 1e3:.6f}s; host self time "
        f"{rep['host_ms'] / 1e3:.6f}s in {rep['host_ops']} host ops\n")
    log("== device time by category ==")
    for k, v in rep["by_category"].items():
        log(f"  {k:<40} {v / 1e3:10.6f}s  {100 * v / max(total, 1e-12):5.1f}%")
    log("\n== device time by stage ==")
    for k, v in rep["stages"].items():
        log(f"  {k:<40} {v / 1e3:10.6f}s  {100 * v / max(total, 1e-12):5.1f}%")
    if rep["idle"]:
        idle = rep["idle"]
        log(f"\n== device idle {idle['idle_ms'] / 1e3:.6f}s, {idle['in_spans_ms'] / 1e3:.6f}s "
            f"of it inside a program span, by the innermost ==")
        for k, v in list(idle["by_span"].items())[:10]:
            log(f"  {k:<40} {v / 1e3:10.6f}s")
    log(f"\n== top {len(rep['top_device'])} device ops by self time ==")
    for r in rep["top_device"]:
        log(f"  {r['ms'] / 1e3:10.6f}s  {r['count']:7d}x  {r['name'][:110]}")
    log(f"\n== top {len(rep['top_host'])} host ops by self CPU time ==")
    for r in rep["top_host"]:
        log(f"  {r['self_ms'] / 1e3:10.6f}s  {r['count']:7d}x  {r['name'][:110]}")


def capture(scene, cfg, mode: str, device, trace_dir: str, top_n: int = 40,
            log=print) -> dict:
    """Trace mode ("fwd" or "bwd") over a window of whole march groups of
    the frame of (scene, cfg) (see the module's doc) -> the window and its
    report."""
    stage = MODES[mode]
    fr = frame_of(scene, cfg if mode == "fwd" else backward_config(cfg))
    groups = ([fr.n_groups // 2] if rays_per_frame(cfg, scene) >= PERSISTENT_BELOW_RAYS
              else list(range(fr.n_groups)))
    blocks = sum(fr.blocks_of(g) for g in groups)
    warm = frame_of(scene, fr.cfg.replace(width=min(cfg.width, WARM["width"]),
                                          height=min(cfg.height, WARM["height"])))
    t0 = time.perf_counter()
    run_stage(stage, warm)
    tools.sync(device)
    log(f"[trace] warm {mode} on {warm.cfg.width}x{warm.cfg.height} = "
        f"{time.perf_counter() - t0:.3f}s")
    win, events = tools.window(lambda: run_stage(stage, fr, groups), device, trace_dir)
    info = tools.card(device)
    log(f"[trace] {mode} over groups {groups[0]}..{groups[-1]} of {fr.n_groups}: {blocks} of "
        f"the frame's {fr.n_blocks} blocks, {blocks * fr.bs} rays, wall "
        f"{win['wall_ms'] / 1e3:.3f}s ({win['profiled_wall_ms'] / 1e3:.3f}s under the "
        f"profiler) {tools.card_line(info)}; trace in {trace_dir}")
    return {"tool": "profile_trace_ops", "mode": mode, "resolution": f"{cfg.width}x{cfg.height}",
            "spp": cfg.spp, **info, "groups": [groups[0], groups[-1]], "window_blocks": blocks,
            "frame_blocks": fr.n_blocks, "window_rays": blocks * fr.bs,
            "wall_s": win["wall_ms"] / 1e3, "profiled_wall_s": win["profiled_wall_ms"] / 1e3,
            "busy": win["busy"], "trace_dir": trace_dir, **report(win, events, top_n)}


def main(scene_name: str = "mixed", mode: str = "bwd", top_n: int = 40, trace_dir=None,
         device="cuda") -> dict:
    from tpu_ray_torch.scene.scenes import build_scene

    device = require_device(device, "tpu_ray_torch.tools.profile_trace_ops")
    trace_dir = trace_dir or os.path.join("build", f"trace_ops_{scene_name}_{mode}")
    scene, cfg = build_scene(scene_name, device=device)
    out = dict(capture(scene, cfg, mode, device, trace_dir, top_n), scene=scene_name)
    print_report(out)
    tools.emit(out)
    return out


def cli(argv=None):
    ap = tools.parser("profile_trace_ops", __doc__)
    ap.add_argument("scene", nargs="?", default="mixed")
    ap.add_argument("mode", nargs="?", default="bwd", choices=list(MODES))
    ap.add_argument("top_n", nargs="?", type=int, default=40)
    ap.add_argument("--trace-dir", default=None,
                    help="where the Chrome trace goes (default build/trace_ops_<scene>_<mode>)")
    args = ap.parse_args(argv)
    main(args.scene, args.mode, args.top_n, args.trace_dir, args.device)


if __name__ == "__main__":
    sys.exit(cli())
