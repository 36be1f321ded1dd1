"""Does the profiler's device time of the primary march (#1) and the mesh
walk (#3) inside the program's graph replays agree with CUDA events?

    python -m benchmark.profiler_check [--workload mixed.frames] [--reps 20]

On one traced slice of the cell (as a --trace 1 run takes it) it reads
each kernel's profiled time inside the graph replay, then launches the
same kernel eagerly on the same rays `reps` times, timed by CUDA events
(a spin kernel queued first, so the events time the device and not the
enqueue) and, in a second pass, under the profiler. One JSON line. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

from benchmark import harness, profile
from benchmark.loops import LOOPS


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, sub: str, reps: int) -> dict:
    """The profiled device ms of the kernel a launch, and of all the call's
    device operations a call (what the events time)."""
    traced = profile.trace(lambda: [fn() for _ in range(reps)], torch.device("cuda", 0))
    n, s = traced.kernel_time(sub)
    return {"kernel": 1e3 * s / max(n, 1),
            "all_ops": 1e3 * sum(d for _, _, d in traced.device) / 1e9 / reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.profiler_check")
    ap.add_argument("--workload", default="mixed.frames")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf
    from tpu_ray_torch.render.camera import generate_rays

    spec = harness.Spec(Path.cwd())
    w = spec.workload(args.workload)
    traffic = spec.traffic(w["traffic"])
    loop = LOOPS[traffic["loop"]](spec.config(w["config"]), traffic, 1, torch.device("cuda", 0))
    loop.setup()
    tr = loop.trace()
    cfg, scene = loop.cfg, loop.scene
    march_kernels = [d for n, _, d in sorted(tr.traced.kernels, key=lambda e: e[1])
                     if "march_kernel" in n]
    walks = [d for n, _, d in sorted(tr.traced.kernels, key=lambda e: e[1]) if "packet_kernel" in n]
    out = {"card": harness.power_limit(), "workload": args.workload,
           "graph_march_ms": [d / 1e6 for d in march_kernels],
           "graph_walk_ms_first_blocks": [d / 1e6 for d in walks[:4]]}
    scene = scene.replace(camera=dataclasses.replace(scene.camera, origin=loop.origin(0)))
    with torch.no_grad():
        n = min(tr.xs.shape[0], tr.bs * traffic["trace"]["slice_blocks"])
        ro, rd = generate_rays(scene.camera, tr.xs[:n], tr.ys[:n], cfg["width"], cfg["height"])
        kw = dict(t0=0.0, max_steps=cfg["max_steps"], eps=cfg["eps"], t_far=cfg["t_far"],
                  bound_pad=cfg["eps"])
        march = lambda: cuda_sdf.march(scene.sdf, ro, rd, **kw)  # noqa: E731
        out["eager_march_event_ms"] = event_ms(march, args.reps)
        out["eager_march_profiled_ms"] = profiled_ms(march, "march_kernel", args.reps)
        if walks:
            t, hit, _, _ = march()
            b = slice(0, tr.bs)
            seed_t = torch.where(hit[b], t[b], torch.full_like(t[b], cfg["t_far"]))
            ob, db = ro[b].contiguous(), rd[b].contiguous()
            walk = lambda: cuda_mt.intersect_packet_parts(  # noqa: E731
                scene.packet, ob, db, t_max=cfg["t_far"], sort_origin=ob[0], t_init=seed_t)
            out["eager_walk_event_ms"] = event_ms(walk, args.reps)
            out["eager_walk_profiled_ms"] = profiled_ms(walk, "packet_kernel", args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
