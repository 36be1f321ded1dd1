"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, the result line last
    python3 chip_smoke.py --only launch   # device, build and the named phases

Eight paths: the headline `mixed` scene (BASELINE config 5: hard shadows, a
mesh), the `mandelbulb` scene (config 4: soft shadows and 5-tap AO, its
fit step with diff_vis), `mixed_sil`: `mixed` with the soft SDF
silhouette and the mesh edge band (width 0.05 each), the silhouette-
gradient path, with the README's two silhouette fits; `mixed_ring`:
`mixed` with its accel partitioned around a ring of processes (of one,
in this script); `knot1m_parts`: the 1.05M-triangle knot split into
accel parts walked in sequence; `mandelbulb_power`: `mandelbulb` with
the generic-power field, as a `sdf.mb_power` fit runs it; `knot8m`: the
8.39M-triangle knot, the largest accel the reference supports; and `bunny`:
BASELINE config 3, its packet walks held against the uniform grid's DDA. Phases, each with its seconds (any failure exits non-zero and prints no result):
  1. device: a CUDA device must exist; its name and nvidia-smi power limit.
  2. build: the kernels from tpu_ray_torch/csrc with nvcc (sm_90a), one
     nvcc per source in parallel; ptxas' registers and spills, and one line
     (`ptxas of #1, #2, #5, #6`) with each build's registers, stack frame and
     spill stores and loads for the marches and the shade kernels; then the
     native packet-accel builder (tpu_ray_torch/native, g++).
  3. kernel parity on real rays: 4 blocks of the `mixed` frame in Morton
     order (those holding the bulb, the sphere, the knot and the ground in
     front) and the shadow rays the geometry pass makes from them; each
     kernel against its plain PyTorch version on the card, with times and
     bounds. The shade forward on the same rays and residuals (per-ray
     p99 < 1e-4, at most 0.1% over 1e-3), and the shade backward with a
     seeded cotangent: per parameter group, per ray, and bit equality of
     two runs; the backward again without shadows, which block every lane
     of the bulb's block, and both with the 5-tap AO (its Mandelbulb and
     mesh terms). The packet walks run once more with their counters
     (chunks staged, MT tests, the share of a staged chunk's rays that
     passed its box), logged beside their times. The primary march of each
     block's group of render.MARCH_GROUP blocks (as the frame runs it)
     against the block's own march, and every wrapper (the reconstruct
     too) given the parameters packed once against the same call packing
     its own: all bit-identical.
  3b. content: the shade forward timed on all-sky, all-bulb and all-mesh
     sets of 32,768 rays from those blocks.
  4. small frame: `mixed` at 320x180, 1 spp, kernel path against plain path:
     the image, and the gradient of mean(img**2) for the six trainables.
  5. the forward slice: `render_image` of `mixed` at 1920x1080, 16 spp,
     with every forward kernel's launch count over that one frame (the
     march once per group of render.MARCH_GROUP blocks, the others once a
     block); the PNG goes to build/.
  5b. graph_frame: the same frame through `render_image_jit` (per-block
     CUDA graphs, render/graphs.py): its first call (warm-up and capture,
     the graph pool's and the plan's memory), then a timed one with the
     launch counts from 0, which equal phase 5's; the image against phase
     5's (max abs <= 1e-6); a profiled window of the middle march group
     (32 blocks): busy share, launches and host ops a block.
  5c. sharded_graph_frame: the same frame through
     `dist.sharding.render_image_sharded_jit` in an NCCL group of one
     process (the frame's plan is 5b's, reused; the gather one captured
     all_gather_into_tensor): first call (capture), then timed with the
     launch counts from 0, which equal phase 5's; the image against 5b's
     (at most 1e-4 of the pixels off by more than 1e-4); capture seconds,
     the graph pools' GiB.
  6. the fit step: forward + backward of mean(img**2) at 1920x1080, 16 spp,
     for the six trainables: time, launch counts, peak memory, gradients.
  6b. graph_step: the same step through `render_image_jit`, after one step
     that captures its backward: time, launch counts (#5 twice a block, the
     others as phase 5b), loss and gradients against phase 6's (rel <= 1e-5
     a trainable, <= 1e-4 for mesh.verts).
  6c. sharded_graph_step: `fit.make_sharded_fit_step` (graphed: the frame's
     plan, then one captured graph of the bucketed all_reduces and the
     loss's) in an NCCL group of one, SGD at lr 0 toward a zero target:
     first step (capture), then timed; loss and gradients against 6b's
     (rel <= 1e-5, mesh.verts <= 1e-4), the launches 6b's.
  7. a fit: `fit()` for 3 Adam steps at 480x272, 16 spp, toward the CLI
     demo target, with the packet accel refit every step; the loss falls.
  8. `mandelbulb` parity: 2 blocks of its frame (the bulb's silhouette, the
     plane's penumbra): the march and the soft-shadow march against their
     plain versions, the soft march again on the `pointlight` frame's
     shadow rays (cut at the light's distance), the shade forward with AO,
     without and with the penumbra, and the shade backward with AO and the
     penumbra (diff_vis) against their plain versions, again with the
     point light's penumbra on the `pointlight` frame. Where the shade
     reads the Mandelbulb through the AO or the penumbra, the rays on which
     float32 rounding alone moves the plain version past the per-ray bound
     (found against its float64 evaluation, without the kernel) are set
     apart, at most 25% of them.
  9. `mandelbulb` small frame: 256x256x1, kernel path against plain path,
     the image and the gradient of its five trainables, without and with
     diff_vis, both without the frame's ill-conditioned rays (phase 8).
 10. `mandelbulb` frame: 1024x1024x4 with launch counts; the PNG to build/;
     10b. bulb_graph_frame: as 5b.
 11. `mandelbulb` fit step with diff_vis: time, launch counts, memory,
     gradients; 11b. bulb_graph_step: as 6b.
 12. `mixed_sil` parity: phase 3's kernels on its 4 blocks (the march with
     its bound cull padded, every lane's shadow ray) and both shade
     kernels with the silhouettes.
 13. `mixed_sil` small frame (as phase 4), 14. its frame (as phase 5) and
     15. its fit step (as phase 6) at 960x540x16, a quarter of the pixels,
     to keep the script well inside its time: 254 launches each of
     `shade_fwd` and `shade_bwd`.
 16. the silhouette fits: `tpu_ray_torch.examples.inverse_rendering` at
     256x256 (200 steps; the loss falls at least 10x) and
     `inverse_pose.main_silhouette` at 96x96 (hard visibility stalls, the
     mesh edge band brings |translate| from 0.1 below 0.01).
 17. resident_parity: TPU kernel #4 (the resident accel, supers visited
     front to back) against its plain version on phase 3's rays: the
     closest hit with sort_origin and the SDF seed, the shadow any-hit with
     sort_dir and 0-seeds (hits equal on >= 99.99%, t rtol 1e-5), timed
     beside kernel #3 on the same rays; then both unseeded over the ring's
     own shard, as phase 19 calls them (the `mixed_ring` entries).
 18. knot1m_parts: the 1.05M-triangle `knot1m` as one whole-mesh accel (#3)
     and as 6 parts of at most 12 MiB (#4, the running t threaded from part
     to part): #4 against its plain version part by part and the threaded
     parts against the whole mesh on 4,096 rays, #3 against its plain
     version, and both 1024x1024x1 frames (p99 pixel difference < 1e-5,
     at most 1e-4 of the pixels off by more than 1e-4)
     with their launches: 16 of each #3 kernel, 6 x 16 of each #4 kernel;
     #3 and #4 also timed on one block of the frame's launch size.
 19. ring_frame: `render_image_sharded(mixed, 960x540x16,
     scene_shards=True)` on a ring of one process (NCCL, world size 1), a
     quarter of phase 5's pixels, to keep the script well inside its time:
     254 launches of each #4 kernel, none of #3; the image against
     render_image's of the same frame (at most 1e-4 of the pixels off by
     more than 1e-4).
     19b. ring_graph_frame: the same through `render_image_sharded_jit`
     (the ring's walk inside each block's graph; at world size 1 it never
     rotates): bit-equal to phase 19's image, its launches.
 20. ring_fit_step: the data-parallel step on the same ring at 960x540x16,
     eagerly (make_sharded_fit_step's computation before it was graphed),
     the six trainables, the shard refit every step: loss (rel 1e-5) and
     gradients (cosine > 0.999999) against phase 6's computation on the same
     frame, 254 `shade_bwd` launches.
     20b. ring_graph_step: `make_sharded_fit_step` with the ring, graphed,
     as 6c, against phase 20's loss and gradients (#4 254 times each, #5
     508, #6 254).
 21. power_parity: phase 8's two `mandelbulb` blocks with the generic
     field (mb_pow8=False) at mb_power 8.0 and 7.5: the march, the soft
     march, the shade forward with AO (without and with the penumbra) and
     the shade backward with AO and the diff_vis penumbra, the
     `sdf.mb_power` group included, against their plain versions; timed at
     8.0 (the `mandelbulb_power` entries).
 22. power_frame: the `mandelbulb_power` frame at 1024x1024x4 (2 launches
     of `march`, 64 each of `shadow_soft` and `shade_fwd`), its diff_vis fit step
     for the five bulb trainables and `sdf.mb_power` (64 `shade_bwd`), and
     3 Adam steps of `fit()` from the registry's power-8 scene (which fit
     switches to the generic field) at 256x256x4 toward the CLI demo target
     of `sdf.mb_power`, the albedo and the light colour; the loss falls.
 23. launch: #1, #2, #3, #5 and #6 as render_pixels_flat launches them,
     once per block of the path's size (32,768 rays for `mixed` and
     `mixed_sil`, 65,536 for `mandelbulb` and `mandelbulb_power`), on each
     block of the path's parity points, and #4 as the ring calls it on the
     `mixed` blocks: the marches and the walks with the arguments the
     geometry pass gives them (recorded), the shade forward with the
     frame's config, the backward with the fit step's, and the values-only
     reconstruct (csrc/reconstruct.cu) on the call the geometry pass made,
     held there against its plain version (reconstruct_row: t, hit, p,
     mat and the masks bit-equal; the normals and shadow origins within
     1e-5 on >= 99% of the rays and 1e-4 on the hit rays, past either only
     where the float64 witness sides with the kernel; float64 rays raise).
     Per block:
     CUDA-event time of the wrapper's launch, the profiler's device time in
     the kernel and in the wrapper's tensor ops, the bound of that block's
     work, and the counters of #1 and #2 (live and marching rays, DE steps,
     lane efficiency, cycles a warp) and #6 (rays by chain class, warps
     that mix classes, cycles a warp by its costliest class, the
     reduction's cycles).
 24. bench_cli: `tpu_ray_torch.bench.run_bench("mandelbulb")` at its
     defaults (1024x1024x4, warmup 1, iters 2, forward + backward, through
     render_image_jit), its JSON line, and the launches of #1, #2 soft, #5
     and #6 over its 3 frames and 2 steps and its graphs' warm-ups (#5 twice
     a block in a step); the jitter draw (seed 3, 1024x1024x4) on the card against
     the CPU's, bit for bit, and the jittered 256x256x4 frame through the
     kernels against the plain path (phase 9's bound); `fit` on
     `mandelbulb` at 128x128x4, 4 steps straight against 2 and a resume
     from the checkpoint to 4 (parameters bit-identical); and the CLI's
     `render --stats` (`mixed` 512x512x1, graphed: the frame's and its
     warm-up's launches, then the stats' 2^18 rays in one launch each of #1
     and #3), `render --progressive 2` and `fit --target --checkpoint-dir`.
 25. knot8m: the 8,388,610-triangle knot (one whole-mesh accel part, 4,097
     supers, ~537 MB of corners): its host build natively and with numpy
     (the disk cache off) and the cached load, each timed and equal to the
     scene's accel; #3 closest and any-hit against their plain versions on
     KNOT8M_SAMPLE rays strided over the frame (hits equal on >= 99.99%, t
     rtol 1e-5, another triangle only on a tie), timed with the bound and
     the walk counters; on one 65,536-ray block, #3 at its launch size and
     the reconstruct's mesh-only branch and #5 against their plain
     versions, and the corner gather bit-equal to the indexing (timed); the
     1024x1024x1 frame through render_image_jit (captured block graphs)
     within 1e-6 of the eager one, with its launches (16 each of #3 closest
     and any-hit, the reconstruct, the corner gather and #5, nothing else),
     time and peak memory.
 26. grid_oracle: BASELINE config 3, `bunny` at 512x512 with its uniform
     grid: #3 closest-hit on every primary ray and any-hit on every live
     shadow ray against the grid's DDA (kernels/dda.py) under the same
     rule, the DDA's time on the card, #3 against its plain version on
     32,768 rays and at its launch size (the frame's one block of 262,144
     rays), and the frame's launches.
 27. gradcheck: `cli gradcheck` on the card under its device rule (the
     float64 finite-difference check on the CPU, then each trainable's
     float32 gradient through #1, #5 and #6 within 1e-3 of the float64
     one), and config 3's vertex check: <grad, V> on lit interior `bunny`
     triangles, finite differences against autograd in float64 on the CPU,
     then the card's float32 derivative (#3, #5, #6) within 1e-3 of it.
 28. inverse_lighting: tpu_ray_torch.examples.inverse_lighting at its
     defaults (256x256, 150 steps, diff_vis): the loss falls >= 10x; the
     light's position error and the launches of #1, #2 soft, #5 and #6.
 29. tools: the port's measurement tools (tpu_ray_torch/tools) on the card
     at a reduced size: bench_all's `sphere` row, and profile_stages,
     profile_bwd and profile_trace_ops (bwd) on `mixed` at 256x128x16
     (16 blocks, one march group): each stage's and subset's launches as
     the frame and the step launch them, every profiled window's device
     time within its wall time (0 < busy <= 1), every number finite.
 30. scatter: the corner gather and its backward, the vertex gradient's
     scatter by triangle (csrc/corner_scatter.cu), against their plain
     versions (the indexing and its autograd: torch's index backward) on
     tools.profile_scatter's `local` and `uniform` sets and on the middle
     block of `mixed` and of `mixed_sil` (each path's own row of the kernels
     line; `mixed_ring` shares `mixed`'s): each gradient entry within 1e-5 of the float64 sum
     relative to its terms' absolute sum, column 9 zero, two runs
     bit-identical, the gather bit-equal; device ms of each inside a CUDA
     graph (20 calls a graph), torch's index backward beside it (the
     `library_ms` yardstick), the plain version's host ms, the bound and
     the scatter's counters; then `mixed`'s graphed fit step of the six
     trainables twice: one scatter and two gathers a block, and the
     mesh.verts gradient bit-identical between the two.
Then the kernels as one JSON line (one entry per kernel and path, each
with its time, its plain version's time and the bound the card could not
beat for the same work, and its `launch_*` numbers; `mixed`'s,
`mandelbulb`'s and `mixed_ring`'s launches are those of the graphed frame
and step, phases 5b, 6b, 10b, 11b, 19b and 20b),
the card's name and power limit, and the result as the last line. With
--only, the per-launch table is the last line and no result is printed.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = "tpu_ray_torch/csrc"
REPLACES = {
    "march": "tpu_ray/kernels/pallas_sdf.py:223",
    "shadow_hard": "tpu_ray/kernels/pallas_sdf.py:328",
    "shadow_soft": "tpu_ray/kernels/pallas_sdf.py:328",  # soft mode, :393-415
    "packet_closest": "tpu_ray/kernels/pallas_mt.py:347",
    "packet_any_hit": "tpu_ray/kernels/pallas_mt.py:347",
    "resident_closest": "tpu_ray/kernels/pallas_mt.py:102",
    "resident_any_hit": "tpu_ray/kernels/pallas_mt.py:102",  # any_hit_packet, :589
    "shade_fwd": "tpu_ray/kernels/pallas_shade.py:510",
    "shade_bwd": "tpu_ray/kernels/pallas_shade.py:591",
    # no Pallas kernel: XLA fuses _sdf_from_res / _mesh_from_res
    "reconstruct": "tpu_ray/render/render.py:272-340",
    # no Pallas kernel: the corner gather, and XLA's transpose of it
    "corner_gather": "tpu_ray/render/render.py:615",
    "corner_scatter": "tpu_ray/render/render.py:615",
}
SOURCES = {"march": "sdf_march.cu", "shadow_hard": "sdf_march.cu",
           "shadow_soft": "sdf_march.cu", "packet_closest": "packet_mt.cu",
           "packet_any_hit": "packet_mt.cu", "resident_closest": "packet_mt.cu",
           "resident_any_hit": "packet_mt.cu", "shade_fwd": "shade_fwd.cu",
           "shade_bwd": "shade_bwd.cu", "reconstruct": "reconstruct.cu",
           "corner_gather": "corner_scatter.cu", "corner_scatter": "corner_scatter.cu"}
# the kernels each path runs, forward then backward
PATH_KERNELS = {"mixed": ("march", "shadow_hard", "packet_closest", "packet_any_hit",
                          "reconstruct", "corner_gather", "shade_fwd", "shade_bwd",
                          "corner_scatter"),
                "mandelbulb": ("march", "shadow_soft", "reconstruct", "shade_fwd", "shade_bwd"),
                "mixed_sil": ("march", "shadow_hard", "packet_closest", "packet_any_hit",
                              "reconstruct", "corner_gather", "shade_fwd", "shade_bwd",
                              "corner_scatter"),
                # `mixed` with its accel partitioned around a ring of processes
                "mixed_ring": ("march", "shadow_hard", "resident_closest", "resident_any_hit",
                               "reconstruct", "corner_gather", "shade_fwd", "shade_bwd",
                               "corner_scatter"),
                # the packet walks of the 1.05M-triangle knot: one whole-mesh
                # accel, and 6 parts under the budget
                "knot1m": ("packet_closest", "packet_any_hit"),
                "knot1m_parts": ("resident_closest", "resident_any_hit"),
                # `mandelbulb` with the generic-power field (mb_pow8=False)
                "mandelbulb_power": ("march", "shadow_soft", "reconstruct", "shade_fwd",
                                     "shade_bwd"),
                # the 8.39M-triangle knot: one whole-mesh accel of 4,097
                # supers, hard shadows, no SDF
                "knot8m": ("packet_closest", "packet_any_hit", "reconstruct", "corner_gather",
                           "shade_fwd"),
                # BASELINE config 3 at 512x512, held against the uniform grid's DDA
                "bunny": ("packet_closest", "packet_any_hit")}
# the backward's kernels (a fit step's; not a frame's)
BACKWARD = ("shade_bwd", "corner_scatter")
# the kernels the ring path shares with `mixed`, measured on the same rays
RING_SHARED = ("march", "shadow_hard", "reconstruct", "corner_gather", "shade_fwd", "shade_bwd",
               "corner_scatter")
# the silhouette-gradient path: `mixed` with both silhouettes (the README's
# fit width; VERDICT.md:180-187)
SILHOUETTES = dict(soft_silhouette=0.05, mesh_silhouette=0.05)
# the six trainables of the reference's backward bench (tpu_ray/bench_lib.py)
TRAINABLES = ("sdf.sph_radius", "sdf.mb_scale", "camera.origin",
              "materials.albedo", "lights.color", "mesh.verts")
# the bench's list filtered to the `mandelbulb` scene, plus the light
# direction, which only the diff_vis penumbra moves
BULB_TRAINABLES = ("sdf.mb_scale", "camera.origin", "materials.albedo",
                   "lights.color", "lights.direction")
# the generic-power path's fit step: the bulb's and its power
POWER_TRAINABLES = BULB_TRAINABLES + ("sdf.mb_power",)
# the published peaks of one H100 SXM: HBM bytes/s, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device time of a kernel wrapper over reps calls, after a warm-up.

    A spin kernel queued first keeps the device busy while the host
    enqueues the calls, so CUDA events time the device work and not the
    wrapper's host overhead, which exceeds a fast kernel's run time."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~60 ms at 1.7 GHz, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    """Host time of one call to a plain PyTorch version after a warm-up, with
    the device drained before and after: what the frame would pay for it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def frac_equal(a, b) -> float:
    return (a == b).float().mean().item()


def cosine(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def rel_max(a, b) -> float:
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) if b.numel() else 0.0


def reset(*tables) -> None:
    for table in tables:
        for k in table:
            table[k] = 0


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_scatter, cuda_sdf, cuda_shade

    reset(cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES, cuda_reconstruct.LAUNCHES,
          cuda_scatter.LAUNCHES)


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# float operations of one live Mandelbulb iteration as csrc/sdf.cuh runs it:
# the power-8 field's double-angle steps; the generic field's ~30 plus two
# atan2f (~20 each), four sinf / cosf (~15 each) and a powf (~25)
MB_ITER_OPS = {True: 62.0, False: 155.0}


def de_ops(sdf, q) -> torch.Tensor:
    """The arithmetic operations one scene DE takes at each point (R,), as
    csrc/sdf.cuh counts them: a sphere 11, a plane 7, a box 26; a bulb 20
    around its loop, 7 for each escape test its loop makes and
    MB_ITER_OPS more for each iteration it runs (the loop ends at the
    escape, as the point needs)."""
    ops = torch.full(q.shape[:1], 11.0 * sdf.sph_center.shape[0] + 7.0 * sdf.pln_normal.shape[0]
                     + 26.0 * sdf.box_center.shape[0], device=q.device)
    per_iter = MB_ITER_OPS[bool(sdf.mb_pow8)]
    for c, s, pw in zip(sdf.mb_center, sdf.mb_scale, sdf.mb_power):
        power = 8.0 if sdf.mb_pow8 else float(pw)
        loc = (q - c) / s
        z = loc
        live = torch.ones_like(ops, dtype=torch.bool)
        ops += 20.0
        for _ in range(sdf.mb_iters):
            r = z.norm(dim=-1)
            ops += 7.0 * live
            live = live & (r <= 4.0)
            ops += per_iter * live
            th = torch.atan2(torch.sqrt(z[:, 0] ** 2 + z[:, 1] ** 2), z[:, 2]) * power
            ph = torch.atan2(z[:, 1], z[:, 0]) * power
            zp = r.clamp(max=4.0)[:, None] ** power * torch.stack(
                [torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph), torch.cos(th)], -1)
            z = torch.where(live[:, None], zp + loc, z)
    return ops


class StepWork:
    """A march's `visit` hook: sums the operations of the DE evaluations the
    march takes (de_ops at each active lane's point) plus `per_step` for the
    step's own arithmetic."""

    def __init__(self, sdf, per_step: float):
        self.sdf, self.per_step, self.ops, self.steps = sdf, per_step, 0.0, 0

    def __call__(self, q, active):
        self.ops += float((de_ops(self.sdf, q[active]) + self.per_step).sum())
        self.steps += int(active.sum())


# world points whose blocks the parity phase takes: the bulb, the sphere and
# the knot (their centres) and the ground in front of them
PARITY_POINTS = ((1.4, 1.05, 0.0), (0.0, 0.55, -1.6), (-1.3, 0.82, 0.0), (0.0, 0.0, 2.0))
# the silhouette path's: the bulb's top edge and the sky above it (the soft
# band: elsewhere the ground stands behind every object), the sphere and
# the knot
SIL_POINTS = ((1.4, 1.9, 0.0), (1.4, 2.1, 0.0)) + PARITY_POINTS[1:3]


def parity_blocks(scene, cfg, perm, points=PARITY_POINTS) -> list:
    """Indices of the blocks (in the frame's Morton block order) whose
    pixels hold the given world points: every kernel then sees hits and
    misses."""
    from tpu_ray_torch.core.math3d import dot

    cam = scene.camera
    fwd, right, up = cam.basis()
    half_h = torch.tan(torch.deg2rad(cam.vfov_deg) * 0.5)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    blocks = []
    for pt in points:
        v = torch.tensor(pt, device=cam.origin.device) - cam.origin
        z = dot(v, fwd)
        x = (dot(v, right) / z / (half_h * cfg.width / cfg.height) + 1) * 0.5 * cfg.width
        y = (1 - dot(v, up) / z / half_h) * 0.5 * cfg.height
        q = int(y.clamp(0, cfg.height - 1)) * cfg.width + int(x.clamp(0, cfg.width - 1))
        b = int(inv[q]) * cfg.spp // cfg.block_size
        while b in blocks:
            b += 1
        blocks.append(b)
    return blocks


def march_entry(sdf, o, d, kw, err) -> dict:
    """The march's times and bound on rays o, d: bytes o, d in and t, hit,
    steps, tmin out; the operations of the DEs its steps take (+8 a step)."""
    from tpu_ray_torch.kernels import cuda_sdf

    work = StepWork(sdf, 8.0)
    cuda_sdf.march_torch(sdf, o, d, **kw, visit=work)
    return dict(max_abs_err=err, ms=kernel_ms(lambda: cuda_sdf.march(sdf, o, d, **kw)),
                plain_ms=wall_ms(lambda: cuda_sdf.march_torch(sdf, o, d, **kw)),
                **bound(nbytes(o, d) + o.shape[0] * 13, work.ops))


def packet_bound(packet, o, t_init) -> dict:
    """The packet walk's bound: the rays in (o, d, t_init) and out (t, tri,
    hit) and the accel read once; one Moller-Trumbore test (~40
    operations) a ray, the least any ray needs."""
    return bound(nbytes(o, o, t_init, packet.corners, packet.chunk_aabb, packet.super_aabb,
                        packet.perm) + o.shape[0] * 9, o.shape[0] * 40.0)


def counted(launch, names) -> dict:
    """One more launch of a kernel, given a zeroed counters tensor of
    len(names): its counters by name."""
    buf = torch.zeros(len(names), dtype=torch.int64, device="cuda")
    launch(buf)
    torch.cuda.synchronize()
    return dict(zip(names, buf.tolist()))


def walk_counts(tag, n_rays, launch) -> dict:
    """One more launch of a packet walk and what it added to the process's
    walk counters (cuda_mt.walk_counters, every kind summed): logged with
    what they say, and returned."""
    from tpu_ray_torch.kernels import cuda_mt

    def total():
        return {k: sum(kind[k] for kind in cuda_mt.walk_counters().values())
                for k in cuda_mt.COUNTERS}

    before = total()
    launch()
    c = {k: n - before[k] for k, n in total().items()}
    # each ray counted once; a passing (ray, chunk) pair runs the chunk's 128
    # tests, fewer where an any-hit ray is decided inside it
    check(c["rays"] == n_rays and c["mt_tests"] <= 128 * c["box_passes"]
          and c["box_passes"] <= c["box_slots"], f"{tag}: walk counters {c}")
    c["pass_share"] = c["box_passes"] / max(c["box_slots"], 1)
    log(tag, f"walk counters: {c['blocks']} blocks, supers visited a block "
        f"{c['supers_visited'] / max(c['blocks'], 1):.2f}, chunks staged a block "
        f"{c['chunks_staged'] / max(c['blocks'], 1):.2f}, share of a staged chunk's rays "
        f"that passed its box {c['pass_share']:.4f}, MT tests a ray "
        f"{c['mt_tests'] / max(n_rays, 1):.1f} ({c['mt_tests']} in all)")
    return c


def walk_rate(r) -> str:
    """For a packet walk's entry: the operations of the MT tests its culls
    left (~40 each, as packet_bound counts one) over its time, against the
    float32 rate of the bound."""
    if "counters" not in r:
        return ""
    ops = r["counters"]["mt_tests"] * 40.0 / (r["ms"] * 1e-3)
    return (f"; the MT tests its culls left run {ops:.3e} operations/s, "
            f"{ops / FP32_OPS_PER_S:.3f} of {FP32_OPS_PER_S:.0e}")


def hit_parity(tag, k, p, any_hit: bool) -> float:
    """A packet walk's hits against another's (its plain version, or the
    whole-mesh walk): hits equal on >= 99.99% of the rays; for closest
    hits t within rtol 1e-5 and a different triangle only where the two t's
    tie to 1e-6. -> the largest |dt| (any-hit: |dhit|)."""
    agree = frac_equal(k.hit, p.hit)
    if any_hit:
        err = float((k.hit.float() - p.hit.float()).abs().max())
        log(tag, f"any-hit: agreement {agree:.6f} ({int((k.hit != p.hit).sum())} mismatches), "
            f"blocked {k.hit.float().mean().item():.4f}")
        check(agree >= 0.9999, f"{tag} any-hit parity")
        return err
    both = k.hit & p.hit
    dt = (k.t - p.t).abs()[both]
    rel = dt / p.t[both]
    tri_bad = int(((k.tri != p.tri)[both] & (rel > 1e-6)).sum())
    err = _max(dt)
    log(tag, f"closest: hit agreement {agree:.6f} ({int((k.hit != p.hit).sum())} mismatches), "
        f"hit rate {k.hit.float().mean().item():.4f}, worst |dt| {err:.3e}, worst rel dt "
        f"{_max(rel):.3e}, tri mismatches off ties {tri_bad}, tri mismatches "
        f"{int((k.tri != p.tri)[both].sum())}")
    check(agree >= 0.9999 and bool((rel <= 1e-5).all()) and tri_bad == 0,
          f"{tag} closest parity")
    return err


def block_rays(scene, cfg, points, tag):
    """The primary rays (o, d) of the frame's blocks that hold the points."""
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays

    dev = scene.device
    sx, sy = R.pixel_sample_coords(cfg, dev)
    perm = R._block_order_perm(cfg).to(dev)
    fx = sx.reshape(-1, cfg.spp)[perm].reshape(-1)
    fy = sy.reshape(-1, cfg.spp)[perm].reshape(-1)
    blocks = parity_blocks(scene, cfg, perm, points)
    idx = torch.cat([torch.arange(b * cfg.block_size, (b + 1) * cfg.block_size, device=dev)
                     for b in blocks])
    log(tag, f"blocks {blocks} of {-(-fx.shape[0] // cfg.block_size)} "
        f"({cfg.block_size} rays each, Morton order)")
    return generate_rays(scene.camera, fx[idx], fy[idx], cfg.width, cfg.height)


def kernel_parity(scene, cfg, results, points=PARITY_POINTS, keep=None):
    """Phase 3: each kernel against its plain version on 4 blocks of the
    frame's primary rays (parity_blocks, the blocks of the points) and the
    shadow rays the geometry pass makes from them. keep: a dict that
    receives the rays and seeds (o, d, seed, p_off, l_dir, aseed)."""
    from tpu_ray_torch.core.math3d import normalize
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.sdf.primitives import sdf_bounding_spheres

    o, d = block_rays(scene, cfg, points, "parity")
    n = o.shape[0]
    sdf, packet = scene.sdf, scene.packet[0]

    # A: primary march (its bound cull padded by eps, and more with soft silhouettes)
    kw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far,
              bound_pad=R._bound_pad(cfg))
    tk, hk, _, mk = cuda_sdf.march(sdf, o, d, **kw)
    tp, hp, _, mp = cuda_sdf.march_torch(sdf, o, d, **kw)
    both = hk & hp
    rel_t = ((tk - tp).abs() / tp.abs().clamp_min(1e-30))[both]
    rel_m = ((mk - mp).abs() / mp.abs().clamp_min(1e-30))[both]
    agree = frac_equal(hk, hp)
    bad_t = int((rel_t > 1e-5).sum() + (rel_m > 1e-5).sum())
    err = _max((tk - tp).abs()[both])
    log("parity", f"march: {n} rays, hit agreement {agree:.6f} ({int((hk != hp).sum())} "
        f"mismatches), hit rate {hk.float().mean().item():.4f}, worst |dt| {err:.3e}, "
        f"worst rel dt {_max(rel_t):.3e}, worst rel dtmin {_max(rel_m):.3e}, "
        f"{bad_t} over rtol 1e-5")
    check(agree >= 0.999 and bad_t == 0, "march parity")
    results["march"] = march_entry(sdf, o, d, kw, err)

    # C closest: seeded with the SDF hit t
    seed = torch.where(hk, tk, torch.full_like(tk, cfg.t_far))
    ck = cuda_mt.intersect_packet_streamed(packet, o, d, t_max=cfg.t_far, t_init=seed)
    cp = cuda_mt.intersect_packet_streamed_torch(packet, o, d, t_max=cfg.t_far, t_init=seed)
    err = hit_parity("parity packet", ck, cp, False)
    results["packet_closest"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: cuda_mt.intersect_packet_streamed(packet, o, d, t_max=cfg.t_far,
                                                               t_init=seed)),
        plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_streamed_torch(
            packet, o, d, t_max=cfg.t_far, t_init=seed)),
        **packet_bound(packet, o, seed),
        counters=walk_counts("parity packet closest", n, lambda: cuda_mt.intersect_packet_streamed(
            packet, o, d, t_max=cfg.t_far, t_init=seed)))

    # the geometry pass's shadow rays for the one directional light
    res = {"sdf_t": tk, "sdf_hit": hk, "sdf_tmin": mk, "mesh_tri": ck.tri,
           "mesh_hit": ck.hit}
    with torch.no_grad():
        _, p_off, _, live = R.shadow_ray_origins(scene, cfg, o, d, res, "mixed",
                                                 mesh_rows=R.mesh_table(scene.mesh))
    l_dir = normalize(scene.lights.direction[0]).expand_as(p_off).contiguous()
    if live is None:  # soft silhouettes: every lane's shadow may reach the image
        live = torch.ones_like(hk)
    t_far_rays = torch.where(live, cfg.t_far, 0.0).to(torch.float32)

    # B: hard SDF shadow
    skw = dict(eps=cfg.eps, t_far=cfg.t_far, steps=cfg.shadow_steps,
               bias=cfg.shadow_bias, t_far_rays=t_far_rays)
    vk, _ = cuda_sdf.shadow_hard(sdf, p_off, l_dir, **skw)
    vp, _ = cuda_sdf.shadow_hard_torch(sdf, p_off, l_dir, **skw)
    agree = frac_equal(vk, vp)
    err = float((vk - vp).abs().max())
    log("parity", f"shadow hard: vis agreement {agree:.6f} ({int((vk != vp).sum())} "
        f"mismatches), blocked {(vk == 0).float().mean().item():.4f}, worst |dvis| {err:.1f}")
    check(agree >= 0.999, "shadow parity")
    # bytes: p, l, t_far_rays in, vis and ts out; the DEs of its steps (+8 a
    # step) and the bound-exit cull (~20 operations a bound)
    work = StepWork(sdf, 8.0)
    cuda_sdf.shadow_hard_torch(sdf, p_off, l_dir, **skw, visit=work)
    n_bounds = 0 if sdf_bounding_spheres(sdf) is None else sdf_bounding_spheres(sdf).shape[0]
    results["shadow_hard"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: cuda_sdf.shadow_hard(sdf, p_off, l_dir, **skw)),
        plain_ms=wall_ms(lambda: cuda_sdf.shadow_hard_torch(sdf, p_off, l_dir, **skw)),
        **bound(nbytes(p_off, l_dir, t_far_rays) + 8 * n, work.ops + 20.0 * n_bounds * n))

    # C any-hit: 0-seeds for lanes the SDF already blocked and for misses
    dead = (vk <= 0.0) | ~live
    aseed = torch.where(dead, 0.0, cfg.t_far).to(torch.float32)
    ak = cuda_mt.intersect_packet_streamed(packet, p_off, l_dir, t_max=cfg.t_far,
                                           any_hit=True, t_init=aseed)
    ap = cuda_mt.intersect_packet_streamed_torch(packet, p_off, l_dir, t_max=cfg.t_far,
                                                 any_hit=True, t_init=aseed)
    log("parity", f"packet any-hit: {(~dead).sum().item()} live shadow rays")
    err = hit_parity("parity packet", ak, ap, True)
    results["packet_any_hit"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: cuda_mt.intersect_packet_streamed(
            packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True, t_init=aseed)),
        plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_streamed_torch(
            packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True, t_init=aseed)),
        **packet_bound(packet, p_off, aseed),
        counters=walk_counts("parity packet any-hit", n, lambda: cuda_mt.intersect_packet_streamed(
            packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True, t_init=aseed)))
    if keep is not None:
        keep.update(o=o, d=d, seed=seed, p_off=p_off, l_dir=l_dir, aseed=aseed)
    for name, r in results.items():
        log("parity", f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})" + walk_rate(r))
    return o, d


def selection(scene, cfg, o, d, res, aux, spec, method):
    """The shade kernels' per-ray branch (csrc/shade_chain.cuh
    shade_surface): (sel_sdf, sel_mesh, p), p the selected hit point of the
    values-only reconstruct. With soft silhouettes a lane that misses runs
    the SDF chain at its closest approach."""
    from tpu_ray_torch.render import render as R

    R_ = o.shape[0]
    no = torch.zeros(R_, dtype=torch.bool, device=o.device)
    hs = res["sdf_hit"] if spec["use_sdf"] else no
    hm = res["mesh_hit"] if spec["use_mesh"] else no
    if spec["mixed"]:
        closer = aux["closer"]
        sel_sdf, sel_mesh = closer & (hs | spec["soft_sil"]), ~closer & hm
    else:
        sel_sdf, sel_mesh = hs | (spec["use_sdf"] and spec["soft_sil"]), hm
    with torch.no_grad():
        rows = R.mesh_table(scene.mesh) if spec["use_mesh"] else None
        p = R.reconstruct_hits(scene, cfg, o, d, res, method, lite=True, mesh_rows=rows)[2]
    return sel_sdf, sel_mesh, p


def shade_bytes(spec, rays, sel_sdf, sel_mesh, full) -> int:
    """The least bytes the shade kernels move on these rays, lane by lane as
    the per-ray branch reads them (csrc/shade_chain.cuh shade_surface): d
    and the masks that pick the branch on every lane; o where a point or an
    edge band is made; the corners on mesh hits that are selected or read
    for the edge band; the march t on SDF-selected hits (and every
    SDF-selected lane without soft silhouettes), tmin on the soft
    silhouette's misses; the material, the shadow rows and the AO's mesh
    term on lanes that select a surface. `full`: tensors read or written
    whole (the outputs, the cotangent, the small block)."""
    o, d, corners, t_bar, tmin, hs, hm, closer, mat, vis, ts, t_mesh = rays
    surf = sel_sdf | sel_mesh
    hit_m = hm if hm is not None else torch.zeros_like(surf)
    hit_s = hs if hs is not None else torch.zeros_like(surf)
    lanes = [(d, None), (hs, None), (hm, None), (closer, None),
             (o, surf | (hit_m & spec["mesh_sil"])),
             (corners, hit_m & (sel_mesh | spec["mesh_sil"])),
             (t_bar, sel_sdf & (hit_s | (not spec["soft_sil"]))),
             (tmin, sel_sdf & ~hit_s), (mat, surf), (vis, surf), (ts, surf), (t_mesh, surf)]
    n = o.shape[0]
    total = nbytes(*full)
    for t, mask in lanes:
        if t is not None:
            per_lane = t.numel() // n * t.element_size()
            total += per_lane * (n if mask is None else int(mask.sum()))
    return total


def shade_ops(scene, cfg, o, d, res, aux, spec, method, backward: bool) -> float:
    """The least operations of the shade kernels on these rays: on each
    SDF-selected lane one DE for its primitive and the adjoint for the
    normal (at least one DE more; the backward's IFT and Dual adjoints two
    more); for each AO tap and each penumbra a DE (the backward: the argmin
    again and the adjoint), each counted at the hit point's DE; ~150 for a
    mesh lane's re-solve and edge band (~300 with the backward); ~40 a lane
    for the shading itself (~60 with the backward)."""
    sel_sdf, sel_mesh, p = selection(scene, cfg, o, d, res, aux, spec, method)
    surf = sel_sdf | sel_mesh
    per = de_ops(scene.sdf, p[surf]) if scene.has_sdf else torch.zeros(int(surf.sum()))
    taps = (5.0 if spec["ao_sdf"] else 0.0) + (
        float(spec["n_dir"] + spec["n_pos"]) if spec["soft_diff"] else 0.0)
    ops = float(per.sum()) * taps * (3.0 if backward else 1.0)
    if spec["use_sdf"]:
        ops += (4.0 if backward else 2.0) * float(de_ops(scene.sdf, p[sel_sdf]).sum())
    ops += (300.0 if backward else 150.0) * float(sel_mesh.sum())
    return ops + (60.0 if backward else 40.0) * o.shape[0]


def shade_inputs(scene, cfg, o, d, method, packed=None):
    """The shade kernels' inputs on rays o, d: (res, aux, corners, spec),
    the geometry pass's residuals as the frame makes them (packed: the
    parameters as render_pixels_flat packs them; None: each wrapper packs
    its own)."""
    from tpu_ray_torch.kernels import cuda_shade
    from tpu_ray_torch.render import render as R

    rows = R.mesh_table(scene.mesh) if scene.has_mesh else None
    with torch.no_grad():
        res = R.geometry_residuals(scene, cfg, o, d, method, mesh_rows=rows, packed=packed)
    corners = (rows[res["mesh_tri"].clamp(0, rows.shape[0] - 1).long()][:, :9].contiguous()
               if rows is not None else None)
    aux = cuda_shade._make_aux(scene, cfg, method, o, d, res, rows)
    return res, aux, corners, cuda_shade.kernel_spec(scene, cfg, method)


def shade_bound(scene, cfg, o, d, res, aux, corners, spec, method, full, backward) -> dict:
    """The shade kernels' bound on these rays: shade_bytes with the small
    block read (and, backward, its cotangent written) and the tensors `full`
    read or written whole, and shade_ops."""
    from tpu_ray_torch.kernels import cuda_shade

    _, small, rays, _ = cuda_shade.kernel_args(scene, cfg, o, d, res, aux, corners, method)
    sel_sdf, sel_mesh, _ = selection(scene, cfg, o, d, res, aux, spec, method)
    smalls = [small, small] if backward else [small]
    return bound(shade_bytes(spec, rays, sel_sdf, sel_mesh, smalls + list(full)),
                 shade_ops(scene, cfg, o, d, res, aux, spec, method, backward))


def seeded_cotangent(o):
    """The shade backward's cotangent for the parity and timing runs:
    uniform in [-1, 1] from a seeded generator on the card."""
    gen = torch.Generator(device=o.device).manual_seed(0)
    return torch.rand(o.shape, generator=gen, device=o.device) * 2.0 - 1.0


def shade_fwd_parity(scene, cfg, o, d, method, results=None, key="shade_fwd"):
    """Phases 3 and 8 (and the silhouette path's parity), shade forward: the
    kernel against shade_fwd_torch on the parity rays and their geometry
    residuals. Gates on the per-ray error (the largest channel difference):
    its 99th percentile < 1e-4 and at most 0.1% of the rays over 1e-3.
    Where the AO taps or the penumbra read the Mandelbulb, the rays whose
    float32 plain forward leaves its float64 evaluation by more than 1e-4
    (cuda_shade.ill_conditioned_colors, without the kernel), at most
    ILL_SHARE_MAX of them, are set apart. With results, also the times and
    the bound (shade_bytes with the colours out; shade_ops)."""
    from tpu_ray_torch.kernels import cuda_shade

    tag = (f"shade_fwd {method} shadow={cfg.shadow} ao={cfg.ao} diff_vis={cfg.diff_vis} "
           f"soft_sil={cfg.soft_silhouette} mesh_sil={cfg.mesh_silhouette}")
    res, aux, corners, spec = shade_inputs(scene, cfg, o, d, method)

    def kernel():
        return cuda_shade.shade_fwd(scene, cfg, o, d, res, method, corners=corners, aux=aux)

    def plain():
        return cuda_shade.shade_fwd_torch(scene, cfg, o, d, res, method, corners=corners)

    k1, k2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err = (k1 - ref).abs().amax(1)
    keep = torch.ones_like(err, dtype=torch.bool)
    ok = bool(torch.isfinite(k1).all())
    sel_sdf, sel_mesh, _ = selection(scene, cfg, o, d, res, aux, spec, method)
    log(tag, f"{o.shape[0]} rays: SDF selected {sel_sdf.float().mean().item():.4f}, mesh "
        f"selected {sel_mesh.float().mean().item():.4f}, sky "
        f"{(~(sel_sdf | sel_mesh)).float().mean().item():.4f}")
    if scene.sdf.mb_center.shape[0] and (spec["ao_sdf"] or spec["soft_diff"]):
        ill = cuda_shade.ill_conditioned_colors(scene, cfg, o, d, res, corners, method)
        share = float(ill.float().mean())
        ok &= share <= ILL_SHARE_MAX
        keep = ~ill
        log(tag, f"ill-conditioned rays (plain float32 against float64, per-ray |dc| > "
            f"1e-4): {int(ill.sum())}, share {share:.5f} (at most {ILL_SHARE_MAX}); "
            f"kernel against plain over 1e-4 on {int((err > 1e-4).sum())} rays, "
            f"{int(((err > 1e-4) & ~ill).sum())} of them outside that set")
    kept = err[keep].double()
    p99 = float(torch.quantile(kept, 0.99)) if kept.numel() else 0.0
    over = float((kept > 1e-3).float().mean()) if kept.numel() else 0.0
    good = p99 < 1e-4 and over <= 1e-3
    ok &= good
    log(tag, f"per-ray |kernel - plain|: p50 {float(kept.median()):.3e} p99 {p99:.3e} max "
        f"{_max(kept):.3e}, over 1e-3 {over:.6f} ({'ok' if good else 'FAIL'}, p99 < 1e-4, "
        f"<= 0.1% over 1e-3); on all rays max {_max(err):.3e}; two kernel runs "
        f"bit-identical {torch.equal(k1, k2)}")
    check(ok and torch.equal(k1, k2), f"{tag} parity")
    if results is not None:
        results[key] = dict(max_abs_err=_max(err), ms=kernel_ms(kernel), plain_ms=wall_ms(plain),
                            **shade_bound(scene, cfg, o, d, res, aux, corners, spec, method,
                                          [k1], False))
        log(tag, f"kernel {results[key]['ms']:.3f} ms, plain {results[key]['plain_ms']:.3f} ms, "
            f"bound {results[key]['bound_ms']:.4f} ms ({results[key]['bound_by']})")
    return res, aux, corners, (sel_sdf, sel_mesh)


def content_classes(scene, cfg, o, d, n=32768):
    """The shade forward on all-sky, all-Mandelbulb and all-mesh ray sets of
    n rays each (the counterpart of tools/profile_shade_kernel.py), taken by
    the kernel's own branch from the `mixed` parity rays and the frame's top
    two pixel rows (sky; the parity blocks hit the ground everywhere):
    kernel ms and ns a ray."""
    from tpu_ray_torch.kernels import cuda_shade
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays

    sx, sy = R.pixel_sample_coords(cfg, o.device)
    to, td = generate_rays(scene.camera, sx[:2].reshape(-1), sy[:2].reshape(-1), cfg.width,
                           cfg.height)
    o, d = torch.cat([o, to]), torch.cat([d, td])
    res, aux, corners, (sel_sdf, sel_mesh) = shade_fwd_parity(scene, cfg, o, d, "mixed")
    bulb = sel_sdf & (aux["mat"] == int(scene.sdf.mb_mat[0]))
    out = {}
    for name, mask in (("sky", ~(sel_sdf | sel_mesh)), ("bulb", bulb), ("mesh", sel_mesh)):
        src = torch.nonzero(mask).flatten()
        check(src.numel() > 0, f"content class {name}: no such ray in the parity blocks")
        idx = src[torch.arange(n, device=o.device) % src.numel()]
        sub = {k: (v[:, idx] if v.dim() == 2 else v[idx]).contiguous()
               for k, v in res.items() if k != "hits"}
        aux_s = {k: v[idx].contiguous() for k, v in aux.items()}
        args = (scene, cfg, o[idx].contiguous(), d[idx].contiguous(), sub, "mixed")
        ms = kernel_ms(lambda: cuda_shade.shade_fwd(*args, corners=corners[idx].contiguous(),
                                                    aux=aux_s))
        out[name] = ms
        log("content", f"shade_fwd on {n} {name} rays ({src.numel()} distinct): {ms:.4f} ms, "
            f"{ms * 1e6 / n:.2f} ns a ray")
    return out


# the most of a frame's or a parity set's rays that may be ill-conditioned
# (cuda_shade.ill_conditioned_rays); measured 4.5% of the `mandelbulb` parity
# blocks' rays and 12-16% of a 128x128 `mandelbulb` frame's on the CPU
ILL_SHARE_MAX = 0.25
SMOOTH = ("materials.albedo", "lights.color", "lights.ambient", "bg_top", "bg_bottom",
          "lights.position", "lights.pos_color", "sdf.sph_center", "sdf.sph_radius",
          "sdf.pln_normal", "sdf.pln_offset", "sdf.box_center", "sdf.box_half",
          "sdf.box_round")
CHAOTIC = ("sdf.mb_center", "sdf.mb_scale", "sdf.mb_power", "lights.direction")


def shade_bwd_parity(scene, cfg, o, d, method, results=None, key="shade_bwd"):
    """Phase 3 and 8, shade backward: the kernel against shade_bwd_torch on
    the parity rays, their geometry residuals and a cotangent uniform in
    [-1, 1] from a seeded generator on the card. With results, also the
    kernel's and the plain version's times and the bound.

    Where the AO taps or the penumbra read the Mandelbulb, float32 rounding
    alone moves some rays' cotangents by more than the per-ray bound: the
    rays cuda_shade.ill_conditioned_rays picks from the plain version and
    its float64 evaluation, without the kernel. At most ILL_SHARE_MAX of
    the rays may be such; both sides then run with their cotangent set to
    0, and every bound below holds on the rest. The log also counts the
    rays on which kernel and plain differ by more than the per-ray bound,
    and how many of those lie outside the ill-conditioned set.

    With the generic-power field every DE the kernel takes is an ulp or so
    from the plain version's (CUDA's atan2f, sinf, cosf and powf against
    torch's kernels for them). Where an AO tap or the penumbra's point lies
    as near the plane as the bulb, that ulp picks the other primitive, and
    the ray's cotangent moves between their groups: there the SDF
    primitives' groups are held to rel < 1e-3 and cosine > 0.999999 in
    place of rel < 1e-4 (measured on phase 21's blocks: the plane's at
    rel 1.2e-4, cosine 1.0)."""
    from tpu_ray_torch.kernels import cuda_shade

    generic = bool(scene.sdf.mb_center.shape[0]) and not scene.sdf.mb_pow8
    tag = (f"shade_bwd {method} shadow={cfg.shadow} ao={cfg.ao} diff_vis={cfg.diff_vis} "
           f"lights {scene.lights.direction.shape[0]}+{scene.lights.position.shape[0]}")
    res, aux, corners, spec = shade_inputs(scene, cfg, o, d, method)
    ct = seeded_cotangent(o)
    args = (scene, cfg, o, d, res)

    def kernel(c=ct):
        return cuda_shade.shade_bwd(*args, aux, corners, c, method)

    def plain(c=ct):
        return cuda_shade.shade_bwd_torch(*args, corners, c, method)

    def per_ray(a, b, key_):
        nz = b[key_].norm(dim=1) > 0
        return nz, (a[key_] - b[key_]).norm(dim=1) / b[key_].norm(dim=1).clamp_min(1e-30)

    k1, k2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    hit = res["sdf_hit"] | res["mesh_hit"] if spec["mixed"] else (
        res["sdf_hit"] if spec["use_sdf"] else res["mesh_hit"])
    sdf_sel = res["sdf_hit"] & aux["closer"] if spec["mixed"] else (
        res["sdf_hit"] if spec["use_sdf"] else torch.zeros_like(hit))
    lit = res["sh_vis"][0] > 0 if "sh_vis" in res else torch.ones_like(hit)
    log(tag, f"{o.shape[0]} rays: hit {hit.float().mean().item():.4f}, SDF hit selected "
        f"{sdf_sel.float().mean().item():.4f} (lit {(sdf_sel & lit).float().mean().item():.4f}), "
        f"mesh hit selected {(hit & ~sdf_sel).float().mean().item():.4f}")
    off = torch.maximum(per_ray(k1, ref, "o")[1], per_ray(k1, ref, "d")[1]) > 1e-3
    g_k, g_p, ok = k1, ref, True
    if scene.sdf.mb_center.shape[0] and (spec["ao_sdf"] or spec["soft_diff"]):
        ill = cuda_shade.ill_conditioned_rays(*args, corners, ct, method)
        share = float(ill.float().mean())
        ok &= share <= ILL_SHARE_MAX
        log(tag, f"ill-conditioned rays (plain float32 against float64, per-ray d_o or d_d "
            f"rel > 1e-3): {int(ill.sum())}, share {share:.5f} (at most {ILL_SHARE_MAX}); "
            f"kernel against plain per-ray rel > 1e-3 on {int(off.sum())} rays, "
            f"{int((off & ~ill).sum())} of them outside that set; compared with their "
            f"cotangent 0")
        ct_m = torch.where(ill[:, None], 0.0, ct)
        g_k, g_p = kernel(ct_m), plain(ct_m)
    else:
        log(tag, f"kernel against plain per-ray rel > 1e-3 on {int(off.sum())} rays")
    worst = 0.0
    for key_ in ("o", "d", "corners"):
        if ref[key_] is None:
            continue
        nz, per = per_ray(g_k, g_p, key_)
        per = per[nz]
        p99 = float(torch.quantile(per.double(), 0.99)) if per.numel() else 0.0
        cos = cosine(g_k[key_], g_p[key_])
        worst = max(worst, float((k1[key_] - ref[key_]).abs().max()))
        good = p99 < 1e-3 and cos > 0.999
        ok &= good
        nz_all, per_all = per_ray(k1, ref, key_)
        log(tag, f"d_{key_}: {int(nz.sum())} rays compared, per-ray rel p50 "
            f"{float(per.median()) if per.numel() else 0.0:.3e} p99 {p99:.3e} max "
            f"{_max(per):.3e}, over 1e-3 {int((per > 1e-3).sum())}, cosine {cos:.9f} "
            f"({'ok' if good else 'FAIL'}, p99 < 1e-3, cosine > 0.999); on all "
            f"{int(nz_all.sum())} rays p99 "
            f"{float(torch.quantile(per_all[nz_all].double(), 0.99)) if nz_all.any() else 0.0:.3e}"
            f", cosine {cosine(k1[key_], ref[key_]):.9f}")
    for path in SMOOTH + CHAOTIC:
        a, b = g_k[path], g_p[path]
        if not b.numel():
            continue
        rel, cos = rel_max(a, b), cosine(a, b)
        zero = not bool(a.any()) and not bool(b.any())  # no lane reaches it
        if path in CHAOTIC:
            good, gate = zero or (cos > 0.999 and rel < 5e-2), "cos > 0.999, rel < 5e-2"
        elif generic and path.startswith("sdf."):
            good, gate = rel < 1e-3 and cos > 0.999999, "rel < 1e-3, cos > 0.999999"
        else:
            good, gate = rel < 1e-4, "rel < 1e-4"
        ok &= good
        worst = max(worst, float((k1[path] - ref[path]).abs().max()))
        log(tag, f"{path}: rel {rel:.3e}, cosine {cos:.9f}, |plain| {float(b.norm()):.4e}"
            f"{', both exactly 0' if zero else ''} ({'ok' if good else 'FAIL'}, {gate})"
            f"; on all rays rel {rel_max(k1[path], ref[path]):.3e}, cosine "
            f"{cosine(k1[path], ref[path]):.9f}")
    same = all(torch.equal(k1[p], k2[p]) for p in cuda_shade.SHADE_PATHS)
    same_rays = all(torch.equal(k1[k], k2[k]) for k in ("o", "d", "corners")
                    if k1[k] is not None)
    log(tag, f"two kernel runs: parameter cotangents bit-identical {same}, "
        f"per-ray bit-identical {same_rays}")
    check(ok, f"{tag} parity")
    check(same, f"{tag}: parameter cotangents differ between two runs")
    if results is not None:
        # the small block's cotangent written, ct read, the rays' written
        results[key] = dict(max_abs_err=worst, ms=kernel_ms(kernel), plain_ms=wall_ms(plain),
                            **shade_bound(scene, cfg, o, d, res, aux, corners, spec, method,
                                          [ct, k1["o"], k1["d"], k1["corners"]], True))
        log(tag, f"kernel {results[key]['ms']:.3f} ms, plain "
            f"{results[key]['plain_ms']:.3f} ms, bound {results[key]['bound_ms']:.4f} ms "
            f"({results[key]['bound_by']})")


def parity(scene, cfg, results, keep=None):
    """Phase 3: the forward kernels, then the shade backward on the same
    rays, with the frame's hard shadows, without them (so that the lit
    Mandelbulb's Hessian chain runs: hard shadows block the bulb's lanes),
    and with the 5-tap AO; the grouped march and the packed parameters
    against the per-block march and the per-call packing. keep: see
    kernel_parity."""
    o, d = kernel_parity(scene, cfg, results, keep=keep)
    shade_fwd_parity(scene, cfg, o, d, "mixed", results)
    shade_bwd_parity(scene, cfg, o, d, "mixed", results)
    shade_bwd_parity(scene, cfg.replace(shadow="none"), o, d, "mixed")
    # the AO's taps, the Mandelbulb's and the mesh's (`mixed --ao sdf5`)
    shade_fwd_parity(scene, cfg.replace(ao="sdf5"), o, d, "mixed")
    shade_bwd_parity(scene, cfg.replace(ao="sdf5"), o, d, "mixed")
    group_parity(scene, cfg, PARITY_POINTS, "parity")
    packed_parity(scene, cfg, o, d, "mixed", "parity")
    return o, d


def group_parity(scene, cfg, points, tag):
    """The primary march as render_pixels_flat runs it, once per group of
    render.MARCH_GROUP blocks (render.march_group, the parameters packed
    once), against the march of each block of the points alone (the
    wrapper packing its own): the group's rays equal the block's own, and
    the group's t, hit, steps and tmin equal the block's, bit for bit."""
    from tpu_ray_torch.kernels import cuda_sdf, cuda_shade
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays

    fx, fy, _, _ = frame_rays(scene, cfg)
    perm = R._block_order_perm(cfg).to(scene.device)
    bs, n = cfg.block_size, R.MARCH_GROUP * cfg.block_size
    packed = cuda_shade.pack(scene, R._bound_pad(cfg))
    for b in parity_blocks(scene, cfg, perm, points):
        g0 = b * bs // n * n
        gx, gy = fx[g0:g0 + n], fy[g0:g0 + n]
        grouped = R.march_group(scene, cfg, gx, gy, packed, bs)
        off = b * bs - g0
        with torch.no_grad():
            og, dg = generate_rays(scene.camera, gx, gy, cfg.width, cfg.height)
        o, d = generate_rays(scene.camera, fx[b * bs:(b + 1) * bs], fy[b * bs:(b + 1) * bs],
                             cfg.width, cfg.height)  # inside autograd, as each block's
        same_rays = torch.equal(og[off:off + bs], o) and torch.equal(dg[off:off + bs], d)
        own = cuda_sdf.march(scene.sdf, o.detach(), d.detach(), t0=0.0,
                             max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far,
                             bound_pad=R._bound_pad(cfg))
        same = [torch.equal(v[off:off + bs], w) for v, w in zip(grouped, own)]
        log(tag, f"grouped march: block {b} in the group of blocks {g0 // bs}.."
            f"{(g0 + gx.shape[0]) // bs - 1}: rays bit-identical {same_rays}; t, hit, steps, "
            f"tmin bit-identical {same} to the block's own march (hit rate "
            f"{own[1].float().mean().item():.4f})")
        check(same_rays and all(same), f"{tag} grouped march against the block's own")


def packed_parity(scene, cfg, o, d, method, tag):
    """The wrappers given the parameters packed once (cuda_shade.pack, as
    render_pixels_flat hands them down) against the same calls packing
    their own: every output bit-identical, one launch of the same kernel
    each."""
    from tpu_ray_torch.kernels import cuda_reconstruct, cuda_sdf, cuda_shade
    from tpu_ray_torch.render import render as R

    packed = cuda_shade.pack(scene, R._bound_pad(cfg))
    rows = R.mesh_table(scene.mesh) if scene.has_mesh else None
    soft = cfg.shadow == "soft"
    shadow = "shadow_soft" if soft else "shadow_hard"
    calls = []
    with recorded(cuda_sdf, shadow, calls):
        res, aux, corners, _ = shade_inputs(scene, cfg, o, d, method)
    args, kw = calls[0]
    kw = {k: v for k, v in kw.items() if k != "packed"}
    ct = seeded_cotangent(o)
    mkw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far,
               bound_pad=R._bound_pad(cfg))
    cases = {
        "march": lambda p: cuda_sdf.march(scene.sdf, o, d, **mkw, packed=p),
        shadow: lambda p: getattr(cuda_sdf, shadow)(*args, **kw, packed=p),
        "shade_fwd": lambda p: cuda_shade.shade_fwd(scene, cfg, o, d, res, method,
                                                    corners=corners, aux=aux, packed=p),
        "shade_bwd": lambda p: cuda_shade.shade_bwd(scene, cfg, o, d, res, aux, corners, ct,
                                                    method, packed=p),
        "reconstruct": lambda p: recon_values(cuda_reconstruct.reconstruct(
            scene, cfg, o, d, res, method, mesh_rows=rows, packed=p))}
    for name, call in cases.items():
        outs = []
        for p in (packed, None):
            reset_launches()
            out = call(p)
            torch.cuda.synchronize()
            launched = {**cuda_sdf.LAUNCHES, **cuda_shade.LAUNCHES,
                        **cuda_reconstruct.LAUNCHES}
            out = out.values() if isinstance(out, dict) else (
                out if isinstance(out, tuple) else (out,))
            outs.append(([v for v in out if v is not None], launched))
        same = all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
        one = outs[0][1] == outs[1][1] and outs[0][1][name] == 1
        log(tag, f"{name} with the parameters packed once against packing its own: outputs "
            f"bit-identical {same}, launches {outs[0][1]}")
        check(same and one, f"{tag} {name}: packed= against per-call packing")


def sil_parity(scene, cfg, results):
    """The silhouette path's parity on the blocks of SIL_POINTS: the forward
    kernels with the padded march and every lane's shadow ray, then both
    shade kernels (the backward per group, per ray and over two runs). The
    blocks must hold rays in both bands: misses whose soft coverage lies
    strictly between 0 and 1, and mesh hits inside the edge band."""
    from tpu_ray_torch.render import render as R

    o, d = kernel_parity(scene, cfg, results, SIL_POINTS)
    res, aux, corners, (sel_sdf, sel_mesh) = shade_fwd_parity(scene, cfg, o, d, "mixed",
                                                              results)
    with torch.no_grad():
        cov = R.reconstruct_hits(scene, cfg, o, d, res, "mixed", corners=corners)[5]
    band = (cov > 1e-3) & (cov < 0.999)
    soft = int((band & ~(res["sdf_hit"] | res["mesh_hit"])).sum())
    edge = int((band & sel_mesh).sum())
    log("sil_parity", f"{o.shape[0]} rays: {soft} misses in the soft silhouette's band, "
        f"{edge} mesh hits in the edge band (0.001 < coverage < 0.999)")
    check(soft >= 500 and edge >= 500, "silhouette parity blocks without both bands")
    shade_bwd_parity(scene, cfg, o, d, "mixed", results)


def soft_parity(sdf, cfg, p_off, l_dir, far, tag, timed=False, exact=True) -> dict:
    """The soft-shadow march against shadow_soft_torch on shadow rays: vis
    within 1e-6 on >= 99.9% of them and ts the same wherever vis agrees.
    exact=False, the generic-power field (sdf_parity): every DE it takes
    is an ulp or so from the plain version's, and every later step's t with
    it, so vis within 1e-6 + 1e-5 |vis| and ts within 1e-5 ts on >= 99% of
    the rays, the bound tests/test_torch_shade_bwd.py holds the host build
    of this march to where glibc's logf and torch's differ (the rest one
    march step apart at the fractal's edge). timed: also the kernel's and
    the plain version's times and the bound (bytes p, l, t_far_rays in and
    vis, ts out; the DEs of its steps +10 a step)."""
    from tpu_ray_torch.kernels import cuda_sdf

    skw = dict(eps=cfg.eps, t_far=cfg.t_far, steps=cfg.shadow_steps, bias=cfg.shadow_bias,
               soft_k=cfg.soft_k, t_far_rays=far)
    vk, tk = cuda_sdf.shadow_soft(sdf, p_off, l_dir, **skw)
    vp, tp = cuda_sdf.shadow_soft_torch(sdf, p_off, l_dir, **skw)
    agree = (vk - vp).abs() <= 1e-6
    ts_bad = int((agree & (tk != tp)).sum())
    err = float((vk - vp).abs().max())
    frac = float(agree.float().mean())
    close = float((((vk - vp).abs() <= 1e-6 + 1e-5 * vp.abs())
                   & ((tk - tp).abs() <= 1e-5 * tp.abs())).float().mean())
    log(tag, f"shadow soft: {p_off.shape[0]} rays, vis agreement {frac:.6f} at |dvis| <= 1e-6 "
        f"({int((~agree).sum())} off), worst |dvis| {err:.3e}, ts differs on {ts_bad} agreeing "
        f"rays; vis within 1e-6 + 1e-5 |vis| and ts within rtol 1e-5 on {close:.6f}; penumbra "
        f"0 < vis < 1 on {float(((vp > 0) & (vp < 1)).float().mean()):.4f}, vis 0 on "
        f"{float((vp == 0).float().mean()):.4f}")
    check(frac >= 0.999 and ts_bad == 0 if exact else close >= 0.99,
          f"{tag} shadow soft parity")
    if not timed:
        return {}
    work = StepWork(sdf, 10.0)
    cuda_sdf.shadow_soft_torch(sdf, p_off, l_dir, **skw, visit=work)
    out = dict(max_abs_err=err, ms=kernel_ms(lambda: cuda_sdf.shadow_soft(sdf, p_off, l_dir, **skw)),
               plain_ms=wall_ms(lambda: cuda_sdf.shadow_soft_torch(sdf, p_off, l_dir, **skw)),
               **bound(nbytes(p_off, l_dir, far) + 8 * p_off.shape[0], work.ops))
    log(tag, f"shadow soft: kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
        f"{work.steps} DE steps, bound {out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


# world points whose `mandelbulb` blocks phase 8 takes: the bulb's silhouette
# and the plane's penumbra beside it
BULB_POINTS = ((1.15, 1.1, 0.0), (-1.3, 0.0, 0.3))


def sdf_parity(scene, cfg, o, d, results, tag, exact=True):
    """The march and the soft march on a `mandelbulb` path's rays against
    their plain versions, timed into results["march"] and
    results["shadow_soft"] when results is given: hits equal on >= 99.9%
    of the rays and t within rtol 1e-5 on every ray both hit (exact=False:
    on all but 0.1% of them). The generic-power field (exact=False) calls
    CUDA's atan2f, sinf, cosf and powf where its plain version runs torch's
    kernels for them, which may round an ulp apart; the fractal carries one
    such difference into another step at its edge, as the power-8 field's
    one multiply-add order does not."""
    from tpu_ray_torch.core.math3d import normalize
    from tpu_ray_torch.kernels import cuda_sdf
    from tpu_ray_torch.render import render as R

    sdf = scene.sdf
    kw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far)
    tk, hk, _, mk = cuda_sdf.march(sdf, o, d, **kw)
    tp, hp, _, _ = cuda_sdf.march_torch(sdf, o, d, **kw)
    both = hk & hp
    rel_t = ((tk - tp).abs() / tp.abs().clamp_min(1e-30))[both]
    agree = frac_equal(hk, hp)
    err = _max((tk - tp).abs()[both])
    over = int((rel_t > 1e-5).sum())
    log(tag, f"march: {o.shape[0]} rays, hit agreement {agree:.6f}, hit rate "
        f"{hk.float().mean().item():.4f}, worst |dt| {err:.3e}, worst rel dt "
        f"{_max(rel_t):.3e}, {over} over rtol 1e-5")
    check(agree >= 0.999 and over <= (0 if exact else 1e-3 * int(both.sum())),
          f"{tag} march parity")
    if results is not None:
        results["march"] = march_entry(sdf, o, d, kw, err)
        log(tag, f"march: kernel {results['march']['ms']:.3f} ms, plain "
            f"{results['march']['plain_ms']:.3f} ms, bound {results['march']['bound_ms']:.4f} "
            f"ms ({results['march']['bound_by']})")

    res = {"sdf_t": tk, "sdf_hit": hk, "sdf_tmin": mk}
    with torch.no_grad():
        _, p_off, _, live = R.shadow_ray_origins(scene, cfg, o, d, res, "sdf")
    l_dir = normalize(scene.lights.direction[0]).expand_as(p_off).contiguous()
    far = torch.where(live, cfg.t_far, 0.0).to(torch.float32)
    soft = soft_parity(sdf, cfg, p_off, l_dir, far, tag, timed=results is not None,
                       exact=exact)
    if results is not None:
        results["shadow_soft"] = soft


def generic_field(scene, power=None):
    """The scene with the generic-power Mandelbulb (mb_pow8=False), as a
    `sdf.mb_power` fit runs it; power: every bulb's, when given."""
    sdf = scene.sdf.replace(mb_pow8=False)
    if power is not None:
        sdf = sdf.replace(mb_power=torch.full_like(sdf.mb_power, power))
    return scene.replace(sdf=sdf)


def power_parity(scene, cfg, results):
    """Phase 21: phase 8's blocks with the generic field at mb_power 8.0
    (the `mandelbulb_power` path's, timed into results) and 7.5: the march
    and the soft march (sdf_parity), the shade forward with AO, without and
    with the penumbra, and the shade backward with AO and the diff_vis
    penumbra, the `sdf.mb_power` group among the chaotic ones; the
    ill-conditioned rays set apart as in phase 8."""
    o, d = block_rays(scene, cfg, BULB_POINTS, "power_parity")
    for power in (8.0, 7.5):
        g = generic_field(scene, power)
        timed = results if power == 8.0 else None
        sdf_parity(g, cfg, o, d, timed, f"power_parity {power}", exact=False)
        shade_fwd_parity(g, cfg, o, d, "sdf", timed)
        shade_fwd_parity(g, cfg.replace(diff_vis=True), o, d, "sdf")
        shade_bwd_parity(g, cfg.replace(diff_vis=True), o, d, "sdf", timed)


def power_frame(scene, cfg, smi, warm, profile_cfg):
    """Phase 22: the `mandelbulb_power` frame (the march once per group of
    blocks, 64 launches each of the soft march and the shade forward), its
    diff_vis fit step for
    POWER_TRAINABLES (64 shade backward), then 3 Adam steps of fit() from
    the registry's power-8 scene toward the CLI demo target at 256x256x4,
    through the kernels. -> the frame's and the step's launch counts."""
    from tpu_ray_torch.cli import demo_target
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.tools import launch_counts
    from tpu_ray_torch.utils.config import FitConfig

    g = generic_field(scene)
    n_blocks = -(-cfg.num_rays // cfg.block_size)
    counts = full_frame(g, cfg, smi, "mandelbulb_power", warm, "power_frame")
    check(counts["shadow_soft"] == n_blocks, f"mandelbulb_power: {counts['shadow_soft']} "
          f"shadow_soft launches for {n_blocks} blocks")
    step = fit_step(g, cfg.replace(diff_vis=True), smi, "mandelbulb_power", POWER_TRAINABLES,
                    warm.replace(diff_vis=True), profile_cfg.replace(diff_vis=True),
                    "power_fit_step")
    # the power's own IFT gradient need not lower the loss in 3 steps (the
    # fractal moves chaotically with it): the albedo and light colour train
    # beside it, as tests/test_torch_mandelbulb.py's CLI fit does
    trainable = ("sdf.mb_power", "materials.albedo", "lights.color")
    small = cfg.replace(width=256, height=256)
    target = demo_target(scene, small, trainable)
    reset_launches()
    t0 = time.perf_counter()
    fitted, history = fit(scene, small, target, trainable,
                          FitConfig(steps=3, learning_rate=1e-2), verbose=False)
    torch.cuda.synchronize()
    launched = launch_counts()
    log("power_fit", f"mandelbulb 256x256x4 from mb_pow8={scene.sdf.mb_pow8}, {list(trainable)}, "
        f"Adam lr 1e-2: loss history {[f'{v:.8f}' for v in history]}, mb_power "
        f"{float(scene.sdf.mb_power[0]):.4f} -> {float(fitted.sdf.mb_power[0]):.6f}, "
        f"generic field {not fitted.sdf.mb_pow8}, launches {launched} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(not fitted.sdf.mb_pow8 and all(launched[k] > 0 for k in PATH_KERNELS["mandelbulb_power"]),
          "the mb_power fit did not run the generic field through the kernels")
    check(len(history) == 3 and all(map(torch.isfinite, torch.tensor(history)))
          and history[-1] < history[0], "the mb_power fit's loss did not fall")
    return dict(counts, shade_bwd=step["shade_bwd"])


def bulb_parity(scene, cfg, results):
    """Phase 8: on 2 blocks of the `mandelbulb` frame, the march and the soft
    march against their plain versions; the soft march on the `pointlight`
    frame's shadow rays, each cut at its light's distance; the shade
    backward with AO and the penumbra (diff_vis) on the blocks' rays, and
    with the point light's penumbra on the `pointlight` frame's rays."""
    from tpu_ray_torch.core.math3d import dot
    from tpu_ray_torch.kernels import cuda_sdf
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays
    from tpu_ray_torch.scene.scenes import build_scene

    o, d = block_rays(scene, cfg, BULB_POINTS, "bulb_parity")
    sdf_parity(scene, cfg, o, d, results, "bulb_parity")
    group_parity(scene, cfg, BULB_POINTS, "bulb_parity")
    packed_parity(scene, cfg.replace(diff_vis=True), o, d, "sdf", "bulb_parity")

    pscene, pcfg = build_scene("pointlight", device=scene.device)
    sx, sy = R.pixel_sample_coords(pcfg, scene.device)
    po, pd = generate_rays(pscene.camera, sx.reshape(-1), sy.reshape(-1), pcfg.width,
                           pcfg.height)
    pt, ph, _, pm = cuda_sdf.march(pscene.sdf, po, pd, t0=0.0, max_steps=pcfg.max_steps,
                                   eps=pcfg.eps, t_far=pcfg.t_far)
    with torch.no_grad():
        _, pp, _, plive = R.shadow_ray_origins(pscene, pcfg, po, pd, {
            "sdf_t": pt, "sdf_hit": ph, "sdf_tmin": pm}, "sdf")
    lvec = pscene.lights.position[0] - pp
    dist = torch.sqrt(torch.clamp_min(dot(lvec, lvec), 1e-12))
    soft_parity(pscene.sdf, pcfg, pp, (lvec / dist[:, None]).contiguous(),
                torch.where(plive, dist, 0.0).contiguous(), "bulb_parity pointlight")

    shade_fwd_parity(scene, cfg, o, d, "sdf", results)
    shade_fwd_parity(scene, cfg.replace(diff_vis=True), o, d, "sdf")
    shade_bwd_parity(scene, cfg.replace(diff_vis=True), o, d, "sdf", results)
    # the point light's penumbra (its direction and distance from p_off)
    shade_fwd_parity(pscene, pcfg.replace(diff_vis=True), po, pd, "sdf")
    shade_bwd_parity(pscene, pcfg.replace(diff_vis=True), po, pd, "sdf")


def plain_paths():
    """Every kernel wrapper patched with its plain PyTorch version."""
    from contextlib import ExitStack

    from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_sdf, cuda_shade

    def reconstruct_plain(scene, cfg, o, d, res, method, mesh_rows=None, packed=None):
        from tpu_ray_torch.render.render import shadow_ray_origins_plain

        aux = {}
        hits, p_off, nf, live = shadow_ray_origins_plain(scene, cfg, o, d, res, method,
                                                         mesh_rows=mesh_rows, aux_out=aux)
        return cuda_reconstruct.Recon(hits, aux.get("closer"), nf, p_off, live)

    def shade_fwd_plain(scene, cfg, o, d, res, method, corners=None, aux=None,
                        mesh_rows=None, packed=None):
        return cuda_shade.shade_fwd_torch(scene, cfg, o, d, res, method, corners=corners,
                                          mesh_rows=mesh_rows)

    def shade_bwd_plain(scene, cfg, o, d, res, aux, corners, ct, method, packed=None):
        return cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)

    def unpacked(plain):  # the plain version, called as its wrapper is
        return lambda *args, packed=None, **kw: plain(*args, **kw)

    stack = ExitStack()
    for name in ("march", "shadow_hard", "shadow_soft"):
        stack.enter_context(mock.patch.object(cuda_sdf, name,
                                              unpacked(getattr(cuda_sdf, f"{name}_torch"))))
    stack.enter_context(mock.patch.object(cuda_mt, "intersect_packet_streamed",
                                          cuda_mt.intersect_packet_streamed_torch))
    stack.enter_context(mock.patch.object(cuda_mt, "intersect_packet",
                                          cuda_mt.intersect_packet_torch))
    stack.enter_context(mock.patch.object(cuda_shade, "shade_fwd", shade_fwd_plain))
    stack.enter_context(mock.patch.object(cuda_shade, "shade_bwd", shade_bwd_plain))
    stack.enter_context(mock.patch.object(cuda_reconstruct, "reconstruct", reconstruct_plain))
    return stack


def grads_of(scene, cfg, paths=TRAINABLES):
    """(loss, {path: gradient}) of mean(render_image**2)."""
    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_image

    params = extract_params(scene, paths)
    loss = torch.mean(render_image(apply_params(scene, params), cfg) ** 2)
    loss.backward()
    return loss.detach(), {p: v.grad for p, v in params.items()}


def ill_conditioned_paths():
    """Two context managers, for the kernel path and then the plain path of
    the same frame, that set to 0 the shade backward's cotangent of each
    block's ill-conditioned rays (cuda_shade.ill_conditioned_rays: found
    from the plain version and its float64 evaluation, once per block, and
    read by both paths). The kernel path also counts the rays on which
    kernel and plain differ by more than 1e-3 per ray on the whole
    cotangent, and how many of those lie outside the set.
    Returns (kernel_ctx, plain_ctx, stats)."""
    from tpu_ray_torch.kernels import cuda_shade

    kernel_bwd, masks = cuda_shade.shade_bwd, {}
    stats = {"rays": 0, "ill": 0, "off": 0, "off_outside": 0}

    def ill_of(scene, cfg, o, d, res, corners, ct, method):
        key = tuple(d[0].tolist() + d[-1].tolist() + o[0].tolist() + [o.shape[0]])
        if key not in masks:
            masks[key] = cuda_shade.ill_conditioned_rays(scene, cfg, o, d, res, corners, ct,
                                                         method)
            stats["rays"] += o.shape[0]
            stats["ill"] += int(masks[key].sum())
        return masks[key]

    def masked_kernel(scene, cfg, o, d, res, aux, corners, ct, method, packed=None):
        ill = ill_of(scene, cfg, o, d, res, corners, ct, method)
        k = kernel_bwd(scene, cfg, o, d, res, aux, corners, ct, method, packed=packed)
        p = cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
        off = torch.stack([(k[x] - p[x]).norm(dim=1) / p[x].norm(dim=1).clamp_min(1e-30)
                           for x in ("o", "d")]).amax(0) > 1e-3
        stats["off"] += int(off.sum())
        stats["off_outside"] += int((off & ~ill).sum())
        return kernel_bwd(scene, cfg, o, d, res, aux, corners,
                          torch.where(ill[:, None], 0.0, ct), method, packed=packed)

    def masked_plain(scene, cfg, o, d, res, aux, corners, ct, method, packed=None):
        ill = ill_of(scene, cfg, o, d, res, corners, ct, method)
        return cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners,
                                          torch.where(ill[:, None], 0.0, ct), method)

    return (mock.patch.object(cuda_shade, "shade_bwd", masked_kernel),
            mock.patch.object(cuda_shade, "shade_bwd", masked_plain), stats)


def small_frame(scene, small, name, trainables, tag="small", ill=False):
    """Phases 4 and 9: a small frame, kernel path against plain path on the
    card: the image, then the gradient of mean(img**2) for the trainables.
    ill: compare the gradients with the ill-conditioned rays' cotangent set
    to 0 on both paths (ill_conditioned_paths), at most ILL_SHARE_MAX of
    the frame's rays; the gradients on all rays are logged."""
    from tpu_ray_torch.render.render import render_image

    with torch.no_grad():
        img_k = render_image(scene, small)
        with plain_paths():
            img_p = render_image(scene, small)
    err = (img_k - img_p).abs().amax(-1)
    p95 = float(torch.quantile(err.flatten(), 0.95))
    log(tag, f"{name} {small.width}x{small.height}x{small.spp} diff_vis={small.diff_vis}: "
        f"kernel vs plain path p95 {p95:.3e}, max {float(err.max()):.3e}, mean "
        f"{float((img_k - img_p).abs().mean()):.3e}, pixels over 1e-3: "
        f"{int((err > 1e-3).sum())} of {err.numel()}")
    check(bool(torch.isfinite(img_k).all()) and p95 < 1e-3, f"{name} small-frame parity")

    loss_k, g_k = grads_of(scene, small, trainables)
    _, g_k2 = grads_of(scene, small, trainables)
    same = {p: torch.equal(g_k[p], g_k2[p]) for p in trainables}
    log(tag, f"two kernel-path passes, gradients bit-identical: {same}")
    with plain_paths():
        loss_p, g_p = grads_of(scene, small, trainables)
    held_k, held_p = g_k, g_p
    if ill:
        kernel_ctx, plain_ctx, stats = ill_conditioned_paths()
        with kernel_ctx:
            _, held_k = grads_of(scene, small, trainables)
        with plain_paths(), plain_ctx:
            _, held_p = grads_of(scene, small, trainables)
        share = stats["ill"] / max(stats["rays"], 1)
        log(tag, f"ill-conditioned rays (plain float32 against float64, per-ray d_o or d_d "
            f"rel > 1e-3): {stats['ill']} of {stats['rays']} ({share:.5f}, at most "
            f"{ILL_SHARE_MAX}); kernel against plain per-ray rel > 1e-3 on {stats['off']} "
            f"rays, {stats['off_outside']} of them outside that set")
        check(share <= ILL_SHARE_MAX, f"{name}: ill-conditioned rays over {ILL_SHARE_MAX}")
    ok = True
    for path in trainables:
        cos = cosine(held_k[path], held_p[path])
        ok &= cos > 0.999 and bool(torch.isfinite(g_k[path]).all())
        log(tag, f"grad {path}: cosine {cos:.9f}, rel {rel_max(held_k[path], held_p[path]):.3e}, "
            f"|kernel| {float(held_k[path].norm()):.4e}, |plain| {float(held_p[path].norm()):.4e}"
            + (f"; on all rays cosine {cosine(g_k[path], g_p[path]):.9f}, |kernel| "
               f"{float(g_k[path].norm()):.4e}, |plain| {float(g_p[path].norm()):.4e}"
               if ill else ""))
    log(tag, f"loss kernel {float(loss_k):.8f}, plain {float(loss_p):.8f}")
    check(ok, f"{name} small-frame gradient cosine > 0.999")


def bulb_small(scene, small):
    """Phase 9: the `mandelbulb` small frame at the scene's own diff_vis=False
    (the AO chain), then with diff_vis (the penumbra too), each without its
    ill-conditioned rays (shade_bwd_parity's docstring)."""
    small_frame(scene, small, "mandelbulb", BULB_TRAINABLES, "bulb_small", ill=True)
    small_frame(scene, small.replace(diff_vis=True), "mandelbulb", BULB_TRAINABLES,
                "bulb_small", ill=True)


def forward_counts():
    """The kernels' launch counts but the backward's (a frame's)."""
    from tpu_ray_torch.tools import launch_counts

    return {k: n for k, n in launch_counts().items() if k not in BACKWARD}


def forward_kernels(path: str) -> tuple:
    """The kernels a frame of the path runs: its PATH_KERNELS but the backward's."""
    return tuple(k for k in PATH_KERNELS[path] if k not in BACKWARD)


def step_launches(frame_counts: dict) -> dict:
    """A graphed fit step's launches from its frame's: the backward replays
    the shade forward and the corner gather once more a block, and runs the
    shade backward and, where the frame gathers corners, the corner scatter
    once a block."""
    blocks, gathers = frame_counts["shade_fwd"], frame_counts["corner_gather"]
    return dict(frame_counts, shade_fwd=2 * blocks, shade_bwd=blocks,
                corner_gather=2 * gathers, corner_scatter=gathers)


def check_counts(name, cfg, counts, kernels) -> None:
    """Every kernel of the path launched; the march once per group of
    render.MARCH_GROUP blocks, the reconstruct and the shade forward (and
    the backward, where it ran) once per block, and so the corner gather
    and scatter where the path lists them."""
    from tpu_ray_torch.render.render import MARCH_GROUP

    n_blocks = -(-cfg.num_rays // cfg.block_size)
    n_groups = -(-n_blocks // MARCH_GROUP)
    check(all(counts[k] > 0 for k in kernels), f"{name}: a kernel never launched: {counts}")
    check(counts["march"] == n_groups, f"{name}: {counts['march']} march launches for "
          f"{n_blocks} blocks in groups of {MARCH_GROUP}")
    for k in ("reconstruct", "shade_fwd", "shade_bwd") + tuple(
            k for k in ("corner_gather", "corner_scatter") if k in kernels):
        check(counts.get(k, n_blocks) == n_blocks,
              f"{name}: {counts.get(k)} {k} launches for {n_blocks} blocks")


def full_frame(scene, cfg, smi: str, name: str, warm, tag="frame", keep=None):
    """Phases 5 and 10: the whole frame through the kernels -> launch
    counts. keep: a dict that receives the image, its seconds and the
    counts (for graph_frame)."""
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.utils.image_io import write_png

    with torch.no_grad():
        render_image(scene, warm)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = render_image(scene, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = forward_counts()
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), f"frame shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "frame not finite")
    check_counts(name, cfg, counts, forward_kernels(name))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    png = os.path.join(REPO, "build", f"chip_smoke_{name}.png")
    write_png(png, img.cpu().numpy())
    log(tag, f"{name} {cfg.width}x{cfg.height}x{cfg.spp} soft_sil={cfg.soft_silhouette} "
        f"mesh_sil={cfg.mesh_silhouette}: {dt:.3f} s, "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s, mean {float(img.mean()):.4f}, "
        f"launches {counts}, peak mem {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"on {smi}; wrote {png}")
    if keep is not None:
        keep.update(image=img, seconds=dt, counts=counts)
    return counts


def profile_step(scene, cfg, trainables, tag):
    """A fit step over a small frame under torch.profiler: the device's busy
    share of the wall time and where the device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads_of(scene, cfg, trainables)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels' own events (the CPU ops that launched them carry the same
    # device time again)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    n_blocks = -(-cfg.num_rays // cfg.block_size)
    log(tag, f"profile of a {cfg.width}x{cfg.height}x{cfg.spp} fit step ({n_blocks} "
        f"blocks): wall {wall * 1e3:.1f} ms, device {dev_us / 1e3:.1f} ms, busy "
        f"{dev_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(tag, f"  device {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")


def fit_step(scene, cfg, smi: str, name: str, trainables, warm, profile_cfg,
             tag="fit_step", keep=None):
    """Phases 6 and 11: one forward + backward of mean(img**2) over the full
    frame for the trainables -> launch counts, the shade backward's among
    them. keep: a dict that receives the loss, the gradients and the
    seconds (for graph_step)."""
    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.tools import launch_counts

    grads_of(scene, warm, trainables)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = extract_params(scene, trainables)
    loss = torch.mean(render_image(apply_params(scene, params), cfg) ** 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {p: v.grad for p, v in params.items()}
    dt = t2 - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(tag, f"{name} {cfg.width}x{cfg.height}x{cfg.spp} diff_vis={cfg.diff_vis} "
        f"soft_sil={cfg.soft_silhouette} mesh_sil={cfg.mesh_silhouette} forward + "
        f"backward: {dt:.3f} s (forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s), "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s, loss {float(loss.detach()):.8f}, "
        f"launches {counts}, peak mem {peak:.3f} GiB on {smi}")
    for path, g in grads.items():
        fin = bool(torch.isfinite(g).all())
        log(tag, f"grad {path}: norm {float(g.norm()):.6e}, finite {fin}, "
            f"nonzero {int((g != 0).sum())} of {g.numel()}")
        check(fin and bool((g != 0).any()), f"gradient of {path} not finite and nonzero")
    check_counts(name, cfg, counts, PATH_KERNELS[name])
    if keep is not None:
        keep.update(loss=loss.detach(), grads=grads, seconds=dt)
    # after the timed step: the profiler slows the launches that follow it
    profile_step(scene, profile_cfg, trainables, tag)
    return counts


def graph_frame(scene, cfg, smi: str, name: str, eager: dict, tag="graph_frame", keep=None):
    """Phases 5b and 10b: the frame of phase 5 (10) through render_image_jit (its blocks
    replayed as CUDA graphs) -> launch counts. The first call warms up and
    captures (its seconds, and the plan's graph pool and buffers); the
    second is timed with the counts from 0: they equal phase 5's, and the
    image phase 5's within 1e-6 (the same kernels in the same order). Then
    a profiled window of the frame's middle march group (32 blocks,
    tools.window) through the same plan: busy share, launches and host
    self time a block. keep: a dict that receives the image (for
    sharded_graph_frame)."""
    from tpu_ray_torch import tools
    from tpu_ray_torch.render import graphs
    from tpu_ray_torch.render.render import (frame_samples, march_groups, render_image_jit,
                                             whole_blocks)

    check("image" in eager, f"graph_frame needs phase `frame`'s image (--only frame,...)")
    graphs.PLANS.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0, allocated0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    with torch.no_grad(), captures_timed() as captured:
        t0 = time.perf_counter()
        render_image_jit(scene, cfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        torch.cuda.empty_cache()
        plan = next(iter(graphs.PLANS.values()))
        pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(plan.pool))
        held = (torch.cuda.memory_reserved() - reserved0,
                torch.cuda.memory_allocated() - allocated0)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = render_image_jit(scene, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = forward_counts()
    err = float((img - eager["image"]).abs().max())
    log(tag, f"{name} {cfg.width}x{cfg.height}x{cfg.spp} through render_image_jit: "
        f"{dt:.3f} s, {cfg.num_rays / dt / 1e6:.3f} Mrays/s (eager: "
        f"{eager['seconds']:.3f} s, {cfg.num_rays / eager['seconds'] / 1e6:.3f} Mrays/s; "
        f"{eager['seconds'] / dt:.2f}x); first call {first:.3f} s, its warm-ups and "
        f"captures {sum(captured):.3f} s ({len(captured)} graphs); graph pool {pool / 2**30:.3f} GiB, the plan's memory "
        f"reserved {held[0] / 2**30:.3f} GiB, allocated {held[1] / 2**30:.3f} GiB; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; max |jit - eager| {err:.3e}; "
        f"launches {counts} on {smi}")
    check(bool(torch.isfinite(img).all()), "graphed frame not finite")
    check(err <= 1e-6, f"graphed frame against the eager one: max abs {err:.3e} > 1e-6")
    check_counts(name, cfg, counts, forward_kernels(name))
    check(counts == eager["counts"], f"graphed launches {counts} != eager {eager['counts']}")
    if keep is not None:
        keep.update(image=img)
    # the middle march group's 32 blocks through the frame's own plan
    s_r, fx, fy, _ = frame_samples(scene, cfg)
    fx, fy, bs = whole_blocks(cfg, fx, fy)
    groups = march_groups(fx.shape[0], bs)
    g = groups[len(groups) // 2]
    with torch.no_grad():
        win, events = tools.window(
            lambda: graphs.render_pixels_flat_jit(s_r, cfg, fx[g], fy[g]), img.device)
    check(len(graphs.PLANS) == 1, "the window captured a second plan")
    blocks = (g.stop - g.start) // bs
    top = sorted(tools.host_self(events).items(), key=lambda kv: -kv[1][0])[:4]
    log(tag, f"profiled window, {blocks} blocks (the middle march group): "
        f"{tools.window_line(tools.per_block(win, blocks))}; host self time: "
        + ", ".join(f"{k} {ms:.1f} ms ({n})" for k, (ms, n) in top))
    # busy: the profiled window's union of device intervals over its own wall
    check(0.0 < win["device_ms"] <= win["profiled_wall_ms"] and 0.0 < win["busy"] <= 1.0,
          f"window device {win['device_ms']} ms, its wall {win['profiled_wall_ms']} ms, "
          f"busy {win['busy']}")
    return counts


@contextlib.contextmanager
def captures_timed():
    """-> a list that receives the seconds of each Graph's warm-up and
    capture (render/graphs.py) made inside the block, synchronized."""
    from tpu_ray_torch.render import graphs

    spent, real = [], graphs.Graph.prepare

    def prepare(self):
        if not self.captures or self.graph is not None:
            return real(self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(self)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)

    with mock.patch.object(graphs.Graph, "prepare", prepare):
        yield spent


def graph_step(scene, cfg, smi: str, name: str, trainables, eager: dict, frame_counts,
               tag="graph_step", keep=None):
    """Phases 6b and 11b: phase 6's (11's) fit step through render_image_jit: the first
    step captures the backward's graph, the second is timed with the
    counts from 0 (#5 twice a block: the backward recomputes the shade
    forward from the kept residuals; the geometry pass and the march
    once). Loss and gradients against phase 6's: rel <= 1e-5 a trainable,
    <= 1e-4 for mesh.verts (the scatter's summation order). keep: a dict
    that receives the loss and the gradients (for sharded_graph_step)."""
    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.tools import launch_counts

    check("grads" in eager, "graph_step needs phase `fit_step`'s gradients")

    def step():
        params = extract_params(scene, trainables)
        loss = torch.mean(render_image_jit(apply_params(scene, params), cfg) ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {p: v.grad for p, v in params.items()}, t1

    t0 = time.perf_counter()
    with captures_timed() as captured:
        step()
    first = time.perf_counter() - t0
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads, t1 = step()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    n_blocks = -(-cfg.num_rays // cfg.block_size)
    rel_loss = float((loss - eager["loss"]).abs() / eager["loss"].abs())
    log(tag, f"{name} {cfg.width}x{cfg.height}x{cfg.spp} forward + backward through "
        f"render_image_jit: {dt:.3f} s (forward {t1 - t0:.3f} s, backward "
        f"{t0 + dt - t1:.3f} s), {cfg.num_rays / dt / 1e6:.3f} Mrays/s (eager: "
        f"{eager['seconds']:.3f} s; {eager['seconds'] / dt:.2f}x); first step {first:.3f} s, "
        f"its warm-ups and captures {sum(captured):.3f} s ({len(captured)} graphs); loss {float(loss):.8f} (rel "
        f"{rel_loss:.2e}); peak mem {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches {counts} on {smi}")
    ok = rel_loss <= 1e-6
    for path, g in grads.items():
        ref = eager["grads"][path]
        rel = float((g - ref).abs().max() / ref.abs().max())
        bound = 1e-4 if path == "mesh.verts" else 1e-5
        ok &= rel <= bound
        log(tag, f"grad {path}: rel {rel:.3e} (bound {bound:.0e}) against the eager step's")
    check(ok, "graphed fit step against the eager one")
    want = step_launches(frame_counts)
    check(counts == want, f"graphed step launches {counts} != {want}")
    if keep is not None:
        keep.update(loss=loss, grads=grads)
    return counts


def pools_gib(plans) -> float:
    """GiB of the CUDA graph pools of these plans (render.graphs.PLANS'
    values: a frame plan, a sharded frame's gather, a step's all-reduce)."""
    pools = {tuple(p.pool) for p in plans if getattr(p, "pool", None) is not None}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) in pools) / 2**30


def pools_line(before) -> str:
    """The graph pools of the plans made since `before` (a set of
    render.graphs.PLANS' keys) and of every plan held."""
    from tpu_ray_torch.render import graphs

    new = [p for k, p in graphs.PLANS.items() if k not in before]
    return (f"{len(new)} new plans, their graph pools {pools_gib(new):.3f} GiB (every plan's "
            f"{pools_gib(graphs.PLANS.values()):.3f} GiB)")


def sharded_graph_frame(scene, cfg, smi: str, dev, graphed: dict, eager_counts: dict):
    """Phase 5c: phase 5b's frame through dist.sharding.render_image_sharded_jit
    in an NCCL group of one process: the frame's plan (the key of 5b's, so
    reused), and the gather, one captured all_gather_into_tensor. The
    first call captures the gather, the second is timed with the counts
    from 0 (phase 5's); the image against phase 5b's: at most 1e-4 of the
    pixels off by more than 1e-4 (the pixels are dealt to the blocks in
    another order)."""
    from tpu_ray_torch.dist.sharding import render_image_sharded_jit
    from tpu_ray_torch.render import graphs

    check("image" in graphed, "sharded_graph_frame needs phase `graph_frame`'s image")
    before = set(graphs.PLANS)
    with ring_group(dev), torch.no_grad(), captures_timed() as captured:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image_sharded_jit(scene, cfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        img = render_image_sharded_jit(scene, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pools = pools_line(before)
    counts = forward_counts()
    err = (img - graphed["image"]).abs().amax(-1)
    frac = float((err > 1e-4).float().mean())
    log("sharded_graph_frame", f"mixed {cfg.width}x{cfg.height}x{cfg.spp} through "
        f"render_image_sharded_jit, NCCL group of 1: {dt:.3f} s, "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s; first call {first:.3f} s, its warm-ups and "
        f"captures {sum(captured):.3f} s ({len(captured)} graphs); {pools}; against "
        f"render_image_jit's frame: max {float(err.max()):.3e}, pixels over 1e-4 "
        f"{frac:.2e} (at most 1e-4); launches {counts} on {smi}")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(img).all()),
          "sharded graphed frame shape or values")
    check(frac <= 1e-4, "sharded graphed frame against render_image_jit's")
    check(counts == eager_counts, f"sharded graphed launches {counts} != eager {eager_counts}")
    return counts


def graphed_sharded_step(scene, cfg, smi: str, dev, ref: dict, want_counts: dict, tag: str,
                         scene_shards: bool = False):
    """Phases 6c and 20b: the graphed data-parallel step (make_sharded_fit_step)
    of the six trainables toward a zero target (its loss mean(img**2)),
    SGD at lr 0, in an NCCL group of one process; its first step captures
    what is new (the all-reduce graph; with the ring, its frame plan), the
    second is timed with the counts from 0. Loss and gradients against
    ref's: rel <= 1e-5, mesh.verts <= 1e-4."""
    from tpu_ray_torch.fit import extract_params, make_sharded_fit_step
    from tpu_ray_torch.render import graphs
    from tpu_ray_torch.tools import launch_counts

    before = set(graphs.PLANS)
    params = extract_params(scene, TRAINABLES)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    with ring_group(dev):
        step = make_sharded_fit_step(scene, cfg, target, params,
                                     torch.optim.SGD(params.values(), lr=0.0),
                                     scene_shards=scene_shards)
        with captures_timed() as captured:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pools = pools_line(before)
    counts = launch_counts()
    rel_loss = abs(loss - float(ref["loss"])) / abs(float(ref["loss"]))
    log(tag, f"mixed {cfg.width}x{cfg.height}x{cfg.spp}{', ring' if scene_shards else ''}, "
        f"make_sharded_fit_step, NCCL group of 1, six trainables: {dt:.3f} s, "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s; first step {first:.3f} s, its warm-ups and "
        f"captures {sum(captured):.3f} s ({len(captured)} graphs); {pools}; "
        f"loss {loss:.8f} (rel {rel_loss:.2e}); peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {counts} on {smi}")
    ok = rel_loss <= 1e-5
    for path, v in params.items():
        rel = rel_max(v.grad, ref["grads"][path])
        bound = 1e-4 if path == "mesh.verts" else 1e-5
        ok &= rel <= bound and bool(torch.isfinite(v.grad).all())
        log(tag, f"grad {path}: rel {rel:.3e} (bound {bound:.0e})")
    check(ok, f"{tag}: the graphed sharded step against its reference")
    check(counts == want_counts, f"{tag}: launches {counts} != {want_counts}")
    return counts


def fit_run(scene, cfg):
    """Phase 7: fit() for 3 Adam steps toward the CLI demo target."""
    from tpu_ray_torch.cli import demo_target
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.utils.config import FitConfig

    trainable = ("sdf.sph_radius", "materials.albedo", "lights.color", "mesh.verts")
    small = cfg.replace(width=480, height=272)
    target = demo_target(scene, small, trainable)
    t0 = time.perf_counter()
    _, history = fit(scene, small, target, trainable,
                     FitConfig(steps=3, learning_rate=1e-2), verbose=False)
    torch.cuda.synchronize()
    log("fit", f"mixed 480x272x16, {list(trainable)}, Adam lr 1e-2, accel refit "
        f"every step: loss history {[f'{v:.8f}' for v in history]} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(len(history) == 3 and all(map(torch.isfinite, torch.tensor(history)))
          and history[-1] < history[0], "the fit's loss did not fall")


def sil_fits(dev):
    """The README's silhouette fits through the port's examples: the sphere's
    radius, centre and albedo with the soft silhouette (256x256, 200 Adam
    steps; the loss falls at least 10x), and the floating triangle's slide,
    which hard visibility cannot see and the mesh edge band recovers
    (96x96, 150 steps each; |translate| from 0.1 to below 0.01)."""
    from tpu_ray_torch.examples import inverse_pose, inverse_rendering

    out = os.path.join(REPO, "build", "chip_smoke_fits")
    t0 = time.perf_counter()
    _, hist = inverse_rendering.main(out, device=dev, size=256, verbose=False)
    torch.cuda.synchronize()
    fall = hist[0] / max(hist[-1], 1e-30)
    log("sil_fits", f"inverse_rendering 256x256, 200 steps, soft_silhouette 0.05: loss "
        f"{hist[0]:.6f} -> {hist[-1]:.6e} ({fall:.1f}x) in {time.perf_counter() - t0:.2f} s")
    check(all(map(torch.isfinite, torch.tensor(hist))) and fall >= 10.0,
          "inverse_rendering: the loss did not fall 10x")
    t0 = time.perf_counter()
    err_hard, err_soft, h_hard, h_soft = inverse_pose.main_silhouette(
        out, device=dev, size=96, steps=150, verbose=False)
    torch.cuda.synchronize()
    log("sil_fits", f"inverse_pose --silhouette 96x96, 150 steps each: hard visibility loss "
        f"{h_hard[0]:.3e} -> {h_hard[-1]:.3e}, |translate| 0.1 -> {err_hard:.5f}; "
        f"mesh_silhouette 0.05 loss {h_soft[0]:.3e} -> {h_soft[-1]:.3e}, |translate| 0.1 -> "
        f"{err_soft:.5f} in {time.perf_counter() - t0:.2f} s")
    check(err_hard > 0.05 and err_soft < 0.01,
          "inverse_pose: hard visibility should stall and the edge band converge")


def resident_parity(scene, cfg, results, rays):
    """Phase 17: TPU kernel #4 against its plain version on phase 3's rays:
    the closest hit with sort_origin = o[0], the any-hit on their shadow
    rays with sort_dir = the light's direction. First seeded (the SDF seed,
    the 0-seeds of decided lanes) over the scene's accel, timed beside
    kernel #3 (slot order, the same seeds); then as the ring of phase 19
    calls it, unseeded over the ring's own shard: that call gives the
    `mixed_ring` entries."""
    from tpu_ray_torch.dist.sharding import ring_scene
    from tpu_ray_torch.kernels import cuda_mt

    packet = scene.packet[0]
    shard = ring_scene(scene).ring.accel()  # a ring of one: the whole posed mesh
    o, d = rays["o"], rays["d"]
    cases = (("resident_closest", (o, d), dict(t_init=rays["seed"]), dict(sort_origin=o[0])),
             ("resident_any_hit", (rays["p_off"], rays["l_dir"]),
              dict(any_hit=True, t_init=rays["aseed"]), dict(sort_dir=scene.lights.direction[0])))
    for key, (ro, rd), kw, hint in cases:
        any_hit = kw.get("any_hit", False)
        kw = dict(kw, t_max=cfg.t_far, **hint)
        hit_parity(f"resident_parity {key} seeded", cuda_mt.intersect_packet(packet, ro, rd, **kw),
                   cuda_mt.intersect_packet_torch(packet, ro, rd, **kw), any_hit)
        ms_seeded = kernel_ms(lambda: cuda_mt.intersect_packet(packet, ro, rd, **kw))
        kw3 = {k: v for k, v in kw.items() if k not in hint}
        ms3 = kernel_ms(lambda: cuda_mt.intersect_packet_streamed(packet, ro, rd, **kw3))
        ring_kw = dict(kw, t_init=None)
        err = hit_parity(f"resident_parity {key} as the ring calls it",
                         cuda_mt.intersect_packet(shard, ro, rd, **ring_kw),
                         cuda_mt.intersect_packet_torch(shard, ro, rd, **ring_kw), any_hit)
        results[key] = dict(
            max_abs_err=err, ms=kernel_ms(lambda: cuda_mt.intersect_packet(shard, ro, rd,
                                                                           **ring_kw)),
            plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_torch(shard, ro, rd, **ring_kw)),
            **packet_bound(shard, ro, None),
            counters=walk_counts(f"resident_parity {key}", ro.shape[0],
                                 lambda: cuda_mt.intersect_packet(shard, ro, rd, **ring_kw)))
        r = results[key]
        log("resident_parity", f"{key} on {ro.shape[0]} rays, {list(hint)}: as the ring calls "
            f"it (unseeded, the ring's shard) kernel #4 {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); seeded "
            f"over the scene's accel kernel #4 {ms_seeded:.3f} ms, kernel #3 (slot order) "
            f"{ms3:.3f} ms" + walk_rate(r))


# the knot1m frame's block that phase 18 takes (4,096 rays): the knot's
# centre, where the tube crosses itself
KNOT_POINTS = ((0.0, 1.12, 0.0),)
# rays of `knot8m`'s parity sample: its plain version makes 8.4M MT tests a ray
KNOT8M_SAMPLE = 1024


def knot_parts(dev, smi, results, counts):
    """Phase 18: `knot1m` with the whole-mesh accel (#3) and split into
    parts for the resident kernel (#4): #4 against its plain version part by
    part on 4,096 rays with the running t (closest and any-hit), the
    threaded parts against the whole-mesh walk, #3 against its plain
    version, then both 1024x1024x1 frames, with their launch counts."""
    from tpu_ray_torch.accel.packet import build_packet_parts
    from tpu_ray_torch.core.math3d import normalize
    from tpu_ray_torch.kernels import cuda_mt
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.utils.image_io import write_png

    t0 = time.perf_counter()
    knot, kcfg = build_scene("knot1m", device=dev)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = build_packet_parts(knot.mesh.verts.cpu().numpy(), knot.mesh.tris.cpu().numpy(),
                               streamed=False, device=dev)
    t_parts = time.perf_counter() - t0
    whole = knot.packet[0]
    log("knot1m_parts", f"{knot.mesh.num_tris} triangles: the scene with its whole-mesh accel "
        f"({whole.super_aabb.shape[0]} supers, {cuda_mt.accel_bytes(whole) / 2**20:.1f} MiB) "
        f"built on the host in {t_scene:.2f} s; {len(parts)} parts in {t_parts:.2f} s, supers "
        f"{[a.super_aabb.shape[0] for a in parts]}, MiB "
        f"{[round(cuda_mt.accel_bytes(a) / 2**20, 2) for a in parts]}")
    check(len(parts) == 6, f"knot1m split into {len(parts)} parts, 6 expected")

    o, d = block_rays(knot, kcfg.replace(block_size=4096), KNOT_POINTS, "knot1m_parts")
    entries = {"resident_closest": [], "resident_any_hit": []}

    def walk(ro, rd, seed0, any_hit, hint):
        """The parts in sequence, #4 against its plain version on each."""
        key = "resident_any_hit" if any_hit else "resident_closest"
        best, t_run = None, seed0
        for i, part in enumerate(parts):
            kw = dict(t_max=kcfg.t_far, any_hit=any_hit, t_init=t_run, **hint)
            k = cuda_mt.intersect_packet(part, ro, rd, **kw)
            p = cuda_mt.intersect_packet_torch(part, ro, rd, **kw)
            err = hit_parity(f"knot1m_parts part {i} {key}", k, p, any_hit)
            entries[key].append(dict(
                max_abs_err=err, ms=kernel_ms(lambda: cuda_mt.intersect_packet(part, ro, rd, **kw)),
                plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_torch(part, ro, rd, **kw)),
                **packet_bound(part, ro, t_run),
                counters=walk_counts(f"knot1m_parts part {i} {key}", ro.shape[0],
                                     lambda: cuda_mt.intersect_packet(part, ro, rd, **kw))))
            best = cuda_mt.fold_hits(best, k, any_hit)
            t_run = cuda_mt.running_t(best, kcfg.t_far, any_hit)
            if seed0 is not None:
                t_run = torch.minimum(t_run, seed0)
        return best

    def whole_walk(ro, rd, seed0, any_hit, key):
        """#3 over the whole-mesh accel against its plain version, timed."""
        kw = dict(t_max=kcfg.t_far, any_hit=any_hit, t_init=seed0)
        k = cuda_mt.intersect_packet_streamed(whole, ro, rd, **kw)
        p = cuda_mt.intersect_packet_streamed_torch(whole, ro, rd, **kw)
        err = hit_parity(f"knot1m whole {key}", k, p, any_hit)
        results["knot1m"][key] = dict(
            max_abs_err=err, ms=kernel_ms(lambda: cuda_mt.intersect_packet_streamed(whole, ro, rd,
                                                                                    **kw)),
            plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_streamed_torch(whole, ro, rd, **kw)),
            **packet_bound(whole, ro, seed0),
            counters=walk_counts(f"knot1m whole {key}", ro.shape[0],
                                 lambda: cuda_mt.intersect_packet_streamed(whole, ro, rd, **kw)))
        return k

    w = whole_walk(o, d, None, False, "packet_closest")
    hit_parity("knot1m parts threaded against the whole mesh",
               walk(o, d, None, False, dict(sort_origin=o[0])), w, False)
    with torch.no_grad():
        _, p_off, _, live = R.shadow_ray_origins(knot, kcfg, o, d, {"mesh_tri": w.tri,
                                                                    "mesh_hit": w.hit},
                                                 "mesh_grid", mesh_rows=R.mesh_table(knot.mesh))
    l_dir = normalize(knot.lights.direction[0]).expand_as(p_off).contiguous()
    aseed = torch.where(live, kcfg.t_far, 0.0).to(torch.float32)
    wa = whole_walk(p_off, l_dir, aseed, True, "packet_any_hit")
    hit_parity("knot1m parts threaded against the whole mesh",
               walk(p_off, l_dir, aseed, True, dict(sort_dir=knot.lights.direction[0])), wa, True)
    for key, rows in entries.items():
        summed = {c: sum(e["counters"][c] for e in rows) for c in cuda_mt.COUNTERS}
        summed["pass_share"] = summed["box_passes"] / max(summed["box_slots"], 1)
        results["knot1m_parts"][key] = {
            "max_abs_err": max(e["max_abs_err"] for e in rows),
            **{f: sum(e[f] for e in rows) / len(rows) for f in ("ms", "plain_ms", "bound_ms")},
            "bound_by": rows[0]["bound_by"], "counters": summed}
        log("knot1m_parts", f"{key} per part: kernel {[round(e['ms'], 4) for e in rows]} ms, "
            f"plain {[round(e['plain_ms'], 1) for e in rows]} ms, bound "
            f"{[round(e['bound_ms'], 5) for e in rows]} ms; #3 on the whole mesh "
            f"{results['knot1m'][key.replace('resident', 'packet')]['ms']:.3f} ms"
            + walk_rate(results["knot1m"][key.replace("resident", "packet")]))

    knot_launches(knot, kcfg, parts, results)

    n_blocks = -(-kcfg.num_rays // kcfg.block_size)
    imgs = {}
    with torch.no_grad():
        R.render_image(knot, kcfg.replace(width=128, height=128))
        for name, sc in (("knot1m", knot), ("knot1m_parts", knot.replace(packet=parts))):
            reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            imgs[name] = R.render_image(sc, kcfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts[name] = forward_counts()
            log("knot1m_parts", f"{name} frame {kcfg.width}x{kcfg.height}x{kcfg.spp}: {dt:.3f} s, "
                f"{kcfg.num_rays / dt / 1e6:.3f} Mrays/s, launches {counts[name]}, peak mem "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
            check(bool(torch.isfinite(imgs[name]).all()), f"{name} frame not finite")
            check(counts[name]["shade_fwd"] == n_blocks, f"{name}: shade_fwd launches")
    c, cp = counts["knot1m"], counts["knot1m_parts"]
    check(c["packet_closest"] == c["packet_any_hit"] == n_blocks
          and c["resident_closest"] == c["resident_any_hit"] == 0,
          f"knot1m whole-mesh frame launches {c}")
    check(cp["resident_closest"] == cp["resident_any_hit"] == len(parts) * n_blocks
          and cp["packet_closest"] == cp["packet_any_hit"] == 0,
          f"knot1m parts frame launches {cp}")
    err = (imgs["knot1m_parts"] - imgs["knot1m"]).abs().amax(-1)
    p99 = float(torch.quantile(err.flatten().double(), 0.99))
    frac = float((err > 1e-4).float().mean())
    log("knot1m_parts", f"parts frame against whole-mesh frame: per-pixel p99 {p99:.3e}, max "
        f"{float(err.max()):.3e}, pixels over 1e-5: {int((err > 1e-5).sum())}, over 1e-4: "
        f"{int((err > 1e-4).sum())} of {err.numel()} ({frac:.2e}, at most 1e-4)")
    check(p99 < 1e-5 and frac <= 1e-4, "knot1m parts frame against the whole-mesh frame")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    write_png(os.path.join(REPO, "build", "chip_smoke_knot1m.png"), imgs["knot1m_parts"].cpu().numpy())


def knot_launches(knot, kcfg, parts, results):
    """#3 and #4 on `knot1m` at its launch size (one block of
    kcfg.block_size rays, the one that holds KNOT_POINTS), with the very
    arguments the geometry pass gives them (recorded): #3 over the
    whole-mesh accel, #4 over each part with the running t (the mean over
    the parts)."""
    from tpu_ray_torch.kernels import cuda_mt

    o, d = block_rays(knot, kcfg, KNOT_POINTS, "knot1m_parts launch")
    for name, scene, fn, kernel in (
            ("knot1m", knot, "intersect_packet_streamed", "packet_kernel"),
            ("knot1m_parts", knot.replace(packet=parts), "intersect_packet",
             "packet_resident_kernel")):
        calls = []
        with recorded(cuda_mt, fn, calls):
            shade_inputs(scene, kcfg, o, d, "mesh_grid")
        per = len(calls) // 2
        check(per == len(scene.packet) and len(calls) == 2 * per,
              f"{name}: {len(calls)} {fn} calls for a block of {len(scene.packet)} parts")
        keys = (("packet" if name == "knot1m" else "resident") + s for s in ("_closest",
                                                                            "_any_hit"))
        for key, part_calls in zip(keys, (calls[:per], calls[per:])):
            rows = [dict(rays=o.shape[0], **timed_launch(
                lambda: getattr(cuda_mt, fn)(*a, **k), (kernel,),
                packet_bound(a[0], a[1], k.get("t_init")))) for a, k in part_calls]
            entry = launch_entry(rows)
            results[name][key]["launch"] = entry
            log_launch(name, key, entry, rows)


@contextlib.contextmanager
def ring_group(dev):
    """A process group of this one process (NCCL, through a file:// store
    under build/), destroyed on exit after the graph plans that captured
    its collectives (multihost.destroy): the ring at world size 1."""
    from tpu_ray_torch.dist.multihost import destroy, initialize

    store = os.path.join(REPO, "build", f"ring_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(dev)
    initialize(f"file://{store}", world_size=1, rank=0, backend="nccl")
    try:
        yield
    finally:
        destroy()
        if os.path.exists(store):
            os.remove(store)


def ring_frame(scene, cfg, smi, warm, dev, keep):
    """Phase 19: render_image_sharded of `mixed` with the accel partitioned
    around a ring of one process: every block's closest hit and shadow
    any-hit through kernel #4, none through #3; the image against
    render_image's of the same frame (the same rays): at most 1e-4 of the
    pixels off by > 1e-4. keep: a dict that receives the image (for
    ring_graph_frame)."""
    from tpu_ray_torch.dist.sharding import render_image_sharded
    from tpu_ray_torch.render.render import render_image

    with torch.no_grad():
        ref_img = render_image(scene, cfg)
    with ring_group(dev), torch.no_grad():
        render_image_sharded(scene, warm, scene_shards=True)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = render_image_sharded(scene, cfg, scene_shards=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = forward_counts()
    check(tuple(img.shape) == (cfg.height, cfg.width, 3) and bool(torch.isfinite(img).all()),
          "ring frame shape or values")
    check_ring_counts("ring frame", cfg, counts)
    err = (img - ref_img).abs().amax(-1)
    frac = float((err > 1e-4).float().mean())
    log("ring_frame", f"mixed {cfg.width}x{cfg.height}x{cfg.spp}, ring of 1: {dt:.3f} s, "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s, launches {counts}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}; against render_image's "
        f"frame: max {float(err.max()):.3e}, pixels over 1e-4 {frac:.2e} (at most 1e-4)")
    check(frac <= 1e-4, "ring frame against render_image's frame")
    keep.update(image=img, counts=counts)
    return counts


def check_ring_counts(what: str, cfg, counts, backward: bool = False) -> None:
    """The ring's launches: #4's closest and any-hit once a block, none of
    #3, the march once a group, and the shade forward once a block (twice
    in a graphed step, whose backward recomputes it)."""
    check_counts("mixed_ring", cfg, counts,
                 PATH_KERNELS["mixed_ring"] if backward else forward_kernels("mixed_ring"))
    n_blocks = -(-cfg.num_rays // cfg.block_size)
    check(counts["resident_closest"] == counts["resident_any_hit"] == n_blocks
          and counts["packet_closest"] == counts["packet_any_hit"] == 0,
          f"{what} launches {counts}")


def ring_graph_frame(scene, cfg, smi, dev, eager: dict):
    """Phase 19b: phase 19's frame through render_image_sharded_jit: the
    ring's walk, #4 and the (here empty) rotation inside each block's
    graph, the gather captured. The first call captures, the second is
    timed with the counts from 0; the image phase 19's bit for bit, the
    launches phase 19's."""
    from tpu_ray_torch.dist.sharding import render_image_sharded_jit
    from tpu_ray_torch.render import graphs

    check("image" in eager, "ring_graph_frame needs phase `ring_frame`'s image")
    before = set(graphs.PLANS)
    with ring_group(dev), torch.no_grad(), captures_timed() as captured:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image_sharded_jit(scene, cfg, scene_shards=True)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = render_image_sharded_jit(scene, cfg, scene_shards=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pools = pools_line(before)
    counts = forward_counts()
    same = torch.equal(img, eager["image"])
    log("ring_graph_frame", f"mixed {cfg.width}x{cfg.height}x{cfg.spp}, ring of 1, through "
        f"render_image_sharded_jit: {dt:.3f} s, {cfg.num_rays / dt / 1e6:.3f} Mrays/s; first "
        f"call {first:.3f} s, its warm-ups and captures {sum(captured):.3f} s "
        f"({len(captured)} graphs); {pools}; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; equal to phase 19's frame: "
        f"{same} (max {float((img - eager['image']).abs().max()):.3e}); launches {counts} "
        f"on {smi}")
    check(same, "graphed ring frame against the eager one")
    check_ring_counts("graphed ring frame", cfg, counts)
    check(counts == eager["counts"], f"graphed ring launches {counts} != {eager['counts']}")
    return counts


def eager_ring_step(scene, cfg, dev):
    """The data-parallel step with the ring as it runs eagerly at world size
    1 (render_pixels_flat over the dealt samples, the shard refit to the
    vertices, loss sum(px**2) / (n_px * 3)) for the six trainables ->
    step() -> (loss, gradients)."""
    from tpu_ray_torch.dist.scene_shard import refit_ring_packet
    from tpu_ray_torch.dist.sharding import ring_scene, shard_sample_coords
    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_pixels_flat
    from tpu_ray_torch.scene.transform import realize_scene

    ring = ring_scene(scene).ring
    base = scene.replace(packet=None)
    fx, fy, n_px, _ = shard_sample_coords(cfg, 1, dev)

    def step():
        params = extract_params(base, TRAINABLES)
        s = realize_scene(apply_params(base, params))
        s = s.replace(ring=refit_ring_packet(ring, s.mesh.verts, s.mesh.tris))
        loss = torch.sum(render_pixels_flat(s, cfg, fx, fy) ** 2) / (n_px * 3)
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in params.items()}

    return step


def ring_fit_step(scene, cfg, smi, warm, dev, keep):
    """Phase 20: the data-parallel step of `mixed` with the ring, eagerly
    (eager_ring_step: make_sharded_fit_step's computation before it was
    graphed), the six trainables, the shard refit (mesh.verts is
    trained): loss (rel 1e-5) and gradients (cosine > 0.999999) against
    those of render_image on the same frame, phase 6's computation, 254
    `shade_bwd` launches. keep: a dict that receives the loss and the
    gradients (for ring_graph_step)."""
    from tpu_ray_torch.tools import launch_counts

    ref_loss, ref_grads = grads_of(scene, cfg, TRAINABLES)
    with ring_group(dev):
        eager_ring_step(scene, warm, dev)()
        step = eager_ring_step(scene, cfg, dev)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = launch_counts()
    rel = float((loss - ref_loss).abs() / ref_loss.abs())
    log("ring_fit_step", f"mixed {cfg.width}x{cfg.height}x{cfg.spp}, ring of 1, six trainables, "
        f"eager: {dt:.3f} s, {cfg.num_rays / dt / 1e6:.3f} Mrays/s, loss {float(loss):.8f} "
        f"(render_image {float(ref_loss):.8f}, rel {rel:.2e}), launches {counts}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    ok = rel < 1e-5
    for path, g in grads.items():
        cos = cosine(g, ref_grads[path])
        ok &= cos > 0.999999 and bool(torch.isfinite(g).all())
        log("ring_fit_step", f"grad {path}: cosine {cos:.9f} against render_image's, rel "
            f"{rel_max(g, ref_grads[path]):.3e}, norm {float(g.norm()):.6e}")
    check(ok, "ring fit step against render_image's step")
    check_ring_counts("ring fit step", cfg, counts, backward=True)
    keep.update(loss=loss, grads=grads, counts=counts)
    return counts


@contextlib.contextmanager
def recorded(module, name, calls):
    """module.name patched to record each call's (args, kwargs) in calls."""
    real = getattr(module, name)

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    with mock.patch.object(module, name, rec):
        yield


def device_split(fn, names, reps: int = 10) -> dict:
    """Device time a call of a kernel wrapper spends in its kernels (the
    functions whose names contain one of `names`) and in the tensor ops the
    wrapper launches around them (the parameter packing, the cotangents'
    unpacking), in ms a call, from torch.profiler over reps calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):  # a window that recorded no device event is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        own = other = 0.0
        n_other = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            if any(n in e.key for n in names):
                own += e.self_device_time_total
            else:
                other += e.self_device_time_total
                n_other += e.count
        if own > 0:
            break
    return dict(kernel_ms=own / reps / 1e3, wrapper_ms=other / reps / 1e3,
                wrapper_ops=n_other / reps)


def shadow_summary(c) -> str:
    """What a shadow march's counters (cuda_sdf.SHADOW_COUNTERS) say."""
    return (f"live {c['live']}, marching after the cull {c['marching']}, DE steps "
            f"{c['steps']} ({c['steps'] / max(c['marching'], 1):.2f} a marching ray, at most "
            f"{c['steps_max']}), lane efficiency {c['steps'] / max(32 * c['warp_steps'], 1):.4f}, "
            f"warp cycles mean {c['warp_cycles'] / max(c['warps'], 1):.0f} max "
            f"{c['warp_cycles_max']} over {c['warps']} warps")


def shade_summary(c) -> str:
    """What the shade backward's counters (cuda_shade.SHADE_BWD_COUNTERS)
    say: rays by class, mixed warps, cycles a warp by its costliest class,
    the reduction's cycles."""
    from tpu_ray_torch.kernels.cuda_shade import RAY_CLASSES

    by = ", ".join(f"{k} {c[f'warps_{k}']} warps mean {c[f'cycles_{k}'] / max(c[f'warps_{k}'], 1):.0f} "
                   f"max {c[f'cycles_max_{k}']}" for k in RAY_CLASSES)
    return (f"rays sky {c['rays_sky']} mesh {c['rays_mesh']} sdf {c['rays_sdf']} bulb "
            f"{c['rays_bulb']} (with AO or penumbra {c['rays_bulb_ao']}); warps {c['warps']}, "
            f"mixing classes as run {c['warps_mixed']}, as loaded {c['warps_mixed_loaded']}; "
            f"cycles a warp by its costliest class: {by}; block reduction cycles mean "
            f"{c['epilogue_cycles'] / max(c['blocks'], 1):.0f} max {c['epilogue_cycles_max']} over "
            f"{c['blocks']} blocks; second pass at most {c['sum_cycles_max']} cycles a thread")


def launch_entry(blocks) -> dict:
    """A kernel's per-launch entry from its blocks' rows (ms, kernel_ms,
    wrapper_ms, wrapper_ops, bound_ms, bound_by, optional counters): the
    means over the blocks, each block's numbers, the counters summed (their
    maxima as maxima)."""
    from tpu_ray_torch.kernels import cuda_shade

    entry = {"rays": blocks[0]["rays"], "block_ms": [e["ms"] for e in blocks],
             "block_bound_ms": [e["bound_ms"] for e in blocks],
             "block_kernel_ms": [e["kernel_ms"] for e in blocks],
             "block_wrapper_ms": [e["wrapper_ms"] for e in blocks],
             "wrapper_ops": blocks[0]["wrapper_ops"],
             "ms": sum(e["ms"] for e in blocks) / len(blocks),
             "bound_ms": sum(e["bound_ms"] for e in blocks) / len(blocks),
             "bound_by": blocks[0]["bound_by"]}
    if "counters" in blocks[0]:
        entry["counters"] = {k: sum(e["counters"][k] for e in blocks)
                             for k in blocks[0]["counters"]}
        for k in ("steps_max", "warp_cycles_max", "epilogue_cycles_max",
                  "sum_cycles_max") + tuple(f"cycles_max_{c}" for c in cuda_shade.RAY_CLASSES):
            if k in entry["counters"]:
                entry["counters"][k] = max(e["counters"][k] for e in blocks)
    return entry


def log_launch(path, key, entry, blocks) -> None:
    log("launch", f"{path} {key} at {entry['rays']} rays a launch: mean {entry['ms']:.4f} ms "
        f"(blocks {[round(x, 4) for x in entry['block_ms']]}), bound "
        f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}; blocks "
        f"{[round(x, 5) for x in entry['block_bound_ms']]}); profiled device time a "
        f"call in the kernel {[round(x, 4) for x in entry['block_kernel_ms']]} ms, in "
        f"the wrapper's {entry['wrapper_ops']:.0f} tensor ops "
        f"{[round(x, 4) for x in entry['block_wrapper_ms']]} ms")
    for b, e in enumerate(blocks):
        if "counters" in e:
            log("launch", f"{path} {key} block {b} counters: "
                + (shade_summary(e["counters"]) if key == "shade_bwd"
                   else shadow_summary(e["counters"])))


def timed_launch(fn, names, bound_of, counters=None) -> dict:
    """One kernel launch of the path's size: its CUDA-event time, the
    profiler's split (kernel / wrapper's tensor ops), its bound and, given
    (launch taking counters, counter names), its counters."""
    row = dict(ms=kernel_ms(fn), **device_split(fn, names), **bound_of)
    if counters is not None:
        row["counters"] = counted(*counters)
    return row


def recon_values(r) -> tuple:
    """A cuda_reconstruct.Recon's tensors in order (None where it has none)."""
    return (*r.hits, r.closer, r.nf, r.p_off, r.live)


def reconstruct_row(path, args, kw) -> dict:
    """The reconstruct kernel (cuda_reconstruct) on the call the geometry
    pass made for a block (args, kw as recorded), against its plain version
    (render.shadow_ray_origins_plain) on the card: t, hit, p, mat, cov, the
    closest-select mask and the live lanes bit-equal; the normal, the
    ray-facing normal and the shadow origins under tests/recon_witness.py's
    rule (per ray, the largest component within 1e-5 on >= 99% of the rays
    and within 1e-4 on every hit ray, past either only where the float64
    witness at the same hit point sides with the kernel), each hit ray over
    1e-4 logged with its distances from the witness. Also: float64 rays
    raise. -> the launch's row (timed_launch) with its parity error and the
    plain version's time. The bound: the rays' inputs and outputs and the
    selected triangles' rows read once; the argmin's DE at the SDF point
    and the adjoint's reverse pass counted as one DE more, ~60 operations a
    mesh re-solve."""
    from tpu_ray_torch.kernels import cuda_reconstruct as CR
    from tpu_ray_torch.render.render import shadow_ray_origins_plain

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import recon_witness

    scene, cfg, o, d, res, method = args
    rows = kw.get("mesh_rows")

    def plain():
        aux = {}
        hits, p_off, nf, live = shadow_ray_origins_plain(scene, cfg, o, d, res, method,
                                                         mesh_rows=rows, aux_out=aux)
        return CR.Recon(hits, aux.get("closer"), nf, p_off, live)

    got = CR.reconstruct(*args, **kw)
    want = plain()
    for name, x, y in zip(("t", "hit", "p", "n", "mat", "cov", "closer", "nf", "p_off", "live"),
                          recon_values(got), recon_values(want)):
        if name in ("n", "nf", "p_off"):
            continue
        check((x is None) == (y is None) and (x is None or torch.equal(x, y)),
              f"reconstruct {path}: {name} not bit-equal to the plain version")
    wit = recon_witness.witness(scene, cfg, o, d, want.hits, want.closer, method)
    worst = 0.0
    for name, x, y in (("n", got.hits[3], want.hits[3]), ("nf", got.nf, want.nf),
                       ("p_off", got.p_off, want.p_off)):
        j = recon_witness.judge(x, y, wit[name], want.hits[1])
        log("launch", f"reconstruct {path} " + recon_witness.describe(name, j))
        check(j["ok"], f"reconstruct {path}: {name} parity")
        worst = max(worst, j["max_err"])
    try:
        CR.reconstruct(scene, cfg, o.double(), d.double(), res, method, **kw)
        raised = False
    except TypeError:
        raised = True
    check(raised, f"reconstruct {path}: float64 rays did not raise")
    ins = [o, d] + [res.get(k) for k in ("sdf_t", "sdf_tmin", "sdf_hit", "mesh_tri", "mesh_hit")]
    n_bytes = nbytes(*ins, *(v for v in recon_values(got)[:-1] if v is not None))
    ops = 0.0
    if method in ("sdf", "mixed") and scene.has_sdf:
        t_eff = (torch.where(res["sdf_hit"], res["sdf_t"], res["sdf_tmin"])
                 if cfg.soft_silhouette > 0.0 else res["sdf_t"])
        ops += 2.0 * float(de_ops(scene.sdf, o + t_eff[:, None] * d).sum())
    if method in ("mesh_brute", "mesh_grid", "mixed") and scene.has_mesh:
        n_bytes += 40 * o.shape[0]
        ops += 60.0 * o.shape[0]
    row = timed_launch(lambda: CR.reconstruct(*args, **kw), ("reconstruct_kernel",),
                       bound(n_bytes, ops))
    row.update(err=worst, plain_ms=wall_ms(plain))
    return row


def reconstruct_call_ms(path, scene, cfg, method, packed, o, d) -> float:
    """The reconstruct kernel's time a call (CUDA events) on all the path's
    parity blocks' rays at once (131,072 rays: the table's call size)."""
    from tpu_ray_torch.kernels import cuda_reconstruct
    from tpu_ray_torch.render import render as R

    rows = R.mesh_table(scene.mesh) if R._use_mesh(scene, method) else None
    with torch.no_grad():
        res = R.geometry_residuals(scene, cfg.replace(shadow="none", ao="none"), o, d, method,
                                   mesh_rows=rows, packed=packed)
    ms = kernel_ms(lambda: cuda_reconstruct.reconstruct(scene, cfg, o, d, res, method,
                                                        mesh_rows=rows, packed=packed))
    log("launch", f"{path} reconstruct at {o.shape[0]} rays a call: {ms:.4f} ms")
    return ms


def frame_rays(scene, cfg):
    """Every primary ray of the frame in Morton block order, padded to whole
    blocks as render_pixels_flat pads them: (xs, ys, o, d)."""
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays

    _, fx, fy, _ = R.frame_samples(scene, cfg)
    fx, fy, _ = R.whole_blocks(cfg, fx, fy)
    with torch.no_grad():
        o, d = generate_rays(scene.camera, fx, fy, cfg.width, cfg.height)
    return fx, fy, o, d


def device_ms(launches, batch: int = 256) -> tuple:
    """Device time of the launches, in ms, and the host's time to enqueue
    them: CUDA events around each batch of `batch` launches, each batch
    queued behind a spin kernel (~0.2 ms a launch at ~1.9 GHz) that outlasts
    its enqueue. A batch stays within the device's queue of pending
    launches, which would otherwise hold the host back to the device's
    pace and let idle gaps into the timed span."""
    total = host = 0.0
    for i in range(0, len(launches), batch):
        part = launches[i:i + batch]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000 * len(part))
        start.record()
        t0 = time.perf_counter()
        for fn in part:
            fn()
        host += time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total, host * 1e3


def group_sweep(path, scene, cfg, packed, groups) -> dict:
    """The primary march of the whole frame as render_pixels_flat runs it,
    one launch per group of G blocks, for each G in groups: device time of
    the frame's launches (device_ms, after a warm-up frame), its launches,
    ms a launch and ns a ray. -> {G: row}, and the smallest G within 10% of
    the best time a ray."""
    from tpu_ray_torch.kernels import cuda_sdf
    from tpu_ray_torch.render import render as R

    _, _, o, d = frame_rays(scene, cfg)
    kw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far,
              bound_pad=R._bound_pad(cfg), packed=packed)
    rows = {}
    for g in groups:
        n = g * cfg.block_size
        launches = [lambda s=s: cuda_sdf.march(scene.sdf, o[s:s + n], d[s:s + n], **kw)
                    for s in range(0, o.shape[0], n)]
        for fn in launches:  # warm-up
            fn()
        ms, host_ms = device_ms(launches)
        rows[g] = dict(launches=len(launches), ms=ms, ms_a_launch=ms / len(launches),
                       ns_a_ray=ms * 1e6 / o.shape[0])
        log("launch", f"{path} march over the frame ({o.shape[0]} rays, "
            f"{o.shape[0] // cfg.block_size} blocks) in groups of {g} blocks: "
            f"{len(launches)} launches, {ms:.4f} ms a frame, {ms / len(launches):.4f} ms a "
            f"launch, {rows[g]['ns_a_ray']:.5f} ns a ray (host enqueue {host_ms:.1f} ms)")
    best = min(r["ns_a_ray"] for r in rows.values())
    chosen = min(g for g, r in rows.items() if r["ns_a_ray"] <= 1.1 * best)
    log("launch", f"{path} group sweep: the smallest group within 10% of the best time a ray "
        f"is {chosen} blocks; render.MARCH_GROUP = {R.MARCH_GROUP}")
    return {"groups": {str(g): r for g, r in rows.items()}, "chosen": chosen}


def group_launch(path, scene, cfg, packed, points) -> dict:
    """One launch of the primary march as render_pixels_flat makes it: the
    group of render.MARCH_GROUP blocks that holds the path's first parity
    block, with the arguments march_group passes (recorded): its time, the
    profiler's split, its counters and the bound of the group's work. The
    bound's operations: StepWork over the plain march of the whole group in
    one call, every ray's DE evaluations counted at their points (the same
    count a block at a time gives, in 1/MARCH_GROUP of the launches)."""
    from tpu_ray_torch.kernels import cuda_sdf
    from tpu_ray_torch.render import render as R

    fx, fy, _, _ = frame_rays(scene, cfg)
    perm = R._block_order_perm(cfg).to(scene.device)
    b = parity_blocks(scene, cfg, perm, points[:1])[0]
    n = R.MARCH_GROUP * cfg.block_size
    g0 = b * cfg.block_size // n * n
    calls = []
    with recorded(cuda_sdf, "march", calls):
        R.march_group(scene, cfg, fx[g0:g0 + n], fy[g0:g0 + n], packed, cfg.block_size)
    (args, kw), = calls
    plain_kw = {k: v for k, v in kw.items() if k != "packed"}
    work = StepWork(scene.sdf, 8.0)
    cuda_sdf.march_torch(*args, **plain_kw, visit=work)
    rays = args[1].shape[0]
    row = dict(rays=rays, **timed_launch(
        lambda: cuda_sdf.march(*args, **kw), ("march_kernel",),
        bound(nbytes(args[1], args[2]) + 13 * rays, work.ops),
        (lambda c: cuda_sdf.march(*args, **kw, counters=c), cuda_sdf.SHADOW_COUNTERS)))
    entry = launch_entry([row])
    log("launch", f"{path} march: the group of blocks {g0 // cfg.block_size}.."
        f"{(g0 + rays) // cfg.block_size - 1} (holding block {b}) in one launch")
    log_launch(path, "march", entry, [row])
    return entry


def launch_sizes(paths, results):
    """Phase `launch`: the kernels timed as render_pixels_flat launches
    them, with the parameters packed once (cuda_shade.pack, as the frame
    packs them). #1: one launch over its group of render.MARCH_GROUP blocks
    (the group that holds the first parity block), and the whole frame's
    march in groups of 1 and MARCH_GROUP blocks (a sweep of 1, 4, 16 and
    32 chose the group; cut to keep the script's time). Per block of the path (32,768
    rays for `mixed` and `mixed_sil`, 65,536 for the bulb paths), on each of
    the path's parity blocks: the primary march of that block alone, the
    shadow march and the packet walks with the very arguments the geometry
    pass passes them (recorded), #4 as the ring calls it on the `mixed`
    blocks (unseeded, over the ring's shard: the `mixed_ring` entries), the
    shade forward with the frame's config and the backward with the fit
    step's. Each with the bound of that launch's work and, for #1, #2 and
    #6, the kernel's counters. paths: {path: (scene, frame config, fit-step
    config, world points of its blocks, method)}."""
    from tpu_ray_torch.dist.sharding import ring_scene
    from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_sdf, cuda_shade
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.sdf.primitives import sdf_bounding_spheres

    for path, (scene, cfg, fit_cfg, points, method) in paths.items():
        packed = cuda_shade.pack(scene, R._bound_pad(cfg))
        fit_packed = cuda_shade.pack(scene, R._bound_pad(fit_cfg))
        results[path].setdefault("march", {})["sweep"] = group_sweep(
            path, scene, cfg, packed, (1, R.MARCH_GROUP))
        results[path]["march"]["launch"] = group_launch(path, scene, cfg, packed, points)
        o_all, d_all = block_rays(scene, cfg, points, f"launch {path}")
        bs, sdf = cfg.block_size, scene.sdf
        soft = cfg.shadow == "soft"
        shadow = "shadow_soft" if soft else "shadow_hard"
        kernel, plain = getattr(cuda_sdf, shadow), getattr(cuda_sdf, f"{shadow}_torch")
        bounds = sdf_bounding_spheres(sdf)
        n_bounds = 0 if soft or bounds is None else bounds.shape[0]
        walks = ("packet_closest", "packet_any_hit") if scene.has_mesh else ()
        ring = ("resident_closest", "resident_any_hit") if path == "mixed" else ()
        shard = ring_scene(scene).ring.accel() if ring else None
        rows = {k: [] for k in ("march", shadow, *walks, *ring, "reconstruct", "shade_fwd",
                                "shade_bwd")}
        for b in range(o_all.shape[0] // bs):
            o, d = o_all[b * bs:(b + 1) * bs], d_all[b * bs:(b + 1) * bs]
            calls = {"march": [], shadow: [], "walks": [], "reconstruct": []}
            with recorded(cuda_sdf, "march", calls["march"]), \
                    recorded(cuda_sdf, shadow, calls[shadow]), \
                    recorded(cuda_mt, "intersect_packet_streamed", calls["walks"]), \
                    recorded(cuda_reconstruct, "reconstruct", calls["reconstruct"]):
                res, aux, corners, spec = shade_inputs(scene, cfg, o, d, method, packed)
            check(len(calls["march"]) == 1 and len(calls[shadow]) == 1
                  and len(calls["walks"]) == len(walks) and len(calls["reconstruct"]) == 1,
                  f"launch {path}: {[(k, len(v)) for k, v in calls.items()]} calls for a block")
            args, kw = calls["march"][0]
            plain_kw = {k: v for k, v in kw.items() if k != "packed"}
            work = StepWork(sdf, 8.0)
            cuda_sdf.march_torch(*args, **plain_kw, visit=work)
            rows["march"].append(dict(rays=bs, **timed_launch(
                lambda: cuda_sdf.march(*args, **kw), ("march_kernel",),
                bound(nbytes(args[1], args[2]) + 13 * bs, work.ops),
                (lambda c: cuda_sdf.march(*args, **kw, counters=c), cuda_sdf.SHADOW_COUNTERS))))
            args, kw = calls[shadow][0]
            plain_kw = {k: v for k, v in kw.items() if k != "packed"}
            work = StepWork(sdf, 10.0 if soft else 8.0)
            plain(*args, **plain_kw, visit=work)
            rows[shadow].append(dict(rays=bs, **timed_launch(
                lambda: kernel(*args, **kw), ("shadow_kernel",),
                bound(nbytes(args[1], args[2], kw.get("t_far_rays")) + 8 * bs,
                      work.ops + 20.0 * n_bounds * bs),
                (lambda c: kernel(*args, **kw, counters=c), cuda_sdf.SHADOW_COUNTERS))))
            for key, (args, kw) in zip(walks, calls["walks"]):
                rows[key].append(dict(rays=bs, **timed_launch(
                    lambda: cuda_mt.intersect_packet_streamed(*args, **kw), ("packet_kernel",),
                    packet_bound(args[0], args[1], kw.get("t_init")))))
            ring_kw = (dict(sort_origin=o[0]),
                       dict(any_hit=True, sort_dir=scene.lights.direction[0]))
            for key, (wargs, _), kw in zip(ring, calls["walks"], ring_kw):
                ro, rd = wargs[1], wargs[2]
                rows[key].append(dict(rays=bs, **timed_launch(
                    lambda: cuda_mt.intersect_packet(shard, ro, rd, t_max=cfg.t_far, **kw),
                    ("packet_resident_kernel",), packet_bound(shard, ro, None))))
            rows["reconstruct"].append(dict(rays=bs, **reconstruct_row(
                path, *calls["reconstruct"][0])))
            fwd = lambda: cuda_shade.shade_fwd(scene, cfg, o, d, res, method, corners=corners,
                                               aux=aux, packed=packed)
            rows["shade_fwd"].append(dict(rays=bs, **timed_launch(
                fwd, ("shade_fwd_kernel",),
                shade_bound(scene, cfg, o, d, res, aux, corners, spec, method, [fwd()], False))))
            if fit_cfg != cfg:
                res, aux, corners, spec = shade_inputs(scene, fit_cfg, o, d, method, fit_packed)
            ct = seeded_cotangent(o)
            bwd = (scene, fit_cfg, o, d, res, aux, corners, ct, method)
            g = cuda_shade.shade_bwd(*bwd, packed=fit_packed)
            rows["shade_bwd"].append(dict(rays=bs, **timed_launch(
                lambda: cuda_shade.shade_bwd(*bwd, packed=fit_packed),
                ("shade_bwd_kernel", "sum_partials_kernel"),
                shade_bound(scene, fit_cfg, o, d, res, aux, corners, spec, method,
                            [ct, g["o"], g["d"], g["corners"]], True),
                (lambda c: cuda_shade.shade_bwd(*bwd, counters=c, packed=fit_packed),
                 cuda_shade.SHADE_BWD_COUNTERS))))
        for key, blocks in rows.items():
            entry = launch_entry(blocks)
            table = results["mixed_ring" if key in ring else path].setdefault(key, {})
            # the march's block entry: one block alone (the main path's launch is the group's)
            table["launch_block" if key == "march" else "launch"] = entry
            log_launch("mixed_ring" if key in ring else path,
                       "march (one block a launch)" if key == "march" else key, entry, blocks)
            if key == "reconstruct":  # its entry of the kernels line
                table.update(max_abs_err=max(e["err"] for e in blocks),
                             ms=reconstruct_call_ms(path, scene, cfg, method, packed, o_all,
                                                    d_all),
                             # the call covers the blocks' rays: their plain times and
                             # bounds summed
                             plain_ms=sum(e["plain_ms"] for e in blocks),
                             bound_ms=sum(e["bound_ms"] for e in blocks),
                             bound_by=entry["bound_by"])


def knot8m(dev, smi, results, counts):
    """Phase `knot8m`: the 8.39M-triangle knot. The host build of its accel
    (the native builder, then the numpy build, the disk cache off), then
    the cached load (each timed and equal to the scene's accel); #3
    closest and any-hit against their plain versions on KNOT8M_SAMPLE rays
    strided over the frame (the plain version tests all 8.4M triangles a
    ray), timed with their bound and counters; on one 65,536-ray block, #3
    at its launch size (the geometry pass's arguments), the reconstruct's
    mesh-only branch and #5 against their plain versions, the corner gather
    against the indexing; the 1024x1024x1 frame through render_image_jit against the eager one, with its launches
    (each of PATH_KERNELS["knot8m"] once a block), time and peak memory."""
    from tpu_ray_torch import native
    from tpu_ray_torch.accel import packet as pk
    from tpu_ray_torch.core.math3d import normalize
    from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct
    from tpu_ray_torch.render import graphs
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.utils.image_io import write_png

    t0 = time.perf_counter()
    knot, kcfg = build_scene("knot8m", device=dev)
    t_scene = time.perf_counter() - t0
    verts, tris = knot.mesh.verts.cpu().numpy(), knot.mesh.tris.cpu().numpy()
    (whole,) = knot.packet

    def same(parts):
        return len(parts) == 1 and all(torch.equal(getattr(parts[0], f), getattr(whole, f))
                                       for f in ("corners", "chunk_aabb", "super_aabb", "perm"))

    cache = pk.cache_dir()
    with mock.patch.dict(os.environ, {pk.CACHE_ENV: ""}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = pk.build_packet_parts(verts, tris, device=dev)
        torch.cuda.synchronize()
        t_native = time.perf_counter() - t0
    check(same(built), "knot8m: the native build differs from the scene's accel")
    del built
    with mock.patch.dict(os.environ, {pk.CACHE_ENV: "", native.ENV_SWITCH: "0"}):
        t0 = time.perf_counter()
        built = pk.build_packet_parts(verts, tris, device=dev)
        torch.cuda.synchronize()
        t_numpy = time.perf_counter() - t0
    check(same(built), "knot8m: the numpy build differs from the native one")
    del built
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = pk.build_packet_parts(verts, tris, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(same(loaded), "knot8m: the cached accel differs from the scene's")
    del loaded
    log("knot8m", f"{knot.mesh.num_tris} triangles, one whole-mesh part: "
        f"{whole.chunk_aabb.shape[0]} chunks (padded), {whole.super_aabb.shape[0]} supers, "
        f"{cuda_mt.accel_bytes(whole) / 2**20:.1f} MiB; the scene built in {t_scene:.2f} s "
        f"(the mesh, the native accel build and the cache write); "
        f"the accel alone: native build and upload {t_native:.2f} s, numpy build and upload "
        f"{t_numpy:.2f} s, cached load and upload {t_load:.2f} s (cache {cache})")
    check(whole.perm.shape[0] == 8_388_736 and whole.super_aabb.shape[0] == 4_097,
          f"knot8m accel shape {tuple(whole.perm.shape)}, {whole.super_aabb.shape[0]} supers")

    # every (R / KNOT8M_SAMPLE)-th primary ray of the frame: the knot, the
    # ground (lit and in the knot's shadow) and the sky
    sx, sy = R.pixel_sample_coords(kcfg, dev)
    step = kcfg.num_rays // KNOT8M_SAMPLE
    with torch.no_grad():
        o, d = generate_rays(knot.camera, sx.reshape(-1)[step // 2::step],
                             sy.reshape(-1)[step // 2::step], kcfg.width, kcfg.height)
    results["knot8m"] = {}

    def walk(ro, rd, seed0, any_hit, key):
        kw = dict(t_max=kcfg.t_far, any_hit=any_hit, t_init=seed0)
        k = cuda_mt.intersect_packet_streamed(whole, ro, rd, **kw)
        p = cuda_mt.intersect_packet_streamed_torch(whole, ro, rd, **kw)
        err = hit_parity(f"knot8m {key}", k, p, any_hit)
        results["knot8m"][key] = dict(
            max_abs_err=err,
            ms=kernel_ms(lambda: cuda_mt.intersect_packet_streamed(whole, ro, rd, **kw)),
            plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_streamed_torch(whole, ro, rd, **kw)),
            **packet_bound(whole, ro, seed0),
            counters=walk_counts(f"knot8m {key}", ro.shape[0],
                                 lambda: cuda_mt.intersect_packet_streamed(whole, ro, rd, **kw)))
        return k

    w = walk(o, d, None, False, "packet_closest")
    with torch.no_grad():
        _, p_off, _, live = R.shadow_ray_origins(knot, kcfg, o, d, {"mesh_tri": w.tri,
                                                                    "mesh_hit": w.hit},
                                                 "mesh_grid", mesh_rows=R.mesh_table(knot.mesh))
    l_dir = normalize(knot.lights.direction[0]).expand_as(p_off).contiguous()
    walk(p_off, l_dir, torch.where(live, kcfg.t_far, 0.0).to(torch.float32), True,
         "packet_any_hit")
    for key in ("packet_closest", "packet_any_hit"):
        r = results["knot8m"][key]
        log("knot8m", f"{key} on {o.shape[0]} rays: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})" + walk_rate(r))

    o, d = block_rays(knot, kcfg, KNOT_POINTS, "knot8m launch")
    calls = {"walks": [], "reconstruct": []}
    with recorded(cuda_mt, "intersect_packet_streamed", calls["walks"]), \
            recorded(cuda_reconstruct, "reconstruct", calls["reconstruct"]):
        res = shade_inputs(knot, kcfg, o, d, "mesh_grid")[0]
    check(len(calls["walks"]) == 2 and len(calls["reconstruct"]) == 1,
          f"knot8m: {[(k, len(v)) for k, v in calls.items()]} calls for a block")
    for key, (a, k) in zip(("packet_closest", "packet_any_hit"), calls["walks"]):
        rows = [dict(rays=o.shape[0], **timed_launch(
            lambda: cuda_mt.intersect_packet_streamed(*a, **k), ("packet_kernel",),
            packet_bound(a[0], a[1], k.get("t_init"))))]
        results["knot8m"][key]["launch"] = launch_entry(rows)
        log_launch("knot8m", key, results["knot8m"][key]["launch"], rows)
    # the reconstruct's mesh-only branch and #5 on the same block, against
    # their plain versions
    row = dict(rays=o.shape[0], **reconstruct_row("knot8m", *calls["reconstruct"][0]))
    results["knot8m"]["reconstruct"] = dict(
        max_abs_err=row["err"], launch=launch_entry([row]),
        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    log_launch("knot8m", "reconstruct", results["knot8m"]["reconstruct"]["launch"], [row])
    del calls
    # the corner gather on the same block's triangle ids, clamped as the
    # shade clamps them, into the knot's own table
    mesh_rows = R.mesh_table(knot.mesh)
    ids = res["mesh_tri"].clamp(0, mesh_rows.shape[0] - 1).to(torch.int32)
    g = results["knot8m"]["corner_gather"] = gather_row("knot8m", mesh_rows, ids)
    log("knot8m", f"corner_gather on {ids.numel()} rays: {g['ms']:.5f} ms in a graph, plain "
        f"{g['plain_ms']:.3f} ms host, bound {g['bound_ms']:.5f} ms; bit-equal to the indexing")
    del mesh_rows, res
    shade_fwd_parity(knot, kcfg, o, d, "mesh_grid", results["knot8m"])

    # the frame: eager (the image's reference), then through render_image_jit
    # (its first call warms up and captures, the second is timed, its
    # launches counted from 0)
    n_blocks = -(-kcfg.num_rays // kcfg.block_size)
    with torch.no_grad():
        t0 = time.perf_counter()
        eager = R.render_image(knot, kcfg)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        graphs.PLANS.clear()
        t0 = time.perf_counter()
        R.render_image_jit(knot, kcfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = R.render_image_jit(knot, kcfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts["knot8m"] = c = forward_counts()
    err = float((img - eager).abs().max())
    log("knot8m", f"frame {kcfg.width}x{kcfg.height}x{kcfg.spp} through render_image_jit: "
        f"{dt:.3f} s, {kcfg.num_rays / dt / 1e6:.3f} Mrays/s (eager {t_eager:.3f} s; first "
        f"call, its warm-ups and captures, {first:.3f} s); max |jit - eager| {err:.3e}; "
        f"launches {c}, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    check(bool(torch.isfinite(img).all()) and tuple(img.shape) == (1024, 1024, 3),
          "knot8m frame not finite or of the wrong shape")
    check(err <= 1e-6, f"knot8m graphed frame against the eager one: max abs {err:.3e} > 1e-6")
    check(all(c[k] == n_blocks for k in PATH_KERNELS["knot8m"])
          and all(n == 0 for k, n in c.items() if k not in PATH_KERNELS["knot8m"]),
          f"knot8m frame launches {c}: each of {PATH_KERNELS['knot8m']} once a block "
          f"({n_blocks}), nothing else")
    graphs.PLANS.clear()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    write_png(os.path.join(REPO, "build", "chip_smoke_knot8m.png"), img.cpu().numpy())


def grid_oracle(dev, smi, results, counts):
    """Phase `grid_oracle`: BASELINE config 3, `bunny` at 512x512, its
    uniform grid built on the host; #3 closest-hit on every primary ray and
    any-hit on every shadow ray (512x512, one launch each, as the frame
    makes them) against the grid's DDA (kernels/dda.py, plain torch on the
    card), under hit_parity's rule; the DDA's time; #3 against its plain
    version on the 32,768 rays of the bunny's centre rows; the frame's
    launches."""
    from tpu_ray_torch.accel.grid_build import grid_stats
    from tpu_ray_torch.core.math3d import normalize
    from tpu_ray_torch.kernels import cuda_mt, dda
    from tpu_ray_torch.kernels.moller_trumbore import TriHit
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays
    from tpu_ray_torch.scene.scenes import build_scene

    t0 = time.perf_counter()
    scene, cfg = build_scene("bunny", device=dev)
    log("grid_oracle", f"bunny: {scene.mesh.num_tris} triangles, packet accel and grid built "
        f"in {time.perf_counter() - t0:.2f} s; grid {grid_stats(scene.grid)}")
    (packet,) = scene.packet
    sx, sy = R.pixel_sample_coords(cfg, dev)
    with torch.no_grad():
        o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), cfg.width, cfg.height)
    k = cuda_mt.intersect_packet_parts(scene.packet, o, d, t_max=cfg.t_far)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = dda.intersect_grid(scene.mesh, scene.grid, o, d, t_max=cfg.t_far)
    torch.cuda.synchronize()
    t_dda = time.perf_counter() - t0
    hit_parity("grid_oracle #3 closest against the DDA", k, g, False)
    with torch.no_grad():
        _, p_off, _, live = R.shadow_ray_origins(scene, cfg, o, d, {"mesh_tri": k.tri,
                                                                    "mesh_hit": k.hit},
                                                 "mesh_grid", mesh_rows=R.mesh_table(scene.mesh))
    l_dir = normalize(scene.lights.direction[0]).expand_as(p_off).contiguous()
    aseed = torch.where(live, cfg.t_far, 0.0).to(torch.float32)
    ka = cuda_mt.intersect_packet_streamed(packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True,
                                           t_init=aseed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ga = dda.intersect_grid(scene.mesh, scene.grid, p_off, l_dir, t_max=cfg.t_far, any_hit=True)
    torch.cuda.synchronize()
    t_dda_any = time.perf_counter() - t0
    hit_parity("grid_oracle #3 any-hit against the DDA (live rays)", ka,
               TriHit(ga.t, ga.tri, ga.hit & live), True)
    log("grid_oracle", f"the DDA on the card: {o.shape[0]} primary rays {t_dda:.3f} s, "
        f"{int(live.sum())} live shadow rays of {p_off.shape[0]} {t_dda_any:.3f} s; #3 on the "
        f"same rays {kernel_ms(lambda: cuda_mt.intersect_packet_streamed(packet, o, d, t_max=cfg.t_far)):.4f} "
        f"/ {kernel_ms(lambda: cuda_mt.intersect_packet_streamed(packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True, t_init=aseed)):.4f} ms")

    # kernel against plain on the bunny's centre rows (the plain version
    # tests every triangle a ray)
    s0 = (cfg.height // 2 - 32) * cfg.width
    sl = slice(s0, s0 + 32_768)
    results["bunny"] = {}
    for key, ro, rd, kw in (
            ("packet_closest", o[sl], d[sl], dict(t_max=cfg.t_far)),
            ("packet_any_hit", p_off[sl], l_dir[sl],
             dict(t_max=cfg.t_far, any_hit=True, t_init=aseed[sl]))):
        kk = cuda_mt.intersect_packet_streamed(packet, ro, rd, **kw)
        pp = cuda_mt.intersect_packet_streamed_torch(packet, ro, rd, **kw)
        err = hit_parity(f"grid_oracle bunny {key} against the plain version", kk, pp,
                         key == "packet_any_hit")
        results["bunny"][key] = dict(
            max_abs_err=err,
            ms=kernel_ms(lambda: cuda_mt.intersect_packet_streamed(packet, ro, rd, **kw)),
            plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_streamed_torch(packet, ro, rd, **kw)),
            **packet_bound(packet, ro, kw.get("t_init")),
            counters=walk_counts(f"grid_oracle bunny {key}", ro.shape[0],
                                 lambda: cuda_mt.intersect_packet_streamed(packet, ro, rd, **kw)))
    calls = []
    with recorded(cuda_mt, "intersect_packet_streamed", calls):
        shade_inputs(scene, cfg, o, d, "mesh_grid")
    check(len(calls) == 2, f"bunny: {len(calls)} walk calls for its block")
    for key, (a, kw) in zip(("packet_closest", "packet_any_hit"), calls):
        rows = [dict(rays=o.shape[0], **timed_launch(
            lambda: cuda_mt.intersect_packet_streamed(*a, **kw), ("packet_kernel",),
            packet_bound(a[0], a[1], kw.get("t_init"))))]
        results["bunny"][key]["launch"] = launch_entry(rows)
        log_launch("bunny", key, results["bunny"][key]["launch"], rows)
    del calls
    with torch.no_grad():
        R.render_image(scene, cfg.replace(width=64, height=64))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = R.render_image(scene, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts["bunny"] = c = forward_counts()
    log("grid_oracle", f"bunny frame {cfg.width}x{cfg.height}x{cfg.spp}: {dt:.3f} s, launches "
        f"{c} on {smi}")
    check(bool(torch.isfinite(img).all()), "bunny frame not finite")
    check(c["packet_closest"] == c["packet_any_hit"] == c["shade_fwd"] == 1,
          f"bunny frame launches {c}")


def gradcheck(dev):
    """Phase `gradcheck`: `cli gradcheck` with its default device, the card
    (the float64 finite-difference check on the CPU, then each trainable's
    float32 gradient through #1, #5 and #6 against the float64 one), and
    BASELINE config 3's vertex check: the directional derivative of the
    masked loss on `bunny` (20x20, no shadows) along V on lit interior
    triangles, finite differences against autograd in float64 on the CPU,
    then the card's float32 derivative through #3, #5 and #6 against it."""
    from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_sdf, cuda_shade
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.utils import gradcheck as gc

    code = 0
    try:
        out = cli_run(["gradcheck", "--scene", "sphere"], "gradcheck")
    except SystemExit as e:
        code, out = e.code, ""
    check(code in (0, None), f"cli gradcheck exited {code}")
    for path in ("sdf.sph_radius", "camera.origin", "materials.albedo"):
        check(f"[gradcheck] {path}: OK" in out and f"[gradcheck] card {path}: OK" in out,
              f"cli gradcheck {path}")
    launched = json.loads(out.split("[gradcheck] card launches: ")[1].splitlines()[0])
    check(all(launched.get(k, 0) > 0 for k in ("march", "shade_fwd", "shade_bwd")),
          f"cli gradcheck card launches {launched}")

    scene, cfg = build_scene("bunny", device="cpu", dtype=torch.float64)
    cfg = cfg.replace(width=20, height=20, shadow="none", block_size=0, method="mesh_grid")
    V = gc.vertex_direction(scene, cfg, interior_only=True)
    t0 = time.perf_counter()
    g_ad, g_fd = gc.check_grad(gc.vertex_loss(scene, cfg, V), torch.zeros(()), eps=2e-6,
                               rtol=5e-3, atol=1e-9)
    log("gradcheck", f"config 3 vertex check, float64 on the CPU: <grad, V> autograd "
        f"{float(g_ad):.9e}, finite differences {float(g_fd):.9e} "
        f"({time.perf_counter() - t0:.2f} s)")
    reset_launches()
    r = gc.card_vertex_check(scene, cfg, V, dev)
    launched = {k: v for t in (cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES,
                               cuda_reconstruct.LAUNCHES) for k, v in t.items() if v}
    log("gradcheck", f"config 3 on the card: float32 {r['d32']:.9e} against float64 "
        f"{r['d64']:.9e}, rel {r['rel_err']:.3e} (at most 1e-3); launches {launched}")
    check(abs(float(g_ad)) > 1e-4 and r["ok"], "config 3 vertex check on the card")
    check(launched.get("closest", 0) > 0 and launched.get("shade_bwd", 0) > 0,
          f"config 3 card launches {launched}")


def inverse_lighting(dev, smi):
    """Phase `inverse_lighting`: tpu_ray_torch.examples.inverse_lighting at
    its defaults (`pointlight` 256x256, diff_vis, 150 Adam steps on the
    light's position and intensity): the loss falls at least 10x; the
    position error is printed, with the launches of #1, #2 soft, #5 and #6."""
    from tpu_ray_torch.examples import inverse_lighting as il
    from tpu_ray_torch.tools import launch_counts

    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        true, fitted, hist = il.main(os.path.join(REPO, "build", "chip_smoke_light"), device=dev)
    dt = time.perf_counter() - t0
    for ln in buf.getvalue().splitlines():
        log("inverse_lighting", f"  {ln}")
    c = launch_counts()
    err = float((true.lights.position - fitted.lights.position).norm())
    log("inverse_lighting", f"{len(hist)} steps in {dt:.2f} s ({dt / len(hist):.3f} s a step "
        f"with the PNGs' frames), loss {hist[0]:.4e} -> {hist[-1]:.4e} "
        f"({hist[0] / hist[-1]:.1f}x), position error {err:.4f}; launches {c} on {smi}")
    check(hist[0] >= 10.0 * hist[-1], "inverse_lighting: the loss fell less than 10x")
    check(all(c[k] > 0 for k in ("march", "shadow_soft", "shade_fwd", "shade_bwd")),
          f"inverse_lighting launches {c}")


# what each stage of tools/profile_stages launches on `mixed`: the march
# once per group of render.MARCH_GROUP blocks, the others once per block
STAGE_KERNELS = {"march": ("march",),
                 "march+mesh": ("march", "packet_closest"),
                 "+reconstruct": ("march", "packet_closest", "reconstruct"),
                 "geometry(all)": ("march", "packet_closest", "reconstruct", "shadow_hard",
                                   "packet_any_hit"),
                 "full fwd": ("march", "packet_closest", "reconstruct", "shadow_hard",
                              "packet_any_hit", "corner_gather", "shade_fwd"),
                 "fwd+bwd": ("march", "packet_closest", "reconstruct", "shadow_hard",
                             "packet_any_hit", "corner_gather", "shade_fwd", "shade_bwd",
                             "corner_scatter")}


def finite_numbers(obj, where: str) -> None:
    """Every number in a tool's report (nested dicts and lists) finite."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            finite_numbers(v, f"{where}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            finite_numbers(v, f"{where}[{i}]")
    elif isinstance(obj, float):
        check(obj == obj and abs(obj) < float("inf"), f"{where} = {obj}")


def check_window(w: dict, where: str) -> None:
    check(w["device_ms"] <= w["wall_ms"] and 0 < w["busy"] <= 1,
          f"{where}: device {w['device_ms']} ms, wall {w['wall_ms']} ms, busy {w['busy']}")


def tools_phase(dev, smi):
    """Phase `tools`: tpu_ray_torch/tools on the card at a reduced size:
    bench_all's `sphere` row; profile_stages, profile_bwd and
    profile_trace_ops (bwd) on `mixed` at 256x128x16, 16 blocks in one
    march group, each timed once, with each tool's seconds. Each stage's
    and subset's launches equal what the frame and the step launch
    (check_counts' rule: the march once a group, the rest once a block),
    every profiled window's device time is at most its wall time with
    0 < busy <= 1, and every number is finite."""
    from tpu_ray_torch.render.render import MARCH_GROUP
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.tools import bench_all, profile_bwd, profile_stages, profile_trace_ops

    say = lambda msg: log("tools", msg)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rows = bench_all.main(os.path.join(REPO, "build", "chip_smoke_bench_all.json"), dev,
                              rows=(("sphere", {}),))["rows"]
    for ln in buf.getvalue().splitlines()[:-1]:
        say(f"  {ln}")
    check(len(rows) == 1 and rows[0]["device"] == torch.cuda.get_device_name(dev)
          and rows[0]["power_limit"] == smi.rsplit(",", 1)[1].strip(), f"bench_all row {rows}")
    finite_numbers(rows, "bench_all")
    check(all(rows[0][k] > 0 for k in ("value", "mrays_fwdbwd")), f"bench_all row {rows}")
    say(f"bench_all sphere: {time.perf_counter() - t0:.2f} s")

    scene, cfg = build_scene("mixed", device=dev)
    cut = cfg.replace(width=256, height=128)
    n_blocks = -(-cut.num_rays // cut.block_size)
    n_groups = -(-n_blocks // MARCH_GROUP)
    want = lambda names: {k: n_groups if k == "march" else n_blocks for k in names}

    t0 = time.perf_counter()
    rep = profile_stages.profile(scene, cut, dev, iters=1, log=say)
    finite_numbers(rep, "profile_stages")
    check([r["stage"] for r in rep["stages"]] == list(STAGE_KERNELS), "profile_stages' stages")
    for r in rep["stages"]:
        check(r["launches"] == want(STAGE_KERNELS[r["stage"]]),
              f"profile_stages {r['stage']}: launches {r['launches']}")
        check_window(r["window"], f"profile_stages {r['stage']}")
        check(r["window"]["blocks"] == n_blocks, f"profile_stages window {r['window']}")
    for stage, name in (("full fwd", "frame"), ("fwd+bwd", "step")):
        r = next(r for r in rep["stages"] if r["stage"] == stage)
        check_counts(f"profile_stages {name}", cut, r["launches"], STAGE_KERNELS[stage])
    say(f"profile_stages: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    rep = profile_bwd.profile(scene, cut, dev, iters=1, log=say)
    finite_numbers(rep, "profile_bwd")
    check(list(rep["subsets"]) == list(profile_bwd.SUBSETS), f"subsets {list(rep['subsets'])}")
    check(rep["fwd_launches"] == want(STAGE_KERNELS["full fwd"]),
          f"profile_bwd forward launches {rep['fwd_launches']}")
    for tag, r in rep["subsets"].items():
        # the corner scatter runs where the subset trains the vertices
        kernels = tuple(k for k in STAGE_KERNELS["fwd+bwd"] if k != "corner_scatter"
                        or "mesh.verts" in profile_bwd.SUBSETS[tag])
        check(r["launches"] == want(kernels) and r["grads_finite"],
              f"profile_bwd {tag}: launches {r['launches']}, finite {r['grads_finite']}")
    check("verts_over_albedo" in rep, "profile_bwd: no verts-only - albedo-only increment")
    pieces = rep["pieces"]
    check(pieces["shade fwd+bwd"]["launches"] == {"corner_gather": 1, "shade_fwd": 1,
                                                  "shade_bwd": 1, "corner_scatter": 1}
          and pieces["shade fwd"]["launches"] == {"corner_gather": 1, "shade_fwd": 1},
          f"profile_bwd pieces' launches {pieces}")
    say(f"profile_bwd: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rep = profile_trace_ops.capture(scene, cut, "bwd", dev, os.path.join(
            REPO, "build", "chip_smoke_trace_ops_bwd"), top_n=8)
        profile_trace_ops.print_report(rep)
    for ln in buf.getvalue().splitlines():
        if ln.strip():
            say(f"  {ln}")
    finite_numbers(rep, "profile_trace_ops")
    check(rep["window_blocks"] == rep["frame_blocks"] == n_blocks,
          f"profile_trace_ops window {rep['window_blocks']} blocks")
    check(0 < rep["busy"] <= 1 and rep["device_ms"] <= rep["wall_s"] * 1e3,
          f"profile_trace_ops: device {rep['device_ms']} ms, wall {rep['wall_s']} s")
    hand = {"#1 march", "#2 shadow", "#3 packet", "#5 shade_fwd", "#6 shade_bwd"}
    check(hand <= set(rep["by_category"]),
          f"profile_trace_ops: categories {list(rep['by_category'])}")
    say(f"profile_trace_ops bwd: {time.perf_counter() - t0:.2f} s")


def gather_row(tag: str, rows, idx) -> dict:
    """The corner gather on the triangle ids idx into the (T, 10) rows:
    bit-equal to the indexing; its device ms inside a CUDA graph, the plain
    version's host ms and the bound (each ray's id read and corners
    written, each distinct triangle's row read)."""
    from tpu_ray_torch.kernels import cuda_scatter
    from tpu_ray_torch.tools.profile_scatter import device_ms

    check(torch.equal(cuda_scatter.corner_gather(rows, idx), rows[idx.long()][:, :9]),
          f"gather [{tag}] against the indexing")
    return dict(ms=device_ms(lambda: cuda_scatter.corner_gather(rows, idx), idx.device),
                plain_ms=wall_ms(lambda: cuda_scatter.corner_gather_torch(rows, idx)),
                max_abs_err=0.0,
                **bound(idx.numel() * (4 + 36) + int(torch.unique(idx).numel()) * 40, 0))


def scatter_row(tag: str, smi: str, ct, idx, n_t: int) -> dict:
    """The corner scatter of the (R, 9) cotangent ct by the triangle ids
    idx against float64 and its plain version (each entry within 1e-5 of
    its terms' absolute sum), column 9 zero, two runs bit-identical; its
    device ms inside a CUDA graph, torch's index backward's (the plain
    version: `library_ms`) and its host ms, the bound and the counters a
    call adds."""
    from tpu_ray_torch.kernels import cuda_scatter
    from tpu_ray_torch.tools.profile_scatter import device_ms

    before = dict(cuda_scatter.scatter_counters())
    got = cuda_scatter.corner_scatter(ct, idx, n_t)
    after = dict(cuda_scatter.scatter_counters())
    again = cuda_scatter.corner_scatter(ct, idx, n_t)
    plain = cuda_scatter.corner_scatter_torch(ct, idx, n_t)
    want = torch.zeros((n_t, 9), dtype=torch.float64, device=ct.device).index_add_(
        0, idx.long(), ct.double())
    abs_sum = torch.zeros((n_t, 9), dtype=torch.float64, device=ct.device).index_add_(
        0, idx.long(), ct.double().abs())
    worst = {}
    for what, ref in (("float64", want), ("plain", plain[:, :9].double())):
        err = (got[:, :9].double() - ref).abs()
        worst[what] = float((err / abs_sum.clamp_min(1e-300)).max())
        check(bool((err <= 1e-5 * abs_sum).all()),
              f"scatter [{tag}] against {what}: worst {worst[what]:.3e} of the terms' "
              "absolute sum (rule 1e-5)")
    check(not got[:, 9].any(), f"scatter [{tag}]: column 9 not zero")
    check(torch.equal(got, again), f"scatter [{tag}]: two runs differ")
    row = dict(ms=device_ms(lambda: cuda_scatter.corner_scatter(ct, idx, n_t), ct.device),
               library_ms=device_ms(lambda: cuda_scatter.corner_scatter_torch(ct, idx, n_t),
                                    ct.device),
               plain_ms=wall_ms(lambda: cuda_scatter.corner_scatter_torch(ct, idx, n_t)),
               max_abs_err=float((got - plain).abs().max()),
               counters={k: after[k] - before.get(k, 0) for k in after if k != "longest_rows"},
               **bound(idx.numel() * (4 + 36) + n_t * 40, 0))
    log("scatter", f"[{tag}] R {idx.numel()}, T {n_t}: scatter {row['ms']:.5f} ms a call in "
        f"a graph (bound {row['bound_ms']:.5f}, {row['bound_ms'] / row['ms']:.1%}; torch's "
        f"index backward {row['library_ms']:.5f} ms, {row['library_ms'] / row['ms']:.1f}x; "
        f"plain {row['plain_ms']:.3f} ms host); worst {worst['float64']:.2e} of the absolute "
        f"sum against float64, {worst['plain']:.2e} against the plain version; bit-identical "
        f"twice; counters {row['counters']}, the process's longest segment "
        f"{after['longest_rows']} on {smi}")
    return row


def scatter_phase(dev, smi, results):
    """Phase 30: the corner gather and scatter against their plain versions
    and torch's index backward, then `mixed`'s graphed fit step (see the
    module docstring)."""
    import numpy as np

    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.kernels import cuda_scatter
    from tpu_ray_torch.render.render import render_image_jit
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.tools import launch_counts, profile_scatter

    T, R = profile_scatter.T, profile_scatter.R_BLOCK
    rng = np.random.default_rng(0)  # profile_scatter's sets, in its order
    local = torch.as_tensor(rng.integers(0, 2000, R) + 30_000, device=dev)
    uniform = torch.as_tensor(rng.integers(0, T, R), device=dev)
    d = torch.as_tensor(rng.standard_normal((R, 9), np.float32), device=dev)
    sets = [("local", local, T, None), ("uniform", uniform, T, None)]
    for path, changes in (("mixed", {}), ("mixed_sil", SILHOUETTES)):
        tri, hit_share, b, _, n_tris = profile_scatter.real_block(dev, **changes)
        sets.append((f"{path} block {b}, hit share {hit_share:.4f}", tri, n_tris, path))
    for tag, idx, n_t, path in sets:
        idx = idx.to(torch.int32)
        row = scatter_row(tag, smi, d[:idx.shape[0]].contiguous(), idx, n_t)
        g_row = gather_row(tag, torch.randn((n_t, 10), device=dev), idx)
        log("scatter", f"[{tag}] gather {g_row['ms']:.5f} ms a call in a graph (bound "
            f"{g_row['bound_ms']:.5f}; plain {g_row['plain_ms']:.3f} ms host), bit-equal to "
            "the indexing")
        if path is not None:
            results[path]["corner_scatter"], results[path]["corner_gather"] = row, g_row
    scene, cfg = build_scene("mixed", device=dev)
    blocks = -(-cfg.num_rays // cfg.block_size)

    def step():
        params = extract_params(scene, TRAINABLES)
        torch.mean(render_image_jit(apply_params(scene, params), cfg) ** 2).backward()
        torch.cuda.synchronize()
        return params["mesh.verts"].grad

    step()  # captures the vjp graph, unless phase 6b did
    reset_launches()
    before = dict(cuda_scatter.scatter_counters())
    t0 = time.perf_counter()
    first = step()
    dt = time.perf_counter() - t0
    counts, after = launch_counts(), dict(cuda_scatter.scatter_counters())
    second = step()
    delta = {k: after[k] - before[k] for k in after if k != "longest_rows"}
    log("scatter", f"mixed {cfg.width}x{cfg.height}x{cfg.spp} graphed fit step: {dt:.3f} s, "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s; corner_gather {counts['corner_gather']}, "
        f"corner_scatter {counts['corner_scatter']} launches for {blocks} blocks; the "
        f"scatter's counters over the step {delta} "
        f"({delta['rows'] / max(delta['segments'], 1):.1f} rays a triangle); mesh.verts "
        f"gradient bit-identical over two steps: "
        f"{torch.equal(first, second)} (norm {float(first.norm()):.6e})")
    check(counts["corner_scatter"] == blocks and counts["corner_gather"] == 2 * blocks,
          f"graphed step: {counts['corner_scatter']} scatters and {counts['corner_gather']} "
          f"gathers for {blocks} blocks")
    check(torch.equal(first, second), "two identical graphed steps' mesh.verts gradients differ")
    return counts


def cli_run(argv, tag="bench_cli") -> str:
    """The port's CLI in this process -> what it printed (logged too)."""
    from tpu_ray_torch import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        for ln in buf.getvalue().splitlines():
            log(tag, f"  {ln}")
    return buf.getvalue()


def bench_cli(dev, smi):
    """Phase 24: the port's bench, jittered sampling, a fit's resume and the
    CLI's new commands, on the card (bench_cli)."""
    import shutil

    from tpu_ray_torch.bench import run_bench
    from tpu_ray_torch.cli import demo_target
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.render import graphs
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.scene.types import get_param
    from tpu_ray_torch.tools import launch_counts
    from tpu_ray_torch.utils import checkpoint as ckpt_lib
    from tpu_ray_torch.utils.config import FitConfig

    # A: `python -m tpu_ray_torch.bench mandelbulb` at its defaults, through
    # render_image_jit: a new plan, whose graphs' warm-ups launch once each
    bulb, bcfg = build_scene("mandelbulb", device=dev)
    graphs.PLANS.clear()
    reset_launches()
    t0 = time.perf_counter()
    line = run_bench("mandelbulb")
    counts = launch_counts()
    log("bench_cli", f"run_bench('mandelbulb') in {time.perf_counter() - t0:.2f} s on {smi}:")
    print(json.dumps(line), flush=True)
    for k in ("value", "fwd_seconds", "fwdbwd_seconds", "mrays_fwdbwd"):
        check(line[k] == line[k] and 0 < line[k] < float("inf"), f"bench {k} = {line[k]}")
    check(not line["persistent_loop"], "the mandelbulb bench took the turntable loop")
    # warmup 1 + iters 2 forward frames, warmup 1 + max(iters - 1, 1) steps,
    # whose backward runs #5 again; one warm-up of the group graph (#1), the
    # block graph (#2, #5) and the vjp graph (#5, #6)
    n_fwd, n_bwd = 3, 2
    n_blocks = -(-bcfg.num_rays // bcfg.block_size)
    want = {"march": (n_fwd + n_bwd) * -(-n_blocks // R.MARCH_GROUP) + 1,
            "shadow_soft": (n_fwd + n_bwd) * n_blocks + 1,
            "shade_fwd": (n_fwd + 2 * n_bwd) * n_blocks + 2,
            "shade_bwd": n_bwd * n_blocks + 1}
    log("bench_cli", f"bench launches {counts}; expected {want} ({n_fwd} frames and {n_bwd} "
        f"steps of {n_blocks} blocks, the march a group of {R.MARCH_GROUP}, and the "
        f"graphs' warm-ups)")
    check(all(counts[k] == v for k, v in want.items()), "bench launch counts")

    # B: jittered sampling: the card's draw is the CPU's; the frame through
    # the kernels against the plain path (phase 9's bound)
    jit_full = bcfg.replace(jitter_seed=3)
    sx, sy = R.pixel_sample_coords(jit_full, dev)
    hx, hy = R.pixel_sample_coords(jit_full, "cpu")
    same = torch.equal(sx.cpu(), hx) and torch.equal(sy.cpu(), hy)
    log("bench_cli", f"jitter seed 3 at {jit_full.width}x{jit_full.height}x{jit_full.spp} "
        f"({2 * jit_full.num_rays} values, {-(-2 * jit_full.num_rays // R.JITTER_CHUNK)} "
        f"chunks): card and CPU bit-identical {same}")
    check(same, "the jitter offsets on the card differ from the CPU's")
    jit = jit_full.replace(width=256, height=256)
    with torch.no_grad():
        img_k = R.render_image(bulb, jit)
        img_0 = R.render_image(bulb, jit.replace(jitter_seed=None))
        with plain_paths():
            img_p = R.render_image(bulb, jit)
    err = (img_k - img_p).abs().amax(-1)
    p95 = float(torch.quantile(err.flatten(), 0.95))
    moved = float((img_k - img_0).abs().max())
    log("bench_cli", f"mandelbulb {jit.width}x{jit.height}x{jit.spp} jitter_seed=3: kernel vs "
        f"plain path p95 {p95:.3e}, max {float(err.max()):.3e}, pixels over 1e-3: "
        f"{int((err > 1e-3).sum())} of {err.numel()}; max change against the stratified "
        f"frame {moved:.3e}")
    check(bool(torch.isfinite(img_k).all()) and p95 < 1e-3 and moved > 0,
          "jittered frame parity")

    # C: a fit's resume on the card: 4 steps straight against 2 and a
    # resume to 4, the fitted parameters bit for bit
    rcfg = bcfg.replace(width=128, height=128)
    trainable = ("sdf.mb_scale", "camera.origin", "materials.albedo", "lights.color")
    target = demo_target(bulb, rcfg, trainable)
    ck = os.path.join(REPO, "build", "chip_smoke_resume")
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(learning_rate=1e-2, checkpoint_every=2)
    full, h_full = fit(bulb, rcfg, target, trainable, FitConfig(steps=4, **kw), verbose=False)
    _, h_a = fit(bulb, rcfg, target, trainable, FitConfig(steps=2, checkpoint_dir=ck, **kw),
                 verbose=False)
    resumed, h_b = fit(bulb, rcfg, target, trainable,
                       FitConfig(steps=4, checkpoint_dir=ck, **kw), verbose=False)
    same = {p: torch.equal(get_param(full, p), get_param(resumed, p)) for p in trainable}
    log("bench_cli", f"mandelbulb 128x128x4 fit, {list(trainable)}: 4 steps {h_full}; 2 steps "
        f"{h_a}, resumed {h_b} (checkpoints {ckpt_lib.make_manager(ck).steps()}); "
        f"parameters bit-identical {same}")
    check(all(same.values()) and h_a + h_b == h_full, "the resumed fit differs")

    # D: the CLI's new commands
    out = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    scene, cfg = build_scene("mixed", device=dev)
    small = cfg.replace(width=512, height=512, spp=1)
    graphs.PLANS.clear()
    reset_launches()
    text = cli_run(["render", "--scene", "mixed", "--width", "512", "--height", "512",
                    "--spp", "1", "--stats", "--out", os.path.join(out, "stats.png")])
    stats = json.loads(text.split("[render] stats: ", 1)[1].splitlines()[0])
    counts = forward_counts()
    n_blocks = -(-small.num_rays // small.block_size)
    want = {"march": -(-n_blocks // R.MARCH_GROUP) + 2, "packet_closest": n_blocks + 2}
    log("bench_cli", f"render --stats: launches {counts}, expected {want} (the graphed "
        f"frame's and its warm-up's, then the stats' {stats['rays_sampled']} rays in one "
        f"launch each)")
    check(stats["rays_sampled"] == 1 << 18 and 0 < stats["hit_rate"] < 1
          and stats["march_steps_max"] > 0 and stats["mean_hit_t"] > 0, f"stats {stats}")
    check(all(counts[k] == v for k, v in want.items()), "render --stats launch counts")
    cli_run(["render", "--scene", "mixed", "--width", "320", "--height", "180",
             "--progressive", "2", "--out", os.path.join(out, "prog.png")])
    check(all(os.path.getsize(os.path.join(out, f)) > 0
              for f in ("prog_prog0.png", "prog_prog1.png", "prog.png")),
          "render --progressive wrote no files")
    ck = os.path.join(out, "ck")
    text = cli_run(["fit", "--scene", "mixed", "--width", "512", "--height", "512", "--spp",
                    "1", "--steps", "2", "--target", os.path.join(out, "stats.png"),
                    "--checkpoint-dir", ck])
    check("[fit] final loss" in text and ckpt_lib.make_manager(ck).steps() == [2],
          "fit --target --checkpoint-dir")


def ptxas_summary(log_text: str) -> str:
    """Registers, stack and spills of every build of the marches and the
    shade kernels, from ptxas' -v output."""
    import re

    names = ("march_kernel", "shadow_kernel", "shade_fwd_kernel", "shade_bwd_kernel",
             "sum_partials_kernel")
    out, cur, props = [], None, {}
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            cur = next((n for n in names if n in mangled), None)
            flags = re.match(r"I((?:Lb[01]E)+)E", mangled[mangled.find(cur) + len(cur):]
                             if cur else "")
            if cur and flags:  # the template's bools: <kPow8> or <kPow8, kSoft>
                cur += "<" + ", ".join("true" if b == "1" else "false"
                                       for b in re.findall(r"Lb([01])E", flags.group(1))) + ">"
            props = {}
        elif cur and "bytes stack frame" in ln and "stack" not in props:  # the entry's own
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            props.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            props["registers"] = int(words[words.index("Used") + 1])
            smem = [words[k - 2] for k, w in enumerate(words) if w == "smem"]
            out.append(f"{cur} {props.get('registers')} registers, {props.get('stack', 0)} B "
                       f"stack, {props.get('spill_stores', 0)} B spill stores, "
                       f"{props.get('spill_loads', 0)} B spill loads"
                       + (f", {smem[0]} B static smem" if smem else ""))
            cur = None
    return "; ".join(out)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="",
                        help="comma-separated phases to run alone (after device and "
                             "build), e.g. `launch`; then the per-launch table is the "
                             "last line and no result line is printed")
    only = set(filter(None, parser.parse_args().only.split(",")))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "script runs only on a CUDA device")
    sys.path.insert(0, REPO)
    from tpu_ray_torch import native
    from tpu_ray_torch.kernels import build
    from tpu_ray_torch.scene.scenes import build_scene

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build.kernel_lib()
    regs = [ln.strip() for ln in build.BUILD_LOG["ptxas"].splitlines()
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    log("build", f"{time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_LOG['seconds']:.2f} s, "
        f"built={build.BUILD_LOG['built']}) -> {build.BUILD_LOG['path']}")
    for ln in regs:
        log("build", ln)
    log("build", f"ptxas of #1, #2, #5, #6: {ptxas_summary(build.BUILD_LOG['ptxas'])}")
    t0 = time.perf_counter()
    native.accel_lib()
    log("build", f"native accel builder: {time.perf_counter() - t0:.2f} s (g++ "
        f"{native.BUILD_LOG['seconds']:.2f} s, built={native.BUILD_LOG['built']}) -> "
        f"{native.BUILD_LOG['path']}")

    dev = torch.device("cuda", 0)
    scene, cfg = build_scene("mixed", device=dev)
    bulb, bcfg = build_scene("mandelbulb", device=dev)
    bcfg = bcfg.replace(block_size=min(bcfg.block_size, 1 << 16))  # bench_lib.py:121-122
    results = {"mixed": {}, "mandelbulb": {}}
    warm = cfg.replace(width=320, height=180)
    bsmall = bcfg.replace(width=256, height=256, spp=1)
    sil = cfg.replace(**SILHOUETTES)
    sil_cut = sil.replace(width=960, height=540)  # phases 14, 15
    ring_cut = cfg.replace(width=960, height=540)  # phases 19, 20
    results.update(mixed_sil={}, mixed_ring={}, knot1m={}, knot1m_parts={},
                   mandelbulb_power={})
    parity_rays, kept, knot_counts = [], {}, {}
    # phases 5, 6, 10 and 11, for 5b, 6b, 10b and 11b; 5b and 6b for 5c and
    # 6c; 19 and 20 for 19b and 20b
    eager_frame, eager_step, eager_bulb, eager_bulb_step = {}, {}, {}, {}
    graphed_frame, graphed_step, eager_ring, eager_ring_fit = {}, {}, {}, {}
    phases = (
        ("parity", lambda: parity_rays.extend(parity(scene, cfg, results["mixed"], kept))),
        ("content", lambda: content_classes(scene, cfg, *parity_rays)),
        ("small", lambda: small_frame(scene, cfg.replace(width=320, height=180, spp=1),
                                      "mixed", TRAINABLES)),
        ("frame", lambda: full_frame(scene, cfg, smi, "mixed", warm, keep=eager_frame)),
        ("graph_frame", lambda: graph_frame(scene, cfg, smi, "mixed", eager_frame,
                                            keep=graphed_frame)),
        ("sharded_graph_frame", lambda: sharded_graph_frame(scene, cfg, smi, dev, graphed_frame,
                                                            eager_frame["counts"])),
        ("fit_step", lambda: fit_step(scene, cfg, smi, "mixed", TRAINABLES, warm,
                                      cfg.replace(width=256, height=128), keep=eager_step)),
        ("graph_step", lambda: graph_step(scene, cfg, smi, "mixed", TRAINABLES, eager_step,
                                          eager_frame["counts"], keep=graphed_step)),
        ("sharded_graph_step", lambda: graphed_sharded_step(
            scene, cfg, smi, dev, graphed_step, out["graph_step"], "sharded_graph_step")),
        ("fit", lambda: fit_run(scene, cfg)),
        ("bulb_parity", lambda: bulb_parity(bulb, bcfg, results["mandelbulb"])),
        ("bulb_small", lambda: bulb_small(bulb, bsmall)),
        ("bulb_frame", lambda: full_frame(bulb, bcfg, smi, "mandelbulb", bsmall,
                                          "bulb_frame", keep=eager_bulb)),
        ("bulb_graph_frame", lambda: graph_frame(bulb, bcfg, smi, "mandelbulb", eager_bulb,
                                                 "bulb_graph_frame")),
        ("bulb_fit_step", lambda: fit_step(
            bulb, bcfg.replace(diff_vis=True), smi, "mandelbulb", BULB_TRAINABLES,
            bsmall.replace(diff_vis=True), bcfg.replace(width=256, height=256, diff_vis=True),
            "bulb_fit_step", keep=eager_bulb_step)),
        ("bulb_graph_step", lambda: graph_step(
            bulb, bcfg.replace(diff_vis=True), smi, "mandelbulb", BULB_TRAINABLES,
            eager_bulb_step, eager_bulb["counts"], "bulb_graph_step")),
        ("sil_parity", lambda: sil_parity(scene, sil, results["mixed_sil"])),
        ("sil_small", lambda: small_frame(scene, sil.replace(width=320, height=180, spp=1),
                                          "mixed_sil", TRAINABLES, "sil_small")),
        ("sil_frame", lambda: full_frame(scene, sil_cut, smi, "mixed_sil",
                                         sil.replace(width=320, height=180), "sil_frame")),
        ("sil_fit_step", lambda: fit_step(scene, sil_cut, smi, "mixed_sil", TRAINABLES,
                                          sil.replace(width=320, height=180),
                                          sil.replace(width=256, height=128), "sil_fit_step")),
        ("sil_fits", lambda: sil_fits(dev)),
        ("resident_parity", lambda: resident_parity(scene, cfg, results["mixed_ring"], kept)),
        ("knot1m_parts", lambda: knot_parts(dev, smi, results, knot_counts)),
        ("ring_frame", lambda: ring_frame(scene, ring_cut, smi, warm, dev, eager_ring)),
        ("ring_graph_frame", lambda: ring_graph_frame(scene, ring_cut, smi, dev, eager_ring)),
        ("ring_fit_step", lambda: ring_fit_step(scene, ring_cut, smi, warm, dev,
                                                eager_ring_fit)),
        ("ring_graph_step", lambda: graphed_sharded_step(
            scene, ring_cut, smi, dev, eager_ring_fit,
            step_launches(out["ring_graph_frame"]),
            "ring_graph_step", scene_shards=True)),
        ("power_parity", lambda: power_parity(bulb, bcfg, results["mandelbulb_power"])),
        ("power_frame", lambda: power_frame(bulb, bcfg, smi, bsmall,
                                            bcfg.replace(width=256, height=256))),
        ("launch", lambda: launch_sizes(launch_paths, results)),
        ("bench_cli", lambda: bench_cli(dev, smi)),
        ("knot8m", lambda: knot8m(dev, smi, results, knot_counts)),
        ("grid_oracle", lambda: grid_oracle(dev, smi, results, knot_counts)),
        ("gradcheck", lambda: gradcheck(dev)),
        ("inverse_lighting", lambda: inverse_lighting(dev, smi)),
        ("tools", lambda: tools_phase(dev, smi)),
        ("scatter", lambda: scatter_phase(dev, smi, results)),
    )
    # the kernels at their launch size: the frame's config, the fit step's
    launch_paths = {
        "mixed": (scene, cfg, cfg, PARITY_POINTS, "mixed"),
        "mixed_sil": (scene, sil, sil, SIL_POINTS, "mixed"),
        "mandelbulb": (bulb, bcfg, bcfg.replace(diff_vis=True), BULB_POINTS, "sdf"),
        "mandelbulb_power": (generic_field(bulb), bcfg, bcfg.replace(diff_vis=True),
                             BULB_POINTS, "sdf")}
    unknown = only - {name for name, _ in phases}
    check(not unknown, f"--only: no such phase {sorted(unknown)}")
    out = {}
    t_start = time.perf_counter()
    for phase, run in phases:
        if only and phase not in only:
            continue
        t0 = time.perf_counter()
        out[phase] = run()
        log(phase, f"phase seconds {time.perf_counter() - t0:.2f}")
    log("done", f"all phases {time.perf_counter() - t_start:.2f} s")
    launch_table = {path: {key: {k: r[k] for k in ("launch", "launch_block", "sweep") if k in r}
                           for key, r in table.items() if "launch" in r}
                    for path, table in results.items()}
    if only:
        print(smi)
        print(json.dumps({"launch": launch_table}))
        return 0
    # `mixed`, `mandelbulb`: the graphed frames and steps, as the bench, the CLI
    # and fit run them
    counts = {"mixed": dict(out["graph_frame"], shade_bwd=out["graph_step"]["shade_bwd"],
                            corner_scatter=out["graph_step"]["corner_scatter"]),
              "mandelbulb": dict(out["bulb_graph_frame"],
                                 shade_bwd=out["bulb_graph_step"]["shade_bwd"]),
              "mixed_sil": dict(out["sil_frame"], shade_bwd=out["sil_fit_step"]["shade_bwd"],
                                corner_scatter=out["sil_fit_step"]["corner_scatter"]),
              "mixed_ring": dict(out["ring_graph_frame"],
                                 shade_bwd=out["ring_graph_step"]["shade_bwd"],
                                 corner_scatter=out["ring_graph_step"]["corner_scatter"]),
              "mandelbulb_power": out["power_frame"],
              **knot_counts}
    for key in RING_SHARED:
        results["mixed_ring"][key] = results["mixed"][key]

    kernels = []
    for path, names in PATH_KERNELS.items():
        for key in names:
            r = results[path][key]
            entry = {"name": key, "path": path, "route": "cuda",
                     "source": f"{SRC}/{SOURCES[key]}", "replaces": REPLACES[key],
                     "launches": counts[path][key], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
            if "counters" in r:
                entry["counters"] = r["counters"]
            if "launch" in r:  # one launch of the path's size (phase `launch`)
                entry.update({f"launch_{k}": v for k, v in r["launch"].items()})
            if "launch_block" in r:  # the march: one block a launch, and the group sweep
                entry.update(launch_block_ms=r["launch_block"]["ms"], sweep=r["sweep"])
            kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
