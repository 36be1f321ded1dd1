"""Timing, ray counts and the program's own tracing (counterpart of
`tpu_ray/utils/metrics.py`): wall-clock timing around synchronized device
work, the Mrays/s ray count, a torch.profiler trace (`profile_trace`)
written as a Chrome trace, and what the program records into such a trace:

  span(name)           a host range (torch.profiler's record_function), opened
                       only while a profiler records: with none, one check of
                       a flag and no dispatcher call. It lands on the thread
                       that runs it, autograd's worker thread included.
  stage(name, device)  on a CUDA device, the stage's empty marker kernel
                       (csrc/trace_stage.cu) launched on the current stream,
                       then the span `stage.<name>`. Launched while a CUDA
                       graph captures, the marker replays with the graph, so
                       the device trace names the stage of every kernel and
                       copy after it, up to the next marker.

STAGES partition each of a frame plan's graphs (render/graphs.py), and
mark the eager path the same way: `march` (the group's primary march, or
a block's own), `rays` (the block's rays), `walk` (the mesh closest hit),
`reconstruct` (the values-only `cuda_reconstruct.reconstruct`), `shadow`
(hard or soft marches, the mesh any-hits, the AO taps' mesh term), `shade` (the corner
gather, #5, the pixel mean); in the vjp graph `vjp.forward` (the rays, the
corners and the shade again), `vjp.backward` (the autograd pass: #6, the
corner scatter, the camera's chain) and `vjp.accumulate` (the gradients
added into the plan's buffers). RENDER_SPANS, FIT_SPANS and ACCEL_SPANS are
the host spans of render/, fit.py and accel/packet.py."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

STAGES = ("march", "rays", "walk", "reconstruct", "shadow", "shade",
          "vjp.forward", "vjp.backward", "vjp.accumulate")
# each stage's marker kernel is MARKER_PREFIX + its name, a dot made "_"
MARKER_PREFIX = "trace_stage_"
RENDER_SPANS = ("render.frame", "render.prepare", "render.load", "render.group",
                "render.block", "render.backward", "render.vjp", "render.to_image")
FIT_SPANS = ("fit.params", "fit.forward", "fit.backward", "fit.optimizer")
ACCEL_SPANS = ("accel.build",)
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}
_STAGE_SPAN = {s: f"stage.{s}" for s in STAGES}
_OFF = contextlib.nullcontext()


def marker_kernel(stage_name: str) -> str:
    """The name of a stage's marker kernel, as the device trace shows it."""
    return MARKER_PREFIX + stage_name.replace(".", "_")


def span(name: str):
    """A context manager: torch.profiler's record_function(name) while a
    profiler records, else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)


def stage(name: str, device: torch.device):
    """Begin stage `name` (one of STAGES) -> its span (a context manager).
    On a CUDA device the stage's marker kernel is launched first, on the
    current stream, captured where a graph captures."""
    which = _STAGE_INDEX[name]
    if device.type == "cuda":
        from tpu_ray_torch.kernels.build import check_launch, kernel_lib

        check_launch("trace_stage", kernel_lib().tr_trace_stage(
            which, torch.cuda.current_stream(device).cuda_stream))
    return span(_STAGE_SPAN[name])


class Timer:
    """Wall-clock timer; call .start(), .stop() or use as a context manager."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def rays_per_frame(cfg, scene=None) -> int:
    """Rays counted for Mrays/s: primary samples + one shadow ray per
    directional light per sample. AO taps and shadow-march steps are DE
    evaluations, not rays, and are not counted (the reference's count)."""
    primary = cfg.width * cfg.height * cfg.spp
    shadow = 0
    if cfg.shadow != "none" and scene is not None:
        shadow = primary * scene.lights.direction.shape[0]
    return primary + shadow


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler over the block (the CPU and, when there is one, the
    CUDA device), written to <log_dir>/trace.json as a Chrome trace; yields
    the profiler, whose events the caller may read after the block. A no-op
    yielding None when log_dir is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_devices(result, found: set) -> set:
    """The CUDA devices of the tensors in a result (tensors, dicts, lists,
    tuples)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, found)
    return found


def _finish(result):
    """Wait until the device work that produced `result` is done."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def block_and_time(fn, *args, warmup: int = 1, iters: int = 3, **kw):
    """Run fn (device work) warmup times, then iters timed times, each
    synchronized on the CUDA devices its result lives on -> (result,
    best_seconds)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = _finish(fn(*args, **kw))
    best = float("inf")
    for _ in range(max(iters, 1)):
        t = Timer().start()
        result = _finish(fn(*args, **kw))
        best = min(best, t.stop())
    return result, best
