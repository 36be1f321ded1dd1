"""Timing, ray counts and structured metrics logging (counterpart of
`tpu_ray/utils/metrics.py`): wall-clock timing around synchronized device
work, the Mrays/s ray count, JSONL metrics, and a torch.profiler trace
(`profile_trace`) written as a Chrome trace."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch


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


@dataclasses.dataclass
class MetricsLogger:
    """Structured JSONL metrics: appended to `path` and/or printed."""

    path: Optional[str] = None
    echo: bool = False

    def log(self, **kv):
        kv.setdefault("ts", time.time())
        line = json.dumps(kv)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(line + "\n")
        if self.echo:
            print(line)


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
