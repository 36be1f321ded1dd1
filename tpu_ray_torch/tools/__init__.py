"""The port's measurement tools, counterparts of the JAX package's `tools/`:

    python -m tpu_ray_torch.tools.bench_all [out.json]       every BASELINE row
    python -m tpu_ray_torch.tools.profile_stages [scene]     time by cumulative stage
    python -m tpu_ray_torch.tools.profile_bwd [scene] [subset ...]
                                                             the backward by trainable subset
    python -m tpu_ray_torch.tools.profile_scatter            the vertex-gradient scatter
    python -m tpu_ray_torch.tools.profile_trace_ops [scene] [fwd|bwd] [top_n]
                                                             top device and host ops

Each takes `--device` (default `cuda`) and stops without a card unless
given `--device cpu`, where the kernels' plain versions run and no device
time exists. On CUDA each prints the card's nvidia-smi name and power limit
beside its numbers, and each ends with one JSON line of what it measured.

Shared here: the card's line, synchronized timing after a warm-up, the
kernels' launch counts, and torch.profiler windows read by kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

# the hand-written kernels by the names nvcc gives them, each with its
# number in the table of TPU kernels (PERF.md); no name holds another
HAND_KERNELS = (("march_kernel", "#1 march"), ("shadow_kernel", "#2 shadow"),
                ("packet_kernel", "#3 packet"), ("packet_resident_kernel", "#4 packet_resident"),
                ("shade_fwd_kernel", "#5 shade_fwd"), ("shade_bwd_kernel", "#6 shade_bwd"),
                ("sum_partials_kernel", "#6 sum_partials"))


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=f"tpu_ray_torch.tools.{prog}",
                                 description=doc.strip().split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def card(device: torch.device) -> dict:
    """The device's name and, on CUDA, its nvidia-smi power limit."""
    from tpu_ray_torch.bench import power_limit

    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    return {"device": torch.cuda.get_device_name(device), "power_limit": power_limit(device)}


def card_line(info: dict) -> str:
    if info["power_limit"] is None:
        return f"on {info['device']} (the plain PyTorch versions; no device time)"
    return f"on {info['device']}, {info['power_limit']}"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device, iters: int = 1, warm=None):
    """fn() after one untimed call of warm (fn itself when None), then
    iters timed calls, each synchronized on the device -> (the last
    result, the best seconds, the kernel launches of one call)."""
    (warm or fn)()
    sync(device)
    before = launch_counts()
    best, out = math.inf, None
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    launches = {k: n // max(iters, 1) for k, n in launches_since(before).items() if n}
    return out, best, launches


def launch_counts() -> dict:
    """Every kernel wrapper's launch count so far, by kernel."""
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf, cuda_shade

    return {"march": cuda_sdf.LAUNCHES["march"],
            "shadow_hard": cuda_sdf.LAUNCHES["shadow_hard"],
            "shadow_soft": cuda_sdf.LAUNCHES["shadow_soft"],
            "packet_closest": cuda_mt.LAUNCHES["closest"],
            "packet_any_hit": cuda_mt.LAUNCHES["any_hit"],
            "resident_closest": cuda_mt.LAUNCHES["resident_closest"],
            "resident_any_hit": cuda_mt.LAUNCHES["resident_any_hit"],
            "shade_fwd": cuda_shade.LAUNCHES["shade_fwd"],
            "shade_bwd": cuda_shade.LAUNCHES["shade_bwd"]}


def launches_since(before: dict) -> dict:
    """The launches made since the launch_counts() snapshot `before`."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def hand_kernel(name: str):
    """The label of the hand-written kernel a device event belongs to, or
    None."""
    for sub, label in HAND_KERNELS:
        if sub in name:
            return label
    return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def raw_events(prof) -> list:
    """(name, on the device, start ns, duration ns, thread) of every event
    a torch.profiler recorded, read from its raw results: building its
    parsed events (key_averages, events) takes ~50 us an event, minutes
    for a window of 32 `mixed` blocks."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(), e.duration_ns(),
             e.start_thread_id()) for e in prof.profiler.kineto_results.events()]


def device_totals(events) -> dict:
    """{name: [device ms, count]} of the device's events (kernels, copies)."""
    out = {}
    for name, on_device, _start, dur, _tid in events:
        if on_device and dur > 0:
            row = out.setdefault(name, [0.0, 0])
            row[0] += dur / 1e6
            row[1] += 1
    return out


def _by_thread(events, keep) -> list:
    """The host events that `keep` takes, per thread, each sorted so that an
    event comes before the events it contains."""
    threads = {}
    for name, on_device, start, dur, tid in events:
        if not on_device and keep(name):
            threads.setdefault(tid, []).append((start, -dur, name))
    return [sorted(evs) for evs in threads.values()]


def host_ops(events) -> int:
    """The aten operators that no other aten operator contains: the tensor
    ops the Python code and autograd dispatched."""
    n = 0
    for evs in _by_thread(events, lambda name: name.startswith("aten::")):
        end = None
        for start, neg_dur, _ in evs:
            if end is None or start >= end:
                n, end = n + 1, start - neg_dur
    return n


def host_self(events) -> dict:
    """{name: [self ms, count]} of the host's events: each event's duration
    less the durations of the events it contains directly."""
    out = {}
    for evs in _by_thread(events, lambda name: True):
        stack, self_ns = [], []
        for start, neg_dur, name in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            if stack:
                self_ns[stack[-1][1]] += neg_dur
            stack.append((start - neg_dur, len(self_ns)))
            self_ns.append(-neg_dur)
        for (_, _, name), ns in zip(evs, self_ns):
            row = out.setdefault(name, [0.0, 0])
            row[0] += max(ns, 0) / 1e6
            row[1] += 1
    return out


def window(fn, device: torch.device, trace_dir=None) -> tuple:
    """fn() once with the host clock, synchronized (wall ms), then once under
    torch.profiler (the CPU and, on CUDA, the device; with trace_dir,
    metrics.profile_trace, which writes the Chrome trace there) -> (the
    window: wall ms, the wall ms under the profiler, host ops and, on CUDA,
    device ms, busy share (device ms over the wall ms without the profiler,
    which slows the host), kernel launches, copies, device ms by category
    (each hand-written kernel, other kernels, memcpy / memset) and each
    hand-written kernel's device ms and launches, the device numbers None
    on the CPU; the raw events)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_ray_torch.utils.metrics import profile_trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with (profile_trace(trace_dir) if trace_dir else profile(activities=acts)) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = raw_events(prof)
    out = {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms, "host_ops": host_ops(events)}
    if device.type != "cuda":
        return dict(out, device_ms=None, busy=None, kernel_launches=None, copies=None,
                    by_category={}, kernels={}), events
    dev_ms = launches = copies = 0
    by_cat, kernels = {}, {}
    for name, (ms, count) in device_totals(events).items():
        dev_ms += ms
        label = hand_kernel(name)
        cat = label or ("memcpy/memset" if is_copy(name) else "other kernels")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        if is_copy(name):
            copies += count
            continue
        launches += count
        if label is not None:
            k = kernels.setdefault(label, {"ms": 0.0, "launches": 0})
            k["ms"] += ms
            k["launches"] += count
    return dict(out, device_ms=dev_ms, busy=dev_ms / wall_ms, kernel_launches=launches,
                copies=copies, by_category=by_cat, kernels=kernels), events


def per_block(win: dict, blocks: int) -> dict:
    """A window's counts and times a block of the `blocks` it covered."""
    out = {"blocks": blocks, "wall_ms_a_block": win["wall_ms"] / blocks,
           "host_ops_a_block": win["host_ops"] / blocks}
    if win["device_ms"] is not None:
        out.update(device_ms_a_block=win["device_ms"] / blocks,
                   kernel_launches_a_block=win["kernel_launches"] / blocks)
    return dict(win, **out)


def window_line(w: dict) -> str:
    """One line of a per_block window."""
    s = (f"host {w['wall_ms_a_block']:.3f} ms and {w['host_ops_a_block']:.1f} host ops "
         f"a block")
    if w["device_ms"] is None:
        return s
    ks = ", ".join(f"{k} {v['ms'] / w['blocks']:.4f} ms ({v['launches']})"
                   for k, v in sorted(w["kernels"].items()))
    return (f"{s}; device {w['device_ms_a_block']:.4f} ms a block, busy {w['busy']:.4f}, "
            f"{w['kernel_launches_a_block']:.1f} kernel launches a block; {ks or 'no hand kernel'}")


def emit(obj: dict) -> None:
    """The tool's last line: one JSON object."""
    print(json.dumps(obj), flush=True)
