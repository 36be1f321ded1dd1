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
kernels' launch counts, and torch.profiler windows read by kernel, by the
program's stages (utils.metrics.STAGES: the device work after each stage's
marker) and by the program's spans that hold the device's idle time.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from tpu_ray_torch.kernels import launches
from tpu_ray_torch.utils import metrics

# the hand-written kernels by the names nvcc gives them, each with its
# number in the table of TPU kernels (PERF.md; the reconstruct has no TPU
# twin); no name holds another
HAND_KERNELS = (("march_kernel", "#1 march"), ("shadow_kernel", "#2 shadow"),
                ("packet_kernel", "#3 packet"), ("packet_resident_kernel", "#4 packet_resident"),
                ("shade_fwd_kernel", "#5 shade_fwd"), ("shade_bwd_kernel", "#6 shade_bwd"),
                ("sum_partials_kernel", "#6 sum_partials"), ("reconstruct_kernel", "reconstruct"),
                ("corner_gather_kernel", "corner_gather"),
                ("corner_tile_kernel", "corner_scatter tiles"),
                ("corner_combine_kernel", "corner_scatter combine"))
# launch_counts' names of the packet walk's launch kinds
_PACKET = {"closest": "packet_closest", "any_hit": "packet_any_hit"}


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
    """Every kernel wrapper's launch count so far, by kernel (the packet
    walk's as packet_closest and packet_any_hit)."""
    return {_PACKET.get(k, k): n for k, n in launches.counts().items()}


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
    """(name, on the device, start ns, duration ns, thread, in a graph) of
    every host event and device operation (kernel, copy, set) a
    torch.profiler recorded, read from its raw results: building its parsed
    events (key_averages, events) takes ~50 us an event, minutes for a
    window of 32 `mixed` blocks. A host range's annotation on the device's
    timeline is left out (no device work). In a graph: a device operation
    that a cudaGraphLaunch launched (they share the runtime call's
    correlation id)."""
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    launches = {e.correlation_id() for e in evs
                if e.device_type() != DeviceType.CUDA and e.name() == "cudaGraphLaunch"}
    out = []
    for e in evs:
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.is_user_annotation():
            continue
        out.append((e.name(), dev, e.start_ns(), e.duration_ns(), e.start_thread_id(),
                    dev and e.correlation_id() in launches))
    return out


def device_totals(events) -> dict:
    """{name: [device ms, count]} of the device's events (kernels, copies)."""
    out = {}
    for name, on_device, _start, dur, *_ in events:
        if on_device and dur > 0:
            row = out.setdefault(name, [0.0, 0])
            row[0] += dur / 1e6
            row[1] += 1
    return out


def _by_thread(events, keep) -> list:
    """The host events that `keep` takes, per thread, each sorted so that an
    event comes before the events it contains."""
    threads = {}
    for name, on_device, start, dur, tid, _ in events:
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


STAGE_OF_MARKER = {metrics.marker_kernel(s): s for s in metrics.STAGES}
PROGRAM_SPANS = (set(metrics.RENDER_SPANS) | set(metrics.FIT_SPANS) | set(metrics.ACCEL_SPANS)
                 | {f"stage.{s}" for s in metrics.STAGES})
MARKER = "tools.window"
NO_MARKER = "(no marker)"


def stage_ms(events) -> dict:
    """{stage: device ms} of the window's device operations, each under the
    stage whose marker came last before it on the device among the
    operations of its kind (launched by a graph, or not); the markers'
    own ms under "(markers)", and the operations that follow no marker of
    their kind under NO_MARKER (in a graphed window: the copies between
    replays)."""
    ops = sorted((start, dur, name, graph) for name, on_device, start, dur, _, graph in events
                 if on_device and dur > 0)
    current = {True: NO_MARKER, False: NO_MARKER}
    out = {}
    for _, dur, name, graph in ops:
        if name in STAGE_OF_MARKER:
            current[graph] = STAGE_OF_MARKER[name]
            label = "(markers)"
        else:
            label = current[graph]
        out[label] = out.get(label, 0.0) + dur / 1e6
    return out


def window_bounds(events, marker: str = MARKER) -> tuple:
    """(start, end) ns of the window's marker range."""
    return next((s, s + d) for n, dev, s, d, *_ in events if not dev and n == marker)


def busy_intervals(events, start: int, end: int) -> list:
    """The union of the device's operations between start and end ns, as
    sorted disjoint [start, end] ns."""
    out = []
    for a, b in sorted((max(s, start), min(s + d, end))
                       for _, dev, s, d, *_ in events if dev and d > 0):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(events, marker: str = MARKER) -> dict:
    """The device's idle time in the window by the program span that holds
    it -> {"idle_ms", "in_spans_ms", "by_span": {"<span> (<thread>)": ms}}:
    each gap between the window's busy intervals goes to the innermost
    program span (utils.metrics: render.*, fit.*, stage.*) open at its
    middle on any thread, the one that began last; "(no span)" where none
    is. Threads: "caller" (the window's), else "thread <n>" in the order
    they first appear. marker: the range that bounds the window."""
    start, end = window_bounds(events, marker)
    caller = next(t for n, dev, _, _, t, _ in events if not dev and n == marker)
    gaps, at = [], start
    for a, b in busy_intervals(events, start, end):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if end > at:
        gaps.append((at, end))
    names, by_thread = {caller: "caller"}, {}
    for n, dev, s, d, t, _ in events:
        if not dev and n in PROGRAM_SPANS:
            names.setdefault(t, f"thread {len(names)}")
            by_thread.setdefault(t, []).append((s, -d, n))
    # each thread's spans nest: a sweep keeps the stack of those open
    sweep = {t: [sorted(evs), 0, []] for t, evs in by_thread.items()}
    out, idle, held = {}, 0, 0
    for a, b in gaps:
        mid, inner = (a + b) // 2, None
        for t, (evs, j, stack) in sweep.items():
            while j < len(evs) and evs[j][0] <= mid:
                s, neg, n = evs[j]
                while stack and stack[-1][1] <= s:
                    stack.pop()
                stack.append((s, s - neg, n))
                j += 1
            sweep[t][1] = j
            while stack and stack[-1][1] <= mid:
                stack.pop()
            if stack and (inner is None or stack[-1][0] > inner[0]):
                inner = (stack[-1][0], stack[-1][2], t)
        label = f"{inner[1]} ({names[inner[2]]})" if inner else "(no span)"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
        idle += b - a
        held += (b - a) if inner else 0
    return {"idle_ms": idle / 1e6, "in_spans_ms": held / 1e6,
            "by_span": dict(sorted(out.items(), key=lambda kv: -kv[1]))}


def window(fn, device: torch.device, trace_dir=None) -> tuple:
    """fn() once with the host clock, synchronized (wall ms), then once under
    torch.profiler (the CPU and, on CUDA, the device; with trace_dir,
    metrics.profile_trace, which writes the Chrome trace there) inside the
    range MARKER, which ends after the device has finished -> (the window:
    wall ms, the wall ms under the profiler, host ops and, on CUDA, device
    ms, busy share (the union of the device's intervals over the profiled
    window's own wall, so never above 1), kernel launches, copies, device
    ms by category (each hand-written kernel, other kernels, memcpy /
    memset), each hand-written kernel's device ms and launches, device ms
    by stage (stage_ms) and the idle time by span (idle_by_span), the
    device numbers None on the CPU; the raw events)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with (metrics.profile_trace(trace_dir) if trace_dir else profile(activities=acts)) as prof:
        t0 = time.perf_counter()
        with record_function(MARKER):
            fn()
            sync(device)
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = raw_events(prof)
    out = {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms, "host_ops": host_ops(events)}
    if device.type != "cuda":
        return dict(out, device_ms=None, busy=None, kernel_launches=None, copies=None,
                    by_category={}, kernels={}, stages={}, idle=None), events
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
    start, end = window_bounds(events)
    busy = sum(b - a for a, b in busy_intervals(events, start, end)) / max(end - start, 1)
    return dict(out, device_ms=dev_ms, busy=busy, kernel_launches=launches, copies=copies,
                by_category=by_cat, kernels=kernels, stages=stage_ms(events),
                idle=idle_by_span(events)), events


def per_block(win: dict, blocks: int) -> dict:
    """A window's counts and times a block of the `blocks` it covered."""
    out = {"blocks": blocks, "wall_ms_a_block": win["wall_ms"] / blocks,
           "host_ops_a_block": win["host_ops"] / blocks}
    if win["device_ms"] is not None:
        out.update(device_ms_a_block=win["device_ms"] / blocks,
                   kernel_launches_a_block=win["kernel_launches"] / blocks,
                   stage_ms_a_block={k: v / blocks for k, v in win["stages"].items()})
    return dict(win, **out)


def window_line(w: dict) -> str:
    """One line of a per_block window."""
    s = (f"host {w['wall_ms_a_block']:.3f} ms and {w['host_ops_a_block']:.1f} host ops "
         f"a block")
    if w["device_ms"] is None:
        return s
    ks = ", ".join(f"{k} {v['ms'] / w['blocks']:.4f} ms ({v['launches']})"
                   for k, v in sorted(w["kernels"].items()))
    st = ", ".join(f"{k} {v:.4f}" for k, v in w["stage_ms_a_block"].items())
    return (f"{s}; device {w['device_ms_a_block']:.4f} ms a block, busy {w['busy']:.4f}, "
            f"{w['kernel_launches_a_block']:.1f} kernel launches a block; {ks or 'no hand kernel'}"
            f"; by stage, ms a block: {st or 'no marker'}")


def emit(obj: dict) -> None:
    """The tool's last line: one JSON object."""
    print(json.dumps(obj), flush=True)
