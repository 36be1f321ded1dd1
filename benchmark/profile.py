"""Reading one torch.profiler window: its raw events, the device's busy
time as a union of intervals over that same window, the top device
operations, and the device's idle gaps by what the host was doing.

The raw-event reader and the kernel labels are frozen copies of
tpu_ray_torch/tools/__init__.py:28-32 and 103-125 (`HAND_KERNELS`,
`hand_kernel`, `is_copy`, `raw_events`) at commit c4adc4a. The busy share
there divided the device time of one run by the wall time of another; here
both come from one window.
"""

from __future__ import annotations

import time

import torch

# the hand-written kernels by the names nvcc gives them, each with its
# number in PERF.md's table of TPU kernels; no name holds another
HAND_KERNELS = (("march_kernel", "#1 march"), ("shadow_kernel", "#2 shadow"),
                ("packet_kernel", "#3 packet"), ("packet_resident_kernel", "#4 packet_resident"),
                ("shade_fwd_kernel", "#5 shade_fwd"), ("shade_bwd_kernel", "#6 shade_bwd"),
                ("sum_partials_kernel", "#6 sum_partials"))
MARKER = "benchmark.traced_window"


def hand_kernel(name: str):
    for sub, label in HAND_KERNELS:
        if sub in name:
            return label
    return None


def label(name: str) -> str:
    """A device operation's name for the breakdown: a hand-written kernel's
    number and name, any other's name cut to 160 characters."""
    hand = hand_kernel(name)
    return f"{hand} ({name[:120]})" if hand else name[:160]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def raw_events(prof) -> list:
    """(name, on the device, start ns, duration ns, thread) of every host
    event and device operation (kernel, copy, set) the profiler recorded,
    read from its raw results (its parsed events cost ~50 us an event)."""
    from torch.autograd import DeviceType

    def on_device(e):
        # a range's annotation on the device's timeline is no device work
        return (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and e.name() != MARKER)

    return [(e.name(), on_device(e), e.start_ns(), e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CUDA or on_device(e)]


class Traced:
    """The events of one profiled call and the window they fall in: from
    the start of the call to the end of its final synchronize, as the
    marker range around both records it."""

    def __init__(self, events, wall_s: float):
        self.events = events
        self.host_wall_s = wall_s
        marks = [(s, s + d) for n, dev, s, d, _ in events if not dev and n == MARKER]
        self.start_ns, self.end_ns = marks[0] if marks else (0, 0)
        self.device = [(n, s, d) for n, dev, s, d, _ in events if dev and d > 0]
        self.kernels = [(n, s, d) for n, s, d in self.device if not is_copy(n)]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device's kernel and copy intervals, clipped to the
        window, as sorted disjoint (start, end) ns."""
        spans = sorted((max(s, self.start_ns), min(s + d, self.end_ns))
                       for _, s, d in self.device)
        out = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_time(self, sub: str):
        """(launches, device seconds) of the kernels whose name holds sub."""
        hits = [d for n, _, d in self.kernels if sub in n]
        return len(hits), sum(hits) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took the most time."""
        tot = {}
        for n, _, d in self.device:
            tot[n] = tot.get(n, 0) + d
        return [[n, ns / 1e9] for n, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[host activity, seconds] of the device's idle time in the window,
        summed by the innermost host operation under each gap's middle."""
        busy = self.busy_intervals()
        gaps, at = [], self.start_ns
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.end_ns > at:
            gaps.append((at, self.end_ns))
        # the thread that made the call: its events nest, so a stack holds
        # the ones that contain the sweep's point, the innermost on top
        tids = [t for n, dev, _, _, t in self.events if not dev and n == MARKER]
        host = sorted((s, -d, n) for n, dev, s, d, t in self.events
                      if not dev and n != MARKER and d > 0 and (not tids or t == tids[0]))
        tot, stack, j = {}, [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while j < len(host) and host[j][0] <= mid:
                s, neg, n = host[j]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, s - neg, n))
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "(no host operation)"
            tot[label] = tot.get(label, 0) + (b - a)
        return [[n, ns / 1e9] for n, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def trace(fn, device: torch.device) -> Traced:
    """fn() once under torch.profiler (the host and, on CUDA, the device),
    inside the marker range, synchronized at its end."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(MARKER):
            fn()
            sync()
        wall = time.perf_counter() - t0
    return Traced(raw_events(prof), wall)

