"""The measured window's arithmetic: closed-loop calls timed by the host
clock, and the end-to-end metrics taken over all of them."""

from __future__ import annotations

import math
import time

from benchmark.work import mrays_per_sec


class Window:
    """Calls of one closed loop: each call is sent when the one before it has
    finished, until `seconds` have passed since the first was sent; the
    window ends when the last call ends."""

    def __init__(self):
        self.t0 = None
        self.starts, self.ends = [], []

    def run(self, call, seconds: float, after=None) -> "Window":
        """call(i) runs item i and returns once its result is on the host
        (synchronized); after(i, result), if given, runs between calls."""
        self.t0 = time.perf_counter()
        i = 0
        while True:
            start = time.perf_counter()
            out = call(i)
            end = time.perf_counter()
            self.starts.append(start)
            self.ends.append(end)
            if after is not None:
                after(i, out)
            i += 1
            if end - self.t0 >= seconds:
                return self

    @property
    def count(self) -> int:
        return len(self.ends)

    @property
    def wall_s(self) -> float:
        """From the first call's send to the last call's end."""
        return self.ends[-1] - self.t0

    def latencies(self) -> list:
        return [e - s for s, e in zip(self.starts, self.ends)]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all the values."""
    ordered = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[k - 1]


def end_to_end(name: str, item: str, rays: int, win: Window, setup_s: float):
    """The value of end-to-end metric `name` for a loop whose calls are
    `item`s of `rays` rays each, or None where the name is not this loop's:
    `setup_s`; `<item>_mrays_s`, the rays of every call over the window;
    `<item>_s_p<q>`, the q-th percentile of every call's latency."""
    if name == "setup_s":
        return setup_s
    if name == f"{item}_mrays_s":
        return mrays_per_sec(rays * win.count, win.wall_s)
    tail = f"{item}_s_p"
    if name.startswith(tail) and name[len(tail):].isdigit():
        return percentile(win.latencies(), float(name[len(tail):]))
    return None
