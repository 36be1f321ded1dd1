"""The window's arithmetic: a rate is all the work over all the time, and
a tail is the tail of every call."""

import pytest

from benchmark import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def timed(monkeypatch, durations, seconds):
    clock = Clock()
    monkeypatch.setattr(window.time, "perf_counter", clock)

    def call(i):
        clock.t += durations[i]

    return window.Window().run(call, seconds)


def test_a_stalled_call_lowers_the_rate_by_its_stall(monkeypatch):
    steady = timed(monkeypatch, [0.5] * 10, 5.0)
    stalled = timed(monkeypatch, [0.5] * 4 + [3.0] + [0.5] * 5, 5.0)
    assert steady.count == 10 and steady.wall_s == pytest.approx(5.0)
    assert window.end_to_end("frame_mrays_s", "frame", 8e6, steady, 0.0) == pytest.approx(16.0)
    # the window runs until 5 s have passed and ends with the call in flight:
    # 5 calls in 5 s, the stall's 2.5 s inside
    assert stalled.count == 5 and stalled.wall_s == pytest.approx(5.0)
    assert window.end_to_end("frame_mrays_s", "frame", 8e6, stalled, 0.0) == pytest.approx(8.0)


def test_p90_is_of_every_call(monkeypatch):
    durations = [0.1] * 18 + [1.0, 2.0]
    win = timed(monkeypatch, durations, sum(durations) - 1e-9)
    assert win.count == 20
    # nearest rank: the 18th of 20 sorted latencies
    assert window.end_to_end("frame_s_p90", "frame", 1, win, 0.0) == pytest.approx(0.1)
    assert window.end_to_end("frame_s_p95", "frame", 1, win, 0.0) == pytest.approx(1.0)
    assert window.percentile(range(1, 101), 90) == 90


def test_end_to_end_names():
    win = window.Window()
    win.t0, win.starts, win.ends = 0.0, [0.0, 1.0], [1.0, 2.0]
    assert window.end_to_end("setup_s", "fit", 10, win, 7.5) == 7.5
    assert window.end_to_end("fit_mrays_s", "fit", 4e6, win, 0.0) == pytest.approx(4.0)
    assert window.end_to_end("frame_mrays_s", "fit", 4e6, win, 0.0) is None
