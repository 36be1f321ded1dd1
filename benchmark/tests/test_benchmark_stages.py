"""The readers of what the program records of itself (benchmark/stages.py):
the stages' device time after the program's marker kernels in a traced
window, and its graph counters; each None where it finds nothing."""

import types

import pytest

from benchmark import harness, profile, stages
from benchmark.loops import Trace
from benchmark.tests import tiny

SPEC = harness.Spec(tiny.REPO)
STAGE_READERS = ("render.reconstruct_ms.frames", "render.reconstruct_ms.fit",
                 "fit.vjp_backward_ms")
COUNTER_READERS = ("render.launch_ms.frames", "render.launch_ms.fit", "setup.capture_s")


def _trace(device_ops, item, blocks=2):
    """A Trace of a window whose device operations are (name, start ns,
    duration ns), in any order."""
    events = [(profile.MARKER, False, 0, 10_000_000, 1)]
    events += [(n, True, s, d, 0) for n, s, d in device_ops]
    return Trace(profile.Traced(events, 0.01), item, blocks, 64, {}, None, None, None, {})


# two blocks of a fit window: per block the block graph's markers and work,
# then the vjp graph's; a copy between replays, and a kernel before any marker
FIT_OPS = [("copy_before", 0, 500)]
for b, t0 in enumerate((1_000, 100_000)):
    FIT_OPS += [("trace_stage_rays", t0, 2), ("gen_rays", t0 + 10, 1_000),
                ("trace_stage_reconstruct", t0 + 2_000, 2), ("mul", t0 + 2_010, 30_000),
                ("Memcpy DtoD (Device -> Device)", t0 + 32_100, 1_000),
                ("trace_stage_shadow", t0 + 34_000, 2), ("shadow_kernel", t0 + 34_010, 5_000),
                ("trace_stage_shade", t0 + 40_000, 2), ("shade_fwd_kernel", t0 + 40_010, 2_000),
                ("trace_stage_vjp_forward", t0 + 50_000, 2),
                ("shade_fwd_kernel", t0 + 50_010, 2_000),
                ("trace_stage_vjp_backward", t0 + 60_000, 2),
                ("shade_bwd_kernel", t0 + 60_010, 4_000),
                ("scatter", t0 + 64_100, 16_000),
                ("trace_stage_vjp_accumulate", t0 + 90_000, 2), ("add", t0 + 90_010, 500)]


def test_stage_seconds_follow_the_markers():
    """Every operation after a marker goes to its stage, whatever order the
    events come in; the kernel before the first marker to none."""
    got = stages.stage_seconds(_trace(list(reversed(FIT_OPS)), "fit").traced)
    want = {"rays": 2_000e-9, "reconstruct": 62_000e-9, "shadow": 10_000e-9,
            "shade": 4_000e-9, "vjp_forward": 4_000e-9, "vjp_backward": 40_000e-9,
            "vjp_accumulate": 1_000e-9, "(markers)": 28e-9}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


@pytest.mark.parametrize("metric,item,want", [
    ("render.reconstruct_ms.fit", "fit", 0.031), ("fit.vjp_backward_ms", "fit", 0.020),
    ("render.reconstruct_ms.frames", "frame", 0.031)])
def test_stage_readers_read_ms_a_block(metric, item, want):
    # the reconstruct: 30,000 ns of `mul` and a 1,000 ns copy a block; the
    # vjp's backward: #6's 4,000 ns and the scatter's 16,000 a block
    read = SPEC.reader(metric)
    assert read(_trace(FIT_OPS, item)) == pytest.approx(want)
    other = "frame" if item == "fit" else "fit"
    assert read(_trace(FIT_OPS, other)) is None


@pytest.mark.parametrize("metric", STAGE_READERS)
def test_stage_readers_find_nothing_without_markers(metric):
    plain = [(n, s, d) for n, s, d in FIT_OPS if not n.startswith("trace_stage_")]
    read = SPEC.reader(metric)
    item = "frame" if metric.endswith("frames") else "fit"
    assert read(_trace(plain, item)) is None
    assert read(_trace([], item)) is None


def _counts(**kinds):
    base = dict.fromkeys(("replays", "launch_ns", "captures", "prepare_s"), 0)
    return types.MappingProxyType({k: types.MappingProxyType(dict(base, **v))
                                   for k, v in kinds.items()})


@pytest.mark.parametrize("metric,item,want", [
    ("render.launch_ms.frames", "frame", (3_000_000 + 96_000_000) / 1e6 / 96),
    ("render.launch_ms.fit", "fit", (3_000_000 + 96_000_000 + 48_000_000) / 1e6 / 96),
    ("setup.capture_s", "fit", 0.25 + 0.5 + 0.125)])
def test_counter_readers(monkeypatch, metric, item, want):
    from tpu_ray_torch.render import graphs

    counts = _counts(group=dict(replays=3, launch_ns=3_000_000, captures=1, prepare_s=0.25),
                     block=dict(replays=96, launch_ns=96_000_000, captures=1, prepare_s=0.5))
    if item == "fit":
        counts = _counts(**{k: dict(v) for k, v in counts.items()},
                         vjp=dict(replays=96, launch_ns=48_000_000, captures=1,
                                  prepare_s=0.125))
    monkeypatch.setattr(graphs, "counters", lambda: counts)
    read = SPEC.reader(metric)
    assert read(_trace([], item)) == pytest.approx(want)


@pytest.mark.parametrize("metric", COUNTER_READERS)
def test_counter_readers_find_nothing_without_captures(monkeypatch, metric):
    """No capture (the CPU), and a program that keeps no counters."""
    from tpu_ray_torch.render import graphs

    read = SPEC.reader(metric)
    item = "frame" if metric.endswith("frames") else "fit"
    monkeypatch.setattr(graphs, "counters", lambda: _counts(block=dict(replays=8)))
    assert read(_trace([], item)) is None
    monkeypatch.delattr(graphs, "counters")
    assert read(_trace([], item)) is None
