"""What the port records of itself (utils/metrics.py, render/graphs.py,
tools/__init__.py), on the CPU: the host spans of a frame and a fit step
under torch.profiler and their nesting, no record_function call without a
profiler, the stage markers' order and names (the marker kernels of
csrc/trace_stage.cu), the graphs' counters, and the tools' reading of a
window by stage, by the spans that hold the device's idle time, and its
busy share."""

import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_ray_torch import fit, tools
from tpu_ray_torch.render import graphs
from tpu_ray_torch.render import render as R
from tpu_ray_torch.scene.scenes import build_scene
from tpu_ray_torch.utils import metrics

CSRC = Path(fit.__file__).resolve().parent / "csrc"
# 16x16x1 in blocks of 64 samples: 4 blocks, one march group
TINY = dict(width=16, height=16, spp=1, block_size=64)
# each documented span (and each stage's span) with the spans it opens in,
# innermost first, as the docstrings of render/, graphs.py and fit.py give them
PARENTS = {
    "fit.params": (None,), "fit.forward": (None,), "fit.backward": (None,),
    "fit.optimizer": (None,),
    "render.frame": ("fit.forward", None),
    "render.prepare": ("render.frame",), "render.to_image": ("render.frame",),
    "render.load": ("render.frame", "render.backward"),
    "render.group": ("render.frame",), "render.block": ("render.frame",),
    "render.backward": ("fit.backward",), "render.vjp": ("render.backward",),
    "stage.march": ("render.group",),
    **{f"stage.{s}": ("render.block",) for s in ("rays", "walk", "reconstruct", "shadow",
                                                   "shade")},
    **{f"stage.{s}": ("render.vjp",) for s in ("vjp.forward", "vjp.backward",
                                                 "vjp.accumulate")},
}


def _scene(name, **over):
    scene, cfg = build_scene(name, device="cpu")
    return scene, cfg.replace(**TINY, **over)


def _spans(prof) -> list:
    """(name, parent) of every program span the profiler recorded, the
    parent the innermost program span around it on its thread."""
    evs = sorted((e.start_ns(), -e.duration_ns(), e.name(), e.start_thread_id())
                 for e in prof.profiler.kineto_results.events() if e.name() in PARENTS)
    out, stacks = [], {}
    for s, neg, n, t in evs:
        stack = stacks.setdefault(t, [])
        while stack and stack[-1][0] <= s:
            stack.pop()
        out.append((n, stack[-1][1] if stack else None))
        stack.append((s - neg, n))
    return out


def test_a_fit_step_records_every_span_nested_as_documented():
    """`sphere` with hard shadows, two trainables: a step's spans, each
    opened where its docstring says, and every fit and render span there."""
    scene, cfg = _scene("sphere", shadow="hard")
    params = fit.extract_params(scene, ["sdf.sph_radius", "materials.albedo"])
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    step = fit.make_fit_step(scene, cfg, torch.full((16, 16, 3), 0.5), params, opt)
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    spans = _spans(prof)
    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    seen = {n for n, _ in spans}
    assert set(metrics.FIT_SPANS) | set(metrics.RENDER_SPANS) <= seen
    want = {"stage.march", "stage.rays", "stage.reconstruct", "stage.shadow", "stage.shade",
            "stage.vjp.forward", "stage.vjp.backward", "stage.vjp.accumulate"}
    assert want <= seen and "stage.walk" not in seen
    count = {n: sum(m == n for m, _ in spans) for n in seen}
    assert count["render.block"] == count["render.vjp"] == count["stage.shade"] == 4
    assert count["render.group"] == 1 and count["render.load"] == 2
    assert [n for n, _ in spans if n.startswith("fit.")] == list(metrics.FIT_SPANS)


def test_a_mesh_frame_records_its_walk():
    """`triangles` (a mesh, hard shadows, no SDF): a frame's spans outside
    a fit step, no group, the walk stage in each block."""
    scene, cfg = _scene("triangles")
    with torch.no_grad():
        R.render_image_jit(scene, cfg)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            R.render_image_jit(scene, cfg)
    spans = _spans(prof)
    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    seen = [n for n, _ in spans]
    assert seen.count("stage.walk") == seen.count("render.block") == 4
    assert "render.group" not in seen and "render.backward" not in seen


def test_without_a_profiler_a_span_calls_nothing(monkeypatch):
    """No record_function call in a frame and a step without a profiler;
    one a span under it."""
    calls = []
    real = metrics.record_function
    monkeypatch.setattr(metrics, "record_function",
                        lambda name: calls.append(name) or real(name))
    scene, cfg = _scene("sphere", shadow="hard")
    params = fit.extract_params(scene, ["materials.albedo"])
    opt = torch.optim.SGD(params.values(), lr=1e-2)
    fit.make_fit_step(scene, cfg, torch.zeros(16, 16, 3), params, opt)()
    with metrics.span("render.frame"):
        pass
    assert calls == [] and metrics.span("x") is metrics.span("y")
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("render.frame"):
            pass
    assert calls == ["render.frame"]


def test_stages_run_in_the_documented_order(monkeypatch):
    """The stages an eager `sphere` frame with hard shadows begins, in
    order: its group's march, then each block's rays, reconstruct, shadow
    and shade; a `triangles` block walks first."""
    seen = []
    real = R.stage
    monkeypatch.setattr(R, "stage", lambda name, dev: seen.append(name) or real(name, dev))
    with torch.no_grad():
        R.render_image(*_scene("sphere", shadow="hard"))
        assert seen == ["march"] + ["rays", "reconstruct", "shadow", "shade"] * 4
        seen.clear()
        R.render_image(*_scene("triangles"))
    assert seen == ["rays", "walk", "reconstruct", "shadow", "shade"] * 4


def test_stage_names_are_the_marker_kernels_of_csrc():
    """Each stage's marker kernel is declared in csrc/trace_stage.cu, and
    tr_trace_stage launches stage i's as case i."""
    src = (CSRC / "trace_stage.cu").read_text()
    declared = re.findall(r'extern "C" __global__ void (trace_stage_\w+)\(\)', src)
    cases = re.findall(r"case (\d+): (trace_stage_\w+)<<<1, 1, 0, s>>>\(\)", src)
    want = [metrics.marker_kernel(s) for s in metrics.STAGES]
    assert declared == want
    assert [(int(i), k) for i, k in cases] == list(enumerate(want))


def test_a_stage_launches_its_marker_on_a_cuda_device(monkeypatch):
    """On a `cuda` device (faked) stage() launches the stage's marker by its
    index on the current stream, and a failed launch raises."""
    from tpu_ray_torch.kernels import build

    launched = []

    class Lib:
        rc = 0

        def tr_trace_stage(self, which, stream):
            launched.append((which, stream))
            return self.rc

    lib = Lib()
    monkeypatch.setattr(build, "kernel_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 77})())
    with metrics.stage("vjp.backward", torch.device("cuda")):
        pass
    metrics.stage("march", torch.device("cuda"))
    assert launched == [(7, 77), (0, 77)]
    lib.rc = 1
    with pytest.raises(RuntimeError, match="trace_stage"):
        metrics.stage("shade", torch.device("cuda"))
    metrics.stage("shade", torch.device("cpu"))  # the span alone
    assert len(launched) == 3
    with pytest.raises(KeyError):
        metrics.stage("scatter", torch.device("cpu"))


def _counts():
    return {k: dict(v) for k, v in graphs.counters().items()}


def _delta(after, before):
    return {k: {c: after[k][c] - before.get(k, {}).get(c, 0) for c in graphs.COUNT_KEYS}
            for k in after}


def test_graph_counters_count_replays_and_captures(monkeypatch):
    """On the CPU a replay runs the callable: counted, with no launch time
    and no capture. Under a fake capture each graph captures once and its
    replays' launches are timed. The snapshot is read-only."""
    scene, cfg = _scene("sphere", shadow="hard")
    graphs.PLANS.clear()
    before = _counts()
    params = fit.extract_params(scene, ["materials.albedo"])
    torch.mean(R.render_image_jit(fit.apply_params(scene, params), cfg) ** 2).backward()
    got = _delta(_counts(), before)
    assert {k: got[k]["replays"] for k in ("group", "block", "vjp")} == dict(group=1, block=4,
                                                                             vjp=4)
    assert all(got[k][c] == 0 for k in got for c in ("launch_ns", "captures", "prepare_s"))
    with pytest.raises(TypeError):
        graphs.counters()["block"]["replays"] = 0

    def launch(self):
        self.fn()

    monkeypatch.setattr(graphs.Graph, "captures", True)
    monkeypatch.setattr(graphs.Graph, "_capture", lambda self: ("graph", self.fn()))
    monkeypatch.setattr(graphs.Graph, "_warm_up", lambda self: self.fn())
    monkeypatch.setattr(graphs.Graph, "_launch", launch)
    graphs.PLANS.clear()
    before = _counts()
    with torch.no_grad():
        for _ in range(2):
            R.render_image_jit(scene, cfg)
    got = _delta(_counts(), before)
    assert {k: (got[k]["replays"], got[k]["captures"]) for k in ("group", "block")} == {
        "group": (2, 1), "block": (8, 1)}
    for k in ("group", "block"):
        assert got[k]["launch_ns"] > 0 and got[k]["prepare_s"] > 0
    graphs.PLANS.clear()


def _ev(name, on_device, start, dur, thread=1, graph=False):
    return (name, on_device, start, dur, thread, graph)


def test_tools_read_a_window_by_stage_by_span_and_busy():
    """A synthetic window: two graph replays of markers and work, an eager
    copy between them; the autograd thread's span holds one idle gap."""
    mk = metrics.marker_kernel
    events = [
        _ev(tools.MARKER, False, 0, 1_000), _ev("render.block", False, 0, 400),
        _ev("render.vjp", False, 500, 400, thread=2), _ev("cudaGraphLaunch", False, 10, 5),
        _ev(mk("rays"), True, 100, 2, graph=True), _ev("gen", True, 110, 40, graph=True),
        _ev(mk("reconstruct"), True, 160, 2, graph=True), _ev("mul", True, 170, 100, graph=True),
        _ev("Memcpy DtoD", True, 300, 50),
        _ev(mk("vjp.backward"), True, 600, 2, graph=True), _ev("bwd", True, 610, 200, graph=True),
    ]
    st = tools.stage_ms(events)
    assert st == {"(markers)": pytest.approx(6e-6), "rays": pytest.approx(40e-6),
                  "reconstruct": pytest.approx(100e-6), tools.NO_MARKER: pytest.approx(50e-6),
                  "vjp.backward": pytest.approx(200e-6)}
    busy = tools.busy_intervals(events, *tools.window_bounds(events))
    assert busy == [[100, 102], [110, 150], [160, 162], [170, 270], [300, 350], [600, 602],
                    [610, 810]]
    idle = tools.idle_by_span(events)
    # gaps by their middles: 0-100, 102-110, 150-160, 162-170 and 270-300
    # in render.block (the caller); 350-600 (475) in no span; 602-610 in
    # render.vjp on the second thread; 810-1000 (905) in no span
    assert idle["idle_ms"] == pytest.approx(1e-6 * (100 + 8 + 10 + 8 + 30 + 250 + 8 + 190))
    assert idle["by_span"] == {"render.block (caller)": pytest.approx(1e-6 * 156),
                               "(no span)": pytest.approx(1e-6 * 440),
                               "render.vjp (thread 1)": pytest.approx(1e-6 * 8)}
    assert idle["in_spans_ms"] == pytest.approx(1e-6 * 164)


def test_window_busy_is_one_window_s_share():
    """tools.window on the CPU: no device number; its marker range bounds
    the profiled call."""
    x = torch.ones(64)
    win, events = tools.window(lambda: (x * 2.0).sum(), torch.device("cpu"))
    start, end = tools.window_bounds(events)
    assert 0 < end - start <= win["profiled_wall_ms"] * 1e6
    assert win["busy"] is None and win["stages"] == {} and win["idle"] is None
