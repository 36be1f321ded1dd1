"""The port's bench_all (tpu_ray_torch/tools/bench_all.py) against the JAX
package's tools/bench_all.py, and what every tool of tpu_ray_torch/tools
shares: the stop without a card, the card's line, the kernel names.

The JAX tools live in tools/, which is not a package: each is loaded from
its file. run_bench is patched in both tools to record its calls, so that
the rows and their order are compared without running the reference's
benches; one real row (`sphere` cut to 16x16) runs through the port's bench
on the CPU.

Tolerances: the rows, their order and keywords, and the JSON's shape are
compared exactly; the real row's times only need to be positive and finite
(a CPU time is no device metric). The host ops counted from the profiler's
raw events equal those its parsed events give; their self times agree
within 0.02 ms + 5% (the parsed events round to microseconds).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tpu_ray_torch import tools
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.tools import (bench_all, profile_bwd, profile_scatter, profile_stages,
                                 profile_trace_ops)
from test_torch_bench import _small

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """tools/<name>.py of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recorder(calls):
    def run_bench(scene, **kw):
        calls.append((scene, kw))
        return {"fwd_seconds": 1.0, "value": 2.0, "fwdbwd_seconds": 3.0, "mrays_fwdbwd": 4.0,
                "scene": scene}
    return run_bench


def test_rows_and_their_order_equal_the_jax_tools(monkeypatch, tmp_path, capsys):
    jtool = jax_tool("bench_all")
    want, got = [], []
    monkeypatch.setattr(jtool, "run_bench", _recorder(want))
    monkeypatch.setattr(bench_all, "run_bench", _recorder(got))
    jtool.main(str(tmp_path / "jax.json"))
    jax_lines = capsys.readouterr().out.splitlines()
    out = bench_all.main(str(tmp_path / "sub" / "port.json"), device="cpu")
    port_lines = capsys.readouterr().out.splitlines()
    assert [s for s, _ in want] == ["sphere", "triangles", "bunny", "mandelbulb", "mandelbulb",
                                    "mixed"]
    assert [(s, {k: v for k, v in kw.items() if k != "device"}) for s, kw in got] == want
    assert all(kw["device"] == torch.device("cpu") for _, kw in got)
    # the summary lines in the reference's format, one a row
    assert port_lines[1:7] == jax_lines[:6]
    assert "mandelbulb+diff_vis" in port_lines[5]
    saved = json.loads((tmp_path / "sub" / "port.json").read_text())
    assert saved == out == json.loads(port_lines[-1])
    assert list(saved) == ["rows"] and len(saved["rows"]) == 6
    assert json.loads((tmp_path / "jax.json").read_text()) == saved


def test_default_output_lies_under_build():
    assert bench_all.DEFAULT_OUT == os.path.join("build", "bench_all.json")
    assert bench_all.ROWS[4] == ("mandelbulb", {"diff_vis": True})


def test_a_real_sphere_row_on_cpu(monkeypatch, tmp_path, capsys):
    """`sphere` cut to 16x16 through the port's bench on the CPU: the
    bench's keys, positive finite times, the device and no power limit."""
    _small(tscenes, monkeypatch)
    out = bench_all.main(str(tmp_path / "b.json"), device="cpu", rows=(("sphere", {}),))
    (row,) = out["rows"]
    assert row["metric"] == "Mrays_per_sec_per_chip_fwd_sphere_16x16_spp1"
    assert row["device"] == "cpu" and row["power_limit"] is None
    assert row["persistent_loop"] and not row["backward_diff_vis"]
    for k in ("value", "fwd_seconds", "fwdbwd_seconds", "mrays_fwdbwd"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[bench_all] on cpu (the plain PyTorch versions; no device time)"
    assert lines[1].startswith("sphere ") and "Mrays/s" in lines[1]
    assert json.loads(lines[-1]) == out


def test_cli_takes_the_jax_tools_argument(monkeypatch):
    seen = []
    monkeypatch.setattr(bench_all, "main", lambda out, device: seen.append((out, device)))
    bench_all.cli(["x.json", "--device", "cpu"])
    bench_all.cli([])
    assert seen == [("x.json", "cpu"), (bench_all.DEFAULT_OUT, "cuda")]


@pytest.mark.parametrize("run", [
    lambda: bench_all.main("unused.json"),
    lambda: profile_stages.main("sphere"),
    lambda: profile_bwd.main("sphere"),
    lambda: profile_scatter.main(),
    lambda: profile_trace_ops.main("sphere", "fwd"),
], ids=["bench_all", "profile_stages", "profile_bwd", "profile_scatter", "profile_trace_ops"])
def test_every_tool_stops_without_a_card(monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device; pass --device cpu"):
        run()


@pytest.mark.parametrize("name, label", [
    ("void march_kernel<true>(float const*, float const*, int)", "#1 march"),
    ("_Z13shadow_kernelILb1ELb0EEvPKfS1_", "#2 shadow"),
    ("packet_kernel(PacketArgs)", "#3 packet"),
    ("packet_resident_kernel(PacketArgs)", "#4 packet_resident"),
    ("void shade_fwd_kernel<true>(ShadeArgs)", "#5 shade_fwd"),
    ("void shade_bwd_kernel<false>(ShadeArgs)", "#6 shade_bwd"),
    ("sum_partials_kernel(float const*, float*, int, int)", "#6 sum_partials"),
    ("void reconstruct_kernel<true>(tr::ShadeParams, tr::ReconArgs, int)", "reconstruct"),
    ("trace_stage_reconstruct", None),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_device_events_are_named_by_kernel(name, label):
    assert tools.hand_kernel(name) == label
    assert tools.is_copy(name) == name.startswith("Memcpy")


def test_host_ops_count_the_operators_called_from_python():
    """Two tensor ops and a sum, and the backward: the aten operators
    nested in another (to, copy_, ...) are not counted, the same count as
    the profiler's parsed parent links give."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = (x * 2.0 + 1.0).sum()
        y.backward()
    events = tools.raw_events(prof)
    n = tools.host_ops(events)
    top = 0
    for e in prof.events():
        p = e.cpu_parent
        while p is not None and not p.name.startswith("aten::"):
            p = p.cpu_parent
        top += e.name.startswith("aten::") and p is None
    assert n == top and 3 <= n < sum(name.startswith("aten::") for name, *_ in events)
    self_ms = tools.host_self(events)
    want = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()}
    for name, (ms, count) in self_ms.items():
        assert abs(ms - want[name]) <= 0.02 + 0.05 * want[name], name
    assert tools.device_totals(events) == {}
    win, events = tools.window(lambda: (x * 2.0).sum(), torch.device("cpu"))
    assert win["host_ops"] == 2 == tools.host_ops(events) and win["wall_ms"] > 0
    assert win["device_ms"] is None and win["by_category"] == {} == win["kernels"]
    assert win["profiled_wall_ms"] > 0
    blk = tools.per_block(win, 2)
    assert blk["host_ops_a_block"] == 1.0 and "device_ms_a_block" not in blk
    assert "host ops a block" in tools.window_line(blk)


def test_timed_counts_the_launches_of_one_call(monkeypatch):
    """On the CPU the wrappers launch nothing; a counter moved by the timed
    calls (not the warm-up's) is reported a call."""
    from tpu_ray_torch.kernels import cuda_sdf

    calls = []

    def fn():
        calls.append(1)
        cuda_sdf.LAUNCHES["march"] += 2
        return torch.ones(1)

    before = dict(cuda_sdf.LAUNCHES)
    try:
        out, sec, launches = tools.timed(fn, torch.device("cpu"), iters=3,
                                         warm=lambda: cuda_sdf.LAUNCHES.update(march=99))
    finally:
        cuda_sdf.LAUNCHES.update(before)
    assert len(calls) == 3 and launches == {"march": 2} and sec > 0
    assert torch.equal(out, torch.ones(1))
