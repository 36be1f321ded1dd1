"""BENCHMARK.json names files the harness finds by name, keeps the shape
its checker accepts, and takes a new cell, configuration, traffic mix or
metric as data, without an edit to a file that is there."""

import hashlib
import json
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_is_found():
    spec = harness.Spec(tiny.REPO)
    for w in SPEC["workloads"]:
        assert spec.config(w["config"])["render"]
        assert spec.traffic(w["traffic"])["loop"] in harness.LOOPS
        assert spec.limits(w["name"])
    for m in SPEC["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    # the check of a full benchmark of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        got = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def _hashes(root):
    return {p: hashlib.sha1(p.read_bytes()).hexdigest() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_cell_is_data(tmp_path, trace):
    """A configuration, traffic mix, cell, limits and per-layer metric added
    as files and entries run without an edit to any file that was there."""
    root = tiny.make_root(tmp_path)
    before = _hashes(root)
    home = root / "benchmark"
    conf = json.loads((home / "configs" / "mandelbulb.json").read_text())
    conf["render"]["shadow"] = "hard"
    (home / "configs" / "bulb_hard.json").write_text(json.dumps(conf))
    traffic = json.loads((home / "traffic" / "frames.json").read_text())
    traffic["turntable_poses"] = 4
    (home / "traffic" / "frames_quarter.json").write_text(json.dumps(traffic))
    (home / "limits" / "bulb_hard.frames_quarter.json").write_text(
        json.dumps(tiny.TINY_LIMITS["frames"]))
    (home / "metrics" / "render.blocks_traced.frames.py").write_text(
        "def read(trace):\n    return float(trace.blocks)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "bulb_hard", "source": "x", "file":
                            "benchmark/configs/bulb_hard.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "bulb_hard.frames_quarter", "config": "bulb_hard",
                              "traffic": "frames_quarter", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("frame_mrays_s", "frame_s_p90"):
            m["workloads"].append("bulb_hard.frames_quarter")
    spec["per_layer"].append({"name": "render.blocks_traced.frames", "unit": "blocks",
                              "better": "higher", "source": "device_trace", "layer": "render",
                              "moves": "frame_mrays_s",
                              "workloads": ["bulb_hard.frames_quarter"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _hashes(root)
    edited = [p for p, h in before.items() if p.name != "BENCHMARK.json" and after[p] != h]
    assert edited == []
    rc, res, err = tiny.run(root, "bulb_hard.frames_quarter", trace=trace)
    assert rc == 0, err
    assert res["correct"] is True
    want = ({"render.blocks_traced.frames"} if trace else
            {"frame_mrays_s", "frame_s_p90", "setup_s"})
    assert set(res["metrics"]) == want
