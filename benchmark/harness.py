"""One run of one cell: find what BENCHMARK.json names, set the cell up,
measure its window, trace it (--trace 1), judge its output, and build the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by name:

  benchmark/configs/<config>.json   the configuration's file (its `file`
                                    in BENCHMARK.json)
  benchmark/traffic/<traffic>.json  the traffic mix: the loop it drives
                                    (loops.LOOPS) and its parameters
  benchmark/limits/<cell>.json      the limit of each number that decides
                                    `correct` in that cell
  benchmark/metrics/<metric>.py     a per-layer metric's reader: read(trace)
                                    -> its value, or None where it finds
                                    nothing to read
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark import profile
from benchmark import window as win_lib
from benchmark.loops import LOOPS

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ray")


class Spec:
    """BENCHMARK.json and the files it names, under root."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.home / "limits" / f"{cell}.json").read_text())

    def metrics(self, kind: str, cell: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics the cell reports."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden():
    """Stop the run, with no result, where such a module is loaded."""
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not load: {found}")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"power limit not read ({e.__class__.__name__})"


def run(spec: Spec, cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, notes: list) -> dict:
    """One run of `cell` -> the result line's dict; notes gets the lines for
    standard error. t_start: the host clock when the process started."""
    w = spec.workload(cell)
    traffic = spec.traffic(w["traffic"])
    loop = LOOPS[traffic["loop"]](spec.config(w["config"]), traffic, seed, device)
    limits = spec.limits(cell)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    off = loop.spans_on() if trace and hasattr(loop, "spans_on") else None
    win = win_lib.Window().run(loop.call, seconds, loop.after)
    if off is not None:
        off()
    refuse_forbidden()
    on_cuda = device.type == "cuda"
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0}
    notes.append(f"card: {power_limit() if on_cuda else 'cpu'}")
    notes.append(f"setup_s {setup_s} window {win.wall_s} s, {win.count} {loop.item}s of "
                 f"{loop.rays} rays; latencies {win.latencies()}")
    result = {"correct": False, "attempted": win.count, "failed": 0, "metrics": {}, "device": dev}
    if trace:
        tr = loop.trace()
        dev["busy_s"] = tr.traced.busy_s()
        dev["window_s"] = tr.traced.window_s
        notes.append(f"traced window: {tr.blocks} blocks, {tr.traced.window_s} s, busy "
                     f"{dev['busy_s']} s, host wall {tr.traced.host_wall_s} s")
        for m in spec.metrics("per_layer", cell):
            value = spec.reader(m["name"])(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": [[profile.label(n), s]
                                              for n, s in tr.traced.device_ops()],
                               "idle_gaps": tr.traced.idle_gaps()}
    else:
        for m in spec.metrics("end_to_end", cell):
            value = win_lib.end_to_end(m["name"], loop.item, loop.rays, win, setup_s)
            if value is None:
                raise ValueError(f"{m['name']} is not a metric of a {loop.item} loop")
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    loop.release()
    numbers = loop.check()
    checked = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    for k, v in numbers.items():
        if k not in limits:
            notes.append(f"also read (no limit): {k} {v}")
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in checked.values())
    for k, c in checked.items():
        notes.append(f"checked {k} {c['value']} limit {c['limit']}")
    result["checked"] = checked
    refuse_forbidden()  # last: nothing after the window may have loaded them either
    return result
