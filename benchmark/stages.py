"""What the program records of itself, read for the per-layer metrics:

  * the device time of its stages: the program launches an empty marker
    kernel, `trace_stage_<stage>`, where a stage begins, captured into its
    CUDA graphs (tpu_ray_torch/utils/metrics.py, csrc/trace_stage.cu), so
    a traced window's device operations after a marker and before the next
    one are that stage's;
  * its graphs' counters (tpu_ray_torch.render.graphs.counters): replays,
    the host ns inside their launches, captures and the seconds of the
    warm-ups and captures, by graph kind, over the whole process.

A program without them gives nothing to read: every function here then
returns None.
"""

from __future__ import annotations

PREFIX = "trace_stage_"


def stage_seconds(traced):
    """{stage: device seconds} of a traced window (profile.Traced), each
    operation under the last marker before it on the device, the markers'
    own time under "(markers)"; None without a marker. A stage's name is
    its marker's suffix (`vjp_backward` for the program's `vjp.backward`)."""
    out, current = {}, None
    for name, _, dur in sorted(traced.device, key=lambda op: op[1]):
        if name.startswith(PREFIX):
            current = name[len(PREFIX):]
            out.setdefault(current, 0.0)
            out["(markers)"] = out.get("(markers)", 0.0) + dur / 1e9
        elif current is not None:
            out[current] += dur / 1e9
    return out or None


def stage_ms_a_block(trace, stage: str, item: str):
    """The device ms a block of `stage` in a traced window of a loop of
    `item`s, or None (another item, no marker, or no such stage)."""
    if trace.item != item:
        return None
    stages = stage_seconds(trace.traced) or {}
    if stage not in stages:
        return None
    return 1e3 * stages[stage] / trace.blocks


def counters():
    """The program's graph counters ({kind: {replays, launch_ns, captures,
    prepare_s}}), or None where the program keeps none or captured nothing
    (the CPU)."""
    from tpu_ray_torch.render import graphs

    read = getattr(graphs, "counters", None)
    if read is None:
        return None
    counts = {k: dict(v) for k, v in read().items()}
    if not sum(v.get("captures", 0) for v in counts.values()):
        return None
    return counts


def launch_ms_a_block(trace, item: str):
    """Host ms inside the graphs' launches (every kind) over the block
    graph's replays, over the whole run, or None."""
    counts = counters() if trace.item == item else None
    if counts is None or not counts.get("block", {}).get("replays"):
        return None
    return sum(v["launch_ns"] for v in counts.values()) / 1e6 / counts["block"]["replays"]
