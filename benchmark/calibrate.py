"""The readings that the limits of `correct` are set from, for one cell:

    python -m benchmark.calibrate --workload <name> --seeds <n> [<n> ...]
        [--control] [--faults] [--witness] [--out <file.jsonl>]

For each seed, in one process (the graphs are captured once):

  program     the program's numbers, as a run computes them, without the
              measured window: a frames cell renders its check_frames
              frames through render_image_jit, a fit cell takes its first
              steps (set-up); both are judged against the reference;
  control     (--control) the reference put in the program's place and
              computed in bfloat16, the precision below the float32 that
              the configuration states, judged the same way;
  half_batch  (--faults, fit cells) the reference put in the program's
              place with half of the frame's pixels (every other one) left
              out of the loss, the mean taken over the rest;
  stale_graph (--faults, fit cells) the program's own readings with each
              later step's loss taken at the start, as a step that renders
              the parameters of its capture would read (no run of its own);
  float64     (--witness, fit cells) the reference in float64, against
              which both the float32 reference and the program are read.

A state left unchanged reads 1 in step_gap and step_gap_steady by their
definition and needs no run. One JSON line a seed, on standard output and,
with --out, appended to the file. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import harness
from benchmark.loops import LOOPS, fit_gaps


def readings(spec, cell: str, seed: int, control: bool, faults: bool, witness: bool,
             device) -> dict:
    w = spec.workload(cell)
    traffic = spec.traffic(w["traffic"])
    loop = LOOPS[traffic["loop"]](spec.config(w["config"]), traffic, seed, device)
    rec = {"workload": cell, "seed": seed}
    t0 = time.perf_counter()
    loop.setup()
    if loop.item == "frame":
        for i in range(traffic["check_frames"]):
            loop.after(i, loop.call(i))
    loop.release()
    if loop.item == "frame":
        rec["program"] = loop.check()
        if control:
            loop.kept = [loop.reference(loop.origin(i), torch.bfloat16)
                         for i in range(traffic["check_frames"])]
            rec["control"] = loop.check()
    else:
        want = loop.reference()
        want["later"] = loop.losses_at(loop.states)
        got = {"losses": loop.losses, "grad": loop.grad_norms, "delta": loop.delta_norms}
        rec["program"] = fit_gaps(got, want)
        rec["norms"] = {"program": got, "reference": without_states(want)}

        def judged(other):
            # `other` in the program's place: its later steps are read at
            # the states its own steps left
            return fit_gaps(other, dict(want, later=loop.losses_at(other["states"])))

        if control:
            low = loop.reference(torch.bfloat16)
            rec["norms"]["control"] = without_states(low)
            rec["control"] = judged(low)
        if witness:
            wide = loop.reference(torch.float64)
            wide["later"] = [float(v) for v in wide["losses"][1:]]
            rec["float64"] = {"reference": without_states(wide),
                              "float32_reference": fit_gaps(want, wide),
                              "program": fit_gaps(got, wide)}
        if faults:
            n_px = loop.cfg["width"] * loop.cfg["height"]
            keep = torch.arange(0, n_px, 2, device=device)
            half = loop.reference(keep=keep)
            rec["norms"]["half_batch"] = without_states(half)
            rec["half_batch"] = judged(half)
            rec["stale_graph"] = fit_gaps(dict(got, losses=[got["losses"][0]] * len(got["losses"])),
                                          want)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def without_states(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "states"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.calibrate", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(Path.cwd())
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for seed in args.seeds:
        rec = readings(spec, args.workload, seed, args.control, args.faults, args.witness,
                       torch.device("cuda", 0))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
