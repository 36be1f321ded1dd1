"""Run one cell of the benchmark once, on the CUDA device:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets the cell up (scene, accel, the warm-up
that captures the program's graphs), measures a closed loop of calls for at
least --seconds, reads the per-layer metrics from a traced window with
--trace 1, judges the window's output against the plain reference, and
prints the result as one JSON line, last on standard output; the numbers
it judged, each beside its limit, are the last lines on standard error.
It stops with an error and prints no result without a CUDA device, or when
the port loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.Spec(Path.cwd())
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark.run: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import tpu_ray_torch  # noqa: F401  the program under test: absent, the run stops here

    notes = []
    try:
        result = harness.run(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START, notes)
    except RuntimeError as e:
        print("\n".join(notes + [f"benchmark.run: {e}"]), file=sys.stderr)
        return 3
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
