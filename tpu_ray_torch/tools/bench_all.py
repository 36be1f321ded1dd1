"""Every BASELINE row through the port's bench, into one JSON (counterpart
of `tools/bench_all.py`).

    python -m tpu_ray_torch.tools.bench_all [out.json] [--device cpu]

Rows, in the reference's order: the five BASELINE configs (`sphere`,
`triangles`, `bunny`, `mandelbulb`, `mixed`), and `mandelbulb` again with
diff_vis=True, the backward through the soft-shadow penumbra, before
`mixed`. Each is `bench.run_bench(scene, backward=True, ...)` at the
scene's own config and carries its `device` and `power_limit`. One summary
line a row in the reference's format, then `{"rows": [...]}` into out.json
(default build/bench_all.json) and as the last line.
"""

from __future__ import annotations

import json
import os
import sys

from tpu_ray_torch.bench import require_device, run_bench
from tpu_ray_torch.tools import card, card_line, emit, parser

ROWS = (("sphere", {}), ("triangles", {}), ("bunny", {}), ("mandelbulb", {}),
        ("mandelbulb", {"diff_vis": True}), ("mixed", {}))
DEFAULT_OUT = os.path.join("build", "bench_all.json")


def main(out_path: str = DEFAULT_OUT, device="cuda", rows=ROWS) -> dict:
    """Bench `rows` ((scene, run_bench keywords), ...) on the device, write
    {"rows": [...]} to out_path -> that dict."""
    device = require_device(device, "tpu_ray_torch.tools.bench_all")
    print(f"[bench_all] {card_line(card(device))}", flush=True)
    out = []
    for scene, kw in rows:
        r = run_bench(scene, backward=True, **kw, device=device)
        tag = f"{scene}{'+diff_vis' if kw.get('diff_vis') else ''}"
        print(f"{tag:<22} fwd {r['fwd_seconds']:8.4f}s ({r['value']:6.2f} "
              f"Mrays/s)  fwd+bwd {r.get('fwdbwd_seconds', 0):8.4f}s "
              f"({r.get('mrays_fwdbwd', 0):6.2f})", flush=True)
        out.append(r)
    result = {"rows": out}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out_path}", flush=True)
    emit(result)
    return result


def cli(argv=None):
    ap = parser("bench_all", __doc__)
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    main(args.out, args.device)


if __name__ == "__main__":
    sys.exit(cli())
