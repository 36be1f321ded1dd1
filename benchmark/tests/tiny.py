"""A tiny copy of the benchmark for tests on the CPU, and a runner that
drives one run of it in a fresh interpreter, optionally with a fault
planted in the timed path:

    python -m benchmark.tests.tiny --root <dir> --workload <name> --seed <n>
        [--trace 1] [--fault <name>]

It skips the look for a card (the plain PyTorch versions run on the CPU)
and drives the rest of a run: set-up, the window, the traced window, the
comparison with the reference. It prints the result line last.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

REPO = Path(__file__).resolve().parents[2]
# every cell at a size the CPU renders in seconds; the knot keeps its shape
# with fewer segments
TINY_RENDER = {"width": 48, "height": 32, "spp": 4, "block_size": 512}
TINY_KNOT = {"p": 2, "q": 3, "seg_u": 40, "seg_v": 12}
TINY_TRAFFIC = {"check_pixels": 256, "trace": {"whole_up_to_blocks": 4, "slice_blocks": 2}}
# limits for the tiny cells: a sound run on the CPU reads ~0 in the frames'
# numbers and up to ~0.07 in step_gap (two steps on 6,144 samples)
TINY_LIMITS = {"frames": {"px_mean_gap": 1e-3, "px_max_gap": 0.05},
               "fit": {"loss_gap": 1e-3, "later_loss_gap": 1e-4, "grad_gap": 1e-3,
                       "step_gap": 0.3}}


def make_root(tmp: Path) -> Path:
    """A checkout's BENCHMARK.json and benchmark/ at tiny sizes under tmp."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        conf = json.loads(path.read_text())
        conf["render"].update(TINY_RENDER)
        for m in conf["meshes"]:
            if m["generator"] == "torus_knot":
                m["args"] = dict(TINY_KNOT)
        path.write_text(json.dumps(conf))
    for t in (root / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(t.read_text())
        traffic.update(TINY_TRAFFIC)
        t.write_text(json.dumps(traffic))
    for w in spec["workloads"]:
        loop = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        (root / "benchmark" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(TINY_LIMITS[loop["loop"]]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root: Path, workload: str, seed: int = 987654321987, trace: int = 0,
        fault: str | None = None, seconds: float = 0.1):
    """One tiny run in a fresh interpreter -> (returncode, result or None,
    standard error)."""
    cmd = [sys.executable, "-m", "benchmark.tests.tiny", "--root", str(root), "--workload",
           workload, "--seed", str(seed), "--trace", str(trace), "--seconds", str(seconds)]
    if fault:
        cmd += ["--fault", fault]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if p.returncode == 0 and lines else None), p.stderr


# ---------------------------------------------------------------------------
# faults planted in the timed path
# ---------------------------------------------------------------------------

def _stale_frames():
    """A frame returns its state unchanged: every frame after the first is
    the first frame's image."""
    from tpu_ray_torch.render import render

    inner, first = render.render_image_jit, []

    def stale(scene, cfg):
        img = inner(scene, cfg)
        if not first:
            first.append(img.clone())
        return first[0]

    render.render_image_jit = stale


def _half_samples():
    """Half of the batch left out, the mean taken over the rest: each
    pixel averages the first half of its samples."""
    from tpu_ray_torch.render import render

    def half_mean(cfg, colors):
        return colors.reshape(-1, cfg.spp, 3)[:, :max(1, cfg.spp // 2)].mean(1).T

    render._pixel_mean = half_mean


def _altered_answer():
    """An answer altered where it is produced: the top eighth of every
    frame brightened by 0.25."""
    from tpu_ray_torch.render import render

    inner = render.render_image_jit

    def altered(scene, cfg):
        img = inner(scene, cfg).clone()
        img[:max(1, cfg.height // 8)] += 0.25
        return img

    render.render_image_jit = altered


def _state_unchanged():
    """A step that returns its state unchanged: Adam's step keeps its
    moments and puts the parameters back as they were."""
    import torch

    inner = torch.optim.Adam.step

    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        inner(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)

    torch.optim.Adam.step = step


def _half_batch_loss():
    """Half of the batch left out, the mean taken over the rest: the loss
    sees every other pixel, each twice as heavy."""
    import torch

    from benchmark import scenes
    from tpu_ray_torch import fit

    made, inner_target, inner = [], scenes.target_image, fit.render_image_jit

    def target_image(*a):
        made.append(inner_target(*a))
        return made[-1]

    def half(scene, cfg):
        img = inner(scene, cfg)
        t = made[-1]
        keep = (torch.arange(img.shape[0] * img.shape[1]) % 2 == 0).reshape(img.shape[:2])
        return torch.where(keep[..., None], t + 2 ** 0.5 * (img - t), t)

    scenes.target_image = target_image
    fit.render_image_jit = half


def _stale_graph():
    """A step that renders the parameters of its capture: every later
    step's loss reads the first step's frame (its gradient still flows at
    the parameters of the step)."""
    from tpu_ray_torch import fit

    inner, first = fit.render_image_jit, []

    def stale(scene, cfg):
        img = inner(scene, cfg)
        if not first:
            first.append(img.detach().clone())
        return img + (first[0] - img).detach()

    fit.render_image_jit = stale


def _control():
    """The reference put in the program's place, in bfloat16: the frames'
    images and the fit's first steps come from the reference."""
    import torch

    from benchmark import loops

    def frames_setup(self):
        pass

    def frames_call(self, i):
        return self

    def frames_after(self, i, _):
        self.kept.append(self.reference(self.origin(i), torch.bfloat16))

    def fit_setup(self):
        got = self.reference(torch.bfloat16)
        self.losses, self.grad_norms, self.delta_norms = got["losses"], got["grad"], got["delta"]
        self.states = got["states"]

    loops.Frames.setup, loops.Frames.call, loops.Frames.after = (frames_setup, frames_call,
                                                                 frames_after)
    loops.Frames.release = loops.Fit.release = lambda self: None
    loops.Fit.setup, loops.Fit.call = fit_setup, lambda self, i: 0.0
    loops.Frames.trace = loops.Fit.trace = None


def _jax_after_window():
    """JAX loaded after the window has closed, as the check begins."""
    from benchmark import loops

    for cls in (loops.Frames, loops.Fit):
        inner = cls.check

        def check(self, inner=inner):
            __import__("jax")
            return inner(self)

        cls.check = check


FAULTS = {"stale_frames": _stale_frames, "half_samples": _half_samples,
          "altered_answer": _altered_answer, "state_unchanged": _state_unchanged,
          "half_batch_loss": _half_batch_loss, "stale_graph": _stale_graph, "control": _control,
          "jax_loaded": lambda: __import__("jax"), "jax_after_window": _jax_after_window}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    from benchmark import harness

    if args.fault:
        FAULTS[args.fault]()
    notes = []
    try:
        result = harness.run(harness.Spec(Path(args.root)), args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cpu"), T_START, notes)
    except RuntimeError as e:
        print("\n".join(notes + [str(e)]), file=sys.stderr)
        return 3
    print("\n".join(notes), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
