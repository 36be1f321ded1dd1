"""The two closed loops a traffic file can name (its "loop" key), each
driving the program's own entry point from the seed:

  frames  one forward frame after another through `render_image_jit`,
          under no_grad, the camera on a turntable about the y axis;
  fit     inverse-rendering steps through the step `fit.make_fit_step`
          returns, set up as `fit.fit` sets it up.

Each loop builds the program's scene from the benchmark's own arrays,
warms up (capturing its graphs), runs the calls of the window, traces one
call or a stated run of its consecutive blocks, and after the window
judges what the timed path produced against the plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time

import torch

from benchmark import profile, scenes, work
from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref


class Trace:
    """What a per-layer metric's reader reads: the traced window, the loop's
    item ("frame" or "fit"), the blocks it covered and their size in
    samples, the samples of its primary marches (xs, ys, in launch order)
    and the scene they were rendered at (the benchmark's own), the render
    settings, and the spans of the window ({name: [seconds, ...]})."""

    def __init__(self, traced, item, blocks, bs, cfg, scene, xs, ys, spans):
        self.traced, self.item, self.blocks, self.bs = traced, item, blocks, bs
        self.cfg, self.scene, self.xs, self.ys, self.spans = cfg, scene, xs, ys, spans


class Loop:
    """What both loops share: the scene's arrays and the reference's scene,
    the render settings, the device, the traced run of blocks."""

    item = ""

    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device):
        self.traffic, self.seed, self.device = traffic, int(seed), device
        self.cfg = scenes.render_settings(conf, traffic.get("render", {}))
        self.arrays, self.statics = scenes.scene_arrays(conf)
        self.ref_scene = ref.Scene(scenes.tensors(self.arrays, device), self.statics["mb_iters"],
                                   self.statics["mb_pow8"])
        ref.check_supported(self.cfg, self.ref_scene)
        self.rays = work.rays_per_frame(self.cfg, self.ref_scene.n("lights.direction"))
        self.spans = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def program_scene(self):
        from tpu_ray_torch.scene.convert import scene_from_numpy
        from tpu_ray_torch.utils.config import RenderConfig

        return (scene_from_numpy(self.arrays, self.statics, device=self.device),
                RenderConfig(**self.cfg))

    def blocks(self) -> tuple:
        """(blocks of a frame, samples a block) as the program splits it."""
        n = self.cfg["width"] * self.cfg["height"] * self.cfg["spp"]
        bs = self.cfg["block_size"]
        if not bs or bs >= n:
            return 1, n
        bs = -(-bs // self.cfg["spp"]) * self.cfg["spp"]
        return -(-n // bs), bs

    def slice_blocks(self) -> int:
        """Blocks the traced window covers when it is not the whole call: the
        march group in the middle of the frame."""
        n, _ = self.blocks()
        whole = self.traffic["trace"]["whole_up_to_blocks"]
        return 0 if n <= whole else self.traffic["trace"]["slice_blocks"]

    def frame_slice(self, scene, cfg):
        """The samples of the traced run of consecutive blocks -> (xs, ys)."""
        from tpu_ray_torch.render import render

        n_sl = self.slice_blocks()
        _, fx, fy, _ = render.frame_samples(scene, cfg)
        xs, ys, bs = render.whole_blocks(cfg, fx, fy)
        b0 = (xs.shape[0] // bs // 2) // n_sl * n_sl
        return xs[b0 * bs:(b0 + n_sl) * bs], ys[b0 * bs:(b0 + n_sl) * bs]

    def release_program(self):
        """Free the program's state: its objects here and its captured plans."""
        from tpu_ray_torch.render import graphs

        self.sync()
        for plan in graphs.PLANS.values():
            plan.reset()
        graphs.PLANS.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Frames(Loop):
    item = "frame"

    def __init__(self, *args):
        super().__init__(*args)
        poses = self.traffic["turntable_poses"]
        self.origins = torch.as_tensor(scenes.turntable(self.arrays["camera.origin"], poses),
                                       dtype=torch.float32, device=self.device)
        self.first = self.seed % poses
        g = scenes.generator(self.seed * 2 + 1, "cpu")
        n_px = self.cfg["width"] * self.cfg["height"]
        self.check_pix = torch.randperm(n_px, generator=g)[:self.traffic["check_pixels"]]
        self.check_pix = self.check_pix.to(self.device)
        self.kept = []

    def setup(self):
        self.scene, self.rcfg = self.program_scene()
        self.pose(-1)  # the warm-up: one frame, which captures the graphs
        self.sync()

    def origin(self, i: int) -> torch.Tensor:
        return self.origins[(self.first + i) % self.origins.shape[0]]

    def pose(self, i: int) -> torch.Tensor:
        from tpu_ray_torch.render.render import render_image_jit

        o = self.origin(i)
        scene = self.scene.replace(camera=dataclasses.replace(self.scene.camera, origin=o))
        with torch.no_grad():
            return render_image_jit(scene, self.rcfg)

    def call(self, i: int):
        img = self.pose(i)
        self.sync()
        return img

    def after(self, i: int, img):
        self.kept.append(img.reshape(-1, 3).index_select(0, self.check_pix).clone())

    def trace(self) -> Trace:
        from tpu_ray_torch.render import graphs, render

        n_sl = self.slice_blocks()
        o = self.origin(0)
        scene = self.scene.replace(camera=dataclasses.replace(self.scene.camera, origin=o))
        if n_sl:
            xs, ys = self.frame_slice(scene, self.rcfg)
            with torch.no_grad():
                traced = profile.trace(
                    lambda: graphs.render_pixels_flat_jit(scene, self.rcfg, xs, ys), self.device)
            blocks = n_sl
        else:
            traced = profile.trace(lambda: self.pose(0), self.device)
            _, fx, fy, _ = render.frame_samples(scene, self.rcfg)
            xs, ys, _ = render.whole_blocks(self.rcfg, fx, fy)
            blocks = self.blocks()[0]
        rs = self.ref_scene.replace({"camera.origin": o})
        return Trace(traced, self.item, blocks, self.blocks()[1], self.cfg, rs, xs, ys, self.spans)

    def release(self):
        self.scene = None
        self.release_program()

    def check(self) -> dict:
        """The reference's colours of the checked pixels of `check_frames`
        frames drawn from the seed among the window's, against the
        program's: the mean and the widest of each pixel's largest channel
        gap."""
        g = scenes.generator(self.seed * 2 + 2, "cpu")
        n = len(self.kept)
        picks = sorted(torch.randperm(n, generator=g)[:self.traffic["check_frames"]].tolist())
        gaps = []
        for i in picks:
            want = self.reference(self.origin(i))
            gaps.append((self.kept[i].double() - want.double()).abs().amax(1))
        gap = torch.cat(gaps)
        return {"px_mean_gap": float(gap.mean()), "px_max_gap": float(gap.max())}

    def reference(self, origin, dtype=torch.float32) -> torch.Tensor:
        """The reference's colours of the checked pixels at a camera origin."""
        scene = ref.Scene({k: (v.to(dtype) if v.is_floating_point() else v)
                           for k, v in self.ref_scene.replace({"camera.origin": origin}).a.items()},
                          self.statics["mb_iters"], self.statics["mb_pow8"])
        with torch.no_grad():
            return ref.render_pixels(scene, self.cfg, self.check_pix).float()


class Fit(Loop):
    item = "fit"

    def __init__(self, *args):
        from tpu_ray_torch.utils.config import FitConfig

        super().__init__(*args)
        self.trainables = [p for p in self.traffic["trainables"] if self.ref_scene[p].numel()]
        self.theta0 = scenes.perturbed({p: self.ref_scene[p] for p in self.trainables},
                                       self.traffic["perturb_sd"], self.seed, self.device)
        self.target = scenes.target_image(self.cfg, self.traffic["target"], self.seed, self.device)
        self.lr = FitConfig().learning_rate

    def setup(self):
        from tpu_ray_torch import fit

        self.scene, self.rcfg = self.program_scene()
        # as fit.fit sets the step up: the accel refit, and the grid dropped,
        # when the vertices train
        self.refit = any(p.split(".")[0] == "mesh" for p in self.trainables)
        if any(p.split(".")[0] in ("mesh", "poses") for p in self.trainables):
            self.scene = self.scene.replace(grid=None)
        self.params = fit.extract_params(self.scene, self.trainables)
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(self.theta0[k])
        self.optimizer = torch.optim.Adam(self.params.values(), lr=self.lr)
        self.step = fit.make_fit_step(self.scene, self.rcfg, self.target, self.params,
                                      self.optimizer, refit_accel=self.refit)
        # the warm-up: the first steps, through the window's own call (the
        # first captures); the reference follows them
        self.losses = [self.step()]
        b1 = self.optimizer.defaults["betas"][0]
        self.grad_norms = {k: float(self.optimizer.state[v]["exp_avg"].norm()) / (1 - b1)
                           for k, v in self.params.items()}
        self.states = []
        for _ in range(1, self.traffic["check_steps"]):
            self.states.append({k: v.detach().clone() for k, v in self.params.items()})
            self.losses.append(self.step())
        self.delta_norms = {k: float((v.detach() - self.theta0[k]).norm())
                            for k, v in self.params.items()}

    def call(self, i: int):
        return self.step()

    after = None

    def spans_on(self):
        """Spans around the step's forward (render_image_jit) and the rest up
        to Adam's step (the loss and its backward), each synchronized."""
        from tpu_ray_torch import fit

        spans = self.spans = {"forward": [], "backward": []}
        inner = fit.render_image_jit
        opt_step = self.optimizer.step
        marks = {}

        def forward(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            self.sync()
            marks["fwd_end"] = t1 = time.perf_counter()
            spans["forward"].append(t1 - t0)
            return out

        def step(*a, **kw):
            self.sync()
            spans["backward"].append(time.perf_counter() - marks["fwd_end"])
            return opt_step(*a, **kw)

        fit.render_image_jit = forward
        self.optimizer.step = step

        def off():
            fit.render_image_jit = inner
            del self.optimizer.step

        return off

    def trace(self) -> Trace:
        from tpu_ray_torch import fit
        from tpu_ray_torch.render import graphs

        n_sl = self.slice_blocks()
        if n_sl:
            s = fit._maybe_refit(fit.apply_params(self.scene, self.params), self.refit)
            xs, ys = self.frame_slice(s, self.rcfg)

            def fwd_bwd():
                px = graphs.render_pixels_flat_jit(s, self.rcfg, xs, ys)
                torch.mean((px - 0.5) ** 2).backward()

            traced = profile.trace(fwd_bwd, self.device)
            self.optimizer.zero_grad(set_to_none=True)
            blocks = n_sl
        else:
            traced = profile.trace(self.step, self.device)
            xs = ys = None
            blocks = self.blocks()[0]
        return Trace(traced, self.item, blocks, self.blocks()[1], self.cfg, self.ref_scene, xs,
                     ys, self.spans)

    def release(self):
        self.step = self.optimizer = self.params = self.scene = None
        self.release_program()

    def reference(self, dtype=torch.float32, keep=None) -> dict:
        """The reference's first steps from the same start -> their losses,
        the norms of the first gradient and of the change, by leaf, and the
        parameters before each later step (states)."""
        cast = (lambda v: v.to(dtype) if v.is_floating_point() else v)
        scene = ref.Scene({k: cast(v) for k, v in self.ref_scene.a.items()},
                          self.statics["mb_iters"], self.statics["mb_pow8"])
        out = ref_fit.fit_steps(scene, self.cfg, cast(self.target),
                                {k: cast(v) for k, v in self.theta0.items()}, self.lr,
                                self.traffic["check_steps"], keep=keep)
        return {"losses": out["losses"], "states": out["states"],
                "grad": {k: float(v.double().norm()) for k, v in out["grad"].items()},
                "delta": {k: float(v.double().norm()) for k, v in out["delta"].items()}}

    def losses_at(self, states: list) -> list:
        """The reference's float32 loss over the whole frame at each of the
        given parameters: what a later step has to read at the state the
        steps before it left."""
        return [ref_fit.frame_loss(self.ref_scene, self.cfg, self.target,
                                   {k: v.float() for k, v in s.items()}) for s in states]

    def check(self) -> dict:
        want = self.reference()
        want["later"] = self.losses_at(self.states)
        return fit_gaps({"losses": self.losses, "grad": self.grad_norms,
                         "delta": self.delta_norms}, want)


STEADY = 5.0
"""A leaf is steady while its reference gradient is under this many times
the median leaf's (mixed.fit, 20 seeds: the smooth leaves read 0.02-1.9
times it, the grazing-hit ones 22-4,300 times)."""


def fit_gaps(got: dict, want: dict) -> dict:
    """The numbers a fit's first steps are judged by: the relative gap of
    the first step's loss (loss_gap), and the largest of the later steps',
    each against the reference's loss at the parameters that got's own
    steps before it left (want["later"]: later_loss_gap, which sees a step
    that renders stale parameters); the gap between the norms of the first gradient, and
    of the change after the steps, by leaf, each over the reference's norm
    of that leaf or of the median leaf, whichever is larger, taken at the
    worst leaf (grad_gap, step_gap) and at the median leaf (grad_gap_median,
    step_gap_median), and at the worst of the steady leaves, those whose
    reference gradient is under STEADY times the median leaf's
    (grad_gap_steady, step_gap_steady): a leaf whose gradient a few grazing
    hits carry reads hundreds of times the others and is not reproducible
    in float32. The median leaf is the lower middle one. The change leaves
    out the leaves whose reference gradient is under a thousandth of the
    median leaf's: Adam moves them by round-off alone."""
    def gap(a, b, base):
        g = abs(a - b) / max(base, 1e-30)
        return g if math.isfinite(g) else math.inf

    losses = [gap(a, b, abs(b)) for a, b in zip(got["losses"], want["losses"])]
    med_g = statistics.median_low(want["grad"].values())
    counted = [k for k, v in want["grad"].items() if v >= 1e-3 * med_g]
    steady = {k for k, v in want["grad"].items() if v < STEADY * med_g}

    def leaves(kind, keys):
        med = statistics.median_low(want[kind][k] for k in keys)
        return {k: gap(got[kind][k], want[kind][k], max(want[kind][k], med)) for k in keys}

    grads, steps = leaves("grad", list(want["grad"])), leaves("delta", counted)
    later = [gap(a, b, abs(b)) for a, b in zip(got["losses"][1:], want["later"])]
    return {"loss_gap": losses[0], "later_loss_gap": max(later, default=0.0),
            "grad_gap": max(grads.values()),
            "grad_gap_median": statistics.median_low(grads.values()),
            "grad_gap_steady": max(v for k, v in grads.items() if k in steady),
            "step_gap": max(steps.values()),
            "step_gap_median": statistics.median_low(steps.values()),
            "step_gap_steady": max((v for k, v in steps.items() if k in steady), default=0.0)}


LOOPS = {"frames": Frames, "fit": Fit}
