"""The yardstick's arithmetic: the rays a frame counts, the card's peaks and
a kernel's least time, and the operations a distance-field march needs.

Frozen copies, at commit c4adc4a, of tpu_ray_torch/utils/metrics.py:44-57
(`rays_per_frame`, `mrays_per_sec`) and chip_smoke.py:272-276 and 348-407
(the peaks, `bound`, `MB_ITER_OPS`, `de_ops`, `StepWork`). `de_ops` reads
the benchmark's own scene (reference.render.Scene) in place of the
program's, and `StepWork` takes the points a step evaluates, as the
reference march hands them.
"""

from __future__ import annotations

import torch

# the published peaks of one H100 SXM at its 700 W limit: HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations of one live Mandelbulb iteration as the card's distance
# field runs it: the power-8 field's double-angle steps; the generic field's
# ~30 plus two atan2f (~20 each), four sinf / cosf (~15 each) and a powf (~25)
MB_ITER_OPS = {True: 62.0, False: 155.0}
# bytes of one ray a march reads (o, d) and writes (t, hit, steps, tmin)
MARCH_RAY_BYTES = 24 + 13
# bytes of one ray a mesh walk reads (o, d, t_init) and writes (t, tri, hit);
# and one Moller-Trumbore test, the least any ray needs
WALK_RAY_BYTES = 28 + 9
MT_OPS = 40.0


def rays_per_frame(cfg: dict, n_dir_lights: int) -> int:
    """Rays counted for Mrays/s: primary samples plus one shadow ray per
    directional light per sample. AO taps and shadow-march steps are
    distance evaluations, not rays."""
    primary = cfg["width"] * cfg["height"] * cfg["spp"]
    shadow = primary * n_dir_lights if cfg["shadow"] != "none" else 0
    return primary + shadow


def mrays_per_sec(n_rays: float, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def de_ops(scene, q) -> torch.Tensor:
    """The arithmetic operations one scene distance takes at each point (R,):
    a sphere 11, a plane 7, a box 26; a bulb 20 around its loop, 7 for each
    escape test its loop makes and MB_ITER_OPS more for each iteration it
    runs (the loop ends at the escape, as the point needs)."""
    ops = torch.full(q.shape[:1], 11.0 * scene.n("sdf.sph_center")
                     + 7.0 * scene.n("sdf.pln_normal") + 26.0 * scene.n("sdf.box_center"),
                     device=q.device)
    per_iter = MB_ITER_OPS[scene.mb_pow8]
    for c, s, pw in zip(scene["sdf.mb_center"], scene["sdf.mb_scale"], scene["sdf.mb_power"]):
        power = 8.0 if scene.mb_pow8 else float(pw)
        loc = (q - c) / s
        z = loc
        live = torch.ones_like(ops, dtype=torch.bool)
        ops += 20.0
        for _ in range(scene.mb_iters):
            r = z.norm(dim=-1)
            ops += 7.0 * live
            live = live & (r <= 4.0)
            ops += per_iter * live
            th = torch.atan2(torch.sqrt(z[:, 0] ** 2 + z[:, 1] ** 2), z[:, 2]) * power
            ph = torch.atan2(z[:, 1], z[:, 0]) * power
            zp = r.clamp(max=4.0)[:, None] ** power * torch.stack(
                [torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph), torch.cos(th)], -1)
            z = torch.where(live[:, None], zp + loc, z)
    return ops


class StepWork:
    """A march's `visit` hook: sums the operations of the distance
    evaluations the march takes plus `per_step` for each step's own
    arithmetic."""

    def __init__(self, scene, per_step: float):
        self.scene, self.per_step, self.ops, self.steps = scene, per_step, 0.0, 0

    def __call__(self, q):
        self.ops += float((de_ops(self.scene, q.float()) + self.per_step).sum())
        self.steps += int(q.shape[0])
