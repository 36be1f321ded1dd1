"""kernels.march_roofline_pct: 100 x the least time of the traced window's
primary marches (#1 `march_kernel`) over their device time. The least time
is the larger of their bytes over the HBM rate (each ray's o, d in and t,
hit, steps, tmin out) and their operations over the float32 rate: the
distance evaluations that the reference's march takes on the same rays,
counted by `work.de_ops`, plus 8 a step. Counts describe the work, not the
kernel that does it."""

from benchmark import work
from benchmark.reference import render as ref

CHUNK = 1 << 22


def read(trace):
    if trace.item != "frame" or trace.xs is None:
        return None
    launches, seconds = trace.traced.kernel_time("march_kernel")
    if not launches or seconds <= 0:
        return None
    cfg, scene = trace.cfg, trace.scene
    counter = work.StepWork(scene, 8.0)
    for s in range(0, trace.xs.shape[0], CHUNK):
        o, d = ref.generate_rays(scene, trace.xs[s:s + CHUNK], trace.ys[s:s + CHUNK],
                                 cfg["width"], cfg["height"])
        ref.march(scene, o, d, max_steps=cfg["max_steps"], eps=cfg["eps"], t_far=cfg["t_far"],
                  bound_pad=cfg["eps"], visit=counter)
    n_bytes = trace.xs.shape[0] * work.MARCH_RAY_BYTES
    return 100.0 * work.bound_s(n_bytes, counter.ops) / seconds
