"""The float64 witness of the values-only reconstruct's normals and the
parity rule that reads it, shared by tests/test_torch_reconstruct.py (the
reconstruct kernel built as host C++) and chip_smoke.py (the kernel on the
card).

The kernel (csrc/reconstruct.cu) and its plain version
(plain.shadow_ray_origins_plain) give bit-equal hit points p. Their normals
n, and with them the ray-facing normal nf and the shadow origins
p_off = p + bias * nf, come from other op orders. The witness is the plain
normal in float64 at the same float32 hit point: the value both float32
versions approximate. A ray that hits the mesh keeps the plain normal as
its witness (both versions re-solve the same triangle).

The rule, per ray, on the largest component's difference from the plain
version: within 1e-5 on at least 99% of the rays, and within 1e-4 on every
ray that hits. A ray past either bound passes only where the witness sides
with the kernel, |kernel - witness| <= |plain - witness|: there the plain
version is the one that left float64. Each hit ray over 1e-4 is named with
its three distances, and the plain version's own distance from float64 is
counted: its ill-conditioned rays.
"""

from __future__ import annotations

import torch

from tpu_ray_torch.core.math3d import dot
from tpu_ray_torch.kernels.sphere_trace import surface_normal
from tpu_ray_torch.render.chain import frame_chain
from tpu_ray_torch.sdf.primitives import sdf_distance


def witness(scene, cfg, o, d, hits, closer, method: str) -> dict:
    """{n, nf, p_off}: the plain version's outputs in float64 at its float32
    hit points (hits: its (t, hit, p, n, mat, cov); closer: its mixed
    closest-select mask, else None)."""
    hit, p, n = hits[1], hits[2], hits[3].double()
    if frame_chain(scene, cfg, method).use_sdf:
        sdf64 = scene.sdf.with_float_leaves(
            [x.double() if x.is_floating_point() else x for x in scene.sdf.float_leaves()])
        with torch.no_grad():
            ns = surface_normal(sdf_distance, sdf64, p.double())
        n = ns if closer is None else torch.where(closer[:, None], ns, n)
    nf = torch.where(dot(n, d.double())[..., None] > 0.0, -n, n)
    p_off = p.double() + cfg.shadow_bias * nf
    if cfg.soft_silhouette <= 0.0:
        p_off = torch.where(hit[:, None], p_off, o.double())
    return {"n": n, "nf": nf, "p_off": p_off}


def judge(got, want, wit, hit) -> dict:
    """The rule on one (R, 3) output: got the kernel's, want the plain
    version's, wit the witness; hit the rays that hit. -> {ok, share (of
    the rays within 1e-5 or sided with the kernel), within (within 1e-5
    alone), max_err, over (the hit rays over 1e-4: (ray, |kernel - plain|,
    |kernel - witness|, |plain - witness|)), bad (those of them the witness
    does not side with), ill_5 / ill_4 (rays whose plain output leaves the
    witness by over 1e-5 / hit rays by over 1e-4), kernel_f64 / plain_f64
    (the largest distance of each from the witness)}."""
    g, w = got.double(), want.double()
    err = (g - w).abs().amax(1)
    kw = (g - wit).abs().amax(1)
    pw = (w - wit).abs().amax(1)
    sided = kw <= pw
    over = torch.nonzero(hit & (err > 1e-4)).flatten()
    rows = list(zip(over.tolist(), err[over].tolist(), kw[over].tolist(), pw[over].tolist()))
    bad = [r for r in rows if r[2] > r[3]]
    share = float(((err <= 1e-5) | sided).double().mean())
    return dict(ok=not bad and share >= 0.99, share=share,
                within=float((err <= 1e-5).double().mean()), max_err=float(err.max()),
                over=rows, bad=bad, ill_5=int((pw > 1e-5).sum()),
                ill_4=int((hit & (pw > 1e-4)).sum()), kernel_f64=float(kw.max()),
                plain_f64=float(pw.max()), rays=err.numel())


def describe(name: str, j: dict) -> str:
    """One line of judge's result."""
    def rays(rows):
        return "; ".join(f"ray {i}: {a:.3e} / {b:.3e} / {c:.3e}" for i, a, b, c in rows[:8])

    return (f"{name}: max |kernel - plain| {j['max_err']:.3e}; within 1e-5 {j['within']:.5f}, "
            f"or sided with the kernel {j['share']:.5f}; hit rays over 1e-4: "
            f"{len(j['over'])} (|kernel - plain| / |kernel - f64| / |plain - f64|: "
            f"{rays(j['over'])}), not sided with the kernel: {len(j['bad'])} "
            f"({rays(j['bad'])}); plain over 1e-5 from f64 on {j['ill_5']} of {j['rays']} "
            f"rays, over 1e-4 on {j['ill_4']} hit rays; largest from f64: kernel "
            f"{j['kernel_f64']:.3e}, plain {j['plain_f64']:.3e}")
