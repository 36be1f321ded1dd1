"""SDF march and shadow marches: CUDA kernels and their plain versions.

Counterpart of `tpu_ray/kernels/pallas_sdf.py` (`march_pallas`,
`shadow_pallas` in hard and soft mode). Kernels: `csrc/sdf_march.cu` over
the device distance field `csrc/sdf.cuh`.

Dispatch follows the device: `march` / `shadow_hard` / `shadow_soft` run
`march_torch` / `shadow_hard_torch` / `shadow_soft_torch` on CPU tensors and
launch the kernel on CUDA tensors, raising on what the kernel does not take
(non-float32 or non-contiguous input, an input that requires grad). The
kernels come in two builds, for the power-8 Mandelbulb field and for the
generic-power one (`SdfScene.mb_pow8`); the wrappers pass the flag. Each
kernel launch adds one to `LAUNCHES`. The three marches take an optional
`counters` tensor (int64, len(SHADOW_COUNTERS), on the rays' device) to
which a launch adds what its march did; the main path passes none. They
also take `packed=` (`pack`): the scene's parameters packed once for many
launches, where a call without it packs them itself.

The plain versions take an optional `visit(points, active)`, called once per
march step with the step's sample points (R, 3) and the lanes that evaluate
the distance field there: a way to count the work a march needs.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_ray_torch.kernels.build import (check_counters, check_cuda_inputs, check_launch,
                                         kernel_lib)
from tpu_ray_torch.sdf.primitives import SdfScene, sdf_bounding_spheres, sdf_distance

LAUNCHES = {"march": 0, "shadow_hard": 0, "shadow_soft": 0}
# the marches' optional counters (csrc/sdf_march.cu `ShadowCounter`): rays
# whose cutoff lets them march (the primary march: that reach a bound), rays
# left after the bound cull (that take a step), their DE steps (sum, max),
# the DE steps the warps issue (lane efficiency is steps over 32 of them),
# and a warp's clock64() cycles (sum, max) over the warps
SHADOW_COUNTERS = ("live", "marching", "steps", "steps_max", "warp_steps", "warp_cycles",
                   "warp_cycles_max", "warps")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's parity reference)
# ---------------------------------------------------------------------------

def _bound_terms(bounds, o, d, inflate: float):
    """Per-ray, per-bound (b, disc) of the ray/sphere quadratic: (R, K) each."""
    ox, oy, oz = o[:, None, 0], o[:, None, 1], o[:, None, 2]
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    r = bounds[:, 3] + inflate
    ocx, ocy, ocz = ox - bounds[:, 0], oy - bounds[:, 1], oz - bounds[:, 2]
    b = ocx * dx + ocy * dy + ocz * dz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    return b, b * b - c2


def march_torch(sdf: SdfScene, o, d, *, t0: float, max_steps: int, eps: float,
                t_far: float, bound_pad: float = 0.0, visit=None):
    """Sphere trace (R,3),(R,3) -> (t, hit, steps, tmin), the kernel's rule:
    `t += DE` until DE < eps, t >= t_far or max_steps; rays that miss every
    bounding sphere, its radius grown by bound_pad, start at t_far (tmin
    stays t0). A ray that misses the grown spheres stays bound_pad away from
    every primitive."""
    R = o.shape[0]
    t = torch.full((R,), float(t0), dtype=o.dtype, device=o.device)
    tmin = t.clone()
    bounds = sdf_bounding_spheres(sdf)
    if bounds is not None:
        b, disc = _bound_terms(bounds, o, d, bound_pad)
        reach = ((disc >= 0.0) & (torch.sqrt(torch.clamp_min(disc, 0.0)) - b > 0.0)).any(1)
        t = torch.where(reach, t, torch.full_like(t, t_far))
    hit = torch.zeros((R,), dtype=torch.bool, device=o.device)
    steps = torch.zeros((R,), dtype=torch.int32, device=o.device)
    dmin = torch.full((R,), 1e10, dtype=o.dtype, device=o.device)
    for _ in range(max_steps):
        active = (~hit) & (t < t_far)
        if not bool(active.any()):
            break  # nothing changes once every ray is done
        q = o + t[:, None] * d
        if visit is not None:
            visit(q, active)
        dist = sdf_distance(sdf, q)
        closer = active & (dist < dmin)
        dmin = torch.where(closer, dist, dmin)
        tmin = torch.where(closer, t, tmin)
        hit_now = active & (dist < eps)
        hit = hit | hit_now
        t = torch.where(active & (~hit_now), t + dist, t)
        steps = steps + active.to(torch.int32)
    return t, hit, steps, tmin


def shadow_hard_torch(sdf: SdfScene, p, l_dir, *, eps: float, t_far: float,
                      steps: int, bias: float, t_far_rays=None, visit=None):
    """0/1 visibility marching from p toward l_dir -> (vis, ts), both (R,).

    The step is max(DE, eps/2); a ray is blocked at DE < eps. Without planes
    the march is clamped at the last exit from the bounding spheres inflated
    by eps (0 for a ray that misses them all). t_far_rays: optional per-ray
    cutoff. ts is the bias (hard visibility has no penumbra argmin)."""
    R = p.shape[0]
    tf = (torch.full((R,), float(t_far), dtype=p.dtype, device=p.device)
          if t_far_rays is None else t_far_rays)
    bounds = sdf_bounding_spheres(sdf)
    if bounds is not None:
        b, disc = _bound_terms(bounds, p, l_dir, eps)
        texit = torch.sqrt(torch.clamp_min(disc, 0.0)) - b
        t_cut = torch.where(disc >= 0.0, texit, torch.zeros_like(texit))
        t_cut = torch.clamp_min(t_cut.amax(1), 0.0)
        tf = torch.minimum(tf, t_cut)
    t = torch.full((R,), float(bias), dtype=p.dtype, device=p.device)
    blocked = torch.zeros((R,), dtype=torch.bool, device=p.device)
    for _ in range(steps):
        active = (~blocked) & (t < tf)
        if not bool(active.any()):
            break
        q = p + t[:, None] * l_dir
        if visit is not None:
            visit(q, active)
        dd = sdf_distance(sdf, q)
        blocked = blocked | (active & (dd < eps))
        t = torch.where(active, t + torch.clamp_min(dd, eps * 0.5), t)
    vis = 1.0 - blocked.to(p.dtype)
    return vis, torch.full_like(vis, float(bias))


def shadow_soft_torch(sdf: SdfScene, p, l_dir, *, eps: float, t_far: float,
                      steps: int, bias: float, soft_k: float, t_far_rays=None,
                      visit=None):
    """Penumbra visibility marching from p toward l_dir -> (vis, ts), both (R,).

    The classic distance-field soft shadow: s = min over the march of
    soft_k * DE / max(t, bias), starting at 1; the step is DE clipped to
    [eps/2, 0.4]; no bound clamp (the penumbra darkens rays that pass near a
    primitive without entering its bound). vis = clip(s, 0, 1); ts is the t
    of the first step that attained the min (bias when none went below 1),
    so clip(soft_k * DE(p + ts l) / max(ts, bias), 0, 1) recomputes vis from
    one DE. t_far_rays: optional per-ray cutoff."""
    R = p.shape[0]
    tf = (torch.full((R,), float(t_far), dtype=p.dtype, device=p.device)
          if t_far_rays is None else t_far_rays)
    t = torch.full((R,), float(bias), dtype=p.dtype, device=p.device)
    s = torch.ones_like(t)
    ts = t.clone()
    for _ in range(steps):
        active = t < tf
        if not bool(active.any()):
            break  # nothing changes once every ray is past its cutoff
        q = p + t[:, None] * l_dir
        if visit is not None:
            visit(q, active)
        dd = sdf_distance(sdf, q)
        s_new = soft_k * dd / torch.clamp_min(t, bias)
        better = active & (s_new < s)
        ts = torch.where(better, t, ts)
        s = torch.where(better, s_new, s)
        t = torch.where(active, t + torch.clamp(dd, eps * 0.5, 0.4), t)
    return torch.clamp(s, 0.0, 1.0), ts


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def pack_sdf(sdf: SdfScene) -> torch.Tensor:
    """The kernels' packed float32 parameter block (layout in csrc/sdf.cuh)."""
    parts = [
        torch.cat([sdf.sph_center, sdf.sph_radius[:, None]], 1),
        torch.cat([sdf.pln_normal, sdf.pln_offset[:, None]], 1),
        torch.cat([sdf.box_center, sdf.box_half, sdf.box_round[:, None]], 1),
        torch.cat([sdf.mb_center, sdf.mb_scale[:, None], sdf.mb_power[:, None]], 1),
    ]
    return torch.cat([q.reshape(-1) for q in parts]).to(torch.float32).contiguous()


def pack_mats(sdf: SdfScene) -> torch.Tensor:
    """The primitives' material ids in pack_sdf's order (int32)."""
    return torch.cat([sdf.sph_mat, sdf.pln_mat, sdf.box_mat, sdf.mb_mat]).to(
        torch.int32).contiguous()


def field_flag(sdf: SdfScene) -> int:
    """The kernels' mb_pow8 argument: 1 runs the power-8 build (also for a
    scene without a bulb, which either build marches alike), 0 the
    generic-power field."""
    return int(bool(sdf.mb_pow8) or sdf.mb_center.shape[0] == 0)


@dataclasses.dataclass(frozen=True)
class Packed:
    """The scene's parameters as the kernels take them, packed once for
    many launches (render_pixels_flat packs them once a frame or fit step,
    under no_grad, and hands them to every wrapper as `packed=`): the SDF
    block of pack_sdf and its counts, the bounding spheres, the primary
    march's bounds grown by bound_pad, the primitives' material ids in the
    block's order (int32, what the reconstruct kernel reads), and the shade
    kernels' block (cuda_shade.pack_small), or None."""
    params: torch.Tensor
    counts: tuple
    bounds: torch.Tensor | None
    march_bounds: torch.Tensor | None
    bound_pad: float
    mats: torch.Tensor
    small: torch.Tensor | None = None


def _counts(sdf: SdfScene) -> tuple:
    return (sdf.sph_center.shape[0], sdf.pln_normal.shape[0], sdf.box_center.shape[0],
            sdf.mb_center.shape[0], int(sdf.mb_iters), field_flag(sdf))


def _grown(bounds, pad: float):
    """The bounding spheres with their radii grown by pad."""
    if bounds is None or not pad:
        return bounds
    return torch.cat([bounds[:, :3], bounds[:, 3:] + pad], 1).contiguous()


@torch.no_grad()
def pack(sdf: SdfScene, bound_pad: float = 0.0) -> Packed:
    """The SDF's kernel arguments, packed once (see Packed; no shade block)."""
    bounds = sdf_bounding_spheres(sdf)
    if bounds is not None:
        bounds = bounds.to(torch.float32).contiguous()
    return Packed(pack_sdf(sdf), _counts(sdf), bounds, _grown(bounds, bound_pad),
                  float(bound_pad), pack_mats(sdf))


def _sdf_args(sdf: SdfScene, packed: Packed | None = None):
    """(params, counts, bounds): from packed, or packed for this call."""
    if packed is None:
        packed = pack(sdf)
    return packed.params, packed.counts, packed.bounds


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def march(sdf: SdfScene, o, d, *, t0: float, max_steps: int, eps: float,
          t_far: float, bound_pad: float = 0.0, counters=None, packed: Packed | None = None):
    """Primary sphere trace -> (t, hit, steps, tmin); see march_torch.
    counters: as the shadow marches' (SHADOW_COUNTERS; live counts the rays
    that reach a bound, marching those that take a step). packed: pack(sdf,
    bound_pad), the same arguments packed once for many launches."""
    if o.device.type == "cpu":
        return march_torch(sdf, o, d, t0=t0, max_steps=max_steps, eps=eps,
                           t_far=t_far, bound_pad=bound_pad)
    if packed is None:
        packed = pack(sdf, bound_pad)
    elif packed.bound_pad != float(bound_pad):
        raise ValueError(f"march: packed for bound_pad {packed.bound_pad}, called with "
                         f"{bound_pad}")
    params, counts, bounds = packed.params, packed.counts, packed.march_bounds
    check_cuda_inputs("march", o, d, params, bounds)
    check_counters("march", counters, o.device, SHADOW_COUNTERS)
    R = o.shape[0]
    dev = o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    steps = torch.empty(R, dtype=torch.int32, device=dev)
    tmin = torch.empty(R, dtype=torch.float32, device=dev)
    lib = kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.tr_march(
            o.data_ptr(), d.data_ptr(), R, params.data_ptr(), *counts,
            _ptr(bounds), 0 if bounds is None else bounds.shape[0],
            float(t0), int(max_steps), float(eps), float(t_far),
            t.data_ptr(), hit.data_ptr(), steps.data_ptr(), tmin.data_ptr(),
            _ptr(counters), _stream(dev))
    check_launch("march", rc)
    LAUNCHES["march"] += 1
    return t, hit, steps, tmin


def shadow_hard(sdf: SdfScene, p, l_dir, *, eps: float, t_far: float,
                steps: int, bias: float, t_far_rays=None, counters=None,
                packed: Packed | None = None):
    """Hard-shadow visibility -> (vis, ts); see shadow_hard_torch. packed:
    see march."""
    if p.device.type == "cpu":
        return shadow_hard_torch(sdf, p, l_dir, eps=eps, t_far=t_far,
                                 steps=steps, bias=bias, t_far_rays=t_far_rays)
    params, counts, bounds = _sdf_args(sdf, packed)
    check_cuda_inputs("shadow_hard", p, l_dir, t_far_rays, params, bounds)
    check_counters("shadow_hard", counters, p.device, SHADOW_COUNTERS)
    R = p.shape[0]
    dev = p.device
    vis = torch.empty(R, dtype=torch.float32, device=dev)
    ts = torch.empty(R, dtype=torch.float32, device=dev)
    lib = kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.tr_shadow_hard(
            p.data_ptr(), l_dir.data_ptr(), _ptr(t_far_rays), R,
            params.data_ptr(), *counts,
            _ptr(bounds), 0 if bounds is None else bounds.shape[0],
            float(eps), float(t_far), int(steps), float(bias),
            vis.data_ptr(), ts.data_ptr(), _ptr(counters), _stream(dev))
    check_launch("shadow_hard", rc)
    LAUNCHES["shadow_hard"] += 1
    return vis, ts


def shadow_soft(sdf: SdfScene, p, l_dir, *, eps: float, t_far: float,
                steps: int, bias: float, soft_k: float, t_far_rays=None, counters=None,
                packed: Packed | None = None):
    """Soft-shadow visibility and its argmin t -> (vis, ts); see
    shadow_soft_torch. packed: see march."""
    if p.device.type == "cpu":
        return shadow_soft_torch(sdf, p, l_dir, eps=eps, t_far=t_far, steps=steps,
                                 bias=bias, soft_k=soft_k, t_far_rays=t_far_rays)
    params, counts, _ = _sdf_args(sdf, packed)
    check_cuda_inputs("shadow_soft", p, l_dir, t_far_rays, params)
    check_counters("shadow_soft", counters, p.device, SHADOW_COUNTERS)
    R = p.shape[0]
    dev = p.device
    vis = torch.empty(R, dtype=torch.float32, device=dev)
    ts = torch.empty(R, dtype=torch.float32, device=dev)
    lib = kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.tr_shadow_soft(
            p.data_ptr(), l_dir.data_ptr(), _ptr(t_far_rays), R,
            params.data_ptr(), *counts, float(eps), float(t_far), int(steps),
            float(bias), float(soft_k), vis.data_ptr(), ts.data_ptr(),
            _ptr(counters), _stream(dev))
    check_launch("shadow_soft", rc)
    LAUNCHES["shadow_soft"] += 1
    return vis, ts
