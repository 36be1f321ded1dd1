"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each with its seconds (any failure exits non-zero and prints no
result):
  1. device: a CUDA device must exist; its name and nvidia-smi power limit.
  2. build: the kernels from tpu_ray_torch/csrc with nvcc (sm_90a), one
     nvcc per source in parallel; ptxas' registers and spills.
  3. kernel parity on real rays: 4 blocks of the `mixed` frame in Morton
     order (those holding the bulb, the sphere, the knot and the ground in
     front) and the shadow rays the geometry pass makes from them; each
     kernel against its plain PyTorch version on the card, with times. The
     shade backward on the same rays and their residuals, with a seeded
     cotangent: per parameter group, per ray, and bit equality of two runs;
     again without shadows, which block every lane of the bulb's block.
  4. small frame: `mixed` at 320x180, 1 spp, kernel path against plain path:
     the image, and the gradient of mean(img**2) for the six trainables.
  5. the forward slice: `render_image` of `mixed` at 1920x1080, 16 spp,
     with every forward kernel's launch count over that one frame; the PNG
     goes to build/.
  6. the fit step: forward + backward of mean(img**2) at 1920x1080, 16 spp,
     for the six trainables: time, launch counts, peak memory, gradients.
  7. a fit: `fit()` for 3 Adam steps at 480x272, 16 spp, toward the CLI
     demo target, with the packet accel refit every step; the loss falls.
Then the kernels as one JSON line, the card's name and power limit, and
the result as the last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = "tpu_ray_torch/csrc"
REPLACES = {
    "march": "tpu_ray/kernels/pallas_sdf.py:223",
    "shadow_hard": "tpu_ray/kernels/pallas_sdf.py:328",
    "packet_closest": "tpu_ray/kernels/pallas_mt.py:347",
    "packet_any_hit": "tpu_ray/kernels/pallas_mt.py:347",
    "shade_bwd": "tpu_ray/kernels/pallas_shade.py:591",
}
SOURCES = {"march": "sdf_march.cu", "shadow_hard": "sdf_march.cu",
           "packet_closest": "packet_mt.cu", "packet_any_hit": "packet_mt.cu",
           "shade_bwd": "shade_bwd.cu"}
# the six trainables of the reference's backward bench (tpu_ray/bench_lib.py)
TRAINABLES = ("sdf.sph_radius", "sdf.mb_scale", "camera.origin",
              "materials.albedo", "lights.color", "mesh.verts")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device time of a kernel wrapper over reps calls, after a warm-up.

    A spin kernel queued first keeps the device busy while the host
    enqueues the calls, so CUDA events time the device work and not the
    wrapper's host overhead, which exceeds a fast kernel's run time."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~60 ms at 1.7 GHz, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    """Host time of one call to a plain PyTorch version after a warm-up, with
    the device drained before and after: what the frame would pay for it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def frac_equal(a, b) -> float:
    return (a == b).float().mean().item()


def cosine(a, b) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def rel_max(a, b) -> float:
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) if b.numel() else 0.0


def reset(*tables) -> None:
    for table in tables:
        for k in table:
            table[k] = 0


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


# world points whose blocks the parity phase takes: the bulb, the sphere and
# the knot (their centres) and the ground in front of them
PARITY_POINTS = ((1.4, 1.05, 0.0), (0.0, 0.55, -1.6), (-1.3, 0.82, 0.0), (0.0, 0.0, 2.0))


def parity_blocks(scene, cfg, perm) -> list:
    """Indices of the 4 blocks (in the frame's Morton block order) whose
    pixels hold the PARITY_POINTS: every kernel then sees hits and misses."""
    from tpu_ray_torch.core.math3d import dot

    cam = scene.camera
    fwd, right, up = cam.basis()
    half_h = torch.tan(torch.deg2rad(cam.vfov_deg) * 0.5)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    blocks = []
    for pt in PARITY_POINTS:
        v = torch.tensor(pt, device=cam.origin.device) - cam.origin
        z = dot(v, fwd)
        x = (dot(v, right) / z / (half_h * cfg.width / cfg.height) + 1) * 0.5 * cfg.width
        y = (1 - dot(v, up) / z / half_h) * 0.5 * cfg.height
        q = int(y.clamp(0, cfg.height - 1)) * cfg.width + int(x.clamp(0, cfg.width - 1))
        b = int(inv[q]) * cfg.spp // cfg.block_size
        while b in blocks:
            b += 1
        blocks.append(b)
    return blocks


def kernel_parity(scene, cfg, results):
    """Phase 3: each kernel against its plain version on 4 blocks of the
    frame's primary rays (parity_blocks) and the shadow rays the geometry
    pass makes from them."""
    from tpu_ray_torch.core.math3d import normalize
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf
    from tpu_ray_torch.render import render as R
    from tpu_ray_torch.render.camera import generate_rays

    dev = scene.device
    sx, sy = R.pixel_sample_coords(cfg, dev)
    perm = R._block_order_perm(cfg).to(dev)
    fx = sx.reshape(-1, cfg.spp)[perm].reshape(-1)
    fy = sy.reshape(-1, cfg.spp)[perm].reshape(-1)
    blocks = parity_blocks(scene, cfg, perm)
    idx = torch.cat([torch.arange(b * cfg.block_size, (b + 1) * cfg.block_size, device=dev)
                     for b in blocks])
    o, d = generate_rays(scene.camera, fx[idx], fy[idx], cfg.width, cfg.height)
    n = o.shape[0]
    log("parity", f"blocks {blocks} of {-(-fx.shape[0] // cfg.block_size)} "
        f"({cfg.block_size} rays each, Morton order)")
    sdf, packet = scene.sdf, scene.packet

    # A: primary march
    kw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far)
    tk, hk, _, mk = cuda_sdf.march(sdf, o, d, **kw)
    tp, hp, _, mp = cuda_sdf.march_torch(sdf, o, d, **kw)
    both = hk & hp
    rel_t = ((tk - tp).abs() / tp.abs().clamp_min(1e-30))[both]
    rel_m = ((mk - mp).abs() / mp.abs().clamp_min(1e-30))[both]
    agree = frac_equal(hk, hp)
    bad_t = int((rel_t > 1e-5).sum() + (rel_m > 1e-5).sum())
    err = _max((tk - tp).abs()[both])
    log("parity", f"march: {n} rays, hit agreement {agree:.6f} ({int((hk != hp).sum())} "
        f"mismatches), hit rate {hk.float().mean().item():.4f}, worst |dt| {err:.3e}, "
        f"worst rel dt {_max(rel_t):.3e}, worst rel dtmin {_max(rel_m):.3e}, "
        f"{bad_t} over rtol 1e-5")
    check(agree >= 0.999 and bad_t == 0, "march parity")
    results["march"] = dict(max_abs_err=err,
                            ms=kernel_ms(lambda: cuda_sdf.march(sdf, o, d, **kw)),
                            plain_ms=wall_ms(lambda: cuda_sdf.march_torch(sdf, o, d, **kw)))

    # C closest: seeded with the SDF hit t
    seed = torch.where(hk, tk, torch.full_like(tk, cfg.t_far))
    ck = cuda_mt.intersect_packet(packet, o, d, t_max=cfg.t_far, t_init=seed)
    cp = cuda_mt.intersect_packet_torch(packet, o, d, t_max=cfg.t_far, t_init=seed)
    agree = frac_equal(ck.hit, cp.hit)
    both = ck.hit & cp.hit
    dt = (ck.t - cp.t).abs()[both]
    rel = dt / cp.t[both]
    # a different triangle is a tie only where the two t's are equal to rtol
    tri_bad = int(((ck.tri != cp.tri)[both] & (rel > 1e-6)).sum())
    err = _max(dt)
    log("parity", f"packet closest: hit agreement {agree:.6f} ({int((ck.hit != cp.hit).sum())} "
        f"mismatches), hit rate {ck.hit.float().mean().item():.4f}, worst |dt| {err:.3e}, "
        f"worst rel dt {_max(rel):.3e}, tri mismatches off "
        f"ties {tri_bad}, tri mismatches {int((ck.tri != cp.tri)[both].sum())}")
    check(agree >= 0.9999 and bool((rel <= 1e-5).all()) and tri_bad == 0,
          "packet closest parity")
    results["packet_closest"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: cuda_mt.intersect_packet(packet, o, d, t_max=cfg.t_far,
                                                      t_init=seed)),
        plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_torch(
            packet, o, d, t_max=cfg.t_far, t_init=seed)))

    # the geometry pass's shadow rays for the one directional light
    res = {"sdf_t": tk, "sdf_hit": hk, "sdf_tmin": mk, "mesh_tri": ck.tri,
           "mesh_hit": ck.hit}
    with torch.no_grad():
        _, p_off, live = R.shadow_ray_origins(scene, cfg, o, d, res, "mixed",
                                              mesh_rows=R.mesh_table(scene.mesh))
    l_dir = normalize(scene.lights.direction[0]).expand_as(p_off).contiguous()
    t_far_rays = torch.where(live, cfg.t_far, 0.0).to(torch.float32)

    # B: hard SDF shadow
    skw = dict(eps=cfg.eps, t_far=cfg.t_far, steps=cfg.shadow_steps,
               bias=cfg.shadow_bias, t_far_rays=t_far_rays)
    vk, _ = cuda_sdf.shadow_hard(sdf, p_off, l_dir, **skw)
    vp, _ = cuda_sdf.shadow_hard_torch(sdf, p_off, l_dir, **skw)
    agree = frac_equal(vk, vp)
    err = float((vk - vp).abs().max())
    log("parity", f"shadow hard: vis agreement {agree:.6f} ({int((vk != vp).sum())} "
        f"mismatches), blocked {(vk == 0).float().mean().item():.4f}, worst |dvis| {err:.1f}")
    check(agree >= 0.999, "shadow parity")
    results["shadow_hard"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: cuda_sdf.shadow_hard(sdf, p_off, l_dir, **skw)),
        plain_ms=wall_ms(lambda: cuda_sdf.shadow_hard_torch(sdf, p_off, l_dir, **skw)))

    # C any-hit: 0-seeds for lanes the SDF already blocked and for misses
    dead = (vk <= 0.0) | ~live
    aseed = torch.where(dead, 0.0, cfg.t_far).to(torch.float32)
    ak = cuda_mt.intersect_packet(packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True,
                                  t_init=aseed)
    ap = cuda_mt.intersect_packet_torch(packet, p_off, l_dir, t_max=cfg.t_far,
                                        any_hit=True, t_init=aseed)
    agree = frac_equal(ak.hit, ap.hit)
    err = float((ak.hit.float() - ap.hit.float()).abs().max())
    log("parity", f"packet any-hit: agreement {agree:.6f} ({int((ak.hit != ap.hit).sum())} "
        f"mismatches), blocked {ak.hit.float().mean().item():.4f}, live {(~dead).sum().item()}")
    check(agree >= 0.9999, "packet any-hit parity")
    results["packet_any_hit"] = dict(
        max_abs_err=err,
        ms=kernel_ms(lambda: cuda_mt.intersect_packet(packet, p_off, l_dir, t_max=cfg.t_far,
                                                      any_hit=True, t_init=aseed)),
        plain_ms=wall_ms(lambda: cuda_mt.intersect_packet_torch(
            packet, p_off, l_dir, t_max=cfg.t_far, any_hit=True, t_init=aseed)))
    for name, r in results.items():
        log("parity", f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    return o, d


def shade_bwd_parity(scene, cfg, o, d, results=None):
    """Phase 3, shade backward: the kernel against shade_bwd_torch on the
    parity rays, their geometry residuals and a cotangent uniform in
    [-1, 1] from a seeded generator on the card. With results, also the
    kernel's and the plain version's times."""
    from tpu_ray_torch.kernels import cuda_shade
    from tpu_ray_torch.render import render as R

    tag = f"shade_bwd shadow={cfg.shadow}"
    rows = R.mesh_table(scene.mesh)
    with torch.no_grad():
        res = R.geometry_residuals(scene, cfg, o, d, "mixed", mesh_rows=rows)
    corners = rows[res["mesh_tri"].clamp(0, rows.shape[0] - 1).long()][:, :9].contiguous()
    aux = cuda_shade._make_aux(scene, cfg, "mixed", o, d, res, rows)
    gen = torch.Generator(device=o.device).manual_seed(0)
    ct = torch.rand(o.shape, generator=gen, device=o.device) * 2.0 - 1.0
    args = (scene, cfg, o, d, res)

    def kernel():
        return cuda_shade.shade_bwd(*args, aux, corners, ct, "mixed")

    def plain():
        return cuda_shade.shade_bwd_torch(*args, corners, ct, "mixed")

    k1, k2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    hit = res["sdf_hit"] | res["mesh_hit"]
    sdf_sel = res["sdf_hit"] & aux["closer"]
    lit = res["sh_vis"][0] > 0 if "sh_vis" in res else torch.ones_like(hit)
    log(tag, f"{o.shape[0]} rays: hit {hit.float().mean().item():.4f}, SDF hit selected "
        f"{sdf_sel.float().mean().item():.4f} (lit {(sdf_sel & lit).float().mean().item():.4f}), "
        f"mesh hit selected {(hit & ~sdf_sel).float().mean().item():.4f}")
    smooth = ("materials.albedo", "lights.color", "lights.ambient", "bg_top", "bg_bottom",
              "sdf.sph_center", "sdf.sph_radius")
    chaotic = ("sdf.mb_center", "sdf.mb_scale", "lights.direction")
    ok, worst = True, 0.0
    for path in smooth + chaotic:
        a, b = k1[path], ref[path]
        rel, cos = rel_max(a, b), cosine(a, b)
        zero = not bool(a.any()) and not bool(b.any())  # no lane reaches it
        good = rel < 1e-4 if path in smooth else (zero or (cos > 0.999 and rel < 5e-2))
        ok &= good
        worst = max(worst, float((a - b).abs().max()))
        log(tag, f"{path}: rel {rel:.3e}, cosine {cos:.9f}, |plain| {float(b.norm()):.4e}"
            f"{', both exactly 0' if zero else ''} ({'ok' if good else 'FAIL'}, "
            f"{'rel < 1e-4' if path in smooth else 'cos > 0.999, rel < 5e-2'})")
    for key in ("o", "d", "corners"):
        a, b = k1[key], ref[key]
        nz = b.norm(dim=1) > 0
        per = (a - b).norm(dim=1)[nz] / b.norm(dim=1)[nz]
        p99 = float(torch.quantile(per.double(), 0.99)) if per.numel() else 0.0
        cos = cosine(a, b)
        good = p99 < 1e-3 and cos > 0.999
        ok &= good
        worst = max(worst, float((a - b).abs().max()))
        log(tag, f"d_{key}: {int(nz.sum())} nonzero rays, per-ray rel p50 "
            f"{float(per.median()) if per.numel() else 0.0:.3e} p99 {p99:.3e} max "
            f"{_max(per):.3e}, over 1e-3 {int((per > 1e-3).sum())}, cosine {cos:.9f} "
            f"({'ok' if good else 'FAIL'})")
    same = all(torch.equal(k1[p], k2[p]) for p in cuda_shade.SHADE_PATHS)
    same_rays = all(torch.equal(k1[k], k2[k]) for k in ("o", "d", "corners"))
    log(tag, f"two kernel runs: parameter cotangents bit-identical {same}, "
        f"per-ray bit-identical {same_rays}")
    check(ok, f"{tag} parity")
    check(same, f"{tag}: parameter cotangents differ between two runs")
    if results is not None:
        results["shade_bwd"] = dict(max_abs_err=worst, ms=kernel_ms(kernel),
                                    plain_ms=wall_ms(plain))
        log(tag, f"kernel {results['shade_bwd']['ms']:.3f} ms, plain "
            f"{results['shade_bwd']['plain_ms']:.3f} ms")


def parity(scene, cfg, results):
    """Phase 3: the forward kernels, then the shade backward on the same
    rays, with the frame's hard shadows and (so that the lit Mandelbulb's
    Hessian chain runs: hard shadows block the bulb's lanes) without."""
    o, d = kernel_parity(scene, cfg, results)
    shade_bwd_parity(scene, cfg, o, d, results)
    shade_bwd_parity(scene, cfg.replace(shadow="none"), o, d)


def plain_paths():
    """Every kernel wrapper patched with its plain PyTorch version."""
    from contextlib import ExitStack

    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf, cuda_shade

    def shade_bwd_plain(scene, cfg, o, d, res, aux, corners, ct, method):
        return cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(cuda_sdf, "march", cuda_sdf.march_torch))
    stack.enter_context(mock.patch.object(cuda_sdf, "shadow_hard", cuda_sdf.shadow_hard_torch))
    stack.enter_context(mock.patch.object(cuda_mt, "intersect_packet",
                                          cuda_mt.intersect_packet_torch))
    stack.enter_context(mock.patch.object(cuda_shade, "shade_bwd", shade_bwd_plain))
    return stack


def grads_of(scene, cfg, paths=TRAINABLES):
    """(loss, {path: gradient}) of mean(render_image**2)."""
    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_image

    params = extract_params(scene, paths)
    loss = torch.mean(render_image(apply_params(scene, params), cfg) ** 2)
    loss.backward()
    return loss.detach(), {p: v.grad for p, v in params.items()}


def small_frame(scene, cfg):
    """Phase 4: 320x180 x 1 spp, kernel path against plain path on the card:
    the image, then the gradient of mean(img**2) for the six trainables."""
    from tpu_ray_torch.render.render import render_image

    small = cfg.replace(width=320, height=180, spp=1)
    with torch.no_grad():
        img_k = render_image(scene, small)
        with plain_paths():
            img_p = render_image(scene, small)
    err = (img_k - img_p).abs().amax(-1)
    p95 = float(torch.quantile(err.flatten(), 0.95))
    log("small", f"mixed 320x180x1: kernel vs plain path p95 {p95:.3e}, max "
        f"{float(err.max()):.3e}, mean {float((img_k - img_p).abs().mean()):.3e}, "
        f"pixels over 1e-3: {int((err > 1e-3).sum())} of {err.numel()}")
    check(bool(torch.isfinite(img_k).all()) and p95 < 1e-3, "small-frame parity")

    loss_k, g_k = grads_of(scene, small)
    _, g_k2 = grads_of(scene, small)
    same = {p: torch.equal(g_k[p], g_k2[p]) for p in TRAINABLES}
    log("small", f"two kernel-path passes, gradients bit-identical: {same}")
    with plain_paths():
        loss_p, g_p = grads_of(scene, small)
    ok = True
    for path in TRAINABLES:
        cos = cosine(g_k[path], g_p[path])
        ok &= cos > 0.999 and bool(torch.isfinite(g_k[path]).all())
        log("small", f"grad {path}: cosine {cos:.9f}, rel {rel_max(g_k[path], g_p[path]):.3e}, "
            f"|kernel| {float(g_k[path].norm()):.4e}, |plain| {float(g_p[path].norm()):.4e}")
    log("small", f"loss kernel {float(loss_k):.8f}, plain {float(loss_p):.8f}")
    check(ok, "small-frame gradient cosine > 0.999")


def forward_counts():
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf

    return {"march": cuda_sdf.LAUNCHES["march"], "shadow_hard": cuda_sdf.LAUNCHES["shadow"],
            "packet_closest": cuda_mt.LAUNCHES["closest"],
            "packet_any_hit": cuda_mt.LAUNCHES["any_hit"]}


def full_frame(scene, cfg, smi: str):
    """Phase 5: the whole frame through the kernels -> launch counts."""
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.utils.image_io import write_png

    with torch.no_grad():
        render_image(scene, cfg.replace(width=320, height=180))  # warm-up
        reset(cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_image(scene, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = forward_counts()
    check(tuple(img.shape) == (cfg.height, cfg.width, 3), f"frame shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "frame not finite")
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    png = os.path.join(REPO, "build", "chip_smoke_mixed.png")
    write_png(png, img.cpu().numpy())
    log("frame", f"mixed {cfg.width}x{cfg.height}x{cfg.spp}: {dt:.3f} s, "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s, mean {float(img.mean()):.4f}, "
        f"launches {counts}, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {smi}; wrote {png}")
    return counts


def profile_step(scene, cfg):
    """A fit step over a small frame under torch.profiler: the device's busy
    share of the wall time and where the device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads_of(scene, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels' own events (the CPU ops that launched them carry the same
    # device time again)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    n_blocks = -(-cfg.num_rays // cfg.block_size)
    log("fit_step", f"profile of a {cfg.width}x{cfg.height}x{cfg.spp} fit step ({n_blocks} "
        f"blocks): wall {wall * 1e3:.1f} ms, device {dev_us / 1e3:.1f} ms, busy "
        f"{dev_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log("fit_step", f"  device {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")


def fit_step(scene, cfg, smi: str):
    """Phase 6: one forward + backward of mean(img**2) over the full frame
    for the six trainables -> the shade backward's launch count."""
    from tpu_ray_torch.kernels import cuda_mt, cuda_sdf, cuda_shade

    from tpu_ray_torch.fit import apply_params, extract_params
    from tpu_ray_torch.render.render import render_image

    grads_of(scene, cfg.replace(width=320, height=180))  # warm-up
    reset(cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = extract_params(scene, TRAINABLES)
    loss = torch.mean(render_image(apply_params(scene, params), cfg) ** 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = {p: v.grad for p, v in params.items()}
    dt = t2 - t0
    counts = dict(forward_counts(), shade_bwd=cuda_shade.LAUNCHES["shade_bwd"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("fit_step", f"mixed {cfg.width}x{cfg.height}x{cfg.spp} forward + backward: {dt:.3f} s "
        f"(forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s), "
        f"{cfg.num_rays / dt / 1e6:.3f} Mrays/s, loss {float(loss.detach()):.8f}, "
        f"launches {counts}, peak mem {peak:.2f} GiB on {smi}")
    for path, g in grads.items():
        fin = bool(torch.isfinite(g).all())
        log("fit_step", f"grad {path}: norm {float(g.norm()):.6e}, finite {fin}, "
            f"nonzero {int((g != 0).sum())} of {g.numel()}")
        check(fin and bool((g != 0).any()), f"gradient of {path} not finite and nonzero")
    check(all(v > 0 for v in counts.values()), f"a kernel never launched: {counts}")
    # after the timed step: the profiler slows the launches that follow it
    profile_step(scene, cfg.replace(width=256, height=128))
    return counts


def fit_run(scene, cfg):
    """Phase 7: fit() for 3 Adam steps toward the CLI demo target."""
    from tpu_ray_torch.cli import demo_target
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.utils.config import FitConfig

    trainable = ("sdf.sph_radius", "materials.albedo", "lights.color", "mesh.verts")
    small = cfg.replace(width=480, height=272)
    target = demo_target(scene, small, trainable)
    t0 = time.perf_counter()
    _, history = fit(scene, small, target, trainable,
                     FitConfig(steps=3, learning_rate=1e-2), verbose=False)
    torch.cuda.synchronize()
    log("fit", f"mixed 480x272x16, {list(trainable)}, Adam lr 1e-2, accel refit "
        f"every step: loss history {[f'{v:.8f}' for v in history]} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(len(history) == 3 and all(map(torch.isfinite, torch.tensor(history)))
          and history[-1] < history[0], "the fit's loss did not fall")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "script runs only on a CUDA device")
    sys.path.insert(0, REPO)
    from tpu_ray_torch.kernels import build
    from tpu_ray_torch.scene.scenes import build_scene

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build.kernel_lib()
    regs = [ln.strip() for ln in build.BUILD_LOG["ptxas"].splitlines()
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    log("build", f"{time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_LOG['seconds']:.2f} s, "
        f"built={build.BUILD_LOG['built']}) -> {build.BUILD_LOG['path']}")
    for ln in regs:
        log("build", ln)

    dev = torch.device("cuda", 0)
    scene, cfg = build_scene("mixed", device=dev)
    results = {}
    phases = (("parity", lambda: parity(scene, cfg, results)),
              ("small", lambda: small_frame(scene, cfg)),
              ("frame", lambda: full_frame(scene, cfg, smi)),
              ("fit_step", lambda: fit_step(scene, cfg, smi)),
              ("fit", lambda: fit_run(scene, cfg)))
    out = {}
    for phase, run in phases:
        t0 = time.perf_counter()
        out[phase] = run()
        log(phase, f"phase seconds {time.perf_counter() - t0:.2f}")
    counts = dict(out["frame"], shade_bwd=out["fit_step"]["shade_bwd"])

    kernels = []
    for key, src in SOURCES.items():
        r = results[key]
        kernels.append({"name": key, "route": "cuda", "source": f"{SRC}/{src}",
                        "replaces": REPLACES[key], "launches": counts[key],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
