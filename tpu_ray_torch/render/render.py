"""The render core: ray generation -> geometry pass -> reconstruct -> shade ->
spp mean, over blocks of samples in Morton 8x8 pixel order.

Counterpart of `tpu_ray/render/render.py`. What a frame traces and shades
is its chain (render/chain.py), built from the scene, the config and the
method. The geometry pass (`geometry_residuals`) runs under
`torch.no_grad()` and goes through the kernel wrappers: the primary SDF
march (`cuda_sdf.march`), the mesh closest hit seeded with the SDF hit t,
the mesh any-hit for shadow rays and the mesh term of the AO taps
(`cuda_mt.intersect_packet_parts` over the accel's parts, or
`dist.scene_shard.intersect_ring_packet` over the ring's shards when the
scene is partitioned across processes), the values-only reconstruct of the
hits and the shadow rays' origins (`cuda_reconstruct.reconstruct`), and
the hard or soft SDF shadow march (`cuda_sdf.shadow_hard`;
`cuda_sdf.shadow_soft` through `shading.sdf_soft_shadow_argmin`). It emits
compact per-ray residuals, from which the shade rebuilds the hit state
(render/plain.py) and shades with the static shadow visibility or, with
`diff_vis` soft shadows, the penumbra recomputed from one DE at the march's
argmin t, and the 5-tap distance-field AO.

On a CUDA device the reconstruct of a block is one launch of the
reconstruct kernel, and the shade of a block one launch of the fused
forward kernel (`cuda_shade.shade_fwd`), with or without a gradient; on
the CPU they are their plain versions (`plain.shadow_ray_origins_plain`,
`plain.shade_plain`). The primary march runs once per group of
`MARCH_GROUP` blocks (`march_group`), and the kernels' scene parameters are
packed once per `render_pixels_flat` call (`cuda_shade.pack`). Gradients:
ray generation runs inside autograd, so the camera gets its gradient; the
shade of a block is one `cuda_shade.ShadeFn`, whose backward is the fused
shade-backward kernel on a CUDA device. Object poses (`scene.poses`) fold
into world-space vertices once per frame, at `render_image`'s entry.
`frame_stats` gives the per-frame ray statistics of the reference's
overlay from the same geometry pass.

`render_image_jit` is the reference's jitted frame: the same blocks
(`render_block`, `march_group`) captured once as CUDA graphs and replayed
over the frame (render/graphs.py); the bench, the fit step and the CLI
render through it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ray_torch.core.math3d import dot, normalize
from tpu_ray_torch.dist.scene_shard import intersect_ring_packet
from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_scatter, cuda_sdf, cuda_shade
from tpu_ray_torch.kernels import moller_trumbore as mt
from tpu_ray_torch.render import plain, shading
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.render.chain import Chain, check_supported, frame_chain, resolve_method
from tpu_ray_torch.scene.transform import realize_scene
from tpu_ray_torch.scene.types import Scene
from tpu_ray_torch.utils import prng
from tpu_ray_torch.utils.config import RenderConfig
from tpu_ray_torch.utils.metrics import span, stage

# with soft silhouettes the march also takes the rays that pass within this
# many silhouette widths of a primitive's bounding sphere: their closest
# approach sets their coverage. A ray that stays farther away has coverage
# below sigmoid(-24) = 4e-11, under float32's resolution of the blend.
SIL_REACH = 24.0
# blocks whose primary rays render_pixels_flat marches in one launch: on
# `mixed`, the smallest group within 10% of the best device time a ray over
# the whole frame in groups of 1, 4, 16 and 32 blocks (chip_smoke.py phase
# `launch`, an H100 80GB HBM3 at 700 W: 0.237, 0.128 and 0.107 ns a ray at
# 4, 16 and 32 blocks; `mandelbulb` 2.16, 1.06, 0.642 and 0.585 at 1 to 32)
MARCH_GROUP = 32
# values of the jitter draw computed at a time: its int64 temporaries stay
# ~0.2 GiB whatever the frame (1920x1080x16 draws 66M)
JITTER_CHUNK = 1 << 22


def _bound_pad(cfg: RenderConfig) -> float:
    """The primary march's bound-cull padding: cfg.eps, because the exact
    distance of a sphere or a box falls below the march's eps up to eps
    outside its bounding sphere (the march hits there), plus SIL_REACH
    widths with soft silhouettes."""
    return cfg.eps + SIL_REACH * max(cfg.soft_silhouette, 0.0)


# ---------------------------------------------------------------------------
# Sampling: deterministic stratified grid, Morton 8x8 pixel order
# ---------------------------------------------------------------------------

def sample_offsets(cfg: RenderConfig, device="cpu", dtype=torch.float32):
    """(spp, 2) stratified subpixel offsets: cell centers of a k x k grid."""
    k = cfg.spp_side
    centers = (torch.arange(k, dtype=dtype, device=device) + 0.5) / k
    ox, oy = torch.meshgrid(centers, centers, indexing="xy")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def pixel_sample_coords(cfg: RenderConfig, device="cpu", dtype=torch.float32):
    """Sample positions for every (pixel, sample): two (H, W, spp) tensors.

    Stratified cell centers by default; with cfg.jitter_seed each sample is
    jittered uniformly inside its stratum by the reference's draw,
    jax.random.uniform(PRNGKey(seed), (H, W, spp, 2), dtype), bit for bit
    (utils.prng), computed JITTER_CHUNK values at a time."""
    xs = torch.arange(cfg.width, dtype=dtype, device=device)
    ys = torch.arange(cfg.height, dtype=dtype, device=device)
    px, py = torch.meshgrid(xs, ys, indexing="xy")  # (H, W)
    if cfg.jitter_seed is None:
        off = sample_offsets(cfg, device, dtype)
        return px[..., None] + off[:, 0], py[..., None] + off[:, 1]
    k = cfg.spp_side
    cell = torch.arange(cfg.spp, device=device)
    cx, cy = (cell % k).to(dtype), (cell // k).to(dtype)
    sx = torch.empty((cfg.height, cfg.width, cfg.spp), dtype=dtype, device=device)
    sy = torch.empty_like(sx)
    row = cfg.width * cfg.spp * 2  # values of the draw a row of pixels
    rows = max(1, JITTER_CHUNK // row)
    for r0 in range(0, cfg.height, rows):
        r1 = min(cfg.height, r0 + rows)
        u = prng.uniform(cfg.jitter_seed, r0 * row, (r1 - r0) * row, dtype, device)
        u = u.reshape(r1 - r0, cfg.width, cfg.spp, 2)
        sx[r0:r1] = px[r0:r1, :, None] + (cx + u[..., 0]) / k
        sy[r0:r1] = py[r0:r1, :, None] + (cy + u[..., 1]) / k
    return sx, sy


def _block_order_perm(cfg: RenderConfig):
    """Pixel permutation (int64 tensor on the CPU): row-major -> 8x8 blocks in
    Morton order over the block grid; None unless both sides divide by 8.

    Consecutive samples then cover compact square regions, so a warp's rays,
    and a block's, walk the same part of the accel."""
    if cfg.height % 8 or cfg.width % 8:
        return None
    hb, wb = cfg.height // 8, cfg.width // 8
    by, bx = np.meshgrid(np.arange(hb), np.arange(wb), indexing="ij")

    def spread(v):  # interleave bits: 16-bit coord -> even bit positions
        v = v.astype(np.uint64)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    morton = (spread(by) << np.uint64(1)) | spread(bx)
    border = np.argsort(morton.ravel(), kind="stable")  # block visit order
    idx = np.arange(cfg.height * cfg.width).reshape(cfg.height, cfg.width)
    blocks = idx.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3).reshape(hb * wb, 64)
    return torch.from_numpy(blocks[border].reshape(-1))


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


# ---------------------------------------------------------------------------
# Geometry pass (no gradient, kernel-backed) and the shade's route
# ---------------------------------------------------------------------------

def _mesh_intersect(scene: Scene, cfg: RenderConfig, chain: Chain, o, d, t_init=None):
    """Mesh closest hit -> (tri, hit). t_init: per-ray best-t seed (the SDF hit
    t in mixed scenes: a mesh hit behind it loses the closest-select). The
    ring's shards (which, as the reference's, take no seed) come first, then
    the accel parts; primary rays share the camera origin, so the supers are
    visited front to back from o[0]."""
    if scene.ring is not None:
        res = intersect_ring_packet(scene.ring, o, d, t_max=cfg.t_far, sort_origin=o[0])
    elif chain.packet:
        res = cuda_mt.intersect_packet_parts(scene.packet, o, d, t_max=cfg.t_far,
                                             sort_origin=o[0], t_init=t_init)
    else:
        res = mt.intersect_brute(scene.mesh, o, d, t_max=cfg.t_far)
    return res.tri, res.hit


def _mesh_any_hit(scene: Scene, chain: Chain, p, d, t_max, sort, t_init=None):
    """Mesh occlusion of shadow rays. `d` may be unnormalized (point lights
    pass the segment to the light with t_max = 1). sort: ("dir", v) visits
    the supers by ascending projection on v (a directional light), or
    ("origin", pt) by distance from pt (a point light). t_init: 0 for rays
    whose shadow is already decided, which skips their work (not on the
    ring, as in the reference)."""
    kind, v = sort
    kw = {"sort_dir": v} if kind == "dir" else {"sort_origin": v}
    if scene.ring is not None:
        return intersect_ring_packet(scene.ring, p, d, t_max=t_max, any_hit=True, **kw).hit
    if chain.packet:
        return cuda_mt.intersect_packet_parts(scene.packet, p, d, t_max=t_max, any_hit=True,
                                              t_init=t_init, **kw).hit
    return mt.any_hit_brute(scene.mesh, p, d, t_max=t_max)


def _mesh_closest_t(scene: Scene, chain: Chain, o, d, t_max: float):
    """Closest mesh hit distance along per-ray dirs within t_max (BIG on a
    miss): the mesh term of the AO taps (plain.make_ao), with no sort hint."""
    if scene.ring is not None:
        return intersect_ring_packet(scene.ring, o, d, t_max=t_max).t
    if chain.ao_packet:
        return cuda_mt.intersect_packet_parts(scene.packet, o, d, t_max=t_max).t
    res = mt.intersect_brute(scene.mesh, o, d, t_max=t_max)
    return torch.where(res.hit, res.t, torch.full_like(res.t, mt.BIG))


@torch.no_grad()
def march_group(scene: Scene, cfg: RenderConfig, xs, ys, packed=None, block: int = 0):
    """The primary march of a group of blocks' samples in one launch ->
    (t, hit, steps, tmin) over the group. Its rays are generate_rays' of
    the group's samples, made `block` samples at a time (all at once for
    0) into one buffer: generate_rays is elementwise, so they are bit for
    bit each block's own, and its temporaries stay a block's."""
    with stage("march", xs.device):
        o = torch.empty((xs.shape[0], 3), dtype=xs.dtype, device=xs.device)
        d = torch.empty_like(o)
        step = block or xs.shape[0]
        for s in range(0, xs.shape[0], step):
            o[s:s + step], d[s:s + step] = generate_rays(scene.camera, xs[s:s + step],
                                                         ys[s:s + step], cfg.width, cfg.height)
        return cuda_sdf.march(scene.sdf, o, d, t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps,
                              t_far=cfg.t_far, bound_pad=_bound_pad(cfg), packed=packed)


@torch.no_grad()
def geometry_residuals(scene: Scene, cfg: RenderConfig, o, d, method: str,
                       mesh_rows=None, march=None, packed=None) -> dict:
    """The geometry pass -> dict of per-ray residuals (march: this block's
    slice of march_group's result, which the pass then takes in place of
    its own march; packed: the kernels' parameters packed once,
    cuda_shade.pack):

      sdf_t, sdf_hit, sdf_tmin   primary march (when the SDF is traced)
      mesh_tri, mesh_hit         mesh closest hit (when the mesh is traced)
      sh_vis (L, R)              shadow visibility per light: the hard
                                 or soft SDF march (unless its penumbra is
                                 recomputed in the shade) x mesh any-hit
      sh_ts (L, R)               the soft march's argmin t per light (soft
                                 shadows with diff_vis)
      ao_tmesh                   closest mesh hit along the shade normal
                                 within the AO taps' reach, from p (AO with
                                 a traced mesh)
      hit_mat, hit_closer        the hit material id and (mixed) the
                                 closest-select mask, residuals of the
                                 fused shade backward (with shadows)
      hits                       the reconstructed hit state, whose values
                                 the forward shade reuses (without
                                 silhouettes the geometry pass's
                                 reconstruct is the shade's); never saved
                                 for the backward

    Stages (utils.metrics.stage): `march` where the pass marches itself,
    `walk`, `reconstruct` (cuda_reconstruct.reconstruct) and `shadow` (the
    rest).
    """
    check_supported(cfg)
    chain = frame_chain(scene, cfg, method)
    o, d = o.detach(), d.detach()
    res = {}
    if chain.use_sdf:
        if march is None:
            with stage("march", o.device):
                march = cuda_sdf.march(scene.sdf, o, d, t0=0.0, max_steps=cfg.max_steps,
                                       eps=cfg.eps, t_far=cfg.t_far, bound_pad=_bound_pad(cfg),
                                       packed=packed)
        t, hit, _steps, tmin = march
        res["sdf_t"], res["sdf_hit"], res["sdf_tmin"] = t, hit, tmin
    if chain.use_mesh:
        with stage("walk", o.device):
            t_seed = None
            if chain.mixed:
                # the SDF hit bounds the mesh search
                t_seed = torch.where(res["sdf_hit"], res["sdf_t"],
                                     torch.full_like(res["sdf_t"], cfg.t_far))
            res["mesh_tri"], res["mesh_hit"] = _mesh_intersect(scene, cfg, chain, o, d,
                                                               t_init=t_seed)
    if cfg.shadow == "none" and not chain.ao_mesh:
        return res

    with stage("reconstruct", o.device):
        r = cuda_reconstruct.reconstruct(scene, cfg, o, d, res, method, mesh_rows=mesh_rows,
                                         packed=packed)
        res["hit_mat"] = r.hits[4]
        if r.closer is not None:
            res["hit_closer"] = r.closer
        if cfg.soft_silhouette <= 0.0 and cfg.mesh_silhouette <= 0.0:
            res["hits"] = r.hits
    with stage("shadow", o.device):
        _shadow_residuals(scene, cfg, chain, res, r, packed)
    return res


def _shadow_residuals(scene: Scene, cfg: RenderConfig, chain: Chain, res: dict,
                      r: plain.Recon, packed) -> None:
    """The geometry pass's shadow part, into res: the AO taps' mesh term
    (chain.ao_mesh), then each light's hard or soft SDF march and mesh
    any-hit from the shadow origins r.p_off (sh_vis, and sh_ts with diff_vis
    soft shadows). r: the block's reconstruct."""
    p, p_off, n, live = r.hits[2], r.p_off, r.nf, r.live
    if chain.ao_mesh:
        # the mesh term of the AO taps: the closest hit along the shade
        # normal within the taps' reach, measured from p
        cut = 5.0 * cfg.ao_step + cfg.shadow_bias
        res["ao_tmesh"] = _mesh_closest_t(scene, chain, p_off, n, cut) + cfg.shadow_bias
    if cfg.shadow == "none":
        return
    soft = cfg.shadow == "soft"

    def one_light(l_dir, t_far_rays, mesh_dir, mesh_tmax, mesh_sort):
        vis = torch.ones_like(p_off[:, 0])
        ts = torch.full_like(vis, cfg.shadow_bias)
        if live is not None:
            base = cfg.t_far if t_far_rays is None else t_far_rays
            t_far_rays = torch.where(live, base, 0.0).to(p.dtype)
        if chain.use_sdf:
            if soft:
                v, ts_m = shading.sdf_soft_shadow_argmin(scene.sdf, p_off, l_dir, cfg,
                                                         t_far_rays, packed=packed)
            else:
                v, ts_m = cuda_sdf.shadow_hard(
                    scene.sdf, p_off, l_dir, eps=cfg.eps, t_far=cfg.t_far,
                    steps=cfg.shadow_steps, bias=cfg.shadow_bias,
                    t_far_rays=t_far_rays, packed=packed)
            if chain.soft_diff:
                ts = ts_m  # the shade recomputes the penumbra from it
            else:
                vis = vis * v
        if chain.use_mesh:
            dead = None
            if chain.use_sdf and not soft:
                dead = vis <= 0.0  # the SDF march already blocked these
            if live is not None:
                dead = ~live if dead is None else (dead | ~live)
            seed = (None if dead is None else
                    torch.where(dead, 0.0, mesh_tmax).to(p.dtype))
            blocked = _mesh_any_hit(scene, chain, p_off, mesh_dir, mesh_tmax, mesh_sort,
                                    t_init=seed)
            vis = vis * (1.0 - blocked.to(p.dtype))
        return vis, ts

    rows = []
    for li in range(scene.lights.direction.shape[0]):
        l_dir = normalize(scene.lights.direction[li]).expand_as(p_off).contiguous()
        rows.append(one_light(l_dir, None, l_dir, cfg.t_far,
                              ("dir", scene.lights.direction[li])))
    for pi in range(scene.lights.position.shape[0]):
        # point light: march clamped at the light distance; the mesh any-hit
        # takes the unnormalized segment with t_max = 1 (MT is scale-free)
        lpos = scene.lights.position[pi]
        lvec = lpos - p_off
        dist = torch.sqrt(torch.clamp_min(dot(lvec, lvec), 1e-12))
        rows.append(one_light((lvec / dist[..., None]).contiguous(), dist,
                              lvec.contiguous(), 1.0, ("origin", lpos)))
    res["sh_vis"] = torch.stack([v for v, _ in rows])
    if chain.soft_diff:
        res["sh_ts"] = torch.stack([t for _, t in rows])


def shade_with_residuals(scene: Scene, cfg: RenderConfig, o, d, res,
                         method: str, mesh_rows=None, packed=None) -> torch.Tensor:
    """Shade a flat ray batch from its geometry residuals -> (R, 3).

    On a CUDA device the shade is one launch of the fused forward kernel;
    when a gradient is asked for, through one `cuda_shade.ShadeFn`, whose
    backward is the fused shade-backward kernel. A chain the kernels do not
    take raises there. On the CPU the plain `plain.shade_plain` runs, and
    with a gradient the same Function with the kernels' plain versions (or,
    for a chain the kernels do not take, autograd of the plain shade). This
    is the one place that picks the route. The per-ray corners of the
    selected triangles are gathered here, from the per-frame
    `plain.mesh_table` (`cuda_scatter.shade_corners`: on the card a
    kernel, whose backward sums the block's corner cotangents by triangle),
    so the vertex gradient scatters by triangle per block and by vertex
    once per frame. packed: the kernels' parameters packed once
    (cuda_shade.pack)."""
    chain = frame_chain(scene, cfg, method)
    grad = torch.is_grad_enabled() and cuda_shade.wants_grad(scene, o, d, mesh_rows)
    if not o.is_cuda and (chain.why is not None or not grad):
        return plain.shade_plain(scene, cfg, o, d, res, method, mesh_rows=mesh_rows)
    chain.check_kernels()
    corners = None
    if chain.use_mesh:
        if mesh_rows is None:
            mesh_rows = plain.mesh_table(scene.mesh)
        corners = cuda_scatter.shade_corners(mesh_rows, res["mesh_tri"])
    if not grad:
        return cuda_shade.shade_fwd(scene, cfg, o, d, res, method, corners=corners,
                                    mesh_rows=mesh_rows, packed=packed)
    return cuda_shade.shade(scene, cfg, o, d, res, method, corners, mesh_rows, packed)


def frame_samples(scene: Scene, cfg: RenderConfig):
    """A frame's samples as render_image hands them to render_pixels_flat
    -> (the scene with its poses folded in, flat_x, flat_y, perm): the
    pixel_sample_coords, a pixel's spp samples contiguous, in
    _block_order_perm's Morton order (perm None: row-major)."""
    scene = realize_scene(scene)
    dev, dtype = scene.device, scene.camera.origin.dtype
    sx, sy = pixel_sample_coords(cfg, dev, dtype)
    flat_x, flat_y = sx.reshape(-1), sy.reshape(-1)
    perm = _block_order_perm(cfg)
    if perm is not None:
        perm = perm.to(dev)
        flat_x = flat_x.reshape(-1, cfg.spp)[perm].reshape(-1)
        flat_y = flat_y.reshape(-1, cfg.spp)[perm].reshape(-1)
    return scene, flat_x, flat_y, perm


def whole_blocks(cfg: RenderConfig, flat_x, flat_y):
    """Flat samples covering whole pixels, split as render_pixels_flat runs
    them -> (flat_x, flat_y, bs): one block (bs the sample count) when
    cfg.block_size is 0 or covers them, else blocks of cfg.block_size
    rounded up to whole pixels, the last padded with the last sample."""
    n = flat_x.shape[0]
    if not (cfg.block_size and cfg.block_size < n):
        return flat_x, flat_y, n
    bs = -(-cfg.block_size // cfg.spp) * cfg.spp
    pad = (-n) % bs
    if pad:
        flat_x = torch.cat([flat_x, flat_x[-1:].expand(pad)])
        flat_y = torch.cat([flat_y, flat_y[-1:].expand(pad)])
    return flat_x, flat_y, bs


def march_groups(n: int, bs: int) -> list:
    """The slices of n samples in blocks of bs, one a group of MARCH_GROUP
    blocks (the last may hold fewer): what march_group marches at once."""
    step = MARCH_GROUP * bs
    return [slice(g, g + step) for g in range(0, n, step)]


def frame_tables(scene: Scene, cfg: RenderConfig, method: str):
    """What every block of a frame reads besides the scene -> (mesh_rows,
    packed): the per-frame plain.mesh_table (differentiable; None when the
    mesh is not traced) and the kernels' parameters packed once
    (cuda_shade.pack, under no_grad)."""
    use_mesh = frame_chain(scene, cfg, method).use_mesh
    mesh_rows = plain.mesh_table(scene.mesh) if use_mesh else None
    return mesh_rows, cuda_shade.pack(scene, _bound_pad(cfg))


def _pixel_mean(cfg: RenderConfig, colors: torch.Tensor) -> torch.Tensor:
    """(R, 3) sample colours -> (3, R / spp) channel-major pixel means."""
    return colors.reshape(-1, cfg.spp, 3).mean(1).T


def render_block(scene: Scene, cfg: RenderConfig, method: str, x, y, mesh_rows=None,
                 packed=None, march=None):
    """One block of samples -> ((3, n_px) spp-averaged colours, the geometry
    residuals). It reads only its arguments: the block's sample coordinates,
    its slice of march_group's result (march; None: the pass marches
    itself), the frame's tables (frame_tables) and the scene's tensors, so a
    CUDA graph of it (render/graphs.py) can be replayed over a frame's
    blocks. Rays are generated inside autograd (the camera's gradient).
    Stages: `rays`, the geometry pass's, `shade`."""
    with stage("rays", x.device):
        o, d = generate_rays(scene.camera, x, y, cfg.width, cfg.height)
    res = geometry_residuals(scene, cfg, o, d, method, mesh_rows=mesh_rows, march=march,
                             packed=packed)
    with stage("shade", x.device):
        colors = shade_with_residuals(scene, cfg, o, d, res, method, mesh_rows=mesh_rows,
                                      packed=packed)
        return _pixel_mean(cfg, colors), res


def shade_block(scene: Scene, cfg: RenderConfig, method: str, x, y, res, mesh_rows=None,
                packed=None) -> torch.Tensor:
    """render_block's colours from its geometry residuals, without the
    geometry pass: the rays again (inside autograd) and the shade. What the
    backward of a graphed frame differentiates, block by block."""
    o, d = generate_rays(scene.camera, x, y, cfg.width, cfg.height)
    colors = shade_with_residuals(scene, cfg, o, d, res, method, mesh_rows=mesh_rows,
                                  packed=packed)
    return _pixel_mean(cfg, colors)


def render_pixels_flat(scene: Scene, cfg: RenderConfig, flat_x, flat_y,
                       method: str | None = None) -> torch.Tensor:
    """Render flat sample coords covering whole pixels (a pixel's spp samples
    contiguous) -> per-pixel colors (3, n_px), spp-averaged, channel-major.
    Samples run in blocks of cfg.block_size (rounded up to whole pixels,
    whole_blocks), one render_block each.

    The kernels' scene parameters are packed once here (frame_tables) and
    handed to every wrapper. The primary march, which takes no gradient,
    runs once per group of MARCH_GROUP consecutive blocks (march_groups,
    march_group), and each block takes its slice of the result.
    No block is checkpointed: the shade's Function saves only compact
    residuals, so the backward keeps ~100 bytes per ray."""
    method = method or resolve_method(scene, cfg)
    mesh_rows, packed = frame_tables(scene, cfg, method)

    def block_fn(x, y, march=None):
        return render_block(scene, cfg, method, x, y, mesh_rows, packed, march)[0]

    R = flat_x.shape[0]
    n_px = R // cfg.spp
    flat_x, flat_y, bs = whole_blocks(cfg, flat_x, flat_y)
    if bs == R:
        return block_fn(flat_x, flat_y)
    grouped = frame_chain(scene, cfg, method).use_sdf
    cols = []
    for g in march_groups(flat_x.shape[0], bs):
        gx, gy = flat_x[g], flat_y[g]
        marched = march_group(scene, cfg, gx, gy, packed, bs) if grouped else None
        for s in range(0, gx.shape[0], bs):
            block = None if marched is None else tuple(v[s:s + bs] for v in marched)
            cols.append(block_fn(gx[s:s + bs], gy[s:s + bs], block))
        del marched, block  # the group's march out of memory before the next one's
    return torch.cat(cols, dim=1)[:, :n_px]


def _to_image(cfg: RenderConfig, flat: torch.Tensor, perm) -> torch.Tensor:
    """(3, H*W) pixels in the samples' order -> the (H, W, 3) image."""
    if perm is not None:
        flat = flat[:, _inverse_perm(perm)]
    return flat.reshape(3, cfg.height, cfg.width).permute(1, 2, 0)


def render_image(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Full frame: (H, W, 3) linear RGB, spp-averaged. Object poses fold
    into world-space vertices first (the packet accel refit to them)."""
    scene, flat_x, flat_y, perm = frame_samples(scene, cfg)
    return _to_image(cfg, render_pixels_flat(scene, cfg, flat_x, flat_y), perm)


def render_image_jit(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """render_image as a compiled program (counterpart of the reference's
    `jax.jit` of render_image): on a CUDA scene every block replays CUDA
    graphs captured once per config, method, block size and the scene's
    structure (render/graphs.py); eager dispatch runs only at their
    warm-up and capture, and a capture that fails raises. Differentiable:
    torch.autograd through it gives render_image's gradients. On a CPU
    scene the same replay plan runs its blocks without capture. Object
    poses fold in first, outside the graphs, as in render_image. Spans
    (utils.metrics.span): `render.frame` around the call, `render.prepare`
    around the samples, `render.to_image` around the image's assembly."""
    from tpu_ray_torch.render import graphs

    with span("render.frame"):
        with span("render.prepare"):
            scene, flat_x, flat_y, perm = frame_samples(scene, cfg)
        flat = graphs.render_pixels_flat_jit(scene, cfg, flat_x, flat_y)
        with span("render.to_image"):
            return _to_image(cfg, flat, perm)


@torch.no_grad()
def frame_stats(scene: Scene, cfg: RenderConfig, max_rays: int = 1 << 18) -> dict:
    """Per-frame ray statistics (the reference's overlay counters): hit
    rate, mean hit distance and, when the SDF is traced, the primary
    march's steps. The frame's samples in row-major order are subsampled
    by a stride to about max_rays. The rays take the geometry pass without
    shadows or AO: the march (whose steps these are) and the mesh walk,
    the kernels on a CUDA device, then the values-only reconstruct for t
    and hit."""
    scene = realize_scene(scene)
    dev, dtype = scene.device, scene.camera.origin.dtype
    method = resolve_method(scene, cfg)
    sx, sy = pixel_sample_coords(cfg, dev, dtype)
    fx, fy = sx.reshape(-1), sy.reshape(-1)
    stride = max(1, fx.shape[0] // max_rays)
    fx, fy = fx[::stride], fy[::stride]
    with stage("rays", dev):
        o, d = generate_rays(scene.camera, fx, fy, cfg.width, cfg.height)
    primary = cfg.replace(shadow="none", ao="none")
    march = None
    if frame_chain(scene, cfg, method).use_sdf:
        with stage("march", dev):
            march = cuda_sdf.march(scene.sdf, o, d, t0=0.0, max_steps=cfg.max_steps,
                                   eps=cfg.eps, t_far=cfg.t_far, bound_pad=_bound_pad(cfg))
    res = geometry_residuals(scene, primary, o, d, method, march=march)
    with stage("reconstruct", dev):
        t, hit = cuda_reconstruct.reconstruct(scene, primary, o, d, res, method).hits[:2]
    stats = {
        "method": method,
        "rays_sampled": int(fx.shape[0]),
        "hit_rate": float(hit.to(torch.float32).mean()),
        "mean_hit_t": float(torch.where(hit, t, torch.zeros_like(t)).sum()
                            / torch.clamp_min(hit.sum(), 1)),
    }
    if march is not None:
        steps = march[2]
        stats["march_steps_mean"] = float(steps.to(torch.float32).mean())
        stats["march_steps_max"] = int(steps.max())
    return stats
