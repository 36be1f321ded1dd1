"""Pixel data parallelism over a process group (counterpart of
`tpu_ray/dist/sharding.py`).

The flat sample grid, dealt by `balanced_pixel_perm`, is padded to whole
pixels per process; rank r renders the r-th contiguous slice with the scene
replicated, and the frame is gathered with one `all_gather`. The forward
pass has no other communication, unless the mesh's accel is partitioned
around the ring (`scene_shards`, dist/scene_shard.py).

The reference's `make_mesh` and `RAY_AXIS` have no counterpart: the process
group (torch.distributed's default, or the one given) takes their place, one
process per device. With `gather=False` no process gathers the frame: the
pixels go by point-to-point exchange to the rank whose band of rows holds
them (`row_bands`), for a per-process image write
(dist/multihost.write_image_per_host).

`render_image_sharded_jit` is the compiled form (the reference's
`render_image_sharded_jit`): each rank's slice through the per-block CUDA
graphs (render/graphs.render_pixels_flat_jit, the ring's rotation captured
with its block), and the gather one captured `all_gather_into_tensor`
into a static buffer, whenever a process group is live (world size 1
included); the slice's samples and the gathered frame's pixel index are
built once per plan.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_ray_torch.dist.multihost import live_group, world
from tpu_ray_torch.dist.scene_shard import build_ring_packet
from tpu_ray_torch.render import graphs
from tpu_ray_torch.render.render import pixel_sample_coords, render_pixels_flat, resolve_method
from tpu_ray_torch.scene.transform import realize_scene
from tpu_ray_torch.scene.types import Scene
from tpu_ray_torch.utils.config import RenderConfig


def balanced_pixel_perm(cfg: RenderConfig, n_dev: int) -> np.ndarray:
    """(n_px,) int32 pixel permutation that deals 8x8 pixel blocks
    round-robin to the shards (each samples the whole frame: load balance)
    and keeps each block contiguous (a warp's rays stay coherent); strips of
    single pixels when the sides do not divide by 8."""
    n_px = cfg.height * cfg.width
    if cfg.height % 8 == 0 and cfg.width % 8 == 0:
        idx = np.arange(n_px, dtype=np.int32).reshape(cfg.height // 8, 8, cfg.width // 8, 8)
        units = idx.transpose(0, 2, 1, 3).reshape(-1, 64)
    else:
        units = np.arange(n_px, dtype=np.int32).reshape(-1, 1)
    order = np.concatenate([np.arange(units.shape[0])[s::n_dev] for s in range(n_dev)])
    return units[order].reshape(-1)


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    return torch.cat([x, x[-1:].expand(pad)]) if pad else x


def shard_sample_coords(cfg: RenderConfig, n_dev: int, device="cpu", dtype=torch.float32):
    """Flat sample coordinates in `balanced_pixel_perm` order, padded so that
    every shard holds whole pixels -> (flat_x, flat_y, n_px, perm): the
    length is a multiple of n_dev * spp. Per-pixel data (targets, frames)
    must be put in the same order."""
    sx, sy = pixel_sample_coords(cfg, device, dtype)
    perm = balanced_pixel_perm(cfg, n_dev)
    p = torch.from_numpy(perm.astype(np.int64)).to(device)
    fx = sx.reshape(-1, cfg.spp)[p].reshape(-1)
    fy = sy.reshape(-1, cfg.spp)[p].reshape(-1)
    return (_pad_to(fx, n_dev * cfg.spp), _pad_to(fy, n_dev * cfg.spp),
            sx.numel() // cfg.spp, perm)


def ring_scene(scene: Scene, group=None) -> Scene:
    """The scene with its poses folded in and its accel partitioned around
    the group's ring (this rank's shard in `ring`, `packet` dropped): the
    shards are geometry, so they are built from the posed vertices."""
    scene = realize_scene(scene)
    if not scene.has_mesh:
        return scene
    ring = build_ring_packet(scene.mesh.verts.detach().cpu().numpy(),
                             scene.mesh.tris.cpu().numpy(), group, scene.device)
    return scene.replace(packet=None, grid=None, ring=ring)


def row_bands(height: int, n: int) -> list[tuple[int, int]]:
    """Rank r's band of rows [r0, r1): ceil(height / n) rows each, the last
    ones shorter or empty."""
    b = -(-height // n)
    return [(min(r * b, height), min((r + 1) * b, height)) for r in range(n)]


def _to_bands(px: torch.Tensor, perm: np.ndarray, n_px: int, cfg: RenderConfig,
              group) -> torch.Tensor:
    """Rank r's rendered slice px (3, per) of the dealt pixels -> its band of
    rows (rows, W, 3): each rank sends every other rank the pixels of its
    slice that lie in that rank's band, and receives its own band's pixels
    from the others (batch_isend_irecv). Which pixels go where follows from
    perm alone, so every rank knows every message's size."""
    n, r = world(group)
    per = px.shape[1]
    bands = row_bands(cfg.height, n)
    # row-major pixel of each dealt position; the padding past n_px is no pixel
    pix = np.full(n * per, -1, np.int64)
    pix[:n_px] = perm
    owner = np.searchsorted(np.asarray([b1 for _, b1 in bands]), pix // cfg.width,
                            side="right")
    owner[pix < 0] = -1
    r0, r1 = bands[r]
    band = px.new_empty((3, (r1 - r0) * cfg.width))
    index = lambda a: torch.from_numpy(a).to(px.device)
    ops, recvs = [], []
    for q in range(n):
        mine = index(np.nonzero(owner[r * per:(r + 1) * per] == q)[0])  # my pixels q holds
        theirs = owner[q * per:(q + 1) * per] == r  # q's positions whose pixels I hold
        dst = index(pix[q * per:(q + 1) * per][theirs] - r0 * cfg.width)
        if q == r:
            band[:, dst] = px[:, mine]
            continue
        if mine.numel():
            ops.append(dist.P2POp(dist.isend, px[:, mine].contiguous(), q, group))
        if dst.numel():
            buf = px.new_empty((3, dst.numel()))
            ops.append(dist.P2POp(dist.irecv, buf, q, group))
            recvs.append((buf, dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, dst in recvs:
        band[:, dst] = buf
    return band.reshape(3, r1 - r0, cfg.width).permute(1, 2, 0)


def render_image_sharded(scene: Scene, cfg: RenderConfig, group=None,
                         scene_shards: bool = False, gather: bool = True) -> torch.Tensor:
    """The full frame (H, W, 3) rendered by every process of the group,
    each its own whole-pixel slice, gathered to every process. With
    scene_shards the mesh's accel is partitioned around the ring: each
    process holds 1/N of it and the shards rotate past its rays. With
    gather=False each process gets only its band of rows of the frame,
    row_bands(H, N)[rank] (at most ceil(H/N) rows, W, 3), and no process
    holds the whole frame."""
    n, r = world(group)
    scene = ring_scene(scene, group) if scene_shards else realize_scene(scene)
    method = resolve_method(scene, cfg)
    flat_x, flat_y, n_px, perm = shard_sample_coords(cfg, n, scene.device,
                                                     scene.camera.origin.dtype)
    per = flat_x.shape[0] // n
    px = render_pixels_flat(scene, cfg, flat_x[r * per:(r + 1) * per],
                            flat_y[r * per:(r + 1) * per], method)  # (3, per / spp)
    if not gather:
        return _to_bands(px, perm, n_px, cfg, group)
    if n > 1:
        parts = [torch.empty_like(px) for _ in range(n)]
        dist.all_gather(parts, px.contiguous(), group=group)
        px = torch.cat(parts, dim=1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_px, dtype=perm.dtype)
    flat = px[:, :n_px][:, torch.from_numpy(inv.astype(np.int64)).to(px.device)]
    return flat.reshape(3, cfg.height, cfg.width).permute(1, 2, 0)


# torch 2.13 renamed all_gather_into_tensor (its old name still works, with a
# warning); the older name is the one every version has
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _ShardedPlan:
    """render_image_sharded_jit's state for one (config, group, rank, device,
    dtype): this rank's samples, the index of each pixel of the row-major
    frame in the gathered (n, 3, per) pixels, and with a live group the
    gather: a Graph of one all_gather_into_tensor from a static (3, per)
    buffer into a static (n * 3, per) one."""

    def __init__(self, cfg: RenderConfig, group, device, dtype):
        n, r = world(group)
        flat_x, flat_y, self.n_px, self.perm = shard_sample_coords(cfg, n, device, dtype)
        per = flat_x.shape[0] // n
        self.xs, self.ys = flat_x[r * per:(r + 1) * per], flat_y[r * per:(r + 1) * per]
        per_px = per // cfg.spp
        # pixel i is dealt to position inv[i]: rank inv[i] // per_px, column
        # inv[i] % per_px of that rank's (3, per_px) slice
        inv = np.empty(self.n_px, np.int64)
        inv[self.perm] = np.arange(self.n_px)
        pos = (inv // per_px) * 3 * per_px + inv % per_px
        self.index = torch.from_numpy(pos[None, :] + np.arange(3)[:, None] * per_px).to(device)
        self.group, self.gather = group, None
        if group is not None:
            self.px = torch.zeros((3, per_px), dtype=dtype, device=device)
            self.gathered = torch.zeros((n * 3, per_px), dtype=dtype, device=device)
            self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
            self.gather = graphs.Graph(self._gather, device, self.pool)

    def _gather(self) -> torch.Tensor:
        _all_gather(self.gathered, self.px, group=self.group)
        return self.gathered

    def reset(self) -> None:
        if self.gather is not None:
            self.gather.reset()

    def frame(self, px: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
        """This rank's (3, per) pixels -> the gathered (H, W, 3) frame."""
        if self.gather is not None:
            self.px.copy_(px)
            px = self.gather.replay()
        flat = px.reshape(-1)[self.index]
        return flat.reshape(3, cfg.height, cfg.width).permute(1, 2, 0)


@torch.no_grad()
def render_image_sharded_jit(scene: Scene, cfg: RenderConfig, group=None,
                             scene_shards: bool = False, gather: bool = True) -> torch.Tensor:
    """render_image_sharded through CUDA graphs: each rank renders its
    slice with graphs.render_pixels_flat_jit (the ring's walk and rotation
    inside the block graph with scene_shards) and the frame is gathered by
    a captured all_gather_into_tensor whenever a process group is live.
    The same frame as render_image_sharded, bit for bit; not
    differentiated (the data-parallel fit step is
    fit.make_sharded_fit_step). gather=False: this rank's band of rows, by
    render_image_sharded's host exchange after the replays."""
    group = live_group(group)
    scene = ring_scene(scene, group) if scene_shards else realize_scene(scene)
    dtype = scene.camera.origin.dtype
    key = ("sharded", cfg, world(group), group, scene.device, dtype)
    plan = graphs.PLANS.get(key)
    if plan is None:
        plan = graphs.PLANS[key] = _ShardedPlan(cfg, group, scene.device, dtype)
    px = graphs.render_pixels_flat_jit(scene, cfg, plan.xs, plan.ys)  # (3, per / spp)
    if not gather:
        return _to_bands(px, plan.perm, plan.n_px, cfg, group)
    return plan.frame(px, cfg)
