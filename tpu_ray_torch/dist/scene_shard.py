"""Ring scene-shard intersection: the mesh partitioned across a process
group (counterpart of `tpu_ray/dist/scene_shard.py`).

Each process holds 1/N of the triangles; its rays and their running closest
hit stay resident while the shards rotate around the ring: at step s,
rank r holds shard (r - s) mod N, as the reference's `ppermute` with pairs
i -> i+1 leaves it. A step sends the shard in hand to rank r+1 and
receives the next from rank r-1 (`dist.batch_isend_irecv`; gloo moves CPU
tensors, NCCL CUDA tensors). With one process there is no rotation.

`intersect_ring` is the brute oracle over raw triangle shards;
`intersect_ring_packet` is the production path over packet-accel shards,
each step the resident kernel (#4), or the streamed one (#3) for a shard
over VMEM_BUDGET_BYTES, seeded with the running best t. It reads no device
value on the host, so a block's CUDA graph captures it, the rotation
included (render/graphs.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from tpu_ray_torch.accel.packet import (CHUNK, ROWS_PER_CHUNK, SUPER, VMEM_BUDGET_BYTES,
                                        PacketAccel, _morton_order, build_packet_accel,
                                        refit_packet_accel, super_tree)
from tpu_ray_torch.dist.multihost import world
from tpu_ray_torch.kernels import cuda_mt
from tpu_ray_torch.kernels.moller_trumbore import BIG, TriHit, _mt_t

_INT32_MAX = 2 ** 31 - 1


def partition_mesh(verts: np.ndarray, tris: np.ndarray, n_shards: int):
    """Split the triangles into n equal shards of gathered corners ->
    (v0, v1, v2, tri_id) of shapes (n, T_pad, 3) and (n, T_pad); the pad
    is degenerate triangles (never hit) with id -1."""
    tris = np.asarray(tris).reshape(-1, 3)
    T = tris.shape[0]
    t_pad = -(-T // n_shards) * n_shards
    corners = np.asarray(verts)[tris]  # (T, 3, 3)
    pad = t_pad - T
    if pad:
        corners = np.concatenate([corners, np.zeros((pad, 3, 3))], 0)
    tri_id = np.concatenate([np.arange(T), np.full(pad, -1)]).astype(np.int32)
    per = t_pad // n_shards
    c = corners.reshape(n_shards, per, 3, 3)
    return c[:, :, 0], c[:, :, 1], c[:, :, 2], tri_id.reshape(n_shards, per)


def _rotate(tensors, group=None):
    """Each rank sends its tensors to rank r+1 and receives rank r-1's.

    Safe under CUDA graph capture (render/graphs.py): the receive buffers
    are allocated here, so a captured rotation takes them from the graph's
    pool, and nothing reads a device value on the host. Under NCCL
    `req.wait()` only orders the current stream after NCCL's (torch's
    ProcessGroupNCCL blocks the host there only with TORCH_NCCL_BLOCKING_WAIT
    set)."""
    n, r = world(group)
    peer = (lambda i: i) if group is None else (lambda i: dist.get_global_rank(group, i))
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, out in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer((r + 1) % n), group))
        ops.append(dist.P2POp(dist.irecv, out, peer((r - 1) % n), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def intersect_ring(o, d, v0, v1, v2, tri_id, t_max: float = BIG, group=None) -> TriHit:
    """Closest hit over all ranks' triangles for this rank's rays (R, 3):
    v0..tri_id are this rank's shard (T_s, 3) / (T_s,). After N steps every
    ray has met every triangle; the result is brute MT over the whole mesh,
    ties broken by the smallest global triangle id."""
    n, _ = world(group)
    best_t = torch.full(o.shape[:-1], BIG, dtype=o.dtype, device=o.device)
    best_tri = torch.full(o.shape[:-1], _INT32_MAX, dtype=torch.int32, device=o.device)
    shard = (v0, v1, v2, tri_id)
    for step in range(n):
        sv0, sv1, sv2, sid = shard
        t, valid = _mt_t(o[:, None, :], d[:, None, :], sv0, sv1, sv2, t_max)
        t = torch.where(valid & (sid >= 0), t, torch.full_like(t, BIG))
        tc = torch.min(t, dim=-1).values
        is_min = t <= tc[:, None]
        ic = torch.where(is_min & (t < BIG * 0.5), sid,
                         torch.full_like(sid, _INT32_MAX)).min(dim=-1).values
        better = (tc < best_t) | ((tc == best_t) & (ic < best_tri) & (tc < BIG * 0.5))
        best_t = torch.where(better, tc, best_t)
        best_tri = torch.where(better, ic, best_tri)
        if step + 1 < n:
            shard = tuple(_rotate(shard, group))
    hit = best_t < BIG * 0.5
    return TriHit(best_t, torch.where(hit, best_tri, torch.full_like(best_tri, -1)), hit)


@dataclasses.dataclass
class RingPacket:
    """This rank's shard of the packet accel. Every shard is padded to the
    same chunk and super counts, so the rotation moves equal shapes; `perm`
    holds global triangle ids. n_shards is the group's size, rank this
    process's rank in it."""

    corners: torch.Tensor  # (C*16, 128)
    chunk_aabb: torch.Tensor  # (C, 128)
    super_aabb: torch.Tensor  # (S, 128)
    perm: torch.Tensor  # (C*128,) int32, -1 pad
    n_shards: int = 1
    rank: int = 0
    group: object = None
    # super_tree(super_aabb), derived as PacketAccel derives it; it rotates
    # with the shard
    tree: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.tree = super_tree(self.super_aabb)

    def accel(self) -> PacketAccel:
        return _accel((self.corners, self.chunk_aabb, self.super_aabb, self.perm, self.tree))


def _accel(shard) -> PacketAccel:
    """The accel of a shard (corners, chunk_aabb, super_aabb, perm, tree)."""
    corners, chunk_aabb, super_aabb, perm, tree = shard
    return PacketAccel.carrying(tree, corners=corners, chunk_aabb=chunk_aabb,
                                super_aabb=super_aabb, perm=perm, num_tris=perm.shape[0])


def ring_shards(verts: np.ndarray, tris: np.ndarray, n_shards: int) -> list:
    """Every shard on the host, deterministically: the whole mesh
    Morton-sorted and split into n contiguous (spatially compact) shards,
    one packet accel each, padded to the largest super count -> a list of
    (corners, chunk_aabb, super_aabb, perm) numpy tuples (the reference's
    stacked RingPacket, shard by shard)."""
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    order = _morton_order(np.asarray(verts, np.float64), tris)
    per = -(-tris.shape[0] // n_shards)
    accels = []
    for s in range(n_shards):
        sel = order[s * per:(s + 1) * per]
        accels.append(build_packet_accel(verts, tris[sel], tri_id_base=sel))
    max_s = max(a.super_aabb.shape[0] for a in accels)
    max_c = max_s * SUPER
    big = 1e10
    out = []
    for a in accels:
        C, S = a.chunk_aabb.shape[0], a.super_aabb.shape[0]
        cor = np.zeros((max_c * ROWS_PER_CHUNK, CHUNK), np.float32)
        cor[:C * ROWS_PER_CHUNK] = a.corners.numpy()
        ab = np.zeros((max_c, 128), np.float32)
        ab[:, 0:3], ab[:, 3:6] = big, -big
        ab[:C] = a.chunk_aabb.numpy()
        sup = np.zeros((max_s, 128), np.float32)
        sup[:, 0:3], sup[:, 3:6] = big, -big
        sup[:S] = a.super_aabb.numpy()
        perm = np.full((max_c * CHUNK,), -1, np.int32)
        perm[:a.perm.shape[0]] = a.perm.numpy()
        out.append((cor, ab, sup, perm))
    return out


def build_ring_packet(verts: np.ndarray, tris: np.ndarray, group=None,
                      device="cuda") -> RingPacket:
    """This rank's RingPacket over the group: every rank builds all shards
    on the host (ring_shards) and keeps its own, on `device`."""
    n, r = world(group)
    own = ring_shards(verts, tris, n)[r]
    t = lambda a: torch.as_tensor(a, device=device)
    return RingPacket(*(t(a) for a in own), n_shards=n, rank=r, group=group)


def refit_ring_packet(ring: RingPacket, verts, tris) -> RingPacket:
    """This rank's shard refit to the current vertices before the rotation
    starts, so every shard in flight is exact for them (`perm` holds global
    ids, so the packet refit applies as it is)."""
    new = refit_packet_accel(ring.accel(), verts, tris)
    return dataclasses.replace(ring, corners=new.corners, chunk_aabb=new.chunk_aabb,
                               super_aabb=new.super_aabb)


def intersect_ring_packet(ring: RingPacket, o, d, t_max: float = BIG,
                          any_hit: bool = False, sort_origin=None,
                          sort_dir=None) -> TriHit:
    """Closest hit (or any-hit) over all ranks' shards with the packet
    kernels -> global triangle ids. Each step runs the resident kernel #4
    with the sort hints and the running best t as its seed (the streamed
    kernel #3 for a shard over VMEM_BUDGET_BYTES), folds its hits as
    `intersect_packet_parts` does, then rotates the shard."""
    n = ring.n_shards
    shard = (ring.corners, ring.chunk_aabb, ring.super_aabb, ring.perm, ring.tree)
    streamed = cuda_mt.accel_bytes(ring.accel()) > VMEM_BUDGET_BYTES
    t_far = min(t_max, BIG)
    best, t_run = None, None
    for step in range(n):
        accel = _accel(shard)
        if streamed:
            res = cuda_mt.intersect_packet_streamed(accel, o, d, t_max=t_max,
                                                    any_hit=any_hit, t_init=t_run)
        else:
            res = cuda_mt.intersect_packet(accel, o, d, t_max=t_max, any_hit=any_hit,
                                           sort_origin=sort_origin, sort_dir=sort_dir,
                                           t_init=t_run)
        best = cuda_mt.fold_hits(best, res, any_hit)
        if step + 1 < n:
            t_run = cuda_mt.running_t(best, t_far, any_hit)
            shard = tuple(_rotate(shard, ring.group))
    return best
