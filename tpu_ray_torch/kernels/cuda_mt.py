"""Packet-accel mesh intersection: CUDA kernels and their plain versions.

Counterpart of `tpu_ray/kernels/pallas_mt.py`, with its names:
`intersect_packet_streamed` (TPU kernel #3, the supers in slot order, as a
walk of the accel's 16-ary tree over them that skips the subtrees no ray
of a block reaches),
`intersect_packet` and `any_hit_packet` (TPU kernel #4, the supers visited
in the order of `sort_origin` or `sort_dir`), and the multi-part walk
`intersect_packet_parts`. Kernels: `csrc/packet_mt.cu`.

Dispatch follows the device: each wrapper runs its `*_torch` plain version
on CPU tensors and launches its kernel on CUDA tensors, raising on what the
kernel does not take. Each launch adds one to `LAUNCHES`: "closest" and
"any_hit" for #3, "resident_closest" and "resident_any_hit" for #4. Each
launch adds what its walk did (COUNTERS) to the process's counters, one
int64 tensor per device and LAUNCHES kind, made at the kind's first launch
on the device (a graph's warm-up, before its capture, so the captured
launch adds to it at every replay); `walk_counters()` reads them, and the
difference of two readings is what the launches between them did.

Semantics shared by all versions: best t starts at min(t_init, t_far); a
triangle counts with t in (T_MIN, t_far) for the static t_far; only strictly
better hits are recorded, so a tie keeps the first slot visited; sorted
slots map to triangle ids through `perm`. Any-hit reports only whether some
blocker exists: t is BIG and tri is 0 on a hit lane, -1 elsewhere.
"""

from __future__ import annotations

import types

import torch

from tpu_ray_torch.accel.packet import (CHUNK, ROWS_PER_CHUNK, SUPER, VMEM_BUDGET_BYTES,
                                        PacketAccel)
from tpu_ray_torch.kernels.build import check_cuda_inputs, check_launch, kernel_lib
from tpu_ray_torch.kernels.moller_trumbore import BIG, TriHit, _DET_EPS, _T_MIN

LAUNCHES = {"closest": 0, "any_hit": 0, "resident_closest": 0, "resident_any_hit": 0}
# the kernels' counters (csrc/packet_mt.cu `Counter`): chunks staged
# in shared memory, ray x triangle MT tests, (ray, staged chunk) pairs whose
# box test passed and all such pairs, supers visited, blocks, rays, and the
# tree's nodes visited (#3; 0 in #4)
COUNTERS = ("chunks_staged", "mt_tests", "box_passes", "box_slots", "supers_visited",
            "blocks", "rays", "nodes_visited")
# the process's walk counters, by (device, kind)
_WALK = {}

# ray x triangle pairs per step of the plain versions (bounds their temporaries)
_PAIRS_PER_STEP = 1 << 22


def _finalize(best_t, slot, accel: PacketAccel, any_hit: bool) -> TriHit:
    hit = slot >= 0
    minus1 = torch.full_like(slot, -1)
    if any_hit:
        return TriHit(torch.full_like(best_t, BIG),
                      torch.where(hit, torch.zeros_like(slot), minus1), hit)
    n = accel.perm.shape[0]
    tri = accel.perm[torch.clamp(slot, 0, n - 1).long()]
    return TriHit(torch.where(hit, best_t, torch.full_like(best_t, BIG)),
                  torch.where(hit, tri, minus1), hit)


def _brute(accel: PacketAccel, o, d, t_max, any_hit, t_init, slots=None) -> TriHit:
    """Brute MT over the accel's sorted triangle slots, taken in the order
    `slots` (all slots in slot order without it), in blocks of rays and
    slots: a walk's function without its culls. The first minimum of a row
    wins a tie, as the first slot visited does in the kernels."""
    t_far = float(min(t_max, BIG))
    R = o.shape[0]
    C = accel.chunk_aabb.shape[0]
    data = (accel.corners.reshape(C, ROWS_PER_CHUNK, CHUNK)[:, :9]
            .permute(1, 0, 2).reshape(9, C * CHUNK))  # (9, slots)
    if slots is not None:
        data = data[:, slots]
    best0 = (torch.full((R,), t_far, dtype=o.dtype, device=o.device)
             if t_init is None else torch.clamp_max(t_init, t_far))
    rb = min(max(R, 1), 8192)
    sb = max(CHUNK, (_PAIRS_PER_STEP // rb) // CHUNK * CHUNK)
    best_out, slot_out = [], []
    for r0 in range(0, R, rb):
        ox, oy, oz = (o[r0:r0 + rb, k, None] for k in range(3))
        dx, dy, dz = (d[r0:r0 + rb, k, None] for k in range(3))
        best = best0[r0:r0 + rb]
        col = torch.full_like(best, -1, dtype=torch.int64)
        for s0 in range(0, data.shape[1], sb):
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = data[:, s0:s0 + sb]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = torch.abs(det) > _DET_EPS
            inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                     & (t > _T_MIN) & (t < t_far))
            tc, ic = torch.min(torch.where(valid, t, torch.full_like(t, BIG)), dim=1)
            better = tc < best  # strictly: the first column keeps a tie
            best = torch.where(better, tc, best)
            col = torch.where(better, ic + s0, col)
        best_out.append(best)
        slot_out.append(col)
    col = torch.cat(slot_out)
    slot = col if slots is None else torch.where(col >= 0, slots[col.clamp_min(0)], col)
    return _finalize(torch.cat(best_out), slot.to(torch.int32), accel, any_hit)


def intersect_packet_streamed_torch(accel: PacketAccel, o, d, *, t_max: float = BIG,
                                    any_hit: bool = False, t_init=None) -> TriHit:
    """Plain version of #3: brute MT over every slot in slot order."""
    return _brute(accel, o, d, t_max, any_hit, t_init)


def intersect_packet_streamed(accel: PacketAccel, o, d, *, t_max: float = BIG,
                              any_hit: bool = False, t_init=None) -> TriHit:
    """TPU kernel #3: closest-hit (or any-hit) of (R,3) rays against the
    packet accel, its supers in slot order: a block walks `accel.tree`
    depth first and steps only the supers under nodes that one of its
    undecided rays reaches, with the result of stepping every super."""
    if o.device.type == "cpu":
        return intersect_packet_streamed_torch(accel, o, d, t_max=t_max,
                                               any_hit=any_hit, t_init=t_init)
    _check(accel, o, d, t_init, "intersect_packet_streamed")
    kind = "any_hit" if any_hit else "closest"
    t, tri, hit = _outputs(o)
    with torch.cuda.device(o.device):
        rc = kernel_lib().tr_intersect_packet_streamed(
            o.data_ptr(), d.data_ptr(), None if t_init is None else t_init.data_ptr(),
            o.shape[0], float(min(t_max, BIG)), accel.corners.data_ptr(),
            accel.chunk_aabb.data_ptr(), accel.super_aabb.data_ptr(), accel.tree.data_ptr(),
            accel.super_aabb.shape[0], accel.perm.data_ptr(), accel.perm.shape[0],
            int(any_hit), t.data_ptr(), tri.data_ptr(), hit.data_ptr(),
            _counted(o.device, kind).data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    check_launch("intersect_packet_streamed", rc)
    LAUNCHES[kind] += 1
    return TriHit(t, tri, hit)


def super_order(accel: PacketAccel, sort_origin=None, sort_dir=None,
                device=None) -> torch.Tensor:
    """(S,) int32 visit order of the supers, on `device` (the accel's by
    default): ascending squared distance of their box centres from
    sort_origin, or ascending projection of the centres on sort_dir, or
    slot order. The sort is stable, as jnp.argsort."""
    sup = accel.super_aabb.to(device) if device is not None else accel.super_aabb
    if sort_origin is None and sort_dir is None:
        return torch.arange(sup.shape[0], dtype=torch.int32, device=sup.device)
    centers = 0.5 * (sup[:, 0:3] + sup[:, 3:6])
    if sort_origin is not None:
        key = torch.sum((centers - sort_origin.to(sup.device)) ** 2, dim=1)
    else:
        key = torch.sum(centers * sort_dir.to(sup.device), dim=1)
    return torch.argsort(key, stable=True).to(torch.int32)


def intersect_packet_torch(accel: PacketAccel, o, d, *, t_max: float = BIG,
                           any_hit: bool = False, sort_origin=None, sort_dir=None,
                           t_init=None) -> TriHit:
    """Plain version of #4: brute MT over the slots reordered super by super
    in the kernel's visit order, so that ties break as in the kernel."""
    order = super_order(accel, sort_origin, sort_dir, o.device).long()
    per = SUPER * CHUNK
    slots = (order[:, None] * per + torch.arange(per, device=o.device)).reshape(-1)
    return _brute(accel, o, d, t_max, any_hit, t_init, slots)


def intersect_packet(accel: PacketAccel, o, d, *, t_max: float = BIG,
                     any_hit: bool = False, sort_origin=None, sort_dir=None,
                     t_init=None) -> TriHit:
    """TPU kernel #4: closest-hit (or any-hit) of (R,3) rays against a
    resident accel part, its supers visited by distance from sort_origin
    (primary rays of one camera), by projection on sort_dir (shadow rays
    toward one light) or in slot order. t_init (R,) seeds each lane's best
    t (a previous part's or ring shard's hit, or 0 for a decided shadow)."""
    if o.device.type == "cpu":
        return intersect_packet_torch(accel, o, d, t_max=t_max, any_hit=any_hit,
                                      sort_origin=sort_origin, sort_dir=sort_dir,
                                      t_init=t_init)
    _check(accel, o, d, t_init, "intersect_packet")
    order = super_order(accel, sort_origin, sort_dir, o.device)
    kind = "resident_any_hit" if any_hit else "resident_closest"
    t, tri, hit = _outputs(o)
    with torch.cuda.device(o.device):
        rc = kernel_lib().tr_intersect_packet_resident(
            o.data_ptr(), d.data_ptr(), None if t_init is None else t_init.data_ptr(),
            o.shape[0], float(min(t_max, BIG)), accel.corners.data_ptr(),
            accel.chunk_aabb.data_ptr(), accel.super_aabb.data_ptr(), order.data_ptr(),
            accel.super_aabb.shape[0], accel.perm.data_ptr(), accel.perm.shape[0],
            int(any_hit), t.data_ptr(), tri.data_ptr(), hit.data_ptr(),
            _counted(o.device, kind).data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    check_launch("intersect_packet", rc)
    LAUNCHES[kind] += 1
    return TriHit(t, tri, hit)


def any_hit_packet(accel: PacketAccel, o, d, t_max: float = BIG) -> torch.Tensor:
    return intersect_packet(accel, o, d, t_max=t_max, any_hit=True).hit


def accel_bytes(accel: PacketAccel) -> int:
    """Bytes of an accel's corners and boxes, as the routing budget counts."""
    return 4 * (accel.corners.numel() + accel.chunk_aabb.numel()
                + accel.super_aabb.numel())


def fold_hits(best: TriHit | None, res: TriHit, any_hit: bool) -> TriHit:
    """Merge one part's (or ring shard's) hits into the running result: a
    strictly smaller t wins; any-hit ORs the hits."""
    if best is None:
        return res
    if any_hit:
        hit = best.hit | res.hit
        return TriHit(torch.where(best.hit, best.t, res.t),
                      torch.where(hit, 0, -1).to(torch.int32), hit)
    better = res.hit & (res.t < best.t)
    return TriHit(torch.where(better, res.t, best.t), torch.where(better, res.tri, best.tri),
                  best.hit | res.hit)


def running_t(best: TriHit, t_max: float, any_hit: bool) -> torch.Tensor:
    """The seed of the next part or ring step: the running best t, or for
    any-hit 0 where a blocker was found and t_max elsewhere."""
    if any_hit:
        return torch.where(best.hit, 0.0, torch.full_like(best.t, t_max))
    return torch.clamp_max(best.t, t_max)


def intersect_packet_parts(parts, o, d, *, t_max: float = BIG, any_hit: bool = False,
                           sort_origin=None, sort_dir=None, t_init=None) -> TriHit:
    """Closest-hit (or any-hit) over a list of accel parts, walked in
    sequence with the running best t threaded into each next part's seed
    (counterpart of the reference's `intersect_packet_parts`). A single
    part, or a part over VMEM_BUDGET_BYTES, goes to the streamed kernel #3;
    the parts of a split mesh to the resident kernel #4 with the sort hints.
    t_init also seeds the first part (the SDF hit t, or 0 for a decided
    shadow) and bounds every later seed."""
    best = None
    t_run = t_init
    for accel in parts:
        if len(parts) == 1 or accel_bytes(accel) > VMEM_BUDGET_BYTES:
            res = intersect_packet_streamed(accel, o, d, t_max=t_max, any_hit=any_hit,
                                            t_init=t_run)
        else:
            res = intersect_packet(accel, o, d, t_max=t_max, any_hit=any_hit,
                                   sort_origin=sort_origin, sort_dir=sort_dir,
                                   t_init=t_run)
        best = fold_hits(best, res, any_hit)
        if len(parts) > 1:
            t_run = running_t(best, t_max, any_hit)
            if t_init is not None:  # keep the caller's bound where unimproved
                t_run = torch.minimum(t_run, t_init)
    return best


def _check(accel: PacketAccel, o, d, t_init, name: str) -> None:
    check_cuda_inputs(name, o, d, t_init, accel.corners, accel.chunk_aabb,
                      accel.super_aabb, accel.tree)
    if accel.perm.device != o.device or accel.perm.dtype != torch.int32:
        raise ValueError(f"{name}: perm must be int32 on the rays' device")
    if accel.corners.data_ptr() % 16:
        raise ValueError(f"{name}: the corners must be 16-byte aligned (cp.async)")


def _counted(device, kind: str) -> torch.Tensor:
    """The counters a launch adds to: the process's own for (device, kind),
    made here at the first launch. That launch may not be a capture's: the
    tensor and its zeroing would belong to the graph."""
    buf = _WALK.get((device, kind))
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"cuda_mt: the first {kind} walk on {device} is being "
                               "captured: warm the graph up first")
        buf = _WALK[(device, kind)] = torch.zeros(len(COUNTERS), dtype=torch.int64,
                                                  device=device)
    return buf


def walk_counters() -> types.MappingProxyType:
    """A read-only snapshot of what the walks did in this process, by
    LAUNCHES kind ({kind: {counter: n}}, summed over devices; empty before
    the first launch on a CUDA device: the plain versions count nothing).
    Waits for each device's work."""
    out = {}
    for (device, kind), buf in _WALK.items():
        torch.cuda.synchronize(device)
        got = out.setdefault(kind, dict.fromkeys(COUNTERS, 0))
        for name, n in zip(COUNTERS, buf.tolist()):
            got[name] += n
    return types.MappingProxyType({k: types.MappingProxyType(v) for k, v in out.items()})


def _outputs(o):
    R, dev = o.shape[0], o.device
    return (torch.empty(R, dtype=torch.float32, device=dev),
            torch.empty(R, dtype=torch.int32, device=dev),
            torch.empty(R, dtype=torch.bool, device=dev))
