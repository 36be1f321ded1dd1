"""Packet-accel mesh intersection: CUDA kernel and its plain version.

Counterpart of `tpu_ray/kernels/pallas_mt.py` (`intersect_packet_streamed`,
closest-hit and any-hit). Kernel: `csrc/packet_mt.cu`.

Dispatch follows the device: `intersect_packet` runs
`intersect_packet_torch` on CPU tensors and launches the kernel on CUDA
tensors, raising on what the kernel does not take. Each kernel launch adds
one to `LAUNCHES["closest"]` or `LAUNCHES["any_hit"]`.

Semantics shared by both versions: best t starts at min(t_init, t_far); a
triangle counts with t in (T_MIN, t_far) for the static t_far; only strictly
better hits are recorded, so a tie keeps the lowest sorted slot; sorted
slots map to triangle ids through `perm`. Any-hit reports only whether some
blocker exists: t is BIG and tri is 0 on a hit lane, -1 elsewhere.
"""

from __future__ import annotations

import torch

from tpu_ray_torch.accel.packet import CHUNK, ROWS_PER_CHUNK, PacketAccel
from tpu_ray_torch.kernels.build import check_cuda_inputs, check_launch, kernel_lib
from tpu_ray_torch.kernels.moller_trumbore import BIG, TriHit, _DET_EPS, _T_MIN

LAUNCHES = {"closest": 0, "any_hit": 0}

# ray x triangle pairs per step of the plain version (bounds its temporaries)
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


def intersect_packet_torch(accel: PacketAccel, o, d, *, t_max: float = BIG,
                           any_hit: bool = False, t_init=None) -> TriHit:
    """Brute MT over the accel's sorted triangle slots, in blocks of rays and
    slots: the same function the kernel computes, without its culls."""
    t_far = float(min(t_max, BIG))
    R = o.shape[0]
    C = accel.chunk_aabb.shape[0]
    data = (accel.corners.reshape(C, ROWS_PER_CHUNK, CHUNK)[:, :9]
            .permute(1, 0, 2).reshape(9, C * CHUNK))  # (9, slots)
    best0 = (torch.full((R,), t_far, dtype=o.dtype, device=o.device)
             if t_init is None else torch.clamp_max(t_init, t_far))
    rb = min(max(R, 1), 8192)
    sb = max(CHUNK, (_PAIRS_PER_STEP // rb) // CHUNK * CHUNK)
    best_out, slot_out = [], []
    for r0 in range(0, R, rb):
        ox, oy, oz = (o[r0:r0 + rb, k, None] for k in range(3))
        dx, dy, dz = (d[r0:r0 + rb, k, None] for k in range(3))
        best = best0[r0:r0 + rb]
        slot = torch.full_like(best, -1, dtype=torch.int32)
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
            better = tc < best  # strictly: the lowest slot keeps a tie
            best = torch.where(better, tc, best)
            slot = torch.where(better, (ic + s0).to(torch.int32), slot)
        best_out.append(best)
        slot_out.append(slot)
    return _finalize(torch.cat(best_out), torch.cat(slot_out), accel, any_hit)


def intersect_packet(accel: PacketAccel, o, d, *, t_max: float = BIG,
                     any_hit: bool = False, t_init=None) -> TriHit:
    """Closest-hit (or any-hit) of (R,3) rays against the packet accel."""
    if o.device.type == "cpu":
        return intersect_packet_torch(accel, o, d, t_max=t_max,
                                      any_hit=any_hit, t_init=t_init)
    check_cuda_inputs("intersect_packet", o, d, t_init, accel.corners,
                      accel.chunk_aabb, accel.super_aabb)
    if accel.perm.device != o.device or accel.perm.dtype != torch.int32:
        raise ValueError("intersect_packet: perm must be int32 on the rays' device")
    R = o.shape[0]
    dev = o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    lib = kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.tr_intersect_packet(
            o.data_ptr(), d.data_ptr(), None if t_init is None else t_init.data_ptr(),
            R, float(min(t_max, BIG)), accel.corners.data_ptr(),
            accel.chunk_aabb.data_ptr(), accel.super_aabb.data_ptr(),
            accel.super_aabb.shape[0], accel.perm.data_ptr(), accel.perm.shape[0],
            int(any_hit), t.data_ptr(), tri.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("intersect_packet", rc)
    LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return TriHit(t, tri, hit)
