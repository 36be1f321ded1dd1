"""Packet accel: Morton-sorted 128-triangle chunks under a two-level AABB
hierarchy, the structure the packet intersection kernel walks.

Counterpart of the numpy build in `tpu_ray/accel/packet.py`, with the same
layout, Morton order and `perm`, so the CUDA kernel's triangle slots compare
one for one with the reference's:

  corners    (C*16, 128) f32  rows ci*16 .. ci*16+8 hold v0.xyz, e1.xyz,
                              e2.xyz of chunk ci (lane = triangle in chunk);
                              rows +9 .. +15 are zero
  chunk_aabb (C, 128)    f32  row ci lanes 0..5 = lo.xyz, hi.xyz
  super_aabb (S, 128)    f32  the union of SUPER consecutive chunk boxes
  perm       (Tpad,)   int32  sorted slot -> original triangle id (-1 pad)
  tree       (N, 8)      f32  the 16-ary tree over the supers (`super_tree`):
                              lanes 0..5 = lo.xyz, hi.xyz of each node, level
                              1 (the union of SUPER consecutive supers) first,
                              up to the root; derived from super_aabb

C is padded to S * SUPER with never-hit boxes and degenerate triangles.
The structure selects hits only; they are recomputed from the mesh.

`build_packet_parts` builds a mesh as a list of such accels: one
whole-mesh accel by default, or, with `streamed=False`, Morton-contiguous
parts under `VMEM_BUDGET_BYTES` that `cuda_mt.intersect_packet_parts`
walks in sequence.

An accel is built by the native C++ builder (tpu_ray_torch/native), bit for
bit the numpy build `_numpy_build`, which runs only when the switch
TPU_RAY_TORCH_NATIVE=0 asks for it; a failed native build raises. Meshes of
at least CACHE_MIN_TRIS triangles go through a disk cache of the built
parts, keyed by a hash of the vertices and triangles, the budget and
`streamed`: in TPU_RAY_TORCH_CACHE_DIR, by default build/tpu_ray_torch/
accel_cache at the repository root ("" turns it off). A cache file is
written through a per-process temporary file and renamed; a corrupt file is
ignored and rebuilt, and a directory that cannot be written never stops a
build.

Tracing: `build_packet_parts` runs inside the host span `accel.build`
(utils/metrics.py) and adds to its counters (`build_counters()`): calls,
triangles, chunks and supers of the parts, their bytes on the device, host
seconds, and the disk cache's hits and misses (a mesh under CACHE_MIN_TRIS
is neither).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import types
import zipfile
from pathlib import Path

import numpy as np
import torch

from tpu_ray_torch import native
from tpu_ray_torch.utils.metrics import span

CHUNK = 128  # triangles per chunk
ROWS_PER_CHUNK = 16  # 9 data rows (v0/e1/e2 xyz) + 7 pad
SUPER = 16  # chunks per super-chunk

# The reference's VMEM budget for the resident kernel's arrays. Here it is
# only the split and routing rule, kept so that both packages split a mesh
# into the same parts and launch the resident kernel (#4) at the same call
# sites; it says nothing about the H100's memory.
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
# the reference's limit of exact float32 triangle slots: streamed parts of a
# larger mesh stay below it. The port's slots are int32 and need no limit; it
# keeps this one only so that both packages build the same parts.
TRI_SLOT_LIMIT = 2 ** 24
# meshes from this many triangles go through the disk cache (the reference's
# threshold: the host build only costs seconds above it)
CACHE_MIN_TRIS = 100_000
CACHE_ENV = "TPU_RAY_TORCH_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_ray_torch" / "accel_cache"
_FIELDS = ("corners", "chunk_aabb", "super_aabb", "perm")
# what build_packet_parts did in this process, updated in place
BUILD_KEYS = ("builds", "triangles", "chunks", "supers", "bytes", "seconds", "cache_hits",
              "cache_misses")
_BUILDS = dict.fromkeys(BUILD_KEYS, 0)


def build_counters() -> types.MappingProxyType:
    """A read-only snapshot of build_packet_parts' counts in this process:
    its calls, the triangles of their meshes, the chunks and supers of the
    parts (padding included), their bytes on the device (corners, boxes and
    perm), the host seconds inside it (building or loading, and the copy to
    the device), and the disk cache's hits and misses."""
    return types.MappingProxyType(dict(_BUILDS))


def super_tree(super_aabb: torch.Tensor) -> torch.Tensor:
    """The (N, 8) float32 boxes of the 16-ary tree over the supers that #3
    walks (csrc/packet_mt.cu): node i of level 1 is the union of supers
    16i .. 16i+15, node i of level L+1 that of level-L nodes 16i .. 16i+15,
    up to a level of one node, the root. Rows: level 1, then 2, ..., the
    root last; lanes 0..5 lo.xyz, hi.xyz, exact float32 min and max, so
    every node's box holds its children's bit for bit. S supers give
    ceil(S / 16) level-1 nodes (`knot8m`'s 4,097: 257 + 17 + 2 + 1 rows)."""
    with torch.no_grad():
        box = super_aabb[:, 0:6]
        levels = []
        while not levels or box.shape[0] > 1:
            n = box.shape[0]
            m = -(-n // SUPER)
            # the last child repeated: its min and max leave the node's as they are
            kids = torch.cat([box, box[-1:].expand(m * SUPER - n, 6)]).reshape(m, SUPER, 6)
            box = torch.cat([kids[..., 0:3].amin(1), kids[..., 3:6].amax(1)], 1)
            levels.append(box)
        return torch.nn.functional.pad(torch.cat(levels), (0, 2)).contiguous()


@dataclasses.dataclass
class PacketAccel:
    corners: torch.Tensor  # (C*16, 128) float32
    chunk_aabb: torch.Tensor  # (C, 128) float32
    super_aabb: torch.Tensor  # (S, 128) float32
    perm: torch.Tensor  # (Tpad,) int32
    num_tris: int = 0
    # super_tree(super_aabb), derived at every construction, dataclasses.replace
    # included, and never passed in: no accel holds the tree of other boxes
    tree: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.tree = super_tree(self.super_aabb)

    @classmethod
    def carrying(cls, tree: torch.Tensor, **fields) -> "PacketAccel":
        """An accel whose tree travels with its boxes, set and not derived:
        a ring step's shard, rotated with its tree (dist/scene_shard.py), so
        that no tree work runs inside a block."""
        accel = cls.__new__(cls)
        accel.__dict__.update(fields, tree=tree)
        return accel


def _morton3(x: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave 3x bits-bit ints into Morton codes. x: (N, 3) ints."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    return (spread(x[:, 0]) << np.uint64(2)) | (spread(x[:, 1]) << np.uint64(1)) | spread(x[:, 2])


def packet_accel_bytes(num_tris: int) -> int:
    """Bytes of the corners and the chunk and super boxes of a mesh of
    num_tris triangles (whole supers)."""
    chunks = -(-num_tris // CHUNK)
    supers = -(-chunks // SUPER)
    chunks_padded = supers * SUPER
    return chunks_padded * ROWS_PER_CHUNK * CHUNK * 4 + (chunks_padded + supers) * 128 * 4


def fits_vmem(num_tris: int) -> bool:
    return packet_accel_bytes(num_tris) <= VMEM_BUDGET_BYTES


def _morton_order(verts64: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Stable Morton ordering of triangle indices by quantized centroid."""
    centroid = verts64[tris].mean(1)
    lo = centroid.min(0)
    extent = np.maximum(centroid.max(0) - lo, 1e-12)
    q = np.clip(((centroid - lo) / extent * 1023).astype(np.int64), 0, 1023)
    return np.argsort(_morton3(q), kind="stable")


def _to_accel(arrays: dict, num_tris: int, device) -> PacketAccel:
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return PacketAccel(corners=t(arrays["corners"].astype(np.float32, copy=False)),
                       chunk_aabb=t(arrays["chunk_aabb"].astype(np.float32, copy=False)),
                       super_aabb=t(arrays["super_aabb"].astype(np.float32, copy=False)),
                       perm=t(arrays["perm"].astype(np.int32, copy=False)), num_tris=num_tris)


def _numpy_build(verts: np.ndarray, tris: np.ndarray, tri_id_base=None) -> dict:
    """The numpy build of one accel of T > 0 triangles (the reference's
    numpy path): the arrays of PacketAccel."""
    T = tris.shape[0]
    big = 1e10
    tv = verts[tris]  # (T, 3, 3)
    order = _morton_order(verts, tris)
    tv = tv[order]
    Tpad = -(-T // CHUNK) * CHUNK
    pad = Tpad - T
    if pad:
        tv = np.concatenate([tv, np.zeros((pad, 3, 3))], 0)  # degenerate pad
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    data9 = np.concatenate([v0.T, e1.T, e2.T], 0)  # (9, Tpad)

    C = Tpad // CHUNK
    S = -(-C // SUPER)
    C_pad = S * SUPER
    corners = np.zeros((C_pad, ROWS_PER_CHUNK, CHUNK), np.float32)
    corners[:C, :9] = data9.reshape(9, C, CHUNK).transpose(1, 0, 2)

    tmin = tv.min(1).reshape(C, CHUNK, 3)
    tmax = tv.max(1).reshape(C, CHUNK, 3)
    # padded (degenerate-at-origin) triangles must not inflate the boxes
    valid = np.concatenate([np.ones(T, bool), np.zeros(pad, bool)]).reshape(C, CHUNK)
    lo_c = np.where(valid[..., None], tmin, big).min(1)  # (C, 3)
    hi_c = np.where(valid[..., None], tmax, -big).max(1)
    aabb = np.zeros((C_pad, 128), np.float32)
    aabb[:C, 0:3] = lo_c
    aabb[:C, 3:6] = hi_c
    aabb[C:, 0:3] = big
    aabb[C:, 3:6] = -big

    lo_p = np.full((C_pad, 3), big, np.float32)
    hi_p = np.full((C_pad, 3), -big, np.float32)
    lo_p[:C], hi_p[:C] = lo_c, hi_c
    sup = np.zeros((S, 128), np.float32)
    sup[:, 0:3] = lo_p.reshape(S, SUPER, 3).min(1)
    sup[:, 3:6] = hi_p.reshape(S, SUPER, 3).max(1)

    ids = order if tri_id_base is None else np.asarray(tri_id_base)[order]
    perm = np.concatenate([ids, np.full(pad, -1, np.int64)]).astype(np.int32)
    return dict(corners=corners.reshape(C_pad * ROWS_PER_CHUNK, CHUNK), chunk_aabb=aabb,
                super_aabb=sup, perm=perm)


def build_packet_accel(verts: np.ndarray, tris: np.ndarray,
                       tri_id_base: np.ndarray | None = None,
                       device="cpu") -> PacketAccel:
    """Build one accel on the host (natively unless TPU_RAY_TORCH_NATIVE=0)
    and move it to `device`. tri_id_base: the (T,) original triangle ids of
    a subset of a mesh (identity if omitted), which `perm` then maps to."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    T = tris.shape[0]
    if T == 0:
        aabb = np.zeros((1, 128), np.float32)
        aabb[0, :3] = 1e10
        aabb[0, 3:6] = -1e10
        return _to_accel(dict(corners=np.zeros((ROWS_PER_CHUNK, CHUNK)), chunk_aabb=aabb,
                              super_aabb=aabb, perm=np.full((CHUNK,), -1)), 0, device)
    build = native.build_accel if native.enabled() else _numpy_build
    return _to_accel(build(verts, tris, tri_id_base), T, device)


def cache_dir() -> str:
    """The accel cache's directory ("" when TPU_RAY_TORCH_CACHE_DIR turns it off)."""
    return os.environ.get(CACHE_ENV, str(DEFAULT_CACHE_DIR))


def _cache_path(verts: np.ndarray, tris: np.ndarray, budget_bytes: int, streamed) -> str | None:
    d = cache_dir()
    if not d:
        return None
    h = hashlib.sha1(b"tpu_ray_torch-packet-accel-v1")
    h.update(np.ascontiguousarray(verts, np.float64).tobytes())
    h.update(np.ascontiguousarray(tris, np.int64).tobytes())
    h.update(f"{budget_bytes}|{streamed}".encode())
    return os.path.join(d, f"accel_{h.hexdigest()}.npz")


def _save_parts(path: str, parts: list) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"n_parts": np.asarray(len(parts))}
    for i, a in enumerate(parts):
        for name in _FIELDS:
            payload[f"{name}_{i}"] = getattr(a, name).cpu().numpy()
        payload[f"num_tris_{i}"] = np.asarray(a.num_tris)
    # one temporary file per writer: concurrent builders each publish whole
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:  # a file handle: savez must not append .npz
            np.savez(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_parts(path: str, device) -> list | None:
    """The cached parts, or None when the file is missing or unreadable."""
    try:
        with np.load(path) as z:
            return [_to_accel({name: z[f"{name}_{i}"] for name in _FIELDS},
                              int(z[f"num_tris_{i}"]), device)
                    for i in range(int(z["n_parts"]))]
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # a missing or corrupt file is rebuilt


def build_packet_parts(verts: np.ndarray, tris: np.ndarray,
                       budget_bytes: int = VMEM_BUDGET_BYTES,
                       streamed: bool | None = None, device="cuda") -> list:
    """The packet accel of a mesh of any size, as a list of parts
    (counterpart of the reference's `build_packet_parts`):

      * a mesh under `budget_bytes`: one part;
      * larger, `streamed` True or None: one whole-mesh part, or, past
        TRI_SLOT_LIMIT slots, Morton-contiguous parts just below it;
      * larger, `streamed=False`: Morton-contiguous parts of as many whole
        supers as fit the budget, walked in sequence with the running best
        t (`cuda_mt.intersect_packet_parts`).

    A mesh of CACHE_MIN_TRIS triangles or more is read from the disk cache
    when it holds its parts, and written to it otherwise. The span
    `accel.build`; counted in build_counters().
    """
    t0 = time.perf_counter()
    with span("accel.build"):
        tris = np.asarray(tris, np.int64).reshape(-1, 3)
        T = tris.shape[0]
        path = _cache_path(verts, tris, budget_bytes, streamed) if T >= CACHE_MIN_TRIS else None
        parts = None if path is None else _load_parts(path, device)
        if path is not None:
            _BUILDS["cache_hits" if parts is not None else "cache_misses"] += 1
        if parts is None:
            parts = _build_parts(verts, tris, budget_bytes, streamed, device)
            if path is not None:
                try:
                    _save_parts(path, parts)
                except OSError:
                    pass  # a directory that cannot be written never stops a build
    _BUILDS["builds"] += 1
    _BUILDS["triangles"] += T
    for a in parts:
        _BUILDS["chunks"] += a.chunk_aabb.shape[0]
        _BUILDS["supers"] += a.super_aabb.shape[0]
        _BUILDS["bytes"] += sum(getattr(a, f).numel() * getattr(a, f).element_size()
                                for f in _FIELDS)
    _BUILDS["seconds"] += time.perf_counter() - t0
    return parts


def _build_parts(verts, tris, budget_bytes, streamed, device) -> list:
    T = tris.shape[0]
    build = lambda sel=None: build_packet_accel(
        verts, tris if sel is None else tris[sel], tri_id_base=sel, device=device)
    if packet_accel_bytes(T) <= budget_bytes:
        return [build()]
    if streamed or streamed is None:
        if -(-T // CHUNK) * CHUNK < TRI_SLOT_LIMIT:
            return [build()]
        part_tris = TRI_SLOT_LIMIT - CHUNK * SUPER  # whole supers below the limit
    else:
        per_super = CHUNK * SUPER
        if packet_accel_bytes(per_super) > budget_bytes:
            raise ValueError(
                f"budget_bytes={budget_bytes} is below one super-chunk's footprint "
                f"({packet_accel_bytes(per_super)} bytes); cannot split smaller")
        max_supers = 1
        while packet_accel_bytes((max_supers + 1) * per_super) <= budget_bytes:
            max_supers += 1
        part_tris = max_supers * per_super
    order = _morton_order(np.asarray(verts, np.float64), tris)
    return [build(order[s:s + part_tris]) for s in range(0, T, part_tris)]


def refit_packet_accel(accel: PacketAccel, verts: torch.Tensor,
                       tris: torch.Tensor) -> PacketAccel:
    """Recompute corners and the chunk/super AABBs from the current vertex
    positions, keeping the build's Morton chunk order (counterpart of the
    reference's `refit_packet_accel`). Plain tensor ops on the accel's
    device, never differentiated: a vertex fit then walks an accel that is
    exact for the moved vertices (only its culls loosen as they drift)."""
    with torch.no_grad():
        C = accel.chunk_aabb.shape[0]
        perm = accel.perm.long()
        if perm.shape[0] < C * CHUNK:  # perm is not padded to whole supers
            perm = torch.cat([perm, perm.new_full((C * CHUNK - perm.shape[0],), -1)])
        valid = perm >= 0
        idx = torch.clamp(perm, 0, max(tris.shape[0] - 1, 0))
        tv = verts.detach()[tris.long()[idx]]  # (C*CHUNK, 3, 3)
        tv = torch.where(valid[:, None, None], tv, torch.zeros_like(tv))
        v0, e1, e2 = tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
        rows = torch.cat([v0.T, e1.T, e2.T], 0).reshape(9, C, CHUNK).permute(1, 0, 2)
        corners = torch.cat([rows, rows.new_zeros((C, ROWS_PER_CHUNK - 9, CHUNK))], 1)
        big = 1e10
        lo = torch.where(valid[:, None], tv.amin(1), big).reshape(C, CHUNK, 3).amin(1)
        hi = torch.where(valid[:, None], tv.amax(1), -big).reshape(C, CHUNK, 3).amax(1)
        chunk_aabb = lo.new_zeros((C, 128))
        chunk_aabb[:, 0:3], chunk_aabb[:, 3:6] = lo, hi
        S = accel.super_aabb.shape[0]  # C == S * SUPER
        super_aabb = lo.new_zeros((S, 128))
        super_aabb[:, 0:3] = lo.reshape(S, SUPER, 3).amin(1)
        super_aabb[:, 3:6] = hi.reshape(S, SUPER, 3).amax(1)
        f32 = lambda x: x.to(torch.float32).contiguous()
        return dataclasses.replace(
            accel, corners=f32(corners.reshape(C * ROWS_PER_CHUNK, CHUNK)),
            chunk_aabb=f32(chunk_aabb), super_aabb=f32(super_aabb))
