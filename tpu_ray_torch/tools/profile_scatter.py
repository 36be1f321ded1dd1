"""The vertex gradient's scatter chain, piece by piece (counterpart of
`tools/profile_scatter.py`).

    python -m tpu_ray_torch.tools.profile_scatter [--device cpu]

The `mixed` backward's vertex gradient: a block's cotangent of its (R, 9)
gathered corners (`cuda_scatter.shade_corners` in
render.shade_with_residuals) sums by triangle into the (T, 10) table's;
once a frame the table's cotangent scatter-adds by vertex
(render.mesh_table's backward). At the reference tool's sizes and index
sets (R = 32,768 rays a block, T = 70,000 triangles, V = 35,000 vertices;
numpy's default_rng(0)): a block whose rays hit 2,000 neighbouring
triangles (`local`) or any of them (`uniform`); one real `mixed` block's
triangle ids into its own table (the frame's middle block, its misses
clamped to triangle 0 as the shade clamps them); 8 and 64 blocks' worth in
one scatter; the table's backward; the reference's "90 B/ray" read and
write of one block ((R, 24) float32) for scale. Per frame: times `mixed`'s
block count, -(-primary rays // block size).

Each scatter is timed twice: the port's (`cuda_scatter.corner_scatter`,
the gather's backward from the cotangent to the (T, 10) gradient: the
kernels on the card, the plain version on the CPU), and torch's autograd
of the indexing `rows[idx][:, :9]` (`gather_backward`: the sorted
`index_put_` the port ran before it had the kernels, which it no longer
calls: the yardstick, `library`).

Times: host clock, synchronized, the best of 10 after 2 warm-ups (the
port's includes its wrapper's host-side check of the ids, which waits for
the device); on the card also the port's device time a call (`device_ms`:
CUDA events around a CUDA graph of 20 calls, as the main path replays it).
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

from tpu_ray_torch import tools
from tpu_ray_torch.bench import require_device
from tpu_ray_torch.kernels import cuda_scatter
from tpu_ray_torch.render import render as R
from tpu_ray_torch.utils.metrics import block_and_time

R_BLOCK = 1 << 15
T = 70_000
V = 35_000
WARMUP, ITERS = 2, 10


def frame_blocks(cfg) -> int:
    """Blocks in a frame: its primary samples over the block size (shadow
    rays are not samples)."""
    return -(-cfg.num_rays // cfg.block_size) if cfg.block_size else 1


def gather_backward(rows: torch.Tensor, idx: torch.Tensor, ct: torch.Tensor):
    """The cotangent of the (T, 10) table `rows` from the cotangent `ct` of
    rows[idx][:, :9], through torch's autograd of the indexing: the
    yardstick beside cuda_scatter.corner_scatter."""
    return torch.autograd.grad(rows[idx][:, :9].contiguous(), rows, ct)[0]


def device_ms(fn, device: torch.device, calls: int = 20):
    """fn's device ms a call inside a CUDA graph of `calls` calls, as the
    main path replays the scatter (the wrapper's host-side checks are
    skipped under capture), after the warm-ups; None off a CUDA device."""
    if device.type != "cuda":
        return None
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / calls


def table_backward(verts: torch.Tensor, tris: torch.Tensor, ct: torch.Tensor):
    """The cotangent of the (V, 3) vertices from the cotangent `ct` of
    render.mesh_table's (T, 10) table, through autograd."""
    mesh = types.SimpleNamespace(verts=verts, tris=tris,
                                 tri_mat=torch.zeros(tris.shape[0], dtype=torch.int32,
                                                     device=tris.device))
    return torch.autograd.grad(R.mesh_table(mesh), verts, ct)[0]


def _time(fn) -> float:
    return block_and_time(fn, warmup=WARMUP, iters=ITERS)[1]


def real_block(device, **changes):
    """`mixed`'s middle block as the frame renders it (changes: fields of
    its RenderConfig replaced, as the silhouette path's) -> its triangle
    ids (clamped as the shade clamps them), its hit share, the block's
    index, the frame's block count and the mesh's triangle count."""
    from tpu_ray_torch.kernels import cuda_shade
    from tpu_ray_torch.render.camera import generate_rays
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.tools.profile_stages import frame_of

    scene, cfg = build_scene("mixed", device=device)
    cfg = cfg.replace(**changes)
    fr = frame_of(scene, cfg)
    b = fr.n_blocks // 2
    g, s = divmod(b, R.MARCH_GROUP)
    gx, gy = fr.group(g)
    sl = slice(s * fr.bs, (s + 1) * fr.bs)
    with torch.no_grad():
        packed = cuda_shade.pack(fr.scene, R._bound_pad(cfg))
        march = R.march_group(fr.scene, cfg, gx, gy, packed, fr.bs)
        o, d = generate_rays(fr.scene.camera, gx[sl], gy[sl], cfg.width, cfg.height)
        res = R.geometry_residuals(fr.scene, cfg.replace(shadow="none"), o, d, fr.method,
                                   march=tuple(v[sl] for v in march), packed=packed)
    tri = torch.clamp(res["mesh_tri"], 0, scene.mesh.num_tris - 1).long()
    return (tri, float(res["mesh_hit"].float().mean()), b, frame_blocks(cfg),
            scene.mesh.num_tris)


def main(device="cuda", log=print) -> dict:
    device = require_device(device, "tpu_ray_torch.tools.profile_scatter")
    info = tools.card(device)
    tri, hit_share, b, n_blocks, n_tris = real_block(device)
    log(f"[profile_scatter] R {R_BLOCK} rays a block, T {T}, V {V}; `mixed` "
        f"{n_blocks} blocks a frame {tools.card_line(info)}")
    rng = np.random.default_rng(0)
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    idx_local = as_t(rng.integers(0, 2000, R_BLOCK) + 30_000, torch.long)
    idx_uniform = as_t(rng.integers(0, T, R_BLOCK), torch.long)
    d = as_t(rng.standard_normal((R_BLOCK, 9), np.float32))
    tris = as_t(rng.integers(0, V, (T, 3)), torch.int32)
    dt = as_t(rng.standard_normal((T, 10), np.float32))
    rows = torch.zeros((T, 10), device=device, requires_grad=True)
    out = {"tool": "profile_scatter", **info, "rays_a_block": R_BLOCK, "triangles": T,
           "vertices": V, "mixed_blocks": n_blocks, "scatter": {}, "batched": {}}

    def timed(tag, rows_, idx, ct, blocks=1):
        ids = idx.to(torch.int32)  # as the shade hands them over
        s = _time(lambda: cuda_scatter.corner_scatter(ct, ids, rows_.shape[0]))
        lib = _time(lambda: gather_backward(rows_, idx, ct))
        dev = device_ms(lambda: cuda_scatter.corner_scatter(ct, ids, rows_.shape[0]), device)
        got = {"ms": s * 1e3, "ms_a_block": s / blocks * 1e3, "device_ms": dev,
               "library_ms": lib * 1e3, "seconds_a_frame": s / blocks * n_blocks}
        log(f"scatter R->T [{tag}]  {s * 1e3:7.3f} ms (device "
            f"{'not measured' if dev is None else f'{dev:.4f} ms'}; torch's index backward "
            f"{lib * 1e3:7.3f} ms) = {s / blocks * 1e3:7.3f} ms/block x {n_blocks} blocks = "
            f"{s / blocks * n_blocks:6.2f}s/frame")
        return got

    for tag, idx in (("local", idx_local), ("uniform", idx_uniform)):
        out["scatter"][tag] = timed(tag, rows, idx, d)
    mesh_rows = torch.zeros((n_tris, 10), device=device, requires_grad=True)
    out["scatter"]["mixed_block"] = dict(
        timed(f"mixed block {b}, hit share {hit_share:.4f}", mesh_rows, tri,
              d[:tri.shape[0]].contiguous()),
        block=b, rays=tri.shape[0], hit_share=hit_share, triangles=n_tris)
    for k in (8, 64):
        dk = as_t(rng.standard_normal((k * R_BLOCK, 9), np.float32))
        ik = as_t(rng.integers(0, T, k * R_BLOCK), torch.long)
        out["batched"][str(k)] = timed(f"{k}-block batch", rows, ik, dk, blocks=k)
    verts = torch.zeros((V, 3), device=device, requires_grad=True)
    s = _time(lambda: table_backward(verts, tris, dt))
    out["table_backward_ms"] = s * 1e3
    log(f"T->V conversion (once/frame) {s * 1e3:7.3f} ms")
    x = as_t(rng.standard_normal((R_BLOCK, 24), np.float32))  # 96 B a ray
    s = _time(lambda: x * 1.000001)
    out["roundtrip_ms"] = s * 1e3
    log(f"90B/ray roundtrip ref        {s * 1e3:7.3f} ms/block")
    return out


def cli(argv=None):
    args = tools.parser("profile_scatter", __doc__).parse_args(argv)
    tools.emit(main(args.device))


if __name__ == "__main__":
    sys.exit(cli())
