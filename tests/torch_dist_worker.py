"""One gloo process of the port's distributed tests (tests/test_torch_dist.py).
Not a pytest module; imports only torch, numpy and the port:

    python torch_dist_worker.py <init file> <rank> <world size> <io dir>

Reads <io dir>/inputs.npz (written by the test), joins the process group
through the `file://` store, runs every case below and writes what it
computed to <io dir>/out_<rank>.npz:

  psum_*        psum_buckets over 2 buckets, and one all_reduce per leaf
  ring_*        intersect_ring on this rank's slice of the rays
  img_<case>    render_image_sharded frames (every rank gathers the frame)
  jit_<case>    the same frames through render_image_sharded_jit (the
                per-block graphs' plan, run uncaptured on the CPU)
  band_<case>   render_image_sharded(gather=False): this rank's band of rows,
                written with write_image_per_host to <io dir>/<case>.pNNN.png
                (and the gathered frame to <io dir>/<case>.png by rank 0)
  bandjit_<case> render_image_sharded_jit(gather=False): the same band
  fit_<case>_*  the loss and the parameters after one sharded SGD step (the
                graphed step, make_sharded_fit_step)
  plans_named_* the graph plans whose key names a process group, before and
                after multihost.destroy
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_ray_torch.dist.grad_allreduce import psum_buckets  # noqa: E402
from tpu_ray_torch.dist.multihost import (destroy, initialize, world,  # noqa: E402
                                          write_image_per_host)
from tpu_ray_torch.dist.scene_shard import intersect_ring, partition_mesh  # noqa: E402
from tpu_ray_torch.dist.sharding import (render_image_sharded,  # noqa: E402
                                         render_image_sharded_jit)
from tpu_ray_torch.fit import extract_params, make_sharded_fit_step  # noqa: E402
from tpu_ray_torch.render import graphs  # noqa: E402
from tpu_ray_torch.scene.scenes import build_scene  # noqa: E402

# (case, scene, config overrides, scene_shards): the frames the test holds
# against the reference's single-device render
RENDERS = (("triangles", "triangles", dict(width=16, height=16), False),
           ("triangles_ring", "triangles", dict(width=16, height=16), True),
           ("mixed", "mixed", dict(width=16, height=16, spp=1, max_steps=64), False),
           ("mixed_ring", "mixed", dict(width=16, height=16, spp=1, max_steps=64), True))
# (case, scene, config overrides, scene_shards): the frames rendered twice,
# gathered and as per-rank bands of rows; 13 rows split unevenly (2 ranks: 7
# and 6 rows, 4 ranks: 4, 4, 4 and 1) and do not divide into 8x8 blocks
BANDS = (("triangles", "triangles", dict(width=16, height=16), False),
         ("triangles_odd", "triangles", dict(width=16, height=13), False),
         ("mixed_ring", "mixed", dict(width=16, height=16, spp=1, max_steps=64), True))
# (case, scene_shards, start from the moved vertices): the fit steps of
# `triangles` (mesh.verts, camera.origin), 12x12, no shadows
FITS = (("replicated", False, False), ("ring", True, False), ("ring_moved", True, True))
FIT_CFG = dict(width=12, height=12, block_size=0, shadow="none")
FIT_PATHS = ("mesh.verts", "camera.origin")
FIT_LR = 1e-3


def main():
    init_file, rank, n, io = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world_size=n, rank=rank, backend="gloo")
    assert world() == (n, rank)
    inp = dict(np.load(os.path.join(io, "inputs.npz")))
    out, t0 = {}, time.perf_counter()

    grads = {"a": torch.arange(5.0) * (rank + 1), "b": torch.full((3, 2), rank + 0.5),
             "c": torch.tensor(float(rank)), "d": torch.arange(7.0) - rank}
    summed = psum_buckets(grads, num_buckets=2)
    for k, g in grads.items():
        one = g.clone()
        dist.all_reduce(one)
        out[f"psum_{k}"], out[f"psum_ref_{k}"] = summed[k].numpy(), one.numpy()

    v0, v1, v2, tid = partition_mesh(inp["ring_verts"], inp["ring_faces"], n)
    per = inp["ring_o"].shape[0] // n
    sl = slice(rank * per, (rank + 1) * per)
    hit = intersect_ring(torch.as_tensor(inp["ring_o"][sl]), torch.as_tensor(inp["ring_d"][sl]),
                         *(torch.as_tensor(a[rank]) for a in (v0, v1, v2, tid)))
    out.update(ring_t=hit.t.numpy(), ring_tri=hit.tri.numpy(), ring_hit=hit.hit.numpy())

    for case, name, over, shards in RENDERS:
        scene, cfg = build_scene(name, device="cpu")
        cfg = cfg.replace(block_size=0, **over)
        with torch.no_grad():
            img = render_image_sharded(scene, cfg, scene_shards=shards)
        out[f"img_{case}"] = img.numpy()
        out[f"jit_{case}"] = render_image_sharded_jit(scene, cfg, scene_shards=shards).numpy()

    for case, name, over, shards in BANDS:
        scene, cfg = build_scene(name, device="cpu")
        cfg = cfg.replace(block_size=0, **over)
        with torch.no_grad():
            # the gathered frame: the RENDERS case of the same name, if any
            whole = (torch.as_tensor(out[f"img_{case}"]) if f"img_{case}" in out
                     else render_image_sharded(scene, cfg, scene_shards=shards))
            band = render_image_sharded(scene, cfg, scene_shards=shards, gather=False)
        out[f"whole_{case}"], out[f"band_{case}"] = whole.numpy(), band.numpy()
        out[f"bandjit_{case}"] = render_image_sharded_jit(scene, cfg, scene_shards=shards,
                                                          gather=False).numpy()
        wrote = write_image_per_host(os.path.join(io, f"{case}.png"), band, banded=True)
        out[f"band_file_{case}"] = np.asarray(wrote or "")
        wrote = write_image_per_host(os.path.join(io, f"{case}.png"), whole)
        out[f"whole_file_{case}"] = np.asarray(wrote or "")

    scene, cfg = build_scene("triangles", device="cpu")
    cfg = cfg.replace(**FIT_CFG)
    target = torch.as_tensor(inp["fit_target"])
    for case, shards, moved in FITS:
        params = extract_params(scene, FIT_PATHS)
        if moved:
            with torch.no_grad():
                params["mesh.verts"].copy_(torch.as_tensor(inp["fit_moved_verts"]))
        opt = torch.optim.SGD(params.values(), lr=FIT_LR)
        loss = make_sharded_fit_step(scene, cfg, target, params, opt,
                                     scene_shards=shards)()
        out[f"fit_{case}_loss"] = np.asarray(loss)
        for k, v in params.items():
            out[f"fit_{case}_{k}"] = v.detach().numpy()

    def named() -> int:  # the plans whose key names a process group
        return sum(graphs._names(k, lambda v: isinstance(v, dist.ProcessGroup))
                   for k in graphs.PLANS)

    out["plans_named_before"] = np.asarray(named())
    destroy()
    assert not dist.is_initialized()
    out["plans_named_after"] = np.asarray(named())
    out["seconds"] = np.asarray(time.perf_counter() - t0)
    np.savez(os.path.join(io, f"out_{rank}.npz"), **out)


if __name__ == "__main__":
    main()
