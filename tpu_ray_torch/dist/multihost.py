"""Process-group setup and rank-0 gating (counterpart of
`tpu_ray/dist/multihost.py`).

The port runs one process per device: `torchrun --nproc_per_node=N`, or N
processes that each call `initialize` with the same `init_method` (a
`tcp://localhost:<port>` or `file://` address), the world size and their
rank. Collectives then go through `torch.distributed` (NCCL between cards,
gloo between CPU processes).

`write_image_per_host` writes a frame from a process group: rank 0 a
gathered frame, each rank its band of rows of an ungathered one
(`render_image_sharded(..., gather=False)`).

A CUDA graph that captured a communicator's work must not outlive its
process group: `destroy` drops the graph plans that name the group
(render/graphs.drop_plans) before it destroys the group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join the process group (a no-op for a single process).

    With no arguments, reads torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT) and does nothing when it names one process.
    An explicit configuration that fails raises: a broken multi-process
    setup is never taken for a single process. The backend is NCCL when a
    CUDA device exists, gloo otherwise."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if init_method is None and world_size is None and rank is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        dist.init_process_group(backend=backend)  # env://, torchrun's variables
        return
    if init_method is None:
        if world_size is not None and world_size <= 1:
            return
        raise ValueError("initialize: a multi-process group needs its init_method")
    if world_size is None or rank is None:
        raise ValueError("initialize: init_method needs world_size and rank")
    if not 0 <= rank < world_size:
        raise ValueError(f"initialize: rank {rank} outside world size {world_size}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def world(group=None) -> tuple[int, int]:
    """(size, rank) of the group, (1, 0) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def live_group(group=None):
    """The process group a collective of `group` runs in: group itself, or
    the default group (None without a process group)."""
    if group is not None or not dist.is_available() or not dist.is_initialized():
        return group
    return dist.group.WORLD


def destroy(group=None) -> None:
    """Drop the graph plans that captured work of the group (None: of every
    group), then destroy it (None: the default group and every other); a
    no-op without a process group."""
    from tpu_ray_torch.render import graphs

    if not dist.is_available() or not dist.is_initialized():
        return
    graphs.drop_plans(group)
    dist.destroy_process_group(group)


def is_main() -> bool:
    return world()[1] == 0


def main_print(*args, **kw) -> None:
    if is_main():
        print(*args, **kw)


def write_image_per_host(path: str, img: torch.Tensor, banded: bool = False,
                         group=None) -> str | None:
    """Write a frame from every process of the group; returns the file this
    process wrote (None if it wrote none).

      * world size 1: `path`;
      * a gathered frame (banded=False): rank 0 writes `path`;
      * this rank's band of rows (banded=True, render_image_sharded's
        gather=False): `<root>.pNNN<ext>` with NNN the rank; an empty band
        writes nothing.
    """
    from tpu_ray_torch.utils.image_io import write_png

    n, r = world(group)
    if n == 1 or not banded:
        if r != 0:
            return None
        write_png(path, img.detach().cpu().numpy())
        return path
    if img.shape[0] == 0:
        return None
    root, ext = os.path.splitext(path)
    out = f"{root}.p{r:03d}{ext}"
    write_png(out, img.detach().cpu().numpy())
    return out
