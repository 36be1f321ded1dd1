"""The gradient all-reduce of the distributed fit step (counterpart of
`tpu_ray/dist/grad_allreduce.py`): each process differentiates the loss of
its own pixels with respect to the replicated parameters, and the true
gradient is their sum over the process group, reduced in a few buckets,
each flattened into one tensor and one `all_reduce`.

`psum_buckets` is the eager form. `BucketSum` is the form the graphed fit
step (fit.make_sharded_fit_step) replays: static flat buffers, one a
bucket, that the gradients are copied into, and one Graph
(render/graphs.py) of an in-place `all_reduce` a bucket and one of the
loss, captured under NCCL on a card (run as plain calls under gloo).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from tpu_ray_torch.dist.multihost import world
from tpu_ray_torch.render.graphs import PLANS, Graph


def _buckets(grads: dict, num_buckets: int) -> list:
    """The keys of grads dealt round-robin in order of decreasing size, as
    the reference does, so the buckets are balanced -> a list of key lists."""
    keys = list(grads)
    order = sorted(range(len(keys)), key=lambda i: -grads[keys[i]].numel())
    buckets = [[] for _ in range(min(num_buckets, len(keys)))]
    for pos, i in enumerate(order):
        buckets[pos % len(buckets)].append(keys[i])
    return buckets


def psum_buckets(grads: dict, group=None, num_buckets: int = 4) -> dict:
    """{name: tensor} summed over the group -> a new dict of the same keys.

    Each bucket (_buckets) is one all_reduce of its leaves concatenated.
    Without a process group the sums are the leaves themselves."""
    if world(group)[0] == 1 or not grads:
        return dict(grads)
    out = {}
    for bucket in _buckets(grads, num_buckets):
        flat = torch.cat([grads[k].reshape(-1) for k in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for k, part in zip(bucket, flat.split([grads[k].numel() for k in bucket])):
            out[k] = part.reshape(grads[k].shape).to(grads[k].dtype)
    return {k: out[k] for k in grads}


class BucketSum:
    """psum_buckets and the loss's all_reduce as one Graph, for gradients
    of one structure (names, shapes, dtypes, device) and a process group:
    `sums(grads, loss)` copies them into the static buffers, replays the
    graph (at world size 1 too: the captured collectives run whenever a
    group is live) and returns new tensors of the sums. Get one through
    `bucket_sum`, which keeps it in render.graphs.PLANS under a key that
    names the group."""

    def __init__(self, grads: dict, loss: torch.Tensor, group, num_buckets: int):
        self.group = group
        self.buckets = _buckets(grads, num_buckets)
        device = loss.device
        self.flats = [torch.zeros(sum(grads[k].numel() for k in b), device=device,
                                  dtype=functools.reduce(torch.promote_types,
                                                         [grads[k].dtype for k in b]))
                      for b in self.buckets]
        self.loss = torch.zeros_like(loss)
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.graph = Graph(self._reduce, device, self.pool, "allreduce")

    def _reduce(self) -> None:
        for flat in self.flats:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        dist.all_reduce(self.loss, op=dist.ReduceOp.SUM, group=self.group)

    def reset(self) -> None:
        self.graph.reset()

    @torch.no_grad()
    def sums(self, grads: dict, loss: torch.Tensor):
        """-> ({name: the gradient summed over the group}, the summed loss)."""
        # the warm-up reduces the buffers in place: it runs before they are loaded
        self.graph.prepare()
        for flat, bucket in zip(self.flats, self.buckets):
            for k, part in zip(bucket, flat.split([grads[k].numel() for k in bucket])):
                part.copy_(grads[k].reshape(-1))
        self.loss.copy_(loss)
        self.graph.replay()
        out = {}
        for flat, bucket in zip(self.flats, self.buckets):
            for k, part in zip(bucket, flat.split([grads[k].numel() for k in bucket])):
                out[k] = part.reshape(grads[k].shape).to(grads[k].dtype, copy=True)
        return {k: out[k] for k in grads}, self.loss.clone()


def bucket_sum(grads: dict, loss: torch.Tensor, group, num_buckets: int = 4):
    """BucketSum.sums through the plan of this structure and group (made at
    the first call) -> (summed grads, summed loss)."""
    key = ("bucket_sum", group, num_buckets, loss.dtype, loss.device,
           tuple((k, tuple(g.shape), g.dtype, g.device) for k, g in grads.items()))
    plan = PLANS.get(key)
    if plan is None:
        plan = PLANS[key] = BucketSum(grads, loss, group, num_buckets)
    return plan.sums(grads, loss)
