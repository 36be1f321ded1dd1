"""The gradient all-reduce of the distributed fit step (counterpart of
`tpu_ray/dist/grad_allreduce.py`): each process differentiates the loss of
its own pixels with respect to the replicated parameters, and the true
gradient is their sum over the process group, reduced in a few buckets,
each flattened into one tensor and one `all_reduce`."""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_ray_torch.dist.multihost import world


def psum_buckets(grads: dict, group=None, num_buckets: int = 4) -> dict:
    """{name: tensor} summed over the group -> a new dict of the same keys.

    Leaves are dealt round-robin in order of decreasing size, as the
    reference does, so the buckets are balanced; each bucket is one
    all_reduce of its leaves concatenated. Without a process group the sums
    are the leaves themselves."""
    if world(group)[0] == 1 or not grads:
        return dict(grads)
    keys = list(grads)
    order = sorted(range(len(keys)), key=lambda i: -grads[keys[i]].numel())
    buckets = [[] for _ in range(min(num_buckets, len(keys)))]
    for pos, i in enumerate(order):
        buckets[pos % len(buckets)].append(keys[i])
    out = {}
    for bucket in buckets:
        flat = torch.cat([grads[k].reshape(-1) for k in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for k, part in zip(bucket, flat.split([grads[k].numel() for k in bucket])):
            out[k] = part.reshape(grads[k].shape).to(grads[k].dtype)
    return {k: out[k] for k in keys}

