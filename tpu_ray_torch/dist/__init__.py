"""The distributed layer (counterpart of `tpu_ray/dist/`): one process per
device in a `torch.distributed` process group, pixel data parallelism, the
ring scene-shard intersection and the bucketed gradient all-reduce."""
