"""Runnable demos of the port (counterparts of the repository's `examples/`):
`python -m tpu_ray_torch.examples.<name> --help`."""
