"""The benchmark of `tpu_ray_torch` on one NVIDIA H100: `python -m
benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>`
(see run.py). It measures the PyTorch and CUDA port and never loads JAX
or the JAX package."""
