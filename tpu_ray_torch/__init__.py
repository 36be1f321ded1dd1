"""PyTorch / CUDA port of the `tpu_ray` renderer for NVIDIA Hopper.

Module names mirror `tpu_ray/`. The port imports torch and numpy only; the
JAX package is its reference and is never imported here. Kernel dispatch
follows the tensor's device: a CPU tensor runs each kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel in `csrc/` (built
with nvcc on first use, see `kernels/build.py`) or raises. What a frame
traces and shades is decided once, in `render/chain.py`.
"""
