"""Typed render and fit configuration: the same fields and defaults as
`tpu_ray.utils.config.RenderConfig` (minus `pallas`) and `FitConfig`.

There is no kernel switch: kernel dispatch follows the device of the tensors
(`tpu_ray_torch/kernels/cuda_*.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 1  # samples per pixel; must be a square number (stratified grid)

    # "auto" picks per scene contents; sdf | mesh_brute | mesh_grid | mixed
    # force one ("mesh_grid" walks the packet accel on every device; the
    # uniform grid, Scene.grid, is the walks' oracle, kernels/dda.py)
    method: str = "auto"

    # sphere-trace march
    max_steps: int = 96
    eps: float = 1e-3
    t_far: float = 40.0

    # shading
    shadow: str = "hard"  # "none" | "hard" | "soft"
    soft_k: float = 8.0
    shadow_steps: int = 48
    shadow_bias: float = 3e-3
    ao: str = "none"  # "none" | "sdf5"
    ao_strength: float = 1.0
    ao_step: float = 0.04
    diff_vis: bool = True

    # rays are processed in blocks of this many samples (0 = one block)
    block_size: int = 0

    # None = stratified cell centers; an int seed jitters within the stratum
    jitter_seed: Optional[int] = None

    # soft silhouette band widths (0 = hard silhouettes)
    soft_silhouette: float = 0.0
    mesh_silhouette: float = 0.0

    def __post_init__(self):
        k = int(round(math.sqrt(self.spp)))
        if k * k != self.spp:
            raise ValueError(f"spp must be a square number, got {self.spp}")

    @property
    def spp_side(self) -> int:
        return int(round(math.sqrt(self.spp)))

    @property
    def num_rays(self) -> int:
        return self.width * self.height * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    steps: int = 200
    learning_rate: float = 1e-2
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
