"""Every kernel wrapper's launch counts, listed once.

Each wrapper counts its launches in its own `LAUNCHES` dict, by kernel.
`TABLES` lists those dicts: the CUDA graphs record each one's change during
a capture and add it at every replay (render/graphs.py), and `counts` and
`reset` serve the tools, the CLI and chip_smoke.py. A new wrapper adds its
table here.
"""

from __future__ import annotations

from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_scatter, cuda_sdf, cuda_shade

TABLES = (cuda_sdf.LAUNCHES, cuda_mt.LAUNCHES, cuda_shade.LAUNCHES, cuda_reconstruct.LAUNCHES,
          cuda_scatter.LAUNCHES)


def counts() -> dict:
    """Every kernel's launches so far, by its wrapper's key."""
    return {k: n for table in TABLES for k, n in table.items()}


def reset() -> None:
    """Every kernel's launch count to 0."""
    for table in TABLES:
        for k in table:
            table[k] = 0
