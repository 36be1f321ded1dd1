"""Uniform grid: the host-side voxelization and its CSR cell lists
(counterpart of `tpu_ray/accel/grid_build.py`).

Each triangle is binned into every cell its bounding box overlaps; the cell
-> triangle lists are stored as CSR (`cell_starts`, `tri_idx`), with the
reference's resolution rule, so both packages build the same grid value for
value. The build is numpy on the host; the tensors then move to the
requested device. The grid selects hits only and is never differentiated:
it is rebuilt, not refit, when vertices move. In the port it is the
oracle of the packet walks (kernels/dda.py), not a render path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class UniformGrid:
    origin: torch.Tensor  # (3,) float32 world-space min corner
    cell_size: torch.Tensor  # (3,) float32
    cell_starts: torch.Tensor  # (C+1,) int32 CSR offsets, C = rx*ry*rz
    tri_idx: torch.Tensor  # (L,) int32 triangle ids, cell-major
    res: tuple = (1, 1, 1)
    max_per_cell: int = 0

    @property
    def num_cells(self) -> int:
        rx, ry, rz = self.res
        return rx * ry * rz


def build_grid(verts: np.ndarray, tris: np.ndarray, density: float = 5.0,
               max_res: int = 128, device="cpu") -> UniformGrid:
    """Voxelize triangles into a uniform grid of about `density` cells per
    triangle, res_a = ceil(extent_a * (density * T / volume)^(1/3)) cells
    along each axis, clamped to [1, max_res]."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    T = tris.shape[0]
    if T == 0:
        return UniformGrid(origin=f32(np.zeros(3)), cell_size=f32(np.ones(3)),
                           cell_starts=i32(np.zeros(2)), tri_idx=i32(np.zeros(0)))

    lo = verts.min(0)
    hi = verts.max(0)
    extent = np.maximum(hi - lo, 1e-9)
    pad = extent * 1e-4 + 1e-9  # boundary triangles land strictly inside
    lo = lo - pad
    hi = hi + pad
    extent = hi - lo

    vol = float(np.prod(extent))
    lam = (density * T / vol) ** (1.0 / 3.0)
    res = np.clip(np.ceil(extent * lam).astype(np.int64), 1, max_res)
    rx, ry, rz = (int(r) for r in res)
    h = extent / res

    tv = verts[tris]  # (T, 3, 3)
    clo = np.clip(np.floor((tv.min(1) - lo) / h).astype(np.int64), 0, res - 1)
    chi = np.clip(np.floor((tv.max(1) - lo) / h).astype(np.int64), 0, res - 1)

    # (cell, triangle) pairs, looping over the small per-triangle span
    # offsets so the inner work stays vectorized over the triangles
    span = chi - clo + 1
    max_span = span.max(0)
    cells_list, tris_list = [], []
    for dx in range(int(max_span[0])):
        mx = dx < span[:, 0]
        for dy in range(int(max_span[1])):
            my = mx & (dy < span[:, 1])
            for dz in range(int(max_span[2])):
                m = my & (dz < span[:, 2])
                if not m.any():
                    continue
                t_ids = np.nonzero(m)[0]
                c = (((clo[t_ids, 0] + dx) * ry + (clo[t_ids, 1] + dy)) * rz
                     + (clo[t_ids, 2] + dz))
                cells_list.append(c)
                tris_list.append(t_ids)
    cells = np.concatenate(cells_list)
    tri_ids = np.concatenate(tris_list)

    order = np.argsort(cells, kind="stable")
    cells = cells[order]
    tri_ids = tri_ids[order]
    C = rx * ry * rz
    counts = np.bincount(cells, minlength=C)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return UniformGrid(origin=f32(lo), cell_size=f32(h), cell_starts=i32(starts),
                       tri_idx=i32(tri_ids), res=(rx, ry, rz),
                       max_per_cell=int(counts.max()))


def grid_stats(grid: UniformGrid) -> dict:
    counts = np.diff(grid.cell_starts.cpu().numpy())
    occupied = counts > 0
    return {
        "res": grid.res,
        "cells": int(counts.size),
        "occupied": int(occupied.sum()),
        "pairs": int(grid.cell_starts[-1]),
        "max_per_cell": int(grid.max_per_cell),
        "mean_per_occupied": float(counts[occupied].mean()) if occupied.any() else 0.0,
    }
