"""3D-DDA traversal of the uniform grid (Amanatides-Woo) as a lock-step
masked loop (counterpart of `tpu_ray/kernels/dda.py`).

Every ray advances cell by cell in lock step while any ray is alive; dead
rays are frozen by masks. A cell's triangle list (the CSR of
accel/grid_build.py) is walked in chunks of _CHUNK triangles, as many chunks
as the fullest live cell of the step needs. A recorded hit retires its ray
only once best_t <= the current cell's exit t (+ _EXIT_EPS): a triangle
tested in an earlier cell can have its hit in a later one.

In the port the grid is an oracle, not a render path: `mesh_grid` walks the
packet accel on every device, and tests and chip_smoke.py hold those walks
against this traversal. It runs on the tensors' device in plain PyTorch
(no TPU kernel corresponds to it), selects hits only and takes no gradient.
Each step costs one host sync on a CUDA device (the live test and the chunk
count read together).
"""

from __future__ import annotations

import torch

from tpu_ray_torch.accel.grid_build import UniformGrid
from tpu_ray_torch.core.aabb import ray_aabb, safe_inv_dir
from tpu_ray_torch.kernels.moller_trumbore import BIG, TriHit, _mt_t
from tpu_ray_torch.scene.mesh import MeshScene

_CHUNK = 16  # triangle tests per ray per inner iteration
_EXIT_EPS = 1e-6  # tolerance of the "hit within the current cell" acceptance


@torch.no_grad()
def intersect_grid(mesh: MeshScene, grid: UniformGrid, o: torch.Tensor, d: torch.Tensor,
                   t_max: float = BIG, any_hit: bool = False) -> TriHit:
    """Closest-hit (or any-hit) traversal of (R, 3) rays through the grid."""
    dtype, dev = o.dtype, o.device
    R = o.shape[0]
    verts = mesh.verts.detach()
    tris = mesh.tris.long()
    starts = grid.cell_starts.to(dev).long()
    tri_idx = grid.tri_idx.to(dev).long()
    L = tri_idx.shape[0]
    if L == 0 or mesh.num_tris == 0 or R == 0:
        return TriHit(torch.full((R,), BIG, dtype=dtype, device=dev),
                      torch.full((R,), -1, dtype=torch.int32, device=dev),
                      torch.zeros((R,), dtype=torch.bool, device=dev))
    rx, ry, rz = grid.res
    res = torch.tensor(grid.res, dtype=torch.int64, device=dev)
    origin = grid.origin.to(dev, dtype)
    h = grid.cell_size.to(dev, dtype)

    inv_d = safe_inv_dir(d)
    t_enter, _, box_hit = ray_aabb(o, inv_d, origin, origin + h * res.to(dtype))
    # the first cell: the entry point nudged inside, clamped against rounding
    p_in = o + (t_enter + 1e-5)[:, None] * d
    cell = torch.floor((p_in - origin) / h)
    cell = torch.minimum(torch.clamp_min(cell, 0.0), (res - 1).to(dtype)).long()
    step = torch.where(d >= 0.0, 1, -1).long()
    next_b = origin + (cell + (step > 0).long()).to(dtype) * h
    flat_axis = torch.abs(d) < 1e-12  # axis-parallel: never crosses those planes
    t_axis = torch.where(flat_axis, BIG, (next_b - o) * inv_d)
    t_delta = torch.where(flat_axis, BIG, h * torch.abs(inv_d))

    alive = box_hit & (t_enter < t_max)
    best_t = torch.full((R,), BIG, dtype=dtype, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    karange = torch.arange(_CHUNK, device=dev)
    o_, d_ = o[:, None, :], d[:, None, :]
    while True:
        # a ray that just left the grid holds a cell outside it: clamp
        cidx = torch.clamp((cell[:, 0] * ry + cell[:, 1]) * rz + cell[:, 2], 0, rx * ry * rz - 1)
        start = starts[cidx]
        count = torch.where(alive, starts[cidx + 1] - start, 0)
        n_live, max_count = torch.stack([alive.sum(), count.max()]).tolist()
        if n_live == 0:
            break
        for k in range(-(-max_count // _CHUNK)):
            offs = k * _CHUNK + karange
            lane_valid = offs[None, :] < count[:, None]  # (R, K)
            ids = tri_idx[torch.clamp(start[:, None] + offs[None, :], 0, L - 1)]
            tv = tris[ids]  # (R, K, 3)
            t, valid = _mt_t(o_, d_, verts[tv[..., 0]], verts[tv[..., 1]],
                             verts[tv[..., 2]], t_max)
            t = torch.where(lane_valid & valid, t, BIG)
            tc, kc = torch.min(t, dim=-1)
            better = tc < best_t
            best_t = torch.where(better, tc, best_t)
            best_tri = torch.where(better, torch.gather(ids, 1, kc[:, None])[:, 0], best_tri)

        cell_exit = torch.amin(t_axis, dim=-1)
        accepted = best_t < BIG * 0.5 if any_hit else best_t <= cell_exit + _EXIT_EPS
        # advance along the axis of the nearest boundary crossing
        onehot = torch.nn.functional.one_hot(torch.argmin(t_axis, dim=-1), 3)
        cell_next = cell + onehot * step
        t_axis_next = t_axis + onehot.to(dtype) * t_delta
        inbounds = torch.all((cell_next >= 0) & (cell_next < res), dim=-1)
        keep = alive[:, None]
        cell = torch.where(keep, cell_next, cell)
        t_axis = torch.where(keep, t_axis_next, t_axis)
        # past t_max nothing closer can appear in a later cell
        alive = alive & ~accepted & inbounds & (cell_exit < t_max)

    hit = best_t < BIG * 0.5
    return TriHit(best_t, torch.where(hit, best_tri, -1).to(torch.int32), hit)


def any_hit_grid(mesh: MeshScene, grid: UniformGrid, o, d, t_max: float = BIG) -> torch.Tensor:
    return intersect_grid(mesh, grid, o, d, t_max=t_max, any_hit=True).hit
