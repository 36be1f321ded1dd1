"""A ray block's mesh corners gathered by triangle, and the gather's
backward, the vertex gradient's scatter: CUDA kernels, their plain
version and the autograd Function around them.

The JAX package has no Pallas kernel here: it gathers the corners with
`mesh_rows[idx][:, :9]` (`tpu_ray/render/render.py:615`) and XLA writes the
gather's transpose, a scatter-add by triangle. Kernels:
`csrc/corner_scatter.cu` (the counterpart of that gather and of XLA's
transpose; its note gives the byte bound and the design: ids sorted per
tile, a fixed-tree segmented sum within a tile and across the tiles, no
float atomic, so the gradient is bit-identical from run to run). Plain
version: `corner_gather_torch`, the indexing, and its autograd
(`corner_scatter_torch`).

`corner_gather(mesh_rows, idx)` -> the (R, 9) corners of the (T, 10)
`render.mesh_table` rows at the (R,) triangle ids idx, differentiable with
respect to mesh_rows. On CPU tensors it runs the plain version; on CUDA
tensors it is `CornerGather`, whose forward is one launch of the gather
kernel and whose backward is one call of the scatter (`corner_scatter`:
the zero fill, the tiles' sort and sums, their combine). Either raises on
what the kernels do not take: non-float32 or non-contiguous rows, ids that
are not a contiguous int32 or int64 vector, ids outside [0, T) (read on
the host, a wait for the device, outside a CUDA graph's capture). Each
launch adds one to `LAUNCHES["corner_gather"]` or
`LAUNCHES["corner_scatter"]`.

`shade_corners(mesh_rows, tri)` is the shade's gather
(render.shade_with_residuals): the ids clamped to [0, T) first (a miss's
-1 reads triangle 0), so it has no range to read and never waits for the
device.

Each scatter on a CUDA device adds to the process's counters (COUNTERS),
one int64 tensor per device, made at the first scatter on it (a graph's
warm-up, before its capture, so the captured launch adds to it at every
replay); `scatter_counters()` reads them. The longest segment is a maximum
over the launches, the rest are sums.
"""

from __future__ import annotations

import types

import torch
from torch.autograd.function import once_differentiable

from tpu_ray_torch.kernels.build import check_launch, kernel_lib

LAUNCHES = {"corner_gather": 0, "corner_scatter": 0}
# the scatter's counters (csrc/corner_scatter.cu `Counter`): launches, rows
# in, rows with a nonzero cotangent, segments (distinct triangles), and the
# longest segment's rows
COUNTERS = ("launches", "rows", "rows_nonzero", "segments", "longest_rows")
# the process's scatter counters, by device
_COUNTS = {}


def corner_gather_torch(mesh_rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: the (R, 9) corners of mesh_rows' rows at idx, by
    indexing (its autograd is the plain scatter)."""
    return mesh_rows[idx.long()][:, :9].contiguous()


def corner_scatter_torch(ct: torch.Tensor, idx: torch.Tensor, n_tris: int) -> torch.Tensor:
    """The plain version of the scatter: the (n_tris, 10) cotangent of the
    table from the (R, 9) cotangent ct of its gathered corners, by autograd
    of corner_gather_torch."""
    rows = torch.zeros((n_tris, 10), dtype=ct.dtype, device=ct.device, requires_grad=True)
    with torch.enable_grad():
        return torch.autograd.grad(corner_gather_torch(rows, idx), rows, ct)[0]


def check_inputs(mesh_rows: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise unless mesh_rows is a contiguous float32 (T, 10) table and idx a
    contiguous int32 or int64 vector on its device with ids in [0, T) (the
    range is read, with a wait for the device, except while a CUDA graph
    captures)."""
    _check_rows(mesh_rows, idx)
    _check_range(idx, mesh_rows.shape[0])


def _check_rows(mesh_rows: torch.Tensor, idx: torch.Tensor) -> None:
    if mesh_rows.dtype != torch.float32:
        raise TypeError(f"corner_gather: float32 rows only, got {mesh_rows.dtype}")
    if mesh_rows.dim() != 2 or mesh_rows.shape[1] != 10:
        raise ValueError("corner_gather: mesh_rows must be the (T, 10) mesh_table")
    if not mesh_rows.is_contiguous():
        raise ValueError("corner_gather: inputs must be contiguous")
    _check_ids(idx, mesh_rows.shape[0], mesh_rows.device)


def _check_ids(idx: torch.Tensor, n_tris: int, device: torch.device) -> None:
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError("corner_gather: the ids must be an int32 or int64 vector")
    if not idx.is_contiguous():
        raise ValueError("corner_gather: inputs must be contiguous")
    if idx.device != device:
        raise ValueError("corner_gather: the ids and the rows must be on one device")
    if not 0 < n_tris < 2**31 - 1 or idx.numel() >= 2**31 // 9:
        raise ValueError("corner_gather: too many rows or triangles for the kernels")


def _check_range(idx: torch.Tensor, n_tris: int) -> None:
    if idx.numel() and not (idx.is_cuda and torch.cuda.is_current_stream_capturing()):
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= n_tris:
            raise IndexError(f"corner_gather: ids in [{lo}, {hi}] outside [0, {n_tris})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _gather(mesh_rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty((idx.shape[0], 9), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        rc = kernel_lib().tr_corner_gather(mesh_rows.data_ptr(), mesh_rows.shape[0],
                                           idx.data_ptr(), idx.shape[0], out.data_ptr(),
                                           _stream(idx))
    check_launch("corner_gather", rc)
    LAUNCHES["corner_gather"] += 1
    return out


def _counted(device) -> torch.Tensor:
    """The counters a scatter adds to: the process's own for the device,
    made here at the first scatter on it, which may not be a capture's."""
    buf = _COUNTS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"cuda_scatter: the first scatter on {device} is being "
                               "captured: warm the graph up first")
        buf = _COUNTS[device] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
    return buf


def _scatter(ct: torch.Tensor, idx: torch.Tensor, n_tris: int) -> torch.Tensor:
    """The kernel: ct (R, 9) float32 and idx (R,) int32, contiguous, on one
    CUDA device -> the (n_tris, 10) gradient."""
    R, dev = idx.shape[0], idx.device
    grad = torch.empty((n_tris, 10), dtype=torch.float32, device=dev)
    lib = kernel_lib()
    scratch = torch.empty(int(lib.tr_corner_scatter_scratch(R, n_tris)), dtype=torch.uint8,
                          device=dev)
    counters = _counted(dev)
    with torch.cuda.device(dev):
        rc = lib.tr_corner_scatter(ct.data_ptr(), idx.data_ptr(), R, n_tris, grad.data_ptr(),
                                   scratch.data_ptr(), counters.data_ptr(), _stream(idx))
    check_launch("corner_scatter", rc)
    LAUNCHES["corner_scatter"] += 1
    return grad


def _ids32(idx: torch.Tensor) -> torch.Tensor:
    return idx if idx.dtype == torch.int32 else idx.to(torch.int32)


def corner_scatter(ct: torch.Tensor, idx: torch.Tensor, n_tris: int) -> torch.Tensor:
    """The gather's backward: the (n_tris, 10) cotangent of the table from
    the (R, 9) cotangent ct of the corners at idx (column 9 zero). The plain
    version on CPU tensors, the kernel on CUDA tensors."""
    if ct.device.type == "cpu":
        return corner_scatter_torch(ct, idx, n_tris)
    if ct.dtype != torch.float32 or tuple(ct.shape) != (idx.shape[0], 9):
        raise TypeError("corner_scatter: the cotangent must be float32 (R, 9)")
    if not ct.is_contiguous() or ct.device != idx.device:
        raise ValueError("corner_scatter: the cotangent must be contiguous, on the ids' device")
    _check_ids(idx, n_tris, ct.device)
    _check_range(idx, n_tris)
    return _scatter(ct, _ids32(idx), n_tris)


class CornerGather(torch.autograd.Function):
    """corners = CornerGather.apply(mesh_rows, idx) on CUDA tensors checked
    by check_inputs: the gather kernel; its backward, the scatter."""

    @staticmethod
    def forward(ctx, mesh_rows, idx):
        idx = _ids32(idx)
        ctx.save_for_backward(idx)
        ctx.n_tris = mesh_rows.shape[0]
        return _gather(mesh_rows.detach(), idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _scatter(ct.contiguous(), idx, ctx.n_tris), None


def corner_gather(mesh_rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The (R, 9) corners of the (T, 10) mesh_rows at the (R,) triangle ids
    idx (see the module docstring): the plain version on CPU tensors, the
    kernels on CUDA tensors."""
    if mesh_rows.device.type == "cpu":
        return corner_gather_torch(mesh_rows, idx)
    check_inputs(mesh_rows, idx)
    return CornerGather.apply(mesh_rows, idx)


def shade_corners(mesh_rows: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """corner_gather at the triangle ids tri clamped to [0, T), as the shade
    reads a block's corners (a miss's -1 reads triangle 0; its cotangent is
    zero): no range left to read, so no wait for the device."""
    idx = torch.clamp(tri, 0, mesh_rows.shape[0] - 1)
    if mesh_rows.device.type == "cpu":
        return corner_gather_torch(mesh_rows, idx)
    _check_rows(mesh_rows, idx)
    return CornerGather.apply(mesh_rows, idx)


def scatter_counters() -> types.MappingProxyType:
    """A read-only snapshot of what the scatters did in this process
    ({counter: n} over COUNTERS; the longest segment a maximum over the
    devices, the rest sums; empty before the first scatter on a CUDA device:
    the plain version counts nothing). Waits for each device's work."""
    out = {}
    for device, buf in _COUNTS.items():
        torch.cuda.synchronize(device)
        for name, n in zip(COUNTERS, buf.tolist()):
            out[name] = max(out.get(name, 0), n) if name == "longest_rows" \
                else out.get(name, 0) + n
    return types.MappingProxyType(out)
