"""The geometry pass's values-only reconstruct: a CUDA kernel and its plain
version.

The JAX package has no kernel here (XLA fuses its `_sdf_from_res` and
`_mesh_from_res`). Kernel: `csrc/reconstruct.cu`, over the shade chain's
per-ray arithmetic (`csrc/shade_chain.cuh`, `csrc/sdf_adj.cuh`). Plain
version: `render.shadow_ray_origins_plain` over
`render.reconstruct_plain(lite=True)`.

`reconstruct` gives, in one launch a ray block, what those two give: the
hit state (t, hit, p, n, mat, cov), the mixed closest-select mask, the
ray-facing normal, the shadow rays' origins and the live lanes. It alone
decides by the device: on CPU tensors it runs the plain version
(`render.shadow_ray_origins_plain`); on CUDA tensors it launches the kernel
and raises on what the kernel does not take (non-float32 or non-contiguous
input, an input that requires grad, a method without its geometry).
`render.shadow_ray_origins` and `render.reconstruct_hits(lite=True)` call
it on any device, so every values-only reconstruct on the card is this
kernel. Each launch adds one to
`LAUNCHES["reconstruct"]`. It takes `packed=` (`cuda_sdf.pack`, with the
primitives' material ids): the SDF's parameters packed once for many
launches, where a call without it packs them itself.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_ray_torch.kernels import cuda_sdf
from tpu_ray_torch.kernels.build import check_cuda_inputs, check_launch, kernel_lib

LAUNCHES = {"reconstruct": 0}
METHODS = ("sdf", "mesh_brute", "mesh_grid", "mixed")


class Recon(NamedTuple):
    """One ray block's values-only reconstruct."""
    hits: tuple                      # (t, hit, p, n, mat, cov), as reconstruct_hits'
    closer: Optional[torch.Tensor]   # the mixed closest-select mask, else None
    nf: torch.Tensor                 # the ray-facing normal
    p_off: torch.Tensor              # the shadow rays' origins
    live: Optional[torch.Tensor]     # the lanes whose shadows reach the image (None
                                     # with soft silhouettes)


def _check_masks(*tensors) -> None:
    for t in tensors:
        if t is not None and (t.device.type != "cuda" or not t.is_contiguous()
                              or t.dtype not in (torch.bool, torch.int32)):
            raise TypeError("reconstruct: masks and ids must be contiguous bool or int32 "
                            "CUDA tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


def reconstruct(scene, cfg, o, d, res, method: str, mesh_rows=None,
                packed: cuda_sdf.Packed | None = None) -> Recon:
    """The values-only reconstruct of one ray block from its geometry
    residuals (sdf_t, sdf_hit, sdf_tmin with soft silhouettes; mesh_tri,
    mesh_hit) -> Recon. mesh_rows: the frame's
    (T, 10) render.mesh_table (made here when None); packed: cuda_sdf.pack's
    (packed here when None)."""
    if o.device.type == "cpu":
        from tpu_ray_torch.render.render import shadow_ray_origins_plain

        aux = {}
        hits, p_off, nf, live = shadow_ray_origins_plain(scene, cfg, o, d, res, method,
                                                         mesh_rows=mesh_rows, aux_out=aux)
        return Recon(hits, aux.get("closer"), nf, p_off, live)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    use_sdf = method in ("sdf", "mixed") and scene.has_sdf
    use_mesh = method in ("mesh_brute", "mesh_grid", "mixed") and scene.has_mesh
    if not (use_sdf or use_mesh) or (method == "mixed" and not (use_sdf and use_mesh)):
        raise NotImplementedError(f"reconstruct: method {method!r} on a scene without "
                                  "its geometry")
    sil = max(float(cfg.soft_silhouette), 0.0)  # 0: hard (misses parked at o)
    if packed is None:
        packed = cuda_sdf.pack(scene.sdf)
    t_bar = res["sdf_t"] if use_sdf else None
    tmin = res["sdf_tmin"] if use_sdf and sil > 0.0 else None
    hs = res["sdf_hit"] if use_sdf else None
    tri = hm = rows = None
    if use_mesh:
        if mesh_rows is None:
            from tpu_ray_torch.render.render import mesh_table

            mesh_rows = mesh_table(scene.mesh)
        tri, hm, rows = res["mesh_tri"], res["mesh_hit"], mesh_rows.detach()
        if rows.dim() != 2 or rows.shape[1] != 10:
            raise ValueError("reconstruct: mesh_rows must be the (T, 10) mesh_table")
    check_cuda_inputs("reconstruct", o, d, t_bar, tmin, rows, packed.params)
    _check_masks(hs, hm, tri, packed.mats)
    R, dev = o.shape[0], o.device
    for x in (t_bar, tmin, hs, tri, hm):
        if x is not None and tuple(x.shape) != (R,):
            raise ValueError(f"reconstruct: the residuals must be ({R},)")
    f32 = dict(dtype=torch.float32, device=dev)
    t, cov = torch.empty(R, **f32), torch.empty(R, **f32)
    p, n, nf, p_off = (torch.empty((R, 3), **f32) for _ in range(4))
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    closer = torch.empty(R, dtype=torch.bool, device=dev) if use_sdf and use_mesh else None
    with torch.cuda.device(dev):
        rc = kernel_lib().tr_reconstruct(
            o.data_ptr(), d.data_ptr(), _ptr(t_bar), _ptr(tmin), _ptr(hs), _ptr(tri), _ptr(hm),
            _ptr(rows), 0 if rows is None else rows.shape[0], R, packed.params.data_ptr(),
            packed.mats.data_ptr(), *packed.counts, int(use_sdf), int(use_mesh),
            sil, float(cfg.shadow_bias),
            t.data_ptr(), hit.data_ptr(), p.data_ptr(), n.data_ptr(), mat.data_ptr(),
            cov.data_ptr(), _ptr(closer), nf.data_ptr(), p_off.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("reconstruct", rc)
    LAUNCHES["reconstruct"] += 1
    live = hit if sil <= 0.0 else None
    return Recon((t, hit, p, n, mat, cov), closer, nf, p_off, live)
