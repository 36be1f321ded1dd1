"""The geometry pass's values-only reconstruct: a CUDA kernel and its plain
version.

The JAX package has no kernel here (XLA fuses its `_sdf_from_res` and
`_mesh_from_res`). Kernel: `csrc/reconstruct.cu`, over the shade chain's
per-ray arithmetic (`csrc/shade_chain.cuh`, `csrc/sdf_adj.cuh`). Plain
version: `plain.shadow_ray_origins_plain` over
`plain.reconstruct_plain(lite=True)`.

`reconstruct` gives, in one launch a ray block, what those two give: a
`plain.Recon` of the hit state (t, hit, p, n, mat, cov), the mixed
closest-select mask, the ray-facing normal, the shadow rays' origins and
the live lanes. It alone decides by the device: on CPU tensors it runs the
plain version; on CUDA tensors it launches the kernel and raises on what
the kernel does not take (non-float32 or non-contiguous input, an input
that requires grad, a chain without its geometry). The geometry pass,
`cuda_shade._make_aux` and `render.frame_stats` call it on any device, so
every values-only reconstruct on the card is this kernel. Each launch adds
one to
`LAUNCHES["reconstruct"]`. It takes `packed=` (`cuda_sdf.pack`, with the
primitives' material ids): the SDF's parameters packed once for many
launches, where a call without it packs them itself.
"""

from __future__ import annotations

import torch

from tpu_ray_torch.kernels import cuda_sdf
from tpu_ray_torch.kernels.build import check_cuda_inputs, check_launch, kernel_lib
from tpu_ray_torch.render.chain import frame_chain
from tpu_ray_torch.render.plain import Recon, mesh_table, shadow_ray_origins_plain

LAUNCHES = {"reconstruct": 0}


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
    (T, 10) plain.mesh_table (made here when None); packed: cuda_sdf.pack's
    (packed here when None)."""
    if o.device.type == "cpu":
        return shadow_ray_origins_plain(scene, cfg, o, d, res, method, mesh_rows=mesh_rows)
    chain = frame_chain(scene, cfg, method)
    if not chain.traced:
        raise NotImplementedError(f"reconstruct: {chain.why}")
    use_sdf, use_mesh = chain.use_sdf, chain.use_mesh
    sil = max(float(cfg.soft_silhouette), 0.0)  # 0: hard (misses parked at o)
    if packed is None:
        packed = cuda_sdf.pack(scene.sdf)
    t_bar = res["sdf_t"] if use_sdf else None
    tmin = res["sdf_tmin"] if chain.soft_sil else None
    hs = res["sdf_hit"] if use_sdf else None
    tri = hm = rows = None
    if use_mesh:
        if mesh_rows is None:
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
    closer = torch.empty(R, dtype=torch.bool, device=dev) if chain.mixed else None
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
