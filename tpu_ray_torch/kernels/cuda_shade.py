"""The fused shade forward and backward: CUDA kernels, their plain
versions, and the autograd Function around the shade of a ray block.

Counterpart of `tpu_ray/kernels/pallas_shade.py` (`shade_fwd_pallas`,
`shade_bwd_pallas` and their wrapper `make_shade_sdf_vjp`). Kernels:
`csrc/shade_fwd.cu` and `csrc/shade_bwd.cu`, over the per-ray chain both
recompute (`csrc/shade_chain.cuh`) and the distance field's adjoint
(`csrc/sdf_adj.cuh`).

`ShadeFn` takes the scene's shade leaves (SHADE_PATHS), the rays o, d and
the selected triangles' corners. Its forward is `shade_fwd`; it saves only
compact residuals: o, d, the march t, closest approach and hit masks, the
shadow visibility and the soft march's argmin t, the AO's mesh distance,
the hit material and the mixed closest-select mask, and the corners. Its
backward is `shade_bwd`.

Dispatch follows the device: `shade_fwd` and `shade_bwd` run their plain
versions (`shade_fwd_torch`, the plain shade `plain.shade_plain` without
gradient; `shade_bwd_torch`, its autograd) on CPU tensors and launch their
kernel on CUDA tensors, raising on what the kernels do not take
(`Chain.why`); `render.shade_with_residuals` picks the route. Each launch
adds one to `LAUNCHES["shade_fwd"]` or `LAUNCHES["shade_bwd"]`;
`shade_bwd` takes an optional `counters` tensor (int64,
len(SHADE_BWD_COUNTERS), on the rays' device) to which a launch adds what
it did, and the main path passes none.
Both take `packed=` (`pack`): the scene's parameters packed once for many
launches (a frame, a fit step), where a call without it packs them itself;
the backward's parameter cotangents still come back per block.
The chains the kernels take (render/chain.py decides which they refuse):
methods sdf, mesh_* and mixed, directional and point lights, static
shadow visibility (hard, soft or none), the soft-shadow penumbra with
`diff_vis`, the 5-tap AO, the soft SDF silhouette and the mesh edge band,
the power-8 and the generic-power Mandelbulb (the latter with its
`sdf.mb_power` cotangent) at any iteration count, float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from tpu_ray_torch.kernels.build import (check_counters, check_cuda_inputs, check_launch,
                                         kernel_lib)
from tpu_ray_torch.kernels import cuda_reconstruct, cuda_sdf
from tpu_ray_torch.kernels.cuda_sdf import field_flag, pack_sdf
from tpu_ray_torch.render.chain import frame_chain
from tpu_ray_torch.render.plain import shade_plain
from tpu_ray_torch.scene.types import apply_params, get_param
from tpu_ray_torch.sdf.primitives import FLOAT_FIELDS

LAUNCHES = {"shade_fwd": 0, "shade_bwd": 0}
# the shade backward's optional counters (csrc/shade_bwd.cu `ShadeCounter`):
# rays by the class of their chain (csrc/shade_chain.cuh `RayClass`), the
# Mandelbulb's with the AO taps or the penumbra, the warps and those whose
# rays mix classes as run and as loaded; by a warp's costliest class its
# warps and clock64() cycles (sum, max); the block reduction's cycles (sum,
# max), the blocks, and the most cycles a thread of the second pass spent
RAY_CLASSES = ("sky", "mesh", "sdf", "bulb")
SHADE_BWD_COUNTERS = (tuple(f"rays_{c}" for c in RAY_CLASSES)
                      + ("rays_bulb_ao", "warps", "warps_mixed", "warps_mixed_loaded")
                      + tuple(f"warps_{c}" for c in RAY_CLASSES)
                      + tuple(f"cycles_{c}" for c in RAY_CLASSES)
                      + tuple(f"cycles_max_{c}" for c in RAY_CLASSES)
                      + ("epilogue_cycles", "epilogue_cycles_max", "blocks", "sum_cycles_max"))

# the differentiable scene leaves of the shade chain, in the kernel's packed
# order after the SDF block; the vertices' gradient flows through the corners
SHADE_PATHS = tuple(f"sdf.{f}" for f in FLOAT_FIELDS) + (
    "materials.albedo", "lights.direction", "lights.color", "lights.ambient",
    "bg_top", "bg_bottom", "lights.position", "lights.pos_color")
_SMALL_PATHS = SHADE_PATHS[len(FLOAT_FIELDS):]
# the residuals the backward keeps (the geometry pass's hit state is not)
_SAVED_RES = ("sdf_t", "sdf_hit", "sdf_tmin", "mesh_tri", "mesh_hit", "sh_vis",
              "sh_ts", "ao_tmesh")


def wants_grad(scene, o, d, mesh_rows=None) -> bool:
    """Whether any input of the shade chain requires grad."""
    given = [o, d, mesh_rows, scene.mesh.verts,
             *(get_param(scene, p) for p in SHADE_PATHS)]
    return any(t is not None and t.requires_grad for t in given)


def _make_aux(scene, cfg, method: str, o, d, res, mesh_rows=None, packed=None) -> dict:
    """The hit material id and the mixed closest-select mask: the geometry
    pass's residuals when it made them (with shadows or the AO's mesh term),
    else recomputed by a values-only reconstruct (on CUDA tensors the
    reconstruct kernel, given packed)."""
    if "hit_mat" not in res:
        with torch.no_grad():
            r = cuda_reconstruct.reconstruct(scene, cfg, o.detach(), d.detach(), res, method,
                                             mesh_rows=mesh_rows, packed=packed)
        res = {"hit_mat": r.hits[4], "hit_closer": r.closer}
    aux = {"mat": res["hit_mat"].to(torch.int32)}
    if res.get("hit_closer") is not None:
        aux["closer"] = res["hit_closer"]
    return aux


def _detached(scene):
    """The scene with its shade leaves and vertices detached (what the
    backward reads; holding no graph)."""
    scene = apply_params(scene, {p: get_param(scene, p).detach() for p in SHADE_PATHS})
    return scene.replace(mesh=dataclasses.replace(
        scene.mesh, verts=scene.mesh.verts.detach()))


@dataclasses.dataclass
class _ShadeCall:
    scene: object
    cfg: object
    method: str
    res: dict
    aux: dict
    mesh_rows: object = None
    packed: object = None


class ShadeFn(torch.autograd.Function):
    """colors = ShadeFn.apply(call, o, d, corners, *shade leaves): the fused
    shade forward and backward (counterpart of `make_shade_sdf_vjp` with
    the Pallas forward rule)."""

    @staticmethod
    def forward(ctx, call: _ShadeCall, o, d, corners, *leaves):
        out = shade_fwd(call.scene, call.cfg, o.detach(), d.detach(), call.res,
                        call.method, corners=None if corners is None else corners.detach(),
                        aux=call.aux, mesh_rows=call.mesh_rows, packed=call.packed)
        saved = {k: call.res[k] for k in _SAVED_RES if k in call.res}
        ctx.call = _ShadeCall(_detached(call.scene), call.cfg, call.method,
                              saved, call.aux, packed=call.packed)
        ctx.save_for_backward(o, d, corners)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        o, d, corners = (None if t is None else t.detach() for t in ctx.saved_tensors)
        c = ctx.call
        g = shade_bwd(c.scene, c.cfg, o, d, c.res, c.aux, corners,
                      ct.contiguous(), c.method, packed=c.packed)
        return (None, g["o"], g["d"], g["corners"],
                *(g[p] for p in SHADE_PATHS))


def shade(scene, cfg, o, d, res, method: str, corners=None, mesh_rows=None, packed=None):
    """The shade of one ray block through ShadeFn -> (R, 3). packed: see
    shade_fwd (the backward reads it too)."""
    aux = _make_aux(scene, cfg, method, o, d, res, mesh_rows, packed)
    call = _ShadeCall(scene, cfg, method, res, aux, mesh_rows, packed)
    return ShadeFn.apply(call, o, d, corners,
                         *(get_param(scene, p) for p in SHADE_PATHS))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's parity reference)
# ---------------------------------------------------------------------------

def shade_fwd_torch(scene, cfg, o, d, res, method: str, corners=None,
                    mesh_rows=None) -> torch.Tensor:
    """The plain shade of one block without gradient -> (R, 3): `shade_plain`
    (which reuses the geometry pass's hit state where it left one)."""
    with torch.no_grad():
        return shade_plain(scene, cfg, o, d, res, method, mesh_rows=mesh_rows,
                           corners=corners)


def shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method: str) -> dict:
    """Cotangents of the plain shade of one block given the output
    cotangent ct (R, 3): torch.autograd of `shade_plain` with respect to
    the SHADE_PATHS leaves, o, d and the corners. Returns a dict by path
    plus "o", "d" and "corners" (None without a mesh); zeros for leaves the
    chain does not use."""
    with torch.enable_grad():
        leaves = {p: get_param(scene, p).detach().requires_grad_(True)
                  for p in SHADE_PATHS}
        o_ = o.detach().requires_grad_(True)
        d_ = d.detach().requires_grad_(True)
        c_ = None if corners is None else corners.detach().requires_grad_(True)
        out = shade_plain(apply_params(scene, leaves), cfg, o_, d_, res, method,
                          corners=c_)
        inputs = [o_, d_, *([] if c_ is None else [c_]), *leaves.values()]
        grads = torch.autograd.grad(out, inputs, grad_outputs=ct,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    result = dict(zip(SHADE_PATHS, grads[-len(SHADE_PATHS):]))
    result.update(o=grads[0], d=grads[1], corners=None if c_ is None else grads[2])
    return result


def _float64(scene, o, d, res, corners):
    """The shade's inputs in float64: the SHADE_PATHS leaves, the rays, the
    float residuals (not the geometry pass's float32 hit state) and the
    corners."""
    def f64(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    scene64 = apply_params(scene, {p: f64(get_param(scene, p)) for p in SHADE_PATHS})
    res64 = {k: f64(v) for k, v in res.items() if k != "hits"}
    return scene64, f64(o), f64(d), res64, f64(corners)


def ill_conditioned_rays(scene, cfg, o, d, res, corners, ct, method: str):
    """(R,) bool: the rays on which shade_bwd_torch in float32 is itself off
    by more than 1e-3, the parity checks' per-ray bound, in d_o or d_d from
    the same computation in float64 on the same inputs. Where the AO taps
    or the penumbra read the Mandelbulb near its surface, float32 rounding
    alone moves a ray's cotangents that far: no float32 version has an
    answer there to agree on, so the parity checks set such rays apart. The
    kernel takes no part in picking them."""
    scene64, o64, d64, res64, c64 = _float64(scene, o, d, res, corners)
    g32 = shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
    g64 = shade_bwd_torch(scene64, cfg, o64, d64, res64, c64, ct.double(), method)
    rel = [(g32[k].double() - g64[k]).norm(dim=1) / g64[k].norm(dim=1).clamp_min(1e-300)
           for k in ("o", "d")]
    return torch.maximum(*rel) > 1e-3


def ill_conditioned_colors(scene, cfg, o, d, res, corners, method: str,
                           tol: float = 1e-4):
    """(R,) bool: the rays whose float32 plain forward (shade_fwd_torch)
    leaves its float64 evaluation on the same inputs by more than tol in a
    channel, the forward parity's per-ray bound. As for the backward, where
    the AO taps or the penumbra read the Mandelbulb near its surface,
    float32 rounding alone moves such a colour that far; the kernel takes no
    part in picking them."""
    scene64, o64, d64, res64, c64 = _float64(scene, o, d, res, corners)
    c32 = shade_fwd_torch(scene, cfg, o, d, res, method, corners=corners)
    c64 = shade_fwd_torch(scene64, cfg, o64, d64, res64, method, corners=c64)
    return (c32.double() - c64).abs().amax(1) > tol


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def pack_small(scene, sdf_block=None) -> torch.Tensor:
    """The kernels' packed float32 parameter block (layout in
    csrc/shade_chain.cuh): the SDF block of pack_sdf (sdf_block, when
    packed already), then the SHADE_PATHS leaves after the SDF's,
    flattened."""
    parts = [pack_sdf(scene.sdf) if sdf_block is None else sdf_block]
    parts += [get_param(scene, p).reshape(-1).to(torch.float32) for p in _SMALL_PATHS]
    return torch.cat(parts).contiguous()


def pack(scene, bound_pad: float = 0.0) -> cuda_sdf.Packed:
    """Every kernel's scene parameters packed once (cuda_sdf.Packed, with
    pack_small's block): what render_pixels_flat hands the wrappers as
    `packed=` for a frame or a fit step. bound_pad: the primary march's."""
    with torch.no_grad():
        packed = cuda_sdf.pack(scene.sdf, bound_pad)
        return dataclasses.replace(packed, small=pack_small(scene, packed.params))


def unpack_small(vec: torch.Tensor, scene) -> dict:
    """Cotangents by path from a vector in pack_small's layout (mb_power's
    is 0 where the power-8 field runs: it does not read the power)."""
    sdf = scene.sdf
    out, off = {}, 0

    def take(n, width):
        nonlocal off
        blk = vec[off:off + n * width].reshape(n, width)
        off += n * width
        return blk

    blk = take(sdf.sph_center.shape[0], 4)
    out["sdf.sph_center"], out["sdf.sph_radius"] = blk[:, :3], blk[:, 3]
    blk = take(sdf.pln_normal.shape[0], 4)
    out["sdf.pln_normal"], out["sdf.pln_offset"] = blk[:, :3], blk[:, 3]
    blk = take(sdf.box_center.shape[0], 7)
    out["sdf.box_center"], out["sdf.box_half"] = blk[:, :3], blk[:, 3:6]
    out["sdf.box_round"] = blk[:, 6]
    blk = take(sdf.mb_center.shape[0], 5)
    out["sdf.mb_center"], out["sdf.mb_scale"] = blk[:, :3], blk[:, 3]
    out["sdf.mb_power"] = blk[:, 4]
    for path in _SMALL_PATHS:
        ref = get_param(scene, path)
        out[path] = vec[off:off + ref.numel()].reshape(ref.shape)
        off += ref.numel()
    return {p: out[p].to(get_param(scene, p).dtype).contiguous() for p in SHADE_PATHS}


def _check_masks(name, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.dtype not in (torch.bool, torch.int32):
            raise TypeError(f"{name}: masks and ids must be bool or int32 CUDA tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def kernel_args(scene, cfg, o, d, res, aux, corners, method: str, packed=None):
    """The arguments both shade kernels take: (chain, small, rays, statics).
    chain: frame_chain's, which the kernels must take (else it raises);
    rays: the 12 per-ray tensors (o, d, corners, t_bar, tmin, hs, hm,
    closer, mat, vis, ts, ao_tmesh; None where the chain reads none), the
    kernels' pointer arguments; statics: the arguments after them, the ray
    count and the packed block `small` (as a tensor) first. packed: pack's,
    whose block serves as small (else it is packed here)."""
    chain = frame_chain(scene, cfg, method)
    chain.check_kernels()
    small = pack_small(scene) if packed is None else packed.small
    rays = [o, d, corners, res["sdf_t"] if chain.use_sdf else None,
            res["sdf_tmin"] if chain.soft_sil else None,
            res["sdf_hit"] if chain.use_sdf else None,
            res["mesh_hit"] if chain.use_mesh else None,
            aux.get("closer") if chain.mixed else None, aux["mat"], res.get("sh_vis"),
            res["sh_ts"] if chain.soft_diff else None,
            res["ao_tmesh"] if chain.ao_mesh else None]
    sdf = scene.sdf
    statics = [o.shape[0], small, sdf.sph_center.shape[0], sdf.pln_normal.shape[0],
               sdf.box_center.shape[0], sdf.mb_center.shape[0], int(sdf.mb_iters),
               field_flag(sdf), scene.materials.albedo.shape[0], chain.n_dir, chain.n_pos,
               *(int(f) for f in (chain.use_sdf, chain.use_mesh, chain.ao_sdf, chain.ao_mesh,
                                  chain.soft_diff)),
               float(cfg.soft_silhouette) if chain.soft_sil else 0.0,
               float(cfg.mesh_silhouette) if chain.mesh_sil else 0.0,
               float(cfg.ao_step), float(cfg.ao_strength), float(cfg.soft_k),
               float(cfg.shadow_bias)]
    return chain, small, rays, statics


def _checked_args(name, scene, cfg, o, d, res, aux, corners, method: str, packed=None):
    """kernel_args, checked for the CUDA kernels, with the tensors as
    pointers: (chain, small, pointers, statics)."""
    chain, small, rays, statics = kernel_args(scene, cfg, o, d, res, aux, corners, method,
                                              packed)
    o, d, corners, t_bar, tmin, hs, hm, closer, mat, vis, ts, t_mesh = rays
    R = o.shape[0]
    n_lights = chain.n_dir + chain.n_pos
    for key, rows in (("sh_vis", vis), ("sh_ts", ts)):
        if rows is not None and tuple(rows.shape) != (n_lights, R):
            raise ValueError(f"{name}: {key} must be ({n_lights}, {R})")
    for key, col in (("ao_tmesh", t_mesh), ("sdf_tmin", tmin)):
        if col is not None and tuple(col.shape) != (R,):
            raise ValueError(f"{name}: {key} must be ({R},)")
    if chain.use_mesh and (corners is None or tuple(corners.shape) != (R, 9)):
        raise ValueError(f"{name}: a mesh chain needs the (R, 9) corners")
    check_cuda_inputs(name, o, d, corners, t_bar, tmin, vis, ts, t_mesh, small)
    _check_masks(name, hs, hm, closer, mat)
    statics[1] = small.data_ptr()
    return chain, small, [_ptr(t) for t in rays], statics


def shade_fwd(scene, cfg, o, d, res, method: str, corners=None, aux=None,
              mesh_rows=None, packed=None) -> torch.Tensor:
    """The shade of one ray block without gradient -> (R, 3); see
    shade_fwd_torch. aux: _make_aux's dict (made here when None). packed:
    pack(scene), the parameters packed once for many launches (packed here
    when None)."""
    if o.device.type == "cpu":
        return shade_fwd_torch(scene, cfg, o, d, res, method, corners=corners,
                               mesh_rows=mesh_rows)
    if aux is None:
        aux = _make_aux(scene, cfg, method, o, d, res, mesh_rows, packed)
    _, _, pointers, statics = _checked_args("shade_fwd", scene, cfg, o, d, res, aux,
                                            corners, method, packed)
    out = torch.empty((o.shape[0], 3), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        rc = kernel_lib().tr_shade_fwd(
            *pointers, *statics, out.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream)
    check_launch("shade_fwd", rc)
    LAUNCHES["shade_fwd"] += 1
    return out


def shade_bwd(scene, cfg, o, d, res, aux, corners, ct, method: str,
              counters=None, packed=None) -> dict:
    """Cotangents of the shade of one ray block; see shade_bwd_torch.
    packed: see shade_fwd."""
    if o.device.type == "cpu":
        return shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
    chain, small, pointers, statics = _checked_args("shade_bwd", scene, cfg, o, d, res,
                                                    aux, corners, method, packed)
    check_cuda_inputs("shade_bwd", o, ct)
    check_counters("shade_bwd", counters, o.device, SHADE_BWD_COUNTERS)
    R, dev = o.shape[0], o.device
    lib = kernel_lib()
    n_rows = -(-R // lib.tr_shade_bwd_threads())
    d_o = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d_d = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d_c = (torch.empty((R, 9), dtype=torch.float32, device=dev)
           if chain.use_mesh else None)
    partials = torch.empty((n_rows, small.numel()), dtype=torch.float32, device=dev)
    d_small = torch.empty_like(small)
    with torch.cuda.device(dev):
        rc = lib.tr_shade_bwd(
            *pointers, ct.data_ptr(), *statics, d_o.data_ptr(), d_d.data_ptr(),
            _ptr(d_c), partials.data_ptr(), n_rows, d_small.data_ptr(), _ptr(counters),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("shade_bwd", rc)
    LAUNCHES["shade_bwd"] += 1
    result = unpack_small(d_small, scene)
    result.update(o=d_o, d=d_d, corners=d_c)
    return result
