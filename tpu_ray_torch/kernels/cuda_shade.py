"""The fused shade backward: CUDA kernel, its plain version, and the
autograd Function around the shade of a ray block.

Counterpart of `tpu_ray/kernels/pallas_shade.py` (`shade_bwd_pallas` and
its wrapper `make_shade_sdf_vjp`). Kernel: `csrc/shade_bwd.cu`, over the
distance field's adjoint `csrc/sdf_adj.cuh`.

`ShadeFn` takes the scene's shade leaves (SHADE_PATHS), the rays o, d and
the selected triangles' corners. Its forward is the plain shade, as the
reference's default forward rule is; it saves only compact residuals: o, d,
the march t and hit masks, the shadow visibility and the soft march's
argmin t, the AO's mesh distance, the hit material and the mixed
closest-select mask, and the corners. Its backward is `shade_bwd`.

Dispatch follows the device: `shade_bwd` runs `shade_bwd_torch` (autograd
of the plain shade) on CPU tensors and launches the kernel on CUDA tensors,
raising on what the kernel does not take. Each kernel launch adds one to
`LAUNCHES["shade_bwd"]`. The chains the kernel takes: methods sdf, mesh_*
and mixed, directional and point lights, static shadow visibility (hard,
soft or none), the soft-shadow penumbra with `diff_vis`, the 5-tap AO, a
power-8 Mandelbulb of at most 16 iterations, float32. Not the silhouettes.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from tpu_ray_torch.kernels.build import check_cuda_inputs, check_launch, kernel_lib
from tpu_ray_torch.kernels.cuda_sdf import pack_sdf
from tpu_ray_torch.scene.types import apply_params, get_param
from tpu_ray_torch.sdf.primitives import FLOAT_FIELDS

LAUNCHES = {"shade_bwd": 0}

# the differentiable scene leaves of the shade chain, in the kernel's packed
# order after the SDF block; the vertices' gradient flows through the corners
SHADE_PATHS = tuple(f"sdf.{f}" for f in FLOAT_FIELDS) + (
    "materials.albedo", "lights.direction", "lights.color", "lights.ambient",
    "bg_top", "bg_bottom", "lights.position", "lights.pos_color")
_SMALL_PATHS = SHADE_PATHS[len(FLOAT_FIELDS):]
# the residuals the backward keeps (the geometry pass's hit state is not)
_SAVED_RES = ("sdf_t", "sdf_hit", "mesh_tri", "mesh_hit", "sh_vis", "sh_ts",
              "ao_tmesh")
_MAX_MB_ITERS = 16  # kMaxMbIters in csrc/sdf_adj.cuh


def wants_grad(scene, o, d, mesh_rows=None) -> bool:
    """Whether any input of the shade chain requires grad."""
    given = [o, d, mesh_rows, scene.mesh.verts,
             *(get_param(scene, p) for p in SHADE_PATHS)]
    return any(t is not None and t.requires_grad for t in given)


def kernel_spec(scene, cfg, method: str):
    """Static shape of the shade chain (what the kernel recomputes): a dict,
    or None on the CPU when the kernel does not take the chain, which then
    runs through autograd of the plain shade. On a CUDA device such a chain
    raises NotImplementedError: there is no plain fallback on the card."""
    use_sdf = method in ("sdf", "mixed") and scene.has_sdf
    use_mesh = method in ("mesh_brute", "mesh_grid", "mixed") and scene.has_mesh
    lights = scene.lights
    spec = {"use_sdf": use_sdf, "use_mesh": use_mesh,
            "mixed": use_sdf and use_mesh, "n_dir": lights.direction.shape[0],
            "n_pos": lights.position.shape[0],
            # the AO's SDF term runs whenever the scene has an SDF, its mesh
            # term when the traced method includes the mesh (render.make_ao)
            "ao_sdf": cfg.ao == "sdf5" and scene.has_sdf,
            "ao_mesh": cfg.ao == "sdf5" and use_mesh,
            "soft_diff": cfg.shadow == "soft" and cfg.diff_vis and use_sdf}
    sdf = scene.sdf
    why = None
    if not (use_sdf or use_mesh):
        why = f"method {method!r} on a scene without its geometry"
    elif method == "mixed" and not spec["mixed"]:
        why = "method 'mixed' without both an SDF and a mesh"
    elif cfg.soft_silhouette > 0.0:
        why = "soft_silhouette > 0"
    elif cfg.mesh_silhouette > 0.0:
        why = "mesh_silhouette > 0"
    elif spec["n_dir"] + spec["n_pos"] == 0:
        why = "a scene without lights"
    elif (use_sdf or spec["ao_sdf"]) and sdf.mb_center.shape[0] and not (
            sdf.mb_pow8 and sdf.mb_iters <= _MAX_MB_ITERS):
        why = f"a Mandelbulb other than power 8 with <= {_MAX_MB_ITERS} iterations"
    elif scene.camera.origin.dtype != torch.float32:
        why = f"dtype {scene.camera.origin.dtype}"
    if why is None:
        return spec
    if scene.device.type == "cuda":
        raise NotImplementedError(
            f"the shade backward kernel does not take {why} yet")
    return None


def _make_aux(scene, cfg, method: str, o, d, res, mesh_rows=None) -> dict:
    """The hit material id and the mixed closest-select mask: the geometry
    pass's residuals when it made them (with shadows), else recomputed."""
    if "hit_mat" not in res:
        from tpu_ray_torch.render.render import reconstruct_hits

        aux = {}
        with torch.no_grad():
            reconstruct_hits(scene, cfg, o.detach(), d.detach(), res, method,
                             lite=True, mesh_rows=mesh_rows, aux_out=aux)
        res = {"hit_mat": aux["mat"], "hit_closer": aux.get("closer")}
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


class ShadeFn(torch.autograd.Function):
    """colors = ShadeFn.apply(call, o, d, corners, *shade leaves): the plain
    shade forward; the fused shade backward (counterpart of
    `make_shade_sdf_vjp`)."""

    @staticmethod
    def forward(ctx, call: _ShadeCall, o, d, corners, *leaves):
        from tpu_ray_torch.render.render import _shade_plain

        out = _shade_plain(call.scene, call.cfg, o, d, call.res, call.method,
                           mesh_rows=call.mesh_rows)
        saved = {k: call.res[k] for k in _SAVED_RES if k in call.res}
        ctx.call = _ShadeCall(_detached(call.scene), call.cfg, call.method,
                              saved, call.aux)
        ctx.save_for_backward(o, d, corners)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        o, d, corners = (None if t is None else t.detach() for t in ctx.saved_tensors)
        c = ctx.call
        g = shade_bwd(c.scene, c.cfg, o, d, c.res, c.aux, corners,
                      ct.contiguous(), c.method)
        return (None, g["o"], g["d"], g["corners"],
                *(g[p] for p in SHADE_PATHS))


def shade(scene, cfg, o, d, res, method: str, corners=None, mesh_rows=None):
    """The shade of one ray block through ShadeFn -> (R, 3)."""
    aux = _make_aux(scene, cfg, method, o, d, res, mesh_rows)
    call = _ShadeCall(scene, cfg, method, res, aux, mesh_rows)
    return ShadeFn.apply(call, o, d, corners,
                         *(get_param(scene, p) for p in SHADE_PATHS))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the card's parity reference)
# ---------------------------------------------------------------------------

def shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method: str) -> dict:
    """Cotangents of the plain shade of one block given the output
    cotangent ct (R, 3): torch.autograd of `_shade_plain` with respect to
    the SHADE_PATHS leaves, o, d and the corners. Returns a dict by path
    plus "o", "d" and "corners" (None without a mesh); zeros for leaves the
    chain does not use."""
    from tpu_ray_torch.render.render import _shade_plain

    with torch.enable_grad():
        leaves = {p: get_param(scene, p).detach().requires_grad_(True)
                  for p in SHADE_PATHS}
        o_ = o.detach().requires_grad_(True)
        d_ = d.detach().requires_grad_(True)
        c_ = None if corners is None else corners.detach().requires_grad_(True)
        out = _shade_plain(apply_params(scene, leaves), cfg, o_, d_, res, method,
                           corners=c_)
        inputs = [o_, d_, *([] if c_ is None else [c_]), *leaves.values()]
        grads = torch.autograd.grad(out, inputs, grad_outputs=ct,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    result = dict(zip(SHADE_PATHS, grads[-len(SHADE_PATHS):]))
    result.update(o=grads[0], d=grads[1], corners=None if c_ is None else grads[2])
    return result


def ill_conditioned_rays(scene, cfg, o, d, res, corners, ct, method: str):
    """(R,) bool: the rays on which shade_bwd_torch in float32 is itself off
    by more than 1e-3, the parity checks' per-ray bound, in d_o or d_d from
    the same computation in float64 on the same inputs. Where the AO taps
    or the penumbra read the Mandelbulb near its surface, float32 rounding
    alone moves a ray's cotangents that far: no float32 version has an
    answer there to agree on, so the parity checks set such rays apart. The
    kernel takes no part in picking them."""
    def f64(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    scene64 = apply_params(scene, {p: f64(get_param(scene, p)) for p in SHADE_PATHS})
    res64 = {k: f64(v) for k, v in res.items() if k != "hits"}
    g32 = shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
    g64 = shade_bwd_torch(scene64, cfg, f64(o), f64(d), res64, f64(corners), f64(ct), method)
    rel = [(g32[k].double() - g64[k]).norm(dim=1) / g64[k].norm(dim=1).clamp_min(1e-300)
           for k in ("o", "d")]
    return torch.maximum(*rel) > 1e-3


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def pack_small(scene) -> torch.Tensor:
    """The kernel's packed float32 parameter block (layout in
    csrc/shade_bwd.cu): the SDF block of pack_sdf, then the SHADE_PATHS
    leaves after the SDF's, flattened."""
    parts = [pack_sdf(scene.sdf)]
    parts += [get_param(scene, p).reshape(-1).to(torch.float32) for p in _SMALL_PATHS]
    return torch.cat(parts).contiguous()


def unpack_small(vec: torch.Tensor, scene) -> dict:
    """Cotangents by path from a vector in pack_small's layout (zero for
    mb_power, which the power-8 field does not read)."""
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
    blk = take(sdf.mb_center.shape[0], 4)
    out["sdf.mb_center"], out["sdf.mb_scale"] = blk[:, :3], blk[:, 3]
    out["sdf.mb_power"] = torch.zeros_like(vec[:sdf.mb_power.shape[0]])
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


def shade_bwd(scene, cfg, o, d, res, aux, corners, ct, method: str) -> dict:
    """Cotangents of the shade of one ray block; see shade_bwd_torch."""
    if o.device.type == "cpu":
        return shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
    spec = kernel_spec(scene, cfg, method)
    R, dev = o.shape[0], o.device
    small = pack_small(scene)
    t_bar = res["sdf_t"] if spec["use_sdf"] else None
    hs = res["sdf_hit"] if spec["use_sdf"] else None
    hm = res["mesh_hit"] if spec["use_mesh"] else None
    closer = aux.get("closer") if spec["mixed"] else None
    vis = res.get("sh_vis")
    ts = res["sh_ts"] if spec["soft_diff"] else None
    t_mesh = res["ao_tmesh"] if spec["ao_mesh"] else None
    n_lights = spec["n_dir"] + spec["n_pos"]
    for name, rows in (("sh_vis", vis), ("sh_ts", ts)):
        if rows is not None and tuple(rows.shape) != (n_lights, R):
            raise ValueError(f"shade_bwd: {name} must be ({n_lights}, {R})")
    if t_mesh is not None and tuple(t_mesh.shape) != (R,):
        raise ValueError(f"shade_bwd: ao_tmesh must be ({R},)")
    if spec["use_mesh"] and (corners is None or tuple(corners.shape) != (R, 9)):
        raise ValueError("shade_bwd: a mesh chain needs the (R, 9) corners")
    check_cuda_inputs("shade_bwd", o, d, corners, t_bar, vis, ts, t_mesh, ct, small)
    _check_masks("shade_bwd", hs, hm, closer, aux["mat"])
    lib = kernel_lib()
    threads = lib.tr_shade_bwd_threads()
    n_rows = -(-R // threads)
    d_o = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d_d = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d_c = (torch.empty((R, 9), dtype=torch.float32, device=dev)
           if spec["use_mesh"] else None)
    partials = torch.empty((n_rows, small.numel()), dtype=torch.float32, device=dev)
    d_small = torch.empty_like(small)
    sdf = scene.sdf
    with torch.cuda.device(dev):
        rc = lib.tr_shade_bwd(
            o.data_ptr(), d.data_ptr(), _ptr(corners), _ptr(t_bar), _ptr(hs),
            _ptr(hm), _ptr(closer), aux["mat"].data_ptr(), _ptr(vis), _ptr(ts),
            _ptr(t_mesh), ct.data_ptr(), R, small.data_ptr(),
            sdf.sph_center.shape[0], sdf.pln_normal.shape[0],
            sdf.box_center.shape[0], sdf.mb_center.shape[0], int(sdf.mb_iters),
            scene.materials.albedo.shape[0], spec["n_dir"], spec["n_pos"],
            *(int(spec[k]) for k in ("use_sdf", "use_mesh", "ao_sdf", "ao_mesh",
                                     "soft_diff")),
            float(cfg.ao_step), float(cfg.ao_strength), float(cfg.soft_k),
            float(cfg.shadow_bias), d_o.data_ptr(),
            d_d.data_ptr(), _ptr(d_c), partials.data_ptr(), n_rows,
            d_small.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("shade_bwd", rc)
    LAUNCHES["shade_bwd"] += 1
    result = unpack_small(d_small, scene)
    result.update(o=d_o, d=d_d, corners=d_c)
    return result
