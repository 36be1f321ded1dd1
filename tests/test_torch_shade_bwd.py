"""The port's shade backward against the JAX package: the IFT attach and the
Hessian-preserving normal, the plain shade backward (`shade_bwd_torch`)
against the Pallas kernel in interpret mode and against `jax.grad` of the
XLA shade, with and without the soft SDF silhouette and the mesh edge
band, `ShadeFn` against autograd of the plain shade, the chains the CUDA
kernels refuse, and a host build of the CUDA kernel's per-ray arithmetic
against the plain version; the host builds of the soft and the hard shadow
march against theirs; the backward kernel's class-sorted block against its
load order, and its fixed-order sums against float64.

Tolerances and why:
  * smooth parameter groups (albedo, light colour and direction, ambient,
    sky colours, sphere, mesh corners): max|a - b| / max|b| < 1e-4, f32
    summation order.
  * the Mandelbulb leaves and the camera's o and d: cosine > 0.999 and
    max|a - b| / max|b| < 5e-2, as the reference's own kernel-vs-XLA test
    (tests/test_pallas_shade.py): the fractal's second-order chain
    amplifies f32 reassociation on boundary rays.
  * the host build of the CUDA arithmetic against the plain version: the
    same bounds, plus the 99th percentile of the per-ray relative error of
    d_o, d_d and d_corners < 1e-3 (the on-card check of chip_smoke.py).
    Where the AO taps or the soft-shadow penumbra evaluate the Mandelbulb,
    float32 rounding alone moves some rays' cotangents by more than that:
    `cuda_shade.ill_conditioned_rays` picks them from the plain version
    and its float64 evaluation, without the host build. At most 25% of the
    rays may be such (measured: 14% at 24x24 on `mandelbulb` with
    diff_vis), and with their cotangent set to 0 every bound above holds
    on the rest.
  * the host build of the kernels' chain order (the bulb's forward at an
    argmin run once, the AO taps in lock-step) against the host build of
    the serial chain (TR_SHADE_SERIAL): every cotangent bit-equal.
  * the kernels' arguments packed once (cuda_shade.pack) against packed
    per call: bit-equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.kernels import pallas_shade
from tpu_ray.kernels import sphere_trace as jst
from tpu_ray.render import camera as jcam
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray.sdf import primitives as jprim
from tpu_ray_torch.fit import apply_params, extract_params
from tpu_ray_torch.kernels import cuda_reconstruct, cuda_sdf, cuda_shade
from tpu_ray_torch.kernels import sphere_trace as tst
from tpu_ray_torch.render import plain as tplain
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.render.chain import frame_chain
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.scene.types import Lights
from tpu_ray_torch.sdf import primitives as tprim
import torch_host_build
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)

SMOOTH = ("materials.albedo", "lights.color", "lights.direction", "lights.ambient",
          "bg_top", "bg_bottom", "sdf.sph_center", "sdf.sph_radius")
CHAOTIC = ("sdf.mb_center", "sdf.mb_scale", "o", "d")
_INT = {"sph_mat", "pln_mat", "box_mat", "mb_mat"}
MIXED_SDF = dict(mb_center=[[1.4, 1.05, 0.0]], mb_scale=[0.9], mb_power=[8.0],
                 mb_mat=[2], sph_center=[[0.0, 0.55, -1.6]], sph_radius=[0.55],
                 sph_mat=[3])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12) if b.size else 0.0


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_groups(got, want, smooth, chaotic=()):
    for k in smooth:
        assert _rel(got[k], want[k]) < 1e-4, (k, _rel(got[k], want[k]))
    for k in chaotic:
        assert _cos(got[k], want[k]) > 0.999 and _rel(got[k], want[k]) < 5e-2, (
            k, _cos(got[k], want[k]), _rel(got[k], want[k]))


def _to_torch(res):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in res.items()}


def _jax_block(jscene, jcfg, width, method):
    """Rays of a width x width frame, their JAX geometry residuals and the
    same in torch, with the port's copy of the scene and a seeded ct."""
    sx, sy = jrender.pixel_sample_coords(jcfg, jnp.float32)
    o, d = jcam.generate_rays(jscene.camera, sx.ravel(), sy.ravel(), width, width)
    rows = jrender.mesh_table(jscene.mesh) if jscene.has_mesh else None
    res = jrender.geometry_residuals(jscene, jcfg, o, d, method, mesh_rows=rows)
    ct = np.random.default_rng(0).uniform(-1, 1, (width * width, 3)).astype(np.float32)
    tscene = port_scene(jscene)
    return (o, d, rows, res, jnp.asarray(ct)), (
        tscene, torch.as_tensor(np.asarray(o)), torch.as_tensor(np.asarray(d)),
        _to_torch(res), torch.as_tensor(ct))


def _get(scene, path):
    obj = scene
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _put(scene, path, value):
    head, *rest = path.split(".")
    if not rest:
        return scene.replace(**{head: value})
    return scene.replace(**{head: _put(getattr(scene, head), ".".join(rest), value)})


def _corners(tscene, tres):
    rows = tplain.mesh_table(tscene.mesh)
    return rows[torch.clamp(tres["mesh_tri"], 0, rows.shape[0] - 1).long()][:, :9]


def _sdf_pair(spec):
    jkw = {k: jnp.asarray(np.asarray(v, np.int32 if k in _INT else np.float32))
           for k, v in spec.items()}
    tkw = {k: torch.as_tensor(np.asarray(v, np.int32 if k in _INT else np.float32))
           for k, v in spec.items()}
    return (jprim.SdfScene.empty(jnp.float32).replace(**jkw, mb_pow8=True),
            tprim.SdfScene.empty().replace(**tkw, mb_pow8=True))


def _hit_rays(n, seed):
    """Rays from the `mixed` camera at the bulb and the sphere, marched."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([0.1, 1.9, 4.6]), (n, 1))
    tgt = np.concatenate([rng.uniform([0.8, 0.5, -0.6], [2.0, 1.6, 0.6], (n // 2, 3)),
                          rng.uniform([-0.4, 0.2, -2.0], [0.4, 0.9, -1.2], (n - n // 2, 3))])
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the IFT attach and the normal's Hessian term
# ---------------------------------------------------------------------------

def test_ift_attach_and_normal_match_jax():
    js, ts = _sdf_pair(MIXED_SDF)
    o, d = _hit_rays(256, 1)
    t, hit, _, _ = cuda_sdf.march_torch(ts, torch.as_tensor(o), torch.as_tensor(d),
                                        t0=0.0, max_steps=96, eps=1e-3, t_far=40.0)
    assert 0.3 < hit.float().mean() < 1.0
    t_bar, hit_f = t.numpy(), hit.float().numpy()
    rng = np.random.default_rng(2)
    w_t = rng.uniform(-1, 1, 256).astype(np.float32)
    w_n = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    keys = ("sph_center", "sph_radius", "mb_center", "mb_scale")

    # JAX, op by op (no multiply-add contraction)
    attach = jst.make_ift_attach(jprim.sdf_distance)

    def jloss(leaves, oo, dd):
        sdf = js.replace(**leaves)
        tt = attach(sdf, oo, dd, jnp.asarray(t_bar), jnp.asarray(hit_f))
        p = oo + tt[:, None] * dd
        n = jst.surface_normal(jprim.sdf_distance, sdf, p)
        return jnp.sum(jnp.asarray(w_t) * tt) + jnp.sum(jnp.asarray(w_n) * n)

    with jax.enable_x64(False), jax.disable_jit():
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            {k: getattr(js, k) for k in keys}, jnp.asarray(o), jnp.asarray(d))

    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in keys}
    ot = torch.as_tensor(o).requires_grad_(True)
    dt = torch.as_tensor(d).requires_grad_(True)
    sdf = ts.replace(**leaves)
    tt = tst.IftAttach.apply(tprim.sdf_distance, sdf, ot, dt, t, hit.float(),
                             *sdf.float_leaves())
    n = tst.surface_normal(tprim.sdf_distance, sdf, ot + tt[:, None] * dt,
                           create_graph=True)
    (torch.sum(torch.as_tensor(w_t) * tt) + torch.sum(torch.as_tensor(w_n) * n)).backward()
    got = {f"sdf.{k}": v.grad.numpy() for k, v in leaves.items()}
    got.update(o=ot.grad.numpy(), d=dt.grad.numpy())
    want = {f"sdf.{k}": np.asarray(v) for k, v in jg[0].items()}
    want.update(o=np.asarray(jg[1]), d=np.asarray(jg[2]))
    _assert_groups(got, want, ("sdf.sph_center", "sdf.sph_radius"), CHAOTIC)


def test_ift_attach_is_the_value_and_zero_on_misses():
    _, ts = _sdf_pair(MIXED_SDF)
    o = torch.tensor([[0.1, 1.9, 4.6]] * 2)
    d = torch.nn.functional.normalize(torch.tensor([[0.0, 5.0, 0.0], [1.3, -0.85, -4.6]]), dim=-1)
    t_bar = torch.tensor([40.0, 4.5])
    ot = o.clone().requires_grad_(True)
    r = ts.sph_radius.clone().requires_grad_(True)
    sdf = ts.replace(sph_radius=r)
    t = tst.IftAttach.apply(tprim.sdf_distance, sdf, ot, d, t_bar, torch.tensor([0.0, 1.0]),
                            *sdf.float_leaves())
    assert torch.equal(t, t_bar)
    t[0].backward()
    assert torch.count_nonzero(ot.grad) == 0
    assert r.grad is None or torch.count_nonzero(r.grad) == 0


# ---------------------------------------------------------------------------
# (b) the plain shade backward against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _small_mixed():
    """The JAX test's tiny mixed scene: 10 triangles + ground + one sphere."""
    scene, cfg = jscenes.build_scene("triangles", dtype=jnp.float32)
    scene = scene.replace(sdf=scene.sdf.replace(
        sph_center=jnp.asarray([[0.4, 0.8, 0.3]], jnp.float32),
        sph_radius=jnp.asarray([0.62], jnp.float32),
        sph_mat=jnp.asarray([1], jnp.int32)))
    return scene, cfg.replace(method="mixed")


def _pallas_case(name, **over):
    """A bulb-free scene of the reference's kernel tests at 20x20, its JAX
    rays, residuals and cotangent, and their copies in the port."""
    if name == "small_mixed":
        jscene, jcfg = _small_mixed()
    else:
        jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=20, height=20, spp=1, block_size=0, diff_vis=False,
                            max_steps=64, pallas="off").replace(**over)
        method = jrender.resolve_method(jscene, jcfg)
        return jscene, jcfg, method, _jax_block(jscene, jcfg, 20, method)


def _pallas_want(jscene, jcfg, method, o, d, rows, res, ct):
    """shade_bwd_pallas in interpret mode, by the port's paths."""
    with jax.enable_x64(False):
        corners = (None if rows is None else
                   rows[jnp.clip(res["mesh_tri"], 0, rows.shape[0] - 1)][:, :9])
        aux = pallas_shade._make_aux(jcfg, method, jscene, o, d, res, corners=corners)
        d_ops, d_prm, d_o, d_d, d_c = pallas_shade.shade_bwd_pallas(
            jscene, jcfg, o, d, res, aux, ct, method, interpret=True)
    want = {"o": d_o, "d": d_d, "corners": d_c}
    names = {"albedo": "materials.albedo", "ldir": "lights.direction",
             "lcol": "lights.color", "ambient": "lights.ambient",
             "bg_top": "bg_top", "bg_bottom": "bg_bottom"}
    want.update({names[k]: v for k, v in d_prm.items()})
    it = iter(d_ops)  # the kernel's SDF operands: the non-empty leaves in order
    for f in dataclasses.fields(jscene.sdf):
        v = getattr(jscene.sdf, f.name)
        if hasattr(v, "size") and v.size > 0:
            c = next(it)
            if f.name not in _INT:
                want[f"sdf.{f.name}"] = c
    return want


@pytest.mark.parametrize("name", ["small_mixed", "triangles"])
def test_shade_bwd_torch_matches_pallas_kernel(name):
    jscene, jcfg, method, ((o, d, rows, res, ct), (tscene, ot, dt, tres, ctt)) = \
        _pallas_case(name)
    want = _pallas_want(jscene, jcfg, method, o, d, rows, res, ct)
    got = cuda_shade.shade_bwd_torch(tscene, port_cfg(jcfg), ot, dt, tres,
                                     _corners(tscene, tres), ctt, method)
    assert set(want) <= set(got)
    hit = np.asarray(res["mesh_hit"]) | (np.asarray(res["sdf_hit"]) if "sdf_hit" in res else False)
    assert 0.1 < hit.mean() < 0.95
    _assert_groups(got, want, sorted(want))


# the reference's own silhouette cases (tests/test_pallas_shade.py:139-172)
SILHOUETTE_CASES = [
    pytest.param("sphere", dict(soft_silhouette=0.05), id="sphere-soft"),
    pytest.param("triangles", dict(mesh_silhouette=0.06), id="triangles-mesh"),
    pytest.param("small_mixed", dict(shadow="soft", diff_vis=True, ao="sdf5",
                                     soft_silhouette=0.05, mesh_silhouette=0.06),
                 id="small_mixed-both"),
]


def _silhouette_lanes(res, cfg):
    """The lanes a silhouette chain reads: the SDF's misses (sigmoid
    coverage at tmin) and the mesh hits (edge band)."""
    n = int(np.sum(~np.asarray(res["sdf_hit"]))) if cfg.soft_silhouette else 0
    return n + (int(np.sum(np.asarray(res["mesh_hit"]))) if cfg.mesh_silhouette else 0)


@pytest.mark.parametrize("name,over", SILHOUETTE_CASES)
def test_silhouette_shade_bwd_torch_matches_pallas_kernel(name, over):
    """The soft SDF silhouette's sigmoid at tmin (miss lanes carry the SDF
    chain) and the mesh edge band's margin, against the Pallas kernel."""
    jscene, jcfg, method, ((o, d, rows, res, ct), (tscene, ot, dt, tres, ctt)) = \
        _pallas_case(name, **over)
    assert _silhouette_lanes(res, jcfg) > 0
    want = _pallas_want(jscene, jcfg, method, o, d, rows, res, ct)
    got = cuda_shade.shade_bwd_torch(tscene, port_cfg(jcfg), ot, dt, tres,
                                     _corners(tscene, tres) if tscene.has_mesh else None,
                                     ctt, method)
    _assert_groups(got, want, sorted(k for k in want if want[k] is not None))


@pytest.mark.parametrize("name,over", SILHOUETTE_CASES)
def test_silhouette_shade_bwd_torch_matches_jax_grad(name, over):
    """The same chains against jax.grad of the XLA shade, per group."""
    jscene, jcfg, method, ((o, d, rows, res, ct), (tscene, ot, dt, tres, ctt)) = \
        _pallas_case(name, **over)
    paths = [p for p in PARAM_PATHS if np.size(_get(jscene, p))]

    def loss(params, oo, dd, rws):
        s = jscene
        for p, v in params.items():
            s = _put(s, p, v)
        return jnp.sum(ct * jrender._shade_xla(s, jcfg, oo, dd, res, method, mesh_rows=rws))

    with jax.enable_x64(False):
        jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2) + ((3,) if rows is not None else ())))(
            {p: _get(jscene, p) for p in paths}, o, d, rows)
    corners = _corners(tscene, tres) if tscene.has_mesh else None
    got = cuda_shade.shade_bwd_torch(tscene, port_cfg(jcfg), ot, dt, tres, corners, ctt,
                                     method)
    want = {p: np.asarray(v) for p, v in jg[0].items()}
    want.update(o=np.asarray(jg[1]), d=np.asarray(jg[2]))
    if corners is not None:
        idx = jnp.clip(res["mesh_tri"], 0, rows.shape[0] - 1)
        want["corners"] = np.asarray(jg[3])[:, :9]
        got["corners"] = torch.zeros(rows.shape[0], 9).index_add_(
            0, torch.as_tensor(np.asarray(idx)).long(), got["corners"])
    _assert_groups(got, want, sorted(k for k in want if np.abs(want[k]).max() > 0))


# ---------------------------------------------------------------------------
# (c) the plain shade backward against jax.grad of the XLA shade, with the
#     Mandelbulb
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed16():
    jscene, jcfg = jscenes.build_scene("mixed", dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=16, height=16, spp=1, block_size=0, max_steps=96,
                            pallas="off")
        return jscene, jcfg, _jax_block(jscene, jcfg, 16, "mixed")


PARAM_PATHS = ("materials.albedo", "lights.color", "lights.direction", "lights.ambient",
               "bg_top", "bg_bottom", "sdf.sph_center", "sdf.sph_radius",
               "sdf.mb_center", "sdf.mb_scale")


def test_shade_bwd_torch_matches_jax_grad_mixed(mixed16):
    jscene, jcfg, ((o, d, rows, res, ct), (tscene, ot, dt, tres, ctt)) = mixed16
    idx = jnp.clip(res["mesh_tri"], 0, rows.shape[0] - 1)

    def loss(params, oo, dd, rws):
        s = jscene
        for p, v in params.items():
            s = _put(s, p, v)
        return jnp.sum(ct * jrender._shade_xla(s, jcfg, oo, dd, res, "mixed", mesh_rows=rws))

    with jax.enable_x64(False):
        jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            {p: _get(jscene, p) for p in PARAM_PATHS}, o, d, rows)
    got = cuda_shade.shade_bwd_torch(tscene, port_cfg(jcfg), ot, dt, tres,
                                     _corners(tscene, tres), ctt, "mixed")
    want = {p: np.asarray(v) for p, v in jg[0].items()}
    want.update(o=np.asarray(jg[1]), d=np.asarray(jg[2]),
                corners=np.asarray(jg[3])[:, :9])
    got["corners"] = torch.zeros(rows.shape[0], 9).index_add_(
        0, torch.as_tensor(np.asarray(idx)).long(), got["corners"])
    sel_sdf = np.asarray(res["sdf_hit"]) & np.asarray(res["hit_closer"])
    assert sel_sdf.sum() >= 8  # Mandelbulb and sphere hits take the IFT path
    _assert_groups(got, want, SMOOTH + ("corners",), CHAOTIC)


# ---------------------------------------------------------------------------
# (d) ShadeFn against autograd of the plain shade; (e) what the kernel takes
# ---------------------------------------------------------------------------

def _shade_grads(fn, tscene, tcfg, o, d, res, ct):
    params = extract_params(tscene, ("sdf.sph_radius", "sdf.mb_scale", "sdf.mb_center",
                                     "materials.albedo", "lights.color",
                                     "lights.direction", "mesh.verts"))
    s = apply_params(tscene, params)
    oo, dd = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    rows = tplain.mesh_table(s.mesh)
    torch.sum(ct * fn(s, tcfg, oo, dd, res, "mixed", mesh_rows=rows)).backward()
    return dict({p: v.grad for p, v in params.items()}, o=oo.grad, d=dd.grad)


def test_shade_fn_gradient_equals_plain_autograd(mixed16):
    jscene, jcfg, (_, (tscene, ot, dt, tres, ctt)) = mixed16
    tcfg = port_cfg(jcfg)
    before = dict(cuda_shade.LAUNCHES)
    a = _shade_grads(trender.shade_with_residuals, tscene, tcfg, ot, dt, tres, ctt)
    b = _shade_grads(tplain.shade_plain, tscene, tcfg, ot, dt, tres, ctt)
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b[k].abs().max()), err_msg=k)
    assert cuda_shade.LAUNCHES == before == {"shade_fwd": 0, "shade_bwd": 0}


def test_shade_fn_hands_the_kernel_what_it_takes(monkeypatch):
    """The render's backward calls shade_bwd once per block with what the
    CUDA wrapper accepts: contiguous float32 tensors that need no grad,
    bool or int32 masks, per-ray shapes."""
    scene, cfg = tscenes.build_scene("mixed", device="cpu")
    cfg = cfg.replace(width=8, height=8, spp=4, block_size=128, max_steps=64)
    calls = []
    plain = cuda_shade.shade_bwd

    def spy(s, c, o, d, res, aux, corners, ct, method, packed=None):
        n = o.shape[0]
        floats = (o, d, corners, ct, res["sdf_t"], res["sh_vis"], cuda_shade.pack_small(s),
                  packed.small)
        for t in floats:
            assert t.dtype == torch.float32 and t.is_contiguous() and not t.requires_grad
        assert torch.equal(packed.small, cuda_shade.pack_small(s))  # the frame's, packed once
        for t in (res["sdf_hit"], res["mesh_hit"], aux["closer"], aux["mat"]):
            assert t.dtype in (torch.bool, torch.int32) and t.is_contiguous()
        assert corners.shape == (n, 9) and ct.shape == (n, 3) and res["sh_vis"].shape == (1, n)
        calls.append(n)
        return plain(s, c, o, d, res, aux, corners, ct, method, packed=packed)

    monkeypatch.setattr(cuda_shade, "shade_bwd", spy)
    params = extract_params(scene, ("sdf.mb_scale", "camera.origin", "mesh.verts"))
    torch.mean(trender.render_image(apply_params(scene, params), cfg) ** 2).backward()
    assert calls == [128, 128]
    assert all(torch.isfinite(v.grad).all() for v in params.values())


@pytest.mark.parametrize("grad", [True, False])
def test_render_hands_the_forward_kernel_what_it_takes(monkeypatch, grad):
    """With and without a gradient the render calls shade_fwd once per block
    with what the CUDA wrapper accepts: contiguous float32 tensors that need
    no grad (the scene's packed parameters too), bool or int32 masks."""
    scene, cfg = tscenes.build_scene("mixed", device="cpu")
    cfg = cfg.replace(width=8, height=8, spp=4, block_size=128, max_steps=64,
                      soft_silhouette=0.05, mesh_silhouette=0.05)
    calls = []
    plain = cuda_shade.shade_fwd

    def spy(s, c, o, d, res, method, corners=None, aux=None, mesh_rows=None, packed=None):
        small = cuda_shade.pack_small(s)
        for t in (o, d, corners, res["sdf_t"], res["sdf_tmin"], res["sh_vis"], small,
                  packed.small):
            assert t.dtype == torch.float32 and t.is_contiguous() and not t.requires_grad
        assert torch.equal(packed.small, small)  # the frame's, packed once
        assert corners.shape == (o.shape[0], 9)
        calls.append((o.shape[0], aux is not None))
        return plain(s, c, o, d, res, method, corners=corners, aux=aux, mesh_rows=mesh_rows,
                     packed=packed)

    monkeypatch.setattr(cuda_shade, "shade_fwd", spy)
    params = extract_params(scene, ("sdf.mb_scale", "camera.origin", "mesh.verts"))
    if grad:
        torch.mean(trender.render_image(apply_params(scene, params), cfg) ** 2).backward()
        assert all(torch.isfinite(v.grad).all() for v in params.values())
        assert calls == [(128, True), (128, True)]
    else:
        with torch.no_grad():
            trender.render_image(apply_params(scene, params), cfg)
        assert calls == []  # the CPU renders without a gradient through shade_plain


def test_kernel_spec_refuses_unported_chains_on_cuda():
    """The chain (render/chain.py): the kernels take the silhouettes, the
    AO and the penumbra; they refuse float64 and a scene without lights,
    which raises where the kernels run (check_kernels) and on the CPU
    sends the shade to plain autograd (render.shade_with_residuals)."""
    scene, cfg = tscenes.build_scene("mixed", device="cpu")
    cfg = cfg.replace(width=8, height=8, spp=1)
    taken = {"ao": cfg.replace(ao="sdf5"),
             "penumbra": cfg.replace(shadow="soft", diff_vis=True),
             "soft_sil": cfg.replace(soft_silhouette=0.02),
             "mesh_sil": cfg.replace(mesh_silhouette=0.01)}
    chain = frame_chain(scene, cfg, "mixed")
    assert chain.mixed and chain.n_dir == 1 and chain.n_pos == 0 and chain.why is None
    assert not any((chain.ao_sdf, chain.ao_mesh, chain.soft_diff, chain.soft_sil,
                    chain.mesh_sil))
    chain.check_kernels()
    dark = scene.replace(lights=Lights.make(torch.zeros(0, 3), torch.zeros(0, 3)))
    wide = scene.replace(camera=dataclasses.replace(
        scene.camera, origin=scene.camera.origin.double()))
    refused = {"without lights": (dark, cfg), "float64": (wide, cfg)}
    ao = frame_chain(scene, taken["ao"], "mixed")
    assert ao.ao_sdf and ao.ao_mesh and not ao.soft_diff
    pen = frame_chain(scene, taken["penumbra"], "mixed")
    assert pen.soft_diff and not (pen.ao_sdf or pen.ao_mesh)
    assert frame_chain(scene, taken["soft_sil"], "mixed").soft_sil
    assert frame_chain(scene, taken["mesh_sil"], "mixed").mesh_sil
    # a silhouette of geometry the method does not trace is not a chain
    assert not frame_chain(scene, taken["mesh_sil"], "sdf").mesh_sil
    for what, (s, c) in refused.items():
        refusal = frame_chain(s, c, "mixed")
        assert refusal.traced and what in refusal.why
        with pytest.raises(NotImplementedError, match=f"shade kernels do not take.*{what}"):
            refusal.check_kernels()


@pytest.mark.parametrize("iters", [12, 20], ids=["12-iterations", "20-iterations"])
def test_kernel_spec_takes_the_generic_bulb_on_cuda(iters):
    """A generic-power Mandelbulb (`mb_pow8=False`, as a `sdf.mb_power`
    fit makes it) at any iteration count is a chain the kernels take, with
    the AO and the penumbra; its wrappers pass the generic field's flag and
    the bulb's power in the packed block."""
    scene, cfg = tscenes.build_scene("mandelbulb", device="cpu")
    generic = scene.replace(sdf=scene.sdf.replace(mb_pow8=False, mb_iters=iters,
                                                  mb_power=torch.tensor([7.5])))
    cfg = cfg.replace(width=8, height=8, spp=1, diff_vis=True)
    chain = frame_chain(generic, cfg, "sdf")
    assert chain.use_sdf and chain.ao_sdf and chain.soft_diff and chain.why is None
    params, counts, _ = cuda_sdf._sdf_args(generic.sdf)
    assert counts[-2:] == (iters, 0) and cuda_sdf._sdf_args(scene.sdf)[1][-1] == 1
    assert float(params[-1]) == 7.5  # the bulb's row ends in its power
    o = torch.zeros(4, 3)
    res = {"sdf_t": torch.ones(4), "sdf_hit": torch.ones(4, dtype=torch.bool),
           "sh_vis": torch.ones(1, 4), "sh_ts": torch.ones(1, 4)}
    statics = cuda_shade.kernel_args(generic, cfg, o, o, res, {"mat": torch.zeros(4)}, None,
                                     "sdf")[3]
    assert statics[6:8] == [iters, 0]  # mb_iters, mb_pow8


def test_silhouette_gradient_on_cpu_runs_plain_autograd():
    """A silhouette chain differentiates on the CPU through the kernels'
    plain versions: no kernel launches there."""
    scene, cfg = tscenes.build_scene("sphere", device="cpu")
    cfg = cfg.replace(width=12, height=12, soft_silhouette=0.05)
    r = scene.sdf.sph_radius.clone().requires_grad_(True)
    img = trender.render_image(scene.replace(sdf=scene.sdf.replace(sph_radius=r)), cfg)
    torch.mean(img ** 2).backward()
    assert torch.isfinite(r.grad).all() and float(r.grad.abs()) > 0
    assert cuda_shade.LAUNCHES == {"shade_fwd": 0, "shade_bwd": 0}


def test_pack_small_round_trips():
    scene, _ = tscenes.build_scene("mixed", device="cpu")
    scene = scene.replace(lights=Lights.make([[0.6, 0.8, 0.3], [-0.2, 1.0, 0.1]],
                                             [[1.0, 1.0, 1.0], [0.3, 0.2, 0.1]],
                                             positions=[[0.5, 2.5, 1.0]],
                                             pos_colors=[[2.0, 1.5, 1.0]]))
    back = cuda_shade.unpack_small(cuda_shade.pack_small(scene), scene)
    for p in cuda_shade.SHADE_PATHS:  # sdf.mb_power included: a bulb packs its power
        assert torch.equal(back[p], cuda_shade.get_param(scene, p)), p


# ---------------------------------------------------------------------------
# The CUDA kernel's per-ray arithmetic, built as host C++
# ---------------------------------------------------------------------------

def _per_ray_rel(got, want, keys):
    """Per ray, the largest |got - want| / |want| over the (R, k) keys (0 where
    want is 0)."""
    rel = [(got[k] - want[k]).norm(dim=1) / want[k].norm(dim=1).clamp_min(1e-30)
           for k in keys]
    return torch.stack(rel).amax(0)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = torch_host_build.build(tmp_path_factory.mktemp("host_kernel"))
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


@pytest.mark.parametrize("name,point_light,over", torch_host_build.HOST_CASES)
def test_kernel_arithmetic_matches_plain_version(host_kernel, name, point_light, over):
    scene, cfg, method, o, d, res, corners = torch_host_build.case(name, point_light, over)
    gen = torch.Generator().manual_seed(0)
    ct = torch.rand(o.shape, generator=gen) * 2 - 1
    want = cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
    got = torch_host_build.shade_bwd(host_kernel, scene, cfg, o, d, res, corners, ct, method)
    if scene.sdf.mb_center.shape[0] and (cfg.ao != "none" or cfg.diff_vis):
        # the ill-conditioned rays, picked without the host build (module
        # docstring)
        ill = cuda_shade.ill_conditioned_rays(scene, cfg, o, d, res, corners, ct, method)
        assert 0.0 < float(ill.float().mean()) <= 0.25
        ct = torch.where(ill[:, None], 0.0, ct)
        want = cuda_shade.shade_bwd_torch(scene, cfg, o, d, res, corners, ct, method)
        got = torch_host_build.shade_bwd(host_kernel, scene, cfg, o, d, res, corners, ct,
                                         method)
    params = [p for p in cuda_shade.SHADE_PATHS if want[p].abs().sum() > 0]
    assert {"materials.albedo", "lights.color", "bg_top"} <= set(params)
    if point_light or name == "pointlight":
        assert {"lights.position", "lights.pos_color"} <= set(params)
    if cfg.shadow == "soft" and cfg.diff_vis:  # the penumbra moves the lights
        assert {"lights.direction", "sdf.pln_normal"} <= set(params)
    _assert_groups(got, want, [p for p in params if not p.startswith("sdf.mb_")],
                   [p for p in params if p.startswith("sdf.mb_")] + ["o", "d"])
    for k in ("o", "d", "corners"):
        if want[k] is None:
            continue
        nz = want[k].norm(dim=1) > 0
        per = _per_ray_rel(got, want, (k,))[nz]
        assert per.numel() == 0 or float(torch.quantile(per, 0.99)) < 1e-3, k


@pytest.fixture(scope="module")
def host_serial(tmp_path_factory):
    so = torch_host_build.build(tmp_path_factory.mktemp("host_serial"), serial=True)
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


@pytest.mark.parametrize("name,point_light,over", torch_host_build.HOST_CASES)
def test_kernel_backward_order_matches_serial_chain(host_kernel, host_serial, name,
                                                    point_light, over):
    """The backward kernel's recompute of the chain and its DE pullbacks,
    with the bulb's forward at each argmin run once (stored for the
    adjoint) and the five AO taps in lock-step, against the serial chain
    it replaced, built as host C++: every cotangent bit-equal."""
    scene, cfg, method, o, d, res, corners = torch_host_build.case(name, point_light, over)
    ct = torch.rand(o.shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    got = torch_host_build.shade_bwd(host_kernel, scene, cfg, o, d, res, corners, ct, method)
    want = torch_host_build.shade_bwd(host_serial, scene, cfg, o, d, res, corners, ct, method)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] is None and want[k] is None) or torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name,over", [
    ("mixed", dict(shadow="hard")), ("mandelbulb", dict(diff_vis=True)),
    ("mixed", dict(shadow="hard", soft_silhouette=0.05, mesh_silhouette=0.05))],
    ids=["mixed", "mandelbulb-diffvis", "mixed-silhouettes"])
def test_packed_arguments_equal_per_call_packing(host_kernel, name, over):
    """What render_pixels_flat packs once (cuda_shade.pack) is what each
    wrapper packs for itself: the SDF block, its counts, the bounds and the
    march's padded bounds, the shade kernels' block; the host build of both
    shade kernels given either gives the same output, and the wrappers
    given packed= return what they return without it."""
    scene, cfg, method, o, d, res, corners = torch_host_build.case(name, False, over)
    packed = cuda_shade.pack(scene, trender._bound_pad(cfg))
    own = cuda_sdf.pack(scene.sdf, trender._bound_pad(cfg))
    assert torch.equal(packed.params, cuda_sdf.pack_sdf(scene.sdf))
    assert torch.equal(packed.params, own.params) and packed.counts == own.counts
    for x, y in ((packed.bounds, own.bounds), (packed.march_bounds, own.march_bounds)):
        assert (x is None and y is None) or torch.equal(x, y)
    pad = trender._bound_pad(cfg)
    if packed.bounds is not None:  # the march's cull, grown by the silhouettes' reach
        assert torch.equal(packed.march_bounds[:, 3], packed.bounds[:, 3] + pad)
    assert torch.equal(packed.small, cuda_shade.pack_small(scene))
    aux = cuda_shade._make_aux(scene, cfg, method, o, d, res)
    a = cuda_shade.kernel_args(scene, cfg, o, d, res, aux, corners, method, packed)
    b = cuda_shade.kernel_args(scene, cfg, o, d, res, aux, corners, method)
    assert torch.equal(a[1], b[1]) and a[2] == b[2] and a[3][2:] == b[3][2:]
    ct = torch.rand(o.shape, generator=torch.Generator().manual_seed(2)) * 2 - 1
    outs = []
    for small in (a[1], b[1]):  # the host build given either block
        statics = list(a[3])
        statics[1] = small.data_ptr()
        outs.append(torch.zeros(o.shape[0], 3))
        host_kernel.host_shade_fwd(*[None if t is None else t.data_ptr() for t in a[2]],
                                   *statics, outs[-1].data_ptr())
    assert torch.equal(*outs)
    # the wrappers (their plain versions on CPU tensors) with and without packed=
    kw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far, bound_pad=pad)
    for x, y in zip(cuda_sdf.march(scene.sdf, o, d, **kw, packed=packed),
                    cuda_sdf.march(scene.sdf, o, d, **kw)):
        assert torch.equal(x, y)
    assert torch.equal(cuda_shade.shade_fwd(scene, cfg, o, d, res, method, corners=corners,
                                            packed=packed),
                       cuda_shade.shade_fwd(scene, cfg, o, d, res, method, corners=corners))
    with_p = cuda_shade.shade_bwd(scene, cfg, o, d, res, aux, corners, ct, method, packed=packed)
    without = cuda_shade.shade_bwd(scene, cfg, o, d, res, aux, corners, ct, method)
    for k in with_p:
        assert (with_p[k] is None and without[k] is None) or torch.equal(with_p[k], without[k])


@pytest.mark.parametrize("name,over,share", [
    ("pointlight", dict(diff_vis=True), (0.0, 0.0)),
    ("mandelbulb", dict(), (0.02, 0.25)),
    ("mandelbulb", dict(diff_vis=True), (0.02, 0.25))])
def test_ill_conditioned_rays_are_the_plain_versions_own(name, over, share):
    """The rays set apart are those where the plain float32 backward itself
    leaves its float64 evaluation by more than 1e-3, per ray: none without
    a fractal; on the Mandelbulb, some but at most a quarter."""
    scene, cfg = tscenes.build_scene(name, device="cpu")
    cfg = cfg.replace(width=16, height=16, spp=1, block_size=0, **over)
    sx, sy = trender.pixel_sample_coords(cfg)
    o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), 16, 16)
    res = trender.geometry_residuals(scene, cfg, o, d, "sdf")
    ct = torch.rand(o.shape, generator=torch.Generator().manual_seed(0)) * 2 - 1
    ill = cuda_shade.ill_conditioned_rays(scene, cfg, o, d, res, None, ct, "sdf")
    assert ill.shape == (256,) and ill.dtype == torch.bool
    assert share[0] <= float(ill.float().mean()) <= share[1]


@pytest.mark.parametrize("name", ["mandelbulb", "pointlight"])
def test_shadow_soft_host_build_matches_plain_version(host_kernel, name):
    """The CUDA soft march's per-ray loop, built as host C++, against
    shadow_soft_torch on the shadow rays of a 24x24 frame. Both run the same
    IEEE ops in the same order, so `pointlight` (spheres, a box, a plane;
    each ray cut at its light's distance) is bit-equal. The Mandelbulb's DE
    ends in a log, which glibc and torch's vectorized CPU log round an ulp
    apart (on the card both sides call CUDA's logf): there vis is within
    1e-6 + 1e-5 |vis| and ts within 1e-5 ts on >= 99% of the rays, the rest
    one march step apart at the fractal's edge."""
    scene, cfg = tscenes.build_scene(name, device="cpu")
    cfg = cfg.replace(width=24, height=24, spp=1, block_size=0)
    sx, sy = trender.pixel_sample_coords(cfg)
    o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), 24, 24)
    res = trender.geometry_residuals(scene, cfg.replace(shadow="none"), o, d, "sdf")
    r = cuda_reconstruct.reconstruct(scene, cfg, o, d, res, "sdf")
    p_off, live = r.p_off, r.live
    if name == "pointlight":
        lvec = scene.lights.position[0] - p_off
        dist = lvec.norm(dim=1)
        l_dir, far = (lvec / dist[:, None]).contiguous(), torch.where(live, dist, 0.0)
    else:
        l_dir = torch.nn.functional.normalize(scene.lights.direction, dim=1)
        l_dir, far = l_dir.expand_as(p_off).contiguous(), torch.where(live, cfg.t_far, 0.0)
    kw = dict(eps=cfg.eps, t_far=cfg.t_far, steps=cfg.shadow_steps, bias=cfg.shadow_bias,
              soft_k=cfg.soft_k)
    want_vis, want_ts = cuda_sdf.shadow_soft_torch(scene.sdf, p_off, l_dir, t_far_rays=far,
                                                   **kw)
    params, counts, _ = cuda_sdf._sdf_args(scene.sdf)
    n = p_off.shape[0]
    vis, ts = torch.empty(n), torch.empty(n)
    host_kernel.host_shadow_soft(p_off.contiguous().data_ptr(), l_dir.data_ptr(),
                                 far.contiguous().data_ptr(), n, params.data_ptr(), *counts,
                                 *kw.values(), vis.data_ptr(), ts.data_ptr())
    assert 0.05 < float((want_vis < 1.0).float().mean()) < 0.95  # penumbra and light
    if name == "pointlight":
        assert torch.equal(vis, want_vis) and torch.equal(ts, want_ts)
    else:
        ok = (((vis - want_vis).abs() <= 1e-6 + 1e-5 * want_vis.abs())
              & ((ts - want_ts).abs() <= 1e-5 * want_ts.abs()))
        assert float(ok.float().mean()) >= 0.99


@pytest.mark.parametrize("name", ["mixed", "sphere"])
def test_shadow_hard_host_build_matches_plain_version(host_kernel, name):
    """The CUDA hard march's per-ray pieces (csrc/sdf_march.cu: the bound
    cull, the start, the steps; shadow_hard_ray), built as host C++, against
    shadow_hard_torch on a frame's shadow rays: bit-equal, the rays that take
    no step (no surface, or culled by the bounds) included."""
    scene, cfg, method, o, d, res, _ = torch_host_build.case(name, False, dict(shadow="hard"))
    rows = tplain.mesh_table(scene.mesh) if scene.has_mesh else None
    r = cuda_reconstruct.reconstruct(scene, cfg, o, d, res, method, mesh_rows=rows)
    p_off, live = r.p_off, r.live
    p_off = p_off.contiguous()
    l_dir = torch.nn.functional.normalize(scene.lights.direction, dim=1)
    l_dir = l_dir[0].expand_as(p_off).contiguous()
    far = torch.where(live, cfg.t_far, 0.0).contiguous()
    kw = dict(eps=cfg.eps, t_far=cfg.t_far, steps=cfg.shadow_steps, bias=cfg.shadow_bias)
    stepped = torch.zeros_like(live)

    def visit(_q, active):
        stepped.logical_or_(active)

    want_vis, want_ts = cuda_sdf.shadow_hard_torch(scene.sdf, p_off, l_dir, t_far_rays=far,
                                                   visit=visit, **kw)
    params, counts, bounds = cuda_sdf._sdf_args(scene.sdf)
    n = p_off.shape[0]
    vis, ts = torch.empty(n), torch.empty(n)
    host_kernel.host_shadow_hard(p_off.data_ptr(), l_dir.data_ptr(), far.data_ptr(), n,
                                 params.data_ptr(), *counts, bounds.data_ptr(),
                                 bounds.shape[0], *kw.values(), vis.data_ptr(), ts.data_ptr())
    # every kind of ray: without a surface, culled by the bounds, marching,
    # lit, blocked
    assert bool((~live).any()) and bool((live & ~stepped).any()) and bool(stepped.any())
    assert bool((live & (want_vis == 1)).any()) and bool((want_vis == 0).any())
    assert torch.equal(vis, want_vis) and torch.equal(ts, want_ts)


@pytest.mark.parametrize("pow8", [False, True])
def test_class_sorted_block_matches_load_order(host_kernel, pow8):
    """The backward kernel's blocks emulated lane by lane on the host: run
    in the order the kernel sorts them to (a stable order by the class of
    their chain; the generic field's build sorts), each ray adding into its
    own column, they give the per-ray cotangents and the block partials of
    the load order bit for bit, and the per-ray cotangents of the one-ray
    host build. The `mixed` frame's rays are shuffled so that every block of
    128 mixes the Mandelbulb, the sphere, the mesh and the sky."""
    scene, cfg, method, o, d, res, corners = torch_host_build.case(
        "mixed", False, dict(shadow="hard", sdf=dict(mb_pow8=pow8)))
    idx = torch.from_numpy(np.random.default_rng(0).permutation(o.shape[0]))
    o, d, corners = o[idx].contiguous(), d[idx].contiguous(), corners[idx].contiguous()
    res = {k: (v[:, idx] if v.dim() == 2 else v[idx]).contiguous()
           for k, v in res.items() if k != "hits"}
    ct = torch.rand(o.shape, generator=torch.Generator().manual_seed(0)) * 2 - 1
    aux = cuda_shade._make_aux(scene, cfg, method, o, d, res)
    sdf_sel = aux["closer"] & res["sdf_hit"]
    bulb = sdf_sel & (aux["mat"] == int(scene.sdf.mb_mat[0]))
    mesh, sky = ~aux["closer"] & res["mesh_hit"], ~(sdf_sel | (~aux["closer"] & res["mesh_hit"]))
    first = slice(0, 128)
    assert all(bool(m[first].any()) for m in (bulb, sdf_sel & ~bulb, mesh, sky))
    sorted_ = torch_host_build.shade_bwd_blocks(host_kernel, scene, cfg, o, d, res, corners,
                                                ct, method, True)
    loaded = torch_host_build.shade_bwd_blocks(host_kernel, scene, cfg, o, d, res, corners,
                                               ct, method, False)
    one = torch_host_build.shade_bwd(host_kernel, scene, cfg, o, d, res, corners, ct, method)
    assert o.shape[0] % 128  # a ragged last block too
    for a, b in zip(sorted_, loaded):
        assert torch.equal(a, b)
    for a, key in zip(sorted_, ("o", "d", "corners")):
        assert torch.equal(a, one[key])


@pytest.mark.parametrize("n", [1, 31, 128, 256, 1013])
def test_lane_tree_sum_matches_float64(host_kernel, n):
    """The kernels' fixed-order sum (a column of the block's cotangents, a
    parameter's partial rows) against a float64 sum: rel 1e-6 of the sum of
    the values' magnitudes, on positive and on mixed-sign values."""
    rng = np.random.default_rng(n)
    for low in (0.0, -1.0):
        v = torch.from_numpy(rng.uniform(low, 1.0, 3 * n).astype(np.float32))
        got = host_kernel.host_lane_tree_sum(v.data_ptr(), n, 3)
        want = float(v[::3].double().sum())
        assert abs(got - want) <= 1e-6 * float(v[::3].double().abs().sum())


@pytest.mark.parametrize("bad", ["float", "short", "strided", "device"])
def test_check_counters_refuses_what_the_kernels_cannot_take(bad):
    """The kernels' optional counters (shadow marches, shade backward,
    packet walks) must be a contiguous int64 tensor of at least as many
    entries as the kernel adds to, on the rays' device; anything else raises
    before a launch."""
    from tpu_ray_torch.kernels.build import check_counters

    names = cuda_shade.SHADE_BWD_COUNTERS
    good = torch.zeros(len(names), dtype=torch.int64)
    check_counters("shade_bwd", None, good.device, names)
    check_counters("shade_bwd", good, good.device, names)
    given = {"float": good.float(), "short": good[:-1],
             "strided": torch.zeros(2 * len(names), dtype=torch.int64)[::2],
             "device": good.to("meta")}[bad]
    with pytest.raises(ValueError, match="counters must be"):
        check_counters("shade_bwd", given, good.device, names)
