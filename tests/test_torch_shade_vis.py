"""The port's shade backward through the AO taps and the differentiable
soft-shadow penumbra (`diff_vis`) against the JAX package: `shade_bwd_torch`
against the Pallas kernel `shade_bwd_pallas` in interpret mode and against
`jax.grad` of the XLA shade.

Tolerances and why (the groups of tests/test_torch_shade_bwd.py, with the
plane's leaves among the smooth ones):
  * smooth groups (albedo, light colour and direction, ambient, sky
    colours, plane, sphere, box, point light): max|a - b| / max|b| < 1e-4,
    f32 summation order.
  * the Mandelbulb leaves (the generic field's power too, in
    tests/test_torch_mandelbulb.py) and the camera's o and d: cosine > 0.999 and
    max|a - b| / max|b| < 5e-2, as the reference's own kernel-vs-XLA test
    (tests/test_pallas_shade.py): the fractal's second-order chain
    amplifies f32 reassociation.
  * against `jax.grad` on `mandelbulb` the JAX side runs op by op
    (`jax.disable_jit`): under jit XLA contracts multiply-adds, and the AO
    taps and the penumbra read the fractal's DE where one ulp moves it.
    The Pallas kernel in interpret mode is compiled whatever the setting; it
    runs a 3-iteration bulb at 8x8 rays, where the chain is not yet chaotic
    (the reference's own interpret-mode test cuts the bulb to 6 iterations
    for the same cost reason).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.kernels import pallas_shade
from tpu_ray.render import camera as jcam
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray_torch.kernels import cuda_shade
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)

SMOOTH = ("materials.albedo", "lights.color", "lights.direction", "lights.ambient",
          "bg_top", "bg_bottom", "sdf.pln_normal", "sdf.pln_offset", "sdf.sph_center",
          "sdf.sph_radius", "sdf.box_center", "sdf.box_half", "sdf.box_round",
          "lights.position", "lights.pos_color")
CHAOTIC = ("sdf.mb_center", "sdf.mb_scale", "sdf.mb_power", "o", "d")
_INT = {"sph_mat", "pln_mat", "box_mat", "mb_mat"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12) if b.size else 0.0


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_groups(got, want):
    for k in want:
        if np.asarray(want[k]).size == 0:
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if k in CHAOTIC:
            assert _cos(a, b) > 0.999 and _rel(a, b) < 5e-2, (k, _cos(a, b), _rel(a, b))
        else:
            assert k in SMOOTH and _rel(a, b) < 1e-4, (k, _rel(a, b))


def _block(jscene, jcfg, width):
    """Rays of a width x width frame, the JAX geometry residuals (soft
    shadows with diff_vis: sh_vis and sh_ts) and a seeded cotangent, in both
    packages."""
    sx, sy = jrender.pixel_sample_coords(jcfg, jnp.float32)
    o, d = jcam.generate_rays(jscene.camera, sx.ravel(), sy.ravel(), width, width)
    res = jrender.geometry_residuals(jscene, jcfg, o, d, "sdf")
    assert "sh_ts" in res
    ct = np.random.default_rng(0).uniform(-1, 1, (width * width, 3)).astype(np.float32)
    torch_side = (port_scene(jscene), torch.as_tensor(np.asarray(o)),
                  torch.as_tensor(np.asarray(d)),
                  {k: torch.as_tensor(np.asarray(v)) for k, v in res.items()},
                  torch.as_tensor(ct))
    return (o, d, res, jnp.asarray(ct)), torch_side


def _plain(jcfg, torch_side):
    tscene, o, d, res, ct = torch_side
    return cuda_shade.shade_bwd_torch(tscene, port_cfg(jcfg), o, d, res, None, ct, "sdf")


def test_shade_bwd_torch_matches_pallas_kernel_mandelbulb():
    """The `mandelbulb` chain: IFT attach, the normal's Hessian term, the
    five AO taps and the penumbra recompute at sh_ts."""
    jscene, jcfg = jscenes.build_scene("mandelbulb", dtype=jnp.float32)
    jscene = jscene.replace(sdf=jscene.sdf.replace(mb_iters=3))
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=8, height=8, spp=1, block_size=0, pallas="off",
                            diff_vis=True)
        (o, d, res, ct), torch_side = _block(jscene, jcfg, 8)
        aux = pallas_shade._make_aux(jcfg, "sdf", jscene, o, d, res)
        d_ops, d_prm, d_o, d_d, _ = pallas_shade.shade_bwd_pallas(
            jscene, jcfg, o, d, res, aux, ct, "sdf", interpret=True)
    got = _plain(jcfg, torch_side)
    names = {"albedo": "materials.albedo", "ldir": "lights.direction",
             "lcol": "lights.color", "ambient": "lights.ambient",
             "bg_top": "bg_top", "bg_bottom": "bg_bottom"}
    want = {"o": d_o, "d": d_d, **{names[k]: v for k, v in d_prm.items()}}
    it = iter(d_ops)  # the kernel's SDF operands: the non-empty leaves in order
    for f in dataclasses.fields(jscene.sdf):
        v = getattr(jscene.sdf, f.name)
        if hasattr(v, "size") and v.size > 0:
            c = next(it)
            if f.name not in _INT and f.name != "mb_power":
                want[f"sdf.{f.name}"] = c
    hit = np.asarray(res["sdf_hit"])
    assert 0.1 < hit.mean() < 0.95
    assert {"sdf.pln_normal", "sdf.mb_scale", "lights.direction"} <= set(want)
    _assert_groups(got, want)


PATHS = ("materials.albedo", "lights.color", "lights.direction", "lights.ambient",
         "bg_top", "bg_bottom", "lights.position", "lights.pos_color",
         "sdf.sph_center", "sdf.sph_radius", "sdf.pln_normal", "sdf.pln_offset",
         "sdf.box_center", "sdf.box_half", "sdf.box_round", "sdf.mb_center",
         "sdf.mb_scale")


def _get(scene, path):
    for part in path.split("."):
        scene = getattr(scene, part)
    return scene


def _put(scene, path, value):
    head, *rest = path.split(".")
    if not rest:
        return scene.replace(**{head: value})
    return scene.replace(**{head: _put(getattr(scene, head), ".".join(rest), value)})


@pytest.mark.parametrize("name", ["mandelbulb", "pointlight"])
def test_shade_bwd_torch_matches_jax_grad(name):
    """`mandelbulb` with AO and the directional light's penumbra (its leaves
    get gradients only through the bulb and the plane); `pointlight` with
    the point light's penumbra along normalize(lpos - p_off)."""
    jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=16, height=16, spp=1, block_size=0, pallas="off",
                            diff_vis=True)
        (o, d, res, ct), torch_side = _block(jscene, jcfg, 16)
        paths = [p for p in PATHS if _get(jscene, p).size]

        def loss(params, oo, dd):
            s = jscene
            for p, v in params.items():
                s = _put(s, p, v)
            return jnp.sum(ct * jrender._shade_xla(s, jcfg, oo, dd, res, "sdf"))

        grad = jax.grad(loss, argnums=(0, 1, 2))
        args = ({p: _get(jscene, p) for p in paths}, o, d)
        if name == "mandelbulb":
            with jax.disable_jit():
                jg = grad(*args)
        else:
            jg = jax.jit(grad)(*args)
    got = _plain(jcfg, torch_side)
    want = {p: np.asarray(v) for p, v in jg[0].items()}
    want.update(o=np.asarray(jg[1]), d=np.asarray(jg[2]))
    pen = "lights.direction" if name == "mandelbulb" else "lights.position"
    assert np.abs(want[pen]).max() > 0
    _assert_groups(got, want)
