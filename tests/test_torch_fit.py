"""The port's gradient slice and fit loop against the JAX package: the
gradient of an image loss through the whole `mixed` render, the packet
accel refit, a few Adam steps of `fit`, and `cli fit`.

Tolerances and why:
  * the whole-slice gradient: smooth leaves (sphere radius, albedo, light
    colour, mesh vertices) max|a - b| / max|b| < 1e-4; the Mandelbulb's
    scale and the camera origin cosine > 0.999 and max|a - b| / max|b| <
    5e-2, as the reference's own kernel-vs-XLA test: the fractal's
    second-order chain amplifies f32 reassociation.
  * the refit: exact. Both packages take the same f32 differences, mins
    and maxes.
  * the fit: loss history rel < 1e-4. torch.optim.Adam and optax.adam
    compute the same update; the losses differ by f32 rounding.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray import fit as jfit
from tpu_ray.accel.packet import refit_packet_accel as jrefit
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray.utils.config import FitConfig as JFitConfig
from tpu_ray_torch import fit as tfit
from tpu_ray_torch.accel.packet import refit_packet_accel
from tpu_ray_torch.kernels import cuda_shade
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.scene.convert import params_from_numpy, params_to_numpy
from tpu_ray_torch.utils.config import FitConfig
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINABLES = ("sdf.sph_radius", "sdf.mb_scale", "camera.origin", "materials.albedo",
              "lights.color", "mesh.verts")


@pytest.fixture(scope="module")
def mixed():
    jscene, jcfg = jscenes.build_scene("mixed", dtype=jnp.float32)
    return jscene, jcfg, port_scene(jscene)


def test_mixed_gradient_matches_jax(mixed):
    """The slice: geometry pass, IFT attach, the shade's Function and its
    backward, ray generation and the vertex scatter, for the six
    trainables of the reference's backward bench."""
    jscene, jcfg, tscene = mixed
    small = dict(width=16, height=16, spp=1, block_size=128)
    with jax.enable_x64(False):
        jc = jcfg.replace(pallas="off", **small)
        jparams = jfit.extract_params(jscene, TRAINABLES)
        jg = jax.jit(jax.grad(lambda pp: jnp.mean(
            jrender.render_image(jfit.apply_params(jscene, pp), jc) ** 2)))(jparams)
    tparams = tfit.extract_params(tscene, TRAINABLES)
    img = trender.render_image(tfit.apply_params(tscene, tparams), port_cfg(jc))
    torch.mean(img ** 2).backward()
    got = {k: v.grad.numpy() for k, v in tparams.items()}
    want = {k: np.asarray(v) for k, v in jg.items()}
    for k in ("sdf.sph_radius", "materials.albedo", "lights.color", "mesh.verts"):
        rel = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert rel < 1e-4, (k, rel)
    for k in ("sdf.mb_scale", "camera.origin"):
        a, b = got[k].ravel().astype(np.float64), want[k].ravel().astype(np.float64)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert cos > 0.999 and rel < 5e-2, (k, cos, rel)
    assert all(np.abs(v).max() > 0 for v in got.values())
    assert cuda_shade.LAUNCHES == {"shade_bwd": 0}


def test_refit_packet_accel_matches_jax(mixed):
    jscene, _, tscene = mixed
    rng = np.random.default_rng(3)
    verts = (np.asarray(jscene.mesh.verts)
             + rng.normal(0, 0.02, jscene.mesh.verts.shape)).astype(np.float32)
    want = jrefit(jscene.packet[0], jnp.asarray(verts), jscene.mesh.tris)
    got = refit_packet_accel(tscene.packet, torch.as_tensor(verts), tscene.mesh.tris)
    for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # at the build's own vertices the refit is the build
    same = refit_packet_accel(tscene.packet, tscene.mesh.verts, tscene.mesh.tris)
    for name in ("corners", "chunk_aabb", "super_aabb"):
        assert torch.equal(getattr(same, name), getattr(tscene.packet, name)), name


def test_params_round_trip_through_numpy(mixed):
    _, _, tscene = mixed
    params = tfit.extract_params(tscene, TRAINABLES)
    back = params_from_numpy(params_to_numpy(params), device="cpu")
    for k, v in params.items():
        assert torch.equal(back[k], v.detach()) and not back[k].requires_grad, k


def test_fit_matches_jax_fit():
    """3 Adam steps on the sphere's radius toward a perturbed render."""
    jscene, jcfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=16, height=16, pallas="off")
        r = jscene.sdf.sph_radius
        target = jrender.render_image(
            jscene.replace(sdf=jscene.sdf.replace(sph_radius=r * 1.15 + 0.02)), jcfg)
        _, want = jfit.fit(jscene, jcfg, target, ["sdf.sph_radius"],
                           JFitConfig(steps=3, learning_rate=1e-2), verbose=False)
    tscene = port_scene(jscene)
    fitted, got = tfit.fit(tscene, port_cfg(jcfg), torch.as_tensor(np.asarray(target)),
                           ["sdf.sph_radius"], FitConfig(steps=3, learning_rate=1e-2),
                           verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert float(fitted.sdf.sph_radius) > float(tscene.sdf.sph_radius)  # grows toward 1.17


def test_fit_with_vertices_refits_the_accel():
    """A mesh.verts fit walks an accel refit to the moved vertices."""
    from tpu_ray_torch.scene.scenes import build_scene

    scene, cfg = build_scene("triangles", device="cpu")
    scene = scene.with_packet()
    cfg = cfg.replace(width=12, height=12, method="mesh_grid")
    target = torch.full((12, 12, 3), 0.5)
    fitted, history = tfit.fit(scene, cfg, target, ["mesh.verts"],
                               FitConfig(steps=2, learning_rate=1e-2), verbose=False)
    assert len(history) == 2 and np.isfinite(history).all()
    want = refit_packet_accel(scene.packet, fitted.mesh.verts, scene.mesh.tris)
    assert not torch.equal(fitted.mesh.verts, scene.mesh.verts)
    assert torch.equal(fitted.packet.chunk_aabb, want.chunk_aabb)


def test_cli_fit_runs_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch.cli", "fit", "--scene", "sphere", "--steps", "2",
         "--width", "16", "--height", "16", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[fit] final loss" in r.stdout
