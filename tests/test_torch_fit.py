"""The port's gradient slice and fit loop against the JAX package: the
gradient of an image loss through the whole `mixed` render, the packet
accel refit, a few Adam steps of `fit`, an object-pose fit through the
mesh edge band, and `cli fit`.

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
  * the pose gradient: max|a - b| / max|b| < 1e-4, the smooth bound: the
    edge band's margin and the pose fold are f32 arithmetic of the same
    formulas.
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
from tpu_ray.scene import transform as jtf
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
    assert cuda_shade.LAUNCHES == {"shade_fwd": 0, "shade_bwd": 0}


def test_refit_packet_accel_matches_jax(mixed):
    jscene, _, tscene = mixed
    rng = np.random.default_rng(3)
    verts = (np.asarray(jscene.mesh.verts)
             + rng.normal(0, 0.02, jscene.mesh.verts.shape)).astype(np.float32)
    want = jrefit(jscene.packet[0], jnp.asarray(verts), jscene.mesh.tris)
    got = refit_packet_accel(tscene.packet[0], torch.as_tensor(verts), tscene.mesh.tris)
    for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # at the build's own vertices the refit is the build
    same = refit_packet_accel(tscene.packet[0], tscene.mesh.verts, tscene.mesh.tris)
    for name in ("corners", "chunk_aabb", "super_aabb"):
        assert torch.equal(getattr(same, name), getattr(tscene.packet[0], name)), name


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


def test_soft_silhouette_fit_matches_jax_fit():
    """examples/inverse_rendering.py at 32x32 for 3 steps: the sphere's
    radius, centre and albedo fitted with the soft silhouette, through the
    port's own geometry pass. The silhouette reads the march's closest
    approach on every miss near the sphere, which the march's bounding
    cull must not drop (render.SIL_REACH)."""
    jscene, jcfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    paths = ["sdf.sph_radius", "sdf.sph_center", "materials.albedo"]
    start = {"sdf.sph_radius": [0.55], "sdf.sph_center": [[0.25, 0.15, 0.0]],
             "materials.albedo": [[0.2, 0.5, 0.8]]}
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=32, height=32, soft_silhouette=0.05, pallas="off")
        target = jrender.render_image(jscene, jcfg.replace(soft_silhouette=0.0))
        init = jfit.apply_params(jscene, {k: jnp.asarray(v, jnp.float32)
                                          for k, v in start.items()})
        _, want = jfit.fit(init, jcfg, target, paths,
                           JFitConfig(steps=3, learning_rate=1e-2), verbose=False)
    _, got = tfit.fit(port_scene(init), port_cfg(jcfg), torch.as_tensor(np.asarray(target)),
                      paths, FitConfig(steps=3, learning_rate=1e-2), verbose=False)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


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
    want = refit_packet_accel(scene.packet[0], fitted.mesh.verts, scene.mesh.tris)
    assert not torch.equal(fitted.mesh.verts, scene.mesh.verts)
    assert len(fitted.packet) == 1
    assert torch.equal(fitted.packet[0].chunk_aabb, want.chunk_aabb)


def test_pose_fit_with_mesh_silhouette_matches_jax():
    """A translation of the floating triangle in its own plane moves only
    its silhouette (examples/inverse_pose.py `main_silhouette`): with the
    mesh edge band the pose gets a gradient, which matches jax.grad of the
    reference's loss, and two Adam steps of `fit` lower the loss as the
    reference's do."""
    jscene, jcfg = jscenes.build_scene("triangles", dtype=jnp.float32)
    inst = np.full((jscene.mesh.verts.shape[0],), -1, np.int32)
    inst[:3] = 0
    jscene = jscene.replace(poses=jtf.MeshPoses.identity(1, inst, dtype=jnp.float32))
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=24, height=24, shadow="none", block_size=0,
                            mesh_silhouette=0.05, pallas="off")
        target = jrender.render_image(jscene, jcfg)
        start = jscene.replace(poses=jscene.poses.replace(
            translate=jnp.asarray([[0.1, 0.0, 0.0]], jnp.float32)))

        def jloss(t):
            s = start.replace(poses=start.poses.replace(translate=t))
            return jnp.mean((jrender.render_image(s, jcfg) - target) ** 2)

        want = np.asarray(jax.jit(jax.grad(jloss))(start.poses.translate))
        _, want_hist = jfit.fit(start, jcfg, target, ["poses.translate"],
                                JFitConfig(steps=2, learning_rate=8e-3), verbose=False)
    tscene, cfg = port_scene(start), port_cfg(jcfg)
    ttarget = torch.as_tensor(np.asarray(target))
    params = tfit.extract_params(tscene, ["poses.translate"])
    torch.mean((trender.render_image(tfit.apply_params(tscene, params), cfg)
                - ttarget) ** 2).backward()
    got = params["poses.translate"].grad.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4, (got, want)
    fitted, hist = tfit.fit(tscene, cfg, ttarget, ["poses.translate"],
                            FitConfig(steps=2, learning_rate=8e-3), verbose=False)
    np.testing.assert_allclose(hist, want_hist, rtol=1e-4)
    assert hist[1] < hist[0]
    assert fitted.poses is not None  # the fitted scene keeps its poses
    assert float(fitted.poses.translate[0, 0]) < 0.1  # moves back toward 0
    assert cuda_shade.LAUNCHES == {"shade_fwd": 0, "shade_bwd": 0}


def test_cli_fit_runs_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch.cli", "fit", "--scene", "sphere", "--steps", "2",
         "--width", "16", "--height", "16", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[fit] final loss" in r.stdout
