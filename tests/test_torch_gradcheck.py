"""The port's gradient checks (tpu_ray_torch/utils/gradcheck.py and `cli
gradcheck`) against the JAX package's.

  * erode_mask / interior_mask: equal to the reference's on random masks;
  * finite_diff_grad and check_grad: on the same smooth loss, written once
    per framework, both return the same autograd gradient (rtol 1e-12:
    float64 sums in another order) and finite differences (atol 1e-9: a
    last-bit difference of the loss over the step 2e-5); a wrong gradient
    raises in both;
  * `cli gradcheck --device cpu` prints the reference's per-parameter
    OK / FAIL and exits as it does, at the default rtol and at 1e-9 (where
    some parameters fail); `--device cuda` without a card stops;
  * the device rule's card check, run here on the CPU: the float32
    gradient of the plain path against the float64 one within 1e-3 of the
    largest component (the CUDA kernels are held to the same bound);
  * BASELINE config 3's vertex check: the directional derivative <grad, V>
    of a masked loss on `bunny` (float64, 20x20, mesh_grid, no shadows)
    along random directions on a few hit body vertices, found by the
    uniform grid's DDA: finite differences against autograd (eps 2e-6,
    rtol 5e-3, atol 1e-9, the reference's). With the reference's V (the
    same vertices) the derivative is exactly 0 in both packages: its
    triangles show only at masked silhouette pixels. Along V on triangles
    seen at interior pixels it is not, and it equals the reference's
    jax.grad within rtol 1e-6 (the reference walks its grid, the port its
    packet accel, to the same triangles).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.utils import gradcheck as jgc
from tpu_ray_torch import cli
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.utils import gradcheck as tgc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOLS = ("2e-3", "1e-9")


@pytest.fixture(scope="module")
def jax_cli():
    """The reference's `cli gradcheck` at each rtol, in subprocesses started
    together (it turns on float64 for its whole process) -> {rtol: (exit
    code, stdout)}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {r: subprocess.Popen([sys.executable, "-m", "tpu_ray.cli", "gradcheck", "--rtol", r],
                                 cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for r in RTOLS}
    out = {}
    for r, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode in (0, 1), stderr
        out[r] = (p.returncode, stdout)
    return out


def _statuses(text: str) -> dict:
    return {ln.split()[1].rstrip(":"): ln.split()[2] for ln in text.splitlines()
            if ln.startswith("[gradcheck] ") and ln.split()[2] in ("OK", "FAIL")}


@pytest.mark.parametrize("rtol", RTOLS)
def test_cli_gradcheck_cpu_matches_jax(jax_cli, capsys, rtol):
    code = 0
    try:
        cli.main(["gradcheck", "--device", "cpu", "--rtol", rtol])
    except SystemExit as e:
        code = e.code
    got = _statuses(capsys.readouterr().out)
    want_code, want_out = jax_cli[rtol]
    want = _statuses(want_out)
    assert got == want and set(got) == {"sdf.sph_radius", "camera.origin", "materials.albedo"}
    assert code == want_code == (1 if "FAIL" in want.values() else 0)
    if rtol == "1e-9":
        assert "FAIL" in got.values()


def test_cli_gradcheck_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["gradcheck", "--device", "cuda"])


@pytest.mark.parametrize("iters", [1, 2])
def test_masks_match_jax(iters):
    rng = np.random.default_rng(iters)
    m = rng.random((20, 24)) < 0.6
    m[5:15, 6:18] = True
    np.testing.assert_array_equal(tgc.erode_mask(torch.as_tensor(m), iters).numpy(),
                                  np.asarray(jgc.erode_mask(jnp.asarray(m), iters)))
    np.testing.assert_array_equal(tgc.interior_mask(torch.as_tensor(m), iters).numpy(),
                                  np.asarray(jgc.interior_mask(jnp.asarray(m), iters)))


def _tloss(x):
    return torch.sum(torch.sin(x) * x ** 2 + torch.exp(0.3 * x))


def _jloss(x):
    return jnp.sum(jnp.sin(x) * x ** 2 + jnp.exp(0.3 * x))


def test_check_grad_matches_jax():
    x0 = np.random.default_rng(0).normal(size=(2, 3))
    g_ad, g_fd = tgc.check_grad(_tloss, torch.as_tensor(x0), eps=1e-5, rtol=1e-6)
    with jax.enable_x64(True):
        j_ad, j_fd = jgc.check_grad(_jloss, jnp.asarray(x0), eps=1e-5, rtol=1e-6)
    np.testing.assert_allclose(g_ad, j_ad, rtol=1e-12)
    np.testing.assert_allclose(g_fd, j_fd, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        tgc.finite_diff_grad(lambda v: float(np.sum(np.cos(v) * v)), x0, 1e-4),
        jgc.finite_diff_grad(lambda v: float(np.sum(np.cos(v) * v)), x0, 1e-4), rtol=0)


class _WrongGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x ** 3

    @staticmethod
    def backward(ctx, g):
        return g * 2.0  # not 3 x^2


@jax.custom_vjp
def _jwrong(x):
    return x ** 3


_jwrong.defvjp(lambda x: (x ** 3, None), lambda _, g: (g * 2.0,))


def test_check_grad_raises_on_a_wrong_gradient_as_jax():
    x0 = np.asarray([0.5, 1.5])
    with pytest.raises(AssertionError, match="gradcheck failed at"):
        tgc.check_grad(lambda x: _WrongGrad.apply(x).sum(), x0)
    with jax.enable_x64(True), pytest.raises(AssertionError, match="gradcheck failed at"):
        jgc.check_grad(lambda x: _jwrong(x).sum(), jnp.asarray(x0))


@pytest.mark.parametrize("path", ["sdf.sph_radius", "camera.origin", "materials.albedo"])
def test_card_check_plain_float32_within_bound(path):
    """The device rule's second check, with the CPU as the 'card': the
    float32 plain path's gradient within 1e-3 of the float64 one."""
    from tpu_ray_torch.render.render import render_image

    scene, cfg = tscenes.build_scene("sphere", device="cpu", dtype=torch.float64)
    c = tgc.gradcheck_config(cfg).replace(eps=cfg.eps)
    with torch.no_grad():
        target = render_image(scene, c) + 0.1
    r = tgc.card_grad_check(scene, c, path, target, "cpu")
    assert r["ok"] and r["rel_err"] < 1e-3 and np.abs(r["g64"]).max() > 0


@pytest.fixture(scope="module")
def bunny64():
    scene, cfg = tscenes.build_scene("bunny", device="cpu", dtype=torch.float64)
    return scene, cfg.replace(width=20, height=20, shadow="none", block_size=0,
                              method="mesh_grid")


def _jax_directional(V):
    """The reference's config 3 loss and its jax.grad along V at 0."""
    from tpu_ray.render.render import pixel_sample_coords, render_image
    from tpu_ray.render.camera import generate_rays
    from tpu_ray.scene.scenes import build_scene
    from tpu_ray.scene.types import background_color

    with jax.enable_x64(True):
        scene, cfg = build_scene("bunny", dtype=jnp.float64)
        cfg = cfg.replace(width=20, height=20, shadow="none", block_size=0, method="mesh_grid")
        base = render_image(scene, cfg)
        sx, sy = pixel_sample_coords(cfg, jnp.float64)
        _, d = generate_rays(scene.camera, sx.ravel(), sy.ravel(), cfg.width, cfg.height)
        bg = background_color(scene, d).reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2)
        hit = jnp.any(jnp.abs(base - bg) > 1e-6, axis=-1)
        mask = jgc.interior_mask(hit, iters=2).astype(base.dtype)[..., None]
        target = base + 0.1
        norm = jnp.sum(mask) * 3.0
        Vj = jnp.asarray(V)

        def loss(alpha):
            s = scene.replace(mesh=scene.mesh.replace(verts=scene.mesh.verts + alpha * Vj))
            return jnp.sum(mask * (render_image(s, cfg) - target) ** 2) / norm

        return float(jax.grad(loss)(jnp.zeros(()))), scene, cfg


def _jax_vertices(jscene, jcfg):
    """The reference test's vertices: those of the first 4 body triangles
    its own grid DDA finds under the frame's primary rays."""
    from tpu_ray.kernels.dda import intersect_grid
    from tpu_ray.render.camera import generate_rays
    from tpu_ray.render.render import pixel_sample_coords

    with jax.enable_x64(True):
        sx, sy = pixel_sample_coords(jcfg, jnp.float64)
        o, d = generate_rays(jscene.camera, sx.ravel(), sy.ravel(), jcfg.width, jcfg.height)
        res = intersect_grid(jscene.mesh, jscene.grid, o, d, t_max=jcfg.t_far)
    tris = np.unique(np.asarray(res.tri)[np.asarray(res.hit)])
    body = tris[tris < jscene.mesh.tris.shape[0] - 2][:4]
    return np.unique(np.asarray(jscene.mesh.tris)[body].ravel())[:6]


@pytest.mark.parametrize("interior_only", [False, True], ids=["reference-V", "interior-V"])
def test_vertex_directional_check_config3(bunny64, interior_only):
    """With the reference's V the triangles show only at masked silhouette
    pixels, and both packages' derivatives are exactly 0; along V on
    triangles seen at interior pixels it is not, and FD, autograd and the
    reference's jax.grad agree."""
    scene, cfg = bunny64
    V = tgc.vertex_direction(scene, cfg, interior_only=interior_only)
    assert 0 < int((V.abs().sum(1) > 0).sum()) <= 6
    g_ad, g_fd = tgc.check_grad(tgc.vertex_loss(scene, cfg, V), torch.zeros(()), eps=2e-6,
                                rtol=5e-3, atol=1e-9)
    want, jscene, jcfg = _jax_directional(V.numpy())
    if interior_only:
        assert abs(float(g_ad)) > 1e-4
        np.testing.assert_allclose(float(g_ad), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(np.nonzero(V.abs().sum(1).numpy())[0],
                                      _jax_vertices(jscene, jcfg))
        assert float(g_ad) == want == 0.0 and abs(float(g_fd)) <= 1e-9
