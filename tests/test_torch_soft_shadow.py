"""The port's soft-shadow march, distance-field AO and the frames that use
them against the JAX package, plus the CLI's device rule and a CPU fit of
the `mandelbulb` scene.

Tolerances and why:
  * the soft march: vis within 1e-6 + 1e-5 |vis| and ts within 1e-5 ts.
    Against the reference's `sdf_soft_shadow_argmin` run op by op
    (`jax.disable_jit`) on >= 99% of the rays; against `shadow_pallas`
    (soft=True) in interpret mode, which XLA compiles and whose multiply-adds
    it contracts (interpret mode ignores `disable_jit`), on >= 97% of the
    rays with mean |dvis| < 1e-3 (measured 98.6% and 99.0%). The other rays
    drift by a march step where the ray grazes the fractal: the last-bit
    differences in the DE move t, and with it the step that attains the
    penumbra minimum. ts is not bit-equal: t sums 48 such steps.
  * the AO: rtol 1e-5, atol 1e-6 against the reference run op by op
    (`jax.disable_jit`), as the distance fields of tests/test_torch_sdf.py.
  * frames: the bounds of tests/test_torch_render.py for the `mixed` frame
    (95th-percentile per-pixel error < 5e-3, max < 1.0, mean < 1e-3): the
    Mandelbulb's march, soft shadows and AO taps are chaotic at its edge.
"""

import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.kernels.pallas_sdf import shadow_pallas
from tpu_ray.render import render as jrender
from tpu_ray.render import shading as jshading
from tpu_ray.scene import scenes as jscenes
from tpu_ray.sdf import primitives as jprim
from tpu_ray.utils.config import RenderConfig as JConfig
from tpu_ray_torch.kernels import cuda_sdf
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.render import shading as tshading
from tpu_ray_torch.sdf import primitives as tprim
from tpu_ray_torch.utils.config import RenderConfig
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGHT = np.array([0.5, 0.75, 0.45]) / np.linalg.norm([0.5, 0.75, 0.45])


@pytest.fixture(scope="module")
def bulb():
    """The `mandelbulb` registry scene's SDF (power-8 bulb on a plane) in
    both packages."""
    jscene, _ = jscenes.build_scene("mandelbulb", dtype=jnp.float32)
    return jscene.sdf, port_scene(jscene).sdf


def _shadow_rays(n, seed):
    """Points on the plane around and under the bulb, toward the scene's
    light: their rays cross the bulb's shadow and penumbra."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-1.5, 0.003, -1.5], [1.5, 0.003, 1.5], (n, 3)).astype(np.float32)
    return p, np.tile(LIGHT.astype(np.float32), (n, 1))


@pytest.mark.parametrize("per_ray_far", [False, True], ids=["t_far", "t_far_rays"])
def test_shadow_soft_torch_matches_jax(bulb, per_ray_far):
    js, ts = bulb
    p, l_dir = _shadow_rays(512, 5)
    rng = np.random.default_rng(6)
    far = (rng.uniform(0.0, 3.0, 512).astype(np.float32) * (rng.random(512) > 0.2)
           if per_ray_far else None)
    cfg = RenderConfig(eps=6e-4, t_far=20.0)
    kw = dict(eps=cfg.eps, t_far=cfg.t_far, steps=cfg.shadow_steps, bias=cfg.shadow_bias)
    vis_p, ts_p = shadow_pallas(js, jnp.asarray(p), jnp.asarray(l_dir), soft=True,
                                soft_k=cfg.soft_k, interpret=True,
                                t_far_rays=None if far is None else jnp.asarray(far), **kw)
    with jax.disable_jit():
        vis_l, ts_l = jshading.sdf_soft_shadow_argmin(
            jprim.sdf_distance, js, jnp.asarray(p), jnp.asarray(l_dir),
            JConfig(eps=cfg.eps, t_far=cfg.t_far),
            t_far=None if far is None else jnp.asarray(far))
    vis_t, ts_t = cuda_sdf.shadow_soft_torch(
        ts, torch.as_tensor(p), torch.as_tensor(l_dir), soft_k=cfg.soft_k,
        t_far_rays=None if far is None else torch.as_tensor(far), **kw)
    vis_t, ts_t = vis_t.numpy(), ts_t.numpy()
    assert 0.1 < (vis_t < 1.0).mean() < 0.9  # penumbra, shadow and light occur
    for vis_j, ts_j, share in ((vis_p, ts_p, 0.97), (vis_l, ts_l, 0.99)):
        vis_j, ts_j = np.asarray(vis_j), np.asarray(ts_j)
        ok = ((np.abs(vis_t - vis_j) <= 1e-6 + 1e-5 * np.abs(vis_j))
              & (np.abs(ts_t - ts_j) <= 1e-5 * np.abs(ts_j)))
        assert ok.mean() >= share and np.abs(vis_t - vis_j).mean() < 1e-3, ok.mean()
    # the geometry pass's entry points, the reference's shape, are the same march
    cfg_t = port_cfg(JConfig(eps=cfg.eps, t_far=cfg.t_far))
    far_t = None if far is None else torch.as_tensor(far)
    vis_s, ts_s = tshading.sdf_soft_shadow_argmin(
        ts, torch.as_tensor(p), torch.as_tensor(l_dir), cfg_t, far_t)
    np.testing.assert_array_equal(vis_s.numpy(), vis_t)
    np.testing.assert_array_equal(ts_s.numpy(), ts_t)
    np.testing.assert_array_equal(tshading.sdf_soft_shadow(
        ts, torch.as_tensor(p), torch.as_tensor(l_dir), cfg_t, far_t).numpy(), vis_t)


def test_shadow_soft_wrapper_on_cpu_runs_the_plain_version(bulb):
    _, ts = bulb
    p, l_dir = (torch.as_tensor(a) for a in _shadow_rays(64, 7))
    kw = dict(eps=6e-4, t_far=20.0, steps=48, bias=3e-3, soft_k=8.0)
    before = dict(cuda_sdf.LAUNCHES)
    a = cuda_sdf.shadow_soft(ts, p, l_dir, **kw)
    b = cuda_sdf.shadow_soft_torch(ts, p, l_dir, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert cuda_sdf.LAUNCHES == before == {"march": 0, "shadow_hard": 0, "shadow_soft": 0}


@pytest.mark.parametrize("with_mesh", [False, True], ids=["sdf", "sdf+t_mesh"])
def test_ambient_occlusion_matches_jax(bulb, with_mesh):
    js, ts = bulb
    rng = np.random.default_rng(8)
    p = rng.uniform([-1.2, 0.0, -1.2], [1.2, 2.3, 1.2], (1024, 3)).astype(np.float32)
    n = rng.normal(size=(1024, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    t_mesh = (np.where(rng.random(1024) < 0.5, rng.uniform(0.0, 0.25, 1024), 1e10)
              .astype(np.float32) if with_mesh else None)
    cfg = JConfig(ao="sdf5")
    with jax.disable_jit():
        want = np.asarray(jshading.sdf_ambient_occlusion(
            jprim.sdf_distance, js, jnp.asarray(p), jnp.asarray(n), cfg,
            t_mesh=None if t_mesh is None else jnp.asarray(t_mesh)))
    got = tshading.sdf_ambient_occlusion(
        tprim.sdf_distance, ts, torch.as_tensor(p), torch.as_tensor(n), port_cfg(cfg),
        t_mesh=None if t_mesh is None else torch.as_tensor(t_mesh)).numpy()
    assert 0.05 < ((want > 0.0) & (want < 1.0)).mean()  # the clip is not everywhere
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


FRAMES = {
    "mandelbulb": ("mandelbulb", {}),
    "mandelbulb-diffvis": ("mandelbulb", {"diff_vis": True}),
    "pointlight": ("pointlight", {}),
    "mixed-ao": ("mixed", {"ao": "sdf5", "max_steps": 64}),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_frame_matches_jax(case):
    """16x16 frames, one block: soft shadows and AO (`mandelbulb`, with the
    penumbra recomputed at the argmin t under diff_vis), the point light's
    per-ray cutoff (`pointlight`), AO with the mesh term (`mixed`)."""
    name, over = FRAMES[case]
    jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    small = dict(width=16, height=16, spp=1, block_size=0, **over)
    ref = np.asarray(jrender.render_image(jscene, jcfg.replace(pallas="off", **small)))
    with torch.no_grad():
        img = trender.render_image(port_scene(jscene), port_cfg(jcfg).replace(**small))
    img = img.numpy()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    err = np.abs(img - ref).max(-1)
    p95, mx, mean = np.quantile(err, 0.95), err.max(), np.abs(img - ref).mean()
    assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "tpu_ray_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=env)


def test_cli_without_cuda_or_device_cpu_stops():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, whatever the machine
    r = _cli("render", "--scene", "sphere", "--width", "8", "--height", "8",
             "--out", os.devnull, env=env)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr


def test_cli_fit_mandelbulb_on_cpu():
    r = _cli("fit", "--scene", "mandelbulb", "--steps", "3", "--width", "16", "--height",
             "16", "--spp", "1", "--ao", "sdf5", "--device", "cpu", "--trainable",
             "sdf.mb_scale", "materials.albedo", "lights.color")
    assert r.returncode == 0, r.stderr
    losses = [float(v) for v in re.findall(r"\[fit\] step \d+ loss (\S+)", r.stdout)]
    assert len(losses) == 2 and losses[-1] < losses[0], r.stdout
