"""The port's jittered sampling against the JAX package: the threefry-2x32
draw (tpu_ray_torch.utils.prng) against jax.random.uniform, the sample
positions against the reference's pixel_sample_coords, and the jittered
`sphere` frame against the JAX render and the scalar golden of
ref/cpu_renderer.py.

Tolerances and why:
  * the draw and the sample positions: bit for bit. The draw is integer
    arithmetic and a bit cast; the positions are the same float ops on it.
  * the `sphere` frames: max error < 1e-4 against the JAX render in
    float32, as the port's other sphere frames (no fractal); against the
    float64 golden, the port in float64 within 1e-4 as well (a float64
    jitter is another draw than a float32 one: 52 mantissa bits from both
    words of the hash).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ref import cpu_renderer
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray.kernels import sphere_trace as jtrace
from tpu_ray.sdf.primitives import sdf_distance as jdistance
from tpu_ray.utils.config import RenderConfig as JConfig
from tpu_ray_torch.kernels import cuda_sdf
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.scene.convert import scene_from_numpy
from tpu_ray_torch.utils import prng
from tpu_ray_torch.utils.config import RenderConfig
from torch_jax_bridge import flatten, port_cfg

torch.set_num_threads(1)
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


@pytest.mark.parametrize("seed", [0, 3, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(7, 5, 4, 2), (20, 20, 9, 2), (3,)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES, ids=["f32", "f64"])
def test_uniform_matches_jax_bit_for_bit(seed, shape, jdtype, tdtype):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jdtype)).ravel()
    got = prng.uniform(seed, 0, want.size, tdtype).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # any run of the flat sequence from its indices alone
    np.testing.assert_array_equal(prng.uniform(seed, 1, want.size - 1, tdtype).numpy(),
                                  want[1:])


@pytest.mark.parametrize("w,h,spp", [(7, 5, 4), (20, 20, 9), (13, 11, 1)])
@pytest.mark.parametrize("jdtype,tdtype", DTYPES, ids=["f32", "f64"])
def test_sample_coords_match_jax_bit_for_bit(monkeypatch, w, h, spp, jdtype, tdtype):
    """The jittered positions; a chunk of 50 values forces a partial row
    and a ragged last chunk."""
    monkeypatch.setattr(trender, "JITTER_CHUNK", 50)
    jx, jy = jrender.pixel_sample_coords(
        JConfig(width=w, height=h, spp=spp, jitter_seed=3), jdtype)
    tx, ty = trender.pixel_sample_coords(
        RenderConfig(width=w, height=h, spp=spp, jitter_seed=3), "cpu", tdtype)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_jittered_sampling_deterministic_and_stratified():
    """The reference's own checks (tests/test_io_and_utils.py): the same
    seed gives the same samples, each sample stays in its pixel and its
    stratum, and the jitter moves the samples off the stratum centers."""
    cfg = RenderConfig(width=8, height=8, spp=4, jitter_seed=7)
    sx1, sy1 = trender.pixel_sample_coords(cfg)
    sx2, sy2 = trender.pixel_sample_coords(cfg)
    assert torch.equal(sx1, sx2) and torch.equal(sy1, sy2)
    assert bool((torch.floor(sx1) == torch.arange(8.0)[None, :, None]).all())
    assert bool((torch.floor(sy1) == torch.arange(8.0)[:, None, None]).all())
    cell = torch.arange(4)
    assert bool((torch.floor((sx1 % 1.0) * 2) == (cell % 2)).all())
    assert bool((torch.floor((sy1 % 1.0) * 2) == (cell // 2)).all())
    sx0, _ = trender.pixel_sample_coords(cfg.replace(jitter_seed=None))
    assert float((sx1 - sx0).abs().max()) > 1e-3
    sx8, _ = trender.pixel_sample_coords(cfg.replace(jitter_seed=8))
    assert not torch.equal(sx1, sx8)


@pytest.fixture(scope="module")
def sphere_frames():
    """The JAX `sphere` at 20x20x4 with and without jitter seed 3: its
    float32 XLA render, and the float64 scene with the scalar golden."""
    out = {}
    for seed in (None, 3):
        j32, cfg = jscenes.build_scene("sphere", dtype=jnp.float32)
        cfg = cfg.replace(width=20, height=20, spp=4, jitter_seed=seed)
        with jax.enable_x64(False):
            ref32 = np.asarray(jrender.render_image(j32, cfg.replace(pallas="off")))
        j64, _ = jscenes.build_scene("sphere", dtype=jnp.float64)
        gold = cpu_renderer.render_image(j64, cfg)
        out[seed] = (j32, j64, cfg, ref32, gold)
    return out


@pytest.mark.parametrize("seed", [None, 3], ids=["stratified", "jitter-3"])
def test_sphere_frame_matches_jax_and_golden(sphere_frames, seed):
    """20x20 is no multiple of 8: the frame runs in row-major strips. The
    grazing rays of its silhouette pass within the march's eps outside the
    sphere, where its exact distance falls below eps; the march's bound
    cull (grown by eps, render._bound_pad) keeps them, as the reference,
    which marches every ray, hits them."""
    j32, j64, cfg, ref32, gold = sphere_frames[seed]
    tcfg = port_cfg(cfg)
    with torch.no_grad():
        img32 = trender.render_image(scene_from_numpy(*flatten(j32), device="cpu"), tcfg)
        img64 = trender.render_image(
            scene_from_numpy(*flatten(j64), device="cpu", dtype=torch.float64), tcfg)
    assert np.abs(img32.numpy() - ref32).max() < 1e-4
    assert np.abs(img64.numpy() - gold).max() < 1e-4


def test_march_hits_rays_within_eps_outside_a_sphere():
    """A ray passing eps/2 outside the unit sphere: the sphere's distance
    along it falls below eps, so the reference's march hits it; the port's
    march, its bound cull grown by render._bound_pad, hits it too, and a
    ray 2 eps outside stays a miss in both."""
    j, cfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    eps = cfg.eps
    o = np.asarray([[0.0, 0.0, 3.5], [0.0, 0.0, 3.5]], np.float32)
    d = np.zeros((2, 3), np.float32)
    for i, gap in enumerate((0.5 * eps, 2.0 * eps)):
        # tangent at distance 1 + gap from the centre
        s = (1.0 + gap) / 3.5
        d[i] = [s, 0.0, -np.sqrt(1.0 - s * s)]
    march = jtrace.march(jdistance, j.sdf, jnp.asarray(o), jnp.asarray(d),
                         t0=0.0, max_steps=cfg.max_steps, eps=eps, t_far=cfg.t_far)
    want = np.asarray(march[1])
    assert want.tolist() == [True, False]
    tscene = scene_from_numpy(*flatten(j), device="cpu")
    got = cuda_sdf.march_torch(tscene.sdf, torch.as_tensor(o), torch.as_tensor(d), t0=0.0,
                               max_steps=cfg.max_steps, eps=eps, t_far=cfg.t_far,
                               bound_pad=trender._bound_pad(port_cfg(cfg)))[1]
    assert got.tolist() == [True, False]
