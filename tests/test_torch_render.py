"""The port's render path against the JAX package: ray generation, sampling
order, the scene bridge, and whole frames of the `mixed` and `sphere`
registry scenes rendered from the same parameters in both packages.

Tolerances and why:
  * rays and sample coordinates: the same float32 ops; `tan` and `sqrt`
    come from other math libraries, so rays agree to rtol 1e-6.
  * the `mixed` frame: 95th-percentile per-pixel error < 5e-3, max < 1.0
    and mean < 1e-3, the reference's own bound for its kernel path against
    its XLA path (tests/test_pallas.py) plus a mean. The Mandelbulb march is
    chaotic: an ulp of difference can move a silhouette pixel.
  * the `sphere`, `triangles` and `bunny` frames: max error < 1e-4 (no
    fractal).
  * the primary march over a group of blocks (render.march_group) against
    one block a group: rays, image and gradients bit-equal (the same
    elementwise ops on the same samples).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.render import camera as jcam
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray.utils.config import RenderConfig as JConfig
from tpu_ray_torch.fit import apply_params, extract_params
from tpu_ray_torch.kernels import build, cuda_mt, cuda_sdf
from tpu_ray_torch.render import camera as tcam
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.utils.config import RenderConfig
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



@pytest.fixture(scope="module")
def mixed():
    """The JAX `mixed` scene, its 24x24 reference frame, and the port's copy."""
    jscene, jcfg = jscenes.build_scene("mixed", dtype=jnp.float32)
    small = dict(width=24, height=24, spp=1, block_size=0, max_steps=64)
    ref = np.asarray(jrender.render_image(jscene, jcfg.replace(pallas="off", **small)))
    tscene = port_scene(jscene)
    tcfg = port_cfg(jcfg)
    return jscene, tscene, tcfg.replace(**small), ref


def test_generate_rays_match_jax(mixed):
    jscene, tscene, _, _ = mixed
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1920, 4096).astype(np.float32)
    ys = rng.uniform(0, 1080, 4096).astype(np.float32)
    oj, dj = jcam.generate_rays(jscene.camera, jnp.asarray(xs), jnp.asarray(ys), 1920, 1080)
    ot, dt = tcam.generate_rays(tscene.camera, torch.as_tensor(xs), torch.as_tensor(ys),
                                1920, 1080)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("w,h,spp", [(24, 16, 4), (1920, 1080, 16), (20, 12, 1)])
def test_sample_coords_and_block_order_match_jax(w, h, spp):
    cfg = RenderConfig(width=w, height=h, spp=spp)
    jx, jy = jrender.pixel_sample_coords(JConfig(width=w, height=h, spp=spp),
                                         jnp.float32)
    tx, ty = trender.pixel_sample_coords(cfg)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    want = jrender._block_order_perm(JConfig(width=w, height=h, spp=spp))
    got = trender._block_order_perm(cfg)
    if want is None:
        assert got is None  # sides not divisible by 8: row-major strips
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    inv = trender._inverse_perm(got)
    np.testing.assert_array_equal(got[inv].numpy(), np.arange(w * h))


def _assert_same_scene(a, b):
    """Every parameter of two port scenes equal, dtypes and statics too."""
    for group in ("camera", "sdf", "mesh", "materials", "lights"):
        ga, gb = getattr(a, group), getattr(b, group)
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), f"{group}.{f.name}"
            else:
                assert x == y, f"{group}.{f.name}"
    assert torch.equal(a.bg_top, b.bg_top) and torch.equal(a.bg_bottom, b.bg_bottom)


def test_scene_from_numpy_round_trips_mixed(mixed):
    jscene, tscene, _, _ = mixed
    own, _ = tscenes.build_scene("mixed", device="cpu")
    _assert_same_scene(tscene, own)
    # the packet accel built from the converted scene is the reference's
    jpacket = jscene.packet[0]
    for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
        np.testing.assert_array_equal(getattr(tscene.packet[0], name).numpy(),
                                      np.asarray(getattr(jpacket, name)), err_msg=name)


@pytest.mark.parametrize("name", tscenes.scene_names())
def test_registry_entry_matches_jax(name):
    """Each of the port's registry entries holds the reference's scene
    parameters and render config, value for value."""
    jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    own, cfg = tscenes.build_scene(name, device="cpu")
    _assert_same_scene(own, port_scene(jscene))
    assert cfg == port_cfg(jcfg)


def _frame_errors(got, want):
    err = np.abs(got - want).max(-1)
    return np.quantile(err, 0.95), err.max(), np.abs(got - want).mean()


@pytest.mark.parametrize("block_size", [0, 100], ids=["one-block", "padded-blocks"])
def test_mixed_frame_matches_jax(mixed, block_size):
    """The slice: march, seeded closest hit, hard shadows and mesh any-hit,
    reconstruct and shade; 100-sample blocks force a padded last block."""
    _, tscene, tcfg, ref = mixed
    with torch.no_grad():
        img = trender.render_image(tscene, tcfg.replace(block_size=block_size)).numpy()
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    p95, mx, mean = _frame_errors(img, ref)
    assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)


def test_mixed_frame_with_silhouettes_matches_jax(mixed):
    """Soft SDF and mesh silhouettes: misses are not parked, coverage blends
    the surface over the sky."""
    jscene, tscene, tcfg, _ = mixed
    sil = dict(width=16, height=16, soft_silhouette=0.02, mesh_silhouette=0.01)
    ref = np.asarray(jrender.render_image(
        jscene, JConfig(**{f.name: getattr(tcfg, f.name)
                           for f in dataclasses.fields(RenderConfig)}).replace(
            pallas="off", **sil)))
    with torch.no_grad():
        img = trender.render_image(tscene, tcfg.replace(**sil)).numpy()
    p95, mx, mean = _frame_errors(img, ref)
    assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)


def test_soft_silhouette_cull_matches_jax_on_grazing_rays(mixed):
    """With soft silhouettes the port's march culls only the rays that pass
    outside every bounding sphere grown by eps and SIL_REACH widths
    (render._bound_pad); the reference
    marches every ray. Rays from the camera that graze the grown spheres of
    the `mixed` scene (its sphere and Mandelbulb; 1e-4 to 5e-2 outside):
    on those the port culls, the reference's closest approach stays more
    than the pad from the scene (the bulb's DE undershoots its distance),
    its soft coverage is below float32's resolution of the blend (measured
    4.5e-12), and the two shades agree (measured: exactly)."""
    from tpu_ray.sdf.primitives import sdf_distance as jdistance
    from tpu_ray_torch.kernels import cuda_shade
    from tpu_ray_torch.sdf.primitives import sdf_bounding_spheres

    jscene, tscene, tcfg, _ = mixed
    sil = dict(soft_silhouette=0.05, mesh_silhouette=0.05)
    jcfg = JConfig(**{f.name: getattr(tcfg, f.name)
                      for f in dataclasses.fields(RenderConfig)}).replace(pallas="off", **sil)
    pad = trender._bound_pad(tcfg.replace(**sil))
    bounds = sdf_bounding_spheres(tscene.sdf).double().numpy()
    origin = tscene.camera.origin.double().numpy()
    dirs = []
    for c, r in zip(bounds[:, :3], bounds[:, 3]):
        w = (c - origin) / np.linalg.norm(c - origin)
        a = np.cross(w, [0.0, 1.0, 0.0])
        a /= np.linalg.norm(a)
        b = np.cross(w, a)
        for delta in (1e-4, 1e-3, 1e-2, 5e-2):
            alpha = np.arcsin((r + pad) * (1.0 + delta) / np.linalg.norm(c - origin))
            for phi in np.linspace(0.0, 2.0 * np.pi, 32, endpoint=False):
                dirs.append(np.cos(alpha) * w
                            + np.sin(alpha) * (np.cos(phi) * a + np.sin(phi) * b))
    d = np.asarray(dirs, np.float32)
    o = np.broadcast_to(origin.astype(np.float32), d.shape).copy()
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    bt, disc = cuda_sdf._bound_terms(sdf_bounding_spheres(tscene.sdf), ot, dt, pad)
    culled = ~((disc >= 0.0) & (torch.sqrt(disc.clamp_min(0.0)) - bt > 0.0)).any(1).numpy()
    assert culled.sum() >= 100

    res = jrender.geometry_residuals(jscene, jcfg, jnp.asarray(o), jnp.asarray(d), "mixed")
    want = np.asarray(jrender._shade_xla(jscene, jcfg, jnp.asarray(o), jnp.asarray(d), res,
                                         "mixed"))
    q = jnp.asarray(o) + res["sdf_tmin"][:, None] * jnp.asarray(d)
    de = np.asarray(jdistance(jscene.sdf, q)).astype(np.float64)
    miss = culled & ~np.asarray(res["sdf_hit"])
    assert miss.sum() == culled.sum()
    assert de[miss].min() > pad
    assert (1.0 / (1.0 + np.exp(de[miss] / sil["soft_silhouette"]))).max() < 6e-8
    with torch.no_grad():
        tres = trender.geometry_residuals(tscene, tcfg.replace(**sil), ot, dt, "mixed")
        got = cuda_shade.shade_fwd_torch(tscene, tcfg.replace(**sil), ot, dt, tres,
                                         "mixed").numpy()
    np.testing.assert_allclose(got[culled], want[culled], atol=1e-6, rtol=0)


def test_group_rays_equal_block_rays(mixed):
    """The grouped march's rays (generate_rays over a group of blocks'
    samples, without autograd) are each block's own rays (made inside
    autograd, with a camera that takes a gradient) bit for bit."""
    _, tscene, tcfg, _ = mixed
    cfg = tcfg.replace(width=64, height=48, spp=4)
    sx, sy = trender.pixel_sample_coords(cfg)
    perm = trender._block_order_perm(cfg)
    fx = sx.reshape(-1, cfg.spp)[perm].reshape(-1)
    fy = sy.reshape(-1, cfg.spp)[perm].reshape(-1)
    cam = dataclasses.replace(tscene.camera,
                              origin=tscene.camera.origin.clone().requires_grad_(True))
    with torch.no_grad():
        og, dg = tcam.generate_rays(cam, fx, fy, cfg.width, cfg.height)
    for s in range(0, fx.shape[0], 1000):
        o, d = tcam.generate_rays(cam, fx[s:s + 1000], fy[s:s + 1000], cfg.width, cfg.height)
        assert o.requires_grad and d.requires_grad
        assert torch.equal(o.detach(), og[s:s + 1000]) and torch.equal(d.detach(), dg[s:s + 1000])


@pytest.mark.parametrize("grad", [False, True], ids=["frame", "fit-step"])
def test_grouped_march_equals_one_block_a_group(mixed, monkeypatch, grad):
    """render_pixels_flat marches its blocks' primary rays once per group
    of MARCH_GROUP blocks. At 64 samples a block the 24x24 frame (16x16 for
    the step) is 9 blocks (4): groups of 4 (4, 4 and a ragged 1) or of 3
    (3 and a ragged 1) against groups of 1 give the same image, and the
    same gradients, bit for bit, with one march call a group over its
    blocks' rays; the grouped frame still matches the JAX frame."""
    _, tscene, tcfg, ref = mixed
    cfg = tcfg.replace(block_size=64, **({"width": 16, "height": 16} if grad else {}))
    sizes = []
    real = cuda_sdf.march

    def spy(sdf, o, d, **kw):
        sizes.append(o.shape[0])
        return real(sdf, o, d, **kw)

    monkeypatch.setattr(cuda_sdf, "march", spy)
    out = {}
    for group in (1, 3 if grad else 4):
        monkeypatch.setattr(trender, "MARCH_GROUP", group)
        sizes.clear()
        if grad:
            params = extract_params(tscene, ("sdf.mb_scale", "camera.origin", "mesh.verts"))
            loss = torch.mean(trender.render_image(apply_params(tscene, params), cfg) ** 2)
            loss.backward()
            out[group] = [loss.detach()] + [v.grad for v in params.values()]
        else:
            with torch.no_grad():
                out[group] = [trender.render_image(tscene, cfg)]
        out[group].append(list(sizes))
    if grad:
        assert out[1][-1] == [64] * 4 and out[3][-1] == [192, 64]
    else:
        assert out[1][-1] == [64] * 9 and out[4][-1] == [256, 256, 64]
    one, grouped = out[1][:-1], out[3 if grad else 4][:-1]
    assert all(torch.equal(a, b) for a, b in zip(one, grouped))
    if not grad:
        p95, mx, mean = _frame_errors(grouped[0].numpy(), ref)
        assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)


def test_sphere_frame_matches_jax():
    jscene, jcfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    jcfg = jcfg.replace(width=32, height=32, pallas="off")
    ref = np.asarray(jrender.render_image(jscene, jcfg))
    tscene, tcfg = tscenes.build_scene("sphere", device="cpu")
    img = trender.render_image(tscene, tcfg.replace(width=32, height=32)).numpy()
    assert np.abs(img - ref).max() < 1e-4


@pytest.mark.parametrize("name", ["triangles", "bunny"])
def test_mesh_scene_frame_matches_jax(name):
    """Mesh-only registry scenes: brute MT (`triangles`) and the packet accel
    in place of the reference's uniform grid (`bunny`); no fractal, so the
    bound is the sphere's."""
    jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    ref = np.asarray(jrender.render_image(jscene, jcfg.replace(width=16, height=16,
                                                               pallas="off")))
    tscene, tcfg = tscenes.build_scene(name, device="cpu")
    with torch.no_grad():
        img = trender.render_image(tscene, tcfg.replace(width=16, height=16)).numpy()
    assert np.abs(img - ref).max() < 1e-4


def test_cpu_render_launches_no_kernel(mixed):
    _, tscene, tcfg, _ = mixed
    with torch.no_grad():
        trender.render_image(tscene, tcfg.replace(width=8, height=8))
    assert cuda_sdf.LAUNCHES == {"march": 0, "shadow_hard": 0, "shadow_soft": 0}
    assert cuda_mt.LAUNCHES == {"closest": 0, "any_hit": 0, "resident_closest": 0,
                                "resident_any_hit": 0}


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_ray_torch\n"
        "for m in pkgutil.walk_packages(tpu_ray_torch.__path__, 'tpu_ray_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'tpu_ray'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('tpu_ray_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_kernel_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)  # nothing built there
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.kernel_lib()
    assert build._LIB is None


def test_cli_renders_png(tmp_path):
    out = tmp_path / "s.png"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch.cli", "render", "--scene", "sphere",
         "--width", "16", "--height", "16", "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data[:16 + 8]
