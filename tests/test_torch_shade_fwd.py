"""The port's fused shade forward against the JAX package: the plain forward
(`shade_fwd_torch`) against the Pallas forward kernel `shade_fwd_pallas` in
interpret mode and against the XLA shade `_shade_xla`, with the soft SDF
silhouette, the mesh edge band, soft shadows with the penumbra and the AO;
on the Mandelbulb against the XLA shade run op by op; and a host build of
the CUDA kernel's per-ray forward against the plain version.

Tolerances and why:
  * against the Pallas kernel and the XLA shade on bulb-free scenes:
    atol = rtol = 2e-5, the reference's own bound for its forward kernel
    (tests/test_pallas_shade.py:278): float32 reassociation only.
  * the Mandelbulb (AO taps and the penumbra read the 12-iteration
    fractal): >= 99% of the pixels within 1e-4. The JAX side runs op by op
    (`jax.disable_jit`), since XLA contracts multiply-adds under jit; the
    rest differ by rounding the fractal amplifies near its surface.
  * the host build of the kernels' chain order (the bulb's forward at the
    hit run once, the AO taps in lock-step) against the host build of the
    serial chain (TR_SHADE_SERIAL): bit-equal; each value takes the same
    ops in the same order in both.
  * the host build against the plain version, per ray (the largest channel
    difference): the 99th percentile < 1e-4 and at most 0.1% of the rays
    over 1e-3, the on-card gates of chip_smoke.py. Where the AO taps or the
    penumbra read the Mandelbulb, the rays whose float32 plain forward
    leaves its float64 evaluation by more than 1e-4
    (`cuda_shade.ill_conditioned_colors`, picked without the host build),
    at most 25% of them, are set apart first.
"""

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
from tpu_ray_torch.render import plain as tplain
from tpu_ray_torch.render import render as trender
import torch_host_build
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)


def _small_mixed():
    """The reference test's tiny mixed scene: 10 triangles, the ground and
    one sphere (tests/test_pallas_shade.py:21-29)."""
    scene, cfg = jscenes.build_scene("triangles", dtype=jnp.float32)
    scene = scene.replace(sdf=scene.sdf.replace(
        sph_center=jnp.asarray([[0.4, 0.8, 0.3]], jnp.float32),
        sph_radius=jnp.asarray([0.62], jnp.float32),
        sph_mat=jnp.asarray([1], jnp.int32)))
    return scene, cfg.replace(method="mixed")


def _frame(jscene, jcfg, width):
    """The frame's rays and JAX residuals, and the port's copies."""
    method = jrender.resolve_method(jscene, jcfg)
    sx, sy = jrender.pixel_sample_coords(jcfg, jnp.float32)
    o, d = jcam.generate_rays(jscene.camera, sx.ravel(), sy.ravel(), width, width)
    res = jrender.geometry_residuals(jscene, jcfg, o, d, method)
    tres = {k: torch.as_tensor(np.asarray(v)) for k, v in res.items()}
    return method, (o, d, res), (port_scene(jscene), torch.as_tensor(np.asarray(o)),
                                 torch.as_tensor(np.asarray(d)), tres)


@pytest.mark.parametrize("name,over", [
    pytest.param("sphere", dict(soft_silhouette=0.05), id="sphere-soft"),
    pytest.param("triangles", dict(mesh_silhouette=0.06), id="triangles-mesh"),
    pytest.param("small_mixed", dict(shadow="soft", diff_vis=True, ao="sdf5",
                                     soft_silhouette=0.05, mesh_silhouette=0.06),
                 id="small_mixed-both"),
])
def test_shade_fwd_torch_matches_pallas_kernel_and_xla(name, over):
    if name == "small_mixed":
        jscene, jcfg = _small_mixed()
    else:
        jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=20, height=20, spp=1, block_size=0, max_steps=64,
                            pallas="off").replace(**over)
        method, (o, d, res), (tscene, ot, dt, tres) = _frame(jscene, jcfg, 20)
        kernel = np.asarray(pallas_shade.apply_fwd_kernel(jscene, jcfg, o, d, res, method,
                                                          interpret=True))
        xla = np.asarray(jrender._shade_xla(jscene, jcfg, o, d, res, method))
    got = cuda_shade.shade_fwd_torch(tscene, port_cfg(jcfg), ot, dt, tres, method).numpy()
    # the frame holds hits and misses
    hit = np.asarray(res["mesh_hit"] if "mesh_hit" in res else res["sdf_hit"])
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)


def test_shade_fwd_torch_matches_xla_mandelbulb():
    """The Mandelbulb's AO taps and the diff_vis penumbra, against the XLA
    shade run op by op."""
    jscene, jcfg = jscenes.build_scene("mandelbulb", dtype=jnp.float32)
    with jax.enable_x64(False):
        jcfg = jcfg.replace(width=16, height=16, spp=1, block_size=0, diff_vis=True,
                            pallas="off")
        method, (o, d, res), (tscene, ot, dt, tres) = _frame(jscene, jcfg, 16)
        with jax.disable_jit():
            want = np.asarray(jrender._shade_xla(jscene, jcfg, o, d, res, method))
    got = cuda_shade.shade_fwd_torch(tscene, port_cfg(jcfg), ot, dt, tres, method).numpy()
    assert 0.1 < np.asarray(res["sdf_hit"]).mean() < 0.9
    close = np.abs(got - want).max(-1) <= 1e-4
    assert close.mean() >= 0.99, close.mean()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = torch_host_build.build(tmp_path_factory.mktemp("host_fwd"))
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


@pytest.mark.parametrize("name,point_light,over", torch_host_build.HOST_CASES)
def test_kernel_forward_matches_plain_version(host_kernel, name, point_light, over):
    # `mixed` at 32x18: its plain geometry pass is brute force over 70k triangles
    scene, cfg, method, o, d, res, corners = torch_host_build.case(
        name, point_light, over, mixed_size=(32, 18))
    want = cuda_shade.shade_fwd_torch(scene, cfg, o, d, res, method, corners=corners)
    got = torch_host_build.shade_fwd(host_kernel, scene, cfg, o, d, res, corners, method)
    err = (got - want).abs().amax(1)
    keep = torch.ones_like(err, dtype=torch.bool)
    if scene.sdf.mb_center.shape[0] and (cfg.ao != "none" or cfg.diff_vis):
        ill = cuda_shade.ill_conditioned_colors(scene, cfg, o, d, res, corners, method)
        assert float(ill.float().mean()) <= 0.25
        keep = ~ill
    assert float(torch.quantile(err[keep], 0.99)) < 1e-4, float(err.max())
    assert float((err[keep] > 1e-3).float().mean()) <= 1e-3
    # the sky is written as is: the rays that select no surface agree bit for bit
    sky = want == trender.shading.background_color(scene, d)
    assert torch.equal(got[sky.all(1)], want[sky.all(1)])
    if cfg.soft_silhouette or cfg.mesh_silhouette:  # some rays blend sky and surface
        cov = tplain.reconstruct_plain(scene, cfg, o, d, res, method, corners=corners)[0][5]
        assert bool(((cov > 0.0) & (cov < 1.0)).any())


@pytest.fixture(scope="module")
def host_serial(tmp_path_factory):
    so = torch_host_build.build(tmp_path_factory.mktemp("host_fwd_serial"), serial=True)
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


@pytest.mark.parametrize("name,point_light,over", torch_host_build.HOST_CASES)
def test_kernel_forward_order_matches_serial_chain(host_kernel, host_serial, name,
                                                   point_light, over):
    """The forward kernel's chain, with the bulb's forward at the hit run
    once (the argmin's, stored for the normal) and the five AO taps in
    lock-step, against the serial chain it replaced, built as host C++:
    every colour bit-equal."""
    scene, cfg, method, o, d, res, corners = torch_host_build.case(
        name, point_light, over, mixed_size=(32, 18))
    got = torch_host_build.shade_fwd(host_kernel, scene, cfg, o, d, res, corners, method)
    want = torch_host_build.shade_fwd(host_serial, scene, cfg, o, d, res, corners, method)
    assert torch.equal(got, want)
