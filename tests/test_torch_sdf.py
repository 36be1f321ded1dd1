"""The port's distance field, march and hard-shadow march against the JAX
package, on the same float32 inputs made with numpy from fixed seeds.

Tolerances and why:
  * distance fields: rtol 1e-5, atol 1e-6. Both packages run the same IEEE
    ops in the same order, so the JAX side runs op by op (`jax.disable_jit`):
    under jit, XLA's CPU backend contracts x*x + y*y + z*z into multiply-adds
    (a fifth of such sums differ in the last bit), and the chaotic Mandelbulb
    iteration amplifies that far past 1e-5. What remains is the final `log`
    of the DE, from another math library, an ulp apart. The generic-power DE
    also takes atan2/sin/cos/pow from other libraries inside the iteration;
    near the set's boundary those ulps grow, so it meets the tolerance on
    99.9% of the points and stays within 1e-4 on all.
  * marches: `hit` equal on >= 99% of rays, and |dt| <= 1e-4 * t + 1e-5 on
    >= 99% of the rays where both hit, the rest within one step of the march
    (10 * eps). The residue is the XLA-vs-torch rounding deciding a
    `DE < eps` test at the threshold: such a ray stops one step apart.
  * the CUDA march's per-ray loop built as host C++ (csrc/sdf_march.cu
    `march_ray`) against march_torch on a frame's camera rays: hit and
    steps equal on every ray, t and tmin bit-equal on >= 97% of them and
    within 1e-4 relative on all. Both run the same ops in the same order,
    but the DE's final `log` (and the generic field's atan2/sin/cos/pow)
    come from libm there and from torch's vectorized kernels here, an ulp
    apart, and the march adds up those DEs. On the card both sides call
    CUDA's functions, and chip_smoke.py holds the power-8 march bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.kernels import sphere_trace as jst
from tpu_ray.kernels.pallas_sdf import march_pallas, shadow_pallas
from tpu_ray.sdf import mandelbulb as jmb
from tpu_ray.sdf import primitives as jprim
from tpu_ray_torch.kernels import cuda_sdf
from tpu_ray_torch.kernels import sphere_trace as tst
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.sdf import mandelbulb as tmb
from tpu_ray_torch.sdf import primitives as tprim
import torch_host_build

torch.set_num_threads(1)

_INT = {"sph_mat", "pln_mat", "box_mat", "mb_mat"}
# the SDF part of the `mixed` registry scene
MIXED = dict(mb_center=[[1.4, 1.05, 0.0]], mb_scale=[0.9], mb_power=[8.0],
             mb_mat=[2], sph_center=[[0.0, 0.55, -1.6]], sph_radius=[0.55],
             sph_mat=[3])
# every primitive family (the `pointlight` scene's sphere, box and plane)
PRIMS = dict(sph_center=[[-0.7, 0.6, 0.0]], sph_radius=[0.6], sph_mat=[0],
             box_center=[[0.9, 0.45, -0.2]], box_half=[[0.45, 0.45, 0.45]],
             box_round=[0.08], box_mat=[2], pln_normal=[[0.0, 1.0, 0.0]],
             pln_offset=[0.0], pln_mat=[1])
LIGHT = np.array([0.6, 0.8, 0.3]) / np.linalg.norm([0.6, 0.8, 0.3])


def _sdf_pair(spec, pow8=False):
    """The same SDF scene in both packages."""
    jkw = {k: jnp.asarray(np.asarray(v, np.int32 if k in _INT else np.float32))
           for k, v in spec.items()}
    tkw = {k: torch.as_tensor(np.asarray(v, np.int32 if k in _INT else np.float32))
           for k, v in spec.items()}
    return (jprim.SdfScene.empty(jnp.float32).replace(**jkw, mb_pow8=pow8),
            tprim.SdfScene.empty().replace(**tkw, mb_pow8=pow8))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform([-1.2, -0.3, -2.4], [2.8, 2.3, 1.4], (n, 3)).astype(np.float32)


def _camera_rays(n, seed):
    """Rays from the `mixed` camera aimed at the bulb and the sphere."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([0.1, 1.9, 4.6]), (n, 1))
    half = n // 2
    tgt = np.concatenate([
        rng.uniform([0.4, 0.1, -1.0], [2.4, 2.0, 1.0], (half, 3)),  # bulb
        rng.uniform([-0.7, 0.0, -2.2], [0.7, 1.2, -1.0], (n - half, 3))])  # sphere
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _close(got, want):
    """Per-point |got - want| <= 1e-6 + 1e-5 * |want|."""
    return np.abs(got - want) <= 1e-6 + 1e-5 * np.abs(want)


@pytest.mark.parametrize("spec,pow8", [(MIXED, True), (PRIMS, False)],
                         ids=["mixed-pow8", "primitives"])
def test_sdf_distance_and_mat_match_jax(spec, pow8):
    js, ts = _sdf_pair(spec, pow8)
    p = _points(4096, 1)
    with jax.disable_jit():
        d_j, m_j = jprim.sdf_distance_and_mat(js, jnp.asarray(p))
        dist_j = jprim.sdf_distance(js, jnp.asarray(p))
    d_t, m_t = tprim.sdf_distance_and_mat(ts, torch.as_tensor(p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(tprim.sdf_distance(ts, torch.as_tensor(p)).numpy(),
                               np.asarray(dist_j), rtol=1e-5, atol=1e-6)


def test_sdf_distance_generic_bulb_matches_jax():
    js, ts = _sdf_pair(MIXED, False)
    p = _points(4096, 1)
    with jax.disable_jit():
        want = np.asarray(jprim.sdf_distance(js, jnp.asarray(p)))
    got = tprim.sdf_distance(ts, torch.as_tensor(p)).numpy()
    assert _close(got, want).mean() >= 0.999
    assert np.abs(got - want).max() < 1e-4


def test_mandelbulb_des_match_jax():
    p = np.random.default_rng(2).uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    with jax.disable_jit():
        pow8 = np.asarray(jmb.mandelbulb_de_pow8(jnp.asarray(p)))
        generic = np.asarray(jmb.mandelbulb_de(jnp.asarray(p), jnp.float32(8.0)))
    np.testing.assert_allclose(tmb.mandelbulb_de_pow8(torch.as_tensor(p)).numpy(),
                               pow8, rtol=1e-5, atol=1e-6)
    got = tmb.mandelbulb_de(torch.as_tensor(p), 8.0).numpy()
    assert _close(got, generic).mean() >= 0.999
    assert np.abs(got - generic).max() < 1e-4


@pytest.mark.parametrize("spec", [MIXED, PRIMS], ids=["mixed", "primitives"])
def test_bounding_spheres_match_jax(spec):
    js, ts = _sdf_pair(spec, True)
    want = jprim.sdf_bounding_spheres(js)
    got = tprim.sdf_bounding_spheres(ts)
    if want is None:
        assert got is None  # planes are unbounded
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _march_kw():
    return dict(t0=0.0, max_steps=96, eps=1e-3, t_far=40.0)


def test_march_torch_matches_march_pallas():
    js, ts = _sdf_pair(MIXED, True)
    o, d = _camera_rays(512, 3)
    tj, hj, _, _ = march_pallas(js, jnp.asarray(o), jnp.asarray(d), **_march_kw(),
                                interpret=True)
    tt, ht, _, _ = cuda_sdf.march_torch(ts, torch.as_tensor(o), torch.as_tensor(d),
                                        **_march_kw())
    hj, tj, ht, tt = np.asarray(hj), np.asarray(tj), ht.numpy(), tt.numpy()
    assert 0.2 < hj.mean() < 0.95  # both hits and misses are exercised
    assert (ht == hj).mean() >= 0.99
    both = ht & hj
    err = np.abs(tt[both] - tj[both])
    assert (err <= 1e-4 * tj[both] + 1e-5).mean() >= 0.99
    assert err.max() <= 10 * _march_kw()["eps"]


def test_march_torch_matches_lockstep_march():
    """The kernel's plain version against the port's and the reference's
    lockstep march: hit agrees; t and tmin differ by design on rays the
    bounding-sphere cull starts at t_far."""
    js, ts = _sdf_pair(MIXED, True)
    o, d = _camera_rays(512, 4)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    tc, hc, _, _ = cuda_sdf.march_torch(ts, ot, dt, **_march_kw())
    tl, hl, _, _ = tst.march(tprim.sdf_distance, ts, ot, dt, **_march_kw())
    tj, hj, _, _ = jst.march(jprim.sdf_distance, js, jnp.asarray(o), jnp.asarray(d),
                             **_march_kw())
    np.testing.assert_array_equal(hc.numpy(), hl.numpy())
    np.testing.assert_allclose(tc.numpy()[hc.numpy()], tl.numpy()[hc.numpy()],
                               rtol=1e-6)
    assert (hl.numpy() == np.asarray(hj)).mean() >= 0.99
    both = hl.numpy() & np.asarray(hj)
    err = np.abs(tl.numpy()[both] - np.asarray(tj)[both])
    assert (err <= 1e-4 * np.asarray(tj)[both] + 1e-5).mean() >= 0.99
    assert err.max() <= 10 * _march_kw()["eps"]


@pytest.mark.parametrize("per_ray_far", [False, True], ids=["t_far", "t_far_rays"])
def test_shadow_hard_torch_matches_shadow_pallas(per_ray_far):
    js, ts = _sdf_pair(MIXED, True)
    rng = np.random.default_rng(5)
    # ground points around and behind the bulb and the sphere, toward the light
    p = rng.uniform([-1.5, 0.003, -3.0], [2.5, 0.003, 0.5], (512, 3)).astype(np.float32)
    l_dir = np.tile(LIGHT.astype(np.float32), (512, 1))
    far = (rng.uniform(0.0, 6.0, 512).astype(np.float32) * (rng.random(512) > 0.2)
           if per_ray_far else None)
    kw = dict(eps=1e-3, t_far=40.0, steps=48, bias=3e-3)
    vj, tsj = shadow_pallas(js, jnp.asarray(p), jnp.asarray(l_dir), soft=False,
                            t_far_rays=None if far is None else jnp.asarray(far),
                            interpret=True, **kw)
    vt, tst_ = cuda_sdf.shadow_hard_torch(
        ts, torch.as_tensor(p), torch.as_tensor(l_dir),
        t_far_rays=None if far is None else torch.as_tensor(far), **kw)
    vj, vt = np.asarray(vj), vt.numpy()
    assert 0.05 < (vj == 0).mean() < 0.95  # blocked and lit rays both occur
    assert (vt == vj).mean() >= 0.99
    np.testing.assert_array_equal(tst_.numpy(), np.asarray(tsj))


def test_cpu_wrappers_use_plain_versions():
    """On CPU tensors the kernel wrappers run the plain versions and launch
    nothing."""
    _, ts = _sdf_pair(MIXED, True)
    o, d = (torch.as_tensor(a) for a in _camera_rays(64, 6))
    before = dict(cuda_sdf.LAUNCHES)
    a = cuda_sdf.march(ts, o, d, **_march_kw())
    b = cuda_sdf.march_torch(ts, o, d, **_march_kw())
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert cuda_sdf.LAUNCHES == before == {"march": 0, "shadow_hard": 0, "shadow_soft": 0}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = torch_host_build.build(tmp_path_factory.mktemp("host_march"))
    if so is None:
        pytest.skip("no g++ to build the kernel arithmetic as host code")
    return so


@pytest.mark.parametrize("name,power,bound_pad", [
    ("mixed", None, 0.0), ("mixed", None, 24 * 0.05), ("mandelbulb", 7.5, 0.0),
    ("mixed", 7.5, 0.0)], ids=["mixed", "mixed-padded-cull", "generic-bulb", "mixed-generic"])
def test_march_host_build_matches_plain_version(host_kernel, name, power, bound_pad):
    """The CUDA primary march's per-ray loop (the bound cull, the steps,
    the closest approach), built as host C++, against march_torch on a
    48x27 frame of the scene's camera; power: the generic-power field at
    that power (None: the scene's power-8 field). The padded cull is the
    soft silhouettes' (render.SIL_REACH widths of 0.05)."""
    scene, cfg = tscenes.build_scene(name, device="cpu")
    sdf = scene.sdf
    if power is not None:
        sdf = sdf.replace(mb_pow8=False, mb_power=torch.tensor([power]))
    small = cfg.replace(width=48, height=27, spp=1)
    sx, sy = trender.pixel_sample_coords(small)
    o, d = generate_rays(scene.camera, sx.reshape(-1), sy.reshape(-1), 48, 27)
    kw = dict(t0=0.0, max_steps=cfg.max_steps, eps=cfg.eps, t_far=cfg.t_far,
              bound_pad=bound_pad)
    tw, hw, sw, mw = cuda_sdf.march_torch(sdf, o, d, **kw)
    t, hit, steps, tmin = torch_host_build.march(host_kernel, sdf, o, d, **kw)
    assert torch.equal(hit, hw) and torch.equal(steps, sw)
    for got, want in ((t, tw), (tmin, mw)):
        assert float((got == want).float().mean()) >= 0.97
        assert bool(((got - want).abs() <= 1e-4 * want.abs()).all())
    # hits, misses that march, and rays the bound cull starts at t_far
    assert bool(hw.any()) and bool((~hw & (sw > 0)).any())
    if name == "mixed":
        assert bool((sw == 0).any())
