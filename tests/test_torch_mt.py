"""The port's packet accel and packet intersection against the JAX package,
on the same float32 rays and numpy meshes.

Tolerances and why:
  * accel build: bit-identical. The port copies the reference's numpy build
    (same Morton order, float64 math, one rounding to float32).
  * closest hit against brute MT: hit equal, t with rtol 1e-5 (the same MT
    on the same float32 corners, its dot products summed in another order),
    tri equal wherever the two nearest candidate t's of a ray differ by more
    than 1e-6 * t (closer than that, the rounding may pick either triangle).
  * against the TPU kernel in interpret mode: hits and ids equal, t with rtol
    1e-5 (the same MT on the same accel rows, but XLA's CPU backend contracts
    the kernel's dot products into multiply-adds under jit).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.accel import packet as jpacket
from tpu_ray.kernels import moller_trumbore as jmt
from tpu_ray.kernels.pallas_mt import intersect_packet_streamed
from tpu_ray.scene.mesh import MeshScene as JMesh
from tpu_ray_torch.accel import packet as tpacket
from tpu_ray_torch.kernels import cuda_mt
from tpu_ray_torch.kernels import moller_trumbore as tmt
from tpu_ray_torch.scene.mesh import torus_knot

torch.set_num_threads(1)


def _rays(n, seed, spread=3.0):
    """Rays from a box around the knot, aimed at points of its bounding box."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3))
    d = rng.uniform([-0.9, -0.9, -0.4], [0.9, 0.9, 0.4], (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _knot(seg_u, seg_v):
    """A torus knot with float32-exact vertices, as a scene's mesh holds them
    (so the accel's edges equal the float32 differences brute MT takes)."""
    v, f = torus_knot(2, 3, seg_u, seg_v)
    return v.astype(np.float32).astype(np.float64), f


@pytest.mark.parametrize("seg", [(24, 24), (48, 48)], ids=["1super", "3supers"])
def test_build_packet_accel_bit_identical(seg):
    v, f = _knot(*seg)
    want = jpacket.build_packet_accel(v, f)
    got = tpacket.build_packet_accel(v, f)
    assert got.num_tris == want.num_tris == f.shape[0]
    for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_intersect_packet_torch_matches_brute():
    v, f = _knot(24, 24)
    accel = tpacket.build_packet_accel(v, f)
    mesh = JMesh.from_numpy(v, f, dtype=jnp.float32)
    o, d = _rays(600, 7)
    want = jmt.intersect_brute(mesh, jnp.asarray(o), jnp.asarray(d))
    got = cuda_mt.intersect_packet_streamed_torch(accel, torch.as_tensor(o), torch.as_tensor(d))
    hit = np.asarray(want.hit)
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)
    assert (got.t.numpy()[~hit] == tmt.BIG).all()
    assert (got.tri.numpy()[~hit] == -1).all()
    # the two nearest candidate t's per ray, from the full brute t matrix
    v0, v1, v2 = mesh.triangle_corners()
    t_all, _ = jmt._mt_t(jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], v0, v1, v2,
                         jmt.BIG)
    two = np.sort(np.asarray(t_all), axis=1)[:, :2]
    clear = hit & (two[:, 1] - two[:, 0] > 1e-6 * two[:, 0])
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(got.tri.numpy()[clear], np.asarray(want.tri)[clear])


def test_intersect_packet_torch_seeded_matches_streamed_kernel():
    """t_init seeding, with 0-seeds, against the TPU kernel in interpret mode
    on a one-super mesh (the interpret-mode compile takes about a minute)."""
    v, f = _knot(8, 16)  # 256 triangles: 2 chunks, 1 super
    jacc = jpacket.build_packet_accel(v, f)
    tacc = tpacket.build_packet_accel(v, f)
    o, d = _rays(300, 11)
    seed = np.where(np.arange(300) % 3 == 0, 0.0, 3.0).astype(np.float32)
    want = intersect_packet_streamed(jacc, jnp.asarray(o), jnp.asarray(d),
                                     t_init=jnp.asarray(seed), interpret=True)
    got = cuda_mt.intersect_packet_streamed_torch(tacc, torch.as_tensor(o), torch.as_tensor(d),
                                         t_init=torch.as_tensor(seed))
    hit = np.asarray(want.hit)
    assert 0.1 < hit.mean() and not hit[seed == 0].any()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)


def test_intersect_packet_torch_seeded_any_hit_matches_brute():
    """Any-hit with 0-seeds and a seeded closest hit against brute MT, as the
    reference's streamed-kernel test checks them: 0-seeded rays never hit,
    the others agree with brute; a seed keeps only strictly closer hits."""
    v, f = _knot(24, 24)
    accel = tpacket.build_packet_accel(v, f)
    mesh = JMesh.from_numpy(v, f, dtype=jnp.float32)
    o, d = _rays(600, 19)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    seed = torch.where(torch.arange(600) % 3 == 0, 0.0, 4.0)
    got = cuda_mt.intersect_packet_streamed_torch(accel, ot, dt, t_max=4.0, any_hit=True,
                                         t_init=seed)
    want = np.asarray(jmt.any_hit_brute(mesh, jnp.asarray(o), jnp.asarray(d), t_max=4.0))
    dead = seed.numpy() == 0.0
    assert 0.1 < want.mean()
    assert not got.hit.numpy()[dead].any()
    np.testing.assert_array_equal(got.hit.numpy()[~dead], want[~dead])
    np.testing.assert_array_equal(got.tri.numpy(), np.where(got.hit.numpy(), 0, -1))
    assert (got.t.numpy() == tmt.BIG).all()

    brute = jmt.intersect_brute(mesh, jnp.asarray(o), jnp.asarray(d))
    w_t = np.asarray(brute.t)
    keep = np.asarray(brute.hit) & (w_t < 2.5)
    got2 = cuda_mt.intersect_packet_streamed_torch(accel, ot, dt, t_init=torch.full((600,), 2.5))
    np.testing.assert_array_equal(got2.hit.numpy(), keep)
    np.testing.assert_allclose(got2.t.numpy()[keep], w_t[keep], rtol=1e-5)


def test_intersect_packet_torch_matches_any_hit_brute():
    v, f = _knot(24, 24)
    accel = tpacket.build_packet_accel(v, f)
    mesh = JMesh.from_numpy(v, f, dtype=jnp.float32)
    o, d = _rays(600, 13)
    want = np.asarray(jmt.any_hit_brute(mesh, jnp.asarray(o), jnp.asarray(d), t_max=4.0))
    got = cuda_mt.intersect_packet_streamed(accel, torch.as_tensor(o), torch.as_tensor(d),
                                   t_max=4.0, any_hit=True)
    np.testing.assert_array_equal(got.hit.numpy(), want)
    assert set(cuda_mt.LAUNCHES.values()) == {0}  # CPU: plain path


def test_recompute_hit_corners_matches_jax():
    rng = np.random.default_rng(17)
    v0, v1, v2, o = (rng.uniform(-1, 1, (512, 3)).astype(np.float32) for _ in range(4))
    d = rng.normal(size=(512, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = jmt.recompute_hit_corners(*(jnp.asarray(a) for a in (v0, v1, v2, o, d)))
    got = tmt.recompute_hit_corners(*(torch.as_tensor(a) for a in (v0, v1, v2, o, d)))
    # the same ops in the same order: t, u, v agree to the bit; the unit
    # normal's sqrt and division may round an ulp apart
    for name, g, w in zip("tuv", got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6, atol=1e-7)
