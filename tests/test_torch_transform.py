"""The port's object poses against the JAX package: `rodrigues_apply`,
`apply_poses` and `realize_scene` on seeded inputs, and their gradients,
at the identity pose too, against `jax.grad`.

Tolerances and why: values and gradients within 1e-6 + 1e-5 relative,
float32 rounding of the same formulas (sin, cos and the Taylor guard are
evaluated alike); the packet refit of the posed vertices within the same
bound, as the vertices it boxes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.scene import scenes as jscenes
from tpu_ray.scene import transform as jtf
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.scene import transform as ttf
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _rot_cases(rng):
    """Axis-angle rotations: generic, tiny (inside the Taylor guard), zero,
    and near the guard's edge."""
    generic = rng.normal(0, 1.0, (5, 3))
    tiny = rng.normal(0, 1e-5, (3, 3))
    edge = rng.normal(0, 1.0, (2, 3))
    edge *= 1.2e-4 / np.linalg.norm(edge, axis=1, keepdims=True)
    return np.concatenate([generic, tiny, np.zeros((1, 3)), edge]).astype(np.float32)


def test_rodrigues_apply_matches_jax():
    rng = np.random.default_rng(0)
    rot = _rot_cases(rng)
    v = rng.normal(0, 1.0, rot.shape).astype(np.float32)
    w = rng.normal(0, 1.0, rot.shape).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jtf.rodrigues_apply(jnp.asarray(rot), jnp.asarray(v)))
        jg = jax.grad(lambda r, x: jnp.sum(jnp.asarray(w) * jtf.rodrigues_apply(r, x)),
                      argnums=(0, 1))(jnp.asarray(rot), jnp.asarray(v))
    rt = torch.as_tensor(rot).requires_grad_(True)
    vt = torch.as_tensor(v).requires_grad_(True)
    got = ttf.rodrigues_apply(rt, vt)
    torch.sum(torch.as_tensor(w) * got).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jg[1]), **TOL)
    assert torch.isfinite(rt.grad).all()


@pytest.mark.parametrize("at", ["identity", "posed"])
def test_apply_poses_gradient_matches_jax(at):
    """Two instances and static vertices; the gradient of a weighted sum of
    the posed vertices with respect to every pose leaf."""
    rng = np.random.default_rng(1)
    verts = rng.normal(0, 1.0, (12, 3)).astype(np.float32)
    inst = np.array([0, 0, 0, 1, 1, 1, -1, -1, 0, 1, -1, 0], np.int32)
    w = rng.normal(0, 1.0, verts.shape).astype(np.float32)
    if at == "identity":
        leaves = dict(translate=np.zeros((2, 3)), rotate=np.zeros((2, 3)), scale=np.ones(2))
    else:
        leaves = dict(translate=rng.normal(0, 0.5, (2, 3)), rotate=rng.normal(0, 0.7, (2, 3)),
                      scale=rng.uniform(0.5, 1.5, 2))
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    with jax.enable_x64(False):
        def jloss(lv):
            poses = jtf.MeshPoses(**{k: jnp.asarray(x) for k, x in lv.items()},
                                  vert_instance=jnp.asarray(inst))
            return jnp.sum(jnp.asarray(w) * jtf.apply_poses(poses, jnp.asarray(verts)))

        want_v = np.asarray(jtf.apply_poses(
            jtf.MeshPoses(**{k: jnp.asarray(x) for k, x in leaves.items()},
                          vert_instance=jnp.asarray(inst)), jnp.asarray(verts)))
        jg = jax.grad(jloss)(leaves)
    tl = {k: torch.as_tensor(x).requires_grad_(True) for k, x in leaves.items()}
    got_v = ttf.apply_poses(ttf.MeshPoses(**tl, vert_instance=torch.as_tensor(inst)),
                            torch.as_tensor(verts))
    torch.sum(torch.as_tensor(w) * got_v).backward()
    np.testing.assert_allclose(got_v.detach().numpy(), want_v, **TOL)
    np.testing.assert_array_equal(got_v.detach().numpy()[inst < 0], verts[inst < 0])
    for k in leaves:
        np.testing.assert_allclose(tl[k].grad.numpy(), np.asarray(jg[k]), err_msg=k, **TOL)
        assert float(tl[k].grad.abs().max()) > 0, k


def test_realize_scene_matches_jax():
    """The floating triangles scene with its first triangle posed: the posed
    vertices, poses folded away, and the packet accel refit to them."""
    jscene, jcfg = jscenes.build_scene("triangles", dtype=jnp.float32)
    inst = np.full((jscene.mesh.verts.shape[0],), -1, np.int32)
    inst[:3] = 0
    poses = jtf.MeshPoses.identity(1, inst, dtype=jnp.float32).replace(
        translate=jnp.asarray([[0.1, -0.05, 0.2]], jnp.float32),
        rotate=jnp.asarray([[0.05, 0.3, -0.1]], jnp.float32),
        scale=jnp.asarray([1.2], jnp.float32))
    jscene = jscene.with_packet().replace(poses=poses)
    tscene = port_scene(jscene)
    assert tscene.poses is not None and tscene.packet is not None
    with jax.enable_x64(False):
        jreal = jtf.realize_scene(jscene)
    got = ttf.realize_scene(tscene)
    assert got.poses is None and ttf.realize_scene(got) is got
    np.testing.assert_allclose(got.mesh.verts.numpy(), np.asarray(jreal.mesh.verts), **TOL)
    np.testing.assert_array_equal(got.mesh.verts.numpy()[3:],
                                  np.asarray(jscene.mesh.verts)[3:])
    np.testing.assert_allclose(got.packet[0].chunk_aabb.numpy(),
                               np.asarray(jreal.packet[0].chunk_aabb), **TOL)
    # render_image folds the poses: the posed scene renders as its fold
    cfg = port_cfg(jcfg.replace(width=16, height=16))
    with torch.no_grad():
        assert torch.equal(trender.render_image(tscene, cfg), trender.render_image(got, cfg))
