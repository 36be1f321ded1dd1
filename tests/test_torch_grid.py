"""The port's uniform grid and 3D-DDA (tpu_ray_torch/accel/grid_build.py,
kernels/dda.py, core/aabb.py) against the JAX package's, and the DDA as
the oracle of the port's packet walks and brute MT.

Tolerances and why:
  * the grid's CSR (cell_starts, tri_idx, res, max_per_cell) and its
    float32 origin and cell size: equal (the same numpy build).
  * the DDA against the reference's, both float64: hits and triangle ids
    equal, t rtol 1e-10 (XLA may contract the MT arithmetic differently).
  * the DDA against brute MT (float64): the same closest hit, so hits and
    ids equal and t rtol 1e-12.
  * the DDA against the packet walk's plain version: the walk tests
    float32 corners and rays, so hits equal on all but 1% of the rays
    (grazing edges), |dt| <= 1e-5 * max(t, 1) (float32 rounds the
    coordinates, ~2 here, not t: a ray starting near a triangle keeps the
    absolute error), and a different triangle only where the two t tie to
    1e-6 that way.
  * the slab test: equal to the reference's (the same float64 ops).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.accel import grid_build as jgrid
from tpu_ray.core import aabb as jaabb
from tpu_ray.kernels import dda as jdda
from tpu_ray.scene import scenes as jscenes
from tpu_ray.scene.mesh import MeshScene as JMesh
from tpu_ray_torch.accel.grid_build import build_grid, grid_stats
from tpu_ray_torch.accel.packet import build_packet_parts
from tpu_ray_torch.core.aabb import ray_aabb, safe_inv_dir
from tpu_ray_torch.kernels import cuda_mt
from tpu_ray_torch.kernels import moller_trumbore as mt
from tpu_ray_torch.kernels.dda import any_hit_grid, intersect_grid
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.scene.mesh import MeshScene, torus_knot

torch.set_num_threads(1)


def _soup(n_tris=200, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n_tris, 3))
    e0 = rng.normal(size=(n_tris, 3)) * 0.35
    e1 = rng.normal(size=(n_tris, 3)) * 0.35
    verts = np.stack([c - e0, c + e1, c + e0 - e1], axis=1).reshape(-1, 3)
    return verts, np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)


MESHES = {"soup": _soup, "knot": lambda: torus_knot(2, 3, 48, 24)}


def _rays(kind, verts, n=600, seed=0):
    """Rays from outside the mesh's box toward random points, axis-parallel
    rays (either sign, along each axis), or rays starting inside the box."""
    rng = np.random.default_rng(seed)
    lo, hi = verts.min(0), verts.max(0)
    if kind == "outside":
        o = rng.uniform(lo - 2.0, hi + 2.0, (n, 3))
        o[:, 2] = hi[2] + 2.0
        d = rng.uniform(lo, hi, (n, 3)) - o
    elif kind == "axis":
        axis = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        o = rng.uniform(lo, hi, (n, 3))
        o[np.arange(n), axis] = np.where(sign > 0, lo[axis] - 1.0, hi[axis] + 1.0)
        d = np.zeros((n, 3))
        d[np.arange(n), axis] = sign
    else:  # inside
        o = rng.uniform(lo, hi, (n, 3))
        d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh(request):
    verts, faces = MESHES[request.param]()
    return dict(name=request.param, verts=verts, faces=faces,
                jgrid=jgrid.build_grid(verts, faces), grid=build_grid(verts, faces),
                jmesh=JMesh.from_numpy(verts, faces, dtype=jnp.float64),
                tmesh=MeshScene.from_numpy(verts, faces, dtype=torch.float64))


def _assert_same_grid(got, want):
    for name in ("cell_starts", "tri_idx", "origin", "cell_size"):
        g, w = getattr(got, name).cpu().numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.res == want.res and got.max_per_cell == want.max_per_cell
    assert got.num_cells == want.num_cells


def test_build_grid_matches_jax(mesh):
    _assert_same_grid(mesh["grid"], mesh["jgrid"])
    assert grid_stats(mesh["grid"]) == jgrid.grid_stats(mesh["jgrid"])


@pytest.mark.parametrize("density,max_res", [(1.0, 128), (20.0, 8)])
def test_build_grid_density_and_cap_match_jax(density, max_res):
    v, f = torus_knot(2, 3, 30, 20)
    _assert_same_grid(build_grid(v, f, density=density, max_res=max_res),
                      jgrid.build_grid(v, f, density=density, max_res=max_res))


def test_empty_grid_matches_jax():
    g = build_grid(np.zeros((0, 3)), np.zeros((0, 3), np.int32))
    _assert_same_grid(g, jgrid.build_grid(np.zeros((0, 3)), np.zeros((0, 3), np.int32)))
    hit = intersect_grid(MeshScene.empty(), g, torch.zeros(4, 3), torch.ones(4, 3))
    assert not hit.hit.any() and (hit.tri == -1).all()
    v, f = torus_knot(2, 3, 10, 8)  # no rays at all
    hit = intersect_grid(MeshScene.from_numpy(v, f), build_grid(v, f), torch.zeros(0, 3),
                         torch.zeros(0, 3))
    assert hit.t.shape == hit.tri.shape == hit.hit.shape == (0,)


@pytest.mark.parametrize("kind", ["outside", "axis", "inside"])
def test_slab_test_matches_jax(kind):
    o, d = _rays(kind, np.asarray([[-1.0, -2.0, -0.5], [1.5, 1.0, 2.0]]), n=300)
    box_lo, box_hi = np.asarray([-1.0, -1.0, -1.0]), np.asarray([1.0, 1.5, 0.5])
    want = jaabb.ray_aabb(jnp.asarray(o), jaabb.safe_inv_dir(jnp.asarray(d)),
                          jnp.asarray(box_lo), jnp.asarray(box_hi))
    inv = safe_inv_dir(torch.as_tensor(d))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jaabb.safe_inv_dir(jnp.asarray(d))))
    got = ray_aabb(torch.as_tensor(o), inv, torch.as_tensor(box_lo), torch.as_tensor(box_hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["outside", "axis", "inside"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_intersect_grid_matches_jax(mesh, kind, any_hit):
    o, d = _rays(kind, mesh["verts"])
    t_max = 4.5 if any_hit else 1e10
    want = jdda.intersect_grid(mesh["jmesh"], mesh["jgrid"], jnp.asarray(o), jnp.asarray(d),
                               t_max=t_max, any_hit=any_hit)
    got = intersect_grid(mesh["tmesh"], mesh["grid"], torch.as_tensor(o), torch.as_tensor(d),
                         t_max=t_max, any_hit=any_hit)
    hit = np.asarray(want.hit)
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-10)
    if any_hit:
        np.testing.assert_array_equal(
            any_hit_grid(mesh["tmesh"], mesh["grid"], torch.as_tensor(o), torch.as_tensor(d),
                         t_max=t_max).numpy(), hit)


@pytest.mark.parametrize("kind", ["outside", "axis", "inside"])
def test_intersect_grid_is_brute_and_packet_oracle(mesh, kind):
    """The DDA's closest hit is brute MT's (float64), and the packet walk's
    plain version agrees with it (float32 corners)."""
    o, d = (torch.as_tensor(a) for a in _rays(kind, mesh["verts"], seed=1))
    got = intersect_grid(mesh["tmesh"], mesh["grid"], o, d)
    brute = mt.intersect_brute(mesh["tmesh"], o, d)
    np.testing.assert_array_equal(got.hit.numpy(), brute.hit.numpy())
    np.testing.assert_array_equal(got.tri.numpy(), brute.tri.numpy())
    h = brute.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[h], brute.t.numpy()[h], rtol=1e-12)

    parts = build_packet_parts(mesh["verts"], mesh["faces"], device="cpu")
    pk = cuda_mt.intersect_packet_parts(parts, o.float(), d.float())
    assert (pk.hit == got.hit).float().mean() >= 0.99
    both = (pk.hit & got.hit).numpy()
    rel = (np.abs(pk.t.numpy()[both] - got.t.numpy()[both])
           / np.maximum(got.t.numpy()[both], 1.0))
    assert rel.max() <= 1e-5
    assert not ((pk.tri.numpy() != got.tri.numpy())[both] & (rel > 1e-6)).any()


def test_registry_grids_match_jax():
    """`bunny` and `mixed` build their grid as the reference's registry does."""
    for name in ("bunny", "mixed"):
        jscene, _ = jscenes.build_scene(name, dtype=jnp.float32)
        tscene, _ = tscenes.build_scene(name, device="cpu")
        assert tscene.grid is not None and tscene.packet is not None
        _assert_same_grid(tscene.grid, jscene.grid)
    knot, _ = tscenes.build_scene("knot1m", device="cpu")
    assert knot.grid is None  # the large meshes build the packet accel only


def test_with_grid_density_matches_jax():
    jscene, _ = jscenes.build_scene("triangles", dtype=jnp.float32)
    tscene, _ = tscenes.build_scene("triangles", device="cpu")
    assert tscene.grid is None
    _assert_same_grid(tscene.with_grid(density=2.0).grid, jscene.with_grid(density=2.0).grid)


def test_fit_and_poses_drop_the_grid():
    """A vertex or pose fit drops the grid built from the first vertices, as
    the reference's fit does; realize_scene drops it with the poses folded
    in; a fit of other leaves keeps it."""
    from tpu_ray_torch.fit import fit
    from tpu_ray_torch.scene.transform import MeshPoses, realize_scene
    from tpu_ray_torch.utils.config import FitConfig

    scene, cfg = tscenes.build_scene("triangles", device="cpu")
    scene = scene.with_grid()
    cfg = cfg.replace(width=8, height=8, shadow="none")
    target = torch.full((8, 8, 3), 0.5)
    fc = FitConfig(steps=1, learning_rate=1e-3)
    kept, _ = fit(scene, cfg, target, ["materials.albedo"], fc, verbose=False)
    assert kept.grid is scene.grid
    moved, _ = fit(scene, cfg, target, ["mesh.verts"], fc, verbose=False)
    assert moved.grid is None
    inst = torch.zeros(scene.mesh.verts.shape[0], dtype=torch.int32)
    posed = scene.replace(poses=MeshPoses.identity(1, inst, device="cpu"))
    assert realize_scene(posed).grid is None
    fitted, _ = fit(posed, cfg, target, ["poses.translate"], fc, verbose=False)
    assert fitted.grid is None and fitted.packet is not None
