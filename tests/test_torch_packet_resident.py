"""TPU kernel #4 (`intersect_packet`, the resident accel walked in a sorted
super order) and the multi-part walk, in the port against the JAX package;
the kernels' per-ray walk (csrc/packet_mt.cu, built with g++) against the
port's plain versions.

Tolerances and why:
  * #4's plain version against the Pallas kernel in interpret mode: hits
    equal, t rtol 1e-5, ids equal wherever the two nearest candidate t's of
    a ray differ by more than 1e-6 * t. Both visit the supers in the same
    sorted order and keep the first slot of a tie; XLA's CPU backend
    contracts the kernel's dot products into multiply-adds, which moves t
    by a few ulps (measured: 2 of 400 rays past rtol 1e-6, the worst
    1.5e-6), as tests/test_torch_mt.py found for #3.
  * the parts build: bit-identical (the same numpy build and Morton order).
  * the parts walk against brute MT: hits equal, t rtol 1e-5, ids with the
    same fallback, as tests/test_torch_mt.py holds #3.
  * the host build of the walk against the plain versions: bit-identical t
    and ids. The same float32 operations in the same order without
    contraction; the kernels' slab culls drop only chunks that cannot hold
    a closer hit. The host build runs the kernels' block walk itself, each
    block's 128 lanes (32 rays x 4 triangle slices) emulated in turn
    between its barriers; with duplicated triangles the tie goes to the
    first slot visited, as in the plain versions, bit for bit. #3's walk of
    the tree over the supers against the walk of every super in slot order
    (#4 given that order): bit-identical outputs and equal chunk, test and
    box counts, since the tree skips only supers whose step stages nothing.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.accel import packet as jpacket
from tpu_ray.kernels import moller_trumbore as jmt
from tpu_ray.kernels.pallas_mt import intersect_packet as j_intersect_packet
from tpu_ray.scene.mesh import MeshScene as JMesh
from tpu_ray_torch.accel import packet as tpacket
from tpu_ray_torch.accel.packet import refit_packet_accel, super_tree
from tpu_ray_torch.kernels import cuda_mt
from tpu_ray_torch.scene.mesh import torus_knot
import torch_host_build

torch.set_num_threads(1)


def _knot(seg_u=48, seg_v=48):
    """4,608 triangles: 36 chunks in 3 supers. Float32-exact vertices."""
    v, f = torus_knot(2, 3, seg_u, seg_v)
    return v.astype(np.float32).astype(np.float64), f


def _camera_rays(n, seed, origin=(0.3, 0.4, 3.2)):
    """Rays from one camera point aimed at the knot's bounding box."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(origin), (n, 1))
    d = rng.uniform([-0.9, -0.9, -0.4], [0.9, 0.9, 0.4], (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _shadow_rays(n, seed):
    """Rays from points around the knot toward one light direction."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3))
    l_dir = np.asarray([0.6, 0.8, 0.3])
    d = np.tile(l_dir / np.linalg.norm(l_dir), (n, 1))
    return o.astype(np.float32), d.astype(np.float32), l_dir.astype(np.float32)


def _clear(o, d, mesh, hit):
    """Hit rays whose two nearest candidate t's differ by more than 1e-6 t
    (closer than that, rounding may pick either triangle)."""
    v0, v1, v2 = mesh.triangle_corners()
    t_all, _ = jmt._mt_t(jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], v0, v1, v2,
                         jmt.BIG)
    two = np.sort(np.asarray(t_all), axis=1)[:, :2]
    return hit & (two[:, 1] - two[:, 0] > 1e-6 * two[:, 0])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_intersect_packet_torch_matches_pallas_interpret(any_hit):
    """One call of the TPU kernel in interpret mode per mode (its compile
    takes about a minute): closest-hit from one camera with sort_origin and
    a seed (BIG, a cut at 2.9, or 0), any-hit toward a light with sort_dir
    and 0-seeds, on a mesh of 3 supers."""
    v, f = _knot()
    jacc = jpacket.build_packet_accel(v, f)
    tacc = tpacket.build_packet_accel(v, f)
    assert tacc.super_aabb.shape[0] == 3
    n = 400
    if any_hit:
        o, d, l_dir = _shadow_rays(n, 5)
        seed = np.where(np.arange(n) % 3 == 0, 0.0, 4.0).astype(np.float32)
        hint = dict(sort_dir=l_dir)
        t_max = 4.0
    else:
        o, d = _camera_rays(n, 3)
        seed = np.select([np.arange(n) % 3 == 0, np.arange(n) % 3 == 1], [0.0, 2.9],
                         1e10).astype(np.float32)
        hint = dict(sort_origin=o[0])
        t_max = 1e10
    want = j_intersect_packet(jacc, jnp.asarray(o), jnp.asarray(d), t_max=t_max,
                              any_hit=any_hit, t_init=jnp.asarray(seed), interpret=True,
                              **{k: jnp.asarray(x) for k, x in hint.items()})
    got = cuda_mt.intersect_packet_torch(tacc, torch.as_tensor(o), torch.as_tensor(d),
                                         t_max=t_max, any_hit=any_hit,
                                         t_init=torch.as_tensor(seed),
                                         **{k: torch.as_tensor(x) for k, x in hint.items()})
    hit = np.asarray(want.hit)
    assert 0.1 < hit.mean() < 0.9 and not hit[seed == 0].any()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    if any_hit:
        # the reference's any-hit t is the first blocker the walk met; the
        # port reports BIG (cuda_mt's docstring)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        assert (got.t.numpy() == 1e10).all()
        return
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    mesh = JMesh.from_numpy(v, f, dtype=jnp.float32)
    clear = _clear(o, d, mesh, hit)
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(got.tri.numpy()[clear], np.asarray(want.tri)[clear])


@pytest.mark.parametrize("streamed", [False, None], ids=["split", "whole"])
def test_build_packet_parts_matches_reference(streamed):
    """At a budget of one super: 3 parts with streamed=False, one
    whole-mesh part by default, array for array the reference's."""
    v, f = _knot()
    budget = jpacket.packet_accel_bytes(2048)
    assert tpacket.packet_accel_bytes(2048) == budget and not tpacket.fits_vmem(10 ** 6)
    want = jpacket.build_packet_parts(v, f, budget_bytes=budget, streamed=streamed)
    got = tpacket.build_packet_parts(v, f, budget_bytes=budget, streamed=streamed,
                                     device="cpu")
    assert len(got) == len(want) == (3 if streamed is False else 1)
    for g, w in zip(got, want):
        assert g.num_tris == w.num_tris
        for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)), err_msg=name)


def test_knot1m_splits_into_six_parts():
    """knot1m's 1.05M triangles at the 12 MiB budget: 6 parts of at most 90
    supers, the reference's, array for array."""
    from tpu_ray.scene.scenes import build_scene as jbuild

    jscene, _ = jbuild("knot1m", dtype=jnp.float32)
    v = np.asarray(jscene.mesh.verts, np.float64)
    f = np.asarray(jscene.mesh.tris)
    want = jpacket.build_packet_parts(v, f, streamed=False)
    got = tpacket.build_packet_parts(v, f, streamed=False, device="cpu")
    assert len(got) == len(want) == 6
    assert max(g.super_aabb.shape[0] for g in got) == 90
    assert all(tpacket.fits_vmem(g.num_tris) for g in got)
    for g, w in zip(got, want):
        for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)), err_msg=name)


def test_build_packet_parts_splits_past_the_slot_limit(monkeypatch):
    """Past the slot limit (2^24 in both packages; lowered here to 2 supers)
    a streamed build splits into Morton-contiguous parts of one super less,
    each the reference's build of its slice."""
    v, f = _knot()
    monkeypatch.setattr(tpacket, "TRI_SLOT_LIMIT", 2 * 2048)
    got = tpacket.build_packet_parts(v, f, budget_bytes=tpacket.packet_accel_bytes(2048),
                                     device="cpu")
    order = jpacket._morton_order(v, np.asarray(f, np.int64))
    assert len(got) == 3  # 4,608 triangles in parts of 1 super
    for i, g in enumerate(got):
        sel = order[i * 2048:(i + 1) * 2048]
        w = jpacket.build_packet_accel(v, np.asarray(f)[sel], tri_id_base=sel)
        for name in ("corners", "chunk_aabb", "super_aabb", "perm"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)), err_msg=name)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_intersect_packet_parts_matches_brute(any_hit):
    """The parts walk (3 parts, the running t threaded through them, the
    caller's seed kept where no part improved on it) against JAX's brute MT
    over the whole mesh."""
    v, f = _knot()
    parts = tpacket.build_packet_parts(v, f, budget_bytes=tpacket.packet_accel_bytes(2048),
                                       streamed=False, device="cpu")
    assert len(parts) == 3
    mesh = JMesh.from_numpy(v, f, dtype=jnp.float32)
    o, d = _camera_rays(500, 9)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    if any_hit:
        got = cuda_mt.intersect_packet_parts(parts, ot, dt, t_max=4.0, any_hit=True,
                                             sort_dir=torch.tensor([0.6, 0.8, 0.3]))
        want = np.asarray(jmt.any_hit_brute(mesh, jnp.asarray(o), jnp.asarray(d), t_max=4.0))
        assert 0.1 < want.mean() < 0.9
        np.testing.assert_array_equal(got.hit.numpy(), want)
        np.testing.assert_array_equal(got.tri.numpy(), np.where(want, 0, -1))
        return
    seed = torch.where(torch.arange(500) % 4 == 0, 3.0, 1e10)
    got = cuda_mt.intersect_packet_parts(parts, ot, dt, sort_origin=ot[0], t_init=seed)
    brute = jmt.intersect_brute(mesh, jnp.asarray(o), jnp.asarray(d))
    w_t = np.asarray(brute.t)
    hit = np.asarray(brute.hit) & (w_t < seed.numpy())
    assert 0.1 < hit.mean() < 0.9 and (~hit & np.asarray(brute.hit)).any()
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], w_t[hit], rtol=1e-5)
    clear = _clear(o, d, mesh, hit)
    assert clear.sum() > 0.9 * hit.sum()
    np.testing.assert_array_equal(got.tri.numpy()[clear], np.asarray(brute.tri)[clear])


def test_cpu_calls_launch_no_kernel():
    v, f = _knot(24, 24)
    parts = tpacket.build_packet_parts(v, f, device="cpu")
    o, d = _camera_rays(64, 1)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    cuda_mt.intersect_packet(parts[0], ot, dt, sort_origin=ot[0])
    cuda_mt.any_hit_packet(parts[0], ot, dt, t_max=4.0)
    cuda_mt.intersect_packet_parts(parts, ot, dt)
    assert set(cuda_mt.LAUNCHES.values()) == {0}


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    so = torch_host_build.build_packet(tmp_path_factory.mktemp("packet_host"))
    if so is None:
        pytest.skip("g++ not found: the kernels' host build needs it")
    return so


@pytest.mark.parametrize("case", ["streamed", "origin", "dir_any_hit", "slot_any_hit"])
def test_kernel_walk_matches_plain_version(host_walk, case):
    """csrc/packet_mt.cu's per-ray walk as the kernels run it: #3 in slot
    order, #4 with sort_origin and a seed, with sort_dir any-hit and
    0-seeds, and without a hint; against the plain versions."""
    v, f = _knot()
    accel = tpacket.build_packet_accel(v, f)
    if case in ("streamed", "origin"):
        o, d = _camera_rays(2000, 21)
        any_hit, t_max, hint = False, 1e10, {"sort_origin": torch.as_tensor(o[0])}
        seed = torch.where(torch.arange(2000) % 3 == 0, 3.0, 1e10)
    else:
        o, d, l_dir = _shadow_rays(2000, 22)
        any_hit, t_max = True, 4.0
        hint = {"sort_dir": torch.as_tensor(l_dir)} if case == "dir_any_hit" else {}
        seed = torch.where(torch.arange(2000) % 3 == 0, 0.0, 4.0)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    if case == "streamed":
        order = None
        want = cuda_mt.intersect_packet_streamed_torch(accel, ot, dt, t_max=t_max,
                                                       t_init=seed)
    else:
        order = cuda_mt.super_order(accel, **hint)
        want = cuda_mt.intersect_packet_torch(accel, ot, dt, t_max=t_max, any_hit=any_hit,
                                              t_init=seed, **hint)
    t, tri, hit = torch_host_build.packet_walk(host_walk, accel, ot, dt, t_max, any_hit,
                                               order, seed)
    assert 0.05 < float(want.hit.float().mean()) < 0.95
    assert torch.equal(hit, want.hit)
    assert torch.equal(t, want.t)
    assert torch.equal(tri, want.tri)


def _tied_accel(across_nodes=False):
    """The knot's accel with two triangles duplicated into other slots: the
    triangle of slot (super 0, chunk 2, lane 70) also at (super 2, chunk 2,
    lane 17), and that of (super 1, chunk 4, lane 90) also at lane 10 of the
    same chunk, another slice. across_nodes: a knot of 21 supers, the first
    triangle at (super 1, chunk 2, lane 70) and (super 17, chunk 3, lane 17),
    under two level-1 nodes of the tree. Returns (accel, [(first slot, copy
    slot)])."""
    v, f = _knot(144, 144) if across_nodes else _knot()
    accel = tpacket.build_packet_accel(v, f)
    perm = accel.perm.long()
    pairs = [((1 * 2048 + 2 * 128 + 70, 17 * 2048 + 3 * 128 + 17) if across_nodes
              else (0 * 2048 + 2 * 128 + 70, 2 * 2048 + 2 * 128 + 17)),
             (1 * 2048 + 4 * 128 + 90, 1 * 2048 + 4 * 128 + 10)]
    tris = torch.as_tensor(np.asarray(f, np.int64)).clone()
    for a, b in pairs:
        tris[perm[b]] = tris[perm[a]]
    return refit_packet_accel(accel, torch.as_tensor(v, dtype=torch.float32), tris), pairs


def _rays_onto(accel, slot, n, seed):
    """n rays falling onto the triangle of a slot along its normal, from
    1e-3 above interior points."""
    rows = accel.corners.reshape(-1, 16, 128)[slot // 128, :9, slot % 128].double()
    v0, e1, e2 = rows[0:3], rows[3:6], rows[6:9]
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / nrm.norm()
    uv = torch.as_tensor(np.random.default_rng(seed).dirichlet([2.0, 2.0, 2.0], n))
    p = v0 + uv[:, 1:2] * e1 + uv[:, 2:3] * e2
    return (p + 1e-3 * nrm).float(), (-nrm).expand(n, 3).float().contiguous()


@pytest.mark.parametrize("case", ["slot_order", "sorted_order", "across_nodes"])
def test_kernel_walk_keeps_the_first_of_tied_triangles(host_walk, case):
    """Exact ties, from the same triangle in two chunks of two supers and in
    two slices of one chunk: the block walk (per-slice bests reduced by
    (t, visit rank)) returns the first slot visited, equal to the plain
    versions bit for bit; #3 in slot order, #4 in a super order that visits
    super 2 before super 0; #3's tree walk with the two supers under two
    level-1 nodes (the lower slot wins), also equal to #4 in slot order."""
    accel, pairs = _tied_accel(case == "across_nodes")
    perm = accel.perm.long()
    o, d = zip(*(_rays_onto(accel, a, 96, i) for i, (a, _) in enumerate(pairs)))
    o, d = torch.cat(o), torch.cat(d)
    # in one chunk lane 10 comes first, whatever the super order
    if case != "sorted_order":
        order = None
        want = cuda_mt.intersect_packet_streamed_torch(accel, o, d)
        first = [perm[pairs[0][0]], perm[pairs[1][1]]]
        if case == "across_nodes":
            assert accel.tree.shape[0] == 2 + 1
            flat = torch_host_build.packet_walk(host_walk, accel, o, d, 1e10, False,
                                                _slot_order(accel))
            assert all(torch.equal(a, b) for a, b in zip(flat, want))
    else:
        hint = {"sort_origin": 0.5 * (accel.super_aabb[2, :3] + accel.super_aabb[2, 3:6])}
        order = cuda_mt.super_order(accel, **hint)
        assert order.tolist().index(2) < order.tolist().index(0)
        want = cuda_mt.intersect_packet_torch(accel, o, d, **hint)
        first = [perm[pairs[0][1]], perm[pairs[1][1]]]
    t, tri, hit = torch_host_build.packet_walk(host_walk, accel, o, d, 1e10, False, order)
    assert bool(want.hit.all())
    assert torch.equal(hit, want.hit) and torch.equal(t, want.t) and torch.equal(tri, want.tri)
    assert torch.equal(tri[:96], torch.full((96,), int(first[0]), dtype=torch.int32))
    assert torch.equal(tri[96:], torch.full((96,), int(first[1]), dtype=torch.int32))


def test_kernel_walk_counts_its_work(host_walk):
    """The walk's counters on 1,000 rays (a ragged last block): one count
    per block, each ray counted once, every passing (ray, chunk) pair runs
    the chunk's 128 MT tests, at most every ray passes a staged chunk's
    box, and the counts do not change the result."""
    v, f = _knot()
    accel = tpacket.build_packet_accel(v, f)
    o, d = _camera_rays(1000, 23)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    counters = torch.zeros(len(cuda_mt.COUNTERS), dtype=torch.int64)
    got = torch_host_build.packet_walk(host_walk, accel, ot, dt, 1e10, False, None,
                                       None, counters)
    want = cuda_mt.intersect_packet_streamed_torch(accel, ot, dt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    c = dict(zip(cuda_mt.COUNTERS, counters.tolist()))
    assert c["blocks"] == 32 and c["rays"] == 1000 and 0 < c["supers_visited"] <= 32 * 3
    assert 0 < c["box_passes"] <= c["box_slots"] and c["chunks_staged"] > 0
    assert c["mt_tests"] == 128 * c["box_passes"]


def _slot_order(accel):
    """#4's super order that is slot order: the flat walk of every super."""
    return torch.arange(accel.super_aabb.shape[0], dtype=torch.int32)


# knots whose accels have 1, 3, 17 (16k + 1: a lone last super, half
# padded), 21 and 257 (16 * 16 + 1: levels of 17, 2 and 1 nodes) supers
TREE_KNOTS = {1: (32, 32), 3: (48, 48), 17: (132, 128), 21: (144, 144), 257: (513, 512)}


@pytest.fixture(scope="module")
def knot_accels():
    """The accels of TREE_KNOTS, built at first use."""
    built = {}

    def get(supers):
        if supers not in built:
            built[supers] = tpacket.build_packet_accel(*_knot(*TREE_KNOTS[supers]))
            assert built[supers].super_aabb.shape[0] == supers
        return built[supers]
    return get


def _beams(n, seed, any_hit):
    """n rays in coherent blocks of 32, as the renderer's Morton blocks are:
    camera rays toward a jittered point near each block's own aim, or
    shadow rays from a jittered point near each block's own origin toward
    one light."""
    rng = np.random.default_rng(seed)
    blocks = -(-n // 32)
    jitter = rng.uniform(-0.06, 0.06, (blocks, 32, 3))
    if any_hit:
        o = (rng.uniform(-1.2, 1.2, (blocks, 1, 3)) + jitter).reshape(-1, 3)[:n]
        d = np.tile(np.asarray([0.6, 0.8, 0.3]) / np.linalg.norm([0.6, 0.8, 0.3]), (n, 1))
    else:
        o = np.tile(np.asarray([0.3, 0.4, 3.2]), (n, 1))
        aim = rng.uniform([-0.9, -0.9, -0.4], [0.9, 0.9, 0.4], (blocks, 1, 3)) + jitter
        d = aim.reshape(-1, 3)[:n] - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)


@pytest.mark.parametrize("supers", sorted(TREE_KNOTS))
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_tree_walk_equals_the_walk_of_every_super(host_walk, knot_accels, supers, any_hit):
    """#3's tree walk against the plain version and against the walk of
    every super in slot order (#4 given the identity order), on 301 rays (a
    ragged last block) in coherent blocks with seeds of t_max, 2.9 and 0:
    t, tri and hit bit-identical; chunks staged, MT tests, box passes and
    slots equal; no more supers stepped, each tree node visited at most once
    a block, and past 16 supers fewer steps in all than the flat walk's."""
    accel = knot_accels(supers)
    n = 301
    o, d = _beams(n, 40 + supers, any_hit)
    t_max = 4.0 if any_hit else 1e10
    i = torch.arange(n)
    seed = torch.where(i % 3 == 0, 0.0, torch.where(i % 3 == 1, 2.9, t_max))
    want = cuda_mt.intersect_packet_streamed_torch(accel, o, d, t_max=t_max, any_hit=any_hit,
                                                   t_init=seed)
    counts = {}
    for walk, order in (("tree", None), ("flat", _slot_order(accel))):
        c = torch.zeros(len(cuda_mt.COUNTERS), dtype=torch.int64)
        got = torch_host_build.packet_walk(host_walk, accel, o, d, t_max, any_hit, order, seed,
                                           c)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), walk
        counts[walk] = dict(zip(cuda_mt.COUNTERS, c.tolist()))
    tree, flat = counts["tree"], counts["flat"]
    assert 0 < int(want.hit.sum()) < n and not want.hit[seed == 0].any()
    for k in ("chunks_staged", "mt_tests", "box_passes", "box_slots", "blocks", "rays"):
        assert tree[k] == flat[k], k
    assert tree["chunks_staged"] > 0 and flat["nodes_visited"] == 0
    assert tree["supers_visited"] <= flat["supers_visited"]
    assert 0 < tree["nodes_visited"] <= tree["blocks"] * accel.tree.shape[0]
    if supers > 16:
        assert tree["supers_visited"] + tree["nodes_visited"] < flat["supers_visited"]


def test_super_tree_holds_its_children_exactly():
    """The tree of 4,097 seeded boxes (knot8m's count): levels of 257, 17, 2
    and 1 nodes, each node's box the exact min and max of its children's
    (a last node of fewer children included), so it holds them bit for
    bit; 1 and 16 supers make the root alone, 17 a root over two nodes."""
    rng = np.random.default_rng(7)
    lo = rng.normal(size=(4097, 3)).astype(np.float32)
    sup = torch.zeros((4097, 128))
    sup[:, 0:3] = torch.as_tensor(lo)
    sup[:, 3:6] = torch.as_tensor(lo + rng.uniform(0, 0.5, (4097, 3)).astype(np.float32))
    tree = super_tree(sup)
    assert tree.shape == (257 + 17 + 2 + 1, 8) and tree.dtype == torch.float32
    assert torch.equal(tree[:, 6:], torch.zeros(tree.shape[0], 2))
    kids, row = sup[:, :6], 0
    for count in (257, 17, 2, 1):
        level = tree[row:row + count, :6]
        for j in range(count):
            k = kids[16 * j:16 * j + 16]
            assert torch.equal(level[j, :3], k[:, :3].amin(0))
            assert torch.equal(level[j, 3:], k[:, 3:].amax(0))
            assert bool((level[j, :3] <= k[:, :3]).all() and (level[j, 3:] >= k[:, 3:]).all())
        kids, row = level, row + count
    for s, rows in ((1, 1), (16, 1), (17, 3)):
        assert super_tree(sup[:s]).shape[0] == rows
        assert torch.equal(super_tree(sup[:s])[-1, :3], sup[:s, :3].amin(0))
        assert torch.equal(super_tree(sup[:s])[-1, 3:6], sup[:s, 3:6].amax(0))


def _moved(v):
    """The knot's vertices, those with x > 0 moved 3 along +x: outside
    every box of the build's tree."""
    w = torch.as_tensor(v, dtype=torch.float32).clone()
    w[w[:, 0] > 0] += torch.tensor([3.0, 0.0, 0.0])
    return w


@pytest.mark.parametrize("path", ["native", "numpy", "cache", "refit", "transform", "ring",
                                  "replace", "plan"])
def test_every_accel_carries_the_tree_of_its_supers(path, monkeypatch, tmp_path):
    """Every path that makes or replaces super_aabb leaves the tree equal to
    super_tree(super_aabb): the native and numpy builds, the disk cache's
    load, the refit (fit), the poses' refit (scene/transform.py), the ring's
    shard and its refit, and dataclasses.replace of the boxes alone; a
    plan's structure keeps the tree as a leaf of its own."""
    from tpu_ray_torch.dist import scene_shard
    from tpu_ray_torch.render import graphs

    v, f = _knot(144, 144)
    tris = torch.as_tensor(np.asarray(f, np.int64))
    if path == "numpy":
        monkeypatch.setenv("TPU_RAY_TORCH_NATIVE", "0")
    if path == "cache":
        monkeypatch.setenv(tpacket.CACHE_ENV, str(tmp_path))
        monkeypatch.setattr(tpacket, "CACHE_MIN_TRIS", 1)
        tpacket.build_packet_parts(v, f, device="cpu")
        hits = tpacket.build_counters()["cache_hits"]
        (accel,) = tpacket.build_packet_parts(v, f, device="cpu")
        assert tpacket.build_counters()["cache_hits"] == hits + 1
    else:
        accel = tpacket.build_packet_accel(v, f)
    old = accel.tree
    if path == "refit":
        accel = refit_packet_accel(accel, _moved(v), tris)
    elif path == "transform":
        from tpu_ray_torch.scene import scenes as tscenes
        from tpu_ray_torch.scene import transform as ttf

        scene, _ = tscenes.build_scene("triangles", device="cpu")
        scene = scene.with_packet()
        old = scene.packet[0].tree
        inst = np.full((scene.mesh.verts.shape[0],), -1, np.int32)
        inst[:3] = 0
        poses = ttf.MeshPoses.identity(1, inst, device="cpu").replace(
            translate=torch.tensor([[2.0, -1.0, 0.5]]))
        (accel,) = ttf.realize_scene(scene.replace(poses=poses)).packet
    elif path == "ring":
        ring = scene_shard.build_ring_packet(v, f, device="cpu")
        assert torch.equal(ring.tree, super_tree(ring.super_aabb))
        assert torch.equal(ring.accel().tree, ring.tree)
        ring = scene_shard.refit_ring_packet(ring, _moved(v), tris)
        assert torch.equal(ring.accel().tree, ring.tree)
        accel = ring.accel()
    elif path == "replace":
        boxes = refit_packet_accel(accel, _moved(v), tris).super_aabb
        accel = dataclasses.replace(accel, super_aabb=boxes)
    elif path == "plan":
        leaves = []
        back = graphs.unflatten(graphs.flatten(accel, leaves), iter(leaves))
        assert sum(x is accel.tree for x in leaves) == 1 and back.tree is accel.tree
    assert torch.equal(accel.tree, super_tree(accel.super_aabb))
    moved = path in ("refit", "transform", "ring", "replace")
    assert torch.equal(accel.tree, old) != moved


def test_walk_after_a_refit_reads_the_refit_tree(host_walk):
    """A refit that moves half the knot: #3's walk on the refit accel, from
    a camera over the moved half, equals the plain version bit for bit, and
    the same boxes under the build's stale tree lose hits (what a tree left
    behind would do)."""
    v, f = _knot(144, 144)
    built = tpacket.build_packet_accel(v, f)
    accel = refit_packet_accel(built, _moved(v), torch.as_tensor(np.asarray(f, np.int64)))
    o, d = _beams(320, 11, False)
    o = o + torch.tensor([3.1, 0.0, 0.0])
    want = cuda_mt.intersect_packet_streamed_torch(accel, o, d)
    got = torch_host_build.packet_walk(host_walk, accel, o, d, 1e10, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and int(want.hit.sum()) > 32
    stale = tpacket.PacketAccel.carrying(
        built.tree, **{k: getattr(accel, k) for k in ("corners", "chunk_aabb", "super_aabb",
                                                     "perm", "num_tris")})
    _, _, hit = torch_host_build.packet_walk(host_walk, stale, o, d, 1e10, False)
    assert int((hit != want.hit).sum()) > 0
