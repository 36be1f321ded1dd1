"""The port's distributed layer in 2 and 4 gloo processes on the CPU, against
the JAX package's single-device render and fit step and its compiled
sharded entry points over a mesh of as many fake CPU devices
(`render_image_sharded_jit`, the jitted `make_sharded_fit_step`).

The processes run tests/torch_dist_worker.py (torch, numpy and the port
only); one group of each size runs every case once, started together by a
module fixture while this process computes the references.

Tolerances and why:
  * pixel-parallel frames, with and without the ring: `triangles` atol
    1e-5 (no fractal); `mixed` the bound tests/test_torch_render.py holds
    its frame to (95th-percentile pixel error < 5e-3, max < 1.0, mean <
    1e-3: the Mandelbulb march is chaotic). Every rank gathers the same
    frame, bit for bit. The JAX package's render_image_sharded_jit takes
    no ring, so the ring cases are held against its replicated frame (the
    ring replaces only the geometry pass's walk).
  * render_image_sharded_jit against render_image_sharded: bit for bit,
    frames and bands (on the CPU its plan runs the same blocks uncaptured,
    and the gather only moves values).
  * the sharded fit step (graphed): loss rtol 1e-5 and parameters after
    one SGD step atol 1e-6, against the single-device step and the JAX
    package's sharded step on the same mesh, with the ring where the case
    has it (the per-rank losses and gradients are summed in another order
    than the reference's; lr 1e-3 scales the gradient's float32 rounding
    far below that).
  * the brute ring against brute MT, both float64: t rtol 1e-10, hits and
    ids equal (ties break by the smallest id in both).
  * psum_buckets and one all_reduce per leaf: equal (the same sums of the
    same float32 values).
  * the per-process image write: render_image_sharded(gather=False) gives
    each rank its band of rows, and the bands stacked in rank order equal
    the gathered frame bit for bit (the same values, moved); each rank's
    PNG (write_image_per_host) decodes to its band's 8-bit image, and
    stacked they equal rank 0's PNG of the gathered frame.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_dist_worker as W
from tpu_ray import fit as jfit
from tpu_ray.dist import sharding as jsharding
from tpu_ray.kernels import moller_trumbore as jmt
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray.scene.mesh import MeshScene as JMesh
from tpu_ray.utils.config import RenderConfig as JConfig
from tpu_ray_torch.dist import multihost, sharding
from tpu_ray_torch.utils.config import RenderConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 4)


def _inputs() -> dict:
    """The cases' inputs, made from seeds with numpy."""
    rng = np.random.default_rng(4)
    n_tris = 97  # not divisible by 2 or 4: the partition pads
    c = rng.uniform(-2, 2, (n_tris, 3))
    e0 = rng.normal(size=(n_tris, 3)) * 0.4
    e1 = rng.normal(size=(n_tris, 3)) * 0.4
    verts = np.stack([c - e0, c + e1, c + e0 - e1], 1).reshape(-1, 3)
    o = rng.uniform(-4, 4, (128, 3))
    d = rng.normal(size=(128, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jscene, _ = jscenes.build_scene("triangles", dtype=jnp.float32)
    base = np.asarray(jscene.mesh.verts)
    moved = (base + np.random.default_rng(3).normal(size=base.shape) * 0.2).astype(np.float32)
    h, w = W.FIT_CFG["height"], W.FIT_CFG["width"]
    target = (0.5 + 0.1 * np.random.default_rng(5).random((h, w, 3))).astype(np.float32)
    return dict(ring_verts=verts, ring_faces=np.arange(3 * n_tris).reshape(-1, 3), ring_o=o,
                ring_d=d, fit_moved_verts=moved, fit_target=target)


def _references(inputs) -> dict:
    """The JAX package's single-device frames and fit steps, and brute MT."""
    ref = {}
    with jax.enable_x64(False):
        for case, name, over, _ in W.RENDERS:
            jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
            ref[f"img_{case}"] = np.asarray(jrender.render_image(
                jscene, jcfg.replace(pallas="off", block_size=0, **over)))
        jscene, jcfg = jscenes.build_scene("triangles", dtype=jnp.float32)
        jcfg = jcfg.replace(pallas="off", **W.FIT_CFG)
        opt = optax.sgd(W.FIT_LR)
        step = jfit.make_fit_step(jscene, jcfg, jnp.asarray(inputs["fit_target"]), opt)
        for case, _, moved in W.FITS:
            params = jfit.extract_params(jscene, W.FIT_PATHS)
            if moved:
                params["mesh.verts"] = jnp.asarray(inputs["fit_moved_verts"])
            new, _, loss = step(params, opt.init(params))
            ref[f"fit_{case}_loss"] = float(loss)
            for k in W.FIT_PATHS:
                ref[f"fit_{case}_{k}"] = np.asarray(new[k])
        for n in SIZES:
            dev_mesh = jsharding.make_mesh(jax.devices()[:n])
            for case, name, over, _ in W.RENDERS:
                jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
                ref[f"sharded_{n}_{case}"] = np.asarray(jsharding.render_image_sharded_jit(
                    jscene, jcfg.replace(pallas="off", block_size=0, **over), dev_mesh))
            jscene, jcfg = jscenes.build_scene("triangles", dtype=jnp.float32)
            jcfg = jcfg.replace(pallas="off", **W.FIT_CFG)
            # one jitted step with the ring and one without (the ring's
            # Pallas walk runs in interpret mode here: one compile a size)
            steps = {shards: jfit.make_sharded_fit_step(
                jscene, jcfg, jnp.asarray(inputs["fit_target"]), opt, dev_mesh,
                scene_shards=shards) for shards in (False, True)}
            for case, shards, moved in W.FITS:
                params = jfit.extract_params(jscene, W.FIT_PATHS)
                if moved:
                    params["mesh.verts"] = jnp.asarray(inputs["fit_moved_verts"])
                new, _, loss = steps[shards](params, opt.init(params))
                ref[f"sharded_fit_{n}_{case}_loss"] = float(loss)
                for k in W.FIT_PATHS:
                    ref[f"sharded_fit_{n}_{case}_{k}"] = np.asarray(new[k])
    mesh = JMesh.from_numpy(inputs["ring_verts"], inputs["ring_faces"], dtype=jnp.float64)
    brute = jmt.intersect_brute(mesh, jnp.asarray(inputs["ring_o"]),
                                jnp.asarray(inputs["ring_d"]))
    ref.update(ring_t=np.asarray(brute.t), ring_tri=np.asarray(brute.tri),
               ring_hit=np.asarray(brute.hit))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process groups, started together; then the references, computed
    here while they run -> (references, {size: [each rank's outputs]})."""
    inputs = _inputs()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    procs = {}
    for n in SIZES:
        io = tmp_path_factory.mktemp(f"dist{n}")
        np.savez(io / "inputs.npz", **inputs)
        procs[n] = (io, [subprocess.Popen([sys.executable, worker, str(io / "store"), str(r),
                                           str(n), str(io)], env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT) for r in range(n)])
    try:
        ref = _references(inputs)
        outs = {}
        for n, (io, ps) in procs.items():
            for r, p in enumerate(ps):
                text = p.communicate(timeout=600)[0].decode(errors="replace")
                assert p.returncode == 0, f"rank {r} of {n} failed:\n{text}"
            outs[n] = [dict(np.load(io / f"out_{r}.npz")) for r in range(n)]
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return ref, outs


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c for c, *_ in W.RENDERS])
def test_render_image_sharded_matches_jax(runs, n, case):
    ref, outs = runs
    img = outs[n][0][f"img_{case}"]
    for other in outs[n][1:]:
        np.testing.assert_array_equal(other[f"img_{case}"], img)  # one gathered frame
    want = ref[f"img_{case}"]
    assert img.shape == want.shape and np.isfinite(img).all()
    if case.startswith("mixed"):
        err = np.abs(img - want).max(-1)
        p95, mx, mean = np.quantile(err, 0.95), err.max(), np.abs(img - want).mean()
        assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)
    else:
        np.testing.assert_allclose(img, want, atol=1e-5, rtol=0)


def _frame_close(img, want, case):
    assert img.shape == want.shape and np.isfinite(img).all()
    if case.startswith("mixed"):
        err = np.abs(img - want).max(-1)
        p95, mx, mean = np.quantile(err, 0.95), err.max(), np.abs(img - want).mean()
        assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)
    else:
        np.testing.assert_allclose(img, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c for c, *_ in W.RENDERS])
def test_render_image_sharded_jit_matches_eager_and_jax(runs, n, case):
    """render_image_sharded_jit (each rank's slice through the graphs'
    plan, the gather an all_gather_into_tensor) on every rank equals the
    eager frame bit for bit, and matches the JAX package's
    render_image_sharded_jit over a mesh of n devices."""
    ref, outs = runs
    for out in outs[n]:
        np.testing.assert_array_equal(out[f"jit_{case}"], out[f"img_{case}"])
    _frame_close(outs[n][0][f"jit_{case}"], ref[f"sharded_{n}_{case}"], case)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c for c, *_ in W.BANDS])
def test_render_image_sharded_jit_bands_equal_eager(runs, n, case):
    _, outs = runs
    for out in outs[n]:
        np.testing.assert_array_equal(out[f"bandjit_{case}"], out[f"band_{case}"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c for c, *_ in W.FITS])
def test_sharded_fit_step_matches_jax_sharded_step(runs, n, case):
    """The graphed step against the JAX package's jitted make_sharded_fit_step
    on a mesh of as many devices, its ring where the case has one (the
    moved vertices: both refit their shards before the ring turns)."""
    ref, outs = runs
    for out in outs[n]:
        np.testing.assert_allclose(float(out[f"fit_{case}_loss"]),
                                   ref[f"sharded_fit_{n}_{case}_loss"], rtol=1e-5)
        for k in W.FIT_PATHS:
            np.testing.assert_allclose(out[f"fit_{case}_{k}"], ref[f"sharded_fit_{n}_{case}_{k}"],
                                       atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("n", SIZES)
def test_destroy_drops_the_plans_of_the_group(runs, n):
    """multihost.destroy drops every graph plan that names the group (the
    ring frames', the gathers', the all-reduces') and keeps the others."""
    _, outs = runs
    for out in outs[n]:
        assert int(out["plans_named_before"]) >= 4 and int(out["plans_named_after"]) == 0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c for c, *_ in W.FITS])
def test_sharded_fit_step_matches_jax(runs, n, case):
    """One SGD step of `mesh.verts` and `camera.origin` on `triangles`: pixel
    parallel with the scene replicated, with the ring, and with the ring
    from vertices moved well past the build's boxes (each rank refits its
    shard before the ring turns), against the single-device step."""
    ref, outs = runs
    for out in outs[n]:  # every rank reports the global loss and takes one step
        np.testing.assert_allclose(float(out[f"fit_{case}_loss"]), ref[f"fit_{case}_loss"],
                                   rtol=1e-5)
        for k in W.FIT_PATHS:
            np.testing.assert_allclose(out[f"fit_{case}_{k}"], ref[f"fit_{case}_{k}"],
                                       atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", [c for c, *_ in W.BANDS])
def test_bands_stack_to_the_gathered_frame(runs, n, case):
    from tpu_ray_torch.dist.sharding import row_bands
    from tpu_ray_torch.utils.image_io import read_png

    _, outs = runs
    whole = outs[n][0][f"whole_{case}"]
    bands = row_bands(whole.shape[0], n)
    for r, out in enumerate(outs[n]):
        r0, r1 = bands[r]
        assert out[f"band_{case}"].shape == (r1 - r0, whole.shape[1], 3)
        assert r1 - r0 <= -(-whole.shape[0] // n)
    np.testing.assert_array_equal(np.concatenate([o[f"band_{case}"] for o in outs[n]]), whole)
    files = [str(o[f"band_file_{case}"]) for o in outs[n]]
    assert [os.path.basename(f) for f in files if f] == [
        f"{case}.p{r:03d}.png" for r in range(n) if bands[r][1] > bands[r][0]]
    assert [str(o[f"whole_file_{case}"]) for o in outs[n]][1:] == [""] * (n - 1)
    pngs = np.concatenate([read_png(f) for f in files if f])
    np.testing.assert_array_equal(pngs, read_png(str(outs[n][0][f"whole_file_{case}"])))


def test_single_process_band_is_the_frame(tmp_path):
    """At world size 1 gather=False returns the whole frame and the write
    goes to `path` itself."""
    from tpu_ray_torch.scene.scenes import build_scene
    from tpu_ray_torch.utils.image_io import read_png

    scene, cfg = build_scene("triangles", device="cpu")
    cfg = cfg.replace(width=16, height=12, block_size=0)
    with torch.no_grad():
        band = sharding.render_image_sharded(scene, cfg, gather=False)
        whole = sharding.render_image_sharded(scene, cfg)
    assert torch.equal(band, whole)
    path = str(tmp_path / "one.png")
    assert multihost.write_image_per_host(path, band, banded=True) == path
    assert read_png(path).shape == (12, 16, 3)
    assert sharding.row_bands(13, 4) == [(0, 4), (4, 8), (8, 12), (12, 13)]
    assert sharding.row_bands(9, 4) == [(0, 3), (3, 6), (6, 9), (9, 9)]


@pytest.mark.parametrize("n", SIZES)
def test_intersect_ring_matches_brute(runs, n):
    ref, outs = runs
    got = {k: np.concatenate([o[k] for o in outs[n]]) for k in ("ring_t", "ring_tri",
                                                                 "ring_hit")}
    hit = ref["ring_hit"]
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(got["ring_hit"], hit)
    np.testing.assert_allclose(got["ring_t"][hit], ref["ring_t"][hit], rtol=1e-10)
    np.testing.assert_array_equal(got["ring_tri"], np.where(hit, ref["ring_tri"], -1))


@pytest.mark.parametrize("n", SIZES)
def test_psum_buckets_equals_one_all_reduce(runs, n):
    _, outs = runs
    for out in outs[n]:
        for k in "abcd":
            np.testing.assert_array_equal(out[f"psum_{k}"], out[f"psum_ref_{k}"], err_msg=k)
    # the sums themselves: rank r contributed (r + 1) * arange(5) to "a"
    np.testing.assert_array_equal(outs[n][0]["psum_a"], np.arange(5.0) * n * (n + 1) / 2)


@pytest.mark.parametrize("w,h,n", [(64, 40, 8), (27, 9, 8), (1920, 1080, 4), (16, 16, 2)])
def test_balanced_pixel_perm_matches_jax(w, h, n):
    got = sharding.balanced_pixel_perm(RenderConfig(width=w, height=h, spp=1), n)
    want = jsharding.balanced_pixel_perm(JConfig(width=w, height=h, spp=1), n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_shard_sample_coords_match_jax():
    cfg = dict(width=24, height=8, spp=4)
    gx, gy, gn, gp = sharding.shard_sample_coords(RenderConfig(**cfg), 3)
    jx, jy, jn, jp = jsharding.shard_sample_coords(JConfig(**cfg), jnp.float32, 3)
    assert gn == jn and gx.shape[0] % (3 * 4) == 0
    np.testing.assert_array_equal(gp, jp)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))


def test_initialize_raises_on_bad_explicit_rank(tmp_path):
    """An explicit configuration that cannot form a group raises; it is
    never taken for a single process."""
    with pytest.raises(ValueError, match="rank 7"):
        multihost.initialize(f"file://{tmp_path / 'store'}", world_size=2, rank=7,
                             backend="gloo")
    with pytest.raises(ValueError):
        multihost.initialize(world_size=2, rank=0)
    multihost.initialize(world_size=1)  # one process: nothing to join
    assert not torch.distributed.is_initialized() and multihost.world() == (1, 0)
    assert multihost.is_main()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_render_sharded_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node=2 -m tpu_ray_torch.cli render --sharded` on
    the CPU writes the frame one process renders alone, byte for byte."""
    args = ["render", "--scene", "sphere", "--width", "16", "--height", "16", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "tpu_ray_torch.cli", *args, "--out",
                          str(tmp_path / "one.png")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode == 0, one.stderr
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
                          "--master_addr=localhost", f"--master_port={_free_port()}",
                          "-m", "tpu_ray_torch.cli", *args, "--sharded", "--out",
                          str(tmp_path / "two.png")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert two.returncode == 0, two.stderr
    assert "x 2 processes" in two.stdout and two.stdout.count("[render] wrote") == 1
    assert (tmp_path / "two.png").read_bytes() == (tmp_path / "one.png").read_bytes()


def test_one_process_ring_renders_through_the_graphs_plan(tmp_path):
    """A process group of one (gloo, a `file://` store): a `mixed` ring
    scene (a block walks its shard, which never rotates) renders through
    render_pixels_flat_jit bit for bit as render_pixels_flat does, in 4
    blocks; the plan keys on the group itself (the default group for the
    ring's None), and multihost.destroy drops it with the group, and the
    sharded frame's plan too: no plan object that held the group survives
    the destroy (a plan's graphs hold its bound methods, a cycle that kept
    the group alive until the interpreter's exit, where gloo's teardown
    could abort the process)."""
    import gc

    import torch.distributed as dist

    from tpu_ray_torch.render import graphs, render
    from tpu_ray_torch.scene.scenes import build_scene

    scene, cfg = build_scene("mixed", device="cpu")
    cfg = cfg.replace(width=16, height=16, spp=1, max_steps=64, block_size=64)
    multihost.initialize(f"file://{tmp_path / 'store'}", world_size=1, rank=0, backend="gloo")
    try:
        group = dist.group.WORLD
        ring_scene = sharding.ring_scene(scene)
        assert ring_scene.ring is not None and ring_scene.ring.group is None
        _, fx, fy, _ = render.frame_samples(ring_scene, cfg)
        graphs.PLANS.clear()
        with torch.no_grad():
            got = graphs.render_pixels_flat_jit(ring_scene, cfg, fx, fy)
            want = render.render_pixels_flat(ring_scene, cfg, fx, fy)
        assert torch.equal(got, want)
        (key,) = graphs.PLANS
        assert graphs._names(key, lambda v: v is group)
        with torch.no_grad():
            img = sharding.render_image_sharded_jit(scene, cfg.replace(block_size=0))
            assert torch.equal(img, sharding.render_image_sharded(scene,
                                                                  cfg.replace(block_size=0)))
        gc.disable()  # only drop_plans may collect the dropped plans
        try:
            multihost.destroy()
            kept = {id(p) for p in graphs.PLANS.values()}
            alive = [o for o in gc.get_objects() if id(o) not in kept
                     and type(o) in (graphs.FramePlan, sharding._ShardedPlan)]
        finally:
            gc.enable()
        assert not dist.is_initialized() and not alive
        assert list(graphs.PLANS) == [k for k in graphs.PLANS if not graphs._names(
            k, lambda v: isinstance(v, dist.ProcessGroup))]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_bucket_sum_replays_sum_each_step_once(monkeypatch):
    """bucket_sum's graph reduces its buffers in place, so its warm-up
    must run before a step's gradients are loaded. A fake capture (the
    warm-up and the capture run the callable, a replay runs it again) and
    an all_reduce that doubles (two ranks holding the same values): two
    steps each return exactly twice their own gradients and loss, equal to
    psum_buckets' sums under the same all_reduce."""
    import torch.distributed as dist

    from tpu_ray_torch.dist import grad_allreduce
    from tpu_ray_torch.render import graphs

    monkeypatch.setattr(graphs.Graph, "captures", True)
    monkeypatch.setattr(graphs.Graph, "_warm_up", lambda self: self.fn())
    monkeypatch.setattr(graphs.Graph, "_capture", lambda self: ("graph", self.fn()))
    monkeypatch.setattr(graphs.Graph, "_launch", lambda self: self.fn())
    monkeypatch.setattr(graphs.Graph, "reset", lambda self: None)
    monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: t.mul_(2))
    monkeypatch.setattr(grad_allreduce, "world", lambda group=None: (2, 0))
    group = object()  # any static value stands for the process group in the key
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = {"a": torch.as_tensor(rng.normal(size=(5, 3)), dtype=torch.float32),
                 "b": torch.as_tensor(rng.normal(size=7), dtype=torch.float32),
                 "c": torch.as_tensor(rng.normal(), dtype=torch.float32)}
        loss = torch.as_tensor(rng.random(), dtype=torch.float32)
        got, total = grad_allreduce.bucket_sum(grads, loss, group, num_buckets=2)
        want = grad_allreduce.psum_buckets(grads, num_buckets=2)
        assert list(got) == list(grads) and torch.equal(total, 2 * loss)
        for k, g in grads.items():
            assert torch.equal(got[k], 2 * g) and torch.equal(got[k], want[k]), k
    keys = [k for k in graphs.PLANS if k[0] == "bucket_sum" and k[1] is group]
    assert len(keys) == 1
    graphs.PLANS.pop(keys[0])
