"""render_image_jit (render/graphs.py: the frame's blocks replayed as CUDA
graphs on a card, the same replay plan without capture on the CPU)
against the port's eager render_image and the JAX package's
render_image_jit / jax.grad, the fit step through it, its plans' cache and
the launch counts a replay adds.

Tolerances and why:
  * against the port's render_image: the image bit for bit (the same ops on
    the same samples, block by block); the gradients max|a - b| / max|b| <
    1e-6, because the eager backward adds a leaf's uses in a block into the
    frame's sum one by one and the plan adds a block's sum at a time (the
    camera origin moves by ~1e-7); the fit step's loss bit for bit and its
    updated parameters within 1e-6 of the largest.
  * against the JAX package: test_torch_render.py's frame bounds (`mixed`:
    95th-percentile pixel error < 5e-3, max < 1.0, mean < 1e-3, the
    Mandelbulb is chaotic; `sphere`: max < 1e-4) and test_torch_fit.py's
    gradient bounds (smooth leaves rel < 1e-4; the Mandelbulb's scale and
    the camera origin cosine > 0.999 and rel < 5e-2).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray import fit as jfit
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray_torch import fit as tfit
from tpu_ray_torch.kernels import cuda_mt, cuda_reconstruct, cuda_scatter, cuda_sdf, cuda_shade
from tpu_ray_torch.render import graphs
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.scene import scenes as tscenes
from torch_jax_bridge import port_cfg, port_scene

torch.set_num_threads(1)
TRAINABLES = ("sdf.sph_radius", "sdf.mb_scale", "camera.origin", "materials.albedo",
              "lights.color", "mesh.verts")
# 24x24x1 in blocks of 64 samples: 9 blocks
MIXED = dict(width=24, height=24, spp=1, block_size=64, max_steps=64)


def _frame_errors(got, want):
    err = np.abs(got - want).max(-1)
    return np.quantile(err, 0.95), err.max(), np.abs(got - want).mean()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _grads(render_fn, scene, cfg, paths=TRAINABLES):
    """(loss, {path: gradient}) of mean(render_fn(...)**2)."""
    params = tfit.extract_params(scene, paths)
    loss = torch.mean(render_fn(tfit.apply_params(scene, params), cfg) ** 2)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in params.items()}


@pytest.fixture(scope="module")
def mixed():
    """The JAX `mixed` scene and its jitted 24x24 frame, the port's copy,
    its config and its eager frame."""
    jscene, jcfg = jscenes.build_scene("mixed", dtype=jnp.float32)
    jc = jcfg.replace(pallas="off", **MIXED)
    ref = np.asarray(jrender.render_image_jit(jscene, jc))
    tscene, tcfg = port_scene(jscene), port_cfg(jc)
    with torch.no_grad():
        eager = trender.render_image(tscene, tcfg)
    return jscene, jc, tscene, tcfg, ref, eager


@pytest.fixture(scope="module")
def mixed_grads(mixed):
    """At 16x16 in blocks of 64 (4 blocks): the config, jax.grad of the
    JAX package's jitted loss and the port's eager gradients."""
    jscene, jc, tscene, _, _, _ = mixed
    jc = jc.replace(width=16, height=16)
    with jax.enable_x64(False):
        jparams = jfit.extract_params(jscene, TRAINABLES)
        want = jax.jit(jax.grad(lambda pp: jnp.mean(
            jrender.render_image(jfit.apply_params(jscene, pp), jc) ** 2)))(jparams)
    cfg = port_cfg(jc)
    return cfg, {k: np.asarray(v) for k, v in want.items()}, _grads(trender.render_image,
                                                                   tscene, cfg)[1]


@pytest.mark.parametrize("group", [4, 32], ids=["short-last-group", "one-group"])
def test_mixed_frame_equals_eager_and_jax(mixed, monkeypatch, group):
    """9 blocks in march groups of 4 (4, 4 and a last group of 1, padded)
    or in one group of 9: the replayed frame is the eager frame bit for bit
    (which marches in groups of the same MARCH_GROUP) and matches the JAX
    package's jitted frame."""
    _, _, tscene, tcfg, ref, eager = mixed
    monkeypatch.setattr(trender, "MARCH_GROUP", group)
    graphs.PLANS.clear()
    with torch.no_grad():
        img = trender.render_image_jit(tscene, tcfg)
        if group != 32:
            eager = trender.render_image(tscene, tcfg)
    plan = next(iter(graphs.PLANS.values()))
    assert plan.group == min(group, 9) and plan.gx.shape[0] == plan.group * 64
    assert torch.equal(img, eager)
    p95, mx, mean = _frame_errors(img.numpy(), ref)
    assert p95 < 5e-3 and mx < 1.0 and mean < 1e-3, (p95, mx, mean)


def test_sphere_frame_is_one_replay_equal_to_eager_and_jax():
    jscene, jcfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    jcfg = jcfg.replace(width=32, height=32, pallas="off")
    ref = np.asarray(jrender.render_image_jit(jscene, jcfg))
    tscene, tcfg = port_scene(jscene), port_cfg(jcfg)
    graphs.PLANS.clear()
    with torch.no_grad():
        img = trender.render_image_jit(tscene, tcfg)
        eager = trender.render_image(tscene, tcfg)
    plan = next(iter(graphs.PLANS.values()))
    assert plan.bs == 32 * 32 and plan.group == 0  # one block, which marches itself
    assert torch.equal(img, eager)
    assert np.abs(img.numpy() - ref).max() < 1e-4


def test_mixed_gradients_equal_eager_and_jax(mixed, mixed_grads, monkeypatch):
    """The bench's six trainables through the frame's Function: its
    backward replays each block's shade inside autograd from the residuals
    its forward kept, the blocks in reverse; 4 blocks in march groups of 3
    (the last padded)."""
    cfg, want, eager = mixed_grads
    monkeypatch.setattr(trender, "MARCH_GROUP", 3)
    _, got = _grads(trender.render_image_jit, mixed[2], cfg)
    for k in TRAINABLES:
        assert _rel(got[k], eager[k]) < 1e-6, (k, _rel(got[k], eager[k]))
    for k in ("sdf.sph_radius", "materials.albedo", "lights.color", "mesh.verts"):
        rel = np.abs(got[k].numpy() - want[k]).max() / np.abs(want[k]).max()
        assert rel < 1e-4, (k, rel)
    for k in ("sdf.mb_scale", "camera.origin"):
        a, b = got[k].numpy().ravel().astype(np.float64), want[k].ravel().astype(np.float64)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        rel = np.abs(a - b).max() / np.abs(b).max()
        assert cos > 0.999 and rel < 5e-2, (k, cos, rel)


def test_new_parameter_values_are_read_every_call():
    """The stale-graph trap: a plan captured on one scene's tensors renders
    a second scene of the same structure from the second scene's values,
    and two frames rendered before one backward each differentiate with
    their own values."""
    scene, cfg = tscenes.build_scene("sphere", device="cpu")
    cfg = cfg.replace(width=16, height=16, block_size=64)  # 4 blocks, one march group
    radii = (0.9, 1.1)
    scenes = [tfit.apply_params(scene, {"sdf.sph_radius": torch.tensor([r])}) for r in radii]
    graphs.PLANS.clear()
    with torch.no_grad():
        imgs = [trender.render_image_jit(s, cfg) for s in scenes]
        assert len(graphs.PLANS) == 1
        for img, s in zip(imgs, scenes):
            assert torch.equal(img, trender.render_image(s, cfg))
    assert not torch.equal(imgs[0], imgs[1])

    def two_frames(render_fn):
        params = [tfit.extract_params(s, ("sdf.sph_radius", "materials.albedo"))
                  for s in scenes]
        a, b = (render_fn(tfit.apply_params(s, p), cfg) for s, p in zip(scenes, params))
        (torch.mean(a ** 2) - 0.5 * torch.mean(b ** 3)).backward()
        return [v.grad for p in params for v in p.values()]

    for got, want in zip(two_frames(trender.render_image_jit),
                         two_frames(trender.render_image)):
        assert _rel(got, want) < 1e-6


def test_fit_step_equals_the_eager_step(mixed):
    """make_fit_step renders through render_image_jit: two Adam steps on
    `mixed` (16x16, 2 blocks, the accel refit to the moved vertices) against
    the same steps through render_image."""
    _, _, tscene, tcfg, _, _ = mixed
    cfg = tcfg.replace(width=16, height=16, block_size=128)
    paths = ("sdf.sph_radius", "materials.albedo", "mesh.verts")
    with torch.no_grad():
        target = trender.render_image(tscene, cfg) * 0.9
    runs = []
    for jit in (True, False):
        params = tfit.extract_params(tscene, paths)
        opt = torch.optim.Adam(params.values(), lr=1e-2)
        if jit:
            step = tfit.make_fit_step(tscene, cfg, target, params, opt, refit_accel=True)
        else:
            def step():
                opt.zero_grad(set_to_none=True)
                s = tfit._maybe_refit(tfit.apply_params(tscene, params), True)
                loss = torch.mean((trender.render_image(s, cfg) - target) ** 2)
                loss.backward()
                opt.step()
                return float(loss.detach())
        runs.append(([step(), step()], {k: v.detach().clone() for k, v in params.items()}))
    (loss_j, p_j), (loss_e, p_e) = runs
    assert loss_j == loss_e
    for k in paths:
        assert _rel(p_j[k], p_e[k]) < 1e-6, k
        assert not torch.equal(p_j[k], tfit.get_param(tscene, k))


def test_plans_are_keyed_by_config_and_structure():
    """The same structure reuses its plan, new tensor values and all; a
    changed block size, config or tensor shape captures anew."""
    scene, cfg = tscenes.build_scene("sphere", device="cpu")
    cfg = cfg.replace(width=8, height=8, block_size=16)
    graphs.PLANS.clear()
    with torch.no_grad():
        trender.render_image_jit(scene, cfg)
        first = list(graphs.PLANS.values())
        moved = tfit.apply_params(scene, {"camera.origin": scene.camera.origin + 0.1})
        trender.render_image_jit(moved, cfg)
        assert list(graphs.PLANS.values()) == first
        trender.render_image_jit(scene, cfg.replace(block_size=32))
        trender.render_image_jit(scene, cfg.replace(shadow="hard"))
        two = tfit.apply_params(scene, {"sdf.sph_radius": torch.tensor([0.5, 0.4]),
                                        "sdf.sph_center": torch.zeros((2, 3)),
                                        "sdf.sph_mat": torch.zeros(2, dtype=torch.int32)})
        trender.render_image_jit(two, cfg)
    plans = list(graphs.PLANS.values())
    assert len(plans) == 4 and plans[0] is first[0]
    assert [p.bs for p in plans] == [16, 32, 16, 16]


def _reset():
    for table in graphs.LAUNCH_TABLES:
        for k in table:
            table[k] = 0


def test_a_graph_adds_its_capture_s_launches_at_each_replay(monkeypatch):
    """A fake capture on a `cuda` device: the launches the callable counts
    while it is captured are taken back (nothing ran) and added at every
    replay; the warm-up's stay counted; the callable runs at warm-up and
    capture only."""
    runs = []

    def fn():
        runs.append(1)
        cuda_sdf.LAUNCHES["march"] += 1
        cuda_shade.LAUNCHES["shade_fwd"] += 2
        cuda_reconstruct.LAUNCHES["reconstruct"] += 1
        cuda_scatter.LAUNCHES["corner_scatter"] += 1
        return torch.zeros(1)

    monkeypatch.setattr(graphs.Graph, "_capture", lambda self: ("graph", self.fn()))
    monkeypatch.setattr(graphs.Graph, "_warm_up", lambda self: self.fn())
    monkeypatch.setattr(graphs.Graph, "_launch", lambda self: None)
    _reset()
    g = graphs.Graph(fn, torch.device("cuda"), None, "block")
    for _ in range(3):
        g.replay()
    assert len(runs) == 2 and g.deltas == [{"march": 1}, {}, {"shade_fwd": 2},
                                           {"reconstruct": 1}, {"corner_scatter": 1}]
    assert cuda_sdf.LAUNCHES["march"] == 1 + 3 and cuda_shade.LAUNCHES["shade_fwd"] == 2 + 6
    assert cuda_reconstruct.LAUNCHES["reconstruct"] == 1 + 3
    assert cuda_scatter.LAUNCHES["corner_scatter"] == 1 + 3
    _reset()


def test_a_captured_frame_counts_the_eager_frame_s_launches(mixed, monkeypatch):
    """The plan of the 24x24 `mixed` frame with its graphs made to capture
    on the CPU (a fake: the capture runs the callable, a launch runs it
    again with the wrappers' counts held and rewrites the captured
    outputs), the marches and walks counting their calls: the first frame
    counts the eager frame's launches plus one warm-up of the group and of
    the block graph, the next frame exactly the eager frame's, and the
    image is the eager one."""
    _, _, tscene, tcfg, _, eager = mixed
    for module, name, key in ((cuda_sdf, "march", "march"),
                              (cuda_sdf, "shadow_hard", "shadow_hard"),
                              (cuda_mt, "intersect_packet_streamed", None)):
        def spy(*args, _real=getattr(module, name), _table=module.LAUNCHES, _key=key, **kw):
            _table[_key or ("any_hit" if kw.get("any_hit") else "closest")] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, spy)
    monkeypatch.setattr(trender, "MARCH_GROUP", 4)

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for v in (x.values() if isinstance(x, dict) else x) for t in tensors(v)]

    def launch(self):
        held = [dict(t) for t in graphs.LAUNCH_TABLES]
        for a, b in zip(tensors(self.out), tensors(self.fn())):
            a.copy_(b)
        for table, before in zip(graphs.LAUNCH_TABLES, held):
            table.update(before)

    monkeypatch.setattr(graphs.Graph, "_capture", lambda self: ("graph", self.fn()))
    monkeypatch.setattr(graphs.Graph, "_warm_up", lambda self: self.fn())
    monkeypatch.setattr(graphs.Graph, "_launch", launch)
    with torch.no_grad():
        _reset()
        trender.render_image(tscene, tcfg)
        want = {**cuda_sdf.LAUNCHES, **cuda_mt.LAUNCHES}
        assert want["march"] == 3 and want["closest"] == want["any_hit"] == 9
        graphs.PLANS.clear()
        monkeypatch.setattr(graphs.Graph, "captures", True)
        counts = []
        for _ in range(2):
            _reset()
            img = trender.render_image_jit(tscene, tcfg)
            counts.append({**cuda_sdf.LAUNCHES, **cuda_mt.LAUNCHES})
            assert torch.equal(img, eager)
    first = {k: want[k] + (1 if k in ("march", "shadow_hard", "closest", "any_hit") else 0)
             for k in want}
    assert counts == [first, want], counts
    _reset()
