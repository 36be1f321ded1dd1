"""The plain reference against the port's plain path on the CPU, at tiny
sizes of both configurations, and the reference's binned mesh tests
against every (ray, triangle) pair."""

import json

import pytest
import torch

from benchmark import scenes
from benchmark.loops import fit_gaps
from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref
from benchmark.tests import tiny


def _setup(name):
    conf = json.loads((tiny.REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    conf["render"].update(tiny.TINY_RENDER)
    for m in conf["meshes"]:
        if m["generator"] == "torus_knot":
            m["args"] = dict(tiny.TINY_KNOT)
    arrays, statics = scenes.scene_arrays(conf)
    rs = ref.Scene(scenes.tensors(arrays, "cpu"), statics["mb_iters"], statics["mb_pow8"])
    return conf, arrays, statics, rs


@pytest.mark.parametrize("name", ["mixed", "mandelbulb"])
def test_frame_matches_the_port(name):
    from tpu_ray_torch.render.render import render_image
    from tpu_ray_torch.scene.convert import scene_from_numpy
    from tpu_ray_torch.utils.config import RenderConfig

    conf, arrays, statics, rs = _setup(name)
    cfg = scenes.render_settings(conf)
    img = render_image(scene_from_numpy(arrays, statics, device="cpu"), RenderConfig(**cfg))
    want = ref.render_pixels(rs, cfg, torch.arange(cfg["width"] * cfg["height"]))
    assert float((img.reshape(-1, 3) - want).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["mixed", "mandelbulb"])
def test_fit_steps_match_the_port(name):
    from tpu_ray_torch import fit
    from tpu_ray_torch.scene.convert import scene_from_numpy
    from tpu_ray_torch.utils.config import RenderConfig

    conf, arrays, statics, rs = _setup(name)
    traffic = json.loads((tiny.REPO / "benchmark" / "traffic" / "fit.json").read_text())
    cfg = scenes.render_settings(conf, traffic["render"])
    names = [p for p in traffic["trainables"] if rs[p].numel()]
    theta0 = scenes.perturbed({p: rs[p] for p in names}, traffic["perturb_sd"], 11, "cpu")
    target = scenes.target_image(cfg, traffic["target"], 11, "cpu")
    ps = scene_from_numpy(arrays, statics, device="cpu")
    params = fit.extract_params(ps, names)
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(theta0[k])
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    step = fit.make_fit_step(ps, RenderConfig(**cfg), target, params, opt,
                             refit_accel="mesh.verts" in names)
    losses = [step()]
    grads = {k: float(opt.state[v]["exp_avg"].norm()) / 0.1 for k, v in params.items()}
    theta1 = {k: v.detach().clone() for k, v in params.items()}
    losses.append(step())
    deltas = {k: float((v.detach() - theta0[k]).norm()) for k, v in params.items()}
    want = ref_fit.fit_steps(rs, cfg, target, theta0, 1e-2, 2)
    want = {"losses": want["losses"], "grad": {k: float(v.norm()) for k, v in want["grad"].items()},
            "delta": {k: float(v.norm()) for k, v in want["delta"].items()},
            "later": [ref_fit.frame_loss(rs, cfg, target, theta1)]}
    gaps = fit_gaps({"losses": losses, "grad": grads, "delta": deltas}, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["later_loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    assert gaps["step_gap"] < 0.3
    assert gaps["grad_gap_steady"] <= gaps["grad_gap"] and gaps["step_gap_steady"] <= gaps["step_gap"]


@pytest.mark.parametrize("off, steady_read", [("geo", False), ("verts", True), ("albedo", True)])
def test_steady_leaves_leave_out_the_grazing_ones(off, steady_read):
    """A leaf whose gradient reads hundreds of times the median leaf's is
    left out of grad_gap_steady and step_gap_steady; any other leaf is in."""
    want = {"losses": [1.0, 0.9], "later": [0.9],
            "grad": {"geo": 500.0, "verts": 0.6, "albedo": 1.6, "color": 1.0},
            "delta": {"geo": 0.03, "verts": 0.2, "albedo": 0.03, "color": 0.03}}
    got = {"losses": [1.0, 0.9], "grad": dict(want["grad"]), "delta": dict(want["delta"])}
    got["grad"][off] *= 2.0
    got["delta"][off] *= 2.0
    gaps = fit_gaps(got, want)
    assert gaps["grad_gap"] >= 0.3 and gaps["step_gap"] >= 0.3
    assert (gaps["grad_gap_steady"] >= 0.3) == steady_read
    assert (gaps["step_gap_steady"] >= 0.3) == steady_read
    assert gaps["loss_gap"] == 0.0 and gaps["later_loss_gap"] == 0.0


def _brute(v0, v1, v2, o, d, t_max, any_hit):
    t, valid = ref._mt_t(o[:, None], d[:, None], v0[None], v1[None], v2[None], t_max)
    if any_hit:
        return valid.any(1)
    t = torch.where(valid, t, torch.full_like(t, ref.BIG))
    best, tri = t.min(1)
    hit = valid.any(1)
    return torch.where(hit, tri, torch.full_like(tri, -1)), hit


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_mesh_tests_equal_brute_force(any_hit):
    conf, arrays, statics, rs = _setup("mixed")
    verts, tris = rs["mesh.verts"], rs["mesh.tris"].long()
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    g = torch.Generator().manual_seed(3)
    if any_hit:  # parallel rays from points above the ground toward the light
        o = torch.rand((3000, 3), generator=g) * torch.tensor([4.0, 1.5, 3.0]) - torch.tensor(
            [3.0, 0.0, 1.5])
        d = ref.normalize(rs["lights.direction"][0]).expand_as(o).contiguous()
        got = ref.mesh_hits(verts, rs["mesh.tris"], o, d, 40.0, any_hit=True)
        assert torch.equal(got, _brute(v0, v1, v2, o, d, 40.0, True))
        assert 0 < int(got.sum()) < o.shape[0]
    else:  # primary rays from the camera
        cfg = scenes.render_settings(conf)
        xs, ys = ref.sample_xy(cfg, torch.arange(cfg["width"] * cfg["height"]), torch.float32)
        o, d = ref.generate_rays(rs, xs, ys, cfg["width"], cfg["height"])
        tri, hit = ref.mesh_hits(verts, rs["mesh.tris"], o, d, 40.0, any_hit=False, eye=o[0])
        btri, bhit = _brute(v0, v1, v2, o, d, 40.0, False)
        assert torch.equal(hit, bhit) and torch.equal(tri, btri)
        assert int((hit & (tri < tris.shape[0] - 2)).sum()) > 0  # the knot, not only the ground
