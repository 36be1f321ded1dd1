"""The port's profiling tools (tpu_ray_torch/tools/profile_stages.py,
profile_bwd.py, profile_scatter.py, profile_trace_ops.py) against the JAX
package's tools/ on the CPU, at small sizes.

The JAX tools live in tools/, which is not a package: each is loaded from
its file, and its timing function (block_and_time) is patched to record
what each stage returns, so that the reference tool's own reductions are
compared; its scene is the registry's cut to 16x16x1.

Tolerances and why:
  * the block partition: equal to the samples render_image's geometry pass
    gets, block by block (the same ops on the same coordinates).
  * the stage sums: the JAX tool sums every ray's output, and some of
    those outputs are defined only by each package's own rule. The port's
    primary march culls the rays that miss every bounding sphere, which
    keep t = t_far and tmin = 0, where the reference marches them past
    t_far and records their closest approach; the port's packet walk is
    seeded with the SDF hit and reports no mesh hit behind it, where the
    reference's CPU path (the uniform grid's DDA) takes no seed. Neither
    value reaches an image. So each package's per-ray outputs are first
    held to its own tool's sums (the JAX tool's float32 sums rtol 1e-5, the
    port's exact), then compared on the rays both define: sdf hits equal
    on >= 99% of the rays (the marches may differ by a step), the sum of
    t + tmin over the rays both hit within rtol 1e-4 (XLA contracts
    multiply-adds in the march; ROADMAP Queue 3); where the mesh is the
    visible surface in the reference, the port's mesh hit equal on >= 99%
    and the triangle id equal, or another triangle whose MT distance along
    the ray ties to 1e-5 * max(t, 1) (float32 at a shared edge).
  * stage 6 (fwd+bwd): every trainable's gradient finite and nonzero.
  * profile_bwd's subsets: equal to the JAX tool's, names and paths, with
    and without its argv filter.
  * profile_scatter: the port's corner-gather and table backward against
    numpy.add.at in float64 and the JAX .at[].add, atol 1e-5 (float32 sums
    of up to ~20 terms per row, in another order).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpu_ray.render.render as jR
from tpu_ray.render.camera import generate_rays as jgenerate_rays
from tpu_ray.scene import scenes as jscenes
from tpu_ray_torch.bench import backward_config, bench_trainables
from tpu_ray_torch.render import render as R
from tpu_ray_torch.render.camera import generate_rays
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.tools import profile_bwd, profile_scatter, profile_stages, profile_trace_ops
from tpu_ray_torch.utils.metrics import rays_per_frame

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (scene, block size): one block for the first two, as their registry
# configs have; `mixed` cut to 3 blocks of 96 samples, the last padded
SMALL = {"sphere": 0, "triangles": 0, "mixed": 96}
CPU = torch.device("cpu")


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cut(cfg, name):
    return cfg.replace(width=16, height=16, spp=1, block_size=SMALL[name])


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_sums():
    """The JAX tool's march, march+mesh and geometry(all) sums of each
    SMALL scene (its later stages are not run)."""
    jtool = jax_tool("profile_stages")
    build = jtool.build_scene
    out = {}
    for name in SMALL:
        sums = []

        def record(fn, *args, warmup=1, iters=1):
            if len(sums) == 3:
                raise _Stop
            r = fn(*args)
            sums.append(float(r))
            return r, 1.0

        jtool.build_scene = lambda n, *a, **k: (lambda s, c: (s, _cut(c, n)))(*build(n, *a, **k))
        jtool.block_and_time = record
        with pytest.raises(_Stop):
            jtool.main(name)
        out[name] = sums
    return out


def _frame(name):
    scene, cfg = tscenes.build_scene(name, device="cpu")
    return profile_stages.frame_of(scene, _cut(cfg, name))


def _port_rays(fr):
    """Every block's (o, d) in the partition's order."""
    with torch.no_grad():
        return [generate_rays(fr.scene.camera, fr.xs[s:s + fr.bs], fr.ys[s:s + fr.bs],
                              fr.cfg.width, fr.cfg.height)
                for s in range(0, fr.xs.shape[0], fr.bs)]


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("group", [32, 2])
def test_partition_is_render_images(monkeypatch, name, group):
    """The tool's blocks are the rays render_image hands the geometry pass,
    block by block (Morton order, whole pixels, the last block padded with
    the last sample), in march groups of MARCH_GROUP blocks, a ragged last
    group included; the stage sums do not depend on the group size."""
    monkeypatch.setattr(R, "MARCH_GROUP", group)
    fr = _frame(name)
    seen = []
    real = R.geometry_residuals

    def record(scene, cfg, o, d, *a, **k):
        seen.append(o.clone())
        return real(scene, cfg, o, d, *a, **k)

    monkeypatch.setattr(R, "geometry_residuals", record)
    with torch.no_grad():
        R.render_image(fr.scene, fr.cfg)
    mine = [o for o, _ in _port_rays(fr)]
    assert fr.n_blocks == len(seen) == len(mine) == (3 if name == "mixed" else 1)
    assert fr.xs.shape[0] == fr.n_blocks * fr.bs and fr.bs == (96 if name == "mixed" else 256)
    for a, b in zip(seen, mine):
        assert torch.equal(a, b)
    if name == "mixed":  # padded with the last sample, in groups of 2 + 1 or 3
        assert torch.equal(fr.xs[256:], fr.xs[255].expand(32))
        assert fr.n_groups == (2 if group == 2 else 1) and fr.blocks_of(fr.n_groups - 1) == (
            1 if group == 2 else 3)
    monkeypatch.setattr(R, "geometry_residuals", real)
    sums = profile_stages.run_stage("march+mesh", fr)
    monkeypatch.setattr(R, "MARCH_GROUP", 32)
    assert {k: float(v) for k, v in sums.items()} == {
        k: float(v) for k, v in profile_stages.run_stage("march+mesh", _frame(name)).items()}


def _jax_per_ray(name, fr):
    """The JAX package's march and mesh hit on the tool's blocks (the JAX
    tool's own partition of these small frames), concatenated."""
    jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    jcfg = _cut(jcfg, name)
    method = jR.resolve_method(jscene, jcfg)

    @jax.jit
    def block(x, y):
        o, d = jgenerate_rays(jscene.camera, x, y, jcfg.width, jcfg.height)
        out = {}
        seed = None
        if jR._use_sdf(jscene, method):
            t, hit, tmin = jR._march_forward(jscene, jcfg, o, d)
            out.update(t=t, hit=hit, tmin=tmin)
            if method == "mixed":
                seed = jnp.where(hit, t, jnp.full_like(t, jcfg.t_far))
        if jR._use_mesh(jscene, method):
            out["tri"], out["mhit"] = jR._mesh_intersect(jscene, jcfg, o, d, method, t_init=seed)
        return out

    xs, ys = jnp.asarray(fr.xs.numpy()), jnp.asarray(fr.ys.numpy())
    blocks = [block(xs[s:s + fr.bs], ys[s:s + fr.bs]) for s in range(0, xs.shape[0], fr.bs)]
    return {k: np.concatenate([np.asarray(b[k]) for b in blocks]) for k in blocks[0]}, jscene


def _port_per_ray(fr):
    """The port tool's march+mesh outputs of every block, concatenated,
    with the march's hit."""
    rows, packed = R.frame_tables(fr.scene, fr.cfg, fr.method)
    with torch.no_grad():
        march = (R.march_group(fr.scene, fr.cfg, fr.xs, fr.ys, packed, fr.bs)
                 if fr.chain.use_sdf else None)
        outs = []
        for b, (o, d) in enumerate(_port_rays(fr)):
            m = None if march is None else tuple(v[b * fr.bs:(b + 1) * fr.bs] for v in march)
            outs.append(profile_stages.block_outputs("march+mesh", fr, o, d, m, packed, rows))
    got = {k: torch.cat([x[k] for x in outs]).numpy() for k in outs[0]}
    if march is not None:
        got["sdf_hit"] = march[1].numpy()
    return got


def _mt_t(verts, tris, tri, o, d):
    """Moller-Trumbore distance of each ray to its triangle, float64."""
    v0, v1, v2 = (verts[tris[tri, i]] for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d, e2)
    det = np.sum(e1 * p, -1)
    q = np.cross(o - v0, e1)
    return np.sum(e2 * q, -1) / det


@pytest.mark.parametrize("name", list(SMALL))
def test_stage_sums_match_the_jax_tool(jax_sums, name):
    fr = _frame(name)
    want, jscene = _jax_per_ray(name, fr)
    got = _port_per_ray(fr)
    j_march, j_mesh, _j_geo = jax_sums[name]
    # each package's per-ray outputs are its own tool's sums
    j_t = want["t"].sum(dtype=np.float64) + want["tmin"].sum(dtype=np.float64) if "t" in want else 0
    np.testing.assert_allclose(j_march, j_t, rtol=1e-5)
    j_m = want["tri"].sum(dtype=np.float64) + want["mhit"].sum() if "tri" in want else 0
    np.testing.assert_allclose(j_mesh, j_t + j_m, rtol=1e-5)
    for stage, keys in (("march", ("sdf_t", "sdf_tmin")),
                        ("march+mesh", ("sdf_t", "sdf_tmin", "mesh_tri", "mesh_hit"))):
        sums = profile_stages.run_stage(stage, fr)
        assert sorted(sums) == sorted(k for k in keys if k in got)
        for k, v in sums.items():
            assert float(v) == got[k].sum(dtype=np.float64), (stage, k)
    # the rays both define
    if "t" in want:
        hit = want["hit"]
        assert np.mean(hit == got["sdf_hit"]) >= 0.99
        both = hit & got["sdf_hit"]
        assert both.sum() > 0
        np.testing.assert_allclose((got["sdf_t"] + got["sdf_tmin"])[both].sum(dtype=np.float64),
                                   (want["t"] + want["tmin"])[both].sum(dtype=np.float64),
                                   rtol=1e-4)
    if "tri" in want:
        o = np.concatenate([o.numpy() for o, _ in _port_rays(fr)]).astype(np.float64)
        d = np.concatenate([d.numpy() for _, d in _port_rays(fr)]).astype(np.float64)
        verts = np.asarray(jscene.mesh.verts, np.float64)
        tris = np.asarray(jscene.mesh.tris)
        t_mesh = np.where(want["mhit"], _mt_t(verts, tris, np.maximum(want["tri"], 0), o, d),
                          np.inf)
        visible = want["mhit"] & (~want["hit"] | (t_mesh < want["t"]) if "t" in want
                                  else want["mhit"])
        assert visible.sum() > 0
        assert np.mean(got["mesh_hit"][visible]) >= 0.99
        same = visible & got["mesh_hit"]
        other = same & (got["mesh_tri"] != want["tri"])
        t_got = _mt_t(verts, tris, np.maximum(got["mesh_tri"], 0), o, d)
        assert np.all(np.abs(t_got - t_mesh)[other] <= 1e-5 * np.maximum(t_mesh[other], 1.0))
        # the port reports no mesh hit the reference does not
        assert np.mean(got["mesh_hit"] <= want["mhit"]) >= 0.99


@pytest.mark.parametrize("name", list(SMALL))
def test_stage_six_gradients_are_finite_and_nonzero(name):
    scene, cfg = tscenes.build_scene(name, device="cpu")
    fr_b = profile_stages.frame_of(scene, backward_config(_cut(cfg, name)))
    out = profile_stages.run_stage("fwd+bwd", fr_b)
    assert sorted(out) == sorted(["loss"] + [f"|d {p}|" for p in bench_trainables(scene)])
    for k, v in out.items():
        assert np.isfinite(float(v)) and float(v) > 0, k


def test_profile_report_on_cpu(monkeypatch):
    """The whole report on a 16x16 `sphere`: six stages in order, their
    increments, cumulative rates, a window of the frame's one block, and
    no device number on the CPU."""
    scene, cfg = tscenes.build_scene("sphere", device="cpu")
    lines = []
    rep = profile_stages.profile(scene, _cut(cfg, "sphere"), CPU, log=lines.append)
    assert [r["stage"] for r in rep["stages"]] == list(profile_stages.STAGES)
    assert rep["iters"] == 2 and rep["blocks"] == 1 and rep["device"] == "cpu"
    prev = 0.0
    for r in rep["stages"]:
        assert r["seconds"] > 0 and abs(r["increment"] - (r["seconds"] - prev)) < 1e-12
        assert abs(r["mrays_cumulative"] - 256 / r["seconds"] / 1e6) < 1e-9
        assert r["launches"] == {}
        w = r["window"]
        assert w["blocks"] == 1 and w["rays"] == 256 and w["group"] == 0
        assert w["device_ms"] is None and w["busy"] is None and w["host_ops"] > 0
        prev = r["seconds"]
    assert len(lines) == 7 and "on cpu" in lines[0]
    json.dumps(rep)


def test_cli_prints_one_json_line_last(monkeypatch, capsys):
    build = tscenes.build_scene
    monkeypatch.setattr(tscenes, "build_scene",
                        lambda n, *a, **k: (lambda s, c: (s, _cut(c, n)))(*build(n, *a, **k)))
    profile_stages.cli(["sphere", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["tool"] == "profile_stages" and out["scene"] == "sphere"
    assert out["resolution"] == "16x16" and len(out["stages"]) == 6


def _jax_groups(name, argv, monkeypatch):
    """The subsets the JAX tool differentiates, in order, for argv (its
    frame timings and pieces not run)."""
    jtool = jax_tool("profile_bwd")
    seen = []
    monkeypatch.setattr(jtool, "block_and_time", lambda fn, *a, **k: (None, 1.0))
    monkeypatch.setattr(jtool, "extract_params", lambda scene, paths: seen.append(paths))
    monkeypatch.setattr(jR, "resolve_method", lambda *a: (_ for _ in ()).throw(_Stop()))
    monkeypatch.setattr(sys, "argv", ["profile_bwd.py", name, *argv])
    with pytest.raises(_Stop):
        jtool.main(name)
    return seen


@pytest.mark.parametrize("name, argv", [
    ("mixed", []), ("mixed", ["verts-only", "albedo-only"]), ("sphere", []),
    ("sphere", ["verts-only", "no-verts"]), ("triangles", ["all"]), ("mandelbulb", [])])
def test_profile_bwd_subsets_equal_the_jax_tools(monkeypatch, name, argv):
    want = _jax_groups(name, argv, monkeypatch)
    scene, _ = tscenes.build_scene(name, device="cpu")
    got = profile_bwd.subsets(scene, argv)
    assert list(got.values()) == want
    assert set(got) <= set(profile_bwd.SUBSETS) and (not argv or set(got) <= set(argv))
    if name == "mixed" and not argv:
        assert list(got) == ["all", "no-verts", "verts-only", "albedo-only"]


def test_profile_bwd_report_on_cpu(monkeypatch):
    """`triangles` at 16x16: the forward, the four subsets it has (its
    mesh.verts among them), the verts-only - albedo-only increment, and the
    one-block pieces times the frame's one block."""
    scene, cfg = tscenes.build_scene("triangles", device="cpu")
    rep = profile_bwd.profile(scene, _cut(cfg, "triangles"), CPU, iters=1, log=lambda m: None)
    assert list(rep["subsets"]) == ["all", "no-verts", "verts-only", "albedo-only"]
    for r in rep["subsets"].values():
        assert r["seconds"] > 0 and r["grads_finite"] and r["launches"] == {}
    assert rep["verts_over_albedo"]["blocks"] == 1
    p = rep["pieces"]
    assert p["rays_a_block"] == 256
    for k in ("shade fwd+bwd", "shade fwd", "geometry"):
        assert p[k]["blocks"] == 1 and p[k]["ms_a_block"] > 0
    json.dumps(rep)


def test_profile_bwd_cli_takes_scene_and_subsets(monkeypatch):
    seen = []
    monkeypatch.setattr(profile_bwd, "main", lambda *a: seen.append(a))
    profile_bwd.cli(["mixed", "verts-only", "albedo-only", "--device", "cpu"])
    profile_bwd.cli([])
    assert seen == [("mixed", ["verts-only", "albedo-only"], "cpu"), ("mixed", [], "cuda")]


def _scatter_sets():
    """The index sets and cotangents of the JAX tool, drawn in its order."""
    rng = np.random.default_rng(0)
    R_, T = profile_scatter.R_BLOCK, profile_scatter.T
    local = rng.integers(0, 2000, R_) + 30_000
    uniform = rng.integers(0, T, R_)
    d = rng.standard_normal((R_, 9), np.float32)
    tris = rng.integers(0, profile_scatter.V, (T, 3))
    dt = rng.standard_normal((T, 10), np.float32)
    return local, uniform, d, tris, dt


def test_scatter_equals_numpy_and_jax():
    local, uniform, d, tris, dt = _scatter_sets()
    T = profile_scatter.T
    for idx in (local, uniform):
        rows = torch.zeros((T, 10), requires_grad=True)
        got = profile_scatter.gather_backward(rows, torch.as_tensor(idx), torch.as_tensor(d))
        want = np.zeros((T, 9))
        np.add.at(want, idx, d.astype(np.float64))
        jax_want = np.asarray(jnp.zeros((T, 9), jnp.float32).at[jnp.asarray(idx)].add(d))
        assert got.shape == (T, 10) and not got[:, 9].any()
        np.testing.assert_allclose(got[:, :9].numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, :9].numpy(), jax_want, atol=1e-5, rtol=0)
    verts = torch.zeros((profile_scatter.V, 3), requires_grad=True)
    got = profile_scatter.table_backward(verts, torch.as_tensor(tris, dtype=torch.int32),
                                         torch.as_tensor(dt))
    want = np.zeros((profile_scatter.V, 3))
    for c in range(3):
        np.add.at(want, tris[:, c], dt[:, 3 * c:3 * c + 3].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_scatter_counts_mixeds_blocks_not_its_rays():
    """1,013 blocks of 32,768 samples in the 1920x1080x16 frame, not the
    reference's 2025 (66,355,200 counted rays, shadow rays included, over
    32,768)."""
    scene, cfg = tscenes.build_scene("mixed", device="cpu")
    n = profile_scatter.frame_blocks(cfg)
    assert n == -(-cfg.num_rays // cfg.block_size) == 1013
    assert -(-rays_per_frame(cfg, scene) // cfg.block_size) == 2025
    assert profile_scatter.frame_blocks(cfg.replace(block_size=0)) == 1


def test_scatter_report_on_cpu(monkeypatch):
    """main() on the CPU with `mixed` cut to 64x32x1 in blocks of 256: the
    middle block's triangle ids, every time positive, the block count from
    the cut frame."""
    build = tscenes.build_scene
    monkeypatch.setattr(tscenes, "build_scene", lambda n, *a, **k: (
        lambda s, c: (s, c.replace(width=64, height=32, spp=1, block_size=256)))(
            *build(n, *a, **k)))
    rep = profile_scatter.main(CPU, log=lambda m: None)
    assert rep["mixed_blocks"] == 8 and rep["scatter"]["mixed_block"]["block"] == 4
    assert rep["scatter"]["mixed_block"]["rays"] == 256
    assert 0 < rep["scatter"]["mixed_block"]["hit_share"] <= 1
    assert set(rep["batched"]) == {"8", "64"}
    for v in (rep["scatter"]["local"]["ms_a_block"], rep["table_backward_ms"],
              rep["roundtrip_ms"]):
        assert np.isfinite(v) and v > 0
    json.dumps(rep)


@pytest.mark.parametrize("mode", ["fwd", "bwd"])
def test_trace_ops_report_from_a_cpu_profile(tmp_path, mode):
    scene, cfg = tscenes.build_scene("sphere", device="cpu")
    lines = []
    rep = profile_trace_ops.capture(scene, _cut(cfg, "sphere"), mode, CPU, str(tmp_path),
                                    top_n=5, log=lines.append)
    profile_trace_ops.print_report(rep, log=lines.append)
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert rep["window_blocks"] == rep["frame_blocks"] == 1 and rep["window_rays"] == 256
    assert rep["device_ms"] == 0 and rep["by_category"] == {} and rep["top_device"] == []
    assert rep["busy"] is None and rep["device"] == "cpu"
    host = rep["top_host"]
    assert len(host) == 5 and all(h["count"] > 0 for h in host)
    assert [h["self_ms"] for h in host] == sorted((h["self_ms"] for h in host), reverse=True)
    assert 0 < sum(h["self_ms"] for h in host) <= rep["host_ms"]
    assert rep["host_ops"] > 0 and any("top 5 host ops" in ln for ln in lines)
    json.dumps(rep)


def test_trace_ops_cli_defaults(monkeypatch):
    seen = []
    monkeypatch.setattr(profile_trace_ops, "main", lambda *a: seen.append(a))
    profile_trace_ops.cli(["bunny", "fwd", "12", "--trace-dir", "x", "--device", "cpu"])
    profile_trace_ops.cli([])
    assert seen == [("bunny", "fwd", 12, "x", "cpu"), ("mixed", "bwd", 40, None, "cuda")]
