"""The benchmark's `knot8m` configuration (benchmark/configs/knot8m.json)
in the port, on the CPU: its arrays are the registry's `knot8m` scene (the
generators' arguments, and the scene at a small cut), a small cut renders
through `render_image_jit` as the benchmark's plain reference renders it
at seeded turntable poses, and what the port records of its accel builds
(the span `accel.build` and `packet.build_counters()`) and of its walks
(`graphs.walk_counters()`, nothing on the CPU)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import scenes
from benchmark.reference import render as ref
from tpu_ray_torch.accel import packet
from tpu_ray_torch.render import graphs
from tpu_ray_torch.render.render import render_image_jit
from tpu_ray_torch.scene import scenes as registry
from tpu_ray_torch.scene.convert import scene_from_numpy
from tpu_ray_torch.scene.mesh import ground_plane_quad, torus_knot
from tpu_ray_torch.utils.config import RenderConfig

REPO = Path(__file__).resolve().parents[1]
CONF = json.loads((REPO / "benchmark" / "configs" / "knot8m.json").read_text())
TRAFFIC = json.loads((REPO / "benchmark" / "traffic" / "frames.json").read_text())
# mixed.frames' limits (benchmark/limits/mixed.frames.json)
LIMITS = json.loads((REPO / "benchmark" / "limits" / "mixed.frames.json").read_text())
# the small cut: the knot's segments and the frame; the camera, the
# turntable and everything else as the configuration has them. Blocks of
# 1,024 samples, so that the plan replays its block graph four times a frame
SMALL_SEG = 48
SMALL_RENDER = {"width": 64, "height": 64, "block_size": 1024}


def _small_conf() -> dict:
    conf = json.loads(json.dumps(CONF))
    conf["meshes"][0]["args"].update(seg_u=SMALL_SEG, seg_v=SMALL_SEG)
    conf["render"].update(SMALL_RENDER)
    return conf


def _registry_calls(monkeypatch) -> dict:
    """Records the registry's generator calls, the knot cut to SMALL_SEG
    segments."""
    calls = {}

    def knot(p, q, seg_u, seg_v, **kw):
        calls["torus_knot"] = dict(p=p, q=q, seg_u=seg_u, seg_v=seg_v, **kw)
        return torus_knot(p, q, SMALL_SEG, SMALL_SEG, **kw)

    def quad(y, half):
        calls["ground_quad"] = dict(y=y, half=half)
        return ground_plane_quad(y, half)

    monkeypatch.setattr(registry, "torus_knot", knot)
    monkeypatch.setattr(registry, "ground_plane_quad", quad)
    return calls


def test_generator_arguments_are_the_registry_scene(monkeypatch):
    """The full configuration's generators take the arguments the registry's
    knot8m passes to its own, and its placement is the registry's."""
    calls = _registry_calls(monkeypatch)
    registry.build_scene("knot8m", device="cpu")
    knot, quad = CONF["meshes"]
    assert knot["generator"] == "torus_knot" and quad["generator"] == "ground_quad"
    assert knot["args"] == calls["torus_knot"]
    assert quad["args"] == calls["ground_quad"]
    assert not knot.get("unit") and knot.get("scale", 1.0) == 1.0
    assert knot["offset"] == [0.0, 1.12, 0.0] and (knot["mat"], quad["mat"]) == (0, 1)
    assert 2 * knot["args"]["seg_u"] * knot["args"]["seg_v"] + 2 == 8_388_610


def test_small_cut_is_the_registry_scene(monkeypatch):
    """At SMALL_SEG segments the configuration's arrays are the registry
    scene's (the mesh in float32 bit for bit), and its render settings the
    registry's config."""
    _registry_calls(monkeypatch)
    scene, cfg = registry.build_scene("knot8m", device="cpu")
    conf = _small_conf()
    conf["render"].update(width=1024, height=1024, block_size=CONF["render"]["block_size"])
    arrays, statics = scenes.scene_arrays(conf)
    assert statics["num_tris"] == scene.mesh.num_tris == 2 * SMALL_SEG * SMALL_SEG + 2
    assert torch.equal(scene.mesh.verts,
                       torch.as_tensor(arrays["mesh.verts"], dtype=torch.float32))
    assert np.array_equal(scene.mesh.tris.numpy(), arrays["mesh.tris"])
    assert np.array_equal(scene.mesh.tri_mat.numpy(), arrays["mesh.tri_mat"])
    fields = {"camera.origin": scene.camera.origin, "camera.look_at": scene.camera.look_at,
              "camera.up": scene.camera.up, "camera.vfov_deg": scene.camera.vfov_deg,
              "materials.albedo": scene.materials.albedo,
              "lights.direction": scene.lights.direction, "lights.color": scene.lights.color,
              "lights.ambient": scene.lights.ambient, "bg_top": scene.bg_top,
              "bg_bottom": scene.bg_bottom}
    for path, got in fields.items():
        assert torch.equal(got, torch.as_tensor(arrays[path], dtype=torch.float32)), path
    assert not scene.has_sdf and arrays["sdf.mb_center"].size == 0
    assert RenderConfig(**scenes.render_settings(conf)) == cfg


@pytest.mark.parametrize("pose_seed", [3_000_000_001, 2_147_483_659, 77])
def test_small_cut_through_render_image_jit_matches_the_reference(pose_seed):
    """The small cut through the port's render_image_jit at the turntable
    pose a seed picks (as the frames loop picks its first), against the
    benchmark's plain reference on every pixel, within mixed.frames'
    limits."""
    conf = _small_conf()
    arrays, statics = scenes.scene_arrays(conf)
    cfg = scenes.render_settings(conf)
    origins = scenes.turntable(arrays["camera.origin"], TRAFFIC["turntable_poses"])
    o = origins[pose_seed % TRAFFIC["turntable_poses"]]
    assert np.isclose(np.hypot(o[0], o[2]), 3.4) and o[1] == 1.9
    arrays = dict(arrays, **{"camera.origin": o})
    scene = scene_from_numpy(arrays, statics, device="cpu")
    with torch.no_grad():
        img = render_image_jit(scene, RenderConfig(**cfg))
    rs = ref.Scene(scenes.tensors(arrays, "cpu"), statics["mb_iters"], statics["mb_pow8"])
    want = ref.render_pixels(rs, cfg, torch.arange(cfg["width"] * cfg["height"]))
    gap = (img.reshape(-1, 3).double() - want.double()).abs().amax(1)
    assert float(gap.mean()) <= LIMITS["px_mean_gap"]
    assert float(gap.max()) <= LIMITS["px_max_gap"]
    # the knot and the ground are both in the frame, lit and in shadow
    assert float((img - img.reshape(-1, 3)[0]).abs().amax()) > 0.1


def test_an_accel_build_records_its_span_and_counters(tmp_path, monkeypatch):
    """build_packet_parts inside the span `accel.build`, counted: a mesh of
    CACHE_MIN_TRIS triangles misses the disk cache, then hits it; a small
    mesh is neither. Triangles, chunks, supers and bytes are the parts'."""
    monkeypatch.setenv(packet.CACHE_ENV, str(tmp_path / "cache"))
    big_v, big_f = torus_knot(2, 3, 224, 224)  # 100,352 triangles
    small_v, small_f = torus_knot(2, 3, 40, 12)
    assert big_f.shape[0] >= packet.CACHE_MIN_TRIS > small_f.shape[0]
    before = dict(packet.build_counters())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        parts = packet.build_packet_parts(big_v, big_f, device="cpu")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("accel.build") == 1
    packet.build_packet_parts(big_v, big_f, device="cpu")
    packet.build_packet_parts(small_v, small_f, device="cpu")
    after = packet.build_counters()
    got = {k: after[k] - before[k] for k in packet.BUILD_KEYS}
    assert (got["builds"], got["cache_misses"], got["cache_hits"]) == (3, 1, 1)
    assert got["triangles"] == 2 * big_f.shape[0] + small_f.shape[0]
    (a,) = parts
    chunks = -(-big_f.shape[0] // packet.CHUNK)
    supers = -(-chunks // packet.SUPER)
    assert a.super_aabb.shape[0] == supers
    assert got["supers"] == 2 * supers + 1
    assert got["chunks"] == 2 * supers * packet.SUPER + packet.SUPER
    big_bytes = packet.packet_accel_bytes(big_f.shape[0]) + 4 * a.perm.numel()
    small_bytes = packet.packet_accel_bytes(small_f.shape[0]) + 4 * -(-small_f.shape[0] // 128) * 128
    assert got["bytes"] == 2 * big_bytes + small_bytes
    assert got["seconds"] > 0.0
    with pytest.raises(TypeError):
        after["builds"] = 0  # a read-only snapshot


def test_walk_counters_are_empty_on_the_cpu():
    """The walks count only their launches on a CUDA device: a frame on the
    CPU runs their plain versions and leaves the snapshot as it was."""
    before = {k: dict(v) for k, v in graphs.walk_counters().items()}
    conf = _small_conf()
    conf["render"].update(width=16, height=16)
    arrays, statics = scenes.scene_arrays(conf)
    with torch.no_grad():
        render_image_jit(scene_from_numpy(arrays, statics, device="cpu"),
                         RenderConfig(**scenes.render_settings(conf)))
    snap = graphs.walk_counters()
    assert {k: dict(v) for k, v in snap.items()} == before == {}
    with pytest.raises(TypeError):
        snap["closest"] = {}
