"""The port's bench (tpu_ray_torch/bench.py) and its metrics
(tpu_ray_torch/utils/metrics.py) against the JAX package's: the ray count
of every registry scene, the JSON line's keys, the turntable poses of the
persistent loop, and block_and_time.

Tolerances and why:
  * the ray count: exact (integer arithmetic on the configs).
  * the turntable origins: rtol 1e-6. The port computes the angles and
    their sines in float64 and rounds once to float32; the reference
    computes them in the scene's dtype.
"""

import json
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray import bench_lib
from tpu_ray.scene import scenes as jscenes
from tpu_ray.utils.metrics import rays_per_frame as jrays_per_frame
from tpu_ray_torch import bench
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.utils import metrics
from torch_jax_bridge import port_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("name", tscenes.scene_names())
def test_rays_per_frame_matches_jax(name):
    jscene, jcfg = jscenes.build_scene(name, dtype=jnp.float32)
    tscene, tcfg = tscenes.build_scene(name, device="cpu")
    assert tcfg == port_cfg(jcfg)
    want = jrays_per_frame(jcfg, jscene)
    assert metrics.rays_per_frame(tcfg, tscene) == want
    assert metrics.rays_per_frame(tcfg) == jrays_per_frame(jcfg)
    assert metrics.rays_per_frame(tcfg.replace(shadow="none"), tscene) == tcfg.num_rays


def _small(module, monkeypatch, width=16, height=16):
    """The registry's build_scene, its frame cut to width x height."""
    build = module.build_scene

    def small(name, *args, **kw):
        scene, cfg = build(name, *args, **kw)
        return scene, cfg.replace(width=width, height=height)

    monkeypatch.setattr(module, "build_scene", small)


def test_run_bench_line_on_cpu(monkeypatch):
    """`sphere` at 16x16 on the CPU: the JAX bench's keys plus the port's
    power_limit and trainables, positive finite times, a persistent
    turntable (256 rays), and no baseline."""
    import tpu_ray.scene.scenes as jscenes_module

    _small(jscenes_module, monkeypatch)
    _small(tscenes, monkeypatch)
    with jax.enable_x64(False):
        want = bench_lib.run_bench("sphere", warmup=1, iters=1)
    got = bench.run_bench("sphere", warmup=1, iters=1, device="cpu")
    assert set(got) == set(want) | {"power_limit", "trainables"}
    assert got["metric"] == want["metric"] == "Mrays_per_sec_per_chip_fwd_sphere_16x16_spp1"
    for k in ("unit", "scene", "resolution", "spp", "rays_per_frame", "chips_used",
              "persistent_loop", "backward_diff_vis"):
        assert got[k] == want[k], k
    for k in ("value", "fwd_seconds", "fwdbwd_seconds", "mrays_fwdbwd"):
        assert np.isfinite(got[k]) and got[k] > 0, k
    assert got["device"] == "cpu" and got["power_limit"] is None
    assert got["vs_baseline"] is None
    assert got["trainables"] == ["sdf.sph_radius", "camera.origin", "materials.albedo",
                                 "lights.color"]
    json.dumps(got)
    fwd = bench.run_bench("sphere", backward=False, warmup=1, iters=1, persistent=False,
                          device="cpu")
    assert not fwd["persistent_loop"] and "fwdbwd_seconds" not in fwd


def test_run_bench_without_a_card_stops(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.run_bench("sphere")


@pytest.mark.parametrize("name", ["sphere", "mixed", "mandelbulb"])
def test_turntable_origins_match_bench_lib(name):
    """The persistent loop's camera origins, as tpu_ray/bench_lib.py
    computes them (:70-76)."""
    jscene, _ = jscenes.build_scene(name, dtype=jnp.float32)
    k = bench.TURNTABLE_POSES
    with jax.enable_x64(False):
        ang = jnp.linspace(0.0, 2.0 * jnp.pi, k, endpoint=False)
        o0 = jscene.camera.origin
        r = jnp.sqrt(o0[0] ** 2 + o0[2] ** 2)
        want = np.asarray(jnp.stack([r * jnp.sin(ang), jnp.broadcast_to(o0[1], ang.shape),
                                     r * jnp.cos(ang)], -1))
    tscene, _ = tscenes.build_scene(name, device="cpu")
    got = bench.turntable_origins(tscene.camera.origin)
    assert got.dtype == torch.float32 and got.shape == (k, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if name == "sphere":  # its camera sits on the +z axis: pose 0 is its own
        assert torch.equal(got[0], tscene.camera.origin)


def test_block_and_time_returns_the_best_run():
    sleeps = iter([0.3, 0.2, 0.02, 0.15])
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(next(sleeps))
        return torch.ones(2) * x

    result, best = metrics.block_and_time(fn, 3.0, warmup=1, iters=3)
    assert len(calls) == 4 and torch.equal(result, torch.full((2,), 3.0))
    assert 0.02 <= best < 0.15


def test_metrics_logger_and_timer(tmp_path):
    path = tmp_path / "m.jsonl"
    log = metrics.MetricsLogger(path=str(path))
    log.log(step=1, loss=0.5)
    log.log(step=2, loss=0.25)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2] and all("ts" in x for x in lines)
    with metrics.Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    assert metrics.mrays_per_sec(2_000_000, 2.0) == 1.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    with metrics.profile_trace(None):
        pass
