"""The port's CLI commands against the JAX package's, all with --device
cpu at 16x16: `scenes`, `render --stats / --turntable / --progressive /
--profile`, `bench`, and `fit --target / --checkpoint-dir`.

Tolerances and why:
  * `--stats`: the hit rate within 1e-6 of the reference's frame_stats
    (the same rays, the same hits), the mean hit distance rtol 1e-5
    (float32 sums in another order). The march's step count is the
    kernel's: rays that miss every bounding sphere take no step, as in the
    reference's chip kernel (`march_pallas`), while its CPU path marches
    them; only the longest march is compared.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray import cli as jcli
from tpu_ray.render import render as jrender
from tpu_ray.scene import scenes as jscenes
from tpu_ray_torch import cli
from tpu_ray_torch.render import render as trender
from tpu_ray_torch.scene import scenes as tscenes
from tpu_ray_torch.scene.scenes import build_scene
from tpu_ray_torch.utils import checkpoint as ckpt_lib
from tpu_ray_torch.utils.image_io import read_png, write_png

torch.set_num_threads(1)
SMALL = ["--width", "16", "--height", "16", "--device", "cpu"]


def test_scenes_lists_the_registry(capsys):
    cli.main(["scenes", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in got] == tscenes.scene_names()
    jcli.cmd_scenes(None)
    want = {ln.split()[0]: ln for ln in capsys.readouterr().out.splitlines()}
    assert got == [want[name] for name in tscenes.scene_names()]


def _stats(out: str) -> dict:
    line, = [ln for ln in out.splitlines() if ln.startswith("[render] stats: ")]
    return json.loads(line[len("[render] stats: "):])


def test_render_stats_match_jax(tmp_path, capsys):
    cli.main(["render", "--scene", "sphere", *SMALL, "--stats", "--out",
              str(tmp_path / "s.png")])
    got = _stats(capsys.readouterr().out)
    jscene, jcfg = jscenes.build_scene("sphere", dtype=jnp.float32)
    with jax.enable_x64(False):
        want = jrender.frame_stats(jscene, jcfg.replace(width=16, height=16, pallas="off"))
    assert set(got) == set(want)
    assert got["method"] == want["method"] and got["rays_sampled"] == want["rays_sampled"]
    assert abs(got["hit_rate"] - want["hit_rate"]) <= 1e-6
    np.testing.assert_allclose(got["mean_hit_t"], want["mean_hit_t"], rtol=1e-5)
    assert got["march_steps_max"] == want["march_steps_max"]
    assert 0 < got["march_steps_mean"] <= want["march_steps_mean"]
    assert read_png(str(tmp_path / "s.png")).shape == (16, 16, 3)


def test_frame_stats_subsample_and_mixed():
    """The stride subsampling (max_rays), and a `mixed` frame: the march
    and the mesh walk both count, against the reference's frame_stats."""
    from torch_jax_bridge import port_cfg, port_scene

    jscene, jcfg = jscenes.build_scene("mixed", dtype=jnp.float32)
    with jax.enable_x64(False):
        jc = jcfg.replace(width=16, height=12, spp=4, max_steps=64, pallas="off")
        want = jrender.frame_stats(jscene, jc, max_rays=300)
    got = trender.frame_stats(port_scene(jscene), port_cfg(jc), max_rays=300)
    assert got["method"] == "mixed" and got["rays_sampled"] == want["rays_sampled"] == 384
    assert abs(got["hit_rate"] - want["hit_rate"]) <= 1e-6
    np.testing.assert_allclose(got["mean_hit_t"], want["mean_hit_t"], rtol=1e-5)


def test_render_turntable_writes_frames(tmp_path, capsys):
    cli.main(["render", "--scene", "sphere", *SMALL, "--turntable", "2", "--out",
              str(tmp_path / "t.png")])
    assert "turntable 2 frames" in capsys.readouterr().out
    a, b = (read_png(str(tmp_path / f"t_{i:03d}.png")) for i in range(2))
    assert a.shape == b.shape == (16, 16, 3)
    assert not np.array_equal(a, b)  # the second frame is half a turn on


def test_render_progressive_writes_levels_one_block_each(tmp_path, capsys, monkeypatch):
    """The previews render as one block (block_size 0), as the reference's
    do; the final frame at its own block size (--block-size 16: 16
    blocks)."""
    calls = []
    geometry = trender.geometry_residuals

    def counted(scene, cfg, o, *args, **kw):
        calls.append(o.shape[0])
        return geometry(scene, cfg, o, *args, **kw)

    monkeypatch.setattr(trender, "geometry_residuals", counted)
    cli.main(["render", "--scene", "sphere", *SMALL, "--block-size", "16",
              "--progressive", "2", "--out", str(tmp_path / "p.png")])
    assert "progressive final" in capsys.readouterr().out
    assert calls == [8 * 8, 8 * 8] + [16] * 16
    for name in ("p_prog0.png", "p_prog1.png", "p.png"):
        assert read_png(str(tmp_path / name)).shape == (16, 16, 3)


def test_render_profile_writes_a_trace(tmp_path, capsys):
    cli.main(["render", "--scene", "sphere", *SMALL, "--profile", str(tmp_path / "prof"),
              "--out", str(tmp_path / "s.png")])
    assert "profiler trace in" in capsys.readouterr().out
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]


def test_bench_prints_a_json_line(capsys, monkeypatch):
    build = tscenes.build_scene

    def small(name, *args, **kw):
        scene, cfg = build(name, *args, **kw)
        return scene, cfg.replace(width=16, height=16)

    monkeypatch.setattr(tscenes, "build_scene", small)
    cli.main(["bench", "--scene", "sphere", "--forward-only", "--device", "cpu"])
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "device", "power_limit"} <= set(data)
    assert data["vs_baseline"] is None and data["value"] > 0 and data["device"] == "cpu"


def test_fit_target_png_and_checkpoint_resume(tmp_path, capsys):
    """`fit --target` reads a PNG written by write_png (a larger sphere),
    and `--checkpoint-dir` resumes: 2 steps, then 3 from step 2."""
    scene, cfg = build_scene("sphere", device="cpu")
    cfg = cfg.replace(width=16, height=16)
    big = scene.replace(sdf=scene.sdf.replace(sph_radius=torch.tensor([1.2])))
    with torch.no_grad():
        write_png(str(tmp_path / "target.png"), trender.render_image(big, cfg).numpy())
    ck = str(tmp_path / "ck")
    base = ["fit", "--scene", "sphere", *SMALL, "--target", str(tmp_path / "target.png"),
            "--checkpoint-dir", ck, "--lr", "0.05"]
    cli.main(base + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "2 steps of sphere" in out and "[fit] final loss" in out
    assert ckpt_lib.make_manager(ck).steps() == [2]
    cli.main(base + ["--steps", "3", "--out", str(tmp_path / "f.png")])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "1 steps of sphere" in out
    assert ckpt_lib.make_manager(ck).steps() == [2, 3]
    params = {"sdf.sph_radius": torch.zeros(1, requires_grad=True)}
    ckpt_lib.restore_latest(ckpt_lib.make_manager(ck), params,
                            torch.optim.Adam(params.values()))
    assert float(params["sdf.sph_radius"].detach()) > 1.0  # grows toward the target's 1.2
    assert os.path.exists(tmp_path / "f.png")
    cli.main(base + ["--steps", "3"])
    assert "nothing to do" in capsys.readouterr().out


def test_fit_target_of_another_size_stops(tmp_path):
    write_png(str(tmp_path / "t.png"), np.zeros((8, 8, 3), np.float32))
    with pytest.raises(SystemExit, match="8x8"):
        cli.main(["fit", "--scene", "sphere", *SMALL, "--target", str(tmp_path / "t.png"),
                  "--steps", "1"])
