"""The knot8m.frames cell's new pieces: its per-layer readers (None on the
CPU and on a program without the counters; their values on a hand-made
counter snapshot and trace), and its limits file, read by a run, under
which a planted fault reads not `correct`."""

import json
import shutil
import types

import pytest
import torch

from benchmark import harness, profile, work
from benchmark.loops import Trace
from benchmark.tests import tiny

SPEC = harness.Spec(tiny.REPO)
CELL = "knot8m.frames"
READERS = ("kernels.walk_roofline_pct", "walk.mt_tests_per_ray", "walk.box_pass_pct",
           "setup.accel_build_s")
# the accepted metrics of a frame loop that the cell reports besides
ALSO = {"end_to_end": {"frame_mrays_s", "frame_s_p90", "setup_s"},
        "per_layer": {"render.kernels_per_block.frames", "device.idle_pct.frames",
                      "render.reconstruct_ms.frames", "render.launch_ms.frames",
                      "setup.capture_s"}}
ON_CARD = types.SimpleNamespace(device=torch.device("cuda", 0))  # samples on a card
BS = 65536
N_TRIS = 8_388_610
# a hand-made snapshot of the walks' counters: #3's two kinds count, #4's not
WALKS = {"closest": {"chunks_staged": 10, "mt_tests": 1_280_000, "box_passes": 10_000,
                     "box_slots": 40_000, "supers_visited": 7, "blocks": 2_048, "rays": 65_536},
         "any_hit": {"chunks_staged": 5, "mt_tests": 640_000, "box_passes": 5_000,
                     "box_slots": 20_000, "supers_visited": 3, "blocks": 2_048, "rays": 65_536},
         "resident_closest": {"chunks_staged": 1, "mt_tests": 99, "box_passes": 99,
                              "box_slots": 99, "supers_visited": 1, "blocks": 1, "rays": 32}}
BUILDS = {"builds": 1, "triangles": N_TRIS, "chunks": 65_552, "supers": 4_097,
          "bytes": 572_000_000, "seconds": 4.25, "cache_hits": 1, "cache_misses": 0}


def _trace(device_ops=(), item="frame", xs=ON_CARD):
    """A Trace of a knot8m-sized frame: (name, start ns, duration ns) device
    operations, 16 blocks of BS samples, a scene of N_TRIS triangles."""
    events = [(profile.MARKER, False, 0, 10_000_000_000, 1)]
    events += [(n, True, s, d, 0) for n, s, d in device_ops]
    scene = types.SimpleNamespace(n=lambda path: N_TRIS if path == "mesh.tris" else 1)
    return Trace(profile.Traced(events, 10.0), item, 16, BS, {}, scene, xs, xs, {})


@pytest.fixture
def program(monkeypatch):
    """The program's counter snapshots replaced by the hand-made ones."""
    from tpu_ray_torch.accel import packet
    from tpu_ray_torch.render import graphs

    monkeypatch.setattr(graphs, "walk_counters", lambda: WALKS)
    monkeypatch.setattr(packet, "build_counters", lambda: BUILDS)
    return graphs, packet


def test_every_reader_is_listed_for_the_cell():
    listed = {m["name"] for m in SPEC.metrics("per_layer", CELL)}
    assert set(READERS) | ALSO["per_layer"] <= listed
    assert ALSO["end_to_end"] == {m["name"] for m in SPEC.metrics("end_to_end", CELL)}
    walks = {"walk.mt_tests_per_ray", "walk.box_pass_pct"}
    assert walks <= {m["name"] for m in SPEC.metrics("per_layer", "mixed.frames")}


def test_counter_readers_read_the_snapshots(program):
    read = {m: SPEC.reader(m)(_trace()) for m in READERS[1:]}
    assert read["walk.mt_tests_per_ray"] == pytest.approx((1_280_000 + 640_000) / 131_072)
    assert read["walk.box_pass_pct"] == pytest.approx(100.0 * 15_000 / 60_000)
    assert read["setup.accel_build_s"] == pytest.approx(4.25)


def test_walk_roofline_reads_the_bound_over_the_walks_time():
    """Two launches of #3 (a closest hit and an any-hit) of 6 and 5 ms over
    the knot's 8.4M triangles."""
    ops = [("packet_kernel(float const*)", 1_000, 6_000_000),
           ("packet_kernel(float const*)", 7_000_000, 5_000_000),
           ("march_kernel", 13_000_000, 1_000_000)]
    per_launch = work.bound_s(BS * work.WALK_RAY_BYTES + N_TRIS * 36, BS * work.MT_OPS)
    got = SPEC.reader("kernels.walk_roofline_pct")(_trace(ops))
    assert got == pytest.approx(100.0 * 2 * per_launch / 11e-3)
    assert 1.0 < got < 2.0  # ~1.6%: 0.0909 ms a launch against ~5.5


@pytest.mark.parametrize("metric", READERS)
def test_readers_find_nothing_on_the_cpu(metric):
    """No device operation, the samples on the CPU, and a process that has
    walked nothing on a card (this one)."""
    cpu = torch.zeros(4)
    assert SPEC.reader(metric)(_trace(xs=cpu)) is None


@pytest.mark.parametrize("metric", READERS[1:])
def test_readers_find_nothing_without_the_counters(program, metric):
    graphs, packet = program
    delattr(graphs, "walk_counters")
    delattr(packet, "build_counters")
    assert SPEC.reader(metric)(_trace()) is None


@pytest.mark.parametrize("metric", READERS[1:])
def test_readers_find_nothing_in_a_fit_loop_or_with_nothing_counted(monkeypatch, metric):
    from tpu_ray_torch.accel import packet
    from tpu_ray_torch.render import graphs

    monkeypatch.setattr(graphs, "walk_counters", lambda: {})
    monkeypatch.setattr(packet, "build_counters", lambda: dict(BUILDS, builds=0))
    assert SPEC.reader(metric)(_trace()) is None
    monkeypatch.setattr(graphs, "walk_counters", lambda: WALKS)
    if metric != "setup.accel_build_s":
        assert SPEC.reader(metric)(_trace(item="fit")) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark with the cell's own limits file in place."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    shutil.copy(tiny.REPO / "benchmark" / "limits" / f"{CELL}.json",
                root / "benchmark" / "limits" / f"{CELL}.json")
    return root


def test_a_sound_run_is_judged_by_the_cells_limits(root):
    limits = json.loads((tiny.REPO / "benchmark" / "limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"px_mean_gap", "px_max_gap"}
    rc, res, err = tiny.run(root, CELL, seed=2_158_483_692, trace=1)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert {k: c["limit"] for k, c in res["checked"].items()} == limits
    assert res["metrics"] == {}  # on the CPU every reader finds nothing


@pytest.mark.parametrize("fault", ["altered_answer", "stale_frames"])
def test_a_planted_fault_reads_not_correct(root, fault):
    rc, res, err = tiny.run(root, CELL, seed=3_300_000_011, fault=fault, seconds=0.5)
    assert rc == 0, err
    assert res["correct"] is False, err
