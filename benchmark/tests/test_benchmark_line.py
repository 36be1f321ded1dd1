"""A run's last line, and `correct`: each drives one tiny run on the CPU in
a fresh interpreter (benchmark/tests/tiny.py), skipping only the look for
a card."""

import os
import subprocess
import sys

import pytest

from benchmark.tests import tiny

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checked"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["mixed.frames", "mixed.fit", "mandelbulb.frames",
                                      "mandelbulb.fit"])
def test_sound_run_line(root, workload):
    rc, res, err = tiny.run(root, workload)
    assert rc == 0, err
    assert set(res) == LINE_KEYS and list(res)[-1] == "checked"
    assert set(res["device"]) == DEVICE_KEYS
    assert res["correct"] is True, err
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for name, c in res["checked"].items():
        assert set(c) == {"value", "limit"}
        last = err.strip().splitlines()[-len(res["checked"]):]
        assert f"checked {name} {c['value']} limit {c['limit']}" in last


@pytest.mark.parametrize("workload", ["mixed.frames", "mixed.fit"])
def test_traced_run_line(root, workload):
    rc, res, err = tiny.run(root, workload, trace=1)
    assert rc == 0, err
    assert set(res) == LINE_KEYS | {"breakdown"} and list(res)[-1] == "checked"
    assert set(res["device"]) == DEVICE_KEYS | {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"] is True
    # on the CPU no device time exists: the device's readers find nothing
    kept = {"fit.forward_s", "fit.backward_s"} if workload.endswith("fit") else set()
    assert set(res["metrics"]) == kept


@pytest.mark.parametrize("workload,fault", [
    ("mixed.frames", "stale_frames"), ("mixed.frames", "half_samples"),
    ("mixed.frames", "altered_answer"), ("mixed.frames", "control"),
    ("mandelbulb.frames", "control"),
    ("mixed.fit", "state_unchanged"), ("mixed.fit", "half_batch_loss"), ("mixed.fit", "control"),
    ("mixed.fit", "stale_graph"), ("mandelbulb.fit", "half_batch_loss"),
    ("mandelbulb.fit", "stale_graph")])
def test_fault_reads_not_correct(root, workload, fault):
    seed = 555 if fault != "stale_frames" else 556  # 556 % 16 != 15: the poses move
    rc, res, err = tiny.run(root, workload, seed=seed, fault=fault, seconds=0.5)
    assert rc == 0, err
    assert res["correct"] is False, err


@pytest.mark.parametrize("fault", ["jax_loaded", "jax_after_window"])
def test_jax_in_the_process_stops_the_run(root, fault):
    rc, res, err = tiny.run(root, "mandelbulb.frames", fault=fault)
    assert rc != 0 and res is None
    assert "jax" in err


def test_no_card_no_result(tmp_path):
    """The command stops without a CUDA device and prints nothing on
    standard output (here: the CPU sandbox)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "mixed.fit",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=tiny.REPO, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
