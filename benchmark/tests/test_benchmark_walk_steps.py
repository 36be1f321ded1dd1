"""walk.steps_per_block's reader: (tree nodes + supers visited) / blocks
of #3's two kinds, on hand-made counter snapshots with and without the
`nodes_visited` counter (a program whose walk steps every super lacks
it), and nothing on the CPU or in a fit loop."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_knot8m import WALKS, _trace

SPEC = harness.Spec(tiny.REPO)
METRIC = "walk.steps_per_block"
# the snapshot's #3 kinds with the tree's nodes counted
TREE = dict(WALKS, closest=dict(WALKS["closest"], nodes_visited=60),
            any_hit=dict(WALKS["any_hit"], nodes_visited=30))


def test_listed_for_the_walk_cells():
    for cell in ("knot8m.frames", "mixed.frames"):
        assert METRIC in {m["name"] for m in SPEC.metrics("per_layer", cell)}
    assert METRIC not in {m["name"] for m in SPEC.metrics("per_layer", "mandelbulb.frames")}


@pytest.mark.parametrize("walks, steps", [(TREE, (60 + 7 + 30 + 3) / 4_096),
                                          (WALKS, (7 + 3) / 4_096)],
                         ids=["with_nodes", "without_nodes"])
def test_reads_the_steps_a_block(monkeypatch, walks, steps):
    """#4's kind (`resident_closest`) is not #3's and is left out."""
    from tpu_ray_torch.render import graphs

    monkeypatch.setattr(graphs, "walk_counters", lambda: walks)
    assert SPEC.reader(METRIC)(_trace()) == pytest.approx(steps)
    assert SPEC.reader(METRIC)(_trace(item="fit")) is None


def test_finds_nothing_on_the_cpu_or_without_counters(monkeypatch):
    """A process that has walked nothing on a card (this one), and a
    program without the counters."""
    from tpu_ray_torch.render import graphs

    assert SPEC.reader(METRIC)(_trace(xs=torch.zeros(4))) is None
    monkeypatch.delattr(graphs, "walk_counters")
    assert SPEC.reader(METRIC)(_trace()) is None
