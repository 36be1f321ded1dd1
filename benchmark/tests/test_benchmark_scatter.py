"""The `render.scatter_ms.fit` reader: the device ms a block of the corner
scatter's two kernels in a fit loop's traced window; nothing in a frame
loop or where either kernel did not run (a program that leaves the
gather's backward to torch's index backward)."""

import types

import pytest

from benchmark import harness, profile
from benchmark.tests import tiny

SPEC = harness.Spec(tiny.REPO)
METRIC = "render.scatter_ms.fit"
TILE = "void (anonymous namespace)::corner_tile_kernel(trcs::Scratch, float const*)"
COMBINE = "void (anonymous namespace)::corner_combine_kernel(trcs::Scratch, float*)"
TORCH = "void at::native::indexing_backward_kernel_small_stride<float>(...)"


def _trace(item, kernels, blocks=32):
    """A traced window of `blocks` blocks holding the device events
    kernels: [(name, ns)], one after another."""
    events, at = [(profile.MARKER, False, 0, 10**9, 1)], 1_000
    for name, ns in kernels:
        events.append((name, True, at, ns, 7))
        at += ns + 100
    return types.SimpleNamespace(item=item, blocks=blocks,
                                 traced=profile.Traced(events, 1.0))


def test_the_metric_is_the_cells_and_reads_both_kernels_a_block():
    assert [m["name"] for m in SPEC.metrics("per_layer", "mixed.fit")][-1] == METRIC
    assert METRIC not in [m["name"] for m in SPEC.metrics("per_layer", "mandelbulb.fit")]
    window = [(TILE, 12_000), (COMBINE, 6_000), ("Memset (Device)", 2_000)] * 32
    window.append((TORCH, 5_000_000))
    assert SPEC.reader(METRIC)(_trace("fit", window)) == pytest.approx(0.018)


@pytest.mark.parametrize("case", ["frame_loop", "torch_s_index_backward", "no_combine"])
def test_nothing_to_read_without_the_kernels_or_in_a_frame_loop(case):
    window = {"frame_loop": [(TILE, 12_000), (COMBINE, 6_000)],
              "torch_s_index_backward": [(TORCH, 5_750_000)],
              "no_combine": [(TILE, 12_000)]}[case]
    item = "frame" if case == "frame_loop" else "fit"
    assert SPEC.reader(METRIC)(_trace(item, window)) is None
