"""walk.box_pass_pct: 100 x the (ray, staged chunk) pairs of the mesh walk
#3 whose box test passed over all such pairs (closest hit and any-hit
together): the share of a staged chunk's rays that go on to its 128
Moller-Trumbore tests, by the program's own walk counters over the whole
run of a frame loop (benchmark/walk.py)."""

from benchmark import walk


def read(trace):
    total = walk.walk_totals(trace)
    if total is None or not total.get("box_slots"):
        return None
    return 100.0 * total["box_passes"] / total["box_slots"]
