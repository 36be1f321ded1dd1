"""walk.steps_per_block: the serial box steps of a block of the mesh walk
#3 above its chunks (the primary rays' closest hit and the shadow rays'
any-hit together): the tree nodes and the supers its blocks visited, over
its blocks, by the program's own walk counters over the whole run of a
frame loop (benchmark/walk.py). A program whose walk steps every super
counts no nodes: its supers alone."""

from benchmark import walk


def read(trace):
    total = walk.walk_totals(trace)
    if total is None or not total.get("blocks"):
        return None
    return (total.get("nodes_visited", 0) + total["supers_visited"]) / total["blocks"]
