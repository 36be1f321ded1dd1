"""walk.mt_tests_per_ray: the Moller-Trumbore tests of the mesh walk #3
(the primary rays' closest hit and the shadow rays' any-hit together) over
the rays it walked, by the program's own walk counters over the whole run
of a frame loop, the untraced window most of it (benchmark/walk.py)."""

from benchmark import walk


def read(trace):
    total = walk.walk_totals(trace)
    return None if total is None else total["mt_tests"] / total["rays"]
