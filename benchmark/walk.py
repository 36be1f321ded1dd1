"""What the program counts of its mesh walks and of its accel builds, read
for the per-layer metrics:

  * the walks' counters (tpu_ray_torch.render.graphs.walk_counters): by
    kind, the chunks staged, Moller-Trumbore tests, box passes and box
    slots, supers visited, blocks and rays of every launch of #3 and #4
    over the whole process, the captured launches' at every replay;
  * the accel builds' counters (tpu_ray_torch.accel.packet.build_counters):
    calls, triangles, chunks, supers, bytes, host seconds, and the disk
    cache's hits and misses.

A program without them, or a run on the CPU, gives nothing to read: every
function here then returns None.
"""

from __future__ import annotations

# the kinds of #3, the streamed walk: the primary rays' closest hit and the
# shadow rays' any-hit
STREAMED = ("closest", "any_hit")


def walk_totals(trace, kinds=STREAMED):
    """{counter: n} summed over the walk kinds, over the whole run of a
    frame loop, or None (another item, no counters, or no ray walked)."""
    if trace.item != "frame":
        return None
    from tpu_ray_torch.render import graphs

    read = getattr(graphs, "walk_counters", None)
    if read is None:
        return None
    counts = read()
    total = {}
    for kind in kinds:
        for name, n in counts.get(kind, {}).items():
            total[name] = total.get(name, 0) + n
    return total if total.get("rays") else None


def build_counters(trace):
    """The accel builds' counters over the whole run, or None (a run on the
    CPU, a program without them, or no build)."""
    if trace.xs is None or trace.xs.device.type != "cuda":
        return None
    from tpu_ray_torch.accel import packet

    read = getattr(packet, "build_counters", None)
    if read is None:
        return None
    counts = dict(read())
    return counts if counts.get("builds") else None
