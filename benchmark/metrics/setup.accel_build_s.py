"""setup.accel_build_s: the host seconds the program spent in its accel
build (the span `accel.build`: the disk cache's look-up, the native build
or the cache's load, the copy to the device), by its own counters over the
whole run; a frame loop builds only in its set-up (benchmark/walk.py)."""

from benchmark import walk


def read(trace):
    counts = walk.build_counters(trace)
    return None if counts is None else counts["seconds"]
