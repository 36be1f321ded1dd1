"""render.launch_ms.frames: the host ms inside the program's CUDA graph
launches (group, block and every other graph kind) over its block graph's
replays, by its own counters over the whole run of a frame loop, the
untraced window most of it (benchmark/stages.py)."""

from benchmark import stages


def read(trace):
    return stages.launch_ms_a_block(trace, "frame")
