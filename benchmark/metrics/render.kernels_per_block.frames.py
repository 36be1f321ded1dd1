"""render.kernels_per_block.frames: device kernel launches (copies and sets
not counted) a block over the traced window of a frame loop: a frame's blocks
through the program's per-block graphs."""


def read(trace):
    if trace.item != "frame" or not trace.traced.kernels:
        return None
    return len(trace.traced.kernels) / trace.blocks
