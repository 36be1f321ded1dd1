"""render.kernels_per_block.fit: device kernel launches (copies and sets
not counted) a block over the traced window of a fit loop: a step's forward and backward blocks
through the program's per-block graphs."""


def read(trace):
    if trace.item != "fit" or not trace.traced.kernels:
        return None
    return len(trace.traced.kernels) / trace.blocks
