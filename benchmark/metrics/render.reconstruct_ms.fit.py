"""render.reconstruct_ms.fit: the device ms a block of the program's
`reconstruct` stage (the values-only `shadow_ray_origins` of the block
graph: every kernel and copy after its marker, before the next one) over
the traced window of a fit loop (benchmark/stages.py)."""

from benchmark import stages


def read(trace):
    return stages.stage_ms_a_block(trace, "reconstruct", "fit")
