"""fit.vjp_backward_ms: the device ms a block of the program's
`vjp.backward` stage (the vjp graph's autograd pass: #6, the corner
scatter, the camera's chain; every kernel and copy after its marker,
before the next one) over the traced window of a fit loop
(benchmark/stages.py)."""

from benchmark import stages


def read(trace):
    return stages.stage_ms_a_block(trace, "vjp_backward", "fit")
