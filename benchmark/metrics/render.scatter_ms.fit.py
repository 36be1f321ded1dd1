"""render.scatter_ms.fit: the device ms a block of the vertex gradient's
corner scatter by triangle (`csrc/corner_scatter.cu`: its kernels
`corner_tile_kernel` and `corner_combine_kernel`; the two zero fills
before them are memsets, not counted) over the traced window of a fit
loop. A program without those kernels (one that leaves the gather's
backward to torch's index backward), a frame loop, or a window in which
either did not run gives nothing to read."""

KERNELS = ("corner_tile_kernel", "corner_combine_kernel")


def read(trace):
    if trace.item != "fit" or not trace.blocks:
        return None
    timed = [trace.traced.kernel_time(k) for k in KERNELS]
    if not all(launches for launches, _ in timed):
        return None
    return 1e3 * sum(seconds for _, seconds in timed) / trace.blocks
