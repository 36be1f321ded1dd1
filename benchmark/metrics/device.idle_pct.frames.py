"""device.idle_pct.frames: 100 x (1 - the union of the device's kernel and
copy intervals / the wall time of the same traced window) of a frame loop."""


def read(trace):
    busy, wall = trace.traced.busy_s(), trace.traced.window_s
    if trace.item != "frame" or busy <= 0 or wall <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
