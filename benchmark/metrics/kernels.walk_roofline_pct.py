"""kernels.walk_roofline_pct: 100 x the least time of the traced window's
mesh walks (#3 `packet_kernel`, one launch a block for the primary rays'
closest hit and one for the shadow rays' any-hit) over their device time.
A launch's least time is the larger of its bytes over the HBM rate (each
ray's o, d, t_init in and t, tri, hit out, and the mesh's triangles read
once: nine float32 a triangle, not the program's accel) and one
Moller-Trumbore test a ray over the float32 rate."""

from benchmark import work


def read(trace):
    if trace.item != "frame":
        return None
    launches, seconds = trace.traced.kernel_time("packet_kernel")
    if not launches or seconds <= 0:
        return None
    mesh_bytes = trace.scene.n("mesh.tris") * 9 * 4
    per_launch = work.bound_s(trace.bs * work.WALK_RAY_BYTES + mesh_bytes, trace.bs * work.MT_OPS)
    return 100.0 * launches * per_launch / seconds
