"""fit.forward_s: the mean seconds of a fit step's forward, render_image_jit
inside the step, from the benchmark's span around it (synchronized at both
ends) over the traced run's window."""


def read(trace):
    spans = trace.spans.get("forward")
    return sum(spans) / len(spans) if spans else None
