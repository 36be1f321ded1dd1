"""fit.backward_s: the mean seconds a fit step spends from the end of its
forward to Adam's step (the loss and loss.backward() through the frame's
vjp graphs), from the benchmark's span (synchronized at both ends) over the
traced run's window."""


def read(trace):
    spans = trace.spans.get("backward")
    return sum(spans) / len(spans) if spans else None
