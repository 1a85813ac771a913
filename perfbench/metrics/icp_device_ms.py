"""Device milliseconds a frame of the kernels launched inside the spans
around ``PoseEstimator.refine`` (the ICP), in the traced window."""

from perfbench.harness import trace


def read(run):
    spans = trace.spans(run.events, "perfbench.refine")
    if not spans:
        return None
    dev = trace.device_launched_in(run.events, spans)
    return trace.total_ns(dev) / 1e6 / len(spans)
