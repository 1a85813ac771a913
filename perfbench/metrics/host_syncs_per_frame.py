"""Calls that make the host wait for the card (stream, device, event or
context synchronize) inside the spans around ``PoseEstimator.estimate``,
per frame of the traced window. The benchmark's own read of the pose is
outside those spans."""

from perfbench.harness import trace


def read(run):
    spans = trace.spans(run.events, "perfbench.estimate")
    if not spans:
        return None
    return len(trace.host_calls_in(run.events, spans)) / len(spans)
