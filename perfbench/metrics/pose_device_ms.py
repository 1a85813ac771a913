"""Device milliseconds a frame of the kernels launched inside the
program's ``rcvpose.pose`` spans (``_pose_from_maps``: packing, the vote
and the fit), in the full pass's window. None where the program has no
such spans."""

from perfbench.harness import trace


def read(run):
    spans = trace.spans(run.events, "rcvpose.pose") if run.events else []
    if not spans:
        return None
    dev = trace.device_launched_in(run.events, spans)
    return trace.total_ns(dev) / 1e6 / run.counters["frames"]
