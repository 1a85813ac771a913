"""Kernel launches the host makes a frame inside the program's
``rcvpose.refine`` spans (``PoseEstimator.refine``, the ICP), in the
full pass's window: the runtime and driver launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``) over the window's frames; 0
in a cell whose frames are not refined. A count, not a speed: the same
frames launch the same kernels, so it repeats exactly. None where the
program has no spans (no ``rcvpose.estimate``)."""

import re

from perfbench.harness import trace

LAUNCH = re.compile(r"^cu(da)?LaunchKernel")


def read(run):
    if not run.events or not trace.spans(run.events, "rcvpose.estimate"):
        return None
    spans = trace.spans(run.events, "rcvpose.refine")
    calls = trace.host_calls_in(run.events, spans, LAUNCH)
    return len(calls) / run.counters["frames"]
