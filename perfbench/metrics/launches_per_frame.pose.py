"""Kernel launches the host makes a frame inside the program's
``rcvpose.pose`` spans (``_pose_from_maps``: packing, the vote and the
fit), in the full pass's window: the runtime and driver launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``) over the window's frames. A
count, not a speed: the same frames launch the same kernels, so it
repeats exactly. None where the program has no such spans."""

import re

from perfbench.harness import trace

LAUNCH = re.compile(r"^cu(da)?LaunchKernel")


def read(run):
    spans = trace.spans(run.events, "rcvpose.pose") if run.events else []
    if not spans:
        return None
    calls = trace.host_calls_in(run.events, spans, LAUNCH)
    return len(calls) / run.counters["frames"]
