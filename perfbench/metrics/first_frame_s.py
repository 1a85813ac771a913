"""Seconds of the process's first ``PoseEstimator.estimate`` (its first
``rcvpose.estimate`` span): cuDNN's algorithm search, lazy loading and
the kernel libraries that the first frame pays. Read from the program's
start-up record (``profiling.startup()``: spans on the host clock from
process start to the end of the first frame); None where the program
keeps none."""

import sys


def read(run):
    profiling = sys.modules.get("rcvpose_tpu_torch.profiling")
    startup = getattr(profiling, "startup", None)
    spans = [s for s in (startup() if startup else [])
             if s.name == "rcvpose.estimate"]
    if not spans:
        return None
    return (spans[0].end_ns - spans[0].start_ns) / 1e9
