"""Seconds of set-up in the program's ``rcvpose.kernels.load`` spans,
summed: each kernel library built by nvcc where the cache lacks it, and
loaded (``ops._build``). Read from the program's start-up record
(``profiling.startup()``: spans on the host clock from process start to
the end of the first frame); None where the program keeps none."""

import sys


def read(run):
    profiling = sys.modules.get("rcvpose_tpu_torch.profiling")
    startup = getattr(profiling, "startup", None)
    spans = [s for s in (startup() if startup else [])
             if s.name == "rcvpose.kernels.load"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9
