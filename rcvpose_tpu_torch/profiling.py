"""Tracing and profiling hooks (the port's counterpart of
``rcvpose_tpu.profiling``).

* ``trace(logdir)``: a ``torch.profiler`` session around a block, written
  as a Chrome/Perfetto trace file under ``logdir``.
* ``annotate(name)``: ``torch.profiler.record_function``, a labelled range
  inside an active trace.
* ``device_memory_stats()``: bytes in use, peak and limit per CUDA device.
* ``utils.StageTimers``: wall-clock stage accumulators that the
  evaluators print.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir="/tmp/rcvpose_trace"):
    """Profile the enclosed block (host ops, and the CUDA device's kernels
    when a card is present) and write ``trace_<time>_<pid>.json`` under
    ``logdir``. Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                    f"{os.getpid()}.json"))


def annotate(name):
    """Label a host-side region inside an active trace."""
    return torch.profiler.record_function(name)


def device_memory_stats():
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}} for every
    CUDA device (empty without one), from ``torch.cuda.memory_stats`` and
    the device's total memory."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
