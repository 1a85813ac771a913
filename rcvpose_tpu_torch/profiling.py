"""Spans, counters and traces of the port (the counterpart of
``rcvpose_tpu.profiling``).

* ``span(name, **attrs)``: a labelled range at a layer boundary of the
  serving frame or of set-up. Off (no profiler recording host events and
  the start-up record closed) it is one shared no-op context after one
  cheap check. Under a ``torch.profiler`` it opens a user range named
  ``name`` (what ``record_function`` opens, at a quarter of its cost),
  whose inputs are the frame id and the attributes' values (numbers read
  back under ``record_shapes=True``), so it lands in the same trace as the
  kernels, on the same clock. A span opened with ``frame=`` (the one
  ``PoseEstimator.estimate`` opens) gives that id to every span the thread
  opens inside it.
* The start-up record: every span opened from process start until the
  first ``PoseEstimator.estimate`` of the process returns (``end_startup``)
  is kept in memory, whatever the profiler is doing, up to
  ``STARTUP_LIMIT`` spans; ``startup()`` returns it as ``SpanRecord``s.
  Times are ``time.time_ns()``, the Unix-epoch clock the profiler's events
  carry. It costs nothing once closed.
* ``count(name, n=1)`` and ``counters()``: the process's counters, under
  one lock (``frames``, ``escalations.cropped``, ``escalations.budget``,
  ``kernels.built``, ``kernels.loaded``, ``graphs.captured``,
  ``graphs.replayed``, ``graphs.eager``, ``pose.captured``,
  ``pose.replayed``, ``pose.eager``, ``icp.captured``, ``icp.replayed``,
  ``icp.eager``). With ``owner=`` the count goes
  to an attribute of that object instead: the kernel wrappers'
  ``.launches``. Inside ``held_launches()`` (a CUDA graph's capture,
  which launches nothing) a thread's ``owner=`` counts are held back, and
  ``count_launches`` adds them at each replay of the graph.
* ``trace(logdir)``: the exporter, a ``torch.profiler`` session around a
  block written as a Chrome/Perfetto trace file under ``logdir``
  (``cli --profile_dir``); the spans above appear in it.
* ``device_memory_stats()``: bytes in use, peak and limit per CUDA device.
* ``utils.StageTimers``: wall-clock stage accumulators that the
  evaluators print.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

STARTUP_LIMIT = 4096

_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_thread = threading.local()       # .frame: the open frame id; .stack;
                                  # .held: held_launches' list
_lock = threading.Lock()
_counters: dict[str, int] = {}


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int | None   # index of the enclosing span in the record
    attrs: dict


class Startup:
    """The start-up record: open from its creation until
    ``end_startup``."""

    def __init__(self):
        self.open = True
        self.spans: list[SpanRecord | None] = []

    def begin(self):
        """A slot for a span opening now, or None once full."""
        with _lock:
            if len(self.spans) >= STARTUP_LIMIT:
                return None
            self.spans.append(None)
            return len(self.spans) - 1


_startup = Startup()


def startup():
    """The start-up record's spans that have ended, in the order they
    opened."""
    return [s for s in _startup.spans if s is not None]


def end_startup():
    """Close the start-up record (``PoseEstimator.estimate`` calls it as
    each frame ends; only the first call does anything)."""
    _startup.open = False


def count(name, n=1, owner=None):
    """Add ``n`` to the counter ``name`` and return its new value; with
    ``owner``, to the attribute ``owner.<name>`` (a kernel wrapper's
    ``launches``), so that counts stay right when threads (a server's, a
    mesh's slots) count concurrently. Inside ``held_launches`` an
    ``owner`` count is held back instead (the owner's value returns)."""
    if owner is not None:
        held = getattr(_thread, "held", None)
        if held is not None:
            held.append((owner, name, int(n)))
            return getattr(owner, name)
    with _lock:
        if owner is not None:
            value = getattr(owner, name) + int(n)
            setattr(owner, name, value)
        else:
            value = _counters.get(name, 0) + int(n)
            _counters[name] = value
        return value


@contextlib.contextmanager
def held_launches():
    """Hold back the launch counts (``count`` with ``owner=``) this thread
    makes inside the block; yields them as a list of (owner, name, n)."""
    before = getattr(_thread, "held", None)
    _thread.held = []
    try:
        yield _thread.held
    finally:
        _thread.held = before


def count_launches(held):
    """Add the launch counts ``held_launches`` held back."""
    for owner, name, n in held:
        count(name, n, owner)


def counters():
    """A copy of the process's counters."""
    with _lock:
        return dict(_counters)


def span(name, **attrs):
    """A context for a span named ``name`` (see the module docstring)."""
    if not (_startup.open or _profiler_enabled()):
        return _OFF
    return _Span(name, attrs)


class _Span:
    __slots__ = ("name", "attrs", "range", "slot", "record", "start",
                 "parent", "prev_frame")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.prev_frame = getattr(_thread, "frame", None)
        frame = self.attrs.get("frame")
        if frame is None:
            frame = self.prev_frame
        else:
            _thread.frame = frame
        self.range = None
        if _profiler_enabled():
            self.range = torch.autograd._record_function_with_args_enter(
                self.name, *{"frame": frame, **self.attrs}.values())
        self.record = _startup if _startup.open else None
        if self.record is not None:
            self.slot = self.record.begin()
            stack = _thread.__dict__.setdefault("stack", [])
            self.parent = stack[-1] if stack else None
            stack.append(self.slot)
            if frame is not None:
                self.attrs = {"frame": frame, **self.attrs}
            self.start = time.time_ns()

    def __exit__(self, *exc):
        if self.record is not None:
            end = time.time_ns()
            _thread.stack.pop()
            if self.slot is not None:
                self.record.spans[self.slot] = SpanRecord(
                    self.name, self.start, end, self.parent, self.attrs)
        if self.range is not None:
            torch.autograd._record_function_with_args_exit(self.range)
        _thread.frame = self.prev_frame
        return False


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block (host ops and the program's spans, and
    the CUDA device's kernels when a card is present) and write
    ``trace_<time>_<pid>.json`` under ``logdir``. Yields ``logdir``."""
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
