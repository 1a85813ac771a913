"""The traced run's events and the arithmetic the per-layer metrics share.

A traced run keeps two profiles' events in memory: ``Run.device_events``
from the profiler's device activity alone (kernels, copies, the runtime
calls), which slows the host least, and ``Run.events`` from the full
profiler with the benchmark's spans. Each is a list of ``Event`` tuples
of four kinds: ``device`` (a kernel, copy or memset on the card), ``runtime``
(a CUDA runtime or driver call on the host), ``op`` (a PyTorch operator on
the host) and ``span`` (a ``record_function`` range the benchmark opened
around a call into the program). Times are nanoseconds on the profiler's
clock. A device event carries the runtime call's correlation id in
``corr`` and the host operator's in ``linked``; a host event carries its
own id in ``corr``.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from typing import NamedTuple

import torch

WINDOW = "perfbench.window"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
_SYNC = re.compile(r"^cu(da)?(Stream|Device|Event|Ctx)Synchronize")


class Event(NamedTuple):
    name: str
    kind: str
    start: int
    end: int
    corr: int = 0
    linked: int = 0


def span(name, on):
    """A ``record_function`` range named ``name`` when ``on``."""
    return torch.profiler.record_function(name) if on else (
        contextlib.nullcontext())


def from_profiler(prof):
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        annotation = e.is_user_annotation()
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                out.append(Event(e.name(), "device", start, end,
                                 e.correlation_id(),
                                 e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            kind = ("span" if annotation else
                    "runtime" if _RUNTIME.match(e.name()) else "op")
            out.append(Event(e.name(), kind, start, end, e.correlation_id(),
                             e.linked_correlation_id()))
    return out


def window(events):
    """(start, end) of the benchmark's window span."""
    spans = [e for e in events if e.kind == "span" and e.name == WINDOW]
    if len(spans) != 1:
        raise ValueError(f"expected one {WINDOW} span, found {len(spans)}")
    return spans[0].start, spans[0].end


def with_window(events):
    """``events`` with a window span from the first event's start to the
    last one's end: the window of a trace that had no spans."""
    if not events:
        return []
    return events + [Event(WINDOW, "span", min(e.start for e in events),
                           max(e.end for e in events))]


def in_window(events):
    lo, hi = window(events)
    return [e for e in events if e.start >= lo and e.end <= hi]


def busy_intervals(events, lo, hi):
    """Merged (start, end) intervals in which a device event ran, clipped
    to [lo, hi]."""
    iv = sorted((max(e.start, lo), min(e.end, hi)) for e in events
                if e.kind == "device" and e.end > lo and e.start < hi)
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_ns(events):
    """Nanoseconds of the window in which the device ran something."""
    lo, hi = window(events)
    return sum(t - s for s, t in busy_intervals(events, lo, hi))


def window_ns(events):
    lo, hi = window(events)
    return hi - lo


def spans(events, name):
    """The spans named ``name`` inside the window."""
    lo, hi = window(events)
    return [e for e in events if e.kind == "span" and e.name == name
            and e.start >= lo and e.end <= hi]


def _inside(ranges):
    """A test of whether a time lies inside one of the disjoint
    ``ranges``."""
    rs = sorted((r.start, r.end) for r in ranges)
    starts = [s for s, _ in rs]

    def test(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < rs[i][1]
    return test


def device_launched_in(events, ranges):
    """Device events launched from the host inside any of ``ranges``
    (disjoint events with start and end): by the runtime call's
    correlation id, or by the host operator's."""
    inside = _inside(ranges)
    runtime, ops = set(), set()
    for e in events:
        if e.kind in ("runtime", "op") and inside(e.start):
            (runtime if e.kind == "runtime" else ops).add(e.corr)
    return [e for e in events if e.kind == "device"
            and (e.corr in runtime or (e.linked and e.linked in ops))]


def total_ns(events):
    return sum(e.end - e.start for e in events)


def host_calls_in(events, ranges, pattern=_SYNC):
    """Runtime calls whose names match ``pattern`` inside ``ranges``."""
    inside = _inside(ranges)
    return [e for e in events if e.kind == "runtime" and pattern.match(e.name)
            and inside(e.start)]


def is_kernel(e):
    return e.kind == "device" and not e.name.startswith(("Memcpy", "Memset"))


def breakdown(events, top=10):
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing (the innermost host event around the
    gap's middle), each as [[name, seconds], ...]."""
    lo, hi = window(events)
    ops = {}
    for e in events:
        if e.kind == "device" and e.start >= lo and e.end <= hi:
            ops[e.name] = ops.get(e.name, 0) + (e.end - e.start)
    idle, prev = [], lo
    for s, t in busy_intervals(events, lo, hi) + [[hi, hi]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, t)
    names = innermost(events, [(a + b) // 2 for a, b in idle])
    gaps = {}
    for (a, b), name in zip(idle, names):
        gaps[name] = gaps.get(name, 0) + (b - a)

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def innermost(events, times):
    """For each of the sorted ``times``, the name of the innermost host
    event open at that time (the one opened last), in one sweep."""
    host = sorted((e for e in events if e.kind != "device"
                   and e.name != WINDOW), key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "no host event")
    return out
