"""Device milliseconds a frame of the kernels the nets' forwards launch
(the spans that forward hooks put around each net), in the traced
window; spans outside it (frames before the window) do not count."""

from perfbench.harness import trace


def read(run):
    spans = trace.spans(run.events, "perfbench.net")
    if not spans:
        return None
    dev = trace.device_launched_in(run.events, spans)
    return trace.total_ns(dev) / 1e6 / run.counters["frames"]
