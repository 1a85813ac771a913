"""Share of the traced window in which no operation ran on the device,
in percent, from the pass profiled for device activity alone."""

from perfbench.harness import trace


def read(run):
    if not run.device_events:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.device_events)
                    / trace.window_ns(run.device_events))
