"""The 95th percentile over every frame of the window of the time from
the call to the pose on the host, in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
