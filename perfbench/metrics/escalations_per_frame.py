"""Re-runs of a frame through ``PoseEstimator._escalate`` (the program's
``escalations.cropped`` and ``escalations.budget`` counters) over the
frames ``estimate`` served (``frames``), over the whole process. None
where the program keeps no counters or served no frame."""

import sys


def read(run):
    profiling = sys.modules.get("rcvpose_tpu_torch.profiling")
    counters = getattr(profiling, "counters", None)
    counts = counters() if counters else {}
    if not counts.get("frames"):
        return None
    reruns = sum(v for k, v in counts.items()
                 if k.startswith("escalations."))
    return reruns / counts["frames"]
