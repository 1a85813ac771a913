"""The readings that a cell's limits are set from, on the card, in one
process: the program's numbers over many seeds (the lower readings) and
the control's over a few (the upper readings).

    python3 perfbench/calibrate.py --workload <cell> --seeds 101-112
        --control-seeds 201-203 [--fault shifted_pose --fault-seeds 301-303]
        [--seconds 3]

One JSON line per run (seed, control, fault or neither, each number
compared), then a summary line: per number, the largest program reading
and the smallest control and fault readings. A fault is one of
``harness.faults.FAULTS``, planted in the program. The limits in
``perfbench/workloads/<cell>.json`` lie between the lower and the upper
readings, with more room above the lower.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seed_list(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seed_list, required=True)
    ap.add_argument("--control-seeds", type=seed_list, default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=seed_list, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import contextlib

    from perfbench.harness import bench, faults
    from rcvpose_tpu_torch import utils

    if not torch.cuda.is_available():
        print("perfbench: calibration needs a CUDA card", file=sys.stderr)
        return 2
    utils.enable_compile_cache(ROOT / "perfbench" / ".cache" / "kernels")
    readings = {"program": [], "control": [], "fault": []}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds),
                        ("fault", args.fault_seeds)):
        for seed in seeds:
            run = bench.Run(cell=bench.load_cell(args.workload, ROOT),
                            seed=seed, seconds=args.seconds, trace=False,
                            device=torch.device("cuda"),
                            t0=time.perf_counter(),
                            control=kind == "control")
            with (faults.FAULTS[args.fault]() if kind == "fault"
                  else contextlib.nullcontext()):
                bench.drive(run)
            nums = {n: v for n, v, _ in run.checks}
            readings[kind].append(nums)
            print(json.dumps({"seed": seed, "kind": kind, "checks": nums,
                              "notes": run.notes}, default=str), flush=True)
            del run
            torch.cuda.empty_cache()
    names = readings["program"][0] if readings["program"] else {}
    summary = {"lower": {n: max(r[n] for r in readings["program"])
                         for n in names}}
    for kind in ("control", "fault"):
        if readings[kind]:
            summary[kind] = {n: min(r[n] for r in readings[kind])
                             for n in names}
    summary["seconds"] = time.perf_counter() - T0
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
