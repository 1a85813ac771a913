"""The benchmark of ``rcvpose_tpu_torch`` on CUDA cards: one run of one
cell, one JSON object on the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1]

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``;
``--trace 1`` profiles the cell's fixed traced sub-window and reports its
per-layer metrics. Both check the timed path's outputs against the plain
reference under ``perfbench/reference/`` after the window (``correct``,
with each number beside its limit under ``checks``). ``--control 1`` puts
the reference, one precision step lower, in the program's place; it must
come out not correct.

Without a CUDA card, or with fewer than the cell asks for, the run prints
no result and exits 2. The program's kernel libraries (nvcc) and native
readers (g++) build into ``perfbench/.cache/kernels`` inside the
checkout, once.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache"


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import bench

    cell = bench.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from rcvpose_tpu_torch import utils

    utils.enable_compile_cache(CACHE / "kernels")
    run = bench.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda"),
                    t0=T0, control=bool(args.control))
    bench.drive(run)
    found = bench.forbidden_modules()
    if found:
        print(f"perfbench: the measured process loaded {found}",
              file=sys.stderr)
        return 3
    out, lines = bench.result(run, torch.cuda.get_device_name(0))
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
