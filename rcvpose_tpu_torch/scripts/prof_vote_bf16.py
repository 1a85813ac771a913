"""bf16 pair arithmetic for the vote counts (K6) against f32 (K1), on the
CUDA card:

    python -m rcvpose_tpu_torch.scripts.prof_vote_bf16

The counterpart of the JAX package's ``scripts/prof_vote_bf16.py``, at its
shapes (32768 coarse voxels of grid 128, 8192 points, slack 4.2, seed 0):
d2 computed in bf16 and cast to f32 for an f32 band compare, timed against
K1 in f32. Prints both device times (CUDA events, median of repeats) and
the speed-up, the counts' relative error (mean and max), and whether bf16
changes the four best coarse cells, which are what the coarse stage ranks.
A second line does the same for the bf16 compare (lo / hi rounded to bf16
as well, the JAX kernel's ``compute_dtype=bfloat16``).
"""

from __future__ import annotations

import numpy as np
import torch

from rcvpose_tpu_torch.ops import vote_cuda
from rcvpose_tpu_torch.scripts import coarse_problem, device_ms
from rcvpose_tpu_torch.utils import resolve_device

N_POINTS = 8192
N_VOXELS = 32768
SLACK = 4.2


def count_errors(a, b):
    """(mean, max) of |a - b| / max(a, 1) over the voxels, and the number
    of the four best cells of ``a`` that are among the four best of
    ``b`` (descending counts, ties in index order)."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    rel = np.abs(a - b) / np.maximum(a, 1.0)
    top_a = set(np.argsort(-a, kind="stable")[:4].tolist())
    top_b = set(np.argsort(-b, kind="stable")[:4].tolist())
    return float(rel.mean()), float(rel.max()), len(top_a & top_b)


def main(reps=20, repeats=5, printer=print):
    """Run the comparison; returns ``{"f32_ms", "bf16_ms": {compare: ms},
    "errors": {compare: (mean, max, top-4 overlap)}, "lines"}``."""
    dev = resolve_device(None)
    args = coarse_problem(N_POINTS, N_VOXELS, SLACK, seed=0, device=dev)
    t32 = device_ms(lambda: vote_cuda.vote_counts_cuda(*args), reps, repeats)
    a = vote_cuda.vote_counts_cuda(*args).cpu()
    out = {"f32_ms": t32, "bf16_ms": {}, "errors": {}, "lines": []}
    for compare in ("f32", "bf16"):
        tbf = device_ms(
            lambda c=compare: vote_cuda.vote_counts_bf16_cuda(*args, c),
            reps, repeats)
        b = vote_cuda.vote_counts_bf16_cuda(*args, compare).cpu()
        mean, mx, overlap = count_errors(a, b)
        out["bf16_ms"][compare] = tbf
        out["errors"][compare] = (mean, mx, overlap)
        out["lines"].append(
            f"f32 {t32:.4f} ms  bf16-arith ({compare} compare) {tbf:.4f} ms  "
            f"speedup {t32 / tbf:.2f}x  count rel-err mean {mean:.4f} max "
            f"{mx:.4f}  top-4 coarse cells overlap: {overlap}/4")
        printer(out["lines"][-1])
    out["lines"].append(f"{N_VOXELS} voxels x {N_POINTS} points on "
                        f"{torch.cuda.get_device_name(dev)}")
    printer(out["lines"][-1])
    return out


if __name__ == "__main__":
    main()
