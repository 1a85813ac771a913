"""Measurement entry points of the port, run on the CUDA card:

    python -m rcvpose_tpu_torch.scripts.prof_vote_tiles
    python -m rcvpose_tpu_torch.scripts.prof_vote_bf16

Both need the card and raise without one. ``device_ms`` and
``coarse_problem`` are shared by them.
"""

from __future__ import annotations

import numpy as np
import torch

# Cycles of the spin kernel queued ahead of a timed run: about 10 ms, long
# enough for the host to queue every timed launch behind it.
_SPIN_CYCLES = 20_000_000


def device_ms(fn, reps=20, repeats=5):
    """Median over ``repeats`` of the device ms of one call of ``fn``.

    Each repeat queues a spin kernel, then a start event, ``reps`` calls and
    an end event; the host enqueues the calls while the spin runs, so the
    events time the device's work back to back rather than the host's
    launch rate.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def coarse_problem(n, v, slack, seed, device):
    """The JAX package's vote-profiling problem (scripts/prof_vote_*.py):
    ``v`` coarse-cell centers of a grid-128 cube, ``n`` points uniform in
    it with radii in [10, 50) voxels, the band widened by ``slack``.
    Returns (voxels (V, 3), points (1, N, 3), lo (1, N), hi (1, N)), f32
    on ``device``; the same numbers as the JAX scripts' from the same seed.
    """
    rng = np.random.default_rng(seed)
    voxels = rng.integers(0, 32, size=(v, 3)).astype(np.float32) * 4 + 1.5
    points = rng.uniform(0, 128, size=(n, 3)).astype(np.float32)
    r = rng.uniform(10, 50, size=n).astype(np.float32)
    lo = np.maximum(r - np.float32(slack), 0.0) ** 2
    hi = (r + np.float32(slack)) ** 2

    def put(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return put(voxels), put(points[None]), put(lo[None]), put(hi[None])
