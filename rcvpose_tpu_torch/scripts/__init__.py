"""Measurement entry points of the port, run on the CUDA card:

    python -m rcvpose_tpu_torch.scripts.prof_vote [--old OLD.cu]
        [--old-heads OLD.cu] [--tiles]
    python -m rcvpose_tpu_torch.scripts.prof_vote_tiles
    python -m rcvpose_tpu_torch.scripts.prof_vote_bf16
    python -m rcvpose_tpu_torch.scripts.prof_conv [--old OLD.cu]
    python -m rcvpose_tpu_torch.scripts.prof_pipes

The bench family (the counterparts of the JAX package's ``bench.py`` and
``scripts/bench_*.py``), each printing one JSON line last:

    python -m rcvpose_tpu_torch.bench [--small]        (also ``cli --mode
        benchmark``)
    python -m rcvpose_tpu_torch.scripts.bench_train [batch] [height]
        [width] [--remat] [--accum N] [--steps N]
    python -m rcvpose_tpu_torch.scripts.bench_train_loop [batch] [steps]
    python -m rcvpose_tpu_torch.scripts.bench_serving_latency [--fused]
        [--daemon HOST:PORT | --cold_class | --scaling] [--n N]
    python -m rcvpose_tpu_torch.scripts.bench_eval_prefetch [--frames N]

They run on the card and raise without one; ``--device cpu`` (with
``--small`` for the small net) runs them on the CPU.

``device_ms``, ``stage_device_ms``, ``profile_ms``, ``card_line``,
``coarse_problem`` and ``hier_problem`` are shared by them.
"""

from __future__ import annotations

import math
import subprocess
import time

import numpy as np
import torch

# Cycles of the spin kernel queued ahead of a timed run: about 25 ms, long
# enough for the host to queue every timed launch behind it (keep reps x
# the host's ~30 us a call well under it).
_SPIN_CYCLES = 50_000_000


def _event_runs(fn, reps, repeats, warmup):
    """``repeats`` runs of ``reps`` calls behind a spin kernel: (device ms
    a call of each run, whether the device ran out of queued work in any
    run: its start event had completed when the host finished queueing)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, drained = [], False
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        drained = drained or start.query()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times, drained


def device_ms(fn, reps=20, repeats=5, warmup=1):
    """Median over ``repeats`` of the device ms of one call of ``fn``.

    After ``warmup`` calls, each repeat queues a spin kernel, then a start
    event, ``reps`` calls and an end event; the host enqueues the calls
    while the spin runs, so the events time the device's work back to back
    rather than the host's launch rate.
    """
    return float(np.median(_event_runs(fn, reps, repeats, warmup)[0]))


def profile_ms(fn, reps, warmup=1):
    """Times of one call of ``fn``, from ``reps`` calls under torch.profiler.

    Returns (wall ms on the host clock, ending in a synchronize, with the
    profiler on; device ms, the summed durations of the kernels and copies
    the calls ran, without the idle gaps between them; device ms by kernel
    name). Only the device's own events are summed: a CPU op's
    ``self_device_time_total`` repeats the time of the kernels it launched,
    and a user annotation on the device's timeline (the optimizer's
    ``Optimizer.step#...`` span) covers kernels that are summed already.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    by_kernel = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.device_time_total / 1e3 / reps)
    return wall_ms, sum(by_kernel.values()), by_kernel


def stage_device_ms(fn, reps, repeats=3, warmup=1, profile_reps=4):
    """Device ms of one call of ``fn`` and the method that measured it.

    ``"events"``: ``device_ms``'s CUDA events, when the host queued every
    run's ``reps`` calls while the spin kernel still ran (the events then
    time the device's work back to back). Otherwise the device ran out of
    queued work (a call that waits on the host, or one whose launches the
    host queues slower than the device runs them, or more launches than
    the queue holds), the events would time the host, and the result is
    ``"profiler"``: the device's own kernel and copy events summed over
    ``profile_reps`` calls (``profile_ms``), its busy time without the
    idle gaps.
    """
    times, drained = _event_runs(fn, reps, repeats, warmup)
    if not drained:
        return float(np.median(times)), "events"
    return profile_ms(fn, profile_reps, warmup=0)[1], "profiler"


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


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


def hier_problem(grid_l, topk, seed=0, n_points=8192, device="cpu"):
    """The hier accumulator's two K1 stages for three keypoints voting from
    one synthetic object: ``n_points`` points on a 3-5 cm shell around a
    center 0.8 m out, about 10% of them masked, radii from three keypoints
    about 8 cm off. Returns ``{"coarse": args, "refine": args}``, each
    ``(voxels, points, lo, hi)`` for ``vote_counts_*``: the coarse stage
    votes every 8th point on the grid-``grid_l / 4`` cell centers (shared
    voxels, widened band), the refine stage every point in the 8^3 windows
    around the ``topk`` best coarse cells (per-keypoint voxels, exact
    band); the windows come from ``voting.vote_counts`` on ``device``."""
    from rcvpose_tpu_torch.ops import voting

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    center = np.array([0.05, -0.03, 0.8])
    dirs = rng.normal(size=(n_points, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cloud = center + dirs * rng.uniform(0.03, 0.05, size=(n_points, 1))
    kpts = center + rng.normal(size=(3, 3)) * 0.08
    radial = np.linalg.norm(cloud[None] - kpts[:, None], axis=-1) * 10.0
    mask = torch.tensor(rng.uniform(size=(3, n_points)) >= 0.1, device=dev)
    xyz = torch.tensor(np.broadcast_to(cloud, (3, n_points, 3)),
                       dtype=torch.float32, device=dev)
    pts, rr, _, _, _ = voting._prepare(
        xyz, torch.tensor(radial, dtype=torch.float32, device=dev), mask)
    co = voting._COARSE
    lc = grid_l // co
    coarse = (voting.enumerate_grid(lc, dev) + 0.5) * co - 0.5
    slack = voting.VOTE_BAND + math.sqrt(3.0) * co / 2.0
    lo_c, hi_c = voting.widened_band(rr, mask, slack)
    s = voting._CPT_STRIDE
    stages = {"coarse": (coarse, pts[:, ::s].contiguous(),
                         lo_c[:, ::s].contiguous(), hi_c[:, ::s].contiguous())}
    top = voting._top_indices(voting.vote_counts(*stages["coarse"]), topk)
    win = voting._WIN
    bases = torch.clamp(voting._unravel3(top, lc) * co - (win - co) // 2, 0,
                        grid_l - win)
    win_vox = (bases[:, :, None, :]
               + voting.enumerate_grid(win, dev)[None, None]).reshape(3, -1, 3)
    lo_f, hi_f = voting.exact_band(rr, mask)
    stages["refine"] = (win_vox, pts, lo_f, hi_f)
    return stages
