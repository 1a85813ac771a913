"""One caller in a closed loop over ``PoseEstimator.estimate``: each frame
is sent when the previous pose is on the host. With ``refine`` in the
traffic, every pose is then refined by ``PoseEstimator.refine`` (ICP
against the CAD cloud) before it is read.

Set-up draws the frame pool, the keypoints, the CAD cloud and the nets'
weights from the seed (the weights on the device), builds the estimator
and serves ``warmup_frames`` frames, which compile and warm every shape
the window uses. The window cycles through the pool from a seeded
offset. A frame's latency runs from the call to its pose (the 4 x 4
transform) on the host.

The traced run serves ``trace_frames`` frames three times over: once
unprofiled on the host clock (the rate the ``mfu`` metric reads), once
under the profiler's device activity alone (kernels, copies and the
runtime calls: the idle share and K1's time), and once under the full
profiler with spans around each frame, each ``estimate``, each
``refine`` and each net's forward (the device time launched from each
span, the syncs). After the window, a seeded sample of its frames goes
to ``harness.check_serve``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import check_serve, seeds, serving, trace


def _frame(est, inp, j, refine, spans):
    with trace.span("perfbench.estimate", spans):
        res = est.estimate(inp.images[j], inp.depths[j])
    refined = None
    if refine:
        with trace.span("perfbench.refine", spans):
            refined = est.refine(res, refine["threshold_mm"],
                                 refine["iters"])
    pose = (refined if refine else res["rt"]).cpu()
    return res, refined, pose


def _net_spans(models):
    """Forward hooks that open and close a span around each net."""
    open_ = {}
    handles = []
    for i, m in enumerate(models):
        def pre(module, args, i=i):
            open_[i] = torch.profiler.record_function("perfbench.net")
            open_[i].__enter__()

        def post(module, args, out, i=i):
            open_.pop(i).__exit__(None, None, None)

        handles += [m.register_forward_pre_hook(pre),
                    m.register_forward_hook(post)]
    return handles


def run(run):
    wl = run.cell.workload
    refine = run.cell.traffic.get("refine")
    t = time.perf_counter()
    inp = serving.inputs(run)
    run.note("inputs_s", time.perf_counter() - t)
    t = time.perf_counter()
    est = (serving.ControlEstimator(run, inp) if run.control
           else serving.program_estimator(run, inp))
    run.note("estimator_build_s", time.perf_counter() - t)
    models = list(est.models)
    pool = len(inp.images)
    start = int(seeds.rng(run.seed, "offset").integers(0, pool))
    for i in range(wl["warmup_frames"]):
        t = time.perf_counter()
        _frame(est, inp, (start + pool - 1 - i) % pool, refine, False)
        run.note(f"warmup_frame{i}_s", time.perf_counter() - t)
    sample = serving.Sample(run, models, wl["check"]["frames"])
    run.setup_done()

    lat = []
    j = start
    calls0 = sample.calls
    if run.trace:
        j = _traced(run, est, inp, j, refine, models, sample)
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < run.seconds:
            t = time.perf_counter()
            res, refined, _ = _frame(est, inp, j, refine, False)
            lat.append(time.perf_counter() - t)
            sample.offer(j, res, refined)
            j = (j + 1) % pool
        run.window = {"seconds": time.perf_counter() - t_start,
                      "latencies_s": lat, "frames": len(lat)}
        for q in (50, 99, 100):
            run.note(f"frame_p{q}_ms", float(np.percentile(lat, q)) * 1e3)
        run.note("frames_per_s_by_quarter", [
            len(part) / float(np.sum(part))
            for part in np.array_split(np.asarray(lat), 4) if len(part)])
    frames = len(lat) + run.counters.get("served", 0)
    run.attempted = frames
    run.note("escalated_frames",
             (sample.calls - calls0) // len(models) - frames)
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    sample.close()
    items = sample.items
    del est, models, sample
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.checks = check_serve.check(run, inp, items)
    run.note("check_s", time.perf_counter() - t)
    run.note("check_frames", len(items))
    run.note("object_px_mean", float(np.mean(inp.areas)))


def _traced(run, est, inp, j, refine, models, sample):
    """The traced run's three passes of ``trace_frames`` frames from pool
    index ``j`` (and two frames that let the full profiler settle before
    its window); returns the next index."""
    from torch.profiler import ProfilerActivity, profile

    n, pool = run.cell.workload["trace_frames"], len(inp.images)
    cuda = run.device.type == "cuda"

    def serve(spans, counts=None):
        nonlocal j
        for _ in range(n):
            with trace.span("perfbench.frame", spans):
                res, refined, _ = _frame(est, inp, j, refine, spans)
            if counts is not None:
                counts.append(_vote_points(res, run))
            sample.offer(j, res, refined)
            j = (j + 1) % pool

    t = time.perf_counter()
    serve(False)
    run.counters["plain_s"] = time.perf_counter() - t

    counts = []
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        serve(False, counts)
    run.device_events = trace.with_window(trace.from_profiler(prof))
    run.counters["vote_points"] = torch.stack(counts).sum(0).tolist()

    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * cuda) as prof:
        for _ in range(2):
            _frame(est, inp, j, refine, False)
            j = (j + 1) % pool
        handles = _net_spans(models)
        with trace.span(trace.WINDOW, True):
            serve(True)
            if cuda:
                torch.cuda.synchronize(run.device)
        for h in handles:
            h.remove()
    run.events = trace.from_profiler(prof)
    run.counters["frames"] = n
    run.counters["served"] = 3 * n + 2
    run.note("traced_frame_ms", {
        "plain": run.counters["plain_s"] * 1e3 / n,
        "device_only": trace.window_ns(run.device_events) / 1e6 / n,
        "full": trace.window_ns(run.events) / 1e6 / n})
    return j


def _vote_points(res, run):
    """(coarse, refine) points that vote, summed over the keypoints: the
    coarse stage takes every ``vote_cpt_stride``-th packed point."""
    mask = res["scene_mask"].reshape(res["centers"].shape[0], -1)
    stride = serving.settings(run)["vote_cpt_stride"]
    return torch.stack([mask[:, ::stride].sum(), mask.sum()])
