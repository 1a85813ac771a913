"""One caller in a closed loop over the ``PoseEstimator`` of the class each
frame asks for: each frame is sent when the previous pose is on the host.
With ``classes`` in the configuration (``harness.classes``) every class's
estimator is resident in the one process, all building their CUDA graphs
in one shared ``GraphPool``; without it there is one class, and the
configuration's budget may be below some frames' objects, so those frames
escalate.

Set-up draws the frame pool, each class's keypoints, CAD cloud and nets'
weights from the seed (the weights on the device, one class at a time,
freed once its estimator holds them), builds the estimators and serves
``warmup_frames`` frames, the first of each class first, which compile and
warm every shape the window uses; then it runs as ``serve_closed`` does:
the window cycles through the pool from a seeded offset, a frame's
latency runs from the call to its pose on the host, and the traced run
serves ``trace_frames`` frames three times over with ``serve_closed``'s
spans and net hooks (over every class's nets).

``correct`` holds a seeded sample of the window's frames against the plain
reference, as ``harness.check_serve`` does, class by class: each sampled
class's reference nets are built in float32 on the device (the seeded
weights assigned over a throwaway init there), and the reference pose
packs with the class's window and budget as ``harness.classes`` gives
them, the budget doubled until it holds the frame's union mask as the
program's escalation contract states (``PoseEstimator.estimate`` never
drops a vote).

A program whose estimators cannot share a graph pool cannot serve the
classes: the run then stops at once, before any input is drawn.
"""

from __future__ import annotations

import inspect
import statistics
import time

import numpy as np
import torch

from perfbench.drivers import serve_closed
from perfbench.harness import check_serve, classes, seeds, serving, trace
from perfbench.harness import weights as weights_mod
from perfbench.reference import full_f32
from perfbench.reference import pose as ref_pose
from perfbench.reference.model import DenseFCNResNet152


def _require_shared_pool():
    from rcvpose_tpu_torch import infer

    if "graph_pool" not in inspect.signature(infer.PoseEstimator).parameters:
        raise SystemExit("perfbench: this program's PoseEstimator takes no "
                         "graph_pool, so its classes cannot share one graph "
                         "pool in one process")


def class_weights(run, c, dtype):
    """The state dicts of class ``c``'s nets (nets ``n c`` to ``n c + n -
    1`` of the seed), on the run's device."""
    conf, cfg = serving.settings(run), run.cell.config
    blocks, width = serving.net_shape(conf)
    n = cfg["nets"]
    return [weights_mod.make_net(run.seed, n * c + i, conf["kpt_heads"],
                                 cfg["head"], dtype, run.device, blocks,
                                 width) for i in range(n)]


def reference_nets(run, c, dtype, quant=None):
    """Class ``c``'s reference networks in float32 on the run's device,
    with the weights the program gets in ``dtype``, built there (the
    throwaway init runs on the device, not the host)."""
    conf = serving.settings(run)
    blocks, width = serving.net_shape(conf)
    nets = []
    for sd in class_weights(run, c, dtype):
        with torch.device(run.device):
            net = DenseFCNResNet152(conf["kpt_heads"], blocks, width, quant)
        net.load_state_dict({name: t.float() if t.is_floating_point() else t
                             for name, t in sd.items()}, assign=True)
        nets.append(net.eval())
    return nets


def class_settings(run, inp, c):
    """The serving settings with class ``c``'s window and budget."""
    return {**serving.settings(run), "pack_win_h": inp.windows[c][0],
            "pack_win_w": inp.windows[c][1], "max_points": inp.budgets[c]}


def union_budget(conf, sem, rad, depth, max_radii):
    """The budget a frame of these (K, H, W) maps runs at: ``conf``'s,
    doubled until it holds the union of the masks (at most the frame)."""
    sems = (sem > conf["sem_threshold"]) & (
        rad <= max_radii[:, None, None]) & (depth > 0)
    union, pixels = int(sems.any(dim=0).sum()), depth.numel()
    n = conf["max_points"]
    while n < min(union, pixels):
        n *= 2
    return n


def program_estimators(run, inp):
    """One ``PoseEstimator`` a class, with the seeded weights; several
    classes share one graph pool."""
    from rcvpose_tpu_torch import infer
    from rcvpose_tpu_torch.config import Config

    conf = serving.settings(run)
    shared = {}
    if len(inp.cads) > 1:
        from rcvpose_tpu_torch.models import graphs

        shared["graph_pool"] = graphs.GraphPool()
    ests = []
    for c, cad in enumerate(inp.cads):
        ws = class_weights(run, c, serving.served_dtype(conf))
        ests.append(infer.PoseEstimator(
            Config(**conf), ws if len(ws) > 1 else ws[0], inp.keypoints[c],
            inp.max_radii, cad_mm=cad, k=inp.k, device=run.device,
            **shared))
        del ws
    return ests


class ControlClass(serving.ControlEstimator):
    """``serving.ControlEstimator`` for class ``c``: its fp8 reference nets,
    keypoints, window and budget (doubled as a frame's union needs)."""

    def __init__(self, run, inp, c):
        self.conf = class_settings(run, inp, c)
        self.device = run.device
        self.models = reference_nets(run, c, serving.served_dtype(self.conf),
                                     quant="fp8")
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=run.device)
        self.k, self.max_radii = put(inp.k), put(inp.max_radii)
        self.kpts_mm = put(inp.keypoints[c][1:4] * 1000.0)
        self.cad_mm = None

    def estimate(self, image, depth):
        with torch.no_grad():
            x = serving.normalize(torch.as_tensor(image,
                                                  device=self.device))[None]
            segs, rads = zip(*[m(x) for m in self.models])
            sem = torch.cat([s[0].permute(2, 0, 1) for s in segs])
            rad = torch.cat([r[0].permute(2, 0, 1) for r in rads])
            depth = torch.as_tensor(depth, device=self.device)
            conf = {**self.conf, "max_points": union_budget(
                self.conf, sem, rad, depth, self.max_radii)}
            return ref_pose.pose_from_maps(sem, rad, depth, self.k,
                                           self.max_radii, self.kpts_mm,
                                           conf, low=True)


class ClassSample(serving.Sample):
    """``serving.Sample`` over every class's nets, filing with a frame the
    maps of its own class's nets."""

    def __init__(self, run, ests, size):
        self.per_class = len(ests[0].models)
        super().__init__(run, [m for e in ests for m in e.models], size)

    def offer(self, pool_index, result, c):
        every = self.latest
        self.latest = every[c * self.per_class:(c + 1) * self.per_class]
        try:
            super().offer(pool_index, result)
        finally:
            self.latest = every


def _frame(ests, inp, j, spans):
    c = int(inp.classes[j])
    with trace.span("perfbench.estimate", spans):
        res = ests[c].estimate(inp.images[j], inp.depths[j])
    return res, c, res["rt"].cpu()


def _warmup_order(inp, start, n):
    """``n`` pool indices counting back from ``start``, the first frame of
    each class first."""
    pool = len(inp.images)
    back = [(start + pool - 1 - i) % pool for i in range(pool)]
    firsts = [next(j for j in back if inp.classes[j] == c)
              for c in range(len(inp.cads))]
    rest = [j for j in back if j not in firsts]
    return (firsts + rest)[:n]


def run(run):
    wl = run.cell.workload
    if classes.n_classes(run.cell.config) > 1:
        _require_shared_pool()
    t = time.perf_counter()
    inp = classes.inputs(run)
    run.note("inputs_s", time.perf_counter() - t)
    t = time.perf_counter()
    ests = ([ControlClass(run, inp, c) for c in range(len(inp.cads))]
            if run.control else program_estimators(run, inp))
    run.note("estimator_build_s", time.perf_counter() - t)
    run.note("budgets", inp.budgets)
    run.note("windows", inp.windows)
    models = [m for e in ests for m in e.models]
    pool = len(inp.images)
    start = int(seeds.rng(run.seed, "offset").integers(0, pool))
    for i, j in enumerate(_warmup_order(inp, start, wl["warmup_frames"])):
        t = time.perf_counter()
        _frame(ests, inp, j, False)
        run.note(f"warmup_frame{i}_s", time.perf_counter() - t)
    sample = ClassSample(run, ests, wl["check"]["frames"])
    run.setup_done()

    lat = []
    j = start
    calls0 = sample.calls
    if run.trace:
        j = _traced(run, ests, inp, j, models, sample)
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < run.seconds:
            t = time.perf_counter()
            res, c, _ = _frame(ests, inp, j, False)
            lat.append(time.perf_counter() - t)
            sample.offer(j, res, c)
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
             (sample.calls - calls0) // sample.per_class - frames)
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    sample.close()
    items = sample.items
    del ests, models, sample
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.checks = check(run, inp, items)
    run.note("check_s", time.perf_counter() - t)
    run.note("check_frames", len(items))
    run.note("object_px_mean", float(np.mean(inp.areas)))


def _traced(run, ests, inp, j, models, sample):
    """``serve_closed``'s three passes of ``trace_frames`` frames from pool
    index ``j``, each frame served by its class; returns the next index."""
    from torch.profiler import ProfilerActivity, profile

    n, pool = run.cell.workload["trace_frames"], len(inp.images)
    cuda = run.device.type == "cuda"

    def serve(spans, counts=None):
        nonlocal j
        for _ in range(n):
            with trace.span("perfbench.frame", spans):
                res, c, _ = _frame(ests, inp, j, spans)
            if counts is not None:
                counts.append(serve_closed._vote_points(res, run))
            sample.offer(j, res, c)
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
            _frame(ests, inp, j, False)
            j = (j + 1) % pool
        handles = serve_closed._net_spans(models)
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


def check(run, inp, items):
    """[(name, value, limit)] over the sampled ``items``, as
    ``check_serve.check`` reads them, each class against its own
    reference nets, keypoints, window and budget."""
    dtype = serving.served_dtype(serving.settings(run))
    limits = run.cell.workload["check"]["limits"]
    dev = run.device
    put = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=dev)
    worst = dict.fromkeys(("centers_diff_mm", "pose_diff_mm"), 0.0)
    per_map, share, budgets = {}, [], []
    by_class = {}
    for item in items:
        by_class.setdefault(int(inp.classes[item["pool"]]), []).append(item)
    with full_f32(), torch.no_grad():
        k, max_radii = put(inp.k), put(inp.max_radii)
        for c, group in sorted(by_class.items()):
            nets = reference_nets(run, c, dtype)
            conf = class_settings(run, inp, c)
            kpts_mm = put(inp.keypoints[c][1:4] * 1000.0)
            for item in group:
                j = item["pool"]
                x = serving.normalize(torch.as_tensor(inp.images[j],
                                                      device=dev))[None]
                depth = put(inp.depths[j])
                for i, (net, maps) in enumerate(zip(nets, item["maps"])):
                    for kind, prog, ref in zip(("seg", "radial"), maps,
                                               net(x)):
                        for ch in range(prog.shape[-1]):
                            per_map.setdefault((i, kind, ch), []).append(
                                check_serve._rel_err(prog[..., ch].float(),
                                                     ref[..., ch]))
                sem = torch.cat([s[0].permute(2, 0, 1).float()
                                 for s, _ in item["maps"]])
                rad = torch.cat([r[0].permute(2, 0, 1).float()
                                 for _, r in item["maps"]])
                n = union_budget(conf, sem, rad, depth, max_radii)
                budgets.append(n)
                ref = ref_pose.pose_from_maps(sem, rad, depth, k, max_radii,
                                              kpts_mm,
                                              {**conf, "max_points": n})
                share.append(float(ref["counts"].float().mean())
                             / float(inp.areas[j]))
                worst["centers_diff_mm"] = max(worst["centers_diff_mm"], float(
                    (item["centers"].to(dev) - ref["centers"]).abs().max()))
                worst["pose_diff_mm"] = max(worst["pose_diff_mm"], float(
                    torch.linalg.vector_norm(
                        check_serve._place(item["rt"].to(dev), kpts_mm)
                        - check_serve._place(ref["rt"], kpts_mm),
                        dim=1).max()))
            del nets
    run.note("check_classes", len(by_class))
    run.note("check_budgets", budgets)
    run.note("voting_px_share", min(share) if share else None)
    every = [e for errs in per_map.values() for e in errs]
    run.note("maps_rel_err_worst_map", max(every))
    run.note("maps_rel_err_median_map", statistics.median(every))
    worst = {"maps_rel_err": max(statistics.median(errs)
                                 for errs in per_map.values()), **worst}
    return [(name, value, limits[name]) for name, value in worst.items()]
