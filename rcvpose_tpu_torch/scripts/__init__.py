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

The learned end-to-end proofs (the counterparts of the JAX package's
``scripts/e2e_*.py``: render a synthetic object, train the full net, save
and restore it, then serve or evaluate), each printing one JSON line last
and exiting non-zero when its accuracy gate fails:

    python -m rcvpose_tpu_torch.scripts.e2e_synthetic [--fused]
        [--fast-head] [--steps N] [--frames N]
    python -m rcvpose_tpu_torch.scripts.e2e_lmo [--steps N] [--test_frames N]
    python -m rcvpose_tpu_torch.scripts.e2e_ycb [--icp_compare] [--steps N]
        [--test_frames N]
    python -m rcvpose_tpu_torch.scripts.e2e_overflow_retry

They run on the card and raise without one; ``--device cpu`` (with
``--small`` for the small net) runs them on the CPU.

``device_ms``, ``stage_device_ms``, ``profile_ms``, ``card_line``,
``coarse_problem`` and ``hier_problem`` are shared by them, and so are the
LINEMOD-layout fixture ``make_lm_eval_tree`` and its writers
``write_ascii_ply`` and ``write_dpt``.
"""

from __future__ import annotations

import math
import os
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


def write_ascii_ply(path, pts):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def write_dpt(path, depth):
    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(np.asarray([h, w], np.uint32).tobytes())
        f.write(depth.astype(np.uint16).tobytes())


def make_lm_eval_tree(root, rng, h=120, w=160, n_frames=2):
    """Synthetic 'ape' frames in the on-disk LINEMOD layout the evaluator
    reads, drawn from ``rng`` in the order of the repo's test fixture
    (``tests/test_eval_lm_format.py``): a 2-3 cm blob CAD in meters,
    keypoints 6 cm out, a small rotation and the object at pixel ~(80, 60)
    at 0.75 m + 5 cm a frame, depth as ``.dpt``, noise images as JPEG and
    perfect radial maps (dm) from the quantized depth. Returns ``root``."""
    import torch
    from PIL import Image

    from rcvpose_tpu_torch import geometry

    k = np.asarray(geometry.LINEMOD_K)
    pv = os.path.join(root, "LINEMOD", "ape")
    orig = os.path.join(root, "LINEMOD_ORIG", "ape")
    rmap = os.path.join(root, "LINEMOD_ORIG", "estRadialMap", "ape")
    for d in ("JPEGImages", "pose", "Split"):
        os.makedirs(os.path.join(pv, d))
    os.makedirs(os.path.join(orig, "data"))
    for kp in range(1, 4):
        os.makedirs(os.path.join(rmap, f"Out_pt{kp}_dm"))

    n_model = 3000
    dirs = rng.normal(size=(n_model, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    model_m = dirs * rng.uniform(0.02, 0.03, size=(n_model, 1))
    kpts9 = np.zeros((9, 3))
    kpts9[1] = [0.06, 0.06, 0.06]
    kpts9[2] = [-0.06, 0.06, -0.06]
    kpts9[3] = [0.06, -0.06, -0.06]
    write_ascii_ply(os.path.join(pv, "ape.ply"), model_m)
    np.save(os.path.join(pv, "Outside9.npy"), kpts9)

    ids = []
    for i in range(n_frames):
        angle = rng.uniform(-0.3, 0.3)
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        z = 0.75 + 0.05 * i
        t = np.array([(80 - k[0, 2]) / k[0, 0] * z,
                      (60 - k[1, 2]) / k[1, 1] * z, z])
        np.save(os.path.join(pv, "pose", f"pose{i}.npy"),
                np.concatenate([rot, t[:, None]], axis=1))
        cam = model_m @ rot.T + t
        uv = cam @ k.T
        uv = uv[:, :2] / uv[:, 2:]
        us = np.round(uv[:, 0]).astype(int)
        vs = np.round(uv[:, 1]).astype(int)
        ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
        depth_mm = np.zeros((h, w), np.float32)
        depth_mm[vs[ok], us[ok]] = cam[ok, 2] * 1000.0
        depth_u16 = np.round(depth_mm).astype(np.uint16)
        write_dpt(os.path.join(orig, "data", f"depth{i}.dpt"), depth_u16)
        img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        frame_id = f"{i:06d}"
        Image.fromarray(img).save(
            os.path.join(pv, "JPEGImages", f"{frame_id}.jpg"))
        xyz_map, valid = geometry.backproject_dense(
            torch.as_tensor(depth_u16.astype(np.float32)),
            torch.as_tensor(k, dtype=torch.float32))
        xyz_m = xyz_map.numpy() / 1000.0
        kpts_cam = kpts9[1:4] @ rot.T + t
        for kp in range(1, 4):
            r = np.linalg.norm(xyz_m - kpts_cam[kp - 1], axis=-1) * 10.0
            np.save(os.path.join(rmap, f"Out_pt{kp}_dm", f"{frame_id}.npy"),
                    np.where(valid.numpy(), r, 0.0).astype(np.float32))
        ids.append(frame_id)
    with open(os.path.join(pv, "Split", "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return root
