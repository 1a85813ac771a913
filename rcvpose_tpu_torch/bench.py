"""The port's benchmark of the RGB-D pose path; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.bench [--small] [--device cpu]
    python -m rcvpose_tpu_torch.cli --mode benchmark

The counterpart of the JAX package's ``bench.py``, at its configuration:
DenseFCNResNet152 forwards (480x640, bf16) + hier radial voting (grid
``suggest_grid_l(0.102, 2.0)`` = 128, 8192 points, K1) + Horn fit, per
frame, in 3-net mode (three seeded nets), batched (B=4), fused
(``kpt_heads=3``, one net) and fused + batched; then the stages alone: one
net forward, one keypoint's vote (hier, and exact at 8192 x 128^3 pairs)
and the fit. It runs on the CUDA card; ``device="cpu"`` takes
``bench.py``'s CPU branch (f32, grid 64, 1024 points, 96x128, B=2,
shorter runs, no exact mode), and ``--small`` the small net of the repo's
scripts (width 0.125, blocks 1,1,1,1).

Every time is the user's view: ``reps`` back-to-back calls on the host
clock with one synchronize at the end, dispatch included, each call fed by
the previous one's result (``bench.py``'s data dependence), best of 3 runs
(``runs_ms`` holds each run's ms a frame or a call). On the card
``device_ms`` adds the device's own time of one call of ``frame_ms``,
``net_ms``, ``vote_ms_per_kpt`` and ``fit_ms`` with the method that took
it (``scripts.stage_device_ms``): CUDA events behind a spin kernel where
the host queued every call before the spin ended, else the profiler's
device events summed (the device's busy time). ``infer._frame_pose`` /
``_pose_from_maps`` read nothing back (no ``.item()``, ``.tolist()`` or
``nonzero``), but each vote waits on the host all the same:
``voting._prepare`` puts a scalar on the card with ``torch.tensor``, a
blocking copy that synchronizes the stream. So the vote stage and the
frame take the profiler, and so does a call that queues more launches
than the launch queue holds (a net forward). ``device`` names the card
(``nvidia-smi``'s name and power limit) or "cpu".

``frame_pose_batch`` and ``frame_pose_fused_batch`` are loops over frames
in the port, measured as they are.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from rcvpose_tpu_torch import eval as eval_mod
from rcvpose_tpu_torch import fit, geometry, infer
from rcvpose_tpu_torch import train as train_mod
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models.fcnresnet import init_params
from rcvpose_tpu_torch.ops import voting
from rcvpose_tpu_torch.utils import resolve_device, synchronize

# Calls a timed run makes, on the card and on the CPU (bench.py's).
CARD_REPS = {"frame": 100, "batched": 25, "net": 128, "vote": 256,
             "exact": 16, "fit": 1024}
CPU_REPS = {"frame": 10, "batched": 5, "net": 8, "vote": 16, "fit": 64}
RUNS = 3
# Calls a device timing queues behind the spin kernel (a Horn fit is
# about 130 launches: 4 of them fit the launch queue).
DEVICE_REPS = 4
SMALL_NET = {"model_width": 0.125, "model_blocks": "1,1,1,1"}


def bench_config(device, small=False):
    """``bench.py``'s ``Config``, (H, W) and batch for ``device``."""
    card = torch.device(device).type == "cuda"
    cfg = Config(compute_dtype="bfloat16" if card else "float32",
                 vote_grid_l=voting.suggest_grid_l(0.102, 2.0) if card
                 else 64,
                 max_points=8192 if card else 1024, vote_mode="hier",
                 **(SMALL_NET if small else {}))
    hw = (480, 640) if card else (96, 128)
    return cfg, hw, 4 if card else 2


def bench_inputs(h, w, device):
    """``bench.py``'s inputs, drawn from ``default_rng(0)`` in its order:
    image (H, W, 3) f32, depth (H, W) mm in the middle third, max radii
    (3,) dm, model-frame keypoints (3, 3) mm."""
    rng = np.random.default_rng(0)
    image = rng.normal(size=(h, w, 3)).astype(np.float32)
    depth = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[h // 3:2 * h // 3, w // 3:2 * w // 3]
    depth[ys, xs] = rng.uniform(600, 900, size=ys.shape)
    max_radii = np.asarray([2.0, 2.2, 2.4], np.float32)
    gt_kpts = (rng.normal(size=(3, 3)) * 100).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (image, depth, max_radii, gt_kpts))


def seeded_net(cfg, seed, device):
    """A network of ``cfg`` from ``init_params`` with ``seed``, cast to
    the compute dtype on ``device`` (as ``PoseEstimator`` loads one)."""
    model = init_params(train_mod.build_model(cfg),
                        torch.Generator().manual_seed(seed))
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval()


def pair_evals(grid_l, n_points):
    """Pair evaluations of one keypoint's vote: (hier, as the coarse and
    refine stages perform them; reference, the O(N * L^3) loop's)."""
    hier = n_points * ((grid_l // voting._COARSE) ** 3 // voting._CPT_STRIDE
                       + voting._TOPK * voting._WIN ** 3)
    return hier, n_points * grid_l ** 3


def net_scalar(model, image):
    """``bench.py``'s net stage: the f32 mean of the radial head."""
    return model(image)[1].float().mean()


def vote_scalar(sem, depth, radial, k, mode, n_points, grid_l):
    """``bench.py``'s vote stage: the mean of one keypoint's center (mm)
    from maps + depth (max radius 2.0 dm, sem threshold 0.8)."""
    center = eval_mod.keypoint_from_maps(
        sem, radial, depth, k, 2.0, 0.8, n_points=n_points, grid_l=grid_l,
        mode=mode)[0]
    return center.float().mean()


def fit_scalar(gt, est):
    """``bench.py``'s fit stage: the mean of Horn's 4x4 transform."""
    return fit.horn_fit(gt, est).float().mean()


def best_of(run, reps, per, device):
    """``run(1)`` to warm, then ``run(reps)`` ``RUNS`` times on the host clock,
    each ending in one synchronize: (best ms a unit, [ms a unit of each
    run]), with ``reps * per`` units a run."""
    run(1)
    synchronize(device)
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        run(reps)
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3 / (reps * per))
    return min(times), times


def chained(fn, x0):
    """``reps`` calls of ``fn(x)`` whose input moves by the previous
    scalar x 1e-12 (``bench.py``'s ``chain_time`` body)."""
    def run(reps):
        x = x0
        for _ in range(reps):
            x = x + (fn(x) * 1e-12).to(x.dtype)
        return x
    return run


def _stage_device_ms(fn, device):
    if torch.device(device).type != "cuda":
        return None
    from rcvpose_tpu_torch.scripts import stage_device_ms

    ms, method = stage_device_ms(fn, DEVICE_REPS)
    return {"ms": ms, "method": method}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m rcvpose_tpu_torch.bench")
    ap.add_argument("--small", action="store_true",
                    help="the small net (width 0.125, blocks 1,1,1,1)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None, device=None, reps_scale=1.0):
    """Run the benchmark and print its record; returns the record.

    ``reps_scale`` multiplies every run's call count (at least 1 call), so
    that a smoke run stays short; the command line does not expose it."""
    args = parse_args(argv)
    device = resolve_device(args.device or device)
    card = device.type == "cuda"
    cfg, (h, w), bsz = bench_config(device, args.small)
    reps = {key: max(1, int(round(n * reps_scale)))
            for key, n in (CARD_REPS if card else CPU_REPS).items()}
    kw = dict(sem_threshold=0.8, n_points=cfg.max_points,
              grid_l=cfg.vote_grid_l, mode=cfg.vote_mode)
    k = torch.as_tensor(geometry.LINEMOD_K, dtype=torch.float32,
                        device=device)
    image, depth, max_radii, gt_kpts = bench_inputs(h, w, device)
    imgs_b = image.expand(bsz, -1, -1, -1)
    deps_b = depth.expand(bsz, -1, -1)
    runs_ms, device_ms = {}, {}

    with torch.inference_mode():
        nets = [seeded_net(cfg, i, device) for i in range(3)]
        fnet = seeded_net(dataclasses.replace(cfg, kpt_heads=3), 7, device)

        def frames(pose_fn, net):
            def run(n):
                img = image
                for _ in range(n):
                    rt = pose_fn(net, img, depth, k, max_radii, gt_kpts,
                                 **kw)["rt"]
                    img = img + rt[0, 0] * 1e-20
            return run

        def batches(batch_fn, net):
            def run(n):
                imgs = imgs_b
                for _ in range(n):
                    rt = batch_fn(net, imgs, deps_b, k, max_radii, gt_kpts,
                                  **kw)["rt"]
                    imgs = imgs + rt[0, 0, 0] * 1e-20
            return run

        frame, runs_ms["frame_ms"] = best_of(
            frames(infer._frame_pose, nets), reps["frame"], 1, device)
        device_ms["frame_ms"] = _stage_device_ms(
            lambda: infer._frame_pose(nets, image, depth, k, max_radii,
                                      gt_kpts, **kw)["rt"], device)
        batched, runs_ms["batched_frame_ms"] = best_of(
            batches(infer.frame_pose_batch, nets), reps["batched"], bsz,
            device)
        fused, runs_ms["fused_frame_ms"] = best_of(
            frames(infer._frame_pose_fused, fnet), reps["frame"], 1, device)
        fused_batched, runs_ms["fused_batched_frame_ms"] = best_of(
            batches(infer.frame_pose_fused_batch, fnet), reps["batched"],
            bsz, device)
        del fnet

        net0 = nets[0]
        x0 = image[None]
        net_ms, runs_ms["net_ms"] = best_of(
            chained(lambda x: net_scalar(net0, x), x0), reps["net"], 1,
            device)
        device_ms["net_ms"] = _stage_device_ms(lambda: net_scalar(net0, x0),
                                               device)
        seg, radial = net0(x0)
        sem_map = seg[0, :, :, 0]
        radial_map = radial[0, :, :, 0].float()

        def vote(mode):
            return lambda r: vote_scalar(sem_map, depth, r, k, mode,
                                         cfg.max_points, cfg.vote_grid_l)

        vote_ms, runs_ms["vote_ms_per_kpt"] = best_of(
            chained(vote(cfg.vote_mode), radial_map), reps["vote"], 1,
            device)
        device_ms["vote_ms_per_kpt"] = _stage_device_ms(
            lambda: vote(cfg.vote_mode)(radial_map), device)
        exact_ms = None
        if card:
            exact_ms, runs_ms["exact_vote_ms_per_kpt"] = best_of(
                chained(vote("exact"), radial_map), reps["exact"], 1,
                device)
        est0 = gt_kpts + 1.0
        fit_ms, runs_ms["fit_ms"] = best_of(
            chained(lambda e: fit_scalar(gt_kpts, e), est0), reps["fit"], 1,
            device)
        device_ms["fit_ms"] = _stage_device_ms(
            lambda: fit_scalar(gt_kpts, est0), device)

    hier_evals, ref_evals = pair_evals(cfg.vote_grid_l, cfg.max_points)
    mvotes = hier_evals / vote_ms / 1e3
    mvotes_ref = ref_evals / vote_ms / 1e3
    print(f"stages (host clock, best of {RUNS}): net={net_ms:.2f} ms  "
          f"vote(1kpt,{cfg.vote_mode})={vote_ms:.2f} ms  "
          f"fit={fit_ms:.3f} ms  frame={frame:.2f} ms  "
          f"batched(B={bsz})={batched:.2f} ms/frame  "
          f"fused(K=3)={fused:.2f} ms/frame  "
          f"fused+batched={fused_batched:.2f} ms/frame", file=sys.stderr)
    print(f"accumulator: {mvotes:.0f} M pair-evals/s (hier), "
          f"{mvotes_ref:.0f} M reference-equivalent votes/s"
          + (f"; exact mode {exact_ms:.1f} ms/kpt "
             f"({ref_evals / exact_ms / 1e3:.0f} M votes/s)"
             if exact_ms else ""), file=sys.stderr)

    from rcvpose_tpu_torch.scripts import card_line

    record = {
        "metric": "rgbd_frames_per_sec_per_chip",
        "value": round(1e3 / frame, 3),
        "unit": "frames/s",
        "batched_frames_per_sec": round(1e3 / batched, 3),
        "batch_size": bsz,
        "fused_multihead_frames_per_sec": round(1e3 / fused, 3),
        "fused_frame_ms": round(fused, 3),
        "fused_batched_frames_per_sec": round(1e3 / fused_batched, 3),
        "net_ms": round(net_ms, 3),
        "vote_ms_per_kpt": round(vote_ms, 3),
        "fit_ms": round(fit_ms, 4),
        "frame_ms": round(frame, 3),
        "mvotes_per_sec": round(mvotes, 1),
        "mvotes_ref_equiv_per_sec": round(mvotes_ref, 1),
        "vote_grid_l": cfg.vote_grid_l,
        "vote_points": cfg.max_points,
        "backend": device.type,
        "device": card_line() if card else "cpu",
        "runs_ms": runs_ms,
        "device_ms": device_ms if card else None,
    }
    if exact_ms is not None:
        record["exact_vote_ms_per_kpt"] = round(exact_ms, 3)
        record["exact_mvotes_per_sec"] = round(ref_evals / exact_ms / 1e3, 1)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
