"""The sequential evaluator's decode prefetch against inline decode, on the
card; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.bench_eval_prefetch [--frames N]
        [--repeats N] [--small] [--device cpu]

The counterpart of the JAX package's ``scripts/bench_eval_prefetch.py``.
The LM/LMO/YCB loops decode the next frame's JPEG and ``.dpt`` in a thread
(``eval._prefetched_chunks``, chunk size 1) while the current frame runs
on the card. This measures what that overlap is worth on the reference's
``using_ckpts`` path (JPEG decode + 3 per-keypoint net forwards + vote +
Horn + ICP a frame): it builds a seeded LINEMOD-layout tree
(``make_lm_eval_tree``, the repo's test fixture's layout and draws),
writes three seeded ``.pth.tar`` nets through the port's ``Checkpointer``
and runs ``estimate_6d_pose_lm`` in three arms after a warm sweep: stock,
with ``_prefetched_chunks(stats=)`` recording each chunk's decode interval
and each consumer interval, and with ``_prefetched_chunks`` replaced by a
synchronous generator of the same semantics (``synchronous_chunks``). Each
arm takes the best of ``--repeats`` sweeps (2). The ADD results must be
identical across the arms. Reported: wall ms/frame of each arm, the
evaluator's own overlapped decode time, and the decode time that ran
while the consumer computed (the pairwise intersection of the recorded
intervals: a host-clock concurrency measurement).

Full size on the card: 480x640, full-width nets in bf16, grid 192, 2048
points, topk 64, 10 ICP iterations, 24 frames. ``--small``: 128x160, the
small net (width 0.125, blocks 1,1,1,1) in f32, grid 96, 4 frames. The CPU
runs only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import tempfile
import time

import numpy as np

from rcvpose_tpu_torch.scripts import make_lm_eval_tree


def synchronous_chunks(items, chunk_size, load_one, timers=None):
    """The no-overlap arm: ``eval._prefetched_chunks``'s chunking, padding
    and timer semantics with the decode inline in the consumer."""
    for c0 in range(0, len(items), chunk_size):
        chunk = items[c0:c0 + chunk_size]
        padded = chunk + [chunk[-1]] * (chunk_size - len(chunk))
        if timers is not None:
            with timers.time("decode"):
                loaded = [load_one(it) for it in padded]
        else:
            loaded = [load_one(it) for it in padded]
        yield len(chunk), padded, loaded


def interval_intersection(a_list, b_list):
    """Summed pairwise overlap (s) of two lists of (t0, t1) intervals."""
    total = 0.0
    for a0, a1 in a_list:
        for b0, b1 in b_list:
            total += max(0.0, min(a1, b1) - max(a0, b0))
    return total


def eval_config(tree, model_dir, small, h, w):
    """The JAX script's ``Config`` of the evaluator's run."""
    from rcvpose_tpu_torch.config import Config

    return Config(
        root_dataset=tree, using_ckpts=True, model_dir=model_dir,
        compute_dtype="float32" if small else "bfloat16",
        model_blocks="1,1,1,1" if small else "",
        model_width=0.125 if small else 1.0,
        image_height=h, image_width=w,
        vote_grid_l=96 if small else 192, max_points=2048,
        vote_mode="hier", icp_iters=10, vote_topk=64,
        eval_data_parallel=False)


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.bench_eval_prefetch")
    ap.add_argument("--small", action="store_true",
                    help="128x160, the small net in f32, grid 96")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=2,
                    help="sweeps an arm (the best is reported)")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Measure and print the record; returns it."""
    import torch

    from rcvpose_tpu_torch import eval as eval_mod
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.checkpoint import Checkpointer
    from rcvpose_tpu_torch.scripts import card_line
    from rcvpose_tpu_torch.utils import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device or device)
    small = args.small
    h, w = (128, 160) if small else (480, 640)
    n_frames = args.frames or (4 if small else 24)
    tmp = tempfile.mkdtemp(prefix="bench_eval_prefetch_")
    try:
        tree = make_lm_eval_tree(os.path.join(tmp, "data"),
                                 np.random.default_rng(0), h=h, w=w,
                                 n_frames=n_frames)
        model_dir = os.path.join(tmp, "ckpts")
        cfg = eval_config(tree, model_dir, small, h, w)
        # seeded nets in the 3-net layout, through the one-shot idiom
        # (the Checkpointer's finalizer finishes each write); evaluation
        # time does not depend on the weights
        state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                       device=dev)
        for kp in range(1, 4):
            Checkpointer(os.path.join(model_dir, f"ape_pt{kp}")).save(
                state, epoch=0, iteration=0, best_val=1.0, is_best=True)
        del state

        def sweep():
            t0 = time.perf_counter()
            res = eval_mod.estimate_6d_pose_lm(
                cfg, class_names=["ape"], progress=lambda *_: None,
                device=dev)["ape"]
            return time.perf_counter() - t0, res

        def best(n):
            return min((sweep() for _ in range(n)), key=lambda r: r[0])

        sweep()   # kernels built, caches warm (programs and page cache)
        real = eval_mod._prefetched_chunks
        stats = {}
        try:
            stock_s, stock_res = best(args.repeats)
            eval_mod._prefetched_chunks = functools.partial(real,
                                                            stats=stats)
            on_s, on_res = best(args.repeats)
            eval_mod._prefetched_chunks = synchronous_chunks
            off_s, off_res = best(args.repeats)
        finally:
            eval_mod._prefetched_chunks = real
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for res in (on_res, off_res):
        for key in ("add_before_icp", "add_after_icp"):
            if res[key] != stock_res[key]:
                raise AssertionError(f"{key} differs across the arms: "
                                     f"{stock_res} {on_res} {off_res}")
        if res["frames"] != n_frames:
            raise AssertionError(f"{res['frames']} of {n_frames} frames")
    # stats spans every sweep of the stats arm; per decoded frame
    n_chunks = max(len(stats.get("decode", ())), 1)
    overlap_ms = interval_intersection(stats.get("decode", ()),
                                       stats.get("consume", ())) \
        / n_chunks * 1e3
    decode_ms = sum(t1 - t0 for t0, t1 in stats.get("decode", ())) \
        / n_chunks * 1e3
    overlapped = on_res.get("decode_ms_per_frame_overlapped")
    record = {
        "metric": "eval_prefetch_ms_per_frame",
        "value": round(on_s / n_frames * 1e3, 1),
        "unit": "ms",
        "inline_decode_ms_per_frame": round(off_s / n_frames * 1e3, 1),
        "speedup": round(off_s / on_s, 3),
        "overlapped_decode_ms_per_frame": (
            round(overlapped, 1) if overlapped is not None else None),
        "measured_concurrent_decode_ms_per_frame": round(overlap_ms, 1),
        "decode_ms_per_frame_total": round(decode_ms, 1),
        "decode_fraction_hidden": (round(overlap_ms / decode_ms, 3)
                                   if decode_ms else None),
        "frames": n_frames,
        "resolution": [h, w],
        "mode": "using_ckpts 3-net sequential loop",
        "backend": dev.type,
        "note": ("value = wall/frame with the shipped prefetch and its "
                 "stats; stock = the same without stats; inline = "
                 "_prefetched_chunks replaced by a synchronous generator "
                 "(identical semantics, no overlap); ADD results asserted "
                 "identical across arms"),
        "stock_ms_per_frame": round(stock_s / n_frames * 1e3, 1),
        "device": card_line() if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
