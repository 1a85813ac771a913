"""The evaluators' grid-overflow retry on the card; prints ONE JSON line
last.

    python -m rcvpose_tpu_torch.scripts.e2e_overflow_retry
    python -m rcvpose_tpu_torch.scripts.e2e_overflow_retry --small \\
        --device cpu

The counterpart of the JAX package's ``scripts/e2e_overflow_retry_tpu.py``.
The evaluators guard mask-noise outliers with a host-side retry: when a
frame's cloud overflows the class-sized vote cube (``voting.accumulate_3d``'s
``overflow`` flag), the keypoint re-runs at ``retry_grid_l=256``
(``eval.keypoint_with_retry``). This builds the seeded LINEMOD-layout tree
of the repo's test fixture (``scripts.make_lm_eval_tree``, precomputed
radial maps), pushes one depth pixel of frame 1 behind the object with a
valid radial value there (the smallest offset whose cloud overflows grid
192 and fits 256), times ``keypoint_with_retry`` warm on that frame and on
the clean frame 0, then sweeps ``eval.estimate_6d_pose_lm`` and asserts
that both frames score and exactly one went through the retry.

The port compiles nothing, so the ``*_first_call_ms`` fields are the cost
of a call at a grid never run before in the process (a kernel's first
build or load, the allocator's growth), not a compile. Times are the host
clock, ending in a synchronize. The script runs on the card and raises
without one; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.e2e_overflow_retry")
    ap.add_argument("--small", action="store_true",
                    help="accepted for the JAX script's command line; the "
                         "fixture is small at either setting")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the measurement and print its record; returns the exit code."""
    import torch

    from rcvpose_tpu_torch import eval as eval_mod
    from rcvpose_tpu_torch import geometry
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.data import readers
    from rcvpose_tpu_torch.scripts import (card_line, make_lm_eval_tree,
                                           write_dpt)
    from rcvpose_tpu_torch.utils import resolve_device, synchronize

    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device or device)
    tmp = tempfile.mkdtemp(prefix="e2e_overflow_retry_")
    try:
        tree = make_lm_eval_tree(tmp, np.random.default_rng(0))
        cfg = Config(root_dataset=tree, using_ckpts=False,
                     compute_dtype="float32", vote_grid_l=192,
                     max_points=2048, vote_mode="hier", icp_iters=10,
                     eval_data_parallel=False, vote_topk=64)
        source = eval_mod.RadialMapSource(cfg, "ape", device=dev)
        k = torch.tensor(geometry.LINEMOD_K, dtype=torch.float32, device=dev)
        cad_m = eval_mod._read_eval_cad_m(
            os.path.join(tree, "LINEMOD", "ape", "ape.ply"))
        keypoints = np.load(os.path.join(tree, "LINEMOD", "ape",
                                         "Outside9.npy"))
        max_radii = eval_mod._per_kpt_max_radii_dm(cad_m, keypoints)
        mr = float(np.float32(max_radii[0]))
        thr = float(cfg.sem_threshold)

        def maps(frame_id):
            return source.maps(1, None, frame_id)

        first_call_ms = {}  # grid_l -> the first call's ms

        def one_kpt(sem, rad, dep, grid_l):
            synchronize(dev)
            t0 = time.perf_counter()
            out = eval_mod.keypoint_from_maps(
                sem, rad, dep, k, mr, thr, n_points=cfg.max_points,
                grid_l=grid_l, mode=cfg.vote_mode, topk=cfg.vote_topk)
            synchronize(dev)
            first_call_ms.setdefault(grid_l,
                                     (time.perf_counter() - t0) * 1e3)
            return out

        # Frame 000001: one depth pixel pushed behind the object with a
        # small valid radial, the mask-noise outlier the retry exists for.
        # The vote frame's bound is a GLOBAL min/max across axes (like the
        # reference's, AccumulatorSpace.py:394-401), so the outlier depth
        # is found by search: the smallest offset whose cloud overflows
        # grid 192 but fits the 256 retry.
        orig = os.path.join(tree, "LINEMOD_ORIG", "ape", "data",
                            "depth1.dpt")
        depth = readers.read_depth(orig).astype(np.uint16)
        z_obj = float(depth[depth > 0].mean())
        p1 = None
        for kp in range(1, 4):
            p = os.path.join(tree, "LINEMOD_ORIG", "estRadialMap", "ape",
                             f"Out_pt{kp}_dm", "000001.npy")
            p1 = p1 or p
            r = np.load(p)
            r[2, 2] = 1.0  # valid (below every max-radius clip)
            np.save(p, r)
        # probe with keypoint 1's map AND keypoint 1's max radius (mr)
        rad1_np = np.load(p1)
        sem1 = torch.as_tensor((rad1_np != 0).astype(np.float32),
                               device=dev)
        rad1 = torch.as_tensor(rad1_np, device=dev)
        for dz in range(300, 1600, 100):
            depth[2, 2] = np.uint16(z_obj + dz)
            d1 = torch.as_tensor(depth.astype(np.float32), device=dev)
            over_base = bool(one_kpt(sem1, rad1, d1, cfg.vote_grid_l)[1])
            over_retry = bool(one_kpt(sem1, rad1, d1, 256)[1])
            if over_base and not over_retry:
                break
        else:
            raise SystemExit("no outlier offset lands between grid 192 "
                             "and 256")
        write_dpt(orig, depth)
        print(f"outlier at z_obj + {dz} mm: overflows 192, fits 256",
              file=sys.stderr)

        def load_depth(i):
            return torch.as_tensor(readers.read_depth(os.path.join(
                tree, "LINEMOD_ORIG", "ape", "data",
                f"depth{i}.dpt")).astype(np.float32), device=dev)

        sem0, rad0 = maps("000000")
        sem1, rad1 = maps("000001")
        d0, d1 = load_depth(0), load_depth(1)

        def retry_call(sem, rad, dep):
            synchronize(dev)
            t0 = time.perf_counter()
            out = eval_mod.keypoint_with_retry(cfg, sem, rad, dep, k, mr,
                                               thr)
            synchronize(dev)
            return (time.perf_counter() - t0) * 1e3, out

        retry_call(sem0, rad0, d0)  # warm the retry path on the clean frame
        clean_ms = min(retry_call(sem0, rad0, d0)[0] for _ in range(3))
        # warm retry-path cost: the grid-192 run (flags overflow) + the
        # grid-256 re-run, both grids run before: the steady-state cost
        # every overflowed frame pays
        warm_ms, out_warm = retry_call(sem1, rad1, d1)
        warm_ms = min([warm_ms] + [retry_call(sem1, rad1, d1)[0]
                                   for _ in range(2)])
        assert not bool(out_warm[1]), "retry at grid 256 still overflowed"

        # full evaluator sweep: the adversarial frame routes through the
        # retry inside the production loop (the sequential loop counts
        # frames whose keypoint_with_retry fallback fired) and both frames
        # still score
        res = eval_mod.estimate_6d_pose_lm(
            cfg, class_names=["ape"], progress=lambda *_: None,
            device=dev)["ape"]
        assert res["frames"] == 2, res
        assert res["overflow_frames"] == 1, res  # the adversarial frame
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({
        "metric": "overflow_retry_warm_ms_per_kpt",
        "value": round(warm_ms, 1),
        "unit": "ms",
        "clean_frame_ms_per_kpt": round(clean_ms, 1),
        "retry_grid256_first_call_ms": round(first_call_ms.get(256, 0), 1),
        "base_grid192_first_call_ms": round(
            first_call_ms.get(cfg.vote_grid_l, 0), 1),
        "outlier_dz_mm": dz,
        "grid_l": cfg.vote_grid_l, "retry_grid_l": 256,
        "eval_add_before_icp": res["add_before_icp"],
        "eval_add_after_icp": res["add_after_icp"],
        "frames": res["frames"],
        "backend": dev.type,
        "note": ("warm = per-keypoint cost of an overflowed frame with "
                 "both grids run before (grid-192 run + grid-256 rerun); "
                 "first_call = the first call at each grid in the process "
                 "(the port compiles nothing: the cost is a first "
                 "kernel build or load and allocation); clean = grid-192 "
                 "baseline per keypoint; host clock ending in a "
                 "synchronize"),
        "device": card_line() if dev.type == "cuda" else "cpu",
        "overflow_frames": res["overflow_frames"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
