"""Learned LMO-pipeline proof on the card: train -> Occlusion-LINEMOD tree
-> evaluator; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.e2e_lmo [--steps N] [--frames N]
        [--test_frames N] [--model_width F] [--model_blocks B]
        [--max_points N] [--out DIR]
    python -m rcvpose_tpu_torch.scripts.e2e_lmo --small --device cpu

The counterpart of the JAX package's ``scripts/e2e_lmo_tpu.py``. The
Occlusion-LINEMOD evaluator (noseg frame paths, ``blender_poses`` ground
truth, the missing-pose skip, sem threshold 0.5, 30 ICP iterations,
meter-valued eval ``.ply``) runs from a net ``train.Trainer`` learned:

  1. renders the synthetic NOCS cuboid (``e2e_synthetic``) under the
     LINEMOD intrinsics, at random rotations with translations aimed so
     the object projects inside the (smaller) frame;
  2. trains ONE fused multi-head net (``kpt_heads=3``,
     ``e2e_fused_train``) and saves it where the evaluator looks
     (``<model_dir>/<class>/``);
  3. writes the held-out frames as an on-disk LMO tree, plus one frame
     WITHOUT a pose file, which the evaluator must skip;
  4. runs ``eval.estimate_6d_pose_lmo`` with ``using_ckpts=True``.

The exit code is 0 when the ADD pass fraction after ICP is at least 0.85;
under ``--small`` (the small net at 128x160, 2 steps) when the evaluator
scored exactly the frames that have a pose. The script runs on the card
and raises without one; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from rcvpose_tpu_torch.scripts import write_ascii_ply
from rcvpose_tpu_torch.scripts.e2e_fused_train import (
    per_kpt_max_radii_dm, train_fused_checkpoint)
from rcvpose_tpu_torch.scripts.e2e_synthetic import (
    DIAMETER_M, KEYPOINTS_M, make_object, random_pose, render_frame)


def aimed_poses(rng, n_frames, k, px_range, py_range, z_range):
    """Random SO(3) rotations with translations aimed at a pixel window
    of the full-K image plane (tests/test_eval_lmo_ycb_format.py:58-64)."""
    poses = []
    for _ in range(n_frames):
        pose = random_pose(rng, z_range=z_range)
        z = pose[2, 3]
        px = rng.uniform(*px_range)
        py = rng.uniform(*py_range)
        pose[0, 3] = (px - k[0, 2]) / k[0, 0] * z
        pose[1, 3] = (py - k[1, 2]) / k[1, 1] * z
        poses.append(pose)
    return np.stack(poses)


def write_lmo_tree(root, class_name, cad_m, poses, images, depths):
    """Write frames as the reference's on-disk Occlusion-LINEMOD layout,
    plus one trailing frame with rgb+depth but NO pose file (the evaluator
    must skip it, reference AccumulatorSpace.py:813-822)."""
    from PIL import Image

    pv = os.path.join(root, "LINEMOD", class_name)
    os.makedirs(pv, exist_ok=True)
    # meter-valued ascii ply: the eval-path CAD convention (reference
    # AccumulatorSpace.py:544-549, 663-667)
    write_ascii_ply(os.path.join(pv, f"{class_name}.ply"), cad_m)
    kpts9 = np.zeros((9, 3))
    kpts9[:KEYPOINTS_M.shape[0]] = KEYPOINTS_M
    np.save(os.path.join(pv, "Outside9.npy"), kpts9)

    occ = os.path.join(root, "OCCLUSION_LINEMOD")
    rgb_dir = os.path.join(occ, "RGB-D", "rgb_noseg")
    depth_dir = os.path.join(occ, "RGB-D", "depth_noseg")
    pose_dir = os.path.join(occ, "blender_poses", class_name)
    for d in (rgb_dir, depth_dir, pose_dir):
        os.makedirs(d, exist_ok=True)
    for i, (img, depth_mm) in enumerate(zip(images, depths)):
        Image.fromarray(img).save(
            os.path.join(rgb_dir, f"color_{i:05d}.png"))
        depth_u16 = np.round(depth_mm).astype(np.uint16)
        Image.fromarray(depth_u16.astype(np.int32)).save(
            os.path.join(depth_dir, f"depth_{i:05d}.png"))
        if i < len(poses):  # the extra frame gets no pose -> skipped
            np.save(os.path.join(pose_dir, f"pose{i}.npy"),
                    np.asarray(poses[i], np.float64))


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.e2e_lmo")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--model_width", type=float, default=None,
                    help="override the net width fraction")
    ap.add_argument("--model_blocks", default=None,
                    help="override encoder block counts, e.g. '2,4,6,2'")
    ap.add_argument("--test_frames", type=int, default=None)
    ap.add_argument("--max_points", type=int, default=None,
                    help="vote point budget override (small default 1024 "
                         "can truncate large masks)")
    ap.add_argument("--out", default="logs/e2e_lmo")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the proof and print its record; returns the exit code."""
    from rcvpose_tpu_torch import eval as eval_mod
    from rcvpose_tpu_torch import geometry
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.ops.voting import suggest_grid_l
    from rcvpose_tpu_torch.scripts import card_line
    from rcvpose_tpu_torch.utils import resolve_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    args.out = os.path.abspath(args.out)
    dev = resolve_device(args.device or device)

    small = args.small
    # frames live in the top-left (h, w) window of the full-K image plane;
    # aim window keeps the ~0.08 m object radius fully inside at these z
    k = np.asarray(geometry.LINEMOD_K, np.float32)
    if small:
        h, w = 128, 160
        px_range, py_range, z_range = (48, 112), (48, 80), (1.2, 1.5)
    else:
        h, w = 256, 320
        px_range, py_range, z_range = (80, 240), (80, 176), (0.78, 1.0)
    n_train = args.frames or (8 if small else 48)
    n_test = args.test_frames or (2 if small else 8)
    steps = args.steps or (2 if small else 600)
    batch = 2 if small else 8
    arch = dict(model_blocks="1,1,1,1", model_width=0.125) if small else {}
    if args.model_width is not None:
        arch["model_width"] = args.model_width
    if args.model_blocks is not None:
        arch["model_blocks"] = args.model_blocks
    class_name = "ape"  # any LMO class; CAD/keypoints are synthetic anyway

    rng = np.random.default_rng(1)
    pts_m, colors, cad_m = make_object(rng)
    poses = aimed_poses(rng, n_train + n_test + 1, k,
                        px_range, py_range, z_range)
    frames = [render_frame(p, pts_m, colors, k, h, w) for p in poses]
    images = np.stack([f[0] for f in frames])
    depths = np.stack([f[1] for f in frames])

    max_radii_dm = per_kpt_max_radii_dm(cad_m, KEYPOINTS_M)

    # --- train the fused net (the shared recipe, e2e_fused_train) ---
    cfg = Config(compute_dtype="float32" if small else "bfloat16",
                 image_height=h, image_width=w, batch_size=batch,
                 initial_lr=3e-4, max_iterations=steps, kpt_heads=3, **arch)
    model_dir = os.path.join(args.out, "ckpts")
    train_fused_checkpoint(cfg, images, depths, poses, KEYPOINTS_M,
                           max_radii_dm, k, n_train,
                           os.path.join(model_dir, class_name), dev)

    # --- write held-out frames (+1 poseless frame) as a real LMO tree ---
    ds_root = os.path.join(args.out, "dataset")
    sl = slice(n_train, n_train + n_test + 1)
    write_lmo_tree(ds_root, class_name, cad_m,
                   poses[n_train:n_train + n_test],
                   images[sl], depths[sl])

    # --- drive the production LMO evaluator from the checkpoint ---
    grid_l = suggest_grid_l(DIAMETER_M, float(max_radii_dm.max()))
    eval_cfg = Config(
        dataset="lmo", root_dataset=ds_root, model_dir=model_dir,
        using_ckpts=True, kpt_heads=3, **arch,
        compute_dtype=cfg.compute_dtype,
        vote_grid_l=min(grid_l, 96) if small else grid_l,
        max_points=args.max_points or (1024 if small else 8192))
    results = eval_mod.estimate_6d_pose_lmo(
        eval_cfg, class_names=[class_name],
        progress=lambda s: print(s, file=sys.stderr), device=dev)
    res = results[class_name]
    record = {
        "metric": "e2e_lmo_add_after_icp",
        "value": round(float(res["add_after_icp"]), 4),
        "unit": "pass_fraction",
        "add_before_icp": round(float(res["add_before_icp"]), 4),
        "frames": res["frames"],
        "frames_written": n_test + 1,  # one poseless frame must be skipped
        "train_steps": steps,
        "resolution": [h, w],
        "backend": dev.type,
        "class": class_name,
        "model": "DenseFCNResNet152 fused multi-head"
                 + (" (tiny)" if small else " (full 3/8/36/3)"),
        "device": card_line() if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(record), flush=True)
    # --small is a plumbing check (2 steps of the small net learn nothing):
    # the evaluator consumed exactly the posed frames (skip path exercised);
    # the full run holds the accuracy
    ok = (res["frames"] == n_test if small
          else res["add_after_icp"] >= 0.85)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
