"""Learned YCB-pipeline proof on the card: train -> YCB-format tree ->
evaluator AUC; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.e2e_ycb [--icp_compare] [--steps N]
        [--frames N] [--test_frames N] [--model_width F]
        [--model_blocks B] [--max_points N] [--image_hw H,W] [--out DIR]
    python -m rcvpose_tpu_torch.scripts.e2e_ycb --small --device cpu

The counterpart of the JAX package's ``scripts/e2e_ycb_tpu.py``. The
YCB-Video evaluator (per-frame ``.mat`` metas, ``factor_depth``-scaled
depth PNGs, the class's HDF5 image names, the fused checkpoint, the 1%
bounding-box ADD threshold and the 0-0.1 m ADD AUC) runs from a net
``train.Trainer`` learned:

  1. renders the synthetic NOCS cuboid (``e2e_synthetic``) at random poses;
  2. trains ONE fused multi-head net (``kpt_heads=3``,
     ``e2e_fused_train``) and saves it where the evaluator looks
     (``<model_dir>/<class>/``);
  3. writes the held-out frames as an on-disk YCB tree
     (``data/<cycle>/<idx>-{color,depth}.png + .mat``,
     ``models/<class>/points.xyz + Outside9.npy``,
     ``Split/<class>/val.txt`` and ``<class>.hdf5``, the last through the
     port's own ``data.hdf5_write``: the card's machine has no h5py);
  4. runs ``eval.estimate_6d_pose_ycb`` with ``using_ckpts=True``, and with
     ``--icp_compare`` again with 30 fixed ICP iterations in place of the
     converged ICP.

The exit code is 0 when the ADD AUC after ICP is at least 0.85; under
``--small`` (the small net at 64x64, 2 steps) when the evaluator scored
every frame. The script runs on the card and raises without one;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from rcvpose_tpu_torch.scripts.e2e_fused_train import (
    per_kpt_max_radii_dm, train_fused_checkpoint)
from rcvpose_tpu_torch.scripts.e2e_synthetic import (
    DIAMETER_M, KEYPOINTS_M, build_dataset, make_object, scaled_linemod_k)


def write_ycb_tree(root, class_name, class_id, cad_m, poses, images,
                   depths, k, factor_depth=10000.0, cycle="0000"):
    """Write frames as the reference's on-disk YCB layout; the class's
    HDF5 holds each frame's image uncompressed under
    ``JPEGImages/<cycle>_<idx>``."""
    import scipy.io
    from PIL import Image

    from rcvpose_tpu_torch.data import hdf5_write

    mdir = os.path.join(root, "models", class_name)
    os.makedirs(mdir, exist_ok=True)
    np.savetxt(os.path.join(mdir, "points.xyz"), cad_m)
    kpts9 = np.zeros((9, 3))
    kpts9[:KEYPOINTS_M.shape[0]] = KEYPOINTS_M
    np.save(os.path.join(mdir, "Outside9.npy"), kpts9)

    os.makedirs(os.path.join(root, "Split", class_name), exist_ok=True)
    ddir = os.path.join(root, "data", cycle)
    os.makedirs(ddir, exist_ok=True)
    ids, hdf5 = [], {}
    for i, (pose, img, depth_mm) in enumerate(zip(poses, images, depths)):
        idx = f"{i + 1:06d}"
        ids.append(f"{cycle}_{idx}")
        Image.fromarray(img).save(os.path.join(ddir, f"{idx}-color.png"))
        depth_u16 = np.round(
            depth_mm / 1000.0 * factor_depth).astype(np.uint16)
        Image.fromarray(depth_u16.astype(np.int32)).save(
            os.path.join(ddir, f"{idx}-depth.png"))
        scipy.io.savemat(os.path.join(ddir, f"{idx}.mat"), {
            "poses": np.asarray(pose, np.float64)[:, :, None],
            "cls_indexes": np.array([[class_id]]),
            "factor_depth": np.array([[factor_depth]]),
            "intrinsic_matrix": np.asarray(k, np.float64),
        })
        hdf5[f"JPEGImages/{cycle}_{idx}"] = img
    hdf5_write.write_hdf5(os.path.join(root, f"{class_name}.hdf5"), hdf5)
    with open(os.path.join(root, "Split", class_name, "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.e2e_ycb")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--test_frames", type=int, default=None)
    ap.add_argument("--model_width", type=float, default=None,
                    help="override the net width fraction")
    ap.add_argument("--model_blocks", default=None,
                    help="override encoder block counts, e.g. '2,3,4,2'")
    ap.add_argument("--max_points", type=int, default=None,
                    help="vote point budget override")
    ap.add_argument("--image_hw", default=None,
                    help="override the frame size, e.g. '128,160'")
    ap.add_argument("--icp_compare", action="store_true",
                    help="also run the evaluator with fixed-30 ICP and "
                         "report the converged-vs-fixed AUC delta")
    ap.add_argument("--out", default="logs/e2e_ycb")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the proof and print its record; returns the exit code."""
    from rcvpose_tpu_torch import eval as eval_mod
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.ops.voting import suggest_grid_l
    from rcvpose_tpu_torch.scripts import card_line
    from rcvpose_tpu_torch.utils import resolve_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    args.out = os.path.abspath(args.out)
    dev = resolve_device(args.device or device)

    small = args.small
    h, w = (64, 64) if small else (256, 320)
    if args.image_hw:
        h, w = (int(v) for v in args.image_hw.split(","))
    k = scaled_linemod_k(h, w)
    n_train = args.frames or (8 if small else 48)
    n_test = args.test_frames or (2 if small else 8)
    steps = args.steps or (2 if small else 600)
    batch = 2 if small else 8
    # the small architecture rides in the config fields: both
    # train.build_model and eval._load_models rebuild the net from these
    arch = dict(model_blocks="1,1,1,1", model_width=0.125) if small else {}
    if args.model_width is not None:
        arch["model_width"] = args.model_width
    if args.model_blocks is not None:
        arch["model_blocks"] = args.model_blocks
    class_name = "003_cracker_box"
    class_id = {v: kk for kk, v in eval_mod.YCB_CLASS_NAMES.items()}[
        class_name]

    rng = np.random.default_rng(0)
    pts_m, colors, cad_m = make_object(rng)
    poses, images, depths = build_dataset(
        rng, n_train + n_test, pts_m, colors, k, h, w)

    max_radii_dm = per_kpt_max_radii_dm(cad_m, KEYPOINTS_M)

    # --- train the fused net (the shared recipe, e2e_fused_train) ---
    cfg = Config(compute_dtype="float32" if small else "bfloat16",
                 image_height=h, image_width=w, batch_size=batch,
                 initial_lr=3e-4, max_iterations=steps, kpt_heads=3, **arch)
    model_dir = os.path.join(args.out, "ckpts")
    train_fused_checkpoint(cfg, images, depths, poses, KEYPOINTS_M,
                           max_radii_dm, k, n_train,
                           os.path.join(model_dir, class_name), dev)

    # --- write the held-out frames as a real YCB tree ---
    ds_root = os.path.join(args.out, "dataset")
    sl = slice(n_train, n_train + n_test)
    write_ycb_tree(ds_root, class_name, class_id, cad_m,
                   poses[sl], images[sl], depths[sl], k)

    # --- drive the production YCB evaluator from the checkpoint ---
    grid_l = suggest_grid_l(DIAMETER_M, float(max_radii_dm.max()))
    eval_cfg = Config(
        dataset="ycb", root_dataset=ds_root, model_dir=model_dir,
        using_ckpts=True, kpt_heads=3, **arch,
        compute_dtype=cfg.compute_dtype,
        vote_grid_l=min(grid_l, 96) if small else grid_l,
        max_points=args.max_points or (1024 if small else 8192),
        icp_iters=10 if small else 30)
    results = eval_mod.estimate_6d_pose_ycb(
        eval_cfg, class_ids=[class_id],
        progress=lambda s: print(s, file=sys.stderr), device=dev)
    res = results["all"]
    icp_cmp = None
    if args.icp_compare:
        # converged (the default: the reference's tolerance semantics,
        # AccumulatorSpace.py:1165-1169) against fixed-30 (the LM/LMO
        # criteria): the AUC delta says what convergence is worth here
        fixed_cfg = dataclasses.replace(eval_cfg, ycb_icp_converged=False,
                                        icp_iters=30)
        fixed = eval_mod.estimate_6d_pose_ycb(
            fixed_cfg, class_ids=[class_id], progress=lambda s: None,
            device=dev)["all"]
        icp_cmp = {
            "converged_auc_af": round(float(res["adds_auc_after_icp"]), 4),
            "fixed30_auc_af": round(float(fixed["adds_auc_after_icp"]), 4),
            "auc_delta": round(float(res["adds_auc_after_icp"]
                                     - fixed["adds_auc_after_icp"]), 4),
        }
    record = {
        "metric": "e2e_ycb_adds_auc_after_icp",
        "value": round(float(res["adds_auc_after_icp"]), 4),
        "unit": "auc_0_100mm",
        "adds_auc_before_icp": round(float(res["adds_auc_before_icp"]), 4),
        "frames": res["frames"],
        "train_steps": steps,
        "resolution": [h, w],
        "backend": dev.type,
        "class": class_name,
        "model": "DenseFCNResNet152 fused multi-head"
                 + (" (tiny)" if small else " (full 3/8/36/3)"),
        "device": card_line() if dev.type == "cuda" else "cpu",
    }
    if icp_cmp is not None:
        record["icp_criteria_compare"] = icp_cmp
    print(json.dumps(record), flush=True)
    # --small is a plumbing check (2 steps of the small net learn nothing):
    # the evaluator consumed every frame; the full run holds the accuracy
    ok = (res["frames"] == n_test if small
          else res["adds_auc_after_icp"] >= 0.85)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
