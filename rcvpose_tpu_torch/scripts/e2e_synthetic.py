"""Learned end-to-end proof on the card: render -> labels -> train -> save
and restore -> serve -> ADD; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.e2e_synthetic [--fused]
        [--fast-head] [--steps N] [--frames N] [--out DIR]
    python -m rcvpose_tpu_torch.scripts.e2e_synthetic --small --device cpu

The counterpart of the JAX package's ``scripts/e2e_synthetic_tpu.py``. No
dataset ships, so the proof makes its own:

  1. renders an asymmetric cuboid with NOCS coordinate colours (z-buffered
     point splat) at random 6DoF poses, LINEMOD optics scaled to 256x320;
  2. labels every frame with ``labels.radial_labels`` on the device;
  3. trains the full DenseFCNResNet152 (3/8/36/3, bf16 compute) per
     keypoint with ``train.Trainer`` (Adam, 600 steps a net), or one
     multi-head net with ``--fused`` (``kpt_heads=3``);
  4. saves each net with the asynchronous ``Checkpointer``, waits for the
     write and restores it into a freshly seeded state;
  5. serves the held-out frames from the restored weights through
     ``infer.PoseEstimator.estimate`` (K2 head split, K1 votes, Horn) and
     ``refine`` (30 ICP iterations);
  6. scores ADD against the reference's criterion, 0.1 x the diameter.

NOCS colours make the radial regression well posed from RGB alone (the
distance from a surface point to a keypoint does not depend on the pose),
so a pass proves the pipeline, not a rendering trick. The exit code is 0
when at least 75% of the held-out frames pass; ``--small`` (the small net
at 64x64, 2 steps) is a plumbing check and always exits 0.

The decoder convs train on the route ``RCVPOSE_PALLAS_CONV`` names
(``cli.conv_kernel_route``): ``on`` runs K3/K4, the default cuDNN. The
renderer and the world are numpy and equal the JAX script's bit for bit.
The script runs on the card and raises without one; ``--device cpu`` runs
it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# Synthetic world
# ---------------------------------------------------------------------------

HALF_EXTENTS = np.array([0.03, 0.045, 0.06])  # m; asymmetric cuboid
DIAMETER_M = 2.0 * float(np.linalg.norm(HALF_EXTENTS))  # 0.1620 m
ADD_THRESHOLD_MM = 0.1 * DIAMETER_M * 1000.0            # reference criterion

# Keypoints: dispersed 2x-bbox corners, the reference's Outside9 fallback
# construction (rmap_dataset.py:43-51). Rows 1..3 are the trained keypoints.
KEYPOINTS_M = np.array([
    [0.0, 0.0, 0.0],                                   # row 0 unused (ref [1:4])
    [2 * 0.03, 2 * 0.045, 2 * 0.06],
    [-2 * 0.03, 2 * 0.045, -2 * 0.06],
    [2 * 0.03, -2 * 0.045, -2 * 0.06],
])


def make_object(rng, n_render=120_000, n_cad=3000):
    """Cuboid surface cloud (model frame, meters) + NOCS colors."""
    # sample faces proportionally to area
    areas = np.array([
        HALF_EXTENTS[1] * HALF_EXTENTS[2],
        HALF_EXTENTS[0] * HALF_EXTENTS[2],
        HALF_EXTENTS[0] * HALF_EXTENTS[1]]).repeat(2)
    p = areas / areas.sum()
    face = rng.choice(6, size=n_render, p=p)
    uv = rng.uniform(-1, 1, size=(n_render, 2))
    pts = np.empty((n_render, 3))
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        others = [a for a in range(3) if a != axis]
        pts[m, axis] = sign * HALF_EXTENTS[axis]
        pts[m, others[0]] = uv[m, 0] * HALF_EXTENTS[others[0]]
        pts[m, others[1]] = uv[m, 1] * HALF_EXTENTS[others[1]]
    colors = ((pts / HALF_EXTENTS + 1.0) * 0.5 * 255.0).astype(np.uint8)
    cad = pts[rng.choice(n_render, size=n_cad, replace=False)]
    return pts, colors, cad


def random_pose(rng, z_range=(0.65, 0.95)):
    """Uniform-ish SO(3) rotation + bounded translation (m), (3, 4)."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t = np.array([rng.uniform(-0.04, 0.04), rng.uniform(-0.03, 0.03),
                  rng.uniform(*z_range)])
    return np.concatenate([rot, t[:, None]], axis=1)


def render_frame(pose, pts_m, colors, k, h, w):
    """Z-buffered point splat -> (rgb u8 (H,W,3), depth mm (H,W))."""
    cam = pts_m @ pose[:3, :3].T + pose[:3, 3]
    uvz = cam @ k.T
    us = np.round(uvz[:, 0] / uvz[:, 2]).astype(np.int64)
    vs = np.round(uvz[:, 1] / uvz[:, 2]).astype(np.int64)
    ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h) & (cam[:, 2] > 0)
    us, vs, z = us[ok], vs[ok], cam[ok, 2]
    lin = vs * w + us
    depth = np.full(h * w, np.inf, np.float32)
    np.minimum.at(depth, lin, z.astype(np.float32))
    # keep only the nearest splat's color per pixel
    keep = z <= depth[lin] + 1e-9
    rgb = np.zeros((h * w, 3), np.uint8)
    rgb[lin[keep]] = colors[ok][keep]
    depth[np.isinf(depth)] = 0.0
    return rgb.reshape(h, w, 3), (depth * 1000.0).reshape(h, w)


def build_dataset(rng, n_frames, pts_m, colors, k, h, w):
    poses, images, depths = [], [], []
    for _ in range(n_frames):
        pose = random_pose(rng)
        rgb, depth = render_frame(pose, pts_m, colors, k, h, w)
        poses.append(pose)
        images.append(rgb)
        depths.append(depth)
    return np.stack(poses), np.stack(images), np.stack(depths)


def scaled_linemod_k(h, w):
    """LINEMOD optics scaled to an (h, w) frame (f = 572.4 at 480x640),
    principal point at the centre."""
    scale = w / 640.0
    return np.array([[572.4114 * scale, 0.0, w / 2.0],
                     [0.0, 573.5704 * scale, h / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def per_kpt_max_radii_dm(cad_m, keypoints_m):
    """Per-keypoint radius clips for keypoints 1..3, in decimeters
    (the reference's max CAD-vertex distance x10, rmap_dataset.py:53-56)."""
    return np.array([
        np.linalg.norm(cad_m - keypoints_m[i + 1], axis=1).max() * 10.0
        for i in range(3)], np.float32)


# ---------------------------------------------------------------------------
# Labels and training
# ---------------------------------------------------------------------------

def frame_labels(depths, poses, k, kpt_m, max_radii_dm, device):
    """``labels.radial_labels(depth, depth > 0, pose, kpt, K, max_r)`` over
    every frame, on ``device``: (radial dm, sem) as (N, H, W) for one
    keypoint (``kpt_m`` (3,)) or (N, H, W, K) for several ((K, 3))."""
    import torch

    from rcvpose_tpu_torch import labels

    d = torch.as_tensor(np.asarray(depths, np.float32), device=device)
    return labels.radial_labels(
        d, d > 0, torch.as_tensor(np.asarray(poses, np.float32),
                                  device=device),
        np.asarray(kpt_m, np.float32), k, max_radii_dm)


def normalized_images(images, device):
    """``labels.normalize_image`` over uint8 frames (N, H, W, 3), on
    ``device``."""
    import torch

    from rcvpose_tpu_torch import labels

    return labels.normalize_image(torch.as_tensor(images, device=device))


def epoch_batches(epoch, seed, n_train, batch):
    """The frame indices of each batch of ``epoch``: the JAX scripts'
    ``default_rng(epoch * 7 + seed).permutation(n_train)`` in ``batch``
    slices, the tail dropped."""
    order = np.random.default_rng(epoch * 7 + seed).permutation(n_train)
    return [order[s:s + batch] for s in range(0, n_train - batch + 1, batch)]


def batch_factories(images_norm, radial, sem, n_train, batch, seed,
                    val_idx):
    """``(train_batches(epoch), val_batches())`` for ``Trainer`` over the
    tensors ``images_norm``, ``radial`` and ``sem`` (on the card or the
    CPU): the batches of ``epoch_batches(epoch, seed, n_train, batch)``,
    and one validation batch of the frames ``val_idx``."""
    import torch

    dev = images_norm.device

    def put(idx):
        # one copy an epoch, from pinned memory without waiting: a copy
        # from pageable memory would make the host wait for the card at
        # every batch
        idx = torch.from_numpy(np.asarray(idx, np.int64))
        if dev.type == "cuda":
            idx = idx.pin_memory()
        return idx.to(dev, non_blocking=True)

    def take(i):
        return {"image": images_norm[i], "radial": radial[i], "sem": sem[i]}

    def train_batches(epoch):
        batches = epoch_batches(epoch, seed, n_train, batch)
        for i in put(np.stack(batches)) if batches else ():
            yield take(i)

    def val_batches():
        yield take(put(val_idx))

    return train_batches, val_batches


def train_net(cfg, state, images_norm, radial, sem, n_train, seed, val_idx):
    """``Trainer.fit`` for ``ceil(steps * batch / n_train)`` epochs over the
    first ``n_train`` frames (``batch_factories``), then one validation on
    the frames ``val_idx``. Returns (trainer, seconds of the fit,
    validation loss)."""
    from rcvpose_tpu_torch import train as train_mod

    train_batches, val_batches = batch_factories(
        images_norm, radial, sem, n_train, cfg.batch_size, seed, val_idx)
    trainer = train_mod.Trainer(cfg=cfg, state=state,
                                train_batches=train_batches,
                                val_batches=val_batches, checkpointer=None)
    max_epochs = -(-cfg.max_iterations * cfg.batch_size // n_train)
    t0 = time.time()
    trainer.fit(max_epochs=max_epochs)
    dt = time.time() - t0
    return trainer, dt, trainer.validate(max_epochs)


def save_and_restore(cfg, trainer, directory, epoch, val, blocks, width,
                     conv_kernel, device):
    """Save ``trainer.state`` with the (asynchronous) ``Checkpointer``,
    wait for the write, and restore it into a state seeded afresh (the JAX
    script's ``PRNGKey(99)``). Returns the restored weights (CPU state
    dict)."""
    import torch

    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.checkpoint import Checkpointer

    ckpt = Checkpointer(directory)
    ckpt.save(trainer.state, epoch=epoch, iteration=trainer.iteration,
              best_val=val, is_best=False)
    ckpt.wait_until_finished()   # restored below: drain the async write
    fresh = train_mod.create_state(
        cfg, torch.Generator().manual_seed(99), steps_per_epoch=1,
        blocks=blocks, width=width, device=device, conv_kernel=conv_kernel)
    restored, _, _, _ = ckpt.restore(fresh)
    return {k: v.detach().cpu()
            for k, v in restored.model.state_dict().items()}


# ---------------------------------------------------------------------------
# Train + eval
# ---------------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.e2e_synthetic")
    ap.add_argument("--small", action="store_true",
                    help="the small net, tiny frames, few steps")
    ap.add_argument("--steps", type=int, default=None,
                    help="train steps per keypoint")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--fused", action="store_true",
                    help="train ONE multi-head net (kpt_heads=3) instead of "
                         "three per-keypoint nets")
    ap.add_argument("--fast-head", action="store_true", dest="fast_head",
                    help="conv7/conv8 head at H/2 + upsampled output")
    ap.add_argument("--out", default="logs/e2e_synthetic")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the proof and print its record; returns the exit code."""
    import torch

    from rcvpose_tpu_torch import cli, infer, metrics
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.ops.voting import suggest_grid_l
    from rcvpose_tpu_torch.scripts import card_line
    from rcvpose_tpu_torch.utils import resolve_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device or device)
    conv_kernel = cli.conv_kernel_route()

    small = args.small
    h, w = (64, 64) if small else (256, 320)  # H, W multiples of 32 (FCN)
    k = scaled_linemod_k(h, w)
    n_train = args.frames or (8 if small else 48)
    n_test = 2 if small else 8
    steps = args.steps or (2 if small else 600)
    batch = 2 if small else 8
    blocks, width = ((1, 1, 1, 1), 0.125) if small else (None, None)

    rng = np.random.default_rng(0)
    pts_m, colors, cad_m = make_object(rng)
    print(f"object: cuboid d={DIAMETER_M * 1000:.0f} mm, "
          f"ADD threshold {ADD_THRESHOLD_MM:.1f} mm", file=sys.stderr)

    t0 = time.time()
    poses, images, depths = build_dataset(
        rng, n_train + n_test, pts_m, colors, k, h, w)
    print(f"rendered {n_train + n_test} frames in {time.time() - t0:.1f} s",
          file=sys.stderr)

    max_radii_dm = per_kpt_max_radii_dm(cad_m, KEYPOINTS_M)

    heads = 3 if args.fused else 1
    cfg = Config(
        compute_dtype="float32" if small else "bfloat16",
        image_height=h, image_width=w, batch_size=batch,
        initial_lr=3e-4, max_iterations=steps, kpt_heads=heads,
        fast_head=args.fast_head)

    images_norm = normalized_images(images, dev)
    val_idx = np.arange(n_train, n_train + n_test)
    trained_vars = []
    steps_per_sec = None
    for kp_i in range(1 if args.fused else 3):
        # multi-head labels (N, H, W, 3): one (radial, sem) per keypoint
        rows = slice(1, 4) if args.fused else kp_i + 1
        radial, sem = frame_labels(
            depths, poses, k, KEYPOINTS_M[rows],
            max_radii_dm if args.fused else max_radii_dm[kp_i], dev)
        state = train_mod.create_state(
            cfg, torch.Generator().manual_seed(kp_i),
            steps_per_epoch=n_train // batch, blocks=blocks, width=width,
            device=dev, conv_kernel=conv_kernel)
        trainer, dt, val = train_net(cfg, state, images_norm, radial, sem,
                                     n_train, kp_i, val_idx)
        steps_per_sec = trainer.iteration / dt
        tag = "fused" if args.fused else f"kpt{kp_i + 1}"
        max_epochs = -(-steps * batch // n_train)
        # the served weights are the RESTORED ones, not the live ones
        trained_vars.append(save_and_restore(
            cfg, trainer, os.path.join(args.out, tag), max_epochs, val,
            blocks, width, conv_kernel, dev))
        print(f"{tag}: {trainer.iteration} steps in {dt:.1f} s "
              f"({steps_per_sec:.2f} steps/s), val loss {val:.4f}",
              file=sys.stderr)
        del trainer, state, radial, sem

    # --- serve held-out frames through the production path ---
    grid_l = suggest_grid_l(DIAMETER_M, float(max_radii_dm.max()))
    small_net = (dict(model_blocks="1,1,1,1", model_width=0.125)
                 if small else {})
    eval_cfg = Config(
        compute_dtype=cfg.compute_dtype, image_height=h, image_width=w,
        vote_grid_l=min(grid_l, 96) if small else grid_l,
        max_points=1024 if small else 8192, sem_threshold=0.8,
        kpt_heads=heads, fast_head=args.fast_head, **small_net)
    est = infer.PoseEstimator(
        eval_cfg, trained_vars, keypoints=KEYPOINTS_M,
        max_radii_dm=max_radii_dm, cad_mm=cad_m * 1000.0, k=k, device=dev)

    cad_mm = torch.as_tensor(cad_m * 1000.0, dtype=torch.float32,
                             device=dev)
    adds_before, adds_after = [], []
    for i in range(n_train, n_train + n_test):
        out = est.estimate(images[i], depths[i])
        rt_gt_mm = poses[i].copy()
        rt_gt_mm[:, 3] *= 1000.0
        rt_gt_mm = torch.as_tensor(np.vstack([rt_gt_mm, [0, 0, 0, 1]]),
                                   dtype=torch.float32, device=dev)
        add_bf = float(metrics.add_score(cad_mm, rt_gt_mm, out["rt"])[0])
        rt2 = est.refine(out, threshold_mm=max(add_bf, 5.0), icp_iters=30)
        add_af = float(metrics.add_score(cad_mm, rt_gt_mm, rt2)[0])
        adds_before.append(add_bf)
        adds_after.append(add_af)
        print(f"frame {i - n_train}: ADD {add_bf:.2f} -> {add_af:.2f} mm "
              f"(threshold {ADD_THRESHOLD_MM:.1f})", file=sys.stderr)

    adds_before = np.array(adds_before)
    adds_after = np.array(adds_after)
    pass_rate = float((adds_after <= ADD_THRESHOLD_MM).mean())
    record = {
        "metric": "e2e_synthetic_add_pass_rate",
        "value": pass_rate,
        "unit": "fraction",
        "add_threshold_mm": round(ADD_THRESHOLD_MM, 1),
        "mean_add_before_icp_mm": round(float(adds_before.mean()), 2),
        "mean_add_after_icp_mm": round(float(adds_after.mean()), 2),
        "max_add_after_icp_mm": round(float(adds_after.max()), 2),
        "train_steps_per_kpt": steps,
        "train_steps_per_sec": round(steps_per_sec or 0.0, 2),
        "frames": {"train": n_train, "test": n_test},
        "resolution": [h, w],
        "backend": dev.type,
        "kpt_heads": heads,
        "model": "DenseFCNResNet152"
                 + (" (tiny)" if small else " (full 3/8/36/3)")
                 + (" fused multi-head" if args.fused else ""),
        "conv_route": "K3/K4" if conv_kernel else "cuDNN",
        "device": card_line() if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(record), flush=True)
    return 0 if (small or pass_rate >= 0.75) else 1


if __name__ == "__main__":
    raise SystemExit(main())
