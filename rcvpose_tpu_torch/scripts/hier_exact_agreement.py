"""Does hier mode pick the exact mode's keypoint? Over random synthetic
frames, on K1:

    python -m rcvpose_tpu_torch.scripts.hier_exact_agreement [n_frames]
        [grid_l] [--scene single|cluttered|maskbleed|both]
        [--sweep | --sweep-win] [--device cpu]

The counterpart of the JAX package's ``scripts/hier_exact_agreement.py``.
Its scene generators are copied bit for bit (numpy, one
``default_rng(seed)`` a run): ``single`` (a clean rough surface patch with
perfect radial labels, 5 mm noise on every other frame), ``maskbleed``
(15% of the points on a background plane with junk radii) and
``cluttered`` (a half-plane-occluded patch beside 1-2 distractor blobs
that vote for their own keypoints, 5% outlier radii). Each frame votes
through ``voting.accumulate_3d`` in ``mode="exact"`` (every voxel of the
``grid_l``^3 lattice against every point) and in ``mode="hier"`` (coarse
vote, top-k cells, refine windows), so K1 runs at every stage; exact is
the reference, and a frame agrees when the two centres lie within one
voxel's diagonal.

Defaults: 120 frames, grid 128, 8192 points, scene ``single``.
``--sweep`` walks hier's ``topk`` x ``cpt_stride`` (2/4/8 x 1/4/8) and
``--sweep-win`` the refine window (``topk`` 4/8 x ``win`` 8/12/16), each
over the single and cluttered scenes. One JSON line a configuration: the
JAX script's record plus ``device`` (the card's name and power limit, or
"cpu") and ``vote_counts_launches`` (K1's launches in that
configuration). It runs on the card and raises without one unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from rcvpose_tpu_torch.ops import vote_cuda, voting
from rcvpose_tpu_torch.utils import resolve_device


def _patch(rng, n, center, extent_scale=1.0, roughness=0.003):
    """Points on a random rough surface patch around ``center``."""
    u = rng.uniform(-1, 1, size=(n, 2)) * rng.uniform(0.02, 0.05) \
        * extent_scale
    normal = rng.normal(size=3)
    normal /= np.linalg.norm(normal)
    b1 = np.cross(normal, [1.0, 0, 0])
    b1 /= np.linalg.norm(b1) + 1e-9
    b2 = np.cross(normal, b1)
    bump = rng.normal(size=(n,)) * roughness
    return center + u[:, :1] * b1 + u[:, 1:] * b2 + bump[:, None] * normal


def _frame(pts, radial_dm, kpt):
    """(points (N, 3) f32 m, radii (N,) f32 dm, mask (N,) bool, keypoint
    mm), the JAX script's return values as numpy arrays."""
    return (np.asarray(pts, np.float32), np.asarray(radial_dm, np.float32),
            np.ones(pts.shape[0], bool), kpt * 1000.0)


def synth_frame(rng, n_points=8192, noise_dm=0.0):
    """Single clean patch + keypoint + radial labels (dm)."""
    center = rng.uniform([-0.1, -0.1, 0.6], [0.1, 0.1, 1.0])
    pts = _patch(rng, n_points, center)
    kpt = center + rng.uniform(-0.06, 0.06, size=3)  # LINEMOD-like offsets
    radial_dm = np.linalg.norm(pts - kpt, axis=1) * 10.0
    if noise_dm:
        radial_dm = radial_dm + rng.normal(size=n_points) * noise_dm
    return _frame(pts, radial_dm, kpt)


def synth_maskbleed_frame(rng, n_points=8192, noise_dm=0.05,
                          bleed_frac=0.15):
    """One object whose sem mask bleeds onto the background:
    ``bleed_frac`` of the points on a plane 10-30 cm behind it with junk
    radii (a trained net's false positives), 5 mm noise on every radius."""
    center = rng.uniform([-0.1, -0.1, 0.6], [0.1, 0.1, 1.0])
    n_obj = int(n_points * (1.0 - bleed_frac))
    obj = _patch(rng, n_obj, center)
    kpt = center + rng.uniform(-0.06, 0.06, size=3)
    obj_r = np.linalg.norm(obj - kpt, axis=1) * 10.0

    n_bg = n_points - n_obj
    bg_center = center + np.array([0.0, 0.0, rng.uniform(0.1, 0.3)])
    bg = _patch(rng, n_bg, bg_center, extent_scale=2.0, roughness=0.001)
    # junk radii: uniform over the plausible prediction range
    bg_r = rng.uniform(0.1, obj_r.max() * 1.2, size=n_bg)

    pts = np.concatenate([obj, bg])[:n_points]
    radial_dm = np.concatenate([obj_r, bg_r])[:n_points]
    radial_dm = np.maximum(
        radial_dm + rng.normal(size=pts.shape[0]) * noise_dm, 0.0)
    return _frame(pts, radial_dm, kpt)


def synth_cluttered_frame(rng, n_points=8192, noise_dm=0.05,
                          outlier_frac=0.05):
    """An occluded object among 1-2 distractor blobs that vote for their
    own keypoints, ``outlier_frac`` of all radii moved by up to 2 dm."""
    center = rng.uniform([-0.1, -0.1, 0.6], [0.1, 0.1, 1.0])
    n_obj = int(n_points * 0.55)
    obj = _patch(rng, 2 * n_obj, center)
    # occlusion: keep one side of a random half-plane through the center
    cut_n = rng.normal(size=3)
    cut_n /= np.linalg.norm(cut_n)
    keep = (obj - center) @ cut_n > rng.uniform(-0.01, 0.01)
    obj = obj[keep][:n_obj]
    kpt = center + rng.uniform(-0.06, 0.06, size=3)
    parts = [obj]
    labels = [np.linalg.norm(obj - kpt, axis=1) * 10.0]

    n_rest = n_points - obj.shape[0]
    n_blobs = int(rng.integers(1, 3))
    for b in range(n_blobs):
        nb = n_rest // n_blobs if b < n_blobs - 1 else \
            n_rest - (n_rest // n_blobs) * (n_blobs - 1)
        d_center = center + rng.uniform(-0.12, 0.12, size=3)
        blob = _patch(rng, nb, d_center, extent_scale=rng.uniform(0.5, 1.2))
        d_kpt = d_center + rng.uniform(-0.06, 0.06, size=3)
        parts.append(blob)
        labels.append(np.linalg.norm(blob - d_kpt, axis=1) * 10.0)

    pts = np.concatenate(parts)[:n_points]
    radial_dm = np.concatenate(labels)[:n_points]
    if noise_dm:
        radial_dm = radial_dm + rng.normal(size=pts.shape[0]) * noise_dm
    if outlier_frac:
        n_out = int(pts.shape[0] * outlier_frac)
        idx = rng.choice(pts.shape[0], n_out, replace=False)
        radial_dm[idx] += rng.uniform(-2.0, 2.0, size=n_out)
    radial_dm = np.maximum(radial_dm, 0.0)
    return _frame(pts, radial_dm, kpt)


def scene_frame(rng, scene, i, n_points):
    """Frame ``i`` of ``scene``, drawn from ``rng`` as the JAX script
    draws it."""
    if scene == "cluttered":
        return synth_cluttered_frame(rng, n_points=n_points)
    if scene == "maskbleed":
        return synth_maskbleed_frame(rng, n_points=n_points)
    noise = 0.0 if i % 2 == 0 else 0.05   # half the frames: 5 mm noise
    return synth_frame(rng, n_points=n_points, noise_dm=noise)


def run_suite(n_frames, grid_l, scene, topk=None, cpt_stride=None, seed=0,
              n_points=8192, win=None, device=None):
    """The JAX script's ``run_suite`` on ``device`` (the card unless
    "cpu"): its record, plus K1's launches in the suite."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    agree_voxel = 0
    dists = []
    err_ex, err_hi = [], []
    overflowed = 0
    launches = vote_cuda.vote_counts_cuda.launches
    for i in range(n_frames):
        pts, rad, mask, kpt_mm = scene_frame(rng, scene, i, n_points)
        pts, rad, mask = (torch.as_tensor(a, device=dev)
                          for a in (pts, rad, mask))
        ex = voting.accumulate_3d(pts, rad, mask, grid_l=grid_l, mode="exact")
        hi = voting.accumulate_3d(pts, rad, mask, grid_l=grid_l, mode="hier",
                                  topk=topk, cpt_stride=cpt_stride, win=win)
        if bool(ex.overflow):
            overflowed += 1
            continue
        ce = ex.center_mm.cpu().numpy()
        ch = hi.center_mm.cpu().numpy()
        d = float(np.linalg.norm(ce - ch))
        dists.append(d)
        agree_voxel += d <= voting.ACC_UNIT_MM * np.sqrt(3) + 1e-6
        err_ex.append(float(np.linalg.norm(ce - kpt_mm)))
        err_hi.append(float(np.linalg.norm(ch - kpt_mm)))
    launches = vote_cuda.vote_counts_cuda.launches - launches

    if not dists:
        return {"frames": 0, "grid_l": grid_l, "scene": scene,
                "overflowed": overflowed,
                "note": "every frame overflowed — grid_l too small",
                "vote_counts_launches": launches}
    dists = np.asarray(dists)
    return {
        "frames": len(dists),
        "grid_l": grid_l,
        "scene": scene,
        "topk": topk or voting._TOPK,
        "cpt_stride": cpt_stride or voting._CPT_STRIDE,
        "win": win or voting._WIN,
        "agree_within_1_voxel": round(float(agree_voxel / len(dists)), 4),
        "center_dist_mm_mean": round(float(dists.mean()), 3),
        "center_dist_mm_p95": round(float(np.percentile(dists, 95)), 3),
        "center_dist_mm_max": round(float(dists.max()), 3),
        "kpt_err_mm_exact_mean": round(float(np.mean(err_ex)), 3),
        "kpt_err_mm_hier_mean": round(float(np.mean(err_hi)), 3),
        "overflowed": overflowed,
        "vote_counts_launches": launches,
    }


def configurations(args):
    """[(scene, run_suite keywords)] that the command line asks for."""
    if args.sweep:
        return [(sc, {"topk": topk, "cpt_stride": stride})
                for sc in ("single", "cluttered") for topk in (2, 4, 8)
                for stride in (1, 4, 8)]
    if args.sweep_win:
        # the true peak lies inside the winning coarse cell, so a window
        # just covering cell + margin should match a wide one
        return [(sc, {"topk": topk, "win": win})
                for sc in ("single", "cluttered") for topk in (4, 8)
                for win in (8, 12, 16)]
    scenes = (("single", "cluttered") if args.scene == "both"
              else (args.scene,))
    return [(sc, {}) for sc in scenes]


def main(argv=None, device=None, printer=print):
    """Run the configurations the arguments name; returns their records."""
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.hier_exact_agreement")
    ap.add_argument("n_frames", nargs="?", type=int, default=120)
    ap.add_argument("grid_l", nargs="?", type=int, default=128)
    ap.add_argument("--scene", default="single",
                    choices=("single", "cluttered", "maskbleed", "both"))
    ap.add_argument("--sweep", action="store_true",
                    help="hier topk x cpt_stride over single and cluttered")
    ap.add_argument("--sweep-win", dest="sweep_win", action="store_true",
                    help="hier topk x refine window over single and "
                         "cluttered")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or device)
    if dev.type == "cuda":
        from rcvpose_tpu_torch.scripts import card_line

        name = card_line()
    else:
        name = str(dev)
    records = []
    for scene, kw in configurations(args):
        rec = run_suite(args.n_frames, args.grid_l, scene, device=dev, **kw)
        rec["device"] = name
        records.append(rec)
        printer(json.dumps(rec))
    return records


if __name__ == "__main__":
    main()
