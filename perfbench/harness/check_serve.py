"""``correct`` for the serving cells: the sampled frames of the window
against the plain reference, after the window has closed.

The vote's peak is a first maximum over integer counts. With random
weights its runner-up lies close, so rounding in the nets (bfloat16 in
the program, float32 in the reference) moves it between near-tied voxels
on some frames. The comparison therefore follows the program step by
step from the nets' maps:

* ``maps_rel_err``: each net's segmentation and radius maps, as the
  timed path produced them, against the reference's float32 forward of
  the same frame with the same weights: the L2 norm of the difference
  over the L2 norm of the reference map about its mean; the median over
  the sampled frames of each net's each map, and the worst of those. A
  deep net with random weights amplifies rounding unevenly from frame to
  frame, so the worst single map swings from seed to seed (it is
  printed beside); a net that is wrong is wrong on most frames;
* ``centers_diff_mm``: the voted keypoints (mm) from the program's maps
  by the reference's masks, packing and hier vote, against the
  program's; the reference's arithmetic is the program's step for step,
  so sound runs read 0, and a peak moved to another 5 mm voxel reads 5
  or more;
* ``pose_diff_mm``: the largest distance between the model's keypoints
  placed by the program's pose and by the reference's Horn fit of them;
* ``icp_diff_mm`` (refine traffic): the largest distance between the CAD
  points placed by the program's refined pose and by the reference's ICP
  from its own pose and scene cloud.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from perfbench.harness import serving
from perfbench.reference import full_f32
from perfbench.reference import pose as ref_pose


def _place(rt, pts):
    return pts @ rt[:3, :3].T + rt[:3, 3]


def _rel_err(prog, ref):
    spread = torch.linalg.vector_norm(ref - ref.mean())
    return float(torch.linalg.vector_norm(prog - ref)
                 / torch.clamp(spread, min=1e-30))


def check(run, inp, items):
    """[(name, value, limit)] over the sampled ``items``."""
    conf = serving.settings(run)
    limits = run.cell.workload["check"]["limits"]
    dev = run.device
    with full_f32():
        nets = [n.eval() for n in serving.reference_nets(
            run, serving.served_dtype(conf))]
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=dev)
        k, max_radii = put(inp.k), put(inp.max_radii)
        kpts_mm = put(inp.keypoints[1:4] * 1000.0)
        refine = run.cell.traffic.get("refine")
        worst = dict.fromkeys(("centers_diff_mm", "pose_diff_mm"), 0.0)
        per_map = {}
        if refine:
            worst["icp_diff_mm"] = 0.0
            cad = put(inp.cad_mm)
        share = []
        with torch.no_grad():
            for item in items:
                j = item["pool"]
                x = serving.normalize(torch.as_tensor(inp.images[j],
                                                      device=dev))[None]
                depth = put(inp.depths[j])
                for i, (net, maps) in enumerate(zip(nets, item["maps"])):
                    for kind, prog, ref in zip(("seg", "radial"), maps,
                                               net(x)):
                        for c in range(prog.shape[-1]):
                            per_map.setdefault((i, kind, c), []).append(
                                _rel_err(prog[..., c].float(), ref[..., c]))
                sem = torch.cat([s[0].permute(2, 0, 1).float()
                                 for s, _ in item["maps"]])
                rad = torch.cat([r[0].permute(2, 0, 1).float()
                                 for _, r in item["maps"]])
                ref = ref_pose.pose_from_maps(sem, rad, depth, k, max_radii,
                                              kpts_mm, conf)
                share.append(float(ref["counts"].float().mean())
                             / float(inp.areas[j]))
                worst["centers_diff_mm"] = max(worst["centers_diff_mm"], float(
                    (item["centers"].to(dev) - ref["centers"]).abs().max()))
                worst["pose_diff_mm"] = max(worst["pose_diff_mm"], float(
                    torch.linalg.vector_norm(
                        _place(item["rt"].to(dev), kpts_mm)
                        - _place(ref["rt"], kpts_mm), dim=1).max()))
                if refine:
                    rt2 = ref_pose.icp(cad, ref["scene_pts"],
                                       ref["scene_mask"], ref["rt"],
                                       refine["threshold_mm"],
                                       refine["iters"])
                    worst["icp_diff_mm"] = max(worst["icp_diff_mm"], float(
                        torch.linalg.vector_norm(
                            _place(item["refined"].to(dev), cad)
                            - _place(rt2, cad), dim=1).max()))
    run.note("voting_px_share", min(share) if share else None)
    every = [e for errs in per_map.values() for e in errs]
    run.note("maps_rel_err_worst_map", max(every))
    run.note("maps_rel_err_median_map", statistics.median(every))
    worst = {"maps_rel_err": max(statistics.median(errs)
                                 for errs in per_map.values()), **worst}
    return [(name, value, limits[name]) for name, value in worst.items()]
