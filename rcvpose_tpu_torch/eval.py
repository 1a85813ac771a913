"""Offline evaluation on LINEMOD, Occlusion-LINEMOD and YCB-Video
(counterpart of ``rcvpose_tpu.eval``, the evaluators' sequential loops).

The reference evaluators (``AccumulatorSpace.py`` ``estimate_6d_pose_lm``
:495-740, ``_lmo`` :742-974, ``_ycb`` :976-1197) per frame: network
forward (or precomputed radial maps) -> sem threshold + radius clip ->
point packing -> radial voting per keypoint (K1) -> Horn fit -> ADD(-S)
-> point-to-point ICP on the union scene cloud -> ADD(-S). File IO and
image decode are the only host work; the next frame's files are read in a
background thread (``_prefetched_chunks``) while this one computes.
``keypoint_from_maps_no_depth`` is the RGB-only ablation: masked pixels
vote from a stack of depth-hypothesis planes.

Behavioural notes carried over from the JAX package: radial values and
scene points are aligned on pixels where ``sem AND depth > 0``; the ICP's
union cloud is concatenated, not deduplicated.

With more than one local card (or ``eval_data_parallel=True``) each
class's frames run data-parallel: mesh-sized chunks through
``parallel.sharded_frame_scores`` (one thread per card), the last chunk
padded by its final frame, frames whose vote grid overflowed re-run
through the sequential grid retry. Under a process group of several
ranks (``--distributed``) every process sweeps a disjoint shard of the
frames (``_proc_shard``) and the per-class metrics are reduced on the
host (``_finalize_class_results``, ``parallel.host_allgather``).

Divergence from the JAX package, with a test:
* The LM and LMO loaders decode the image only when a network or the
  overlays read it (``using_ckpts`` or ``demo_mode``). On the
  precomputed-map route the JAX loops decode the image and never use it;
  the results are the same.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import re
import threading
import time
from functools import partial

import numpy as np
import torch

from rcvpose_tpu_torch import (checkpoint, demo, fit, geometry, labels,
                               metrics, parallel)
from rcvpose_tpu_torch import train as train_mod
from rcvpose_tpu_torch.data import readers
from rcvpose_tpu_torch.ops import voting
from rcvpose_tpu_torch.utils import StageTimers, resolve_device, synchronize

# Class lists + symmetric sets + ADD thresholds (m): dataset constants from
# the reference (AccumulatorSpace.py:19-57).
LM_CLASS_NAMES = ["ape", "benchvise", "cam", "can", "cat", "duck", "driller",
                  "eggbox", "glue", "holepuncher", "iron", "lamp", "phone"]
LMO_CLASS_NAMES = ["ape", "can", "cat", "duck", "driller", "eggbox", "glue",
                   "holepuncher"]
LM_SYMS = ["eggbox", "glue"]
YCB_SYMS = ["024_bowl", "036_wood_block", "051_large_clamp",
            "052_extra_large_clamp", "061_foam_brick"]
ADD_THRESHOLD = {
    "eggbox": 0.019735770122546523, "ape": 0.01421240983190395,
    "cat": 0.018594838977253875, "cam": 0.02222763033276377,
    "duck": 0.015569664208967385, "glue": 0.01930723067998101,
    "can": 0.028415044264086586, "driller": 0.031877906042,
    "holepuncher": 0.019606109985, "benchvise": 0.033091264970068,
    "iron": 0.03172344425531, "lamp": 0.03165980764376,
    "phone": 0.02543407135792,
}
YCB_CLASS_NAMES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill",
    16: "036_wood_block", 17: "037_scissors", 18: "040_large_marker",
    19: "051_large_clamp", 20: "052_extra_large_clamp", 21: "061_foam_brick",
}
# reference YCB AUC threshold grid, meters (AccumulatorSpace.py:978)
YCB_AUC_THRESHOLDS = [0.0, 0.02, 0.04, 0.06, 0.08, 0.1]
# The LMO loop's own criteria, whatever the config says: sem threshold 0.5
# (reference :837) and 30 ICP iterations (:940-942).
LMO_SEM_THRESHOLD = 0.5
LMO_ICP_ITERS = 30

_NO_YCB_MAPS = (
    "YCB evaluation has no precomputed-radial-map path: the reference YCB "
    "loop always runs the network (AccumulatorSpace.py:1044 — only the "
    "LM/LMO evaluators have an estRadialMap branch). Re-run with "
    "using_ckpts and --model_dir pointing at the per-class checkpoints.")


def keypoint_from_maps(sem_map, radial_map, depth_mm, k, max_radius_dm,
                       sem_threshold, n_points=8192, grid_l=192, mode="hier",
                       topk=None, cpt_stride=None, win=None):
    """One keypoint estimate from network output maps + depth.

    Mirrors the reference per-keypoint block (AccumulatorSpace.py:602-628):
    sem > threshold, radial clipped above the per-keypoint max radius, depth
    masked, back-projected to meters, packed in row-major order,
    accumulated. Returns (center_mm (3,), overflow (), count (), scene
    points mm (n_points, 3), mask (n_points,)), all on the maps' device.
    """
    sem = (sem_map > sem_threshold) & (radial_map <= max_radius_dm)
    depth = torch.where(sem, depth_mm, torch.zeros_like(depth_mm))
    xyz_map, valid = geometry.backproject_dense(depth, k)
    flat_xyz = xyz_map.reshape(-1, 3) / 1000.0
    flat_rad = radial_map.reshape(-1)
    order, mask = geometry.pack_valid_indices(valid.reshape(-1), n_points)
    pts = torch.where(mask[:, None], flat_xyz[order], 0.0)
    rad = torch.where(mask, flat_rad[order], 0.0)
    res = voting.accumulate_3d(pts, rad, mask, grid_l=grid_l, mode=mode,
                               topk=topk, cpt_stride=cpt_stride, win=win)
    count = valid.sum().to(torch.int32)
    return res.center_mm, res.overflow, count, pts * 1000.0, mask


def keypoint_from_maps_no_depth(sem_map, radial_map, k, z_min_m,
                                max_radius_dm, sem_threshold, n_points=2048,
                                n_hyp=32, grid_l=192, mode="hier",
                                step_m=1e-3):
    """RGB-only ablation: one keypoint from (sem, radial) maps WITHOUT depth.

    Closes the reference's dead no-depth loop (``rgbd_to_point_cloud_no_depth``
    -> ``Accumulator_3D_no_depth``, AccumulatorSpace.py:100-120, 421-479):
    masked pixels are back-projected onto ``n_hyp`` planes from ``z_min_m``
    (``step_m`` apart) and every hypothesis point votes with its pixel's
    radius, so at the defaults 2048 x 32 points vote. Returns (center_mm
    (3,), overflow (), count () masked pixels) on the maps' device.
    """
    sem = (sem_map > sem_threshold) & (radial_map <= max_radius_dm)
    clouds, mask, order, count = geometry.depth_hypothesis_clouds(
        sem, k, z_min_m, n_hyp, n_points, step_m=step_m)
    rad = torch.where(mask, radial_map.reshape(-1)[order], 0.0)
    res = voting.accumulate_3d_no_depth(clouds, rad, mask, grid_l=grid_l,
                                        mode=mode)
    return res.center_mm, res.overflow, count


def _keypoint_kw(cfg):
    return dict(n_points=cfg.max_points, mode=cfg.vote_mode,
                topk=cfg.vote_topk, cpt_stride=cfg.vote_cpt_stride,
                win=cfg.vote_win)


def _vote_kw(cfg):
    """The frame program's keywords (``_frame_scores``)."""
    return dict(sem_threshold=cfg.sem_threshold, grid_l=cfg.vote_grid_l,
                icp_iters=cfg.icp_iters, **_keypoint_kw(cfg))


def keypoint_with_retry(cfg, sem_map, radial_map, depth, k, max_r,
                        sem_threshold, retry_grid_l=None, on_retry=None):
    """``keypoint_from_maps`` + a host-side fallback to a larger grid when
    the frame's extent overflows the class-sized cube. One host read of the
    overflow flag per keypoint. ``retry_grid_l`` defaults to
    ``cfg.retry_grid_l``; ``on_retry`` (zero arguments) is called iff the
    fallback fires. The returned overflow flag is the last run's: True
    means the frame overflowed even at the retry grid."""
    if retry_grid_l is None:
        retry_grid_l = cfg.retry_grid_l
    kn = _keypoint_kw(cfg)
    out = keypoint_from_maps(sem_map, radial_map, depth, k, max_r,
                             sem_threshold, grid_l=cfg.vote_grid_l, **kn)
    if bool(out[1]) and retry_grid_l > cfg.vote_grid_l:
        if on_retry is not None:
            on_retry()
        out = keypoint_from_maps(sem_map, radial_map, depth, k, max_r,
                                 sem_threshold, grid_l=retry_grid_l, **kn)
    return out


def _add(cad_mm, rt_gt_mm, rt, sym):
    d = metrics.nn_distances(metrics.transform(cad_mm, rt_gt_mm),
                             metrics.transform(cad_mm, rt))
    return d.amin() if sym else d.mean()


def pose_and_add(gt_kpts_mm, est_kpts_mm, cad_mm, rt_gt_mm, sym):
    """Horn fit over the 3 keypoints + ADD(-S) before ICP
    (AccumulatorSpace.py:660-695). Returns (rt (4, 4), score ())."""
    rt = fit.horn_fit(gt_kpts_mm, est_kpts_mm)
    return rt, _add(cad_mm, rt_gt_mm, rt, sym)


def refine_and_add(rt, cad_mm, scene_mm, scene_mask, rt_gt_mm, sym, threshold,
                   icp_iters=30, rel_fitness=None, rel_rmse=None):
    """ICP refinement against the union scene cloud + ADD(-S) after
    (AccumulatorSpace.py:697-728). ``rel_fitness``/``rel_rmse`` switch the
    ICP to converge-to-tolerance with ``icp_iters`` as the cap (the
    reference's YCB criteria); None = the LM/LMO fixed-iteration ones."""
    rt2 = fit.icp_point_to_point(cad_mm, scene_mm, scene_mask, rt, threshold,
                                 max_iters=icp_iters,
                                 rel_fitness=rel_fitness, rel_rmse=rel_rmse)
    return rt2, _add(cad_mm, rt_gt_mm, rt2, sym)


def _frame_scores(sem_maps, radial_maps, depth_mm, k, max_radii_dm,
                  gt_kpts_mm, cad_mm, rt_gt_mm, sym, *, sem_threshold,
                  n_points, grid_l, mode, topk=None, cpt_stride=None,
                  win=None, icp_iters=30, rel_fitness=None, rel_rmse=None):
    """One frame's whole eval compute on its device: per-keypoint vote
    (``keypoint_from_maps``, the sequential loops' math) -> Horn -> ADD ->
    ICP -> ADD. ``sem_maps``/``radial_maps`` (3, H, W); ``rt_gt_mm``
    (3, 4) with the translation in mm. Returns device tensors: ``rt``,
    ``rt2``, ``score_bf``/``score_af`` (mm) and the per-keypoint
    ``overflow`` (an overflowed frame must re-run through the sequential
    grid retry for parity with the sequential loop)."""
    centers, overflow, scene, masks = [], [], [], []
    for i in range(sem_maps.shape[0]):
        center, over, _, pts_mm, mask = keypoint_from_maps(
            sem_maps[i], radial_maps[i], depth_mm, k, max_radii_dm[i],
            sem_threshold, n_points=n_points, grid_l=grid_l, mode=mode,
            topk=topk, cpt_stride=cpt_stride, win=win)
        centers.append(center)
        overflow.append(over)
        scene.append(pts_mm)
        masks.append(mask)
    rt, score_bf = pose_and_add(gt_kpts_mm, torch.stack(centers), cad_mm,
                                rt_gt_mm, sym)
    rt2, score_af = refine_and_add(
        rt, cad_mm, torch.cat(scene), torch.cat(masks), rt_gt_mm, sym,
        torch.clamp(score_bf, min=1e-3), icp_iters=icp_iters,
        rel_fitness=rel_fitness, rel_rmse=rel_rmse)
    return {"rt": rt, "rt2": rt2, "score_bf": score_bf,
            "score_af": score_af, "overflow": torch.stack(overflow)}


def _frame_scores_net(net, image_norm, depth_mm, k, max_radii_dm,
                      gt_kpts_mm, cad_mm, rt_gt_mm, sym, **kw):
    """``_frame_scores`` after the network forward: ``net`` is a tuple
    of 3 per-keypoint networks or one multi-head network; ``image_norm``
    (H, W, 3)."""
    if isinstance(net, (tuple, list)):
        maps = [m(image_norm[None]) for m in net]
        sem_maps = torch.stack([seg[0, :, :, 0] for seg, _ in maps])
        radial_maps = torch.stack([rad[0, :, :, 0] for _, rad in maps])
    else:
        seg, radial = net(image_norm[None])
        sem_maps, radial_maps = seg[0].permute(2, 0, 1), \
            radial[0].permute(2, 0, 1)
    return _frame_scores(sem_maps, radial_maps, depth_mm, k, max_radii_dm,
                         gt_kpts_mm, cad_mm, rt_gt_mm, sym, **kw)


class RadialMapSource:
    """Network-driven or precomputed radial/sem maps, per keypoint.

    The reference either runs one checkpoint per keypoint
    (AccumulatorSpace.py:520-530, 595-610) or loads precomputed
    ``estRadialMap/.../Out_pt<k>_dm/*.npy`` files (:612-618), under
    ``LINEMOD_ORIG`` or, for LMO, ``OCCLUSION_LINEMOD``. With
    ``cfg.kpt_heads > 1`` one multi-head forward per frame serves every
    keypoint from its cached output. ``models``: the networks of
    ``_load_models``; maps come back as f32 tensors on ``device`` (None:
    the card, as for the entry points).
    """

    def __init__(self, cfg, class_name, models=None, device=None):
        self.cfg = cfg
        self.class_name = class_name
        self.models = models
        self.device = resolve_device(device)
        self._fused_cache = None  # ((frame id, lmo), (seg, radial) (H,W,K))

    def _forward(self, model, image_u8):
        img = torch.tensor(np.asarray(image_u8), device=self.device)
        with torch.inference_mode():
            return model(labels.normalize_image(img)[None])

    def maps(self, kpt_idx, image_u8, frame_id, lmo=False):
        cfg = self.cfg
        if not cfg.using_ckpts and cfg.dataset == "ycb":
            raise ValueError(_NO_YCB_MAPS)
        if cfg.using_ckpts:
            if cfg.kpt_heads > 1:
                key = (frame_id, lmo)
                if self._fused_cache is None or self._fused_cache[0] != key:
                    seg, radial = self._forward(self.models[0], image_u8)
                    self._fused_cache = (key, (seg[0], radial[0]))
                seg, radial = self._fused_cache[1]
                return seg[:, :, kpt_idx - 1], radial[:, :, kpt_idx - 1]
            seg, radial = self._forward(self.models[kpt_idx - 1], image_u8)
            return seg[0, :, :, 0], radial[0, :, :, 0]
        base = "OCCLUSION_LINEMOD" if lmo else "LINEMOD_ORIG"
        path = os.path.join(cfg.root_dataset, base, "estRadialMap",
                            self.class_name,
                            f"Out_pt{kpt_idx}_dm", f"{frame_id}.npy")
        radial = np.load(path).astype(np.float32)
        sem = (radial != 0).astype(np.float32)
        return (torch.as_tensor(sem, device=self.device),
                torch.as_tensor(radial, device=self.device))


def _read_eval_cad_m(path):
    """Read the eval-path ``<class>.ply`` CAD cloud in METERS, guarded.

    The reference treats this file as meter-valued: ``max_radii_dm`` is
    computed from the raw vertex values against the (meter) keypoints
    (AccumulatorSpace.py:544-549) and the model is scaled ``xyz_load*1000``
    into mm for ADD (:663-667). This is the opposite convention from the
    train-path ``mesh.ply`` (millimeters). The guard catches a mm-valued
    file loudly instead of silently collapsing the radius clip and
    shrinking ADD 1000x.
    """
    cad_m = readers.read_ply_points(path)
    extent = float(np.max(cad_m.max(axis=0) - cad_m.min(axis=0)))
    if not (0.03 <= extent <= 0.6):
        raise ValueError(
            f"{path}: largest extent {extent:.4g} is outside 0.03-0.6 m; the "
            "eval <class>.ply must be meter-valued (reference "
            "AccumulatorSpace.py:544-549, 663-667). An extent in the "
            "30-600 range means the file is millimeter-valued (that is the "
            "train-path mesh.ply convention, not this one).")
    return cad_m


def _per_kpt_max_radii_dm(cad_m, keypoints):
    """Per-keypoint radius clips: max distance from any CAD vertex to the
    keypoint, x10 into decimeters — both in meters, raw values
    (AccumulatorSpace.py:544-549)."""
    return np.array([
        np.linalg.norm(cad_m - keypoints[i + 1], axis=1).max() * 10.0
        for i in range(3)])


def _load_models(cfg, class_name, device):
    """Load one class's eval networks on ``device`` in
    ``cfg.compute_dtype``.

    3-net reference mode (``cfg.kpt_heads == 1``): one model per keypoint,
    from ``<model_dir>/<class>_pt<k>.pth.tar`` (reference layout,
    AccumulatorSpace.py:522), else the directory
    ``<model_dir>/<class>_pt<k>/``: the port's own ``--mode train`` output
    or the JAX package's orbax one.
    Fused mode (``cfg.kpt_heads > 1``): ONE multi-head checkpoint from the
    directory ``<model_dir>/<class>/``, or ``model_dir`` itself, in either
    format. The order is the JAX package's; ``checkpoint.
    import_torch_checkpoint`` tells the formats apart.
    """
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)

    def load(path):
        model = train_mod.build_model(cfg)
        checkpoint.load_model_weights(model,
                                      checkpoint.import_torch_checkpoint(path))
        return model.to(device=device, dtype=dtype,
                        memory_format=torch.channels_last).eval()

    if cfg.kpt_heads > 1:
        for cand in (os.path.join(cfg.model_dir, class_name), cfg.model_dir):
            if os.path.isdir(cand):
                return [load(cand)]
        raise FileNotFoundError(
            f"fused-mode checkpoint not found: neither "
            f"{os.path.join(cfg.model_dir, class_name)} nor {cfg.model_dir} "
            "is a checkpoint directory (the port's Checkpointer or an orbax "
            "one)")
    models = []
    for i in range(1, 4):
        torch_path = os.path.join(cfg.model_dir, f"{class_name}_pt{i}.pth.tar")
        dir_path = os.path.join(cfg.model_dir, f"{class_name}_pt{i}")
        if os.path.exists(torch_path):
            models.append(load(torch_path))
        elif os.path.isdir(dir_path):
            models.append(load(dir_path))
        else:
            raise FileNotFoundError(
                f"neither {torch_path} (reference ckpt layout, "
                f"AccumulatorSpace.py:522) nor checkpoint dir {dir_path} "
                "(the port's --mode train output, or an orbax dir from the "
                "JAX package's) exists")
    return models


@torch.inference_mode()
def _frame_eval_seq(cfg, source, image, source_frame_id, depth, k,
                    max_radii, sem_threshold, gt_kpts_mm, cad, rt_gt_mm,
                    sym, lmo=False, icp_iters=30, timers=None, retry=True,
                    rel_fitness=None, rel_rmse=None):
    """One frame of the sequential eval loops: per-keypoint maps + voting,
    Horn, ADD, ICP, ADD.

    ``depth`` (H, W) mm, ``k`` (3, 3), ``cad`` (S, 3) mm: tensors on the
    evaluation device; ``max_radii`` (3,), ``gt_kpts_mm`` (3, 3) and
    ``rt_gt_mm`` (3, 4, translation in mm): arrays. ``lmo`` selects the
    LMO maps. ``retry``: the LM/LMO host-side grid-overflow retry (the
    YCB loop has none, reference :1049-1070). ``icp_iters`` /
    ``rel_fitness`` / ``rel_rmse``: the ICP criteria (``refine_and_add``).
    ``timers``: optional ``StageTimers`` accruing 'net'/'acc' stage time,
    each stage ending in a synchronize of the device. Returns (rt, score_bf,
    score_af, retried, still_overflowed).
    """
    if timers is None:
        timers = StageTimers()
    dev = depth.device

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    centers, scene_parts, scene_masks = [], [], []
    retried = [False]
    still_overflowed = False
    for kp in range(1, 4):
        with timers.time("net", dev):
            sem_map, radial_map = source.maps(kp, image, source_frame_id,
                                              lmo=lmo)
        with timers.time("acc", dev):
            args = (sem_map, radial_map, depth, k, put(max_radii[kp - 1]),
                    put(sem_threshold))
            if retry:
                center, overflow, _, pts_mm, mask = keypoint_with_retry(
                    cfg, *args, on_retry=lambda: retried.__setitem__(0, True))
            else:
                center, overflow, _, pts_mm, mask = keypoint_from_maps(
                    *args, grid_l=cfg.vote_grid_l, **_keypoint_kw(cfg))
        still_overflowed = still_overflowed or bool(overflow)
        centers.append(center)
        scene_parts.append(pts_mm)
        scene_masks.append(mask)
    rt_gt = put(rt_gt_mm)
    rt, score_bf = pose_and_add(put(gt_kpts_mm), torch.stack(centers), cad,
                                rt_gt, sym)
    _, score_af = refine_and_add(
        rt, cad, torch.cat(scene_parts), torch.cat(scene_masks), rt_gt, sym,
        torch.clamp(score_bf, min=1e-3), icp_iters=icp_iters,
        rel_fitness=rel_fitness, rel_rmse=rel_rmse)
    return rt, float(score_bf), float(score_af), retried[0], still_overflowed


def _dp_mesh_or_none(cfg, device=None):
    """The mesh of the data-parallel sweep, or None for the sequential
    loop. Auto (``eval_data_parallel=None``): on when this process has
    more than one local card.

    Under a process group of several ranks every process sweeps a
    disjoint shard of the frames (``_proc_shard``) and the per-class
    metrics are reduced on the host (``_finalize_class_results``); the
    mesh is then the process's own devices, with no collective inside
    the frame program, and a process with one card sweeps its shard
    sequentially. An explicit ``eval_data_parallel=True`` is honoured by
    the process sharding there. On one process with one device it
    cannot be honoured and raises, as the JAX package does."""
    dp = cfg.eval_data_parallel
    if dp is False:
        return None
    devices = parallel.local_devices(device)
    if parallel.process_count() > 1:
        return parallel.local_data_mesh(device) if len(devices) > 1 \
            else None
    if len(devices) < 2:
        if dp is True:
            raise ValueError(
                "--eval_data_parallel requested but only "
                f"{len(devices)} device is visible")
        return None
    return parallel.local_data_mesh(device)


def _proc_shard(items):
    """This process's slice of a frame list, round-robin by rank; the
    whole list on one process."""
    n = parallel.process_count()
    if n == 1:
        return items
    return items[parallel.process_index()::n]


def _finalize_class_results(res):
    """Finish one class's results dict: the cross-process reduction, then
    the raw counters go.

    On one process the raw counters are stripped and nothing else
    changes. Under a process group every process sums every process's
    raw counters (each swept a disjoint shard) with a host allgather of a
    fixed-key vector and a presence mask (the data-parallel and the
    sequential sweeps report different raw keys, and processes may mix
    them) and recomputes the derived metrics, so every process returns
    the global per-class numbers. A collective: every process calls it
    once per class, in the same class order. Stage times are summed
    across processes before the per-frame division."""
    raw = ["bf_count", "af_count", "frames", "overflow_frames",
           "overflow_after_retry", "frame_total_ms", "net_total_ms",
           "acc_total_ms", "decode_total_ms", "data_parallel"]
    out = dict(res)
    if parallel.process_count() > 1:
        vec = np.array(
            [float(res.get(k, 0.0)) for k in raw]
            + [1.0 if k in res else 0.0 for k in raw], np.float32)
        tot = parallel.host_allgather(vec).sum(axis=0)
        out.update({k: float(tot[i]) for i, k in enumerate(raw)
                    if tot[len(raw) + i] > 0})
        n = max(int(round(out["frames"])), 1)
        out["frames"] = int(round(out["frames"]))
        out["add_before_icp"] = out["bf_count"] / n
        out["add_after_icp"] = out["af_count"] / n
        for total_key, per_key in (
                ("frame_total_ms", "frame_ms_per_frame"),
                ("net_total_ms", "net_ms_per_frame"),
                ("acc_total_ms", "acc_ms_per_frame"),
                ("decode_total_ms", "decode_ms_per_frame_overlapped")):
            if total_key in out:
                out[per_key] = out[total_key] / n
        for key in ("overflow_frames", "overflow_after_retry",
                    "data_parallel"):
            if key in out:
                out[key] = int(round(out[key]))
        out["eval_processes"] = parallel.process_count()
    for k in raw:
        if k not in ("frames", "overflow_frames", "overflow_after_retry",
                     "data_parallel"):
            out.pop(k, None)
    return out


def _prefetched_chunks(items, chunk_size, load_one, timers=None, stats=None):
    """Yield ``(n_real, padded_chunk, loaded)`` chunks with the NEXT
    chunk's host file IO running in a background thread while the caller
    computes on the current one. The last chunk is padded by repeating its
    final item (and its decoded object).

    If the consumer abandons the generator mid-sweep (an exception in its
    loop body, or an early break), the ``finally`` block sets a
    cancellation flag; every producer-side put, the final sentinel
    included, polls that flag, so the producer exits instead of leaking a
    thread plus a decoded chunk per aborted sweep.

    ``timers``: optional ``StageTimers``; decode wall time accrues under
    ``"decode"`` (producer-thread time that overlaps the compute, reported
    separately).

    ``stats``: optional dict; the producer appends each chunk's decode
    interval to ``stats["decode"]`` and the generator each consumer
    processing interval (yield -> next get) to ``stats["consume"]``, both
    as ``(t0, t1)`` ``time.perf_counter`` pairs. Their pairwise
    intersection is the decode time that ran while the consumer computed
    (``scripts.bench_eval_prefetch``).
    """
    q = queue.Queue(maxsize=1)
    cancelled = threading.Event()

    def put_or_cancel(obj):
        while not cancelled.is_set():
            try:
                q.put(obj, timeout=0.05)
                return
            except queue.Full:
                continue

    def produce():
        try:
            for c0 in range(0, len(items), chunk_size):
                if cancelled.is_set():
                    return
                chunk = items[c0:c0 + chunk_size]
                padded = chunk + [chunk[-1]] * (chunk_size - len(chunk))
                t_dec = time.perf_counter()
                if timers is not None:
                    with timers.time("decode"):
                        loaded = [load_one(it) for it in chunk]
                else:
                    loaded = [load_one(it) for it in chunk]
                if stats is not None:
                    stats.setdefault("decode", []).append(
                        (t_dec, time.perf_counter()))
                loaded = loaded + [loaded[-1]] * (chunk_size - len(chunk))
                put_or_cancel((len(chunk), padded, loaded))
        except BaseException as exc:  # surfaced in the consumer
            put_or_cancel(exc)
        else:
            put_or_cancel(None)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            got = q.get()
            if got is None:
                return
            if isinstance(got, BaseException):
                raise got
            if stats is None:
                yield got
            else:
                t0 = time.perf_counter()
                yield got
                stats.setdefault("consume", []).append(
                    (t0, time.perf_counter()))
    finally:
        cancelled.set()
        try:  # unblock a producer parked on q.put
            q.get_nowait()
        except queue.Empty:
            pass


def _seq_timer_ms(timers, counter):
    """Per-frame stage times (ms) of the sequential loop: net and acc,
    each ending in a synchronize, plus the overlapped background decode
    (reported separately: it is not additive per-frame latency)."""
    n = max(counter, 1)
    tot = lambda stage: timers.totals.get(stage, 0) / 1e6  # noqa: E731
    return {"net_ms_per_frame": tot("net") / n,
            "acc_ms_per_frame": tot("acc") / n,
            "decode_ms_per_frame_overlapped": tot("decode") / n,
            "net_total_ms": tot("net"), "acc_total_ms": tot("acc"),
            "decode_total_ms": tot("decode")}


def _seq_timer_line(name, res):
    return (f"{name} per-frame time: net {res['net_ms_per_frame']:.1f} ms, "
            f"accumulator {res['acc_ms_per_frame']:.1f} ms "
            f"(+{res['decode_ms_per_frame_overlapped']:.1f} ms decode, "
            f"overlapped)")


def _dataset_eval_cfg(cfg):
    """Offline-dataset default vote knob: the saturated hier ``topk=64``
    unless the user set one (serving keeps 32 for latency)."""
    if cfg.vote_topk is None:
        return dataclasses.replace(cfg, vote_topk=64)
    return cfg


def _demo_dir(cfg, kind, class_name):
    """Where a loop writes its overlays (``out_dir/<kind>/<class>``), or
    None without ``demo_mode``."""
    if not cfg.demo_mode:
        return None
    return os.path.join(cfg.out_dir, kind, class_name)


def _linemod_class(cfg, class_name, device):
    """The LINEMOD-tree data of one class that the LM and LMO loops share:
    (CAD (m), keypoints, max radii (dm), map source, sym, ADD threshold
    (mm))."""
    root_pv = os.path.join(cfg.root_dataset, "LINEMOD", class_name)
    cad_m = _read_eval_cad_m(os.path.join(root_pv, f"{class_name}.ply"))
    keypoints = np.load(os.path.join(root_pv, "Outside9.npy"))
    models = (_load_models(cfg, class_name, device) if cfg.using_ckpts
              else None)
    return (cad_m, keypoints, _per_kpt_max_radii_dm(cad_m, keypoints),
            RadialMapSource(cfg, class_name, models, device),
            class_name in LM_SYMS, ADD_THRESHOLD[class_name] * 1000.0)


def _sweep_class(cfg, class_name, source, frames, k, cad_m, keypoints,
                 max_radii, sym, threshold_mm, sem_threshold, icp_iters,
                 progress, lmo=False, demo_dir=None):
    """One LM or LMO class's sequential sweep. ``frames``: [(source frame
    id, progress name, overlay name, loader)], where ``loader()`` returns
    (image or None, depth (H, W) f32 mm, rt_gt (3, 4) translation in m).
    Returns the class's results dict."""
    device = k.device
    cad_mm = cad_m * 1000.0  # mm for ADD/ICP (reference :663-667)
    cad = torch.as_tensor(cad_mm.astype(np.float32), device=device)
    gt_kpts_mm = keypoints[1:4] * 1000.0
    bf_icp = af_icp = counter = overflow_count = 0
    overflow_after_retry = 0
    timers = StageTimers()
    for _, padded, loaded in _prefetched_chunks(
            frames, 1, lambda it: it[3](), timers=timers):
        frame_id, name, demo_name, _ = padded[0]
        image, depth, rt_gt = loaded[0]
        rt_gt_mm = rt_gt.copy()
        rt_gt_mm[:, 3] *= 1000.0
        rt, score_bf, score_af, retried, still = _frame_eval_seq(
            cfg, source, image, frame_id,
            torch.as_tensor(depth, device=device), k, max_radii,
            sem_threshold, gt_kpts_mm, cad, rt_gt_mm, sym, lmo=lmo,
            icp_iters=icp_iters, timers=timers)
        overflow_count += retried
        overflow_after_retry += still
        bf_icp += score_bf <= threshold_mm
        af_icp += score_af <= threshold_mm
        counter += 1
        progress(f"{class_name} {name}: ADD(s) "
                 f"bf={bf_icp / counter:.4f} af={af_icp / counter:.4f}")
        if demo_dir is not None:
            # estimate (red) + GT (blue) overlays, headless PNGs — the
            # reference's blocking matplotlib/Open3D windows
            # (AccumulatorSpace.py:670-683, 716-717, 899-948) as files
            demo.save_demo_frame(
                demo_dir, demo_name, image, cad_mm, rt.cpu().numpy(),
                k.cpu().numpy(), rt_gt_mm=rt_gt_mm, depth_mm=depth,
                scene_ply=cfg.demo_scene_ply)
    return _finalize_class_results({
        "add_before_icp": bf_icp / max(counter, 1),
        "add_after_icp": af_icp / max(counter, 1),
        "frames": counter,
        "overflow_frames": overflow_count,
        "overflow_after_retry": overflow_after_retry,
        "bf_count": bf_icp, "af_count": af_icp,
        **_seq_timer_ms(timers, counter),
        "vote_topk": cfg.vote_topk,
    })


def _source_net(cfg, source):
    """The networks a data-parallel chunk runs (one fused network or a
    tuple of three), or None on a map route."""
    models = getattr(source, "models", None)
    if not cfg.using_ckpts or models is None:
        return None
    return models[0] if cfg.kpt_heads > 1 else tuple(models)


def _dp_chunk_scores(mesh, source, net, images, frame_ids, depths,
                     rt_gts_mm, ks, mr, gt, cad, sym, kw, lmo=None):
    """One mesh-sized chunk through ``parallel.sharded_frame_scores``, the
    network-or-maps dispatch shared by the LM/LMO and YCB sweeps: with
    ``net`` the images are normalized on the first slot and the slots run
    the forward; without, ``source.maps`` per keypoint are stacked
    (``lmo`` passed on when not None: the YCB sources take none). Returns
    after the slots' devices have finished."""
    dev = mesh.devices[0]

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    args = (put(depths), put(rt_gts_mm), put(ks), mr, gt, cad, sym)
    if net is not None:
        imgs = labels.normalize_image(
            torch.as_tensor(np.stack(images), device=dev))
        scores = parallel.sharded_frame_scores(mesh, net, imgs, *args, **kw)
    else:
        maps_kw = {} if lmo is None else {"lmo": lmo}
        sems, radials = [], []
        for frame_id, image in zip(frame_ids, images):
            pairs = [source.maps(kp, image, frame_id, **maps_kw)
                     for kp in range(1, 4)]
            sems.append(torch.stack([s for s, _ in pairs]).to(dev))
            radials.append(torch.stack([r for _, r in pairs]).to(dev))
        scores = parallel.sharded_frame_scores(
            mesh, None, (torch.stack(sems), torch.stack(radials)), *args,
            **kw)
    for d in mesh.devices:
        synchronize(d)
    return scores


def _eval_lm_class_dp(cfg, class_name, source, frames, k, cad_m, keypoints,
                      max_radii, sym, threshold_mm, sem_threshold, icp_iters,
                      progress, lmo=False, demo_dir=None, mesh=None):
    """One LM or LMO class's sweep, data-parallel over ``mesh`` (the
    arguments of ``_sweep_class``). Chunks of mesh-size frames run
    ``parallel.sharded_frame_scores``; the last chunk is padded by its
    final frame (padded outputs dropped). A frame whose vote grid
    overflowed re-runs through the sequential grid retry, timed inside
    the frame. Returns the finalized per-class results, the frame
    program's time as ``frame_ms_per_frame``."""
    device = mesh.devices[0]
    b = mesh.size
    kw = _vote_kw(cfg)
    kw.update(sem_threshold=sem_threshold, icp_iters=icp_iters)
    net = _source_net(cfg, source)
    cad_mm = cad_m * 1000.0
    cad = torch.as_tensor(cad_mm.astype(np.float32), device=device)
    gt_kpts_mm = keypoints[1:4] * 1000.0

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    gt, mr = put(gt_kpts_mm), put(max_radii)
    ks = np.tile(k.cpu().numpy()[None], (b, 1, 1))
    bf_icp = af_icp = counter = overflow_count = overflow_after_retry = 0
    frame_ns = 0
    timers = StageTimers()
    for n_real, padded, loaded in _prefetched_chunks(
            frames, b, lambda it: it[3](), timers=timers):
        depths = np.stack([d for _, d, _ in loaded])
        rt_gts_mm = np.stack([p for _, _, p in loaded]).astype(np.float64)
        rt_gts_mm[:, :, 3] *= 1000.0
        t0 = time.perf_counter_ns()
        scores = _dp_chunk_scores(
            mesh, source, net, [im for im, _, _ in loaded],
            [f[0] for f in padded], depths, rt_gts_mm, ks, mr, gt, cad, sym,
            kw, lmo=lmo)
        frame_ns += time.perf_counter_ns() - t0
        sbf = scores["score_bf"].cpu().numpy()
        saf = scores["score_af"].cpu().numpy()
        rts = scores["rt"].cpu().numpy()
        overflowed = scores["overflow"].cpu().numpy().reshape(b, -1).any(1)
        for i in range(n_real):
            frame_id, name, demo_name, _ = padded[i]
            image, depth, _ = loaded[i]
            rt_i, sbf_i, saf_i = rts[i], float(sbf[i]), float(saf[i])
            if overflowed[i]:
                # the sequential grid retry is part of this frame's cost
                t1 = time.perf_counter_ns()
                rt_t, sbf_i, saf_i, _, still = _frame_eval_seq(
                    cfg, source, image, frame_id,
                    torch.as_tensor(depth, device=device), k, max_radii,
                    sem_threshold, gt_kpts_mm, cad, rt_gts_mm[i], sym,
                    lmo=lmo, icp_iters=icp_iters)
                frame_ns += time.perf_counter_ns() - t1
                rt_i = rt_t.cpu().numpy()
                overflow_count += 1
                overflow_after_retry += still
            bf_icp += sbf_i <= threshold_mm
            af_icp += saf_i <= threshold_mm
            counter += 1
            progress(f"{class_name} {name}: ADD(s) "
                     f"bf={bf_icp / counter:.4f} af={af_icp / counter:.4f}")
            if demo_dir is not None:
                demo.save_demo_frame(
                    demo_dir, demo_name, image, cad_mm, rt_i,
                    k.cpu().numpy(), rt_gt_mm=rt_gts_mm[i], depth_mm=depth,
                    scene_ply=cfg.demo_scene_ply)
    n = max(counter, 1)
    decode_ms = timers.totals.get("decode", 0) / 1e6
    return _finalize_class_results({
        "add_before_icp": bf_icp / n,
        "add_after_icp": af_icp / n,
        "frames": counter,
        "frame_ms_per_frame": frame_ns / n / 1e6,
        "decode_ms_per_frame_overlapped": decode_ms / n,
        "overflow_frames": overflow_count,
        "overflow_after_retry": overflow_after_retry,
        "vote_topk": cfg.vote_topk,
        "data_parallel": b,
        "bf_count": int(bf_icp), "af_count": int(af_icp),
        "frame_total_ms": frame_ns / 1e6,
        "decode_total_ms": decode_ms,
    })


def _class_sweep(dp_mesh):
    """The LM/LMO per-class sweep: data-parallel over ``dp_mesh``, or the
    sequential loop without one."""
    if dp_mesh is None:
        return _sweep_class
    return partial(_eval_lm_class_dp, mesh=dp_mesh)


def _timer_line(name, res, dp_mesh):
    if dp_mesh is None:
        return _seq_timer_line(name, res)
    return (f"{name} per-frame time (data-parallel frame program): "
            f"{res['frame_ms_per_frame']:.1f} ms over {dp_mesh.size} "
            f"devices")


def estimate_6d_pose_lm(cfg, class_names=None, max_frames=None,
                        progress=print, device=None):
    """LINEMOD evaluation (reference :495-740). Returns per-class results:
    ``add_before_icp``, ``add_after_icp``, ``frames``,
    ``overflow_frames``, ``overflow_after_retry``, the per-frame stage
    times and ``vote_topk``. ``demo_mode`` writes overlays under
    ``out_dir/demo/<class>``.

    ``device``: None runs on the CUDA card and raises without one;
    ``"cpu"`` runs on the CPU through the kernels' plain versions. With
    more than one local card (or ``eval_data_parallel``) the sweep is
    data-parallel (``_eval_lm_class_dp``: ``frame_ms_per_frame`` and
    ``data_parallel`` in place of the stage times); under a process group
    each process sweeps its shard and the results are global.
    """
    dp_mesh = _dp_mesh_or_none(cfg, device)
    sweep = _class_sweep(dp_mesh)
    device = resolve_device(device)
    cfg = _dataset_eval_cfg(cfg)
    results = {}
    class_names = class_names or LM_CLASS_NAMES
    k = torch.tensor(geometry.LINEMOD_K, dtype=torch.float32, device=device)
    read_image = cfg.using_ckpts or cfg.demo_mode

    for class_name in class_names:
        progress(f"Evaluation on {class_name}")
        root_orig = os.path.join(cfg.root_dataset, "LINEMOD_ORIG", class_name)
        root_pv = os.path.join(cfg.root_dataset, "LINEMOD", class_name)
        with open(os.path.join(root_pv, "Split", "val.txt")) as f:
            test_ids = {line.strip() for line in f if line.strip()}
        cad_m, keypoints, max_radii, source, sym, threshold_mm = \
            _linemod_class(cfg, class_name, device)

        frame_ids = sorted(
            os.path.splitext(fn)[0]
            for fn in os.listdir(os.path.join(root_pv, "JPEGImages"))
            if fn.endswith(".jpg") and os.path.splitext(fn)[0] in test_ids)
        if max_frames:
            frame_ids = frame_ids[:max_frames]
        frame_ids = _proc_shard(frame_ids)

        def load_frame(frame_id):
            rt_gt = np.load(os.path.join(
                root_pv, "pose", f"pose{int(frame_id)}.npy"))
            depth = readers.read_depth(os.path.join(
                root_orig, "data", f"depth{int(frame_id)}.dpt"))
            image = None
            if read_image:
                image = readers.read_image(os.path.join(
                    root_pv, "JPEGImages", f"{frame_id}.jpg"))
            return image, depth.astype(np.float32), rt_gt

        frames = [(fid, fid, fid, partial(load_frame, fid))
                  for fid in frame_ids]
        results[class_name] = res = sweep(
            cfg, class_name, source, frames, k, cad_m, keypoints, max_radii,
            sym, threshold_mm, cfg.sem_threshold, cfg.icp_iters, progress,
            demo_dir=_demo_dir(cfg, "demo", class_name))
        progress(f"ADD(s) of {class_name}: before ICP "
                 f"{res['add_before_icp']:.4f}, after ICP "
                 f"{res['add_after_icp']:.4f}")
        progress(_timer_line(class_name, res, dp_mesh))
    return results


def estimate_6d_pose_lmo(cfg, class_names=None, max_frames=None,
                         progress=print, device=None):
    """Occlusion-LINEMOD evaluation (reference :742-974): the LM per-frame
    engine on frames from ``OCCLUSION_LINEMOD/RGB-D/{rgb,depth}_noseg``
    (``color_<N>.png``, ``depth_<N>.png``), GT poses from
    ``blender_poses/<class>/pose<N>.npy`` (frames without one are skipped
    and not counted, :813-822), precomputed maps ``_<NNNNN>.npy`` under
    ``OCCLUSION_LINEMOD/estRadialMap``, sem threshold 0.5 and 30 ICP
    iterations whatever ``cfg`` says (:837, :940-942). The CAD models,
    keypoints and networks are the LINEMOD class's (:769-772). Returns
    per-class results with the LM keys; ``demo_mode`` writes overlays
    under ``out_dir/demo_lmo/<class>``.

    ``device``: None runs on the CUDA card and raises without one;
    ``"cpu"`` runs on the CPU through the kernels' plain versions.
    Data-parallel and process-sharded as ``estimate_6d_pose_lm``.
    """
    dp_mesh = _dp_mesh_or_none(cfg, device)
    sweep = _class_sweep(dp_mesh)
    device = resolve_device(device)
    cfg = _dataset_eval_cfg(cfg)
    results = {}
    class_names = class_names or LMO_CLASS_NAMES
    root_occ = os.path.join(cfg.root_dataset, "OCCLUSION_LINEMOD")
    rgb_dir = os.path.join(root_occ, "RGB-D", "rgb_noseg")
    depth_dir = os.path.join(root_occ, "RGB-D", "depth_noseg")
    k = torch.tensor(geometry.LINEMOD_K, dtype=torch.float32, device=device)
    read_image = cfg.using_ckpts or cfg.demo_mode

    def load_lmo(frame_num, pose_path):
        rt_gt = np.load(pose_path)
        depth = readers.read_depth(os.path.join(
            depth_dir, f"depth_{frame_num:05d}.png"))
        image = None
        if read_image:
            image = readers.read_image(os.path.join(
                rgb_dir, f"color_{frame_num:05d}.png"))
        return image, depth.astype(np.float32), rt_gt

    for class_name in class_names:
        progress(f"Evaluation on {class_name} (occlusion)")
        cad_m, keypoints, max_radii, source, sym, threshold_mm = \
            _linemod_class(cfg, class_name, device)
        # strict color_NNNNN.png filter: a stray .png (preview.png, editor
        # backup) would otherwise crash the int() frame-number parse
        names = sorted(fn for fn in os.listdir(rgb_dir)
                       if re.fullmatch(r"color_\d+\.png", fn))
        if max_frames:
            names = names[:max_frames]
        frames = []
        for filename in names:
            frame_num = int(os.path.splitext(filename)[0][6:])
            pose_path = os.path.join(root_occ, "blender_poses", class_name,
                                     f"pose{frame_num}.npy")
            if os.path.isfile(pose_path):  # reference pose-skip :813-822
                frames.append((f"_{frame_num:05d}", filename,
                               f"{frame_num:05d}",
                               partial(load_lmo, frame_num, pose_path)))
        frames = _proc_shard(frames)
        results[class_name] = res = sweep(
            cfg, class_name, source, frames, k, cad_m, keypoints, max_radii,
            sym, threshold_mm, LMO_SEM_THRESHOLD, LMO_ICP_ITERS, progress,
            lmo=True, demo_dir=_demo_dir(cfg, "demo_lmo", class_name))
        progress(f"ADD(s) of {class_name} (occ): before ICP "
                 f"{res['add_before_icp']:.4f}, after ICP "
                 f"{res['add_after_icp']:.4f}")
        progress(_timer_line(class_name, res, dp_mesh))
    return results


def _ycb_icp_kw(cfg):
    """The YCB evaluator's ICP criteria.

    The reference's YCB loop, unlike LM/LMO's 30 iterations, runs ICP to
    convergence: ``max_iteration=2_000_000`` with relative fitness/RMSE
    tolerances 1e-6 (AccumulatorSpace.py:1165-1169). Here: the same
    tolerance semantics (``icp_rel_tol``) under a ``ycb_icp_max_iters``
    cap; ``ycb_icp_converged=False`` falls back to the fixed
    ``icp_iters``."""
    if cfg.ycb_icp_converged:
        tol = cfg.icp_rel_tol
        return dict(icp_iters=int(cfg.ycb_icp_max_iters), rel_fitness=tol,
                    rel_rmse=tol)
    return dict(icp_iters=cfg.icp_iters)


def _ycb_class_frames(root, class_name, class_id, max_frames, sio):
    """One YCB class's frames: the HDF5 ``JPEGImages`` keys in h5py's
    (name) order, filtered by ``Split/<class>/val.txt``, and their
    ``.mat`` metadata read up front; frames whose ``cls_indexes`` lack the
    class are skipped. Under a process group each process takes its
    shard of the frames (``_proc_shard``). Returns [(filename, rt_gt
    (3, 4) m, k (3, 3) f32, factor_depth)]."""
    with open(os.path.join(root, "Split", class_name, "val.txt")) as f:
        test_ids = {line.strip() for line in f if line.strip()}
    frames = [fn for fn in readers.hdf5_group_keys(
        os.path.join(root, f"{class_name}.hdf5"), "JPEGImages")
        if fn in test_ids]
    if max_frames:
        frames = frames[:max_frames]
    metas = []
    for filename in _proc_shard(frames):
        cycle, idx = filename.split("_")
        meta = sio.loadmat(os.path.join(root, "data", cycle, f"{idx}.mat"))
        sel = np.where(meta["cls_indexes"].ravel() == class_id)[0]
        if sel.size == 0:
            continue
        metas.append((filename, meta["poses"][:, :, sel[0]],
                      np.asarray(meta["intrinsic_matrix"], np.float32),
                      float(np.asarray(meta["factor_depth"]).ravel()[0])))
    return metas


def _eval_ycb_frames_dp(cfg, mesh, source, metas, load_one, max_radii,
                        gt_kpts_mm, cad, sym, timers=None):
    """One YCB class's frames, data-parallel over ``mesh``: mesh-sized
    chunks through ``parallel.sharded_frame_scores`` with each frame's
    own intrinsics, the converged ICP of ``_ycb_icp_kw`` and no overflow
    retry (the sequential YCB loop has none). ``load_one(meta)`` returns
    (image, depth mm). Returns (rows, ns): rows = [(filename, image,
    rt_gt_mm, k, rt, score_bf, score_af, depth or None)] in frame order
    (the depth kept only for scene-PLY overlays), ns the frame program's
    time."""
    device = mesh.devices[0]
    b = mesh.size
    kw = _vote_kw(cfg)
    kw.update(_ycb_icp_kw(cfg))
    net = _source_net(cfg, source)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    gt, mr = put(gt_kpts_mm), put(max_radii)
    keep_depth = cfg.demo_mode and cfg.demo_scene_ply
    rows, ns = [], 0
    for n_real, padded, loaded in _prefetched_chunks(
            metas, b, load_one, timers=timers):
        depths = np.stack([d for _, d in loaded])
        ks = np.stack([m[2] for m in padded])
        rt_gts_mm = np.stack([m[1] for m in padded]).astype(np.float64)
        rt_gts_mm[:, :, 3] *= 1000.0
        t0 = time.perf_counter_ns()
        scores = _dp_chunk_scores(
            mesh, source, net, [im for im, _ in loaded],
            [m[0] for m in padded], depths, rt_gts_mm, ks, mr, gt, cad, sym,
            kw)
        ns += time.perf_counter_ns() - t0
        sbf = scores["score_bf"].cpu().numpy()
        saf = scores["score_af"].cpu().numpy()
        rts = scores["rt"].cpu().numpy()
        for i in range(n_real):
            rows.append((padded[i][0], loaded[i][0], rt_gts_mm[i],
                         padded[i][2], rts[i], float(sbf[i]), float(saf[i]),
                         loaded[i][1] if keep_depth else None))
    return rows, ns


def estimate_6d_pose_ycb(cfg, class_ids=None, max_frames=None,
                         progress=print, map_source_factory=None,
                         device=None):
    """YCB-Video evaluation (reference :976-1197), the sequential sweep.

    Layout: <root>/Split/<class>/val.txt, <root>/models/<class>/points.xyz +
    Outside9.npy, <root>/<class>.hdf5 (JPEGImages keys '<cycle>_<idx>'),
    <root>/data/<cycle>/<idx>.mat (poses, cls_indexes, factor_depth,
    intrinsic_matrix) and <idx>-{color,depth}.png; the HDF5 file is read
    only for its ``JPEGImages`` names (``readers.hdf5_group_keys``: h5py,
    or the port's own reader without it). Per frame: the frame's
    own intrinsics, depth ``png / factor_depth * 1000`` mm, the keypoint
    vote at ``cfg.vote_grid_l`` and ``cfg.sem_threshold`` with no overflow
    retry (:1049-1070), the converged ICP of ``_ycb_icp_kw``, and a pass
    at 1% of the oriented bounding box's diagonal. Returns ``{"all":
    ...}`` with the ADD(-S) AUCs over ``YCB_AUC_THRESHOLDS``
    (``adds_auc_before_icp``/``_after_icp``), the pass rates, ``frames``,
    ``vote_topk`` and the per-frame stage times; ``demo_mode`` writes
    overlays under ``out_dir/demo_ycb/<class>``.

    YCB has NO precomputed-radial-map branch (the reference YCB loop always
    runs the network, :1044): ``using_ckpts=False`` raises unless
    ``map_source_factory(cfg, class_name) -> source`` is given, a test
    seam whose ``maps(kpt_idx, image_u8, frame_id)`` returns f32 tensors
    on the evaluation device. Reference quirks not reproduced, as in the
    JAX package: keypoints[1:4] in the Horn fit, depth pixels aligned with
    radial values, radial maps clipped by the per-keypoint max radius.

    ``device``: None runs on the CUDA card and raises without one;
    ``"cpu"`` runs on the CPU through the kernels' plain versions.
    """
    try:
        import scipy.io as sio
    except ImportError as exc:
        raise ImportError("estimate_6d_pose_ycb reads the YCB-Video .mat "
                          "metadata with scipy.io; install scipy") from exc
    cfg = _dataset_eval_cfg(cfg)
    if not cfg.using_ckpts and map_source_factory is None:
        raise ValueError(_NO_YCB_MAPS)
    dp_mesh = _dp_mesh_or_none(cfg, device)
    device = resolve_device(device)
    root = cfg.root_dataset
    scores_bf, scores_af = [], []
    bf_icp = af_icp = counter = 0
    dp_ns = 0
    timers = StageTimers()

    def load_rgbd(filename, factor):
        cycle, idx = filename.split("_")
        image = readers.read_image(os.path.join(
            root, "data", cycle, f"{idx}-color.png"))
        depth_png = readers.read_depth(os.path.join(
            root, "data", cycle, f"{idx}-depth.png"))
        return image, depth_png.astype(np.float32) / factor * 1000.0

    for class_id in class_ids or list(YCB_CLASS_NAMES):
        class_name = YCB_CLASS_NAMES[class_id]
        progress(f"Evaluation on {class_name}")
        model_dir = os.path.join(root, "models", class_name)
        cad_m = np.loadtxt(os.path.join(model_dir, "points.xyz"))[:, :3]
        keypoints = np.load(os.path.join(model_dir, "Outside9.npy"))
        corners = readers.oriented_bbox_corners(cad_m)
        bbox_diag_mm = float(np.linalg.norm(
            corners.max(axis=0) - corners.min(axis=0))) * 1000.0
        max_radii = _per_kpt_max_radii_dm(cad_m, keypoints)
        if map_source_factory is not None:
            source = map_source_factory(cfg, class_name)
        else:
            source = RadialMapSource(
                cfg, class_name, _load_models(cfg, class_name, device),
                device)
        sym = class_name in YCB_SYMS
        cad_mm = cad_m * 1000.0
        cad = torch.as_tensor(cad_mm.astype(np.float32), device=device)
        metas = _ycb_class_frames(root, class_name, class_id, max_frames,
                                  sio)
        demo_dir = _demo_dir(cfg, "demo_ycb", class_name)

        if dp_mesh is not None:
            rows, ns = _eval_ycb_frames_dp(
                cfg, dp_mesh, source, metas,
                lambda it: load_rgbd(it[0], it[3]), max_radii,
                keypoints[1:4] * 1000.0, cad, sym, timers=timers)
            dp_ns += ns
            for (filename, image, rt_gt_mm, k_np, rt, sbf, saf,
                 depth_row) in rows:
                scores_bf.append(sbf)
                scores_af.append(saf)
                bf_icp += sbf <= bbox_diag_mm * 0.01
                af_icp += saf <= bbox_diag_mm * 0.01
                counter += 1
                progress(f"{class_name} {filename}: "
                         f"bf={bf_icp / counter:.4f} "
                         f"af={af_icp / counter:.4f}")
                if demo_dir is not None:
                    demo.save_demo_frame(
                        demo_dir, filename, image, cad_mm, rt, k_np,
                        rt_gt_mm=rt_gt_mm, depth_mm=depth_row,
                        scene_ply=depth_row is not None)
            continue

        for _, padded, loaded in _prefetched_chunks(
                metas, 1, lambda it: load_rgbd(it[0], it[3]),
                timers=timers):
            filename, rt_gt, k_np, _ = padded[0]
            image, depth_mm = loaded[0]
            rt_gt_mm = rt_gt.copy()
            rt_gt_mm[:, 3] *= 1000.0
            rt, sbf, saf, _, _ = _frame_eval_seq(
                cfg, source, image, filename,
                torch.as_tensor(depth_mm, device=device),
                torch.as_tensor(k_np, device=device), max_radii,
                cfg.sem_threshold, keypoints[1:4] * 1000.0, cad, rt_gt_mm,
                sym, timers=timers, retry=False, **_ycb_icp_kw(cfg))
            scores_bf.append(sbf)
            scores_af.append(saf)
            bf_icp += sbf <= bbox_diag_mm * 0.01
            af_icp += saf <= bbox_diag_mm * 0.01
            counter += 1
            progress(f"{class_name} {filename}: "
                     f"bf={bf_icp / counter:.4f} af={af_icp / counter:.4f}")
            if demo_dir is not None:
                # the reference paints these in the YCB loop too
                # (:1121-1171)
                demo.save_demo_frame(
                    demo_dir, filename, image, cad_mm, rt.cpu().numpy(),
                    k_np, rt_gt_mm=rt_gt_mm, depth_mm=depth_mm,
                    scene_ply=cfg.demo_scene_ply)

    dp_ms = dp_ns / 1e6
    net_ms = timers.totals.get("net", 0) / 1e6
    acc_ms = timers.totals.get("acc", 0) / 1e6
    dec_ms = timers.totals.get("decode", 0) / 1e6
    any_dp, any_seq = dp_mesh is not None, dp_mesh is None
    dp_devices = 0 if dp_mesh is None else dp_mesh.size
    nproc = parallel.process_count()
    if nproc > 1:
        # every process swept a disjoint shard: the AUC needs every
        # process's per-frame scores, the counters and stage totals sum,
        # and the paths' presence reduces (fixed keys, as
        # _finalize_class_results), so every process reports the global
        # key set and numbers
        scores_bf = parallel.host_allgather_concat(scores_bf).tolist()
        scores_af = parallel.host_allgather_concat(scores_af).tolist()
        tot = parallel.host_allgather(np.array(
            [bf_icp, af_icp, counter, dp_ms, net_ms, acc_ms, dec_ms,
             float(any_dp), float(dp_devices), float(any_seq)],
            np.float32)).sum(axis=0)
        bf_icp, af_icp, counter = (int(round(float(v))) for v in tot[:3])
        dp_ms, net_ms, acc_ms, dec_ms = (float(v) for v in tot[3:7])
        any_dp, dp_devices, any_seq = (tot[7] > 0, int(round(float(tot[8]))),
                                       tot[9] > 0)
    auc_bf = metrics.auc_add(np.asarray(scores_bf) / 1000.0,
                             thresholds=YCB_AUC_THRESHOLDS)
    auc_af = metrics.auc_add(np.asarray(scores_af) / 1000.0,
                             thresholds=YCB_AUC_THRESHOLDS)
    n = max(counter, 1)
    res = {
        "adds_auc_before_icp": auc_bf, "adds_auc_after_icp": auc_af,
        "add_before_icp": bf_icp / n, "add_after_icp": af_icp / n,
        "frames": counter, "vote_topk": cfg.vote_topk,
        "decode_ms_per_frame_overlapped": dec_ms / n,
    }
    if nproc > 1:
        res["eval_processes"] = nproc
    progress(f"ADD(s) AUC before ICP: {auc_bf:.4f}, after ICP: {auc_af:.4f}")
    if any_dp:
        res["frame_ms_per_frame"] = dp_ms / n
        res["data_parallel"] = dp_devices
        progress(f"per-frame time (data-parallel frame program): "
                 f"{res['frame_ms_per_frame']:.1f} ms over {dp_devices} "
                 f"devices" + (f" across {nproc} processes" if nproc > 1
                               else ""))
    if any_seq:
        res["net_ms_per_frame"] = net_ms / n
        res["acc_ms_per_frame"] = acc_ms / n
        progress(_seq_timer_line("ycb", res))
    return {"all": res}
