"""Offline LINEMOD evaluation (counterpart of ``rcvpose_tpu.eval``, the LM
evaluator's sequential loop).

The reference evaluator (``AccumulatorSpace.py`` ``estimate_6d_pose_lm``
:495-740) per frame: network forward (or precomputed radial maps) -> sem
threshold + radius clip -> point packing -> radial voting per keypoint
(K1, with the host-side grid-overflow retry) -> Horn fit -> ADD(-S) ->
point-to-point ICP on the union scene cloud -> ADD(-S). File IO and image
decode are the only host work; the next frame's files are read in a
background thread (``_prefetched_chunks``) while this one computes.

Behavioural notes carried over from the JAX package: radial values and
scene points are aligned on pixels where ``sem AND depth > 0``; the ICP's
union cloud is concatenated, not deduplicated.

Divergences from the JAX package, each with a test:
* ``demo_mode=True`` and ``eval_data_parallel=True`` raise
  ``NotImplementedError``: the overlays (``demo.py``) and the
  data-parallel sweep are not ported yet; the JAX package would draw the
  overlays or shard the sweep.
* The frame loader decodes the JPEG only when a network reads it
  (``using_ckpts``). On the precomputed-map route the JAX loop decodes the
  image and never uses it; the results are the same.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading

import numpy as np
import torch

from rcvpose_tpu_torch import checkpoint, fit, geometry, labels, metrics
from rcvpose_tpu_torch import train as train_mod
from rcvpose_tpu_torch.data import readers
from rcvpose_tpu_torch.ops import voting
from rcvpose_tpu_torch.utils import StageTimers, resolve_device

# Class lists + symmetric sets + ADD thresholds (m): dataset constants from
# the reference (AccumulatorSpace.py:19-57).
LM_CLASS_NAMES = ["ape", "benchvise", "cam", "can", "cat", "duck", "driller",
                  "eggbox", "glue", "holepuncher", "iron", "lamp", "phone"]
LM_SYMS = ["eggbox", "glue"]
ADD_THRESHOLD = {
    "eggbox": 0.019735770122546523, "ape": 0.01421240983190395,
    "cat": 0.018594838977253875, "cam": 0.02222763033276377,
    "duck": 0.015569664208967385, "glue": 0.01930723067998101,
    "can": 0.028415044264086586, "driller": 0.031877906042,
    "holepuncher": 0.019606109985, "benchvise": 0.033091264970068,
    "iron": 0.03172344425531, "lamp": 0.03165980764376,
    "phone": 0.02543407135792,
}


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
    kn = dict(n_points=cfg.max_points, mode=cfg.vote_mode,
              topk=cfg.vote_topk, cpt_stride=cfg.vote_cpt_stride,
              win=cfg.vote_win)
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


class RadialMapSource:
    """Network-driven or precomputed radial/sem maps, per keypoint.

    The reference either runs one checkpoint per keypoint
    (AccumulatorSpace.py:520-530, 595-610) or loads precomputed
    ``estRadialMap/.../Out_pt<k>_dm/*.npy`` files (:612-618). With
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
        self._fused_cache = None  # (frame id, (seg (H,W,K), radial (H,W,K)))

    def _forward(self, model, image_u8):
        img = torch.tensor(np.asarray(image_u8), device=self.device)
        with torch.inference_mode():
            return model(labels.normalize_image(img)[None])

    def maps(self, kpt_idx, image_u8, frame_id):
        cfg = self.cfg
        if not cfg.using_ckpts and cfg.dataset == "ycb":
            raise ValueError(
                "YCB evaluation has no precomputed-radial-map path: the "
                "reference YCB loop always runs the network "
                "(AccumulatorSpace.py:1044 — only the LM/LMO evaluators "
                "have an estRadialMap branch). Re-run with using_ckpts "
                "and --model_dir pointing at the per-class checkpoints.")
        if cfg.using_ckpts:
            if cfg.kpt_heads > 1:
                if self._fused_cache is None or \
                        self._fused_cache[0] != frame_id:
                    seg, radial = self._forward(self.models[0], image_u8)
                    self._fused_cache = (frame_id, (seg[0], radial[0]))
                seg, radial = self._fused_cache[1]
                return seg[:, :, kpt_idx - 1], radial[:, :, kpt_idx - 1]
            seg, radial = self._forward(self.models[kpt_idx - 1], image_u8)
            return seg[0, :, :, 0], radial[0, :, :, 0]
        path = os.path.join(cfg.root_dataset, "LINEMOD_ORIG", "estRadialMap",
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
    AccumulatorSpace.py:522) or from the port's own ``--mode train`` output,
    a ``Checkpointer`` directory ``<model_dir>/<class>_pt<k>/``.
    Fused mode (``cfg.kpt_heads > 1``): ONE multi-head checkpoint from the
    ``Checkpointer`` directory ``<model_dir>/<class>/``, or ``model_dir``
    itself. Orbax directories are not read (``checkpoint``).
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
            "is a checkpoint directory")
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
                "(the port's --mode train output) exists")
    return models


@torch.inference_mode()
def _frame_eval_seq(cfg, source, image, source_frame_id, depth, k,
                    max_radii, sem_threshold, gt_kpts_mm, cad, rt_gt_mm,
                    sym, icp_iters=30, timers=None):
    """One frame of the sequential eval loop: per-keypoint maps + voting
    (with the host-side grid-overflow retry), Horn, ADD, ICP, ADD.

    ``depth`` (H, W) mm, ``k`` (3, 3), ``cad`` (S, 3) mm: tensors on the
    evaluation device; ``max_radii`` (3,), ``gt_kpts_mm`` (3, 3) and
    ``rt_gt_mm`` (3, 4, translation in mm): arrays. ``timers``: optional
    ``StageTimers`` accruing 'net'/'acc' stage time, each stage ending in a
    synchronize of the device. Returns (rt, score_bf, score_af, retried,
    still_overflowed).
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
            sem_map, radial_map = source.maps(kp, image, source_frame_id)
        with timers.time("acc", dev):
            center, overflow, _, pts_mm, mask = keypoint_with_retry(
                cfg, sem_map, radial_map, depth, k, put(max_radii[kp - 1]),
                put(sem_threshold),
                on_retry=lambda: retried.__setitem__(0, True))
        still_overflowed = still_overflowed or bool(overflow)
        centers.append(center)
        scene_parts.append(pts_mm)
        scene_masks.append(mask)
    rt_gt = put(rt_gt_mm)
    rt, score_bf = pose_and_add(put(gt_kpts_mm), torch.stack(centers), cad,
                                rt_gt, sym)
    _, score_af = refine_and_add(
        rt, cad, torch.cat(scene_parts), torch.cat(scene_masks), rt_gt, sym,
        torch.clamp(score_bf, min=1e-3), icp_iters=icp_iters)
    return rt, float(score_bf), float(score_af), retried[0], still_overflowed


def _finalize_class_results(res):
    """Finish one class's results dict (single process): strip the raw
    counters that the JAX package's multi-process reduction reads."""
    raw = ["bf_count", "af_count", "frame_total_ms", "net_total_ms",
           "acc_total_ms", "decode_total_ms"]
    return {k: v for k, v in res.items() if k not in raw}


def _prefetched_chunks(items, chunk_size, load_one, timers=None):
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
                if timers is not None:
                    with timers.time("decode"):
                        loaded = [load_one(it) for it in chunk]
                else:
                    loaded = [load_one(it) for it in chunk]
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
            yield got
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


def estimate_6d_pose_lm(cfg, class_names=None, max_frames=None,
                        progress=print, device=None):
    """LINEMOD evaluation (reference :495-740). Returns per-class results:
    ``add_before_icp``, ``add_after_icp``, ``frames``,
    ``overflow_frames``, ``overflow_after_retry``, the per-frame stage
    times and ``vote_topk``.

    ``device``: None runs on the CUDA card and raises without one;
    ``"cpu"`` runs on the CPU through the kernels' plain versions.
    """
    if cfg.demo_mode:
        raise NotImplementedError(
            "demo_mode overlays (demo.py) are not ported yet")
    if cfg.eval_data_parallel:
        raise NotImplementedError(
            "the data-parallel evaluation sweep is not ported yet; run "
            "with eval_data_parallel unset or False")
    device = resolve_device(device)
    cfg = _dataset_eval_cfg(cfg)
    results = {}
    class_names = class_names or LM_CLASS_NAMES
    k = torch.tensor(geometry.LINEMOD_K, dtype=torch.float32, device=device)

    for class_name in class_names:
        progress(f"Evaluation on {class_name}")
        root_orig = os.path.join(cfg.root_dataset, "LINEMOD_ORIG", class_name)
        root_pv = os.path.join(cfg.root_dataset, "LINEMOD", class_name)
        with open(os.path.join(root_pv, "Split", "val.txt")) as f:
            test_ids = {line.strip() for line in f if line.strip()}

        cad_m = _read_eval_cad_m(os.path.join(root_pv, f"{class_name}.ply"))
        keypoints = np.load(os.path.join(root_pv, "Outside9.npy"))
        max_radii = _per_kpt_max_radii_dm(cad_m, keypoints)
        models = (_load_models(cfg, class_name, device) if cfg.using_ckpts
                  else None)
        source = RadialMapSource(cfg, class_name, models, device)
        sym = class_name in LM_SYMS
        threshold_mm = ADD_THRESHOLD[class_name] * 1000.0
        cad = torch.as_tensor((cad_m * 1000.0).astype(np.float32),
                              device=device)  # mm (reference :663-667)

        frame_ids = sorted(
            os.path.splitext(fn)[0]
            for fn in os.listdir(os.path.join(root_pv, "JPEGImages"))
            if fn.endswith(".jpg") and os.path.splitext(fn)[0] in test_ids)
        if max_frames:
            frame_ids = frame_ids[:max_frames]
        gt_kpts_mm = keypoints[1:4] * 1000.0

        def load_frame(frame_id):
            rt_gt = np.load(os.path.join(
                root_pv, "pose", f"pose{int(frame_id)}.npy"))
            depth = readers.read_depth(os.path.join(
                root_orig, "data", f"depth{int(frame_id)}.dpt"))
            image = None
            if cfg.using_ckpts:  # only a network reads the image
                image = readers.read_image(os.path.join(
                    root_pv, "JPEGImages", f"{frame_id}.jpg"))
            return image, depth.astype(np.float32), rt_gt

        bf_icp = af_icp = counter = overflow_count = 0
        overflow_after_retry = 0
        timers = StageTimers()
        for _, padded, loaded in _prefetched_chunks(
                frame_ids, 1, load_frame, timers=timers):
            frame_id = padded[0]
            image, depth, rt_gt = loaded[0]
            rt_gt_mm = rt_gt.copy()
            rt_gt_mm[:, 3] *= 1000.0
            _, score_bf, score_af, retried, still = _frame_eval_seq(
                cfg, source, image, frame_id,
                torch.as_tensor(depth, device=device), k, max_radii,
                cfg.sem_threshold, gt_kpts_mm, cad, rt_gt_mm, sym,
                icp_iters=cfg.icp_iters, timers=timers)
            overflow_count += retried
            overflow_after_retry += still
            bf_icp += score_bf <= threshold_mm
            af_icp += score_af <= threshold_mm
            counter += 1
            progress(f"{class_name} {frame_id}: ADD(s) "
                     f"bf={bf_icp / counter:.4f} af={af_icp / counter:.4f}")

        results[class_name] = _finalize_class_results({
            "add_before_icp": bf_icp / max(counter, 1),
            "add_after_icp": af_icp / max(counter, 1),
            "frames": counter,
            "overflow_frames": overflow_count,
            "overflow_after_retry": overflow_after_retry,
            "bf_count": bf_icp, "af_count": af_icp,
            **_seq_timer_ms(timers, counter),
            "vote_topk": cfg.vote_topk,
        })
        progress(f"ADD(s) of {class_name}: before ICP "
                 f"{results[class_name]['add_before_icp']:.4f}, after ICP "
                 f"{results[class_name]['add_after_icp']:.4f}")
        progress(_seq_timer_line(class_name, results[class_name]))
    return results
