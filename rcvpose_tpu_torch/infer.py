"""Serving-path inference: whole-frame pose estimation (counterpart of
``rcvpose_tpu.infer``).

A frame runs the keypoint networks (three per-keypoint nets, or one fused
net with ``kpt_heads`` output pairs), thresholds and crops the maps,
back-projects and compacts the points once for all keypoints, votes for
every keypoint in one launch of each vote stage and closes the pose with
a Horn fit. Everything stays on the device; the one host read per frame is
the packed ``escalate`` vector that ``PoseEstimator`` checks.

``PoseEstimator`` is the serving API: ``estimate(image, depth)`` per frame,
``estimate_batch`` for a batch (a loop over frames, escalated per frame)
and ``refine`` for an optional ICP of a frame's pose against its own scene.
Its nets are served with batch norm folded (``models.folded``: a
bias-free conv and one epilogue kernel a unit). Their forwards
(``models.graphs.GraphedNet``s), ``estimate``'s
``_pose_from_maps`` (one call a packing key: ``full_frame``, ``n_points``)
and ``refine``'s ICP each go through a ``models.graphs.GraphCache``, which
on the card replays one CUDA graph of the call after the first and
elsewhere runs it. ``_frame_pose`` and ``_frame_pose_fused`` stay eager,
for every other caller.

An estimator serves one class: its packing window and point budget are
the config's, or at 0 derived from the class's CAD cloud
(``suggest_pack_window``, ``suggest_point_budget``). The classes of one
process may build their graphs in one ``models.graphs.GraphPool``
(``graph_pool=``), as ``serve.PoseServer`` does for each device.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from rcvpose_tpu_torch import fit, geometry, labels, profiling
from rcvpose_tpu_torch import train as train_mod
from rcvpose_tpu_torch.checkpoint import from_flax_variables
from rcvpose_tpu_torch.models import folded, graphs
from rcvpose_tpu_torch.ops import voting
from rcvpose_tpu_torch.utils import resolve_device

# Legacy fixed crop window for point packing (pixels), used when the
# estimator has no class geometry to derive one from.
WIN_H = 256
WIN_W = 320
# Padding of the CAD's projected bounding sphere, for window and budget.
PACK_MARGIN = 1.2


def suggest_pack_window(cad_mm, k, z_min_mm=600.0, margin=PACK_MARGIN,
                        multiple=32):
    """Packing window (win_h, win_w) sized to the class geometry: the CAD
    bounding-sphere diameter projected at the nearest expected depth
    ``z_min_mm`` through intrinsics ``k``, padded by ``margin`` and rounded
    up to ``multiple``."""
    cad_mm = np.asarray(cad_mm)
    center = cad_mm.mean(axis=0)
    diameter = 2.0 * float(np.linalg.norm(cad_mm - center, axis=1).max())
    k = np.asarray(k)
    out = []
    for f in (float(k[1, 1]), float(k[0, 0])):  # rows use fy, cols fx
        px = diameter / float(z_min_mm) * f * margin
        out.append(int(-(-max(px, 1.0) // multiple) * multiple))
    return tuple(out)


def suggest_point_budget(cad_mm, k, win_hw, z_min_mm=600.0):
    """Point budget sized to the class geometry: the area of the CAD
    bounding sphere's disc projected at ``z_min_mm`` through intrinsics
    ``k``, its radius padded by ``PACK_MARGIN`` (as
    ``suggest_pack_window``'s diameter), rounded up to 1,024 and capped at
    the area of the packing window ``win_hw``. An object no nearer than
    ``z_min_mm`` covers no more pixels, so a frame of it never exceeds the
    budget; a long, thin object pads its points a few times over."""
    cad_mm = np.asarray(cad_mm)
    center = cad_mm.mean(axis=0)
    radius = float(np.linalg.norm(cad_mm - center, axis=1).max())
    k = np.asarray(k)
    r_rows, r_cols = (radius / float(z_min_mm) * float(f) * PACK_MARGIN
                      for f in (k[1, 1], k[0, 0]))
    area = math.pi * r_rows * r_cols
    budget = int(-(-max(area, 1.0) // 1024) * 1024)
    return min(budget, int(win_hw[0]) * int(win_hw[1]))


def _window_origin(any_rows, any_cols, win_h, win_w):
    """Top-left corner (device tensors) of a fixed window centered on the
    True extent."""
    h = any_rows.shape[0]
    w = any_cols.shape[0]
    ri = torch.arange(h, device=any_rows.device)
    ci = torch.arange(w, device=any_cols.device)
    big = 1 << 30
    r0 = torch.where(any_rows, ri, big).min()
    r1 = torch.where(any_rows, ri, -1).max()
    c0 = torch.where(any_cols, ci, big).min()
    c1 = torch.where(any_cols, ci, -1).max()
    rc = torch.where(r0 > r1, h // 2, (r0 + r1) // 2)
    cc = torch.where(c0 > c1, w // 2, (c0 + c1) // 2)
    ro = torch.clamp(rc - win_h // 2, 0, h - win_h)
    co = torch.clamp(cc - win_w // 2, 0, w - win_w)
    return ro, co


def _frame_pose(models, image_norm, depth_mm, k, max_radii_dm, gt_kpts_mm,
                sem_threshold=0.8, n_points=8192, grid_l=192, mode="hier",
                full_frame=False, topk=None, cpt_stride=None, win=None,
                win_hw=None):
    """Full frame: one forward per keypoint net, then ``_pose_from_maps``.

    models: the three per-keypoint networks. image_norm (H, W, 3)
    normalized; depth_mm (H, W); k (3, 3); max_radii_dm (3,); gt_kpts_mm
    (3, 3) model-frame keypoints. Returns the ``_pose_from_maps`` dict.
    """
    return _pose_from_maps(*_maps(_forward(models, image_norm), False),
                           depth_mm, k, max_radii_dm, gt_kpts_mm,
                           sem_threshold, n_points, grid_l, mode, full_frame,
                           topk, cpt_stride, win, win_hw)


def _frame_pose_fused(model, image_norm, depth_mm, k, max_radii_dm,
                      gt_kpts_mm, sem_threshold=0.8, n_points=8192,
                      grid_l=192, mode="hier", full_frame=False, topk=None,
                      cpt_stride=None, win=None, win_hw=None):
    """Fused multi-head frame: ONE forward (``kpt_heads`` output pairs)
    serves every keypoint; voting and fit as in ``_frame_pose``."""
    return _pose_from_maps(*_maps(_forward((model,), image_norm), True),
                           depth_mm, k, max_radii_dm, gt_kpts_mm,
                           sem_threshold, n_points, grid_l, mode, full_frame,
                           topk, cpt_stride, win, win_hw)


def _forward(models, image_norm):
    """Each net's forward of one frame: its (seg, radial) outputs, all in
    one flat tuple."""
    outs = []
    for i, m in enumerate(models):
        with profiling.span("rcvpose.net", net=i):
            outs.extend(m(image_norm[None]))
    return tuple(outs)


def _maps(outs, fused):
    """The (K, H, W) sem and radial maps of ``_forward``'s outputs: one
    fused net's (1, H, W, K) pair, or K nets' (1, H, W, 1) pairs."""
    if fused:
        seg, radial = outs
        return seg[0].permute(2, 0, 1), radial[0].permute(2, 0, 1)
    return (torch.stack([seg[0, :, :, 0] for seg in outs[0::2]]),
            torch.stack([rad[0, :, :, 0] for rad in outs[1::2]]))


def _pose_from_maps(sem_maps, radial_maps, depth_mm, k, max_radii_dm,
                    gt_kpts_mm, sem_threshold, n_points, grid_l, mode,
                    full_frame, topk=None, cpt_stride=None, win=None,
                    win_hw=None):
    """(K, H, W) sem + radial maps -> pose dict (shared by the 3-net and
    fused paths).

    Returns dict(rt (4, 4) mm, centers (K, 3) mm, overflow (K,), counts
    (K,), scene_pts (K, n_points, 3) mm, scene_mask (K, n_points), cropped
    (K,), budget_exceeded (), union_count (), escalate (3,) f32 =
    [any cropped, budget_exceeded, union_count]).
    """
    with profiling.span("rcvpose.pose"):
        return _pose_stages(sem_maps, radial_maps, depth_mm, k, max_radii_dm,
                            gt_kpts_mm, sem_threshold, n_points, grid_l,
                            mode, full_frame, topk, cpt_stride, win, win_hw)


def _pose_stages(sem_maps, radial_maps, depth_mm, k, max_radii_dm,
                 gt_kpts_mm, sem_threshold, n_points, grid_l, mode,
                 full_frame, topk, cpt_stride, win, win_hw):
    """``_pose_from_maps`` inside its span: packing, the vote and the fit."""
    with profiling.span("rcvpose.pack"):
        pts, valid, rad, counts, total_valid, union_count = _pack(
            sem_maps, radial_maps, depth_mm, k, max_radii_dm,
            sem_threshold, n_points, full_frame, win_hw)
    n_kpt = sem_maps.shape[0]
    res = voting.accumulate_3d(pts.expand(n_kpt, -1, -1), rad, valid,
                               grid_l=grid_l, mode=mode, topk=topk,
                               cpt_stride=cpt_stride, win=win)
    with profiling.span("rcvpose.fit"):
        rt = fit.horn_fit(gt_kpts_mm, res.center_mm)
    cropped = counts < total_valid  # the window truncated mask pixels
    budget_exceeded = union_count > n_points
    # One packed vector of the escalation signals: estimate() reads it
    # on the host every frame, in one transfer.
    escalate = torch.stack([cropped.any().to(torch.float32),
                            budget_exceeded.to(torch.float32),
                            union_count.to(torch.float32)])
    return {"rt": rt, "centers": res.center_mm,
            "overflow": res.overflow, "counts": counts,
            "scene_pts": (pts * 1000.0).expand(n_kpt, -1, -1),
            "scene_mask": valid, "cropped": cropped,
            "budget_exceeded": budget_exceeded,
            "union_count": union_count, "escalate": escalate}


# The pose dict's entries by dtype (f32, int32, bool), in the order a pose
# graph packs them into one buffer a dtype, so that a replay's outputs are
# copied out in three copies; ``scene_pts`` is packed as its one
# (n_points, 3) cloud.
_PACKED = (("rt", "centers", "escalate", "scene_pts"),
           ("counts", "union_count"),
           ("overflow", "cropped", "budget_exceeded", "scene_mask"))


def _packed(result):
    """``_pose_stages``'s dict as ``_PACKED``'s three flat buffers."""
    parts = {**result, "scene_pts": result["scene_pts"][0]}
    return tuple(torch.cat([parts[key].reshape(-1) for key in keys])
                 for keys in _PACKED)


def _unpacked(buffers, n_kpt, n_points):
    """The pose dict of ``_packed``'s buffers (views of them), with
    ``scene_pts`` an expand of one cloud over the K keypoints."""
    shapes = {"rt": (4, 4), "centers": (n_kpt, 3), "overflow": (n_kpt,),
              "counts": (n_kpt,), "scene_pts": (n_points, 3),
              "scene_mask": (n_kpt, n_points), "cropped": (n_kpt,),
              "budget_exceeded": (), "union_count": (), "escalate": (3,)}
    out = {}
    for keys, buf in zip(_PACKED, buffers):
        parts = buf.split([math.prod(shapes[key]) for key in keys])
        out.update((key, part.view(shapes[key]))
                   for key, part in zip(keys, parts))
    out["scene_pts"] = out["scene_pts"].expand(n_kpt, -1, -1)
    return {key: out[key] for key in shapes}   # _pose_stages's order


def _pack(sem_maps, radial_maps, depth_mm, k, max_radii_dm, sem_threshold,
          n_points, full_frame, win_hw):
    """The masks, the packing window and the points packed from it:
    (points (n_points, 3) m, per-keypoint validity (K, n_points) and
    radii (K, n_points) over them, per-keypoint mask pixels inside the
    window (K,) and in the frame (K,), the union's pixel count ())."""
    device = depth_mm.device
    n_kpt = sem_maps.shape[0]
    h, w = depth_mm.shape
    wh, ww = (WIN_H, WIN_W) if win_hw is None else win_hw
    win_h = h if full_frame else min(wh, h)
    win_w = w if full_frame else min(ww, w)
    sems = (sem_maps > sem_threshold) & (radial_maps
                                         <= max_radii_dm[:, None, None])
    sems = sems & (depth_mm > 0)
    union = sems.any(dim=0)
    ro, co = _window_origin(union.any(dim=1), union.any(dim=0), win_h, win_w)
    total_valid = sems.sum(dim=(1, 2))

    # Pack the window once on the union mask: every keypoint votes from the
    # same packed points, each with its own validity mask over them (masked
    # points carry lo == hi == 0 and never vote). The window offsets stay on
    # the device: the crop is a gather.
    rows = ro + torch.arange(win_h, device=device)
    cols = co + torch.arange(win_w, device=device)

    def crop(m):
        return m[..., rows[:, None], cols[None, :]]

    unionw = crop(union)
    depw = torch.where(unionw, crop(depth_mm), 0.0)
    us = cols.to(torch.float32)[None, :]
    vs = rows.to(torch.float32)[:, None]
    xs = (us - k[0, 2]) * depw / k[0, 0]
    ys = (vs - k[1, 2]) * depw / k[1, 1]
    flat_xyz = torch.stack([xs, ys, depw], dim=-1).reshape(-1, 3) / 1000.0
    flat_union = (depw > 0).reshape(-1)
    # Budget check: a union larger than the point budget loses votes in
    # the compaction; surfaced so estimate() can grow n_points.
    union_count = flat_union.sum().to(torch.int32)
    order, umask = geometry.pack_valid_indices(flat_union, n_points)
    pts = torch.where(umask[:, None], flat_xyz[order], 0.0)

    semw = crop(sems)
    counts = (semw & (depw > 0)).sum(dim=(1, 2)).to(torch.int32)
    valid = semw.reshape(n_kpt, -1)[:, order] & umask & flat_union[order]
    rad = torch.where(valid, crop(radial_maps).reshape(n_kpt, -1)[:, order],
                      0.0)
    return pts, valid, rad, counts, total_valid, union_count


def _stack_frames(outs):
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


def frame_pose_batch(models, images_norm, depths_mm, *args, **kwargs):
    """``_frame_pose`` over a batch of frames ((B, H, W, 3) images, (B, H, W)
    depths), one frame after another; every entry gains a leading B axis."""
    return _stack_frames([_frame_pose(models, img, dep, *args, **kwargs)
                          for img, dep in zip(images_norm, depths_mm)])


def frame_pose_fused_batch(model, images_norm, depths_mm, *args, **kwargs):
    """``_frame_pose_fused`` over a batch of frames (see
    ``frame_pose_batch``)."""
    return _stack_frames([_frame_pose_fused(model, img, dep, *args, **kwargs)
                          for img, dep in zip(images_norm, depths_mm)])


class PoseEstimator:
    """Per-frame 6DoF pose estimation for one object class."""

    def __init__(self, cfg, variables_list, keypoints, max_radii_dm,
                 cad_mm=None, k=None, device=None, graph_pool=None):
        """``variables_list``: 3 per-keypoint weight sets (reference mode,
        ``cfg.kpt_heads == 1``) or one multi-head set (``cfg.kpt_heads >
        1``). A weight set is either the JAX package's Flax tree
        (``{"params", "batch_stats"}`` with numpy leaves, carried through
        ``checkpoint.from_flax_variables``) or the port's own state dict.

        ``device``: None runs on the CUDA card and raises without one;
        ``"cpu"`` runs on the CPU through the kernels' plain versions.
        Each net is built on ``device`` and takes copies of the weights,
        cast to ``cfg.compute_dtype`` there; then its
        batch norms are folded (``models.folded.fold_for_serving``): the
        nets are eval-only.

        ``graph_pool``: a ``models.graphs.GraphPool`` to build the nets',
        pose's and ICP's graphs in, shared with the other estimators that
        join it (the classes of one process, which run one at a time);
        None makes one of this estimator's own.

        The point budget is ``cfg.max_points``; 0 derives it from
        ``cad_mm`` (``suggest_point_budget``), which it then requires.
        """
        if cfg.max_points < 0 or (cfg.max_points == 0 and cad_mm is None):
            raise ValueError(
                f"max_points={cfg.max_points}: give a positive point budget, "
                f"or 0 with cad_mm to derive it from the class geometry")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fused = cfg.kpt_heads > 1
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        if self.fused:
            if isinstance(variables_list, (tuple, list)):
                variables_list = variables_list[0]
            variables_list = [variables_list]
        self.models = tuple(graphs.GraphedNet(self._load(i, v))
                            for i, v in enumerate(variables_list))
        self.join_graph_pool(graph_pool or graphs.GraphPool())

        def put(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)

        self.gt_kpts_mm = put(np.asarray(keypoints)[1:4] * 1000.0)
        self.max_radii = put(max_radii_dm)
        self.cad_mm = None if cad_mm is None else put(cad_mm)
        self.k = put(geometry.LINEMOD_K if k is None else k)
        # Packing window: explicit config override > derived from class
        # geometry > legacy fixed WIN_H x WIN_W.
        if cfg.pack_win_h > 0 and cfg.pack_win_w > 0:
            self.win_hw = (cfg.pack_win_h, cfg.pack_win_w)
        elif cad_mm is not None:
            self.win_hw = suggest_pack_window(
                np.asarray(cad_mm), self.k.cpu().numpy(),
                z_min_mm=float(cfg.pack_z_min_mm))
        else:
            self.win_hw = None
        # Point budget: explicit config > derived from class geometry.
        self.n_points = cfg.max_points or suggest_point_budget(
            np.asarray(cad_mm), self.k.cpu().numpy(), self.win_hw,
            z_min_mm=float(cfg.pack_z_min_mm))

    def _load(self, index, weights):
        """Net ``index`` with ``weights``, built on the device (so its
        throwaway init runs there, not on the host): its parameters become
        the weights' copies on the device, in the compute dtype (4-D ones
        channels-last), then its batch norms are folded."""
        with profiling.span("rcvpose.load", net=index):
            if "params" in weights:
                weights = from_flax_variables(weights)
            with torch.device(self.device):
                model = train_mod.build_model(self.cfg)
            model.load_state_dict({name: self._copy(t)
                                   for name, t in weights.items()},
                                  assign=True)
            return folded.fold_for_serving(model.eval())

    def _copy(self, t):
        t = torch.as_tensor(t)
        return t.to(device=self.device,
                    dtype=self.dtype if t.is_floating_point() else t.dtype,
                    memory_format=(torch.channels_last if t.dim() == 4
                                   else torch.preserve_format), copy=True)

    def join_graph_pool(self, pool):
        """Build this estimator's graphs (its nets', pose's and ICP's) in
        ``pool`` from now on; the graphs it holds are dropped. Counts
        ``graphs.pool.joined`` where another estimator uses ``pool``."""
        pool.join()
        for m in self.models:
            m.use_pool(pool)
        self._icp = graphs.GraphCache(pool, "icp")
        self._pose = graphs.GraphCache(pool, "pose")

    def replicate_to(self, device):
        """A replica of this estimator whose weights and constants live on
        ``device``; the config is shared. Its graphs start empty, in a pool
        of their own."""
        new = copy.copy(self)
        new.device = resolve_device(device)
        new.models = tuple(m.to(new.device)
                           for m in copy.deepcopy(self.models))
        new.join_graph_pool(graphs.GraphPool())
        for name in ("gt_kpts_mm", "max_radii", "k"):
            setattr(new, name, getattr(self, name).to(new.device))
        if self.cad_mm is not None:
            new.cad_mm = self.cad_mm.to(new.device)
        return new

    def _put(self, x, dtype):
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _escalate(self, run, image_pixels):
        """Run a frame program and escalate its fallbacks until nothing is
        silently dropped: ``cropped`` re-runs with full-frame packing;
        ``budget_exceeded`` doubles ``n_points`` until the union fits
        (capped at the frame size). The loop re-checks after every re-run."""
        full = False
        n_pts = self.n_points
        result = run(full, n_pts)
        while True:
            # the one host read per frame: packed [cropped, budget, union]
            with profiling.span("rcvpose.escalate.read"):
                esc = np.asarray(result["escalate"].cpu()).reshape(-1, 3)
            reason = None
            if not full and bool((esc[:, 0] > 0).any()):
                full = True
                reason = "cropped"
            if bool((esc[:, 1] > 0).any()) and n_pts < image_pixels:
                needed = min(int(esc[:, 2].max()), image_pixels)
                while n_pts < needed:
                    n_pts *= 2
                reason = reason or "budget"
            if reason is None:
                return result
            profiling.count(f"escalations.{reason}")
            with profiling.span("rcvpose.escalate.rerun", reason=reason,
                                n_points=n_pts):
                result = run(full, n_pts)

    def _frame_kwargs(self, full_frame, n_points):
        cfg = self.cfg
        return dict(sem_threshold=cfg.sem_threshold, n_points=n_points,
                    grid_l=cfg.vote_grid_l, mode=cfg.vote_mode,
                    full_frame=full_frame, topk=cfg.vote_topk,
                    cpt_stride=cfg.vote_cpt_stride, win=cfg.vote_win,
                    win_hw=self.win_hw)

    def estimate(self, image_u8, depth_mm):
        """image: (H, W, 3) uint8 RGB; depth: (H, W) mm (numpy arrays or
        tensors). Returns the ``_pose_from_maps`` dict as device tensors.

        Serving never silently drops votes: a window that truncated mask
        pixels re-runs with full-frame packing, and a union mask over the
        point budget re-runs with a doubled budget (``_escalate``).
        """
        frame = profiling.count("frames")
        try:
            with profiling.span("rcvpose.estimate", frame=frame,
                                n_points=self.n_points):
                return self._estimate(image_u8, depth_mm)
        finally:
            profiling.end_startup()

    def _estimate(self, image_u8, depth_mm):
        with torch.inference_mode():
            with profiling.span("rcvpose.inputs"):
                image_norm = labels.normalize_image(
                    self._put(image_u8, torch.uint8))
                depth = self._put(depth_mm, torch.float32)

            def run(full_frame, n_points):
                return self._pose_of(_forward(self.models, image_norm), depth,
                                     self._frame_kwargs(full_frame, n_points))

            return self._escalate(run, depth.numel())

    def _pose_of(self, outs, depth, kwargs):
        """``_pose_from_maps`` of the nets' outputs ``outs`` (``_forward``'s)
        and ``depth`` through ``self._pose``, at the key of the shapes and
        ``kwargs``. The call takes ``outs`` and ``depth``, holds the
        estimator's constants and returns the dict's ``_packed`` buffers;
        the result is views of them."""
        fused = self.fused
        n_kpt = outs[0].shape[-1] if fused else len(outs) // 2
        consts = (self.k, self.max_radii, self.gt_kpts_mm)

        def pose(*args):
            return _packed(_pose_stages(*_maps(args[:-1], fused), args[-1],
                                        *consts, **kwargs))

        key = (tuple((t.shape, t.dtype) for t in outs), depth.shape, fused,
               tuple(kwargs.items()))
        with profiling.span("rcvpose.pose"):
            return _unpacked(self._pose(key, pose, outs + (depth,)), n_kpt,
                             kwargs["n_points"])

    def estimate_batch(self, images_u8, depths_mm):
        """(B, H, W, 3) uint8 images + (B, H, W) mm depths -> the frame dict
        with a leading B axis on every entry.

        The batch runs once at the serving knobs; only the frames whose
        escalate flags tripped re-run through ``estimate`` and their rows
        are spliced in. When an escalated frame grew its point budget,
        every frame's ``scene_pts``/``scene_mask`` are zero-padded to the
        largest budget (padded entries are masked out).
        """
        frame = profiling.count("frames", len(images_u8))
        try:
            with profiling.span("rcvpose.estimate", frame=frame,
                                n_points=self.n_points):
                return self._estimate_batch(images_u8, depths_mm)
        finally:
            profiling.end_startup()

    def _estimate_batch(self, images_u8, depths_mm):
        imgs_np = np.asarray(images_u8)
        deps_np = np.asarray(depths_mm, np.float32)
        batch_fn = frame_pose_fused_batch if self.fused else frame_pose_batch
        nets = self.models[0] if self.fused else self.models
        with torch.inference_mode():
            with profiling.span("rcvpose.inputs"):
                imgs = labels.normalize_image(
                    self._put(imgs_np, torch.uint8))
                deps = self._put(deps_np, torch.float32)
            result = batch_fn(nets, imgs, deps, self.k,
                              self.max_radii, self.gt_kpts_mm,
                              **self._frame_kwargs(False, self.n_points))

        # one host read of the packed (B, 3) [cropped, budget, union] flags
        with profiling.span("rcvpose.escalate.read"):
            esc = np.asarray(result["escalate"].cpu()).reshape(-1, 3)
        pixels = int(np.prod(deps_np.shape[1:]))
        tripped = (esc[:, 0] > 0) | ((esc[:, 1] > 0)
                                     & (self.n_points < pixels))
        if not tripped.any():
            return result

        singles = {}
        for i in np.nonzero(tripped)[0]:
            reason = "cropped" if esc[i, 0] > 0 else "budget"
            profiling.count(f"escalations.{reason}")
            with profiling.span("rcvpose.escalate.rerun", reason=reason,
                                n_points=self.n_points):
                singles[int(i)] = self._estimate(imgs_np[i], deps_np[i])
        n_max = max([result["scene_pts"].shape[2]]
                    + [s["scene_pts"].shape[1] for s in singles.values()])

        def pad_pts(row):
            pad = n_max - row.shape[1]
            if pad == 0:
                return row
            return torch.cat([row, row.new_zeros((row.shape[0], pad)
                                                 + row.shape[2:])], dim=1)

        out = {}
        for key, val in result.items():
            rows = [singles[i][key] if i in singles else val[i]
                    for i in range(val.shape[0])]
            if key in ("scene_pts", "scene_mask"):
                rows = [pad_pts(r) for r in rows]
            out[key] = torch.stack(rows)
        return out

    def refine(self, result, threshold_mm, icp_iters=None):
        """ICP refinement of a frame's fitted pose: align the CAD model
        (constructor ``cad_mm``) to the frame's own masked scene cloud
        (``result["scene_pts"]`` / ``["scene_mask"]``) from ``result["rt"]``,
        for ``icp_iters`` (default ``cfg.icp_iters``) fixed iterations.
        Returns the (4, 4) refined transform on the estimator's device.

        The K rows of ``scene_pts`` (K, n_points, 3) are one cloud:
        ``_pose_from_maps`` expands the packed points over the keypoints, as
        the JAX package's frame program does. So the ICP runs over row 0
        with the OR of the K rows of ``scene_mask``: the correspondences of
        the K copies, from a K-th of the targets. The targets go in the
        order of the first keypoint whose mask holds them, then by index,
        so that a tie between two distinct targets resolves as it does
        across the K copies (to the earlier copy, then the lower index). On
        the card the ordering and the updates replay one CUDA graph per CAD
        size, scene shape and iteration count."""
        if self.cad_mm is None:
            raise ValueError("PoseEstimator needs cad_mm for ICP refinement")
        iters = icp_iters or self.cfg.icp_iters

        def icp(cad, points, masks, rt, threshold):
            order = torch.argsort(masks.to(torch.uint8).argmax(dim=0),
                                  stable=True)
            return fit.icp_point_to_point(cad, points[order],
                                          masks.any(dim=0)[order], rt,
                                          threshold, max_iters=iters)

        with torch.inference_mode(), profiling.span("rcvpose.refine",
                                                    iterations=iters):
            masks = self._put(result["scene_mask"], torch.bool)
            args = (self.cad_mm, self._put(result["scene_pts"][0],
                                           torch.float32),
                    masks, self._put(result["rt"], torch.float32),
                    threshold_mm)
            return self._icp((self.cad_mm.shape, masks.shape, iters), icp,
                             args)
