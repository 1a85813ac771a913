"""Dataset self-check: ``--mode check-data`` (the port's own copy of
``rcvpose_tpu.checkdata``; the findings are the JAX module's, message for
message).

Real-data parity cannot be proven without the real datasets, so this mode
de-risks a user's first run: walk a LINEMOD / Occlusion-LINEMOD / YCB-Video
tree and validate every on-disk convention the framework (and the
reference) ASSUMES but never checks — unit conventions, file coverage,
shape alignment, HDF5 key coherence. Each finding cites the reference
file:line that establishes the convention, so a failing tree can be fixed
against the source of truth rather than a stack trace.

The conventions checked (reference citations inline below):

* train-path ``mesh.ply`` is MILLIMETER-valued (rmap_dataset.py:41-42
  divides by 1000); eval-path ``<class>.ply`` is METER-valued
  (AccumulatorSpace.py:544-549 uses raw values against meter keypoints,
  :663-667 scales x1000 into mm) — the two are opposite, and a swapped
  file silently collapses the radius clip and shrinks ADD 1000x.
* ``Outside9.npy`` keypoints are meters, 9x3 (rmap_dataset.py:43-50).
* ``.dpt`` depth is uint16 millimeters under a uint32 h,w header
  (rmap_dataset.py:10-18); YCB depth pngs divide by ``factor_depth`` into
  meters (AccumulatorSpace.py:1057-1062).
* GT pose translation is METERS (scaled x1000 for the mm pipeline,
  data_loader.py:84-87); a mm-valued pose betrays itself by |t| ~ 1000.
* mask / image / depth are pixel-aligned (data_loader.py:68-80).
* split files list frames that actually exist (rmap_dataset.py:32-38).
* YCB HDF5 carries ``JPEGImages/<cycle>_<idx>`` and
  ``3Dradius_pt<k>_dm/<cycle>_<idx>`` datasets per frame
  (3DRadius_ycb.py:200-253) and the ``.mat`` metas carry
  poses/cls_indexes/factor_depth/intrinsic_matrix
  (AccumulatorSpace.py:1018-1019, 1051, 1057).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Finding:
    level: str      # "ERROR" (wrong results/crash) | "WARN" | "OK"
    path: str
    message: str

    def __str__(self):
        return f"[{self.level}] {self.path}: {self.message}"


def _extent(points):
    points = np.asarray(points)
    return float(np.max(points.max(axis=0) - points.min(axis=0)))


def _read_or_error(findings, path, what, fn):
    """Run one file read; a corrupt/unreadable file becomes an ERROR
    finding instead of a traceback. check-data's whole point is 'a
    failing tree can be fixed against the source of truth rather than a
    stack trace' — a truncated .npy/.mat/HDF5/png must not abort the
    walk before the remaining findings are reported. Returns None on
    failure."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - report, keep walking
        findings.append(Finding(
            "ERROR", str(path),
            f"unreadable {what}: {type(exc).__name__}: {exc}"))
        return None


def _check_cad_units(path, expect, findings):
    """expect: 'mm' (train mesh.ply) or 'm' (eval <class>.ply)."""
    from rcvpose_tpu_torch.data import readers

    try:
        pts = readers.read_ply_points(path)
    except Exception as exc:
        findings.append(Finding("ERROR", path, f"unreadable PLY: {exc}"))
        return None
    ext = _extent(pts)
    if expect == "mm" and not (30.0 <= ext <= 600.0):
        hint = ("meter-valued (that is the EVAL <class>.ply convention, "
                "AccumulatorSpace.py:544-549)" if 0.03 <= ext <= 0.6
                else "of implausible scale")
        findings.append(Finding(
            "ERROR", path,
            f"largest extent {ext:.4g} outside 30-600 mm — the train-path "
            f"mesh.ply must be millimeter-valued (rmap_dataset.py:41-42 "
            f"divides by 1000); this file looks {hint}"))
    elif expect == "m" and not (0.03 <= ext <= 0.6):
        hint = ("millimeter-valued (that is the TRAIN mesh.ply convention, "
                "rmap_dataset.py:41-42)" if 30.0 <= ext <= 600.0
                else "of implausible scale")
        findings.append(Finding(
            "ERROR", path,
            f"largest extent {ext:.4g} outside 0.03-0.6 m — the eval-path "
            f"<class>.ply must be meter-valued (AccumulatorSpace.py:"
            f"544-549 uses raw values; :663-667 scales x1000 into mm); "
            f"this file looks {hint}"))
    else:
        findings.append(Finding("OK", path,
                                f"CAD extent {ext:.4g} {expect} plausible"))
    return pts


def _check_keypoints(path, findings):
    if not os.path.isfile(path):
        findings.append(Finding(
            "WARN", path,
            "Outside9.npy missing — the dataset layer generates 2x "
            "oriented-bbox-corner keypoints instead (rmap_dataset.py:43-51)"
        ))
        return None
    kpts = _read_or_error(findings, path, "keypoint .npy",
                          lambda: np.load(path))
    if kpts is None:
        return None
    if kpts.shape != (9, 3):
        findings.append(Finding(
            "ERROR", path,
            f"keypoint array has shape {kpts.shape}, expected (9, 3) "
            f"(rmap_dataset.py:43-50; eval reads rows 1..3, "
            f"AccumulatorSpace.py:542)"))
        return None
    m = float(np.abs(kpts).max())
    if m > 1.0:
        findings.append(Finding(
            "ERROR", path,
            f"keypoint magnitude {m:.3g} — keypoints must be METERS "
            f"(rmap_dataset.py:45-50; values ~{m:.0f} look millimeter-"
            f"valued)"))
    else:
        findings.append(Finding("OK", path, "keypoints (9, 3), meters"))
    return kpts


def _check_depth_mm(path, depth, findings, what="depth"):
    nz = np.asarray(depth)[np.asarray(depth) > 0]
    if nz.size == 0:
        findings.append(Finding(
            "WARN", path, f"{what} has no nonzero pixels"))
        return
    med = float(np.median(nz))
    if not (100.0 <= med <= 10000.0):
        hint = (" (values ~1 look METER-valued; the pipeline expects "
                "millimeters — rmap_dataset.py:10-18, data_loader.py:84)"
                if med < 100 else "")
        findings.append(Finding(
            "ERROR", path,
            f"median nonzero {what} {med:.4g} outside 100-10000 mm{hint}"))
    else:
        findings.append(Finding(
            "OK", path, f"{what} median {med:.0f} mm plausible"))


def _check_pose_m(path, pose, findings):
    pose = np.asarray(pose)
    if pose.shape not in ((3, 4), (4, 4)):
        findings.append(Finding(
            "ERROR", path,
            f"pose has shape {pose.shape}, expected (3, 4) rotation|"
            f"translation (data_loader.py:84-87)"))
        return
    t = float(np.linalg.norm(pose[:3, 3]))
    if not (0.2 <= t <= 5.0):
        hint = (" (|t| ~ 1000 is a millimeter translation; the GT pose "
                "must be METERS — data_loader.py:84-87 scales x1000)"
                if t > 5.0 else "")
        findings.append(Finding(
            "ERROR", path,
            f"|translation| = {t:.4g} outside 0.2-5 m{hint}"))
    else:
        findings.append(Finding("OK", path, f"pose |t| {t:.2f} m plausible"))


def check_lm(root, class_name, max_frames=3, assets_only=False):
    """LINEMOD tree checks (layout: rmap_dataset.py:32-38 + the eval
    tree's LINEMOD_ORIG conventions, AccumulatorSpace.py:507-618).

    ``assets_only``: check only the class assets the OTHER datasets
    borrow from this tree — the meter-valued eval ``<class>.ply`` and
    ``Outside9.npy`` keypoints (what ``estimate_6d_pose_lmo`` reads,
    eval.py) — with the eval ply as ERROR. The full-LM requirements
    (Split/val.txt, JPEGImages, poses, masks, LINEMOD_ORIG depth) are
    NOT applied: a valid LMO setup has none of them, and flagging them
    as errors would fail a tree that ``--mode test --dname lmo``
    evaluates fine."""
    from rcvpose_tpu_torch.data import readers

    findings = []
    pv = os.path.join(root, "LINEMOD", class_name)
    orig = os.path.join(root, "LINEMOD_ORIG", class_name)
    if not os.path.isdir(pv):
        findings.append(Finding(
            "ERROR", pv,
            "class directory missing (<root>/LINEMOD/<class>, "
            "rmap_dataset.py:31-38)"))
        return findings
    if assets_only:
        eval_ply = os.path.join(pv, f"{class_name}.ply")
        if os.path.isfile(eval_ply):
            _check_cad_units(eval_ply, "m", findings)
        else:
            findings.append(Finding(
                "ERROR", eval_ply,
                "eval-path <class>.ply missing — the LMO evaluator "
                "reads it for radius clips, ADD and ICP "
                "(AccumulatorSpace.py:544-549)"))
        _check_keypoints(os.path.join(pv, "Outside9.npy"), findings)
        return findings

    ids = []
    for split in ("train", "val"):
        sp = os.path.join(pv, "Split", f"{split}.txt")
        if not os.path.isfile(sp):
            lvl = "ERROR" if split == "val" else "WARN"
            note = (" — BOTH loaders read val.txt (data_loader.py:123) and "
                    "the evaluator filters by it (AccumulatorSpace.py:"
                    "553-558)" if split == "val" else "")
            findings.append(Finding(lvl, sp, f"split file missing{note}"))
            continue
        with open(sp) as f:
            lst = [ln.strip() for ln in f if ln.strip()]
        if not lst:
            findings.append(Finding("ERROR", sp, "split file is empty"))
        elif split == "val":
            ids = lst
            findings.append(Finding("OK", sp, f"{len(lst)} frames listed"))

    mesh = os.path.join(pv, "mesh.ply")
    if os.path.isfile(mesh):
        _check_cad_units(mesh, "mm", findings)
    else:
        findings.append(Finding(
            "WARN", mesh,
            "train-path mesh.ply missing (training/radius computation "
            "needs it, rmap_dataset.py:41-42); eval can still run"))
    eval_ply = os.path.join(pv, f"{class_name}.ply")
    if os.path.isfile(eval_ply):
        _check_cad_units(eval_ply, "m", findings)
    else:
        findings.append(Finding(
            "WARN", eval_ply,
            "eval-path <class>.ply missing (--mode test needs it, "
            "AccumulatorSpace.py:544-549); training can still run"))
    _check_keypoints(os.path.join(pv, "Outside9.npy"), findings)

    img_shape = None
    for frame_id in ids[:max_frames]:
        n = str(int(frame_id))
        img_p = os.path.join(pv, "JPEGImages", f"{frame_id}.jpg")
        if not os.path.isfile(img_p):
            findings.append(Finding(
                "ERROR", img_p,
                "frame listed in Split/val.txt but image missing "
                "(rmap_dataset.py:32)"))
            continue
        img = _read_or_error(findings, img_p, "image",
                             lambda p=img_p: readers.read_image(p))
        if img is None:
            continue
        img_shape = np.asarray(img).shape[:2]

        pose_p = os.path.join(pv, "pose", f"pose{n}.npy")
        rot_p = os.path.join(pv, "data", f"rot{n}.rot")
        if os.path.isfile(pose_p):
            pose = _read_or_error(findings, pose_p, "pose .npy",
                                  lambda p=pose_p: np.load(p))
            if pose is not None:
                _check_pose_m(pose_p, pose, findings)
        elif os.path.isfile(rot_p):
            findings.append(Finding(
                "OK", rot_p, "original-format rot/tra GT (cm; "
                "3DRadius_lm.py:59-74 reader)"))
        else:
            findings.append(Finding(
                "ERROR", pose_p,
                "no GT pose: neither pose<N>.npy (rmap_dataset.py:35) nor "
                "the rot/tra pair (3DRadius_lm.py:59-74)"))

        mask_p = os.path.join(pv, "mask", f"{n.zfill(4)}.png")
        if os.path.isfile(mask_p):
            mask = _read_or_error(findings, mask_p, "mask png",
                                  lambda p=mask_p: readers.read_mask(p))
            if mask is not None and \
                    np.asarray(mask).shape[:2] != tuple(img_shape):
                findings.append(Finding(
                    "ERROR", mask_p,
                    f"mask shape {np.asarray(mask).shape[:2]} != image "
                    f"shape {tuple(img_shape)} — per-pixel alignment is "
                    f"assumed (data_loader.py:68-80)"))
        else:
            findings.append(Finding(
                "WARN", mask_p,
                "mask missing (training's on-the-fly labels need it, "
                "data_loader.py:76-80); eval can still run"))

        dpt_p = os.path.join(orig, "data", f"depth{n}.dpt")
        if os.path.isfile(dpt_p):
            depth = _read_or_error(findings, dpt_p, ".dpt depth",
                                   lambda p=dpt_p: readers.read_depth(p))
            if depth is None:
                continue
            if np.asarray(depth).shape != tuple(img_shape):
                findings.append(Finding(
                    "ERROR", dpt_p,
                    f"depth shape {np.asarray(depth).shape} != image "
                    f"shape {tuple(img_shape)}"))
            _check_depth_mm(dpt_p, depth, findings)
        else:
            findings.append(Finding(
                "WARN", dpt_p,
                "LINEMOD_ORIG depth missing (the evaluator reads it, "
                "eval.py load_frame; AccumulatorSpace.py:601)"))
    return findings


def check_lmo(root, class_name, max_frames=3):
    """Occlusion-LINEMOD tree checks (AccumulatorSpace.py:783-827)."""
    from rcvpose_tpu_torch.data import readers

    findings = []
    occ = os.path.join(root, "OCCLUSION_LINEMOD")
    rgb_dir = os.path.join(occ, "RGB-D", "rgb_noseg")
    depth_dir = os.path.join(occ, "RGB-D", "depth_noseg")
    pose_dir = os.path.join(occ, "blender_poses", class_name)
    for d, what in ((rgb_dir, "rgb_noseg frames (:783)"),
                    (depth_dir, "depth_noseg frames (:784)"),
                    (pose_dir, "blender_poses GT (:827)")):
        if not os.path.isdir(d):
            findings.append(Finding("ERROR", d, f"directory missing — "
                                                f"{what}"))
    if not os.path.isdir(rgb_dir):
        return findings
    import re

    pngs = sorted(fn for fn in os.listdir(rgb_dir) if fn.endswith(".png"))
    frames = [fn for fn in pngs if re.fullmatch(r"color_\d+\.png", fn)]
    for stray in sorted(set(pngs) - set(frames)):
        findings.append(Finding(
            "WARN", os.path.join(rgb_dir, stray),
            "png does not match color_<N>.png — ignored by the evaluator "
            "(eval.py strict frame filter)"))
    if not frames:
        findings.append(Finding("ERROR", rgb_dir, "no color_*.png frames"))
        return findings
    findings.append(Finding("OK", rgb_dir, f"{len(frames)} frames"))
    with_pose = 0
    for fn in frames[:max_frames]:
        num = int(os.path.splitext(fn)[0][6:])
        dp = os.path.join(depth_dir, f"depth_{str(num).zfill(5)}.png")
        if not os.path.isfile(dp):
            findings.append(Finding(
                "ERROR", dp, "depth frame missing for listed rgb frame"))
        else:
            depth = _read_or_error(findings, dp, "depth png",
                                   lambda p=dp: readers.read_depth(p))
            if depth is not None:
                _check_depth_mm(dp, depth, findings)
        pp = os.path.join(pose_dir, f"pose{num}.npy")
        if os.path.isfile(pp):
            with_pose += 1
            pose = _read_or_error(findings, pp, "pose .npy",
                                  lambda p=pp: np.load(p))
            if pose is not None:
                _check_pose_m(pp, pose, findings)
    if os.path.isdir(pose_dir) and with_pose == 0:
        findings.append(Finding(
            "WARN", pose_dir,
            f"none of the first {max_frames} frames has a GT pose — such "
            f"frames are SKIPPED, not failed (AccumulatorSpace.py:813-822); "
            f"verify the class name if the whole sweep comes out empty"))
    return findings


def check_ycb(root, class_name, class_id, max_frames=3):
    """YCB-Video tree checks (AccumulatorSpace.py:996-1062 + the HDF5
    layout of 3DRadius_ycb.py:200-253)."""
    try:
        import scipy.io
    except ImportError as exc:
        raise ImportError("check_ycb reads the .mat metas with scipy, "
                          "which is not installed") from exc

    from rcvpose_tpu_torch.data import readers

    findings = []
    h5p = os.path.join(root, f"{class_name}.hdf5")
    sp = os.path.join(root, "Split", class_name, "val.txt")
    mdir = os.path.join(root, "models", class_name)

    ids = []
    if not os.path.isfile(sp):
        findings.append(Finding(
            "ERROR", sp, "split file missing (eval layout "
            "<root>/Split/<class>/val.txt, AccumulatorSpace.py:996-1001)"))
    else:
        with open(sp) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
        findings.append(Finding("OK", sp, f"{len(ids)} frames listed"))
    train_sp = os.path.join(root, class_name, "Split", "val.txt")
    if not os.path.isfile(train_sp):
        findings.append(Finding(
            "WARN", train_sp,
            "training-layout split missing (<root>/<class>/Split/val.txt, "
            "rmap_dataset.py:31-38) — --mode train cannot run"))

    xyz = os.path.join(mdir, "points.xyz")
    if os.path.isfile(xyz):
        pts = _read_or_error(findings, xyz, "points.xyz",
                             lambda: np.loadtxt(xyz)[:, :3])
        ext = _extent(pts) if pts is not None else None
        if ext is None:
            pass
        elif not (0.03 <= ext <= 0.6):
            findings.append(Finding(
                "ERROR", xyz,
                f"model extent {ext:.4g} outside 0.03-0.6 m — YCB "
                f"points.xyz is meter-valued (AccumulatorSpace.py:"
                f"1003-1008)"))
        else:
            findings.append(Finding("OK", xyz, f"model extent {ext:.3g} m"))
    else:
        findings.append(Finding("ERROR", xyz, "model points.xyz missing "
                                "(AccumulatorSpace.py:1003)"))
    _check_keypoints(os.path.join(mdir, "Outside9.npy"), findings)

    if not os.path.isfile(h5p):
        findings.append(Finding(
            "ERROR", h5p, "per-class HDF5 missing (3DRadius_ycb.py:200; "
            "AccumulatorSpace.py:1012-1013)"))
        return findings
    fobj = _read_or_error(findings, h5p, "HDF5",
                          lambda: readers.open_hdf5(h5p))
    if fobj is None:
        return findings
    with fobj as f:
        if "JPEGImages" not in f:
            findings.append(Finding(
                "ERROR", h5p, "no JPEGImages group (3DRadius_ycb.py:"
                "250-253)"))
            return findings
        keys = set(f["JPEGImages"].keys())
        covered = [i for i in ids if i in keys]
        if ids and not covered:
            findings.append(Finding(
                "ERROR", h5p,
                "no split frame has an image in the HDF5 — id scheme "
                "mismatch? (keys are '<cycle>_<idx>', 3DRadius_ycb.py:200)"))
        elif ids and len(covered) < len(ids):
            findings.append(Finding(
                "WARN", h5p,
                f"only {len(covered)}/{len(ids)} split frames present in "
                f"the HDF5 (missing frames are silently not evaluated)"))
        else:
            findings.append(Finding(
                "OK", h5p, f"{len(covered)} split frames covered"))
        for kp in (1, 2, 3):
            g = f"3Dradius_pt{kp}_dm"
            if g not in f:
                findings.append(Finding(
                    "WARN", h5p,
                    f"no {g} group — fused training (kpt_heads>1) and the "
                    f"precomputed route need it (3DRadius_ycb.py:200-253)"))
                continue
            sample = covered[0] if covered else None
            if sample and sample in f[g]:
                r = np.asarray(f[g][sample])
                if float(np.max(r, initial=0.0)) > 20.0:
                    findings.append(Finding(
                        "ERROR", h5p,
                        f"{g}/{sample} max {float(r.max()):.3g} — radial "
                        f"maps are DECIMETERS (values x10 of meters, "
                        f"3DRadius_lm.py:216; >20 dm = 2 m radius is "
                        f"implausible)"))

        for frame in covered[:max_frames]:
            cycle, idx = frame.split("_")
            mat_p = os.path.join(root, "data", cycle, f"{idx}.mat")
            if not os.path.isfile(mat_p):
                findings.append(Finding(
                    "ERROR", mat_p, "frame .mat missing "
                    "(AccumulatorSpace.py:1018)"))
                continue
            meta = _read_or_error(findings, mat_p, ".mat meta",
                                  lambda p=mat_p: scipy.io.loadmat(p))
            if meta is None:
                continue
            for key in ("poses", "cls_indexes", "factor_depth",
                        "intrinsic_matrix"):
                if key not in meta:
                    findings.append(Finding(
                        "ERROR", mat_p,
                        f"missing '{key}' (AccumulatorSpace.py:1018-1019, "
                        f"1051, 1057)"))
            if "cls_indexes" in meta and class_id not in \
                    np.asarray(meta["cls_indexes"]).ravel():
                findings.append(Finding(
                    "WARN", mat_p,
                    f"class id {class_id} not among this frame's "
                    f"cls_indexes — the frame is skipped for this class"))
            dep_p = os.path.join(root, "data", cycle, f"{idx}-depth.png")
            if os.path.isfile(dep_p) and "factor_depth" in meta:
                factor = float(np.asarray(meta["factor_depth"]).ravel()[0])
                raw = _read_or_error(findings, dep_p, "depth png",
                                     lambda p=dep_p: readers.read_depth(p))
                if raw is not None:
                    depth_mm = raw.astype(np.float32) / factor * 1000.0
                    _check_depth_mm(
                        dep_p, depth_mm, findings,
                        what=f"depth (/factor_depth={factor:g} -> mm)")
            elif not os.path.isfile(dep_p):
                findings.append(Finding(
                    "ERROR", dep_p, "depth png missing "
                    "(AccumulatorSpace.py:1057-1062)"))
            col_p = os.path.join(root, "data", cycle, f"{idx}-color.png")
            if not os.path.isfile(col_p):
                findings.append(Finding(
                    "ERROR", col_p, "color png missing"))
    return findings


def run_check(cfg, progress=print):
    """``--mode check-data`` entry: check ``cfg.class_name`` (or every
    class in ``--eval_classes``) for ``cfg.dataset``; print each finding;
    return the findings. Raises SystemExit(1) from the CLI when any
    ERROR was found (scripts can gate on the exit code)."""
    classes = [c.strip() for c in getattr(cfg, "eval_classes", "").split(",")
               if c.strip()] or [cfg.class_name]
    findings = []
    for cname in classes:
        progress(f"check-data: {cfg.dataset}/{cname}")
        if cfg.dataset == "ycb":
            from rcvpose_tpu_torch.eval import YCB_CLASS_NAMES
            cid = {v: k for k, v in YCB_CLASS_NAMES.items()}.get(cname)
            if cid is None:
                findings.append(Finding(
                    "ERROR", cname, "unknown YCB class name "
                    "(AccumulatorSpace.py:21-41)"))
                continue
            findings += check_ycb(cfg.root_dataset, cname, cid)
        elif cfg.dataset == "lmo":
            findings += check_lmo(cfg.root_dataset, cname)
            # the CAD/keypoint assets LMO borrows from the LINEMOD tree
            # (NOT the full-LM requirements — a valid LMO setup has no
            # Split/JPEGImages/pose dirs there)
            findings += check_lm(cfg.root_dataset, cname, assets_only=True)
        else:
            findings += check_lm(cfg.root_dataset, cname)
    for f in findings:
        progress(str(f))
    n_err = sum(f.level == "ERROR" for f in findings)
    n_warn = sum(f.level == "WARN" for f in findings)
    progress(f"check-data: {n_err} error(s), {n_warn} warning(s), "
             f"{len(findings) - n_err - n_warn} ok")
    return findings
