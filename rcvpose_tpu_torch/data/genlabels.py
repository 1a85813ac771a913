"""Offline GT radial-map generation (the port's counterpart of
``rcvpose_tpu.data.genlabels``), on the device through
``labels.radial_labels``.

Equivalent of the reference's standalone generators
(3DRadius_lm.py:126-234: per class x keypoint x frame,
``Out_pt<k>_dm/<id>.npy`` in decimeters; 3DRadius_ycb.py:164-286: gzip
HDF5 datasets ``3Dradius_pt<k>_dm/<cycle>_<frame>``). Training does not
need them: the loader makes labels on the fly on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rcvpose_tpu_torch import geometry, labels
from rcvpose_tpu_torch.data.dataset import LinemodDataset
from rcvpose_tpu_torch.utils import resolve_device


def generate_lm(root, class_name, kpt_indices=range(1, 4), split="val",
                out_root=None, batch_size=8, progress=print,
                fake_depth=False, device=None):
    """Write ``Out_pt<k>_dm/<id>.npy`` radial maps (f32, decimeters) for one
    LINEMOD class, ``batch_size`` frames a device call.

    ``fake_depth=True`` is the reference's ``depthGeneration`` mode
    (3DRadius_lm.py:14, 152-153, 213-214): the same per-pixel
    keypoint-distance maps, saved METER-valued (no x10) under
    ``FakeDepth/``, the pseudo-depth input of the RGB-only ablation.
    ``device``: the card unless ``"cpu"`` is named.
    """
    dev = resolve_device(device)
    out_root = out_root or os.path.join(root, class_name)
    k = torch.as_tensor(geometry.LINEMOD_K, dtype=torch.float32, device=dev)

    for kpt_num in kpt_indices:
        ds = LinemodDataset(root, class_name, kpt_num=kpt_num, split=split)
        out_dir = os.path.join(
            out_root, "FakeDepth" if fake_depth else f"Out_pt{kpt_num}_dm")
        os.makedirs(out_dir, exist_ok=True)
        kpt = torch.as_tensor(np.asarray(ds.kpt, np.float32), device=dev)
        maxr = torch.tensor(ds.max_radii_dm, dtype=torch.float32, device=dev)

        for start in range(0, len(ds), batch_size):
            idx = range(start, min(start + batch_size, len(ds)))
            samples = [ds.raw(i) for i in idx]

            def stacked(key, dtype=None):
                arr = np.stack([s[key] for s in samples])
                return torch.as_tensor(arr if dtype is None
                                       else arr.astype(dtype), device=dev)

            radials, _ = labels.radial_labels(
                stacked("depth", np.float32), stacked("mask"),
                stacked("pose", np.float32), kpt, k, maxr)
            radials = radials.cpu().numpy()
            if fake_depth:
                radials = radials / 10.0  # dm -> meters (reference :213)
            for s, r in zip(samples, radials):
                np.save(os.path.join(out_dir, f"{s['img_id']}.npy"), r)
            progress(f"{class_name} pt{kpt_num}: "
                     f"{min(start + batch_size, len(ds))}/{len(ds)}")


def generate_ycb(root, class_name, class_id, kpt_indices=range(1, 4),
                 batch_size=8, progress=print, write_split=True,
                 device=None):
    """Write one YCB class's training HDF5, the file its consumers read.

    Output layout as the reference generator's (3DRadius_ycb.py:200-253):

      <root>/<class>.hdf5            (YcbDataset; the YCB evaluator's
        /JPEGImages/<cycle>_<idx>     frame index)
        /3Dradius_pt<k>_dm/<cycle>_<idx>

    gzip level 9 datasets; radial maps are raw decimeters (max radius
    ``inf``: no clip at generation; the >= 10 dm filter is the loader's
    ``ycb_clip``). ``write_split=True`` also records the generated frame
    ids in ``<root>/<class>/Split/val.txt`` (the dataset's layout) and
    ``<root>/Split/<class>/val.txt`` (the evaluator's) where missing;
    existing split files are never touched. ``batch_size`` is kept for
    the JAX signature; frames are labelled one at a time, all keypoints in
    one device call.

    The file is written by the port's own ``hdf5_write.Hdf5Writer`` in
    h5py's ``"a"`` mode, with h5py installed or not: an image that exists
    is kept, a radial map that exists is replaced, and every other object
    of an existing file is carried over with its stored chunks unchanged.
    Reading the ``.mat`` metas needs ``scipy.io``.
    """
    try:
        import scipy.io
    except ImportError as exc:
        raise ImportError("generate_ycb reads the YCB-Video .mat metas with "
                          "scipy.io, which is not installed") from exc

    from rcvpose_tpu_torch.data import hdf5_write, readers

    dev = resolve_device(device)
    keypoints = np.load(os.path.join(root, "models", class_name,
                                     "Outside9.npy"))
    kpt_indices = list(kpt_indices)
    kpts = torch.as_tensor(keypoints[kpt_indices].astype(np.float32),
                           device=dev)
    inf = torch.full((len(kpt_indices),), float("inf"), device=dev)

    h5_path = os.path.join(root, f"{class_name}.hdf5")
    data_root = os.path.join(root, "data")
    frame_ids = []
    with hdf5_write.Hdf5Writer(h5_path, "a") as h5f:
        for cycle in sorted(os.listdir(data_root)):
            cdir = os.path.join(data_root, cycle)
            if not os.path.isdir(cdir):
                continue
            for fn in sorted(os.listdir(cdir)):
                if not fn.endswith(".mat"):
                    continue
                idx = fn[:-4]
                meta = scipy.io.loadmat(os.path.join(cdir, fn))
                sel = np.where(meta["cls_indexes"].ravel() == class_id)[0]
                if sel.size == 0:
                    continue
                pose = meta["poses"][:, :, sel[0]]
                factor = float(np.asarray(meta["factor_depth"]).ravel()[0])
                kmat = torch.as_tensor(meta["intrinsic_matrix"],
                                       dtype=torch.float32, device=dev)
                depth = readers.read_depth(
                    os.path.join(cdir, f"{idx}-depth.png"))
                depth_mm = depth.astype(np.float32) / factor * 1000.0
                # label mask: per-object id in the label png
                seg = readers.read_depth(
                    os.path.join(cdir, f"{idx}-label.png"))
                mask = (seg == class_id).astype(np.int32)

                frame_id = f"{cycle}_{idx}"
                img_key = f"JPEGImages/{frame_id}"
                if img_key not in h5f:
                    image = readers.read_image(
                        os.path.join(cdir, f"{idx}-color.png"))
                    h5f.add(img_key, image, gzip=9)
                radial, _ = labels.radial_labels(
                    torch.as_tensor(depth_mm[None], device=dev),
                    torch.as_tensor(mask[None], device=dev),
                    torch.as_tensor(pose[None].astype(np.float32),
                                    device=dev), kpts, kmat, inf)
                radial = radial[0].cpu().numpy()              # (H, W, K)
                for j, kpt_num in enumerate(kpt_indices):
                    key = f"3Dradius_pt{kpt_num}_dm/{frame_id}"
                    if key in h5f:
                        del h5f[key]
                    h5f.add(key, radial[..., j], gzip=9)
                frame_ids.append(frame_id)
                progress(f"{class_name} {frame_id}")

    if write_split and frame_ids:
        # the dataset reads <root>/<class>/Split/val.txt
        # (rmap_dataset.py:64), the evaluator <root>/Split/<class>/val.txt
        # (AccumulatorSpace.py:986): write both
        for split_path in (
                os.path.join(root, class_name, "Split", "val.txt"),
                os.path.join(root, "Split", class_name, "val.txt")):
            if not os.path.exists(split_path):
                os.makedirs(os.path.dirname(split_path), exist_ok=True)
                with open(split_path, "w") as f:
                    f.write("\n".join(frame_ids) + "\n")
    return frame_ids
