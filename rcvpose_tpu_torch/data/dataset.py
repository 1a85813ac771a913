"""Dataset indexing for LINEMOD and YCB-Video training trees (the port's own
copy of ``rcvpose_tpu.data.dataset``, numpy only).

Mirrors the reference ``RMapDataset`` layout (rmap_dataset.py:31-68):

  <root>/<class>/JPEGImages/%s.jpg
  <root>/<class>/data/depth%d.dpt
  <root>/<class>/mask/%04d.png
  <root>/<class>/pose/pose%d.npy
  <root>/<class>/Split/{train,val}.txt
  <root>/<class>/mesh.ply              (CAD, millimeters)
  <root>/<class>/Outside9.npy          (dispersed keypoints, meters)

The reference trains and validates on the *val* split for both loaders
(data_loader.py:123), kept as the default here (``split='val'``).
Label generation happens on the device (``labels.make_sample``, called by
``data.loader.BatchLoader``); these classes only read raw frames.
"""

from __future__ import annotations

import os

import numpy as np

from rcvpose_tpu_torch.data import readers


class LinemodDataset:
    def __init__(self, root, class_name, kpt_num=1, split="val"):
        self.root = root
        self.class_name = class_name
        self.kpt_num = int(kpt_num)
        self.split = split
        base = os.path.join(root, class_name)
        self._img = os.path.join(base, "JPEGImages", "%s.jpg")
        self._depth = os.path.join(base, "data", "depth%s.dpt")
        self._mask = os.path.join(base, "mask", "%s.png")
        self._pose = os.path.join(base, "pose", "pose%s.npy")
        # original-format LINEMOD trees carry rot/tra text GT instead of
        # pose*.npy (the reference's debug-only linemod_pose reader,
        # 3DRadius_lm.py:59-74): _load_pose falls back per frame
        self._rot = os.path.join(base, "data", "rot%s.rot")
        self._tra = os.path.join(base, "data", "tra%s.tra")
        split_path = os.path.join(base, "Split", f"{split}.txt")
        with open(split_path) as f:
            self.ids = [line.strip() for line in f if line.strip()]

        # CAD model (mm on disk, reference divides by 1000: rmap_dataset.py:42)
        self.cad_points_mm = readers.read_ply_points(
            os.path.join(base, "mesh.ply"))
        self.cad_points_m = self.cad_points_mm / 1000.0

        kpt_path = os.path.join(base, "Outside9.npy")
        if os.path.isfile(kpt_path):
            self.keypoints = np.load(kpt_path)
        else:
            self.keypoints = readers.dispersed_keypoints(self.cad_points_mm)
            np.save(kpt_path, self.keypoints)
        self.kpt = self.keypoints[self.kpt_num]

        # max radius (dm) from CAD vertices to this keypoint
        # (rmap_dataset.py:53-56)
        d = np.linalg.norm(self.cad_points_m - self.kpt, axis=1)
        self.max_radii_dm = float(d.max() * 10.0)

    def __len__(self):
        return len(self.ids)

    def _load_pose(self, n):
        """GT pose (3, 4), translation in meters: ``pose<N>.npy`` when
        present, else the original-format ``rot<N>.rot``/``tra<N>.tra``
        pair (reference 3DRadius_lm.py:59-74; cm converted to m)."""
        npy = self._pose % n
        if os.path.isfile(npy):
            return np.load(npy)
        rot, tra = self._rot % n, self._tra % n
        if os.path.isfile(rot) and os.path.isfile(tra):
            return readers.read_rot_tra_pose(rot, tra)
        raise FileNotFoundError(
            f"no GT pose for frame {n}: neither {npy} nor the "
            f"original-format pair {rot} / {tra} exists")

    def raw(self, index):
        """Raw per-frame arrays (image uint8 (H, W, 3), depth uint16 mm,
        mask, pose (3, 4), img_id)."""
        img_id = self.ids[index]
        n = str(int(img_id))
        return {
            "image": readers.read_image(self._img % img_id),
            "depth": readers.read_depth(self._depth % n),
            "mask": readers.read_mask(self._mask % n.zfill(4)),
            "pose": self._load_pose(n),
            "img_id": img_id,
        }

    def raw_batch(self, indices):
        """Batched raw read; depth files go through the native threaded
        reader (``rcvpose_tpu_torch.native``; the numpy reader where it
        did not build)."""
        from rcvpose_tpu_torch import native

        ids = [self.ids[int(i)] for i in indices]
        ns = [str(int(i)) for i in ids]
        depths = native.batch_read_dpt([self._depth % n for n in ns])
        out = []
        for img_id, n, depth in zip(ids, ns, depths):
            out.append({
                "image": readers.read_image(self._img % img_id),
                "depth": depth,
                "mask": readers.read_mask(self._mask % n.zfill(4)),
                "pose": self._load_pose(n),
                "img_id": img_id,
            })
        return out

    def max_radii_for(self, kpt_indices):
        """Per-keypoint max radii in dm (eval path,
        AccumulatorSpace.py:544-549)."""
        out = []
        for k in kpt_indices:
            d = np.linalg.norm(self.cad_points_m - self.keypoints[k], axis=1)
            out.append(float(d.max() * 10.0))
        return np.asarray(out)


class YcbDataset:
    """YCB-Video training dataset: precomputed radial labels from the
    per-class HDF5 (reference rmap_dataset.py:62-65, 79-86).

    The reference's YCB ``__getitem__`` branch passes undefined
    ``depth/mask/gtpose`` into the transform (rmap_dataset.py:87, a
    NameError never exercised); here YCB samples carry their precomputed
    radial map, and the loader normalizes the image and derives the
    semantic map from the radial map. The file is read through
    ``readers.open_hdf5``: h5py where it imports, else the port's own
    reader, so training needs no h5py.
    """

    def __init__(self, root, class_name, kpt_num=1, split="val"):
        self.root = root
        self.class_name = class_name
        self.kpt_num = int(kpt_num)
        self._h5path = os.path.join(root, f"{class_name}.hdf5")
        split_path = os.path.join(root, class_name, "Split", f"{split}.txt")
        with open(split_path) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self._h5 = None  # lazy handle, opened on first read

    def __len__(self):
        return len(self.ids)

    def _file(self):
        # One persistent read handle: opening the gzip HDF5 per sample
        # would dominate the per-frame cost.
        if self._h5 is None:
            self._h5 = readers.open_hdf5(self._h5path)
        return self._h5

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def _image(self, f, img_id):
        if "JPEGImages" in f and img_id in f["JPEGImages"]:
            return np.array(f["JPEGImages"][img_id])
        return np.array(f[img_id])

    def raw(self, index):
        img_id = self.ids[index]
        f = self._file()
        radial = np.array(f[f"3Dradius_pt{self.kpt_num}_dm"][img_id])
        return {"image": self._image(f, img_id),
                "radial_dm": radial.astype(np.float32),
                "img_id": img_id}

    def raw_multi(self, index, heads):
        """Multi-head sample for fused training (``kpt_heads > 1``): the
        HDF5 stores one radial map per keypoint (``3Dradius_pt<k>_dm``,
        reference 3DRadius_ycb.py:200-253); keypoints 1..heads stack into
        an (H, W, heads) label."""
        img_id = self.ids[index]
        f = self._file()
        radial = np.stack(
            [np.array(f[f"3Dradius_pt{k}_dm"][img_id])
             for k in range(1, heads + 1)], axis=-1)
        return {"image": self._image(f, img_id),
                "radial_dm": radial.astype(np.float32),
                "img_id": img_id}
