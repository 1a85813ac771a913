"""Host-side dataset IO: .dpt depth, PLY models, images, masks, poses.

The port's own copy of ``rcvpose_tpu.data.readers`` (numpy only; the JAX
package's ``__init__`` pulls in JAX, so the port cannot import it). The
reference leans on Open3D (native C++) for PLY IO and PIL/NumPy for the
rest (rmap_dataset.py:10-18, 41). Open3D is not a dependency here: PLY
parsing is implemented directly (ascii + binary_little_endian vertex
elements), which is all the pipeline needs — CAD models are consumed as
point sets.

PIL is imported only by the functions that decode images (``read_image``,
``read_mask`` and the image branch of ``read_depth``); without it they raise
an ``ImportError`` that names PIL, and ``.dpt`` depth and PLY still read.
"""

from __future__ import annotations

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding images needs PIL (Pillow), which is not "
                          "installed; .dpt depth and PLY models read "
                          "without it") from exc
    return Image


def read_depth(path):
    """LINEMOD .dpt (uint32 h, w header + uint16 payload) or image depth
    (reference rmap_dataset.py:10-18)."""
    path = str(path)
    if path.endswith("dpt"):
        with open(path, "rb") as f:
            h, w = np.fromfile(f, dtype=np.uint32, count=2)
            data = np.fromfile(f, dtype=np.uint16, count=int(w) * int(h))
        return data.reshape((int(h), int(w)))
    return np.asarray(_pil_image().open(path)).copy()


def read_image(path):
    """RGB uint8 (H, W, 3)."""
    return np.asarray(_pil_image().open(path).convert("RGB"))


def read_rot_tra_pose(rot_path, tra_path):
    """(3, 4) pose from the original LINEMOD ``rot*.rot`` / ``tra*.tra``
    text files, translation converted to METERS.

    The original-format files are one header line followed by whitespace-
    separated floats: 9 for the rotation, 3 for the translation **in
    centimeters** (the reference's debug-only ``linemod_pose`` reader,
    3DRadius_lm.py:59-74, returns them raw in cm). The returned pose uses
    the framework's ``pose*.npy`` convention — translation in meters — so
    a tree holding only rot/tra GT drops into ``LinemodDataset`` unchanged.
    """
    with open(rot_path) as f:
        f.readline()  # header (element counts)
        r = np.array(f.read().split(), np.float32).reshape(3, 3)
    with open(tra_path) as f:
        f.readline()
        t_cm = np.array(f.read().split(), np.float32)
    if t_cm.shape != (3,):
        raise ValueError(f"{tra_path}: expected 3 translation values, "
                         f"got {t_cm.shape}")
    return np.concatenate([r, (t_cm / 100.0)[:, None]], axis=1)


def read_mask(path):
    """First channel of the mask png as int (reference rmap_dataset.py:76)."""
    arr = np.asarray(_pil_image().open(path), dtype=np.int32)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_points(path):
    """Vertex positions (N, 3) float64 from an ascii or binary-LE PLY file."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment":
                continue
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1], ("list", tokens[2], tokens[3])))
                else:
                    cur[2].append((tokens[-1], tokens[1]))
            elif tokens[0] == "end_header":
                break

        for name, count, props in elements:
            if name != "vertex":
                continue
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    vals = f.readline().split()
                    rows.append([float(v) for v in vals[:len(props)]])
                arr = np.asarray(rows)
                cols = {p[0]: i for i, p in enumerate(props)}
                return arr[:, [cols["x"], cols["y"], cols["z"]]]
            elif fmt == "binary_little_endian":
                if any(isinstance(p[1], tuple) for p in props):
                    raise ValueError("list property in vertex element")
                dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[1]])
                               for p in props])
                arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt,
                                    count=count)
                return np.stack([arr["x"], arr["y"], arr["z"]],
                                axis=1).astype(np.float64)
            else:
                raise ValueError(f"unsupported PLY format: {fmt}")
        raise ValueError(f"no vertex element in {path}")


def oriented_bbox_corners(points):
    """8 corners of a PCA-oriented bounding box of a point set.

    Stand-in for Open3D's minimal OBB (rmap_dataset.py:47-48), used only to
    synthesize dispersed keypoints when ``Outside9.npy`` is absent. PCA axes
    are a standard approximation of the minimal-volume box.
    """
    pts = np.asarray(points, np.float64)
    c = pts.mean(axis=0)
    centered = pts - c
    cov = centered.T @ centered / len(pts)
    _, vecs = np.linalg.eigh(cov)
    proj = centered @ vecs
    lo = proj.min(axis=0)
    hi = proj.max(axis=0)
    corners = np.array([[lo[0], lo[1], lo[2]],
                        [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]],
                        [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]],
                        [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]],
                        [hi[0], hi[1], hi[2]]])
    return corners @ vecs.T + c


def dispersed_keypoints(cad_points_mm):
    """Reference fallback keypoints when ``Outside9.npy`` is absent: 2x the
    oriented-bounding-box corners (rmap_dataset.py:43-51; 8 rows, indexed
    from 1 by train/eval so row 0 is effectively unused there)."""
    return oriented_bbox_corners(cad_points_mm) * 2.0
