"""Demo-mode overlays and scene clouds (counterpart of
``rcvpose_tpu.demo``; reference AccumulatorSpace.py:670-683, 716-717).

The reference paints projected CAD points into the RGB frame and opens
blocking matplotlib/Open3D windows. Here the overlay is drawn with numpy
and written as a PNG per frame (PIL), the scene as a binary PLY. The
projection and back-projection are the port's ``geometry`` in f32 on the
CPU, so a pose gives the same pixels as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rcvpose_tpu_torch import geometry


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def project_points_to_pixels(cad_mm, rt_mm, k):
    """(N, 2) f32 pixel coordinates of the model under ``rt_mm``."""
    xy, _ = geometry.project(_f32(cad_mm), _f32(k), _f32(rt_mm)[:3, :])
    return xy.numpy()


def draw_overlay(image_u8, cad_mm, rt_mm, k, color=(255, 0, 0)):
    """Paint the model (under pose ``rt_mm``, mm) into a copy of the image;
    pixels round half to even (``np.round``)."""
    img = np.asarray(image_u8).copy()
    h, w = img.shape[:2]
    xy = project_points_to_pixels(cad_mm, rt_mm, k)
    us = np.round(xy[:, 0]).astype(int)
    vs = np.round(xy[:, 1]).astype(int)
    ok = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
    img[vs[ok], us[ok]] = color
    return img


def save_demo_frame(out_dir, frame_id, image_u8, cad_mm, rt_est_mm, k,
                    rt_gt_mm=None, depth_mm=None, scene_ply=False):
    """Write ``<frame_id>_overlay.png`` with the estimate (red) and the GT
    (blue) painted over the image; with ``scene_ply`` (and ``depth_mm``)
    also the frame's coloured scene cloud as ``<frame_id>_scene.ply``.
    Returns the overlay's path."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    img = draw_overlay(image_u8, cad_mm, rt_est_mm, k, color=(255, 0, 0))
    if rt_gt_mm is not None:
        img = draw_overlay(img, cad_mm, rt_gt_mm, k, color=(0, 0, 255))
    path = os.path.join(out_dir, f"{frame_id}_overlay.png")
    Image.fromarray(img).save(path)
    if scene_ply and depth_mm is not None:
        save_scene_ply(os.path.join(out_dir, f"{frame_id}_scene.ply"),
                       image_u8, depth_mm, k)
    return path


def rgbd_to_color_point_cloud(k, depth, rgb):
    """(N, 6) f64 [x, y, z, r, g, b] of every pixel with depth > 0, in the
    depth's units, back-projected in f32 (the reference's unused debug
    helper, AccumulatorSpace.py:87-98)."""
    xyz, valid = geometry.backproject_dense(_f32(depth), k)
    vs, us = valid.numpy().nonzero()
    rgb = np.asarray(rgb)
    return np.concatenate(
        [xyz.numpy()[vs, us].astype(np.float64),
         rgb[vs, us, :3].astype(np.float64)], axis=1)


def save_scene_ply(path, image_u8, depth_mm, k):
    """Write the frame's coloured scene cloud (mm) as a binary-LE PLY,
    readable back by ``readers.read_ply_points`` (positions)."""
    pts = rgbd_to_color_point_cloud(k, depth_mm, np.asarray(image_u8))
    rec = np.empty(len(pts), dtype=np.dtype(
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
         ("red", "u1"), ("green", "u1"), ("blue", "u1")]))
    for i, name in enumerate(("x", "y", "z")):
        rec[name] = pts[:, i]
    for i, name in enumerate(("red", "green", "blue")):
        rec[name] = pts[:, 3 + i].astype(np.uint8)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(rec)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return path
