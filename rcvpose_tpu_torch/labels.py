"""Image normalization and training labels (counterpart of
``rcvpose_tpu.labels``), batched, on the input's device.

``make_sample`` is the label half of the JAX loader's ``transform_batch``
(``data/loader.py``): normalized images, radial maps in decimeters and
+/-1 semantic maps for a batch of frames, one keypoint or several
(``kpt_heads > 1`` stacks them on a last axis), even-cropped.
``radial_labels_from_cad`` makes one frame's labels from the CAD model
alone, z-buffered.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image(img_u8):
    """uint8/float (..., H, W, 3) RGB tensor -> float32 ImageNet-normalized,
    channels last, on the input's device."""
    img = img_u8.to(torch.float32) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def radial_labels(depth_mm, mask, pose, kpt_m, k, max_radii_dm,
                  ycb_clip=False):
    """Dense radial and semantic labels for a batch of frames.

    Args:
      depth_mm: (B, H, W) depth in millimeters (0 = no return).
      mask: (B, H, W) object mask; depth counts only where it is nonzero.
      pose: (B, 3, 4) poses, rotation and translation in meters.
      kpt_m: (3,) one keypoint or (K, 3) keypoints, model frame, meters.
      k: (3, 3) intrinsics.
      max_radii_dm: scalar, or (K,) with (K, 3) keypoints; larger radii are
        zeroed.
      ycb_clip: also zero radii >= 10 dm (the reference's YCB filter).

    Returns (radial_dm, sem), f32, (B, H, W) for one keypoint or
    (B, H, W, K) for several: radii in decimeters (0 = background) and +1
    object / -1 background.
    """
    dev = depth_mm.device
    f32 = torch.float32
    depth = depth_mm.to(f32)
    valid = (mask != 0) & (depth > 0)
    k = torch.as_tensor(k, dtype=f32, device=dev)
    _, h, w = depth.shape
    us = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    vs = torch.arange(h, dtype=f32, device=dev)[None, :, None]
    xyz_m = torch.stack([(us - k[0, 2]) * depth / k[0, 0],
                         (vs - k[1, 2]) * depth / k[1, 1],
                         depth], dim=-1) / 1000.0        # (B, H, W, 3)

    single = torch.as_tensor(kpt_m).dim() == 1
    kpt = torch.as_tensor(kpt_m, dtype=f32, device=dev).reshape(-1, 3)
    pose = torch.as_tensor(pose, dtype=f32, device=dev)
    # keypoints into the camera frame by the reference's mm-unit route
    # (data_loader.py:78-85): translation x1000, keypoint x1000, back to m
    kpt_cam_m = (torch.einsum("bij,kj->bki", pose[:, :, :3], kpt * 1000.0)
                 + pose[:, None, :, 3] * 1000.0) / 1000.0   # (B, K, 3)

    diff = xyz_m[:, :, :, None, :] - kpt_cam_m[:, None, None]  # (B,H,W,K,3)
    dist_m = torch.sqrt((diff * diff).sum(-1))
    maxr = torch.as_tensor(max_radii_dm, dtype=f32, device=dev).reshape(-1)
    radial = torch.where(valid[..., None], dist_m * 10.0, 0.0)
    radial = torch.where(radial > maxr, 0.0, radial)
    if ycb_clip:
        radial = torch.where(radial >= 10.0, 0.0, radial)
    sem = torch.where(radial > 0, 1.0, -1.0)
    if single:
        return radial[..., 0], sem[..., 0]
    return radial, sem


def _rigid(pts, pose):
    """``pts @ pose[:, :3].T + pose[:, 3]`` as elementwise products and
    sums in a fixed order (no matmul), so that every device rounds alike."""
    return (pts[..., 0:1] * pose[:, 0] + pts[..., 1:2] * pose[:, 1]
            + pts[..., 2:3] * pose[:, 2] + pose[:, 3])


def radial_labels_from_cad(cad_m, pose, kpt_m, k, max_radii_dm, hw):
    """Z-buffered CAD-projection labels for one frame, no depth sensor.

    Projects the posed CAD cloud, keeps the nearest (min-z) point per pixel
    and writes that point's keypoint distance: two scatter-mins (z, then
    the lowest point index among the z-winners) and one gather. Points off
    the frame or behind the camera scatter +inf / ``n`` into pixel 0, which
    changes nothing. The reference's abandoned rasterizer
    (3DRadius_lm.py:87-118) carried the previous pixel's point when its
    ``z <= mean(z)`` gate failed, an order-dependent bug; the z-buffer is
    the rule that code reached for, so the carry is not reproduced.

    Args:
      cad_m: (N, 3) CAD points, model frame, meters; a tensor fixes the
        device (numpy runs on the CPU).
      pose: (3, 4) pose, rotation and translation in meters.
      kpt_m: (3,) keypoint, model frame, meters.
      k: (3, 3) intrinsics.
      max_radii_dm: max keypoint radius (dm); larger radii are zeroed.
      hw: (H, W) output size.

    Returns (radial_dm, sem), f32 (H, W): radii in decimeters (0 =
    background or occluded) and +1 object / -1 background.
    """
    h, w = hw
    f32 = torch.float32
    cad = torch.as_tensor(cad_m, dtype=f32)
    dev = cad.device
    pose = torch.as_tensor(pose, dtype=f32, device=dev)
    kpt = torch.as_tensor(kpt_m, dtype=f32, device=dev)
    k = torch.as_tensor(k, dtype=f32, device=dev)
    cam_m = _rigid(cad, pose)
    # the keypoint by the same mm-unit route as radial_labels
    # (data_loader.py:78-85)
    pose_mm = torch.cat([pose[:, :3], pose[:, 3:] * 1000.0], dim=1)
    kpt_cam_m = _rigid(kpt * 1000.0, pose_mm) / 1000.0

    z = cam_m[:, 2]
    u = torch.round(cam_m[:, 0] / z * k[0, 0] + k[0, 2]).to(torch.int64)
    v = torch.round(cam_m[:, 1] / z * k[1, 1] + k[1, 2]).to(torch.int64)
    ok = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = torch.where(ok, v * w + u, 0)

    inf = torch.tensor(float("inf"), device=dev)
    zbuf = torch.full((h * w,), float("inf"), device=dev).scatter_reduce_(
        0, flat, torch.where(ok, z, inf), "amin", include_self=True)
    # among the min-z points of each pixel, the lowest index wins
    front = ok & (z <= zbuf[flat])
    n = cam_m.shape[0]
    idx = torch.arange(n, device=dev)
    ibuf = torch.full((h * w,), n, device=dev).scatter_reduce_(
        0, flat, torch.where(front, idx, n), "amin", include_self=True)

    diff = cam_m - kpt_cam_m
    dist_dm = torch.sqrt((diff * diff).sum(dim=-1)) * 10.0
    dist_dm = torch.cat([dist_dm, dist_dm.new_zeros(1)])
    radial = dist_dm[ibuf].reshape(h, w)
    radial = torch.where(radial > max_radii_dm, 0.0, radial)
    sem = torch.where(radial > 0, 1.0, -1.0)
    return radial, sem


def even_crop(*arrays):
    """Crop dims 1 and 2 (H, W) of batched arrays to even sizes (reference
    data_loader.py:97-101)."""
    return tuple(a[:, :a.shape[1] - a.shape[1] % 2, :a.shape[2] - a.shape[2] % 2]
                 for a in arrays)


def make_sample(img_u8, depth_mm, mask, pose, kpt_m, k, max_radii_dm,
                ycb_clip=False):
    """A training batch from frames: ``{"image": (B, H, W, 3) normalized,
    "radial": (B, H, W[, K]), "sem": (B, H, W[, K])}``, f32, even-cropped,
    on the frames' device."""
    img = normalize_image(img_u8)
    radial, sem = radial_labels(depth_mm, mask, pose, kpt_m, k, max_radii_dm,
                                ycb_clip=ycb_clip)
    img, radial, sem = even_crop(img, radial, sem)
    return {"image": img, "radial": radial, "sem": sem}
