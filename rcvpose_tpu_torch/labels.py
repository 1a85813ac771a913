"""Image normalization and training labels (counterpart of
``rcvpose_tpu.labels``), batched, on the input's device.

``make_sample`` is the label half of the JAX loader's ``transform_batch``
(``data/loader.py``): normalized images, radial maps in decimeters and
+/-1 semantic maps for a batch of frames, one keypoint or several
(``kpt_heads > 1`` stacks them on a last axis), even-cropped.
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
