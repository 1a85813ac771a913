"""Pinhole-camera geometry on tensors (counterpart of ``rcvpose_tpu.geometry``).

Back-projection is dense (every pixel maps to an (x, y, z) triple plus a
validity flag) and point compaction keeps static shapes, as in the JAX
package, so the frame program never needs a host round trip.
"""

from __future__ import annotations

import numpy as np
import torch

# LINEMOD camera intrinsics (reference: data_loader.py:9-11).
LINEMOD_K = np.array(
    [[572.4114, 0.0, 325.2611],
     [0.0, 573.57043, 242.04899],
     [0.0, 0.0, 1.0]],
    dtype=np.float64,
)


def _as_f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def transform_points(xyz, rt):
    """Apply a rigid transform. ``xyz``: (N, 3); ``rt``: (3, 4) or (4, 4)."""
    rt = _as_f32(rt, xyz.device)
    return xyz @ rt[:3, :3].T + rt[:3, 3]


def project(xyz, k, rt):
    """World points -> (pixel xy, camera-frame xyz)."""
    cam_xyz = transform_points(xyz, rt)
    uvw = cam_xyz @ _as_f32(k, xyz.device).T
    xy = uvw[..., :2] / uvw[..., 2:]
    return xy, cam_xyz


def backproject_dense(depth, k):
    """(H, W) depth -> ((H, W, 3) camera-frame points, (H, W) bool valid).

    x = (u - cx) z / fx, y = (v - cy) z / fy over every pixel; points are
    garbage where ``depth == 0``, so gate on ``valid``.
    """
    h, w = depth.shape
    dtype = depth.dtype if depth.is_floating_point() else torch.float32
    k = torch.as_tensor(k, dtype=dtype, device=depth.device)
    z = depth.to(dtype)
    us = torch.arange(w, dtype=dtype, device=depth.device)[None, :]
    vs = torch.arange(h, dtype=dtype, device=depth.device)[:, None]
    xs = (us - k[0, 2]) * z / k[0, 0]
    ys = (vs - k[1, 2]) * z / k[1, 1]
    return torch.stack([xs, ys, z], dim=-1), depth > 0


def pack_valid_indices(flat_valid, n_points):
    """Indices of the first ``n_points`` True entries (row-major), plus a
    validity mask of length ``n_points``.

    A stable sort of ``where(valid, idx, n)`` puts the valid indices first
    in ascending order and the invalid ones after them, also ascending:
    the order the JAX package's min-k gives, ties included.
    """
    n = flat_valid.shape[0]
    idx = torch.arange(n, device=flat_valid.device)
    key = torch.where(flat_valid, idx, torch.full_like(idx, n))
    k = min(n_points, n)  # source may hold fewer pixels than the budget
    order = torch.sort(key, stable=True).indices[:k]
    if k < n_points:
        order = torch.nn.functional.pad(order, (0, n_points - k))
    count = flat_valid.sum()
    mask = (torch.arange(n_points, device=flat_valid.device)
            < torch.clamp(count, max=n_points))
    return order, mask


def depth_hypothesis_clouds(pixel_mask, k, z_min_m, n_hyp, n_points,
                            step_m=1e-3):
    """Depth-hypothesis clouds for the RGB-only ablation (reference
    ``rgbd_to_point_cloud_no_depth``, AccumulatorSpace.py:100-120).

    Every masked pixel is back-projected onto ``n_hyp`` constant-depth
    planes ``z_i = z_min_m + i * step_m``. Pixels are packed by
    ``pack_valid_indices``: masked pixels in row-major order, truncated or
    padded to ``n_points``.

    Args:
      pixel_mask: (H, W) bool tensor, the pixels that vote (the sem mask).
      k: (3, 3) intrinsics.
      z_min_m: first plane's depth in meters (float or 0-d tensor).
      n_hyp: number of planes.
      n_points: packed pixel budget.
      step_m: plane spacing in meters (reference: 0.001).

    Returns ``(clouds (n_hyp, n_points, 3) m, mask (n_points,), order
    (n_points,) flat pixel index of each packed point, count ())`` on the
    mask's device; padded entries carry the plane's z and x = y = 0.
    """
    dev = pixel_mask.device
    f32 = torch.float32
    h, w = pixel_mask.shape
    k = _as_f32(k, dev)
    us = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
    vs = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w)
    xs_unit = (us - k[0, 2]) / k[0, 0]   # x at z = 1
    ys_unit = (vs - k[1, 2]) / k[1, 1]
    flat_valid = pixel_mask.reshape(-1)
    order, mask = pack_valid_indices(flat_valid, n_points)
    xu = torch.where(mask, xs_unit.reshape(-1)[order], 0.0)
    yu = torch.where(mask, ys_unit.reshape(-1)[order], 0.0)
    zs = (_as_f32(z_min_m, dev)
          + torch.arange(n_hyp, dtype=f32, device=dev) * step_m)   # (D,)
    clouds = torch.stack([xu[None, :] * zs[:, None],
                          yu[None, :] * zs[:, None],
                          zs[:, None].expand(n_hyp, n_points)], dim=-1)
    return clouds, mask, order, flat_valid.sum().to(torch.int32)


def depth_to_pointcloud(depth, k, n_points, fill_value=0.0):
    """Back-project and compact valid pixels into a fixed-size point set.

    Returns ``(pts (n_points, 3), mask (n_points,), count ())``: valid
    points in row-major pixel order, truncated or padded with
    ``fill_value``; ``count`` is the number of valid pixels before
    truncation.
    """
    xyz, valid = backproject_dense(depth, k)
    flat_xyz = xyz.reshape(-1, 3)
    flat_valid = valid.reshape(-1)
    count = flat_valid.sum()
    idx, mask = pack_valid_indices(flat_valid, n_points)
    pts = torch.where(mask[:, None], flat_xyz[idx],
                      torch.full_like(flat_xyz[idx], fill_value))
    return pts, mask, count
