"""The frame's pose from its maps, in plain PyTorch float32: the
benchmark's frozen reference of the masks, the packing, the hier radial
vote, Horn's fit and point-to-point ICP.

RCVPose (arXiv 2104.02527): pixels that pass the segmentation test and
whose radius lies under the keypoint's maximum, and that have depth, are
back-projected inside a window centred on them; every such point votes
for the 5 mm voxels at its predicted distance (a shell of half-thickness
sqrt(3)/4 voxel) in a cube recentred on the points' mean; a coarse vote on
4x4x4 cells over every 8th point ranks cells, and the voxels of 8^3
windows around the 32 best are counted over every point; the first
largest count is the keypoint. Horn's 1987 quaternion fit maps the
model's keypoints onto the three; ICP (Open3D's point-to-point, a fixed
iteration count) refines the pose against the scene's points. The
arithmetic is written out step for step as the program states it, so
the same inputs give the same counts, peaks and transforms.

``low=True`` is the control one precision step below: the vote's
distances and bands in bfloat16, Horn's fit in bfloat16, and the ICP's
distance products with TF32 allowed.
"""

from __future__ import annotations

import math

import torch

VOTE_BAND = math.sqrt(3.0) / 4.0
ACC_UNIT_MM = 5.0
COARSE = 4
PAIRS_PER_CHUNK = 1 << 22


def _masked(valid, x):
    return torch.where(valid, x, torch.zeros_like(x))


def _band(r, mask, lo_of, hi_of):
    valid = mask & (r > 0)
    return _masked(valid, lo_of(r) ** 2), _masked(valid, hi_of(r) ** 2)


def counts(voxels, points, lo, hi, low=False):
    """(B, V) number of points whose squared distance to each voxel lies
    strictly inside (lo, hi); voxels (V, 3) or (B, V, 3), points (B, N, 3).
    """
    b, n, _ = points.shape
    vox = voxels.expand(b, -1, -1) if voxels.dim() == 2 else voxels
    if low:
        vox, points, lo, hi = (t.to(torch.bfloat16)
                               for t in (vox, points, lo, hi))
    acc = torch.zeros(vox.shape[:2], dtype=torch.int64, device=points.device)
    chunk = max(1, PAIRS_PER_CHUNK // max(1, b * vox.shape[1]))
    for c0 in range(0, n, chunk):
        p = points[:, None, c0:c0 + chunk, :]
        dx = vox[:, :, None, 0] - p[..., 0]
        dy = vox[:, :, None, 1] - p[..., 1]
        dz = vox[:, :, None, 2] - p[..., 2]
        d2 = dx * dx + dy * dy + dz * dz
        acc += ((d2 > lo[:, None, c0:c0 + chunk])
                & (d2 < hi[:, None, c0:c0 + chunk])).sum(dim=-1)
    return acc.to(torch.float32)


def grid(side, device):
    c = torch.arange(side, dtype=torch.float32, device=device)
    ii, jj, kk = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], 1)


def _unravel(flat, side):
    return torch.stack([flat // (side * side), (flat // side) % side,
                        flat % side], dim=-1).to(torch.float32)


def _voxelize(xyz_m, radial_dm, mask):
    mask_f = mask.to(torch.float32)
    n = torch.clamp(mask_f.sum(dim=1), min=1.0)
    xyz = xyz_m.to(torch.float32) * (1000.0 / ACC_UNIT_MM)
    means = (xyz * mask_f[..., None]).sum(dim=1) / n[:, None]
    centred = xyz - means[:, None, :]
    radii = radial_dm.to(torch.float32) * (100.0 / ACC_UNIT_MM)
    radii_round = torch.round(radii)
    big = torch.tensor(3e38, dtype=torch.float32, device=xyz_m.device)
    m3 = mask[..., None]
    cmin = torch.where(m3, centred, big).amin(dim=(1, 2))
    cmax = torch.where(m3, centred, -big).amax(dim=(1, 2))
    rmax = torch.where(mask, radii, -big).amax(dim=1)
    zero_boundary = torch.trunc(cmin - rmax) + 1.0
    shift = torch.where(zero_boundary < 0, zero_boundary,
                        torch.zeros_like(zero_boundary))
    shifted = centred - shift[:, None, None]
    bound = torch.trunc(cmax - shift) + torch.trunc(rmax)
    shifted = torch.where(m3, shifted, torch.full_like(shifted, 1e9))
    return shifted, radii_round, means, shift, bound


def hier_vote(xyz_m, radial_dm, mask, grid_l, topk, cpt_stride, win,
              low=False):
    """(B, N, 3) points (m), (B, N) radii (dm) and mask -> (B, 3) centres
    (mm) by the coarse-to-fine vote."""
    pts, rr, means, shift, bound = _voxelize(xyz_m, radial_dm, mask)
    device, b = pts.device, pts.shape[0]
    lc = grid_l // COARSE
    cc = torch.arange(lc, dtype=torch.float32, device=device)
    coarse_vox = (grid(lc, device) + 0.5) * COARSE - 0.5
    slack = VOTE_BAND + math.sqrt(3.0) * COARSE / 2.0
    lo_c, hi_c = _band(rr, mask, lambda r: torch.clamp(r - slack, min=0.0),
                       lambda r: r + slack)
    cvotes = counts(coarse_vox, pts[:, ::cpt_stride], lo_c[:, ::cpt_stride],
                    hi_c[:, ::cpt_stride], low)
    cin = cc[None, :] < torch.ceil(bound / COARSE)[:, None]
    cvalid = (cin[:, :, None, None] & cin[:, None, :, None]
              & cin[:, None, None, :]).reshape(b, -1)
    cvotes = torch.where(cvalid, cvotes, torch.full_like(cvotes, -1.0))
    top = torch.sort(cvotes, dim=1, descending=True, stable=True).indices[
        :, :topk]
    base = _unravel(top, lc) * COARSE - (win - COARSE) // 2
    bases = torch.clamp(base, 0, grid_l - win)
    win_vox = (bases[:, :, None, :] + grid(win, device)[None, None]).reshape(
        b, -1, 3)
    lo_f, hi_f = _band(rr, mask, lambda r: r - VOTE_BAND, lambda r: r)
    fvotes = counts(win_vox, pts, lo_f, hi_f, low)
    fvalid = (win_vox < bound[:, None, None]).all(dim=2)
    fvotes = torch.where(fvalid, fvotes,
                         torch.full_like(fvotes, -1.0)).reshape(b, topk, -1)
    best = torch.argmax(fvotes.amax(dim=2), dim=1)
    rows = torch.arange(b, device=device)
    peak = bases[rows, best] + _unravel(torch.argmax(fvotes[rows, best],
                                                     dim=1), win)
    return (peak + shift[:, None] + means + 0.5) * ACC_UNIT_MM


def _window_origin(any_rows, any_cols, win_h, win_w):
    h, w = any_rows.shape[0], any_cols.shape[0]
    ri = torch.arange(h, device=any_rows.device)
    ci = torch.arange(w, device=any_cols.device)
    big = 1 << 30
    r0 = torch.where(any_rows, ri, big).min()
    r1 = torch.where(any_rows, ri, -1).max()
    c0 = torch.where(any_cols, ci, big).min()
    c1 = torch.where(any_cols, ci, -1).max()
    rc = torch.where(r0 > r1, h // 2, (r0 + r1) // 2)
    cc = torch.where(c0 > c1, w // 2, (c0 + c1) // 2)
    return (torch.clamp(rc - win_h // 2, 0, h - win_h),
            torch.clamp(cc - win_w // 2, 0, w - win_w))


def _pack(flat_valid, n_points):
    """Indices of the first ``n_points`` valid entries, then the rest, in
    ascending order; and the mask of the valid ones among them."""
    n = flat_valid.shape[0]
    idx = torch.arange(n, device=flat_valid.device)
    key = torch.where(flat_valid, idx, torch.full_like(idx, n))
    k = min(n_points, n)
    order = torch.sort(key, stable=True).indices[:k]
    if k < n_points:
        order = torch.nn.functional.pad(order, (0, n_points - k))
    mask = (torch.arange(n_points, device=flat_valid.device)
            < torch.clamp(flat_valid.sum(), max=n_points))
    return order, mask


def pose_from_maps(sem_maps, radial_maps, depth_mm, k, max_radii_dm,
                   kpts_mm, cfg, low=False):
    """(K, H, W) segmentation and radius maps + (H, W) depth -> dict of
    ``rt`` (4, 4), ``centers`` (K, 3) mm, ``counts`` (K,) pixels in the
    window, ``scene_pts`` (K N, 3) mm and ``scene_mask`` (K N,).

    ``cfg``: the serving settings (``sem_threshold``, ``max_points``,
    ``vote_grid_l``, ``vote_topk``, ``vote_cpt_stride``, ``vote_win``,
    ``pack_win_h``, ``pack_win_w``)."""
    device = depth_mm.device
    n_kpt = sem_maps.shape[0]
    h, w = depth_mm.shape
    win_h, win_w = min(cfg["pack_win_h"], h), min(cfg["pack_win_w"], w)
    n_points = cfg["max_points"]
    sems = (sem_maps > cfg["sem_threshold"]) & (
        radial_maps <= max_radii_dm[:, None, None])
    sems = sems & (depth_mm > 0)
    union = sems.any(dim=0)
    ro, co = _window_origin(union.any(dim=1), union.any(dim=0), win_h, win_w)
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
    order, umask = _pack(flat_union, n_points)
    pts = torch.where(umask[:, None], flat_xyz[order], 0.0)
    semw = crop(sems)
    n_in = (semw & (depw > 0)).sum(dim=(1, 2)).to(torch.int32)
    valid = semw.reshape(n_kpt, -1)[:, order] & umask & flat_union[order]
    rad = torch.where(valid, crop(radial_maps).reshape(n_kpt, -1)[:, order],
                      0.0)
    centers = hier_vote(pts.expand(n_kpt, -1, -1), rad, valid,
                        cfg["vote_grid_l"], cfg["vote_topk"],
                        cfg["vote_cpt_stride"], cfg["vote_win"], low)
    return {"rt": horn_fit(kpts_mm, centers, low=low), "centers": centers,
            "counts": n_in,
            "scene_pts": (pts * 1000.0).expand(n_kpt, -1, -1).reshape(-1, 3),
            "scene_mask": valid.reshape(-1)}


def _quat_to_rot(q):
    q0, q1, q2, q3 = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([q0*q0 + q1*q1 - q2*q2 - q3*q3, 2*(q1*q2 - q0*q3),
                     2*(q1*q3 + q0*q2)]),
        torch.stack([2*(q1*q2 + q0*q3), q0*q0 + q2*q2 - q1*q1 - q3*q3,
                     2*(q2*q3 - q0*q1)]),
        torch.stack([2*(q1*q3 - q0*q2), 2*(q2*q3 + q0*q1),
                     q0*q0 + q3*q3 - q1*q1 - q2*q2]),
    ])


def _max_eigvec_4x4(n, squarings=10):
    diag = torch.diagonal(n)
    row_abs = n.abs().sum(dim=1)
    lower = torch.min(diag - (row_abs - diag.abs()))
    c = torch.clamp(-lower, min=0.0) + 1e-6 * n.abs().max()
    a = n + c * torch.eye(4, dtype=n.dtype, device=n.device)
    for _ in range(squarings):
        a = a / torch.clamp(a.abs().max(), min=1e-30)
        a = a @ a
    q = a @ torch.full((4,), 0.5, dtype=n.dtype, device=n.device)
    return q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)


def horn_fit(p1, p2, weights=None, low=False):
    """Least-squares rigid (4, 4) transform A with A[:3] @ [p1, 1] ~ p2."""
    dt = torch.bfloat16 if low else torch.float32
    p1, p2 = p1.to(dt), p2.to(dt)
    if weights is None:
        weights = torch.ones(p1.shape[0], dtype=dt, device=p1.device)
    w = weights.to(dt)
    wsum = torch.clamp(w.sum(), min=1e-12)
    c1 = (p1 * w[:, None]).sum(dim=0) / wsum
    c2 = (p2 * w[:, None]).sum(dim=0) / wsum
    q1, q2 = p1 - c1, p2 - c2
    s = (q1 * w[:, None]).T @ q2
    sxx, sxy, sxz = s[0, 0], s[0, 1], s[0, 2]
    syx, syy, syz = s[1, 0], s[1, 1], s[1, 2]
    szx, szy, szz = s[2, 0], s[2, 1], s[2, 2]
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx]),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz]),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy]),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]),
    ])
    r = _quat_to_rot(_max_eigvec_4x4(n))
    t = c2 - r @ c1
    a = torch.eye(4, dtype=torch.float32, device=p1.device)
    a[:3, :3] = r.float()
    a[:3, 3] = t.float()
    return a


def icp(source, target, target_mask, init, threshold, iters, low=False):
    """Point-to-point ICP of ``source`` onto ``target`` for ``iters``
    updates; a step with fewer than 3 correspondences keeps the pose."""
    source, target = source.float(), target.float()
    t2 = (target * target).sum(dim=1)
    threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                device=source.device)
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = low
    try:
        rt = init.float()
        for _ in range(iters):
            src = source @ rt[:3, :3].T + rt[:3, 3]
            d2 = ((src * src).sum(dim=1)[:, None]
                  - 2.0 * torch.matmul(src, target.T) + t2[None, :])
            d2 = torch.where(target_mask[None, :], d2,
                             torch.full_like(d2, 1e30))
            idx = torch.argmin(d2, dim=1)
            dist = torch.sqrt(torch.clamp(d2.gather(1, idx[:, None])[:, 0],
                                          min=0.0))
            w = (dist <= threshold).to(torch.float32)
            delta = horn_fit(src, target[idx], weights=w, low=low)
            rt = torch.where(w.sum() >= 3.0, delta @ rt, rt)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
    return rt
