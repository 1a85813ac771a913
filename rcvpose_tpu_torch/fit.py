"""Closed-form rigid pose fitting (counterpart of ``rcvpose_tpu.fit``).

Horn's 1987 quaternion least-squares fit: build the 4x4 quaternion matrix
N and take its max-eigenvalue eigenvector by shifted repeated squaring, as
the JAX package does (no ``eigh``), so both packages take the same steps.

``icp_point_to_point`` is Open3D's point-to-point ICP as the JAX package
writes it: brute-force nearest neighbours, a weighted Horn fit per
iteration, a fixed iteration count or Open3D's convergence test. On CUDA
tensors its nearest neighbours and pose update run as the kernels of
``ops.icp_cuda``, which build no distance matrix.
"""

from __future__ import annotations

import torch

from rcvpose_tpu_torch.ops import icp_cuda


def _quat_to_rot(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation (Horn's convention)."""
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
    """Max-eigenvalue eigenvector of a symmetric 4x4.

    Gershgorin-shift the spectrum positive (same top eigenvector), then
    square the matrix ``squarings`` times, normalizing each time: 2^10
    power-iteration steps, exact to f32 for any nonzero eigengap.
    """
    diag = torch.diagonal(n)
    row_abs = n.abs().sum(dim=1)
    lower = torch.min(diag - (row_abs - diag.abs()))
    c = torch.clamp(-lower, min=0.0) + 1e-6 * n.abs().max()
    a = n + c * torch.eye(4, dtype=n.dtype, device=n.device)
    for _ in range(squarings):
        a = a / torch.clamp(a.abs().max(), min=1e-30)
        a = a @ a
    # a ~ lam^(2^k) v v^T: any non-orthogonal probe lands on v
    q = a @ torch.full((4,), 0.5, dtype=n.dtype, device=n.device)
    return q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)


def horn_fit(p1, p2, weights=None):
    """Least-squares rigid transform A (4x4) with A[:3] @ [p1, 1] ~= p2.

    p1, p2: (N, 3) source and destination points; weights: optional (N,)
    non-negative weights. Returns the (4, 4) f32 transform on p1's device.
    """
    p1 = p1.to(torch.float32)
    p2 = p2.to(torch.float32)
    if weights is None:
        weights = torch.ones(p1.shape[0], dtype=torch.float32,
                             device=p1.device)
    return _horn_solve(*_horn_sums(p1, p2, weights.to(torch.float32)))


def _horn_sums(p1, p2, w):
    """Horn's weighted sums of f32 (N, 3) points and (N,) weights: the
    cross-covariance S (3, 3) of the centred points and both centroids."""
    wsum = torch.clamp(w.sum(), min=1e-12)
    c1 = (p1 * w[:, None]).sum(dim=0) / wsum
    c2 = (p2 * w[:, None]).sum(dim=0) / wsum
    q1 = p1 - c1
    q2 = p2 - c2
    # S[a, b] = sum_i w_i * q1[i, a] * q2[i, b]
    return (q1 * w[:, None]).T @ q2, c1, c2


def _horn_solve(s, c1, c2):
    """The (4, 4) transform of Horn's sums ``_horn_sums``."""
    sxx, sxy, sxz = s[0, 0], s[0, 1], s[0, 2]
    syx, syy, syz = s[1, 0], s[1, 1], s[1, 2]
    szx, szy, szz = s[2, 0], s[2, 1], s[2, 2]
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx]),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz]),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy]),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]),
    ])
    q = _max_eigvec_4x4(n)
    r = _quat_to_rot(q)
    t = c2 - r @ c1
    a = torch.eye(4, dtype=torch.float32, device=s.device)
    a[:3, :3] = r
    a[:3, 3] = t
    return a


def _update_pose(s, c1, c2, n_corr, rt):
    """An ICP update's new pose: Horn's transform of the sums composed
    onto ``rt``, or ``rt`` where fewer than 3 correspondences were found."""
    return torch.where(n_corr >= 3.0, _horn_solve(s, c1, c2) @ rt, rt)


def _nn(src, target, t2, target_mask):
    """Nearest target of each source point: (index, distance). d2 in the
    ``|s|^2 - 2 s.t + |t|^2`` form in full f32; masked targets excluded;
    ``argmin`` takes the first index on ties."""
    d2 = ((src * src).sum(dim=1)[:, None] - 2.0 * torch.matmul(src, target.T)
          + t2[None, :])
    d2 = torch.where(target_mask[None, :], d2, torch.full_like(d2, 1e30))
    idx = torch.argmin(d2, dim=1)
    dmin = d2.gather(1, idx[:, None])[:, 0]
    return idx, torch.sqrt(torch.clamp(dmin, min=0.0))


def icp_point_to_point(source, target, target_mask, init, threshold,
                       max_iters=30, rel_fitness=None, rel_rmse=None,
                       return_iters=False):
    """Point-to-point ICP: align ``source`` onto ``target``.

    Mirrors Open3D ``registration_icp(source, target, threshold, init,
    TransformationEstimationPointToPoint())`` as the JAX package does:

    * ``rel_fitness``/``rel_rmse`` both None: ``max_iters`` updates, the
      reference's LM/LMO criteria. The loop stays on the device: a step
      that finds fewer than 3 correspondences keeps the transform.
    * tolerances set: iterate to convergence, the reference's YCB criteria.
      Stop when the absolute change of both fitness (inlier fraction of
      source points) and inlier RMSE drops below its tolerance, or after
      ``max_iters`` updates. Quality is evaluated before the update, so the
      returned transform is the one whose quality passed, and the count is
      the number of updates applied. This loop reads the convergence flag
      on the host once per iteration; it is not on the LM path.

    Args:
      source: (S, 3) model points (e.g. CAD vertices, mm).
      target: (T, 3) scene points, padded.
      target_mask: (T,) bool validity of scene points.
      init: (4, 4) initial transform.
      threshold: max correspondence distance (a float or 0-d tensor).
      max_iters: iteration count (fixed mode) or cap (converged mode).
      rel_fitness / rel_rmse: Open3D-style convergence tolerances.
      return_iters: also return the number of updates applied.

    Returns: (4, 4) refined transform (plus the update count when
    ``return_iters``).

    On CUDA tensors the nearest neighbours and the pose update run as the
    kernels of ``ops.icp_cuda``, which round as the tensor ops they stand
    for round on the card: the same transform bit for bit, without the
    S x T distance matrix or the 4 x 4 solve's small launches.
    """
    return _icp(source, target, target_mask, init, threshold, max_iters,
                rel_fitness, rel_rmse, return_iters,
                kernels=source.device.type == "cuda")


def _icp(source, target, target_mask, init, threshold, max_iters,
         rel_fitness, rel_rmse, return_iters, kernels):
    """``icp_point_to_point``; ``kernels`` picks ``ops.icp_cuda``'s
    kernels (CUDA tensors) or the tensor ops (any device)."""
    source = source.to(torch.float32)
    target = target.to(torch.float32)
    device = source.device
    t2 = (target * target).sum(dim=1)
    n_src = float(source.shape[0])
    threshold = torch.as_tensor(threshold, dtype=torch.float32,
                                device=device)
    if kernels:
        keys = icp_cuda.new_keys(source.shape[0], device)

        def nearest(src):
            return icp_cuda.nearest_cuda(src, target, t2, target_mask, keys)
        update = icp_cuda.update_pose_cuda
    else:
        def nearest(src):
            return _nn(src, target, t2, target_mask)
        update = _update_pose

    def one_iter(rt, quality=True):
        """One update and, with ``quality``, this iteration's fitness and
        inlier RMSE."""
        src_tf = source @ rt[:3, :3].T + rt[:3, 3]
        idx, dist = nearest(src_tf)
        w = (dist <= threshold).to(torch.float32)
        n_corr = w.sum()
        new_rt = update(*_horn_sums(src_tf, target[idx], w), n_corr, rt)
        if not quality:
            return new_rt, None, None
        fitness = n_corr / n_src
        rmse = torch.sqrt((w * dist * dist).sum()
                          / torch.clamp(n_corr, min=1.0))
        return new_rt, fitness, rmse

    rt = init.to(device=device, dtype=torch.float32)
    if rel_fitness is None and rel_rmse is None:
        for _ in range(max_iters):
            rt, _, _ = one_iter(rt, quality=False)
        return (rt, max_iters) if return_iters else rt

    tol_f = 0.0 if rel_fitness is None else rel_fitness
    tol_r = 0.0 if rel_rmse is None else rel_rmse
    # The first evaluation compares against -1 sentinels, as Open3D's first
    # comparison (update 1's quality against the init's) does.
    prev_f = prev_r = torch.tensor(-1.0, device=device)
    n_upd = 0
    while n_upd < max_iters:
        new_rt, fitness, rmse = one_iter(rt)
        done = ((prev_f - fitness).abs() < tol_f) & ((prev_r - rmse).abs()
                                                     < tol_r)
        if bool(done):
            break
        rt, prev_f, prev_r = new_rt, fitness, rmse
        n_upd += 1
    return (rt, n_upd) if return_iters else rt
