"""The 3D radial-voting accumulator (counterpart of ``rcvpose_tpu.ops.voting``).

Static shapes as in the JAX package: the vote grid is a fixed ``L^3`` cube
whose data-dependent extent becomes a validity bound at argmax time, and
point sets are padded with a mask. Votes are counted in the pair-evaluation
form ``votes[v] = sum_n [lo_n < d2(v, n) < hi_n]`` by K1
(``ops.vote_cuda``).

Every function here takes a leading keypoint dimension ``B`` where the JAX
package ``vmap``s over keypoints; ``accumulate_3d`` also takes one
unbatched point set. The decode follows the reference semantics: 5 mm
voxels, recentering by the masked mean, radii dm -> voxels rounded half to
even, ``zero_boundary = trunc(min - r_max) + 1``, the first row-major
argmax, ``center = (argmax + shift + mean + 0.5) * 5`` mm.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rcvpose_tpu_torch import profiling
from rcvpose_tpu_torch.ops import vote_cuda

# Shell half-thickness: reference ``factor = sqrt(3)/4``.
VOTE_BAND = math.sqrt(3.0) / 4.0
ACC_UNIT_MM = 5.0  # reference acc_unit


class AccumulatorResult(NamedTuple):
    center_mm: torch.Tensor    # (..., 3) estimated keypoint, millimeters
    peak_votes: torch.Tensor   # (...) vote count at the peak
    overflow: torch.Tensor     # (...) bool: the reference's dynamic grid
    #                            would not fit in the static L^3 cube
    peak_voxel: torch.Tensor   # (..., 3) argmax voxel (shifted grid)


# ---------------------------------------------------------------------------
# Band bounds (squared-distance form)
# ---------------------------------------------------------------------------

def band_votes(d2, r):
    """Oracle vote indicator, equivalent to the reference's
    ``0 < r - d < sqrt(3)/4`` for rounded radii r >= 0."""
    lo = r - VOTE_BAND
    return (d2 < r * r) & (d2 > lo * lo)


def _masked(valid, x):
    return torch.where(valid, x, torch.zeros_like(x))


def exact_band(radii_round, point_mask):
    """Per-point [lo, hi] d2 bounds of the exact band; masked points get
    lo = hi = 0 and can never vote."""
    r = radii_round
    valid = point_mask & (r > 0)
    lo = r - VOTE_BAND
    return _masked(valid, lo * lo), _masked(valid, r * r)


def widened_band(radii_round, point_mask, slack):
    """[lo, hi] for the hier coarse stage: the band widened by +/- slack."""
    r = radii_round
    valid = point_mask & (r > 0)
    lo = torch.clamp(r - slack, min=0.0)
    hi = r + slack
    return _masked(valid, lo * lo), _masked(valid, hi * hi)


def surface_band(radii_round, point_mask):
    """[lo, hi] for sphere-surface voting: the Andres annulus
    ``r - 1/2 <= |v - c| < r + 1/2`` in d2 form."""
    r = radii_round
    valid = point_mask & (r > 0)
    lo = torch.clamp(r - 0.5, min=0.0)
    hi = r + 0.5
    return _masked(valid, lo * lo), _masked(valid, hi * hi)


# ---------------------------------------------------------------------------
# Vote counting
# ---------------------------------------------------------------------------

def vote_counts_reference(voxels, points, radii, point_mask):
    """O(V*N) direct oracle over one point set (small problems, tests)."""
    diff = voxels[:, None, :] - points[None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    votes = band_votes(d2, radii[None, :]) & point_mask[None, :]
    return votes.sum(dim=1).to(torch.float32)


def vote_grid_oracle(points, radii, point_mask, grid_l):
    """Dense (L, L, L) vote grid, one point at a time by separable
    broadcast (an oracle for small grids: O(N * L^3) work). points (N, 3)
    in voxel coordinates, radii (N,) rounded voxels, point_mask (N,)."""
    coords = torch.arange(grid_l, dtype=torch.float32, device=points.device)
    acc = torch.zeros((grid_l,) * 3, dtype=torch.float32,
                      device=points.device)
    for p, r, m in zip(points.to(torch.float32), radii.to(torch.float32),
                       point_mask):
        d2 = ((coords - p[0])[:, None, None] ** 2
              + (coords - p[1])[None, :, None] ** 2
              + (coords - p[2])[None, None, :] ** 2)
        acc += (band_votes(d2, r) & m).to(torch.float32)
    return acc


def vote_counts(voxels, points, lo, hi, mxu=False):
    """Dispatch: K1 for CUDA tensors, its plain version for CPU tensors.

    voxels (V, 3) shared or (B, V, 3); points (B, N, 3); lo, hi (B, N).
    Returns (B, V) f32. K1 walks each row's points only up to its last
    one with ``hi > 0`` (``live_extent``, read on the card): a point votes
    only where ``lo < d2 < hi``, so none past it can, and a packed mask
    leaves the padding unwalked. ``mxu=True`` takes the matmul form of d2
    (K5, ``|v|^2 - 2v.p + |p|^2``), whose cancellation moves counts at
    band edges; as in the JAX package nothing passes it by default.
    """
    if points.device.type == "cuda":
        if mxu:
            return vote_cuda.vote_counts_mxu_cuda(voxels, points, lo, hi)
        return vote_cuda.vote_counts_cuda(voxels, points, lo, hi,
                                          n_live=live_extent(hi > 0))
    if points.device.type == "cpu":
        if mxu:
            return vote_cuda.vote_counts_mxu_plain(voxels, points, lo, hi)
        return vote_cuda.vote_counts_plain(voxels, points, lo, hi)
    raise ValueError(f"unsupported device {points.device}")


def live_extent(point_mask):
    """(B,) int32: per row of a (B, N) mask, its last True index + 1 (0
    for an empty row), so every entry at or past it is False. One
    reduction on the mask's device, no host read."""
    b, n = point_mask.shape
    if n == 0:
        return torch.zeros(b, dtype=torch.int32, device=point_mask.device)
    ends = torch.arange(1, n + 1, dtype=torch.int32, device=point_mask.device)
    return torch.where(point_mask, ends, 0).amax(dim=1)


def enumerate_grid(grid_l, device=None):
    """(L^3, 3) row-major voxel-center list for the exact mode."""
    c = torch.arange(grid_l, dtype=torch.float32, device=device)
    ii, jj, kk = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], 1)


def suggest_grid_l(object_diameter_m, max_radial_dm, slack_voxels=16,
                   multiple=32, cap=256):
    """Static grid side for a class, sized from the CAD diameter and the
    keypoint's max radius, rounded up; ``overflow`` still guards outliers."""
    extent_vox = object_diameter_m * 1000.0 / ACC_UNIT_MM
    rmax_vox = max_radial_dm * 100.0 / ACC_UNIT_MM
    need = extent_vox + 2.0 * rmax_vox + slack_voxels
    l = int(-(-need // multiple) * multiple)
    return min(max(l, 2 * multiple), cap)


# ---------------------------------------------------------------------------
# Voxelization frame
# ---------------------------------------------------------------------------

def _prepare(xyz_m, radial_dm, point_mask):
    """Voxelize, recenter and shift a (B, N) batch of point sets. All
    reductions are masked so padded points never move the grid frame.

    Returns (points_vox (B, N, 3), radii_rounded (B, N), means (B, 3),
    shift (B,), bound (B,)); valid voxel indices are [0, bound) per axis.
    """
    mask_f = point_mask.to(torch.float32)
    n = torch.clamp(mask_f.sum(dim=1), min=1.0)
    xyz_vox = xyz_m.to(torch.float32) * (1000.0 / ACC_UNIT_MM)

    means = (xyz_vox * mask_f[..., None]).sum(dim=1) / n[:, None]
    centered = xyz_vox - means[:, None, :]

    radii_vox = radial_dm.to(torch.float32) * (100.0 / ACC_UNIT_MM)
    radii_round = torch.round(radii_vox)  # half to even, as np.around

    # Python scalars, not a device tensor: no host-to-device copy, which
    # would block the host and could not sit in a CUDA graph
    m3 = point_mask[..., None]
    cmin = torch.where(m3, centered, 3e38).amin(dim=(1, 2))
    cmax = torch.where(m3, centered, -3e38).amax(dim=(1, 2))
    rmax = torch.where(point_mask, radii_vox, -3e38).amax(dim=1)

    # zero_boundary = int(min - r_max) + 1; int() truncates toward zero.
    zero_boundary = torch.trunc(cmin - rmax) + 1.0
    shift = torch.where(zero_boundary < 0, zero_boundary,
                        torch.zeros_like(zero_boundary))
    shifted = centered - shift[:, None, None]

    length = torch.trunc(cmax - shift)
    bound = length + torch.trunc(rmax)
    # Keep padded points far outside every band.
    shifted = torch.where(m3, shifted, torch.full_like(shifted, 1e9))
    return shifted, radii_round, means, shift, bound


# ---------------------------------------------------------------------------
# Public accumulator
# ---------------------------------------------------------------------------

# Hier-mode constants, as in the JAX package.
_COARSE = 4      # coarse factor (4x4x4 fine voxels per coarse cell)
_TOPK = 32       # refine around this many coarse peaks
_WIN = 8         # fine refine window side per peak
_CPT_STRIDE = 8  # coarse stage samples every k-th point (refine uses all)


def accumulate_3d(xyz_m, radial_dm, point_mask, grid_l=192, mode="hier",
                  topk=None, cpt_stride=None, win=None):
    """Point cloud (m) + radial predictions (dm) -> keypoint estimate (mm).

    xyz_m (N, 3) or (B, N, 3); radial_dm and point_mask (N,) or (B, N).
    A batch runs every keypoint through one launch of each vote stage.
    ``mode`` is 'exact', 'surface' or 'hier'; ``topk``/``cpt_stride``/
    ``win`` are the hier knobs (None = _TOPK/_CPT_STRIDE/_WIN).
    """
    if mode not in ("exact", "surface", "hier"):
        raise ValueError(f"unknown accumulator mode: {mode}")
    single = xyz_m.dim() == 2
    if single:
        xyz_m, radial_dm, point_mask = (xyz_m[None], radial_dm[None],
                                        point_mask[None])
    with profiling.span("rcvpose.vote", mode=mode):
        with profiling.span("rcvpose.vote.prepare"):
            pts, radii_round, means, shift, bound = _prepare(
                xyz_m, radial_dm, point_mask)
        if mode == "hier":
            res = _accumulate_hier(pts, radii_round, point_mask, grid_l,
                                   means, shift, bound, topk=topk or _TOPK,
                                   cpt_stride=cpt_stride or _CPT_STRIDE,
                                   win=win or _WIN)
        else:
            res = _accumulate_exact(
                pts, radii_round, point_mask, grid_l, means, shift, bound,
                band_fn=surface_band if mode == "surface" else exact_band)
    if single:
        res = AccumulatorResult(*(t[0] for t in res))
    return res


def _unravel3(flat_idx, side):
    """Row-major flat index -> (..., 3) f32 voxel coordinates."""
    return torch.stack([flat_idx // (side * side), (flat_idx // side) % side,
                        flat_idx % side], dim=-1).to(torch.float32)


def _accumulate_exact(pts, radii_round, point_mask, grid_l, means, shift,
                      bound, band_fn=exact_band):
    lo, hi = band_fn(radii_round, point_mask)
    votes = vote_counts(enumerate_grid(grid_l, pts.device), pts, lo, hi)

    # Mask voxels the reference grid would not contain, then take the first
    # row-major argmax (np.argwhere(V == V.max())[0]).
    coords = torch.arange(grid_l, dtype=torch.float32, device=pts.device)
    inb = coords[None, :] < bound[:, None]                      # (B, L)
    valid = (inb[:, :, None, None] & inb[:, None, :, None]
             & inb[:, None, None, :]).reshape(votes.shape)
    masked = torch.where(valid, votes, torch.full_like(votes, -1.0))
    flat_idx = torch.argmax(masked, dim=1)
    peak = _unravel3(flat_idx, grid_l)
    center = (peak + shift[:, None] + means + 0.5) * ACC_UNIT_MM
    return AccumulatorResult(
        center_mm=center,
        peak_votes=masked.gather(1, flat_idx[:, None])[:, 0],
        overflow=bound > grid_l, peak_voxel=peak)


def _top_indices(values, k):
    """Indices of the ``k`` largest entries per row, ties in index order
    (the order of the JAX package's ``lax.top_k``). A stable descending
    sort keeps equal values in ascending index order."""
    return torch.sort(values, dim=1, descending=True, stable=True).indices[
        :, :k]


def _accumulate_hier(pts, radii_round, point_mask, grid_l, means, shift,
                     bound, topk=_TOPK, cpt_stride=_CPT_STRIDE, win=_WIN):
    """Coarse-to-fine accumulation in the exact mode's millimeter frame.

    The coarse stage votes on a 4x coarser grid with a band widened by the
    coarse cell's circumradius, using every ``cpt_stride``-th packed point
    (valid points come first, so a stride is a uniform subsample); it only
    ranks cells. The refine stage votes with every point in ``win^3``
    windows around the ``topk`` best cells.
    """
    with profiling.span("rcvpose.vote.coarse"):
        top_idx = _coarse_peaks(pts, radii_round, point_mask, grid_l, bound,
                                topk, cpt_stride)
    with profiling.span("rcvpose.vote.fine"):
        return _fine_peak(pts, radii_round, point_mask, grid_l, means, shift,
                          bound, top_idx, topk, win)


def _coarse_peaks(pts, radii_round, point_mask, grid_l, bound, topk,
                  cpt_stride):
    """The hier coarse stage: the ``topk`` best coarse cells (B, topk)."""
    device = pts.device
    b = pts.shape[0]
    lc = grid_l // _COARSE
    cc = torch.arange(lc, dtype=torch.float32, device=device)
    coarse_vox = (enumerate_grid(lc, device) + 0.5) * _COARSE - 0.5

    slack = VOTE_BAND + math.sqrt(3.0) * _COARSE / 2.0
    lo_c, hi_c = widened_band(radii_round, point_mask, slack)
    cvotes = vote_counts(coarse_vox, pts[:, ::cpt_stride],
                         lo_c[:, ::cpt_stride], hi_c[:, ::cpt_stride])

    cb = torch.ceil(bound / _COARSE)
    cin = cc[None, :] < cb[:, None]                             # (B, lc)
    cvalid = (cin[:, :, None, None] & cin[:, None, :, None]
              & cin[:, None, None, :]).reshape(b, -1)
    cvotes = torch.where(cvalid, cvotes, torch.full_like(cvotes, -1.0))
    return _top_indices(cvotes, topk)


def _fine_peak(pts, radii_round, point_mask, grid_l, means, shift, bound,
               top_idx, topk, win):
    """The hier refine stage: every point votes in ``win^3`` windows
    around the coarse cells ``top_idx``; the best window's peak decodes."""
    device = pts.device
    b = pts.shape[0]
    lc = grid_l // _COARSE

    # Dense fine windows around each coarse peak, evaluated in one batch.
    base = _unravel3(top_idx, lc) * _COARSE - (win - _COARSE) // 2
    bases = torch.clamp(base, 0, grid_l - win)                  # (B, topk, 3)
    local = enumerate_grid(win, device)                         # (W^3, 3)
    win_vox = (bases[:, :, None, :] + local[None, None]).reshape(b, -1, 3)

    lo_f, hi_f = exact_band(radii_round, point_mask)
    fvotes = vote_counts(win_vox, pts, lo_f, hi_f)
    fvalid = (win_vox < bound[:, None, None]).all(dim=2)
    fvotes = torch.where(fvalid, fvotes,
                         torch.full_like(fvotes, -1.0)).reshape(b, topk, -1)

    best_per = fvotes.amax(dim=2)                               # (B, topk)
    kbest = torch.argmax(best_per, dim=1)                       # (B,)
    rows = torch.arange(b, device=device)
    widx = torch.argmax(fvotes[rows, kbest], dim=1)
    peak = bases[rows, kbest] + _unravel3(widx, win)
    center = (peak + shift[:, None] + means + 0.5) * ACC_UNIT_MM
    return AccumulatorResult(center_mm=center,
                             peak_votes=best_per[rows, kbest],
                             overflow=bound > grid_l, peak_voxel=peak)


def accumulate_3d_no_depth(xyz_hyp_m, radial_dm, point_mask, grid_l=192,
                           mode="hier"):
    """RGB-only ablation accumulator: vote over a stack of depth-hypothesis
    clouds ``(D, N, 3)`` sharing ``radial_dm`` and ``point_mask`` ``(N,)``;
    the hypotheses are just more voting spheres."""
    d, n, _ = xyz_hyp_m.shape
    flat = xyz_hyp_m.reshape(d * n, 3)
    radial = radial_dm.to(torch.float32).repeat(d)
    mask = point_mask.repeat(d)
    return accumulate_3d(flat, radial, mask, grid_l=grid_l, mode=mode)
