"""The vote-count kernels of ``csrc/vote.cu`` and their plain versions.

Each computes, for a batch of keypoints,
``votes[b, v] = #{n : lo[b, n] < d2(voxels[b, v], points[b, n]) < hi[b, n]}``.
Voxels are either ``(V, 3)``, shared by the whole batch, or ``(B, V, 3)``;
points are ``(B, N, 3)`` and the bands ``(B, N)``. Masked points carry
``lo == hi == 0`` and never vote. Three forms of d2:

- **K1** (``vote_counts_cuda``): ``dx*dx + dy*dy + dz*dz`` in f32, every
  operation rounded on its own, at a tile chosen from ``TILES``, with the
  point axis split across blocks as ``plan_votes`` says.
- **K5** (``vote_counts_mxu_cuda``): the matmul form
  ``vx*(-2px) + vy*(-2py) + vz*(-2pz) + |v|^2 + |p|^2`` in f32.
- **K6** (``vote_counts_bf16_cuda``): the subtract-square form in bf16,
  compared in f32 or in bf16, with the point axis split as
  ``plan_votes(..., kernel="K6")`` says.

Each kernel and its plain version agree exactly. A ``*_cuda`` wrapper
launches its kernel on CUDA tensors and counts the launches in its
``launches`` attribute; ``ops.voting.vote_counts`` is the dispatcher: the
kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import torch

from rcvpose_tpu_torch.ops import _build

# K1 tiles: (threads per block, voxels per thread, points per staged chunk).
TILES = tuple(itertools.product((128, 256, 512), (1, 2, 4),
                                (256, 512, 1024, 2048)))
DEFAULT_TILE = (256, 4, 1024)
# The H100 SXM's multiprocessors: the planner's default (the wrapper passes
# the card's own count).
H100_SMS = 132
# The vote kernels' bound. None of their operations is an FMA, so the 67
# TFLOP/s FP32 peak (an FMA counted as two) does not apply: an SM issues at
# most one warp instruction a clock in each of its 4 sub-partitions, 132 x
# 4 x 32 lanes x 1.98 GHz lane-instructions a second. The instructions a
# (voxel, point) pair needs: K1 3 sub, 3 mul, 2 add, 2 compares, the
# predicated count add; K5 3 mul, 4 add, 2 compares, the count; K6, in
# either compare, the 8 sub / mul / add in bf16x2 pair forms (4 a pair),
# two packed band compares for two pairs (1 a pair: the f32 compare of a
# bf16 d2 is a bf16 compare with the band rounded outward, once a point)
# and the count, an AND for two pairs and a three-input add for four (0.75).
ISSUE_RATE = H100_SMS * 4 * 32 * 1.98e9
INSTRUCTIONS_PER_PAIR = {"K1": 11, "K5": 10, "K6 f32": 5.75, "K6 bf16": 5.75}
# K1's and K6's counts are f32 sums of integer partial counts: exact below
# 2^24.
MAX_POINTS = 1 << 24
# K6's only tile, and the most points a K6 block takes: it counts the two
# points of a staged pair in the 16-bit halves of a register.
K6_TILE = (256, 4, 1024)
K6_MAX_SPLIT = 2 * 65535

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_K1_ARGTYPES = [_PTR] * 5 + [_INT] * 8 + [_PTR] * 2
_K5_ARGTYPES = [_PTR] * 7 + [_INT] * 4 + [_PTR]
_K6_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [_PTR]


def _check_args(voxels, points, lo, hi, dtype=torch.float32):
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    b, n, _ = points.shape
    if voxels.dim() not in (2, 3) or voxels.shape[-1] != 3 or (
            voxels.dim() == 3 and voxels.shape[0] != b):
        raise ValueError(f"voxels must be (V, 3) or ({b}, V, 3), got "
                         f"{tuple(voxels.shape)}")
    for name, t in (("lo", lo), ("hi", hi)):
        if tuple(t.shape) != (b, n):
            raise ValueError(f"{name} must be ({b}, {n}), got {tuple(t.shape)}")
    for name, t in (("voxels", voxels), ("points", points), ("lo", lo),
                    ("hi", hi)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _on_card(what, tensors):
    """Every tensor on the points' CUDA device, contiguous; raises
    otherwise. Strided views (``pts[:, ::stride]``) are copied here."""
    dev = tensors[1].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{what} needs every tensor on one CUDA device")
    return [t.contiguous() for t in tensors]


def _launch(what, symbol, argtypes, args, out, b, v, n):
    """Call the C entry ``symbol`` on the current stream; raises on a
    launch error. Returns ``out``."""
    if max(b * v, b * n * 3) >= 2 ** 31:
        raise ValueError(f"{what}: problem too large for int32 indexing")
    if b == 0 or v == 0:
        return out
    fn = _build.function("vote", symbol, argtypes)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    _build.check(err, symbol)
    return out


# ---------------------------------------------------------------------------
# K1: subtract-square d2 in f32, at a chosen tile; the point-split planner
# of K1 and K6
# ---------------------------------------------------------------------------

# The planner's aim: 32 resident warps an SM (4 blocks of 256 threads).
# csrc/vote.cu caps a K1 or K6 thread at 64 registers
# (__launch_bounds__(threads, 1024 / threads)), so that many always fit.
TARGET_WARPS = 32
# Points a split is rounded to (a warp's staging width).
SPLIT_ALIGN = 32
_SM_THREADS = 2048
_SM_BLOCKS = 32
_SM_SHARED = 233472        # bytes an SM can give its blocks
_BLOCK_RESERVED = 1024     # shared memory the runtime keeps a block
# By kernel: shared-memory bytes a staged point takes (K1 a float4 and a
# quarter float4 a point; K6 a 16-byte word and a quarter word a pair) and
# the most points a block may take
_STAGED_BYTES = {"K1": 20, "K6": 10}
_MAX_SPLIT = {"K1": None, "K6": K6_MAX_SPLIT}


@dataclasses.dataclass(frozen=True)
class VotePlan:
    """How a split kernel covers a (B, V, N) problem at a tile: ``splits``
    blocks of ``split`` points (the last takes the rest) for each of
    ``voxel_blocks`` (B times the voxel tiles). ``resident`` is the blocks
    an SM holds at once, ``target`` the blocks an SM the planner aims for,
    ``blocks_per_sm`` what the grid gives over ``sms`` multiprocessors."""
    tile: tuple
    split: int
    splits: int
    voxel_blocks: int
    resident: int
    target: int
    sms: int
    kernel: str = "K1"

    @property
    def blocks(self):
        return self.voxel_blocks * self.splits

    @property
    def blocks_per_sm(self):
        return self.blocks / self.sms


def resident_blocks(tile, kernel="K1"):
    """Blocks of ``kernel`` an SM holds at once at ``tile``: the least of
    the thread, block, shared-memory (``_STAGED_BYTES`` a staged point) and
    register (64 a thread) limits."""
    threads, _, chunk = tile
    return min(_SM_THREADS // threads, _SM_BLOCKS,
               _SM_SHARED // (_STAGED_BYTES[kernel] * chunk
                              + _BLOCK_RESERVED),
               65536 // (64 * threads))


@functools.lru_cache(maxsize=1024)
def plan_votes(b, v, n, tile=DEFAULT_TILE, sms=H100_SMS, kernel="K1"):
    """Split the point axis of ``kernel`` ("K1" at ``tile``, or "K6" at
    ``K6_TILE``) so that the grid holds at least ``target`` blocks an SM,
    ``min(resident, TARGET_WARPS warps)``: the voxel tiles of the serving
    refine stage alone give 1.45 blocks an SM at K1's default tile. Splits
    are multiples of ``SPLIT_ALIGN`` points, and K6's at most
    ``K6_MAX_SPLIT``. Among the split counts from the least that reaches
    the target (and the cap) to twice it, takes the one that balances the
    SMs best (the busiest SM's share of the points over the mean), then the
    fewest splits. Where N is too short to reach the target, every split
    is ``SPLIT_ALIGN`` points. Pure Python; the wrapper passes the card's
    multiprocessor count."""
    if kernel == "K6" and tuple(tile) != K6_TILE:
        raise ValueError(f"K6 is built at {K6_TILE} only, got {tile}")
    threads, vpt, _ = tile
    cap = _MAX_SPLIT[kernel]
    voxel_blocks = max(1, b * -(-v // (threads * vpt)))
    resident = resident_blocks(tile, kernel)
    target = min(resident, max(1, TARGET_WARPS * 32 // threads))
    want = -(-target * sms // voxel_blocks)
    if cap is not None:
        want = max(want, -(-n // cap))
    max_splits = max(1, -(-n // SPLIT_ALIGN))

    def split_of(s):
        per = -(-n // s)
        per = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
        return max(per, 1), max(1, -(-n // max(per, 1)))

    if want <= 1 or n <= SPLIT_ALIGN:
        split, splits = max(n, 1), 1
    elif want >= max_splits:
        split, splits = split_of(max_splits)
    else:
        best = None
        for s in range(want, min(2 * want, max_splits) + 1):
            per, got = split_of(s)
            if got * voxel_blocks < target * sms or (
                    cap is not None and per > cap):
                continue
            # the busiest SM runs ceil(blocks / sms) blocks of `per` points
            # against a mean of voxel_blocks * n / sms points
            busiest = -(-got * voxel_blocks // sms) * per
            key = (busiest, got)
            if best is None or key < best[0]:
                best = (key, per, got)
        if best is None:
            split, splits = split_of(max_splits)
        else:
            _, split, splits = best
    return VotePlan(tuple(tile), split, splits, voxel_blocks, resident,
                    target, sms, kernel)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_output(what, b, v, n, split, tile, kernel, device):
    """The points a block of a split kernel takes (``split``, or the
    planner's choice on this card for None; at most N) and its f32 (B, V)
    output, zeroed where split blocks add into it. Raises for N >= 2^24
    (the f32 sums of counts stop being exact), a split the kernel cannot
    take, or a grid that does not fit."""
    if n >= MAX_POINTS:
        raise ValueError(f"{what}: N = {n} points; the f32 counts are "
                         f"exact only below 2^24")
    if split is None:
        split = plan_votes(b, v, n, tile, _sm_count(device), kernel).split
    split = min(int(split), max(n, 1))
    cap = _MAX_SPLIT[kernel]
    if cap is not None and split > cap:
        raise ValueError(f"{what}: a split of {split} points; a block takes "
                         f"at most {cap}")
    splits = -(-n // split) if n > split else 1
    if splits > 65535 or b > 65535:
        raise ValueError(f"{what}: {splits} point splits, batch {b} (grid y "
                         f"and z hold 65535)")
    alloc = torch.zeros if splits > 1 else torch.empty
    return split, alloc((b, v), dtype=torch.float32, device=device)


def vote_counts_cuda(voxels, points, lo, hi, tile=None, split=None,
                     n_live=None):
    """Launch K1 on CUDA tensors; returns (B, V) f32 counts.

    ``tile``: ``(threads, voxels per thread, points per chunk)`` from
    ``TILES``; None is ``DEFAULT_TILE``, the serving path's. ``split``:
    points a block, None for ``plan_votes``'s choice on this card. Every
    tile and split gives the same counts. ``n_live``: None, or a (B,)
    int32 tensor on the points' device with the promise that no entry of
    row b at index ``n_live[b]`` or later votes (``hi <= 0``, as a masked
    one's; ``voting.vote_counts`` derives it so); the kernel reads it
    on the card and spreads each row's live points over the blocks that
    the plan at the full N gives (so a CUDA graph replays it with new
    bounds), and the counts are the same. ``vote_counts_cuda.launches``
    counts every launch, ``vote_counts_cuda.tiled_launches`` those with an
    explicit ``tile``, ``vote_counts_cuda.live_bounded`` those given an
    ``n_live``.
    """
    _check_args(voxels, points, lo, hi)
    b = points.shape[0]
    if n_live is not None and (tuple(n_live.shape) != (b,)
                               or n_live.dtype != torch.int32
                               or n_live.device != points.device
                               or not n_live.is_contiguous()):
        raise ValueError(f"n_live must be a contiguous ({b},) int32 tensor "
                         f"on {points.device}, got {tuple(n_live.shape)} "
                         f"{n_live.dtype} on {n_live.device}")
    explicit = tile is not None
    tile = DEFAULT_TILE if tile is None else tuple(tile)
    if tile not in TILES:
        raise ValueError(f"tile {tile} is not one of the built tiles "
                         f"(threads 128/256/512, voxels per thread 1/2/4, "
                         f"chunk 256/512/1024/2048)")
    if split is not None and int(split) < 1:
        raise ValueError(f"split must be >= 1 point, got {split}")
    voxels, points, lo, hi = _on_card("vote_counts_cuda",
                                      (voxels, points, lo, hi))
    b, n, _ = points.shape
    v = voxels.shape[-2]
    split, out = _split_output("vote_counts_cuda", b, v, n, split, tile,
                               "K1", points.device)
    live_ptr = None if n_live is None else n_live.data_ptr()
    _launch("vote_counts_cuda", "vote_counts_f32", _K1_ARGTYPES,
            (voxels.data_ptr(), points.data_ptr(), lo.data_ptr(),
             hi.data_ptr(), out.data_ptr(), int(voxels.dim() == 2), b, v, n,
             *tile, int(split), live_ptr), out, b, v, n)
    if b and v:
        _build.count(vote_counts_cuda)
        _build.count(vote_counts_cuda, "tiled_launches", explicit)
        _build.count(vote_counts_cuda, "live_bounded", n_live is not None)
    return out


vote_counts_cuda.launches = 0
vote_counts_cuda.tiled_launches = 0
vote_counts_cuda.live_bounded = 0

# Pairs evaluated per step of the plain versions: bounds their temporaries
# (a few (B, V, chunk) tensors of at most 16 MB each).
_PLAIN_PAIRS = 1 << 22


def _plain_counts(voxels, points, lo, hi, d2_fn):
    """Band counts over point chunks with ``d2_fn(vox (B, V, 1, 3) view
    pieces, point chunk) -> d2``; shared by the plain versions."""
    b, n, _ = points.shape
    vox = voxels.expand(b, -1, -1) if voxels.dim() == 2 else voxels
    v = vox.shape[1]
    acc = torch.zeros((b, v), dtype=torch.int64, device=points.device)
    chunk = max(1, _PLAIN_PAIRS // max(1, b * v))
    for c0 in range(0, n, chunk):
        d2 = d2_fn(vox, c0, c0 + chunk)
        hit = ((d2 > lo[:, None, c0:c0 + chunk])
               & (d2 < hi[:, None, c0:c0 + chunk]))
        acc += hit.sum(dim=-1)
    return acc.to(torch.float32)


def _d2_subtract_square(points):
    def d2(vox, c0, c1):
        p = points[:, None, c0:c1, :]
        dx = vox[:, :, None, 0] - p[..., 0]
        dy = vox[:, :, None, 1] - p[..., 1]
        dz = vox[:, :, None, 2] - p[..., 2]
        return dx * dx + dy * dy + dz * dz
    return d2


def vote_counts_plain(voxels, points, lo, hi):
    """K1's counts in plain PyTorch, chunked over the points. K1's tile
    changes nothing of the result, so every tile has this plain version."""
    _check_args(voxels, points, lo, hi)
    return _plain_counts(voxels, points, lo, hi, _d2_subtract_square(points))


# ---------------------------------------------------------------------------
# K5: matmul-form d2 in f32
# ---------------------------------------------------------------------------

def _sq_norm(x):
    """|x|^2 over the last axis of (..., 3), summed x, y, z in that order
    as ``jnp.sum(x * x, axis=1)`` is in the JAX package's wrapper."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def mxu_operands(voxels, points):
    """The matmul form's operands, built once for the kernel and its plain
    version alike: ``(|v|^2, -2p, |p|^2)``."""
    return _sq_norm(voxels), -2.0 * points, _sq_norm(points)


def vote_counts_mxu_cuda(voxels, points, lo, hi):
    """Launch K5 on CUDA tensors; returns (B, V) f32 counts.
    ``vote_counts_mxu_cuda.launches`` counts the launches."""
    _check_args(voxels, points, lo, hi)
    voxels, points, lo, hi = _on_card("vote_counts_mxu_cuda",
                                      (voxels, points, lo, hi))
    v2, pm2, p2 = mxu_operands(voxels, points)
    b, n, _ = points.shape
    v = voxels.shape[-2]
    out = torch.empty((b, v), dtype=torch.float32, device=points.device)
    _launch("vote_counts_mxu_cuda", "vote_counts_mxu_f32", _K5_ARGTYPES,
            (voxels.data_ptr(), v2.data_ptr(), pm2.data_ptr(), p2.data_ptr(),
             lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
             int(voxels.dim() == 2), b, v, n), out, b, v, n)
    if b and v:
        _build.count(vote_counts_mxu_cuda)
    return out


vote_counts_mxu_cuda.launches = 0


def vote_counts_mxu_plain(voxels, points, lo, hi):
    """K5's counts in plain PyTorch: the same dot, in the same k order,
    one rounded operation at a time."""
    _check_args(voxels, points, lo, hi)
    v2, pm2, p2 = mxu_operands(voxels, points)
    b = points.shape[0]
    v2 = v2.expand(b, -1) if voxels.dim() == 2 else v2

    def d2(vox, c0, c1):
        m = pm2[:, None, c0:c1, :]
        acc = vox[:, :, None, 0] * m[..., 0] + vox[:, :, None, 1] * m[..., 1]
        acc = acc + vox[:, :, None, 2] * m[..., 2]
        acc = acc + v2[:, :, None]
        return acc + p2[:, None, c0:c1]

    return _plain_counts(voxels, points, lo, hi, d2)


# ---------------------------------------------------------------------------
# K6: subtract-square d2 in bf16
# ---------------------------------------------------------------------------

_COMPARES = ("f32", "bf16")


def _check_bf16_args(voxels, points, lo, hi, compare):
    if compare not in _COMPARES:
        raise ValueError(f"compare must be 'f32' or 'bf16', got {compare!r}")
    _check_args(voxels, points, lo, hi)


def _bf16_operands(voxels, points, lo, hi, compare):
    """Coordinates rounded to bf16; lo / hi too when ``compare="bf16"``."""
    _check_bf16_args(voxels, points, lo, hi, compare)
    bf16 = torch.bfloat16
    band = bf16 if compare == "bf16" else torch.float32
    return voxels.to(bf16), points.to(bf16), lo.to(band), hi.to(band)


def vote_counts_bf16_cuda(voxels, points, lo, hi, compare="f32", split=None):
    """Launch K6 on CUDA tensors (f32 in: the kernel rounds the coordinates
    to bf16, and the band as ``compare`` says); returns (B, V) f32 counts.
    ``split``: points a block (at most ``K6_MAX_SPLIT``), None for
    ``plan_votes(..., kernel="K6")``'s choice on this card; every split
    gives the same counts. ``vote_counts_bf16_cuda.launches`` counts every
    launch, ``vote_counts_bf16_cuda.bf16_compare_launches`` those with
    ``compare="bf16"``."""
    _check_bf16_args(voxels, points, lo, hi, compare)
    if split is not None and int(split) < 1:
        raise ValueError(f"split must be >= 1 point, got {split}")
    voxels, points, lo, hi = _on_card("vote_counts_bf16_cuda",
                                      (voxels, points, lo, hi))
    b, n, _ = points.shape
    v = voxels.shape[-2]
    split, out = _split_output("vote_counts_bf16_cuda", b, v, n, split,
                               K6_TILE, "K6", points.device)
    _launch("vote_counts_bf16_cuda", "vote_counts_bf16", _K6_ARGTYPES,
            (voxels.data_ptr(), points.data_ptr(), lo.data_ptr(),
             hi.data_ptr(), out.data_ptr(), int(voxels.dim() == 2), b, v, n,
             int(compare == "bf16"), int(split)), out, b, v, n)
    if b and v:
        _build.count(vote_counts_bf16_cuda)
        _build.count(vote_counts_bf16_cuda, "bf16_compare_launches",
                     compare == "bf16")
    return out


vote_counts_bf16_cuda.launches = 0
vote_counts_bf16_cuda.bf16_compare_launches = 0


def vote_counts_bf16_plain(voxels, points, lo, hi, compare="f32"):
    """K6's counts in plain PyTorch: each op a separate bf16 tensor op."""
    voxels, points, lo, hi = _bf16_operands(voxels, points, lo, hi, compare)
    d2_bf16 = _d2_subtract_square(points)

    def d2(vox, c0, c1):
        out = d2_bf16(vox, c0, c1)
        return out.float() if compare == "f32" else out

    return _plain_counts(voxels, points, lo, hi, d2)

