"""K3 and K4, the decoder conv kernels (``csrc/mmconv.cu``), their plain
versions, and the differentiable conv built on them (counterpart of
``rcvpose_tpu.ops.mmconv_pallas``).

* ``conv_same(x, kernel)``: SAME stride-1 KxK conv (K odd >= 3) of an NHWC
  ``(B, H, W, C)`` tensor with a ``(K, K, C, D)`` kernel of x's dtype, all
  products accumulated in f32, one rounding to x's dtype at the end (K3).
* ``conv_same_dk(x, g, ks)``: its weight gradient
  ``dk[ky, kx, c, d] = sum_bhw x[b, h+ky-p, w+kx-p, c] g[b, h, w, d]`` in
  f32 (K4).
* ``MMConv2dFunction``: forward K3; backward dx = K3(g, the kernel rotated
  and transposed), dk = K4(x, g) cast to the kernel's dtype.

Each dispatches on the device: the kernel for CUDA tensors, the plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from rcvpose_tpu_torch.ops import _build

_FWD_ARGTYPES = {
    "bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [ctypes.c_void_p],
    "f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}
_DK_ARGTYPES = {
    "bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    "f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# The card the planner sizes for: H100 SXM, 132 multiprocessors, 227 KB of
# shared memory a block.
SM_COUNT = 132
SMEM_LIMIT = 232_448
# A multiprocessor's 233,472 bytes of shared memory, less 1 KB a block,
# split between two blocks (K3's narrow tiles run two a multiprocessor).
SMEM_LIMIT_2 = 233_472 // 2 - 1024
# Split reductions keep their f32 partial sums under SCRATCH_BYTES.
SCRATCH_BYTES = 256 << 20
# Tile widths N the bf16 K3 is built for. wgmma takes multiples of 8 up to
# 256, but with promotion a consumer thread holds 2 x N/2 f32 accumulators
# and ptxas gives it 168 registers (384 threads a block): N = 192 spilled
# 328 bytes, so the widest tile is 128 and a 192-channel output takes two
# tiles of 96.
TILE_N = (32, 64, 96, 128)
MAX_STAGES = 6
# The template instances csrc/mmconv.cu builds: K3 (tile_k, tile_n,
# blocks a multiprocessor, promotion) and K4 (tile_n, taps). Two blocks a
# multiprocessor leave 112 registers a thread: room for N/2 f32
# accumulators at N <= 96, or two sets (promotion) at N <= 64.
BUILT_FWD = frozenset(
    [(k, n, 1, pr) for k in (32, 64) for n in TILE_N for pr in (True, False)]
    + [(k, n, 2, True) for k in (32, 64) for n in (32, 64)]
    + [(k, n, 2, False) for k in (32, 64) for n in (32, 64, 96)])
BUILT_DK = frozenset({(32, 9), (32, 3), (64, 3), (128, 1), (32, 1), (64, 1)})
# K3 adds each wgmma chain into its f32 sum with IEEE adds after PROMOTE
# stages (a stage: K taps x 64 channels, 32 where C <= 32: 576 products at
# K = 3); a block whose whole reduction fits in one interval keeps a single
# accumulator. Chosen on the card (PERF.md): every interval from 1
# stage to none kept K3 within the one-ulp check at conv_up5 and at
# (2,15,20,2048,64,3); 3 was as fast as the longest.
PROMOTE = 3
# The ring's alignment (the 128-byte swizzle's repeat); a block's fixed
# cost (pipeline fill, epilogue) in units of its reduction work (K3: one
# tap of one channel chunk; K4: one 8x8 pixel tile), for the split choice.
_ALIGN = 1024
_CHUNK_COST = 6
# K4's f32 arm: pixels per slice are a multiple of this.
_SLICE_ALIGN = 32


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How a conv kernel cuts its work (``plan_conv``).

    variant: the C entry's template (``"fwd"``: K3 bf16 ``conv_fwd_bf16<
    tile_k, tile_n, blocks_per_sm, promote > 0>``; ``"dk"``: K4 bf16
    ``conv_dk_bf16<tile_n, taps>``; ``"dk_f32"``: K4's FMA arm, whose
    tile_m[1] is the pixels a slice). tile_m: the (rows, cols) pixel
    rectangle of one tile; tile_n: output channels (K3) or d (K4) a
    tile; tile_k: channels (K3) or pixels (K4) a pipeline stage reduces;
    stages: ring depth; splits: blocks the reduction is cut into (K3
    split-K, K4 pixel slices); units: blocks launched; partials: f32
    partial sums pass 2 adds (1: none); smem_bytes: dynamic shared memory
    of a block; taps: taps a K4 block owns; ksplit: K4's two consumers take
    alternate pixel tiles of one 64-channel slab; promote: K3's promotion
    interval in stages, 0 where a block's reduction fits in one interval
    (a single accumulator); blocks_per_sm: K3 blocks a multiprocessor holds
    (2 where the accumulators fit 112 registers a thread and a 2-stage
    ring fits half the shared memory).
    """
    variant: str
    tile_m: tuple
    tile_n: int
    tile_k: int
    stages: int
    splits: int
    units: int
    partials: int
    smem_bytes: int
    taps: int = 9
    ksplit: bool = False
    promote: int = 1
    blocks_per_sm: int = 1


def _cdiv(a, b):
    return -(-a // b)


def _split(units, iters, sm_count, cap):
    """The split count in 1..cap of a reduction of ``iters`` work units
    over ``units`` tiles that minimises waves x (work a block + its fixed
    cost), among those that give at least one block per
    multiprocessor where the cap allows it: fills the card where the tiles
    alone leave it idle, and evens out the last wave."""
    counts = range(1, max(1, cap) + 1)
    full = [n for n in counts if units * n >= sm_count]
    best, best_cost = None, None
    for n in full or [max(counts)]:
        cost = _cdiv(units * n, sm_count) * (_cdiv(iters, n) + _CHUNK_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = n, cost
    return best


def _stages(stage_bytes, floor_bytes=0, limit=SMEM_LIMIT):
    budget = limit - _ALIGN - 16 * MAX_STAGES
    n = min(MAX_STAGES, budget // stage_bytes)
    if n < 2 or n * stage_bytes < floor_bytes:
        raise ValueError(f"no ring of >= 2 stages of {stage_bytes} bytes "
                         f"fits")
    return n


def _fwd_tile_m(h, w, ks):
    """K3's th x tw pixel rectangle: tw a multiple of 8 (so that each tap
    row of the halo box starts on a swizzle repeat), th * tw <= 128; the
    one that covers an h x w image with the fewest wgmma rows plus loaded
    box rows ((th + K - 1) x tw a tile)."""
    best = None
    for tw in (8, 16, 32, 64, 128):
        th = max(1, min(128 // tw, h))
        tiles = _cdiv(h, th) * _cdiv(w, tw)
        key = (tiles * (128 + (th + ks - 1) * tw), -tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return best[1]


@functools.lru_cache(maxsize=1024)
def plan_conv(direction, b, h, w, c, d, ks, dtype=torch.bfloat16,
              sm_count=SM_COUNT):
    """The tiling of K3 (``direction="fwd"``, x (b,h,w,c) -> d) or K4
    (``"dk"``, x (b,h,w,c), g (b,h,w,d)) for a card of ``sm_count``
    multiprocessors: pure Python, the same answer on every call. bf16
    shapes are the kernels' (channels already padded to multiples of 8)."""
    pixels = b * h * w
    if dtype == torch.float32:
        if direction != "dk":
            raise ValueError("K3's f32 arm has a fixed 64x64 tile, no plan")
        # 64 x 64 tiles, one tap each; slices for 8 blocks a multiprocessor
        tiles = _cdiv(c, 64) * _cdiv(d, 64) * ks * ks
        want = max(1, _cdiv(sm_count * 8, tiles))
        cap = max(1, SCRATCH_BYTES // (ks * ks * c * d * 4))
        n = min(want, cap, max(1, _cdiv(pixels, _SLICE_ALIGN)), 65535)
        per = _cdiv(_cdiv(pixels, n), _SLICE_ALIGN) * _SLICE_ALIGN
        n = _cdiv(pixels, per)
        return ConvPlan("dk_f32", (1, per), 64, 16, 1, n, tiles * n, n, 0)
    if direction == "fwd":
        bk = 32 if c <= 32 else 64
        bn = min((128, 96, 64, 32), key=lambda n: _cdiv(d, n) * n)
        th, tw = _fwd_tile_m(h, w, ks)
        units = b * _cdiv(h, th) * _cdiv(w, tw) * _cdiv(d, bn)
        # a stage: one channel chunk of one kernel column (K taps)
        iters = ks * _cdiv(c, bk)
        cap = min(16, max(1, iters // 2),
                  max(1, SCRATCH_BYTES // max(1, pixels * d * 4)))
        splits = _split(units, ks * iters, sm_count, cap)  # in tap-chunks
        a_bytes = _cdiv((128 + (ks - 1) * tw) * bk * 2, _ALIGN) * _ALIGN
        stage = a_bytes + ks * bk * bn * 2
        epilogue = 128 * (bn + 4) * 4
        promote = PROMOTE if _cdiv(iters, splits) > PROMOTE else 0
        # two blocks a multiprocessor where that instance is built (its
        # accumulators fit 112 registers a thread) and a 2-stage ring fits
        # half the shared memory: one block's pipeline fill and epilogue
        # overlap the other's main loop
        minb = 1
        if ((bk, bn, 2, promote > 0) in BUILT_FWD
                and _ALIGN + 2 * (stage + 16) <= SMEM_LIMIT_2):
            minb = 2
        stages = _stages(stage, epilogue,
                         SMEM_LIMIT if minb == 1 else SMEM_LIMIT_2)
        return ConvPlan("fwd", (th, tw), bn, bk, stages, splits,
                        units * splits, splits,
                        _ALIGN + stages * (stage + 16), promote=promote,
                        blocks_per_sm=minb)
    if direction != "dk":
        raise ValueError(f"direction must be 'fwd' or 'dk', got {direction}")
    # d tile and taps a block: with K = 3, 3 taps (one kx column: one X box
    # with a 2-row halo serves them) at d tiles of 32 or 64, or 9 taps split
    # between the consumers where one 64-channel slab and 32 d fit; the
    # accumulators stay <= 96 registers a thread
    if ks == 3:
        bd = 32 if d <= 32 else 64
        taps = 9 if bd == 32 and c <= 64 else 3
    else:
        bd = 32 if d <= 32 else (64 if d <= 64 else 128)
        taps = 1
    ksplit = c <= 64 and taps != 9
    slabs = 2 if c > 64 else 1
    groups = {9: 1, 3: 3, 1: ks * ks}[taps]
    units = _cdiv(c, 64 * slabs) * _cdiv(d, bd) * groups
    tiles = b * _cdiv(h, 8) * _cdiv(w, 8)
    per_slice = ks * ks * c * d * 4 * (2 if ksplit else 1)
    cap = min(65535, max(1, tiles // 4),
              max(1, SCRATCH_BYTES // per_slice))
    slices = _split(units, tiles, sm_count, cap)
    rows = 8 if taps == 1 else 8 + ks - 1
    stage = (3 if taps == 9 else 1) * slabs * rows * 8 * 128 + 64 * bd * 2
    stages = _stages(stage)
    partials = slices * (2 if ksplit else 1)
    return ConvPlan("dk", (8, 8), bd, 64, stages, slices, units * slices,
                    partials, _ALIGN + stages * (stage + 16), taps=taps,
                    ksplit=ksplit)


def pad_channels(t, n):
    """``t`` with its last axis zero-padded to ``n`` entries, in a fresh
    buffer (torch allocations are 16-byte aligned); ``t`` itself where it
    already has ``n`` channels and a 16-byte aligned start. Exact: the
    zeros add nothing to any sum."""
    if t.shape[-1] == n and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(tuple(t.shape[:-1]) + (n,))
    out[..., :t.shape[-1]] = t
    return out


def pad_kernel(kernel, c, d):
    """A (K, K, C, D) kernel zero-padded to (K, K, c, d) in a fresh buffer
    (``kernel`` itself where nothing changes), as ``pad_channels``."""
    if (tuple(kernel.shape[2:]) == (c, d) and kernel.is_contiguous()
            and kernel.data_ptr() % 16 == 0):
        return kernel
    out = kernel.new_zeros(tuple(kernel.shape[:2]) + (c, d))
    out[:, :, :kernel.shape[2], :kernel.shape[3]] = kernel
    return out


def round8(n):
    """``n`` rounded up to a multiple of 8: the bf16 kernels' channel
    counts (TMA strides are multiples of 16 bytes)."""
    return _cdiv(n, 8) * 8


def _check_conv_args(x, kernel):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if kernel.dim() != 4 or kernel.shape[0] != kernel.shape[1]:
        raise ValueError(f"kernel must be (K, K, C, D), got "
                         f"{tuple(kernel.shape)}")
    ks = kernel.shape[0]
    if ks % 2 == 0 or ks < 3:
        raise ValueError(f"K must be odd and >= 3, got {ks}")
    if kernel.shape[2] != x.shape[3]:
        raise ValueError(f"kernel takes {kernel.shape[2]} channels, x has "
                         f"{x.shape[3]}")
    if kernel.dtype != x.dtype:
        raise TypeError(f"kernel dtype {kernel.dtype} != x dtype {x.dtype}")


def _cuda_operands(what, *tensors):
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{what} needs every tensor on one CUDA device")
    if tensors[0].dtype not in _SUFFIX:
        raise TypeError(f"{what}: expected float32 or bfloat16, got "
                        f"{tensors[0].dtype}")
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{what}: operands differ in dtype")
    return [t.contiguous() for t in tensors]


def _stream(dev):
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def conv_same_cuda(x, kernel):
    """Launch K3 on CUDA tensors; ``conv_same_cuda.launches`` counts the
    launches. bf16 operands whose channel counts are not multiples of 8, or
    whose data does not start on 16 bytes (TMA needs both), are zero-padded
    into fresh buffers first and the output is sliced back."""
    _check_conv_args(x, kernel)
    x, kernel = _cuda_operands("conv_same_cuda", x, kernel)
    b, h, w, c = x.shape
    ks, d = kernel.shape[0], kernel.shape[3]
    if max(b, h, w, c, d) >= 2 ** 31 or b * h * w >= 2 ** 31 * 128:
        raise ValueError("conv_same_cuda: problem too large")
    out = torch.empty((b, h, w, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if c == 0:
        return out.zero_()
    suffix = _SUFFIX[x.dtype]
    name = f"conv_same_{suffix}"
    fn = _build.function("mmconv", name, _FWD_ARGTYPES[suffix])
    stream = _stream(x.device)
    if suffix == "f32":
        err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, h, w, c,
                 d, ks, stream)
    else:
        cp, dp = round8(c), round8(d)
        x, kernel = pad_channels(x, cp), pad_kernel(kernel, cp, dp)
        res = out if dp == d else torch.empty(
            (b, h, w, dp), dtype=x.dtype, device=x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        pl = plan_conv("fwd", b, h, w, cp, dp, ks, torch.bfloat16, sms)
        part = (torch.empty(pl.splits * b * h * w * dp, dtype=torch.float32,
                            device=x.device) if pl.splits > 1 else None)
        err = fn(x.data_ptr(), kernel.data_ptr(), res.data_ptr(),
                 0 if part is None else part.data_ptr(), b, h, w, cp, dp, ks,
                 pl.tile_k, pl.tile_n, pl.tile_m[0], pl.tile_m[1], pl.splits,
                 pl.stages, pl.promote, pl.blocks_per_sm, pl.smem_bytes,
                 stream)
        if res is not out:
            out.copy_(res[..., :d])
    _build.check(err, name)
    _build.count(conv_same_cuda)
    return out


conv_same_cuda.launches = 0


def _acc_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def conv_same_plain(x, kernel):
    """The K*K shifted products accumulated in f32 (f64 for f64 inputs), as
    the JAX package's ``_mmconv_apply`` writes them, with one rounding to
    x's dtype."""
    _check_conv_args(x, kernel)
    b, h, w, c = x.shape
    ks = kernel.shape[0]
    p = ks // 2
    acc = _acc_dtype(x)
    xp = F.pad(x.to(acc), (0, 0, p, p, p, p))
    kf = kernel.to(acc)
    out = None
    for dy in range(ks):
        for dx in range(ks):
            contrib = torch.matmul(xp[:, dy:dy + h, dx:dx + w, :], kf[dy, dx])
            out = contrib if out is None else out + contrib
    return out.to(x.dtype)


def conv_same(x, kernel):
    """Dispatch: K3 for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return conv_same_cuda(x, kernel)
    if x.device.type == "cpu":
        return conv_same_plain(x, kernel)
    raise ValueError(f"unsupported device {x.device}")


def _check_dk_args(x, g, ks):
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"x (B, H, W, C) and g (B, H, W, D) must share "
                         f"(B, H, W), got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    if ks % 2 == 0 or ks < 3:
        raise ValueError(f"K must be odd and >= 3, got {ks}")


def conv_same_dk_cuda(x, g, ks):
    """Launch K4 (two passes, or one with a single partial) on CUDA
    tensors; returns f32 ``(K, K, C, D)``. ``conv_same_dk_cuda.launches``
    counts the calls. bf16 operands are padded as in ``conv_same_cuda``."""
    _check_dk_args(x, g, ks)
    x, g = _cuda_operands("conv_same_dk_cuda", x, g)
    b, h, w, c = x.shape
    d = g.shape[3]
    dk = torch.empty((ks, ks, c, d), dtype=torch.float32, device=x.device)
    if dk.numel() == 0:
        return dk
    if b * h * w == 0:
        return dk.zero_()
    suffix = _SUFFIX[x.dtype]
    name = f"conv_same_dk_{suffix}"
    fn = _build.function("mmconv", name, _DK_ARGTYPES[suffix])
    stream = _stream(x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if suffix == "f32":
        pl = plan_conv("dk", b, h, w, c, d, ks, torch.float32, sms)
        part = (dk if pl.partials == 1 else torch.empty(
            (pl.partials,) + tuple(dk.shape), dtype=torch.float32,
            device=x.device))
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(),
                 b, h, w, c, d, ks, pl.tile_m[1], pl.splits, stream)
    else:
        cp, dp = round8(c), round8(d)
        x, g = pad_channels(x, cp), pad_channels(g, dp)
        res = dk if (cp, dp) == (c, d) else torch.empty(
            (ks, ks, cp, dp), dtype=torch.float32, device=x.device)
        pl = plan_conv("dk", b, h, w, cp, dp, ks, torch.bfloat16, sms)
        part = (res if pl.partials == 1 else torch.empty(
            (pl.partials,) + tuple(res.shape), dtype=torch.float32,
            device=x.device))
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), res.data_ptr(),
                 b, h, w, cp, dp, ks, pl.tile_n, pl.taps, int(pl.ksplit),
                 pl.splits, pl.stages, pl.smem_bytes, stream)
        if res is not dk:
            dk.copy_(res[:, :, :c, :d])
    _build.check(err, name)
    _build.count(conv_same_dk_cuda)
    return dk


conv_same_dk_cuda.launches = 0


def conv_same_dk_plain(x, g, ks):
    """The K*K (bhw)-contractions of the JAX package's ``_mmconv2d_bwd``,
    in f32 (f64 for f64 inputs)."""
    _check_dk_args(x, g, ks)
    b, h, w, c = x.shape
    p = ks // 2
    acc = _acc_dtype(x)
    xp = F.pad(x.to(acc), (0, 0, p, p, p, p))
    g2 = g.to(acc).reshape(-1, g.shape[3])
    rows = []
    for dy in range(ks):
        rows.append(torch.stack([
            xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, c).T @ g2
            for dx in range(ks)]))
    return torch.stack(rows)


def conv_same_dk(x, g, ks):
    """Dispatch: K4 for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return conv_same_dk_cuda(x, g, ks)
    if x.device.type == "cpu":
        return conv_same_dk_plain(x, g, ks)
    raise ValueError(f"unsupported device {x.device}")


def rot_transpose(kernel):
    """Kernel of the transpose conv: both spatial dims flipped, channel
    axes swapped (``mmconv_pallas.py`` ``_rot_transpose``)."""
    return kernel.flip(0, 1).permute(0, 1, 3, 2).contiguous()


class MMConv2dFunction(torch.autograd.Function):
    """Differentiable SAME conv on K3/K4 (``mmconv2d_pallas`` and its VJP):
    ``apply(x, kernel)`` with NHWC ``x`` and a ``(K, K, C, D)`` kernel of
    x's dtype."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return conv_same(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv_same(g, rot_transpose(kernel))
        dk = conv_same_dk(x, g, kernel.shape[0])
        return dx, dk.to(kernel.dtype)
