"""K2, the head-split kernel (``csrc/heads.cu``), its backward, and their
plain versions.

The forward turns conv8's ``(B, 2K, H, W)`` output (bf16 or f32, NCHW or
channels-last strides) into one contiguous f32 channel-major
``(2K, B, H, W)`` buffer; the backward turns the f32 ``(2K, B, H, W)``
cotangent back into ``(B, 2K, H, W)`` in the input's dtype and strides.
Kernel and plain version agree bit for bit in both directions.
``heads_channel_major`` is differentiable and dispatches: the kernels for
CUDA tensors, the plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from rcvpose_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
                 + [ctypes.c_int, ctypes.c_void_p])
# The branches of K2 and its backward (csrc/heads.cu): one thread a run of 8
# elements where the channels-last or NCHW side is contiguous (ROWS for a
# channels-last one with 2K in ROWS_CHANNELS, PLANES for an NCHW one), one
# thread an element otherwise.
BRANCHES = ("generic", "planes", "rows")
ROWS_CHANNELS = (2, 4, 6, 8)
_ENTRY = {torch.float32: "heads_channel_major_f32",
          torch.bfloat16: "heads_channel_major_bf16"}
_BWD_ENTRY = {torch.float32: "heads_channel_major_bwd_f32",
              torch.bfloat16: "heads_channel_major_bwd_bf16"}


def _check_int32(t, what):
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    if max(t.numel(), last + 1) >= 2 ** 30:
        raise ValueError(f"{what}: tensor too large for int32 indexing")


def fwd_branch(out):
    """Which branch of K2 takes conv8's output ``out`` (B, 2K, H, W):
    "rows" where it is channels-last and contiguous with 2K in
    ``ROWS_CHANNELS``, "planes" where it is NCHW and contiguous (at most
    65535 planes, the planes grid's y), "generic" otherwise (a strided
    view). Any base offset takes the vectorized branches: misaligned runs
    go scalar in the kernel."""
    b, c = out.shape[:2]
    if out.is_contiguous(memory_format=torch.channels_last) and \
            c in ROWS_CHANNELS:
        return "rows"
    if out.is_contiguous() and b * c <= 65535:
        return "planes"
    return "generic"


def heads_channel_major_cuda(out):
    """Launch K2 on a CUDA tensor through the branch ``fwd_branch`` picks;
    ``heads_channel_major_cuda.launches`` counts the launches."""
    if out.device.type != "cuda":
        raise ValueError("heads_channel_major_cuda needs a CUDA tensor")
    if out.dim() != 4:
        raise ValueError(f"expected (B, 2K, H, W), got {tuple(out.shape)}")
    if out.dtype not in _ENTRY:
        raise TypeError(f"expected float32 or bfloat16, got {out.dtype}")
    b, c, h, w = out.shape
    _check_int32(out, "heads_channel_major_cuda")
    res = torch.empty((c, b, h, w), dtype=torch.float32, device=out.device)
    if res.numel() == 0:
        return res
    fn = _build.function("heads", _ENTRY[out.dtype], _ARGTYPES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(out.data_ptr(), res.data_ptr(), b, c, h, w, *out.stride(),
                 BRANCHES.index(fwd_branch(out)), stream)
    _build.check(err, _ENTRY[out.dtype])
    _build.count(heads_channel_major_cuda)
    return res


heads_channel_major_cuda.launches = 0


def heads_channel_major_plain(out):
    """``(B, 2K, H, W)`` -> contiguous f32 ``(2K, B, H, W)``."""
    return out.float().permute(1, 0, 2, 3).contiguous()


def _is_channels_last(t):
    return (t.is_contiguous(memory_format=torch.channels_last)
            and not t.is_contiguous())


def _grad_buffer(g, dtype, channels_last):
    """Empty ``(B, 2K, H, W)`` gradient buffer for the ``(2K, B, H, W)``
    cotangent ``g``, in ``dtype``, NCHW or channels-last."""
    c, b, h, w = g.shape
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return torch.empty((b, c, h, w), dtype=dtype, device=g.device,
                       memory_format=fmt)


def bwd_branch(g, channels_last):
    """Which branch of K2's backward takes the cotangent ``g`` (2K, B, H, W)
    for an NCHW or channels-last output: "planes" or "rows" where ``g`` is
    contiguous (any base offset: misaligned runs go scalar in the kernel),
    "generic" for a strided ``g``, a channels-last 2K outside
    ``ROWS_CHANNELS``, or more than 65535 output planes (the planes grid's
    y)."""
    c, b = g.shape[:2]
    if not g.is_contiguous():
        return "generic"
    if channels_last:
        return "rows" if c in ROWS_CHANNELS else "generic"
    return "planes" if b * c <= 65535 else "generic"


def heads_channel_major_bwd_cuda(g, dtype, channels_last=False):
    """Launch K2's backward: the f32 ``(2K, B, H, W)`` cotangent ``g`` (any
    strides) -> ``(B, 2K, H, W)`` in ``dtype``, NCHW or channels-last (the
    forward input's dtype and layout), through the branch ``bwd_branch``
    picks. ``heads_channel_major_bwd_cuda.launches`` counts the launches."""
    if g.device.type != "cuda":
        raise ValueError("heads_channel_major_bwd_cuda needs a CUDA tensor")
    if g.dim() != 4 or g.dtype != torch.float32:
        raise ValueError(f"expected an f32 (2K, B, H, W) cotangent, got "
                         f"{g.dtype} {tuple(g.shape)}")
    if dtype not in _BWD_ENTRY:
        raise TypeError(f"expected float32 or bfloat16, got {dtype}")
    _check_int32(g, "heads_channel_major_bwd_cuda")
    res = _grad_buffer(g, dtype, channels_last)
    if res.numel() == 0:
        return res
    branch = bwd_branch(g, channels_last)
    c, b, h, w = g.shape
    ints = ctypes.c_int * 4
    if branch == "generic":
        # (b, c, h, w) of the output <- (c, b, h, w) of g; dims ordered by
        # the output's strides, outermost first (a stable sort keeps b, c,
        # h, w order among ties)
        g_strides = dict(zip("cbhw", g.stride()))
        dims = sorted(zip("bchw", res.shape, res.stride()),
                      key=lambda d: -d[2])
        sizes = ints(*(n for _, n, _ in dims))
        gs = ints(*(g_strides[name] for name, _, _ in dims))
        os_ = ints(*(st for _, _, st in dims))
    else:
        sizes = ints(*((b, h, w, c) if branch == "rows" else (b, c, h, w)))
        gs = os_ = ints(0, 0, 0, 0)
    fn = _build.function("heads", _BWD_ENTRY[dtype], _BWD_ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), res.data_ptr(), sizes, gs, os_,
                 BRANCHES.index(branch), stream)
    _build.check(err, _BWD_ENTRY[dtype])
    _build.count(heads_channel_major_bwd_cuda)
    return res


heads_channel_major_bwd_cuda.launches = 0


def heads_channel_major_bwd_plain(g, dtype, channels_last=False):
    """``g.permute(1, 0, 2, 3).to(dtype)``, NCHW or channels-last."""
    res = _grad_buffer(g, dtype, channels_last)
    res.copy_(g.permute(1, 0, 2, 3))
    return res


class _HeadsChannelMajor(torch.autograd.Function):
    """K2 with its backward (the VJP of ``layout.py`` ``_pinned_identity``,
    which the JAX package's training loss differentiates through)."""

    @staticmethod
    def forward(ctx, out):
        ctx.dtype = out.dtype
        ctx.channels_last = _is_channels_last(out)
        if out.device.type == "cuda":
            return heads_channel_major_cuda(out)
        return heads_channel_major_plain(out)

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cuda":
            return heads_channel_major_bwd_cuda(g, ctx.dtype,
                                                ctx.channels_last)
        return heads_channel_major_bwd_plain(g, ctx.dtype, ctx.channels_last)


def heads_channel_major(out):
    """Differentiable dispatch: K2 (and its backward) for a CUDA tensor, the
    plain versions for a CPU one."""
    if out.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {out.device}")
    return _HeadsChannelMajor.apply(out)
