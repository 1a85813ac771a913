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

import torch
import torch.nn.functional as F

from rcvpose_tpu_torch.ops import _build

_FWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                 + [ctypes.c_void_p])
_DK_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K4 splits its pixel reduction into slices so that enough blocks fill the
# card (BLOCKS_PER_SM on each multiprocessor) while the f32 partial sums
# stay under SCRATCH_BYTES.
BLOCKS_PER_SM = 8
SCRATCH_BYTES = 256 << 20
_SLICE_ALIGN = 32


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


def _vec(t, n):
    """16-byte loads along a row of ``n`` elements: bf16 rows whose length
    is a multiple of 8, in a 16-byte aligned buffer."""
    return int(t.dtype == torch.bfloat16 and n % 8 == 0
               and t.data_ptr() % 16 == 0)


def conv_same_cuda(x, kernel):
    """Launch K3 on CUDA tensors; ``conv_same_cuda.launches`` counts the
    launches."""
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
    name = f"conv_same_{_SUFFIX[x.dtype]}"
    fn = _build.function("mmconv", name, _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, h, w, c,
                 d, ks, _vec(x, c), _vec(kernel, d), stream)
    _build.check(err, name)
    conv_same_cuda.launches += 1
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


def dk_slices(pixels, ks, c, d, sm_count):
    """(pixels per slice, slice count) of K4's split pixel reduction: enough
    slices that the blocks fill a card of ``sm_count`` multiprocessors, few
    enough that the f32 partial sums stay under ``SCRATCH_BYTES``; one
    slice writes dk directly."""
    tiles = -(-c // 64) * -(-d // 64) * ks * ks
    want = max(1, -(-(sm_count * BLOCKS_PER_SM) // tiles))
    cap = max(1, SCRATCH_BYTES // (ks * ks * c * d * 4))
    most = max(1, -(-pixels // _SLICE_ALIGN))
    n = min(want, cap, most, 65535)
    per = -(-pixels // n)
    per = -(-per // _SLICE_ALIGN) * _SLICE_ALIGN
    return per, -(-pixels // per)


def conv_same_dk_cuda(x, g, ks):
    """Launch K4 (two passes, or one with a single slice) on CUDA tensors;
    returns f32 ``(K, K, C, D)``. ``conv_same_dk_cuda.launches`` counts the
    calls."""
    _check_dk_args(x, g, ks)
    x, g = _cuda_operands("conv_same_dk_cuda", x, g)
    b, h, w, c = x.shape
    d = g.shape[3]
    dk = torch.empty((ks, ks, c, d), dtype=torch.float32, device=x.device)
    pixels = b * h * w
    if dk.numel() == 0:
        return dk
    if pixels == 0:
        return dk.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per, n = dk_slices(pixels, ks, c, d, sms)
    part = (dk if n == 1 else
            torch.empty((n,) + tuple(dk.shape), dtype=torch.float32,
                        device=x.device))
    name = f"conv_same_dk_{_SUFFIX[x.dtype]}"
    fn = _build.function("mmconv", name, _DK_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(),
                 b, h, w, c, d, ks, _vec(x, c), _vec(g, d), per, n, stream)
    _build.check(err, name)
    conv_same_dk_cuda.launches += 1
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
