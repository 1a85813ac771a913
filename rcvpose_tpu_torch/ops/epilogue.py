"""The conv epilogue (``csrc/epilogue.cu``) and its plain version.

``conv_epilogue(x, scale, shift, residual=None, relu=True)`` computes, in
place on a conv's output ``x`` (N, C, H, W), ``relu?(x * scale[c] +
shift[c] (+ residual))`` in f32 and rounds once to ``x``'s dtype; it
returns ``x``. It is the second half of a folded conv -> batch norm
(-> + residual) (-> ReLU) unit of the serving nets (``models/folded.py``).
Kernel and plain version agree bit for bit: each multiplies, then adds,
then adds the residual, each step rounded to f32 (no fused multiply-add).
``conv_epilogue`` dispatches: the kernel for CUDA tensors, the plain
version for CPU tensors. It is for inference: autograd does not see the
kernel's write, so it refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from rcvpose_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_ENTRY = {torch.float32: "conv_epilogue_f32",
          torch.bfloat16: "conv_epilogue_bf16"}


def _check_operands(x, scale, shift, residual):
    if x.dim() != 4:
        raise ValueError(f"expected (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be f32 ({c},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual must be {x.dtype} {tuple(x.shape)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")


def conv_epilogue_cuda(x, scale, shift, residual=None, relu=True):
    """Launch the epilogue on CUDA tensors: ``x`` bf16 or f32,
    channels-last and contiguous with C a multiple of 8, the residual laid
    out as ``x``, every operand on ``x``'s device and 16-byte aligned;
    raises otherwise. ``conv_epilogue_cuda.launches`` counts the
    launches."""
    _check_operands(x, scale, shift, residual)
    if x.dtype not in _ENTRY:
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    if c % 8:
        raise ValueError(f"the epilogue takes C a multiple of 8, got {c}")
    operands = [x, scale, shift] + ([] if residual is None else [residual])
    for t in operands:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("conv_epilogue_cuda needs every tensor on x's "
                             "CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("conv_epilogue_cuda needs 16-byte aligned "
                             "tensors")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and not t.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError(f"conv_epilogue_cuda: {name} must be "
                             f"channels-last and contiguous")
    if not (scale.is_contiguous() and shift.is_contiguous()):
        raise ValueError("conv_epilogue_cuda: scale and shift must be "
                         "contiguous")
    fn = _build.function("epilogue", _ENTRY[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), None if residual is None
                 else residual.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), x.numel(), c, int(relu), stream)
    _build.check(err, _ENTRY[x.dtype])
    _build.count(conv_epilogue_cuda)
    return x


conv_epilogue_cuda.launches = 0


def conv_epilogue_plain(x, scale, shift, residual=None, relu=True):
    """The epilogue as tensor ops, written into ``x``: ``x * scale +
    shift`` in f32 (two roundings), ``+ residual``, ``t < 0 ? 0 : t``,
    then one rounding to ``x``'s dtype."""
    _check_operands(x, scale, shift, residual)
    c = x.shape[1]
    y = x.float() * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.where(y < 0, 0.0, y)
    return x.copy_(y)


def conv_epilogue(x, scale, shift, residual=None, relu=True):
    """The kernel for a CUDA ``x``, the plain version for a CPU one; in
    place, returns ``x``."""
    if torch.is_grad_enabled() and (x.requires_grad or (
            residual is not None and residual.requires_grad)):
        raise RuntimeError("conv_epilogue is for inference: its inputs "
                           "must not require grad")
    if x.device.type == "cuda":
        return conv_epilogue_cuda(x, scale, shift, residual, relu)
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, scale, shift, residual, relu)
    raise ValueError(f"unsupported device {x.device}")
