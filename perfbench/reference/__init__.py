"""The plain reference: float32 PyTorch that imports nothing of the
program, written from the published description."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """float32 matrix products and convolutions in full float32 (no TF32)
    for the enclosed block."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
