"""The ICP kernels of ``csrc/icp.cu``: ``fit.icp_point_to_point``'s
nearest neighbours and pose update on CUDA tensors.

- ``nearest_cuda`` stands for ``fit._nn`` (its plain version): each
  source point's nearest valid target in the ``(|s|^2 - 2 s.t) + |t|^2``
  f32 form, first index on ties, without the S x T distance matrix. Two
  launches; the blocks combine through a 64-bit ``atomicMin`` in ``keys``
  (``new_keys``), which the second launch resets for the next update.
- ``update_pose_cuda`` stands for ``fit._update_pose`` (its plain
  version): Horn's 4 x 4 solve from the sums, the keep rule and
  ``delta @ rt``, in one launch where the tensor ops take some 150.

Each kernel rounds as its plain version's tensor ops round on the card
(cuBLAS's small products as fused multiply-adds in its order, torch's
sums of three and four values in theirs; ``csrc/icp.cu`` says which), so
the two agree bit for bit there, and so does a refinement through them
with one through the tensor ops. The CPU has no kernel: ``fit`` runs the
tensor ops. A wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from rcvpose_tpu_torch.ops import _build

# The key of a point no valid target has reached yet (~0 as an int64).
NO_KEY = -1

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_NEAREST_ARGTYPES = [_PTR, _INT, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _PTR,
                     _PTR]
_UPDATE_ARGTYPES = [_PTR] * 7


def _launch(symbol, argtypes, args, device):
    fn = _build.function("icp", symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, symbol)


def _on_card(what, tensors, dtypes):
    """The tensors, contiguous, on one CUDA device with the given dtypes;
    raises otherwise."""
    dev = tensors[0].device
    for t, dtype in zip(tensors, dtypes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what} needs every tensor on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    return [t.contiguous() for t in tensors]


def new_keys(n_src, device):
    """The (S,) int64 workspace of ``nearest_cuda`` for S source points."""
    return torch.full((n_src,), NO_KEY, dtype=torch.int64, device=device)


def nearest_cuda(src, target, t2, target_mask, keys):
    """``fit._nn(src, target, t2, target_mask)`` on CUDA tensors: (index
    (S,) int64, distance (S,) f32). ``keys`` is ``new_keys``'s workspace,
    reset again on return. ``nearest_cuda.launches`` counts the launches
    (two a call)."""
    s, n = src.shape[0], target.shape[0]
    if src.dim() != 2 or src.shape[1] != 3 or s < 1:
        raise ValueError(f"src must be (S, 3), S >= 1, got {tuple(src.shape)}")
    if target.dim() != 2 or target.shape[1] != 3 or n < 1:
        raise ValueError(f"target must be (T, 3), T >= 1, got "
                         f"{tuple(target.shape)}")
    if (tuple(t2.shape), tuple(target_mask.shape), tuple(keys.shape)) != (
            (n,), (n,), (s,)):
        raise ValueError(f"t2 and target_mask must be ({n},), keys ({s},)")
    if max(s, n) * 3 >= 2 ** 31:
        raise ValueError("ICP clouds too large for int32 indexing")
    f32 = torch.float32
    src, target, t2, target_mask, keys = _on_card(
        "nearest_cuda", (src, target, t2, target_mask, keys),
        (f32, f32, f32, torch.bool, torch.int64))
    idx = torch.empty(s, dtype=torch.int64, device=src.device)
    dist = torch.empty(s, dtype=f32, device=src.device)
    _launch("icp_nearest", _NEAREST_ARGTYPES,
            (src.data_ptr(), s, target.data_ptr(), t2.data_ptr(),
             target_mask.data_ptr(), n, keys.data_ptr(), idx.data_ptr(),
             dist.data_ptr()), src.device)
    _build.count(nearest_cuda, n=2)
    return idx, dist


nearest_cuda.launches = 0


def update_pose_cuda(s, c1, c2, n_corr, rt):
    """``fit._update_pose(s, c1, c2, n_corr, rt)`` on CUDA tensors: S
    (3, 3), centroids (3,), n_corr (), rt (4, 4), all f32; returns the new
    (4, 4) pose. ``update_pose_cuda.launches`` counts the launches."""
    shapes = tuple(tuple(t.shape) for t in (s, c1, c2, n_corr, rt))
    if shapes != ((3, 3), (3,), (3,), (), (4, 4)):
        raise ValueError(f"expected S (3, 3), centroids (3,), n_corr () and "
                         f"rt (4, 4), got {shapes}")
    args = _on_card("update_pose_cuda", (s, c1, c2, n_corr, rt),
                    (torch.float32,) * 5)
    out = torch.empty((4, 4), dtype=torch.float32, device=s.device)
    _launch("icp_pose_update", _UPDATE_ARGTYPES,
            tuple(t.data_ptr() for t in args) + (out.data_ptr(),), s.device)
    _build.count(update_pose_cuda)
    return out


update_pose_cuda.launches = 0
