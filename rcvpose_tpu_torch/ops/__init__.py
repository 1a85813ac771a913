"""Kernels (CUDA C++ under ``csrc/``, each with its plain PyTorch version)
and the vote accumulator."""

from rcvpose_tpu_torch.ops.voting import (  # noqa: F401
    VOTE_BAND,
    AccumulatorResult,
    accumulate_3d,
    vote_counts_reference,
    vote_grid_oracle,
)
