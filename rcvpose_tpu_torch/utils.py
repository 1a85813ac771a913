"""Device selection, the kernel-library cache, log directories and stage
timers shared by the port's entry points."""

from __future__ import annotations

import contextlib
import os
import time

import torch


def resolve_device(device=None):
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises instead of
    carrying on on the CPU. The CPU runs only when the caller names it
    (``device="cpu"``), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


def enable_compile_cache(cache_dir):
    """Build and load the port's compiled libraries in ``cache_dir`` (made
    if missing): the CUDA kernels of ``csrc/`` (``ops._build``, with
    ``other/`` beneath it for earlier sources) and the native readers
    (``native``). The counterpart of the JAX package's persistent XLA
    cache: the first process to start pays nvcc's and g++'s builds, and
    every later one, across restarts, loads the libraries from disk. A
    read-only install, or servers started side by side, name a directory
    of their own here (``--compile_cache_dir``).

    Safe to share between concurrent processes: a library's file name
    hashes its source and flags, and each build writes a per-process
    temporary file that then replaces the target. Call it before the
    first kernel launches: it raises if a library is loaded from another
    directory already, since it could not move that one. Returns the
    directory."""
    from pathlib import Path

    from rcvpose_tpu_torch import native
    from rcvpose_tpu_torch.ops import _build

    path = Path(cache_dir).expanduser().resolve()
    clash = _build.loaded_elsewhere(path) + native.loaded_elsewhere(path)
    if clash:
        raise RuntimeError(
            f"enable_compile_cache({str(cache_dir)!r}): the libraries "
            f"{clash} are loaded from another directory already; call it "
            "before the first kernel launches")
    _build.set_build_dir(path)
    native.set_build_dir(path)
    return str(path)


def synchronize(device):
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU): the counterpart of ``jax.block_until_ready``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def get_log_dir(cfg):
    """Create ``logs/<dataset>/<class>Kp<k>/`` (``cfg.log_dir()``) and dump
    the config there as ``config.json``; returns the directory."""
    log_dir = cfg.log_dir()
    os.makedirs(log_dir, exist_ok=True)
    cfg.dump(os.path.join(log_dir, "config.json"))
    return log_dir


class StageTimers:
    """Per-stage wall-clock accumulators that are actually reported —
    the reference accumulated net_time/acc_time and never printed them
    (AccumulatorSpace.py:510-511). ``time(stage, device)`` ends in a
    synchronize of ``device`` when it is a CUDA device, so a stage is
    billed the device work it queued."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def time(self, stage, device=None):
        t0 = time.perf_counter_ns()
        try:
            yield
            if device is not None:
                synchronize(device)
        finally:
            dt = time.perf_counter_ns() - t0
            self.totals[stage] = self.totals.get(stage, 0) + dt
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def report(self):
        return {stage: {"total_ms": self.totals[stage] / 1e6,
                        "mean_ms": self.totals[stage] / 1e6
                        / max(self.counts[stage], 1),
                        "count": self.counts[stage]}
                for stage in self.totals}
