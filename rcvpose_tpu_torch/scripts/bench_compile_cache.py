"""What a serving process's cold start costs with an empty kernel-library
cache and with a warm one; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.bench_compile_cache [--small]
        [--device cpu]

The counterpart of the JAX package's ``scripts/bench_compile_cache.py``.
There XLA compiles the serving frame program at first use and
``--compile_cache_dir`` keeps the executable on disk; here ``nvcc``
builds the kernel libraries (``csrc/*.cu``) at first use and
``--compile_cache_dir`` (``utils.enable_compile_cache``) names the
directory they build into and load from. Two fresh child processes share
one directory that is empty at first: the first builds the libraries
serving needs (``vote``: K1, ``heads``: K2), the second loads them. Each
child times, at ``bench.py``'s configuration (DenseFCNResNet152, bf16,
480x640, grid 128, 8192 points, hier, 3 seeded nets):

- ``libs_s``: building or loading those libraries (``built`` lists the
  sources nvcc compiled in that process);
- ``first_estimate_ms``: the first ``PoseEstimator.estimate`` (the
  estimator is built before, as a server builds it before its socket
  opens: ``setup_s``);
- ``second_estimate_ms``: the next one;

each on the host clock, ending in a synchronize, with K1's and K2's
launches. The record holds both children as ``cold`` and ``warm``, the
files the directory holds and ``device`` (the card's name and power
limit). ``--small --device cpu`` is the CPU smoke: the small net (width
0.125, blocks 1,1,1,1, f32, grid 64, 1024 points, 96x128), nothing built,
the plain versions run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SERVING_LIBRARIES = ("vote", "heads")
_ROOT = Path(__file__).resolve().parents[2]


def child(cache_dir, small, device):
    """One process's cold start against ``cache_dir``; returns its
    record."""
    from rcvpose_tpu_torch import utils

    utils.enable_compile_cache(cache_dir)
    dev = utils.resolve_device(device)

    from rcvpose_tpu_torch.ops import _build, heads, vote_cuda
    from rcvpose_tpu_torch.scripts.bench_serving_latency import (
        build_estimator, serving_config, synth_frame)

    t0 = time.perf_counter()
    built = []
    if dev.type == "cuda":
        built = sorted(_build.build(SERVING_LIBRARIES))
        for name in SERVING_LIBRARIES:
            _build.load(name)
    libs_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, (h, w) = serving_config(small)
    est = build_estimator(cfg, fused=False, device=dev)
    image, depth = synth_frame(h, w)
    utils.synchronize(dev)
    setup_s = time.perf_counter() - t0

    counters = (vote_cuda.vote_counts_cuda, heads.heads_channel_major_cuda)
    for fn in counters:
        fn.launches = 0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        est.estimate(image, depth)
        utils.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"libs_s": libs_s, "built": built, "setup_s": setup_s,
            "first_estimate_ms": times[0], "second_estimate_ms": times[1],
            "vote_counts_launches": counters[0].launches,
            "heads_channel_major_launches": counters[1].launches,
            "backend": dev.type}


def run_child(cache_dir, small=False, device=None, timeout=1800):
    """``child`` in a fresh process (``python -m`` from the repository's
    root); returns its record."""
    cmd = [sys.executable, "-m", "rcvpose_tpu_torch.scripts."
           "bench_compile_cache", "--child", "--cache_dir", str(cache_dir)]
    cmd += ["--small"] if small else []
    cmd += ["--device", str(device)] if device is not None else []
    out = subprocess.run(cmd, cwd=_ROOT, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"bench_compile_cache child failed "
                           f"({out.returncode}):\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None, device=None, printer=print):
    """Run the cold and the warm child; prints and returns the record."""
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.bench_compile_cache")
    ap.add_argument("--small", action="store_true",
                    help="the small net at the CPU smoke's shapes")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cache_dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = args.device or device
    if args.child:
        printer(json.dumps(child(args.cache_dir, args.small, device)))
        return None

    from rcvpose_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    cache_dir = tempfile.mkdtemp(prefix="rcvpose_kernels_")
    try:
        cold = run_child(cache_dir, args.small, str(dev))
        warm = run_child(cache_dir, args.small, str(dev))
        entries = sorted(os.listdir(cache_dir))
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    if dev.type == "cuda":
        from rcvpose_tpu_torch.scripts import card_line

        name = card_line()
    else:
        name = "cpu"
    record = {
        "metric": "compile_cache_warm_libs_s",
        "value": round(warm["libs_s"], 3),
        "unit": "s",
        "cold_libs_s": round(cold["libs_s"], 3),
        "speedup": round(cold["libs_s"] / max(warm["libs_s"], 1e-9), 1),
        "cold": cold,
        "warm": warm,
        "cache_entries": entries,
        "device": name,
        "note": ("two fresh processes against one kernel-library directory, "
                 "empty at first: cold builds the serving libraries with "
                 "nvcc, warm loads them (--compile_cache_dir); each then "
                 "times its first and second PoseEstimator.estimate on the "
                 "host clock, ending in a synchronize"),
    }
    printer(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
