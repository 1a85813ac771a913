"""The training loop's host costs on the card; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.bench_train_loop [batch] [steps]
        [--small] [--device cpu]

The counterpart of the JAX package's ``scripts/bench_train_loop.py``. Two
costs that ``bench_train`` (steps back to back) does not see:

1. **The metric fetch.** ``Trainer.train_epoch`` reads the step's metrics
   on the host (``float``, which waits for the device) every
   ``log_interval`` steps. Measured: ms/step through the real
   ``train_epoch`` at ``log_interval`` 1 against the default (10), with
   the batch already on the card, so the fetch is the loop's only host
   interaction; interleaved runs, 3 of each, the least of each arm.
2. **The checkpoint stall.** ``Checkpointer.save``'s return latency with
   ``async_save=True`` (it returns once the state is copied to host
   memory, and a thread writes) against ``async_save=False`` (it returns
   once the file is written), on the full-width training state: the
   parameters, BN statistics and Adam's two moments.

bf16 compute on the card (batch 8, 480x640, 30 steps by default); the CPU
runs only with ``--device cpu`` (``--small``: the small net at 64x64, f32).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
import tempfile
import time

import torch


def save_ms(checkpoint, state, async_save):
    """(ms until ``save`` returned, ms until the write was on disk) of one
    save into a fresh directory, after a first save that warms it."""
    d = tempfile.mkdtemp(prefix="bench_ckpt_")
    try:
        ck = checkpoint.Checkpointer(d, async_save=async_save)
        ck.save(state, epoch=0, iteration=0, best_val=1.0)
        ck.wait_until_finished()
        t0 = time.perf_counter()
        ck.save(state, epoch=1, iteration=1, best_val=0.5)
        ret = time.perf_counter() - t0
        ck.wait_until_finished()
        return ret * 1e3, (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None, device=None):
    """Measure and print the record; returns it."""
    from rcvpose_tpu_torch import checkpoint
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.scripts.bench_train import seeded_batch
    from rcvpose_tpu_torch.utils import resolve_device, synchronize

    argv = sys.argv[1:] if argv is None else list(argv)
    small = "--small" in argv
    dev_arg = None
    if "--device" in argv:
        dev_arg = argv[argv.index("--device") + 1]
        argv.remove("--device")
        argv.remove(dev_arg)
    pos = [int(a) for a in argv if not a.startswith("--")]
    batch = pos[0] if pos else 8
    steps = pos[1] if len(pos) > 1 else 30
    dev = resolve_device(dev_arg or device)

    if small:
        h, w = 64, 64
        cfg = Config(compute_dtype="float32", image_height=h, image_width=w,
                     batch_size=batch, model_blocks="1,1,1,1",
                     model_width=0.125)
    else:
        h, w = 480, 640
        cfg = Config(compute_dtype="bfloat16" if dev.type == "cuda"
                     else "float32", image_height=h, image_width=w,
                     batch_size=batch)
    state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                   device=dev)
    data = seeded_batch(batch, h, w, dev)

    def run_epoch(log_interval, n):
        c = dataclasses.replace(cfg, log_interval=log_interval,
                                max_iterations=10 ** 9)
        tr = train_mod.Trainer(cfg=c, state=state,
                               train_batches=lambda epoch: (data
                                                            for _ in range(n)),
                               val_batches=lambda: iter(()))
        synchronize(dev)
        t0 = time.perf_counter()
        tr.train_epoch(0)
        synchronize(dev)
        return (time.perf_counter() - t0) / n * 1e3

    run_epoch(1, 2)     # kernels built, allocator and cuDNN warm
    every_s, interval_s = [], []
    for _ in range(3):
        every_s.append(run_epoch(1, steps))
        interval_s.append(run_epoch(cfg.log_interval, steps))
    ms_every, ms_interval = min(every_s), min(interval_s)

    async_ret, async_total = save_ms(checkpoint, state, True)
    sync_ret, _ = save_ms(checkpoint, state, False)
    n_params = sum(p.numel() for p in state.model.parameters())
    from rcvpose_tpu_torch.scripts import card_line

    record = {
        "metric": "train_loop_host_costs",
        "value": round(ms_every - ms_interval, 2),
        "unit": "ms/step saved by interval metric fetch",
        "ms_per_step_fetch_every": round(ms_every, 2),
        f"ms_per_step_fetch_interval{cfg.log_interval}": round(
            ms_interval, 2),
        "samples_fetch_every": [round(v, 3) for v in every_s],
        "samples_fetch_interval": [round(v, 3) for v in interval_s],
        "ckpt_save_return_ms_async": round(async_ret, 1),
        "ckpt_save_return_ms_sync": round(sync_ret, 1),
        "ckpt_stall_removed_ms": round(sync_ret - async_ret, 1),
        "ckpt_background_write_ms": round(async_total - async_ret, 1),
        "params": n_params,
        "batch": batch, "image_hw": [h, w], "steps": steps,
        "backend": dev.type,
        "device": card_line() if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
