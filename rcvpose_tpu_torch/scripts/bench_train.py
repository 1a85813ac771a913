"""Training-step throughput of the full model on the card; prints ONE JSON
line last.

    python -m rcvpose_tpu_torch.scripts.bench_train [batch] [height] [width]
        [--remat] [--accum N] [--steps N] [--small] [--device cpu]

The counterpart of the JAX package's ``scripts/bench_train.py``: the same
seeded batch (default 8 at 480x640) already on the card, ``Trainer``'s own
``train_step`` (or, with ``--accum N``, its accumulation step over N
microbatches of batch/N) run ``--steps`` times (32) back to back on the
host clock with one synchronize at the end, best of 3 runs (``runs_ms``
holds each run's ms a step). bf16 compute with f32 parameters and Adam on
the card; f32 on the CPU, which runs only with ``--device cpu`` (and
``--small``, the small net, to finish in seconds).

The decoder convs take the route ``RCVPOSE_PALLAS_CONV`` names
(``cli.conv_kernel_route``): ``on`` runs K3/K4, the default cuDNN; the
record's ``conv_route`` says which.

``tflops_per_step`` counts one step with ``torch.utils.flop_counter.
FlopCounterMode``: convolutions and matrix products only (their forward
and backward), where XLA's ``cost_analysis`` in the JAX script also counts
elementwise work. K3/K4 are calls the counter cannot see, so on the K3/K4
route one step of a cuDNN-route twin of the same shapes is counted.
``mfu_vs_bf16_peak`` divides the FLOPs a second by the dense bf16
tensor-core peak of the card ``scripts.card_line`` names (``BF16_PEAKS``);
for a card the table lacks, and on the CPU, it is null.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# Dense bf16 tensor-core peaks (FLOP/s) by the name nvidia-smi prints:
# NVIDIA's H100 SXM data sheet.
BF16_PEAKS = {"NVIDIA H100 80GB HBM3": 989.4e12}
RUNS = 3


def parse_args(argv):
    """``[batch] [height] [width] [--remat] [--accum N] [--steps N]
    [--small] [--device D]`` -> dict."""
    out = {"remat": False, "accum": 1, "steps": 32, "small": False,
           "device": None}
    pos = []
    it = iter(argv)
    for a in it:
        if a == "--remat":
            out["remat"] = True
        elif a == "--small":
            out["small"] = True
        elif a in ("--accum", "--steps", "--device"):
            val = next(it)
            out[a[2:]] = val if a == "--device" else int(val)
        else:
            pos.append(int(a))
    out["batch"], out["height"], out["width"] = (pos + [8, 480, 640][
        len(pos):])[:3]
    return out


def seeded_batch(batch, h, w, device):
    """The JAX script's batch from ``default_rng(0)``: a normal image, a
    radial map uniform in [1, 3) dm in the middle half, sem +1 there and
    -1 elsewhere."""
    rng = np.random.default_rng(0)
    radial = np.zeros((batch, h, w), np.float32)
    radial[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = rng.uniform(
        1, 3, size=(batch, h // 2, w // 2))
    host = {"image": rng.normal(size=(batch, h, w, 3)).astype(np.float32),
            "radial": radial,
            "sem": np.where(radial > 0, 1.0, -1.0).astype(np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


def step_fn(accum):
    from rcvpose_tpu_torch import train as train_mod

    return (train_mod.make_accum_train_step(accum) if accum > 1
            else train_mod.train_step)


def step_flops(cfg, state, batch, accum, conv_kernel):
    """FLOPs of one training step (convolutions and matrix products, as
    ``FlopCounterMode`` counts them); on the K3/K4 route, of a step of a
    cuDNN-route twin with the same shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from rcvpose_tpu_torch import train as train_mod

    if conv_kernel:
        state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                       device=state.device)
    counter = FlopCounterMode(display=False)
    with counter:
        step_fn(accum)(state, batch)
    return counter.get_total_flops()


def bf16_peak(card):
    """The dense bf16 peak (FLOP/s) of the card ``card`` (``card_line``)
    names, or None."""
    return BF16_PEAKS.get(card.split(",")[0].strip())


def main(argv=None, device=None):
    """Measure and print the record; returns it."""
    from rcvpose_tpu_torch import cli
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.utils import resolve_device, synchronize

    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args["device"] or device)
    card = dev.type == "cuda"
    conv_kernel = cli.conv_kernel_route()
    batch, h, w = args["batch"], args["height"], args["width"]
    small = {"model_width": 0.125, "model_blocks": "1,1,1,1"}
    cfg = Config(compute_dtype="bfloat16" if card else "float32",
                 image_height=h, image_width=w, batch_size=batch,
                 remat=args["remat"], accum_steps=args["accum"],
                 **(small if args["small"] else {}))
    state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                   device=dev, conv_kernel=conv_kernel)
    data = seeded_batch(batch, h, w, dev)
    step = step_fn(args["accum"])
    reps = args["steps"]

    def run(n):
        nonlocal state
        acc = torch.zeros((), device=dev)
        for _ in range(n):
            state, m = step(state, data)
            acc = acc + m["loss"]
        return float(acc)

    t0 = time.time()
    run(1)
    print(f"build+first step: {time.time() - t0:.1f} s", file=sys.stderr)
    flops = step_flops(cfg, state, data, args["accum"], conv_kernel)
    times = []
    for _ in range(RUNS):
        synchronize(dev)
        t0 = time.perf_counter()
        loss = run(reps)
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    if not np.isfinite(loss):
        raise RuntimeError(f"training diverged: summed loss {loss}")
    best = min(times)
    from rcvpose_tpu_torch.scripts import card_line

    line = card_line() if card else "cpu"
    peak = bf16_peak(line) if card else None
    mfu = flops / (best / 1e3) / peak if peak and flops else None
    width = "small, width 0.125" if args["small"] else "full"
    record = {
        "metric": "train_step_ms", "value": round(best, 2),
        "imgs_per_sec": round(batch * 1e3 / best, 2), "batch": batch,
        "resolution": [h, w], "remat": args["remat"],
        "accum_steps": args["accum"],
        "tflops_per_step": flops / 1e12 if flops else None,
        "mfu_vs_bf16_peak": round(mfu, 3) if mfu is not None else None,
        "backend": dev.type,
        "model": (f"DenseFCNResNet152 ({width}, "
                  f"{cfg.compute_dtype} compute, f32 params)"),
        "conv_route": "K3/K4" if conv_kernel else "cuDNN",
        "runs_ms": times,
        "device": line,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
