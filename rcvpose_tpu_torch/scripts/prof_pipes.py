"""Issue rate of single instruction kinds on the CUDA card:

    python -m rcvpose_tpu_torch.scripts.prof_pipes

Builds ``scripts/pipes.cu`` (8 independent chains a thread of one
instruction: FFMA, FADD, the bf16x2 HFMA2 / HADD2 / HMUL2 of K6's d2, the
HSET2 of its band compare, LOP3, IADD) into the git-ignored
``_build/other/`` and prints, for each, lane-instructions a second and
their share of the vote kernels' issue rate (``vote_cuda.ISSUE_RATE``,
132 SMs x 4 sub-partitions x 32 lanes x 1.98 GHz): what the card sustains
for that kind alone, the ceiling of an instruction mix that leans on it.
Times are CUDA events behind a spin kernel (``scripts.device_ms``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from rcvpose_tpu_torch.ops import _build, vote_cuda
from rcvpose_tpu_torch.scripts import card_line, device_ms
from rcvpose_tpu_torch.utils import resolve_device

KINDS = ("FFMA f32", "FADD f32", "HFMA2 bf16x2", "HADD2 bf16x2",
         "HMUL2 bf16x2", "HSET2 bf16x2 (u32 masks)", "LOP3", "IADD")
ITERS = 4096


def main(reps=3, repeats=5, printer=print):
    """Returns ``{"card", "rates": {kind: share of the issue rate}}``."""
    dev = resolve_device(None)
    fn = _build.load_other(Path(__file__).with_name("pipes.cu")).run_pipe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(256, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = 8 * sms
    res = {"card": card_line(), "rates": {}}
    printer(res["card"])
    for op, kind in enumerate(KINDS):
        def run(op=op, kind=kind):
            err = fn(op, out.data_ptr(), blocks, ITERS,
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, kind)
        ms = device_ms(run, reps, repeats)
        rate = blocks * 256 * ITERS * 8 / (ms * 1e-3)
        res["rates"][kind] = rate / vote_cuda.ISSUE_RATE
        printer(f"{kind}: {ms:.4f} ms, {rate / 1e12:.2f} T "
                f"lane-instructions/s = {rate / vote_cuda.ISSUE_RATE:.3f} of "
                f"the issue rate")
    return res


if __name__ == "__main__":
    main()
