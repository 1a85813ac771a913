"""K3 and K4 (bf16) at the decoder's training shapes, on the CUDA card:

    python -m rcvpose_tpu_torch.scripts.prof_conv [--old OLD.cu]
        [--promote 1,2,4,0] [--json OUT.json]

For each of the 18 entries of one batch-4 480x640 DenseFCNResNet152 step
(the six 3x3 decoder convs, each forward, dx and dk) prints the kernel's
device ms, TFLOP/s, share of its bound and its factor against the PyTorch
call for the same function (cuDNN's ``F.conv2d`` or the weight half of
``aten.convolution_backward``), with TF32 off. With ``--old`` it also
builds that source (an earlier ``csrc/mmconv.cu`` with the wmma entries'
C interface: ``vec_x, vec_k`` / ``vec_x, vec_g, slice, slices``) with the
same ``nvcc`` flags and times it in turns with the current kernels (old,
new, new, old; each number is the mean of its two turns). ``--promote``
re-runs K3 at conv_up5 (forward and dx) and at the long-reduction test
shape (2,15,20,2048,64,3) with other promotion intervals (stages between
IEEE adds, a stage being 3 taps x 64 channels; 0 = never: one
accumulator), printing the worst error in units
of the one-ulp check and the time. Every entry is also checked: K3 within
one bf16 ulp (plus 1e-5 of the output's scale) of ``conv_same_plain`` and
bit-identical over two runs, K4 within 1e-4 of its scale and bit-identical.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from rcvpose_tpu_torch.ops import _build, mmconv
from rcvpose_tpu_torch.scripts import card_line, device_ms
from rcvpose_tpu_torch.utils import resolve_device

BATCH = 4
DECODER = [("conv_up5", 15, 20, 3072, 1024), ("conv_up4", 30, 40, 2048, 512),
           ("conv_up3", 60, 80, 1024, 256), ("conv_up2", 120, 160, 512, 128),
           ("conv_up1", 240, 320, 192, 64), ("conv7", 480, 640, 64, 32)]
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PROMOTE_SHAPES = [("conv_up5", (BATCH, 15, 20, 3072, 1024)),
                  ("conv_up5 dx", (BATCH, 15, 20, 1024, 3072)),
                  ("long", (2, 15, 20, 2048, 64))]


def old_kernels(source):
    """(K3, K4) callables of an older mmconv.cu, built with the current
    flags (``_build.load_other``)."""
    lib = _build.load_other(source)
    fwd, dk = lib.conv_same_bf16, lib.conv_same_dk_bf16
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    dk.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = dk.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def conv(x, k):
        b, h, w, c = x.shape
        d = k.shape[3]
        out = torch.empty((b, h, w, d), dtype=x.dtype, device=x.device)
        _build.check(fwd(x.data_ptr(), k.data_ptr(), out.data_ptr(), b, h, w,
                         c, d, 3, 1, 1, stream()), "old conv_same_bf16")
        return out

    def conv_dk(x, g):
        b, h, w, c = x.shape
        d = g.shape[3]
        pixels = b * h * w
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        # the earlier wrapper's split (dk_slices)
        tiles = -(-c // 64) * -(-d // 64) * 9
        want = max(1, -(-(sms * 8) // tiles))
        cap = max(1, mmconv.SCRATCH_BYTES // (9 * c * d * 4))
        n = min(want, cap, max(1, -(-pixels // 32)), 65535)
        per = -(-(-(-pixels // n)) // 32) * 32
        n = -(-pixels // per)
        dkt = torch.empty((3, 3, c, d), dtype=torch.float32, device=x.device)
        part = dkt if n == 1 else torch.empty((n, 3, 3, c, d),
                                              dtype=torch.float32,
                                              device=x.device)
        _build.check(dk(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                        dkt.data_ptr(), b, h, w, c, d, 3, 1, 1, per, n,
                        stream()), "old conv_same_dk_bf16")
        return dkt

    return conv, conv_dk


def ulp_ratio(got, want):
    """Worst |got - want| over the one-ulp check's allowance (<= 1 passes)."""
    err = (got.float() - want.float()).abs()
    allow = (torch.finfo(torch.bfloat16).eps * want.float().abs()
             + 1e-5 * want.float().abs().max())
    return float((err / allow).max())


def check_k3(x, k, what):
    got = mmconv.conv_same_cuda(x, k)
    again = mmconv.conv_same_cuda(x, k)
    ratio = ulp_ratio(got, mmconv.conv_same_plain(x, k))
    if ratio > 1 or not torch.equal(got, again):
        raise AssertionError(f"K3 {what}: {ratio:.3f} of the one-ulp bound, "
                             f"repeats {torch.equal(got, again)}")
    return ratio


def check_k4(x, g, what):
    got = mmconv.conv_same_dk_cuda(x, g, 3)
    again = mmconv.conv_same_dk_cuda(x, g, 3)
    want = mmconv.conv_same_dk_plain(x, g, 3)
    rel = float((got - want).abs().max() / want.abs().max())
    if rel > 1e-4 or not torch.equal(got, again):
        raise AssertionError(f"K4 {what}: max err {rel:.3g} of scale, "
                             f"repeats {torch.equal(got, again)}")
    return rel


def entries(dev, seed=9):
    """The 18 entries: (conv, part, kernel fn, old-kernel args, cuDNN fn,
    flop, bytes, check fn)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, h, w, c, d in DECODER:
        b = BATCH
        x = torch.randn(b, h, w, c, device=dev, generator=g).bfloat16()
        kern = (torch.randn(3, 3, c, d, device=dev, generator=g)
                / (3 * c ** 0.5)).bfloat16()
        gy = torch.randn(b, h, w, d, device=dev, generator=g).bfloat16()
        kt = mmconv.rot_transpose(kern)
        flop = 2 * b * h * w * c * d * 9

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        w_f = kern.permute(3, 2, 0, 1).contiguous()
        w_t = kt.permute(3, 2, 0, 1).contiguous()
        yield (name, "fwd", lambda: mmconv.conv_same_cuda(x, kern),
               ("fwd", x, kern), lambda: F.conv2d(nchw(x), w_f, padding=1),
               flop, (x.numel() + kern.numel() + b * h * w * d) * 2,
               lambda: check_k3(x, kern, f"{name} fwd"))
        yield (name, "dx", lambda: mmconv.conv_same_cuda(gy, kt),
               ("fwd", gy, kt), lambda: F.conv2d(nchw(gy), w_t, padding=1),
               flop, (gy.numel() + kt.numel() + x.numel()) * 2,
               lambda: check_k3(gy, kt, f"{name} dx"))
        yield (name, "dk", lambda: mmconv.conv_same_dk_cuda(x, gy, 3),
               ("dk", x, gy),
               lambda: torch.ops.aten.convolution_backward(
                   nchw(gy), nchw(x), w_f, None, [1, 1], [1, 1], [1, 1],
                   False, [0, 0], 1, [False, True, False]),
               flop, (x.numel() + gy.numel()) * 2 + kern.numel() * 4,
               lambda: check_k4(x, gy, f"{name} dk"))


def run(old=None, promote=(), reps=10):
    dev = resolve_device(None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    olds = old_kernels(old) if old else None
    rows = []
    tot = {}
    for name, part, fn, oargs, lib, flop, nbytes, check in entries(dev):
        err = check()
        if olds:
            ofn = (lambda a=oargs: olds[0](a[1], a[2])) if oargs[0] == "fwd" \
                else (lambda a=oargs: olds[1](a[1], a[2]))
            o1 = device_ms(ofn, reps=reps, repeats=3)
            n1 = device_ms(fn, reps=reps, repeats=3)
            n2 = device_ms(fn, reps=reps, repeats=3)
            o2 = device_ms(ofn, reps=reps, repeats=3)
            ms, old_ms = (n1 + n2) / 2, (o1 + o2) / 2
        else:
            ms, old_ms = device_ms(fn, reps=reps, repeats=3), None
        lib_ms = device_ms(lib, reps=reps, repeats=3)
        bound = max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        row = dict(conv=name, part=part, ms=ms, old_ms=old_ms,
                   cudnn_ms=lib_ms, bound_ms=bound,
                   tflops=flop / ms / 1e9, share=bound / ms,
                   factor=ms / lib_ms, err=err)
        rows.append(row)
        k = "K4" if part == "dk" else "K3"
        t = tot.setdefault(k, dict(ms=0.0, old_ms=0.0, cudnn_ms=0.0,
                                   bound_ms=0.0))
        for key in t:
            t[key] += row[key] or 0.0
        print(f"{name} {part}: kernel {ms:.4f} ms"
              + (f" (old {old_ms:.4f}, {old_ms / ms:.2f}x)" if olds else "")
              + f", cuDNN {lib_ms:.4f}, bound {bound:.4f}; "
              f"{row['tflops']:.1f} TFLOP/s, {100 * row['share']:.1f}% of "
              f"bound, {row['factor']:.2f}x cuDNN; check {err:.3g}",
              flush=True)
    for k, t in tot.items():
        print(f"{k} per step: kernel {t['ms']:.3f} ms"
              + (f", old {t['old_ms']:.3f}" if olds else "")
              + f", cuDNN {t['cudnn_ms']:.3f} ({t['ms'] / t['cudnn_ms']:.2f}x)"
              f", bound {t['bound_ms']:.3f}", flush=True)
    sweep = []
    kept = mmconv.PROMOTE
    g = torch.Generator(device=dev).manual_seed(11)
    for what, (b, h, w, c, d) in PROMOTE_SHAPES if promote else ():
        x = torch.randn(b, h, w, c, device=dev, generator=g).bfloat16()
        kern = (torch.randn(3, 3, c, d, device=dev, generator=g)
                / (3 * c ** 0.5)).bfloat16()
        want = mmconv.conv_same_plain(x, kern)
        for p in promote:
            mmconv.PROMOTE = p if p > 0 else 1 << 30
            mmconv.plan_conv.cache_clear()
            try:
                ratio = ulp_ratio(mmconv.conv_same_cuda(x, kern), want)
                ms = device_ms(lambda: mmconv.conv_same_cuda(x, kern),
                               reps=reps, repeats=3)
            finally:
                mmconv.PROMOTE = kept
                mmconv.plan_conv.cache_clear()
            sweep.append(dict(shape=what, promote=p, ulp_ratio=ratio, ms=ms))
            print(f"promote {p} at {what} {(b, h, w, c, d)}: worst error "
                  f"{ratio:.3f} of the one-ulp bound, {ms:.4f} ms",
                  flush=True)
    return dict(card=card, rows=rows, totals=tot, promote=sweep)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--promote", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    promote = [int(p) for p in a.promote.split(",") if p]
    res = run(a.old, promote, a.reps)
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
