"""The vote counts K1 and K6 at the hier stages of serving and of the LM
evaluator, K2 (the head split) at the serving, fused and training shapes,
and K2's backward at the training shape, on the CUDA card:

    python -m rcvpose_tpu_torch.scripts.prof_vote [--old OLD_vote.cu]
        [--old-heads OLD_heads.cu] [--tiles] [--json OUT.json]

K1 and K6 (f32 and bf16 compare) run on ``hier_problem``'s stages (3
keypoints; serving: grid 128, topk 32; LM: grid 192, topk 64) with their
planners' splits, K1 at its default tile. K2 turns conv8's bf16
channels-last output into the f32 channel-major buffer at (1, 2, 480, 640)
(a serving net), (1, 6, 480, 640) (the fused net) and (4, 2, 480, 640)
(a training batch), and an f32 NCHW one at (1, 2, 480, 640); an empty
kernel (``torch.cuda._sleep(0)``) timed the same way gives the launch
floor. K2's backward turns the f32 (2, 4, 480, 640) cotangent into bf16
channels-last (training's layout) and into f32 NCHW. Each line gives the
device ms (CUDA events behind a spin kernel, median of repeats), the bound
and the share of it. The vote kernels' bound is the issue rate, 132 SMs x
4 sub-partitions x 32 lanes x 1.98 GHz = 33.45 T lane-instructions/s, at
``vote_cuda.INSTRUCTIONS_PER_PAIR`` (K1 11, K6 5.75; none an FMA); K2's
is its bytes (each element read once, written once as f32) over 3.35
TB/s, with the PyTorch call for the same relayout timed beside it.

``--old`` builds an earlier ``csrc/vote.cu`` (whose ``vote_counts_bf16``
takes no split: the C interface before K6's point split) with the same
``nvcc`` flags into the git-ignored ``_build/other/``, and times its K6 in
both compares in turns with the current one (old, new, new, old; each
number the mean of its two turns). ``--old-heads`` does the same for an
earlier ``csrc/heads.cu``'s forward (the C interface without a branch
argument). The card's copy of the repository has no ``.git``: write the
earlier source out first (``git show
REV:rcvpose_tpu_torch/csrc/vote.cu``) into a git-ignored directory.
``--tiles`` also sweeps K1's 36 tiles at the serving stages and prints the
fastest. Every kernel's result is checked against its plain version first
(exact counts, bit-identical relayout); a mismatch raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from rcvpose_tpu_torch.ops import _build, heads, vote_cuda
from rcvpose_tpu_torch.scripts import card_line, device_ms, hier_problem
from rcvpose_tpu_torch.utils import resolve_device

PEAK_BYTES_PER_S = 3.35e12
HIER = (("serving", 128, 32), ("lm", 192, 64))
K2_SHAPE = (2, 4, 480, 640)
# K2's forward: (what, shape, dtype, channels-last)
K2_FWD = (("serving", (1, 2, 480, 640), torch.bfloat16, True),
          ("fused", (1, 6, 480, 640), torch.bfloat16, True),
          ("training", (4, 2, 480, 640), torch.bfloat16, True),
          ("NCHW f32", (1, 2, 480, 640), torch.float32, False))
COMPARES = ("f32", "bf16")

_P = ctypes.c_void_p
_I = ctypes.c_int


def bound_ms(args, kernel):
    """The issue-rate bound of a vote kernel ("K1", "K6 f32", "K6 bf16")
    on ``args``, and the pairs."""
    vox, pts = args[0], args[1]
    pairs = pts.shape[0] * vox.shape[-2] * pts.shape[1]
    return (pairs * vote_cuda.INSTRUCTIONS_PER_PAIR[kernel]
            / vote_cuda.ISSUE_RATE * 1e3), pairs


def old_vote_bf16(source):
    """K6 of an earlier vote.cu (no split argument: one voxel a thread)."""
    fn = _build.load_other(source).vote_counts_bf16
    fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    fn.restype = _I

    def run(vox, pts, lo, hi, compare):
        vox, pts, lo, hi = (t.contiguous() for t in vote_cuda._bf16_operands(
            vox, pts, lo, hi, compare))
        b, n, _ = pts.shape
        v = vox.shape[-2]
        out = torch.empty((b, v), dtype=torch.float32, device=pts.device)
        err = fn(vox.data_ptr(), pts.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                 out.data_ptr(), int(vox.dim() == 2), b, v, n,
                 int(compare == "bf16"),
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "old vote_counts_bf16")
        return out

    return run


def old_heads_fwd(source):
    """K2's forward of an earlier heads.cu (one thread an output element,
    no branch argument)."""
    lib = _build.load_other(source)
    fns = {torch.float32: lib.heads_channel_major_f32,
           torch.bfloat16: lib.heads_channel_major_bf16}
    for fn in fns.values():
        fn.argtypes = [_P] * 2 + [_I] * 8 + [_P]
        fn.restype = _I

    def run(x):
        b, c, h, w = x.shape
        res = torch.empty((c, b, h, w), dtype=torch.float32, device=x.device)
        err = fns[x.dtype](x.data_ptr(), res.data_ptr(), b, c, h, w,
                           *x.stride(),
                           torch.cuda.current_stream().cuda_stream)
        _build.check(err, "old heads_channel_major")
        return res

    return run


def clocks_under_load(fn, calls=2000):
    """nvidia-smi's SM clock, the SM clock's maximum and the power draw,
    read while ``calls`` queued calls of ``fn`` run."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    for _ in range(calls):
        fn()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.cuda.synchronize()
    return line


def in_turns(new_fn, old_fn, reps, repeats):
    """(new ms, old ms): old, new, new, old, each the mean of its turns;
    old is None without ``old_fn``."""
    if old_fn is None:
        return device_ms(new_fn, reps, repeats), None
    o1 = device_ms(old_fn, reps, repeats)
    n1 = device_ms(new_fn, reps, repeats)
    n2 = device_ms(new_fn, reps, repeats)
    o2 = device_ms(old_fn, reps, repeats)
    return (n1 + n2) / 2, (o1 + o2) / 2


def _vote_kernels(old):
    """(name, bound key, kernel, plain, old kernel or None) of each timed
    vote kernel."""
    rows = [("K1", "K1", vote_cuda.vote_counts_cuda,
             vote_cuda.vote_counts_plain, None)]
    for c in COMPARES:
        rows.append((
            f"K6 {c}", f"K6 {c}",
            lambda *a, c=c: vote_cuda.vote_counts_bf16_cuda(*a, c),
            lambda *a, c=c: vote_cuda.vote_counts_bf16_plain(*a, c),
            old and (lambda *a, c=c: old(*a, c))))
    return rows


def vote_rows(dev, old, reps, repeats, say):
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cfg, grid_l, topk in HIER:
        stages = hier_problem(grid_l, topk, device=dev)
        for name, key, kern, plain, old_fn in _vote_kernels(old):
            frame = dict(ms=0.0, old_ms=0.0, bound_ms=0.0)
            for stage, args in stages.items():
                want = plain(*args)
                got = kern(*args)
                if not (torch.equal(got, want)
                        and torch.equal(kern(*args), got)):
                    raise AssertionError(f"{name} {cfg} {stage}: counts "
                                         f"differ from the plain version "
                                         f"or between runs")
                if old_fn is not None and not torch.equal(old_fn(*args),
                                                          want):
                    raise AssertionError(f"old {name} {cfg} {stage}: "
                                         f"counts differ")
                ms, old_ms = in_turns(lambda a=args: kern(*a),
                                      old_fn and (lambda a=args: old_fn(*a)),
                                      reps, repeats)
                bound, pairs = bound_ms(args, key)
                b, n = args[1].shape[:2]
                v = args[0].shape[-2]
                plan = (vote_cuda.plan_votes(b, v, n, vote_cuda.DEFAULT_TILE,
                                             sms) if name == "K1" else
                        vote_cuda.plan_votes(b, v, n, vote_cuda.K6_TILE, sms,
                                             "K6"))
                row = dict(kernel=name, cfg=cfg, stage=stage, pairs=pairs,
                           ms=ms, old_ms=old_ms, bound_ms=bound,
                           share=bound / ms, split=plan.split,
                           splits=plan.splits, blocks=plan.blocks)
                rows.append(row)
                for k in frame:
                    frame[k] += row[k] or 0.0
                if (name, cfg, stage) == ("K6 f32", "lm", "refine"):
                    row["clocks"] = clocks_under_load(lambda a=args: kern(*a))
                    say(f"{name} {cfg} {stage} under load: SM clock, its "
                        f"max, power draw: {row['clocks']}")
                say(f"{name} {cfg} {stage}: B={b} V={v} N={n} ({pairs} "
                    f"pairs; {plan.splits} splits of {plan.split} points, "
                    f"{plan.blocks} blocks): {ms:.4f} ms"
                    + (f" (old {old_ms:.4f}, {old_ms / ms:.2f}x)"
                       if old_fn else "")
                    + f", bound {bound:.4f} ({100 * bound / ms:.1f}%)")
            rows.append(dict(kernel=name, cfg=cfg, stage="frame",
                             share=frame["bound_ms"] / frame["ms"],
                             **{k: (v if old_fn or k != "old_ms" else None)
                                for k, v in frame.items()}))
            say(f"{name} {cfg} frame (coarse + refine): {frame['ms']:.4f} ms"
                + (f" (old {frame['old_ms']:.4f}, "
                   f"{frame['old_ms'] / frame['ms']:.2f}x)" if old_fn else "")
                + f", bound {frame['bound_ms']:.4f} "
                f"({100 * frame['bound_ms'] / frame['ms']:.1f}%)")
    return rows


def tile_sweep(dev, reps, repeats, say):
    """Every tile at the serving stages (coarse + refine a frame)."""
    stages = hier_problem(128, 32, device=dev)
    want = {k: vote_cuda.vote_counts_plain(*a) for k, a in stages.items()}
    times = {}
    for tile in vote_cuda.TILES:
        ms = 0.0
        for stage, args in stages.items():
            if not torch.equal(vote_cuda.vote_counts_cuda(*args, tile=tile),
                               want[stage]):
                raise AssertionError(f"tile {tile} {stage}: counts differ")
            ms += device_ms(lambda a=args, t=tile:
                            vote_cuda.vote_counts_cuda(*a, tile=t),
                            reps, repeats)
        times[tile] = ms
    ranked = sorted(times, key=times.get)
    for tile in ranked[:8]:
        say(f"tile {tile}: {times[tile]:.4f} ms a serving frame")
    say(f"best tile {ranked[0]} {times[ranked[0]]:.4f} ms; default "
        f"{vote_cuda.DEFAULT_TILE} {times[vote_cuda.DEFAULT_TILE]:.4f}; "
        f"slowest {ranked[-1]} {times[ranked[-1]]:.4f}")
    return {str(t): ms for t, ms in times.items()}


def heads_fwd_rows(dev, old, reps, repeats, say):
    """K2 at each of K2_FWD beside its library call, its byte bound, the
    empty-kernel floor and (``old``) the earlier kernel, in turns."""
    g = torch.Generator(device=dev).manual_seed(9)
    floor = device_ms(lambda: torch.cuda._sleep(0), reps, repeats)
    say(f"empty kernel (torch.cuda._sleep(0)): {floor:.5f} ms a launch")
    rows = [dict(kernel="empty", ms=floor)]
    for what, shape, dtype, cl in K2_FWD:
        x = torch.randn(*shape, device=dev, generator=g).to(dtype)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        want = heads.heads_channel_major_plain(x)
        if not (torch.equal(heads.heads_channel_major_cuda(x), want)):
            raise AssertionError(f"K2 {what}: not bit-exact")
        if old is not None and not torch.equal(old(x), want):
            raise AssertionError(f"old K2 {what}: differs")
        ms, old_ms = in_turns(lambda: heads.heads_channel_major_cuda(x),
                              old and (lambda: old(x)), reps, repeats)
        lib_ms = device_ms(lambda: x.float().permute(1, 0, 2, 3).contiguous(),
                           reps, repeats)
        nbytes = x.numel() * (x.element_size() + 4)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        branch = heads.fwd_branch(x)
        rows.append(dict(kernel="K2", what=what, shape=shape,
                         dtype=str(dtype)[6:], channels_last=cl,
                         branch=branch, ms=ms, old_ms=old_ms,
                         library_ms=lib_ms, bound_ms=bound, share=bound / ms,
                         floor_ms=floor))
        say(f"K2 {what} {shape} {str(dtype)[6:]} "
            f"{'channels-last' if cl else 'NCHW'} ({branch}): {ms:.5f} ms"
            + (f" (old {old_ms:.5f}, {old_ms / ms:.2f}x)" if old else "")
            + f", library {lib_ms:.5f} ({lib_ms / ms:.2f}x the kernel's "
            f"time), bound {bound:.5f} ({100 * bound / ms:.1f}%, {nbytes} "
            f"bytes), above the empty kernel {ms - floor:.5f}")
    return rows


def heads_bwd_rows(dev, reps, repeats, say):
    g = torch.Generator(device=dev).manual_seed(9)
    ct = torch.randn(*K2_SHAPE, device=dev, generator=g)
    rows = []
    for dtype, cl in ((torch.bfloat16, True), (torch.float32, False)):
        fmt = torch.channels_last if cl else torch.contiguous_format
        want = heads.heads_channel_major_bwd_plain(ct, dtype, cl)
        got = heads.heads_channel_major_bwd_cuda(ct, dtype, cl)
        if not (torch.equal(got, want) and got.stride() == want.stride()):
            raise AssertionError(f"K2 backward {dtype} cl={cl}: not bit-exact")
        ms = device_ms(
            lambda: heads.heads_channel_major_bwd_cuda(ct, dtype, cl), reps,
            repeats)
        # copy=True: .to() returns an f32 view as it is, without the copy
        lib_ms = device_ms(lambda: ct.permute(1, 0, 2, 3).to(
            dtype, memory_format=fmt, copy=True), reps, repeats)
        nbytes = ct.numel() * (4 + want.element_size())
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        branch = heads.bwd_branch(ct, cl)
        rows.append(dict(kernel="K2 backward", dtype=str(dtype)[6:],
                         channels_last=cl, branch=branch, ms=ms,
                         library_ms=lib_ms, bound_ms=bound,
                         share=bound / ms))
        say(f"K2 backward {K2_SHAPE} f32 -> {str(dtype)[6:]} "
            f"{'channels-last' if cl else 'NCHW'} ({branch}): {ms:.5f} ms, "
            f"library {lib_ms:.5f} ({lib_ms / ms:.2f}x the kernel's time), "
            f"bound {bound:.5f} ({100 * bound / ms:.1f}%, {nbytes} bytes)")
    return rows


def main(old=None, old_heads=None, tiles=False, reps=20, repeats=5,
         printer=print):
    """Time and check K1, K6, K2 and K2's backward (and, with ``old`` /
    ``old_heads``, the earlier sources' K6 / K2); returns ``{"card",
    "votes", "k2", "k2_bwd"[, "tiles"]}``."""
    say = printer
    dev = resolve_device(None)
    card = card_line()
    say(card)
    res = dict(card=card)
    res["votes"] = vote_rows(dev, old and old_vote_bf16(old), reps, repeats,
                             say)
    res["k2"] = heads_fwd_rows(dev, old_heads and old_heads_fwd(old_heads),
                               5 * reps, repeats, say)
    res["k2_bwd"] = heads_bwd_rows(dev, 5 * reps, repeats, say)
    if tiles:
        res["tiles"] = tile_sweep(dev, reps, repeats, say)
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--old-heads", type=Path, default=None)
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    a = ap.parse_args(argv)
    res = main(a.old, a.old_heads, a.tiles, a.reps,
               printer=lambda line: print(line, flush=True))
    if a.json:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    cli()
