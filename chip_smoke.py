#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``rcvpose_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line:

1. build the kernels from ``rcvpose_tpu_torch/csrc`` with nvcc (into the
   git-ignored ``rcvpose_tpu_torch/_build``), print the card's name and
   power limit and whether PIL imports, and read the vote kernels' SASS
   (``cuobjdump``): each pair loop's instructions a pair (K1, K5, and K6's
   packed loop in both compares), no FFMA in K1 or K5, no local memory;
2. K1 (vote counts) against its plain version at the serving shapes, exact
   equality, repeatable bit for bit, also at each branch of its split
   planner (one split, several, ragged N, shared voxels);
3. K2 (head split) and its backward against their plain versions, bit
   for bit, at every layout (2K = 2 and 6, f32 and bf16, NCHW and
   channels-last, contiguous, W % 8 != 0, misaligned and strided inputs
   and cotangents: each branch of both);
4. the frame program on perfect synthetic maps at 480x640, on the card and
   on the CPU through the plain versions;
5. serving at full width (DenseFCNResNet152, bf16, 480x640, grid 128, 8192
   points, hier): ``PoseEstimator.estimate`` on a few frames in 3-net and in
   fused mode, with both kernels' launch counters reset just before and
   read just after, then a profiler view of where a frame's time goes;
6. the device time of each kernel (CUDA events behind a spin kernel), its
   plain version and its bound, at the shapes of phases 2 and 3, K2 also
   at the fused and training shapes beside an empty kernel's time (after
   serving, so that no profiler has run before the serving times are
   taken);
7. K3 (decoder conv, forward and dx) and K4 (its weight gradient)
   against their plain versions at the six DenseFCN decoder shapes of a
   batch-4 480x640 step, in bf16 and f32, each also bit-identical over two
   runs; then in bf16 at one shape for each branch of the conv planner
   (split-K, two N = 96 tiles, 32-channel chunks, K4 at 9 and 3 taps,
   padded channels, a misaligned base, K = 5); and K2 and its backward at
   every layout of phase 3, at batch 4;
8. training at full width (DenseFCNResNet152, ``Config`` defaults: bf16,
   Adam, batch 4, 480x640) on batches that ``labels.make_sample`` makes on
   the card from rendered frames: one f32 step (TF32 off) with the decoder
   convs on K3/K4 against the cuDNN route, both held against the cuDNN
   route in f64, then ``Trainer.fit`` on each
   route with a checkpoint, a validation, a restore and one served frame
   from the restored weights, the launch counts of a step, and a profile;
9. the device time of K3, K4 and K2's backward at the training shapes,
   beside their plain versions, their bounds and the cuDNN (or PyTorch)
   call for the same function (per conv entry also TFLOP/s, the share of
   the bound and the factor against cuDNN);
10. K5 (matmul-form votes), K6 (bf16 votes, f32 and bf16 compare, also
    at each branch of its split planner, repeatable bit for bit) and
    every K1 tile against their plain versions, exactly, at the hier
    stages' shapes of serving (grid 128) and of the LM evaluator (grid
    192) on the synthetic frame of phase 4; K5 against K1 within the
    matmul form's band-edge rounding; then their paths, with the counts
    set to 0 just before: ``voting.vote_counts(mxu=True)`` over those
    stages and the ``rcvpose_tpu_torch.scripts`` entry points
    ``prof_vote_tiles`` and ``prof_vote_bf16``;
11. the LINEMOD evaluator ``eval.estimate_6d_pose_lm`` at full width
    (DenseFCNResNet152, bf16, 480x640, grid 192, 8192 points, topk 64,
    30 ICP iterations) on a rendered LINEMOD-layout tree: 3-net
    ``.pth.tar`` checkpoints with calibrated heads (K2 and K1 counted) and
    the precomputed-map route, which must score ADD 1.0 before and after
    ICP; then the ICP's device time;
12. the device time of K5, K6 and K1 at the sweep's best tile at the
    phase-10 shapes, beside their plain versions and bounds, and of K6 in
    both compares at each of its split branches (CUDA events);
13. in phase 11's tree and with its nets: the Occlusion-LINEMOD evaluator
    ``estimate_6d_pose_lmo`` on both routes (a frame without a pose
    skipped; ADD 1.0 before and after ICP on the precomputed maps), the
    YCB-Video evaluator ``estimate_6d_pose_ycb`` on a rendered 480x640
    YCB-layout tree (YCB-Video's camera-1 intrinsics, depth at 1/10000
    m) through the nets and through exact maps (AUC before ICP >= 0.8, no
    lower after; the converged ICP's updates a frame and its device time
    beside the LM's 30 iterations), the RGB-only keypoint at its defaults
    against the truth and the CPU, ``PoseEstimator.refine`` on phase 4's
    frame and ``radial_labels_from_cad`` on the card against the CPU;
    K1's and K2's launches on each path;
14. the training-from-disk path through ``cli.main`` at full width, in a
    temporary LINEMOD training-layout tree (16 rendered frames at 480x640:
    JPEG, ``.dpt``, mask PNGs, poses, mm ``mesh.ply``): ``check-data``
    with no ERROR, ``gen-labels`` on the card against the CPU's
    ``labels.radial_labels`` (1e-5 dm), ``--mode train`` (batch 4, bf16
    Adam, cuDNN route) for 8 steps and ``--resume_train`` to 10 (ms/step,
    images/s, the loader's wait a batch, K2 launches), the loader alone
    (frames/s, which ``.dpt`` reader), ``export-torch`` and one frame
    served from the exported weights (K1, K2), the K3/K4 route
    (``RCVPOSE_PALLAS_CONV=on``) for 3 steps, one f32 step with
    ``--remat`` against one without (loss and BN statistics equal bit for
    bit, gradients within twice the plain step's run-to-run spread; peak
    memory and ms/step of each in bf16), and the YCB
    precomputed route for 2 steps from an HDF5 the script carries, read
    by the port's own reader, under ``--profile_dir``;
15. what crosses processes, devices and a socket, at full width in phase
    11's LINEMOD tree and phase 14's training tree:
    ``parallel.sharded_vote_counts`` at phase 2's stages in an NCCL world
    of one and over two gloo ranks on the one card (spawned by
    ``parallel.run_ranks``), bit-equal to the unsharded K1 call; in those
    two ranks one global-batch f32 step (batch 2 each) against one
    process at batch 4 (loss, ``loss_r``, ``acc`` and the BN running
    statistics), ``cli.main --mode train --distributed`` (3 steps, one
    ``best_val`` and one pair of checkpoints) and ``--mode test
    --distributed`` (each rank sweeps its shard; the results file equals
    one process's); ``parallel.sharded_frame_scores`` on a 4-frame chunk
    over a one-card mesh on both routes against the sequential
    evaluator's per-frame scores (ADD 1.0 on the maps), and
    ``eval_data_parallel=True`` raising on one card; ``PoseServer`` on
    the card with two concurrent ``PoseClient``s, their replies against a
    direct ``estimate``/``refine``, a malformed request, and K1's and
    K2's launches on each path.

The vote kernels' bounds count instructions at the card's issue rate
(``vote_cuda.ISSUE_RATE``), not FLOPs at the FP32 peak: none of their
operations is an FMA.

Then a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line; without a CUDA card it exits 1 at once. Weights are seeded random
(no checkpoint ships with the repository).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): dense bf16
# tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

GRID_L = 128
N_POINTS = 8192
H, W = 480, 640
DEVICE = "cuda"
# The 3x3 decoder convs of DenseFCNResNet152 in a batch-4 480x640 step:
# (name, H, W, C in, D out).
TRAIN_BATCH = 4
DECODER = [("conv_up5", 15, 20, 3072, 1024), ("conv_up4", 30, 40, 2048, 512),
           ("conv_up3", 60, 80, 1024, 256), ("conv_up2", 120, 160, 512, 128),
           ("conv_up1", 240, 320, 192, 64), ("conv7", 480, 640, 64, 32)]
TRAIN_STEPS = 10
# bf16 shapes (B, H, W, C, D, K) that take each branch of the conv planner
# (ops/mmconv.py plan_conv), checked in phase 7 beside the decoder's own
PLAN_BRANCHES = [((1, 15, 20, 3072, 256, 3), "split-K"),
                 ((2, 24, 40, 64, 192, 3), "dx N = 96 x 2"),
                 ((2, 24, 40, 32, 64, 3), "32-channel chunks"),
                 ((2, 40, 48, 64, 32, 3), "K4 9 taps"),
                 ((2, 24, 40, 192, 64, 3), "K4 3 taps"),
                 ((2, 17, 23, 5, 7, 3), "padded channels"),
                 ((2, 15, 20, 64, 32, 3), "misaligned"),
                 ((1, 33, 47, 64, 32, 5), "K = 5")]


def say(*parts):
    print(*parts, flush=True)


def profile_ms(fn, reps, warmup=1):
    """Times of one call of ``fn``, from ``reps`` calls under torch.profiler.

    Returns (wall ms on the host clock, ending in a synchronize, with the
    profiler on; device ms, the summed durations of the kernels and copies
    the calls ran, without the idle gaps between them; device ms by kernel
    name). Only the device's own events are summed: a CPU op's
    ``self_device_time_total`` repeats the time of the kernels it launched,
    and a user annotation on the device's timeline (the optimizer's
    ``Optimizer.step#...`` span) covers kernels that are summed already.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    by_kernel = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.device_time_total / 1e3 / reps)
    return wall_ms, sum(by_kernel.values()), by_kernel


def event_ms(fn, reps, warmup=2, repeats=3):
    """Device ms of one call of ``fn`` by CUDA events: ``scripts.device_ms``
    (the median of ``repeats`` runs of ``reps`` back-to-back calls queued
    behind a ~25 ms spin kernel)."""
    from rcvpose_tpu_torch.scripts import device_ms

    return device_ms(fn, reps, repeats, warmup)


def card_line():
    from rcvpose_tpu_torch.scripts import card_line as line

    return line()


def random_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    r = np.array([
        [1 - 2*(y*y + z*z), 2*(x*y - w*z), 2*(x*z + w*y)],
        [2*(x*y + w*z), 1 - 2*(x*x + z*z), 2*(y*z - w*x)],
        [2*(x*z - w*y), 2*(y*z + w*x), 1 - 2*(x*x + y*y)],
    ])
    t = rng.normal(size=3) * 0.1 + np.array([0, 0, 0.8])
    return np.concatenate([r, t[:, None]], axis=1)


def render_synthetic_frame(rng, k):
    """A 3-4 cm thick-shell object at a random pose, its depth map (mm),
    perfect radial maps (dm) for three keypoints and the object's points
    (m): (pose, keypoints, depth, radials, model)."""
    pose = random_pose(rng)
    dirs = rng.normal(size=(4000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    model_m = dirs * rng.uniform(0.03, 0.04, size=(4000, 1))
    kpts_m = np.array([[0.08, 0.08, 0.08], [-0.08, 0.08, -0.08],
                       [0.08, -0.08, -0.08]])
    cam_m = model_m @ pose[:3, :3].T + pose[:3, 3]
    uv = cam_m @ k.T
    uv = uv[:, :2] / uv[:, 2:]
    us = np.round(uv[:, 0]).astype(int)
    vs = np.round(uv[:, 1]).astype(int)
    ok = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    depth_mm = np.zeros((H, W), np.float32)
    depth_mm[vs[ok], us[ok]] = cam_m[ok, 2] * 1000.0
    z = depth_mm.astype(np.float64)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    xyz_m = np.stack([(uu - k[0, 2]) * z / k[0, 0],
                      (vv - k[1, 2]) * z / k[1, 1], z], axis=-1) / 1000.0
    kpts_cam = kpts_m @ pose[:3, :3].T + pose[:3, 3]
    radials = np.stack([
        np.where(depth_mm > 0, np.linalg.norm(xyz_m - kc, axis=-1) * 10.0,
                 0.0) for kc in kpts_cam]).astype(np.float32)
    return pose, kpts_m, depth_mm, radials, model_m


def sass_functions(lib):
    """``cuobjdump -sass`` of a built library: {function: (instructions
    [(address, text)], labels {name: address})}."""
    import re
    from pathlib import Path

    from rcvpose_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                cur[1][label] = addr
            pending = []
            cur[0].append((addr, m.group(2)))
    return funcs


def opcode(ins):
    """The opcode of a SASS instruction without its predicate and
    modifiers (``@!P0 IADD3.X R1, ...`` -> ``IADD3``)."""
    parts = ins.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0].split(".")[0] if parts else ""


def inner_loop(instrs, labels, pair_ops, per_pair):
    """Of the innermost loops (backward branches whose body holds no other
    backward branch), the one with the most ``pair_ops`` instructions (the
    unrolled pair loop), ``per_pair`` of them a pair: (instructions in the
    body, pairs it evaluates, opcode histogram), or None if there is
    none."""
    import re

    loops = []
    for addr, ins in instrs:
        if opcode(ins) != "BRA":
            continue
        m = re.search(r"`\((\.L_x_\d+)\)", ins)
        target = labels.get(m.group(1)) if m else None
        if target is None:
            m = re.search(r"\b0x([0-9a-f]+)\b", ins)
            target = int(m.group(1), 16) if m else None
        if target is not None and target <= addr:
            loops.append((target, addr))
    best = None
    for target, addr in loops:
        if any(target <= t and a < addr for t, a in loops):
            continue
        body = [opcode(i) for a, i in instrs if target <= a <= addr]
        muls = sum(op in pair_ops for op in body)
        if muls and (best is None or (muls, -len(body)) > best[0]):
            best = ((muls, -len(body)), body)
    if best is None:
        return None
    body = best[1]
    hist = {}
    for op in body:
        hist[op] = hist.get(op, 0) + 1
    return len(body), best[0][0] / per_pair, hist


def check_vote_sass(vote_cuda):
    """The vote kernels' compiled inner loops: instructions a pair beside
    the bound's count. Fails if a K1 tile or K5 contracts into an FMA, or
    any vote kernel touches local memory. Returns {kernel: per pair}."""
    from rcvpose_tpu_torch.ops import _build

    funcs = sass_functions(_build.library_path("vote"))
    t, v, c = vote_cuda.DEFAULT_TILE
    # (function, the d2 instructions, how many of them a pair, the bound's
    # count): 3 FMUL a pair in f32; in bf16x2 the 8 sub / mul / add of two
    # pairs, each an HADD2, HMUL2 or HFMA2 (ptxas writes some as FMAs with
    # an exact 1 or -0 operand), 4 a pair
    f32, bf16 = ("FMUL",), ("HADD2", "HMUL2", "HFMA2")
    ipp = vote_cuda.INSTRUCTIONS_PER_PAIR
    targets = {
        f"K1 {vote_cuda.DEFAULT_TILE}": (f"vote_counts_kernelILi{t}ELi{v}ELi"
                                         f"{c}E", f32, 3, ipp["K1"]),
        "K5": ("vote_counts_mxu_kernel", f32, 3, ipp["K5"]),
        "K6 f32 compare": ("vote_counts_bf16_kernelILb0E", bf16, 4,
                           ipp["K6 f32"]),
        "K6 bf16 compare": ("vote_counts_bf16_kernelILb1E", bf16, 4,
                            ipp["K6 bf16"])}
    k1_names = [n for n in funcs if "vote_counts_kernel" in n]
    if len(k1_names) != len(vote_cuda.TILES):
        raise AssertionError(f"SASS: {len(k1_names)} K1 instances, "
                             f"expected {len(vote_cuda.TILES)}")
    for name, (instrs, _) in funcs.items():
        ops = {opcode(i) for _, i in instrs}
        if ops & {"LDL", "STL"}:
            raise AssertionError(f"SASS {name}: local memory")
        if ("vote_counts_kernel" in name or "mxu" in name) and "FFMA" in ops:
            raise AssertionError(f"SASS {name}: an FFMA (contracted d2)")
    result = {}
    for what, (key, pair_ops, per_pair, ops) in targets.items():
        name = next(n for n in funcs if key in n)
        loop = inner_loop(*funcs[name], pair_ops, per_pair)
        if loop is None:
            raise AssertionError(f"SASS {what}: no pair loop found")
        n, pairs, hist = loop
        result[what] = n / pairs
        top = sorted(hist.items(), key=lambda kv: -kv[1])
        say(f"phase 1 SASS {what}: pair loop of {n} instructions for "
            f"{pairs:g} pairs = {n / pairs:.3f} a pair (bound counts {ops}); "
            + ", ".join(f"{op} {k / pairs:.3f}" for op, k in top))
    say(f"phase 1 SASS: no FFMA in the {len(k1_names)} K1 tiles or K5, no "
        f"local memory in any vote kernel")
    return result


def phase_build(vote_cuda):
    from rcvpose_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    say(f"phase 1 build: {sorted(_build.SOURCES)} built in {secs:.2f} s "
        f"({len(logs)} compiled now)")
    say(card_line())
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports"
    except ImportError as exc:
        PIL, pil = None, f"PIL does not import ({exc})"
    say(f"phase 1 {pil}")
    return check_vote_sass(vote_cuda)


def phase_vote(voting, vote_cuda):
    """K1 against its plain version at the serving shapes, exact and
    bit-identical over two runs, then at each branch of the split planner;
    returns ``{stage: (kernel arguments, max |kernel - plain|)}``."""
    from rcvpose_tpu_torch.scripts import hier_problem

    dev = torch.device(DEVICE)
    stages = hier_problem(GRID_L, voting._TOPK, n_points=N_POINTS,
                          device=dev)
    stages["exact64"] = (voting.enumerate_grid(64, dev), *stages["refine"][1:])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, args in stages.items():
        got = vote_cuda.vote_counts_cuda(*args)
        again = vote_cuda.vote_counts_cuda(*args)
        want = vote_cuda.vote_counts_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (torch.equal(got, want) and torch.equal(again, got)):
            raise AssertionError(f"K1 {name}: counts differ from the plain "
                                 f"version (max |diff| {err}) or between "
                                 f"runs")
        out[name] = (args, err)
        plan = vote_cuda.plan_votes(args[1].shape[0], args[0].shape[-2],
                                    args[1].shape[1], vote_cuda.DEFAULT_TILE,
                                    sms)
        say(f"phase 2 K1 {name}: B=3 V={args[0].shape[-2]} "
            f"N={args[1].shape[1]} counts equal, repeat bit for bit (max "
            f"votes {got.max():.0f}; {plan.splits} splits of {plan.split} "
            f"points, {plan.blocks_per_sm:.2f} blocks an SM)")
    for name in ("coarse", "refine"):
        check_k1_splits(vote_cuda, name, stages[name], out)
    return out


def split_cases(args):
    """A stage's split branches, {what: (arguments, split)}: the planner's
    own, one split (stores, no atomics), 2 and 7 splits, splits of 32
    points, a split that is neither a multiple of the chunk nor of 4; also
    N = 37 short of a chunk multiple (planned) and, for per-keypoint voxels,
    the first keypoint's voxels shared by the batch (planned)."""
    vox, pts, lo, hi = args
    n = pts.shape[1]
    cut = n - 37
    cases = {"planner": (args, None), "one split": (args, n),
             "2 splits": (args, -(-n // 2)), "7 splits": (args, -(-n // 7)),
             "splits of 32": (args, 32), "splits of 1001": (args, 1001),
             f"N={cut}": ((vox, pts[:, :cut], lo[:, :cut], hi[:, :cut]),
                          None)}
    if vox.dim() == 3:
        cases["shared voxels"] = ((vox[0], pts, lo, hi), None)
    return cases


def check_splits(kernel, plain, what, args):
    """``kernel(*a, split=s)`` at each of ``split_cases(args)`` against
    ``plain(*a)``: exact and bit-identical over two runs. Returns the max
    |kernel - plain| (0 when exact)."""
    wants, worst = {}, 0.0
    for case, (a, split) in split_cases(args).items():
        key = id(a)
        if key not in wants:
            wants[key] = plain(*a)
        got = kernel(*a, split=split)
        again = kernel(*a, split=split)
        torch.cuda.synchronize()
        err = float((got - wants[key]).abs().max())
        worst = max(worst, err)
        if not (torch.equal(got, wants[key]) and torch.equal(again, got)):
            raise AssertionError(f"{what} {case}: differs from the plain "
                                 f"version (max |diff| {err}) or between "
                                 f"runs")
    return worst


def check_k1_splits(vote_cuda, name, args, out):
    """K1 at one serving stage through each branch of the split planner
    (``split_cases``), each exact and bit-identical over two runs; folds
    the errors into ``out``."""
    err = check_splits(vote_cuda.vote_counts_cuda, vote_cuda.vote_counts_plain,
                       f"K1 {name}", args)
    out[name] = (out[name][0], max(out[name][1], err))
    say(f"phase 2 K1 {name} split branches "
        f"({', '.join(split_cases(args))}): each equal to the plain "
        f"version, repeat bit for bit")


# K2's inputs (conv8's output) and its backward's cotangents: contiguous
# (NCHW or channels-last; the cotangent's training layout), a width that
# is not a multiple of 8, a contiguous view one element (the cotangent: 4
# bytes) past a 16-byte boundary, and a strided view (the generic branch)
LAYOUTS = ("contiguous", "W % 8 != 0", "misaligned", "strided")


def heads_input(kind, b, c, dtype, channels_last, gen):
    """conv8's output (b, c, H, w) laid out as ``kind`` of LAYOUTS, NCHW or
    channels-last underneath."""
    dev = torch.device(DEVICE)
    w = W - 3 if kind == "W % 8 != 0" else W
    shape = (b, H, w, c) if channels_last else (b, c, H, w)
    to_bchw = (0, 3, 1, 2) if channels_last else (0, 1, 2, 3)
    if kind == "misaligned":
        x = torch.randn(b * c * H * w + 1, device=dev, generator=gen).to(
            dtype)[1:].view(shape)
    elif kind == "strided":
        x = torch.randn(*shape[:-2], shape[-1], shape[-2], device=dev,
                        generator=gen).to(dtype).transpose(-1, -2)
    else:
        x = torch.randn(*shape, device=dev, generator=gen).to(dtype)
    return x.permute(*to_bchw)


def check_heads_fwd(heads, b, gen, phase):
    """K2 against its plain version, bit for bit and over two runs, for
    2K = 2 and 6, f32 and bf16, NCHW and channels-last, at each of LAYOUTS
    at (b, 2K, H, W). Returns the max |kernel - plain| (0 when
    bit-exact)."""
    err, branches = 0.0, {}
    for c in (2, 6):
        for kind in LAYOUTS:
            for dtype in (torch.float32, torch.bfloat16):
                for cl in (False, True):
                    x = heads_input(kind, b, c, dtype, cl, gen)
                    got = heads.heads_channel_major_cuda(x)
                    again = heads.heads_channel_major_cuda(x)
                    want = heads.heads_channel_major_plain(x)
                    torch.cuda.synchronize()
                    err = max(err, float((got - want).abs().max()))
                    if not (torch.equal(got, want)
                            and torch.equal(again, got)):
                        raise AssertionError(
                            f"K2 {tuple(x.shape)} {kind} {str(dtype)[6:]} "
                            f"channels_last={cl}: not bit-exact")
                    branches.setdefault(heads.fwd_branch(x), []).append(
                        f"{c}/{kind}/{str(dtype)[6:]}/{'cl' if cl else 'nchw'}")
    say(f"{phase} K2 at B={b}: {sum(map(len, branches.values()))} layouts "
        f"bit-exact, repeat bit for bit; by branch "
        + "; ".join(f"{k} {len(v)}" for k, v in sorted(branches.items())))
    return err


def phase_heads(heads):
    """K2 and its backward against their plain versions, bit for bit, at
    every layout; returns the serving-shape input (one net's conv8 output,
    bf16, channels-last) and K2's max |kernel - plain|."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)
    err = check_heads_fwd(heads, 1, g, "phase 3")
    serving = torch.randn(1, 2, H, W, device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    if not torch.equal(heads.heads_channel_major_cuda(serving),
                       heads.heads_channel_major_plain(serving)):
        raise AssertionError("K2 at the serving shape: not bit-exact")
    check_heads_bwd(heads, 1, g, "phase 3")
    return serving, err


def check_heads_bwd(heads, b, gen, phase):
    """K2's backward against its plain version, bit for bit and over two
    runs, for 2K = 2 and 6, f32 and bf16, NCHW and channels-last, from each
    of LAYOUTS at (2K, b, H, W). Returns the max |kernel - plain|
    (0 when bit-exact)."""
    dev = torch.device(DEVICE)
    err, branches = 0.0, {}
    for c in (2, 6):
        for kind in LAYOUTS:
            w = W - 3 if kind == "W % 8 != 0" else W
            if kind == "misaligned":
                ct = torch.randn(c * b * H * w + 1, device=dev,
                                 generator=gen)[1:].view(c, b, H, w)
            elif kind == "strided":
                ct = torch.randn(c, b, w, H, device=dev,
                                 generator=gen).transpose(2, 3)
            else:
                ct = torch.randn(c, b, H, w, device=dev, generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                for cl in (False, True):
                    got = heads.heads_channel_major_bwd_cuda(ct, dtype, cl)
                    again = heads.heads_channel_major_bwd_cuda(ct, dtype, cl)
                    want = heads.heads_channel_major_bwd_plain(ct, dtype, cl)
                    torch.cuda.synchronize()
                    err = max(err, float((got.float() - want.float())
                                         .abs().max()))
                    what = (f"K2 backward ({b},{c},{H},{w}) {kind} "
                            f"{str(dtype)[6:]} channels_last={cl}")
                    if not (got.stride() == want.stride()
                            and torch.equal(got, want)
                            and torch.equal(again, got)):
                        raise AssertionError(f"{what}: not bit-exact")
                    branches.setdefault(heads.bwd_branch(ct, cl), []).append(
                        f"{c}/{kind}/{str(dtype)[6:]}/{'cl' if cl else 'nchw'}")
    say(f"{phase} K2 backward at B={b}: {sum(map(len, branches.values()))} "
        f"layouts bit-exact, repeat bit for bit; by branch "
        + "; ".join(f"{k} {len(v)}" for k, v in sorted(branches.items())))
    return err


def phase_frame(infer, geometry):
    """The frame program on perfect maps: card against CPU plain path, and
    the card's pose against the truth."""
    rng = np.random.default_rng(0)
    k = geometry.LINEMOD_K
    pose, kpts_m, depth_mm, radials, _ = render_synthetic_frame(rng, k)
    sem = (radials > 0).astype(np.float32)
    results = {}
    for dev in (DEVICE, "cpu"):
        def t(x, dev=dev):
            return torch.tensor(np.asarray(x), dtype=torch.float32,
                                device=dev)
        results[dev] = infer._pose_from_maps(
            t(sem), t(radials), t(depth_mm), t(k), t([100.0] * 3),
            t(kpts_m * 1000.0), 0.5, N_POINTS, GRID_L, "hier", False)
    card, cpu = results[DEVICE], results["cpu"]
    dc = float((card["centers"].cpu() - cpu["centers"]).abs().max())
    if dc > 1e-2:
        raise AssertionError(f"frame: card centers differ from CPU by {dc} mm")
    if not torch.equal(card["escalate"].cpu(), cpu["escalate"]):
        raise AssertionError("frame: escalate vectors differ")
    rt = card["rt"].cpu().numpy()
    r_err = float(np.abs(rt[:3, :3] - pose[:3, :3]).max())
    t_err = float(np.linalg.norm(rt[:3, 3] - pose[:3, 3] * 1000.0))
    if not (r_err < 0.15 and t_err < 25.0):
        raise AssertionError(f"frame: pose off (R {r_err}, t {t_err} mm)")
    say(f"phase 4 frame on perfect maps: centers card vs CPU max |diff| "
        f"{dc:.2e} mm, escalate {card['escalate'].cpu().tolist()}, "
        f"R err {r_err:.4f}, t err {t_err:.2f} mm, counts "
        f"{card['counts'].cpu().tolist()}")


def calibrate_head(net, frame, sem_threshold, max_radius_dm):
    """Rescale conv8 of a random net so that its maps look like a trained
    net's over the object patch of ``frame``: seg logits with unit spread
    centered on the sem threshold, radii with 0.25 dm spread centered on
    half the radius clip. Without this, random heads give masks that are
    all or nothing and the vote stage sees no points."""
    from rcvpose_tpu_torch import labels

    img, depth = frame
    dev = net.conv8.weight.device
    with torch.no_grad():
        seg, rad = net(labels.normalize_image(
            torch.tensor(img, device=dev))[None])
        used = torch.tensor(depth > 0, device=dev)
        k = seg.shape[-1]
        for j, vals, center, spread in (
                [(j, seg[0][used][:, j], sem_threshold, 1.0)
                 for j in range(k)]
                + [(k + j, rad[0][used][:, j], max_radius_dm / 2, 0.25)
                   for j in range(k)]):
            scale = spread / max(float(vals.std()), 1e-12)
            shift = center - float(vals.median()) * scale
            w = net.conv8.weight
            w[j] = (w[j].float() * scale).to(w.dtype)
            b = net.conv8.bias
            b[j] = (b[j].float() * scale + shift).to(b.dtype)


def serve(est, frames):
    """``est.estimate`` on each frame: host ms per frame (ending in a
    synchronize) and the results."""
    times, outs = [], []
    for img, depth in frames:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(est.estimate(img, depth))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times, outs


def breakdown(est3, estf, frames, infer):
    """Where a frame's time goes: one net forward and the frame program
    after the nets, then whole frames, each as host wall time (profiler on)
    against device-busy time, with the costliest kernels."""
    from rcvpose_tpu_torch import labels

    img, depth = frames[-1]
    x = labels.normalize_image(torch.tensor(img, device=DEVICE))[None]
    dep = torch.tensor(depth, device=DEVICE)
    kw = est3._frame_kwargs(False, est3.cfg.max_points)
    with torch.inference_mode():
        maps = [m(x) for m in est3.models]
        sem = torch.stack([seg[0, :, :, 0] for seg, _ in maps])
        rad = torch.stack([r[0, :, :, 0] for _, r in maps])

        def post():
            return infer._pose_from_maps(sem, rad, dep, est3.k,
                                         est3.max_radii, est3.gt_kpts_mm,
                                         **kw)
        stages = {
            "one net forward": profile_ms(lambda: est3.models[0](x), 10),
            "frame program after the nets (_pose_from_maps, 3 keypoints)":
                profile_ms(post, 10)}
    for name, est in (("3-net frame", est3), ("fused frame", estf)):
        stages[name] = profile_ms(lambda e=est: e.estimate(img, depth), 3)
    for name, (wall, dev, by_kernel) in stages.items():
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        say(f"phase 5 profile {name}: wall {wall:.3f} ms (profiler on), "
            f"device busy {dev:.3f} ms ({dev / wall:.1%}); top kernels ms: "
            + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top))


def phase_serving(infer, train_mod, fcn, voting, config, vote_cuda, heads):
    """Full-width serving, 3-net then fused; the kernels' launch counts over
    exactly this run."""
    cfg3 = config.Config(vote_grid_l=voting.suggest_grid_l(0.102, 2.0))
    assert cfg3.vote_grid_l == GRID_L and cfg3.max_points == N_POINTS
    cfgf = config.Config(vote_grid_l=cfg3.vote_grid_l, kpt_heads=3)
    rng = np.random.default_rng(1)
    keypoints = rng.normal(size=(9, 3)) * 0.05
    max_radii = [2.0, 2.0, 2.0]

    def weights(cfg, seed):
        model = train_mod.build_model(cfg)
        fcn.init_params(model, torch.Generator().manual_seed(seed))
        return model.state_dict()

    frames = []
    for i in range(6):
        img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
        depth = np.zeros((H, W), np.float32)
        r0, c0 = 180 + 5 * i, 260 + 7 * i
        depth[r0:r0 + 80, c0:c0 + 80] = rng.uniform(600.0, 900.0,
                                                   size=(80, 80))
        frames.append((img, depth))

    t0 = time.perf_counter()
    est3 = infer.PoseEstimator(cfg3, [weights(cfg3, i) for i in range(3)],
                               keypoints, max_radii)
    estf = infer.PoseEstimator(cfgf, weights(cfgf, 3), keypoints, max_radii)
    for est in (est3, estf):
        for net in est.models:
            calibrate_head(net, frames[0], cfg3.sem_threshold, max_radii[0])
    say(f"phase 5 weights: seeded init, load and head calibration of 4 "
        f"full-width nets in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    vote_cuda.vote_counts_cuda.launches = 0
    heads.heads_channel_major_cuda.launches = 0
    for name, est in (("3-net", est3), ("fused", estf)):
        k1_0 = vote_cuda.vote_counts_cuda.launches
        k2_0 = heads.heads_channel_major_cuda.launches
        times, outs = serve(est, frames)
        k1 = (vote_cuda.vote_counts_cuda.launches - k1_0) / len(frames)
        k2 = (heads.heads_channel_major_cuda.launches - k2_0) / len(frames)
        for out in outs:
            for key in ("rt", "centers", "escalate"):
                if not torch.isfinite(out[key]).all():
                    raise AssertionError(f"{name}: non-finite {key}")
        say(f"phase 5 serving {name}: {len(frames)} frames, ms/frame after "
            f"warm-up {[round(x, 3) for x in times[2:]]} (median "
            f"{np.median(times[2:]):.3f}), first {times[0]:.1f} ms; "
            f"launches/frame K1 {k1:.1f} K2 {k2:.1f}; escalate "
            f"{outs[-1]['escalate'].cpu().tolist()}, counts "
            f"{outs[-1]['counts'].cpu().tolist()}")
    launches = {"vote_counts": vote_cuda.vote_counts_cuda.launches,
                "heads_channel_major": heads.heads_channel_major_cuda.launches}
    for kname, n in launches.items():
        if n == 0:
            raise AssertionError(f"{kname} never launched on the main path")

    breakdown(est3, estf, frames, infer)
    # the same serving loop once more, now that the profiler has run
    for name, est in (("3-net", est3), ("fused", estf)):
        times, _ = serve(est, frames)
        say(f"phase 5 serving {name} after the profiler: ms/frame after "
            f"warm-up {[round(x, 3) for x in times[2:]]} (median "
            f"{np.median(times[2:]):.3f})")

    # information only: bf16 serving forward against the f32 one (TF32 off)
    net = est3.models[0]
    f32 = train_mod.build_model(cfg3)
    f32.load_state_dict({k: v.float() for k, v in net.state_dict().items()})
    f32 = f32.to(device=DEVICE, memory_format=torch.channels_last).eval()
    img = torch.tensor(frames[0][0], device=DEVICE)
    from rcvpose_tpu_torch import labels
    x = labels.normalize_image(img)[None]
    with torch.inference_mode():
        s16, r16 = net(x)
        s32, r32 = f32(x)
    say(f"phase 5 bf16 vs f32 forward (one frame): max |d seg| "
        f"{float((s16 - s32).abs().max()):.4g} (f32 range "
        f"{float(s32.abs().max()):.4g}), max |d radial| "
        f"{float((r16 - r32).abs().max()):.4g} (f32 range "
        f"{float(r32.abs().max()):.4g})")
    return launches


def phase_kernel_times(k1_stages, k2_input, vote_cuda, heads):
    """Device time of each kernel, its plain version and (K2) the one
    PyTorch call with the same result, at the shapes checked in phases 2
    and 3 and K2 also at the fused and training shapes, beside the bound
    and (K2) an empty kernel's time; CUDA events behind a spin kernel
    (``event_ms``: short profiler sessions dropped events). Run after
    serving, so that the serving times are taken before the profiler first
    runs. Returns K1's times by stage and K2's at the serving shape."""
    k1 = {}
    ipp = vote_cuda.INSTRUCTIONS_PER_PAIR["K1"]
    for name, (args, _) in k1_stages.items():
        pairs = args[1].shape[0] * args[0].shape[-2] * args[1].shape[1]
        ms = event_ms(lambda a=args: vote_cuda.vote_counts_cuda(*a),
                      reps=5 if name == "exact64" else 40)
        plain_ms = event_ms(lambda a=args: vote_cuda.vote_counts_plain(*a),
                            reps=2, warmup=1, repeats=1)
        bound_ms = pairs * ipp / vote_cuda.ISSUE_RATE * 1e3
        k1[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 6 K1 {name}: pairs={pairs}; device ms: kernel "
            f"{ms:.4f}, plain {plain_ms:.3f}, bound {bound_ms:.4f} "
            f"({ipp} instructions a pair at "
            f"{vote_cuda.ISSUE_RATE / 1e12:.2f} T/s; "
            f"{100 * bound_ms / ms:.1f}%)")
    frame = {k: sum(k1[s][k] for s in ("coarse", "refine"))
             for k in ("ms", "bound_ms")}
    say(f"phase 6 K1 serving frame (coarse + refine): {frame['ms']:.4f} ms, "
        f"bound {frame['bound_ms']:.4f} "
        f"({100 * frame['bound_ms'] / frame['ms']:.1f}%)")
    floor = event_ms(lambda: torch.cuda._sleep(0), reps=100)
    say(f"phase 6 empty kernel (torch.cuda._sleep(0)): {floor:.5f} ms a "
        f"launch")
    g = torch.Generator(device=DEVICE).manual_seed(6)
    shapes = {"serving": k2_input}
    for what, shape in (("fused", (1, 6, H, W)),
                        ("training", (TRAIN_BATCH, 2, H, W))):
        shapes[what] = torch.randn(*shape, device=DEVICE, generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
    k2 = {}
    for what, x in shapes.items():
        ms = event_ms(lambda: heads.heads_channel_major_cuda(x), reps=100)
        plain_ms = event_ms(lambda: heads.heads_channel_major_plain(x),
                            reps=100)
        library_ms = event_ms(
            lambda: x.float().permute(1, 0, 2, 3).contiguous(), reps=100)
        nbytes = x.numel() * (x.element_size() + 4)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        say(f"phase 6 K2 {what} {tuple(x.shape)} bf16 channels-last "
            f"({heads.fwd_branch(x)} branch): device ms: kernel {ms:.5f}, "
            f"plain {plain_ms:.5f}, library {library_ms:.5f}, bound "
            f"{bound_ms:.5f} ({100 * bound_ms / ms:.1f}%, {nbytes} bytes), "
            f"above the empty kernel {ms - floor:.5f}")
        k2[what] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms)
    return k1, k2["serving"]


def check_conv(mmconv, x, kern, what):
    """K3 against its plain version: f32 within 1e-5 of the output's scale
    (two f32 summation orders); bf16 within one bf16 ulp of the plain
    value, plus that f32 term where a sum cancels to near zero; and
    bit-identical across two runs. Returns max |kernel - plain|."""
    got = mmconv.conv_same_cuda(x, kern)
    again = mmconv.conv_same_cuda(x, kern)
    want = mmconv.conv_same_plain(x, kern)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"K3 {what}: two runs differ")
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    if x.dtype == torch.float32:
        ok = float(err.max()) <= 1e-5 * scale
    else:
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
        ok = bool((err <= ulp + 1e-5 * scale).all())
    if not ok:
        raise AssertionError(f"K3 {what}: max |diff| {float(err.max())} "
                             f"(scale {scale})")
    return float(err.max())


def check_dk(mmconv, x, g, what, ks=3):
    """K4 within 1e-4 of dk's scale and bit-identical across two runs.
    Returns max |kernel - plain|."""
    got = mmconv.conv_same_dk_cuda(x, g, ks)
    again = mmconv.conv_same_dk_cuda(x, g, ks)
    want = mmconv.conv_same_dk_plain(x, g, ks)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-4 * float(want.abs().max()):
        raise AssertionError(f"K4 {what}: max |diff| {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"K4 {what}: two runs differ")
    return err


def phase_conv_kernels(mmconv, heads):
    """K3 (forward and dx) and K4 at the decoder shapes in bf16 and f32,
    K2 and its backward at every layout at the training batch; returns the
    max errors by kernel name."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(7)
    errs = {"conv_same": 0.0, "conv_same_dk": 0.0,
            "heads_channel_major_bwd": 0.0}
    for name, h, w, c, d in DECODER:
        x = torch.randn(TRAIN_BATCH, h, w, c, device=dev, generator=g)
        kern = torch.randn(3, 3, c, d, device=dev, generator=g) / (3 * c ** 0.5)
        gy = torch.randn(TRAIN_BATCH, h, w, d, device=dev, generator=g)
        line = []
        for dtype in (torch.bfloat16, torch.float32):
            xs, ks, gs = (t.to(dtype) for t in (x, kern, gy))
            what = f"{name} {dtype}"
            e3 = check_conv(mmconv, xs, ks, what)
            # dx of the backward: K3 on the cotangent, (B,H,W,D) -> C
            e3dx = check_conv(mmconv, gs, mmconv.rot_transpose(ks),
                              what + " dx")
            e4 = check_dk(mmconv, xs, gs, what)
            errs["conv_same"] = max(errs["conv_same"], e3, e3dx)
            errs["conv_same_dk"] = max(errs["conv_same_dk"], e4)
            line.append(f"{str(dtype)[6:]} K3 {e3:.3g} K3 dx {e3dx:.3g} "
                        f"K4 {e4:.3g}")
        say(f"phase 7 {name} ({TRAIN_BATCH},{h},{w},{c})->{d} and dx "
            f"->{c}: max |kernel - plain| " + ", ".join(line)
            + "; K3 and K4 repeat bit for bit")
        del x, kern, gy
    for shape, why in PLAN_BRANCHES:
        b, h, w, c, d, ks = shape
        x = torch.randn(b * h * w * c + 1, device=dev, generator=g).to(
            torch.bfloat16)
        # "misaligned": a view 2 bytes past the buffer's 16-byte start
        x = (x[1:] if why == "misaligned" else x[:-1]).view(b, h, w, c)
        kern = (torch.randn(ks, ks, c, d, device=dev, generator=g)
                / (ks * c ** 0.5)).to(torch.bfloat16)
        gy = torch.randn(b, h, w, d, device=dev, generator=g).to(
            torch.bfloat16)
        e3 = check_conv(mmconv, x, kern, f"{shape} {why}")
        e3dx = check_conv(mmconv, gy, mmconv.rot_transpose(kern),
                          f"{shape} {why} dx")
        e4 = check_dk(mmconv, x, gy, f"{shape} {why}", ks)
        errs["conv_same"] = max(errs["conv_same"], e3, e3dx)
        errs["conv_same_dk"] = max(errs["conv_same_dk"], e4)
        plans = [mmconv.plan_conv(p, b, h, w, mmconv.round8(cc),
                                  mmconv.round8(dd), ks)
                 for p, cc, dd in (("fwd", c, d), ("fwd", d, c), ("dk", c, d))]
        say(f"phase 7 bf16 {shape} ({why}): K3 {e3:.3g} K3 dx {e3dx:.3g} "
            f"K4 {e4:.3g}, repeat bit for bit; plans "
            + "; ".join(f"{p.variant} m{p.tile_m} n{p.tile_n} k{p.tile_k} "
                        f"taps {p.taps} splits {p.splits}" for p in plans))
    errs["heads_channel_major"] = check_heads_fwd(heads, TRAIN_BATCH, g,
                                                  "phase 7")
    errs["heads_channel_major_bwd"] = check_heads_bwd(heads, TRAIN_BATCH, g,
                                                      "phase 7")
    return errs


def training_batches(labels, geometry, n, seed):
    """``n`` batches of TRAIN_BATCH rendered frames, labelled on the card
    by ``labels.make_sample`` (keypoint 0, radius clip 2 dm)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    k = geometry.LINEMOD_K
    out = []
    for _ in range(n):
        frames = [render_synthetic_frame(rng, k) for _ in range(TRAIN_BATCH)]
        depth = torch.tensor(np.stack([f[2] for f in frames]), device=DEVICE)
        pose = torch.tensor(np.stack([f[0] for f in frames]),
                            dtype=torch.float32, device=DEVICE)
        img = torch.randint(0, 256, (TRAIN_BATCH, H, W, 3), dtype=torch.uint8,
                            device=DEVICE, generator=gen)
        out.append(labels.make_sample(img, depth, depth > 0, pose,
                                      frames[0][1][0], k, 2.0))
    return out


class Scalars:
    """A writer that keeps the Trainer's scalars."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))


def counts(counters):
    return [f.launches for f in counters]


def grad_step(train_mod, cfg, batch, conv_kernel, dtype):
    """One step at lr 0 from the seeded weights in f32 (TF32 off) or f64:
    (loss, gradients by parameter name, the decoder ReLUs' sign masks,
    conv8's output). In f64, conv8's output is rounded to f32 for K2."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32", initial_lr=0.0)
    state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                   conv_kernel=conv_kernel)
    model = state.model.to(dtype)
    taps = {"relu": []}

    def keep_out(mod, inp, out):
        taps["out"] = out.detach()
        return out.float()

    hooks = [m.register_forward_hook(
        lambda mod, inp, out: taps["relu"].append(out > 0))
        for m in model.modules() if isinstance(m, torch.nn.ReLU)]
    hooks.append(model.conv8.register_forward_hook(keep_out))
    state, m = train_mod.train_step(state, batch)
    for h in hooks:
        h.remove()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(m["loss"]), grads, taps


def kink_flips(ta, tb, batch):
    """Pixels on the two sides of a kink in one run and not the other: the
    decoder's ReLUs, and the L1 losses' |seg - sem| and |radial - label|
    (labelled pixels)."""
    relu = sum(int((a != b).sum()) for a, b in zip(ta["relu"], tb["relu"]))
    sem, rad = batch["sem"], batch["radial"]
    oa, ob = ta["out"], tb["out"]
    l1 = (int(((oa[:, 0] > sem) != (ob[:, 0] > sem)).sum())
          + int((((oa[:, 1] > rad) != (ob[:, 1] > rad)) & (rad != 0)).sum()))
    return relu, l1


def check_f32_step(train_mod, cfg, batch):
    """The kernel route's f32 step against the cuDNN route's (run twice),
    all held against the cuDNN route in f64. Per parameter, e(a, b) is
    max |a - b| over the f64 gradient's max; a conv bias that feeds a BN
    (every one but conv8's) has an exact gradient of zero, and its e is
    taken over the model's largest f64 gradient entry. The kernel route
    must give the loss within 1e-4 relative of the cuDNN route's, and each
    gradient within 1e-3 of f64 (pre-BN biases 1e-4) or no further from
    f64 than twice the cuDNN route is: this net's f32 gradient is far from
    its f64 value on both routes alike, so an f32 route-vs-route bound
    measures rounding, not the kernels."""
    runs = [grad_step(train_mod, cfg, batch, ck, dtype)
            for ck, dtype in ((True, torch.float32), (False, torch.float32),
                              (False, torch.float32), (False, torch.float64))]
    (lk, gk, tk), (lc, gc, tc), (_, gc2, tc2), (lt, gt, tt) = runs
    del runs
    top = max(float(v.abs().max()) for v in gt.values())
    pre_bn = {n for n in gt if n.endswith(".bias")
              and not n.startswith("conv8")}

    def err(a, b, n):
        scale = top if n in pre_bn else float(gt[n].abs().max())
        return float((a[n].double() - b[n].double()).abs().max()) / scale

    pairs = {"K-C": (gk, gc), "C-C": (gc, gc2), "K-f64": (gk, gt),
             "C-f64": (gc, gt)}
    worst = {}
    for key, (a, b) in pairs.items():
        worst[key] = max((err(a, b, n), n) for n in gt)
    bad = [(n, err(gk, gt, n), err(gc, gt, n)) for n in gt
           if err(gk, gt, n) > max(1e-4 if n in pre_bn else 1e-3,
                                   2 * err(gc, gt, n))]
    n_kc = worst["K-C"][1]
    rel = abs(lk - lc) / abs(lc)
    flips = {pair: kink_flips(a, b, batch) for pair, a, b in (
        ("K-C", tk, tc), ("C-C", tc, tc2), ("C-f64", tc, tt))}
    say(f"phase 8 f32 step (batch 2, TF32 off), K3/K4 route (K) vs cuDNN "
        f"route (C, run twice) vs cuDNN route in f64: loss {lk:.9g} / "
        f"{lc:.9g} / {lt:.9g} (K vs C rel {rel:.2e}); worst gradient max "
        f"|diff| over the f64 max: "
        + ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in worst.items())
        + f"; at {n_kc} K-f64 {err(gk, gt, n_kc):.3e} C-f64 "
        f"{err(gc, gt, n_kc):.3e}")
    say("phase 8 f32 step: C-f64 of the decoder conv weights, deepest "
        "features first: " + ", ".join(
            f"{n[:-9]} {err(gc, gt, n):.3e}" for n in gt
            if n.startswith(("conv_up", "conv7")) and n.endswith(".0.weight"))
        + "; decoder ReLU / L1 kink flips "
        + ", ".join(f"{k} {r}/{f}" for k, (r, f) in flips.items()))
    if not (rel <= 1e-4 and not bad and math.isfinite(lk)):
        raise AssertionError(f"f32 kernel route disagrees with the cuDNN "
                             f"route: loss rel {rel}, gradients {bad[:5]}")


def phase_training(config, train_mod, labels, geometry, checkpoint, infer,
                   mmconv, heads):
    """Full-width training on both routes; returns the kernel launches of
    the kernel route's ``Trainer.fit`` run."""
    cfg = config.Config()
    assert (cfg.model, cfg.compute_dtype, cfg.optim, cfg.batch_size,
            cfg.kpt_heads) == ("dense", "bfloat16", "adam", TRAIN_BATCH, 1)
    t0 = time.perf_counter()
    batches = training_batches(labels, geometry, 2, seed=3)
    b0 = batches[0]
    labelled = int((b0["radial"] != 0).sum())
    say(f"phase 8 batches: {len(batches)} x {tuple(b0['image'].shape)} made "
        f"on the card in {time.perf_counter() - t0:.1f} s; {labelled} "
        f"labelled pixels in the first")

    # f32 (TF32 off), batch 2: the kernel route and the cuDNN route from
    # the same seeded weights, each against an f64 run of the cuDNN route
    small = {k: v[:2] for k, v in b0.items()}
    check_f32_step(train_mod, cfg, small)

    counters = (mmconv.conv_same_cuda, mmconv.conv_same_dk_cuda,
                heads.heads_channel_major_cuda,
                heads.heads_channel_major_bwd_cuda)
    fit_cfg = dataclasses.replace(cfg, max_iterations=TRAIN_STEPS,
                                  log_interval=1)
    launches = None
    for route, ck in (("K3/K4", True), ("cuDNN", False)):
        state = train_mod.create_state(fit_cfg,
                                       torch.Generator().manual_seed(0),
                                       conv_kernel=ck)
        times = []

        def timed_step(st, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = train_mod.train_step(st, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            return out

        writer = Scalars()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in counters:
            f.launches = 0
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = checkpoint.Checkpointer(tmp)
            trainer = train_mod.Trainer(
                cfg=fit_cfg, state=state,
                train_batches=lambda epoch: [batches[i % 2]
                                             for i in range(TRAIN_STEPS)],
                val_batches=lambda: [b0], checkpointer=ckpt, writer=writer,
                steps=(timed_step, train_mod.eval_step))
            t0 = time.perf_counter()
            trainer.fit(max_epochs=1)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            fit_counts = counts(counters)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            losses = [v for t, v, _ in writer.scalars if t == "Train_sum"]
            if len(losses) != TRAIN_STEPS or not all(map(math.isfinite,
                                                          losses)):
                raise AssertionError(f"{route}: losses {losses}")
            ms = float(np.median(times[2:]))
            say(f"phase 8 fit {route}: {TRAIN_STEPS} steps + 1 validation "
                f"in {fit_s:.1f} s; ms/step {[round(t, 3) for t in times]} "
                f"(median after 2 {ms:.3f}, {TRAIN_BATCH * 1e3 / ms:.2f} "
                f"images/s); losses {[round(x, 4) for x in losses]}; val "
                f"{trainer.best_val:.4f}; peak memory {peak:.2f} GiB; "
                f"launches in fit K3 {fit_counts[0]} K4 {fit_counts[1]} "
                f"K2 {fit_counts[2]} K2-bwd {fit_counts[3]}")
            if ck:
                launches = dict(zip(("conv_same", "conv_same_dk",
                                     "heads_channel_major",
                                     "heads_channel_major_bwd"), fit_counts))
                restored = serve_restored(config, train_mod, checkpoint,
                                          infer, ckpt, trainer, fit_cfg)
                del restored

        # the launches of one step and of one accumulated step
        before = counts(counters)
        trainer.state, _ = train_mod.train_step(trainer.state, b0)
        per_step = [a - b for a, b in zip(counts(counters), before)]
        before = counts(counters)
        trainer.state, m2 = train_mod.make_accum_train_step(2)(trainer.state,
                                                               b0)
        torch.cuda.synchronize()
        per_accum = [a - b for a, b in zip(counts(counters), before)]
        want = [12, 6, 1, 1] if ck else [0, 0, 1, 1]
        if per_step != want or per_accum != [2 * n for n in want] \
                or not math.isfinite(float(m2["loss"])):
            raise AssertionError(f"{route}: launches per step {per_step}, "
                                 f"per 2-microbatch step {per_accum}")
        wall, dev_ms, by_kernel = profile_ms(
            lambda: train_mod.train_step(trainer.state, b0), reps=3)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        say(f"phase 8 {route}: launches per step K3 K4 K2 K2-bwd {per_step}, "
            f"per accum_steps=2 step {per_accum}; profile: wall "
            f"{wall:.3f} ms/step (profiler on), device busy {dev_ms:.3f} ms "
            f"({dev_ms / wall:.1%}); top kernels ms: "
            + "; ".join(f"{k[:48]} {v:.3f}" for k, v in top))
        del trainer, state
        torch.cuda.empty_cache()
    return launches


def serve_restored(config, train_mod, checkpoint, infer, ckpt, trainer, cfg):
    """Restore the checkpoint into a freshly seeded state, check it equals
    the trained one, and serve one frame from its weights (3-net mode)."""
    fresh = train_mod.create_state(cfg, torch.Generator().manual_seed(1),
                                   conv_kernel=True)
    fresh, epoch, it, best = ckpt.restore(fresh)
    trained = trainer.state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        if not torch.equal(v, trained[k]):
            raise AssertionError(f"restore: {k} differs")
    if (it, fresh.step) != (trainer.iteration, trainer.state.step):
        raise AssertionError(f"restore: iteration {it}, step {fresh.step}")
    cfg3 = config.Config(vote_grid_l=GRID_L)
    rng = np.random.default_rng(5)
    weights = {k: v.detach().cpu() for k, v in fresh.model.state_dict().items()}
    est = infer.PoseEstimator(cfg3, [weights] * 3,
                              rng.normal(size=(9, 3)) * 0.05, [2.0] * 3)
    img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    depth = np.zeros((H, W), np.float32)
    depth[200:280, 280:360] = rng.uniform(600.0, 900.0, size=(80, 80))
    for net in est.models:
        calibrate_head(net, (img, depth), cfg3.sem_threshold, 2.0)
    out = est.estimate(img, depth)
    for key in ("rt", "centers"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"served frame: non-finite {key}")
    say(f"phase 8 restore: epoch {epoch}, iteration {it}, best val "
        f"{best:.4f}, weights equal to the trained ones; served one frame "
        f"from them: counts {out['counts'].cpu().tolist()}")
    del est
    return fresh


def phase_train_kernel_times(mmconv, heads):
    """Device ms of K3 (forward and dx), K4 and K2's backward at the
    training shapes, their plain versions, the PyTorch call for the same
    function, and the bound. Returns per-kernel sums over one step. All
    are timed with CUDA events behind a spin kernel (the profiler dropped
    events over many short sessions)."""
    import torch.nn.functional as F

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(9)
    tot = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
           for n in ("conv_same", "conv_same_dk")}
    bf = torch.bfloat16
    for name, h, w, c, d in DECODER:
        b = TRAIN_BATCH
        x = torch.randn(b, h, w, c, device=dev, generator=g).to(bf)
        kern = (torch.randn(3, 3, c, d, device=dev, generator=g)
                / (3 * c ** 0.5)).to(bf)
        gy = torch.randn(b, h, w, d, device=dev, generator=g).to(bf)
        kt = mmconv.rot_transpose(kern)
        flop = 2 * b * h * w * c * d * 9

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        def oihw(k):
            return k.permute(3, 2, 0, 1).contiguous()

        w_f, w_t = oihw(kern), oihw(kt)
        cases = {
            ("conv_same", "fwd"): (
                lambda: mmconv.conv_same_cuda(x, kern),
                lambda: mmconv.conv_same_plain(x, kern),
                lambda: F.conv2d(nchw(x), w_f, padding=1),
                (x.numel() + kern.numel() + b * h * w * d) * 2),
            ("conv_same", "dx"): (
                lambda: mmconv.conv_same_cuda(gy, kt),
                lambda: mmconv.conv_same_plain(gy, kt),
                lambda: F.conv2d(nchw(gy), w_t, padding=1),
                (gy.numel() + kt.numel() + x.numel()) * 2),
            ("conv_same_dk", "dk"): (
                lambda: mmconv.conv_same_dk_cuda(x, gy, 3),
                lambda: mmconv.conv_same_dk_plain(x, gy, 3),
                lambda: torch.ops.aten.convolution_backward(
                    nchw(gy), nchw(x), w_f, None, [1, 1], [1, 1], [1, 1],
                    False, [0, 0], 1, [False, True, False]),
                (x.numel() + gy.numel()) * 2 + kern.numel() * 4),
        }
        parts = []
        for (kname, part), (kern_fn, plain_fn, lib_fn, nbytes) in \
                cases.items():
            ms = event_ms(kern_fn, reps=10)
            plain_ms = event_ms(plain_fn, reps=3)
            lib_ms = event_ms(lib_fn, reps=10)
            bound = max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
            t = tot[kname]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["library_ms"] += lib_ms
            t["bound_ms"] += bound
            parts.append(f"{part} kernel {ms:.4f} ({flop / ms / 1e9:.1f} "
                         f"TFLOP/s, {100 * bound / ms:.1f}% of bound, "
                         f"{ms / lib_ms:.2f}x cuDNN) plain {plain_ms:.4f} "
                         f"cuDNN {lib_ms:.4f} bound {bound:.4f}")
        say(f"phase 9 {name} ({b},{h},{w},{c})->{d} bf16, {flop / 1e9:.1f} "
            f"GFLOP each, device ms: " + "; ".join(parts))
        del x, kern, gy, kt
    ct = torch.randn(2, TRAIN_BATCH, H, W, device=dev, generator=g)
    ms = event_ms(lambda: heads.heads_channel_major_bwd_cuda(ct, bf, True),
                  reps=100)
    plain_ms = event_ms(
        lambda: heads.heads_channel_major_bwd_plain(ct, bf, True), reps=100)
    lib_ms = event_ms(
        lambda: ct.permute(1, 0, 2, 3).to(bf, memory_format=torch.channels_last),
        reps=100)
    nbytes = ct.numel() * (4 + 2)
    tot["heads_channel_major_bwd"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
    bound = tot["heads_channel_major_bwd"]["bound_ms"]
    say(f"phase 9 K2 backward ({TRAIN_BATCH},2,{H},{W}) f32 -> bf16 "
        f"channels-last ({heads.bwd_branch(ct, True)} branch): device ms "
        f"kernel {ms:.5f}, plain {plain_ms:.5f}, library {lib_ms:.5f} "
        f"({ms / lib_ms:.2f}x), bound {bound:.5f} ({100 * bound / ms:.1f}%, "
        f"{nbytes} bytes)")
    for n in ("conv_same", "conv_same_dk"):
        t = tot[n]
        say(f"phase 9 {n} per step: device ms kernel {t['ms']:.3f}, plain "
            f"{t['plain_ms']:.3f}, cuDNN {t['library_ms']:.3f} "
            f"({t['ms'] / t['library_ms']:.2f}x), bound "
            f"{t['bound_ms']:.3f} ({100 * t['bound_ms'] / t['ms']:.1f}%)")
    return tot


# The hier stages' shapes (3 keypoints a launch): serving at grid 128 with
# topk 32 and the LM evaluator at grid 192 with topk 64.
HIER_CONFIGS = (("serving", 128, 32), ("lm", 192, 64))
# K6's bf16-compare arm, a row of its own in the kernels line
K6_BF16_COMPARE = "vote_counts_bf16 (bf16 compare)"
LM_FRAMES = 4


def hier_stages(voting, vote_cuda, geometry, frame, grid_l, topk):
    """The coarse and refine stage inputs of the hier accumulator for the
    three keypoints of a rendered frame, at ``grid_l`` with ``topk``
    refine windows (the refine windows from K1's coarse counts)."""
    dev = torch.device(DEVICE)
    _, _, depth_mm, radials, _ = frame
    depth = torch.tensor(depth_mm, device=dev)
    xyz, valid = geometry.backproject_dense(depth, geometry.LINEMOD_K)
    order, mask = geometry.pack_valid_indices(valid.reshape(-1), N_POINTS)
    pts_m = (xyz.reshape(-1, 3)[order] / 1000.0).expand(3, -1, -1)
    rad = torch.tensor(radials, device=dev).reshape(3, -1)[:, order]
    mask3 = mask[None] & (rad > 0)
    pts, rr, _, _, _ = voting._prepare(pts_m, rad, mask3)
    co = voting._COARSE
    lc = grid_l // co
    coarse = (voting.enumerate_grid(lc, dev) + 0.5) * co - 0.5
    slack = voting.VOTE_BAND + math.sqrt(3.0) * co / 2.0
    lo_c, hi_c = voting.widened_band(rr, mask3, slack)
    s = voting._CPT_STRIDE
    stages = {"coarse": (coarse, pts[:, ::s].contiguous(),
                         lo_c[:, ::s].contiguous(), hi_c[:, ::s].contiguous())}
    top = voting._top_indices(vote_cuda.vote_counts_cuda(*stages["coarse"]),
                              topk)
    win = voting._WIN
    bases = torch.clamp(voting._unravel3(top, lc) * co - (win - co) // 2, 0,
                        grid_l - win)
    win_vox = (bases[:, :, None, :]
               + voting.enumerate_grid(win, dev)[None, None]).reshape(3, -1, 3)
    lo_f, hi_f = voting.exact_band(rr, mask3)
    stages["refine"] = (win_vox, pts, lo_f, hi_f)
    return stages


def near_edge_counts(vox, pts, lo, hi):
    """Per voxel, the pairs whose f64 d2 lies within the matmul form's
    rounding, 4 * 2^-24 * (|v|^2 + |p|^2), of lo or hi (on the card, in
    f64, chunked over the points)."""
    b = pts.shape[0]
    v = (vox.expand(b, -1, -1) if vox.dim() == 2 else vox).double()
    p, l, h = pts.double(), lo.double(), hi.double()
    v2 = (v * v).sum(-1)[:, :, None]
    out = torch.zeros(v.shape[:2], dtype=torch.int64, device=vox.device)
    chunk = max(1, (1 << 22) // v.shape[1])
    for c0 in range(0, p.shape[1], chunk):
        pc = p[:, None, c0:c0 + chunk]
        d2 = ((v[:, :, None] - pc) ** 2).sum(-1)
        tol = 4 * 2.0 ** -24 * (v2 + (pc * pc).sum(-1))
        lc, hc = l[:, None, c0:c0 + chunk], h[:, None, c0:c0 + chunk]
        near = ((d2 - lc).abs() <= tol) | ((d2 - hc).abs() <= tol)
        out += (near & (hc > 0)).sum(-1)
    return out


def phase_vote_variants(voting, vote_cuda, geometry):
    """K5, K6 (both compares) and every K1 tile against their plain versions
    at the hier stages' shapes of serving and of the LM evaluator; K5
    against K1 within the matmul form's band-edge rounding; then the paths
    that run them: ``voting.vote_counts(mxu=True)`` over those stages and
    the two ``rcvpose_tpu_torch.scripts`` entry points, with the counts
    set to 0 just before. Returns (stages, max errors, path launches,
    script results)."""
    from rcvpose_tpu_torch.scripts import prof_vote_bf16, prof_vote_tiles

    frame = render_synthetic_frame(np.random.default_rng(0),
                                   geometry.LINEMOD_K)
    stages = {}
    for cfg_name, grid_l, topk in HIER_CONFIGS:
        for stage, args in hier_stages(voting, vote_cuda, geometry, frame,
                                       grid_l, topk).items():
            stages[f"{cfg_name} {stage}"] = args
    errs = {"vote_counts_mxu": 0.0, "vote_counts_bf16": 0.0,
            K6_BF16_COMPARE: 0.0, "vote_counts_tiled": 0.0}
    for name, args in stages.items():
        b, v, n = args[1].shape[0], args[0].shape[-2], args[1].shape[1]
        k1 = vote_cuda.vote_counts_cuda(*args)
        k1_plain = vote_cuda.vote_counts_plain(*args)
        checks = {
            "K1": (k1, k1_plain, "vote_counts_tiled"),
            "K5": (vote_cuda.vote_counts_mxu_cuda(*args),
                   vote_cuda.vote_counts_mxu_plain(*args), "vote_counts_mxu"),
            "K6 f32": (vote_cuda.vote_counts_bf16_cuda(*args, "f32"),
                       vote_cuda.vote_counts_bf16_plain(*args, "f32"),
                       "vote_counts_bf16"),
            "K6 bf16": (vote_cuda.vote_counts_bf16_cuda(*args, "bf16"),
                        vote_cuda.vote_counts_bf16_plain(*args, "bf16"),
                        K6_BF16_COMPARE)}
        torch.cuda.synchronize()
        for what, (got, want, key) in checks.items():
            errs[key] = max(errs[key], float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{what} {name}: counts differ from "
                                     f"the plain version")
        k5 = checks["K5"][0]
        diff = (k5 - k1).abs()
        near = near_edge_counts(*args)
        if not bool((diff <= near).all()):
            raise AssertionError(f"K5 {name}: differs from K1 beyond the "
                                 f"band-edge pairs")
        k6 = checks["K6 f32"][0]
        rel = float(((k6 - k1).abs() / k1.clamp(min=1)).mean())
        bad = []
        for tile in vote_cuda.TILES:
            got = vote_cuda.vote_counts_cuda(*args, tile=tile)
            errs["vote_counts_tiled"] = max(
                errs["vote_counts_tiled"], float((got - k1_plain).abs().max()))
            if not torch.equal(got, k1_plain):
                bad.append(tile)
        if bad:
            raise AssertionError(f"K1 {name}: tiles {bad} differ from the "
                                 f"plain version")
        for compare, key in (("f32", "vote_counts_bf16"),
                             ("bf16", K6_BF16_COMPARE)):
            errs[key] = max(errs[key], check_splits(
                lambda *a, split, c=compare: vote_cuda.vote_counts_bf16_cuda(
                    *a, c, split=split),
                lambda *a, c=compare: vote_cuda.vote_counts_bf16_plain(*a, c),
                f"K6 {compare} compare {name}", args))
        say(f"phase 10 {name}: B={b} V={v} N={n}; K1, K5, K6 f32 and K6 "
            f"bf16 equal their plain versions; K5 vs K1 "
            f"{int((diff > 0).sum())} voxels differ (max "
            f"{float(diff.max()):.0f} votes, within the {int(near.sum())} "
            f"band-edge pairs); K6 f32 vs K1 count rel-err mean {rel:.4f}; "
            f"all {len(vote_cuda.TILES)} K1 tiles equal the plain version; "
            f"K6 in both compares at every split branch "
            f"({', '.join(split_cases(args))}) equal to the plain version, "
            f"repeat bit for bit")

    torch.cuda.synchronize()
    vote_cuda.vote_counts_mxu_cuda.launches = 0
    vote_cuda.vote_counts_bf16_cuda.launches = 0
    vote_cuda.vote_counts_bf16_cuda.bf16_compare_launches = 0
    vote_cuda.vote_counts_cuda.tiled_launches = 0
    for args in stages.values():
        voting.vote_counts(*args, mxu=True)
    scripts = {"tiles": prof_vote_tiles.main(
                   printer=lambda line: say(f"phase 10 prof_vote_tiles: "
                                            f"{line}")),
               "bf16": prof_vote_bf16.main(
                   printer=lambda line: say(f"phase 10 prof_vote_bf16: "
                                            f"{line}"))}
    torch.cuda.synchronize()
    k6_bf16 = vote_cuda.vote_counts_bf16_cuda.bf16_compare_launches
    launches = {"vote_counts_mxu": vote_cuda.vote_counts_mxu_cuda.launches,
                "vote_counts_bf16":
                    vote_cuda.vote_counts_bf16_cuda.launches - k6_bf16,
                K6_BF16_COMPARE: k6_bf16,
                "vote_counts_tiled":
                    vote_cuda.vote_counts_cuda.tiled_launches}
    say(f"phase 10 path launches (voting.vote_counts(mxu=True) over the "
        f"{len(stages)} stages, then both scripts): {launches}")
    return stages, errs, launches, scripts


def pose_at(rng, u0, v0, z, k):
    """A pose (3, 4), translation in m, that puts the model frame's origin
    at pixel (u0, v0) and depth z, turned about the optical axis by up to
    0.3 rad."""
    angle = rng.uniform(-0.3, 0.3)
    c, s_ = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]])
    t = np.array([(u0 - k[0, 2]) / k[0, 0] * z, (v0 - k[1, 2]) / k[1, 1] * z,
                  z])
    return np.concatenate([rot, t[:, None]], axis=1)


def render_depth(model_m, pose, k):
    """(H, W) f32 depth (mm) of a point model: each point's z at its
    rounded pixel."""
    cam = model_m @ pose[:, :3].T + pose[:, 3]
    uv = cam @ k.T
    us = np.round(uv[:, 0] / uv[:, 2]).astype(int)
    vs = np.round(uv[:, 1] / uv[:, 2]).astype(int)
    ok = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    depth = np.zeros((H, W), np.float32)
    depth[vs[ok], us[ok]] = cam[ok, 2] * 1000.0
    return depth


def perfect_radials(depth_mm, pose, kpts9, k):
    """(3, H, W) f32 radial maps (dm) of keypoints 1-3 from a depth map
    (mm), 0 where the depth is."""
    z = np.asarray(depth_mm, np.float64)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    xyz_m = np.stack([(uu - k[0, 2]) * z / k[0, 0],
                      (vv - k[1, 2]) * z / k[1, 1], z], -1) / 1000.0
    kc = kpts9[1:4] @ pose[:, :3].T + pose[:, 3]
    return np.stack([np.where(z > 0, np.linalg.norm(xyz_m - c, axis=-1)
                              * 10.0, 0.0) for c in kc]).astype(np.float32)


def write_lm_tree(root, geometry):
    """A LINEMOD-layout tree for class ``ape`` at 480x640 with LM_FRAMES
    frames, as ``tests/test_eval_lm_format.py`` renders it: a 2-3 cm blob
    CAD in meters, keypoints 6 cm out, depth as .dpt, perfect radial maps
    (dm) from the quantized depth, noise images as JPEG. Returns the frames
    in memory: [(frame id, image, depth (H, W) f32, pose (3, 4) m)], and
    the CAD (m) and keypoints."""
    import os

    from PIL import Image

    rng = np.random.default_rng(11)
    k = np.asarray(geometry.LINEMOD_K)
    pv = os.path.join(root, "LINEMOD", "ape")
    orig = os.path.join(root, "LINEMOD_ORIG", "ape")
    for d in ("JPEGImages", "pose", "Split"):
        os.makedirs(os.path.join(pv, d))
    os.makedirs(os.path.join(orig, "data"))
    rmap = os.path.join(root, "LINEMOD_ORIG", "estRadialMap", "ape")
    for kp in range(1, 4):
        os.makedirs(os.path.join(rmap, f"Out_pt{kp}_dm"))
    dirs = rng.normal(size=(3000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    model_m = dirs * rng.uniform(0.02, 0.03, size=(3000, 1))
    kpts9 = np.zeros((9, 3))
    kpts9[1:4] = [[0.06, 0.06, 0.06], [-0.06, 0.06, -0.06],
                  [0.06, -0.06, -0.06]]
    with open(os.path.join(pv, "ape.ply"), "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 3000\nproperty float "
                "x\nproperty float y\nproperty float z\nend_header\n")
        for p in model_m:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
    np.save(os.path.join(pv, "Outside9.npy"), kpts9)
    frames = []
    for i in range(LM_FRAMES):
        pose = pose_at(rng, W // 2 - 20 + 20 * i, H // 2 - 20 + 10 * i,
                       0.75 + 0.05 * i, k)
        np.save(os.path.join(pv, "pose", f"pose{i}.npy"), pose)
        depth_u16 = np.round(render_depth(model_m, pose, k)).astype(np.uint16)
        with open(os.path.join(orig, "data", f"depth{i}.dpt"), "wb") as f:
            f.write(np.asarray([H, W], np.uint32).tobytes())
            f.write(depth_u16.tobytes())
        img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
        fid = f"{i:06d}"
        Image.fromarray(img).save(
            os.path.join(pv, "JPEGImages", f"{fid}.jpg"))
        for kp, r in enumerate(perfect_radials(depth_u16, pose, kpts9, k), 1):
            np.save(os.path.join(rmap, f"Out_pt{kp}_dm", f"{fid}.npy"), r)
        frames.append((fid, img, depth_u16.astype(np.float32), pose))
    with open(os.path.join(pv, "Split", "val.txt"), "w") as f:
        f.write("\n".join(fid for fid, _, _, _ in frames) + "\n")
    return frames, model_m, kpts9


def phase_lm_eval(config, eval_mod, train_mod, fcn, geometry, vote_cuda,
                  heads, root):
    """The LM evaluator at full width on both routes: 3-net .pth.tar
    checkpoints through RadialMapSource -> K2 -> keypoint_with_retry -> K1
    -> Horn -> ICP -> ADD, and the precomputed-map route, with K1's and
    K2's counts set to 0 just before each and read just after. The tree
    and the nets stay in ``root`` for phase 13. Returns {"cad_m", "kpts9",
    "model_dir", "icp_ms": (wall, device) of the 30-iteration ICP}."""
    import os

    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("nn_distances and ICP need full-f32 matmuls "
                             "(TF32 off)")
    frames, cad_m, kpts9 = write_lm_tree(root, geometry)
    max_radii = eval_mod._per_kpt_max_radii_dm(cad_m, kpts9)
    model_dir = os.path.join(root, "ckpts")
    os.makedirs(model_dir)
    cfg = config.Config(root_dataset=root, model_dir=model_dir)
    assert (cfg.vote_grid_l, cfg.max_points, cfg.vote_mode, cfg.icp_iters,
            cfg.sem_threshold, cfg.compute_dtype) == (
                192, 8192, "hier", 30, 0.8, "bfloat16")
    t0 = time.perf_counter()
    for i in range(1, 4):
        net = fcn.init_params(train_mod.build_model(cfg),
                              torch.Generator().manual_seed(20 + i))
        net = net.to(DEVICE, memory_format=torch.channels_last).eval()
        calibrate_head(net, frames[0][1:3], cfg.sem_threshold,
                       float(max_radii[i - 1]))
        torch.save({"model_state_dict": {
            k: v.detach().cpu() for k, v in net.state_dict().items()}},
            os.path.join(model_dir, f"ape_pt{i}.pth.tar"))
        del net
    say(f"phase 11 tree: {LM_FRAMES} frames at {H}x{W}, 3 calibrated "
        f"full-width .pth.tar nets written in "
        f"{time.perf_counter() - t0:.1f} s; max radii "
        f"{np.round(max_radii, 4).tolist()} dm")

    for route, using in (("network", True), ("precomputed", False)):
        rcfg = dataclasses.replace(cfg, using_ckpts=using)
        res, launches, secs = counted_eval(
            vote_cuda, heads, lambda c=rcfg: eval_mod.estimate_6d_pose_lm(
                c, class_names=["ape"], progress=lambda m: None)["ape"])
        say(f"phase 11 {route} route: {res['frames']} frames in "
            f"{secs:.1f} s; ADD before ICP {res['add_before_icp']}, "
            f"after ICP {res['add_after_icp']}; overflow frames "
            f"{res['overflow_frames']}; net_ms_per_frame "
            f"{res['net_ms_per_frame']:.3f}, acc_ms_per_frame "
            f"{res['acc_ms_per_frame']:.3f} (host clock, each stage "
            f"ending in a synchronize); launches K1 "
            f"{launches['vote_counts']} K2 "
            f"{launches['heads_channel_major']}")
        check_route(f"phase 11 {route}", res, launches, LM_FRAMES, using,
                    perfect=not using)
    icp_ms = icp_device_ms(eval_mod, cfg, root, frames[0], cad_m, kpts9,
                           max_radii)
    say(f"phase 11 ICP ({cfg.icp_iters} iterations, {cad_m.shape[0]} "
        f"CAD points against 3 x {cfg.max_points} scene points): device "
        f"{icp_ms[1]:.3f} ms, wall {icp_ms[0]:.3f} ms (profiler on)")
    return {"cad_m": cad_m, "kpts9": kpts9, "model_dir": model_dir,
            "icp_ms": icp_ms}


def counted_eval(vote_cuda, heads, run):
    """``run()`` with K1's and K2's launch counts set to 0 just before and
    read just after: (its result, launches, seconds)."""
    torch.cuda.synchronize()
    vote_cuda.vote_counts_cuda.launches = 0
    heads.heads_channel_major_cuda.launches = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return res, {"vote_counts": vote_cuda.vote_counts_cuda.launches,
                 "heads_channel_major":
                     heads.heads_channel_major_cuda.launches}, secs


def check_route(what, res, launches, frames, network, perfect):
    """An evaluator route's checks: the frame count; K1 launched, and K2 on
    a network route; ADD 1.0 before and after ICP on perfect maps."""
    if res["frames"] != frames:
        raise AssertionError(f"{what}: {res['frames']} frames, not {frames}")
    if launches["vote_counts"] == 0 or (
            network and launches["heads_channel_major"] == 0):
        raise AssertionError(f"{what}: kernels not launched {launches}")
    if perfect and (res["add_before_icp"], res["add_after_icp"]) != (1.0,
                                                                     1.0):
        raise AssertionError(f"{what} on perfect maps: ADD {res}")


def icp_device_ms(eval_mod, cfg, root, frame, cad_m, kpts9, max_radii):
    """Profiler wall and device ms of one ``refine_and_add`` (the LM ICP)
    on the first frame's precomputed keypoints and scene cloud."""
    cfg = eval_mod._dataset_eval_cfg(dataclasses.replace(
        cfg, root_dataset=root, using_ckpts=False))
    dev = torch.device(DEVICE)
    fid, _, depth, pose = frame
    source = eval_mod.RadialMapSource(cfg, "ape", None, dev)
    k = torch.tensor(eval_mod.geometry.LINEMOD_K, dtype=torch.float32,
                     device=dev)
    d = torch.tensor(depth, device=dev)
    cad = torch.tensor((cad_m * 1000.0).astype(np.float32), device=dev)
    rt_gt = pose.copy()
    rt_gt[:, 3] *= 1000.0
    rt_gt = torch.tensor(rt_gt, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        outs = [eval_mod.keypoint_with_retry(
            cfg, *source.maps(kp, None, fid), d, k,
            torch.tensor(float(max_radii[kp - 1]), device=dev),
            torch.tensor(cfg.sem_threshold, device=dev))
            for kp in range(1, 4)]
        rt, score = eval_mod.pose_and_add(
            torch.tensor(kpts9[1:4] * 1000.0, dtype=torch.float32,
                         device=dev),
            torch.stack([o[0] for o in outs]), cad, rt_gt, False)
        scene = torch.cat([o[3] for o in outs])
        mask = torch.cat([o[4] for o in outs])
        wall, dev_ms, _ = profile_ms(lambda: eval_mod.refine_and_add(
            rt, cad, scene, mask, rt_gt, False, score.clamp(min=1e-3),
            icp_iters=cfg.icp_iters), reps=3)
    return wall, dev_ms


def phase_variant_times(stages, vote_cuda, best_tile):
    """Device ms of K5, K6 (f32 and bf16 compare) and K1 at the sweep's
    best tile, at the phase-10 stages, beside their plain versions and
    bounds. Returns the sums over the LM evaluator's two stages (one
    hier frame of 3 keypoints) by kernel name."""
    ipp = vote_cuda.INSTRUCTIONS_PER_PAIR
    kernels = {
        "vote_counts_mxu": (
            vote_cuda.vote_counts_mxu_cuda, vote_cuda.vote_counts_mxu_plain,
            ipp["K5"], ()),
        "vote_counts_bf16": (
            vote_cuda.vote_counts_bf16_cuda, vote_cuda.vote_counts_bf16_plain,
            ipp["K6 f32"], ("f32",)),
        K6_BF16_COMPARE: (
            vote_cuda.vote_counts_bf16_cuda, vote_cuda.vote_counts_bf16_plain,
            ipp["K6 bf16"], ("bf16",)),
        "vote_counts_tiled": (
            lambda *a: vote_cuda.vote_counts_cuda(*a, tile=best_tile),
            vote_cuda.vote_counts_plain, ipp["K1"], ()),
        "vote_counts (default tile)": (
            vote_cuda.vote_counts_cuda, vote_cuda.vote_counts_plain,
            ipp["K1"], ()),
    }
    tot = {}
    for kname, (kern, plain, ops, extra) in kernels.items():
        t = tot.setdefault(kname, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0))
        parts = []
        for name, args in stages.items():
            pairs = args[1].shape[0] * args[0].shape[-2] * args[1].shape[1]
            ms = event_ms(lambda a=args: kern(*a, *extra), reps=20)
            bound = pairs * ops / vote_cuda.ISSUE_RATE * 1e3
            parts.append(f"{name} {ms:.4f} (bound {bound:.4f}, "
                         f"{100 * bound / ms:.1f}%, {pairs} pairs)")
            if name.startswith("lm "):
                # the plain versions only where the kernels line reads them
                plain_ms = event_ms(lambda a=args: plain(*a, *extra), reps=1,
                                    warmup=1, repeats=1)
                parts[-1] = parts[-1][:-1] + f", plain {plain_ms:.3f})"
                t["ms"] += ms
                t["plain_ms"] += plain_ms
                t["bound_ms"] += bound
        say(f"phase 12 {kname}: device ms " + "; ".join(parts))
    for kname, t in tot.items():
        say(f"phase 12 {kname} per LM hier frame (coarse + refine, 3 "
            f"keypoints): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f}, "
            f"bound {t['bound_ms']:.4f} ({t['bound_ms'] / t['ms']:.1%} of "
            f"it)")
    k6_split_times(stages, vote_cuda)
    return tot


def k6_split_times(stages, vote_cuda):
    """Device ms of K6 in both compares at each of its split branches
    (``split_cases``, checked in phase 10) at the phase-10 stages."""
    for name, args in stages.items():
        for compare in ("f32", "bf16"):
            parts = []
            for case, (a, split) in split_cases(args).items():
                ms = event_ms(lambda a=a, s=split, c=compare:
                              vote_cuda.vote_counts_bf16_cuda(*a, c, split=s),
                              reps=20)
                parts.append(f"{case} {ms:.4f}")
            say(f"phase 12 K6 {compare} compare {name} by split branch, "
                f"device ms: " + "; ".join(parts))


# Phase 13: the LMO tree's frame without a pose, the YCB class, YCB-Video's
# camera-1 intrinsics and depth scale, and its frames.
LMO_UNPOSED = 9
YCB_CLASS = (1, "002_master_chef_can")
YCB_K = np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109],
                  [0.0, 0.0, 1.0]])
YCB_FACTOR_DEPTH = 10000.0
YCB_FRAMES = 3
# The class's HDF5 file as h5py 3.14 (HDF5 1.14.6) writes it, zlib and
# base64: empty datasets JPEGImages/0000_000001-0000_000004 (the last is
# not in val.txt). The evaluator reads only these names; the machine with
# the card has no h5py to write the file, and the port reads it there
# with its own reader (readers.hdf5_group_keys).
YCB_KEYS_HDF5 = (
    "eNrr9HBx4+WS4mIAAQ4OBhYGAQZk8B8KNvCg8mHyCVCaEUp3QOkVTDBxRrCcBFRcEGo+urqQ"
    "IFdXkOr/aABmzwNWCM3BMApGIvBwdQwA0RFQPiw9nWBCVecV4OrumZuYnlqMmi4dyLQXV/r1"
    "YIbwM1iJS78W0IRrMRqVo+kXxIeVl6yo6gyAIB5EGBii8Y3Q+MZofBOU9A4rxYP9/F1AKRhW"
    "biowo+YL9HQ8CnCVA6yQMGOE8SElAiMjI1b1zMAYYITGAyNSzcUKpEF8JiYmRogoxBxmRvQS"
    "AwYmDMrwgKQrFni60mDHrx5WfjZw4lenAfM1F351sHJ0AfdouhpO6Wo0PEbDAx8AAPLTdZI=")


def write_lmo_tree(root, geometry, cad_m, kpts9):
    """The OCCLUSION_LINEMOD layout beside phase 11's LINEMOD tree (whose
    CAD, keypoints and nets LMO reads): LM_FRAMES posed frames and frame
    LMO_UNPOSED without a pose, PNG colour and 16-bit depth (mm), perfect
    ``_NNNNN.npy`` radial maps of the depth."""
    import os

    from PIL import Image

    rng = np.random.default_rng(13)
    k = np.asarray(geometry.LINEMOD_K)
    occ = os.path.join(root, "OCCLUSION_LINEMOD")
    rgb = os.path.join(occ, "RGB-D", "rgb_noseg")
    dep = os.path.join(occ, "RGB-D", "depth_noseg")
    poses = os.path.join(occ, "blender_poses", "ape")
    rmap = os.path.join(occ, "estRadialMap", "ape")
    for d in (rgb, dep, poses) + tuple(
            os.path.join(rmap, f"Out_pt{kp}_dm") for kp in range(1, 4)):
        os.makedirs(d)
    for num in list(range(LM_FRAMES)) + [LMO_UNPOSED]:
        pose = pose_at(rng, W // 2 + 30 - 15 * (num % 5),
                       H // 2 - 10 + 8 * (num % 5), 0.7 + 0.04 * (num % 5), k)
        depth = np.round(render_depth(cad_m, pose, k)).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(dep, f"depth_{num:05d}.png"))
        Image.fromarray(rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
                        ).save(os.path.join(rgb, f"color_{num:05d}.png"))
        if num == LMO_UNPOSED:
            continue
        np.save(os.path.join(poses, f"pose{num}.npy"), pose)
        for kp, r in enumerate(perfect_radials(depth, pose, kpts9, k), 1):
            np.save(os.path.join(rmap, f"Out_pt{kp}_dm", f"_{num:05d}.npy"),
                    r)


def write_ycb_tree(root, cad_m, kpts9):
    """A YCB-Video tree for YCB_CLASS at 480x640: the model as
    ``points.xyz`` with its keypoints, YCB_FRAMES frames (PNG colour,
    16-bit depth at YCB_FACTOR_DEPTH, a ``.mat`` with the pose, class,
    depth scale and YCB_K), the HDF5 name list, and the exact radial maps
    of the depth the evaluator reads under ``exact/``."""
    import base64
    import os
    import zlib

    import scipy.io
    from PIL import Image

    rng = np.random.default_rng(17)
    class_id, name = YCB_CLASS
    mdir = os.path.join(root, "models", name)
    data = os.path.join(root, "data", "0000")
    for d in (mdir, data, os.path.join(root, "Split", name),
              os.path.join(root, "exact")):
        os.makedirs(d)
    np.savetxt(os.path.join(mdir, "points.xyz"), cad_m)
    np.save(os.path.join(mdir, "Outside9.npy"), kpts9)
    with open(os.path.join(root, f"{name}.hdf5"), "wb") as f:
        f.write(zlib.decompress(base64.b64decode(YCB_KEYS_HDF5)))
    ids = []
    for i in range(1, YCB_FRAMES + 1):
        idx = f"{i:06d}"
        pose = pose_at(rng, W // 2 - 40 + 30 * i, H // 2 + 20 - 15 * i,
                       0.8 + 0.05 * i, YCB_K)
        depth = np.round(render_depth(cad_m, pose, YCB_K) / 1000.0
                         * YCB_FACTOR_DEPTH).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(data, f"{idx}-depth.png"))
        Image.fromarray(rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
                        ).save(os.path.join(data, f"{idx}-color.png"))
        scipy.io.savemat(os.path.join(data, f"{idx}.mat"), {
            "poses": pose[:, :, None], "cls_indexes": np.array([[class_id]]),
            "factor_depth": np.array([[YCB_FACTOR_DEPTH]]),
            "intrinsic_matrix": YCB_K})
        seen = depth.astype(np.float32) / YCB_FACTOR_DEPTH * 1000.0
        for kp, r in enumerate(perfect_radials(seen, pose, kpts9, YCB_K), 1):
            np.save(os.path.join(root, "exact", f"0000_{idx}_pt{kp}.npy"), r)
        ids.append(f"0000_{idx}")
    with open(os.path.join(root, "Split", name, "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


class ExactMaps:
    """``map_source_factory`` of the YCB exact-map route: the tree's exact
    radial maps as f32 tensors on the card, sem = radial != 0."""

    def __init__(self, cfg, class_name):
        import os

        self.dir = os.path.join(cfg.root_dataset, "exact")

    def maps(self, kp, image_u8, frame_id, lmo=False):
        import os

        r = torch.tensor(np.load(os.path.join(self.dir,
                                              f"{frame_id}_pt{kp}.npy")),
                         device=DEVICE)
        return (r != 0).to(torch.float32), r


def phase_lmo_ycb(config, eval_mod, fit, infer, labels, geometry, metrics,
                  train_mod, vote_cuda, heads, root, lm):
    """The LMO and YCB evaluators at full width (phase 11's nets), the
    RGB-only keypoint, ``PoseEstimator.refine`` and the CAD labels, each
    with its checks. Returns the launches of K1 and K2 on each path."""
    import os

    launches = {}
    base = config.Config(root_dataset=root, model_dir=lm["model_dir"])
    write_lmo_tree(root, geometry, lm["cad_m"], lm["kpts9"])
    for route, using in (("network", True), ("precomputed", False)):
        cfg = dataclasses.replace(base, using_ckpts=using)
        res, n, secs = counted_eval(
            vote_cuda, heads, lambda c=cfg: eval_mod.estimate_6d_pose_lmo(
                c, class_names=["ape"], progress=lambda m: None)["ape"])
        say(f"phase 13 LMO {route} route: {res['frames']} frames (frame "
            f"{LMO_UNPOSED} has no pose) in {secs:.1f} s; ADD before ICP "
            f"{res['add_before_icp']}, after ICP {res['add_after_icp']}; "
            f"net_ms_per_frame {res['net_ms_per_frame']:.3f}, "
            f"acc_ms_per_frame {res['acc_ms_per_frame']:.3f}; launches K1 "
            f"{n['vote_counts']} K2 {n['heads_channel_major']}")
        check_route(f"phase 13 LMO {route}", res, n, LM_FRAMES, using,
                    perfect=not using)
        launches[f"LMO {route}"] = n

    yroot = os.path.join(root, "ycb")
    write_ycb_tree(yroot, lm["cad_m"], lm["kpts9"])
    class_id, name = YCB_CLASS
    for i in range(1, 4):   # phase 11's nets serve the YCB class too
        os.symlink(os.path.join(lm["model_dir"], f"ape_pt{i}.pth.tar"),
                   os.path.join(lm["model_dir"], f"{name}_pt{i}.pth.tar"))
    ycfg = dataclasses.replace(base, root_dataset=yroot, dataset="ycb")
    assert (ycfg.ycb_icp_converged, ycfg.icp_rel_tol,
            ycfg.ycb_icp_max_iters) == (True, 1e-6, 10_000)
    updates, finals, icp_args = [], [], []
    icp, refine = fit.icp_point_to_point, eval_mod.refine_and_add

    def counted_icp(*args, **kw):
        rt, n = icp(*args, return_iters=True, **kw)
        updates.append(n)
        finals.append(rt)
        return rt

    def kept_refine(*args, **kw):
        icp_args.append((args, kw))
        return refine(*args, **kw)

    for route, factory in (("network", None), ("exact-map", ExactMaps)):
        updates.clear()
        finals.clear()
        fit.icp_point_to_point = counted_icp
        eval_mod.refine_and_add = kept_refine
        try:
            res, n, secs = counted_eval(
                vote_cuda, heads, lambda f=factory: eval_mod.
                estimate_6d_pose_ycb(ycfg, class_ids=[class_id],
                                     progress=lambda m: None,
                                     map_source_factory=f)["all"])
        finally:
            fit.icp_point_to_point = icp
            eval_mod.refine_and_add = refine
        say(f"phase 13 YCB {route} route: {res['frames']} frames in "
            f"{secs:.1f} s; ADD(-S) AUC before ICP "
            f"{res['adds_auc_before_icp']:.4f}, after "
            f"{res['adds_auc_after_icp']:.4f}; pass rate (1% of the "
            f"diagonal) {res['add_before_icp']} / {res['add_after_icp']}; "
            f"ICP updates a frame {updates}; net_ms_per_frame "
            f"{res['net_ms_per_frame']:.3f}, acc_ms_per_frame "
            f"{res['acc_ms_per_frame']:.3f}; launches K1 "
            f"{n['vote_counts']} K2 {n['heads_channel_major']}")
        check_route(f"phase 13 YCB {route}", res, n, YCB_FRAMES,
                    factory is None, perfect=False)
        if factory is not None:
            check_ycb_exact(fit, res, updates, finals,
                            icp_args[-YCB_FRAMES:], ycfg.ycb_icp_max_iters)
        launches[f"YCB {route}"] = n
    # the exact-map frame with the fewest updates
    first = min(range(YCB_FRAMES), key=updates.__getitem__)
    args, kw = icp_args[-YCB_FRAMES + first]
    wall, dev_ms, _ = profile_ms(lambda: refine(*args, **kw), reps=2)
    last = updates[first]
    say(f"phase 13 YCB converged ICP (exact-map frame {first + 1}, {last} "
        f"updates, "
        f"{lm['cad_m'].shape[0]} CAD points against 3 x {ycfg.max_points}): "
        f"device {dev_ms:.3f} ms ({dev_ms / max(last, 1):.3f} an update), "
        f"wall {wall:.3f} ms (profiler on; one host read of the stop flag "
        f"an update); the LM's 30-iteration ICP: device "
        f"{lm['icp_ms'][1]:.3f} ms ({lm['icp_ms'][1] / 30:.3f} an update)")

    launches["no-depth"] = phase_no_depth(eval_mod, vote_cuda)
    check_refine(config, infer, metrics, train_mod, geometry, lm)
    check_cad_labels(labels, geometry, lm)
    return launches


def check_ycb_exact(fit, res, updates, finals, icp_args, cap):
    """The exact-map route's checks: AUC before ICP >= 0.8 and no lower
    after; the converged ICP's stop test fires (some frame stops under the
    cap). A frame at the cap is a limit cycle of the reference's criteria:
    its next 8 updates' inlier counts and RMSE are printed."""
    if not (res["adds_auc_before_icp"] >= 0.8 and res["adds_auc_after_icp"]
            >= res["adds_auc_before_icp"] - 1e-6):
        raise AssertionError(f"YCB exact maps: AUC {res}")
    if min(updates) >= cap:
        raise AssertionError(f"YCB exact maps: no ICP stopped {updates}")
    for frame, (n, rt, (args, _)) in enumerate(zip(updates, finals,
                                                    icp_args)):
        if n < cap:
            continue
        _, cad, scene, mask, _, _, thr = args
        t2 = (scene * scene).sum(dim=1)
        tail = []
        with torch.inference_mode():
            for _ in range(8):
                src = cad @ rt[:3, :3].T + rt[:3, 3]
                idx, dist = fit._nn(src, scene, t2, mask)
                w = (dist <= thr).to(torch.float32)
                tail.append((int(w.sum()), round(float(torch.sqrt(
                    (w * dist * dist).sum() / w.sum().clamp(min=1))), 6)))
                rt = fit.horn_fit(src, scene[idx], weights=w) @ rt
        say(f"phase 13 YCB exact-map frame {frame + 1} ran to the {cap} cap: "
            f"the next 8 updates' (inliers, RMSE mm) {tail}")


def phase_no_depth(eval_mod, vote_cuda):
    """``tests/test_no_depth.py``'s planar scene at 480x640 (every 4th pixel
    of the scaled patch, 1900 pixels) through the RGB-only keypoint at its
    defaults (2048 points x 32 planes, grid 192): within 10 mm of the truth
    and 1e-2 mm of the CPU's plain versions; K1 launched."""
    k = np.array([[750.0, 0, W / 2], [0, 750.0, H / 2], [0, 0, 1]])
    z0 = 0.72
    mask = np.zeros((H, W), bool)
    mask[175:325:4, 225:425:4] = True
    vs, us = mask.nonzero()
    pts = np.stack([(us - k[0, 2]) * z0 / k[0, 0],
                    (vs - k[1, 2]) * z0 / k[1, 1], np.full(len(us), z0)], 1)
    kpt = np.array([0.02, -0.01, 0.75])
    radial = np.zeros((H, W), np.float32)
    radial[mask] = np.linalg.norm(pts - kpt, axis=1) * 10.0
    out = {}
    for dev in ("cpu", DEVICE):
        torch.cuda.synchronize()
        vote_cuda.vote_counts_cuda.launches = 0
        t0 = time.perf_counter()
        center, overflow, count = eval_mod.keypoint_from_maps_no_depth(
            torch.tensor(mask, dtype=torch.float32, device=dev),
            torch.tensor(radial, device=dev),
            torch.tensor(k, dtype=torch.float32, device=dev), z0 - 0.004,
            100.0, 0.5)
        torch.cuda.synchronize()
        out[dev] = (center.cpu().numpy(), bool(overflow), int(count),
                    vote_cuda.vote_counts_cuda.launches,
                    (time.perf_counter() - t0) * 1e3)
    (c_cpu, _, _, _, ms_cpu), (c, overflow, count, n, ms) = (
        out["cpu"], out[DEVICE])
    err = float(np.linalg.norm(c - kpt * 1000.0))
    diff = float(np.abs(c - c_cpu).max())
    say(f"phase 13 no-depth keypoint: {count} pixels x 32 planes, grid 192; "
        f"center {np.round(c, 3).tolist()} mm, {err:.3f} mm from the truth, "
        f"{diff:.2e} mm from the CPU's; K1 launches {n}; {ms:.1f} ms on "
        f"the card, {ms_cpu:.1f} ms on the CPU (host clock)")
    if not (err < 10.0 and diff <= 1e-2 and n > 0 and not overflow
            and count == int(mask.sum())):
        raise AssertionError(f"no-depth keypoint: {out}")
    return {"vote_counts": n, "heads_channel_major": 0}


def check_refine(config, infer, metrics, train_mod, geometry, lm):
    """``PoseEstimator.refine`` on phase 4's perfect-map frame: the ICP
    from the fitted pose against the frame's own scene keeps ADD at or
    under its value before plus 1e-2 mm (threshold: that ADD, as the
    evaluators set it)."""
    k = geometry.LINEMOD_K
    pose, kpts_m, depth_mm, radials, model_m = render_synthetic_frame(
        np.random.default_rng(0), k)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=DEVICE)

    result = infer._pose_from_maps(
        t(radials > 0), t(radials), t(depth_mm), t(k), t([100.0] * 3),
        t(kpts_m * 1000.0), 0.5, N_POINTS, GRID_L, "hier", False)
    # the estimator's nets take no part in refine: a small one will do
    cfg = config.Config(model_blocks="1,1,1,1", model_width=0.125)
    kp9 = np.zeros((9, 3))
    kp9[1:4] = kpts_m
    est = infer.PoseEstimator(
        cfg, [train_mod.build_model(cfg).state_dict() for _ in range(3)],
        kp9, [100.0] * 3, cad_mm=model_m * 1000.0, k=k)
    cad, gt = t(model_m * 1000.0), pose.copy()
    gt[:, 3] *= 1000.0

    def add(rt):
        return float(metrics.nn_distances(metrics.transform(cad, t(gt)),
                                          metrics.transform(cad, rt)).mean())

    before = add(result["rt"])
    after = add(est.refine(result, max(before, 1e-3)))
    say(f"phase 13 PoseEstimator.refine on phase 4's frame "
        f"({cfg.icp_iters} iterations, {len(model_m)} CAD points): ADD "
        f"{before:.4f} -> {after:.4f} mm")
    if not after <= before + 1e-2:
        raise AssertionError(f"refine raised ADD {before} -> {after}")


def check_cad_labels(labels, geometry, lm):
    """``radial_labels_from_cad`` at 480x640 with phase 11's 3000-point
    CAD, on the card against the CPU: the same sem map, radii within 1e-4
    dm."""
    k = geometry.LINEMOD_K
    pose = pose_at(np.random.default_rng(19), W // 2, H // 2, 0.7, k)
    args = (pose, lm["kpts9"][1], k, 2.0, (H, W))
    want = labels.radial_labels_from_cad(torch.tensor(lm["cad_m"]), *args)
    got = labels.radial_labels_from_cad(
        torch.tensor(lm["cad_m"], device=DEVICE), *args)
    diff = float((got[0].cpu() - want[0]).abs().max())
    same = torch.equal(got[1].cpu(), want[1])
    say(f"phase 13 CAD labels at {H}x{W}: {int((want[1] > 0).sum())} object "
        f"pixels; sem maps equal {same}; radii max |card - CPU| {diff:.2e} dm")
    if not (same and diff <= 1e-4 and bool((want[1] > 0).any())):
        raise AssertionError("CAD labels: card differs from the CPU")


TRAIN_FRAMES = 16
# A YCB-Video training HDF5 for class 002_master_chef_can as h5py 3.14
# (HDF5 1.14.6) writes it, zlib and base64: JPEGImages/0000_000001-4
# (uint8) and 3Dradius_pt1_dm/0000_000001-4 (f32 decimeters, a disk of
# radii 2-4 dm in 1/8 dm steps), each gzip level 9 in four chunks. Reduced
# from 480x640 to 64x96 frames with blocky images so that the script
# carries 5 KB; the machine with the card has no h5py, and the port reads
# the file there with its own reader (readers.Hdf5File).
YCB_TRAIN_HDF5 = (
    "eNrtnAdcU8m6wNMIJSRUaYFLQFxxFzQqSpMiRVBZsKALNkAplqWISBGUhCYgilhxxQByXby6"
    "KotcihISRAXUBSK4IlJXFN0NCSg3AQLJS0hCyaL4e/d5r76dv2HmN5PvnDOZ+WbmzHzjl+Ls"
    "sAItpyUHESAjA0FAFCGT4YloPjQ1Lf7eWxRDRXGyKL4ME+dDx77TEOUrie4vKee+ztFRIM2T"
    "QPycTilhLAMB/BVxdly+RhB7iNKGorgGNlVu1RpHp5WBPgF++4TpxQ6hPr679u/zCglb6OUb"
    "OK6n+I987vv01xkuTO+U+jj9NRMprhloSqC/grR4vJSaKofn4yUI8Asl0osk0osl0iZTxmHx"
    "KL7e1c0BCoGN6y9VZ+p4/VqUlsFNHV9x8Klykvr+VwMKQQrrAipOC3syFC7MsJWYD0XV9d58"
    "OL+FoKJ2gk6qeSl+LEjD4LCxbBQEN5aGjj9XZmxE8vXz/94nzA8iCxG3m7AB4TAEQZSHEz0W"
    "PqkZJ5Xo30OoV4hxfTGU/rC8WP8UjT8sJx7XLzt+WE48jtr6f9l6JZg3BP1Tct6I/8jrqbOE"
    "MREy0egfwl5tahr3Hv2EgiEbAAAAAAAAAAD47Ihs6W1YqETFy1OphL41MpooHMRCK2E5ImG5"
    "up1Jz99V4nRfbCHMjSSqbOlEB/U1OOkeHKDxA8a7qDrpyDh1s0qp9k7kH3np1sOv+YH6cHkP"
    "fFklKqsTFhwS/y+aUDwbdbDiHZTUKeUaQjQtrRyT5Af1B61tjJmDVmNFQPOLAKkk4JP5H9vX"
    "iorIrly83E3Ft/sGHuuV9qftVaYilD2oSLmd3oMv0m24goA92uQJUXH2hmINc6CxI/3Vuvyg"
    "504224gga1BAQKs2EISC3MF9XfURauI7UHVFwmXMHmljj8hkfgFO6SnYLZRPmJvhbKCc4mCd"
    "kuWgn+HczXkjU9gdWsYivm4+sS006DdOi/8l30XnXL46Weu7KGv/0MDLIrLmUaxmtuszP9Ug"
    "3xizDfN5fR4pWE2m6+nVwdJHyAvbswqdgqV9S0qvrq+f3VK5PYBxdf1L2kNicNKzjH1Kfgrh"
    "1M2pJPK9do8FF+k+5g506q3zu0OyHU877WcYHmAti+i2Trl4uMW+CVM8OIuztik0+RXPj1Vz"
    "iFBYVWKZ/IrdzG4wPpwxiOVgUjGL+8/WDgVk8VzYHT28KDipVNub/8MqoWh+K9/JYbsFKkir"
    "jjV5nz9/MQ3lf5dxFVOFV0SMzkskEpOISYnExKQk4ugAac53FhdY2xvuLmnOOPNy4Y7DfSim"
    "cYL9Rl9P1onewnyj2qWep64FHqFDiy8HbI9e8E8mvfd22Wg+9waXLXeAuy1eJ1S3y4vGbdeJ"
    "wYZV7y7PO6BWtof3TT8D0hbPSD5WEk7h0Ht1BrTCqpHl9a1Ms2gmZk18rzMVW9ZxkEVGNhF/"
    "JDvdzku6iTHptnpMfppj2fAWwSheHtF8hm6m/i+GTSsZ83yddo9m+drDgeaEd9+3Jyjayejx"
    "gxrtGMgo9kbGDL+ar+53Bbp2WElmPtwWUqEqQ8TLxONloPIIr96yc44FL9RfGBAQcplU2NIG"
    "al+1SFsYnKg6mHMOQdbIG44e10F1bnkA1GANFaFWQESKVLA6GxXLnSaXc8j68JvLyRPqvtwC"
    "6qNIbKjEyevb6/kaQeBGCSPa5DCZoGULXWGZtjApwaPkxzW7ItsC5Q2TVeWrtkmn6PncLYPv"
    "SFJ4IkKOr9pa44WdPzJUN36HSR1m5PA6w0Z+AU7ojbU8GoWCo/h/aP4/QfxuIO7B4937K/Ac"
    "o95VVfL+rq4rG02+FXyKzCNe2Ry2P6jyC1aHgmlVvofVscG0LmppCz1kGbLagP17qWVItTP7"
    "TMTezmMyDDrZPMSpvj/bJ2LgEbKV1pgd3BF64/pVaMSpVh5rJHhVFcfPe39auVWHDjkb2axU"
    "2xEaq+GBJvPqnvTSDkJL9VIpPYekN6GVRq9y0NSkcyON3VzuaOxP2ylK/LI/zpUj2KpK0di7"
    "TLWOrsij7RxodJR/IOfv1ENlWZZfO2Gw8oRB6pwNe0o5PQVY1mh30rzqvKVpPqby5tjrsSlF"
    "lEBcW04wy60AG1ZmejyoL3HUDR2szr7NK+GYethY1QpqJxeTgFeU4siODQeenikOJP5wEDPc"
    "O+f7t4VRies3hz47m3bxW/916942k9a3JGyIRB3Boxxr7hik3cENzL3QB7MYXJrVQ2Fv4nQs"
    "CVNnPKvl1VAoxMDXKZzGkT1otT+2ZY302rhHwwOpx2iRbiG/NlJYSLpOwY4rkWffkXqaeNeh"
    "lov6N7LvPeuogO4p0EmMrA+pjv4n8tfKhsUH8u8VdF2Jzw0YcL36RKsgnthTnMRtJugU+82p"
    "e9DenL2/+cxRs2+q7Ud+riqm3x3a1f6zh5HakXvb+RGLx4EgK7K7BHWohyHgFR1oVpvmKPN/"
    "3kb96DB/RxU72xP4Pq9F3ICbSpccXFp+2hBI23ht13lWeKP0MLPFcjTdssRy1PXK/RLd0erw"
    "/Of5VylvVozW9f5DsyT90FNWdytmbEPJho5+vWCeQMuXo8c6WvxaDem8eoKgkyUTZPgDfKZd"
    "TUXeaWRlmtexkxBlQ28YqtkWXjVpVDZH4YiwryT13GbaXJLUcVuoyhTtZ3CGIF0vPBon5jbb"
    "VGKDnribCYoxL2Ena+VchA1Jo2SuGRVVXik7vw+qIJzbBmj52W6t2d6P+XNYHCqGKp6v3Oyz"
    "2VyEdCTRlD/rWXuPC+fWR8TGwcupWP6sp1tgLRJvrO+R7nJ5piDWWMWErmh5vraauJbvNNE6"
    "ev+I9S0jUoFR6spS4pDPcHXhvHmXTq1bxQ+Gb8Cfyg223guUzo6OeE7dwX4V/Y1Z7542GIZz"
    "8vnS+IeMtuLWyzZcl6KAkl+Def5OW6+WpMculma7V4dwIiP2pe934e7UbWAwY9ra6VYZvNo6"
    "BjMEZnRhy9r37EtPb5+S3NefyT51XG/qvirgr8X77FOGEhvK/9f2qT/bVYQWAChseruK7Z/2"
    "qzXGLlXC6UIQoh1tdRmIeqzo+/+9PUXYo+AweLP+xFa5wGwsfAxkzSdpB0m7CmGGDX1xv/e2"
    "+LCc2K4yuO7DcuL+f3zfl63PQrsK4k/j3bMZrrsrso9oS+RLnhe4oC6MWyATyjEdZepT74d7"
    "z/1OakxNS8ohwBAFAAAAAAAA8En4gs554eZPvCp6Qz7ROa9/93zSDdF77ceeT1qkOf17sGS9"
    "gvNJAAAAAAAAAADAl7Ce+uzsOyGWE0uNT27feZ9donyG626K1kXbJfIl7QjBWsL4txnWWzSR"
    "nJ+EnOT9bmKnX48BuwQAAAAAAADAf/o9+rO1S5SumHhV9Ib8h+0SCR95vYboQE7iDO/JYrK0"
    "p38PlqxXYJcAAAAAAAAAAAC+hPXUZ2eXkHGfWGr81+wSqTNcpyf6f2YkiXxJO4LtNmF8bob1"
    "VrtI7o6EnOT9IrymX48BuwQAAAAAAADAp0XobiN+jSIio+bBKl8/v5erBC43PFPo+aYGyQ/b"
    "YPuDz9MNXkSEPt1/X2NH2sL7Gu8WGHUeWvokKv78Zvco4sNNqpakzkK1e0mara25LXhidFNu"
    "Ez7uoYUqlrCbUYPuP7vpne2SCPoSw9bOY1//kYnhXp5j6r5D+nb8YzTSna3lzvaKL+t6ii3a"
    "3hYjS1pyudfLlF3ZnEPhoe7lxI05ycnF3OGXjrn4+Gln35e1D8aKV5t/M3n1/F8sqT+rh5/o"
    "t/Rc/FW46fNOnfbOWddDiJiASGKAWeXJ8yxeCK9pZ+wT6t0qCg+nZdGru6Qgg/2drkOVSyll"
    "2HsgXoVRrxuz28OZrWujseSnu5yOJdqWmbXoDdKWG+zDwnBaoU5FYfoRDqudtunQ9IVubgbV"
    "ST827TAf8+GCSsKrOqqP+UDZUr6XJnArsSJ2OELXTJGNoHSrdBCrPDS056NyV8jMQnPmsZOK"
    "i/Ksjqqa0IjHwi4u3vr6a6auPvu7Bb3BrFfDTdwz3PDgoKCizb02558zgyhWzR25Rbx9nLmc"
    "6FP37TlPWGrcY4prU4+0XQtcALn0ZsXtxN5ERFvXxbbHrDuQth0lT8J9Eq7/Gnhta2aOJSVn"
    "a2bu7axbxsUoVNh3L9rOzbp1vj+oeq/22KfivoJhTKrnJAch0Yi7lYZpdnLJYh8hCXY1FddO"
    "IysfedWdl0Ict4VizaiQH8XOnBqZPbElBIHjELi0xriLp8a+nrLNthBZ1QIiXH7cxdOuwXft"
    "xjgCQq6ZCkWOuw0Z4AxB9lalQCZ5nppji5qNW6Zqdx82VgZbQ5ErHmtzN5iHLUzKpIAIdZnk"
    "iidKjQpTNswhoieeVdbXY4XyhsqqNlCRyMkuSi5IFfBLsNMbDp/sogS610h2tcA7SKUsBKcI"
    "r/ym90H/m8b8S0cckxH+X3vYXRF0D4JpeAD7Rl27dRmvuL6ufRuvg5lmXdMuVybsN7CFig58"
    "zXQ2UI5S9kxZluKgz2x0O/7VyVq6HWyr66PV9zeUPw3/QdBrBF0nM9iz5ympdvgcOSrvxWzN"
    "Evo9rA6z1v2hjcXGtyuq55zb/Y+g5NbbL4w1I9xNc6K720746cxCP7hAvlHr7uQH52qGO9V7"
    "plmWQnmPnXmPyLe33S2dvVtjCDkSvKnzoNp6HeMhp7yRs53tNI5Bks7vOl+3425Fh9ukOqJP"
    "c5mMv7Up4IMGB9CHHiJJe4toIh80a+QdKq02pcc76PNolYpGcoW1Lut4PyzdFeZS6HXz24E/"
    "nt7grd9D0hngceyvMbAme5heL0f5tdJXJxtMnCUrqIMbClU4xcSMkydP8+F30O5uA+UUenbF"
    "7Nzal2933vZtONG6mvSbUwWTmpm++NW3B9eqX8nb9LvLhcs7GLYHCzHfBz7gBFpTujmPyW8O"
    "uaGbnEcj6vqC6QobGQ0qlDdZlOoh9gAvXTtJhW48RH4eC3+Dh7Fu3vTC9p/V9u3RDfA6QhlA"
    "noezM6VK/KKVon+hnFRG2ByQZvigWrPIT+im3NnSjC4I+2/RvzzLd7ifrv33alipUvSRZ/k/"
    "YSxxCu51bT/omNOjcvQZZ+hOmFb4kw7CVosQhTe/oR4RL5DjyN16W+2IQ5jWGvtbDtQY06Cx"
    "rs7v5T+6Vjzfyl4LZg/A/799tM/2XMKagImtIm/IZ3ouwVxUIXEz7JOJIXtPvw8mWa/gXAIA"
    "AAAAAAAAAPAlrKc+u3MJOWETS43/2rkE8xmus/ERxhSJfMlzBJEiOccZ1lum26cupHDvuV/M"
    "9unXY+BcAgAAAAAAAMCn5X8AudoICA==")


def write_train_tree(root, geometry):
    """A LINEMOD training-layout tree for class ``ape`` under
    ``<root>/LINEMOD``: TRAIN_FRAMES frames at 480x640 of a 3-4 cm shell
    (4000 points, ``mesh.ply`` in mm) at random rotations 0.65-0.9 m away,
    ``.dpt`` depth, mask PNGs, JPEG images (blurred noise), ``pose*.npy``
    (m), ``Outside9.npy`` (keypoints 1-3 at 0.08 m per axis) and both
    split files. Returns [(image, depth (H, W) f32 mm, pose)], keypoints."""
    import os

    from PIL import Image

    rng = np.random.default_rng(23)
    k = np.asarray(geometry.LINEMOD_K)
    base = os.path.join(root, "LINEMOD", "ape")
    for d in ("JPEGImages", "data", "mask", "pose", "Split"):
        os.makedirs(os.path.join(base, d))
    dirs = rng.normal(size=(4000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    model_mm = dirs * rng.uniform(30.0, 40.0, size=(4000, 1))
    with open(os.path.join(base, "mesh.ply"), "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 4000"
                b"\nproperty float x\nproperty float y\nproperty float z\n"
                b"end_header\n")
        f.write(model_mm.astype("<f4").tobytes())
    kpts9 = rng.uniform(-0.06, 0.06, size=(9, 3))
    kpts9[1:4] = [[0.08, 0.08, 0.08], [-0.08, 0.08, -0.08],
                  [0.08, -0.08, -0.08]]
    np.save(os.path.join(base, "Outside9.npy"), kpts9)
    frames = []
    for i in range(TRAIN_FRAMES):
        pose = pose_at(rng, W // 2 + rng.uniform(-120, 120),
                       H // 2 + rng.uniform(-80, 80), rng.uniform(0.65, 0.9),
                       k)
        pose[:, :3] = random_pose(rng)[:, :3]
        np.save(os.path.join(base, "pose", f"pose{i}.npy"), pose)
        depth = np.round(render_depth(model_mm / 1000.0, pose, k)
                         ).astype(np.uint16)
        with open(os.path.join(base, "data", f"depth{i}.dpt"), "wb") as f:
            f.write(np.asarray([H, W], np.uint32).tobytes())
            f.write(depth.tobytes())
        Image.fromarray(np.where(depth > 0, 255, 0).astype(np.uint8)).save(
            os.path.join(base, "mask", f"{i:04d}.png"))
        coarse = rng.integers(0, 256, size=(H // 16, W // 16, 3))
        img = np.clip(np.kron(coarse, np.ones((16, 16, 1)))
                      + rng.normal(0, 8, size=(H, W, 3)), 0, 255
                      ).astype(np.uint8)
        Image.fromarray(img).save(
            os.path.join(base, "JPEGImages", f"{i:06d}.jpg"))
        frames.append((img, depth.astype(np.float32), pose))
    for split in ("train", "val"):
        with open(os.path.join(base, "Split", f"{split}.txt"), "w") as f:
            f.write("\n".join(f"{i:06d}" for i in range(TRAIN_FRAMES))
                    + "\n")
    return frames, kpts9


def check_launches(what, counts):
    """Raise unless every kernel of ``counts`` ({name: launches}) ran."""
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched: {counts}")


class CliRun:
    """``cli.main`` with the hooks a measurement needs and no change to
    what runs: each train step timed (ending in a synchronize) with its
    loss, the loaders ``make_loaders`` made, the host ms the step loop
    spent getting each train batch, the iteration a resume restored, and
    the launches of ``counters`` ({name: wrapper}) counted from 0 over the
    call."""

    def __init__(self, cli, loader_mod, train_mod, checkpoint, counters):
        self.mods = cli, loader_mod, train_mod, checkpoint
        self.counters = counters

    def __call__(self, argv):
        cli, loader_mod, train_mod, checkpoint = self.mods
        made, times, losses, restored, fetch = [], [], [], [], []
        step, make, restore = (train_mod.train_step, loader_mod.make_loaders,
                               checkpoint.Checkpointer.restore)

        def timed_step(state, batch):
            synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            return state, m

        def made_loaders(*args, **kwargs):
            made.append(make(*args, **kwargs))
            batches = made[-1][0].batches

            def timed_batches(epoch, start_batch=0):
                it = batches(epoch, start_batch)
                while True:
                    t = time.perf_counter()
                    b = next(it, None)
                    if b is None:
                        return
                    fetch.append((time.perf_counter() - t) * 1e3)
                    yield b

            made[-1][0].batches = timed_batches
            return made[-1]

        def restoring(ckpt, state, best=False):
            out = restore(ckpt, state, best=best)
            restored.append(out[2])
            return out

        for f in self.counters.values():
            f.launches = 0
        train_mod.train_step = timed_step
        loader_mod.make_loaders = made_loaders
        checkpoint.Checkpointer.restore = restoring
        try:
            result = cli.main(argv, device=DEVICE)
        finally:
            train_mod.train_step = step
            loader_mod.make_loaders = make
            checkpoint.Checkpointer.restore = restore
        synchronize()
        return {"result": result, "times": times, "losses": losses,
                "fetch": fetch,
                "loaders": made[0] if made else None,
                "restored": restored[0] if restored else None,
                "launches": {n: f.launches for n, f in self.counters.items()}}


def synchronize():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def step_summary(run, warmup=2):
    """(median ms/step after ``warmup`` steps, images/s at TRAIN_BATCH,
    loader wait ms per consumed batch)."""
    ms = float(np.median(run["times"][warmup:]))
    loader = run["loaders"][0]
    wait = loader.stats["wait_s"] * 1e3 / max(loader.stats["batches"], 1)
    return ms, TRAIN_BATCH * 1e3 / ms, wait


def remat_step(config, train_mod, batch, remat):
    """One f32 step at lr 0 from the seeded weights: (gradients, BN
    statistics)."""
    cfg = config.Config(compute_dtype="float32", remat=remat)
    state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                   device=DEVICE)
    state, m = train_mod.train_step(state, batch)
    grads = {n: p.grad.detach().clone()
             for n, p in state.model.named_parameters()}
    stats = {k: v.clone() for k, v in state.model.state_dict().items()
             if k.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))}
    return grads, stats, float(m["loss"])


def remat_memory(config, train_mod, batch, remat, steps=4):
    """Peak device memory (GiB) and median ms of steps 2.. of ``steps``
    bf16 Adam steps at batch TRAIN_BATCH."""
    cfg = config.Config(remat=remat)
    state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                   device=DEVICE)
    synchronize()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        state, m = train_mod.train_step(state, batch)
        synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else float("nan"))
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"remat={remat}: loss {float(m['loss'])}")
    return peak, float(np.median(times[1:]))


def free_memory():
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def phase_cli_train(config, cli, checkpoint, infer, labels, geometry,
                    heads, mmconv, vote_cuda, tmp=None):
    """The port's training-from-disk path through ``cli.main`` at full
    width: check-data, gen-labels, train and resume on the cuDNN route,
    the loader alone, export and a served frame, the K3/K4 route, remat
    against no remat, the YCB HDF5 route with a profile. The labelled tree
    stays in ``tmp`` (a temporary directory when None) for phase 15.
    Returns the kernels' launches on each path."""
    import os
    import shutil

    from rcvpose_tpu_torch import native
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.data import loader as loader_mod
    from rcvpose_tpu_torch.data.dataset import LinemodDataset

    k2 = {"K2": heads.heads_channel_major_cuda,
          "K2-bwd": heads.heads_channel_major_bwd_cuda}
    k34 = {"K3": mmconv.conv_same_cuda, "K4": mmconv.conv_same_dk_cuda}
    paths = {}
    with (contextlib.nullcontext(tmp) if tmp is not None
          else tempfile.TemporaryDirectory()) as tmp:
        root = os.path.join(tmp, "data")
        lm = os.path.join(root, "LINEMOD")
        t0 = time.perf_counter()
        frames, kpts9 = write_train_tree(root, geometry)
        say(f"phase 14 tree: {TRAIN_FRAMES} frames at {H}x{W} (JPEG, .dpt, "
            f"mask PNG, pose, mm mesh.ply) written in "
            f"{time.perf_counter() - t0:.1f} s")

        # 1. check-data: no ERROR finding (the CLI exits 1 on one)
        try:
            cli.main(["--mode", "check-data", "--root_dataset", root,
                      "--class_name", "ape"], device=DEVICE)
        except SystemExit as exc:
            raise AssertionError(f"check-data found errors ({exc})") from exc

        # 2. gen-labels on the card against the CPU's radial_labels
        t0 = time.perf_counter()
        cli.main(["--mode", "gen-labels", "--root_dataset", root,
                  "--class_name", "ape"], device=DEVICE)
        gen_s = time.perf_counter() - t0
        ds = LinemodDataset(lm, "ape")
        depth = torch.tensor(np.stack([f[1] for f in frames]))
        pose = torch.tensor(np.stack([f[2] for f in frames]),
                            dtype=torch.float32)
        worst, labelled = 0.0, 0
        for kp in (1, 2, 3):
            want, _ = labels.radial_labels(
                depth, depth > 0, pose, ds.keypoints[kp].astype(np.float32),
                geometry.LINEMOD_K, ds.max_radii_for([kp])[0])
            got = np.stack([np.load(os.path.join(
                lm, "ape", f"Out_pt{kp}_dm", f"{i:06d}.npy"))
                for i in range(TRAIN_FRAMES)])
            worst = max(worst, float(np.abs(got - want.numpy()).max()))
            labelled += int((want > 0).sum())
        say(f"phase 14 gen-labels: {3 * TRAIN_FRAMES} maps in {gen_s:.1f} s, "
            f"{labelled} labelled pixels, max |card - CPU| {worst:.3g} dm")
        if not (worst <= 1e-5 and labelled > 0):
            raise AssertionError(f"gen-labels: {worst} dm off the CPU")

        # 3. train at full width on the cuDNN route, then resume
        run = CliRun(cli, loader_mod, train_mod, checkpoint, k2)
        logs = os.path.join(tmp, "logs")
        argv = ["--mode", "train", "--root_dataset", lm, "--class_name",
                "ape", "--out_dir", logs]
        first = run(argv + ["--max_iterations", "8"])
        resumed = run(argv + ["--max_iterations", "10", "--resume_train"])
        for name, r, n in (("train", first, 8), ("resume", resumed, None)):
            it = r["result"].iteration
            if it != (n or 10) or not all(map(math.isfinite, r["losses"])):
                raise AssertionError(f"{name}: iteration {it}, losses "
                                     f"{r['losses']}")
        ms, ips, wait = step_summary(first)
        paths["train"] = first["launches"]
        paths["resume"] = resumed["launches"]
        check_launches("phase 14 train", first["launches"])
        say(f"phase 14 train (cuDNN route, batch {TRAIN_BATCH}, bf16 Adam): "
            f"8 steps, ms/step {[round(t, 3) for t in first['times']]} "
            f"(median after 2 {ms:.3f}, {ips:.2f} images/s); loader wait "
            f"{wait:.3f} ms a batch; host ms to get each batch "
            f"{[round(t, 3) for t in first['fetch']]}; losses "
            f"{[round(x, 4) for x in first['losses']]}; launches "
            f"{first['launches']}; resumed at iteration "
            f"{resumed['restored']} to {resumed['result'].iteration}, "
            f"launches {resumed['launches']}")
        if resumed["restored"] not in (4, 8):
            raise AssertionError(f"resume restored {resumed['restored']}")
        del first, resumed
        free_memory()

        # the loader alone: two epochs, labels made on the card
        cfg = cli.config_from_args(["--root_dataset", lm, "--class_name",
                                    "ape"])
        tl, _ = loader_mod.make_loaders(cfg, device=DEVICE)
        rates = []
        for epoch in range(2):
            synchronize()
            t0, n = time.perf_counter(), 0
            for b in tl.batches(epoch):
                n += b["image"].shape[0]
            synchronize()
            rates.append(n / (time.perf_counter() - t0))
        batch = b
        say(f"phase 14 loader alone: {rates[0]:.1f} / {rates[1]:.1f} "
            f"frames/s (epochs 1 / 2, {n} frames each, labels on the "
            f"card); {native.describe()}")

        # 7. export-torch, then the exported weights serve a frame
        ckpts = os.path.join(logs, "lm", "apeKp1", "ckpts")
        exported = os.path.join(tmp, "exported.pth.tar")
        cli.main(["--mode", "export-torch", "--model_dir", ckpts,
                  "--export_path", exported], device=DEVICE)
        shutil.rmtree(logs)
        weights = checkpoint.import_torch_checkpoint(exported)
        maxr = ds.max_radii_for([1, 2, 3])
        cfg3 = config.Config(vote_grid_l=GRID_L)
        est = infer.PoseEstimator(cfg3, [weights] * 3, kpts9, maxr)
        img, depth0, _ = frames[0]
        for net, r in zip(est.models, maxr):
            calibrate_head(net, (img, depth0), cfg3.sem_threshold, float(r))
        serving = {"K1": vote_cuda.vote_counts_cuda,
                   "K2": heads.heads_channel_major_cuda}
        for f in serving.values():
            f.launches = 0
        out = est.estimate(img, depth0)
        synchronize()
        paths["serve exported"] = {n: f.launches for n, f in serving.items()}
        check_launches("phase 14 served frame", paths["serve exported"])
        for key in ("rt", "centers"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"served frame: non-finite {key}")
        say(f"phase 14 export: {os.path.getsize(exported) / 2 ** 20:.1f} "
            f"MiB, served one frame from it: counts "
            f"{out['counts'].cpu().tolist()}, launches "
            f"{paths['serve exported']}")
        del est, weights
        free_memory()

        # 4. the K3/K4 route for 3 steps
        os.environ["RCVPOSE_PALLAS_CONV"] = "on"
        try:
            kr = CliRun(cli, loader_mod, train_mod, checkpoint,
                        {**k2, **k34})(argv + ["--max_iterations", "3"])
        finally:
            del os.environ["RCVPOSE_PALLAS_CONV"]
        shutil.rmtree(logs)
        paths["train K3/K4"] = kr["launches"]
        check_launches("phase 14 K3/K4 route", kr["launches"])
        ms, ips, wait = step_summary(kr, warmup=1)
        say(f"phase 14 train K3/K4 route: 3 steps, ms/step "
            f"{[round(t, 3) for t in kr['times']]} (median after 1 "
            f"{ms:.3f}); loader wait {wait:.3f} ms a batch; launches "
            f"{kr['launches']}")
        del kr
        free_memory()

        # 5. remat against none: one f32 step, TF32 off, deterministic
        # cuDNN; the plain step twice, for its own run-to-run spread
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            g_r, s_r, l_r = remat_step(config, train_mod, batch, True)
            g_p, s_p, l_p = remat_step(config, train_mod, batch, False)
            g_q, _, l_q = remat_step(config, train_mod, batch, False)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        top = max(float(g.abs().max()) for g in g_p.values())
        grad_diff = max(float((g_r[n] - g_p[n]).abs().max()) for n in g_p)
        spread = max(float((g_q[n] - g_p[n]).abs().max()) for n in g_p)
        stat_diff = max(float((s_r[n].double() - s_p[n].double()).abs().max())
                        for n in s_p)
        del g_r, g_p, g_q
        free_memory()
        peaks = {}
        for remat in (False, True):
            peaks[remat] = remat_memory(config, train_mod, batch, remat)
            free_memory()
        say(f"phase 14 remat (f32 step, TF32 off, deterministic cuDNN): "
            f"loss remat / plain / plain {l_r:.9g} / {l_p:.9g} / {l_q:.9g}; "
            f"max |grad diff| remat-plain {grad_diff:.3g}, plain-plain "
            f"{spread:.3g} (largest gradient {top:.3g}); max |BN statistic "
            f"diff| {stat_diff:.3g}; bf16 at batch {TRAIN_BATCH}: peak "
            f"{peaks[False][0]:.2f} GiB, {peaks[False][1]:.3f} ms/step "
            f"without remat, {peaks[True][0]:.2f} GiB, "
            f"{peaks[True][1]:.3f} ms/step with")
        # The forward, loss and BN statistics must be bit-identical; the
        # gradients only within the plain step's own run-to-run spread:
        # bilinear upsampling's backward adds with atomics on the card, so
        # two plain steps differ in the last bits too.
        if (stat_diff != 0.0 or l_r != l_p
                or grad_diff > 2 * spread + 1e-6 * top):
            raise AssertionError("the remat step differs from the plain one")

        # 6 and 8. the YCB HDF5 route, 2 steps, under --profile_dir
        import base64
        import zlib

        ycb = os.path.join(tmp, "ycb")
        name = "002_master_chef_can"
        os.makedirs(os.path.join(ycb, name, "Split"))
        with open(os.path.join(ycb, f"{name}.hdf5"), "wb") as f:
            f.write(zlib.decompress(base64.b64decode(YCB_TRAIN_HDF5)))
        with open(os.path.join(ycb, name, "Split", "val.txt"), "w") as f:
            f.write("".join(f"0000_{i:06d}\n" for i in range(1, 5)))
        prof = os.path.join(tmp, "prof")
        yr = CliRun(cli, loader_mod, train_mod, checkpoint, k2)(
            ["--mode", "train", "--dname", "ycb", "--root_dataset", ycb,
             "--class_name", name, "--batch_size", "2", "--max_iterations",
             "2", "--out_dir", logs, "--profile_dir", prof])
        handle = yr["loaders"][0].ds._h5
        traces = os.listdir(prof)
        paths["train YCB"] = yr["launches"]
        check_launches("phase 14 YCB route", yr["launches"])
        say(f"phase 14 YCB route: 2 steps on 64x96 frames, losses "
            f"{[round(x, 4) for x in yr['losses']]}, HDF5 read by "
            f"{type(handle).__module__}.{type(handle).__name__}; launches "
            f"{yr['launches']}; profile {traces} "
            f"({sum(os.path.getsize(os.path.join(prof, t)) for t in traces) / 2 ** 20:.1f} MiB)")
        if (yr["result"].iteration != 2 or len(traces) != 1
                or not all(map(math.isfinite, yr["losses"]))):
            raise AssertionError(f"YCB route: {yr['result'].iteration} "
                                 f"steps, traces {traces}")
        del yr, handle
        free_memory()
    return paths


# Phase 15: what crosses processes, devices and a socket. The ranks'
# networks are full width; a CPU rehearsal shrinks them with these.
NET_FLAGS = []          # extra cli flags for the networks
NET_SIZE = {}           # create_state keywords for them
RANK_TIMEOUT = 900.0
# one f32 step of two ranks x batch 2 against one process x batch 4: the
# same sums in other orders (E[x^2] - E[x]^2 against cuDNN's BN, the
# ranks' conv algorithms at batch 2)
DDP_METRIC_RTOL = 1e-3
DDP_STATS_ATOL = 1e-3   # x (1 + |statistic|)
SERVE_REQUESTS = 8      # per client, two clients
# the sequential and the data-parallel evaluator on one card: the same
# kernels on the same inputs, held to the frame tolerance of ROADMAP C
DP_SCORE_ATOL_MM = 1e-2


def vote_problems(stages):
    """Keypoint 0's (voxels (V, 3), points (N, 3), lo, hi) at phase 2's
    coarse and refine stages, numpy, N padded to a multiple of 2 with
    masked points."""
    out = {}
    for name in ("coarse", "refine"):
        vox, pts, lo, hi = stages[name][0]
        vox = vox if vox.dim() == 2 else vox[0]
        arrs = [t.cpu().numpy() for t in (vox, pts[0], lo[0], hi[0])]
        if arrs[1].shape[0] % 2:
            arrs[1:] = [np.concatenate([a, np.zeros_like(a[:1])])
                        for a in arrs[1:]]
        out[name] = tuple(arrs)
    return out


def kernel_counters():
    from rcvpose_tpu_torch.ops import heads, vote_cuda

    return {"K1": vote_cuda.vote_counts_cuda,
            "K2": heads.heads_channel_major_cuda,
            "K2-bwd": heads.heads_channel_major_bwd_cuda}


def counted(run):
    """``run()`` with K1's, K2's and K2's backward's launch counts set to
    0 just before and read just after: (result, launches)."""
    counters = kernel_counters()
    synchronize()
    for f in counters.values():
        f.launches = 0
    out = run()
    synchronize()
    return out, {n: f.launches for n, f in counters.items()}


def bn_stats(model):
    return {k: v.detach().double().cpu() for k, v in
            model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def param_digest(model):
    """A sha256 of every parameter's bytes: equal on ranks that have not
    drifted."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def phase15_rank(rank, world, job):
    """One of two gloo ranks on the one card: the points split over the
    ranks, one global-batch f32 step on rows [2 rank, 2 rank + 2) of the
    batch, ``cli.main --mode train --distributed`` and ``cli.main --mode
    test --distributed``, each with its kernels' launches."""
    import gc

    from rcvpose_tpu_torch import cli, parallel
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.config import Config

    global DEVICE
    DEVICE = job["device"]
    dev = torch.device(DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    mesh = parallel.data_mesh(devices=[dev])
    out["votes"] = counted(lambda: {
        name: parallel.sharded_vote_counts(
            mesh, *(torch.as_tensor(a, device=dev) for a in arrs)).cpu()
        for name, arrs in job["votes"].items()})

    def step():
        cfg = Config(compute_dtype="float32")
        state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                       device=dev, **job["net"])
        train, _ = train_mod.make_parallel_steps(mesh)
        rows = slice(2 * rank, 2 * rank + 2)
        batch = {k: torch.as_tensor(v[rows], device=dev)
                 for k, v in job["batch"].items()}
        state, m = train(state, batch)
        # the step's one gradient all-reduce alone, at its size
        flat = torch.zeros(sum(p.numel() for p in state.model.parameters()),
                           device=dev)
        synchronize()
        t = time.perf_counter()
        parallel.all_reduce(flat, mesh.group)
        synchronize()
        return {"metrics": {k: float(v) for k, v in m.items()},
                "stats": bn_stats(state.model), "grad_numel": flat.numel(),
                "allreduce_ms": (time.perf_counter() - t) * 1e3}

    out["step"] = counted(step)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    times = []
    make = train_mod.make_parallel_steps

    def timed_steps(mesh_, accum=1):
        train, ev = make(mesh_, accum)

        def timed(state, batch):
            synchronize()
            t = time.perf_counter()
            res = train(state, batch)
            synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            return res
        return timed, ev

    def train_cli():
        train_mod.make_parallel_steps = timed_steps
        try:
            trainer = cli.main(job["train_argv"], device=job["device_arg"])
        finally:
            train_mod.make_parallel_steps = make
        return {"best_val": trainer.best_val,
                "iteration": trainer.iteration,
                "digest": param_digest(trainer.state.model),
                "times": times}

    out["train"] = counted(train_cli)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["test"] = counted(lambda: cli.main(
        job["test_argv"], device=job["device_arg"])["ape"])
    return out


def lm_frames(readers, root):
    """Phase 11's frames as the LM evaluator reads them: [(frame id,
    decoded image, depth (H, W) f32 mm, pose (3, 4) m)]."""
    import os

    pv = os.path.join(root, "LINEMOD", "ape")
    out = []
    for i in range(LM_FRAMES):
        fid = f"{i:06d}"
        out.append((fid, readers.read_image(
            os.path.join(pv, "JPEGImages", f"{fid}.jpg")),
            readers.read_depth(os.path.join(
                root, "LINEMOD_ORIG", "ape", "data", f"depth{i}.dpt")
            ).astype(np.float32),
            np.load(os.path.join(pv, "pose", f"pose{i}.npy"))))
    return out


def recorded_lm(eval_mod, cfg):
    """The sequential LM evaluator with each frame's scores recorded from
    its ``pose_and_add``/``refine_and_add``: (results, [(bf, af)])."""
    rows = []
    pose_and_add, refine_and_add = eval_mod.pose_and_add, \
        eval_mod.refine_and_add

    def pose_rec(*args):
        rt, score = pose_and_add(*args)
        rows.append([float(score)])
        return rt, score

    def refine_rec(*args, **kw):
        rt2, score = refine_and_add(*args, **kw)
        rows[-1].append(float(score))
        return rt2, score

    eval_mod.pose_and_add, eval_mod.refine_and_add = pose_rec, refine_rec
    try:
        res = eval_mod.estimate_6d_pose_lm(cfg, class_names=["ape"],
                                           progress=lambda m: None)["ape"]
    finally:
        eval_mod.pose_and_add, eval_mod.refine_and_add = (pose_and_add,
                                                          refine_and_add)
    return res, rows


def phase_distributed(config, cli, eval_mod, labels, geometry, train_mod,
                      vote_cuda, k1_stages, root, lm, train_root):
    """Phase 15 (see the module docstring). Returns the kernels' launches
    on each path."""
    import os
    import threading

    import torch.distributed as dist

    from rcvpose_tpu_torch import parallel, serve
    from rcvpose_tpu_torch.data import readers

    paths = {}
    dev = torch.device(DEVICE)
    problems = vote_problems(k1_stages)
    whole = {}
    for name, arrs in problems.items():
        t = [torch.as_tensor(a, device=dev) for a in arrs]
        whole[name] = vote_cuda.vote_counts_cuda(
            t[0], t[1][None], t[2][None], t[3][None])[0].cpu()
        plain = vote_cuda.vote_counts_plain(
            t[0], t[1][None], t[2][None], t[3][None])[0].cpu()
        if not torch.equal(whole[name], plain):
            raise AssertionError(f"phase 15 K1 {name}: unsharded counts "
                                 "differ from the plain version")

    def check_votes(what, got):
        for name, counts in got.items():
            if not torch.equal(counts, whole[name]):
                err = float((counts - whole[name]).abs().max())
                raise AssertionError(f"{what} {name}: sharded counts differ "
                                     f"from the unsharded K1 call ({err})")

    # 1. an NCCL world of one
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{parallel.free_port()}",
        world_size=1, rank=0)
    try:
        mesh = parallel.Mesh((dev,), dist.group.WORLD)
        got, paths["NCCL world of one: votes"] = counted(lambda: {
            name: parallel.sharded_vote_counts(
                mesh, *(torch.as_tensor(a, device=dev) for a in arrs)).cpu()
            for name, arrs in problems.items()})
    finally:
        dist.destroy_process_group()
    check_votes("phase 15 NCCL world of one", got)
    check_launches("phase 15 NCCL votes", {
        "K1": paths["NCCL world of one: votes"]["K1"]})
    say(f"phase 15 {backend} world of one: sharded_vote_counts at the "
        f"serving stages (" + ", ".join(
            f"{n} V={a[0].shape[0]} N={a[1].shape[0]}"
            for n, a in problems.items())
        + ") bit-equal to the unsharded K1 call and its plain version; "
        f"launches {paths['NCCL world of one: votes']}")

    # references of one process: a batch-4 f32 step, the sequential LM
    # evaluator on both routes
    batch = training_batches(labels, geometry, 1, 15)[0]
    state = train_mod.create_state(config.Config(compute_dtype="float32"),
                                   torch.Generator().manual_seed(0),
                                   device=DEVICE, **NET_SIZE)
    state, m = train_mod.train_step(state, batch)
    ref = {"metrics": {k: float(v) for k, v in m.items()},
           "stats": bn_stats(state.model)}
    del state, m
    free_memory()
    base = config.Config(root_dataset=root, model_dir=lm["model_dir"],
                         eval_data_parallel=False)
    seq = {}
    for route, using in (("network", True), ("maps", False)):
        seq[route] = recorded_lm(
            eval_mod, dataclasses.replace(base, using_ckpts=using))
    free_memory()

    # 2. two gloo ranks on the one card
    logs = os.path.join(train_root, "logs15")
    test_out = os.path.join(train_root, "test15")
    job = {
        "device": DEVICE, "device_arg": None if dev.type == "cuda" else DEVICE,
        "net": NET_SIZE, "votes": problems,
        "batch": {k: v.cpu().numpy() for k, v in batch.items()},
        "train_argv": ["--mode", "train", "--distributed", "--root_dataset",
                       os.path.join(train_root, "data", "LINEMOD"),
                       "--class_name", "ape", "--batch_size", "2",
                       "--max_iterations", "3", "--out_dir", logs,
                       *NET_FLAGS],
        "test_argv": ["--mode", "test", "--distributed", "--root_dataset",
                      root, "--model_dir", lm["model_dir"], "--eval_classes",
                      "ape", "--out_dir", test_out, *NET_FLAGS],
    }
    del batch
    t0 = time.perf_counter()
    ranks = parallel.run_ranks(phase15_rank, 2, (job,),
                               timeout=RANK_TIMEOUT, backend="gloo")
    ranks_s = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        check_votes(f"phase 15 gloo rank {r}", out["votes"][0])
        for part in ("votes", "step", "train", "test"):
            paths[f"gloo rank {r}: {part}"] = out[part][1]
        check_launches(f"phase 15 rank {r} votes",
                       {"K1": out["votes"][1]["K1"]})
        check_launches(f"phase 15 rank {r} step",
                       {k: out["step"][1][k] for k in ("K2", "K2-bwd")})
        check_launches(f"phase 15 rank {r} cli train",
                       {k: out["train"][1][k] for k in ("K2", "K2-bwd")})
        check_launches(f"phase 15 rank {r} cli test",
                       {k: out["test"][1][k] for k in ("K1", "K2")})
    merr = {k: max(abs(out["step"][0]["metrics"][k] - ref["metrics"][k])
                   / max(abs(ref["metrics"][k]), 1e-12) for out in ranks)
            for k in ("loss", "loss_r", "acc")}
    serr = max(float(((out["step"][0]["stats"][k] - v).abs()
                      / (1 + v.abs())).max())
               for out in ranks for k, v in ref["stats"].items())
    say(f"phase 15 gloo ranks: 2 processes on the one card in "
        f"{ranks_s:.1f} s; sharded_vote_counts over the two ranks "
        f"bit-equal to the unsharded count on both; one global-batch f32 "
        f"step (2 ranks x batch 2) against one process x batch 4: "
        f"relative error {({k: f'{v:.3g}' for k, v in merr.items()})} "
        f"(tolerance {DDP_METRIC_RTOL}), BN running statistics "
        f"max |diff| / (1 + |stat|) {serr:.3g} (tolerance "
        f"{DDP_STATS_ATOL}); loss one process {ref['metrics']['loss']:.6f},"
        f" ranks {[round(o['step'][0]['metrics']['loss'], 6) for o in ranks]}")
    if max(merr.values()) > DDP_METRIC_RTOL or serr > DDP_STATS_ATOL:
        raise AssertionError("phase 15: the two-rank step is not the "
                             "batch-4 step")
    tr = [out["train"][0] for out in ranks]
    ckpts = sorted(f for _, _, fs in os.walk(logs) for f in fs
                   if f.endswith(".pth.tar"))
    step_ms = float(np.median(tr[0]["times"][1:]))
    st = ranks[0]["step"][0]
    say(f"phase 15 cli train --distributed (2 gloo ranks on one card, "
        f"batch 2 each, bf16 Adam, cuDNN route; a correctness run, not a "
        f"scaling number; gloo's all-reduce of the {st['grad_numel']} f32 "
        f"gradients alone {st['allreduce_ms']:.1f} ms through host "
        f"memory): iterations {[t['iteration'] for t in tr]}, "
        f"best_val {[t['best_val'] for t in tr]}, parameters equal on the "
        f"ranks {tr[0]['digest'] == tr[1]['digest']}, checkpoints {ckpts}; "
        f"rank 0 ms/step {[round(t, 3) for t in tr[0]['times']]} (median "
        f"after 1 {step_ms:.3f}, {4 * 1e3 / step_ms:.2f} images/s of the "
        f"global batch of 4)")
    if (len({t["best_val"] for t in tr}) != 1
            or [t["iteration"] for t in tr] != [3, 3]
            or tr[0]["digest"] != tr[1]["digest"]
            or ckpts != ["ckpt.pth.tar", "model_best.pth.tar"]):
        raise AssertionError("phase 15: the distributed cli train run "
                             "disagrees across ranks")
    with open(os.path.join(test_out, "eval_results.json")) as f:
        written = json.load(f)["ape"]
    one = seq["network"][0]
    keys = ("frames", "add_before_icp", "add_after_icp")
    say(f"phase 15 cli test --distributed (2 gloo ranks, {LM_FRAMES} "
        f"frames, a shard of {LM_FRAMES // 2} each swept sequentially on "
        f"the one card): files "
        f"{sorted(os.listdir(test_out))}, written "
        f"{ {k: written[k] for k in keys} }, one process "
        f"{ {k: one[k] for k in keys} }, eval_processes "
        f"{written.get('eval_processes')}")
    if (os.listdir(test_out) != ["eval_results.json"]
            or any(written[k] != one[k] for k in keys)
            or written.get("eval_processes") != 2
            or any(out["test"][0][k] != one[k] for out in ranks
                   for k in keys)):
        raise AssertionError("phase 15: the distributed cli test run "
                             "differs from one process")

    # 3. data-parallel evaluation on a one-card mesh
    ecfg = eval_mod._dataset_eval_cfg(base)
    models = eval_mod._load_models(ecfg, "ape", dev)
    frames = lm_frames(readers, root)
    mesh = parallel.data_mesh(devices=[dev])
    max_radii = eval_mod._per_kpt_max_radii_dm(lm["cad_m"], lm["kpts9"])

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    rt_gts_mm = np.stack([f[3] for f in frames]).astype(np.float64)
    rt_gts_mm[:, :, 3] *= 1000.0
    threshold_mm = eval_mod.ADD_THRESHOLD["ape"] * 1000.0
    for route, net in (("network", tuple(models)), ("maps", None)):
        rcfg = dataclasses.replace(ecfg, using_ckpts=net is not None)
        source = eval_mod.RadialMapSource(rcfg, "ape",
                                          models if net else None, dev)
        t0 = time.perf_counter()
        scores, launches = counted(lambda: eval_mod._dp_chunk_scores(
            mesh, source, net, [f[1] for f in frames],
            [f[0] for f in frames], np.stack([f[2] for f in frames]),
            rt_gts_mm, np.tile(geometry.LINEMOD_K, (LM_FRAMES, 1, 1)),
            put(max_radii), put(lm["kpts9"][1:4] * 1000.0),
            put(lm["cad_m"] * 1000.0), False, eval_mod._vote_kw(rcfg)))
        secs = time.perf_counter() - t0
        paths[f"DP eval: {route}"] = launches
        got = np.stack([scores["score_bf"].cpu().numpy(),
                        scores["score_af"].cpu().numpy()], 1)
        want = np.asarray(seq[route][1])
        err = float(np.abs(got - want).max())
        add = (float((got[:, 0] <= threshold_mm).mean()),
               float((got[:, 1] <= threshold_mm).mean()))
        say(f"phase 15 sharded_frame_scores, {route} route ({LM_FRAMES}-"
            f"frame chunk, one-card mesh, grid {rcfg.vote_grid_l}, topk "
            f"{rcfg.vote_topk}, {rcfg.icp_iters} ICP): {secs:.2f} s, max "
            f"|score - sequential| {err:.3g} mm (tolerance "
            f"{DP_SCORE_ATOL_MM}), ADD before/after {add}, overflow "
            f"{scores['overflow'].cpu().numpy().astype(int).tolist()}, "
            f"launches {launches}")
        check_launches(f"phase 15 DP {route}",
                       {k: launches[k] for k in
                        (("K1", "K2") if net else ("K1",))})
        if err > DP_SCORE_ATOL_MM or (net is None and add != (1.0, 1.0)):
            raise AssertionError(f"phase 15 DP {route}: scores {got}, "
                                 f"sequential {want}")
    try:
        eval_mod.estimate_6d_pose_lm(dataclasses.replace(
            ecfg, eval_data_parallel=True), class_names=["ape"],
            progress=lambda m: None)
    except ValueError as exc:
        say(f"phase 15 eval_data_parallel=True on this one-card machine "
            f"raises ValueError: {exc}")
    else:
        raise AssertionError("eval_data_parallel=True on one card ran")
    del models
    free_memory()

    # 4. serving over the socket
    scfg = config.Config(root_dataset=root, model_dir=lm["model_dir"])
    est = serve.build_lm_estimator(scfg, "ape")
    srv = serve.PoseServer(est, warmup_hw=(H, W), class_name="ape")
    addr = srv.start(port=0)
    replies = [[], []]
    errors = []

    def client(i):
        c = serve.PoseClient(*addr)
        try:
            if c.ping() != {"ok": True, "pong": True}:
                raise AssertionError("ping")
            for j in range(SERVE_REQUESTS):
                f = frames[(i + j) % LM_FRAMES]
                icp = j % 2 == 1
                t = time.perf_counter()
                rep = c.pose(f[1], f[2], icp=icp)
                replies[i].append((f[0], icp, rep,
                                   (time.perf_counter() - t) * 1e3))
        except Exception as exc:  # surfaced below
            errors.append(exc)
        finally:
            c.close()

    def both():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=RANK_TIMEOUT)

    _, launches = counted(both)
    paths["serve over the socket"] = launches
    try:
        if errors:
            raise errors[0]
        c = serve.PoseClient(*addr)
        try:
            bad = c.raw({"op": "pose", "h": 4})
            alive = c.ping()
            alone = []     # one client, plain requests, nothing queued
            for f in frames:
                t = time.perf_counter()
                if not c.pose(f[1], f[2])["ok"]:
                    raise AssertionError("phase 15 serve: a plain request")
                alone.append((time.perf_counter() - t) * 1e3)
        finally:
            c.close()
    finally:
        srv.shutdown()
    direct, est_ms = {}, []
    for fid, img, depth, _ in frames:
        synchronize()
        t = time.perf_counter()
        res = est.estimate(img, depth)
        synchronize()
        est_ms.append((time.perf_counter() - t) * 1e3)
        rt2 = est.refine(res, threshold_mm=20.0)
        direct[fid] = {k: res[k].double().cpu().numpy()
                       for k in ("rt", "centers", "counts")}
        direct[fid]["rt_icp"] = rt2.double().cpu().numpy()
    worst = {"rt": 0.0, "centers": 0.0}
    flat = [r for rs in replies for r in rs]
    for fid, icp, rep, _ in flat:
        want = direct[fid]
        if not rep["ok"] or rep["device"] != 0 or \
                rep["counts"] != want["counts"].tolist():
            raise AssertionError(f"phase 15 serve: reply {rep}")
        worst["rt"] = max(worst["rt"], float(np.abs(
            np.asarray(rep["rt"]) - want["rt_icp" if icp else "rt"]).max()))
        worst["centers"] = max(worst["centers"], float(np.abs(
            np.asarray(rep["centers"]) - want["centers"]).max()))
    req_ms = float(np.median([r[3] for r in flat]))
    say(f"phase 15 serve over the socket: 2 concurrent PoseClients x "
        f"(ping + {SERVE_REQUESTS} pose requests, every second one with "
        f"ICP) on {LM_FRAMES} frames at {H}x{W}, devices "
        f"{sorted({r[2]['device'] for r in flat})}; replies against a "
        f"direct estimate/refine: counts equal, max |rt diff| "
        f"{worst['rt']:.3g}, max |centers diff| {worst['centers']:.3g} mm; "
        f"a malformed request answered {bad}, then ping {alive}; median "
        f"request {req_ms:.3f} ms (client wall clock, two clients sharing "
        f"the card's lock, ICP on half); one client's plain requests "
        f"{[round(t, 3) for t in alone]} ms (median "
        f"{float(np.median(alone)):.3f}) beside a median direct estimate "
        f"{float(np.median(est_ms)):.3f} ms (host clock, ending in a "
        f"synchronize); launches {launches}")
    check_launches("phase 15 serve", {k: launches[k] for k in ("K1", "K2")})
    if (len(flat) != 2 * SERVE_REQUESTS or bad.get("ok") is not False
            or not alive.get("ok") or worst["rt"] > 1e-3
            or worst["centers"] > 1e-3):
        raise AssertionError("phase 15: the served replies differ from "
                             "a direct estimate")
    return paths


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs the card",
              file=sys.stderr)
        return 1
    from rcvpose_tpu_torch import (checkpoint, cli, config, fit, geometry,
                                   infer, labels, metrics)
    from rcvpose_tpu_torch import eval as eval_mod
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.models import fcnresnet as fcn
    from rcvpose_tpu_torch.ops import heads, mmconv, vote_cuda, voting

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    seconds = {}

    def run(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        say(f"phase {phase} took {seconds[phase]} s")
        return out

    run(1, phase_build, vote_cuda)
    k1_stages = run(2, phase_vote, voting, vote_cuda)
    k2_input, k2_err = run(3, phase_heads, heads)
    run(4, phase_frame, infer, geometry)
    launches = run(5, phase_serving, infer, train_mod, fcn, voting, config,
                   vote_cuda, heads)
    k1, k2 = run(6, phase_kernel_times, k1_stages, k2_input, vote_cuda,
                 heads)
    errs = run(7, phase_conv_kernels, mmconv, heads)
    train_launches = run(8, phase_training, config, train_mod, labels,
                         geometry, checkpoint, infer, mmconv, heads)
    times = run(9, phase_train_kernel_times, mmconv, heads)
    stages, var_errs, var_launches, scripts = run(
        10, phase_vote_variants, voting, vote_cuda, geometry)
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as train_root:
        lm = run(11, phase_lm_eval, config, eval_mod, train_mod, fcn,
                 geometry, vote_cuda, heads, root)
        var_times = run(12, phase_variant_times, stages, vote_cuda,
                        scripts["tiles"]["best"])
        eval_launches = run(13, phase_lmo_ycb, config, eval_mod, fit, infer,
                            labels, geometry, metrics, train_mod, vote_cuda,
                            heads, root, lm)
        cli_launches = run(14, phase_cli_train, config, cli, checkpoint,
                           infer, labels, geometry, heads, mmconv, vote_cuda,
                           train_root)
        dist_launches = run(15, phase_distributed, config, cli, eval_mod,
                            labels, geometry, train_mod, vote_cuda,
                            k1_stages, root, lm, train_root)
    say(f"phase seconds {seconds}, total {sum(seconds.values()):.1f}")
    say(f"phase 13 launches by path: {eval_launches}")
    say(f"phase 14 launches by path: {cli_launches}")
    say(f"phase 15 launches by path: {dist_launches}")

    main_path = ("coarse", "refine")
    kernels = [
        {"name": "vote_counts", "route": "cuda",
         "source": "rcvpose_tpu_torch/csrc/vote.cu",
         "replaces": "rcvpose_tpu/ops/vote_pallas.py:165",
         "launches": launches["vote_counts"],
         "max_abs_err": max(err for _, err in k1_stages.values()),
         "ms": sum(k1[s]["ms"] for s in main_path),
         "plain_ms": sum(k1[s]["plain_ms"] for s in main_path),
         "bound_ms": sum(k1[s]["bound_ms"] for s in main_path),
         "bound_by": "operations", "library_ms": None},
        {"name": "heads_channel_major", "route": "cuda",
         "source": "rcvpose_tpu_torch/csrc/heads.cu",
         "replaces": "rcvpose_tpu/ops/layout.py:25",
         "launches": launches["heads_channel_major"],
         "max_abs_err": max(k2_err, errs["heads_channel_major"]),
         "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "bytes", "library_ms": k2["library_ms"]},
    ]
    new = (("heads_channel_major_bwd", "rcvpose_tpu_torch/csrc/heads.cu",
            "rcvpose_tpu/ops/layout.py:53", "bytes"),
           ("conv_same", "rcvpose_tpu_torch/csrc/mmconv.cu",
            "rcvpose_tpu/ops/mmconv_pallas.py:215", "operations"),
           ("conv_same_dk", "rcvpose_tpu_torch/csrc/mmconv.cu",
            "rcvpose_tpu/ops/mmconv_pallas.py:261", "operations"))
    for name, source, replaces, bound_by in new:
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": train_launches[name],
                        "max_abs_err": errs[name], "bound_by": bound_by,
                        **times[name]})
    for name, replaces in (
            ("vote_counts_mxu", "rcvpose_tpu/ops/vote_pallas.py:115"),
            ("vote_counts_bf16", "scripts/prof_vote_bf16.py:116"),
            (K6_BF16_COMPARE, "rcvpose_tpu/ops/vote_pallas.py:201"),
            ("vote_counts_tiled", "scripts/prof_vote_tiles.py:17")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "rcvpose_tpu_torch/csrc/vote.cu",
                        "replaces": replaces,
                        "launches": var_launches[name],
                        "max_abs_err": var_errs[name],
                        "bound_by": "operations", "library_ms": None,
                        **var_times[name]})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
