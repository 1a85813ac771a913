#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``rcvpose_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line:

1. build the kernels from ``rcvpose_tpu_torch/csrc`` with nvcc into a
   fresh temporary library directory (``utils.enable_compile_cache``, the
   ``--compile_cache_dir`` of the CLI: the cold start), print the card's
   name and
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
   fused mode, with K1's, K2's and the conv epilogue's launch counters
   reset just before and read just after (the epilogue 162 times a net
   forward, eager, captured or replayed), then a profiler view of where a
   frame's time goes;
6. the device time of each kernel (CUDA events behind a spin kernel), its
   plain version and its bound, at the shapes of phases 2 and 3, K2 also
   at the fused and training shapes beside an empty kernel's time (after
   serving, so that no profiler has run before the serving times are
   taken); then the conv epilogue (``ops/epilogue.py``, the serving nets'
   folded units) against its plain version bit for bit at every unit shape
   of a serving forward, its rounding at identity batch norm statistics,
   and its cold device times beside its plain version's, the unfolded
   ops' and its byte bound, at four unit shapes and over one forward's 162
   units (phase "6 epilogue");
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
    ``prof_vote_tiles`` and ``prof_vote_bf16``; then the hier-vs-exact
    agreement study (``scripts.hier_exact_agreement``) cut to a few frames
    a scene at grid 128 and 8192 points: one exact-mode frame's K1 counts
    (128^3 voxels x 8192 points) against the plain version, then
    ``run_suite`` on the single, cluttered and mask-bleed scenes (K1
    counted);
11. the LINEMOD evaluator ``eval.estimate_6d_pose_lm`` at full width
    (DenseFCNResNet152, bf16, 480x640, grid 192, 8192 points, topk 64,
    30 ICP iterations) on a rendered LINEMOD-layout tree: 3-net
    ``.pth.tar`` checkpoints with calibrated heads (K2 and K1 counted) and
    the precomputed-map route, which must score ADD 1.0 before and after
    ICP; then the ICP's device time;
    then the ICP kernels (``ops/icp_cuda.py``) at the refine cell's shapes
    (phase 11's 3,000-point CAD against one 8,192-point scene cloud at
    800 mm, and against its three copies with masks of their own):
    ``nearest_cuda`` against ``fit._nn`` and ``update_pose_cuda`` against
    ``fit._update_pose`` bit for bit over a few updates; their launch
    counts, set to 0 just before, over three ``PoseEstimator.refine``
    calls (eager and capture, then two replays of its graph) and one
    ``eval.refine_and_add`` (eager, over the copies), whose poses all
    equal the tensor ops' ICP over the copies bit for bit; and the
    kernels' device times beside their plain versions and bounds, and a
    refinement's;
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
    memory and ms/step of each in bf16), and YCB from a raw 480x640
    YCB-Video tree (PNG colour, depth and label, ``.mat`` metas,
    ``points.xyz`` and ``Outside9.npy``): ``gen-labels --dname ycb`` on the
    card twice through the port's own HDF5 writer (labels within 1e-5 dm
    of the CPU's ``radial_labels``; the second run keeps the images, their
    stored chunks unchanged, and replaces the maps), 2 training steps from
    the file under ``--profile_dir`` and ``--mode test`` (the YCB
    evaluator, K1 and K2) on the trained net;
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
    K2's launches on each path;
16. the JAX package's orbax checkpoints, read without JAX, orbax,
    tensorstore or zstandard (the port's ``native/zstd.cpp``, ``ocdbt.py``
    and ``orbax_read.py``): the orbax directory the script carries
    (``ORBAX_DIR``, written by orbax: OCDBT, zarr v2, zstd level 1) against
    the seeded arrays bit for bit, with the decoder's block, literal and
    sequence-table modes and its decode rate on the level-1 chunk; then,
    in phase 11's tree, full-width orbax trees written by the script's
    own writer (``write_orbax``: the same layout, Raw-block zstd frames)
    from phase 11's nets: the read time and rate of one net, ``cli
    --mode test`` on ``<class>_pt<k>/model_best/`` against phase 15's
    record of the ``.pth.tar`` route (every frame's scores equal), the
    fused route (``<class>/``) against its ``.pth.tar`` twin, and
    ``--mode export-torch`` of a ``ckpt/`` that also holds Adam's state
    (the bytes read against the bytes on disk), with K1's and K2's
    launches on each path;
17. the bench family on the card, each through its ``main`` with the
    counts set to 0 just before and read just after: ``rcvpose_tpu_torch.
    bench`` at full width with its reps cut (``reps_scale``),
    ``scripts.bench_train`` for 2 steps on the cuDNN and the K3/K4 route,
    ``bench_serving_latency`` with 16 requests, ``bench_train_loop`` for 4
    steps and ``bench_eval_prefetch`` on 4 frames: each last line one
    JSON record whose times are finite and > 0, whose ``device`` names
    the card and whose ``mfu_vs_bf16_peak`` is at most 1, and K1, K2, K2's
    backward, K3 and K4 launched where each path runs them (the
    ``kernels`` line gains ``bench_launches``); then a full-width training
    state saved with ``Checkpointer(async_save=True)`` against
    ``async_save=False``: equal after ``torch.load``; then
    ``scripts.bench_compile_cache``'s warm child, a fresh process, against
    phase 1's library directory: nothing compiled, the serving libraries
    loaded faster than phase 1 built them, its first and second
    ``estimate`` timed with K1 and K2 launched;
18. the learned end-to-end proofs (``rcvpose_tpu_torch.scripts.e2e_*``),
    each through its ``main`` with the counts set to 0 just before and
    read just after, under its own gate: the synthetic 3-net proof at its
    defaults (render, labels, DenseFCNResNet152 trained 600 steps a net at
    256x320, bf16 Adam, save and restore, serve and ICP; ADD pass rate >=
    0.75), then with the steps cut (``E2E_STEPS``) ``--fused`` (>= 0.75),
    the LMO evaluator from a learned fused net (pass fraction >= 0.85),
    the YCB evaluator on 4 test frames (ADD AUC >= 0.85) and ``--fused``
    on the K3/K4 route (>= 0.75); then the overflow retry (both
    frames scored, one through the grid-256 retry); K1, K2, K2's backward,
    K3 and K4 launched where each path runs them (the ``kernels`` line
    gains ``e2e_launches``).

The vote kernels' bounds count instructions at the card's issue rate
(``vote_cuda.ISSUE_RATE``), not FLOPs at the FP32 peak: none of their
operations is an FMA.

Then a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line; without a CUDA card it exits 1 at once. Weights are seeded random
(no checkpoint ships with the repository); phase 18 trains its own.
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
# tensor-core rate, FP32 rate off the tensor cores, HBM3 bandwidth; L2 size.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20

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
# The conv epilogue (ops/epilogue.py): its launches a serving net forward
# (the folded units of DenseFCNResNet152, models/folded.py) and the bf16
# unit shapes timed one by one: (name, (N, C, H, W), residual), ReLU on
EPILOGUE_UNITS = 162
EPILOGUE_SHAPES = [("stem", (1, 64, 240, 320), False),
                   ("stage3 conv3", (1, 1024, 30, 40), True),
                   ("stage4 conv3", (1, 2048, 15, 20), True),
                   ("conv7", (1, 32, H, W), False)]
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
    """``scripts.profile_ms``: (wall ms with the profiler on, device ms
    summed from the device's own events, device ms by kernel name) of one
    call of ``fn`` over ``reps`` calls."""
    from rcvpose_tpu_torch.scripts import profile_ms as prof

    return prof(fn, reps, warmup)


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
        f"({len(logs)} compiled now) into {_build.BUILD_DIR}")
    say(card_line())
    try:
        import PIL
        pil = f"PIL {PIL.__version__} imports"
    except ImportError as exc:
        PIL, pil = None, f"PIL does not import ({exc})"
    say(f"phase 1 {pil}")
    check_vote_sass(vote_cuda)
    return secs


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
        check_k1_live(voting, vote_cuda, name, stages[name], out)
    return out


def live_bounds(b, n):
    """Per-row live-point bounds for a batch of ``b`` rows of ``n`` points:
    each of none, 33, a middle value and all in every row position, so the
    rows of a batch differ."""
    values = (0, 33, n // 2 + 7, n)
    return [tuple(values[(shift + i) % 4] for i in range(b))
            for shift in range(4)]


def check_k1_live(voting, vote_cuda, name, args, out):
    """K1 at one serving stage with each row's points masked from its bound
    on (``live_bounds``), given the bound as an ``n_live`` tensor and as
    ``voting.vote_counts`` derives it from ``hi`` on the card (the main
    path's call): each equal to the plain version, repeat bit for bit."""
    vox, pts, lo, hi = args
    b, n = hi.shape
    idx = torch.arange(n, device=pts.device)[None]
    derived = []
    for bounds in live_bounds(b, n):
        n_live = torch.tensor(bounds, dtype=torch.int32, device=pts.device)
        keep = idx < n_live[:, None].long()
        a = (vox, pts, torch.where(keep, lo, 0.0), torch.where(keep, hi, 0.0))
        want = vote_cuda.vote_counts_plain(*a)
        before = vote_cuda.vote_counts_cuda.live_bounded
        runs = [vote_cuda.vote_counts_cuda(*a, n_live=n_live)
                for _ in range(2)] + [voting.vote_counts(*a) for _ in range(2)]
        torch.cuda.synchronize()
        if vote_cuda.vote_counts_cuda.live_bounded != before + 4:
            raise AssertionError(
                f"K1 {name} bounds {bounds}: "
                f"{vote_cuda.vote_counts_cuda.live_bounded - before} "
                f"bounded launches of 4")
        got = voting.live_extent(a[3] > 0).tolist()
        if any(g > w for g, w in zip(got, bounds)):
            raise AssertionError(f"K1 {name}: derived bound {got} past the "
                                 f"mask's {bounds}")
        derived.append(got)
        err = max(float((r - want).abs().max()) for r in runs)
        out[name] = (out[name][0], max(out[name][1], err))
        if not all(torch.equal(r, want) for r in runs):
            raise AssertionError(f"K1 {name} bounds {bounds}: differs from "
                                 f"the plain version (max |diff| {err}) or "
                                 f"between runs")
    say(f"phase 2 K1 {name} live bounds {live_bounds(b, n)} (derived from "
        f"hi: {derived}): given and derived, each equal to the plain "
        f"version, repeat bit for bit")


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
            calibrate_head(net.net, frames[0], cfg3.sem_threshold,
                           max_radii[0])
    say(f"phase 5 weights: seeded init, load and head calibration of 4 "
        f"full-width nets in {time.perf_counter() - t0:.1f} s")

    from rcvpose_tpu_torch.models import folded
    from rcvpose_tpu_torch.ops import epilogue

    epi = epilogue.conv_epilogue_cuda
    for est in (est3, estf):
        units = sum(isinstance(m, folded._Unit)
                    for m in est.models[0].net.modules())
        if units != EPILOGUE_UNITS:
            raise AssertionError(f"a served net has {units} folded units, "
                                 f"not {EPILOGUE_UNITS}")
    from rcvpose_tpu_torch import profiling

    def poses():
        # one pose a frame, one more for each escalation's re-run
        return sum(v for k, v in profiling.counters().items()
                   if k.startswith("escalations."))

    torch.cuda.synchronize()
    k1 = vote_cuda.vote_counts_cuda
    k1.launches = 0
    k1.live_bounded = 0
    heads.heads_channel_major_cuda.launches = 0
    epi.launches = 0
    for name, est in (("3-net", est3), ("fused", estf)):
        k1_0 = k1.launches
        k2_0 = heads.heads_channel_major_cuda.launches
        times, outs, epi_frames, bounded = [], [], [], []
        for frame in frames:
            # K2 launches once a net forward, so the epilogue's launches a
            # frame are EPILOGUE_UNITS times K2's on the first (eager, then
            # captured) forward of each net and on every replay alike
            e0, f0 = epi.launches, heads.heads_channel_major_cuda.launches
            b0, p0 = k1.live_bounded, poses()
            t, out = serve(est, [frame])
            times += t
            outs += out
            forwards = heads.heads_channel_major_cuda.launches - f0
            epi_frames.append(epi.launches - e0)
            if (forwards < len(est.models)
                    or epi_frames[-1] != EPILOGUE_UNITS * forwards):
                raise AssertionError(
                    f"{name}: frame {len(epi_frames)} launched the epilogue "
                    f"{epi_frames[-1]} times over {forwards} net forwards, "
                    f"not {EPILOGUE_UNITS} a forward")
            # both hier stages of every pose vote with the live bound
            bounded.append(k1.live_bounded - b0)
            if bounded[-1] != 2 * (1 + poses() - p0):
                raise AssertionError(
                    f"{name}: frame {len(bounded)} gave K1 a live bound "
                    f"{bounded[-1]} times over {1 + poses() - p0} poses, "
                    f"not 2 a pose")
        k1_frame = (k1.launches - k1_0) / len(frames)
        k2 = (heads.heads_channel_major_cuda.launches - k2_0) / len(frames)
        for out in outs:
            for key in ("rt", "centers", "escalate"):
                if not torch.isfinite(out[key]).all():
                    raise AssertionError(f"{name}: non-finite {key}")
        say(f"phase 5 serving {name}: {len(frames)} frames, ms/frame after "
            f"warm-up {[round(x, 3) for x in times[2:]]} (median "
            f"{np.median(times[2:]):.3f}), first {times[0]:.1f} ms; "
            f"launches/frame K1 {k1_frame:.1f} K2 {k2:.1f}, epilogue by "
            f"frame {epi_frames}, K1 live-bounded by frame {bounded}; "
            f"escalate "
            f"{outs[-1]['escalate'].cpu().tolist()}, counts "
            f"{outs[-1]['counts'].cpu().tolist()}")
    launches = {"vote_counts": vote_cuda.vote_counts_cuda.launches,
                "heads_channel_major": heads.heads_channel_major_cuda.launches,
                "conv_epilogue": epi.launches}
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

    # information only: bf16 serving forward (batch norm folded) against
    # the unfolded f32 one (TF32 off) of the same bf16 weights
    net = est3.models[0].net
    f32 = train_mod.build_model(cfg3)
    f32.load_state_dict({k: v.to(torch.bfloat16).float()
                         for k, v in weights(cfg3, 0).items()})
    with torch.no_grad():   # the calibrated head
        f32.conv8.weight.copy_(net.conv8.weight)
        f32.conv8.bias.copy_(net.conv8.bias)
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


def serving_units(fcn):
    """(shape, residual, relu) of each folded unit of one full-width
    DenseFCNResNet152 forward (bf16, channels-last, H x W), in order, read
    by forward hooks."""
    from rcvpose_tpu_torch.models import folded

    with torch.device(DEVICE):
        net = fcn.DenseFCNResNet152(output_channels=6)
    net = net.to(dtype=torch.bfloat16,
                 memory_format=torch.channels_last).eval()
    f = folded.fold_for_serving(net)
    units = []
    for m in f.modules():
        if isinstance(m, folded._Unit):
            m.register_forward_hook(lambda mod, args, out: units.append(
                (tuple(out.shape), len(args) > 1, mod.relu)))
    with torch.inference_mode():
        f(torch.zeros(1, H, W, 3, device=DEVICE))
    return units


def epilogue_bytes(shape, residual):
    """The epilogue's bytes in bf16: ``x`` read and written, the residual
    read, the f32 scale and shift read."""
    n = math.prod(shape)
    return n * 2 * (3 if residual else 2) + 8 * shape[1]


def epilogue_operands(shape, residual, relu, gen, identity=False):
    """One unit's bf16 channels-last operands: the conv's output ``x``
    (and the residual), f32 scale and shift (random, or 1 and 0 so that
    repeated in-place calls stay finite), and the bf16 eval batch norm
    parameters (mean 0, var 1, weight 1, bias 0) of the unfolded route."""
    c = shape[1]

    def act():
        return torch.randn(*shape, device=DEVICE, generator=gen).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    if identity:
        scale = torch.ones(c, device=DEVICE)
        shift = torch.zeros(c, device=DEVICE)
    else:
        scale = torch.rand(c, device=DEVICE, generator=gen) + 0.5
        shift = torch.randn(c, device=DEVICE, generator=gen)
    zero = torch.zeros(c, device=DEVICE, dtype=torch.bfloat16)
    one = torch.ones(c, device=DEVICE, dtype=torch.bfloat16)
    return dict(x=act(), scale=scale, shift=shift,
                res=act() if residual else None, relu=relu,
                bn=(zero, one, one, zero))


def epilogue_pass(epilogue, sets, route):
    """A callable that runs ``route`` once on each operand set: "kernel"
    (``conv_epilogue_cuda``), "plain" (``conv_epilogue_plain``) or
    "unfolded" (eval ``F.batch_norm`` with bf16 parameters, the residual
    add and ReLU, as the unfolded net runs them)."""
    import torch.nn.functional as F

    fn = {"kernel": epilogue.conv_epilogue_cuda,
          "plain": epilogue.conv_epilogue_plain}.get(route)

    def run():
        for s in sets:
            if fn is not None:
                fn(s["x"], s["scale"], s["shift"], s["res"], s["relu"])
                continue
            mean, var, w, b = s["bn"]
            y = F.batch_norm(s["x"], mean, var, w, b, False, 0.0, 1e-5)
            if s["res"] is not None:
                y = y + s["res"]
            if s["relu"]:
                F.relu(y)
    return run


def identity_bn_rounding(epilogue, shape, seed=0, device=None):
    """The fold's rounding at the benchmark's batch norm statistics (mean
    0, var 1, weight 1, bias 0, so scale = rsqrt(1 + 1e-5), 5e-6 below 1)
    on a residual unit, ``x`` and the residual N(0, 1) in bf16: the share
    of ``x + residual`` that are exact bf16 ties, the share of outputs in
    which the folded unit (``conv_epilogue``) differs from the unfolded
    one (eval ``F.batch_norm``, ``+ residual``, ReLU), and each one's mean
    error against the f64 value as a share of its mean magnitude. Runs on
    the CPU too (``device="cpu"``), where the plain version stands in for
    the kernel bit for bit."""
    import torch.nn.functional as F

    device = device or DEVICE
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x, res = (torch.randn(*shape, device=device, generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for _ in range(2))
    one = torch.ones(c, device=device, dtype=torch.bfloat16)
    zero = torch.zeros(c, device=device, dtype=torch.bfloat16)
    scale = one.float() * torch.rsqrt(one.float() + 1e-5)
    folded = epilogue.conv_epilogue(x.clone(), scale, zero.float(), res)
    unfolded = F.relu(F.batch_norm(x, zero, one, one, zero, False, 0.0,
                                   1e-5) + res)
    exact = torch.relu(x.double() / math.sqrt(1 + 1e-5) + res.double())
    total = x.float() + res.float()
    size = exact.abs().mean()
    return {
        "ties": float(((total.view(torch.int32) & 0xFFFF) == 0x8000)
                      .double().mean()),
        "differ": float((folded.view(torch.int16)
                         != unfolded.view(torch.int16)).double().mean()),
        "bias_folded": float((folded.double() - exact).mean() / size),
        "bias_unfolded": float((unfolded.double() - exact).mean() / size)}


def phase_epilogue(fcn):
    """The conv epilogue (``ops/epilogue.py``): the kernel against its plain
    version bit for bit in bf16 channels-last at every unit shape of a
    full-width serving forward, with and without the residual and ReLU;
    then device times (CUDA events) of the kernel, its plain version and
    the unfolded ops at ``EPILOGUE_SHAPES`` and over the
    ``EPILOGUE_UNITS`` units of one forward, beside the byte bound. Each
    shape is timed cold: its calls cycle through enough operand sets to
    pass four times the L2, and one forward's units hold 0.3 GB. One
    forward's units are queued once a timed run: five runs of 162 calls
    outlast the spin kernel this late in the script and read the host's
    launch rate (2.15 ms against 0.76 ms a forward). Returns
    the ``conv_epilogue`` row of the ``kernels`` line (``ms`` etc. over one
    forward's units, ``shapes`` one by one)."""
    from rcvpose_tpu_torch.ops import epilogue

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    units = serving_units(fcn)
    if len(units) != EPILOGUE_UNITS:
        raise AssertionError(f"a forward ran {len(units)} folded units")
    shapes = sorted({shape for shape, _, _ in units})
    for shape in shapes:
        for residual in (False, True):
            for relu in (False, True):
                s = epilogue_operands(shape, residual, relu, gen)
                want = epilogue.conv_epilogue_plain(
                    s["x"].clone(), s["scale"], s["shift"], s["res"], relu)
                got = epilogue.conv_epilogue_cuda(
                    s["x"], s["scale"], s["shift"], s["res"], relu)
                if not torch.equal(got.view(torch.int16),
                                   want.view(torch.int16)):
                    raise AssertionError(
                        f"epilogue differs from its plain version at "
                        f"{shape} residual={residual} relu={relu}")
    say(f"phase 6 epilogue: equals its plain version bit for bit at the "
        f"{len(shapes)} unit shapes of a serving forward, each with and "
        f"without the residual and ReLU (bf16 channels-last)")
    for shape in ((1, 1024, 30, 40), (1, 2048, 15, 20)):
        r = identity_bn_rounding(epilogue, shape)
        say(f"phase 6 epilogue at identity statistics {shape} + residual: "
            f"ties {r['ties']:.4%} of x + residual, folded differs from "
            f"unfolded in {r['differ']:.4%}, mean error against f64: "
            f"folded {r['bias_folded']:.4%}, unfolded "
            f"{r['bias_unfolded']:.4%}")

    rows = {}
    for name, shape, residual in EPILOGUE_SHAPES:
        nbytes = epilogue_bytes(shape, residual)
        n = max(2, math.ceil(4 * L2_BYTES / nbytes))
        sets = [epilogue_operands(shape, residual, True, gen, identity=True)
                for _ in range(n)]
        reps = max(1, math.ceil(50 / n))
        rows[name] = dict(
            shape=list(shape), residual=residual, sets=n,
            ms=event_ms(epilogue_pass(epilogue, sets, "kernel"), reps) / n,
            plain_ms=event_ms(epilogue_pass(epilogue, sets, "plain"), 1,
                              warmup=1) / n,
            unfolded_ms=event_ms(epilogue_pass(epilogue, sets, "unfolded"),
                                 1, warmup=1) / n,
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
        del sets
    sets = [epilogue_operands(shape, residual, relu, gen, identity=True)
            for shape, residual, relu in units]
    net = dict(
        units=len(units), residual=sum(r for _, r, _ in units),
        elements=sum(math.prod(s) for s, _, _ in units),
        ms=event_ms(epilogue_pass(epilogue, sets, "kernel"), 1, repeats=5),
        plain_ms=event_ms(epilogue_pass(epilogue, sets, "plain"), 1,
                          warmup=1),
        unfolded_ms=event_ms(epilogue_pass(epilogue, sets, "unfolded"), 1,
                             warmup=1),
        bound_ms=sum(epilogue_bytes(s, r) for s, r, _ in units)
        / PEAK_BYTES_PER_S * 1e3)
    del sets
    for name, row in {**rows, f"{EPILOGUE_UNITS} units": net}.items():
        say(f"phase 6 epilogue {name} (cold, bf16): device ms: kernel "
            f"{row['ms']:.5f}, plain {row['plain_ms']:.5f}, unfolded ops "
            f"{row['unfolded_ms']:.5f}, bound {row['bound_ms']:.5f} "
            f"({100 * row['bound_ms'] / row['ms']:.1f}%)")
    return dict(max_abs_err=0.0, bound_by="bytes", library_ms=None,
                **net, shapes=rows)


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
        calibrate_head(net.net, (img, depth), cfg3.sem_threshold, 2.0)
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


AGREE_FRAMES = 3   # a scene; the script's default is 120


def phase_agreement(voting, vote_cuda):
    """The hier-vs-exact agreement study (``scripts.hier_exact_agreement``)
    cut to AGREE_FRAMES frames a scene, at grid GRID_L and N_POINTS points:
    first one exact-mode frame's K1 counts (GRID_L^3 voxels x N_POINTS
    points) against the plain version, exactly; then ``run_suite`` on the
    single, cluttered and mask-bleed scenes with K1's launches set to 0
    just before and read just after. Returns (max |K1 - plain| of that
    frame, launches)."""
    from rcvpose_tpu_torch.scripts import hier_exact_agreement as agree

    dev = torch.device(DEVICE)
    pts, rad, mask, _ = agree.scene_frame(np.random.default_rng(0), "single",
                                          0, N_POINTS)
    pts, rad, mask = (torch.as_tensor(a, device=dev)[None]
                      for a in (pts, rad, mask))
    shifted, radii, _, _, bound = voting._prepare(pts, rad, mask)
    lo, hi = voting.exact_band(radii, mask)
    args = (voting.enumerate_grid(GRID_L, dev), shifted, lo, hi)
    got = vote_cuda.vote_counts_cuda(*args)
    want = vote_cuda.vote_counts_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K1 exact grid {GRID_L}: counts differ from "
                             f"the plain version (max |diff| {err})")
    say(f"phase 10 agreement: K1 on one exact-mode frame ({GRID_L}^3 "
        f"voxels x {N_POINTS} points, bound {float(bound[0]):.0f}) equals "
        f"the plain version (max votes {float(got.max()):.0f})")
    del got, want, args
    torch.cuda.synchronize()
    vote_cuda.vote_counts_cuda.launches = 0
    for scene in ("single", "cluttered", "maskbleed"):
        t0 = time.perf_counter()
        rec = agree.run_suite(AGREE_FRAMES, GRID_L, scene,
                              n_points=N_POINTS, device=dev)
        say(f"phase 10 agreement {scene} ({time.perf_counter() - t0:.1f} "
            f"s): {json.dumps(rec)}")
        if (rec["frames"] + rec["overflowed"] != AGREE_FRAMES
                or rec["vote_counts_launches"] == 0):
            raise AssertionError(f"phase 10 agreement {scene}: {rec}")
    torch.cuda.synchronize()
    launches = vote_cuda.vote_counts_cuda.launches
    check_launches("phase 10 agreement", {"vote_counts": launches})
    return err, launches


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


def icp_scene(rng, cad_mm, n_points, n_valid, k=3):
    """A packed scene at LINEMOD's depth for ``cad_mm`` (S, 3): the first
    ``n_valid`` of ``n_points`` points are the CAD placed at 800 mm (1 mm
    noise) and clutter around it, the rest padding; each keypoint's mask a
    random 80% of the valid points (every valid point in one at least);
    and an initial pose a few degrees and millimetres off. Returns numpy
    scene_pts (k, n_points, 3) (one cloud), scene_mask (k, n_points) and
    rt (4, 4)."""
    def rot(axis, angle):
        axis = axis / np.linalg.norm(axis)
        x = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
        return np.eye(3) + np.sin(angle) * x + (1 - np.cos(angle)) * x @ x

    r = rot(rng.normal(size=3), rng.uniform(0, np.pi))
    t = np.array([rng.uniform(-80, 80), rng.uniform(-60, 60), 800.0])
    n_obj = (2 * n_valid) // 3
    obj = cad_mm[rng.integers(0, len(cad_mm), n_obj)] @ r.T + t
    pts = np.zeros((n_points, 3))
    pts[:n_valid] = np.concatenate([
        obj + rng.normal(size=obj.shape),
        t + rng.uniform(-150, 150, size=(n_valid - n_obj, 3))])
    mask = np.zeros((k, n_points), bool)
    mask[:, :n_valid] = rng.uniform(size=(k, n_valid)) < 0.8
    mask[0, :n_valid] |= ~mask.any(axis=0)[:n_valid]
    rt = np.eye(4)
    rt[:3, :3] = rot(rng.normal(size=3), 0.06) @ r
    rt[:3, 3] = t + rng.normal(size=3) * 4.0
    return (np.broadcast_to(pts.astype(np.float32), (k, n_points, 3)),
            mask, rt.astype(np.float32))


def phase_icp_kernels(config, eval_mod, fit, infer, train_mod, geometry,
                      profiling, lm):
    """The ICP kernels at the refine cell's shapes (see the module
    docstring, phase 11). Returns their rows of the ``kernels`` line:
    {name: {launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}}."""
    from rcvpose_tpu_torch.ops import icp_cuda

    dev = torch.device(DEVICE)
    cfg = config.Config(model_blocks="1,1,1,1", model_width=0.125)
    threshold = 20.0
    cad = (lm["cad_m"] * 1000.0).astype(np.float32)
    scene, masks, rt = icp_scene(np.random.default_rng(111), cad, N_POINTS,
                                 N_POINTS * 5 // 8)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    cad_t, rt_t = t(cad), t(rt)
    clouds = {"one cloud": (t(scene[0]),
                            torch.tensor(masks.any(axis=0), device=dev)),
              "3 copies": (t(scene).reshape(-1, 3),
                           torch.tensor(masks, device=dev).reshape(-1))}
    with torch.inference_mode():
        for name, (target, mask) in clouds.items():
            t2 = (target * target).sum(dim=1)
            keys = icp_cuda.new_keys(cad.shape[0], dev)
            pose = rt_t
            for step in range(4):
                src = cad_t @ pose[:3, :3].T + pose[:3, 3]
                idx, dist = icp_cuda.nearest_cuda(src, target, t2, mask,
                                                  keys)
                want_idx, want_dist = fit._nn(src, target, t2, mask)
                if not (torch.equal(idx, want_idx)
                        and torch.equal(dist, want_dist)):
                    raise AssertionError(
                        f"phase 11 icp {name}: nearest_cuda differs from "
                        f"fit._nn at update {step}")
                w = (dist <= threshold).to(torch.float32)
                sums = (*fit._horn_sums(src, target[idx], w), w.sum(), pose)
                pose = icp_cuda.update_pose_cuda(*sums)
                if not torch.equal(pose, fit._update_pose(*sums)):
                    raise AssertionError(
                        f"phase 11 icp {name}: update_pose_cuda differs "
                        f"from fit._update_pose at update {step}")
        say(f"phase 11 icp kernels: nearest_cuda equals fit._nn and "
            f"update_pose_cuda equals fit._update_pose bit for bit over 4 "
            f"updates, {cad.shape[0]} CAD points against "
            + " and ".join(f"{name} ({c[0].shape[0]} points, "
                           f"{int(c[1].sum())} valid)"
                           for name, c in clouds.items()))

        # the refine path: the estimator's graph, then the evaluator's
        # eager ICP over the copies, counted from 0
        est = infer.PoseEstimator(
            cfg, [train_mod.build_model(cfg).state_dict() for _ in range(3)],
            np.zeros((9, 3)), [100.0] * 3, cad_mm=cad,
            k=geometry.LINEMOD_K, device=dev)
        result = {"scene_pts": t(scene),
                  "scene_mask": torch.tensor(masks, device=dev),
                  "rt": rt_t}
        counts0 = profiling.counters()
        torch.cuda.synchronize()
        icp_cuda.nearest_cuda.launches = 0
        icp_cuda.update_pose_cuda.launches = 0
        poses = [est.refine(result, threshold) for _ in range(3)]
        copies = clouds["3 copies"]
        rt_eval, _ = eval_mod.refine_and_add(
            rt_t, cad_t, *copies, rt_t, False, threshold,
            icp_iters=cfg.icp_iters)
        torch.cuda.synchronize()
        launches = {"icp_nearest": icp_cuda.nearest_cuda.launches,
                    "icp_pose_update": icp_cuda.update_pose_cuda.launches}
        counts1 = profiling.counters()
        counts = {k: counts1.get(k, 0) - counts0.get(k, 0)
                  for k in ("icp.captured", "icp.replayed", "icp.eager")}
        want = fit._icp(cad_t, *copies, rt_t, threshold, cfg.icp_iters,
                        None, None, False, kernels=False)
    n = cfg.icp_iters
    if launches != {"icp_nearest": 4 * 2 * n, "icp_pose_update": 4 * n}:
        raise AssertionError(f"phase 11 icp: launches {launches} over 3 "
                             f"refinements and 1 refine_and_add of {n} "
                             f"updates")
    if counts != {"icp.captured": 1, "icp.replayed": 2, "icp.eager": 1}:
        raise AssertionError(f"phase 11 icp: counters {counts}")
    for i, pose in enumerate(poses + [rt_eval]):
        if not torch.equal(pose, want):
            raise AssertionError(
                f"phase 11 icp: refinement {i} differs from the tensor "
                f"ops' ICP over the copies by "
                f"{float((pose - want).abs().max())}")
    if torch.equal(want, rt_t):
        raise AssertionError("phase 11 icp: the ICP left the pose as it was")
    say(f"phase 11 icp refine path ({n} updates): launches {launches} over "
        f"3 PoseEstimator.refine and 1 eval.refine_and_add; counters "
        f"{counts}; every pose equals the tensor ops' ICP over the 3 "
        f"copies with their own masks bit for bit")

    target, mask = clouds["one cloud"]
    t2 = (target * target).sum(dim=1)
    keys = icp_cuda.new_keys(cad.shape[0], dev)
    with torch.inference_mode():
        src = cad_t @ rt_t[:3, :3].T + rt_t[:3, 3]
        idx, dist = icp_cuda.nearest_cuda(src, target, t2, mask, keys)
        w = (dist <= threshold).to(torch.float32)
        sums = (*fit._horn_sums(src, target[idx], w), w.sum(), rt_t)
        rows = {"icp_nearest": dict(
            ms=event_ms(lambda: icp_cuda.nearest_cuda(src, target, t2, mask,
                                                      keys), reps=50),
            plain_ms=event_ms(lambda: fit._nn(src, target, t2, mask),
                              reps=10),
            # 9 FP32 operations a (source, valid target) pair
            bound_ms=cad.shape[0] * int(mask.sum()) * 9
            / PEAK_FP32_FLOPS * 1e3, bound_by="operations"),
            "icp_pose_update": dict(
            ms=event_ms(lambda: icp_cuda.update_pose_cuda(*sums), reps=50),
            plain_ms=event_ms(lambda: fit._update_pose(*sums), reps=10),
            # one warp's chain of dependent operations: an empty kernel's
            # time is its floor
            bound_ms=event_ms(lambda: torch.cuda._sleep(0), reps=100),
            bound_by="launch")}
        refine_ms = event_ms(lambda: est.refine(result, threshold), reps=5)
    for name, row in rows.items():
        row.update(launches=launches[name], max_abs_err=0.0, library_ms=None)
        say(f"phase 11 icp {name}: device ms {row['ms']:.5f}, plain "
            f"{row['plain_ms']:.5f}, bound {row['bound_ms']:.5f} by "
            f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}%)")
    say(f"phase 11 icp: one refinement ({n} updates, a graph replay) "
        f"{refine_ms:.4f} device ms")
    return rows


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
            calibrate_head(net.net, (img, depth0), cfg3.sem_threshold,
                           float(r))
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

        # 6 and 8. YCB: gen-labels from a raw tree twice, 2 steps from
        # the file under --profile_dir, then --mode test on the nets
        paths.update(phase_ycb_route(cli, labels, loader_mod, train_mod,
                                     checkpoint, heads, vote_cuda, k2, tmp))
    return paths


YCB_GEN_FRAMES = 4


def write_ycb_raw_tree(root):
    """A raw YCB-Video tree for YCB_CLASS at 480x640, as the dataset ships
    it before label generation: ``models/<class>/points.xyz`` (a 3-4 cm
    shell, m) and ``Outside9.npy``, then YCB_GEN_FRAMES frames in
    ``data/0000/``: PNG colour (blocky noise), 16-bit depth at
    YCB_FACTOR_DEPTH, a label PNG holding the class id where the object
    is, and a ``.mat`` (pose, class, depth scale, YCB_K) written with
    ``scipy.io.savemat``. Returns [(depth mm (H, W) f32, mask, pose)] and
    the keypoints."""
    import os

    import scipy.io
    from PIL import Image

    rng = np.random.default_rng(29)
    class_id, name = YCB_CLASS
    mdir = os.path.join(root, "models", name)
    data = os.path.join(root, "data", "0000")
    for d in (mdir, data):
        os.makedirs(d)
    dirs = rng.normal(size=(3000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    cad_m = dirs * rng.uniform(0.03, 0.04, size=(3000, 1))
    np.savetxt(os.path.join(mdir, "points.xyz"), cad_m)
    kpts9 = rng.uniform(-0.06, 0.06, size=(9, 3))
    np.save(os.path.join(mdir, "Outside9.npy"), kpts9)
    frames = []
    for i in range(1, YCB_GEN_FRAMES + 1):
        idx = f"{i:06d}"
        pose = pose_at(rng, W // 2 + rng.uniform(-120, 120),
                       H // 2 + rng.uniform(-80, 80), rng.uniform(0.7, 0.9),
                       YCB_K)
        pose[:, :3] = random_pose(rng)[:, :3]
        depth = np.round(render_depth(cad_m, pose, YCB_K) / 1000.0
                         * YCB_FACTOR_DEPTH).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(data, f"{idx}-depth.png"))
        Image.fromarray(np.where(depth > 0, class_id, 0).astype(np.uint8)
                        ).save(os.path.join(data, f"{idx}-label.png"))
        coarse = rng.integers(0, 256, size=(H // 16, W // 16, 3))
        img = np.clip(np.kron(coarse, np.ones((16, 16, 1)))
                      + rng.normal(0, 8, size=(H, W, 3)), 0, 255
                      ).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(data, f"{idx}-color.png"))
        scipy.io.savemat(os.path.join(data, f"{idx}.mat"), {
            "poses": pose[:, :, None], "cls_indexes": np.array([[class_id]]),
            "factor_depth": np.array([[YCB_FACTOR_DEPTH]]),
            "intrinsic_matrix": YCB_K})
    return kpts9


def ycb_file(path, keys):
    """{name: array} of ``keys`` in the class HDF5 and each image's stored
    chunks (bytes, filter mask, offset), read by the port's reader; and
    the reader's class (h5py, where it imports, or the port's own)."""
    from rcvpose_tpu_torch.data import readers

    out, chunks = {}, {}
    with readers.Hdf5File(path) as f:
        r = f._reader
        for key in keys:
            out[key] = np.array(f[key])
            if key.startswith("JPEGImages"):
                chunks[key] = sorted(
                    (bytes(r.data[a:a + n]), m, o)
                    for a, n, m, o in r.stored(f[key]._entry)[2])
    with readers.open_hdf5(path) as f:
        reader = f"{type(f).__module__}.{type(f).__name__}"
    return out, chunks, reader


def ycb_cpu_labels(labels, root, kpts9):
    """The CPU's ``radial_labels`` of every frame of the raw tree (dm, no
    clip), from its PNGs and ``.mat``s: {frame id: (H, W, 3)}."""
    import os

    import scipy.io

    from rcvpose_tpu_torch.data import readers

    class_id, _ = YCB_CLASS
    data = os.path.join(root, "data", "0000")
    out = {}
    for i in range(1, YCB_GEN_FRAMES + 1):
        idx = f"{i:06d}"
        meta = scipy.io.loadmat(os.path.join(data, f"{idx}.mat"))
        depth = readers.read_depth(os.path.join(data, f"{idx}-depth.png"))
        seg = readers.read_depth(os.path.join(data, f"{idx}-label.png"))
        radial, _ = labels.radial_labels(
            torch.tensor(depth.astype(np.float32)[None] / YCB_FACTOR_DEPTH
                         * 1000.0),
            torch.tensor((seg == class_id).astype(np.int32)[None]),
            torch.tensor(meta["poses"][:, :, 0][None], dtype=torch.float32),
            torch.tensor(kpts9[1:4], dtype=torch.float32),
            torch.tensor(meta["intrinsic_matrix"], dtype=torch.float32),
            torch.full((3,), float("inf")))
        out[f"0000_{idx}"] = radial[0].numpy()
    return out


def phase_ycb_route(cli, labels, loader_mod, train_mod, checkpoint, heads,
                    vote_cuda, k2, tmp):
    """YCB from a raw 480x640 tree to an evaluated net, through
    ``cli.main``: ``gen-labels --dname ycb`` on the card twice (labels
    within 1e-5 dm of the CPU's ``radial_labels``; between the runs the
    colour PNGs and one frame's depth change, and the second run keeps the
    images, their stored chunks too, and replaces the maps, as h5py's
    ``"a"`` mode does), 2 steps from the file under ``--profile_dir``,
    then ``--mode test`` on the trained net (the YCB evaluator, 30 ICP
    iterations). Returns the kernels' launches on each path."""
    import os

    from PIL import Image

    class_id, name = YCB_CLASS
    ycb = os.path.join(tmp, "ycb")
    kpts9 = write_ycb_raw_tree(ycb)
    h5 = os.path.join(ycb, f"{name}.hdf5")
    ids = [f"0000_{i:06d}" for i in range(1, YCB_GEN_FRAMES + 1)]
    maps = [f"3Dradius_pt{k}_dm/{i}" for i in ids for k in (1, 2, 3)]
    images = [f"JPEGImages/{i}" for i in ids]
    gen = ["--mode", "gen-labels", "--dname", "ycb", "--root_dataset", ycb,
           "--class_name", name]
    paths, runs = {}, []
    for run in range(2):
        want = ycb_cpu_labels(labels, ycb, kpts9)
        t0 = time.perf_counter()
        cli.main(gen, device=DEVICE)
        secs = time.perf_counter() - t0
        got, chunks, reader = ycb_file(h5, maps + images)
        worst = max(float(np.abs(got[f"3Dradius_pt{k}_dm/{i}"]
                                 - want[i][..., k - 1]).max())
                    for i in ids for k in (1, 2, 3))
        labelled = sum(int((w > 0).sum()) for w in want.values())
        size = os.path.getsize(h5)
        raw = sum(a.nbytes for a in got.values())
        runs.append((got, chunks))
        say(f"phase 14 YCB gen-labels run {run + 1}: {YCB_GEN_FRAMES} frames "
            f"at {H}x{W} in {secs:.2f} s ({secs / YCB_GEN_FRAMES:.3f} s a "
            f"frame), {labelled} labelled pixels, max |card - CPU| "
            f"{worst:.3g} dm; {name}.hdf5 {size} B against {raw} B raw "
            f"({size / raw:.3f}); read by {reader}")
        if not (worst <= 1e-5 and labelled > 0):
            raise AssertionError(f"YCB gen-labels: {worst} dm off the CPU")
        if run == 0:    # new colour everywhere, frame 1 5 cm further away
            data = os.path.join(ycb, "data", "0000")
            for i in range(1, YCB_GEN_FRAMES + 1):
                path = os.path.join(data, f"{i:06d}-color.png")
                Image.fromarray(255 - np.asarray(Image.open(path))).save(path)
            path = os.path.join(data, "000001-depth.png")
            depth = np.asarray(Image.open(path)).astype(np.uint16)
            Image.fromarray(np.where(depth > 0, depth + 500, 0).astype(
                np.uint16)).save(path)
    (first, chunks1), (second, chunks2) = runs
    kept = all(np.array_equal(first[k], second[k]) for k in images)
    moved = [k for k in maps if not np.array_equal(first[k], second[k])]
    say(f"phase 14 YCB gen-labels twice: images kept {kept} (stored chunks "
        f"unchanged {chunks1 == chunks2}); maps replaced: {len(moved)} of "
        f"{len(maps)} changed, all of frame {ids[0]}'s")
    if not (kept and chunks1 == chunks2
            and sorted(moved) == sorted(m for m in maps if ids[0] in m)):
        raise AssertionError("YCB gen-labels: the second run did not keep "
                             "the images and replace the maps")

    prof = os.path.join(tmp, "prof")
    logs = os.path.join(tmp, "logs_ycb")
    yr = CliRun(cli, loader_mod, train_mod, checkpoint, k2)(
        ["--mode", "train", "--dname", "ycb", "--root_dataset", ycb,
         "--class_name", name, "--batch_size", "2", "--max_iterations",
         "2", "--out_dir", logs, "--profile_dir", prof])
    handle = yr["loaders"][0].ds._h5
    traces = os.listdir(prof)
    paths["train YCB"] = yr["launches"]
    check_launches("phase 14 YCB route", yr["launches"])
    say(f"phase 14 YCB route: 2 steps at {H}x{W} from the generated file, "
        f"ms/step {[round(t, 3) for t in yr['times']]}, losses "
        f"{[round(x, 4) for x in yr['losses']]}, HDF5 read by "
        f"{type(handle).__module__}.{type(handle).__name__}; launches "
        f"{yr['launches']}; profile {traces} "
        f"({sum(os.path.getsize(os.path.join(prof, t)) for t in traces) / 2 ** 20:.1f} MiB)")
    if (yr["result"].iteration != 2 or len(traces) != 1
            or not all(map(math.isfinite, yr["losses"]))):
        raise AssertionError(f"YCB route: {yr['result'].iteration} steps, "
                             f"traces {traces}")
    del yr, handle
    free_memory()

    # the trained net serves the three keypoints of the YCB evaluator
    nets = os.path.join(tmp, "ycb_nets")
    os.makedirs(nets)
    ckpts = os.path.join(logs, "ycb", f"{name}Kp1", "ckpts")
    for k in (1, 2, 3):
        os.symlink(ckpts, os.path.join(nets, f"{name}_pt{k}"))
    res, n, secs = counted_eval(vote_cuda, heads, lambda: cli.main(
        ["--mode", "test", "--dname", "ycb", "--root_dataset", ycb,
         "--model_dir", nets, "--eval_classes", name, "--out_dir",
         os.path.join(tmp, "test_ycb"), "--no_ycb_icp_converged"],
        device=DEVICE)["all"])
    say(f"phase 14 YCB --mode test on the trained net: {res['frames']} "
        f"frames in {secs:.1f} s, ADD(-S) AUC before ICP "
        f"{res['adds_auc_before_icp']:.4f}, after "
        f"{res['adds_auc_after_icp']:.4f}; launches K1 {n['vote_counts']} "
        f"K2 {n['heads_channel_major']}")
    check_route("phase 14 YCB --mode test", res, n, YCB_GEN_FRAMES, True,
                perfect=False)
    for key in ("adds_auc_before_icp", "adds_auc_after_icp"):
        if not math.isfinite(res[key]):
            raise AssertionError(f"YCB --mode test: {key} {res[key]}")
    paths["test YCB"] = n
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


def recorded(eval_mod, run):
    """``run()`` with each LM frame's scores recorded from the evaluator's
    ``pose_and_add``/``refine_and_add``: (its result, [(bf, af)])."""
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
        return run(), rows
    finally:
        eval_mod.pose_and_add, eval_mod.refine_and_add = (pose_and_add,
                                                          refine_and_add)


def recorded_lm(eval_mod, cfg):
    """The sequential LM evaluator with each frame's scores recorded:
    (results, [(bf, af)])."""
    return recorded(eval_mod, lambda: eval_mod.estimate_6d_pose_lm(
        cfg, class_names=["ape"], progress=lambda m: None)["ape"])


def phase_distributed(config, cli, eval_mod, labels, geometry, train_mod,
                      vote_cuda, k1_stages, root, lm, train_root):
    """Phase 15 (see the module docstring). Returns the kernels' launches
    on each path and the sequential evaluator's record of phase 11's
    ``.pth.tar`` route ((results, [(bf, af)]), for phase 16)."""
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
    return paths, seq["network"]


# ---------------------------------------------------------------------------
# Phase 16: the JAX package's orbax checkpoints, read without JAX
# ---------------------------------------------------------------------------

ORBAX_SEED = 16
ZSTD_MAGIC = 0xFD2FB528
OCDBT_MANIFEST_MAGIC = 0x0CDB3A2A
OCDBT_NODE_MAGIC = 0x0CDB20DE
OCDBT_INLINE_MAX = 1024  # orbax's: larger values go to a data file


def orbax_fixture_arrays():
    """The tree of the carried orbax directory (``ORBAX_DIR``), from the
    seed: nested dicts, a tuple, a 0-d int64, a bf16 leaf (a
    ``torch.bfloat16`` tensor; every value is exact in bf16) and a 320 KB
    f32 random walk in steps of 1/8, whose repeats make zstd level 1 write
    Compressed blocks with Huffman literals and FSE-coded sequences."""
    rng = np.random.default_rng(ORBAX_SEED)
    walk = np.cumsum(rng.integers(-2, 3, size=(160, 512)), axis=1) / 8.0
    return {
        "params": {"dense": {"kernel": walk.astype(np.float32),
                             "bias": rng.normal(size=512).astype(np.float32)},
                   "embed": {"table": rng.normal(size=(7, 3))}},
        "batch_stats": {"mean": rng.integers(-50, 50, size=33,
                                             dtype=np.int32)},
        "pair": (rng.integers(0, 256, size=(4, 5), dtype=np.uint8),
                 rng.random(6) < 0.5),
        "step": np.asarray(12345678901, np.int64),
        "scale": torch.tensor(rng.integers(-64, 64, size=(5, 8)) / 4.0,
                              dtype=torch.bfloat16),
    }


def unpack_dir(blob, path):
    """Write a directory carried as base64(zlib(tar)) under ``path``."""
    import base64
    import io
    import tarfile
    import zlib

    with tarfile.open(fileobj=io.BytesIO(zlib.decompress(
            base64.b64decode(blob)))) as tar:
        tar.extractall(path, filter="data")


def same_tree(a, b, where=""):
    """Raise unless two trees of dicts, tuples, arrays and bf16 tensors are
    equal bit for bit, with the same dtypes and shapes."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or \
                sorted(a) != sorted(b):
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            same_tree(a[k], b[k], f"{where}/{k}")
        return
    if isinstance(a, tuple) or isinstance(b, tuple):
        if not (isinstance(a, tuple) and isinstance(b, tuple)) or \
                len(a) != len(b):
            raise AssertionError(f"{where}: tuples differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{where}/{i}")
        return
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                                b.reshape(-1).contiguous().view(torch.uint8))):
            raise AssertionError(f"{where}: tensors differ")
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or \
            a.tobytes() != b.tobytes():
        raise AssertionError(f"{where}: {a.dtype}{a.shape} against "
                             f"{b.dtype}{b.shape}")


# -- a writer of the orbax layout, for full-width trees on the card -------

def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


_CRC32C = []


def crc32c(data):
    """CRC-32C (Castagnoli), bit-reflected, as OCDBT's trailers use."""
    if not _CRC32C:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            _CRC32C.append(c)
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def zstd_raw_frame(data):
    """A zstd frame (RFC 8878) of Raw blocks holding ``data``: single
    segment, 8-byte content size, no checksum. Valid zstd that needs no
    compressor."""
    import struct

    data = memoryview(data).cast("B")
    parts = [struct.pack("<IBQ", ZSTD_MAGIC, 0xE0, len(data))]
    pos = 0
    while True:
        size = min(len(data) - pos, 1 << 17)
        last = pos + size >= len(data)
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(data[pos:pos + size])
        pos += size
        if last:
            return b"".join(parts)


def _ocdbt_file(magic, body):
    """An OCDBT manifest or node: header, body as one zstd frame (Raw
    blocks), CRC-32C trailer."""
    import struct

    content = zstd_raw_frame(body)
    head = struct.pack(">I", magic) + struct.pack(
        "<Q", 4 + 8 + 2 + len(content) + 4) + b"\x00\x01"
    data = head + content
    return data + crc32c(data).to_bytes(4, "little")


def _one_file_table(path):
    p = path.encode()
    return _varint(1) + _varint(len(p)) + _varint(0) + p


def _tree_leaves(tree, keys=(), types=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], keys + (str(k),), types + (2,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, keys + (str(i),), types + (1,))
    else:
        yield keys, types, tree


def write_orbax(path, tree):
    """Write ``tree`` (dicts, tuples, numpy arrays, bf16 tensors) as the
    JAX Checkpointer's payload directory: ``_CHECKPOINT_METADATA``,
    ``_METADATA`` and an OCDBT store of zarr v2 arrays (one chunk each,
    zstd frames of Raw blocks), as orbax 0.11 with tensorstore 0.1 lays it
    out. Returns the bytes written."""
    import hashlib
    import os
    import struct

    os.makedirs(os.path.join(path, "d"))
    uid = hashlib.sha256(path.encode()).digest()
    data_rel = f"d/{uid[:16].hex()}"
    node_rel = f"d/{uid[16:].hex()}"
    entries, meta, offset = [], {}, 0
    with open(os.path.join(path, data_rel), "wb") as data_file:
        for keys, types, leaf in _tree_leaves(tree):
            name = ".".join(keys)
            if isinstance(leaf, torch.Tensor):
                if leaf.dtype != torch.bfloat16:
                    raise TypeError(f"{name}: {leaf.dtype}")
                arr, dtype = leaf.contiguous().view(torch.int16).numpy(), \
                    "bfloat16"
            else:
                arr = np.asarray(leaf)  # ascontiguousarray makes 0-d 1-d
                arr = arr if arr.flags.c_contiguous else arr.copy()
                dtype = arr.dtype.str
            zarray = json.dumps({
                "chunks": list(arr.shape),
                "compressor": {"id": "zstd", "level": 1},
                "dimension_separator": ".", "dtype": dtype,
                "fill_value": None, "filters": None, "order": "C",
                "shape": list(arr.shape), "zarr_format": 2},
                separators=(",", ":"), sort_keys=True).encode()
            chunk = zstd_raw_frame(arr.reshape(-1).view(np.uint8))
            entries.append((f"{name}/.zarray".encode(), zarray))
            ckey = ".".join("0" * arr.ndim) or "0"
            if len(chunk) <= OCDBT_INLINE_MAX:
                entries.append((f"{name}/{ckey}".encode(), chunk))
            else:
                data_file.write(chunk)
                entries.append((f"{name}/{ckey}".encode(),
                                (offset, len(chunk))))
                offset += len(chunk)
            meta[str(keys)] = {
                "key_metadata": [{"key": k, "key_type": t}
                                 for k, t in zip(keys, types)],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
    entries.sort(key=lambda e: e[0])
    keys = [k for k, _ in entries]
    prefix = [0] + [len(os.path.commonprefix([a, b]))
                    for a, b in zip(keys, keys[1:])]
    inline = [v for _, v in entries if isinstance(v, bytes)]
    indirect = [v for _, v in entries if not isinstance(v, bytes)]
    body = b"".join([
        b"\x00", _one_file_table(data_rel), _varint(len(entries)),
        *map(_varint, prefix[1:]),
        *(_varint(len(k) - p) for k, p in zip(keys, prefix)),
        *(k[p:] for k, p in zip(keys, prefix)),
        *(_varint(len(v) if isinstance(v, bytes) else v[1])
          for _, v in entries),
        *(_varint(0 if isinstance(v, bytes) else 1) for _, v in entries),
        *(_varint(0) for _ in indirect),
        *(_varint(off) for off, _ in indirect),
        *inline])
    node = _ocdbt_file(OCDBT_NODE_MAGIC, body)
    with open(os.path.join(path, node_rel), "wb") as f:
        f.write(node)
    manifest = b"".join([
        uid[:16], _varint(0), _varint(OCDBT_INLINE_MAX),
        _varint(100_000_000), b"\x04", _varint(1), struct.pack("<i", 0),
        _one_file_table(node_rel), _varint(1), _varint(1), b"\x00",
        _varint(0), _varint(0), _varint(len(node)), _varint(len(entries)),
        _varint(len(node)), _varint(offset),
        struct.pack("<Q", 1_800_000_000_000_000_000), _varint(0)])
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(_ocdbt_file(OCDBT_MANIFEST_MAGIC, manifest))
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": 0, "commit_timestamp_nsecs": 0,
                   "custom_metadata": {}}, f)
    return offset + len(node)


def torch_key_to_flax(key):
    """(collection, Flax path) of a reference state-dict key, or None for
    one that carries no weight: the script's own copy of the JAX package's
    mapping (``rcvpose_tpu/checkpoint.py::torch_key_to_flax``)."""
    import re

    parts = key.split(".")
    conv = {"weight": "kernel", "bias": "bias"}
    bn = {"weight": ("params", "scale"), "bias": ("params", "bias"),
          "running_mean": ("batch_stats", "mean"),
          "running_var": ("batch_stats", "var")}

    def leaf(module_path, member, pname):
        if member.startswith("bn") or member.endswith("_bn"):
            if pname not in bn:
                return None
            col, name = bn[pname]
            return col, module_path + [name]
        return "params", module_path + [conv[pname]]

    head = parts[0]
    if head in ("conv1", "bn1"):
        return leaf(["encoder", head], head, parts[1])
    if re.match(r"block\dup$", head):
        if parts[1] == "upsample_":
            member = "proj_conv" if parts[2] == "0" else "proj_bn"
            return leaf(["encoder", head, member], member, parts[3])
        return leaf(["encoder", head, parts[1]], parts[1], parts[2])
    m = re.match(r"block(\d)$", head)
    if m:
        name = f"block{m.group(1)}_{int(parts[1]) + 1}"
        return leaf(["encoder", name, parts[2]], parts[2], parts[3])
    if head in ("conv6", "bn6", "conv8") or re.match(r"conv_up\d_1$", head):
        return leaf([head], head, parts[1])
    member = f"{head}_conv" if parts[1] == "0" else f"{head}_bn"
    return leaf([member], member, parts[2])


def flax_variables(checkpoint, state_dict):
    """The inverse of ``checkpoint.from_flax_variables``: a reference-layout
    state dict -> ``{"params", "batch_stats"}`` in Flax layout (numpy,
    conv kernels OIHW -> HWIO), each key checked against the port's own
    mapping back."""
    out = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        mapped = torch_key_to_flax(key)
        if mapped is None:
            continue
        col, path = mapped
        if checkpoint._flax_path_to_torch_key(col, path) != key:
            raise AssertionError(f"{key} -> {col}/{path} does not map back")
        arr = value.detach().cpu().float().numpy()
        if path[-1] == "kernel":
            arr = np.transpose(arr, (2, 3, 1, 0))
        node = out[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def jax_payload(variables, epoch, iteration, adam=False):
    """The JAX Checkpointer's payload (rcvpose_tpu/checkpoint.py:
    ``_payload``) around ``variables``; ``adam``: with the opt_state of
    ``optax.adam`` under a schedule, (ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count)), at the JAX shapes."""
    payload = {"params": variables["params"],
               "batch_stats": variables["batch_stats"],
               "step": np.asarray(iteration, np.int32),
               "epoch": np.asarray(epoch, np.int64),
               "iteration": np.asarray(iteration, np.int64),
               "best_val": np.asarray(0.25, np.float64)}
    if adam:
        def like(tree, fill):
            return {k: like(v, fill) if isinstance(v, dict)
                    else np.full_like(v, fill) for k, v in tree.items()}

        count = np.asarray(iteration, np.int32)
        payload["opt_state"] = (
            {"count": count, "mu": like(variables["params"], 1e-3),
             "nu": like(variables["params"], 1e-6)}, {"count": count})
    return payload


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)


def same_lm(what, got, want):
    """Raise unless two recorded LM runs agree exactly: every frame's
    scores before and after ICP, and the ADD pass rates."""
    (res, rows), (res_w, rows_w) = got, want
    keys = ("frames", "add_before_icp", "add_after_icp", "overflow_frames")
    if rows != rows_w or any(res[k] != res_w[k] for k in keys):
        raise AssertionError(
            f"{what}: {rows} {[res[k] for k in keys]} against {rows_w} "
            f"{[res_w[k] for k in keys]}")


def phase_orbax(config, cli, checkpoint, eval_mod, train_mod, fcn, root, lm,
                seq_network):
    """Phase 16: the carried orbax directory read bit for bit, then
    full-width orbax trees staged from phase 11's nets through the LM
    evaluator (``cli --mode test``) against phase 15's record of the
    ``.pth.tar`` route, the fused route against its ``.pth.tar`` twin, and
    ``--mode export-torch`` on a ``ckpt/`` with Adam's state. Returns the
    kernels' launches on each path."""
    import os
    import shutil

    from rcvpose_tpu_torch import orbax_read
    from rcvpose_tpu_torch.data import readers
    from rcvpose_tpu_torch.native import zstd

    import importlib.util

    card = card_line()
    paths = {}
    present = [m for m in ("jax", "orbax", "tensorstore", "zstandard")
               if importlib.util.find_spec(m) is not None]
    say(f"phase 16 on this machine: importable of jax, orbax, tensorstore, "
        f"zstandard: {present or 'none'}")
    # 1. real orbax bytes, written by orbax 0.11.32
    fixture = os.path.join(root, "orbax_fixture")
    unpack_dir(ORBAX_DIR, fixture)
    zstd.reset_stats()
    same_tree(orbax_read.read_tree(fixture), orbax_fixture_arrays(),
              "phase 16 fixture")
    modes = {k: v for k, v in zstd.STATS.items() if v}
    if min(zstd.STATS["compressed_blocks"], zstd.STATS["fse_tables"],
           zstd.STATS["huffman_1_stream"] + zstd.STATS["huffman_4_streams"]
           ) == 0:
        raise AssertionError(f"phase 16: the fixture did not reach the "
                             f"Huffman and FSE paths: {modes}")
    frame = orbax_read.OrbaxCheckpoint(fixture).store.read(
        "params.dense.kernel/0.0")
    out = np.empty(160 * 512 * 4, np.uint8)
    reps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        zstd.decompress_into(frame, out)
        reps += 1
    huff_mbs = reps * out.nbytes / (time.perf_counter() - t0) / 1e6
    say(f"phase 16 carried orbax directory ({dir_bytes(fixture)} bytes on "
        f"disk): every leaf equal to the seeded tree bit for bit; decoder "
        f"modes {modes}; the level-1 chunk ({len(frame)} -> {out.nbytes} "
        f"bytes) decodes at {huff_mbs:.1f} MB/s on one host thread "
        f"({card})")
    shutil.rmtree(fixture)

    # 2. full width: phase 11's nets as JAX Checkpointer directories
    base = config.Config(root_dataset=root, model_dir=lm["model_dir"])
    sds = [torch.load(os.path.join(lm["model_dir"], f"ape_pt{i}.pth.tar"),
                      map_location="cpu", weights_only=True)
           ["model_state_dict"] for i in range(1, 4)]
    model_dir = os.path.join(root, "orbax16")
    t0 = time.perf_counter()
    for i, sd in enumerate(sds, 1):
        write_orbax(os.path.join(model_dir, f"ape_pt{i}", "model_best"),
                    jax_payload(flax_variables(checkpoint, sd), 7, 700 + i))
    say(f"phase 16 staged 3 full-width model_best/ trees "
        f"({dir_bytes(model_dir)} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    got = checkpoint.from_flax_variables(checkpoint.orbax_variables(
        os.path.join(model_dir, "ape_pt1")))
    read_s = time.perf_counter() - t0
    want = {k: v for k, v in sds[0].items()
            if not k.endswith("num_batches_tracked")}
    same_tree(dict(got), want, "phase 16 ape_pt1")
    net_bytes = sum(v.numel() * 4 for v in got.values())
    say(f"phase 16 read one full-width net ({len(got)} tensors, "
        f"{net_bytes} bytes) in {read_s:.3f} s: {net_bytes / read_s / 1e6:.1f}"
        f" MB/s (Raw-block frames, {min(8, os.cpu_count())} threads) on "
        f"{card}")

    out_dir = os.path.join(root, "test16")
    argv = ["--mode", "test", "--root_dataset", root, "--model_dir",
            model_dir, "--eval_classes", "ape", "--out_dir", out_dir,
            *NET_FLAGS]
    (rec, launches) = counted(lambda: recorded(
        eval_mod, lambda: cli.main(argv, device=DEVICE)["ape"]))
    same_lm("phase 16 cli --mode test on orbax", rec, seq_network)
    say(f"phase 16 cli --mode test on the orbax tree: per-frame scores "
        f"{rec[1]} and ADD {rec[0]['add_before_icp']} / "
        f"{rec[0]['add_after_icp']} equal phase 15's record of the "
        f".pth.tar route; launches {launches}")
    check_launches("phase 16 3-net", {k: launches[k] for k in ("K1", "K2")})
    paths["3-net orbax"] = launches
    shutil.rmtree(model_dir)

    # 3. fused: one seeded multi-head net as .pth.tar and as orbax
    frames = lm_frames(readers, root)
    fcfg = dataclasses.replace(base, kpt_heads=3, eval_data_parallel=False)
    net = fcn.init_params(train_mod.build_model(fcfg),
                          torch.Generator().manual_seed(16))
    net = net.to(DEVICE, memory_format=torch.channels_last).eval()
    calibrate_head(net, frames[0][1:3], fcfg.sem_threshold,
                   float(np.mean(eval_mod._per_kpt_max_radii_dm(
                       lm["cad_m"], lm["kpts9"]))))
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    del net
    pth_dir, orb_dir = (os.path.join(root, "fused_pth"),
                        os.path.join(root, "fused_orbax"))
    os.makedirs(os.path.join(pth_dir, "ape"))
    torch.save({"model_state_dict": sd},
               os.path.join(pth_dir, "ape", "model_best.pth.tar"))
    write_orbax(os.path.join(orb_dir, "ape", "model_best"),
                jax_payload(flax_variables(checkpoint, sd), 1, 16))
    runs = {}
    for name, mdir in (("pth", pth_dir), ("orbax", orb_dir)):
        c = dataclasses.replace(fcfg, model_dir=mdir)
        runs[name] = counted(lambda c=c: recorded(
            eval_mod, lambda: eval_mod.estimate_6d_pose_lm(
                c, class_names=["ape"], progress=lambda m: None)["ape"]))
        check_launches(f"phase 16 fused {name}",
                       {k: runs[name][1][k] for k in ("K1", "K2")})
    same_lm("phase 16 fused orbax", runs["orbax"][0], runs["pth"][0])
    say(f"phase 16 fused route: orbax <class>/ and its .pth.tar twin give "
        f"the same per-frame scores {runs['orbax'][0][1]} (ADD "
        f"{runs['orbax'][0][0]['add_before_icp']} / "
        f"{runs['orbax'][0][0]['add_after_icp']}); launches orbax "
        f"{runs['orbax'][1]}, pth {runs['pth'][1]}")
    paths["fused orbax"] = runs["orbax"][1]
    shutil.rmtree(pth_dir)
    shutil.rmtree(orb_dir)

    # 4. export-torch on a ckpt/ that also holds Adam's state
    exp_dir = os.path.join(root, "export16")
    write_orbax(os.path.join(exp_dir, "ckpt"),
                jax_payload(flax_variables(checkpoint, sds[1]), 9, 901,
                            adam=True))
    ck = orbax_read.OrbaxCheckpoint(os.path.join(exp_dir, "ckpt"))
    t0 = time.perf_counter()
    ck.read_tree(("params", "batch_stats"))
    ckpt_s = time.perf_counter() - t0
    on_disk = dir_bytes(exp_dir)
    say(f"phase 16 ckpt/ with Adam's mu and nu: params and batch_stats "
        f"read {ck.store.bytes_read} of {on_disk} bytes on disk in "
        f"{ckpt_s:.3f} s (opt_state not read) on {card}")
    if ck.store.bytes_read > 0.4 * on_disk:
        raise AssertionError("phase 16: reading the weights read opt_state")
    out = os.path.join(exp_dir, "exported.pth.tar")
    cli.main(["--mode", "export-torch", "--model_dir", exp_dir,
              "--export_path", out])
    payload = torch.load(out, map_location="cpu", weights_only=True)
    want = {k: v for k, v in sds[1].items()
            if not k.endswith("num_batches_tracked")}
    same_tree(dict(payload["model_state_dict"]), want,
              "phase 16 export-torch")
    if (payload["epoch"], payload["iteration"]) != (9, 901):
        raise AssertionError(f"phase 16 export-torch: {payload['epoch']}, "
                             f"{payload['iteration']}")
    say(f"phase 16 export-torch of the orbax ckpt/: "
        f"{len(payload['model_state_dict'])} tensors equal the staged "
        f"weights, epoch 9, iteration 901")
    shutil.rmtree(exp_dir)
    return paths


# Phase 17: the bench family. Each entry point prints one JSON record
# last; the keys each record must hold as times, finite and > 0.
BENCH_TIMES = {
    "bench": ("value", "batched_frames_per_sec",
              "fused_multihead_frames_per_sec", "fused_frame_ms",
              "fused_batched_frames_per_sec", "net_ms", "vote_ms_per_kpt",
              "fit_ms", "frame_ms", "mvotes_per_sec",
              "mvotes_ref_equiv_per_sec", "exact_vote_ms_per_kpt",
              "exact_mvotes_per_sec"),
    "bench_train": ("value", "imgs_per_sec", "tflops_per_step",
                    "mfu_vs_bf16_peak"),
    "bench_serving_latency": ("value", "capacity_rps", "achieved_rps",
                              "p50_ms", "p99_ms", "max_ms",
                              "dispatch_floor_ms"),
    "bench_train_loop": ("ms_per_step_fetch_every",
                         "ms_per_step_fetch_interval10",
                         "ckpt_save_return_ms_async",
                         "ckpt_save_return_ms_sync",
                         "ckpt_background_write_ms"),
    "bench_eval_prefetch": ("value", "inline_decode_ms_per_frame",
                            "stock_ms_per_frame",
                            "decode_ms_per_frame_total"),
}
BENCH_REPS_SCALE = 0.03


def bench_counters():
    from rcvpose_tpu_torch.ops import heads, mmconv, vote_cuda

    return {"vote_counts": vote_cuda.vote_counts_cuda,
            "heads_channel_major": heads.heads_channel_major_cuda,
            "heads_channel_major_bwd": heads.heads_channel_major_bwd_cuda,
            "conv_same": mmconv.conv_same_cuda,
            "conv_same_dk": mmconv.conv_same_dk_cuda}


def counted_main(main):
    """``main()`` with the launch counts of ``bench_counters`` set to 0
    just before and read just after, its standard output captured.
    Returns (its return value, its last line, that line as JSON, launches,
    seconds)."""
    import io

    counters = bench_counters()
    synchronize()
    for f in counters.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main()
    synchronize()
    secs = time.perf_counter() - t0
    launches = {n: f.launches for n, f in counters.items()}
    last = buf.getvalue().strip().splitlines()[-1]
    return out, last, json.loads(last), launches, secs


def run_entry(name, main, want):
    """``counted_main(main)``: its last line must be one JSON object whose
    ``BENCH_TIMES[name]`` are finite and > 0, whose ``device`` names the
    card, and whose ``mfu_vs_bf16_peak`` (if any) is at most 1; ``want``
    names the kernels the path must launch. Returns (record, launches,
    seconds)."""
    _, last, record, launches, secs = counted_main(main)
    if not isinstance(record, dict):
        raise AssertionError(f"phase 17 {name}: last line {last!r}")
    times = {k: record.get(k) for k in BENCH_TIMES[name.split(" ")[0]]}
    bad = {k: v for k, v in times.items()
           if not isinstance(v, (int, float)) or not math.isfinite(v)
           or v <= 0}
    for key in ("runs_ms",):
        runs = record.get(key) or {}
        flat = runs if isinstance(runs, list) else [
            t for ts in runs.values() for t in ts]
        bad.update({f"{key}[{i}]": t for i, t in enumerate(flat)
                    if not math.isfinite(t) or t <= 0})
    for key, dev in (record.get("device_ms") or {}).items():
        if not math.isfinite(dev["ms"]) or dev["ms"] <= 0:
            bad[f"device_ms.{key}"] = dev
    if bad:
        raise AssertionError(f"phase 17 {name}: times {bad} in {record}")
    if record.get("device") != card_line():
        raise AssertionError(f"phase 17 {name}: device "
                             f"{record.get('device')!r}")
    if (record.get("mfu_vs_bf16_peak") or 0.0) > 1.0:
        raise AssertionError(f"phase 17 {name}: mfu "
                             f"{record['mfu_vs_bf16_peak']}")
    check_launches(f"phase 17 {name}", {k: launches[k] for k in want})
    say(f"phase 17 {name} in {secs:.1f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }: {last}")
    return record, launches, secs


def same_payload(a, b, where="payload"):
    """Raise unless two ``torch.load``ed payloads are equal: the same
    keys, values, and tensors of one dtype, shape and bits."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b)):
            raise AssertionError(f"{where} differs")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            same_payload(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_payload(x, y, f"{where}[{i}]")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def check_async_save(config, train_mod, checkpoint, labels, geometry):
    """A full-width training state after one step (Adam's moments exist),
    saved with ``async_save=True`` and with ``async_save=False``: the two
    files load equal, and the asynchronous save returned before its write
    finished."""
    import os

    cfg = dataclasses.replace(config.Config(), batch_size=2)
    state = train_mod.create_state(cfg, torch.Generator().manual_seed(0),
                                   device=DEVICE)
    batch = training_batches(labels, geometry, 1, seed=3)[0]
    state, _ = train_mod.train_step(state, {k: v[:2]
                                            for k, v in batch.items()})
    ms, payloads = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in (True, False):
            d = os.path.join(tmp, str(mode))
            ck = checkpoint.Checkpointer(d, async_save=mode)
            synchronize()
            t0 = time.perf_counter()
            ck.save(state, epoch=1, iteration=1, best_val=0.5)
            ms[mode] = (time.perf_counter() - t0) * 1e3
            pending = len(ck._pending)
            ck.wait_until_finished()
            if pending != int(mode):
                raise AssertionError(f"phase 17: {pending} writes in flight "
                                     f"after a save with async_save={mode}")
            payloads[mode] = torch.load(os.path.join(d, ck.CKPT),
                                        map_location="cpu", weights_only=True)
    same_payload(payloads[True], payloads[False],
                 "phase 17 async vs sync save")
    n = sum(v.numel() for v in payloads[True]["model_state_dict"].values())
    say(f"phase 17 async save: ckpt.pth.tar of the full-width state "
        f"({n} model values, Adam's moments) equal to the synchronous "
        f"save's after torch.load; save returned in {ms[True]:.1f} ms "
        f"async against {ms[False]:.1f} ms sync")
    del state, payloads
    free_memory()


def phase_bench_family(config, train_mod, checkpoint, labels, geometry,
                       kernel_cache, cold_s):
    """The bench family on the card with the reps cut: ``rcvpose_tpu_torch.
    bench`` at full width, ``bench_train`` for 2 steps on each conv route,
    ``bench_serving_latency`` with 16 requests, ``bench_train_loop`` for 4
    steps (batch 4) and ``bench_eval_prefetch`` on 4 frames; then the
    async save against the synchronous one and ``bench_compile_cache``'s
    warm child against phase 1's library directory. Returns {path:
    launches}."""
    import os

    from rcvpose_tpu_torch import bench
    from rcvpose_tpu_torch.scripts import (bench_eval_prefetch,
                                           bench_serving_latency,
                                           bench_train, bench_train_loop)

    k1k2 = ("vote_counts", "heads_channel_major")
    train = ("heads_channel_major", "heads_channel_major_bwd")
    paths = {}
    _, paths["bench"], _ = run_entry(
        "bench", lambda: bench.main([], device=DEVICE,
                                    reps_scale=BENCH_REPS_SCALE), k1k2)
    free_memory()
    for route in ("cuDNN", "K3/K4"):
        if route == "K3/K4":
            os.environ["RCVPOSE_PALLAS_CONV"] = "on"
        try:
            rec, paths[f"bench_train {route}"], _ = run_entry(
                f"bench_train {route}",
                lambda: bench_train.main(["--steps", "2"], device=DEVICE),
                train + (("conv_same", "conv_same_dk")
                         if route == "K3/K4" else ()))
        finally:
            os.environ.pop("RCVPOSE_PALLAS_CONV", None)
        if rec["conv_route"] != route:
            raise AssertionError(f"phase 17 bench_train: {rec}")
        if route == "cuDNN" and (paths["bench_train cuDNN"]["conv_same"]
                                 or paths["bench_train cuDNN"][
                                     "conv_same_dk"]):
            raise AssertionError("phase 17: the cuDNN route ran K3/K4")
        free_memory()
    _, paths["bench_serving_latency"], _ = run_entry(
        "bench_serving_latency",
        lambda: bench_serving_latency.main(["--n", "16"], device=DEVICE),
        k1k2)
    free_memory()
    _, paths["bench_train_loop"], _ = run_entry(
        "bench_train_loop",
        lambda: bench_train_loop.main(["4", "4"], device=DEVICE), train)
    free_memory()
    _, paths["bench_eval_prefetch"], _ = run_entry(
        "bench_eval_prefetch",
        lambda: bench_eval_prefetch.main(["--frames", "4", "--repeats", "1"],
                                         device=DEVICE), k1k2)
    free_memory()
    check_async_save(config, train_mod, checkpoint, labels, geometry)
    paths["bench_compile_cache warm"] = compile_cache_warm(kernel_cache,
                                                           cold_s)
    return paths


def compile_cache_warm(kernel_cache, cold_s):
    """``scripts.bench_compile_cache``'s warm child, a fresh process,
    against the library directory phase 1 built into: it must compile
    nothing, load the serving libraries in less time than phase 1's
    build took, and launch K1 and K2 in its two ``estimate`` calls.
    Returns its launches as {kernel: n}."""
    from rcvpose_tpu_torch.scripts import bench_compile_cache

    rec = bench_compile_cache.run_child(kernel_cache)
    say(f"phase 17 bench_compile_cache warm child on {kernel_cache}: "
        f"{json.dumps(rec)} (phase 1's cold build {cold_s:.2f} s)")
    if (rec["built"] or not rec["libs_s"] < cold_s
            or not all(math.isfinite(rec[k]) and rec[k] > 0 for k in (
                "first_estimate_ms", "second_estimate_ms"))):
        raise AssertionError(f"phase 17 warm kernel cache: {rec}")
    launches = {name: 0 for name in bench_counters()}
    launches["vote_counts"] = rec["vote_counts_launches"]
    launches["heads_channel_major"] = rec["heads_channel_major_launches"]
    check_launches("phase 17 bench_compile_cache warm",
                   {k: launches[k] for k in ("vote_counts",
                                             "heads_channel_major")})
    return launches


# Phase 18: the learned end-to-end proofs, each through its ``main`` with
# the counts set to 0 just before and read just after. The synthetic 3-net
# proof runs at its defaults (600 steps a net); the others with their
# steps cut to E2E_STEPS, each under its own gate. LMO passed 1.0 before
# and after ICP at 300 steps in every run and at 150; --fused on K3/K4
# sat at its gate (0.75) at 250 and once at 300, so it trains 400; YCB
# sat at its gate (0.85) at 300.
E2E_STEPS = {"fused": 300, "lmo": 150, "ycb": 300, "fused K3/K4": 400}
E2E_YCB_TEST_FRAMES = 4


def run_proof(name, main, argv, want, gate):
    """``counted_main`` of ``main(argv, device=DEVICE)``, a proof: it must
    exit 0 (its own gate), its last line must be one JSON record whose
    ``device`` names the card and for which ``gate`` holds, and ``want``
    names the kernels the path must launch. Returns (record, launches,
    seconds)."""
    rc, last, record, launches, secs = counted_main(
        lambda: main(argv, device=DEVICE))
    if rc != 0 or not gate(record):
        raise AssertionError(f"phase 18 {name}: exit {rc}, record {last}")
    if record.get("device") != card_line():
        raise AssertionError(f"phase 18 {name}: device "
                             f"{record.get('device')!r}")
    check_launches(f"phase 18 {name}", {k: launches[k] for k in want})
    say(f"phase 18 {name} in {secs:.1f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }: {last}")
    return record, launches, secs


def phase_e2e_proofs():
    """The learned proofs on the card: the synthetic 3-net proof at its
    defaults (pass rate >= 0.75), then ``--fused``, LMO (ADD pass fraction
    >= 0.85), YCB on 4 test frames (AUC >= 0.85) and ``--fused`` on the
    K3/K4 route (>= 0.75) with their steps cut to ``E2E_STEPS``, and the
    overflow retry (2 frames scored, 1 through the retry). Returns {path:
    launches}."""
    import os

    from rcvpose_tpu_torch.scripts import (e2e_lmo, e2e_overflow_retry,
                                           e2e_synthetic, e2e_ycb)

    train = ("vote_counts", "heads_channel_major",
             "heads_channel_major_bwd")
    k34 = ("conv_same", "conv_same_dk")

    def passes(gate, frames=None):
        return lambda r: (r["value"] >= gate
                          and (frames is None or r["frames"] == frames))

    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = (
            ("synthetic", e2e_synthetic.main, [], passes(0.75)),
            ("fused", e2e_synthetic.main,
             ["--fused", "--steps", str(E2E_STEPS["fused"])], passes(0.75)),
            ("lmo", e2e_lmo.main, ["--steps", str(E2E_STEPS["lmo"])],
             passes(0.85, 8)),
            ("ycb", e2e_ycb.main,
             ["--steps", str(E2E_STEPS["ycb"]), "--test_frames",
              str(E2E_YCB_TEST_FRAMES)],
             passes(0.85, E2E_YCB_TEST_FRAMES)),
            ("fused K3/K4", e2e_synthetic.main,
             ["--fused", "--steps", str(E2E_STEPS["fused K3/K4"])],
             passes(0.75)))
        for name, main, argv, gate in runs:
            out = os.path.join(tmp, name.replace(" ", "_").replace("/", ""))
            if name == "fused K3/K4":
                os.environ["RCVPOSE_PALLAS_CONV"] = "on"
            try:
                rec, paths[name], _ = run_proof(
                    name, main, argv + ["--out", out],
                    train + (k34 if name == "fused K3/K4" else ()),
                    gate)
            finally:
                os.environ.pop("RCVPOSE_PALLAS_CONV", None)
            route = paths[name]["conv_same"] + paths[name]["conv_same_dk"]
            if (name == "fused K3/K4") != bool(route) or (
                    "conv_route" in rec and (rec["conv_route"] == "K3/K4")
                    != (name == "fused K3/K4")):
                raise AssertionError(f"phase 18 {name}: conv route "
                                     f"{rec.get('conv_route')}, K3/K4 "
                                     f"launches {route}")
            free_memory()
    _, paths["overflow retry"], _ = run_proof(
        "overflow retry", e2e_overflow_retry.main, [], ("vote_counts",),
        lambda r: r["frames"] == 2 and r["overflow_frames"] == 1)
    free_memory()
    return paths


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs the card",
              file=sys.stderr)
        return 1
    from rcvpose_tpu_torch import (checkpoint, cli, config, fit, geometry,
                                   infer, labels, metrics, profiling, utils)
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

    # a fresh kernel-library directory (--compile_cache_dir), so that phase
    # 1's build is the cold start that phase 17's warm child loads from;
    # removed when the script exits
    kernel_cache = tempfile.TemporaryDirectory(prefix="rcvpose_kernels_")
    utils.enable_compile_cache(kernel_cache.name)
    cold_s = run(1, phase_build, vote_cuda)
    k1_stages = run(2, phase_vote, voting, vote_cuda)
    k2_input, k2_err = run(3, phase_heads, heads)
    run(4, phase_frame, infer, geometry)
    launches = run(5, phase_serving, infer, train_mod, fcn, voting, config,
                   vote_cuda, heads)
    k1, k2 = run(6, phase_kernel_times, k1_stages, k2_input, vote_cuda,
                 heads)
    epilogue_row = run("6 epilogue", phase_epilogue, fcn)
    errs = run(7, phase_conv_kernels, mmconv, heads)
    train_launches = run(8, phase_training, config, train_mod, labels,
                         geometry, checkpoint, infer, mmconv, heads)
    times = run(9, phase_train_kernel_times, mmconv, heads)
    stages, var_errs, var_launches, scripts = run(
        10, phase_vote_variants, voting, vote_cuda, geometry)
    exact_err, agree_launches = run("10 agreement", phase_agreement, voting,
                                    vote_cuda)
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as train_root:
        lm = run(11, phase_lm_eval, config, eval_mod, train_mod, fcn,
                 geometry, vote_cuda, heads, root)
        icp_rows = run("11 icp", phase_icp_kernels, config, eval_mod, fit,
                       infer, train_mod, geometry, profiling, lm)
        var_times = run(12, phase_variant_times, stages, vote_cuda,
                        scripts["tiles"]["best"])
        eval_launches = run(13, phase_lmo_ycb, config, eval_mod, fit, infer,
                            labels, geometry, metrics, train_mod, vote_cuda,
                            heads, root, lm)
        cli_launches = run(14, phase_cli_train, config, cli, checkpoint,
                           infer, labels, geometry, heads, mmconv, vote_cuda,
                           train_root)
        dist_launches, seq_network = run(
            15, phase_distributed, config, cli, eval_mod, labels, geometry,
            train_mod, vote_cuda, k1_stages, root, lm, train_root)
        orbax_launches = run(16, phase_orbax, config, cli, checkpoint,
                             eval_mod, train_mod, fcn, root, lm, seq_network)
    bench_launches = run(17, phase_bench_family, config, train_mod,
                         checkpoint, labels, geometry, kernel_cache.name,
                         cold_s)
    e2e_launches = run(18, phase_e2e_proofs)
    say(f"phase seconds {seconds}, total {sum(seconds.values()):.1f}")
    say(f"phase 13 launches by path: {eval_launches}")
    say(f"phase 14 launches by path: {cli_launches}")
    say(f"phase 15 launches by path: {dist_launches}")
    say(f"phase 16 launches by path: {orbax_launches}")
    say(f"phase 17 launches by path: {bench_launches}")
    say(f"phase 18 launches by path: {e2e_launches}")

    main_path = ("coarse", "refine")
    kernels = [
        {"name": "vote_counts", "route": "cuda",
         "source": "rcvpose_tpu_torch/csrc/vote.cu",
         "replaces": "rcvpose_tpu/ops/vote_pallas.py:165",
         "launches": launches["vote_counts"],
         "max_abs_err": max(exact_err,
                            max(err for _, err in k1_stages.values())),
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
    for name, replaces in (("icp_nearest", "rcvpose_tpu/fit.py:147"),
                           ("icp_pose_update", "rcvpose_tpu/fit.py:166")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "rcvpose_tpu_torch/csrc/icp.cu",
                        "replaces": replaces, **icp_rows[name]})
    kernels.append({"name": "conv_epilogue", "route": "cuda",
                    "source": "rcvpose_tpu_torch/csrc/epilogue.cu",
                    "replaces": None,
                    "launches": launches["conv_epilogue"], **epilogue_row})
    kernels[0]["agreement_launches"] = agree_launches
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")
        if k["name"] in bench_counters():
            k["bench_launches"] = {path: n[k["name"]]
                                   for path, n in bench_launches.items()
                                   if n[k["name"]]}
            k["e2e_launches"] = {path: n[k["name"]]
                                 for path, n in e2e_launches.items()
                                 if n[k["name"]]}
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# The orbax directory of phase 16 as orbax 0.11.32's StandardCheckpointer
# (tensorstore 0.1.80: OCDBT + zarr v2, zstd level 1) writes
# orbax_fixture_arrays(), tar, zlib and base64
# (tests/test_torch_port_orbax.py::write_chip_fixture, pack_dir). The
# machine with the card has neither orbax nor tensorstore.
ORBAX_DIR = (
    "eNrsuHdYU922Lk5RijQVBZQqSFGk9xoEpNgAkV5C7733gCBFukhvIgqo9A4BQu8dpZPQOyTU"
    "BNJ++u19zj1n799z9n3uvec79z5nj/yRteZ45xxjrMx3rHcGqKT2ROmZpob6y9fAF09eP1Z+"
    "/Poxwf9hE/xl4qKif3z/sr/9FhQVFP/X6z/GhQQlhMQJ2AQJ/gTz9vQy9/gVnuC/pwWy23tZ"
    "OwPtzF2snKw9PNml2dhdPSzM/fgt7awtHd1c7V28+IGeHpb8/4Lg//W8XKzMPayA/wPxL9P5"
    "tf/qU/pXl9pfPOyP2Nidrb087C1/hwgM/nXrZu1h4+rhbO5iaQ38G5e9i70X0Mve2fpXLGc3"
    "oIun9R8+IQkpYWFRYUkRYRExEQkxKSlRsV9gS1dn538El5QUlxAWFf8D/usHd3X+HdHcytzL"
    "/I+QwQT/be0/jfT/8/wXERIX+/f8F5QQFhL9J///HP57eVhb/zs6sPNwW5h7WdoBfz0ZL0/u"
    "R2zcztbmLtwP/vA5Wvv/W7DRHyO/u8a/mfKb7L9xXv5u1r9cwr8o/a+w30v9nd/k14CPuZP3"
    "3+Txl6G/othd3Ph/9xYPc//f8z0d7d2AVtae1h725k72Ab8RNuZOntbBv/sHD7ebub3H78wF"
    "/1Hav4H/Ub6Cf+MU+k9MVuh/N1mhPyVZD3PnP3aFlfWvTvv7wsLe3PMfp/572n+U/B/L/UeA"
    "32H+lK3zdwU6Wnu4WDv9CSX+JdCfWqS1s4W11e8LL3MLJ+v//Rr/WO8/AvwR508o0dPS/Fc9"
    "j/5BQX+g/teycfilkh7/o2R+uXw9fkksoKed+R/TjH6JEEmTf8nRy9rtH6f4C/Sf+7x+J+Pt"
    "aQ10tbSy8Po17OXhbf3XoYBf00X+TTG/xJOHNfCPNYG/owKt3b3NnYBerkAbeycn4B/x/8cK"
    "fy+2XLydnP4by63/+/Tfr33pYWXvYvtfp/8EhURE/1b/iQv/U//9SfrPUvilnYWqjhy7NHug"
    "Mfu/bIc/eojxL8Ias2v/unWyVrb2sbe01v6r2/hXQzH+9T77PfZL9Hn8Bfla5dVroJKmDlDQ"
    "mD2Y/Z80/3/A/tLJ/6VBewq4ebhaWnt6AgX/RP4L/93/P8IS/+T/n8X/v9kBf5Ee/37wD2nx"
    "h/QDupg7W/873fT/p25+v/ntvF0c/37Y2s/r79RAsMk/O8V/mVkJWAhZSNoIiolaSFmai9oI"
    "mttI2ZiLiViJiopaC4uJCwv9p/NfSFxE5G/5Lyb6z/9//xSjXGCDZhP/9YaQp04Aa0ZPimUk"
    "sBFsVXZzGCHG6SGHttFv7xMshRIQoLjp1jhVFi19r68HU710UO6NSyPajTT6lKzYfpVRvRfp"
    "UDoc9yGaXjjN8/L6vsvd6krxL1kE+QTtBMBzR4zJzyF29E8o6xMkBFHxTk7jNggTohsXyMKl"
    "6n7LPA8fLyBLieZN3jmDcPdWp68x/3wYmEqbdCeJeeAdiohfQbf7zrBkaLDyh3aCNwwTcXaM"
    "E7pi6YzOjQsoT6lUUZDj/HSdtSdnudjCuU19Q+qjvrO1p+cVNi61WPxAVibYHz7DVG5lkdlr"
    "woT/SYpXNrDWY41Pe80efSAuGXGjPrrzlt27b9skKszNPpSNvveKeJ4KPzVJD6Y5r5PRuI2s"
    "tN1upgbRnfcg0k3oUbuXpM1Qh63mlvqo1l7P3WYcSMCqPspkvzoKC+8Dz/TFwmBrVXIfHu82"
    "o8vaFrpGB490ZrzTZsy3pfdj12jwAW11UbzPRd6W9+kIJDkcCIrDghjdOXhQdFurHQXs5piB"
    "sEcssu3JbEfL5Hnr9EYk/rli7yevfZYzs+FQjMq9JmM4bE4fIul+O1SSlFx6dSXiWAzeJBz2"
    "9umPieHe4ahXz68qcDM4Px6ezMtCL0cTt1ql2fAay0Yo51K/BMgUiY/r7eZ9aRRvuZ4gUT0t"
    "nfo5/rVreG0cAfHHB/GpWlPr8ZRx9FJ+eZgHVb43bjJ00U1/cDlVq/Hfv5LMj6BPmn3Pfb+E"
    "1NcvhoGhtuXalSie6PfCFdtaQoWP06eYzMjvcSp1yPDbbERImPmVDvqpq6tnkgXCZ7MqSOtb"
    "tfNoW/dMuH+yOHwY1QI/oB7x+LRdLvbDXC6C6NPE3VjqokcO5CV0dz8XfVHnNpmyK730dZiw"
    "e2pBUmgga/5TvVj36TOlH4y51ZaiLp/3g12+ryou3OF6+i5FnPbzsNfwjyDRHfssyBtN7c7X"
    "/mNSKseaJZk/Riuhj4YSbyMxRCsUOaWSGrb0aVc1lcwYNiuBzpRJsdmZY5N06TNZMOOo5zkP"
    "RAOvDVs65Ny4JcymQKTIQG7o73jlCm6SdoyNp+hKH92mRH+kZoPshTth/O1wlWSWWB1mOkYF"
    "0Goc/zsRcZb2jwhF+7eE0sx0gqHSfSsfq8Q682EcOLUPV31Y7t6jm9O/gqufvX7paRw6EU0Q"
    "+UREW4Gypf4aTwW09UZ85uwju/ud/JpxF3eET6y/6OvsGjCpvIsiIesk4v1T+O9s7mJvY+3p"
    "xf/H2f+/6Pwn/rf9X1BMQvCf/f/P6f/SDz0J/m3/Z9PvICKQZWvrvRtZxdaQGLND2KRGTBBK"
    "Fto5I3CF8A8Y+/+EbCD8Dc0mvZ5NmlF1Zd07G2CsDWMgGEKs1P9TdP1fZH/Qnv9fT30CVgLC"
    "kr9+UXNzcSkRUSFra2sxQSkRS2srYUlrS0FhIUtxm//D/BcWEhYW+tvz368NJPZP/v8Z9pvx"
    "BGrd7sS7PetsspqqC14E19dbQhvoCfwBSTps60tvSvOpGjGlQ/Ngp7Rhny2wODj320NgyHsp"
    "u4QCy94ez3EmpW8lFdE3imYJaYi4iHxhvRBvLJito0upG3LdWUu/5DWbSKOWGJs9KxVpBOyK"
    "FP2UJIVW/MQzU9+9u6r7/FyFebxiXS6gQKsH5qqRB09cQVo1pdWH9h/OfPUcPxwy9+pcgi/h"
    "Oz0MvRn4IVkVlwN5yFSgAhcVqQyb5qodz2v2nmoFAcoDBJxYmciQ4/4tjBH+rZ+bGsL1zRAk"
    "/cp1/CSIFedtZoZqwJskpZI/Mf+EEHiCc/yKeRajxpUC4niPco14rs6rFaenE0ciIknEie/s"
    "h1wnxdCvopBHKPpjePidW2d3b59Blcvuv7i19qu4n5APp/BTuDz+EDIO0bDEOeeAsp1x1hBw"
    "iF72yqgRCNIUVgUhXFmm74Hd3icFhXfAQt0IVlwFS1CBn3B8VcuuV0G8jfdx5WKr8Cs0ICAD"
    "XfPOBhyHXkVIdL2pFcQ4Xyyw43VR4Jv4hFTIA5AGLgFDtQJLgjDHQ75DvkK+SmBbx6YqZZJq"
    "QUogGZDEsD3OZtnxgb3enYujlA8m1V+9sdhzia7TPRg+Gzt9ZnTWwAOv74NclcHRRSRy+CRC"
    "Gc7h6+excN8WtEyIBo4fR41LADXssVQ5QtBw+Yu6kzJs2fkYztbIcekSgMav4/GFOI5fH+KX"
    "4ROhmqn+3DRDb6wLFGNoyu/yPmZJUUtG3O+UkXrGaRVJOkMYESmBaf/Iy8WDiwQQrnx8wHWX"
    "mvJuQjsRipHhCgGGipLIR0FIy92NoAOWhJBgymi8Jat2J1OZ/VbMF8VkZXZq8tcfeXjUWBY/"
    "cqk7kPC+DusW0zoS6Lny9koPhBbPj/JVXIUFGFQqk+37+DVK1j4pEI5JXtqyQJY0MSaQB9h9"
    "WQJNw4RVR+By5Dt1cU9d0qo6zWL8PvLR81MeuH19bXX/6UOVQjmbkHxZWw2X5665wIIdoYTm"
    "2OQZ3GPGBZZj9FZhZGpz+aEHi+29u+7dZWde9ODzWg9kjc+DG5Jar08YEs0f5TuSa+UxJWxp"
    "znkqfsU4mydR0Bl8Vb6qztE7YJlV9DR7/zvzwyqSntCctOuDhjOGc7YBC/itZKa+Oii82rHB"
    "BQvcmzo5ZS7im8/pFS2We3+Fb2OfQ2vPwJWhoWMRNTCHZQ/ZH83CtoVVX4zcGIDRMoS5dR+F"
    "vu+rlrMsHWymgRlNb8kFBRX7Z4n4m86YGTl77IuEn932yDkX1eBsVSEmuhdxh8hfdnntcVWa"
    "lqk0GkFcuFk/6oSVzeS1zPLea+1zwZUP9moJcx3crzPp/aaT/d2fujvLv0tUYwFSzC1Hbti7"
    "5tp3X0vniRgT6AQNthDMmFiGZN7ju4+VE5uTh5t+nVIYPpQJRO6iTBsJb3JkyydwlP2ovGb9"
    "gW/FSV51yXANrwWsN0rApi66BANj/RqVX1+LuXY0TvHiq6A+AwMbE9NNZQWF+0kfFexQb559"
    "4tcfvy2R8bEExWjKwXYTQ+XeZLyuKGPM06UYIaT+/rTS2r/pu5wtVDTu1eEAzeDTit4D2WtM"
    "10PDOrp1H+F4P0lLyhrzRBTwfJUz2tib+dR0s/ybN8OWv98dYd8BUvrDtoYllJxkoP89ZxVe"
    "gD3j+9oxkTPOrztj0fcADqYzxoEwadDo3PVXhyUmHK1LM+M2dGUjtfZZbDZf9OQcFAiJr4+z"
    "qamZZUREgDqoK4nrBQX1mTSdejp0NTGxHEwKagqCCkoKvO2hRPOE+M4LempivEXYlTySPFBB"
    "O0R/GXgfIZBDRKlGEEY8D2H7eAchcA1Ff0WUGENBSCCZ9OsUfYWIACFAQMBGQIh7ciJAhKIf"
    "hqgpIASoMRRXzgWoKSlxPfgewk6IJIq+WNPNhOLWrYd8gSsjB5RP+294OvHd8XFKWpOtsHhd"
    "UfDC2TFOqHvCTBJ6Kir0LsDEc4vbSPxt8K/WSJk8G0jpCF3wAf0YmTWt/zBa9tkiOTQ0tISa"
    "Vj0uQaUrg4euj7OMxFb1BUcfMg+cFQly9FkQgPRX1g/o7gl4puoGDNgw4C8uZ+7CR232xhzQ"
    "24tejEFBqkuUS4Flj7/XOblKWHx/4pqIMiQLSvqhWSEk9I30ijxDQBGyHyITgL9jocph4S9J"
    "xMw8JWxamKYlZPkmL/h+ialu/I3Res22wctb7K/OFBIkdOKCagpLysbyRsCux6+YUruOuCJz"
    "SL/dqP7MpXL1Z7AS0qn+DHzNZEniUOVLhMhqdCGS+kuxmKb2l3UJsEvpcQq+wqjxmGmB80sN"
    "MnAPVM7YOQ+5//klcR1wUmfzAC23mn9hsa8FNsq3JUMnpzls+55DRpbqVDGqcnj+pVHyTKDV"
    "AO3pK45bxqcdnZoxggxxqu6CRRJlOsgaAGzxQOtmPYp/TzpP1naob9uwF2Kz6QLq1nQE03at"
    "uD1/vyak4/opIxc7PbwPkGra4m6I/RCtdEXx27dP55N8npCNhjqXI3x09o6hTJM/LphsrWns"
    "oMZc5LtwpOl0zyXTkyVEDzLrbGBpiRLM4pA/XTlfOpW+SOWYM33pmjPLvFavujGO/Phh0uRw"
    "XqCQcklNptlwaWU9mm9Odkz7oJZCa+r+gS7cfFVnryeRNQh0gMVimdhvDBH9EmpG6XKM4hJO"
    "Nb+SBjGRyzMl2nowRdqnwqwBjfCaTFBeS/HzshejoupwdZqfJSwuPBE3dSnViVZU6qjPHg1+"
    "ixtr8i5jjeOz/PC+Xik+KVX9yk3ruJR3HT+qDb+oB3Q99DxojRHSS0UceahitkGONaA9B7Mg"
    "zPwtsHDJj/lcezK2e2Q1tGZJmoJMSQPKXdavqG4R0BKRKt8XCE9hVKBsvx5KsPdm6FZvg0/I"
    "ZzHVUipcalHSxYb7i/yrgEjPAG5/bL4ZPvbNplOJyGWVhjPOt2MV+ZhFbUZcZFimHefiSAB7"
    "j4XXRMcbMTWeAZNpZL5WdBdf7LqF31z09tSNr2aVPdzjPtobW3bTzJNcnIzzs22iyBl6zCJ5"
    "Vy+tfrmP+uCRZmlnuvFz3GffYChxaJBnkgjBHfTZ/nRDVL7cXBM/QcNKL0JDhDNYa6ABYPqT"
    "RqGFdPL8ETmFo1QmdpcaV99f2WVASAe60fBSCq+HNinE7m4IQVSGQE4abBFd1LvFoJPuW4ms"
    "bRjBpfSxZt1v+V8O8Bm2BAdfg1oD8icbpDN0nPUm85+v4d1z85hByfg7h/3EqZFbn7BmlbJc"
    "6abN+Soy/NBOIebza7eZShjGfBvkU7hvH0ZHpUvfVTqOcxOWZTISor/K7SbVjO3NZgbNQXKs"
    "zJJ7Hs8437IAT685CI5Y2WWcu1jwnkukKHXebI1n/SkRcxoo96q+jdmZRH+VIfArDfMRo3+H"
    "fYi9UcTjd/CPwSPEygncAgqOPNxe54TzWhSmr4IZbR3fp1nBy2w+baQQVtsSvu8focEnYuso"
    "kjl2L2OlWb7IRZ0GNXbQ45+aMDHeH+lEr1HoDsKFPcXgvXI++lUJ5ZvXHgMFQPEAU1zgwNEb"
    "8imPewjbxoIuYY++PVXu665jLvI8IYyZYCK/Swej3NLh1oUROLVVRYJSd0paGHcZH6MJ4Gb4"
    "00KNbCdknGRnR0q+WGaPOPbt2Lng2YvkuYQgFzdlVw7MoMHdGajGzzqPKdPWbd9BPFEeGRxU"
    "cPDtZ1m+xV7MELfGXs1Iz1pya91pCUthbw7cCWP5BW9rtITtKyhklv+8X6HQSnv2ySl2c2ax"
    "Qp/e9+3sbRMxrPO7osaKE+ZHtYcntsd6vM6XY9u7rQsqgaWz/oBsHgZD4lRA06jwq26heu0O"
    "1fjFfB6qD4X99jljR5w4leclhPEwKkWZl+dt6pdd4sLctheR9GX2wCDB8MeWYqoEdw5I5qMb"
    "88jpEJQd0iQOh/GdY90+rOC4NexdtqJrR6VDscptoBw8DhsWXg6Eh5CPKfDwhk+t7Ng3usxJ"
    "tuQHkxE2eMNYjGFDZ4tLR08CwNcciN1ffphUvbJ/GViNi4rmsCtsWmOZQiubbSBdtY15BSbO"
    "5dUwjTjNiYNlXwWa2aWeRj4FU2TatoqCFHs5vIkFk7f1VtvPeXMz9xEc8sD26pB6QBwDLAVW"
    "Fvv9sUC9UJo97mkQm8vQnqehNZlrF2gw14BlEDOiivTg+LybIxZikHdrM9daK1MoaasNkgHI"
    "HZbQDtS1vc95pyX1hQM7tSx1Hf/ilE5H7MXpZ0aIM/fa080OI21gfTleL+6bI1mKf65Lv+6Z"
    "ScyDrGd3rgVPsjLduXScSdIIemVA3GbBgdT1Ie9Y8UfAAcLAW6D2K2hiJJusoEfu+oO223uW"
    "95yq+h0t60eEALWfyxybq5KzH/Xjp5hX12EPb1DnXx337pBX0uNyEJO2ey1JA+uWeOK0s5n0"
    "ZVTtiAqAa+nHXCntXVkSYln1bGuAFqQ7AtFd1WU5571Dba8X5v0vcq+3LQxCkQStNKyCj47z"
    "2uXC2vZxwb6+tGrVIRi0aVB9fKiEQHD4aKZ79WutT7lzgMogO4Z0lESoaSNce5E6HBPR69WH"
    "uhyB+0iA2zIimpY1quUAj67NyFS9tFH1DVzaUjfE5M2fjcUD9xon0vaYXlmyrVF+j7R/cxJH"
    "vGJoXCQvdSN2ZDRUNgmH2ZM1DZwSlmFkVtyJ2UY8R+k5suJT234gaCsQka+hbLFnRk8G5OEv"
    "VbiigicyMfyl1HOO18aXV9BkLVngV7PIUwoG8qbWnAo0cQ5shVjE0wPVyYEa+Q4baqeOxv88"
    "EZCmjYSlHKxBJ2nfvdidEpwyNvIm6A+MPmq6uC6nqWGd38IMSwCfj0BXrbU7ey6c0+Enmxoj"
    "27tTTVTlF3YOJhsBp75Ima2K96vaqr7FiMthPaydsUa3S2tXV6Vvnaj27BdYTmuAP0B4LKfE"
    "PRDs7p7PxVqsr91ywMQ42Yq/2rYdXK3HzbxTMVDQlVwxlSvugze47aMrTEln+sZ1YjlZ9jbN"
    "svfZzMKLHNZbzAPS8woGPRrn3iFE8uHo4xhr3Kvg8vcBNBfw1+4JDBt3cBimWw/hG9Hezp/F"
    "o37sUZXFOp21j5wwV/9gEPLOvdfXxzzfcxtigQv1/cF4MiftB1NiAMMY5E96jkpF++Inr7+D"
    "bNCUWJL97IveHA4UvatHG8Ykgu9mGYmTX4DclScdTRM80QuaLFyaqUIuyc6KmG9GcOQeEjdo"
    "LagEUOCyz4QoWBpljUP2bbF2MFYOE7rn6s5TbmftgDJ2pdheIUlSPZe8NeBIcO/K2fZl5MoL"
    "47FuSSE9tsDl272Wo/mfvlv28YuP6D+c7d6lhVqx9KvLCJz6446185lY3nB/OGu4y90ZpkQT"
    "9OHFfn75l+Cb9Px15mjPwNKgN22FNV/3yvY2di5qcvLYvvZdGYGYNh+CuEiy/GEVURcq71SD"
    "waoXmrElV3NjF244mNvRiEX9qBpdaR6azJYKBexPLfS1+61csMQLRhw6pkyIlTh0mrEFETIX"
    "ex447saUW+BLohS9HVNSatjgokcden0r5uPo0zJSF96My/xlhE8lvyKN3JzItqcGBSIKgsHQ"
    "yNAh35xeDcrhK7rhK0zs+SRwJH2lk3fF6EkFDBtbAU6547HzIuQ4yqMngCAknHWzJpcTfq4B"
    "oH8vcHHRgnByt19gQIeO4/vNA0Duxt7ouL2BGp2isALu8bWhXmnhIUrfuxZBUXGP9iogd/eg"
    "cO8R3qCM8mY2qsU6Bxub2fg2NkZ7pPK3s77NfJYvuaVwuYnahUQWdb4tPV3WUfuassNb781h"
    "WVc0vGdaFfrOpwJ/GjkHF+jVMhrxzknZVUcss4SQQf1ba7Tye2jfTBHUBXHCcVhXGkDek6NI"
    "6Nb+vWlqPCUO6yk7GrwXfJWUgKNcW28wvL6fKmCtc/TzjQtLsN9mzrhKlw8oiEbmnB5f4wGQ"
    "vCs1xSHTXbev9IjN8UZpArwmIA7Eml0nokoRwDxMWeZzmNJYb87FJoJvoi1PvFoMN5InSkjC"
    "fcwfiloFcUVq8oMEnGAhMaSsR84hdnGXxQngBP860x94+5xWEVdeNWxH5udUWY8XPos9VUtN"
    "BxTJQ4JPNzro+5jV+9dyAR910hf04QZyo8Ft3HjOHCW4SmD0ozub294d3vgiv5MQMvOT17Ql"
    "Iu+k7QydyUhE8u4JfDpmQ9lwjyyFet5e+0To0cEMje4Y9c7ZJHmvVF3sh4/x2/CxXbJ1mytU"
    "a7PPviw8f/b87HmPx1cEp6jenO+q6alz9VizRVvRJ99akfL8kA684aKkBLylwVaFXutR4v5j"
    "ZVUfJhoU5UTdRiTerxTNdhz0FPCZqaNCS3sgYdcvdFcIF9WvZLVRnlc3fyeG4dZ6aqEitVaf"
    "ODgauiRA5MPRQiKRWFPa/lrrWZ8SY36dbH6TD52vuVcrNRPEV6jSn+0Zqc/FGqw+9syW3GBq"
    "YIjWY+ROtLkQ82hNXW074QrQMhHQKCF1zElTQqyUR/+c2DTJYw/TW/Ruw9NEVHzdn11ss4oj"
    "20dfXgACW0fkKshXajeDX4ETrQGBlbISryYPv45aJJFtvtM2vnV8FGom9mq9+CnmOYtKC/MB"
    "Wv8BVEYzdesKzPsNjHbRooOlw29MrYoTxduNaBfCCxGTTaFJDpnuN7Zy3jn9NrIg87VPtPwm"
    "sTa0Csl0Rh7V2l1v0Io0rqbydWV2OpaRCUW8+Ex1I5gOI4pkhkpZdoTc8EHgLd8KOdYKMVfg"
    "+dt6FMNIrAWwH4OVzm5xS4k+88XY4yJNavJWW22LaaaZGfOCb8jVS/S4yzCBNLqL/QkhN5CK"
    "QL0W6ovimf14gbWtXUuN/jIIhD9GY0ssXWIXyzFgfSZj0ywDXpJ6DaZp1G4iW3bjg2YDJKfS"
    "tUGDgslv2aS23lwUggLADc8aO76P7iQUV3BWmLzjEjyoHQKd27p21kqxpi+1bAIivh7R8noT"
    "Sb+HXtlbfaQ/Nke8Fp09DNIGZQuhUGdDZCHuaYhA8iqhKYe4gbrjra46IpnbW/eXMbm42PqB"
    "/c4RY2JLFAFNR9s4T8D+3Uz5y48Cn2uo6sKrU2uKOrmj0GBGRQeYO5fPQ3NSCscUG8XNXUv9"
    "1SW94l2bSqZYD1K6NMxxoQ+38FWfEW2VEO79R/AFqeuJ9SJlP0ezpNbvuaqcfMGcp3BArebW"
    "0pAxoJAcgfqK+btmFqqcDejWWzQJTw6iM2aquCe4YYzOyksa50AI95Q6qBJPEAG2ZADgGbJu"
    "CFU2Bi89OI287sWAu3cqzTxdAKDfiuHL37fHaFxbIJ3V1D8n+8pp+InxjgWM+tKABAuYAAGf"
    "1h6KnXohpqr7qJp98Ku+CgVg3fEtp30FkI4XC32w9ol9I1Spaw3t1GjjJx0km+trNr0DUUqY"
    "6knYkFdYjFfduZQ6cPdlwc8LePGN6TeivdzXEP5jA3wyWT6L1Sr4FYpQ0EHlpcB1DVWSltVK"
    "C0i2oRcr1VJXAQwuSUoNgiLyqX+Jqpp9vdO1ZX/PdgeTLYkoxpNe56lRmWC5Vtzi7nIkNs8U"
    "K3KmhF1bF4lsKZsNoG4aCCrsn2iY3s8/tvRLxKX44tJrigzzHQ/C6wvzLKoWwp1GEFc3QTLx"
    "/sMBabmD5zlOCRsvwieTAwSq+cD+U/mEUjN4phbuFFjXtxGXRNTo/plUbMN2sXPPJCOavM3w"
    "KWQZVg587TyKvNSkGIlezT9JQm8xhF1eC81Rz/4BOBYZIZesDy64ubKohv2M3CH3aH6Ouz6U"
    "oGepumqaQhN/LICiF6FP8GA8jTnURqVOSFqEMCIWi4ASQ11cc+pWTvJyLUfJZoEXfFso+kjb"
    "2Nx0vNrxtpPgDp+n7TRtj2Sno9nMy4Cs3PF3NMSOR7ZiMtGuBQJnV0/ER+AtSePAboE9sbQd"
    "VG3q3S1K4gG5+JB4X1/jvLqrP5suQg4fOqaH4zcPVNNXbEdQHie6UPFjcMN2lNd+wA2Pr63n"
    "sW9Mm8XXs8hmx7mFVfd9zwOFZ9AkskOwOrb8cPV56x828tzKsvgpKGIN84BbxSeN3vBGJ6UC"
    "4LDJy5V1/ptuQFRHyVtS2/fghBCeFuXcj8ba4ka2ReLOb1N/8IU3Cw8uBdmqqGXD+QYFsOGB"
    "GtecWJyjWmwArcrgHwaELuhRqucybmuMMTu942Ah2B4k4GWiHSs89N0P4GOdH1zbjJi0hoth"
    "EaBvQczYi0PBk45ZqCyi432jxeZEYlx3PSub00ZA10I8be/hHnLG6dM4Vq8ppfvgm2+swPGt"
    "z2XtPq73dzsQiOLjoKml3RuigSSNjEGIwxLgWeU9sP57j9ZqR4yLpnFGVcWDiOT4UwyLtiJo"
    "yd+19OwWMjkrcDKEN1Z7WGesGFjbsN7KBto/zBWcRg0mpa3x0M+gczH565D++e9PXHW6g69B"
    "z6nd/PNDp2qe2QYv23c9bWRyDySsUmpvxYnjCEAQxaBL37gHjkflshRJS4tXx77+QPVKo12X"
    "laFvrE9P/EKiWo93EvPWZvxVjVUcbJZ5pSuoiJEUH8KUhrL3uUJOVbfyn7HL4/DfyEO6GYJ6"
    "BPeBZ1sV62i57ut+2mjTyZW9RMpG4IMRnMMF2cI3l9IQc0gCW9QHMqcQmJnSvk84FauBiCDz"
    "oM8RvE/UOWBoveLGoyiji42FigvYPfyec9S5jNXubop1eX9EzZ0m/CqM5li6bm0FSjY93TmF"
    "IrMDrBosGjeGxgSRPg8U84TG4ruTUvqGVg1iwSPWXB88RXT0g7YT6o0G+ECCkNyOcvs9eGwY"
    "7CQRuJVQ4CR/bVCM40dxG6uOUAp4yefIo/m0Y+YNzdH7qV3HjemSgwH6NUvF5kZaygLgBpw+"
    "/WaxTgdjaLJSeX0KWtL7ZX6DJKW7aPLcc4KGQJ35mwxt2J6ZNWTdmEH/jCefrfJdKu+l8lOK"
    "dQcr9FSk0nEFc5/0NvbZiuRlc8ygvoYm3f7VluWfxdiRLikSHdL3sv5YugWp1/vrRwX5pPle"
    "FArE4nks4eZPB+VLg4PyWO/NvezWAFRd+YmPjW/Nr/B93lJNMFEFKEw0IjQV7/5YkGgiOZJ9"
    "JIZ6m+6sB5NJh/k28ClcBBUsGY37bIjAXO1xcRXT4KR9V4JDhL2ne4Z6+8+Xyw4wZlAGCGrN"
    "0woJwRfaw45K1xOxMmO4AxgVw6FhRlsvzbKLnI/Gw5MQIKQ8xJjQ6xh+Ep58sEXywX1zR9bX"
    "B3ihZ/UpSiAl0GVJFEo0ci29OZGR3nlPRyVRFogXIbWI934/YxDSz1HL6Ml/HlqLFcJ5Xhgk"
    "JAQvnB1Dq0jovV7K8fSebimOuqz0McQynm4w7ZqFsFiOs2HPXxQ04QiEi7iyEYY/6Ix+NcQB"
    "2EXh8XFzhYd7yHN2YB8ziXZj+HfPodYD8darnmFUHrondVPhV5Dzci7hn+1PJ+ME7gqU6LPN"
    "LH7AVubPv+xyuu4aFDXiJWCPi7g4gODt2McjPsbXL6zYefqe6mJL8rFTSxoG2U0Ax0wkZcwp"
    "CmO2X7gjXn22ET2BL/c5745ZTLm8luOEZPZ8ZRAFORmrpPjcF6Pvz1ra/bGr55ivoHVbbKVR"
    "nNpWLzBkPXGdQVzETEnKeHEVBeuBn3XtdSzIhJm68K6EZZSFYgMqah6E7Fzk+VelUm9MK/i7"
    "TE1sw/wlz1uLCo/I7wG08+rTRwVeHH3HG+cjEqk2mgSBqX55pDuaAYk5P9JrGudweATtyYtz"
    "4uQTmqJZnyxB28UhzKcld9ytulTfm1t2E0tlTp9R9MP1bBSNzvT6xn21bRdMGk3uCQdIbGUQ"
    "InxVj4k7iFfYYQNQr4CUVVvWs9LHvTaWXt20ovjMSHC1nsvoq2wP1zFnf/NZDnR4uwPpWyAx"
    "mHId1+V+Tp4IOHxK0jhgPQl9mnAb6daS1dtZ4L1irmmrAWgexlkw2DNhX0B1fDHP80YF6BO7"
    "P2ed4zBBg9m86A1MRWg3bHO8bez2R+Zp1DrxJHWFgoU24s46FifArLgZRaf4WYlsvOoMz22N"
    "VPVgTyysqm/wJsLcx1Y19wrHuqZ/v2SaiEMJHXjVUpb5M6+PyX3kngLKwUfB8b4Utxm/ImLQ"
    "xh1fwzrVJGGd8OPC3Rf7u8ygBrnwF43bH0EolvOrL6BNdAUcqfqVhVs0IuekLY5F2nAXWT1f"
    "kRtZbaGxJE2SbQ0IbQt6vXXtCBrs8mE+/N70y3rfXQ1QfOJAYJFsA7cbRugsm1YhzYIYurjX"
    "GCtYfIkkfZv/Le6Gz57IaIEtUP/0q8Zz3/Um9mamFuultAv6xSa/XLdyBPfjzDessx4BKKT8"
    "ZyShcDg+zPkgCFPM2lT1OGGKgWeMak7GV8ewBwSTjeXs6OuUNJpnNlubuOzYlYq/L1E6TnWY"
    "iP5uOwtdWJZ7qQaxORcsLtxAxObKA4QFmLevvJPh9Py+eqxHcpjklna3X/+dFKQGbltl27i5"
    "29vhkg2NU3/eotPOuMxcX8d5Nn48TaZ6b4pjwwL8AxMrZwL2Ov7adFwOXD8ruDdraknhi1fm"
    "VXAt1m9eM92mZKOedZ1dxfNJOOCQ3OkjmR3jNnu1gehk+Y8VEoo/kZvp68DlzYCmGTEU+c19"
    "QCMFQiJ9z7C5pIeFJtSz42WHLEsLGj0DPULjVprAjtS4yzPXVmTFDA5J7/605PsIWXj2Ny4o"
    "YgWSOfKZ0UdicLhV/rJOftxxW2B2T2viWTJzRc+UvcS0HlXxRkT8RBo4mBhSrsQfNfoGe3nQ"
    "OmUj8+ilS83Q2eG1Ku39Jy8mOWuCd6lPYipPhPgGkFw3lchhqpNx32+rxwoy7ureme3TJcyL"
    "llvHzztDN76LcaSd0n/wvHqfvv3NyprlVC+MNp9HoruVds01MPs5/FHpSMjzZiwfcKvOZ1hI"
    "xNNOP1FOKFMnEctUU9Y6QOf3BccqYJ14ASTINa4yyT3raViTZy8mtZ89dtuBjo+9DKUAx35r"
    "tQssL8kbNfIy/tm8McYWUKFbGGkKF62xWZhON8+9bFviz1OURVLhIu8Rb6FRGwzVa8AqKVzb"
    "6tnFxbPgBBX/uFGNn3sOL/tX/ZJrclN3X9D5vKqWGTgCOIfwn7HunF889VTcACchD32mb08E"
    "9QOuC0vNTc0tfMRWnmcfUmbn9wSfgjZ4gcJEOPfbewJLBRpUvSdOrjUBmvW8Y58cnbiIFie+"
    "rbw4h/RZLUSVsSiqQGXpPKVap9A1D9ndCI0Wfcm3xqHTVUwfmTeXjd8KdTEsSEQEZS7+HFIP"
    "aNrBzzbNnuJ0nEaw8j2zr6cX8vf99omfNzDOQobOHbAALMuH2TnbGjli7f5nSRJnUPxLqGjA"
    "k7XXHN55+FsuEixnJnGlec4S+80a33f1BsYXEdw7C36eYJ+vDwFT4DLu3JeGet0SYuvEqwnu"
    "29jD+zUwP1GxT24AfGrGg7bjN2XZESN9bxpdxMa6t7Ch4rY1J3YhPHIbYNt76H2GeCOKZu5X"
    "KC9FgfJ8e45igX1TXwG9+DWDHP8tpSohBGz9ZG4vzbdmwT0vh+7R6hnXeiLZeRHy7R6g58IV"
    "3S/SyFo38xrKuIGljVpcYR5ZDik6a22RaXm185GwFHwu/XJWNLGp9dw2AbvxQbNKpUalq6I9"
    "MT3PCOvVW8kaTH90IkEYXDlqnnwWEd9ss649by3oipa06q3oY49iuCM3U25e5hua65HjaheX"
    "WWYq4Mbk+ba+W4e7yfzzjO+ayXpehLegxr4Yy09A8yEwFbhOdhznQbVb7B2JzipeTWIhxJHL"
    "DR3uQQ6SMi+cPhJV6DSXhBea1b51PIODfSpnH7XpAeHNr8Gy3T9vkgaJSER1vFtYOwwpMj6l"
    "m8rVbi1p8oIUXn14gLyY7WbUSAhO0Hb9cNEiESv9XUWyVYP0gawNpSoKFtCIN6BhfkZCS5Sy"
    "dPllRmgknHT9Ov4FjaTCWH4wCGLC4NT5KHSg83ZUn+DiqOeX76j92ETe0UNis9UKy+LryK8p"
    "xVkJBaxZDFF1WIuFN3IJVHqzeNzDreETBrGspEwlDdSBTXUnXtXqHrjlQvt5xebYgSjpgp/Q"
    "8r3VclMYa9+97KWWjLMYqqyGw4rQcdxn8M4WMwCjfNaXo9Z0Ymk3eGiBzvOppcw5GwHxzu7T"
    "73NvFJrluDgJXaHY5Jd/WkT6sbxPIvio+4SQDaAyxBC9p6eKWn1UfEJ3dCrS+RTuEiz9LOpn"
    "j/U4bpV7JUo6h28SYaZPmt5/PBbBpFuaki+ScRkIj4HMKXj8nMM7Qtja4nO7yO+lf9OmkMPs"
    "HhDkMIYAG0H2iQpZV5pxKfjs/PO8RfIlkDG+Bt1Xj6vGMEApeLhi9YIBklSXZ/mYqFCNdJ/a"
    "At8A4e2um/wC0cW8D1ruQGn0N7sU893vCbw0A01k0R0FtSR6HMqSuHq+hlPM5DI4dkYVIFQQ"
    "4e8X9fSRbzD4Ul1FtyLyxmt5e5wYVsn0zCYvXWn6bUsPGT9bXfrN9MejfV/tlONA1w5L+5Yt"
    "Jk8Sg/KXrfzH2l8US/gDHTkvaZyWKq5LXeACjsSZes1YNyWSwvMA/bmr3U6rHw0XREY3YAnQ"
    "rsNmpqSNKzafhBAiji6jNpKv/dMFiq77TG4xUfn7JtSY2a140atMnHy646w9Aqmuc+AXyqr/"
    "2czySj4csjwrSUcErJBsZmTZvo1IEEs/fk2kLwNpYcOIIL75hhpKXziGmNKou9A6ETZy7xOG"
    "hkQn04uhlutsenPDMe+4n2bgHpvCWRdidUJNE2UArcfMn3Qoy+f0Jq1T57wc9ssCPWrGCncA"
    "p7pVPjDD0vZjnXL/aDPKjyGyuJ8tAyWmpOmJ/p5yzuZkh8Kr6C4mpnfeJmUGhxJsWVdH+CkN"
    "LDED7lJfZMh9beTxgtSU/pmqpq9R6pdau5nYE2d8l+0RanNtFayBpkVYxjvfeuYkUZ19nfhk"
    "f6xq9NbL2w1WVaSXLzewTkULmoepQVzTgbmw1ZxHHBn7yueudMNBsVNanLBabWCE6Y22Aynd"
    "tJTytDOnblzKfZECz4PXZDCxqrWVSRnR04EHccFX9xYEQ94f4P2QG7lzeA0HXMOld+tbjbCH"
    "GqsLVqx4VaZKwrMZ+hDihPZRCIkHKr6aiT3/a7a45Q9WHmD8SPbJwDvcNorZ8j7aiLDAvqLi"
    "6EolSwB4VwOXxnLutMC0n1srV71QEM8dawIiCKrIcgGJDOBOyvB3jcr963G2fKDG0s6U/GDx"
    "iSXCvNOz+XrLSQfQnD9hbtPPibtr6Dw/32T8tLhpduK8bKI7iAhYaUe6Q7l5hFuWk1gt1F9y"
    "AfMcbk7sGqPdUumrXodkrT9w/bC3tnYw4L0+IzdOGZWl1Ju+Z2YzQ3hP1g1Umc7uY158HWA5"
    "o+fUxK/skmC01e5bltm7PJXSl93A8dIeUQBz5E5v7Uo+T2X1C7Gr8Iny7hTII9aY+LryLKUJ"
    "krkTOeaV5L4853PljW5PFBQdUdOMrtceW8/ecF7vL/eBdbMYRSKjYYQ74ZiISx2Y/2A5amiF"
    "0Uw9kF8QXj7x/IUkg5nJOX5WY86oxXR35kNY+kx+t0lFXjNjlpCz8tFH83SBmTz56uil0R7Y"
    "e3C0CD4PTlky91k8Lryg1QrCrPF8B9JJLdInP8YBHxNc3aGZ957ffse/dUf6fmDW84mxt6CJ"
    "/WNhk0Js2gqQOP91kNKS/ck6FeQTyWNu9jlCGMnaN3q8m3dDTTW4AuPRmupy+Hh0kVik4Xrp"
    "cDxb8Ap8GxTc0MxCvNI4/3JvY/wFYITyo2DDs5xm+o4xvaPMXc881HGexj29iG7rvNUZKsrN"
    "GIYQ2W6X1roMuguYewlx3iFdt6tescS3wkTAp1bVh32tCbJiPVPJd1emO/YXIg95+GPDJijr"
    "DgLXiD1n+9eeooZjmT3aClR2tY6gDljJ0nZwYp7rOVe1+tYzXFd9frdtSG0Yh1ytzWYVo5VJ"
    "xQkjN/+cvmf37hZtw5R61dmsEalTu8BNX8SqhnXfNeTOe9b772h6VOFAue3po9c7Va8Y9wEL"
    "nqkJ3l2+N+EewJYHxQp7rg1TC2aeuEYUFZBl/fJIhV4Ft30qtwwXA3MRT1/N7wuYpS+D2qav"
    "xkYXQh8Gvd2TvzaxYYMInJ/V4fW5MbrE1RL9aQVi+S4J69hWKYQM9ZJzDQZ3ZEDhVNCQYNPt"
    "4vPpbRpOF4Xpkesmr+9OGhwFyMjDKC7INeoHOZkvR6tJBw2YHJdSlx80LtBzLPsqfsn3efGh"
    "7Ec6FU1Lp0rMy32z8DG7MwFT0Q7hB3E1SATBHMsJ9Shg4cnJzqRTNIDiuEM2saXuTNFq0S7D"
    "8o1NcKYhn2xdgF5Lw6hVRp7tJ/vLmKU73Ex9yDpgF/Kanu38dKbXpwWKkrcXLWeRWbfzwly+"
    "6104e1wfarHUh9/zHZhJwnVgm90rm4/u3nKh2a1zUAoIq4ctWD/Y0V/rEIYCPK8YRHqloxcK"
    "CPunmctdil7AIuBcIamUTPTOoDbI9ldABCemnnWs/Imc6Oj+z3zeRDh9iWszLFp9E724Yp3g"
    "IRE3ZlQOmdmQmdemyQrsIqWZXTkue0Bxt9Y9q+nw5Dhe5ujwtNg0xxeUpGHiLeyZWC43OajH"
    "vW/REikfMnL15Q5GvGL7rIZOwnrLbZ/qKWSRq77nmeWoxg7IzXMiYOsjjRB9HiPZJgxXd89z"
    "XzLb8jyQHfZG6dpIlfvDU73ARNDlgWtXU5/ROuM3jcXirRvNyoYqe4CK6+UJrDF8slu0l4QX"
    "E3Eh6cjQA2fRQ0bo5srzkAIfm5ov/MeJJ/Qam1zKIqOSEODCBB4ceD46688V+DpTBNLB2fZK"
    "dcFxsBgewV+NGmzb8MlpOG5EaA2bq1EBIEBQ/9empUuVc9L5yMoUYvkGShrv0DDMNRjneRVu"
    "6uvQQ2uI8bzGQE+2WgO3pwSLjOHx95Z97DUX39JrlJscW8k9OSAdnkWgQ+IHyeKu5cUKIN4v"
    "ynwJylFHvF0UBxj7/i07lrVEnq75ZEASUZ+wp0dNsHcJ2fCYgNRpvGkh+sC9BoRQM6Lnnhob"
    "hPNWfPfNoSiALm/KEMDkg0ksT2Jq8mUUNtA0+zn5JsswmlkmCxn20y8TbwNvlAXPG7Ul2GOf"
    "hyvhj0AXxqzDNJ8dn861LPVNUhUzCZgW16jm1iSVTZ6xA5eSV/ObyUyz+B95MaXfN+Rh7a41"
    "C1RYJpt5u/vI0t7JTfHRJmek5KDC9Bt+FKR353mtWs2ZpMgdPteAGLGPnWGfsAqzHYAMV7tz"
    "TPVRR0JIenzI0xuko+EhVNDaZvEGi9mTx/b1y1GQtUBdzenRAvRj6MULw2MxDQ/saLq3dzDZ"
    "MVw4XcQMON34rHg8+I0/B6Ln+10KdQAaGTrmbnwLZvNEn3eJZ+0TX+IAcH2K9GH6u3AeLT4g"
    "ZckSmlmtiOX+6WDikeA5FwxFFwQTknoi+rOiEudL0JqPYcJsbXhLBcOASjvTDwGgGshkbjUo"
    "xskOcql+IQtLKUNKO0TjkvGc4MBAn6merbZtT7J4zwRE2kRuUeuSIgbNwVtb0yi/22tJujn0"
    "smbnofH8Q+d7k9mMxqtuHfdW6AVvXNiGCO7F5vBgX1w1lXgAUYjMkmWUkRRBamFRTLeIA2ci"
    "d0OPr847EmRQvzIK7PUBpIIKWxH7OWKHsTSccpmgkDsHkVawNwFR4PTQOcZmem5/+kGZLkrV"
    "wrGnO+iEy4fTF1cvVl0atvQ3Hb4VDGw++iZ3p6wPQEgaJS8hLjJ28aN8ax/ZlJEenvMM8SWT"
    "2AMwgNFrGg9XMEYXld/ysg0iEbi0gZ6IvwHOIn2kdBPYmJ6/TLRPI4speJyp7Y+9m/pz6mDJ"
    "bGpr9vAGTeCzDpBzYMiBXbZlZzw9al0tJGJEzld5lEHm1pswCkU9pM5O+cFb18/GC/1aGiLx"
    "leb1fiNWZ3SZh19fwMbINvGm2F0xl03tfc/dxkeJojYYGrlyS6pV12UWTcuMJYtLmupunJNM"
    "G000YIFxjavGWkJNJ0RabtxJvOB5T4GteSP9ndPiuPI1XOEckcwlHPpQFa7TQgBKmaKJUziC"
    "jzvrWTi8FbB8i2jEfFT1oz/EUvh8J8RtPx+9/fIrJDUIU6juYyYwCvdoM3YW4294OwAqL+YL"
    "5EyvBDKeZg+Frbcd5qpJ0BpvRPEm0yveAGf64eyz0WOSRhdhLxZD2jD3/Ha5LocDGgLnh6GN"
    "DU5C1wYcOvJCXmVwo64V+CsGIIzxDSK1vQxByTTL6tCGCdVLgxdRfvwH5H0Y9D5anFKCyMcs"
    "0Ko2t5mpuYDQl3YFz8A2oQo8M76RQdqxIHMQ1rX6IRM/1GF3oF9iS4pJCMKvg3Yqxr77iWdH"
    "hYTcL0GZkLuJHCz5sMg6+PDFunsxyNlKHcctMjq3xVmalJoYHJ7gmlC3O/2MuXP6hedx8m8O"
    "zgXnUbuHj2WExhYSmATHlvzGAayA5ttVnmq97/mDpfL2npBYdBqtH6O+BFyxO0ngzoD1ph2p"
    "7gnRjQD5Pq6GXy4SoH0bUy9xZwkyLo4Ncx8Z2WEfgUaChMjlH65jLPve1/MIeeJptdEQJgyv"
    "tTmIA7PBOJItGLWh6kO2NIWUsO08kWNNLUzgxKkf1wZANlRgArodN5TLKwuEn26/J+UWBNKK"
    "evwg1mzrPGe1p8WpTlgq9HEJwNFiiZq9t/UD34+yfxHh/sqhFhMYD3TmVRGbvr6515n50jSA"
    "Wekyioso6+z+Np2H3NucyxY5hTn3i0vmMYTMMf0SyJUuNPh66YjvEJzgkyxN6VRGw4XseNTp"
    "q5XMAvHQKBIsMZWo3cu7bwcOXMWalVRI0ayFU6fiqu43PeqsTkPt5y0WSzOfzD5da+6XNM3T"
    "w8mYX5jzHd/uzQ2bScVvKrYb0uvjcoSUy1SF+xhmg+X7P8I+rc/ajIvVH1Nxrp0PAp9Lep3I"
    "6+EKFjcCrntlynSR93l3n4itH0w9LsGAOxPALl6r9RN9FV10jPRjujiq8qDTmZvZvPgoJmkI"
    "9fz3ShHiHReJXfTnwpr5bXmxS0IkPFIcna5iuziR6+pVzriUTisrtQp2lm2OD9OQ7qNBSnoP"
    "g6IM6ZcoxYX2dic6VtHzFaNsx+mRYG8aI2xxQAXM4gS5J7EX7i+XA5PhpTEaGW7280v84ZxY"
    "2Hw7fewZ0Jt4fRWigxN5tKQVbv3zcY/NxNfBxMLELLS6s33kwaVmZX6pLe2cwUL3saFoo/CF"
    "/MZa+upZsJpTuHvK4A3plTiT8hlAgFJZEaEg/mXGCl0MG20cwqqT0F1LRekd812/8ZUfM5/z"
    "wlkLRkOG4wZe9rg6C7qsbaC+S+NUF709MM9iDx7aIopwnWmt+JrBGeGC8OXskwAcNMF/yzWv"
    "PI3aC74Hx50QLGfZkVhK548RDBfuwKNaYIeQu4skCTGyS6qK41m09YcY1QZd1uYnraVDX5pG"
    "SO8/ownl65tDFiRtAC+/vxnCNO66AEOiRhMuErEdlvv+UEl7uXea/ljdtQf9YJT189IDcbiP"
    "st62G7hFYpK8NKTJL61xqOLELD73VbC3qqALmSJkPE27nfVcRlAD054PEGh/0Rx0aIxTeQNC"
    "fX9Cp7Q4c/ciVKK4J2ADr7PZA6HOoMXarqfT7y2utT1rz/UPNtIQQV1sqadXLGo1isYHi2SN"
    "DVZVhsULEaQv2kTHjrvBKhIa0B3VKc6IeTkjaU2WwFs0tQKZJyuB36RtRTdePxAuVoS9whcl"
    "6Oh0RawOfWPNl3VG7Q/eXHjK+ul1+Ho3hzSr5kQwe9al34VGsp9is+mn8TXi1iA787sDJpIo"
    "m7oqG5axi+HO6kMW/ueMGHqa0+pvM5HEh4IJfOggMO10nqgsLLhZInEjN3kimh1PiZ3pEGBe"
    "3Hgf+OyOUFLiF32R7qWGxLqQftI99+3o4li1/c9Hr3ZlrcKn/E7duiU4aVQL9WgOD8VCV4hZ"
    "K707SdxNTlxj8Cd+Jx3+66AMXipTgzzSRoQ70kw5LAbgFBUNUos90ZK7sO0kQEHvnVIZpE5L"
    "704Xc+BDd2uO3MovbjUTC7CmrNE7LnJLYHjPy2dJOVhUGgHMy5RcMr0iAVHnuafy1XHr0QGB"
    "9vxunbRPo4YJjEk+yE1UKK463p5foZgbgPO9NwmV7wDP9g0XJH2AIR58m2fhwUsB37KKRHnq"
    "3d83hJ9chueuQnXqpLdIWHe+zMrNkcy1K/qMCPZTPymhYWuQlLpnGH5vFISgz2RysOB6tE8b"
    "uoHYrSdxE49wsfmO2cDe5DyO8t5ZloAwaIT6BC01LWBFXlmGhnuShwUEN+G+aG6hzC8SCSGU"
    "jdAEjIiZRqws+yNHpeuFijbK/Yc9QQYjF3VE8jnurRInl9kGt1ez71F1Bz/Yj4p5B6ge2A6v"
    "1JrH78J/6vbKi71scxm8h1rtkk4CYXxb44PaaaZpaopOjiC1OXIGhCBXbxigDXbWE0XhGUiO"
    "BU67u0wfbq8asS7otJuyUIBlJsiNBdyFRSRt06d/iEO5AOVH57To13IZcYdHIqcx7wTgHBf7"
    "GuKjbeNh5x0CbY1pRo3PxwT6D1+OL9RM6Xdml8dVxFeA1YXLrUl9v7FvhnO9oZlaSMKrHQrY"
    "6Dbw2L5FszC3Ra2jJmaKu31n0qz69Ftr1u6vT+Rxn31VzK71RKq0FrmYBClfNkpehHg3REL2"
    "BWo2nX3ZAbltpAFlrNOlNAVhp2/klWk+SBWG6DO6Z9mcEwBt75yd/MT+ZEEeYSMeG22cZeAN"
    "SOhGc1KpoRUFN1y6IOu+tNrLdB7EGe/QFwFQY4vrqRXuGBlVg7HG85KBjyjW47Dy/SpX1UDM"
    "VnHbtyw9zLbW6g+5NmWhogyDDCbeq7x8zOV7TkymfW9XZm13BnrGOPqqhobXdHMluYx/+q0W"
    "90nwpYU+9vpQlml72ARmYRkJN4SuKiNY+3ahveQIF0mPQeYsfffdspOE4A8XQYxbmc+6yG0W"
    "VwEeeqIto2/k1J4JmoMPFGBvUd8B0WfZoTgBTZ/CF4fkGPcz4IHMY59DJPKo2CdHepfh3kXE"
    "Simz+Wnhw+hRlmbeiBef52X2kneYQ1YOH97YY1kHost5wFbMSVJVesGfYJbgnhDLOG2ScBxr"
    "O8Egy+kxBU8FH07IUMTydvTXSeiAAQ6nh++k9cmBIvvy/W92U8jUQ1pAMuILOeeHgaTPX4rn"
    "Mpm6rCpH5preqU7PdXnEH3xJNCgFkFw180K0vJjQyBpZN+eP1ag5eMUhqvFME0j5aFBvhLti"
    "8EY2Ej99sjl5bnBIC7G3wVd+32tRSniSdwezzg9M7ikom9NuW3xefGbsYOmTKppPSO57z7iF"
    "gIxmdPzGmXfskXOOhnAXJmU0uD13XSRsSwqUrnEeM0cLDx/EX6e71RRtEgdlU3Kj+Sq0wSsP"
    "JJNHnR2gnR9ZnVYGmXEnpMavugg14PXGvvW5gWxmtJhXqQUZp4JNNn2lwlejGtgmZ8QM2/dy"
    "AXiV2RVuzEZjncxpCXX66F1TPkMBk3dXUe/3h0Gy+dWqvnuNEro3ud8hmbmLgxYln7FMjbEs"
    "+l7NgYzt0rYd2cwKQ2siYlvRo+/fA1BHjUKJP9sihXTTIE199RkPauu6mkWtTEWyHwkSN9oq"
    "v+V3c3I55Ny1PKIrfr9loFOTaj0OF9Yu7gjZ/bo8URnB2nf1UyI3cZ957f15MZqRKNNpPMUP"
    "e3QF9auGauAQa4z5SuJkKesgzFvvCXaahLf9zh2ONT2xzwe6nBILUfiwnKlMh9jPVJ902V/o"
    "1yAn1EF3SV3BJ1Jojv+PgvP+h8Lx43iSVEJSybyk0rL3PKVSWUnZW/be25FQ4Y6EzCM7e+87"
    "sveKwzlnHw6Hw7n9/Xz/hPfj8Xq8nq/nL2/U4K2tmKZy+gIKArQaI/1up8aV282H8J0Q5ywU"
    "0BvKDH72+CxelkAf9WgXhcJjMom0mJT5syE/AUHT3VvkpiWccpNA/ca7GBMA2MNb2JHTPkGH"
    "FQyq2t/PeijlJS1PaI3614WIjWuDrgqpxAEub4rBlr68US72P5tZ02pxDOlnryjyf1xc2rv7"
    "EfVWrA/Xf+sga7PSer0RfcVIq7x8d0lXdnxf5SNUQw5fFf67MRKM4Bs0S2GxqgP54TXwiHzw"
    "HvxLPsi5LRKlZr7kyPoQu5kPn/WqZgDq7MtaTmV55tXhnBKjPfps863Ik2uEdlu31WgQnXFx"
    "/vLck3K46arUfgpupeTwB0hBfV8gC7/ZNgK0iuV3BnG89JAVn1EIoA9LoUqPNA0rsoeS7zp0"
    "vLtNqhmhNy9y8vMJGXIRWVqkysKIDMbNZeEiFURzxX/tRbtHhkzM8RNQDRVu/AdOZSWP5kCX"
    "hCa+vq6t8n8RYc2bv/19wdyHCrhdWMzAEgfs97wZunTFJ7kPvLnL83MdwNDlgXdMnbvZH2Qb"
    "Liit26Jbb7yf+XmzpL7hhOK/jImRGHu5ivaW9357lnRsNADRCDYR8CLKfT3Ug2WRBo+SdNWf"
    "vnUVMW97gsxcBCkkk1oyPXUlhMgqnKvBB9oT83duCVkITnltJv6IS9V9IXbDir3Hzyn4IbxN"
    "5X3WB33+kWViWI8ujdjOoeRZZTLomo1SS7shz1VFTmx2OqmwPBzmFcIlXTHPeu316VBjjSqJ"
    "LeZIi3K8mRMijgdz1rO5wOnU9vFHB1R2eB/07G8aj8VvyjWuTELBBDgQMuQFF9tsQqhapnsu"
    "I2syLzMfYzWE7lCUlYSZxhQX2Dke+Oc8hgab7azOXY9BbzDlkR2Lf+qtNbyq70su0fAl3QaY"
    "aFy7wmapnnfwKEq+MQnzoSfINxxfG9gemSmWB73EfbOArlOziI/zIZHAHCc9YV4B0sItodN2"
    "s02Un5qG7RDKrXSa7X/MP4jX4Q6EmCTH+LNz5cJqQPYtTZivGAUAr2w4p0Wdn/OXCJWxMLl3"
    "QTPrNjKfNn2sSappIMlEAKM3v6iyikP8yehntHwXvflqnsDdnPCFLTgMZ36aUifAHWdc63J+"
    "3FSxNsEoNDeuwfaNpYiHkulGJ32aqjYjR5JUzZVb0eUoHlLG365hCq0nti2qBgZsyrOBVfwf"
    "ednLFfHyYIivwpks0I8QO3yDmSbg+GrheqGPWK4lCNXQfVlzZLzX5mVMha9euZ7FbKYRKKeR"
    "eaLlvLBuj8onJzhgtxCZmXlzv3vsAlDFJfC+rG/YIyEBHZ5fny1R54iulYzNdmZcIqIJ7GH0"
    "kXyNNpP5wN1jldDajh2mWEt0ahtnnm2F/enJYyVT9HUgpbFa//q23HYFKvuWRBANdgS3yb49"
    "afvPYc5tr6xwEhD2mDAWw7ZxX3hOzQarDDUfW/e6eBxPk1hhc+9jaLpMFPT9F6k5FjAQfNda"
    "9e6ac1MzbsJQmMW8MdttC6T8LTYUWdJmrs6+grAZTfR28NJ0eEPR8lV0smBxGSSoIXUiCoU+"
    "hTL92jQ4kcU4A6/rEr7OhEWpRKluX8Zcv7OMIq/rY7qjv/oyA0HNt/pjmFzP4bp8rzwMpzGH"
    "GSqGX1aRzblFq/7oHseS7Biyv8L+scb7lelW70ML291bzNvytfyFcbWaAo0pBrvvKkdDG2bq"
    "Pm+sChXqEmiysmyhnPG8UmfA6hb4u2O/wAZuOVf5zYt/7nvi954co5Fdglq8pnu1kq62UnEK"
    "TjlnmYE7tEL3GvgH3FFTIQ86cP/FvyGfhY5u6pznJ/pjWh0E33cYSoni9j5ieNrYngSwee5i"
    "JOAWUBtLNOUwlStqwyhPFNQKOhjOIfsIhJ0VQjKl9hnxde2/n2KsAU5elg7RP1yOJJ9ars89"
    "bzq1LVJAf2X7mIBE5NiGbrlpBtuFpU9Edn5lggUUcDVsf8cEy8UNw25CP9J0aqH3xmOc6+Z1"
    "OixW1YMTjmhf6WfLWKpPeiR0OoJxj356kW682hYuv6i+xUpvOXvFFuJGPPunikzw2bw13VS9"
    "nVbmZy8b1QpXrFUwGg0g1ab1ieQzyN2+NCuybxP2OMwHGvpKyhckTls9pJ0EX6NfpAwsogPO"
    "z6W5y3htX6d8EPx8+CDm5ukNQx14TLvn7jvVQk9nl5zeCmubgHN2HWLS8PWL+2i9yZpi7RTN"
    "r8fL92kutnEDKb+m7LEjafn9bL+iVolADoT38tKw5CW2VOAiq5Va1ttb/NM+zxRwkfaAgLFn"
    "TznzG0GXMBqsNYBXmrsyUsU/lO6I1gA7xc5Wp7Z9bLefyK+rO3s7Fa3FUqdKL9457Il7sKrw"
    "xXzDjyUwfzkMa1n7FSOaRSJZ0Y21hd7RqjXG406uNznf72aqNcvNZj7h5AtjeD7s8zZEZKEc"
    "/TKCYQAg5tfYbEjRhXO5OvD3Eho6JM4Jx9nLOb5bhyV5uPplhvYEnRuwjGwiNNKClI77RwYk"
    "D5oRAfOlycwkjPqaPze8Kmh5fsX7a0ss2SfQ9IKtyeHLdSnhpiqm1udPNU3e+GrxKwZEwzY9"
    "dVhGz19HsyC8VlJ9kPwirjjiu2Cc1/5hNZvi3fnUE3ICWfGnHB+uDIP3uYOh+5zat3ECDXfC"
    "FbZu+BodMb+B+qzs9wQlMh66T8ReRbh5Hiu5DC3o4bIxecmQC2L2uHMrASdJAkTsUOANSsdq"
    "xSczxXeAoNDTub7ggcqdsoNPP9eFljkPRUgQR42OaliObjmmRXIHxj4bEeqy1IGqfDqiyoNy"
    "FdUNlaUbn35fhz42sqJJOoRJHDpm0F43mwNE80+6dP9dXgr/HOBTfNMNWvZk3WHRnCuZYOXn"
    "+nsNEkI+75VbfUQ5OskMiCnSVKfM+t0wYPtbdPQTwuAahjFYG1Lv7gLcdJZU9WDsjKt1+v6U"
    "AnhHTijRyBlY1s3V/mKQZfIch5ywQvN9zhpvsN6wukaRqHca3i7xHzXlixzChW8DoSfSwdTu"
    "rYbzRP65qwwrBMvlzPNcZZNgxne0qEYHLugJrpwT56jxIEe7clo3CudZ+cADU8rJcfFnnNDv"
    "HPb2tAXCSJbOVBu4o2kb5keztb+tAHpNz8ZHvmRem2/L3gjMvb/xqim0nz3NfYwsJ4z+q7G3"
    "Zw0HImpone9CJb4y5nF9xWyray14FKPhc3YGn0gBlMVwpCQKo69xuhbmO+ueCI1UrZ2y/qXk"
    "1G2tCUDJQ/0CUvqAVlIhFECsVdFJBV3lTp1uBye8LyiMbtN+xohW4VnLxk/LQTnbaxryX0Lo"
    "pvZinbmj3GnALeDfidnzEBiQEr5eUJxyKDcxoo69lFwsL5aelYuWXMoJp5Avg6YV8jxaKMaL"
    "F1tVQ4tH5ByeoN+84uJCw9xULynNsawItV3wpdzGKW6ZLkM/uWApz0JGj1JnYD6DdjcXCwum"
    "VcY5fSFbzMsYVK2SQ+yTIv3jo1uVf2AxKzq7uiM1fjY3xWgF5t0y4y63z5vbBviyYc5Ejg7a"
    "16TdVyHHOWMH1Tr96KndAM/+uwu8Seaa/LMPHjO2CCxkd4QWp8XEZu0ZD6FJxjmOI0MLHgyN"
    "AOVT/rnVtz6N3FcRXfWYP9u/erpMQpFZ4Db5vdjHsRdShMKeB67p/B6RWa4KSINlK52wBK/O"
    "r5mLLO8fNhINkT1Gmx4HFY0KpqiotUoNHGtBqrDFHXe0xTUvr6H54L15dJuNEiPYyKKBJok1"
    "cf2bMoxAkuYvj5Rbyo0p4dQaGmnicvLIPWyPm3hWjQf4sD6o9WhD9VSq8tZJHlIwOADvDVes"
    "AUpsmidHs8e7XmyB9NwlFqYTxEaJvTUO6YGtUOKHmCNvhSMLUInBv+cG6qNiyS5o7Eu8lsq0"
    "21UoT9rSrlL1KXuSV8X3FQ5LkCMUR6MR26D9ou2lmWAP6fs97VlU+TtiarJW+cN6XqywV5lF"
    "h25DPWReiPefqsUwj6PoijDOypQ1oXSxxJOj97iKlubSwxeAGZETrmeGT9jrs/9RhY56zvwf"
    "7XvGbvsB+lVEY692+Iwxhgf2NDHUKdPfu12H7nbN/UleixHp0ls7CPFzKjrzOS27KWao8oc4"
    "uWylYHZLowuUmLzDRn/hU5cg8GAlMBrhomGzRFYtAYjT04GYmj1DiL+JCZXVXuiIcUiF8m1H"
    "PAGqMu2+jXs0gQcEd90elMr3nLnmU0A+8aqBgPeSFmR9zCycLJvxebIc3RgtHUXMskF0TZXg"
    "WdUlZMS4NHCmylvXL69jnk7iJddaFmF+Ihazv+aLe7Eb1we9h2q1qYc5lpjcsUezRQU/lBIW"
    "wIqC4Hx/6Jz7UeHvH5w8tCedM3N+Ncpzb6yaocp+Xh+V1Mze17SvXHAxAFshl1wLSYJvyGdq"
    "TvE0/bDXN+OR07+aYD8xTBtYGb7/ApWruYyZXhZv7cI+NR7MzGNx7/GNp0qPiz+u7B0eov/O"
    "93B/fmifu/JwDDvJxC2ddpwePq/i2U74RfXExOYr3+VkXhDxBXl4BKqi/GryFNyAQqqqaywH"
    "nBRPHRwfv6vnJmEqEvlLirC9TymN5A+ciD1k8Ir6V7rtpEwUNB1/vCJMyiZHbN4R6LPeBvK+"
    "urr9YVys3pJWROfe2FGOa4KRM/uIeqqc1Diz1rj0sCEXuul4gTLi8pbdfIzkHfrBr3CUus5r"
    "WzohouBpxr7NiXpRwk9eBz8HcynKj05R2uu2N4RzMf6gGFzjGEowPBq0O5tPsnwxptz9i/qe"
    "70DnjfC3+ue2AuaQohOFoiFmsWnoXMh5SzaH5IMdkO7ZoPdC2NZY3j7l/CHtC//EdKWXARaj"
    "I8r+2f8Z81Aq4YBdbAhwlLmLy0oZjVpyC4AZ3n4upMR20PQCmjPXcmvmtP1tBUXL5+aS0brq"
    "9pKWWNZxTi8JqHCBekh7FeAQZWHusTnvb2spaK1jP84ynRhAiU28J4RuFX+KF89kAeEUmv+C"
    "88ykx69HsJ0/OLi6O/+keqOZw51a9F3MhXPAJTwGbIg0Hvf70J2WHfrwn9bqpk3UqLXeAOjq"
    "hxFcCiuFDGfZXv7101h+G7A6gLypK/DnHlfX8dp80fZRaEtrMMgPwzrtHBsFLUMWjQ+b57j0"
    "7yoYfUK/c9ENqZy7t5J6Oj5ZuVUWJWav2pYLfYeezPuvjicNvJ+DpA181UIwnTqH3v79oqYP"
    "6YsP7WkCt7C/ccMe9AbDPU5xukt4qll+mVHdTlyrQ5gS9SYp+uSqCuU/FwbvTHc4LOLTdq50"
    "flu8ebrDfA/91nMtOjR1soMlDGQQEplfOnmo6uK6CUoM+rF1VXQ8gWzbDjr7RXlj3AbK71jU"
    "uYONrjDzK7JbakInS9mq3mlw36swPBA51rDog2hFe5NLjJsjYmVDuEkxswGd4YhnbS2GGIv4"
    "pH5VcmUKDjl8dn/hVifvFrFWyuJqjEOx2H/6ngFiWgrNACV5nOciMC8odDoo3FdC38Cn2nXs"
    "+SpuWMUNn8k09pdp4vqZNt8g5M5iNSTE2AZydg+Su9ocNnjmrC1WiaIDEubSUFjw/I9DqORB"
    "ZTMXBYL4QlTC9PHcZXxukTRWWu2Y8tLBqLE0X9h7n6w0gSmlHXDgFOyUE05Bdts6U5sVcire"
    "1OG9mv4Vjwb48+OsmrsTTRXhLTSACV0JcHdxt/VwpcUD3SoxssBfuLgAcHTYb+/tsWRLhZKW"
    "p2fibps+HznuWZHEjBBdYdc2fszeG0xQ66yyirkwbq09wrRH9U7ZCKb14E9vuFSqpAKfjqzl"
    "txHfnN5do+S/d6dEm38z/63EkmVQ9GzlT2ZksovdWYjc2GKaezg8undV0sji+mYD6jSP1IKl"
    "qEmdmQ7hX0txZMZlILex0ftBY3btpXUSjYZf/6U0B7ozzyxnN53HkOZVgPvjczWiGckB1W53"
    "EFiByCZBSkIdAE9fJHSopbe1INTM9sAc6fJKbbDPSp8GJ2/4B1nyXrIoCJ64qBJ60HrcH+AC"
    "jaM4qDRe2nPM+QBOauvhBWy0rwls/fAoiiVBEql8f/3q3niYw9GxKNwtbeAVlYu6vclh2qGJ"
    "j3IU5sE+LCRTTV3JqoZI+IEI7CmlurE1nP8bYdUK0TfrjYf1p9cFLHHbx5+L1nY6e5EhZsin"
    "KBC4HVQZZUfvZc0NFFvfAQBmZrfWs/Uk+h9sXiAb+2reUzKEsbZO+u0qf1AVr8xNsN69OirH"
    "YgBnAb0XaxH3f+5QnJkksKFyznkRSDwVYz5CR0oB0ayHnAciiOEJS8+j71mfVVbTrnkJQ2nG"
    "I5Qxz2TyNptEL4Rb56LfJccLY0g+w9CLy7wH+3rI97jfJyu5VR8kf2dXNILQelD6SvezoyKi"
    "tT5nO+d2USjlF/j8eJt/3TPcCdYLPWG5KvAPVXnSP9z1sa1IUErejbuxYq1HyBnFL8cZqmS7"
    "Qm6xAermHG22wdgR/VJo05ypzxCIf1lvipnCDftrRUmEQu5VfuIzYXptKDvhEqk0yuE2rloH"
    "aVZHBmzedGe6VaHXePp94lri2F+RZezwyp5hu1y89CxmtU/3i7g3ofLjL1T4tEf7swezd/lU"
    "CP4NXPkee0PeSy0b36ucBe40EwXqNXQmK4Wgz0KHrCZrUJq+9lWZv/auPdWvRT+phYw3Xi76"
    "rqTljNre69GbJnVbwB9E7FtmiQfLhXiONPW2hZ5LRSkFSfY4MuaqWhvHW69JvEP/UFnnPH6T"
    "IECqilQ0zD2tkIsSvuStHAjgg20OLq2h9FW4JdoGRSjZFqpUp3ebfuvO4u2ZvHLk41FnQAc+"
    "W4tAVhOlkjvO3od5iwS/pjiIvtRk/4Mkc3bzeE3pJifis0OYsamzEd8WngHvFT+ndU5n773Y"
    "yrEIVKTOwpSkF84u4cum+fd9rZF7vih2JfP+7cmxl8uTzcg8QyVz0YAdcmhxhoti2tFSnq6S"
    "W8l37AXehWYm45MUvvaKfvaTdY6gDa0t/g23nccY4Seqhyx7ZD7Frb+Y6UWl4a111gGj7GWX"
    "gKCXYir67Lhw8w/FmPt7wRAYJIT9e1enanGHtnKfrCjvOKJHu4Ez1JP3zfBO7O64E9pL9ubS"
    "ycagWYrMI/iNtURAUPlwK2csrzOAqu5y5hPlsOU8LfSe9qBZIPytu7ssKrCnK+Wn+tSvbMxW"
    "b9b9DULolwbXyETggae6Giq/a6CxQPUYEaX6AMTJ+/Jkms4xx4izALVjiMmhuqU7a4S0eZlj"
    "0PYUZaAjAZworMTcMBCV9iaLtI8+p0XsNfyONLyaS+Y6XejbBLuXNGGiHDPoyVcWB3ZxnFK+"
    "agzaTRV7daCkBt/me2G+EAfa3zONcHej7JeOwDyHDwo8HIsrJ3v05Hp6V6/5gHd/AOpb/cVF"
    "le1+A+rWP8hF6plHug5H9lnIr498rk5Zy4XraPFvBxrNXT9jn5LHjT4ffC5VsaRcct+hHb06"
    "NNyd4Sb00Odv1/cK7xOnGDpPGryK3bW1yyxkXeedtx4fwEAELd4dLL9Cw8f+R6OKsiAkWGs+"
    "5LikKuQGzLV9LSlWwK0qz7IvlnVX7qys4XK616JUe/ZspeX7XVGXGztXZILBV1SGE35mQ8uk"
    "Yb640SduEo66FMjhbumdtLAwkYUEQbLZ8RuNEKunOIQqLyNu9K+5/8wj+5w23kXyrI/biOrC"
    "YUeZ9lJK+jqxBmr7WIppkbbtnPPl8nmzxc9z3/1LZKmimVJPKtdbPN9Lz/SHgDQBlpf6eXD1"
    "9VWw9LDFRkCRhet2LMH/twxawsHN/N/oy/1YjxPNmeSYuB2VddkQrUXnVlivl77oZ+y9HHcB"
    "HCb4E3zI0q9u2Uvbs8rons9X39rDEBE06NYPanjgyQ36axqgK20dwXF8/zEc+pbs1JLnko4c"
    "PQ+bj1/jG4zdO92KkaBC8nwE1DXeJdwtKkai3dE92y2NhPgoYzTyFwo3Sf3ZV2OBe7QQ8lK2"
    "cjRzX8T4Urji2i4wOiMbiTl5Kd2Y3SozKwRKtLgTae8VT9ZcS9w3gBzloLsifbrRwc0hR05s"
    "VgKyhEH6I17jBUydHCP06pH3wpoyWQa1fclCL7ohoHeG/foTKwTEmKVatDNfqDbuwu6l0zWz"
    "rzvV7SXFBsUmowFomdLic1ATkNObQHJxcHPoHtIn+MIX6CwLsepi99w8iL6Zsx6GI4A0RGe3"
    "9puo/7qIPl/Rhk3vapMCSzxy47j46ujIip7seK5N+u6Y5qici/9WdgrL/lvNVTWvde7ijo4n"
    "e8TQYfxRZkv/U/FwEWY+iTndxt+qvcPUy38ahT5UraNnHgPXKfeexhfys8uyOufep6c49TUh"
    "1WBXlbn5fkmhGqJzwcYuX8ptN1cADuUecf8sxfxM1mXp76cNnncUuJWOeydvjT+QKe7Yj++I"
    "20Csdne6ZaUA9ILOGpb7yQG/K3xzqOeh6KMTu/1AcEeFCx7G/jCK2lQF7e08HLdFvRxnPD4x"
    "XQyd12VyZF4qrLtZxOojMoGqeJMfKbo1xz7/LFff/zwVMIo74fVhagafG9sMbYHOV2+DuGlM"
    "6qBwyU7cqv17Wo/5CrfhJ2E1pVMx4cpExOw9vvIV5qKqQljZSLjrpCek5a7rvL62ekNMXfTC"
    "vqqPKVRca1HXiZcYSBMJaE8TNSwqW6lYR8kLbGbm3Qz4PfJDHgilAHNhLBPUsAvNlIh15dMS"
    "lRwZZmF8l/Rfjb8E1l94uHz7I9ur5GNlJpx/eF4b6I3UyjFK19/3+AGFl9/hbkBQ5juPixsa"
    "NIOgpNh7HLT1VGNrlezwJvpB13ItHOrqGejhInwNA16YL0IyWAdXVa1stifhiQ7TKLEF7+/D"
    "tJBcYNk0zKnI8DY9RuNY631IVl7r3Ua7q5eajYzNG0XX2Z7Ksr5HfiFOe4Uu5HtNlPWwf7hZ"
    "lIoIb7tQS5TMmbA5mpCbq1IzvPhLpffB8tgYck+BySzwYLCWRL/oOaQ6GVaDln4nLwCzMzV6"
    "jTmXpvyTcl7+tc4/4QsBO2q1agGfm47fe7o/U4tbz/SNo11zWQLX+Is+G911ogCybLiiWJB6"
    "bKoMFua6OHK/eoPeoO9d7AOqQgDMxEPED0TpOOXJwjc3WJ/OnNFHSuzDAMBnwFusITYfwsvF"
    "LdpuZrgNh4ZsI3HrdlVP1JWQKQIuc+hlC+d5MBERvJujXHnVzuohpvVjr/RGaYfOugqyHNsh"
    "kpk/MP44vFKpjCRzRicp4qdx5EAgCz7G+1H4Gux88W9hiJt9BfbwhtP0JHM4ySN4VMTF98ki"
    "rPRNTuiaaar/J+K+ao2IZRXmlnY7t20VoezlaLdHuA6CpKGkyxSkyPOM8XUVR3BbpFsB1zNW"
    "+LvG47yxopGI6kP06g2GPb1faPqOaPQ2/JLDQOVpLHVvVzvhNcCo/Tl9vM5JWzyFI+epQ50q"
    "+ZABdORFowGJZ+hU/vgiXfYeod1RudxhlxGfQd5y1Wl5xuSWD4EYAI59x+CdAN4ia20ZmEYo"
    "YSbEZ7FPPz+Kls/Imq2pl4lTbyx0PHRgsf0U6so7hW1tAFge2qbGsZ72x+NSziSYZakY6VvL"
    "p5RHoWKFaRe5BViXlu5UPTBdM/RZ4/aOskT1rv2dQIRsPAAPn57YKlCqR4FDF+Hgjb1Ho1m3"
    "lcXlLMqN6Nwz8+9iw4hBDgfxR2mUs5C79KJdh/bXJEl2gv6nj9C77KAjePeLEO5fSdSopm5A"
    "YKrk9uf4wXcGuSITc5cxSYUaai5OSsMcf2L96Jq/25W/j53PCUjItaSSg/0ckMHr2vPlCRn7"
    "B6STTyKnEocyZewzXJvOVza7A2+4tLOkEGt8Tb+28UNCuU5MlTbl7Xe+MlQ1iwg0IBe0dSVf"
    "vw1Wi91jDhP0gHI1uXQ6/LvZJ33tWGHG559VtCIEuQfbd5tBJFcPOUwqCGYzERix4w/5DUc6"
    "Iqs2+YN2Aj7hIMicwWKs5MA+OF5jw/KA3nO6gVkRgUuRmqJB32ZVhycL672SrWr3b2udqO5h"
    "CKfRoYSofwtnId0qoOXdODT24XdKmeMmsyehws1tPBc+byMvdeoA8WKJu9jWxKc5br/K8e+t"
    "ijUOfAnCjctlWrXsD24R/+Q9Xwy3UG/ALunmnJvDs3h8dTBj9Q3Oephhfd8AsvPwSHBLsc0w"
    "WCPNVBsS5RQU29XmfBsv0XoKwYDt5vvALbFDau4BX/W8pwKUP/uxT8xMe2tpbHpuTms4Zpx3"
    "IXBHO7Tcx4j3sN1L/6y7+D0RO37vGdbgYJpuyd8lLJqz76ctNlQVtlCwhpDZ75NZ3+VvNmz6"
    "cXjtysE7763TmH1qW1vY9kSdOJ+x5ULoKfygSJmjLGfLMuMVuXEYfpya0uBG7K11QUXp7700"
    "f99e2a+PUx34vXXPtYiZgwD/0D7/y5bksvn3a2E/umuU/P3fYx7cFdwBu6f09bO27VvHQc8U"
    "jfFXwsss8xuHV/M2H7Lo738cCWEUS3zYdtOiBvqBpLZq8Q0oLJz56PShDD7+cstJl0Dzwclh"
    "wWlt/5JV75uh74b2FVfzQE+J1qhMttS/ZUeLsi0MPs5ZajYVjEU3Gol2Jm6vP5Tlt9Hk8EIp"
    "qvZ6RRfNNnzAokfcNwmTlNujCEdw3fDj1oWbj3ftpHFOwHyvc85cNaFZMXCP/rUCuR9Cz83Y"
    "NNAUpX0psgOyeJRs98hhQnqPjGVROR0m96vVSTTfpWcwSesyOMwusnTtE2zQuFlk0HTP4ww6"
    "wKr65hYrQmqyWd//rUGU7Txa0AOh6xa75iMRzBKGWuYOba3ZTJqWWO57UtRv2i8QI2GrhcJx"
    "FTDLcSw9aSvBtF7lOn2Nqd4ftuCp/JAN9PEtrHU4JKWyIZoGaee8T+Qq+B1OKvpL0BvpO++a"
    "OYVnuXA/dNbusEt1TFCnlajDPlPa5AIeWUDOIrfwBwupM3ukha7PGL+MGTCAdaeYme5AHfsK"
    "pHPrB0T2dOb2gsQj0FdOO8O5zc8Go5U6F7UtNiFHBl5HJ2UNlZjUVuMjh5YMtt9hrGGSBJVF"
    "zaEjGw5hTX8f7c9nKy2ISuCa99IGRNO/Z53HSsIdEqfH9mnY4VVW9v3+r9e3GQ74j8LugCM/"
    "Q26717sCqu1iPaNAUzxZ36goGDdFQSk+g9XiY9TMStNe855yZshjFpwLRRr35+8r4j4LLoiq"
    "QO6o7Wt8Ub5AUdUYuThteyAzIEOLNeS5Ne8wAA0Rz0YtS8dXyPK90x7+8sCUC9Wxjif8XiM1"
    "1oQIA1A5odWEqIdoGVF5MfNEW+BrSrevviFFdtQqHZrZizySzv5AFxFGl7s8k9s7cKpXFh0p"
    "bc1z2Qtn+eOETjeq0L3q9Rcf0uzabwjVk6W5DodqunY8xE/3Abh3LcCsHiNvgazp6qluOVV2"
    "oj4EG/WV/tzbwabjKpKvuGXD13UlnP0PjHHIxgfEgZmXMAFlzlXT+GYN0Pf6GQM+UgLW9nhh"
    "bOMP6rdKP6xEN9T7bD/wvYbfRThqALXB3uXw1/KciWQIOVRX4uAvkqVcB8Izogc53C9TGWuD"
    "TJUiEaWkF6gJeHabi4v4c8BjReQFcXZcz01ki/ZTQeEcSOEGreiwchYCERYfLvWELd/iZhxH"
    "/XGRWhdE38dFjIsJ79KIIp1eg3O1KgUZQBIafzZW3/oO7ip2vykE9YtQp5o7vgeW0pvasM6G"
    "A2jCBvOyvKUfd/uBon5RcrrfeuEoVbHtRNpfgaFL96IbDygRPJy8AOfz6Tl800UT1qOiN9pY"
    "ZDydoobH/1hLxFLN5WYd0yzqEkO4fBp7O5coU+6W5eR+DySfZQTrCnU4nwCkeASMdcBnur+p"
    "FyPYS9fE/TSn+ItWNw0rVHaDwg+t6aHlykEkiXcBfcS+w8LhPNB8D1M3S7S+Odylk/L5Ud/v"
    "sIMawJh4NbN2aRbdwfMmO35lm6l1uiP32JZ57JAVJtk6y8jeiAsFOYAzHIgrHKMiDH91oQlx"
    "CiMyUwHp/sdojjqzp++hFwTUlkK6Pi3MuIbF88tatZ0wtno7B0ftMz51985w1NnweI9cadgo"
    "mkISHjvnTMm9+rd0HLXX3sQeI4hVmsvsNNTbWPkqYM886hiu79TFuti5T2CFYgkkVuPvtq2X"
    "39M4aefnzqKKSYwuKK2msB3r2bt46ZxPg3kbf0duAAGwbtOULJBPoI/xwi1syYtXtdhjxwnx"
    "h6F3YLWT6Y1Ga/xrLNqNCetkDRjktsCLVW5/xKSrT+1hU4sxZx28TsS/cY6DdVsHLXy6e4O6"
    "gH0ybX90N6gx6oirHTErWWdJ8haM2Wdv33ebF8roXK2qQFicDPZrcK7RjN6D0sgvdrCnfYHk"
    "mCfaIdsdM9b1bWdP7eMScQeiGdbJ3RNhu+1FIr1+YuPqWeYFiaqHVNLbQg9ZaRyFBHwtG2+E"
    "ew+1hifP59MPbvPB30jdrVIFntSsYGg+ewCz79bQzzhtp3ADlS8a07GeGPCzg8rQ6FvQIf20"
    "myHI7aiYo73WtmZ0d8ADnJsOZgx5sdMy7GPdjrQ0gTNGIs8jX3icwQxmxyzTAuupe8PZwq/U"
    "73H4+HREsdtT3r09s7lQxjfssYfir8OC6jx593qWeI7leCTDHfZx2NGxXwvdqd58MnBo75ME"
    "VFTrBjj9yhxx/Lek16uAFaHAp3yBbw4eyHmgx1WvxvJQJFXiBIJ6pn12rBer0Ib7YiGMNtRH"
    "Lx72A48oHak+PB1NHZ17TqbmqJSYSc8aFLPHdoHPO7c4tuEQAeYp7/glWTBwwHfEPM9t3oHo"
    "5YQGUzUna4DVrqL0b//g7c/yAlJGWR3NbiSSG/uTbAq45rkhPndMMWu2GOD1C7qpBUBOESXd"
    "f5wqKdxXVS/d9Y8cAd4HqbUFYCZ31sN3fA3lHzvgA3a77H7vXRGbMrSISSCulC8OK1f3C6wr"
    "FfLWWNdebXP4i6H+Bro/8um1fSPbs1uAG61oLjKLPcJEsjxxU7pMGC15WreyrpPJHzxfk7nL"
    "svBy3f9IX3LXRYAx5PuL753kL2HtMKGUpfPCgvGrr6xpfpAW+DPEz2q2bi4ny/yRUsf4N1WL"
    "e1vP2O35kFGYHx6U+H1yNpyePRIXKbnd6Sbf7MB7ty5RgpODfiUnRKs39mwOanqk2d62yoUB"
    "LdsNUCF/Bb59gh9aTsZlv/91w5BATOqxuQuFpst9UrizeLFG2uTRMkF6I91/G9i+nx7ATFVY"
    "TIk9Jco9u2e55hl27gW6M+3V7PXYO2yvtpg6TFudQAlho09an6ZaIhu8JPiEZ+1ykD9CMyme"
    "bPZz23cXroQvg6POztOqmRJXk4jEWw9HGJrrGy4Gn748Ta+gXGHxwwBuqmY83rlO3XYBMyDK"
    "j5nC30I/xZ2IYBGjYlvsVKZ5k4O3mqJeTWzGynfJnNQX4AqpiyZaHP/OB77EjwIqxMY4ZlwA"
    "tSpYWhCZMkUbtvEQDVcBwvB5YpzBIO7C6cvFQT4IkDGfHGR4fd+1d63DSGzKQw8OFsp8VYrs"
    "LbN28xbayVL9ncohRpk985sNUE1PPbc/h7zMWHuQlK1w4eXRNQrnGv9KjJSa8IDQYpnKVR8G"
    "8lXb71iZShjjbU+A3ZHIztqXQCGxpmu7H7g7M7FPDz9XqeeIPboIlBPDoehWrVe/pWsMjK6W"
    "TLIMCy2jw6I1mFu6Or5zxRABIFWU173wLucDEk/NGeotcyU8Nocrejos+OXVvhbNZaMsu3Ma"
    "YQTR+nYuWI9fO8EwP+Qcsb5/axp51oEXfkMwl8ybBb2iuRtVLzzMugm6wKLsOz1yO9QHiHuo"
    "/UDMw7XLHofc6vTyDcB8DLFLpW98JzDyXsHsWcRu0H4kjAUwDxYbuaoFeOwvHouHc6sa80fd"
    "x8J3dZPJDQrtn46Vy0Vcw8aJzeNbcwss15pHbmgSclSR/4br56OC4VvdZuHmtMi5lnL5j3F5"
    "FOckjfpx6jkzzeK9poOOyNEJna3fcNkrjmcU6gjr2iAq5P7ZL4gDZYki17hnEV20IAKS5qFT"
    "G8giI9WLvlv4GypXGz3H4sxOGHMku6MCl/U+AIZVfqHAqnYAWiFvnOyntoIvSjWpQ9pGafq1"
    "JGCKcdI4cJuOttCcVndyaDqwt2QGNrTbbjK2jfcZdyRX0NkH0FagLrDTqYJ5uIsH/bxtKKEY"
    "PWazcXNp9tsrQl5+R1cWk+lOFkiUvmDjQjsjhdUZZ455SIEmd6q0Q/wAM1dgupgK5uCJTDVj"
    "JUViB3Wc6+ASSQwI+7PKc7ARi/AE+yyNbo1RlVFyZ6xAv34AcFOARAyJhBwmCSaj/McTJ2cG"
    "2x907kdmnaUJqLPvVePPja0p5cgPRFNtOu4UqFRwGTmNkYqUzxtW812U8+ZPZ8nZpliZCIKu"
    "2enL/WJfPirY5xVwx9kvgRsjMMSRBjJt5QQV1hPqr5RrPoPaGpjE71HjI9uUuMXieGVRCzih"
    "7Njpux2fx1XbajlXh7BI+8n93GLmse+EAw/llh+m5PfzrxJdq+fO67v/etSztCY3GkXYu7j/"
    "ERbm29J6R5pwnvYdNmwFcArSvThEf4Fa8Pa9dcXd1iHq8TbS7qQXUsMhJHXZUfSQz8Qa8NMp"
    "7fbunAE9jc7vs/+HU0GO7eBZWIxD/1fRa+2hETZP8Hq7W/0CQz2M07RiTMeQpWtS4jkvqe6B"
    "Q9azcY2DzUVrTOAt4EhsqAkiy+S6J+H8nOyQTVDmCHzSe8GRUk3nhf0ZTRufuf1zHdesr6YE"
    "lJh7H658BbSUCy00+NL6N/vXTf3YGMlWrUs0TyHNZhjt3Lqma4kVXFcVm8lYpg/vydnRxcpf"
    "WX1N+Jf9o/emVMil5kKF12Xir4yW8Ghm4FfQE+Fbpp+T7upYG9TE2oo9NiaAsSaVYX6KmqRx"
    "0FL8twXmVZfw5KNz6tQbY6ZZFwXyY+N64ICNxL4V/3EBjtRIVWzbjPy2XCh9eau3VK7WcMjG"
    "N9xDo9GUh7F2nvK7teh65DFD4u4b9WNNHjaFl6Cve+2xGyI1T8YOXMaRnY+mGHOMpZkH68hX"
    "ptD+JekVgJFVn4ixy4G27LegdN6y+RS0ejDlilWs7OBJLGXbG0TrPGmJ5dKyVdRZwE7ZqM0+"
    "P+aHJ7JuZzJrh5CuIfRAGhVYFt8Ki6bF7bYf4do0vm+ZYV0xSWQD2bFnU8wFoHQXqmWJ4g+W"
    "kHjiJwLCmND+ZjDc2Dm5KAeeyuayQPnTMisKUqx1Ajz7V0/seX0rjUaKmFlLY9IRD8oQg5am"
    "vKcrPDQf3devGVhWqdg+umQ2L3hmdH+xfzKP3cVuV/isNZY+eOBAPAQmulmwD9KA0oC5LAAe"
    "uJNwEuQT8eKXpQY+uHX8Z2UCVaYg6Ez9crdruoasVDtaQyQ5CpeQI0YtrF/yyrqn3NMqTBr7"
    "vBI6/x3uB3cR6if6iCn9F3m3H4shoek5hJrZdgNn/dmfzJX5vK0QVSD6m90cO4xYvl23tdwZ"
    "S50dph9WS4eU+/ydS6+zSd3pH0LvNWzxrBYemNF4ffJxLMP8KaEe4ceJOsd2m1+QVaC3BvJp"
    "CsmTxbLeShVPOP6bFetaxJvwt+WdwURyI9/91tuysw4Iwn93LcPQzFLvc3EsoevSJDdMQUeX"
    "j9uxpAhWSdA8LTzijxUv/Z1DUrcaYrmOe8XhmXRoPHxBT+3iIuMr2HfbHJYMxn7T4s4WrFEM"
    "JaG57ul7sOrpwlXnf41K0H86kJ2lhWuUqwKFhIbiOy1sQHS4OfWTx8CSydz8e+qp8mfMxebk"
    "TMEnxX8USi2Sz986vWP5TOzHoCR44uvVUdyn+H6B8BUeItJ09xmZSLjkoHtl5bIpAS6DcqOq"
    "ejCfQwOPOc8THH/pMrPUahqZgFU7oMF8SZxH3PQrRtLj+B3Y8dtn7N0dp4vUuN38GMHufqn9"
    "GSfVPTti2Dh8vHKbd6q9LWqFdIBIUglGVsGS5VYaibcWZi+ksG9cPHdSaOegEl9LnoI5xkYB"
    "M1vvzftEjDs0cAJfr+EksN6GVxmt2O0Ky2JfjAyZxtFrxj7wcoQ+UF+AVFAImnbvb1Qvcfq+"
    "OuB5WLEE+w/rKbo+foHtAfS9NEO09sQwwXAopHMTVD04vm+I47Hc611/84n9yx0dqkiERKrC"
    "nzQlt/ixYXL+3kNI7/OwmlkZx/c+CrafaPPFYA6dd0CASnYhj3GXquenBRtgrtx7b08vYc+b"
    "KhzO8H0FI11Es3MybhNTMjJhrOYUuOTqKl+O5xjncx9Zmi17kRG+N6pFYArycPH99bMplcqy"
    "3XDJfxXWKTIJ/OX4yCiV+9eakl74+7jwDUbK3pg+4ChQ2DBfNilQeNVt4swM/vucXCbdm8mh"
    "2MQgamthdhkVYMI37n5Ci/o2O5G1VSK8Ht4Q6dVyf3EUqpB/QtpeuZFDWDW44bFsd1JDPK47"
    "amblu+JBMLbkHGN2Lw3ZUBrIxfSSb4WAOWswykHN70J+FmvLPWAfqVprobKwU+xaVLFc10IA"
    "t5/I7Q9XCZnqi67v5dFEPtMuCyzU0Yo9ki0GoKiycAq8aUA+YulbZlZQcRSK0fs9Px4pVtjb"
    "7IcbkuENJxievc6+pfmKcvb49i32qwoRoFbWZMYxQZEFkdh15VBFlr88HRistLPxVqZK+dp0"
    "S9P6uflavuBwZ98rhziElyzi5wg8MuRL6xOY4JGz1tqTU4/FakZqLrUAAfSlSTUimPPOdnFv"
    "jP2kjRjkt7rS0aLjlI1Juwe0HWhggjT9+leBQ/MffaWB32SiMPeCeJoKwv6CKngjmWcZR0GW"
    "X7Lo3Y1yVhpnS4xeieCsQPbRDRYyHyTQ19FiYLNo34xtaZPKSNr+I8F8Mvwf9OVVxMoslrki"
    "b8dEkbwpQC/LjNaVNEeQ4K6WW+/rYsZBr2v98cVKJrjIIVDk7liX+O85DF7yVbb39nqUW4e5"
    "Jepq+Y//vEThotRIifyvvQtiq4JO1nxfAewgRXCKNSG0W+2ht9S4u6B0TNNhAEnl4ale9hi9"
    "k9FjkGlqCTQown36i9Gshj9NOECcVtEWEjKKo64qdPehWhwP5pM3g0wlf1xGtkiFnvk7PNtH"
    "H5GkxtvyrbCJYrTPwaxBgKwVTQBWcbf32f7NcdqjX1vcbcSZPLhdMwmEP/n4nL4imaLhn3XN"
    "DXGkZtPkfjgCumP5tT8ia/xIATpkdCf1sHjTALmuzdXBNHM5vtRDV/F3qxwnXlA9/rXmt7Ct"
    "m1OaHya1i+hJePLnFq8XEI/HGWxSGrJhhqZxeIvsUR0LrWHEn4Dy9ZJurcGz9SIVBrB258zi"
    "S3vearqba7ai3Lcy/qD/BupBFyYsfknzpQHFB9SheBp01JVaRRAiAjum5fQ0jov4WmbpMcor"
    "aV6jPkNlIEX/jCMeeNb8KKswDiabJp3+F7ph1tJOXFxCkVvuIq8qV9dwfnqqoJYCaJgNtuYw"
    "6avpCNY4FgjakQBJd9MbdNMeigXhm1rrGUv6n7uuR0lhOVIXijO22Lq9sQpbX823lQlYp/Ss"
    "kkaHdMLXgG7gSexeUNZh0EQLl/GxSXhxeBya6KHzF8xHzpiGHNf0TgXeAxmvMFzqm7gEEebu"
    "wxG8ROt8ht12Th+VdacruGla3tmSRQi6fw78M3o7ZqnmfvrZfjSK35atJxl3bXvv35dNzf8s"
    "h1Ts4g4sQIB32Yr1lrccugqSqt7DmxBvZtO4F+lzZ9FB6jfceKUvpe1+aZCQB/weTfND+rkG"
    "rZaxE0GoycO1BMeRO+yer1OlbP0feFl02Lpdba/cS1hc1ZiBZUityIbwlQVoDGh4qakOu6Yp"
    "F6cPHQQtfmTtNy1Ah8oj4nufEFCE9PJFD/rtTN2sBJ000jvUdMf00gprMPL6dzGLb93+eWSv"
    "qJ/BE7dP/E7/qYYAX9++z6ArMImd3uTo0IWL+wZ7uMuc84smXcIhJfS1g0H2oFyF01TcEi8s"
    "N7WEfy0r85OVpkXFYSXGhb6E0n8QGiadLhlSxealJPdDZ85CCFpckGCjr2I7eK5y14tfVNrC"
    "x2zR6+gm4W7Y2/xAs1H2Afa219cq8BPrqr9T5l2EL10aKFRbpLKvgDBxrLnsnz4xKoGybrxn"
    "UGVQYaD0jSzFBft/0ZPEJy8KED1cAE/1ViS8eh0/JPSZvs4z+qT02uZL7dTZX00aqMdt7Wjp"
    "99GzeXGxn6NWUm8gHyuwJytf351/pMcQnFORy+xdwpz02qbQJu9pfbnCxHMIgFN9fK2+35q1"
    "e7cSs//6g+2on0KwwUfu+ycCAxwaD9iZ8yX0PiZr3U1+fWGquK5Ct5GG+GGyh5to9XtoW3EV"
    "/3AnCEs37mK4cJXh3K2Ic+fEGcTP86nlGoVGXnjx+bvrB3Z3Ldluwq2w039W75S0JxhlYt+S"
    "mHewwXX+p1hC3WJDLFb0MX1p3EN2rlhin1Dj+4u25lbl9jNRMHpBFXzvJSFnUeQNhDvl3l/O"
    "oQuvmJguZ4kLAEtVsHUo039xGg9L3iXeYfgYofyQc3CC5QaLeqiaxSMgsS5IpUWl7HQNvj3z"
    "+tq9Z9wyJ/e+yejCMmKAQDBp/9kjpVV+CVyaYoCP2Oqgl7/Lw5YGKcuhzXcu5gYbbsibG4Gs"
    "/VHCTiYDKzRXbAI0xWSNy1gR3GZE55DTQPGfCNFQtN2MuGChnNHrUwN7evX46bAWod3UBOcD"
    "l9OgDOmP4PV5V+roTGPDabNzqsxoNrnpTKFdYnbfMPnntbf+9NqvyNaTObK9YXCWnVt++D8D"
    "2zsvJKoQG9VWeanR4dJvnY9anG0XMQ66tPyvmbGTjwE+xg3aYue/yQdmY4KyZLV1nT12aXX3"
    "7eJIkOBXi8ltU4T52RN0jQtHiDRO9FvS0fdqHXe+KtiXWeRa96MnYbi5+Io4ieHkAcbreV8i"
    "T6ssu9VGnd6FZKjow6eWzBOcxp7CS9Cn4jZvXnR1rQh2dfcKMlx40fP5p5a/4KlZOwfu3vVI"
    "z/vao85pfsaG+atAwVk9U/G2yfyckE3lKbxy4rT4++cBe9wawe8yeZrszmgplNu663FJDdZf"
    "3DqCTn2qwpoATeZY3sOKB2vJe+zHyjfuicixqoNbp654tfgWWNf02I12g3dEegKvbcyVPLhY"
    "ICEykxX7w+CPQYpbkJA+z4klWZYP/NWV+Y2T5v1n4LZ7G8z8qGFqDpeFJNb5TrFEhVP5cBCP"
    "i0C/rRbS8/XeIXZjENiteZn3lTKvD6kDl3AGf9g98PFt41JyNmrwY8vioWZmXIVLMvq6pFzt"
    "5BURuduJOy2tu9COXZM12pK5jM7EtDTEOmVUYcfcHjyH6vBaWBNPrn/PmWl8fOLkU7cAULrL"
    "ynzh6EXl0rS0xr3nd4qScuhPzV30xMrjy/7NyEo8rjemVPj0jDq7Noy7Y6tqkBX4MXDqicXb"
    "Mkn38B7IyYCiBgOWgpXPaHussRH49OlTM757/6U2vyuBuQPYV5J7rgzxy3WxYSQoZEJEcxN1"
    "64QWZBF1qJx4D13bMBqMQ05n9XlxDePTP3J3i7O8mX1ZKqTijEyTkGEj203a7xpUjP6mh5a/"
    "2LLSujZwFawX+d64pCOd1OHS4qbn+PrCqtHWhVsxJddKv/1eqmcPRfv4CorHfXr/jbXyHpuG"
    "uk3sXpc7N6q3UqbJLfnHw9IuT3GjvL8HgR9uBmmFlc0WPeNyU43+cp6p/sHraxxe1l/l+RL7"
    "A0Xnfktp8B1WtDUmKjgH7MMbZgR0EcGEHwVGabJxTc/B169z3rxp6LdVpGUxk3Maky7Qm2jm"
    "5wcvLyzTckn4Qq83wWukIfKXhgJ59bGrs4rB116h5oJ9ir4LeonzjN4Oddlbl7oaYqiooJ+J"
    "BLmTKXCROxEM5+QjPD1FXmgUdO3ep7wyFuPG6LC1hZR8oIRHcVpFvH4qwD5woS5a0ulGxPXz"
    "l6TuPGFc4xVn6bwWcYGJCT9vfJi0/1mmfTPn8B2+iZbkF5kzAHaYfWuTofRktrTcXBIHFsMv"
    "cJfYCiAQNnrEecf9tg/eCUYYADx/ZjIDBmyXAeDxdv/IG3a/EcdF3782ZGyuMXbIO9+znMsr"
    "CaBL1jwKeBCQDGkv8N00PgkmBOF3ousybB0YNUQxqh5RyuQLPYQIxo58kUWqRo2lJhAMKDk7"
    "FQr6NIFou0AvkNt7Zy8QAqXUugNghPDnOkxx1N3u++QJ5TadY5KY6100P2S0OryxRswTn0zT"
    "34+4xSVUnTUAtkvkJBYNzjuvu76gpCbDcgj/+PKFfatMIKaWuNEG6GNC1l7K1ce2T5/gzVxg"
    "ZsVBw9hVtraK1DBknahVtoswf00eoXK1UAJj2edvqlpiw+jkb45ozwpARICWg6II5VZxikXs"
    "YBl+sUCLdvYSa1d9WgmIQ6ct2EVB1qE9tCq538JGgceIFzWZttY6Hd0X+nyoDGILV+1ygMnD"
    "TbUVtCJkPJ9rXvyrynHU8g1yHl7MR790l9FjSZIUsaaqHEEzbO5qtlI95y5ca27xTGK5tpVe"
    "Uf2TQYf4zPiiPDNdF6YHVIWGXELob84j65AwdyDm60emGv1YLpXRyrKQSM8XTsYd3qKiOlp0"
    "/cCPh+n2XMXpMzLSD1XiV3STT6JqQg4nRnq/e77J1B4xP3NlzkClWwkDF8Sgdy0jMMqtoJGD"
    "hdZLhzrE5MDrlX4a3j7tB3Jw3f9/NjzYJXMsb0VTBRk5IBtCLZAqB12Xv6PsHGWeGXOgdi6A"
    "Xr1NX1iRGK1rS9HEj984nGG/FqcN+tILFmyEtPiYjX1aqs5s7inmEbtVLe53X85dsYExjNxw"
    "1+/U/xQPiY5q+wIQ9sfvcFxiRwGPBEbFjxI+ktgMcdjDq/ixnS8vF1/3B/yhFrwUq4secVff"
    "0CTiknZuLAafWfy9awG0n9D01X3RmLXUdgMebnOqHaplCbgXTZ4J8hDT17Fxn9ng435x++XI"
    "eegSC8XeYsRjtPuiPpfH523tiTBUwhx9szYi+EbH4RgQtMs7kVgs7c537rUS+OiR650x7/Ie"
    "mq4/RTNC23P1TtFOZEIMOvphoHN0hPB5eqJqWGzjfJPSn/YB3wjD0BMKQ5XuhOrns0rYiVig"
    "SaWphJk3JeNNx3/s/ZgOqBa3b7emFHk27xoeocNAEsJeNZijKNlui4XpwTqX05T2s9IEyxny"
    "x5ik1Vd4rkr0yy+jWx2tSiw9SS9UnEY3sw84OPoV7LIob1zJB3zyIhh032/kX5cptsJ2RLy7"
    "jlkcP4flNOI8lwqx8w9FDrmSvbFgzqr0g/7pxHT3ypmeyfdmutT+m8b5urQ3QV6yhUqqbakf"
    "Q5wiE6oyogMA7J+Ne6+PtOf7rLLEksZp2pkhUfzsSyy+4RQ63198pBneE6MNsEx2Ifun77BA"
    "M85+AxEfkXV0lh5EpurnjCixnPtoCcN8gQMaJTgOOxGZ0SIXz/j0ywE77zcN6Nm39L2FXXXL"
    "5cbkad6LDrmRiIQ6hjPDGVksqZWbsLixipkSg14WHooY5hjnymkE8x1aBvJRO1zmHx7qb+O+"
    "vRI+O1QJyqaW8nT+MewSMQxYeLo0VAzafRebzYxI2DTlKq+FAMwpvt8n4oB1ScvoQU3xbBd4"
    "2pvPpqUSHqt79EreS42Fl7GrCRNtgRuL0k+seCItD9QK8uzH/nnJtbFk9UbBDNALLJ+F4deb"
    "igYo8SEkrUDIanFtfPUTv3HvMZ19Xs2JvrLuDwcrrLAiAi9hoKzRYJZBVEYJV6W+68Oaxuv8"
    "iZBTw7tlStNyWGjlXYxEvXJ61SNnde+poMyiDz6ND4GS+MBbzc14UMYTnD/awCfBvHT3S6Cj"
    "BYhx6smsY5iT5IcYGyxf7Vhak5aDlYek112WiKC3NKPXxmFCqckYseqqqGXsAwmrAcbApiWu"
    "lvtHcMuzDSvoTJwVYVTsdVklgOg43IMv6OaX/CLGlvkEASvYNQuvdF2iBxanaiVT5JRX2rf/"
    "ssCGV2LOtRwF6MGx4SSEGmy1b6ZT+NUKBkqwoMv2r5u+yA7Twt7PHRBYUBrzDMzZ7wM0hrYV"
    "LkD+R3F9OELhOAwYVzLKLF8h4ypFkp19XCVJVlIh47Jlc/YdZ4TKqsjIuMqqZO91Z2Rv4ozj"
    "zOOscw53zo339/4Vn+dJtkMroWcwj0t7nAe7ccnkYhhaLNO0+Fm+EGH5y9WccohsRai95rF9"
    "gi+fvYZwm6nVuzLpHxKxoRerrD2y1RE2DdYwCuavpDlxDHfeNExyakYZZoqlcp44O93v0T/a"
    "pe4rTBo5iIXymsnpfkjpTuJZ3sxuj+xhO9t0ZvxfwWiPpp826zhse4OQf5cSGqterMs9Uom6"
    "9a3iG0coKw7b+qeJbig8Qfa9n5+a8UWhsduv5tlCNQp0r1mgv7+RSHpyfB1ATztJ39sK2zPS"
    "7llwDP0Z2MHzlZSP+IdzMput8hYVPfCtxCfkXPs8fNu1yDpS3aCEk0DVqHrVxrbcdzEX62EN"
    "XOXRAzsPt5CE0LSzc4Wo+m5gPAkzw7JC11w8bvIbOUFK9lJC1qx2bYRDG/Z3/3o6YemaR7VX"
    "49NgWi2x8BjrSdRyXPT89M1JHW+TvX9c0lJeQrt1Kj9etL7fwUI4XSIizNC+3QGh9pKRKd1s"
    "Ob7m3IStdVXcBv3CpH8ET128g9prW4SOmkLzv+LqnNBSav1qf1lbWXYbfZs3dIKD8HfhO9lw"
    "e02LAL6WmWd46MIcIDSAnLh+bUgcJD9QPKmSDqS+FzO7x+TDdKbi33ZFv928s8onMvRafWFV"
    "wMb8VnXBnhOhEnzz5CqsTyVYo89ndq7qHEkCscmSgZ1/7HX9vjybXC1nqyHNb/xmH9nityIA"
    "fvmqjc7D8AvGUb0/1BB/RFQaMu4oGFzGb1MobbbWgXIt2iQS90Zj0GyFtKSxJcfibrX31pD+"
    "iUXBLwvMnwhMeS7p5xNbsBbzuChsT7NjdT/U5xzO8RKGaBkVAqDsf6rn0GGWUz0zNkizvRwS"
    "WAUpTgizpLZlkln6983XHDY9fBlKocYDLLCbKvEfNaRD47xxbLVOPu0qmYCNPedWwTpCLtno"
    "jcZswGVohxyNkRi7XX1ImPjfex9lid7iW7lZPPipsQmUYn1hMJ2/TX+KPcDs4vT+Qmtmpe/V"
    "DRYmSw9gl/xSPG6f1Gaz6DYjFQgg+P4qkvuuuuI2HCHRJXZbTsDszLjY09WTme/FnySIc7Ij"
    "AGnMqEcOQ5RlYRbDvvNKh/jquUC79VyOP1MLtDRKfgNUZlOBGzu3REaNSwelb0HcxGvSmhlE"
    "3geZNy1Vc97u2LB9pEl/PE2tuPol5N4rNnwE+Doaf+bb5nEN6Mw3m5jWJIPgHZbcYY48Q1MW"
    "JbZ7Vs1ttsvBiQC4MH8vYN30DFeJeIW+3O5RGtcZo2w4tUfqT/f1lvZXsdKNJvwSZ36NXkhy"
    "3RRCi5189xOwCok6othIo+KUsgCs+3Dsa7R0kDnFBsXZuFKjJARA7f33qqcxbpQ73oVaMT0Y"
    "AS/gcwylrLwiO5WgQiPXcixhtHZQuG1EGIaMphz7zg2jCM6HRoMfkwn2oPxFDdj+sikw1KdS"
    "i3z1aPTgws+jvrvXkCxZLIraq4SzkWfxqIou0GCrERMqHEVPI/c/TtrgzzpVqlitvvdQk9A3"
    "z/WzZixyZeUifISQJ6P/QjfFLkRt7PR73NeLuttILDohzYvVLeemJk/xkVy3y97ya8L1N4n8"
    "rKTT7VV41PRjzKi5JrzBSfu5rfjZU+C1Qmw//KnO7CpXqmYDoxB8zWapiaR62s39iuUYuEMa"
    "H2bT2X7TE/nizvXT6fMmpsmiS7pVyo764HBAUGO4tQvEJ+aly/zdIcwmmZ7wTjzq82/b8DMy"
    "79CgXC6cSPx7ECTuTzeLv1fbr1BBB6sNTV9Sw6uNi6hat68Nh1K1KmOa4dwMk5YNLiqZwpF0"
    "fbB26wywsgxDVSYfbMRiKEU0hu5pmjar+2Jack/n6spKH1DumKAYrqnxK4KO3szHYMjMzjR4"
    "zsXdoGkz4bwXBkynnETxnD3vZB9Wtcma1RxT1OtxARk0axJy01VW5qtEoSVQXO1Z/Kzok41z"
    "ZjxKlRi1/mrpqXfj1c47S1WH24/35nMNgz9/oN/861DcnTncsn2+W40fHC52fM+Pzvfc9VlQ"
    "oWGOy6OtSY9yW1yt3AkqrMkL52zWkYIS1KKOgrpE6115eGJy/xzUrNdCPLIJZFlOlCzEYizT"
    "Z5sPZM8jq0aKzqqx2bWHEf6irMVzTcs51EaCLrQB0vLTJeim0HzfbkI3bzpd0X0HtVo38vTX"
    "6qW6Dj2ADFBCUaB+zKTk2FhF8wHl0YRCK/7kRRRJSBQ8f1VVP5I4+CxsodGXQfeOperUaAna"
    "3QZH6laftD9V/eul/Nlo8Ygymi/MFvCkK2F9PRzq9s7ovROnMbufPMX+0Je7HS7Ksijod5Or"
    "IiRZBSpwozEJv9P9kzXTYIt4KQqVmmXTcaoohLlK9e3nMebLWQTxFKjwQ1SdKMcoB30mkw7W"
    "AB6GnIWgrrns3AxsjRRRAduHR48vhDUd8E5ayu01Ju89G+ouNlHgD9ilRQOE/7rdhrIPtWsx"
    "HzVr5g4YnbGIxeOcWs+Dklo5ltpqpF+6VFhGXHhnMxomgWszK/kLJjdnPQowe1d1tUSkDPHL"
    "l73kAXl8niJ0O/m73AndW4eJ/BmpGf4+kYyGnsm9iGs46mqsy27zdhguzLPuZxyztkwJPZs0"
    "7JBVDV+aOtk1YW9vnJP/xQNJM0X5rs0FmjT7Q/Cb0ReDbWJ4PsV2k0bzrGxOv0qUSCvmpOaN"
    "1TicW/yYlILEAnZEFFj9Qi51ZGvLcNm7oxI4PmLqD2GYauGrrebkTRdkSlWByN1Ecw9a7/Us"
    "/Ts/x7vO2jauqs7Oz9nznHbqaRZrEgWu7H+ib13JyR/oSEoYP2ZB0hVugApBoglQ2gtCjtBU"
    "PD8Xcdt2zy9mciek+GKx6xH7HjdcRNffrvd1ayc+lpKAryE1UDy1bhU4d4Wrh8jjVZ2G62+T"
    "jSLX9A3vTN3VUsNDTvOhEcCmjwvkfh+H9sSwDmgEx/Zf+C/NMUsmF7qFeaXUF7xLZWTZckWv"
    "DsdpUsaPP5uFYNGVqimRm/2E32AcDOJ29LW15zCXCbZUZZku6Za1A+SbQW8qiULlte/nf1/U"
    "axsv90XcGBfqzA/PKVBXZipBZ/4kcQKggXbPDfx/bG/AzKhJ2i9cy3VCXkIdNR6X9JY9GsPC"
    "+FGT/nkt3wno6UDgUls1W3PcxojIvkW9Ui4F3FoBezwstBGTkFIzr5JnLezPnJpAODQE9zbM"
    "3Jn2atAkmZFBNLtd7xPyrjdfeF2whtvuZw0YzjyrL068n24XnwypIAEiS01fovNXRSSv8X0b"
    "ul3WJc84p5FMTz4dlvXp2AC+hTQPzctnBecwT8+TBPr84Gcuq7mi2r57GyM+af8o0bPKj7ma"
    "y7dqU7dJIKY0qTuT29H+OV8L1a9NWW5zTBggSbi4r70D39ZMNMIZd0waC+xbfeae/CCXESJu"
    "+phM4/3n2oJMBy7ncuy8O57juAVeY2Ajr1T+GaWOlSJdkMXWjOgLYbEUOFsIiocRVSb6kNmr"
    "uSGWe/+wJqITbZOZU8nIDaTvY0nfmQJWvlAhdFjSJKWGNQriFyYSETobJH04ODzoQzVbOKGt"
    "ZtceWLbRj8fStMnCKqnrBcjwLXN/H5Hwxuv0+RpI6iqFWVUSRDVPiNjSHzdI/QPcLi+QDulf"
    "Xj7Zeb8MUHxE16C+pgkUCX5cf+11HfhYnfXwHctwRyJEPNJ/FuSBIQb1jjfJDDOa0TmdQnGa"
    "Fg43Kyf7tLcWi0ImfPEEoRn0VlxB4zJT5s7V1p6Q/nERzaYQOvs5M6wRWn4tlu/3Dkbkodk7"
    "uM/67X0ApYfnU4brFe5aCXlbiZyrA4NiXQ2qwr6xomLid8IMdBKMmqEaMOaj4Ecj3AngKeYZ"
    "RORFHwPh1sykvd5S/o1FVsKY0KIHHE/yPLzT0KrgnhQUu+s34xB9MnhmcRJbuEO1qXr76Inj"
    "y0IQiI0ygFTUKQZSoNlk8y7tUZiAxtOlAZbeDu+99XnpmtZwnnNK18SOtzMs9TRQmJV38PKY"
    "vThcry+jrO8AXJoiVvtiIpyva8hrNniyK8XMbkXA53HrJybK7XYEutOxpe7KcmsGrN2vHXui"
    "fGHbTj+iK9LvEvKfXQYz+ogL8KWh2Ha3dN94mq7kKg/vQJul1a9M4FiRTzShgkRKbFP6QtQv"
    "0+3STrnDyxEGCD9W4svlkeHXUnoVrh+a/EHEy1tCByr/lWdVMOIja6ATHBWlVT2NIvi2SYrL"
    "sfTZr0sSvEk6FbMDZTUuN0Q7Nsrs/ZvPl7hHRcwcm1BmOjYcu7Bf8H61IigKb396d6SbHNmS"
    "apmr2+bDOfyySjsYkuLq4yfu0uS56U2RfvxsdFiCZ1yz4S/4dkrFQnZTCzwA5wkrF82rKZgQ"
    "b4Pa/+6CLlusbjNhkVXwpIG9zGyNkcblS6t9w4nLErsfNi0ovVbnQd9H75+lhcn+J+SvfREv"
    "oZlrZpXPjfiQt3f9IOA74yxF5PQTVEQyfLP1M56IG9gaR4i0QlKTEfCwKMELg5z4+jUH7PMi"
    "iP0MoUxDbAReHtH1KkAp84jTJt7sMWw61Ekf7eko3ziOOxJKI4hs6DptlNCdFnJ6/xXlLbP4"
    "JDX55u5OHi+06jQHNUs1wbK8cepzz1ZeH9odph5edrFY03S54HL6y8X31nHBdLBvv9/Dg2uz"
    "MiL5AYt5s58GtZ7fTT1s8fxZw9cOwLwqKvbtSJhtnkod/Owqp3ZaahBmcgMyPuNVtUDGjnmy"
    "tlQMF3k+PRY8C3Ku6H3gil+s9D3dSuzI6AIpB7drn2XzeyatCFVojuzJLwCn5h7XtgAqqCra"
    "zl9SoeBatw1NEz1X+u4RSuvF4mciC2H8egDJCzoHMB6aXs7BX6Te3gmB654rty2tFmj2fbfa"
    "F7iSuOAdbmCRobKMpkUuBA3yPdNaIM7OLi34CI2ilr/QHPzUiqCHcag15S3Pa5LV5bj7o0DF"
    "E6Oa0T/OQFrTR9EUo8BImj/vQjkV8Nzp1gniD/S37amTvmtn7CSAKN1T8k/Xyy8TmLB4ZnUx"
    "uiKuD6jUfJwJ+CG8nXpp6JWTTwJYriFgCXpPe7/pVCt0EHx3jjmHWCetqZjaN2oHg3F7a6Mw"
    "vmPzgXuTCwd6Vbnkc52QkdV6roy2Uho3euXoPC6Iq+vTIQT40WIN7Rcaycm9A5ag4+W+g9Qh"
    "71G01kKGpBHJwIdofzZ/wxoufyRd+QkLZ2IZoSINld6HhqKHbCFV4IUjquMdt3XWPlVZb/bt"
    "+v7TW74Ky4nirZ9qR2PPfln80rIxojPEqqd05C0RKwQcDZhZEr1oLLgdOFw9cBF7c23NTbzu"
    "zteuUFWbmXobWV+7n2mCCY9D2DQvzOy9WoN8Qgn7SeeMDD0eSewjvKJc6euPT/1VeigQdLkg"
    "8Bz8RHWYzWkRZM0tX2d1Yf3l3pngwp5BbSQmgJQBpVYQAto5KTLUqJadroReyGxh+e/tpo9d"
    "gclQSYcYZnLkPMqx4YWW8Ybmkx80/2SlOTohLmOWyUKrSJBmZz97D8AyM/8PLV7Pwk/iyi8u"
    "CBQIbMxnfhssTHHz/TkznwH6ir4Z6l/mTytnkLtH06+xFh/iBptxn7aGuLdIEQxtqM3p8BtX"
    "Yt90w7nqCZYYI6AVhRSE57mh6IbvGTSEInaGlm2O3dZEOtcst+kd88R8viO3Ba5RMNLcvu/O"
    "bMKzHyNj4las7vn10UsxUSk6u8dcXDtsE8zUfybkR4XNYlGHCfE/yn3N7XoBdMCnwPnQO3gA"
    "ZrvAV5tviih4k22AHrN1QC9IjQTj+H5Dwd8C05hm6OwWnx1DtzMErWh0mQ6JfWvQAsFYyybp"
    "BpMDO5rTkM2TEcFUtxJIZcfBsrNegtkdsyWJs+9azu9VxpbXWEXgPOSrdUrmhpx217K2urdN"
    "/KB74aPTq6E4CaS2RBOMVI1PAG9stBhS7oqW59HjZCf9WNPO5DrVrw8DOq3jGew1HJV/eAZ9"
    "haN8DJjDCuHnmFKuz1vxXVVqTSca4lKgJqmmVh81peNJPgXplpDvUk0Ji82ggX80sx+QVVPU"
    "OSP4TeCmN5lVvosBRdtg44FPY+yFKq0++F6+v1OrYi6kUSmexNpA0/0H/JP6t2ZaLS9GBSvj"
    "wpi4qxsH9L38OY9N4R123pPf7kMch26Js2+CxGmzmILudtzu34PO3IuMr9thogpvVRNkpMcr"
    "GYWDjPvnFDQZ4uiLlsxa0e1/V1ucoZpuEififbleWfOmq/JV1JvlreoOUYxvi2DcbC9rSC3J"
    "oPfGykXaq76lluJf4RLBjzz0OoXSCfDmm7CwyKOBfv6VC+xx94PPoN9EShvfKAvaKXWyu0U8"
    "LTXFzYn3HALHIuuIGSdCVQ7bOn/PMk2dfrtEhNypSpn9kvwr78UyMkbsjlWtjXIwFWmrWJlJ"
    "HdTQSmz4MLo24njvYDr2/NnXVBuu8YW/Rt+YOcVHSOoliwfi8ITPPeOQMMx7zHaf6loDQ/bZ"
    "KLOpwHM7JNOdOyeX9Cjlw8yTWt7dg2tqH7ljF8sR+J3GShtD3ZS7jhRXQSDtingR3wK9rQ6z"
    "/ektWs3zlfYcJK/jz+zoahfz/BXNvMYwzUf9SdMPkR9r1GciuBsuw3MMLHYXn6i5Xo7Y3ty8"
    "HW685iNGWOMnCHQiajQFnMIUY/d1wl8fxNV7haseGcQJwc/504RUBbuuTIFRLFLGft/faO+8"
    "qIXZDXUsbKu2PY0Arl0OJ13RPfoRPH19I9Y+Y84S/RnDIjSZU7wACibHp5iJJ5Z6w1UUyQ1F"
    "SPMKk+7vXQ1tT3r++6CiXC5cv+fUfA0SfjDSxfOblTPSrlw4njx64COdz5b6VpdrFh4asUtF"
    "fZ0jAL5KvH0EroFzMwG28x4S3lfhoqPJQcNNtb/2jh22WZ27ztP4BPORiI75jgS/g9GtY9CI"
    "XoxuolfIFC3Xl67a8jdcyHKJg1mUU2lwQW4lrHqbNt12/j+9AllTSkCb6YnaB7ELhUAXKxBD"
    "jIPyGZouupb7Yj+e+m2j/G/BhTTvaZXm4pGdWLnzRkn5nAkc/1zrcMnetzM61hKcbXtTrTl8"
    "FKvTudLnGeIzA167sET7cmq3dO3YUBvuOXOxgdr+iqpjd9UOUkJKledWugEoj3CqiozwZkEl"
    "XF2RXxYD9i5uhA/88/M9zUy2H0nPlOzqPPlVsZP6l4kAf/A9imDZ2MuMCXni2MOdQ9UaPVGw"
    "32+07IkwcyXC74hODSN2WODvcY8SEF71joG4xUc7HGrhQn/ev/gRnWXirDwygY3JEMuKBT5s"
    "lL88jroWuvp65myed9urDezqw6pEM+KLdRKrpldQLP6g4fY5WjMhfL46dYZQdSRvQV8vL5E3"
    "yz/1d1fjTGeEUQFw/WePBieH2Ch9VlNp26tPe+OCZus8j/A7fIAJrnt/pvuaIn7BDz6FeE81"
    "lRyN1rlFNvuHX2Hf8fkhhFBYb9J/Mwo6AyaVe1HCZTQl/g1+dgIJs64tNBc1N/S00jJUkAd/"
    "i9VDjWHWtv/+lRZFWAR7UaIWyo98tufX7m+rfRHga1HOp9dJuRq1lKE6M3WVXkgEJd2vNzN9"
    "yz1hf7flTkCFCIzTN5OLn7CXx6elwHfcbk4Owbj22vGj2sce11OTnz0zsQ+YaNMGxrt2VZxL"
    "WuS1moJoiUy9+f6ShOvjsvIM+zVP2sYdMv2IvqC0St0bDggt4bAHc5TIfWNMyAh+aQNm8RE2"
    "VTnAxrc6P3UnyCudOcUhWqFtWuGzGxDWVvlkuL3Fh2t94HKLZ9dzAvVMDTE5M3vWIfsQPzX2"
    "6cybiqtoVK6MW4hCFMrA/leFNtTxKI25EbscRicU/xIdvuM2Cra21fFaGYpRiHCHEF3PM7L5"
    "MGsLlFRK4rKkoIhMhKZp5BKy62j7M9kGn6E58qaSQsSSZokjMjUdEt+SVVjW4edq0AefSOUg"
    "BzmSjLAD1mlmMaE25Sax/WqSff6o5QI1EXNmcv4tPlyn44f98d5/3Pb1vKqTCto64p3+d1u/"
    "BcGvbwfZ4Sbn+CU20cpcb75SbNPsF4M3OJbFXv/bpk4g60+RrVGR4qfMcfEqrJ1PQvjiofKS"
    "3sCZ175aYTIcpbOlUK9uF26rZsiaYhdxiwYDi00s6vCmgGlPzITtX7MKHXDDEKZD/TZriW4+"
    "NOhPXvH8iMeX5qbqv7dSh+rMXlduA7um9Rnth9YJ9qKdbeWpsYt7+1Rm7n589qKSSmQ3Swa5"
    "rMNGGdQvrLvbRdCsFIaIcTXceAiGTQkspoqL7Wwps2c1ViF60JFkGafI3eUEP67LnTyg+rY3"
    "bhVFPUyJnWLkv5fnCduU3t8ZLxTY/FMkXiBk7BLMGd0Gm5+khsHzsN91wfHeWXZ/HdhyBF/K"
    "LaVcxGFlxEJXJlT+Gnw7I0E3c0BVqXvw3l+cXASZme/snWqLAo2AFMQMGH+t4hipqjYm28lv"
    "O+ODsmG48VnwjaDUdWbtg4r5umaR5KJLaz+pe4s6slkju9W1tmGlJgI1zXehaYPCScaaXEZu"
    "g5i/kL06PYEJ1U9Tc5kUfPrjOYGApKXP3V9efyUGprrEHj2PuLF4gIprpkZslK2Mbhp6v9jY"
    "6t2i72FE30CFqj+XaP3EkljB06CW67syOjsWyL9/fTJ8xjgrBw3kq96TvBlvFisrDslVBkWg"
    "FHhwZK2sUPAlDvKbp/MrPNmXDipixWenk2B0aU66V4gCJ1L13LCMw0ts49XgvZYhK4xEiEJ7"
    "06sSv7DcPgNVwNFoqxa3gcpw/hdLmWOdyRTt3hFPbicUJjCXXwnOvVrN0gI/wCsfjfQLppcs"
    "bPoVMr9VpGakkR74/MP54IV/Sr4F0M0uuyycO24ysyvBJ3KiX2kXZd4EXbGqWPgNeAsZVXxT"
    "Ary+AYkpvpPvbjp0iUVTd/TE6ntloRr7eXquIOvg1/+9yuga6yXu15pIlVDcQTrzSs34muWu"
    "ciRhaXbzFYL0GDEGiar5FqBKTND4j62gPdjz9dvX7lH3o3rbv0/PwyzLg+rkCO9bJLafmTXL"
    "bdnfEwwtVxUjC0/Zcgfe2JlH4Q+WruRs7xdeRXPGIo1CVxO7aqZSps9PH1c+ejPHMW+iKexD"
    "S4h8rvYDu7mXoBZbKrG0G43qTpUfBdyisgasbrA9jeyTRKjtUPmvwZxbxp04APYMiP5ax6/7"
    "32f2pU25aEM74cqTAMRPjrq1JupD+K9uqKipQRPpU6vB1s+6Ou3r//yu6Oz0pdLvYu2vZKxb"
    "qhJOZ8ydWnleTjEatuESDr5Px/yDpM+9MeZRWeI69V2khuABzWP/ff45tOkdYioc77Azzye2"
    "eNn/PdjdQHStinfgWr41V8/GSEyjY+CbZ0zh9047SNaADorpImjwTEeIQ5mn9LzSjDwB6AG0"
    "qw3Xz9pa3+w67GKb94LK2tcjOb/ItgYktW4vVaHXUyd+fj5BmyPakkHPg+B8Bzaw1Kp4eJLz"
    "VNJJCt3Yw6/hp85d4VVGBqx19Rj/A2RRntf50dk0csA03Z8gvH+FhYty76AKjSrZNERbwK5P"
    "BPMG6vYixSMc+w6yvWK/lYgD2HFvo0lEjEF1soIT1lMpIth+mK65GieueyFiJGTyJFIjCBgm"
    "6Fep+t1bGkWVWGgEwhYE7rhdauFDNJzvStXYF8swq6u3tp+LC+q3sTSx8fX0CfJNt/X07JOr"
    "7WoLuY01XXTm1WFLiGzSZUC0S3CGKTgdP0iC+EYtmfwhsBjrM1R/8iIzvOJUNzH0uQ1s36en"
    "BmadAQt+Md5/Ool2+TlPVDlh4CixWvDO0z+Euboal1kCV3i3cMruAkjV6t/bl8EWos90atW4"
    "evr+xBtLjYZzXcxcmQ2z1llvqX6u05hwzHl6rhHzCo/iU2rQr7+M9GBHpFC0Bp9iYkrU8QFD"
    "rAG928k3/iX5JKUDFsWJjwnOmYXQeF+hfGBg7oSchuPC0wjpVFotEj1DaZoP3eYbUs8J5S42"
    "hUJygGaL7mOr41XPUkJWZlUSA2ROUSs3H2XnSk8p9/RNJu4qBZT5mzHwZW9wyTkhF4RQxCh/"
    "9egbcJmcUZ5XvP4/bJ4gkfw7YhKLk4FuDXfDraFcPZpeozQ7SC3K6QtrvmpVmQmvnHvzy7GI"
    "7ga8NN0XE7OqUoW9gc2OzRcIpGU04UzVcnzL/OZM+jUxLYOL0h6mdSOy4o5eQ1O9hxDvw/Dc"
    "Kjak5Sn3W5i6o51ddsuC4ZBbAC/cSLpFneXvWu9prOD1+TNHQoa5byF1uI16B3ZPDTcqnSv0"
    "QH/6CnlweA8QLM08aeS0YTwIeEyR+1PSWh+1GeChypGiWcHDtegoo2zXmNa2OwgrOHkf0hep"
    "INX8vqHI1vArol/Sm96cVIZX6sDz/HfngZV0MqHqH6WXqhvcnEPQE2hxv3tX+4s0ag70xGTf"
    "IcTd/aZZUwOW6Y6ShF6QD3VfnX0bWvqoIOThqFF+nJCP26XIB+P4DdBMdTezyxljGx15s+cw"
    "g2L8jPTeTArYCUL31+4ynwA6NUEc8es4E5HycttIelOYqPLa7TZhzcyytL37dkOWbXGXTu7P"
    "m9ZKPwl4BDXMSzXQajbslbWAylXdX7kxj+mOcsozvuK0GnPunD74pvm0o4Ove06B6pPPgt5O"
    "130cGG7AYkouwAcVJkWp7LsbqSLr2wWSI/2nm6fTzFHMu1Ld6G4EengSM7NnsQrOjW/Y3cy2"
    "12mpMc5oaypLswMdis+7Jzs1h9+WC21dd1UJQJCxKqQfllSVxYiywe07SQvsJ+wAWtO9W3HY"
    "/4EagfKln7KHHh/tYF88HXTzIs+tBs1NWs9LMD0i43KcwPx4uCPv3sX7hO+j82vA67w4xjfL"
    "v3NlbUd8sAS1HF689Uy2IZRycbRb0hW2dyo0eCV/P5YYh1LnP7jH22EDF3vDnnmUxsncBaU3"
    "vUldSoY/RNzdPgCQbyoMyCvHnlwpCPgB+YXGZf4FKFNuLTE/nQHZsnwGGm+B32sPLEVSjMt7"
    "pb9SD6Ra3+8g2Vf5n/WEX69y/tFBO0f9TD6oO4u75fwf4WvQ8TK9i/4ZhCRnkAHEuUC3ktHu"
    "6B6s/C53rbZdb0gCmNpySb+bxmicEPUKsvf4dN7S1HaPyoNaYFbqNkSVRaWF2iSfGocIqSEI"
    "sDnOP+x5B2KPR6Bfzn+E391bz9yejGRqggBNrNdHIyOGtx/EkeF93zZ1RBMHH7etLkZuNN/c"
    "VqLfYKYOlMDEiPMS+WowwRx1wu5r45Wh+jYJsc2aDQn/oLpbn3BbQyf4B+3M1ys1UH/vUAPY"
    "B0yHOxMYYZGSm+68davkAJOYOtY7EwI1g1LI/dfovnkL4G/xUF3tCtF0enHCJ6dbmOHlECCA"
    "2sjQZ6yxf3PDr59vCRWdDT5mvEvY9vhg79TMNwWUMUUK7PdyOOl1ErNVqxSant7SYho8bmlT"
    "jDh104yaTnd32+3Cy/9wABFuY+7vjm8r6b7Os67OvOCpsd5y2SAiKcdmTKFfGXjarzr0HMKU"
    "M3s74ouftRVhmvHNDEKDI1oRHm7L8n92vsTdxb61CP6Y+ub0l8BbBa8fkXN2a0zvhi44iiFw"
    "wMIHWk7v0mT+Q+KHyhO8ryWmCTGhVBbmCXYoeffy0MZnra6F2ixdltFdZnpdegEl6CEUgOE9"
    "ad7co2yQSMk1ZrKJlYPy9WSTy1lxOFl+bU2tayMwWQ3TiGFJ5hCLQucDzp6Xx4nTT444c1gK"
    "RN0XD/Xj+KBhq0Fa32HvUcrwCDY7/BEyxOa0dYXgK5Tkt+y/Ty9mphTkUppPNRWl5Ye0T4tD"
    "8qe0NO+hLpdYL4y5tJad0DnozDYZF8RYrt5jFM9CY9fKpaTFsSOP8cuqw8R1xCNGu9lrcAA8"
    "Nz8gwnOjCqyrjg6LK0m1BKUtcI4WrNK94wVeip9MDpYCNK/heHjX0GHHwwU/4f2ZtahQ4R7+"
    "whOYTbz43oO1W4xlprrjXbOhWdBQ3fiLcEfnrLBjBD1hHoRpXhYC3i6y87XoqInTa7dYo4no"
    "QdbaXNLJCsG+iH/Uxq3KtZxAM8arn6HhZcHTzz5KKzQ90XQgPpxFPJSWPsAkLF92q5qF3t2a"
    "fDpEQJZSJdYcDo7No7ka+U7/atrgZ+6oRU8mMnxK5iAKjRVJk25sJ01ai2Ijq3LL7Ofi+26O"
    "R5iBv6Owfc2LRRlnYm1gBbKWh+obhQa9b3YrSVY8ZkdH0x0ACnq0k2ttQQe5n+cQHmATl1Jc"
    "VvdqhbVsTpGo5Q4BzF32q1uRAHnVm/mfVWl+NSdaFN8JwMe85gfEusnZehsl14HSWqpQZPYO"
    "/lXM9/CjtrMBgqXw7ua5SmF+enHwo5b5N0sB+yI+ZhOCWDJ0xFmirVOo3+JUskn74Cey9bjT"
    "eCUeWGrfrB0zsseYTwB5sT7tGQ390qbJ7FGoEUbN/4kjo+/YSMpH/8o2J+5XvVkzbczrNzRh"
    "0APti7zal+lLnKP/tRz0tHr62qzFYO2a+Ly8Xbb8tcK7cwpsYMlkiSif47+ioaxMv/upBCEk"
    "T/T1rufi1xhRAR9DPqsnGvk+QpP2sH/RzVct87PYW7iGgv0/aUoW9zkEJVmGTEZ9kvWYQZrU"
    "xmd+j+wdUYgCUizZ3z+nUKKWCnSLSviFItUNmFe9aZ0SKYjWLDh2xCBTJFxXd52a18D3O2kI"
    "lHecYczcEHeHkCxJPI2Q5EL8AgJVIAmTGEnlPjWsqJSs0U6xEKcmM0qxCW5OW+9BWxHVFjkq"
    "EsHBJeYZcPrn/YuMSw1t4vUpAMuyei1QFa05ESURCQ/74twG4ycJl8GPzp7rF1/odQO2W6+f"
    "tpytq8vU7hMd6+ra0ysdZHafAUFgJy5c936eOd0bksaPa10M5CiX8PbwNmMLvggNpnaL6ZcI"
    "wXfsq6rIfbQaQJHTRa7vp+Z8S+r/rhlMuhHi+SJ8PRGtSokjHFNElFrCVLc3WPbf8bbeM/Ad"
    "QKrt6L8jM7KL3zr/AxhadlHtSooZ/HzzFW3g27vHM6eNwfdkv5k9ANu63eMmoAinKEmd2ACq"
    "n8eu3czIl7CYZOPcYLdc4qSneGQA0c+3+Sdk/FbC5vWFlZ/rbmJCoVuj3j9+hNbSufkO43TY"
    "dWIQZycJo2y+1Qza2HDUYOSuw/e114d6aopnbtGm3f+gNaM1BROYnu7VAu11p61MUz1UISDb"
    "n/frxROJuf+qF1C+ZlJXeufRcQK+4Vl81RxvRqy/V/CrAWdkoLrqALQJSOk4AXt/8fSLencw"
    "o1fV3de1b6l2SJzKsgpBmkaO6hyAk90Odu+7XWL0zauJO3aFNn7U90YoY0Nid6DMsoXu1LCt"
    "BhGl0dV2wfzcmcsINsjPt9kdeVesx2clK++5HBzOrHuEKv7VTDz9uNVd2U8Wa38stZeTXuW9"
    "T/l1Zd/mHPhItsHGkSaHMpJ8fxT6wYfC1bH7GiDVsGt4LcR2vdl9HAzG3VMuPoQq+5LvtkNo"
    "C9Z3k8WR7aTyg9AIN+2e2YKWd3bZmw2Z94Nc1XFeyjgQ9nYnHXG9iXqaUjdekBUsk8Ubrzlg"
    "1TqgfXfjoimcuOA8jNTK8O7+Oag3IG79yZNOJR5WPqp32dcHWdyraKIe/Pa7ma2O5LDEpzBv"
    "Uh8g2IQOD1fcZmeL6bM2OqcdfIW/XH2+4tbEKxoVuoHB3Ouw3IenQH2M8MkH6ZcvrmPyNt8o"
    "zV/Xn/3VpHfLGIcBB2UytEZJAsm6e8XbPmqzw5lFjU350xY+v28lesJO6jy59/deA6RXpcam"
    "zmTnVEQMtZXzdNE7JSzvCJUrsw5zBmeU6rfsxLuBJD3/UE6W3BqfX7costvL+PN87euQXaAC"
    "WY6CE1MN8rY53nHFIH/67kXSe3dj+t/gLi0yGsbETHYAuyOr0JWNnN77fO6pxawXujQwR1fR"
    "bTvmDr6kQWQ/CcLw0AunSFW3+pZ7GYWfVfxPN0YdOg7fnQckGjv93FtVv8ijd5yK0TDy5pr+"
    "j9yoStPzKPjZfTcTNQo0TQZddE2laHKMli792E3VE5lJ0D3zHoK8RxYyK1K9odgLGcImc6+L"
    "LEwr8xZ0PqO47IfFxV92+ynH9x1VN98cZnjI64YrEX8I/lPGMXSs9pz7gZaI6Qq5Kh/GseL2"
    "DwCzQb8TfWvxTh8n65j5ccHwsvTz6DoIMTzzI6A6bN8GTF9VKHXa9DaW90dOTc+uZiYOav70"
    "dKr6FCP5NAFUuH3ffkcoYVNk4iRZqFf9NbfGFTahqnermFifil3uehu2rsIa6Gt5dSgzIDEJ"
    "BCxR2WMV1UkjtohCJY++rruH8S7ot34i9pBaPoXU+XZoXv3BjOWoY9M8pam9C6nj+OnGcEcg"
    "X2JfUuKm/qntGAf7Xc9VAcSp3vLdgL0uEVe3dmImmB4eWRtke25lNNi5Gho1F3cAEcvAYAav"
    "TufJ18ukD+Y61AIrKangJvtnK5kTvElL8692PMTBdXynIV/Utq/B/6gGC54QLun+KJlnbeNZ"
    "J/Eb8G+PVMEhBRbliu3XXlY9uzGkTYkNMOC7gg6d2tqFmiGSemUv+6DMVqRlrzBwKrF9rIrh"
    "LKI2yLAFmvXafDrXYdAK8nt1QjKr4qzuFxD3NnHuSwR6EyRUffNUxXkvBKYP3fSW+N7zowXB"
    "rfNKUUyauhSLwofvtCGOhvbhtVs+qZikPqWHI6cKc9LrORtyttJR4XdUE/CrWYcZ40JUX9hx"
    "6eK3KoZsXmog/4qVp5pJdvTRLw3Ohuy885h2QpUmY8PfyMxu4kHkIDEpUQMBeN4Ct/3hH01/"
    "IjQ1Swi872HNEdiUYjXi5uQua/o3UXp/XYApznxL3KFT2OHSAd1VM79Q0TZYdafh2fazNQvN"
    "qQoLyMMKDiw5de0g+FM94WtvRWcCqIJpv73TuB1wSMGy014iTl6WrHl771yro1dgWzaeqGWk"
    "8ipqIOB3pGMEfYitiqNH523VpfLGH33zKczpOxR1uIHqVjuunCZGsVMsN/xUvejPZyvwlrx8"
    "osUHIv7hDqxg/fpRp/QJ1j70gHEE0R1ZR2dhX+PwtquI9+lgHgJ6keQ/HhxOVtOo9KzZE4IY"
    "dPDgU2Gv4IQFzdrnzKNGOjPkkQ4dKnpvKm8dzKwPbBPRQoPWTdt59EuunH5wvdbiY3pE2fE8"
    "cTwIA26660dIeOsNhO/gl+wP/B3+ujfc0l721Apj9uquo0cNxkNLtMEejyL8EUsV4d3qlMkA"
    "lcfD855InVGocMkFiAfo+eX0kbaNZxIvTeC5YXFC/RUQfS3FwxrY42E37sVXC0Q2PA+X5Ueh"
    "1Es2K/V+5HjqQuiceqAH/ASVKq3AC8dRmqaDfyS8sr0yQZ5gZkv8oNU48vvbhcaG8iuhuDQc"
    "NPxrQWCsh3s2hUe9hrS8oSz+eFNN8ssG5aL9ANZ8D0ge9oY/StAUKiDbXCUPDJdIDDWe7liw"
    "1eyXYVcq81caZ0Hic0c9VviToAyCTtYN9gWZ8Ib5E3ZkF2+W9C21nqOUitGcIF/AL/UomhEj"
    "uQ8kp9AZtinVpHRHXOdkess3XzJgLZTKQQ6fOVE0d5UcaTYak9i62Knp08uKSEDLIIasL5KO"
    "gv1eE0gk5d7cAx/MHbr0uXSNzshbix+/iNLSnpAjjIPvTST9qZHbJiCYrMGShxFMka8yF7bf"
    "Dn1qcG6iQnWVwMf2o4oc4xuQ2hBjfniu2JDsIqFhAFeB7Wm6Q/Esz2i1F8nYWk4bgJxuq5Pt"
    "eVbbiP2g6bjEGtFVapvHukDnaYFViU0pt0LJxbJ/xwKvYlGOgH3BAMaQsrLXTkS/0SrLbzvq"
    "co5KyV6LmnJjZkbIN6TIy5Z3ASH/bQY7uu9tc49sQw69i5tlzE41WcfHGmBDuw3v+Aq5m8Iq"
    "4yMC89pR5N9hshxU9ORgH99UUIRcLjnYUb/tJa0TMvLt2Q6zINwRZ7M5ztDFJ1x5EMDBUcye"
    "JRMHtpmR8gR9KUQzibHarjQ+J6DeiOHnSfTExo+Uk1uneyIbsejanqd3pgtuXg7njj7Osv1+"
    "mAG1mJnMAL/dtQ03dHrdVn1t2+ZLsrAlIZYmQUv/b+Tx/Vec7E+tfrWCFlnCtIjnvMDtgH3p"
    "fyBeEpV/KLoj9cst2tGvmn2TVV2XPlEUZQ8o8jUwMcxts0EbZ2ctJJ+g7TbUQMxvPLkUEpys"
    "lcqomF7OGbH7wtdV8eX0bNPnKIBG5yPMINmNSUsa4XEXZR3ws/lw5rh7gd7uAorbEZw+vjmU"
    "kmzQ/0708fj4dCzDvZ41NuhRjUqFKuIVV2ybg4WbORxgdoF1KgQ0fBBnkgvUi2oyAWLWJto7"
    "PnrbulAUds6LXEg6trg1yrpokoQwCgN6Y4wGEOf28oxiIpKR+WMVjl62nQgzk73dpwtYEYmz"
    "MMn1lGuO0hudCyRQLL3rdYKsX8/O+LcS/IwjNFFuh/exWaov+7Fg+9zkTtpgir6dcjepOIm8"
    "Ul4BKeK1OgHkJUd6ogpipcUzeu3nDbWs173lEROLeJzHo4QY+LSz66KDb9HsRbhmQmrBvP8/"
    "PVO3KnOUzsft+8TtP0UAITfSgiP8Wro1Y5ts09tcwdeeBycEse4ZRNLCchaC0nY/+lJF4sDr"
    "qO9YZoigK7pjidjIEc+GzpdpwjJm5tOzbYZ7Uybz8+PE+bp0vRQYXDIKD3XjkDDhe81M+RaW"
    "XBDnO9g5QlxiyaxPDI4LDwqpnwwR3y5rv34vvyjQZSVED7zqq5tSQ/OWtEpoC9WUcPRtLops"
    "mAU+NHOJow5g3zH64yJYfi0H9vr0NVJMF40lzuYg7odTs7kIpa0PGbP2fSheNoscyQnUvUWR"
    "M8FCeHmcFDX2d6f3Whz5myzbymly21k5P2dkb8e7wCj5b3b0R48+Lye+s1wBLtw99kHdjyhZ"
    "aLqfbX+ea4yywbl1Nk4adY3QXGFYgHTvlINVsuGONi72Uu5tgUzahDb+kn2V6WQVZ+FLLmZN"
    "NWk01xm19Rt9IUTAIHLhAHfS4e67vzBB4UJV20rd2zvFTt2ZWLj7MlSfaw4yHEoEARl+6B2H"
    "QLKmbDGI/ysQGh08v7Xam8oCulZUgYMdlIt8tKJyzwK64Kte+krlGOOsse78g7Q72GjCEwmq"
    "TEvJ4W8bxXpKJvlSFs79UGnfKFK151NFJQnNTjbV5VD8/MlzTAvhX3yacZrxTmuJVWIzSLOW"
    "pnpaVfHtc+oho8GD2ymgNCIqm9TyQ2lm29T881Xan0iKaFJqDtx9P3l4Tj0C2DtQ3AuNHxx9"
    "y0PdmZBSGFMQ289W31kozv+98XJDjoG6M2agstf76ThHCKCHk5JBsWJmFyCl4qnTHDvl0i9F"
    "NZxbMp/MegZOwmB7j9LyQUtgue+thqg7hay/pal6C3LDrkgpm5/PO8/+v5r9oVOrHhaj5oXE"
    "ghHDBX8xtIcmSCq9V08QHYqRBqsBb6MPknWuJ5s3LHgjXQbd+aEXc9uf9kuGvG5q9MGHL0ZI"
    "9f9o3VPYv/7HW0FD39hwsbc7+9Hepceex4V1Bg7nU9w2tQBRv1tddsUobzeCS+dvIM0DlN8W"
    "Sm/a7Mbksw2OCwkc5xJPXOGU7qRvtuqdt3E9CMO5uzUAIdHSzWzvZ67pc+m2Hx4VAdrxiIdm"
    "F0/Oj84cMYmSPpNy8iLsJ5cQuNPFEQ9LifTVdibb/jTftjE7SHPji4L1uslj2qhQxNnS/dNj"
    "SiOxK9UoKJVYpfGqLmBvAvR1S6Nrf/N5JOsqOkQGgxs2ecs4Uyt5LFBXrDuVpYXLCnmN0nEb"
    "crBbrfJzoeXNgn5xJa7HF+Qq9fkOnltl2qUuyyZfo/4tHF3pDEfskb1RzgPIwYZVD1haWsD0"
    "psQW4zd/bjSKEa02CuTXOUmo4JPKb+U1pwFHS5EGI++uQJUVcap0brU+spRUdGdF81uG8jYs"
    "ckJlxMAbXKXUASwA9cTwFOrSltgOVDLLCdVSub1F09kTa+pLXTzM90YGpyV8KFhXHCSMKrd1"
    "R63SBOk7etwK1lkpn99jr92KH/wBWYenxBa/2fiBpdbN0QNdLQ298Sk6i/clV1wWACHGHNIU"
    "you2jtRqt+yNjEAu4nF0ouvOMffJ+WRkZ+AHU8jIzZBR+V2hINbbEq5FSHxYmzGUXSKcL+Gw"
    "HPbQkJmu8AayuSnNM82V3NLx6ut/TmRxy7u+xUBZKPhY7IrsiPa6bAvNv4sWMrtqO9VQ0btn"
    "CojJyRfv0p8XjRiseCqlH3GL4xx88Pmb6YXnsIol4SkQVQ5TnytDPyr5CdIm9+uQGYqMyyrd"
    "86Na3ZM5lzm+srlVq19qGMk0HAbJpTpWsbeF2ZEYvS+/gS8zzFmZ2QVj/FWdIktBhK3XXyVD"
    "lmnYd7vKLDiOQvtv0zs1s0jPoOGclH3a0gWDKNRO22Frfii2uxwnCKvxAZ599TaSCV8WVNCH"
    "1OWZ+uWuPW34Eiy6R5r7abL72HprTRrrL6s/OaNi6hBglGmkgL1xwlJWtvgdVaOgZfO3RB26"
    "N0zoJoSTIA0b1gDqmZuEx7xXywB5lZvQh+sCr6si95r3NlWeqT1equhFpPyvvrWbd/4zZcJ1"
    "Uc2xpbIriQgZImNrAA2B+nGN6jWy5uu01TxgSM+9V/mqFNC1mriY80MkO6vF6KMJho92VorU"
    "n2tQNWcD3X6v+xHQtmGnoJmGwlCCBs2/9ntHOa6Uwh7CTd5SOMrlY1tCwGLtb7QTmfE8wcm1"
    "rpJMLx3b7AHDijCmOvk9yaCOU+QmqYACm8errXwA7crTdDbrRh82WGI5TAJ3cbMhc10YRggf"
    "b2/u6c14QskVsZe8qeXfnux9LHMt30dL+iEiKdOjI4eXh2zoId5ZM6HGTb5Zb1qY5HrS5t+8"
    "dvlTvv/89rBVXUkKR1ZvUBCt2f9aIwgmn7vDReW/MYsfjwZlVJvr/Jjhi5Rzmyr5XIEukuUt"
    "CqCtUZJwO0cdC2tR/WbNX8Od6SMbqDFBZLBtJa0YWQ78rfvU9j6df0BMa9frL/PZlRbnlptm"
    "8wZs9UN0GTKzcJ6Mat/oMDuhWT2rd7sPDPkL+ZzOUA8Sx69sSgZGbLx0TNSGm/u+Rdly9CzD"
    "I+MXeZkCyAtYuqOfPuT8lA3AS2+QtUIir01CpkeroiFR2/jAHb9kueXueF3DWE2zCnHx9xT2"
    "FpTxpQuj0UA87fm3aTsnjods6lXu7eXslmNXN7fpq782CEWlcajVhAD2++69S1XhaladewF7"
    "s8+dCjyXOQLXMkfBZB5I289o5j75IIbbgOBQbpOKVP70B/Pimdn1jPXr7bYmhJiwElHtgdL9"
    "xB2YNjrrSfdVXIzp8Yd9ve9eSHnd2Nz06NVbuqJP93ovq7MAEFdPnnmYu5tFx79j/N3r9mY9"
    "JzRi1qF7TfyItod1PkmQxbqrQefSgzwe+El9eBG6CWs+kPMnUsDFZ06MFoIOJP1fagmU6TCX"
    "EGYkv3aEzdYuJIZhBihsc6OeN71ZuXT/Tm3ZX7YdM8BLztSAgwIuAZIOCO33bCUtzCDw3fyM"
    "4n6Tx/FDMNFM1zMihgt4LhPttiarzgHzUm+jt/O94TWjSXx4OS0rd5uSWhU1xRP/SUhq6OUl"
    "60l4p4tecura2g5Rlya/kPNJWajt56ldmtmzHFfA/Mr0UuqaTpJcl5rWZndNk1Fa5JmzkB9q"
    "Yb5b/674dbp9VyjbeH8zqlKVPYxamYWYLADmSFJ5dPw+v+ClaQqL7m5FmIZ+C710Y8BoPfiZ"
    "p51H26ssO9uN0YXOzbYdD87jJSubt+t3pivoNWo3Ht0FZfn4fUVeHiaqfHQrmS8QYDI3MYLY"
    "qsMX+KwUg4NG6aN/1zsojlJ61HyJQN1Hw3VrJo9StZ/J022OEf1wMtZjWjO4gSbXlhzGUCaJ"
    "IGQJN+f2SAsXMlfqlUkPZzf5qlo3oqd49gJEzaRfPf8j123bUOYimlOmgOlm/UN33jIQseyG"
    "iGeKPuOZAmzZDH7ILEybAcHutxOnpHtOyJupeODtUMl74ADpVr1JcaQU8q2CfXH2dr7d3e2u"
    "hSv3QAU3n/8rbhf/b6xBKYh+AbPLF7I6I/jUZjD3ZdkPsZdMR2YN0oEu5baVBc44KRNN6hud"
    "XZc+s94+U/Eg8nKEWF007d/lgaD5x3UmqPiKuqY1YxhW4ENeKlVlQI2H4bnfINQnojm90gBw"
    "WHknjqne8e+SuDLd6KLtbjUNvLfT6qpzZbrIAVwTNJMK6KHvXqGxoAbeMiTIyH+Wh2LHOuNs"
    "8XtcYh3VNmGm4HdHgCvHK458wpe1EUFmWzYY3LzgyT0z4ZSMAQmhyYkoEcE0A05xxbD2CtpD"
    "qoUDSFP2rwPTeE5tpoOx+47i7Sh1gdfLFlJ5YwsRxicGTT2JTuTBkPJvgB9eJ7+39wLLOf3H"
    "g0YO0IsacYlJx59wSyxdb/2tJdzzIh2GwpQ0b6yeuSQkCL0aVc/FfP8V9HArJ52neORtQhOC"
    "U5emtXjt/NR7AWDnPGdJq32Hqn3v64enZ4UU7uNdBkO2JrvZtbnmlL0Udh9ZZ3suGqIh1bSF"
    "NXGekN0HPyN68D0M4QauogqYoJLF/BlwDtfst7gNbJSR5j7XC1CYcOB1cXdnrdh6RbATeWhq"
    "3yrjfT0Lu+KhkWEtCXCLOKcRjfld69Ik9KmE6+H7K8Y6DcfRjODvoFIkDT1UvGe74qwHtT1d"
    "SzLPsb+GUMxx+hNLMKoNh7zKMJfDGj4GIQOZj3D25/8rtSbxACzF/J9vHGb7Cr9iHl6beohp"
    "wqjTElo6ld9C3h3P8jKd3+Lf6n17/42v9SHmpFn4U2HEbb6ZIGEw4k4TIVoxFvX85FUkr18O"
    "C8+3FpN3hHKex+lk8iLk8CdqCeyxgxi2RdzNz2vSybsR8at2ctV4Qu+s6WyGPJwvYdQKAIhR"
    "uEZyTrHSNZl8jBFZn00HrxTGJ9QzBYjeNq6Xz5Gwrn4He8spgJS8N2hlEMS0vO4ngBPkHaNN"
    "evwZ6LQ1nrM7Ca3bUXyDMpKnq7++ngPUlWUWrlBQu5+rDWcEbCr3fHT+i8RoKcFQY9mG6jcr"
    "uFG0FE1fuILvNmFAGyFKNARZ2HQ/1VK13yc9Iaz9p7pW+HuSiIwfsArSC0Obl8htz//GxPs0"
    "N0U6HsaazB8UndMKt/6rgeGxFT9k/jNY3ey7jSk5WZmMF7/TAWnZ4ASwQho1YkT5TnWdBw4/"
    "zUA6Y2Mk+47yoa9CgevM+tkAlGU+itU+RNlidexfjD0Ojz8mTCozngju/+NckHuODHivdXcy"
    "dWUeN+qWceKCetzjLtg4YrRdpf301eW3aM6IZZ0SEd9zBD/DgF7Wmz/CMWI90Tv3VYnY/qHO"
    "hhwz1tmcziuBu8HhhBcRmb1naQkO23Kt6sQU9pyLhTiFEw64XviJtsqv/mHRY0lRHh9jQNNI"
    "Zy8KPF6o1zT/cnAV55Hcd4oalLgm4hil4rVPvMPSSlW/Z2lSr1rsUYYq4C7mWyKyqtMmlcYN"
    "The0FhaNUsfeVdr6NdN2AcT7ZH9eo65ghjrz5X5yhD8Z75KwkSutrnBizjd7lLthnKhbIpXb"
    "ylpf0TBh/upB7eKoiO2fim1a6MU/Zp6/QZTC/veKB3XXQgdlJAu9nuhlZS+qbqSeaVMPKAMl"
    "BPCA8J2tDCVqe2OuySdzv1LKaU0TlHUTeR92wPuOOSdCnYPvWopJzC55E5WCvvZ5Zo9V+lU4"
    "E2gSmEpOmHv5fExbSVhu8ooTOHOimJkk/5BxkPCTwxarcGbrqI+4iNreTv5RSerJNZCgzR0N"
    "yUbZBl3cv2kz3vAtBOTFYb3TDT6maoztXoziMusFZJ6YsutG+YlS2cMPqMeUEPe42JIJepgn"
    "kmNow4wqcfLuEZ3jqcHEfXtXvxfhOQTQRWbF5nntQaSf7oXyTfsDIxXy952kxb78vOXmm3aP"
    "zDp7w0VHHxAv0Evz6bNybH/aOh+0A49/gPLBsruvK9t2ZlmBwNnFRAUnLvPwHZt9Iv18ZOq+"
    "4pPVgLXJ/2O4PvyhcBwwjidJZSVlj0pRXyGUzVWKyqpUknFmZO913Bkh2Um2UzIiexwOZ8/j"
    "7H139nbnHDecu/v9/ojP83reqONCFNseK/ldiO6GKo97Huj4xEF3Gn6kFJm0UphU5S0QJHif"
    "JNoD/D3iKT/9D/rA/OLvho6NJ5b9HHaBsM05yGllZS5coPL+iA4ZcsXvYprg7ZXImVFTAvs1"
    "uY04wSRPweP79BlfTPlJKNee/Uu6cGh3kKXhdnFAJiLK2JPMo9rWIv1ec6QLcC8ZhWLKajSm"
    "wVUBytHQFxkldGP6D7c3QH/fy8affrbXGfJOXkt1adJezUtv3siSL1MWXtfQ6tCFruWt+u2G"
    "M6ZkznqUhxz47UjQYxZZlL0ebXobcUpTNbZC8z8ViMcmXsyDVxUXkx1N28RGF19DOjdT+f4A"
    "Z3K//H2xNa6QNoTzzc2jbCOcVvtzEVtzcPFO7r5I6WhjgNFvhZVzkS98Di+rL44++9sw1++c"
    "yk7V1GoTMls0AA7lyYN92KuDv+IHFyo4JND3cgTE1abAci0X+qhZvp4HdWqfpC1ytai18oLK"
    "XC5f7ltoNdaiK/X4pihWh8oclQJesasxk2/+AKGNh957A8bIuQjVU2+ecwCk15ErU0AcD6l4"
    "27Lut3QXTW6SyFOQU/aJrS3pgjkGxooWpfCqWAZu+y//nlKxbABq70EbIAP/JiyDtjnaXVqW"
    "ELOt5E3t4+WTviYeZs6iNvruvIj4IRfQQAMcKeyFhJBx7A03vv2Erx7vkmCOoLDspvQFgT2B"
    "I4NbHgPnn0OOPpEOzD/o/KyWBX/QzPMl39J5Dqts50Gjm1S6DhbbGIp7FjeRVTv0afhcVUPJ"
    "edHovZb6w++e65Grd7kgoQ/laNRVp9ewQsd/UyFQEU2mS2tE3JngrDPKOBGfcwUfDpoUlpab"
    "eAcaMESF5p5aepSbBCADrrW6dvR3XOUgVmjsLUHrpUfbjUdbgZHmllVqXDFfwlvNcmrTV1SY"
    "k0rTW0HFE681rkcu4ytaX3yqCKdq0HpYz1SRzw309WGsWbX9SqyGRTRn2p4C9n9GZFrRQULQ"
    "oe0EqIuHnQchKBLr79z0YZ/uZn5QNMZnwyjaPJ4Hj0VyLGJO9Y/m1mw2QWNTE37ap4XRNzah"
    "XOcQSqGHS7WtBdGndl+BXAe7HdWs7tkJEEucebqpcivmnW/DyjUBlGlD/cjbjBXnQtvbxeHJ"
    "C79yDSJ/8ZyFRIvKtIack3CSyFGk+ut+6QoxKGU4J/d6oKuKGfGhqHMHS1e177TRXc6VWWjs"
    "84etuj4TEv/nYDv010xJB/q36JeCOz39RsXY8dlSv3FakHXRfevBmYsjcfxhw9hWwiZPxtl7"
    "fX1Y9jBN5sZw6//X5E7ouXwt3dYWFJvOno8x6R3i6MNP7G6CY3BP62JsZOPwGznCwL8en8L4"
    "t5hz2mzZeR9DdZl5uDKfMvq7jXK5ofdoFu0WvqGYGAa8Xr2PguRry2zzVUd4iupf+hBgNA8a"
    "KVlURy+8T1jNnMj1HQ/IfW2cK6dS1YwDbssy0sHoGNnV23T7sMUJyszLzepph7UBW+0u8fKG"
    "etx2Q0igLkRTCzhweG5fWadSjBa8UU0sMNr9u18R8oarEgkgmBmzCPTGcTh+r+xgVzk1vGT0"
    "C13S26Kr8Qgh5m7qDiUUaM+taxUw9RjTPhnWc08omZI73/7wTJonxZMryCurttvvG65mdGWM"
    "dSxAIoKuicUabR+85IBPdGgDo8BQacSANuRh0+JjrN1A11IUMsleKTjZPUnALAeQFNUa1Kqy"
    "sAbOhzYBL5sx8Nsg+PunbdhTu3rF6dy0MGIbQb2DwLC0goqPZyOY9S6aiGutZ9DaOPa6VcR1"
    "9qTHralu8neRyppL5QYWmVZK+S089KIsZbSF1JH/Lf/UpExG5CYBlBXzfM/KhPmqRwFnTjki"
    "Z7vNx3/THI2UFVrKG8CAxZ81Yd5qoD5Gk/wxd/+0oMx20O/R+HIU7IF/WeiL72W7b8RzBy5O"
    "jiwL8zDdgJ9xmBo6Unm0xiHg1cby+L5GV8CsCbW2yDww6JeE34YW9kPb3HBc29hqsW8ZqYlV"
    "63WXocySwGGrCKmRRyWZOPGwQVQVUQ8u2eUWfFU+wXijflu9DzKANdmb0752mtR0KCWRN0AP"
    "jtTCq//61VX+6x1hLD97A2uL5SNPc/RTPXqVhCpnRQGBXpHWCvi45xNIdYvuOHVkB/8u19xp"
    "huGKESlWsy4pE2MpxWeUhczQtHeOGLkT8t3XQPHFJfoLQq3eONxpevkp+vuSjvOvvlIUa+rX"
    "vUq3DL4kF1Lt7kX5KqHWQrEfy275KBfsG24F/EZVtnt8/FK/6X3VxrDV9ru/iMvfCB8G3ZyJ"
    "hgpqGmqPsh0CjlJrQAm8wGsqpWuwTOgb0+MEULpv5Xj5EmwdTDCc14VitW0hP5zpSjOJsivn"
    "rQLfbgw0/hcSRQMgx06wb4yEavU3bGCnwtrXhHRF8oFeKo4LuBzWWJ7Ni2YIQanGjzbuF7Bw"
    "xtiX3W+ftedxdytZdpYOkZUC7mHQIx3lf4KjAlOyobOOgs6xFkYLC4l6lLRtjexrc2SxyovN"
    "5dwV4E9n2vzgMza9b/feJjPQX5sO70XBtqUXa5cbNhIfpmaFuivC5vMepe59EmpSEpDoPcSZ"
    "Jn1DKTFtBxWv+o4aRcwEuZRn9NXWq/wMeeQWQ7jb8kuHcSNYJ4X5vP9S4ogApA/o1m/z78ZG"
    "pYFmbtfy6qTlWcdu3jQ30iOlD2kStXTNIUXmU2ZxwC0+7s3CaWzrDNfQEEtW1MNptM51iHZt"
    "sqGh4VZpus8IYcvKxArx3WW9w2gf5MlLo7rP+X987vvfZkrMbe1Y3xWPtIOuhbkGlRYBki2y"
    "LVznWSCir7smcd+wRP5xOICUTBW0HePp9Pow0SfOLpyhCacCv3ZdYQ+fKFFfUvE/76Ya/loU"
    "Wg15ClhD/cYsnxb4XEhied8o57ks8XLBaUFMUTuFG4kG/T2SDKqi0d01Fg4c92qvhFwoXxHP"
    "L8DshzL62a5/P35C4cxeqKy8DlHhDDEcpFsHDQD2sk/eKfEGoHc5xIffQeiAM28UqRg44yni"
    "nXksZguwWt03C0VOWD9YA0x2Mic9ZvoYe9wWVQfYgjPGiOOT2MZD6NodXb2Ty0Tb9kJrH8AK"
    "QtZzuK++iP4kQCTHngfplSo2q4SuFFHHf9O2CU2GpkXN305Uy3044eLriepWnR4Efu5aP16H"
    "RwDq4rA9Aa9WgyxDbIS2sjstMz/ZY5aWFwQ8xpe0KSeiffWde+nAZXAsKu+aBHodp6JEHf5M"
    "g9fwuf+ZVScas5pq+8YafZk/ydfxgnyUjigHhUH8ufcW9ywPuzWIspqz07rMbQWZ1LnrF0zE"
    "VeqBPfFp+kvXgmifQxW16vtO3VtQTb25bYvzM4pqyh/EYIfoLeeDp9eEAvDVAy/WzQJuDRw5"
    "2kLH/GIjRlRT9SvI5lckPDDtJjbDWqgi5ZTMre2QuF5EZD3ZrUWEARP1qPB6x5PRZ0g+M+lM"
    "YJ6zhOwxiuXJxgiLPKgSS8gH97NoV8iJvtDCw7khr38aljagcFcrU3wLnLCuyAb47/z1rIe7"
    "w9EuhMnvOy3PAmo9SfyOpdIuNosU5GNS54Frfz5jn//VTlQcHGgsiWwnIhZC2Qd5uk1CQObx"
    "bNIC0bd8W0IXzNG4bLjBFb0vI7+itC4Z8vvdYsr7px6lNz2aPV3KcfEaPSnWSmcpflfAD9LY"
    "It5bKqykVFMuzXSkf51w3o+Z6a6i2opRtcCNAsO7u7aOx9wM0eBFQ9QF6DG0adYsxmofHMH0"
    "d0+pvqSy77VvWlE0vVSMC8F16l81s7FEISObvIRUWTVEZMQvoiOoSpGPERYik1apTOGDXM5i"
    "tpDOX4AN4vT7fmjy4H7BtBkg+sjLOV2Y7/x/lAi86GFPJjV9xAp3vSxmjMk6maToQSkLKTIe"
    "ljxu+1IkPrUsnnm913SdekPeCG98ZfdIbu4faB+6//O7sRrwXtdQz4DFZVTrQZm5KIDg4ITI"
    "08q0dJwAKX8C8+fdE44PF/6QY3pkZJCt5C/aGjFPH644AUbSYa8R3zCPrdhThtXQdUSLfPlc"
    "UIgnjaK/unlZlYn1iE2R/Jeuo0c4ehFyqmzFytYXdfvoK2d83Zj16HLLsygQPKifQur3e0Jk"
    "hI40H/rIvKHWtXLF2IsImr79XGsZfPI8G0ns4n9Lpn57Px/0w81w5csh3xRi7cJb4Y0eATnJ"
    "nzt+tImQ7ubNW9uztUZalmJd4flNUR7Jcxc0MNibAgeOM8tkfpwLIRmcH+PhQ1I764kSkRJj"
    "B6xbSJP+Mqvgsyq1c+bMhxNRovG7WRDfn0cDC2knFEuXzc/MXhTFwlemzjOtqvxXwj9u1lnh"
    "oFgEj0IGAFV5ujyo7JV8rZnTgEiK+9BE6u1/0iULFyLVHO4KC59hLd7HPur6uQNYtiT+q4k8"
    "TsconSM5SkM+dwMld08S7/IUZTmdalVme4fYnOf4XMsZYBqddP53bcc/49TEjFAlMWtlyQ/i"
    "SxUo5P6itJSdxkSPSxCstp7IHaN6BaO6ljakB52dn83zCas454b6F79dWxO7zRZYyrw1yv4V"
    "RcbPMYp+rUITk1i551g0l4QDwprltrdFx92sZmkCILKRCzUZNM7VptzREdOlurGO02FX+BEK"
    "v8yu0LfLfi0oP9QrIi9GX8XZdR4iNkXnWad5Zlg+NxB1CIpv/9CWPMvkCZei+8pDTua6g63k"
    "7PsC5LWGaUAmimc2acuXbhMcWL/psv48m4zC3djLN4YZbituHwB+DRVvqa55nxHowkJ9WiCe"
    "htR2vcDTymh72uS69FNV7tqOttKohPp4VNfSYrU3z4dvIVUHz1RHv8irLxKKrfVnQ/4aLftk"
    "E/KuNAuBqcrdR5dl28rM231UzzKnr7yf/PuPmnQm5zLPZozEdXT98aXOmOkrDKFP4SJqU9zL"
    "+n0dUAvaVa1+QgIoT+DCoIaiJ5XUz65fvoHb018IR9j3Nvl0Go6ZphpXtBovksr0a6ranklb"
    "vhzKy2kK84MX7MB4QzcOVi5UiNIMtZTZtft5aZcM3rBPZ2mRQ+iDKkvnFlZvMvRNJ6TSIaPO"
    "7m9H/PJyRyBPhSGNqWdxO11bZRpUpmxDKh0c1sAVAgaBEDNBj9xOUHyEPbmeVYAFIkJtw+tc"
    "q+PdUCdR9sRSxFDvyueZmUgIBS5be5AajN/oH7ilbXsIrm74pviu53rrkaS+0uIDdq99iyls"
    "gtzXz4PpyR7S4ulBeRPBnjwG9x3eoBNardsdRfpCKjz6AHBa5/xnRtKQ0FMt2t2Ni57LpEBc"
    "vdnhPH28jD7nEpjYt9cRx3pUf2AMKLIzoWmKHEelzmzA7plA3+yy3O7vnZj5PqM+1q2tgQ+Z"
    "c8xVZWMqqu1tfLjJuEkdlhitBK2Qprny1wGGyDfA78p5MaeM6WliUI4rOlUtUzkb8jAATFh6"
    "9Ej0lSoxZ85N6U0OWqLGYvb2P7e7VafHqoFvFo4kZaVvVbBKzO3z94Uoqe+q5oqug31r2fgV"
    "KvOzq40t84YXm+Dm7uyz58o29clMwudbgmEfmTLAzQco74heib29TPaDGqOEjbLeFhoNtNKP"
    "NuV/qtUiruYtrO55pFcyU1DJnUWsZLKINGfCQnmPZPIa0tEh62KgCawXQwUvmIzsutwvssRS"
    "QjzlVNE7vKAU1LrMkeoj/sFzOrFieXZxL/nYh2e7AdbrY5/wj5QtfgNbO7h8eQPXceoT65ja"
    "d1n861ECUxNKJsd4aE/Ea/hkx1HOj2sz8CIPRO4n3p69BxybHLoS6ONNE3pp2oJnhhSkSgEb"
    "tINzsFAqcu5b03nxwZXY7ZDXC7ry9yNvgECEBLBhRQJihO3O9P/L/dwr5yERKt+oGCohw+5h"
    "LjcsL4tdmtrUzfEg9nKJw5suS/Z/auUiyjt/SYNtilv6+1B6n5BwVpqT/+AtzT77HY5M7Sm1"
    "6sY+rAtMtSxZzhOJ9usakQS6rwt75S8bJi5+AugEpOzDRInHCO5W+5rexscxe3h7oB1ore42"
    "Aauhj/iLsHzszwagOlpsBY2dbtxpOGV8vkqqnai8mB7Pq+qWzDuagY0CCqer+F53Z7jMKx/o"
    "aHOsUl5WBF3dfo+2twwgLtaGrt23SzX+w1CtScdy43IB93U15+c7yCKsb2+IbItFZL4Hnm0W"
    "ZRd7UYuGA7vUmPahJHSyU5iNn8UCO9/p7ZjuhOD3kKzyjubOXNf3w8e7QvcbM5rovNMSiWku"
    "mulG3SV9SYHojVaELU4qWDTlmNJ/eb16bOofD4nTK402cFIQp63PPabUErB6KIgyUS0+ghzP"
    "WDGMz3sFwmDzHIltqdAnrCUBpwsroOdYe/rO5jZ+lzK026rqX3Z6JUdCizmMyuvs0sxEjUjs"
    "P3wLinYs3SQoI9M/j9RPUUymeu4nkZSVSFnLGgCSpJzXjW4NHKLOsM4Gx543hZp6puc6U4RV"
    "20+dCvwztnPSQ9EKfSNAb8/j27GKAXdLfLUhpUCUjCgTTqXoQffFo8ixYt8tDg6fVtEmZjxT"
    "9G4rhF5bWKIOCv5EXqeC3yQd3BFcqOkito95Nnvxr9/4cVE0TeT2AXrTdf+nHFRUBkMIUt9e"
    "et9K6s5tmkAKAikcyg38O3y7HUffCb3MT7kdan5G51E8Hu4C7oMHFJSD7qS0EKCVcmb9xY2H"
    "/jvBM4rElCMWu0zWzRG9OfxJ61D6wRq0EnejEZrM5gmlo7YnPiP24U6AoLNBhWJ8P9RUWfg3"
    "MpztkZjHdfquge1MTHPtOmqUnATQzvVg9IxorDTOW6mf1rMJ/sf+qHJMYFIITnwQbXQJK41/"
    "OUNi9SuLczD+2rxg92Dpxg3EWR9HZrT6Y0akDRqQP6KZrB1Q7ihRUtZCKmgbDzhjt03rWd+o"
    "TMb5yxwNS4CbkfStN/BSVtx/HpF1/MVPfPdrD/A2ycJnPM9NEqaHZdHxOiAYwm2xzj+kQlSy"
    "ioLbCjPevP08gN+3mmfSi6ilzsGfDofioqPOh/u7rul5lOpDh/ye4QVtm21/Pe0t9vbvXenU"
    "eSz7f/wapg+4CkkjPZfvih90Ghj7b1Nk4IgB60+FZ/x5H3y/77LZYe5YvDWnu9/TnvR85sa3"
    "ZVYxw/ZbSuenOSxUr+tfI/t/AL+6BTgdkzCcv8kV131VwSNA/gz3BKkY5/Z9Mz5dZj+wH3G7"
    "8b+nyncrr5FhB/Y2hm+fE51TlC4a3T7oOactIPTyIOVYhLtgak9HVRmQkRhnXRblOJb9ebqg"
    "tUqyxR0FOwiOW6LqtpAaSeYq3oLlIoQfRzXaBVo/A/JXLxhH/WV/s/iaR3ohgJDYp8z5Vv42"
    "ky6+oHGntTIhVlcysi/5xompuYt6rfenkmzmX7OQ328rbLncCXfcZRhTxdIh/8wISiTqx5e4"
    "++AdCRazTMjHewFu9uWrI9O38QDXM1iHXq3lo/GLKgFUlTQFlx+OeKmNfVxfbDP5YYFWpgMZ"
    "yd7Djsm/rw2pCT1qq0uUMYFTQWtweVGnfs06OEfryWOI3K7bpw5ZKU6GxEqkdHxBM978nq7L"
    "4c0wuGq3+XJ1IUvZUrlVWIyvxrdjzbCHW0nGs/AZr0Yl3zhoUsg1Ga8B6RFRh1963StMVKlD"
    "uqPaXO74Ud/wiXW4VPniuyp7GXbgR7LL7P6q5oUyiqqKEfbFR2n6KXHBsmYnLHfhGy2mILBr"
    "94dxEXeb+OB1zDgr7LFdF+LCvyywlfqPmsbn0ymYQ3Kqe9VTaQlHjqVIQ0zLa3d/jByLP8zu"
    "tExtEXdbEp+tUKNEpgbqAoQaeC5IXHJseDgqdC9EorCPnmwnosdABNewUtjdN5AeqUJITHwK"
    "oSm8efTG9rLgtKhBWxUL6LG/DkkPtfNAVJOb2Te6b6uTaRiqs4hkJK28WTnfl1BzVzivglbA"
    "PTnTTbQ6FcN0qX7BZ9asZ97iDkihPsPE/ptq7hBeoT4eGDPrwG+tvwKxbL94YYkhxnHQaazA"
    "Tx7yDYvLfmhnQk75ptzyGMJjniDSS4vvZQMm8Acbl14+XK+iNQTeph66UG5T2okvgD+zp29g"
    "tw5Gb8onRAIGW1AeB3yuqwt6fnLvlS93ySxFqM7E7ba5aP+uE3ISC8QKuZp82BtctTJubE45"
    "EtEtDT8yPj6XqLnzRGLGHHT0LYIZmmXj7VVz9HqJqFSsxmGP6pqtczqsA58oeKp6/tQFzUoq"
    "5i3WHjpytCmxYHY+Hp1fk1czJUGFdAENyYviGx4nnDqJSVXK2Bi6NUJ9VSBz5ijvnb/o/F3L"
    "Gf25/qAA+ZfipRU5AGB8J3Sc9N5TIBbaWcYuelXhfs4sns9D8TxthDMDGwaaCN6+yiHEsfBf"
    "UIZNsMeN+/W6ANJ01hearroE4Zl2Ro3AYoO2B+V6cxTUaG5o7pns8tJxsU1eW6lI1ZU+YYwp"
    "8r8Vm9Ob3fxXWpKSJLzS9wP4WvxJHXC7pkADcVpmi3cACG5kYEW+SIYoL2hopdpCiVzhbCGU"
    "0jbEmz08QevxUJTKRCtWNyic9U4fN6pym3eDUQyTrq2657n99cHnwC7xyqu7obuhQY2vPPGh"
    "i8GbUmKrRy3Up8WBUOoT1+Nni7eGJsdjTPYV5lLE7tdmWQlyzA+dXgI79+bZ/davRipg6m0c"
    "7LT9tx2/Y+bMTF7880/E71o64hUdaZ3aF0hqgW3BaIbl3p8RI4RhWWwnyxg7YIONbnyfqUpq"
    "bcjTOVaxgS+p0nTbZZ6c9P6TGLGfd2eQQxtMzDRcTffuOUkAnYXZUXoNuwNDB9+qTgxFCkIs"
    "LTK80PMagJZpvhgTpM8k8asy4wvi2mZul4p42xC+1ufJENfwTgvAYcfH1dz7td8r6qnPYG5G"
    "7W5lXbP4W/Wb5YR1o+4oJM2R0ryGvQdczWsJpH6Rao3R+VMl6WbWtnY2ROsRu7GchPJTUKhE"
    "3lmDm6lNvw3kjTTCiD4jdDG1xz/u5rs79KDfpfZsE70xoRtJaAgGjYwv6FOnd2JYxZs72gQT"
    "k+gSjCU66ZfUKNN0s8COAnTAfSFzMvlKoZ+UY5oSQtUpCCbnGCAUunMdN/9TKEXRxsQ78SBc"
    "lwFMLmgbhu9A2W7e979xYgheyxDVSjpwqACl4B9FaN8PXgweOo9MvLML5uw1Jh3xZyRIAICh"
    "jo8wHYGglWAKwXHGkNtWtvv3XJE+Ie6YL8vwN1vw4XYR97Pr1ca6gOCxsMDPeHXbAq3IsTTf"
    "C53p+sF2tR+9tyXweTROpDnPwfhDl5KQojHg8FcvE/9hHGvkLl403R2yBR8Opm9wZxfMysFn"
    "Jn+IBWBOU/nNIKtmjDRHMwW+eVOXMElF/Dgq8BWY4JQapLg6sgiao7dtshVxrFBrQrz5mz/h"
    "H1GYpADA4iihF1rOnumf+JA/ve2GXJC7aRLc80eKX6LylkCQX/aoy+7Metzt2XI2bkvVkSuO"
    "hdnp0T5RNmzbfdcAIrkrv9OhlItrvhqfpWbcOX02KeCxTLF9FdPJ9Q8lTeVcim1980otrMby"
    "mW2Sb/cvq9ZUtVZvLUeztDzrMXH/vJKlf97DVLk4N79Z+c5KwqAav38hIEbKnJ1rb1Yf8i6E"
    "mFGrnFwV7DHEbi0Rcg4lzzv86IRGLPx8lMDIuQTI0ZhIuYgPut/rqBqklOTmoVrB+hj5nkrh"
    "LV62aWl7DGH8TsTm8jKax1TzsJZTYwm4jMXLZyUiJmYCLllX9HnGjs2F6lliLcXx6mgyvuRa"
    "Ps13BtbGZe2ar7aGjAYnt9KfVQfCPonTl53GcQuW8O17wZ3P44fE8S/czSOAr+Wgc9SVRFZJ"
    "YG0ZdvYbtVQOo3b+S0AYZ7BapZ52UHxkHynPi/ZGLKy1HjxXo3zXM9/3Xd34LwOMRsOzcnJn"
    "PXjq4+neKy0+wq2gofFC0y7ffFbcR1wCfzYhJu3xwU7+GLAt/deKjcKsdPARh9EGj8TC0WPa"
    "+xN4YvYxwcG/oTf23xc6zu93kgZjVw7iSs1Lmqf32MBEgtfRymS77JKFBA4TjZ3mtPpN7wli"
    "NNMlxPoI6HrCL/1NK97F0s1JL5tSascuGrD7m/Y3VmD2ahjG1KWuPeidtPHs6voFmdOS4GkN"
    "ZaaN+wv6S/SQSBrbRtRh7JtNQ+CWqljTXwtnmwDhxd2ip1iC4fsF0ZCHismSLdQ/bQSmBlYE"
    "xDaLL2zgWHDn7jMk4+ps2s3bugcCrN1bpvKGA3m4NVv5VHsRO2JFaQhI4urDhFe3Kfnv8/66"
    "HXvwsbebD47NrI5OHQmib8nrG5vsyvNKZ2FhGdfKAF/77Q0feKMzfjJFK2lXvZamndpsnf6Y"
    "HoxMl0/Z87w1Akub1/pr2bzNmyQWBr/MHNPQYWOfN83pAeitOn74mF4tOFOkPZsFYzVwb3kf"
    "I58hv0fTVp4/r2bfpK4ocm2ibEwGKLksdHDVydz274YHlOxzAF0vDZ9WydzbOhJNEonGpE4J"
    "7BqGuCODydmdmIHbdJhCD0nQ3ZS8YrmkV+2tRxUQ7GgigPTk9wVBiYDEnx++HOhGvhOk4Qqy"
    "YxINpXJq0xeT9gMLeLCRYQ5D2Ppkjul3wPP+JmgbgxMvi6z2veWnCi3s7K19AbsxJy/kVDZ1"
    "JCKCHQaNr+stsgbZHOaC3nuCUHkZPmDtv0LX1HIKKd6+XzzSr++xYfgxf4PWZ/Nwba0YldBc"
    "Sm2L3MnTVaKEIJEs9ViizEXtlg/5s9IqVSGlDNxt9/r2pw42tLNoV9KSzbmH/OGENDLi3cKN"
    "zkn5kpk+1AxJnTbkxQWAxBhnejBV1dia+j0ycU/CRyASwZ9u/LSJvG+xr978lRFwncH2+cLq"
    "7Xa1Hw8PhpjyqBad+I6Tks3V4z2tEVZPYZ5pckR1cNFiRMhgBIxUSE3AXSJHsv7Cjq2yfs0E"
    "yKf9Yd7rm2xsvQ9F/QdzVwnqxw53fJ67DLBimnN9zptxHBcrY+4y4voB4twnvfEHWutROS47"
    "qPwhX9le0O+Z5XYsNmEtICb8+LV0NGXgMnhWTmcty1M+RILlu5BJs7GD+JHJ7FeyUHEI5ObS"
    "mG+AyqBtXvoe9xdsyvEcBUN/Tz4r/65yqnhToVs2aBgmoEBqPLzxQY7HCdXmUt6v/y4snbaP"
    "83FajKAZMi/tNvuwi4MmSWwtr9bnmtald8bnASfazXEtNp8qj3ovfdglm7CHgWcMLciygvVM"
    "/w+QgjI5OM0HJkupJs5B6rCibAyWYLml+oa3lo56hV3FEYybHvt9w173Kyb4xHJrSCJ0S8tq"
    "+4ZXmgEQXgxapj+bMmXB0HqxMgLnwb/pLVf7k8S3uNDQTInDsx57GXs7U8blN8bk5ZPPbwa2"
    "RbsC6M+j4PritNh/2g7VLDBw4Z8zxWdKzqRaxs2frF3okJG6dfXR2/9SOqs+xmZbPdCdvaly"
    "cY7guv9frcHLAIW33iZztA1cRWvv84Nnr7txB24P1JRD3A4dYQO15bmton/jFXvdCG+uvY2O"
    "iuvSiUj88F/qBftvY+87S5iVEfYdNUuXO0YFzLysrT/kPxK992JGyIWz3MDEffE3OAlXjipK"
    "tN9wz9p5+MZ9D0H4qQiKxhlnFj/EtyqrZZ1+FRjhPmw+uaJsNEEymwG5ir1ufBptoWU0tG/M"
    "OZshtfF5P1y0gSPo8PkZ3hssCrGvP95Li7XwLHkuzpt4+b0WSp1z9/wZljPxT34rpnCkPM95"
    "ekvh92WZS7zgIQv0Bzrzq7TxcFel/x7HfP0O28IqAlJmqOfsldn7fF1zqF5uY4+Y5/fi3JOl"
    "LmvVjz7Oddx2rgHlEnqnfTDhoUZeGIlcInmH+u5l9qAuE8xJk/dwRcR4BU8G94S+RvQhMb/+"
    "+2YWbSa0uv4qKFoECJoqxStFHQY+vcX1V+3Zldf5d+4XfapR19R8+tTg0dM7nlsDX96k/Lh4"
    "7uzda1GX+vq7anxN73k/Mct4iwyceDnh0tu8U5eA2Hq2KNgrMNPaiqBzacBr4de5vxV+OQDi"
    "QhdGo2rLlaX1OIUO46wik0Yyrt5aTM53kwILfTs2S1J3BnfjePWNgxsJpbG2Z2shZc9EvZjT"
    "jNcNvuLHku55dISKqJPq1sVYmZvjqkl1I284nz8cd6n+NaW9q90wQv/XrKmyY76JaHCXRfz/"
    "wRG/65n3BuWxz+sXDVlbJCYF5iEqDPEEa731/Oe2z56IXr2wSriZ4pcX/fzW6ysp+f4DMzd/"
    "ipQrw8t9ZzQa4l8/+clrlIgeb65AwSAEepM+bP/jVTpsxDPAdtenhiu3rsReFFLA9yjs+T3R"
    "ywP2tQ5vDFmuhl1hvfBQSqlzhS/jvDXbC47dPzKrE0MJ8rzy0X4L1FtBauOtHqO04A3kp8A7"
    "m2CXBW8jaLLM5FpaQtK2h/rYZkeFCGKu2Pfqv5XirSF4wshS1eUR2k04c0NJy5+x6mFmBNIy"
    "35IgdSCpeCH8zIjOH1fskWHKVLHrVngKUa6Yo24PnpjWM4XRRpVHdYEQ8h1dWoyLuOgi848H"
    "+zxCDKaDR+XUQy2ydpF1KeLCMgZJMbvvNl85Z27C8FngjCZPHcYxnjRt7uVuy30EWdvwFj/x"
    "3/AIdSRdP4FN+1V//wxoCI8JaR0RqRY93oLaafMtNG0K+42dilYggFd/blOcI9j2+g80B5Q3"
    "MvbNtEk/zRSonX+J8SqOMa+a3mvq4rQdTp5pW7/bawRUPNME4UJ+3yV+Gj67yC4Gj9rOMsXK"
    "Fhg/4HPuM2HcHICL/D3t/Gx3Rnq+8grjYeIhuYeA4AHNy8O6F1Z7cTYnvJ3vU4ureY3wQtTN"
    "6V4YTb17cq3AVlkQXlb84zQqsBkaM9+dVBhQUgyEnqhMWiaW25DvEkSXSRdyFvqbiHWMZWYp"
    "9UIPQmjlmTmOzRsEQG+I+rE8YXdl5jKvXaCzNW1I6Iee8Xpy/SdWhH6uu4eZ0Eb1k9xM4oh0"
    "aq4zwPIIVLTFQdpxow6cx+8FeW/hszz8ypzxBl0xFVHKPMzFiOjb4w67behEB5/mw+oxVGN9"
    "85f6AGjU7nZPxV/XpVyx9SIJu8BMaDm6D9j5yeUjqLufBwLnZQJJd1StifUvFpx1JZs/+o4d"
    "9PUOyVb809mXPKlg7Wy9hBLxU506npMQ/gLKvVHOmDu8PlYxEKSl7RCsxh5ddpP8p7iWrl8U"
    "y68vPXKa1XKfqUXQeBvgBJZy/GE3NW1p07Ua3vMi4UYludC1gZeRUZrqizWiz7NT1Rzw3t94"
    "NFKlYvdGooYRta7a04oejnyCV0DRK1qWQp6X+fpKzbqHyUKnKak34d6DPuVaBC6UY5yQVPQ1"
    "sEewMLBTdHLnv+3zRT57N0ObjZAhmG98k7CYmYMDwuPwvKkev2tH77wT2WdAr66PBmMyomRG"
    "49CiolpDR6Lg5g8H7Ex6hkiF119tZiP629WDX6lX8G0yK1anKojcZhzkMs/RJsW/FsYDnNY7"
    "VzATDFgfq2+9DRsDkEtOlu+e3A5a5N2bFo/9Fv2zoufn9wAvTmJOdzg41AMmEhKxsxdnXTTe"
    "vfWSrAp8wFA/KrsUUSYmsJbx/3DoTx0P7KzolW0p9hzrkIlrmUZxnu//78bQS3jeD93GWXan"
    "LPEaKpSlpX16Eqbhh+iDHkhenKGFXh6RFwLQbQ3mN10qD3/Mjr6XozDF0Xl+GPLJ7qpCFGCt"
    "zWro9yfcHg+fsLHSL1KmVTj++s5IyzWueNTFmdy5KzuYdeHjH4cmEfUKarjynKau4+23dXIq"
    "a9EnHSS3JKEiT83f37IfyfN6PHaDE8aHYbOLKsEqV3sMcC2JwK9c4/+oescZ5UKvyK99Pipw"
    "ZfKgjQ8m0OVIwyEbKoMEFGsctIfwXx5ESWEJWpXfbf5oqO7OPW0dEupb+ObI/tzYdijeID26"
    "lh7wKQIwTeSEQVkUAvsenRSADaUfxTArYahFIdT7Hov9YyCiWMEfU1vcI2aTcRoovq3koz8z"
    "wawEJIkt/9QIa6lkUxce57sUdGeD5xaZDlqpyGG469xBBuHi1UrnuTkwxYSgNep60PwZVoE4"
    "tfvzGHsrlEvOqd/Br7Tfs79OfGwabem/AikOHfjQVvO4OWlOpxNeN4+bUhq6MTaKodM+8YDD"
    "jqOHSzpdHL8dE7XjBRL0vR4RvoX0QeVVjL8J9f6U4hLKk0152hZ/aGeevfdFQ4ynx8HsY/x8"
    "ccJNNYNNgZdA30eWprR/6FFV1wDzrrmuHtwN1r6YnpFVWu8iPyJXrCUeuLMQp/n2oQBA0U0R"
    "s0ZIssXb/IwLwMT5W/M0YQeMsuU7JCHsQjlBqGe1fBeLnbR1FvIosZwmTySCKadEFoHn90y7"
    "uDhKzLWKV63/6TYB0jUCXBuM0ByFPq8qr5YBfXjiSXe5nbomN8tZNW+AhIp7ENwvgaKIlNeA"
    "1D/SVyoPbu++wQ10LEl89xiKavffS7eVq/YcrIT9e99Xexb13LcqH7qUnpFwr2Sb1TFv+fDy"
    "TXRxAmwXbe5NCaod6g/wpIvJMRmCNJmth38DRuRulRxc17yrliyW8wV+64kBt6pond5+WXWB"
    "X13VtTxEAokKuErfLzVBiIBZK4BeMiUx5yaSJU7tC7Wtv9ZpGz/PpNtU0S+fCFvsOy9xqhzO"
    "qKE5ZhcxGIXAMOyspLxVtG8CvnVmFeTq4uteDZYOek2hvq8sJk317VXrCX4PEWxA7XBqccp3"
    "H7/+cDauJ+iv4qdD1kaJCBGUKdeYRVyUksfDQTWp9ZRSAUrozLLL2GaG43F7Qe7qMQJA2INh"
    "7Ba7QXEhBczadRayzL3vNKSJBU2JU/mo/UrAwHbVf1pYxU9sVFbZrlXBPeFF6x2J/2AUjyyb"
    "7IdFlf0FQGjKwUA0QC6BMgDtVqCkt77tkrb1qv+FNaO9e8UJGze10QRWHbrxGgXkuGbIPl/9"
    "Fn+EP/D204PVj5f7VQBxhaoN4+nbA4XGZaS+IXyy+KrNGQ0gJVeOxAALOn2x8qZqrDORvnMC"
    "Yz2g++fm800qXqzm5Rh7VvVKhMp7JYFxVZ0aLoiDiA2QdwjCqmzfi8LHSCNGkuNbFR2T+rJX"
    "Hw66fHI8V3+v+fwMoLGAFo7cp2mESceMta/aiV9pbfwVR2elgy/fmIIEW55UvCfTXXDX4VNn"
    "KiQ1IlvK9uKfUg25lEpNhImLg7rRC38lN81Ctnj9ue+Jtg+x7IneD1/uYbHa6U5OJ27GuRa2"
    "9oXHRpIMZMvNDk1/xWuUxUhYHS9PnpQn7cS4klpTRtc+i/HEeAv3ppfxjAkEizfeELDL8Txd"
    "V8UkUehfXTY9F+13UbWFGKW1gwasZ3/RMOKlug1FVhvy4HP+rwCcTqveZdlGed1zysV6jWHE"
    "7rypizcaOMsVFLPsSvR0JS+jVxgl8pBZsXZ+rhWU8dIMg3Kyu6BTwj7s7PUr1kVWyJ5Yzwfl"
    "0iogffBkE5DZ8FYbkUc6HXWqwe5KNH4C8EQqTYXZdDMClR5Ybe9TIwXgv0CL1JV+U9zImNIj"
    "pGEoDXzX2B4YdE3gedmjydCYnPnjwjSdMVaQ7FnEL9MalZUpniwi+XF6MLFWltFdNF0QZHyi"
    "7AhxvL7KX0nTfeYPY0X9yNubD5kJvXZ0ph5XIJG4yQKQDOVZXgiUOWhjNO/ZtYckEveMecIl"
    "bjUv92QzxnYTc9ftgOqNqx79/2CglNqFq19Iej9jRQ6QJUe+Xjx7S3dMutZzGVapsmFzRhVF"
    "Mj+yI7g5B+NPWjo4T2VIsiG7GWEkA1HIz81jEvHipA54cw7OJ5/lr5BUI9MiVpzDQvaMBRw+"
    "DbSZJbbtTqK03l5cvK7ice3UqRprh2rvuV6Xjg2aVzwWKXjXJ/nugYclIs6/kqimcWs2LuX8"
    "kB5fHkI1ozJB/2Y/M35RZe+itimHpbe/W89C87tIlsgK2/d721aktJVit3/5RMl1laZ/Q2s9"
    "qiwM1sXJ9LavakoSh38ty9KfSKm04v6zOCtK++cwQPhb+HwtsfnWaTsmYLRiLWk/Os9adC7P"
    "b7zCNyGxSzJETaKnBZfo7hgiFyRG8SQTwmivgq/mJPAduCd8EM8y22pNA9wNFbFCbYGPprW0"
    "jKS+YHtEnzoYTO/ORtECbcBrBbT440s3ZToo3kofV4XO92Zu3qD0ryFffLb2Y6nv/zFM/s78"
    "5oN5dSoZ4mDYJOqbiopxV3nBHBLSKJDhuv65a0v/SHtALxxdZuD2LLQJ5K8v2nUlo5fXrFF2"
    "UAmce/TwWJ+Z7Zm9+3DMZdJv+9ZImbVytSa3lqX/heF3gFnS1+IDKPWiIP2kdj9A3BCjlccl"
    "dXYVe6Dx88fc79csWp4pZZj6sDVjhG1VHL8KUcnoq/YabEk2QTqwJ/LJPWErSeUXYVp2JPKW"
    "UEuFnd8hemYX7Xhq0OfyRMAUOat1p+9xhfZ4DbF+eIrCCYqdkv1jcq7y63Oik5S4FeIu4fZx"
    "odk6+jPiO/0qZL7gi2jGSTGyGMfvUBvNGOSJF34VpAXwchzs/Vs/JCGXrvwcsfMbaeonf1ZA"
    "3adIfl6raykaX3dqDGDmgakcW6FhWw0tgfc6buP+tS0CP/rA7smu5m8FPKHl8vDgJUMsiWc2"
    "FWKy1uJKQlEKxQRJfhs+68881FYtG1QNd4wSvqNN35UTb+EN9HN/M2QKHMT77XvMO5uHiLxP"
    "9NXhJWLFBvyXA/czbF9Ak1vtQpH10+1gf7zNnkaVpdqo+ivoTcwD0DwCoyBW9W7HMlOuMChd"
    "9K34n7t6jlHke1O3n5XR++5kx0lTuio3BVUiHiv/S2HU2QmbWnjIZAvJbld2ZhrdAypp/wMd"
    "GMpkcAWHrGZRQ0uqIdS44zCtjQBopn9N1o9sDmBPFTUB9tSdkxn1JfxMq7Eb5jXl9xlqOV01"
    "iZhIyrW23kAd/6zNQC3lOq4uwPUny4wZ51pt28l8sIXvgItVCzJCtWLZaCitsf1MGnOVGHO8"
    "7B6ixXpC2To+07Dfu3MqnZ7i80BuMzxDe9mzdhNYp8OALNUF+LXRXG0x8WUaduAU0ExLXLFJ"
    "6s9N6JNJU8nKSsmFkZI1wdAcn1Wngh5Wj9Wnv3bzgTqnF1YVXD9u6v78+HihCnv5g36bg4V6"
    "jcSs0ewQM404VBVvuZSDo6fmvLBscpfhkpcZWdrWO0zxRSW/S3KBij2vhiXaMmOigDoPvlbd"
    "9l7Ds/FtxQJ7v1UCl9OtAZE8IblmpwuYZmhxhxg7qVulGkoxptyzDohYOxeziYdza7VLFqAq"
    "PXhWAEtN7QHf9ie1ltrCMZesHrddPQpksRIDkH6/Nf5IwbG9NGdnih68/Gr+oHefhwvml9uq"
    "ECpeWdEiwp+m/Uxj1XHRj1qd7BUbAvudLu78WYb5OtW4vjBy8FhjOW1+PS3XPjewJD/lnn+y"
    "0uEUf2D8oQkgqTmfv+DgWZHKA/m1cuBW31v+8cohaZAiIWI7fGzqisZu/0jWwkmvGLIWW9mD"
    "bVrdG9tD9crWnPnZjuFoZibKZ+WS88Z8qwv73KwgiiSdlwBadEle7Owc8rylQc0W+AAyRpZp"
    "v0S6idAcFkEML0yo/Gm1XHy0XRe8DP1MTndRgAqvF0metiCOnV1xKTxXz/901Hhfarcb8xZ/"
    "tCWOvXmvWUM+X8Foo4wX9V9c1ugueZU+WLUlZQRSkW9Xa3N3MC518GFYqOuiadBaUwnfiWdJ"
    "zl6EKzFRRlenTQvY6zpPRU5KH8xnUkxniA8FVb0o5EEY7l2jn7OcG89sCWzy4E9NavQKdjV8"
    "+1wvoJm7fCZCYLgBaI2excPb1Q5ENhLJj9BFEEl566SYrJfFE7VwprnN7yW5jJH/4jFGUtrM"
    "zJpQ68TkKscljMJJgHvmoc8HFneDUhakvGr+L9x/ngwgOlqwR2ma8ChpImFnAa+w6RnGfkHQ"
    "yTS+8caHU0wFOOTLDNhw8Dy/k/ILvEXEWaO3VpvtLtD4tkqdsNynkqN3rvY5MnhAsYkFuSOr"
    "8/R3HPPz6ZxdecUKe0tWq08ztAobwmsmOoxdExTaKn1M1V7P5K6B1lyQqvg8Ouedvur63nde"
    "XUdPTsOMSx6yBJK2dyWhLGsikDNe/MPiPd22jzauRTBFY+ARtLMnIwI80kzu0cSo2uZ35zty"
    "w2kbIlqPpUkdJK9jd2OOPzbTi790cfn4yy2ESEnu90P9fCShOTlx3mc/OPt1jQYvKW/EYDvO"
    "YyewWB2JWIbZJC2BxovENlU3ac5p/KBIyLAq9wUX7v4dl9tF/TpGs4IC1J+gNscfd8xIPWvs"
    "iSkojYyDn7H9vt70YfWvlakb/lUHjSR51AhqWy6GbsQxU2TA/+VlJYlCDqSlu0i6X1vh0pXS"
    "O0B+DjeQNmppDDDZufqmQq15EriKWUJ9fL2xt1JDE8ptPeLrkajkzVOQ8849ZJ+TTGdfq08i"
    "jQeK3TvLkBaF7dDvlS65P9nRs3lhtGztGKw7ijcl8+sm6W0jvoIelGh8QO4MNl0ushYLnOe0"
    "0DZ+7/7Hb035Cm0GfOC7DGkBR2CshrBxH9VGJ2CNISIcMU59SZ3f+iG/RupuQFmmxY6TqEfe"
    "+6jX36FCFdacW44xDvLL4NZmj9+5Qo0ekRZHVZKB6AUrxq0o2qr/8YOc4ECHtSg+CWiRhi+g"
    "eX3RTyB42/mJjzfqcL/TRwmISPwgZzFO9XHR07ZSsAVO3tHp8g5Woscdcg/WIWbRH8UDEH+G"
    "IUAspGAEIdc20HlPUulr67M97cWCnesKyR/lPrZdhCXw/U7w+hk1Lc+qZduI4qRtij3qcv0F"
    "6gr/ZTZ9R7N7HsC5NzI+/vU3Yp4faCx/BHRJuO+2fF8f6k31PasjdVIo+3Pef1EwNpz/Scjk"
    "81qBgOZvRlb3jWsM86Xmm6MZmcsSNJVFqq+9+dEufrDo6zRyPYCWvR8z1YFZAIE7P0I7lSnc"
    "k3MpIHllWardkiyT/WGUSEqt8bq/+PfBYf+P/TgH10UN1VsT/60wIsEV5P1z14Ht7cZg/Lpb"
    "Fwx/vLsWuIKPpsAkrbLevTdp/EGJIbF6qtcaS1xo5MonfHlzev3r5oU4BVjiil0e+7JfmwAy"
    "94Hcb8GEJSJEsjVvj/WA7JQX7sn2//acuiq7JvY3oNmBzIyp5Yfo2EGVdjhHb2aIcXx6g2fO"
    "+xxPv75sbf+Tfmgqj3ZUBrHL01ID3IbRwSowKtC3V/oO55arKz52wswnMEc+YvxLhVngY58p"
    "WHQ4LTZU1mJKsNdQTJU4cFBAENxw46zTWLWDR9TpGW+Za/evya0qU6xJhItDNyDuSyHt+yQJ"
    "630zNMmT/nHOd9E+WFf8zeSntPsmtR+9Ggu58h+DF0fp/FrbIUx76Ld0+nSpSXka+s1khJIb"
    "HeY4P5apWDOtBsjlxOh93u5OP24QxY8J+tgybQvkc5nJ96sZS9Moq3jFdeP1S5kQQG+bmL/K"
    "Ud4i6GhddCOVSUssbUmjxHnJeJlOkFjxMcU6+NeYCaz6VcK+4KnmvEoBpCN1tOz0U/hkhwvl"
    "if4xrSMUQAXV7xgFv1aFR8v3kpBjRZdjcGnZ3dacmuFM7YKaoatWGc1UwCLn4jWVYgMMNfu5"
    "+AH+NrCz8opN//6rCyT/Lrfo9JcP263W5lS1dpce7yL2nfU9ZIQd4kN4/YVQmx0hX6ZwVbBa"
    "2cGx77WU4k3EZNjJzRJLxUAXYKZDgz26Uhr4W8qcKAMKcNfFlemiroX0JI4HpgV08S0jppNY"
    "xN5TSxW5rRqH3p72CL7+bowEw8KU7s20k5+Cbi8SDYK9YBw92MxT5JLSiwbNnHwc8utEBkeo"
    "csfn/46VB5BfiP99qDz/xqdUzV86BvzIiVksqu272MC7O4DmgcqijWwdYZ947pkK98Z0+Z5X"
    "9fnNDFrghbbKd8t2DH29eu9Qqdu72vOfzO9cma0yeEZAiXurt4qUvtleo0bDZgW2sQJX8wue"
    "2dTTIR9SKX356NvbkeaNSqVeN1+dQdq2p0nUFtXi+VaapIjbU2cwt8b8L6lWzQFrlf3onmdd"
    "PVt6OkdS35joEME0DXio0lOk1JZNJ/3BaJMcFCIXOC9fBRY+WFEZO4d3OUmPGvNcFuLm0Oyc"
    "uXQ0tmzSKxO6ggkfaLmp065RL9vFyQxfPDt7gxqt9NElzkqLPfutBM5bt/ScPTy/++L9XHDn"
    "ts6E8SUGUvzYcBZf4ztRi8lcWDdXRr86dcAGP76vF1DLdZgocUavXb8nErduhPSZLPZJOkXf"
    "F0/DK1Qy0ypKXtSuso98AThlqyrHsLzyCL4T86ftnrbn5wYRMZL8va847Cu52m8ic4GGVmwe"
    "syvn7LTaKsAvEeciMpGtN2tvd1LHH2w9B7rX+c0SnSqb29ZnKhIKFqPnEJDSviuRR06IMnNp"
    "nS4Ee+ZxPVuK0UdTpSQc6k/TGIfX3+Py+f3JJtn1O/asPMO7VgfLLPPT3oNdyfMd0CVTdvnI"
    "4619xsU9ReA3Sv5Eg3gUfRBPYHS1cxjI9LZ4pjuwggadmojliYCck/aF3hrBM9fbymBfFvT+"
    "ap9io+FBWNPDi3gFeNVFYNgyko+JSn54KHPfW5R2LAE9Dj66j5U+ew9y9gW3Mk8uY2Foi+Rz"
    "3ZNd6zEYQBJlPcQzFc4Q3JRmbqyN3Dn4yxcn8eYfTcaGHLmc1TTfRWrdXhubSC9r3nWeMVRq"
    "2h5TgNnFiNJ+z+0KBlYvQdY2dBfH/LZMd+SD/TBRQeLnhOryeMvklwZUWcvux8NmPmCnP4dd"
    "C9w2bjJxFgIbmq+6GBuLhK4zyrCHtoYbP77VkooKWa9uTnD+OYCxbD8A6llVrvQu0YP6bo9o"
    "A1PKXRz6QCXLAjQTciI+W7chFzovGRhyghc7OWT/maPGgUjXYuojnre+3X/qNnJwVeuRWhyD"
    "QX9k7gYQBtjVomVl9UCGLZE7/on1H+76P2qyxN1clRG0RK44wt+x7tLsbLZfiNr5BkfXOH1u"
    "lExscdwrWFaRiamQNbyKuaT9MEMY7+w5s927PTUMD3Gel8D2VWVdW0d437Y1zEt94AvKmZho"
    "+Lst7dvgc34R4jF4v/YdpqTH/kETKQEpsPEwfgjkeoqVcnSrIZ1rvAOT/pGY5IY93kIaKDaY"
    "fp9QSyFINJ5jxMl9Qp49w9jFNhrUGaib3boTWI33MAWcLK7fgp8hy8TZUTxX7xkncNuKpKua"
    "7PII8qo+1fTx+MFcGqNRvJ33XmcrWjLFFwSitSliZm1E4PIq62TB9OcpL2TLmNwbo66YGWTZ"
    "gUtxmU2S48Wch1iljZuBDyzOoaosNzLMtWzOl3FtmFbXyjOo3Y4X/DWrM+TD5Ka+mHetftKQ"
    "4PdUeQXE6YWRWCANKz0ZIqIyQWPGbnW2NKWPkCoX9GE/eoLZy1x1RLV9Vf6EEHdQ2QDTz6jO"
    "mxVYYi/WJQX0LK/h/8MBMdWNMliBpr66mDw9wUGHDCRy9ozogtolxa/pBGSvOCc2U8U6t6fe"
    "8RF+X6DwGvy+/826fdxJqT79j0ebBKpeZQhJyJo+4Esfb4vlmeHi/MEz2vf+Nrzl5vzbbs1T"
    "j8MGs4SsIEp9cS4Dzav9j/rsXIvAacHlmLxV8QcjvhNT1kcHSXuRskNRu6cme3bidn+cLowq"
    "gm/jl5MiMRdeoNqIROe1W5upJn26POt57S5E1VDvO6ddudznwY/2XsO/N3OCa/WUR6CVrI9U"
    "f35Og7xDMLqOGst2lf6sJ/YszFhH6IOZwhometKRhFnUqFHX79IjTj7VrP1zf9JAAR6Rm8ru"
    "3KzJZhgKdoHOwxNfeTo9eW1kwD1w1O4mXaSemaYOLhDv5p+FHDKW6R8or9VYwWQnbTaxPuNn"
    "dlW1oKCkoiTTvOKkLq3G09PmaIWT/zuSNjSkWWn+p4e39Ypeap63jeUUlKHakOcsrpk3UOGO"
    "tE5h5WzLVcB/FfhPKp33pSqqMePk7kyexIhfaBRBT0DCMe0dNRyt4H9eSbXIvZ08c8zJPgr3"
    "vxizda3jomqXYhBU2hD6fcOf279b2FzkIns/68pZEorlf+2aZVBcQbvnBwgBggcPLglug+tA"
    "CBBCggbL4DC4OwwwuAQPCQ5DQrAkQBJcB3d3h8HdbbDZvO+trdp798Otrbr3rd3a/L50n+4+"
    "3XVOn/8jXae+0akHdUUcOBlZU70ZXLguElZIttvn6P81sJcf23DxZ9yaykEba1mg/J7vNNO3"
    "hshIsqGGFNnaqvifQ+v0989nqzinZXHaGHkV9InVeejlbdAwJd2fD5tvmxfCk6daQa5rSwlv"
    "1FUyBKpwF6uDSuE5TcLK5pcLaZipiu0zFjiLjPsulfRNS/q0B/6lob899DoR6ffsd0wyB5uX"
    "lEgqeFZTbPmxIfu14dImGarF1cpq6M7iEK/7Lvo7FeKLfA/a980jPBLaTpOSi7ZBTwva8+XP"
    "3D6oTJzzNYKMVwOunKt9kCoUYnlTZElj6sKbfVm75aAjJETpNQYd9s9aDj3+uuZH1Nd0UOt9"
    "7/NRo0DbLzefy83dQmpo0F4C9Adp9v1S4i2I7lhcPiOyzJolJbog55n0myXDgDD/fuqH72+n"
    "G25K7S07nFHuj7ihuaoIAMNlXhJb6oVFH8ZWK7vR2dZ308iF0cCz/k8XgMsrPFInoDExo+kp"
    "2ZOVQgS7hENNolcbhYQYHSletvuiapnKtdnAWEfLZSu6PkKH/ifwzFIDqyUz7x///u+LDPQb"
    "W+mFEeHegX/f1m+5Rui94v4155w61Xb+09UiCzRftyuSauQKA6fdqV5H1qect92gBiAviKyW"
    "PsE+ebwhR5qtsYbdHm+AUTjF1+IOPxGl13XC+298BeqQ/t9nQFPT6HmrM88FsdYycdYHMJ3l"
    "oV7YlIi6wT50p25ZohbJqIxnB2HU4VUeOCDn15ssvKwuqktyYzPfGnGMXt7Q8zdGMKob4vFF"
    "fD9JXNcaSz3avHzhw3zyBQdpdM/Z8HJxsr9UXdj+UvqlLf9gHA2ob29bAn3+1vvegzH3T3jP"
    "V15Ut4dx2Pr4qFS7sO4ZKHun2P0isQRKC0bLzc3sx+VsoQsRtTXb9vtr6UPT7YcWvuSUI31S"
    "mvUWX9/holpRU5FL/bzx+PxUdl8Wfs16OxjJMtscCSpTQwuQG37VDOWf5nVcE7wKO0JEHhyT"
    "XkVexi/Z916slIDwrGdNe+czM+uIocMbwy3268kLgUs+FcP5bhQKQ6s3PW8Xs/1b0rHixFbC"
    "47VGWr7Ep1wRVXWWZS8rVMYcnMBN87KGHi8Qx3vmyF4YMNTH0/uKrozKo732NCA+n33cL8py"
    "drHac5IPJEct2NZtPe/e2jX6iGos/h6XKdC3uMaTPnbx1iUx3tra3hRp9Mo6Xo/2iv3N74bj"
    "iPC717xV2OrW2xd8islYEUO+YYPIhWEUbqheH79dEFMPP5Qm7EDgZDgeydvcuCePXzYr+j96"
    "FY01u1qwkE5owg89G4xzEnowKhj1omywPGQ+VbxVfX+sNj1jAp/xF91eMs4dlsFpSyU0roqx"
    "n8HvGTJteFxRtgvN1LKTUByXsBDvxzDuSVfbeRq25WS11yUxBQUq8x86qDMyBy4PNUjL8rQB"
    "y67nn1p/a/RH5VxGeiyGzmYdqJiG4bR0trBP2143zw/NNqiiUDjORpkx7lDu+ri+i/Q494tj"
    "dMoJ1jFtaUyErfJNi9Rhr3yNI9rLAp4DIbjnvX98fXYK2hVqzqTibC80E2fxmsLoer2TkNyU"
    "Qu9ojx+bMlVzxud1AcWVxM2XV7W9WVSdJ3QIArU/Kb84vLK88XQ+5v+JgFQbSyxdeiI+1+de"
    "Dr9pCtr8aMTYOAYsY/C5LrU4v1j44KY3TmWLO86OGZi6Lrt2cfo59Mx3/Vyn9IVfi/M3MhcM"
    "jzr8HSyqkyMloX7/zjzY6/RheGycUuMBI5tQsj0W46PnOMLuQbwkr9vAyHgbPB9a1CLTgZ2H"
    "Y6HSdjkFCWwnbcznQePjJwH38SvsU6flugFJoMHb5QDk0vI0fm+z1fkDoWscDh7+q+N66/u0"
    "p4Gcg5nSPLrZKiqM6t4tS0WRjOMTA0uxSO8ecU1K5GWgU6Cp1cVDQ2mduaT4zP1CR1snskw1"
    "xVIzQRbiQ1X4EMlt8F5tr3DqWZYL6EdHfl/0Z4pb5o3c6fCUFZKl8XtmdkHbraKtimph7l9A"
    "dwU6vGyOslDv+TshNtTx3fPvCcbz5Z3GFr9c4Cst51j4d9Vi45zE49Mlbm8DbXfTfbv73agb"
    "CnUqSmobrE+4F63ple2uQn+aiGWjml7Ifhs4ZcXJoB3w6HabZbio3yPdhqj7X5P1qz9bMF3A"
    "dCsnL6v63NyPsNtT2+i5C5BcDLRgrRZsef1bUtYKVfL5O97US5Nwh5mfN+xnSeVkcwSIDqpS"
    "IuuVi3fZPznBuyWMRyi6rHuCPvwFWOCZT+dk+lnc2RhMVZQhj/9Sz6Beh1GStjt4j77Snb3o"
    "2MO5vi3y/MWpuc+V9u24f3tJV76acXdZO9E4YSAlkap479hwnO/+lJUmda9WLMxssLrDVwWu"
    "40DkJEcqK7BB60yBTuPc+OCCyIQ1NnJ7fb3tOZf91FeM/pzXZaTlVFG2WpW+pe0u1sg6y7t2"
    "YiDURevHQ9PU+quPbm56XTt+wbE7/NNLIxOmqdREz0gyONbuBF2qQNGYqUFiRnv+ZrXhkp0H"
    "iNSwC+3f2chxOwr5nmh6hGtQVpHuQiVVIysNoiWZatdJYL4t4O1zjT+AGQw0bFh8qxKs74vu"
    "kG0N+Ba15fn+TrpBZt6k9sCUXPcYPyfrGd3XrdU3juFn8z0mTH1WSeet2c/b9Af2WOys3lA7"
    "xruNOmb44zgWvtml9kuETmclpEl/0x34HZQeA18O2dlCNjCbbxY2QAhkBbPwTLeyaHJCrgcm"
    "7uCQr3sMmEvihWBsxWGOQMCcKXu5H1ad9YHZ7+ierFlZ4Ns1qs+MP2NDcoFty7Ad1uV658fX"
    "5cjTlSsemV6COv1kaFcLiJVURU8Kzi7NmLgrNA3bQmSClBjrBQEIIP498nmTPUNVT3/9iet9"
    "VFs2OC7HixFprUV8j58BOhDEmfpxIEXICBmcWxFq9YvjQbpfdF9X04FM252z6n5aeqChk/vn"
    "73rIXLykZangu0F6qw4FDU030pums9MPfYytiruVbnMjvG5VCaKtn7Oe2hVA0AwjF3mMAMSG"
    "0xJ39ULUbv0t/84PBrn9XQlgA3voAobXXJSZH6/Vr7o+zzaTsHsP6KlYC3zH4dCeRGiz94f8"
    "hsCli6t4W3wsePpSlvmkWIqB2JeK/0FrjPFrWV+tusto27e16nkxzEcPAwumZtXfTAR3as9a"
    "Icnic5BJnTUKAa0LV95OSnOWjVWliOBG/SruezsEbzsboS4xjPfay2u+F8P4WnTCUsQMwp6t"
    "1Y8pNXRoukiSscKQi+Pw5AyK2MjQZiO7/LVB0uEUT3bKtPSygDBzdeuogpO+k1ec+NLsnfW1"
    "amNuw9e8y+Xs8PM7rksjNLCTUfzjpQZb01X3Z/vvt3rJv9omeUYnveHUY1sYojRSehpLLOlP"
    "Tvd8g6tmfBjpnsnfFwUcqFySxb1xt9eNN6mQeI86boYwmrDSJZwM3I2gxHMjIwbQD+a8vV27"
    "UNsViFq5Vb22yIGhwCCGwgrtQP2LzgJ9hVdEo0skjfc7JReEwKsGqaf2aL/gc28PlXO6vTbw"
    "5Yy39uCv8ruWHDZi5U2zpY8WrSbQBCXeocWPt5zJQ/KF0n4lJ/mLivEh3sUn70VesgYU05v2"
    "3wfi+UvG5onRvjgWhNKP73b65DluYHiuNsbIqp/CHsUKA4zKXhRkiQwH/oCg5xvJiCIWx6NM"
    "sALv7r/ZpW4iHR66I/taOuC5/Jt2lHonvjvLqsOBlt8W8gTaJp12zxdo7MUxaDgdgER3JCup"
    "FNYBhL7NvSIHGtcsSwO68au0LofE+a8jM1MWqVeiksrAXm0qyKVhlFOcucr3kqqIMphYVUHT"
    "2kacLGrDrftuMW6zljUS7T3sXQHfUCu4NzvcSNvPzfrhORRCu1Cy15YIUvSeXMI71A2MP60I"
    "yMoEUtU8REvMfXvnRbEoJ74tyxexQ7K2i59M3PephVNCmj5U5uzRCY0dPVz9kfcvSK+1crJ5"
    "OiIi5aBb59SjuXTzTdVs2FpXk608WUPywlJSXLiZ9bQPbnn0NaPJcrWzU3g/MvuDiB38S8y7"
    "BUSyKy7Xs9ubtNTArgBqpDDooNinD/8raad1GWMXEo5pzCPl/J2IsO/Gn56WQywN+610+Ptr"
    "HpNi+6I9+EpQlsMKAT3fjP4trDZqchn1nFUiuLa6JmCob6ZRVrRWdrOsfOug8e0JdOOhht/X"
    "s/Vua1zj+YO5pOvqHTWLja4CMYHs/XcIl+VD/72Pl7WMYlCz8gvBK+nyAjsq7q0h0PrCWU83"
    "LYIKXmbY0+H7WblEwUOGoSHo6lWpNUz2/EPXjcyvkHtdLAbgO6yeLg3Q2B6SPNoETUDEhgR3"
    "7n+S3Jy5z/cX4tgrV7wH7uesfp9tesxItE0M9hgiehG7fve04DYc+d1EZaG3Zsujo3C7ZJ+1"
    "TDITMUrtOcksfTAgTx+pGohM7dqdy/IkPwO0Ksws8/J9iKgh8OEz8iEofZVQXO7rjHTfl9C1"
    "uPp4WymwsE1IieNmReftdEIpjOfQ5fLle2zCjY2MBwwibdoITVizY54E3bsfR0x8bAJfl915"
    "Ut/nLOyeMu05+Et33gpcKMIXL3+2nWFIrYKla2EHRM8iTayjty7m0uE8xzk1S00ounsDBGx2"
    "C53xfhfSW7J6sHBF5yF8u0qO3utus9VWXQF8aIquSBV0bM1tmG1hQ6qGLnY2USwaLGcXs2x2"
    "EfYLtzFB409CUVy0Jcb1DIRFerhv+LR4RjMj9g4nSAqza3CerTrrflBpajkFRyxv6k255mgc"
    "WqvtWzW73fnKCN3NX87xPJk5K0flp5cnrujsReeZNEcGDFMz9oiF3IKbh30Cb7G5HfOgLKOD"
    "xbyuIxVSG6uHoM5jJcmi4Bx37Aal06YmPvqoPcEta7ceK2j5UcfKQNexVPZF417Hcr3LcPUy"
    "Twe5L04TR8NnGGzIWkTfAT/70wHSQG6m53Z94+4ltNA10FF4LJYY4lt0d5q9It7r6E8GUw13"
    "KPnWOGkn2gdHFvgkw5yONrGq0YRvL3O9Ho2UdU40PnS2HygvdHB6FBh6/PDcvG9eAA3odAGD"
    "qeNpN+qmVpms6fcHg7iRR3BGdSclWA10kbVgEX+hlamzovdD5mD1YYCMRrU5OTLpif1xHh0o"
    "1AjVDaOF8dLfyuxKOc09VJs5avrE0OG9G1uNAE9ebav76TYq1y+d0wbYOs9dyaGD3041OO9x"
    "nq+gAsDyQ/yyyFPFobGR1gbRHkBjtR+XJPqd8Z7P0MID4O2EkrNOwxjnR/ddDV6u28y5dpPW"
    "aedPTjfilWawb2qXI/ZgXXSdypQF6eWJiNoc9F75U2Fs8YDabyTV0tZK8Il2TL30zg6RjIlN"
    "36G3r7SrBKOt0J+Y/Quc8yem/TfSANEk1S9wp3efrug169ciX80IgDPEeHHOjbTAtXfINkHJ"
    "fa+uegp9NztynLZrdLcfnxu3AoJnkdVY/fnro2usx7CWPix24+NHFc6kCz+W49xrq42m2hOd"
    "b/uekGsX8t4wo82v/c6xZmQuhTGH9zhM4KaSw8Z5PQtZNYernhtf8Fb3MWa7Vbt3pHfmohdH"
    "rtmuKvuvYz5S3JfY3CTMzCmh8/e8jRXWdt3xUAcJ+psfkjDNG4N8jLJCatpYr+BwJcmdzKoO"
    "/GOncPgn9Wk7hpOsL/fYarYbj8QEu168wziNMVE/oycKJpo9YT1oSU57lnmyRMymgFpNXso7"
    "DMuCM0TfzaAaJcC/E8ygQfLRGG/3/YQDOsegfKA0oub0DPVhYmp6pYT2dZBhwrOcQbrA7Vpr"
    "SQaTlsol6wy/vi6xlva7GijAECTjPnjomelsD6iivp9EZ0ssIf2wcqYW6o6XypI/bwTUlEnv"
    "BUNpnQzGG9clpBrtp9A8W6jzGBQXXwfckELORjWRNkTtVSB025h50cqDXZvPrrpP1dnAkMpP"
    "JiwN+g1Hk+9FB9Uv6guP4RzsRsbcG1/u/og2iZjGgIfVnhXeBS2egegmrDW1GqoGmXicF1JE"
    "3uDXjDA/lObZKtsIZVAg2ocoiGw4oWcI0ICFGYgXhDNYqfZN3dZudghbrUncvaYlKehQDuIW"
    "Deo78uwyvVcWaWzS9HjYehfiGERlfXpomvCMvcIRyykOQp0JOPNx8B1ppHJtWa0ef4XqsUvn"
    "uJUA35r5zAbU+9Ud69IJnk8ndQUQDC3r8xm134i5hSA6G0lIa+RrhrNgkRVwkzHrgdenXIfH"
    "QntLHYcpl88YQQRR6EF6AiLzmT6Bcm1wHc43tcOgJgZwu4Lrbq0ReR5796q9JOTaVKKePEFT"
    "Ze2wIbUfaQeSCTwEEZo+zo9WET3MWRBi/yUR9klPH0zR5sKl66q7zib4FUK3T5FS0Gd7jpdy"
    "IPUDJXnn4kdhK2g4ZJ1xO4HeR0dycb0jHpxehmywrCVwOG89CYl3/nZIH57AaKc+unGgV9Tw"
    "PsM7Edjf5dwYd/x4d/gpH3iMUc+tfav5cyrw0boGDkNYbgnNTpPAOGVurY6zUVn9+ZQ8FZGn"
    "t3GR/bXGZtuQJUZvRMhqoX6tpOa0ux2rsWmj8c52luerVN2xYggykbZLLTFUrV4skWY0iZn9"
    "cjDDaiw6Eia+zjPuRUu8VRXnNm/z9ddOkKI0DtzS9CtSgjopyvGS6kl8pcwVtJSmrkDtoH6E"
    "MVbJo83e0F6gDX2kSHuJSoYXlJpsnDryyOAOnaHPWGeGDCYJaWj9dx7EhTkvHeKsZqafqqX6"
    "Gmy0oRb1JiTgB7Li5MhLrGcmnE9GYuZKj9PsH10HwnTeTXEXmUoNrLG0uH3BUlRmojxcVA30"
    "e4AEYYkHXTDtqTLGUhb6tKM01WKQVQxJgfcpl65x0Mn7BI88KLCiOkcqTCINoVmvg25MtRYn"
    "ryexUD7abG0VWa1oClX7EacksDfZJ65cc/xD4vxYCC5DY8imarNQaSTrzgK9mIxA7SoALWJC"
    "VZKp2m5MphzndsPnrMgJP5Rc/ThJ6MAb8neaNBQtfJNwftsGyItcNHRFNPXb1+Yl+p39aron"
    "0xjrO6TzYsjJvneveCObt1cXTstfxW3IJKZvTzRuVLo+NgJYHTW4ulq5e1yMM32B9PzofWNe"
    "4/hMHk21/tz4ue8obEf2qZgTi1ECo+nddgNM5qBstU6MVdfliW5Ty6SFs2jftUt6wJasj/yu"
    "mOeCdVfIvWSgqKfj+teApq0AyTfKvxF+aM5T6fX+0okjZTCHs/uKz2/9JYvroeO5PsULMdnS"
    "z24NjsYXznjV2mXlJmHswUgwqRQQZwbsK9LTJnaxeq36zMdqW9dnVDAnxjjFyD9/wXZvNu9s"
    "lh1LM1/5Mn4pOZvSDT5gZkgK7co/VcpbGXy0SK5XgIA7vSy/uTSQckMd9/psgTXZj8qCnCe+"
    "Lvle596pDzHUKvp6JJsZMsSUpbY0ux1lmnbJ8HxpC48i2P2ITstSvmXaftK2OA1Sp3s1pEHk"
    "JCbgpieRmjS3aby9n84QO7x6s1OcNeXObrd9AEbhlJYon0UzspScW+bf8H0UEnu+Lx0zMIdL"
    "sDa3NwNJO53rFEtvX83u8ZUpR5VmZSj5KD8FzkYTXYbmuDqI0sVH+Ys7+J3QdYmsGwR2Lyz8"
    "WkDcD0lAA3BgUsQlv/iWD7OQsB0vb7ZzLEMpP+nTOUjg3hiowda5y3mg6jvh1STbRWVy207N"
    "dByIhNVlbztoXLD1THU9yBFyw+W51EklnnGwb70jFE8kfRKR2otJU59wAN8asYnxqA15vYCi"
    "8tsiLnCaG7OltWTkzWmUOzxdYWz1Q/OP9aWUHQpkmcjREYQi9p6dRUkeMla/TGyzFaILvDfp"
    "n714mYVzBpz0v9fJAt15zAz8BiJe/X5Oe6aY21GYmfzl8TYbfJ7hvkPYX0YaH5YgTXA/ND7P"
    "/gItwjskVhMGqvow/wht+Ybv4OswFruzvXmVsc/ocZPXQ8a9/fo1LMcB8eA5OnoReJ0zRQfB"
    "HNNiAhbg38DgqOS/M8XByaYFWPHXKbrYjGCxuITR64DfJWGpAFSbdGxYrPa0cJNey7en5nqc"
    "HuN39aq6qrfyipCSvKbFy9Ai+T50UT3vmtKy4kx6Nd56M3v/jDMNkAOoB6wMB/l8fUb0Jupl"
    "CPxi/9Zsciz/ZmZJTPWq6yQ1ozGBF00Hq86CGcsOjPJA4MQZfA080G+POS/QeoMVhdZFRSkX"
    "P8QBugDdB7SPKaIwTBVWMNM52mOscB/RUVv/pmH/UsmTYL3hJXl66rMXfU81ULm/e+JUTxVg"
    "Qn+9M3tqVQXzdofFnPTPo9Htn6WzL5vW951e8m1WycZLexd0O0hISHwq+hUcFiTCqplF8+E3"
    "DYnr8Epe4qn8S41Y83m/7AsQzdVzVFFtMr3CoSeqHuiSAiJsa62ZQpBcaGsI7EGlZlxl8xd3"
    "QVshXlIzfWrQGRw0AQVWgPstTLY6WXDQOBI9Hik1Y+RXsNN4cH0dY5wafHq7vkw87aWF/f7L"
    "1rkBF6VS5R02VW13dDsL+wseQVW6zij/aDUCfWxzmzS8rx323I32Slx2hnKNz17ES5J7/CxC"
    "8FzZYLJfJfphA0eZA1p1dj9zuUJeaWs2FsRGgqkfwUb56p+nsd6/Pa0VxHrfRTeh89vrge0r"
    "2q8BHtK2P4v1+cDe/LbBwp7sBzp12bXJE74Q0mNFDlv6nq9mKw8v8lWzpNRuE5ezujnDklhd"
    "lUR9cpErNua4VOm7XUWWxZ1rzfEvMTvDv/NiKjDjZWRpcPtqdZvm5r/F0mDhUHGwKQzfe9by"
    "Ri/rVJMwNZRu87t6z4YYwtE7ElzpOn9Up/3r67feQwIx365xUJWf3kybZwe9fKNW8HzFRMqs"
    "2EBpXej2p5JS1h0+aIfWhKNqme7so5WNb+Syg8PZFTit/PWs7pxpBRxvpl9GaQ1xhu4mfWQv"
    "3ngCVMFQeKq2Tt4ihDQOUUUEAr/L6iyP92HxO/9Y5sl/p0cu0FHHN24in0WNTBE9z2H98YNX"
    "pCVjkFpc3fqMpAgLyCSH+Zwa752v/YMH96NkQ0wcBQ+6KDfEuiM0qqVRrhhxFKFKSQwxOvSU"
    "tHKwlVi+90KiDM25R89twzEk6SkFgiS7kLm/RFrhS6z3Lz9iezE8Yaac0X9wXzVNcu1uGDQS"
    "BYhQFNKWI2ioesRRtthIGpc+zWPD1sqnEYuiAZ5C8vV1dgzonr+PfLgJsuoA/OVfjLOFpbkH"
    "n4ubswXE3d1EgN+SX0jUykrIShwoYWllYSEiZAUREjSXkIAIiIqLCEhImFv8n68h8AdRYeF/"
    "ln/4j6UIUFT0f9b/rV1QRFRABMAk8K94AZ7uHmZuf5b//3T//+HyALgO0oBHQUwMwkzzyURt"
    "0a8HKhEEWP3yVCqP60RgYu715A+7qAxb205O377/xP7pCPDBIbDWwa+jhTzGFrd2DGMMYwJj"
    "nbW9Qm/2+fHLECO1T+t7EB+OL+WAhz59rE/88Sd3Jey3XESVqthDmZmDVcD7xLbvxq3HD86s"
    "KRL2U9PrsaPibhPje7LdlBHYtpEBNRwdmmnrB0KfNOo5Ywe1SUamf2a9B3eJdh5gZmw99xbP"
    "SqF4Twlu8vv4I3Uj+Ftty6tycY2dXUEYT9UWFQN0VCWmVLEO9Wr+B33+RKw6hsFOD2n87Esv"
    "x2TelsEfNTLS3R90hbiSUK9/E9wo3Bh/+vEe9PzxzNtQxXyoOs8tuNickmXMT40ViV9lJPOZ"
    "4sMFZyKchm3jR1yBX+R+AV2LFIwjaXtvNmpX1EhGSpUnmPGx070hORwd7NIKKX67L1G072iP"
    "rHqYh1Szlb93f3WBDT7JOVLtA2UdWffRAonGs2kpPEdm2CRUQAERiwMXu58MX8IVl36wOoii"
    "LA1+wFxKHGgVwAniE9vqUr+JK61X03MgvSJiMHBU8gyvBYX6DaHgJ/fxoobY6aypn3VnsnmP"
    "5nW1CKYSWNlvN4gcaS/iZoKINS6tgjV4n5lP6Ac29JfqmPJiL7s7H43MlScm3DUyr2P59BiC"
    "wGsX6sMjqlJAEQJ61cCsIgUlkY88oY0zTXyWjFTmH0io6s1ZiFaiC3PwuQf4nYLFczPH8TmQ"
    "37437/gwJfMnPKX5Xh4o7NOaufQpRSJwh8k2VC8MpPW69fXyAM70rt71Is5rMFlUkXRzxejY"
    "t36J4GeJxjbPz+CtV0dcIFFi/9E6OlEogM+QPjrZtUBRdSXNwi++uXkPN/f1SFKw1qDIzDXO"
    "CbARMykx06XvKCzf2jA4ShtHSHwxxZxAWOft4oEgD/Qp3n1DpNEulCZvM4sZ0JMLDoMW9fd6"
    "rawUVwYLDx3qbl98/rLJ+J5TBieR8+aU2zaPU+t6OR4ciRkg8x7volH+VUJIgP8Iry68Xb8g"
    "jwc3A+a1JVuY3vWGam1Pnphx6QEFk1P0+obiJJN3NOMi8Q/MMUO+2QvT2DmqkDxSB7MeMhht"
    "xYqlXuWhr34RM2TCUM31rI8aWPtBAJ5QRe8o/1Of/be9chOXJK0epR/qibo/kOrLkPu3PswM"
    "ulq53O5zzso6VJnSuLcT5tEYzc9A97wJPAOy2n5DQpeW17RCxLw4foXyCbylEtdMUjld2IRz"
    "lhxBjOWTmwnL4r70XcqgHw1HWjml88RYY8ZrJBvcZSkbYqJ0iHLyVTEFB0Q1WefqgayYRjb1"
    "ZvvKungSp/GbV2N9C0/9kqZjJF0I9qykoccf3r2nDVmdyyMyvl/XIyirn5tIeuKRyll9O03C"
    "vsyZR1aewisnmvN4nTWcVDwnZOIkmF+9PnHrvVRS+5g6F5Y0ZeWLEmERJbrtoEWl7y4SZcVy"
    "cyq/W/2BmOmNWFbfwRjRe3Q8rasCpTIMVcuKtV2nI4wWhfdaDqcujrGnxlRFhTF+d+8KKqsd"
    "kgzZhC+E+BC3isFPUoEU0PdAxXrcOfqriLBsNO5p00D6AEyVO6AcTx10cT6Rd5osdnWM/GTJ"
    "dPKMNL9t+tFTqk4D1FQOdPrH+N1E3AmCRdcf40eJmswa1+rHjdpquZnwDw/qcIfl6EXMvVYX"
    "NAdDvYhuOx9vLemHXdOTfmUImToO1fAcyYhe3MRaYAV1194e0oyWLT9DZlYU9Ne/salOYU3w"
    "ei5z/djdmlhOboF25Jljoev8YTMQRoUj88ZuZj3d/5stNZI0QZFjPSYaCu7/OkAqc96sWqH9"
    "5Agr0ZUMk/uMRIqukRm0B+bmdM/6wGEUKtRMVvK+ibtoI5+c+qoYKAA3fZEh1k2zLEYXONlf"
    "f2dUNq8ncpOpoy2YfditYT1TfFT3jgHmxmz1XXTQ9KHsZ5OXMeXecVuBm1FqcemVedC0pNvK"
    "EWYMS3rAC/fSlSwQs9GKiJrtE4yM5qEzZs8FvZyOlBSptz3rk/tCbtQWXFQjuBuCCpr0sWsq"
    "79+nr9vLDtV0LhEOUUB0yzMkh83MuQ7WX80r3cwGCLrwXLF35A4pvM5wD8+m1Ca6InbMkG1z"
    "tX02ZCZxwK0v9HxE0vTJiPoJi78cw+97io4Aenqj1W6u/AALleIDQa0JSKuNWnv/XkpfJfdc"
    "Tct+JY3PDT5n1u4LmtPflrKGVPbQXeoJ74iSq+a8vv2oF32VAjUHFb/5799lriGaEiCHWATX"
    "la+83e1qT6BF24Rt8eCRt5i1L7ExAzfCUGztRoF5xVsy+jo+vFyPHdvtPvp/Cx/E70YGcq2n"
    "iJVajegY+4ruUFMqZ9z66WQyMnhlthS2n0m/1himwZioIlzUU51tbbK1e7LJalaFDvtYlS4o"
    "Dztiu42CJPpxBUUsdBA4OI12rtXfNxh/eBmS/pyNaumxHOqDvWRpWsiWxDqmGF3NuOLEY0/r"
    "+JZLO6OrY6csImBX3h31FWrPZqHNuI7RytNPJ81ZW765QrP75cnMCL7TZ9vz4Drc28lg4Xet"
    "JDhdJKFD3NStjREGzGiRkKIBm9sAB92EUKqsaQseoLKkwsrLwMQHAAwA4B+ZKf2/z0x9HxJS"
    "AyrYARgsgP88TCMiBeBg42A+JsQhA2BgU2MQYeFhUGEQkWER4mOYm3lY2Jj8CXw83PkcIWZO"
    "/Hx+Zm5uZr4CLma2bnwCfAKCbmaO7nyWECd3CJ+5rZm7PcTNCeIAcTSHWPJ5mJk7QP6Mcbcw"
    "84C4CBRg6BVh0H/FIC7CSCf+iVGE8QujBOMLBumfZ4CyWNh4Otm7s0iChYSMeFgsnB1d3P6E"
    "mc5uLJJQFltLFkkWP3cPSxYeFgeIF8SBRVIwgIfF0tbxz7K2zk4m7hAXMzczDxa+PwMsPXxd"
    "IH/GS9sK/7mysnVwMPEyc/D80+Tk6eDgAXH7M6kl5M+8LAp/+t1tzEysnN0c/9wsCQz4Z4gD"
    "8MQEjCqT0jTbE82BeXBKWHmUwnR1dHQmprwOl9efArG9D4oeFN4W4yKkR2lghsedQjraFDlF"
    "BBO5z/01MQ7otOhlizFT59364XqYGICFxHAOYR4Rf0/BzwCA5uXPw62BIaz10sUpTHmph0Pq"
    "PTei5oJ/dk1EEChtJSwoKsAjxmMlLo8NMPdrVjSOvQA9AWlnxv/qQPCOO6HcI88RxgDeEa7m"
    "ZdAV+wjw1QwSQabd2KXrd4qY/w16mXd9A1KlcChLEUMjrGPZ96PfIBGPAPRGHPQtoImb3uvZ"
    "kDEEwemc8eb4HsJlaeJXCe8ZYq3Pc0zYBY14vvxAi6prFCS7mb4xyDwIcui4SMd2RIOEv7c8"
    "O/qyDXJqGq7RKppHSB1LJQvP7CKqn66WVWsPg0R4xM2tHJzNPARFpW3lAQARuvklzD/foeC/"
    "5Yp0Mo8fPBA9arcPx6yibt0DjAB2UthBfHm/zHM5Rs1+/W5bwSpSzxrJE+/rZCV4xP9RlyZ3"
    "zqwF48ydjugJLeuWNpM5cbSB6eZnzXYWqpigJconzwPi8X2EWYJ+svWTY2KVlWD2fvd2fgFe"
    "dUsG/lSZ91eIeU0TrPfJj5Lq1fGXWTEAyd+87b8v/xM1F4aYiYhZWAoCIeYWYuZWFiJmluIS"
    "olaCIiJAoLDIf3n+JyAiKvK/5X9CwL/537+Cf7gZT4x/52Z2Hgw8AlCSSvFoRGdiyaHTBIW0"
    "4wIibOyH/G7Q8J53oymZxRwvopgZRqpxstqLaocZjrl/YQgC+AFcAGlOPT+LtRp2hanx0Uik"
    "jeHu7498nU/7Ib2eC7Mkit9oKTgIKHEe4D/YwOUAYGZhdOEdCsieqn13KqDUUXEmJMJpg+pt"
    "KCbluE5jJZvSiraIEoQ46od1eOZb0Th6JrK+h0z5b6qWYn8AqjnD2nuWZureXnld1nnwOtno"
    "/mLXJm2yzfHuoUxxjqwUJBY8GS9ZI1d58gIoEt4ZJZ1gO+rDpLlWS8e0/9m2YSrfRkRedbua"
    "/zYb+FVHu1TrISeTKSaNUIu71mpwi6++yJOflExRwXW9PcSS3ykpO+SQ7dvC/zj3ask9ejXy"
    "PhxbYHizhtxDjfCxVctgG/lHPTA4KNwtXlue9Sldangr6VG5zteGHSgrnz2QRr89eM6gh+Cx"
    "Pvyt0oMHwZ+hjmLM/1frX8JKFGImbGYhZgmRgFgBgRDRP5oUFrMA/oksxMxExf7r9S8mCvyP"
    "+hcREP6r/3+V/k/+vf6VsCuJAJ2UBgoCzplYLRlTkSIfQzPUrdU5YJ7jPUBTSYDiPZoRzNLD"
    "5ziqy/+K5fHHUhCSuHi/ZHlmdrbbgXKAQtveAzVo37/MqvVQHiAHeAFgaRrKQVanWb+CxkJv"
    "FgIeX7zXTKif4uhHlYiPl9y7yt0aE38Wl4TFt84INSkZePEArOQKmp+yEnbbtLz+VFTbTl1e"
    "PBh4B/X3NO5YcNfZVdEaqTLxmyuvjFXIqNIFh12cC9zfuBpPjoV0ncrTJku6fKx8+ZHpazTB"
    "UzyaXhLgWSIGRwpEs/vI9JnAr/4ECprR6LiHrSpZzdTWLh+nmbaHBweNnOv9w6BVoQUBJvUM"
    "TfASbKlZ4nf8RpOTJdawb0W2aJwPlUQibyGXexGerzW6RKleqxVdO3xRw259TiGOmQEnJKR9"
    "90LC1+elq4FL2itqpkQXJkUlatsjDEW56eDmB32hLErYBJlkSXiAp0AlmzBOKi56bH7DZo5i"
    "XK5/2h353T92x5VBVxGrABvXIrfU7SR08BF+jOCwlGsKZYcBbYKphk++zafwDuqtzZq3HmpP"
    "2KxasiI5o/QYMoMYYohyZbqwyeNwXdKIhBTNl62/v/SduFQynDSNqozCqi7/QMP2U7Y4NooU"
    "UwFjHaNR+T/Tv5mohYiomIUFRMAcKCEoZgaECFiZi5kL/amImJlZAf/r9Q/8Y1T+g/7FhP+e"
    "//7L9F8N+F/1z9Sx/gAQ8oqFJahwAENI4JIfvTDJlpSf7yMD7n4fJ6jNdP2ecjrjmsnXDhyN"
    "4c8OLmQKqD0aIow3ebPrUzll/sQ4/RPhO1VOELsGdteukMc16nhwoDA2Q3v+Y/FZMkkzv6PH"
    "nbQIY7z6Du6tpNVCl+FJaBATjo+uTf8HOk1q/Ij5gTbSYa2ZluwBGxVJMkDsF1xsACt+bmvi"
    "0+Ruu8XUES2rSZNa17+B+3+T/3c0c7K1grh78P2z479mjf9M/8LCgv9B/0IiIqJ/9f+v0b8k"
    "F/O/9/8CAF5cgFWilKCLo+StxZWaABGKYflLhQzVL2iH5g/s3ork4sn0OqYvaV9fu/VVXHT6"
    "yVMQ2+YuvnCiEQSwA54BNL97d+3foV9ILB54xb8vTmFTeYxpEasz+Q7/vQAzPR2+tS31Wx5L"
    "B2A2DrEyspk5hHnMMF4HBH9c55/NFVkG/7D7obaxZj99fS2wblOWe1J8IWt34/rrAOiwMjvM"
    "rWoqguy7wyHRJUp0PoK/VPLrO/ubb6co7q0354drysVNVLsnIw5ARtIPxMS4EYoKLxL6lMt7"
    "hGPZXtCSYWNhUnLIYeYqcJo9I1H2cH0uh6GpX8FFGi5Pkb2AgQuQe1hjls+piZlYG9vx8lFa"
    "GHYvt8TCh78m4i9/+ctf/vKXv/zlL3/5y1/+8pe//OUv/w/zPwCIQ1qX")


if __name__ == "__main__":
    sys.exit(main())
