"""Command line of the port: ``python -m rcvpose_tpu_torch.cli`` (console
script ``rcvpose-tpu-torch``), the counterpart of ``rcvpose_tpu.cli``.

The parser has the JAX CLI's flags and defaults, so one command line
configures either package. The modes: ``train`` (datasets on disk ->
``BatchLoader`` -> ``Trainer.fit`` -> ``Checkpointer``, ``--resume_train``
from ``model_best``), ``test`` (the LM, LMO and YCB evaluators), ``serve``
(``serve.run_serve``), ``gen-labels``, ``export-torch`` and
``check-data``. Each runs on the CUDA card; the Python entry points take
``device="cpu"`` for the CPU (the tests pass it), and the command line
has no such flag.

``--distributed`` under torchrun (``torchrun --nproc_per_node N -m
rcvpose_tpu_torch.cli --distributed ...``) makes one process per card:
``train`` then takes the JAX package's global-batch step over every
process (``--batch_size`` per process) and ``test`` sweeps a shard of the
frames in each process. NCCL on the card, gloo on the CPU;
``RCVPOSE_DIST_BACKEND`` names another (gloo for several ranks on one
card, which NCCL refuses).

``--mode benchmark`` runs the port's own benchmark
(``rcvpose_tpu_torch.bench``, the counterpart of the JAX mode's
``bench.py``). ``--compile_cache_dir`` names the directory the port's
kernel libraries build into and load from (``utils.enable_compile_cache``;
default ``rcvpose_tpu_torch/_build/``), as it names the JAX package's XLA
cache. ``RCVPOSE_PALLAS_CONV=on``
trains with the decoder convs on K3/K4 (``build_model(conv_kernel=True)``),
as the same variable selects the JAX package's Pallas conv.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os

from rcvpose_tpu_torch.config import Config


def build_parser():
    parser = argparse.ArgumentParser(prog="rcvpose-tpu-torch")
    defaults = Config()
    parser.add_argument("--mode", default=defaults.mode,
                        choices=["train", "test", "benchmark", "gen-labels",
                                 "export-torch", "serve", "check-data"])
    parser.add_argument("--dname", "--dataset", dest="dataset",
                        default=defaults.dataset, choices=["lm", "lmo", "ycb"])
    parser.add_argument("--root_dataset", default=defaults.root_dataset)
    parser.add_argument("--class_name", default=defaults.class_name)
    parser.add_argument("--kpt_num", type=int, default=defaults.kpt_num)
    parser.add_argument("--optim", default=defaults.optim,
                        choices=["adam", "sgd", "Adam", "SGD"])
    parser.add_argument("--batch_size", type=int, default=defaults.batch_size)
    parser.add_argument("--initial_lr", type=float,
                        default=defaults.initial_lr)
    parser.add_argument("--max_iterations", type=int,
                        default=defaults.max_iterations)
    parser.add_argument("--resume_train", action="store_true")
    parser.add_argument("--model_dir", default=defaults.model_dir)
    parser.add_argument("--out_dir", default=defaults.out_dir)
    parser.add_argument("--model_blocks", default=defaults.model_blocks,
                        help='stage depths, e.g. "1,1,1,1"; "" = ResNet-152')
    parser.add_argument("--model_width", type=float,
                        default=defaults.model_width,
                        help="channel multiplier (power-of-two fraction)")
    parser.add_argument("--kpt_heads", type=int, default=defaults.kpt_heads,
                        help="1 = reference per-keypoint nets; 3 = one "
                             "fused multi-head net")
    parser.add_argument("--model", default=defaults.model,
                        choices=["dense", "res"])
    parser.add_argument("--compute_dtype", default=defaults.compute_dtype,
                        choices=["bfloat16", "float32"])
    parser.add_argument("--remat", action="store_true",
                        help="recompute encoder blocks in the backward "
                             "(less activation memory, a slower step)")
    parser.add_argument("--fast_head", action="store_true",
                        help="conv7/conv8 head at H/2 + upsampled output "
                             "(faster forward; not the reference forward)")
    parser.add_argument("--vote_mode", default=defaults.vote_mode,
                        choices=["hier", "exact", "surface"])
    parser.add_argument("--vote_grid_l", type=int,
                        default=defaults.vote_grid_l)
    parser.add_argument("--vote_topk", type=int, default=defaults.vote_topk,
                        help="hier refine windows (default 32)")
    parser.add_argument("--vote_cpt_stride", type=int,
                        default=defaults.vote_cpt_stride,
                        help="hier coarse-stage point subsample")
    parser.add_argument("--vote_win", type=int, default=defaults.vote_win,
                        help="hier refine window side (default 8)")
    parser.add_argument("--max_points", type=int,
                        default=defaults.max_points,
                        help="padded point-cloud size for voting")
    parser.add_argument("--retry_grid_l", type=int,
                        default=defaults.retry_grid_l,
                        help="vote-grid side for the overflow retry; a "
                             "frame still overflowing after the retry is "
                             "reported as overflow_after_retry")
    parser.add_argument("--pack_win_h", type=int, default=defaults.pack_win_h,
                        help="serving point-packing window height px (0 = "
                             "derive from class geometry)")
    parser.add_argument("--pack_win_w", type=int, default=defaults.pack_win_w,
                        help="serving point-packing window width px (0 = "
                             "derive from class geometry)")
    parser.add_argument("--pack_z_min_mm", type=float,
                        default=defaults.pack_z_min_mm,
                        help="nearest expected object depth for the derived "
                             "packing window")
    parser.add_argument("--icp_iters", type=int, default=defaults.icp_iters)
    parser.add_argument("--no_ycb_icp_converged", dest="ycb_icp_converged",
                        action="store_false",
                        default=defaults.ycb_icp_converged,
                        help="YCB eval: fixed icp_iters instead of the "
                             "reference's converge-to-tolerance ICP "
                             "(AccumulatorSpace.py:1165-1169)")
    parser.add_argument("--ycb_icp_max_iters", type=int,
                        default=defaults.ycb_icp_max_iters,
                        help="iteration cap on the converged YCB ICP")
    parser.add_argument("--icp_rel_tol", type=float,
                        default=defaults.icp_rel_tol,
                        help="convergence tolerance (fitness + RMSE "
                             "absolute per-iteration delta)")
    parser.add_argument("--serve_host", default=defaults.serve_host)
    parser.add_argument("--serve_port", type=int,
                        default=defaults.serve_port)
    parser.add_argument("--serve_classes", default=defaults.serve_classes,
                        help="comma list of extra classes to build before "
                             "the serve socket opens")
    parser.add_argument("--serve_devices", type=int,
                        default=defaults.serve_devices,
                        help="per-card replicas of the default class")
    parser.add_argument("--log_interval", type=int,
                        default=defaults.log_interval,
                        help="fetch + TB-log train metrics every N steps "
                             "(each fetch waits for the device; the NaN "
                             "guard samples at this cadence)")
    parser.add_argument("--accum_steps", type=int,
                        default=defaults.accum_steps,
                        help="gradient accumulation: N microbatches of "
                             "batch_size/N per optimizer step")
    parser.add_argument("--val_interval_epochs", type=int,
                        default=defaults.val_interval_epochs,
                        help="validate + checkpoint every N epochs "
                             "(1 = reference behavior; the final epoch "
                             "always validates)")
    parser.add_argument("--using_ckpts", action="store_true", default=True)
    parser.add_argument("--no_ckpts", dest="using_ckpts",
                        action="store_false",
                        help="use precomputed estRadialMap npy files")
    parser.add_argument("--eval_classes", default=defaults.eval_classes,
                        help="comma-separated class subset for --mode test "
                             "(default: every dataset class, like the "
                             "reference)")
    parser.add_argument("--eval_data_parallel", dest="eval_data_parallel",
                        action="store_true", default=None,
                        help="--mode test: shard evaluation frames over "
                             "the local cards")
    parser.add_argument("--no_eval_data_parallel", dest="eval_data_parallel",
                        action="store_false",
                        help="force the sequential per-frame eval loop")
    parser.add_argument("--demo_mode", action="store_true")
    parser.add_argument("--demo_scene_ply", action="store_true",
                        help="demo mode also writes each frame's colored "
                             "scene cloud as <frame>_scene.ply")
    parser.add_argument("--test_occ", action="store_true")
    parser.add_argument("--fake_depth", action="store_true",
                        help="gen-labels: meter-valued FakeDepth/ maps for "
                             "the RGB-only ablation (reference "
                             "depthGeneration flag)")
    parser.add_argument("--compile_cache_dir",
                        default=defaults.compile_cache_dir,
                        help="directory the kernel libraries build into "
                             "and load from, shared across processes and "
                             "restarts (default rcvpose_tpu_torch/_build/)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process train/test under torchrun "
                             "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT); a logged no-op on one process")
    parser.add_argument("--seed", type=int, default=defaults.seed)
    parser.add_argument("--profile_dir", default=defaults.profile_dir,
                        help="write a torch.profiler trace of the train/"
                             "test run into this directory (Perfetto/"
                             "chrome://tracing-viewable)")
    parser.add_argument("--export_path", default=defaults.export_path,
                        help="export-torch: output .pth.tar path (default "
                             "<model_dir>/exported.pth.tar)")
    return parser


def config_from_args(argv=None):
    args = build_parser().parse_args(argv)
    cfg = Config()
    for field in dataclasses.fields(Config):
        if hasattr(args, field.name):
            setattr(cfg, field.name, getattr(args, field.name))
    cfg.optim = cfg.optim.lower()
    return cfg


def maybe_init_distributed(cfg, device=None):
    """``--distributed``: join the torchrun world.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, pins ``LOCAL_RANK``'s card (modulo the cards there
    are, so that several ranks may share one) and makes the default
    process group over ``tcp://MASTER_ADDR:MASTER_PORT``: NCCL when the
    entry point runs on the card, gloo on the CPU, or the backend that
    ``RCVPOSE_DIST_BACKEND`` names. Without a world of several processes
    it is a logged no-op, as the JAX CLI's is without a coordinator.
    Returns True iff it made the group (an existing one is reused and
    False returned)."""
    if not cfg.distributed:
        return False
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        print("distributed init skipped (single process)")
        return False
    if dist.is_initialized():
        return False
    from rcvpose_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = os.environ.get("RCVPOSE_DIST_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world,
                            rank=int(os.environ["RANK"]))
    print(f"distributed: rank {dist.get_rank()} of {world} ({backend})")
    return True


def conv_kernel_route():
    """``RCVPOSE_PALLAS_CONV``: ``on`` trains with the decoder convs on
    K3/K4, ``off`` or unset on cuDNN. ``interpret`` (the JAX package's
    Pallas interpreter) and ``auto`` (its TPU-tuned heuristic) have no
    counterpart in the port and raise."""
    env = os.environ.get("RCVPOSE_PALLAS_CONV", "off")
    if env in ("off", "on"):
        return env == "on"
    raise ValueError(f"RCVPOSE_PALLAS_CONV={env!r}: the port takes 'on' "
                     "(decoder convs on K3/K4) or 'off' (cuDNN); it has no "
                     "interpret mode and no 'auto' heuristic")


def _mesh_size_for_batch(batch_size, n_devices):
    """Largest divisor of the batch that fits the device count (a batch
    of 6 on 8 devices gets a 6-device mesh, not gcd's 2)."""
    for d in range(min(max(batch_size, 1), max(n_devices, 1)), 0, -1):
        if batch_size % d == 0:
            return d
    return 1


def run_train(cfg, device=None):
    """Train ``cfg.class_name`` from the dataset tree at
    ``cfg.root_dataset``; returns the ``Trainer``. Checkpoints go to
    ``<log_dir>/ckpts``; ``cfg.resume_train`` restores ``model_best``
    there and continues to ``cfg.max_iterations``.

    Under a process group (``--distributed``) every process trains on its
    card with its shard of the batches (``cfg.batch_size`` rows each, as
    the JAX CLI's per-host batch) and the steps are the global-batch ones
    of ``train.make_parallel_steps``; rank 0 alone holds the TensorBoard
    writer and writes the checkpoints."""
    import torch

    from rcvpose_tpu_torch import parallel, train, utils
    from rcvpose_tpu_torch.checkpoint import Checkpointer
    from rcvpose_tpu_torch.data.loader import make_loaders

    conv_kernel = conv_kernel_route()
    dev = utils.resolve_device(device)
    # one card a process (PyTorch's idiom, where the JAX CLI spans every
    # local chip): the process's batch goes whole to its one slot, and
    # the mesh has one slot a process
    slots = _mesh_size_for_batch(cfg.batch_size, 1)
    n_dev = slots * parallel.process_count()
    if cfg.mesh_data_axis and cfg.mesh_data_axis != n_dev:
        raise ValueError(
            f"mesh_data_axis={cfg.mesh_data_axis}: the port trains on one "
            f"card a process, so its mesh has {n_dev} (launch that many "
            "processes with torchrun)")
    mesh = parallel.data_mesh(n_dev, devices=[dev])
    parallel.warm_collectives(mesh)
    rank0 = mesh.rank == 0
    if rank0:
        log_dir = utils.get_log_dir(cfg)
    else:
        log_dir = cfg.log_dir()
        os.makedirs(log_dir, exist_ok=True)
    writer = None
    if rank0:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(logdir=log_dir + "/tbLog/")
        except ImportError:
            pass

    train_loader, val_loader = make_loaders(cfg, device=dev)
    steps_per_epoch = max(len(train_loader), 1)
    state = train.create_state(cfg, torch.Generator().manual_seed(cfg.seed),
                               steps_per_epoch=steps_per_epoch,
                               device=dev, conv_kernel=conv_kernel)
    ckpt = Checkpointer(log_dir + "/ckpts", group=mesh.group)
    trainer = train.Trainer(
        cfg=cfg, state=state,
        # two-argument factory: a mid-epoch resume skips at the index
        # level (the skipped prefix is never read, BatchLoader.batches)
        train_batches=lambda epoch, start_batch=0: train_loader.batches(
            epoch, start_batch),
        val_batches=lambda: iter(val_loader),
        checkpointer=ckpt, writer=writer, steps_per_epoch=steps_per_epoch,
        mesh=mesh)
    if cfg.resume_train:
        # the reference resumes from model_best (train.py:46); the restored
        # iteration places fit() in its epoch and fast-forwards within it
        state, epoch, iteration, best = ckpt.restore(state, best=True)
        trainer.state, trainer.iteration, trainer.best_val = \
            state, iteration, best
    max_epochs = int(math.ceil(cfg.max_iterations / steps_per_epoch))
    trainer.fit(max_epochs)
    return trainer


def run_test(cfg, device=None):
    from rcvpose_tpu_torch import eval as eval_mod

    classes = ([c.strip() for c in cfg.eval_classes.split(",") if c.strip()]
               or None)
    if cfg.dataset == "ycb":
        ycb_ids = None
        if classes:
            name_to_id = {v: k for k, v in eval_mod.YCB_CLASS_NAMES.items()}
            ycb_ids = [name_to_id[c] for c in classes]
        return eval_mod.estimate_6d_pose_ycb(cfg, class_ids=ycb_ids,
                                             device=device)
    if cfg.test_occ or cfg.dataset == "lmo":
        return eval_mod.estimate_6d_pose_lmo(cfg, class_names=classes,
                                             device=device)
    return eval_mod.estimate_6d_pose_lm(cfg, class_names=classes,
                                        device=device)


def run_gen_labels(cfg, device=None):
    """Offline GT radial-map generation (reference 3DRadius_* scripts)."""
    from rcvpose_tpu_torch.data import genlabels

    if cfg.dataset == "lm":
        # accept either the LINEMOD dir itself or its parent (the test
        # mode's --root_dataset convention), so one flag works for both
        root = cfg.root_dataset
        sub = os.path.join(root, "LINEMOD")
        if os.path.isdir(sub):
            root = sub
        if cfg.fake_depth:
            # one FakeDepth/ dir per class (the reference loops keypoints
            # into it, each overwriting the last: run one keypoint)
            genlabels.generate_lm(root, cfg.class_name,
                                  kpt_indices=[cfg.kpt_num],
                                  fake_depth=True, device=device)
        else:
            genlabels.generate_lm(root, cfg.class_name, device=device)
    else:
        from rcvpose_tpu_torch.eval import YCB_CLASS_NAMES
        class_id = {v: k for k, v in YCB_CLASS_NAMES.items()}[cfg.class_name]
        genlabels.generate_ycb(cfg.root_dataset, cfg.class_name, class_id,
                               device=device)


def run_export_torch(cfg):
    """Export a training run's weights as a reference-format ``.pth.tar``.

    ``--model_dir`` points at a ``Checkpointer`` directory (the ``ckpts/``
    under a train run's log dir) of either package; ``model_best`` is
    preferred over ``ckpt``, the reference's eval-from-best convention
    (train.py:46). The port's checkpoints are reference-layout already, so
    this copies ``model_state_dict``, ``epoch`` and ``iteration`` (with
    ``arch``) and leaves the optimizer state behind. A JAX orbax directory
    is read without JAX (``checkpoint.orbax_payload``) and written as the
    JAX CLI's export writes it: the same keys, in the same order, and the
    same tensors. Reference code can ``torch.load`` the result and
    ``load_state_dict`` it onto DenseFCNResNet152."""
    import torch

    from rcvpose_tpu_torch import checkpoint

    out = cfg.export_path or os.path.join(cfg.model_dir, "exported.pth.tar")
    port_best = os.path.join(cfg.model_dir, checkpoint.Checkpointer.BEST)
    port_ckpt = os.path.join(cfg.model_dir, checkpoint.Checkpointer.CKPT)
    if os.path.isfile(port_best) or os.path.isfile(port_ckpt):
        best = os.path.isfile(port_best)
        payload = torch.load(port_best if best else port_ckpt,
                             map_location="cpu", weights_only=True)
        sd = payload["model_state_dict"]
        arch = payload.get("arch", "DenseFCNResNet152")
    else:
        best = os.path.isdir(os.path.join(cfg.model_dir, "model_best"))
        payload = checkpoint.orbax_payload(
            cfg.model_dir, ("params", "batch_stats", "epoch", "iteration"))
        sd = checkpoint.from_flax_variables(payload)
        arch = "DenseFCNResNet152"
    torch.save({"model_state_dict": sd,
                "epoch": int(payload["epoch"]),
                "iteration": int(payload["iteration"]),
                "arch": arch}, out)
    print(f"exported {'model_best' if best else 'ckpt'} -> {out}")
    return out


def main(argv=None, device=None):
    cfg = config_from_args(argv)
    if cfg.compile_cache_dir:
        from rcvpose_tpu_torch import utils

        utils.enable_compile_cache(cfg.compile_cache_dir)
    if cfg.profile_dir and cfg.mode in ("train", "test"):
        from rcvpose_tpu_torch import profiling

        with profiling.trace(cfg.profile_dir):
            return main_dispatch(cfg, device)
    return main_dispatch(cfg, device)


def main_dispatch(cfg, device=None):
    """Run ``cfg.mode``; returns the ``Trainer`` of a train run, the
    results of a test run, the (shut down) server of a serve run and the
    record of a benchmark run. A
    process group that ``--distributed`` made here is left at the end."""
    made = (maybe_init_distributed(cfg, device)
            if cfg.mode in ("train", "test") else False)
    try:
        return _dispatch(cfg, device)
    finally:
        if made:
            import torch.distributed as dist

            dist.destroy_process_group()


def _dispatch(cfg, device):
    if cfg.mode == "train":
        return run_train(cfg, device)
    if cfg.mode == "test":
        from rcvpose_tpu_torch import parallel

        results = run_test(cfg, device)
        # the reference only prints its final ADD(s) lines
        # (AccumulatorSpace.py:735-740); also persist them. Every process
        # holds the same reduced results; rank 0 writes the file.
        if parallel.process_index() == 0:
            import json

            os.makedirs(cfg.out_dir, exist_ok=True)
            path = os.path.join(cfg.out_dir, "eval_results.json")
            with open(path, "w") as f:
                json.dump(results, f, indent=2, default=float)
            print(f"eval results written to {path}")
        return results
    if cfg.mode == "serve":
        from rcvpose_tpu_torch import serve

        return serve.run_serve(cfg, device)
    if cfg.mode == "benchmark":
        from rcvpose_tpu_torch import bench

        return bench.main([], device=device)
    if cfg.mode == "gen-labels":
        run_gen_labels(cfg, device)
    elif cfg.mode == "export-torch":
        run_export_torch(cfg)
    elif cfg.mode == "check-data":
        from rcvpose_tpu_torch import checkdata

        findings = checkdata.run_check(cfg)
        if any(f.level == "ERROR" for f in findings):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
