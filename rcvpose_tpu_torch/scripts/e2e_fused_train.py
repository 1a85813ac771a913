"""The fused-net training recipe of the learned evaluator proofs
(``e2e_lmo``, ``e2e_ycb``), the counterpart of the JAX package's
``scripts/e2e_fused_train.py``: label the frames with
``labels.radial_labels``, train ONE multi-head net (``kpt_heads=3``) with
``train.Trainer``, validate, and save it where the evaluators look in
fused mode (``<model_dir>/<class>/``, ``eval._load_models``) in the
port's ``Checkpointer`` format.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from rcvpose_tpu_torch.scripts.e2e_synthetic import (  # noqa: F401
    frame_labels, normalized_images, per_kpt_max_radii_dm, train_net)


def train_fused_checkpoint(cfg, images, depths, poses, keypoints_m,
                           max_radii_dm, k, n_train, ckpt_dir, device):
    """Train on the first ``n_train`` frames and save to ``ckpt_dir``.

    ``keypoints_m`` rows 1..3 are the trained keypoints (the reference's
    Outside9 convention, rmap_dataset.py:43-51). Model depth and width
    come from ``cfg.model_blocks`` / ``cfg.model_width``
    (``train.build_model``); the init is seeded with 0, the batches of
    epoch e are ``default_rng(e * 7)``'s permutation, and the validation
    takes the first batch of frames. The decoder convs take the route
    ``RCVPOSE_PALLAS_CONV`` names (``cli.conv_kernel_route``). Returns
    (iteration, val).
    """
    import torch

    from rcvpose_tpu_torch import cli
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.checkpoint import Checkpointer

    batch = cfg.batch_size
    if n_train % batch:
        # the batches drop the tail and max_epochs assumes none is dropped:
        # a non-multiple would silently undertrain (or train zero steps)
        raise ValueError(f"n_train={n_train} must be a multiple of the "
                         f"batch size {batch}")
    radial_all, sem_all = frame_labels(
        depths[:n_train], poses[:n_train], k, keypoints_m[1:4],
        max_radii_dm, device)
    images_norm = normalized_images(images[:n_train], device)
    state = train_mod.create_state(
        cfg, torch.Generator().manual_seed(0),
        steps_per_epoch=n_train // batch, device=device,
        conv_kernel=cli.conv_kernel_route())
    t0 = time.time()
    trainer, _, val = train_net(cfg, state, images_norm, radial_all,
                                sem_all, n_train, 0, np.arange(batch))
    print(f"fused: {trainer.iteration} steps in {time.time() - t0:.1f} s, "
          f"val loss {val:.4f}", file=sys.stderr)
    max_epochs = -(-cfg.max_iterations * batch // n_train)
    ckpt = Checkpointer(ckpt_dir)
    ckpt.save(trainer.state, epoch=max_epochs, iteration=trainer.iteration,
              best_val=val, is_best=False)
    # asynchronous save: the caller's evaluator reads this directory next
    ckpt.wait_until_finished()
    return trainer.iteration, val
