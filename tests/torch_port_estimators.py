"""The tiny serving estimator shared by the port's graph tests (this module
imports neither JAX nor the JAX package, so the card's machine runs the
files that use it under ``--noconftest``).

Drawing a tiny net's weights takes seconds on the CPU, so each
``kpt_heads``'s are drawn once a process and kept as state dicts;
``PoseEstimator`` copies them into nets of its own, so sharing them is
safe.
"""

import functools

import numpy as np
import torch
from torch import nn

from rcvpose_tpu_torch import infer, train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models import fcnresnet

HW = 64


def config(kpt_heads, dtype="float32", **cfg):
    # a threshold below every logit and radii above every map: each pixel
    # with depth is in every mask, whatever the random heads give; a short
    # top-k keeps the CPU's plain vote quick
    return Config(**{**dict(
        compute_dtype=dtype, vote_grid_l=64, vote_topk=8, max_points=1024,
        image_height=HW, image_width=HW, model_blocks="1,1,1,1",
        model_width=0.125, kpt_heads=kpt_heads, sem_threshold=-1e30), **cfg})


@functools.cache
def _weights(kpt_heads, seed=0):
    """The seeded weights of ``config(kpt_heads)``'s nets: three
    per-keypoint nets, or one fused net; ``seed`` draws another class's."""
    cfg = config(kpt_heads)
    n = 1 if kpt_heads > 1 else 3
    return tuple(fcnresnet.init_params(train.build_model(cfg),
                                       torch.Generator().manual_seed(
                                           n * seed + i)).state_dict()
                 for i in range(n))


def random_statistics(net, seed):
    """``net`` with random batch norm statistics, scales and shifts and
    random conv biases (conv2's, conv6's, the decoder's, conv8's), drawn
    in place from ``seed``; the fold's error shows on them where the
    identity statistics of a fresh init hide it."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, nn.Conv2d) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=gen)
    return net


def estimator(kpt_heads, device="cpu", dtype="float32", cad_mm=None,
              seed=0, graph_pool=None, **cfg):
    """A ``PoseEstimator`` of ``config(kpt_heads, dtype, **cfg)`` on
    ``device`` (None: the card), with the seeded weights and keypoints
    (``seed`` > 0: another class's), its graphs in ``graph_pool``."""
    keypoints = np.random.default_rng(
        [kpt_heads, seed] if seed else kpt_heads).normal(size=(9, 3)) * 0.05
    return infer.PoseEstimator(config(kpt_heads, dtype, **cfg),
                               list(_weights(kpt_heads, seed)), keypoints,
                               [1e6] * 3, cad_mm=cad_mm, device=device,
                               graph_pool=graph_pool)


def frame(seed, hw=HW, patch=24):
    """A uint8 image and a depth map (mm) whose centred ``patch`` square
    alone has depth."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(hw, hw, 3), dtype=np.uint8)
    depth = np.zeros((hw, hw), np.float32)
    r0 = (hw - patch) // 2
    depth[r0:r0 + patch, r0:r0 + patch] = rng.uniform(
        650.0, 750.0, size=(patch, patch))
    return img, depth
