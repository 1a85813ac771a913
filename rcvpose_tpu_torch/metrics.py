"""Pose-accuracy metrics: ADD / ADD-S, pass rates and AUC (counterpart of
``rcvpose_tpu.metrics``), on tensors.

Semantics of the reference (AccumulatorSpace.py:687-695, 978, 1144-1152),
as in the JAX package:
* asymmetric objects: score = *mean* nearest-neighbour distance from the
  CAD model under the GT transform to the model under the estimate (NN,
  not index-paired);
* symmetric objects (ADD-S): score = *min* NN distance;
* a pose passes when score <= threshold;
* YCB reports the AUC of accuracy over thresholds in [0, 0.1 m],
  normalized by 0.1.

``nn_distances`` keeps the ``|a|^2 - 2ab + |b|^2`` form with one
``torch.matmul`` in full f32: the JAX package asks for
``Precision.HIGHEST``, which on the card means TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

import numpy as np
import torch


def _sq_rows(x):
    return (x * x).sum(dim=1)


def nn_distances(a, b, b_mask=None):
    """For each point of ``a`` (M, 3), the distance to its nearest
    neighbour in ``b`` (N, 3); masked-out points of ``b`` never count."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    d2 = _sq_rows(a)[:, None] - 2.0 * torch.matmul(a, b.T) + _sq_rows(b)[None]
    if b_mask is not None:
        d2 = torch.where(b_mask[None, :], d2, torch.full_like(d2, 1e30))
    return torch.sqrt(torch.clamp(d2.amin(dim=1), min=0.0))


def transform(points, rt):
    """``points @ R.T + t`` for a (3, 4) or (4, 4) transform."""
    return points @ rt[:3, :3].T + rt[:3, 3]


def add_score(model_pts, rt_gt, rt_est):
    """(mean_nn, min_nn) distances between the model under the GT and the
    estimated transforms: the reference's ADD / ADD-S pair in one pass."""
    d = nn_distances(transform(model_pts, rt_gt), transform(model_pts,
                                                             rt_est))
    return d.mean(), d.amin()


def add_accuracy(scores, threshold):
    """Fraction of frames with score <= threshold."""
    scores = torch.as_tensor(scores)
    return (scores <= threshold).to(torch.float32).mean()


def auc_add(distances, max_threshold=0.1, steps=1000, thresholds=None):
    """AUC of accuracy over thresholds [0, max_threshold], normalized.

    NumPy, as in the JAX package: accuracy(t) on a threshold sweep,
    trapezoid-integrated and divided by max_threshold. Pass
    ``thresholds=[0, 0.02, 0.04, 0.06, 0.08, 0.1]`` (meters) for the exact
    reference YCB grid (AccumulatorSpace.py:978).
    """
    if torch.is_tensor(distances):
        distances = distances.detach().cpu().numpy()
    d = np.asarray(distances, np.float64)
    if thresholds is not None:
        ts = np.asarray(thresholds, np.float64)
        max_threshold = ts[-1]
    else:
        ts = np.linspace(0.0, max_threshold, steps)
    acc = (d[None, :] <= ts[:, None]).mean(axis=1)
    return float(np.trapezoid(acc, ts) / max_threshold)
