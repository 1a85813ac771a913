"""FCN-ResNet-152 radial-map backbones in PyTorch (counterpart of
``rcvpose_tpu.models.fcnresnet``).

* ``DenseFCNResNet152``: ResNet-152 encoder (3/8/36/3 bottleneck stages),
  a 2048 -> 1024 conv6 neck and an FCN decoder with concatenated skips,
  emitting 2K full-resolution channels split into (segmentation, radial).
* ``ResFCNResNet152``: the same encoder with additive skips through 1x1
  channel-lift convs.

Submodules carry the reference state-dict names (``conv1``, ``bn1``,
``block1up.upsample_.0``, ``block2.3.conv2``, ``conv_up5.0``, ``conv7.1``,
``conv8``, ``conv_up4_1``, ...), so reference checkpoints and the weight
bridge (``checkpoint.from_flax_variables``) load directly. The JAX
package's shifted-matmul ``MMConv`` layers are plain ``nn.Conv2d`` here
(SAME padding ``k//2``, with a bias); with ``conv_kernel=True`` the 3x3
ones (the decoder's ``conv_upN`` and ``conv7``) run on K3/K4
(``ops/mmconv.py``), the counterpart of ``RCVPOSE_PALLAS_CONV=on``.
Batch norm updates its running statistics as Flax's ``nn.BatchNorm`` does.
``remat=True`` recomputes each encoder Bottleneck in the backward
(``torch.utils.checkpoint``, the counterpart of the JAX package's
``nn.remat(Bottleneck)``); the replay's batch norms normalize as the
forward did but write no statistic, so the running statistics move once
per train-mode forward, as ``nn.remat`` keeps them. Under a process
group of several ranks (``set_batch_norm_group``) the train-mode batch
norms take their statistics over the global batch, as Flax's do inside a
jit over a batch sharded across processes.

Public layout as in the JAX package: NHWC images in, ``(B, H, W, K)`` f32
seg and radial out. Inside, an NHWC input viewed as NCHW carries
channels-last strides, which the convolutions keep.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rcvpose_tpu_torch.ops import heads, mmconv
from rcvpose_tpu_torch.parallel.mesh import all_reduce

# ResNet-152 stage depths.
RESNET152_BLOCKS = (3, 8, 36, 3)


def _scaled(c: int, width: float) -> int:
    """Channel count scaled by a width multiplier, floored at 8.

    ``width=1.0`` is the reference architecture; fractional widths keep
    the topology for tests.
    """
    return max(8, int(round(c * width)))


_replay = threading.local()


@contextlib.contextmanager
def _replaying():
    """Marks the recompute of a rematerialized block, on the thread that
    runs it (the autograd engine's)."""
    before = getattr(_replay, "active", False)
    _replay.active = True
    try:
        yield
    finally:
        _replay.active = before


def _remat_contexts():
    """``context_fn`` of the encoder's checkpoints: nothing around the
    forward, the replay flag around the recompute."""
    return contextlib.nullcontext(), _replaying()


class _AllReduceSum(torch.autograd.Function):
    """Differentiable ``all_reduce(SUM)``: its backward sums the
    cotangents of every rank, which is the transpose of a sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode forward updates the running
    statistics as Flax's ``nn.BatchNorm`` does: with the *biased* batch
    variance (torch's own layer takes the unbiased one). Normalization is
    unchanged: batch statistics in train mode, running ones in eval mode.
    Parameter and persistent buffer names are ``nn.BatchNorm2d``'s.

    In the recompute of a rematerialized block (``_replaying``) the
    train-mode forward normalizes with the batch statistics by the same
    call, but into throwaway buffers: the running statistics,
    ``batch_mean``/``batch_var`` and ``num_batches_tracked`` keep the
    values the forward gave them.

    ``group``: a process group of more than one rank makes the train-mode
    statistics global (``_global_forward``); None (the default) or a
    group of one rank keeps the layer above, bit for bit. Not
    ``nn.SyncBatchNorm``, which updates the running variance with the
    unbiased estimate."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # scratch for the batch statistics, outside the state dict
        self.register_buffer("batch_mean", torch.zeros_like(self.running_mean),
                             persistent=False)
        self.register_buffer("batch_var", torch.zeros_like(self.running_var),
                             persistent=False)
        self.group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None and dist.get_world_size(self.group) > 1:
            return self._global_forward(x)
        if getattr(_replay, "active", False):
            return F.batch_norm(x, torch.zeros_like(self.batch_mean),
                                torch.zeros_like(self.batch_var),
                                self.weight, self.bias, True, 1.0, self.eps)
        # momentum 1 makes the fused op overwrite the scratch buffers with
        # this batch's mean and unbiased variance, so the statistics come
        # from the normalizing pass itself
        y = F.batch_norm(x, self.batch_mean, self.batch_var, self.weight,
                         self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.lerp_(self.batch_mean, m)
            self.running_var.mul_(1 - m).add_(self.batch_var,
                                              alpha=m * (n - 1) / n)
            self.num_batches_tracked += 1
        return y

    def _global_forward(self, x):
        """Train-mode batch norm over the global batch of ``self.group``:
        the per-channel f32 sum, sum of squares and element count are
        all-reduced, and the layer normalizes with the global mean and
        biased variance E[x^2] - E[x]^2 (Flax's fast variance), as a Flax
        ``BatchNorm`` does over the batch sharded across processes. The
        all-reduce is differentiable: the backward sums every rank's
        cotangents of the statistics, so each rank's input gradient is
        that of the global loss. The recompute of a rematerialized block
        reduces again, on every rank alike (each rank replays the same
        blocks in the same order), and writes no statistic."""
        c = x.shape[1]
        x32 = x.float()
        local = torch.cat([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)),
                           x32.new_full((1,), x.numel() // c)])
        tot = _AllReduceSum.apply(local, self.group)
        n = tot[2 * c].detach()
        mean = tot[:c] / n
        var = torch.clamp(tot[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        if not getattr(_replay, "active", False):
            m = self.momentum
            with torch.no_grad():
                self.running_mean.lerp_(mean, m)
                self.running_var.lerp_(var, m)
                self.num_batches_tracked += 1
        return y.to(x.dtype)


def set_batch_norm_group(model, group):
    """Give every port ``BatchNorm2d`` of ``model`` the process ``group``
    whose global batch its train-mode statistics cover (None: this
    process's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
    return model


def _bn(c):
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1-3-1 bottleneck with x4 expansion. ``project=True`` adds the 1x1
    projection shortcut (the reference's ``upsample_``)."""

    def __init__(self, in_channels, channels, stride=1, project=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.bn1 = _bn(channels)
        # reference conv2 keeps torch's default bias=True
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=stride,
                               padding=1)
        self.bn2 = _bn(channels)
        self.conv3 = nn.Conv2d(channels, channels * 4, 1, bias=False)
        self.bn3 = _bn(channels * 4)
        self.upsample_ = nn.Sequential(
            nn.Conv2d(in_channels, channels * 4, 1, stride=stride,
                      bias=False),
            _bn(channels * 4)) if project else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.upsample_ is None else self.upsample_(x)
        return F.relu(y + residual)


class MMConv2d(nn.Conv2d):
    """SAME stride-1 conv on K3/K4 (``ops.mmconv.MMConv2dFunction``), the
    counterpart of the JAX package's ``MMConv`` under
    ``RCVPOSE_PALLAS_CONV=on``. An ``nn.Conv2d`` subclass, so its
    parameters keep their names and initialization. Under autocast, x and
    the weight are cast to the autocast dtype here, outside the Function,
    so the weight's gradient arrives in the parameter's dtype."""

    def forward(self, x):
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev)
                 if torch.is_autocast_enabled(dev) else x.dtype)
        xh = x.to(dtype).permute(0, 2, 3, 1)          # NHWC view
        kernel = self.weight.to(dtype).permute(2, 3, 1, 0).contiguous()
        out = mmconv.MMConv2dFunction.apply(xh.contiguous(), kernel)
        out = out + self.bias.to(dtype)
        return out.permute(0, 3, 1, 2)                 # channels-last NCHW


def _conv_bn_relu(cin, cout, conv_kernel=False):
    conv = (MMConv2d(cin, cout, 3, padding=1) if conv_kernel
            else nn.Conv2d(cin, cout, 3, padding=1))
    return nn.Sequential(conv, _bn(cout), nn.ReLU())


def resize2x(x):
    """Bilinear x2 upsample, half-pixel centers with edge clamp."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class _Encoder(nn.Module):
    """Shared ResNet-152 encoder trunk. A base class rather than a child
    module, so its layers sit at the top of the state dict as in the
    reference (``conv1``, ``block1up``, ``block1``, ...)."""

    def __init__(self, input_channels=3, blocks=RESNET152_BLOCKS, width=1.0,
                 remat=False):
        super().__init__()
        self.remat = remat
        w = lambda c: _scaled(c, width)  # noqa: E731
        self.conv1 = nn.Conv2d(input_channels, w(64), 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = _bn(w(64))
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.stage_channels = tuple(w(c) for c in (64, 128, 256, 512))
        cin = w(64)
        for s, (depth, ch) in enumerate(zip(blocks, self.stage_channels)):
            setattr(self, f"block{s + 1}up",
                    Bottleneck(cin, ch, stride=1 if s == 0 else 2,
                               project=True))
            setattr(self, f"block{s + 1}",
                    nn.Sequential(*[Bottleneck(ch * 4, ch)
                                    for _ in range(1, depth)]))
            cin = ch * 4

    def encode(self, x):
        """NCHW input -> (x, x2s, x4s, x8s, x16s) at H/2 .. H/32."""
        x = F.relu(self.bn1(self.conv1(x)))   # H/2 ("x" skip)
        y = self.maxpool(x)                   # H/4
        skips = []
        for s in range(1, 5):
            for block in (getattr(self, f"block{s}up"),
                          *getattr(self, f"block{s}")):
                y = self._bottleneck(block, y)
            skips.append(y)
        return (x, *skips)

    def _bottleneck(self, block, y):
        """One Bottleneck; under ``remat`` with gradients on, its
        activations are recomputed in the backward instead of kept."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, y, use_reentrant=False,
                              context_fn=_remat_contexts)
        return block(y)


def _nchw_input(model, x):
    """NHWC image batch -> NCHW view (channels-last strides) in the
    model's weight dtype."""
    return x.to(model.conv1.weight.dtype).permute(0, 3, 1, 2)


class DenseFCNResNet152(_Encoder):
    """Concat-skip FCN decoder variant, the production model.

    ``forward(x)`` takes NHWC RGB (H, W multiples of 32) and returns
    ``(seg, radial)``, each (B, H, W, K) f32 with K = output_channels // 2.
    ``fast_head`` runs conv7/conv8 before the last x2 upsample and
    upsamples the thin output instead (same parameters, not the reference
    forward). ``conv_kernel`` runs the 3x3 decoder convs (``conv_up5`` ..
    ``conv_up1``, ``conv7``) on K3/K4; ``remat`` recomputes the encoder's
    Bottlenecks in the backward.
    """

    def __init__(self, input_channels=3, output_channels=2,
                 blocks: Sequence[int] = RESNET152_BLOCKS, width=1.0,
                 fast_head=False, conv_kernel=False, remat=False):
        super().__init__(input_channels, blocks, width, remat)
        w = lambda c: _scaled(c, width)  # noqa: E731
        st = self.stage_channels
        ck = conv_kernel
        self.fast_head = fast_head
        self.conv6 = nn.Conv2d(4 * st[3], w(1024), 3, padding=1)
        self.bn6 = _bn(w(1024))
        self.conv_up5 = _conv_bn_relu(w(1024) + 4 * st[3], w(1024), ck)
        self.conv_up4 = _conv_bn_relu(w(1024) + 4 * st[2], w(512), ck)
        self.conv_up3 = _conv_bn_relu(w(512) + 4 * st[1], w(256), ck)
        self.conv_up2 = _conv_bn_relu(w(256) + 4 * st[0], w(128), ck)
        self.conv_up1 = _conv_bn_relu(w(128) + w(64), w(64), ck)
        self.conv7 = _conv_bn_relu(w(64), w(32), ck)
        self.conv8 = nn.Conv2d(w(32), output_channels, 1)

    def forward(self, x):
        xc, x2s, x4s, x8s, x16s = self.encode(_nchw_input(self, x))
        x32s = F.relu(self.bn6(self.conv6(x16s)))
        up = self.conv_up5(torch.cat([x32s, x16s], 1))
        up = self.conv_up4(torch.cat([resize2x(up), x8s], 1))
        up = self.conv_up3(torch.cat([resize2x(up), x4s], 1))
        up = self.conv_up2(torch.cat([resize2x(up), x2s], 1))
        up = self.conv_up1(torch.cat([resize2x(up), xc], 1))
        if self.fast_head:
            out = resize2x(self.conv8(self.conv7(up)))
        else:
            out = self.conv8(self.conv7(resize2x(up)))
        return _split_heads(out)


def _split_heads(out):
    """(B, 2K, H, W) -> ((B, H, W, K) seg, (B, H, W, K) radial), f32.

    The first K channels are the per-keypoint segmentation logits, the last
    K the radial maps. K2 writes one contiguous f32 channel-major
    (2K, B, H, W) buffer; seg and radial are views of it.
    """
    k = out.shape[1] // 2
    cm = heads.heads_channel_major(out)
    return cm[:k].permute(1, 2, 3, 0), cm[k:].permute(1, 2, 3, 0)


class ResFCNResNet152(_Encoder):
    """Additive-skip decoder variant. The default ``double_up1=False`` is
    the reference forward (five x2 upsamples, H/32 -> H);
    ``double_up1=True`` adds a sixth (2x-resolution output).
    ``conv_kernel`` runs the 3x3 decoder convs (``conv_up4`` ..
    ``conv_up1``, ``conv7``) on K3/K4."""

    def __init__(self, input_channels=3, output_channels=2,
                 double_up1=False, blocks: Sequence[int] = RESNET152_BLOCKS,
                 width=1.0, conv_kernel=False, remat=False):
        super().__init__(input_channels, blocks, width, remat)
        w = lambda c: _scaled(c, width)  # noqa: E731
        st = self.stage_channels
        ck = conv_kernel
        self.double_up1 = double_up1
        self.conv_up4_1 = nn.Conv2d(4 * st[2], w(2048), 1)
        self.conv_up4 = _conv_bn_relu(w(2048), w(1024), ck)
        self.conv_up3_1 = nn.Conv2d(4 * st[1], w(1024), 1)
        self.conv_up3 = _conv_bn_relu(w(1024), w(512), ck)
        self.conv_up2_1 = nn.Conv2d(4 * st[0], w(512), 1)
        self.conv_up2 = _conv_bn_relu(w(512), w(256), ck)
        self.conv_up1_1 = nn.Conv2d(w(64), w(256), 1)
        self.conv_up1 = _conv_bn_relu(w(256), w(128), ck)
        self.conv7 = _conv_bn_relu(w(128), w(64), ck)
        self.conv8 = nn.Conv2d(w(64), output_channels, 1)

    def forward(self, x):
        xc, x2s, x4s, x8s, x16s = self.encode(_nchw_input(self, x))
        up = self.conv_up4(resize2x(x16s) + self.conv_up4_1(x8s))
        up = self.conv_up3(resize2x(up) + self.conv_up3_1(x4s))
        up = self.conv_up2(resize2x(up) + self.conv_up2_1(x2s))
        up = self.conv_up1(resize2x(up) + self.conv_up1_1(xc))
        up = resize2x(up)
        if self.double_up1:
            up = resize2x(up)
        return _split_heads(self.conv8(self.conv7(up)))


def init_params(model, generator):
    """Seeded initialization of a model's parameters and BN statistics:
    conv kernels LeCun-normal (truncated at two standard deviations and
    rescaled to variance 1/fan_in), biases zero, BN scale one, running
    mean zero and running variance one. ``generator`` is a CPU
    ``torch.Generator``; initialize on the CPU, then move the model."""
    # std of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / trunc_std
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
