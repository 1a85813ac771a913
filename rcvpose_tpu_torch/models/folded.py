"""The serving nets with batch norm folded: the eval-only twins of
``models.fcnresnet``'s two nets.

``fold_for_serving(net)`` takes an eval-mode ``DenseFCNResNet152`` or
``ResFCNResNet152`` and returns a module that computes the same function
with each conv -> eval batch norm (-> + residual) (-> ReLU) chain as two
kernels: the conv without a bias (cuDNN on the card) and
``ops.epilogue.conv_epilogue``, in place on the conv's output. A unit's
per-channel f32 ``scale`` and ``shift`` are

    scale = gamma * rsqrt(running_var + eps)
    shift = beta + (conv_bias - running_mean) * scale

(``conv_bias`` 0 where the conv has none), computed in f32 from the net's
own parameters in their dtype, as eval batch norm promotes them. The conv
weights are the net's own tensors, shared and unscaled. The units: the
stem (conv1, bn1, ReLU); in each Bottleneck, conv1 and conv2 (ReLU), the
projection (``upsample_``, no ReLU) and conv3, which adds the residual (the
input or the projection's output) before its ReLU; conv6 / bn6 and the
decoder's ``_conv_bn_relu`` units (ReLU). conv8 and the additive decoder's
1x1 lifts keep their biases and no batch norm.

The folded classes are separate from the training ones, which keep their
code: serving carries no running statistics and training must. They hold
no trainable parameter (weights, biases, scales and shifts are buffers),
refuse train mode, and take the same NHWC input and return the same
``(seg, radial)`` through ``fcnresnet._split_heads``. A unit keeps scale
and shift as the int32 bits of one (2, C) f32 tensor, so that ``.to(dtype)``
and the other floating casts leave them in f32, while ``.to(device)``,
``copy.deepcopy`` and the state dict carry them. Nets built with
``conv_kernel=True`` (K3/K4, a training route) are refused.

Counter (``profiling.counters()``): ``bn.folded``, the batch norms folded
(162 a full-width DenseFCNResNet152).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rcvpose_tpu_torch import profiling
from rcvpose_tpu_torch.models import fcnresnet
from rcvpose_tpu_torch.models.fcnresnet import (_nchw_input, _split_heads,
                                                resize2x)
from rcvpose_tpu_torch.ops.epilogue import conv_epilogue


class _Frozen(nn.Module):
    """A module that is in eval mode for good: ``train(True)`` raises."""

    def train(self, mode=True):
        if mode:
            raise RuntimeError(f"{type(self).__name__} is a serving net with "
                               f"batch norm folded: it has no train mode")
        return super().train(False)


class _Conv(_Frozen):
    """A conv with its bias (conv8, the 1x1 lifts), weights as buffers."""

    def __init__(self, conv):
        super().__init__()
        self.stride, self.padding = conv.stride, conv.padding
        self.register_buffer("weight", conv.weight.detach())
        self.register_buffer("bias", conv.bias.detach())

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class _Unit(_Frozen):
    """conv -> eval batch norm (-> + residual) (-> ReLU): the conv without
    a bias, then the epilogue in place on its output."""

    def __init__(self, conv, bn, relu):
        super().__init__()
        self.stride, self.padding = conv.stride, conv.padding
        self.relu = relu
        self.register_buffer("weight", conv.weight.detach())
        with torch.no_grad():
            scale = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                    + bn.eps)
            shift = -bn.running_mean.float()
            if conv.bias is not None:
                shift = shift + conv.bias.float()
            shift = bn.bias.float() + shift * scale
        self.register_buffer("affine",
                             torch.stack([scale, shift]).view(torch.int32))

    def forward(self, x, residual=None):
        y = F.conv2d(x, self.weight, None, self.stride, self.padding)
        scale, shift = self.affine.view(torch.float32)
        return conv_epilogue(y, scale, shift, residual, self.relu)


def _conv_bn_relu(seq):
    conv, bn, _ = seq
    return _Unit(conv, bn, relu=True)


class _Bottleneck(_Frozen):
    """A folded ``fcnresnet.Bottleneck``."""

    def __init__(self, block):
        super().__init__()
        self.unit1 = _Unit(block.conv1, block.bn1, relu=True)
        self.unit2 = _Unit(block.conv2, block.bn2, relu=True)
        self.unit3 = _Unit(block.conv3, block.bn3, relu=True)
        self.project = (None if block.upsample_ is None
                        else _Unit(*block.upsample_, relu=False))

    def forward(self, x):
        y = self.unit2(self.unit1(x))
        residual = x if self.project is None else self.project(x)
        return self.unit3(y, residual)


class _Encoder(_Frozen):
    """The folded ResNet-152 trunk: the stem and one ``nn.Sequential`` of
    Bottlenecks a stage."""

    def __init__(self, net):
        super().__init__()
        if any(isinstance(m, fcnresnet.MMConv2d) for m in net.modules()):
            raise ValueError("fold_for_serving refuses a net built with "
                             "conv_kernel=True (K3/K4 decoder convs, a "
                             "training route); build it without")
        self.conv1 = _Unit(net.conv1, net.bn1, relu=True)
        self.maxpool = net.maxpool
        self.stages = nn.ModuleList(
            nn.Sequential(*[_Bottleneck(b) for b in (
                getattr(net, f"block{s}up"), *getattr(net, f"block{s}"))])
            for s in range(1, 5))

    def encode(self, x):
        """NCHW input -> (x, x2s, x4s, x8s, x16s) at H/2 .. H/32."""
        x = self.conv1(x)                     # H/2 ("x" skip)
        y = self.maxpool(x)                   # H/4
        skips = []
        for stage in self.stages:
            y = stage(y)
            skips.append(y)
        return (x, *skips)


class FoldedDenseFCNResNet152(_Encoder):
    """``DenseFCNResNet152``'s eval forward with batch norm folded."""

    def __init__(self, net):
        super().__init__(net)
        self.fast_head = net.fast_head
        self.conv6 = _Unit(net.conv6, net.bn6, relu=True)
        for name in ("conv_up5", "conv_up4", "conv_up3", "conv_up2",
                     "conv_up1", "conv7"):
            setattr(self, name, _conv_bn_relu(getattr(net, name)))
        self.conv8 = _Conv(net.conv8)

    def forward(self, x):
        xc, x2s, x4s, x8s, x16s = self.encode(_nchw_input(self, x))
        up = self.conv_up5(torch.cat([self.conv6(x16s), x16s], 1))
        up = self.conv_up4(torch.cat([resize2x(up), x8s], 1))
        up = self.conv_up3(torch.cat([resize2x(up), x4s], 1))
        up = self.conv_up2(torch.cat([resize2x(up), x2s], 1))
        up = self.conv_up1(torch.cat([resize2x(up), xc], 1))
        if self.fast_head:
            out = resize2x(self.conv8(self.conv7(up)))
        else:
            out = self.conv8(self.conv7(resize2x(up)))
        return _split_heads(out)


class FoldedResFCNResNet152(_Encoder):
    """``ResFCNResNet152``'s eval forward with batch norm folded."""

    def __init__(self, net):
        super().__init__(net)
        self.double_up1 = net.double_up1
        for name in ("conv_up4", "conv_up3", "conv_up2", "conv_up1", "conv7"):
            setattr(self, name, _conv_bn_relu(getattr(net, name)))
        for name in ("conv_up4_1", "conv_up3_1", "conv_up2_1", "conv_up1_1",
                     "conv8"):
            setattr(self, name, _Conv(getattr(net, name)))

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


_FOLDED = {fcnresnet.DenseFCNResNet152: FoldedDenseFCNResNet152,
           fcnresnet.ResFCNResNet152: FoldedResFCNResNet152}


def fold_for_serving(net):
    """The eval-only folded twin of the eval-mode ``net`` (see the module
    docstring), on its device, sharing its conv weights; counts the batch
    norms folded in ``bn.folded``."""
    folded_cls = _FOLDED.get(type(net))
    if folded_cls is None:
        raise TypeError(f"fold_for_serving takes a DenseFCNResNet152 or a "
                        f"ResFCNResNet152, got {type(net).__name__}")
    if net.training:
        raise ValueError("fold_for_serving takes an eval-mode net")
    folded = folded_cls(net).eval()
    profiling.count("bn.folded",
                    sum(isinstance(m, _Unit) for m in folded.modules()))
    return folded
