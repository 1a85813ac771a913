"""DenseFCNResNet152 in plain PyTorch float32: the benchmark's frozen
reference of the network that serving runs.

RCVPose (arXiv 2104.02527), reference ``models/fcnresnet.py``
``DenseFCNResNet152``: a ResNet-152 encoder (3/8/36/3 bottlenecks, x4
expansion, a 1x1 projection shortcut at the head of each stage), a
2048 -> 1024 conv6 neck and an FCN decoder whose 3x3 conv + BN + ReLU
stages take the bilinear x2 upsample of the stage below concatenated with
the encoder's skip; conv7 (3x3 to 32) and conv8 (1x1 to 2K) run at full
resolution, and the 2K output channels split into K segmentation logits
and K radius maps (dm). Module names follow the reference state dict, so
one state dict loads into it and into the program.

Batch norm normalizes with the running statistics (eval mode).

``quant="fp8"`` is the benchmark's control, one precision step below
the bfloat16 the configurations state: every convolution rounds its
input and its weight to float8 e4m3, each under a per-tensor scale that
maps the largest magnitude to the format's largest, and computes in f32
from the rounded operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def fp8_round(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    ``x``'s dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with the reference's SAME padding, optionally on
    fp8-rounded operands."""

    quant = None

    def forward(self, x):
        if self.quant == "fp8":
            return self._conv_forward(fp8_round(x), fp8_round(self.weight),
                                      self.bias)
        return super().forward(x)


class BatchNorm(nn.BatchNorm2d):
    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training, 0.0,
                            self.eps)


def _bn(c):
    return BatchNorm(c, eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, cin, ch, stride=1, project=False):
        super().__init__()
        self.conv1 = Conv(cin, ch, 1, bias=False)
        self.bn1 = _bn(ch)
        self.conv2 = Conv(ch, ch, 3, stride=stride, padding=1)
        self.bn2 = _bn(ch)
        self.conv3 = Conv(ch, ch * 4, 1, bias=False)
        self.bn3 = _bn(ch * 4)
        self.upsample_ = nn.Sequential(
            Conv(cin, ch * 4, 1, stride=stride, bias=False),
            _bn(ch * 4)) if project else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.upsample_ is None else self.upsample_(x)
        return F.relu(y + res)


def _stage(cin, cout):
    return nn.Sequential(Conv(cin, cout, 3, padding=1), _bn(cout), nn.ReLU())


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def scaled(c, width):
    """Channels at a width multiplier (1.0 is the published network)."""
    return max(8, int(round(c * width)))


class DenseFCNResNet152(nn.Module):
    """NHWC image batch in; ``(seg, radial)`` out, each (B, H, W, K)."""

    def __init__(self, kpt_heads=1, blocks=(3, 8, 36, 3), width=1.0,
                 quant=None):
        super().__init__()
        w = lambda c: scaled(c, width)  # noqa: E731
        self.conv1 = Conv(3, w(64), 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(w(64))
        st = tuple(w(c) for c in (64, 128, 256, 512))
        cin = w(64)
        for s, (depth, ch) in enumerate(zip(blocks, st)):
            setattr(self, f"block{s + 1}up",
                    Bottleneck(cin, ch, 1 if s == 0 else 2, project=True))
            setattr(self, f"block{s + 1}", nn.Sequential(
                *[Bottleneck(ch * 4, ch) for _ in range(1, depth)]))
            cin = ch * 4
        self.conv6 = Conv(4 * st[3], w(1024), 3, padding=1)
        self.bn6 = _bn(w(1024))
        self.conv_up5 = _stage(w(1024) + 4 * st[3], w(1024))
        self.conv_up4 = _stage(w(1024) + 4 * st[2], w(512))
        self.conv_up3 = _stage(w(512) + 4 * st[1], w(256))
        self.conv_up2 = _stage(w(256) + 4 * st[0], w(128))
        self.conv_up1 = _stage(w(128) + w(64), w(64))
        self.conv7 = _stage(w(64), w(32))
        self.conv8 = Conv(w(32), 2 * kpt_heads, 1)
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant = quant

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        xc = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(xc, 3, stride=2, padding=1)
        skips = []
        for s in range(1, 5):
            y = getattr(self, f"block{s}up")(y)
            y = getattr(self, f"block{s}")(y)
            skips.append(y)
        x2s, x4s, x8s, x16s = skips
        up = F.relu(self.bn6(self.conv6(x16s)))
        up = self.conv_up5(torch.cat([up, x16s], 1))
        up = self.conv_up4(torch.cat([_up(up), x8s], 1))
        up = self.conv_up3(torch.cat([_up(up), x4s], 1))
        up = self.conv_up2(torch.cat([_up(up), x2s], 1))
        up = self.conv_up1(torch.cat([_up(up), xc], 1))
        out = self.conv8(self.conv7(_up(up))).float()
        k = out.shape[1] // 2
        return out[:, :k].permute(0, 2, 3, 1), out[:, k:].permute(0, 2, 3, 1)
