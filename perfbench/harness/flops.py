"""Operations of the network, counted from its layer shapes, and the
card's peak: the yardstick of the ``mfu`` metrics.

Only convolutions count, as ``torch.utils.flop_counter.FlopCounterMode``
counts them (the network has no matrix product): 2 x batch x C_out x
C_in x kh x kw x H_out x W_out. The shapes come from the benchmark's own
copy of the network on the meta device, so no change to the program can
move the count.
"""

from __future__ import annotations

import functools

import torch

from perfbench.reference.model import Conv, DenseFCNResNet152

# Dense bfloat16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's data
# sheet, at the 700 W limit), FLOP/s.
H100_BF16_PEAK = 989.4e12


@functools.lru_cache(maxsize=None)
def conv_flops(h, w, kpt_heads, blocks=(3, 8, 36, 3), width=1.0):
    """The forward FLOPs of each convolution of one (1, h, w, 3)
    forward."""
    with torch.device("meta"):
        net = DenseFCNResNet152(kpt_heads, tuple(blocks), width)
        out = []

        def hook(m, inputs, y):
            kh, kw = m.kernel_size
            out.append(2 * y.shape[0] * y.shape[1] * m.in_channels * kh * kw
                       * y.shape[2] * y.shape[3])

        for m in net.modules():
            if isinstance(m, Conv):
                m.register_forward_hook(hook)
        net(torch.empty(1, h, w, 3))
    return tuple(out)


def forward_flops(h, w, kpt_heads, blocks=(3, 8, 36, 3), width=1.0):
    """FLOPs of one image's forward."""
    return sum(conv_flops(h, w, kpt_heads, tuple(blocks), width))
