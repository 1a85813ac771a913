"""Seeded weights of a DenseFCNResNet152, made on the device.

The scheme is the program's ``init_params`` (conv kernels LeCun-normal,
truncated at two standard deviations and rescaled to variance 1/fan_in;
biases zero; batch norm scale one, shift zero, running mean zero, running
variance one), drawn here in one call a net: a uniform draw mapped
through the normal's inverse CDF between -2 and 2, then scaled per leaf.

The last layer, conv8, is seeded so that the voting region is the
object's valid-depth pixels whatever the seed: its segmentation rows give
logits around ``head["seg_bias"]`` (far above the sem threshold) and its
radius rows radii around ``head["radial_bias"]`` dm (far below the
configured maximum), each spread by the given standard deviation over
features of the assumed RMS. The network's arithmetic is unchanged, and
the program and the reference get the same weights.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness import seeds
from perfbench.reference.model import DenseFCNResNet152

# std of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
PHI_2 = 0.9772498680518208   # the unit normal's CDF at 2


def shapes(kpt_heads, blocks=(3, 8, 36, 3), width=1.0):
    """{name: shape} of the network's state dict, in its order."""
    with torch.device("meta"):
        net = DenseFCNResNet152(kpt_heads, tuple(blocks), width)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def _is_conv_weight(name, shape):
    return name.endswith(".weight") and len(shape) == 4


def make_net(seed, index, kpt_heads, head, dtype, device, blocks=(3, 8, 36, 3),
             width=1.0):
    """State dict of net ``index`` for ``seed``: every floating leaf in
    ``dtype`` on ``device``."""
    spec = shapes(kpt_heads, blocks, width)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "weights", index))
    n_conv = sum(math.prod(s) for k, s in spec.items()
                 if _is_conv_weight(k, s))
    u = torch.rand(n_conv, generator=gen, device=device)
    normal = torch.special.ndtri(u * (2 * PHI_2 - 1) + (1 - PHI_2))
    out, off = {}, 0
    for name, shape in spec.items():
        numel = math.prod(shape)
        if _is_conv_weight(name, shape):
            fan_in = numel // shape[0]
            unit = normal[off:off + numel].view(shape) / TRUNC_STD
            off += numel
            leaf = (_head_weight(unit, kpt_heads, head, fan_in)
                    if name == "conv8.weight"
                    else unit * math.sqrt(1.0 / fan_in))
            out[name] = leaf.to(dtype)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif name.endswith("running_var") or (
                name.endswith(".weight") and len(shape) == 1):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    k = kpt_heads
    bias = torch.tensor([head["seg_bias"]] * k + [head["radial_bias"]] * k,
                        device=device)
    out["conv8.bias"] = bias.to(dtype)
    return out


def _head_weight(unit, k, head, fan_in):
    """conv8's (2K, C, 1, 1) kernel from unit-variance draws: rows of
    standard deviation ``std / (feature_rms sqrt(C))``."""
    per = 1.0 / (head["feature_rms"] * math.sqrt(fan_in))
    scale = torch.tensor([head["seg_std"] * per] * k
                         + [head["radial_std"] * per] * k,
                         device=unit.device)
    return unit * scale[:, None, None, None]
