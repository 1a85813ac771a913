"""The port's decoder conv (K3/K4's plain versions and ``MMConv2dFunction``)
against the JAX package's Pallas conv, run in the Pallas interpreter.

Inputs are made with numpy from a seed and go through both packages in f32
on the CPU (bf16 where stated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rcvpose_tpu.models import fcnresnet as jax_fcn
from rcvpose_tpu.ops.mmconv_pallas import (conv_same_pallas,
                                           conv_same_pallas_dk,
                                           mmconv2d_pallas)
from rcvpose_tpu_torch.checkpoint import from_flax_variables
from rcvpose_tpu_torch.models import fcnresnet as port_fcn
from rcvpose_tpu_torch.ops import mmconv
from rcvpose_tpu_torch.scripts import prof_conv
from tests.test_torch_port_cuda import CONV_SHAPES
from tests.test_torch_port_model import _with_bn_stats

# (B, H, W, C, D, K) of tests/test_mmconv_pallas.py: thin and wide (130)
# channels, K = 5, heights that take different row tiles there
SHAPES = [
    (2, 16, 24, 8, 4, 3),
    (1, 32, 20, 5, 7, 3),
    (2, 8, 16, 130, 12, 3),
    (1, 20, 16, 6, 3, 5),
]
# f32 sums of up to K*K*C products in two orders: 1e-5 (the bound of
# tests/test_mmconv_pallas.py); dk sums B*H*W products per entry, hence
# its looser atol.
RTOL, ATOL, DK_ATOL = 1e-5, 1e-5, 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _problem(shape, seed=0):
    b, h, w, c, d, k = shape
    return (_rand((b, h, w, c), seed), _rand((k, k, c, d), seed + 1, 0.1),
            _rand((b, h, w, d), seed + 2))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_same_plain_matches_pallas(shape):
    x, kern, _ = _problem(shape)
    want = conv_same_pallas(jnp.asarray(x), jnp.asarray(kern), interpret=True)
    got = mmconv.conv_same_plain(torch.from_numpy(x), torch.from_numpy(kern))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_same_dk_plain_matches_pallas(shape):
    x, kern, g = _problem(shape)
    ks = kern.shape[0]
    want = conv_same_pallas_dk(jnp.asarray(x), jnp.asarray(g), ks,
                               interpret=True)
    got = mmconv.conv_same_dk_plain(torch.from_numpy(x), torch.from_numpy(g),
                                    ks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=DK_ATOL)


def test_conv_same_plain_bf16_within_one_ulp_of_pallas():
    """bf16 in, f32 accumulation, one rounding: the two differ at most by
    the one bf16 ulp that a different f32 summation order can flip."""
    x, kern, _ = _problem(SHAPES[2])
    xb, kb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, kern))
    want = conv_same_pallas(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(kb.float().numpy(), jnp.bfloat16),
                            interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = mmconv.conv_same_plain(xb, kb)
    assert got.dtype == torch.bfloat16
    ulp = torch.finfo(torch.bfloat16).eps * want.abs().clamp(min=1e-30)
    assert ((got.float() - want).abs() <= ulp).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mmconv_function_grads_match_jax_and_conv2d(shape):
    """dx and dk of ``MMConv2dFunction`` against ``jax.grad`` of
    ``mmconv2d_pallas`` (interpreter) and against ``F.conv2d``'s autograd,
    for sum(sin(conv))."""
    x, kern, _ = _problem(shape)

    def loss_jax(x, kern):
        return jnp.sum(jnp.sin(mmconv2d_pallas(x, kern, True)))

    jdx, jdk = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(kern))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(kern).requires_grad_()
    torch.sin(mmconv.MMConv2dFunction.apply(xt, kt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(jdk), rtol=RTOL,
                               atol=DK_ATOL)

    xc = torch.from_numpy(x).requires_grad_()
    kc = torch.from_numpy(kern).requires_grad_()
    ks = kern.shape[0]
    ref = F.conv2d(xc.permute(0, 3, 1, 2), kc.permute(3, 2, 0, 1),
                   padding=ks // 2)
    torch.sin(ref).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xc.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(kt.grad.numpy(), kc.grad.numpy(), rtol=RTOL,
                               atol=DK_ATOL)


@pytest.mark.parametrize("ks", [3, 5])
def test_mmconv_function_gradcheck_f64(ks):
    g = torch.Generator().manual_seed(ks)
    x = torch.randn(2, 7, 5, 3, dtype=torch.float64, generator=g)
    kern = torch.randn(ks, ks, 3, 2, dtype=torch.float64, generator=g)
    assert torch.autograd.gradcheck(mmconv.MMConv2dFunction.apply,
                                    (x.requires_grad_(),
                                     kern.requires_grad_()))


def test_dk_slices_bound_the_scratch():
    """K4's split of the pixel reduction: in f32 every pixel in exactly one
    32-aligned slice; in bf16 every slice holds at least one 8x8 pixel
    tile; both keep the f32 partial sums within the scratch bound at the
    decoder's full-width shapes (batch 4, 480x640) on a 132-multiprocessor
    card."""
    for b, h, w, c, d in [(4, 15, 20, 3072, 1024), (4, 240, 320, 192, 64),
                          (4, 480, 640, 64, 32), (1, 37, 1, 5, 7)]:
        pixels = b * h * w
        f32 = mmconv.plan_conv("dk", b, h, w, c, d, 3, torch.float32, 132)
        per, n = f32.tile_m[1], f32.splits
        assert per % 32 == 0 and (n - 1) * per < pixels <= n * per
        bf = mmconv.plan_conv("dk", b, h, w, mmconv.round8(c),
                              mmconv.round8(d), 3, torch.bfloat16, 132)
        tiles = b * -(-h // 8) * -(-w // 8)
        assert bf.splits <= tiles
        for plan, cc, dd in ((f32, c, d), (bf, mmconv.round8(c),
                                           mmconv.round8(d))):
            assert (plan.partials == 1
                    or plan.partials * 9 * cc * dd * 4
                    <= mmconv.SCRATCH_BYTES)
    # conv_up5's 113 MB dk takes one partial, written in place
    assert mmconv.plan_conv("dk", 4, 15, 20, 3072, 1024, 3, torch.bfloat16,
                            132).partials == 1


# The decoder convs of the card tests' train step (blocks (1,1,1,1), width
# 0.125, batch 2, 64x64): (H = W, C, D)
SMALL_DECODER = [(2, 384, 128), (4, 256, 64), (8, 128, 32), (16, 64, 16),
                 (32, 24, 8), (64, 8, 8)]
# The planner's cases: the 18 entries of a training step's decoder convs
# (forward, dx, dk), the small net's, and the card tests' shapes in every
# direction
PLAN_CASES = (
    [(part, (4, h, w, c, d, 3)) for _, h, w, c, d in prof_conv.DECODER
     for part in ("fwd", "dx", "dk")]
    + [(part, (2, hw, hw, c, d, 3)) for hw, c, d in SMALL_DECODER
       for part in ("fwd", "dx", "dk")]
    + [(part, shape) for shape in CONV_SHAPES
       for part in ("fwd", "dx", "dk")])


@pytest.mark.parametrize("part,shape", PLAN_CASES, ids=str)
def test_planner_fits_the_card(part, shape):
    """Every plan fits an H100 block (<= 232,448 bytes of shared memory,
    a ring of >= 2 stages), names a built kernel with a tile width wgmma
    takes, splits the same way on every call, and launches at least one
    block per multiprocessor wherever its split cap allows."""
    b, h, w, c, d, k = shape
    c, d = mmconv.round8(c), mmconv.round8(d)
    if part == "dx":
        c, d = d, c
    direction = "dk" if part == "dk" else "fwd"
    plan = mmconv.plan_conv(direction, b, h, w, c, d, k, torch.bfloat16, 132)
    assert plan == mmconv.plan_conv(direction, b, h, w, c, d, k,
                                    torch.bfloat16, 132)
    assert plan.smem_bytes <= mmconv.SMEM_LIMIT == 232_448
    assert plan.stages >= 2 and plan.splits >= 1 and plan.partials >= 1
    assert plan.tile_n % 8 == 0 and 8 <= plan.tile_n <= 256
    if direction == "fwd":
        assert (plan.tile_k, plan.tile_n, plan.blocks_per_sm,
                plan.promote > 0) in mmconv.BUILT_FWD
        assert plan.smem_bytes <= (mmconv.SMEM_LIMIT if plan.blocks_per_sm == 1
                                   else mmconv.SMEM_LIMIT_2)
        th, tw = plan.tile_m
        assert tw % 8 == 0 and th * tw <= 128
    else:
        assert (plan.tile_n, plan.taps) in mmconv.BUILT_DK
        assert plan.taps == 1 or k == 3
    most = mmconv.plan_conv(direction, b, h, w, c, d, k, torch.bfloat16,
                            10 ** 6)
    assert plan.units >= 132 or plan.splits == most.splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_channel_padding_is_exact(shape, dtype):
    """The bf16 wrappers' zero padding of C and D to multiples of 8 (and
    their aligned copy of a misaligned view) changes nothing: the plain
    versions on the padded operands, sliced, equal the unpadded results
    bit for bit. The operands are small integers, so that every sum is
    exact in f32 whatever order the CPU's matmul takes (its blocking
    changes with the reduction length, and with it the rounding of
    random operands)."""
    x, kern, g = (torch.from_numpy(np.round(4 * np.tanh(a))).to(dtype)
                  for a in _problem(shape))
    ks, c, d = kern.shape[0], x.shape[3], g.shape[3]
    cp, dp = mmconv.round8(c), mmconv.round8(d)
    xp, gp = mmconv.pad_channels(x, cp), mmconv.pad_channels(g, dp)
    kp = mmconv.pad_kernel(kern, cp, dp)
    assert xp.shape[3] == cp and gp.shape[3] == dp
    assert xp.data_ptr() % 16 == 0 and kp.shape == (ks, ks, cp, dp)
    assert torch.equal(mmconv.conv_same_plain(xp, kp)[..., :d],
                       mmconv.conv_same_plain(x, kern))
    assert torch.equal(mmconv.conv_same_dk_plain(xp, gp, ks)[:, :, :c, :d],
                       mmconv.conv_same_dk_plain(x, g, ks))
    flat = torch.cat([torch.zeros(1, dtype=dtype), x.reshape(-1)])
    view = flat[1:].view(x.shape)
    assert view.data_ptr() % 16 != 0
    moved = mmconv.pad_channels(view, c)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x)


MODELS = {
    "dense": (jax_fcn.DenseFCNResNet152, port_fcn.DenseFCNResNet152),
    "res": (jax_fcn.ResFCNResNet152, port_fcn.ResFCNResNet152),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_kernel_route_forward_matches_jax_pallas(name, monkeypatch):
    """The port's ``conv_kernel=True`` model against the JAX model with
    ``RCVPOSE_PALLAS_CONV=interpret``, f32, eval mode: atol 1e-5 (the
    forward bound of tests/test_torch_port_model.py)."""
    jcls, pcls = MODELS[name]
    jm = jcls(blocks=(1, 1, 1, 1), width=0.125)
    v = _with_bn_stats(
        jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)), False), 9)
    x = _rand((1, 64, 64, 3), 11)
    monkeypatch.setenv("RCVPOSE_PALLAS_CONV", "interpret")
    jseg, jrad = jm.apply(v, jnp.asarray(x), False)
    pm = pcls(blocks=(1, 1, 1, 1), width=0.125, conv_kernel=True).eval()
    plain = pcls(blocks=(1, 1, 1, 1), width=0.125).eval()
    # the kernel layers keep nn.Conv2d's state-dict names
    assert pm.state_dict().keys() == plain.state_dict().keys()
    pm.load_state_dict(from_flax_variables(v))
    n_kernel = sum(isinstance(m, port_fcn.MMConv2d) for m in pm.modules())
    assert n_kernel == (6 if name == "dense" else 5)
    with torch.no_grad():
        pseg, prad = pm(torch.from_numpy(x))
    np.testing.assert_allclose(pseg.numpy(), np.asarray(jseg), atol=1e-5)
    np.testing.assert_allclose(prad.numpy(), np.asarray(jrad), atol=1e-5)


def test_kernel_layer_weight_grad_is_f32_under_bf16_autocast():
    """Under bf16 autocast the layer casts x and the weight outside the
    Function, so the f32 parameter gets an f32 gradient."""
    conv = port_fcn.MMConv2d(8, 4, 3, padding=1)
    x = torch.randn(2, 8, 6, 10).contiguous(memory_format=torch.channels_last)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = conv(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 6, 10)
    out.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    assert conv.bias.grad.dtype == torch.float32
