"""The serving nets with batch norm folded (``models.folded``) and the
conv epilogue's plain version (``ops.epilogue``), on the CPU.

The folded net against the net it was folded from, in f32 on random batch
norm statistics, scales and shifts and random conv biases (conv2's, conv6's,
the decoder's); that it refuses train mode and K3/K4 nets; that its f32
scales and shifts survive dtype casts and the estimator's copies; the
``bn.folded`` counter; that ``PoseEstimator`` serves folded nets; and how
the fold's single rounding departs from the unfolded unit's at identity
statistics. The Flax parity of the folded forward is ``tests/test_torch_port_model.py``'s.
This file imports neither JAX nor the JAX package.
"""

import copy

import pytest
import torch
from torch import nn

from rcvpose_tpu_torch import profiling
from rcvpose_tpu_torch.models import fcnresnet, folded
from rcvpose_tpu_torch.ops import epilogue
from tests.torch_port_estimators import HW, estimator, random_statistics
from tests.torch_port_threads import port_threads  # noqa: F401

TINY = dict(blocks=(1, 1, 1, 1), width=0.125)
# the parity bound of tests/test_torch_port_model.py
ATOL = 1e-5
CASES = {
    "dense": (fcnresnet.DenseFCNResNet152, dict(output_channels=6)),
    "dense_fast_head": (fcnresnet.DenseFCNResNet152,
                        dict(output_channels=2, fast_head=True)),
    "res": (fcnresnet.ResFCNResNet152, dict(output_channels=2)),
    "res_double_up1": (fcnresnet.ResFCNResNet152,
                       dict(output_channels=2, double_up1=True)),
}


def _random_net(name, seed=0):
    """A tiny eval-mode net of ``CASES[name]`` with seeded conv weights and
    random batch norm statistics, scales, shifts and conv biases."""
    cls, kw = CASES[name]
    net = fcnresnet.init_params(cls(**TINY, **kw),
                                torch.Generator().manual_seed(seed))
    return random_statistics(net, seed + 1).to(
        memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def nets():
    return {name: _random_net(name) for name in CASES}


def _image(seed=7):
    return torch.randn(1, HW, HW, 3,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", sorted(CASES))
def test_folded_forward_matches_the_net(nets, name):
    """The folded net gives the net's eval forward in f32 (one rounding
    order for another), and folding leaves the net as it was."""
    net = nets[name]
    before = {k: v.clone() for k, v in net.state_dict().items()}
    f = folded.fold_for_serving(net)
    x = _image()
    with torch.no_grad():
        want = net(x)
        got = f(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in before.items())
    assert not f.training and list(f.parameters()) == []


def test_folded_scale_and_shift_are_the_batch_norms(nets):
    """A unit's scale and shift are the f32 fold of its batch norm and its
    conv's bias, and its weight is the conv's own tensor."""
    net = nets["dense"]
    f = folded.fold_for_serving(net)
    bn, conv = net.block1up.bn2, net.block1up.conv2
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    shift = bn.bias + (conv.bias - bn.running_mean) * scale
    unit = f.stages[0][0].unit2
    got_scale, got_shift = unit.affine.view(torch.float32)
    torch.testing.assert_close(got_scale, scale.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(got_shift, shift.detach(), rtol=1e-6,
                               atol=1e-7)
    assert unit.weight.data_ptr() == conv.weight.data_ptr()
    assert f.conv8.bias.data_ptr() == net.conv8.bias.data_ptr()


def test_train_mode_raises(nets):
    f = folded.fold_for_serving(nets["dense"])
    with pytest.raises(RuntimeError, match="no train mode"):
        f.train()
    with pytest.raises(RuntimeError, match="no train mode"):
        f.stages[0][0].train(True)
    assert not any(m.training for m in f.modules())
    assert f.eval() is f


def test_refuses_train_mode_nets_and_other_modules(nets):
    net = nets["res"]
    net.train()
    try:
        with pytest.raises(ValueError, match="eval-mode"):
            folded.fold_for_serving(net)
    finally:
        net.eval()
    with pytest.raises(TypeError, match="DenseFCNResNet152"):
        folded.fold_for_serving(nn.Conv2d(3, 8, 3))


def test_refuses_a_conv_kernel_net():
    with torch.device("meta"):
        net = fcnresnet.DenseFCNResNet152(conv_kernel=True, **TINY)
    with pytest.raises(ValueError, match="conv_kernel=True"):
        folded.fold_for_serving(net.eval())


def _affines(module):
    return {k: v for k, v in module.state_dict().items()
            if k.endswith("affine")}


def test_scale_and_shift_stay_f32_through_casts_and_copies(nets):
    f = folded.fold_for_serving(nets["dense"])
    want = _affines(f)
    assert len(want) == sum(isinstance(m, nn.BatchNorm2d)
                            for m in nets["dense"].modules())
    for copied in (copy.deepcopy(f).to(dtype=torch.bfloat16),
                   copy.deepcopy(f).bfloat16(), copy.deepcopy(f).half(),
                   copy.deepcopy(f).to("cpu", torch.bfloat16)):
        assert copied.conv1.weight.dtype != torch.float32
        got = _affines(copied)
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.dtype == torch.int32 and torch.equal(v, want[k]), k
            assert v.data_ptr() != want[k].data_ptr()


def test_estimator_copies_carry_f32_scale_and_shift():
    """A bf16 estimator's folded nets hold f32 scales and shifts, folded
    from the bf16 parameters; ``replicate_to`` and ``deepcopy`` carry them
    in memory of their own."""
    est = estimator(1, dtype="bfloat16")
    for copied in (est.replicate_to("cpu"), copy.deepcopy(est)):
        for old, new in zip(est.models, copied.models):
            unit = new.net.conv1
            assert unit.weight.dtype == torch.bfloat16
            assert unit.affine.view(torch.float32).dtype == torch.float32
            want, got = _affines(old), _affines(new)
            assert got.keys() == want.keys() and len(got) > 0
            for k in got:
                assert torch.equal(got[k], want[k])
                assert got[k].data_ptr() != want[k].data_ptr()


def test_bn_folded_counts_162_for_a_full_width_net():
    """Counted on a net built on ``meta``: nothing is allocated."""
    with torch.device("meta"):
        net = fcnresnet.DenseFCNResNet152(output_channels=6)
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in net.modules())
    before = profiling.counters().get("bn.folded", 0)
    f = folded.fold_for_serving(net.eval())
    assert n_bn == 162
    assert profiling.counters()["bn.folded"] - before == 162
    assert sum(isinstance(m, folded._Unit) for m in f.modules()) == 162


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_estimator_serves_folded_nets(kpt_heads):
    """Each of the estimator's nets is folded at load, and ``bn.folded``
    counts every batch norm of them."""
    before = profiling.counters().get("bn.folded", 0)
    est = estimator(kpt_heads)
    with torch.device("meta"):
        per_net = sum(isinstance(m, nn.BatchNorm2d) for m in
                      fcnresnet.DenseFCNResNet152(**TINY).modules())
    assert profiling.counters()["bn.folded"] - before == (
        per_net * len(est.models))
    for m in est.models:
        assert isinstance(m.net, folded.FoldedDenseFCNResNet152)
        assert not m.training and list(m.parameters()) == []
        with pytest.raises(RuntimeError, match="no train mode"):
            m.net.train()


# ---------------------------------------------------------------------------
# The epilogue's plain version (the kernel's yardstick on the card)
# ---------------------------------------------------------------------------

def _operands(dtype, c=16, residual=True, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c, 5, 6, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    scale = torch.rand(c, generator=gen) + 0.5
    shift = torch.randn(c, generator=gen)
    res = (torch.randn(2, c, 5, 6, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last) if residual else None)
    return x, scale, shift, res


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_epilogue_rounds_once_in_place(dtype, residual, relu):
    """In place and in x's dtype: the f32 multiply, add and residual add,
    ReLU, then one rounding; the CPU dispatch launches nothing."""
    x, scale, shift, res = _operands(dtype, residual=residual)
    c = x.shape[1]
    t = (x.double() * scale.view(1, c, 1, 1).double()).float()
    t = (t.double() + shift.view(1, c, 1, 1).double()).float()
    if residual:
        t = (t.double() + res.double()).float()
    if relu:
        t = torch.where(t < 0, 0.0, t)
    launches = epilogue.conv_epilogue_cuda.launches
    out = epilogue.conv_epilogue(x, scale, shift, res, relu)
    assert out is x and out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, t.to(dtype))
    assert epilogue.conv_epilogue_cuda.launches == launches
    if relu:
        assert (out >= 0).all()


def test_epilogue_refuses_what_it_does_not_take():
    x, scale, shift, res = _operands(torch.float32)
    with pytest.raises(ValueError, match="scale must be f32"):
        epilogue.conv_epilogue(x, scale[:-1], shift)
    with pytest.raises(ValueError, match="shift must be f32"):
        epilogue.conv_epilogue(x, scale, shift.double())
    with pytest.raises(ValueError, match="residual must be"):
        epilogue.conv_epilogue(x, scale, shift, res[:, :8])
    with pytest.raises(ValueError, match="CUDA device"):
        epilogue.conv_epilogue_cuda(x, scale, shift, res)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="inference"):
            epilogue.conv_epilogue(x.requires_grad_(), scale, shift)


@pytest.mark.parametrize("shape", [(2, 64, 40, 48), (1, 256, 30, 40)],
                         ids=["64ch", "256ch"])
def test_identity_statistics_fold_rounds_ties_toward_zero_from_x(shape):
    """At the benchmark's batch norm statistics (mean 0, var 1, weight 1,
    bias 0: scale = rsqrt(1 + 1e-5), 5e-6 below 1) a folded residual unit
    rounds ``x * scale + residual`` once; the unfolded one rounds
    ``x * scale`` back to ``x``, then breaks the exact bf16 ties of ``x +
    residual`` to even. Every output where the two differ lies on zero's
    side of ``x`` (the scale's shortfall), within that shortfall and one
    bf16 ulp; nearly all of them are exact ties; so the fold's mean error
    against f64 leans below 0 where the unfolded one's does not. This is
    why the benchmark's ``maps_rel_err`` reads higher on the folded nets
    (``chip_smoke.identity_bn_rounding`` measures it on the card)."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    c = shape[1]
    x, res = (torch.randn(*shape, generator=gen).to(torch.bfloat16)
              .contiguous(memory_format=torch.channels_last)
              for _ in range(2))
    one = torch.ones(c, dtype=torch.bfloat16)
    zero = torch.zeros(c, dtype=torch.bfloat16)
    scale = one.float() * torch.rsqrt(one.float() + 1e-5)
    fold = epilogue.conv_epilogue(x.clone(), scale, zero.float(), res)
    unfolded = F.relu(F.batch_norm(x, zero, one, one, zero, False, 0.0,
                                   1e-5) + res)
    differ = fold.view(torch.int16) != unfolded.view(torch.int16)
    gap = fold.double() - unfolded.double()
    assert differ.any()
    assert (gap[differ] * x.double()[differ] < 0).all()
    bound = (1e-5 * x.double().abs() + 2 ** -7 * torch.maximum(
        fold.double().abs(), unfolded.double().abs()))
    assert (gap.abs() <= bound).all()
    total = x.float() + res.float()
    ties = (total.view(torch.int32) & 0xFFFF) == 0x8000
    assert (differ & ties).sum() >= 0.95 * differ.sum()
    exact = torch.relu(x.double() / (1 + 1e-5) ** 0.5 + res.double())
    size = exact.abs().mean()
    assert (fold.double() - exact).mean() / size < -3e-4
    assert abs((unfolded.double() - exact).mean() / size) < 5e-5
