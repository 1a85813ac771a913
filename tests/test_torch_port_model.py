"""The port's models and head split against the JAX package's Flax models.

The same seeded weights (a Flax ``init`` plus non-trivial BN statistics
made with numpy) go through ``checkpoint.from_flax_variables`` into the
port; the same numpy image goes through both forwards in f32 on the CPU,
the port's also with its batch norm folded for serving.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcvpose_tpu.models import fcnresnet as jax_fcn
from rcvpose_tpu_torch.checkpoint import from_flax_variables
from rcvpose_tpu_torch.models import fcnresnet as port_fcn
from rcvpose_tpu_torch.models.folded import fold_for_serving
from rcvpose_tpu_torch.ops import heads

TINY = (1, 1, 1, 1)
WIDTH = 0.125
HW = 64
# f32 forward tolerance, the bound of tests/test_torch_parity.py
ATOL = 1e-5

CASES = {
    "dense_k1": (jax_fcn.DenseFCNResNet152, port_fcn.DenseFCNResNet152,
                 dict(output_channels=2)),
    "dense_k3": (jax_fcn.DenseFCNResNet152, port_fcn.DenseFCNResNet152,
                 dict(output_channels=6)),
    "res": (jax_fcn.ResFCNResNet152, port_fcn.ResFCNResNet152,
            dict(output_channels=2)),
}


def _with_bn_stats(variables, seed):
    """Replace the zero/one BN statistics of a fresh init with random ones,
    so the bridge's mean/var mapping is exercised."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "mean":
                out[key] = rng.normal(0.0, 0.1, np.shape(val)).astype(
                    np.float32)
            else:
                out[key] = rng.uniform(0.5, 1.5, np.shape(val)).astype(
                    np.float32)
        return out

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": fill(variables["batch_stats"])}


def _with_random_affine(variables, seed):
    """Replace the one/zero BN scales and shifts and the zero conv biases of
    a fresh init with random ones, so the serving fold (``models.folded``)
    folds every term."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "bias":
                out[key] = rng.normal(0.0, 0.1, np.shape(val)).astype(
                    np.float32)
            elif key == "scale":
                out[key] = rng.uniform(0.5, 1.5, np.shape(val)).astype(
                    np.float32)
            else:
                out[key] = val
        return out

    return {**variables, "params": fill(variables["params"])}


@pytest.fixture(scope="module")
def pairs():
    """(jax model, flax variables, port model) for every case."""
    out = {}
    for i, (name, (jcls, pcls, kw)) in enumerate(sorted(CASES.items())):
        jm = jcls(blocks=TINY, width=WIDTH, **kw)
        v = jm.init(jax.random.PRNGKey(i), jnp.zeros((1, HW, HW, 3)), False)
        v = _with_random_affine(_with_bn_stats(v, seed=100 + i), 200 + i)
        pm = pcls(blocks=TINY, width=WIDTH, **kw).eval()
        pm.load_state_dict(from_flax_variables(v))
        out[name] = (jm, v, pm)
    return out


@pytest.mark.parametrize("folded", [False, True],
                         ids=["unfolded", "folded"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_flax(pairs, name, folded):
    """The port's eval forward, and its serving form with batch norm folded
    (``models.folded``), against the Flax forward on random statistics."""
    jm, v, pm = pairs[name]
    if folded:
        pm = fold_for_serving(pm)
    x = np.random.default_rng(7).normal(size=(1, HW, HW, 3)).astype(
        np.float32)
    jseg, jrad = jm.apply(v, jnp.asarray(x), False)
    with torch.no_grad():
        pseg, prad = pm(torch.from_numpy(x))
    assert pseg.dtype == torch.float32 and pseg.shape == jseg.shape
    np.testing.assert_allclose(pseg.numpy(), np.asarray(jseg), atol=ATOL)
    np.testing.assert_allclose(prad.numpy(), np.asarray(jrad), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_covers_every_parameter(pairs, name):
    """Every Flax leaf lands on exactly one port tensor of the same shape:
    nothing missing, nothing extra (BN's num_batches_tracked aside, which
    has no Flax counterpart)."""
    _, v, pm = pairs[name]
    sd = from_flax_variables(v)
    n_leaves = len(jax.tree.leaves(v))
    assert len(sd) == n_leaves
    want = {k: tuple(t.shape) for k, t in pm.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert {k: tuple(t.shape) for k, t in sd.items()} == want


def test_bridge_rejects_unknown_paths():
    with pytest.raises(KeyError):
        from_flax_variables({"params": {"mystery": {"kernel": np.zeros(1)}}})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_head_split_plain_matches_jax(dtype, channels_last):
    """The plain head split against the JAX ``_split_heads`` (whose Pallas
    copy is an identity off the TPU)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 8, 12)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    cm = heads.heads_channel_major(xt)
    assert cm.is_contiguous() and cm.dtype == torch.float32
    seg, rad = port_fcn._split_heads(xt)
    nhwc = xt.float().permute(0, 2, 3, 1).numpy()
    jseg, jrad = jax_fcn._split_heads(jnp.asarray(nhwc))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(rad.numpy(), np.asarray(jrad))


def _cotangent(kind, c, b=3, h=5, w=16):
    """A (2K, B, H, W) f32 cotangent laid out as ``kind``."""
    if kind == "strided":
        return torch.zeros(c, b, w, h).transpose(2, 3)
    if kind == "permuted":
        return torch.zeros(b, c, h, w).permute(1, 0, 2, 3)
    if kind == "misaligned":
        return torch.zeros(c * b * h * w + 1)[1:].view(c, b, h, w)
    return torch.zeros(c, b, h, w)


@pytest.mark.parametrize("kind,c,channels_last,branch", [
    ("contiguous", 2, True, "rows"), ("contiguous", 6, True, "rows"),
    ("contiguous", 8, True, "rows"), ("contiguous", 10, True, "generic"),
    ("contiguous", 2, False, "planes"), ("contiguous", 6, False, "planes"),
    ("misaligned", 2, True, "rows"), ("misaligned", 6, False, "planes"),
    ("strided", 2, True, "generic"), ("strided", 2, False, "generic"),
    ("permuted", 6, True, "generic"), ("permuted", 2, False, "generic")])
def test_head_split_backward_branch(kind, c, channels_last, branch):
    """K2's backward takes its vectorized branches exactly where g is
    contiguous (a misaligned base included: such runs go scalar inside the
    kernel), "rows" only for a 2K it is built for, and "generic" for every
    strided g; the plain backward is the same relayout on each."""
    g = _cotangent(kind, c)
    assert heads.bwd_branch(g, channels_last) == branch
    g = torch.arange(g.numel(), dtype=torch.float32).reshape(
        g.shape).as_strided(g.shape, g.stride()) if kind == "contiguous" \
        else g.copy_(torch.randn(g.shape))
    got = heads.heads_channel_major_bwd_plain(g, torch.bfloat16,
                                              channels_last)
    assert torch.equal(got, g.permute(1, 0, 2, 3).to(torch.bfloat16))
    assert heads._is_channels_last(got) == channels_last


def test_head_split_backward_branch_many_planes():
    """An NCHW output of more than 65535 planes (the planes grid's y) takes
    the generic branch."""
    g = torch.empty(2, 40000, 1, 1)
    assert heads.bwd_branch(g, False) == "generic"
    assert heads.bwd_branch(torch.empty(2, 30000, 1, 1), False) == "planes"


def _head_output(kind, c, b=3, h=5, w=16):
    """conv8's (B, 2K, H, W) output laid out as ``kind``."""
    if kind == "channels-last":
        return torch.randn(b, h, w, c).permute(0, 3, 1, 2)
    if kind == "misaligned channels-last":
        return torch.randn(b * h * w * c + 1)[1:].view(b, h, w, c).permute(
            0, 3, 1, 2)
    if kind == "misaligned NCHW":
        return torch.randn(b * c * h * w + 1)[1:].view(b, c, h, w)
    if kind == "strided":
        return torch.randn(b, c, w, h).transpose(2, 3)
    if kind == "permuted":
        return torch.randn(b, h, c, w).permute(0, 2, 1, 3)
    return torch.randn(b, c, h, w)


@pytest.mark.parametrize("kind,c,branch", [
    ("channels-last", 2, "rows"), ("channels-last", 6, "rows"),
    ("channels-last", 8, "rows"), ("channels-last", 10, "generic"),
    ("misaligned channels-last", 2, "rows"), ("NCHW", 2, "planes"),
    ("NCHW", 6, "planes"), ("misaligned NCHW", 6, "planes"),
    ("strided", 2, "generic"), ("permuted", 6, "generic")])
def test_head_split_forward_branch(kind, c, branch):
    """K2 takes its vectorized branches exactly where conv8's output is
    contiguous in one of the two layouts (a misaligned base included: such
    runs go scalar inside the kernel), "rows" only for a 2K it is built
    for, and "generic" for every strided view; the plain forward is the
    same relayout on each."""
    x = _head_output(kind, c)
    assert heads.fwd_branch(x) == branch
    got = heads.heads_channel_major_plain(x.to(torch.bfloat16))
    assert got.is_contiguous() and got.dtype == torch.float32
    assert torch.equal(got, x.to(torch.bfloat16).float().permute(1, 0, 2, 3))


def test_head_split_forward_branch_many_planes():
    """An NCHW input of more than 65535 planes (the planes grid's y) takes
    the generic branch."""
    assert heads.fwd_branch(torch.empty(40000, 2, 1, 2)) == "generic"
    assert heads.fwd_branch(torch.empty(30000, 2, 1, 2)) == "planes"
