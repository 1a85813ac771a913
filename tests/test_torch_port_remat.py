"""``Config.remat`` in the port's training against the plain step and the
JAX package's ``remat=True`` step, on the CPU.

Remat recomputes each encoder Bottleneck in the backward
(``torch.utils.checkpoint``). The recompute runs the same ops on the same
inputs, so on the CPU the remat step equals the plain port step bit for
bit (gradients, updates, BN statistics, metrics). Against the JAX
``nn.remat`` step the bounds are ``test_torch_port_train.py``'s
(``UPDATE_REL``, ``STATS_ATOL``, ``METRIC_RTOL``). The replay's batch
norms must not move the running statistics a second time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcvpose_tpu import train as jax_train
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu_torch import train
from rcvpose_tpu_torch.checkpoint import from_flax_variables
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models.fcnresnet import BatchNorm2d
from tests.test_torch_port_train import (HW, STATS_ATOL, TINY, WIDTH,
                                         _assert_metrics, _assert_updates,
                                         _cfg, _np_tree, _params,
                                         _port_state, _torch_batch,
                                         synth_batch)


@pytest.fixture(scope="module")
def jax_remat_step():
    """(batch, cfg dict, initial variables, variables and metrics after
    one jitted JAX SGD step with ``remat=True``)."""
    batch = synth_batch(0)
    cfg = _cfg(JaxConfig, optim="sgd", remat=True)
    state = jax_train.create_state(cfg, jax.random.PRNGKey(0), blocks=TINY,
                                   sample_shape=(1, HW, HW, 3), width=WIDTH)
    init = {"params": _np_tree(state.params),
            "batch_stats": _np_tree(state.batch_stats)}
    state, m = jax.jit(jax_train.train_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    after = {"params": _np_tree(state.params),
             "batch_stats": _np_tree(state.batch_stats)}
    return batch, dataclasses.asdict(cfg), init, after, \
        {k: float(v) for k, v in m.items()}


def _step(cfg, init, batch, accum=1):
    state = _port_state(cfg, init)
    before = _params(state.model)
    step = train.make_accum_train_step(accum) if accum > 1 \
        else train.train_step
    state, m = step(state, _torch_batch(batch))
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return before, state, m, grads


def test_remat_step_equals_the_plain_step_and_jax(jax_remat_step):
    batch, cfg_d, init, after, metrics = jax_remat_step
    cfg = Config(**cfg_d)
    assert cfg.remat and train.build_model(cfg, TINY, WIDTH).remat
    before, rs, rm, rg = _step(cfg, init, batch)
    _, ps, pm, pg = _step(dataclasses.replace(cfg, remat=False), init, batch)
    for key in pm:
        assert float(rm[key]) == float(pm[key]), key
    for name, g in pg.items():
        torch.testing.assert_close(rg[name], g, rtol=0, atol=0, msg=name)
    psd = ps.model.state_dict()
    for key, val in rs.model.state_dict().items():
        torch.testing.assert_close(val, psd[key], rtol=0, atol=0, msg=key)
    # against the JAX nn.remat step
    _assert_metrics(rm, metrics)
    want = from_flax_variables(after)
    _assert_updates(before, _params(rs.model), from_flax_variables(init),
                    want)
    sd = rs.model.state_dict()
    for key, val in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(), rtol=0,
                                       atol=STATS_ATOL, err_msg=key)


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_updates_bn_statistics_once_per_forward(jax_remat_step,
                                                      accum):
    """Every BN's running statistics move once per train-mode forward (one
    a microbatch under accumulation), as without remat, although the
    backward re-runs each encoder block's BNs."""
    batch, cfg_d, init, _, _ = jax_remat_step
    cfg = Config(**cfg_d)
    if accum > 1:
        batch = {k: np.concatenate([v, v]) for k, v in batch.items()}
    replays = []
    orig = BatchNorm2d.forward

    def spy(self, x):
        replays.append(self)
        return orig(self, x)

    BatchNorm2d.forward = spy
    try:
        _, rs, _, _ = _step(cfg, init, batch, accum)
        calls = len(replays)
        _, ps, _, _ = _step(dataclasses.replace(cfg, remat=False), init,
                            batch, accum)
    finally:
        BatchNorm2d.forward = orig
    plain_calls = len(replays) - calls
    n_bn = sum(isinstance(m, BatchNorm2d) for m in rs.model.modules())
    encoder_bn = sum(isinstance(m, BatchNorm2d) for name, m in
                     rs.model.named_modules() if name.startswith("block"))
    # the replay re-runs the encoder blocks' BNs, and only those
    assert calls == plain_calls + accum * encoder_bn and encoder_bn > 0
    assert plain_calls == accum * n_bn
    psd = ps.model.state_dict()
    for key, val in rs.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(val) == accum, key
        torch.testing.assert_close(val, psd[key], rtol=0, atol=0, msg=key)


def test_remat_forward_without_grad_skips_the_checkpoint():
    """Serving and evaluation run without gradients: remat changes
    nothing there (no checkpoint, no replay)."""
    cfg = _cfg(remat=True)
    state = train.create_state(cfg, torch.Generator().manual_seed(0),
                               blocks=TINY, width=WIDTH, device="cpu")
    x = torch.from_numpy(synth_batch(3)["image"])
    state.model.eval()
    with torch.no_grad():
        seg, radial = state.model(x)
    plain = train.build_model(dataclasses.replace(cfg, remat=False), TINY,
                              WIDTH)
    plain.load_state_dict(state.model.state_dict())
    plain.eval()
    with torch.no_grad():
        want = plain(x)
    torch.testing.assert_close(seg, want[0], rtol=0, atol=0)
    torch.testing.assert_close(radial, want[1], rtol=0, atol=0)
