"""The port's training runtime against the JAX package's.

Both packages start from the same weights (a Flax ``init`` carried into the
port through ``checkpoint.from_flax_variables``) and take the same numpy
batches, in f32 on the CPU, at ``blocks=(1, 1, 1, 1)``, ``width=0.125``,
64x64, batch 2. At 64x64 the deepest stage is 2x2, so a batch-2 BN there
normalizes over 8 values, where torch's unbiased running variance would be
8/7 of Flax's biased one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcvpose_tpu import labels as jax_labels
from rcvpose_tpu import train as jax_train
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu.models import fcnresnet as jax_fcn
from rcvpose_tpu_torch import infer, labels, train
from rcvpose_tpu_torch.checkpoint import Checkpointer, from_flax_variables
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models import fcnresnet as port_fcn
from tests.test_geometry import random_pose
from tests.test_torch_port_model import _with_bn_stats

TINY = (1, 1, 1, 1)
WIDTH = 0.125
HW = 64
# metrics of one step: the same f32 sums in two frameworks' orders
METRIC_RTOL = 1e-4
# BN statistics after a step: f32 means and variances of O(1) activations
STATS_ATOL = 1e-5
# Parameter updates: within 1e-3 of the largest JAX update of the step.
# BN's E[x^2] - E[x]^2 cancellation (Flax's fast variance; torch's kernel
# uses another formula) moves the normalized activations, and so the
# grads, by up to ~1e-3 of their scale at the 2x2 deep stage
# (tests/test_train.py::test_accum_step_matches_plain_step measured ~1e-3
# between two reduction orders); a conv bias in front of a BN has a zero
# true gradient, so both updates are rounding noise of ~1e-11. Parameters
# whose update is not negligible are also held to UPDATE_REL_EACH of their
# own largest update: a real bug shows at O(1).
UPDATE_REL = 1e-3
UPDATE_REL_EACH = 2e-2


def _cfg(cls=Config, **kw):
    kw.setdefault("initial_lr", 1e-3)
    return cls(compute_dtype="float32", image_height=HW, image_width=HW,
               batch_size=2, **kw)


def synth_batch(seed, b=2, kpt_heads=1):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, HW, HW, 3)).astype(np.float32)
    radial = np.zeros((b, HW, HW), np.float32)
    radial[:, 8:24, 8:24] = rng.uniform(1, 3, size=(b, 16, 16))
    if kpt_heads > 1:
        radial = np.stack([radial * (1 + 0.1 * j) for j in range(kpt_heads)],
                          -1)
    sem = np.where(radial > 0, 1.0, -1.0).astype(np.float32)
    return {"image": img, "radial": radial, "sem": sem}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, variables=None, conv_kernel=False):
    state = train.create_state(cfg, torch.Generator().manual_seed(0),
                               blocks=TINY, width=WIDTH, device="cpu",
                               conv_kernel=conv_kernel)
    if variables is not None:
        state.model.load_state_dict(from_flax_variables(variables))
    return state


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# One jitted JAX step per optimizer, shared by the tests of this module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """{optim: (cfg, initial variables, [(variables, metrics) after each of
    two steps on the same batch])} for SGD and Adam."""
    batch = synth_batch(0)
    out = {}
    for optim in ("sgd", "adam"):
        cfg = _cfg(JaxConfig, optim=optim,
                   initial_lr=1e-3 if optim == "sgd" else 1e-4)
        state = jax_train.create_state(cfg, jax.random.PRNGKey(0),
                                       blocks=TINY, sample_shape=(1, HW, HW, 3),
                                       width=WIDTH)
        init = {"params": _np_tree(state.params),
                "batch_stats": _np_tree(state.batch_stats)}
        step = jax.jit(jax_train.train_step)
        steps = []
        for _ in range(2 if optim == "adam" else 1):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            steps.append(({"params": _np_tree(state.params),
                           "batch_stats": _np_tree(state.batch_stats)},
                          {k: float(v) for k, v in m.items()}))
        out[optim] = (dataclasses.asdict(cfg), init, steps)
    return batch, out


def _assert_metrics(got, want):
    for key in ("loss", "loss_s", "loss_r", "acc"):
        np.testing.assert_allclose(float(got[key]), want[key],
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=key)


def _assert_updates(before, after, want_before, want_after):
    """Every parameter's update within UPDATE_REL of the largest JAX update,
    and within UPDATE_REL_EACH of its own where that is not negligible."""
    d_got = {k: (after[k] - before[k]).numpy() for k in before}
    d_want = {k: (want_after[k] - want_before[k]).numpy() for k in before}
    top = max(np.abs(d).max() for d in d_want.values())
    assert top > 0
    for key in before:
        scale = np.abs(d_want[key]).max()
        atol = UPDATE_REL * top
        if scale > UPDATE_REL * top:
            atol = min(atol, UPDATE_REL_EACH * scale)
        np.testing.assert_allclose(d_got[key], d_want[key], rtol=0,
                                   atol=atol, err_msg=key)


def test_sgd_step_matches_jax(jax_steps):
    batch, steps = jax_steps
    cfg_d, init, [(after, metrics)] = steps["sgd"]
    state = _port_state(Config(**cfg_d), init)
    before = _params(state.model)
    state, m = train.train_step(state, _torch_batch(batch))
    assert state.step == 1
    _assert_metrics(m, metrics)
    want_before = from_flax_variables(init)
    want_after = from_flax_variables(after)
    _assert_updates(before, _params(state.model), want_before, want_after)
    sd = state.model.state_dict()
    for key, val in want_after.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(),
                                       rtol=0, atol=STATS_ATOL, err_msg=key)


def test_adam_two_steps_match_jax(jax_steps):
    batch, steps = jax_steps
    cfg_d, init, jsteps = steps["adam"]
    state = _port_state(Config(**cfg_d), init)
    tb = _torch_batch(batch)
    for _, metrics in jsteps:
        state, m = train.train_step(state, tb)
        _assert_metrics(m, metrics)
    assert state.step == 2


def test_accum_step_matches_jax_plain_step(jax_steps):
    """Two identical microbatches: the averaged grads equal the batch's own,
    so the accumulated SGD update is the JAX plain step's update."""
    batch, steps = jax_steps
    cfg_d, init, [(after, metrics)] = steps["sgd"]
    state = _port_state(Config(**cfg_d), init)
    before = _params(state.model)
    doubled = {k: np.concatenate([v, v]) for k, v in batch.items()}
    state, m = train.make_accum_train_step(2)(state, _torch_batch(doubled))
    assert state.step == 1
    _assert_metrics(m, metrics)
    _assert_updates(before, _params(state.model), from_flax_variables(init),
                    from_flax_variables(after))
    # BN statistics chained through both microbatches: two updates
    assert int(state.model.bn1.num_batches_tracked) == 2
    with pytest.raises(ValueError, match="not divisible"):
        train.make_accum_train_step(3)(state, _torch_batch(doubled))


def test_kernel_route_step_matches_default_route(jax_steps):
    """``conv_kernel=True`` (the decoder convs through K3/K4's plain
    versions and ``MMConv2dFunction``) against the cuDNN route's layers,
    same weights, one SGD step."""
    batch, steps = jax_steps
    cfg_d, init, _ = steps["sgd"]
    cfg = Config(**cfg_d)
    results = []
    for ck in (False, True):
        state = _port_state(cfg, init, conv_kernel=ck)
        state, m = train.train_step(state, _torch_batch(batch))
        results.append((m, _params(state.model)))
    (m0, p0), (m1, p1) = results
    for key in m0:
        np.testing.assert_allclose(float(m1[key]), float(m0[key]),
                                   rtol=1e-5, atol=1e-7)
    before = {k: v for k, v in from_flax_variables(init).items() if k in p0}
    _assert_updates(before, p1, before, p0)


def test_losses_and_schedule_match_jax():
    rng = np.random.default_rng(3)
    seg = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    rad = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    sem_t = np.sign(rng.normal(size=(2, 4, 4, 3))).astype(np.float32)
    rad_t = np.where(rng.uniform(size=(2, 4, 4, 3)) < 0.3,
                     rad + rng.choice([0.01, 1.0], size=rad.shape),
                     0.0).astype(np.float32)
    want = jax_train.losses(*(jnp.asarray(a) for a in (seg, rad, sem_t,
                                                       rad_t)))
    got = train.losses(*(torch.from_numpy(a) for a in (seg, rad, sem_t,
                                                       rad_t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    assert 0.0 < float(got[2]) < 1.0
    for spe, decay in [(10, 70), (3, 2)]:
        js = jax_train.make_lr_schedule(1e-4, spe, decay, 0.1)
        ps = train.make_lr_schedule(1e-4, spe, decay, 0.1)
        for step in (0, 1, spe * decay - 1, spe * decay, 2 * spe * decay + 5):
            assert ps(step) == pytest.approx(float(js(step)), rel=1e-12)


# ---------------------------------------------------------------------------
# Model pieces the training loss reaches
# ---------------------------------------------------------------------------

MODELS = {
    "dense": (jax_fcn.DenseFCNResNet152, port_fcn.DenseFCNResNet152),
    "res": (jax_fcn.ResFCNResNet152, port_fcn.ResFCNResNet152),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_batch_stats_after_train_forward_match_flax(name):
    """One train-mode forward updates the running statistics as Flax's
    ``mutable=["batch_stats"]`` does (biased variance, momentum 0.9), and
    normalizes with the batch's own statistics."""
    jcls, pcls = MODELS[name]
    jm = jcls(blocks=TINY, width=WIDTH)
    v = _with_bn_stats(
        jm.init(jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 3)), False), 4)
    x = synth_batch(1)["image"]
    (jseg, jrad), mutated = jm.apply(v, jnp.asarray(x), True,
                                     mutable=["batch_stats"])
    pm = pcls(blocks=TINY, width=WIDTH)
    pm.load_state_dict(from_flax_variables(v))
    pm.train()
    pseg, prad = pm(torch.from_numpy(x))
    want = from_flax_variables({"params": v["params"],
                                "batch_stats": _np_tree(
                                    mutated["batch_stats"])})
    sd = pm.state_dict()
    n_stats = 0
    for key, val in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(), rtol=0,
                                       atol=STATS_ATOL, err_msg=key)
            n_stats += 1
    assert n_stats > 20
    np.testing.assert_allclose(pseg.detach().numpy(), np.asarray(jseg),
                               atol=1e-4)
    np.testing.assert_allclose(prad.detach().numpy(), np.asarray(jrad),
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_split_heads_grad_matches_jax(dtype, channels_last):
    """The head split's backward against ``jax.vjp`` of the JAX
    ``_split_heads``: the same values, cast back to conv8's dtype, bit for
    bit, in the input's layout."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 8, 12)).astype(np.float32)
    ct_seg, ct_rad = (rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
                      for _ in range(2))
    xt = torch.from_numpy(x).to(dtype)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    seg, rad = port_fcn._split_heads(xt)
    torch.autograd.backward([seg, rad], [torch.from_numpy(ct_seg),
                                         torch.from_numpy(ct_rad)])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    nhwc = jnp.asarray(xt.detach().float().permute(0, 2, 3, 1).numpy(), jdt)
    _, vjp = jax.vjp(jax_fcn._split_heads, nhwc)
    (jgrad,) = vjp((jnp.asarray(ct_seg), jnp.asarray(ct_rad)))
    assert xt.grad.dtype == dtype
    assert xt.grad.is_contiguous(
        memory_format=torch.channels_last if channels_last
        else torch.contiguous_format)
    np.testing.assert_array_equal(
        xt.grad.float().permute(0, 2, 3, 1).numpy(),
        np.asarray(jgrad.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,ycb_clip", [(1, False), (3, False),
                                            (1, True)])
def test_make_sample_matches_jax(heads, ycb_clip):
    """The batched labels against the JAX ``make_sample`` frame by frame
    (multi-head: its vmap over keypoints, as the loader stacks them).
    Radii within 1e-5 dm, sem maps equal."""
    rng = np.random.default_rng(heads + 10 * ycb_clip)
    b, h, w = 2, 31, 41   # odd sizes: the even crop cuts a row and a column
    img = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
    depth = np.zeros((b, h, w), np.float32)
    depth[:, 5:25, 8:30] = rng.uniform(600.0, 900.0, size=(b, 20, 22))
    mask = (rng.uniform(size=(b, h, w)) < 0.8).astype(np.uint8)
    pose = np.concatenate([np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                                     for _ in range(b)]),
                           rng.normal(size=(b, 3, 1)) * 0.05
                           + np.array([0, 0, 0.7])[:, None]], axis=2)
    k = np.array([[300.0, 0, 20.5], [0, 310.0, 15.2], [0, 0, 1]], np.float32)
    kpts = (rng.normal(size=(heads, 3)) * 0.05).astype(np.float32)
    maxr = np.array([1.2, 2.0, 0.9][:heads], np.float32)
    if heads == 1:
        kpts, maxr = kpts[0], maxr[0]
    got = labels.make_sample(*(torch.from_numpy(np.asarray(a)) for a in
                               (img, depth, mask, pose)), kpts, k, maxr,
                             ycb_clip=ycb_clip)
    for i in range(b):
        def one(kp, mr, i=i):
            return jax_labels.make_sample(img[i], depth[i], mask[i], pose[i],
                                          kp, k, mr, ycb_clip=ycb_clip)
        if heads == 1:
            jimg, jrad, jsem = one(kpts, maxr)
        else:
            outs = [one(kpts[j], maxr[j]) for j in range(heads)]
            jimg = outs[0][0]
            jrad = np.stack([o[1] for o in outs], -1)
            jsem = np.stack([o[2] for o in outs], -1)
        np.testing.assert_allclose(got["image"][i].numpy(), np.asarray(jimg),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["radial"][i].numpy(), np.asarray(jrad),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["sem"][i].numpy(), np.asarray(jsem))
    assert got["image"].shape == (b, 30, 40, 3)
    assert (got["sem"] > 0).any() and (got["sem"] < 0).any()


def _cad_case(name):
    """``tests/test_labels.py``'s CAD-label cases: (cad_m, pose, kpt, k,
    max radius dm, hw)."""
    rng = np.random.default_rng(0)
    if name == "occlusion":   # a hidden point, a z-tie, then the clip
        pose = np.hstack([np.eye(3), np.zeros((3, 1))])
        cad = np.array([[0, 0, 1.0], [0, 0, 0.5], [0.05, 0, 0.7],
                        [0.12, 0, 0.7]])
        k = np.array([[8.0, 0, 4.0], [0, 8.0, 4.0], [0, 0, 1]])
        return cad, pose, np.zeros(3), k, 99.0, (8, 8)
    h, w = 24, 32
    k = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    cad = rng.normal(size=(4000 if name == "dense" else 2000, 3)) * 0.05
    pose = random_pose(rng)
    pose[:, 3] = [0.0, 0.0, 0.8]
    # off-frame and behind-camera points scatter into pixel 0
    if name == "off-frame":
        cad[:50] += [1.0, 0.0, 0.0]
        cad[50:60, 2] -= 2.0
    return cad, pose, np.array([0.06, -0.05, 0.04]), k, 8.0, (h, w)


@pytest.mark.parametrize("case", ["dense", "occlusion", "off-frame"])
def test_radial_labels_from_cad_matches_jax(case):
    """The two-scatter-min z-buffer against the JAX package's: the same sem
    map, radii within 1e-5 dm; a tightened clip zeroes everything."""
    cad, pose, kpt, k, maxr, hw = _cad_case(case)
    want = jax_labels.radial_labels_from_cad(cad, pose, kpt, k, maxr, hw=hw)
    got = labels.radial_labels_from_cad(torch.tensor(cad), pose, kpt, k,
                                        maxr, hw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    assert got[0].dtype == torch.float32 and got[0].shape == hw
    assert (got[0] > 0).any()
    if case == "occlusion":   # z = 0.5 hides z = 1.0; index 2 wins the tie
        assert abs(float(got[0][4, 4]) - 5.0) <= 1e-5
        assert abs(float(got[0][4, 5])
                   - np.linalg.norm([0.05, 0, 0.7]) * 10.0) <= 1e-4
    clipped = labels.radial_labels_from_cad(cad, pose, kpt, k, 0.1, hw)
    assert (clipped[0] == 0).all() and (clipped[1] == -1).all()


# ---------------------------------------------------------------------------
# The Trainer loop (the behaviours of tests/test_train.py, port only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_state():
    """A fresh port state to copy from (its own weights, SGD)."""
    return _port_state(_cfg(optim="sgd"))


@pytest.fixture
def one_thread():
    """One intra-op thread for a test held against the port alone. Beside
    the suite's other workers torch's default (a thread a core)
    oversubscribes the cores and the trainer's many small ops crawl (the
    loop test took 196 s there against 1 s alone). Tests held against JAX
    keep the default: their tolerances were set with its summation
    order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(tiny_state, cfg):
    state = _port_state(cfg)
    state.model.load_state_dict(tiny_state.model.state_dict())
    return state


class Writer:
    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def add_image(self, tag, img, step):
        self.images.append((tag, img, step))


@pytest.mark.usefixtures("one_thread")
def test_trainer_loop_checkpoints_and_restores(tiny_state, tmp_path):
    cfg = _cfg(optim="sgd", max_iterations=3)
    batch = synth_batch(2)
    writer = Writer()
    ckpt = Checkpointer(str(tmp_path / "ckpts"))
    trainer = train.Trainer(cfg=cfg, state=_fresh(tiny_state, cfg),
                            train_batches=lambda epoch: [batch, batch],
                            val_batches=lambda: [batch] * 50,
                            checkpointer=ckpt, writer=writer)
    final = trainer.fit(max_epochs=5)
    assert trainer.iteration == 3 and final.step == 3
    tags = {t for t, _, _ in writer.scalars}
    assert {"Train_sum", "Train_r", "Val_ACC", "Val_MAE"} <= tags
    # validation after epochs 0 and 1, one image per 50 val batches
    assert [img.shape for _, img, _ in writer.images] == [(1, HW, HW)] * 2
    # the reference layout, readable without the port
    payload = torch.load(tmp_path / "ckpts" / "ckpt.pth.tar",
                         weights_only=True)
    assert payload["arch"] == "DenseFCNResNet152"
    assert payload["iteration"] == 3 and payload["step"] == 3
    assert "conv_up5.0.weight" in payload["model_state_dict"]
    assert (tmp_path / "ckpts" / "model_best.pth.tar").exists()

    fresh = _fresh(tiny_state, cfg)
    restored, epoch, it, best = ckpt.restore(fresh)
    assert (it, epoch, restored.step) == (3, 1, 3)
    assert best == trainer.best_val
    for (k, a), b in zip(restored.model.state_dict().items(),
                         final.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    # the optimizer's momentum came back too: one more step on each agrees
    s1, _ = train.train_step(restored, _torch_batch(batch))
    s2, _ = train.train_step(final, _torch_batch(batch))
    torch.testing.assert_close(_params(s1.model), _params(s2.model), rtol=0,
                               atol=0)


@pytest.mark.usefixtures("one_thread")
def test_trainer_loss_decreases_with_accumulation(tiny_state):
    cfg = _cfg(optim="sgd", accum_steps=2, max_iterations=3, log_interval=1)
    batch = synth_batch(3, b=4, kpt_heads=3)
    cfg = dataclasses.replace(cfg, kpt_heads=3)
    state = train.create_state(cfg, torch.Generator().manual_seed(1),
                               blocks=TINY, width=WIDTH, device="cpu")
    writer = Writer()
    trainer = train.Trainer(cfg=cfg, state=state,
                            train_batches=lambda epoch: [batch] * 3,
                            val_batches=lambda: iter(()), writer=writer)
    trainer.fit(max_epochs=1)
    losses = [v for t, v, _ in writer.scalars if t == "Train_sum"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.usefixtures("one_thread")
def test_nan_loss_raises(tiny_state):
    cfg = _cfg(optim="sgd")
    bad = synth_batch(4)
    bad["image"][0, 0, 0, 0] = np.nan
    trainer = train.Trainer(cfg=cfg, state=_fresh(tiny_state, cfg),
                            train_batches=lambda epoch: [bad],
                            val_batches=lambda: [bad])
    with pytest.raises(ValueError, match="nan while training"):
        trainer.train_epoch(0)
    with pytest.raises(ValueError, match="nan while validating"):
        trainer.validate(0)


@pytest.mark.usefixtures("one_thread")
def test_resume_fast_forwards_mid_epoch(tiny_state):
    """Resume at iteration 6 with 4 steps/epoch lands in epoch 1 and skips
    its first 2 batches, consumed from the loader but not trained."""
    cfg = _cfg(optim="sgd", max_iterations=8)
    consumed, trained = [], []

    def train_batches(epoch):
        for i in range(4):
            consumed.append((epoch, i))
            yield synth_batch(i)

    def spy_step(state, batch):
        trained.append(consumed[-1])
        return train.train_step(state, batch)

    trainer = train.Trainer(cfg=cfg, state=_fresh(tiny_state, cfg),
                            train_batches=train_batches,
                            val_batches=lambda: iter(()),
                            steps=(spy_step, train.eval_step),
                            steps_per_epoch=4, iteration=6)
    trainer.fit(max_epochs=2)
    assert trained == [(1, 2), (1, 3)]
    assert trainer.iteration == 8


@pytest.mark.usefixtures("one_thread")
def test_resume_index_level_skip_protocol(tiny_state):
    """A factory whose second parameter is ``start_batch`` gets the skip as
    a start index, and the Trainer discards nothing itself."""
    cfg = _cfg(optim="sgd", max_iterations=8)
    calls = []

    def train_batches(epoch, start_batch=0):
        calls.append((epoch, start_batch))
        for i in range(start_batch, 4):
            yield synth_batch(i)

    trainer = train.Trainer(cfg=cfg, state=_fresh(tiny_state, cfg),
                            train_batches=train_batches,
                            val_batches=lambda: iter(()),
                            steps_per_epoch=4, iteration=6)
    trainer.fit(max_epochs=2)
    assert calls == [(1, 2)]
    assert trainer.iteration == 8


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("interval,max_epochs,want", [(1, 3, 3), (2, 4, 2),
                                                      (3, 4, 2)])
def test_val_interval_epochs(tiny_state, interval, max_epochs, want):
    """Validation every val_interval_epochs, and always after the final
    epoch (interval 3 over 4 epochs: epoch 2, then the final epoch 3)."""
    cfg = _cfg(optim="sgd", max_iterations=10_000,
               val_interval_epochs=interval)
    val_calls = []

    def val_batches():
        val_calls.append(1)
        return iter(())

    trainer = train.Trainer(cfg=cfg, state=_fresh(tiny_state, cfg),
                            train_batches=lambda epoch: [synth_batch(epoch)],
                            val_batches=val_batches, steps_per_epoch=1)
    trainer.fit(max_epochs=max_epochs)
    assert len(val_calls) == want


def test_create_state_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.create_state(_cfg(), torch.Generator().manual_seed(0),
                           blocks=TINY, width=WIDTH)


@pytest.mark.usefixtures("one_thread")
def test_remat_trains_and_serving_takes_it(tiny_state):
    """``Config.remat`` (the JAX package's ``nn.remat`` per Bottleneck)
    trains: ``create_state`` builds the model with its encoder blocks
    rematerialized and a ``Trainer`` takes a step with it
    (``tests/test_torch_port_remat.py`` holds the step against the plain
    and the JAX step). ``build_model`` and the serving estimator take the
    same config: a forward without gradients keeps no activations to
    rematerialize."""
    cfg = _cfg(remat=True, optim="sgd", max_iterations=1)
    state = train.create_state(cfg, torch.Generator().manual_seed(0),
                               blocks=TINY, width=WIDTH, device="cpu")
    assert state.model.remat
    writer = Writer()
    trainer = train.Trainer(cfg=cfg, state=state,
                            train_batches=lambda epoch: [synth_batch(6)],
                            val_batches=lambda: [], writer=writer)
    trainer.fit(max_epochs=1)
    assert trainer.iteration == 1 and state.step == 1
    assert np.isfinite([v for t, v, _ in writer.scalars
                        if t == "Train_sum"]).all()
    serve_cfg = Config(remat=True, compute_dtype="float32",
                       model_blocks="1,1,1,1", model_width=WIDTH)
    model = train.build_model(serve_cfg)
    port_fcn.init_params(model, torch.Generator().manual_seed(0))
    est = infer.PoseEstimator(serve_cfg, [model.state_dict()] * 3,
                              np.zeros((9, 3)), [2.0] * 3, device="cpu")
    x = torch.zeros(1, HW, HW, 3)
    with torch.no_grad():
        seg, radial = est.models[0](x)
    assert seg.shape == radial.shape == (1, HW, HW, 1)
