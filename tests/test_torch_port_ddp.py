"""The port's multi-process training against the JAX package's global batch.

Two gloo ranks of batch 2 (``train.make_parallel_steps`` over a process
group, spawned by ``parallel.run_ranks``) against the JAX package's
``make_parallel_steps(data_mesh(2))`` at batch 4 on the same seeded rows
and weights, in f32 on the CPU at ``blocks=(1, 1, 1, 1)``, ``width=0.125``,
64x64, held to the single-device step's tolerances of
``test_torch_port_train.py``. The rows of rank 0 carry large masks and those
of rank 1 small ones, so a per-rank loss normalizer would show.

The rank workers are module-level functions that import neither JAX nor
the JAX package: the spawned processes import this module.
"""

import os

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import parallel, train
from rcvpose_tpu_torch.checkpoint import Checkpointer, from_flax_variables
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models import fcnresnet

TINY = (1, 1, 1, 1)
WIDTH = 0.125
HW = 64
RANK_TIMEOUT = 240.0
# the mask side of each global row: rank 0 holds rows 0-1, rank 1 rows 2-3
MASK_SIDES = (40, 36, 4, 3)


def _cfg(cls=Config, optim="adam", batch_size=2, **kw):
    """SGD at lr 1e-3 and Adam at 1e-4, as in test_torch_port_train.py."""
    kw.setdefault("initial_lr", 1e-3 if optim == "sgd" else 1e-4)
    return cls(compute_dtype="float32", image_height=HW, image_width=HW,
               batch_size=batch_size, optim=optim, **kw)


def global_batch(seed, sides=MASK_SIDES):
    """Four rows whose radial masks have the given sides."""
    rng = np.random.default_rng(seed)
    b = len(sides)
    img = rng.normal(size=(b, HW, HW, 3)).astype(np.float32)
    radial = np.zeros((b, HW, HW), np.float32)
    for i, s in enumerate(sides):
        radial[i, 6:6 + s, 10:10 + s] = rng.uniform(1, 3, size=(s, s))
    sem = np.where(radial > 0, 1.0, -1.0).astype(np.float32)
    return {"image": img, "radial": radial, "sem": sem}


def _rows(batch, rows):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            for k, v in batch.items()}


def _port_state(cfg, init):
    state = train.create_state(cfg, torch.Generator().manual_seed(0),
                               blocks=TINY, width=WIDTH, device="cpu")
    state.model.load_state_dict(from_flax_variables(init))
    return state


def _snapshot(state, metrics):
    sd = state.model.state_dict()
    adam = {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        if "exp_avg" in st:
            adam[name] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: p.detach().clone()
                       for k, p in state.model.named_parameters()},
            "stats": {k: v.clone() for k, v in sd.items()
                      if k.endswith(("running_mean", "running_var"))},
            "adam": adam}


def _naive_step(state, batch, group, world):
    """What plain DDP computes: per-rank BN statistics and loss
    normalizer, gradients averaged."""
    fcnresnet.set_batch_norm_group(state.model, None)
    sem_t, rad_t = train._label_maps(batch)
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_s, loss_r, acc = train._forward_losses(
        state, batch["image"], sem_t, rad_t)
    loss.backward()
    train._allreduce_grads(state.model, group, 1.0 / world)
    train._apply_update(state)
    return state, {"loss": loss, "loss_s": loss_s, "loss_r": loss_r,
                   "acc": acc}


def _steps(rank, world, cfg_kw, init, batches, accum, naive):
    """Steps of this rank's rows ``[2 rank, 2 rank + 2)`` of each global
    batch; a snapshot after each."""
    import torch.distributed as dist

    state = _port_state(_cfg(**cfg_kw), init)
    mesh = parallel.data_mesh(devices=[torch.device("cpu")])
    assert mesh.world == world and mesh.group is not None
    step, _ = train.make_parallel_steps(mesh, accum)
    out = []
    for gb in batches:
        local = _rows(gb, slice(2 * rank, 2 * rank + 2))
        if naive:
            state, m = _naive_step(state, local, mesh.group, world)
        else:
            state, m = step(state, local)
        out.append(_snapshot(state, m))
    # the ranks cannot drift: every parameter equal on both, bit for bit
    flat = torch.cat([p.detach().reshape(-1)
                      for p in state.model.parameters()])
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    out[-1]["ranks_equal"] = all(torch.equal(g, gathered[0])
                                 for g in gathered)
    return out


def _fit(rank, init, batches, val, ckpt_dir):
    """``Trainer.fit`` for 2 epochs of 2 steps on this rank's shards, with
    a ``Checkpointer`` over the group; counts the saves that wrote."""
    cfg = _cfg(max_iterations=4)
    state = _port_state(cfg, init)
    mesh = parallel.data_mesh(devices=[torch.device("cpu")])
    ckpt = Checkpointer(ckpt_dir, group=mesh.group)
    wrote = []
    orig = ckpt._save
    ckpt._save = lambda *a: (wrote.append(a[1]), orig(*a))
    trainer = train.Trainer(
        cfg=cfg, state=state, mesh=mesh,
        train_batches=lambda epoch: [_rows(gb, slice(2 * rank, 2 * rank + 2))
                                     for gb in batches],
        val_batches=lambda: [_rows(val, slice(0, 4))],
        checkpointer=ckpt, steps_per_epoch=2)
    trainer.fit(2)
    restored = ckpt.restore(_port_state(cfg, init), best=True)
    return {"best_val": trainer.best_val, "iteration": trainer.iteration,
            "wrote": wrote, "restored_iteration": restored[2]}


# (name, config keywords, accum_steps, plain DDP)
VARIANTS = (("sgd", {"optim": "sgd"}, 1, False),
            ("adam", {"optim": "adam"}, 1, False),
            ("naive", {"optim": "sgd"}, 1, True),
            ("accum", {"optim": "sgd"}, 2, False),
            ("remat", {"optim": "sgd", "remat": True}, 1, False))


def ranks_worker(rank, world, init, batches, val, ckpt_dir):
    """Every two-rank run of this module in one spawned world: the
    global-batch steps (SGD and Adam), plain DDP's, accum_steps=2, remat,
    and a fit."""
    parallel.warm_collectives(
        parallel.data_mesh(devices=[torch.device("cpu")]))
    out = {name: _steps(rank, world, kw, init, batches, accum, naive)
           for name, kw, accum, naive in VARIANTS}
    out["fit"] = _fit(rank, init, batches, val, ckpt_dir)
    return out


def cli_train_worker(rank, world, argv):
    """``cli.main --mode train --distributed``: the process group comes
    from the torchrun environment that ``run_ranks`` sets."""
    import torch.distributed as dist

    from rcvpose_tpu_torch import cli

    trainer = cli.main(argv, device="cpu")
    assert not dist.is_initialized()   # cli.main left the group it made
    return {"best_val": trainer.best_val, "iteration": trainer.iteration,
            "step": trainer.state.step,
            "params": torch.cat([p.detach().reshape(-1) for p in
                                 trainer.state.model.parameters()])}


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------

BATCHES = [global_batch(0), global_batch(1)]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's 2-device global-batch steps at batch 4, from one
    initialization: {optim: [snapshot after each of two steps]} for SGD
    (momentum 0.9) and Adam, and the initial variables."""
    import jax
    import jax.numpy as jnp

    from rcvpose_tpu import parallel as jax_parallel
    from rcvpose_tpu import train as jax_train
    from rcvpose_tpu.config import Config as JaxConfig

    mesh = jax_parallel.data_mesh(2)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    init, snaps = None, {}
    for optim in ("sgd", "adam"):
        cfg = _cfg(JaxConfig, optim, batch_size=4)
        state = jax.jit(lambda r, c=cfg: jax_train.create_state(
            c, r, blocks=TINY, sample_shape=(1, HW, HW, 3),
            width=WIDTH))(jax.random.PRNGKey(0))
        state = jax.device_put(state, jax_parallel.replicated(mesh))
        init = {"params": np_tree(state.params),
                "batch_stats": np_tree(state.batch_stats)}
        p_train, _ = jax_train.make_parallel_steps(mesh)
        snaps[optim] = []
        for gb in BATCHES:
            state, m = p_train(state, jax_parallel.shard_batch(
                mesh, {k: jnp.asarray(v) for k, v in gb.items()}))
            snap = {"metrics": {k: float(v) for k, v in m.items()},
                    "vars": from_flax_variables(
                        {"params": np_tree(state.params),
                         "batch_stats": np_tree(state.batch_stats)})}
            if optim == "adam":
                adam = state.opt_state[0]
                snap["mu"] = from_flax_variables({"params": np_tree(adam.mu)})
                snap["nu"] = from_flax_variables({"params": np_tree(adam.nu)})
            snaps[optim].append(snap)
    return init, snaps


VAL = global_batch(7)


@pytest.fixture(scope="module")
def ddp_runs(jax_ref, tmp_path_factory):
    """The two-rank runs (``ranks_worker``), rank by rank, and the
    checkpoint directory of the fit."""
    init, _ = jax_ref
    ckpt_dir = str(tmp_path_factory.mktemp("ddp_ckpts"))
    ranks = parallel.run_ranks(ranks_worker, 2,
                               (init, BATCHES, VAL, ckpt_dir),
                               timeout=RANK_TIMEOUT)
    runs = {name: [r[name] for r in ranks] for name in ranks[0]}
    return runs, ckpt_dir


def _one_process(init, batches, accum=1):
    """The port's single process at batch 4 on the same rows (SGD)."""
    state = _port_state(_cfg(optim="sgd"), init)
    step = train.make_accum_train_step(accum) if accum > 1 else \
        train.train_step
    out = []
    for gb in batches:
        state, m = step(state, _rows(gb, slice(0, 4)))
        out.append(_snapshot(state, m))
    return out


def _interleaved(gb):
    """Rows ordered so that the single process's microbatch i holds every
    rank's i-th local row: [r0[0], r1[0], r0[1], r1[1]]."""
    return {k: v[[0, 2, 1, 3]] for k, v in gb.items()}


# ---------------------------------------------------------------------------
# Assertions, at test_torch_port_train.py's tolerances
# ---------------------------------------------------------------------------

def _tolerances():
    from tests import test_torch_port_train as t
    return t


def _assert_rel(got, want, init=None):
    """Each tensor of ``got`` against ``want`` as the train tests hold
    parameter updates: from ``init`` (zeros when None)."""
    t = _tolerances()
    keys = sorted(want)
    zero = {k: torch.zeros_like(want[k]) for k in keys}
    before = zero if init is None else {k: init[k] for k in keys}
    t._assert_updates(before, {k: got[k] for k in keys}, before,
                      {k: want[k] for k in keys})


def _assert_snapshot(got, want_metrics, want_vars, init_vars, what):
    t = _tolerances()
    if what == "metrics":
        t._assert_metrics(got["metrics"], want_metrics)
    elif what == "params":
        _assert_rel(got["params"], {k: want_vars[k] for k in got["params"]},
                    init_vars)
    else:
        for key, val in got["stats"].items():
            np.testing.assert_allclose(val.numpy(), want_vars[key].numpy(),
                                       rtol=0, atol=t.STATS_ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("optim,what", [
    ("sgd", "metrics"), ("sgd", "params"), ("sgd", "bn_stats"),
    ("adam", "metrics"), ("adam", "moments")])
def test_two_ranks_match_jax_global_batch(jax_ref, ddp_runs, optim, what):
    """Two gloo ranks x batch 2 against the JAX package's 2-device
    ``make_parallel_steps`` at batch 4, after each of two steps, on both
    ranks: metrics, parameters and BN running statistics after SGD
    steps, and metrics and Adam's moments after Adam steps.

    As in test_torch_port_train.py, parameters are held after SGD: Adam
    turns the rounding-noise gradients of the conv biases in front of a
    batch norm into updates of about +-lr whose signs the frameworks draw
    differently. After the first step the parameters meet the single
    step's tolerance. The second step's gradient is taken at parameters
    that already differ by that much, and moves the port's own single
    process at batch 4 further from JAX than the single step's tolerance
    (conv1 most): after it each parameter is held to be no further from
    JAX than the single process's is, plus UPDATE_REL of the largest
    update, and to the single process itself at the single step's
    tolerance (``test_two_ranks_match_one_process``)."""
    t = _tolerances()
    init, snaps = jax_ref
    init_vars = from_flax_variables(init)
    one = _one_process(init, BATCHES) if what == "params" else None
    for rank_out in ddp_runs[0][optim]:
        for i, (got, want) in enumerate(zip(rank_out, snaps[optim])):
            if what == "moments":
                _assert_rel({k: v[0] for k, v in got["adam"].items()},
                            want["mu"])
                _assert_rel({k: v[1] for k, v in got["adam"].items()},
                            want["nu"])
            elif what == "params" and i > 0:
                top = max(float((want["vars"][k] - init_vars[k]).abs().max())
                          for k in got["params"])
                for k, val in got["params"].items():
                    ref = want["vars"][k]
                    own = float((one[i]["params"][k] - ref).abs().max())
                    err = float((val - ref).abs().max())
                    assert err <= own + t.UPDATE_REL * top, (k, err, own)
            else:
                _assert_snapshot(got, want["metrics"], want["vars"],
                                 init_vars, what)


def test_ranks_stay_equal_after_each_run(ddp_runs):
    for name, _, _, _ in VARIANTS:
        ranks = ddp_runs[0][name]
        assert all(r[-1]["ranks_equal"] for r in ranks), name
        a, b = (r[-1]["params"] for r in ranks)
        assert all(torch.equal(a[k], b[k]) for k in a), name


def test_unequal_masks_expose_a_per_rank_normalizer(jax_ref, ddp_runs):
    """Plain DDP (per-rank BN statistics and loss normalizer, gradients
    averaged) is not the global-batch step on these rows: the ranks'
    mean loss_r and the parameters leave the tolerances that the
    global-batch run meets."""
    t = _tolerances()
    init, snaps = jax_ref
    want = snaps["sgd"]
    naive = ddp_runs[0]["naive"]
    mean = {k: float(np.mean([r[0]["metrics"][k] for r in naive]))
            for k in want[0]["metrics"]}
    with pytest.raises(AssertionError):
        t._assert_metrics(mean, want[0]["metrics"])
    global_r = want[0]["metrics"]["loss_r"]
    assert abs(mean["loss_r"] - global_r) > 100 * t.METRIC_RTOL * global_r
    with pytest.raises(AssertionError):
        _assert_snapshot(naive[0][-1], None, want[-1]["vars"],
                         from_flax_variables(init), "params")


@pytest.mark.parametrize("name", ["sgd", "accum", "remat"])
def test_two_ranks_match_one_process(jax_ref, ddp_runs, name):
    """Against the port's own single process at batch 4. accum_steps=2:
    microbatch i of the ranks is every rank's i-th row, which is the
    single process's microbatch i on the interleaved rows [r0[0], r1[0],
    r0[1], r1[1]] (the JAX package would take rank 0's two rows as
    microbatch 0). Remat under two ranks (the replay all-reduces again,
    on both ranks) equals the plain two-rank step bit for bit."""
    init, _ = jax_ref
    init_vars = from_flax_variables(init)
    if name == "accum":
        want = _one_process(init, [_interleaved(gb) for gb in BATCHES], 2)
    else:
        want = _one_process(init, BATCHES)
    for rank_out in ddp_runs[0][name]:
        for got, w in zip(rank_out, want):
            for what in ("metrics", "params", "bn_stats"):
                _assert_snapshot(got, w["metrics"],
                                 {**w["params"], **w["stats"]}, init_vars,
                                 what)
    if name == "remat":
        for got, w in zip(ddp_runs[0]["remat"][0], ddp_runs[0]["sgd"][0]):
            assert got["metrics"] == w["metrics"]
            for key in w["params"]:
                assert torch.equal(got["params"][key], w["params"][key]), key


def test_rank0_alone_writes_checkpoints(ddp_runs):
    runs, ckpt_dir = ddp_runs
    ranks = runs["fit"]
    assert sorted(os.listdir(ckpt_dir)) == [Checkpointer.CKPT,
                                            Checkpointer.BEST]
    assert ranks[0]["wrote"] == [0, 1] and ranks[1]["wrote"] == []
    restored = {r["restored_iteration"] for r in ranks}
    assert len(restored) == 1 and restored <= {2, 4}


def test_fit_gives_one_best_val_on_both_ranks(jax_ref, ddp_runs):
    """Both ranks end with the same ``best_val``, which is the single
    process's on the same global batches (batch 4)."""
    init, _ = jax_ref
    ranks = ddp_runs[0]["fit"]
    assert ranks[0]["best_val"] == ranks[1]["best_val"]
    assert [r["iteration"] for r in ranks] == [4, 4]
    cfg = _cfg(max_iterations=4)
    trainer = train.Trainer(
        cfg=cfg, state=_port_state(cfg, init),
        train_batches=lambda epoch: [_rows(gb, slice(0, 4))
                                     for gb in BATCHES],
        val_batches=lambda: [_rows(VAL, slice(0, 4))], steps_per_epoch=2)
    trainer.fit(2)
    np.testing.assert_allclose(ranks[0]["best_val"], trainer.best_val,
                               rtol=_tolerances().METRIC_RTOL)


def test_cli_train_distributed(tmp_path):
    """``cli.main --mode train --distributed`` on two gloo ranks of the
    CPU (``WORLD_SIZE=2``): both ranks take 3 global-batch steps on their
    shards, end with the same ``best_val`` and parameters, and one pair
    of checkpoints is written."""
    from tests.test_torch_port_cli import TINY as CLI_TINY
    from tests.test_torch_port_cli import _labelled_tree

    root = _labelled_tree(tmp_path, 4)
    out_dir = str(tmp_path / "logs")
    argv = ["--mode", "train", "--distributed", "--root_dataset", root,
            "--class_name", "toy", "--batch_size", "1", "--max_iterations",
            "3", "--out_dir", out_dir, *CLI_TINY]
    ranks = parallel.run_ranks(cli_train_worker, 2, (argv,),
                               timeout=RANK_TIMEOUT, init_group=False)
    assert [r["iteration"] for r in ranks] == [3, 3]
    assert [r["step"] for r in ranks] == [3, 3]
    assert ranks[0]["best_val"] == ranks[1]["best_val"] < float("inf")
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    ckpts = [os.path.join(d, f) for d, _, fs in os.walk(out_dir)
             for f in fs if f.endswith(".pth.tar")]
    assert sorted(os.path.basename(c) for c in ckpts) == [
        Checkpointer.CKPT, Checkpointer.BEST]
