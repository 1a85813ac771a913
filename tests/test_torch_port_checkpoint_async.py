"""The port's asynchronous ``Checkpointer`` on the CPU.

The semantics of the JAX package's ``Checkpointer`` (async by default):
``save`` returns before a slowed write finishes; the payload is a copy, so
a parameter and an Adam moment changed after ``save`` returns leave the
file at the saved values; ``restore`` waits; the one-shot
``Checkpointer(d).save(...)`` idiom reads back whole (as
``tests/test_checkpoint.py`` holds for the JAX package); ``async_save=False``
writes what the synchronous writer wrote; under two gloo ranks rank 1's
``restore`` sees rank 0's complete file. The rank worker is module level
in a module that imports no JAX (spawned ranks import it).
"""

import gc
import os
import threading
import time

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import checkpoint, parallel, train
from rcvpose_tpu_torch.checkpoint import Checkpointer
from rcvpose_tpu_torch.config import Config
from tests.torch_port_threads import port_threads  # noqa: F401

HW = 32


@pytest.fixture
def one_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default (a thread a core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    """A small Adam state after one step, so that Adam's moments exist."""
    cfg = Config(compute_dtype="float32", image_height=HW, image_width=HW,
                 batch_size=2, model_blocks="1,1,1,1", model_width=0.125,
                 initial_lr=1e-3)
    state = train.create_state(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")
    rng = np.random.default_rng(seed)
    radial = np.zeros((2, HW, HW), np.float32)
    radial[:, 8:24, 8:24] = rng.uniform(1, 3, size=(2, 16, 16))
    batch = {"image": torch.tensor(rng.normal(size=(2, HW, HW, 3)),
                                   dtype=torch.float32),
             "radial": torch.tensor(radial),
             "sem": torch.tensor(np.where(radial > 0, 1.0, -1.0),
                                 dtype=torch.float32)}
    state, _ = train.train_step(state, batch)
    return state, batch


def _copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    return tree


def _assert_same(a, b, where="payload"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture
def gated_writes(monkeypatch):
    """``checkpoint._write`` held until the returned Event is set."""
    gate = threading.Event()
    write = checkpoint._write

    def slow(payload, path):
        if not gate.wait(timeout=60):
            raise TimeoutError("the test never released the write")
        write(payload, path)

    monkeypatch.setattr(checkpoint, "_write", slow)
    yield gate
    gate.set()


@pytest.mark.usefixtures("one_thread")
def test_save_returns_before_a_slowed_write_finishes(tmp_path, gated_writes):
    state, _ = _state()
    ck = Checkpointer(str(tmp_path))
    assert ck.async_save
    ck.save(state, epoch=0, iteration=1, best_val=0.5, is_best=True)
    threads = [t for t, _ in ck._pending]
    assert len(threads) == 2 and all(t.is_alive() for t in threads)
    assert not (tmp_path / Checkpointer.CKPT).exists()
    gated_writes.set()
    ck.wait_until_finished()
    assert not any(t.is_alive() for t in threads) and not ck._pending
    for name in (Checkpointer.CKPT, Checkpointer.BEST):
        assert _load(tmp_path / name)["iteration"] == 1
    assert sorted(os.listdir(tmp_path)) == [Checkpointer.CKPT,
                                            Checkpointer.BEST]


@pytest.mark.usefixtures("one_thread")
def test_changes_after_save_leave_the_file_at_the_saved_values(
        tmp_path, gated_writes):
    state, batch = _state()
    saved_model = _copy(state.model.state_dict())
    saved_optim = _copy(state.optimizer.state_dict())
    ck = Checkpointer(str(tmp_path))
    ck.save(state, epoch=0, iteration=1, best_val=0.5)
    # a step changes the parameters and Adam's moments in place, and an
    # in-place edit changes a parameter, while the write waits
    state, _ = train.train_step(state, batch)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    moments = state.optimizer.state_dict()["state"][0]
    assert not torch.equal(moments["exp_avg"],
                           saved_optim["state"][0]["exp_avg"])
    assert not torch.equal(next(state.model.parameters()),
                           saved_model["conv1.weight"])
    gated_writes.set()
    ck.wait_until_finished()
    payload = _load(tmp_path / Checkpointer.CKPT)
    _assert_same(payload["model_state_dict"], saved_model)
    _assert_same(payload["optim_state_dict"], saved_optim)
    assert payload["step"] == 1


@pytest.mark.usefixtures("one_thread")
def test_restore_waits_for_the_write(tmp_path, gated_writes):
    state, _ = _state()
    want = _copy(state.model.state_dict())
    ck = Checkpointer(str(tmp_path))
    ck.save(state, epoch=3, iteration=5, best_val=0.25, is_best=True)
    timer = threading.Timer(0.3, gated_writes.set)
    t0 = time.perf_counter()
    timer.start()
    fresh, _ = _state(seed=1)
    restored, epoch, it, best = ck.restore(fresh, best=True)
    assert gated_writes.is_set() and time.perf_counter() - t0 >= 0.25
    timer.join(timeout=10)
    assert (epoch, it, best, restored.step) == (3, 5, 0.25, 1)
    _assert_same(restored.model.state_dict(), want)


@pytest.mark.usefixtures("one_thread")
def test_one_shot_idiom_reads_back_whole(tmp_path, monkeypatch):
    """``Checkpointer(d).save(...)`` with a slow writer: the wrapper's
    finalizer finishes both writes, so a reader that knows nothing of the
    writer finds complete files."""
    write = checkpoint._write

    def slow(payload, path):
        time.sleep(0.2)
        write(payload, path)

    monkeypatch.setattr(checkpoint, "_write", slow)
    state, _ = _state()
    want = _copy(state.model.state_dict())
    d = str(tmp_path / "ckpts")
    Checkpointer(d).save(state, epoch=2, iteration=7, best_val=0.25,
                         is_best=True)
    gc.collect()
    assert sorted(os.listdir(d)) == [Checkpointer.CKPT, Checkpointer.BEST]
    _assert_same(checkpoint.import_torch_checkpoint(d), want)
    payload = _load(os.path.join(d, Checkpointer.CKPT))
    assert (payload["epoch"], payload["iteration"]) == (2, 7)


@pytest.mark.usefixtures("one_thread")
def test_sync_mode_writes_the_synchronous_payload(tmp_path):
    """``async_save=False`` writes in ``save`` what the synchronous writer
    wrote (the model's tensors on the CPU, the optimizer's state dict as
    it is), and the asynchronous file holds the same values."""
    state, _ = _state()
    today = {
        "model_state_dict": {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items()},
        "epoch": 4, "iteration": 9, "arch": "DenseFCNResNet152",
        "optim_state_dict": state.optimizer.state_dict(), "step": 1,
        "best_val": 0.125}
    torch.save(today, tmp_path / "today.pth.tar")
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    ck = Checkpointer(str(sync_dir), async_save=False)
    ck.save(state, epoch=4, iteration=9, best_val=0.125, is_best=True)
    assert not ck._pending
    Checkpointer(str(async_dir)).save(state, epoch=4, iteration=9,
                                      best_val=0.125, is_best=True)
    want = _load(tmp_path / "today.pth.tar")
    for d in (sync_dir, async_dir):
        for name in (Checkpointer.CKPT, Checkpointer.BEST):
            _assert_same(_load(d / name), want, f"{d.name}/{name}")


def _ranks_worker(rank, world, directory):
    """Rank 0 writes slowly; every rank then restores into a fresh state
    at once. Returns (restored epoch, iteration, a parameter's sum)."""
    torch.manual_seed(0)
    write = checkpoint._write

    def slow(payload, path):
        time.sleep(0.5)
        write(payload, path)

    checkpoint._write = slow
    state, _ = _state()
    fresh, _ = _state(seed=1)
    ck = Checkpointer(directory, group=torch.distributed.group.WORLD)
    ck.save(state, epoch=1, iteration=3, best_val=0.5, is_best=True)
    restored, epoch, it, _ = ck.restore(fresh, best=True)
    return (epoch, it, float(restored.model.conv1.weight.sum()),
            float(state.model.conv1.weight.sum()))


def test_two_ranks_restore_sees_rank0s_complete_file(tmp_path):
    out = parallel.run_ranks(_ranks_worker, 2, (str(tmp_path),),
                             timeout=300.0)
    assert [o[:2] for o in out] == [(1, 3), (1, 3)]
    for _, _, got, want in out:
        assert got == want
    assert sorted(os.listdir(tmp_path)) == [Checkpointer.CKPT,
                                            Checkpointer.BEST]
