"""Training checkpoints, evaluation weights and the weight bridge.

``Checkpointer`` writes reference-layout ``ckpt.pth.tar`` and
``model_best.pth.tar`` files and restores them into a ``TrainState``.
``import_torch_checkpoint`` reads evaluation weights (a reference
``.pth.tar``, a ``Checkpointer`` directory, or the JAX package's orbax
output, through ``orbax_variables``) and ``load_model_weights`` loads them
into a port model, strictly.

``from_flax_variables`` takes the ``{"params", "batch_stats"}`` tree of the
JAX package's Flax models as nested dicts of numpy arrays and returns a
state dict in the reference layout, which the port's models load. Conv
kernels go HWIO -> OIHW; BN ``scale``/``bias``/``mean``/``var`` go to
``weight``/``bias``/``running_mean``/``running_var``. The path mapping is
the port's own copy of the JAX package's ``_flax_path_to_torch_key``.
"""

from __future__ import annotations

import os
import re
import threading
import weakref

import numpy as np
import torch
import torch.distributed as dist


def _flax_path_to_torch_key(col, path):
    """Reference state-dict key for one (collection, Flax path) pair.

    Reference module naming: conv1/bn1, block{s}up (+ upsample_ projection),
    block{s}.{i} Sequentials, conv6/bn6, conv_up{k}.{0,1}, conv_up{k}_1
    lifts, conv7.{0,1}, conv8. Raises ``KeyError`` on a path it cannot map.
    """
    leaf = path[-1]
    conv_leaf = {"kernel": "weight", "bias": "bias"}
    bn_leaf = {"scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}
    lmap = bn_leaf if col == "batch_stats" else conv_leaf

    def bn_or_conv(module):
        is_bn = (col == "batch_stats" or module.startswith("bn")
                 or module.endswith("_bn") or module == "proj_bn")
        return (bn_leaf if is_bn else conv_leaf)[leaf]

    if path[0] == "encoder":
        mod = path[1]
        if mod in ("conv1", "bn1"):
            return f"{mod}.{bn_or_conv(mod)}"
        if re.match(r"block(\d)up$", mod):
            member = path[2]
            if member == "proj_conv":
                return f"{mod}.upsample_.0.{conv_leaf[leaf]}"
            if member == "proj_bn":
                return f"{mod}.upsample_.1.{bn_leaf[leaf]}"
            return f"{mod}.{member}.{bn_or_conv(member)}"
        m_blk = re.match(r"block(\d)_(\d+)$", mod)
        if m_blk:
            member = path[2]
            seq = int(m_blk.group(2)) - 1  # Flax _1 -> Sequential index 0
            return (f"block{m_blk.group(1)}.{seq}.{member}."
                    f"{bn_or_conv(member)}")
        raise KeyError(f"unmapped encoder module {mod!r}")
    mod = path[0]
    if mod in ("conv6", "bn6", "conv8"):
        return f"{mod}.{bn_or_conv(mod)}"
    m_seq = re.match(r"(conv_up\d|conv7)_(conv|bn)$", mod)
    if m_seq:
        idx = 0 if m_seq.group(2) == "conv" else 1
        return f"{m_seq.group(1)}.{idx}.{bn_or_conv(mod)}"
    if re.match(r"conv_up\d_1$", mod):
        return f"{mod}.{lmap[leaf]}"
    raise KeyError(f"unmapped module path {'/'.join(path)!r}")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield list(prefix + (key,)), value


def from_flax_variables(variables):
    """JAX-package ``{"params", "batch_stats"}`` tree (numpy leaves, or
    tensors) -> state dict of f32 CPU tensors in the reference layout."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, value in _leaves(dict(variables.get(col, {}))):
            key = _flax_path_to_torch_key(col, path)
            if isinstance(value, torch.Tensor):
                value = value.float().numpy()
            arr = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
            out[key] = torch.tensor(arr)
    return out


def _host_copy(tree, pinned):
    """A copy of ``tree`` (nested dicts, lists and tuples) whose tensors
    are detached CPU copies that share no memory with the originals;
    ``pinned`` copies CUDA tensors into pinned host memory without waiting
    (the caller synchronizes once). Other leaves are returned as they are
    (ints, floats, strings: immutable)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        out.copy_(t, non_blocking=pinned)
        return out
    if isinstance(tree, dict):
        return {k: _host_copy(v, pinned) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, pinned) for v in tree)
    return tree


def _write(payload, path):
    """``torch.save`` to a temporary file that then replaces ``path``."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _join(pending):
    """Wait for every write thread of ``pending`` ([(thread, errors)]) and
    empty it; returns the writes' exceptions and raises none (it is also
    the finalizer of a collected ``Checkpointer``, which may run while
    the interpreter shuts down)."""
    errors = []
    while pending:
        thread, errs = pending.pop(0)
        thread.join()
        errors.extend(errs)
    return errors


class Checkpointer:
    """The JAX package's ``Checkpointer`` interface over reference-layout
    ``.pth.tar`` files (reference train.py:118-131): ``ckpt.pth.tar`` on
    every save, ``model_best.pth.tar`` on a best one. The payload holds the
    reference's ``model_state_dict``, ``epoch``, ``iteration`` and
    ``arch``, plus ``optim_state_dict``, ``step`` and ``best_val``. Each
    write goes to a temporary file that then replaces the target, so no
    reader ever sees half a file.

    Saves are asynchronous by default, as the JAX package's are: ``save``
    first waits out the previous save, then snapshots the payload (every
    tensor of the model's and the optimizer's state dicts copied to host
    memory: pinned, with one synchronize, from the card; cloned on the
    CPU), and returns while a background thread writes ``ckpt.pth.tar``.
    A best save writes ``model_best.pth.tar`` from the same snapshot on a
    thread of its own, so it does not wait for the ckpt write. The copy is
    what makes returning early safe: the next optimizer step changes the
    parameters and Adam's moments in place. ``wait_until_finished`` blocks
    until both writes are on disk (and raises a write's error),
    ``restore`` waits first, ``Trainer.fit`` waits before it returns, and
    a finalizer drains the writes when the wrapper is collected, so the
    one-shot ``Checkpointer(d).save(...)`` idiom is safe. Another reader
    of the directory (a fresh ``Checkpointer``, the evaluator) needs
    ``wait_until_finished()`` first while this one is alive.
    ``async_save=False`` writes in ``save``: the payload then holds the
    optimizer's state dict as it is (tensors where they live).

    ``group``: under a process group of several ranks (data-parallel
    training, where every rank holds the same state) rank 0 writes and
    every rank passes a barrier after the write is dispatched, so no rank
    runs ahead of a save; ``restore`` (a collective there) has rank 0
    finish its writes and every rank pass a barrier before any rank reads,
    each onto its own device."""

    CKPT = "ckpt.pth.tar"
    BEST = "model_best.pth.tar"

    def __init__(self, directory, async_save=True, group=None):
        self.directory = os.path.abspath(directory)
        self.async_save = bool(async_save)
        self.group = group
        os.makedirs(self.directory, exist_ok=True)
        # [(write thread, its exceptions)]; the finalizer holds the list,
        # not self, so it cannot keep the wrapper alive
        self._pending = []
        weakref.finalize(self, _join, self._pending)

    def _writes(self):
        return self.group is None or dist.get_rank(self.group) == 0

    def _dispatch(self, payload, name):
        # the thread holds the path, not self: a one-shot wrapper is then
        # collected (and its finalizer drains the write) at once
        path, errors = os.path.join(self.directory, name), []

        def run():
            try:
                _write(payload, path)
            except BaseException as exc:  # raised by wait_until_finished
                errors.append(exc)

        thread = threading.Thread(target=run, name=f"checkpoint {name}")
        thread.start()
        self._pending.append((thread, errors))

    def save(self, state, epoch, iteration, best_val, is_best=False):
        if self._writes():
            self._save(state, epoch, iteration, best_val, is_best)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _save(self, state, epoch, iteration, best_val, is_best):
        self.wait_until_finished()
        model_sd = state.model.state_dict()
        optim_sd = state.optimizer.state_dict()
        if self.async_save:
            on_card = any(v.is_cuda for v in model_sd.values())
            model_sd, optim_sd = _host_copy((model_sd, optim_sd), on_card)
            if on_card:
                torch.cuda.synchronize(state.device)
        else:
            model_sd = {k: v.detach().cpu() for k, v in model_sd.items()}
        payload = {
            "model_state_dict": model_sd,
            "epoch": int(epoch),
            "iteration": int(iteration),
            "arch": type(state.model).__name__,
            "optim_state_dict": optim_sd,
            "step": int(state.step),
            "best_val": float(best_val),
        }
        names = (self.CKPT, self.BEST) if is_best else (self.CKPT,)
        for name in names:
            if self.async_save:
                self._dispatch(payload, name)
            else:
                _write(payload, os.path.join(self.directory, name))

    def wait_until_finished(self):
        """Block until every dispatched write (ckpt and model_best) is on
        disk; raise the first write's exception, if one failed."""
        errors = _join(self._pending)
        if errors:
            raise errors[0]

    def restore(self, state, best=False):
        """Load the checkpoint into ``state`` (model, optimizer, step);
        returns ``(state, epoch, iteration, best_val)``."""
        self.wait_until_finished()
        if self.group is not None:
            dist.barrier(group=self.group)
        path = os.path.join(self.directory, self.BEST if best else self.CKPT)
        payload = torch.load(path, map_location=state.device,
                             weights_only=True)
        state.model.load_state_dict(payload["model_state_dict"])
        state.optimizer.load_state_dict(payload["optim_state_dict"])
        state.step = int(payload["step"])
        return (state, int(payload["epoch"]), int(payload["iteration"]),
                float(payload["best_val"]))


# Projections the reference allocates in every Bottleneck but only the
# first block of a stage uses (reference models/fcnresnet.py:16-18, 35-36):
# nothing reads them, and the port's non-projecting blocks have none.
_DEAD_KEY = re.compile(r"^block\d\.\d+\.upsample_\.")


def orbax_payload(path, subtrees):
    """The top-level ``subtrees`` of the JAX package's orbax checkpoint at
    ``path``, as numpy trees: a ``Checkpointer`` directory (``model_best/``
    preferred over ``ckpt/``) or a bare payload directory. Read by the
    port's own OCDBT / zarr v2 / zstd readers (``orbax_read``); nothing
    else in the payload (``opt_state``) is decoded."""
    from rcvpose_tpu_torch import orbax_read

    path = os.path.abspath(path)
    for name in ("model_best", "ckpt"):
        sub = os.path.join(path, name)
        if os.path.isdir(sub):
            path = sub
            break
    return orbax_read.read_tree(path, subtrees)


def orbax_variables(path):
    """``{"params", "batch_stats"}`` of a JAX orbax checkpoint (the
    counterpart of the JAX package's ``eval._orbax_variables``);
    ``from_flax_variables`` turns it into a reference-layout state dict."""
    return orbax_payload(path, ("params", "batch_stats"))


def is_orbax_dir(path):
    """Whether ``path`` is a JAX orbax payload or ``Checkpointer``
    directory."""
    return any(os.path.isfile(os.path.join(path, name, "_METADATA"))
               for name in ("model_best", "ckpt", ""))


def import_torch_checkpoint(path):
    """Evaluation weights as a reference-layout state dict of CPU tensors.

    ``path`` is a reference ``.pth.tar`` (a payload with
    ``model_state_dict``, or a bare state dict; ``module.`` prefixes of
    DataParallel are dropped) or a directory: the port's own
    ``Checkpointer`` directory (``model_best.pth.tar`` preferred over
    ``ckpt.pth.tar``), else the JAX package's orbax output (a
    ``Checkpointer`` directory with ``model_best/`` or ``ckpt/``, or a bare
    payload), read by ``orbax_variables``. A directory that holds neither
    raises ``ValueError`` naming both formats. As in the JAX package a
    ``.pth.tar`` is unpickled in full (reference checkpoints may hold more
    than tensors): load only files you trust.
    """
    if os.path.isdir(path):
        for name in (Checkpointer.BEST, Checkpointer.CKPT):
            if os.path.isfile(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            if is_orbax_dir(path):
                return from_flax_variables(orbax_variables(path))
            raise ValueError(
                f"{path} holds neither the port's {Checkpointer.BEST} / "
                f"{Checkpointer.CKPT} nor an orbax checkpoint (model_best/, "
                "ckpt/ or a payload with _METADATA, the JAX package's "
                "--mode train output)")
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = (payload.get("model_state_dict", payload)
          if isinstance(payload, dict) else payload)
    return {re.sub(r"^module\.", "", k): torch.as_tensor(v)
            for k, v in sd.items()}


def load_model_weights(model, state_dict):
    """Load a reference-layout state dict into a port model, strictly.

    Every parameter and running statistic of the model must be present;
    only the bookkeeping ``num_batches_tracked`` may be absent. The
    reference's dead ``upsample_`` projections of non-projecting blocks
    are dropped; any other key the model does not have raises.
    """
    own = model.state_dict()
    sd = {k: v for k, v in state_dict.items()
          if k in own or not _DEAD_KEY.match(k)}
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in sd if k not in own]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not match the model: missing "
                       f"{missing[:5]} ({len(missing)}), unexpected "
                       f"{unexpected[:5]} ({len(unexpected)})")
    model.load_state_dict(sd, strict=False)
    return model
