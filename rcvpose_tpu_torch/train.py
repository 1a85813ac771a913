"""Training runtime (counterpart of ``rcvpose_tpu.train``) on one device.

Loss and metric semantics are the JAX package's:

* ``loss_s``: mean L1 between the seg logits and the +/-1 semantic target;
* ``loss_r``: L1 summed over pixels where the GT radial map is nonzero,
  divided by the batch-global count of such pixels;
* total = loss_r + loss_s; a NaN raises in the ``Trainer``;
* ``acc``: the share of GT-nonzero pixels with |err| <= 0.05 dm;
* lr: ``initial_lr`` times ``decay_factor`` every ``decay_epochs`` epochs,
  evaluated at the step count *before* each update, as optax does.

The forward runs under ``torch.autocast`` in bf16 when
``cfg.compute_dtype == "bfloat16"``, with f32 parameters and BN statistics
(the JAX package's bf16 compute with f32 master parameters). The steps
update the ``TrainState`` in place and return it with the step's metrics
as device tensors; nothing waits for the device until the ``Trainer``
fetches metrics every ``log_interval`` steps.

Data parallelism (``make_parallel_steps``) has the JAX package's
global-batch semantics: W processes with b rows each compute the step of
one batch of W*b rows. Batch norm takes its statistics over the global
batch (``fcnresnet.set_batch_norm_group``), ``loss_r`` and ``acc`` divide
by the global count of GT-nonzero pixels, and the gradients are summed
across ranks from per-rank objectives that sum to the global loss.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import torch
import torch.distributed as dist

from rcvpose_tpu_torch import parallel
from rcvpose_tpu_torch.models.fcnresnet import (DenseFCNResNet152,
                                                ResFCNResNet152, init_params,
                                                set_batch_norm_group)
from rcvpose_tpu_torch.utils import resolve_device


def build_model(cfg, blocks=None, width=None, conv_kernel=False):
    """The ``cfg.model`` network with f32 parameters on the CPU, or on the
    device of an enclosing ``torch.device`` context (``PoseEstimator``
    builds its nets on its device and assigns their weights).

    ``blocks``/``width`` shrink depth/channels for tests only (width a
    power-of-two fraction >= 1/8 so the x4 bottleneck expansion scales
    exactly); without them ``cfg.model_blocks``/``cfg.model_width`` apply.
    ``conv_kernel`` runs the 3x3 decoder convs on K3/K4 (the counterpart of
    the JAX package's ``RCVPOSE_PALLAS_CONV=on``); ``cfg.remat``
    recomputes the encoder's Bottlenecks in the backward. The serving
    compute dtype is applied by the caller (``PoseEstimator``).
    """
    kwargs = dict(output_channels=2 * cfg.kpt_heads, conv_kernel=conv_kernel,
                  remat=bool(getattr(cfg, "remat", False)))
    if cfg.model == "dense" and cfg.fast_head:
        kwargs["fast_head"] = True  # DenseFCN-only extension
    if blocks is None and cfg.model_blocks:
        blocks = [int(b) for b in cfg.model_blocks.split(",")]
    if width is None and cfg.model_width != 1.0:
        width = cfg.model_width
    if blocks is not None:
        kwargs["blocks"] = tuple(blocks)
    if width is not None:
        kwargs["width"] = width
    if cfg.model == "dense":
        return DenseFCNResNet152(**kwargs)
    return ResFCNResNet152(**kwargs)


def make_lr_schedule(initial_lr, steps_per_epoch, decay_epochs=70,
                     decay_factor=0.1):
    """lr * factor^(epoch // decay_epochs), stepwise."""
    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        return initial_lr * (decay_factor ** (epoch // decay_epochs))
    return schedule


def make_optimizer(cfg, params, steps_per_epoch):
    """(optimizer, schedule): Adam with betas (0.9, 0.999) and eps 1e-8, as
    optax's ``adam``, or SGD with momentum ``cfg.momentum`` and no
    dampening, as ``optax.sgd``. The steps set each group's lr to
    ``schedule(step)`` before every update."""
    sched = make_lr_schedule(cfg.initial_lr, steps_per_epoch,
                             cfg.lr_decay_epochs, cfg.lr_decay_factor)
    if cfg.optim.lower() == "adam":
        opt = torch.optim.Adam(params, lr=sched(0), betas=(0.9, 0.999),
                               eps=1e-8)
    else:
        opt = torch.optim.SGD(params, lr=sched(0), momentum=cfg.momentum)
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the lr
    schedule and the count of optimizer steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def device(self):
        return next(self.model.parameters()).device


def create_state(cfg, generator, steps_per_epoch=1000, blocks=None,
                 width=None, device=None, conv_kernel=False):
    """A fresh ``TrainState``: ``init_params`` from the CPU
    ``torch.Generator``, then the model moves to ``device`` (the card
    unless ``device="cpu"``) in channels-last layout."""
    dev = resolve_device(device)
    model = build_model(cfg, blocks, width, conv_kernel)
    init_params(model, generator)
    model = model.to(device=dev, memory_format=torch.channels_last)
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    return TrainState(model=model, optimizer=opt, schedule=sched,
                      compute_dtype=dtype)


def losses(seg, radial, sem_target, radial_target):
    """Reference loss pair and accuracy proxy over (B, H, W, K) maps."""
    loss_s = torch.mean(torch.abs(seg - sem_target))
    nz = radial_target != 0
    count = torch.clamp(nz.sum().to(torch.float32), min=1.0)
    err = torch.abs(radial - radial_target)
    loss_r = torch.where(nz, err, 0.0).sum() / count
    acc = torch.where(nz, (err <= 0.05).to(torch.float32), 0.0).sum() / count
    return loss_s, loss_r, acc


def _label_maps(batch):
    """Labels as (B, H, W, K): single-head (B, H, W) labels gain a channel
    axis; multi-head labels arrive channeled. loss_s means over all heads;
    loss_r's normalizer counts GT-nonzero pixels across all heads."""
    sem_t, rad_t = batch["sem"], batch["radial"]
    if sem_t.dim() == 3:
        sem_t, rad_t = sem_t[..., None], rad_t[..., None]
    return sem_t, rad_t


def _autocast(state):
    dev = state.device.type
    return torch.autocast(dev, dtype=state.compute_dtype,
                          enabled=state.compute_dtype != torch.float32)


def _forward_losses(state, image, sem_t, rad_t):
    with _autocast(state):
        seg, radial = state.model(image)
    loss_s, loss_r, acc = losses(seg, radial, sem_t, rad_t)
    return loss_s + loss_r, loss_s, loss_r, acc


def _apply_update(state):
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, batch):
    """One optimizer step on ``batch`` (dict of image (B, H, W, 3) and
    radial/sem (B, H, W[, K]) f32 tensors on the state's device); BN
    statistics update once. Returns (state, metrics)."""
    sem_t, rad_t = _label_maps(batch)
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, loss_s, loss_r, acc = _forward_losses(state, batch["image"], sem_t,
                                                rad_t)
    loss.backward()
    _apply_update(state)
    return state, {"loss": loss.detach(), "loss_s": loss_s.detach(),
                   "loss_r": loss_r.detach(), "acc": acc.detach()}


def make_accum_train_step(accum):
    """Gradient-accumulation step: ``accum`` microbatches of ``B/accum``
    images, their grads averaged, one optimizer update. The masked radial
    normalizer counts per microbatch; BN statistics chain through the
    microbatches (one momentum update each); metrics are microbatch
    means."""
    def step(state: TrainState, batch):
        sem_t, rad_t = _label_maps(batch)
        b = batch["image"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum}")
        n = b // accum
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        ms = []
        for i in range(accum):
            sl = slice(i * n, (i + 1) * n)
            out = _forward_losses(state, batch["image"][sl], sem_t[sl],
                                  rad_t[sl])
            out[0].backward()   # grads sum over microbatches
            ms.append(torch.stack([t.detach() for t in out]))
        with torch.no_grad():
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
        _apply_update(state)
        mean = torch.stack(ms).mean(0)
        return state, dict(zip(("loss", "loss_s", "loss_r", "acc"), mean))
    return step


def _global_forward_losses(state, image, sem_t, rad_t, group, world):
    """This rank's objective and the global metrics of a step over the
    process group's global batch.

    The objective is ``loss_s / world + sum(masked L1) / count``, ``count``
    the global GT-nonzero count: the ranks' objectives sum to the global
    loss (local batches are equal, so the mean of the local ``loss_s``
    means is the global mean), and the summed gradients are the global
    loss's. Returns (objective, [loss, loss_s, loss_r, acc]) with the
    metrics all-reduced."""
    count = parallel.all_reduce(
        (rad_t != 0).sum().to(torch.float32).reshape(1), group)
    count = torch.clamp(count[0], min=1.0)
    with _autocast(state):
        seg, radial = state.model(image)
    nz = rad_t != 0
    err = torch.abs(radial - rad_t)
    loss_s = torch.mean(torch.abs(seg - sem_t))
    rsum = torch.where(nz, err, 0.0).sum()
    objective = loss_s / world + rsum / count
    with torch.no_grad():
        asum = torch.where(nz, (err <= 0.05).to(torch.float32), 0.0).sum()
        sums = parallel.all_reduce(torch.stack([loss_s, rsum, asum]),
                                   group)
        loss_s_g = sums[0] / world
        loss_r, acc = sums[1] / count, sums[2] / count
    return objective, torch.stack([loss_s_g + loss_r, loss_s_g, loss_r,
                                   acc])


def _allreduce_grads(model, group, scale=1.0):
    """Sum every parameter's gradient across ``group`` in one flat
    all-reduce, times ``scale``."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = parallel.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               group)
    if scale != 1.0:
        flat.mul_(scale)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()


def make_parallel_steps(mesh, accum_steps=1):
    """(train step, eval step) over a data mesh.

    Without a process group (one process) these are the plain steps. With
    one, the train step runs this rank's batch against the global batch:
    BN statistics and the loss normalizer are global, and the gradients
    are all-reduced once (a flat buffer, after the backward) before one
    optimizer update on every rank, so the ranks' states stay equal. K2's
    backward (and K3/K4 on the kernel route) stay inside their
    ``autograd.Function``s. ``accum_steps > 1`` splits each rank's batch
    into microbatches of ``b / accum_steps`` rows: microbatch i is every
    rank's i-th slice, whose frames share one BN batch (the JAX package
    takes rows ``[i B / accum, (i + 1) B / accum)`` of the global batch
    instead; ROADMAP C). The eval step runs each rank's batch alone with
    no collective: batch norm reads running statistics in eval mode, and
    every rank validates on the full val set."""
    group = None if mesh is None else mesh.group
    if group is None:
        train = (make_accum_train_step(accum_steps) if accum_steps > 1
                 else train_step)
        return train, eval_step
    world = dist.get_world_size(group)

    def step(state: TrainState, batch):
        set_batch_norm_group(state.model, group)
        sem_t, rad_t = _label_maps(batch)
        b = batch["image"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps}")
        n = b // accum_steps
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        ms = []
        for i in range(accum_steps):
            sl = slice(i * n, (i + 1) * n)
            objective, m = _global_forward_losses(
                state, batch["image"][sl], sem_t[sl], rad_t[sl], group,
                world)
            objective.backward()
            ms.append(m)
        _allreduce_grads(state.model, group, 1.0 / accum_steps)
        _apply_update(state)
        mean = torch.stack(ms).mean(0)
        return state, dict(zip(("loss", "loss_s", "loss_r", "acc"), mean))

    return step, eval_step


def eval_step(state: TrainState, batch):
    """Validation pass in eval mode; ``mae`` sums |err| over every pixel
    (the reference's Val_MAE) and divides by the GT-nonzero count."""
    sem_t, rad_t = _label_maps(batch)
    state.model.eval()
    with torch.no_grad(), _autocast(state):
        seg, radial = state.model(batch["image"])
    loss_s, loss_r, acc = losses(seg, radial, sem_t, rad_t)
    count = torch.clamp((rad_t != 0).sum().to(torch.float32), min=1.0)
    mae = torch.abs(radial - rad_t).sum() / count
    return {"loss": loss_s + loss_r, "loss_s": loss_s, "loss_r": loss_r,
            "acc": acc, "mae": mae}


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@dataclasses.dataclass
class Trainer:
    """Epoch/validate/checkpoint driver (the JAX package's ``Trainer``).

    Data loading and checkpointing are injected so the loop is testable
    without datasets on disk: ``train_batches(epoch)`` or
    ``train_batches(epoch, start_batch)`` and ``val_batches()`` yield dicts
    of numpy arrays or tensors (``data.loader.BatchLoader`` yields device
    tensors; ``cli.run_train`` wires it in). ``mesh`` (a
    ``parallel.data_mesh``) takes the steps of ``make_parallel_steps``:
    with a process group each rank feeds its own shard of the batches.
    """
    cfg: Any
    state: TrainState
    train_batches: Any
    val_batches: Any
    checkpointer: Any = None    # rcvpose_tpu_torch.checkpoint.Checkpointer
    writer: Any = None          # tensorboardX-like, optional
    best_val: float = float("inf")
    iteration: int = 0
    steps: Any = None           # optional (train, eval) step pair
    steps_per_epoch: int = 0    # enables mid-epoch resume fast-forward
    mesh: Any = None            # parallel.Mesh; None: the state's device

    def __post_init__(self):
        if self.steps is not None:
            self._train_step, self._eval_step = self.steps
        elif self.mesh is not None:
            self._train_step, self._eval_step = make_parallel_steps(
                self.mesh, getattr(self.cfg, "accum_steps", 1) or 1)
        else:
            accum = getattr(self.cfg, "accum_steps", 1) or 1
            self._train_step = (make_accum_train_step(accum) if accum > 1
                                else train_step)
            self._eval_step = eval_step

    def train_epoch(self, epoch):
        # Mid-epoch resume skips the batches this epoch consumed before the
        # checkpoint. A factory whose second parameter is literally named
        # start_batch takes the skip as a start index and never yields the
        # skipped batches; any other factory's batches are consumed and
        # discarded here.
        skip = (max(0, self.iteration - epoch * self.steps_per_epoch)
                if self.steps_per_epoch else 0)
        try:
            params = list(inspect.signature(self.train_batches).parameters)
            takes_start = len(params) >= 2 and params[1] == "start_batch"
        except (TypeError, ValueError):
            takes_start = False
        if takes_start:
            batches, skip = self.train_batches(epoch, skip), 0
        else:
            batches = self.train_batches(epoch)
        # Metrics are fetched (one host sync) every log_interval steps; the
        # NaN guard samples at that cadence, and the last pending metrics
        # are fetched before the epoch ends.
        interval = max(getattr(self.cfg, "log_interval", 1) or 1, 1)
        pending = None
        for batch in batches:
            if skip > 0:
                skip -= 1
                continue
            batch = self._place(batch)
            self.state, m = self._train_step(self.state, batch)
            self.iteration += 1
            pending = (self.iteration, m)
            if self.iteration % interval == 0:
                self._fetch_train_metrics(*pending)
                pending = None
            if self.iteration >= self.cfg.max_iterations:
                break
        if pending is not None:
            self._fetch_train_metrics(*pending)

    def _place(self, batch):
        if self.mesh is not None:
            return parallel.shard_batch(self.mesh, batch)
        return _to_device(batch, self.state.device)

    def _fetch_train_metrics(self, iteration, m):
        """NaN guard and the reference's TensorBoard scalars."""
        loss = float(m["loss"])
        if loss != loss:
            raise ValueError("loss is nan while training")
        if self.writer is not None:
            self.writer.add_scalar("Train_sum", loss, iteration)
            self.writer.add_scalar("Train_r", float(m["loss_r"]), iteration)
            self.writer.add_scalar("Train_s", float(m["loss_s"]), iteration)
            self.writer.add_scalar("Train_ACC", float(m["acc"]), iteration)

    def validate(self, epoch):
        total, n = 0.0, 0
        for batch in self.val_batches():
            batch = self._place(batch)
            m = self._eval_step(self.state, batch)
            loss = float(m["loss"])
            if loss != loss:
                raise ValueError("loss is nan while validating")
            total += loss
            n += 1
            if self.writer is not None:
                self.writer.add_scalar("Val_r+s", loss, self.iteration)
                self.writer.add_scalar("Val_MAE", float(m["mae"]),
                                       self.iteration)
                self.writer.add_scalar("Val_ACC", float(m["acc"]),
                                       self.iteration)
                # sem-mask image every 50 val batches (reference
                # train.py:108-109), when the writer takes images; on one
                # process only, as in the JAX package
                if (n % 50 == 0 and hasattr(self.writer, "add_image")
                        and (self.mesh is None or self.mesh.group is None)):
                    self.state.model.eval()
                    with torch.no_grad(), _autocast(self.state):
                        seg, _ = self.state.model(batch["image"][:1])
                    sem_img = (seg[0, :, :, 0] >= 0.5).float()[None]
                    self.writer.add_image("Val_sem", sem_img.cpu().numpy(),
                                          self.iteration)
        mean_loss = total / max(n, 1)
        is_best = mean_loss < self.best_val
        if is_best:
            self.best_val = mean_loss
        if self.checkpointer is not None:
            self.checkpointer.save(self.state, epoch=epoch,
                                   iteration=self.iteration,
                                   best_val=self.best_val, is_best=is_best)
        return mean_loss

    def fit(self, max_epochs):
        # resume lands in the epoch the checkpointed iteration belongs to;
        # train_epoch then fast-forwards within it. Validation (and the
        # checkpoint) runs every val_interval_epochs and after the final
        # epoch, so no run ends without a checkpoint.
        start = (self.iteration // self.steps_per_epoch
                 if self.steps_per_epoch else 0)
        interval = max(getattr(self.cfg, "val_interval_epochs", 1) or 1, 1)
        for epoch in range(start, max_epochs):
            self.train_epoch(epoch)
            done = (self.iteration >= self.cfg.max_iterations
                    or epoch == max_epochs - 1)
            if done or (epoch + 1) % interval == 0:
                self.validate(epoch)
            if done:
                break
        if self.checkpointer is not None:
            self.checkpointer.wait_until_finished()
        return self.state
