"""Batching with background prefetch and labels made on the device (the
port's counterpart of ``rcvpose_tpu.data.loader``).

A producer thread reads raw frames (``dataset.raw_batch`` / ``raw`` /
``raw_multi``), stacks them on the host (depth cast to f32 there, as the
JAX loader does) and, when the device is CUDA, pins them. The consumer
copies each batch to the device (``non_blocking`` from pinned memory) and
makes its labels there with ``labels.make_sample``; it dispatches batch
k+1's copy and labels before it yields batch k, so both overlap the
caller's step.

The frame order is the JAX loader's: epoch ``e``'s permutation is
``np.random.default_rng((seed, e))``, a pure function of the seed and the
epoch, sharded ``rank::count`` and trimmed to a common length.

One deliberate divergence from the JAX loader: there, a read that raises
in the producer ends the epoch early with no word (its ``try/finally``
enqueues the stop marker and the exception dies with the thread). Here the
producer hands its exception to the consumer, which re-raises it, so a
corrupt or missing frame stops training instead of shortening the epoch.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from rcvpose_tpu_torch import labels
from rcvpose_tpu_torch.utils import resolve_device


def _stack_raw(samples):
    if "radial_dm" in samples[0]:  # precomputed labels (YCB HDF5 route)
        return {
            "image": np.stack([s["image"] for s in samples]),
            "radial_dm": np.stack([s["radial_dm"] for s in samples]),
        }
    return {
        "image": np.stack([s["image"] for s in samples]),
        "depth": np.stack([s["depth"] for s in samples]).astype(np.float32),
        "mask": np.stack([s["mask"] for s in samples]),
        "pose": np.stack([s["pose"] for s in samples]).astype(np.float32),
    }


class _Raised:
    """A producer's exception on its way to the consumer."""

    def __init__(self, exc):
        self.exc = exc


class BatchLoader:
    """Iterable of device batches ``{image, radial, sem}`` (f32,
    even-cropped; radial/sem (B, H, W), or (B, H, W, K) for
    ``kpt_heads > 1``).

    ``kpt_heads > 1`` makes one radial/sem pair per keypoint (rows 1..K of
    the dataset's keypoint array) on the fly from datasets with keypoint
    geometry (LINEMOD), or stacks the per-keypoint precomputed maps of
    ``dataset.raw_multi`` (the YCB HDF5 route). ``ycb_clip`` zeroes radii
    >= 10 dm (the reference's YCB filter). ``shard_rank/shard_count``:
    every rank draws the same permutation and takes its disjoint
    ``rank::count`` slice, trimmed so that every rank yields the same
    number of batches. ``device``: the card unless ``"cpu"`` is named.

    ``stats`` counts, over this loader's life, the batches the consumer
    took (``batches``) and the host seconds it blocked waiting for the
    producer (``wait_s``).
    """

    def __init__(self, dataset, k, batch_size, shuffle=True, seed=0,
                 prefetch=2, drop_last=True, ycb_clip=False, kpt_heads=1,
                 shard_rank=0, shard_count=1, device=None):
        if not (0 <= shard_rank < shard_count):
            raise ValueError(f"shard_rank {shard_rank} not in "
                             f"[0, {shard_count})")
        self.ds = dataset
        self.k = np.asarray(k, np.float32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._auto_epoch = 0  # epoch counter for bare iter() calls
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.ycb_clip = ycb_clip
        self.kpt_heads = kpt_heads
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self.device = resolve_device(device)
        self.stats = {"batches": 0, "wait_s": 0.0}

        has_geometry = hasattr(dataset, "kpt")
        multi = kpt_heads > 1
        # multi-head labels come from keypoint geometry (on the fly) or
        # from the dataset's per-keypoint precomputed maps (raw_multi)
        self._multi_precomputed = (multi and not hasattr(dataset, "keypoints")
                                   and hasattr(dataset, "raw_multi"))
        if multi and not hasattr(dataset, "keypoints") \
                and not self._multi_precomputed:
            raise ValueError(
                "kpt_heads > 1 needs a dataset with either a keypoints "
                "array (on-the-fly label route) or per-keypoint "
                "precomputed maps (raw_multi, the YCB HDF5 route)")
        f32, dev = torch.float32, self.device
        if multi and not self._multi_precomputed:
            kpt = np.asarray(dataset.keypoints[1:1 + kpt_heads])   # (K, 3)
            maxr = dataset.max_radii_for(range(1, 1 + kpt_heads))
        else:
            kpt = self.ds.kpt if has_geometry else np.zeros(3)
            maxr = self.ds.max_radii_dm if has_geometry else 0.0
        self._kpt = torch.as_tensor(np.asarray(kpt, np.float32), device=dev)
        self._maxr = torch.as_tensor(np.asarray(maxr, np.float32), device=dev)
        self._kmat = torch.as_tensor(self.k, dtype=f32, device=dev)

    def _shard_len(self):
        # floor(n / count) for EVERY rank: uniform step counts across ranks
        return len(self.ds) // self.shard_count if self.shard_count > 1 \
            else len(self.ds)

    def __len__(self):
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_order(self, epoch=0):
        """Epoch ``epoch``'s sample permutation: a pure function of
        ``(seed, epoch)``, so a resumed run replays the batch sequence of
        the unbroken one and every rank draws the same permutation."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        if self.shard_count > 1:
            idx = idx[self.shard_rank::self.shard_count][:self._shard_len()]
        return idx

    def __iter__(self):
        epoch = self._auto_epoch
        self._auto_epoch += 1
        return self.batches(epoch)

    def _read(self, sel):
        if self._multi_precomputed:
            samples = [self.ds.raw_multi(int(i), self.kpt_heads)
                       for i in sel]
        elif hasattr(self.ds, "raw_batch"):
            samples = self.ds.raw_batch(sel)
        else:
            samples = [self.ds.raw(int(i)) for i in sel]
        item = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in _stack_raw(samples).items()}
        if self.device.type == "cuda":
            item = {k: v.pin_memory() for k, v in item.items()}
        return item

    def _transform(self, item):
        """Copy a stacked host batch to the device and make its labels
        there."""
        item = {k: v.to(self.device, non_blocking=True)
                for k, v in item.items()}
        if "radial_dm" in item:
            im = labels.normalize_image(item["image"])
            radial = item["radial_dm"].to(torch.float32)
            if self.ycb_clip:
                radial = torch.where(radial >= 10.0, 0.0, radial)
            sem = torch.where(radial > 0, 1.0, -1.0)
            im, radial, sem = labels.even_crop(im, radial, sem)
            return {"image": im, "radial": radial, "sem": sem}
        return labels.make_sample(item["image"], item["depth"], item["mask"],
                                  item["pose"], self._kpt, self._kmat,
                                  self._maxr, ycb_clip=self.ycb_clip)

    def batches(self, epoch, start_batch=0):
        """Epoch ``epoch``'s device batches, starting at batch index
        ``start_batch``; the skipped prefix is never read nor labelled
        (the index-level mid-epoch resume)."""
        order = self._index_order(epoch)
        nb = len(self)
        start_batch = min(max(start_batch, 0), nb)
        q = queue.Queue(maxsize=self.prefetch)
        stop, closing = object(), threading.Event()

        def put(item):
            # gives up once the consumer has gone away, so an abandoned
            # epoch does not leave the thread blocked on a full queue
            while not closing.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(start_batch, nb):
                    sel = order[b * self.batch_size:(b + 1) * self.batch_size]
                    if not put(self._read(sel)):
                        return
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                put(_Raised(exc))
            finally:
                put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            pending = None
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.stats["wait_s"] += time.perf_counter() - t0
                if item is stop:
                    break
                if isinstance(item, _Raised):
                    # the batches read before the error go out first
                    if pending is not None:
                        yield pending
                    raise item.exc
                self.stats["batches"] += 1
                nxt = self._transform(item)
                if pending is not None:
                    yield pending
                pending = nxt
            if pending is not None:
                yield pending
        finally:
            closing.set()


def make_loaders(cfg, dataset_cls=None, shard_rank=None, shard_count=None,
                 device=None, progress=print):
    """(train_loader, val_loader), both on the 'val' split as the
    reference does (data_loader.py:123).

    The train loader shards the dataset across processes; ``shard_rank``
    and ``shard_count`` default to ``torch.distributed``'s rank and world
    size when it is initialized, else 0 and 1. The val loader stays
    full-set on every rank, so each rank takes the same best-checkpoint
    decision. For a dataset that reads ``.dpt`` depth, ``progress`` is
    told which depth reader runs (native or numpy).
    """
    import torch.distributed as dist

    from rcvpose_tpu_torch import geometry, native
    from rcvpose_tpu_torch.data.dataset import LinemodDataset, YcbDataset

    on = dist.is_available() and dist.is_initialized()
    if shard_rank is None:
        shard_rank = dist.get_rank() if on else 0
    if shard_count is None:
        shard_count = dist.get_world_size() if on else 1
    if dataset_cls is None:
        dataset_cls = LinemodDataset if cfg.dataset == "lm" else YcbDataset
    train_ds = dataset_cls(cfg.root_dataset, cfg.class_name,
                           kpt_num=cfg.kpt_num, split="val")
    val_ds = dataset_cls(cfg.root_dataset, cfg.class_name,
                         kpt_num=cfg.kpt_num, split="val")
    if hasattr(train_ds, "raw_batch"):
        progress(f"loader: {native.describe()}")
    k = geometry.LINEMOD_K
    ycb = cfg.dataset != "lm"
    heads = getattr(cfg, "kpt_heads", 1)
    train = BatchLoader(train_ds, k, cfg.batch_size, shuffle=True,
                        seed=cfg.seed, prefetch=cfg.num_prefetch,
                        ycb_clip=ycb, kpt_heads=heads,
                        shard_rank=shard_rank, shard_count=shard_count,
                        device=device)
    val = BatchLoader(val_ds, k, cfg.batch_size, shuffle=False,
                      seed=cfg.seed, prefetch=cfg.num_prefetch, ycb_clip=ycb,
                      kpt_heads=heads, device=device)
    return train, val
