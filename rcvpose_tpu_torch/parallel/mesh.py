"""Device meshes of the port (counterpart of ``rcvpose_tpu.parallel.mesh``).

The JAX package's data parallelism is one ``jax.jit`` over a batch sharded
on a 1-D ``data`` mesh that may span processes. A port ``Mesh`` has the
same two parts, in PyTorch's terms:

* ``devices``: the local device slots this process runs on (one card per
  slot; CPU tests may repeat ``torch.device("cpu")`` to get several slots
  on one device);
* ``group``: the ``torch.distributed`` process group across processes, or
  None on one process.

Training puts one card in each process and makes the global batch out of
the processes' batches (``train.make_parallel_steps``). Evaluation splits a
batch of frames over the local slots, one thread per card
(``sharded_frame_pose``/``sharded_frame_scores``), and crosses processes
only in the host-side metric reductions (``host_allgather``).
``sharded_vote_counts`` splits a point cloud over every slot of every
process and sums the per-voxel counts with ``all_reduce``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from rcvpose_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Local device slots and the process group across processes."""
    devices: tuple
    group: Any = None

    @property
    def size(self):
        """Local slots."""
        return len(self.devices)

    @property
    def world(self):
        """Processes in the group (1 without one)."""
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self):
        return 0 if self.group is None else dist.get_rank(self.group)


def _multi_process(group=None):
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) > 1)


def process_count():
    """Processes of the default process group (1 without one)."""
    return dist.get_world_size() if _multi_process() else 1


def process_index():
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if _multi_process() else 0


def canonical_device(device):
    """``cuda`` -> ``cuda:<current>``, so that devices compare by card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices(device=None):
    """The devices this process may run on: every card (the card it is
    pinned to when it is one rank of several), or the CPU when
    ``device="cpu"``. ``None`` means the card, and raises without one."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    if _multi_process():
        return [canonical_device(dev)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(n_devices=None, devices=None):
    """1-D data mesh over ``n_devices`` devices of the whole world.

    ``devices``: this process's slots (default ``local_devices()``). Under
    an initialized process group of several ranks the mesh spans them
    all, each contributing ``n_devices / world`` of its slots, as the JAX
    package's multi-host mesh does; ``n_devices`` must then be a multiple
    of the world size."""
    group = dist.group.WORLD if _multi_process() else None
    world = dist.get_world_size() if group is not None else 1
    if devices is None:
        devices = local_devices()
    if n_devices is not None:
        if n_devices % world:
            raise ValueError(f"multi-process mesh size {n_devices} must be "
                             f"a multiple of the process count {world}")
        devices = list(devices)[:n_devices // world]
    return Mesh(tuple(torch.device(d) for d in devices), group)


def local_data_mesh(device=None):
    """Mesh over this process's own devices and no process group: the
    process-sharded evaluation runs its shard here, with no collective
    inside the frame program."""
    return Mesh(tuple(local_devices(device)), None)


def _collective_device(group=None):
    """Where a collective's tensors live: the current card for NCCL, the
    CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(t, group=None):
    """``dist.all_reduce(SUM)`` of ``t`` in place, through the collective
    device: a CUDA tensor under gloo is reduced in a host copy. Returns
    ``t``."""
    dev = _collective_device(group)
    if t.device == dev or (t.device.type == dev.type == "cuda"):
        dist.all_reduce(t, group=group)
        return t
    host = t.to(dev)
    dist.all_reduce(host, group=group)
    t.copy_(host)
    return t


def host_allgather(x, group=None):
    """One same-shaped host array per process -> stacked ``(world, ...)``
    numpy array in rank order, of ``x``'s dtype (carried as float32, as
    the JAX package's metric vectors are). A collective: every process
    calls it the same number of times in the same order. On one process
    it returns ``x[None]``."""
    x = np.asarray(x)
    if not _multi_process(group):
        return x[None]
    t = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                        device=_collective_device(group))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return np.stack([p.cpu().numpy() for p in parts]).astype(x.dtype)


def host_allgather_concat(x, group=None):
    """Concatenate variable-length 1-D host arrays across processes, in
    rank order: two allgathers, the lengths and then the padded values."""
    x = np.asarray(x, np.float32).reshape(-1)
    lens = host_allgather(np.array([x.size], np.int32), group)[:, 0]
    m = max(int(lens.max()) if lens.size else 0, 1)
    pad = np.zeros((m,), np.float32)
    pad[:x.size] = x
    rows = host_allgather(pad, group)
    return np.concatenate([rows[i, :int(lens[i])]
                           for i in range(len(lens))])


def warm_collectives(mesh):
    """One small all-reduce right after the group is made, so that the
    communicators are set up while the ranks are close together and not
    inside the first step. No-op without a group."""
    if mesh.group is None:
        return
    all_reduce(torch.zeros(1, device=_collective_device(mesh.group)),
               mesh.group)


def shard_batch(mesh, batch):
    """This process's share of the global batch, on its device. Every rank
    already holds its own rows (``BatchLoader`` shards by rank), so this
    moves them to the mesh's first slot."""
    dev = mesh.devices[0]
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def sharded_vote_counts(mesh, voxels, points, lo, hi):
    """Vote counts with the points split over every slot of every process
    and the (V,) counts summed with ``all_reduce``.

    Every rank passes the whole (N, 3) points and (N,) bands, N a multiple
    of the mesh's world size times its slots (masked entries have lo = hi
    = 0); slot ``j`` of the world counts points ``[j N / S, (j + 1) N /
    S)`` with ``voting.vote_counts`` (K1 on a card). Counts are integers
    below 2^24 in f32, so the sum is exact. Returns the (V,) counts on the
    first slot, on every rank."""
    from rcvpose_tpu_torch.ops import voting

    slots = mesh.size * mesh.world
    n = points.shape[0]
    if n % slots:
        raise ValueError(f"{n} points are not padded to a multiple of the "
                         f"mesh's {slots} slots")
    per = n // slots
    first = mesh.rank * mesh.size
    total = None
    for i, dev in enumerate(mesh.devices):
        sl = slice((first + i) * per, (first + i + 1) * per)
        part = voting.vote_counts(voxels.to(dev), points[sl][None].to(dev),
                                  lo[sl][None].to(dev),
                                  hi[sl][None].to(dev))[0]
        part = part.to(mesh.devices[0])
        total = part if total is None else total + part
    if mesh.group is not None:
        all_reduce(total, mesh.group)
    return total


def _is_fused(net):
    """A tuple/list of 3 networks = per-keypoint nets; one network = the
    fused multi-head net."""
    return not isinstance(net, (tuple, list))


_replicas = weakref.WeakKeyDictionary()   # module -> {device: replica}
_replicas_lock = threading.Lock()


def _module_replica(module, device):
    home = canonical_device(next(module.parameters()).device)
    device = canonical_device(device)
    if home == device:
        return module
    with _replicas_lock:
        per = _replicas.setdefault(module, {})
        if device not in per:
            per[device] = copy.deepcopy(module).to(device)
        return per[device]


def _replica(net, device):
    """``net`` (one module, or a tuple of them) on ``device``; copies are
    made once and kept while the module lives."""
    if net is None:
        return None
    if _is_fused(net):
        return _module_replica(net, device)
    return tuple(_module_replica(m, device) for m in net)


def _over_slots(mesh, net, batch, run):
    """Split ``batch`` frames over the mesh's slots and run ``run(device,
    replica, rows)`` on each, one thread per distinct device; returns the
    per-frame dict in frame order on the first slot."""
    n = mesh.size
    if batch % n:
        raise ValueError(f"batch {batch} is not a multiple of the mesh "
                         f"size {n}")
    per = batch // n
    jobs = [(dev, _replica(net, dev), slice(i * per, (i + 1) * per))
            for i, dev in enumerate(mesh.devices)]

    def one(job):
        dev = job[0]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            return run(*job)

    if len({canonical_device(d) for d in mesh.devices}) > 1:
        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(one, jobs))
    else:
        outs = [one(job) for job in jobs]
    dev0 = mesh.devices[0]
    return {key: torch.cat([o[key].to(dev0) for o in outs])
            for key in outs[0]}


def sharded_frame_pose(mesh, net, images_norm, depths_mm, k, max_radii_dm,
                       gt_kpts_mm, fused=None, **kw):
    """Data-parallel serving program: a batch of B frames split over the
    mesh's slots, each slot running the whole frame program (net -> vote
    -> Horn, ``infer.frame_pose_batch``) on its frames with its replica of
    the weights. B must be a multiple of the mesh size. Returns the
    batched frame dict in frame order.

    ``net``: a tuple/list of 3 per-keypoint networks or one fused network;
    the container type picks the path when ``fused`` is None."""
    from rcvpose_tpu_torch import infer

    if fused is None:
        fused = _is_fused(net)
    batch_fn = (infer.frame_pose_fused_batch if fused
                else infer.frame_pose_batch)

    def run(dev, net_d, rows):
        return batch_fn(net_d, images_norm[rows].to(dev),
                        depths_mm[rows].to(dev), k.to(dev),
                        max_radii_dm.to(dev), gt_kpts_mm.to(dev), **kw)

    return _over_slots(mesh, net, images_norm.shape[0], run)


def sharded_frame_scores(mesh, net, images_norm, depths_mm, rt_gts_mm, k,
                         max_radii_dm, gt_kpts_mm, cad_mm, sym, **kw):
    """Data-parallel dataset evaluation: the full per-frame eval program
    (net forward -> 3x vote -> Horn -> ADD -> ICP -> ADD,
    ``eval._frame_scores``, the sequential loops' math) over a batch of
    frames split over the mesh's slots.

    ``net=None`` evaluates precomputed maps: pass ``(sems, radials)``, each
    (B, 3, H, W), as ``images_norm``. ``k`` is per frame, (B, 3, 3);
    ``rt_gts_mm`` (B, 3, 4) with the translation in mm. B must be a
    multiple of the mesh size. Returns per-frame ``rt``, ``rt2``,
    ``score_bf``/``score_af`` (mm) and ``overflow`` (B, 3)."""
    from rcvpose_tpu_torch import eval as eval_mod

    maps = net is None
    batch = (images_norm[0] if maps else images_norm).shape[0]

    def run(dev, net_d, rows):
        shared = (max_radii_dm.to(dev), gt_kpts_mm.to(dev), cad_mm.to(dev),
                  bool(sym))
        outs = []
        for i in range(rows.start, rows.stop):
            per = (depths_mm[i].to(dev), k[i].to(dev))
            if maps:
                sems, radials = images_norm
                out = eval_mod._frame_scores(
                    sems[i].to(dev), radials[i].to(dev), *per, *shared[:3],
                    rt_gts_mm[i].to(dev), shared[3], **kw)
            else:
                out = eval_mod._frame_scores_net(
                    net_d, images_norm[i].to(dev), *per, *shared[:3],
                    rt_gts_mm[i].to(dev), shared[3], **kw)
            outs.append(out)
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return _over_slots(mesh, net, batch, run)
