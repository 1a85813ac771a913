"""CUDA graphs over the serving path: the nets' forwards, the pose and the
refinement's ICP.

``GraphCache`` owns the one rule. A call ``cache(key, fn, args)`` whose
first argument is not a CUDA tensor runs ``fn(*args)`` and counts
nothing. On the card with grad enabled it runs ``fn(*args)`` eagerly and
counts ``<prefix>.eager``. Otherwise it holds one CUDA graph of ``fn`` a
key and device: the first call runs ``fn`` eagerly on a side stream
(cuDNN's heuristics and lazy loading happen there) and then captures it;
later calls copy ``args`` into the graph's static inputs, replay it (one
``cudaGraphLaunch`` in place of the host's launches) and return owned
copies of the static outputs, which the next replay cannot overwrite.
The graph runs the same kernels as the eager call, so its outputs equal
the eager ones bit for bit.

``GraphedNet`` owns a serving net (a ``DenseFCNResNet152`` with batch
norm folded, ``models.folded``, which has no train mode) and a cache of
its forwards, one graph an input shape and dtype. ``PoseEstimator`` keeps
two more caches beside its nets': ``estimate``'s pose
(``_pose_from_maps``) and ``refine``'s fixed-iteration ICP.

The caches of one estimator share a ``GraphPool``: one graph memory pool
(they replay one after another, so one graph reuses the memory another
freed during capture), one lock over the enqueueing of each replay, and
the stream of the last replay, which a replay on another stream waits
for. Several estimators may share one pool (``PoseEstimator(...,
graph_pool=)``, ``serve.PoseServer``'s classes on a device): every replay
is copied out before the pool's next one is enqueued, so graphs of
different classes replayed in any order leave each other's outputs
alone. A copy or a pickle of a cache or a ``GraphedNet`` carries no graph
and gets a pool of its own; ``.to()`` and the other tensor moves of a
``GraphedNet`` drop its graphs, which hold the addresses of the tensors
they were captured with. Weights updated in place (``load_state_dict``,
``copy_``) are read by the next replay.

Counters (``profiling.counters()``), under each cache's prefix:
``<prefix>.captured`` (one a graph), ``<prefix>.replayed`` (one a
replay), ``<prefix>.eager`` (calls on the card that ran eagerly, the
first at each key included); the prefixes are ``graphs`` for the nets,
``pose`` and ``icp``; ``graphs.pool.joined`` counts the estimators that
joined a pool another estimator uses. The kernel wrappers' launch counts
made during a capture, which runs nothing, are held back and added at
each replay.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch
from torch import nn

from rcvpose_tpu_torch import profiling


class GraphPool:
    """What the graphs of one or more estimators share (see the module
    docstring). A copy or a pickle is a new, empty pool."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = None      # the stream of the last replay
        self.members = 0        # the estimators that joined
        self._handle = None
        self._side = {}         # device -> the stream captures run on

    def __reduce__(self):
        return GraphPool, ()

    def join(self):
        """Admit one more estimator; counts ``graphs.pool.joined`` from the
        second on."""
        with self.lock:
            if self.members:
                profiling.count("graphs.pool.joined")
            self.members += 1

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def side_stream(self, device):
        """The one stream that the pool's captures on ``device`` run on (a
        stream holds its own cuBLAS workspace, so one a capture would
        hold one workspace a graph)."""
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple               # the static inputs
    out: object                 # the static outputs
    launches: list              # launch counts held back during capture


class GraphCache(dict):
    """The CUDA graphs of calls on the card, one a key, in ``pool``;
    ``prefix`` names their counters. A copy or a pickle is empty, with a
    copy of the pool."""

    def __init__(self, pool, prefix):
        super().__init__()
        self.pool = pool
        self.prefix = prefix

    def __reduce__(self):
        return GraphCache, (self.pool, self.prefix)

    def __call__(self, key, fn, args):
        """``fn(*args)``, through the graph at ``key`` on the card (see the
        module docstring). ``args`` are tensors and numbers (held as f32
        device scalars in a graph). The first call at a key captures from
        static inputs laid out as its ``args`` (so that copying later ones
        in is a plain copy)."""
        device = args[0].device
        if device.type != "cuda":
            return fn(*args)
        if torch.is_grad_enabled():
            profiling.count(f"{self.prefix}.eager")
            return fn(*args)
        key = (key, device)
        pool = self.pool
        with pool.lock:
            stream = torch.cuda.current_stream(device)
            graph = self.get(key)
            if graph is None:
                out = self._capture(key, fn, args, stream)
            else:
                # the pool's graphs share memory: a replay on another
                # stream waits until the last one's outputs are copied out
                if pool.stream is not None and pool.stream != stream:
                    stream.wait_stream(pool.stream)
                for static, x in zip(graph.inputs, args):
                    if torch.is_tensor(x):
                        static.copy_(x)
                    else:
                        static.fill_(x)
                graph.graph.replay()
                profiling.count_launches(graph.launches)
                profiling.count(f"{self.prefix}.replayed")
                out = _own_copy(graph.out)
            pool.stream = stream
            return out

    def _capture(self, key, fn, args, stream):
        device = args[0].device
        side = self.pool.side_stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = fn(*args)
        profiling.count(f"{self.prefix}.eager")
        with torch.inference_mode(False):
            inputs = tuple(
                torch.empty_like(x) if torch.is_tensor(x)
                else torch.empty((), dtype=torch.float32, device=device)
                for x in args)
        graph = torch.cuda.CUDAGraph()
        with profiling.held_launches() as launches:
            with torch.cuda.graph(graph, pool=self.pool.handle(),
                                  stream=side,
                                  capture_error_mode="thread_local"):
                static = fn(*inputs)
        stream.wait_stream(side)
        for t in (out if isinstance(out, tuple) else (out,)):
            t.record_stream(stream)
        self[key] = _Graph(graph, inputs, static, launches)
        profiling.count(f"{self.prefix}.captured")
        return out


class GraphedNet(nn.Module):
    """``net`` whose forwards go through a ``GraphCache`` (see the module
    docstring). ``net`` is its only child, so its buffers are this
    module's under the prefix ``net.``."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.training = net.training
        self._graphs = GraphCache(GraphPool(), "graphs")

    @property
    def pool(self):
        return self._graphs.pool

    def use_pool(self, pool):
        """Capture in ``pool`` from now on; the graphs held are dropped."""
        self._graphs = GraphCache(pool, "graphs")

    def _apply(self, fn, *args, **kwargs):
        self._graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x):
        return self._graphs((x.shape, x.dtype), self.net, (x,))


def _own_copy(outs):
    """A tensor or a tuple of tensors ``outs`` in memory of their own:
    each storage they view copied once, and the same views of the copy."""
    if torch.is_tensor(outs):
        return _own_copy((outs,))[0]
    copies = {}
    res = []
    for t in outs:
        storage = t.untyped_storage()
        flat = copies.get(storage.data_ptr())
        if flat is None:
            n = storage.nbytes() // t.element_size()
            flat = copies[storage.data_ptr()] = t.as_strided(
                (n,), (1,), 0).clone()
        res.append(flat.as_strided(t.shape, t.stride(), t.storage_offset()))
    return tuple(res)
