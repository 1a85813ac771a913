"""CUDA graphs over the serving nets' forwards and the refinement's ICP.

``GraphedNet`` owns a net (a ``DenseFCNResNet152``) and, for each input
(shape, dtype, device) it has seen, a CUDA graph of the net's eager
forward. A call on the card, with the net in eval mode and grad disabled
(``inference_mode`` or ``no_grad``), copies the input into the graph's
static input, replays the graph (one ``cudaGraphLaunch`` in place of the
forward's ~930 kernel launches) and returns a copy of the graph's outputs
that the next replay cannot overwrite. Everything else runs the eager
forward: the CPU, train mode, grad-enabled calls, and the first call at
an input, which runs eagerly on a side stream (cuDNN's heuristics and
lazy loading happen there) and then captures the same forward. The graph
runs the same kernels as the eager forward, so its outputs equal the
eager ones bit for bit.

The nets of one estimator share a ``GraphPool``: one graph memory pool
(they replay one after another, so one net's graph reuses the memory
another's freed during capture), one lock over the enqueueing of each
replay, and the stream of the last replay, which a replay on another
stream waits for. A copy or a pickle of a ``GraphedNet`` carries no graph
and gets a pool of its own; ``.to()`` and the other tensor moves drop the
graphs, which hold the addresses of the tensors they were captured with.
Weights updated in place (``load_state_dict``, ``copy_``) are read by the
next replay.

``GraphCache`` is the part that knows nothing of nets: one graph of a
function per key, under a ``GraphPool``'s rules above. ``PoseEstimator``
keeps one for ``estimate``'s pose (``_pose_from_maps``) and one for
``refine``'s fixed-iteration ICP beside its nets'.

Counters (``profiling.counters()``), under each cache's prefix:
``graphs.captured`` (one a net and input), ``graphs.replayed`` (one a
replayed forward), ``graphs.eager`` (eval-mode forwards on the card that
ran eagerly); ``pose.captured``, ``pose.replayed`` and ``pose.eager`` for
the pose, ``icp.captured``, ``icp.replayed`` and ``icp.eager`` for
``refine``'s ICP alike. The kernel wrappers' launch counts made during a
capture, which runs nothing, are held back and added at each replay.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch
from torch import nn

from rcvpose_tpu_torch import profiling


class GraphPool:
    """What the graphs of one estimator share (see the module docstring).
    A copy or a pickle is a new, empty pool."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = None      # the stream of the last replay
        self._handle = None

    def __reduce__(self):
        return GraphPool, ()

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


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

    def __call__(self, key, fn, args, copy_out):
        """``fn(*args)`` on the card through the graph at ``key``. ``args``
        are CUDA tensors and numbers (held as f32 device scalars). The first
        call at a key runs ``fn`` eagerly on a side stream (its result is
        the call's) and captures it from static inputs, laid out as the
        first call's ``args`` (so that copying later ones in is a plain
        copy); later calls copy ``args`` into them, replay, and return
        ``copy_out`` of the static outputs, which the next replay
        overwrites."""
        pool = self.pool
        with pool.lock:
            stream = torch.cuda.current_stream(args[0].device)
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
                out = copy_out(graph.out)
            pool.stream = stream
            return out

    def _capture(self, key, fn, args, stream):
        device = args[0].device
        side = torch.cuda.Stream(device)
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
    """``net`` whose eval-mode, grad-free forwards on the card replay a CUDA
    graph (see the module docstring). ``net`` is its only child, so its
    parameters are this module's under the prefix ``net.``."""

    def __init__(self, net, pool=None):
        super().__init__()
        self.net = net
        self.training = net.training
        self._graphs = GraphCache(GraphPool() if pool is None else pool,
                                  "graphs")

    @property
    def pool(self):
        return self._graphs.pool

    def _apply(self, fn, *args, **kwargs):
        self._graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x):
        if x.device.type != "cuda" or self.net.training:
            return self.net(x)
        if torch.is_grad_enabled():
            profiling.count("graphs.eager")
            return self.net(x)
        return self._graphs((x.shape, x.dtype, x.device), self.net, (x,),
                            _own_copy)


def _own_copy(outs):
    """The tensors ``outs`` in memory of their own: each storage they view
    copied once, and the same views of the copy."""
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
