"""Network pose-serving daemon (counterpart of ``rcvpose_tpu.serve``).

A long-lived process keeps the weights on the card and answers pose
queries over TCP: ``infer.PoseEstimator`` (the escalation-checked serving
path) behind the JAX package's length-prefixed protocol, with nothing
beyond the standard library, so that either package's ``PoseClient``
talks to either package's ``PoseServer``.

Wire protocol (all lengths big-endian uint32; connections are persistent,
many requests per connection, FIFO):

  request  = [header_len][header JSON][payload bytes]
    {"op": "ping"}                                   -> no payload
    {"op": "pose", "h": H, "w": W,
     "icp": bool?, "icp_threshold_mm": float?,
     "icp_iters": int?, "class_name": str?}          -> payload =
        H*W*3 uint8 RGB (row-major) ++ H*W float32 little-endian depth (mm)

  response = [len][JSON]
    ping  -> {"ok": true, "pong": true}
    pose  -> {"ok": true, "rt": [[..]x4] (mm), "centers": [[..]x3] (mm),
              "counts": [..], "overflow": [..], "ms": float,
              "icp_applied": bool, "device": int}
    error -> {"ok": false, "error": "..."}  (connection stays usable)

Each card runs one request at a time (one execution lock per device
slot); concurrent requests go round-robin to the slots through
per-device estimator replicas (``PoseEstimator.replicate_to``), and
``device`` in the reply names the slot that served the request.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import socketserver
import struct
import threading
import time

import numpy as np
import torch

from rcvpose_tpu_torch import parallel
from rcvpose_tpu_torch.models import graphs
from rcvpose_tpu_torch.utils import synchronize

_MAX_HEADER = 1 << 16
_MAX_PAYLOAD = 1 << 28  # 256 MB: a 4096x4096 RGB-D frame is ~117 MB


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def _recv_exact(sock, n):
    """Read exactly n bytes or raise ConnectionError on EOF."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_json(sock, obj):
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_json(sock, limit=_MAX_HEADER):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > limit:
        raise ValueError(f"message of {n} bytes exceeds the {limit} limit")
    return json.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

def _same(a, b):
    return (parallel.mesh.canonical_device(a)
            == parallel.mesh.canonical_device(b))


def _on_device(device):
    """The context a replica on ``device`` runs in: its card is the
    current one, so every launch goes there."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Pool:
    """One class's estimator replicas, indexed by device slot."""

    __slots__ = ("replicas", "building")

    def __init__(self, base):
        self.replicas = {0: base}   # device slot -> PoseEstimator
        self.building = False       # a background replica build is running


class PoseServer:
    """Serve one or many classes' ``PoseEstimator``s over TCP.

    ``estimator`` is the default ``infer.PoseEstimator`` (weights loaded),
    used when a pose request names no class; give it ``cad_mm`` if clients
    will ask for ICP. ``estimator_factory(class_name) -> PoseEstimator``
    lets pose requests carry ``"class_name"``: estimators are built on
    first use, under a per-class build lock and outside the execution
    locks, so a cold class's checkpoint load does not stall traffic to
    warm classes, and cached for the server's lifetime. ``warm_classes``
    builds a list before the socket opens (``--serve_classes``).

    ``devices`` (default: the cards of ``parallel.local_devices``, or the
    CPU when the estimator lives there; a list may repeat a device to get
    several slots on it) is the scale-out set. Execution serializes per
    slot (one lock each, shared by all classes); concurrent requests go
    round-robin to free slots, each served by that slot's replica.
    Replicas beyond slot 0 are built lazily, in a background thread, the
    first time every built replica of a class is busy at once; the
    triggering request blocks on a busy slot as a one-slot server would.
    ``expand_to`` builds replicas synchronously (``--serve_devices``).
    Every ``infer.PoseEstimator`` the server places on a device builds its
    CUDA graphs in that device's one ``models.graphs.GraphPool``
    (``join_graph_pool``), so the classes' graphs share memory.

    With both ``estimator`` and ``estimator_factory``, pass ``class_name``
    (the default estimator's class), or a request naming that class
    builds a duplicate. ``warmup_hw`` runs the default estimator once at
    that (H, W) before the socket opens.
    """

    def __init__(self, estimator=None, warmup_hw=None,
                 estimator_factory=None, class_name=None, devices=None):
        if devices is not None:
            self._devices = [torch.device(d) for d in devices]
        else:
            self._devices = parallel.local_devices(
                None if estimator is None else estimator.device)
        self._graph_pools = {}              # device -> its one GraphPool
        if estimator is not None:
            # the base estimator lives on the first slot's device
            estimator = self._place(estimator, self._devices[0])
        self.estimator = estimator
        self._factory = estimator_factory
        self._pools = {}                    # class_name -> _Pool
        self._default_pool = None           # pool for class_name=None
        if estimator is not None:
            self._default_pool = _Pool(estimator)
            if class_name is not None:
                self._pools[class_name] = self._default_pool
        # one EXECUTION lock per slot, shared across classes
        self._dev_locks = [threading.Lock() for _ in self._devices]
        self._rr = 0                        # round-robin dispatch cursor
        self._rr_lock = threading.Lock()
        self._reg_lock = threading.Lock()   # pool cache + build locks
        self._build_locks = {}              # class_name -> threading.Lock
        self._warmup_hw = warmup_hw
        self._server = None
        self._thread = None
        if warmup_hw is not None and estimator is not None:
            self._warm_estimator(estimator, warmup_hw)

    # -- request handling ---------------------------------------------------

    @staticmethod
    def _warm_estimator(est, hw):
        """Run an estimator once at (H, W): a zero image with a plausible
        depth plateau (kernels built and loaded, caches warm)."""
        h, w = hw
        img = np.zeros((h, w, 3), np.uint8)
        dep = np.zeros((h, w), np.float32)
        dep[h // 3:2 * h // 3, w // 3:2 * w // 3] = 700.0
        with _on_device(est.device):
            est.estimate(img, dep)
            synchronize(est.device)

    def warm_classes(self, class_names, hw=None):
        """Build and warm the estimators of ``class_names`` (the
        ``--serve_classes`` warmup, before the socket opens)."""
        for name in class_names:
            self._pool_for(name, hw=hw or self._warmup_hw)

    def _pool_for(self, class_name, hw=None):
        """A pose request's replica pool. Called without any execution
        lock; the per-class build lock makes concurrent first requests for
        one class build it once, and ``hw`` warms it before the pool is
        published."""
        if class_name is None:
            if self._default_pool is None:
                raise ValueError(
                    "server has no default estimator; pose requests must "
                    "carry a class_name")
            return self._default_pool
        pool = self._pools.get(class_name)
        if pool is not None:
            return pool
        if self._factory is None:
            raise ValueError(
                f"server hosts a single class and no estimator factory; "
                f"cannot serve class_name={class_name!r}")
        with self._reg_lock:
            build_lock = self._build_locks.setdefault(class_name,
                                                      threading.Lock())
        with build_lock:
            pool = self._pools.get(class_name)
            if pool is not None:  # built while we waited
                return pool
            est = self._place(self._factory(class_name), self._devices[0])
            if hw is not None:
                self._warm_estimator(est, hw)
            pool = _Pool(est)
            self._pools[class_name] = pool
        return pool

    def _place(self, est, device, copy=False):
        """``est`` (a replica of it, where it lives elsewhere or ``copy``)
        on ``device``, building its graphs in the device's one pool."""
        if copy or not _same(est.device, device):
            est = est.replicate_to(device)
        join = getattr(est, "join_graph_pool", None)
        if join is not None:
            join(self._graph_pools.setdefault(
                parallel.mesh.canonical_device(device), graphs.GraphPool()))
        return est

    # -- replica dispatch ---------------------------------------------------

    def n_replicas(self, class_name=None):
        """Built replica count of a class."""
        pool = (self._default_pool if class_name is None
                else self._pools.get(class_name))
        return 0 if pool is None else len(pool.replicas)

    def expand_to(self, n_devices=None, class_name=None, hw=None):
        """Build and warm replicas of ``class_name`` on the first
        ``n_devices`` slots (None/0 = all); returns the replica count."""
        pool = self._pool_for(class_name, hw=hw or self._warmup_hw)
        n = len(self._devices) if not n_devices else min(
            int(n_devices), len(self._devices))
        for i in range(n):
            self._build_replica(pool, i, hw or self._warmup_hw)
        return len(pool.replicas)

    def _build_replica(self, pool, i, hw):
        """Build (and optionally warm) pool replica ``i``; idempotent. A
        replica is published only once warm, so dispatch never waits on
        another request's build."""
        with self._reg_lock:
            if i in pool.replicas:
                return
            base = pool.replicas[min(pool.replicas)]
            est = self._place(base, self._devices[i], copy=True)
        if hw is not None:
            self._warm_estimator(est, hw)
        with self._reg_lock:
            pool.replicas.setdefault(i, est)

    def _maybe_grow(self, pool, hw):
        """Every built replica of this class is busy: build one more on
        the next unused slot, in the background (one build in flight per
        pool)."""
        with self._reg_lock:
            if pool.building or len(pool.replicas) >= len(self._devices):
                return
            i = next(j for j in range(len(self._devices))
                     if j not in pool.replicas)
            pool.building = True

        def build():
            try:
                self._build_replica(pool, i, hw)
            finally:
                pool.building = False

        threading.Thread(target=build, daemon=True).start()

    def _acquire_replica(self, pool, hw):
        """A replica whose slot is free (round-robin over the built ones);
        if every one is busy, trigger growth and block on the round-robin
        slot. Returns (slot, estimator) with that slot's lock held."""
        with self._rr_lock:
            start = self._rr
            self._rr += 1
        # snapshot under the registry lock: a background build publishes
        # into pool.replicas concurrently
        with self._reg_lock:
            built = sorted(pool.replicas)
        for j in range(len(built)):
            i = built[(start + j) % len(built)]
            if self._dev_locks[i].acquire(blocking=False):
                return i, pool.replicas[i]
        self._maybe_grow(pool, hw)
        i = built[start % len(built)]
        self._dev_locks[i].acquire()
        return i, pool.replicas[i]

    def _handle_pose(self, header, payload):
        h, w = int(header["h"]), int(header["w"])
        if h <= 0 or w <= 0 or h * w > (1 << 24):
            raise ValueError(f"bad frame shape ({h}, {w})")
        need = h * w * 3 + h * w * 4
        if len(payload) != need:
            raise ValueError(
                f"payload is {len(payload)} bytes, expected {need} "
                f"for a ({h}, {w}) RGB-D frame")
        buf = bytearray(payload)   # writable: torch takes it as is
        image = np.frombuffer(buf, np.uint8, h * w * 3).reshape(h, w, 3)
        depth = np.frombuffer(buf, "<f4", h * w, h * w * 3).reshape(h, w)
        class_name = header.get("class_name")

        t0 = time.perf_counter()
        # a cold class's build happens outside the execution locks
        pool = self._pool_for(class_name, hw=(h, w))
        dev_i, est = self._acquire_replica(pool, hw=(h, w))
        try:
            with _on_device(est.device):
                result = est.estimate(image, depth)
                rt = result["rt"]
                icp_applied = False
                if header.get("icp"):
                    if est.cad_mm is None:
                        raise ValueError(
                            "server was started without a CAD model; ICP "
                            "refinement is unavailable")
                    rt = est.refine(
                        result,
                        threshold_mm=float(header.get("icp_threshold_mm",
                                                      20.0)),
                        icp_iters=(int(header["icp_iters"])
                                   if "icp_iters" in header else None))
                    icp_applied = True
                # one device-to-host copy for everything the reply needs
                k = result["centers"].shape[0]
                flat = torch.cat([
                    rt.reshape(-1).float(),
                    result["centers"].reshape(-1).float(),
                    result["counts"].reshape(-1).float(),
                    result["overflow"].reshape(-1).float()]).cpu().numpy()
        finally:
            self._dev_locks[dev_i].release()
        ms = (time.perf_counter() - t0) * 1e3
        flat = flat.astype(np.float64)
        reply = {
            "ok": True,
            "rt": flat[:16].reshape(4, 4).tolist(),
            "centers": flat[16:16 + 3 * k].reshape(k, 3).tolist(),
            "counts": flat[16 + 3 * k:16 + 4 * k].tolist(),
            "overflow": (flat[16 + 4 * k:] > 0).tolist(),
            "ms": round(ms, 3),
            "icp_applied": icp_applied,
            "device": dev_i,
        }
        if class_name is not None:
            reply["class_name"] = class_name
        return reply

    def _handle_connection(self, sock, recv_timeout=300.0):
        # a half-sent frame must not wedge the connection forever: the
        # payload length comes from (h, w), so a client that stops
        # mid-frame looks like a slow sender until this fires
        sock.settimeout(recv_timeout)
        while True:
            try:
                header = _recv_json(sock)
            except (ConnectionError, TimeoutError, struct.error, OSError):
                return  # clean disconnect (or gave up on a stalled peer)
            except (ValueError, json.JSONDecodeError) as exc:
                # framing error: the byte stream is out of step and
                # nothing after this point can be parsed; report and close
                try:
                    _send_json(sock, {"ok": False,
                                      "error": f"framing: {exc}"})
                except OSError:
                    pass
                return
            try:
                op = header.get("op")
                if op == "ping":
                    _send_json(sock, {"ok": True, "pong": True})
                    continue
                if op == "pose":
                    h, w = int(header["h"]), int(header["w"])
                    need = h * w * 3 + h * w * 4
                    if need > _MAX_PAYLOAD or need < 0:
                        raise ValueError(f"frame too large ({need} bytes)")
                    payload = _recv_exact(sock, need)
                    _send_json(sock, self._handle_pose(header, payload))
                    continue
                raise ValueError(f"unknown op {op!r}")
            except (ConnectionError, TimeoutError):
                return
            except Exception as exc:  # report, keep the connection alive
                try:
                    _send_json(sock, {"ok": False, "error": str(exc)})
                except OSError:
                    return

    # -- lifecycle ----------------------------------------------------------

    def start(self, host="127.0.0.1", port=0):
        """Bind and serve in a background thread; returns (host, port)."""
        handle = self._handle_connection

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                handle(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self._server.server_address[:2]

    def serve_forever(self, host="127.0.0.1", port=5555):
        """Blocking serve (the CLI entry point)."""
        addr = self.start(host, port)
        print(f"rcvpose_tpu_torch serving on {addr[0]}:{addr[1]}",
              flush=True)
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.shutdown()

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class PoseClient:
    """Minimal blocking client for ``PoseServer`` (either package's)."""

    def __init__(self, host, port, timeout=600.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def ping(self):
        _send_json(self._sock, {"op": "ping"})
        return _recv_json(self._sock, limit=_MAX_PAYLOAD)

    def pose(self, image_u8, depth_mm, icp=False, icp_threshold_mm=None,
             icp_iters=None, class_name=None):
        image = np.ascontiguousarray(image_u8, np.uint8)
        depth = np.ascontiguousarray(depth_mm, "<f4")
        h, w = depth.shape
        header = {"op": "pose", "h": h, "w": w}
        if class_name is not None:
            header["class_name"] = class_name
        if icp:
            header["icp"] = True
            if icp_threshold_mm is not None:
                header["icp_threshold_mm"] = float(icp_threshold_mm)
            if icp_iters is not None:
                header["icp_iters"] = int(icp_iters)
        hdr = json.dumps(header).encode()
        self._sock.sendall(struct.pack(">I", len(hdr)) + hdr
                           + image.tobytes() + depth.tobytes())
        return _recv_json(self._sock, limit=_MAX_PAYLOAD)

    def raw(self, header_obj, payload=b""):
        """Send an arbitrary header (a hook for protocol-error tests)."""
        hdr = json.dumps(header_obj).encode()
        self._sock.sendall(struct.pack(">I", len(hdr)) + hdr + payload)
        return _recv_json(self._sock, limit=_MAX_PAYLOAD)

    def close(self):
        self._sock.close()


# ---------------------------------------------------------------------------
# CLI assembly: an estimator from the on-disk class assets
# ---------------------------------------------------------------------------

def build_lm_estimator(cfg, class_name, device=None):
    """``PoseEstimator`` from the LINEMOD eval-tree conventions: the
    class's networks as ``eval._load_models`` finds them (reference
    ``.pth.tar`` files, the port's ``Checkpointer`` directories or the JAX
    package's orbax ones), the
    meter-valued ``<class>.ply`` for the radius clips and the ICP CAD
    model, and ``Outside9.npy`` keypoints. ``device``: None is the card,
    ``"cpu"`` the CPU."""
    from rcvpose_tpu_torch import eval as eval_mod
    from rcvpose_tpu_torch import infer

    root_pv = os.path.join(cfg.root_dataset, "LINEMOD", class_name)
    cad_m = eval_mod._read_eval_cad_m(
        os.path.join(root_pv, f"{class_name}.ply"))
    keypoints = np.load(os.path.join(root_pv, "Outside9.npy"))
    max_radii = eval_mod._per_kpt_max_radii_dm(cad_m, keypoints)
    models = eval_mod._load_models(cfg, class_name, torch.device("cpu"))
    weights = [m.state_dict() for m in models]
    return infer.PoseEstimator(cfg, weights, keypoints, max_radii,
                               cad_mm=cad_m * 1000.0, device=device)


def run_serve(cfg, device=None):
    """``--mode serve``: load ``cfg.class_name``'s assets and serve on
    ``cfg.serve_host:serve_port`` until interrupted; returns the server.

    ``cfg.class_name`` is the warmed default; a request naming another
    class loads that class from the same tree on first use.
    ``--serve_classes a,b,c`` builds those before the socket opens, and
    ``--serve_devices N`` builds the default class's replicas on the
    first N device slots (0: replicas appear lazily under load).
    Deployments should also set ``--compile_cache_dir``: the first start
    builds the kernel libraries there with nvcc and every restart then
    loads them from disk (``utils.enable_compile_cache``; measured by
    ``python -m rcvpose_tpu_torch.scripts.bench_compile_cache``). A
    read-only install needs it, as the default directory lies inside the
    package."""
    est = build_lm_estimator(cfg, cfg.class_name, device)
    warm = (cfg.image_height, cfg.image_width)
    server = PoseServer(
        est, warmup_hw=warm, class_name=cfg.class_name,
        estimator_factory=lambda cname: build_lm_estimator(cfg, cname,
                                                           device))
    n_pre = int(cfg.serve_devices or 0)
    if n_pre > 1:
        n = server.expand_to(n_pre, class_name=cfg.class_name, hw=warm)
        print(f"serving {cfg.class_name} on {n} devices", flush=True)
    eager = [c.strip() for c in cfg.serve_classes.split(",")
             if c.strip() and c.strip() != cfg.class_name]
    if eager:
        print(f"warming {len(eager)} extra classes: {', '.join(eager)}",
              flush=True)
        server.warm_classes(eager, hw=warm)
    server.serve_forever(cfg.serve_host, cfg.serve_port)
    return server
