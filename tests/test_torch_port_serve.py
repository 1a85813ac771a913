"""The port's pose server (``rcvpose_tpu_torch.serve``) against the JAX
package's, on the CPU.

Both packages speak one wire protocol: the JAX ``PoseClient`` against the
port's server and the port's client against the JAX server give the reply
fields of the JAX client on the JAX server, on the same conditioned fused
net (``test_torch_port_infer.py``'s weights and frame), centers within
1e-2 mm as that file holds them. The rest follows ``tests/test_serve.py``
on tiny seeded port nets: replies equal a direct ``estimate``/``refine``,
protocol and framing errors, payload validation, interleaved clients,
multi-class serving and refusal, cold-class builds off the critical path,
``warm_classes``, round-robin over two CPU slots, ``build_lm_estimator``
and ``cli --mode serve`` on a fixture tree, and the kernels' launch
counters under concurrent threads.
"""

import functools
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import infer, serve, train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models.fcnresnet import init_params
from tests.torch_port_threads import port_threads  # noqa: F401

H = W = 64
CPU2 = [torch.device("cpu")] * 2
# centers as test_torch_port_infer.py holds them (mm), rotations within
# what 1e-2 mm moves a Horn fit over ~0.1 m keypoint lever arms
CENTER_ATOL_MM = 1e-2
ROT_ATOL = 1e-3
TINY = dict(compute_dtype="float32", vote_grid_l=32, max_points=512,
            vote_mode="hier", model_width=0.125, model_blocks="1,1,1,1",
            icp_iters=4)


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, size=(H, W, 3)).astype(np.uint8)
    depth = np.zeros((H, W), np.float32)
    win = depth[H // 3:2 * H // 3, W // 3:2 * W // 3]
    win[...] = rng.uniform(600, 900, size=win.shape).astype(np.float32)
    return image, depth


@functools.lru_cache(maxsize=None)
def _weights(seed):
    m = init_params(train.build_model(Config(**TINY)),
                    torch.Generator().manual_seed(seed))
    return m.state_dict()


def _tiny_estimator(seed=0, cad=True):
    """Three seeded tiny nets on the CPU."""
    cfg = Config(**TINY)
    weights = [_weights(seed * 3 + i) for i in range(3)]
    rng = np.random.default_rng(seed)
    keypoints = np.zeros((9, 3))
    keypoints[1:4] = rng.normal(size=(3, 3)) * 0.05
    return infer.PoseEstimator(
        cfg, weights, keypoints, max_radii_dm=np.array([2.0, 2.2, 2.4]),
        cad_mm=rng.normal(size=(64, 3)) * 40.0 if cad else None,
        device="cpu")


def _client(srv_addr):
    return serve.PoseClient(*srv_addr)


@pytest.fixture(scope="module")
def server():
    est = _tiny_estimator(0)
    srv = serve.PoseServer(est, warmup_hw=(H, W))
    addr = srv.start(port=0)
    yield srv, est, addr
    srv.shutdown()


# ---------------------------------------------------------------------------
# Either package's client against either package's server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_servers():
    """The JAX and the port server on one conditioned fused net, the
    frame, and the JAX client's reply from the JAX server."""
    import jax
    import jax.numpy as jnp

    from rcvpose_tpu import infer as jax_infer
    from rcvpose_tpu import serve as jax_serve
    from rcvpose_tpu import train as jax_train
    from rcvpose_tpu.config import Config as JaxConfig
    from tests import test_torch_port_infer as ti

    jcfg = JaxConfig(**ti._cfg(3), icp_iters=3)
    model = jax_train.build_model(jcfg)
    img, depth, keypoints = ti._frame(3)
    variables = ti._condition(model, jax.jit(model.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((1, ti.HW, ti.HW, 3)), False),
        img, depth)
    cad = np.random.default_rng(3).normal(size=(64, 3)) * 40.0
    jax_est = jax_infer.PoseEstimator(jcfg, [variables], keypoints,
                                      ti.MAX_RADII, cad_mm=cad)
    port_est = infer.PoseEstimator(
        Config(**ti._cfg(3), icp_iters=3),
        [jax.tree.map(np.asarray, variables)], keypoints, ti.MAX_RADII,
        cad_mm=cad, device="cpu")
    jsrv = jax_serve.PoseServer(jax_est, devices=jax.local_devices()[:1])
    psrv = serve.PoseServer(port_est)
    addrs = {"jax": jsrv.start(port=0), "port": psrv.start(port=0)}
    clients = {"jax": jax_serve.PoseClient, "port": serve.PoseClient}
    ref = {}
    c = jax_serve.PoseClient(*addrs["jax"])
    try:
        for icp in (False, True):
            ref[icp] = c.pose(img, depth, icp=icp, icp_threshold_mm=50.0)
    finally:
        c.close()
    yield addrs, clients, ref, (img, depth), port_est
    jsrv.shutdown()
    psrv.shutdown()


def _assert_reply(got, want):
    assert got["ok"] and want["ok"], (got, want)
    assert sorted(got) == sorted(want)
    for key in ("counts", "overflow", "icp_applied", "device"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=0,
                               atol=CENTER_ATOL_MM)
    rt, wrt = np.asarray(got["rt"]), np.asarray(want["rt"])
    np.testing.assert_allclose(rt[:3, :3], wrt[:3, :3], atol=ROT_ATOL)
    np.testing.assert_allclose(rt[:3, 3], wrt[:3, 3], atol=CENTER_ATOL_MM)


@pytest.mark.parametrize("client,server_pkg", [("jax", "port"),
                                               ("port", "jax"),
                                               ("port", "port")])
@pytest.mark.parametrize("icp", [False, True], ids=["pose", "icp"])
def test_clients_and_servers_interoperate(two_servers, client, server_pkg,
                                          icp):
    addrs, clients, ref, (img, depth), _ = two_servers
    c = clients[client](*addrs[server_pkg])
    try:
        assert c.ping() == {"ok": True, "pong": True}
        got = c.pose(img, depth, icp=icp, icp_threshold_mm=50.0)
    finally:
        c.close()
    _assert_reply(got, ref[icp])
    assert min(got["counts"]) > 0


def test_reply_equals_direct_estimate_and_refine(two_servers):
    """The port server's reply is the estimator's own result: the same
    numbers as a direct ``estimate`` and ``refine`` on the frame."""
    addrs, _, _, (img, depth), est = two_servers
    c = serve.PoseClient(*addrs["port"])
    try:
        plain = c.pose(img, depth)
        refined = c.pose(img, depth, icp=True, icp_threshold_mm=50.0,
                         icp_iters=2)
    finally:
        c.close()
    res = est.estimate(img, depth)
    np.testing.assert_array_equal(plain["rt"], res["rt"].double().numpy())
    np.testing.assert_array_equal(plain["centers"],
                                  res["centers"].double().numpy())
    assert plain["counts"] == res["counts"].double().tolist()
    assert plain["overflow"] == res["overflow"].tolist()
    rt2 = est.refine(res, threshold_mm=50.0, icp_iters=2)
    np.testing.assert_array_equal(refined["rt"], rt2.double().numpy())
    assert refined["icp_applied"] and not plain["icp_applied"]


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------

def test_protocol_errors_keep_connection(server):
    _, _, addr = server
    c = _client(addr)
    try:
        res = c.raw({"op": "warp"})
        assert res["ok"] is False and "unknown op" in res["error"]
        res = c.raw({"op": "pose", "h": 1 << 14, "w": 1 << 14})
        assert res["ok"] is False
        assert c.ping()["ok"]
    finally:
        c.close()


def test_framing_error_closes_connection(server):
    """A non-JSON header puts the stream out of step: the server reports
    the framing error and closes; a new connection still works."""
    _, _, addr = server
    sock = socket.create_connection(addr, timeout=30)
    try:
        junk = b"\xde\xad\xbe\xef not json"
        sock.sendall(struct.pack(">I", len(junk)) + junk)
        (n,) = struct.unpack(">I", sock.recv(4))
        reply = json.loads(sock.recv(n))
        assert reply["ok"] is False and "framing" in reply["error"]
        sock.settimeout(10)
        assert sock.recv(4) == b""
    finally:
        sock.close()
    c = _client(addr)
    try:
        assert c.ping()["ok"]
    finally:
        c.close()


def test_payload_length_validation():
    srv = serve.PoseServer.__new__(serve.PoseServer)  # no estimator needed
    with pytest.raises(ValueError, match="expected"):
        srv._handle_pose({"h": 4, "w": 4}, b"\x00" * 7)
    with pytest.raises(ValueError, match="bad frame shape"):
        srv._handle_pose({"h": 0, "w": 4}, b"")


def test_two_clients_interleave_and_icp_without_cad(server):
    _, _, addr = server
    a, b = _client(addr), _client(addr)
    try:
        image, depth = _frame(2)
        assert a.ping()["ok"]
        res_b = b.pose(image, depth)
        res_a = a.pose(image, depth)
        assert res_a["ok"] and res_b["ok"]
        assert res_a["rt"] == res_b["rt"]
    finally:
        a.close()
        b.close()
    srv = serve.PoseServer(_tiny_estimator(1, cad=False))
    c = _client(srv.start(port=0))
    try:
        res = c.pose(*_frame(2), icp=True)
        assert res["ok"] is False and "CAD" in res["error"]
        assert c.ping()["ok"]
    finally:
        c.close()
        srv.shutdown()


# ---------------------------------------------------------------------------
# Classes
# ---------------------------------------------------------------------------

def test_multi_class_serving_and_refusal(server):
    """Requests naming a class build it through the factory once, over
    one connection; a classless request to a server without a default
    errors and the connection lives; a single-class server refuses
    foreign classes."""
    built = []

    def factory(cname):
        built.append(cname)
        return _tiny_estimator({"ape": 10, "cat": 20}[cname])

    srv = serve.PoseServer(estimator_factory=factory, devices=CPU2[:1])
    c = _client(srv.start(port=0))
    try:
        image, depth = _frame(4)
        ape = c.pose(image, depth, class_name="ape")
        cat = c.pose(image, depth, class_name="cat")
        assert ape["ok"] and ape["class_name"] == "ape"
        assert cat["ok"] and cat["class_name"] == "cat"
        assert c.pose(image, depth, class_name="ape")["rt"] == ape["rt"]
        assert built == ["ape", "cat"]
        assert srv._pools["ape"].replicas[0] is not \
            srv._pools["cat"].replicas[0]
        res = c.pose(image, depth)
        assert res["ok"] is False and "class_name" in res["error"]
        assert c.ping()["ok"]
    finally:
        c.close()
        srv.shutdown()
    _, _, addr = server
    c = _client(addr)
    try:
        res = c.pose(*_frame(5), class_name="driller")
        assert res["ok"] is False and "single class" in res["error"]
    finally:
        c.close()


def test_cold_class_build_off_critical_path():
    """A cold class's build (the factory sleeps 2 s) runs outside the
    execution locks: a concurrent request to the warm default class does
    not wait for it."""
    sleep_s = 2.0

    def slow_factory(cname):
        time.sleep(sleep_s)
        return _tiny_estimator(99)

    srv = serve.PoseServer(_tiny_estimator(0), warmup_hw=(H, W),
                           class_name="default",
                           estimator_factory=slow_factory)
    addr = srv.start(port=0)
    image, depth = _frame(6)
    warm = _client(addr)
    results = {}

    def cold_request():
        c = _client(addr)
        try:
            t0 = time.perf_counter()
            results["cold"] = c.pose(image, depth, class_name="slow")
            results["cold_s"] = time.perf_counter() - t0
        finally:
            c.close()

    try:
        assert warm.pose(image, depth)["ok"]
        th = threading.Thread(target=cold_request)
        th.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        assert warm.pose(image, depth)["ok"]
        during = time.perf_counter() - t0
        th.join(timeout=60)
        assert results["cold"]["ok"] and results["cold_s"] >= sleep_s
        assert during < sleep_s * 0.75, during
    finally:
        warm.close()
        srv.shutdown()


def test_warm_classes_and_default_class_name():
    """``warm_classes`` builds each class once before the socket opens;
    a request naming the default estimator's own class reuses it."""
    built = []

    def factory(cname):
        built.append(cname)
        return _tiny_estimator(len(built))

    srv = serve.PoseServer(_tiny_estimator(3), warmup_hw=(H, W),
                           class_name="ape", estimator_factory=factory)
    srv.warm_classes(["a", "b"], hw=(H, W))
    srv.warm_classes(["a", "b", "ape"], hw=(H, W))
    assert built == ["a", "b"]
    c = _client(srv.start(port=0))
    try:
        image, depth = _frame(8)
        assert c.pose(image, depth, class_name="a")["ok"]
        named = c.pose(image, depth, class_name="ape")
        default = c.pose(image, depth)
        assert named["rt"] == default["rt"]
        assert built == ["a", "b"]
    finally:
        c.close()
        srv.shutdown()


# ---------------------------------------------------------------------------
# Device slots
# ---------------------------------------------------------------------------

def test_round_robin_over_two_cpu_slots():
    """``expand_to`` builds a replica on each slot; serial requests cycle
    over them and both give the same pose; a one-replica server grows
    its second replica in the background under concurrent load."""
    srv = serve.PoseServer(_tiny_estimator(4), warmup_hw=(H, W),
                           devices=CPU2)
    addr = srv.start(port=0)
    try:
        assert srv.n_replicas() == 1
        image, depth = _frame(3)
        deadline = time.monotonic() + 60
        while srv.n_replicas() < 2 and time.monotonic() < deadline:
            replies = [None] * 3

            def one(i):
                c = _client(addr)
                try:
                    replies[i] = c.pose(image, depth)
                finally:
                    c.close()

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert all(r["ok"] for r in replies), replies
        assert srv.n_replicas() == 2
        assert srv.expand_to() == 2
        c = _client(addr)
        try:
            replies = [c.pose(image, depth) for _ in range(4)]
        finally:
            c.close()
        assert {r["device"] for r in replies} == {0, 1}
        assert len({json.dumps(r["rt"]) for r in replies}) == 1
    finally:
        srv.shutdown()


def test_launch_counters_under_threads():
    """The kernels' launch counters (``ops._build.count``) stay exact when
    more threads than cores launch at once, switching as often as the
    interpreter allows."""
    import sys

    from rcvpose_tpu_torch.ops import _build, heads, vote_cuda

    before = (vote_cuda.vote_counts_cuda.launches,
              heads.heads_channel_major_cuda.launches)

    def launch():
        for _ in range(2000):
            _build.count(vote_cuda.vote_counts_cuda)
            _build.count(heads.heads_channel_major_cuda, n=2)

    n = 2 * (os.cpu_count() or 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert vote_cuda.vote_counts_cuda.launches == before[0] + 2000 * n
    assert heads.heads_channel_major_cuda.launches == before[1] + 4000 * n
    vote_cuda.vote_counts_cuda.launches = before[0]
    heads.heads_channel_major_cuda.launches = before[1]


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_build_lm_estimator_and_cli_serve(tmp_path, monkeypatch):
    """``--mode serve`` on a LINEMOD eval tree: three ``.pth.tar`` nets,
    the meter ``.ply`` (radius clips and the ICP CAD model) and
    ``Outside9.npy``; then a TCP round trip with ICP, and the extra
    ``--serve_classes``/``--serve_devices`` of ``run_serve``."""
    from rcvpose_tpu_torch import cli
    from tests.test_eval_lm_format import make_lm_eval_tree

    tree = make_lm_eval_tree(tmp_path, np.random.default_rng(0))
    model_dir = tmp_path / "ckpts"
    model_dir.mkdir()
    for i in range(1, 4):
        torch.save({"model_state_dict": _weights(i)},
                   model_dir / f"ape_pt{i}.pth.tar")
    est = serve.build_lm_estimator(
        Config(**TINY, root_dataset=str(tree), model_dir=str(model_dir)),
        "ape", device="cpu")
    assert est.cad_mm is not None and est.device.type == "cpu"

    started = []

    def start_only(self, host, port):
        started.append((self, self.start(host, 0)))

    monkeypatch.setattr(serve.PoseServer, "serve_forever", start_only)
    argv = ["--mode", "serve", "--root_dataset", str(tree), "--model_dir",
            str(model_dir), "--compute_dtype", "float32", "--model_blocks",
            "1,1,1,1", "--model_width", "0.125", "--vote_grid_l", "32",
            "--max_points", "512", "--icp_iters", "4", "--serve_devices",
            "1", "--serve_classes", "ape"]
    srv = cli.main(argv, device="cpu")
    assert [s for s, _ in started] == [srv]
    c = _client(started[0][1])
    try:
        res = c.pose(*_frame(3), icp=True, icp_threshold_mm=50.0,
                     icp_iters=2)
        assert res["ok"] and res["icp_applied"], res
        assert np.isfinite(res["rt"]).all()
    finally:
        c.close()
        srv.shutdown()
    assert os.path.isdir(tree)
