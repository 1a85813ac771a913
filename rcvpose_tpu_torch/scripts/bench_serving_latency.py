"""Open-loop serving latency on the card; prints ONE JSON line last.

    python -m rcvpose_tpu_torch.scripts.bench_serving_latency [--fused]
        [--n N] [--rate R | --utilization U] [--small] [--device cpu]
    ... --daemon HOST:PORT [--image_hw H,W]     (a pure client)
    ... --cold_class [--cold_build_s S]
    ... --scaling

The counterpart of the JAX package's ``scripts/bench_serving_latency.py``.
``bench`` reports throughput (frames back to back); serving also cares
about the latency a client sees when requests arrive at a given rate, each
crossing the host boundary: the image's normalization and copy to the
card, one ``PoseEstimator.estimate`` (escalation-checked) and the
synchronize that ends it, plus the queueing when a request lands while the
previous one runs.

Method: seeded Poisson arrivals at ``--rate`` requests/s (default
``--utilization`` x the back-to-back capacity measured first) against the
in-process ``PoseEstimator.estimate``; the latency of request i is its
completion minus its *scheduled* arrival, so queueing is charged to the
server. Reports p50/p90/p95/p99/max, the achieved rate, the capacity, and
``dispatch_floor_ms``: the best round trip of a one-element add on the card
followed by ``.item()``.

``--daemon HOST:PORT`` measures through a running ``--mode serve`` daemon
with ``serve.PoseClient`` (the network path included; the floor is a
``ping``). ``--cold_class`` measures how a cold class's build (a sleep of
``--cold_build_s`` in the estimator factory) affects warm traffic, with
the build outside the execution lock (``serve.PoseServer``'s behaviour)
and with a factory that holds the card's lock for the whole build.
``--scaling`` measures requests/s against a ``PoseServer`` on 1 card and
on every local card (1-vs-1 on a one-card machine, reported as such).

Full width on the card (bf16, grid 128, 8192 points, hier, 480x640);
``--small`` takes the small net (width 0.125, blocks 1,1,1,1) at f32, grid
64, 1024 points, 96x128. The CPU runs only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np


def build_estimator(cfg, fused, seed=0, device=None):
    """``PoseEstimator`` with seeded random weights: serving latency does
    not depend on the weights (same program, same shapes)."""
    import torch

    from rcvpose_tpu_torch import infer
    from rcvpose_tpu_torch import train as train_mod
    from rcvpose_tpu_torch.models.fcnresnet import init_params

    def weights(i):
        return init_params(train_mod.build_model(cfg),
                           torch.Generator().manual_seed(seed + i)
                           ).state_dict()

    variables = weights(0) if fused else [weights(i) for i in range(3)]
    rng = np.random.default_rng(seed)
    keypoints = np.zeros((9, 3))
    keypoints[1:4] = rng.normal(size=(3, 3)) * 0.05
    return infer.PoseEstimator(cfg, variables, keypoints,
                               max_radii_dm=np.array([2.0, 2.2, 2.4]),
                               device=device)


def synth_frame(h, w, seed=0):
    """A seeded uint8 noise image and a depth plateau (600-900 mm) in the
    middle third, as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    image = (rng.uniform(0, 255, size=(h, w, 3))).astype(np.uint8)
    depth = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[h // 3:2 * h // 3, w // 3:2 * w // 3]
    depth[ys, xs] = rng.uniform(600, 900, size=ys.shape).astype(np.float32)
    return image, depth


def arrivals(rate_fps, n, seed):
    """Seeded Poisson arrival times (s from the start) of ``n`` requests."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_fps, size=n))


def one_request(est, image, depth):
    from rcvpose_tpu_torch.utils import synchronize

    res = est.estimate(image, depth)
    synchronize(est.device)
    return res


def measure_dispatch_floor(device, runs=20):
    """Best round trip of a one-element add on ``device`` read back with
    ``.item()``: the floor of any request, independent of the model."""
    import torch

    x = torch.zeros((), device=device)
    (x + 1.0).item()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        (x + 1.0).item()
        best = min(best, time.perf_counter() - t0)
    return best


def run_openloop(request, rate_fps, n, seed):
    """Poisson arrivals at ``rate_fps``; FIFO service; latency against the
    scheduled arrival (queueing charged to the server). ``request()``
    performs one complete round trip. Returns (latencies s, achieved
    requests/s)."""
    times = arrivals(rate_fps, n, seed)
    lat = np.empty(n)
    t0 = time.perf_counter()
    for i in range(n):
        target = t0 + times[i]
        now = time.perf_counter()
        if now < target:
            time.sleep(target - now)
        request()
        lat[i] = time.perf_counter() - target
    wall = time.perf_counter() - t0
    return lat, n / wall


def serving_config(small, fused=False):
    """(``Config``, (H, W)) of the full-width or the small run."""
    from rcvpose_tpu_torch.config import Config
    from rcvpose_tpu_torch.ops.voting import suggest_grid_l

    heads = 3 if fused else 1
    if small:
        return Config(compute_dtype="float32", vote_grid_l=64,
                      max_points=1024, vote_mode="hier", model_width=0.125,
                      model_blocks="1,1,1,1", kpt_heads=heads), (96, 128)
    return Config(compute_dtype="bfloat16",
                  vote_grid_l=suggest_grid_l(0.102, 2.0), max_points=8192,
                  vote_mode="hier", kpt_heads=heads), (480, 640)


def device_line(device):
    from rcvpose_tpu_torch.scripts import card_line

    return card_line() if device.type == "cuda" else "cpu"


def run_cold_class(args, device):
    """Warm traffic's worst request while a cold class builds, with the
    build outside the execution lock and under it (simulated)."""
    from rcvpose_tpu_torch import parallel
    from rcvpose_tpu_torch import serve as serve_mod

    cfg, (h, w) = serving_config(args.small)
    image, depth = synth_frame(h, w, seed=args.seed)
    build_s = args.cold_build_s
    one_dev = parallel.local_devices(device)[:1]
    # warm every one-time cost of the factory's path (kernel builds, the
    # allocator, cuDNN's plans) so that both arms measure lock contention
    pre = build_estimator(cfg, fused=False, seed=99, device=device)
    one_request(pre, *synth_frame(h, w, seed=1))
    del pre

    def measure(under_lock):
        est = build_estimator(cfg, fused=False, seed=args.seed,
                              device=device)
        building = threading.Event()

        def factory(cname):
            if under_lock:  # the card's execution lock held for the build
                with srv._dev_locks[0]:
                    building.set()
                    time.sleep(build_s)
                    return build_estimator(cfg, False, 99, device)
            building.set()
            time.sleep(build_s)
            return build_estimator(cfg, False, 99, device)

        srv = serve_mod.PoseServer(est, warmup_hw=(h, w),
                                   class_name="default",
                                   estimator_factory=factory,
                                   devices=one_dev)
        host, port = srv.start(port=0)
        warm = serve_mod.PoseClient(host, port)
        try:
            lats = []
            for _ in range(5):
                t0 = time.perf_counter()
                if not warm.pose(image, depth)["ok"]:
                    raise RuntimeError("warm request failed")
                lats.append(time.perf_counter() - t0)
            steady_ms = float(np.median(lats) * 1e3)
            done = threading.Event()

            def cold():
                c = serve_mod.PoseClient(host, port)
                try:
                    c.pose(image, depth, class_name="coldclass")
                finally:
                    c.close()
                    done.set()

            thread = threading.Thread(target=cold, daemon=True)
            thread.start()
            building.wait(timeout=600)   # the build is in flight
            during = []
            while not done.is_set() or not during:
                t0 = time.perf_counter()
                if not warm.pose(image, depth)["ok"]:
                    raise RuntimeError("warm request failed")
                during.append(time.perf_counter() - t0)
            thread.join(timeout=600)
            return steady_ms, float(np.max(during) * 1e3), len(during)
        finally:
            warm.close()
            srv.shutdown()

    steady_off, max_off, n_off = measure(under_lock=False)
    steady_on, max_on, n_on = measure(under_lock=True)
    return {
        "metric": "cold_class_warm_traffic_max_ms",
        "value": max_off,
        "unit": "ms",
        "cold_build_s": build_s,
        "steady_median_ms": round(steady_off, 2),
        "during_cold_max_ms_offlock": round(max_off, 2),
        "warm_requests_served_during_cold_offlock": n_off,
        "during_cold_max_ms_underlock_sim": round(max_on, 2),
        "warm_requests_served_during_cold_underlock_sim": n_on,
        "backend": device.type,
        "image_hw": [h, w],
        "note": ("offlock = serve.PoseServer's behaviour (cold build "
                 "outside the execution lock); underlock_sim = a factory "
                 "that holds the card's lock for the whole build"),
        "device": device_line(device),
    }


def run_scaling(args, device):
    """Closed-loop concurrent requests/s against a ``PoseServer`` with
    replicas on 1 card and on every local card."""
    from rcvpose_tpu_torch import parallel
    from rcvpose_tpu_torch import serve as serve_mod

    cfg, (h, w) = serving_config(args.small, args.fused)
    image, depth = synth_frame(h, w, seed=args.seed)
    devices = parallel.local_devices(device)
    n_all = len(devices)
    n_req = args.n or (48 if args.small else 120)

    def throughput(n_dev):
        est = build_estimator(cfg, args.fused, seed=args.seed, device=device)
        srv = serve_mod.PoseServer(est, warmup_hw=(h, w),
                                   devices=devices[:n_dev])
        srv.expand_to()   # build and warm every replica up front
        host, port = srv.start(port=0)
        try:
            workers = max(2 * n_dev, 2)
            per = max(n_req // workers, 2)
            counts, used = [], set()

            def worker():
                cli = serve_mod.PoseClient(host, port)
                c = 0
                try:
                    for _ in range(per):
                        res = cli.pose(image, depth)
                        if not res["ok"]:
                            raise RuntimeError(res)
                        used.add(res["device"])
                        c += 1
                finally:
                    cli.close()
                    counts.append(c)

            wcli = serve_mod.PoseClient(host, port)
            wcli.pose(image, depth)    # untimed: connection, cold paths
            wcli.close()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=worker)
                       for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            if sum(counts) != workers * per:
                raise RuntimeError(f"{sum(counts)} of {workers * per} "
                                   "requests answered")
            return sum(counts) / wall, sorted(used)
        finally:
            srv.shutdown()

    one, used1 = throughput(1)
    alln, usedn = throughput(n_all) if n_all > 1 else (one, used1)
    return {
        "metric": "serving_throughput_scaling",
        "value": round(alln / one, 2),
        "unit": f"x over {n_all} devices",
        "rps_1dev": round(one, 2),
        f"rps_{n_all}dev": round(alln, 2),
        "devices_used": usedn,
        "host_cores": os.cpu_count() or 1,
        "backend": device.type,
        "fused": bool(args.fused),
        "image_hw": [h, w],
        "device": device_line(device),
    }


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m rcvpose_tpu_torch.scripts.bench_serving_latency")
    ap.add_argument("--small", action="store_true",
                    help="the small net at 96x128, f32, grid 64")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    ap.add_argument("--fused", action="store_true",
                    help="kpt_heads=3 multi-head serving")
    ap.add_argument("--cold_class", action="store_true",
                    help="measure a cold class's build against warm "
                         "traffic instead of the open-loop run")
    ap.add_argument("--scaling", action="store_true",
                    help="requests/s on 1 card against every local card")
    ap.add_argument("--cold_build_s", type=float, default=3.0,
                    help="injected cold-class build time (s)")
    ap.add_argument("--n", type=int, default=None,
                    help="requests in the open-loop run")
    ap.add_argument("--rate", type=float, default=None,
                    help="offered load, req/s (default: utilization x "
                         "measured capacity)")
    ap.add_argument("--utilization", type=float, default=0.6,
                    help="offered load as a fraction of capacity when "
                         "--rate is not given")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--daemon", default=None, metavar="HOST:PORT",
                    help="measure through a running `--mode serve` daemon "
                         "(network path included) instead of in-process")
    ap.add_argument("--image_hw", default=None,
                    help="frame size H,W for --daemon (the daemon's "
                         "warmup; default 480,640, or 96,128 with --small)")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Measure and print the record; returns it."""
    args = parse_args(argv)
    if args.daemon:
        # a pure client: the daemon owns the model and the card
        from rcvpose_tpu_torch import serve as serve_mod

        host, port = args.daemon.rsplit(":", 1)
        client = serve_mod.PoseClient(host, int(port))
        h, w = (96, 128) if args.small else (480, 640)
        if args.image_hw:
            h, w = (int(x) for x in args.image_hw.split(","))
        image, depth = synth_frame(h, w, seed=args.seed)
        backend, line = "daemon", f"daemon at {args.daemon}"

        def request():
            res = client.pose(image, depth)
            if not res.get("ok"):
                raise RuntimeError(res.get("error"))

        def floor_fn():
            best = float("inf")
            for _ in range(20):
                t0 = time.perf_counter()
                client.ping()
                best = min(best, time.perf_counter() - t0)
            return best
    else:
        from rcvpose_tpu_torch.utils import resolve_device

        dev = resolve_device(args.device or device)
        if args.cold_class or args.scaling:
            record = (run_cold_class if args.cold_class
                      else run_scaling)(args, dev)
            print(json.dumps(record), flush=True)
            return record
        cfg, (h, w) = serving_config(args.small, args.fused)
        est = build_estimator(cfg, args.fused, seed=args.seed, device=dev)
        image, depth = synth_frame(h, w, seed=args.seed)
        backend, line = dev.type, device_line(dev)

        def request():
            one_request(est, image, depth)

        def floor_fn():
            return measure_dispatch_floor(dev)

    n = args.n or (8 if args.small else 200)
    try:
        for _ in range(2):     # kernels built, every escalation path warm
            request()
        t0 = time.perf_counter()
        n_cap = max(4, n // 4)
        for _ in range(n_cap):
            request()
        capacity = n_cap / (time.perf_counter() - t0)
        rate = args.rate or args.utilization * capacity
        lat, achieved = run_openloop(request, rate, n, args.seed)
        floor = floor_fn()
    finally:
        if args.daemon:
            client.close()

    def q(p):
        return float(np.percentile(lat, p) * 1e3)

    record = {
        "metric": "serving_latency_p99_ms",
        "value": round(q(99), 2),
        "unit": "ms",
        "mode": ("daemon" if args.daemon
                 else ("fused" if args.fused else "3-net")),
        "path": "tcp-daemon" if args.daemon else "in-process",
        "offered_rate_rps": round(rate, 2),
        "achieved_rps": round(achieved, 2),
        "capacity_rps": round(capacity, 2),
        "p50_ms": round(q(50), 2),
        "p90_ms": round(q(90), 2),
        "p95_ms": round(q(95), 2),
        "p99_ms": round(q(99), 2),
        "max_ms": round(float(lat.max() * 1e3), 2),
        "n_requests": n,
        "dispatch_floor_ms": round(floor * 1e3, 3),
        "backend": backend,
        "image_hw": [h, w],
        "device": line,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
