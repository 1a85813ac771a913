"""The port's measuring scripts (``rcvpose_tpu_torch.scripts.bench_*``)
against the JAX package's ``scripts/bench_*.py``, on the CPU.

Each record has the JAX script's keys (read from both sources with
``ast``), minus what came from the TPU or the CPU fallback and plus
``device`` (and, where named, the port's own additions); ``synth_frame``,
the open-loop arrival schedule, ``synchronous_chunks`` and
``interval_intersection`` equal the JAX scripts' (imported with
``importlib``; none imports JAX at the top); the port's
``eval._prefetched_chunks(stats=)`` records what the JAX function
records; one small step's FLOP count equals an analytic count of its
convolutions; each script runs on the CPU at a small size and prints one
parseable last line, and raises without a card unless the CPU is named.
"""

import ast
import dataclasses
import importlib.util
import json
import math
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch import serve
from rcvpose_tpu_torch import train as port_train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.scripts import (bench_eval_prefetch,
                                       bench_serving_latency, bench_train,
                                       bench_train_loop)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "rcvpose_tpu_torch" / "scripts"
# metric -> (keys the port drops, keys it adds)
CHANGES = {
    "train_step_ms": ({"recommended_recipe"},
                      {"device", "conv_route", "runs_ms"}),
    "train_loop_host_costs": (set(), {"device"}),
    "serving_latency_p99_ms": ({"note"}, {"device"}),
    "cold_class_warm_traffic_max_ms": (set(), {"device"}),
    "serving_throughput_scaling": ({"note"}, {"device"}),
    "eval_prefetch_ms_per_frame": (set(), {"device", "stock_ms_per_frame"}),
}
SCRIPTS = ("bench_train", "bench_train_loop", "bench_serving_latency",
           "bench_eval_prefetch")


@pytest.fixture
def one_thread():
    """One intra-op thread for a test held against the port alone (the
    suite's other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(node):
    """A dict key: its string, or an f-string's text with ``{}`` for each
    replacement field."""
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value if isinstance(v, ast.Constant) else "{}"
                       for v in node.values)
    return node.value


def records(path):
    """{metric: keys} of every record dict in ``path``: a dict literal
    with a ``"metric"`` key, plus the ``name["..."] = ...`` assignments of
    the name it was bound to in the same function."""
    out = {}
    tree = ast.parse(pathlib.Path(path).read_text())
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.Module)):
            continue
        bound = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                keys = [_key(k) for k in node.keys]
                if "metric" in keys:
                    metric = node.values[keys.index("metric")].value
                    out.setdefault(metric, set()).update(keys)
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and isinstance(node.value,
                                                              ast.Dict):
                        keys = [_key(k) for k in node.value.keys]
                        if "metric" in keys:
                            bound[t.id] = node.value.values[
                                keys.index("metric")].value
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in bound):
                        out[bound[t.value.id]].add(_key(t.slice))
    return out


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_record(record, metric):
    """The run's record: its keys are the port source's for ``metric``
    (f-string keys matched by their text), its times finite."""
    want = records(PORT / f"{SCRIPTS_BY_METRIC[metric]}.py")[metric]
    literal = {k for k in want if "{}" not in k}

    def matches(key, pattern):
        head, tail = pattern.split("{}")
        return key.startswith(head) and key.endswith(tail)

    assert literal <= set(record)
    for key in set(record) - literal:
        assert any(matches(key, p) for p in want - literal), key
    for pattern in want - literal:
        assert any(matches(key, pattern) for key in record), pattern
    assert record["metric"] == metric
    assert isinstance(record["value"], (int, float))
    assert math.isfinite(record["value"])


SCRIPTS_BY_METRIC = {
    "train_step_ms": "bench_train",
    "train_loop_host_costs": "bench_train_loop",
    "serving_latency_p99_ms": "bench_serving_latency",
    "cold_class_warm_traffic_max_ms": "bench_serving_latency",
    "serving_throughput_scaling": "bench_serving_latency",
    "eval_prefetch_ms_per_frame": "bench_eval_prefetch",
}


@pytest.mark.parametrize("name", SCRIPTS)
def test_record_keys_are_the_jax_scripts(name):
    jax_recs = records(REPO / "scripts" / f"{name}.py")
    port_recs = records(PORT / f"{name}.py")
    assert set(port_recs) == set(jax_recs)
    for metric, keys in jax_recs.items():
        dropped, added = CHANGES[metric]
        assert dropped <= keys
        assert port_recs[metric] == (keys - dropped) | added, metric


def test_synth_frame_and_arrivals_are_the_jax_scripts(monkeypatch):
    jax_mod = _jax_script("bench_serving_latency")
    for h, w, seed in ((96, 128, 0), (48, 64, 5)):
        for a, b in zip(bench_serving_latency.synth_frame(h, w, seed),
                        jax_mod.synth_frame(h, w, seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    class Clock:
        """A fake clock: ``sleep`` moves it; every request is instant."""

        def __init__(self):
            self.now = 100.0

        def perf_counter(self):
            return self.now

        def sleep(self, s):
            self.now += s

    schedules = []
    for mod in (jax_mod, bench_serving_latency):
        clock = Clock()
        monkeypatch.setattr(mod, "time", clock)
        calls = []
        lat, rate = mod.run_openloop(lambda: calls.append(clock.now), 7.5,
                                     20, 3)
        assert np.all(lat == 0.0)
        schedules.append((np.array(calls) - 100.0, rate))
    np.testing.assert_array_equal(schedules[0][0], schedules[1][0])
    assert schedules[0][1] == schedules[1][1]
    np.testing.assert_allclose(schedules[1][0],
                               bench_serving_latency.arrivals(7.5, 20, 3),
                               rtol=1e-12)


def _intervals(rng, n):
    t0 = np.cumsum(rng.uniform(0, 1, size=n))
    return [(float(a), float(a + d))
            for a, d in zip(t0, rng.uniform(0, 2, size=n))]


def test_prefetch_helpers_are_the_jax_scripts():
    jax_mod = _jax_script("bench_eval_prefetch")
    src = (REPO / "scripts" / "bench_eval_prefetch.py").read_text()
    node = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.FunctionDef)
                and n.name == "interval_intersection")
    scope = {}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "jax", "exec"),
         scope)
    rng = np.random.default_rng(0)
    for n in (1, 5, 12):
        a, b = _intervals(rng, n), _intervals(rng, n + 2)
        assert (bench_eval_prefetch.interval_intersection(a, b)
                == scope["interval_intersection"](a, b))
    items = [f"f{i}" for i in range(7)]
    for chunk in (1, 3, 4):
        got = list(bench_eval_prefetch.synchronous_chunks(items, chunk,
                                                          str.upper))
        want = list(jax_mod.synchronous_chunks(items, chunk, str.upper))
        assert got == want


def test_prefetched_chunks_stats_are_the_jax_functions():
    from rcvpose_tpu import eval as jax_eval

    items = list(range(5))
    recorded = []
    for fn in (jax_eval._prefetched_chunks, port_eval._prefetched_chunks):
        stats = {}
        out = [(n, p, ld) for n, p, ld in fn(items, 2, lambda i: i * 10,
                                             stats=stats)]
        recorded.append((out, {k: len(v) for k, v in stats.items()}))
        for t0, t1 in stats["decode"] + stats["consume"]:
            assert t1 >= t0
    assert recorded[0] == recorded[1]
    assert recorded[1][1] == {"decode": 3, "consume": 3}
    # no stats: nothing recorded, the same chunks
    assert list(port_eval._prefetched_chunks(items, 2, lambda i: i)) == \
        list(jax_eval._prefetched_chunks(items, 2, lambda i: i))


@pytest.mark.usefixtures("one_thread")
def test_step_flops_count_the_convolutions():
    cfg = Config(compute_dtype="float32", image_height=64, image_width=64,
                 batch_size=2, model_blocks="1,1,1,1", model_width=0.125)
    state = port_train.create_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    data = bench_train.seeded_batch(2, 64, 64, "cpu")
    shapes = []

    def hook(mod, inp, out):
        shapes.append((mod, out.shape))

    handles = [m.register_forward_hook(hook)
               for m in state.model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        state.model(data["image"])
    for h in handles:
        h.remove()
    total = 0
    for mod, (b, c, h, w) in shapes:
        kh, kw = mod.kernel_size
        fwd = 2 * b * c * h * w * mod.in_channels // mod.groups * kh * kw
        # forward, input gradient (not for the image) and weight gradient
        total += fwd * (2 if mod is state.model.conv1 else 3)
    assert len(shapes) > 20
    got = bench_train.step_flops(cfg, state, data, 1, conv_kernel=False)
    assert got == total
    assert bench_train.step_flops(cfg, state, data, 2, False) == total


def test_bf16_peak_table():
    assert bench_train.bf16_peak("NVIDIA H100 80GB HBM3, 700.00 W") == \
        989.4e12
    assert bench_train.bf16_peak("NVIDIA A100-SXM4-80GB, 400.00 W") is None


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.usefixtures("one_thread")
def test_bench_train_runs_on_the_cpu(capsys):
    out = bench_train.main(["2", "64", "64", "--small", "--device", "cpu",
                            "--steps", "1", "--accum", "2"])
    record = _last_json(capsys)
    assert record == json.loads(json.dumps(out))
    _check_record(record, "train_step_ms")
    assert (record["backend"], record["device"], record["conv_route"],
            record["accum_steps"], record["mfu_vs_bf16_peak"]) == (
                "cpu", "cpu", "cuDNN", 2, None)
    assert record["tflops_per_step"] > 0 and len(record["runs_ms"]) == 3
    assert all(math.isfinite(t) and t > 0 for t in record["runs_ms"])


@pytest.mark.usefixtures("one_thread")
def test_bench_train_loop_runs_on_the_cpu(capsys):
    bench_train_loop.main(["2", "2", "--small", "--device", "cpu"])
    record = _last_json(capsys)
    _check_record(record, "train_loop_host_costs")
    assert "ms_per_step_fetch_interval10" in record
    for key in ("ms_per_step_fetch_every", "ckpt_save_return_ms_async",
                "ckpt_save_return_ms_sync"):
        assert math.isfinite(record[key]) and record[key] > 0, key
    assert record["params"] == sum(
        p.numel() for p in port_train.build_model(Config(
            model_blocks="1,1,1,1", model_width=0.125)).parameters())


@pytest.fixture
def smaller_votes(monkeypatch):
    """The small runs at a fraction of their grid, points and refine
    windows: the plain vote on one thread dominates the CPU runs at their
    own."""
    serving = bench_serving_latency.serving_config

    def serving_config(small, fused=False):
        cfg, _ = serving(small, fused)
        # 64x64: the depth plateau (441 pixels) fits the points
        return dataclasses.replace(cfg, vote_grid_l=32, max_points=512,
                                   vote_topk=4), (64, 64)

    evaluation = bench_eval_prefetch.eval_config

    def eval_config(*args):
        return dataclasses.replace(evaluation(*args), vote_grid_l=48,
                                   max_points=512, vote_topk=8,
                                   icp_iters=2)

    monkeypatch.setattr(bench_serving_latency, "serving_config",
                        serving_config)
    monkeypatch.setattr(bench_eval_prefetch, "eval_config", eval_config)


@pytest.mark.usefixtures("one_thread", "smaller_votes")
def test_serving_latency_runs_on_the_cpu_and_as_a_client(capsys):
    bench_serving_latency.main(["--small", "--device", "cpu", "--n", "2",
                                "--fused"])
    record = _last_json(capsys)
    _check_record(record, "serving_latency_p99_ms")
    assert (record["mode"], record["path"], record["device"]) == (
        "fused", "in-process", "cpu")
    for key in ("p50_ms", "p99_ms", "capacity_rps", "dispatch_floor_ms"):
        assert math.isfinite(record[key]) and record[key] > 0, key

    cfg, (h, w) = bench_serving_latency.serving_config(True)
    est = bench_serving_latency.build_estimator(cfg, False, device="cpu")
    srv = serve.PoseServer(est, warmup_hw=(h, w))
    host, port = srv.start(port=0)
    try:
        bench_serving_latency.main(["--small", "--n", "2", "--daemon",
                                    f"{host}:{port}", "--image_hw",
                                    f"{h},{w}"])
    finally:
        srv.shutdown()
    record = _last_json(capsys)
    _check_record(record, "serving_latency_p99_ms")
    assert (record["mode"], record["path"], record["backend"]) == (
        "daemon", "tcp-daemon", "daemon")


@pytest.mark.usefixtures("one_thread", "smaller_votes")
def test_serving_scaling_on_the_cpu(capsys):
    bench_serving_latency.main(["--small", "--device", "cpu", "--scaling",
                                "--n", "4"])
    record = _last_json(capsys)
    _check_record(record, "serving_throughput_scaling")
    assert record["value"] == 1.0 and record["devices_used"] == [0]


@pytest.mark.usefixtures("one_thread", "smaller_votes")
def test_eval_prefetch_runs_on_the_cpu(capsys):
    bench_eval_prefetch.main(["--small", "--device", "cpu", "--frames", "1",
                              "--repeats", "1"])
    record = _last_json(capsys)
    _check_record(record, "eval_prefetch_ms_per_frame")
    assert record["frames"] == 1 and record["resolution"] == [128, 160]
    assert record["decode_ms_per_frame_total"] > 0


def test_lm_tree_is_the_fixtures(tmp_path):
    """The script's LINEMOD tree equals ``tests/test_eval_lm_format.py``'s
    from the same seed: files byte for byte, radial maps within f32."""
    from tests.test_eval_lm_format import make_lm_eval_tree

    a = pathlib.Path(bench_eval_prefetch.make_lm_eval_tree(
        str(tmp_path / "port"), np.random.default_rng(0), n_frames=2))
    b = pathlib.Path(make_lm_eval_tree(tmp_path / "jax",
                                       np.random.default_rng(0), n_frames=2))
    files = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(a) for p in a.rglob("*")
                           if p.is_file())
    for rel in files:
        if "estRadialMap" in str(rel):
            np.testing.assert_allclose(np.load(a / rel), np.load(b / rel),
                                       rtol=1e-6, atol=1e-6)
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_scripts_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((bench_train.main, ["2", "32", "32", "--small"]),
                       (bench_train_loop.main, ["2", "2", "--small"]),
                       (bench_serving_latency.main, ["--small"]),
                       (bench_serving_latency.main, ["--small",
                                                     "--cold_class"]),
                       (bench_serving_latency.main, ["--small",
                                                     "--scaling"]),
                       (bench_eval_prefetch.main, ["--small"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


def test_cold_class_measures_warm_traffic(capsys, monkeypatch):
    """``--cold_class`` on the CPU with the builds and requests stubbed to
    sleeps: the factory that holds the lock stalls warm traffic for the
    build, the one outside it does not."""
    class Est:
        device = torch.device("cpu")

        def estimate(self, image, depth):
            time.sleep(0.005)
            return {"rt": torch.eye(4), "centers": torch.zeros(3, 3),
                    "counts": torch.zeros(3), "overflow": torch.zeros(3)}

    monkeypatch.setattr(bench_serving_latency, "build_estimator",
                        lambda *a, **k: Est())
    monkeypatch.setattr(serve.PoseServer, "_warm_estimator",
                        staticmethod(lambda est, hw: None))
    bench_serving_latency.main(["--small", "--device", "cpu", "--cold_class",
                                "--cold_build_s", "0.4"])
    record = _last_json(capsys)
    _check_record(record, "cold_class_warm_traffic_max_ms")
    assert record["during_cold_max_ms_underlock_sim"] > 300
    assert record["during_cold_max_ms_offlock"] < 300
    assert threading.active_count() < 20
