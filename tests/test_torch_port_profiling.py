"""The port's spans, start-up record and counters (``profiling``) on the
CPU: off they record nothing; under a CPU ``torch.profiler`` a
``PoseEstimator.estimate`` emits the serving frame's spans, nested and
carrying one frame id; the start-up record holds set-up and the first
frame on the profiler's clock; a cropped frame counts one escalation.

The estimators take ``tests/test_torch_port_infer.py``'s configuration
and frame with the port's own seeded weights.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rcvpose_tpu_torch import infer, profiling, train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.ops import _build
from tests.test_torch_port_infer import HW, MAX_RADII, _cfg, _frame
from tests.torch_port_threads import port_threads  # noqa: F401

FRAME_SPANS = {"rcvpose.estimate", "rcvpose.inputs", "rcvpose.net",
               "rcvpose.pose", "rcvpose.pack", "rcvpose.vote",
               "rcvpose.vote.prepare", "rcvpose.vote.coarse",
               "rcvpose.vote.fine", "rcvpose.fit", "rcvpose.escalate.read"}


def _estimator(kpt_heads, radii=MAX_RADII, **cfg):
    conf = Config(**{**_cfg(kpt_heads), **cfg})
    torch.manual_seed(kpt_heads)
    weights = [train.build_model(conf).state_dict()
               for _ in range(1 if kpt_heads > 1 else 3)]
    _, _, keypoints = _frame(kpt_heads)
    return infer.PoseEstimator(conf, weights, keypoints,
                               radii, device="cpu")


@pytest.fixture
def fresh_startup(monkeypatch):
    """An open start-up record, as at process start."""
    record = profiling.Startup()
    monkeypatch.setattr(profiling, "_startup", record)
    return record


@pytest.fixture
def closed_startup(monkeypatch):
    record = profiling.Startup()
    record.open = False
    monkeypatch.setattr(profiling, "_startup", record)
    return record


def _spans(prof):
    """The profiler's ``rcvpose.*`` ranges as (name, start, end, inputs),
    in start order."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.concrete_inputs())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("rcvpose.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_records_nothing(closed_startup, monkeypatch):
    def refuse(*args):
        raise AssertionError("a range opened with tracing off")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    assert not torch.autograd._profiler_enabled()
    for name, attrs in (("rcvpose.net", {"net": 1}), ("rcvpose.pose", {})):
        ctx = profiling.span(name, **attrs)
        assert ctx is profiling._OFF
        with ctx:
            pass
    assert profiling.startup() == []


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_estimate_spans_nest_and_share_a_frame_id(kpt_heads,
                                                  closed_startup):
    est = _estimator(kpt_heads)
    img, depth, _ = _frame(kpt_heads)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        est.estimate(img, depth)
        est.estimate(img, depth)
    spans = _spans(prof)
    assert FRAME_SPANS <= {s[0] for s in spans}
    frames = [s for s in spans if s[0] == "rcvpose.estimate"]
    assert len(frames) == 2
    for frame in frames:
        own = [s for s in spans if _inside(s, frame)]
        names = [s[0] for s in own]
        per_run = 1 if kpt_heads > 1 else 3
        assert names.count("rcvpose.net") == per_run * names.count(
            "rcvpose.pose")
        vote = next(s for s in own if s[0] == "rcvpose.vote")
        pose = next(s for s in own if s[0] == "rcvpose.pose")
        assert _inside(vote, pose)
        for child in ("rcvpose.vote.prepare", "rcvpose.vote.coarse",
                      "rcvpose.vote.fine"):
            assert _inside(next(s for s in own if s[0] == child), vote)
        for child in ("rcvpose.pack", "rcvpose.fit"):
            assert _inside(next(s for s in own if s[0] == child), pose)
        # every span of a frame carries that frame's id first
        assert {s[3][0] for s in own} == {frame[3][0]}
        nets = [s[3][1:] for s in own if s[0] == "rcvpose.net"]
        assert nets == [[i % per_run] for i in range(len(nets))]
    assert frames[1][3][0] == frames[0][3][0] + 1


def test_startup_record_holds_loads_and_closes_after_first_frame(
        fresh_startup):
    est = _estimator(1)
    loads = [s for s in profiling.startup() if s.name == "rcvpose.load"]
    assert [s.attrs["net"] for s in loads] == [0, 1, 2]
    assert all(s.end_ns > s.start_ns for s in loads)
    assert fresh_startup.open
    img, depth, _ = _frame(1)
    est.estimate(img, depth)
    assert not fresh_startup.open
    record = profiling.startup()
    (first,) = [s for s in record if s.name == "rcvpose.estimate"]
    root = record.index(first)
    assert first.parent is None and "frame" in first.attrs
    children = [s for s in record if s.parent == root]
    assert {s.name for s in children} >= {"rcvpose.inputs", "rcvpose.net",
                                          "rcvpose.pose"}
    assert all(s.attrs["frame"] == first.attrs["frame"] for s in children)
    est.estimate(img, depth)
    assert profiling.startup() == record   # closed: nothing more is kept


def test_startup_record_shares_the_profilers_clock(fresh_startup):
    est = _estimator(3)
    img, depth, _ = _frame(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est.estimate(img, depth)
    record = [s for s in profiling.startup() if s.name != "rcvpose.load"]
    by_name = {}
    for name, start, end, _ in _spans(prof):
        by_name.setdefault(name, []).append((start, end))
    assert len(record) >= len(FRAME_SPANS)
    for s in record:
        start, end = by_name[s.name].pop(0)
        assert start <= s.start_ns < s.end_ns <= end, s


def test_cropped_frame_counts_one_escalation(closed_startup, monkeypatch):
    """Every depth pixel passes the masks (threshold far below the maps,
    radius clip far above them); a 20 x 20 object overflows a 16 x 16
    packing window, so the frame re-runs once with full-frame packing,
    and its 400 points fit the 512-point budget."""
    monkeypatch.setattr(infer, "WIN_H", 16)
    monkeypatch.setattr(infer, "WIN_W", 16)
    est = _estimator(3, sem_threshold=-1e9, max_points=512,
                     radii=[1e6] * 3)
    img, _, _ = _frame(3)
    depth = np.zeros((HW, HW), np.float32)
    depth[22:42, 22:42] = 700.0
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = est.estimate(img, depth)
    after = profiling.counters()

    def delta(key):
        return after.get(key, 0) - before.get(key, 0)

    assert (delta("escalations.cropped"), delta("escalations.budget"),
            delta("frames")) == (1, 0, 1)
    assert not out["cropped"].any()
    reruns = [s for s in _spans(prof) if s[0] == "rcvpose.escalate.rerun"]
    assert len(reruns) == 1
    # inputs: the frame id, the reason (a string, not read back), n_points
    assert reruns[0][3][2] == 512


def test_kernel_library_loads_are_spans_and_counts(fresh_startup, tmp_path,
                                                   monkeypatch):
    """``ops._build`` opens one ``rcvpose.kernels.load`` a library and
    counts it loaded, and built where nvcc ran (a stand-in build and
    loader here: the CPU has no nvcc)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_loaded_from", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)

    def build(names):
        for name in names:
            _build.library_path(name).write_bytes(b"")
        return {}

    monkeypatch.setattr(_build, "build", build)
    before = profiling.counters()
    _build.load("vote")
    _build.library_path("heads").write_bytes(b"")   # built earlier
    _build.load("heads")
    _build.load("vote")                             # loaded once
    after = profiling.counters()
    loads = [s for s in profiling.startup()
             if s.name == "rcvpose.kernels.load"]
    assert [(s.attrs["library"], s.attrs["built"]) for s in loads] == [
        ("vote", True), ("heads", False)]
    assert after.get("kernels.loaded", 0) - before.get("kernels.loaded",
                                                       0) == 2
    assert after.get("kernels.built", 0) - before.get("kernels.built", 0) == 1


def test_counters_and_launch_attributes_hold_under_threads():
    """Sixteen threads count at once with a short switch interval: no
    update is lost, in the store or in a kernel wrapper's ``launches``."""
    def fn():
        pass

    fn.launches = 0
    before = profiling.counters().get("test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                profiling.count("test.threads")
                _build.count(fn)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["test.threads"] - before == 32000
    assert fn.launches == 32000


def test_trace_exports_the_spans(tmp_path, closed_startup):
    with profiling.trace(str(tmp_path)):
        with profiling.span("rcvpose.pose"):
            torch.ones(4).sum()
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "rcvpose.pose" in names
