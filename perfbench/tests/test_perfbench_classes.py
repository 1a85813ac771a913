"""The multi-class cell and the escalation cell at a CPU size: sound runs
are correct, the control is not, every class's estimator serves its own
frames without escalating where the budget is derived, half the frames
escalate where the configuration's budget is below them, and a program
whose estimators cannot share a graph pool stops at once."""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

from perfbench.harness import bench, classes
from perfbench.tests import small

# three classes (longest semi-axes 30, 75 and 120 mm) at 64 x 96, the
# YCB camera's focal lengths cut by 8 so the largest class fits the frame
SMALL_YCB = {k: v for k, v in small.SMALL.items() if k != "max_points"}
SMALL_YCB["vote_topk"] = 8
K_SMALL = [[1066.778 / 8, 0.0, 48.0], [0.0, 1067.487 / 8, 32.0],
           [0.0, 0.0, 1.0]]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def ycb_cell():
    c = bench.load_cell("serve-3net-ycb")
    c.config = copy.deepcopy(c.config)
    c.config.update(classes=3, class_names=c.config["class_names"][:3],
                    intrinsics=K_SMALL)
    c.traffic = {**c.traffic, "pool": 6}
    c.workload = copy.deepcopy(c.workload)
    c.workload.update(warmup_frames=3, trace_frames=3)
    c.workload["check"]["frames"] = 3
    c.workload["check"]["limits"].update(small.SERVE_LIMITS)
    return c


def ycb_run(trace=False, control=False, seed=2 ** 33 + 5):
    r = bench.Run(cell=ycb_cell(), seed=seed, seconds=0.5, trace=trace,
                  device=torch.device("cpu"), t0=time.perf_counter(),
                  control=control, overrides=SMALL_YCB)
    bench.drive(r)
    return bench.result(r, "cpu")[0], r


def counters():
    from rcvpose_tpu_torch import profiling

    return dict(profiling.counters())


def test_classes_inputs_windows_and_budgets_hold_every_frame():
    r = bench.Run(cell=ycb_cell(), seed=2 ** 40 + 1, seconds=0.5,
                  trace=False, device=torch.device("cpu"), t0=0.0,
                  overrides=SMALL_YCB)
    inp = classes.inputs(r)
    assert sorted(inp.classes.tolist()) == [0, 0, 1, 1, 2, 2]
    assert [a[0] for a in classes.semi_axes(r.cell.config)] == [30, 75, 120]
    for j, c in enumerate(inp.classes):
        rows, cols = np.nonzero(inp.depths[j])
        assert len(rows) == inp.areas[j] <= inp.budgets[c]
        assert np.ptp(rows) < min(inp.windows[c][0], 64)
        assert np.ptp(cols) < min(inp.windows[c][1], 96)
    assert inp.budgets[0] < inp.budgets[1] < inp.budgets[2]
    assert all(b % 1024 == 0 for b in inp.budgets)


def test_harness_derivation_agrees_with_the_program():
    """The harness's own window and budget equal the program's at the
    full-size camera, for every class of a few seeds."""
    from rcvpose_tpu_torch import infer

    cfg = bench.load_cell("serve-3net-ycb").config
    k32 = np.asarray(cfg["intrinsics"], np.float32)
    axes = classes.semi_axes(cfg)
    for seed in (1, 2 ** 40 + 7):
        for c in range(cfg["classes"]):
            cad = classes.cad_cloud(seed, c, cfg["cad"]["points"], axes[c])
            win = classes.window(cad, k32, 600.0)
            assert win == infer.suggest_pack_window(cad, k32, 600.0)
            assert classes.budget(cad, k32, 600.0, win) == (
                infer.suggest_point_budget(cad, k32, win, 600.0))


@pytest.mark.parametrize("trace", [False, True])
def test_ycb_cell_small_is_correct_and_never_escalates(trace):
    before = counters()
    out, r = ycb_run(trace=trace)
    after = counters()
    assert out["correct"] is True, out["checks"]
    assert r.notes["escalated_frames"] == 0
    assert after.get("escalations.budget", 0) == before.get(
        "escalations.budget", 0)
    # every class joined the first one's graph pool (counted on the card)
    assert len(r.notes["budgets"]) == 3
    if trace:
        assert "mfu_pct.serve" in out["metrics"]


def test_ycb_cell_small_control_is_not_correct():
    out, _ = ycb_run(control=True)
    assert out["correct"] is False


def test_a_program_without_shared_pools_stops_at_once(monkeypatch):
    from rcvpose_tpu_torch import infer

    class Old(infer.PoseEstimator):
        def __init__(self, cfg, variables_list, keypoints, max_radii_dm,
                     cad_mm=None, k=None, device=None):
            raise AssertionError("never built")

    monkeypatch.setattr(infer, "PoseEstimator", Old)
    t = time.perf_counter()
    with pytest.raises(SystemExit, match="graph_pool"):
        ycb_run()
    assert time.perf_counter() - t < 5.0


def test_escalate_cell_small_half_the_frames_rerun():
    c = small.cell("serve-3net-escalate")
    c.traffic.update(pool=4, area_px=[300, 724])   # two of four above 512
    c.workload["warmup_frames"] = 4
    before = counters()
    r = bench.Run(cell=c, seed=2 ** 33 + 5, seconds=0.5, trace=False,
                  device=torch.device("cpu"), t0=time.perf_counter(),
                  overrides=small.SMALL)
    bench.drive(r)
    out = bench.result(r, "cpu")[0]
    after = counters()
    assert out["correct"] is True, out["checks"]
    reruns = after.get("escalations.budget", 0) - before.get(
        "escalations.budget", 0)
    frames = after["frames"] - before.get("frames", 0)
    assert reruns / frames == pytest.approx(0.5, abs=0.13)
    assert max(r.notes["check_budgets"]) == 1024
